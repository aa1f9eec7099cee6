"""K9 ``ba_solve`` (``kernels/ba.py``, ``csrc/ba.cu``): the windowed
pose-graph solve.

On the CPU: ``posegraph/graph.optimize`` runs the twin and launches
nothing; the wrapper's checks raise ``ValueError`` before any launch; a
keyframe manager of any window is built; a scalar model of the kernel's
forward-mode pass (one dual number, a value and one tangent, through
``csrc/ba.cu``'s operations in its order, in numpy f32) gives each edge's
residual and 12 Jacobian columns as JAX's ``jax.jacfwd(_residual_local)``
does, to 1e-5, on random edges and on edges that take each Taylor window
and each quaternion branch, and counts the operations an edge needs for
``chip_smoke.py``'s bound; a numpy f32 model of the kernel's blocked
Cholesky and substitutions (panels, tiles, their order) against LAPACK
and the twin's solve; and a padded slot with a NaN makes every pose NaN
in the twin as in JAX.

On a CUDA card only (marker ``cuda``; run there with
``python -m pytest tests/test_torch_ba.py -m cuda --noconftest``, which
needs no JAX): the kernel against its twin on windows of 2 to 512 nodes
across both tiers (Tier S's largest window and one node more) with
closures, frozen anchors, garbage padding and E > 128, poses to 1e-5,
fixed nodes bit-equal, the gauge-less and NaN-slot windows NaN in both,
one launch a call, two calls bit-identical, a window over the index limit
refused before anything is allocated, and the launch captured in a CUDA
graph in each tier.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib, ba
from supereight_tpu_torch.posegraph import graph as pg
from supereight_tpu_torch.tools import ba_windows

TOL = 1e-5  # tests/test_torch_posegraph.py's
F = np.float32


# ---- the kernel's forward-mode pass, one scalar at a time ----------------

class D:
    """A dual number in f32: a value and one tangent. For the count,
    ``dz`` marks a tangent that is zero whatever the column (a constant,
    a measurement, the node that is not perturbed) and ``const`` a value
    known before the data (a literal, a rigid transform's bottom row)."""
    __slots__ = ("v", "d", "dz", "const")

    def __init__(self, v, d=0.0, dz=True, const=False):
        self.v, self.d, self.dz, self.const = F(v), F(d), dz, const


def lit(v):
    return D(v, const=True)


def rigid(T):
    """A rigid transform's entries: data, and the bottom row literal."""
    return [[D(T[r][c], const=(r == 3)) for c in range(4)] for r in range(4)]


class DualPass:
    """csrc/ba.cu's edge_column in numpy f32 scalars, operation by
    operation, and ``branches`` (the quaternion candidate, so3_log's
    Taylor window, se3_log's). It also counts the f32 operations the
    solve needs (a transcendental counts one), apart from how the kernel
    spends them: ``primal`` those of the residual and of the derivatives'
    coefficients (one pass an edge; a literal operand folds), ``tangent``
    those of this column's tangents (a zero tangent costs none)."""

    def __init__(self):
        self.primal = self.tangent = 0
        self.branches = None

    @staticmethod
    def _zero(a):
        return a.const and a.v == 0

    def _out(self, v, d, a, b=None, tangent_ops=0):
        """The result of an operation on a (and b): a literal where they
        are; otherwise one primal operation unless an operand is a
        literal 0 (add, sub) and ``tangent_ops`` for the tangent."""
        args = (a,) if b is None else (a, b)
        if all(x.const for x in args):
            return D(v, d, const=True)
        dz = all(x.dz for x in args)
        self.tangent += 0 if dz else tangent_ops
        return D(v, d, dz)

    def _linear(self, a, b, v, d):
        out = self._out(v, d, a, b, 1 if not (a.dz or b.dz) else 0)
        if not out.const and not (self._zero(a) or self._zero(b)):
            self.primal += 1
        return out

    def add(self, a, b):
        return self._linear(a, b, a.v + b.v, a.d + b.d)

    def sub(self, a, b):
        return self._linear(a, b, a.v - b.v, a.d - b.d)

    def mul(self, a, b):
        v, d = a.v * b.v, a.d * b.v + a.v * b.d
        if self._zero(a) or self._zero(b):
            return D(v, d, const=True)

        def term(t, c):  # tangent t times value c: none, free or one
            return 0 if t.dz else (0 if c.const and abs(c.v) == 1 else 1)
        ta, tb = term(a, b), term(b, a)
        out = self._out(v, d, a, b, ta + tb + (not (a.dz or b.dz)))
        if not out.const and not (a.const and abs(a.v) == 1
                                  or b.const and abs(b.v) == 1):
            self.primal += 1
        return out

    def scale(self, a, c):
        out = self._out(a.v * F(c), a.d * F(c), a, tangent_ops=1)
        self.primal += not out.const
        return out

    def div(self, a, b):
        q = a.v / b.v
        d = (a.d - q * b.d) / b.v
        # tangent: a.d / b - b.d q / b, with q / b and (where a has a
        # tangent) 1 / b once an edge
        out = self._out(q, d, a, b, 3 if not (a.dz or b.dz) else 1)
        if not out.const:
            self.primal += 1 if b.const else 2 + (not a.const)
        return out

    def _unary(self, a, v, d):
        """sqrt, sin: the value and the coefficient (1 / 2s, cos), one
        operation each an edge, and one for the tangent."""
        out = self._out(v, d, a, tangent_ops=1)
        self.primal += 0 if out.const else 2
        return out

    def sqrt(self, a):
        s = np.sqrt(a.v)
        return self._unary(a, s, a.d / (F(2) * s))

    def sin(self, a):
        return self._unary(a, np.sin(a.v), np.cos(a.v) * a.d)

    def atan2(self, y, x):
        d = (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)
        # the value, x^2 + y^2 (3) and the two coefficients an edge
        out = self._out(np.arctan2(y.v, x.v), d, y, x,
                        3 if not (y.dz or x.dz) else 1)
        self.primal += 0 if out.const else 6
        return out

    @staticmethod
    def neg(a):
        return D(-a.v, -a.d, a.dz, a.const)

    def matmul(self, a, b):
        """a @ b, each entry summed left to right (se3.matmul4)."""
        out = []
        for r in range(len(a)):
            row = []
            for c in range(len(b[0])):
                s = self.mul(a[r][0], b[0][c])
                for k in range(1, len(b)):
                    s = self.add(s, self.mul(a[r][k], b[k][c]))
                row.append(s)
            out.append(row)
        return out

    def inverse(self, T):
        Rt = [[T[c][r] for c in range(3)] for r in range(3)]
        t = self.matmul(Rt, [[T[r][3]] for r in range(3)])
        return [Rt[r] + [self.neg(t[r][0])] for r in range(3)] \
            + [[lit(0), lit(0), lit(0), lit(1)]]

    @staticmethod
    def perturbed(T, k):
        """exp(x) @ T at x = 0 with the unit tangent on twist entry k
        (None: none): (T, G_k @ T)."""
        out = rigid(T)
        if k is not None and k < 3:
            out[k][3] = D(T[k][3], 1, dz=False)
        elif k is not None:
            p, q = (k - 2) % 3, (k - 1) % 3  # hat(e_a), a = k - 3
            for c in range(4):
                out[p][c] = D(T[p][c], -F(T[q][c]), dz=False)
                out[q][c] = D(T[q][c], F(T[p][c]), dz=False)
        return out

    def rot_to_quat(self, R):
        one = lit(1)
        (r00, r01, r02), (r10, r11, r12), (r20, r21, r22) = R
        add, sub = self.add, self.sub
        p, m = add(one, r00), sub(one, r00)
        d = [add(add(p, r11), r22), sub(sub(p, r11), r22),
             sub(add(m, r11), r22), add(sub(m, r11), r22)]
        best = 0
        for k in range(1, 4):
            if d[k].v > d[best].v:
                best = k
        # only the selected candidate is computed
        abc, order = (
            (lambda: (sub(r21, r12), sub(r02, r20), sub(r10, r01)),
             (0, 1, 2, 3)),
            (lambda: (sub(r21, r12), add(r01, r10), add(r02, r20)),
             (1, 0, 2, 3)),
            (lambda: (sub(r02, r20), add(r01, r10), add(r12, r21)),
             (2, 0, 1, 3)),
            (lambda: (sub(r10, r01), add(r02, r20), add(r12, r21)),
             (3, 0, 1, 2)),
        )[best]
        abc = abc()
        db = d[best] if d[best].v >= F(1e-12) else lit(1e-12)
        s = self.sqrt(db)
        inv = self.div(lit(0.5), s)
        q = [None] * 4
        for slot, v in zip(order, (self.scale(s, 0.5), self.mul(abc[0], inv),
                                   self.mul(abc[1], inv),
                                   self.mul(abc[2], inv))):
            q[slot] = v
        if q[0].v < 0:
            q = [self.neg(x) for x in q]
        return q, best

    def se3_log(self, M):
        q, best = self.rot_to_quat([row[:3] for row in M[:3]])
        mul, add = self.mul, self.add
        nv_sq = add(add(mul(q[1], q[1]), mul(q[2], q[2])), mul(q[3], q[3]))
        so3_small = bool(nv_sq.v < F(1e-10))
        if so3_small:
            qc = q[0] if q[0].v >= F(1e-6) else lit(1e-6)
            f = mul(self.div(lit(2), qc),
                    self.sub(lit(1), self.div(nv_sq,
                                            self.scale(mul(qc, qc), 3))))
        else:
            nv = self.sqrt(nv_sq)
            f = self.div(self.scale(self.atan2(nv, q[0]), 2), nv)
        w = [mul(q[1], f), mul(q[2], f), mul(q[3], f)]
        theta_sq = add(add(mul(w[0], w[0]), mul(w[1], w[1])),
                       mul(w[2], w[2]))
        se3_small = bool(theta_sq.v < F(1e-6))
        if se3_small:
            coef = add(lit(1.0 / 12.0), self.div(theta_sq, lit(720)))
        else:
            th = self.sqrt(theta_sq)
            sh = self.sin(self.scale(th, 0.5))
            th2 = mul(th, th)
            b = self.div(mul(self.scale(sh, 2), sh), th2)
            a = self.div(self.sin(th), th)
            coef = self.div(self.sub(lit(1), self.div(a, self.scale(b, 2))),
                            th2)
        z, neg = lit(0), self.neg
        W = [[z, neg(w[2]), w[1]], [w[2], z, neg(w[0])],
             [neg(w[1]), w[0], z]]
        W2 = self.matmul(W, W)
        vinv = [[add(self.sub(lit(1.0 if r == c else 0.0),
                              self.scale(W[r][c], 0.5)),
                     mul(coef, W2[r][c])) for c in range(3)]
                for r in range(3)]
        v = self.matmul(vinv, [[M[r][3]] for r in range(3)])
        self.branches = (best, so3_small, se3_small)
        return [v[r][0] for r in range(3)] + w

    def column(self, ti, tj, tm, k):
        """The residual (values) and its Jacobian column k (tangents) of
        the edge (ti, tj, tm): k < 6 on x_i, k >= 6 on x_j."""
        a = self.perturbed(ti, k if k < 6 else None)
        b = self.perturbed(tj, k - 6 if k >= 6 else None)
        m = self.inverse(rigid(tm))
        res = self.se3_log(self.matmul(m, self.matmul(self.inverse(a), b)))
        self.nonzero = [not x.dz for x in res]
        return (np.array([x.v for x in res], F),
                np.array([x.d for x in res], F))


# ---- CPU: dispatch, checks, the forward-mode pass -------------------------

def rand_poses(rng, k, scale):
    tw = (rng.normal(size=(k, 6)) * scale).astype(F)
    return se3.exp(torch.from_numpy(tw)).numpy()


def _no_launch(*args, **kw):
    raise AssertionError("a CPU call reached _lib.launch")


@pytest.mark.parametrize("n,cap,frozen", [(4, 8, False), (9, 16, True)])
def test_cpu_optimize_runs_the_twin(monkeypatch, n, cap, frozen):
    """On CPU tensors graph.optimize is ba_solve_plain, bit for bit, and
    reaches no launch."""
    torch.set_num_threads(1)
    monkeypatch.setattr(_lib, "launch", _no_launch)
    poses, graph, fixed = ba_windows.window(n, cap, n, "cpu")
    fixed = fixed if frozen else None
    before = dict(_lib.LAUNCHES)
    got = pg.optimize(poses, graph, n, iters=3, fixed=fixed)
    want = ba.ba_solve_plain(poses, graph, n, 3, 1e-6, fixed)
    assert torch.equal(got, want) and torch.isfinite(got).all()
    assert _lib.LAUNCHES == before


def _bad(case):
    """A window of 5 nodes and 8 edge slots with one argument broken."""
    poses, graph, fixed = ba_windows.window(5, 8, 0, "cpu")
    n, iters = 5, 10
    g = graph._asdict()
    if case == "poses f64":
        poses = poses.double()
    elif case == "poses shape":
        poses = torch.cat([poses, poses[:1]])
    elif case == "i float":
        g["i"] = g["i"].float()
    elif case == "j int16":
        g["j"] = g["j"].to(torch.int16)
    elif case == "t_meas f64":
        g["t_meas"] = g["t_meas"].double()
    elif case == "t_meas shape":
        g["t_meas"] = g["t_meas"][:, :3]
    elif case == "weight shape":
        g["weight"] = torch.cat([g["weight"], g["weight"][:1]])
    elif case == "valid uint8":
        g["valid"] = g["valid"].to(torch.uint8)
    elif case == "j shape":
        g["j"] = g["j"][:-1]
    elif case == "fixed int":
        fixed = fixed.int()
    elif case == "fixed shape":
        fixed = fixed[:-1]
    elif case == "i over n":
        g["i"] = g["i"].clone()
        g["i"][6] = n
    elif case == "j negative":
        g["j"] = g["j"].clone()
        g["j"][3] = -1
    elif case == "no nodes":
        n = 0
    elif case == "iters negative":
        iters = -1
    return poses, pg.PoseGraph(**g), n, iters, fixed


@pytest.mark.parametrize("case", [
    "poses f64", "poses shape", "i float", "j int16", "t_meas f64",
    "t_meas shape", "weight shape", "valid uint8", "j shape", "fixed int",
    "fixed shape", "i over n", "j negative", "no nodes", "iters negative"])
def test_checks_raise_before_any_launch(monkeypatch, case):
    monkeypatch.setattr(_lib, "launch", _no_launch)
    poses, graph, n, iters, fixed = _bad(case)
    with pytest.raises(ValueError, match="ba_solve"):
        ba.ba_solve(poses, graph, n, iters, 1e-6, fixed)


@pytest.mark.parametrize("window,pinned,device", [
    (161, 16, "cuda"), (32, 161, "cuda"), (512, 16, "cuda"),
    (2048, 2048, "cuda"), (161, 16, "cpu"), (2048, 16, "cpu")])
def test_keyframe_window_of_any_size_is_built(window, pinned, device):
    """A keyframe manager of any window or pinned count is built, on the
    card as on the CPU (building one touches no device): the card's
    ba_solve takes every window JAX's optimize takes, up to
    ba.INDEX_NODES nodes, which no window here reaches."""
    from supereight_tpu_torch.posegraph.keyframes import KeyframeManager
    km = KeyframeManager(window=window, max_pinned=pinned, device=device)
    assert km.device.type == device and max(window, pinned) \
        <= ba.INDEX_NODES


def test_ba_windows_tool_needs_the_card():
    """tools/ba_windows times the kernel on the card only: without one it
    exits 2; its windows hold the edges they were asked for."""
    if not torch.cuda.is_available():
        assert ba_windows.main(["--nodes", "4"]) == 2
    poses, graph, fixed = ba_windows.window(12, 24, 0, "cpu")
    assert poses.shape == (12, 4, 4) and graph.i.shape == (24,)
    assert int(graph.valid.sum()) == 11 + 3 and fixed.tolist() == [
        k >= 5 and (k - 5) % 8 == 0 for k in range(12)]
    with pytest.raises(ValueError, match="over the cap"):
        ba_windows.window(12, 13, 0, "cpu")


def test_timeline_marks_fit_the_kernel():
    """Each time mark SE_MARK(k) of csrc/ba.cu occurs once, and k runs over
    tools/ba_windows.PHASES: the --timeline side build names every mark."""
    text = (_lib.CSRC / "ba.cu").read_text()
    marks = [int(k) for k in re.findall(r"\bSE_MARK\((\d+)\);", text)]
    assert sorted(marks) == list(range(len(ba_windows.PHASES)))


def test_int64_edges_are_taken():
    """int64 node indices (the twin's .long()) give the int32 result."""
    poses, graph, fixed = ba_windows.window(6, 8, 1, "cpu")
    g64 = graph._replace(i=graph.i.long(), j=graph.j.long())
    assert torch.equal(ba.ba_solve(poses, g64, 6, 2, 1e-6, fixed),
                       ba.ba_solve(poses, graph, 6, 2, 1e-6, fixed))


def _edge_case(rng, case, e):
    """(t_i, t_j, t_meas) of one edge: random, or with T_meas near
    T_i^-1 T_j (rotations of ~0, 1e-6 and 2e-4 rad: both Taylor windows,
    or so3_log's closed form with se3_log's window), or ~3.1 rad about
    axis e % 3 (the quaternion's x, y or z candidate)."""
    ti, tj = rand_poses(rng, 1, 1.0)[0], rand_poses(rng, 1, 1.0)[0]
    if case == "random":
        return ti, tj, rand_poses(rng, 1, 1.5)[0]
    if case == "pi":
        tw = np.zeros((1, 6), F)
        tw[0, 3 + e % 3] = 3.1
        tw[0, :3] = rng.normal(size=3)
        noise = se3.exp(torch.from_numpy(tw)).numpy()[0]
    else:
        noise = rand_poses(rng, 1, {"converged": 0.0, "tiny": 1e-6,
                                    "small": 2e-4}[case])[0]
    return ti, tj, (np.linalg.inv(ti) @ tj @ noise).astype(F)


CASES = {"random": None, "converged": (0, True, True),
         "tiny": (0, True, True), "small": (0, False, True), "pi": None}


@pytest.mark.parametrize("case", list(CASES))
def test_dual_pass_matches_jax_jacfwd(case):
    """The kernel's forward-mode pass (the scalar model) against JAX's
    jacfwd of the residual, and its values against JAX's residual, to
    1e-5 on 6 edges of each kind, each kind taking the branches it names
    (the quaternion candidate, so3_log's and se3_log's Taylor windows)."""
    import jax
    import jax.numpy as jnp
    from supereight_tpu.posegraph import graph as jax_pg
    rng = np.random.default_rng(len(case))
    z = jnp.zeros(6)
    jac = jax.jacfwd(jax_pg._residual_local, argnums=(0, 1))
    seen = set()
    for e in range(6):
        ti, tj, tm = _edge_case(rng, case, e)
        wi, wj = jac(z, z, *map(jnp.asarray, (ti, tj, tm)))
        want = np.concatenate([np.asarray(wi), np.asarray(wj)], 1)
        r_want = np.asarray(jax_pg.edge_residual(
            *map(jnp.asarray, (ti, tj, tm))))
        m = DualPass()
        cols = [m.column(ti, tj, tm, k) for k in range(12)]
        np.testing.assert_allclose(np.stack([c[1] for c in cols], 1), want,
                                   atol=TOL)
        for r, _ in cols:
            np.testing.assert_allclose(r, r_want, atol=TOL)
        seen.add(m.branches)
    if CASES[case] is not None:
        assert seen == {CASES[case]}
    elif case == "pi":
        assert {b[0] for b in seen} == {1, 2, 3}
    else:
        assert all(not b[1] and not b[2] for b in seen)


def test_column_ops_count():
    """chip_smoke.BA_EDGE_OPS, the bound's count, is the fewest operations
    an edge and its 12 Jacobian columns need over the pass's branches
    (so3_log's closed form with se3_log's window): the residual and the
    coefficients once (every column's pass counts the same), each
    column's nonzero tangents, and a product and a sum for each pair of
    nonzero Jacobian entries in H's upper triangle and for each nonzero
    entry in b."""
    rng = np.random.default_rng(3)
    counts = {}
    for case in CASES:
        ti, tj, tm = _edge_case(rng, case, 0)
        passes = [DualPass() for _ in range(12)]
        for k, m in enumerate(passes):
            m.column(ti, tj, tm, k)
        assert len({m.primal for m in passes}) == 1
        nz = np.array([m.nonzero for m in passes]).T  # J's rows x columns
        # a rotation's residual does not depend on a translation
        assert not nz[3:, [0, 1, 2, 6, 7, 8]].any() and nz.sum() == 54
        normal = 2 * sum(int((nz[:, a] & nz[:, b]).sum())
                         for a in range(12) for b in range(a, 12))
        counts[case] = (passes[0].primal + sum(m.tangent for m in passes)
                        + normal + 2 * int(nz.sum()))
    assert min(counts.values()) == counts["small"] == chip_smoke.BA_EDGE_OPS


# ---- the blocked factorisation and substitutions --------------------------

def _fma(x, y, acc):
    """f32 fused multiply-add, near enough: the f32 product is exact in
    f64, and the sum rounds once more to f32."""
    return (x.astype(np.float64) * y + acc).astype(F)


def blocked_solve(H, b, panel=ba.PANEL, tile=ba.TILE):
    """csrc/ba.cu's phases 3 and 4 in numpy f32, in its order: H's upper
    triangle and b as column N of an N x ld array (``ld`` the kernel's
    row_floats), factored by panels of ``panel`` rows (the warp's diagonal
    block a column at a time, the panel's rows solved a column at a time
    against it with the reciprocals, the trailing upper triangle updated
    in ``tile`` x ``tile`` tiles with fused multiply-adds), then U x = y a
    panel at a time from the last (the panel after applied first, to the
    panel's rows and the rows above). Returns (U, x), or None where a
    pivot is not > 0."""
    N = H.shape[0]
    ld = (N + 4) & ~3
    A = np.zeros((N, ld), F)
    A[:, :N] = np.triu(H)
    A[:, N] = b
    rd = np.zeros(N, F)
    K = -(-N // panel)

    def width(k):
        return min(panel, N - k * panel)

    def diag(j0, w):
        for t in range(w):
            p = A[j0 + t, j0 + t]
            if not p > 0:
                return False
            d = np.sqrt(p)
            A[j0 + t, j0 + t], rd[j0 + t] = d, F(1) / d
            A[j0 + t, j0 + t + 1:j0 + w] /= d
            # lanes l >= r: col[r] -= U[t][r] U[t][l]
            for r in range(t + 1, w):
                A[j0 + r, j0 + r:j0 + w] -= (A[j0 + t, j0 + r]
                                             * A[j0 + t, j0 + r:j0 + w])
        return True

    if not diag(0, width(0)):
        return None
    for k in range(K):
        j0, w = k * panel, width(k)
        j1 = j0 + w
        h = A[j0:j1, j1:N + 1].copy()  # a column a thread
        for t in range(w):
            h[t] = h[t] * rd[j0 + t]
            for r in range(t + 1, w):
                h[r] = h[r] - A[j0 + t, j0 + r] * h[t]
        A[j0:j1, j1:N + 1] = h
        if k + 1 == K:
            break
        for ti in range(-(-(N - j1) // tile)):
            for tj in range(ti, -(-(N + 1 - j1) // tile)):
                ra = np.arange(j1 + ti * tile, min(j1 + (ti + 1) * tile, N))
                cb = np.arange(j1 + tj * tile,
                               min(j1 + (tj + 1) * tile, N + 1))
                acc = np.zeros((len(ra), len(cb)), F)
                for s in range(w):
                    acc = _fma(A[j0 + s, ra][:, None], A[j0 + s, cb][None],
                               acc)
                blk = A[np.ix_(ra, cb)]
                A[np.ix_(ra, cb)] = np.where(cb[None] >= ra[:, None],
                                             blk - acc, blk)
        if not diag(j1, width(k + 1)):
            return None
    for k in reversed(range(K)):
        j0, w = k * panel, width(k)
        j1 = j0 + w
        wn = width(k + 1) if k + 1 < K else 0
        y = A[j0:j1, N].copy()  # the lead warp, a lane a row
        above = A[:j0, N].copy()  # the workers, a thread a row
        for c in range(j1, j1 + wn):
            y = y - A[j0:j1, c] * A[c, N]
            above = above - A[:j0, c] * A[c, N]
        for t in reversed(range(w)):
            y[t] = y[t] * rd[j0 + t]
            y[:t] = y[:t] - A[j0:j0 + t, j0 + t] * y[t]
        A[j0:j1, N] = y
        if wn:
            A[:j0, N] = above
    return np.triu(A[:, :N]), A[:, N].copy()


# (n, fixed nodes): below one panel (N = 24), panels 32 + 32 + 14 with a
# ragged tile, 138 rows (trailing tiles of 64 and a ragged one), and
# every third node fixed (the gauge's identity rows across the panels)
FACTOR_CASES = {"under_a_panel": (4, ()), "ragged": (13, (5,)),
                "tiles": (23, (5, 13, 21)),
                "gauge": (23, tuple(range(2, 23, 3)))}


@pytest.mark.parametrize("case", list(FACTOR_CASES))
def test_blocked_factor_model(case):
    """The kernel's blocked Cholesky and substitutions (the numpy model
    above) on a BA window's H and b (the twin's normal equations after
    two iterations): U against LAPACK's f64 factor and x against the
    twin's f32 cholesky_solve, each to 1e-4 of its largest entry (f32
    rounding in another order: the windows' cond(H) reaches ~1e6), and
    the fixed nodes' rows of x exactly 0."""
    n, fixed_nodes = FACTOR_CASES[case]
    poses, graph, _ = ba_windows.window(n, 2 * n + 4, n, "cpu")
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[list(fixed_nodes)] = True
    poses = ba.ba_solve_plain(poses, graph, n, 2, 1e-6, fixed)
    free6 = ba._free6(n, fixed, poses.device)
    H, b = ba.normal_equations_plain(poses, graph, n, 1e-6, free6)
    H, b = H.numpy(), b.numpy()
    U, x = blocked_solve(H, b)
    want_u = np.linalg.cholesky(H.astype(np.float64)).T
    np.testing.assert_allclose(U, want_u, atol=1e-4 * np.abs(want_u).max())
    L = torch.linalg.cholesky(torch.from_numpy(H))
    want_x = torch.cholesky_solve(torch.from_numpy(b)[:, None], L)[:, 0]
    np.testing.assert_allclose(x, want_x.numpy(),
                               atol=1e-4 * float(want_x.abs().max()))
    assert not x[free6.numpy() == 0].any()


def test_blocked_factor_model_fails_as_cholesky_ex():
    """A pivot that is not > 0 fails the model as cholesky_ex reports it:
    the gauge-less window's H at its first iteration, with the damping
    gone (singular), and an indefinite H."""
    poses, graph, _ = ba_windows.gaugeless("cpu")
    free6 = ba._free6(6, None, poses.device)
    H, b = ba.normal_equations_plain(poses, graph, 6, 0.0, free6)
    assert int(torch.linalg.cholesky_ex(H).info) > 0
    assert blocked_solve(H.numpy(), b.numpy()) is None
    bad = np.eye(40, dtype=F)
    bad[35, 35] = -1.0
    assert blocked_solve(bad, np.ones(40, F)) is None


def test_nan_padded_slot_fails_as_jax():
    """A padded slot whose measurement holds a NaN: JAX scales its terms
    by where(valid, w, 0), 0 times NaN is NaN, and every pose is NaN
    (the Cholesky fails on H, or b spreads it through the
    substitutions); the twin leaves NaN in the same places. The kernel
    checks each padded slot's residual for that (csrc/ba.cu, phase 1)."""
    import jax.numpy as jnp
    from supereight_tpu.posegraph import graph as jax_pg
    poses, graph, fixed = ba_windows.nan_slot(6, 12, 1, "cpu")
    arrays = [x.numpy() for x in graph]
    want = np.asarray(jax_pg.optimize(
        jnp.asarray(poses.numpy()), jax_pg.PoseGraph(*map(jnp.asarray,
                                                          arrays)),
        num_nodes=6, iters=2, fixed=jnp.asarray(fixed.numpy())))
    got = pg.optimize(poses, graph, 6, iters=2, fixed=fixed).numpy()
    assert np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _nodes(label, dev):
    """A window's n: an int, or Tier S's largest window ("s_max") and one
    node more ("s_max+1"), asked of the card."""
    if isinstance(label, int):
        return label
    return ba.tier_s_nodes(dev) + (label == "s_max+1")


@pytest.mark.cuda
@pytest.mark.parametrize("label,cap", [
    (2, 4), (4, 8), (12, 24), (32, 128), (48, 200), (64, 160), (64, 256),
    ("s_max", None), ("s_max+1", None), (160, None), (256, None),
    (512, None)])
def test_ba_solve_matches_plain_on_cuda(cuda, label, cap):
    """The kernel against its twin on a window of n nodes (closures,
    every 8th node from 5 frozen, garbage padding; E = 2n slots where
    cap is None), on both sides of Tier S's edge and in Tier L up to 512
    nodes: poses to 1e-5, node 0 and the frozen nodes bit-equal to their
    input, one launch a call in the tier the plan names, two calls
    bit-identical."""
    n = _nodes(label, cuda)
    cap = cap or 2 * n
    poses, graph, fixed = ba_windows.window(n, cap, n, cuda)
    tier = ba.plan(n, cap, cuda).tier
    assert tier == ("S" if n <= ba.tier_s_nodes(cuda) else "L")
    before = _lib.LAUNCHES["ba_solve"]
    got = pg.optimize(poses, graph, n, fixed=fixed)
    assert _lib.LAUNCHES["ba_solve"] == before + 1
    want = ba.ba_solve_plain(poses, graph, n, 10, 1e-6, fixed)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL
    held = fixed.clone()
    held[0] = True
    assert torch.equal(got[held], poses[held])
    assert torch.equal(got, pg.optimize(poses, graph, n, fixed=fixed))


@pytest.mark.cuda
def test_ba_solve_refuses_a_window_over_its_limit_on_cuda(cuda):
    """A window over INDEX_NODES nodes raises, naming the limit, before
    anything is allocated, and launches nothing."""
    n = ba.INDEX_NODES + 1
    assert n > 4096
    poses, graph, fixed = ba_windows.window(n, 2 * n, 0, cuda)
    torch.cuda.synchronize()
    before = _lib.LAUNCHES["ba_solve"]
    held = torch.cuda.memory_allocated(cuda)
    with pytest.raises(ValueError, match=f"INDEX_NODES = {ba.INDEX_NODES}"):
        pg.optimize(poses, graph, n, fixed=fixed)
    assert torch.cuda.memory_allocated(cuda) == held
    assert _lib.LAUNCHES["ba_solve"] == before


@pytest.mark.cuda
def test_ba_solve_gaugeless_fails_as_plain_on_cuda(cuda):
    """The window whose free nodes lost their tie to a fixed one: the
    factorisation fails and every pose is NaN, in both."""
    poses, graph, _ = ba_windows.gaugeless(cuda)
    got = pg.optimize(poses, graph, 6, iters=1)
    want = ba.ba_solve_plain(poses, graph, 6, 1)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[:, :3]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 64])
def test_ba_solve_nan_padded_slot_fails_as_plain_on_cuda(cuda, n):
    """In either tier (n = 6: S, 64: L), a padded slot with a NaN
    measurement makes every pose NaN, as the twin (and JAX,
    test_nan_padded_slot_fails_as_jax); a padded slot whose translation is
    far out (5 km, past the kernel's tame bound) but finite adds nothing:
    the poses match the twin's."""
    poses, graph, fixed = ba_windows.nan_slot(n, 2 * n, 1, cuda)
    got = ba.ba_solve(poses, graph, n, 2, 1e-6, fixed)
    want = ba.ba_solve_plain(poses, graph, n, 2, 1e-6, fixed)
    assert torch.isnan(want).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    far = graph.t_meas.clone()
    far[-1] = graph.t_meas[-2]
    far[-1, :3, 3] = 5000.0
    graph = graph._replace(t_meas=far)
    got = ba.ba_solve(poses, graph, n, 10, 1e-6, fixed)
    want = ba.ba_solve_plain(poses, graph, n, 10, 1e-6, fixed)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_ba_solve_without_iterations_or_edges_on_cuda(cuda):
    """iters 0 returns the poses; a window without edges moves no pose
    (H is the damping alone and b is 0), as the twin, in either tier."""
    for n in (5, 45):
        poses, graph, _ = ba_windows.window(n, 2 * n, 0, cuda)
        assert torch.equal(ba.ba_solve(poses, graph, n, 0), poses)
        empty = pg.PoseGraph(*(x[:0] for x in graph))
        got = ba.ba_solve(poses, empty, n, 3)
        want = ba.ba_solve_plain(poses, empty, n, 3)
        assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 64])
def test_ba_solve_captures_in_a_graph_on_cuda(cuda, n):
    """The launch can be captured in either tier (n = 12: S, 64: L; the
    wrapper reads nothing while a graph captures it): a replay gives the
    eager call's poses, twice, and an edge index out of range, which the
    wrapper cannot check then, makes every pose NaN in the kernel."""
    poses, graph, fixed = ba_windows.window(n, 2 * n, 5, cuda)
    args = (n, 10, 1e-6, fixed)
    want = ba.ba_solve(poses, graph, *args)
    bad = graph._replace(j=graph.j.clone())
    bad.j[2] = n
    g, g_bad = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = ba.ba_solve(poses, graph, *args)
    with torch.cuda.graph(g_bad):
        nan = ba.ba_solve(poses, bad, *args)
    g.replay()
    g_bad.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.isnan(nan).all()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 64])
def test_ba_solve_graphs_replay_in_any_order_on_cuda(cuda, n):
    """Two graphs captured one after the other, each on scratch of its
    own (Tier L's barrier counter with it, zeroed by the memset the
    capture records), replay in either order, the second first (n = 12:
    S, 64: L): each gives its eager call's poses."""
    windows = [ba_windows.window(n, 2 * n, seed, cuda) for seed in (6, 7)]
    want = [ba.ba_solve(p, g, n, 10, 1e-6, f) for p, g, f in windows]
    graphs, got = [], []
    for p, g, f in windows:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            got.append(ba.ba_solve(p, g, n, 10, 1e-6, f))
    for k in (1, 0, 1):
        graphs[k].replay()
        torch.cuda.synchronize()
        assert torch.equal(got[k], want[k])
