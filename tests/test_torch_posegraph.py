"""Parity of the port's pose graph (``posegraph/graph.py``,
``posegraph/keyframes.py``) and of the class pipeline's keyframe step
with the JAX package's.

The SE(3) log, the quaternion and the edge Jacobians (against
``jax.jacfwd``) agree to 1e-5; ``optimize`` agrees to 1e-5 on chains of 4
to 48 nodes with loop closures, padded (masked) edges and frozen nodes;
the keyframe manager's lists, edges, pinned and frozen flags are equal
and its poses agree to 1e-5 through trims with pinned anchors. Keyframe
graphs replayed by ``tools/ba_loop.py`` (one from a CPU run of the CLI,
one from the 250-frame loop on an H100) give the same ATE and closure
reports through either package's manager. (The class pipeline's keyframe
step is held to JAX's in ``tests/test_torch_pipeline.py``.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import se3 as jax_se3
from supereight_tpu.posegraph import graph as jax_pg
from supereight_tpu.posegraph.keyframes import \
    KeyframeManager as JaxKeyframeManager
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.posegraph import graph as pg
from supereight_tpu_torch.posegraph.keyframes import KeyframeManager

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def rand_poses(rng, k, scale=0.5):
    tw = (rng.normal(size=(k, 6)) * scale).astype(np.float32)
    return np.asarray(jax_se3.exp(jnp.asarray(tw)))


def test_se3_log_and_quat_match_jax():
    rng = np.random.default_rng(0)
    T = np.concatenate([rand_poses(rng, 64), rand_poses(rng, 16, 1e-4),
                        rand_poses(rng, 16, 1.5), np.eye(4, dtype=np.float32)
                        [None]])
    for name, arg in (("se3_log", T), ("so3_log", T[:, :3, :3]),
                      ("rot_to_quat", T[:, :3, :3])):
        np.testing.assert_allclose(
            getattr(pg, name)(t(arg)).numpy(),
            np.asarray(getattr(jax_pg, name)(jnp.asarray(arg))),
            atol=TOL, err_msg=name)
    # log inverts exp
    tw = (rng.normal(size=(10, 6)) * 0.5).astype(np.float32)
    np.testing.assert_allclose(pg.se3_log(se3.exp(t(tw))).numpy(), tw,
                               atol=TOL)


def test_edge_jacobians_match_jax():
    rng = np.random.default_rng(1)
    ti, tj = rand_poses(rng, 12), rand_poses(rng, 12)
    # measurements near the truth (the converged case) and far from it
    tm = np.concatenate([np.linalg.inv(ti[:6]) @ tj[:6],
                         rand_poses(rng, 6)]).astype(np.float32)
    z = jnp.zeros(6)
    jac = jax.vmap(jax.jacfwd(jax_pg._residual_local, argnums=(0, 1)),
                   in_axes=(None, None, 0, 0, 0))
    wi, wj = jac(z, z, jnp.asarray(ti), jnp.asarray(tj), jnp.asarray(tm))
    gi, gj = pg.edge_jacobians(t(ti), t(tj), t(tm))
    assert gi.dtype == torch.float32 and gi.shape == (12, 6, 6)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=TOL)
    np.testing.assert_allclose(gj.numpy(), np.asarray(wj), atol=TOL)
    np.testing.assert_allclose(
        pg.edge_residual(t(ti), t(tj), t(tm)).numpy(),
        np.asarray(jax.vmap(jax_pg.edge_residual)(
            jnp.asarray(ti), jnp.asarray(tj), jnp.asarray(tm))), atol=TOL)


def drift_chain(rng, n, closures, drift=0.02):
    """A ground-truth random walk, odometry edges from it, estimates with
    accumulated drift, and ``closures`` random non-consecutive edges."""
    steps = rand_poses(rng, n, 0.1)
    gt = [np.eye(4, dtype=np.float32)]
    for k in range(1, n):
        gt.append((gt[-1] @ steps[k]).astype(np.float32))
    noise = rand_poses(rng, n, drift)
    est = [g @ noise[k] for k, g in enumerate(gt)]
    edges = [(k, k + 1, np.linalg.inv(gt[k]) @ gt[k + 1],
              float(rng.uniform(1, 20))) for k in range(n - 1)]
    for _ in range(closures):
        a = int(rng.integers(0, n - 2))
        b = int(rng.integers(a + 2, n))
        edges.append((a, b, np.linalg.inv(gt[a]) @ gt[b],
                      float(rng.uniform(1, 50))))
    return np.stack(est).astype(np.float32), edges


@pytest.mark.parametrize("n,closures,frozen,pad", [
    (4, 1, (), 0), (12, 3, (5,), 4), (48, 10, (3, 17, 30), 60)])
def test_optimize_matches_jax(n, closures, frozen, pad):
    rng = np.random.default_rng(n)
    est, edges = drift_chain(rng, n, closures)
    e = len(edges)
    cap = e + pad
    i = np.zeros(cap, np.int32)
    j = np.zeros(cap, np.int32)
    tm = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    w = np.ones(cap, np.float32)
    valid = np.zeros(cap, bool)
    for k, (a, b, m, wt) in enumerate(edges):
        i[k], j[k], tm[k], w[k], valid[k] = a, b, m, wt, True
    # garbage in the padding, masked by valid
    tm[e:] = rand_poses(rng, pad, 1.0)
    fixed = np.zeros(n, bool)
    fixed[list(frozen)] = True
    want = np.asarray(jax_pg.optimize(
        jnp.asarray(est), jax_pg.PoseGraph(*map(jnp.asarray,
                                                (i, j, tm, w, valid))),
        num_nodes=n, fixed=jnp.asarray(fixed)))
    got = pg.optimize(t(est), pg.PoseGraph(*map(t, (i, j, tm, w, valid))),
                      n, fixed=t(fixed)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_array_equal(got[fixed], est[fixed])
    np.testing.assert_array_equal(got[0], est[0])


def test_window_without_gauge_fails_as_jax():
    """A window whose free nodes have lost every edge to a fixed node (the
    trim of a 6-keyframe window with pinned anchors reaches it) is
    singular but for the damping: JAX's Cholesky fails and leaves NaNs,
    and the port leaves NaNs in the same places."""
    rng = np.random.default_rng(2)
    poses = rand_poses(rng, 6, 0.3)
    edges = [(1, 2, 22.0), (2, 3, 44.0), (3, 4, 69.3), (4, 5, 50.6),
             (2, 5, 3.0)]
    cap = 8
    i = np.zeros(cap, np.int32)
    j = np.zeros(cap, np.int32)
    tm = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    w = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    for k, (a, b, wt) in enumerate(edges):
        i[k], j[k], w[k], valid[k] = a, b, wt, True
        tm[k] = (np.linalg.inv(poses[a]) @ poses[b]
                 @ rand_poses(rng, 1, 0.01)[0])
    want = np.asarray(jax_pg.optimize(
        jnp.asarray(poses), jax_pg.PoseGraph(*map(jnp.asarray,
                                                  (i, j, tm, w, valid))),
        num_nodes=6, iters=1))
    got = pg.optimize(t(poses), pg.PoseGraph(*map(t, (i, j, tm, w, valid))),
                      6, iters=1).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=TOL)


def _same_manager(a, b):
    assert a.frames == b.frames
    assert a.pinned == b.pinned and a.frozen == b.frozen
    assert [(i, j, w) for i, j, _, w in a.edges] == \
        [(i, j, w) for i, j, _, w in b.edges]
    for x, y in zip(a.edges, b.edges):
        np.testing.assert_allclose(x[2], y[2], atol=TOL)
    np.testing.assert_allclose(np.stack(a.poses), np.stack(b.poses),
                               atol=TOL)
    np.testing.assert_allclose(np.stack(a.orig_poses),
                               np.stack(b.orig_poses), atol=TOL)


@pytest.mark.parametrize("window,max_pinned", [(6, 2), (12, 4)])
def test_keyframe_manager_matches_jax(window, max_pinned):
    """A drifting walk with a keyframe every 2nd frame, inlier-weighted
    odometry, loop closures to old keyframes (pinned, later frozen),
    windowed trims and an optimize every 3rd keyframe, through both
    managers side by side."""
    rng = np.random.default_rng(window)
    est, _ = drift_chain(rng, 40, 0)
    ref = (torch.zeros(4, 5, 3), torch.zeros(4, 5, 3),
           torch.zeros(4, 5, dtype=torch.bool))
    kw = dict(window=window, keyframe_every=2, max_pinned=max_pinned)
    a, b = JaxKeyframeManager(**kw), KeyframeManager(**kw, device="cpu")
    for f in range(40):
        red = np.zeros(32, np.float32)
        red[28] = rng.integers(0, 5000)
        added = a.maybe_add(f, est[f], red)
        assert b.maybe_add(f, t(est[f]), t(red), ref_maps=ref) == added
        if not added:
            continue
        assert b.nearest_revisit(est[f], max_dist=2.0) == \
            a.nearest_revisit(est[f], max_dist=2.0)
        if f % 10 == 0 and len(a.poses) > 4:
            k = int(rng.integers(0, len(a.poses) - 3))
            m = (np.linalg.inv(a.poses[k]) @ est[f] @ rand_poses(rng, 1,
                                                                 0.01)[0])
            for km in (a, b):
                km.add_loop_closure(k, len(km.poses) - 1, m, 3.0)
        if len(a.poses) % 3 == 0:
            np.testing.assert_allclose(b.optimize(), a.optimize(), atol=TOL)
            np.testing.assert_allclose(b.correction_for_latest(),
                                       a.correction_for_latest(), atol=TOL)
        _same_manager(a, b)
    assert any(a.pinned) and any(a.frozen)
    assert len(b.ref_maps) == len(b.poses)
    for (fa, ca), (fb, cb) in zip(a.frame_corrections(),
                                  b.frame_corrections()):
        assert fa == fb
        np.testing.assert_allclose(cb, ca, atol=TOL)


def test_pinned_anchor_survives_trim():
    """JAX's anchor drive: a closure anchor outlives eight trims, frozen,
    with its maps, and optimize holds it fixed."""
    km = KeyframeManager(window=4, keyframe_every=1, device="cpu")
    maps = (torch.ones(2, 2, 3), torch.ones(2, 2, 3),
            torch.ones(2, 2, dtype=torch.bool))
    for f in range(4):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * f
        km.maybe_add(f, T, ref_maps=maps)
    km.add_loop_closure(0, 3, np.eye(4, dtype=np.float32), 1.0)
    for f in range(4, 12):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * f
        km.maybe_add(f, T, ref_maps=maps)
    assert km.frames[0] == 0 and km.pinned[0] and km.frozen[0]
    assert km.ref_maps[0] is not None and km.ref_maps[0][0] is not maps[0]
    before = km.poses[0].copy()
    out = km.optimize(iters=5)
    np.testing.assert_allclose(out[0], before, atol=1e-6)
    assert np.isfinite(out).all()


def _jax_manager(g):
    return JaxKeyframeManager(window=int(g["window"]),
                              keyframe_every=int(g["every"]))


def _assert_same_analysis(a, b):
    """Two ``tools/ba_loop.analyse`` reports agree to TOL."""
    assert [c["keyframes"] for c in a["closure"]] == \
        [c["keyframes"] for c in b["closure"]]
    for x, y in zip(a["closure"] + a["counterfactual"] + [a["replay"]],
                    b["closure"] + b["counterfactual"] + [b["replay"]]):
        for k, v in x.items():
            if isinstance(v, float):
                assert abs(v - y[k]) <= TOL, (k, v, y[k])
        for k, v in x.get("shifted", {}).items():
            assert abs(v - y["shifted"][k]) <= TOL, (k, v, y["shifted"][k])


def test_ba_loop_replays_the_run_and_matches_jax(tmp_path):
    """``tools/ba_loop``: the CLI with ``--keyframe-rate 2`` over the orbit
    that goes out and comes back (one closure, frame 10 against frame 4).
    Its graph replayed offline gives the run's ATE, and JAX's keyframe
    manager replaying the same graph gives the same report (the replay,
    the closure's errors and every counterfactual ATE) to 1e-5."""
    from test_torch_cli import ORBIT_ARGS
    from test_torch_pipeline import write_there_and_back
    from supereight_tpu_torch.tools import ba_loop
    raw = write_there_and_back(str(tmp_path / "orbit.raw"))
    pipe, frames, xyz, gt, ate = ba_loop.run_cli(
        ["-i", raw, "-g", raw + ".gt.txt", "-o", str(tmp_path / "log"),
         "--platform", "cpu", "--keyframe-rate", "2"] + ORBIT_ARGS)
    g = ba_loop.graph_of(pipe.keyframes, pipe._ba_every)
    assert g["closure_ij"].tolist() == [[0, 3]]
    port = ba_loop.analyse(g, frames, xyz, gt, ba_loop.cpu_manager,
                           shifts=(0.01,))
    assert abs(port["replay"]["ate"] - ate) <= TOL
    _assert_same_analysis(port, ba_loop.analyse(g, frames, xyz, gt,
                                                _jax_manager, (0.01,)))
    # the closure measures the loop better than the tracker did
    c = port["closure"][0]
    assert c["measured_err_m"] < c["drift_err_m"]


def test_loop_graph_from_the_card_replays_as_jax():
    """The 250-frame loop's keyframe graph as the ``tsdf icp+BA`` row built
    it on an H100 (``tests/data/loop_ba_graph.npz``, written by
    ``tools/ba_loop.py --graph-out``): the port's keyframe manager on the
    CPU replays it to the run's ATE, and JAX's manager gives the same
    report (the replay, the closure's errors and the ATE with the
    closure's measurement true) to 1e-5."""
    from supereight_tpu_torch.tools import ba_loop
    path = os.path.join(os.path.dirname(__file__), "data",
                        "loop_ba_graph.npz")
    g = dict(np.load(path))
    frames, xyz, gt = g.pop("frames"), g.pop("xyz"), g.pop("gt_poses")
    run_ate = float(g.pop("run_ate"))
    port = ba_loop.analyse(g, frames, xyz, gt, ba_loop.cpu_manager,
                           shifts=())
    assert len(port["closure"]) >= 1
    assert abs(port["replay"]["ate"] - run_ate) <= TOL
    _assert_same_analysis(port, ba_loop.analyse(g, frames, xyz, gt,
                                                _jax_manager, ()))
