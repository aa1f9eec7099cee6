"""The port's sharded frame step (``parallel/dist_step.py``) against JAX's
``make_dist_step`` over ``make_mesh(4)``, on the CPU.

The port runs as four Gloo ranks on the CPU through
``tools/dist_run.py`` (every kernel through its twin); JAX runs its
``shard_map`` step on four of the eight virtual CPU devices that
``conftest.py`` gives it. The scene is ``tests/test_dist.py``'s orbit
(64x48, 64^3 voxels over 2 m, 256 blocks a rank, ICP 3/2, 6 frames). Each
side runs once per module (fixtures). Tolerances: poses 2e-3 a frame
(``tests/test_dist.py:83``), integer state exactly, the TSDF pool to 1e-5
and the OFusion pool and mips to 1e-4 (XLA on the CPU contracts into FMAs;
the kernels and twins round every product, ROADMAP.md Queue 3).

Then one test per sharded kernel mode, its twin against the JAX
function it replaces: K6's per-iteration reduction and update (JAX
``track`` in its ``axis_name`` mode), K5's marches over a column window
(``x_offset``) and the owner-masked allocation, the halo worklist, and
K1's column window against the whole image's rays.
"""

import functools
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from supereight_tpu.core import map as jax_map
from supereight_tpu.core import se3 as jax_se3
from supereight_tpu.core.map import MapGeometry as JaxGeometry
from supereight_tpu.fields import get_field
from supereight_tpu.ops import allocation as jax_alloc
from supereight_tpu.ops import tracking as jax_tracking
from supereight_tpu.parallel import dist_step as jax_dist
from supereight_tpu_torch import convert
from supereight_tpu_torch.core.map import MapGeometry, touched_buffer
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.kernels import _lib, alloc, frame, halo, icp, nav
from supereight_tpu_torch.kernels import raycast as kray
from supereight_tpu_torch.parallel import dist_step, step
from supereight_tpu_torch.parallel.distributed import Collectives
from supereight_tpu_torch.pipeline import preprocess_and_pyramid
from supereight_tpu_torch.tools import dist_run

from test_torch_step import (DIM, FIELDS, MU, H, K, W, jax_frames, k_torch,
                             make_scene, torch_frames)

D = 4
CAP_LOCAL = 256
N = 6
ITERATIONS = (3, 2)
POOL_TOL = {"tsdf": 1e-5, "ofusion": 1e-4}
# port cases: (name, field, frustum halo, ground-truth poses)
CASES = (("tsdf_exact", "tsdf", False, False),
         ("ofusion_exact", "ofusion", False, False),
         ("tsdf_gt", "tsdf", True, True),
         ("ofusion_gt", "ofusion", False, True),
         ("tsdf_frustum", "tsdf", True, False))
DROPS = ("alloc_overflow", "blocks_truncated", "ray_overflow",
         "halo_overflow")


CAPTURE = 4  # the frame of tsdf_exact whose calls rank 1 captures


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dist"))


@pytest.fixture(scope="module")
def port(port_dir):
    """Every port case in one four-rank run: [rank] -> results."""
    cases = [{"name": n, "field": f, "frustum_halo": fr, "use_gt_pose": gt,
              "save_map": gt} for n, f, fr, gt in CASES]
    cases[0]["capture"] = CAPTURE
    return dist_run.launch(D, "gloo", "cpu", port_dir, "test", cases)


def _jax_run(field, frustum, gt):
    depths, poses = make_scene(N)
    mesh = jax_dist.make_mesh(D)
    geom = JaxGeometry(size=64, dim=DIM, capacity=CAP_LOCAL)
    stepf = jax_dist.make_dist_step(
        mesh, geom, get_field(field), frame_size=(W, H),
        iterations=ITERATIONS, mu=MU[field], icp_threshold=1e-5,
        frustum_halo=frustum, use_gt_pose=gt)
    state = jax_dist.init_dist_state(mesh, geom, get_field(field), (W, H),
                                     poses[0])
    k = jnp.asarray(K, jnp.float32)
    traj, auxes = [], []
    for i in range(N):
        g = jnp.asarray(poses[i], jnp.float32) if gt else None
        state, aux = stepf(state, jnp.asarray(depths[i]), k, jnp.int32(i), g)
        traj.append(np.asarray(state.pose))
        auxes.append(jax.tree.map(np.asarray, aux))
    return jax.tree.map(np.asarray, state), np.stack(traj), auxes


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded step, once per (case) of :data:`CASES` but the
    frustum tracking one (held against the port's exact run)."""
    return {n: _jax_run(f, fr, gt) for n, f, fr, gt in CASES
            if n != "tsdf_frustum"}


@pytest.mark.parametrize("name", ["tsdf_exact", "ofusion_exact"])
def test_exact_halo_matches_jax_frame_by_frame(port, jax_runs, name):
    _, traj, auxes = jax_runs[name]
    for r, res in enumerate(port):
        np.testing.assert_allclose(res[name + ".poses"], traj, atol=2e-3,
                                   err_msg=f"rank {r}")
        for i, aux in enumerate(auxes):
            np.testing.assert_array_equal(
                res[name + ".aux.n_blocks_dev"][i], aux["n_blocks_dev"])
            assert bool(res[name + ".aux.tracked"][i]) == bool(
                aux["tracked"]), i
            for c in DROPS:
                assert int(aux[c]) == 0 and int(
                    res[f"{name}.aux.{c}"][i]) == 0, (c, i)
    assert bool(port[0][name + ".aux.tracked"][-1])


@pytest.mark.parametrize("name,field,frustum,gt", CASES,
                         ids=[c[0] for c in CASES])
def test_collectives_a_frame(port, name, field, frustum, gt):
    """Every rank issues the same collectives: each frame the reference
    maps' all-gather, one all-reduce a Gauss-Newton iteration (none with
    ground-truth poses), the touched buffer's, mip_alloc's and the
    counters' all-reduces, and from frame 3 the halo's all-gather; the
    all-gathers move the rank's column slices and its halo send buffer."""
    icp = 0 if gt else sum(ITERATIONS)
    ref = H * (W // D) * 7 * 4
    for r, res in enumerate(port):
        calls = json.loads(str(res[name + ".comm_calls"]))
        sent = json.loads(str(res[name + ".comm_bytes"]))
        assert calls == {"all_gather": 2 * N - 3,
                         "all_reduce": N * (3 + icp)}, r
        assert sent["all_gather"] == N * ref + (N - 3) * halo.halo_rows(
            int(res[name + ".halo_budget"])) * 512 * 4, r
        assert res[name + ".comm_s"].shape == (N,)


def test_capture_copies_each_call_before_it(port, port_dir):
    """``dist_run``'s capture frame: rank 1 saves a copy of the arguments
    of every kernel wrapper and op the step calls, taken before the call
    (the allocation's map still holds the ranks' union of touched grids,
    which the call clears), with nav_grid's result; the step's functions
    are restored after it."""
    cap = torch.load(os.path.join(port_dir, "capture_tsdf_exact.pt"),
                     weights_only=False)
    assert (cap["frame"], cap["rank"], cap["world"]) == (CAPTURE, 1, D)
    assert sorted(cap["calls"]) == sorted(
        ["track", "touched_mask", "alloc_assign", "integrate", "halo_pack",
         "nav_grid", "raycast_rays"])
    assert "group" not in cap["calls"]["track"]["kwargs"]
    m = cap["calls"]["alloc_assign"]["args"][1]
    assert m.touched.any()
    (hgeom, hs, fld), _, nav_step = (cap["calls"]["nav_grid"][k]
                                     for k in ("args", "kwargs", "result"))
    assert torch.equal(nav.nav_grid_plain(hgeom, hs, fld), nav_step)
    kw = cap["calls"]["raycast_rays"]["kwargs"]
    assert (kw["x0"], kw["width"]) == (W // D, W // D)
    mods = {m: importlib.import_module(m) for m, _ in dist_run.CAPTURED}
    fns = {(m, n): getattr(mods[m], n) for m, names in dist_run.CAPTURED
           for n in names}
    with dist_run.capturing({}):
        assert all(getattr(mods[m], n) is not f for (m, n), f in fns.items())
    assert all(getattr(mods[m], n) is f for (m, n), f in fns.items())


@pytest.mark.parametrize("name", ["tsdf_gt", "ofusion_gt"])
def test_ground_truth_state_matches_jax_per_rank(port, jax_runs, name):
    """Each rank's map equals JAX's shard r: slot grid, block coordinates
    and counts exactly, mip existence exactly, the pool and mips to
    float tolerance; the ranks' blocks are the single-device port's."""
    state, _, auxes = jax_runs[name]
    field = name.split("_")[0]
    m = state.map
    tol = POOL_TOL[field]
    cells = []
    for r, res in enumerate(port):
        rows = slice(r * CAP_LOCAL, (r + 1) * CAP_LOCAL)
        n = int(m.n_blocks[r])
        assert int(res[name + ".map.n_blocks"]) == n > 0
        np.testing.assert_array_equal(res[name + ".map.slot"], m.slot[r])
        np.testing.assert_array_equal(res[name + ".map.block_coord"][:n],
                                      m.block_coord[rows][:n])
        for ch in ("data_x", "data_y"):
            np.testing.assert_allclose(res[f"{name}.map.{ch}"][:n],
                                       getattr(m, ch)[rows][:n], atol=tol,
                                       rtol=0, err_msg=f"rank {r} {ch}")
        for lvl in range(len(m.mip_alloc)):
            np.testing.assert_array_equal(
                res[f"{name}.map.mip_alloc.{lvl}"], m.mip_alloc[lvl])
            for ch in ("mip_x", "mip_y"):
                np.testing.assert_allclose(
                    res[f"{name}.map.{ch}.{lvl}"], getattr(m, ch)[lvl],
                    atol=tol, rtol=0, err_msg=f"rank {r} {ch} {lvl}")
        cells.append(res[name + ".map.block_coord"][:n])
        for i, aux in enumerate(auxes):
            for c in DROPS + ("halo_blocks",):
                assert int(res[f"{name}.aux.{c}"][i]) == int(aux[c]), (c, i)
    want = {tuple(c) for c in single_blocks(field)}
    got = {tuple(c) for c in np.concatenate(cells)}
    assert got == want


def single_blocks(field):
    """The block coordinates of the single-device port over the scene with
    ground-truth poses."""
    depths, poses = make_scene(N)
    geom = MapGeometry(size=64, dim=DIM, capacity=D * CAP_LOCAL)
    state = step.init_frame_state(geom, FIELDS[field], (W, H), poses[0],
                                  "cpu")
    for i in range(N):
        state, _ = step.frame_step(
            geom, FIELDS[field], state, torch.from_numpy(depths[i]),
            k_torch(), i, torch.from_numpy(poses[i].astype(np.float32)),
            frame_size=(W, H), iterations=ITERATIONS, mu=MU[field],
            icp_threshold=1e-5, neg_y=False, filter_input=False,
            use_gt_pose=True, integration_rate=1, budget=D * CAP_LOCAL)
    n = int(state.map.n_blocks)
    return state.map.block_coord[:n].numpy()


def test_frustum_halo_matches_jax_and_exact(port, jax_runs):
    """The frustum halo sends JAX's blocks (ground-truth poses) and tracks
    within 5e-3 of the exact halo (``tests/test_dist.py:96``)."""
    _, _, auxes = jax_runs["tsdf_gt"]
    res = port[0]
    got = res["tsdf_gt.aux.halo_blocks"]
    np.testing.assert_array_equal(got, [int(a["halo_blocks"])
                                        for a in auxes])
    assert got[-1] > 0
    np.testing.assert_allclose(res["tsdf_frustum.poses"][-1],
                               res["tsdf_exact.poses"][-1], atol=5e-3)
    for c in DROPS:
        assert not res["tsdf_frustum.aux." + c].any(), c
    assert res["tsdf_frustum.aux.halo_blocks"][-1] > 0


@pytest.mark.parametrize("d", [2, 4, 8])
def test_owner_grid_matches_jax(d):
    geom = MapGeometry(size=64, dim=2.0, capacity=64)
    got = dist_step.owner_grid(geom, d, device="cpu").numpy()
    want = jax_dist.owner_grid(JaxGeometry(size=64, dim=2.0, capacity=64), d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b", [8, 16, 64])
@pytest.mark.parametrize("d", [2, 4])
def test_arithmetic_owner_matches_owner_grid_and_jax(d, b):
    """The owner that ``csrc/alloc.cu`` computes (``tile_owner``: the
    morton code of the cell's 4^3 super-brick mod D), in its plain form
    ``alloc.owner_cells``, is the step's ``owner_grid`` and equals JAX's
    ``owner_grid`` (morton code // 64 mod D), cell for cell."""
    size = 8 * b
    geom = MapGeometry(size=size, dim=2.0, capacity=64)
    got = alloc.owner_cells(b, alloc.Owners(d), device="cpu")
    assert got.dtype == torch.int32 and got.shape == (b, b, b)
    np.testing.assert_array_equal(
        got.numpy(), dist_step.owner_grid(geom, d, device="cpu").numpy())
    want = jax_dist.owner_grid(JaxGeometry(size=size, dim=2.0, capacity=64),
                               d)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want).tolist()) == set(range(d))


def test_owners_take_only_the_super_brick_tile():
    """``alloc_assign`` refuses ownership in tiles other than the 4^3
    super-brick the kernel's arithmetic takes, and a rank outside the
    world; with :class:`Owners` its twin allocates as with the owner
    grid."""
    geom = MapGeometry(size=64, dim=2.0, capacity=512)
    b = geom.blocks_per_side
    rng = np.random.default_rng(7)
    grid = torch.from_numpy(rng.random((b, b, b)) < 0.3)
    for bad, rank in ((alloc.Owners(4, 8), 0), (alloc.Owners(4), 4)):
        with pytest.raises(ValueError):
            alloc.alloc_assign(geom, step.init_frame_state(
                geom, TSDF, (W, H), np.eye(4), "cpu").map, grid.clone(),
                owner=bad, rank=rank)
    maps = [step.init_frame_state(geom, TSDF, (W, H), np.eye(4), "cpu").map
            for _ in range(2)]
    for m, owner in zip(maps, (alloc.Owners(4),
                               dist_step.owner_grid(geom, 4, device="cpu"))):
        t = grid.clone()
        alloc.alloc_assign(geom, m, t, owner=owner, rank=2)
        assert not t.any()
    for key in ("slot", "block_coord", "active", "n_blocks"):
        assert torch.equal(getattr(maps[0], key), getattr(maps[1], key))
    assert 0 < int(maps[0].n_blocks) < int(grid.sum())


def _comm(world, rank=0):
    """A :class:`Collectives` of ``world`` ranks without a process group
    (its collectives are not called)."""
    c = Collectives.__new__(Collectives)
    c.group, c.world, c.rank = None, world, rank
    c.reset()
    return c


@pytest.mark.parametrize("field, size, world", [
    (TSDF, (64, 48), 3),      # 64 % 3
    (TSDF, (36, 48), 4),      # level 0 slice of 9 columns, stride 2
    (TSDF, (40, 48), 8),      # level 1 is 20 wide, 20 % 8
    (OFUSION, (48, 48), 4)])  # a slice of 12 columns, stride 8
def test_width_that_does_not_divide_is_refused(field, size, world):
    geom = MapGeometry(size=64, dim=2.0, capacity=64)
    with pytest.raises(ValueError, match="frame width"):
        dist_step.make_dist_step(_comm(world), geom, field, frame_size=size,
                                 iterations=ITERATIONS, mu=0.1,
                                 icp_threshold=1e-5)
    dist_step.make_dist_step(_comm(4), geom, TSDF, frame_size=(64, 48),
                             iterations=ITERATIONS, mu=0.1,
                             icp_threshold=1e-5)


# ---- the sharded kernel modes: twins against JAX ------------------------

@pytest.fixture(scope="module")
def frame4():
    """JAX's single-device state after frames 0-3 (numpy) and frame 4's
    depth and pose."""
    depths, poses = make_scene(5)
    states, _ = jax_frames(depths, poses, 4)
    return states[-1], depths[4], poses[4]


def test_mode_a_sharded_reduction_and_update_match_jax(frame4):
    """K6 over four column windows, summed (icp_reduce64_plain) and one
    icp_update_plain, against JAX's ``track`` in its ``axis_name`` mode
    over a four-device mesh (one iteration): the psum'd reduction and the
    pose."""
    st, depth, _ = frame4
    k = k_torch()
    ts = convert.frame_to_torch(st, "cpu")
    _, v, n, ok = preprocess_and_pyramid(torch.from_numpy(depth), k, 1,
                                         False, False)
    view = frame.frame_mats(k, ts.raycast_pose).view
    red = torch.zeros(32, dtype=torch.float64)
    for r in range(D):
        _, part = icp.icp_reduce64_plain(v[0], n[0], ok[0], ts.vertex,
                                         ts.normal, ts.valid, ts.pose, view,
                                         x0=r * (W // D), width=W // D)
        red += part
    (carry, checked) = icp.icp_update_plain(red, ts.pose, None, True, 1e-5,
                                            ts.pose, (H, W))

    mesh = jax_dist.make_mesh(D)

    def one(pose, rpose, kk, vv, nn, oo, rv, rn, ro):
        return jax_tracking.track(pose, rpose, kk, (vv,), (nn,), (oo,), rv,
                                  rn, ro, (1,), 1e-5, axis_name=jax_dist.AXIS,
                                  n_shards=D)[:3]

    fn = jax.shard_map(one, mesh=mesh, in_specs=(P(),) * 9,
                       out_specs=(P(), P(), P()), check_vma=False)
    pose, tracked, jred = fn(*(jnp.asarray(a) for a in (
        st.pose, st.raycast_pose, np.asarray(K, np.float32), v[0].numpy(),
        n[0].numpy(), ok[0].numpy(), st.vertex, st.normal, st.valid)))
    jred = np.asarray(jred)
    np.testing.assert_allclose(carry.reduction.numpy(), jred, rtol=1e-4,
                               atol=1e-4 * np.abs(jred).max())
    np.testing.assert_allclose(checked[0].numpy(), np.asarray(pose),
                               atol=1e-5)
    assert bool(checked[1]) == bool(tracked)


# the fused mode's cases: (the update's first_of_level, the reduced
# iteration's first_of_level, whether a carry comes in, its done flag)
STEP_CASES = {"first_of_frame": (True, False, False, False),
              "first_of_level": (False, True, True, False),
              "mid_level": (False, False, True, False),
              "frozen": (False, False, True, True)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mode_a_fused_step_equals_update_then_reduce(frame4, case):
    """K6's fused mode (``icp_reduce_step``: the previous iteration's
    update folded into the next one's reduction) on rank 1's window of
    level 0, after level 1's reduction summed over the four windows: its
    twin equals ``icp_update_plain`` then ``icp_reduce64_plain`` at the
    stepped pose bit for bit, and so does the wrapper on CPU tensors,
    writing into the buffers it is given and counting no launch. A
    frozen iteration's sums are zeros, and the next update from them
    leaves the carry as it was."""
    st, depth, _ = frame4
    k = k_torch()
    ts = convert.frame_to_torch(st, "cpu")
    _, v, n, ok = preprocess_and_pyramid(torch.from_numpy(depth), k, 2,
                                         False, False)
    view = frame.frame_mats(k, ts.raycast_pose).view
    ref = (ts.vertex, ts.normal, ts.valid)
    red = torch.zeros(32, dtype=torch.float64)
    for r in range(D):
        red += icp.icp_reduce64_plain(v[1], n[1], ok[1], *ref, ts.pose, view,
                                      x0=r * (W // 2 // D),
                                      width=W // 2 // D)[1]
    first, next_first, with_carry, done = STEP_CASES[case]
    carry = icp.Carry(ts.pose.clone(), red.to(torch.float32) * 0.5,
                      torch.tensor(done)) if with_carry else None
    level0 = (v[0], n[0], ok[0], *ref, view)
    win = dict(x0=W // D, width=W // D)
    new, sums = icp.icp_reduce_step_plain(red, ts.pose, carry, first,
                                          next_first, 1e-5, *level0, **win)
    want, _ = icp.icp_update_plain(red, ts.pose, carry, first, 1e-5)
    for a, b in zip(new, want):
        assert torch.equal(a, b)
    if done:
        assert not bool(sums.any())
        again, _ = icp.icp_update_plain(sums, new.pose, new, False, 1e-5)
        for a, b in zip(again, new):
            assert torch.equal(a, b)
        for a, b in zip(new, carry):
            assert torch.equal(a, b)
    else:
        _, direct = icp.icp_reduce64_plain(*level0[:6], want.pose, view,
                                           **win)
        assert torch.equal(sums, direct) and bool(sums.any())
    before = dict(_lib.LAUNCHES)
    out = torch.full((32,), float("nan"), dtype=torch.float64)
    bufs = icp.Carry(torch.zeros(4, 4), torch.zeros(32),
                     torch.zeros((), dtype=torch.bool))
    got, got_sums = icp.icp_reduce_step(red, ts.pose, carry, first,
                                        next_first, 1e-5, *level0, out=out,
                                        carry_out=bufs, **win)
    assert got_sums is out and torch.equal(out, sums)
    for a, b, c in zip(got, bufs, new):
        assert a is b and torch.equal(a, c)
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_mode_b_windowed_march_and_owned_allocation_match_jax(frame4,
                                                               field):
    """K5's march over each rank's columns equals JAX's with ``x_offset``
    exactly, and alloc_assign with the owner mask equals JAX's
    ``allocate_blocks`` of ``touched & (own == rank)``."""
    st, depth, pose = frame4
    jgeom = JaxGeometry(size=64, dim=DIM, capacity=1024)
    geom = MapGeometry(size=64, dim=DIM, capacity=1024)
    mu = MU[field]
    k = k_torch()
    pose_t = torch.from_numpy(pose.astype(np.float32))
    kpose = frame.frame_mats(k, pose_t).kpose
    dt = torch.from_numpy(depth)
    b = geom.blocks_per_side
    union = touched_buffer(b, "cpu")
    for r in range(D):
        x0, w = r * (W // D), W // D
        buf = touched_buffer(b, "cpu")
        dslice = jnp.asarray(depth[:, x0:x0 + w])
        if field == "tsdf":
            got = (alloc.touched_mask(geom, dt, pose_t, kpose, mu, buf, x0,
                                      w),)
            want = (jax_alloc.tsdf_touched_mask(jgeom, dslice, pose,
                                                jnp.asarray(K), mu,
                                                x_offset=x0),)
        else:
            got = alloc.touched_masks_of(geom, dt, pose_t, kpose, mu, buf,
                                         None, x0, w)
            t0, extra = jax_alloc.ofusion_touched_masks(
                jgeom, dslice, pose, jnp.asarray(K), mu, x_offset=x0)
            want = (t0,) + tuple(e for e in extra[1:3])
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        union |= buf
    jm = st.map
    own = dist_step.owner_grid(geom, D, device="cpu")
    grids = alloc._grids(geom, union, union.device, 1)
    for r in range(D):
        tm = convert.map_to_torch(jm, "cpu")
        t = union.clone()
        g0 = alloc._grids(geom, t, t.device, 1)[0]
        overflow = alloc.alloc_assign(geom, tm, g0, owner=own, rank=r)
        jstate, stats = jax_map.allocate_blocks(
            jgeom, jax.tree.map(jnp.asarray, jm),
            jnp.asarray(grids[0].numpy() & (own.numpy() == r)),
            with_stats=True)
        assert int(overflow) == int(stats["alloc_overflow"])
        for key in ("slot", "block_coord", "active", "n_blocks"):
            np.testing.assert_array_equal(getattr(tm, key).numpy(),
                                          np.asarray(getattr(jstate, key)))
        assert not g0.any()


@pytest.mark.parametrize("frustum", [True, False])
def test_mode_c_halo_worklist_matches_jax(frame4, frustum):
    """The halo compaction equals JAX's ``build_halo_worklist`` (slots and
    count), under a budget that fits and one that overflows; the pack's
    rows are the listed blocks' bricks and cells."""
    st, _, pose = frame4
    geom = MapGeometry(size=64, dim=DIM, capacity=1024)
    jgeom = JaxGeometry(size=64, dim=DIM, capacity=1024)
    tm = convert.map_to_torch(st.map, "cpu")
    pose_t = torch.from_numpy(pose.astype(np.float32))
    mats = frame.frame_mats(k_torch(), pose_t)
    n = int(tm.n_blocks)
    for budget in (1024, n // 3):
        wl, cnt = halo.build_halo_worklist_plain(
            geom, tm, mats.t_cw, mats.kmat, (W, H), budget, 0.3, frustum)
        jwl, jcnt = jax_dist.build_halo_worklist(
            jgeom, jax.tree.map(jnp.asarray, st.map),
            jax_se3.inverse(jnp.asarray(pose)),
            jax_se3.camera_matrix(jnp.asarray(K, jnp.float32)), (W, H),
            budget, 0.3, frustum)
        np.testing.assert_array_equal(wl.numpy(), np.asarray(jwl))
        assert int(cnt) == int(jcnt) > 0
        send, counts = halo.halo_pack(geom, tm, mats.t_cw, mats.kmat, (W, H),
                                      budget, 0.3, frustum)
        filled = min(int(cnt), budget)
        assert counts.tolist() == [filled, int(cnt) - filled]
        slots = wl[:filled].long()
        assert torch.equal(send[:filled], tm.data_x[slots])
        assert torch.equal(send[budget:budget + filled], tm.data_y[slots])
        bc = tm.block_coord[slots]
        b = geom.blocks_per_side
        cells = halo.cells_of(send, budget)
        assert torch.equal(cells[:filled],
                           (bc[:, 0] * b + bc[:, 1]) * b + bc[:, 2])
        assert bool((cells[filled:] == b ** 3).all())


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_mode_d_column_window_equals_whole_image_columns(field):
    """K1's twin over each rank's column window gives the whole image's
    rays at those columns, bit for bit (JAX's sharded raycast slices the
    same rays, ``dist_step.py:411-419``)."""
    depths, poses = make_scene(5)
    state, _, _ = torch_frames(depths, poses, 4, field)
    geom = MapGeometry(size=64, dim=DIM, capacity=1024)
    k = k_torch()
    m = state.map
    nv = nav.nav_grid(geom, m, FIELDS[field])
    view = frame.frame_mats(k, state.pose).kpose
    depth = torch.from_numpy(depths[4])
    whole = kray.raycast_rays(geom, m, FIELDS[field], nv, view, depth, k,
                              MU[field], (W, H))
    for r in range(D):
        x0, w = r * (W // D), W // D
        got = kray.raycast_rays(geom, m, FIELDS[field], nv, view, depth, k,
                                MU[field], (W, H), x0=x0, width=w)
        for a, b_ in zip(got[:3], whole[:3]):
            assert torch.equal(a, b_[:, x0:x0 + w])
    assert bool(whole.valid.any())
