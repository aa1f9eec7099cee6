"""Parity of the port's fused frame step with the JAX reference.

Frames of the synthetic orbit (the ``test_dist.py`` scene: 64^3 voxels
over 2.0 m, 64x48 pixels, ICP iterations (3, 2)) go through JAX
``frame_step`` on the CPU and the port's ``frame_step`` on CPU tensors
(the kernels' plain twins): eight TSDF frames at mu 0.1 and six OFusion
frames at mu 0.008 (the OFusion bench's mu). Poses must agree frame by
frame to 2e-3 and the block count and every aux counter exactly, with
JAX's drop counters asserted zero first.

The scene helpers here are shared by the other ``test_torch_*`` files.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core.map import MapGeometry as JaxGeometry
from supereight_tpu.fields import get_field
from supereight_tpu.io import synthetic as jax_synthetic
from supereight_tpu.parallel import step as jax_step
from supereight_tpu_torch import convert
from supereight_tpu_torch.core.map import MapGeometry
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.io import synthetic
from supereight_tpu_torch.parallel import step

W, H = 64, 48
DIM = 2.0
K = (48.0, 48.0, 32.0, 24.0)
CAPACITY = 1024
N_FRAMES = 8
STEP_KW = dict(frame_size=(W, H), iterations=(3, 2), mu=0.1,
               icp_threshold=1e-5, neg_y=False, filter_input=False,
               use_gt_pose=False, integration_rate=1, tracking_rate=1,
               budget=CAPACITY)
MU = {"tsdf": 0.1, "ofusion": 0.008}
N_FRAMES_OF = 6
FIELDS = {"tsdf": TSDF, "ofusion": OFUSION}
COUNTERS = ("alloc_overflow", "blocks_truncated", "patch_skipped",
            "mip_skipped", "ray_overflow", "pool_bucket_overflow")
SCENE_KW = dict(width=W, height=H, radius=0.4 * DIM, center=(DIM / 2,) * 3,
                sphere_radius=0.15 * DIM, angle_span=0.3,
                room=((0.15,) * 3, (DIM - 0.15,) * 3))


def make_scene(n=N_FRAMES):
    """(depths [n, H, W], poses [n, 4, 4]) of the orbit, numpy."""
    return synthetic.orbit_sequence(n, K, **SCENE_KW)


def jax_geometry():
    return JaxGeometry(size=64, dim=DIM, capacity=CAPACITY)


def torch_geometry():
    return MapGeometry(size=64, dim=DIM, capacity=CAPACITY)


def k_jax():
    return jnp.asarray(K, jnp.float32)


def k_torch():
    return torch.tensor(K, dtype=torch.float32)


def step_kw(field="tsdf"):
    """The frame-step keywords of the test scene for ``field``."""
    return {**STEP_KW, "mu": MU[field]}


def jax_frames(depths, poses, n, field="tsdf", **options):
    """Run JAX frame_step over the first n frames (with the frame-step
    ``options``); returns the host (numpy) state and aux of every
    frame."""
    fn = functools.partial(jax_step.frame_step, jax_geometry(),
                           get_field(field), **{**step_kw(field), **options})
    state = jax_step.init_frame_state(jax_geometry(), get_field(field),
                                      (W, H), poses[0])
    states, auxes = [], []
    for i in range(n):
        state, aux = fn(state, jnp.asarray(depths[i]), k_jax(), jnp.int32(i))
        # host copies before the next call donates these buffers
        states.append(jax.tree.map(np.asarray, state))
        auxes.append(jax.tree.map(np.asarray, aux))
    return states, auxes


def assert_no_drops(aux):
    """Parity holds only where JAX dropped no work (its budget counters)."""
    for c in COUNTERS:
        assert int(aux[c]) == 0, (c, aux[c])


def test_scene_matches_jax_generator():
    """The port's numpy generator is bit-identical to the JAX package's."""
    d, p = make_scene(3)
    dj, pj = jax_synthetic.orbit_sequence(3, K, **SCENE_KW)
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(p, pj)


def torch_frames(depths, poses, n, field="tsdf", **options):
    """Run the port's frame_step over the first n frames on CPU tensors;
    returns the last state and the (numpy) pose and aux of every frame,
    each aux with ``touched_left``: the bytes set in the map's touched
    buffer after the frame."""
    geom = torch_geometry()
    state = step.init_frame_state(geom, FIELDS[field], (W, H), poses[0],
                                  "cpu")
    tposes, taux = [], []
    for i in range(n):
        state, aux = step.frame_step(geom, FIELDS[field], state,
                                     torch.from_numpy(depths[i]), k_torch(),
                                     i, **{**step_kw(field), **options})
        tposes.append(state.pose.numpy().copy())
        taux.append({k: v.numpy().copy() for k, v in aux.items()})
        taux[-1]["touched_left"] = int(state.map.touched.sum())
    return state, tposes, taux


@pytest.fixture(scope="module", params=["tsdf", "ofusion"])
def trajectories(request):
    torch.set_num_threads(1)
    n = N_FRAMES if request.param == "tsdf" else N_FRAMES_OF
    depths, poses = make_scene()
    jstates, jaux = jax_frames(depths, poses, n, request.param)
    jposes = [s.pose for s in jstates]
    _, tposes, taux = torch_frames(depths, poses, n, request.param)
    return jposes, jaux, tposes, taux


def test_frame_step_pose_parity(trajectories):
    jposes, jaux, tposes, _ = trajectories
    for a in jaux:
        assert_no_drops(a)
    # frames 0-3 cannot track (no raycast before frame 3)
    assert sum(bool(a["tracked"]) for a in jaux) >= min(3, len(jaux) - 4)
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        np.testing.assert_allclose(b, a, atol=2e-3,
                                   err_msg=f"frame {i} diverged")


@pytest.mark.parametrize("key", ("n_blocks", "tracked", "integrated")
                         + COUNTERS)
def test_frame_step_aux_parity(trajectories, key):
    _, jaux, _, taux = trajectories
    for i, (a, b) in enumerate(zip(jaux, taux)):
        assert int(b[key]) == int(a[key]), (i, key, a[key], b[key])


def test_touched_buffer_is_zero_after_every_frame(trajectories):
    """The map's touched buffer is all zero after every frame: the
    allocator consumed the grids the march wrote."""
    _, jaux, _, taux = trajectories
    assert sum(bool(a["integrated"]) for a in jaux) >= len(jaux) - 1
    assert [a["touched_left"] for a in taux] == [0] * len(taux)


def test_frame_step_result_codes(trajectories):
    """The finest-level ICP result map of every frame agrees."""
    _, jaux, _, taux = trajectories
    for i, (a, b) in enumerate(zip(jaux, taux)):
        agree = np.mean(a["track_result"] == b["track_result"])
        assert agree >= 0.999, (i, agree)


def test_min_ref_weight_is_a_no_op_for_ofusion():
    """JAX gates the raycast on the fusion weight for TSDF only
    (supereight_tpu/parallel/step.py:171): for OFusion, channel y is a
    time stamp and ``min_ref_weight`` changes nothing. For TSDF the gate
    runs and the step keeps to JAX's, frame by frame."""
    torch.set_num_threads(1)
    depths, poses = make_scene(5)
    base, bposes, baux = torch_frames(depths, poses, 5, "ofusion")
    gated, gposes, gaux = torch_frames(depths, poses, 5, "ofusion",
                                       min_ref_weight=3)
    assert sum(bool(a["tracked"]) for a in baux) >= 1
    np.testing.assert_array_equal(np.stack(gposes), np.stack(bposes))
    for a, b in zip(gaux, baux):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(gated)),
                    jax.tree.leaves(convert.to_numpy(base))):
        np.testing.assert_array_equal(a, b)
    # TSDF: the gate against JAX's, poses to 2e-3, the aux keys exactly
    jstates, jaux = jax_frames(depths, poses, 5, "tsdf", min_ref_weight=3)
    _, tposes, taux = torch_frames(depths, poses, 5, "tsdf",
                                   min_ref_weight=3)
    for i, (js, a, tp, b) in enumerate(zip(jstates, jaux, tposes, taux)):
        assert_no_drops(a)
        np.testing.assert_allclose(tp, js.pose, atol=2e-3,
                                   err_msg=f"frame {i} diverged")
        for key in ("n_blocks", "tracked", "integrated") + COUNTERS:
            assert int(b[key]) == int(a[key]), (i, key)
    assert bool(jaux[4]["tracked"])


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_convert_round_trip(field):
    """numpy -> torch -> numpy keeps every field of a JAX FrameState,
    the mip tuples included."""
    depths, poses = make_scene(3)
    states, _ = jax_frames(depths, poses, 1, field)
    js = states[0]
    back = convert.to_numpy(convert.frame_to_torch(js, "cpu"))
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(tuple(back))):
        np.testing.assert_array_equal(np.asarray(a), b)
