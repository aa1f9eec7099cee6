"""The port's headline bench (``supereight_tpu_torch/tools/bench.py``)
against the JAX package's root ``bench.py``, and the trace reader
(``utils/deviceprof.py``).

The port's orbit at the bench's arguments is bit-equal to JAX's, and its
constants are ``bench.py``'s. The bench's frame callable at 64^3 voxels
over 3.0 m, 80x60 pixels, over the first 6 frames of its orbit, for both
fields on the CPU (the kernels' twins), follows JAX's ``frame_step`` with ``bench.py``'s
keyword arguments: poses to 2e-3, blocks and the tracked flag exactly,
JAX's drop counters 0 first. ``bench.py``'s arguments are read from its
source, so the two files cannot drift apart unseen. Without a CUDA device
the bench exits non-zero, names CUDA and prints no JSON line.
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from supereight_tpu.core.map import MapGeometry as JaxGeometry
from supereight_tpu.fields import get_field
from supereight_tpu.io import synthetic as jax_synthetic
from supereight_tpu.parallel import step as jax_step
from supereight_tpu_torch.tools import bench
from supereight_tpu_torch.utils import deviceprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CPU size: 64^3 voxels over 3.0 m (over 4.8 m the TSDF raycast of a
# 64^3 map finds 5 of 4,800 pixels), 80x60 pixels, the first 6 frames of
# the bench's 43-frame orbit (a 6-frame orbit turns 0.5 rad in 5 steps:
# the ICP from frame 4 is ill-conditioned and the packages part by 8 cm)
SMALL = dict(size=64, dim=3.0, capacity=512, frame_size=(80, 60))
N_RUN = 6
POSE_ATOL = 2e-3


def _main_of_jax_bench():
    with open(jax_bench.__file__) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _call(main, name):
    """The call of ``<module>.<name>(...)`` in bench.py's ``main``."""
    return next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == name)


def _assigned(main, name):
    """The expression ``name`` is assigned in bench.py's ``main``."""
    return next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in n.targets))


def _eval(node, **names):
    """A keyword's expression of bench.py, evaluated in its module's
    names (``names`` override or add to them)."""
    return eval(compile(ast.Expression(node), jax_bench.__file__, "eval"),
                {**vars(jax_bench), **names})


def jax_k():
    return _eval(_assigned(_main_of_jax_bench(), "k"))


def jax_mu(field):
    return _eval(_assigned(_main_of_jax_bench(), "mu"), field_name=field)


def jax_orbit(n, k=None, **names):
    """JAX's orbit_sequence called as bench.py calls it, for n frames
    (with the intrinsics ``k``, else bench.py's)."""
    call = _call(_main_of_jax_bench(), "orbit_sequence")
    kw = {a.arg: _eval(a.value, **names) for a in call.keywords}
    return jax_synthetic.orbit_sequence(n, k or jax_k(), **kw)


def jax_step_kw(geom, field, **names):
    """frame_step's keyword arguments as bench.py's partial gives them."""
    call = _call(_main_of_jax_bench(), "partial")
    return {k.arg: _eval(k.value, pstep=jax_step, geom=geom,
                         mu=jax_mu(field), **names)
            for k in call.keywords}


def test_constants_are_the_jax_bench():
    for name in ("W", "H", "SIZE", "DIM", "CAPACITY", "N_WARMUP",
                 "N_FRAMES", "N_TIMED", "BASELINE_FPS"):
        assert getattr(bench, name) == getattr(jax_bench, name), name
    assert bench.N_TOTAL == 43
    assert bench.K == jax_k()
    assert {f: jax_mu(f) for f in ("tsdf", "ofusion")} == bench.MU
    geom = JaxGeometry(size=bench.SIZE, dim=bench.DIM,
                       capacity=bench.CAPACITY)
    b = bench.config("tsdf", "cpu", n_frames=1)
    want = jax_step_kw(geom, "tsdf")
    assert b.kw == want
    assert (b.geom.size, b.geom.dim, b.geom.capacity) == (
        geom.size, geom.dim, geom.capacity)


def test_orbit_is_the_jax_bench_orbit():
    """Two frames at 320x240: the poses depend on the frame count."""
    b = bench.config("tsdf", "cpu", n_frames=2)
    depths, poses = jax_orbit(2)
    assert b.depths.shape == (2, bench.H, bench.W)
    np.testing.assert_array_equal(b.depths, depths)
    np.testing.assert_array_equal(b.poses, poses)
    for d, t in zip(depths, b.frames):
        np.testing.assert_array_equal(t.numpy(), d)
    np.testing.assert_array_equal(b.k.numpy(),
                                  np.asarray(jax_k(), np.float32))


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_frame_callable_follows_jax_frame_step(field):
    torch.set_num_threads(1)
    b = bench.config(field, "cpu", **SMALL)
    w, h = SMALL["frame_size"]
    # the intrinsics scale with the frame, as the compute ratio scales them
    k = tuple(c * w / jax_bench.W for c in jax_k())
    depths, poses = jax_orbit(bench.N_TOTAL, k, W=w, H=h, DIM=SMALL["dim"])
    np.testing.assert_array_equal(b.depths, depths)
    np.testing.assert_array_equal(b.poses, poses)
    geom = JaxGeometry(size=SMALL["size"], dim=SMALL["dim"],
                       capacity=SMALL["capacity"])
    kw = jax_step_kw(geom, field, W=w, H=h)
    assert b.kw == kw
    np.testing.assert_array_equal(b.k.numpy(), np.asarray(k, np.float32))
    kj = jnp.asarray(k, jnp.float32)
    jstate = jax_step.init_frame_state(geom, get_field(field), (w, h),
                                       poses[0])
    state = b.init()
    for i in range(N_RUN):
        jstate, jaux = jax_step.frame_step(geom, get_field(field), jstate,
                                           jnp.asarray(depths[i]), kj,
                                           jnp.int32(i), **kw)
        jpose = np.asarray(jstate.pose)
        jblocks = int(jstate.map.n_blocks)
        jaux = jax.tree.map(np.asarray, jaux)
        for c in bench.DROPS:
            assert int(jaux[c]) == 0, (i, c)
        state, aux = b.frame(state, i)
        np.testing.assert_allclose(state.pose.numpy(), jpose, atol=POSE_ATOL,
                                   rtol=0, err_msg=f"frame {i}")
        assert int(state.map.n_blocks) == jblocks, i
        assert bool(aux["tracked"]) == bool(jaux["tracked"]), i


def test_bench_refuses_without_cuda():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "supereight_tpu_torch.tools.bench"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert "{" not in out.stdout


def test_device_seconds_sums_device_events_only(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "pyramid_kernel", "ts": 0,
         "dur": 6.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 10,
         "dur": 2.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 20,
         "dur": 1.5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::zeros", "ts": 0,
         "dur": 40.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 3.0},
        {"ph": "X", "cat": "user_annotation", "name": "frame_step/track",
         "ts": 0, "dur": 50.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "frame_step/track",
         "ts": 0, "dur": 30.0},
        {"ph": "s", "cat": "ac2g", "name": "launch", "ts": 1},
        {"ph": "f", "cat": "ac2g", "name": "launch", "ts": 2},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    seconds, n = deviceprof.device_seconds(str(path))
    assert n == 3
    assert seconds == pytest.approx(10e-6, rel=1e-12)
