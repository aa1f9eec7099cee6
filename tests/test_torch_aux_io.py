"""The port's auxiliary IO against the JAX package's: the ``.scf`` reader
(``io/scf.py``), the debug dumps (``io/debug_io.py``), device telemetry
(``utils/telemetry.py``) and the run plots (``plots.py``).

The ``.scf`` fields equal JAX's over a file with every key; the four
dumps are byte-equal to JAX's on a map carried across by
``convert.map_to_torch``; ``DeviceMonitor`` samples nothing on the CPU,
as JAX's; the plots decode to JAX's pixels on the same rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu import config as jax_config
from supereight_tpu.core import map as jax_map
from supereight_tpu.fields import get_field as jax_field
from supereight_tpu.io import debug_io as jax_debug_io
from supereight_tpu.io import scf as jax_scf
from supereight_tpu.utils.telemetry import DeviceMonitor as JaxMonitor
from supereight_tpu_torch import convert
from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.core.map import MapGeometry
from supereight_tpu_torch.fields import get_field
from supereight_tpu_torch.io import debug_io, scf
from supereight_tpu_torch.utils.telemetry import DeviceMonitor

SCF = """
# every key of the reader, a comment and lines it skips
volume_resolution = 128
volume_size = 3.2   # trailing comment
compute_size_ratio = 4
integration_rate = 3
tracking_rate = 2
rendering_rate = 8
mu = 0.05
icp_threshold = 2e-6
field = ofusion
input_file = /data/seq.raw
log_file = run.log
groundtruth_file = seq.gt.txt
dump_volume_file = vol.npz
camera = 100,100.5,64,48
pyramid = 4,3,2
initial_pos_factor = 0.5, 0.25,0.125
unknown_key = 7
no equals sign here

"""


def fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("base", [False, True])
def test_parse_scf_every_field_equals_jax(base, tmp_path):
    p = tmp_path / "run.scf"
    p.write_text(SCF)
    if base:
        kw = dict(mu=0.2, volume_size=9.0, block_capacity=77)
        got = scf.parse_scf(str(p), Configuration(**kw))
        want = jax_scf.parse_scf(str(p), jax_config.Configuration(**kw))
    else:
        got = scf.parse_scf(str(p))
        want = jax_scf.parse_scf(str(p))
    assert isinstance(got, Configuration)
    assert fields(got) == fields(want)
    assert got.camera == (100.0, 100.5, 64.0, 48.0)
    assert got.pyramid == (4, 3, 2)
    assert got.initial_pos_factor == (0.5, 0.25, 0.125)
    assert got.volume_resolution == 128 and got.icp_threshold == 2e-6
    assert got.field == "ofusion" and got.dump_volume_file == "vol.npz"
    assert got.block_capacity == (77 if base else None)


def jax_random_map(field, seed):
    """A map with random values over a third of its blocks."""
    rng = np.random.default_rng(seed)
    geom = jax_map.MapGeometry(size=32, dim=2.0, capacity=32)
    state = jax_map.make_map(geom, jax_field(field))
    state = jax_map.allocate_blocks(geom, state,
                                    jnp.asarray(rng.random((4, 4, 4)) < 0.3))
    shape = np.shape(state.data_x)
    return geom, state._replace(
        data_x=jnp.asarray(rng.normal(size=shape), jnp.float32),
        data_y=jnp.asarray(rng.random(shape) * 10, jnp.float32),
        active=state.active.at[::3].set(False))


def port_map(geom, state):
    return (MapGeometry(geom.size, geom.dim, geom.capacity),
            convert.map_to_torch(state, "cpu"))


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_debug_dumps_byte_equal_jax(field, tmp_path):
    geom, state = jax_random_map(field, seed=4)
    pgeom, pstate = port_map(geom, state)
    cases = [
        ("slice_x", lambda f, g, s, fl, path: f.save_3d_slice(
            path, g, s, fl, (0, 0, 0), (16, 12, 9))),
        # a box past the map's edge, and the other channel
        ("slice_y", lambda f, g, s, fl, path: f.save_3d_slice(
            path, g, s, fl, (20, -2, 5), (36, 7, 11),
            select=lambda x, y: y)),
        ("blocks", lambda f, g, s, fl, path: f.save_block_list(path, g, s)),
    ]
    for name, dump in cases:
        a, b = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
        dump(debug_io, pgeom, pstate, get_field(field), a)
        dump(jax_debug_io, geom, state, jax_field(field), b)
        assert open(a, "rb").read() == open(b, "rb").read(), name
    blocks = open(tmp_path / "port_blocks").read().splitlines()
    assert len(blocks) == 1 + int(state.n_blocks) > 1
    assert any(ln.endswith(" 0") for ln in blocks[1:])


def test_point_cloud_and_normals_byte_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    T = np.eye(4)
    T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T[:3, 3] = rng.normal(size=3)
    for name, transform in (("plain", None), ("moved", T)):
        a, b = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
        debug_io.save_point_cloud(a, pts, transform)
        jax_debug_io.save_point_cloud(b, pts, transform)
        assert open(a, "rb").read() == open(b, "rb").read()
    normals = rng.uniform(-1.2, 1.2, size=(12, 20, 3)).astype(np.float32)
    a, b, c = (str(tmp_path / f"{n}.ppm") for n in ("port", "jax", "torch"))
    debug_io.print_normals(a, normals)
    jax_debug_io.print_normals(b, normals)
    debug_io.print_normals(c, torch.from_numpy(normals))
    assert open(a, "rb").read() == open(b, "rb").read() \
        == open(c, "rb").read()
    assert open(a, "rb").read().startswith(b"P6\n20 12\n255\n")


def test_device_monitor_samples_nothing_on_the_cpu():
    """No CUDA device here; JAX's CPU device has no memory stats."""
    ours, theirs = DeviceMonitor().sample(), JaxMonitor().sample()
    assert dict(ours.series) == dict(theirs.series) == {}
    mon = DeviceMonitor()
    assert mon.sample() is mon.stats


def log_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for f in range(n):
        r = {k: float(rng.uniform(1e-4, 5e-3)) for k in (
            "preprocessing", "tracking", "integration", "raycasting",
            "rendering")}
        r.update(frame=float(f), computation=sum(r.values()),
                 X=float(np.cos(f / 5)), Y=0.5, Z=float(np.sin(f / 5)))
        rows.append(r)
    rows[3]["computation"] = 0.0   # a frame with no time: a gap in fps
    return rows


def test_plots_equal_jax_pixels(tmp_path):
    pytest.importorskip("matplotlib")
    from matplotlib.image import imread

    from supereight_tpu import plots as jax_plots
    from supereight_tpu.cli import LOG_HEADER
    from supereight_tpu_torch import plots
    rows = log_rows(20, seed=6)
    rng = np.random.default_rng(7)
    gt = rng.normal(size=(20, 3))
    est = gt + rng.normal(size=(20, 3)) * 0.01
    for name, kw in (("bare", {}), ("both", dict(gt_xyz=gt, est_xyz=est))):
        a, b = (str(tmp_path / f"{who}_{name}.png") for who in ("port",
                                                                 "jax"))
        plots.plot_run(rows, a, **kw)
        jax_plots.plot_run(rows, b, **kw)
        pa, pb = imread(a), imread(b)
        assert pa.shape == pb.shape and pa.shape[0] > 100
        np.testing.assert_array_equal(pa, pb)
    log = tmp_path / "run.log"
    with open(log, "w") as f:
        f.write(LOG_HEADER + "\n")
        for r in rows:
            f.write("\t".join(str(r.get(k, 1.0)) for k in
                              LOG_HEADER.split("\t")) + "\n")
    a, b = str(tmp_path / "port_log.png"), str(tmp_path / "jax_log.png")
    plots.plot_log_file(str(log), a)
    jax_plots.plot_log_file(str(log), b)
    np.testing.assert_array_equal(imread(a), imread(b))
