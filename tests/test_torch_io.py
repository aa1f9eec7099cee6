"""The port's configuration, dataset IO, map snapshots, evaluation and
``mm2meters`` against the JAX package's.

The port keeps its own copies of these numpy modules (it imports no JAX):
``config``, ``io/dataset``, ``io/synthetic``'s loop scene,
``io/convert``, ``io/serialise``, ``eval/{ate,rpe,sweep}`` and
``utils/perfstats``. Each is held to JAX's on the same inputs: .raw files
byte for byte, trajectories, scenes and statistics exactly, map snapshots
array for array in both directions (``touched`` left out and zeroed on
load), and ``mm2meters`` exactly over all 65,536 u16 values.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu import config as jax_config
from supereight_tpu.core import morton as jax_morton
from supereight_tpu.eval import ate as jax_ate
from supereight_tpu.eval import rpe as jax_rpe
from supereight_tpu.eval import sweep as jax_sweep
from supereight_tpu.io import convert as jax_convert
from supereight_tpu.io import dataset as jax_dataset
from supereight_tpu.io import native as jax_native
from supereight_tpu.io import serialise as jax_serialise
from supereight_tpu.io import synthetic as jax_synthetic
from supereight_tpu.ops import preprocess as jax_preprocess
from supereight_tpu_torch import config, convert
from supereight_tpu_torch.eval import ate, rpe, sweep
from supereight_tpu_torch.io import convert as io_convert
from supereight_tpu_torch.io import dataset, native, serialise, synthetic
from supereight_tpu_torch.ops.preprocess import mm2meters
from supereight_tpu_torch.utils.perfstats import PerfStats, StatType

JAX_ARGV = ["-c", "2", "-t", "1", "-r", "1", "-z", "0", "-v", "512", "-s",
            "4.8", "-p", "0.5,0.4583,0.18", "-y", "10,5,4", "-m", "0.1",
            "-l", "1e-6", "-k", "481.2,480,320,240", "--filter", "median2",
            "--fuse-filtered", "--min-ref-weight", "4", "--noise-weighted",
            "-f", "tsdf", "-i", "seq.raw", "-o", "log.txt", "-d", "map.npz",
            "-g", "gt.txt", "--block-capacity", "49152", "--preset-budget",
            "49152", "--max-frames", "250", "--depth-interp", "--platform",
            "cpu"]


def test_raw_round_trip_and_bytes(tmp_path):
    """write_raw then RawDepthReader; the file equals JAX's byte for byte,
    and each package reads the other's."""
    rng = np.random.default_rng(0)
    depths = rng.integers(0, 65536, size=(3, 24, 32)).astype(np.uint16)
    rgbs = rng.integers(0, 256, size=(3, 24, 32, 3)).astype(np.uint8)
    for rgb in (None, rgbs):
        a, b = str(tmp_path / "port.raw"), str(tmp_path / "jax.raw")
        dataset.write_raw(a, depths, rgb)
        jax_dataset.write_raw(b, depths, rgb)
        assert open(a, "rb").read() == open(b, "rb").read()
        r = dataset.RawDepthReader(b)
        assert (r.width, r.height, r.num_frames) == (32, 24, 3)
        assert r.get_k() == jax_dataset.RawDepthReader(a).get_k()
        for i in range(3):
            d, c, _ = r.read_next()
            np.testing.assert_array_equal(d, depths[i])
            np.testing.assert_array_equal(c, 0 if rgb is None else rgbs[i])
        assert r.read_next()[0] is None
        r.restart()
        np.testing.assert_array_equal(r.read_next()[0], depths[0])


def test_groundtruth_parsing(tmp_path):
    """TUM trajectories with comments, commas and short lines parse to the
    same poses as JAX's, with and without a pre-transform; the first-pose
    alignment too."""
    path = str(tmp_path / "gt.txt")
    with open(path, "w") as f:
        f.write("# comment\n\n")
        f.write("0.0 1.0 2.0 3.0 0 0 0 1\n")
        f.write("0.033,1.1,2.0,3.0,0,0,0.7071068,0.7071068\n")
        f.write("1 2 3\n")
        f.write("0.066 0.5 -2.0 3.5 0.1 0.2 0.3 0.9\n")
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (0.5, -0.25, 1.0)
    for transform in (None, t):
        got = dataset.load_groundtruth_poses(path, transform)
        want = jax_dataset.load_groundtruth_poses(path, transform)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    g = dataset.load_groundtruth_poses(path)
    np.testing.assert_array_equal(
        dataset.first_pose_transform(g[0], (2.4, 2.2, 0.86)),
        jax_dataset.first_pose_transform(g[0], (2.4, 2.2, 0.86)))
    rays = np.random.default_rng(1).uniform(0.5, 4.0, (6, 8))
    k = (5.0, -4.0, 3.5, 2.5)
    np.testing.assert_array_equal(dataset.ray_length_to_z_depth(rays, k),
                                  jax_dataset.ray_length_to_z_depth(rays, k))


def test_loop_sequence_bit_equal_to_jax():
    """The loop scene (with range noise) and each frame of it alone equal
    JAX's generator bit for bit."""
    k = (120.0, 120.0, 80.0, 60.0)
    kw = dict(width=160, height=120, noise_factor=0.002, seed=3)
    got = synthetic.loop_sequence(5, k, **kw)
    want = jax_synthetic.loop_sequence(5, k, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    d, p = synthetic.loop_frame(3, 5, k, **kw)
    np.testing.assert_array_equal(d, want[0][3])
    np.testing.assert_array_equal(p, want[1][3])
    assert synthetic.default_loop_scene(3.0) == \
        jax_synthetic.default_loop_scene(3.0)


def test_synthetic2raw_bytes_equal_jax(tmp_path):
    """The converter writes JAX's .raw and ground-truth file, byte for
    byte, for the loop (also rendered in two processes) and the orbit."""
    for scene, workers in (("loop", 1), ("loop", 2), ("orbit", 1)):
        a = str(tmp_path / f"port_{scene}_{workers}.raw")
        b = str(tmp_path / f"jax_{scene}.raw")
        assert io_convert.synthetic2raw(a, 2, scene=scene,
                                        workers=workers) == 2
        if not os.path.exists(b):
            jax_convert.synthetic2raw(b, 2, scene=scene)
        for suffix in ("", ".gt.txt"):
            assert open(a + suffix, "rb").read() == \
                open(b + suffix, "rb").read(), (scene, workers, suffix)
    with pytest.raises(NotImplementedError):
        io_convert.oni2raw()


@pytest.mark.parametrize("path", ["native", "python"])
def test_scene2raw_reads_the_scene_directory(path, tmp_path, monkeypatch):
    """An ICL-NUIM scene directory of ray lengths becomes JAX's .raw of
    the same path: JAX's native converter's (millimetres rounded) when
    the port's native library builds, else JAX's Python reader's
    (truncated)."""
    d = tmp_path / "scene"
    d.mkdir()
    rng = np.random.default_rng(2)
    for i in range(2):
        np.savetxt(d / f"scene_00_{i:04d}.depth",
                   rng.uniform(0.5, 3.0, 640 * 480).reshape(-1, 640))
    a, b = str(tmp_path / "port.raw"), str(tmp_path / "jax.raw")
    if path == "python":
        monkeypatch.setattr(native, "available", lambda: False)
        reader = jax_dataset.SceneDepthReader(str(d))
        depths = [(reader.read_frame(i) * 1000.0).astype(np.uint16)
                  for i in range(2)]
        jax_dataset.write_raw(b, np.stack(depths))
    else:
        assert native.available(), native.build_info
        assert jax_native.scene2raw(str(d), b) == 2
    assert io_convert.scene2raw(str(d), a) == 2
    assert open(a, "rb").read() == open(b, "rb").read()


def test_mm2meters_exact_over_all_u16():
    """JAX's mm2meters: one f32 division by 1000 of every u16 value, and
    strided sampling; numpy and JAX agree with the port bit for bit."""
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    want = v.astype(np.float32) / np.float32(1000)
    got = mm2meters(v, (256, 256), "cpu").numpy()
    jgot = np.asarray(jax_preprocess.mm2meters(jnp.asarray(v), (256, 256)))
    np.testing.assert_array_equal(jgot.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    sampled = mm2meters(torch.from_numpy(v.astype(np.int32)), (64, 64),
                        "cpu").numpy()
    np.testing.assert_array_equal(
        sampled, np.asarray(jax_preprocess.mm2meters(jnp.asarray(v),
                                                     (64, 64))))
    with pytest.raises(ValueError):
        mm2meters(v, (100, 64), "cpu")


def random_jax_map(field, n=40, seed=0):
    """A JAX MapState (64^3 over 2 m, capacity 1024) with ``n`` blocks at
    random cells, random payloads and random mip levels."""
    from supereight_tpu.core.map import MapGeometry as JaxGeometry
    from supereight_tpu.core.map import make_map
    from supereight_tpu.fields import get_field
    geom = JaxGeometry(size=64, dim=2.0, capacity=1024)
    rng = np.random.default_rng(seed)
    m = make_map(geom, get_field(field))
    b = geom.blocks_per_side
    cells = rng.choice(b ** 3, n, replace=False)
    coords = np.stack(np.unravel_index(cells, (b, b, b)), -1).astype(np.int32)
    slot = np.full((b, b, b), -1, np.int32)
    slot[tuple(coords.T)] = np.arange(n, dtype=np.int32)
    bc = np.zeros((geom.capacity, 3), np.int32)
    bc[:n] = coords
    dx, dy = np.array(m.data_x), np.array(m.data_y)
    dx[:n] = rng.uniform(-1, 1, (n, 512))
    dy[:n] = rng.integers(0, 5, (n, 512))
    active = np.zeros(geom.capacity, bool)
    active[:n] = rng.random(n) < 0.7
    m = m._replace(
        data_x=jnp.asarray(dx.astype(np.float32)),
        data_y=jnp.asarray(dy.astype(np.float32)),
        block_coord=jnp.asarray(bc), active=jnp.asarray(active),
        slot=jnp.asarray(slot), n_blocks=jnp.asarray(n, jnp.int32),
        mip_x=tuple(jnp.asarray(rng.uniform(-1, 1, a.shape)
                                .astype(np.float32)) for a in m.mip_x),
        mip_y=tuple(jnp.asarray(rng.uniform(0, 9, a.shape)
                                .astype(np.float32)) for a in m.mip_y),
        mip_alloc=tuple(jnp.asarray(rng.random(a.shape) < 0.3)
                        for a in m.mip_alloc))
    return geom, m, get_field(field)


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_map_snapshot_interop(tmp_path, field):
    """A snapshot written by one package loads in the other with equal
    arrays and geometry: a JAX map saved by JAX and loaded by the port,
    then saved by the port (the same keys, dtypes and values as JAX's
    file) and loaded by JAX; the port's touched buffer comes back
    zeroed."""
    jgeom, jmap, jfield = random_jax_map(field)
    a = str(tmp_path / "jax.npz")
    jax_serialise.save_map(a, jgeom, jmap, jfield)
    geom, state, tfield = serialise.load_map(a, "cpu")
    assert (geom.size, geom.dim, geom.capacity) == (64, 2.0, 1024)
    assert tfield.name == field
    assert int(state.touched.sum()) == 0
    assert state.touched.numel() == 8 ** 3 + 4 ** 3 + 2 ** 3
    for x, y in zip(jax.tree.leaves(jmap),
                    jax.tree.leaves(tuple(convert.to_numpy(state)))):
        np.testing.assert_array_equal(np.asarray(x), y)
    b = str(tmp_path / "port.npz")
    serialise.save_map(b, geom, state, tfield)
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for key in za.files:
        assert za[key].dtype == zb[key].dtype, key
        np.testing.assert_array_equal(za[key], zb[key], err_msg=key)
    assert int(zb["version"]) == jax_serialise.FORMAT_VERSION \
        == serialise.FORMAT_VERSION
    g2, s2, f2 = jax_serialise.load_map(b)
    assert g2 == jgeom and f2.name == field
    for x, y in zip(jax.tree.leaves(s2), jax.tree.leaves(jmap)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_morton_keys_match_jax():
    c = np.random.default_rng(3).integers(0, 1024, (500, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        serialise.morton_keys(c), np.asarray(jax_morton.encode_v(c)))
    assert serialise.morton_keys(c).dtype == np.uint32


def test_ate_and_rpe_equal_jax(tmp_path):
    """ATE (with and without Horn alignment, association, the file-level
    evaluation) and RPE of noisy trajectories equal JAX's."""
    rng = np.random.default_rng(4)
    n = 40
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)
    est = gt + rng.normal(0, 0.01, (n, 3)) + 0.2
    for align in (False, True):
        assert ate.ate_statistics(gt, est, align) == \
            jax_ate.ate_statistics(gt, est, align)
    s1 = np.arange(n) / 30.0
    s2 = s1 + rng.uniform(-0.01, 0.01, n)
    assert ate.associate(s1, s2) == jax_ate.associate(s1, s2)
    quat = rng.normal(0, 1, (n, 4))
    paths = []
    for name, xyz, st in (("gt", gt, s1), ("est", est, s2)):
        p = str(tmp_path / f"{name}.txt")
        with open(p, "w") as f:
            f.write("# t x y z qx qy qz qw\n")
            for t, x, q in zip(st, xyz, quat):
                f.write(" ".join(f"{v:.6f}" for v in (t, *x, *q)) + "\n")
        paths.append(p)
    for align in (False, True):
        assert ate.evaluate_ate(*paths, align=align) == \
            jax_ate.evaluate_ate(*paths, align=align)
    for a, b in zip(ate.load_tum_trajectory(paths[0]),
                    jax_ate.load_tum_trajectory(paths[0])):
        np.testing.assert_array_equal(a, b)
    gm = rpe.trajectory_matrices(gt, quat)
    em = rpe.trajectory_matrices(est, quat + rng.normal(0, 0.01, (n, 4)))
    jgm = jax_rpe.trajectory_matrices(gt, quat)
    for a, b in zip(gm, jgm):
        np.testing.assert_array_equal(a, b)
    for delta in (1, 5):
        assert rpe.rpe_statistics(gm, em, delta) == \
            jax_rpe.rpe_statistics(gm, em, delta)


def test_configuration_equals_jax():
    """Defaults, a full JAX command line and the empty one parse to equal
    configurations (``--platform`` picks the torch device instead)."""
    assert dataclasses.asdict(config.Configuration()) == \
        dataclasses.asdict(jax_config.Configuration())
    assert config.Configuration().resolve_capacity() == \
        jax_config.Configuration().resolve_capacity()
    assert config.default_camera(640, 480) == \
        jax_config.default_camera(640, 480)
    for argv in (JAX_ARGV, [], ["-F", "-f", "ofusion", "-k", "1,2,3,4"]):
        got = config.config_from_args(config.build_parser().parse_args(argv))
        want = jax_config.config_from_args(
            jax_config.build_parser().parse_args(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), argv
    got = config.config_from_args(config.build_parser().parse_args(JAX_ARGV))
    assert got.filter_input == "median2" and got.block_capacity == 49152
    jp = {a.dest: a.default for a in jax_config.build_parser()._actions}
    tp = {a.dest: a.default for a in config.build_parser()._actions}
    assert jp == tp
    assert [config.device_from_platform(p) for p in
            ("cpu", None, "cuda", "tpu")] == ["cpu", "cuda", "cuda", "cuda"]


def test_frame_log_parsing_equals_jax(tmp_path):
    """parse_frame_log and summarize (what tools/longseq.py reads)
    equal JAX's on a CLI log."""
    p = str(tmp_path / "log.txt")
    rng = np.random.default_rng(5)
    with open(p, "w") as f:
        f.write("frame\tpreprocessing\ttracking\tintegration\traycasting\t"
                "computation\ttotal\tX\tY\tZ\ttracked\tintegrated\n")
        for i in range(6):
            v = rng.uniform(0, 0.01, 6)
            f.write("\t".join([str(i)] + [f"{x:.6f}" for x in v]
                              + ["1.0", "2.0", "3.0", str(int(i > 3)), "1"])
                    + "\n")
        f.write("# a comment\n")
    rows = sweep.parse_frame_log(p)
    assert rows == jax_sweep.parse_frame_log(p)
    assert sweep.summarize(rows) == jax_sweep.summarize(rows)
    assert sweep.summarize(rows)["tracked_fraction"] == 2 / 6


def test_perfstats():
    s = PerfStats()
    for v in (3.0, 1.0, 2.0):
        s.sample("a", v, StatType.COUNT)
    assert (s.last("a"), s.mean("a"), s.min("a"), s.max("a"), s.sum("a")) \
        == (2.0, 2.0, 1.0, 3.0, 6.0)
    with s.timer("t", sync=torch.zeros(1)):
        time.sleep(0.001)
    assert s.has("t") and s.types["t"] is StatType.TIME and s.last("t") > 0
    s.reset("a")
    assert not s.has("a")
