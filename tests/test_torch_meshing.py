"""Parity of the port's marching-cubes export (``io/meshing.py``,
``io/mc_tables.py``, ``DenseSLAMSystem.dump_mesh``) with the JAX
package's.

Maps come from JAX (an analytic sphere over every block, a sparse
random map with unobserved voxels, a shell across block and map edges)
and are carried into torch with ``convert.map_to_torch``: the triangles
must be bit-equal and the writers' files byte-equal to JAX's on the same
path: both packages' native writers (``%g``), then both packages' Python
writers (each float's repr) with the native libraries switched off.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import map as jax_map
from supereight_tpu.fields import get_field as jax_field
from supereight_tpu.io import mc_tables as jax_tables
from supereight_tpu.io import meshing as jax_meshing
from supereight_tpu.io import native as jax_native
from supereight_tpu_torch import convert
from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.io import mc_tables, meshing, native
from supereight_tpu_torch.pipeline import DenseSLAMSystem


@pytest.fixture(params=["native", "python"])
def writer_path(request, monkeypatch):
    """Both packages write through their native library, or both through
    Python; yields the path and checks the port's files took it."""
    if request.param == "python":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert jax_native.available() and native.available(), \
            native.build_info
    before = meshing.WRITES[request.param]
    yield request.param
    assert meshing.WRITES[request.param] > before


def jax_sphere(size=32, dim=2.0, radius=0.5, field="tsdf", shell=None):
    """JAX's sphere map (tests/test_meshing.py): every block, or with
    ``shell`` only the blocks within that many voxels of the surface."""
    geom = jax_map.MapGeometry(size=size, dim=dim, capacity=(size // 8) ** 3)
    state = jax_map.make_map(geom, jax_field(field))
    b = geom.blocks_per_side
    c = (size / 2.0) * geom.voxel_size
    bc = (np.stack(np.meshgrid(*(np.arange(b),) * 3, indexing="ij"), -1)
          + 0.5) * 8 * geom.voxel_size
    near = np.abs(np.linalg.norm(bc - c, axis=-1) - radius) \
        < (np.inf if shell is None else shell * geom.voxel_size)
    state = jax_map.allocate_blocks(geom, state, jnp.asarray(near))
    g = np.arange(size)
    coords = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1) \
        .reshape(-1, 3).astype(np.int32)
    sdf = np.linalg.norm(coords * geom.voxel_size - c, axis=-1) - radius
    state = jax_map.set_voxels(state, jnp.asarray(coords),
                               jnp.asarray(np.clip(sdf / 0.1, -1, 1),
                                           dtype=np.float32),
                               jnp.ones(len(coords)))
    return geom, state, c, radius


def jax_random(seed):
    """A sparse map with random values around 0 and a quarter of its
    voxels unobserved."""
    rng = np.random.default_rng(seed)
    geom = jax_map.MapGeometry(size=32, dim=2.0, capacity=64)
    state = jax_map.make_map(geom, jax_field("tsdf"))
    state = jax_map.allocate_blocks(geom, state,
                                    jnp.asarray(rng.random((4, 4, 4)) < 0.4))
    shape = np.shape(state.data_x)
    return geom, state._replace(
        data_x=jnp.asarray(rng.normal(size=shape), jnp.float32),
        data_y=jnp.asarray(rng.random(shape) > 0.25, jnp.float32))


def port(geom, state):
    from supereight_tpu_torch.core.map import MapGeometry
    return (MapGeometry(geom.size, geom.dim, geom.capacity),
            convert.map_to_torch(state, "cpu"))


def test_tables_are_jax_tables():
    for name in ("EDGE_TABLE", "TRI_TABLE", "CORNER_OFFSETS", "CORNER_A",
                 "CORNER_B"):
        np.testing.assert_array_equal(getattr(mc_tables, name),
                                      getattr(jax_tables, name))


@pytest.mark.parametrize("case", ["sphere", "shell", "random", "empty",
                                  "unobserved"])
def test_marching_cubes_bit_equal(case, monkeypatch):
    if case == "random":
        geom, state = jax_random(0)
    else:
        geom, state, _, _ = jax_sphere(shell=3 if case == "shell" else None)
    if case == "empty":
        state = jax_map.make_map(geom, jax_field("tsdf"))
    if case == "unobserved":
        state = state._replace(data_y=jnp.zeros_like(state.data_y))
    # several chunks of the block-sparse pass
    monkeypatch.setattr(jax_meshing, "_MESH_CHUNK", 5)
    monkeypatch.setattr(meshing, "_MESH_CHUNK", 5)
    want = jax_meshing.marching_cubes(geom, state)
    got = meshing.marching_cubes(*port(geom, state))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (len(got) > 100) == (case in ("sphere", "shell", "random"))


@pytest.mark.parametrize("writer", ["write_vtk", "write_obj"])
def test_writers_byte_equal(writer, writer_path, tmp_path):
    geom, state, _, _ = jax_sphere(size=16, radius=0.4)
    tris = meshing.marching_cubes(*port(geom, state))
    assert len(tris) > 0
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    getattr(jax_meshing, writer)(a, tris)
    getattr(meshing, writer)(b, tris)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_dump_mesh(writer_path, tmp_path):
    """The class's export: a few frames of the test orbit, then dump_mesh
    writes the same triangles as JAX's marching_cubes on the same map, to
    .obj and (any other name) .vtk, the files JAX's writers of the same
    path write."""
    from test_torch_step import K, H, W, make_scene
    torch.set_num_threads(1)
    depths, poses = make_scene(4)
    cfg = Configuration(volume_resolution=64, volume_size=2.0, mu=0.1,
                        camera=K, compute_size_ratio=1, pyramid=(3, 2),
                        block_capacity=1024)
    sys_ = DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device="cpu")
    for i, d in enumerate(depths):
        sys_.process_frame(d, i, is_mm=False, gt_pose=poses[i])
    jm = convert.to_numpy(sys_.map)
    geom = jax_map.MapGeometry(64, 2.0, 1024)
    want = jax_meshing.marching_cubes(geom, jax_map.MapState(**{
        f: getattr(jm, f) for f in jax_map.MapState._fields}))
    for name in ("mesh.obj", "mesh.vtk", "mesh"):
        path = str(tmp_path / name)
        got = sys_.dump_mesh(path)
        np.testing.assert_array_equal(got, want)
        assert len(got) > 100 and os.path.getsize(path) > 0
        head = open(path).readline()
        assert head.startswith("# OBJ" if name.endswith(".obj")
                               else "# vtk DataFile")
        jax_path = str(tmp_path / ("jax-" + name))
        (jax_meshing.write_obj if name.endswith(".obj")
         else jax_meshing.write_vtk)(jax_path, want)
        assert open(path, "rb").read() == open(jax_path, "rb").read()
