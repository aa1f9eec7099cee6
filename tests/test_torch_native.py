"""The port's native library (``io/native.py``) against the JAX package's.

The port builds ``native/src/*.cpp`` itself, at first use, into
``build/native/<hash>/`` and never loads the Makefile's
``native/libsupereight_native.so``. Its reader equals the Python
``RawDepthReader`` and JAX's ``NativeRawReader`` frame for frame, its
writers and ``scene2raw`` write JAX's native bytes, the build is reused,
and a failed build leaves ``available()`` False with the compiler's
complaint in ``build_info`` while the callers take their Python paths.
"""

import os

import numpy as np
import pytest

from supereight_tpu.io import meshing as jax_meshing
from supereight_tpu.io import native as jax_native
from supereight_tpu_torch.io import convert, dataset, meshing, native


def make_raw(tmp_path, n=4, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    depths = rng.integers(0, 5000, size=(n, h, w)).astype(np.uint16)
    rgbs = rng.integers(0, 255, size=(n, h, w, 3)).astype(np.uint8)
    path = str(tmp_path / "seq.raw")
    dataset.write_raw(path, depths, rgbs)
    return path, depths, rgbs


def random_triangles(n=200, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3, 3)) * 10.0 ** rng.integers(
        -4, 4, size=(n, 3, 1))).astype(np.float32)


def test_reader_equals_python_and_jax(tmp_path):
    path, depths, rgbs = make_raw(tmp_path)
    ours = native.NativeRawReader(path)
    theirs = jax_native.NativeRawReader(path)
    python = dataset.RawDepthReader(path)
    assert (ours.width, ours.height, ours.num_frames) == (32, 24, 4) \
        == (theirs.width, theirs.height, theirs.num_frames) \
        == (python.width, python.height, python.num_frames)
    for i in range(4):
        d, rgb, _ = ours.read_next()
        jd, jrgb, _ = theirs.read_next()
        pd, prgb = python.read_frame(i)
        for a in (d, jd, pd, depths[i]):
            assert a.dtype == np.uint16
            np.testing.assert_array_equal(d, a)
        for a in (rgb, jrgb, prgb, rgbs[i]):
            np.testing.assert_array_equal(rgb, a)
    assert ours.read_next()[0] is None
    assert ours.read_frame(-1) == (None, None)
    ours.close()
    theirs.close()
    with pytest.raises(IOError):
        native.NativeRawReader(str(tmp_path / "missing.raw"))


@pytest.mark.parametrize("writer", ["vtk", "obj"])
@pytest.mark.parametrize("n", [0, 1, 200])
def test_writers_byte_equal_jax_native(writer, n, tmp_path):
    """``%g`` of each float, as JAX's native writers print it; a float64
    input is written as its float32, as theirs."""
    tris = random_triangles(max(n, 1))[:n]
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert getattr(native, f"write_{writer}_native")(a, tris)
    assert getattr(jax_native, f"write_{writer}_native")(b, tris)
    assert open(a, "rb").read() == open(b, "rb").read()
    c = str(tmp_path / "f64")
    assert getattr(native, f"write_{writer}_native")(c, tris.astype(float))
    assert open(a, "rb").read() == open(c, "rb").read()
    assert not getattr(native, f"write_{writer}_native")(
        str(tmp_path / "no" / "dir"), tris)


def write_scene(d, n, seed):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        np.savetxt(d / f"scene_00_{i:04d}.depth",
                   rng.uniform(0.5, 3.0, 640 * 480).reshape(-1, 640))


def test_scene2raw_byte_equal_jax_native(tmp_path):
    """Ray lengths to rounded millimetres, JAX's native bytes; the
    converter (``convert.scene2raw``) takes this path when it builds."""
    write_scene(tmp_path / "scene", 2, seed=3)
    scene = str(tmp_path / "scene")
    a, b, c = (str(tmp_path / f"{n}.raw") for n in ("port", "jax", "conv"))
    assert native.scene2raw(scene, a) == 2
    assert jax_native.scene2raw(scene, b) == 2
    assert convert.scene2raw(scene, c) == 2
    assert open(a, "rb").read() == open(b, "rb").read() \
        == open(c, "rb").read()
    assert native.scene2raw(str(tmp_path / "none"), a) == 0


def test_build_is_hashed_and_reused():
    assert native.available()
    lib = native.BUILD_ROOT / native.source_hash() / native.LIB_NAME
    assert native.build_info["path"] == str(lib) and lib.exists()
    assert lib.parent.parent == native.ROOT / "build" / "native"
    assert {p.name for p in native.SOURCES} == {
        "raw_reader.cpp", "mesh_writer.cpp", "scene2raw.cpp"}
    mtime = lib.stat().st_mtime_ns
    assert native.build() == lib
    assert native.build_info["cached"] and lib.stat().st_mtime_ns == mtime
    # the Makefile's own output is never what the port loads
    assert os.path.realpath(str(lib)) != os.path.realpath(
        str(native.ROOT / "native" / "libsupereight_native.so"))


def test_hash_covers_compiler_and_flags(monkeypatch):
    h = native.source_hash()
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ("-g",))
    assert native.source_hash() != h
    monkeypatch.undo()
    monkeypatch.setattr(native, "CXX", "clang++")
    assert native.source_hash() != h


def test_failed_build_is_explained_and_callers_fall_back(monkeypatch,
                                                         tmp_path):
    """A compiler that does not exist: ``available()`` is False,
    ``build_info`` says why, the reader and the converter raise, and the
    mesh writers write JAX's Python bytes."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_info", {})
    assert not native.available()
    assert "no-such-g++" in native.build_info["error"]
    assert "path" not in native.build_info
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.NativeRawReader(str(tmp_path / "x.raw"))
    with pytest.raises(RuntimeError, match="not available"):
        native.scene2raw(str(tmp_path), str(tmp_path / "x.raw"))
    assert not native.write_obj_native(str(tmp_path / "x.obj"),
                                       random_triangles(2))
    monkeypatch.setattr(jax_native, "available", lambda: False)
    tris = random_triangles(20)
    before = dict(meshing.WRITES)
    for w in ("write_obj", "write_vtk"):
        a, b = str(tmp_path / f"port.{w}"), str(tmp_path / f"jax.{w}")
        getattr(meshing, w)(a, tris)
        getattr(jax_meshing, w)(b, tris)
        assert open(a, "rb").read() == open(b, "rb").read()
    assert meshing.WRITES["python"] == before["python"] + 2
    assert meshing.WRITES["native"] == before["native"]


def test_compile_error_is_explained(monkeypatch, tmp_path):
    """A source that does not compile: the compiler's message is kept."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCES", native.SOURCES + (bad,))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_info", {})
    assert not native.available()
    assert "bad.cpp" in native.build_info["error"]
    assert not list((tmp_path / "build").glob("*/*.so"))
