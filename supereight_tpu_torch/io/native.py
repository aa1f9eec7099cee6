"""ctypes bindings for the native runtime library, built from the
repository's ``native/src``.

Port of ``supereight_tpu/io/native.py``: the same C ABI and the same
Python surface (``NativeRawReader`` with its prefetch, the mesh writers,
``scene2raw`` and :func:`available`). The C++ pieces mirror the roles the
reference implements natively: dataset reading with prefetch
(interface.h), dataset conversion (se_tools/scene2raw.cpp) and fast mesh
export (commons.h writers).

The library is built at first use from ``native/src/*.cpp`` with the
flags of ``native/Makefile`` into ``build/native/<hash>/`` at the
repository root (``.gitignore`` lists ``build/``); the hash covers the
sources, the compiler and the flags, so an edited source rebuilds and an
unchanged one loads the cached library. The build writes a temporary
name and renames it, so processes building at once cannot tear the file.
``native/libsupereight_native.so`` (the Makefile's output) is never
loaded. When the library cannot be built, :func:`available` is False,
callers take their Python paths, and :data:`build_info` holds why.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCES = tuple(ROOT / "native" / "src" / name for name in
                ("raw_reader.cpp", "mesh_writer.cpp", "scene2raw.cpp"))
BUILD_ROOT = ROOT / "build" / "native"
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")  # Makefile:3
LDFLAGS = ("-shared", "-pthread")                              # Makefile:4
LIB_NAME = "libsupereight_native.so"

_lock = threading.Lock()
_lib = None
_tried = False
# seconds, cached, path of the library; or error: the compiler's output
build_info = {}


def source_hash() -> str:
    h = hashlib.sha256(" ".join((CXX,) + CXXFLAGS + LDFLAGS).encode())
    for p in SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources into build/native/<hash>/ (if not cached) and
    return the library's path; raise with the compiler's output if the
    build fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(seconds=0.0, cached=True, path=str(lib))
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [CXX, *CXXFLAGS, *map(str, SOURCES), "-o", str(tmp), *LDFLAGS],
            capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{CXX} did not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed ({proc.returncode}):\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      path=str(lib))
    return lib


def _bind(lib):
    lib.se_raw_open.restype = ctypes.c_void_p
    lib.se_raw_open.argtypes = [ctypes.c_char_p]
    lib.se_raw_close.argtypes = [ctypes.c_void_p]
    for f in ("se_raw_width", "se_raw_height", "se_raw_num_frames"):
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.se_raw_read_depth.restype = ctypes.c_int
    lib.se_raw_read_depth.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.se_raw_read_rgb.restype = ctypes.c_int
    lib.se_raw_read_rgb.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.se_raw_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.se_write_vtk.restype = ctypes.c_int
    lib.se_write_vtk.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64]
    lib.se_write_obj.restype = ctypes.c_int
    lib.se_write_obj.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64]
    lib.se_scene2raw.restype = ctypes.c_int
    lib.se_scene2raw.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    return lib


def _load():
    """The bound library, built on first call; None (and the reason in
    :data:`build_info`) when it cannot be built or loaded. A process
    tries once."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as e:
                build_info["error"] = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


class NativeRawReader:
    """Drop-in fast path for dataset.RawDepthReader with async prefetch."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not available: "
                               + build_info.get("error", ""))
        self._lib = lib
        self._h = lib.se_raw_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open raw file {path}")
        self.width = lib.se_raw_width(self._h)
        self.height = lib.se_raw_height(self._h)
        self.num_frames = lib.se_raw_num_frames(self._h)
        self.frame = -1

    def read_frame(self, index: int):
        if index < 0 or index >= self.num_frames:
            return None, None
        depth = np.empty((self.height, self.width), np.uint16)
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        if self._lib.se_raw_read_depth(self._h, index,
                                       depth.ctypes.data) != 0:
            return None, None
        self._lib.se_raw_read_rgb(self._h, index, rgb.ctypes.data)
        # overlap the next frame's disk read with this frame's compute
        self._lib.se_raw_prefetch(self._h, index + 1)
        return depth, rgb

    def read_next(self):
        self.frame += 1
        d, rgb = self.read_frame(self.frame)
        return d, rgb, None

    def close(self):
        if self._h:
            self._lib.se_raw_close(self._h)
            self._h = None

    def __del__(self):
        # the interpreter may be tearing down: nothing to report to
        try:
            self.close()
        except Exception:
            pass


def write_vtk_native(path, triangles) -> bool:
    lib = _load()
    if lib is None:
        return False
    tris = np.ascontiguousarray(triangles, np.float32)
    return lib.se_write_vtk(path.encode(), tris.ctypes.data,
                            len(tris)) == 0


def write_obj_native(path, triangles) -> bool:
    lib = _load()
    if lib is None:
        return False
    tris = np.ascontiguousarray(triangles, np.float32)
    return lib.se_write_obj(path.encode(), tris.ctypes.data,
                            len(tris)) == 0


def scene2raw(scene_dir: str, out_path: str) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available: "
                           + build_info.get("error", ""))
    return lib.se_scene2raw(scene_dir.encode(), out_path.encode())
