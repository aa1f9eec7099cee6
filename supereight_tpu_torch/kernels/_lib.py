"""Build, load and call the port's CUDA library (``csrc/*.cu``).

The kernels are plain CUDA C++ with a C interface, compiled by ``nvcc``
for ``sm_90a`` (one ``nvcc`` process per source, all started together,
then one link) into one shared library and bound with ctypes — no
PyTorch headers, so a build takes seconds. The build runs at first use,
from the package's own sources only, into ``build/kernels/<hash>/`` at
the repository root (``.gitignore`` lists ``build/``); the hash covers
the sources and the flags, so an edited source rebuilds and an unchanged
one loads the cached library.

Launch counts live in :data:`LAUNCHES`, one plain integer per kernel,
incremented by each wrapper right after its launch succeeds. A CUDA graph
captures launches without running them: :func:`capturing` records the
launches of a capture as the graph's table and leaves the counts alone,
and :func:`replayed` adds that table once per replay. :func:`host_calls`
counts what the host itself issues: kernel launches and graph replays.
"""

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"icp_reduce": 0, "icp_reduce_step": 0, "icp_track": 0,
            "alloc_touch": 0, "alloc_touch_of": 0, "alloc_assign": 0, "integrate_worklist": 0,
            "integrate_fused": 0, "integrate_fused_of": 0,
            "integrate_fallback": 0, "integrate_fallback_of": 0,
            "nav_grid": 0, "raycast": 0, "raycast_of": 0, "gather_a": 0,
            "gather_b": 0, "gather_c": 0, "gather_d": 0, "node_rank": 0,
            "node_pass": 0, "pyramid": 0, "frame_mats": 0, "bilateral": 0,
            "median": 0, "median2": 0, "integrate_fused_noise": 0,
            "integrate_fused_bilinear": 0,
            "integrate_fused_noise_bilinear": 0,
            "integrate_fused_of_bilinear": 0,
            "integrate_fallback_noise": 0, "raycast_gated": 0,
            "raycast_cold": 0, "raycast_cold_of": 0,
            # the sharded step's modes (parallel/dist_step.py)
            "icp_update": 0, "alloc_touch_cols": 0, "alloc_touch_of_cols": 0,
            "alloc_assign_owned": 0, "halo_pack": 0, "raycast_cols": 0,
            "raycast_cols_of": 0,
            # the pose graph's windowed solve (posegraph/graph.optimize)
            "ba_solve": 0,
            # the visualization renders (ops/rendering.py)
            "render_depth": 0, "render_track": 0, "render_volume": 0,
            # a rendered frame's three renders in its composite (the CLI's)
            "render_views": 0}

MAX_MIP_LEVELS = 10  # mip levels csrc/nav.cu, node.cu and alloc.cu take
MAX_ICP_LEVELS = 4   # pyramid levels csrc/icp.cu and preprocess.cu take


class Mips(ctypes.Structure):
    """Per-level mip pointers, passed by value (``Mips`` of csrc/nav.cu,
    csrc/node.cu and csrc/alloc.cu)."""

    _fields_ = [("alloc", ctypes.c_void_p * MAX_MIP_LEVELS),
                ("x", ctypes.c_void_p * MAX_MIP_LEVELS),
                ("y", ctypes.c_void_p * MAX_MIP_LEVELS)]


class Pyramid(ctypes.Structure):
    """Per-level input pyramid and iteration counts, passed by value
    (csrc/icp.cu ``Pyramid``)."""

    _fields_ = [("vertex", ctypes.c_void_p * MAX_ICP_LEVELS),
                ("normal", ctypes.c_void_p * MAX_ICP_LEVELS),
                ("valid", ctypes.c_void_p * MAX_ICP_LEVELS),
                ("h", ctypes.c_int * MAX_ICP_LEVELS),
                ("w", ctypes.c_int * MAX_ICP_LEVELS),
                ("iterations", ctypes.c_int * MAX_ICP_LEVELS),
                ("n_levels", ctypes.c_int)]


class Step(ctypes.Structure):
    """The previous iteration's update that a launch of icp_reduce runs
    first, passed by value (csrc/icp.cu ``Step``); all zero: none."""

    _fields_ = [("red64", ctypes.c_void_p), ("red_in", ctypes.c_void_p),
                ("done_in", ctypes.c_void_p), ("pose_out", ctypes.c_void_p),
                ("red_out", ctypes.c_void_p), ("done_out", ctypes.c_void_p),
                ("icp_threshold", ctypes.c_float),
                ("next_first", ctypes.c_int)]


class Levels(ctypes.Structure):
    """Per-level pyramid outputs and sizes, passed by value
    (csrc/preprocess.cu ``Levels``)."""

    _fields_ = [("depth", ctypes.c_void_p * MAX_ICP_LEVELS),
                ("vertex", ctypes.c_void_p * MAX_ICP_LEVELS),
                ("normal", ctypes.c_void_p * MAX_ICP_LEVELS),
                ("valid", ctypes.c_void_p * MAX_ICP_LEVELS),
                ("h", ctypes.c_int * MAX_ICP_LEVELS),
                ("w", ctypes.c_int * MAX_ICP_LEVELS),
                ("n_levels", ctypes.c_int)]


class Spatial(ctypes.Structure):
    """The bilateral filter's 5 x 5 spatial factors, passed by value
    (csrc/preprocess.cu ``Spatial``)."""

    _fields_ = [("gg", (ctypes.c_float * 5) * 5)]

    def __init__(self, gg):
        super().__init__(((ctypes.c_float * 5) * 5)(
            *((ctypes.c_float * 5)(*row) for row in gg)))


P, I, F, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# C signature of each exported entry point (stream last, every one
# returns the cudaError_t of its launch)
_SIGNATURES = {
    "se_icp_reduce": (P, P, P, I, I, I, I, P, P, P, I, I, P, P, F, F, P, P,
                      Step, P),
    "se_icp_update": (P, P, P, P, P, P, P, F, P, F, I, I, P, P, P),
    "se_icp_track": (Pyramid, P, P, P, I, I, P, P, F, F, F, F, P, P, P, P, P,
                     P, P, P),
    "se_icp_track_clusters": (I, P),
    "se_alloc_touch": (P, I, I, I, I, I, P, P, F, D, I, F, I, I, P, P),
    "se_alloc_touch_of": (P, I, I, I, I, P, P, F, P, P, I, I, F, I, I, P, P,
                          P, P),
    "se_alloc_assign": (P, P, P, P, I, I, I, I, I, I, P, P, P, P, P, Mips,
                        P),
    "se_integrate_worklist": (P, P, P, I, P, P, F, I, I, I, P, P, P, P),
    "se_halo_pack": (P, P, I, P, P, P, P, F, F, F, F, F, I, I, I, P, P, P),
    "se_integrate_fused": (P, I, I, P, P, P, F, I, I, I, P, I, I, I, F, F, F,
                           P, P, P, P, P, P, P, P, P),
    "se_integrate_fallback": (P, I, P, P, P, F, I, I, P, I, I, F, F, F, P, I,
                              P, P, P, P, P, P, P, P),
    "se_nav_grid": (P, I, I, I, I, Mips, P, P, P, P),
    "se_raycast": (P, P, P, P, P, F, P, P, I, I, I, I, I, I, I, I, F, F, F,
                   F, F, F, F, F, F, F, F, F, F, F, P, P, P, P, P, P, P, P,
                   P, P, P, P, P),
    "se_gather_a": (P, P, I, I, I, P, P),
    "se_gather_b": (P, P, I, I, I, P, P),
    "se_gather_c": (P, P, I, I, I, P, P),
    "se_gather_d": (P, P, I, I, I, P, P),
    "se_node_rank": (P, I, I, P, P, P, P),
    "se_node_pass": (Mips, I, I, D, P, P, P, P, I, I, P, I, F, F, F, P, P),
    "se_frame_mats": (P, P, P, P, P, I, I, I, P, P, P),
    "se_pyramid": (P, P, F, I, Levels, P),
    "se_median": (P, I, I, I, P, P),
    "se_bilateral": (P, I, I, Spatial, F, P, P),
    "se_ba_solve": (P, P, P, P, P, P, P, P, I, I, I, F, P, ctypes.c_longlong,
                    P),
    "se_ba_plan": (I, I, P),
    "se_ba_tier_nodes": (P,),
    "se_render_depth": (P, I, F, F, F, P, P),
    "se_render_track": (P, I, P, P),
    "se_render_volume": (P, P, P, P, P, I, P, P),
    "se_render_views": (P, P, P, P, P, P, P, I, I, F, F, F, P, P),
}

# the host's calls: kernel launches (launch) and graph replays (replayed)
HOST_CALLS = {"launch": 0, "replay": 0}

_lock = threading.Lock()
_lib = None
build_info = {}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def capturing():
    """Launches made inside are a graph capture's, which runs nothing:
    yields the dict that receives them (kernel -> launches, the graph's
    launch table) and leaves :data:`LAUNCHES` as it found it."""
    before = dict(LAUNCHES)
    table = {}
    try:
        yield table
    finally:
        table.update((name, n - before[name]) for name, n in LAUNCHES.items()
                     if n != before[name])
        LAUNCHES.update(before)


def replayed(table):
    """Count one replay of a graph whose capture launched ``table``
    (:func:`capturing`)."""
    for name, n in table.items():
        LAUNCHES[name] += n
    HOST_CALLS["replay"] += 1


@contextlib.contextmanager
def host_calls():
    """Yields a dict that receives, when the block ends, the host's calls
    made inside it: ``launch``, the kernel launches it issued itself, and
    ``replay``, the graph replays (whose launches :data:`LAUNCHES` counts,
    but the host issues one call each)."""
    before = dict(HOST_CALLS)
    seen = {}
    try:
        yield seen
    finally:
        seen.update((k, n - before[k]) for k, n in HOST_CALLS.items())


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> pathlib.Path:
    """Compile csrc/*.cu into build/kernels/<hash>/libse_kernels.so (if
    not cached) and return its path: one ``nvcc -c`` per source, run in
    parallel, then one link. ptxas's register/spill report goes to
    ``build.log`` beside the library."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libse_kernels.so"
    if lib.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = os.getpid()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], False
    for proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        failed |= proc.returncode != 0
    tmp = out_dir / f"libse_kernels.{tag}.so"
    if not failed:
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(proc.stdout + proc.stderr)
        failed = proc.returncode != 0
    log = "".join(logs)
    (out_dir / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + log)
    os.replace(tmp, lib)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      log=str(out_dir / "build.log"))
    return lib


def library():
    """The loaded ctypes library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(kernel: str, entry: str, device, *args):
    """Call ``entry`` with ``args`` (tensors are passed as their data
    pointers, checked by :func:`check` first) on ``device``'s current
    stream; raise on a launch error, else count one launch of ``kernel``.
    """
    fn = getattr(library(), entry)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err}")
    LAUNCHES[kernel] += 1
    HOST_CALLS["launch"] += 1


def check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Validate a kernel argument before its pointer is passed."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t
