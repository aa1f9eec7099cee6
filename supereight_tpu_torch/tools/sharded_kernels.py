"""The sharded step's windowed marches, halo_pack and owned allocation,
and the single device's march and allocation, timed on the card.

    python3 -m supereight_tpu_torch.tools.sharded_kernels
        [--field tsdf|ofusion] [--frame N ...] [--workdir DIR]
        [--kernels marches|halo_pack|alloc_assign ...]

For each field: four Gloo ranks of the sharded step (``tools/dist_run.py``)
on card 0 over the bench orbit (``tools/bench.scene()``, the scene of
``chip_smoke.py``'s dist phase) with the exact halo and a halo budget of
HALO_BUDGET blocks a rank, one case a ``--frame`` (default 4, the frame
the dist phase captures, and 42, the last) that runs up to that frame and
writes rank 1's kernel arguments there. Then the single-device bench
(``tools/bench.config``) through ``frame_step``, with the march's and
``alloc_assign``'s arguments copied at the same frames. Each of
``--kernels`` (default all):

* ``marches``: the field's march over rank 1's columns
  (``alloc_touch_cols`` / ``alloc_touch_of_cols``) and over the single
  device's whole frame (``alloc_touch`` / ``alloc_touch_of``), into a
  scratch touched buffer: the whole launch and the side builds of
  :data:`TOUCH_SIDE` (without the samples' stores, in CTAs of 256
  threads whatever the rays, and with the matrices read straight into
  registers);
* ``halo_pack`` on rank 1's inputs, with the frustum test (the step's
  default) and without: the rows sent, device microseconds of the whole
  launch and of a side build that stops after the compaction (flagging
  and compaction timed apart from the copy);
* ``alloc_assign``: rank 1's ``alloc_assign_owned`` and the single
  device's ``alloc_assign`` (for OFusion also a side build without the
  coarse grids' clusters), and the two other kernels on
  ``csrc/compact.cuh``'s compaction, K3's ``integrate_worklist`` and
  K4's ``node_rank``. Every allocation call is handed its own copy of
  the map fields it writes and of the touched grids it consumes, made
  before the timing, so each launch does the frame's work.

A side build is one source of the checkout in use with a few lines
edited (:data:`SIDE`), compiled with the library's flags into its
own library under ``build/side/`` (:func:`build_sources`, which also
builds a whole source of another checkout) and swapped in for the
duration of its timing; a build whose edit does not fit the source is
reported as absent. Side builds live here only, and no flag of the
program selects one. A device time is the median of the named kernel's
launches over REPS calls, each launch's own duration read from a
``torch.profiler`` chrome trace (:func:`kernel_us`), printed with the
fastest and slowest launch; a trace that does not show all REPS launches
is taken again, and the script fails after TRIES such traces. One line a
measurement on stdout, then one JSON line of them all with the card's
name and power limit.

The script imports its kernels from whichever ``supereight_tpu_torch``
comes first on the path, so it can time another checkout's kernels on
the same card: ``PYTHONPATH=<checkout> python3
supereight_tpu_torch/tools/sharded_kernels.py``. It runs on the card only:
without a CUDA device it exits 2.
"""

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

WORLD, RANK = 4, 1
# what the script times (--kernels): the marches (alloc_touch_cols[_of]
# on rank 1's window, alloc_touch[_of] on the single device's frame),
# halo_pack, and the allocations with the single device's other
# compaction kernels
PARTS = ("marches", "halo_pack", "alloc_assign")
# a field's march: (the wrapper in kernels/alloc.py, the launch name)
MARCHES = {"tsdf": ("touched_mask", "alloc_touch"),
           "ofusion": ("touched_masks_of", "alloc_touch_of")}
FRAMES = (4, 42)
REPS = 20
TRIES = 5           # traces taken before a shortfall of launches fails
HALO_BUDGET = 4096  # chip_smoke.DIST_HALO_BUDGET

# side builds: name -> (source file, [(old, new), ...]), applied where the
# source holds every `old` exactly once, else reported as not applicable
SIDE = {
    # halo_pack stopped after its compaction: flagging and compaction
    # timed apart from the copy
    "halo_compaction_only": ("integrate.cu", [(
        "  se::cluster_compact<true>(n, flag, emit, [&](int total) {\n",
        "  se::cluster_compact<true>(n, flag, emit, [&](int total) {\n"
        "    if (total >= 0) return;\n")]),
    # the allocator without OFusion's coarse grids' clusters
    "alloc_no_extra": ("alloc.cu", [(
        "  const int n_coarse = min(kMaxCoarseClusters,\n"
        "                           (coarse + per_cluster - 1) / "
        "per_cluster);\n",
        "  const int n_coarse = 0;\n")]),
    # the marches without their samples' stores: each sample's cell is
    # computed and kept alive, and nothing is written
    "touch_no_stores": ("alloc.cu", [(
        "  grid[cell] = 1;\n", "  asm volatile(\"\" :: \"r\"(cell));\n")]),
    # the marches in CTAs of 256 threads whatever their rays
    "touch_threads_256": ("alloc.cu", [(
        "  while (t > kMinThreads && ", "  while (false && ")]),
    # the marches reading the matrices straight into registers, 15
    # broadcast loads a thread, with no barrier
    "touch_mats_ldg": ("alloc.cu", [
        ("  __shared__ float sh[15];\n  const int t = threadIdx.x;\n"
         "  if (t < 15) sh[t] = __ldg(t < 12 ? kpose + t : pose + 3 + 4 * "
         "(t - 12));\n"
         "  __syncthreads();\n  Mats m;\n#pragma unroll\n"
         "  for (int i = 0; i < 12; ++i) m.K[i] = sh[i];\n"
         "  m.cx = sh[12];\n  m.cy = sh[13];\n  m.cz = sh[14];\n",
         "  Mats m;\n#pragma unroll\n"
         "  for (int i = 0; i < 12; ++i) m.K[i] = __ldg(kpose + i);\n"
         "  m.cx = __ldg(pose + 3);\n  m.cy = __ldg(pose + 7);\n"
         "  m.cz = __ldg(pose + 11);\n")]),
    # the bilateral filter in tiles of 14 output rows (CTAs of 512
    # threads); with every tap weighed by its own pixel (no pair shared);
    # dividing equal depths' zero too; with the range weight replaced by 1
    # (no division, no expf); with the division's fast approximation (not
    # the twin's: its output differs)
    "bilateral_tile14": ("preprocess.cu", [(
        "constexpr int kBilH = 22;", "constexpr int kBilH = 14;")]),
    "bilateral_no_sharing": ("preprocess.cu", [(
        "        factor = wt[half_index(-i, -j)][py + i][px + j];\n",
        "        factor = pair_weight(S.gg[i + 2][j + 2], d, cur, "
        "e_d_sq_2);\n")]),
    "bilateral_zero_div": ("preprocess.cu", [(
        "  const float q = -(mod == 0.f ? 1.f : mod) / e_d_sq_2;\n"
        "  return mod == 0.f ? gg : gg * expf(q);\n",
        "  return gg * expf(-mod / e_d_sq_2);\n")]),
    "bilateral_unit_weight": ("preprocess.cu", [(
        "  return mod == 0.f ? gg : gg * expf(q);\n",
        "  return gg + 0.f * q;\n")]),
    "bilateral_fast_div": ("preprocess.cu", [(
        "  const float q = -(mod == 0.f ? 1.f : mod) / e_d_sq_2;\n",
        "  const float q = __fdividef(-(mod == 0.f ? 1.f : mod), "
        "e_d_sq_2);\n")]),
    # K8's gather_b (tools/probe_gather.py --time --split): its index's
    # round trip alone, its clamp and column stored with no table read
    "gather_b_index_only": ("gather_probe.cu", [(
        "      out[row + c] = __ldg(\n          table + (size_t)clamp_index("
        "__ldg(idx + row + c), rows) * cols + c);\n",
        "      out[row + c] = __int_as_float(\n          clamp_index(__ldg("
        "idx + row + c), rows) * cols + c);\n")]),
    # K8's gather_c: its loads and barrier alone, each output the clamped
    # index in place of the stage's element (a broadcast read of the
    # stage's first word keeps the stage live); and the direct body (no
    # stage) at every width
    "gather_c_stage_only": ("gather_probe.cu", [(
        "  return s[clamp_index(k, n)];\n",
        "  return __int_as_float(clamp_index(k, n)) + 0.f * s[0];\n")]),
    "gather_c_direct": ("gather_probe.cu", [(
        "  if (table_cols > kStageFloats)\n", "  if (true)\n")]),
}

# the part of PARTS each side build's name starts with (the bilateral
# filter's are tools/noise_kernels.py's, the gather's
# tools/probe_gather.py's), and the marches' by field
SIDE_PREFIX = {"halo": "halo_pack", "alloc": "alloc_assign",
               "touch": "marches", "bilateral": "bilateral",
               "gather": "gather"}
TOUCH_SIDE = {f: ("touch_no_stores", "touch_threads_256", "touch_mats_ldg")
              for f in ("tsdf", "ofusion")}


def side_source(name, csrc):
    """(file name, edited text) of side build ``name`` of :data:`SIDE` on
    the sources in ``csrc``, or None where its edits do not fit them."""
    fname, edits = SIDE[name]
    text = (csrc / fname).read_text()
    if not all(text.count(old) == 1 for old, _ in edits):
        return None
    for old, new in edits:
        text = text.replace(old, new)
    return fname, text


def build_side(names):
    """Compile each side build of ``names`` (its one edited source and the
    library's headers) with the library's flags, all at once; returns name
    -> its ctypes library, or None where it does not fit the sources."""
    from supereight_tpu_torch.kernels import _lib
    return build_sources({name: side_source(name, _lib.CSRC)
                          for name in names})


def build_sources(sources, headers=None):
    """Compile each of ``sources`` (name -> (file name, text), or None)
    with the headers of ``headers`` (a ``csrc`` directory; default the
    library's) and the library's flags into its own library under
    ``build/side/``, all at once; returns name -> its ctypes library, or
    None where the source is None."""
    from supereight_tpu_torch.kernels import _lib
    root = _lib.BUILD_ROOT.parent / "side"
    nvcc = _lib.nvcc_path()
    cuh = sorted(pathlib.Path(headers or _lib.CSRC).glob("*.cuh"))
    jobs, libs = {}, {}
    for name, src in sources.items():
        if src is None:
            libs[name] = None
            continue
        fname, text = src
        h = hashlib.sha256(text.encode())
        for p in cuh:
            h.update(p.read_bytes())
        out = root / h.hexdigest()[:16]
        out.mkdir(parents=True, exist_ok=True)
        for p in cuh:
            (out / p.name).write_bytes(p.read_bytes())
        (out / fname).write_text(text)
        so = out / "libside.so"
        proc = None if so.exists() else subprocess.Popen(
            [nvcc, *_lib.NVCC_FLAGS, "-shared", "-o", str(so),
             str(out / fname)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, so)
    for name, (proc, so) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"side build {name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry, args in _lib._SIGNATURES.items():
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


@contextlib.contextmanager
def using(lib):
    """Within: the wrappers launch from ``lib`` (a side build)."""
    from supereight_tpu_torch.kernels import _lib
    _lib.library()
    saved, _lib._lib = _lib._lib, lib
    try:
        yield
    finally:
        _lib._lib = saved


def launch_durations(trace, kernel):
    """The device microseconds of each launch, in trace order, of the
    kernels whose names hold ``kernel`` in a chrome trace (the parsed
    JSON that ``torch.profiler`` exports)."""
    return [float(e["dur"]) for e in trace["traceEvents"]
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() ==
            "kernel" and kernel in e.get("name", "")]


def kernel_us(fn, kernel, reps=REPS, per_call=1):
    """(median, fastest, slowest) device microseconds of the launches of
    the kernel whose name holds ``kernel`` over ``reps`` calls of ``fn``,
    each launch's own duration (:func:`launch_durations`). The profiler
    traces a warm-up step of ``reps`` calls before the ``reps`` it keeps,
    after one call before it. A call makes ``per_call`` launches of it
    (None: as many as the trace shows over ``reps``, a whole number), and
    its time is the sum of its consecutive launches'; a trace that does
    not show exactly ``per_call * reps`` launches is taken again, up to
    TRIES times, and then this fails. ``fn`` must take ``1 + 2 * TRIES * reps``
    calls."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(TRIES):
        got = []

        def ready(prof):
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    got.extend(launch_durations(json.load(f), kernel))

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        k = per_call or len(got) // reps
        if k and len(got) == k * reps:
            calls = [sum(got[j * k:(j + 1) * k]) for j in range(reps)]
            return statistics.median(calls), min(calls), max(calls)
        print(f"sharded_kernels: a trace showed {len(got)} {kernel} "
              f"launches for {reps} calls; taken again", flush=True)
    raise RuntimeError(f"sharded_kernels: {TRIES} traces showed other than "
                       f"{per_call or 'a whole number of'} {kernel} "
                       f"launches a call over {reps} calls")


def launch_floor_us():
    """Device us of a one-element ``zero_()``."""
    x = torch.zeros(1, device="cuda")
    return kernel_us(lambda: x.zero_(), "")[0]


def capture_dist(field_name, frames, workdir):
    """Rank 1's captured calls (``tools/dist_run.capturing``) at each of
    ``frames`` of the four-rank step on the bench orbit: frame -> the
    capture's ``calls``."""
    from supereight_tpu_torch.tools import bench, dist_run
    cases = [dict(name=f"{field_name}-f{f}", field=field_name,
                  frustum_halo=False, halo_budget=HALO_BUDGET, frames=f + 1,
                  capture=f) for f in frames]
    out = os.path.join(workdir, "dist")
    dist_run.launch(WORLD, "gloo", "cuda", out, bench.scene(), cases)
    dev = torch.device("cuda", 0)
    return {f: torch.load(os.path.join(out, f"capture_{c['name']}.pt"),
                          map_location=dev, weights_only=False)["calls"]
            for f, c in zip(frames, cases)}


def capture_single(field_name, frames):
    """The single-device bench's calls at each of ``frames`` of the
    kernels on ``csrc/compact.cuh``'s compaction besides the sharded
    ones, and of its march: frame -> {"alloc_assign": (geom, a copy of
    the map with the march's touched buffer, when, budget),
    "integrate_worklist" and "node_rank": (args with a copy of the map,
    kwargs), the march's name: its arguments before ``out``}."""
    from supereight_tpu_torch.kernels import node
    from supereight_tpu_torch.ops import allocation, integration
    from supereight_tpu_torch.tools import bench
    from supereight_tpu_torch.tools.dist_run import _copy
    b = bench.config(field_name, torch.device("cuda", 0))
    got, at, saved = {}, [None], []

    def wrap(module, name, record):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            if at[0] is not None:
                got.setdefault(at[0], {})[name] = record(args, kwargs)
            return fn(*args, **kwargs)
        saved.append((module, name, fn))
        setattr(module, name, wrapped)

    wrap(allocation, "alloc_assign", lambda a, kw: (
        a[0], bench.clone_map(a[1]), _copy(a[3] if len(a) > 3 else None),
        a[4] if len(a) > 4 else None))
    wrap(allocation, MARCHES[field_name][0], lambda a, kw: _copy(a[:5]))
    for module, name in ((integration, "integrate_worklist"),
                         (node, "node_rank")):
        wrap(module, name, lambda a, kw: (
            (a[0], bench.clone_map(a[1])) + _copy(tuple(a[2:])), _copy(kw)))
    try:
        state = b.init()
        for i in range(max(frames) + 1):
            at[0] = i if i in frames else None
            state, _ = b.frame(state, i)
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    return got


def fresh(m, n):
    """``n`` copies of the map ``m`` in the fields ``alloc_assign`` writes
    (the pool is shared) and of the touched buffer it consumes (each
    16-byte aligned)."""
    row = -(-m.touched.numel() // 16) * 16
    work = torch.zeros((n, row), dtype=torch.bool, device=m.touched.device)
    work[:, :m.touched.numel()] = m.touched
    return [m._replace(slot=m.slot.clone(), block_coord=m.block_coord.clone(),
                       active=m.active.clone(), n_blocks=m.n_blocks.clone(),
                       mip_alloc=tuple(a.clone() for a in m.mip_alloc),
                       touched=w[:m.touched.numel()]) for w in work]


def timed(tag, fn, kernel):
    """:func:`kernel_us` of ``fn``, printed under ``tag``; returns the
    median and the fastest and slowest launch as a dict."""
    med, lo, hi = kernel_us(fn, kernel)
    print(f"{tag}: {med:.2f} device us a launch (median of {REPS}; "
          f"{lo:.2f}-{hi:.2f})", flush=True)
    return dict(us=med, fastest=lo, slowest=hi)


def side_times(make, kernel, side, tag):
    """Device us a launch (:func:`timed`) of the kernel named ``kernel``
    over the calls of ``make()``, each on its own inputs, with the
    library's kernels (``whole``) and each of ``side`` (name -> library,
    or None where the build does not fit the sources); returns name ->
    :func:`timed`'s dict, or None."""
    out = {}
    for name, lib in (("whole", None),) + tuple(side.items()):
        if name != "whole" and lib is None:
            print(f"{tag} {name}: no such side build of these sources",
                  flush=True)
            out[name] = None
            continue
        fn = make()
        with using(lib) if lib is not None else contextlib.nullcontext():
            out[name] = timed(f"{tag} {name}", fn, kernel)
    return out


def march_times(tag, march, args, window, side):
    """The march ``march`` (:data:`MARCHES`) on ``args`` (geom, depth,
    pose, kpose, mu) over the column window ``window`` ({} for the whole
    frame, else x0 and width), into a scratch touched buffer: its rays
    and CTAs, printed, and :func:`side_times` with ``side``."""
    from supereight_tpu_torch.core.map import touched_buffer
    from supereight_tpu_torch.kernels import alloc
    name, kernel = march
    geom, depth = args[:2]
    fn = getattr(alloc, name)
    scratch = touched_buffer(geom.blocks_per_side, depth.device)
    h, w = depth.shape
    width = window.get("width", w)
    rays = -(-h // 2) * -(-width // 2)
    coarse = -(-h // 8) * -(-width // 8) if kernel.endswith("_of") else 0
    print(f"{tag} {kernel}: columns [{window.get('x0', 0)}, "
          f"{window.get('x0', 0) + width}) of {w}, {rays} rays"
          + (f" and {coarse} coarse rays" if coarse else ""), flush=True)
    out = dict(columns=width, rays=rays, coarse_rays=coarse)
    out.update(side_times(lambda: (lambda: fn(*args, out=scratch, **window)),
                          kernel + "_kernel", side, f"{tag} {kernel}"))
    return out


def measure(field_name, frames, workdir, libs, parts=PARTS):
    """Rank 1's windowed march, halo_pack and owned allocation and the
    single device's march, allocation, worklist and parent rank at each
    of ``frames``, those of ``parts`` (:data:`PARTS`); returns them as a
    dict."""
    march = MARCHES[field_name]
    dist = capture_dist(field_name, frames, workdir)
    single = capture_single(field_name, frames)
    res = {}
    for f in frames:
        calls, r = dist[f], {}
        tag = f"{field_name} frame {f}"
        if "marches" in parts:
            side = {k: libs[k] for k in TOUCH_SIDE[field_name]}
            cols = calls[march[0]]
            r["march_cols"] = march_times(
                f"{tag} rank {RANK}", march, cols["args"],
                {k: cols["kwargs"][k] for k in ("x0", "width")}, side)
            r["march"] = march_times(f"{tag} single device", march,
                                     single[f][march[0]], {}, side)
        if "halo_pack" in parts:
            r.update(halo_times(tag, calls["halo_pack"]["args"][:7], {
                "compaction_only": libs["halo_compaction_only"]}))
        if "alloc_assign" in parts:
            r.update(allocation_times(tag, field_name, calls, single[f], {
                } if field_name == "tsdf" else {
                    "no_extra": libs["alloc_no_extra"]}))
        res[f] = r
    return res


def halo_times(tag, args, side):
    """halo_pack on rank 1's ``args``, with the frustum test and without:
    the rows sent and :func:`side_times` with ``side``."""
    from supereight_tpu_torch.kernels import halo
    r = {}
    n = int(args[1].n_blocks)
    for frustum in (True, False):
        key = "halo_pack" + ("" if frustum else "_all")
        cnt = halo.halo_pack(*args, frustum)[1]
        r[key] = dict(rows=int(cnt[0]), overflow=int(cnt[1]), n_blocks=n)
        print(f"{tag} {key}: {r[key]['rows']} of {n} blocks sent "
              f"(overflow {r[key]['overflow']})", flush=True)
        r[key].update(side_times(
            lambda: (lambda: halo.halo_pack(*args, frustum)),
            "halo_pack_kernel", side, f"{tag} {key}"))
    return r


def allocation_times(tag, field_name, calls, single, side):
    """Rank 1's owned allocation (its captured ``calls``) and the single
    device's allocation, worklist and parent rank (``single``, from
    :func:`capture_single`), each allocation on its own copies of the
    map and grids, the allocations also with ``side``."""
    from supereight_tpu_torch.core.map import touched_grids
    from supereight_tpu_torch.kernels import alloc, node
    from supereight_tpu_torch.kernels import integrate as ki
    levels = 1 if field_name == "tsdf" else 3

    def allocations(geom, m, call):
        """A maker of calls of ``call(map, grids)``, each on its own copy
        of ``m`` and its touched buffer (:func:`fresh`)."""
        b = geom.blocks_per_side

        def make():
            copies = iter(fresh(m, 1 + 2 * TRIES * REPS))

            def one():
                c = next(copies)
                return call(c, touched_grids(c.touched, b, levels))
            return one
        return make

    r = {}
    (geom, m0, _, when), kw = (calls["alloc_assign"]["args"],
                               calls["alloc_assign"]["kwargs"])
    owned = dict(touched=int(touched_grids(
        m0.touched, geom.blocks_per_side, 1)[0].sum()))
    print(f"{tag} alloc_assign_owned: the union touched "
          f"{owned['touched']} cells", flush=True)
    owned.update(side_times(allocations(
        geom, m0,
        lambda c, g: alloc.alloc_assign(geom, c, g[0], when, None,
                                        g[1:], kw["owner"], kw["rank"])),
        "alloc_assign_kernel", side, f"{tag} alloc_assign_owned"))
    r["alloc_assign_owned"] = owned

    for name, kernel in (("integrate_worklist", ki.integrate_worklist),
                         ("node_rank", node.node_rank)):
        c_args, c_kwargs = single[name]
        r[name] = timed(f"{tag} {name} (single device)",
                        lambda: kernel(*c_args, **c_kwargs),
                        name + "_kernel")
    geom1, m1, when1, budget1 = single["alloc_assign"]
    one = dict(touched=int(touched_grids(
        m1.touched, geom1.blocks_per_side, 1)[0].sum()))
    print(f"{tag} alloc_assign (single device): {one['touched']} "
          f"touched cells", flush=True)
    one.update(side_times(allocations(
        geom1, m1,
        lambda c, g: alloc.alloc_assign(geom1, c, g[0], when1, budget1,
                                        g[1:])),
        "alloc_assign_kernel", side, f"{tag} alloc_assign"))
    r["alloc_assign"] = one
    return r


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--field", choices=("tsdf", "ofusion"), action="append")
    p.add_argument("--frame", type=int, action="append")
    p.add_argument("--workdir", help="where the ranks write their captures "
                   "(default: a temporary directory)")
    p.add_argument("--kernels", choices=PARTS, action="append",
                   help="time only these (default: all)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sharded_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    import supereight_tpu_torch
    from supereight_tpu_torch.tools.bench import card
    print(f"# {card()}; kernels of {supereight_tpu_torch.__file__}",
          flush=True)
    parts = tuple(args.kernels or PARTS)
    libs = build_side(tuple(
        name for name in SIDE
        if SIDE_PREFIX[name.split("_")[0]] in parts))
    floor = launch_floor_us()
    print(f"launch floor (a one-element zero_()): {floor:.2f} device us",
          flush=True)
    frames = tuple(args.frame or FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        res = {f: measure(f, frames, args.workdir or tmp, libs, parts)
               for f in args.field or ("tsdf", "ofusion")}
    print(json.dumps({"card": card(), "launch_floor_us": floor,
                      "side_builds": {k: v is not None
                                      for k, v in libs.items()},
                      "sharded_kernels": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
