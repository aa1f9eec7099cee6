"""The sharded step's halo_pack and owned allocation, and the single-device
allocation, timed on the card.

    python3 -m supereight_tpu_torch.tools.sharded_kernels
        [--field tsdf|ofusion] [--frame N ...] [--workdir DIR]

For each field: four Gloo ranks of the sharded step (``tools/dist_run.py``)
on card 0 over the bench orbit (``tools/bench.scene()``, the scene of
``chip_smoke.py``'s dist phase) with the exact halo and a halo budget of
HALO_BUDGET blocks a rank, one case a ``--frame`` (default 4, the frame
the dist phase captures, and 42, the last) that runs up to that frame and
writes rank 1's kernel arguments there. Then the single-device bench
(``tools/bench.config``) through ``frame_step``, with ``alloc_assign``'s
arguments copied at the same frames. On rank 1's inputs:

* ``halo_pack`` with the frustum test (the step's default) and without:
  the rows sent, device microseconds of the whole launch and of a side
  build that stops after the compaction (flagging and compaction timed
  apart from the copy);
* ``alloc_assign_owned``: the whole launch;

and on the single device's, ``alloc_assign``'s whole launch and the two
other kernels on ``csrc/compact.cuh``'s compaction, K3's
``integrate_worklist`` and K4's ``node_rank``. For OFusion both
allocations also run a side build without the coarse grids' clusters.
Every allocation call is handed its own copy of the map fields it writes
and of the touched grids it consumes, made before the timing, so each
launch does the frame's work.

A side build is one source of the checkout in use with a few lines
edited (:data:`SIDE`), compiled with the library's flags into its own
library under ``build/side/`` and swapped in for the duration of its
timing; a build whose edit does not fit the source is reported as
absent. Side builds live here only, and no flag of the program selects
one. A device time is the median of the named kernel's launches over
REPS calls, each launch's own duration read from a ``torch.profiler``
chrome trace (:func:`kernel_us`), printed with the fastest and slowest
launch; a trace that does not show all REPS launches is taken again, and
the script fails after TRIES such traces. One line a measurement on
stdout, then one JSON line of them all with the card's name and power
limit.

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
import statistics
import subprocess
import sys
import tempfile

import torch

WORLD, RANK = 4, 1
FRAMES = (4, 42)
REPS = 20
TRIES = 3           # traces taken before a shortfall of launches fails
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
}


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
    root = _lib.BUILD_ROOT.parent / "side"
    nvcc = _lib.nvcc_path()
    jobs, libs = {}, {}
    for name in names:
        src = side_source(name, _lib.CSRC)
        if src is None:
            libs[name] = None
            continue
        fname, text = src
        h = hashlib.sha256(text.encode())
        for p in sorted(_lib.CSRC.glob("*.cuh")):
            h.update(p.read_bytes())
        out = root / h.hexdigest()[:16]
        out.mkdir(parents=True, exist_ok=True)
        for p in _lib.CSRC.glob("*.cuh"):
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


def kernel_us(fn, kernel, reps=REPS):
    """(median, fastest, slowest) device microseconds of the launches of
    the kernel whose name holds ``kernel`` over ``reps`` calls of ``fn``,
    each launch's own duration (:func:`launch_durations`). The profiler
    traces a warm-up step of ``reps`` calls before the ``reps`` it keeps,
    after one call before it; a trace that does not show exactly ``reps``
    launches is taken again, up to TRIES times, and then this fails.
    ``fn`` must take ``1 + 2 * TRIES * reps`` calls."""
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
        if len(got) == reps:
            return statistics.median(got), min(got), max(got)
        print(f"sharded_kernels: a trace showed {len(got)} of {reps} "
              f"{kernel} launches; taken again", flush=True)
    raise RuntimeError(f"sharded_kernels: {TRIES} traces showed other than "
                       f"{reps} {kernel} launches")


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
    ones: frame -> {"alloc_assign": (geom, a copy of the map with the
    march's touched buffer, when, budget), "integrate_worklist" and
    "node_rank": (args with a copy of the map, kwargs)}."""
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


def measure(field_name, frames, workdir, libs):
    """Rank 1's halo_pack and owned allocation and the single device's
    allocation, worklist and parent rank at each of ``frames``; returns
    them as a dict."""
    from supereight_tpu_torch.core.map import touched_grids
    from supereight_tpu_torch.kernels import alloc, halo, node
    from supereight_tpu_torch.kernels import integrate as ki
    levels = 1 if field_name == "tsdf" else 3
    extra_side = {} if field_name == "tsdf" else {
        "no_extra": libs["alloc_no_extra"]}
    halo_side = {"compaction_only": libs["halo_compaction_only"]}
    dist = capture_dist(field_name, frames, workdir)
    single = capture_single(field_name, frames)
    res = {}

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

    for f in frames:
        calls, r = dist[f], {}
        tag = f"{field_name} frame {f}"
        args = calls["halo_pack"]["args"][:7]
        n = int(args[1].n_blocks)
        for frustum in (True, False):
            key = "halo_pack" + ("" if frustum else "_all")
            cnt = halo.halo_pack(*args, frustum)[1]
            r[key] = dict(rows=int(cnt[0]), overflow=int(cnt[1]), n_blocks=n)
            print(f"{tag} {key}: {r[key]['rows']} of {n} blocks sent "
                  f"(overflow {r[key]['overflow']})", flush=True)
            r[key].update(side_times(
                lambda: (lambda: halo.halo_pack(*args, frustum)),
                "halo_pack_kernel", halo_side, f"{tag} {key}"))

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
            "alloc_assign_kernel", extra_side, f"{tag} alloc_assign_owned"))
        r["alloc_assign_owned"] = owned

        for name, kernel in (("integrate_worklist", ki.integrate_worklist),
                             ("node_rank", node.node_rank)):
            c_args, c_kwargs = single[f][name]
            r[name] = timed(f"{tag} {name} (single device)",
                            lambda: kernel(*c_args, **c_kwargs),
                            name + "_kernel")
        geom1, m1, when1, budget1 = single[f]["alloc_assign"]
        one = dict(touched=int(touched_grids(
            m1.touched, geom1.blocks_per_side, 1)[0].sum()))
        print(f"{tag} alloc_assign (single device): {one['touched']} "
              f"touched cells", flush=True)
        one.update(side_times(allocations(
            geom1, m1,
            lambda c, g: alloc.alloc_assign(geom1, c, g[0], when1, budget1,
                                            g[1:])),
            "alloc_assign_kernel", extra_side, f"{tag} alloc_assign"))
        r["alloc_assign"] = one
        res[f] = r
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--field", choices=("tsdf", "ofusion"), action="append")
    p.add_argument("--frame", type=int, action="append")
    p.add_argument("--workdir", help="where the ranks write their captures "
                   "(default: a temporary directory)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sharded_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    import supereight_tpu_torch
    from supereight_tpu_torch.tools.bench import card
    print(f"# {card()}; kernels of {supereight_tpu_torch.__file__}",
          flush=True)
    libs = build_side(tuple(SIDE))
    floor = launch_floor_us()
    print(f"launch floor (a one-element zero_()): {floor:.2f} device us",
          flush=True)
    frames = tuple(args.frame or FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        res = {f: measure(f, frames, args.workdir or tmp, libs)
               for f in args.field or ("tsdf", "ofusion")}
    print(json.dumps({"card": card(), "launch_floor_us": floor,
                      "side_builds": {k: v is not None
                                      for k, v in libs.items()},
                      "sharded_kernels": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
