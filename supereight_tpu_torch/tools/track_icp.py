"""K6's icp_track timed on the card: a frame's whole Gauss-Newton in one
launch, its split into per-iteration and per-pixel cost, and another
checkout's kernel on the same inputs.

    python3 -m supereight_tpu_torch.tools.track_icp [--time] [--split]
        [--parent CHECKOUT] [--field tsdf|ofusion|tsdf-noise ...]
        [--frame N ...]

For each field the bench orbit (``tools/bench.config``; ``tsdf-noise``:
``tools/noise_kernels.slice_config``, the orbit noised frame by frame
with the noise row's options) runs through ``frame_step`` for all its 43
frames, and every frame's ``icp_track`` arguments are copied as the
frame step hands them to the kernel (:func:`capture`); frame 3, before
the step's first raycast, is tracked as ``chip_smoke.py``'s kernel phase
tracks it, against the K1 raycast of the map three frames built, at
their pose, primed with frame 2's depth. The cases: frames
``--frame`` (default 3 and 42) of ``tsdf`` and ``ofusion``, and the
``tsdf-noise`` frame whose launch runs the most Gauss-Newton iterations
(:func:`busiest`; the first of a tie), named with its iterations per
level.

Per case: the iterations the kernel ran at each level (finest first, of
ITERATIONS), the pixel-iterations (each level's pixels times its
iterations), whether the outputs equal the twin's bit for bit and the
pose's largest difference from it, and the first 16 hex digits of the
SHA-256 of the outputs (pose, tracked, reduction, result map), so that
two checkouts compare bit for bit across runs.

``--time``: the device microseconds of a launch, the median of REPS
launches, each launch's own duration from a ``torch.profiler`` chrome
trace (``tools/sharded_kernels.kernel_us``; a trace short of a launch is
taken again), with the fastest and slowest, beside the launch floor (a
one-element ``zero_()``). ``--parent CHECKOUT`` adds CHECKOUT's
``supereight_tpu_torch/csrc/icp.cu`` (for example the parent commit
unpacked by ``git archive``), built with its own headers and this
checkout's flags as a library of its own
(``sharded_kernels.build_sources``) and
timed in turns, parent, this, this, parent, on the same inputs; its
digest is printed beside this checkout's.

``--split`` (implies ``--time``): the side builds of :data:`SPLIT`, each
one source (this checkout's ``icp.cu``, and the parent's with
``--parent``) with a few lines edited here, never in ``csrc/``. Every
side build runs with the level's early break taken out and each level's
iterations set to the ones the whole kernel ran at that level, so each
part is timed over the same iterations: ``nobreak`` (nothing else
changed: the whole kernel at those trip counts), ``no_pass`` (no pixel
pass, a fixed SPD system in the sums, with the exchanges and solves: the
per-iteration chain floor), ``no_solve`` (the pose kept: no step),
``scatter`` (``icp_reduce``'s reduce-scatter warp sum in place of a
shuffle-down tree a term; the parent only), ``pass_only`` (the pixel
pass alone, each thread's sums kept alive and reduced no further),
``step_twice`` (the
step run twice, the first into a scratch pose), ``no_exp`` and
``no_chol`` (the step without its exponential, without its solve),
``approx_solve`` and ``approx_exp`` (their divisions and trigonometry
by the fast approximate intrinsics: diagnostics, not the twin's
results), ``unroll2`` (the pixel loop unrolled twice) and ``timeline``
(thread 0 of each CTA stamps ``clock64()`` through each iteration:
:data:`STAGES`, in SM clocks, averaged over the CTAs and each level's
iterations). From them: F, the device us an iteration of ``no_pass``,
and c, the ns a pixel-iteration of ``nobreak`` less ``no_pass``. The
clusters a launch takes (``kernels/icp.track_clusters``) are printed
first. One line a case and a build, then one JSON line of them all with
the card's name and power limit. It runs on the card only: without a
CUDA device it exits 2.
"""

import argparse
import contextlib
import hashlib
import json
import pathlib
import sys

import torch

FIELDS = ("tsdf", "ofusion", "tsdf-noise")
FRAMES = (3, 42)
ITERATIONS = (10, 5, 4)   # tools/bench.ITERATIONS
# the first frame that frame_step tracks against a reference (its
# raycast comes after frame 3's tracking); the tool takes its reference
# as chip_smoke.py's kernel phase does
FIRST = 3
REPS = 20
ROUNDS = 3   # kernel_us calls (each up to sharded_kernels.TRIES traces)

# the level's early break, as the parent and this checkout write it
_BREAK = ("      if (done) break;  // the reference's per-level early break\n",
          "      if (done) break;  // the level's early break\n")

# no_pass's sums: J^T J = 1e4 I and J^T e = 1e-4, added by one thread
_SPD = ("      if (first == 0) {\n"
        + "".join(f"        acc[{k}] += 1e-4;\n" for k in range(1, 7))
        + "".join(f"        acc[{k}] += 1e4;\n"
                  for k in (7, 13, 18, 22, 25, 27))
        + "      }\n")

# side builds: name -> alternatives, each a list of (old, new) edits of
# csrc/icp.cu; a source takes the first alternative whose every `old` it
# holds exactly once, and none where no alternative fits. Every build
# also takes the early break out (:func:`split_source`).
SPLIT = {
    "nobreak": [[]],
    "no_pass": [
        # the parent: the grid-stride pixel loop runs no pixel, and thread
        # 0 of rank 0 adds a fixed SPD system, so every step solves finite
        # sums as a real frame's
        [("      for (int i = first; i < n; i += stride) {\n"
          "        float z[7];\n",
          "      for (int i = first; i < 0 * n; i += stride) {\n"
          "        float z[7];\n"),
         ("      warp_reduce_terms(acc, warp_sums[warp]);\n",
          _SPD + "      warp_reduce_terms(acc, warp_sums[warp]);\n")],
        # this checkout: the same loop
        [("      for (int i = first; i < n; i += stride) {\n"
          "        float z[7];\n",
          "      for (int i = first; i < 0 * n; i += stride) {\n"
          "        float z[7];\n"),
         ("      // the counts are exact in f64 in any order\n",
          _SPD + "      // the counts are exact in f64 in any order\n")]],
    "no_solve": [
        [("          next_done = gauss_newton_step(red, T, icp_threshold, "
          "next_pose);\n",
          "        {\n          for (int q = 0; q < 16; ++q) next_pose[q] = "
          "T[q];\n          next_done = 0;\n        }\n")],
        [("        const bool now = gauss_newton_step(lane, red, T, "
          "icp_threshold, T);\n",
          "        const bool now = false;\n")]],
    "scatter": [
        [("      warp_reduce_terms(acc, warp_sums[warp]);\n",
          "      warp_sums[warp][lane] = warp_sum_scatter(acc);\n")]],
    "pass_only": [
        [("      warp_reduce_terms(acc, warp_sums[warp]);\n"
          "      __syncthreads();\n"
          "      if (threadIdx.x < kTerms) {\n"
          "        double s = 0.0;\n"
          "#pragma unroll\n"
          "        for (int w = 0; w < kWarps; ++w) s += "
          "warp_sums[w][threadIdx.x];\n"
          "        partial[threadIdx.x] = s;\n"
          "      }\n"
          "      cluster.sync();  // every CTA's partial is written\n"
          "      if (rank == 0 && warp == 0) {\n",
          "#pragma unroll\n"
          "      for (int k = 0; k < kTerms; ++k) asm volatile(\"\" :: "
          "\"d\"(acc[k]));\n"
          "      if (false) {\n"),
         ("      cluster.sync();  // rank 0's pose and flag are written\n"
          "      if (threadIdx.x < 16) {\n",
          "      if (false) {\n"),
         ("      if (threadIdx.x == 0) done = "
          "*cluster.map_shared_rank(&next_done, 0);\n", "")],
        [("      warp_sums[warp][lane] = warp_sum_scatter(acc);\n"
          "      __syncthreads();\n"
          "      if (warp == 0) {\n",
          "#pragma unroll\n"
          "      for (int k = 0; k < kTerms; ++k) asm volatile(\"\" :: "
          "\"d\"(acc[k]));\n"
          "      if (false) {\n")]],
    # this checkout: the step run twice, first into a scratch pose, so the
    # second run finds its code and data warm
    "step_twice": [
        [("        const bool now = gauss_newton_step(lane, red, T, "
          "icp_threshold, T);\n",
          "        __shared__ float scratch[16];\n"
          "        gauss_newton_step(lane, red, T, icp_threshold, scratch);\n"
          "        const bool now = gauss_newton_step(lane, red, T, "
          "icp_threshold, T);\n")]],
    # this checkout: the step without its exponential (exp(x) as the
    # identity with x's translation), and without its Cholesky solve (x a
    # fixed multiple of J^T e): which part of the step's chain costs what
    "no_exp": [
        [("  se3_exp(x, E);\n",
          "#pragma unroll\n"
          "  for (int k = 0; k < 16; ++k) E[k] = k % 5 == 0 ? 1.f : 0.f;\n"
          "  E[3] = x[0];\n  E[7] = x[1];\n  E[11] = x[2];\n")]],
    "no_chol": [
        [("  solve6(lane, red, x);\n",
          "#pragma unroll\n"
          "  for (int k = 0; k < 6; ++k) x[k] = red[1 + k] * 1e-9f;\n")]],
    # this checkout, diagnostics only (their poses are not the twin's):
    # the solve's divisions, and the exponential's divisions and
    # trigonometry, by the fast approximate intrinsics
    "approx_solve": [
        # the one-thread solve
        [("      L[i * 6 + j] = i == j ? sqrtf(s) : s / L[j * 6 + j];\n",
          "      L[i * 6 + j] = i == j ? sqrtf(s) : __fdividef(s, "
          "L[j * 6 + j]);\n"),
         ("    y[i] = s / L[i * 6 + i];\n",
          "    y[i] = __fdividef(s, L[i * 6 + i]);\n"),
         ("    x[i] = s / L[i * 6 + i];\n",
          "    x[i] = __fdividef(s, L[i * 6 + i]);\n")],
        # this checkout's, its columns over the lanes
        [("    const float q = (row > j ? s : d) / d;\n",
          "    const float q = __fdividef(row > j ? s : d, d);\n"),
         ("    y[i] = s / L[i][i];\n",
          "    y[i] = __fdividef(s, L[i][i]);\n"),
         ("    x[i] = s / L[i][i];\n",
          "    x[i] = __fdividef(s, L[i][i]);\n")]],
    "approx_exp": [
        [("    const float sn = sinf(theta);\n"
          "    a = sn / theta;\n"
          "    b = (1.f - cosf(theta)) / (theta * theta);\n"
          "    c = (theta - sn) / (theta * theta * theta);\n",
          "    const float sn = __sinf(theta);\n"
          "    a = __fdividef(sn, theta);\n"
          "    b = __fdividef(1.f - __cosf(theta), theta * theta);\n"
          "    c = __fdividef(theta - sn, theta * theta * theta);\n")]],
    # this checkout: the pixel loop unrolled twice, so two pixels' loads
    # can be in flight at once
    "unroll2": [
        [("      for (int i = first; i < n; i += stride) {\n"
          "        float z[7];\n",
          "#pragma unroll 2\n"
          "      for (int i = first; i < n; i += stride) {\n"
          "        float z[7];\n")]],
    # this checkout: thread 0 of each CTA stamps clock64() at eight points
    # of each iteration and writes the seven intervals (and their sum)
    # over the result map at the end (:data:`STAGES`, :func:`timeline`)
    "timeline": [
        [("  int slot = 0;\n",
          "  int slot = 0;\n"
          "  __shared__ long long stamps[kStampIts][8];\n"
          "  int n_st = 0;\n"
          "#define SE_STAMP(q) if (threadIdx.x == 0 && n_st < kStampIts) "
          "stamps[n_st][q] = clock64()\n"),
         ("    while (it < pyr.iterations[level]) {\n",
          "    while (it < pyr.iterations[level]) {\n      SE_STAMP(0);\n"),
         ("      // the counts are exact in f64 in any order\n",
          "      SE_STAMP(1);\n"),
         ("      warp_sums[warp][lane] = warp_sum_scatter(acc);\n"
          "      __syncthreads();\n",
          "      warp_sums[warp][lane] = warp_sum_scatter(acc);\n"
          "      __syncthreads();\n      SE_STAMP(2);\n"),
         ("        const unsigned dst = smem_addr(&gathered[slot][rank]"
          "[lane]);\n",
          "        SE_STAMP(3);\n        const unsigned dst = "
          "smem_addr(&gathered[slot][rank][lane]);\n"),
         ("        parity ^= 1u << slot;\n",
          "        parity ^= 1u << slot;\n        SE_STAMP(4);\n"),
         ("        const bool now = gauss_newton_step(",
          "        SE_STAMP(5);\n        const bool now = "
          "gauss_newton_step("),
         ("        if (lane == 0) done = now;\n",
          "        if (lane == 0) done = now;\n        SE_STAMP(6);\n"),
         ("      slot ^= 1;\n",
          "      SE_STAMP(7);\n      ++n_st;\n      slot ^= 1;\n"),
         ("  if (blockIdx.x == 0) {\n    // check_pose",
          "  if (threadIdx.x == 0)\n"
          "    for (int k = 0; k < n_st; ++k) {\n"
          "      int* at = result + (blockIdx.x * kStampIts + k) * 8;\n"
          "      at[0] = (int)(stamps[k][7] - stamps[k][0]);\n"
          "      for (int j = 1; j < 8; ++j)\n"
          "        at[j] = (int)(stamps[k][j] - stamps[k][j - 1]);\n"
          "    }\n"
          "  if (blockIdx.x == 0) {\n    // check_pose"),
         ("constexpr int kSums = 28;",
          "constexpr int kStampIts = 24;\nconstexpr int kSums = 28;")]],
}


# the intervals of the timeline build, in SM clocks: thread 0's pass, the
# other warps' passes and the warp sums, the CTA sum, the pushes and the
# wait for every CTA's sums, their sum with the slot's arming and the
# clusters' sum through device memory, the step, the closing block
# barrier
STAGES = ("pass", "warps", "cta_sum", "exchange", "sum", "step", "sync")
STAMP_ITS = 24


def timeline(result, iterations, ctas):
    """Per level (finest first) the mean SM clocks of an iteration and of
    each of :data:`STAGES` over the CTAs and the level's iterations, from
    the result map of the ``timeline`` build run at ``iterations``."""
    t = result.reshape(-1)[:ctas * STAMP_ITS * 8].reshape(ctas, STAMP_ITS, 8)
    t = t.double().mean(0)
    out, k = [], 0
    for lvl in range(len(iterations) - 1, -1, -1):
        rows = t[k:k + iterations[lvl]]
        k += iterations[lvl]
        out.append((lvl, dict(total=float(rows[:, 0].mean()),
                              **{s: float(rows[:, q + 1].mean())
                                 for q, s in enumerate(STAGES)})))
    return dict(sorted(out))


def split_source(name, text):
    """``text`` (an ``icp.cu``) with side build ``name``'s edits and the
    early break taken out, or None where no alternative fits it."""
    brk = [b for b in _BREAK if text.count(b) == 1]
    if not brk:
        return None
    for edits in SPLIT[name]:
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits + [(brk[0], "")]:
                text = text.replace(old, new)
            return text
    return None


def capture(b):
    """Run the bench ``b`` (``tools/bench.Bench``) through all its frames;
    returns each frame's ``icp_track`` arguments before its iterations
    (copies: pose, view, pyramid vertex, normal, valid, reference vertex,
    normal, valid) and the iterations and threshold of the first call.
    Frame 3's reference, which ``frame_step`` has not raycast yet, is
    ``chip_smoke.py``'s kernel-phase one (:func:`first_reference`)."""
    from supereight_tpu_torch.kernels.frame import frame_mats
    from supereight_tpu_torch.ops import tracking
    from supereight_tpu_torch.tools.dist_run import _copy
    calls, track = [], tracking.icp_track

    def wrapped(*args, **kwargs):
        calls.append(_copy(args))
        return track(*args, **kwargs)

    tracking.icp_track = wrapped
    try:
        state = b.init()
        for i in range(len(b.frames)):
            if i == FIRST:
                first = (state.pose.clone(),
                         frame_mats(b.k, state.pose).view,
                         first_reference(b, state, b.frames[i - 1]))
            state, _ = b.frame(state, i)
    finally:
        tracking.icp_track = track
    args = [c[:8] for c in calls]
    if len(args) > FIRST:
        pose, view, ref = first
        args[FIRST] = (pose, view) + args[FIRST][2:5] + ref
    return args, tuple(calls[0][8]), calls[0][9]


def first_reference(b, state, depth):
    """The reference maps (vertex, normal, valid) of the K1 raycast of
    ``state``'s map at its pose, primed with ``depth``: ``chip_smoke.py``'s
    frame-3 case, whose map three frames built."""
    from supereight_tpu_torch.kernels import frame, nav, raycast
    view = frame.frame_mats(b.k, state.pose).kpose
    nv = nav.nav_grid(b.geom, state.map, b.field, bucket=b.kw["budget"])
    rays = raycast.raycast_rays(b.geom, state.map, b.field, nv, view, depth,
                                b.k, b.kw["mu"], b.kw["frame_size"])
    return tuple(t.clone() for t in rays[:3])


def bench_of(field, dev):
    """The bench of ``field`` (:data:`FIELDS`) on ``dev``."""
    from supereight_tpu_torch.tools import bench, noise_kernels
    if field == "tsdf-noise":
        return noise_kernels.slice_config(dev)
    return bench.config(field, dev)


def pixels(args):
    """Each level's pixel count, finest first."""
    return [v.shape[0] * v.shape[1] for v in args[2]]


def busiest(frames, iterations, thr):
    """(frame, iterations run per level) of the frame among ``frames``
    (index -> args) whose launch runs the most iterations, the first of a
    tie."""
    from supereight_tpu_torch.kernels import icp
    runs = {i: icp._icp_track(*a, iterations, thr)[4].tolist()
            for i, a in frames.items()}
    best = max(runs, key=lambda i: (sum(runs[i]), -i))
    return best, runs[best]


def digest(outs):
    """The first 16 hex digits of the SHA-256 of the outputs' bytes."""
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


class Unscratched:
    """A side library whose ``se_icp_track`` takes no cross-cluster scratch
    (an ``icp.cu`` whose launch is one cluster): the wrapper's calls,
    passed on without the scratch."""

    def __init__(self, lib):
        from supereight_tpu_torch.kernels import _lib
        self.lib = lib
        args = list(_lib._SIGNATURES["se_icp_track"])
        lib.se_icp_track.argtypes = args[:-2]

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def se_icp_track(self, *args):
        return self.lib.se_icp_track(*args[:-3], args[-1])


def adapted(lib, text):
    """``lib`` (built from the ``icp.cu`` ``text``) as the wrapper calls
    it."""
    if lib is None or "grid_counts" in text:
        return lib
    return Unscratched(lib)


def parent_library(checkout):
    """CHECKOUT's ``csrc/icp.cu`` built with its own headers as a side
    library, and the source's text."""
    from supereight_tpu_torch.tools import sharded_kernels as sk
    csrc = pathlib.Path(checkout) / "supereight_tpu_torch" / "csrc"
    src = (csrc / "icp.cu").read_text()
    lib = sk.build_sources({"parent": ("icp.cu", src)}, csrc)["parent"]
    return adapted(lib, src), src, csrc


def split_libraries(sources):
    """The side builds of :data:`SPLIT` of each of ``sources`` (prefix ->
    (``icp.cu`` text, its ``csrc`` directory)): name -> library, or None
    where it does not fit."""
    from supereight_tpu_torch.tools import sharded_kernels as sk
    libs = {}
    for prefix, (text, csrc) in sources.items():
        todo = {}
        for name in SPLIT:
            src = split_source(name, text)
            todo[prefix + name] = None if src is None else ("icp.cu", src)
        libs.update({name: adapted(lib, text) for name, lib in
                     sk.build_sources(todo, csrc).items()})
    return libs


def outputs(lib, args, iterations, thr):
    """The kernel's outputs and iterations run, from ``lib`` (None: this
    checkout's)."""
    from supereight_tpu_torch.kernels import icp
    from supereight_tpu_torch.tools import sharded_kernels as sk
    with sk.using(lib) if lib is not None else contextlib.nullcontext():
        return icp._icp_track(*args, iterations, thr)


def time_launch(lib, args, iterations, thr):
    """:func:`tools.sharded_kernels.kernel_us` of the kernel from ``lib``
    (None: this checkout's) on ``args`` at ``iterations``."""
    from supereight_tpu_torch.kernels import icp
    from supereight_tpu_torch.tools import sharded_kernels as sk
    with sk.using(lib) if lib is not None else contextlib.nullcontext():
        for k in range(ROUNDS):
            try:
                return sk.kernel_us(
                    lambda: icp._icp_track(*args, iterations, thr),
                    "icp_track_kernel", REPS)
            except RuntimeError:
                if k + 1 == ROUNDS:
                    raise


def case(tag, args, thr, parent=None, split=None, time=True, ctas=16):
    """One case's numbers (:func:`main`'s), printed under ``tag``; ``ctas``
    is the CTAs of a launch, for the ``timeline`` build."""
    from supereight_tpu_torch.kernels import icp
    out = outputs(None, args, ITERATIONS, thr)
    run = out[4].tolist()
    want = icp.icp_track_plain(*args, ITERATIONS, thr)
    px = pixels(args)
    r = dict(iterations=run, pixels=px,
             pixel_iterations=sum(a * b for a, b in zip(run, px)),
             exact=all(torch.equal(a, b) for a, b in zip(out[:4], want)),
             pose_err=float((out[0] - want[0]).abs().max()),
             sha256=digest(out[:4]), builds={})
    line = (f"{tag}: iterations {run} of {list(ITERATIONS)}, "
            f"{r['pixel_iterations']} pixel-iterations; equal to the twin "
            f"{r['exact']} (pose {r['pose_err']:.2e}); sha256 {r['sha256']}")
    if parent is not None:
        pout = outputs(parent, args, ITERATIONS, thr)
        r["parent_sha256"] = digest(pout[:4])
        r["parent_iterations"] = pout[4].tolist()
        line += (f"; parent's {r['parent_sha256']}, iterations "
                 f"{r['parent_iterations']}")
    print(line, flush=True)
    if not time:
        return r
    order = [("change", None)]
    if parent is not None:
        order = [("parent", parent), ("change", None), ("change", None),
                 ("parent", parent)]
    for name, lib in order:
        r["builds"].setdefault(name, []).append(
            time_launch(lib, args, ITERATIONS, thr))
    for name, lib in (split or {}).items():
        if lib is None:
            continue
        # the split's trip counts: the iterations the build's own whole
        # kernel ran (the parent's for its side builds)
        trips = (r.get("parent_iterations", run)
                 if name.startswith("parent:") else run)
        r["builds"][name] = [time_launch(lib, args, trips, thr)]
        if name.endswith("timeline"):
            r[name] = timeline(outputs(lib, args, trips, thr)[3], trips,
                               ctas)
            for lvl, st in r[name].items():
                print(f"{tag} {name} level {lvl}: " + ", ".join(
                    f"{k} {v:.0f}" for k, v in st.items())
                    + " clocks an iteration", flush=True)
    for prefix in ("", "parent:"):
        b = r["builds"]
        if prefix + "no_pass" in b and prefix + "nobreak" in b:
            trips = (r.get("parent_iterations", run) if prefix else run)
            n_it = sum(trips)
            pix = sum(a * b for a, b in zip(trips, px))
            floor = b[prefix + "no_pass"][0][0]
            whole = b[prefix + "nobreak"][0][0]
            r[prefix + "F_us"] = floor / n_it
            r[prefix + "c_ns"] = (whole - floor) / pix * 1e3
    for name, times in r["builds"].items():
        us = ", ".join(f"{t[0]:.2f}" for t in times)
        print(f"{tag} {name}: {us} device us a launch (median of {REPS}; "
              f"{times[0][1]:.2f}-{times[0][2]:.2f})", flush=True)
    for prefix in ("", "parent:"):
        if prefix + "F_us" in r:
            print(f"{tag} {prefix or 'change:'} F {r[prefix + 'F_us']:.3f} "
                  f"us an iteration (no_pass / iterations), c "
                  f"{r[prefix + 'c_ns']:.4f} ns a pixel-iteration "
                  f"((nobreak - no_pass) / pixel-iterations)", flush=True)
    return r


def measure(field, frames, parent=None, split=None, time=True, ctas=16):
    """:func:`case` of each case of ``field``."""
    dev = torch.device("cuda", 0)
    args, iterations, thr = capture(bench_of(field, dev))
    assert iterations == ITERATIONS, iterations
    if field == "tsdf-noise":
        f, run = busiest(dict(enumerate(args)), iterations, thr)
        print(f"{field}: frame {f} runs the most iterations, {run} "
              f"(finest first)", flush=True)
        picks = (f,)
    else:
        picks = frames
    return {f: case(f"{field} frame {f}", args[f], thr, parent, split,
                    time, ctas) for f in picks}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--time", action="store_true",
                   help="time each case's launch")
    p.add_argument("--split", action="store_true",
                   help="also the side builds of SPLIT (implies --time)")
    p.add_argument("--parent", metavar="CHECKOUT",
                   help="also CHECKOUT's icp_track, in turns with this one")
    p.add_argument("--field", choices=FIELDS, action="append")
    p.add_argument("--frame", type=int, action="append",
                   help="frames of tsdf and ofusion (default 3 and 42)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("track_icp: needs a CUDA device", file=sys.stderr)
        return 2
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.tools import sharded_kernels as sk
    from supereight_tpu_torch.tools.bench import card
    time = args.time or args.split
    print(f"# {card()}; kernels of {_lib.CSRC}", flush=True)
    parent = src = None
    if args.parent:
        parent, src, csrc = parent_library(args.parent)
    split = None
    if args.split:
        sources = {"": ((_lib.CSRC / "icp.cu").read_text(), _lib.CSRC)}
        if src is not None:
            sources["parent:"] = (src, csrc)
        split = split_libraries(sources)
        for name, lib in split.items():
            if lib is None:
                print(f"{name}: no such side build of these sources",
                      flush=True)
    floor = sk.launch_floor_us() if time else None
    if time:
        print(f"launch floor (a one-element zero_()): {floor:.2f} device us",
              flush=True)
    from supereight_tpu_torch.kernels import icp
    clusters = icp.track_clusters(320 * 240, torch.device("cuda", 0))
    print(f"icp_track: {clusters} clusters of 16 CTAs at 320x240",
          flush=True)
    res = {f: measure(f, tuple(args.frame or FRAMES), parent, split, time,
                      16 * clusters) for f in args.field or FIELDS}
    print(json.dumps({"card": card(), "launch_floor_us": floor,
                      "clusters": clusters, "side_builds": {k: v is not None
                                      for k, v in (split or {}).items()},
                      "track_icp": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
