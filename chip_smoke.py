#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``supereight_tpu_torch``).

Runs on one NVIDIA GPU (built for Hopper, sm_90a) from the root of a
checkout:

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA, nvcc and Triton versions; fails when no CUDA device is present;
2. builds the hand-written CUDA kernels from ``supereight_tpu_torch/csrc``
   (one nvcc per source, in parallel);
3. kernel phases: on a map built by three port frames of the bench scene,
   runs each kernel and its plain PyTorch twin on the same inputs on the
   card, checks them against the stated tolerances and times both; TSDF
   (the pose prologue, K2 nav grid on the map and on random grids of side
   1 to 256, K1 raycast with its prime, select and probe counts, K1's
   unprimed launch (a fresh view's: the pose moved 0.5 m back, marched to
   twice the far plane; and a view whose rays partly start behind the
   surface, which must miss), K6 ICP
   reduction and whole tracking step, K5 march (also on a random depth
   seen from the frame's pose and from outside the map) and allocator
   (which must leave its grids all zero), K3
   worklist, fused pass and fallback on the map the allocator made, K4
   parent rank and node pass, K7 pyramid at 1 to 4 levels and an odd
   size; the noise-grade kernels: K7's bilateral and median filters (one
   pass and two) on frame 3 with range noise and a tenth of its pixels
   0, K3's TSDF noise weight, bilinear read and both, K1's maturity gate
   at W = 4 on the map of frames 0-5 and at W = 2 on frame 3's) and
   OFusion (the prologue, K5-OF march as K5's, K2, K1-OF and its
   unprimed launch, K6, the
   allocator, K3-OF with its bilinear read, K4, K7); then, per field,
   the allocator with a budget of half frame 3's new blocks and into a
   pool with room for half of them (both must drop blocks), and a close
   view of the sphere, allocated and fused (TSDF also noise-weighted),
   whose near blocks take K3's exact-pixel fallback;
4. probe phase: the four gather forms of the Pallas probe (K8) against
   their twins, bit for bit, and both timed, the library call's device
   time and the card's launch floor (a one-element ``zero_()``) beside
   theirs; and ``ops/preprocess.mm2meters`` on the card against numpy
   for all 65,536 u16 values, bit for bit;
   library phase (the library surface's sphere drive, a path of its own
   with the launch counts zeroed just before and read just after): a
   512^3 map over 4.8 m
   with capacity 16,384, a sphere shell allocated by
   ``core/map.allocate_blocks`` (K5's alloc_assign) and its analytic SDF
   written with ``set_voxels``; interp and ``Volume.interp`` at 100k
   points of the band against the SDF (< 1e-3 m), grad against the
   normal (< 0.1 degree), the same allocation, writes and reads on a CPU
   copy (the map equal, interp and grad to 1e-6), ``collides_with``
   inside the sphere (OCCUPIED), in the band outside it (EMPTY) and in
   unallocated space (UNSEEN), and marching cubes (every vertex within a
   voxel of the sphere);
5. slice phases: drives ``parallel/step.frame_step`` at the bench config
   (320x240, 512^3 voxels over 4.8 m, capacity 36864, budget 8192, ICP
   10/5/4; TSDF at mu 0.1, then OFusion at mu 0.008, ``bench.py --field
   ofusion``) over 3 warm-up + 20 + 20 timed distinct frames of the
   synthetic orbit, with every kernel launch count zeroed just before and
   read just after, and any synchronising call inside a frame raising; it
   reports ms/frame of the timed window (CUDA events) and, from a replay
   of its first 5 frames under torch.profiler, each stage's host and
   device time and the device's busy share; it checks the drop counters,
   tracking from frame 4 on, the final position error against ground
   truth and that every kernel of the path was launched (K7, K6, K4's
   rank and pass, K5's allocator, K3's three launches and K2 once a
   frame, the pose prologue twice, K3's former prepass never) and that
   the profile shows K2 and K7 as one device kernel a frame each and the
   frame as its 13 kernels alone (no fill in the allocate span), holds
   the tracking kernel and the prologue to their twins and the
   allocator's incremental mip_alloc to the dense rule on every frame,
   checks the map's touched buffer all zero after every frame,
   and K6, K5, K3, K4 and K7 to their twins once more on the slice's
   last frame; then a third slice, ``tsdf-noise``: TSDF over the orbit
   with range noise (frame i noised by ``add_depth_noise(d, 0.002,
   seed=i)``) under the options of EVAL_table.md's noise+levers row
   (median2, fuse_filtered, min_ref_weight 4, noise_weighted) with its
   pool, budget and bucket of 49,152, whose path adds the filter's launch
   and the gated raycast (14 kernels and copies a frame), whose tracked
   frames must equal those of JAX's frame step over the same frames
   (JAX_NOISE_*, JAX on the CPU), with its block count and final error
   printed beside JAX's, and whose K3 prints what the empty entries of
   its worklist cost; then the probe's own path
   (``supereight_tpu_torch.tools.probe_gather.run``) likewise, each form
   bit for bit against the probe's numpy expectation;
6. pipeline phases: the 250-frame closed loop (``io/convert.synthetic2raw
   scene="loop"``, rendered into a temporary directory in four processes
   while the phases above run) through the port's CLI (``cli.run``, in
   this process) with ``tools/run_longseq_eval.py``'s arguments, TSDF
   (with ``--dump-renders``) and OFusion, then one volume render from a
   view 0.5 m behind the last raycast pose (K1's unprimed launch), each
   path with the launch counts zeroed just before and read just after;
   it holds the drop counters to 0, the tracked fraction to 0.98, the ATE
   to EVAL_table.md's row plus 25 % (TSDF 0.025 m, OFusion 0.020 m), the
   renders to one PPM a rendered frame, and, for TSDF, a checkpoint saved,
   loaded into a new pipeline and run one more frame to the same frame
   without the round trip, bit for bit, and ``dump_mesh`` (triangles,
   time); it prints each ATE beside its row, the log's mean computation a
   frame, wall fps, peak device memory and, from five more frames under
   torch.profiler, the device's busy share; then the TSDF path with the
   keyframe pose graph (``--keyframe-rate 15``, EVAL_table.md's BA row):
   drop counters 0, tracked fraction 0.98, ATE <= 0.0285 m, at least one
   accepted loop closure, icp_track launched once a frame plus once a
   closure try, and the first closure's icp_track (3x gate) against its
   twin; it prints the closures tried and accepted and the BA solves'
   host ms;
7. prints one JSON line of per-kernel results (each with its bound: the
   larger of its bytes over the HBM rate and its operations over the f32
   rate, counted from this run's inputs; and, where one PyTorch call
   computes the same function, that call's time), the card line again,
   and as its last line ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero without the ``ok`` line.
It imports no JAX.
"""

import ast
import collections
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

W, H = 320, 240
SIZE, DIM, CAPACITY = 512, 4.8, 36864
BUDGET = 8192       # integration worklist and raycast pool bucket (bench.py)
MU = {"tsdf": 0.1, "ofusion": 0.008}   # bench.py:50
K = (240.6, 240.0, 160.0, 120.0)
ITERATIONS = (10, 5, 4)
N_WARMUP, N_FRAMES, N_TIMED = 3, 20, 20
N_PROFILED = 5       # timed frames replayed under torch.profiler
PROFILE_TRIES = 3    # profiled replays before a trace that missed launches
                     # fails the run
# m, final position error against ground truth after the 43 frames, both
# fields: the accuracy bar of EVAL_table.md (TSDF loop ATE 0.0200 m). The
# JAX package reaches 0.0047 m at the TSDF config (BENCH_r05.json); its
# value at the OFusion config is not recorded (PERF.md, Findings PR 2).
MAX_POS_ERR = 0.02
# H100 SXM peaks at the 700 W limit (NVIDIA H100 datasheet): HBM3
# bytes/s and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SECTOR = 32  # bytes: the least a scattered store moves to and from HBM
# K3, K4, K5's allocator and K7 calls timed back to back against their
# twins' (new_kernel_rows)
KERNEL_REPS, TWIN_REPS = 50, 5
# f32 operations of K6's per-pixel body (csrc/icp.cu icp_pixel +
# pixel_terms + the accumulation): two 4x4 transforms 36, projection 4,
# residual 3, normal rotation 15, distance 6, normal dot 5, error 5,
# j_rot 9, 28 products, 32 sums; and of one Gauss-Newton solve (Cholesky
# 91, two substitutions 72, exp ~60, exp @ pose 112, norm 12)
ICP_PIXEL_OPS = 143
ICP_SOLVE_OPS = 347
ICP_PIXEL_BYTES = 25     # vertex 12 + normal 12 + valid 1
# f32 operations a gated coarse cell's projection takes (two 4x4
# transforms, the divide and the window tests, as K3's voxel) and each
# field's update of a written value (csrc/fields.cuh)
PROJECT_OPS = 43
UPDATE_OPS = {"tsdf": 19, "ofusion": 44}
BILINEAR_OPS = 30  # K3's bilinear read: 4 reciprocals, 12 products, 4 tests
# K7: per pixel of a coarser level four samples of the robust mean
# (subtract, abs, compare, two adds) and the divide; per pixel of every
# level its ray and vertex (11), the differences (6), the cross product
# (9), the norm (6), the divide (3) and the five tests (csrc/preprocess.cu)
HALF_SAMPLE_OPS = 21
VERTEX_NORMAL_OPS = 40
# K2: per cell the distance's bit tests and the slot pick (~12); per word
# of a column (32 cells) five dilation steps of ~20 operations
NAV_CELL_OPS = 12
NAV_WORD_OPS = 100
# K2's random sweep: grid sides (partial words below 32, several words a
# column past 64) and occupancies
NAV_SIDES = (1, 2, 8, 64, 128, 256)
NAV_DENSITIES = (0.01, 0.1, 0.5)
# K1: per march probe (csrc/raycast.cu probe + the step) ~25 operations;
# per ray the prime from the depth frame ~8 operations
RAY_PROBE_OPS = 25
PRIME_OPS = 8
# the pose prologue (csrc/frame.cu): two 4x4 products 224, R^T t 18, the
# intrinsics 6, gates and time stamp ~11; k, two poses, the verdict and the
# frame read, five matrices, the time stamp and three gates written
FRAME_MATS_OPS = 259
FRAME_MATS_BYTES = 16 + 2 * 64 + 1 + 4 + 81 * 4 + 3
COUNTERS = ("alloc_overflow", "blocks_truncated", "patch_skipped",
            "mip_skipped", "ray_overflow", "pool_bucket_overflow")
# the tsdf-noise slice: the bench orbit with range noise sigma = 0.002 z^2
# (io/synthetic.add_depth_noise, seed i on frame i) under the options of
# EVAL_table.md's "tsdf icp noise=0.002+levers" row
# (tools/run_longseq_eval.py:127-131): its pool (--block-capacity) and its
# integration budget and pool bucket (--preset-budget)
NOISE_FACTOR = 0.002
NOISE_CAPACITY = NOISE_BUDGET = 49152
NOISE_OPTIONS = dict(filter_input="median2", fuse_filtered=True,
                     min_ref_weight=4, noise_weighted=True)
# JAX on the CPU: supereight_tpu/parallel/step.py:frame_step over the same
# 43 noisy frames with the same options (run once, not by this script:
# PERF.md §4). JAX loses the trajectory there (the maturity gate leaves
# ICP the sphere alone from frame 4), yet reports every frame from 4 on
# tracked, with no drop: the slice is held to that tracked set.
JAX_NOISE_TRACKED = tuple(range(4, 43))
JAX_NOISE_BLOCKS = 19148
JAX_NOISE_POS_ERR = 1.8616660833358765
# frame -> (position error m, blocks) of that JAX run, printed beside the
# port's to show where the two trajectories part
JAX_NOISE_AT = {4: (0.1564, 5332), 5: (0.5135, 7599), 10: (0.8294, 10510),
                20: (1.3445, 13848), 30: (1.7091, 16507),
                42: (1.8617, 19148)}
# the filters of K7: a filter CTA's pixels a side, and the operations of
# one bilateral tap (difference, square, divide, exp ~10, two products,
# test, two sums)
FILTER_TILE = 16
BILATERAL_TAP_OPS = 18
MEDIAN_PIXEL_OPS = 9 + 2 * 19 + 1  # tap tests, 19 exchanges, the centre test
# the gate's extra reads a hit: its slot entry and its weight
GATE_HIT_BYTES = 8
# K1's unprimed launch (a fresh view's raycast, ops/rendering.py): the
# frame's pose moved this far (m) back along its optical axis, marched to
# twice the far plane over every block; and a view moved forward until
# its centre ray starts BEHIND m behind the surface the frame saw there,
# where some rays start behind a surface and must miss
BACK_VIEW = 0.5
BEHIND = 0.03
# the pipeline paths: the closed loop (io/convert.synthetic2raw
# scene="loop", rendered in LOOP_WORKERS processes while the kernel phases
# run) through the port's CLI with tools/run_longseq_eval.py's arguments
# (35-42) and its rows' field options, and EVAL_table.md's ATE of each row
# (JAX, bf16 raycast) and its limit, the row plus 25 %
LOOP_FRAMES = 250
LOOP_WORKERS = 4
PIPE_ARGS = ("-s", "4.8", "-p", "0.5,0.4583,0.18", "-c", "2", "-r", "1",
             "-t", "1", "-v", "512", "-k", "481.2,480,320,240", "-y",
             "10,5,4", "--no-stage-sync", "--preset-budget", "36864")
PIPE_FIELD_ARGS = {"tsdf": ("-f", "tsdf", "-m", "0.1", "-z", "4"),
                   "ofusion": ("-f", "ofusion", "-m", "0.008", "-z", "0")}
EVAL_ATE = {"tsdf": 0.0200, "ofusion": 0.0161}
MAX_ATE = {"tsdf": 0.025, "ofusion": 0.020}
MIN_TRACKED = 0.98
N_PIPE_PROFILED = 5  # frames past the loop replayed under torch.profiler
# the BA path: the TSDF pipeline with the keyframe pose graph, as
# tools/run_longseq_eval.py's "tsdf icp+BA" row, held to that row's ATE
# (EVAL_table.md, JAX) plus 25 %; a closure try re-tracks with the 3x gate
BA_ARGS = ("--keyframe-rate", "15")
EVAL_BA_ATE = 0.0228
MAX_BA_ATE = 0.0285
CLOSURE_DIST = 0.3
# the library phase (the library surface's sphere drive): a sphere shell
# at full width, its blocks those whose centre lies within 2 half
# diagonals of the surface (tests/test_meshing.py:78-110), the analytic
# SDF written with set_voxels, and reads in the band around the surface
LIB_SIZE, LIB_DIM, LIB_CAPACITY = 512, 4.8, 16384
LIB_CENTRE, LIB_RADIUS = 2.4, 1.0
LIB_POINTS = 100_000
LIB_BAND = 0.03           # m on either side of the surface
# the SDF is linear to within ~2e-5 m across a voxel at this radius, so a
# read shifted by more than 1 mm (about a ninth of a 9.4 mm voxel), or a
# gradient 0.1 degree off, fails; the card is also held to the same drive
# on the CPU at 1e-6
MAX_INTERP_ERR = 1e-3     # m
MAX_GRAD_ANGLE = 0.1      # degrees
LIB_TWIN_TOL = 1e-6       # interp, grad: card against CPU (rtol and atol)

KERNELS = {  # name -> (source in the repo, TPU-side stage it replaces)
    "icp_reduce": ("supereight_tpu_torch/csrc/icp.cu",
                   "supereight_tpu/ops/tracking.py:56"),
    "icp_track": ("supereight_tpu_torch/csrc/icp.cu",
                  "supereight_tpu/ops/tracking.py:242"),
    "alloc_touch": ("supereight_tpu_torch/csrc/alloc.cu",
                    "supereight_tpu/ops/allocation.py:75"),
    "alloc_touch_of": ("supereight_tpu_torch/csrc/alloc.cu",
                       "supereight_tpu/ops/allocation.py:148"),
    "alloc_assign": ("supereight_tpu_torch/csrc/alloc.cu",
                     "supereight_tpu/core/map.py:273"),
    "integrate_worklist": ("supereight_tpu_torch/csrc/integrate.cu",
                           "supereight_tpu/ops/integration.py:60"),
    "integrate_fused": ("supereight_tpu_torch/csrc/integrate.cu",
                        "supereight_tpu/ops/integration.py:286"),
    "integrate_fused_of": ("supereight_tpu_torch/csrc/integrate.cu",
                           "supereight_tpu/ops/integration.py:286"),
    "integrate_fallback": ("supereight_tpu_torch/csrc/integrate.cu",
                           "supereight_tpu/ops/integration.py:340"),
    "integrate_fallback_of": ("supereight_tpu_torch/csrc/integrate.cu",
                              "supereight_tpu/ops/integration.py:340"),
    "nav_grid": ("supereight_tpu_torch/csrc/nav.cu",
                 "supereight_tpu/ops/raycast.py:138"),
    "raycast": ("supereight_tpu_torch/csrc/raycast.cu",
                "supereight_tpu/ops/raycast.py:454"),
    "raycast_of": ("supereight_tpu_torch/csrc/raycast.cu",
                   "supereight_tpu/ops/raycast.py:454"),
    "gather_a": ("supereight_tpu_torch/csrc/gather_probe.cu",
                 "tools/probe_pallas_gather.py:25"),
    "gather_b": ("supereight_tpu_torch/csrc/gather_probe.cu",
                 "tools/probe_pallas_gather.py:37"),
    "gather_c": ("supereight_tpu_torch/csrc/gather_probe.cu",
                 "tools/probe_pallas_gather.py:50"),
    "gather_d": ("supereight_tpu_torch/csrc/gather_probe.cu",
                 "tools/probe_pallas_gather.py:66"),
    "node_rank": ("supereight_tpu_torch/csrc/node.cu",
                  "supereight_tpu/ops/integration.py:449"),
    "node_pass": ("supereight_tpu_torch/csrc/node.cu",
                  "supereight_tpu/ops/integration.py:377"),
    "pyramid": ("supereight_tpu_torch/csrc/preprocess.cu",
                "supereight_tpu/pipeline.py:27"),
    "frame_mats": ("supereight_tpu_torch/csrc/frame.cu",
                   "supereight_tpu/parallel/step.py:117"),
    "bilateral": ("supereight_tpu_torch/csrc/preprocess.cu",
                  "supereight_tpu/ops/preprocess.py:28"),
    "median": ("supereight_tpu_torch/csrc/preprocess.cu",
               "supereight_tpu/ops/preprocess.py:55"),
    "median2": ("supereight_tpu_torch/csrc/preprocess.cu",
                "supereight_tpu/pipeline.py:40"),
    "integrate_fused_noise": ("supereight_tpu_torch/csrc/integrate.cu",
                              "supereight_tpu/fields/tsdf.py:52"),
    "integrate_fallback_noise": ("supereight_tpu_torch/csrc/integrate.cu",
                                 "supereight_tpu/ops/integration.py:340"),
    "integrate_fused_bilinear": ("supereight_tpu_torch/csrc/integrate.cu",
                                 "supereight_tpu/ops/integration.py:229"),
    "integrate_fused_noise_bilinear": (
        "supereight_tpu_torch/csrc/integrate.cu",
        "supereight_tpu/ops/integration.py:229"),
    "integrate_fused_of_bilinear": ("supereight_tpu_torch/csrc/integrate.cu",
                                    "supereight_tpu/ops/integration.py:229"),
    "raycast_gated": ("supereight_tpu_torch/csrc/raycast.cu",
                      "supereight_tpu/parallel/step.py:171"),
    "raycast_cold": ("supereight_tpu_torch/csrc/raycast.cu",
                     "supereight_tpu/ops/raycast.py:537"),
    "raycast_cold_of": ("supereight_tpu_torch/csrc/raycast.cu",
                        "supereight_tpu/ops/raycast.py:537"),
}
# why no single PyTorch call computes a kernel's function (its library_ms
# is null)
NO_LIBRARY = {
    "icp_reduce": "a gather plus 28 Gram sums",
    "icp_track": "no call runs a Gauss-Newton loop",
    "alloc_touch": "no call marches rays into a grid",
    "alloc_touch_of": "no call marches rays into a grid",
    "alloc_assign": "no call bump-allocates a pool; nonzero would size its "
                    "output on the host",
    "integrate_worklist": "nonzero would size its output on the host",
    "integrate_fused": "no call runs a gated field update",
    "integrate_fused_of": "no call runs a gated field update",
    "integrate_fallback": "no call runs a gated field update",
    "integrate_fallback_of": "no call runs a gated field update",
    "nav_grid": "no call runs a capped distance transform",
    "raycast": "no call marches rays through a sparse grid",
    "raycast_of": "no call marches rays through a sparse grid",
    "node_rank": "nonzero would size its output on the host; no call "
                 "ranks the occupied parents of a grid",
    "node_pass": "no call runs a gated field update",
    "pyramid": "no call takes a robust mean or makes a sentinel normal map",
    "frame_mats": "no call builds the frame's pose select, gates and five "
                  "matrices; a matmul is one of its five products",
    "bilateral": "no call runs a range-weighted (bilateral) filter",
    "median": "no call takes a 3x3 median with zero taps replaced by the "
              "centre",
    "median2": "no call takes a 3x3 median with zero taps replaced by the "
               "centre",
    "integrate_fused_noise": "no call runs a gated field update",
    "integrate_fallback_noise": "no call runs a gated field update",
    "integrate_fused_bilinear": "no call runs a gated field update",
    "integrate_fused_noise_bilinear": "no call runs a gated field update",
    "integrate_fused_of_bilinear": "no call runs a gated field update",
    "raycast_gated": "no call marches rays through a sparse grid",
    "raycast_cold": "no call marches rays through a sparse grid",
    "raycast_cold_of": "no call marches rays through a sparse grid",
}
# device kernel names (without "_kernel") reported from the profile, and
# the frame_step stage that launches each; the OFusion instantiations are
# the <true> ones; K1's unprimed instantiations (raycast_kernel<of, false,
# false>) are named raycast_cold (port_kernel), launched by a fresh view's
# render of the class pipeline
PROFILED = {"raycast_cold": "render", "pyramid": "preprocess",
            "bilateral": "preprocess",
            "median": "preprocess", "icp_reduce": "track",
            "icp_track": "track", "frame_mats": "track",
            "alloc_touch": "allocate", "alloc_touch_of": "allocate",
            "alloc_assign": "allocate", "integrate_worklist": "integrate",
            "integrate_fused": "integrate", "integrate_fallback": "integrate",
            "node_rank": "integrate", "node_pass": "integrate",
            "nav_grid": "raycast", "raycast": "raycast"}
PATHS = {  # the kernels each main path must launch
    "tsdf": ("pyramid", "frame_mats", "icp_track", "alloc_touch",
             "alloc_assign", "integrate_worklist", "integrate_fused",
             "integrate_fallback", "node_rank", "node_pass", "nav_grid",
             "raycast"),
    "ofusion": ("pyramid", "frame_mats", "icp_track", "alloc_touch_of",
                "alloc_assign", "integrate_worklist", "integrate_fused_of",
                "integrate_fallback_of", "node_rank", "node_pass",
                "nav_grid", "raycast_of"),
    "tsdf-noise": ("median2", "pyramid", "frame_mats", "icp_track",
                   "alloc_touch", "alloc_assign", "integrate_worklist",
                   "integrate_fused_noise", "integrate_fallback_noise",
                   "node_rank", "node_pass", "nav_grid", "raycast_gated"),
    "probe": ("gather_a", "gather_b", "gather_c", "gather_d"),
    # the class pipeline through the CLI, then a fresh view's render
    "pipeline-tsdf": ("pyramid", "frame_mats", "icp_track", "alloc_touch",
                      "alloc_assign", "integrate_worklist", "integrate_fused",
                      "integrate_fallback", "node_rank", "node_pass",
                      "nav_grid", "raycast", "raycast_cold"),
    "pipeline-ofusion": ("pyramid", "frame_mats", "icp_track",
                         "alloc_touch_of", "alloc_assign",
                         "integrate_worklist", "integrate_fused_of",
                         "integrate_fallback_of", "node_rank", "node_pass",
                         "nav_grid", "raycast_of", "raycast_cold_of"),
    # the TSDF pipeline with keyframes: the loop-closure re-tracks are
    # icp_track and frame_mats launches too
    "pipeline-tsdf-ba": ("pyramid", "frame_mats", "icp_track",
                         "alloc_touch", "alloc_assign", "integrate_worklist",
                         "integrate_fused", "integrate_fallback",
                         "node_rank", "node_pass", "nav_grid", "raycast"),
    # the library surface: allocate_blocks over a sphere shell
    "library": ("alloc_assign",),
}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def versions(torch):
    from supereight_tpu_torch.kernels import _lib
    nvcc = subprocess.run([_lib.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    return (f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, nvcc: {nvcc}, triton {triton_v}")


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of fn() over reps back-to-back calls,
    between CUDA events on the stream: the device time where the device
    is the bound, the host's enqueue time where the wrapper is."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(torch, fn, reps, per_call=None):
    """Device microseconds per call of fn() from torch.profiler: the sum
    of the kernels and copies it runs, over reps calls. The device trace
    misses the first launches after it starts (1 to 5 of 20 on the H100),
    so where ``per_call``, the kernels and copies one call runs, is known,
    the sum is averaged over the calls the trace shows, not over reps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    seen = sum(e.count for e in events)
    calls = seen / per_call if per_call and seen else reps
    return sum(e.self_device_time_total for e in events) / calls


def bound(n_bytes, n_ops):
    """The least time the card could take for a function that moves
    n_bytes (each input read once, each output written once) and does
    n_ops operations: the larger of the two times at the card's peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def set_sectors(torch, grids):
    """The SECTOR-byte runs of the bool grids that hold a set cell: the
    least a march into zeroed grids writes, and a clear writes back."""
    n = 0
    for g in grids:
        f = g.reshape(-1)
        f = torch.cat([f, f.new_zeros(-f.numel() % SECTOR)])
        n += int(f.view(-1, SECTOR).any(1).sum())
    return n


def icp_bound(args, run):
    """K6 icp_track's bound for one frame: the pyramid and the reference
    read once, the finest result map written once, and the pixel body
    over the iterations this frame ran at each level."""
    _, _, verts, _, _, ref_vertex, _, _ = args
    px = [v.shape[0] * v.shape[1] for v in verts]
    ref = ref_vertex.shape[0] * ref_vertex.shape[1]
    n_bytes = ((sum(px) + ref) * ICP_PIXEL_BYTES + px[0] * 4
               + 4 * 64 + 32 * 4 + 1 + 4 * len(px))
    n_ops = (sum(r * n for r, n in zip(run, px)) * ICP_PIXEL_OPS
             + sum(run) * ICP_SOLVE_OPS)
    return bound(n_bytes, n_ops)


def track_errors(torch, got, want):
    """K6 icp_track's outputs (pose, tracked, reduction, result) against
    its twin's: (within the tolerances, errors). Tracked equal, pose to
    1e-4, reduction entries 0-27 to 1e-3 of themselves (floored at 1e-4
    of the largest), the counts 28-31 to 0.1 % of the pixels, result codes
    on >= 99.9 % of pixels."""
    rp = want[2]
    scale = rp[:28].abs() + 1e-4 * rp[:28].abs().max()
    diff = (got[2][:28] - rp[:28]).abs()
    # frames without a reference reduce to all zeros: equal is exact there
    rel = torch.where(diff == 0, torch.zeros_like(diff), diff / scale)
    e = dict(tracked=(bool(got[1]), bool(want[1])),
             pose=(got[0] - want[0]).abs().max().item(),
             rel=rel.max().item(), worst=int(rel.argmax()),
             counts=(got[2][28:] - rp[28:]).abs().max().item(),
             agree=(got[3] == want[3]).float().mean().item(),
             n_px=want[3].numel())
    ok = (e["tracked"][0] == e["tracked"][1] and e["pose"] <= 1e-4
          and e["rel"] <= 1e-3 and e["counts"] <= 1e-3 * e["n_px"]
          and e["agree"] >= 0.999)
    return ok, e


def check_icp_track(torch, tag, args, dist_threshold=None):
    """K6 icp_track against its twin on one frame's tracking inputs (with
    ``dist_threshold``, else the tracker's own gate): the tolerances of
    :func:`track_errors` and two launches bit-identical. Returns the
    kernel's row."""
    from supereight_tpu_torch.constants import DIST_THRESHOLD
    from supereight_tpu_torch.kernels import icp
    gate = dict(dist_threshold=DIST_THRESHOLD if dist_threshold is None
                else dist_threshold)

    def call():
        return icp.icp_track(*args, ITERATIONS, 1e-5, **gate)

    want = icp.icp_track_plain(*args, ITERATIONS, 1e-5, **gate)
    # the kernel's outputs and the iterations it ran at each level
    got = icp._icp_track(*args, ITERATIONS, 1e-5, **gate)
    run = got[4].tolist()
    got = got[:4]
    same = all(torch.equal(a, b) for a, b in zip(got, call()))
    ok, e = track_errors(torch, got, want)
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    ms = cuda_ms(torch, call, 20)
    us = device_us(torch, call, 10, 1)
    print(f"{tag}: tracked {e['tracked'][0]} vs {e['tracked'][1]}, pose "
          f"max err {e['pose']:.3e} (<= 1e-4), reduction 0-27 max rel err "
          f"{e['rel']:.3e} (<= 1e-3; entry {e['worst']}), counts max err "
          f"{e['counts']:.0f} (<= {1e-3 * e['n_px']:.1f}), result codes "
          f"agree on {e['agree']:.6f} (>= 0.999), equal to the twin bit for "
          f"bit: {exact}, two launches bit-identical: {same}; iterations "
          f"run per level (finest first) {run} of {list(ITERATIONS)}; call "
          f"{ms:.4f} ms, device {us:.2f} us/launch")
    require(ok and same, f"{tag}: icp_track disagrees with twin")
    row = dict(max_abs_err=e["pose"], ms=ms, **icp_bound(args, run))
    row["plain_ms"] = cuda_ms(torch, lambda: icp.icp_track_plain(
        *args, ITERATIONS, 1e-5, **gate), 3)
    print(f"{tag}: twin call {row['plain_ms']:.4f} ms; bound "
          f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
    return row


def track_args(torch, sc, state, depth):
    """One frame's tracking inputs, as frame_step hands them to K6: the
    state's pose, K @ raycast_pose^-1 (the prologue's twin), the frame's
    pyramid and the state's reference maps."""
    from supereight_tpu_torch.kernels.frame import frame_mats_plain
    from supereight_tpu_torch.pipeline import preprocess_and_pyramid
    _, verts, norms, valids = preprocess_and_pyramid(
        depth, sc.kt, len(ITERATIONS), False, sc.kw["filter_input"])
    view = frame_mats_plain(sc.kt, state.raycast_pose).view
    return (state.pose, view, verts, norms, valids, state.vertex,
            state.normal, state.valid)


def port_kernel(key):
    """(name, label) of a profiled device kernel of the port (PROFILED's
    names; K1's unprimed instantiations as raycast_cold), else None."""
    m = re.search(r"(\w+)_kernel(<[^>(]*>)?\(", key)
    if not m or m.group(1) not in PROFILED:
        return None
    name, targs = m.group(1), m.group(2) or ""
    if name == "raycast" and targs.count(",") == 2 \
            and targs.replace(" ", "").endswith(",false>"):
        name = "raycast_cold"
    return name, m.group(1) + "_kernel" + targs


def report_profile(prof, ms_frame, tag):
    """Print the per-stage and per-kernel device time of the profiled
    frames, and the device's busy share of the unprofiled frame time.
    Returns the launches a frame of each of the port's device kernels
    (PROFILED's names) and of all kernels and copies, and the device us a
    frame of the torch ops in each span and outside them."""
    from torch.autograd import DeviceType

    def dev_us(e, self_only):
        return e.self_device_time_total if self_only \
            else e.device_time_total

    events = prof.key_averages()
    stages = [e for e in events if e.key.startswith("frame_step/")
              and e.device_type == DeviceType.CPU]
    # device-side events: kernels and copies, plus the GPU-timeline copies
    # of the frame_step/* annotations, which are spans and not work
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("frame_step/")]
    # the profiler ties a kernel to the torch op that launched it, and a
    # span's device time sums its ops': the port's kernels, launched
    # through ctypes with no op around them, are added to their stages
    port, port_us = [], {}  # (event, label); stage -> device us
    for e in kernels:
        pk = port_kernel(e.key)
        if pk:
            port.append((e, pk[1]))
            stage = "frame_step/" + PROFILED[pk[0]]
            port_us[stage] = port_us.get(stage, 0.0) + dev_us(e, True)
    for e in sorted(stages, key=lambda e: e.key):
        extra = port_us.get(e.key, 0.0)
        print(f"{tag} profile: {e.key:22s} host "
              f"{e.cpu_time_total / 1e3 / N_PROFILED:8.3f} ms/frame, device "
              f"{(dev_us(e, False) + extra) / 1e3 / N_PROFILED:8.3f} "
              f"ms/frame (the port's kernels "
              f"{extra / 1e3 / N_PROFILED:.3f} of it)")
    busy = sum(dev_us(e, True) for e in kernels) / 1e3 / N_PROFILED
    n_launch = sum(e.count for e in kernels) / N_PROFILED
    print(f"{tag} profile: device busy {busy:.3f} ms/frame in "
          f"{n_launch:.0f} kernels and copies a frame; busy share of the "
          f"timed {ms_frame:.3f} ms/frame: {busy / ms_frame:.4f}")
    per_frame = {}
    for e, label in port:
        name = label.split("_kernel")[0]
        per_frame[name] = per_frame.get(name, 0) + e.count / N_PROFILED
        print(f"{tag} profile: port kernel {label:32s} "
              f"{dev_us(e, True) / max(e.count, 1):9.2f} us/launch, "
              f"{e.count / N_PROFILED:5.1f} launches/frame")
    # the torch ops left in the frame: each op called directly in one of
    # the five stage spans, or in frame_step outside every span (a
    # top-level op of the replay), with the device time of the kernels and
    # copies it (and the ops under it) ran
    outside = "outside the spans"
    groups = {e.key: {} for e in stages}
    groups[outside] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU \
                or ev.name.startswith("frame_step/"):
            continue
        group = outside if ev.cpu_parent is None else ev.cpu_parent.name
        if group not in groups:
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        n, t = groups[group].get(ev.name, (0, 0.0))
        groups[group][ev.name] = (n + 1, t + us)
    op_us = {}
    for group in sorted(groups):
        ops = sorted(((t, n, k) for k, (n, t) in groups[group].items()
                      if t > 0), reverse=True)
        op_us[group] = sum(t for t, _, _ in ops) / N_PROFILED
        print(f"{tag} profile: {group} torch ops, device us/frame: "
              f"{sum(t for t, _, _ in ops) / N_PROFILED:.2f} in all, "
              f"{sum(n for _, n, _ in ops) / N_PROFILED:g} ops; "
              + ", ".join(f"{k} {t / N_PROFILED:.2f} ({n / N_PROFILED:g}x)"
                          for t, n, k in ops))
    return per_frame, n_launch, op_us


def require(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def clone_map(m):
    return type(m)(*(tuple(x.clone() for x in v) if isinstance(v, tuple)
                     else v.clone() for v in m))


def clone_frame_state(s):
    return s._replace(map=clone_map(s.map), pose=s.pose.clone(),
                      raycast_pose=s.raycast_pose.clone())


class Scene:
    """The bench scene and a frame runner for one field on the card; with
    ``noisy`` the tsdf-noise slice: the orbit's frames noised (frame i
    with seed i, made before any timing), the eval row's pool, budget and
    options."""

    def __init__(self, torch, field, dev, noisy=False):
        import numpy as np
        from supereight_tpu_torch.core.map import MapGeometry
        from supereight_tpu_torch.io import synthetic
        from supereight_tpu_torch.parallel import step as pstep
        self.torch, self.np, self.pstep = torch, np, pstep
        self.field, self.mu, self.dev = field, MU[field.name], dev
        self.noisy = noisy
        self.name = field.name + ("-noise" if noisy else "")
        capacity, budget = ((NOISE_CAPACITY, NOISE_BUDGET) if noisy
                            else (CAPACITY, BUDGET))
        self.geom = MapGeometry(size=SIZE, dim=DIM, capacity=capacity)
        self.n_total = N_WARMUP + N_FRAMES + N_TIMED
        self.depths, self.poses = synthetic.orbit_sequence(
            self.n_total, K, width=W, height=H, radius=0.3 * DIM,
            center=(DIM / 2,) * 3, sphere_radius=0.15 * DIM, angle_span=0.5,
            room=((0.55, 0.55, 0.55), (DIM - 0.55,) * 3))
        if noisy:
            self.depths = np.stack([
                synthetic.add_depth_noise(d, NOISE_FACTOR, seed=i)
                for i, d in enumerate(self.depths)])
        self.kt = torch.tensor(K, dtype=torch.float32).to(dev)
        self.depths_t = [torch.from_numpy(d).to(dev) for d in self.depths]
        self.budget = pstep.integration_budget(self.geom, budget)
        self.options = NOISE_OPTIONS if noisy else {}
        self.kw = dict(frame_size=(W, H), iterations=ITERATIONS, mu=self.mu,
                       icp_threshold=1e-5, neg_y=False, filter_input=False,
                       use_gt_pose=False, integration_rate=1,
                       tracking_rate=1, budget=self.budget)
        self.kw.update(self.options)

    def init(self):
        return self.pstep.init_frame_state(self.geom, self.field, (W, H),
                                           self.poses[0], self.dev)

    def frame(self, state, i):
        # frame_step must enqueue without reading anything back: a
        # synchronising call inside it raises here
        self.torch.cuda.set_sync_debug_mode("error")
        try:
            return self.pstep.frame_step(self.geom, self.field, state,
                                         self.depths_t[i], self.kt, i,
                                         **self.kw)
        finally:
            self.torch.cuda.set_sync_debug_mode("default")

    def run_frames(self, n):
        state = self.init()
        for i in range(n):
            state, _ = self.frame(state, i)
        return state


def alloc_bound(torch, geom, depth, pose, kpose, mu):
    """K5 alloc_touch: the 2x2-sampled depth read once and the sectors
    holding a touched cell written once (the grid is zero before the
    march, so no other byte must move), counted from this run's grid (the
    twin's, equal to the kernel's); per valid sampled pixel the ray setup
    (~40 operations) and ~13 per band sample (csrc/alloc.cu)."""
    from supereight_tpu_torch.kernels import alloc
    _, num_steps, _ = alloc.band_schedule(geom, mu)
    rays = int((depth[::2, ::2] > 0).sum())
    grid = alloc.touched_mask_plain(geom, depth, pose, kpose, mu)
    return bound(rays * 4 + SECTOR * set_sectors(torch, (grid,)) + 2 * 64,
                 rays * (40 + 13 * num_steps))


def alloc_of_bound(torch, geom, depth, pose, kpose, mu):
    """K5-OF alloc_touch_of: the 2x2- and 8x8-sampled depth and the ladder
    read once and the sectors holding a touched cell of the three grids
    written once, counted from this run's grids (the twin's); per valid
    ray the setup (~50 operations) and ~13 per sample of its levels that
    lies short of its surface (f32(t) < dist: a ray stops at its first
    dead sample), counted from this run's rays."""
    from supereight_tpu_torch.kernels import alloc
    ladder = alloc.of_ladder(geom, mu, None, depth.device)
    n = ladder.t.numel()
    rays = samples = 0
    for stride, ts in ((2, ladder.t[:ladder.n_fine]),
                       (8, ladder.t[ladder.n_fine:])):
        _, _, valid, dist = alloc.of_rays(geom, depth, stride, pose, kpose,
                                          mu)
        rays += int(valid.sum())
        samples += int((ts[:, None] < dist[valid][None, :]).sum())
    grids = alloc.touched_masks_of_plain(geom, depth, pose, kpose, mu)
    return bound(rays * 4 + 5 * n + 8 + SECTOR * set_sectors(torch, grids)
                 + 2 * 64, rays * 50 + 13 * samples)


def march_cases(torch, geom, depth, pose, seed):
    """The marches' inputs beyond a frame of the orbit, (name, depth,
    pose): a random depth of the frame's size, surfaces from 0.3 m to 1.25
    times the occupancy march's range (dim x sqrt 3) and a tenth of the
    pixels 0, from numpy's generator seeded with ``seed``, seen from the
    frame's pose and from a camera outside the map (one dim in front of a
    face, looking at the centre)."""
    import numpy as np
    from supereight_tpu_torch.io import synthetic
    rng = np.random.RandomState(seed)
    h, w = depth.shape
    d = rng.uniform(0.3, 1.25 * geom.dim * np.sqrt(3.0),
                    (h, w)).astype(np.float32)
    d[rng.rand(h, w) < 0.1] = 0.0
    c = np.full(3, geom.dim / 2)
    outside = synthetic.look_at(c - np.array([0.0, 0.0, geom.dim]), c)
    d = torch.from_numpy(d).to(depth.device)
    return [("random depth", d, pose),
            ("random depth, camera outside the map", d,
             torch.from_numpy(outside).to(depth.device))]


def check_marches(torch, geom, field, mu, k, cases, tag):
    """The field's K5 march (alloc_touch, or alloc_touch_of) against its
    twin on each (name, depth, pose) case, every grid bit for bit; each
    kernel launch a fresh, zeroed touched buffer. Returns the mismatches
    in all."""
    from supereight_tpu_torch.core.map import touched_buffer
    from supereight_tpu_torch.kernels import alloc
    from supereight_tpu_torch.kernels.frame import frame_mats_plain
    bad = 0
    for name, depth, pose in cases:
        kpose = frame_mats_plain(k, pose).kpose
        out = touched_buffer(geom.blocks_per_side, depth.device)
        if field.name == "tsdf":
            got = (alloc.touched_mask(geom, depth, pose, kpose, mu, out),)
            want = (alloc.touched_mask_plain(geom, depth, pose, kpose, mu),)
        else:
            got = alloc.touched_masks_of(geom, depth, pose, kpose, mu, out)
            want = alloc.touched_masks_of_plain(geom, depth, pose, kpose, mu)
        mism = [int((a != b).sum()) for a, b in zip(got, want)]
        print(f"{tag} ({name}): touched cells per level "
              f"{[int(g.sum()) for g in want]}, mismatches {mism} (== 0)")
        bad += sum(mism)
    return bad


def check_alloc(torch, sc, m, pose, depth, tag, budget=None, capacity=None):
    """K5 alloc_assign against its twin on two copies of ``m``, for the
    touched grids of ``depth`` at ``pose`` (the field's march on the card)
    under a true ``when``: slot grid, block_coord, active, n_blocks,
    alloc_overflow and every mip_alloc level bit for bit, and mip_alloc
    against the dense rule (JAX's refresh over every allocated block; the
    kernel's refresh is incremental). ``budget`` caps the new blocks,
    ``capacity`` cuts the pool to that many slots. Returns the kernel's
    row (error and bound: the touched grid read once, the slot grid under
    its touched cells, the extra grids, the new entries and the mip bytes
    set written once), its and its twin's calls, the kernel's map and
    alloc_overflow. Each call consumes the grids it is given (they are all
    zero on return, checked here for both), so each call, timed ones too,
    is handed its own copy of the march's touched buffer, all made before
    by one copy launch; the timed calls are the wrapper's alone."""
    from supereight_tpu_torch.core.map import (MapGeometry, refresh_mip_alloc,
                                               touched_buffer, touched_grids)
    from supereight_tpu_torch.kernels import alloc
    from supereight_tpu_torch.kernels.frame import frame_mats_plain
    geom, field, mu = sc.geom, sc.field, sc.mu
    if capacity is not None:
        geom = MapGeometry(size=SIZE, dim=DIM, capacity=capacity)
        m = m._replace(**{n: getattr(m, n)[:capacity] for n in
                          ("data_x", "data_y", "block_coord", "active")})
    kpose = frame_mats_plain(sc.kt, pose).kpose
    b = geom.blocks_per_side
    buf = touched_buffer(b, sc.dev)
    grids = ((alloc.touched_mask(geom, depth, pose, kpose, mu, buf),)
             if field.name == "tsdf"
             else alloc.touched_masks_of(geom, depth, pose, kpose, mu, buf))
    when = torch.ones((), dtype=torch.bool, device=sc.dev)
    ma, mb, md = clone_map(m), clone_map(m), clone_map(m)
    row_bytes = -(-buf.numel() // 16) * 16  # each copy 16-byte aligned

    def copies(n):
        """n copies of the march's grids, as the calls take them."""
        work = torch.zeros((n, row_bytes), dtype=torch.bool, device=sc.dev)
        work[:, :buf.numel()] = buf
        return [touched_grids(w[:buf.numel()], b, len(grids)) for w in work]

    def call(fn, mm, views):
        return fn(geom, mm, views[0], when, budget, views[1:])

    (ka,), (kb,) = copies(1), copies(1)
    over = int(call(alloc.alloc_assign, ma, ka))
    left = sum(int(g.sum()) for g in ka)
    over_p = int(call(alloc.alloc_assign_plain, mb, kb))
    left_p = sum(int(g.sum()) for g in kb)
    refresh_mip_alloc(geom, md, ma.slot >= 0,
                      extra_levels=(None,) + tuple(grids[1:]))
    mism = {n: int((getattr(ma, n) != getattr(mb, n)).sum())
            for n in ("slot", "block_coord", "active", "n_blocks")}
    mism["mip_alloc"] = sum(int((a != b).sum())
                            for a, b in zip(ma.mip_alloc, mb.mip_alloc))
    dense = sum(int((a != b).sum())
                for a, b in zip(ma.mip_alloc, md.mip_alloc))
    n_old, n_new = int(m.n_blocks), int(ma.n_blocks)
    touched = int(grids[0].sum())
    print(f"{tag}: {touched} touched cells, {n_new - n_old} new blocks "
          f"({n_old} -> {n_new} of {geom.capacity}), alloc_overflow {over} "
          f"vs {over_p}, mismatches {mism} (all 0), mip_alloc against the "
          f"dense rule {dense} mismatches (0), grid bytes left set after "
          f"the kernel / the twin {left} / {left_p} (0)")
    require(over == over_p and sum(mism.values()) == 0 and dense == 0,
            f"{tag} disagrees with twin")
    require(left == 0 and left_p == 0, f"{tag} left its grids set")
    mip_set = sum(int((a != c).sum())
                  for a, c in zip(ma.mip_alloc, m.mip_alloc))
    row = dict(max_abs_err=float(sum(mism.values()) + abs(over - over_p)),
               **bound(b ** 3 + 4 * touched
                       + sum(g.numel() for g in grids[1:])
                       + SECTOR * set_sectors(torch, grids)
                       + 17 * (n_new - n_old) + mip_set + 8, b ** 3))
    # cuda_ms makes one untimed call before its timed ones
    timed, timed_p = (iter(copies(n + 1)) for n in (KERNEL_REPS, TWIN_REPS))
    return (row, lambda: call(alloc.alloc_assign, ma, next(timed)),
            lambda: call(alloc.alloc_assign_plain, mb, next(timed_p)), ma,
            over)


def payload_errors(field, a, b):
    """The fused payloads of two maps against each other: (largest data_x
    error, within K3's tolerances — TSDF data_x to 1e-5, OFusion log-odds
    to 1e-4 + 1e-5 |x| (log2f against torch.log2) —, data_y and active
    exactly, message)."""
    dx = (a.data_x - b.data_x).abs()
    ey = int((a.data_y != b.data_y).sum())
    act = int((a.active != b.active).sum())
    if field.name == "ofusion":
        bad = int((dx > 1e-4 + 1e-5 * b.data_x.abs()).sum())
        ok, tol = bad == 0, f"{bad} beyond 1e-4 + 1e-5 |x| (== 0)"
    else:
        ok, tol = dx.max().item() <= 1e-5, "(<= 1e-5)"
    ex = dx.max().item()
    return ex, ok and ey == 0 and act == 0, (
        f"data_x max err {ex:.3e} {tol}, data_y mismatches {ey} (== 0), "
        f"active mismatches {act} (== 0)")


def changed(a, b):
    """Voxels whose payload differs between two maps."""
    return int(((a.data_x != b.data_x) | (a.data_y != b.data_y)).sum())


def check_block_pass(torch, sc, m, pose, depth, ts, tag, noise=False,
                     bilinear=False):
    """K3's three launches against their twins on two copies of ``m``,
    fusing ``depth`` at ``pose`` stamped ``ts`` under a true ``when``: the
    worklist, n_active and blocks_truncated exactly; then the fused pass
    (mode, n_valid, need exactly, payloads by :func:`payload_errors`);
    then the fallback (patch_skipped and the final mode exactly, payloads
    again). ``noise``: the TSDF noise_weighted mode of both passes;
    ``bilinear``: the bilinear read, whose fused pass writes patch_skipped
    (0) and has no fallback. Returns each kernel's row (under its mode's
    launch name), kernel call and twin call, and the counts (listed,
    need, fallback-fused blocks, patch_skipped).

    Bounds, counted from these inputs: the worklist reads the active flag
    of every allocated slot and the coordinates of the active ones once,
    writes its entries once, and projects each active slot's corner; the
    fused pass reads every worklist entry, and for the listed blocks their
    coordinates, their valid voxels' two channels and the depth under them
    once, writes the changed voxels, the active flag and the three
    per-entry outputs once, and projects every voxel of each listed block
    (43 operations, 4 for the bbox) and updates each valid voxel of a
    covered block (with the bilinear read's ~30 more); the fallback reads
    every entry's need flag, and the slot and n_valid of the need entries,
    and does the same as the fused pass for the blocks it fuses (their
    mode and active flag written, the skipped ones' active flag
    cleared)."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.kernels import integrate as ki
    geom, field, mu, dev = sc.geom, sc.field, sc.mu, sc.dev
    h, w = depth.shape
    t_cw, kmat = se3.inverse(pose), se3.camera_matrix(sc.kt)
    when = torch.ones((), dtype=torch.bool, device=dev)
    wl_args = (geom, m, t_cw, kmat, (w, h), sc.budget, when)
    wk = ki.integrate_worklist(*wl_args)
    wp = ki.integrate_worklist_plain(*wl_args)
    wl_mism = sum(int((a != b).sum()) for a, b in zip(wk, wp))
    wl = wk[0]
    blk = (wl, depth, t_cw, kmat, mu)
    mode_kw = (noise, bilinear)
    ma, mb = clone_map(m), clone_map(m)
    sk_k, sk_p = (torch.full((), 7, dtype=torch.int32, device=dev)
                  for _ in range(2))
    fk = ki.integrate_fused(geom, ma, field, *blk, ts, *mode_kw,
                            sk_k if bilinear else None)
    fp = ki.integrate_fused_plain(geom, mb, field, *blk, ts, *mode_kw,
                                  sk_p if bilinear else None)
    f_mism = sum(int((a != b).sum()) for a, b in zip(fk, fp))
    e_f, ok_f, msg_f = payload_errors(field, ma, mb)
    mode_f, fused = fk[0].clone(), clone_map(ma)
    if bilinear:
        sk, sp = sk_k, sk_p
        b_mism = int(sk != sp) + int(sk != 0)
        e_b, ok_b, msg_b = e_f, ok_f, "no fallback: the bilinear read"
    else:
        sk = ki.integrate_fallback(geom, ma, field, *blk, *fk, ts, noise)
        sp = ki.integrate_fallback_plain(geom, mb, field, *blk, *fp, ts,
                                         noise)
        b_mism = int(sk != sp) + int((fk[0] != fp[0]).sum())
        e_b, ok_b, msg_b = payload_errors(field, ma, mb)
    nb = int((wl < geom.capacity).sum())
    need = fk[2]
    fb = need & (fk[0] == 0)
    counts = dict(listed=nb, need=int(need.sum()), fallback=int(fb.sum()),
                  patch_skipped=int(sk))
    print(f"{tag}: worklist {nb} blocks of n_active {int(wk[1])} (budget "
          f"{sc.budget}), blocks_truncated {int(wk[2])}, {wl_mism} "
          f"mismatches (== 0); fused: {int((mode_f > 0).sum())} on a coarser "
          f"depth level, {counts['need']} uncovered, mode/n_valid/need "
          f"{f_mism} mismatches (== 0), {msg_f}; fallback: "
          f"{counts['fallback']} blocks fused at the exact pixel, "
          f"patch_skipped {int(sk)} vs {int(sp)}, mode/patch_skipped "
          f"{b_mism} mismatches (== 0), {msg_b}")
    require(wl_mism == 0 and f_mism == 0 and ok_f and b_mism == 0 and ok_b,
            f"{tag} disagrees with twin")

    n_blk = int(m.n_blocks)
    n_act = int(m.active[:n_blk].sum())
    nv_cov = int(fk[1][mode_f >= 0].sum())
    nv_fb = int(fk[1][fb].sum())
    upd = UPDATE_OPS[field.name] + (BILINEAR_OPS if bilinear else 0)
    rows = {
        "integrate_worklist": (
            dict(max_abs_err=float(wl_mism), **bound(
                n_blk + 12 * n_act + 4 * sc.budget + 12 + 2 * 64,
                n_act * PROJECT_OPS)),
            lambda: ki.integrate_worklist(*wl_args),
            lambda: ki.integrate_worklist_plain(*wl_args)),
        ki.fused_name(field, *mode_kw): (
            dict(max_abs_err=e_f, **bound(
                4 * sc.budget + 22 * nb + 8 * nv_cov + 8 * changed(fused, m)
                + 4 * min(nv_cov, w * h) + 2 * 64,
                nb * 512 * (PROJECT_OPS + 4) + nv_cov * upd)),
            lambda: ki.integrate_fused(geom, ma, field, *blk, ts, *mode_kw,
                                       sk_k if bilinear else None),
            lambda: ki.integrate_fused_plain(geom, mb, field, *blk, ts,
                                             *mode_kw,
                                             sk_p if bilinear else None)),
    }
    if not bilinear:
        rows[ki.fallback_name(field, noise)] = (
            dict(max_abs_err=max(e_b, float(b_mism)), **bound(
                sc.budget + 8 * counts["need"] + 17 * counts["fallback"]
                + (counts["need"] - counts["fallback"]) + 12 * nv_fb
                + 8 * changed(ma, fused) + 4 + 2 * 64,
                counts["fallback"] * 512 * PROJECT_OPS + nv_fb * upd)),
            lambda: ki.integrate_fallback(geom, ma, field, *blk, *fk, ts,
                                          noise),
            lambda: ki.integrate_fallback_plain(geom, mb, field, *blk, *fp,
                                                ts, noise))
    return rows, counts


def check_caps_and_fallback(torch, sc, m, pose, ts, tag):
    """K5 with its drop paths and K3 with its fallback, on the card: frame
    3 allocated with a budget of half its new blocks, and into a pool with
    room for half of them (both must drop blocks); then a close view of the
    sphere
    (0.15 m from its surface, the scene's intrinsics), allocated and fused,
    whose near blocks outgrow every depth level, so that the fallback fuses
    blocks at the exact pixel. Returns each checked kernel's largest
    error."""
    import numpy as np
    from supereight_tpu_torch.core.map import touched_buffer
    from supereight_tpu_torch.io import synthetic
    from supereight_tpu_torch.kernels import alloc
    from supereight_tpu_torch.kernels.frame import frame_mats_plain
    errs = {}
    n = int(m.n_blocks)
    kpose = frame_mats_plain(sc.kt, pose).kpose
    out = touched_buffer(sc.geom.blocks_per_side, sc.dev)
    touched = (alloc.touched_mask(sc.geom, sc.depths_t[3], pose, kpose,
                                  sc.mu, out)
               if sc.field.name == "tsdf" else alloc.touched_masks_of(
                   sc.geom, sc.depths_t[3], pose, kpose, sc.mu, out)[0])
    half = int((touched & (m.slot < 0)).sum()) // 2
    require(half > 0, f"{tag}: frame 3 has too few new blocks to cap")
    for kw, what in ((dict(budget=half), f"budget {half}"),
                     (dict(capacity=n + half), f"capacity {n + half}")):
        row, _, _, _, over = check_alloc(
            torch, sc, m, pose, sc.depths_t[3],
            f"K5 alloc_assign ({tag}, {what})", **kw)
        require(over > 0, f"K5 alloc_assign ({tag}, {what}): nothing dropped")
        errs["alloc_assign"] = max(errs.get("alloc_assign", 0.0),
                                   row["max_abs_err"])
    c = np.full(3, DIM / 2)
    r = 0.15 * DIM
    pose_c = synthetic.look_at(c + np.array([0.0, 0.05, -(r + 0.15)]), c)
    depth_c = synthetic.render_depth(
        pose_c, K, W, H, sphere_center=c, sphere_radius=r,
        box_min=(0.55,) * 3, box_max=(DIM - 0.55,) * 3)
    pose_c = torch.from_numpy(pose_c.astype(np.float32)).to(sc.dev)
    depth_c = torch.from_numpy(depth_c).to(sc.dev)
    row, _, _, mc, _ = check_alloc(torch, sc, m, pose_c, depth_c,
                                   f"K5 alloc_assign ({tag}, close view)")
    errs["alloc_assign"] = max(errs["alloc_assign"], row["max_abs_err"])
    for noise in (False, True) if sc.field.name == "tsdf" else (False,):
        rows, counts = check_block_pass(
            torch, sc, mc, pose_c, depth_c, ts,
            f"K3 ({tag}, close view{', noise' if noise else ''})", noise)
        require(counts["fallback"] > 0,
                f"K3 ({tag}, close view): the fallback fused no block")
        for k, v in rows.items():
            errs[k] = max(errs.get(k, 0.0), v[0]["max_abs_err"])
    return errs


def nav_bound(geom, field):
    """K2 nav_grid: the slot grid (and, for OFusion, every mip level's
    existence, value and time) read once and the nav grid written once;
    per cell the distance's bit tests and the slot pick, per column word
    the five dilation steps."""
    b = geom.blocks_per_side
    mips = (sum(9 * (b >> lvl) ** 3 for lvl in range(geom.num_levels))
            if field.name == "ofusion" else 0)
    return bound(8 * b ** 3 + mips, NAV_CELL_OPS * b ** 3
                 + NAV_WORD_OPS * b * b * ((b + 31) // 32))


NavState = collections.namedtuple(
    "NavState", "slot mip_alloc mip_x mip_y n_blocks")
NavState.__doc__ = """The map fields K2 reads, without the pool (a dense
random grid's pool would not fit)."""


def random_nav_map(torch, b, density, seed, device, single=None):
    """A random slot grid of side ``b``: each cell allocated with
    probability ``density`` (or only the cell ``single``), the slots a
    random permutation of 0..n-1; and random mip levels (half allocated,
    70 % with a value, log-odds -k/32 for k in -200..40000: positive,
    rounding halves and past the clip at -1000), all from numpy's
    generator seeded with ``seed``. Returns the geometry (capacity n, at
    least 1) and a :class:`NavState` on ``device``."""
    import numpy as np
    from supereight_tpu_torch.core.map import MapGeometry
    rng = np.random.RandomState(seed)
    if single is None:
        occ = rng.rand(b, b, b) < density
    else:
        occ = np.zeros((b, b, b), dtype=bool)
        occ[single] = True
    n = int(occ.sum())
    slot = np.full((b, b, b), -1, dtype=np.int32)
    slot[occ] = rng.permutation(n)
    geom = MapGeometry(size=8 * b, dim=1.0, capacity=max(n, 1))
    shapes = [(b >> lvl,) * 3 for lvl in range(geom.num_levels)]
    alloc = tuple(rng.rand(*s) < 0.5 for s in shapes)
    x = tuple((-rng.randint(-200, 40000, size=s) / 32).astype(np.float32)
              for s in shapes)
    y = tuple((rng.rand(*s) < 0.7).astype(np.float32) for s in shapes)

    def t(a):
        return torch.from_numpy(a).to(device)

    return geom, NavState(t(slot), tuple(map(t, alloc)), tuple(map(t, x)),
                          tuple(map(t, y)), torch.tensor(n, dtype=torch.int32,
                                                         device=device))


def nav_cases(torch, b, device):
    """K2's random sweep at side ``b``: a grid at each of NAV_DENSITIES,
    one with a single block (its cells at distances 0 to b - 1, 5 and 6
    among them for b >= 8) and an empty one."""
    cases = [random_nav_map(torch, b, dens, seed, device)
             for seed, dens in enumerate(NAV_DENSITIES)]
    cases.append(random_nav_map(torch, b, 0.0, 3, device,
                                single=(0, b // 2, b - 1)))
    cases.append(random_nav_map(torch, b, 0.0, 4, device))
    return cases


def raycast_bound(got, probes, extra_bytes=0):
    """K1 with the state's select: the depth frame, view, k, gate and pose
    read and the vertex, normal and hit maps, raycast pose and overflow
    written once; each nav entry and pool voxel (both channels) that this
    run's rays read (the twin's record: the start probe, the march probes
    and the hits' refinement), read once; per ray the direction, box clip
    (~55 operations) and prime, per probe ~25 and per hit the refinement
    and normal (~115)."""
    rays = got[2].numel()
    hits = int(got[2].sum())
    n_probes = int(probes.per_ray.sum()) + rays
    return bound(rays * (4 + 12 + 12 + 1) + 64 + 16 + 1 + 64 + 64 + 4
                 + 4 * int(probes.nav.sum()) + 8 * int(probes.pool.sum())
                 + extra_bytes,
                 rays * (55 + PRIME_OPS) + hits * 115
                 + RAY_PROBE_OPS * n_probes)


def probe_stats(torch, probes):
    """The march's probes from the twin's record (``kernels/raycast.py``
    ``Probes``): the mean, 99th percentile and largest count a ray, the
    total, the sum over the kernel's warps (8 x 4 pixel tiles) of each
    warp's largest count (the probes a warp in lockstep takes), and the
    distinct nav entries and pool voxels read."""
    p = probes.per_ray
    h, w = p.shape
    f = p.reshape(-1).to(torch.float64)
    return dict(
        mean=f.mean().item(), p99=torch.quantile(f, 0.99).item(),
        max=int(p.max()), total=int(p.sum()),
        warp_max=int(p.reshape(h // 4, 4, w // 8, 8).amax(dim=(1, 3)).sum()),
        warps=p.numel() // 32, nav=int(probes.nav.sum()),
        voxels=int(probes.pool.sum()))


def check_k1(torch, sc, state, depth, tag):
    """K1 against its twin on the map and pose of ``state``, primed in the
    kernel by ``depth``: the rays alone (:func:`check_raycast`'s
    tolerances); with a state's select gated on (the same, and the
    raycast pose exactly) and gated off (the given old maps and raycast
    pose exactly, ray_overflow 0); every overflow scratch zero after the
    launches. Prints the march's probes and reads (the twin's record).
    Returns the kernel's row and its rays."""
    from supereight_tpu_torch.kernels import frame, nav, raycast
    geom, field, m, mu = sc.geom, sc.field, state.map, sc.mu
    view = frame.frame_mats(sc.kt, state.pose).kpose
    nv = nav.nav_grid(geom, m, field, bucket=sc.budget)

    def call(prev=None):
        return raycast.raycast_rays(geom, m, field, nv, view, depth, sc.kt,
                                    mu, (W, H), prev=prev)

    def plain(prev=None):
        return raycast.raycast_plain(geom, field, m.data_x, m.data_y, nv,
                                     view, depth, sc.kt, mu, (W, H),
                                     prev=prev)

    got = call()
    ref, probes = raycast.raycast_plain(geom, field, m.data_x, m.data_y, nv,
                                        view, depth, sc.kt, mu, (W, H),
                                        with_probes=True)
    v_err = check_raycast(torch, tag, got, ref)
    # an old state unlike the new one, so that the select shows
    old = (ref.vertex + 1.0, -ref.normal, ~ref.valid)

    def prev(on):
        return raycast.Previous(torch.full((), on, device=sc.dev),
                                state.pose, state.raycast_pose + 1.0, *old)

    on, off = call(prev(True)), call(prev(False))
    check_raycast(torch, tag + " (select on)", on, ref)
    sel_ok = (torch.equal(on.raycast_pose, state.pose)
              and all(torch.equal(a, b) for a, b in zip(off[:3], old))
              and int(off.overflow) == 0
              and torch.equal(off.raycast_pose, state.raycast_pose + 1.0))
    print(f"{tag}: select on/off against the twin's where: raycast pose, "
          f"kept maps and a zero overflow exactly: {sel_ok}")
    require(sel_ok, f"{tag}: the state's select disagrees with the twin")
    st = probe_stats(torch, probes)
    print(f"{tag}: march probes a ray (twin): mean {st['mean']:.3f}, p99 "
          f"{st['p99']:.0f}, max {st['max']}, {st['total']} in all; sum "
          f"over the {st['warps']} warps (8x4 pixel tiles) of each warp's "
          f"largest count {st['warp_max']}; distinct reads: {st['nav']} nav "
          f"entries, {st['voxels']} pool voxels")
    gate_on = prev(True)
    row = dict(max_abs_err=v_err, probes=st,
               device_us=device_us(torch, lambda: call(gate_on), 20, 1),
               ms=cuda_ms(torch, lambda: call(gate_on), 20),
               plain_ms=cuda_ms(torch, lambda: plain(gate_on), 2),
               **raycast_bound(got, probes))
    torch.cuda.synchronize()
    dirty = [k for k, v in raycast._SCRATCH.items() if bool(v.any())]
    print(f"{tag}: device {row['device_us']:.2f} us/launch; bound "
          f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}); overflow "
          f"scratches left nonzero: {len(dirty)} of {len(raycast._SCRATCH)}")
    require(not dirty, f"{tag}: a launch left its overflow scratch nonzero")
    return row, got


def moved_pose(pose, shift):
    """``pose`` moved ``shift`` m along its optical axis (forward > 0)."""
    p = pose.clone()
    p[:3, 3] += shift * p[:3, 2]
    return p


def blocked_starts(geom, view, probes, far):
    """The rays of ``view`` whose range [near, far] in the map is not
    empty and that took no march probe (the twin's ``Probes``): those
    that start behind a surface (the unprimed start's test)."""
    from supereight_tpu_torch.constants import NEAR_PLANE
    from supereight_tpu_torch.kernels import raycast
    h, w = probes.per_ray.shape
    dx, dy, dz = raycast.ray_directions_c(view, w, h)
    tnear, tfar = raycast.ray_box_range_c(
        (view[0, 3], view[1, 3], view[2, 3]), dx, dy, dz, geom.dim,
        NEAR_PLANE, far)
    return (tnear < tfar).reshape(h, w) & (probes.per_ray == 0)


def raycast_cold_bound(got, probes):
    """K1's unprimed launch: the view read and the vertex, normal and hit
    maps and the overflow written once; each nav entry and pool voxel
    that this run's rays read (the twin's record), read once; per ray the
    direction and box clip (~55 operations), per probe (the start's
    included) ~25 and per hit the refinement and normal (~115)."""
    rays = got[2].numel()
    hits = int(got[2].sum())
    n_probes = int(probes.per_ray.sum()) + rays
    return bound(rays * (12 + 12 + 1) + 64 + 4 + 4 * int(probes.nav.sum())
                 + 8 * int(probes.pool.sum()),
                 rays * 55 + hits * 115 + RAY_PROBE_OPS * n_probes)


def check_k1_cold(torch, sc, state, tag):
    """K1's unprimed launch against its twin on the map of ``state``,
    marched to twice the far plane through the nav grid of every block
    (a fresh view's render): from the state's pose moved BACK_VIEW back
    along its optical axis (timed; its probes, reads and bound), and from
    a view moved forward until its centre ray starts BEHIND behind the
    surface that frame 2 saw there, where some rays start behind a
    surface and must miss (none marches, none hits). check_raycast's
    tolerances on both. Returns the kernel's row."""
    from supereight_tpu_torch.constants import FAR_PLANE, NEAR_PLANE
    from supereight_tpu_torch.kernels import frame, nav, raycast
    geom, field, m, mu = sc.geom, sc.field, state.map, sc.mu
    far = 2.0 * FAR_PLANE
    nv = nav.nav_grid(geom, m, field)

    def call(view):
        return raycast.raycast_rays(geom, m, field, nv, view, None, None, mu,
                                    (W, H), far=far)

    def plain(view, with_probes=False):
        return raycast.raycast_plain(geom, field, m.data_x, m.data_y, nv,
                                     view, None, None, mu, (W, H),
                                     with_probes=with_probes, far=far)

    centre = float(sc.depths[2][H // 2, W // 2])
    views = {"back": moved_pose(state.pose, -BACK_VIEW),
             "forward": moved_pose(state.pose, centre - NEAR_PLANE + BEHIND)}
    errs, blocked = [], {}
    for name, pose in views.items():
        view = frame.frame_mats(sc.kt, pose).kpose
        got = call(view)
        ref, probes = plain(view, True)
        errs.append(check_raycast(torch, f"{tag} ({name} view)", got, ref))
        b = blocked_starts(geom, view, probes, far)
        blocked[name] = (int(b.sum()), int((got.valid & b).sum()))
        if name == "back":
            st = probe_stats(torch, probes)
            row = dict(probes=st,
                       device_us=device_us(torch, lambda: call(view), 20, 1),
                       ms=cuda_ms(torch, lambda: call(view), 20),
                       plain_ms=cuda_ms(torch, lambda: plain(view), 2),
                       **raycast_cold_bound(got, probes))
            print(f"{tag}: march probes a ray (twin): mean {st['mean']:.3f}, "
                  f"p99 {st['p99']:.0f}, max {st['max']}, {st['total']} in "
                  f"all; sum over the {st['warps']} warps of each warp's "
                  f"largest count {st['warp_max']}; distinct reads: "
                  f"{st['nav']} nav entries, {st['voxels']} pool voxels; "
                  f"{int(got.valid.sum())} hits; device "
                  f"{row['device_us']:.2f} us/launch, call {row['ms']:.4f} "
                  f"ms, twin {row['plain_ms']:.4f} ms; bound "
                  f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
    print(f"{tag}: rays that start behind a surface (a range in the map, no "
          f"march probe), and of them hits: {blocked} (forward: > 0 and no "
          f"hit)")
    require(blocked["forward"][0] > 0 and blocked["forward"][1] == 0
            and blocked["back"][1] == 0,
            f"{tag}: no ray started behind a surface, or one hit")
    row["max_abs_err"] = max(errs)
    return row


def check_mm2meters(torch, dev):
    """ops/preprocess.mm2meters on the card against numpy's
    ``u16.astype(f32) / f32(1000)`` for all 65,536 u16 values, bit for
    bit; prints how many a product with the reciprocal would change."""
    import numpy as np
    from supereight_tpu_torch.ops.preprocess import mm2meters
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    want = v.astype(np.float32) / np.float32(1000)
    got = mm2meters(v, (256, 256), dev).cpu().numpy()
    bad = int((got.view(np.uint32) != want.view(np.uint32)).sum())
    recip = (torch.from_numpy(v.astype(np.float32)).to(dev) / 1000.0) \
        .cpu().numpy()
    n_recip = int((recip.view(np.uint32) != want.view(np.uint32)).sum())
    print(f"mm2meters: all 65536 u16 values on the card against numpy, "
          f"unequal bits: {bad} (== 0); a CUDA tensor divided by the "
          f"Python scalar 1000.0 changes {n_recip}")
    require(bad == 0, "mm2meters differs from numpy on the card")


def check_frame_mats(torch, sc, state, tag):
    """The pose prologue against its twin, bit for bit, on ``state``'s
    poses: tracking's view of its raycast pose, and the frame's select of
    a candidate 1 cm away from its pose, tracked (frame 3), untracked
    (frame 4) and skipped by a tracking rate of 2 (frame 5 as a device
    tensor, integration rate 3). Returns the kernel's row (the bound of
    FRAME_MATS_BYTES and FRAME_MATS_OPS; the tracked case timed)."""
    from supereight_tpu_torch.kernels.frame import frame_mats, \
        frame_mats_plain
    moved = state.pose.clone()
    moved[:3, 3] += 0.01
    yes = torch.ones((), dtype=torch.bool, device=sc.dev)
    five = torch.full((), 5, dtype=torch.int32, device=sc.dev)
    cases = [(sc.kt, state.raycast_pose),
             (sc.kt, moved, state.pose, yes, 3, 1, 1),
             (sc.kt, moved, state.pose, ~yes, 4, 1, 1),
             (sc.kt, moved, state.pose, yes, five, 2, 3)]
    n_bad = sum(not torch.equal(a, b) for args in cases
                for a, b in zip(frame_mats(*args), frame_mats_plain(*args)))
    print(f"{tag}: {len(cases)} cases, outputs unequal to the twin: {n_bad} "
          f"(== 0, bit for bit)")
    require(n_bad == 0, f"{tag} disagrees with twin")
    args = cases[1]
    return dict(max_abs_err=float(n_bad),
                ms=cuda_ms(torch, lambda: frame_mats(*args), 50),
                plain_ms=cuda_ms(torch, lambda: frame_mats_plain(*args), 10),
                **bound(FRAME_MATS_BYTES, FRAME_MATS_OPS))


def check_raycast(torch, tag, got, ref):
    both = got[2] & ref[2]
    agree = (got[2] == ref[2]).float().mean().item()
    v_err = (got[0] - ref[0]).abs().amax(-1)[both].max().item()
    n_err = (got[1] - ref[1]).abs().amax(-1)[both].max().item()
    print(f"{tag}: hit mask agrees on {agree:.6f} of rays (>= 0.999), "
          f"{int(both.sum())} hits, vertex max err {v_err:.3e} m (<= 1e-4), "
          f"normal max err {n_err:.3e} (<= 1e-3), overflow "
          f"{int(got[3])} vs {int(ref[3])}")
    require(agree >= 0.999 and v_err <= 1e-4 and n_err <= 1e-3
            and int(got[3]) == int(ref[3]), f"{tag} disagrees with twin")
    return v_err


def check_nav(torch, sc, m, tag):
    """K2 against its twin, bit for bit, on ``m`` at the bench bucket and
    on :func:`nav_cases` at every side of NAV_SIDES with the full pool and
    a bucket of half the blocks (the block count and bucket clamp too).
    Returns the kernel's row (bound and times on ``m``)."""
    from supereight_tpu_torch.kernels import nav
    got = nav.nav_grid(sc.geom, m, sc.field, bucket=sc.budget)
    ref = nav.nav_grid_plain(sc.geom, m, sc.field, bucket=sc.budget)
    mism = int((got != ref).sum())
    n_grids = sweep_bad = 0
    for b in NAV_SIDES:
        for geom, rm in nav_cases(torch, b, sc.dev):
            n = int(rm.n_blocks)
            for bucket in (None, n // 2):
                g = nav.nav_grid(geom, rm, sc.field, bucket, True)
                r = nav.nav_grid_plain(geom, rm, sc.field, bucket, True)
                sweep_bad += sum(int((a != c).sum()) for a, c in zip(g, r))
                n_grids += 1
    print(f"{tag}: random sweep, sides {list(NAV_SIDES)}, occupancy "
          f"{list(NAV_DENSITIES)}, one block and none, full pool and half "
          f"bucket: {n_grids} grids, {sweep_bad} mismatches (== 0)")
    row = dict(
        max_abs_err=float(mism + sweep_bad),
        ms=cuda_ms(torch, lambda: nav.nav_grid(sc.geom, m, sc.field,
                                               bucket=sc.budget), 50),
        plain_ms=cuda_ms(torch, lambda: nav.nav_grid_plain(
            sc.geom, m, sc.field, bucket=sc.budget), 10),
        **nav_bound(sc.geom, sc.field))
    print(f"{tag}: {int((ref >= 0).sum())} block cells, "
          f"{int(((-ref - 1) >= 8).sum())} known-free coarse cells, "
          f"{mism} mismatches (== 0); call {row['ms']:.4f} ms, twin "
          f"{row['plain_ms']:.4f} ms")
    require(mism == 0 and sweep_bad == 0, f"{tag} disagrees with twin")
    return row


def check_rank(torch, sc, m, tag):
    """K4's rank kernel against ``_parent_present`` on ``m``: the gate grid
    and mip_skipped exactly, at the bench budget and at a budget of half
    the occupied parents (mip_skipped > 0), and mip_skipped 0 under a
    false ``when``. Returns the kernel's row (bound: mip_alloc[0] read
    once, the gate grid and mip_skipped written once, one OR a child) and
    its and its twin's calls."""
    from supereight_tpu_torch.kernels import node
    geom = sc.geom
    b = geom.blocks_per_side
    true = torch.ones((), dtype=torch.bool, device=sc.dev)
    occupied = int(node._parent_present(geom, m, b ** 3)[0].sum())
    cut = max(occupied // 2, 1)
    mism, skips = 0, []
    for budget, when in ((sc.budget, true), (cut, true), (sc.budget, ~true)):
        got = node.node_rank(geom, m, budget, when)
        want = node._parent_present(geom, m, budget)
        skip = int(want[1]) if bool(when) else 0
        mism += int((got[0] != want[0]).sum()) + abs(int(got[1]) - skip)
        skips.append(int(got[1]))
    print(f"{tag}: {occupied} occupied parents; gate grid and mip_skipped "
          f"at budgets {sc.budget} and {cut} and under when False: {mism} "
          f"mismatches (== 0), mip_skipped {skips}")
    require(mism == 0 and skips[1] > 0,
            f"{tag} disagrees with _parent_present")
    hp = b // 2
    row = dict(max_abs_err=float(mism),
               **bound(b ** 3 + hp ** 3 + 4 + 1, b ** 3))
    return (row, lambda: node.node_rank(geom, m, sc.budget, true),
            lambda: node.node_rank_plain(geom, m, sc.budget, true))


def check_node_pass(torch, sc, m, pose, depth, ts, tag):
    """K4 node_pass against its twin on two copies of ``m``, fusing
    ``depth`` at ``pose`` stamped ``ts``: TSDF mip x and y to 1e-5;
    OFusion log-odds to 1e-4 + 1e-5 |x| and time stamps exactly (K3's
    tolerances); mip_skipped exactly; and its rank kernel
    (:func:`check_rank`). Returns, for ``node_pass`` (error and bound: the
    gates read once, and per written value its depth read and x and y
    read and written; per gated cell the projection and per written value
    the update) and ``node_rank``, the row and the kernel's and the twin's
    calls for timing."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.kernels import node
    geom, field = sc.geom, sc.field
    t_cw, kmat = se3.inverse(pose), se3.camera_matrix(sc.kt)
    when = torch.ones((), dtype=torch.bool, device=sc.dev)
    ma, mb = clone_map(m), clone_map(m)

    def args(mm):
        return (geom, mm, field, depth, t_cw, kmat, sc.mu, sc.budget, ts,
                when)

    sk = int(node.node_pass(*args(ma)))
    sp = int(node.node_pass_plain(*args(mb)))
    ex = max((a - b).abs().max().item() for a, b in zip(ma.mip_x, mb.mip_x))
    ey = max((a - b).abs().max().item() for a, b in zip(ma.mip_y, mb.mip_y))
    if field.name == "ofusion":
        bad = sum(int(((a - b).abs() > 1e-4 + 1e-5 * b.abs()).sum())
                  for a, b in zip(ma.mip_x, mb.mip_x))
        ok = bad == 0 and ey == 0
        tol = f"{bad} beyond 1e-4 + 1e-5 |x| (== 0), mip_y max err {ey} " \
              f"(== 0)"
    else:
        ok = ex <= 1e-5 and ey <= 1e-5
        tol = f"(<= 1e-5), mip_y max err {ey:.3e} (<= 1e-5)"
    present, _ = node._parent_present(geom, m, sc.budget)
    gated = (int(present.sum()) * 8 if present is not None
             else int(m.mip_alloc[0].sum()))
    gated += sum(int(a.sum()) for a in m.mip_alloc[1:])
    gate_bytes = (present.numel() if present is not None
                  else m.mip_alloc[0].numel())
    gate_bytes += sum(a.numel() for a in m.mip_alloc[1:])
    written = sum(int(((a != b) | (c != d)).sum()) for a, b, c, d in zip(
        ma.mip_x, m.mip_x, ma.mip_y, m.mip_y))
    print(f"{tag}: {gated} gated coarse cells, {written} values written, "
          f"mip_x max err {ex:.3e} {tol}, mip_skipped {sk} vs {sp} (==)")
    require(ok and sk == sp, f"{tag} disagrees with twin")
    row = dict(max_abs_err=ex, **bound(
        gate_bytes + written * 20 + 2 * 64 + 4 + 1,
        gated * PROJECT_OPS + written * UPDATE_OPS[field.name]))
    return {"node_pass": (row, lambda: node.node_pass(*args(ma)),
                          lambda: node.node_pass_plain(*args(mb))),
            "node_rank": check_rank(torch, sc, m, tag.replace("node_pass",
                                                              "node_rank"))}


def pyramid_bound(depth, levels):
    """K7 pyramid: the level-0 depth and k read once, every level's
    vertex, normal and valid and every coarser level's depth written once;
    per pixel of a coarser level the robust mean, per pixel of every level
    the vertex and normal."""
    h, w = depth.shape
    px = [h * w]
    for _ in range(1, levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        px.append(h * w)
    return bound(4 * px[0] + 16 + 4 * sum(px[1:]) + ICP_PIXEL_BYTES * sum(px),
                 HALF_SAMPLE_OPS * sum(px[1:]) + VERTEX_NORMAL_OPS * sum(px))


def pyramid_errors(torch, depth, k, levels, neg_y):
    """K7 against its composed twins: (depths, vertices and valid masks
    bit-equal, the largest error of any output)."""
    from supereight_tpu_torch.kernels import preprocess as pre
    got = pre.pyramid(depth, k, levels, neg_y)
    want = pre.pyramid_plain(depth, k, levels, neg_y)
    exact = all(torch.equal(a, b) for i in (0, 1, 3)
                for a, b in zip(got[i], want[i]))
    err = max((a.float() - b.float()).abs().max().item()
              for i in range(4) for a, b in zip(got[i], want[i]))
    return exact, err


def check_pyramid(torch, depth, tag):
    """K7 against its twins on ``depth`` at every level count from 1 to
    MAX_ICP_LEVELS, and on its odd crop (h - 1, w - 1), both neg_y:
    depths, vertices and valid masks bit-equal, normals to 1e-6. Returns
    the kernel's row (error; bound of the path's pyramid, len(ITERATIONS)
    levels of ``depth``) and its and its twin's calls for timing."""
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.kernels import preprocess as pre
    k = torch.tensor(K, dtype=torch.float32, device=depth.device)
    h, w = depth.shape
    exact, err, n_cases = True, 0.0, 0
    for d in (depth, depth[:h - 1, :w - 1].contiguous()):
        for levels in range(1, _lib.MAX_ICP_LEVELS + 1):
            for neg_y in (False, True):
                ok, e = pyramid_errors(torch, d, k, levels, neg_y)
                exact &= ok
                err = max(err, e)
                n_cases += 1
    print(f"{tag}: {w}x{h} and {w - 1}x{h - 1}, 1 to "
          f"{_lib.MAX_ICP_LEVELS} levels, both neg_y ({n_cases} cases): "
          f"depths, vertices and masks bit-equal: {exact}; normals max err "
          f"{err:.3e} (<= 1e-6)")
    require(exact and err <= 1e-6, f"{tag} disagrees with twin")
    n_lv = len(ITERATIONS)
    row = dict(max_abs_err=err, **pyramid_bound(depth, n_lv))
    return (row, lambda: pre.pyramid(depth, k, n_lv, False),
            lambda: pre.pyramid_plain(depth, k, n_lv, False))


def noisy_depth(torch, sc, i, seed):
    """Frame i of the scene with range noise (sigma 0.002 z^2, numpy's
    generator seeded with ``seed``) and a tenth of its pixels 0, on the
    card."""
    import numpy as np
    from supereight_tpu_torch.io import synthetic
    d = synthetic.add_depth_noise(sc.depths[i], NOISE_FACTOR, seed=seed)
    d[np.random.RandomState(seed).rand(*d.shape) < 0.1] = 0.0
    return torch.from_numpy(d).to(sc.dev)


def check_filters(torch, depth, tag):
    """K7's input filters against their twins on ``depth``: the median
    (one pass and two) bit for bit, the bilateral to 1e-5 m (CUDA's expf
    against torch's exp, whose argument the twin on the card divides by
    multiplying with a reciprocal: ulps). Returns their rows, each bound
    by the depth read once and the filtered depth written once, or by its
    operations (the bilateral's 25 taps a pixel)."""
    from supereight_tpu_torch.kernels import preprocess as pre
    h, w = depth.shape
    rows = {}
    for name, call, plain, tol, ops in (
            ("bilateral", lambda: pre.bilateral_filter(depth),
             lambda: pre.bilateral_filter_plain(depth), 1e-5,
             25 * BILATERAL_TAP_OPS + 2),
            ("median", lambda: pre.median_filter3(depth),
             lambda: pre.median_filter3_plain(depth), 0.0, MEDIAN_PIXEL_OPS),
            ("median2", lambda: pre.median_filter3(depth, 2),
             lambda: pre.median_filter3_plain(depth, 2), 0.0,
             2 * MEDIAN_PIXEL_OPS)):
        got, want = call(), plain()
        err = (got - want).abs().max().item()
        changed = int((want != depth).sum())
        print(f"{tag} {name}: {w}x{h}, {int((depth == 0).sum())} zero "
              f"pixels, {changed} pixels changed by the filter; max err "
              f"against the twin {err:.3e} (<= {tol:g}), bit-equal "
              f"{bool(torch.equal(got, want))}")
        require(err <= tol and changed > 0, f"{tag} {name} disagrees with "
                f"twin")
        rows[name] = dict(max_abs_err=err,
                          device_us=device_us(torch, call, 20, 1),
                          ms=cuda_ms(torch, call, KERNEL_REPS),
                          plain_ms=cuda_ms(torch, plain, TWIN_REPS),
                          **bound(8 * h * w, ops * h * w))
        print(f"{tag} {name}: device {rows[name]['device_us']:.2f} "
              f"us/launch, call {rows[name]['ms']:.4f} ms, twin "
              f"{rows[name]['plain_ms']:.4f} ms; bound "
              f"{rows[name]['bound_ms'] * 1e3:.3f} us "
              f"({rows[name]['bound_by']})")
    return rows


def check_gate(torch, sc, n_frames, weight, depth_i, tag, timed=False):
    """K1's TSDF maturity gate at ``weight`` against its twin on the map of
    frames 0 to n_frames - 1, primed by frame depth_i at the state's pose:
    :func:`check_raycast`'s tolerances, and against the ungated kernel the
    vertex and normal maps bit for bit, the valid mask a subset; prints
    the hits it drops. Returns the kernel's row: its error and, when
    ``timed`` (where the gate must drop some hits and keep others), its
    times and bound (K1's, plus each hit's slot entry and weight)."""
    from supereight_tpu_torch.kernels import frame, nav, raycast
    state = sc.run_frames(n_frames)
    geom, field, m, mu = sc.geom, sc.field, state.map, sc.mu
    view = frame.frame_mats(sc.kt, state.pose).kpose
    nv = nav.nav_grid(geom, m, field, bucket=sc.budget)
    depth = sc.depths_t[depth_i]
    prev = raycast.Previous(torch.ones((), dtype=torch.bool, device=sc.dev),
                            state.pose, state.raycast_pose, state.vertex,
                            state.normal, state.valid)

    def call(gate=weight):
        return raycast.raycast_rays(geom, m, field, nv, view, depth, sc.kt,
                                    mu, (W, H), prev=prev,
                                    min_ref_weight=gate)

    def plain():
        return raycast.raycast_plain(geom, field, m.data_x, m.data_y, nv,
                                     view, depth, sc.kt, mu, (W, H),
                                     prev=prev, slot=m.slot,
                                     min_ref_weight=weight)

    got, ungated = call(), call(0)
    err = check_raycast(torch, tag, got, plain())
    same = (torch.equal(got.vertex, ungated.vertex)
            and torch.equal(got.normal, ungated.normal)
            and not bool((got.valid & ~ungated.valid).any()))
    hits, kept = int(ungated.valid.sum()), int(got.valid.sum())
    print(f"{tag}: weight >= {weight} keeps {kept} of {hits} hits; vertex "
          f"and normal maps bit-equal to the ungated launch's, valid a "
          f"subset: {same}")
    require(same, f"{tag}: the gate changed more than the valid mask")
    if not timed:
        return dict(max_abs_err=err)
    require(0 < kept < hits, f"{tag}: the gate drops no hit or every hit")
    _, probes = raycast.raycast_plain(geom, field, m.data_x, m.data_y, nv,
                                      view, depth, sc.kt, mu, (W, H),
                                      with_probes=True)
    row = dict(max_abs_err=err, device_us=device_us(torch, call, 20, 1),
               ungated_device_us=device_us(torch, lambda: call(0), 20, 1),
               ms=cuda_ms(torch, call, 20), plain_ms=cuda_ms(torch, plain, 2),
               **raycast_bound(got, probes, GATE_HIT_BYTES * hits))
    print(f"{tag}: device {row['device_us']:.2f} us/launch, the same launch "
          f"ungated {row['ungated_device_us']:.2f}; call {row['ms']:.4f} ms, "
          f"twin {row['plain_ms']:.4f} ms; bound "
          f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
    return row


def option_rows(torch, sc, m, pose, depth, ts, tag):
    """K3's noise-grade modes on the map the allocator made for ``depth``
    (:func:`check_block_pass`): TSDF the noise weight, the bilinear read
    and both; OFusion the bilinear read; each timed with its twin."""
    _, _, _, m_alloc, _ = check_alloc(torch, sc, m, pose, depth,
                                      f"K5 alloc_assign ({tag}, modes)")
    modes = (((True, False), (False, True), (True, True))
             if sc.field.name == "tsdf" else ((False, True),))
    rows = {}
    for noise, bilinear in modes:
        checked, _ = check_block_pass(
            torch, sc, m_alloc, pose, depth, ts,
            f"K3 ({tag}, {'noise' if noise else ''}"
            f"{'+' if noise and bilinear else ''}"
            f"{'bilinear' if bilinear else ''})", noise, bilinear)
        for name, (row, call, plain) in checked.items():
            if name == "integrate_worklist":
                continue
            rows[name] = dict(row, ms=cuda_ms(torch, call, KERNEL_REPS),
                              plain_ms=cuda_ms(torch, plain, TWIN_REPS),
                              device_us=device_us(torch, call, 20, 1))
            print(f"{name} ({tag}): device {rows[name]['device_us']:.2f} "
                  f"us/launch, call {rows[name]['ms']:.4f} ms, twin "
                  f"{rows[name]['plain_ms']:.4f} ms; bound "
                  f"{rows[name]['bound_ms'] * 1e3:.3f} us "
                  f"({rows[name]['bound_by']})")
    return rows


def new_kernel_rows(torch, sc, m, pose, depth, ts, tag):
    """K5's allocator, then K3's three launches on the map it made
    (:func:`check_alloc`, :func:`check_block_pass`), K4 and K7 against
    their twins (:func:`check_node_pass`, :func:`check_pyramid`), each
    with its call and its twin's timed: the kernel over 50 back-to-back
    calls, the twin over 5."""
    row, call, plain, m_alloc, _ = check_alloc(
        torch, sc, m, pose, depth, f"K5 alloc_assign ({tag})")
    checked = {"alloc_assign": (row, call, plain)}
    checked.update(check_block_pass(torch, sc, m_alloc, pose, depth, ts,
                                    f"K3 ({tag})")[0])
    checked.update(check_node_pass(torch, sc, m, pose, depth, ts,
                                   f"K4 node_pass ({tag})"))
    checked["pyramid"] = check_pyramid(torch, depth, f"K7 pyramid ({tag})")
    rows = {}
    for name, (row, call, plain) in checked.items():
        rows[name] = dict(row, ms=cuda_ms(torch, call, KERNEL_REPS),
                          plain_ms=cuda_ms(torch, plain, TWIN_REPS))
        print(f"{name} ({tag}): call {rows[name]['ms']:.4f} ms, twin "
              f"{rows[name]['plain_ms']:.4f} ms; bound "
              f"{rows[name]['bound_ms'] * 1e3:.3f} us "
              f"({rows[name]['bound_by']})")
    return rows


def merge_errs(rows, errs):
    """Raise each named row's max_abs_err to the error of a further
    check."""
    for k, e in errs.items():
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], e)


def kernel_phase_tsdf(torch, sc):
    """Each TSDF-path kernel against its twin on a map built by three port
    frames."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.core.map import touched_buffer
    from supereight_tpu_torch.kernels import alloc, icp
    from supereight_tpu_torch.pipeline import preprocess_and_pyramid

    geom, mu, kt = sc.geom, sc.mu, sc.kt
    state = sc.run_frames(3)
    m = state.map
    pose = state.pose
    d2, d3 = sc.depths_t[2], sc.depths_t[3]
    rows = {}

    # the pose prologue; K2 + K1: the primed raycast of frame 2 (its output
    # feeds K6 below)
    rows["frame_mats"] = check_frame_mats(torch, sc, state,
                                          "frame_mats (TSDF, frame 3)")
    rows["nav_grid"] = check_nav(torch, sc, m, "K2 nav_grid (TSDF)")
    rows["raycast"], got = check_k1(torch, sc, state, d2, "K1 raycast")
    rows["raycast_cold"] = check_k1_cold(torch, sc, state,
                                         "K1 raycast_cold (TSDF)")
    ref_vertex, ref_normal, ref_valid = got[0], got[1], got[2]

    # K6: frame 3's finest pyramid level against that raycast
    _, verts, norms, valids = preprocess_and_pyramid(d3, kt, 3, False, False)
    kview = se3.matmul4(se3.camera_matrix(kt), se3.inverse(pose))
    args = (verts[0], norms[0], valids[0], ref_vertex, ref_normal, ref_valid,
            pose, kview)
    res_k, red_k = icp.icp_reduce(*args)
    res_p, red_p = icp.icp_reduce_plain(*args)
    code_agree = (res_k == res_p).float().mean().item()
    red_err = ((red_k - red_p).abs()
               / (red_p.abs() + 1e-4 * red_p.abs().max())).max().item()
    print(f"K6 icp_reduce: result codes agree on {code_agree:.6f} of pixels "
          f"(>= 0.999), 32-vector max rel err {red_err:.3e} (<= 1e-4), "
          f"inliers {red_p[28].item():.0f}")
    require(code_agree >= 0.999 and red_err <= 1e-4,
            "K6 icp_reduce disagrees with twin")
    rows["icp_reduce"] = dict(
        max_abs_err=(red_k - red_p).abs().max().item(),
        ms=cuda_ms(torch, lambda: icp.icp_reduce(*args), 50),
        plain_ms=cuda_ms(torch, lambda: icp.icp_reduce_plain(*args), 10),
        **bound((2 * H * W) * ICP_PIXEL_BYTES + H * W * 4 + 2 * 64 + 32 * 4,
                H * W * ICP_PIXEL_OPS))

    # K6: the whole tracking step of frame 3 against that raycast
    rows["icp_track"] = check_icp_track(
        torch, "K6 icp_track (TSDF, frame 3)",
        (pose, kview, verts, norms, valids, ref_vertex, ref_normal,
         ref_valid))

    # K5: the band march of frame 3 at the frame-2 pose, and of a random
    # depth from there and from outside the map, into fresh grids; timed as
    # the path calls it, into a touched buffer
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(kt))
    mism = check_marches(torch, geom, sc.field, mu, kt,
                         [("frame 3", d3, pose)]
                         + march_cases(torch, geom, d3, pose, 3),
                         "K5 alloc_touch")
    require(mism == 0, "K5 alloc_touch disagrees with twin")
    buf = touched_buffer(geom.blocks_per_side, sc.dev)
    rows["alloc_touch"] = dict(
        max_abs_err=float(mism),
        ms=cuda_ms(torch, lambda: alloc.touched_mask(geom, d3, pose, kpose,
                                                     mu, out=buf), 50),
        plain_ms=cuda_ms(torch, lambda: alloc.touched_mask_plain(
            geom, d3, pose, kpose, mu), 10),
        **alloc_bound(torch, geom, d3, pose, kpose, mu))

    # K5's allocator, K3, K4 and K7: frame 3 at the frame-2 pose; then
    # K5's drop paths and K3's fallback
    ts = torch.full((), 3.0, dtype=torch.float32, device=sc.dev) * (1 / 30)
    rows.update(new_kernel_rows(torch, sc, m, pose, d3, ts, "TSDF, frame 3"))

    # the noise-grade options: K7's filters on frame 3 with range noise and
    # holes; K3's modes; K1's maturity gate at W = 4 on the map of frames
    # 0-5 (a three-frame map weighs at most 3) and at W = 2 on frame 3's
    rows.update(check_filters(torch, noisy_depth(torch, sc, 3, 3),
                              "K7 (frame 3, noisy)"))
    rows.update(option_rows(torch, sc, m, pose, d3, ts, "TSDF, frame 3"))
    rows["raycast_gated"] = check_gate(torch, sc, 6, 4, 5,
                                       "K1 raycast_gated (frames 0-5, W 4)",
                                       timed=True)
    merge_errs(rows, {"raycast_gated": check_gate(
        torch, sc, 3, 2, 2,
        "K1 raycast_gated (frames 0-2, W 2)")["max_abs_err"]})
    merge_errs(rows, check_caps_and_fallback(torch, sc, m, pose, ts,
                                             "TSDF, frame 3"))
    return rows


def kernel_phase_of(torch, sc):
    """Each OFusion-path kernel against its twin on a map built by three
    OFusion port frames."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.core.map import touched_buffer
    from supereight_tpu_torch.kernels import alloc
    from supereight_tpu_torch.pipeline import preprocess_and_pyramid

    geom, mu, kt = sc.geom, sc.mu, sc.kt
    state = sc.run_frames(3)
    m = state.map
    pose = state.pose
    d2, d3 = sc.depths_t[2], sc.depths_t[3]
    rows = {}

    # K5-OF: the multi-scale march of frame 3 at the frame-2 pose, and of
    # a random depth from there and from outside the map, into fresh grids;
    # timed as the path calls it, into a touched buffer
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(kt))
    mism = check_marches(torch, geom, sc.field, mu, kt,
                         [("frame 3", d3, pose)]
                         + march_cases(torch, geom, d3, pose, 3),
                         "K5-OF alloc_touch_of")
    require(mism == 0, "K5-OF alloc_touch_of disagrees with twin")
    buf = touched_buffer(geom.blocks_per_side, sc.dev)
    rows["alloc_touch_of"] = dict(
        max_abs_err=float(mism),
        ms=cuda_ms(torch, lambda: alloc.touched_masks_of(
            geom, d3, pose, kpose, mu, out=buf), 50),
        plain_ms=cuda_ms(torch, lambda: alloc.touched_masks_of_plain(
            geom, d3, pose, kpose, mu), 10),
        **alloc_of_bound(torch, geom, d3, pose, kpose, mu))

    # the pose prologue; K2 (OFusion payload) + K1-OF: the primed raycast
    # of frame 2
    rows["frame_mats"] = check_frame_mats(torch, sc, state,
                                          "frame_mats (OFusion, frame 3)")
    rows["nav_grid"] = check_nav(torch, sc, m, "K2 nav_grid (OFusion)")
    rows["raycast_of"], got = check_k1(torch, sc, state, d2,
                                       "K1-OF raycast_of")
    rows["raycast_cold_of"] = check_k1_cold(torch, sc, state,
                                            "K1-OF raycast_cold_of")

    # K6: the whole tracking step of frame 3 against that raycast
    _, verts, norms, valids = preprocess_and_pyramid(d3, kt, 3, False, False)
    kview = se3.matmul4(se3.camera_matrix(kt), se3.inverse(pose))
    rows["icp_track"] = check_icp_track(
        torch, "K6 icp_track (OFusion, frame 3)",
        (pose, kview, verts, norms, valids, got[0], got[1], got[2]))

    # K5's allocator, K3-OF, K4 and K7: frame 3 at the frame-2 pose,
    # stamped with frame 3's time; then K5's drop paths and K3's fallback
    ts = torch.full((), 3.0, dtype=torch.float32, device=sc.dev) * (1 / 30)
    rows.update(new_kernel_rows(torch, sc, m, pose, d3, ts,
                                "OFusion, frame 3"))
    rows.update(option_rows(torch, sc, m, pose, d3, ts, "OFusion, frame 3"))
    merge_errs(rows, check_caps_and_fallback(torch, sc, m, pose, ts,
                                             "OFusion, frame 3"))
    return rows


def probe_phase(torch, dev):
    """K8: each gather form against its twin, bit for bit, and both timed
    (the probe path checks the kernels against the probe's numpy
    expectation)."""
    from supereight_tpu_torch.kernels import gather_probe as gp
    # the card's launch floor under the same profiler: the device time of
    # the least kernel, a one-element fill
    one = torch.zeros(1, device=dev)
    floor_us = device_us(torch, lambda: one.zero_(), 20, 1)
    print(f"K8: launch floor, a one-element zero_(): {floor_us:.2f} device "
          f"us/call")
    rows = {}
    for (name, kernel, plain, _), (t, i), key in zip(
            gp.FORMS, gp.probe_inputs(), PATHS["probe"]):
        tt = torch.from_numpy(t).to(dev)
        it = torch.from_numpy(i).to(dev)
        got, ref = kernel(tt, it), plain(tt, it)
        err = (got - ref).abs().max().item()
        exact = bool(torch.equal(got, ref))
        print(f"K8 {key} ({name}): {tuple(got.shape)}, bit-exact against "
              f"twin: {exact}")
        require(exact, f"K8 {key} is not bit-exact")
        # the one PyTorch call of the same function (its index as int64,
        # made before the timing); the port never calls it
        it64 = it.long()
        library = {
            "gather_a": lambda: torch.index_select(tt, 0, it),
            "gather_b": lambda: torch.gather(tt, 0, it64),
            "gather_c": lambda: torch.gather(tt, 1, it64),
            "gather_d": lambda: torch.index_select(tt, 0, it)}[key]
        require(torch.equal(library(), ref), f"K8 {key}: library call")
        # bytes: the distinct table elements read, the index, the output
        cols = torch.arange(got.shape[1], device=dev)
        if key in ("gather_a", "gather_d"):
            n_read = torch.unique(it).numel() * tt.shape[1]
        elif key == "gather_b":
            n_read = torch.unique(it64 * tt.shape[1] + cols).numel()
        else:
            rows_ = torch.arange(got.shape[0], device=dev)[:, None]
            n_read = torch.unique(rows_ * tt.shape[1] + it64).numel()
        rows[key] = dict(
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: kernel(tt, it), 200),
            plain_ms=cuda_ms(torch, lambda: plain(tt, it), 200),
            library_ms=cuda_ms(torch, library, 200),
            **bound(4 * (n_read + it.numel() + got.numel()), 0))
        # device time per call, of the kernel, its twin and the library
        # call, under the same profiler (the call times above are the
        # host's)
        us = [device_us(torch, fn, 20, n) for fn, n in
              ((lambda: kernel(tt, it), 1), (lambda: plain(tt, it), None),
               (library, 1))]
        rows[key].update(device_us=us[0], library_device_us=us[2],
                         launch_floor_us=floor_us)
        print(f"K8 {key}: call {rows[key]['ms']:.4f} ms, twin "
              f"{rows[key]['plain_ms']:.4f} ms, library "
              f"{rows[key]['library_ms']:.4f} ms; device {us[0]:.2f} "
              f"us/call, twin {us[1]:.2f} us/call, library {us[2]:.2f} "
              f"us/call; bound {rows[key]['bound_ms'] * 1e3:.3f} us; "
              f"above the launch floor {us[0] - floor_us:+.2f} us, the "
              f"library call {us[2] - floor_us:+.2f} us")
    return rows


def slice_phase(torch, sc, card):
    """The main path of one field: 43 frames with the launch counts zeroed
    just before and read just after; then K6 icp_track against its twin
    on every frame's tracking inputs, and K6, K4 and K7 against their
    twins on the last frame's. Returns the path's launch counts and, per
    kernel, the largest error of those checks."""
    import numpy as np
    from supereight_tpu_torch.kernels import _lib

    from supereight_tpu_torch.kernels import integrate as ki
    tag = f"slice {sc.name}"
    first_timed = N_WARMUP + N_FRAMES
    # one event at each timed frame's start and one after the last: the
    # device reaches them in stream order, so consecutive pairs time frames
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(N_TIMED + 1)]
    auxes = []
    state = sc.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t_wall = time.perf_counter()
    for i in range(sc.n_total):
        if i == first_timed - 1:
            snapshot = clone_frame_state(state)  # for the profiled replay
        if i >= first_timed:
            marks[i - first_timed].record()
        state, aux = sc.frame(state, i)
        auxes.append(aux)
    marks[-1].record()
    launches = dict(_lib.LAUNCHES)
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t_wall
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    ms_frame = marks[0].elapsed_time(marks[-1]) / N_TIMED
    frame_ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))

    # the first N_PROFILED timed frames again, from the same state, under
    # torch.profiler: per-stage and per-kernel device times. The frame
    # before them is replayed first as the profiler's warm-up step, whose
    # events are dropped: the device trace misses the first launches after
    # it starts. The trace is complete when it shows every kernel of the
    # path once a frame (the prologue twice), which is K2 and K7 as one
    # device kernel a frame each; a trace that missed launches is taken
    # again, up to PROFILE_TRIES times
    from torch.profiler import ProfilerActivity, profile, schedule
    n_path = len(PATHS[sc.name])
    for attempt in range(PROFILE_TRIES):
        replay = clone_frame_state(snapshot)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=N_PROFILED,
                                       repeat=1)) as prof:
            for i in range(first_timed - 1, first_timed + N_PROFILED):
                replay, _ = sc.frame(replay, i)
                if i in (first_timed - 1, first_timed + N_PROFILED - 1):
                    torch.cuda.synchronize()
                prof.step()
        per_frame, n_launch, op_us = report_profile(prof, ms_frame, tag)
        complete = len(per_frame) == n_path and all(
            v == (2 if k == "frame_mats" else 1) for k, v in per_frame.items())
        one = {k: per_frame.get(k, 0) for k in ("nav_grid", "pyramid")}
        print(f"{tag}: device kernels a frame of K2 and K7 {one} (== 1 "
              f"each), of the frame {n_launch:.0f} kernels and copies; "
              f"{len(per_frame)} of the path's {n_path} kernels, each once "
              f"a frame (the prologue twice): {complete}")
        if complete:
            break
        print(f"{tag}: the profile missed launches (try {attempt + 1} of "
              f"{PROFILE_TRIES})")
    require(complete, f"{tag}: no profile showed the path's kernels once a "
            f"frame, K2 and K7 one device kernel each: {per_frame}")
    # the frame is the path's kernels alone (the prologue twice): no torch
    # op has device work, K5's touched grids no fill
    alloc_ops = op_us.get("frame_step/allocate", 0.0)
    print(f"{tag}: {n_launch:.0f} kernels and copies a frame (== "
          f"{n_path + 1}), torch ops' device time in the allocate span "
          f"{alloc_ops:.2f} us/frame (== 0)")
    require(round(n_launch) == n_path + 1 and alloc_ops == 0,
            f"{tag}: the frame runs more than its kernels: {n_launch} "
            f"kernels and copies, torch ops {op_us}")

    tracked = [bool(a["tracked"]) for a in auxes]
    drops = {c: [int(a[c]) for a in auxes] for c in COUNTERS}
    n_blocks = int(state.map.n_blocks)
    pose = state.pose.cpu().numpy()
    pos_err = float(np.linalg.norm(pose[:3, 3] - sc.poses[-1][:3, 3]))
    print(f"{tag}: {ms_frame:.3f} ms/frame over {N_TIMED} timed distinct "
          f"frames (CUDA events; {card}); per frame median "
          f"{statistics.median(frame_ms):.3f} ms, min {frame_ms[0]:.3f}, max "
          f"{frame_ms[-1]:.3f}; {sc.n_total} frames in {t_wall:.2f} s wall")
    print(f"{tag}: mu {sc.mu}, n_blocks {n_blocks}, final position error "
          f"{pos_err:.4f} m (< {MAX_POS_ERR}), drops (max over frames) "
          f"{ {c: max(v) for c, v in drops.items()} }")
    print(f"{tag}: untracked frames "
          f"{[i for i, t in enumerate(tracked) if not t]}")
    print(f"{tag}: kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }; peak device "
          f"memory {peak_mib:.1f} MiB allocated")
    require(np.isfinite(pose).all()
            and bool(torch.isfinite(state.vertex).all())
            and tuple(state.vertex.shape) == (H, W, 3),
            f"{tag}: non-finite or misshapen output")
    require(all(max(v) == 0 for v in drops.values()),
            f"{tag}: drop counters nonzero: {drops}")
    if sc.noisy:
        check_noise_reference(sc, tracked, n_blocks, pos_err, tag)
    else:
        require(all(tracked[4:]),
                f"{tag}: a frame from frame 4 on did not track")
        require(pos_err < MAX_POS_ERR,
                f"{tag}: final position error {pos_err:.4f} m")
    path = PATHS[sc.name]
    require(all(launches[k] > 0 for k in path),
            f"{tag}: a kernel of the path was not launched: {launches}")
    # the pyramid, the whole tracking step, the node pass and the nav grid
    # are one launch a frame; the reduction alone is no longer on the
    # path; K5's allocator and K3's three launches once a frame each
    noise = sc.options.get("noise_weighted", False)
    expect = {"icp_track": sc.n_total, "node_pass": sc.n_total,
              "pyramid": sc.n_total, "nav_grid": sc.n_total,
              "icp_reduce": 0,
              "alloc_assign": sc.n_total, "integrate_worklist": sc.n_total,
              ki.fused_name(sc.field, noise): sc.n_total,
              ki.fallback_name(sc.field, noise): sc.n_total,
              "frame_mats": 2 * sc.n_total, "node_rank": sc.n_total}
    if sc.noisy:  # the filter and the gated raycast once a frame
        expect.update(median2=sc.n_total, raycast_gated=sc.n_total)
    require(all(launches[k] == v for k, v in expect.items()),
            f"{tag}: launches {launches}, expected {expect} in "
            f"{sc.n_total} frames")

    # K6 against its twin on every frame's tracking inputs as the path
    # meets them (the slice once more: every launch is deterministic, so
    # these are the timed run's frames), then once more (timed, launched
    # twice) on the last frame; on every frame the pose prologue's two
    # calls against the twin, bit for bit, and its pose against the
    # frame's; and on every frame the allocator's incremental mip_alloc
    # against the dense rule (JAX's refresh over every allocated block and
    # this frame's extra octants, on the mips the frame started from)
    from supereight_tpu_torch.core.map import (refresh_mip_alloc,
                                               touched_buffer)
    from supereight_tpu_torch.kernels import alloc, icp
    from supereight_tpu_torch.kernels.frame import frame_mats, \
        frame_mats_plain
    n_exact, worst, mip_bad, mats_bad = 0, 0.0, 0, 0
    seen = []  # each frame's pose, for the noise slice's comparison
    state = sc.init()
    # the touched buffer's set bytes over every frame's end, summed on the
    # device and read once after the slice
    left = torch.zeros((), dtype=torch.int64, device=sc.dev)
    for i in range(sc.n_total):
        args = track_args(torch, sc, state, sc.depths_t[i])
        dense = state.map._replace(
            mip_alloc=tuple(a.clone() for a in state.map.mip_alloc))
        pose_t, tracked_t = icp.icp_track(*args, ITERATIONS, 1e-5)[:2]
        calls = [(sc.kt, state.raycast_pose),
                 (sc.kt, pose_t, state.pose, tracked_t, i,
                  sc.kw["tracking_rate"], sc.kw["integration_rate"])]
        mats = [frame_mats(*a) for a in calls]
        mats_bad += sum(not torch.equal(x, y) for m, a in zip(mats, calls)
                        for x, y in zip(m, frame_mats_plain(*a)))
        state, aux = sc.frame(state, i)
        seen.append(state.pose.clone())
        left += state.map.touched.sum()
        mats_bad += int(not torch.equal(mats[1].pose, state.pose))
        got = (state.pose, aux["tracked"], aux["reduction"],
               aux["track_result"])
        want = icp.icp_track_plain(*args, ITERATIONS, 1e-5)
        ok, e = track_errors(torch, got, want)
        require(ok, f"{tag}: frame {i}: icp_track disagrees with twin: {e}")
        n_exact += all(torch.equal(x, y) for x, y in zip(got, want))
        worst = max(worst, e["pose"])
        extra = ()
        if sc.field.name == "ofusion":
            grids = alloc.touched_masks_of(
                sc.geom, sc.depths_t[i], state.pose,
                frame_mats_plain(sc.kt, state.pose).kpose, sc.mu,
                touched_buffer(sc.geom.blocks_per_side, sc.dev))
            extra = tuple(t & aux["integrated"] for t in grids[1:])
        refresh_mip_alloc(sc.geom, dense, state.map.slot >= 0,
                          extra_levels=(None,) + extra)
        mip_bad += sum(int((a != b).sum()) for a, b in
                       zip(dense.mip_alloc, state.map.mip_alloc))
    print(f"{tag}: icp_track within the twin's tolerances on all "
          f"{sc.n_total} frames, equal to it bit for bit on {n_exact}; pose "
          f"max err {worst:.3e}; frame_mats against its twin and the "
          f"frame's pose on all {sc.n_total} frames: {mats_bad} unequal "
          f"outputs (== 0, bit for bit); incremental mip_alloc against the "
          f"dense rule on all {sc.n_total} frames: {mip_bad} mismatches "
          f"(== 0)")
    if sc.noisy:
        at = {i: (float(np.linalg.norm(seen[i][:3, 3].cpu().numpy()
                                       - sc.poses[i][:3, 3])),
                  int(auxes[i]["n_blocks"]))
              for i in JAX_NOISE_AT if i < sc.n_total}
        print(f"{tag}: position error (m) and blocks by frame, the port's "
              f"against JAX's: " + "; ".join(
                  f"frame {i} {at[i][0]:.4f} / {JAX_NOISE_AT[i][0]:.4f} m, "
                  f"{at[i][1]} / {JAX_NOISE_AT[i][1]}" for i in at))
    left = int(left)
    print(f"{tag}: the map's touched buffer after each of the "
          f"{sc.n_total} frames: {left} bytes set in all (== 0)")
    require(left == 0, f"{tag}: the touched buffer kept marks past a frame")
    require(mip_bad == 0, f"{tag}: mip_alloc departs from the dense rule")
    require(mats_bad == 0, f"{tag}: frame_mats disagrees with its twin")
    last = f"{sc.name}, frame {sc.n_total - 1}"
    trow = check_icp_track(torch, f"K6 icp_track ({last})", args)
    # K4 and K7 on the last frame: its node pass on the map and pose the
    # slice ended with, and its pyramid; the depth the path fuses and
    # allocates from (the filtered one where the slice filters)
    from supereight_tpu_torch.pipeline import preprocess_and_pyramid
    ts = torch.full((), float(sc.n_total - 1), dtype=torch.float32,
                    device=sc.dev) * (1 / 30)
    d0 = preprocess_and_pyramid(sc.depths_t[-1], sc.kt, 1, False,
                                sc.kw["filter_input"])[0][0]
    fuse = d0 if sc.options.get("fuse_filtered") else sc.depths_t[-1]
    errs = {"icp_track": max(worst, trow["max_abs_err"]),
            "frame_mats": float(mats_bad)}
    errs.update((k, v[0]["max_abs_err"]) for k, v in check_node_pass(
        torch, sc, state.map, state.pose, fuse, ts,
        f"K4 node_pass ({last})").items())
    errs["pyramid"] = check_pyramid(torch, d0,
                                    f"K7 pyramid ({last})")[0]["max_abs_err"]
    # K5's allocator and K3 on the last frame, on the map and pose the
    # slice ended with
    arow, _, _, m_alloc, _ = check_alloc(torch, sc, state.map, state.pose,
                                         d0, f"K5 alloc_assign ({last})")
    errs["alloc_assign"] = arow["max_abs_err"]
    brows, _ = check_block_pass(torch, sc, m_alloc, state.pose, fuse, ts,
                                f"K3 ({last})", noise)
    errs.update((k, v[0]["max_abs_err"]) for k, v in brows.items())
    if sc.noisy:
        empty_cta_cost(torch, sc, m_alloc, state.pose, fuse, ts, last)
    return {k: launches[k] for k in path}, errs


def check_noise_reference(sc, tracked, n_blocks, pos_err, tag):
    """The tsdf-noise slice against JAX's frame step over the same frames
    (JAX_NOISE_*, JAX on the CPU): the tracked frames equal. The block
    count and the final position error are printed beside JAX's: JAX
    loses the trajectory on this slice (1.86 m), so neither a 1 % and 1 mm
    tolerance nor the 0.02 m accuracy bar can hold a port that follows it
    (PERF.md)."""
    got = tuple(i for i, t in enumerate(tracked) if t)
    d_blocks = (n_blocks - JAX_NOISE_BLOCKS) / JAX_NOISE_BLOCKS
    print(f"{tag}: against JAX on the CPU: tracked frames {len(got)} vs "
          f"{len(JAX_NOISE_TRACKED)} (the same set: "
          f"{got == JAX_NOISE_TRACKED}); blocks {n_blocks} vs "
          f"{JAX_NOISE_BLOCKS} ({100 * d_blocks:+.2f} %); final position "
          f"error {pos_err:.4f} m vs {JAX_NOISE_POS_ERR:.4f} m "
          f"({1e3 * (pos_err - JAX_NOISE_POS_ERR):+.1f} mm)")
    require(got == JAX_NOISE_TRACKED,
            f"{tag}: tracked frames {got} differ from JAX's")


def empty_cta_cost(torch, sc, m, pose, depth, ts, tag):
    """The cost of the noise slice's budget in K3's fused pass: its device
    time with the worklist of NOISE_BUDGET entries (the path's) and with
    only the entries that list a block, on copies of the last frame's
    map."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.kernels import integrate as ki
    h, w = depth.shape
    t_cw, kmat = se3.inverse(pose), se3.camera_matrix(sc.kt)
    when = torch.ones((), dtype=torch.bool, device=sc.dev)
    wl = ki.integrate_worklist(sc.geom, m, t_cw, kmat, (w, h), sc.budget,
                               when)[0]
    listed = int((wl < sc.geom.capacity).sum())
    us = []
    for entries in (wl, wl[:listed].contiguous()):
        mm = clone_map(m)
        us.append(device_us(torch, lambda: ki.integrate_fused(
            sc.geom, mm, sc.field, entries, depth, t_cw, kmat, sc.mu, ts,
            True), 20, 1))
    print(f"K3 integrate_fused_noise ({tag}): {listed} listed blocks; device "
          f"{us[0]:.2f} us/launch over the path's {sc.budget} entries, "
          f"{us[1]:.2f} over the {listed} listed ones: the empty CTAs cost "
          f"{us[0] - us[1]:.2f} us a frame")


def probe_path(torch, dev):
    """The probe's main path: its entry point, counts zeroed just before
    and read just after; each form must equal the probe's numpy
    expectation bit for bit."""
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.tools import probe_gather
    torch.cuda.synchronize()
    _lib.reset_launches()
    results = probe_gather.run(dev)
    launches = dict(_lib.LAUNCHES)
    for name, ok, msg in results:
        print(f"probe path: {name}: {msg}")
    require(all(ok for _, ok, _ in results), "probe path: a form failed")
    require(all(launches[k] > 0 for k in PATHS["probe"]),
            f"probe path: a kernel was not launched: {launches}")
    return {k: launches[k] for k in PATHS["probe"]}


def start_loop_raw(tmp):
    """Start rendering the LOOP_FRAMES-frame loop .raw (and its ground
    truth) into ``tmp`` with the port's converter, in a process of its
    own that spreads the frames over LOOP_WORKERS processes; returns the
    process and the .raw's path."""
    raw = os.path.join(tmp, "loop.raw")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "supereight_tpu_torch.io.convert",
         "synthetic", raw, "--frames", str(LOOP_FRAMES), "--scene", "loop",
         "--workers", str(LOOP_WORKERS)], cwd=root, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return proc, raw


def wait_loop_raw(proc, t_start):
    _, err = proc.communicate(timeout=900)
    ready = time.perf_counter() - t_start
    print(f"pipeline: the {LOOP_FRAMES}-frame loop .raw rendered in "
          f"{LOOP_WORKERS} processes, ready {ready:.1f} s after its start "
          f"(rc {proc.returncode})")
    require(proc.returncode == 0, f"the loop .raw failed: {err[-2000:]}")


def cli_stderr(text):
    """The CLI's stderr lines: (ATE RMSE m, drop counters dict, wall fps
    of the run)."""
    ate, drops, fps = None, None, None
    for line in text.splitlines():
        if "ATE RMSE" in line:
            ate = float(line.split("ATE RMSE")[1].split()[0])
        if line.startswith("# drop counters"):
            drops = ast.literal_eval(line.split(": ", 1)[1].strip())
        if line.startswith("# frames=") and "fps=" in line:
            fps = float(line.split("fps=")[1])
    return ate, drops, fps


def pipeline_run(torch, name, raw, tmp, card):
    """The class pipeline's path for one field: the port's CLI
    (``cli.run``, in this process) over the loop .raw with
    run_longseq_eval.py's arguments, then one volume render from the last
    raycast pose moved BACK_VIEW back (K1's unprimed launch), with every
    launch count zeroed just before and read just after. Holds the drop
    counters to 0, the tracked fraction (the log's) to MIN_TRACKED, the
    ATE to MAX_ATE and, for TSDF, the PPM count to the rendered frames.
    Returns the pipeline, the path's launch counts and its numbers."""
    import numpy as np
    from supereight_tpu_torch import cli
    from supereight_tpu_torch.eval.sweep import parse_frame_log, summarize
    from supereight_tpu_torch.kernels import _lib
    tag = f"pipeline {name}"
    path = "pipeline-" + name
    log = os.path.join(tmp, name + ".log")
    renders = os.path.join(tmp, "renders-" + name)
    argv = (["-i", raw, "-g", raw + ".gt.txt", "-o", log,
             "--trajectory-out", os.path.join(tmp, name + ".traj"),
             "--max-frames", str(LOOP_FRAMES)] + list(PIPE_ARGS)
            + list(PIPE_FIELD_ARGS[name]))
    field_args = PIPE_FIELD_ARGS[name]
    rate = int(field_args[field_args.index("-z") + 1])
    if rate:
        argv += ["--dump-renders", renders]
    err = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        pipe = cli.run(argv)
    # a fresh view: K1's unprimed launch over every block
    view_pose = moved_pose(pipe.raycast_pose, -BACK_VIEW).cpu().numpy()
    image = pipe.render_volume(view_pose=view_pose)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    wall = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    for line in err.getvalue().splitlines():
        print(f"{tag}: cli: {line}")
    ate, drops, fps = cli_stderr(err.getvalue())
    rows = parse_frame_log(log)
    summary = summarize(rows)
    n_ppm = len(os.listdir(renders)) if rate else 0
    want_ppm = sum(1 for f in range(LOOP_FRAMES) if rate and f % rate == 0
                   and f > 2)
    lit = int((image[..., :3].max(-1) > 0).sum())
    print(f"{tag}: {len(rows)} frames; ATE RMSE {ate:.4f} m (EVAL_table.md "
          f"row {EVAL_ATE[name]:.4f} m, limit {MAX_ATE[name]:.3f}); tracked "
          f"fraction {summary['tracked_fraction']:.4f} (>= {MIN_TRACKED}); "
          f"drops {drops}; mean computation "
          f"{1e3 * summary['computation_mean']:.3f} ms/frame, total "
          f"{1e3 * summary['total_mean']:.3f} ms/frame, wall fps {fps} "
          f"({wall:.2f} s with the fresh view; {card}); peak device memory "
          f"{peak_mib:.1f} MiB allocated; {n_ppm} PPM renders (== "
          f"{want_ppm}); fresh view from {BACK_VIEW} m back: {lit} lit "
          f"pixels of {image.shape[0] * image.shape[1]}")
    print(f"{tag}: kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    require(len(rows) == LOOP_FRAMES and ate is not None
            and np.isfinite(ate), f"{tag}: the run did not finish")
    require(drops is not None and all(v == 0 for v in drops.values()),
            f"{tag}: drop counters nonzero: {drops}")
    require(summary["tracked_fraction"] >= MIN_TRACKED,
            f"{tag}: tracked fraction {summary['tracked_fraction']}")
    require(ate <= MAX_ATE[name], f"{tag}: ATE {ate:.4f} m over the limit")
    require(n_ppm == want_ppm, f"{tag}: {n_ppm} renders, {want_ppm} due")
    require(lit > 0, f"{tag}: the fresh view shows nothing")
    require(all(launches[k] > 0 for k in PATHS[path]),
            f"{tag}: a kernel of the path was not launched: {launches}")
    cold = "raycast_cold_of" if name == "ofusion" else "raycast_cold"
    require(launches[cold] == 1, f"{tag}: the fresh view launched "
            f"{cold} {launches[cold]} times")
    numbers = dict(ate=ate, tracked=summary["tracked_fraction"],
                   computation_ms=1e3 * summary["computation_mean"],
                   wall_fps=fps, peak_mib=peak_mib)
    return pipe, {k: launches[k] for k in PATHS[path]}, numbers


def loop_depth(raw, i):
    from supereight_tpu_torch.io.dataset import RawDepthReader
    return RawDepthReader(raw).read_frame(i)[0]


def check_resume(torch, pipe, raw, tmp, tag):
    """save_checkpoint, load_checkpoint into a new pipeline, and one more
    frame (frame LOOP_FRAMES, the loop's first depth again) in both: the
    pose, raycast pose and maps, the map and the frame's result equal bit
    for bit."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    ckpt = os.path.join(tmp, "resume.npz")
    pipe.save_checkpoint(ckpt)
    w, h = pipe.computation_size
    r = pipe.config.compute_size_ratio
    other = DenseSLAMSystem((w * r, h * r), pipe.config, device=pipe.device)
    other.load_checkpoint(ckpt)
    depth = loop_depth(raw, 0)
    ra = pipe.process_frame(depth, LOOP_FRAMES)
    rb = other.process_frame(depth, LOOP_FRAMES)
    names = ("pose", "raycast_pose", "vertex", "normal", "valid")
    same = [torch.equal(getattr(pipe, a), getattr(other, a)) for a in names]

    def leaves(m):
        return [x for v in m for x in (v if isinstance(v, tuple) else (v,))]
    same_map = all(torch.equal(a, b) for a, b in zip(leaves(pipe.map),
                                                     leaves(other.map)))
    # the counters a frame does not write carry over from earlier frames,
    # which the checkpoint does not hold
    same_res = all(int(ra[k]) == int(rb[k]) for k in ra if k in rb)
    print(f"{tag}: save_checkpoint, load_checkpoint, frame {LOOP_FRAMES}: "
          f"{dict(zip(names, same))}, map {same_map}, result {same_res} "
          f"against the same frame without the round trip (bit for bit); "
          f"tracked {ra['tracked']}, blocks {pipe.block_count()}")
    require(all(same) and same_map and same_res,
            f"{tag}: the resumed frame differs")


def pipeline_profile(torch, pipe, raw, ms_frame, tag):
    """N_PIPE_PROFILED more frames of the pipeline (the loop's frames 1 to
    N_PIPE_PROFILED again, numbered on past the loop) under torch.profiler
    after one warm-up step: the device's busy ms a frame and its share of
    the run's mean computation time, and each port kernel's launches a
    frame and device us a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    depths = [loop_depth(raw, i) for i in range(N_PIPE_PROFILED + 1)]
    first = LOOP_FRAMES + 1
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=N_PIPE_PROFILED,
                                   repeat=1)) as prof:
        for j, d in enumerate(depths):
            pipe.process_frame(d, first + j)
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 \
        / N_PIPE_PROFILED
    n = sum(e.count for e in events) / N_PIPE_PROFILED
    per = {}
    for e in events:
        pk = port_kernel(e.key)
        if pk:
            c, us = per.get(pk[0], (0, 0.0))
            per[pk[0]] = (c + e.count, us + e.self_device_time_total)
    print(f"{tag} profile: device busy {busy:.3f} ms/frame in {n:.0f} "
          f"kernels and copies a frame; busy share of the run's mean "
          f"computation {ms_frame:.3f} ms/frame: {busy / ms_frame:.4f}; "
          + ", ".join(f"{k} {c / N_PIPE_PROFILED:g}x {us / max(c, 1):.2f} us"
                      for k, (c, us) in sorted(per.items())))
    return dict(busy_ms=busy, launches_frame=n, busy_share=busy / ms_frame)


def pipeline_phase(torch, raw, tmp, card):
    """Both fields' class-pipeline paths over the loop; the TSDF pipeline
    then resumes from a checkpoint and exports its mesh; both profiled;
    then the TSDF path with keyframes (:func:`ba_run`). Returns the paths'
    launch counts and the closure icp_track's error against its twin."""
    launches = {}
    for name in ("tsdf", "ofusion"):
        tag = f"pipeline {name}"
        pipe, counts, numbers = pipeline_run(torch, name, raw, tmp, card)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if name == "tsdf":
            check_resume(torch, pipe, raw, tmp, tag)
            check_dump_mesh(pipe, tmp, tag, card)
            no_ba_ate = numbers["ate"]
        numbers.update(pipeline_profile(torch, pipe, raw,
                                        numbers["computation_ms"], tag))
        print(f"{tag}: {json.dumps(numbers)}")
        del pipe
        torch.cuda.empty_cache()
    counts, closure_err, numbers = ba_run(torch, raw, tmp, card, no_ba_ate)
    print(f"pipeline tsdf-ba: {json.dumps(numbers)}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    return launches, closure_err


def sphere_shell(torch, geom, dev):
    """The library phase's shell: bool[B, B, B], the blocks whose centre
    lies within 2 half diagonals of the sphere's surface."""
    b = geom.blocks_per_side
    g = (torch.arange(b, dtype=torch.float64, device=dev) + 0.5) * 8 \
        * geom.voxel_size
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    dist = torch.sqrt((x - LIB_CENTRE) ** 2 + (y - LIB_CENTRE) ** 2
                      + (z - LIB_CENTRE) ** 2) - LIB_RADIUS
    return dist.abs() < 2 * 4 * 3 ** 0.5 * geom.voxel_size


def band_points(torch, n, seed, dev):
    """n metric points within LIB_BAND of the sphere's surface, and their
    analytic SDF and unit normal."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    d = torch.randn((n, 3), generator=gen, dtype=torch.float64)
    d = d / d.norm(dim=1, keepdim=True)
    u = (torch.rand(n, generator=gen, dtype=torch.float64) * 2 - 1) \
        * LIB_BAND
    p = LIB_CENTRE + d * (LIB_RADIUS + u)[:, None]
    sdf = (p - LIB_CENTRE).norm(dim=1) - LIB_RADIUS
    return (p.to(torch.float32).to(dev), sdf.to(dev), d.to(dev))


def library_phase(torch, dev, tmp, card):
    """The library surface at full width on the card: a LIB_SIZE^3 map over
    LIB_DIM m with capacity LIB_CAPACITY, the sphere shell allocated by
    ``core/map.allocate_blocks`` (K5's alloc_assign, counted as the
    library path, counts zeroed just before and read just after) and the
    analytic SDF written with ``set_voxels``; then interp and
    ``Volume.interp`` at LIB_POINTS points in the band against the SDF,
    grad against the analytic normal, ``collides_with`` on a box inside
    the sphere (OCCUPIED), one in the observed band outside it (EMPTY)
    and one in unallocated space (UNSEEN), and marching cubes, whose
    vertices must lie within a voxel of the sphere. The same allocation,
    writes and reads on a CPU copy (the allocator's twin) must give the
    same map exactly and interp and grad to LIB_TWIN_TOL. Returns the
    path's launch counts."""
    import numpy as np
    from supereight_tpu_torch.core import geometry, interp
    from supereight_tpu_torch.core import map as tmap
    from supereight_tpu_torch.core.volume import Volume
    from supereight_tpu_torch.fields import TSDF
    from supereight_tpu_torch.io import meshing
    from supereight_tpu_torch.kernels import _lib
    tag = "library"
    geom = tmap.MapGeometry(LIB_SIZE, LIB_DIM, LIB_CAPACITY)
    state = tmap.make_map(geom, TSDF, dev)
    shell = sphere_shell(torch, geom, dev)
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    tmap.allocate_blocks(geom, state, shell)
    torch.cuda.synchronize()
    alloc_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(_lib.LAUNCHES)
    n = int(state.n_blocks)
    require(n == int(shell.sum()) and not state.touched.any(),
            f"{tag}: {n} blocks for {int(shell.sum())} shell cells")
    require(bool(shell.equal(state.slot >= 0)),
            f"{tag}: the slot grid is not the shell")
    # the analytic SDF (m) on every voxel of the allocated bricks
    lin = torch.arange(512, device=dev)
    local = torch.stack([lin % 8, (lin // 8) % 8, lin // 64], -1)
    v = (state.block_coord[:n, None, :] * 8 + local[None]).reshape(-1, 3)
    sdf = ((v.double() * geom.voxel_size - LIB_CENTRE).norm(dim=1)
           - LIB_RADIUS).to(torch.float32)
    t0 = time.perf_counter()
    tmap.set_voxels(state, v, sdf, torch.ones_like(sdf))
    torch.cuda.synchronize()
    set_ms = 1e3 * (time.perf_counter() - t0)

    p, want, normal = band_points(torch, LIB_POINTS, 7, dev)
    vox = p * geom.inv_voxel_size
    got = interp.interp(geom, state, TSDF, vox)
    vol = Volume(geom, state, TSDF).interp(p)
    err = (got.double() - want).abs().max().item()
    err_vol = (vol.double() - want).abs().max().item()
    g = interp.grad(geom, state, TSDF, vox).double()
    cos = (g * normal).sum(1) / g.norm(dim=1)
    angle = torch.rad2deg(torch.acos(cos.clamp(-1, 1)))
    print(f"{tag}: {n} blocks of {LIB_CAPACITY} ({LIB_SIZE}^3 over "
          f"{LIB_DIM} m), allocate_blocks {alloc_ms:.2f} ms (launches "
          f"{ {k: c for k, c in launches.items() if c} }), set_voxels of "
          f"{len(v)} voxels {set_ms:.2f} ms; interp at {LIB_POINTS} points "
          f"within {LIB_BAND} m of the surface: max error {err:.3e} m, "
          f"Volume.interp {err_vol:.3e} m (< {MAX_INTERP_ERR}); grad against "
          f"the analytic normal: mean {angle.mean().item():.4f}, max "
          f"{angle.max().item():.4f} degrees (< {MAX_GRAD_ANGLE})")
    require(max(err, err_vol) < MAX_INTERP_ERR, f"{tag}: interp error")
    require(angle.max().item() < MAX_GRAD_ANGLE, f"{tag}: grad angle")

    # the same drive on the CPU: alloc_assign's twin, the writes, the reads
    host = tmap.make_map(geom, TSDF, "cpu")
    tmap.allocate_blocks(geom, host, shell.cpu())
    tmap.set_voxels(host, v.cpu(), sdf.cpu(), torch.ones_like(sdf).cpu())
    for f, a, b in zip(host._fields[:-1], host[:-1], state[:-1]):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            require(torch.equal(x, y.cpu()), f"{tag}: {f} differs from the "
                    f"CPU twin's")
    vox_h = vox.cpu()
    dev_i = (got.cpu() - interp.interp(geom, host, TSDF, vox_h)).abs()
    dev_g = (g.float().cpu() - interp.grad(geom, host, TSDF, vox_h)).abs()
    print(f"{tag}: against the same drive on the CPU: the map equal, "
          f"interp max |diff| {dev_i.max().item():.3e}, grad "
          f"{dev_g.max().item():.3e} (tolerance {LIB_TWIN_TOL} + "
          f"{LIB_TWIN_TOL} x value)")
    for name, d, ref in (("interp", dev_i, got.cpu()), ("grad", dev_g,
                                                        g.float().cpu())):
        require(bool((d <= LIB_TWIN_TOL + LIB_TWIN_TOL * ref.abs()).all()),
                f"{tag}: {name} differs from the CPU's")
    del host

    # boxes on the +x axis through the centre: just inside the surface,
    # just outside it, and far from the shell
    c = round(LIB_CENTRE * geom.inv_voxel_size)
    r = LIB_RADIUS * geom.inv_voxel_size
    inner = int(np.floor(c + r)) - 3
    boxes = {"inside": ((inner, c - 1, c - 1), (inner + 3, c + 2, c + 2)),
             "band outside": ((inner + 5, c - 1, c - 1),
                              (inner + 8, c + 2, c + 2)),
             "unallocated": ((c - 4, c - 4, c - 4), (c + 4, c + 4, c + 4))}
    want_status = {"inside": geometry.CollisionStatus.OCCUPIED,
                   "band outside": geometry.CollisionStatus.EMPTY,
                   "unallocated": geometry.CollisionStatus.UNSEEN}
    for name, (lo, hi) in boxes.items():
        st = int(geometry.collides_with(geom, state, TSDF, lo, hi))
        print(f"{tag}: collides_with {name} box {lo}-{hi}: "
              f"{geometry.CollisionStatus(st).name} (want "
              f"{want_status[name].name})")
        require(st == want_status[name], f"{tag}: collision of {name}")

    t0 = time.perf_counter()
    tris = meshing.marching_cubes(geom, state)
    mesh_s = time.perf_counter() - t0
    dist = np.abs(np.linalg.norm(tris.reshape(-1, 3) - LIB_CENTRE, axis=1)
                  - LIB_RADIUS)
    print(f"{tag}: marching_cubes {len(tris)} triangles in {mesh_s:.2f} s "
          f"(host numpy; {card}); vertex distance to the sphere max "
          f"{dist.max() * 1e3:.3f} mm (< one voxel, "
          f"{geom.voxel_size * 1e3:.3f} mm)")
    require(len(tris) > 100_000 and dist.max() < geom.voxel_size,
            f"{tag}: mesh off the sphere")
    require(launches["alloc_assign"] > 0, f"{tag}: alloc_assign not "
            f"launched: {launches}")
    return {k: launches[k] for k in PATHS["library"]}


@contextlib.contextmanager
def watch_closures(torch):
    """Record the loop-closure re-tracks (icp_track launches with the 3x
    gate: the count and the first one's inputs, cloned) and the BA solves
    (count and host ms, each ending with its host read) of the pipeline
    runs inside."""
    from supereight_tpu_torch.constants import DIST_THRESHOLD
    from supereight_tpu_torch.ops import tracking
    from supereight_tpu_torch.posegraph.keyframes import KeyframeManager
    seen = dict(tries=0, args=None, solves_ms=[])
    track, optimize = tracking.icp_track, KeyframeManager.optimize

    def icp_track(*args, dist_threshold=DIST_THRESHOLD, **kw):
        if dist_threshold != DIST_THRESHOLD:
            seen["tries"] += 1
            if seen["args"] is None:
                seen["args"] = tuple(
                    tuple(x.clone() for x in a) if isinstance(a, tuple)
                    else a.clone() for a in args[:8])
        return track(*args, dist_threshold=dist_threshold, **kw)

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        out = optimize(self, *args, **kw)
        seen["solves_ms"].append(1e3 * (time.perf_counter() - t0))
        return out
    tracking.icp_track, KeyframeManager.optimize = icp_track, timed
    try:
        yield seen
    finally:
        tracking.icp_track, KeyframeManager.optimize = track, optimize


def ba_run(torch, raw, tmp, card, no_ba_ate):
    """The BA path: the TSDF pipeline through the CLI with keyframes
    (BA_ARGS), launch counts zeroed just before and read just after.
    Holds the drop counters to 0, the tracked fraction to MIN_TRACKED,
    the ATE to MAX_BA_ATE, at least one accepted closure (an edge between
    non-consecutive keyframes), icp_track launched once a frame plus once
    a closure try, and one closure's icp_track against its twin with the
    3x gate. Returns the path's launch counts and its row's error."""
    import numpy as np
    from supereight_tpu_torch import cli
    from supereight_tpu_torch.eval.sweep import parse_frame_log, summarize
    from supereight_tpu_torch.kernels import _lib
    tag = "pipeline tsdf-ba"
    log = os.path.join(tmp, "tsdf-ba.log")
    argv = (["-i", raw, "-g", raw + ".gt.txt", "-o", log,
             "--trajectory-out", os.path.join(tmp, "tsdf-ba.traj"),
             "--max-frames", str(LOOP_FRAMES)] + list(PIPE_ARGS)
            + list(PIPE_FIELD_ARGS["tsdf"]) + list(BA_ARGS))
    err = io.StringIO()
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with watch_closures(torch) as seen, contextlib.redirect_stderr(err):
        pipe = cli.run(argv)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    wall = time.perf_counter() - t0
    for line in err.getvalue().splitlines():
        print(f"{tag}: cli: {line}")
    ate, drops, fps = cli_stderr(err.getvalue())
    summary = summarize(parse_frame_log(log))
    km = pipe.keyframes
    closures = [(i, j) for i, j, _, _ in km.edges if j - i > 1]
    solves = seen["solves_ms"]
    print(f"{tag}: ATE RMSE {ate:.4f} m (EVAL_table.md tsdf icp+BA "
          f"{EVAL_BA_ATE:.4f} m, limit {MAX_BA_ATE}; this run's no-BA row "
          f"{no_ba_ate:.4f} m); tracked fraction "
          f"{summary['tracked_fraction']:.4f}; drops {drops}; keyframes "
          f"{len(km.frames)} (frames {km.frames}); closures tried "
          f"{seen['tries']}, accepted {len(closures)} {closures}, pinned "
          f"{sum(km.pinned)}; BA solves {len(solves)}, host ms each "
          f"{[round(x, 2) for x in solves]}; mean computation "
          f"{1e3 * summary['computation_mean']:.3f} ms/frame, wall fps "
          f"{fps} ({wall:.2f} s; {card})")
    print(f"{tag}: kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    require(ate is not None and np.isfinite(ate), f"{tag}: no ATE")
    require(drops is not None and all(v == 0 for v in drops.values()),
            f"{tag}: drop counters nonzero: {drops}")
    require(summary["tracked_fraction"] >= MIN_TRACKED,
            f"{tag}: tracked fraction {summary['tracked_fraction']}")
    require(ate <= MAX_BA_ATE, f"{tag}: ATE {ate:.4f} m over the limit")
    require(closures and any(km.pinned), f"{tag}: no closure accepted")
    require(solves, f"{tag}: no BA solve")
    require(all(launches[k] > 0 for k in PATHS["pipeline-tsdf-ba"]),
            f"{tag}: a kernel of the path was not launched: {launches}")
    require(launches["icp_track"] == LOOP_FRAMES + seen["tries"],
            f"{tag}: icp_track launched {launches['icp_track']} times for "
            f"{LOOP_FRAMES} frames and {seen['tries']} closure tries")
    row = check_icp_track(torch, f"{tag} closure icp_track (gate "
                          f"{CLOSURE_DIST} m)", seen["args"],
                          dist_threshold=CLOSURE_DIST)
    del pipe
    return ({k: launches[k] for k in PATHS["pipeline-tsdf-ba"]},
            row["max_abs_err"], dict(ate=ate, closures=len(closures),
                                     tries=seen["tries"],
                                     solves=len(solves)))


def check_dump_mesh(pipe, tmp, tag, card):
    """dump_mesh of the pipeline's map to .obj: it must produce
    triangles; its time and the triangle count are printed."""
    path = os.path.join(tmp, "loop.obj")
    t0 = time.perf_counter()
    tris = pipe.dump_mesh(path)
    dt = time.perf_counter() - t0
    print(f"{tag}: dump_mesh of {pipe.block_count()} blocks: {len(tris)} "
          f"triangles, {os.path.getsize(path) / 2**20:.1f} MiB .obj in "
          f"{dt:.2f} s (one download, host numpy and the Python writer; "
          f"{card})")
    require(len(tris) > 0, f"{tag}: dump_mesh made no triangle")
    os.remove(path)


def main():
    import torch

    require(torch.cuda.is_available(), "no CUDA device")
    card = card_line()
    print(card)
    print(versions(torch))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from supereight_tpu_torch.kernels import _lib

    t0 = time.perf_counter()
    lib = _lib.library()
    # K3's former prepass and update, which the fused block pass replaced,
    # are no longer built, so no path can launch them
    require(not any(hasattr(lib, "se_integrate_" + k)
                    for k in ("prepass", "update")),
            "the library still exports K3's former prepass or update")
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_lib.build_info.get('seconds', 0.0):.1f} s, "
          f"cached={_lib.build_info.get('cached')})")
    log = _lib.build_info.get("log")
    if log:
        for line in open(log).read().splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    dev = torch.device("cuda", 0)
    # the loop .raw of the pipeline paths renders while the kernel phases
    # and the slices run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    t_raw = time.perf_counter()
    raw_proc, raw = start_loop_raw(tmp)
    try:
        run_checks(torch, dev, card, raw_proc, raw, t_raw, tmp)
    finally:
        if raw_proc.poll() is None:
            raw_proc.kill()
            raw_proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def run_checks(torch, dev, card, raw_proc, raw, t_raw, tmp):
    from supereight_tpu_torch.fields import OFUSION, TSDF
    tsdf, of = Scene(torch, TSDF, dev), Scene(torch, OFUSION, dev)
    noise = Scene(torch, TSDF, dev, noisy=True)
    rows = kernel_phase_tsdf(torch, tsdf)
    # a kernel both fields run keeps the TSDF phase's times and bound, with
    # the OFusion phase's under "ofusion"; its error is the largest of all
    # its checks (both fields, frame 3 and the slices' last frames)
    errs = {}
    for name, row in kernel_phase_of(torch, of).items():
        if name in rows:
            errs.setdefault(name, [rows[name]["max_abs_err"]]).append(
                row["max_abs_err"])
            rows[name]["ofusion"] = {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by") if k in row}
        else:
            rows[name] = row
    rows.update(probe_phase(torch, dev))
    check_mm2meters(torch, dev)
    torch.cuda.synchronize()

    # ---- the main paths, each with the counts zeroed just before -------
    launches = {k: 0 for k in KERNELS}
    for sc in (tsdf, of, noise):
        path_launches, slice_errs = slice_phase(torch, sc, card)
        for k, e in slice_errs.items():
            errs.setdefault(k, [rows[k]["max_abs_err"]]).append(e)
        for k, v in path_launches.items():
            launches[k] += v
    launches.update(probe_path(torch, dev))
    for k, v in library_phase(torch, dev, tmp, card).items():
        launches[k] += v
    torch.cuda.empty_cache()
    wait_loop_raw(raw_proc, t_raw)
    pipe_launches, closure_err = pipeline_phase(torch, raw, tmp, card)
    for k, v in pipe_launches.items():
        launches[k] += v
    errs.setdefault("icp_track", [rows["icp_track"]["max_abs_err"]]) \
        .append(closure_err)
    for k, e in errs.items():
        rows[k]["max_abs_err"] = max(e)

    # library_ms: no single PyTorch call computes the function, except
    # for the gather forms (probe phase); the others say why not
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name],
                    **{"library_ms": None, **rows[name]},
                    **({"library_none": NO_LIBRARY[name]}
                       if name in NO_LIBRARY else {}))
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
