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
   worklist, fused pass and fallback on the map the allocator made (each
   checked and timed at the slice's 8,192 entries and at the bucket's
   49,152, the second's row under "bucket" in the JSON line), K4
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
   theirs, at the probe's shapes and at the brick pool's
   (``gather_probe.pool_inputs``; A and D on disjoint brick sets in turn,
   C on disjoint tables and indices in turn, so that their reads come
   from device memory), each with its bytes bound and share, by
   ``tools/probe_gather.py --time``'s cases and meter;
   K9 ``ba_solve`` (the pose graph's windowed solve) against its twin on
   synthetic windows of 4, 17, 32 and 64 nodes with 128 and 200 edge
   slots, and with twice as many slots as nodes Tier S's largest window
   and one node more (``kernels/ba.tier_s_nodes``), then 160, 256 and 512
   nodes in Tier L (closures, frozen nodes, garbage padding; poses to
   1e-5, fixed nodes bit-equal, one launch a call), the gauge-less window
   and a window with a NaN in a padded slot (NaN in both), each with its
   tier, timed (call ms, device us, twin ms; a single call past 160
   nodes) beside its bound, its chain of panels and the factor's library
   yardstick (``tools/ba_windows.cholesky_ms``);
   and ``ops/preprocess.mm2meters`` on the card against numpy
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
   its worklist cost (the fused pass and the fallback over the path's
   entries beside the listed ones alone, as on the pipeline paths), and
   on whose last frame K1's gated launch and K7's median2 are held to
   their twins and measured (``tools/noise_kernels.py``: the gated
   march's probes a ray, the longest ray's probes by kind, device us, the
   launch with its probe bound cut to the p50/p90/p99/max of the probe
   counts); after each slice its graph phase: the same 43 frames through
   the frame program (``parallel/step.FrameProgram``, the frame step
   captured as one CUDA graph at frame 0 and replayed), frame by frame
   against the eager step, bit for bit (pose, raycast pose, reference
   maps, every aux entry and the packed row; the map at the end), one
   graph, the slice's blocks and drops 0; ms/frame of the timed window
   eager, graph, graph, eager in this call with the per-frame median,
   min and max and the host's time a call, the launches counted by the
   replays equal to the eager run's and the path's; and a replay under
   torch.profiler that shows each kernel of the path once a frame (the
   prologue twice) and the program's own copies, nothing else, with the
   replayed frame's split (busy, idle inside it, gaps between frames);
   then
   the bench phase: the port's headline bench
   (``python -m supereight_tpu_torch.tools.bench``, whose configuration
   the slices take, timing the frame program) for each field in a
   process of its own, its one JSON
   line held to its four keys, metric name, unit and vs_baseline, its
   blocks, drops, tracked flag and final error to the field's slice, its
   launches (counted by the replays) to the path's kernels once a frame
   (the prologue twice), its eager step's final pose and blocks to its
   graph's, and its fps printed beside the graph phase's and its eager
   fps beside the slice's; then the probe's own path
   (``supereight_tpu_torch.tools.probe_gather.run``) likewise, each form
   bit for bit against the probe's numpy expectation;
6. pipeline phases: the 250-frame closed loop (``io/convert.synthetic2raw
   scene="loop"``, rendered into a temporary directory in four processes
   while the phases above run) through the port's CLI (``cli.run``, in
   this process) with ``tools/run_longseq_eval.py``'s arguments, TSDF
   (with ``--dump-renders``) and OFusion, the class on its stage graphs
   (one CUDA graph a stage and set of static arguments; each replay timed
   on the host), then one volume render from a
   view 0.5 m behind the last raycast pose (K1's unprimed launch), each
   path with the launch counts zeroed just before and read just after;
   every render is K10's (``csrc/render.cu``): a rendered frame is one
   ``render_views`` launch (the three renders in the 2x2 composite) and
   one read, so TSDF's 62 rendered frames and the fresh view launch 63
   ``render_views``, OFusion's fresh view one, and no CLI path launches a
   single render; the fresh view leaves the tracking maps as they were;
   the class's three single renders are a path of their own (one launch
   each); K10 is then held to its twins bit for bit on the TSDF loop's
   last maps, the fresh view's and the edge inputs (``render_edges``,
   ``render_view_edges``), ``render_views``' quadrants to the single
   launches' images, and timed, and the log's ``rendering`` column over
   the rendered frames of the graph and eager runs is printed with its
   split (the class's call, its read into a fresh array and through a
   pinned buffer, the PPM write);
   the same CLI run again with the class's ``eager`` keyword (its rows,
   ATE and launches equal to the graphs'), and a fresh eager pipeline and
   a fresh one on graphs over the 250 frames in turn, bit-equal every
   frame and in the map at the end, and each rendering a fresh view
   every 4th frame (on the graphs one replay of the fresh-view graph,
   ``ops/rendering.FreshView``), the composites bit-equal; on their last
   state the fresh view's host launches a render (one replay on the
   graphs, four kernel launches eagerly), host us of the call and with
   its read, the stream's us and the kernels' device us, eager, graphs,
   graphs, eager, medians of 20; it prints the log's computation a
   frame of both runs (mean, median, max) beside the aim of 0.40 ms, the
   graphs captured and their pool's bytes;
   it holds the drop counters to 0, the tracked fraction to 0.98, the ATE
   to EVAL_table.md's row plus 25 % (TSDF 0.025 m, OFusion 0.020 m), the
   renders to one PPM a rendered frame, and, for TSDF, a checkpoint saved,
   loaded into a new pipeline and run one more frame to the same frame
   without the round trip, bit for bit, and ``dump_mesh`` (triangles,
   time); it prints each ATE beside its row, the log's mean computation a
   frame, wall fps, peak device memory and, from five more frames under
   torch.profiler (taken again, up to PROFILE_TRIES times, until its
   trace shows the frame's 20 kernels and copies and the stage graphs'
   copies into the class's tensors), the device's busy
   share, and what the empty entries of its 49,152-entry bucket cost K3
   (as the noise slice's); the host-IO
   step: the
   native library built from ``native/src`` (its build time, whether it
   came from the cache; its reader equal to the Python reader on every
   frame of the loop, depth and RGB), ``dump_mesh`` through its native
   writer (``io/meshing.WRITES``; time and size), the telemetry sample
   after the TSDF run (the peak equal to ``max_memory_allocated()``, the
   limit to the card's memory), a flag whose package does not import
   refusing cleanly (``--plot-out`` without matplotlib; where matplotlib
   imports, a PNG), and where Pillow imports the served TSDF loop as a
   path of its own: a run with ``--serve`` and no control request equal
   to pipeline-tsdf's first rows, then a session driven over HTTP (the
   viewer starts paused; ``/stats`` advances, a pause holds for a second,
   ``/stream``'s JPEG decodes to the composite's size, the static view
   launches ``raycast_cold``, a reset makes the blocks fall and rise,
   drops 0, peak memory within 1.2x pipeline-tsdf's), then the loop served
   in the static view (the viewer's ``view=static`` before the first
   frame; a path of its own, every rendered frame a fresh view) on the graphs and with
   ``eager=True``: PPMs byte-equal, rows, ATE and launches equal, one
   fresh-view graph replayed on every rendered frame after the first, and
   the rendering column of both printed; then the TSDF path
   with the keyframe pose graph (``--keyframe-rate 15``, EVAL_table.md's
   BA row):
   drop counters 0, tracked fraction 0.98, ATE <= 0.0285 m, at least one
   accepted loop closure, icp_track launched once a frame plus once a
   closure try, ba_solve (K9) once a BA solve, the first closure's
   icp_track (3x gate) against its twin, and every BA solve replayed from
   its recorded arguments against the twin (poses to 1e-5) and against
   the kernel again (bit for bit); it prints the closures tried and
   accepted and, for each BA solve, the manager's host ms, the call's ms
   and the kernel's device us beside the twin's ms; then the tracked
   noise map (``tools/noise_kernels.py``), a
   path of its own: the first 60 frames of the loop with range noise
   0.002 (rendered there in four processes) through the CLI with
   the noise+levers row's options, every frame from frame 4 on tracked
   and every drop counter 0, median2 once a frame and the gated raycast
   once a frame from frame 3, and on its last frame the same checks and
   measurements of K1's gated launch and K7's median2 as the noise
   slice's;
7. dist phase: the sharded step (``parallel/dist_step.py``) as four
   Gloo ranks sharing card 0, started through ``tools/dist_run.py``
   (they load the library this process built), both fields at the bench
   config (320x240, 512^3 over 4.8 m, 36,864 / 4 = 9,216 blocks a rank,
   ICP 10/5/4, halo budget 4,096 a rank), exact and frustum halo, over
   the 43 slice frames, each rank's launch counts zeroed before each case
   and read after it: every exact-halo pose within 2e-3 of the
   single-device frame step on this card, the frustum final pose within
   5e-3 of the exact one, every drop counter 0, every rank owning blocks
   (summed and printed beside the single run's), every kernel of the
   sharded path launched (K6 icp_reduce over the rank's columns,
   icp_reduce_step and icp_update, each rank's K6 launches a frame one,
   sum(ITERATIONS) - 1 and one, K5's windowed march and owner-masked
   allocation, halo_pack, K2 on the halo, K1 over the rank's columns);
   the sharded modes against their twins on rank 1's inputs at frame 4
   (captured by the rank, checked here) and that rank's ICP of the frame
   replayed without collectives (device us, launches); it prints
   ms/frame per rank, the halo's bytes and the share of a frame blocked
   in collectives, which measure no scaling: the four ranks share one
   card;
8. prints one JSON line of per-kernel results (each with its bound: the
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

from supereight_tpu_torch.tools import bench as port_bench
from supereight_tpu_torch.tools import noise_kernels as noise_tool

# the bench configuration, the port's bench's own (tools/bench.py, a copy
# of the JAX bench's), so that the slices and the bench cannot drift apart
W, H = port_bench.W, port_bench.H
SIZE, DIM, CAPACITY = port_bench.SIZE, port_bench.DIM, port_bench.CAPACITY
BUDGET = port_bench.BUDGET  # integration worklist and raycast pool bucket
MU = port_bench.MU
K = port_bench.K
ITERATIONS = port_bench.ITERATIONS
N_WARMUP, N_FRAMES, N_TIMED = (port_bench.N_WARMUP, port_bench.N_FRAMES,
                               port_bench.N_TIMED)
# the bench scene: its orbit, map and tracking, in the form the sharded
# step's launcher takes (tools/dist_run.py), so that the single-device
# slices and the dist phase render and run the same frames
ORBIT = port_bench.scene()
N_PROFILED = 5       # timed frames replayed under torch.profiler
# ms/frame the graphed step aims at (TSDF, OFusion, tsdf-noise): the
# eager step's device busy time a frame (PERF.md) and room for the gaps
GRAPH_AIM_MS = {"tsdf": 0.30, "ofusion": 0.30, "tsdf-noise": 0.40}
PROFILE_TRIES = 5    # profiled replays before a trace that missed launches
                     # fails the run (a trace can lose every event: a
                     # pipeline's three tries on an H100 showed 20, 12
                     # and 0 of its 21 a frame)
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
# the dist phase: the sharded step (parallel/dist_step.py) as four Gloo
# ranks sharing card 0, through tools/dist_run.py, at the bench config
# a bench process of the bench phase: ~10 s of start-up, the orbit and
# 64 frames (43, then the profiled replay of 21)
BENCH_TIMEOUT_S = 300
DIST_WORLD = 4
DIST_HALO_BUDGET = 4096   # blocks a rank may send (the TSDF slice: ~7.3k)
DIST_CAPTURE = 4          # the frame whose inputs the mode checks take
DIST_POSE_TOL = 2e-3      # tests/test_dist.py:83
DIST_FRUSTUM_TOL = 5e-3   # tests/test_dist.py:96
# the sharded tracking's launches (one icp_reduce, then one
# icp_reduce_step an iteration, then one icp_update a frame)
DIST_K6 = ("icp_reduce", "icp_reduce_step", "icp_update")
DIST_DROPS = ("alloc_overflow", "blocks_truncated", "ray_overflow",
              "halo_overflow")
HALO_FLAG_OPS = 40        # halo_pack's test of a slot (two transforms ...)
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
NOISE_FACTOR = noise_tool.NOISE_FACTOR
NOISE_CAPACITY = NOISE_BUDGET = noise_tool.NOISE_BUDGET
# K3's kernel rows are checked and timed at the slice's budget and at this
# many entries: the noise row's budget and the class pipeline's bucket
# (the next power of two over its --preset-budget, PIPE_ARGS)
BUCKET = NOISE_BUDGET
NOISE_OPTIONS = noise_tool.NOISE_OPTIONS
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
# the filters of K7: the operations of one bilateral pair weight
# (difference, square, divide, exp ~10, product), of which a pixel needs
# 12 (a pair's weight serves both its pixels), and of one of its 25 taps
# (test, product, two sums)
BILATERAL_PAIR_OPS = 14
BILATERAL_TAP_OPS = 4
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
# the fresh view's graph (ops/rendering.FreshView): the graph and eager
# classes of pipeline_equal render a fresh view BACK_VIEW behind the
# raycast pose on every FRESH_RATE-th loop frame from frame 4 (the
# frames pipeline-tsdf renders), compared bit for bit; on the last state
# each render is timed FRESH_REPS times in each of four blocks (eager,
# graphs, graphs, eager); a render is FRESH_KERNELS launches eagerly (the
# prologue, K2, K1's unprimed launch, K10's render_views) and one replay
# on the graph
FRESH_RATE = 4
FRESH_REPS = 20
FRESH_KERNELS = 4
# K10 (csrc/render.cu) a pixel: the bytes its function moves (depth f32 or
# track i32 in, RGBA out; vertex, normal and valid in, RGBA out; the pose's
# light besides; render_views all three and the composite's zero quadrant)
# and its f32 operations (depth: the scale, the clamp's two tests, the
# sector's product and floor, the fraction and its complement, three
# channels, the two plane tests; track: six code tests; volume: the
# difference, its squared norm and root, the zero test, three divisions,
# the dot product, its clamp, the ambient add, its clamp and the channel)
RENDER_PIXEL_BYTES = {"render_depth": 8, "render_track": 8,
                      "render_volume": 12 + 12 + 1 + 4,
                      "render_views": 8 + 8 + 29 + 4}
RENDER_PIXEL_OPS = {"render_depth": 13, "render_track": 6,
                    "render_volume": 23, "render_views": 13 + 6 + 23}
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
# device events a pipeline frame runs (PR 15's complete pipeline-ofusion
# trace): 14 launches of the path's 12 kernels (the prologue three times)
# and 6 of the class's own (the depth's upload and its division, the time
# stamp, its host reads: one read of the block count a frame since the
# class keeps the integration's bucket for the raycast; 7 before). The
# stage graphs add their copies into the class's own tensors
# (pipeline_copies)
PIPE_EVENTS = 20
# the stage graphs' aim for the CLI's computation a frame with
# --no-stage-sync (printed, not held)
PIPE_AIM_MS = 0.40
# the BA path: the TSDF pipeline with the keyframe pose graph, as
# tools/run_longseq_eval.py's "tsdf icp+BA" row, held to that row's ATE
# (EVAL_table.md, JAX) plus 25 %; a closure try re-tracks with the 3x gate
BA_ARGS = ("--keyframe-rate", "15")
EVAL_BA_ATE = 0.0228
MAX_BA_ATE = 0.0285
CLOSURE_DIST = 0.3
# K9: the pose graph's windowed solve, held to its twin on synthetic
# windows (n nodes, E edges) and on every solve of the BA path
BA_TOL = 1e-5     # poses, kernel against twin (tests/test_torch_posegraph.py)
BA_ITERS = 10     # posegraph/keyframes.KeyframeManager.optimize's
BA_WINDOWS = tuple((n, e) for e in (128, 200) for n in (4, 17, 32, 64))
BA_ROW = (17, 128)  # the kernels line's window (the loop solves n = 4-16)
BA_LARGE = (160, 256, 512)  # Tier L's windows, 2n slots each
BA_TIMED_NODES = 160  # past it a window's kernel is timed on one call
# the fewest f32 operations an edge needs over the branches of
# csrc/ba.cu's dual-number pass: its residual and the derivatives'
# coefficients once (literal operands folded), its 12 Jacobian columns'
# nonzero tangents, and its terms of H's upper triangle and of b (a
# product and a sum for each pair of nonzero Jacobian entries).
# tests/test_torch_ba.py's model of the pass counts them and holds this
BA_EDGE_OPS = 2850
BA_EDGE_BYTES = 4 + 4 + 64 + 4 + 1  # i, j, t_meas, weight, valid
# the host-IO step: the served TSDF loop. A run of SERVED_FRAMES
# frames without controls must log pipeline-tsdf's first SERVED_FRAMES
# rows; then a session whose viewer starts paused is driven over HTTP. It
# runs with --groundtruth-mode: after a reset past frame 3 the new
# pipeline has no raycast to track against, so in ICP mode its map stays
# empty (JAX's semantics, copied); ground-truth poses let it grow again.
# A reset frees the first pool before it builds the second, so the
# session's peak memory stays within SERVED_PEAK_RATIO of pipeline-tsdf's.
SERVED_FRAMES = 40
SERVE_DEADLINE = 120.0   # s for any one state of the session
SERVE_POLL = 0.005       # s between /stats reads while waiting
PAUSE_HOLD = 1.0         # s a pause must hold the frame count
SERVED_PEAK_RATIO = 1.2
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
    # the sharded step's modes (dist phase)
    "icp_reduce_step": ("supereight_tpu_torch/csrc/icp.cu",
                        "supereight_tpu/ops/tracking.py:286"),
    "icp_update": ("supereight_tpu_torch/csrc/icp.cu",
                   "supereight_tpu/ops/tracking.py:293"),
    "alloc_touch_cols": ("supereight_tpu_torch/csrc/alloc.cu",
                         "supereight_tpu/parallel/dist_step.py:310"),
    "alloc_touch_of_cols": ("supereight_tpu_torch/csrc/alloc.cu",
                            "supereight_tpu/parallel/dist_step.py:304"),
    "alloc_assign_owned": ("supereight_tpu_torch/csrc/alloc.cu",
                           "supereight_tpu/parallel/dist_step.py:313"),
    "halo_pack": ("supereight_tpu_torch/csrc/integrate.cu",
                  "supereight_tpu/parallel/dist_step.py:190"),
    "raycast_cols": ("supereight_tpu_torch/csrc/raycast.cu",
                     "supereight_tpu/parallel/dist_step.py:415"),
    "raycast_cols_of": ("supereight_tpu_torch/csrc/raycast.cu",
                        "supereight_tpu/parallel/dist_step.py:415"),
    # the pose graph's windowed solve (the BA path)
    "ba_solve": ("supereight_tpu_torch/csrc/ba.cu",
                 "supereight_tpu/posegraph/graph.py:132"),
    # the visualization renders (the CLI's rendered frames, a fresh view)
    "render_depth": ("supereight_tpu_torch/csrc/render.cu",
                     "supereight_tpu/ops/rendering.py:39"),
    "render_track": ("supereight_tpu_torch/csrc/render.cu",
                     "supereight_tpu/ops/rendering.py:64"),
    "render_volume": ("supereight_tpu_torch/csrc/render.cu",
                      "supereight_tpu/ops/rendering.py:77"),
    # a rendered frame's three renders in the viewer's composite
    "render_views": ("supereight_tpu_torch/csrc/render.cu",
                     "supereight_tpu/ops/rendering.py:39"),
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
    "icp_reduce_step": "no call runs a Gauss-Newton step with a freeze, "
                       "nor a gather plus 28 Gram sums",
    "icp_update": "no call runs a Gauss-Newton step with a freeze",
    "alloc_touch_cols": "no call marches rays into a grid",
    "alloc_touch_of_cols": "no call marches rays into a grid",
    "alloc_assign_owned": "no call bump-allocates a pool; nonzero would "
                          "size its output on the host",
    "halo_pack": "nonzero would size its output on the host",
    "raycast_cols": "no call marches rays through a sparse grid",
    "raycast_cols_of": "no call marches rays through a sparse grid",
    "ba_solve": "no call runs a Gauss-Newton loop",
    "render_depth": "none: no call maps a depth to the rainbow with its "
                    "plane tests",
    "render_track": "none: a colour table's index_select would take the "
                    "codes' rows from a computed index, not the codes",
    "render_volume": "none: no call shades a vertex and normal map",
    "render_views": "none: no call computes any of its three renders",
}
# device kernel names (without "_kernel") reported from the profile, and
# the frame_step stage that launches each (icp_reduce's kernel runs its
# icp_reduce_step mode too); the OFusion instantiations are
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
    # (K10's render_views, one a rendered frame: TSDF's every 4th frame;
    # each field's fresh view)
    "pipeline-tsdf": ("pyramid", "frame_mats", "icp_track", "alloc_touch",
                      "alloc_assign", "integrate_worklist", "integrate_fused",
                      "integrate_fallback", "node_rank", "node_pass",
                      "nav_grid", "raycast", "raycast_cold", "render_views"),
    "pipeline-ofusion": ("pyramid", "frame_mats", "icp_track",
                         "alloc_touch_of", "alloc_assign",
                         "integrate_worklist", "integrate_fused_of",
                         "integrate_fallback_of", "node_rank", "node_pass",
                         "nav_grid", "raycast_of", "raycast_cold_of",
                         "render_views"),
    # the class's three single renders (JAX's render_depth, render_track
    # and render_volume) on the TSDF loop's last state
    "renders": ("render_depth", "render_track", "render_volume"),
    # the tracked noise map: the CLI with the noise+levers row's options
    # over the first frames of the noisy loop (tools/noise_kernels.py),
    # rendering every 4th frame
    "pipeline-tsdf-levers": ("median2", "pyramid", "frame_mats",
                             "icp_track", "alloc_touch", "alloc_assign",
                             "integrate_worklist", "integrate_fused_noise",
                             "integrate_fallback_noise", "node_rank",
                             "node_pass", "nav_grid", "raycast_gated",
                             "render_views"),
    # the TSDF pipeline with keyframes: the loop-closure re-tracks are
    # icp_track and frame_mats launches too, and each BA solve one
    # ba_solve; it renders every 4th frame
    "pipeline-tsdf-ba": ("pyramid", "frame_mats", "icp_track",
                         "alloc_touch", "alloc_assign", "integrate_worklist",
                         "integrate_fused", "integrate_fallback",
                         "node_rank", "node_pass", "nav_grid", "raycast",
                         "ba_solve", "render_views"),
    # the served TSDF loop (host-IO step): a run without controls, then the
    # controlled session, whose static view is K1's unprimed launch
    "served": ("pyramid", "frame_mats", "icp_track", "alloc_touch",
               "alloc_assign", "integrate_worklist", "integrate_fused",
               "integrate_fallback", "node_rank", "node_pass", "nav_grid",
               "raycast", "raycast_cold", "render_views"),
    # the served TSDF loop in its static view on the stage graphs: every
    # rendered frame a fresh view, one replay of the fresh-view graph
    "served-static": ("pyramid", "frame_mats", "icp_track", "alloc_touch",
                      "alloc_assign", "integrate_worklist",
                      "integrate_fused", "integrate_fallback", "node_rank",
                      "node_pass", "nav_grid", "raycast", "raycast_cold",
                      "render_views"),
    # the library surface: allocate_blocks over a sphere shell
    "library": ("alloc_assign",),
    # the sharded step, four ranks on one card (the dist phase)
    "dist-tsdf": ("pyramid", "frame_mats", "icp_reduce", "icp_reduce_step",
                  "icp_update", "alloc_touch_cols", "alloc_assign_owned",
                  "integrate_worklist", "integrate_fused",
                  "integrate_fallback", "node_rank", "node_pass",
                  "halo_pack", "nav_grid", "raycast_cols"),
    "dist-ofusion": ("pyramid", "frame_mats", "icp_reduce",
                     "icp_reduce_step", "icp_update",
                     "alloc_touch_of_cols", "alloc_assign_owned",
                     "integrate_worklist", "integrate_fused_of",
                     "integrate_fallback_of", "node_rank", "node_pass",
                     "halo_pack", "nav_grid", "raycast_cols_of"),
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


def device_us(torch, fn, reps, per_call=None, name=None):
    """Device microseconds per call of fn() from torch.profiler: the sum
    of the kernels and copies it runs (with ``name``, of those whose name
    holds it), over reps calls. The device trace
    misses the first launches after it starts (1 to 5 of 20 on the H100),
    so where ``per_call``, the kernels and copies one call runs, is known,
    the sum is averaged over the calls the trace shows, not over reps. A
    trace that shows no device work at all (seen once: a K1 window
    read 0.0 us) is taken again, up to PROFILE_TRIES times, and fails
    after that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and (name is None or name in e.key)]
        seen = sum(e.count for e in events)
        if seen:
            break
    require(seen > 0, "device_us: the trace showed no device work")
    calls = seen / per_call if per_call else reps
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


def ba_bound(n, cap, edges, iters=BA_ITERS):
    """K9's bound for one solve over n nodes and ``edges`` valid edges of
    ``cap`` slots: the poses, the slots and the fixed flags read once and
    the poses written once; the valid edges' residuals, Jacobian columns
    and normal equations (BA_EDGE_OPS; a padded slot's terms are zeros),
    the factorisation
    ((6n)^3 / 3) and the two substitutions (2 (6n)^2), ``iters`` times.
    Its chain floor is iters x ceil(6n / 32) panels (``chain_panels``;
    csrc/ba.cu's note: each a 32-step pivot chain in one warp, a 32-step
    column solve and a backward panel, with their barriers)."""
    from supereight_tpu_torch.kernels.ba import PANEL
    n6 = 6 * n
    n_bytes = 2 * 64 * n + n + cap * BA_EDGE_BYTES
    n_ops = iters * (edges * BA_EDGE_OPS + n6 ** 3 / 3 + 2 * n6 ** 2)
    return dict(**bound(n_bytes, n_ops), chain_panels=iters * -(-n6 // PANEL))


def ba_errors(torch, tag, got, want, poses, fixed):
    """The kernel's poses against the twin's: NaN in the same places,
    within BA_TOL elsewhere, node 0 and the fixed nodes bit-equal to their
    input wherever the solve is finite. Returns the max error."""
    nan = torch.isnan(got)
    require(torch.equal(nan, torch.isnan(want)),
            f"{tag}: NaN where the twin has none, or none where it has")
    err = (got - want)[~nan].abs().max().item() if not nan.all() else 0.0
    require(err <= BA_TOL, f"{tag}: poses {err:.3e} off the twin's")
    if not nan.any():
        held = torch.zeros(poses.shape[0], dtype=torch.bool,
                           device=poses.device)
        held[0] = True
        if fixed is not None:
            held |= fixed
        require(torch.equal(got[held], poses[held]),
                f"{tag}: a fixed node moved")
    return err


def ba_times(torch, args):
    """K9 on ``args`` (ba_solve's): the call's ms over 10 calls (one past
    BA_TIMED_NODES nodes) and the twin's over one (CUDA events), the
    kernel's device us over as many launches (torch.profiler, the kernel
    alone)."""
    from supereight_tpu_torch.kernels import ba
    reps = 10 if args[2] <= BA_TIMED_NODES else 1
    return dict(ms=cuda_ms(torch, lambda: ba.ba_solve(*args), reps),
                device_us=device_us(torch, lambda: ba.ba_solve(*args),
                                    max(reps, 2), 1, name="ba_solve"),
                plain_ms=cuda_ms(torch, lambda: ba.ba_solve_plain(*args), 1))


def check_ba_solve(torch, tag, poses, graph, n, fixed):
    """K9 ba_solve against its twin on one window: :func:`ba_errors`, one
    launch a call and two calls bit-identical; the call's ms and the
    twin's (CUDA events) and the kernel's device us (torch.profiler).
    Returns the kernel's row."""
    from supereight_tpu_torch.kernels import _lib, ba
    args = (poses, graph, n, BA_ITERS, 1e-6, fixed)
    before = _lib.LAUNCHES["ba_solve"]
    got = ba.ba_solve(*args)
    require(_lib.LAUNCHES["ba_solve"] == before + 1,
            f"{tag}: ba_solve launched {_lib.LAUNCHES['ba_solve'] - before} "
            f"times in one call")
    want = ba.ba_solve_plain(*args)
    err = ba_errors(torch, tag, got, want, poses, fixed)
    require(torch.equal(got.nan_to_num(), ba.ba_solve(*args).nan_to_num()),
            f"{tag}: two launches differ")
    from supereight_tpu_torch.tools.ba_windows import cholesky_ms
    e = graph.i.shape[0]
    row = dict(max_abs_err=err, tier=ba.plan(n, e, poses.device).tier,
               **ba_times(torch, args),
               **ba_bound(n, e, int(graph.valid.sum())),
               cholesky_ms=cholesky_ms(6 * n, BA_ITERS))
    print(f"{tag}: n {n}, E {e}, valid {int(graph.valid.sum())}, tier "
          f"{row['tier']}: poses max err {err:.3e} (<= {BA_TOL}), NaN "
          f"{bool(torch.isnan(got).any())}; call {row['ms']:.4f} ms, "
          f"device {row['device_us']:.1f} us "
          f"({row['device_us'] / row['chain_panels']:.3f} us a panel of "
          f"{row['chain_panels']}), twin {row['plain_ms']:.1f} ms; bound "
          f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}); the factor's "
          f"yardstick cholesky_ex + cholesky_solve x {BA_ITERS} "
          f"{row['cholesky_ms']:.4f} ms")
    return row


def ba_phase(torch, dev, card):
    """K9 on the synthetic windows (BA_WINDOWS; Tier S's largest window
    and one node more with twice as many slots, and BA_LARGE in Tier L),
    the gauge-less one and one with a NaN in a padded slot. Returns the
    kernels line's row: BA_ROW's window, every window's under "windows",
    the largest error of all."""
    from supereight_tpu_torch.kernels import ba
    from supereight_tpu_torch.tools import ba_windows
    rows = {}
    s_max = ba.tier_s_nodes(dev)
    windows = BA_WINDOWS + tuple((n, 2 * n) for n in (s_max, s_max + 1)
                                 + BA_LARGE)
    for seed, (n, e) in enumerate(windows):
        poses, graph, fixed = ba_windows.window(n, e, seed, dev)
        rows[f"{n}x{e}"] = check_ba_solve(torch, f"ba_solve window {n}x{e}",
                                          poses, graph, n, fixed)
    require(rows[f"{s_max}x{2 * s_max}"]["tier"] == "S"
            and rows[f"{s_max + 1}x{2 * s_max + 2}"]["tier"] == "L",
            f"ba_solve: Tier S's edge is not at {s_max} nodes")
    poses, graph, fixed = ba_windows.gaugeless(dev)
    rows["gaugeless"] = check_ba_solve(torch, "ba_solve gauge-less window",
                                       poses, graph, 6, fixed)
    poses, graph, fixed = ba_windows.nan_slot(6, 12, 1, dev)
    rows["nan_slot"] = check_ba_solve(torch, "ba_solve NaN padded slot",
                                      poses, graph, 6, fixed)
    require(bool(torch.isnan(ba.ba_solve(poses, graph, 6, BA_ITERS, 1e-6,
                                         fixed)).all()),
            "ba_solve NaN padded slot: a pose is not NaN")
    row = dict(rows["%dx%d" % BA_ROW])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    row["windows"] = {k: {x: r[x] for x in (
        "tier", "ms", "device_us", "plain_ms", "bound_ms", "chain_panels",
        "cholesky_ms")} for k, r in rows.items()}
    print(f"ba_solve: Tier S up to {s_max} nodes; "
          f"{json.dumps(row['windows'])} ({card})")
    return row


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
    # of the frame_step/* annotations and (under a replayed CUDA graph) of
    # the profiler's ProfilerStep#, which are spans and not work
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("frame_step/", "ProfilerStep"))]
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


def rendered_frames(argv, frames):
    """The frames a CLI run of ``argv`` over ``frames`` frames renders:
    every ``-z``-th from frame 4 (the last ``-z`` given)."""
    argv = list(argv)
    rate = int(argv[len(argv) - argv[::-1].index("-z")])
    return sum(1 for f in range(frames) if rate and f % rate == 0 and f > 2)


def require_views(tag, launches, frames=None):
    """A CLI path's K10: ``render_views`` once a rendered frame
    (``frames`` launches where given, else at least one) and no single
    render."""
    n = launches["render_views"]
    singles = {k: launches[k] for k in PATHS["renders"]}
    require((n > 0 if frames is None else n == frames)
            and not any(singles.values()),
            f"{tag}: K10 launched render_views {n} times (rendered frames "
            f"{frames}) and the single renders {singles}")


clone_map = port_bench.clone_map
clone_frame_state = port_bench.clone_state


class Scene:
    """The bench scene and a frame runner for one field on the card
    (``tools/bench.config``); with ``noisy`` the tsdf-noise slice: the
    orbit's frames noised (frame i with seed i, made before any timing),
    the eval row's pool, budget and options."""

    def __init__(self, torch, field, dev, noisy=False):
        b = noise_tool.slice_config(dev) if noisy \
            else port_bench.config(field.name, dev, capacity=CAPACITY)
        self.torch, self.bench = torch, b
        self.field, self.mu, self.dev = field, b.kw["mu"], dev
        self.noisy = noisy
        self.name = field.name + ("-noise" if noisy else "")
        self.geom, self.kt, self.kw = b.geom, b.k, b.kw
        self.n_total = len(b.frames)
        self.depths, self.poses, self.depths_t = b.depths, b.poses, b.frames
        self.budget = b.kw["budget"]
        self.options = NOISE_OPTIONS if noisy else {}

    def init(self):
        return self.bench.init()

    def frame(self, state, i):
        # frame_step must enqueue without reading anything back: a
        # synchronising call inside it raises here
        self.torch.cuda.set_sync_debug_mode("error")
        try:
            return self.bench.frame(state, i)
        finally:
            self.torch.cuda.set_sync_debug_mode("default")

    def run_frames(self, n):
        state = self.init()
        for i in range(n):
            state, _ = self.frame(state, i)
        return state

    def graph_frame(self, prog, i):
        # the capture and every replay enqueue without reading anything
        # back, as the eager step
        self.torch.cuda.set_sync_debug_mode("error")
        try:
            return self.bench.graph_frame(prog, i)
        finally:
            self.torch.cuda.set_sync_debug_mode("default")


def alloc_bound(torch, geom, depth, pose, kpose, mu, x_offset=0):
    """K5 alloc_touch: the 2x2-sampled depth read once and the sectors
    holding a touched cell written once (the grid is zero before the
    march, so no other byte must move), counted from this run's grid (the
    twin's, equal to the kernel's); per valid sampled pixel the ray setup
    (~40 operations) and ~13 per band sample (csrc/alloc.cu). ``depth``
    may be a column window of the frame from column ``x_offset``."""
    from supereight_tpu_torch.kernels import alloc
    _, num_steps, _ = alloc.band_schedule(geom, mu)
    rays = int((depth[::2, ::2] > 0).sum())
    grid = alloc.touched_mask_plain(geom, depth, pose, kpose, mu, x_offset)
    return bound(rays * 4 + SECTOR * set_sectors(torch, (grid,)) + 2 * 64,
                 rays * (40 + 13 * num_steps))


def alloc_of_bound(torch, geom, depth, pose, kpose, mu, x_offset=0):
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
                                          mu, x_offset)
        rays += int(valid.sum())
        samples += int((ts[:, None] < dist[valid][None, :]).sum())
    grids = alloc.touched_masks_of_plain(geom, depth, pose, kpose, mu, None,
                                         x_offset)
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
                     bilinear=False, budget=None):
    """K3's three launches against their twins on two copies of ``m``,
    fusing ``depth`` at ``pose`` stamped ``ts`` under a true ``when``, at a
    worklist of ``budget`` entries (the slice's by default): the
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
    budget = sc.budget if budget is None else budget
    h, w = depth.shape
    t_cw, kmat = se3.inverse(pose), se3.camera_matrix(sc.kt)
    when = torch.ones((), dtype=torch.bool, device=dev)
    wl_args = (geom, m, t_cw, kmat, (w, h), budget, when)
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
          f"{budget}), blocks_truncated {int(wk[2])}, {wl_mism} "
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
    size = dict(entries=budget, listed=nb)
    rows = {
        "integrate_worklist": (
            dict(max_abs_err=float(wl_mism), **size, **bound(
                n_blk + 12 * n_act + 4 * budget + 12 + 2 * 64,
                n_act * PROJECT_OPS)),
            lambda: ki.integrate_worklist(*wl_args),
            lambda: ki.integrate_worklist_plain(*wl_args)),
        ki.fused_name(field, *mode_kw): (
            dict(max_abs_err=e_f, **size, **bound(
                13 * budget + 13 * nb + 8 * nv_cov + 8 * changed(fused, m)
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
            dict(max_abs_err=max(e_b, float(b_mism)), **size, **bound(
                budget + 8 * counts["need"] + 17 * counts["fallback"]
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


def probe_stats(probes):
    """The march's probes from the twin's record (``kernels/raycast.py``
    ``Probes``; ``tools/noise_kernels.probe_stats``: the mean, percentiles
    and largest count a ray, the total, the sum over the kernel's warps
    (8 x 4 pixel tiles) of each warp's largest count (the probes a warp in
    lockstep takes), the longest ray's probes by kind), and the distinct
    nav entries and pool voxels read."""
    return dict(noise_tool.probe_stats(probes), nav=int(probes.nav.sum()),
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
    st = probe_stats(probes)
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


def render_edges(np, seed=27):
    """K10's edge inputs as numpy arrays: ``depth`` f32[257, 256], every
    u16 millimetre depth / 1000, then the planes and their f32
    neighbours, zeros after; ``track`` i32[48, 64], the codes -7 to 3 in
    turn; the shading maps ``vertex``, ``normal`` f32[48, 64, 3] and
    ``valid`` bool[48, 64] under ``pose`` f32[4, 4] (its light at
    ``pose[:3, 3]``) or ``light`` f32[3], pixel p of kind p % 4: its
    vertex at the pose's light (a zero distance), its normal facing away
    (shade < 0), facing the light (shade + 0.1 clamps at 1), or random;
    ``valid`` a checkerboard of False."""
    from supereight_tpu_torch.constants import FAR_PLANE, NEAR_PLANE
    rng = np.random.default_rng(seed)
    planes = [np.float32(p) for p in (NEAR_PLANE, FAR_PLANE)]
    planes += [np.nextafter(p, np.float32(s)) for p in planes
               for s in (-np.inf, np.inf)]
    depth = np.zeros(257 * 256, np.float32)
    values = np.concatenate([np.arange(65536, dtype=np.float32)
                             / np.float32(1000.0), planes])
    depth[:values.size] = values
    track = np.resize(np.arange(-7, 4, dtype=np.int32), (48, 64))
    h, w = 48, 64
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.3, -0.2, 1.5)
    vertex = rng.uniform(-2.0, 2.0, (h * w, 3)).astype(np.float32)
    normal = rng.normal(size=(h * w, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    kind = np.arange(h * w) % 4
    vertex[kind == 0] = pose[:3, 3]
    to = vertex.astype(np.float64) - pose[:3, 3]
    to /= np.maximum(np.linalg.norm(to, axis=1, keepdims=True), 1e-12)
    normal[kind == 1] = -to[kind == 1]
    normal[kind == 2] = to[kind == 2]
    i, j = np.indices((h, w))
    return dict(depth=depth.reshape(257, 256), track=track,
                vertex=vertex.reshape(h, w, 3),
                normal=normal.astype(np.float32).reshape(h, w, 3),
                valid=(i + j) % 2 == 1, pose=pose,
                light=np.array([-0.4, 0.9, 0.25], np.float32))


def render_view_edges(np, seed=27):
    """:func:`render_edges` at one shape, the depth's [257, 256], for the
    launch that takes all three renders' inputs (``render_views``): the
    track codes and the shading maps repeated in their flat order to that
    size, so that each still holds all its cases."""
    e = render_edges(np, seed)
    hw = e["depth"].shape
    return dict(e, track=np.resize(e["track"], hw),
                vertex=np.resize(e["vertex"], hw + (3,)),
                normal=np.resize(e["normal"], hw + (3,)),
                valid=np.resize(e["valid"], hw))


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
            st = probe_stats(probes)
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
    multiplying with a reciprocal: ulps), the bilateral also on a noisy
    640x480 loop frame and on a 333x251 crop of it (no multiple of a
    tile's 28 output columns or its rows). Returns their rows, each bound
    by the depth read once and the filtered depth written once, or by its
    operations (the bilateral's 12 pair weights and 25 taps a pixel)."""
    from supereight_tpu_torch.kernels import preprocess as pre
    h, w = depth.shape
    rows = {}
    for name, call, plain, tol, ops in (
            ("bilateral", lambda: pre.bilateral_filter(depth),
             lambda: pre.bilateral_filter_plain(depth), 1e-5,
             12 * BILATERAL_PAIR_OPS + 25 * BILATERAL_TAP_OPS + 2),
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
    loop = noise_tool.loop_depth(depth.device)
    for d in (loop, loop[:251, :333].contiguous()):
        got, want = pre.bilateral_filter(d), pre.bilateral_filter_plain(d)
        err = (got - want).abs().max().item()
        print(f"K7 bilateral (loop frame {noise_tool.BILATERAL_FRAME}, "
              f"noisy): {d.shape[1]}x{d.shape[0]}, {int((d == 0).sum())} "
              f"zero pixels; max err against the twin {err:.3e} (<= 1e-5), "
              f"bit-equal {bool(torch.equal(got, want))}")
        require(err <= 1e-5 and bool((want != d).any()),
                f"K7 bilateral at {d.shape[1]}x{d.shape[0]} disagrees "
                f"with twin")
        merge_errs(rows, {"bilateral": err})
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


def timed_k3(torch, row, call, plain, tag):
    """A K3 row with its call and twin timed (CUDA events over
    KERNEL_REPS and TWIN_REPS back-to-back calls) and the kernel's device
    us a launch (torch.profiler over 20)."""
    row = dict(row, ms=cuda_ms(torch, call, KERNEL_REPS),
               plain_ms=cuda_ms(torch, plain, TWIN_REPS),
               device_us=device_us(torch, call, 20, 1))
    print(f"{tag}: {row['entries']} entries, {row['listed']} listed: device "
          f"{row['device_us']:.2f} us/launch, call {row['ms']:.4f} ms, twin "
          f"{row['plain_ms']:.4f} ms; bound {row['bound_ms'] * 1e3:.3f} us "
          f"({row['bound_by']})")
    return row


def k3_rows(torch, sc, m, pose, depth, ts, tag, noise=False,
            bilinear=False):
    """:func:`check_block_pass` at the slice's budget and at BUCKET
    entries, each kernel timed at both (:func:`timed_k3`): the first's
    rows, each with the bucket's under "bucket" and the larger error of
    the two."""
    mode = (f", {'noise' if noise else ''}{'+' if noise and bilinear else ''}"
            f"{'bilinear' if bilinear else ''}" if noise or bilinear else "")
    rows = {}
    for budget in (sc.budget, BUCKET):
        checked, _ = check_block_pass(
            torch, sc, m, pose, depth, ts, f"K3 ({tag}{mode}, {budget} "
            f"entries)", noise, bilinear, budget)
        for name, (row, call, plain) in checked.items():
            row = timed_k3(torch, row, call, plain,
                           f"{name} ({tag}, {budget} entries)")
            if name not in rows:
                rows[name] = row
            else:
                rows[name]["bucket"] = row
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                row["max_abs_err"])
    return rows


def option_rows(torch, sc, m, pose, depth, ts, tag):
    """K3's noise-grade modes on the map the allocator made for ``depth``
    (:func:`k3_rows`): TSDF the noise weight, the bilinear read and both;
    OFusion the bilinear read."""
    _, _, _, m_alloc, _ = check_alloc(torch, sc, m, pose, depth,
                                      f"K5 alloc_assign ({tag}, modes)")
    modes = (((True, False), (False, True), (True, True))
             if sc.field.name == "tsdf" else ((False, True),))
    rows = {}
    for noise, bilinear in modes:
        checked = k3_rows(torch, sc, m_alloc, pose, depth, ts, tag, noise,
                          bilinear)
        rows.update((k, v) for k, v in checked.items()
                    if k != "integrate_worklist")
    return rows


def new_kernel_rows(torch, sc, m, pose, depth, ts, tag):
    """K5's allocator, then K3's three launches on the map it made
    (:func:`check_alloc`, :func:`k3_rows`), K4 and K7 against their twins
    (:func:`check_node_pass`, :func:`check_pyramid`), each with its call
    and its twin's timed: the kernel over 50 back-to-back calls, the twin
    over 5."""
    row, call, plain, m_alloc, _ = check_alloc(
        torch, sc, m, pose, depth, f"K5 alloc_assign ({tag})")
    checked = {"alloc_assign": (row, call, plain)}
    checked.update(check_node_pass(torch, sc, m, pose, depth, ts,
                                   f"K4 node_pass ({tag})"))
    checked["pyramid"] = check_pyramid(torch, depth, f"K7 pyramid ({tag})")
    rows = k3_rows(torch, sc, m_alloc, pose, depth, ts, tag)
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
    # timed in the dist phase, where the path launches it (a rank's window)
    rows["icp_reduce"] = dict(max_abs_err=(red_k - red_p).abs().max().item())

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
    """K8: each gather form against its twin, bit for bit, and the kernel,
    its twin and the library call timed, at the probe's shapes (the
    returned rows) and at the brick pool's (each row's ``pool``), on the
    cases and with the meter of ``tools/probe_gather.py --time``; the
    probe path checks the kernels against the probe's numpy expectation.
    At the pool's shapes A and D are timed on ``probe_gather.cold_bricks``
    taken in turn, and C on ``probe_gather.cold_tables``: back to back on
    one input, A's and D's 16.8 MB of rows and C's 33.6 MB of table and
    index would come from L2 and beat the device-memory bound.
    """
    from supereight_tpu_torch.tools import probe_gather as pg
    from supereight_tpu_torch.tools import sharded_kernels as sk
    def timer(fn, kernel, per_call=1):
        """The tool's meter; where every trace it takes drops launches,
        the time is reported as not measured (None) and the phase goes on:
        the profiler, not the kernel, failed."""
        try:
            return sk.kernel_us(fn, kernel, per_call=per_call)
        except RuntimeError as e:
            print(f"K8: device time not measured: {e}")
            return None, None, None

    def us_text(us, sign=""):
        return "not measured" if us is None else f"{us:{sign}.2f}"

    def above(us, floor):
        return None if us is None or floor is None else us - floor
    # the card's launch floor under the same meter: the device time of
    # the least kernel, a one-element fill
    one = torch.zeros(1, device=dev)
    floor_us = timer(lambda: one.zero_(), "")[0]
    print(f"K8: launch floor, a one-element zero_(): {us_text(floor_us)} "
          f"device us/call")
    rows = {}
    for shape, case, key, kernel, plain, tables, sets in pg.cases(dev):
        calls = pg.pairs(tables, sets)
        err, exact = 0.0, True
        for tt, it in calls:
            got, ref = kernel(tt, it), plain(tt, it)
            err = max(err, (got - ref).abs().max().item())
            exact &= bool(torch.equal(got, ref))
            require(torch.equal(pg.LIBRARY[key](tt, it, it.long()), ref),
                    f"K8 {case}, {shape}: library call")
        print(f"K8 {case}, {shape}: {tuple(got.shape)} x {len(calls)}, "
              f"bit-exact against twin: {exact}")
        require(exact, f"K8 {case} is not bit-exact at the {shape}'s shapes")
        # the kernels line's rows: each form at the probe's shapes, and at
        # the pool's B as it is and A, C and D cold
        if not (case.endswith("_cold") or case in PATHS["probe"] and (
                shape == "probe" or case == "gather_b")):
            continue
        r = pg.time_case(key, kernel, plain, tables, sets,
                         [("change", None)], timer)
        us = r["builds"]["change"][0]["us"][0]
        lib_us = r["library"][0]
        # bytes: the distinct table elements read, the index, the output
        row = dict(max_abs_err=err, **bound(r["bytes"], 0), device_us=us,
                   plain_device_us=r["twin"][0], library_device_us=lib_us,
                   launch_floor_us=floor_us,
                   share=None if us is None else r["bound_us"] / us,
                   **({"sector_floor_us": r["sector_us"]}
                      if "sector_us" in r else {}))
        if shape == "probe":
            tt, it = calls[0]
            it64 = it.long()
            row.update(
                ms=cuda_ms(torch, lambda: kernel(tt, it), 200),
                plain_ms=cuda_ms(torch, lambda: plain(tt, it), 200),
                library_ms=cuda_ms(
                    torch, lambda: pg.LIBRARY[key](tt, it, it64), 200))
            rows[key] = row
            print(f"K8 {key}: call {row['ms']:.4f} ms, twin "
                  f"{row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms")
        else:
            rows[key]["pool"] = row
        share = "not measured" if us is None else f"{row['share']:.1%}"
        print(f"K8 {case}, {shape}: device {us_text(us)} us/call, twin "
              f"{us_text(row['plain_device_us'])} us/call, library "
              f"{us_text(lib_us)} us/call (medians of {sk.REPS}); bound "
              f"{r['bound_us']:.3f} us, share {share}"
              + (f" (sector floor {r['sector_us']:.3f} us)"
                 if "sector_us" in r else "") + "; above the launch "
              f"floor {us_text(above(us, floor_us), '+')} us, the library "
              f"call {us_text(above(lib_us, floor_us), '+')} us")
    return rows


def expected_launches(sc):
    """The launches of a slice's 43 frames: the pyramid, the whole
    tracking step, the node pass and the nav grid one a frame (the
    reduction alone is no longer on the path); K5's allocator and K3's
    three launches once a frame each; the prologue twice; on the noise
    slice the filter and the gated raycast once a frame."""
    from supereight_tpu_torch.kernels import integrate as ki
    noise = sc.options.get("noise_weighted", False)
    n = sc.n_total
    expect = {"icp_track": n, "node_pass": n, "pyramid": n, "nav_grid": n,
              "icp_reduce": 0, "icp_reduce_step": 0, "icp_update": 0,
              "alloc_assign": n, "integrate_worklist": n,
              ki.fused_name(sc.field, noise): n,
              ki.fallback_name(sc.field, noise): n,
              "frame_mats": 2 * n, "node_rank": n}
    if sc.noisy:
        expect.update(median2=n, raycast_gated=n)
    return expect


def slice_phase(torch, sc, card):
    """The main path of one field: 43 frames with the launch counts zeroed
    just before and read just after; then K6 icp_track against its twin
    on every frame's tracking inputs, and K6, K4 and K7 against their
    twins on the last frame's. Returns the path's launch counts, per
    kernel the largest error of those checks, and the slice's blocks,
    final position error, ms/frame and last tracked flag."""
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
    noise = sc.options.get("noise_weighted", False)
    expect = expected_launches(sc)
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
    n_exact, n_twice, worst, mip_bad, mats_bad = 0, 0, 0.0, 0, 0
    seen = []  # each frame's pose, for the noise slice's comparison
    state = sc.init()
    # the touched buffer's set bytes over every frame's end, summed on the
    # device and read once after the slice
    left = torch.zeros((), dtype=torch.int64, device=sc.dev)
    for i in range(sc.n_total):
        args = track_args(torch, sc, state, sc.depths_t[i])
        dense = state.map._replace(
            mip_alloc=tuple(a.clone() for a in state.map.mip_alloc))
        first = icp.icp_track(*args, ITERATIONS, 1e-5)
        pose_t, tracked_t = first[:2]
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
        # the frame step's launch against the one before it, bit for bit
        n_twice += all(torch.equal(x, y) for x, y in zip(got, first))
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
          f"{sc.n_total} frames, equal to it bit for bit on {n_exact}, two "
          f"launches bit-identical on {n_twice} (== {sc.n_total}); pose "
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
    require(n_twice == sc.n_total,
            f"{tag}: two icp_track launches differ on a frame")
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
    noise_map = None
    if sc.noisy:
        empty_cta_cost(torch, sc.geom, sc.field, m_alloc, state.pose, sc.kt,
                       fuse, sc.mu, ts, sc.budget, noise, last)
        noise_map = check_noise_map(
            torch, noise_tool.slice_inputs(sc.bench, state), last)
    return {k: launches[k] for k in path}, errs, dict(
        n_blocks=n_blocks, pos_err=pos_err, ms_frame=ms_frame,
        tracked=tracked[-1], noise_map=noise_map)


def timed_slice(torch, sc, start, frame):
    """One run of the slice's frames: ``start()`` sets up the state, then
    ``frame(i)`` runs frame i; the launch counts are zeroed just before
    the frames and read just after, and CUDA events time the window of
    the N_TIMED frames from N_WARMUP + N_FRAMES on (one event at each
    frame's start, one after the last). Returns the window's ms/frame,
    the frames' ms and the host's seconds inside each call of the window
    (both sorted), and the launches."""
    from supereight_tpu_torch.kernels import _lib
    first = N_WARMUP + N_FRAMES
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(N_TIMED + 1)]
    host = []
    start()
    torch.cuda.synchronize()
    _lib.reset_launches()
    for i in range(sc.n_total):
        if i >= first:
            marks[i - first].record()
        t0 = time.perf_counter()
        frame(i)
        if i >= first:
            host.append(time.perf_counter() - t0)
    marks[-1].record()
    launches = dict(_lib.LAUNCHES)
    torch.cuda.synchronize()
    frame_ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    return (marks[0].elapsed_time(marks[-1]) / N_TIMED, frame_ms,
            sorted(host), launches)


def graph_phase(torch, sc, card, sl):
    """The slice through the frame program (``parallel/step.
    FrameProgram``: the frame step captured once as a CUDA graph at
    frame 0, replayed on every later frame), beside the eager step it is
    held to. All 43 frames through both in turn: pose, raycast pose,
    vertex, normal, valid and every aux entry (the packed row too) equal
    each frame, bit for bit, the map equal at the end, one graph, the
    blocks and drops those of the slice (``sl``, slice_phase's summary);
    then ms/frame of the slice's timed window eager, graph, graph, eager
    (each run from a fresh state, a graph run keeping each frame's aux
    row, one copy a frame, as the slice keeps its auxes), with the
    launches each graph run counts by replays equal to the eager run's
    and the path's; then a replay of the first N_PROFILED timed frames
    from a snapshot under torch.profiler: each kernel of the path once a
    frame (the prologue twice) and the program's own copies, nothing
    else (retaken up to PROFILE_TRIES times), and the replayed frame's
    split (busy, idle inside it, gaps between frames) beside the host's
    time a call. Returns the graph run's launches and
    a summary."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from supereight_tpu_torch.parallel import step
    from supereight_tpu_torch.utils import deviceprof
    tag = f"graph {sc.name}"
    first = N_WARMUP + N_FRAMES
    path = PATHS[sc.name]

    # both in turn, every frame compared; the program's state before the
    # profiled frames kept for their replay
    prog = sc.bench.program()
    state = sc.init()
    unequal = collections.Counter()
    rows = []
    for i in range(sc.n_total):
        if i == first - 1:
            snapshot = clone_frame_state(prog.state)
        state, aux = sc.frame(state, i)
        gstate, gaux = sc.graph_frame(prog, i)
        row = torch.stack([aux[k].reshape(()).to(torch.int32)
                           for k in step.AUX_SCALARS])
        for name in ("pose", "raycast_pose", "vertex", "normal", "valid"):
            unequal[name] += not torch.equal(getattr(state, name),
                                             getattr(gstate, name))
        for k in aux:
            unequal[k] += not torch.equal(aux[k], gaux[k])
        unequal["scalars"] += not torch.equal(row, gaux["scalars"])
        rows.append(row)
    leaves = list(zip(step.state_leaves(state), step.state_leaves(gstate)))
    unequal["leaves"] = sum(not torch.equal(a, b) for a, b in leaves)
    rows = torch.stack(rows).cpu().numpy()
    cols = dict(zip(step.AUX_SCALARS, rows.T))
    n_blocks = int(gstate.map.n_blocks)
    final_pose = gstate.pose.clone()
    keys = list(prog.graphs)
    bad = {k: v for k, v in unequal.items() if v}
    print(f"{tag}: the program against the eager step on all "
          f"{sc.n_total} frames (frame 0 the capture's eager warm-up, 1-"
          f"{sc.n_total - 1} replays): unequal outputs {bad} (== {{}}, bit "
          f"for bit: pose, raycast pose, vertex, normal, valid, "
          f"{len(aux)} aux entries and the packed row each frame, "
          f"{len(leaves)} state leaves, the map's among them, at the "
          f"end); "
          f"{len(keys)} graph (== 1); blocks {n_blocks} (the slice "
          f"{sl['n_blocks']}); drops (max over frames) "
          f"{ {c: int(cols[c].max()) for c in COUNTERS} }")
    require(not bad, f"{tag}: the graph departs from the eager step: {bad}")
    require(len(keys) == 1 and n_blocks == sl["n_blocks"]
            and all(int(cols[c].max()) == 0 for c in COUNTERS),
            f"{tag}: {len(keys)} graphs, blocks {n_blocks} (the slice "
            f"{sl['n_blocks']}), drops {cols}")
    del state, gstate, leaves
    key = keys[0]

    # eager, graph, graph, eager in this call; a graph run keeps each
    # frame's row (one copy), the eager run its aux dicts
    fresh = sc.init()
    eager, kept = None, []

    def eager_start():
        nonlocal eager
        eager = sc.init()

    def eager_frame(i):
        nonlocal eager
        eager, aux = sc.frame(eager, i)
        kept.append(aux)

    def graph_frame(i):
        kept.append(sc.graph_frame(prog, i)[1]["scalars"].clone())

    runs = []
    for name in ("eager", "graph", "graph", "eager"):
        kept.clear()
        if name == "eager":
            ms, fms, host, launches = timed_slice(torch, sc, eager_start,
                                                  eager_frame)
        else:
            ms, fms, host, launches = timed_slice(
                torch, sc, lambda: prog.load(fresh), graph_frame)
            same = torch.equal(torch.stack(kept).cpu(),
                               torch.from_numpy(rows)) and torch.equal(
                prog.state.pose, final_pose)
            require(same, f"{tag}: a timed graph run departs from the "
                    f"compared one")
            graph_launches = launches
        runs.append((name, ms, fms, host, launches))
    want = expected_launches(sc)
    eager_launches = runs[0][4]
    for name, ms, fms, host, launches in runs:
        print(f"{tag}: {name:5s} {ms:.3f} ms/frame over {N_TIMED} timed "
              f"frames (CUDA events; {card}); per frame median "
              f"{statistics.median(fms):.3f} ms, min {fms[0]:.3f}, max "
              f"{fms[-1]:.3f} (max / median "
              f"{fms[-1] / statistics.median(fms):.2f}); host "
              f"{statistics.median(host) * 1e6:.1f} us a call (median)")
        require(all(launches.get(k, 0) == v for k, v in want.items())
                and launches == eager_launches
                and all(launches[k] > 0 for k in path),
                f"{tag}: {name} launches {launches}, expected {want} and "
                f"the eager run's {eager_launches}")
    print(f"{tag}: launches counted by the replays equal the eager run's "
          f"and the path's: "
          f"{ {k: v for k, v in graph_launches.items() if v} }")

    # the replay under the profiler
    n_path = len(path)
    own = prog.ops(key)
    fd, trace = tempfile.mkstemp(suffix=".json", prefix="graph_trace_")
    os.close(fd)
    ms_graph = statistics.mean(r[1] for r in runs if r[0] == "graph")
    try:
        for attempt in range(PROFILE_TRIES):
            prog.load(snapshot)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1,
                                           active=N_PROFILED, repeat=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(
                             trace)) as prof:
                for i in range(first - 1, first + N_PROFILED):
                    sc.graph_frame(prog, i)
                    if i in (first - 1, first + N_PROFILED - 1):
                        torch.cuda.synchronize()
                    prof.step()
            per_frame, n_launch, _ = report_profile(prof, ms_graph, tag)
            complete = len(per_frame) == n_path and all(
                v == (2 if k == "frame_mats" else 1)
                for k, v in per_frame.items()) \
                and round(n_launch) == n_path + 1 + own
            print(f"{tag}: a replayed frame holds {len(per_frame)} of the "
                  f"path's {n_path} kernels, each once a frame (the "
                  f"prologue twice), and {n_launch:.0f} kernels and copies "
                  f"(== {n_path + 1} + the program's own {own}: the input "
                  f"copies, the copies back into the state, the packed "
                  f"row): {complete}")
            if complete:
                break
            print(f"{tag}: the profile missed launches (try {attempt + 1} "
                  f"of {PROFILE_TRIES})")
        require(complete, f"{tag}: no profile showed the path's kernels "
                f"once a frame and the program's own copies: {per_frame}")
        split = deviceprof.frame_split(deviceprof.device_events(trace),
                                       N_PROFILED)
    finally:
        os.remove(trace)
    host_us = statistics.median(
        h for r in runs if r[0] == "graph" for h in r[3]) * 1e6
    if split:
        print(f"{tag}: a replayed frame under the profiler: device busy "
              f"{split['busy_us']:.2f} us, its span {split['span_us']:.2f} "
              f"us (idle inside it {split['inside_us']:.2f} us: the gaps "
              f"between the graph's nodes, and any wait for the host after "
              f"the input copies), between frames "
              f"{split['between_us']:.2f} us; the host {host_us:.1f} us a "
              f"call in the timed runs (median: the input copies, the "
              f"replay, the row's copy)")
    ms = {name: [r[1] for r in runs if r[0] == name]
          for name in ("eager", "graph")}
    print(f"{tag}: ms/frame eager {ms['eager'][0]:.3f}, graph "
          f"{ms['graph'][0]:.3f}, graph {ms['graph'][1]:.3f}, eager "
          f"{ms['eager'][1]:.3f} in this call ({card}); aim for the graph "
          f"<= {GRAPH_AIM_MS[sc.name]} ms/frame (printed, not held)")
    return ({k: graph_launches[k] for k in path},
            dict(ms=ms, split=split, host_us=host_us, n_blocks=n_blocks))


def check_noise_map(torch, inp, tag):
    """K1's gated launch and K7's median2 on a noise map's last frame
    (``tools/noise_kernels.GateInputs``) against their twins: the rays to
    :func:`check_raycast`'s tolerances (bit-equality of the vertex,
    normal and hit maps and ray_overflow printed), median2 on the frame's
    raw depth bit for bit; then (``noise_kernels.measure``) the gated
    march's probes a ray, the longest ray's probes by kind, both kernels'
    device us and the gated launch's time against its probe bound. Returns
    those numbers."""
    from supereight_tpu_torch.kernels import preprocess as pre
    got, ref = noise_tool.gated(inp), noise_tool.gated_plain(inp)
    v_err = check_raycast(torch, f"K1 raycast_gated ({tag})", got, ref)
    exact = all(torch.equal(a, b) for a, b in zip(got[:4], ref[:4]))
    med = torch.equal(pre.median_filter3(inp.depth, 2),
                      pre.median_filter3_plain(inp.depth, 2))
    print(f"K1 raycast_gated ({tag}): vertex, normal, hit maps and "
          f"ray_overflow bit-equal to the twin: {exact}; K7 median2 on the "
          f"frame's raw depth bit-equal to the twin: {med}")
    require(med, f"K7 median2 ({tag}) disagrees with twin")
    out = noise_tool.measure(inp, lambda fn: device_us(torch, fn, 20, 1),
                             f"K1 raycast_gated, K7 median2 ({tag})")
    out.update(bit_equal=exact, max_abs_err=v_err)
    return out


def start_noisy_raw(tmp):
    """Start rendering the tracked noise map's .raw (the first
    TRACKED_FRAMES frames of the loop with range noise,
    ``tools/noise_kernels.py --render``) into ``tmp`` in a process of its
    own; returns the process and the .raw's path."""
    raw = os.path.join(tmp, "noisy_loop.raw")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "supereight_tpu_torch.tools.noise_kernels",
         "--render", raw], cwd=root, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    return proc, raw


def tracked_noise_phase(torch, tmp, card):
    """The tracked noise map (``tools/noise_kernels.py``), a path of its
    own with the launch counts zeroed just before and read just after:
    the first noise_tool.TRACKED_FRAMES frames of the loop with range
    noise, rendered first (here, so that the renderers share the host with
    no timed phase), through the CLI (``cli.run``, in this process) with
    tools/longseq.py's arguments and the noise=0.002+levers row's options.
    Every frame from frame 4 on must track (the log's column) and every
    drop counter be 0; then :func:`check_noise_map` on its last frame.
    Returns the path's launch counts and those numbers."""
    from supereight_tpu_torch.eval.sweep import parse_frame_log
    from supereight_tpu_torch.kernels import _lib
    tag = "tracked noise map"
    path = "pipeline-tsdf-levers"
    n = noise_tool.TRACKED_FRAMES
    t_render = time.perf_counter()
    proc, raw = start_noisy_raw(tmp)
    try:
        wait_loop_raw(proc, t_render, f"the tracked noise map's {n}-frame "
                      "noisy loop .raw (the phase's set-up)")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    _lib.reset_launches()
    pipe, err = noise_tool.run_tracked(raw, os.path.join(tmp, "tracked.log"))
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    t_run = time.perf_counter() - t_run
    ate, drops, _ = cli_stderr(err)
    rows = parse_frame_log(os.path.join(tmp, "tracked.log"))
    untracked = [i for i, r in enumerate(rows) if not r.get("tracked")]
    print(f"{tag}: {len(rows)} frames in {t_run:.2f} s ({card}); ATE RMSE "
          f"{ate:.4f} m; untracked frames {untracked} (frames 0-3 cannot "
          f"track); drops {drops}; blocks {pipe.block_count()}; kernel "
          f"launches { {k: v for k, v in launches.items() if v} }")
    require(len(rows) == n, f"{tag}: {len(rows)} frames of {n}")
    require(all(i < 4 for i in untracked),
            f"{tag}: a frame from frame 4 on did not track: {untracked}")
    require(drops is not None and all(v == 0 for v in drops.values()),
            f"{tag}: drop counters nonzero: {drops}")
    require(all(launches[k] > 0 for k in PATHS[path]),
            f"{tag}: a kernel of the path was not launched: {launches}")
    require_views(tag, launches, rendered_frames(
        noise_tool.tracked_argv("", "", n), n))
    require(launches["median2"] == n and launches["raycast_gated"] == n - 3,
            f"{tag}: median2 {launches['median2']} (== {n}) and "
            f"raycast_gated {launches['raycast_gated']} (== {n - 3}, from "
            f"frame 3) launches")
    out = check_noise_map(torch, noise_tool.pipeline_inputs(pipe),
                          f"{tag}, frame {n - 1}")
    out.update(ate=ate, blocks=pipe.block_count(),
               seconds=time.perf_counter() - t0)
    print(f"{tag}: the phase took {out['seconds']:.1f} s (< 30) after its "
          f"set-up, the render")
    del pipe
    torch.cuda.empty_cache()
    return {k: launches[k] for k in PATHS[path]}, out


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


def empty_cta_cost(torch, geom, field, m, pose, k, depth, mu, ts, budget,
                   noise, tag):
    """What the empty entries of a bucketed path's worklist cost K3: the
    device us a launch of its fused pass and its fallback over the path's
    ``budget`` entries and over the listed entries alone, on copies of the
    map ``m`` the path ended with, fusing its last ``depth`` at its
    ``pose`` (``tools/k3_bucket.k3_times``). Printed, not held; returns
    the times."""
    from supereight_tpu_torch.kernels import integrate as ki
    from supereight_tpu_torch.tools.k3_bucket import k3_times
    r = k3_times(geom, field, m, pose, k, depth, mu, ts, budget, noise,
                 lambda fn: device_us(torch, fn, 20, 1))
    for name, key in ((ki.fused_name(field, noise), "fused_us"),
                      (ki.fallback_name(field, noise), "fallback_us")):
        print(f"K3 {name} ({tag}): {r['listed']} listed blocks; device "
              f"{r[key]:.2f} us/launch over the path's {budget} entries, "
              f"{r[key + '_listed']:.2f} over the {r['listed']} listed "
              f"ones: the empty entries cost "
              f"{r[key] - r[key + '_listed']:.2f} us a frame")
    return r


def bench_phase(slices, graphs, card):
    """The port's headline bench (``python -m
    supereight_tpu_torch.tools.bench``), both fields, each in a process of
    its own: its one stdout line held to the four keys, the metric name,
    the unit and vs_baseline; its blocks, drops, tracked flag and final
    error to the same field's slice (``slices``: slice_phase's summaries
    by field); its launches, counted by its graph's replays, to the path's
    kernels once a frame (the prologue twice) over the 43 frames; its
    eager step's line on stderr, whose final pose and blocks must equal
    the graph run's. Prints its fps beside the graph phase's (``graphs``)
    1000 / ms_frame and its eager fps beside the slice's, not held: two
    processes differ by host noise. Returns the bench runs' launch
    counts."""
    launches = collections.Counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    n = port_bench.N_TOTAL
    for field in port_bench.FIELDS:
        tag = f"bench {field}"
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "supereight_tpu_torch.tools.bench",
             "--field", field], cwd=repo, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT_S)
        secs = time.perf_counter() - t0
        for line in out.stderr.splitlines():
            print(f"{tag} | {line}")
        require(out.returncode == 0, f"{tag}: exit {out.returncode}")
        lines = out.stdout.strip().splitlines()
        require(len(lines) == 1, f"{tag}: stdout is not one line: "
                f"{out.stdout!r}")
        res = json.loads(lines[0])
        metric = f"frames_per_sec_gpu_traj2cfg_c2_512v_{field}_icp"
        require(sorted(res) == ["metric", "unit", "value", "vs_baseline"]
                and res["metric"] == metric and res["unit"] == "fps"
                and res["value"] > 0 and res["vs_baseline"] == round(
                    res["value"] / port_bench.BASELINE_FPS, 3),
                f"{tag}: the JSON line {res}")
        m = re.search(r"blocks=(\d+), tracked=(True|False), final pos "
                      r"err=([0-9.]+) m, drops=(\{.*\})", out.stderr)
        require(m, f"{tag}: no result line on stderr")
        blocks, tracked, err = int(m[1]), m[2] == "True", float(m[3])
        drops = ast.literal_eval(m[4])
        sl = slices[field]
        require(blocks == sl["n_blocks"] and tracked == sl["tracked"]
                and tracked and not any(drops.values())
                and err < MAX_POS_ERR,
                f"{tag}: blocks {blocks}, tracked {tracked}, error {err}, "
                f"drops {drops}; the slice's {sl}")
        m = re.search(r"^# launches (\{.*\})$", out.stderr, re.M)
        require(m, f"{tag}: no launches line on stderr")
        got = json.loads(m[1])
        want = {k: (2 if k == "frame_mats" else 1) * n for k in PATHS[field]}
        require(got["frames"] == n and got["total"] == want,
                f"{tag}: launches {got}, expected {want}")
        m = re.search(r"^# eager step: ([0-9.]+) fps, .*equal to the "
                      r"graph's: (True|False)$", out.stderr, re.M)
        require(m and m[2] == "True", f"{tag}: no eager line on stderr, "
                "or its final pose and blocks differ from the graph's")
        launches.update(got["total"])
        g = graphs[field]["ms"]["graph"][0]
        print(f"{tag}: {res['value']:.3f} fps by CUDA events (the graph), "
              f"the graph phase {1000 / g:.3f} (1000 / {g:.3f} ms/frame); "
              f"eager {float(m[1]):.3f}, the slice "
              f"{1000 / sl['ms_frame']:.3f} (1000 / {sl['ms_frame']:.3f} "
              f"ms/frame; two processes, not held); blocks {blocks} (the "
              f"slice {sl['n_blocks']}), final error {err:.4f} m (the slice "
              f"{sl['pos_err']:.4f}), drops {drops}; launches a frame "
              f"{got['per_frame']:g}; the process {secs:.1f} s; {card}")
    return launches


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


def wait_loop_raw(proc, t_start, what=f"the {LOOP_FRAMES}-frame loop .raw"):
    _, err = proc.communicate(timeout=900)
    ready = time.perf_counter() - t_start
    print(f"pipeline: {what} rendered in {LOOP_WORKERS} processes, ready "
          f"{ready:.1f} s after its start (rc {proc.returncode})")
    require(proc.returncode == 0, f"{what} failed: {err[-2000:]}")


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


def loop_argv(raw, name, log, frames):
    """The CLI's arguments for ``frames`` frames of the loop .raw at
    run_longseq_eval.py's settings and field ``name``'s options."""
    return (["-i", raw, "-g", raw + ".gt.txt", "-o", log, "--max-frames",
             str(frames)] + list(PIPE_ARGS) + list(PIPE_FIELD_ARGS[name]))


def pipeline_run(torch, name, raw, tmp, card):
    """The class pipeline's path for one field: the port's CLI
    (``cli.run``, in this process) over the loop .raw with
    run_longseq_eval.py's arguments, then one rendered frame
    (``render_views``) from the last raycast pose moved BACK_VIEW back
    (K1's unprimed launch), with every launch count zeroed just before and
    read just after. Holds the drop counters to 0, the tracked fraction
    (the log's) to MIN_TRACKED, the ATE to MAX_ATE, for TSDF the PPM count
    to the rendered frames, K10 to one render_views a rendered frame and
    the tracking maps to what they were before the fresh view;
    the class runs on its stage graphs, whose replays are timed on the
    host. Returns the pipeline, the path's launch counts, its numbers,
    its log's rows and the CLI's launch counts (the fresh view's
    aside)."""
    import numpy as np
    from supereight_tpu_torch import cli
    from supereight_tpu_torch.eval.sweep import parse_frame_log, summarize
    from supereight_tpu_torch.kernels import _lib
    tag = f"pipeline {name}"
    path = "pipeline-" + name
    log = os.path.join(tmp, name + ".log")
    renders = os.path.join(tmp, "renders-" + name)
    argv = loop_argv(raw, name, log, LOOP_FRAMES) + [
        "--trajectory-out", os.path.join(tmp, name + ".traj")]
    field_args = PIPE_FIELD_ARGS[name]
    rate = int(field_args[field_args.index("-z") + 1])
    if rate:
        argv += ["--dump-renders", renders]
    err = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), timed_replays() as replays:
        pipe = cli.run(argv)
    cli_launches = dict(_lib.LAUNCHES)
    # a fresh view: K1's unprimed launch over every block, into scratch maps
    view_pose = moved_pose(pipe.raycast_pose, -BACK_VIEW).cpu().numpy()
    maps = [t.clone() for t in (pipe.vertex, pipe.normal, pipe.valid)]
    image = pipe.render_views(view_pose=view_pose)[3]
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    kept = all(torch.equal(t, m) for t, m in
               zip((pipe.vertex, pipe.normal, pipe.valid), maps))
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
          f"pixels of {image.shape[0] * image.shape[1]}, the tracking maps "
          f"kept: {kept}")
    print(f"{tag}: kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    graphs = pipe.graph_stats()
    print(f"{tag}: the stage graphs: {graphs['graphs']} captured "
          f"(keys {list(pipe._graphs.entries)}), their pool holds "
          f"{graphs['pool_bytes']} bytes; {replays['n']} replays, the host "
          f"{1e6 * replays['s'] / LOOP_FRAMES:.1f} us a frame in them")
    require(len(rows) == LOOP_FRAMES and ate is not None
            and np.isfinite(ate), f"{tag}: the run did not finish")
    require(drops is not None and all(v == 0 for v in drops.values()),
            f"{tag}: drop counters nonzero: {drops}")
    require(summary["tracked_fraction"] >= MIN_TRACKED,
            f"{tag}: tracked fraction {summary['tracked_fraction']}")
    require(ate <= MAX_ATE[name], f"{tag}: ATE {ate:.4f} m over the limit")
    require(n_ppm == want_ppm, f"{tag}: {n_ppm} renders, {want_ppm} due")
    require(lit > 0, f"{tag}: the fresh view shows nothing")
    require(kept, f"{tag}: the fresh view wrote the tracking maps")
    require(all(launches[k] > 0 for k in PATHS[path]),
            f"{tag}: a kernel of the path was not launched: {launches}")
    cold = "raycast_cold_of" if name == "ofusion" else "raycast_cold"
    require(launches[cold] == 1, f"{tag}: the fresh view launched "
            f"{cold} {launches[cold]} times")
    # K10: one render_views a rendered frame, and the fresh view's
    require_views(tag, launches, want_ppm + 1)
    require(graphs["graphs"] >= 5 and replays["n"] > 0,
            f"{tag}: the CLI ran no stage graphs: {graphs}, {replays}")
    numbers = dict(ate=ate, tracked=summary["tracked_fraction"],
                   computation_ms=1e3 * summary["computation_mean"],
                   wall_fps=fps, peak_mib=peak_mib,
                   replay_host_us=1e6 * replays["s"] / LOOP_FRAMES,
                   **graphs)
    return (pipe, {k: launches[k] for k in PATHS[path]}, numbers, rows,
            cli_launches)


@contextlib.contextmanager
def timed_replays():
    """Count the stage graphs' replays of the runs inside and their host
    seconds (the call of ``Graphs`` that replays, from its start to its
    return: the replay's launch and the launch table's count)."""
    from supereight_tpu_torch import graphs
    seen = dict(n=0, s=0.0)
    call = graphs.Graphs.__call__

    def timed(self, key, program):
        replay = key in self.entries
        t0 = time.perf_counter()
        out = call(self, key, program)
        if replay:
            seen["n"] += 1
            seen["s"] += time.perf_counter() - t0
        return out
    graphs.Graphs.__call__ = timed
    try:
        yield seen
    finally:
        graphs.Graphs.__call__ = call


def computation_ms(rows):
    """The log's computation a frame (ms): mean, median and max, the mean
    from frame 4 on (the stage graphs capture on the first frame of each
    key: frames 0 and 3 on the loop) and the three slowest frames."""
    ms = [1e3 * r["computation"] for r in rows]
    slowest = sorted(range(len(ms)), key=ms.__getitem__)[-3:][::-1]
    return dict(mean=statistics.mean(ms), median=statistics.median(ms),
                max=max(ms), mean_from_4=statistics.mean(ms[4:]),
                slowest={int(rows[i]["frame"]): ms[i] for i in slowest})


def pipeline_eager_cli(torch, name, raw, tmp, graph_rows, launches,
                       graph_ate):
    """The CLI of ``name``'s path again with the class's ``eager``
    keyword (every stage eager, the reference of the stage graphs): the
    log's rows but the timings, the ATE and the launches must equal the
    graph run's (``graph_rows``, ``launches``, ``graph_ate``). Returns the
    eager run's log rows."""
    from supereight_tpu_torch.eval.sweep import parse_frame_log
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.tools import render_loop
    tag = f"pipeline {name}"
    log = os.path.join(tmp, name + "-eager.log")
    torch.cuda.synchronize()
    _lib.reset_launches()
    pipe, err = render_loop.run_cli(loop_argv(raw, name, log, LOOP_FRAMES),
                                    eager=True)
    torch.cuda.synchronize()
    eager_launches = dict(_lib.LAUNCHES)
    require(pipe._graphs is None, f"{tag}: the eager run has graphs")
    del pipe
    ate, _, _ = cli_stderr(err)
    rows = parse_frame_log(log)
    cols = ("frame", "X", "Y", "Z", "tracked", "integrated")
    same_rows = [{c: r[c] for c in cols} for r in rows] == [
        {c: r[c] for c in cols} for r in graph_rows]
    same_launches = launches == eager_launches
    print(f"{tag}: the CLI with every stage eager: ATE RMSE {ate:.6f} m "
          f"(the graphs' {graph_ate:.6f}), its rows (frame, position, "
          f"tracked, integrated) equal the graph run's: {same_rows}, "
          f"launches equal the graph run's: {same_launches}")
    require(same_rows and same_launches and ate == graph_ate,
            f"{tag}: the eager CLI departs from the graphs: rows "
            f"{same_rows}, ATE {ate} vs {graph_ate}, launches "
            f"{eager_launches} vs {launches}")
    return rows


def pipeline_equal(torch, name, pipe, raw, card):
    """Two fresh pipelines of ``pipe``'s configuration, one eager and one
    on the stage graphs, over the loop's LOOP_FRAMES frames through
    ``process_frame`` in turn: every frame the pose, old pose, raycast
    pose, reference maps, reduction, track result, float depth, pyramid
    and result equal bit for bit, and the map at the end; on every
    FRESH_RATE-th frame from frame 4 both render a fresh view BACK_VIEW
    behind the raycast pose (``render_views``; on the graphs a replay of
    the fresh-view graph, reading the map as it has grown), the
    composites equal bit for bit. Then :func:`fresh_view_costs` on the
    last state. Returns the graphs' stats and the fresh view's numbers."""
    import numpy as np
    from supereight_tpu_torch.io.dataset import RawDepthReader
    from supereight_tpu_torch.pipeline import DenseSLAMSystem, _leaves
    tag = f"pipeline {name}"
    w, h = pipe.computation_size
    r = pipe.config.compute_size_ratio
    init = pipe.init_pose.cpu().numpy()
    runs = {eager: DenseSLAMSystem((w * r, h * r), pipe.config,
                                   init_pose=init, device=pipe.device,
                                   eager=eager) for eager in (True, False)}
    names = ("pose", "old_pose", "raycast_pose", "vertex", "normal",
             "valid", "reduction", "track_result", "float_depth", "pyr")
    unequal = collections.Counter()
    fresh = []   # each fresh view's lit pixels (its volume image's)
    reader = RawDepthReader(raw)
    for i in range(LOOP_FRAMES):
        depth = reader.read_frame(i)[0]
        res = {e: p.process_frame(depth, i) for e, p in runs.items()}
        a, b = runs[True], runs[False]
        for n in names:
            unequal[n] += not all(
                torch.equal(x, y) for x, y in zip(
                    _leaves(getattr(a, n)), _leaves(getattr(b, n)),
                    strict=True))
        unequal["result"] += res[True].keys() != res[False].keys() or any(
            not (torch.equal(v, res[False][k]) if isinstance(v, torch.Tensor)
                 else v == res[False][k]) for k, v in res[True].items())
        if i % FRESH_RATE == 0 and i > 2:
            view = moved_pose(b.raycast_pose, -BACK_VIEW).cpu().numpy()
            comps = [p.render_views(view)[0] for p in (a, b)]
            unequal["fresh_view"] += not np.array_equal(*comps)
            h, w = comps[1].shape[0] // 2, comps[1].shape[1] // 2
            fresh.append(int((comps[1][h:, w:, :3].max(-1) > 0).sum()))
    leaves = list(zip(_leaves(runs[True].map), _leaves(runs[False].map)))
    unequal["map"] = sum(not torch.equal(x, y) for x, y in leaves)
    bad = {k: v for k, v in unequal.items() if v}
    graphs = runs[False].graph_stats()
    keys = [k for k in runs[False]._graphs.entries if k[0] == "fresh_view"]
    print(f"{tag}: the stage graphs against the eager class on all "
          f"{LOOP_FRAMES} loop frames in turn (process_frame): frames "
          f"unequal {bad} (== {{}}, bit for bit: {', '.join(names)} and the "
          f"result each frame, the map's {len(leaves)} leaves at the end, "
          f"and the composites of {len(fresh)} fresh views, one every "
          f"{FRESH_RATE} frames from frame 4, {BACK_VIEW} m behind the "
          f"raycast pose, lit pixels {min(fresh, default=0)} to "
          f"{max(fresh, default=0)}, through {len(keys)} fresh-view "
          f"graph); {graphs['graphs']} graphs captured, their pool "
          f"{graphs['pool_bytes']} bytes; blocks {runs[False].block_count()}")
    require(not bad, f"{tag}: the stage graphs depart from the eager "
            f"class: {bad}")
    require(len(keys) == 1 and fresh and min(fresh) > 0,
            f"{tag}: fresh views {fresh} through the graphs {keys}")
    out = dict(graphs, fresh_views=len(fresh),
               fresh_view=fresh_view_costs(torch, runs, tag, card))
    del runs
    torch.cuda.empty_cache()
    return out


def fresh_view_costs(torch, runs, tag, card):
    """A fresh view's render (BACK_VIEW behind the raycast pose) on the
    loop's last state of the eager class (``runs[True]``) and the one on
    the stage graphs (``runs[False]``): the host's launches a render
    (``_lib.host_calls``), held to FRESH_KERNELS and no replay eagerly
    and to one replay and no kernel launch on the graphs; host us of the
    class's composite call (``_composite``: the view pose's copy, then
    the launches or the replay; no read) and of ``render_views`` (with
    the read into a host array), and the stream's us between CUDA events
    just before and after the composite call (eagerly the device waits
    there for the host's launches), medians of FRESH_REPS in four blocks
    (eager, graphs, graphs, eager), each call after a synchronize; and the
    device us of a render's FRESH_KERNELS kernels (their durations summed,
    median of FRESH_REPS, ``tools/sharded_kernels.kernel_us``, from a
    trace that shows the same whole number of kernels a call). The aim,
    printed and not held: a graph render whose host us are below the
    eager one's. Returns the numbers."""
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.tools.sharded_kernels import kernel_us
    view = moved_pose(runs[False].raycast_pose, -BACK_VIEW).cpu().numpy()
    modes = {"eager": runs[True], "graphs": runs[False]}
    out = {m: dict(host_us=[], stream_us=[], call_us=[]) for m in modes}
    calls = {}
    for m, p in modes.items():
        p.render_views(view)
        torch.cuda.synchronize()
        with _lib.host_calls() as seen:
            p._composite(view)
        torch.cuda.synchronize()
        calls[m] = dict(seen)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for m in ("eager", "graphs", "graphs", "eager"):
        p, host, stream, whole = modes[m], [], [], []
        for _ in range(FRESH_REPS):
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            p._composite(view)
            host.append(1e6 * (time.perf_counter() - t0))
            end.record()
            torch.cuda.synchronize()
            stream.append(1e3 * start.elapsed_time(end))
        for _ in range(FRESH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.render_views(view)
            whole.append(1e6 * (time.perf_counter() - t0))
        out[m]["host_us"].append(statistics.median(host))
        out[m]["stream_us"].append(statistics.median(stream))
        out[m]["call_us"].append(statistics.median(whole))
    for m, p in modes.items():
        out[m]["device_us"] = kernel_us(lambda: p._composite(view), "",
                                        reps=FRESH_REPS, per_call=None)[0]
        out[m]["host_launches"] = calls[m]
    g, e = out["graphs"], out["eager"]
    print(f"{tag}: a fresh view's render ({BACK_VIEW} m behind the raycast "
          f"pose, {runs[False].computation_size[0]}x"
          f"{runs[False].computation_size[1]}), eager / graphs, medians of "
          f"{FRESH_REPS} in the blocks eager, graphs, graphs, eager: host us "
          f"of the composite call {e['host_us']} / {g['host_us']}, the "
          f"stream's us around it {e['stream_us']} / {g['stream_us']}, host "
          f"us of render_views with its read {e['call_us']} / "
          f"{g['call_us']}; device us of its kernels "
          f"{e['device_us']:.2f} / {g['device_us']:.2f}; the host's launches "
          f"a render {calls['eager']} / {calls['graphs']}; aim (printed, not "
          f"held): graph host us below eager: "
          f"{max(g['host_us']) < min(e['host_us'])} ({card})")
    require(calls["eager"] == dict(launch=FRESH_KERNELS, replay=0)
            and calls["graphs"] == dict(launch=0, replay=1),
            f"{tag}: a fresh view's host launches {calls}")
    return out


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
    frame and device us a launch. The trace is complete when it shows
    PIPE_EVENTS kernels and copies a frame and the stage graphs' copies
    (:func:`pipeline_copies`); one that missed launches is taken again
    over the next frames, up to PROFILE_TRIES times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    depths = [loop_depth(raw, i) for i in range(N_PIPE_PROFILED + 1)]
    copies = pipeline_copies(pipe)
    want = PIPE_EVENTS + sum(copies.values())
    for attempt in range(PROFILE_TRIES):
        first = LOOP_FRAMES + 1 + attempt * len(depths)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1,
                                       active=N_PIPE_PROFILED,
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
              f"kernels and copies a frame (== {want}: {PIPE_EVENTS} and "
              f"the stage graphs' copies {copies}); busy share "
              f"of the run's mean computation {ms_frame:.3f} ms/frame: "
              f"{busy / ms_frame:.4f}; "
              + ", ".join(f"{k} {c / N_PIPE_PROFILED:g}x "
                          f"{us / max(c, 1):.2f} us"
                          for k, (c, us) in sorted(per.items())))
        # every kernel of the frame (the path's, the renders and the fresh
        # view's march aside) once a frame, the prologue three times
        n_path = sum(not k.startswith(("raycast_cold", "render_"))
                     for k in PATHS["pipeline-" + pipe.field.name])
        complete = round(n) == want and len(per) == n_path and all(
            c == N_PIPE_PROFILED * (3 if k == "frame_mats" else 1)
            for k, (c, _) in per.items())
        if complete:
            break
        print(f"{tag}: the profile missed launches (try {attempt + 1} of "
              f"{PROFILE_TRIES})")
    require(complete, f"{tag}: no profile showed {want} kernels and "
            f"copies a frame, each kernel of the frame once (the prologue "
            f"three times): {n}, {per}")
    return dict(busy_ms=busy, launches_frame=n, busy_share=busy / ms_frame,
                device_us={k: us / max(c, 1) for k, (c, us) in per.items()})


def pipeline_copies(pipe):
    """Each stage's copies into the class's own tensors a frame, in its
    newest graph (what the stage's program returned); the fresh view's
    graph is a render, no stage of a frame."""
    return {key[0]: entry.out for key, entry in pipe._graphs.entries.items()
            if key[0] != "fresh_view"}


def pipeline_empty_cost(torch, pipe, tag):
    """:func:`empty_cta_cost` on the class pipeline's last frame: its map,
    pose and fused depth, at its bucket."""
    c = pipe.config
    depth = pipe.pyr[0][0] if c.fuse_filtered else pipe.float_depth
    ts = torch.tensor((LOOP_FRAMES + N_PIPE_PROFILED) / 30.0,
                      dtype=torch.float32, device=depth.device)
    return empty_cta_cost(torch, pipe.geom, pipe.field, pipe.map, pipe.pose,
                          pipe.k, depth, c.mu, ts, pipe._budget_bucket(),
                          c.noise_weighted, f"{tag}, last frame")


def render_cases(torch, pipe):
    """K10's inputs on the card, per render: the loop's last maps (the
    TSDF pipeline's depth, track result and raycast maps under its
    raycast pose: the main path's shapes, timed), the fresh view's maps
    from its raycast pose moved BACK_VIEW back (K1's unprimed march, to
    twice the far plane), and :func:`render_edges` (for ``render_views``
    :func:`render_view_edges`, all at one shape)."""
    import numpy as np
    from supereight_tpu_torch.constants import FAR_PLANE
    from supereight_tpu_torch.kernels.frame import frame_mats
    from supereight_tpu_torch.ops import raycast as raycast_mod
    dev = pipe.device
    e = {k: torch.from_numpy(v).to(dev) for k, v in render_edges(np).items()}
    ev = {k: torch.from_numpy(v).to(dev)
          for k, v in render_view_edges(np).items()}
    pose = moved_pose(pipe.raycast_pose, -BACK_VIEW)
    fresh = raycast_mod.raycast(
        pipe.geom, pipe.map, pipe.field, frame_mats(pipe.k, pose).kpose,
        pipe.config.mu, pipe.computation_size, far=2.0 * FAR_PLANE)
    edges = (e["vertex"], e["normal"], e["valid"], e["pose"])
    images = (pipe.float_depth, pipe.track_result)
    view_edges = (ev["depth"], ev["track"], ev["vertex"], ev["normal"],
                  ev["valid"], ev["pose"])
    return {
        "render_depth": {"loop": (pipe.float_depth,), "edges": (e["depth"],)},
        "render_track": {"loop": (pipe.track_result,),
                         "edges": (e["track"],)},
        "render_volume": {"loop": (pipe.vertex, pipe.normal, pipe.valid,
                                   pipe.raycast_pose),
                          "fresh": (*fresh, pose), "edges": edges,
                          "edges_light": edges + (e["light"],)},
        "render_views": {"loop": images + (pipe.vertex, pipe.normal,
                                           pipe.valid, pipe.raycast_pose),
                         "fresh": images + (*fresh, pose),
                         "edges": view_edges,
                         "edges_light": view_edges + (ev["light"],)}}


def check_render(torch, pipe, card):
    """K10 against its twins on the card, bit for bit, on every case of
    :func:`render_cases`, one launch a call, and ``render_views``'
    quadrants against the single launches' images and a zero quadrant;
    on the loop's maps each
    render's call ms (CUDA events over back-to-back calls), its device us
    (median of 20 launches, ``tools/sharded_kernels.kernel_us``) beside
    the launch floor, its twin's ms and its bound. Returns the kernels
    line's rows."""
    from supereight_tpu_torch.kernels import _lib, render
    from supereight_tpu_torch.tools.sharded_kernels import (kernel_us,
                                                            launch_floor_us)
    floor = launch_floor_us()
    rows = {}
    for name, cases in render_cases(torch, pipe).items():
        kernel, twin = getattr(render, name), getattr(render, name + "_plain")
        errs = {}
        for case, args in cases.items():
            before = _lib.LAUNCHES[name]
            got = kernel(*args)
            require(_lib.LAUNCHES[name] == before + 1,
                    f"{name} {case}: {_lib.LAUNCHES[name] - before} launches "
                    f"in one call")
            want = twin(*args)
            errs[case] = (got.int() - want.int()).abs().max().item()
            require(torch.equal(got, want), f"{name} {case}: differs from "
                    f"its twin on {int((got != want).any(-1).sum())} pixels")
            if name == "render_views":
                require(views_are_singles(torch, got, args),
                        f"{name} {case}: a quadrant differs from the "
                        f"single launch's image")
        args = cases["loop"]
        px = args[0].shape[0] * args[0].shape[1]
        us = kernel_us(lambda: kernel(*args), name + "_kernel")
        row = dict(max_abs_err=max(errs.values()),
                   ms=cuda_ms(torch, lambda: kernel(*args), 50),
                   plain_ms=cuda_ms(torch, lambda: twin(*args), 10),
                   device_us=us[0], device_us_range=[us[1], us[2]],
                   launch_floor_us=floor, pixels=px,
                   **bound(px * RENDER_PIXEL_BYTES[name]
                           + (12 if name in ("render_volume", "render_views")
                              else 0),
                           px * RENDER_PIXEL_OPS[name]))
        rows[name] = row
        print(f"render {name}: bit-equal to its twin on {list(cases)} "
              f"(max abs err {row['max_abs_err']}); at {px} pixels device "
              f"{us[0]:.2f} us a launch (median of 20, {us[1]:.2f}-"
              f"{us[2]:.2f}; launch floor {floor:.2f}), bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), share "
              f"{row['bound_ms'] * 1e3 / us[0]:.3f}; call {row['ms']:.4f} "
              f"ms, twin {row['plain_ms']:.4f} ms ({card})")
    return rows


def views_are_singles(torch, got, args):
    """``render_views``' composite ``got`` of ``args`` holds the single
    launches' images in its quadrants and zeros top left."""
    from supereight_tpu_torch.kernels import render
    depth, result, vertex, normal, valid, pose, *light = args
    h, w = depth.shape
    return (not got[:h, :w].any()
            and torch.equal(got[:h, w:], render.render_depth(depth))
            and torch.equal(got[h:, :w], render.render_track(result))
            and torch.equal(got[h:, w:], render.render_volume(
                vertex, normal, valid, pose, *light)))


def single_renders_path(torch, pipe):
    """The class's three single renders (JAX's ``render_depth``,
    ``render_track`` and ``render_volume``) on the TSDF loop's last state,
    a path with the launch counts zeroed just before and read just after:
    one launch each, their images the composite's quadrants. Returns the
    path's launch counts."""
    import numpy as np
    from supereight_tpu_torch.kernels import _lib
    comp, *quadrants = pipe.render_views()
    torch.cuda.synchronize()
    _lib.reset_launches()
    images = (pipe.render_depth(), pipe.render_track(), pipe.render_volume())
    torch.cuda.synchronize()
    launches = {k: _lib.LAUNCHES[k] for k in PATHS["renders"]}
    same = all(np.array_equal(a, b) for a, b in zip(images, quadrants))
    print(f"renders: the class's three single renders launched {launches}; "
          f"their images equal render_views' quadrants: {same}")
    require(all(v == 1 for v in launches.values()) and same,
            f"renders: {launches}, equal to the quadrants: {same}")
    return launches


def rendering_column(torch, name, pipe, rows, eager_rows, tmp, card):
    """The log's ``rendering`` column over the rendered frames of the
    stage-graph run and of the ``eager=True`` run, and its split on the
    graph pipeline's last frame (``tools/render_loop.split``: the class's
    ``render_views`` call, its read into a fresh array and through a
    reused pinned buffer, and the PPM write, host ms medians of
    ``render_loop.REPS``). Returns them."""
    from supereight_tpu_torch.tools import render_loop
    field_args = PIPE_FIELD_ARGS[name]
    rate = int(field_args[field_args.index("-z") + 1])
    out = {run: render_loop.column_ms(r, rate)
           for run, r in (("graphs", rows), ("eager", eager_rows))}
    out["split"] = render_loop.split(pipe, os.path.join(tmp, "split.ppm"))
    print(f"pipeline {name}: the rendering column over the "
          f"{out['graphs']['frames']} rendered frames, mean / median ms: "
          f"graphs {out['graphs']['mean']:.4f} / "
          f"{out['graphs']['median']:.4f}, eager {out['eager']['mean']:.4f} "
          f"/ {out['eager']['median']:.4f}; a rendered frame's parts on the "
          f"last frame, host ms (median, min of {render_loop.REPS}): "
          + ", ".join(f"{k} {v['median']:.4f}, {v['min']:.4f}"
                      for k, v in out["split"].items()) + f" ({card})")
    return out


def pipeline_phase(torch, raw, tmp, card):
    """Both fields' class-pipeline paths over the loop, with the host-IO
    step around them (the native library and its reader first; after the
    TSDF run its telemetry, then a checkpoint resume and the mesh export
    through the native writer); both profiled; then the refusals of a
    flag whose package does not import and, where Pillow imports, the
    served loop (:func:`served_phase`); then the TSDF path with keyframes
    (:func:`ba_run`); K10 on the TSDF path's maps (the class's single
    renders as a path, :func:`single_renders_path`; :func:`check_render`)
    and its rendering column (:func:`rendering_column`). Returns the
    paths' launch counts, the closure icp_track's error against its twin,
    the BA solves' largest and K10's rows."""
    launches = {}
    host_io = check_native(raw, card)
    for name in ("tsdf", "ofusion"):
        tag = f"pipeline {name}"
        pipe, counts, numbers, rows, cli_counts = pipeline_run(
            torch, name, raw, tmp, card)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        eager_rows = pipeline_eager_cli(torch, name, raw, tmp, rows,
                                        cli_counts, numbers["ate"])
        ms = {"graphs": computation_ms(rows),
              "eager": computation_ms(eager_rows)}
        for run, c in ms.items():
            print(f"{tag}: computation {c['mean']:.4f} ms a frame "
                  f"{run} (the log's, --no-stage-sync; per frame median "
                  f"{c['median']:.4f}, max {c['max']:.4f}; from frame 4 "
                  f"on {c['mean_from_4']:.4f}; the slowest frames "
                  f"{ {f: round(v, 4) for f, v in c['slowest'].items()} }; "
                  f"{card})")
        print(f"{tag}: the stage graphs' aim <= {PIPE_AIM_MS} ms a frame "
              f"(printed, not held): mean {ms['graphs']['mean']:.4f} ms; the "
              f"host {numbers['replay_host_us']:.1f} us a frame in the "
              f"replays; {numbers['graphs']} graphs, pool "
              f"{numbers['pool_bytes']} bytes")
        numbers["computation"] = ms
        if name == "tsdf":
            for k, v in single_renders_path(torch, pipe).items():
                launches[k] = launches.get(k, 0) + v
            render_rows = check_render(torch, pipe, card)
            numbers["rendering"] = rendering_column(
                torch, name, pipe, rows, eager_rows, tmp, card)
        numbers["equal"] = pipeline_equal(torch, name, pipe, raw, card)
        if name == "tsdf":
            host_io.update(check_telemetry(torch, card))
            check_resume(torch, pipe, raw, tmp, tag)
            host_io.update(check_dump_mesh(pipe, tmp, tag, card))
            no_ba_ate = numbers["ate"]
            tsdf_peak_mib = numbers["peak_mib"]
        numbers.update(pipeline_profile(torch, pipe, raw,
                                        numbers["computation_ms"], tag))
        numbers["k3"] = pipeline_empty_cost(torch, pipe, tag)
        print(f"{tag}: {json.dumps(numbers)}")
        del pipe
        torch.cuda.empty_cache()
    have = check_refusals(raw, tmp)
    if have["PIL"]:
        counts, numbers = served_phase(torch, raw, tmp, card, tsdf_peak_mib)
        host_io.update(numbers)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
        counts, numbers = static_view_phase(torch, raw, tmp, card)
        host_io.update(numbers)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    print(f"host-io: {json.dumps(host_io)}")
    counts, closure_err, ba_err, numbers = ba_run(torch, raw, tmp, card,
                                                  no_ba_ate)
    print(f"pipeline tsdf-ba: {json.dumps(numbers)}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    return launches, closure_err, ba_err, render_rows


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
    (count and host ms, each ending with its host read; each solve's
    ``posegraph.graph.optimize`` arguments and result, cloned) of the
    pipeline runs inside."""
    from supereight_tpu_torch.constants import DIST_THRESHOLD
    from supereight_tpu_torch.ops import tracking
    from supereight_tpu_torch.posegraph import graph
    from supereight_tpu_torch.posegraph.keyframes import KeyframeManager
    seen = dict(tries=0, args=None, solves_ms=[], solves=[])
    track, optimize = tracking.icp_track, KeyframeManager.optimize
    solve = graph.optimize

    def icp_track(*args, dist_threshold=DIST_THRESHOLD, **kw):
        if dist_threshold != DIST_THRESHOLD:
            seen["tries"] += 1
            if seen["args"] is None:
                seen["args"] = tuple(
                    tuple(x.clone() for x in a) if isinstance(a, tuple)
                    else a.clone() for a in args[:8])
        return track(*args, dist_threshold=dist_threshold, **kw)

    def timed(self, *args, **kw):
        before = len(seen["solves"])
        t0 = time.perf_counter()
        out = optimize(self, *args, **kw)
        if len(seen["solves"]) > before:  # a window of one node solves none
            seen["solves_ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    def recorded(poses, g, num_nodes, iters=10, damping=1e-6, fixed=None):
        args = (poses.clone(), graph.PoseGraph(*(x.clone() for x in g)),
                num_nodes, iters, damping,
                None if fixed is None else fixed.clone())
        out = solve(poses, g, num_nodes, iters, damping, fixed)
        seen["solves"].append((args, out.clone()))
        return out
    tracking.icp_track, KeyframeManager.optimize = icp_track, timed
    graph.optimize = recorded
    try:
        yield seen
    finally:
        tracking.icp_track, KeyframeManager.optimize = track, optimize
        graph.optimize = solve


def ba_run(torch, raw, tmp, card, no_ba_ate):
    """The BA path: the TSDF pipeline through the CLI with keyframes
    (BA_ARGS), launch counts zeroed just before and read just after.
    Holds the drop counters to 0, the tracked fraction to MIN_TRACKED,
    the ATE to MAX_BA_ATE, at least one accepted closure (an edge between
    non-consecutive keyframes), icp_track launched once a frame plus once
    a closure try, ba_solve once a BA solve, one closure's icp_track
    against its twin with the 3x gate and every BA solve against its twin
    (:func:`check_ba_path_solve`). Returns the path's launch counts, the
    closure's error, the BA solves' largest and the path's numbers."""
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
    require_views(tag, launches, rendered_frames(argv, LOOP_FRAMES))
    require(launches["icp_track"] == LOOP_FRAMES + seen["tries"],
            f"{tag}: icp_track launched {launches['icp_track']} times for "
            f"{LOOP_FRAMES} frames and {seen['tries']} closure tries")
    require(launches["ba_solve"] == len(solves) == len(seen["solves"]),
            f"{tag}: ba_solve launched {launches['ba_solve']} times for "
            f"{len(solves)} BA solves")
    row = check_icp_track(torch, f"{tag} closure icp_track (gate "
                          f"{CLOSURE_DIST} m)", seen["args"],
                          dist_threshold=CLOSURE_DIST)
    ba_rows = [check_ba_path_solve(torch, f"{tag} BA solve {k}", args, out,
                                   host_ms, card)
               for k, ((args, out), host_ms) in enumerate(
                   zip(seen["solves"], solves))]
    del pipe
    return ({k: launches[k] for k in PATHS["pipeline-tsdf-ba"]},
            row["max_abs_err"], max(r["max_abs_err"] for r in ba_rows),
            dict(ate=ate, closures=len(closures), tries=seen["tries"],
                 solves=len(solves), ba=ba_rows))


def check_ba_path_solve(torch, tag, args, out, host_ms, card):
    """One BA solve of the path, replayed from its recorded arguments:
    its result (``out``) against the twin's (:func:`ba_errors`) and
    against the kernel run again, bit for bit; the manager's host ms
    (uploads, the solve, the read), the call's ms and the kernel's device
    us beside the twin's ms."""
    from supereight_tpu_torch.kernels import ba
    poses, graph, n = args[:3]
    err = ba_errors(torch, tag, out, ba.ba_solve_plain(*args), poses,
                    args[5])
    require(torch.equal(out, ba.ba_solve(*args)),
            f"{tag}: the kernel again differs from the path's solve")
    row = dict(n=n, edges=int(graph.valid.sum()), capacity=graph.i.shape[0],
               max_abs_err=err, host_ms=host_ms, **ba_times(torch, args))
    row.update(ba_bound(n, row["capacity"], row["edges"]))
    print(f"{tag}: n {n}, edges {row['edges']} of {row['capacity']}: host "
          f"{host_ms:.3f} ms (the manager's call; aim <= 5 ms, printed), "
          f"call {row['ms']:.4f} ms, device {row['device_us']:.1f} us; twin "
          f"{row['plain_ms']:.1f} ms; poses max err {err:.3e} (<= {BA_TOL}) "
          f"({card})")
    return row


def check_dump_mesh(pipe, tmp, tag, card):
    """dump_mesh of the pipeline's map to .obj through the native writer
    (``io/meshing.WRITES`` must count one native file and no Python one):
    it must produce triangles; its time, the writer's alone (the same
    triangles written again) and the file's size are printed."""
    from supereight_tpu_torch.io import meshing
    path = os.path.join(tmp, "loop.obj")
    before = dict(meshing.WRITES)
    t0 = time.perf_counter()
    tris = pipe.dump_mesh(path)
    dt = time.perf_counter() - t0
    wrote = {k: meshing.WRITES[k] - before[k] for k in before}
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    meshing.write_obj(path, tris)
    dt_write = time.perf_counter() - t0
    print(f"{tag}: dump_mesh of {pipe.block_count()} blocks: {len(tris)} "
          f"triangles, {size / 2**20:.1f} MiB .obj in {dt:.2f} s (one "
          f"download, host numpy marching cubes and the native writer; the "
          f"writer alone {dt_write:.2f} s; files by writer {wrote}; {card})")
    require(len(tris) > 0, f"{tag}: dump_mesh made no triangle")
    require(wrote == {"native": 1, "python": 0},
            f"{tag}: dump_mesh did not go through the native writer: "
            f"{wrote}")
    os.remove(path)
    return dict(mesh_s=dt, mesh_write_s=dt_write, triangles=len(tris),
                obj_mib=size / 2**20)


def check_native(raw, card):
    """The native library, built from native/src at first use (or taken
    from build/native/<hash>/): it must load, and its reader must give
    every frame of the loop .raw as the Python reader does, depth and
    RGB. Prints the build's time and the readers' times."""
    import numpy as np
    from supereight_tpu_torch.io import native
    from supereight_tpu_torch.io.dataset import RawDepthReader
    tag = "host-io native"
    t0 = time.perf_counter()
    ok = native.available()
    dt = time.perf_counter() - t0
    info = native.build_info
    print(f"{tag}: library ready in {dt:.2f} s (g++ "
          f"{info.get('seconds', 0.0):.2f} s, cached={info.get('cached')}, "
          f"{info.get('path')}); available {ok}")
    require(ok, f"{tag}: the native library did not build: "
            f"{info.get('error')}")
    fast, slow = native.NativeRawReader(raw), RawDepthReader(raw)
    require((fast.width, fast.height, fast.num_frames)
            == (slow.width, slow.height, slow.num_frames)
            == (640, 480, LOOP_FRAMES), f"{tag}: the readers' sizes differ")
    t_fast = t_slow = 0.0
    for i in range(LOOP_FRAMES):
        t0 = time.perf_counter()
        d, rgb = fast.read_frame(i)
        t1 = time.perf_counter()
        pd, prgb = slow.read_frame(i)
        t2 = time.perf_counter()
        t_fast += t1 - t0
        t_slow += t2 - t1
        require(np.array_equal(d, pd) and np.array_equal(rgb, prgb),
                f"{tag}: frame {i} differs from the Python reader's")
    fast.close()
    ms_fast, ms_slow = (1e3 * t / LOOP_FRAMES for t in (t_fast, t_slow))
    print(f"{tag}: NativeRawReader equals RawDepthReader on all "
          f"{LOOP_FRAMES} frames, depth and RGB ({ms_fast:.3f} against "
          f"{ms_slow:.3f} ms a frame; {card})")
    return dict(native_build_s=info.get("seconds", 0.0),
                native_cached=info.get("cached"), native_read_ms=ms_fast,
                python_read_ms=ms_slow)


def check_telemetry(torch, card):
    """DeviceMonitor's sample against the allocator and the card: the
    peak equals max_memory_allocated(), the limit the card's memory."""
    from supereight_tpu_torch.utils.telemetry import DeviceMonitor
    series = DeviceMonitor().sample().series
    got = {k: v[-1] for k, v in series.items()}
    peak = torch.cuda.max_memory_allocated(0)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"host-io telemetry: {got}; max_memory_allocated {peak}, the "
          f"card's memory {total} ({card})")
    require(got.get("dev0.peak_bytes_in_use") == peak,
            "host-io telemetry: the peak differs from max_memory_allocated")
    require(got.get("dev0.bytes_limit") == total,
            "host-io telemetry: the limit differs from the card's memory")
    require(0 < got.get("dev0.bytes_in_use", 0) <= peak,
            "host-io telemetry: bytes in use out of range")
    return dict(peak_bytes=peak, bytes_limit=total)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def read_stream_frame(port):
    """The first JPEG of the viewer's MJPEG stream."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream",
                                timeout=10) as r:
        require(r.readline().strip() == b"--se8frame",
                "host-io served: no stream boundary")
        r.readline()
        n = int(r.readline().split(b":")[1])
        r.readline()
        return r.read(n)


class ServedSession:
    """The CLI with --serve in a daemon thread, its viewer started
    paused so the script sets the pace over HTTP; every request has a
    timeout and every wait a deadline."""

    def __init__(self, argv):
        import threading
        from supereight_tpu_torch import webviewer
        self.viewers = []
        session = self

        class Paused(webviewer.LiveViewer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.paused = True
                session.viewers.append(self)
        self.webviewer, self.original = webviewer, webviewer.LiveViewer
        webviewer.LiveViewer = Paused
        self.port = free_port()
        self.result = {}
        self.thread = threading.Thread(
            target=self._run, args=(argv + ["--serve", str(self.port)],),
            daemon=True)
        self.thread.start()

    def _run(self, argv):
        from supereight_tpu_torch import cli
        try:
            self.result["pipe"] = cli.run(argv)
            self.result["done"] = True
        except BaseException as e:   # raised again by the script's thread
            self.result["error"] = e

    def stats(self):
        return json.loads(http_get(self.port, "/stats")[1])

    def ctl(self, cmd):
        require(http_get(self.port, "/ctl?cmd=" + cmd)[0] == 204,
                f"host-io served: /ctl?cmd={cmd} refused")

    def wait(self, cond, what):
        end = time.perf_counter() + SERVE_DEADLINE
        while time.perf_counter() < end:
            if "error" in self.result:
                raise self.result["error"]
            got = cond()
            if got:
                return got
            time.sleep(SERVE_POLL)
        raise RuntimeError(f"host-io served: timed out waiting for {what}")

    def settle(self):
        """The stats of a paused run once its last frame is pushed."""
        def still():
            a = self.stats()
            time.sleep(0.3)
            return a == self.stats() and a
        return self.wait(still, "the pause to settle")

    def close(self):
        self.webviewer.LiveViewer = self.original
        for v in self.viewers:
            v.paused = False
        self.thread.join(SERVE_DEADLINE)
        for v in self.viewers:
            v.stop()


def served_phase(torch, raw, tmp, card, tsdf_peak_mib):
    """The served TSDF loop, a path with the launch counts zeroed just
    before and read just after: SERVED_FRAMES frames with --serve and no
    control request must log pipeline-tsdf's first rows bit for bit;
    then the controlled session (ground-truth poses, the whole loop):
    /stats advances, a pause holds the frame count PAUSE_HOLD s, resume
    lets it go on, /stream's JPEG decodes to the composite's size, the
    static view launches K1's unprimed march, a reset makes the block
    count fall and rise again, every drop counter stays 0 and the peak
    memory stays within SERVED_PEAK_RATIO of pipeline-tsdf's. Returns the
    path's launch counts and its numbers."""
    from PIL import Image
    from supereight_tpu_torch import cli
    from supereight_tpu_torch.kernels import _lib
    tag = "host-io served"
    log = os.path.join(tmp, "served.log")
    rows_ref = open(os.path.join(tmp, "tsdf.log")).read().splitlines()
    err = io.StringIO()
    torch.cuda.synchronize()
    _lib.reset_launches()
    with contextlib.redirect_stderr(err):
        cli.run(loop_argv(raw, "tsdf", log, SERVED_FRAMES)
                + ["--serve", str(free_port())])
    rows = open(log).read().splitlines()
    xyz = [r.split("\t")[9:12] for r in rows[1:]]
    require(len(xyz) == SERVED_FRAMES
            and xyz == [r.split("\t")[9:12]
                        for r in rows_ref[1:SERVED_FRAMES + 1]],
            f"{tag}: the run without controls differs from pipeline-tsdf")
    require("# live view: http://localhost:" in err.getvalue(),
            f"{tag}: the run served nothing")
    print(f"{tag}: {SERVED_FRAMES} frames with --serve and no control "
          "request: X/Y/Z equal to pipeline-tsdf's first rows, as text")

    torch.cuda.reset_peak_memory_stats()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        s = ServedSession(loop_argv(raw, "tsdf", log, LOOP_FRAMES)
                          + ["--groundtruth-mode"])
        try:
            s.wait(lambda: s.viewers and s.stats() == {}, "the server")
            s.ctl("resume")
            first = s.wait(lambda: (st := s.stats()).get("frame", -1) >= 8
                           and st, "frame 8")
            second = s.wait(lambda: (st := s.stats())["frame"]
                            > first["frame"] and st, "/stats to advance")
            s.ctl("pause")
            held = s.settle()
            t0 = time.perf_counter()
            time.sleep(PAUSE_HOLD)
            after = s.stats()
            hold = time.perf_counter() - t0
            require(after == held, f"{tag}: the pause did not hold: "
                    f"{held['frame']} -> {after['frame']}")
            image = Image.open(io.BytesIO(read_stream_frame(s.port)))
            image.load()
            # the 2x2 composite of the computation-size views
            ratio = int(PIPE_ARGS[PIPE_ARGS.index("-c") + 1])
            require(image.size == (2 * 640 // ratio, 2 * 480 // ratio),
                    f"{tag}: the stream's JPEG is {image.size}")
            cold = _lib.LAUNCHES["raycast_cold"]
            require(cold == 0, f"{tag}: the camera view launched "
                    f"raycast_cold {cold} times")
            s.ctl("view=static")
            s.ctl("resume")
            s.wait(lambda: s.stats()["frame"] >= held["frame"] + 8,
                   "two static renders")
            s.ctl("pause")
            s.ctl("view=follow")
            before = s.settle()
            cold = _lib.LAUNCHES["raycast_cold"]
            require(cold >= 2, f"{tag}: the static view launched "
                    f"raycast_cold {cold} times")
            s.ctl("reset")
            s.ctl("resume")
            fell = s.wait(lambda: (st := s.stats())["frame"]
                          > before["frame"] and st, "a frame after reset")
            require(fell["blocks"] < before["blocks"],
                    f"{tag}: the reset did not empty the map: "
                    f"{before['blocks']} -> {fell['blocks']}")
            rose = s.wait(lambda: (st := s.stats())["blocks"]
                          > fell["blocks"] and st, "the blocks to rise")
            s.thread.join(SERVE_DEADLINE)
            require(not s.thread.is_alive() and s.result.get("done"),
                    f"{tag}: the session did not finish: {s.result}")
        finally:
            s.close()
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    _, drops, fps = cli_stderr(err.getvalue())
    print(f"{tag}: session over the {LOOP_FRAMES}-frame loop (ground-truth "
          f"poses): /stats frame {first['frame']:.0f} -> "
          f"{second['frame']:.0f}; paused at frame {held['frame']:.0f}, "
          f"held {hold:.2f} s; stream JPEG {image.size}; static view "
          f"launched raycast_cold {cold} times; reset at frame "
          f"{before['frame']:.0f}: blocks {before['blocks']:.0f} -> "
          f"{fell['blocks']:.0f} (frame {fell['frame']:.0f}) -> "
          f"{rose['blocks']:.0f} (frame {rose['frame']:.0f}); drops {drops}; "
          f"peak device memory {peak_mib:.1f} MiB (pipeline-tsdf "
          f"{tsdf_peak_mib:.1f}); wall fps {fps} ({card})")
    print(f"{tag}: kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    require(drops is not None and all(v == 0 for v in drops.values()),
            f"{tag}: drop counters nonzero: {drops}")
    require(peak_mib <= SERVED_PEAK_RATIO * tsdf_peak_mib,
            f"{tag}: peak {peak_mib:.1f} MiB: the reset kept two pools")
    require(all(launches[k] > 0 for k in PATHS["served"]),
            f"{tag}: a kernel of the path was not launched: {launches}")
    require_views(tag, launches)
    numbers = dict(pause_hold_s=hold, paused_frame=held["frame"],
                   reset_frame=before["frame"],
                   blocks=[before["blocks"], fell["blocks"],
                           rose["blocks"]],
                   raycast_cold=cold, served_peak_mib=peak_mib,
                   served_wall_fps=fps)
    return {k: launches[k] for k in PATHS["served"]}, numbers


def static_view_phase(torch, raw, tmp, card):
    """The served TSDF loop in the viewer's static view (a
    :class:`ServedSession` switched to ``view=static`` before its first
    frame, then let run: the view pinned at the raycast pose of frame 4,
    so that every rendered frame is a fresh view of a map that grows) on
    the stage graphs, a path with the launch
    counts zeroed just before and read just after, then again with the
    class's ``eager=True``, both writing PPMs: the PPMs equal byte for
    byte, the log's rows (frame, position, flags) and ATE equal, each
    rendered frame one K1 unprimed launch and one ``render_views`` in both
    runs, the graph run's fresh views through one graph, each after the
    first a replay (``Graphs.replays``), drops 0; prints the log's ``rendering`` column over
    the rendered frames of both runs. Returns the path's launch counts
    and the numbers."""
    from supereight_tpu_torch.eval.sweep import parse_frame_log
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.tools import render_loop
    tag = "host-io served static"
    field_args = PIPE_FIELD_ARGS["tsdf"]
    rate = int(field_args[field_args.index("-z") + 1])
    want = sum(1 for f in range(LOOP_FRAMES) if f % rate == 0 and f > 2)
    cols = ("frame", "X", "Y", "Z", "tracked", "integrated")
    runs = {}
    for run in ("graphs", "eager"):
        log = os.path.join(tmp, f"static-{run}.log")
        ppms = os.path.join(tmp, f"static-{run}")
        torch.cuda.synchronize()
        _lib.reset_launches()
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                render_loop.eager_cli(run == "eager"):
            s = ServedSession(loop_argv(raw, "tsdf", log, LOOP_FRAMES)
                              + ["--dump-renders", ppms])
            try:
                s.wait(lambda: s.viewers and s.stats() == {}, "the server")
                s.ctl("view=static")
                s.ctl("resume")
                s.thread.join(SERVE_DEADLINE)
                require(not s.thread.is_alive() and s.result.get("done"),
                        f"{tag}: the {run} session did not finish: "
                        f"{s.result}")
            finally:
                s.close()
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
        pipe = s.result.pop("pipe")
        fresh = [] if pipe._graphs is None else [
            k for k in pipe._graphs.entries if k[0] == "fresh_view"]
        keys = len(fresh)
        replays = sum(pipe._graphs.replays[k] for k in fresh)
        del pipe
        torch.cuda.empty_cache()
        rows = parse_frame_log(log)
        ate, drops, fps = cli_stderr(err.getvalue())
        digest, n = render_loop.ppm_digest(ppms)
        runs[run] = dict(launches=launches, replays=replays, keys=keys,
                         rows=[{c: r[c] for c in cols} for r in rows],
                         ate=ate, drops=drops, fps=fps, sha256=digest,
                         ppms=n, column=render_loop.column_ms(rows, rate))
    g, e = runs["graphs"], runs["eager"]
    print(f"{tag}: the {LOOP_FRAMES}-frame loop served in the static view "
          f"(pinned at frame 4; {g['ppms']} rendered frames, each a fresh "
          f"view): the rendering column, mean / median ms, graphs "
          f"{g['column']['mean']:.4f} / {g['column']['median']:.4f}, eager "
          f"{e['column']['mean']:.4f} / {e['column']['median']:.4f} (the "
          f"composite's render and read, the JPEG push, the PPM write); "
          f"PPMs equal {g['sha256'] == e['sha256']} (SHA-256 "
          f"{g['sha256'][:16]}), rows and ATE equal "
          f"{g['rows'] == e['rows'] and g['ate'] == e['ate']} (ATE "
          f"{g['ate']:.4f} m); fresh-view graphs {g['keys']}, replays "
          f"{g['replays']}; launches equal {g['launches'] == e['launches']}; "
          f"wall fps {g['fps']} / {e['fps']} ({card})")
    require(g["sha256"] == e["sha256"] and g["ppms"] == e["ppms"] == want,
            f"{tag}: the PPMs differ or miss: {g['ppms']}, {e['ppms']} of "
            f"{want}")
    require(g["rows"] == e["rows"] and g["ate"] == e["ate"],
            f"{tag}: the eager run's rows or ATE differ")
    require(g["launches"] == e["launches"], f"{tag}: launches "
            f"{g['launches']} against the eager run's {e['launches']}")
    require(g["launches"]["raycast_cold"] == want
            and g["launches"]["render_views"] == want,
            f"{tag}: a rendered frame is not one fresh view: "
            f"{g['launches']}")
    require(g["keys"] == 1 and g["replays"] == want - 1
            and e["keys"] == e["replays"] == 0,
            f"{tag}: fresh-view graphs {g['keys']}, replays {g['replays']}")
    for r in runs.values():
        require(r["drops"] is not None
                and all(v == 0 for v in r["drops"].values()),
                f"{tag}: drop counters nonzero: {r['drops']}")
    require(all(g["launches"][k] > 0 for k in PATHS["served-static"]),
            f"{tag}: a kernel of the path was not launched: {g['launches']}")
    numbers = {f"static_{run}": dict(column=r["column"], sha256=r["sha256"],
                                     ppms=r["ppms"], fps=r["fps"],
                                     replays=r["replays"])
               for run, r in runs.items()}
    return {k: g["launches"][k] for k in PATHS["served-static"]}, numbers


def check_refusals(raw, tmp):
    """A flag whose package does not import exits naming it before the
    pipeline is built; where matplotlib imports, --plot-out writes a PNG
    (Pillow's case is the served session)."""
    import importlib.util
    from supereight_tpu_torch import cli
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "matplotlib")}
    print(f"host-io: Pillow imports {have['PIL']}, matplotlib imports "
          f"{have['matplotlib']}")
    png = os.path.join(tmp, "plot.png")
    for flag, value, module, package in (
            ("--serve", str(free_port()), "PIL", "Pillow"),
            ("--plot-out", png, "matplotlib", "matplotlib")):
        if have[module]:
            continue
        argv = loop_argv(raw, "tsdf", os.path.join(tmp, "refused.log"), 8)
        try:
            cli.run(argv + [flag, value])
            msg = None
        except SystemExit as e:
            msg = str(e)
        print(f"host-io: {flag} without {package}: exits with {msg!r}")
        require(msg is not None and f"{flag} needs {package}" in msg,
                f"host-io: {flag} did not refuse cleanly: {msg!r}")
    if have["matplotlib"]:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            cli.run(loop_argv(raw, "tsdf", os.path.join(tmp, "plot.log"), 8)
                    + ["--plot-out", png])
        require(open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n",
                "host-io: --plot-out wrote no PNG")
        print(f"host-io: --plot-out wrote {os.path.getsize(png)} bytes")
    return have


def dist_map(torch, geom, field, dev, **tensors):
    """A map of ``geom`` on ``dev`` whose fields given by name are copies
    of ``tensors`` (a mode check's captured inputs)."""
    from supereight_tpu_torch.core.map import make_map
    m = make_map(geom, field, dev)
    for name, v in tensors.items():
        if isinstance(v, tuple):
            for a, b in zip(getattr(m, name), v):
                a.copy_(b)
        else:
            getattr(m, name).copy_(v)
    return m


def captured(cap, name):
    """(args, kwargs, result) of the step's call ``name`` at the capture
    frame (``tools/dist_run.capturing``)."""
    c = cap["calls"][name]
    return c["args"], c["kwargs"], c["result"]


def check_dist_icp(torch, cap, tag):
    """Mode A on a rank's captured inputs (the step's track call): K6
    icp_reduce (one cluster launch) over the rank's column window of every
    pyramid level (80, 40 and 20 columns at the bench config) against its
    twin, codes on >= 99.9 % of pixels and each of the 32 f64 sums to
    1e-4 of itself (plus 1e-4 of the largest: the finest-level check of
    the kernel phase), the sums without a result map and a second launch
    bit-identical; the fused mode icp_reduce_step from the finest level's
    sums (the frame's first update, a mid-level one, one before a level's
    first iteration and a frozen one, whose sums must be zeros) against
    its twin: the carry's pose to 1e-6, its reduction and done exactly,
    the sums as icp_reduce's; then icp_update (a level's first iteration
    with check_pose, and a frozen iteration) against its twin: pose and
    checked pose to 1e-6, the reduction, done and tracked exactly. Then
    the rank's whole tracking of the frame, replayed without collectives
    (``tools/sharded_icp``): its ICP device us and launches. Returns the
    three kernels' rows (each timed as the path launches it: no result
    map, the update with check_pose)."""
    from supereight_tpu_torch.kernels import frame, icp
    from supereight_tpu_torch.tools import sharded_icp
    track_args = captured(cap, "track")[0]
    (pose, raycast_pose, k, verts, norms, valids, ref_v, ref_n, ref_ok,
     *_) = track_args
    view = frame.frame_mats(k, raycast_pose).view
    agree, red_err, abs_err, wins, same = 1.0, 0.0, 0.0, [], True
    for level in range(len(verts)):
        wl = verts[level].shape[1] // cap["world"]
        win = dict(x0=cap["rank"] * wl, width=wl)
        args = (verts[level], norms[level], valids[level], ref_v, ref_n,
                ref_ok, pose, view)
        res, red = icp.icp_reduce64(*args, **win)
        res_p, red_p = icp.icp_reduce64_plain(*args, **win)
        none, again = icp.icp_reduce64(*args, **win, with_result=False)
        same &= none is None and torch.equal(again, red)
        agree = min(agree, (res == res_p).float().mean().item())
        red_err = max(red_err, ((red - red_p).abs() / (
            red_p.abs() + 1e-4 * red_p.abs().max())).max().item())
        abs_err = max(abs_err, (red - red_p).abs().max().item())
        wins.append(f"level {level} [{win['x0']}, {win['x0'] + wl})")
        if level == 0:
            args0, win0, red0 = args, win, red
    size = tuple(ref_v.shape[:2])
    zero = torch.zeros((), dtype=torch.bool, device=pose.device)
    mid = icp.Carry(pose, red0.to(torch.float32), zero)
    frozen = mid._replace(done=~zero)
    level0 = args0[:6] + (view,)
    step_err, step_same, frozen_zero = 0.0, True, True
    for carry, first, next_first in ((None, True, False), (mid, False, False),
                                     (mid, False, True),
                                     (frozen, False, False)):
        got = icp.icp_reduce_step(red0, pose, carry, first, next_first, 1e-5,
                                  *level0, **win0)
        want = icp.icp_reduce_step_plain(red0, pose, carry, first,
                                         next_first, 1e-5, *level0, **win0)
        step_err = max(step_err,
                       (got[0].pose - want[0].pose).abs().max().item())
        step_same &= torch.equal(got[0].reduction, want[0].reduction) \
            and torch.equal(got[0].done, want[0].done)
        red_err = max(red_err, ((got[1] - want[1]).abs() / (
            want[1].abs() + 1e-4 * want[1].abs().max() + 1e-30)).max()
            .item())
        abs_err = max(abs_err, (got[1] - want[1]).abs().max().item())
        if carry is frozen:
            frozen_zero = not bool(got[1].any())
    errs = []
    for carry, first, old in ((None, True, pose), (frozen, False, None)):
        got = icp.icp_update(red0, pose, carry, first, 1e-5, old, size)
        want = icp.icp_update_plain(red0, pose, carry, first, 1e-5, old,
                                    size)
        errs.append((got[0].pose - want[0].pose).abs().max().item())
        same &= torch.equal(got[0].reduction, want[0].reduction) \
            and torch.equal(got[0].done, want[0].done)
        if old is not None:
            errs.append((got[1][0] - want[1][0]).abs().max().item())
            same &= torch.equal(got[1][1], want[1][1])
    err = max(errs)
    print(f"{tag}: icp_reduce over the columns of {', '.join(wins)}: codes "
          f"agree on {agree:.6f} (>= 0.999), sums' largest relative err "
          f"{red_err:.2e} (<= 1e-4), absolute {abs_err:.2e}; "
          f"icp_reduce_step pose err {step_err:.2e} (<= 1e-6), reduction "
          f"and done equal: {step_same}, frozen sums zero: {frozen_zero}; "
          f"icp_update pose err {err:.2e} (<= 1e-6), reduction, done and "
          f"tracked equal, no-result sums and a second launch bit-equal: "
          f"{same}")
    require(agree >= 0.999 and red_err <= 1e-4 and err <= 1e-6 and same
            and step_err <= 1e-6 and step_same and frozen_zero,
            f"{tag}: a sharded ICP mode disagrees with its twin")

    # a rank's tracking of this frame, replayed with the ranks' sums and
    # no collective
    sargs, iterations, thr = sharded_icp.sharded_args(track_args)
    sums, frozen_its = sharded_icp.record(sargs, iterations, thr)
    replays = sharded_icp.split_replays(sharded_icp.device_events(
        lambda: sharded_icp.replay(sargs, iterations, thr, sums)),
        len(sums))
    require(len(replays) > 0, f"{tag}: no replay of the rank's tracking "
            "showed all its launches in the trace")
    frame_icp = sharded_icp.summarize(replays, iterations, frozen_its)
    print(f"{tag}: rank {cap['rank']}'s ICP of the frame, replayed without "
          f"collectives: {frame_icp['icp_us']:.2f} device us in "
          f"{frame_icp['launches']:.1f} launches ({sum(frozen_its)} of "
          f"{len(frozen_its)} iterations frozen; per level, finest first, "
          f"icp_reduce us a launch "
          f"{[round(lv['reduce_us'], 2) for lv in frame_icp['levels']]}; "
          f"{frame_icp['replays']} replays seen whole; a frozen "
          f"iteration's launch {frame_icp['frozen_us']} us)")

    # each timed as the path launches it
    n0 = args0[0].shape[0] * win0["width"]
    # the window's pixels and one reference pixel each, pose, view, sums
    reduce_bytes = 2 * n0 * ICP_PIXEL_BYTES + 2 * 64 + 32 * 8
    carry_bytes = 64 + 32 * 4 + 1
    out = torch.empty(32, dtype=torch.float64, device=pose.device)
    cout = icp.Carry(torch.empty_like(pose), torch.empty_like(mid.reduction),
                     torch.empty_like(zero))

    def reduce():
        return icp.icp_reduce64(*args0, **win0, with_result=False, out=out)

    def reduce_plain():
        return icp.icp_reduce64_plain(*args0, **win0)

    def step():
        return icp.icp_reduce_step(red0, pose, mid, False, False, 1e-5,
                                   *level0, **win0, out=out, carry_out=cout)

    def step_plain():
        return icp.icp_reduce_step_plain(red0, pose, mid, False, False, 1e-5,
                                         *level0, **win0)

    def update():
        return icp.icp_update(red0, pose, mid, False, 1e-5, pose, size)

    def update_plain():
        return icp.icp_update_plain(red0, pose, mid, False, 1e-5, pose, size)

    rows = {}
    for name, fn, plain, n_bytes, n_ops in (
            ("icp_reduce", reduce, reduce_plain, reduce_bytes,
             n0 * ICP_PIXEL_OPS),
            # the sums, the carry in and out besides
            ("icp_reduce_step", step, step_plain,
             reduce_bytes + 32 * 8 + 2 * carry_bytes - 64,
             n0 * ICP_PIXEL_OPS + ICP_SOLVE_OPS),
            # the sums, the carry in and out, the old pose, the checked
            # pose and flag
            ("icp_update", update, update_plain,
             32 * 8 + 2 * carry_bytes + 64 + 64 + 1, ICP_SOLVE_OPS)):
        rows[name] = dict(max_abs_err=abs_err if name == "icp_reduce"
                          else step_err if name == "icp_reduce_step"
                          else err,
                          device_us=device_us(torch, fn, 20, 1),
                          ms=cuda_ms(torch, fn, KERNEL_REPS),
                          plain_ms=cuda_ms(torch, plain, TWIN_REPS),
                          **bound(n_bytes, n_ops))
        print(f"{tag}: {name} as the path launches it: "
              f"{rows[name]['device_us']:.2f} device us; bound "
              f"{rows[name]['bound_ms'] * 1e3:.4f} us "
              f"({rows[name]['bound_by']})")
    rows["icp_reduce_step"]["rank_frame"] = frame_icp
    return rows


def check_dist_alloc(torch, cap, field, tag):
    """Mode B on a rank's captured inputs: the field's march over the
    rank's columns against its twin, every grid bit for bit, and
    alloc_assign with the owner mask on the ranks' union of grids (the
    touched buffer of the map the step passed it) against its twin (slot
    grid, block_coord, active, n_blocks, mip_alloc and alloc_overflow
    exactly; the grids all zero after either)."""
    from supereight_tpu_torch.core.map import touched_buffer, touched_grids
    from supereight_tpu_torch.kernels import alloc
    from supereight_tpu_torch.parallel.dist_step import owner_grid
    march_name = "touched_mask" if field.name == "tsdf" \
        else "touched_masks_of"
    (geom, depth, pose, kpose, mu), kw, _ = captured(cap, march_name)
    b = geom.blocks_per_side
    x0, w = kw["x0"], kw["width"]
    win = depth[:, x0:x0 + w]
    levels = 1 if field.name == "tsdf" else 3

    def march(out):
        fn = getattr(alloc, march_name)
        got = fn(geom, depth, pose, kpose, mu, out=out, x0=x0, width=w)
        return (got,) if field.name == "tsdf" else got

    def plain():
        fn = getattr(alloc, march_name + "_plain")
        return fn(geom, win, pose, kpose, mu, x_offset=x0)

    got = march(touched_buffer(b, depth.device))
    want = (plain(),) if field.name == "tsdf" else plain()
    mism = sum(int((a != c).sum()) for a, c in zip(got, want))
    scratch = touched_buffer(b, depth.device)
    bnd = (alloc_bound if field.name == "tsdf" else alloc_of_bound)(
        torch, geom, win, pose, kpose, mu, x0)
    march_row = dict(max_abs_err=float(mism),
                     device_us=device_us(torch, lambda: march(scratch), 20,
                                         1),
                     ms=cuda_ms(torch, lambda: march(scratch), KERNEL_REPS),
                     plain_ms=cuda_ms(torch, plain, TWIN_REPS), **bnd)
    print(f"{tag}: march over columns [{x0}, {x0 + w}): touched cells per "
          f"level {[int(g.sum()) for g in want]}, mismatches {mism} (== 0)")
    require(mism == 0, f"{tag}: the windowed march disagrees with its twin")

    (geom, m0, _, when), kw, _ = captured(cap, "alloc_assign")
    fields = {n: getattr(m0, n) for n in ("slot", "block_coord", "active",
                                          "n_blocks", "mip_alloc")}
    union, owner, rank = m0.touched, kw["owner"], kw["rank"]
    # the kernel computes each cell's owner (alloc.Owners); the foreign
    # check reads the step's morton owner grid
    own = owner_grid(geom, owner.world, owner.tile, device=depth.device)

    def call(fn, m, buf):
        g = touched_grids(buf, b, levels)
        return fn(geom, m, g[0], when, None, g[1:], owner, rank)

    ma = dist_map(torch, geom, field, depth.device, **fields)
    mb = dist_map(torch, geom, field, depth.device, **fields)
    ua, ub = union.clone(), union.clone()
    over, over_p = int(call(alloc.alloc_assign, ma, ua)), int(call(
        alloc.alloc_assign_plain, mb, ub))
    bad = {n: int((getattr(ma, n) != getattr(mb, n)).sum())
           for n in ("slot", "block_coord", "active", "n_blocks")}
    bad["mip_alloc"] = sum(int((a != c).sum())
                           for a, c in zip(ma.mip_alloc, mb.mip_alloc))
    owned = (ma.slot >= 0) & (fields["slot"] < 0)
    foreign = int((own[owned] != rank).sum())
    n_new = int(owned.sum())
    print(f"{tag}: alloc_assign owned by rank {rank}: {n_new} new blocks "
          f"(the union touched {int(touched_grids(union, b, 1)[0].sum())} "
          f"cells), another rank's among them {foreign} (0), "
          f"alloc_overflow {over} vs {over_p}, mismatches {bad} (all 0), "
          f"grid bytes left set {int(ua.sum())} / {int(ub.sum())} (0)")
    require(over == over_p and sum(bad.values()) == 0 and foreign == 0
            and n_new > 0 and not ua.any() and not ub.any(),
            f"{tag}: the owned allocation disagrees with its twin")
    # each call its own copy of the union, made before: the timed calls,
    # each timing's untimed first call and every profiler try's 20
    copies = iter([union.clone() for _ in range(
        KERNEL_REPS + TWIN_REPS + 2 + 1 + PROFILE_TRIES * 20)])
    grids = touched_grids(union, b, levels)
    mip_set = sum(int((a != c).sum())
                  for a, c in zip(ma.mip_alloc, fields["mip_alloc"]))
    assign_row = dict(
        max_abs_err=float(sum(bad.values()) + abs(over - over_p)),
        device_us=device_us(torch, lambda: call(alloc.alloc_assign, ma,
                                                next(copies)), 20, 1),
        ms=cuda_ms(torch, lambda: call(alloc.alloc_assign, ma, next(copies)),
                   KERNEL_REPS),
        plain_ms=cuda_ms(torch, lambda: call(alloc.alloc_assign_plain, mb,
                                             next(copies)), TWIN_REPS),
        # the level-0 grid, and the slot entries under its set cells, read
        # once; the coarse grids, the cleared sectors, the new entries and
        # the mip bytes set written once
        **bound(b ** 3 + 4 * int(grids[0].sum())
                + sum(g.numel() for g in grids[1:])
                + SECTOR * set_sectors(torch, grids) + 17 * n_new + mip_set
                + 8, b ** 3))
    return march_row, assign_row


def check_dist_local(torch, cap, tag):
    """K3 and K4 on the rank's captured local map (after its owned
    allocation, before its integration; capacity and worklist budget
    36,864 / 4), fusing the frame's depth at its pose, against their
    twins with the single-device phases' checks (:func:`check_block_pass`,
    :func:`check_node_pass`). Returns each kernel's max_abs_err."""
    import types
    (geom, m, field, depth, pose, k, mu, ts, _), kw, _ = captured(
        cap, "integrate")
    sc = types.SimpleNamespace(geom=geom, field=field, mu=mu, kt=k,
                               dev=depth.device, budget=kw["budget"])
    errs = {name: row["max_abs_err"] for name, (row, _, _) in
            check_block_pass(torch, sc, m, pose, depth, ts,
                             f"{tag} K3 (capacity {geom.capacity})")[0]
            .items()}
    errs.update((name, row["max_abs_err"]) for name, (row, _, _) in
                check_node_pass(torch, sc, m, pose, depth, ts,
                                f"{tag} K4 node_pass (capacity "
                                f"{geom.capacity})").items())
    return errs


def check_dist_halo(torch, cap, field, tag):
    """Mode C on a rank's captured map (after the frame's integration):
    halo_pack with the frustum test and without, and with the frustum
    test under a budget of half the rows it sends (overflow > 0), against
    its twin: the counts and cell ids exactly, the flagged rows' bricks
    bit for bit."""
    from supereight_tpu_torch.kernels import halo
    args = captured(cap, "halo_pack")[0][:7]
    m, budget = args[1], args[5]
    err, rows = 0.0, {}
    for frustum, cut in ((True, False), (False, False), (True, True)):
        a = list(args)
        if cut:
            a[5] = max(rows[True] // 2, 1)
        got, cnt = halo.halo_pack(*a, frustum)
        want, cnt_p = halo.halo_pack_plain(*a, frustum)
        filled, bud = int(cnt_p[0]), a[5]
        diff = [(got[r] - want[r]).abs().max().item() if filled else 0.0
                for r in (slice(0, filled), slice(bud, bud + filled))]
        same = torch.equal(cnt, cnt_p) and torch.equal(
            halo.cells_of(got, bud), halo.cells_of(want, bud))
        print(f"{tag}: halo_pack (frustum {frustum}, budget {bud}): "
              f"{filled} of {int(m.n_blocks)} blocks sent, overflow "
              f"{int(cnt[1])}, counts and cells equal: {same}, brick max err "
              f"{max(diff):.1e} (0)")
        require(same and max(diff) == 0.0 and (int(cnt[1]) > 0) == cut,
                f"{tag}: halo_pack disagrees with its twin")
        err = max(err, max(diff))
        if not cut:
            rows[frustum] = filled
    n = int(m.n_blocks)
    row = dict(max_abs_err=err,
               device_us=device_us(torch, lambda: halo.halo_pack(*args, True),
                                   20, 1),
               ms=cuda_ms(torch, lambda: halo.halo_pack(*args, True),
                          KERNEL_REPS),
               plain_ms=cuda_ms(torch, lambda: halo.halo_pack_plain(
                   *args, True), TWIN_REPS),
               # the slots' coordinates, the sent bricks read and written,
               # the cell ids and counts
               **bound(12 * n + 4 + 2 * 4096 * rows[True] + 4 * budget + 8
                       + 128, HALO_FLAG_OPS * n))
    return row


def check_dist_raycast(torch, cap, tag):
    """Mode D on a rank's captured halo: K2 on the gathered table (its
    capacity D x the halo rows less the budget, its slot grid the
    scatter's) against its twin and equal to the nav grid the step used,
    and K1 over the rank's columns against its twin
    (:func:`check_raycast`'s tolerances). Returns K1's row and K2's
    error."""
    from supereight_tpu_torch.kernels import nav, raycast
    (hgeom, hs_nav, field), _, step_nav = captured(cap, "nav_grid")
    nv = nav.nav_grid(hgeom, hs_nav, field)
    nv_p = nav.nav_grid_plain(hgeom, hs_nav, field)
    nav_bad = int((nv != nv_p).sum())
    print(f"{tag}: K2 nav_grid on the halo table (capacity "
          f"{hgeom.capacity}, {int((hs_nav.slot >= 0).sum())} blocks): "
          f"{nav_bad} entries differ from the twin (0), equal to the "
          f"step's: {torch.equal(nv, step_nav)}")
    require(nav_bad == 0 and torch.equal(nv, step_nav),
            f"{tag}: K2 on the halo disagrees with its twin or the step")
    (hgeom, hs, field, _, view, depth, k, mu, size), kw, _ = captured(
        cap, "raycast_rays")
    x0, w = kw["x0"], kw["width"]

    def call():
        return raycast.raycast_rays(hgeom, hs, field, nv, view, depth, k, mu,
                                    size, x0=x0, width=w)

    def plain(with_probes=False):
        return raycast.raycast_plain(hgeom, field, hs.data_x, hs.data_y, nv,
                                     view, depth, k, mu, size,
                                     with_probes=with_probes, x0=x0,
                                     width=w)

    got = call()
    ref, probes = plain(True)
    v_err = check_raycast(torch, f"{tag}: K1 over columns [{x0}, {x0 + w})",
                          got, ref)
    return dict(max_abs_err=v_err, device_us=device_us(torch, call, 20, 1),
                ms=cuda_ms(torch, call, 20),
                plain_ms=cuda_ms(torch, plain, 2),
                **raycast_bound(got, probes)), float(nav_bad)


def single_trajectory(torch, sc):
    """The single-device frame step's poses over the slice (numpy) and its
    final block count, on the card."""
    import numpy as np
    state, poses = sc.init(), []
    for i in range(sc.n_total):
        state, _ = sc.frame(state, i)
        poses.append(state.pose.clone())
    return np.stack([p.cpu().numpy() for p in poses]), int(
        state.map.n_blocks)


def dist_phase(torch, dev, tmp, card):
    """The sharded step (``parallel/dist_step.py``) as four Gloo ranks on
    card 0 through ``tools/dist_run.py``, both fields at the bench config
    (:data:`ORBIT`; per-rank capacity 36,864 / 4, halo budget
    DIST_HALO_BUDGET), exact and frustum halo, over the 43 slice frames,
    each rank's launch counts zeroed before each case and read after it.
    Holds: every exact-halo pose within 2e-3 of the single-device frame
    step on this card, the frustum run's final pose within 5e-3 of the
    exact one's, every drop counter 0, every rank owning blocks, each
    rank's collectives (1 + sum(ITERATIONS) + 3 a frame, one more for the
    halo on frames > 2, and the all-gathers' bytes), and the kernels the
    path runs against their twins on rank 1's captured calls at frame
    DIST_CAPTURE: the sharded modes (K6's windowed icp_reduce at every
    level, icp_reduce_step and icp_update, K5's windowed marches and owned
    allocation, halo_pack, K2 on the halo table, K1's column window) and
    K3 and K4 at the rank's capacity; and each rank's launches: one
    icp_reduce, sum(ITERATIONS) - 1 icp_reduce_step, one icp_update and
    one alloc_assign_owned a frame, one halo_pack a frame from frame 3.
    Prints ms/frame per rank, the halo's bytes and
    the collectives' share, which measure no scaling (four ranks share one
    card, their collectives staged through host memory). Returns the
    kernels' launches over both paths, the new modes' rows and the errors
    of the other kernels' checks."""
    import numpy as np
    from supereight_tpu_torch.fields import OFUSION, TSDF
    from supereight_tpu_torch.kernels import halo
    from supereight_tpu_torch.tools import dist_run
    t0 = time.perf_counter()
    cases = [dict(name=f"{f}-{h}", field=f, frustum_halo=h == "frustum",
                  halo_budget=DIST_HALO_BUDGET,
                  **({"capture": DIST_CAPTURE} if h == "exact" else {}))
             for f in ("tsdf", "ofusion") for h in ("exact", "frustum")]
    out = os.path.join(tmp, "dist")
    res = dist_run.launch(DIST_WORLD, "gloo", "cuda", out, ORBIT, cases)
    t_ranks = time.perf_counter() - t0
    launches, rows, errs = collections.Counter(), {}, {}
    n = ORBIT["frames"]
    send = halo.halo_rows(DIST_HALO_BUDGET) * 512 * 4
    ref = H * (W // DIST_WORLD) * 7 * 4  # a rank's vertex, normal, valid
    want_calls = {"all_gather": n + n - 3,
                  "all_reduce": n * (3 + sum(ITERATIONS))}
    want_gather = n * ref + (n - 3) * send
    for field in (TSDF, OFUSION):
        sc = Scene(torch, field, dev)
        single, n_single = single_trajectory(torch, sc)
        path = collections.Counter()
        tag = f"dist {field.name}"
        for h in ("exact", "frustum"):
            name = f"{field.name}-{h}"
            for r, rr in enumerate(res):
                counts = json.loads(str(rr[name + ".launches"]))
                path.update(counts)
                k6 = {k: counts[k] for k in DIST_K6}
                require(k6 == {"icp_reduce": n, "icp_reduce_step":
                               n * (sum(ITERATIONS) - 1), "icp_update": n},
                        f"{tag} rank {r} {h}: K6 launches {k6} over {n} "
                        f"frames; want one icp_reduce, "
                        f"{sum(ITERATIONS) - 1} icp_reduce_step and one "
                        f"icp_update a frame")
                # one owned allocation a frame, one halo from frame 3
                own = {k: counts[k] for k in ("alloc_assign_owned",
                                              "halo_pack")}
                require(own == {"alloc_assign_owned": n, "halo_pack": n - 3},
                        f"{tag} rank {r} {h}: launches {own} over {n} "
                        f"frames; want one alloc_assign_owned a frame and "
                        f"one halo_pack a frame from frame 3")
                for c in DIST_DROPS:
                    require(not rr[f"{name}.aux.{c}"].any(),
                            f"{tag} rank {r} {h}: {c} nonzero")
                calls = json.loads(str(rr[name + ".comm_calls"]))
                sent = json.loads(str(rr[name + ".comm_bytes"]))
                require(calls == want_calls
                        and sent["all_gather"] == want_gather,
                        f"{tag} rank {r} {h}: collectives {calls}, "
                        f"all_gather bytes {sent['all_gather']}; want "
                        f"{want_calls}, {want_gather}")
                ms = rr[name + ".ms"][N_WARMUP + 1:]
                share = rr[name + ".comm_s"][N_WARMUP + 1:].sum() / (
                    ms.sum() / 1e3)
                print(f"{tag} {h} rank {r}: {ms.mean():.2f} ms/frame over "
                      f"frames 4-42 (CUDA events; {card}); {share:.3f} of it "
                      f"blocked in collectives (host clock); collectives "
                      f"{calls} over {n} frames, bytes a frame "
                      f"{ {k: v / n for k, v in sent.items()} }; four ranks "
                      f"share one card under Gloo: no scaling is measured")
            blocks = res[0][name + ".aux.n_blocks_dev"][-1]
            halo_blocks = res[0][name + ".aux.halo_blocks"]
            print(f"{tag} {h}: blocks per rank {blocks.tolist()}, "
                  f"{int(blocks.sum())} in all (single device {n_single}; "
                  f"TSDF 7,335 / OFusion 3,197 in earlier runs); halo "
                  f"blocks sent, frame 3 / {len(halo_blocks) - 1}: "
                  f"{int(halo_blocks[3])} / {int(halo_blocks[-1])} "
                  f"(halo_budget "
                  f"{DIST_HALO_BUDGET} a rank); halo bytes a frame: "
                  f"{send / 1e6:.2f} MB sent and {DIST_WORLD * send / 1e6:.2f}"
                  f" MB gathered a rank")
            require((blocks > 0).all(), f"{tag} {h}: a rank owns no block")
        for r, rr in enumerate(res):
            err = np.abs(rr[f"{field.name}-exact.poses"] - single).max(
                axis=(1, 2))
            fr = np.abs(rr[f"{field.name}-frustum.poses"][-1]
                        - rr[f"{field.name}-exact.poses"][-1]).max()
            print(f"{tag} rank {r}: exact-halo pose against the single "
                  f"device, largest over the frames {err.max():.2e} (frame "
                  f"{int(err.argmax())}; <= {DIST_POSE_TOL}); frustum "
                  f"final pose against exact {fr:.2e} (<= "
                  f"{DIST_FRUSTUM_TOL})")
            require(err.max() <= DIST_POSE_TOL,
                    f"{tag} rank {r}: exact halo left the single device")
            require(fr <= DIST_FRUSTUM_TOL,
                    f"{tag} rank {r}: frustum halo left the exact halo")
        for k in PATHS["dist-" + field.name]:
            require(path[k] > 0, f"{tag}: {k} was not launched")
        print(f"{tag} launches (4 ranks, both halos): "
              f"{ {k: path[k] for k in PATHS['dist-' + field.name]} }")
        launches.update(path)

        cap = torch.load(os.path.join(out, f"capture_{field.name}-exact.pt"),
                         map_location=dev, weights_only=False)
        ctag = f"{tag} modes (rank {cap['rank']}, frame {cap['frame']})"
        new = check_dist_icp(torch, cap, ctag)
        march_row, assign_row = check_dist_alloc(torch, cap, field, ctag)
        ray_row, nav_err = check_dist_raycast(torch, cap, ctag)
        new.update({"alloc_touch_cols" if field is TSDF
               else "alloc_touch_of_cols": march_row,
               "alloc_assign_owned": assign_row,
               "halo_pack": check_dist_halo(torch, cap, field, ctag),
               "raycast_cols" if field is TSDF else "raycast_cols_of":
                   ray_row})
        for name, row in new.items():
            rows.setdefault(name, []).append(row)
        local = check_dist_local(torch, cap, ctag)
        local.update(nav_grid=nav_err)
        for name, e in local.items():
            errs.setdefault(name, []).append(e)
    print(f"dist phase: {time.perf_counter() - t0:.1f} s ({t_ranks:.1f} s "
          f"of it the four ranks, start-up included)")
    return launches, rows, errs


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
    rows["ba_solve"] = ba_phase(torch, dev, card)
    check_mm2meters(torch, dev)
    torch.cuda.synchronize()

    # ---- the main paths, each with the counts zeroed just before -------
    launches = {k: 0 for k in KERNELS}
    slices, graphs = {}, {}
    for sc in (tsdf, of, noise):
        path_launches, slice_errs, slices[sc.name] = slice_phase(torch, sc,
                                                                 card)
        for k, e in slice_errs.items():
            errs.setdefault(k, [rows[k]["max_abs_err"]]).append(e)
        for k, v in path_launches.items():
            launches[k] += v
        # the same frames through the frame program (one CUDA graph)
        path_launches, graphs[sc.name] = graph_phase(torch, sc, card,
                                                     slices[sc.name])
        for k, v in path_launches.items():
            launches[k] += v
    for k, v in bench_phase(slices, graphs, card).items():
        launches[k] += v
    launches.update(probe_path(torch, dev))
    for k, v in library_phase(torch, dev, tmp, card).items():
        launches[k] += v
    torch.cuda.empty_cache()
    wait_loop_raw(raw_proc, t_raw)
    pipe_launches, closure_err, ba_err, render_rows = pipeline_phase(
        torch, raw, tmp, card)
    rows.update(render_rows)
    for k, v in pipe_launches.items():
        launches[k] += v
    noise_launches, tracked = tracked_noise_phase(torch, tmp, card)
    for k, v in noise_launches.items():
        launches[k] += v
    # the noise maps' gated raycast and median2 (device us, the probes,
    # the time against the probe bound) beside their kernel phase rows
    maps = {"slice": slices["tsdf-noise"]["noise_map"], "tracked": tracked}
    rows["raycast_gated"]["noise_maps"] = {
        k: {"device_us": v["gated_us"], "probes": v["probes"],
            "probe_bound_line": v["line"], "hits": v["hits"],
            "bit_equal": v["bit_equal"]} for k, v in maps.items()}
    rows["median2"]["noise_maps"] = {k: {"device_us": v["median2_us"]}
                                     for k, v in maps.items()}
    errs.setdefault("raycast_gated", [rows["raycast_gated"]["max_abs_err"]]) \
        .extend(v["max_abs_err"] for v in maps.values())
    errs.setdefault("icp_track", [rows["icp_track"]["max_abs_err"]]) \
        .append(closure_err)
    errs.setdefault("ba_solve", [rows["ba_solve"]["max_abs_err"]]) \
        .append(ba_err)
    # the sharded step last: its four ranks share the card and the host's
    # cores, which the loop's renderers no longer use
    dist_launches, dist_rows, dist_errs = dist_phase(torch, dev, tmp, card)
    for k, e in dist_errs.items():
        errs.setdefault(k, [rows[k]["max_abs_err"]]).extend(e)
    for k, v in dist_launches.items():
        if k in launches:
            launches[k] += v
    for name, (first, *more) in dist_rows.items():
        e = errs.setdefault(name, [])
        if name in rows:  # a check of the same kernel outside the path
            e.append(rows[name]["max_abs_err"])
        e.extend(row["max_abs_err"] for row in (first, *more))
        rows[name] = first
        for row in more:  # the OFusion path's row of a kernel both share
            first["ofusion"] = {k: row[k] for k in (
                "device_us", "ms", "plain_ms", "bound_ms", "bound_by")}
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
