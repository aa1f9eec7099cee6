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
   (K6 ICP, K5 allocation, K3 integration prepass and update, K2 nav
   grid, K1 raycast) and OFusion (K5-OF allocation, K2 nav grid, K3-OF
   update, K1-OF raycast);
4. probe phase: the four gather forms of the Pallas probe (K8) against
   their twins, bit for bit, and both timed;
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
   truth and that every kernel of the path was launched; then the probe's
   own path (``supereight_tpu_torch.tools.probe_gather.run``) likewise,
   each form bit for bit against the probe's numpy expectation;
6. prints one JSON line of per-kernel results, the card line again, and
   as its last line ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero without the ``ok`` line.
It imports no JAX.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

W, H = 320, 240
SIZE, DIM, CAPACITY = 512, 4.8, 36864
BUDGET = 8192       # integration worklist and raycast pool bucket (bench.py)
MU = {"tsdf": 0.1, "ofusion": 0.008}   # bench.py:50
K = (240.6, 240.0, 160.0, 120.0)
ITERATIONS = (10, 5, 4)
N_WARMUP, N_FRAMES, N_TIMED = 3, 20, 20
N_PROFILED = 5       # timed frames replayed under torch.profiler
# m, final position error against ground truth after the 43 frames, both
# fields: the accuracy bar of EVAL_table.md (TSDF loop ATE 0.0200 m). The
# JAX package reaches 0.0047 m at the TSDF config (BENCH_r05.json); its
# value at the OFusion config is not recorded (PERF.md, Findings PR 2).
MAX_POS_ERR = 0.02
COUNTERS = ("alloc_overflow", "blocks_truncated", "patch_skipped",
            "mip_skipped", "ray_overflow", "pool_bucket_overflow")

KERNELS = {  # name -> (source in the repo, TPU-side stage it replaces)
    "icp_reduce": ("supereight_tpu_torch/csrc/icp.cu",
                   "supereight_tpu/ops/tracking.py:56"),
    "alloc_touch": ("supereight_tpu_torch/csrc/alloc.cu",
                    "supereight_tpu/ops/allocation.py:75"),
    "alloc_touch_of": ("supereight_tpu_torch/csrc/alloc.cu",
                       "supereight_tpu/ops/allocation.py:148"),
    "integrate_prepass": ("supereight_tpu_torch/csrc/integrate.cu",
                          "supereight_tpu/ops/integration.py:123"),
    "integrate_update": ("supereight_tpu_torch/csrc/integrate.cu",
                         "supereight_tpu/ops/integration.py:286"),
    "integrate_update_of": ("supereight_tpu_torch/csrc/integrate.cu",
                            "supereight_tpu/fields/ofusion.py:58"),
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
}
# device kernel names (without "_kernel") reported from the profile; the
# OFusion instantiations are the <true> ones
PROFILED = {"icp_reduce", "alloc_touch", "alloc_touch_of",
            "integrate_prepass", "integrate_update", "nav_dist_x",
            "nav_dist_y", "nav_final", "raycast"}
PATHS = {  # the kernels each main path must launch
    "tsdf": ("icp_reduce", "alloc_touch", "integrate_prepass",
             "integrate_update", "nav_grid", "raycast"),
    "ofusion": ("icp_reduce", "alloc_touch_of", "integrate_prepass",
                "integrate_update_of", "nav_grid", "raycast_of"),
    "probe": ("gather_a", "gather_b", "gather_c", "gather_d"),
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


def report_profile(prof, ms_frame, tag):
    """Print the per-stage and per-kernel device time of the profiled
    frames, and the device's busy share of the unprofiled frame time."""
    from torch.autograd import DeviceType

    def dev_us(e, self_only):
        return e.self_device_time_total if self_only \
            else e.device_time_total

    events = prof.key_averages()
    stages = [e for e in events if e.key.startswith("frame_step/")
              and e.device_type == DeviceType.CPU]
    for e in sorted(stages, key=lambda e: e.key):
        print(f"{tag} profile: {e.key:22s} host "
              f"{e.cpu_time_total / 1e3 / N_PROFILED:8.3f} ms/frame, device "
              f"{dev_us(e, False) / 1e3 / N_PROFILED:8.3f} ms/frame")
    # device-side events: kernels and copies, plus the GPU-timeline copies
    # of the frame_step/* annotations, which are spans and not work
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("frame_step/")]
    busy = sum(dev_us(e, True) for e in kernels) / 1e3 / N_PROFILED
    n_launch = sum(e.count for e in kernels) / N_PROFILED
    print(f"{tag} profile: device busy {busy:.3f} ms/frame in "
          f"{n_launch:.0f} kernels and copies a frame; busy share of the "
          f"timed {ms_frame:.3f} ms/frame: {busy / ms_frame:.4f}")
    for e in kernels:
        name = re.search(r"(\w+)_kernel(<\w+>)?\(", e.key)
        if name and name.group(1) in PROFILED:
            label = name.group(1) + "_kernel" + (name.group(2) or "")
            print(f"{tag} profile: port kernel {label:32s} "
                  f"{dev_us(e, True) / max(e.count, 1):9.2f} us/launch, "
                  f"{e.count / N_PROFILED:5.1f} launches/frame")


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
    """The bench scene and a frame runner for one field on the card."""

    def __init__(self, torch, field, dev):
        import numpy as np
        from supereight_tpu_torch.core.map import MapGeometry
        from supereight_tpu_torch.io import synthetic
        from supereight_tpu_torch.parallel import step as pstep
        self.torch, self.np, self.pstep = torch, np, pstep
        self.field, self.mu, self.dev = field, MU[field.name], dev
        self.geom = MapGeometry(size=SIZE, dim=DIM, capacity=CAPACITY)
        self.n_total = N_WARMUP + N_FRAMES + N_TIMED
        self.depths, self.poses = synthetic.orbit_sequence(
            self.n_total, K, width=W, height=H, radius=0.3 * DIM,
            center=(DIM / 2,) * 3, sphere_radius=0.15 * DIM, angle_span=0.5,
            room=((0.55, 0.55, 0.55), (DIM - 0.55,) * 3))
        self.kt = torch.tensor(K, dtype=torch.float32).to(dev)
        self.depths_t = [torch.from_numpy(d).to(dev) for d in self.depths]
        self.kw = dict(frame_size=(W, H), iterations=ITERATIONS, mu=self.mu,
                       icp_threshold=1e-5, neg_y=False, filter_input=False,
                       use_gt_pose=False, integration_rate=1,
                       tracking_rate=1,
                       budget=pstep.integration_budget(self.geom, BUDGET))

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
    from supereight_tpu_torch.kernels import nav
    got = nav.nav_grid(sc.geom, m, sc.field, bucket=BUDGET)
    ref = nav.nav_grid_plain(sc.geom, m, sc.field, bucket=BUDGET)
    mism = int((got != ref).sum())
    row = dict(
        max_abs_err=float(mism),
        ms=cuda_ms(torch, lambda: nav.nav_grid(sc.geom, m, sc.field,
                                               bucket=BUDGET), 50),
        plain_ms=cuda_ms(torch, lambda: nav.nav_grid_plain(
            sc.geom, m, sc.field, bucket=BUDGET), 10))
    print(f"{tag}: {int((ref >= 0).sum())} block cells, "
          f"{int(((-ref - 1) >= 8).sum())} known-free coarse cells, "
          f"{mism} mismatches (== 0); call {row['ms']:.4f} ms, twin "
          f"{row['plain_ms']:.4f} ms")
    require(mism == 0, f"{tag} disagrees with twin")
    return row


def kernel_phase_tsdf(torch, sc):
    """Each TSDF-path kernel against its twin on a map built by three port
    frames."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.kernels import alloc, icp, integrate, nav, \
        raycast
    from supereight_tpu_torch.ops import integration, raycast as ops_ray
    from supereight_tpu_torch.pipeline import preprocess_and_pyramid

    geom, field, mu, kt = sc.geom, sc.field, sc.mu, sc.kt
    state = sc.run_frames(3)
    m = state.map
    pose = state.pose
    d2, d3 = sc.depths_t[2], sc.depths_t[3]
    rows = {}

    # K2 + K1: the primed raycast of frame 2 (its output feeds K6 below)
    check_nav(torch, sc, m, "K2 nav_grid (TSDF)")
    view = se3.matmul4(pose, se3.inverse_camera_matrix(kt))
    prime = ops_ray.prime_from_depth(d2, kt)
    nv = nav.nav_grid(geom, m, field, bucket=BUDGET)
    got = raycast.raycast_rays(geom, m, field, nv, view, prime, mu, (W, H))
    ref = raycast.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                                prime, mu, (W, H))
    v_err = check_raycast(torch, "K1 raycast", got, ref)
    rows["raycast"] = dict(
        max_abs_err=v_err,
        ms=cuda_ms(torch, lambda: raycast.raycast_rays(
            geom, m, field, nv, view, prime, mu, (W, H)), 20),
        plain_ms=cuda_ms(torch, lambda: raycast.raycast_plain(
            geom, field, m.data_x, m.data_y, nv, view, prime, mu, (W, H)),
            2))
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
        plain_ms=cuda_ms(torch, lambda: icp.icp_reduce_plain(*args), 10))

    # K5: the band march of frame 3 at the frame-2 pose
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(kt))
    t_k = alloc.touched_mask(geom, d3, pose, kt, mu)
    t_p = alloc.touched_mask_plain(geom, d3, pose, kpose, mu)
    mism = int((t_k != t_p).sum())
    print(f"K5 alloc_touch: {int(t_k.sum())} touched blocks, {mism} "
          f"mismatches (== 0)")
    require(mism == 0, "K5 alloc_touch disagrees with twin")
    rows["alloc_touch"] = dict(
        max_abs_err=float(mism),
        ms=cuda_ms(torch, lambda: alloc.touched_mask(geom, d3, pose, kt, mu),
                   50),
        plain_ms=cuda_ms(torch, lambda: alloc.touched_mask_plain(
            geom, d3, pose, kpose, mu), 10))

    # K3: fuse frame 3 at the frame-2 pose into two copies of the map
    t_cw = se3.inverse(pose)
    kmat = se3.camera_matrix(kt)
    wl, _ = integration.build_active_worklist(geom, m, t_cw, kmat, (W, H),
                                              BUDGET)
    pre_k = integrate.integrate_prepass(geom, m, wl, d3, t_cw, kmat)
    pre_p = integrate.integrate_prepass_plain(geom, m, wl, d3, t_cw, kmat)
    pre_mism = sum(int((a != b).sum()) for a, b in zip(pre_k, pre_p))
    print(f"K3 integrate_prepass: {int((wl < CAPACITY).sum())} blocks, "
          f"{int((pre_k[0] > 0).sum())} on a coarser depth level, "
          f"{int(pre_k[2].sum())} uncovered, {pre_mism} mismatches (== 0)")
    require(pre_mism == 0, "K3 integrate_prepass disagrees with twin")
    mode, _ = integrate._fallback_mode(pre_k[0], pre_k[2], pre_k[1],
                                       wl.shape[0])
    ma, mb = clone_map(m), clone_map(m)
    integrate.integrate_update(geom, ma, field, wl, d3, t_cw, kmat, mu, mode)
    integrate.integrate_update_plain(geom, mb, field, wl, d3, t_cw, kmat, mu,
                                     mode)
    ex = (ma.data_x - mb.data_x).abs().max().item()
    ey = (ma.data_y - mb.data_y).abs().max().item()
    act = int((ma.active != mb.active).sum())
    print(f"K3 integrate_update: data_x max err {ex:.3e} (<= 1e-5), data_y "
          f"max err {ey:.3e} (== 0), active mismatches {act} (== 0)")
    require(ex <= 1e-5 and ey == 0 and act == 0,
            "K3 integrate_update disagrees with twin")
    rows["integrate_prepass"] = dict(
        max_abs_err=float(pre_mism),
        ms=cuda_ms(torch, lambda: integrate.integrate_prepass(
            geom, m, wl, d3, t_cw, kmat), 50),
        plain_ms=cuda_ms(torch, lambda: integrate.integrate_prepass_plain(
            geom, m, wl, d3, t_cw, kmat), 10))
    rows["integrate_update"] = dict(
        max_abs_err=ex,
        ms=cuda_ms(torch, lambda: integrate.integrate_update(
            geom, ma, field, wl, d3, t_cw, kmat, mu, mode), 50),
        plain_ms=cuda_ms(torch, lambda: integrate.integrate_update_plain(
            geom, mb, field, wl, d3, t_cw, kmat, mu, mode), 10))
    return rows


def kernel_phase_of(torch, sc):
    """Each OFusion-path kernel against its twin on a map built by three
    OFusion port frames."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.kernels import alloc, integrate, nav, raycast
    from supereight_tpu_torch.ops import integration, raycast as ops_ray

    geom, field, mu, kt = sc.geom, sc.field, sc.mu, sc.kt
    state = sc.run_frames(3)
    m = state.map
    pose = state.pose
    d2, d3 = sc.depths_t[2], sc.depths_t[3]
    rows = {}

    # K5-OF: the multi-scale march of frame 3 at the frame-2 pose
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(kt))
    t_k = alloc.touched_masks_of(geom, d3, pose, kt, mu)
    t_p = alloc.touched_masks_of_plain(geom, d3, pose, kpose, mu)
    mism = [int((a != b).sum()) for a, b in zip(t_k, t_p)]
    print(f"K5-OF alloc_touch_of: touched octants per level "
          f"{[int(t.sum()) for t in t_k]}, mismatches {mism} (== 0)")
    require(sum(mism) == 0, "K5-OF alloc_touch_of disagrees with twin")
    rows["alloc_touch_of"] = dict(
        max_abs_err=float(sum(mism)),
        ms=cuda_ms(torch, lambda: alloc.touched_masks_of(
            geom, d3, pose, kt, mu), 50),
        plain_ms=cuda_ms(torch, lambda: alloc.touched_masks_of_plain(
            geom, d3, pose, kpose, mu), 10))

    # K2 (OFusion payload) + K1-OF: the primed raycast of frame 2
    rows["nav_grid"] = check_nav(torch, sc, m, "K2 nav_grid (OFusion)")
    view = se3.matmul4(pose, se3.inverse_camera_matrix(kt))
    prime = ops_ray.prime_from_depth(d2, kt)
    nv = nav.nav_grid(geom, m, field, bucket=BUDGET)
    got = raycast.raycast_rays(geom, m, field, nv, view, prime, mu, (W, H))
    ref = raycast.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                                prime, mu, (W, H))
    v_err = check_raycast(torch, "K1-OF raycast_of", got, ref)
    rows["raycast_of"] = dict(
        max_abs_err=v_err,
        ms=cuda_ms(torch, lambda: raycast.raycast_rays(
            geom, m, field, nv, view, prime, mu, (W, H)), 20),
        plain_ms=cuda_ms(torch, lambda: raycast.raycast_plain(
            geom, field, m.data_x, m.data_y, nv, view, prime, mu, (W, H)),
            2))

    # K3-OF: fuse frame 3 at the frame-2 pose into two copies of the map,
    # stamped with frame 3's time
    t_cw = se3.inverse(pose)
    kmat = se3.camera_matrix(kt)
    ts = torch.full((), 3.0, dtype=torch.float32, device=sc.dev) * (1 / 30)
    wl, _ = integration.build_active_worklist(geom, m, t_cw, kmat, (W, H),
                                              BUDGET)
    lv, n_valid, need = integrate.integrate_prepass(geom, m, wl, d3, t_cw,
                                                    kmat)
    mode, _ = integrate._fallback_mode(lv, need, n_valid, wl.shape[0])
    ma, mb = clone_map(m), clone_map(m)
    integrate.integrate_update(geom, ma, field, wl, d3, t_cw, kmat, mu, mode,
                               ts)
    integrate.integrate_update_plain(geom, mb, field, wl, d3, t_cw, kmat, mu,
                                     mode, ts)
    dx = (ma.data_x - mb.data_x).abs()
    bad = int((dx > 1e-4 + 1e-5 * mb.data_x.abs()).sum())
    ex = dx.max().item()
    wrote_k = ma.data_y == ts
    wrote_p = mb.data_y == ts
    ey = int((ma.data_y != mb.data_y).sum())
    act = int((ma.active != mb.active).sum())
    print(f"K3-OF integrate_update_of: {int((wl < CAPACITY).sum())} blocks, "
          f"{int(wrote_p.sum())} voxels written, data_x max abs err "
          f"{ex:.3e}, {bad} beyond 1e-4 + 1e-5 |x| (== 0), write-gate "
          f"(data_y) mismatches {ey} (== 0), active mismatches {act} "
          f"(== 0)")
    require(bad == 0 and ey == 0 and act == 0
            and bool((wrote_k == wrote_p).all()),
            "K3-OF integrate_update_of disagrees with twin")
    rows["integrate_update_of"] = dict(
        max_abs_err=ex,
        ms=cuda_ms(torch, lambda: integrate.integrate_update(
            geom, ma, field, wl, d3, t_cw, kmat, mu, mode, ts), 50),
        plain_ms=cuda_ms(torch, lambda: integrate.integrate_update_plain(
            geom, mb, field, wl, d3, t_cw, kmat, mu, mode, ts), 10))
    return rows


def probe_phase(torch, dev):
    """K8: each gather form against its twin, bit for bit, and both timed
    (the probe path checks the kernels against the probe's numpy
    expectation)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from supereight_tpu_torch.kernels import gather_probe as gp
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
        rows[key] = dict(max_abs_err=err,
                         ms=cuda_ms(torch, lambda: kernel(tt, it), 200),
                         plain_ms=cuda_ms(torch, lambda: plain(tt, it), 200))
        # device time per launch (the call times above are the host's)
        us = []
        for fn in (kernel, plain):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn(tt, it)
                torch.cuda.synchronize()
            us.append(sum(e.self_device_time_total
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA) / 20)
        print(f"K8 {key}: call {rows[key]['ms']:.4f} ms, twin "
              f"{rows[key]['plain_ms']:.4f} ms; device {us[0]:.2f} "
              f"us/call, twin {us[1]:.2f} us/call")
    return rows


def slice_phase(torch, sc, card):
    """The main path of one field: 43 frames with the launch counts zeroed
    just before and read just after; returns the launch counts."""
    import numpy as np
    from supereight_tpu_torch.kernels import _lib

    tag = f"slice {sc.field.name}"
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
        if i == first_timed:
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
    # torch.profiler: per-stage and per-kernel device times
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(first_timed, first_timed + N_PROFILED):
            snapshot, _ = sc.frame(snapshot, i)
        torch.cuda.synchronize()
    report_profile(prof, ms_frame, tag)

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
    require(all(tracked[4:]), f"{tag}: a frame from frame 4 on did not track")
    require(pos_err < MAX_POS_ERR,
            f"{tag}: final position error {pos_err:.4f} m")
    path = PATHS[sc.field.name]
    require(all(launches[k] > 0 for k in path),
            f"{tag}: a kernel of the path was not launched: {launches}")
    return {k: launches[k] for k in path}


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


def main():
    import torch

    require(torch.cuda.is_available(), "no CUDA device")
    card = card_line()
    print(card)
    print(versions(torch))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from supereight_tpu_torch.fields import OFUSION, TSDF
    from supereight_tpu_torch.kernels import _lib

    t0 = time.perf_counter()
    _lib.library()
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
    tsdf, of = Scene(torch, TSDF, dev), Scene(torch, OFUSION, dev)
    rows = kernel_phase_tsdf(torch, tsdf)
    rows.update(kernel_phase_of(torch, of))
    rows.update(probe_phase(torch, dev))
    torch.cuda.synchronize()

    # ---- the main paths, each with the counts zeroed just before -------
    launches = {k: 0 for k in KERNELS}
    for sc in (tsdf, of):
        for k, v in slice_phase(torch, sc, card).items():
            launches[k] += v
    launches.update(probe_path(torch, dev))

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **rows[name])
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
