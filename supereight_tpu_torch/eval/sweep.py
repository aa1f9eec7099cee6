"""Parameter/dataset sweeps (a copy of
``supereight_tpu/eval/sweep.py`` that runs the port's CLI).

Behavioral reference: se_apps/scripts/run_kf.py + _run.py — run the
pipeline binary over a set of sequences/configs, collect the per-stage
log, and score ATE against ground truth.

Usage:
  python -m supereight_tpu_torch.eval.sweep --root /data --datasets icl-traj2
  python -m supereight_tpu_torch.eval.sweep --synthetic 32   # no data needed
"""

import argparse
import json
import subprocess
import sys
import tempfile

import numpy as np

from supereight_tpu_torch.eval.datasets import DATASETS


def parse_frame_log(path):
    """Parse the tab-separated per-stage log (schema of
    benchmark.cpp:110-173, reproduced by supereight_tpu_torch.cli)."""
    rows = []
    with open(path) as f:
        header = f.readline().strip().split("\t")
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = line.strip().split("\t")
            rows.append({k: float(v) for k, v in zip(header, vals)})
    return rows


def summarize(rows):
    out = {}
    for key in ("preprocessing", "tracking", "integration", "raycasting",
                "computation", "total"):
        vals = [r[key] for r in rows if key in r]
        if vals:
            out[key + "_mean"] = float(np.mean(vals))
    if rows:
        out["tracked_fraction"] = float(np.mean([r.get("tracked", 0)
                                                 for r in rows]))
        out["fps"] = (1.0 / out["computation_mean"]
                      if out.get("computation_mean") else 0.0)
    return out


def run_one(cli_args, log_file):
    cmd = [sys.executable, "-m", "supereight_tpu_torch.cli", "-o",
           log_file] + cli_args
    proc = subprocess.run(cmd, capture_output=True, text=True)
    ate = None
    for line in proc.stderr.splitlines():
        if "ATE RMSE" in line:
            ate = float(line.split("ATE RMSE")[1].split()[0])
    return proc.returncode, ate, proc.stderr


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".")
    p.add_argument("--datasets", nargs="*", default=[])
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--field", default="tsdf")
    args = p.parse_args(argv)

    results = {}
    runs = []
    if args.synthetic:
        runs.append(("synthetic", ["--synthetic", str(args.synthetic),
                                   "-v", "256", "-s", "4.8", "-r", "1",
                                   "-f", args.field]))
    for name in args.datasets:
        ds = DATASETS[name]
        raw, gt = ds.resolve(args.root)
        a = ["-i", raw, "-g", gt, "-s", str(ds.volume_size),
             "-v", str(ds.volume_resolution),
             "-k", ",".join(str(v) for v in ds.camera),
             "-p", ",".join(str(v) for v in ds.init_pose_factor),
             "-f", args.field]
        if args.max_frames:
            a += ["--max-frames", str(args.max_frames)]
        runs.append((name, a))

    for name, cli_args in runs:
        with tempfile.NamedTemporaryFile(suffix=".log",
                                         delete=False) as tf:
            log_file = tf.name
        code, ate, err = run_one(cli_args, log_file)
        summary = summarize(parse_frame_log(log_file)) if code == 0 else {}
        summary["ate_rmse"] = ate
        summary["returncode"] = code
        results[name] = summary
        print(f"{name}: {json.dumps(summary)}", flush=True)
        if code != 0:
            print(err[-2000:], file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
