"""The traj2-class long-sequence evaluation of the port: the closed loop
end to end from a ``.raw`` file to ATE.

    python -m supereight_tpu_torch.tools.longseq [--frames 250] \\
        [--noise 0.002] [--workdir DIR] [--out TABLE.md]

Renders the multi-object closed-loop sequence (640x480, with its TUM
ground truth) with the port's ``io/convert.synthetic2raw``, runs each
variant through the port's CLI (``python -m supereight_tpu_torch.cli``,
one process each) at the reference's traj2 configuration (``-c 2``, 4.8
m, 512^3 voxels, ICP mode) with the arguments and variants of the JAX
package's ``tools/run_longseq_eval.py``, and prints the same markdown
table (ATE RMSE, tracked fraction, wall and computation fps, drop
counters). The rows that need the pose graph (``--keyframe-rate``) are
left out until it is ported. ``--noise`` adds the noisy-depth variants on
a second sequence with Kinect-model range noise of that factor. Each
sequence renders in one process a CPU core; the CLI runs on the card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

from supereight_tpu_torch.eval.sweep import parse_frame_log, summarize
from supereight_tpu_torch.io.convert import synthetic2raw

BASE_ARGS = ("-s", "4.8", "-p", "0.5,0.4583,0.18", "-z", "4", "-c", "2",
             "-r", "1", "-t", "1", "-v", "512", "-k", "481.2,480,320,240",
             "-y", "10,5,4", "--no-stage-sync", "--preset-budget", "36864")
VARIANTS = (
    ("tsdf icp", ("-f", "tsdf", "-m", "0.1")),
    ("ofusion icp", ("-f", "ofusion", "-m", "0.008", "-z", "0")),
)


def noise_variants(noise):
    """The noisy-depth rows of run_longseq_eval.py without its BA row."""
    return (
        (f"tsdf icp noise={noise}", ("-f", "tsdf", "-m", "0.1")),
        # the noise-grade stack: iterated median input filter fused into
        # the map, map-maturity ICP gate, sigma(z)-weighted fusion, pool
        # sized for the noise-inflated surface band
        (f"tsdf icp noise={noise}+levers",
         ("-f", "tsdf", "-m", "0.1", "--filter", "median2",
          "--fuse-filtered", "--min-ref-weight", "4", "--noise-weighted",
          "--block-capacity", "49152", "--preset-budget", "49152")),
        (f"tsdf icp noise={noise} partial-levers (BA baseline)",
         ("-f", "tsdf", "-m", "0.1", "--filter", "median",
          "--fuse-filtered", "-z", "0")),
    )


def run_one(raw, extra, log_file, max_frames):
    """One CLI run; returns rc, ATE, wall fps, computation fps, tracked
    fraction, drop counters and the end of stderr."""
    cmd = [sys.executable, "-m", "supereight_tpu_torch.cli",
           "-i", raw, "-g", raw + ".gt.txt", "-o", log_file, *BASE_ARGS,
           "--max-frames", str(max_frames), *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    ate = fps = None
    drops = ""
    for line in proc.stderr.splitlines():
        if "ATE RMSE" in line:
            ate = float(line.split("ATE RMSE")[1].split()[0])
        if line.startswith("# frames=") and "fps=" in line:
            fps = float(line.split("fps=")[1])
        if "drop counters" in line:
            drops = line.split(":", 1)[1].strip()
    tracked = comp_fps = None
    if proc.returncode == 0:
        s = summarize(parse_frame_log(log_file))
        tracked, comp_fps = s.get("tracked_fraction"), s.get("fps")
    return {"rc": proc.returncode, "ate": ate, "fps": fps,
            "comp_fps": comp_fps, "tracked": tracked, "drops": drops,
            "stderr": proc.stderr[-2000:]}


def table(rows):
    lines = ["| variant | ATE RMSE (m) | tracked frac | wall fps | "
             "computation fps | drop counters |",
             "|---|---|---|---|---|---|"]
    for name, r in rows:
        ate = f"{r['ate']:.4f}" if r["ate"] is not None else "FAIL"
        tr = f"{r['tracked']:.2f}" if r["tracked"] is not None else "-"
        fps = f"{r['fps']:.1f}" if r["fps"] else "-"
        cfps = f"{r['comp_fps']:.1f}" if r["comp_fps"] else "-"
        lines.append(f"| {name} | {ate} | {tr} | {fps} | {cfps} | "
                     f"{r['drops'] or '-'} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="supereight-tpu-torch-longseq")
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="also the noisy-depth variants at this factor")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--out", default="", help="write the table here too")
    args = ap.parse_args(argv)

    wd = args.workdir or tempfile.mkdtemp(prefix="longseq_")
    os.makedirs(wd, exist_ok=True)
    runs = [("loop.raw", 0.0, VARIANTS)]
    if args.noise > 0:
        runs.append(("loop_noisy.raw", args.noise,
                     noise_variants(args.noise)))
    rows = []
    for fname, noise, variants in runs:
        raw = os.path.join(wd, fname)
        if not os.path.exists(raw):
            print(f"rendering the {args.frames}-frame loop "
                  f"(noise {noise}) ...", file=sys.stderr)
            synthetic2raw(raw, args.frames, scene="loop", noise_factor=noise,
                          workers=os.cpu_count() or 1)
        for name, extra in variants:
            log = os.path.join(wd, name.replace(" ", "_").replace("+", "_")
                               .replace("(", "").replace(")", "") + ".log")
            r = run_one(raw, extra, log, args.frames)
            summary = {k: v for k, v in r.items() if k != "stderr"}
            print(f"{name}: {json.dumps(summary)}", file=sys.stderr)
            if r["rc"] != 0:
                print(r["stderr"], file=sys.stderr)
            rows.append((name, r))
    out = table(rows)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0 if all(r["rc"] == 0 for _, r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
