"""Read the numbers that decide ``correct`` on many seeds, for the program
and for the control, in one process: what each limit is set from.

    python3 -m benchmark.control --workload traj2-tsdf.live \\
        --seeds 11 12 13 ... --seconds 2

Each seed is one run of the cell (``run.run``) with a short window; its
sampled frames are judged twice, with the plain reference in float32 (the
program's readings) and in bfloat16 at every stage boundary (the
control's readings). Prints each seed's readings, then per number the
largest of the program's and the smallest of the control's; the
benchmark's own runs never run the control.
"""

import argparse
import json
import sys

import torch

from benchmark import run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    prog, ctrl = {}, {}
    for seed in args.seeds:
        r = run.run(args.workload, seed, args.seconds, 0, control=True)
        got = {k: c["value"] for k, c in r["checks"].items()}
        low = {k: c["value"] for k, c in r["control"].items()}
        print(json.dumps({"seed": seed, "program": got, "control": low,
                          "frames_per_s": r["metrics"]["frames_per_s"]
                          ["value"], "failed": r["failed"]}), flush=True)
        for k, v in got.items():
            prog.setdefault(k, []).append(v)
        for k, v in low.items():
            ctrl.setdefault(k, []).append(v)
        torch.cuda.empty_cache()
    for k in prog:
        print(f"{k}: program largest {max(prog[k])!r} over "
              f"{len(prog[k])} seeds; control smallest {min(ctrl[k])!r} "
              f"over {len(ctrl[k])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
