"""The OFusion loop's ATE against JAX's, frame by frame (not a test).

Runs JAX's CLI on the CPU over the 250-frame loop ``.raw`` with
``tools/run_longseq_eval.py``'s OFusion row (``-f ofusion -m 0.008 -z
0``), optionally with its raycast strip table held at f32 (a patch of
``ops/raycast.strips_dtype`` in this process; the package is not
edited), and compares frame logs: the first frame where two runs' X/Y/Z
part by more than each threshold, and their mean and largest distance.

    python -m supereight_tpu_torch.io.convert synthetic loop.raw \\
        --frames 250 --scene loop --workers 4
    python tests/ofusion_gap.py jax loop.raw jax.log [--f32-strips]
    python -m supereight_tpu_torch.cli -i loop.raw -g loop.raw.gt.txt \\
        <the same arguments> -o port.log      # on the card
    python tests/ofusion_gap.py compare port.log jax.log

A run takes ~14-20 min on 4 CPU cores.
"""

import argparse
import os
import sys

import numpy as np

# tools/run_longseq_eval.py:29-35 and its OFusion row (:88)
ARGS = ["-s", "4.8", "-p", "0.5,0.4583,0.18", "-z", "4", "-c", "2", "-r",
        "1", "-t", "1", "-v", "512", "-k", "481.2,480,320,240", "-y",
        "10,5,4", "--max-frames", "250", "--no-stage-sync",
        "--preset-budget", "36864", "-f", "ofusion", "-m", "0.008", "-z",
        "0"]
THRESHOLDS = (1e-5, 1e-4, 1e-3, 2e-3, 5e-3)


def run_jax(raw, log, f32_strips):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if f32_strips:
        import jax.numpy as jnp
        from supereight_tpu.ops import raycast
        raycast.strips_dtype = lambda n_bricks: jnp.float32
    from supereight_tpu import cli
    return cli.main(["-i", raw, "-g", raw + ".gt.txt", "-o", log,
                     "--platform", "cpu"] + ARGS)


def load(path):
    lines = [ln for ln in open(path).read().splitlines()
             if ln and not ln.startswith("#")]
    return np.array([[float(v) for v in r.split("\t")] for r in lines[1:]])


def compare(a_path, b_path):
    a, b = load(a_path), load(b_path)
    n = min(len(a), len(b))
    d = np.linalg.norm(a[:n, 9:12] - b[:n, 9:12], axis=1)
    print(f"{n} frames; tracked {int(a[:n, 12].sum())} / "
          f"{int(b[:n, 12].sum())}, differing on "
          f"{int((a[:n, 12] != b[:n, 12]).sum())}")
    for t in THRESHOLDS:
        idx = np.nonzero(d > t)[0]
        print(f"first frame parting by more than {t:g} m: "
              f"{int(idx[0]) if len(idx) else None}")
    print(f"distance: mean {d.mean():.6f} m, largest {d.max():.6f} m at "
          f"frame {int(d.argmax())}, last frame {d[n - 1]:.6f} m")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    j = sub.add_parser("jax")
    j.add_argument("raw")
    j.add_argument("log")
    j.add_argument("--f32-strips", action="store_true")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args(argv)
    if args.cmd == "jax":
        return run_jax(args.raw, args.log, args.f32_strips)
    compare(args.a, args.b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
