"""The gather-form probe on the card: forms A-D of
``tools/probe_pallas_gather.py`` through the K8 kernels.

    python -m supereight_tpu_torch.tools.probe_gather

Draws the probe's inputs (``kernels/gather_probe.probe_inputs``), runs
each form's kernel on the first CUDA device and prints one line per
form, ``<name>: OK match=True`` when the result equals the probe's numpy
expectation bit for bit (``match=False`` otherwise, or ``FAIL`` with the
error). Exits 1 unless every form matches, and 2 without a CUDA device.
"""

import sys

import numpy as np
import torch

from supereight_tpu_torch.kernels.gather_probe import FORMS, probe_inputs


def run(device):
    """[(name, ok, message)] of the four forms on ``device``."""
    results = []
    for (name, kernel, _, expect), (t, i) in zip(FORMS, probe_inputs()):
        try:
            out = kernel(torch.from_numpy(t).to(device),
                         torch.from_numpy(i).to(device))
            ok = bool(np.array_equal(out.cpu().numpy(), expect(t, i)))
            results.append((name, ok, f"OK match={ok}"))
        except Exception as e:  # reported per form, like the TPU probe
            msg = str(e).split("\n")[0][:160]
            results.append((name, False, f"FAIL {type(e).__name__}: {msg}"))
    return results


def main():
    if not torch.cuda.is_available():
        print("probe_gather: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"device: {device} {torch.cuda.get_device_name(device)}",
          flush=True)
    results = run(device)
    for form, _, msg in results:
        print(f"{form}: {msg}", flush=True)
    return 0 if all(ok for _, ok, _ in results) else 1


if __name__ == "__main__":
    sys.exit(main())
