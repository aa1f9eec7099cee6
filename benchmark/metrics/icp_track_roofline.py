"""K6 ``icp_track``'s share (%) of its roofline in the traced frames: the
least time the card could take for the work those frames' own inputs
needed, over the kernel's measured device time.

The work (``chip_smoke.icp_bound``'s counts, frozen here): each level's
vertices, normals and valid flags and the reference maps read once
(25 bytes a pixel), the finest result map written once (4 bytes a
pixel), the poses, sums and counts; 143 f32 operations a pixel and
iteration (two transforms, the projection, the residual, the normal
test, the Jacobian and the 28 products and 32 sums of the reduction),
347 a Gauss-Newton solve. The iterations a level are the reference's,
run on each traced frame's own inputs (``run.icp_work``). The peaks are
the H100 SXM's published 3.35 TB/s and 67 TFLOP/s in f32 at 700 W; the
bound is whichever of the two times is larger, and the reader says on
stderr which one it is."""

import sys

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PIXEL_OPS = 143
SOLVE_OPS = 347
PIXEL_BYTES = 25


def bound_s(runs, pixels, ref_pixels):
    """(seconds, "bytes" or "operations") of one frame's bound."""
    n_bytes = ((sum(pixels) + ref_pixels) * PIXEL_BYTES + pixels[0] * 4
               + 4 * 64 + 32 * 4 + 1 + 4 * len(pixels))
    n_ops = (sum(r * p for r, p in zip(runs, pixels)) * PIXEL_OPS
             + sum(runs) * SOLVE_OPS)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def read(ctx):
    icp = ctx["icp"]
    us = ctx["timeline"].kernel_us(("icp_track",))
    if icp is None or us is None:
        return None
    bounds = [bound_s(r, icp["pixels"], icp["ref_pixels"])
              for r in icp["runs"]]
    kinds = sorted({kind for _, kind in bounds})
    print(f"# icp_track_roofline: bound by {' and '.join(kinds)}",
          file=sys.stderr)
    return 100.0 * sum(t for t, _ in bounds) / (us / 1e6)
