"""Pipeline helpers shared by the fused frame step.

Port of ``supereight_tpu/pipeline.py:_preprocess_and_pyramid`` on kernel
K7 (``kernels/preprocess.py``: the input filters, then the pyramid). The
``DenseSLAMSystem`` class, the CLI and rendering are not ported yet.
"""

from supereight_tpu_torch.kernels import preprocess


def preprocess_and_pyramid(depth_m, k, levels: int, neg_y: bool,
                           filter_input):
    """Filter, then build the depth/vertex/normal pyramid (ref
    DenseSLAMSystem::preprocessing + tracking's pyramid prep,
    DenseSLAMSystem.cpp:128-164).

    ``filter_input`` dispatches as JAX's (pipeline.py:36-45): "median" is
    one 3x3 median pass, "median2" two, any other true value (True,
    "bilateral") the reference's 5x5 bilateral filter, and a false value
    no filter. Returns (depths, verts, norms, valids), tuples finest
    first; depths[0] is the filtered depth.
    """
    if filter_input == "median":
        d0 = preprocess.median_filter3(depth_m)
    elif filter_input == "median2":
        d0 = preprocess.median_filter3(depth_m, passes=2)
    elif filter_input:
        d0 = preprocess.bilateral_filter(depth_m)
    else:
        d0 = depth_m
    return preprocess.pyramid(d0, k, levels, neg_y)
