"""Pipeline helpers shared by the fused frame step.

Port of ``supereight_tpu/pipeline.py:_preprocess_and_pyramid`` (the
``filter_input=False`` path) on kernel K7 (``kernels/preprocess.py``). The
``DenseSLAMSystem`` class, the CLI and rendering are not ported yet.
"""

from supereight_tpu_torch.kernels import preprocess


def preprocess_and_pyramid(depth_m, k, levels: int, neg_y: bool,
                           filter_input):
    """Build the depth/vertex/normal pyramid (ref DenseSLAMSystem::
    preprocessing + tracking's pyramid prep, DenseSLAMSystem.cpp:128-164).

    Returns (depths, verts, norms, valids), tuples finest first.
    """
    if filter_input:
        raise NotImplementedError(
            "input filters (bilateral, median) are not ported yet")
    return preprocess.pyramid(depth_m, k, levels, neg_y)
