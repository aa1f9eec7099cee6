"""Pipeline helpers shared by the fused frame step.

Port of ``supereight_tpu/pipeline.py:_preprocess_and_pyramid`` (the
``filter_input=False`` path) on kernel K7 (``kernels/preprocess.py``). The
``DenseSLAMSystem`` class, the CLI and rendering are not ported yet.
"""

from supereight_tpu_torch import constants as C
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
    depths = [depth_m]
    for _ in range(1, levels):
        depths.append(preprocess.half_sample(depths[-1], C.E_DELTA * 3.0))
    verts, norms, valids = zip(*(preprocess.vertex_normal(d, k, i, neg_y)
                                 for i, d in enumerate(depths)))
    return tuple(depths), verts, norms, valids
