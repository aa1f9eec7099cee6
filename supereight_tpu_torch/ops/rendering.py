"""Visualization renders (RGBA u8 images).

Port of ``supereight_tpu/ops/rendering.py`` (ref renderDepthKernel /
renderTrackKernel / renderVolumeKernel, se_denseslam/src/rendering.cpp:
111-283, and the gray-to-rainbow map gs2rgb, commons.h:105-164), with
JAX's public functions and signatures. Each render is one launch of K10
(``kernels/render.py``, ``csrc/render.cu``) on the card and its plain
twin on the CPU; the u8 images equal JAX's.
A volume render from a view that is not the raycast pose marches the map
afresh through K1's unprimed launch (``ops/raycast``), to twice the far
plane; its view is the pose prologue's (``kernels/frame.frame_mats``).
"""

from supereight_tpu_torch import constants as C
from supereight_tpu_torch.kernels import render as krender
from supereight_tpu_torch.kernels.frame import frame_mats
# gs2rgb stays importable here, where JAX's module has it
from supereight_tpu_torch.kernels.render import gs2rgb  # noqa: F401
from supereight_tpu_torch.ops import raycast as raycast_mod


def render_depth(depth, near=C.NEAR_PLANE, far=C.FAR_PLANE):
    """Depth image -> RGBA (ref renderDepthKernel, rendering.cpp:111-152):
    white below near, black above far, rainbow in between."""
    return krender.render_depth(depth, near, far)


def render_track(result):
    """Tracking-status colours (ref renderTrackKernel,
    rendering.cpp:154-212, legend at DenseSLAMSystem.h:249-258)."""
    return krender.render_track(result)


def render_volume(geom, state, field, view_pose, k, mu, frame_size,
                  light=None, vertex=None, normal=None, valid=None,
                  reuse_maps=False):
    """Diffuse-shaded surface render (ref renderVolumeKernel,
    rendering.cpp:214-283). When the view pose is the raycast pose the
    reference reuses the tracking maps: pass ``reuse_maps=True`` with
    them; otherwise the map is raycast afresh from ``view_pose`` (K1's
    unprimed launch over every block, to twice the far plane). The light
    is ``view_pose[:3, 3]`` unless ``light`` is given."""
    if not reuse_maps:
        view = frame_mats(k, view_pose).kpose
        vertex, normal, valid = raycast_mod.raycast(
            geom, state, field, view, mu, frame_size,
            far=C.FAR_PLANE * 2.0)
    return krender.render_volume(vertex, normal, valid, view_pose, light)
