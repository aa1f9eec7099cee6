"""Visualization renders (RGBA u8 images).

Port of ``supereight_tpu/ops/rendering.py`` (ref renderDepthKernel /
renderTrackKernel / renderVolumeKernel, se_denseslam/src/rendering.cpp:
111-283, and the gray-to-rainbow map gs2rgb, commons.h:105-164), with
JAX's public functions and signatures. Each render is one launch of K10
(``kernels/render.py``, ``csrc/render.cu``) on the card and its plain
twin on the CPU; the u8 images equal JAX's. :func:`render_views` is a
rendered frame's three renders in one launch, placed in the viewer's 2x2
composite (JAX's ``viewer.composite_views`` of its three renders).
A volume render from a view that is not the raycast pose marches the map
afresh through K1's unprimed launch (``ops/raycast``), to twice the far
plane; its view is the pose prologue's (``kernels/frame.frame_mats``).

JAX's ``render_volume`` is one jit for each set of its static arguments;
without ``reuse_maps`` it traces the whole fresh view. :class:`FreshView`
is its counterpart: the pose prologue, K2's nav grid, K1's unprimed
launch and K10's ``render_views`` as one CUDA graph for each set
(``graphs.Graphs``), reading the map and the images at fixed addresses.
"""

import torch

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
        vertex, normal, valid = _fresh_maps(geom, state, field, view_pose, k,
                                            mu, frame_size)
    return krender.render_volume(vertex, normal, valid, view_pose, light)


def render_views(depth, result, geom, state, field, view_pose, k, mu,
                 frame_size, light=None, vertex=None, normal=None,
                 valid=None, reuse_maps=False):
    """:func:`render_depth` of ``depth``, :func:`render_track` of
    ``result`` and :func:`render_volume` (its arguments) in one u8[2H, 2W,
    4] composite: depth top right, track bottom left, volume bottom right,
    zeros top left. One launch after the fresh view's march, if any; the
    march's maps are new tensors, never ``vertex``, ``normal`` or
    ``valid``."""
    if not reuse_maps:
        vertex, normal, valid = _fresh_maps(geom, state, field, view_pose, k,
                                            mu, frame_size)
    return krender.render_views(depth, result, vertex, normal, valid,
                                view_pose, light)


def _fresh_maps(geom, state, field, view_pose, k, mu, frame_size):
    """The map raycast afresh from ``view_pose``, to twice the far
    plane."""
    view = frame_mats(k, view_pose).kpose
    return raycast_mod.raycast(geom, state, field, view, mu, frame_size,
                               far=C.FAR_PLANE * 2.0)


class FreshView:
    """:func:`render_views` with a fresh view (JAX's ``render_volume``
    with ``reuse_maps=False``, ``supereight_tpu/ops/rendering.py:77``, and
    the composite around it) as one graph of ``graphs`` (a
    ``graphs.Graphs``, its owner's: one pool, one side stream) for each
    set of JAX's static arguments: ``geom``, ``field``, ``frame_size``,
    and ``mu`` (K1 takes it as a launch argument) and the light's source
    (given, or the view pose's translation).

    The graph reads ``state`` (the map), ``depth`` and ``result`` (the
    composite's other two images) at the addresses they have here, so each
    replay renders the map as it is then; the view pose, ``k`` and a given
    light are copied into the buffers :attr:`view_pose`, :attr:`k` and
    :attr:`light` first (a tensor that is the buffer is not copied). The
    graph holds no host read and no size taken from the map's values: the
    nav grid covers every block and the pool's capacity is ``geom``'s.
    A capture or replay that fails raises; nothing falls back to eager
    launches. On the CPU each call runs the same functions eagerly.
    """

    def __init__(self, graphs, state, depth, result, k=None):
        dev = graphs.device
        self.graphs, self.state = graphs, state
        self.depth, self.result = depth, result
        f32 = dict(dtype=torch.float32, device=dev)
        self.view_pose = torch.zeros((4, 4), **f32)
        self.k = torch.zeros((4,), **f32) if k is None else k
        self.light = torch.zeros((3,), **f32)

    def key(self, geom, field, mu, frame_size, light=None):
        """The graph's key: JAX's static arguments, mu and the light's
        source."""
        return ("fresh_view", geom, field.name, tuple(frame_size),
                float(mu), light is None)

    def __call__(self, geom, field, view_pose, k, mu, frame_size,
                 light=None):
        """The composite u8[2H, 2W, 4] of :func:`render_views` from the
        fresh view ``view_pose`` (f32[4, 4], host or device); its bottom
        right quadrant is :func:`render_volume`'s image. On the card the
        graph's own output, rewritten by the next call with the key."""
        for buf, t in ((self.view_pose, view_pose), (self.k, k),
                       (self.light, light)):
            if t is not None and t is not buf:
                buf.copy_(torch.as_tensor(t, dtype=torch.float32))
        given = None if light is None else self.light

        def program():
            return render_views(self.depth, self.result, geom, self.state,
                                field, self.view_pose, self.k, mu,
                                frame_size, light=given)
        return self.graphs(self.key(geom, field, mu, frame_size, light),
                           program)
