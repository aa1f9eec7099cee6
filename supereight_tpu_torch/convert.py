"""numpy <-> torch state conversion.

Turns a JAX ``MapState`` or ``FrameState`` given as numpy arrays (for
example ``jax.tree.map(np.asarray, state)``) into the port's tensors on a
device (the card unless the caller asks for another), and back to numpy.
The field names are the same in both packages, so any object with those
attributes works; this module imports no JAX. The port's map has one field
more, ``touched`` (the allocation march's scratch, ``core/map.py``): it is
made zeroed on the way in and left out on the way back.
"""

import collections

import numpy as np
import torch

from supereight_tpu_torch.core.map import MapState, touched_buffer
from supereight_tpu_torch.parallel.step import FrameState

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported state dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


# a map in the JAX layout: the port's MapState without ``touched``
NumpyMap = collections.namedtuple(
    "NumpyMap", [f for f in MapState._fields if f != "touched"])


def map_to_torch(m, device="cuda") -> MapState:
    """A JAX-layout map (numpy arrays) -> the port's MapState, with a
    zeroed touched buffer."""
    return MapState(
        data_x=_tensor(m.data_x, device), data_y=_tensor(m.data_y, device),
        block_coord=_tensor(m.block_coord, device),
        active=_tensor(m.active, device), slot=_tensor(m.slot, device),
        n_blocks=_tensor(m.n_blocks, device),
        mip_x=tuple(_tensor(a, device) for a in m.mip_x),
        mip_y=tuple(_tensor(a, device) for a in m.mip_y),
        mip_alloc=tuple(_tensor(a, device) for a in m.mip_alloc),
        touched=touched_buffer(np.shape(m.slot)[0], device))


def frame_to_torch(s, device="cuda") -> FrameState:
    """A JAX-layout FrameState (numpy arrays) -> the port's FrameState."""
    return FrameState(
        map=map_to_torch(s.map, device), pose=_tensor(s.pose, device),
        raycast_pose=_tensor(s.raycast_pose, device),
        vertex=_tensor(s.vertex, device), normal=_tensor(s.normal, device),
        valid=_tensor(s.valid, device))


def to_numpy(state):
    """A port MapState or FrameState -> the same NamedTuple of numpy
    arrays (tuples of mip levels stay tuples), a map as a
    :data:`NumpyMap`: the JAX fields, in JAX's order, without
    ``touched``."""
    def conv(v):
        if isinstance(v, MapState):
            return NumpyMap(*(conv(getattr(v, f)) for f in NumpyMap._fields))
        if isinstance(v, tuple) and not hasattr(v, "_fields"):
            return tuple(conv(x) for x in v)
        if hasattr(v, "_fields"):
            return type(v)(*(conv(x) for x in v))
        return v.detach().cpu().numpy()
    return conv(state)
