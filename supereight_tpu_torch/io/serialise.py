"""Map snapshots (checkpoint / resume).

Port of ``supereight_tpu/io/serialise.py`` (behavioral reference:
Octree::save/load, octree.hpp:897-950 + se_serialise.hpp). A snapshot is
the allocated part of the pool keyed by morton code, and topology (the
dense slot grid) is rebuilt from the block coordinates on load. The
``.npz`` keys, dtypes and :data:`FORMAT_VERSION` are JAX's, so a snapshot
written by one package loads in the other. The port's ``touched`` buffer
is not saved: it is all zero between frames and made zeroed on load.
"""

import numpy as np
import torch

from supereight_tpu_torch.core import morton
from supereight_tpu_torch.core.map import MapGeometry, MapState, \
    touched_buffer
from supereight_tpu_torch.fields import get_field

FORMAT_VERSION = 1


def morton_keys(block_coord):
    """u32 morton key of each [..., 3] block coordinate, host numpy in and
    out (JAX core/map.py:morton_keys; the codes of ``core/morton.py``)."""
    c = torch.from_numpy(np.asarray(block_coord))
    return morton.encode_v(c, "cpu").numpy().astype(np.uint32)


def _np(t):
    return t.detach().cpu().numpy()


def save_map(path, geom, state, field):
    """Write a .npz snapshot of the allocated part of the map."""
    n = int(state.n_blocks)
    bc = _np(state.block_coord)[:n]
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        size=geom.size,
        dim=geom.dim,
        capacity=geom.capacity,
        field=field.name,
        n_blocks=n,
        keys=morton_keys(bc),
        block_coord=bc,
        active=_np(state.active)[:n],
        data_x=_np(state.data_x)[:n],
        data_y=_np(state.data_y)[:n],
        mip_x=_np(state.mip_x[0]),
        mip_y=_np(state.mip_y[0]),
        **{f"mipx_{i}": _np(v) for i, v in enumerate(state.mip_x)},
        **{f"mipy_{i}": _np(v) for i, v in enumerate(state.mip_y)},
        **{f"mipa_{i}": _np(v) for i, v in enumerate(state.mip_alloc)},
    )


def load_map(path, device="cuda"):
    """Load a snapshot onto ``device`` (the card unless the caller asks
    for another); returns (geom, state, field)."""
    z = np.load(path, allow_pickle=False)
    geom = MapGeometry(size=int(z["size"]), dim=float(z["dim"]),
                       capacity=int(z["capacity"]))
    field = get_field(str(z["field"]))
    n = int(z["n_blocks"])
    cap, b = geom.capacity, geom.blocks_per_side

    bc = np.asarray(z["block_coord"])
    slot = np.full((b, b, b), -1, np.int32)
    slot[bc[:, 0], bc[:, 1], bc[:, 2]] = np.arange(n, dtype=np.int32)
    init_x, init_y = field.init
    data_x = np.full((cap, 512), init_x, np.float32)
    data_y = np.full((cap, 512), init_y, np.float32)
    data_x[:n] = z["data_x"]
    data_y[:n] = z["data_y"]
    active = np.zeros(cap, bool)
    active[:n] = z["active"]
    coords = np.zeros((cap, 3), np.int32)
    coords[:n] = bc

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    nl = geom.num_levels
    state = MapState(
        data_x=t(data_x), data_y=t(data_y), block_coord=t(coords),
        active=t(active), slot=t(slot),
        n_blocks=torch.tensor(n, dtype=torch.int32, device=device),
        mip_x=tuple(t(z[f"mipx_{i}"]) for i in range(nl)),
        mip_y=tuple(t(z[f"mipy_{i}"]) for i in range(nl)),
        mip_alloc=tuple(t(z[f"mipa_{i}"]) for i in range(nl)),
        touched=touched_buffer(b, device))
    return geom, state, field
