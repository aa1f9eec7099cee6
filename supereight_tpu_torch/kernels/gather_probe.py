"""K8 wrappers and twins: the four gather forms of the Pallas probe.

Counterparts of ``tools/probe_pallas_gather.py``'s ``formA`` (25),
``formB`` (37), ``formC`` (50) and ``formD`` (66), the repo's only
``pl.pallas_call`` sites. The CUDA kernels are ``csrc/gather_probe.cu``;
the ``*_plain`` functions (torch indexing and ``torch.gather``) are the
plain versions, used for CPU tensors and as the kernels' reference on the
card. :func:`probe_inputs` draws the probe's inputs from the probe's own
seeded generator, in its order, so the numpy expectation is the probe's;
:func:`pool_inputs` draws the same forms at the brick pool's shapes, where
the bytes and not the launch are the cost.
"""

import numpy as np
import torch

from supereight_tpu_torch.kernels import _lib


def _args(table, idx, name):
    dev = table.device
    _lib.check(table, f"{name} table", torch.float32, device=dev)
    _lib.check(idx, f"{name} idx", torch.int32, device=dev)
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be 2-D")
    return dev


def take_rows(table, idx):
    """Form A: ``take(table, idx, axis=0)``, f32[R, C], i32[N] ->
    f32[N, C]."""
    dev = _args(table, idx, "take_rows")
    if dev.type == "cpu":
        return take_rows_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"take_rows: unsupported device {dev}")
    rows, cols = table.shape
    out = torch.empty((idx.shape[0], cols), dtype=torch.float32, device=dev)
    _lib.launch("gather_a", "se_gather_a", dev, table, idx, rows,
                idx.shape[0], cols, out)
    return out


def take_along_rows(table, idx):
    """Form B: ``take_along_axis(table, idx, axis=0)``, f32[R, C],
    i32[N, C] -> f32[N, C]."""
    dev = _args(table, idx, "take_along_rows")
    if dev.type == "cpu":
        return take_along_rows_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"take_along_rows: unsupported device {dev}")
    rows, cols = table.shape
    _lib.check(idx, "take_along_rows idx", torch.int32,
               (idx.shape[0], cols), dev)
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _lib.launch("gather_b", "se_gather_b", dev, table, idx, rows,
                idx.shape[0], cols, out)
    return out


def take_along_cols(table, idx):
    """Form C: ``take_along_axis(table, idx, axis=1)``, a within-row
    gather: f32[N, C], i32[N, J] -> f32[N, J]."""
    dev = _args(table, idx, "take_along_cols")
    if dev.type == "cpu":
        return take_along_cols_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"take_along_cols: unsupported device {dev}")
    n, table_cols = table.shape
    _lib.check(idx, "take_along_cols idx", torch.int32,
               (n, idx.shape[1]), dev)
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _lib.launch("gather_c", "se_gather_c", dev, table, idx, table_cols, n,
                idx.shape[1], out)
    return out


def take_rows_staged(table, idx):
    """Form D: the dynamic row-slice loop, the same result as form A: one
    thread per 16-byte vector of the output over the whole grid, each
    reading its row's index."""
    dev = _args(table, idx, "take_rows_staged")
    if dev.type == "cpu":
        return take_rows_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"take_rows_staged: unsupported device {dev}")
    rows, cols = table.shape
    out = torch.empty((idx.shape[0], cols), dtype=torch.float32, device=dev)
    _lib.launch("gather_d", "se_gather_d", dev, table, idx, rows,
                idx.shape[0], cols, out)
    return out


def take_rows_plain(table, idx):
    return table[idx.long()]


def take_along_rows_plain(table, idx):
    return torch.gather(table, 0, idx.long())


def take_along_cols_plain(table, idx):
    return torch.gather(table, 1, idx.long())


# the launch name of each form, in FORMS' order
KEYS = ("gather_a", "gather_b", "gather_c", "gather_d")

# (name as the probe prints it, kernel wrapper, plain twin, numpy form)
FORMS = (
    ("A take axis0 row-gather", take_rows, take_rows_plain,
     lambda t, i: t[i]),
    ("B take_along_axis axis0", take_along_rows, take_along_rows_plain,
     lambda t, i: np.take_along_axis(t, i, axis=0)),
    ("C take_along_axis axis1", take_along_cols, take_along_cols_plain,
     lambda t, i: np.take_along_axis(t, i, axis=1)),
    ("D fori dynamic row slice", take_rows_staged, take_rows_plain,
     lambda t, i: t[i]),
)


def probe_inputs(seed: int = 0):
    """The four forms' (table f32, idx i32) numpy inputs at the probe's
    shapes, drawn like the probe: one generator, forms A-D in order."""
    rng = np.random.default_rng(seed)
    out = []
    for rows, cols, idx_shape, hi in ((512, 128, (256,), 512),
                                      (512, 128, (256, 128), 512),
                                      (256, 512, (256, 128), 512),
                                      (512, 128, (64,), 512)):
        t = rng.normal(size=(rows, cols)).astype(np.float32)
        i = rng.integers(0, hi, idx_shape).astype(np.int32)
        out.append((t, i))
    return out


# the bench config's brick pool (tools/bench.config): bricks of 512
# voxels and the integration budget in blocks
POOL_BRICKS, BRICK_VOXELS, POOL_BUDGET = 36864, 512, 8192


def pool_inputs(seed: int = 0, scale: int = 1):
    """The four forms' (table f32, idx i32) numpy inputs at the brick
    pool's shapes, ``scale`` dividing the row counts: A and D gather
    POOL_BUDGET distinct bricks of the f32[POOL_BRICKS, 512] pool; B
    takes, for each voxel of each of those rows, the voxel of a random
    brick (i32[POOL_BUDGET, 512] indices into the pool); C gathers within
    the rows of an f32[POOL_BUDGET, 512] table (indices in [0, 512)). A,
    B and D share the pool array."""
    rng = np.random.default_rng(seed)
    rows, n = POOL_BRICKS // scale, POOL_BUDGET // scale
    pool = rng.standard_normal((rows, BRICK_VOXELS), dtype=np.float32)
    bricks = rng.permutation(rows)[:n].astype(np.int32)
    along = rng.integers(0, rows, (n, BRICK_VOXELS), dtype=np.int32)
    table_c = rng.standard_normal((n, BRICK_VOXELS), dtype=np.float32)
    within = rng.integers(0, BRICK_VOXELS, (n, BRICK_VOXELS), dtype=np.int32)
    return [(pool, bricks), (pool, along), (table_c, within), (pool, bricks)]


def moved_bytes(key, table, idx):
    """The bytes form ``key`` (:data:`KEYS`) must move on these tensors:
    the distinct table elements it reads, its index and its output, 4
    bytes each (each input read once, each output written once)."""
    rows, cols = table.shape
    i64 = idx.long()
    if key in ("gather_a", "gather_d"):
        n_read, n_out = torch.unique(i64).numel() * cols, idx.numel() * cols
    elif key == "gather_b":
        col = torch.arange(cols, device=idx.device)
        n_read, n_out = torch.unique(i64 * cols + col).numel(), idx.numel()
    else:
        row = torch.arange(rows, device=idx.device)[:, None]
        n_read, n_out = torch.unique(row * cols + i64).numel(), idx.numel()
    return 4 * (n_read + idx.numel() + n_out)


def sector_bytes(table, idx):
    """Form C's sector floor: the bytes of the table's 32-byte sectors
    that ``idx`` touches (the table taken as 32-byte aligned), and its
    index and output, 4 bytes each: what a read of whole sectors must
    move, where :func:`moved_bytes` counts the distinct elements."""
    rows, cols = table.shape
    row = torch.arange(rows, device=idx.device)[:, None]
    n_sectors = torch.unique((row * cols + idx.long()) // 8).numel()
    return 32 * n_sectors + 8 * idx.numel()
