"""The integration layer (``ops/allocation.py``, ``ops/integration.py``):
K5's marches and allocator, K3's worklist, fused pass and fallback, K4's
rank and node pass, device microseconds a traced frame."""

KERNELS = ("alloc_touch", "alloc_touch_of", "alloc_assign",
           "integrate_worklist", "integrate_fused", "integrate_fallback",
           "node_rank", "node_pass")


def read(ctx):
    us = ctx["timeline"].kernel_us(KERNELS)
    return None if us is None else us / ctx["frames"]
