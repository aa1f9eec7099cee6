"""Hand-written CUDA kernels of the port: build, binding, wrappers, twins.

Each wrapper module (``icp``, ``alloc``, ``integrate``, ``node``,
``nav``, ``raycast``, ``preprocess``, ``frame``, ``halo``, ``ba``,
``gather_probe``) launches its kernel for CUDA tensors and runs its
plain PyTorch twin for CPU tensors; it never falls back to the twin on a
GPU. ``_lib`` builds and loads the
library and keeps the launch counts (``_lib.LAUNCHES``,
zeroed by ``_lib.reset_launches``).
"""
