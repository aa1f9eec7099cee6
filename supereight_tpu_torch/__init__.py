"""supereight-tpu on PyTorch + CUDA: dense SLAM (TSDF and OFusion fields)
on one NVIDIA Hopper GPU, from a depth sequence to a trajectory and map.

A port of the JAX package ``supereight_tpu`` (which stays the reference
it is tested against). It imports ``torch`` and numpy only — never
``jax`` and never ``supereight_tpu`` — so it runs on a host that has no
JAX. The hot stages are hand-written CUDA C++ kernels (``csrc/``) bound
through ctypes (``kernels/``); each has a plain PyTorch twin that runs
whenever its input tensors lie on the CPU.

Layer map (mirrors the JAX package):
  cli        -- the headless front-end: a .raw sequence (or a synthetic
                one) through the class pipeline to a frame log, a TUM
                trajectory and the ATE
  config     -- run configuration and the JAX CLI's flags
  pipeline   -- DenseSLAMSystem (the class pipeline) and the input
                pyramid (K7)
  parallel/  -- the fused frame step
  ops/       -- tracking (K6), allocation (K5), integration (K3 block
                pass, K4 node pass), raycast (K2 nav grid, K1, primed or
                unprimed), rendering, mm2meters
  core/      -- SE(3) helpers, the block-pool map and its voxel queries,
                interpolation, the Volume facade, collision, the functor
                and the Morton key algebra
  posegraph/ -- the keyframe pose graph and its windowed BA (K9)
  fields/    -- the TSDF and OFusion fields
  kernels/   -- kernel build, ctypes binding, wrappers and twins
                (and K8, the gather-form probe)
  csrc/      -- CUDA C++ sources (sm_90a)
  io/        -- dataset readers, .raw conversion, map snapshots, the
                synthetic scenes, marching-cubes export (numpy)
  eval/      -- ATE, RPE and dataset sweeps (numpy)
  utils/     -- perfstats
  viewer     -- 2x2 composite snapshots (PPM)
  tools/     -- entry points (probe_gather, longseq)
"""

__version__ = "0.1.0"

from supereight_tpu_torch.core.map import (MapGeometry, MapState,  # noqa: F401
                                           make_map)
from supereight_tpu_torch.fields import (OFUSION, TSDF,  # noqa: F401
                                         get_field)
