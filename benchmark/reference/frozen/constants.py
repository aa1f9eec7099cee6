"""Pipeline constants: the values of ``supereight_tpu/constants.py``.

Values mirror the reference's compile-time constants so that trajectories are
comparable (ref: se_denseslam/include/se/constant_parameters.h:17-37 and
se_core/include/se/octree_defines.h:38-44).
"""

# Depth-pyramid / bilateral-filter range sigma (meters).
E_DELTA = 0.1
# Bilateral filter window radius (pixels).
RADIUS = 2
# Bilateral filter spatial sigma (pixels).
DELTA = 4.0

# ICP gates (ref: constant_parameters.h + tracking.cpp:226-302).
DIST_THRESHOLD = 0.1     # max point-to-point distance (m), rejection code -4
NORMAL_THRESHOLD = 0.8   # min normal dot product, rejection code -5
TRACK_THRESHOLD = 0.15   # min inlier fraction accepted by checkPoseKernel

# TSDF fusion weight cap (ref: DenseSLAMSystem.cpp:235).
MAX_WEIGHT = 100

# Rendering clip planes (meters).
NEAR_PLANE = 0.4
FAR_PLANE = 4.0

# Voxel block side (ref: octree_defines.h:38). The whole layout assumes 8.
BLOCK_SIDE = 8
BLOCK_VOXELS = BLOCK_SIDE ** 3  # 512

# Occupancy-field constants (ref: volume_traits.hpp:74-81).
SURF_BOUNDARY = 0.0
TOP_CLAMP = 1000.0
BOTTOM_CLAMP = -1000.0
CAPITAL_T = 4.0          # temporal decay window tau

# Tracking-status codes shared by trackKernel and renderTrack
# (ref: tracking.cpp:250-288, documented at DenseSLAMSystem.h:249-258).
TRACK_OK = 1
TRACK_NO_INPUT = -1
TRACK_OUT_OF_FRAME = -2
TRACK_NO_REF_NORMAL = -3
TRACK_TOO_FAR = -4
TRACK_BAD_NORMAL = -5

# Sentinel used in normal maps for invalid entries (ref: commons.h INVALID=-2).
INVALID = -2.0
