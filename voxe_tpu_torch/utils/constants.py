"""Framework-wide constants.

Parity notes: mirrors the semantic constants of the reference implementation
(reference: thre3d_atom/utils/constants.py:1-28) so that rendered outputs and
checkpoints carry the same keys.
"""

NUM_COORD_DIMENSIONS = 3  # (x, y, z)
NUM_COLOUR_CHANNELS = 3  # (r, g, b)
NUM_RGBA_CHANNELS = 4
NUM_ATTN_CHANNELS = 1

SEED = 42
ZERO_PLUS = 1e-10
INFINITY = 1e10

# volumetric rendering keys
EXTRA_DISPARITY = "disparity"
EXTRA_ACCUMULATED_WEIGHTS = "accumulated_weight"
EXTRA_POINT_DENSITIES = "point_densities"
EXTRA_POINT_OCCUPANCIES = "point_occupancies"
EXTRA_SAMPLE_INTERVALS = "deltas"
EXTRA_POINT_WEIGHTS = "point_weights"
EXTRA_POINT_DEPTHS = "point_depths"

# camera related keys
CAMERA_BOUNDS = "camera_bounds"
CAMERA_INTRINSICS = "camera_intrinsics"
HEMISPHERICAL_RADIUS = "hemispherical_radius"

# misc keys
EXTRA_INFO = "extra_info"
