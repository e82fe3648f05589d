# Copied from path_tracer_tpu/core/constants.py (numpy-only host code shared with the JAX package).
"""Global constants shared by host and device code.

Mirrors the semantic constants of the reference renderer
(reference src/core/common.glsl.inc:4-12 and
reference src/scene/scene.glsl.inc:7-28), re-expressed for a
JAX/TPU implementation. Indices that the reference encodes as unsigned
0xFFFFFFFF sentinels are encoded here as INT32 sentinels so that the
"minimum index wins" priority logic keeps working with signed int32
arrays on TPU.
"""

INFINITY = 1e30
EPSILON = 1e-9
PI = 3.141592653
TAU = 6.283185306

HIT_TIME_LIMIT = 1048576.0

CIE_LAMBDA_MIN = 360.0
CIE_LAMBDA_MAX = 830.0

# Sentinel "no shape / no texture / no material" index. The reference uses
# 0xFFFFFFFF (scene.glsl.inc:7-8); we use int32 max so min-reductions over
# active-shape lists behave identically.
SHAPE_INDEX_NONE = 0x7FFFFFFF
TEXTURE_INDEX_NONE = 0x7FFFFFFF

SHAPE_TYPE_MESH_INSTANCE = 0
SHAPE_TYPE_PLANE = 1
SHAPE_TYPE_SPHERE = 2
SHAPE_TYPE_CUBE = 3
# Padded shape-table slots (scene/compile.py bucket padding): inert
# rows that keep packed array shapes -- and with them the compiled
# program cache keys -- stable under small scene edits. Never produced
# by a hit; skipped by layout reconstruction.
SHAPE_TYPE_NONE = -1

TEXTURE_TYPE_RAW = 0
TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA = 1
TEXTURE_TYPE_RADIANCE = 2

TEXTURE_FLAG_FILTER_NEAREST = 1 << 0

MATERIAL_TYPE_BASIC_DIFFUSE = 0
MATERIAL_TYPE_BASIC_METAL = 1
MATERIAL_TYPE_BASIC_TRANSLUCENT = 2
MATERIAL_TYPE_OPENPBR = 3

CAMERA_MODEL_PINHOLE = 0
CAMERA_MODEL_THIN_LENS = 1
CAMERA_MODEL_360 = 2

RENDER_FLAG_ACCUMULATE = 1 << 0
RENDER_FLAG_SAMPLE_JITTER = 1 << 1

TONE_MAPPING_MODE_CLAMP = 0
TONE_MAPPING_MODE_REINHARD = 1
TONE_MAPPING_MODE_HABLE = 2
TONE_MAPPING_MODE_ACES = 3

# Number of hero wavelengths carried by every path (basic_scatter.glsl:116).
WAVELENGTH_CLUSTER_SIZE = 4

# Size of the per-path nested-dielectric active shape list
# (basic.glsl.inc ACTIVE_SHAPE_LIMIT).
ACTIVE_SHAPE_LIMIT = 4

# Material attribute blob geometry: each material occupies an integral
# number of 32-word slots; OpenPBR uses two slots (scene.hpp:468-519).
MATERIAL_SLOT_WORDS = 32
