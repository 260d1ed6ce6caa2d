"""Scene intermediate representation: one frozen SoA pytree.

This is the wavefront replacement for the reference's object graph
(Scene/Shape/BSDF/Emitter/Medium plugin instances wired by the parser,
src/render/scene.cpp:23-113).  Instead of refcounted C++ objects with
vectorized virtual calls, the whole scene is flattened host-side into dense
typed tables (type code + parameter rows + texture/bitmap indices); the
render kernels dispatch with masked selects over the *static* set of types
present, which `jax.jit` specializes per scene structure — the analog of the
reference recompiling a megakernel per scene.

All buffers are device arrays; all Python-level metadata (counts, type sets,
film size) is static so it participates in jit specialization, not tracing.
"""
from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.distr import DiscreteDistribution, Distribution2D
from ..core.types import static_field

Array = jax.Array

# ---------------------------------------------------------------------------
# Type codes (stable ABI between builder and kernels)
# ---------------------------------------------------------------------------
BSDF_DIFFUSE = 0
BSDF_DIELECTRIC = 1
BSDF_THINDIELECTRIC = 2
BSDF_CONDUCTOR = 3
BSDF_ROUGHCONDUCTOR = 4
BSDF_PLASTIC = 5
BSDF_NULL = 6
BSDF_ROUGHDIELECTRIC = 7
BSDF_ROUGHPLASTIC = 8
BSDF_BLEND = 9
BSDF_MASK = 10
BSDF_PRINCIPLED = 11
BSDF_HAIR = 12
BSDF_POLARIZER = 13
BSDF_RETARDER = 14
BSDF_CIRCULAR = 15
BSDF_MEASURED = 16
BSDF_PPLASTIC = 17
BSDF_PRINCIPLEDTHIN = 18

EMITTER_AREA = 0
EMITTER_POINT = 1
EMITTER_CONSTANT = 2
EMITTER_ENVMAP = 3
EMITTER_DIRECTIONAL = 4
EMITTER_SPOT = 5
EMITTER_PROJECTOR = 6

TEX_CONST = 0
TEX_BITMAP = 1
TEX_CHECKERBOARD = 2
TEX_MESHATTR = 3
TEX_VOLUME = 4

MEDIUM_HOMOGENEOUS = 0
MEDIUM_HETEROGENEOUS = 1
MEDIUM_GLISSON = 2
MEDIUM_PARENCHYMA = 3
MEDIUM_LIVER = 4

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2
PHASE_BLEND = 3
PHASE_TAB = 4
PHASE_SGGX = 5

SHAPE_MESH = 0
SHAPE_SPHERE = 1
SHAPE_SDF = 2

# triangles per block of the instanced-geometry intersection pass; group
# streams are zero-padded to a multiple of this (degenerate tris never hit)
INST_CHUNK = 128

FILTER_BOX = 0
FILTER_GAUSSIAN = 1
FILTER_TENT = 2
FILTER_MITCHELL = 3
FILTER_CATMULLROM = 4
FILTER_LANCZOS = 5

SENSOR_PERSPECTIVE = 0
SENSOR_THINLENS = 1
SENSOR_ORTHOGRAPHIC = 2
SENSOR_DISTANT = 3
SENSOR_RADIANCEMETER = 4
SENSOR_IRRADIANCEMETER = 5
SENSOR_BATCH = 6

# BSDF flag bits (subset of reference include/mitsuba/render/bsdf.h BSDFFlags)
F_NULL = 1 << 0
F_DIFFUSE_REFL = 1 << 1
F_GLOSSY_REFL = 1 << 2
F_GLOSSY_TRANS = 1 << 3
F_DELTA_REFL = 1 << 4
F_DELTA_TRANS = 1 << 5
F_SMOOTH = F_DIFFUSE_REFL | F_GLOSSY_REFL | F_GLOSSY_TRANS
F_DELTA = F_DELTA_REFL | F_DELTA_TRANS | F_NULL

# parameter-row widths
BSDF_P = 12     # float params per bsdf row
EMITTER_P = 16
TEX_P = 10
MEDIUM_P = 52


@struct.dataclass
class Textures:
    """Texture table. data rows: TEX_CONST rgb in [0:3]; TEX_CHECKERBOARD
    color0 [0:3] color1 [3:6] uv-scale [6:8] uv-offset [8:10]; TEX_BITMAP
    uv-scale [6:8] uv-offset [8:10] and bitmap index in `bitmap_id`.

    Capability analog of reference src/textures/{bitmap,checkerboard}.cpp +
    constant spectra.
    """
    ttype: Array       # (Tx,) int32
    data: Array        # (Tx, TEX_P) float32
    bitmap_id: Array   # (Tx,) int32, -1 if none
    # Bitmaps stacked & padded to a common (H, W); per-bitmap true sizes.
    bitmaps: Array     # (K, H, W, 3) float32 (linear RGB)
    bitmap_hw: Array   # (K, 2) int32 true (h, w)
    # quad-packed copy: [c00 c01 c10 c11] per texel (wrap-aware) so one
    # bilinear tap is ONE per-lane gather instead of four
    quads: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 1, 1, 12), jnp.float32))
    # 3D texture grids (src/textures/volume + volumes/grid.cpp as texture)
    vgrids: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 2, 2, 2, 3), jnp.float32))
    vgrid_whd: Array = struct.field(
        default_factory=lambda: jnp.full((1, 3), 2, jnp.int32))
    vgrid_to_local: Array = struct.field(
        default_factory=lambda: jnp.eye(4, dtype=jnp.float32)[None])
    has_quads: bool = static_field(default=False)
    types_present: Tuple[int, ...] = static_field(default=(TEX_CONST,))


@struct.dataclass
class BSDFs:
    """BSDF table.

    Param rows by type (reference plugin params in src/bsdfs/*.cpp):
      DIFFUSE:          tex0 = reflectance
      DIELECTRIC:       p0 = eta (int/ext); tex0 = specular_reflectance,
                        tex1 = specular_transmittance
      THINDIELECTRIC:   p0 = eta
      CONDUCTOR:        p0:3 = eta, p3:6 = k; tex0 = specular_reflectance
      ROUGHCONDUCTOR:   + p6 = alpha_u, p7 = alpha_v (GGX)
      ROUGHDIELECTRIC:  p0 = eta, p6 = alpha
      PLASTIC:          p0 = eta, p1 = nonlinear, p2 = fdr_int, p3 = fdr_ext,
                        p4 = spec_sampling_weight; tex0 = diffuse_reflectance
      NULL:             --
      MASK:             tex0 = opacity, inner = nested bsdf
      BLEND:            tex0 = weight, inner = bsdf0, p0(int) via inner2
    """
    btype: Array     # (B,) int32
    params: Array    # (B, BSDF_P) float32
    tex0: Array      # (B,) int32 texture index (-1 => white)
    tex1: Array      # (B,) int32
    inner: Array     # (B,) int32 nested bsdf (mask/blend), -1 otherwise
    inner2: Array    # (B,) int32 second nested bsdf (blend)
    flags: Array     # (B,) uint32 BSDF flag bits
    twosided: Array  # (B,) bool
    types_present: Tuple[int, ...] = static_field(default=(BSDF_DIFFUSE,))
    # static texture-type sets actually reachable from each slot, so
    # eval_texture skips the (expensive) bitmap gather when a slot only
    # ever holds constants
    tex0_types: Tuple[int, ...] = static_field(default=(TEX_CONST,))
    tex1_types: Tuple[int, ...] = static_field(default=(TEX_CONST,))


@struct.dataclass
class Emitters:
    """Emitter table. Param rows by type (src/emitters/*.cpp):
      AREA:        tex0 = radiance texture; shape = owning shape
      POINT:       p0:3 position, p3:6 intensity
      CONSTANT:    p0:3 radiance
      ENVMAP:      bitmap via tex0, p6 scale; to_world in `emitter_to_world`
      DIRECTIONAL: p0:3 direction (world, unit), p3:6 irradiance
      SPOT:        p0:3 position, p3:6 intensity, p6 cos_cutoff, p7 cos_beam,
                   p8:11 direction
    """
    etype: Array          # (E,) int32
    params: Array         # (E, EMITTER_P) float32
    shape: Array          # (E,) int32 shape index for area emitters, -1 else
    tex0: Array           # (E,) int32 radiance texture
    to_world: Array       # (E, 4, 4) float32 (envmap orientation)
    distr: DiscreteDistribution   # emitter-selection distribution
    # Environment importance map (envmap emitters); identity row for others.
    env_distr: Distribution2D
    env_index: int = static_field(default=-1)   # scene env emitter id or -1
    types_present: Tuple[int, ...] = static_field(default=())
    count: int = static_field(default=0)


@struct.dataclass
class Media:
    """Participating media table.

    params layout (MEDIUM_P = 52 floats / row):
      common:        [0:3] sigma_t rgb, [3:6] albedo rgb, [6] scale,
                     [7] phase g, [8] (int) phase type, [9] has_spectral_ext
      HETEROGENEOUS: [10] max_density (majorant), grid via `grid_id`
      GLISSON (src/media/glissonCapsule.cpp:146-189):
                     [12:24] sigma_collagen layer1..4 rgb
                     [24:36] sigma_elastin layer1..4 rgb
                     [36:40] layer limits 1..4
      PARENCHYMA (src/media/parenchyma.cpp):
                     [12:15] sigma_blood, [15:18] sigma_bile,
                     [18:21] sigma_lipid_water, [21] sigma_hepatocity
      LIVER (src/media/liver.cpp:140-194): union of both layouts —
                     glisson block at [12:40], parenchyma block at [40] on:
                     blood/bile/lipid_water stored at [12:21]? no — LIVER uses
                     glisson slots [12:40] plus [40:43] blood, [43:46] bile,
                     hepatocity [46], lipid_water stored in sigma_t slot? —
                     see builder.py _pack_medium for the authoritative layout.
    """
    mtype: Array     # (M,) int32
    params: Array    # (M, MEDIUM_P) float32
    grid_id: Array   # (M,) int32 into grids, -1 if none
    grids: Array     # (G, D, H, W, 4) stacked density/albedo grids (padded)
    grid_whd: Array  # (G, 3) int32 true sizes
    grid_to_local: Array  # (G, 4, 4) world->grid-local transforms
    types_present: Tuple[int, ...] = static_field(default=())
    # static set of phase-function codes used by any medium (gates the
    # extended-phase evaluation paths)
    phase_types: Tuple[int, ...] = static_field(default=(0,))
    count: int = static_field(default=0)


@struct.dataclass
class MeasuredTable:
    """RGL measured-material tables (bsdf/measured.py; reference
    src/bsdfs/measured.cpp).  One material per scene round 1."""
    theta_i: Array = struct.field(
        default_factory=lambda: jnp.zeros((1,), jnp.float32))
    vndf_row: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 3), jnp.float32))
    vndf_cond: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 2, 3), jnp.float32))
    vndf_pdf: Array = struct.field(
        default_factory=lambda: jnp.ones((1, 2, 2), jnp.float32))
    lum_row: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 3), jnp.float32))
    lum_cond: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 2, 3), jnp.float32))
    lum_pdf: Array = struct.field(
        default_factory=lambda: jnp.ones((1, 2, 2), jnp.float32))
    spectra: Array = struct.field(
        default_factory=lambda: jnp.ones((1, 3, 2, 2), jnp.float32))
    ndf: Array = struct.field(
        default_factory=lambda: jnp.ones((2, 2), jnp.float32))
    sigma: Array = struct.field(
        default_factory=lambda: jnp.ones((2, 2), jnp.float32))
    jacobian: bool = static_field(default=False)
    enabled: bool = static_field(default=False)


@struct.dataclass
class BVH:
    """Flattened 2-wide BVH in depth-first order over the *global* triangle
    stream (device-side analog of reference kdtree.h / scene_embree.inl).
    Internal node i: left child = i+1, right child = right[i].
    Leaf: right[i] == -1, prims [first[i], first[i]+count[i]).
    `perm` maps BVH-leaf order -> global triangle index."""
    node_min: Array   # (Nn, 3)
    node_max: Array   # (Nn, 3)
    right: Array      # (Nn,) int32
    first: Array      # (Nn,) int32
    count: Array      # (Nn,) int32
    perm: Array       # (T,) int32
    depth: int = static_field(default=32)


SSUB_VAE = 0
SSUB_DIPOLE = 1


@struct.dataclass
class SubsurfaceTable:
    """BSSRDF plugin table (reference subsurface.h:8-61 + vaescatter/dipole).

    params rows: sigma_t [0:3], albedo [3:6], g [6], eta [7].
    poly: per-vertex per-RGB-channel degree-3 world-space polynomial
    coefficients (the reference's Mesh PolyStorage, mesh.h:427-434),
    fitted at build time (ssub/preprocess.py).
    dip_*: the dipole's irradiance point cloud (ssub/dipole.py); dip_consts
    packs (zr[3], zv[3], sigma_tr[3], eta)."""
    params: Array      # (Ns, 8)
    poly: Array        # (V, 3, 20) float32
    weights: Any       # ssub.vae.VAEWeights (pytree) or None
    ss_type: Array = struct.field(
        default_factory=lambda: jnp.zeros((1,), jnp.int32))
    dip_points: Array = struct.field(
        default_factory=lambda: jnp.zeros((256, 3)))
    dip_irradiance: Array = struct.field(
        default_factory=lambda: jnp.zeros((256, 3)))
    dip_area: Array = struct.field(
        default_factory=lambda: jnp.zeros((256,)))
    dip_consts: Array = struct.field(
        default_factory=lambda: jnp.ones((10,)))
    kernel_eps_scale: float = static_field(default=1.0)
    enabled: bool = static_field(default=False)
    has_vae: bool = static_field(default=False)
    has_dipole: bool = static_field(default=False)


@struct.dataclass
class VolPrims:
    """Volumetric (Gaussian-splat) primitive table for the radiance-field
    integrator (reference src/shapes/ellipsoids*.cpp attribute storage +
    ad/integrators/volprim_rf_basic.py).

    Each ellipsoids-shape row carries the 3DGS parameters; tri_ell maps
    every triangle of the instanced-icosphere tessellation back to its
    ellipsoid so the wavefront can fetch (center, scale, rot, opacity,
    sh) from the hit prim id in one gather."""
    center: Array    # (N, 3)
    scale: Array     # (N, 3)
    rot: Array       # (N, 3, 3) quaternion-derived rotation
    opacity: Array   # (N,)
    sh: Array        # (N, K, 3) SH coefficients, K = (deg+1)^2
    tri_ell: Array   # (T,) int32 triangle -> ellipsoid index, -1 none
    count: int = static_field(default=0)
    sh_degree: int = static_field(default=0)
    srgb: bool = static_field(default=True)


def _empty_volprims() -> "VolPrims":
    return VolPrims(center=jnp.zeros((1, 3)), scale=jnp.ones((1, 3)),
                    rot=jnp.eye(3)[None], opacity=jnp.zeros((1,)),
                    sh=jnp.zeros((1, 1, 3)),
                    tri_ell=jnp.full((1,), -1, jnp.int32))


@struct.dataclass
class Sensor:
    """Camera (reference src/sensors/{perspective,thinlens,
    orthographic}.cpp)."""
    to_world: Array       # (4,4) camera-to-world
    fov_x: Array          # () x-field-of-view in degrees
    near_clip: Array      # ()
    far_clip: Array       # ()
    aperture_radius: Array = struct.field(
        default_factory=lambda: jnp.float32(0.0))
    focus_distance: Array = struct.field(
        default_factory=lambda: jnp.float32(1.0))
    # distant sensor (src/sensors/distant.cpp): scene bounding sphere
    # (cx, cy, cz, r) for cross-section origin sampling + optional target
    bsphere: Array = struct.field(
        default_factory=lambda: jnp.array([0, 0, 0, 1], jnp.float32))
    target: Array = struct.field(
        default_factory=lambda: jnp.zeros(3, jnp.float32))
    # batch sensor (src/sensors/batch.cpp): stacked child camera params,
    # film width split evenly across children
    batch_to_world: Array = struct.field(
        default_factory=lambda: jnp.eye(4, dtype=jnp.float32)[None])
    batch_fov_x: Array = struct.field(
        default_factory=lambda: jnp.full((1,), 45.0, jnp.float32))
    stype: int = static_field(default=SENSOR_PERSPECTIVE)
    has_target: bool = static_field(default=False)
    # irradiancemeter (src/sensors/irradiancemeter.cpp): parent shape index
    target_shape: int = static_field(default=-1)
    batch_count: int = static_field(default=1)


@struct.dataclass
class Scene:
    # ------------- geometry (world space, SoA) -------------
    vertices: Array       # (V, 3) float32
    faces: Array          # (T, 3) int32
    normals: Array        # (V, 3) float32 vertex normals
    uvs: Array            # (V, 2) float32
    tri_shape: Array      # (T,) int32 owning shape id
    # analytic spheres
    sph_center: Array     # (Sp, 3)
    sph_radius: Array     # (Sp,)
    sph_shape: Array      # (Sp,) int32 owning shape id
    # ------------- shape table (S,) -------------
    shape_bsdf: Array         # (S,) int32
    shape_emitter: Array      # (S,) int32, -1 none
    shape_int_medium: Array   # (S,) int32, -1 none
    shape_ext_medium: Array   # (S,) int32, -1 none
    shape_bump_tex: Array     # (S,) int32 texture for bump/normal map, -1
    shape_bump_scale: Array   # (S,)
    shape_subsurface: Array   # (S,) int32 subsurface index, -1 none
    shape_type: Array         # (S,) int32 SHAPE_MESH / SHAPE_SPHERE
    shape_prim_offset: Array  # (S,) int32 first prim (tri or sphere idx)
    shape_prim_count: Array   # (S,) int32
    shape_area: Array         # (S,) total surface area
    # area-emitter triangle sampling: global cumulative triangle areas
    tri_area_cdf: Array       # (T,)
    tri_area: Array           # (T,)
    # packed (16, Tpad) Baldwin-Weber buffer for the GPU intersect kernel
    # (BVH-leaf order) + per-chunk AABBs + buffer column -> original-id map
    tri_buf: Array
    tri_boxes: Array
    tri_kperm: Array
    # (3,) local-frame origin of the packed buffer (scene-AABB midpoint):
    # Baldwin-Weber rows are computed and queried relative to it so the
    # kernel keeps fp32 precision for scenes far from the world origin
    tri_center: Array
    # (T, 25) packed per-triangle interaction row: p0 e1 e2 n0 n1 n2
    # uv0 uv1 uv2 shape — compute_si reads ONE gather instead of 11
    tri_si: Array
    # ------------- tables -------------
    bsdfs: BSDFs
    emitters: Emitters
    textures: Textures
    media: Media
    bvh: BVH
    sensor: Sensor
    ssub: SubsurfaceTable
    # per-vertex fiber tangents for curve tubes ((1,3) zeros when unused);
    # hair shading frames take s = tangent (scene/curves.py)
    tangents: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 3), jnp.float32))
    # per-vertex rgb attribute for mesh_attribute textures
    vertex_attrs: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 3), jnp.float32))
    measured: MeasuredTable = struct.field(default_factory=MeasuredTable)
    volprims: VolPrims = struct.field(default_factory=_empty_volprims)
    # ------------- instanced geometry (shapegroup/instance) -------------
    # Non-flattened instancing (reference src/shapes/{shapegroup,
    # instance}.cpp): each shapegroup's triangle stream is stored ONCE in
    # GROUP-LOCAL space; instances are 3x4 to-world transforms composed
    # inside the intersector (geometry memory is O(group + n_instances),
    # not O(group * n_instances)).  Layout: the per-instance
    # pass transforms the shared TRIANGLES into world space chunk-by-chunk
    # (broadcast over lanes, a handful of 3-vectors per chunk) instead of
    # transforming every ray into instance space — the same vertex-then-
    # subtract float ops the flattening baker performs, so instanced and
    # flattened renders agree to fp32 rounding.
    inst_tris: Array = struct.field(          # (Tg, 3, 3) local p0,p1,p2
        default_factory=lambda: jnp.zeros((1, 3, 3), jnp.float32))
    inst_si: Array = struct.field(            # (Tg, 25) local si rows:
        # p0 p1 p2 n0 n1 n2 uv0 uv1 uv2 shape (NOT e1/e2 — world-space
        # edges are formed after the per-lane instance transform)
        default_factory=lambda: jnp.zeros((1, 25), jnp.float32))
    inst_xf: Array = struct.field(            # (I, 21): to-world 3x4
        # row-major [0:12] + inverse-transpose 3x3 row-major [12:21]
        default_factory=lambda: jnp.zeros((1, 21), jnp.float32))
    inst_face_start: Array = struct.field(    # (I,) first tri (chunk-
        default_factory=lambda: jnp.zeros((1,), jnp.int32))  # aligned)
    inst_n_chunks: Array = struct.field(      # (I,) tri chunks in group
        default_factory=lambda: jnp.zeros((1,), jnp.int32))
    inst_bmin: Array = struct.field(          # (I, 3) world AABB
        default_factory=lambda: jnp.zeros((1, 3), jnp.float32))
    inst_bmax: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 3), jnp.float32))
    # SDF grid shapes (reference src/shapes/sdfgrid.cpp): signed-distance
    # values on a [0,1]^3-local grid, sphere-traced in the intersector
    sdf_grids: Array = struct.field(          # (K, D, H, W) padded
        default_factory=lambda: jnp.zeros((1, 2, 2, 2), jnp.float32))
    sdf_whd: Array = struct.field(            # (K, 3) true (W, H, D)
        default_factory=lambda: jnp.full((1, 3), 2, jnp.int32))
    sdf_to_local: Array = struct.field(       # (K, 4, 4) world -> unit cube
        default_factory=lambda: jnp.eye(4, dtype=jnp.float32)[None])
    sdf_shape: Array = struct.field(          # (K,) owning shape id
        default_factory=lambda: jnp.full((1,), -1, jnp.int32))
    # ------------- static config -------------
    n_shapes: int = static_field(default=0)
    n_tris: int = static_field(default=0)
    n_spheres: int = static_field(default=0)
    n_sdfs: int = static_field(default=0)
    # instancing statics: instance count, total padded group-stream tris,
    # and the largest group's chunk count (the instanced pass's inner
    # loop bound)
    n_instances: int = static_field(default=0)
    n_inst_tris: int = static_field(default=0)
    inst_max_chunks: int = static_field(default=0)
    film_w: int = static_field(default=256)
    film_h: int = static_field(default=256)
    rfilter: int = static_field(default=FILTER_GAUSSIAN)
    spp: int = static_field(default=64)
    sampler_kind: str = static_field(default="independent")
    integrator: str = static_field(default="path")
    max_depth: int = static_field(default=8)
    rr_depth: int = static_field(default=5)
    hide_emitters: bool = static_field(default=False)
    camera_medium: int = static_field(default=-1)
    intersector: str = static_field(default="auto")  # auto|brute|bvh|pallas
    has_bump: bool = static_field(default=False)
    # which perturbation families exist (bump scale sign encodes normalmap)
    has_heightmap: bool = static_field(default=False)
    has_normalmap: bool = static_field(default=False)
    # curve tubes present: shading frames align s with the fiber tangent
    has_tangents: bool = static_field(default=False)
    has_vertex_attr: bool = static_field(default=False)
    # Static NEE reachability, computed at build: surface NEE needs a
    # shape-referenced smooth BSDF; medium NEE needs a non-bio medium under
    # a volpath-family integrator.  When both are false the whole
    # emitter-sampling block (env 2D-CDF sampling + attenuated shadow walk)
    # is elided at trace time — all liver scenes are delta-surface-only.
    needs_surface_nee: bool = static_field(default=True)
    needs_medium_nee: bool = static_field(default=True)
    # spectral variant (reference fwd.h:216 *_spectral_* builds): the
    # surface-path transport carries N_SPEC hero-wavelength samples per
    # lane, RGB inputs lifted by Smits upsampling (core/spectrum.py),
    # film converts CIE->sRGB at lane death
    spectral: bool = static_field(default=False)

    # convenience -----------------------------------------------------------
    @property
    def has_env(self) -> bool:
        return self.emitters.env_index >= 0
