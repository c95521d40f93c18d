"""SceneDesc -> FlatScene: the tensor scene representation (port of
tungsten_tpu/scene/flatten.py).

All finite geometry is gathered into one triangle SoA with a host-built
SAH BVH and the wave kernels' cluster tables; BSDFs are parameter-table
rows; emissive primitives form a light table with alias tables; an
equirect env map carries its importance-sampling tables.  FlatScene is
a dataclass of tensors on one device.

The port flattens what its path tracer renders: quad, cube and mesh
primitives, the analytic disk, sphere and cylinder, infinite_sphere
(env map), infinite_sphere_cap, point and skydome (a Hosek-Wilkie sky
baked to an env map, scene/sky.py) emitters, the BSDFs of
bsdf/types.py::PORTED_TYPES (nested children are table rows of their
own, so present_bsdf_types lists them), every light those make,
homogeneous, exponential, atmosphere and voxel media (dense `.npy`,
inline data or `.vdb` grids) bound to primitives and the camera, the
pinhole, thinlens (disk or bitmap aperture, cat eye, focus pivot),
equirectangular and cubemap cameras, `curves` in all four modes (split
into linear pieces under a piece BVH) with the hair azimuthal tables of
the fiber BCSDFs, `instances` (expanded into their masters), the
path_tracer integrator.  Anything else (minecraft maps, which the JAX
package refuses too, the other integrators) raises NotImplementedError
naming it.  The numbers are the JAX package's: the same host numpy code
builds every table, so every field is equal to the JAX build (bf16
fields included).  Beside the JAX-named curve tables the port keeps the
curve walk's packed rows (`crv_rows`, `cwbvh_rows`, pack_curve_rows).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace as _replace

import numpy as np
import torch

from tungsten_tpu_torch.bsdf import types as bsdf_types
from tungsten_tpu_torch.device import resolve_device
from tungsten_tpu_torch.io import mesh as mesh_io
from tungsten_tpu_torch.media import grid as grid_mod
from tungsten_tpu_torch.media import phase as phase_mod
from tungsten_tpu_torch.media import transmittance as trans_mod
from tungsten_tpu_torch.scene import transform as xform
from tungsten_tpu_torch.scene.parse import SceneDesc
from tungsten_tpu_torch.scene.textures import TextureTableBuilder

LIGHT_AREA = 0
LIGHT_INFINITE = 1
LIGHT_CAP = 2
LIGHT_POINT = 3
LIGHT_DISK = 4
LIGHT_CYLINDER = 5
LIGHT_SPHERE = 6

PORTED_PRIMITIVES = ("quad", "cube", "mesh", "infinite_sphere", "disk",
                     "sphere", "cylinder", "infinite_sphere_cap", "point",
                     "skydome", "curves", "instances")

# curve render modes (ref Curves.cpp:20-25)
CURVE_MODE_CYLINDER = 0
CURVE_MODE_HALF_CYLINDER = 1
CURVE_MODE_BCSDF_CYLINDER = 2
CURVE_MODE_RIBBON = 3
CURVE_MODES = {"cylinder": CURVE_MODE_CYLINDER,
               "half_cylinder": CURVE_MODE_HALF_CYLINDER,
               "bcsdf_cylinder": CURVE_MODE_BCSDF_CYLINDER,
               "ribbon": CURVE_MODE_RIBBON}
CURVE_SUBDIV = 8  # linear pieces per quadratic segment (leaf test)
# the curve walk's packed rows (pack_curve_rows): a piece is 16 words
# [q0 xyzw | q1 xyzw | nmid xyz, t0 | t1, seg, mode, 0]; a node of the
# 4-wide piece BVH is 32 words, 8 a child [min xyz, word | max xyz, end]
# with word first_piece * 8 + count for a leaf, node * 8 for an interior
# child and 0 for an empty slot (node 0, the root, is no one's child),
# and end one past the last piece under the child (0 for an empty slot);
# the integer words as int32 bits
CRV_ROW = 16
CWBVH_ROW = 32
PORTED_CAMERAS = ("pinhole", "thinlens", "equirectangular", "cubemap")
PORTED_INTEGRATORS = ("path_tracer", "bidirectional_path_tracer",
                      "light_tracer", "photon_map", "progressive_photon_map",
                      "kelemen_mlt", "multiplexed_mlt", "reversible_jump_mlt")


def _lt_slot_of_tri(lt_tri_l, num_tris):
    """Reverse map: global triangle id -> its alias-table slot."""
    slot = np.full(max(num_tris, 1), -1, np.int32)
    if lt_tri_l:
        cat = np.concatenate(lt_tri_l).astype(np.int64)
        slot[cat] = np.arange(len(cat), dtype=np.int32)
    return slot


def _build_alias(p):
    """Walker/Vose alias table for probabilities p (sum ~1).  Returns
    (prob (n,) f32 keep-probability, alias (n,) i32 local index)."""
    n = len(p)
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    scaled = np.asarray(p, np.float64) * n
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        lg = large.pop()
        prob[s] = scaled[s]
        alias[s] = lg
        scaled[lg] = (scaled[lg] + scaled[s]) - 1.0
        (small if scaled[lg] < 1.0 else large).append(lg)
    return prob, alias


@dataclass
class FlatScene:
    # --- triangles (SoA, BVH leaf order) ---
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_shade: torch.Tensor   # (T, 21) [e1, e2, n0, n1, n2, uv0, uv1, uv2]
    tri_n0: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_prim: torch.Tensor    # (T,) i32
    tri_fin: torch.Tensor     # (T, 9) [v0 | e1 | e2] finalize rows
    # --- BVH ---
    bvh_min: torch.Tensor     # (N,3)
    bvh_max: torch.Tensor
    bvh_meta: torch.Tensor    # (N,2) i32
    bvh_skip: torch.Tensor    # (N,) i32
    # --- wave kernel cluster tables ---
    wk_boxes: torch.Tensor    # (16, NCp)
    wk_cbox: torch.Tensor     # (NCp, 8)
    wk_sbox: torch.Tensor     # (16, NSp)
    wk_attr: torch.Tensor     # (NCp*16, 128)
    wk_remap: torch.Tensor    # (NCp*128,) i32
    # --- analytic primitives ---
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_prim: torch.Tensor
    dsk_c: torch.Tensor
    dsk_n: torch.Tensor
    dsk_r: torch.Tensor
    dsk_cos: torch.Tensor
    dsk_prim: torch.Tensor
    cyl_pos: torch.Tensor
    cyl_rot: torch.Tensor
    cyl_r: torch.Tensor
    cyl_hh: torch.Tensor
    cyl_capped: torch.Tensor
    cyl_prim: torch.Tensor
    # --- curves (ref Curves.cpp): quadratic B-spline segments split into
    # CURVE_SUBDIV linear pieces under a piece BVH (the JAX names), and
    # the packed rows of the curve walk ---
    crv_seg_p0: torch.Tensor    # (Cs,4) control points xyz+width (world)
    crv_seg_p1: torch.Tensor
    crv_seg_p2: torch.Tensor
    crv_seg_n0: torch.Tensor    # (Cs,3) node normals (ribbon mode)
    crv_seg_n1: torch.Tensor
    crv_seg_n2: torch.Tensor
    crv_seg_prim: torch.Tensor  # (Cs,) i32
    crv_seg_mode: torch.Tensor  # (Cs,) i32 CURVE_MODE_*
    crv_pc_q0: torch.Tensor     # (Cp,4) piece endpoints xyz+width
    crv_pc_q1: torch.Tensor
    crv_pc_nmid: torch.Tensor   # (Cp,3) spline normal at piece midpoint
    crv_pc_seg: torch.Tensor    # (Cp,) i32 parent segment
    crv_pc_t0: torch.Tensor     # (Cp,) segment-parameter range
    crv_pc_t1: torch.Tensor
    cbvh_min: torch.Tensor      # curve-piece BVH (same layout as bvh_*)
    cbvh_max: torch.Tensor
    cbvh_meta: torch.Tensor
    cbvh_skip: torch.Tensor
    crv_rows: torch.Tensor      # (Cp, CRV_ROW) f32 packed pieces
    cwbvh_rows: torch.Tensor    # (M, CWBVH_ROW) f32 packed wide nodes
    # --- hair BCSDF azimuthal tables (ref PrecomputedAzimuthalLobe),
    # one set per hair-type BSDF ---
    hair_values: torch.Tensor   # (H,3,AZ,AZ,3) N_R/N_TT/N_TRT
    hair_pdf: torch.Tensor      # (H,3,AZ,AZ) row-normalized pdf
    hair_cdf: torch.Tensor      # (H,3,AZ,AZ+1)
    hair_sums: torch.Tensor     # (H,3,AZ) unnormalized row sums
    hair_params: torch.Tensor   # (H,4) scale_angle_rad, vR, vTT, vTRT
    # --- primitives ---
    prim_bsdf: torch.Tensor
    prim_emission_tex: torch.Tensor
    prim_light: torch.Tensor
    # --- bsdf table ---
    bsdf_type: torch.Tensor
    bsdf_albedo_tex: torch.Tensor
    bsdf_params: torch.Tensor
    bsdf_aux: torch.Tensor
    # --- textures ---
    tex_type: torch.Tensor
    tex_const: torch.Tensor
    tex_params: torch.Tensor
    tex_bitmap_id: torch.Tensor
    bitmaps: tuple
    # --- lights ---
    light_type: torch.Tensor
    light_prim: torch.Tensor
    light_slot: torch.Tensor
    light_emission: torch.Tensor
    lt_prob: torch.Tensor
    lt_alias: torch.Tensor
    lt_tri: torch.Tensor
    lt_slot: torch.Tensor
    light_tri_off: torch.Tensor
    light_tri_cnt: torch.Tensor
    light_area: torch.Tensor
    light_aux: torch.Tensor
    light_bsr: torch.Tensor
    light_lum: torch.Tensor
    # --- scene-wide occluder bounds ---
    geo_lo: torch.Tensor
    geo_hi: torch.Tensor
    # --- infinite sphere caps (directional "sun" emitters) ---
    cap_dir: torch.Tensor         # (C,3)
    cap_cos: torch.Tensor         # (C,) 2 = never hit (no caps)
    cap_emission: torch.Tensor    # (C,3)
    cap_samplable: torch.Tensor   # (C,) bool
    # --- media (ref HomogeneousMedium / ExponentialMedium /
    # AtmosphericMedium / VoxelMedium) ---
    med_sigma_a: torch.Tensor     # (M,3) material sigma_a * density
    med_sigma_s: torch.Tensor     # (M,3)
    med_phase: torch.Tensor       # (M,) i32
    med_g: torch.Tensor           # (M,)
    med_trans_type: torch.Tensor  # (M,) i32
    med_trans_params: torch.Tensor  # (M,4); (M,16) if any law interpolated
    med_max_bounce: torch.Tensor  # (M,) i32
    med_kind: torch.Tensor        # (M,) i32 media/grid.py MED_*
    med_grid: torch.Tensor        # (M,) i32 grid index of voxel media, -1
    med_exp_params: torch.Tensor  # (M,8) exponential / atmosphere params
    grid_density: tuple           # (nx,ny,nz) f32, zero-padded border
    grid_emission: tuple          # (nx,ny,nz,3) f32, (0,0,0,3) if none
    grid_w2g: torch.Tensor        # (G,3,4) world -> padded grid index
    grid_super: tuple             # (sx,sy,sz,2) [muC, muR] supergrids
    prim_int_medium: torch.Tensor  # (P,) i32, -1 = none
    prim_ext_medium: torch.Tensor  # (P,) i32
    cam_medium: torch.Tensor      # () i32
    # --- envmap ---
    env_image: torch.Tensor   # (H,W,3) bf16
    env_cond_pdf: torch.Tensor
    env_cond_cdf: torch.Tensor
    env_marg_pdf: torch.Tensor
    env_marg_cdf: torch.Tensor
    env_alias: torch.Tensor   # (H*W, 4) [prob, alias, pdf_self, pdf_alias]
    env_quad: torch.Tensor    # (H*W, 12) bf16 bilinear neighborhood rows
    env_pdf_tab: torch.Tensor
    env_to_world: torch.Tensor
    env_to_local: torch.Tensor
    env_light_index: torch.Tensor
    env_emission_scale: torch.Tensor
    # --- camera ---
    cam_mat: torch.Tensor
    cam_plane_dist: torch.Tensor
    cam_ap_prob: torch.Tensor     # (N,) thinlens aperture alias keep-prob
    cam_ap_alias: torch.Tensor    # (N,) i32
    cam_ap_hw: torch.Tensor       # (2,) i32 aperture bitmap (H, W)
    cam_ratio: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def replace(self, **changes) -> "FlatScene":
        """The same scene with the given fields replaced (the flax
        dataclass's `replace`)."""
        return _replace(self, **changes)

    def to(self, device) -> "FlatScene":
        """The same scene with every tensor on `device`."""
        dev = torch.device(device)
        return FlatScene(**{
            f.name: (tuple(b.to(dev) for b in v) if f.name in TUPLE_FIELDS
                     else v.to(dev))
            for f in fields(self) for v in (getattr(self, f.name),)})


# FlatScene fields that hold a tuple of tensors of differing shapes
TUPLE_FIELDS = ("bitmaps", "grid_density", "grid_emission", "grid_super")


@dataclass(frozen=True)
class RenderSettings:
    """Static render configuration (hashable)."""
    width: int
    height: int
    spp: int = 16
    max_bounces: int = 64
    min_bounces: int = 0
    enable_light_sampling: bool = True
    enable_volume_light_sampling: bool = True
    two_sided_shading: bool = True
    seed: int = 0xBA5EBA11
    tonemap: str = "gamma"
    filter: str = "tent"
    camera_type: str = "pinhole"
    cubemap_mode: str = "horizontal_cross"
    fov_deg: float = 60.0
    focus_distance: float = 1.0
    aperture_size: float = 0.001
    aperture_tex: bool = False  # thinlens aperture bitmap present
    cat_eye: float = 0.0
    spp_step: int = 16
    stratified_sampler: bool = False  # scrambled Sobol' vs pcg4d hash
    adaptive_sampling: bool = False
    has_env: bool = False
    has_curves: bool = False
    curve_modes: tuple = ()  # CURVE_MODE_* present
    num_lights: int = 0
    present_bsdf_types: tuple = ()
    has_media: bool = False
    num_caps: int = 0
    has_points: bool = False
    has_disk_lights: bool = False
    has_cyl_lights: bool = False
    has_sphere_lights: bool = False
    has_area_lights: bool = True
    med_kinds: tuple = ()    # medium kinds present (media/grid.py MED_*)
    grid_steps: int = 96     # raymarch steps for voxel optical depth
    # voxel optical depth (ref VdbGrid IntegrationMethod): "raymarching"
    # (fixed-step midpoint quadrature), "residual_ratio" (ratio tracking
    # over the majorant supergrid), "exact_linear" / "exact_nearest"
    # (voxel-boundary DDA)
    voxel_integration: str = "raymarching"
    # voxel distance sampling (ref VdbGrid SampleMethod): "raymarching"
    # or the "exact_linear" / "exact_nearest" DDA inversion
    voxel_sampling: str = "raymarching"
    rr_max_events: int = 192  # event cap per ratio-tracking query
    integrator_type: str = "path_tracer"
    bdpt_vertices: int = 8   # per-subpath vertex cap for bdpt/light_tracer
    mlt_path_length: int = -1  # MMLT: restrict to one path length
    # the MLT family (ref KelemenMltSettings / MultiplexedMltSettings /
    # ReversibleJumpMltSettings)
    mlt_large_step_prob: float = 0.1
    mlt_sample_pool: int = 10000     # initial_sample_pool
    mlt_chains: int = 8192           # parallel chains a batch
    mlt_strategy_prob: float = 0.05  # strategy_perturbation_probability
    # kelemen_mlt / multiplexed_mlt's base sampler (ref
    # KelemenMltSettings.hpp:19 "bidirectional", default true): the chains
    # mutate a BDPT tape instead of the path tracer's
    mlt_bidirectional: bool = True
    # photon_map / progressive_photon_map (ref PhotonMapSettings.hpp)
    photon_count: int = 1 << 20
    gather_radius: float = 0.05
    gather_count: int = 20   # gather_photon_count (kNN k)
    vol_gather_radius: float = 0.05  # volume_gather_radius
    vol_photon_type: str = "points"  # "points" | "beams" | "planes"
    vol_photon_count: int = 10000    # paths the beam / plane maps keep
    ppm_alpha: float = 0.3           # PPM's radius shrink (alpha)
    # output buffers (ref OutputBufferSettings): when True the wavefront
    # tracks depth/normal/albedo/visibility at the first non-specular
    # vertex (PathTracer.cpp:78-96) alongside the radiance
    track_aovs: bool = False


_UNIT_QUAD_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)


class _GeomAccum:
    def __init__(self):
        self.v0, self.e1, self.e2 = [], [], []
        self.n0, self.n1, self.n2 = [], [], []
        self.uv0, self.uv1, self.uv2 = [], [], []
        self.prim = []

    def add_tris(self, verts, uvs, normals, tri_idx, prim_id):
        """verts (V,3), uvs (V,2), normals (V,3), tri_idx (T,3)."""
        a = verts[tri_idx[:, 0]]
        b = verts[tri_idx[:, 1]]
        c = verts[tri_idx[:, 2]]
        self.v0.append(a)
        self.e1.append(b - a)
        self.e2.append(c - a)
        self.n0.append(normals[tri_idx[:, 0]])
        self.n1.append(normals[tri_idx[:, 1]])
        self.n2.append(normals[tri_idx[:, 2]])
        self.uv0.append(uvs[tri_idx[:, 0]])
        self.uv1.append(uvs[tri_idx[:, 1]])
        self.uv2.append(uvs[tri_idx[:, 2]])
        self.prim.append(np.full(tri_idx.shape[0], prim_id, np.int32))

    def count(self):
        return sum(p.shape[0] for p in self.prim)


def _quad_verts(m):
    """Tungsten quad: unit XZ square through origin (ref Quad.cpp)."""
    base = xform.transform_point(m, [0.0, 0.0, 0.0])
    e0 = xform.transform_vectors(m, [[1.0, 0.0, 0.0]])[0]
    e1 = xform.transform_vectors(m, [[0.0, 0.0, 1.0]])[0]
    base = base - 0.5 * e0 - 0.5 * e1
    verts = np.stack([base, base + e0, base + e0 + e1, base + e1])
    n = np.cross(e1, e0)
    n = n / max(np.linalg.norm(n), 1e-30)
    return verts.astype(np.float32), n.astype(np.float32)


def _cube_tris(m):
    """Unit cube [-0.5,0.5]^3 in local space, 12 tris."""
    corners = np.array(
        [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]
    )
    faces = [
        (0, 1, 3, 2, (-1, 0, 0)), (4, 6, 7, 5, (1, 0, 0)),
        (0, 4, 5, 1, (0, -1, 0)), (2, 3, 7, 6, (0, 1, 0)),
        (0, 2, 6, 4, (0, 0, -1)), (1, 5, 7, 3, (0, 0, 1)),
    ]
    verts, uvs, normals, tris = [], [], [], []
    for a, b, c, d, _ in faces:
        i = len(verts)
        world = xform.transform_points(m, corners[[a, b, c, d]])
        fn = np.cross(world[1] - world[0], world[3] - world[0])
        fn = fn / max(np.linalg.norm(fn), 1e-30)
        verts.extend(world)
        uvs.extend(_UNIT_QUAD_UV)
        normals.extend([fn] * 4)
        tris.append((i, i + 1, i + 2))
        tris.append((i, i + 2, i + 3))
    return (np.asarray(verts, np.float32), np.asarray(uvs, np.float32),
            np.asarray(normals, np.float32), np.asarray(tris, np.int32))


def _build_env_distribution(img: np.ndarray):
    """Luminance*sin(theta) weights with 3-wide max dilation, per-row +
    marginal CDFs, and an O(1) alias table over all texels (packed rows
    [prob_keep, alias_idx, texel_pdf, alias_texel_pdf])."""
    h, w = img.shape[:2]
    weight = img.max(axis=-1)
    rows = np.sin((np.arange(h) * np.pi) / h)[:, None]
    wgt = weight * rows
    wgt = np.maximum(wgt, np.maximum(np.roll(wgt, 1, axis=1),
                                     np.roll(wgt, -1, axis=1)))
    wgt = np.maximum(wgt, np.maximum(np.roll(wgt, 1, axis=0),
                                     np.roll(wgt, -1, axis=0)))

    row_sum = wgt.sum(axis=1)
    cond_pdf = np.where(row_sum[:, None] < 1e-4, 1.0 / w,
                        wgt / np.maximum(row_sum[:, None], 1e-30))
    cond_cdf = np.zeros((h, w + 1), np.float32)
    cond_cdf[:, 1:] = np.cumsum(cond_pdf, axis=1)
    cond_cdf[:, -1] = 1.0

    marg = row_sum / max(row_sum.sum(), 1e-30)
    marg_cdf = np.zeros(h + 1, np.float32)
    marg_cdf[1:] = np.cumsum(marg)
    marg_cdf[-1] = 1.0

    p_tex = (cond_pdf * marg[:, None]).reshape(-1).astype(np.float64)
    p_tex = p_tex / max(p_tex.sum(), 1e-300)
    n = p_tex.size
    scaled = p_tex * n
    alias = np.arange(n, dtype=np.int64)
    prob = np.ones(n, np.float64)
    small = [i for i in np.nonzero(scaled < 1.0)[0]]
    large = [i for i in np.nonzero(scaled >= 1.0)[0]]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    packed = np.zeros((n, 4), np.float32)
    packed[:, 0] = prob
    packed[:, 1] = alias
    pdf_rel = p_tex * n
    packed[:, 2] = pdf_rel
    packed[:, 3] = pdf_rel[alias]
    return (cond_pdf.astype(np.float32), cond_cdf,
            marg.astype(np.float32), marg_cdf, packed)


def _build_env_quad(img: np.ndarray) -> np.ndarray:
    """(H*W, 12) bilinear neighborhood table: row (iy*W+ix) packs the
    2x2 texel block [c00, c10, c01, c11] with wrap addressing."""
    h, w = img.shape[:2]
    c01 = np.roll(img, -1, axis=0)
    return np.concatenate([img, np.roll(img, -1, axis=1), c01,
                           np.roll(c01, -1, axis=1)],
                          axis=-1).reshape(h * w, 12).astype(np.float32)


def _flatten_curves(prim: dict, m: np.ndarray, resolve_path, prim_id: int):
    """One `curves` primitive -> world-space quadratic segments
    (ref Curves::loadCurves + prepareForRender, Curves.cpp:282-616)."""
    from tungsten_tpu_torch.io import curves as curve_io
    data = curve_io.load_curves(resolve_path(prim["file"]))
    nodes = data.nodes.copy()
    normals = data.normals

    curve_ends = data.curve_ends.astype(np.int64)
    starts = np.concatenate([[0], curve_ends[:-1]])
    counts = curve_ends - starts

    # thickness override / taper run before the transform
    # (Curves::loadCurves, Curves.cpp:296-306)
    if prim.get("curve_thickness") is not None:
        nodes[:, 3] = float(prim["curve_thickness"])
    if bool(prim.get("curve_taper", False)):
        curve_of = np.repeat(np.arange(len(counts)), counts)
        t_in = np.arange(len(nodes)) - starts[curve_of]
        nodes[:, 3] *= 1.0 - (t_in - 0.5) / np.maximum(
            counts[curve_of] - 1, 1)

    # transform nodes; widths scale by the average axis scale
    # (Curves::prepareForRender, Curves.cpp:577-585)
    width_scale = float(np.mean(np.linalg.norm(m[:3, :3], axis=0)))
    nodes[:, :3] = xform.transform_points(m, nodes[:, :3])
    nodes[:, 3] *= width_scale
    nrm = xform.transform_vectors(m, normals)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)

    # subsample: drop whole curves with probability `subsample`
    # (Curves.cpp:593-594)
    subsample = float(prim.get("subsample", 0.0))
    keep = np.ones(len(counts), bool)
    if subsample > 0.0:
        keep = np.random.default_rng(0xBA5EBA11).random(len(counts)) \
            >= subsample

    # segment index triples: curve i contributes nodes [s+2, e)
    seg_last = []
    for i in np.nonzero(keep & (counts >= 3))[0]:
        seg_last.append(np.arange(starts[i] + 2, curve_ends[i]))
    if not seg_last:
        return None
    t2 = np.concatenate(seg_last)
    mode = CURVE_MODES.get(prim.get("mode", "half_cylinder"),
                           CURVE_MODE_HALF_CYLINDER)
    return dict(
        p0=nodes[t2 - 2], p1=nodes[t2 - 1], p2=nodes[t2],
        n0=nrm[t2 - 2].astype(np.float32),
        n1=nrm[t2 - 1].astype(np.float32),
        n2=nrm[t2].astype(np.float32),
        prim=np.full(len(t2), prim_id, np.int32),
        mode=np.full(len(t2), mode, np.int32),
    )


def _build_curve_tables(curve_segs: list):
    """Concatenate per-prim segments, pre-subdivide into linear pieces,
    and build the piece BVH.  Returns a dict of FlatScene crv_*/cbvh_*
    arrays (numpy), equal to the JAX package's."""
    from tungsten_tpu_torch.scene.bvh import build_bvh
    curve_segs = [c for c in curve_segs if c is not None]
    if not curve_segs:
        z4 = np.zeros((0, 4), np.float32)
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros((0,), np.int32)
        zf = np.zeros((0,), np.float32)
        bvh = build_bvh(np.zeros((0, 3)), np.zeros((0, 3)))
        return dict(
            crv_seg_p0=z4, crv_seg_p1=z4, crv_seg_p2=z4,
            crv_seg_n0=z3, crv_seg_n1=z3, crv_seg_n2=z3,
            crv_seg_prim=zi, crv_seg_mode=zi,
            crv_pc_q0=z4, crv_pc_q1=z4, crv_pc_nmid=z3,
            crv_pc_seg=zi, crv_pc_t0=zf, crv_pc_t1=zf,
            cbvh_min=bvh.bounds_min, cbvh_max=bvh.bounds_max,
            cbvh_meta=bvh.meta, cbvh_skip=bvh.skip)

    p0 = np.concatenate([c["p0"] for c in curve_segs]).astype(np.float32)
    p1 = np.concatenate([c["p1"] for c in curve_segs]).astype(np.float32)
    p2 = np.concatenate([c["p2"] for c in curve_segs]).astype(np.float32)
    n0 = np.concatenate([c["n0"] for c in curve_segs])
    n1 = np.concatenate([c["n1"] for c in curve_segs])
    n2 = np.concatenate([c["n2"] for c in curve_segs])
    seg_prim = np.concatenate([c["prim"] for c in curve_segs])
    seg_mode = np.concatenate([c["mode"] for c in curve_segs])
    cs = p0.shape[0]
    S = CURVE_SUBDIV

    # B-spline coefficient form (precomputeBSplineCoefficients,
    # Curves.cpp:135-144): q(t) = a t^2 + b t + c
    a = 0.5 * p0 - p1 + 0.5 * p2
    b = p1 - p0
    c = 0.5 * (p0 + p1)
    ts = np.linspace(0.0, 1.0, S + 1, dtype=np.float32)
    vals = (a[:, None] * (ts ** 2)[None, :, None]
            + b[:, None] * ts[None, :, None] + c[:, None])  # (Cs, S+1, 4)
    q0 = vals[:, :-1].reshape(cs * S, 4)
    q1 = vals[:, 1:].reshape(cs * S, 4)
    tmid = 0.5 * (ts[:-1] + ts[1:])
    an, bn, cn = 0.5 * n0 - n1 + 0.5 * n2, n1 - n0, 0.5 * (n0 + n1)
    nmid = (an[:, None] * (tmid ** 2)[None, :, None]
            + bn[:, None] * tmid[None, :, None]
            + cn[:, None]).reshape(cs * S, 3).astype(np.float32)
    pc_seg = np.repeat(np.arange(cs, dtype=np.int32), S)
    pc_t0 = np.tile(ts[:-1], cs)
    pc_t1 = np.tile(ts[1:], cs)

    # piece AABBs: chord box + width + curvature bulge bound
    # (max chord deviation of a quadratic over 1/S of its span)
    bulge = np.linalg.norm(a[:, :3], axis=-1) / (4.0 * S * S)
    pad = (np.maximum(q0[:, 3], q1[:, 3])
           + np.repeat(bulge, S)).astype(np.float32)[:, None]
    lo = np.minimum(q0[:, :3], q1[:, :3]) - pad
    hi = np.maximum(q0[:, :3], q1[:, :3]) + pad
    bvh = build_bvh(lo, hi)
    order = bvh.order
    return dict(
        crv_seg_p0=p0, crv_seg_p1=p1, crv_seg_p2=p2,
        crv_seg_n0=n0, crv_seg_n1=n1, crv_seg_n2=n2,
        crv_seg_prim=seg_prim, crv_seg_mode=seg_mode,
        crv_pc_q0=q0[order], crv_pc_q1=q1[order],
        crv_pc_nmid=nmid[order], crv_pc_seg=pc_seg[order],
        crv_pc_t0=pc_t0[order], crv_pc_t1=pc_t1[order],
        cbvh_min=bvh.bounds_min, cbvh_max=bvh.bounds_max,
        cbvh_meta=bvh.meta, cbvh_skip=bvh.skip)


def _stack_hair_tables(fiber_tables: list) -> dict:
    """Stack per-hair-bsdf azimuthal tables; a benign 1-entry placeholder
    keeps gathers in range when no hair is present."""
    from tungsten_tpu_torch.bsdf.fiber import AZ_RES
    if not fiber_tables:
        return dict(
            hair_values=np.zeros((1, 3, AZ_RES, AZ_RES, 3), np.float32),
            hair_pdf=np.full((1, 3, AZ_RES, AZ_RES), 1.0 / AZ_RES,
                             np.float32),
            hair_cdf=np.broadcast_to(
                np.arange(AZ_RES + 1, dtype=np.float32) / AZ_RES,
                (1, 3, AZ_RES, AZ_RES + 1)).copy(),
            hair_sums=np.ones((1, 3, AZ_RES), np.float32),
            hair_params=np.asarray([[0.0, 0.04, 0.01, 0.16]], np.float32))
    return dict(
        hair_values=np.stack([t["values"] for t in fiber_tables]),
        hair_pdf=np.stack([t["pdf"] for t in fiber_tables]),
        hair_cdf=np.stack([t["cdf"] for t in fiber_tables]),
        hair_sums=np.stack([t["sums"] for t in fiber_tables]),
        hair_params=np.stack([t["params"] for t in fiber_tables]))


def wide_curve_rows(meta, bounds_min, bounds_max) -> np.ndarray:
    """The curve walk's wide node rows (M, CWBVH_ROW) f32 from the binary
    piece BVH (cbvh_meta / _min / _max, numpy): bvh.collapse_wide's
    4-wide tree, each child's box, word and piece-range end in its
    parent's row.  Any depth packs (the walk restarts where its stack
    overflows); raises only where a word would overflow."""
    from tungsten_tpu_torch.scene.bvh import collapse_wide, subtree_end
    meta = np.asarray(meta).astype(np.int64)
    child, wide, _ = collapse_wide(meta, bounds_min, bounds_max)
    b = np.maximum(child, 0)
    word = np.where(wide >= 0, wide * 8, meta[b, 0] * 8 + meta[b, 1])
    word = np.where(child >= 0, word, 0)
    end = np.where(child >= 0, subtree_end(meta)[b], 0)
    if word.size and int(word.max()) >= 2 ** 31:
        raise ValueError("curve piece or node count exceeds the packed word")
    rows = np.zeros(child.shape + (8,), np.float32)
    full = child >= 0
    rows[..., 0:3] = np.where(full[..., None], bounds_min[b], 0.0)
    rows[..., 4:7] = np.where(full[..., None], bounds_max[b], 0.0)
    rows.view(np.int32)[..., 3] = word
    rows.view(np.int32)[..., 7] = end
    return rows.reshape(-1, CWBVH_ROW)


def pack_curve_rows(flds: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The curve walk's packed rows from the JAX-named tensors of `flds`:
    (crv_rows (Cp, CRV_ROW), cwbvh_rows (M, CWBVH_ROW)) f32 on their
    device, so that one piece test is one 64-byte load and one node
    visit one 128-byte load of its four children's boxes
    (wide_curve_rows)."""
    q0, q1 = flds["crv_pc_q0"], flds["crv_pc_q1"]
    seg = flds["crv_pc_seg"].to(torch.int32)
    cp = q0.shape[0]
    mode = flds["crv_seg_mode"].to(torch.int32)
    pmode = mode[seg.long()] if cp else seg
    ints = torch.stack([seg, pmode, torch.zeros_like(seg)], dim=-1)
    crv_rows = torch.cat([
        q0, q1, flds["crv_pc_nmid"], flds["crv_pc_t0"][:, None],
        flds["crv_pc_t1"][:, None], ints.view(torch.float32)], dim=1)
    wide = wide_curve_rows(*(flds[k].cpu().numpy() for k in (
        "cbvh_meta", "cbvh_min", "cbvh_max")))
    return crv_rows.contiguous(), torch.from_numpy(wide).to(q0.device)


def _to_tensor(x, device, dtype=None) -> torch.Tensor:
    """numpy -> tensor with the JAX package's 32-bit defaults (float64 ->
    float32, int64 -> int32); `dtype` forces a type (bf16 tables)."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":   # a JAX bf16 array carried across
        t = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(device)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    elif x.dtype == np.int64:
        x = x.astype(np.int32)
    t = torch.from_numpy(np.array(x, order="C", copy=True)).to(device)
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------- media

def _vec3(v, default=0.0):
    if v is None:
        v = default
    if isinstance(v, (int, float)):
        return [float(v)] * 3
    return [float(x) for x in v]


SUPERGRID_SUB = grid_mod.SUPERGRID_SUB  # voxels per supercell axis


def build_supergrid(dens: np.ndarray, sub: int = SUPERGRID_SUB):
    """Residual-ratio control/majorant supergrid (ref
    VdbGrid::generateSuperGrid, VdbGrid.cpp:87-134): per supercell of
    sub^3 voxels compute muC (control, the Novak et al. 2014 formula
    clamped to [muMin, muAvg]) and muR >= max |rho - muC| over the
    cell.  Min/max are dilated by one voxel so trilinear samples near
    cell borders stay inside the bound (keeps the ratio-tracking factor
    1 - (rho-muC)/muR nonnegative)."""
    nx, ny, nz = dens.shape
    sx, sy, sz = (-(-nx // sub), -(-ny // sub), -(-nz // sub))
    pad = np.zeros((sx * sub, sy * sub, sz * sub), np.float32)
    pad[:nx, :ny, :nz] = dens

    def dilate(a, op):
        for ax in range(3):
            lo = np.concatenate([a.take([0], ax), a], ax)
            hi = np.concatenate([a, a.take([-1], ax)], ax)
            a = op(lo.take(range(a.shape[ax]), ax),
                   hi.take(range(1, a.shape[ax] + 1), ax))
        return a

    mx = dilate(pad, np.maximum)
    mn = dilate(pad, np.minimum)

    def block(a, red):
        return red(a.reshape(sx, sub, sy, sub, sz, sub), axis=(1, 3, 5))

    mu_max = block(mx, np.max)
    mu_min = block(mn, np.min)
    mu_avg = block(pad, np.mean)
    width = mu_max - mu_min
    gamma = 2.0
    D = np.sqrt(3.0) * sub
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        mu_c = mu_min + width * (np.power(gamma,
                                          1.0 / (D * np.maximum(width,
                                                                1e-30)))
                                 - 1.0)
    mu_c = np.clip(np.nan_to_num(mu_c, posinf=0.0), mu_min, mu_avg)
    mu_r = np.maximum(mu_max - mu_c, mu_c - mu_min)
    return np.stack([mu_c, mu_r], axis=-1).astype(np.float32)


def _load_grid(g: dict, resolve_path):
    """Load a density grid spec -> (density (padded), emission|None, w2g).

    Specs: {"type": "dense", "file": "x.npy" | "data": [[[...]]],
    "emission_file"/"emission_data": ..., "density_scale": s,
    "emission_scale": s, "scale_emission_by_density": bool,
    "transform": {...}} — the transform maps the local unit cube
    [-0.5, 0.5]^3 onto the world (the primitives' convention); or
    {"type": "vdb", "file": "x.vdb", ...} (`_load_vdb_grid`).

    The density grid is zero-padded by one voxel per side so clamped
    trilinear lookups read zero outside the active region; w2g maps
    world points to padded index coordinates (ref
    src/core/grids/VdbGrid.hpp:16-44: the sparse tree becomes a dense
    device brick)."""
    gtype = g.get("type", "dense")
    if gtype == "vdb":
        return _load_vdb_grid(g, resolve_path)
    if gtype != "dense":
        raise NotImplementedError(f"grid type not supported: {gtype}")

    if "data" in g:
        dens = np.asarray(g["data"], np.float32)
    else:
        dens = np.load(resolve_path(g["file"])).astype(np.float32)
    if dens.ndim != 3 or min(dens.shape) < 2:
        raise ValueError("dense grid must be (nx,ny,nz) with n >= 2")
    dens = dens * float(g.get("density_scale", 1.0))

    emis = None
    if "emission_data" in g or "emission_file" in g:
        if "emission_data" in g:
            emis = np.asarray(g["emission_data"], np.float32)
        else:
            emis = np.load(resolve_path(g["emission_file"])).astype(
                np.float32)
        if emis.ndim == 3:
            emis = np.repeat(emis[..., None], 3, axis=-1)
        emis = emis * float(g.get("emission_scale", 1.0))
        if g.get("scale_emission_by_density", False):
            emis = emis * dens[..., None]
        emis = np.pad(emis, ((1, 1), (1, 1), (1, 1), (0, 0)))

    n = np.asarray(dens.shape, np.float64)
    dens = np.pad(dens, 1)

    m = xform.parse_transform(g.get("transform"))
    minv = np.linalg.inv(m)
    # index = (local + 0.5) * (n - 1) + 1  (padded by one voxel)
    a = (n - 1)[:, None] * minv[:3, :3]
    b = (minv[:3, 3] + 0.5) * (n - 1) + 1.0
    w2g = np.concatenate([a, b[:, None]], axis=1).astype(np.float32)
    return dens, emis, w2g


def _host_trilinear(vol, pts):
    """Host-side trilinear sample of vol (nx,ny,nz,C) at pts (N,3);
    out-of-range clamps (the brick is zero-padded so clamps read 0)."""
    n = np.asarray(vol.shape[:3])
    p = np.clip(pts, 0.0, n - 1.0 - 1e-6)
    i0 = np.floor(p).astype(np.int64)
    f = (p - i0)[..., None]
    i1 = np.minimum(i0 + 1, n - 1)
    c = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = (i1 if dx else i0)[:, 0]
                iy = (i1 if dy else i0)[:, 1]
                iz = (i1 if dz else i0)[:, 2]
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                c = c + vol[ix, iy, iz] * w
    return c


def _load_vdb_grid(g: dict, resolve_path):
    """OpenVDB grid -> (density (padded), emission|None, w2g).

    Mirrors ref src/core/grids/VdbGrid.cpp loadResources (lines 173-265):
    density values scaled in place, medium-local frame built from either
    normalize_size (unit-box the active bbox: scale = 1/diag.max, center
    = minP*scale + (diag.x, 0, diag.z)*0.5) or the grid's own voxel
    spacing (scale = spacing.min, center = -indexToWorld(0)), emission
    resampled at density coords + emissionIndexOffset, scaled and
    optionally multiplied by density.  io/vdb.py densifies the sparse
    tree with a one-voxel zero pad, which also covers the reference's
    exact_linear one-voxel dilation."""
    from tungsten_tpu_torch.io.vdb import read_vdb

    grids = read_vdb(resolve_path(g["file"]))
    dname = g.get("density_name", g.get("grid_name", "density"))
    if dname not in grids:
        raise ValueError(f"vdb: no grid named '{dname}' in {g['file']} "
                         f"(has {list(grids)})")
    gd = grids[dname]
    dens = gd.values * float(g.get("density_scale", 1.0))

    # active-region bbox in the grid's own index space (strip the pad)
    min_p = gd.ijk_min + 1
    diag = np.asarray(dens.shape, np.float64) - 2.0
    spacing = np.abs(np.diag(gd.transform[:3, :3]))
    spacing = np.where(spacing <= 0, 1.0, spacing)
    d_center = gd.transform[3, :3]
    if g.get("normalize_size", True):
        scale = 1.0 / diag.max()
        center = min_p * scale + np.asarray(
            [diag[0] * scale, 0.0, diag[2] * scale]) * 0.5
    else:
        scale = spacing.min()
        center = -d_center

    emis = None
    ename = g.get("emission_name", "Cd")
    if ename in grids:
        ge = grids[ename]
        e_spacing = np.abs(np.diag(ge.transform[:3, :3]))
        e_spacing = np.where(e_spacing <= 0, 1.0, e_spacing)
        e_offset = (d_center - ge.transform[3, :3]) / e_spacing
        # resample emission onto the density brick lattice
        nx, ny, nz = dens.shape
        ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz), indexing="ij")
        ijk = np.stack([ii, jj, kk], -1).reshape(-1, 3) + gd.ijk_min
        pts = ijk + e_offset - ge.ijk_min
        emis = _host_trilinear(ge.values, pts).reshape(nx, ny, nz, 3)
        emis = emis.astype(np.float32) * float(g.get("emission_scale", 1.0))
        if g.get("scale_emission_by_density", True):
            emis = emis * dens[..., None]

    # w2g: world -> config-local -> vdb index -> padded brick coords
    m_cfg = xform.parse_transform(g.get("transform"))
    minv = np.linalg.inv(m_cfg)
    # index = (local + center) / scale;  brick = index - ijk_min
    a = minv[:3, :3] / scale
    b = (minv[:3, 3] + center) / scale - gd.ijk_min
    w2g = np.concatenate([a, b[:, None]], axis=1).astype(np.float32)
    return dens.astype(np.float32), emis, w2g


MED_KINDS = {"homogeneous": grid_mod.MED_HOMOGENEOUS,
             "exponential": grid_mod.MED_EXPONENTIAL,
             "voxel": grid_mod.MED_VOXEL,
             "atmosphere": grid_mod.MED_ATMOSPHERE}


def _trans_row(tr):
    """(type_id, 4 base params) for one non-interpolated law."""
    tt = tr.get("type", "exponential")
    tp = [0.0, 0.0, 0.0, 0.0]
    if tt in ("linear", "quadratic"):
        tp[0] = float(tr.get("max_t", 1.0 if tt == "linear" else 0.75))
    elif tt == "double_exponential":
        tp[0] = float(tr.get("sigma_a", 0.5))
        tp[1] = float(tr.get("sigma_b", 10.0))
    elif tt == "erlang":
        tp[0] = float(tr.get("rate", 5.0))
    elif tt == "davis":
        tp[0] = max(float(tr.get("alpha", 1.1)), 1.0 + 1e-6)
    elif tt == "davis_weinstein":
        tp[0] = min(max(float(tr.get("h", 0.75)), 0.5), 1.0)
        tp[1] = float(tr.get("c", 1.0))
    elif tt == "pulse":
        tp[0] = float(tr.get("min", 0.0))
        tp[1] = float(tr.get("max", 1.0))
        tp[2] = float(tr.get("num_pulses", 4))
    return trans_mod.NAMES.get(tt, 0), tp


def _flatten_media(desc: SceneDesc):
    """The media table (ref HomogeneousMedium::prepareForRender scales
    the material cross-sections by density; a transmittance law per
    medium; voxel media load their grid and its majorant supergrid).
    Returns (host arrays keyed by FlatScene field, RenderSettings
    fields)."""
    sig_a, sig_s, phase, g_, ttype, tparams, max_b = [], [], [], [], [], [], []
    kinds, grid_idx, exp_params = [], [], []
    dens_l, emis_l, w2g_l, super_l = [], [], [], []
    voxel_integration = voxel_sampling = "raymarching"
    for m in desc.media:
        mtype = m.get("type", "homogeneous")
        if mtype not in MED_KINDS:
            raise NotImplementedError(
                f"medium type not yet supported: {mtype}")
        kind = MED_KINDS[mtype]
        kinds.append(kind)
        # homogeneous/exponential/atmosphere scale the cross-sections by
        # the scalar density; voxel grids carry density spatially
        density = float(m.get("density", 1.0)) \
            if kind != grid_mod.MED_VOXEL else 1.0
        ep = [0.0] * 8
        if kind == grid_mod.MED_EXPONENTIAL:
            ep[0] = float(m.get("falloff_scale", 1.0))
            ep[1:4] = _vec3(m.get("unit_point", 0.0))
            fd = np.asarray(_vec3(m.get("falloff_direction", [0, 1, 0])),
                            np.float64)
            fd = fd / max(np.linalg.norm(fd), 1e-20)
            ep[4:7] = [float(x) for x in fd]
        if kind == grid_mod.MED_ATMOSPHERE:
            # ref AtmosphericMedium: effective scale = falloff / radius;
            # the center may bind to a named primitive's position
            radius = float(m.get("radius", 1.0))
            ep[0] = float(m.get("falloff_scale", 1.0)) / max(radius, 1e-9)
            center = m.get("center", [0.0, 0.0, 0.0])
            if "primitive" in m:
                for pr in desc.primitives:
                    if pr.get("name") == m["primitive"]:
                        pm = xform.parse_transform(pr.get("transform"))
                        center = xform.transform_point(
                            pm, [0.0, 0.0, 0.0]).tolist()
                        break
            ep[1:4] = _vec3(center)
            ep[4] = radius
        exp_params.append(ep)
        if kind == grid_mod.MED_VOXEL:
            # ref VdbGrid "integration_method" / "sampling_method"
            # (VdbGrid.cpp:41-63); unknown values keep raymarching
            im = str(m["grid"].get("integration_method", ""))
            if im in ("residual_ratio", "exact_linear", "exact_nearest"):
                voxel_integration = im
            sm = str(m["grid"].get("sampling_method", ""))
            if sm in ("exact_linear", "exact_nearest"):
                voxel_sampling = sm
            dens, emis, w2g = _load_grid(m["grid"], desc.resolve_path)
            grid_idx.append(len(dens_l))
            dens_l.append(dens)
            super_l.append(build_supergrid(dens))
            emis_l.append(emis if emis is not None
                          else np.zeros((0, 0, 0, 3), np.float32))
            w2g_l.append(w2g)
        else:
            grid_idx.append(-1)
        sig_a.append([density * x for x in _vec3(m.get("sigma_a"))])
        sig_s.append([density * x for x in _vec3(m.get("sigma_s"))])
        ph = m.get("phase_function", {"type": "isotropic"})
        if isinstance(ph, str):
            ph = {"type": ph}
        phase.append(phase_mod.NAMES.get(ph.get("type", "isotropic"), 0))
        g_.append(float(ph.get("g", 0.0)))
        tr = m.get("transmittance", {"type": "exponential"})
        if isinstance(tr, str):
            tr = {"type": tr}
        if tr.get("type") == "interpolated":
            # ref InterpolatedTransmittance: lerp(tr_a, tr_b, ratio);
            # defaults linear/erlang at ratio 0.5, the 16-column layout
            ta = tr.get("tr_a", {"type": "linear"})
            tb = tr.get("tr_b", {"type": "erlang"})
            ida, pa = _trans_row({"type": ta} if isinstance(ta, str) else ta)
            idb, pb = _trans_row({"type": tb} if isinstance(tb, str) else tb)
            ttype.append(trans_mod.T_INTERPOLATED)
            tparams.append([0.0] * 4 + [float(ida), float(idb),
                                        float(tr.get("ratio", 0.5)), 0.0]
                           + pa + pb)
        else:
            tid, tp = _trans_row(tr)
            ttype.append(tid)
            tparams.append(tp)
        max_b.append(int(m.get("max_bounces", 1024)))
    # widen every row to 16 cols iff any medium is interpolated
    if any(len(r) > 4 for r in tparams):
        tparams = [r + [0.0] * (16 - len(r)) for r in tparams]
    host = dict(
        med_sigma_a=np.asarray(sig_a, np.float32).reshape(-1, 3),
        med_sigma_s=np.asarray(sig_s, np.float32).reshape(-1, 3),
        med_phase=np.asarray(phase, np.int32),
        med_g=np.asarray(g_, np.float32),
        med_trans_type=np.asarray(ttype, np.int32),
        med_trans_params=(np.asarray(tparams, np.float32).reshape(
            len(ttype), -1) if ttype else np.zeros((0, 4), np.float32)),
        med_max_bounce=np.asarray(max_b, np.int32),
        med_kind=np.asarray(kinds, np.int32),
        med_grid=np.asarray(grid_idx, np.int32),
        med_exp_params=np.asarray(exp_params, np.float32).reshape(-1, 8),
        grid_density=tuple(dens_l), grid_super=tuple(super_l),
        grid_emission=tuple(emis_l),
        grid_w2g=np.asarray(w2g_l, np.float32).reshape(-1, 3, 4))
    kw = dict(has_media=len(kinds) > 0, med_kinds=tuple(sorted(set(kinds))),
              voxel_integration=voxel_integration,
              voxel_sampling=voxel_sampling)
    return host, kw


def flat_scene_from_numpy(flds: dict, device=None) -> FlatScene:
    """Build the port's FlatScene from a dict of numpy arrays keyed by
    FlatScene field name — e.g. the fields of a JAX FlatScene — so both
    packages render the very same scene, BSDF table, analytic primitives,
    caps, aperture table, curve tables and hair tables included.  Extra
    keys are ignored; `tri_fin` and the curve walk's packed rows
    (`crv_rows`, `cwbvh_rows`) are packed from their JAX-named fields when
    absent; `bitmaps` and the grid fields (TUPLE_FIELDS) are sequences
    of arrays."""
    dev = resolve_device(device)
    packed = ("tri_fin", "crv_rows", "cwbvh_rows")
    out = {}
    for f in fields(FlatScene):
        if f.name in packed and f.name not in flds:
            continue
        if f.name in TUPLE_FIELDS:
            out[f.name] = tuple(_to_tensor(b, dev) for b in flds[f.name])
        else:
            out[f.name] = _to_tensor(flds[f.name], dev)
    if "tri_fin" not in out:
        out["tri_fin"] = torch.cat([out["tri_v0"], out["tri_e1"],
                                    out["tri_e2"]], dim=1).contiguous()
    if "crv_rows" not in out or "cwbvh_rows" not in out:
        out["crv_rows"], out["cwbvh_rows"] = pack_curve_rows(out)
    return FlatScene(**out)


def _unsupported(what: str):
    return NotImplementedError(f"tungsten_tpu_torch: {what} is not ported "
                               f"yet")


def _expand_instances(primitives: list) -> list:
    """The primitive list with each `instances` entry expanded (ref
    Instance.cpp:16-93): every instance stamps one master primitive with
    the instance's rotation + translation (scale comes from the master's
    own transform, as in the reference), in the JAX package's order."""
    expanded = []
    for prim in primitives:
        if prim.get("type") != "instances":
            expanded.append(prim)
            continue
        masters = prim.get("masters", [])
        for inst in prim.get("instances", []):
            mid = int(inst.get("id", 0))
            if not 0 <= mid < len(masters):
                continue
            master = dict(masters[mid])
            mi = xform.parse_transform(master.get("transform"))
            it = xform.parse_transform(inst.get("transform"))
            # drop scale from the instance rotation (the reference keeps
            # only position + quaternion)
            R = it[:3, :3]
            R = R / np.maximum(np.linalg.norm(R, axis=0, keepdims=True),
                               1e-30)
            comp = np.eye(4)
            comp[:3, :3] = R @ mi[:3, :3]
            comp[:3, 3] = R @ mi[:3, 3] + it[:3, 3]
            master["transform"] = comp.reshape(-1).tolist()
            if master.get("bsdf_index") is None and \
                    prim.get("bsdf_index") is not None:
                master["bsdf_index"] = prim["bsdf_index"]
            expanded.append(master)
    return expanded


def flatten_scene(desc: SceneDesc, device=None
                  ) -> tuple[FlatScene, RenderSettings]:
    """SceneDesc -> (FlatScene on `device`, RenderSettings).  device None
    means CUDA (raises when CUDA is absent)."""
    dev = resolve_device(device)
    textures = TextureTableBuilder(desc.resolve_path)

    media_host, media_kw = _flatten_media(desc)
    integ = desc.integrator
    if integ.get("type", "path_tracer") not in PORTED_INTEGRATORS:
        raise _unsupported(f"integrator {integ.get('type')!r}")
    cam = desc.camera
    if cam.get("type", "pinhole") not in PORTED_CAMERAS:
        raise _unsupported(f"camera {cam.get('type')!r}")

    fiber_tables: list = []
    bsdf_rows = [bsdf_types.parse_bsdf_row(b, textures, fiber_tables)
                 for b in desc.bsdfs]
    if not bsdf_rows:
        bsdf_rows = [bsdf_types.parse_bsdf_row({"type": "lambert"}, textures,
                                               fiber_tables)]

    vec3 = _vec3
    geom = _GeomAccum()
    curve_segs = []  # per-curves-prim dicts of segment arrays
    spheres_c, spheres_r, spheres_p = [], [], []
    disks = dict(c=[], n=[], r=[], cos=[], prim=[])
    cyls = dict(pos=[], rot=[], r=[], hh=[], capped=[], prim=[])
    prim_bsdf, prim_emission_tex = [], []
    prim_int_med, prim_ext_med = [], []
    prim_power: dict[int, np.ndarray] = {}
    lights = []
    env_info = None
    caps = []
    points = []

    prim_id = -1
    for prim in _expand_instances(desc.primitives):
        ptype = prim.get("type", "mesh")
        if ptype not in PORTED_PRIMITIVES:
            raise _unsupported(f"primitive type {ptype!r}")
        m = xform.parse_transform(prim.get("transform"))
        prim_id += 1
        bidx = prim.get("bsdf_index")
        prim_bsdf.append(0 if bidx is None else bidx)
        im = prim.get("int_medium_index")
        em = prim.get("ext_medium_index")
        prim_int_med.append(-1 if im is None else int(im))
        prim_ext_med.append(-1 if em is None else int(em))

        emission = prim.get("emission")
        power = prim.get("power")
        etex = -1
        if emission is not None:
            etex = textures.add(emission)
        elif power is not None:
            # radiance filled in once the primitive's area is known
            etex = textures.add(1.0)
            prim_power[prim_id] = np.asarray(vec3(power), np.float64)
        prim_emission_tex.append(etex)

        samplable = bool(prim.get("sample", True))
        if ptype == "quad":
            verts, n = _quad_verts(m)
            normals = np.repeat(n[None], 4, axis=0)
            # winding chosen so cross(e1, e2) == Tungsten's quad normal
            tris = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
            geom.add_tris(verts, _UNIT_QUAD_UV, normals, tris, prim_id)
        elif ptype == "cube":
            verts, uvs, normals, tris = _cube_tris(m)
            geom.add_tris(verts, uvs, normals, tris, prim_id)
        elif ptype == "mesh":
            mesh = mesh_io.load_mesh(desc.resolve_path(prim["file"]))
            if bool(prim.get("recompute_normals", False)) or \
                    not np.any(mesh.normal):
                mesh.normal = mesh_io.compute_smooth_normals(mesh)
            pos = xform.transform_points(m, mesh.pos).astype(np.float32)
            if bool(prim.get("smooth", True)):
                nrm = xform.transform_normals(m, mesh.normal).astype(
                    np.float32)
                norms = np.linalg.norm(nrm, axis=1, keepdims=True)
                nrm = nrm / np.maximum(norms, 1e-30)
            else:
                nrm = np.zeros_like(pos)  # flat: zero shading normals -> Ng
            geom.add_tris(pos, mesh.uv, nrm, mesh.indices, prim_id)
        elif ptype == "disk":
            # analytic disk (ref Disk.cpp:315-327 prepareForRender: center
            # T*0, radius the larger xz scale of a unit disk, normal
            # T*(0,1,0); Disk.cpp:64-87 world-space plane test)
            center = xform.transform_point(m, [0, 0, 0])
            sv = xform.transform_vectors(m, [[1, 0, 0], [0, 0, 1]])
            r = float(max(np.linalg.norm(sv[0]), np.linalg.norm(sv[1])))
            n = xform.transform_normals(m, [[0, 1, 0]])[0]
            n = (n / max(np.linalg.norm(n), 1e-30)).astype(np.float32)
            disks["c"].append(np.asarray(center, np.float32))
            disks["n"].append(n)
            disks["r"].append(r)
            disks["cos"].append(np.cos(np.deg2rad(
                float(prim.get("cone_angle", 90.0)))))
            disks["prim"].append(prim_id)
            if etex >= 0 and samplable:
                lights.append({"type": LIGHT_DISK, "prim": prim_id,
                               "tex": etex, "slot": len(disks["r"]) - 1})
            if prim_id in prim_power:
                # powerToRadianceFactor = INV_PI / area (Disk.cpp:40-43)
                textures.const[etex] = (
                    prim_power.pop(prim_id)
                    / (np.pi * max(np.pi * r * r, 1e-20))).astype(np.float32)
        elif ptype == "sphere":
            center = xform.transform_point(m, [0, 0, 0])
            radius = float(np.linalg.norm(
                xform.transform_vectors(m, [[1, 0, 0]])[0]))
            spheres_c.append(center)
            spheres_r.append(radius)
            spheres_p.append(prim_id)
            if etex >= 0 and samplable:
                # cone-sampled sphere emitter (ref Sphere::sampleDirect)
                lights.append({"type": LIGHT_SPHERE, "prim": prim_id,
                               "tex": etex, "slot": len(spheres_r) - 1})
            if prim_id in prim_power:
                # powerToRadianceFactor = INV_PI / area, area = 4 pi r^2
                textures.const[etex] = (
                    prim_power.pop(prim_id)
                    / (4.0 * np.pi * np.pi * max(radius * radius, 1e-20))
                ).astype(np.float32)
        elif ptype == "cylinder":
            # analytic y-aligned cylinder (ref Cylinder.cpp:288-303: rot
            # = extractRotation, radius = 0.5 * the larger xz scale,
            # halfHeight = 0.5 * the y scale; Cylinder.cpp:56-109 local
            # cap and quadric tests)
            capped = bool(prim.get("capped", True))
            pos = np.asarray(xform.transform_point(m, [0, 0, 0]), np.float32)
            cols = xform.transform_vectors(
                m, [[1, 0, 0], [0, 1, 0], [0, 0, 1]])
            scale = np.linalg.norm(cols, axis=-1)
            rot = (np.asarray(cols).T
                   / np.maximum(scale[None, :], 1e-30)).astype(np.float32)
            r = float(0.5 * max(scale[0], scale[2]))
            hh = float(0.5 * scale[1])
            for k, v in (("pos", pos), ("rot", rot), ("r", r), ("hh", hh),
                         ("capped", capped), ("prim", prim_id)):
                cyls[k].append(v)
            area = (2.0 * np.pi * r * r if capped else 0.0) \
                + 2.0 * np.pi * r * 2.0 * hh
            if etex >= 0 and samplable:
                lights.append({"type": LIGHT_CYLINDER, "prim": prim_id,
                               "tex": etex, "slot": len(cyls["r"]) - 1})
            if prim_id in prim_power:
                textures.const[etex] = (
                    prim_power.pop(prim_id)
                    / (np.pi * max(area, 1e-20))).astype(np.float32)
        elif ptype == "infinite_sphere":
            if etex >= 0:
                rot = m[:3, :3].astype(np.float32)
                norm = np.linalg.norm(rot, axis=0, keepdims=True)
                env_info = {"prim": prim_id, "tex": etex,
                            "rot": rot / np.maximum(norm, 1e-30),
                            "samplable": samplable}
            continue
        elif ptype == "infinite_sphere_cap":
            # directional "sun" cap (ref InfiniteSphereCap.cpp): direction
            # the transform's up axis, radiance the emission or power *
            # INV_TWO_PI / (1 - cos(cap_angle))
            cap_d = xform.transform_vectors(m, [[0.0, 1.0, 0.0]])[0]
            cap_d = cap_d / max(np.linalg.norm(cap_d), 1e-30)
            cos_cap = float(np.cos(np.deg2rad(
                float(prim.get("cap_angle", 10.0)))))
            if power is not None:
                rad = np.asarray(vec3(power)) / (2.0 * np.pi) / \
                    max(1.0 - cos_cap, 1e-9)
            else:
                rad = np.asarray(vec3(emission if emission is not None
                                      else 1.0))
            caps.append({"prim": prim_id, "dir": cap_d, "cos": cos_cap,
                         "emission": rad.astype(np.float32),
                         "samplable": samplable})
            continue
        elif ptype == "curves":
            curve_segs.append(_flatten_curves(prim, m, desc.resolve_path,
                                              prim_id))
            # curves default to the hair BCSDF when no bsdf is given
            # (ref Curves::Curves() ctor)
            if prim.get("bsdf_index") is None:
                prim_bsdf[-1] = len(bsdf_rows)
                bsdf_rows.append(
                    bsdf_types.parse_bsdf_row({"type": "hair"}, textures,
                                              fiber_tables))
            continue
        elif ptype == "point":
            pos = xform.transform_point(m, [0, 0, 0])
            rad = np.asarray(vec3(emission if emission is not None
                                  else (power if power is not None else 1.0)))
            points.append({"prim": prim_id, "pos": pos.astype(np.float32),
                           "emission": rad.astype(np.float32)})
            continue
        else:  # skydome
            # a daylight dome baked to an env map (ref Skydome.cpp:292-317;
            # the sun direction is the transform's up axis)
            from tungsten_tpu_torch.scene.sky import generate_sky
            sun = xform.transform_vectors(m, [[0.0, 1.0, 0.0]])[0]
            sky_img = generate_sky(
                sun, turbidity=float(prim.get("turbidity", 3.0)),
                intensity=float(prim.get("intensity", 2.0)),
                temperature=float(prim.get("temperature", 5777.0)),
                gamma_scale=float(prim.get("gamma_scale", 1.0)))
            env_info = {"prim": prim_id, "tex": -1, "image": sky_img,
                        "rot": np.eye(3, dtype=np.float32),
                        "samplable": samplable}
            continue
        if etex >= 0 and samplable and ptype in ("quad", "cube", "mesh"):
            lights.append({"type": LIGHT_AREA, "prim": prim_id, "tex": etex})

    num_prims = prim_id + 1

    # ---- concatenate triangles ----
    if geom.count() > 0:
        cat = {k: np.concatenate(getattr(geom, k))
               for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1",
                         "uv2", "prim")}
    else:
        z3 = np.zeros((0, 3), np.float32)
        z2 = np.zeros((0, 2), np.float32)
        cat = dict(v0=z3, e1=z3, e2=z3, n0=z3, n1=z3, n2=z3, uv0=z2,
                   uv1=z2, uv2=z2, prim=np.zeros((0,), np.int32))

    # ---- BVH over triangles (host build), reorder tris to leaf order ----
    from tungsten_tpu_torch.scene.bvh import build_bvh
    v0 = cat["v0"]
    p_min = np.minimum(v0, np.minimum(v0 + cat["e1"], v0 + cat["e2"]))
    p_max = np.maximum(v0, np.maximum(v0 + cat["e1"], v0 + cat["e2"]))
    bvh = build_bvh(p_min, p_max)
    order = bvh.order if len(bvh.order) else np.zeros(0, np.int32)
    cat = {k: a[order] for k, a in cat.items()}
    tri_v0, tri_e1, tri_e2 = cat["v0"], cat["e1"], cat["e2"]
    tri_prim = cat["prim"]

    # ---- lights: surface lights in primitive order, the env, then the
    # samplable caps and the points ----
    n_env = 1 if env_info and env_info["samplable"] else 0
    L = len(lights) + n_env + sum(1 for c in caps if c["samplable"]) + \
        len(points)
    light_type = np.zeros(max(L, 1), np.int32)
    light_prim = np.full(max(L, 1), -1, np.int32)
    light_emission = np.zeros((max(L, 1), 3), np.float32)
    light_area = np.zeros(max(L, 1), np.float32)
    light_aux = np.zeros((max(L, 1), 4), np.float32)
    light_bsr = np.zeros((max(L, 1), 4), np.float32)
    light_lum = np.zeros(max(L, 1), np.float32)
    light_tri_off = np.zeros(max(L, 1), np.int32)
    light_tri_cnt = np.zeros(max(L, 1), np.int32)
    light_slot = np.full(max(L, 1), -1, np.int32)
    lt_prob_l, lt_alias_l, lt_tri_l = [], [], []
    prim_light = np.full(max(num_prims, 1), -1, np.int32)

    tri_cross = np.cross(tri_e1, tri_e2)
    tri_area = 0.5 * np.linalg.norm(tri_cross, axis=-1) if len(tri_v0) \
        else np.zeros(0)

    # power-specified emitters: radiance = power / (pi * area)
    for pid, power in prim_power.items():
        ids = np.nonzero(tri_prim == pid)[0]
        area = float(tri_area[ids].sum()) if len(ids) else 1.0
        textures.const[prim_emission_tex[pid]] = (
            power / (np.pi * max(area, 1e-20))).astype(np.float32)

    for li, light in enumerate(lights):
        if light["type"] != LIGHT_AREA:
            # analytic emitters: area and bounding sphere from their
            # primitive tables, no triangle alias rows
            slot = light["slot"]
            light_type[li] = light["type"]
            light_prim[li] = light["prim"]
            light_slot[li] = slot
            light_emission[li] = textures.const[light["tex"]]
            light_tri_off[li] = sum(len(x) for x in lt_tri_l)
            light_tri_cnt[li] = 0
            if light["type"] == LIGHT_SPHERE:
                r = spheres_r[slot]
                light_area[li] = 4.0 * np.pi * r * r
                light_bsr[li, :3] = spheres_c[slot]
                light_bsr[li, 3] = r
            elif light["type"] == LIGHT_DISK:
                r = disks["r"][slot]
                light_area[li] = np.pi * r * r
                light_bsr[li, :3] = disks["c"][slot]
                light_bsr[li, 3] = r
            else:
                r, hh = cyls["r"][slot], cyls["hh"][slot]
                light_area[li] = (2.0 * np.pi * r * r
                                  if cyls["capped"][slot] else 0.0) \
                    + 2.0 * np.pi * r * 2.0 * hh
                light_bsr[li, :3] = cyls["pos"][slot]
                light_bsr[li, 3] = np.sqrt(r * r + hh * hh)
            light_lum[li] = float(np.max(textures.const[light["tex"]]))
            prim_light[light["prim"]] = li
            continue
        ids = np.nonzero(tri_prim == light["prim"])[0]
        areas = tri_area[ids]
        total = float(areas.sum())
        light_type[li] = LIGHT_AREA
        light_prim[li] = light["prim"]
        light_emission[li] = textures.const[light["tex"]]
        prob, alias = _build_alias(areas / max(total, 1e-30))
        light_tri_off[li] = sum(len(x) for x in lt_tri_l)
        light_tri_cnt[li] = len(ids)
        lt_prob_l.append(prob)
        lt_alias_l.append(alias)
        lt_tri_l.append(ids.astype(np.int32))
        light_area[li] = total
        if len(ids):
            lv0 = tri_v0[ids]
            pts = np.concatenate([lv0, lv0 + tri_e1[ids], lv0 + tri_e2[ids]])
            c = 0.5 * (pts.min(0) + pts.max(0))
            light_bsr[li, :3] = c
            light_bsr[li, 3] = np.linalg.norm(pts - c, axis=-1).max()
        light_lum[li] = float(np.max(textures.const[light["tex"]]))
        prim_light[light["prim"]] = li

    env_light_index = -1
    env_image = np.zeros((1, 1, 3), np.float32)
    env_rot = np.eye(3, dtype=np.float32)
    env_scale = 1.0
    if env_info is not None:
        tex_id = env_info["tex"]
        if env_info.get("image") is not None:
            env_image = env_info["image"]
        elif textures.bitmap_id[tex_id] >= 0:
            env_image = np.asarray(
                textures.bitmaps[textures.bitmap_id[tex_id]], np.float32)
        else:
            env_image = np.broadcast_to(textures.const[tex_id][None, None],
                                        (1, 1, 3)).astype(np.float32)
        env_rot = env_info["rot"]
        if env_info["samplable"]:
            li = len(lights)
            env_light_index = li
            light_type[li] = LIGHT_INFINITE
            light_prim[li] = env_info["prim"]
            prim_light[env_info["prim"]] = li
            # ref InfiniteSphere::approximateRadiance = TWO_PI * avg().max()
            light_lum[li] = 2.0 * np.pi * float(
                np.max(env_image.reshape(-1, 3).mean(axis=0)) * env_scale)
    (cond_pdf, cond_cdf, marg_pdf, marg_cdf,
     env_alias) = _build_env_distribution(env_image)

    # ---- cap and point lights ----
    li_next = len(lights) + n_env
    nc = max(len(caps), 1)
    cap_dir = np.zeros((nc, 3), np.float32)
    cap_cos = np.full(nc, 2.0, np.float32)   # 2: no direction is inside
    cap_em = np.zeros((nc, 3), np.float32)
    cap_samp = np.zeros(nc, bool)
    for ci, cap in enumerate(caps):
        cap_dir[ci] = cap["dir"]
        cap_cos[ci] = cap["cos"]
        cap_em[ci] = cap["emission"]
        cap_samp[ci] = cap["samplable"]
        if cap["samplable"]:
            li = li_next
            li_next += 1
            light_type[li] = LIGHT_CAP
            light_prim[li] = cap["prim"]
            light_emission[li] = cap["emission"]
            light_aux[li, :3] = cap["dir"]
            light_aux[li, 3] = cap["cos"]
            # ref InfiniteSphereCap::approximateRadiance
            light_lum[li] = 2.0 * np.pi * (1.0 - cap["cos"]) * \
                float(np.max(cap["emission"]))
            prim_light[cap["prim"]] = li
    for pt in points:
        li = li_next
        li_next += 1
        light_type[li] = LIGHT_POINT
        light_prim[li] = pt["prim"]
        light_emission[li] = pt["emission"]
        light_aux[li, :3] = pt["pos"]
        # the selection weight divides by r^2 at the shading point
        # (lights.py::_choose_light_weights)
        light_lum[li] = float(np.max(pt["emission"]))
        prim_light[pt["prim"]] = li

    # ---- camera ----
    cam_mat = xform.parse_transform(cam.get("transform"))
    cam_mat[:3, 0] = -cam_mat[:3, 0]  # ref Camera::fromJson flips right axis
    cam_mat = cam_mat.astype(np.float32)
    res = cam.get("resolution", [512, 512])
    if isinstance(res, (int, float)):
        res = [res, res]
    fov = float(cam.get("fov", 60.0))
    plane_dist = 1.0 / np.tan(np.deg2rad(fov) * 0.5)
    ratio = res[1] / res[0]
    # thinlens focus pivot (ref ThinlensCamera::prepareForRender): the
    # distance from the camera to the named primitive's origin
    focus_distance = float(cam.get("focus_distance", 1.0))
    pivot = cam.get("focus_pivot")
    if pivot:
        for prim in desc.primitives:
            if prim.get("name") == pivot:
                pm = xform.parse_transform(prim.get("transform"))
                focus_distance = float(np.linalg.norm(
                    pm[:3, 3] - cam_mat[:3, 3]))
                break
    cam_ap_prob, cam_ap_alias, cam_ap_hw, aperture_tex = _aperture(
        cam.get("aperture"), desc.resolve_path)

    rend = desc.renderer
    settings = RenderSettings(
        width=int(res[0]),
        height=int(res[1]),
        spp=int(rend.get("spp", 32)),
        spp_step=int(rend.get("spp_step", 16)),
        stratified_sampler=bool(rend.get("stratified_sampler", True)),
        adaptive_sampling=bool(rend.get("adaptive_sampling", True)),
        max_bounces=int(integ.get("max_bounces", 64)),
        min_bounces=int(integ.get("min_bounces", 0)),
        enable_light_sampling=bool(integ.get("enable_light_sampling", True)),
        enable_volume_light_sampling=bool(
            integ.get("enable_volume_light_sampling", True)),
        two_sided_shading=bool(integ.get("enable_two_sided_shading", True)),
        tonemap=cam.get("tonemap", "gamma"),
        filter=cam.get("reconstruction_filter", "tent"),
        camera_type=cam.get("type", "pinhole"),
        cubemap_mode=cam.get("mode", "horizontal_cross"),
        fov_deg=fov,
        focus_distance=focus_distance,
        aperture_size=float(cam.get("aperture_size", 0.001)),
        aperture_tex=aperture_tex,
        cat_eye=float(cam.get("cateye", cam.get("cat_eye", 0.0))),
        has_env=env_info is not None,
        has_curves=any(c is not None for c in curve_segs),
        curve_modes=tuple(sorted(set(
            int(v) for c in curve_segs if c is not None
            for v in np.unique(c["mode"])))),
        num_lights=int(L),
        present_bsdf_types=tuple(sorted({int(r[0]) for r in bsdf_rows})),
        num_caps=len(caps),
        has_points=len(points) > 0,
        has_disk_lights=any(lt["type"] == LIGHT_DISK for lt in lights),
        has_cyl_lights=any(lt["type"] == LIGHT_CYLINDER for lt in lights),
        has_sphere_lights=any(lt["type"] == LIGHT_SPHERE for lt in lights),
        has_area_lights=any(lt["type"] == LIGHT_AREA for lt in lights),
        integrator_type=integ.get("type", "path_tracer"),
        photon_count=int(integ.get("photon_count", 1 << 20)),
        gather_radius=float(integ.get("gather_radius", 0.05)),
        gather_count=int(integ.get("gather_photon_count", 20)),
        vol_photon_type=str(integ.get("volume_photon_type", "points")),
        vol_photon_count=int(integ.get("volume_photon_count", 10000)),
        vol_gather_radius=float(
            integ.get("volume_gather_radius",
                      integ.get("gather_radius", 0.05))),
        ppm_alpha=float(integ.get("alpha", 0.3)),
        mlt_large_step_prob=float(integ.get("large_step_probability", 0.1)),
        mlt_sample_pool=int(integ.get("initial_sample_pool", 10000)),
        mlt_strategy_prob=float(
            integ.get("strategy_perturbation_probability", 0.05)),
        mlt_bidirectional=bool(integ.get("bidirectional", True)),
        **media_kw,
    )

    tex_type, tex_const, tex_params, tex_bitmap_id, bitmaps = \
        textures.finalize()

    from tungsten_tpu_torch.ops.wave_trace import build_wave_tables
    wk_boxes, wk_cbox, wk_attr, wk_remap, wk_sbox = build_wave_tables(
        tri_v0, tri_e1, tri_e2)

    tri_shade = np.concatenate(
        [tri_e1, tri_e2, cat["n0"], cat["n1"], cat["n2"], cat["uv0"],
         cat["uv1"], cat["uv2"]], axis=1) if len(tri_v0) else \
        np.zeros((0, 21), np.float32)
    tri_fin = np.concatenate([tri_v0, tri_e1, tri_e2], axis=1) \
        if len(tri_v0) else np.zeros((0, 9), np.float32)

    # scene-wide occluder bounds: the triangles, the analytic prims and
    # the curve pieces padded by the widest piece
    los, his = [], []
    if len(tri_v0):
        los.append(p_min.min(0))
        his.append(p_max.max(0))
    if spheres_c:
        sc = np.asarray(spheres_c, np.float32)
        sr = np.asarray(spheres_r, np.float32)[:, None]
        los.append((sc - sr).min(0))
        his.append((sc + sr).max(0))
    if disks["c"]:
        dc = np.asarray(disks["c"], np.float32)
        dr = np.asarray(disks["r"], np.float32)[:, None]
        los.append((dc - dr).min(0))
        his.append((dc + dr).max(0))
    if cyls["pos"]:
        cp = np.asarray(cyls["pos"], np.float32)
        cr = np.sqrt(np.asarray(cyls["r"], np.float32) ** 2
                     + np.asarray(cyls["hh"], np.float32) ** 2)[:, None]
        los.append((cp - cr).min(0))
        his.append((cp + cr).max(0))
    curve_tables = _build_curve_tables(curve_segs)
    if curve_tables["crv_pc_q0"].shape[0] > 0:
        q = np.concatenate([curve_tables["crv_pc_q0"][:, :3],
                            curve_tables["crv_pc_q1"][:, :3]])
        w_c = np.concatenate([curve_tables["crv_pc_q0"][:, 3],
                              curve_tables["crv_pc_q1"][:, 3]]).max()
        los.append(q.min(0) - w_c)
        his.append(q.max(0) + w_c)
    geo_lo = (np.min(los, axis=0) if los else np.zeros(3)).astype(np.float32)
    geo_hi = (np.max(his, axis=0) if his else np.zeros(3)).astype(np.float32)
    host = dict(
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2, tri_shade=tri_shade,
        tri_n0=cat["n0"], tri_n1=cat["n1"], tri_n2=cat["n2"],
        tri_uv0=cat["uv0"], tri_uv1=cat["uv1"], tri_uv2=cat["uv2"],
        tri_prim=tri_prim, tri_fin=tri_fin,
        bvh_min=bvh.bounds_min, bvh_max=bvh.bounds_max,
        bvh_meta=bvh.meta, bvh_skip=bvh.skip,
        wk_boxes=wk_boxes, wk_cbox=wk_cbox, wk_attr=wk_attr,
        wk_remap=wk_remap, wk_sbox=wk_sbox,
        sph_center=np.asarray(spheres_c, np.float32).reshape(-1, 3),
        sph_radius=np.asarray(spheres_r, np.float32),
        sph_prim=np.asarray(spheres_p, np.int32),
        dsk_c=np.asarray(disks["c"], np.float32).reshape(-1, 3),
        dsk_n=np.asarray(disks["n"], np.float32).reshape(-1, 3),
        dsk_r=np.asarray(disks["r"], np.float32),
        dsk_cos=np.asarray(disks["cos"], np.float32),
        dsk_prim=np.asarray(disks["prim"], np.int32),
        cyl_pos=np.asarray(cyls["pos"], np.float32).reshape(-1, 3),
        cyl_rot=np.asarray(cyls["rot"], np.float32).reshape(-1, 3, 3),
        cyl_r=np.asarray(cyls["r"], np.float32),
        cyl_hh=np.asarray(cyls["hh"], np.float32),
        cyl_capped=np.asarray(cyls["capped"], bool),
        cyl_prim=np.asarray(cyls["prim"], np.int32),
        **curve_tables,
        **_stack_hair_tables(fiber_tables),
        prim_bsdf=np.asarray(prim_bsdf, np.int32),
        prim_emission_tex=np.asarray(prim_emission_tex, np.int32),
        prim_light=prim_light,
        bsdf_type=np.asarray([r[0] for r in bsdf_rows], np.int32),
        bsdf_albedo_tex=np.asarray([r[1] for r in bsdf_rows], np.int32),
        bsdf_params=np.stack([r[2] for r in bsdf_rows]),
        bsdf_aux=np.stack([r[3] for r in bsdf_rows]),
        tex_type=tex_type, tex_const=tex_const, tex_params=tex_params,
        tex_bitmap_id=tex_bitmap_id, bitmaps=bitmaps,
        light_type=light_type, light_prim=light_prim, light_slot=light_slot,
        light_emission=light_emission, light_area=light_area,
        light_aux=light_aux, light_bsr=light_bsr, light_lum=light_lum,
        lt_prob=(np.concatenate(lt_prob_l).astype(np.float32)
                 if lt_prob_l else np.zeros(1, np.float32)),
        lt_alias=(np.concatenate(lt_alias_l).astype(np.int32)
                  if lt_alias_l else np.zeros(1, np.int32)),
        lt_tri=(np.concatenate(lt_tri_l).astype(np.int32)
                if lt_tri_l else np.zeros(1, np.int32)),
        lt_slot=_lt_slot_of_tri(lt_tri_l, len(tri_v0)),
        light_tri_off=light_tri_off, light_tri_cnt=light_tri_cnt,
        geo_lo=geo_lo, geo_hi=geo_hi,
        cap_dir=cap_dir, cap_cos=cap_cos, cap_emission=cap_em,
        cap_samplable=cap_samp,
        **media_host,
        prim_int_medium=np.asarray(prim_int_med, np.int32),
        prim_ext_medium=np.asarray(prim_ext_med, np.int32),
        cam_medium=np.int32(cam.get("medium_index")
                            if cam.get("medium_index") is not None else -1),
        env_image=env_image, env_quad=_build_env_quad(env_image),
        env_cond_pdf=cond_pdf, env_cond_cdf=cond_cdf,
        env_marg_pdf=marg_pdf, env_marg_cdf=marg_cdf, env_alias=env_alias,
        env_pdf_tab=np.ascontiguousarray(env_alias[:, 2]),
        env_to_world=env_rot, env_to_local=env_rot.T,
        env_light_index=np.int32(env_light_index),
        env_emission_scale=np.float32(env_scale),
        cam_mat=cam_mat, cam_plane_dist=np.float32(plane_dist),
        cam_ap_prob=cam_ap_prob.astype(np.float32),
        cam_ap_alias=cam_ap_alias.astype(np.int32), cam_ap_hw=cam_ap_hw,
        cam_ratio=np.float32(ratio),
    )
    flat = flat_scene_from_numpy(host, dev)
    # bf16 halves the env tables' random-gather working set (as in the
    # JAX package); rounded to nearest even like its conversion
    flat.env_image = flat.env_image.to(torch.bfloat16)
    flat.env_quad = flat.env_quad.to(torch.bfloat16)
    return flat, settings


def _aperture(spec, resolve_path):
    """A thinlens aperture bitmap (ref ThinlensCamera `_aperture`, sampled
    MAP_UNIFORM) -> (alias keep-probability, alias, (H, W), present): an
    alias table over the texels' mean channel.  No bitmap (or an all-dark
    one) keeps the analytic uniform disk."""
    prob = np.zeros((1,), np.float32)
    alias = np.zeros((1,), np.int32)
    hw = np.asarray([1, 1], np.int32)
    if isinstance(spec, str) or (isinstance(spec, dict)
                                 and spec.get("type") == "bitmap"):
        from tungsten_tpu_torch.io import image as image_io
        path = spec if isinstance(spec, str) else spec["file"]
        img = np.asarray(image_io.load_image(resolve_path(path)), np.float32)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        lum = np.maximum(img.reshape(-1), 0.0)
        if lum.sum() > 0:
            prob, alias = _build_alias(lum / lum.sum())
            return prob, alias, np.asarray(img.shape, np.int32), True
    return prob, alias, hw, False


def load_flat_scene(path, device=None):
    """Convenience: path -> (FlatScene, RenderSettings)."""
    from tungsten_tpu_torch.scene.parse import load_scene
    return flatten_scene(load_scene(path), device)
