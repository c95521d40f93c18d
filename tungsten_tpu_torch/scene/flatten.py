"""SceneDesc -> FlatScene: the tensor scene representation (port of
tungsten_tpu/scene/flatten.py).

All finite geometry is gathered into one triangle SoA with a host-built
SAH BVH and the wave kernels' cluster tables; BSDFs are parameter-table
rows; emissive primitives form a light table with alias tables; an
equirect env map carries its importance-sampling tables.  FlatScene is
a dataclass of tensors on one device.

The port flattens what the path-tracer main path renders: quad, cube,
mesh and infinite_sphere (env map) primitives, the surface BSDFs of
bsdf/types.py::PORTED_TYPES (nested children are table rows of their
own, so present_bsdf_types lists them), area lights and the env light,
pinhole cameras, the path_tracer integrator.  Anything else raises
NotImplementedError naming it.  The numbers are the JAX package's: the
same host numpy code builds every table, so every field is equal to the
JAX build (bf16 fields included).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from tungsten_tpu_torch.bsdf import types as bsdf_types
from tungsten_tpu_torch.device import resolve_device
from tungsten_tpu_torch.io import mesh as mesh_io
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

PORTED_PRIMITIVES = ("quad", "cube", "mesh", "infinite_sphere")


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
    # --- analytic primitives (always empty in the port) ---
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
    cam_ratio: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device) -> "FlatScene":
        """The same scene with every tensor on `device`."""
        dev = torch.device(device)
        return FlatScene(**{
            f.name: (tuple(b.to(dev) for b in v) if f.name == "bitmaps"
                     else v.to(dev))
            for f in fields(self) for v in (getattr(self, f.name),)})


@dataclass(frozen=True)
class RenderSettings:
    """Static render configuration (hashable)."""
    width: int
    height: int
    spp: int = 16
    max_bounces: int = 64
    min_bounces: int = 0
    enable_light_sampling: bool = True
    two_sided_shading: bool = True
    seed: int = 0xBA5EBA11
    tonemap: str = "gamma"
    filter: str = "tent"
    camera_type: str = "pinhole"
    fov_deg: float = 60.0
    spp_step: int = 16
    stratified_sampler: bool = False  # scrambled Sobol' vs pcg4d hash
    adaptive_sampling: bool = False
    has_env: bool = False
    num_lights: int = 0
    present_bsdf_types: tuple = ()
    has_media: bool = False
    num_caps: int = 0
    has_points: bool = False
    has_disk_lights: bool = False
    has_cyl_lights: bool = False
    has_sphere_lights: bool = False
    has_area_lights: bool = True
    integrator_type: str = "path_tracer"
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


def flat_scene_from_numpy(flds: dict, device=None) -> FlatScene:
    """Build the port's FlatScene from a dict of numpy arrays keyed by
    FlatScene field name — e.g. the fields of a JAX FlatScene — so both
    packages render the very same scene, BSDF table included.  Extra keys
    are ignored, but a scene with curves, media, analytic primitives or
    fiber BSDFs (which the port's shading does not handle yet) raises
    NotImplementedError; `tri_fin` is packed from tri_v0/e1/e2 when
    absent; `bitmaps` is a sequence of (H, W, 3) arrays."""
    dev = resolve_device(device)
    fiber = {bsdf_types.HAIR, bsdf_types.ROUGH_WIRE,
             bsdf_types.LAMBERTIAN_FIBER}
    if fiber & {int(t) for t in np.asarray(flds["bsdf_type"]).ravel()}:
        raise _unsupported("fiber BSDFs")
    for key, what in (("crv_seg_p0", "curves"),
                      ("med_sigma_a", "participating media"),
                      ("sph_radius", "analytic spheres"),
                      ("dsk_r", "analytic disks"),
                      ("cyl_r", "analytic cylinders")):
        if key in flds and np.asarray(flds[key]).shape[0] > 0:
            raise _unsupported(what)
    out = {}
    for f in fields(FlatScene):
        if f.name == "tri_fin" and f.name not in flds:
            continue
        if f.name == "bitmaps":
            out[f.name] = tuple(_to_tensor(b, dev) for b in flds["bitmaps"])
        else:
            out[f.name] = _to_tensor(flds[f.name], dev)
    if "tri_fin" not in out:
        out["tri_fin"] = torch.cat([out["tri_v0"], out["tri_e1"],
                                    out["tri_e2"]], dim=1).contiguous()
    return FlatScene(**out)


def _unsupported(what: str):
    return NotImplementedError(f"tungsten_tpu_torch: {what} is not ported "
                               f"yet")


def flatten_scene(desc: SceneDesc, device=None
                  ) -> tuple[FlatScene, RenderSettings]:
    """SceneDesc -> (FlatScene on `device`, RenderSettings).  device None
    means CUDA (raises when CUDA is absent)."""
    dev = resolve_device(device)
    textures = TextureTableBuilder(desc.resolve_path)

    if desc.media:
        raise _unsupported("participating media")
    integ = desc.integrator
    if integ.get("type", "path_tracer") != "path_tracer":
        raise _unsupported(f"integrator {integ.get('type')!r}")
    cam = desc.camera
    if cam.get("type", "pinhole") != "pinhole":
        raise _unsupported(f"camera {cam.get('type')!r}")

    bsdf_rows = [bsdf_types.parse_bsdf_row(b, textures) for b in desc.bsdfs]
    if not bsdf_rows:
        bsdf_rows = [bsdf_types.parse_bsdf_row({"type": "lambert"}, textures)]

    def vec3(v, default=0.0):
        if v is None:
            v = default
        if isinstance(v, (int, float)):
            return [float(v)] * 3
        return [float(x) for x in v]

    geom = _GeomAccum()
    prim_bsdf, prim_emission_tex = [], []
    prim_power: dict[int, np.ndarray] = {}
    lights = []
    light_tri_ranges = []
    env_info = None

    prim_id = -1
    for prim in desc.primitives:
        ptype = prim.get("type", "mesh")
        if ptype not in PORTED_PRIMITIVES:
            raise _unsupported(f"primitive type {ptype!r}")
        if prim.get("int_medium_index") is not None or \
                prim.get("ext_medium_index") is not None:
            raise _unsupported("participating media")
        m = xform.parse_transform(prim.get("transform"))
        prim_id += 1
        bidx = prim.get("bsdf_index")
        prim_bsdf.append(0 if bidx is None else bidx)

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
        tri_start = geom.count()
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
        else:  # infinite_sphere
            if etex >= 0:
                rot = m[:3, :3].astype(np.float32)
                norm = np.linalg.norm(rot, axis=0, keepdims=True)
                env_info = {"prim": prim_id, "tex": etex,
                            "rot": rot / np.maximum(norm, 1e-30),
                            "samplable": samplable}
            continue
        if etex >= 0 and samplable:
            lights.append({"type": LIGHT_AREA, "prim": prim_id, "tex": etex})
            light_tri_ranges.append((tri_start, geom.count()))

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

    # ---- lights ----
    L = len(lights) + (1 if env_info and env_info["samplable"] else 0)
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
        bid = textures.bitmap_id[tex_id]
        if bid >= 0:
            env_image = np.asarray(textures.bitmaps[bid], np.float32)
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
        two_sided_shading=bool(integ.get("enable_two_sided_shading", True)),
        tonemap=cam.get("tonemap", "gamma"),
        filter=cam.get("reconstruction_filter", "tent"),
        camera_type=cam.get("type", "pinhole"),
        fov_deg=fov,
        has_env=env_info is not None,
        num_lights=int(L),
        present_bsdf_types=tuple(sorted({int(r[0]) for r in bsdf_rows})),
        has_area_lights=len(lights) > 0,
        integrator_type=integ.get("type", "path_tracer"),
    )
    if settings.filter not in ("tent", "box", "dirac"):
        raise _unsupported(f"reconstruction filter {settings.filter!r}")

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

    if len(tri_v0):
        geo_lo = p_min.min(0).astype(np.float32)
        geo_hi = p_max.max(0).astype(np.float32)
    else:
        geo_lo = geo_hi = np.zeros(3, np.float32)

    z3 = np.zeros((0, 3), np.float32)
    zf = np.zeros((0,), np.float32)
    zi = np.zeros((0,), np.int32)
    host = dict(
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2, tri_shade=tri_shade,
        tri_n0=cat["n0"], tri_n1=cat["n1"], tri_n2=cat["n2"],
        tri_uv0=cat["uv0"], tri_uv1=cat["uv1"], tri_uv2=cat["uv2"],
        tri_prim=tri_prim, tri_fin=tri_fin,
        bvh_min=bvh.bounds_min, bvh_max=bvh.bounds_max,
        bvh_meta=bvh.meta, bvh_skip=bvh.skip,
        wk_boxes=wk_boxes, wk_cbox=wk_cbox, wk_attr=wk_attr,
        wk_remap=wk_remap, wk_sbox=wk_sbox,
        sph_center=z3, sph_radius=zf, sph_prim=zi,
        dsk_c=z3, dsk_n=z3, dsk_r=zf, dsk_cos=zf, dsk_prim=zi,
        cyl_pos=z3, cyl_rot=np.zeros((0, 3, 3), np.float32), cyl_r=zf,
        cyl_hh=zf, cyl_capped=np.zeros((0,), bool), cyl_prim=zi,
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
        env_image=env_image, env_quad=_build_env_quad(env_image),
        env_cond_pdf=cond_pdf, env_cond_cdf=cond_cdf,
        env_marg_pdf=marg_pdf, env_marg_cdf=marg_cdf, env_alias=env_alias,
        env_pdf_tab=np.ascontiguousarray(env_alias[:, 2]),
        env_to_world=env_rot, env_to_local=env_rot.T,
        env_light_index=np.int32(env_light_index),
        env_emission_scale=np.float32(env_scale),
        cam_mat=cam_mat, cam_plane_dist=np.float32(plane_dist),
        cam_ratio=np.float32(ratio),
    )
    flat = flat_scene_from_numpy(host, dev)
    # bf16 halves the env tables' random-gather working set (as in the
    # JAX package); rounded to nearest even like its conversion
    flat.env_image = flat.env_image.to(torch.bfloat16)
    flat.env_quad = flat.env_quad.to(torch.bfloat16)
    return flat, settings


def load_flat_scene(path, device=None):
    """Convenience: path -> (FlatScene, RenderSettings)."""
    from tungsten_tpu_torch.scene.parse import load_scene
    return flatten_scene(load_scene(path), device)
