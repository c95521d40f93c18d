"""Light sampling (port of tungsten_tpu/integrators/lights.py): area
lights (triangle sets with alias tables), the infinite-sphere
environment light, the analytic sphere, disk and cylinder emitters,
infinite sphere caps and point lights.

Parity targets: Quad/TriangleMesh::sampleDirect (uniform-by-area point,
solid-angle pdf r^2/(cos * area)), InfiniteSphere::sampleDirect/
directPdf (pdf INV_PI*INV_TWO_PI*texPdf/sinTheta), equirect mapping
u = atan2(z,x)/2pi + 0.5, v = acos(-y)/pi; Sphere::sampleDirect (cone
sampling), Disk::sampleDirect, Cylinder::samplePosition/sampleDirect,
InfiniteSphereCap::sampleDirect.
"""
from __future__ import annotations

import math

import torch

from tungsten_tpu_torch.ops.segment_sum import ordered_cumsum
from tungsten_tpu_torch.scene.flatten import (
    LIGHT_AREA, LIGHT_CYLINDER, LIGHT_DISK, LIGHT_POINT, LIGHT_SPHERE)
from tungsten_tpu_torch.scene.textures import sample_bitmap_quad
from tungsten_tpu_torch.utils.vecmath import (INV_FOUR_PI, INV_PI,
                                              INV_TWO_PI, clip, ortho_frame,
                                              take, to_global)

INF = 3.0e38


# ----------------------------------------------------------------- envmap

def env_direction_to_uv(scene, d):
    """World direction -> equirect uv (+ sinTheta)."""
    local = d @ scene.env_to_local.T
    u = torch.atan2(local[..., 2], local[..., 0]) * INV_TWO_PI + 0.5
    cos_t = torch.clamp(-local[..., 1], -1.0, 1.0)
    v = torch.acos(cos_t) * INV_PI
    sin_t = torch.sqrt(torch.clamp(1.0 - local[..., 1] ** 2, min=0.0))
    return torch.stack([u, v], dim=-1), sin_t


def env_uv_to_direction(scene, uv):
    phi = (uv[..., 0] - 0.5) * (2.0 * math.pi)
    theta = uv[..., 1] * math.pi
    sin_t = torch.sin(theta)
    local = torch.stack([torch.cos(phi) * sin_t, -torch.cos(theta),
                         torch.sin(phi) * sin_t], dim=-1)
    return local @ scene.env_to_world.T, sin_t


def env_eval(scene, d, active=None):
    """Environment radiance for escaping rays; lanes with `active` False
    tap row 0 of the bilinear table."""
    h, w = scene.env_cond_pdf.shape
    uv, _ = env_direction_to_uv(scene, d)
    return sample_bitmap_quad(scene.env_quad, h, w, uv, active) * \
        scene.env_emission_scale


def env_pdf(scene, d, active=None):
    """Solid-angle pdf of env importance sampling for direction d."""
    h, w = scene.env_cond_pdf.shape
    uv, sin_t = env_direction_to_uv(scene, d)
    row = torch.clamp(((1.0 - uv[..., 1]) * h).to(torch.int32), 0, h - 1)
    col = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    idx = row * w + col
    if active is not None:
        idx = torch.where(active, idx, 0)
    tex_pdf = scene.env_pdf_tab[idx.long()]
    return torch.where(
        sin_t > 1e-8,
        INV_PI * INV_TWO_PI * tex_pdf / torch.clamp(sin_t, min=1e-8), 0.0)


def env_sample(scene, u1, u2, active=None):
    """Importance-sample the envmap through the texel alias table;
    returns (d, radiance, pdf)."""
    h, w = scene.env_cond_pdf.shape
    n = h * w
    x = u2 * n
    idx = torch.clamp(x.to(torch.int32), max=n - 1)
    f = x - idx
    if active is not None:
        idx = torch.where(active, idx, 0)
    cell = scene.env_alias[idx.long()]                   # (R, 4) one gather
    keep = f < cell[..., 0]
    texel = torch.where(keep, idx, cell[..., 1].to(torch.int32))
    # recycle the comparison residual as the in-texel row offset
    ry = torch.where(keep,
                     f / torch.clamp(cell[..., 0], min=1e-20),
                     (f - cell[..., 0]) / torch.clamp(1.0 - cell[..., 0],
                                                      min=1e-20))
    ry = torch.clamp(ry, 1e-4, 1.0 - 1e-4)
    row = torch.div(texel, w, rounding_mode="floor")
    col = texel - row * w
    uv = torch.stack([(col + u1) / w, 1.0 - (row + ry) / h], dim=-1)
    d, sin_t = env_uv_to_direction(scene, uv)
    tex_pdf = torch.where(keep, cell[..., 2], cell[..., 3])
    pdf = torch.where(
        sin_t > 1e-8,
        INV_PI * INV_TWO_PI * tex_pdf / torch.clamp(sin_t, min=1e-8), 0.0)
    radiance = sample_bitmap_quad(scene.env_quad, h, w, uv, active) * \
        scene.env_emission_scale
    return d, radiance, pdf


# -------------------------------------------------------------- area light

def alias_pick_tri(scene, light_idx, u):
    """O(1) area-proportional triangle pick from light `light_idx`'s
    alias table.  Lanes whose light has no triangles (an analytic, cap
    or point light after the area lights) read clamped rows, as the JAX
    package's gathers clamp; their pick is discarded."""
    off = scene.light_tri_off[light_idx]
    cnt = torch.clamp(scene.light_tri_cnt[light_idx], min=1)
    x = u * cnt
    k = torch.minimum(x.to(torch.int32), cnt - 1)
    f = x - k
    last = scene.lt_prob.shape[0] - 1
    j = torch.clamp(off + k, max=last).long()
    keep = f < scene.lt_prob[j]
    slot = torch.where(keep, j, torch.clamp(off + scene.lt_alias[j],
                                            max=last).long())
    return scene.lt_tri[slot]


def _choose_light_weights(scene, settings, p):
    """Per-light selection weights at shading points p (R,3) and their
    row totals: surface lights weigh their bounding sphere's solid angle
    times their luminance, point lights INV_FOUR_PI * luminance / r^2,
    the env and caps their baked luminance."""
    nl = settings.num_lights
    lt = scene.light_type[:nl]
    c = scene.light_bsr[:nl, :3]
    r = scene.light_bsr[:nl, 3]
    dvec = c[None, :, :] - p[:, None, :]
    dsq = torch.sum(dvec * dvec, dim=-1)
    sin2 = clip(r[None, :] ** 2 / torch.clamp(dsq, min=1e-12), 0.0, 1.0)
    sa = 2.0 * math.pi * (1.0 - torch.sqrt(1.0 - sin2))
    w_area = sa * scene.light_lum[None, :nl]
    area_like = (lt == LIGHT_AREA) | (lt == LIGHT_DISK) | \
        (lt == LIGHT_CYLINDER) | (lt == LIGHT_SPHERE)
    w_other = scene.light_lum[None, :nl]
    if settings.has_points:
        # the emission tables hold a point's radiant intensity, so the
        # 1/r^2 falloff is what weighs
        pvec = scene.light_aux[None, :nl, :3] - p[:, None, :]
        w_point = INV_FOUR_PI * scene.light_lum[None, :nl] / \
            torch.clamp(torch.sum(pvec * pvec, dim=-1), min=1e-12)
        w_other = torch.where((lt == LIGHT_POINT)[None, :], w_point, w_other)
    w = torch.where(area_like[None, :], w_area, w_other)
    total = torch.sum(w, dim=-1)
    w = torch.where(total[..., None] > 0.0, w, 1.0)
    total = torch.where(total > 0.0, total, float(nl))
    return w, total


def choose_light(scene, settings, p, u_sel):
    """Radiance-weighted light selection (ref TraceBase::chooseLight);
    returns (light index (R,) i32, weight (R,) = total/pdf_of_pick)."""
    nl = settings.num_lights
    R = p.shape[0]
    if nl <= 1:
        return (torch.zeros((R,), dtype=torch.int32, device=p.device),
                torch.ones((R,), dtype=torch.float32, device=p.device))
    w, total = _choose_light_weights(scene, settings, p)
    cdf = ordered_cumsum(w, dim=-1)
    x = u_sel * total
    li = torch.clamp(torch.sum((cdf <= x[..., None]).to(torch.int32), dim=-1),
                     max=nl - 1)
    w_i = torch.gather(w, -1, li[..., None].long())[..., 0]
    weight = total / torch.clamp(w_i, min=1e-30)
    return li.to(torch.int32), weight


def area_light_sample(scene, light_idx, p, u_tri, u1, u2):
    """Sample a point on area light `light_idx` (R,) as seen from p (R,3).
    Returns dict(d, dist, pdf, emission, valid)."""
    tri_c = torch.clamp(alias_pick_tri(scene, light_idx, u_tri), 0,
                        scene.tri_v0.shape[0] - 1).long()
    su = torch.sqrt(torch.clamp(u1, min=0.0))
    a = 1.0 - su
    b = (1.0 - u2) * su
    v0 = scene.tri_v0[tri_c]
    e1 = scene.tri_e1[tri_c]
    e2 = scene.tri_e2[tri_c]
    q = v0 + a[..., None] * e1 + b[..., None] * e2
    n = torch.linalg.cross(e1, e2, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-20)
    dvec = q - p
    r_sq = torch.sum(dvec * dvec, dim=-1)
    dist = torch.sqrt(torch.clamp(r_sq, min=1e-20))
    d = dvec / dist[..., None]
    cos_theta = -torch.sum(d * n, dim=-1)
    area = scene.light_area[light_idx]
    pdf = r_sq / torch.clamp(cos_theta * area, min=1e-20)
    valid = (cos_theta > 0.0) & (area > 0.0)
    return dict(d=d, dist=dist, pdf=pdf,
                emission=take(scene.light_emission, light_idx), valid=valid)


def area_light_direct_pdf(scene, light_idx, hit_t, d, hit_normal, p=None,
                          has_sphere_lights: bool = False):
    """Solid-angle pdf that sampling light `light_idx` would have produced
    the given hit (Quad::directPdf r^2/(cos * area); analytic disks and
    cylinders use the same conversion).  Sphere emitters use the cone
    pdf (Sphere::directPdf): pass the shading point `p` when the scene
    has sphere lights."""
    cos_theta = -torch.sum(d * hit_normal, dim=-1)
    area = scene.light_area[light_idx]
    pdf = torch.where(
        cos_theta > 1e-6,
        hit_t * hit_t / torch.clamp(cos_theta * area, min=1e-20), 0.0)
    if has_sphere_lights and p is not None:
        pdf = torch.where(scene.light_type[light_idx] == LIGHT_SPHERE,
                          sphere_light_direct_pdf(scene, light_idx, p), pdf)
    return pdf


# ------------------------------------------------- analytic sphere emitter

def _sphere_of(scene, light_idx):
    slot = torch.clamp(scene.light_slot[light_idx], 0,
                       scene.sph_radius.shape[0] - 1).long()
    return scene.sph_center[slot], scene.sph_radius[slot]


def sphere_light_sample(scene, light_idx, p, u1, u2):
    """Cone sampling toward the sphere's subtended cap (ref
    Sphere::sampleDirect, Sphere.cpp:173-194): a uniform direction within
    cos(theta_max) = sqrt(d^2 - r^2)/d, distance the nearer root, pdf the
    uniform cap pdf; invalid for points inside the sphere.  Returns
    dict(d, dist, pdf, emission, valid)."""
    c, r = _sphere_of(scene, light_idx)
    lv = c - p
    d2 = torch.sum(lv * lv, dim=-1)
    dist_c = torch.sqrt(torch.clamp(d2, min=1e-20))
    C = d2 - r * r
    outside = C > 0.0
    cos_max = torch.sqrt(torch.clamp(C, min=0.0)) / dist_c
    ln = lv / dist_c[..., None]
    phi = u1 * 2.0 * math.pi
    z = 1.0 + u2 * (cos_max - 1.0)
    sr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    t, b = ortho_frame(ln)
    d = to_global(t, b, ln, torch.stack(
        [torch.cos(phi) * sr, torch.sin(phi) * sr, z], dim=-1))
    B = dist_c * z
    det = torch.sqrt(torch.clamp(B * B - C, min=0.0))
    dist = B - det
    pdf = INV_TWO_PI / torch.clamp(1.0 - cos_max, min=1e-9)
    valid = outside & (dist > 0.0)
    return dict(d=d, dist=dist, pdf=pdf,
                emission=take(scene.light_emission, light_idx), valid=valid)


def sphere_light_direct_pdf(scene, light_idx, p):
    """Sphere::directPdf: the cap pdf as seen from p (independent of the
    hit point)."""
    c, r = _sphere_of(scene, light_idx)
    lv = c - p
    d2 = torch.sum(lv * lv, dim=-1)
    cos_max = torch.sqrt(torch.clamp(d2 - r * r, min=0.0)) / \
        torch.sqrt(torch.clamp(d2, min=1e-20))
    return INV_TWO_PI / torch.clamp(1.0 - cos_max, min=1e-9)


# ------------------------------------------------ analytic disk / cylinder

def disk_light_sample(scene, light_idx, p, u1, u2):
    """Uniform point on an analytic disk emitter as seen from p (ref
    Disk::sampleDirect, Disk.cpp:177-195): rejects shading points behind
    the disk and directions outside its emission cone; pdf
    rSq/(cosTheta * area).  Returns dict(d, dist, pdf, emission,
    valid)."""
    slot = torch.clamp(scene.light_slot[light_idx], 0,
                       scene.dsk_r.shape[0] - 1).long()
    c = scene.dsk_c[slot]
    n = scene.dsk_n[slot]
    r = scene.dsk_r[slot]
    tan, bit = ortho_frame(n)
    # SampleWarp::uniformDisk (polar)
    rho = torch.sqrt(torch.clamp(u2, min=0.0)) * r
    phi = u1 * 2.0 * math.pi
    q = c + (torch.cos(phi) * rho)[..., None] * bit \
        + (torch.sin(phi) * rho)[..., None] * tan
    dvec = q - p
    r_sq = torch.sum(dvec * dvec, dim=-1)
    dist = torch.sqrt(torch.clamp(r_sq, min=1e-20))
    d = dvec / dist[..., None]
    cos_theta = -torch.sum(d * n, dim=-1)
    front = torch.sum(n * (p - c), dim=-1) > 0.0
    in_cone = cos_theta >= scene.dsk_cos[slot]
    area = scene.light_area[light_idx]
    pdf = r_sq / torch.clamp(cos_theta * area, min=1e-20)
    valid = front & in_cone & (cos_theta > 0.0) & (area > 0.0)
    return dict(d=d, dist=dist, pdf=pdf,
                emission=take(scene.light_emission, light_idx), valid=valid)


def _rot_apply(rot, v):
    """rot (R,3,3) times v (R,3), as elementwise products summed over j
    (a batched matmul may round differently from run to run)."""
    return torch.sum(rot * v[..., None, :], dim=-1)


def cyl_position_sample(scene, slot, u1, u2, u3):
    """Uniform-area point and outward normal on analytic cylinder `slot`
    (ref Cylinder::samplePosition, Cylinder.cpp:152-173): the caps take
    their share of the area, the side the rest.  Returns (q (R,3) world,
    n (R,3) world unit normal)."""
    r = scene.cyl_r[slot]
    hh = scene.cyl_hh[slot]
    capped = scene.cyl_capped[slot]
    cap_area = torch.where(capped, 2.0 * math.pi * r * r, 0.0)
    side_area = 2.0 * math.pi * r * 2.0 * hh
    p_cap = cap_area / torch.clamp(cap_area + side_area, min=1e-20)
    take_cap = u3 < p_cap
    # the remapped u3 picks the cap's sign
    sign = torch.where(u3 / torch.clamp(p_cap, min=1e-20) < 0.5, -1.0, 1.0)
    phi = u1 * 2.0 * math.pi
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    rho = torch.sqrt(torch.clamp(u2, min=0.0))
    q_cap = torch.stack([rho * cphi * r, sign * hh, rho * sphi * r], -1)
    n_cap = torch.stack([torch.zeros_like(sign), sign,
                         torch.zeros_like(sign)], -1)
    h = (2.0 * u2 - 1.0) * hh
    q_side = torch.stack([cphi * r, h, sphi * r], -1)
    n_side = torch.stack([cphi, torch.zeros_like(h), sphi], -1)
    q_loc = torch.where(take_cap[..., None], q_cap, q_side)
    n_loc = torch.where(take_cap[..., None], n_cap, n_side)
    rot = scene.cyl_rot[slot]
    return _rot_apply(rot, q_loc) + scene.cyl_pos[slot], _rot_apply(rot, n_loc)


def cyl_light_sample(scene, light_idx, p, u1, u2, u3):
    """Analytic cylinder emitter sample (ref Cylinder::sampleDirect,
    Cylinder.cpp:185-201): a uniform-area position, pdf rSq/(cosTheta *
    area), rejected where the sampled normal faces away."""
    slot = torch.clamp(scene.light_slot[light_idx], 0,
                       scene.cyl_r.shape[0] - 1).long()
    q, n = cyl_position_sample(scene, slot, u1, u2, u3)
    dvec = q - p
    r_sq = torch.sum(dvec * dvec, dim=-1)
    dist = torch.sqrt(torch.clamp(r_sq, min=1e-20))
    d = dvec / dist[..., None]
    cos_theta = -torch.sum(d * n, dim=-1)
    area = scene.light_area[light_idx]
    pdf = r_sq / torch.clamp(cos_theta * area, min=1e-20)
    valid = (cos_theta > 0.0) & (area > 0.0)
    return dict(d=d, dist=dist, pdf=pdf,
                emission=take(scene.light_emission, light_idx), valid=valid)


# ------------------------------------------------------------ cap / point

def cap_light_sample(scene, light_idx, u1, u2):
    """A uniform direction in the cap around light_aux's direction (ref
    InfiniteSphereCap::sampleDirect); returns (d, pdf)."""
    aux = scene.light_aux[light_idx]
    cap_d = aux[..., :3]
    cos_cap = aux[..., 3]
    phi = u1 * 2.0 * math.pi
    z = 1.0 + u2 * (cos_cap - 1.0)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    local = torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)
    t, b = ortho_frame(cap_d)
    return to_global(t, b, cap_d, local), cap_pdf_value(cos_cap)


def cap_pdf_value(cos_cap):
    return INV_TWO_PI / torch.clamp(1.0 - cos_cap, min=1e-9)


def eval_caps(scene, d):
    """Summed radiance of every cap that holds direction d, split by the
    samplable flag: (samplable (R,3), unsamplable (R,3))."""
    inside = torch.sum(d[..., None, :] * scene.cap_dir, dim=-1) >= \
        scene.cap_cos
    e = torch.where(inside[..., None], scene.cap_emission, 0.0)
    samp = scene.cap_samplable[..., None]
    return (torch.sum(torch.where(samp, e, 0.0), dim=-2),
            torch.sum(torch.where(samp, 0.0, e), dim=-2))


def power_heuristic(pdf0, pdf1):
    """pdf0^2 / (pdf0^2 + pdf1^2) in ratio form (no f32 overflow)."""
    ratio = pdf1 / torch.clamp(pdf0, min=1e-30)
    ratio = clip(ratio, hi=1e15)
    return torch.where(pdf0 > 0.0, 1.0 / (1.0 + ratio * ratio), 0.0)
