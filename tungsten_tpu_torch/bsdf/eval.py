"""Batched BSDF eval / sample / pdf over the flattened material table
(port of tungsten_tpu/bsdf/eval.py: lambert, null, mirror, conductor,
rough_conductor, dielectric, rough_dielectric, plastic, rough_plastic,
oren_nayar, phong, diffuse_transmission, smooth_coat, rough_coat, mixed,
the forward-lobe types thinsheet, transparency and forward, whose
straight-through lobe `bsdf_forward` evaluates, and the fiber BCSDFs of
bsdf/fiber.py: hair, rough_wire and lambertian_fiber).

Convention (ref Bsdf.hpp + SurfaceScatterEvent): directions in the local
tangent frame, +z = shading normal; `wi` points away from the surface
toward the previous vertex; eval() returns f * |cos(theta_o)|; sample()
returns (wo, weight = f*cos/pdf, pdf, flags); eval()/pdf() cover the
non-Dirac lobes only.  Dispatch is a masked select over the BSDF types
present in the scene; nested materials (smooth/rough coat, mixed,
transparency) re-dispatch one level down over the non-nested present
types; a type without an entry (the ERROR row) evaluates to zero, as in
the JAX package.  Every formula is the
JAX package's, op for op (each function names its reference source).
"""
from __future__ import annotations

import math

import torch

from tungsten_tpu_torch.bsdf import fresnel as fr
from tungsten_tpu_torch.bsdf import microfacet as mf
from tungsten_tpu_torch.bsdf import types as bt
from tungsten_tpu_torch.bsdf.types import AUX, P
from tungsten_tpu_torch.scene.textures import eval_texture
from tungsten_tpu_torch.utils.vecmath import (INV_PI, clip, ortho_frame,
                                              take, to_global)

FLAG_SPECULAR = 1
FLAG_VALID = 2
FLAG_TRANSMIT = 4

NESTED_TYPES = (bt.SMOOTH_COAT, bt.ROUGH_COAT, bt.MIXED, bt.TRANSPARENCY)


def _flag(mask, value):
    """int32 `value` where mask, else 0 (the JAX package's flag words)."""
    return torch.where(mask, value, 0).to(torch.int32)


def _cosine_hemisphere(u1, u2):
    phi = u1 * (2.0 * math.pi)
    r = torch.sqrt(u2)
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)


def _cosine_pdf(wo):
    return torch.abs(wo[..., 2]) * INV_PI


def _uniform_hemisphere(u1, u2):
    phi = u1 * (2.0 * math.pi)
    z = u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)


def _reflect_z(wi):
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def _is_mirror_dir(wi, wo, tol=1e-3):
    """wo is wi's mirror direction (the reference's
    checkReflectionConstraint, for float wavefronts)."""
    return torch.sum(torch.abs(wo - _reflect_z(wi)), dim=-1) < tol


def _normalized(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-20)


def _zeros3(wi):
    return torch.zeros(wi.shape[:-1] + (3,), dtype=wi.dtype, device=wi.device)


def _zeros1(wi, dtype=None):
    return torch.zeros(wi.shape[:-1], dtype=dtype or wi.dtype,
                       device=wi.device)


class ShadePoint:
    """Per-ray material bindings gathered once per bounce."""

    def __init__(self, scene, bsdf_idx, uv):
        self.scene = scene
        self.idx = bsdf_idx
        self.uv = uv
        self.type = scene.bsdf_type[bsdf_idx]
        self.params = take(scene.bsdf_params, bsdf_idx)
        self.aux = scene.bsdf_aux[bsdf_idx]
        self.albedo = self._tex(scene.bsdf_albedo_tex[bsdf_idx])
        # textured roughness: params[ROUGHNESS] < 0 marks a texture ref
        r_scalar = self.params[..., P.ROUGHNESS]
        if scene.tex_type.shape[0] > 0:
            r_val = self._tex(torch.clamp(self.aux[..., AUX.RATIO_TEX], 0,
                                          scene.tex_type.shape[0] - 1))
            self.roughness = torch.where(r_scalar < 0.0, r_val[..., 0],
                                         r_scalar)
        else:
            self.roughness = r_scalar
        self.dist = self.aux[..., AUX.DISTRIBUTION]

    def _tex(self, tex_idx):
        s = self.scene
        return eval_texture(s.tex_type, s.tex_const, s.tex_params,
                            s.tex_bitmap_id, s.bitmaps, tex_idx.long(),
                            self.uv)

    def child(self, slot=AUX.CHILD0):
        idx = torch.clamp(self.aux[..., slot], 0,
                          self.scene.bsdf_type.shape[0] - 1).long()
        return ShadePoint(self.scene, idx, self.uv)

    def ratio(self):
        """mixed-ratio texture value."""
        r_tex = torch.clamp(self.aux[..., AUX.RATIO_TEX], 0,
                            self.scene.tex_type.shape[0] - 1)
        return self._tex(r_tex)[..., 0]


# =================================================================== lambert

def _lambert_eval(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(ok[..., None], sp.albedo * (INV_PI * wo[..., 2:3]),
                       0.0)


def _lambert_pdf(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(ok, wo[..., 2] * INV_PI, 0.0)


def _lambert_sample(sp, wi, U, ctx):
    wo = _cosine_hemisphere(U["u1"], U["u2"])
    pdf = _cosine_pdf(wo)
    ok = wi[..., 2] > 0
    weight = torch.where(ok[..., None], sp.albedo, 0.0)
    return wo, weight, pdf, _flag(ok, FLAG_VALID)


# ============================================================ mirror, null

def _zero_eval(sp, wi, wo, ctx):
    return _zeros3(wi)


def _zero_pdf(sp, wi, wo, ctx):
    return _zeros1(wi)


def _mirror_sample(sp, wi, U, ctx):
    wo = _reflect_z(wi)
    ok = wi[..., 2] > 0
    weight = torch.where(ok[..., None], sp.albedo, 0.0)
    pdf = torch.where(ok, 1.0, 0.0)
    return wo, weight, pdf, _flag(ok, FLAG_VALID | FLAG_SPECULAR)


def _null_sample(sp, wi, U, ctx):
    return (_reflect_z(wi), _zeros3(wi), _zeros1(wi),
            _zeros1(wi, torch.int32))


# ================================================================= conductor

def _conductor_sample(sp, wi, U, ctx):
    """ref ConductorBsdf::sample"""
    wo = _reflect_z(wi)
    eta = sp.params[..., P.ETA_R:P.ETA_B + 1]
    k = sp.params[..., P.K_R:P.K_B + 1]
    F = fr.conductor_reflectance_rgb(eta, k, wi[..., 2])
    ok = wi[..., 2] > 0
    weight = torch.where(ok[..., None], sp.albedo * F, 0.0)
    pdf = torch.where(ok, 1.0, 0.0)
    return wo, weight, pdf, _flag(ok, FLAG_VALID | FLAG_SPECULAR)


# =========================================================== rough conductor

def _rough_conductor_eval(sp, wi, wo, ctx):
    """ref RoughConductorBsdf::eval"""
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    alpha = mf.roughness_to_alpha(sp.dist, sp.roughness)
    hr = _normalized(wi + wo)
    cos_m = torch.sum(wi * hr, dim=-1)
    eta = sp.params[..., P.ETA_R:P.ETA_B + 1]
    k = sp.params[..., P.K_R:P.K_B + 1]
    F = fr.conductor_reflectance_rgb(eta, k, cos_m)
    G = mf.G(sp.dist, alpha, wi, wo, hr)
    D = mf.D(sp.dist, alpha, hr)
    f = (G * D * 0.25) / torch.clamp(wi[..., 2], min=1e-20)
    return torch.where(ok[..., None], sp.albedo * F * f[..., None], 0.0)


def _rough_conductor_pdf(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    alpha = mf.roughness_to_alpha(sp.dist, sp.roughness)
    hr = _normalized(wi + wo)
    p = mf.pdf(sp.dist, alpha, hr) * 0.25 / \
        torch.clamp(torch.abs(torch.sum(wi * hr, dim=-1)), min=1e-20)
    return torch.where(ok, p, 0.0)


def _rough_conductor_sample(sp, wi, U, ctx):
    """ref RoughConductorBsdf::sample"""
    alpha = mf.roughness_to_alpha(sp.dist, sp.roughness)
    # detached microfacet sampling, as the JAX package: the sampled
    # half-vector carries no parameter gradient (the warp's derivative
    # is singular at the domain edges and NaNs the replay backward); the
    # weight D·G/pdf keeps its roughness dependence at the detached m
    m = mf.sample(sp.dist, alpha, U["u1"], U["u2"]).detach()
    wi_dot_m = torch.sum(wi * m, dim=-1)
    wo = 2.0 * wi_dot_m[..., None] * m - wi
    ok = (wi[..., 2] > 0) & (wi_dot_m > 0) & (wo[..., 2] > 0)
    G = mf.G(sp.dist, alpha, wi, wo, m)
    D = mf.D(sp.dist, alpha, m)
    m_pdf = mf.pdf(sp.dist, alpha, m)
    pdf = m_pdf * 0.25 / torch.clamp(wi_dot_m, min=1e-20)
    w = wi_dot_m * G * D / torch.clamp(wi[..., 2] * m_pdf, min=1e-20)
    eta = sp.params[..., P.ETA_R:P.ETA_B + 1]
    k = sp.params[..., P.K_R:P.K_B + 1]
    F = fr.conductor_reflectance_rgb(eta, k, wi_dot_m)
    weight = torch.where(ok[..., None], sp.albedo * F * w[..., None], 0.0)
    pdf = torch.where(ok, pdf, 0.0)
    return wo, weight, pdf, _flag(ok, FLAG_VALID)


# ================================================================ dielectric

def _dielectric_sample(sp, wi, U, ctx):
    """ref DielectricBsdf::sample (both Dirac lobes, refraction-enabled
    governed by params[EXTRA0])."""
    ior = sp.params[..., P.IOR]
    enable_t = sp.params[..., P.EXTRA0] > 0.5
    eta = torch.where(wi[..., 2] < 0.0, ior, 1.0 / ior)
    F, cos_t = fr.dielectric_reflectance(eta, torch.abs(wi[..., 2]))
    refl_prob = torch.where(enable_t, F, 1.0)

    take_refl = U["lobe2"] < refl_prob
    wo_r = _reflect_z(wi)
    wo_t = torch.stack([
        -wi[..., 0] * eta, -wi[..., 1] * eta,
        -torch.copysign(cos_t, wi[..., 2])], dim=-1)
    wo = torch.where(take_refl[..., None], wo_r, wo_t)
    w_r = torch.where(enable_t, 1.0, F)
    w_t = 1.0 - F  # only reachable when enable_t
    if not ctx.get("adjoint", False):
        # radiance compression across the boundary (ref
        # Bsdf::sample(event, adjoint=false), Bsdf.hpp:71-83)
        w_t = w_t * eta * eta
    w = torch.where(take_refl, w_r, w_t)
    pdf = torch.where(take_refl, refl_prob, 1.0 - refl_prob)
    ok = torch.where(take_refl, wi[..., 2] != 0.0, F < 1.0)
    weight = torch.where(ok[..., None], sp.albedo * w[..., None], 0.0)
    flags = _flag(ok, FLAG_VALID | FLAG_SPECULAR) | \
        _flag(ok & ~take_refl, FLAG_TRANSMIT)
    return wo, weight, torch.where(ok, pdf, 0.0), flags


# ========================================================== rough dielectric

def _rough_dielectric_parts(sp, wi, wo):
    ior = sp.params[..., P.IOR]
    wi_n = wi[..., 2]
    wo_n = wo[..., 2]
    reflect = wi_n * wo_n >= 0.0
    eta = torch.where(wi_n < 0.0, ior, 1.0 / ior)
    m_r = torch.sign(wi_n)[..., None] * (wi + wo)
    m_t = -(wi * eta[..., None] + wo)
    m = _normalized(torch.where(reflect[..., None], m_r, m_t))
    wi_dot_m = torch.sum(wi * m, dim=-1)
    wo_dot_m = torch.sum(wo * m, dim=-1)
    F, _ = fr.dielectric_reflectance(1.0 / ior, wi_dot_m)
    return reflect, eta, m, wi_dot_m, wo_dot_m, F


def _sampling_alpha(sp, wi):
    """The widened roughness microfacet sampling uses (ref
    RoughDielectricBsdf: (1.2 - 0.2 sqrt|cos|) * roughness)."""
    rough = (1.2 - 0.2 * torch.sqrt(torch.abs(wi[..., 2]))) * sp.roughness
    return mf.roughness_to_alpha(sp.dist, rough)


def _rough_dielectric_eval(sp, wi, wo, ctx):
    """ref RoughDielectricBsdf::evalBase (sampleR and sampleT on)."""
    enable_t = sp.params[..., P.EXTRA0] > 0.5
    reflect, eta, m, wi_dot_m, wo_dot_m, F = _rough_dielectric_parts(
        sp, wi, wo)
    alpha = mf.roughness_to_alpha(sp.dist, sp.roughness)
    G = mf.G(sp.dist, alpha, wi, wo, m)
    D = mf.D(sp.dist, alpha, m)
    abs_wi_n = torch.clamp(torch.abs(wi[..., 2]), min=1e-20)
    f_r = F * G * D * 0.25 / abs_wi_n
    denom = torch.clamp((eta * wi_dot_m + wo_dot_m) ** 2, min=1e-20)
    f_t = torch.abs(wi_dot_m * wo_dot_m) * (1.0 - F) * G * D / \
        (denom * abs_wi_n)
    if not ctx.get("adjoint", False):
        # camera-transport eta^2 on the transmission lobe
        # (ref Bsdf::eval(event, adjoint=false), Bsdf.hpp:84-96)
        f_t = f_t * eta * eta
    f = torch.where(reflect, f_r, torch.where(enable_t, f_t, 0.0))
    return sp.albedo * f[..., None]


def _rough_dielectric_pdf(sp, wi, wo, ctx):
    """ref RoughDielectricBsdf::pdfBase."""
    enable_t = sp.params[..., P.EXTRA0] > 0.5
    reflect, eta, m, wi_dot_m, wo_dot_m, F = _rough_dielectric_parts(
        sp, wi, wo)
    pm = mf.pdf(sp.dist, _sampling_alpha(sp, wi), m)
    pdf_r = pm * 0.25 / torch.clamp(torch.abs(wi_dot_m), min=1e-20)
    pdf_t = pm * torch.abs(wo_dot_m) / \
        torch.clamp((eta * wi_dot_m + wo_dot_m) ** 2, min=1e-20)
    return torch.where(reflect, pdf_r * torch.where(enable_t, F, 1.0),
                       torch.where(enable_t, pdf_t * (1.0 - F), 0.0))


def _rough_dielectric_sample(sp, wi, U, ctx):
    """ref RoughDielectricBsdf::sampleBase."""
    ior = sp.params[..., P.IOR]
    enable_t = sp.params[..., P.EXTRA0] > 0.5
    wi_n = wi[..., 2]
    eta_n = torch.where(wi_n < 0.0, ior, 1.0 / ior)
    alpha = mf.roughness_to_alpha(sp.dist, sp.roughness)
    s_alpha = _sampling_alpha(sp, wi)
    m = mf.sample(sp.dist, s_alpha, U["u1"], U["u2"]).detach()  # detached
    pm = mf.pdf(sp.dist, s_alpha, m)
    wi_dot_m = torch.sum(wi * m, dim=-1)
    F, cos_t = fr.dielectric_reflectance(1.0 / ior, wi_dot_m)
    eta_m = torch.where(wi_dot_m < 0.0, ior, 1.0 / ior)

    reflect = torch.where(enable_t, U["lobe2"] < F,
                          torch.ones_like(F, dtype=torch.bool))
    wo_r = 2.0 * wi_dot_m[..., None] * m - wi
    wo_t = (eta_m * wi_dot_m - torch.sign(wi_dot_m) * cos_t)[..., None] * \
        m - eta_m[..., None] * wi
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    wo_n = wo[..., 2]
    ok = (pm > 1e-10) & ((wi_n * wo_n > 0.0) == reflect)
    wo_dot_m = torch.sum(wo * m, dim=-1)
    G = mf.G(sp.dist, alpha, wi, wo, m)
    D = mf.D(sp.dist, alpha, m)
    w = torch.abs(wi_dot_m) * G * D / torch.clamp(torch.abs(wi_n) * pm,
                                                  min=1e-20)
    pdf_r = pm * 0.25 / torch.clamp(torch.abs(wi_dot_m), min=1e-20)
    pdf_t = pm * torch.abs(wo_dot_m) / \
        torch.clamp((eta_n * wi_dot_m + wo_dot_m) ** 2, min=1e-20)
    pdf = torch.where(reflect, pdf_r, pdf_t)
    # enable_t: the F-choice goes into the pdf; otherwise into the weight
    pick = torch.where(reflect, F, 1.0 - F)
    pdf = torch.where(enable_t, pdf * pick, pdf)
    w = torch.where(enable_t, w, w * pick)
    if not ctx.get("adjoint", False):
        # camera-transport eta^2 on refraction (Bsdf.hpp:71-83)
        w = torch.where(reflect, w, w * eta_n * eta_n)
    weight = torch.where(ok[..., None], sp.albedo * w[..., None], 0.0)
    flags = _flag(ok, FLAG_VALID) | _flag(ok & ~reflect, FLAG_TRANSMIT)
    return wo, weight, torch.where(ok, pdf, 0.0), flags


# =================================================================== plastic

def _plastic_diffuse_f(sp, wi, wo):
    """Shared diffuse layer term of Plastic (ref PlasticBsdf::eval)."""
    ior = sp.params[..., P.IOR]
    eta = 1.0 / ior
    Fi, _ = fr.dielectric_reflectance(eta, wi[..., 2])
    Fo, _ = fr.dielectric_reflectance(eta, wo[..., 2])
    dfres = sp.params[..., P.EXTRA0]
    alb = sp.albedo
    brdf = ((1.0 - Fi) * (1.0 - Fo) * eta * eta * wo[..., 2] * INV_PI
            )[..., None] * alb / (1.0 - alb * dfres[..., None])
    sig = sp.params[..., P.SIGMA_A_R:P.SIGMA_A_B + 1] * \
        sp.params[..., P.THICKNESS][..., None]
    atten = torch.exp(sig * (-1.0 / torch.clamp(wo[..., 2:3], min=1e-6)
                             - 1.0 / torch.clamp(wi[..., 2:3], min=1e-6)))
    return brdf * atten


def _plastic_eval(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(ok[..., None], _plastic_diffuse_f(sp, wi, wo), 0.0)


def _plastic_pdf(sp, wi, wo, ctx):
    # non-specular request: pure cosine pdf (ref PlasticBsdf::pdf, sampleT)
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(ok, _cosine_pdf(wo), 0.0)


def _spec_prob(sp, Fi):
    """P(specular lobe) of plastic and the coats: Fi against the
    substrate's average transmittance."""
    avg_trans = sp.params[..., P.EXTRA1]
    return Fi / torch.clamp(Fi + avg_trans * (1.0 - Fi), min=1e-20)


def _plastic_sample(sp, wi, U, ctx):
    """ref PlasticBsdf::sample (both lobes)."""
    ior = sp.params[..., P.IOR]
    eta = 1.0 / ior
    Fi, _ = fr.dielectric_reflectance(eta, wi[..., 2])
    spec_prob = _spec_prob(sp, Fi)
    take_spec = U["lobe2"] < spec_prob

    wo_s = _reflect_z(wi)
    w_spec = Fi / torch.clamp(spec_prob, min=1e-20)

    wo_d = _cosine_hemisphere(U["u1"], U["u2"])
    f_d = _plastic_diffuse_f(sp, wi, wo_d)
    pdf_d = _cosine_pdf(wo_d) * (1.0 - spec_prob)
    w_d = f_d / torch.clamp(pdf_d, min=1e-20)[..., None]

    ok = wi[..., 2] > 0
    wo = torch.where(take_spec[..., None], wo_s, wo_d)
    weight = torch.where(take_spec[..., None], w_spec[..., None], w_d)
    weight = torch.where(ok[..., None], weight, 0.0)
    pdf = torch.where(take_spec, spec_prob, pdf_d)
    flags = _flag(ok, FLAG_VALID) | _flag(ok & take_spec, FLAG_SPECULAR)
    return wo, weight, torch.where(ok, pdf, 0.0), flags


# ============================================================= rough plastic

def _rough_plastic_eval(sp, wi, wo, ctx):
    """glossy (rough-dielectric reflection) + diffuse substrate
    (ref RoughPlasticBsdf::eval)."""
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    # glossy reflection part = rough dielectric eval with T disabled
    reflect, eta, m, wi_dot_m, wo_dot_m, F = _rough_dielectric_parts(
        sp, wi, wo)
    alpha = mf.roughness_to_alpha(sp.dist, sp.roughness)
    G = mf.G(sp.dist, alpha, wi, wo, m)
    D = mf.D(sp.dist, alpha, m)
    glossy = F * G * D * 0.25 / torch.clamp(torch.abs(wi[..., 2]), min=1e-20)
    diffuse = _plastic_diffuse_f(sp, wi, wo)
    return torch.where(ok[..., None], glossy[..., None] + diffuse, 0.0)


def _rough_plastic_probs(sp, wi):
    ior = sp.params[..., P.IOR]
    Fi, _ = fr.dielectric_reflectance(1.0 / ior, wi[..., 2])
    sub_w = sp.params[..., P.EXTRA2] * sp.params[..., P.EXTRA1] * (1.0 - Fi)
    return Fi / torch.clamp(Fi + sub_w, min=1e-20)


def _rough_plastic_pdf(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    spec_prob = _rough_plastic_probs(sp, wi)
    reflect, eta, m, wi_dot_m, wo_dot_m, F = _rough_dielectric_parts(
        sp, wi, wo)
    pm = mf.pdf(sp.dist, _sampling_alpha(sp, wi), m)
    glossy_pdf = pm * 0.25 / torch.clamp(torch.abs(wi_dot_m), min=1e-20)
    pdf = glossy_pdf * spec_prob + _cosine_pdf(wo) * (1.0 - spec_prob)
    return torch.where(ok, pdf, 0.0)


def _rough_plastic_sample(sp, wi, U, ctx):
    """ref RoughPlasticBsdf::sample: pick lobe, sample it, MIS-combine
    both lobes' f and pdf."""
    spec_prob = _rough_plastic_probs(sp, wi)
    take_spec = U["lobe2"] < spec_prob
    # glossy branch: rough-dielectric reflection sample (T off)
    m = mf.sample(sp.dist, _sampling_alpha(sp, wi), U["u1"],
                  U["u2"]).detach()  # detached sampling
    wi_dot_m = torch.sum(wi * m, dim=-1)
    wo_g = 2.0 * wi_dot_m[..., None] * m - wi
    wo_d = _cosine_hemisphere(U["u1"], U["u2"])
    wo = torch.where(take_spec[..., None], wo_g, wo_d)
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    # combined f and pdf at the chosen wo
    f = _rough_plastic_eval(sp, wi, wo, ctx)
    pdf = _rough_plastic_pdf(sp, wi, wo, ctx)
    good = ok & (pdf > 1e-20)
    weight = torch.where(good[..., None],
                         f / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
    return wo, weight, pdf, _flag(good, FLAG_VALID)


# ================================================================ oren-nayar

def _oren_nayar_eval(sp, wi, wo, ctx):
    """ref OrenNayarBsdf::eval (full Fujii/improved form)."""
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    theta_r = torch.arccos(torch.clamp(wo[..., 2], -1, 1))
    theta_i = torch.arccos(torch.clamp(wi[..., 2], -1, 1))
    alpha = torch.maximum(theta_r, theta_i)
    beta = torch.minimum(theta_r, theta_i)
    sin_alpha = torch.sin(alpha)
    denom = (wi[..., 0] ** 2 + wi[..., 1] ** 2) * \
        (wo[..., 0] ** 2 + wo[..., 1] ** 2)
    cos_dphi = torch.where(
        denom <= 0.0, 1.0,
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
        / torch.sqrt(torch.clamp(denom, min=1e-30)))
    sigma = sp.roughness / math.sqrt(2.0)
    s_sq = sigma * sigma
    C1 = 1.0 - 0.5 * s_sq / (s_sq + 0.33)
    C2 = 0.45 * s_sq / (s_sq + 0.09)
    C2 = torch.where(cos_dphi >= 0.0, C2 * sin_alpha,
                     C2 * (sin_alpha - ((2.0 * INV_PI) * beta) ** 3))
    C3 = 0.125 * (s_sq / (s_sq + 0.09)) * \
        ((4.0 * INV_PI * INV_PI) * alpha * beta) ** 2
    fr1 = C1 + cos_dphi * C2 * torch.tan(beta) + \
        (1.0 - torch.abs(cos_dphi)) * C3 * torch.tan(0.5 * (alpha + beta))
    fr2 = 0.17 * s_sq / (s_sq + 0.13) * \
        (1.0 - cos_dphi * ((2.0 * INV_PI) * beta) ** 2)
    alb = sp.albedo
    f = (alb * fr1[..., None] + alb * alb * fr2[..., None]) * \
        wo[..., 2:3] * INV_PI
    return torch.where(ok[..., None], f, 0.0)


def _oren_nayar_pdf(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    ratio = clip(sp.roughness, 0.01, 1.0)
    p = (0.5 * INV_PI) * ratio + _cosine_pdf(wo) * (1.0 - ratio)
    return torch.where(ok, p, 0.0)


def _mis_sample(sp, wi, wo, eval_fn, pdf_fn, ctx):
    """(weight, pdf, flags) of a lobe-mixture BSDF at its sampled wo:
    the combined f over the combined pdf (oren-nayar, phong)."""
    pdf = pdf_fn(sp, wi, wo, ctx)
    f = eval_fn(sp, wi, wo, ctx)
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0) & (pdf > 1e-20)
    weight = torch.where(ok[..., None],
                         f / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
    return weight, pdf, _flag(ok, FLAG_VALID)


def _oren_nayar_sample(sp, wi, U, ctx):
    ratio = clip(sp.roughness, 0.01, 1.0)
    uni = _uniform_hemisphere(U["u1"], U["u2"])
    cos = _cosine_hemisphere(U["u1"], U["u2"])
    wo = torch.where((U["lobe2"] < ratio)[..., None], uni, cos)
    return (wo,) + _mis_sample(sp, wi, wo, _oren_nayar_eval,
                               _oren_nayar_pdf, ctx)


# ===================================================================== phong

def _phong_terms(sp):
    """The phong exponent n and diffuse ratio dr."""
    return sp.params[..., P.EXTRA0], sp.params[..., P.EXTRA1]


def _phong_lobe(sp, wi, wo, norm_add):
    """exponent n, diffuse ratio dr and the glossy lobe
    cos^n (n + norm_add) / 2pi around the mirror direction."""
    n, dr = _phong_terms(sp)
    cos_t = torch.sum(_reflect_z(wi) * wo, dim=-1)
    glossy = torch.where(cos_t > 0,
                         torch.pow(torch.clamp(cos_t, min=1e-20), n)
                         * (n + norm_add) / (2.0 * math.pi), 0.0)
    return n, dr, glossy


def _phong_eval(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    _, dr, glossy = _phong_lobe(sp, wi, wo, 2.0)
    f = sp.albedo * (wo[..., 2] * (dr * INV_PI + glossy * (1.0 - dr))
                     )[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _phong_pdf(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    _, dr, glossy = _phong_lobe(sp, wi, wo, 1.0)
    p = glossy * (1.0 - dr) + dr * _cosine_pdf(wo)
    return torch.where(ok, p, 0.0)


def _phong_sample(sp, wi, U, ctx):
    n = sp.params[..., P.EXTRA0]
    dr = sp.params[..., P.EXTRA1]
    take_glossy = U["lobe2"] >= dr
    phi = U["u1"] * 2.0 * math.pi
    cos_theta = torch.pow(torch.clamp(U["u2"], min=1e-20), 1.0 / (n + 1.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_theta,
                         torch.sin(phi) * sin_theta, cos_theta], dim=-1)
    # frame around the mirror direction
    mdir = _reflect_z(wi)
    t, b = ortho_frame(mdir)
    wo_g = to_global(t, b, mdir, local)
    wo_d = _cosine_hemisphere(U["u1"], U["u2"])
    wo = torch.where(take_glossy[..., None], wo_g, wo_d)
    return (wo,) + _mis_sample(sp, wi, wo, _phong_eval, _phong_pdf, ctx)


# ================================================================= thinsheet

def _thinsheet_transmittance(sp, wi):
    """ref ThinSheetBsdf::eval: the forward-lobe transmittance."""
    ior = sp.params[..., P.IOR]
    R, cos_t = fr.thin_film_reflectance(1.0 / ior, torch.abs(wi[..., 2]))
    sig = sp.params[..., P.SIGMA_A_R:P.SIGMA_A_B + 1]
    thickness = sp.params[..., P.THICKNESS]
    atten = torch.exp(-sig * (thickness[..., None] * 2.0 /
                              torch.clamp(cos_t[..., None], min=1e-6)))
    atten = torch.where(cos_t[..., None] > 0, atten, 1.0)
    return (1.0 - R)[..., None] * atten


def _thinsheet_sample(sp, wi, U, ctx):
    R, _ = fr.thin_film_reflectance(1.0 / sp.params[..., P.IOR],
                                    torch.abs(wi[..., 2]))
    trans = _thinsheet_transmittance(sp, wi)
    w = R[..., None] / torch.clamp(
        1.0 - torch.mean(trans, -1, keepdim=True), min=1e-20)
    pdf = torch.ones(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    flags = torch.full(wi.shape[:-1], FLAG_VALID | FLAG_SPECULAR,
                       dtype=torch.int32, device=wi.device)
    return _reflect_z(wi), w.expand(wi.shape), pdf, flags


# ====================================================== diffuse transmission

def _difftrans_factor(sp, wi, wo):
    tr = sp.params[..., P.EXTRA0]
    return torch.where(wi[..., 2] * wo[..., 2] < 0.0, tr, 1.0 - tr)


def _difftrans_eval(sp, wi, wo, ctx):
    return sp.albedo * (_difftrans_factor(sp, wi, wo) * INV_PI *
                        torch.abs(wo[..., 2]))[..., None]


def _difftrans_pdf(sp, wi, wo, ctx):
    return _difftrans_factor(sp, wi, wo) * _cosine_pdf(wo)


def _difftrans_sample(sp, wi, U, ctx):
    tr = sp.params[..., P.EXTRA0]
    transmit = U["lobe2"] < tr
    wo = _cosine_hemisphere(U["u1"], U["u2"])
    z = torch.copysign(wo[..., 2], wi[..., 2])
    z = torch.where(transmit, -z, z)
    wo = torch.cat([wo[..., :2], z[..., None]], dim=-1)
    # branch probability folded into the pdf so pdf() and sample() agree
    pdf = _cosine_pdf(wo) * torch.where(transmit, tr, 1.0 - tr)
    weight = torch.broadcast_to(sp.albedo, wo.shape)
    flags = _flag(torch.ones_like(transmit), FLAG_VALID) | \
        _flag(transmit, FLAG_TRANSMIT)
    return wo, weight, pdf, flags


# =============================================================== smooth coat

def _coat_warp(ior, w):
    """Refract direction w into the coating (top interface)."""
    eta = 1.0 / ior
    F, cos_t = fr.dielectric_reflectance(eta, torch.abs(w[..., 2]))
    warped = torch.stack([
        w[..., 0] * eta, w[..., 1] * eta,
        torch.copysign(cos_t, w[..., 2])], dim=-1)
    return warped, F, cos_t


def _coat_atten(sp, cos_a, cos_b):
    """Absorption through the coat layer along both legs."""
    sig = sp.params[..., P.SIGMA_A_R:P.SIGMA_A_B + 1] * \
        sp.params[..., P.THICKNESS][..., None]
    return torch.exp(sig * (-1.0 / torch.clamp(cos_a[..., None], min=1e-6)
                            - 1.0 / torch.clamp(cos_b[..., None], min=1e-6)))


def _smooth_coat_eval(sp, wi, wo, ctx):
    """ref SmoothCoatBsdf::eval (substrate branch; the specular lobe is
    Dirac and contributes 0 to non-delta eval)."""
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    ior = sp.params[..., P.IOR]
    eta = 1.0 / ior
    wi_s, Fi, cos_ti = _coat_warp(ior, wi)
    wo_s, Fo, cos_to = _coat_warp(ior, wo)
    laplacian = eta * eta * wo[..., 2] / torch.clamp(cos_to, min=1e-6)
    sub_f = _dispatch_eval(sp.child(), wi_s, wo_s, ctx["child_types"], ctx)
    atten = _coat_atten(sp, cos_to, cos_ti)
    f = (laplacian * (1.0 - Fi) * (1.0 - Fo))[..., None] * sub_f * atten
    return torch.where(ok[..., None], f, 0.0)


def _smooth_coat_pdf(sp, wi, wo, ctx):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    ior = sp.params[..., P.IOR]
    eta = 1.0 / ior
    wi_s, Fi, cos_ti = _coat_warp(ior, wi)
    wo_s, Fo, cos_to = _coat_warp(ior, wo)
    sub_pdf = _dispatch_pdf(sp.child(), wi_s, wo_s, ctx["child_types"], ctx)
    spec_prob = _spec_prob(sp, Fi)
    p = sub_pdf * (1.0 - spec_prob) * eta * eta * \
        torch.abs(wo[..., 2] / torch.clamp(cos_to, min=1e-6))
    return torch.where(ok, p, 0.0)


def _smooth_coat_sample(sp, wi, U, ctx):
    """ref SmoothCoatBsdf::sample."""
    ior = sp.params[..., P.IOR]
    eta = 1.0 / ior
    wi_s, Fi, cos_ti = _coat_warp(ior, wi)
    spec_prob = _spec_prob(sp, Fi)
    take_spec = U["lobe"] < spec_prob

    # specular branch
    wo_spec = _reflect_z(wi)
    w_spec = Fi / torch.clamp(spec_prob, min=1e-20)

    # substrate branch: sample the child with the warped wi
    U_sub = dict(U, lobe=U["lobe2"])
    wo_sub, w_sub, pdf_sub, fl_sub = _dispatch_sample(
        sp.child(), wi_s, U_sub, ctx["child_types"], ctx)
    Fo, cos_to = fr.dielectric_reflectance(ior, wo_sub[..., 2])
    cos_sub = wo_sub[..., 2]
    wo_out = torch.stack([
        wo_sub[..., 0] * ior, wo_sub[..., 1] * ior, cos_to], dim=-1)
    atten = _coat_atten(sp, cos_sub, cos_ti)
    w_subst = w_sub * ((1.0 - Fi) * (1.0 - Fo))[..., None] * atten / \
        torch.clamp(1.0 - spec_prob, min=1e-20)[..., None]
    pdf_subst = pdf_sub * (1.0 - spec_prob) * eta * eta * \
        cos_to / torch.clamp(cos_sub, min=1e-20)
    ok_sub = ((fl_sub & FLAG_VALID) != 0) & (Fo < 1.0)

    ok = wi[..., 2] > 0
    wo = torch.where(take_spec[..., None], wo_spec, wo_out)
    weight = torch.where(take_spec[..., None], w_spec[..., None],
                         torch.where(ok_sub[..., None], w_subst, 0.0))
    weight = torch.where(ok[..., None], weight, 0.0)
    pdf = torch.where(take_spec, spec_prob, pdf_subst)
    valid = ok & (take_spec | ok_sub)
    flags = _flag(valid, FLAG_VALID) | _flag(valid & take_spec,
                                             FLAG_SPECULAR)
    return wo, weight, torch.where(valid, pdf, 0.0), flags


# ===================================================================== mixed

def _mixed_eval(sp, wi, wo, ctx):
    ratio = sp.ratio()[..., None]
    f0 = _dispatch_eval(sp.child(AUX.CHILD0), wi, wo, ctx["child_types"],
                        ctx)
    f1 = _dispatch_eval(sp.child(AUX.CHILD1), wi, wo, ctx["child_types"],
                        ctx)
    return sp.albedo * (f0 * ratio + f1 * (1.0 - ratio))


def _mixed_pdf(sp, wi, wo, ctx):
    ratio = sp.ratio()
    p0 = _dispatch_pdf(sp.child(AUX.CHILD0), wi, wo, ctx["child_types"], ctx)
    p1 = _dispatch_pdf(sp.child(AUX.CHILD1), wi, wo, ctx["child_types"], ctx)
    return p0 * ratio + p1 * (1.0 - ratio)


def _mixed_sample(sp, wi, U, ctx):
    """ref MixedBsdf::sample with one-sample MIS over the two children."""
    ratio = sp.ratio()
    take0 = U["lobe"] < ratio
    c0 = sp.child(AUX.CHILD0)
    c1 = sp.child(AUX.CHILD1)
    types = ctx["child_types"]
    U_sub = dict(U, lobe=U["lobe2"])
    wo0, w0, p0, f0 = _dispatch_sample(c0, wi, U_sub, types, ctx)
    wo1, w1, p1, f1 = _dispatch_sample(c1, wi, U_sub, types, ctx)
    wo = torch.where(take0[..., None], wo0, wo1)
    # combined f and pdf at the chosen direction
    fA = _dispatch_eval(c0, wi, wo, types, ctx)
    fB = _dispatch_eval(c1, wi, wo, types, ctx)
    pA = _dispatch_pdf(c0, wi, wo, types, ctx)
    pB = _dispatch_pdf(c1, wi, wo, types, ctx)
    own_w = torch.where(take0[..., None], w0, w1)
    own_p = torch.where(take0, p0, p1)
    own_flags = torch.where(take0, f0, f1)
    spec = (own_flags & FLAG_SPECULAR) != 0
    # for non-specular children: f = fA*r + fB*(1-r); pdf = pA*r + pB*(1-r)
    f = fA * ratio[..., None] + fB * (1.0 - ratio[..., None])
    pdf = pA * ratio + pB * (1.0 - ratio)
    w_mix = torch.where(pdf[..., None] > 1e-20,
                        f / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
    # specular child picked: keep its weight/pdf scaled by pick prob
    pick_p = torch.where(take0, ratio, 1.0 - ratio)
    w_spec = own_w / torch.clamp(pick_p, min=1e-20)[..., None]
    p_spec = own_p * pick_p
    weight = sp.albedo * torch.where(spec[..., None], w_spec, w_mix)
    pdf = torch.where(spec, p_spec, pdf)
    valid = (own_flags & FLAG_VALID) != 0
    weight = torch.where(valid[..., None], weight, 0.0)
    flags = _flag(valid, FLAG_VALID) | _flag(valid & spec, FLAG_SPECULAR)
    return wo, weight, torch.where(valid, pdf, 0.0), flags


# ============================================================== transparency

def _transparency_eval(sp, wi, wo, ctx):
    return _dispatch_eval(sp.child(), wi, wo, ctx["child_types"], ctx)


def _transparency_pdf(sp, wi, wo, ctx):
    return _dispatch_pdf(sp.child(), wi, wo, ctx["child_types"], ctx)


def _transparency_sample(sp, wi, U, ctx):
    return _dispatch_sample(sp.child(), wi, U, ctx["child_types"], ctx)


# ------------------------------------------------------------- dispatch core

# type id -> (eval, sample, pdf)
_REGISTRY = {
    bt.LAMBERT: (_lambert_eval, _lambert_sample, _lambert_pdf),
    bt.MIRROR: (_zero_eval, _mirror_sample, _zero_pdf),
    bt.NULL: (_zero_eval, _null_sample, _zero_pdf),
    bt.CONDUCTOR: (_zero_eval, _conductor_sample, _zero_pdf),
    bt.ROUGH_CONDUCTOR: (_rough_conductor_eval, _rough_conductor_sample,
                         _rough_conductor_pdf),
    bt.DIELECTRIC: (_zero_eval, _dielectric_sample, _zero_pdf),
    bt.ROUGH_DIELECTRIC: (_rough_dielectric_eval, _rough_dielectric_sample,
                          _rough_dielectric_pdf),
    bt.PLASTIC: (_plastic_eval, _plastic_sample, _plastic_pdf),
    bt.ROUGH_PLASTIC: (_rough_plastic_eval, _rough_plastic_sample,
                       _rough_plastic_pdf),
    bt.OREN_NAYAR: (_oren_nayar_eval, _oren_nayar_sample, _oren_nayar_pdf),
    bt.PHONG: (_phong_eval, _phong_sample, _phong_pdf),
    bt.THINSHEET: (_zero_eval, _thinsheet_sample, _zero_pdf),
    bt.DIFFUSE_TRANSMISSION: (_difftrans_eval, _difftrans_sample,
                              _difftrans_pdf),
    bt.SMOOTH_COAT: (_smooth_coat_eval, _smooth_coat_sample,
                     _smooth_coat_pdf),
    bt.ROUGH_COAT: (_smooth_coat_eval, _smooth_coat_sample, _smooth_coat_pdf),
    bt.MIXED: (_mixed_eval, _mixed_sample, _mixed_pdf),
    bt.TRANSPARENCY: (_transparency_eval, _transparency_sample,
                      _transparency_pdf),
    bt.FORWARD: (_zero_eval, _null_sample, _zero_pdf),
}

# fiber BCSDFs (hair/rough_wire/lambertian_fiber) live in bsdf/fiber.py
from tungsten_tpu_torch.bsdf import fiber as _fiber  # noqa: E402

_REGISTRY[bt.HAIR] = (_fiber.hair_eval, _fiber.hair_sample, _fiber.hair_pdf)
_REGISTRY[bt.ROUGH_WIRE] = (_fiber.rough_wire_eval, _fiber.rough_wire_sample,
                            _fiber.rough_wire_pdf)
_REGISTRY[bt.LAMBERTIAN_FIBER] = (
    _fiber.lambertian_fiber_eval, _fiber.lambertian_fiber_sample,
    _fiber.lambertian_fiber_pdf)

# BSDFs whose continuation sample is a Dirac lobe only: NEE's
# AllButSpecular sample fails on them entirely
PURE_SPECULAR = frozenset({bt.MIRROR, bt.NULL, bt.CONDUCTOR, bt.DIELECTRIC,
                           bt.THINSHEET, bt.FORWARD})


def supported_types():
    return frozenset(_REGISTRY)


def _child_types(present_types):
    return tuple(t for t in present_types if t not in NESTED_TYPES)


def _make_ctx(present_types, adjoint=False):
    return {"child_types": _child_types(present_types), "adjoint": adjoint}


def _dispatch_eval(sp, wi, wo, types, ctx):
    out = _zeros3(wi)
    for t in types:
        if t in _REGISTRY:
            out = torch.where((sp.type == t)[..., None],
                              _REGISTRY[t][0](sp, wi, wo, ctx), out)
    return out


def _dispatch_pdf(sp, wi, wo, types, ctx):
    out = _zeros1(wi)
    for t in types:
        if t in _REGISTRY:
            out = torch.where(sp.type == t, _REGISTRY[t][2](sp, wi, wo, ctx),
                              out)
    return out


def _dispatch_sample(sp, wi, U, types, ctx):
    wo = _zeros3(wi)
    weight = _zeros3(wi)
    pdf = _zeros1(wi)
    flags = _zeros1(wi, torch.int32)
    for t in (t for t in types if t in _REGISTRY):
        w, wt, p, fl = _REGISTRY[t][1](sp, wi, U, ctx)
        m = sp.type == t
        wo = torch.where(m[..., None], w, wo)
        weight = torch.where(m[..., None], wt, weight)
        pdf = torch.where(m, p, pdf)
        flags = torch.where(m, fl, flags)
    return wo, weight, pdf, flags


# ----------------------------------------------------------------- public

def bsdf_eval(sp: ShadePoint, wi, wo, present_types, adjoint=False):
    """f * cos(theta_o); Dirac lobes contribute 0 (the reference's NEE
    convention).  Non-adjoint (camera) transport scales transmissive
    lobes by eta^2 = (etaI/etaO)^2 (ref Bsdf::eval(event, adjoint),
    Bsdf.hpp:84-96); adjoint transport omits it."""
    return _dispatch_eval(sp, wi, wo, present_types,
                          _make_ctx(present_types, adjoint))


def bsdf_pdf(sp: ShadePoint, wi, wo, present_types):
    return _dispatch_pdf(sp, wi, wo, present_types, _make_ctx(present_types))


def bsdf_sample(sp: ShadePoint, wi, u_lobe, u1, u2, present_types,
                u_lobe2=None, no_specular=False, adjoint=False):
    """Sample a direction for every ray; returns (wo, weight, pdf, flags).
    u_lobe picks a nested BSDF's branch (coat specular, mixed child),
    u_lobe2 a leaf BSDF's lobe (u_lobe when not given), as in
    tungsten_tpu/bsdf/eval.py:916.  no_specular is the AllButSpecular
    request of NEE's bsdf strategy: a sample that took a specular lobe
    comes back invalid with weight 0."""
    U = {"lobe": u_lobe, "u1": u1, "u2": u2,
         "lobe2": u_lobe2 if u_lobe2 is not None else u_lobe}
    wo, weight, pdf, flags = _dispatch_sample(
        sp, wi, U, present_types, _make_ctx(present_types, adjoint))
    if no_specular:
        spec = (flags & FLAG_SPECULAR) != 0
        flags = torch.where(spec, 0, flags).to(torch.int32)
        weight = torch.where(spec[..., None], 0.0, weight)
    return wo, weight, pdf, flags


def bsdf_forward(sp: ShadePoint, wi, present_types):
    """Forward-lobe transparency f(wi -> -wi), what the reference's
    handleSurface evaluates through makeForwardEvent: 1 for `forward`,
    1 - opacity for `transparency`, the transmittance of `thinsheet`,
    0 for every other type."""
    out = _zeros3(wi)
    if bt.FORWARD in present_types:
        out = torch.where((sp.type == bt.FORWARD)[..., None], 1.0, out)
    if bt.TRANSPARENCY in present_types:
        out = torch.where((sp.type == bt.TRANSPARENCY)[..., None],
                          (1.0 - sp.ratio())[..., None], out)
    if bt.THINSHEET in present_types:
        out = torch.where((sp.type == bt.THINSHEET)[..., None],
                          _thinsheet_transmittance(sp, wi), out)
    return out
