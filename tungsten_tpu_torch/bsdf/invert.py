"""BSDF sample inversion (port of tungsten_tpu/bsdf/invert.py): map a
scattering direction back to the primary-sample-space uniforms that would
produce it.

The reference's `Bsdf::invert(WritablePathSampleGenerator&, event)`
(ref src/core/bsdfs/Bsdf.hpp:66-104, e.g. LambertBsdf.cpp:49-59,
RoughConductorBsdf.cpp:112-126, DielectricBsdf.cpp:110-140), the
machinery behind reversible-jump MLT's technique exchange
(ReversibleJumpMltTracer.cpp:128-196).  Each inversion matches this
package's samplers (bsdf/eval.py):

    sample(invert(wo)) == wo        (for the same wi)
    invert(sample(u))   ~ u         (on the deterministic coordinates)

Discrete choices that wo alone cannot recover (which lobe of a multi-lobe
BSDF, where inside a Dirac lobe's uniform cell) consume `mu` uniforms,
the analog of the reference's sampler.untracked1D().  Coats, mixed and
the fibers have no inverse: they report valid False.
"""
from __future__ import annotations

import math

import torch

from tungsten_tpu_torch.bsdf import fresnel as fr
from tungsten_tpu_torch.bsdf import microfacet as mf
from tungsten_tpu_torch.bsdf import types as bt
from tungsten_tpu_torch.bsdf.eval import (
    _cosine_pdf, _is_mirror_dir, _phong_terms, _reflect_z,
    _rough_dielectric_parts, _rough_plastic_probs)
from tungsten_tpu_torch.bsdf.types import P
from tungsten_tpu_torch.utils.vecmath import ortho_frame, to_local

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi


def _invert_phi(wo, fallback):
    """u for phi = 2 pi u reproducing atan2(wo_y, wo_x), in [0, 1) (the
    reference's SampleWarp::invertPhi); `fallback` where phi is
    undefined."""
    u = torch.atan2(wo[..., 1], wo[..., 0]) / TWO_PI
    u = torch.where(u < 0.0, u + 1.0, u)
    denom = wo[..., 0] ** 2 + wo[..., 1] ** 2
    return torch.where(denom > 1e-24, u, fallback)


def _invert_cosine_hemisphere(wo, mu):
    """(u1, u2) for eval._cosine_hemisphere: phi = 2 pi u1, r = sqrt(u2)."""
    u1 = _invert_phi(wo, mu)
    u2 = torch.clamp(wo[..., 0] ** 2 + wo[..., 1] ** 2, 0.0, 1.0)
    return u1, u2


def _invert_uniform_hemisphere(wo, mu):
    """(u1, u2) for eval._uniform_hemisphere: z = u2."""
    return _invert_phi(wo, mu), torch.clamp(torch.abs(wo[..., 2]), 0.0, 1.0)


def invert_microfacet(dist, alpha, m, mu):
    """(u1, u2) for microfacet.sample reproducing normal m (the
    reference's Microfacet::invert)."""
    cos = torch.clamp(m[..., 2], 1e-10, 1.0)
    tan_sq = torch.clamp(1.0 - cos * cos, min=0.0) / (cos * cos)
    a_sq = torch.clamp(alpha * alpha, min=1e-20)
    u1_beck = 1.0 - torch.exp(-tan_sq / a_sq)
    u1_phong = torch.pow(cos, alpha + 2.0)
    u1_ggx = tan_sq / (a_sq + tan_sq)
    u1 = torch.where(dist == bt.DIST_BECKMANN, u1_beck,
                     torch.where(dist == bt.DIST_PHONG, u1_phong, u1_ggx))
    u2 = _invert_phi(m, mu)
    return torch.clamp(u1, 0.0, 1.0 - 1e-7), u2


def _seg(mu, lo, width):
    """A uniform draw inside [lo, lo + width): the inverse of a discrete
    branch whose acceptance region is that segment."""
    return torch.clamp(lo + mu * torch.clamp(torch.as_tensor(width),
                                             min=1e-7), 0.0, 1.0 - 1e-7)


def bsdf_invert(sp, wi, wo, present_types, mu):
    """Invert the sampling of `wo` at shade point sp with incident wi
    (both in the local frame).  mu (..., 4): uniforms for the free and
    discrete coordinates.  Returns dict(lobe, lobe2, u1, u2 in [0, 1),
    valid: False where the BSDF cannot produce wo or has no inverse)."""
    mu0, mu1, mu2, mu3 = (mu[..., 0], mu[..., 1], mu[..., 2], mu[..., 3])
    out = dict(lobe=mu0, lobe2=mu1, u1=mu2, u2=mu3,
               valid=torch.zeros(wi.shape[:-1], dtype=torch.bool,
                                 device=wi.device))

    refl_ok = _is_mirror_dir(wi, wo)
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)

    def merge(m, l2=None, a=None, b=None, ok=None):
        for k, v in (("lobe2", l2), ("u1", a), ("u2", b)):
            if v is not None:
                out[k] = torch.where(m, v, out[k])
        out["valid"] = torch.where(m, ok, out["valid"])

    t = sp.type

    # ---- lambert: cosine hemisphere ----
    if bt.LAMBERT in present_types:
        a, b = _invert_cosine_hemisphere(wo, mu2)
        merge(t == bt.LAMBERT, a=a, b=b, ok=up)

    # ---- pure mirror lobes: wo is determined, every dim free ----
    for ty in (bt.MIRROR, bt.CONDUCTOR):
        if ty in present_types:
            merge(t == ty, ok=(wi[..., 2] > 0) & refl_ok)

    # ---- rough conductor: invert the half-vector warp ----
    if bt.ROUGH_CONDUCTOR in present_types:
        alpha = mf.roughness_to_alpha(sp.dist, sp.roughness)
        m = wi + wo
        m = m / torch.clamp(torch.linalg.vector_norm(m, dim=-1, keepdim=True),
                            min=1e-20)
        a, b = invert_microfacet(sp.dist, alpha, m, mu3)
        ok = up & (torch.sum(wi * m, dim=-1) > 0)
        merge(t == bt.ROUGH_CONDUCTOR, a=a, b=b, ok=ok)

    # ---- dielectric: discrete reflect / refract through lobe2 ----
    if bt.DIELECTRIC in present_types:
        ior = sp.params[..., P.IOR]
        enable_t = sp.params[..., P.EXTRA0] > 0.5
        eta = torch.where(wi[..., 2] < 0.0, ior, 1.0 / ior)
        F, cos_t = fr.dielectric_reflectance(eta, torch.abs(wi[..., 2]))
        refl_prob = torch.where(enable_t, F, 1.0)
        wo_t = torch.stack([-wi[..., 0] * eta, -wi[..., 1] * eta,
                            -torch.copysign(cos_t, wi[..., 2])], dim=-1)
        is_t = torch.sum(torch.abs(wo - wo_t), dim=-1) < 1e-3
        l2 = torch.where(is_t, _seg(mu1, refl_prob, 1.0 - refl_prob),
                         _seg(mu1, 0.0, refl_prob))
        ok = torch.where(is_t, enable_t & (F < 1.0),
                         refl_ok & (wi[..., 2] != 0.0))
        merge(t == bt.DIELECTRIC, l2=l2, ok=ok & (refl_ok | is_t))

    # ---- rough dielectric: half vector + discrete F segment ----
    if bt.ROUGH_DIELECTRIC in present_types:
        ior = sp.params[..., P.IOR]
        enable_t = sp.params[..., P.EXTRA0] > 0.5
        reflect, _, m, _, _, _ = _rough_dielectric_parts(sp, wi, wo)
        m = torch.where((m[..., 2] < 0.0)[..., None], -m, m)
        wi_dot_m = torch.sum(wi * m, dim=-1)
        s_rough = (1.2 - 0.2 * torch.sqrt(torch.abs(wi[..., 2]))) * \
            sp.roughness
        s_alpha = mf.roughness_to_alpha(sp.dist, s_rough)
        a, b = invert_microfacet(sp.dist, s_alpha, m, mu3)
        Fm, _ = fr.dielectric_reflectance(1.0 / ior, wi_dot_m)
        l2 = torch.where(reflect, _seg(mu1, 0.0, Fm),
                         _seg(mu1, Fm, 1.0 - Fm))
        ok = (m[..., 2] > 1e-6) & torch.where(reflect, True,
                                              enable_t & (Fm < 1.0))
        merge(t == bt.ROUGH_DIELECTRIC, l2=l2, a=a, b=b, ok=ok)

    # ---- plastic: specular segment or diffuse cosine ----
    if bt.PLASTIC in present_types:
        ior = sp.params[..., P.IOR]
        Fi, _ = fr.dielectric_reflectance(1.0 / ior, wi[..., 2])
        avg_trans = sp.params[..., P.EXTRA1]
        spec_prob = Fi / torch.clamp(Fi + avg_trans * (1.0 - Fi), min=1e-20)
        a, b = _invert_cosine_hemisphere(wo, mu2)
        # a mirror-direction wo is ambiguous in principle; the diffuse
        # lobe has measure zero there, so it counts as specular
        l2 = torch.where(refl_ok, _seg(mu1, 0.0, spec_prob),
                         _seg(mu1, spec_prob, 1.0 - spec_prob))
        merge(t == bt.PLASTIC, l2=l2, a=torch.where(refl_ok, mu2, a),
              b=torch.where(refl_ok, mu3, b), ok=up)

    # ---- rough plastic: stochastic branch choice by pdf share ----
    if bt.ROUGH_PLASTIC in present_types:
        spec_prob = _rough_plastic_probs(sp, wi)
        _, _, m, _, _, _ = _rough_dielectric_parts(sp, wi, wo)
        m = torch.where((m[..., 2] < 0.0)[..., None], -m, m)
        rough = (1.2 - 0.2 * torch.sqrt(torch.abs(wi[..., 2]))) * \
            sp.roughness
        s_alpha = mf.roughness_to_alpha(sp.dist, rough)
        pm = mf.pdf(sp.dist, s_alpha, m)
        p_g = spec_prob * pm * 0.25 / torch.clamp(
            torch.abs(torch.sum(wi * m, dim=-1)), min=1e-20)
        p_d = (1.0 - spec_prob) * _cosine_pdf(wo)
        w_g = p_g / torch.clamp(p_g + p_d, min=1e-20)
        pick_g = mu0 < w_g
        ag, bg = invert_microfacet(sp.dist, s_alpha, m, mu3)
        ad, bd = _invert_cosine_hemisphere(wo, mu2)
        l2 = torch.where(pick_g, _seg(mu1, 0.0, spec_prob),
                         _seg(mu1, spec_prob, 1.0 - spec_prob))
        merge(t == bt.ROUGH_PLASTIC, l2=l2, a=torch.where(pick_g, ag, ad),
              b=torch.where(pick_g, bg, bd), ok=up)

    # ---- oren-nayar: uniform / cosine mixture by pdf share ----
    if bt.OREN_NAYAR in present_types:
        ratio = torch.clamp(sp.roughness, 0.01, 1.0)
        p_u = ratio * (0.5 * INV_PI)
        p_c = (1.0 - ratio) * _cosine_pdf(wo)
        pick_u = mu0 < p_u / torch.clamp(p_u + p_c, min=1e-20)
        au, bu = _invert_uniform_hemisphere(wo, mu2)
        ac, bc = _invert_cosine_hemisphere(wo, mu2)
        l2 = torch.where(pick_u, _seg(mu1, 0.0, ratio),
                         _seg(mu1, ratio, 1.0 - ratio))
        merge(t == bt.OREN_NAYAR, l2=l2, a=torch.where(pick_u, au, ac),
              b=torch.where(pick_u, bu, bc), ok=up)

    # ---- phong: glossy-lobe frame inversion or diffuse cosine ----
    if bt.PHONG in present_types:
        n, dr = _phong_terms(sp)
        mdir = _reflect_z(wi)
        tan, bit = ortho_frame(mdir)
        local = to_local(tan, bit, mdir, wo)
        cos_t = torch.clamp(local[..., 2], 1e-10, 1.0)
        in_lobe = local[..., 2] > 0.0
        p_g = torch.where(in_lobe, (1.0 - dr) * torch.pow(cos_t, n)
                          * (n + 1.0) / TWO_PI, 0.0)
        p_d = dr * _cosine_pdf(wo)
        pick_g = mu0 < p_g / torch.clamp(p_g + p_d, min=1e-20)
        ag = _invert_phi(local, mu2)
        bg = torch.pow(cos_t, n + 1.0)
        ad, bd = _invert_cosine_hemisphere(wo, mu2)
        l2 = torch.where(pick_g, _seg(mu1, dr, 1.0 - dr),
                         _seg(mu1, 0.0, dr))
        merge(t == bt.PHONG, l2=l2, a=torch.where(pick_g, ag, ad),
              b=torch.where(pick_g, bg, bd), ok=up)

    # ---- diffuse transmission: the side picks the branch ----
    if bt.DIFFUSE_TRANSMISSION in present_types:
        tr = sp.params[..., P.EXTRA0]
        transmit = (wo[..., 2] * wi[..., 2]) < 0.0
        wo_up = torch.cat([wo[..., :2], torch.abs(wo[..., 2:3])], dim=-1)
        a, b = _invert_cosine_hemisphere(wo_up, mu2)
        l2 = torch.where(transmit, _seg(mu1, 0.0, tr),
                         _seg(mu1, tr, 1.0 - tr))
        ok = torch.where(transmit, tr > 0.0, tr < 1.0)
        merge(t == bt.DIFFUSE_TRANSMISSION, l2=l2, a=a, b=b, ok=ok)

    return out
