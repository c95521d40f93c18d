"""Microfacet distributions (Beckmann / Phong / GGX), batched with a
per-ray distribution id (port of tungsten_tpu/bsdf/microfacet.py).

Formula parity with ref src/core/bsdfs/Microfacet.hpp: D, the rational
Smith G1 approximations, pdf = D * m.z, and the exact inverse-CDF
sampling per distribution.  roughnessToAlpha clamps at 1e-3 and converts
Phong roughness to an exponent.
"""
from __future__ import annotations

import math

import torch

from tungsten_tpu_torch.utils.vecmath import clip

from tungsten_tpu_torch.bsdf.types import DIST_BECKMANN, DIST_GGX, DIST_PHONG

MIN_ALPHA = 1e-3


def roughness_to_alpha(dist, roughness):
    r = clip(roughness, MIN_ALPHA)
    phong = 2.0 / (r * r) - 2.0
    return torch.where(dist == DIST_PHONG, phong, r)


def D(dist, alpha, m):
    mz = m[..., 2]
    cos_sq = mz * mz
    tan_sq = torch.clamp(1.0 - cos_sq, min=0.0) / torch.clamp(cos_sq,
                                                              min=1e-20)
    cos_qu = cos_sq * cos_sq
    a_sq = alpha * alpha

    beck = torch.exp(-tan_sq / torch.clamp(a_sq, min=1e-20)) / \
        torch.clamp(math.pi * a_sq * cos_qu, min=1e-20)
    phong = (alpha + 2.0) / (2.0 * math.pi) * \
        torch.pow(torch.clamp(mz, min=1e-20), alpha)
    ggx = a_sq / torch.clamp(math.pi * cos_qu * (a_sq + tan_sq) ** 2,
                             min=1e-20)

    d = torch.where(dist == DIST_BECKMANN, beck,
                    torch.where(dist == DIST_PHONG, phong, ggx))
    return torch.where(mz > 0.0, d, 0.0)


def G1(dist, alpha, v, m):
    vz = v[..., 2]
    ok = torch.sum(v * m, dim=-1) * vz > 0.0
    cos_sq = vz * vz
    tan_theta = torch.abs(torch.sqrt(torch.clamp(1.0 - cos_sq, min=0.0)) /
                          torch.where(torch.abs(vz) > 1e-20, vz, 1e-20))
    tan_theta = torch.clamp(tan_theta, min=1e-20)

    a_beck = 1.0 / torch.clamp(alpha * tan_theta, min=1e-20)
    a_phong = torch.sqrt(0.5 * alpha + 1.0) / tan_theta
    a = torch.where(dist == DIST_PHONG, a_phong, a_beck)
    rational = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    smith = torch.where(a < 1.6, rational, 1.0)

    a_sq = alpha * alpha
    tan_sq = torch.clamp(1.0 - cos_sq, min=0.0) / torch.clamp(cos_sq,
                                                              min=1e-20)
    ggx = 2.0 / (1.0 + torch.sqrt(1.0 + a_sq * tan_sq))

    g = torch.where(dist == DIST_GGX, ggx, smith)
    return torch.where(ok, g, 0.0)


def G(dist, alpha, wi, wo, m):
    return G1(dist, alpha, wi, m) * G1(dist, alpha, wo, m)


def pdf(dist, alpha, m):
    return D(dist, alpha, m) * m[..., 2]


def sample(dist, alpha, u1, u2):
    """Sample a microfacet normal m; (u1, u2) uniform."""
    phi = u2 * (2.0 * math.pi)
    u1 = torch.clamp(u1, max=1.0 - 1e-7)

    tan_sq_beck = -alpha * alpha * torch.log(1.0 - u1)
    cos_beck = 1.0 / torch.sqrt(1.0 + tan_sq_beck)
    cos_phong = torch.pow(torch.clamp(u1, min=1e-20), 1.0 / (alpha + 2.0))
    tan_sq_ggx = alpha * alpha * u1 / torch.clamp(1.0 - u1, min=1e-20)
    cos_ggx = 1.0 / torch.sqrt(1.0 + tan_sq_ggx)

    cos_theta = torch.where(dist == DIST_BECKMANN, cos_beck,
                            torch.where(dist == DIST_PHONG, cos_phong,
                                        cos_ggx))
    r = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, cos_theta],
                       dim=-1)
