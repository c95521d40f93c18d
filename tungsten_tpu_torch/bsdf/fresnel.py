"""Fresnel terms (port of tungsten_tpu/bsdf/fresnel.py): batched torch
and the host-side diffuse-Fresnel precompute.

Formula parity with ref src/core/bsdfs/Fresnel.hpp: dielectric (with
internal-reflection handling via eta inversion), conductor (Shirley's
exact unpolarized form), and the hemispherical diffuse Fresnel integral
used by plastic/coat energy conservation, and the thin-film term of the
thinsheet BSDF.
"""
from __future__ import annotations

import numpy as np
import torch


def dielectric_reflectance(eta, cos_i):
    """F and cosThetaT.  `eta` is n_incident/n_transmitted as the reference
    passes it (i.e. callers pass 1/ior when entering from outside).
    Handles cos_i < 0 by flipping eta, like the reference."""
    flip = cos_i < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_i = torch.abs(cos_i)
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin_t_sq > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t_sq, min=0.0))
    rs = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-20)
    rp = (eta * cos_t - cos_i) / torch.clamp(eta * cos_t + cos_i, min=1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, f), torch.where(tir, 0.0, cos_t)


def conductor_reflectance(eta, k, cos_i):
    """Exact unpolarized conductor Fresnel; eta/k broadcast against cos_i.
    The square roots floor at 1e-20, as the JAX package's do (there for
    finite gradients through zeroed eta/k rows of other BSDF types)."""
    cos_sq = cos_i * cos_i
    sin_sq = torch.clamp(1.0 - cos_sq, min=0.0)
    sin_qu = sin_sq * sin_sq
    inner = eta * eta - k * k - sin_sq
    a_sq_b_sq = torch.sqrt(torch.clamp(
        inner * inner + 4.0 * eta * eta * k * k, min=1e-20))
    a = torch.sqrt(torch.clamp((a_sq_b_sq + inner) * 0.5, min=1e-20))
    rs = ((a_sq_b_sq + cos_sq) - 2.0 * a * cos_i) / \
        torch.clamp((a_sq_b_sq + cos_sq) + 2.0 * a * cos_i, min=1e-20)
    rp = ((cos_sq * a_sq_b_sq + sin_qu) - 2.0 * a * cos_i * sin_sq) / \
        torch.clamp((cos_sq * a_sq_b_sq + sin_qu) + 2.0 * a * cos_i * sin_sq,
                    min=1e-20)
    return 0.5 * (rs + rs * rp)


def conductor_reflectance_rgb(eta3, k3, cos_i):
    """eta3/k3 (..., 3), cos_i (...,) -> (..., 3)."""
    return conductor_reflectance(eta3, k3, cos_i[..., None])


def thin_film_reflectance(eta, cos_i):
    """Total reflectance of an infinitesimally thin film (all internal
    bounces summed); returns (R, cosThetaT)."""
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin_t_sq > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t_sq, min=0.0))
    rs = ((eta * cos_i - cos_t) /
          torch.clamp(eta * cos_i + cos_t, min=1e-20)) ** 2
    rp = ((eta * cos_t - cos_i) /
          torch.clamp(eta * cos_t + cos_i, min=1e-20)) ** 2
    r = 1.0 - ((1.0 - rs) / (1.0 + rs) + (1.0 - rp) / (1.0 + rp)) * 0.5
    return torch.where(tir, 1.0, r), torch.where(tir, 0.0, cos_t)


def compute_diffuse_fresnel(ior: float, samples: int = 100000) -> float:
    """Host-side trapezoid integral of F(ior, sqrt(t)) over t in [0,1]
    (= hemispherical average with cosine weight), ref Fresnel.hpp:141-153."""
    def f(eta, cos_i):
        if cos_i < 0:
            eta = 1.0 / eta
            cos_i = -cos_i
        sin_t_sq = eta * eta * (1 - cos_i * cos_i)
        if sin_t_sq > 1:
            return 1.0
        cos_t = np.sqrt(max(1 - sin_t_sq, 0))
        rs = (eta * cos_i - cos_t) / (eta * cos_i + cos_t)
        rp = (eta * cos_t - cos_i) / (eta * cos_t + cos_i)
        return 0.5 * (rs * rs + rp * rp)

    t = np.arange(1, samples + 1) / samples
    cos_i = np.sqrt(t)
    eta = np.full_like(cos_i, ior)
    sin_t_sq = eta * eta * (1 - cos_i * cos_i)
    cos_t = np.sqrt(np.maximum(1 - sin_t_sq, 0))
    rs = (eta * cos_i - cos_t) / (eta * cos_i + cos_t)
    rp = (eta * cos_t - cos_i) / (eta * cos_t + cos_i)
    fa = np.where(sin_t_sq > 1, 1.0, 0.5 * (rs * rs + rp * rp))
    fb = np.concatenate([[f(ior, 0.0)], fa[:-1]])
    return float(np.sum(fa + fb) * 0.5 / samples)
