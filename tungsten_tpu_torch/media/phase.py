"""Phase functions: isotropic / Henyey-Greenstein / Rayleigh, batched
(port of tungsten_tpu/media/phase.py).

Convention parity with ref src/core/phasefunctions/: `wi` is the ray's
direction of travel (NOT flipped), eval(wi, wo) over cos(theta) =
wi . wo; sample builds a frame around wi.
"""
from __future__ import annotations

import math

import torch

from tungsten_tpu_torch.utils.vecmath import (INV_FOUR_PI, ortho_frame,
                                              to_global)

P_ISOTROPIC = 0
P_HENYEY_GREENSTEIN = 1
P_RAYLEIGH = 2

NAMES = {"isotropic": P_ISOTROPIC, "henyey_greenstein": P_HENYEY_GREENSTEIN,
         "rayleigh": P_RAYLEIGH}


def _hg(cos_t, g):
    term = 1.0 + g * g - 2.0 * g * cos_t
    return INV_FOUR_PI * (1.0 - g * g) / (
        term * torch.sqrt(torch.clamp(term, min=1e-12)))


def _rayleigh(cos_t):
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_t * cos_t)


def phase_eval(ptype, g, wi, wo):
    """Scalar phase value (also the pdf — phases integrate to 1)."""
    cos_t = torch.sum(wi * wo, dim=-1)
    out = torch.full_like(cos_t, INV_FOUR_PI)
    out = torch.where(ptype == P_HENYEY_GREENSTEIN,
                      torch.where(torch.abs(g) < 1e-4, INV_FOUR_PI,
                                  _hg(cos_t, g)), out)
    return torch.where(ptype == P_RAYLEIGH, _rayleigh(cos_t), out)


def phase_pdf(ptype, g, wi, wo):
    return phase_eval(ptype, g, wi, wo)


def phase_sample(ptype, g, wi, u1, u2):
    """Sample wo around wi; returns (wo, pdf).  Weight is always 1."""
    phi = u1 * 2.0 * math.pi
    # isotropic: uniform sphere
    z_iso = u2 * 2.0 - 1.0
    # HG inverse CDF (guard g ~ 0)
    use_iso_hg = torch.abs(g) < 1e-4
    g_safe = torch.where(use_iso_hg, 1e-4, g)
    sq = (1.0 - g_safe * g_safe) / (1.0 + g_safe * (u2 * 2.0 - 1.0))
    z_hg = (1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe)
    # rayleigh inverse CDF (Cardano); zr + sqrt(zr^2 + 1) > 0, so the
    # real cube root is the positive power
    zr = u2 * 4.0 - 2.0
    inv_z = torch.sqrt(zr * zr + 1.0)
    u = torch.pow(zr + inv_z, 1.0 / 3.0)
    z_ray = u - 1.0 / u

    cos_t = torch.where(ptype == P_RAYLEIGH, z_ray,
                        torch.where(ptype == P_HENYEY_GREENSTEIN,
                                    torch.where(use_iso_hg, z_iso, z_hg),
                                    z_iso))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                         cos_t], dim=-1)
    t, b = ortho_frame(wi)
    wo = to_global(t, b, wi, local)
    return wo, phase_eval(ptype, g, wi, wo)
