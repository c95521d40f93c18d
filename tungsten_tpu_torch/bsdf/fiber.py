"""Fiber BCSDFs (port of tungsten_tpu/bsdf/fiber.py): hair (Marschner/d'Eon R/TT/TRT lobes with precomputed
azimuthal tables), rough_wire (conductor fiber) and lambertian_fiber.

Reference parity:
  * hair — src/core/bsdfs/HairBcsdf.cpp (M lobes analytic, N lobes
    precomputed into 64x64 tables over (phi, cos(thetaD)) with an
    InterpolatedDistribution1D sampler, HairBcsdf.cpp:318-415 +
    PrecomputedAzimuthalLobe.{hpp,cpp}).
  * rough_wire — src/core/bsdfs/RoughWireBcsdf.cpp (analytic N = the
    h->phi jacobian, von-Mises-Fisher-style M).
  * lambertian_fiber — src/core/bsdfs/LambertianFiberBcsdf.cpp (closed
    form Lambertian cylinder).

Frame convention: local y = fiber tangent (Curves::tangentSpace sets the
bitangent to the curve tangent), so wi.y = sin(theta) along the fiber
and phi = atan2(wo.x, wo.z) is the azimuth around it.

The hair tables are precomputed per hair-BSDF instance on the host
(numpy, at scene-flatten time — the analog of prepareForRender) and
shipped to the device; sigma_a/roughness are therefore *not*
differentiable for hair (same limitation as the reference's baked
tables).  The host precompute is the JAX package's numpy code as it is,
so the tables come out bit-equal; the device math is the JAX package's
op for op in PyTorch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tungsten_tpu_torch.bsdf import fresnel as fr
from tungsten_tpu_torch.bsdf.types import AUX, P
from tungsten_tpu_torch.utils.vecmath import clip

HAIR_ETA = 1.55          # ref HairBcsdf.hpp:19
AZ_RES = 64              # ref PrecomputedAzimuthalLobe::AzimuthalResolution
GL_POINTS = 140          # ref HairBcsdf.cpp NumPoints
D_SAMPLES = 2048         # ref HairBcsdf.cpp NumGaussianSamples
TWO_PI = 2.0 * np.pi


# ======================================================= host precompute

def _gaussian_detector(beta: float, phis: np.ndarray) -> np.ndarray:
    """Wrapped Gaussian D(beta, phi) as a finite sum (HairBcsdf.cpp:62-73)."""
    result = np.zeros_like(phis)
    shift = 0.0
    norm = 1.0 / (np.sqrt(2.0 * np.pi) * beta)
    while True:
        delta = (np.exp(-((phis + shift) ** 2) / (2 * beta * beta))
                 + np.exp(-((phis - shift - TWO_PI) ** 2)
                          / (2 * beta * beta))) * norm
        result += delta
        shift += TWO_PI
        if delta.max() <= 1e-4:
            break
    return result


def _dielectric_reflectance_np(eta, cos_i):
    cos_i = np.clip(cos_i, 0.0, 1.0)
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = np.sqrt(np.maximum(1.0 - sin_t_sq, 0.0))
    rs = (eta * cos_i - cos_t) / np.maximum(eta * cos_i + cos_t, 1e-20)
    rp = (eta * cos_t - cos_i) / np.maximum(eta * cos_t + cos_i, 1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    return np.where(sin_t_sq > 1.0, 1.0, f)


def precompute_hair_azimuthal(sigma_a, beta_r: float):
    """Bake N_R / N_TT / N_TRT tables + the interpolated-row sampling
    CDFs (ref HairBcsdf::precomputeAzimuthalDistributions +
    PrecomputedAzimuthalLobe ctor).

    Returns dict of numpy arrays:
      values (3, AZ_RES[y=cosThetaD], AZ_RES[x=phi], 3)
      pdf    (3, AZ_RES, AZ_RES)   row-normalized discrete pdf
      cdf    (3, AZ_RES, AZ_RES+1)
      sums   (3, AZ_RES)           unnormalized row sums (for weight())
    """
    sigma_a = np.asarray(sigma_a, np.float64).reshape(3)
    eta = HAIR_ETA

    x_gl, w_gl = np.polynomial.legendre.leggauss(GL_POINTS)
    gamma_i = np.arcsin(np.clip(x_gl, -1.0, 1.0))

    # D sampled once at beta_r for all lobes (HairBcsdf.cpp:341-347)
    phi_grid = np.arange(D_SAMPLES) / (D_SAMPLES - 1.0) * TWO_PI
    Dtab = _gaussian_detector(beta_r, phi_grid)

    def approx_d(dphi):
        u = np.abs(dphi * ((D_SAMPLES - 1) / TWO_PI))
        x0 = u.astype(np.int64)
        frac = u - x0
        return (Dtab[x0 % D_SAMPLES] * (1.0 - frac)
                + Dtab[(x0 + 1) % D_SAMPLES] * frac)

    ys = np.arange(AZ_RES) / (AZ_RES - 1.0)              # cosThetaD rows
    ch = np.maximum(ys, 1e-4)[:, None]                   # guard y = 0
    ior_prime = np.sqrt(eta * eta - (1.0 - ch * ch)) / ch
    cos_theta_t = np.sqrt(1.0 - (1.0 - ch * ch) / (eta * eta))
    sigma_a_prime = sigma_a[None, None] / cos_theta_t[..., None]  # (Y,1,3)

    gamma_t = np.arcsin(np.clip(x_gl[None, :] / ior_prime, -1.0, 1.0))
    f = _dielectric_reflectance_np(
        1.0 / eta, ch * np.cos(gamma_i)[None, :])        # (Y, G)
    T = np.exp(-sigma_a_prime * 2.0 * np.cos(gamma_t)[..., None])  # (Y,G,3)

    A_r = f[..., None] * np.ones(3)
    A_tt = ((1.0 - f) ** 2)[..., None] * T
    A_trt = A_tt * f[..., None] * T

    phis = TWO_PI * np.arange(AZ_RES) / (AZ_RES - 1.0)   # (X,)
    # Phi(gammaI, gammaT, p) = 2 p gammaT - 2 gammaI + p pi
    values = np.zeros((3, AZ_RES, AZ_RES, 3), np.float32)
    for p, A in ((0, A_r), (1, A_tt), (2, A_trt)):
        delta = phis[None, :, None] - (
            2.0 * p * gamma_t[:, None, :] - 2.0 * gamma_i[None, None, :]
            + p * np.pi)                                 # (Y, X, G)
        D = approx_d(delta)
        integ = np.einsum("g,yxg,ygc->yxc", w_gl, D, A)  # (Y, X, 3)
        values[p] = 0.5 * integ

    # sampling weights: max channel, dilated one texel in x then y
    # (PrecomputedAzimuthalLobe.cpp:12-29; clamped, not wrapped)
    w = values.max(axis=-1)                              # (3, Y, X)
    w = np.maximum(w, np.concatenate([w[:, :, 1:], w[:, :, -1:]], axis=2))
    w = np.maximum(w, np.concatenate([w[:, :, :1], w[:, :, :-1]], axis=2))
    w = np.maximum(w, np.concatenate([w[:, 1:], w[:, -1:]], axis=1))
    w = np.maximum(w, np.concatenate([w[:, :1], w[:, :-1]], axis=1))

    sums = w.sum(axis=-1)                                # (3, Y)
    degenerate = sums < 1e-4
    pdf = np.where(degenerate[..., None], 1.0 / AZ_RES,
                   w / np.maximum(sums[..., None], 1e-30))
    cdf = np.zeros((3, AZ_RES, AZ_RES + 1), np.float32)
    cdf[..., 1:] = np.cumsum(pdf, axis=-1)
    cdf[..., -1] = 1.0
    return dict(values=values.astype(np.float32),
                pdf=pdf.astype(np.float32), cdf=cdf,
                sums=sums.astype(np.float32))


def hair_sigma_a(b: dict) -> np.ndarray:
    """sigma_a from explicit override or the two melanin parameters
    (ref HairBcsdf::prepareForRender, HairBcsdf.cpp:432-441)."""
    if "sigma_a" in b:
        sa = b["sigma_a"]
        if isinstance(sa, (int, float)):
            sa = (sa,) * 3
        return np.asarray(sa, np.float64)
    ratio = float(b.get("melanin_ratio", 0.5))
    conc = float(b.get("melanin_concentration", 0.25))
    eumelanin = np.array([0.419, 0.697, 1.37])
    pheomelanin = np.array([0.187, 0.4, 1.05])
    return conc * ((1.0 - ratio) * eumelanin + ratio * pheomelanin)


def hair_lobe_params(b: dict) -> np.ndarray:
    """(scale_angle_rad, vR, vTT, vTRT) per HairBcsdf::prepareForRender."""
    roughness = float(b.get("roughness", 0.1))
    beta_r = max(np.pi / 2 * roughness, 0.04)
    beta_tt = beta_r * 0.5
    beta_trt = beta_r * 2.0
    scale = np.deg2rad(float(b.get("scale_angle", 2.0)))
    return np.asarray([scale, beta_r ** 2, beta_tt ** 2, beta_trt ** 2],
                      np.float32), beta_r


# ========================================================== device math

def trig_inverse(x):
    return torch.clamp(torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)),
                       max=1.0)


def trig_half_angle(x):
    return torch.clamp(torch.sqrt(torch.clamp(x * 0.5 + 0.5, min=0.0)),
                       max=1.0)


def _bessel_i0(x):
    """Series I0 as the reference computes it (HairBcsdf.cpp:25-37)."""
    result = torch.ones_like(x)
    x_sq = x * x
    xi = x_sq
    denom = 4.0
    for i in range(1, 11):
        result = result + xi / denom
        xi = xi * x_sq
        denom = denom * 4.0 * float((i + 1) * (i + 1))
    return result


def _log_i0(x):
    xs = torch.clamp(x, min=1e-8)
    return torch.where(
        x > 12.0,
        x + 0.5 * (torch.log(1.0 / (TWO_PI * xs)) + 1.0 / (8.0 * xs)),
        torch.log(torch.clamp(_bessel_i0(clip(x, hi=12.0)),
                              min=1e-30)))


def fiber_m(v, sin_ti, sin_to, cos_ti, cos_to):
    """Longitudinal scattering M (HairBcsdf.cpp:130-141), numerically
    stable in both the small- and large-roughness regimes."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    stable = torch.exp(-b + _log_i0(a) - 1.0 / v + 0.6931
                       + torch.log(1.0 / (2.0 * v)))
    direct = torch.exp(-b) * _bessel_i0(a) / \
        (2.0 * v * torch.sinh(clip(1.0 / v, hi=30.0)))
    return torch.where(v < 0.1, stable, direct)


def fiber_sample_m(v, sin_ti, cos_ti, xi1, xi2):
    """Returns sin(thetaO) (HairBcsdf.cpp:144-154)."""
    cos_theta = 1.0 + v * torch.log(
        torch.clamp(xi1 + (1.0 - xi1) * torch.exp(-2.0 / v), min=1e-30))
    sin_theta = trig_inverse(cos_theta)
    cos_phi = torch.cos(TWO_PI * xi2)
    return -cos_theta * sin_ti + sin_theta * cos_phi * cos_ti


# ------------------------------------------------------------------ hair

def _hair_tables(sp):
    return torch.clamp(sp.aux[..., AUX.CHILD0], 0,
                       sp.scene.hair_values.shape[0] - 1).long()


def _hair_angles(wi, wo):
    sin_ti = wi[..., 1]
    sin_to = wo[..., 1]
    cos_to = trig_inverse(sin_to)
    theta_i = torch.asin(torch.clamp(sin_ti, -1.0, 1.0))
    theta_o = torch.asin(torch.clamp(sin_to, -1.0, 1.0))
    cos_td = torch.cos((theta_o - theta_i) * 0.5)
    phi = torch.atan2(wo[..., 0], wo[..., 2])
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    return sin_ti, sin_to, cos_to, theta_i, cos_td, phi


def _hair_n_eval(scene, h, phi, cos_td):
    """Bilinear lookup of all three azimuthal lobes at once ->
    (..., 3 lobes, 3 rgb) (PrecomputedAzimuthalLobe::eval)."""
    u = (AZ_RES - 1) * phi / TWO_PI
    v = (AZ_RES - 1) * cos_td
    x0 = torch.clamp(u.to(torch.int32), 0, AZ_RES - 2).long()
    y0 = torch.clamp(v.to(torch.int32), 0, AZ_RES - 2).long()
    fu = torch.clamp(u - x0, 0.0, 1.0)[..., None, None]
    fv = torch.clamp(v - y0, 0.0, 1.0)[..., None, None]
    t = scene.hair_values
    v00 = t[h, :, y0, x0]
    v10 = t[h, :, y0, x0 + 1]
    v01 = t[h, :, y0 + 1, x0]
    v11 = t[h, :, y0 + 1, x0 + 1]
    return (v00 * (1 - fu) + v10 * fu) * (1 - fv) + \
        (v01 * (1 - fu) + v11 * fu) * fv


def _hair_rows(cos_td):
    """Row interpolation weights for the azimuthal sampler."""
    v = (AZ_RES - 1) * cos_td
    y0 = torch.clamp(v.to(torch.int32), 0, AZ_RES - 1).long()
    y1 = torch.clamp(y0 + 1, max=AZ_RES - 1)
    fv = torch.clamp(v - y0, 0.0, 1.0)
    return y0, y1, fv


def _hair_n_pdf(scene, h, phi, cos_td):
    """(..., 3 lobes) azimuthal pdf (PrecomputedAzimuthalLobe::pdf)."""
    u = (AZ_RES - 1) * phi / TWO_PI
    x = torch.clamp(u.to(torch.int32), 0, AZ_RES - 1).long()
    y0, y1, fv = _hair_rows(cos_td)
    p0 = scene.hair_pdf[h, :, y0, x]
    p1 = scene.hair_pdf[h, :, y1, x]
    return (p0 * (1 - fv[..., None]) + p1 * fv[..., None]) * \
        (AZ_RES / TWO_PI)


def _hair_weights(scene, h, cos_x):
    """(..., 3 lobes) lobe weights (PrecomputedAzimuthalLobe::weight)."""
    y0, y1, fv = _hair_rows(cos_x)
    s0 = scene.hair_sums[h, :, y0]
    s1 = scene.hair_sums[h, :, y1]
    return (s0 * (1 - fv[..., None]) + s1 * fv[..., None]) * \
        (TWO_PI / AZ_RES)


def _hair_ms(sp, theta_i, sin_to, cos_to):
    """(..., 3) M lobe values with per-lobe scale-tilt shifts."""
    pr = sp.scene.hair_params[_hair_tables(sp)]
    scale = pr[..., 0]
    shifts = torch.stack([theta_i - 2.0 * scale, theta_i + scale,
                          theta_i + 4.0 * scale], dim=-1)
    vs = pr[..., 1:4]
    return fiber_m(vs, torch.sin(shifts), sin_to[..., None],
                   torch.cos(shifts), cos_to[..., None])


def hair_eval(sp, wi, wo, ctx):
    """HairBcsdf::eval (no cosine fold — BCSDFs absorb the projection)."""
    h = _hair_tables(sp)
    sin_ti, sin_to, cos_to, theta_i, cos_td, phi = _hair_angles(wi, wo)
    M = _hair_ms(sp, theta_i, sin_to, cos_to)                  # (...,3)
    N = _hair_n_eval(sp.scene, h, phi, cos_td)                 # (...,3,3)
    return torch.sum(M[..., None] * N, dim=-2)


def hair_pdf(sp, wi, wo, ctx):
    h = _hair_tables(sp)
    sin_ti, sin_to, cos_to, theta_i, cos_td, phi = _hair_angles(wi, wo)
    cos_ti = trig_inverse(sin_ti)
    weights = _hair_weights(sp.scene, h, cos_ti)               # (...,3)
    wsum = torch.clamp(torch.sum(weights, dim=-1), min=1e-20)
    M = _hair_ms(sp, theta_i, sin_to, cos_to)
    Npdf = _hair_n_pdf(sp.scene, h, phi, cos_td)
    return torch.sum(weights * M * Npdf, dim=-1) / wsum


def _hair_sample_phi(scene, h, lobe, cos_td, xi):
    """Interpolated-row CDF inversion (InterpolatedDistribution1D::warp):
    6-step binary search over the 64 phi bins."""
    y0, y1, fv = _hair_rows(cos_td)

    def cdf_at(x):
        c0 = scene.hair_cdf[h, lobe, y0, x]
        c1 = scene.hair_cdf[h, lobe, y1, x]
        return c0 * (1 - fv) + c1 * fv

    lower = torch.zeros_like(lobe)
    upper = torch.full_like(lobe, AZ_RES)
    lower_u = torch.zeros_like(xi)
    upper_u = torch.ones_like(xi)
    for _ in range(6):  # log2(64)
        mid = (lower + upper) // 2
        mid_u = cdf_at(mid)
        below = mid_u < xi
        lower = torch.where(below, mid, lower)
        lower_u = torch.where(below, mid_u, lower_u)
        upper = torch.where(below, upper, mid)
        upper_u = torch.where(below, upper_u, mid_u)
    x = lower
    u = torch.clamp((xi - lower_u) /
                    torch.clamp(upper_u - lower_u, min=1e-20), 0.0, 1.0)
    phi = TWO_PI * (x.to(torch.float32) + u) / AZ_RES
    p0 = scene.hair_pdf[h, lobe, y0, x]
    p1 = scene.hair_pdf[h, lobe, y1, x]
    pdf = (p0 * (1 - fv) + p1 * fv) * (AZ_RES / TWO_PI)
    return phi, pdf


def hair_sample(sp, wi, U, ctx):
    """HairBcsdf::sample — lobe select by azimuthal weight, vMF-style M
    sampling, tabulated phi inversion, weight = eval/pdf."""
    from tungsten_tpu_torch.bsdf.eval import FLAG_VALID
    scene = sp.scene
    h = _hair_tables(sp)
    pr = scene.hair_params[h]
    scale = pr[..., 0]
    vs = pr[..., 1:4]

    sin_ti = wi[..., 1]
    cos_ti = trig_inverse(sin_ti)
    theta_i = torch.asin(torch.clamp(sin_ti, -1.0, 1.0))
    thetas = torch.stack([theta_i - 2.0 * scale, theta_i + scale,
                          theta_i + 4.0 * scale], dim=-1)

    weights = _hair_weights(scene, h, cos_ti)
    wsum = torch.clamp(torch.sum(weights, dim=-1), min=1e-20)
    target = U["lobe"] * wsum
    c0 = weights[..., 0]
    c01 = c0 + weights[..., 1]
    lobe = torch.where(target < c0, 0,
                       torch.where(target < c01, 1, 2)).long()

    v_sel = torch.gather(vs, -1, lobe[..., None])[..., 0]
    th_sel = torch.gather(thetas, -1, lobe[..., None])[..., 0]
    sin_to = fiber_sample_m(v_sel, torch.sin(th_sel), torch.cos(th_sel),
                            U["u1"], U["u2"])
    cos_to = trig_inverse(sin_to)
    theta_o = torch.asin(torch.clamp(sin_to, -1.0, 1.0))
    cos_td = torch.cos((theta_o - theta_i) * 0.5)

    phi, _ = _hair_sample_phi(scene, h, lobe, cos_td, U["lobe2"])
    wo = torch.stack([torch.sin(phi) * cos_to, sin_to,
                      torch.cos(phi) * cos_to], dim=-1)
    pdf = hair_pdf(sp, wi, wo, ctx)
    f = hair_eval(sp, wi, wo, ctx)
    ok = pdf > 1e-9
    weight = torch.where(ok[..., None],
                         f / torch.clamp(pdf, min=1e-9)[..., None], 0.0)
    flags = torch.where(ok, FLAG_VALID, 0).to(torch.int32)
    return wo, weight, pdf, flags


# ------------------------------------------------------------ rough wire

def _wire_v(sp):
    return torch.square(clip(sp.roughness, 1e-3) * (np.pi / 2))


def _wire_n(cos_phi):
    return 0.25 * trig_half_angle(cos_phi)


def _wire_terms(wi, wo):
    sin_ti = wi[..., 1]
    sin_to = wo[..., 1]
    cos_ti = trig_inverse(sin_ti)
    cos_to = trig_inverse(sin_to)
    denom = torch.sqrt(torch.clamp(wo[..., 0] ** 2 + wo[..., 2] ** 2,
                                   min=1e-20))
    cos_phi = wo[..., 2] / denom
    return sin_ti, sin_to, cos_ti, cos_to, cos_phi


def _wire_reflectance(sp, wi, wo):
    eta = sp.params[..., P.ETA_R:P.ETA_B + 1]
    k = sp.params[..., P.K_R:P.K_B + 1]
    return fr.conductor_reflectance_rgb(
        eta, k, trig_half_angle(torch.sum(wi * wo, dim=-1)))


def rough_wire_eval(sp, wi, wo, ctx):
    """RoughWireBcsdf::eval."""
    sin_ti, sin_to, cos_ti, cos_to, cos_phi = _wire_terms(wi, wo)
    val = sp.albedo * _wire_reflectance(sp, wi, wo) * (
        _wire_n(cos_phi) * fiber_m(_wire_v(sp), sin_ti, sin_to,
                                   cos_ti, cos_to))[..., None]
    return torch.where((wo[..., 2] == 0.0)[..., None], 0.0, val)


def rough_wire_pdf(sp, wi, wo, ctx):
    sin_ti, sin_to, cos_ti, cos_to, cos_phi = _wire_terms(wi, wo)
    return _wire_n(cos_phi) * fiber_m(_wire_v(sp), sin_ti, sin_to,
                                      cos_ti, cos_to)


def rough_wire_sample(sp, wi, U, ctx):
    from tungsten_tpu_torch.bsdf.eval import FLAG_VALID
    sin_ti = wi[..., 1]
    cos_ti = trig_inverse(sin_ti)
    sin_phi = 2.0 * U["lobe"] - 1.0
    sin_to = fiber_sample_m(_wire_v(sp), sin_ti, cos_ti, U["u1"], U["u2"])
    cos_phi = trig_inverse(sin_phi)
    cos_to = trig_inverse(sin_to)
    wo = torch.stack([sin_phi * cos_to, sin_to, cos_phi * cos_to], dim=-1)
    pdf = _wire_n(cos_phi) * fiber_m(_wire_v(sp), sin_ti, sin_to,
                                     cos_ti, cos_to)
    weight = sp.albedo * _wire_reflectance(sp, wi, wo)
    ok = pdf > 1e-9
    flags = torch.where(ok, FLAG_VALID, 0).to(torch.int32)
    return wo, torch.where(ok[..., None], weight, 0.0), pdf, flags


# ------------------------------------------------------ lambertian fiber

def _lambertian_cylinder(wo):
    """LambertianFiberBcsdf.cpp:21-28."""
    cos_to = trig_inverse(wo[..., 1])
    phi = torch.atan2(wo[..., 0], wo[..., 2])
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    return cos_to * torch.abs(((math.pi - phi) * torch.cos(phi)
                               + torch.sin(phi)) / (4.0 * math.pi))


def lambertian_fiber_eval(sp, wi, wo, ctx):
    return sp.albedo * _lambertian_cylinder(wo)[..., None]


def lambertian_fiber_pdf(sp, wi, wo, ctx):
    return _lambertian_cylinder(wo)


def lambertian_fiber_sample(sp, wi, U, ctx):
    from tungsten_tpu_torch.bsdf.eval import FLAG_VALID, _cosine_hemisphere
    nx = 2.0 * U["lobe"] - 1.0
    nz = trig_inverse(nx)
    d = _cosine_hemisphere(U["u1"], U["u2"])
    wo = torch.stack([d[..., 2] * nx + d[..., 0] * nz,
                      d[..., 1],
                      d[..., 2] * nz - d[..., 0] * nx], dim=-1)
    pdf = _lambertian_cylinder(wo)
    ok = pdf > 1e-9
    flags = torch.where(ok, FLAG_VALID, 0).to(torch.int32)
    return wo, torch.where(ok[..., None], sp.albedo, 0.0), pdf, flags
