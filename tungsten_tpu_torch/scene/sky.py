"""Analytic daylight sky for the `skydome` primitive (port of
tungsten_tpu/scene/sky.py, numpy on the host).

The reference rasterizes a Hosek-Wilkie sky into a lat-long HDR envmap
at prepareForRender and treats it as an infinite sphere
(ref src/core/primitives/Skydome.cpp:292-317; uv convention
Skydome.cpp:37-45, identical to InfiniteSphere).  The model is
Hosek & Wilkie 2012 evaluated from the paper's equations (a quintic
elevation bezier over the published RGB coefficient dataset of
scene/hosek_data.py, F(theta, gamma) with the mie and zenith terms),
`temperature` as a blackbody tint and `intensity` as a radiance scale.
The JAX package falls back to the Preetham model when its dataset is
missing; the port carries its own copy of the dataset, so it has no
fallback.  The arithmetic is the JAX module's, so the baked image is
bit-equal to its.
"""
from __future__ import annotations

import numpy as np

from tungsten_tpu_torch.scene.hosek_data import load_dataset

_XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252]])


def _blackbody_rgb(temp_k: float) -> np.ndarray:
    """Normalized sRGB tint of a blackbody at temp_k relative to 5777 K."""
    def xyz(t):
        # Planck's law sampled over the visible range with CIE fits
        lam = np.linspace(380e-9, 720e-9, 64)
        h, c, kb = 6.62607e-34, 2.99792e8, 1.380649e-23
        rad = 1.0 / (lam ** 5 * (np.exp(h * c / (lam * kb * t)) - 1.0))
        lam_nm = lam * 1e9
        # coarse CIE x-bar/y-bar/z-bar gaussian fits (Wyman et al. 2013)
        def g(x, mu, s1, s2):
            s = np.where(x < mu, s1, s2)
            return np.exp(-0.5 * ((x - mu) / s) ** 2)
        xb = (1.056 * g(lam_nm, 599.8, 37.9, 31.0)
              + 0.362 * g(lam_nm, 442.0, 16.0, 26.7)
              - 0.065 * g(lam_nm, 501.1, 20.4, 26.2))
        yb = (0.821 * g(lam_nm, 568.8, 46.9, 40.5)
              + 0.286 * g(lam_nm, 530.9, 16.3, 31.1))
        zb = (1.217 * g(lam_nm, 437.0, 11.8, 36.0)
              + 0.681 * g(lam_nm, 459.0, 26.0, 13.8))
        return np.array([(rad * xb).sum(), (rad * yb).sum(),
                         (rad * zb).sum()])
    a = xyz(max(temp_k, 1000.0))
    b = xyz(5777.0)
    rgb_a = _XYZ_TO_SRGB @ (a / max(a[1], 1e-30))
    rgb_b = _XYZ_TO_SRGB @ (b / max(b[1], 1e-30))
    tint = np.maximum(rgb_a, 0.0) / np.maximum(rgb_b, 1e-6)
    return tint / max(tint.max(), 1e-6) * tint.max() / max(tint[1], 1e-6)


def _hosek_config(cfg, rad, turbidity, albedo, elevation):
    """Cook the 9 Hosek params + radiance scale per channel (the
    paper's quintic bezier over elevation^(1/3), bilinear over
    turbidity/albedo; structure as ArHosekSkyModel_CookConfiguration).
    cfg (3,2,10,6,9), rad (3,2,10,6) -> (3,9), (3,)."""
    t = float(np.clip(turbidity, 1.0, 10.0))
    ti = min(int(t), 10)
    tr = t - ti
    a = float(np.clip(albedo, 0.0, 1.0))
    x = (max(elevation, 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)
    bez = np.array([
        (1 - x) ** 5, 5 * (1 - x) ** 4 * x, 10 * (1 - x) ** 3 * x * x,
        10 * (1 - x) ** 2 * x ** 3, 5 * (1 - x) * x ** 4, x ** 5])

    def cook(arr):
        # arr (3, 2, 10, 6, P) or (3, 2, 10, 6)
        if arr.ndim == 4:
            arr = arr[..., None]
        lo = np.einsum("k,acke->ace", bez, arr[:, :, ti - 1])
        out = (1 - a) * (1 - tr) * lo[:, 0] + a * (1 - tr) * lo[:, 1]
        if ti < 10:
            hi = np.einsum("k,acke->ace", bez, arr[:, :, ti])
            out = out + (1 - a) * tr * hi[:, 0] + a * tr * hi[:, 1]
        return out

    return cook(cfg), cook(rad)[:, 0]


def _hosek_image(dirs, sun, turbidity, intensity, temperature,
                 gamma_scale):
    """Evaluate the Hosek-Wilkie RGB model over direction grid `dirs`
    (H, W, 3).  F(theta, gamma) = (1 + A e^{B/(cos+0.01)}) *
    (C + D e^{E gamma} + F cos^2 gamma + G chi(H, gamma) +
    I sqrt(cos theta)), chi = (1 + cos^2)/(1 + H^2 - 2 H cos)^1.5
    (the paper's eq. 3 / GetRadianceInternal)."""
    cfg, radd = load_dataset()
    elevation = np.arcsin(np.clip(sun[1], -1.0, 1.0))
    C, R = _hosek_config(cfg, radd, turbidity, 0.2, max(elevation, 0.0))

    cos_t = np.clip(dirs[..., 1], 0.0, 1.0)
    cos_g = np.clip(dirs @ sun, -1.0, 1.0)
    gamma = np.clip(np.arccos(cos_g) * gamma_scale, 0.0, np.pi)
    cg = np.cos(gamma)

    rgb = np.zeros(dirs.shape[:-1] + (3,))
    for c in range(3):
        # param order per GetRadianceInternal: [0]=A [1]=B [2]=C [3]=D
        # [4]=E (exp gamma) [5]=F (cos^2) [6]=G (mie) [7]=I (zenith)
        # [8]=H (mie anisotropy)
        A, B, Cc, D, E, F, G, I, Hh = C[c]
        chi = (1.0 + cg * cg) / np.power(
            np.maximum(1.0 + Hh * Hh - 2.0 * Hh * cg, 1e-9), 1.5)
        f = (1.0 + A * np.exp(B / (cos_t + 0.01))) * \
            (Cc + D * np.exp(E * gamma) + F * cg * cg + G * chi
             + I * np.sqrt(cos_t))
        rgb[..., c] = np.maximum(R[c] * f, 0.0)
    # calibration into render units: the RGB dataset yields absolute
    # spectral-radiance-integrated values; 0.015 brings the default sky
    # (turbidity 3, intensity 2) into the envmap range the reference's
    # XYZ-weighted bake produces
    scale = 0.015 * float(intensity)
    rgb = rgb * scale * _blackbody_rgb(float(temperature))[None, None, :]
    return rgb


def generate_sky(sun_dir, turbidity=3.0, intensity=2.0, temperature=5777.0,
                 gamma_scale=1.0, width=512, height=256) -> np.ndarray:
    """Bake a lat-long HDR sky image.

    Image convention matches Skydome::directionToUV: u = atan2(z, x) /
    2pi + 0.5, v = acos(-y) / pi, so row 0 looks down and row H-1 up.
    Rows below the horizon are black except two rows copied from just
    above it (Skydome.cpp:310-311).
    """
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / max(np.linalg.norm(sun), 1e-9)
    theta_s = np.arccos(np.clip(sun[1], -1.0, 1.0))
    theta_s = min(theta_s, np.pi / 2 - 1e-3)  # model defined above horizon
    T = float(np.clip(turbidity, 1.2, 10.0))

    # row 0 = zenith: bitmap sampling flips v (sample_bitmap reads row
    # (1 - v) * h and v = acos(-y)/pi puts the zenith at v = 1)
    v = 1.0 - (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    theta = v * np.pi                      # angle from "down"
    phi = (u - 0.5) * 2.0 * np.pi
    y = -np.cos(theta)                     # world up component
    sin_t = np.sin(theta)
    dirs = np.zeros((height, width, 3))
    dirs[..., 0] = sin_t[:, None] * np.cos(phi)[None, :]
    dirs[..., 1] = y[:, None]
    dirs[..., 2] = sin_t[:, None] * np.sin(phi)[None, :]

    rgb = _hosek_image(dirs, sun, T, intensity, temperature, gamma_scale)
    above = dirs[..., 1] > 0.0
    rgb = np.where(above[..., None], rgb, 0.0)
    # horizon smoothing: copy the last above-horizon row into the two
    # rows just below it (ref Skydome.cpp:310-311)
    h2 = height // 2
    rgb[h2:min(h2 + 2, height)] = rgb[h2 - 1]
    return rgb.astype(np.float32)
