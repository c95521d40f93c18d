"""NFOR denoiser (Bitterli et al. 2016), port of tungsten_tpu/tools/
denoiser.py in plain torch tensor code (the JAX package has no Pallas
kernel here): the reference's denoiser app (ref src/denoiser/
denoiser.cpp:38-134, NlMeans.hpp, Regression.cpp).

Pipeline parity with nforDenoiser():
  1. feature cross-prefiltering (NL-means, each half buffer guided by
     the other; F=3, R=5, k=0.5, variance scale 2),
  2. two collaborative first-order regression passes (k = 0.5 and 1.0)
     on the color half buffers with the prefiltered features,
  3. per-pixel MSE estimation + NL-means-filtered bandwidth selection,
  4. second filter pass: feature/color halves combined and a final
     regression.

As in the JAX package: NL-means is a loop over window offsets with
box-filtered patch distances (separable cumsum), and the regression
solves per-pixel dxd normal equations with a batched linear solve,
evaluated at the window center.  The patch weights shift their inputs
through a copy padded by max(F, 8), so the R = 9 windows ask for offsets
beyond the pad; the JAX package's dynamic_slice then wraps a negative
start and clamps it (an offset of -9 reads +8, +9 reads +8).  The port
reproduces that (`_offset_in_pad`), so the two agree.
"""
from __future__ import annotations

import numpy as np
import torch

from tungsten_tpu_torch.ops.segment_sum import ordered_cumsum

EPS = 1e-7
DIST_CLAMP = 1e4


def _box_filter(img, radius: int):
    """Separable (2F+1) box mean over the leading two axes (edge pad)."""
    if radius <= 0:
        return img
    k = 2 * radius + 1
    for axis in (0, 1):
        n = img.shape[axis]
        idx = torch.clamp(torch.arange(-radius, n + radius, device=img.device),
                          0, n - 1)
        c = ordered_cumsum(img.index_select(axis, idx), dim=axis)
        c = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
        img = (c.narrow(axis, k, n) - c.narrow(axis, 0, n)) / k
    return img


def _offsets(R: int):
    return [(dy, dx) for dy in range(-R, R + 1) for dx in range(-R, R + 1)]


def _offset_in_pad(d: int, pad: int, n: int) -> int:
    """The offset a dynamic_slice of the copy padded by `pad` takes for
    offset d: its start pad + d, wrapped when negative, clamped to
    [0, 2 * pad]."""
    s = pad + d
    if s < 0:
        s += n + 2 * pad
    return min(max(s, 0), 2 * pad) - pad


def _shift(img, dy: int, dx: int, pad: int):
    """img[y + dy, x + dx] with edge clamping, read from a copy padded by
    `pad` (see _offset_in_pad)."""
    h, w = img.shape[:2]
    dy = _offset_in_pad(dy, pad, h)
    dx = _offset_in_pad(dx, pad, w)
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(0, ys).index_select(1, xs)


def _nl_weight(guide, var, dy, dx, F, k, var_scale):
    """Rousselle et al. patch weight for offset (dy, dx)
    (ref NlMeans.hpp squaredDist + box filter + exp)."""
    pad = max(F, 8)
    g_q = _shift(guide, dy, dx, pad)
    v_p = var * var_scale
    v_q = _shift(var, dy, dx, pad) * var_scale
    sq = (guide - g_q) ** 2 - (v_p + torch.minimum(v_p, v_q))
    dist = torch.clamp(sq / ((v_p + v_q) * k * k + EPS), max=DIST_CLAMP)
    patch = _box_filter(dist, F)
    if patch.ndim == 3:  # rgb guide -> min-channel weight (convertWeight)
        patch = torch.amax(patch, dim=-1)
    return torch.exp(-torch.clamp(patch, min=0.0))


def nl_means(image, guide, variance, F: int, R: int, k: float,
             var_scale: float = 1.0):
    """NL-means filter of `image` guided by (guide, variance)."""
    acc = torch.zeros_like(image)
    wacc = torch.zeros(image.shape[:2], dtype=image.dtype,
                       device=image.device)
    for dy, dx in _offsets(R):
        w = _nl_weight(guide, variance, dy, dx, F, k, var_scale)
        acc = acc + _shift(image, dy, dx, R) * w[..., None]
        wacc = wacc + w
    return acc / torch.clamp(wacc, min=EPS)[..., None]


def collaborative_regression(image, guide, features, variance,
                             F: int, R: int, k: float):
    """First-order weighted regression (ref Regression.cpp): per pixel,
    fit color ~ 1 + (dx, dy) + (features - center features) over a
    (2R+1)^2 window with NL-means weights, evaluate at the center."""
    h, w = image.shape[:2]
    nf = features.shape[-1] if features is not None else 0
    d = 3 + nf
    dev, dt = image.device, image.dtype
    A = torch.zeros((h, w, d, d), dtype=dt, device=dev)
    b = torch.zeros((h, w, d, 3), dtype=dt, device=dev)
    ones = torch.ones((h, w), dtype=dt, device=dev)
    for dy, dx in _offsets(R):
        wgt = _nl_weight(guide, variance, dy, dx, F, k, 2.0)
        y_q = _shift(image, dy, dx, R)
        parts = [ones, ones * float(dx), ones * float(dy)]
        if nf:
            diff = _shift(features, dy, dx, R) - features
            parts.extend(diff[..., i] for i in range(nf))
        x = torch.stack(parts, dim=-1)                          # (h,w,d)
        A = A + wgt[..., None, None] * (x[..., :, None] * x[..., None, :])
        b = b + wgt[..., None, None] * (x[..., :, None] * y_q[..., None, :])
    A = A + torch.eye(d, dtype=dt, device=dev) * 1e-4          # ridge guard
    beta = torch.linalg.solve(A, b)                            # (h,w,d,3)
    return beta[..., 0, :]                                     # center eval


def nfor_denoise(color_a, color_b, color_var, features_a, features_b,
                 features_var, device=None):
    """Full NFOR pipeline.  colors (H,W,3); features (H,W,NF) scalar
    channels (albedo splits into 3), or None.  numpy in, numpy out; the
    work runs on `device` (None = CUDA, raising when absent)."""
    from tungsten_tpu_torch.device import resolve_device
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    color_a, color_b, color_var = t(color_a), t(color_b), t(color_var)
    color = 0.5 * (color_a + color_b)

    # 1. feature cross-prefiltering (denoiser.cpp:43-53)
    if features_a is not None:
        fa, fb, fv = t(features_a), t(features_b), t(features_var)
        filt_a, filt_b = [], []
        for i in range(fa.shape[-1]):
            a, bq, v = fa[..., i:i + 1], fb[..., i:i + 1], fv[..., i]
            filt_a.append(nl_means(a, bq[..., 0], v, 3, 5, 0.5, 2.0))
            filt_b.append(nl_means(bq, a[..., 0], v, 3, 5, 0.5, 2.0))
        feat_a = torch.cat(filt_a, dim=-1)
        feat_b = torch.cat(filt_b, dim=-1)
    else:
        feat_a = feat_b = None

    # 2. regression passes at k = 0.5, 1.0 (denoiser.cpp:56-84)
    filtered_a, filtered_b, mses = [], [], []
    for k in (0.5, 1.0):
        fca = collaborative_regression(color_a, color_b, feat_b,
                                       color_var, 3, 9, k)
        fcb = collaborative_regression(color_b, color_a, feat_a,
                                       color_var, 3, 9, k)
        mse_a = (color_b - fca) ** 2 - 2.0 * color_var
        mse_b = (color_a - fcb) ** 2 - 2.0 * color_var
        resid = (fcb - fca) ** 2 * 0.25
        noisy_mse = 0.5 * (mse_a + mse_b) - resid
        filtered_a.append(fca)
        filtered_b.append(fcb)
        mses.append(nl_means(noisy_mse, color, color_var, 1, 9, 1.0))

    # 3. bandwidth selection (denoiser.cpp:88-103)
    noisy_sel = (mses[0] >= mses[1]).to(color.dtype)
    sel = torch.clamp(nl_means(noisy_sel, color, color_var, 1, 9, 1.0),
                      0.0, 1.0)
    result_a = filtered_a[0] * (1 - sel) + filtered_a[1] * sel
    result_b = filtered_b[0] * (1 - sel) + filtered_b[1] * sel

    # 4. second filter pass (denoiser.cpp:107-133)
    if feat_a is not None:
        final_feats = []
        for i in range(feat_a.shape[-1]):
            comb = 0.5 * (feat_a[..., i:i + 1] + feat_b[..., i:i + 1])
            comb_var = (feat_b[..., i] - feat_a[..., i]) ** 2 * 0.25
            final_feats.append(nl_means(comb, comb[..., 0], comb_var,
                                        3, 2, 0.5))
        final_feat = torch.cat(final_feats, dim=-1)
    else:
        final_feat = None
    comb = 0.5 * (result_a + result_b)
    comb_var = (result_b - result_a) ** 2 * 0.25
    out = collaborative_regression(comb, comb, final_feat,
                                   comb_var, 3, 9, 1.0)
    return torch.clamp(out, min=0.0).cpu().numpy()


def main(argv=None):
    """CLI: denoise a render directory containing the two-buffer AOV
    outputs (colorA/colorB/variance + albedo/normal/depth halves)."""
    import argparse
    from tungsten_tpu_torch.io import image as im
    ap = argparse.ArgumentParser(description="NFOR denoiser")
    ap.add_argument("color_a")
    ap.add_argument("color_b")
    ap.add_argument("--variance", default=None)
    ap.add_argument("--features-a", nargs="*", default=[])
    ap.add_argument("--features-b", nargs="*", default=[])
    ap.add_argument("--feature-vars", nargs="*", default=[])
    ap.add_argument("-o", "--output", default="denoised.pfm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ca = im.load_hdr(args.color_a)
    cb = im.load_hdr(args.color_b)
    if args.variance:
        cv = im.load_hdr(args.variance)
    else:
        cv = (cb - ca) ** 2 * 0.25
    fa = fb = fv = None
    if args.features_a:
        fa = np.concatenate([np.atleast_3d(im.load_hdr(p))
                             for p in args.features_a], axis=-1)
        fb = np.concatenate([np.atleast_3d(im.load_hdr(p))
                             for p in args.features_b], axis=-1)
        if args.feature_vars:
            fv = np.concatenate([np.atleast_3d(im.load_hdr(p))
                                 for p in args.feature_vars], axis=-1)
        else:
            fv = (fb - fa) ** 2 * 0.25
    out = nfor_denoise(ca, cb, cv, fa, fb, fv, device=args.device)
    im.save_hdr(args.output, out)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
