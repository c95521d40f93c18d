"""Camera ray generation, reconstruction filters, tonemapping (port of
tungsten_tpu/cameras/camera.py; pinhole camera, dirac/box/tent filters).

Pinhole parity (ref PinholeCamera.cpp:70-88): local ray direction
through pixel (x, y) with a filter-importance-sampled subpixel offset,
using pixelSize.x for both axes; weight 1 because the filter is
sampled proportionally.  Tonemaps follow ref Tonemap.hpp:25-45.
"""
from __future__ import annotations

import numpy as np
import torch

from tungsten_tpu_torch.utils import rng

FILTER_WIDTHS = {"dirac": 0.0, "box": 0.5, "tent": 1.0}


def filter_eval(name: str, x):
    """Filter profile f(x), numpy (ref ReconstructionFilter::eval)."""
    x = np.abs(np.asarray(x, np.float64))
    if name == "box":
        return np.where(x <= 0.5, 1.0, 0.0)
    if name == "tent":
        return np.maximum(1.0 - x, 0.0)
    if name == "dirac":
        return np.zeros_like(x)
    raise NotImplementedError(
        f"tungsten_tpu_torch: reconstruction filter {name!r} is not ported "
        f"yet")


def filter_sample(filter_name: str, u):
    """Inverse-CDF sample of the reconstruction filter, in pixels:
    u in [0,1) -> signed offset in [-width, width]."""
    if filter_name == "dirac":
        return torch.zeros_like(u)
    if filter_name == "box":
        return u - 0.5
    if filter_name == "tent":
        lo = torch.sqrt(torch.clamp(2.0 * u, min=0.0)) - 1.0
        hi = 1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * u, min=0.0))
        return torch.where(u < 0.5, lo, hi)
    raise NotImplementedError(
        f"tungsten_tpu_torch: reconstruction filter {filter_name!r} is not "
        f"ported yet")


def generate_rays_w(scene, settings, pixel, sample_idx, seed):
    """pixel (R,) linear index, sample_idx (R,) -> (o, d, weight (R,)) for
    a pinhole camera.  The subpixel offset is addressed by (pixel,
    sample) through the counter RNG."""
    if settings.camera_type != "pinhole":
        raise NotImplementedError(
            f"tungsten_tpu_torch: camera {settings.camera_type!r} is not "
            f"ported yet")
    w = settings.width
    px = (pixel % w).to(torch.float32)
    py = torch.div(pixel, w, rounding_mode="floor").to(torch.float32)
    u1, u2 = rng.random_2d(seed, pixel, sample_idx, rng.DIM_CAMERA,
                           sobol=settings.stratified_sampler)
    fx = filter_sample(settings.filter, u1)
    fy = filter_sample(settings.filter, u2)
    inv_w = 1.0 / w
    # aspect ratio follows the render resolution (ref Camera::precompute)
    ratio = settings.height / settings.width
    lx = -1.0 + (px + 0.5 + fx) * (2.0 * inv_w)
    ly = ratio - (py + 0.5 + fy) * (2.0 * inv_w)
    lz = torch.broadcast_to(scene.cam_plane_dist, lx.shape)
    local = torch.stack([lx, ly, lz], dim=-1)
    local = local / torch.linalg.vector_norm(local, dim=-1, keepdim=True)
    d = local @ scene.cam_mat[:3, :3].T
    o = torch.broadcast_to(scene.cam_mat[:3, 3], d.shape)
    return o, d, torch.ones(d.shape[:1], dtype=d.dtype, device=d.device)


def tonemap(name: str, c):
    if name == "linear":
        return c
    if name == "gamma":
        return torch.clamp(c, min=0.0) ** (1.0 / 2.2)
    if name == "reinhard":
        return torch.clamp(c / (c + 1.0), min=0.0) ** (1.0 / 2.2)
    if name == "filmic":
        x = torch.clamp(c - 0.004, min=0.0)
        return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    if name == "pbrt":
        c = torch.clamp(c, min=0.0)
        return torch.where(
            c < 0.0031308, 12.92 * c,
            1.055 * torch.clamp(c, min=1e-20) ** (1.0 / 2.4) - 0.055)
    raise ValueError(f"unknown tonemap {name}")


def tonemap_image(name: str, hdr):
    """A linear HDR image (numpy, any float dtype) tonemapped and clipped
    to [0, 1] as float32 numpy, ready for an 8-bit writer."""
    import numpy as np
    c = torch.from_numpy(np.ascontiguousarray(hdr, dtype=np.float32))
    return np.clip(tonemap(name, c).numpy(), 0.0, 1.0)
