"""Camera ray generation, reconstruction filters, tonemapping (port of
tungsten_tpu/cameras/camera.py: the pinhole, thinlens, equirectangular
and cubemap cameras, every reconstruction filter).

Pinhole parity (ref PinholeCamera.cpp:70-88): local ray direction
through pixel (x, y) with a filter-importance-sampled subpixel offset,
using pixelSize.x for both axes; weight 1 because the filter is
sampled proportionally.  Dirac, box and tent sample analytically;
gaussian, mitchell_netravali, catmull_rom and lanczos through a host
table of the inverse CDF of max(f, 0) (ReconstructionFilter.hpp:
45-207).  Thinlens (ThinlensCamera.cpp) samples the lens from a disk or
an aperture bitmap's alias table and zeroes cat-eye-vignetted samples;
equirectangular and cubemap follow EquirectangularCamera /
CubemapCamera.cpp:14-53.  Tonemaps follow ref Tonemap.hpp:25-45.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tungsten_tpu_torch.utils import rng

FILTER_WIDTHS = {"dirac": 0.0, "box": 0.5, "tent": 1.0, "gaussian": 2.0,
                 "mitchell_netravali": 2.0, "catmull_rom": 2.0,
                 "lanczos": 2.0}


def filter_eval(name: str, x):
    """Filter profile f(x), numpy (ref ReconstructionFilter::eval)."""
    x = np.abs(np.asarray(x, np.float64))
    if name == "box":
        return np.where(x <= 0.5, 1.0, 0.0)
    if name == "tent":
        return np.maximum(1.0 - x, 0.0)
    if name == "gaussian":
        return np.maximum(np.exp(-2.0 * x * x) - np.exp(-8.0), 0.0)
    if name == "mitchell_netravali":
        B = C = 1.0 / 3.0
        f1 = ((12 - 9 * B - 6 * C) * x ** 3 + (-18 + 12 * B + 6 * C) * x ** 2
              + (6 - 2 * B)) / 6.0
        f2 = ((-B - 6 * C) * x ** 3 + (6 * B + 30 * C) * x ** 2
              + (-12 * B - 48 * C) * x + (8 * B + 24 * C)) / 6.0
        return np.where(x < 1.0, f1, np.where(x < 2.0, f2, 0.0))
    if name == "catmull_rom":
        f1 = (9 * x ** 3 - 15 * x ** 2 + 6) / 6.0
        f2 = (-3 * x ** 3 + 15 * x ** 2 - 24 * x + 12) / 6.0
        return np.where(x < 1.0, f1, np.where(x < 2.0, f2, 0.0))
    if name == "lanczos":
        with np.errstate(invalid="ignore", divide="ignore"):
            f = np.sin(np.pi * x) * np.sin(np.pi * x / 2.0) / \
                (np.pi * np.pi * x * x / 2.0)
        f = np.where(x == 0.0, 1.0, f)
        return np.where(x < 2.0, f, 0.0)
    return np.zeros_like(x)


@functools.lru_cache(maxsize=16)
def _filter_invcdf(name: str, res: int = 256) -> tuple:
    """Tabulated inverse CDF of max(f, 0) over [0, width] (256 entries)."""
    width = FILTER_WIDTHS[name]
    xs = (np.arange(res) + 0.5) * (width / res)
    f = np.maximum(filter_eval(name, xs), 0.0)
    cdf = np.concatenate([[0.0], np.cumsum(f)])
    cdf /= cdf[-1]
    u = np.linspace(0.0, 1.0, 256)
    inv = np.interp(u, cdf, np.arange(res + 1) * (width / res))
    return tuple(inv.astype(np.float32))


def filter_sample(filter_name: str, u):
    """Inverse-CDF sample of the reconstruction filter, in pixels:
    u in [0,1) -> signed offset in [-width, width] (the sign from folding
    u, ref ReconstructionFilter::sample)."""
    if filter_name == "dirac":
        return torch.zeros_like(u)
    if filter_name == "box":
        return u - 0.5
    if filter_name == "tent":
        lo = torch.sqrt(torch.clamp(2.0 * u, min=0.0)) - 1.0
        hi = 1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * u, min=0.0))
        return torch.where(u < 0.5, lo, hi)
    if filter_name not in FILTER_WIDTHS:
        raise ValueError(f"unknown reconstruction filter {filter_name!r}")
    inv = torch.tensor(_filter_invcdf(filter_name), dtype=torch.float32,
                       device=u.device)
    negative = u < 0.5
    xi = torch.where(negative, u * 2.0, (u - 0.5) * 2.0)
    pos = xi * (inv.shape[0] - 1)
    i0 = torch.clamp(pos.to(torch.int32), 0, inv.shape[0] - 2).long()
    frac = pos - i0
    mag = inv[i0] * (1.0 - frac) + inv[i0 + 1] * frac
    return torch.where(negative, -mag, mag)


# cubemap face layouts (ref CubemapCamera.cpp:14-53): modes
# horizontal_cross / vertical_cross / row / column; face order +x -x +y
# -y +z -z; the basis vectors index that same order
_CUBE_BASIS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                        [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
_CUBE_MODES = {"horizontal_cross": 0, "vertical_cross": 1,
               "row": 2, "column": 3}
_CUBE_RES_U = [4, 3, 6, 1]
_CUBE_RES_V = [3, 4, 1, 6]
_CUBE_OFF_U = [[2, 0, 1, 1, 1, 3], [1, 1, 1, 1, 0, 2],
               [0, 1, 2, 3, 4, 5], [0, 0, 0, 0, 0, 0]]
_CUBE_OFF_V = [[1, 1, 0, 2, 1, 1], [1, 3, 0, 2, 1, 1],
               [0, 0, 0, 0, 0, 0], [0, 1, 2, 3, 4, 5]]
_CUBE_BU = [[5, 4, 0, 0, 0, 1], [5, 5, 5, 5, 0, 1],
            [5, 4, 0, 0, 0, 1], [5, 4, 0, 0, 0, 1]]
_CUBE_BV = [[3, 3, 4, 5, 3, 3], [3, 2, 0, 1, 3, 3],
            [3, 3, 4, 5, 3, 3], [3, 3, 4, 5, 3, 3]]


def sample_aperture(scene, settings, u3, u4, u5):
    """Thinlens lens-plane position (R,3) in camera-local space (ref
    ThinlensCamera::samplePosition): a uniform disk by default, or with
    an aperture bitmap an alias-table texel pick (u5) and an in-texel
    jitter, proportional to the texture so the sample weight is 1."""
    if settings.aperture_tex:
        nt = scene.cam_ap_prob.shape[0]
        x = u5 * nt
        idx = torch.clamp(x.to(torch.int32), max=nt - 1)
        f = x - idx
        keep = f < scene.cam_ap_prob[idx.long()]
        texel = torch.where(keep, idx, scene.cam_ap_alias[idx.long()])
        w_ap = scene.cam_ap_hw[1]
        row = torch.div(texel, w_ap, rounding_mode="floor")
        col = texel - row * w_ap
        ax = ((col + u3) / w_ap) * 2.0 - 1.0
        ay = 1.0 - ((row + u4) / scene.cam_ap_hw[0]) * 2.0
        return torch.stack([ax, ay, torch.zeros_like(ax)],
                           dim=-1) * settings.aperture_size
    r = torch.sqrt(u3) * settings.aperture_size
    phi = u4 * (2.0 * math.pi)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r,
                        torch.zeros_like(r)], dim=-1)


def _to_world(scene, local):
    d = local @ scene.cam_mat[:3, :3].T
    return torch.broadcast_to(scene.cam_mat[:3, 3], d.shape), d


def generate_rays_w(scene, settings, pixel, sample_idx, seed, tape=None):
    """pixel (R,) linear index, sample_idx (R,) -> (o, d, weight (R,)).
    The subpixel offset is addressed by (pixel, sample) through the
    counter RNG, or read from `tape` (an rng.Tape) when one is given.  `weight` is 1 except for thinlens samples the cat eye
    vignettes (weight 0: the reference's sampleDirection returns false
    and the sample counts black, ThinlensCamera.cpp:118-123)."""
    smp = rng.sampler(settings, tape)
    w = settings.width
    px = (pixel % w).to(torch.float32)
    py = torch.div(pixel, w, rounding_mode="floor").to(torch.float32)
    u1, u2 = rng.random_2d(seed, pixel, sample_idx, rng.DIM_CAMERA,
                           smp=smp)
    fx = filter_sample(settings.filter, u1)
    fy = filter_sample(settings.filter, u2)
    ones = torch.ones(pixel.shape, dtype=torch.float32, device=pixel.device)
    cam = settings.camera_type

    if cam == "equirectangular":
        # ref EquirectangularCamera::uvToDirection (uv.y from the bottom)
        u = (px + 0.5 + fx) / settings.width
        v = 1.0 - (py + 0.5 + fy) / settings.height
        phi = (u - 0.5) * (2.0 * math.pi)
        theta = (1.0 - v) * math.pi
        sin_t = torch.sin(theta)
        local = torch.stack([torch.cos(phi) * sin_t, -torch.cos(theta),
                             torch.sin(phi) * sin_t], dim=-1)
        o, d = _to_world(scene, local)
        return o, d, ones

    if cam == "cubemap":
        dev = pixel.device
        mode = _CUBE_MODES.get(settings.cubemap_mode, 0)
        fs_u = 1.0 / _CUBE_RES_U[mode]
        fs_v = 1.0 / _CUBE_RES_V[mode]
        u = (px + 0.5 + fx) / settings.width
        v = (py + 0.5 + fy) / settings.height
        off_u = torch.tensor(_CUBE_OFF_U[mode], dtype=torch.float32,
                             device=dev) * fs_u
        off_v = torch.tensor(_CUBE_OFF_V[mode], dtype=torch.float32,
                             device=dev) * fs_v
        base = torch.from_numpy(_CUBE_BASIS).to(dev)
        bu = base[_CUBE_BU[mode]]
        bv = base[_CUBE_BV[mode]]
        du = u[:, None] - off_u[None, :]      # (R, 6)
        dv = v[:, None] - off_v[None, :]
        inside = (du >= 0) & (du <= fs_u) & (dv >= 0) & (dv <= fs_v)
        # the first face that holds the point (argmax of a bool picks
        # the first True, 0 where none)
        face = torch.argmax(inside.to(torch.int32), dim=-1)
        ok = torch.any(inside, dim=-1)
        ou = torch.gather(du, 1, face[:, None])[:, 0] / fs_u
        ov = torch.gather(dv, 1, face[:, None])[:, 0] / fs_v
        local = (base[face] + bu[face] * (ou * 2 - 1)[:, None]
                 + bv[face] * (ov * 2 - 1)[:, None])
        local = local / torch.linalg.vector_norm(local, dim=-1, keepdim=True)
        o, d = _to_world(scene, local)
        # dead zones of the cross layouts get the degenerate direction
        # (0, 1, 0) the JAX package gives them
        d = torch.where(ok[:, None], d,
                        torch.tensor([0.0, 1.0, 0.0], device=dev))
        return o, d, ones

    inv_w = 1.0 / w
    # aspect ratio follows the render resolution (ref Camera::precompute)
    ratio = settings.height / settings.width
    lx = -1.0 + (px + 0.5 + fx) * (2.0 * inv_w)
    ly = ratio - (py + 0.5 + fy) * (2.0 * inv_w)
    lz = torch.broadcast_to(scene.cam_plane_dist, lx.shape)

    if cam == "thinlens":
        # ref ThinlensCamera::sampleDirection: a lens position, the
        # direction through the focus plane
        u3, u4 = rng.random_2d(seed, pixel, sample_idx, rng.DIM_CAMERA + 2,
                               smp=smp)
        # the texel pick's seed is the render seed as a uint32 word xor
        # 0xA9E27 (the JAX package's `seed ^ jnp.uint32(0xA9E27)`)
        u5 = rng.random_1d((int(seed) & 0xFFFFFFFF) ^ 0xA9E27, pixel,
                           sample_idx, rng.DIM_CAMERA + 2, smp=smp)
        lens = sample_aperture(scene, settings, u3, u4, u5)
        plane = torch.stack([lx, ly, lz], dim=-1)
        plane = plane * (settings.focus_distance / plane[..., 2:3])
        local = plane - lens
        local = local / torch.linalg.vector_norm(local, dim=-1, keepdim=True)
        wt = ones
        if settings.cat_eye > 0.0:
            # cat-eye vignetting (ref ThinlensCamera.cpp:118-123): the
            # lens point projected along the ray onto the virtual
            # diaphragm plane; outside the aperture radius -> black
            dia = lens[..., :2] - settings.cat_eye * scene.cam_plane_dist \
                * local[..., :2] / torch.clamp(local[..., 2:3], min=1e-9)
            inside = torch.sum(dia * dia, dim=-1) <= \
                settings.aperture_size ** 2
            wt = torch.where(inside, wt, 0.0)
        d = local @ scene.cam_mat[:3, :3].T
        o = lens @ scene.cam_mat[:3, :3].T + scene.cam_mat[:3, 3]
        return o, d, wt

    if cam != "pinhole":
        raise ValueError(f"unknown camera type {cam!r}")
    local = torch.stack([lx, ly, lz], dim=-1)
    local = local / torch.linalg.vector_norm(local, dim=-1, keepdim=True)
    o, d = _to_world(scene, local)
    return o, d, ones


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
