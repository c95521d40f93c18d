"""Path-element inversion beyond BSDFs (port of tungsten_tpu/integrators/
invert_path.py): camera direction, emitter position, light choice,
medium distance.

The other inversion interfaces the reference defines for reversible-jump
MLT (ref Primitive::invertPosition/invertDirection, Primitive.hpp:59-101;
Medium::invertDistance, Medium.hpp:29-74; Camera::invertPosition/
invertDirection, Camera.hpp:74-106): each maps a concrete path element
back to the primary-sample-space uniforms that regenerate it under this
package's samplers,

    regenerate(invert(x)) == x      on the deterministic coordinates.

Discrete preimage choices consume `mu` untracked uniforms.  An inversion
that cannot recover a coordinate exactly reports valid False.
"""
from __future__ import annotations

import torch

from tungsten_tpu_torch.integrators.lights import _choose_light_weights
from tungsten_tpu_torch.media.transmittance import T_EXPONENTIAL


def invert_camera_direction(scene, settings, d_world):
    """Pinhole inverse of the camera's direction mapping: world direction
    -> (pixel (R,) int32, u1, u2, valid).  The box and dirac filters
    invert (jitter u = f + 0.5); other filters and cameras report valid
    False.  Ref PinholeCamera::invertDirection (PinholeCamera.cpp:94-99)."""
    R = d_world.shape[0]
    dev = d_world.device
    w, h = settings.width, settings.height
    local = d_world @ scene.cam_mat[:3, :3]        # R^T = inverse rotation
    lz = local[..., 2]
    ok = lz > 1e-6
    scale = torch.where(ok, scene.cam_plane_dist / torch.clamp(lz, min=1e-6),
                        0.0)
    lx = local[..., 0] * scale
    ly = local[..., 1] * scale
    ratio = h / w
    fx_px = (lx + 1.0) * (0.5 * w) - 0.5           # px + fx
    fy_px = (ratio - ly) * (0.5 * w) - 0.5         # py + fy
    px = torch.clamp(torch.round(fx_px).to(torch.int32), 0, w - 1)
    py = torch.clamp(torch.round(fy_px).to(torch.int32), 0, h - 1)
    fx = fx_px - px
    fy = fy_px - py
    if settings.filter in ("box", "dirac"):
        u1 = torch.clamp(fx + 0.5, 0.0, 1.0)
        u2 = torch.clamp(fy + 0.5, 0.0, 1.0)
        ok = ok & (torch.abs(fx) <= 0.5 + 1e-4) & (torch.abs(fy) <= 0.5 + 1e-4)
    else:
        u1 = torch.zeros((R,), dtype=torch.float32, device=dev)
        u2 = torch.zeros((R,), dtype=torch.float32, device=dev)
        ok = torch.zeros((R,), dtype=torch.bool, device=dev)
    pixel = (py * w + px).to(torch.int32)
    ok = ok & (settings.camera_type == "pinhole")
    return pixel, u1, u2, ok


def invert_area_light_point(scene, light_idx, tri, b1, b2, mu):
    """Inverse of area_light_sample's position coordinates: given the hit
    triangle (global id) and its barycentrics (b1, b2) over (e1, e2),
    (u_tri, u1, u2, valid) such that sampling with them regenerates the
    same point (ref TriangleMesh::invertPosition).  The alias pick is
    inverted through the triangle's own bin (u_tri in [k, k + prob) /
    cnt); mu is the coordinate within it.  valid False where the
    triangle is not part of the light."""
    off = scene.light_tri_off[light_idx]
    cnt = torch.clamp(scene.light_tri_cnt[light_idx], min=1)
    slot = scene.lt_slot[torch.clamp(tri, 0, scene.lt_slot.shape[0] - 1)
                         .long()]
    k = slot - off
    ok = (slot >= 0) & (k >= 0) & (k < cnt)
    prob = scene.lt_prob[torch.clamp(slot, 0, scene.lt_prob.shape[0] - 1)
                         .long()]
    u_tri = (k.to(torch.float32) + mu * torch.clamp(prob, min=1e-6)) / \
        cnt.to(torch.float32)
    # a = 1 - su, b = (1 - u2) * su  with su = sqrt(u1)
    su = torch.clamp(1.0 - b1, 1e-6, 1.0)
    u1 = su * su
    u2 = 1.0 - torch.clamp(b2 / su, 0.0, 1.0)
    ok = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0 + 1e-5)
    return u_tri, u1, u2, ok


def invert_choose_light(scene, settings, p, li, mu):
    """Inverse of lights.choose_light: (u_sel in the CDF bin of light li
    as seen from p, valid); mu is the coordinate within the bin.  A scene
    with one light accepts any u_sel."""
    R = p.shape[0]
    nl = settings.num_lights
    if nl <= 1:
        return mu, torch.ones((R,), dtype=torch.bool, device=p.device)
    w, total = _choose_light_weights(scene, settings, p)
    cdf = torch.cumsum(w, dim=-1)
    li_c = torch.clamp(li, 0, nl - 1).long()
    lo = torch.where(li_c > 0, torch.gather(
        cdf, -1, torch.clamp(li_c - 1, min=0)[..., None])[..., 0], 0.0)
    w_i = torch.gather(w, -1, li_c[..., None])[..., 0]
    u_sel = (lo + mu * torch.clamp(w_i, min=1e-12)) / \
        torch.clamp(total, min=1e-30)
    ok = (li >= 0) & (li < nl) & (w_i > 0.0)
    return torch.clamp(u_sel, 0.0, 1.0 - 1e-7), ok


def invert_medium_distance(ttype, params, start_on_surface, t_unit):
    """Inverse of transmittance.sample_distance for the exponential law:
    unit-optical-depth distance -> (u1, valid) (ref Medium::invertDistance,
    Medium.hpp:29-74).  Other laws report valid False."""
    u1 = 1.0 - torch.exp(-t_unit)
    ok = (ttype == T_EXPONENTIAL) & (t_unit >= 0.0)
    return torch.clamp(u1, 0.0, 1.0 - 1e-7), ok
