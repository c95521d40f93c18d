"""Heterogeneous media: dense voxel grids and the analytic exponential
and atmosphere falloffs (port of tungsten_tpu/media/grid.py).

Counterpart of ref src/core/media/VoxelMedium.cpp, ExponentialMedium.cpp,
AtmosphericMedium.cpp and the Grid abstraction (src/core/grids/Grid.hpp,
VdbGrid.hpp:16-44):

  * Grids live on the device as dense (nx,ny,nz) float32 bricks with an
    affine world->index transform per grid (the reference's sparse VDB
    tree becomes a dense padded brick).  Lookups are trilinear gathers
    (8 taps).
  * Optical depth (`unit_tau`) follows settings.voxel_integration:
    fixed-count midpoint raymarching over the ray/grid segment
    (settings.grid_steps, the default), residual ratio tracking over the
    majorant supergrid, or the exact voxel-boundary DDA (linear or
    nearest).  Distance sampling (`inverse_unit_tau`) inverts the same
    march, or the DDA with settings.voxel_sampling.
  * The exponential and atmosphere closed forms stay analytic.

The voxel work runs on the lanes whose medium uses that grid only (one
`nonzero` a grid and call); a lane's result does not depend on which
other lanes run beside it.  The raymarch evaluates its steps as one
(lanes, steps) batch, in chunks of at most CHUNK_POINTS taps, and its
inversion finds the crossing step with a cumulative sum.  The tracking
and DDA loops stop once every lane is done, checked every CHECK_EVERY
iterations: an iteration over finished lanes changes nothing, so they
stop at the JAX package's count or later, never earlier.

Medium kinds (FlatScene.med_kind): MED_HOMOGENEOUS (density 1), MED_
EXPONENTIAL (med_exp_params [falloff_scale, unit_point xyz, falloff_dir
xyz, pad]), MED_VOXEL (med_grid indexes the grid_* tuples), MED_
ATMOSPHERE (med_exp_params [s_eff, center xyz, radius, ...]).
"""
from __future__ import annotations

import torch

from tungsten_tpu_torch.utils import rng
from tungsten_tpu_torch.utils.vecmath import clip

MED_HOMOGENEOUS = 0
MED_EXPONENTIAL = 1
MED_VOXEL = 2
MED_ATMOSPHERE = 3
SUPERGRID_SUB = 8    # voxels per majorant supercell axis

INF = 3.0e38
SQRT_PI = 1.7724538509055159
CHUNK_POINTS = 1 << 22   # raymarch taps evaluated per batch
CHECK_EVERY = 8          # loop iterations between all-done checks


# ------------------------------------------------------------- trilinear

def trilinear(grid, p):
    """Trilinear sample of a dense grid at index-space points.
    grid: (nx,ny,nz) or (nx,ny,nz,C); p: (...,3) index coords.  Points
    outside [0, n-1] clamp (the flatten step zero-pads one border voxel
    so clamping reads zero density outside the active region)."""
    nx, ny, nz = grid.shape[:3]
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=p.device)
    p = torch.minimum(torch.clamp(p, min=0.0), dims.float() - 1.0 - 1e-4)
    i0 = torch.floor(p).to(torch.int32)
    f = p - i0
    i1 = torch.minimum(i0 + 1, dims - 1)
    flat = grid.reshape((nx * ny * nz,) + tuple(grid.shape[3:]))
    x0, y0, z0 = (i0[..., k].long() for k in range(3))
    x1, y1, z1 = (i1[..., k].long() for k in range(3))

    def tap(ix, iy, iz):
        return flat[(ix * ny + iy) * nz + iz]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    if grid.ndim == 4:
        fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]
    c00 = tap(x0, y0, z0) * (1 - fx) + tap(x1, y0, z0) * fx
    c10 = tap(x0, y1, z0) * (1 - fx) + tap(x1, y1, z0) * fx
    c01 = tap(x0, y0, z1) * (1 - fx) + tap(x1, y0, z1) * fx
    c11 = tap(x0, y1, z1) * (1 - fx) + tap(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _linear(m, x):
    """x (...,3) through the 3x3 part of m, as three multiply-adds a row
    (a lane's result does not depend on the batch it is in, as a
    matmul's blocking may make it)."""
    return x[..., 0:1] * m[:, 0] + x[..., 1:2] * m[:, 1] + \
        x[..., 2:3] * m[:, 2]


def _affine(scene, g, o, d):
    """World rays -> grid g's index space: (origin, direction)."""
    m = scene.grid_w2g[g]
    return _linear(m, o) + m[:, 3], _linear(m, d)


def _to_grid(scene, g, p):
    """World points (...,3) -> index coords of grid g."""
    m = scene.grid_w2g[g]
    return _linear(m, p) + m[:, 3]


def _safe_dir(dg):
    return torch.where(torch.abs(dg) < 1e-12,
                       torch.where(dg >= 0, 1e-12, -1e-12), dg)


def _grid_segment(scene, g, o, d, t_max):
    """Clip world-space rays to grid g's bounds.  Returns (t0, t1) world
    parameters with t1 <= t_max; empty segments have t1 <= t0."""
    og, dg = _affine(scene, g, o, d)
    dims = torch.tensor(scene.grid_density[g].shape[:3], dtype=torch.float32,
                        device=o.device) - 1.0
    inv = 1.0 / _safe_dir(dg)
    ta = (0.0 - og) * inv
    tb = (dims - og) * inv
    t0 = torch.amax(torch.minimum(ta, tb), dim=-1)
    t1 = torch.amin(torch.maximum(ta, tb), dim=-1)
    return torch.clamp(t0, min=0.0), torch.minimum(t1, t_max)


def _on_lanes(sel, fn, *xs):
    """Run fn on the lanes where sel holds; returns (lane index, fn's
    outputs on those lanes) or None when no lane is selected."""
    idx = torch.nonzero(sel).squeeze(1)
    if idx.numel() == 0:
        return None
    return idx, fn(*(x[idx] for x in xs))


def _grid_lanes(scene, mi, g, active=None):
    sel = (scene.med_kind[mi] == MED_VOXEL) & (scene.med_grid[mi] == g)
    return sel if active is None else sel & active


# -------------------------------------------------- exponential (analytic)

def _exp_xdx(scene, mi, o, d):
    prm = scene.med_exp_params[mi]
    fs = prm[..., 0]
    x = fs * torch.sum((o - prm[..., 1:4]) * prm[..., 4:7], dim=-1)
    dx = fs * torch.sum(d * prm[..., 4:7], dim=-1)
    return x, dx


def _nz(dx):
    return torch.where(torch.abs(dx) < 1e-12, 1e-12, dx)


def _exp_density_integral(x, dx, t_max):
    """ref ExponentialMedium::densityIntegral (lines 85-93)."""
    ex = torch.exp(-x)
    inf_case = ex / _nz(dx)
    zero_case = ex * t_max
    safe_t = torch.where(t_max >= INF, 0.0, t_max)
    gen_case = (ex - torch.exp(-dx * safe_t - x)) / _nz(dx)
    out = torch.where(torch.abs(dx) < 1e-12, zero_case, gen_case)
    return torch.where(t_max >= INF, torch.where(dx > 0, inf_case, INF), out)


def _exp_inverse(x, dx, tau):
    """ref ExponentialMedium::inverseOpticalDepth (lines 95-104)."""
    lin = tau / torch.clamp(torch.exp(-x), min=1e-30)
    denom = 1.0 - dx * torch.exp(x) * tau
    gen = torch.where(denom <= 0.0, INF,
                      -torch.log(torch.clamp(denom, min=1e-30)) / _nz(dx))
    return torch.where(torch.abs(dx) < 1e-12, lin, gen)


# ------------------------------------------------- atmosphere (analytic)
#
# Gaussian shell density rho(p) = exp(-s^2 (|p-c|^2 - r^2)) with
# s = falloff_scale / radius (ref AtmosphericMedium.cpp:62-121), closed
# forms via erf.  The reference returns the absolute coordinate u from
# inverseOpticalDepth; the JAX package converts it back to ray distance
# (t = u - t0), and so does this port.

def _atmo_hu(scene, mi, o, d):
    prm = scene.med_exp_params[mi]
    p = o - prm[..., 1:4]
    t0 = torch.sum(p * d, dim=-1)
    h_sq = torch.clamp(torch.sum(p * p, dim=-1) - t0 * t0, min=0.0)
    return prm[..., 0], prm[..., 4], t0, h_sq


def _atmo_integral(s, r, t0, h_sq, u0, u1):
    """The integral of rho du from u0 to u1 (absolute coords; u1 may be
    INF)."""
    pre = (SQRT_PI * 0.5 / torch.clamp(s, min=1e-20)) * \
        torch.exp((-h_sq + r * r) * s * s)
    hi = torch.where(u1 >= INF, 1.0,
                     torch.special.erf(s * torch.where(u1 >= INF, 0.0, u1)))
    return pre * (hi - torch.special.erf(s * u0))


def _atmo_inverse(s, r, t0, h_sq, tau):
    """Absolute coordinate u whose integral from t0 is tau, INF if
    never."""
    inner = torch.special.erf(s * t0) + (2.0 / SQRT_PI) * \
        torch.exp(s * s * (h_sq - r * r)) * s * tau
    return torch.where(
        inner >= 1.0, INF,
        torch.special.erfinv(clip(inner, -1.0 + 1e-7, 1.0 - 1e-7)) /
        torch.clamp(s, min=1e-20))


# --------------------------------------------------------- dispatch layer

def density(scene, settings, mi, p):
    """Normalized density rho(p) per ray; mi (R,) clipped medium index."""
    kind = scene.med_kind[mi]
    rho = torch.ones(p.shape[:-1], dtype=torch.float32, device=p.device)
    if MED_EXPONENTIAL in settings.med_kinds:
        x, _ = _exp_xdx(scene, mi, p, torch.zeros_like(p))
        rho = torch.where(kind == MED_EXPONENTIAL, torch.exp(-x), rho)
    if MED_ATMOSPHERE in settings.med_kinds:
        prm = scene.med_exp_params[mi]
        sa, r = prm[..., 0], prm[..., 4]
        dist_sq = torch.sum((p - prm[..., 1:4]) ** 2, dim=-1)
        rho = torch.where(kind == MED_ATMOSPHERE,
                          torch.exp(-sa * sa * (dist_sq - r * r)), rho)
    for g in range(len(scene.grid_density)):
        rho_g = trilinear(scene.grid_density[g], _to_grid(scene, g, p))
        rho = torch.where(_grid_lanes(scene, mi, g), rho_g, rho)
    return rho


def emission(scene, settings, mi, p, active=None):
    """Volumetric emission at p (R,3); zero for non-voxel media (and,
    with `active` given, on the lanes it excludes)."""
    out = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    for g in range(len(scene.grid_density)):
        em = scene.grid_emission[g]
        if em.shape[0] == 0:
            continue
        got = _on_lanes(_grid_lanes(scene, mi, g, active),
                        lambda q: trilinear(em, _to_grid(scene, g, q)), p)
        if got is not None:
            out[got[0]] = got[1]
    return out


def _query_rand(o, d, salt, j):
    """Counter RNG keyed on the QUERY (bits of o, d) and the event index:
    transmittance estimates need streams independent of the integrand
    but deterministic per query, so a replayed or resumed path
    reproduces the forward pass bit for bit.  Bit-equal to the JAX
    package's (uint32 words held in int32, as utils/rng.py does)."""
    def b(x):
        return x.contiguous().view(torch.int32)

    v0 = b(o[..., 0]) + b(o[..., 1]) * 3 + b(o[..., 2]) * 7
    v1 = b(d[..., 0]) + b(d[..., 1]) * 3 + b(d[..., 2]) * 7
    x, _, _, _ = rng._pcg4d(v0, v1, rng.u32(salt, o.device),
                            rng.u32(j, o.device))
    return rng._to_unit_float(x)


def _any_left(done, i) -> bool:
    """The loop's all-done check, made every CHECK_EVERY iterations (a
    host sync on CUDA)."""
    return i % CHECK_EVERY != 0 or bool((~done).any())


def _rr_tau_grid(scene, settings, g, o, d, t_max, salt=0x5157):
    """Residual-ratio tracking estimate of the integral of rho over
    [0, t_max] for grid g (ref VdbGrid::opticalDepth ResidualRatio
    branch, VdbGrid.cpp:332-361): walk the majorant supergrid cell by
    cell, accumulate the analytic control integral muC*len, and estimate
    the residual transmittance by ratio tracking with majorant muR.
    Returns tau with E[exp(-tau)] = the true transmittance.  Each
    iteration advances every ray by one event (a tentative collision or
    a supercell crossing)."""
    sup = scene.grid_super[g]                   # (sx,sy,sz,2)
    sx, sy, sz = sup.shape[:3]
    sdim = torch.tensor([sx, sy, sz], dtype=torch.int32, device=o.device)
    sflat = sup.reshape(-1, 2)
    S = float(SUPERGRID_SUB)
    og, dg = _affine(scene, g, o, d)
    dg_safe = _safe_dir(dg)
    t0, t1 = _grid_segment(scene, g, o, d, torch.clamp(t_max, max=INF))
    live0 = t1 > t0

    def cell_state(t):
        """Supercell at parameter t -> (muC, muR, seg_end)."""
        p = og + dg * t[..., None]
        cell = torch.minimum(torch.clamp(torch.floor(p / S).to(torch.int32),
                                         min=0), sdim - 1)
        c = cell.long()
        mu = sflat[(c[..., 0] * sy + c[..., 1]) * sz + c[..., 2]]
        lo = cell.to(torch.float32) * S
        ta = (lo - og) / dg_safe
        tb = (lo + S - og) / dg_safe
        t_exit = torch.amin(torch.maximum(ta, tb), dim=-1)
        seg_end = torch.minimum(torch.maximum(t_exit, t + 1e-6), t1)
        return mu[..., 0], mu[..., 1], seg_end

    # boundary overshoot ~1e-3 voxels: small enough to skip negligible
    # optical depth, large enough that grazing rays change supercells
    eps_t = 1e-3 / torch.clamp(torch.amax(torch.abs(dg), dim=-1), min=1e-12)
    muC, muR, seg_end = cell_state(t0)
    ctrl = torch.where(live0, muC * (seg_end - t0), 0.0)
    t = t0
    logtr = torch.zeros_like(t0)
    done = ~live0
    j = 0
    while j < settings.rr_max_events and _any_left(done, j):
        u = _query_rand(o, d, salt, j)
        jump = -torch.log1p(-torch.clamp(u, max=0.99999994)) / \
            torch.clamp(muR, min=1e-20)
        t_col = t + jump
        collide = ~done & (t_col < seg_end) & (muR > 1e-20)
        # tentative collision: ratio-tracking factor
        rho = trilinear(scene.grid_density[g], og + dg * t_col[..., None])
        factor = 1.0 - (rho - muC) / torch.clamp(muR, min=1e-20)
        logtr = logtr + torch.where(
            collide, torch.log(torch.clamp(factor, min=1e-30)), 0.0)
        # supercell crossing: advance into the next cell, bank its
        # control integral
        cross = ~done & ~collide
        t_new = torch.where(collide, t_col, seg_end + eps_t)
        finished = cross & (seg_end >= t1 - 1e-7)
        done = done | finished
        muC2, muR2, seg2 = cell_state(t_new)
        enter = cross & ~finished
        ctrl = ctrl + torch.where(enter, muC2 * (seg2 - t_new), 0.0)
        muC = torch.where(enter, muC2, muC)
        muR = torch.where(enter, muR2, muR)
        seg_end = torch.where(enter, seg2, seg_end)
        t = torch.where(collide | enter, t_new, t)
        j += 1
    # rays truncated by the event cap close out with the control-only
    # remainder (slight bias only in pathological dense grids)
    ctrl = ctrl + torch.where(~done, muC * torch.clamp(t1 - t, min=0.0), 0.0)
    return torch.where(live0, ctrl - logtr, 0.0)


def _dda_grid(scene, g, o, d, t_max, tau_c=None, nearest=False):
    """Voxel-boundary DDA over grid g, the analog of the reference's
    VdbRaymarcher walks (VdbGrid.cpp:308-331 opticalDepth ExactNearest/
    ExactLinear, :382-430 inverseOpticalDepth).  Each iteration advances
    every ray one voxel-boundary segment:

      * nearest=False ("exact_linear"): trapezoid of the trilinear
        density between consecutive boundary crossings; inversion solves
        the quadratic segment integral for the crossing point (ref
        :404-421).
      * nearest=True ("exact_nearest"): piecewise-constant density of the
        voxel containing each segment (boundaries at half-integer index
        coords, the DdaRay(p + 0.5) shift); inversion is linear.

    With tau_c None returns tau_total; otherwise (t, rho_at_t,
    tau_total) with t = INF where tau_c is never reached."""
    grid = scene.grid_density[g]
    og, dg = _affine(scene, g, o, d)
    dg_safe = _safe_dir(dg)
    t0, t1 = _grid_segment(scene, g, o, d, torch.clamp(t_max, max=INF))
    live0 = t1 > t0
    shift = 0.5 if nearest else 0.0
    nx, ny, nz = grid.shape[:3]
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=o.device)
    # a ray crosses at most sum(dims) + slack boundaries
    max_steps = nx + ny + nz + 8
    eps_t = 1e-4 / torch.clamp(torch.amax(torch.abs(dg), dim=-1), min=1e-12)
    flat = grid.reshape(-1)

    def next_boundary(ta):
        p = og + dg * (ta + eps_t)[..., None] + shift
        base = torch.floor(p)
        target = torch.where(dg >= 0.0, base + 1.0, base) - shift
        tb = torch.amin((target - og) / dg_safe, dim=-1)
        return torch.minimum(torch.maximum(tb, ta + eps_t), t1)

    def f_at(t):
        return trilinear(grid, og + dg * t[..., None])

    def v_mid(ta, tb):
        pm = og + dg * (0.5 * (ta + tb))[..., None]
        idx = torch.minimum(torch.clamp(torch.round(pm).to(torch.int32),
                                        min=0), dims - 1).long()
        return flat[(idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2]]

    ta = t0
    fa = torch.zeros_like(t0) if nearest else f_at(t0)
    integral = torch.zeros_like(t0)
    done = ~live0
    t_hit = torch.full_like(t0, INF)
    rho_hit = torch.zeros_like(t0)
    i = 0
    while i < max_steps and _any_left(done, i):
        tb = next_boundary(ta)
        if nearest:
            v = v_mid(ta, tb)
            delta = v * (tb - ta)
            fb = fa
        else:
            fb = f_at(tb)
            delta = 0.5 * (fa + fb) * (tb - ta)
        if tau_c is not None:
            crosses = ~done & (integral + delta >= tau_c) & (delta > 0.0)
            if nearest:
                x1 = clip((tau_c - integral) / torch.clamp(delta, min=1e-30),
                          0.0, 1.0)
                rho_x = v
            else:
                # solve a/2 x^2 + b x + c = 0 for the in-segment crossing
                # of the trapezoid integral (ref :404-416)
                a = fb - fa
                b = fa
                c = (integral - tau_c) / torch.clamp(tb - ta, min=1e-30)
                lin = -c / torch.where(torch.abs(b) < 1e-20, 1e-20, b)
                mant = torch.clamp(b * b - 2.0 * a * c, min=0.0)
                quad = (-b + torch.sqrt(mant)) / \
                    torch.where(torch.abs(a) < 1e-6, 1e-6, a)
                x1 = clip(torch.where(torch.abs(a) < 1e-6, lin, quad), 0.0,
                          1.0)
                rho_x = fa + (fb - fa) * x1
            t_hit = torch.where(crosses, ta + (tb - ta) * x1, t_hit)
            rho_hit = torch.where(crosses, rho_x, rho_hit)
            done = done | crosses
        integral = integral + torch.where(done, 0.0, delta)
        done = done | (tb >= t1 - eps_t)
        ta, fa = tb, fb
        i += 1
    integral = torch.where(live0, integral, 0.0)
    if tau_c is None:
        return integral
    return t_hit, rho_hit, integral


def _march_rho(scene, settings, g, o, d, t_max):
    """The fixed-step raymarch's density samples: (t0, dt, rho (R, n))
    at the midpoints t0 + (i + 0.5) dt of the ray/grid segment."""
    t0, t1 = _grid_segment(scene, g, o, d, torch.clamp(t_max, max=INF))
    n = settings.grid_steps
    dt = torch.clamp(t1 - t0, min=0.0) / n
    R = o.shape[0]
    k = max(1, min(n, CHUNK_POINTS // max(R, 1)))
    parts = []
    for s0 in range(0, n, k):
        steps = torch.arange(s0, min(n, s0 + k), dtype=torch.float32,
                             device=o.device) + 0.5
        ts = t0[:, None] + steps * dt[:, None]
        pts = o[:, None, :] + d[:, None, :] * ts[..., None]
        parts.append(trilinear(scene.grid_density[g],
                               _to_grid(scene, g, pts)))
    return t0, dt, torch.cat(parts, dim=1)


def _march_tau(scene, settings, g, o, d, t_max):
    _, dt, rho = _march_rho(scene, settings, g, o, d, t_max)
    return torch.sum(rho, dim=-1) * dt


def _march_inverse(scene, settings, g, o, d, t_max, tau_c):
    """Invert the raymarch: the first step whose running optical depth
    reaches tau_c, linearly interpolated inside it (the batched
    VdbGrid::inverseOpticalDepth).  Returns (t, rho, tau_total)."""
    t0, dt, rho = _march_rho(scene, settings, g, o, d, t_max)
    step = rho * dt[:, None]
    cum = torch.cumsum(step, dim=1)
    reach = cum >= tau_c[:, None]
    found = reach.any(dim=1)
    i = torch.argmax(reach.to(torch.int32), dim=1)
    before = torch.gather(cum - step, 1, i[:, None])[:, 0]
    rho_i = torch.gather(rho, 1, i[:, None])[:, 0]
    frac = (tau_c - before) / torch.clamp(rho_i * dt, min=1e-30)
    t_c = t0 + i.to(torch.float32) * dt + clip(frac, 0.0, 1.0) * dt
    return (torch.where(found, t_c, INF), torch.where(found, rho_i, 0.0),
            cum[:, -1])


def unit_tau(scene, settings, mi, o, d, t_max, active=None):
    """The integral of rho over [0, t_max] per ray (world measure).
    Homogeneous media return t_max itself (rho = 1).  Voxel grids use
    settings.voxel_integration: "residual_ratio" (unbiased tracking over
    the majorant supergrid), "exact_linear" / "exact_nearest" (DDA) or
    "raymarching" (fixed-step midpoint quadrature).  `active` (R,) bool,
    when given, limits the voxel work to those lanes; the others get the
    homogeneous value."""
    kind = scene.med_kind[mi]
    tau = torch.clamp(t_max, max=INF)
    if MED_EXPONENTIAL in settings.med_kinds:
        x, dx = _exp_xdx(scene, mi, o, d)
        tau = torch.where(kind == MED_EXPONENTIAL,
                          _exp_density_integral(x, dx, t_max), tau)
    if MED_ATMOSPHERE in settings.med_kinds:
        sa, r, t0, h_sq = _atmo_hu(scene, mi, o, d)
        u1 = torch.where(t_max >= INF, INF, t0 + t_max)
        tau = torch.where(kind == MED_ATMOSPHERE,
                          _atmo_integral(sa, r, t0, h_sq, t0, u1), tau)
    method = settings.voxel_integration
    for g in range(len(scene.grid_density)):
        if method == "residual_ratio" and len(scene.grid_super) > g:
            def fn(o_, d_, t_):
                return _rr_tau_grid(scene, settings, g, o_, d_, t_)
        elif method in ("exact_linear", "exact_nearest"):
            def fn(o_, d_, t_):
                return _dda_grid(scene, g, o_, d_, t_,
                                 nearest=method == "exact_nearest")
        else:
            def fn(o_, d_, t_):
                return _march_tau(scene, settings, g, o_, d_, t_)
        got = _on_lanes(_grid_lanes(scene, mi, g, active), fn, o, d, t_max)
        if got is not None:
            tau = tau.index_put((got[0],), got[1])
    return tau


def inverse_unit_tau(scene, settings, mi, o, d, t_max, tau_c, active=None):
    """Invert the integral of rho dt = tau_c along the ray.  Returns (t,
    rho_at_t, tau_total) where rays that never reach tau_c within
    [0, t_max] and the grid get t = INF and tau_total = the full
    segment's optical depth (VdbGrid::inverseOpticalDepth /
    ExponentialMedium::inverseOpticalDepth semantics).  `active` as in
    unit_tau."""
    kind = scene.med_kind[mi]
    # homogeneous: t = tau_c directly
    t_out = tau_c
    rho_out = torch.ones_like(tau_c)
    tau_tot = torch.clamp(t_max, max=INF)

    if MED_EXPONENTIAL in settings.med_kinds:
        x, dx = _exp_xdx(scene, mi, o, d)
        t_e = _exp_inverse(x, dx, tau_c)
        is_e = kind == MED_EXPONENTIAL
        t_out = torch.where(is_e, t_e, t_out)
        rho_out = torch.where(
            is_e, torch.exp(-(x + dx * torch.minimum(t_e, t_max))), rho_out)
        tau_tot = torch.where(is_e, _exp_density_integral(x, dx, t_max),
                              tau_tot)

    if MED_ATMOSPHERE in settings.med_kinds:
        sa, r, t0, h_sq = _atmo_hu(scene, mi, o, d)
        u = _atmo_inverse(sa, r, t0, h_sq, tau_c)
        u_clip = torch.minimum(torch.where(u >= INF, 0.0, u),
                               t0 + torch.clamp(t_max, max=INF))
        u1 = torch.where(t_max >= INF, INF, t0 + t_max)
        is_a = kind == MED_ATMOSPHERE
        t_out = torch.where(is_a, torch.where(u >= INF, INF, u - t0), t_out)
        rho_out = torch.where(
            is_a, torch.exp(-sa * sa * (h_sq - r * r + u_clip * u_clip)),
            rho_out)
        tau_tot = torch.where(is_a, _atmo_integral(sa, r, t0, h_sq, t0, u1),
                              tau_tot)

    method = settings.voxel_sampling
    for g in range(len(scene.grid_density)):
        if method in ("exact_linear", "exact_nearest"):
            def fn(o_, d_, t_, c_):
                return _dda_grid(scene, g, o_, d_, t_, tau_c=c_,
                                 nearest=method == "exact_nearest")
        else:
            def fn(o_, d_, t_, c_):
                return _march_inverse(scene, settings, g, o_, d_, t_, c_)
        got = _on_lanes(_grid_lanes(scene, mi, g, active), fn, o, d, t_max,
                        tau_c)
        if got is not None:
            idx, (t_g, rho_g, tau_g) = got
            t_out = t_out.index_put((idx,), t_g)
            rho_out = rho_out.index_put((idx,), rho_g)
            tau_tot = tau_tot.index_put((idx,), tau_g)
    return t_out, rho_out, tau_tot

