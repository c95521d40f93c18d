"""Photon mapping and progressive photon mapping (port of
tungsten_tpu/integrators/photon_map.py): the photon pass, the hash-grid
surface map and the three volume maps (points, beams, planes), the
specular camera walk with its gather, and PPM's radius schedule.

  * photon pass (`trace_photons`): a wavefront of light subpaths that
    deposits a photon {pos, incoming dir, power, bounce} at every
    non-pure-specular surface hit and at every medium scatter (with
    sigma_s folded into the power), records a beam per medium segment
    and, in planes mode, a plane per pair of volume vertices.  Powers
    are not yet divided by the number of paths.
  * grids: photons (beam and plane lattice points) sorted by hash-grid
    cell key; a query scans the 27 neighbour cells' first CAP entries
    (CELL_CAP, BEAM_CAP, PLANE_CAP) in the JAX package's order.
  * camera pass (the JAX package's gather_pass, here `camera_walk` and
    `gather_walk`): walk through pure-specular and forward surfaces,
    credit env and emitters, and gather the k nearest photons at the
    first other surface; the points volume map marches the primary
    segment.  `beam_pass` / `plane_pass` add the beams' and
    planes' in-scattering along the primary segment.

Port notes:
  * A photon walk writes its bounce's slot with one indexed write: the
    fields of a slot are packed into one f32 row (bounce and the flags
    as int32 bit patterns).  The walk and the camera walk end when no
    lane is alive (one host read a step); every output is then the
    full loop's.
  * Sorts are stable (jnp.argsort's default).  The 27-cell candidate
    scan is ragged: only the (query, photon) pairs inside the capped
    cell ranges are formed, in groups of query rows of at most
    PAIR_BUDGET pairs, each pair carrying its position in the JAX
    package's dense candidate list (neighbour cell in dx, dy, dz order,
    then its slot).  The k nearest are the first k of a stable sort of
    (row, d2) over those pairs, which is lax.top_k's order (ties to the
    lower position); the sums add each row's pairs in that order.
  * Cell indices take the JAX package's saturating float-to-int32 cast
    (NaN to 0, out-of-range to the int32 ends) before the clip to
    [1, GRID_RES - 3]: the clamp runs in float, then the cast.
  * The grids drop the invalid photons, beams and plane lattice points
    (key 2^31 - 1) before their sort: the JAX package sorts them to the
    tail, where no query key can match them, so the sorted arrays are
    the JAX package's without that tail.
  * A render traces the photon paths of all its rounds in one wave
    (each lane its round's seed) and walks all its rounds' camera lanes
    in one wave (`camera_walk`); each round then gathers its lanes
    against its own grids (`gather_walk`).  Lanes are independent, so
    each round's photons and radiance are those of its own call.
  * Plane-map shadow rays trace only the march rows that hold a
    contribution (K2 on the card); the others are far limit 0 in the
    JAX package.
  * The sampler is `settings.stratified_sampler`, threaded into every
    draw (the JAX package latches it in a module global).
"""
from __future__ import annotations

import math

import torch

from tungsten_tpu_torch.bsdf import types as bt
from tungsten_tpu_torch.bsdf.eval import (FLAG_VALID, ShadePoint, bsdf_eval,
                                          bsdf_forward, bsdf_sample)
from tungsten_tpu_torch.integrators import lights as L
from tungsten_tpu_torch.integrators.bdpt import _sample_light_root
from tungsten_tpu_torch.integrators.path_tracer import (
    EPSILON, INF, _expand_hit, _has_forward_types, _Media, _medium_tr,
    _select_medium, shading_frame)
from tungsten_tpu_torch.media import grid as GR
from tungsten_tpu_torch.media import phase as PH
from tungsten_tpu_torch.media import transmittance as TR
from tungsten_tpu_torch.ops.intersect import bvh_intersect, occluded
from tungsten_tpu_torch.ops.segment_sum import ordered_index_add
from tungsten_tpu_torch.utils import rng
from tungsten_tpu_torch.utils import vecmath as vm

PHOTON_DIM_OFFSET = 8192   # RNG dim family for photon walks
CELL_CAP = 48              # candidate photons scanned per grid cell
GRID_RES = 1024            # max cells per axis (key fits int32)
INVALID_KEY = 2**31 - 1
BEAM_CELLS = 24            # rasterized centerline cells per beam
BEAM_CAP = 32              # candidate beams scanned per grid cell
PLANE_U = 12               # rasterized samples along a plane's first edge
PLANE_V = 24               # rasterized samples along its extrusion
PLANE_CAP = 16             # candidate planes scanned per grid cell
VOL_MARCH_STEPS = 32       # camera-segment march steps for the volume maps
# the ragged candidate scan: query rows per searchsorted block, and the
# most (query, candidate) pairs one group forms
ROW_BLOCK = 1 << 18
PAIR_BUDGET = 1 << 23
# planes rasterized per block in build_plane_grid
PLANE_BLOCK = 1 << 16

# BSDF types whose every lobe is specular: the camera walk passes
# through these and photons are not deposited on them
PURE_SPECULAR_TYPES = (bt.MIRROR, bt.DIELECTRIC, bt.CONDUCTOR)

# neighbour cell offsets in the JAX package's loop order (dx, dy, dz)
_NB = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
       for dz in (-1, 0, 1)]


def _is_pure_specular(scene, settings, bsdf_idx):
    t = scene.bsdf_type[bsdf_idx]
    out = torch.zeros(bsdf_idx.shape, dtype=torch.bool,
                      device=bsdf_idx.device)
    for ty in PURE_SPECULAR_TYPES:
        if ty in settings.present_bsdf_types:
            out = out | (t == ty)
    return out


# ------------------------------------------------------------ photon pass

# the packed slot row: (name, columns, kind) with kind f (f32), i (int32
# bits) or b (bool as int32 bits)
_SURF = (("pos", 3, "f"), ("dir", 3, "f"), ("power", 3, "f"),
         ("bounce", 1, "i"), ("valid", 1, "b"), ("vol", 1, "b"))
_BEAM = (("b_o", 3, "f"), ("b_d", 3, "f"), ("b_len", 1, "f"),
         ("b_pow", 3, "f"), ("b_valid", 1, "b"))
_PLANE = (("pl_p0", 3, "f"), ("pl_p1", 3, "f"), ("pl_d1", 3, "f"),
          ("pl_l1", 1, "f"), ("pl_pow", 3, "f"), ("pl_valid", 1, "b"))


def _pack(vals, layout):
    """One f32 row (R, C) of the slot's fields, ints and bools as int32
    bit patterns."""
    cols = []
    for name, n, kind in layout:
        v = vals[name]
        if kind != "f":
            v = v.to(torch.int32).view(torch.float32)
        cols.append(v.reshape(v.shape[0], n))
    return torch.cat(cols, dim=-1)


def _unpack(rows, layout):
    out, c = {}, 0
    for name, n, kind in layout:
        v = rows[:, c:c + n]
        if kind != "f":
            v = v.contiguous().view(torch.int32)
            if kind == "b":
                v = v != 0
        out[name] = v if n == 3 else v[:, 0]
        c += n
    return out


def _layout(settings):
    beams = settings.has_media and \
        settings.vol_photon_type in ("beams", "planes")
    planes = settings.has_media and settings.vol_photon_type == "planes"
    return _SURF + (_BEAM if beams else ()) + (_PLANE if planes else ())


def slot_bytes(settings) -> int:
    """Bytes of one deposit slot of trace_photons' packed rows."""
    return 4 * sum(n for _, n, _ in _layout(settings))


def _seed_words(seeds, n, dev):
    """Per-lane uint32 seeds as int32 bit patterns, n lanes a seed."""
    words = [((int(x) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
             for x in seeds]
    return torch.tensor(words, dtype=torch.int32,
                        device=dev).repeat_interleave(n)


def trace_photons(scene, settings, n_paths: int, seed):
    """Trace n_paths light subpaths, depositing photons.  Returns a dict
    of (n_paths * B,) tensors (B = max_bounces - 1 deposit slots, path
    major): pos (N,3), dir (N,3) incoming, power (N,3) (not yet divided
    by the path count), bounce, valid, vol; the beam fields b_o, b_d,
    b_len, b_pow, b_valid (zeros unless beams are recorded); in planes
    mode pl_p0, pl_p1, pl_d1, pl_l1, pl_pow, pl_valid; and "rays", the
    walks traced (alive lanes a bounce).  The paths are the JAX
    package's path ids 0..n_paths-1, its chunks of paths in one wave.

    `seed` may be a sequence of seeds: the rounds of a render, traced in
    one wave, each its n_paths paths with its own seed; the slots are
    then round major (each round's block as one call with that seed
    gives it) and "rays" their sum."""
    rounds = list(seed) if isinstance(seed, (list, tuple)) else None
    R = n_paths * (len(rounds) if rounds else 1)
    B = max(settings.max_bounces - 1, 1)
    dev = scene.device
    sobol = settings.stratified_sampler
    types = settings.present_bsdf_types
    has_media = settings.has_media
    has_fwd = _has_forward_types(settings)
    planes_mode = settings.vol_photon_type == "planes"
    layout = _layout(settings)
    beams = any(name == "b_o" for name, _, _ in layout)
    ncol = sum(n for _, n, _ in layout)
    pixel = torch.arange(n_paths, dtype=torch.int32, device=dev)
    if rounds:
        pixel = pixel.repeat(len(rounds))
        seed = _seed_words(rounds, n_paths, dev)
    sample = torch.zeros((R,), dtype=torch.int32, device=dev)

    root = _sample_light_root(scene, settings, R, seed, pixel, sample)
    thr = root["alpha_walk"]
    rows = torch.zeros((R, B, ncol), dtype=torch.float32, device=dev)
    media = _Media(scene, settings) if has_media else None
    zb = torch.zeros((R,), dtype=torch.bool, device=dev)
    zf = torch.zeros((R,), dtype=torch.float32, device=dev)
    z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    o = root["q"] + root["d0"] * EPSILON
    d = root["d0"]
    alive = ~zb
    med = root["med"].to(torch.int32) if has_media else \
        torch.full((R,), -1, dtype=torch.int32, device=dev)
    med_first = ~zb
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    pp0, pp1, plen0, pact = z3, z3, zf, zb

    for i in range(B):
        if not bool(alive.any()):
            break
        nrays = nrays + torch.sum(alive.to(torch.int64))
        dims = PHOTON_DIM_OFFSET + 16 + i * rng.DIMS_PER_BOUNCE
        res = bvh_intersect(scene, o, d, 0.0, torch.where(alive, INF, 0.0))
        hit = res["hit"] & alive
        slot = {}

        # ---- medium flight: may scatter before the surface, depositing
        # a volume photon ----
        vol_scatter = zb
        vol_point = o
        vol_power = thr
        seg_pow = thr          # incident power at the segment start
        if has_media:
            laws = media.laws
            in_med = alive & (med >= 0)
            mi = torch.clamp(med, 0, media.n - 1).long()
            sigma_s = scene.med_sigma_s[mi]
            sigma_t = scene.med_sigma_a[mi] + sigma_s
            absorb_only = torch.amax(sigma_s, dim=-1) == 0.0
            tt = scene.med_trans_type[mi]
            tp = scene.med_trans_params[mi]
            u_c, u_d, u_e = rng.random_3d(seed, pixel, sample,
                                          dims + rng.BounceDims.MEDIUM, sobol)
            comp = torch.clamp((u_c * 3).to(torch.int32), max=2)
            sigma_tc = torch.gather(sigma_t, -1, comp[..., None].long())[..., 0]
            t_law = TR.sample_distance(tt, tp, med_first, u_d, u_e, laws)
            max_t = torch.where(hit, res["t"], INF)
            if media.het:
                tau_c = t_law / torch.clamp(sigma_tc, min=1e-20)
                t_m, rho, tau_tot = GR.inverse_unit_tau(
                    scene, settings, mi, o, d, max_t, tau_c, active=in_med)
                exited = (t_m >= max_t) | absorb_only
                ut_used = torch.where(exited, tau_tot, tau_c)
                rho = torch.where(exited, 1.0, rho)[..., None]
            else:
                t_m = t_law / torch.clamp(sigma_tc, min=1e-20)
                exited = (t_m >= max_t) | absorb_only
                ut_used = torch.minimum(
                    torch.where(absorb_only, max_t, t_m), max_t)
                rho = 1.0
            t_s = torch.minimum(torch.where(absorb_only, max_t, t_m), max_t)
            tau = sigma_t * ut_used[..., None]
            sbar = TR.sigma_bar(tt, tp, laws)
            w_exit = TR.eval_tr(tt, tau, tp, med_first,
                                torch.ones_like(exited), laws)
            p_exit = torch.mean(
                TR.surface_probability(tt, tau, tp, med_first, laws), dim=-1)
            tr_med = TR.eval_tr(tt, tau, tp, med_first,
                                torch.zeros_like(exited), laws)
            p_scat = torch.mean(
                rho * sigma_t * TR.medium_pdf(tt, tau, tp, med_first, laws),
                dim=-1)
            # the deposit weight includes sigma_s: a volume photon is a
            # scattering event, whose density along the ray is
            # sigma_s * Tr (the camera march needs no sigma factor then)
            w_vol = tr_med * rho * sigma_s * sbar[..., None] / \
                torch.clamp(p_scat, min=1e-20)[..., None]
            w = torch.where(exited[..., None],
                            w_exit / torch.clamp(p_exit, min=1e-20)[..., None],
                            w_vol)
            w = torch.where(absorb_only[..., None], w_exit, w)
            vol_scatter = in_med & ~exited
            vol_point = o + d * t_s[..., None]
            vol_power = thr * torch.where(in_med[..., None], w_vol, 1.0)
            if planes_mode:
                # the continued (unclamped) distance and weight of this
                # segment (ref MediumSample::continuedT / continuedWeight):
                # the pending plane of the previous volume vertex extends
                # l1 = continuedT past any surface hit
                t_unc = torch.clamp(t_m, max=1e7)
                tau_cont = sigma_t * t_unc[..., None]
                tr_cont = TR.eval_tr(tt, tau_cont, tp, med_first,
                                     torch.zeros_like(exited), laws)
                p_cont = torch.mean(
                    sigma_t * TR.medium_pdf(tt, tau_cont, tp, med_first,
                                            laws), dim=-1)
                w_cont = sigma_s * sbar[..., None] * tr_cont / \
                    torch.clamp(p_cont, min=1e-20)[..., None]
                emit = pact & in_med & alive & (plen0 > 0) & (t_unc > 0)
                ppow = plen0[..., None] * t_unc[..., None] * seg_pow * w_cont
                ppow = torch.where(torch.isfinite(ppow), ppow, 0.0)
                e3 = emit[..., None]
                slot.update(pl_p0=torch.where(e3, pp0, 0.0),
                            pl_p1=torch.where(e3, pp1, 0.0),
                            pl_d1=torch.where(e3, d, 0.0),
                            pl_l1=torch.where(emit, t_unc, 0.0),
                            pl_pow=torch.where(e3, ppow, 0.0),
                            pl_valid=emit)
            thr = thr * torch.where(in_med[..., None], w, 1.0)
            # a volume scatter preempts the surface this bounce
            hit = hit & ~vol_scatter
            med_first = torch.where(in_med & ~absorb_only, False, med_first)

        info = _expand_hit(scene, o, d, res)
        ng = info["ng"]
        ns = info["ns"]
        ng_d = torch.sum(ng * d, dim=-1)
        if settings.two_sided_shading:
            ns = torch.where((ng_d > 0.0)[..., None], -ns, ns)
        tan, bit = shading_frame(info, ns)
        wi_local = vm.to_local(tan, bit, ns, -d)
        sp = ShadePoint(scene, info["bsdf"], info["uv"])

        if has_fwd:
            transp = bsdf_forward(sp, wi_local, types)
            t_scalar = torch.mean(transp, dim=-1)
            u_fwd = rng.random_1d(seed, pixel, sample,
                                  dims + rng.BounceDims.FORWARD, sobol)
            take_fwd = hit & (torch.amax(transp, dim=-1) > 0) & \
                (u_fwd < t_scalar)
            fwd_w = transp / torch.clamp(t_scalar, min=1e-20)[..., None]
        else:
            take_fwd = zb

        # deposit on non-pure-specular surfaces (the shading-normal
        # asymmetry factor folded into the stored power, ref :546)
        spec_surf = _is_pure_specular(scene, settings, info["bsdf"])
        dep = hit & ~spec_surf & ~take_fwd
        asym = torch.abs(torch.sum(ns * d, dim=-1) /
                         torch.where(torch.abs(ng_d) < 1e-9, 1e-9, ng_d))
        p_pow = thr * torch.clamp(asym, 0.0, 8.0)[..., None]
        if beams:
            # the beam spans the whole unoccluded segment (to the surface
            # hit); in planes mode only segments rooted at the light or
            # a surface become beams, volume-to-volume ones are planes
            in_med_seg = alive & (med >= 0)
            if planes_mode:
                in_med_seg = in_med_seg & ~pact
            blen = torch.where(res["hit"], res["t"], 1e8)
            s3 = in_med_seg[..., None]
            slot.update(b_o=torch.where(s3, o, 0.0),
                        b_d=torch.where(s3, d, 0.0),
                        b_len=torch.where(in_med_seg,
                                          torch.clamp(blen, max=1e8), 0.0),
                        b_pow=torch.where(s3, seg_pow, 0.0),
                        b_valid=in_med_seg)

        # one slot per bounce serves either a surface or a volume photon
        any_dep = dep | vol_scatter
        a3 = any_dep[..., None]
        slot.update(
            pos=torch.where(a3, vm.where3(vol_scatter, vol_point, info["p"]),
                            0.0),
            dir=torch.where(a3, d, 0.0),
            power=torch.where(a3, torch.where(vol_scatter[..., None],
                                              vol_power, p_pow), 0.0),
            bounce=torch.where(any_dep, i + 1, 0), valid=any_dep,
            vol=vol_scatter)
        rows[:, i] = _pack(slot, layout)

        # continue the walk (full BSDF sampling, ref handleSurface)
        ul = rng.random_1d(seed, pixel, sample,
                           dims + rng.BounceDims.BSDF_LOBE, sobol)
        u1, u2 = rng.random_2d(seed, pixel, sample,
                               dims + rng.BounceDims.BSDF_SAMPLE, sobol)
        ul2 = rng.random_1d(seed, pixel, sample,
                            dims + rng.BounceDims.BSDF_LOBE2, sobol)
        wo, wt, _, flags = bsdf_sample(sp, wi_local, ul, u1, u2, types,
                                       u_lobe2=ul2, adjoint=True)
        ok = ((flags & FLAG_VALID) != 0) & (torch.amax(wt, dim=-1) > 0)
        new_d = vm.to_global(tan, bit, ns, wo)
        # adjoint shading-normal correction (Bsdf.hpp:75-79)
        adj = torch.abs(torch.sum(new_d * ng, dim=-1) * wi_local[..., 2]) / \
            torch.clamp(torch.abs(ng_d * wo[..., 2]), min=1e-9)
        wt = wt * torch.clamp(adj, 0.0, 8.0)[..., None]
        if has_fwd:
            new_d = vm.where3(take_fwd, d, new_d)
            wt = torch.where(take_fwd[..., None], fwd_w, wt)
            ok = torch.where(take_fwd, torch.amax(fwd_w, dim=-1) > 0, ok)
        thr2 = torch.where(hit[..., None], thr * wt, thr)
        o2 = info["p"] + new_d * EPSILON
        if has_media:
            # volume scatter: continue through the phase function
            pw, _ = PH.phase_sample(scene.med_phase[mi], scene.med_g[mi], d,
                                    u1, u2)
            new_d = vm.where3(vol_scatter, pw, new_d)
            o2 = vm.where3(vol_scatter, vol_point + pw * EPSILON, o2)
            ok = torch.where(vol_scatter, True, ok)
            # medium handoff at surface crossings
            geo_back = torch.sum(new_d * ng, dim=-1) < 0.0
            med = torch.where(hit & ok,
                              _select_medium(scene, info["prim"], med,
                                             geo_back), med)
            med_first = torch.where(hit & ok, True, med_first)
        alive2 = (hit | vol_scatter) & ok & (torch.amax(thr2, dim=-1) > 0)
        if planes_mode:
            # the next bounce's pending plane roots at this bounce's
            # volume vertex: segment start, scatter point, length
            pact = vol_scatter & alive2
            pp0 = vm.where3(vol_scatter, o, pp0)
            pp1 = vm.where3(vol_scatter, vol_point, pp1)
            plen0 = torch.where(vol_scatter, t_s, plen0)
        o, d, thr, alive = o2, new_d, thr2, alive2

    out = _unpack(rows.reshape(R * B, ncol), layout)
    if not beams:
        for name, n, _ in _BEAM:
            z = torch.zeros((), dtype=torch.bool if name == "b_valid"
                            else torch.float32, device=dev)
            out[name] = z.expand((R * B, 3) if n == 3 else (R * B,))
    out["rays"] = nrays
    return out


# ------------------------------------------------------------- hash grid

def _f32_sq(r) -> float:
    """r * r in f32 (the JAX package squares its f32 radius argument)."""
    r = torch.tensor(float(r), dtype=torch.float32)
    return float(r * r)


def _cell(x, lo, inv):
    """clip(((x - lo) * inv).astype(int32), 1, GRID_RES - 3) with the JAX
    package's saturating cast (NaN to 0, out-of-range values to the
    int32 ends): clamping in float first gives the same cell."""
    f = torch.nan_to_num((x - lo) * inv, nan=0.0)
    return torch.clamp(f, 1.0, float(GRID_RES - 3)).to(torch.int32)


def _key(c):
    return (c[..., 0] * GRID_RES + c[..., 1]) * GRID_RES + c[..., 2]


def _lo(pts, valid, pad):
    lo = torch.amin(torch.where(valid[..., None], pts, math.inf).reshape(
        -1, 3), dim=0) - pad
    return torch.where(torch.isfinite(lo), lo, 0.0)


def build_photon_grid(photons, radius):
    """Sort the valid photons by hash-grid cell key (cell size = gather
    radius).  Returns the sorted keys and photon fields, with the grid
    origin lo and inv_cell."""
    pos = photons["pos"]
    valid = photons["valid"]
    lo = _lo(pos, valid, radius)
    inv = 1.0 / radius
    vi = torch.nonzero(valid).reshape(-1)
    key, order = torch.sort(_key(_cell(pos[vi], lo, inv)), stable=True)
    vi = vi[order]
    return dict(key=key, pos=pos[vi], dir=photons["dir"][vi],
                power=photons["power"][vi], bounce=photons["bounce"][vi],
                valid=valid[vi], lo=lo, inv_cell=inv)


def _candidates(keys, cell, cap, live=None):
    """The 27-cell candidate scan as ragged pairs.  For each group of
    query rows [r0, r1) yields (r0, r1, q, ix, k, pos): per candidate its
    row q (relative to r0), its slot ix in the sorted keys, its
    neighbour cell key k and its position in the JAX package's dense
    candidate list (neighbour index * cap + slot within the cell), in
    that order within each row.  `live` (N,) bool drops rows."""
    N = cell.shape[0]
    dev = cell.device
    nb = torch.tensor(_NB, dtype=torch.int32, device=dev)
    keys = keys.contiguous()
    for b0 in range(0, N, ROW_BLOCK):
        c = cell[b0:b0 + ROW_BLOCK]
        n = c.shape[0]
        k = _key(c[:, None, :] + nb).contiguous()             # (n, 27)
        start = torch.searchsorted(keys, k)
        cnt = torch.clamp(torch.searchsorted(keys, k, right=True) - start,
                          max=cap)
        if live is not None:
            cnt = torch.where(live[b0:b0 + n, None], cnt, 0)
        cs = torch.cumsum(cnt.sum(1), 0)
        total = int(cs[-1])
        if total == 0:
            continue
        cuts = torch.searchsorted(
            cs, torch.arange(PAIR_BUDGET, total, PAIR_BUDGET, device=dev),
            right=True).tolist() if total > PAIR_BUDGET else []
        edges = sorted({0, n, *cuts})
        for a, b in zip(edges[:-1], edges[1:]):
            flat = cnt[a:b].reshape(-1)
            P = int(flat.sum())
            if P == 0:
                continue
            seg = torch.repeat_interleave(
                torch.arange(flat.shape[0], device=dev), flat,
                output_size=P)
            j = torch.arange(P, device=dev) - (torch.cumsum(flat, 0) -
                                               flat)[seg]
            yield (b0 + a, b0 + b, torch.div(seg, 27, rounding_mode="floor"),
                   start[a:b].reshape(-1)[seg] + j, k[a:b].reshape(-1)[seg],
                   (seg % 27) * cap + j)


def _dist2(a, b):
    """|a - b|^2 summed x, y, z in order (as XLA sums the last axis; a
    reduction kernel may take another order)."""
    dv = a - b
    dv = dv * dv
    return (dv[..., 0] + dv[..., 1]) + dv[..., 2]


def _knn(grid, radius, K, p):
    """The k nearest photons within `radius` of each p (R,3), as the JAX
    package's top_k over its 27 * CELL_CAP candidates picks them.
    Returns (sel_d2 (R,K), inf where none; sel_ix (R,K) sorted slots;
    sel_pos (R,K) the candidate positions, -1 where none)."""
    R = p.shape[0]
    dev = p.device
    r2 = _f32_sq(radius)
    sel_d2 = torch.full((R, K), math.inf, dtype=torch.float32, device=dev)
    sel_ix = torch.zeros((R, K), dtype=torch.int64, device=dev)
    sel_pos = torch.full((R, K), -1, dtype=torch.int64, device=dev)
    cell = _cell(p, grid["lo"], grid["inv_cell"])
    for r0, r1, q, ix, _, pos in _candidates(grid["key"], cell, CELL_CAP):
        d2 = _dist2(grid["pos"][ix], p[r0:r1][q])
        d2 = torch.where(d2 <= r2, d2, math.inf)
        # rows, then d2 (non-negative: its bits order as ints), then the
        # candidate position (the stable sort keeps the pairs' order)
        sk = (q << 32) | d2.view(torch.int32).to(torch.int64)
        order = torch.sort(sk, stable=True).indices
        qs = q[order]
        cnt = torch.bincount(q, minlength=r1 - r0)
        rank = torch.arange(q.shape[0], device=dev) - \
            (torch.cumsum(cnt, 0) - cnt)[qs]
        keep = (rank < K) & torch.isfinite(d2[order])
        rows = qs[keep] + r0
        cols = rank[keep]
        sel_d2[rows, cols] = d2[order][keep]
        sel_ix[rows, cols] = ix[order][keep]
        sel_pos[rows, cols] = pos[order][keep]
    return sel_d2, sel_ix, sel_pos


def _gather_estimate(scene, settings, grid, radius, p, frame, wi_local,
                     bsdf_idx, uv, cam_bounce):
    """kNN density estimate at surface points p (R,3): the k =
    gather_count nearest photons within the radius, the radius clamped
    to the k-th distance, sum power * f / |cos| * INV_PI / r^2 over the
    photons whose full path bounce lies in [min_bounces, max_bounces)."""
    R = p.shape[0]
    K = settings.gather_count
    tan, bit, ns = frame
    sel_d2, sel_ix, _ = _knn(grid, radius, K, p)
    got = torch.isfinite(sel_d2)
    count = torch.sum(got, dim=1)
    kth = torch.amax(torch.where(got, sel_d2, 0.0), dim=1)
    rr = torch.tensor(radius, dtype=torch.float32, device=p.device)
    r2 = torch.where(count >= K, kth, rr * rr)

    # f at the gather point toward each selected photon
    def rep(x):
        return x.repeat_interleave(K, dim=0)
    sp = ShadePoint(scene, rep(bsdf_idx), rep(uv))
    flat = sel_ix.reshape(-1)
    wo_l = vm.to_local(rep(tan), rep(bit), rep(ns), -grid["dir"][flat])
    f = bsdf_eval(sp, rep(wi_local), wo_l, settings.present_bsdf_types)
    f = f / torch.clamp(torch.abs(wo_l[..., 2]), min=1e-6)[..., None]
    f = f.reshape(R, K, 3)
    power = grid["power"][flat].reshape(R, K, 3)
    full_bounce = cam_bounce[:, None] + grid["bounce"][flat].reshape(R, K) - 1
    ok = got & (full_bounce >= settings.min_bounces) & \
        (full_bounce < settings.max_bounces) & \
        (sel_d2 <= r2[:, None] + 1e-12)
    est = torch.sum(torch.where(ok[..., None], power * f, 0.0), dim=1)
    return est * (vm.INV_PI / torch.clamp(r2, min=1e-20))[..., None]


def _gather_volume(scene, settings, vgrid, vradius, p, wo, ptype, pg):
    """Sum of phase-weighted photon powers within vradius of p (R,3),
    added in the JAX package's candidate order."""
    acc = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    vr2 = _f32_sq(vradius)
    cell = _cell(p, vgrid["lo"], vgrid["inv_cell"])
    for r0, r1, q, ix, _, _ in _candidates(vgrid["key"], cell, CELL_CAP):
        qg = q + r0
        d2 = _dist2(vgrid["pos"][ix], p[qg])
        ph = PH.phase_eval(ptype[qg], pg[qg], vgrid["dir"][ix], wo[qg])
        # the pairs come grouped by query row, in candidate order
        ordered_index_add(acc, qg, torch.where(
            (d2 <= vr2)[..., None], vgrid["power"][ix] * ph[..., None], 0.0),
            grouped=True)
    return acc


def _cam_medium(scene, R, dev):
    """The camera's medium per lane and the clipped index into the
    medium tables."""
    med = scene.cam_medium.to(torch.int32).expand(R)
    mi = torch.clamp(med, 0, max(scene.med_sigma_a.shape[0] - 1, 0)).long()
    return med, mi


def _volume_march(scene, settings, vgrid, vradius, o, d, t1, seed, pixel,
                  sample_idx):
    """In-scattered radiance along the primary camera segment from the
    points volume map: march t in (0, t1) with a jittered start and sum
    dt * Tr(0, t) * sum_k phase * power_k / (4/3 pi r^3)."""
    R = o.shape[0]
    dev = o.device
    med, mi = _cam_medium(scene, R, dev)
    if int(scene.cam_medium) < 0:
        return torch.zeros((R, 3), dtype=torch.float32, device=dev)
    sobol = settings.stratified_sampler
    u_j = rng.random_1d(seed, pixel, sample_idx, PHOTON_DIM_OFFSET + 7,
                        sobol)
    vr = torch.tensor(vradius, dtype=torch.float32, device=dev)
    vr = torch.clamp(vr, min=1e-9)
    kernel = 3.0 / (4.0 * math.pi * (vr * vr * vr))
    ptype = scene.med_phase[mi]
    pg = scene.med_g[mi]
    M = VOL_MARCH_STEPS
    dt = t1 / M
    j = torch.arange(M, dtype=torch.float32, device=dev)[None, :]
    t = (j + u_j[:, None]) * dt[:, None]                  # (R, M)
    x = (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(R * M, 3)

    def rep(a):
        return a.repeat_interleave(M, dim=0)
    est = _gather_volume(scene, settings, vgrid, vradius, x, rep(-d),
                         rep(ptype), rep(pg)).reshape(R, M, 3)
    tr = _medium_tr(scene, settings, _Media(scene, settings), rep(med),
                    rep(o), rep(d), t.reshape(R * M),
                    torch.ones((R * M,), dtype=torch.bool, device=dev),
                    torch.zeros((R * M,), dtype=torch.bool, device=dev))
    acc = torch.sum(est * tr.reshape(R, M, 3), dim=1) * (kernel * dt)[:, None]
    return acc


# ------------------------------------------------------------ photon beams

def build_beam_grid(photons, radius):
    """Hash grid over photon beams (cell = 2 * radius): each beam's
    centerline sampled every cell (BEAM_CELLS samples), consecutive
    repeats dropped, the (cell, beam) pairs sorted by key."""
    bo = photons["b_o"]
    bd = photons["b_d"]
    blen = photons["b_len"]
    valid = photons["b_valid"]
    dev = bo.device
    cell = 2.0 * radius
    inv = 1.0 / cell
    lo = _lo(bo, valid, 2.0 * cell)
    vi = torch.nonzero(valid).reshape(-1)
    t_k = (torch.arange(BEAM_CELLS, dtype=torch.float32, device=dev) + 0.5) \
        * cell
    pts = bo[vi, None, :] + bd[vi, None, :] * t_k[None, :, None]
    ok = t_k[None, :] <= blen[vi, None] + cell
    key = torch.where(ok, _key(_cell(pts, lo, inv)), INVALID_KEY)
    # in-beam dedup: consecutive samples in the same cell keep the first
    dup = torch.cat([torch.zeros((vi.shape[0], 1), dtype=torch.bool,
                                 device=dev), key[:, 1:] == key[:, :-1]], 1)
    key = torch.where(dup, INVALID_KEY, key).reshape(-1)
    bid = vi.to(torch.int32).repeat_interleave(BEAM_CELLS)
    keep = key != INVALID_KEY
    key, order = torch.sort(key[keep], stable=True)
    return dict(key=key, bid=bid[keep][order], b_o=bo, b_d=bd, b_len=blen,
                b_pow=photons["b_pow"], lo=lo, cell=cell, inv_cell=inv)


def _march_cells(o, d, t1, lo, inv):
    """The camera segments' midpoint march cells (R*M, 3) and whether
    each is the first of its run along its ray (each cell visited once a
    ray)."""
    R = o.shape[0]
    M = VOL_MARCH_STEPS
    step = t1 / M
    j = torch.arange(M, dtype=torch.float32, device=o.device)[None, :]
    tj = (j + 0.5) * step[:, None]
    xj = o[:, None, :] + d[:, None, :] * tj[..., None]
    cj = _cell(xj, lo, inv)
    ck = _key(cj)
    fresh = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=o.device),
                       ck[:, 1:] != ck[:, :-1]], dim=1)
    return cj.reshape(R * M, 3), fresh.reshape(R * M)


def _beam_eval(scene, settings, bgrid, radius, o, d, t1):
    """In-scattered radiance along the camera segment from the beam map
    (ref evalBeam1D, PhotonTracer.cpp:120-135): for each beam within
    `radius` of the ray, power * phase * sigma_s * Tr_cam(t) *
    Tr_beam(s) / (2 radius sin theta) at the closest approach, counted
    in the cell that owns the beam's closest point."""
    R = o.shape[0]
    dev = o.device
    M = VOL_MARCH_STEPS
    if int(scene.cam_medium) < 0:
        return torch.zeros((R, 3), dtype=torch.float32, device=dev)
    _, mi = _cam_medium(scene, R, dev)
    sigma_s = scene.med_sigma_s[mi]
    sigma_t = sigma_s + scene.med_sigma_a[mi]
    ptype = scene.med_phase[mi]
    pg = scene.med_g[mi]
    lo, inv = bgrid["lo"], bgrid["inv_cell"]
    cj, fresh = _march_cells(o, d, t1, lo, inv)
    acc = torch.zeros((R * M, 3), dtype=torch.float32, device=dev)
    two_r = float(2.0 * torch.tensor(radius, dtype=torch.float32))
    for r0, _, q, ix, k, _ in _candidates(bgrid["key"], cj, BEAM_CAP,
                                          live=fresh):
        qg = q + r0
        ray = torch.div(qg, M, rounding_mode="floor")
        b = bgrid["bid"][ix].long()
        bo, bd = bgrid["b_o"][b], bgrid["b_d"][b]
        bl, bp = bgrid["b_len"][b], bgrid["b_pow"][b]
        oq, dq = o[ray], d[ray]
        # closest approach (intersectBeam1D)
        l = bo - oq
        cr = torch.linalg.cross(l, bd, dim=-1)
        sin2 = 1.0 - torch.sum(dq * bd, dim=-1) ** 2
        u = cr / torch.clamp(torch.linalg.vector_norm(cr, dim=-1,
                                                      keepdim=True), min=1e-12)
        nrm = torch.linalg.cross(bd, u, dim=-1)
        denom = torch.sum(nrm * dq, dim=-1)
        t = torch.sum(nrm * l, dim=-1) / \
            torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
        x = oq + dq * t[..., None]
        dist = torch.abs(torch.sum(u * (x - bo), dim=-1))
        s_b = torch.sum(bd * (x - bo), dim=-1)
        okb = ((dist <= radius) & (sin2 > 1e-9) & (t > 1e-4) & (t < t1[ray])
               & (s_b >= 0.0) & (s_b <= bl))
        # ownership: the beam's closest point lies in the queried cell
        pb = bo + bd * s_b[..., None]
        okb = okb & (_key(_cell(pb, lo, inv)) == k)
        ph = PH.phase_eval(ptype[ray], pg[ray], bd, -dq)
        tr = torch.exp(-sigma_t[ray] * (t + s_b)[..., None])
        inv_sin = torch.rsqrt(torch.clamp(sin2, min=1e-9))
        w = (bp * sigma_s[ray] * ph[..., None] * tr
             * (inv_sin / two_r)[..., None])
        ordered_index_add(acc, qg, torch.where(okb[..., None], w, 0.0),
                          grouped=True)
    return acc.reshape(R, M, 3).sum(dim=1)


# ------------------------------------------------------------ photon planes

def build_plane_grid(photons, radius):
    """Hash grid over photon planes (cell = 2 * radius): each
    parallelogram p0 + u (p1 - p0) + v l1 d1 point-sampled on a PLANE_U x
    PLANE_V lattice, each plane's keys sorted with repeats dropped, the
    (cell, plane) pairs sorted by key."""
    p0 = photons["pl_p0"]
    p1 = photons["pl_p1"]
    d1 = photons["pl_d1"]
    l1 = photons["pl_l1"]
    valid = photons["pl_valid"]
    dev = p0.device
    cell = 2.0 * radius
    inv = 1.0 / cell
    ext = d1 * l1[..., None]
    corners = torch.stack([p0, p1, p1 + ext, p0 + ext], dim=1)  # (N,4,3)
    lo = _lo(corners, valid[:, None].expand(-1, 4), 2.0 * cell)
    u_k = (torch.arange(PLANE_U, dtype=torch.float32, device=dev) + 0.5) \
        / PLANE_U
    v_k = (torch.arange(PLANE_V, dtype=torch.float32, device=dev) + 0.5) \
        * cell
    vi = torch.nonzero(valid).reshape(-1)
    keys, pids = [], []
    for c0 in range(0, vi.shape[0], PLANE_BLOCK):
        v = vi[c0:c0 + PLANE_BLOCK]
        a = p0[v]
        pts = (a[:, None, None, :]
               + (p1[v] - a)[:, None, None, :] * u_k[None, :, None, None]
               + d1[v][:, None, None, :] * v_k[None, None, :, None])
        ok = (v_k[None, None, :] <= l1[v][:, None, None] + cell).expand(
            -1, PLANE_U, -1)
        key = torch.where(ok, _key(_cell(pts, lo, inv)),
                          INVALID_KEY).reshape(v.shape[0], -1)
        # exact per-plane dedup: sort the lattice keys, drop repeats
        key = torch.sort(key, dim=1).values
        dup = torch.cat([torch.zeros((v.shape[0], 1), dtype=torch.bool,
                                     device=dev),
                         key[:, 1:] == key[:, :-1]], dim=1)
        key = torch.where(dup, INVALID_KEY, key).reshape(-1)
        pid = v.to(torch.int32).repeat_interleave(PLANE_U * PLANE_V)
        keep = key != INVALID_KEY
        keys.append(key[keep])
        pids.append(pid[keep])
    key = torch.cat(keys) if keys else torch.zeros((0,), dtype=torch.int32,
                                                   device=dev)
    pid = torch.cat(pids) if pids else key
    key, order = torch.sort(key, stable=True)
    return dict(key=key, pid=pid[order], p0=p0, p1=p1, d1=d1, l1=l1,
                pow=photons["pl_pow"], lo=lo, inv_cell=inv)


def _plane_eval(scene, settings, pgrid, o, d, t1):
    """In-scattered radiance along the camera segment from the plane map
    (ref evalPlane0D, PhotonTracer.cpp:138-157): for each plane the ray
    pierces, sigma_t^2 * |invDet| * phase(d1, -d) * Tr_cam(t) * power at
    the intersection, counted in the cell that owns the hit point; the
    largest contribution of each march row is shadow-tested back along
    -d1 for v * l1 and dropped when occluded."""
    R = o.shape[0]
    dev = o.device
    M = VOL_MARCH_STEPS
    N = R * M
    if int(scene.cam_medium) < 0:
        return torch.zeros((R, 3), dtype=torch.float32, device=dev)
    _, mi = _cam_medium(scene, R, dev)
    sigma_t = scene.med_sigma_s[mi] + scene.med_sigma_a[mi]
    ptype = scene.med_phase[mi]
    pg = scene.med_g[mi]
    lo, inv = pgrid["lo"], pgrid["inv_cell"]
    cj, fresh = _march_cells(o, d, t1, lo, inv)
    acc = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    # the shadow-test slot: the largest-luminance hit of each march row
    # (the first in candidate order among equals)
    best_w = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    best_x = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    best_d1 = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    best_len = torch.zeros((N,), dtype=torch.float32, device=dev)
    for r0, r1, q, ix, k, _ in _candidates(pgrid["key"], cj, PLANE_CAP,
                                           live=fresh):
        qg = q + r0
        ray = torch.div(qg, M, rounding_mode="floor")
        p = pgrid["pid"][ix].long()
        p0, p1, d1 = pgrid["p0"][p], pgrid["p1"][p], pgrid["d1"][p]
        l1, ppow = pgrid["l1"][p], pgrid["pow"][p]
        oq, dq = o[ray], d[ray]
        # Moller-Trumbore against the parallelogram e1 = p1 - p0,
        # e2 = d1 * l1 (ref intersectPlane0D, PhotonTracer.cpp:67-95)
        e1 = p1 - p0
        e2 = d1 * l1[..., None]
        P = torch.linalg.cross(dq, e2, dim=-1)
        det = torch.sum(e1 * P, dim=-1)
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-8, 1e-8, det)
        T = oq - p0
        uu = torch.sum(T * P, dim=-1) * inv_det
        Q = torch.linalg.cross(T, e1, dim=-1)
        vv = torch.sum(dq * Q, dim=-1) * inv_det
        t = torch.sum(e2 * Q, dim=-1) * inv_det
        okb = ((torch.abs(det) > 1e-8) & (uu >= 0.0) & (uu <= 1.0)
               & (vv >= 0.0) & (vv <= 1.0) & (t > 1e-4) & (t < t1[ray]))
        x = oq + dq * t[..., None]
        okb = okb & (_key(_cell(x, lo, inv)) == k)
        ph = PH.phase_eval(ptype[ray], pg[ray], d1, -dq)
        tr = torch.exp(-sigma_t[ray] * t[..., None])
        w = (sigma_t[ray] ** 2 * torch.abs(inv_det)[..., None]
             * ph[..., None] * tr * ppow)
        w = torch.where(okb[..., None], w, 0.0)
        ordered_index_add(acc, qg, w, grouped=True)
        lum = torch.sum(w, dim=-1)
        n = r1 - r0
        mx = torch.zeros((n,), dtype=torch.float32, device=dev).scatter_reduce(
            0, q, lum, "amax")
        is_best = (lum == mx[q]) & (lum > 0)
        P_ = q.shape[0]
        first = torch.full((n,), P_, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(
            0, q[is_best], torch.arange(P_, device=dev)[is_best], "amin")
        has = torch.nonzero(first < P_).reshape(-1)
        pick = first[has]
        rows = has + r0
        best_w[rows] = w[pick]
        best_x[rows] = x[pick]
        best_d1[rows] = d1[pick]
        best_len[rows] = (vv * l1)[pick]
    # occlusion along -d1 for v * l1 (ref evalPlane0D's shadow ray):
    # subtract the occluded best-slot contributions
    sh = torch.nonzero(torch.sum(best_w, dim=-1) > 0.0).reshape(-1)
    if sh.shape[0] > 0:
        occ = occluded(scene, best_x[sh], -best_d1[sh], EPSILON,
                       best_len[sh] * (1.0 - 1e-3))
        # sh comes from nonzero: unique rows, one add each, so the order
        # of index_add_'s atomics cannot change the sum
        acc.index_add_(0, sh, torch.where(occ[..., None], -best_w[sh], 0.0))
    return acc.reshape(R, M, 3).sum(dim=1)


def _primary(scene, settings, pixel, sample_idx, seed):
    """Camera rays, their weights and the march length t1 (the hit
    distance, or 1.5 scene diagonals for an escaping ray)."""
    from tungsten_tpu_torch.cameras.camera import generate_rays_w
    o, d, cam_w = generate_rays_w(scene, settings, pixel, sample_idx, seed)
    res = bvh_intersect(scene, o, d, 0.0, INF)
    diag = torch.linalg.vector_norm(scene.bvh_max[0] - scene.bvh_min[0])
    t1 = torch.where(res["hit"], res["t"], diag * 1.5)
    return o, d, cam_w, t1


def beam_pass(scene, settings, bgrid, vradius, pixel, sample_idx, seed):
    """The beam map's camera pass: primary rays, their hit distance and
    the beam gather along them."""
    o, d, cam_w, t1 = _primary(scene, settings, pixel, sample_idx, seed)
    return _beam_eval(scene, settings, bgrid, vradius, o, d, t1) * \
        cam_w[..., None]


def plane_pass(scene, settings, pgrid, pixel, sample_idx, seed):
    """The plane map's camera pass, as beam_pass."""
    o, d, cam_w, t1 = _primary(scene, settings, pixel, sample_idx, seed)
    return _plane_eval(scene, settings, pgrid, o, d, t1) * cam_w[..., None]


# ------------------------------------------------------------ camera pass

def camera_walk(scene, settings, pixel, sample_idx, seed):
    """The camera walk of the gather pass (ref traceSensorPath): through
    pure-specular and forward surfaces, crediting env and emitters, to
    the first other surface, where the gather point is recorded.
    Returns a dict: result (R,3) (env and emitter credit), stopped (R,),
    the gather point g_p, g_ns, g_wi, g_bsdf, g_uv, g_thr, g_bounce, the
    primary rays o0, d0 and their march length g_t1, and rays (alive
    walks a bounce)."""
    from tungsten_tpu_torch.cameras.camera import generate_rays_w
    R = pixel.shape[0]
    dev = pixel.device
    sobol = settings.stratified_sampler
    types = settings.present_bsdf_types
    has_fwd = _has_forward_types(settings)
    media = _Media(scene, settings) if settings.has_media else None
    o0, d0, cam_w = generate_rays_w(scene, settings, pixel, sample_idx, seed)
    o, d = o0, d0
    thr = cam_w[..., None].expand(R, 3) * 1.0
    result = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    zb = torch.zeros((R,), dtype=torch.bool, device=dev)
    alive, stopped = ~zb, zb
    bounce = torch.zeros((R,), dtype=torch.int32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    med = scene.cam_medium.to(torch.int32).expand(R)
    g_p = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    g_ns, g_wi, g_thr = g_p, g_p, g_p
    g_uv = torch.zeros((R, 2), dtype=torch.float32, device=dev)
    g_bsdf = torch.zeros((R,), dtype=torch.int64, device=dev)
    g_bounce = bounce
    g_t1 = torch.zeros((R,), dtype=torch.float32, device=dev)
    diag = torch.linalg.vector_norm(scene.bvh_max[0] - scene.bvh_min[0])

    for i in range(settings.max_bounces):
        if not bool(alive.any()):
            break
        dims = rng.DIMS_CAMERA + i * rng.DIMS_PER_BOUNCE
        nrays = nrays + torch.sum(alive.to(torch.int64))
        res = bvh_intersect(scene, o, d, 0.0, torch.where(alive, INF, 0.0))
        hit = res["hit"] & alive
        escaped = alive & ~res["hit"]
        # medium transmittance along the camera segment
        if settings.has_media:
            seg = torch.where(hit, res["t"], INF)
            ones = torch.ones((R,), dtype=torch.bool, device=dev)
            seg_tr = _medium_tr(scene, settings, media, med, o, d, seg, ones,
                                ones)
            thr = thr * torch.where(alive[..., None], seg_tr, 1.0)
        bounce = bounce + hit.to(torch.int32)
        if i == 0:
            # the primary segment for the volume map's march (escaping
            # primaries march 1.5 scene diagonals)
            g_t1 = torch.where(res["hit"], res["t"], diag * 1.5)
        if settings.has_env and i >= settings.min_bounces:
            result = result + torch.where(escaped[..., None],
                                          thr * L.env_eval(scene, d), 0.0)

        info = _expand_hit(scene, o, d, res)
        ns = info["ns"]
        if settings.two_sided_shading:
            backside = torch.sum(info["ng"] * d, dim=-1) > 0.0
            ns = torch.where(backside[..., None], -ns, ns)
        tan, bit = shading_frame(info, ns)
        wi_local = vm.to_local(tan, bit, ns, -d)
        sp = ShadePoint(scene, info["bsdf"], info["uv"])

        if has_fwd:
            transp = bsdf_forward(sp, wi_local, types)
            t_scalar = torch.mean(transp, dim=-1)
            u_fwd = rng.random_1d(seed, pixel, sample_idx,
                                  dims + rng.BounceDims.FORWARD, sobol)
            take_fwd = hit & (torch.amax(transp, dim=-1) > 0) & \
                (u_fwd < t_scalar)
            fwd_w = transp / torch.clamp(t_scalar, min=1e-20)[..., None]
        else:
            take_fwd = zb
        spec_surf = _is_pure_specular(scene, settings, info["bsdf"])
        stop_here = hit & ~spec_surf & ~take_fwd

        # emissive credit at the stop vertex (ref :409-410)
        prim = info["prim"]
        etex = scene.prim_emission_tex[prim]
        pl = scene.prim_light[prim]
        li = torch.clamp(pl, 0, max(scene.light_emission.shape[0] - 1,
                                    0)).long()
        e_val = torch.where(
            (pl >= 0)[..., None], scene.light_emission[li],
            scene.tex_const[torch.clamp(etex, 0, scene.tex_const.shape[0]
                                        - 1).long()])
        front = torch.sum(info["ng"] * d, dim=-1) < 0.0
        if i >= settings.min_bounces:
            emit = stop_here & (etex >= 0) & front
            result = result + torch.where(emit[..., None], thr * e_val, 0.0)

        # record the gather point once
        s3 = stop_here[..., None]
        g_p = torch.where(s3, info["p"], g_p)
        g_ns = torch.where(s3, ns, g_ns)
        g_wi = torch.where(s3, wi_local, g_wi)
        g_uv = torch.where(s3, info["uv"], g_uv)
        g_thr = torch.where(s3, thr, g_thr)
        g_bsdf = torch.where(stop_here, info["bsdf"], g_bsdf)
        g_bounce = torch.where(stop_here, bounce, g_bounce)
        stopped = stopped | stop_here

        # specular / forward continuation
        ul = rng.random_1d(seed, pixel, sample_idx,
                           dims + rng.BounceDims.BSDF_LOBE, sobol)
        u1, u2 = rng.random_2d(seed, pixel, sample_idx,
                               dims + rng.BounceDims.BSDF_SAMPLE, sobol)
        ul2 = rng.random_1d(seed, pixel, sample_idx,
                            dims + rng.BounceDims.BSDF_LOBE2, sobol)
        wo, wt, _, flags = bsdf_sample(sp, wi_local, ul, u1, u2, types,
                                       u_lobe2=ul2)
        ok = ((flags & FLAG_VALID) != 0) & (torch.amax(wt, dim=-1) > 0)
        new_d = vm.to_global(tan, bit, ns, wo)
        if has_fwd:
            new_d = vm.where3(take_fwd, d, new_d)
            wt = torch.where(take_fwd[..., None], fwd_w, wt)
            ok = torch.where(take_fwd, torch.amax(fwd_w, dim=-1) > 0, ok)
        thr = torch.where((hit & ~stop_here)[..., None], thr * wt, thr)
        alive = hit & ~stop_here & ok & (torch.amax(thr, dim=-1) > 0)
        if settings.has_media:
            # medium handoff when the specular walk crosses a surface
            geo_back = torch.sum(new_d * info["ng"], dim=-1) < 0.0
            med = torch.where(alive, _select_medium(scene, prim, med,
                                                    geo_back), med)
        o = vm.where3(alive, info["p"] + new_d * EPSILON, o)
        d = vm.where3(alive, new_d, d)

    return dict(result=result, stopped=stopped, g_p=g_p, g_ns=g_ns,
                g_wi=g_wi, g_bsdf=g_bsdf, g_uv=g_uv, g_thr=g_thr,
                g_bounce=g_bounce, o0=o0, d0=d0, g_t1=g_t1, rays=nrays)


def gather_walk(scene, settings, walk, lanes, grid, radius, seed,
                vgrid=None, vradius=None, pixel=None, sample_idx=None):
    """Radiance (n,3) of camera_walk's `lanes` (a slice) gathered from
    the photon grid at their stop vertices (the others add nothing), and
    with the points volume map `vgrid` the march along their primary
    segments (pixel and sample_idx: the lanes' ids)."""
    w = {k: v[lanes] for k, v in walk.items() if k != "rays"}
    result = w["result"]
    sel = torch.nonzero(w["stopped"]).reshape(-1)
    if sel.shape[0] > 0:
        ns = w["g_ns"][sel]
        tan, bit = vm.ortho_frame(ns)
        est = _gather_estimate(scene, settings, grid, radius, w["g_p"][sel],
                               (tan, bit, ns), w["g_wi"][sel],
                               w["g_bsdf"][sel], w["g_uv"][sel],
                               w["g_bounce"][sel])
        # sel comes from nonzero: unique lanes, one add each, so the
        # order of index_add's atomics cannot change the sum
        result = result.index_add(0, sel, w["g_thr"][sel] * est)
    if vgrid is not None and settings.has_media:
        result = result + _volume_march(scene, settings, vgrid, vradius,
                                        w["o0"], w["d0"], w["g_t1"], seed,
                                        pixel, sample_idx)
    return result


def ppm_gamma(iteration: int, alpha: float) -> float:
    """Radius shrink factor: gamma_i = prod_{k=1..i} (k+alpha)/(k+1)
    (ref ProgressivePhotonMapIntegrator.cpp:58-60)."""
    g = 1.0
    for k in range(1, iteration + 1):
        g *= (k + alpha) / (k + 1.0)
    return g
