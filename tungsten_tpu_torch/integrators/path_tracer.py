"""Wavefront path tracer (port of tungsten_tpu/integrators/
path_tracer.py: the bounce body with media, forward-lobe surfaces and
analytic primitives, every light type of the JAX package, both NEE
estimators, staged compaction).

SoA ray/path state over the whole wavefront; per bounce one closest-hit
traversal at the top of the body (camera ray at bounce 0, the previous
body's continuation after) plus the NEE traversals.  Two estimators, as
in the JAX package:

  * ONE-SAMPLE MIS (`_one_sample_mis`), for scenes without media or
    forward-lobe surfaces: one any-hit shadow ray for the light sample;
    the continuation bsdf sample doubles as the bsdf-side strategy, and
    emitter / env hits are power-heuristic-weighted against the
    light-selection-aware NEE density.
  * TWO-STRATEGY NEE (the reference's estimateDirect), for the rest
    (media, forward-lobe surfaces, cap lights): the light sample and an
    independent bsdf (or phase) sample toward the chosen light, each
    weighted by the power heuristic.  With media or forward lobes their
    visibility is the generalized shadow ray (`_shadow_transmittance`):
    closest-hit hops through forward-lobe surfaces, accumulating each
    medium segment's transmittance.  Without them (a cap-light scene)
    the simple sub-branch traces one any-hit shadow segment and one
    closest hit for the strategy ray.  Direct emitter, env and cap hits
    then count only after a specular vertex (or with light sampling
    off); point lights are Dirac and take the light strategy alone.

Media: homogeneous distance sampling with spectral channel MIS and the
transmittance laws of media/transmittance.py (HomogeneousMedium.cpp:
65-108); exponential, atmosphere and voxel media invert their optical
depth (media/grid.py), voxel grids credit their emission.  Forward-lobe
surfaces (forward, transparency, thinsheet) pass the path straight
through with the probability of their forward transparency.

Estimator guards mirror the reference: NEE at every shading vertex
(surface or medium) while bounce < max_bounces - 1; Russian roulette
after bounce 2 at max|throughput| < 0.1.

On CUDA the body first reorders the whole wavefront state by the
traversal sort key (one key sort + one packed row gather) so the
closest-hit launch skips its own sort, as the JAX package does when its
Pallas path is on; on the CPU lanes keep their order, as there.

MLT: with a primary-sample tape (rng.Tape) every draw reads the tape row
of the lane's input entry, the state's `lane`, which the sort and the
compactions move with the lane (the JAX package reads row i for lane i,
wrong once its sort permutes lanes, ROADMAP C-ref 1).  A chain may be
restricted to one path length (`mlt_path_length`, multiplexed MLT), and
trace_wave_rj records the reversible-jump inversions at a bounce per
lane (_rj_step).

Gradients (trace_wave_replay, the JAX package's path replay): sampling
decisions and traversals are detached, interior derivatives only.
`bvh_intersect` returns no graph, the microfacet samplers detach their
half-vector, and an autograd Function re-traces each bounce in its
backward pass with flat memory in depth.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from tungsten_tpu_torch.bsdf import types as bt
from tungsten_tpu_torch.bsdf.eval import (FLAG_SPECULAR, FLAG_VALID,
                                          ShadePoint, bsdf_eval, bsdf_forward,
                                          bsdf_pdf, bsdf_sample)
from tungsten_tpu_torch.integrators import lights as L
from tungsten_tpu_torch.media import grid as GR
from tungsten_tpu_torch.media import phase as PH
from tungsten_tpu_torch.media import transmittance as TR
from tungsten_tpu_torch.ops.intersect import bvh_intersect, ray_sort_key
from tungsten_tpu_torch.ops.segment_sum import index_sums
from tungsten_tpu_torch.scene.flatten import (
    CURVE_MODE_BCSDF_CYLINDER, CURVE_MODE_RIBBON, LIGHT_AREA, LIGHT_CAP,
    LIGHT_CYLINDER, LIGHT_DISK, LIGHT_INFINITE, LIGHT_POINT, LIGHT_SPHERE)
from tungsten_tpu_torch.utils import rng
from tungsten_tpu_torch.utils import vecmath as vm

INF = 3.0e38
EPSILON = 5e-4  # ray-offset epsilon (ref TraceableScene.hpp DefaultEpsilon)
SHADOW_FUDGE = 1.0 - 1e-3
MAX_SHADOW_HOPS = 8  # forward-surface crossings a shadow ray may pass

def _has_forward_types(settings) -> bool:
    return any(t in settings.present_bsdf_types
               for t in bt.FORWARD_LOBE_TYPES)


def _one_sample_mis(settings) -> bool:
    """The JAX package's one-sample-MIS condition: no media, no forward
    lobes, light sampling on, no cap lights, and no MMLT path-length
    restriction (`mlt_path_length` < 0: a chain restricted to one length
    keeps the two-strategy estimator, whose terms the body gates by
    length)."""
    return (not settings.has_media and not _has_forward_types(settings)
            and bool(settings.enable_light_sampling)
            and settings.num_lights > 0 and settings.num_caps == 0
            and settings.mlt_path_length < 0)


def _light_select_pmf(scene, settings, p, li):
    """P(choose_light picks li | shading point p)."""
    nl = settings.num_lights
    if nl <= 1:
        return torch.ones(li.shape, dtype=torch.float32, device=li.device)
    w, total = L._choose_light_weights(scene, settings, p)
    wi = torch.gather(w, -1, torch.clamp(li, 0, nl - 1)[..., None].long())
    return wi[..., 0] / torch.clamp(total, min=1e-30)


# ---------------------------------------------------------------- media

class _Media:
    """What the media code needs of a scene, read once per bounce body:
    the transmittance laws present (one device read) and whether any
    medium is heterogeneous."""

    def __init__(self, scene, settings):
        self.laws = TR.present_laws(scene.med_trans_type,
                                    scene.med_trans_params)
        self.het = any(k != GR.MED_HOMOGENEOUS for k in settings.med_kinds)
        self.n = scene.med_sigma_a.shape[0]


def _medium_tr(scene, settings, media, med, o, d, seg_len, start_surf,
               end_surf):
    """Transmittance (R,3) of `seg_len` through medium index `med` (-1 =
    vacuum, transmittance 1).  Heterogeneous media integrate the density
    along the segment (ref VoxelMedium/ExponentialMedium::transmittance);
    infinite segments through a homogeneous medium transmit 0."""
    m = torch.clamp(med, 0, media.n - 1).long()
    sigma_t = vm.take(scene.med_sigma_a, m) + \
        vm.take(scene.med_sigma_s, m)
    if media.het:
        ut = GR.unit_tau(scene, settings, m, o, d, seg_len, active=med >= 0)
    else:
        ut = torch.clamp(seg_len, max=INF)
    tau = sigma_t * ut[..., None]
    tr = TR.eval_tr(scene.med_trans_type[m], tau, scene.med_trans_params[m],
                    start_surf, end_surf, media.laws)
    # ut is INF only where the density never falls off along an infinite
    # segment; guard NaNs from 0*inf in the law params
    tr = torch.where(torch.isfinite(tr), tr, 0.0)
    tr = torch.where(((seg_len >= INF) & (ut >= INF))[..., None], 0.0, tr)
    return torch.where((med >= 0)[..., None], tr, 1.0)


def _select_medium(scene, prim, cur_med, geometric_backside):
    """ref Primitive::selectMedium (Primitive.hpp:177-183)."""
    im = scene.prim_int_medium[prim]
    em = scene.prim_ext_medium[prim]
    overrides = (im >= 0) | (em >= 0)
    return torch.where(overrides, torch.where(geometric_backside, im, em),
                       cur_med)


def _shadow_transmittance(scene, settings, media, o, d, dist, medium,
                          starts_on_surface, active, endcap_prim):
    """Generalized shadow ray (ref TraceBase::generalizedShadowRay):
    walks through forward-lobe surfaces, accumulating their transparency
    and the transmittance of each medium segment.  Returns (R,3).

    Each hop is one closest-hit traversal from t_min = EPSILON; lanes
    that are not `active` get t_max = 0 (the JAX package walks every lane
    and masks the ones its caller does not use; those lanes' results are
    what differs).  endcap_prim (R,) excludes the target light primitive
    from occlusion, like the reference's endCap.  The walk stops when no
    lane is active (one host read a hop) or after MAX_SHADOW_HOPS; lanes
    still active then are blocked."""
    types = settings.present_bsdf_types
    fwd = _has_forward_types(settings)
    remaining = torch.where(dist >= INF, INF, dist * SHADOW_FUDGE)
    med = medium
    tr = torch.ones(o.shape, dtype=torch.float32, device=o.device)
    start_surf = starts_on_surface
    hops = 0
    while hops < MAX_SHADOW_HOPS and bool(active.any()):
        res = bvh_intersect(scene, o, d, EPSILON,
                            torch.where(active, remaining, 0.0))
        did_hit = res["hit"] & active
        # reaching the target light ends the walk successfully; the
        # medium segment still runs to the light's surface
        hit_prim = _hit_prim(scene, res)
        did_hit = did_hit & (hit_prim != endcap_prim)
        seg = torch.where(res["hit"] & active, res["t"], remaining)
        if settings.has_media:
            seg_tr = _medium_tr(scene, settings, media,
                                torch.where(active, med, -1), o, d, seg,
                                start_surf, torch.ones_like(did_hit))
            tr = tr * torch.where(active[..., None], seg_tr, 1.0)
        # surface crossing: must be a forward-lobe surface
        uv, bsdf_idx, prim = _hit_uv_bsdf(scene, res)
        ng = _hit_ng(scene, res)
        if fwd:
            sp = ShadePoint(scene, bsdf_idx.long(), uv)
            # forward transparency is wi-dependent only for thinsheet
            cosd = torch.abs(torch.sum(d * ng, dim=-1))
            wi_proxy = torch.stack(
                [torch.sqrt(torch.clamp(1 - cosd ** 2, min=0.0)),
                 torch.zeros_like(cosd), cosd], dim=-1)
            transp = bsdf_forward(sp, wi_proxy, types)
        else:
            transp = torch.zeros_like(tr)
        passes = torch.amax(transp, dim=-1) > 0.0
        tr = torch.where((did_hit & ~passes)[..., None], 0.0, tr)
        tr = tr * torch.where((did_hit & passes)[..., None], transp, 1.0)
        # medium handoff at the crossing: entering through a front face
        if settings.has_media:
            backside = torch.sum(d * ng, dim=-1) > 0.0
            new_med = _select_medium(scene, prim, med, ~backside)
            med = torch.where(did_hit & passes, new_med, med)
        o = torch.where(did_hit[..., None], o + d * res["t"][..., None], o)
        remaining = torch.where(did_hit, remaining - res["t"], remaining)
        start_surf = start_surf | did_hit
        active = active & did_hit & passes & (remaining > EPSILON)
        hops += 1
    return torch.where(active[..., None], 0.0, tr)


# ----------------------------------------------------------------- NEE

def _nee(scene, settings, ctx, seed, pixel, sample_idx, bounce_dim_base, smp,
         want_tr: bool = False, media=None, want_dir: bool = False):
    """Next-event estimation toward one chosen light, at surface vertices
    (bsdf) or medium vertices (phase).  ctx: p, frame, sp, wi_local, gate
    (the vertices that want NEE this bounce) and, with media, is_volume,
    ray_d, phase_type, phase_g and medium.  One-sample MIS scenes trace
    the light sample's shadow ray through the any-hit traversal; the
    others run both strategies (light sample and an independent
    bsdf/phase sample) through the generalized shadow ray.  Returns
    ((R,3) contribution excluding path throughput, NEE rays traced, and
    with want_tr (tr (R,3), tr_valid (R,)): the light strategy's shadow
    transmittance, valid only where that ray was traced — the visibility
    AOV's input, ref PathTracer.cpp:92-93 — else None; with want_dir
    (d (R,3), visible (R,)): the light strategy's direction and whether
    its shadow ray was traced and reached the light — the reversible-jump
    inversion's input — else None).  `smp` is the sampler
    (rng.sampler)."""
    p = ctx["p"]
    R = p.shape[0]
    types = settings.present_bsdf_types
    t, b, n = ctx["frame"]
    sp = ctx["sp"]
    wi_local = ctx["wi_local"]
    gate = ctx["gate"]
    is_vol = ctx.get("is_volume")
    u_sel = rng.random_1d(seed, pixel, sample_idx,
                          bounce_dim_base + rng.BounceDims.LIGHT_SELECT, smp)
    li, sel_weight = L.choose_light(scene, settings, p, u_sel)
    ltype = scene.light_type[li]

    u1, u2 = rng.random_2d(seed, pixel, sample_idx,
                           bounce_dim_base + rng.BounceDims.LIGHT_SAMPLE,
                           smp)
    if settings.has_area_lights or settings.has_cyl_lights:
        u_tri = rng.random_1d(seed, pixel, sample_idx,
                              bounce_dim_base + rng.BounceDims.LIGHT_TRI,
                              smp)
    if settings.has_area_lights:
        a = L.area_light_sample(scene, li, p, u_tri, u1, u2)
    else:
        # every light is the env: skip the triangle alias machinery
        z = torch.zeros((R,), dtype=torch.float32, device=p.device)
        dz = torch.zeros((R, 3), dtype=torch.float32, device=p.device)
        a = dict(d=torch.stack([z, z, z + 1.0], dim=-1), dist=z, pdf=z,
                 emission=dz, valid=torch.zeros_like(gate))
    if settings.has_env:
        ed, erad, epdf = L.env_sample(scene, u1, u2, active=gate)
        is_env = ltype == LIGHT_INFINITE
        d = vm.where3(is_env, ed, a["d"])
        dist = torch.where(is_env, INF, a["dist"])
        pdf = torch.where(is_env, epdf, a["pdf"])
        emis = torch.where(is_env[..., None], erad, a["emission"])
        valid = torch.where(is_env, epdf > 0, a["valid"])
    else:
        d, dist, pdf, emis, valid = (a["d"], a["dist"], a["pdf"],
                                     a["emission"], a["valid"])
    if settings.num_caps > 0:
        is_cap = ltype == LIGHT_CAP
        cd, cpdf = L.cap_light_sample(scene, li, u1, u2)
        d = vm.where3(is_cap, cd, d)
        dist = torch.where(is_cap, INF, dist)
        pdf = torch.where(is_cap, cpdf, pdf)
        emis = torch.where(is_cap[..., None],
                           vm.take(scene.light_emission, li), emis)
        valid = valid | is_cap
    # point lights are Dirac: the light strategy alone, weight 1
    if settings.has_points:
        is_pt = ltype == LIGHT_POINT
        pvec = scene.light_aux[li, :3] - p
        p_rsq = torch.sum(pvec * pvec, dim=-1)
        p_dist = torch.sqrt(torch.clamp(p_rsq, min=1e-20))
        d = vm.where3(is_pt, pvec / p_dist[..., None], d)
        dist = torch.where(is_pt, p_dist, dist)
        pdf = torch.where(is_pt, p_rsq, pdf)
        emis = torch.where(is_pt[..., None], vm.take(scene.light_emission, li),
                           emis)
        valid = valid | is_pt
    for present, kind, sample in (
            (settings.has_disk_lights, LIGHT_DISK,
             lambda: L.disk_light_sample(scene, li, p, u1, u2)),
            (settings.has_cyl_lights, LIGHT_CYLINDER,
             lambda: L.cyl_light_sample(scene, li, p, u1, u2, u_tri)),
            (settings.has_sphere_lights, LIGHT_SPHERE,
             lambda: L.sphere_light_sample(scene, li, p, u1, u2))):
        if not present:
            continue
        is_k = ltype == kind
        ls = sample()
        d = vm.where3(is_k, ls["d"], d)
        dist = torch.where(is_k, ls["dist"], dist)
        pdf = torch.where(is_k, ls["pdf"], pdf)
        emis = torch.where(is_k[..., None], ls["emission"], emis)
        valid = torch.where(is_k, ls["valid"], valid)

    def eval_f_pdf(d_world):
        """(f (R,3) with cos folded in, pdf (R,)) of the scatter function
        toward d_world: the bsdf at surfaces, the phase function at
        medium vertices."""
        wo_local = vm.to_local(t, b, n, d_world)
        f_s = bsdf_eval(sp, wi_local, wo_local, types)
        p_s = bsdf_pdf(sp, wi_local, wo_local, types)
        if not settings.has_media:
            return f_s, p_s
        pe = PH.phase_eval(ctx["phase_type"], ctx["phase_g"], ctx["ray_d"],
                           d_world)
        return (torch.where(is_vol[..., None], pe[..., None], f_s),
                torch.where(is_vol, pe, p_s))

    f, pdf_counter = eval_f_pdf(d)
    do_shadow = valid & (torch.amax(f, dim=-1) > 0.0) & (pdf > 1e-20) & gate
    shadow_o = p + d * EPSILON

    if _one_sample_mis(settings):
        far_sh = torch.where(
            do_shadow, torch.where(dist >= INF, INF, dist * SHADOW_FUDGE),
            0.0)
        occ = bvh_intersect(scene, shadow_o, d, 0.0, far_sh,
                            any_hit=True)["hit"]
        tr = torch.where((do_shadow & ~occ)[..., None], 1.0, 0.0)
        pmf = 1.0 / sel_weight
        mis_l = L.power_heuristic(pdf * pmf, pdf_counter)
        if settings.has_points:
            mis_l = torch.where(is_pt, 1.0, mis_l)
        out = f * tr * emis / torch.clamp(pdf, min=1e-20)[..., None] \
            * mis_l[..., None] * sel_weight[..., None]
        return (out, torch.sum(do_shadow.to(torch.int64)),
                (tr, do_shadow) if want_tr else None,
                _nee_dir(d, tr, do_shadow) if want_dir else None)

    # ---- two strategies: the light sample's visibility, through the
    # generalized shadow ray where media or forward lobes are present,
    # else one any-hit segment (the simple sub-branch) ----
    simple = not settings.has_media and not _has_forward_types(settings)
    surface_light = ltype == LIGHT_AREA
    if settings.has_disk_lights or settings.has_cyl_lights or \
            settings.has_sphere_lights:
        surface_light = surface_light | (ltype == LIGHT_DISK) | \
            (ltype == LIGHT_CYLINDER) | (ltype == LIGHT_SPHERE)
    endcap = torch.where(surface_light, scene.light_prim[li], -2)
    not_vol = ~is_vol if is_vol is not None else torch.ones_like(gate)
    medium = ctx.get("medium")
    if medium is None:
        medium = torch.full((R,), -1, dtype=torch.int32, device=p.device)
    if simple:
        # the reference's occluded() with farT shy of the light sample:
        # no endcap test (TraceableScene.hpp occlusion path)
        far_sh = torch.where(
            do_shadow, torch.where(dist >= INF, INF, dist * SHADOW_FUDGE),
            0.0)
        occ = bvh_intersect(scene, shadow_o, d, 0.0, far_sh,
                            any_hit=True)["hit"]
        tr = torch.where((do_shadow & ~occ)[..., None], 1.0, 0.0)
    else:
        tr = _shadow_transmittance(scene, settings, media, shadow_o, d, dist,
                                   medium, not_vol, do_shadow, endcap)
        tr = torch.where(do_shadow[..., None], tr, 0.0)
    mis_l = L.power_heuristic(pdf, pdf_counter)
    if settings.has_points:
        mis_l = torch.where(is_pt, 1.0, mis_l)
    contrib_l = f * tr * emis / torch.clamp(pdf, min=1e-20)[..., None] \
        * mis_l[..., None]

    # ---- the independent bsdf/phase sample (ref TraceBase::bsdfSample)
    ub = rng.random_1d(seed, pixel, sample_idx,
                       bounce_dim_base + rng.BounceDims.NEE_BSDF_LOBE, smp)
    ub1, ub2 = rng.random_2d(seed, pixel, sample_idx,
                             bounce_dim_base + rng.BounceDims.NEE_BSDF_SAMPLE,
                             smp)
    ub_l2 = rng.random_1d(seed, pixel, sample_idx,
                          bounce_dim_base + rng.BounceDims.NEE_BSDF_LOBE2,
                          smp)
    wo_b, wt_b, pdf_b, flags_b = bsdf_sample(
        sp, wi_local, ub, ub1, ub2, types, u_lobe2=ub_l2, no_specular=True)
    wd = vm.to_global(t, b, n, wo_b)
    ok_b = ((flags_b & FLAG_VALID) != 0) & (torch.amax(wt_b, dim=-1) > 0)
    if settings.has_media:
        pw, ppdf = PH.phase_sample(ctx["phase_type"], ctx["phase_g"],
                                   ctx["ray_d"], ub1, ub2)
        wd = vm.where3(is_vol, pw, wd)
        wt_b = torch.where(is_vol[..., None], 1.0, wt_b)
        pdf_b = torch.where(is_vol, ppdf, pdf_b)
        ok_b = torch.where(is_vol, ppdf > 0, ok_b)
    # the strategy ray is dead where the sample is invalid (specular
    # vertices: no_specular sampling returns weight 0) or gated off
    trace_b = ok_b & gate
    ob = p + wd * EPSILON
    res_b = bvh_intersect(scene, ob, wd, 0.0, torch.where(trace_b, INF, 0.0))
    hit_prim = _hit_prim(scene, res_b)
    nb = _hit_ng(scene, res_b, ob, wd)
    hit_t = torch.where(res_b["hit"], res_b["t"], 1.0)
    lpdf = L.area_light_direct_pdf(
        scene, li, hit_t, wd, nb, p=p,
        has_sphere_lights=settings.has_sphere_lights)
    front = torch.sum(wd * nb, dim=-1) < 0.0
    got = surface_light & res_b["hit"] & \
        (hit_prim == scene.light_prim[li]) & front
    e_b = vm.take(scene.light_emission, li)
    if settings.has_env:
        is_env = ltype == LIGHT_INFINITE
        escape = is_env & ~res_b["hit"]
        e_b = torch.where(is_env[..., None],
                          L.env_eval(scene, wd, active=escape & trace_b), e_b)
        lpdf = torch.where(is_env, L.env_pdf(scene, wd,
                                             active=escape & trace_b), lpdf)
        got = torch.where(is_env, escape, got)
    if settings.num_caps > 0:
        aux = scene.light_aux[li]
        in_cap = torch.sum(wd * aux[..., :3], dim=-1) >= aux[..., 3]
        got = torch.where(is_cap, ~res_b["hit"] & in_cap, got)
        e_b = torch.where(is_cap[..., None],
                          vm.take(scene.light_emission, li), e_b)
        lpdf = torch.where(is_cap, L.cap_pdf_value(aux[..., 3]), lpdf)
    if settings.has_points:
        got = got & ~is_pt   # no bsdf strategy toward a Dirac light
    if simple:
        # the closest hit already decides the strategy ray's visibility
        tr_b = 1.0
    else:
        # the transmittance along the strategy ray's segment
        seg = torch.where(res_b["hit"], res_b["t"], INF)
        tr_b = _shadow_transmittance(scene, settings, media, ob, wd, seg,
                                     medium, not_vol, trace_b, endcap)
    mis_b = L.power_heuristic(pdf_b, lpdf)
    contrib_b = torch.where((ok_b & got)[..., None],
                            wt_b * tr_b * e_b * mis_b[..., None], 0.0)
    out = (contrib_l + contrib_b) * sel_weight[..., None]
    nee_rays = torch.sum(do_shadow.to(torch.int64)) + \
        torch.sum(trace_b.to(torch.int64))
    return (out, nee_rays, (tr, do_shadow) if want_tr else None,
            _nee_dir(d, tr, do_shadow) if want_dir else None)


def _nee_dir(d, tr, do_shadow):
    """The light strategy's direction and whether its shadow ray was
    traced and reached the light."""
    return d, do_shadow & (torch.amax(tr, dim=-1) > 0.0)


# ------------------------------------------------------------ hit expand

def _clip_idx(idx, n):
    return torch.clamp(idx, 0, max(n - 1, 0)).long()


def _hit_prim(scene, res):
    """Primitive id of a hit (-1 on miss), over the triangle, analytic and
    curve winner channels."""
    if scene.tri_v0.shape[0] > 0:
        prim = torch.where(
            res["tri"] >= 0,
            scene.tri_prim[_clip_idx(res["tri"], scene.tri_v0.shape[0])], -1)
    else:
        prim = torch.full(res["t"].shape, -1, dtype=torch.int32,
                          device=res["t"].device)
    for ch, table in (("sph", scene.sph_prim), ("dsk", scene.dsk_prim),
                      ("cyl", scene.cyl_prim), ("crv", scene.crv_seg_prim)):
        if table.shape[0] > 0:
            prim = torch.where(res[ch] >= 0,
                               table[_clip_idx(res[ch], table.shape[0])], prim)
    return prim


def _hit_ng(scene, res, o=None, d=None):
    """Geometric normal of a triangle hit or, with o/d given, of an
    analytic sphere / disk / cylinder hit.  Callers use it only where a
    matching channel is >= 0; tri-only callers may omit o/d."""
    if scene.tri_v0.shape[0] == 0:
        ng = torch.tensor([0.0, 0.0, 1.0], device=res["t"].device) \
            .expand(res["t"].shape + (3,))
    else:
        tri = _clip_idx(res["tri"], scene.tri_v0.shape[0])
        ng = torch.linalg.cross(scene.tri_e1[tri], scene.tri_e2[tri], dim=-1)
        ng = ng / torch.clamp(
            torch.linalg.vector_norm(ng, dim=-1, keepdim=True), min=1e-20)
    if o is None:
        return ng
    if scene.sph_radius.shape[0] > 0:
        si = _clip_idx(res["sph"], scene.sph_radius.shape[0])
        ps = o + d * res["t"][..., None]
        ng_s = (ps - scene.sph_center[si]) / torch.clamp(
            scene.sph_radius[si][..., None], min=1e-20)
        ng = vm.where3(res["sph"] >= 0, ng_s, ng)
    if scene.dsk_r.shape[0] > 0:
        di = _clip_idx(res["dsk"], scene.dsk_r.shape[0])
        ng = vm.where3(res["dsk"] >= 0, scene.dsk_n[di], ng)
    if scene.cyl_r.shape[0] > 0:
        yi = _clip_idx(res["cyl"], scene.cyl_r.shape[0])
        n_w = _cyl_hit(scene, yi, o + d * res["t"][..., None])[0]
        ng = vm.where3(res["cyl"] >= 0, n_w, ng)
    return ng


def _cyl_hit(scene, yi, p):
    """A hit p on analytic cylinder yi (ref Cylinder::intersectionInfo,
    Cylinder.cpp:123-133): a cap hit (on an end plane within tolerance,
    inside the unit circle; the rim belongs to the side) takes the axial
    normal, a side hit the radial one.  Returns (n (R,3) world, on_cap,
    the local hit (px, py, pz) with xz over the radius, half height)."""
    rot = scene.cyl_rot[yi]
    pl = torch.sum((p - scene.cyl_pos[yi])[..., :, None] * rot, dim=-2)
    r_y = torch.clamp(scene.cyl_r[yi], min=1e-20)
    hh = torch.clamp(scene.cyl_hh[yi], min=1e-20)
    px, py, pz = pl[..., 0] / r_y, pl[..., 1], pl[..., 2] / r_y
    on_cap = (torch.abs(torch.abs(py) - hh) < 1e-4 * hh) & \
        (px * px + pz * pz < 1.0) & scene.cyl_capped[yi]
    n_side = torch.stack([px, torch.zeros_like(px), pz], -1)
    n_side = n_side / torch.clamp(
        torch.linalg.vector_norm(n_side, dim=-1, keepdim=True), min=1e-20)
    n_cap = torch.stack([torch.zeros_like(py),
                         torch.where(py >= 0, 1.0, -1.0),
                         torch.zeros_like(py)], -1)
    n_loc = vm.where3(on_cap, n_cap, n_side)
    return (torch.sum(rot * n_loc[..., None, :], dim=-1), on_cap,
            (px, py, pz), hh)


def _hit_uv_bsdf(scene, res):
    """Minimal hit expansion for shadow rays: (uv, bsdf, prim)."""
    u = res["u"][..., None]
    v = res["v"][..., None]
    if scene.tri_v0.shape[0] > 0:
        tri = _clip_idx(res["tri"], scene.tri_v0.shape[0])
        w = 1.0 - u - v
        uv = scene.tri_uv0[tri] * w + scene.tri_uv1[tri] * u + \
            scene.tri_uv2[tri] * v
        prim = scene.tri_prim[tri]
    else:
        uv = torch.cat([u, v], dim=-1)
        prim = torch.zeros(res["t"].shape, dtype=torch.int32,
                           device=res["t"].device)
    for ch, table in (("sph", scene.sph_prim), ("dsk", scene.dsk_prim),
                      ("cyl", scene.cyl_prim), ("crv", scene.crv_seg_prim)):
        if table.shape[0] > 0:
            prim = torch.where(res[ch] >= 0,
                               table[_clip_idx(res[ch], table.shape[0])], prim)
    if scene.crv_seg_prim.shape[0] > 0:
        uv = torch.where((res["crv"] >= 0)[..., None],
                         torch.stack([res["u"], res["v"]], dim=-1), uv)
    prim = _clip_idx(prim, scene.prim_bsdf.shape[0])
    return uv, scene.prim_bsdf[prim], prim


def _expand_hit(scene, o, d, res):
    """IntersectionInfo expansion: position, normals, uv, prim, bsdf, over
    the triangle, analytic (sphere, disk, cylinder) and curve channels;
    a scene with curves adds `is_curve` and `crv_tangent`."""
    t = res["t"]
    p = o + d * t[..., None]
    u = res["u"][..., None]
    v = res["v"][..., None]
    if scene.tri_v0.shape[0] > 0:
        tri = torch.clamp(res["tri"], 0, scene.tri_v0.shape[0] - 1).long()
        # ONE packed gather row [e1, e2, n0, n1, n2, uv0, uv1, uv2]
        row = scene.tri_shade[tri]
        ng = torch.linalg.cross(row[..., 0:3], row[..., 3:6], dim=-1)
        ng = ng / torch.clamp(torch.linalg.vector_norm(ng, dim=-1,
                                                       keepdim=True),
                              min=1e-20)
        w = 1.0 - u - v
        ns = row[..., 6:9] * w + row[..., 9:12] * u + row[..., 12:15] * v
        ns_len = torch.linalg.vector_norm(ns, dim=-1, keepdim=True)
        ns = torch.where(ns_len > 1e-6, ns / torch.clamp(ns_len, min=1e-20),
                         ng)
        uv = row[..., 15:17] * w + row[..., 17:19] * u + row[..., 19:21] * v
        prim = scene.tri_prim[tri]
    else:
        ng = ns = torch.broadcast_to(
            torch.tensor([0.0, 0.0, 1.0], device=p.device), p.shape)
        uv = torch.cat([u, v], dim=-1)
        prim = torch.zeros(t.shape, dtype=torch.int32, device=p.device)
    if scene.sph_radius.shape[0] > 0:
        is_s = res["sph"] >= 0
        si = _clip_idx(res["sph"], scene.sph_radius.shape[0])
        ng_s = (p - scene.sph_center[si]) / torch.clamp(
            scene.sph_radius[si][..., None], min=1e-20)
        ng = vm.where3(is_s, ng_s, ng)
        ns = vm.where3(is_s, ng_s, ns)
        prim = torch.where(is_s, scene.sph_prim[si], prim)
        uv_s = torch.stack(
            [torch.atan2(ng_s[..., 2], ng_s[..., 0]) * vm.INV_TWO_PI + 0.5,
             torch.acos(torch.clamp(-ng_s[..., 1], -1, 1)) * vm.INV_PI], -1)
        uv = torch.where(is_s[..., None], uv_s, uv)
    if scene.dsk_r.shape[0] > 0:
        # ref Disk::intersectionInfo (Disk.cpp:113-127): Ng = Ns = n, uv
        # (azimuth, radial fraction) in the disk's frame
        is_d = res["dsk"] >= 0
        di = _clip_idx(res["dsk"], scene.dsk_r.shape[0])
        nd = scene.dsk_n[di]
        dv = p - scene.dsk_c[di]
        tan_d, bit_d = vm.ortho_frame(nd)
        x = torch.sum(dv * bit_d, dim=-1)
        y = torch.sum(dv * tan_d, dim=-1)
        r_frac = torch.linalg.vector_norm(dv, dim=-1) / \
            torch.clamp(scene.dsk_r[di], min=1e-20)
        ng = vm.where3(is_d, nd, ng)
        ns = vm.where3(is_d, nd, ns)
        prim = torch.where(is_d, scene.dsk_prim[di], prim)
        uv = torch.where(is_d[..., None], torch.stack(
            [torch.atan2(y, x) * vm.INV_TWO_PI + 0.5, r_frac], -1), uv)
    if scene.cyl_r.shape[0] > 0:
        is_y = res["cyl"] >= 0
        yi = _clip_idx(res["cyl"], scene.cyl_r.shape[0])
        # caps take planar uv, the side (azimuth, height)
        n_w, on_cap, (px, py, pz), hh = _cyl_hit(scene, yi, p)
        uv_y = torch.where(
            on_cap[..., None], torch.stack([px, pz], -1) * 0.5 + 0.5,
            torch.stack([torch.atan2(pz, px) * vm.INV_TWO_PI + 0.5,
                         py / (2.0 * hh) + 0.5], -1))
        ng = vm.where3(is_y, n_w, ng)
        ns = vm.where3(is_y, n_w, ns)
        prim = torch.where(is_y, scene.cyl_prim[yi], prim)
        uv = torch.where(is_y[..., None], uv_y, uv)
    out = dict()
    if scene.crv_seg_p0.shape[0] > 0:
        # ref Curves::intersectionInfo (Curves.cpp:484-529): the spline
        # point and tangent at the hit parameter, the normal per render
        # mode, the frame's bitangent the tangent (shading_frame)
        is_crv = res["crv"] >= 0
        ci = _clip_idx(res["crv"], scene.crv_seg_p0.shape[0])
        tc = res["u"][..., None]
        p0c = scene.crv_seg_p0[ci][..., :3]
        p1c = scene.crv_seg_p1[ci][..., :3]
        p2c = scene.crv_seg_p2[ci][..., :3]
        # q(t) = a t^2 + b t + c ; q'(t) = 2 a t + b
        ac = 0.5 * p0c - p1c + 0.5 * p2c
        bc = p1c - p0c
        cc = 0.5 * (p0c + p1c)
        point = ac * tc * tc + bc * tc + cc
        tang = vm.safe_normalize(2.0 * ac * tc + bc)
        mode = scene.crv_seg_mode[ci]
        # cylinder / half_cylinder: the radial normal at the hit point
        lp = p - point
        lp = lp - tang * torch.sum(lp * tang, dim=-1, keepdim=True)
        ng_c = vm.safe_normalize(lp)
        # bcsdf_cylinder: the normal faces the viewer, across the tangent
        nb = -d - tang * torch.sum(tang * -d, dim=-1, keepdim=True)
        ng_c = torch.where((mode == CURVE_MODE_BCSDF_CYLINDER)[..., None],
                           vm.safe_normalize(nb), ng_c)
        # ribbon: the interpolated node normal, across the tangent
        n0c = scene.crv_seg_n0[ci]
        n1c = scene.crv_seg_n1[ci]
        n2c = scene.crv_seg_n2[ci]
        nr = (0.5 * n0c - n1c + 0.5 * n2c) * tc * tc + (n1c - n0c) * tc \
            + 0.5 * (n0c + n1c)
        nr = vm.safe_normalize(tang * torch.sum(tang * nr, dim=-1, keepdim=True)
                         - nr)
        ng_c = torch.where((mode == CURVE_MODE_RIBBON)[..., None], nr, ng_c)
        ng = vm.where3(is_crv, ng_c, ng)
        ns = vm.where3(is_crv, ng_c, ns)
        prim = torch.where(is_crv, scene.crv_seg_prim[ci], prim)
        uv = torch.where(is_crv[..., None],
                         torch.stack([res["u"], res["v"]], dim=-1), uv)
        out["is_curve"] = is_crv
        out["crv_tangent"] = tang
    prim = torch.clamp(prim, 0, scene.prim_bsdf.shape[0] - 1).long()
    out.update(p=p, ng=ng, ns=ns, uv=uv, prim=prim,
               bsdf=scene.prim_bsdf[prim].long())
    return out


def shading_frame(info, ns):
    """Tangent frame at a shading point: an arbitrary orthonormal frame
    for surfaces, tangent-aligned for curves (ref Curves::tangentSpace:
    the bitangent is the fiber tangent, so local y = sin(theta) for the
    BCSDFs)."""
    tan, bit = vm.ortho_frame(ns)
    if "is_curve" in info:
        ct = info["crv_tangent"]
        t2 = vm.safe_normalize(torch.linalg.cross(ct, ns, dim=-1))
        tan = vm.where3(info["is_curve"], t2, tan)
        bit = vm.where3(info["is_curve"], ct, bit)
    return tan, bit


# --------------------------------------------------------------- the loop

def _init_state(scene, settings, pixel, sample_idx, seed, tape=None):
    """Initial wavefront: camera rays, traced by the first bounce body.
    pixel/sample_idx (R,) int32.  `bounce` is a host int.  With a tape
    (rng.Tape) the camera's draws read it, lane i row i."""
    from tungsten_tpu_torch.cameras.camera import generate_rays_w
    R = pixel.shape[0]
    dev = pixel.device
    o, d, cam_w = generate_rays_w(scene, settings, pixel, sample_idx, seed,
                                  tape=tape)
    state = dict(
        o=o.contiguous(), d=d,
        throughput=cam_w[..., None].expand(R, 3) * 1.0,
        emission=torch.zeros((R, 3), dtype=torch.float32, device=dev),
        was_specular=torch.ones((R,), dtype=torch.bool, device=dev),
        alive=cam_w > 0.0,
        bounce=0,
        rays=torch.zeros((), dtype=torch.int64, device=dev),
        pixel=pixel, sample=sample_idx,
    )
    if settings.has_media:
        # the medium each ray travels in, whether it has not scattered in
        # it yet (distance sampling starts on a surface), and its scatter
        # count there
        state["medium"] = scene.cam_medium.to(torch.int32).expand(R) \
            .contiguous()
        state["med_first"] = torch.ones((R,), dtype=torch.bool, device=dev)
        state["med_bounce"] = torch.zeros((R,), dtype=torch.int32,
                                          device=dev)
    if _one_sample_mis(settings):
        # pdf of the bsdf sample that produced the current ray
        state["pdf_fwd"] = torch.zeros((R,), dtype=torch.float32, device=dev)
    if settings.track_aovs:
        # output-value tracking (ref PathTracer.cpp:43-44,78-96): recorded
        # once per path at the first non-specular (or terminating) surface
        # vertex; hit distance accumulates across the leading specular
        # chain.  Each AOV is (value, count).
        def z(c):
            return torch.zeros((R, c), dtype=torch.float32, device=dev)
        state.update(aov_recorded=torch.zeros((R,), dtype=torch.bool,
                                              device=dev),
                     aov_dist=torch.zeros((R,), dtype=torch.float32,
                                          device=dev),
                     aov_depth=z(2), aov_normal=z(4), aov_albedo=z(4),
                     aov_vis=z(2))
    return state


def _sample_medium(scene, settings, media, s, res, seed, dim_base, smp):
    """Medium distance sampling at the top of the body (ref
    HomogeneousMedium::sampleDistance with spectral channel MIS, the
    heterogeneous media's inverse optical depth, and volumetric
    emission).  Returns (vol_scatter, alive, throughput, emission,
    med_point, med_first, med_bounce)."""
    alive = s["alive"]
    throughput = s["throughput"]
    emission = s["emission"]
    med = s["medium"]
    laws = media.laws
    in_med = alive & (med >= 0)
    mi = torch.clamp(med, 0, media.n - 1).long()
    sigma_s = vm.take(scene.med_sigma_s, mi)
    sigma_t = vm.take(scene.med_sigma_a, mi) + sigma_s
    absorb_only = torch.amax(sigma_s, dim=-1) == 0.0
    tt = scene.med_trans_type[mi]
    tp = scene.med_trans_params[mi]
    first = s["med_first"]

    u_c, u_d, u_e = rng.random_3d(seed, s["pixel"], s["sample"],
                                  dim_base + rng.BounceDims.MEDIUM, smp)
    comp = torch.clamp((u_c * 3).to(torch.int32), max=2)
    sigma_tc = torch.gather(sigma_t, -1, comp[..., None].long())[..., 0]
    t_law = TR.sample_distance(tt, tp, first, u_d, u_e, laws)
    max_t = torch.where(res["hit"], res["t"], INF)
    if media.het:
        tau_c = t_law / torch.clamp(sigma_tc, min=1e-20)
        t_m, rho, tau_tot = GR.inverse_unit_tau(
            scene, settings, mi, s["o"], s["d"], max_t, tau_c, active=in_med)
        exited = (t_m >= max_t) | absorb_only
        ut_used = torch.where(exited, tau_tot, tau_c)
        rho = torch.where(exited, 1.0, rho)[..., None]
    else:
        t_m = t_law / torch.clamp(sigma_tc, min=1e-20)
        exited = (t_m >= max_t) | absorb_only
        ut_used = torch.minimum(torch.where(absorb_only, max_t, t_m), max_t)
        rho = 1.0
    t_s = torch.minimum(torch.where(absorb_only, max_t, t_m), max_t)
    tau = sigma_t * ut_used[..., None]
    sbar = TR.sigma_bar(tt, tp, laws)
    surf_end = torch.ones_like(exited)
    w_exit = TR.eval_tr(tt, tau, tp, first, surf_end, laws)
    p_exit = torch.mean(TR.surface_probability(tt, tau, tp, first, laws),
                        dim=-1)
    tr_med = TR.eval_tr(tt, tau, tp, first, ~surf_end, laws)
    w_scat = tr_med * rho * sigma_s * sbar[..., None]
    p_scat = torch.mean(rho * sigma_t * TR.medium_pdf(tt, tau, tp, first,
                                                      laws), dim=-1)
    w = torch.where(exited[..., None], w_exit, w_scat) / torch.clamp(
        torch.where(exited, p_exit, p_scat), min=1e-20)[..., None]
    # absorption-only media skip the MC division (pdf 1, ref :76-82)
    w = torch.where(absorb_only[..., None], w_exit, w)
    # volumetric emission at the scatter point (ref PathTracer.cpp:56,
    # VoxelMedium.cpp:142: grid emission * Tr / pdf, credited before the
    # weight multiplies in)
    med_point = s["o"] + s["d"] * t_s[..., None]
    if media.het and len(scene.grid_density) > 0:
        lit = in_med & ~exited
        e_med = GR.emission(scene, settings, mi, med_point, active=lit) * \
            tr_med / torch.clamp(p_scat, min=1e-20)[..., None]
        emission = emission + torch.where(lit[..., None], throughput * e_med,
                                          0.0)
    throughput = torch.where(in_med[..., None], throughput * w, throughput)
    # absorption-only and no surface: a homogeneous fog extends to
    # infinity (weight 0, ref HomogeneousMedium early-out); a bounded or
    # falling-off heterogeneous medium lets the attenuated ray escape
    died_in_fog = in_med & absorb_only & ~res["hit"]
    if media.het:
        died_in_fog = died_in_fog & \
            (scene.med_kind[mi] == GR.MED_HOMOGENEOUS)
    # medium max-bounce cap (ref Medium::_maxBounce)
    over_bounce = in_med & (s["med_bounce"] > scene.med_max_bounce[mi])
    vol_scatter = in_med & ~exited & ~died_in_fog & ~over_bounce
    alive = alive & ~died_in_fog & ~over_bounce
    scattered = in_med & ~absorb_only
    med_first = torch.where(scattered, False, first)
    med_bounce = s["med_bounce"] + scattered.to(torch.int32)
    return (vol_scatter, alive, throughput, emission, med_point, med_first,
            med_bounce)


def _make_bounce_body(scene, settings, seed, replay: bool = False,
                      tape=None):
    """The per-bounce wavefront step: state dict -> state dict.  `replay`
    (the path-replay gradient, trace_wave_replay) turns the body-start
    sort off: the replay's suffix math needs every lane to keep its
    identity, as in the JAX package's detach mode.  With a tape (rng.Tape)
    every draw reads the row the state's `lane` names, so the sort and
    the compactions keep each chain on its own row.  A state holding
    `rj_b` runs the reversible-jump inversions (trace_wave_rj)."""
    body_sort = scene.device.type == "cuda" and not replay
    one_sample = _one_sample_mis(settings)
    fwd_types = _has_forward_types(settings)
    has_media = settings.has_media
    media = _Media(scene, settings) if has_media else None
    plain_smp = rng.sampler(settings)
    mlt_len = settings.mlt_path_length
    types = settings.present_bsdf_types
    els = bool(settings.enable_light_sampling)
    transmissive = torch.tensor(
        [bt.DIELECTRIC, bt.ROUGH_DIELECTRIC, bt.DIFFUSE_TRANSMISSION],
        dtype=scene.bsdf_type.dtype, device=scene.device)

    def body(s):
        if body_sort:
            key = ray_sort_key(scene, s["o"], s["d"], ~s["alive"])
            _, order = torch.sort(key, stable=True)
            s = _gather_rows(s, order)
        smp = plain_smp if tape is None else tape.at(s["lane"])

        pixel = s["pixel"]
        sample_idx = s["sample"]
        bounce = s["bounce"]
        dim_base = rng.DIMS_CAMERA + bounce * rng.DIMS_PER_BOUNCE
        alive = s["alive"]
        throughput = s["throughput"]
        emission = s["emission"]

        # ---- this bounce's closest-hit trace ----
        res = bvh_intersect(scene, s["o"], s["d"], 0.0,
                            torch.where(alive, INF, 0.0),
                            presorted=body_sort)
        rays_top = torch.sum(alive.to(torch.int64))

        # ---- medium distance sampling ----
        if has_media:
            (vol_scatter, alive, throughput, emission, med_point, med_first,
             med_bounce) = _sample_medium(scene, settings, media, s, res,
                                          seed, dim_base, smp)
            active = alive & res["hit"] & ~vol_scatter
            escaped = alive & ~res["hit"] & ~vol_scatter
        else:
            active = alive & res["hit"]
            escaped = alive & ~res["hit"]

        # ---- escaped rays: environment and caps (ref
        # handleInfiniteLights) ----
        if settings.has_env or settings.num_caps > 0:
            env_ok = escaped & (bounce >= settings.min_bounces)
            if mlt_len >= 0:
                # MMLT: this chain measures length-k paths only
                env_ok = env_ok & (bounce + 1 == mlt_len)
            guard = s["was_specular"] | (not els)
            if settings.has_env:
                env_val = L.env_eval(scene, s["d"], active=env_ok)
                env_guard = guard | (scene.env_light_index < 0)
                if one_sample:
                    eli = torch.broadcast_to(scene.env_light_index,
                                             pixel.shape).to(torch.int32)
                    epdf = L.env_pdf(scene, s["d"], active=env_ok) * \
                        _light_select_pmf(scene, settings, s["o"], eli)
                    w_env = torch.where(
                        env_guard, 1.0, L.power_heuristic(s["pdf_fwd"], epdf))
                    emission = emission + torch.where(
                        env_ok[..., None],
                        throughput * env_val * w_env[..., None], 0.0)
                else:
                    emission = emission + torch.where(
                        (env_ok & env_guard)[..., None],
                        throughput * env_val, 0.0)
            if settings.num_caps > 0:
                # a samplable cap counts under the guard, an unsamplable
                # one always
                cap_samp, cap_unsamp = L.eval_caps(scene, s["d"])
                emission = emission + torch.where(
                    env_ok[..., None], throughput * (
                        torch.where(guard[..., None], cap_samp, 0.0)
                        + cap_unsamp), 0.0)

        info = _expand_hit(scene, s["o"], s["d"], res)
        # two-sided shading: flip the shading frame toward the ray;
        # transmissive BSDFs handle both hemispheres themselves — never flip
        backside = torch.sum(info["ng"] * s["d"], dim=-1) > 0.0
        flip = backside if settings.two_sided_shading else \
            torch.zeros_like(backside)
        flip = flip & ~torch.isin(scene.bsdf_type[info["bsdf"]], transmissive)
        ns = torch.where(flip[..., None], -info["ns"], info["ns"])
        tan, bit = shading_frame(info, ns)
        wi_local = vm.to_local(tan, bit, ns, -s["d"])
        sp = ShadePoint(scene, info["bsdf"], info["uv"])

        # ---- forward/transparency lobe passthrough (ref handleSurface
        # transparency branch: continue straight, no NEE or emission) ----
        if fwd_types:
            transp = bsdf_forward(sp, wi_local, types)
            t_scalar = torch.mean(transp, dim=-1)
            u_fwd = rng.random_1d(seed, pixel, sample_idx,
                                  dim_base + rng.BounceDims.FORWARD, smp)
            take_forward = active & (u_fwd < t_scalar)
            fwd_weight = transp / torch.clamp(t_scalar, min=1e-20)[..., None]
            shade = active & ~take_forward
        else:
            shade = active

        # ---- continuation: bsdf sample / phase sample / forward ----
        ul = rng.random_1d(seed, pixel, sample_idx,
                           dim_base + rng.BounceDims.BSDF_LOBE, smp)
        u1, u2 = rng.random_2d(seed, pixel, sample_idx,
                               dim_base + rng.BounceDims.BSDF_SAMPLE, smp)
        ul2 = rng.random_1d(seed, pixel, sample_idx,
                            dim_base + rng.BounceDims.BSDF_LOBE2, smp)
        wo, wt, pdf, flags = bsdf_sample(sp, wi_local, ul, u1, u2, types,
                                         u_lobe2=ul2)
        ok = ((flags & FLAG_VALID) != 0) & (torch.amax(wt, dim=-1) > 0)
        new_d = vm.to_global(tan, bit, ns, wo)
        new_o = info["p"]
        if fwd_types:
            new_d = vm.where3(take_forward, s["d"], new_d)
            wt = torch.where(take_forward[..., None], fwd_weight, wt)
            ok = torch.where(take_forward,
                             torch.amax(fwd_weight, dim=-1) > 0, ok)
        if has_media:
            mi = torch.clamp(s["medium"], 0, media.n - 1).long()
            phase_type = scene.med_phase[mi]
            phase_g = vm.take(scene.med_g, mi)
            pw, _ = PH.phase_sample(phase_type, phase_g, s["d"], u1, u2)
            new_d = vm.where3(vol_scatter, pw, new_d)
            new_o = vm.where3(vol_scatter, med_point, new_o)
            ok = torch.where(vol_scatter, True, ok)
            wt = torch.where(vol_scatter[..., None], 1.0, wt)
            moved = active | vol_scatter
        else:
            moved = active
        thr_next = torch.where((moved & ok)[..., None], throughput * wt,
                               throughput)
        was_specular = torch.where(shade & ok, (flags & FLAG_SPECULAR) != 0,
                                   s["was_specular"])
        if has_media:
            # ref handleVolume: wasSpecular = !enableVolumeLightSampling
            was_specular = torch.where(
                vol_scatter, not settings.enable_volume_light_sampling,
                was_specular)
        alive2 = moved & ok

        # ---- medium handoff at the surface (ref handleSurface tail) ----
        if has_media:
            geo_back = torch.sum(new_d * info["ng"], dim=-1) < 0.0
            new_med = _select_medium(scene, info["prim"], s["medium"],
                                     geo_back)
            crossed = active & ok
            medium = torch.where(crossed, new_med, s["medium"])
            # state.reset() on surface scatter
            med_first = med_first | crossed
            med_bounce = torch.where(crossed, 0, med_bounce)

        # ---- russian roulette (ref PathTracer.cpp:111-117) ----
        r_pdf = torch.amax(torch.abs(thr_next), dim=-1)
        do_rr = alive2 & (bounce > 2) & (r_pdf < 0.1)
        u_rr = rng.random_1d(seed, pixel, sample_idx,
                             dim_base + rng.BounceDims.ROULETTE, smp)
        survive = u_rr < r_pdf
        thr_next = torch.where(
            (do_rr & survive)[..., None],
            thr_next / torch.clamp(r_pdf, min=1e-20)[..., None], thr_next)
        alive2 = alive2 & (~do_rr | survive)
        alive2 = alive2 & (torch.amax(thr_next, dim=-1) > 0.0)

        o2 = vm.where3(alive2, new_o + new_d * EPSILON, s["o"])
        d2 = vm.where3(alive2, new_d, s["d"])

        # ---- NEE at surface and medium vertices together; the
        # continuation ray is traced at the NEXT body's top ----
        nee_rays = 0
        tr_nee = nee_dir = None
        rj = "rj_b" in s
        if els and settings.num_lights > 0:
            vertex = (shade | vol_scatter) if has_media else shade
            do_nee = vertex & (bounce < settings.max_bounces - 1)
            if mlt_len >= 0:
                do_nee = do_nee & (bounce + 2 == mlt_len)
            ctx = dict(p=info["p"], sp=sp, frame=(tan, bit, ns),
                       wi_local=wi_local, gate=do_nee)
            if has_media:
                ctx.update(p=vm.where3(vol_scatter, med_point, info["p"]),
                           is_volume=vol_scatter, ray_d=s["d"],
                           medium=s["medium"], phase_type=phase_type,
                           phase_g=phase_g)
            nee, nee_rays, tr_nee, nee_dir = _nee(
                scene, settings, ctx, seed, pixel, sample_idx, dim_base, smp,
                want_tr=settings.track_aovs, media=media, want_dir=rj)
            emission = emission + torch.where(do_nee[..., None],
                                              nee * throughput, 0.0)

        # ---- direct emitter hit ----
        prim = info["prim"]
        etex = scene.prim_emission_tex[prim]
        is_emissive = etex >= 0
        samplable = scene.prim_light[prim] >= 0
        guard = s["was_specular"] | ~samplable | (not els)
        front = torch.sum(info["ng"] * s["d"], dim=-1) < 0.0
        li = torch.clamp(scene.prim_light[prim], 0,
                         max(scene.light_emission.shape[0] - 1, 0))
        e_val = vm.take(scene.light_emission, li.long())
        e_tex = vm.take(scene.tex_const, torch.clamp(
            etex, 0, scene.tex_const.shape[0] - 1).long())
        e_hit = torch.where(samplable[..., None], e_val, e_tex)
        take_emit = shade & is_emissive & front & \
            (bounce >= settings.min_bounces)
        if one_sample:
            lpdf = L.area_light_direct_pdf(
                scene, li.long(), res["t"], s["d"], info["ng"], p=s["o"],
                has_sphere_lights=settings.has_sphere_lights) * \
                _light_select_pmf(scene, settings, s["o"], li)
            w_emit = torch.where(guard, 1.0,
                                 L.power_heuristic(s["pdf_fwd"], lpdf))
            emission = emission + torch.where(
                take_emit[..., None], throughput * e_hit * w_emit[..., None],
                0.0)
        else:
            take_emit = take_emit & guard
            if mlt_len >= 0:
                take_emit = take_emit & (bounce + 1 == mlt_len)
            emission = emission + torch.where(
                take_emit[..., None], throughput * e_hit, 0.0)

        out = dict(
            o=o2, d=d2, throughput=thr_next, emission=emission,
            was_specular=was_specular, alive=alive2, bounce=bounce + 1,
            rays=s["rays"] + rays_top + nee_rays,
            pixel=pixel, sample=sample_idx,
        )
        if has_media:
            out.update(medium=medium, med_first=med_first,
                       med_bounce=med_bounce)
        if one_sample:
            out["pdf_fwd"] = torch.where(shade & ok, pdf, s["pdf_fwd"])
        if "lane" in s:
            out["lane"] = s["lane"]
        if rj:
            out.update(_rj_step(scene, settings, s, res, info, sp, wi_local,
                                (tan, bit, ns), shade, nee_dir, seed))

        # ---- output-value capture (ref PathTracer.cpp:78-96,133-140):
        # depth/normal/albedo/visibility at the first non-specular or
        # terminating surface vertex; escapes record normal/env-albedo ----
        if settings.track_aovs:
            def add(buf, val, mask):
                c = mask.to(torch.float32)[..., None]
                if val.ndim == 1:
                    val = val[..., None]
                return buf + torch.cat([val * c, c], dim=-1)

            aov_dist = s["aov_dist"] + torch.where(active, res["t"], 0.0)
            rec = shade & ~s["aov_recorded"] & (~was_specular | (active & ~ok))
            esc = escaped & ~s["aov_recorded"]
            depth = add(s["aov_depth"], aov_dist, rec)
            # escaped primaries record depth 0 (PathTracer.cpp:134-135)
            depth = add(depth, torch.zeros_like(aov_dist), esc & (bounce == 0))
            normal = add(add(s["aov_normal"], info["ns"], rec), -s["d"], esc)
            albedo = add(s["aov_albedo"], sp.albedo + torch.where(
                is_emissive[..., None], e_hit, 0.0), rec)
            if settings.has_env:
                albedo = add(albedo, L.env_eval(scene, s["d"], active=esc),
                             esc)
            vis = s["aov_vis"]
            if tr_nee is not None:
                vis = add(vis, torch.mean(tr_nee[0], dim=-1),
                          rec & tr_nee[1])
            out.update(aov_recorded=s["aov_recorded"] | rec | esc,
                       aov_dist=aov_dist, aov_depth=depth, aov_normal=normal,
                       aov_albedo=albedo, aov_vis=vis)
        return out

    return body


RJ_FIELDS = ("rj_b", "rj_dims", "rj_valid", "rj_nee", "rj_rev_valid",
             "rj_pp")
# the rj fields each lane writes at most once: banked by lane like the
# accumulators, so compaction keeps them
RJ_RESULTS = ("rj_dims", "rj_valid", "rj_nee", "rj_rev_valid")


def _rj_step(scene, settings, s, res, info, sp, wi_local, frame, shade,
             nee_dir, seed):
    """The reversible-jump bookkeeping of one body (the JAX package's rj
    block): at each lane's bounce rj_b, invert both techniques.

      * forward: the continuation sampler's coordinates (lobe, u1, u2,
        lobe2) that aim the bounce's bsdf sample at the NEE light
        direction (bsdf_invert, the reference's Bsdf::invert), where that
        direction's shadow ray reached the light;
      * reverse, one body later: whether rj_b's continuation ray (this
        body's top trace `res`) hit the front of a samplable area light,
        and the NEE sampler's coordinates (light select, u1, u2, triangle
        pick) that regenerate that hit from rj_b's shading point rj_pp.

    The inversions' free coordinates come from untracked pcg4d draws keyed
    on rj_b's dim block, never from the tape.  As in the JAX package, a
    pick rj_b = max_bounces - 1 never validates (no NEE there, and no body
    runs the reverse check) and a medium vertex at rj_b never shades
    (rj_pp stays as it was).  Returns the rj fields of the body's
    output."""
    from tungsten_tpu_torch.bsdf.invert import bsdf_invert
    from tungsten_tpu_torch.integrators.invert_path import (
        invert_area_light_point, invert_choose_light)
    keep = {k: s[k] for k in RJ_FIELDS}
    if nee_dir is None:
        return keep
    pixel, sample_idx, bounce = s["pixel"], s["sample"], s["bounce"]
    seed32 = int(seed) & 0xFFFFFFFF
    dim_base = rng.DIMS_CAMERA + bounce * rng.DIMS_PER_BOUNCE
    tan, bit, ns = frame
    at_b = shade & (s["rj_b"] == bounce)
    d, d_ok = nee_dir
    mu = torch.stack(rng.untracked_4d(seed32 ^ 0x52A11CE, pixel, sample_idx,
                                      dim_base), dim=-1)
    inv = bsdf_invert(sp, wi_local, vm.to_local(tan, bit, ns, d),
                      settings.present_bsdf_types, mu)
    take = at_b & d_ok & inv["valid"]
    new_dims = torch.stack([inv["lobe"], inv["u1"], inv["u2"],
                            inv["lobe2"]], dim=-1)
    out = dict(keep)
    out["rj_dims"] = torch.where(take[..., None], new_dims, s["rj_dims"])
    out["rj_valid"] = s["rj_valid"] | take

    at_rev = s["alive"] & (s["rj_b"] + 1 == bounce)
    hit_prim = _hit_prim(scene, res)
    li_hit = scene.prim_light[torch.clamp(hit_prim, min=0).long()]
    li_c = torch.clamp(li_hit, 0,
                       max(scene.light_type.shape[0] - 1, 0)).long()
    front = torch.sum(s["d"] * _hit_ng(scene, res), dim=-1) < 0.0
    is_area_hit = res["hit"] & (li_hit >= 0) & \
        (scene.light_type[li_c] == LIGHT_AREA) & front & (res["tri"] >= 0)
    dim_prev = rng.DIMS_CAMERA + (bounce - 1) * rng.DIMS_PER_BOUNCE
    mu2 = rng.untracked_4d(seed32 ^ 0x2E5, pixel, sample_idx, dim_prev)
    u_tri, lu1, lu2, ok_pos = invert_area_light_point(
        scene, li_c, torch.clamp(res["tri"], 0, scene.lt_slot.shape[0] - 1),
        res["u"], res["v"], mu2[0])
    u_sel, ok_sel = invert_choose_light(scene, settings, s["rj_pp"], li_hit,
                                        mu2[1])
    take_r = at_rev & is_area_hit & ok_pos & ok_sel
    nee_dims = torch.stack([u_sel, lu1, lu2, u_tri], dim=-1)
    out["rj_nee"] = torch.where(take_r[..., None], nee_dims, s["rj_nee"])
    out["rj_rev_valid"] = s["rj_rev_valid"] | take_r
    out["rj_pp"] = vm.where3(at_b, info["p"], s["rj_pp"])
    return out


def init_wave(scene, settings, pixel, sample_idx, seed):
    """Initial wavefront state (camera rays, traced by the first body)."""
    return _init_state(scene, settings, pixel, sample_idx, seed)


def run_bounces(scene, settings, seed, state, bounce_end):
    """Advance the wavefront until bounce_end (or extinction)."""
    body = _make_bounce_body(scene, settings, seed)
    end = min(int(bounce_end), settings.max_bounces)
    while state["bounce"] < end and bool(state["alive"].any()):
        state = body(state)
    return state


def trace_wave(scene, settings, pixel, sample_idx, seed, with_stats=False,
               min_wave: int = 4096, step: int = 2, tape=None):
    """Trace one radiance sample per entry; pixel/sample_idx (R,) int32.
    Returns radiance (R,3), or (radiance, rays traced as a 0-d int64
    tensor) with stats.  The staged loop, banking by lane.  `tape` (an
    rng.Tape) drives every draw from its rows instead of the counter
    hash (the MLT integrators)."""
    banks, rays = _staged(scene, settings, pixel, sample_idx, seed,
                          pixel.shape[0], min_wave, step, key="lane",
                          tape=tape)
    if with_stats:
        return banks["emission"], rays
    return banks["emission"]


def trace_wave_rj(scene, settings, pixel, sample_idx, seed, rj_b, tape=None,
                  with_stats=False, min_wave: int = 4096, step: int = 2):
    """Trace one sample per entry while inverting, at each lane's bounce
    rj_b ((R,) int32), both techniques (_rj_step): the continuation
    sampler's coordinates that aim the bounce's bsdf sample at the NEE
    light direction, and the NEE sampler's coordinates that regenerate
    the continuation ray's area-light hit.  Returns (radiance (R,3),
    rj_dims (R,4), rj_valid (R,), rj_nee (R,4), rj_rev_valid (R,)), the
    reversible-jump exchange's raw material (JAX trace_wave_rj), with
    stats also the rays traced."""
    R = pixel.shape[0]
    dev = pixel.device
    z = torch.zeros((R,), dtype=torch.bool, device=dev)
    extra = dict(rj_b=torch.broadcast_to(
        torch.as_tensor(rj_b, dtype=torch.int32, device=dev), (R,))
        .contiguous(),
        rj_dims=torch.zeros((R, 4), dtype=torch.float32, device=dev),
        rj_valid=z, rj_nee=torch.zeros((R, 4), dtype=torch.float32,
                                       device=dev),
        rj_rev_valid=z, rj_pp=torch.zeros((R, 3), dtype=torch.float32,
                                          device=dev))
    banks, rays = _staged(scene, settings, pixel, sample_idx, seed, R,
                          min_wave, step, key="lane", tape=tape, extra=extra)
    out = (banks["emission"], banks["rj_dims"],
           banks["rj_valid"][:, 0] > 0.5, banks["rj_nee"],
           banks["rj_rev_valid"][:, 0] > 0.5)
    return out + (rays,) if with_stats else out


def trace_wave_aovs(scene, settings, pixel, sample_idx, seed,
                    with_stats=False, min_wave: int = 4096, step: int = 2):
    """Trace one sample per entry with output-value tracking.  Returns
    (radiance (R,3), aovs) where aovs maps depth/normal/albedo/visibility
    to (value, count) arrays — count is 0 or 1 per sample, as the
    reference's per-AOV OutputBuffer::addSample counts
    (OutputBuffer.hpp:88-130); with stats also the rays traced."""
    from dataclasses import replace
    settings = replace(settings, track_aovs=True)
    banks, rays = _staged(scene, settings, pixel, sample_idx, seed,
                          pixel.shape[0], min_wave, step, key="lane")
    aovs = dict(depth=banks["aov_depth"], normal=banks["aov_normal"],
                albedo=banks["aov_albedo"], visibility=banks["aov_vis"])
    if with_stats:
        return banks["emission"], aovs, rays
    return banks["emission"], aovs


# per-ray sums that retire into banks: radiance, each AOV's (value,
# count) and the reversible-jump results (written once a lane, so their
# bank sums are the values; flags bank as 0 / 1); everything else in the
# state is carried
ACCUMULATORS = ("emission", "aov_depth", "aov_normal", "aov_albedo",
                "aov_vis") + RJ_RESULTS


def bank(state, n_total, key="pixel"):
    """Scatter every ray's accumulators into (n_total, C) buffers by
    state[key] (rays with key >= n_total are dropped).  By pixel (the
    framebuffer) non-finite radiance is dropped too; by lane it is kept,
    so each sample comes back as traced.  The sums add in a fixed order
    (ops/segment_sum.py): a pixel's samples in ascending sample order,
    the order the CPU's state holds them in (the card's body sort moves
    rays, so its rows are sorted by (pixel, sample) first); lanes are
    unique, so each lane's bank is its one row."""
    idx = state[key]
    keep = (idx < n_total)[..., None]
    # a dropped ray adds +0.0, which changes no sum wherever it lands: it
    # banks at key % n_total, so that a padded chunk's dropped rays spread
    # over the frame and no pixel's ordered sum walks them all
    idx = torch.where(keep[..., 0], idx, idx % n_total).long()
    vals = {}
    for k in ACCUMULATORS:
        if k not in state:
            continue
        v = state[k]
        if v.ndim == 1:
            v = v.to(torch.float32)[..., None]
        if k == "emission" and key == "pixel":
            v = torch.where(torch.isfinite(v), v, 0.0)
        vals[k] = torch.where(keep, v, 0.0)
    if key == "lane":
        return index_sums(idx, vals, n_total, grouped=True)
    return index_sums(idx, vals, n_total,
                      key=(idx << 31) | state["sample"].long())


def pack_rows(state):
    """Pack every leading-R state field into one (R, F) f32 matrix (ints
    and bools bitcast through int32).  Returns (rows, specs, the fields
    that pass through: scalars and host values)."""
    r = state["alive"].shape[0]
    cols, specs, passthru = [], [], {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == r:
            flat = v.reshape(r, -1)
            if flat.dtype == torch.float32:
                cols.append(flat)
            else:
                cols.append(flat.to(torch.int32).view(torch.float32))
            specs.append((k, v.shape[1:], v.dtype, flat.shape[1]))
        else:
            passthru[k] = v
    return torch.cat(cols, dim=1), specs, passthru


def unpack_rows(rows, specs, passthru):
    """pack_rows' inverse on (possibly moved or sliced) rows."""
    new_r = rows.shape[0]
    out = dict(passthru)
    off = 0
    for k, tshape, dtype, w in specs:
        part = rows[:, off:off + w]
        off += w
        if dtype == torch.bool:
            part = part.view(torch.int32) != 0
        elif dtype != torch.float32:
            part = part.view(torch.int32).to(dtype)
        out[k] = part.reshape((new_r,) + tuple(tshape))
    return out


def _gather_rows(state, idx):
    """Apply a row permutation/slice `idx` to every leading-R state field
    with ONE packed row gather."""
    rows, specs, passthru = pack_rows(state)
    return unpack_rows(rows[idx], specs, passthru)


def compact_wave(state, new_r: int):
    """Gather alive rays to the front (stable) and slice to new_r rows;
    zeroes the accumulators (bank must be called first)."""
    order = torch.argsort(torch.where(state["alive"], 0, 1).to(torch.int32),
                          stable=True)
    out = _gather_rows(state, order[:new_r])
    for k in ACCUMULATORS:
        if k in out:
            out[k] = torch.zeros_like(out[k])
    # compacted-away padding must not resurrect
    out["alive"] = out["alive"] & (
        torch.arange(new_r, device=out["alive"].device) <
        torch.sum(state["alive"]))
    return out


# the staged schedule of a whole render: on CUDA compact after every
# bounce to width / 2; the CPU (tests) compacts to width / 4 (the JAX
# package's CPU schedule); the tail runs at MIN_WAVE lanes or fewer
MIN_WAVE = 1024
WIDTH_STEP = 2


def staged_schedule(device: torch.device) -> dict:
    """The staged loop's min_wave and step for a render on `device`."""
    return dict(min_wave=MIN_WAVE,
                step=4 if device.type == "cpu" else WIDTH_STEP)


def _staged(scene, settings, pixel, sample_idx, seed, n_total: int,
            min_wave: int, step: int, key: str, tape=None, extra=None):
    """The width-staged bounce schedule: run the bounce body at a fixed
    width until the survivors fit the next width (width // step), bank
    every ray's accumulators by `key`, compact, repeat down to min_wave,
    then run the tail to extinction.  key "pixel" banks into the
    framebuffer; key "lane" banks by input entry (n_total = R), which
    undoes the body's sort and the compactions.  `tape` drives the draws
    (rng.Tape, each lane reading its entry's row; key "lane" only);
    `extra` adds state fields (trace_wave_rj's).  Returns ({accumulator:
    (n_total, C) sum; a flag's C is 1}, rays traced as a 0-d int64
    tensor)."""
    if tape is not None and key != "lane":
        raise ValueError("a tape is read by lane: trace it banking by lane")
    body = _make_bounce_body(scene, settings, seed, tape=tape)
    state = _init_state(scene, settings, pixel, sample_idx, seed, tape=tape)
    state.update(extra or {})
    if key == "lane":
        state["lane"] = torch.arange(pixel.shape[0], dtype=torch.int32,
                                     device=pixel.device)
    banks = None
    w = pixel.shape[0]
    while True:
        nxt = w // step
        last = nxt < min_wave
        while state["bounce"] < settings.max_bounces and (
                bool(state["alive"].any()) if last
                else int(torch.sum(state["alive"])) > nxt):
            state = body(state)
        part = bank(state, n_total, key)
        banks = part if banks is None else \
            {k: banks[k] + v for k, v in part.items()}
        if last:
            return banks, state["rays"]
        state = compact_wave(state, nxt)
        w = nxt


def trace_wave_staged(scene, settings, pixel, sample_idx, seed,
                      n_total: int, min_wave: int = 4096, step: int = 2):
    """The staged loop banking into the framebuffer.  Returns ((n_total,
    3) framebuffer sum, rays traced as a 0-d int64 tensor)."""
    banks, rays = _staged(scene, settings, pixel, sample_idx, seed, n_total,
                          min_wave, step, key="pixel")
    return banks["emission"], rays


def bank_emission(state, n_total: int):
    """Scatter every ray's accumulated radiance into an (n_total, 3)
    framebuffer by pixel id (rays with pixel >= n_total are dropped,
    non-finite radiance too: ref PathTracer.cpp:119-122)."""
    return bank(state, n_total, key="pixel")["emission"]


# ------------------------------------------------------- path replay
#
# Path-replay backprop (Vicini et al. 2021, detached-sampling variant),
# the JAX package's _replay_tracer.  The forward saves nothing per
# bounce; the backward re-traces the same path (the (pixel, sample,
# bounce, dim)-keyed RNG repeats every decision bit for bit) and adds up
# one bounce's vector-Jacobian product at a time:
#
#     L = e_0 + w_0 (e_1 + w_1 (e_2 + ...)),  all decisions detached
#     dL = sum_b T_b (de_b + dw_b . S_{b+1}),
#     S_{b+1} = (L - prefix_{b+1}) / T_{b+1}   (suffix radiance)
#
# The bounce body maps a detached state to (emission', throughput') =
# (prefix + T_b e_b(theta), T_b w_b(theta)), so the cotangents
# (g, g * S_{b+1}) on one body's outputs give both summands.


@dataclass
class ReplayStats:
    """What one replay reports (trace_wave_replay(with_stats=True)): the
    rays its forward traced and, once its backward has run, that pass's
    final re-traced emission (the forward's L, bit for bit) and the
    bounce bodies it ran."""
    rays: torch.Tensor | None = None
    emission: torch.Tensor | None = None
    bodies: int = 0


def _scene_params(scene):
    """The FlatScene float tensors that require grad: (slots, tensors),
    a slot being (field, None) or, for a tuple field, (field, index)."""
    from dataclasses import fields
    from tungsten_tpu_torch.scene.flatten import TUPLE_FIELDS
    slots, params = [], []
    for f in fields(scene):
        v = getattr(scene, f.name)
        items = enumerate(v) if f.name in TUPLE_FIELDS else [(None, v)]
        for i, x in items:
            if isinstance(x, torch.Tensor) and x.requires_grad:
                slots.append((f.name, i))
                params.append(x)
    return tuple(slots), params


def _with_params(scene, slots, params):
    """`scene` with the tensors at `slots` replaced by `params`."""
    changes = {}
    for (name, i), x in zip(slots, params):
        if i is None:
            changes[name] = x
        else:
            t = list(changes.get(name, getattr(scene, name)))
            t[i] = x
            changes[name] = tuple(t)
    return scene.replace(**changes)


def _replay_loop(settings, state):
    return state["bounce"] < settings.max_bounces and \
        bool(state["alive"].any())


def replay_forward(scene, settings, pixel, sample_idx, seed):
    """The replay's forward without a graph: the bounce body at full
    width, no compaction and no body-start sort, until max_bounces or
    until no lane is alive.  Returns (L (R,3), rays as a 0-d int64
    tensor)."""
    with torch.no_grad():
        state = _init_state(scene, settings, pixel, sample_idx, seed)
        body = _make_bounce_body(scene, settings, seed, replay=True)
        while _replay_loop(settings, state):
            state = body(state)
    return state["emission"], state["rays"]


def replay_backward(scene, settings, pixel, sample_idx, seed, L, g, slots,
                    params):
    """d<g, L>/d params by path replay: each bounce body re-runs on the
    detached state under autograd, and its (emission, throughput) take
    the cotangents (g, g * suffix).  Memory stays that of one body.
    Returns (gradients, one per param; the final re-traced emission;
    the bodies run)."""
    leaves = [p.detach().requires_grad_() for p in params]
    sc = _with_params(scene, slots, leaves)
    with torch.no_grad():
        state = _init_state(sc, settings, pixel, sample_idx, seed)
    body = _make_bounce_body(sc, settings, seed, replay=True)
    grads = [torch.zeros_like(p) for p in params]
    bodies = 0
    while _replay_loop(settings, state):
        with torch.enable_grad():
            out = body(state)
        thr = out["throughput"].detach()
        live = torch.abs(thr) > 1e-12
        suffix = torch.where(
            live, (L - out["emission"].detach()) /
            torch.where(live, thr, 1.0), 0.0)
        pairs = [(x, c) for x, c in ((out["emission"], g),
                                     (out["throughput"], g * suffix))
                 if x.requires_grad]
        if pairs and leaves:
            gs = torch.autograd.grad([x for x, _ in pairs], leaves,
                                     [c for _, c in pairs],
                                     allow_unused=True)
            grads = [a if b is None else a + b for a, b in zip(grads, gs)]
        state = {k: v.detach() if isinstance(v, torch.Tensor) else v
                 for k, v in out.items()}
        bodies += 1
    return grads, state["emission"], bodies


class _Replay(torch.autograd.Function):
    """L = trace(scene; pixel, sample, seed) with the scene's tensors
    that require grad as explicit inputs (autograd sees only those);
    pixel, sample and seed take no gradient.  `stats` (a ReplayStats)
    takes the forward's rays and the backward's final emission."""

    @staticmethod
    def forward(ctx, scene, settings, pixel, sample_idx, seed, slots, stats,
                *params):
        L, stats.rays = replay_forward(scene, settings, pixel, sample_idx,
                                       seed)
        ctx.replay = (scene, settings, seed, slots, stats)
        ctx.save_for_backward(pixel, sample_idx, L, *params)
        return L

    @staticmethod
    def backward(ctx, g):
        scene, settings, seed, slots, stats = ctx.replay
        pixel, sample_idx, L, *params = ctx.saved_tensors
        grads, stats.emission, stats.bodies = replay_backward(
            scene, settings, pixel, sample_idx, seed, L, g, slots, params)
        return (None,) * 7 + tuple(grads)


def trace_wave_replay(scene, settings, pixel, sample_idx, seed,
                      with_stats: bool = False):
    """Differentiable radiance estimate by path-replay backprop: flat
    memory in bounce count, full `max_bounces` depth.  Gradients flow to
    every FlatScene tensor that requires grad (set one with
    `scene.replace(field=t.requires_grad_())`) through the shading
    chain (albedo, emission, roughness, ior, textures, media); sampling
    decisions and intersections are detached (interior derivatives
    only).  Returns radiance (R,3), with stats also a ReplayStats."""
    slots, params = _scene_params(scene)
    stats = ReplayStats()
    L = _Replay.apply(scene, settings, pixel, sample_idx, seed, slots, stats,
                      *params)
    return (L, stats) if with_stats else L


# The JAX package's name for the same estimator.
trace_wave_diff = trace_wave_replay
