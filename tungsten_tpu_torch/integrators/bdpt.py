"""Bidirectional path tracer and light tracer (port of
tungsten_tpu/integrators/bdpt.py): wavefront SoA subpaths, every (s,t)
connection strategy with balance-heuristic MIS, medium path vertices,
forward-surface collapse, and the t=1 lens connections that splat.

Camera and emitter subpaths are fixed-size SoA vertex arrays (R, V,
...) built by bounded random walks; every (s,t) strategy is a masked
computation over the whole wave with one visibility query.  The
strategies are a static Python loop, as in the JAX package:
`s + t - 1 > max_edges` and `mlt_path_length` drop strategies before
anything runs.  Every lane runs at full width (no wave compaction).

MIS parity (LightPath::misWeight + toAreaMeasure, LightPath.cpp:
32-180): vertex pdf_fwd / pdf_rev are stored in area measure with the
medium distance pdfs of their edge and the cosine at the vertex folded
in (cosineFactor 1 at medium vertices); forward-lobe surfaces are
collapsed out of the path during the walk (the crossing's probability
and the crossed sub-segments' medium pdfs fold into the surviving edge);
connections use the generalized shadow ray with forward and backward
medium pdf products; specular vertices are not connectable.

Port notes:
  * A walk writes its vertex slots by index: the fields of one vertex
    are packed into one f32 row (the ints and bools as int32 bit
    patterns) and stored with one index_put a step, lanes that record
    nothing writing a spare slot V that is never read.  The values are
    the JAX package's one-hot writes'.
  * The walk's fixed-count loop ends early when no lane is alive (one
    host read a step): from then on no lane records, escapes or counts
    a ray, so every output is the full loop's.  A step's read is one
    sync against the hundreds of launches the step makes.
  * A connection's visibility query traces only the lanes whose
    connection is otherwise valid (far limit 0 elsewhere), as the port's
    path tracer does for its shadow rays: the JAX package traces every
    lane and masks the others, whose results are the only ones that
    differ.  The simple connection (no media, no forward lobes) is one
    any-hit launch (K2 on the card); the general one hops through
    forward-lobe surfaces with closest hits (K1), at most MAX_CONN_HOPS,
    ending when no lane is active.  The segment's transmittance and
    both its medium pdfs share one optical-depth query.
  * The sampler is `settings.stratified_sampler`, or the MLT tape
    (`tape`, an rng.Tape whose light columns take the light root's and
    walk's dims from LIGHT_WALK_DIM_OFFSET on), threaded into every draw
    (the JAX package latches both in module globals).  Lanes never move,
    so lane i reads tape row i.
"""
from __future__ import annotations

import math

import torch

from tungsten_tpu_torch.bsdf.eval import (FLAG_SPECULAR, FLAG_VALID,
                                          ShadePoint, bsdf_eval, bsdf_forward,
                                          bsdf_pdf, bsdf_sample)
from tungsten_tpu_torch.integrators import lights as L
from tungsten_tpu_torch.integrators.path_tracer import (
    EPSILON, INF, SHADOW_FUDGE, _expand_hit, _has_forward_types, _hit_ng,
    _hit_uv_bsdf, _Media, _select_medium, shading_frame)
from tungsten_tpu_torch.media import grid as GR
from tungsten_tpu_torch.media import phase as PH
from tungsten_tpu_torch.media import transmittance as TR
from tungsten_tpu_torch.ops.intersect import bvh_intersect, occluded
from tungsten_tpu_torch.scene.flatten import (LIGHT_CYLINDER, LIGHT_DISK,
                                              LIGHT_SPHERE)
from tungsten_tpu_torch.utils import rng
from tungsten_tpu_torch.utils import vecmath as vm

# RNG dim blocks: the camera subpath uses the camera dims and the
# per-bounce blocks, the light subpath an offset block
LIGHT_WALK_DIM_OFFSET = rng.LIGHT_DIM_OFFSET
FWD_HOP_BUDGET = 4   # extra walk iterations for collapsed forward hops
MAX_CONN_HOPS = 6    # forward-surface crossings a connection ray may pass
LENS_SEED_XOR = 0x7E15C0DE

# the packed vertex row: f32 columns, then int32 bit patterns
_F3 = {"p": 0, "ns": 3, "ng": 6, "wi": 9, "alpha": 12}
_UV = 15
_F1 = {"pdf_fwd": 17, "dist_prev": 18, "edge_pb": 19}
_I1 = {"bsdf": 20, "prim": 21, "med_at": 22, "orig": 23}
_B1 = {"valid": 24, "spec": 25, "is_med": 26}
NCOL = 27


def _area_pdf_m(pdf_solid, edge_pdf, d, dist, n_at, is_med_at=None):
    """Area-measure pdf at a vertex including the edge's medium pdf;
    medium vertices have cosineFactor 1 (ref PathVertex::cosineFactor).
    is_med_at None: no medium vertex."""
    cos_next = torch.abs(torch.sum(d * n_at, dim=-1))
    if is_med_at is not None:
        cos_next = torch.where(is_med_at, 1.0, cos_next)
    return pdf_solid * edge_pdf * cos_next / torch.clamp(dist * dist,
                                                         min=1e-20)


# ------------------------------------------------------------------ media

def _medium_segment(scene, settings, media, med, med_first, o, d, max_t,
                    start_surf, u_c, u_d, u_e, active):
    """Distance-sample one walk segment through medium `med` (-1 =
    vacuum) (ref HomogeneousMedium::sampleDistance +
    Medium::transmittanceAndPdfs).  Returns dict(t (R,), scattered (R,),
    w (R,3) medium weight, pf (R,) channel-averaged forward distance pdf,
    pb (R,) backward pdf of the reverse ray).  `active` limits the voxel
    work to the lanes whose result is used."""
    laws = media.laws
    in_med = med >= 0
    mi = torch.clamp(med, 0, media.n - 1).long()
    sigma_s = vm.take(scene.med_sigma_s, mi)
    sigma_t = vm.take(scene.med_sigma_a, mi) + sigma_s
    absorb_only = torch.amax(sigma_s, dim=-1) == 0.0
    tt = scene.med_trans_type[mi]
    tp = scene.med_trans_params[mi]

    comp = torch.clamp((u_c * 3).to(torch.int32), max=2)
    sigma_tc = torch.gather(sigma_t, -1, comp[..., None].long())[..., 0]
    t_law = TR.sample_distance(tt, tp, med_first, u_d, u_e, laws)
    if media.het:
        # invert the unit optical depth along the density field (ref
        # VoxelMedium/ExponentialMedium::sampleDistance)
        tau_c = t_law / torch.clamp(sigma_tc, min=1e-20)
        t_m, rho, tau_tot = GR.inverse_unit_tau(
            scene, settings, mi, o, d, max_t, tau_c, active=active & in_med)
        exited = (t_m >= max_t) | absorb_only
        ut_used = torch.where(exited, tau_tot, tau_c)
        rho_e = torch.where(exited, 1.0, rho)[..., None]
        t_used = torch.minimum(torch.where(absorb_only, max_t, t_m), max_t)
        tau = sigma_t * ut_used[..., None]
        # density at the segment start (the reverse pdf's event factor)
        rho0 = GR.density(scene, settings, mi, o)[..., None]
    else:
        t_m = t_law / torch.clamp(sigma_tc, min=1e-20)
        exited = (t_m >= max_t) | absorb_only
        t_used = torch.where(exited, max_t, t_m)
        tau = sigma_t * torch.where(torch.isfinite(t_used), t_used,
                                    3e38)[..., None]
        rho_e = rho0 = 1.0

    ones = torch.ones_like(exited)
    sbar = TR.sigma_bar(tt, tp, laws)
    w_exit = TR.eval_tr(tt, tau, tp, med_first, ones, laws)
    p_exit = torch.mean(TR.surface_probability(tt, tau, tp, med_first, laws),
                        dim=-1)
    tr_med = TR.eval_tr(tt, tau, tp, med_first, ~ones, laws)
    w_scat = tr_med * rho_e * sigma_s * sbar[..., None]
    p_scat = torch.mean(rho_e * sigma_t * TR.medium_pdf(tt, tau, tp,
                                                        med_first, laws),
                        dim=-1)
    w = torch.where(exited[..., None], w_exit, w_scat) / torch.clamp(
        torch.where(exited, p_exit, p_scat), min=1e-20)[..., None]
    w = torch.where(absorb_only[..., None], w_exit, w)
    pf = torch.where(exited, p_exit, p_scat)
    pf = torch.where(absorb_only, 1.0, pf)
    # backward: the reverse ray starts at the sampled endpoint; its event
    # density factor sits at the segment start
    pb = torch.where(
        start_surf,
        torch.mean(TR.surface_probability(tt, tau, tp, exited, laws), dim=-1),
        torch.mean(rho0 * sigma_t * TR.medium_pdf(tt, tau, tp, exited, laws),
                   dim=-1))
    pb = torch.where(absorb_only, 1.0, pb)
    w = torch.where(torch.isfinite(w), w, 0.0)
    return dict(t=torch.where(in_med, t_used, max_t),
                scattered=in_med & ~exited,
                w=torch.where(in_med[..., None], w, 1.0),
                pf=torch.where(in_med, pf, 1.0),
                pb=torch.where(in_med, pb, 1.0))


def _segment_terms(scene, settings, media, med, o, d, seg_len, start_surf,
                   end_surf, active):
    """A connection sub-segment through medium `med`: (transmittance
    (R,3), channel-averaged distance pdf along d, the same along -d) —
    the JAX package's _medium_tr_seg and its two _medium_pdf_dir calls,
    from one optical-depth query (heterogeneous media integrate the
    density along [o, o + d * seg_len]; `active` limits that work)."""
    laws = media.laws
    mi = torch.clamp(med, 0, media.n - 1).long()
    sigma_s = vm.take(scene.med_sigma_s, mi)
    sigma_t = vm.take(scene.med_sigma_a, mi) + sigma_s
    absorb_only = torch.amax(sigma_s, dim=-1) == 0.0
    tt = scene.med_trans_type[mi]
    tp = scene.med_trans_params[mi]
    if media.het:
        ut = GR.unit_tau(scene, settings, mi, o, d, seg_len,
                         active=active & (med >= 0))
    else:
        ut = torch.where(torch.isfinite(seg_len), seg_len, 3e38)
    tau = sigma_t * ut[..., None]
    in_med = med >= 0
    tr = TR.eval_tr(tt, tau, tp, start_surf, end_surf, laws)
    tr = torch.where(torch.isfinite(tr), tr, 0.0)
    tr = torch.where(in_med[..., None], tr, 1.0)

    def pdf_dir(s_surf, e_surf):
        p_surf = torch.mean(TR.surface_probability(tt, tau, tp, s_surf, laws),
                            dim=-1)
        p_med = torch.mean(sigma_t * TR.medium_pdf(tt, tau, tp, s_surf, laws),
                           dim=-1)
        p = torch.where(e_surf, p_surf, p_med)
        p = torch.where(absorb_only, 1.0, p)
        return torch.where(in_med, p, 1.0)

    return tr, pdf_dir(start_surf, end_surf), pdf_dir(end_surf, start_surf)


def _connection_walk(scene, settings, media, o, d, dist, med, start_surf,
                     end_surf, active):
    """Generalized shadow ray with medium pdf accumulation for a
    connection edge (ref TraceBase::generalizedShadowRayAndPdfs): walks
    forward-lobe surfaces, multiplying their transparency into the
    transmittance and their discrete probability into both pdf products;
    each medium sub-segment multiplies its forward / backward distance
    pdf.  Only `active` lanes are traced.  Returns (tr (R,3), pf along d,
    pb along -d); the pdfs are 1.0 in the simple case."""
    simple = not settings.has_media and not _has_forward_types(settings)
    far0 = torch.where(dist >= INF, INF, dist * SHADOW_FUDGE)
    if simple:
        occ = occluded(scene, o, d, 0.0, torch.where(active, far0, 0.0))
        return torch.where(occ[..., None], 0.0, 1.0).expand(o.shape), 1.0, 1.0

    fwd = _has_forward_types(settings)
    R = o.shape[0]
    remaining = far0
    tr = torch.ones((R, 3), dtype=torch.float32, device=o.device)
    pf = torch.ones((R,), dtype=torch.float32, device=o.device)
    pb = torch.ones_like(pf)
    hops = 0
    while hops < MAX_CONN_HOPS and bool(active.any()):
        res = bvh_intersect(scene, o, d, EPSILON,
                            torch.where(active, remaining, 0.0))
        did_hit = res["hit"] & active
        if settings.has_media:
            seg = torch.where(did_hit, res["t"], remaining)
            seg_tr, seg_pf, seg_pb = _segment_terms(
                scene, settings, media, med, o, d, seg, start_surf,
                did_hit | end_surf, active)
            tr = tr * torch.where(active[..., None], seg_tr, 1.0)
            pf = pf * torch.where(active, seg_pf, 1.0)
            pb = pb * torch.where(active, seg_pb, 1.0)

        # surface crossing: must be a forward-lobe surface
        uv, bsdf_idx, prim = _hit_uv_bsdf(scene, res)
        ng = _hit_ng(scene, res)
        if fwd:
            sp = ShadePoint(scene, bsdf_idx.long(), uv)
            cosd = torch.abs(torch.sum(d * ng, dim=-1))
            wi_proxy = torch.stack(
                [torch.sqrt(torch.clamp(1 - cosd ** 2, min=0.0)),
                 torch.zeros_like(cosd), cosd], dim=-1)
            transp = bsdf_forward(sp, wi_proxy, settings.present_bsdf_types)
        else:
            transp = torch.zeros_like(tr)
        t_scalar = torch.mean(transp, dim=-1)
        passes = torch.amax(transp, dim=-1) > 0.0
        tr = torch.where((did_hit & ~passes)[..., None], 0.0, tr)
        cross = did_hit & passes
        tr = tr * torch.where(cross[..., None], transp, 1.0)
        pf = pf * torch.where(cross, t_scalar, 1.0)
        pb = pb * torch.where(cross, t_scalar, 1.0)
        if settings.has_media:
            backside = torch.sum(d * ng, dim=-1) > 0.0
            med = torch.where(cross, _select_medium(scene, prim, med,
                                                    ~backside), med)
        o = torch.where(did_hit[..., None], o + d * res["t"][..., None], o)
        remaining = torch.where(did_hit, remaining - res["t"], remaining)
        active = active & cross & (remaining > EPSILON)
        start_surf = start_surf | did_hit
        hops += 1
    return torch.where(active[..., None], 0.0, tr), pf, pb


# --------------------------------------------------------------- subpaths

def _unpack_vertices(rows, pdf_rev, nv):
    """The packed (R, nv + 1, NCOL) rows as per-field (R, nv[, c]) views
    (the spare slot dropped)."""
    out = {k: rows[:, :nv, c:c + 3] for k, c in _F3.items()}
    out["uv"] = rows[:, :nv, _UV:_UV + 2]
    out.update({k: rows[:, :nv, c] for k, c in _F1.items()})
    out.update({k: rows[:, :nv, c].view(torch.int32) for k, c in _I1.items()})
    out.update({k: rows[:, :nv, c].view(torch.int32) != 0
                for k, c in _B1.items()})
    out["pdf_rev"] = pdf_rev[:, :nv]
    return out


def _trace_subpath(scene, settings, media, o, d, alpha, adjoint, seed,
                   pixel, sample_idx, dim_base, nv, pdf_solid, n0, med0=None,
                   escapes=False, smp=None):
    """Random walk storing per-vertex SoA arrays (ref LightPath::tracePath
    + PathVertex::sampleNextVertex).

    Returns dict of (R, nv) arrays: p, ns, ng, wi (unit, toward the
    previous vertex), alpha (throughput up to arrival at the vertex),
    pdf_fwd (area measure, incl. edge medium pdfs + cosine), pdf_rev (of
    this vertex from its successor), bsdf, uv, spec, valid, prim, is_med,
    med_at (medium the vertex sits in), edge_pb (backward medium *
    forward pdf product of the incoming edge), dist_prev (collapsed edge
    length), orig (edge count from the root, collapsed forward crossings
    counted); root_rev (R,): area pdf of the root re-sampled from walk
    vertex 0; rays (0-d int64): live intersect queries; with `escapes`
    the first escape's esc_d, esc_alpha, esc_edges, esc_valid.

    o/d: first ray; alpha (R,3); pdf_solid: solid-angle pdf of d from the
    root; n0: root normal (area conversions); med0: medium the root emits
    into (None: no media); smp: the sampler (rng.sampler; None: the
    settings')."""
    R = o.shape[0]
    dev = o.device
    smp = rng.sampler(settings) if smp is None else smp
    types = settings.present_bsdf_types
    has_media = settings.has_media
    has_fwd = _has_forward_types(settings)
    niter = nv + (FWD_HOP_BUDGET if has_fwd else 0)

    init = torch.zeros((R, nv + 1, NCOL), dtype=torch.int32, device=dev)
    init[..., _I1["med_at"]] = -1
    rows = init.view(torch.float32)
    pdf_rev = torch.zeros((R, nv + 1), dtype=torch.float32, device=dev)
    lanes = torch.arange(R, device=dev)
    spare = torch.full((R,), nv, dtype=torch.int64, device=dev)
    zf = torch.zeros((R,), dtype=torch.float32, device=dev)
    zb = torch.zeros((R,), dtype=torch.bool, device=dev)
    out = dict(root_rev=zf, rays=torch.zeros((), dtype=torch.int64,
                                             device=dev))
    if escapes:
        out.update(esc_d=torch.zeros((R, 3), device=dev),
                   esc_alpha=torch.zeros((R, 3), device=dev),
                   esc_edges=torch.zeros((R,), dtype=torch.int32, device=dev),
                   esc_valid=zb)
    med = med0 if med0 is not None else \
        torch.full((R,), -1, dtype=torch.int32, device=dev)
    med_first = torch.ones((R,), dtype=torch.bool, device=dev)
    start_surf = med_first
    vi = torch.zeros((R,), dtype=torch.int32, device=dev)
    ei = vi
    pend_r, pend_pf, pend_pb = zf, zf + 1.0, zf + 1.0
    prev_n, prev_is_med = n0, zb
    alive = ~zb

    for i in range(niter):
        if not bool(alive.any()):
            break
        dims = dim_base + i * rng.DIMS_PER_BOUNCE
        out["rays"] = out["rays"] + torch.sum(alive.to(torch.int64))
        res = bvh_intersect(scene, o, d, 0.0, torch.where(alive, INF, 0.0))
        hit = res["hit"] & alive
        max_t = torch.where(hit, res["t"], INF)
        if has_media:
            u_c, u_d, u_e = rng.random_3d(seed, pixel, sample_idx,
                                          dims + rng.BounceDims.MEDIUM, smp)
            ms = _medium_segment(scene, settings, media, med, med_first, o, d,
                                 max_t, start_surf, u_c, u_d, u_e, alive)
            vol_ev = alive & ms["scattered"]
            alpha_arr = alpha * ms["w"]
            seg_t, seg_pf, seg_pb = ms["t"], ms["pf"], ms["pb"]
        else:
            vol_ev = zb
            alpha_arr = alpha
            seg_t, seg_pf, seg_pb = max_t, 1.0, 1.0
        surf_ev = hit & ~vol_ev

        if escapes:
            # env escape (camera side; light subpaths never root on the
            # env, so crediting it at weight 1 double counts no strategy)
            first_esc = alive & ~res["hit"] & ~vol_ev & ~out["esc_valid"]
            out["esc_d"] = vm.where3(first_esc, d, out["esc_d"])
            out["esc_alpha"] = vm.where3(first_esc, alpha_arr,
                                         out["esc_alpha"])
            out["esc_edges"] = torch.where(first_esc, ei, out["esc_edges"])
            out["esc_valid"] = out["esc_valid"] | first_esc

        info = _expand_hit(scene, o, d, res)
        ng = info["ng"]
        ns = info["ns"]
        if settings.two_sided_shading:
            backside = torch.sum(ng * d, dim=-1) > 0.0
            ns = torch.where(backside[..., None], -ns, ns)
        tan, bit = shading_frame(info, ns)
        wi_local = vm.to_local(tan, bit, ns, -d)
        sp = ShadePoint(scene, info["bsdf"], info["uv"])

        # ---- forward-surface collapse (toAreaMeasure step 1, online) ----
        if has_fwd:
            transp = bsdf_forward(sp, wi_local, types)
            t_scalar = torch.mean(transp, dim=-1)
            u_fwd = rng.random_1d(seed, pixel, sample_idx,
                                  dims + rng.BounceDims.FORWARD, smp)
            take_fwd = surf_ev & (torch.amax(transp, dim=-1) > 0) & \
                (u_fwd < t_scalar)
            fwd_w = transp / torch.clamp(t_scalar, min=1e-20)[..., None]
            record_surf = surf_ev & ~take_fwd
        else:
            take_fwd = zb
            record_surf = surf_ev
        record = (record_surf | vol_ev) & (vi < nv)

        r_tot = pend_r + seg_t
        pf_tot = pend_pf * seg_pf
        pb_tot = pend_pb * seg_pb

        # ---- the vertex ----
        if has_media:
            vp = vm.where3(vol_ev, o + d * seg_t[..., None], info["p"])
            cos_v = torch.where(vol_ev, 1.0,
                                torch.abs(torch.sum(ng * d, dim=-1)))
        else:
            vp = info["p"]
            cos_v = torch.abs(torch.sum(ng * d, dim=-1))
        pdf_fwd = pdf_solid * pf_tot * cos_v / torch.clamp(r_tot * r_tot,
                                                           min=1e-20)
        pdf_fwd = torch.where(torch.isfinite(pdf_fwd), pdf_fwd, 0.0)

        # ---- continuation sampling at the vertex ----
        ul = rng.random_1d(seed, pixel, sample_idx,
                           dims + rng.BounceDims.BSDF_LOBE, smp)
        u1, u2 = rng.random_2d(seed, pixel, sample_idx,
                               dims + rng.BounceDims.BSDF_SAMPLE, smp)
        ul2 = rng.random_1d(seed, pixel, sample_idx,
                            dims + rng.BounceDims.BSDF_LOBE2, smp)
        wo, wt, pdf_new, flags = bsdf_sample(sp, wi_local, ul, u1, u2, types,
                                             u_lobe2=ul2, adjoint=adjoint)
        spec = (flags & FLAG_SPECULAR) != 0
        ok = ((flags & FLAG_VALID) != 0) & (torch.amax(wt, dim=-1) > 0)
        new_d = vm.to_global(tan, bit, ns, wo)
        if adjoint:
            # shading-normal adjoint correction (Bsdf.hpp:75-79)
            adj = torch.abs(torch.sum(new_d * ng, dim=-1) * wi_local[..., 2]) \
                / torch.clamp(torch.abs(torch.sum(d * ng, dim=-1)
                                        * wo[..., 2]), min=1e-9)
            wt = wt * torch.clamp(adj, 0.0, 8.0)[..., None]
        rev_solid = bsdf_pdf(sp, wo, wi_local, types)
        rev_solid = torch.where(spec, pdf_new, rev_solid)
        if has_media:
            mi = torch.clamp(med, 0, media.n - 1).long()
            pt_, pg_ = scene.med_phase[mi], vm.take(scene.med_g, mi)
            pw, ppdf = PH.phase_sample(pt_, pg_, d, u1, u2)
            new_d = vm.where3(vol_ev, pw, new_d)
            pdf_new = torch.where(vol_ev, ppdf, pdf_new)
            wt = torch.where(vol_ev[..., None], 1.0, wt)
            ok = torch.where(vol_ev, ppdf > 0, ok)
            # ref MediumVertex: prev->_pdfBackward = phase->pdf(-wo, -d)
            rev_solid = torch.where(vol_ev, PH.phase_pdf(pt_, pg_, -pw, -d),
                                    rev_solid)
            spec = spec & ~vol_ev

        # the recorded vertex, one packed row at slot vi
        ints = torch.stack([info["bsdf"].to(torch.int32),
                            torch.where(vol_ev, -1, info["prim"]).to(
                                torch.int32),
                            med.to(torch.int32), ei + 1,
                            torch.ones_like(vi), spec.to(torch.int32),
                            vol_ev.to(torch.int32)], dim=-1)
        row = torch.cat([vp, ns, ng, -d, alpha_arr, info["uv"],
                         pdf_fwd[:, None], r_tot[:, None], pb_tot[:, None],
                         ints.view(torch.float32)], dim=-1)
        rows.index_put_((lanes, torch.where(record, vi.long(), spare)), row)

        # reverse pdf of the previous vertex (area, incl. edge pdf_bwd)
        if has_media:
            cos_prev = torch.where(prev_is_med, 1.0,
                                   torch.abs(torch.sum(prev_n * d, dim=-1)))
        else:
            cos_prev = torch.abs(torch.sum(prev_n * d, dim=-1))
        prev_rev = rev_solid * pb_tot * cos_prev / torch.clamp(r_tot * r_tot,
                                                               min=1e-20)
        prev_rev = torch.where(torch.isfinite(prev_rev), prev_rev, 0.0)
        pdf_rev.index_put_(
            (lanes, torch.where(record & (vi > 0), vi.long() - 1, spare)),
            prev_rev)
        out["root_rev"] = torch.where(record & (vi == 0), prev_rev,
                                      out["root_rev"])

        # ---- next state ----
        new_alpha = alpha_arr * wt
        o_rec = vp + new_d * EPSILON
        alpha_next = torch.where(record[..., None], new_alpha, alpha)
        if has_fwd:
            o = vm.where3(take_fwd, info["p"] + d * EPSILON, o_rec)
            d_next = vm.where3(take_fwd, d, new_d)
            alpha = torch.where(take_fwd[..., None], alpha_arr * fwd_w,
                                alpha_next)
            pend_r = torch.where(take_fwd, r_tot, 0.0)
            pend_pf = torch.where(take_fwd, pf_tot * t_scalar, 1.0)
            pend_pb = torch.where(take_fwd, pb_tot * t_scalar, 1.0)
        else:
            o, d_next, alpha = o_rec, new_d, alpha_next
        pdf_solid = torch.where(record, pdf_new, pdf_solid)
        if has_media:
            geo_back_f = torch.sum(d * ng, dim=-1) < 0.0
            geo_back_s = torch.sum(new_d * ng, dim=-1) < 0.0
            med_f = _select_medium(scene, info["prim"], med, geo_back_f)
            med_s = _select_medium(scene, info["prim"], med, geo_back_s)
            med = torch.where(take_fwd, med_f,
                              torch.where(record_surf, med_s, med))
            med_first = torch.where(vol_ev, False,
                                    med_first | record_surf | take_fwd)
            start_surf = ~vol_ev
        d = d_next
        vi = vi + record.to(torch.int32)
        ei = ei + (record | take_fwd).to(torch.int32)
        alive = ((record & ok) | take_fwd) & (ei < niter + 1)
        alive = alive & ((vi < nv) | take_fwd)
        prev_n = vm.where3(record, ng, prev_n)
        if has_media:
            prev_is_med = torch.where(record, vol_ev, prev_is_med)

    out.update(_unpack_vertices(rows, pdf_rev, nv))
    return out


# ----------------------------------------------------------------- roots

def _sample_light_root(scene, settings, R, seed, pixel, sample_idx,
                       smp=None):
    """Pick a light uniformly, a point on it and a cosine direction.
    Returns dict: q, n, Le, li, prim, pdf_a (area pdf incl. the pick),
    d0, pdf0_solid, alpha_v0, alpha_walk, pick_pdf, area, med (the medium
    the emitter radiates into, ref PathVertex::sampleRootVertex)."""
    smp = rng.sampler(settings) if smp is None else smp
    dev = pixel.device
    nl = settings.num_lights
    base = LIGHT_WALK_DIM_OFFSET
    u_sel = rng.random_1d(seed, pixel, sample_idx, base + 0, smp)
    li = torch.clamp((u_sel * nl).to(torch.int32), max=nl - 1).long()
    pick_pdf = 1.0 / nl

    u1, u2 = rng.random_2d(seed, pixel, sample_idx, base + 1, smp)
    u_tri = rng.random_1d(seed, pixel, sample_idx, base + 3, smp)
    if scene.tri_v0.shape[0] > 0:
        tri = torch.clamp(L.alias_pick_tri(scene, li, u_tri), 0,
                          scene.tri_v0.shape[0] - 1).long()
        su = torch.sqrt(torch.clamp(u1, min=0.0))
        b1 = 1.0 - su
        b2 = (1.0 - u2) * su
        e1 = scene.tri_e1[tri]
        e2 = scene.tri_e2[tri]
        q = scene.tri_v0[tri] + b1[..., None] * e1 + b2[..., None] * e2
        n = vm.normalize(torch.linalg.cross(e1, e2, dim=-1), 1e-20)
    else:
        q = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        n = q + torch.tensor([0.0, 0.0, 1.0], device=dev)

    # analytic disk / cylinder / sphere emitters (ref Disk, Cylinder,
    # Sphere::samplePosition): a uniform-area point and its normal
    ltype = scene.light_type[li]
    if settings.has_disk_lights:
        is_dl = ltype == LIGHT_DISK
        slot = torch.clamp(scene.light_slot[li], 0,
                           scene.dsk_r.shape[0] - 1).long()
        nd = scene.dsk_n[slot]
        tan_d, bit_d = vm.ortho_frame(nd)
        rho = torch.sqrt(torch.clamp(u1, min=0.0)) * scene.dsk_r[slot]
        phi = u2 * 2.0 * math.pi
        qd = scene.dsk_c[slot] + (torch.cos(phi) * rho)[..., None] * bit_d \
            + (torch.sin(phi) * rho)[..., None] * tan_d
        q = vm.where3(is_dl, qd, q)
        n = vm.where3(is_dl, nd, n)
    if settings.has_cyl_lights:
        is_cl = ltype == LIGHT_CYLINDER
        slot = torch.clamp(scene.light_slot[li], 0,
                           scene.cyl_r.shape[0] - 1).long()
        qc, nc = L.cyl_position_sample(scene, slot, u1, u2, u_tri)
        q = vm.where3(is_cl, qc, q)
        n = vm.where3(is_cl, nc, n)
    if settings.has_sphere_lights:
        is_sl = ltype == LIGHT_SPHERE
        slot = torch.clamp(scene.light_slot[li], 0,
                           scene.sph_radius.shape[0] - 1).long()
        phi = u1 * 2.0 * math.pi
        z = 2.0 * u2 - 1.0
        sr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        ns_ = torch.stack([torch.cos(phi) * sr, torch.sin(phi) * sr, z], -1)
        qs = scene.sph_center[slot] + ns_ * scene.sph_radius[slot][..., None]
        q = vm.where3(is_sl, qs, q)
        n = vm.where3(is_sl, ns_, n)

    area = scene.light_area[li]
    pdf_a = pick_pdf / torch.clamp(area, min=1e-20)
    Le = scene.light_emission[li]

    # cosine-hemisphere emission direction
    u3, u4 = rng.random_2d(seed, pixel, sample_idx, base + 4, smp)
    phi = u3 * 2.0 * math.pi
    r = torch.sqrt(u4)
    z = torch.sqrt(torch.clamp(1.0 - u4, min=0.0))
    t, b = vm.ortho_frame(n)
    d0 = vm.to_global(t, b, n, torch.stack(
        [torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1))
    pdf0_solid = torch.clamp(z, min=1e-9) * vm.INV_PI

    prim = scene.light_prim[li]
    med = scene.prim_ext_medium[torch.clamp(
        prim, 0, scene.prim_ext_medium.shape[0] - 1).long()]
    # Veach: alpha_1 = Le / pdf_a; leaving the light the walk's alpha
    # multiplies cos / pdf0_solid
    alpha_v0 = Le / pdf_a[..., None]
    alpha_walk = alpha_v0 * (z / pdf0_solid)[..., None]
    return dict(q=q, n=n, Le=Le, li=li, prim=prim, pdf_a=pdf_a, d0=d0,
                pdf0_solid=pdf0_solid, alpha_v0=alpha_v0,
                alpha_walk=alpha_walk, pick_pdf=pick_pdf, area=area, med=med)


def _camera_local(scene, d_world):
    return d_world @ scene.cam_mat[:3, :3]  # the forward transform's transpose


def _camera_dir_pdf(scene, settings, d_world):
    """Solid-angle pdf of the pinhole camera emitting direction d
    (invPlaneArea / cos^3, ref PinholeCamera::sampleDirection)."""
    cosz = torch.clamp(_camera_local(scene, d_world)[..., 2], min=1e-6)
    ratio = settings.height / settings.width
    plane_area = (2.0 / scene.cam_plane_dist) * \
        (2.0 * ratio / scene.cam_plane_dist)
    return (1.0 / plane_area) / torch.clamp(cosz ** 3, min=1e-9)


def _pixel_of(settings, lx, ly, ok):
    w, h = settings.width, settings.height
    ratio = h / w
    px = (lx + 1.0) * 0.5 * w
    py = (ratio - ly) * (0.5 * w)
    ok = ok & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pix = torch.clamp(py.to(torch.int32), 0, h - 1) * w + \
        torch.clamp(px.to(torch.int32), 0, w - 1)
    return pix, ok


def _thinlens_pixel(scene, settings, lens_local, d_world):
    """A world direction leaving the thinlens at camera-local lens point
    `lens_local` -> (pixel, valid): the focus-plane projection and the
    cat-eye diaphragm gate (ref ThinlensCamera::evalDirection,
    ThinlensCamera.cpp:150-176)."""
    local = _camera_local(scene, d_world)
    ok = local[..., 2] > 0
    lz = torch.clamp(local[..., 2], min=1e-9)
    fp = local * (settings.focus_distance / lz)[..., None] + lens_local
    fz = torch.clamp(fp[..., 2], min=1e-9)
    lx = fp[..., 0] / fz * scene.cam_plane_dist
    ly = fp[..., 1] / fz * scene.cam_plane_dist
    if settings.cat_eye > 0.0:
        dia = lens_local[..., :2] - settings.cat_eye * \
            scene.cam_plane_dist * local[..., :2] / lz[..., None]
        ok = ok & (torch.sum(dia * dia, dim=-1) <= settings.aperture_size ** 2)
    return _pixel_of(settings, lx, ly, ok)


def _camera_pixel(scene, settings, d_world):
    """A world direction -> (pixel, valid) through the pinhole."""
    local = _camera_local(scene, d_world)
    ok = local[..., 2] > 0
    lz = torch.clamp(local[..., 2], min=1e-9)
    lx = local[..., 0] / lz * scene.cam_plane_dist
    ly = local[..., 1] / lz * scene.cam_plane_dist
    return _pixel_of(settings, lx, ly, ok)


# ------------------------------------------------------------ vertex eval

def _vertex_eval(scene, settings, verts, idx, wo_world, adjoint=False):
    """Scatter eval at stored vertex `idx` toward wo_world: (f,
    pdf_fwd_solid, pdf_rev_solid).  Surfaces: the BSDF with |cos(wo)|
    folded in; medium vertices: the phase value, no cosine (ref
    PathVertex::eval / evalPdfs).  adjoint for light-subpath vertices."""
    types = settings.present_bsdf_types
    ns = verts["ns"][:, idx]
    wi_world = verts["wi"][:, idx]
    tan, bit = vm.ortho_frame(ns)
    wi_l = vm.to_local(tan, bit, ns, wi_world)
    wo_l = vm.to_local(tan, bit, ns, wo_world)
    sp = ShadePoint(scene, verts["bsdf"][:, idx].long(), verts["uv"][:, idx])
    f = bsdf_eval(sp, wi_l, wo_l, types, adjoint=adjoint)
    pdf_f = bsdf_pdf(sp, wi_l, wo_l, types)
    pdf_r = bsdf_pdf(sp, wo_l, wi_l, types)
    if settings.has_media:
        is_med = verts["is_med"][:, idx]
        mi = torch.clamp(verts["med_at"][:, idx], 0,
                         scene.med_phase.shape[0] - 1).long()
        pt_, pg_ = scene.med_phase[mi], vm.take(scene.med_g, mi)
        # the stored wi points toward the previous vertex
        pv_f = PH.phase_eval(pt_, pg_, -wi_world, wo_world)
        pv_r = PH.phase_eval(pt_, pg_, -wo_world, wi_world)
        f = torch.where(is_med[..., None], pv_f[..., None], f)
        pdf_f = torch.where(is_med, pv_f, pdf_f)
        pdf_r = torch.where(is_med, pv_r, pdf_r)
    return f, pdf_f, pdf_r


def _vertex_conn_medium(scene, verts, idx, d_out):
    """Medium of the connection segment leaving stored vertex idx along
    d_out (ref PathVertex::selectMedium)."""
    med = verts["med_at"][:, idx]
    prim = torch.clamp(verts["prim"][:, idx], 0,
                       scene.prim_int_medium.shape[0] - 1).long()
    geo_back = torch.sum(d_out * verts["ng"][:, idx], dim=-1) < 0.0
    return torch.where(verts["is_med"][:, idx], med,
                       _select_medium(scene, prim, med, geo_back))


def _mis_weight(pdf_fwd, pdf_rev, connectable, s, t):
    """Balance-heuristic MIS over the combined path (length s + t,
    emitter side first; lists of (R,) entries).  LightPath::misWeight's
    ratio recursion: the product runs over every vertex, an alternative
    strategy is added only when both vertices of its connection are
    connectable."""
    n = s + t
    weight = torch.ones_like(pdf_fwd[0])
    # camera-side alternatives: the connection moves toward the camera
    pi = torch.ones_like(weight)
    for i in range(s + 1, n):
        pi = pi * pdf_fwd[i - 1] / torch.clamp(pdf_rev[i - 1], min=1e-20)
        ok = connectable[i - 1] & connectable[i]
        weight = weight + torch.where(ok, pi, 0.0)
    # emitter-side alternatives: the connection moves toward the light
    pi = torch.ones_like(weight)
    for i in range(s - 1, 0, -1):
        pi = pi * pdf_rev[i] / torch.clamp(pdf_fwd[i], min=1e-20)
        ok = connectable[i - 1] & connectable[i]
        weight = weight + torch.where(ok, pi, 0.0)
    if s >= 1:
        # the pure camera path (s' = 0), always available for non-Dirac
        # area emitters (ref LightPath.cpp:166-173)
        pi = pi * pdf_rev[0] / torch.clamp(pdf_fwd[0], min=1e-20)
        weight = weight + pi
    return 1.0 / torch.clamp(weight, min=1e-20)


def _mis_weight_s0(pdf_fwd, pdf_rev, connectable, t, root_connectable):
    """MIS of the s=0 strategy (the full camera path): the alternatives
    extend the light side, up to the t'=1 splat (k = t, admitted when the
    reconstruction filter is not Dirac)."""
    weight = torch.ones_like(pdf_fwd[0])
    pi = torch.ones_like(weight)
    for k in range(1, t + 1):
        pi = pi * pdf_fwd[k - 1] / torch.clamp(pdf_rev[k - 1], min=1e-20)
        if k < t:
            ok = connectable[k - 1] & connectable[k]
        elif root_connectable:
            ok = connectable[k - 1]
        else:
            continue
        weight = weight + torch.where(ok, pi, 0.0)
    return 1.0 / torch.clamp(weight, min=1e-20)


# ----------------------------------------------------- MIS array builders

def _is_med(settings, verts, k):
    """Walk slot k's medium-vertex flags (None without media)."""
    return verts["is_med"][:, k] if settings.has_media else None


def _build_emitter_side(settings, lig, root, s, R, pdf_conn_to_light,
                        pdf_light_rev_solid, dev):
    """Combined-array entries for the emitter side (indices 0..s-1).
    pdf_conn_to_light: area pdf of the connecting light vertex sampled
    from the camera side (incl. the connection edge's medium pdf);
    pdf_light_rev_solid: solid-angle pdf at the connecting light vertex
    toward its predecessor given the connection direction (s >= 2)."""
    yes = torch.ones((R,), dtype=torch.bool, device=dev)
    pdf_fwd = [root["pdf_a"]]
    if s == 1:
        return pdf_fwd, [pdf_conn_to_light], [yes]
    pdf_rev, conn = [], [yes]
    if s == 2:
        # the root's reverse pdf from the connecting vertex, with the new
        # incoming direction (ref PathVertex::evalPdfs)
        pdf_rev.append(_area_pdf_m(pdf_light_rev_solid, lig["edge_pb"][:, 0],
                                   lig["wi"][:, 0], lig["dist_prev"][:, 0],
                                   root["n"]))
    else:
        pdf_rev.append(lig["root_rev"])
    # middle vertices: combined index j = 1..s-2, walk index j-1
    for j in range(1, s - 1):
        wj = j - 1
        pdf_fwd.append(lig["pdf_fwd"][:, wj])
        if j == s - 2:
            pdf_rev.append(_area_pdf_m(
                pdf_light_rev_solid, lig["edge_pb"][:, s - 2],
                lig["wi"][:, s - 2], lig["dist_prev"][:, s - 2],
                lig["ng"][:, s - 3], _is_med(settings, lig, s - 3)))
        else:
            pdf_rev.append(lig["pdf_rev"][:, wj])
        conn.append(~lig["spec"][:, wj])
    # index s-1: the connecting light vertex (walk s-2), connectable
    pdf_fwd.append(lig["pdf_fwd"][:, s - 2])
    pdf_rev.append(pdf_conn_to_light)
    conn.append(yes)
    return pdf_fwd, pdf_rev, conn


def _build_camera_side(settings, cam, t, R, pdf_light_to_cam,
                       pdf_cam_rev_solid, dev):
    """Combined-array entries for the camera side (indices s..s+t-1): the
    connecting camera vertex (connectable), its predecessor's reverse
    pdf recomputed with the connection direction, then the rest toward
    the lens, whose connectable flag follows the reconstruction filter's
    Dirac-ness (ref PathVertex: _dirac = camera->isFilterDirac())."""
    ci = t - 2  # camera walk index of the connecting vertex
    ones = torch.ones((R,), dtype=torch.float32, device=dev)
    root = torch.full((R,), settings.filter != "dirac", dtype=torch.bool,
                      device=dev)
    pdf_fwd = [pdf_light_to_cam]
    pdf_rev = [cam["pdf_fwd"][:, ci]]
    conn = [ones > 0]
    if ci == 0:
        # the predecessor is the lens
        return pdf_fwd + [ones], pdf_rev + [ones], conn + [root]
    pdf_fwd.append(_area_pdf_m(pdf_cam_rev_solid, cam["edge_pb"][:, ci],
                               cam["wi"][:, ci], cam["dist_prev"][:, ci],
                               cam["ng"][:, ci - 1],
                               _is_med(settings, cam, ci - 1)))
    pdf_rev.append(cam["pdf_fwd"][:, ci - 1])
    conn.append(~cam["spec"][:, ci - 1])
    for j in range(2, t):
        cj = ci - j  # walk index; -1 is the lens
        if cj >= 0:
            pdf_fwd.append(cam["pdf_rev"][:, cj])
            pdf_rev.append(cam["pdf_fwd"][:, cj])
            conn.append(~cam["spec"][:, cj])
        else:
            pdf_fwd.append(ones)
            pdf_rev.append(ones)
            conn.append(root)
    return pdf_fwd, pdf_rev, conn


# ------------------------------------------------------------ connections

def _light_vertex(settings, lig, root, s, R, dev):
    """The connecting light vertex s-1 (walk slot s-2; s == 1 is the
    root): (p, ng, alpha, is_med or None, orig, walk slot or None)."""
    if s == 1:
        return (root["q"], root["n"], root["alpha_v0"], None,
                torch.zeros((R,), dtype=torch.int32, device=dev), None)
    si = s - 2
    return (lig["p"][:, si], lig["ng"][:, si], lig["alpha"][:, si],
            _is_med(settings, lig, si), lig["orig"][:, si], si)


def _emitter_eval(cos_l):
    """The emitter's directional eval at the root: its cosine lobe
    (radiance is in alpha_v0), the emission pdf, no reverse pdf."""
    f = torch.clamp(cos_l, min=0.0)
    return (f[..., None].expand(cos_l.shape + (3,)), f * vm.INV_PI,
            torch.zeros_like(cos_l), cos_l > 0)


def _connect(scene, settings, media, cam, lig, root, s, t, R):
    """Connect light vertex s-1 with camera vertex t-1 (walk slots s-2 /
    t-2; s == 1 is the light root).  Ref LightPath::bdptConnect.
    Returns (contribution (R,3), MIS weight (R,), ok (R,))."""
    dev = cam["p"].device
    ci = t - 2
    cam_ok = cam["valid"][:, ci] & ~cam["spec"][:, ci]
    pc = cam["p"][:, ci]
    is_med_c = _is_med(settings, cam, ci)
    pl, nl_, alpha_l, is_med_l, orig_l, si = _light_vertex(settings, lig,
                                                           root, s, R, dev)
    dvec = pl - pc
    r2 = torch.sum(dvec * dvec, dim=-1)
    dist = torch.sqrt(torch.clamp(r2, min=1e-20))
    dw = dvec / dist[..., None]  # camera vertex -> light vertex

    f_c, pdf_c_f, pdf_c_r = _vertex_eval(scene, settings, cam, ci, dw)
    cos_l = torch.sum(-dw * nl_, dim=-1)
    if si is None:
        f_l, pdf_l_f, pdf_l_r, ok = _emitter_eval(cos_l)
        ok = ok & cam_ok
    else:
        f_l, pdf_l_f, pdf_l_r = _vertex_eval(scene, settings, lig, si, -dw,
                                             adjoint=True)
        ok = cam_ok & lig["valid"][:, si] & ~lig["spec"][:, si]
    contrib = cam["alpha"][:, ci] * f_c * f_l * alpha_l / \
        torch.clamp(r2, min=1e-20)[..., None]

    # degenerate-geometry guard (ref: cosineFactor < 1e-5 rejects)
    cos_c = torch.abs(torch.sum(dw * cam["ng"][:, ci], dim=-1))
    geo_c = cos_c > 1e-5
    geo_l = torch.abs(cos_l) > 1e-5
    if is_med_c is not None:
        geo_c = is_med_c | geo_c
    if is_med_l is not None:
        geo_l = is_med_l | geo_l
    ok = ok & geo_c & geo_l & (torch.amax(contrib, dim=-1) > 0)
    # bounce budget in original vertex indices (collapsed forwards count)
    ok = ok & (orig_l + cam["orig"][:, ci] < settings.max_bounces)

    # visibility + the connection edge's medium pdfs, from the camera side
    start_surf = end_surf = torch.ones_like(ok)
    med_conn = None
    if settings.has_media:
        med_conn = _vertex_conn_medium(scene, cam, ci, dw)
        start_surf = ~is_med_c
        if is_med_l is not None:
            end_surf = ~is_med_l
    tr, pf_cl, pb_cl = _connection_walk(
        scene, settings, media, pc + dw * EPSILON, dw, dist, med_conn,
        start_surf, end_surf, ok)
    contrib = contrib * tr
    ok = ok & (torch.amax(tr, dim=-1) > 0)

    # ---- MIS ----
    pdf_conn_to_light = _area_pdf_m(pdf_c_f, pf_cl, dw, dist, nl_, is_med_l)
    pdf_light_to_cam = _area_pdf_m(pdf_l_f, pb_cl, -dw, dist,
                                   cam["ng"][:, ci], is_med_c)
    e_f, e_r, e_c = _build_emitter_side(settings, lig, root, s, R,
                                        pdf_conn_to_light, pdf_l_r, dev)
    c_f, c_r, c_c = _build_camera_side(settings, cam, t, R, pdf_light_to_cam,
                                       pdf_c_r, dev)
    w = _mis_weight(e_f + c_f, e_r + c_r, e_c + c_c, s, t)
    return contrib, w, ok


def _connect_lens(scene, settings, media, lig, root, s, R, seed, pixel,
                  sample_idx, mis=True, smp=None):
    """t=1: connect light vertex s-1 to the lens; returns (pixel, value,
    ok) for splatting (ref LightPath::bdptCameraConnect).  mis=False is
    the light tracer's estimator (every lens connection at weight 1, ref
    LightTracer.cpp:12-88).  A thinlens camera connects to an aperture
    point sampled per strategy (ref ThinlensCamera::sampleDirect), keyed
    on seed ^ LENS_SEED_XOR and dims 3s..3s+2; the pixel then projects
    through the focus plane and the cat-eye diaphragm gates it."""
    dev = pixel.device
    pl, nl_, alpha_l, is_med_l, orig_l, si = _light_vertex(settings, lig,
                                                           root, s, R, dev)
    cam_pos = scene.cam_mat[:3, 3]
    thinlens = settings.camera_type == "thinlens"
    if thinlens:
        from tungsten_tpu_torch.cameras.camera import sample_aperture
        smp = rng.sampler(settings) if smp is None else smp
        lens_seed = (int(seed) & 0xFFFFFFFF) ^ LENS_SEED_XOR
        u3, u4 = rng.random_2d(lens_seed, pixel, sample_idx, 3 * s, smp)
        u5 = rng.random_1d(lens_seed, pixel, sample_idx, 3 * s + 2, smp)
        lens_local = sample_aperture(scene, settings, u3, u4, u5)
        cam_point = lens_local @ scene.cam_mat[:3, :3].T + cam_pos
    else:
        cam_point = cam_pos
    dvec = cam_point - pl
    r2 = torch.sum(dvec * dvec, dim=-1)
    dist = torch.sqrt(torch.clamp(r2, min=1e-20))
    dw = dvec / dist[..., None]  # light vertex -> camera

    if thinlens:
        pix, in_frame = _thinlens_pixel(scene, settings, lens_local, -dw)
    else:
        pix, in_frame = _camera_pixel(scene, settings, -dw)
    pdf_dir = _camera_dir_pdf(scene, settings, -dw)
    cos_l = torch.sum(dw * nl_, dim=-1)
    if si is None:
        f_l, pdf_l_f, pdf_l_r, ok = _emitter_eval(cos_l)
    else:
        f_l, pdf_l_f, pdf_l_r = _vertex_eval(scene, settings, lig, si, dw,
                                             adjoint=True)
        ok = lig["valid"][:, si] & ~lig["spec"][:, si]

    # pinhole importance: splatting alpha * f * pdf_dir / (rSq |cos(axis)|)
    # reproduces the pixel estimate
    cos_axis = torch.abs(torch.sum(dw * scene.cam_mat[:3, 2], dim=-1))
    val = alpha_l * f_l * (pdf_dir / (torch.clamp(r2, min=1e-20) *
                                      torch.clamp(cos_axis, min=1e-9)))[..., None]
    ok = ok & in_frame & (torch.amax(val, dim=-1) > 0)
    ok = ok & (orig_l < settings.max_bounces)

    # visibility walk from the light vertex toward the lens
    start_surf = torch.ones_like(ok)
    med_conn = None
    if settings.has_media:
        med_conn = root["med"] if si is None else \
            _vertex_conn_medium(scene, lig, si, dw)
        if is_med_l is not None:
            start_surf = ~is_med_l
    tr, _, pb_lc = _connection_walk(
        scene, settings, media, pl + dw * EPSILON, dw, dist, med_conn,
        start_surf, torch.ones_like(ok), ok)
    val = val * tr
    ok = ok & (torch.amax(tr, dim=-1) > 0)
    if not mis:
        return pix, val, ok

    # MIS: the emitter side and one connectable camera root entry
    pdf_conn_to_light = _area_pdf_m(pdf_dir, pb_lc, -dw, dist, nl_, is_med_l)
    e_f, e_r, e_c = _build_emitter_side(settings, lig, root, s, R,
                                        pdf_conn_to_light, pdf_l_r, dev)
    one = torch.ones((R,), dtype=torch.float32, device=dev)
    w = _mis_weight(e_f + [one], e_r + [one], e_c + [one > 0], s, 1)
    return pix, val * w[..., None], ok


# -------------------------------------------------------------- strategies

def _light_subpath(scene, settings, media, seed, pixel, sample_idx, nv,
                   smp=None):
    R = pixel.shape[0]
    root = _sample_light_root(scene, settings, R, seed, pixel, sample_idx,
                              smp=smp)
    lig = _trace_subpath(scene, settings, media,
                         root["q"] + root["d0"] * EPSILON, root["d0"],
                         root["alpha_walk"], True, seed, pixel, sample_idx,
                         LIGHT_WALK_DIM_OFFSET + 16, nv, root["pdf0_solid"],
                         root["n"],
                         med0=root["med"] if settings.has_media else None,
                         smp=smp)
    return root, lig


def _lens_strategies(s_list, scene, settings, media, lig, root, seed, pixel,
                     sample_idx, mis, smp=None):
    """The t=1 lens connections for each s: (splat pixels (R*S,), values
    (R*S,3), rays)."""
    R = pixel.shape[0]
    rays = 0
    pix_l, val_l = [], []
    for s in s_list:
        rays = rays + torch.sum(lig["valid"][:, s - 1].to(torch.int64))
        pixv, val, ok = _connect_lens(scene, settings, media, lig, root, s, R,
                                      seed, pixel, sample_idx, mis=mis,
                                      smp=smp)
        pix_l.append(torch.where(ok, pixv, 0))
        val_l.append(torch.where(ok[..., None], val, 0.0))
    if not pix_l:
        return (torch.zeros((0,), dtype=torch.int32, device=pixel.device),
                torch.zeros((0, 3), device=pixel.device), rays)
    return torch.cat(pix_l), torch.cat(val_l), rays


def _lens_s(settings, nv, me):
    return [s for s in range(1, nv + 1) if s <= me and
            (settings.mlt_path_length < 0 or s == settings.mlt_path_length)]


def trace_bdpt(scene, settings, pixel, sample_idx, seed, max_vertices=8,
               max_edges=None, tape=None):
    """One BDPT sample per entry; pixel/sample_idx (R,) int32, seed a
    uint32 word.  Returns (radiance (R,3) of the pixel's own estimator,
    splat pixels (R*NS,) int32, splat values (R*NS,3), rays as a 0-d
    int64 tensor).  max_edges caps the path's segments (the path
    tracer's max_bounces); strategies with s + t - 1 > max_edges are
    skipped, and each connection applies the per-ray budget in original
    vertex indices (ref bdptConnect's `bounce >= maxBounce`).  `tape` (an
    rng.Tape) drives every draw (the MLT integrators' bidirectional
    tape)."""
    from tungsten_tpu_torch.cameras.camera import generate_rays_w
    smp = rng.sampler(settings, tape)
    R = pixel.shape[0]
    dev = pixel.device
    NV = max_vertices
    ME = max_edges if max_edges is not None else 2 * NV
    mlt_len = settings.mlt_path_length
    media = _Media(scene, settings) if settings.has_media else None

    # ---- camera subpath ----
    o, d, cam_w = generate_rays_w(scene, settings, pixel, sample_idx, seed,
                                  tape=tape)
    cam_med0 = scene.cam_medium.to(torch.int32).expand(R).contiguous() \
        if settings.has_media else None
    cam = _trace_subpath(scene, settings, media, o, d,
                         cam_w[..., None].expand(R, 3) * 1.0, False,
                         seed, pixel, sample_idx, rng.DIMS_CAMERA, NV,
                         _camera_dir_pdf(scene, settings, d),
                         scene.cam_mat[:3, 2].expand(R, 3), med0=cam_med0,
                         escapes=settings.has_env, smp=smp)
    # ---- light subpath ----
    root, lig = _light_subpath(scene, settings, media, seed, pixel,
                               sample_idx, NV, smp=smp)

    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    if settings.has_env:
        env_ok = cam["esc_valid"] & (cam["esc_edges"] <= ME) & \
            (cam["esc_edges"] >= settings.min_bounces)
        if mlt_len >= 0:
            env_ok = env_ok & (cam["esc_edges"] == mlt_len)
        radiance = radiance + torch.where(
            env_ok[..., None],
            cam["esc_alpha"] * L.env_eval(scene, cam["esc_d"], active=env_ok),
            0.0)

    # ================= s = 0: the camera path hits a light ==============
    nl = settings.num_lights
    dirac = settings.filter == "dirac"
    for t in range(1, NV + 1):
        if t - 1 > ME or (mlt_len >= 0 and t - 1 != mlt_len):
            continue
        ci = t - 1  # the camera walk slot of the path's end
        v_ok = cam["valid"][:, ci]
        if settings.has_media:
            v_ok = v_ok & ~cam["is_med"][:, ci] & (cam["orig"][:, ci] <= ME)
        prim = torch.clamp(cam["prim"][:, ci], 0,
                           scene.prim_emission_tex.shape[0] - 1).long()
        emissive = v_ok & (scene.prim_emission_tex[prim] >= 0)
        li = torch.clamp(scene.prim_light[prim], 0,
                         scene.light_emission.shape[0] - 1).long()
        front = torch.sum(cam["ng"][:, ci] * cam["wi"][:, ci], dim=-1) > 0.0
        contrib = cam["alpha"][:, ci] * scene.light_emission[li]
        pdfA = (1.0 / nl) / torch.clamp(scene.light_area[li], min=1e-20)
        if t == 1:
            # a direct hit from the camera: the (1,1) lens splat samples
            # the same one-edge paths, so balance against its density
            # unless the reconstruction filter is Dirac
            if dirac:
                w = None
            else:
                w = 1.0 / (1.0 + pdfA / torch.clamp(cam["pdf_fwd"][:, 0],
                                                    min=1e-20))
        else:
            # combined path = the camera path reversed, n = t: light area
            # pdf, the emission pdf toward camera vertex t-2 (x the edge's
            # backward medium pdf, ref bdptWeightedPathEmission), then the
            # camera pdf_rev; pdf_rev = the camera pdf_fwd reversed
            cos_here = torch.abs(torch.sum(cam["ng"][:, ci] * cam["wi"][:, ci],
                                           dim=-1))
            pdf_em_area = _area_pdf_m(cos_here * vm.INV_PI,
                                      cam["edge_pb"][:, ci],
                                      -cam["wi"][:, ci],
                                      cam["dist_prev"][:, ci],
                                      cam["ng"][:, ci - 1],
                                      _is_med(settings, cam, ci - 1))
            yes = torch.ones_like(emissive)
            pdf_fwd = [pdfA, pdf_em_area]
            pdf_rev = [cam["pdf_fwd"][:, ci], cam["pdf_fwd"][:, ci - 1]]
            conn = [yes, ~cam["spec"][:, ci - 1] if ci >= 1 else yes]
            for j in range(2, t):
                cj = t - 1 - j  # camera walk slot
                pdf_fwd.append(cam["pdf_rev"][:, cj])
                pdf_rev.append(cam["pdf_fwd"][:, cj])
                conn.append(~cam["spec"][:, cj] if cj >= 1 else yes)
            w = _mis_weight_s0(pdf_fwd, pdf_rev, conn, t, not dirac)
        val = contrib if w is None else contrib * w[..., None]
        radiance = radiance + torch.where((emissive & front)[..., None], val,
                                          0.0)

    # ray accounting: the walks count live intersect queries, every
    # attempted connection one shadow segment
    rays = cam["rays"] + lig["rays"]

    # ================= s >= 1, t >= 2: connections ======================
    for s in range(1, NV + 1):
        for t in range(2, NV + 1):
            if s + t - 1 > ME or (mlt_len >= 0 and s + t - 1 != mlt_len):
                continue
            pair = cam["valid"][:, t - 1] & lig["valid"][:, s - 1]
            rays = rays + torch.sum(pair.to(torch.int64))
            contrib, w, ok = _connect(scene, settings, media, cam, lig, root,
                                      s, t, R)
            radiance = radiance + torch.where(ok[..., None],
                                              contrib * w[..., None], 0.0)

    # ================= t = 1: light path to the lens (splat) ============
    spix, sval, lens_rays = _lens_strategies(
        _lens_s(settings, NV, ME), scene, settings, media, lig, root, seed,
        pixel, sample_idx, mis=True, smp=smp)
    return radiance, spix, sval, rays + lens_rays


def trace_light(scene, settings, pixel, sample_idx, seed, max_vertices=8,
                max_edges=None):
    """Adjoint particle (light) tracer: one emitter subpath per entry,
    every vertex connected to the lens and splatted (ref light_tracer,
    LightTracer.cpp:12-88, LightTraceIntegrator.cpp:82-95): BDPT's t=1
    family at MIS weight 1.  Returns (splat pixels (R*S,), splat values
    (R*S,3), rays as a 0-d int64 tensor)."""
    NV = max_vertices
    ME = max_edges if max_edges is not None else 2 * NV
    media = _Media(scene, settings) if settings.has_media else None
    root, lig = _light_subpath(scene, settings, media, seed, pixel,
                               sample_idx, NV)
    spix, sval, rays = _lens_strategies(
        _lens_s(settings, NV, ME), scene, settings, media, lig, root, seed,
        pixel, sample_idx, mis=False)
    return spix, sval, lig["rays"] + rays
