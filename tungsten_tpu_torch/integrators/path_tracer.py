"""Wavefront path tracer (port of tungsten_tpu/integrators/
path_tracer.py: the surface-only bounce body, NEE, staged compaction).

SoA ray/path state over the whole wavefront; per bounce one closest-hit
traversal at the top of the body (camera ray at bounce 0, the previous
body's continuation after) and, with light sampling on, one any-hit
shadow traversal for the NEE light sample.  The estimator is the JAX
package's ONE-SAMPLE MIS (`_one_sample_mis` there): the continuation
bsdf sample doubles as the bsdf-side strategy, and emitter / env hits
are power-heuristic-weighted against the light-selection-aware NEE
density.  That branch is the one the JAX package takes for every scene
the port flattens (no media, no forward-lobe BSDFs, no cap lights, no
MMLT path-length restriction).  The surface BSDFs of that branch are
all ported (bsdf/eval.py); a scene with a forward-lobe or fiber BSDF
raises NotImplementedError.

Estimator guards mirror the reference: NEE at every shading vertex
while bounce < max_bounces - 1; direct emitter and env hits weighted
unless the previous vertex was specular (or light sampling is off);
Russian roulette after bounce 2 at max|throughput| < 0.1.

On CUDA the body first reorders the whole wavefront state by the
traversal sort key (one key sort + one packed row gather) so the
closest-hit launch skips its own sort, as the JAX package does when its
Pallas path is on; on the CPU lanes keep their order, as there.
"""
from __future__ import annotations

import torch

from tungsten_tpu_torch.bsdf import types as bt
from tungsten_tpu_torch.bsdf.eval import (FLAG_SPECULAR, FLAG_VALID,
                                          ShadePoint, bsdf_eval, bsdf_pdf,
                                          bsdf_sample)
from tungsten_tpu_torch.integrators import lights as L
from tungsten_tpu_torch.ops.intersect import bvh_intersect, ray_sort_key
from tungsten_tpu_torch.scene.flatten import LIGHT_INFINITE
from tungsten_tpu_torch.utils import rng
from tungsten_tpu_torch.utils import vecmath as vm

INF = 3.0e38
EPSILON = 5e-4  # ray-offset epsilon (ref TraceableScene.hpp DefaultEpsilon)
SHADOW_FUDGE = 1.0 - 1e-3


def _check_supported(settings):
    if settings.has_media:
        raise NotImplementedError(
            "tungsten_tpu_torch: participating media are not ported yet")
    unported = set(settings.present_bsdf_types) - set(bt.PORTED_TYPES)
    if unported:
        names = sorted(n for n, t in bt.NAME_TO_TYPE.items() if t in unported)
        raise NotImplementedError(
            f"tungsten_tpu_torch: bsdf types {names} (forward-lobe or "
            f"fiber) are not ported yet")
    if settings.num_caps or settings.has_points or settings.has_disk_lights \
            or settings.has_cyl_lights or settings.has_sphere_lights:
        raise NotImplementedError(
            "tungsten_tpu_torch: cap, point and analytic lights are not "
            "ported yet")


def _one_sample_mis(settings) -> bool:
    """The JAX package's one-sample-MIS condition, for ported scenes."""
    return bool(settings.enable_light_sampling) and settings.num_lights > 0


def _light_select_pmf(scene, settings, p, li):
    """P(choose_light picks li | shading point p)."""
    nl = settings.num_lights
    if nl <= 1:
        return torch.ones(li.shape, dtype=torch.float32, device=li.device)
    w, total = L._choose_light_weights(scene, settings, p)
    wi = torch.gather(w, -1, torch.clamp(li, 0, nl - 1)[..., None].long())
    return wi[..., 0] / torch.clamp(total, min=1e-30)


# ----------------------------------------------------------------- NEE

def _nee(scene, settings, ctx, seed, pixel, sample_idx, bounce_dim_base,
         want_tr: bool = False):
    """Next-event estimation toward one chosen light (one-sample MIS: the
    light strategy only; the continuation ray carries the bsdf strategy).
    The shadow segment runs through the any-hit traversal with its own
    ray sort.  Returns ((R,3) contribution excluding path throughput,
    number of shadow rays traced, and with want_tr (tr (R,3), tr_valid
    (R,)): the shadow transmittance, valid only where the shadow ray was
    traced — the visibility AOV's input, ref PathTracer.cpp:92-93 — else
    None)."""
    p = ctx["p"]
    R = p.shape[0]
    sobol = settings.stratified_sampler
    t, b, n = ctx["frame"]
    sp = ctx["sp"]
    wi_local = ctx["wi_local"]
    gate = ctx["gate"]
    u_sel = rng.random_1d(seed, pixel, sample_idx,
                          bounce_dim_base + rng.BounceDims.LIGHT_SELECT, sobol)
    li, sel_weight = L.choose_light(scene, settings, p, u_sel)
    ltype = scene.light_type[li]

    u1, u2 = rng.random_2d(seed, pixel, sample_idx,
                           bounce_dim_base + rng.BounceDims.LIGHT_SAMPLE, sobol)
    if settings.has_area_lights:
        u_tri = rng.random_1d(seed, pixel, sample_idx,
                              bounce_dim_base + rng.BounceDims.LIGHT_TRI,
                              sobol)
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

    wo_local = vm.to_local(t, b, n, d)
    f = bsdf_eval(sp, wi_local, wo_local, settings.present_bsdf_types)
    pdf_counter = bsdf_pdf(sp, wi_local, wo_local,
                           settings.present_bsdf_types)
    do_shadow = valid & (torch.amax(f, dim=-1) > 0.0) & (pdf > 1e-20) & gate

    far_sh = torch.where(do_shadow,
                         torch.where(dist >= INF, INF, dist * SHADOW_FUDGE),
                         0.0)
    occ = bvh_intersect(scene, p + d * EPSILON, d, 0.0, far_sh,
                        any_hit=True)["hit"]
    tr = torch.where((do_shadow & ~occ)[..., None], 1.0, 0.0)
    pmf = 1.0 / sel_weight
    mis_l = L.power_heuristic(pdf * pmf, pdf_counter)
    out = f * tr * emis / torch.clamp(pdf, min=1e-20)[..., None] \
        * mis_l[..., None] * sel_weight[..., None]
    return (out, torch.sum(do_shadow.to(torch.int64)),
            (tr, do_shadow) if want_tr else None)


# ------------------------------------------------------------ hit expand

def _clip_idx(idx, n):
    return torch.clamp(idx, 0, max(n - 1, 0)).long()


def _hit_prim(scene, res):
    """Primitive id of a hit (-1 on miss), over the triangle and analytic
    winner channels."""
    if scene.tri_v0.shape[0] > 0:
        prim = torch.where(
            res["tri"] >= 0,
            scene.tri_prim[_clip_idx(res["tri"], scene.tri_v0.shape[0])], -1)
    else:
        prim = torch.full(res["t"].shape, -1, dtype=torch.int32,
                          device=res["t"].device)
    for ch, table in (("sph", scene.sph_prim), ("dsk", scene.dsk_prim),
                      ("cyl", scene.cyl_prim)):
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
        p = o + d * res["t"][..., None]
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
        ng = vm.where3(res["cyl"] >= 0,
                       torch.sum(rot * n_loc[..., None, :], dim=-1), ng)
    return ng


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
                      ("cyl", scene.cyl_prim)):
        if table.shape[0] > 0:
            prim = torch.where(res[ch] >= 0,
                               table[_clip_idx(res[ch], table.shape[0])], prim)
    prim = _clip_idx(prim, scene.prim_bsdf.shape[0])
    return uv, scene.prim_bsdf[prim], prim


def _expand_hit(scene, o, d, res):
    """IntersectionInfo expansion: position, normals, uv, prim, bsdf."""
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
    prim = torch.clamp(prim, 0, scene.prim_bsdf.shape[0] - 1).long()
    return dict(p=p, ng=ng, ns=ns, uv=uv, prim=prim,
                bsdf=scene.prim_bsdf[prim].long())


# --------------------------------------------------------------- the loop

def _init_state(scene, settings, pixel, sample_idx, seed):
    """Initial wavefront: camera rays, traced by the first bounce body.
    pixel/sample_idx (R,) int32.  `bounce` is a host int."""
    from tungsten_tpu_torch.cameras.camera import generate_rays_w
    R = pixel.shape[0]
    dev = pixel.device
    o, d, cam_w = generate_rays_w(scene, settings, pixel, sample_idx, seed)
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


def _make_bounce_body(scene, settings, seed):
    """The per-bounce wavefront step: state dict -> state dict."""
    _check_supported(settings)
    body_sort = scene.device.type == "cuda"
    one_sample = _one_sample_mis(settings)
    sobol = settings.stratified_sampler
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
        active = alive & res["hit"]
        escaped = alive & ~res["hit"]

        # ---- escaped rays: environment (ref handleInfiniteLights) ----
        if settings.has_env:
            env_ok = escaped & (bounce >= settings.min_bounces)
            guard = s["was_specular"] | (not els)
            env_val = L.env_eval(scene, s["d"], active=env_ok)
            env_guard = guard | (scene.env_light_index < 0)
            if one_sample:
                eli = torch.broadcast_to(scene.env_light_index,
                                         pixel.shape).to(torch.int32)
                epdf = L.env_pdf(scene, s["d"], active=env_ok) * \
                    _light_select_pmf(scene, settings, s["o"], eli)
                w_env = torch.where(env_guard, 1.0,
                                    L.power_heuristic(s["pdf_fwd"], epdf))
                emission = emission + torch.where(
                    env_ok[..., None], throughput * env_val * w_env[..., None],
                    0.0)
            else:
                emission = emission + torch.where(
                    (env_ok & env_guard)[..., None], throughput * env_val,
                    0.0)

        info = _expand_hit(scene, s["o"], s["d"], res)
        # two-sided shading: flip the shading frame toward the ray;
        # transmissive BSDFs handle both hemispheres themselves — never flip
        backside = torch.sum(info["ng"] * s["d"], dim=-1) > 0.0
        flip = backside if settings.two_sided_shading else \
            torch.zeros_like(backside)
        flip = flip & ~torch.isin(scene.bsdf_type[info["bsdf"]], transmissive)
        ns = torch.where(flip[..., None], -info["ns"], info["ns"])
        tan, bit = vm.ortho_frame(ns)
        wi_local = vm.to_local(tan, bit, ns, -s["d"])
        sp = ShadePoint(scene, info["bsdf"], info["uv"])
        shade = active

        # ---- continuation: bsdf sample ----
        ul = rng.random_1d(seed, pixel, sample_idx,
                           dim_base + rng.BounceDims.BSDF_LOBE, sobol)
        u1, u2 = rng.random_2d(seed, pixel, sample_idx,
                               dim_base + rng.BounceDims.BSDF_SAMPLE, sobol)
        ul2 = rng.random_1d(seed, pixel, sample_idx,
                            dim_base + rng.BounceDims.BSDF_LOBE2, sobol)
        wo, wt, pdf, flags = bsdf_sample(sp, wi_local, ul, u1, u2, types,
                                         u_lobe2=ul2)
        ok = ((flags & FLAG_VALID) != 0) & (torch.amax(wt, dim=-1) > 0)
        new_d = vm.to_global(tan, bit, ns, wo)
        new_o = info["p"]
        thr_next = torch.where((active & ok)[..., None], throughput * wt,
                               throughput)
        was_specular = torch.where(shade & ok, (flags & FLAG_SPECULAR) != 0,
                                   s["was_specular"])
        alive2 = active & ok

        # ---- russian roulette (ref PathTracer.cpp:111-117) ----
        r_pdf = torch.amax(torch.abs(thr_next), dim=-1)
        do_rr = alive2 & (bounce > 2) & (r_pdf < 0.1)
        u_rr = rng.random_1d(seed, pixel, sample_idx,
                             dim_base + rng.BounceDims.ROULETTE, sobol)
        survive = u_rr < r_pdf
        thr_next = torch.where(
            (do_rr & survive)[..., None],
            thr_next / torch.clamp(r_pdf, min=1e-20)[..., None], thr_next)
        alive2 = alive2 & (~do_rr | survive)
        alive2 = alive2 & (torch.amax(thr_next, dim=-1) > 0.0)

        o2 = vm.where3(alive2, new_o + new_d * EPSILON, s["o"])
        d2 = vm.where3(alive2, new_d, s["d"])

        # ---- NEE; the continuation ray is traced at the NEXT body's top
        nee_rays = 0
        tr_nee = None
        if els and settings.num_lights > 0:
            do_nee = shade & (bounce < settings.max_bounces - 1)
            ctx = dict(p=info["p"], sp=sp, frame=(tan, bit, ns),
                       wi_local=wi_local, gate=do_nee)
            nee, nee_rays, tr_nee = _nee(scene, settings, ctx, seed, pixel,
                                         sample_idx, dim_base,
                                         want_tr=settings.track_aovs)
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
        e_val = scene.light_emission[li.long()]
        e_tex = scene.tex_const[torch.clamp(
            etex, 0, scene.tex_const.shape[0] - 1).long()]
        e_hit = torch.where(samplable[..., None], e_val, e_tex)
        take_emit = shade & is_emissive & front & \
            (bounce >= settings.min_bounces)
        if one_sample:
            lpdf = L.area_light_direct_pdf(scene, li.long(), res["t"],
                                           s["d"], info["ng"]) * \
                _light_select_pmf(scene, settings, s["o"], li)
            w_emit = torch.where(guard, 1.0,
                                 L.power_heuristic(s["pdf_fwd"], lpdf))
            emission = emission + torch.where(
                take_emit[..., None], throughput * e_hit * w_emit[..., None],
                0.0)
        else:
            emission = emission + torch.where(
                (take_emit & guard)[..., None], throughput * e_hit, 0.0)

        out = dict(
            o=o2, d=d2, throughput=thr_next, emission=emission,
            was_specular=was_specular, alive=alive2, bounce=bounce + 1,
            rays=s["rays"] + rays_top + nee_rays,
            pixel=pixel, sample=sample_idx,
        )
        if one_sample:
            out["pdf_fwd"] = torch.where(shade & ok, pdf, s["pdf_fwd"])
        if "lane" in s:
            out["lane"] = s["lane"]

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
               min_wave: int = 4096, step: int = 2):
    """Trace one radiance sample per entry; pixel/sample_idx (R,) int32.
    Returns radiance (R,3), or (radiance, rays traced as a 0-d int64
    tensor) with stats.  The staged loop, banking by lane."""
    banks, rays = _staged(scene, settings, pixel, sample_idx, seed,
                          pixel.shape[0], min_wave, step, key="lane")
    if with_stats:
        return banks["emission"], rays
    return banks["emission"]


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


# per-ray sums that retire into banks: radiance and each AOV's (value,
# count); everything else in the state is carried
ACCUMULATORS = ("emission", "aov_depth", "aov_normal", "aov_albedo",
                "aov_vis")


def bank(state, n_total, key="pixel"):
    """Scatter every ray's accumulators into (n_total, C) buffers by
    state[key] (rays with key >= n_total are dropped).  By pixel (the
    framebuffer) non-finite radiance is dropped too; by lane it is kept,
    so each sample comes back as traced.  index_add_ uses atomics on
    CUDA, so the summation order of rays that share a pixel varies from
    run to run there."""
    idx = state[key]
    keep = (idx < n_total)[..., None]
    idx = torch.clamp(idx, 0, n_total - 1).long()
    out = {}
    for k in ACCUMULATORS:
        if k not in state:
            continue
        v = state[k]
        if k == "emission" and key == "pixel":
            v = torch.where(torch.isfinite(v), v, 0.0)
        v = torch.where(keep, v, 0.0)
        out[k] = torch.zeros((n_total, v.shape[1]), dtype=torch.float32,
                             device=v.device).index_add_(0, idx, v)
    return out


def _gather_rows(state, idx):
    """Apply a row permutation/slice `idx` to every leading-R state field
    with ONE packed row gather: the fields are packed into one (r, F)
    f32 matrix (ints and bools bitcast through int32) and moved
    together."""
    r = state["alive"].shape[0]
    new_r = idx.shape[0]
    cols, specs, out = [], [], {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == r:
            flat = v.reshape(r, -1)
            if flat.dtype == torch.float32:
                cols.append(flat)
            else:
                cols.append(flat.to(torch.int32).view(torch.float32))
            specs.append((k, v.shape[1:], v.dtype, flat.shape[1]))
        else:
            out[k] = v
    rows = torch.cat(cols, dim=1)[idx]                  # ONE gather
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


def _staged(scene, settings, pixel, sample_idx, seed, n_total: int,
            min_wave: int, step: int, key: str):
    """The width-staged bounce schedule: run the bounce body at a fixed
    width until the survivors fit the next width (width // step), bank
    every ray's accumulators by `key`, compact, repeat down to min_wave,
    then run the tail to extinction.  key "pixel" banks into the
    framebuffer; key "lane" banks by input entry (n_total = R), which
    undoes the body's sort and the compactions.  Returns ({accumulator:
    (n_total, C) sum}, rays traced as a 0-d int64 tensor)."""
    body = _make_bounce_body(scene, settings, seed)
    state = _init_state(scene, settings, pixel, sample_idx, seed)
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
