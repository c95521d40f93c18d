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

def _nee(scene, settings, ctx, seed, pixel, sample_idx, bounce_dim_base):
    """Next-event estimation toward one chosen light (one-sample MIS: the
    light strategy only; the continuation ray carries the bsdf strategy).
    The shadow segment runs through the any-hit traversal with its own
    ray sort.  Returns ((R,3) contribution excluding path throughput,
    number of shadow rays traced)."""
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
    return out, torch.sum(do_shadow.to(torch.int64))


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
        if els and settings.num_lights > 0:
            do_nee = shade & (bounce < settings.max_bounces - 1)
            ctx = dict(p=info["p"], sp=sp, frame=(tan, bit, ns),
                       wi_local=wi_local, gate=do_nee)
            nee, nee_rays = _nee(scene, settings, ctx, seed, pixel,
                                 sample_idx, dim_base)
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


def bank_emission(state, n_total):
    """Scatter every ray's accumulated radiance into an (n_total, 3)
    framebuffer by pixel id (rays with pixel >= n_total are dropped).
    index_add_ uses atomics on CUDA, so the summation order of rays that
    share a pixel varies from run to run there."""
    pix = torch.clamp(state["pixel"], 0, n_total - 1).long()
    em = state["emission"]
    em = torch.where(torch.isfinite(em), em, 0.0)
    em = torch.where((state["pixel"] < n_total)[..., None], em, 0.0)
    fb = torch.zeros((n_total, 3), dtype=torch.float32, device=em.device)
    return fb.index_add_(0, pix, em)


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
    zeroes the emission accumulator (bank_emission must be called
    first)."""
    order = torch.argsort(torch.where(state["alive"], 0, 1).to(torch.int32),
                          stable=True)
    out = _gather_rows(state, order[:new_r])
    out["emission"] = torch.zeros((new_r, 3), dtype=torch.float32,
                                  device=out["alive"].device)
    # compacted-away padding must not resurrect
    out["alive"] = out["alive"] & (
        torch.arange(new_r, device=out["alive"].device) <
        torch.sum(state["alive"]))
    return out


def trace_wave_staged(scene, settings, pixel, sample_idx, seed,
                      n_total: int, min_wave: int = 4096, step: int = 2):
    """The width-staged bounce schedule: run the bounce body at a fixed
    width until the survivors fit the next width (width // step), bank
    every ray's radiance into the framebuffer, compact, repeat down to
    min_wave, then run the tail to extinction.  Returns ((n_total, 3)
    framebuffer sum, rays traced as a 0-d int64 tensor)."""
    body = _make_bounce_body(scene, settings, seed)
    state = _init_state(scene, settings, pixel, sample_idx, seed)
    fb = torch.zeros((n_total, 3), dtype=torch.float32, device=pixel.device)
    w = pixel.shape[0]
    while w // step >= min_wave:
        nxt = w // step
        while state["bounce"] < settings.max_bounces and \
                int(torch.sum(state["alive"])) > nxt:
            state = body(state)
        fb = fb + bank_emission(state, n_total)
        state = compact_wave(state, nxt)
        w = nxt
    while state["bounce"] < settings.max_bounces and \
            bool(state["alive"].any()):
        state = body(state)
    fb = fb + bank_emission(state, n_total)
    return fb, state["rays"]
