"""Top-level render loop (port of tungsten_tpu/render.py for every
integrator of the JAX package: path_tracer, bidirectional_path_tracer,
light_tracer, photon_map, progressive_photon_map and the MLT family
kelemen_mlt, multiplexed_mlt and reversible_jump_mlt): spp batches over
the width-staged wavefront or the splatting BDPT / light-tracer waves,
the photon maps' spp rounds, the MLT chains' batches, accumulation into a
framebuffer, Mrays/s stats; adaptive sampling; the output buffers (AOVs,
variance, parity halves).

A small frame batches several spp into one wide wavefront (up to
WAVE_RAYS = 4 * WAVEFRONT_CHUNK rays): 256x256 at 16 spp is one wave of
1,048,576 rays, narrowed by the staged schedule
(path_tracer.staged_schedule).  The adaptive and output-buffer renders
batch their samples the same way, where the JAX package traces one wave
per spp: rays are independent, so
only the order of the sums changes (and index_add_ on CUDA sums with
atomics in a varying order anyway).  They take the same staged schedule
too, banking each sample by its lane instead of its pixel.  The
splatting integrators batch their samples into waves of up to WAVE_RAYS
lanes the same way, where the JAX package traces one chunk per spp.  A photon-map render traces
the photon paths of several rounds in one wave, where the JAX package
traces chunks of PHOTON_CHUNK paths a round: the paths keep their ids
and each its round's seed, so each round's photons keep the chunks'
path-major order; and it walks the camera lanes of those rounds in one
wave, each round gathering against its own grids after.
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from tungsten_tpu_torch.device import resolve_device
from tungsten_tpu_torch.integrators.path_tracer import (staged_schedule,
                                                        trace_wave,
                                                        trace_wave_aovs,
                                                        trace_wave_staged)

WAVEFRONT_CHUNK = 262144
WAVE_RAYS = 4 * WAVEFRONT_CHUNK
ADAPTIVE_THRESHOLD = 16
VARIANCE_TILE = 4
LUMA = (0.2126, 0.7152, 0.0722)


def _trace_chunk_staged(scene, settings, pixel, sample_idx, seed, n_total):
    """One pixel chunk, one spp batch: the full width-staged bounce
    schedule.  Returns ((n_total, 3) radiance sum, rays)."""
    fb, rays = trace_wave_staged(scene, settings, pixel, sample_idx, seed,
                                 n_total, **staged_schedule(scene.device))
    return fb, int(rays)


SPLATTING = ("bidirectional_path_tracer", "light_tracer")


def _trace_chunk_splat(scene, settings, pixel, sample_idx, seed, n_total):
    """One wave of a splatting integrator (bidirectional_path_tracer,
    light_tracer): each lane's own radiance banked by its pixel, plus
    every lens connection's splat, scatter-added into the frame (the
    reference's AtomicFramebuffer, AtomicFramebuffer.hpp:26-89).
    Non-finite values are dropped, and padded lanes (pixel >= n_total)
    bank and splat nothing.  Returns ((n_total, 3) sum, rays)."""
    from tungsten_tpu_torch.integrators.bdpt import trace_bdpt, trace_light
    kw = dict(max_vertices=settings.bdpt_vertices,
              max_edges=settings.max_bounces)
    keep = pixel < n_total
    pix = torch.clamp(pixel, 0, n_total - 1).long()
    fb = torch.zeros((n_total, 3), dtype=torch.float32, device=pixel.device)
    if settings.integrator_type == "light_tracer":
        spix, sval, rays = trace_light(scene, settings, pixel, sample_idx,
                                       seed, **kw)
    else:
        rad, spix, sval, rays = trace_bdpt(scene, settings, pixel,
                                           sample_idx, seed, **kw)
        rad = torch.where(torch.isfinite(rad), rad, 0.0)
        fb.index_add_(0, pix, torch.where(keep[..., None], rad, 0.0))
    if spix.shape[0] > 0:
        sval = torch.where(torch.isfinite(sval), sval, 0.0)
        valid = keep.repeat(spix.shape[0] // pixel.shape[0])
        sval = torch.where(valid[..., None], sval, 0.0)
        fb.index_add_(0, torch.clamp(spix, 0, n_total - 1).long(), sval)
    return fb, int(rays)


# the photon paths of a round are at least this many (the JAX package's
# photon chunk); the rounds one photon wave traces together keep their
# packed slots within PHOTON_WAVE_BYTES
PHOTON_CHUNK = 1 << 16
PHOTON_WAVE_BYTES = 4 << 30
PHOTON_MAPS = ("photon_map", "progressive_photon_map")


def _photon_grids(PM, settings, photons, n_paths, it, use_beams,
                  use_planes):
    """One round's grids: (surface grid, its radius as f32, the volume
    grid (points), or the beam grid, or (beam grid, plane grid), or None,
    the volume radius as f32 or None), at PPM's radii for iteration
    `it`."""
    photons = dict(photons, power=photons["power"] / n_paths)
    gamma = PM.ppm_gamma(it, settings.ppm_alpha) \
        if settings.integrator_type == "progressive_photon_map" else 1.0
    radius = settings.gather_radius * float(np.sqrt(gamma))
    grid = PM.build_photon_grid(
        dict(photons, valid=photons["valid"] & ~photons["vol"]), radius)
    vgrid = vradius = None
    if settings.has_media:
        # the volume map, at the volume gather radius: the beam or plane
        # grids over the first vol_photon_count paths' slots, or the
        # points grid over every volume photon
        vradius = settings.vol_gather_radius * float(np.sqrt(gamma))
        if use_beams or use_planes:
            B = max(settings.max_bounces - 1, 1)
            n_vb = min(settings.vol_photon_count, n_paths)
            sub = {k: v[:n_vb * B] for k, v in photons.items()}
            sub["b_pow"] = sub["b_pow"] / n_vb
            if use_beams:
                vgrid = PM.build_beam_grid(sub, vradius)
            else:
                # planes for the volume-to-volume segments and beams for
                # the segments rooted on the light or a surface
                sub["pl_pow"] = sub["pl_pow"] / n_vb
                vgrid = (PM.build_beam_grid(sub, vradius),
                         PM.build_plane_grid(sub, vradius))
        else:
            vgrid = PM.build_photon_grid(
                dict(photons, valid=photons["valid"] & photons["vol"]),
                vradius)
        vradius = float(np.float32(vradius))
    return grid, float(np.float32(radius)), vgrid, vradius


def _render_pass_photon(scene, settings, sample_start, seed,
                        spp_chunk: int):
    """Photon-map / PPM spp rounds (ref PhotonMapIntegrator::renderSegment
    and ProgressivePhotonMapIntegrator's per-iteration radius shrink):
    each round traces a fresh photon map (seed offset by the iteration),
    builds its grids and gathers every pixel against them.  The rounds'
    photon paths are traced in waves of several rounds, and their camera
    walks a pixel chunk in one wave; each round then gathers its lanes.
    Returns ((H, W, 3) sum, rays)."""
    from tungsten_tpu_torch.integrators import photon_map as PM
    from tungsten_tpu_torch.media.grid import MED_HOMOGENEOUS
    dev = scene.device
    w, h = settings.width, settings.height
    n = w * h
    C = min(WAVEFRONT_CHUNK, n)
    n_chunks = -(-n // C)
    if settings.vol_photon_type in ("beams", "planes") and \
            settings.has_media and \
            any(k != MED_HOMOGENEOUS for k in settings.med_kinds):
        # the beams' and planes' analytic transmittance covers
        # homogeneous media: heterogeneous scenes take the points
        # estimator (the JAX package's choice)
        settings = replace(settings, vol_photon_type="points")
    use_beams = settings.has_media and settings.vol_photon_type == "beams"
    use_planes = settings.has_media and settings.vol_photon_type == "planes"

    acc = torch.zeros((n_chunks * C, 3), dtype=torch.float32, device=dev)
    rays = 0
    B = max(settings.max_bounces - 1, 1)
    n_paths = max(settings.photon_count // B, PHOTON_CHUNK)
    per_wave = max(1, PHOTON_WAVE_BYTES // (n_paths * B *
                                            PM.slot_bytes(settings)))
    its = list(range(int(sample_start), int(sample_start) + spp_chunk))
    for b0 in range(0, len(its), per_wave):
        batch = its[b0:b0 + per_wave]
        # ---- photon pass (fresh photons each round) ----
        photons = PM.trace_photons(
            scene, settings, n_paths,
            [(int(seed) + 0x9E3779B9 * it) & 0xFFFFFFFF for it in batch])
        rays += int(photons.pop("rays"))
        nb = n_paths * B
        grids = [_photon_grids(PM, settings,
                               {k: v[r * nb:(r + 1) * nb]
                                for k, v in photons.items()},
                               n_paths, it, use_beams, use_planes)
                 for r, it in enumerate(batch)]
        del photons

        # ---- camera passes: one walk of the batch's rounds a chunk ----
        for ci in range(n_chunks):
            pix = torch.arange(ci * C, (ci + 1) * C, dtype=torch.int32,
                               device=dev).repeat(len(batch))
            smp = torch.tensor(batch, dtype=torch.int32,
                               device=dev).repeat_interleave(C)
            walk = PM.camera_walk(scene, settings, pix, smp, seed)
            rays += int(walk["rays"])
            for r, (grid, radius, vgrid, vradius) in enumerate(grids):
                lanes = slice(r * C, (r + 1) * C)
                p, sm = pix[lanes], smp[lanes]
                rad = PM.gather_walk(
                    scene, settings, walk, lanes, grid, radius, seed,
                    vgrid=None if use_beams or use_planes else vgrid,
                    vradius=vradius, pixel=p, sample_idx=sm)
                if use_beams:
                    rad = rad + PM.beam_pass(scene, settings, vgrid, vradius,
                                             p, sm, seed)
                elif use_planes:
                    rad = rad + PM.beam_pass(scene, settings, vgrid[0],
                                             vradius, p, sm, seed)
                    rad = rad + PM.plane_pass(scene, settings, vgrid[1], p,
                                              sm, seed)
                if use_beams or use_planes:
                    rays += C  # the beam / plane pass re-traces primaries
                rad = torch.where(torch.isfinite(rad), rad, 0.0)
                acc[ci * C:(ci + 1) * C] += rad
    return acc[:n].reshape(h, w, 3), rays


def render_pass(scene, settings, sample_start, seed, spp_chunk: int = 1):
    """Render spp_chunk samples per pixel; returns ((H, W, 3) sum, rays)."""
    from tungsten_tpu_torch.scene.flatten import PORTED_INTEGRATORS
    if settings.integrator_type not in PORTED_INTEGRATORS:
        raise NotImplementedError(
            f"tungsten_tpu_torch: integrator {settings.integrator_type!r} is "
            f"not ported yet")
    if settings.integrator_type in PHOTON_MAPS:
        return _render_pass_photon(scene, settings, sample_start, seed,
                                   spp_chunk)
    if "mlt" in settings.integrator_type:
        # the chains and their helper draws run on the uniform sampler
        # (the JAX package latches `stratified_sampler and "mlt" not in
        # integrator_type`)
        from tungsten_tpu_torch.integrators import mlt
        settings = replace(settings, stratified_sampler=False)
        fn = mlt.render_pass_mmlt \
            if settings.integrator_type == "multiplexed_mlt" \
            else mlt.render_pass_mlt
        return fn(scene, settings, sample_start, seed, spp_chunk)
    trace = _trace_chunk_splat if settings.integrator_type in SPLATTING \
        else _trace_chunk_staged
    dev = scene.device
    w, h = settings.width, settings.height
    n = w * h
    C = min(WAVEFRONT_CHUNK, n)
    n_chunks = -(-n // C)
    fb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = 0
    spp_batch = max(1, min(WAVE_RAYS // max(C, 1), spp_chunk))
    i = 0
    while i < spp_chunk:
        k = min(spp_batch, spp_chunk - i)
        for ci in range(n_chunks):
            pix = torch.arange(ci * C, (ci + 1) * C, dtype=torch.int32,
                               device=dev).repeat(k)
            smp = torch.arange(int(sample_start) + i,
                               int(sample_start) + i + k, dtype=torch.int32,
                               device=dev).repeat_interleave(C)
            part, r = trace(scene, settings, pix, smp, seed, n)
            fb = fb + part
            rays += r
        i += k
    return fb.reshape(h, w, 3), rays


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _waves(n: int, s0: int, s1: int, dev):
    """(pixel, sample) int32 id batches of at most WAVE_RAYS rays covering
    every pixel of samples s0..s1-1, sample-major."""
    total = n * (s1 - s0)
    for off in range(0, total, WAVE_RAYS):
        idx = torch.arange(off, min(off + WAVE_RAYS, total), device=dev)
        yield (idx % n).to(torch.int32), (s0 + idx // n).to(torch.int32)


# --------------------------- adaptive sampling -------------------------
# ref PathTraceIntegrator.cpp:44-134: per-4x4-tile Welford error
# estimates, 95th-percentile clamp, one-texel weight dilation, and
# stochastic per-tile budget allocation after 16 uniform spp.

def _trace_adaptive_chunk(scene, settings, pixel, sample_idx, seed,
                          n_total: int, vt_w: int, n_tiles: int):
    """Trace a wavefront with per-ray sample indices; returns the
    radiance framebuffer part + per-variance-tile (sum, sumsq, count)
    luminance statistics and the rays traced."""
    rad, nrays = trace_wave(scene, settings, pixel, sample_idx, seed,
                            with_stats=True,
                            **staged_schedule(scene.device))
    rad = torch.where(torch.isfinite(rad), rad, 0.0)
    ok = pixel < n_total
    rad = torch.where(ok[..., None], rad, 0.0)
    pix = torch.clamp(pixel.long(), 0, n_total - 1)
    dev = rad.device
    fb = torch.zeros((n_total, 3), dtype=torch.float32,
                     device=dev).index_add_(0, pix, rad)
    lum = rad @ torch.tensor(LUMA, dtype=torch.float32, device=dev)
    px = pix % settings.width
    py = pix // settings.width
    tile = torch.clamp(px // VARIANCE_TILE + (py // VARIANCE_TILE) * vt_w,
                       0, n_tiles - 1)

    def per_tile(v):   # float64, as the JAX package's host sums
        return torch.zeros((n_tiles,), dtype=torch.float64,
                           device=dev).index_add_(0, tile, v.double())
    return (fb, per_tile(lum), per_tile(lum * lum),
            per_tile(ok.to(torch.float32)), nrays)


def adaptive_state_buffers(state: dict) -> dict:
    """The adaptive-sampling state as named checkpoint buffers (ref
    PathTraceIntegrator serializes its SampleRecords + tile samplers,
    PathTraceIntegrator.cpp:158-172; here the tile statistics + sample
    cursors ARE that state — the RNG is counter-based)."""
    return {f"adaptive_{k}": v for k, v in state.items()
            if k != "done"} | {"adaptive_done":
                               np.asarray([state["done"]], np.int64)}


def adaptive_state_from_buffers(buffers: dict) -> dict | None:
    keys = ("fb", "px_count", "t_sum", "t_sumsq", "t_cnt",
            "tile_next_index")
    if not all(f"adaptive_{k}" in buffers for k in keys) or \
            "adaptive_done" not in buffers:
        return None
    st = {k: buffers[f"adaptive_{k}"].copy() for k in keys}
    st["done"] = int(buffers["adaptive_done"][0])
    return st


def render_adaptive(scene, settings, spp: int, seed: int,
                    verbose: bool = False, state: dict = None,
                    round_cb=None):
    """Adaptive path tracing: uniform warmup then per-tile budget
    redistribution each spp_step round.  Returns (hdr, rays, seconds,
    state); pass a previous `state` to resume, and `round_cb(state)`
    fires after every round (checkpointing hook).  The budget draws stay
    on the host with the JAX package's generator and seed, so the
    per-tile sample allocation is the JAX package's, tile for tile."""
    t_start = time.time()
    dev = scene.device
    w, h = settings.width, settings.height
    n = w * h
    vt_w = -(-w // VARIANCE_TILE)
    vt_h = -(-h // VARIANCE_TILE)
    nt = vt_w * vt_h

    if state is not None:
        fb = state["fb"].reshape(n, 3).astype(np.float32)
        px_count = state["px_count"].astype(np.float64)
        t_sum = state["t_sum"].copy()
        t_sumsq = state["t_sumsq"].copy()
        t_cnt = state["t_cnt"].copy()
        tile_next_index = state["tile_next_index"].astype(np.int64)
        resume_done = int(state["done"])
    else:
        fb = np.zeros((n, 3), np.float32)
        px_count = np.zeros(n, np.float64)
        t_sum = np.zeros(nt)
        t_sumsq = np.zeros(nt)
        t_cnt = np.zeros(nt)
        tile_next_index = np.zeros(nt, np.int64)  # per-tile cursor
        resume_done = 0

    pix_all = np.arange(n, dtype=np.uint32)
    px_of_tile = None  # lazy: pixel ids grouped by variance tile
    rays = 0

    def snapshot(done):
        return dict(fb=fb, px_count=px_count, t_sum=t_sum,
                    t_sumsq=t_sumsq, t_cnt=t_cnt,
                    tile_next_index=tile_next_index, done=done)

    def run_wave(pixels, samples):
        nonlocal fb, t_sum, t_sumsq, t_cnt, rays
        for off in range(0, len(pixels), WAVE_RAYS):
            p = torch.from_numpy(
                pixels[off:off + WAVE_RAYS].astype(np.int32)).to(dev)
            s = torch.from_numpy(
                samples[off:off + WAVE_RAYS].astype(np.int32)).to(dev)
            part, ts, tq, tc, nrays = _trace_adaptive_chunk(
                scene, settings, p, s, seed, n, vt_w, nt)
            fb += part.cpu().numpy()
            t_sum += ts.cpu().numpy()
            t_sumsq += tq.cpu().numpy()
            t_cnt += tc.cpu().numpy()
            rays += int(nrays)

    # ---- uniform warmup (every warm spp in batched waves) ----
    warm = min(ADAPTIVE_THRESHOLD, spp)
    if resume_done < warm:
        k = warm - resume_done
        run_wave(np.tile(pix_all, k),
                 np.repeat(np.arange(resume_done, warm, dtype=np.uint32), n))
        px_count += k
        tile_next_index += k
        done = warm
    else:
        done = resume_done
    if round_cb is not None:
        round_cb(snapshot(done))

    # ---- adaptive rounds ----
    # NOTE: the round RNG restarts its sequence on resume; per-tile
    # budget draws after a resume differ from the uninterrupted run
    # (sample indices stay collision-free via tile_next_index, so the
    # estimate remains unbiased — only the budget shuffle differs)
    rng_host = np.random.default_rng(seed ^ 0xADA7 ^ done)
    while done < spp:
        step = min(settings.spp_step, spp - done)
        cnt = np.maximum(t_cnt, 2.0)
        mean = t_sum / cnt
        var = np.maximum(t_sumsq - t_sum * mean, 0.0) / (cnt - 1.0)
        err = var / (cnt * np.maximum(mean * mean, 1e-3))
        pos = err[err > 0.0]
        if pos.size == 0:
            break
        max_err = np.sort(pos)[(pos.size * 95) // 100]
        wgt = np.minimum(err, max_err).reshape(vt_h, vt_w)
        # one-texel max dilation (dilateAdaptiveWeights)
        wgt = np.maximum(wgt, np.roll(wgt, -1, 0))
        wgt = np.maximum(wgt, np.roll(wgt, -1, 1))
        wgt = np.maximum(wgt, np.roll(wgt, 1, 0))
        wgt = np.maximum(wgt, np.roll(wgt, 1, 1))
        wgt = wgt.reshape(-1)
        budget = (step - 1) * n // (VARIANCE_TILE * VARIANCE_TILE)
        factor = budget / max(wgt.sum(), 1e-30)
        frac = wgt * factor
        extra = np.floor(frac).astype(np.int64)
        # stochastic rounding of the fractional remainders
        extra += (rng_host.random(nt) < (frac - extra)).astype(np.int64)
        counts = extra + 1  # every tile gets >= 1 sample

        if px_of_tile is None:
            px = pix_all % w
            py = pix_all // w
            tid = px // VARIANCE_TILE + (py // VARIANCE_TILE) * vt_w
            order = np.argsort(tid, kind="stable")
            px_of_tile = (pix_all[order],
                          np.searchsorted(tid[order], np.arange(nt + 1)))
        sorted_pix, starts = px_of_tile
        pixels_l, samples_l = [], []
        for k in range(nt):
            c = int(counts[k])
            tp = sorted_pix[starts[k]:starts[k + 1]]
            if c <= 0 or len(tp) == 0:
                continue
            reps = np.tile(tp, c)
            sidx = np.repeat(tile_next_index[k] + np.arange(c), len(tp))
            pixels_l.append(reps)
            samples_l.append(sidx.astype(np.uint32))
            px_count[tp] += c
        tile_next_index += counts
        run_wave(np.concatenate(pixels_l), np.concatenate(samples_l))
        done += step
        if round_cb is not None:
            round_cb(snapshot(done))
        if verbose:
            print(f"adaptive round done~{done}/{spp} "
                  f"(tile spp {counts.min()}..{counts.max()})")

    img = fb / np.maximum(px_count[:, None], 1.0)
    return (img.reshape(h, w, 3).astype(np.float32), rays,
            time.time() - t_start, snapshot(done))


def render(scene, settings, spp: int | None = None, seed: int | None = None,
           spp_chunk: int = 1, verbose: bool = False,
           return_stats: bool = False, device=None):
    """Render `spp` samples per pixel; returns linear HDR (H, W, 3) numpy.

    `device` (None = CUDA, raising when absent) must be the device the
    scene lives on.  With return_stats also returns {"rays", "time",
    "mrays_per_s"} — host wall time around work ending in a device sync.
    Above ADAPTIVE_THRESHOLD spp with adaptive_sampling on (the scene
    files' default), the render is render_adaptive's."""
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene lives on {scene.device}, render asked for "
                         f"{dev}")
    spp = spp if spp is not None else settings.spp
    seed = seed if seed is not None else settings.seed
    if settings.adaptive_sampling and \
            settings.integrator_type == "path_tracer" and \
            spp > ADAPTIVE_THRESHOLD:
        img, rays, secs, _ = render_adaptive(scene, settings, spp, seed,
                                             verbose=verbose)
        if return_stats:
            return img, {"rays": rays, "time": secs,
                         "mrays_per_s": rays / max(secs, 1e-9) / 1e6}
        return img
    acc = None
    done = 0
    total_rays = 0
    elapsed = 0.0
    while done < spp:
        chunk = min(spp_chunk, spp - done)
        t0 = time.time()
        out, rays = render_pass(scene, settings, done, seed, spp_chunk=chunk)
        _sync(dev)
        dt = time.time() - t0
        elapsed += dt
        total_rays += int(rays)
        acc = out if acc is None else acc + out
        done += chunk
        if verbose:
            print(f"spp {done}/{spp}  ({dt:.2f}s, "
                  f"{int(rays) / dt / 1e6:.1f} Mrays/s)")
    img = acc.cpu().numpy() / spp
    if return_stats:
        return img, {"rays": total_rays, "time": elapsed,
                     "mrays_per_s": total_rays / max(elapsed, 1e-9) / 1e6}
    return img


# ------------------------- output buffers (AOVs + variance) -----------
# ref OutputBuffer<T> (src/core/cameras/OutputBuffer.hpp:88-130): per-AOV
# sample counting, Welford sample_variance (saved as M2/(n*max(n-1,1))),
# two-buffer A/B split by sample parity.  AOVs are captured inside the
# path-trace bounce loop at the first non-specular vertex
# (integrators/path_tracer.py trace_wave_aovs).

def _trace_chunk_aov(scene, settings, pixel, sample_idx, seed,
                     n_total: int):
    """One wave with output-value tracking: per-pixel float64 sums of
    radiance, its square, its parity halves (by each lane's own sample
    index) and the sample count, and each AOV's sum, square sum and
    count; and the rays traced."""
    rad, aovs, rays = trace_wave_aovs(scene, settings, pixel, sample_idx,
                                      seed, with_stats=True,
                                      **staged_schedule(scene.device))
    rad = torch.where(torch.isfinite(rad), rad, 0.0)
    ok = pixel < n_total
    rad = torch.where(ok[..., None], rad, 0.0)
    pix = torch.clamp(pixel.long(), 0, n_total - 1)
    parity = ((sample_idx % 2) == 1)[..., None]
    dev = rad.device

    def acc(v):
        # float64 sums (the JAX package sums its one-spp waves in float64
        # on the host), so a batched wave and a resumed one agree
        shape = (n_total,) + tuple(v.shape[1:])
        return torch.zeros(shape, dtype=torch.float64,
                           device=dev).index_add_(0, pix, v.double())
    out = {
        "color_sum": acc(rad),
        "color_sumsq": acc(rad * rad),
        "color_a": acc(torch.where(parity, 0.0, rad)),
        "color_b": acc(torch.where(parity, rad, 0.0)),
        "color_n": acc(ok.to(torch.float32)),
    }
    for k, v in aovs.items():
        v = torch.where(ok[..., None], v, 0.0)
        val, cnt = v[..., :-1], v[..., -1]
        out[k + "_sum"] = acc(val)
        # count is 0/1 per sample so val*val == raw^2 * count
        out[k + "_sumsq"] = acc(val * val)
        out[k + "_n"] = acc(cnt)
    return out, rays


def _finalize_buffers(acc, spp, w, h):
    """Raw accumulators -> mean / A / B / variance-of-the-mean images."""
    def vom(s, sq, n):
        n = np.maximum(n, 1.0)[..., None]
        m2 = np.maximum(sq - s * s / n, 0.0)
        return m2 / (n * np.maximum(n - 1.0, 1.0))

    n_color = np.maximum(acc["color_n"], 1.0)[..., None]
    out = {
        "color": acc["color_sum"] / n_color,
        "color_a": acc["color_a"] / np.maximum((spp + 1) // 2, 1),
        "color_b": acc["color_b"] / np.maximum(spp // 2, 1),
        "color_variance": vom(acc["color_sum"], acc["color_sumsq"],
                              acc["color_n"]),
    }
    for k in ("depth", "normal", "albedo", "visibility"):
        n = np.maximum(acc[k + "_n"], 1.0)[..., None]
        out[k] = acc[k + "_sum"] / n
        out[k + "_variance"] = vom(acc[k + "_sum"], acc[k + "_sumsq"],
                                   acc[k + "_n"])
        out[k + "_n"] = acc[k + "_n"]

    def shape(img):
        if img.shape[-1] == 1:
            return img.reshape(h, w)
        return img.reshape(h, w, img.shape[-1])

    return {k: shape(np.asarray(v, np.float32)) if v.ndim == 2
            else np.asarray(v, np.float32).reshape(h, w)
            for k, v in out.items()}


def render_with_aovs(scene, settings, spp: int | None = None,
                     seed: int | None = None, acc: dict | None = None,
                     sample_start: int = 0, stats: dict | None = None):
    """Render with the full output-buffer set: color (+ A/B half
    buffers by sample parity + Welford variance) and depth/normal/
    albedo/visibility AOVs captured at the first non-specular vertex
    (+ per-AOV variance and sample counts).  Returns (buffers, raw_acc);
    raw_acc (float64 numpy, the JAX package's keys) round-trips through
    checkpoint save/load for resume.  A `stats` dict, when given,
    receives the rays traced under "rays"."""
    spp = spp if spp is not None else settings.spp
    seed = seed if seed is not None else settings.seed
    settings = replace(settings, track_aovs=True)
    w, h = settings.width, settings.height
    n = w * h
    rays = 0
    for pix, smp in _waves(n, sample_start, spp, scene.device):
        part, r = _trace_chunk_aov(scene, settings, pix, smp, seed, n)
        part = {k: v.cpu().numpy() for k, v in part.items()}
        acc = part if acc is None else {k: acc[k] + part[k] for k in acc}
        rays += int(r)
    if stats is not None:
        stats["rays"] = rays
    return _finalize_buffers(acc, spp, w, h), acc


def render_aovs(scene, settings, seed=0, spp: int = 4):
    """AOV means only (depth / normal / albedo / visibility), captured at
    the first non-specular vertex (ref PathTracer.cpp:78-96)."""
    bufs, _ = render_with_aovs(scene, settings, spp=spp, seed=seed)
    return {"depth": bufs["depth"], "normal": bufs["normal"],
            "albedo": bufs["albedo"], "visibility": bufs["visibility"]}


def render_denoise_buffers(scene, settings, spp: int | None = None,
                           seed: int | None = None):
    """Two-buffer outputs for the NFOR denoiser (ref OutputBuffer's
    two_buffer_variance: half buffers split by sample parity,
    Camera::colorBuffer A/B + feature AOVs, OutputBuffer.hpp:88-130).

    Returns dict(color_a, color_b, color_var, feat_a, feat_b, feat_var)
    with features = [albedo rgb, normal xyz, depth].
    """
    spp = spp if spp is not None else settings.spp
    seed = seed if seed is not None else settings.seed
    bufs, _ = render_with_aovs(scene, settings, spp=max(spp, 2), seed=seed)
    color_a, color_b = bufs["color_a"], bufs["color_b"]
    color_var = bufs["color_variance"]

    def feats(sd):
        aov = render_aovs(scene, settings, seed=sd)
        return np.concatenate([aov["albedo"], aov["normal"],
                               aov["depth"][..., None]], axis=-1)

    fa = feats(int(seed) + 2)
    fb = feats(int(seed) + 3)
    fv = (fb - fa) ** 2 * 0.25
    return dict(color_a=color_a, color_b=color_b, color_var=color_var,
                feat_a=fa, feat_b=fb, feat_var=fv)


def render_file(scene_path, output=None, spp=None, resolution=None,
                seed=None, verbose=False, device=None):
    """Load a Tungsten scene file, render, tonemap, save; returns HDR.
    `device` as render's (None = CUDA)."""
    from tungsten_tpu_torch.scene.flatten import load_flat_scene
    scene, settings = load_flat_scene(scene_path, device)
    if resolution is not None:
        settings = replace(settings, width=resolution[0], height=resolution[1])
    hdr = render(scene, settings, spp=spp, seed=seed, verbose=verbose,
                 device=device)
    if output:
        from tungsten_tpu_torch.cameras.camera import tonemap_image
        from tungsten_tpu_torch.io import image as im
        if im.is_hdr(output):
            im.save_hdr(output, hdr)
        else:
            im.save_ldr(output, tonemap_image(settings.tonemap, hdr))
    return hdr
