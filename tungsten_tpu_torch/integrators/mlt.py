"""Metropolis light transport (port of tungsten_tpu/integrators/mlt.py):
kelemen_mlt, multiplexed_mlt and reversible_jump_mlt, primary-sample-space
MCMC over the wavefront tracers with one chain a lane.

  * kelemen_mlt (ref src/core/integrators/kelemen_mlt/): the Kelemen
    exponential mutation (MetropolisSampler.hpp:43-66), large steps,
    luminance-scaled acceptance and bootstrap seeding
    (KelemenMltTracer.cpp:97-131).  As the reference's default
    ("bidirectional": true, KelemenMltSettings.hpp:19) the chains mutate a
    bidirectional tape evaluated by the BDPT integrator (camera-walk dims
    in the low columns, the light root's and walk's past them), accepting
    on the luminance of the whole splat vector; "bidirectional": false
    mutates the path tracer's tape.
  * multiplexed_mlt (ref multiplexed_mlt/): chains restricted to one path
    length k each (settings.mlt_path_length), with per-length
    normalizations b_k from a bootstrap pool and chain budgets
    proportional to b_k (MultiplexedMltIntegrator.cpp:88-125), on the
    bidirectional tape (the BDPT strategies with s + t - 1 = k) or on the
    path tracer's.
  * reversible_jump_mlt (ref reversible_jump_mlt/): on the path tracer's
    tape, a technique exchange at a chosen bounce b
    (ReversibleJumpMltTracer.cpp:128-196): the current path is re-traced
    while both techniques are inverted (path_tracer.trace_wave_rj), and
    the proposal writes the continuation sampler's coordinates that aim
    at the NEE light point and the NEE sampler's coordinates that hit
    the continuation ray's light point at once, which makes the map
    self-inverse on the swapped slots.  Chains where either inversion
    fails reject (proposal weight 0).

Estimator: for S = chains x steps mutations with bootstrap normalization
b (the mean luminance over uniform tapes), every step splats both states,
the current one with (1 - a) / lum and the proposal with a / lum, and
image = b * n_pixels / S * splats.

Port notes: the tape travels as an rng.Tape, never a module global, and
each lane reads its own chain's row (the path tracer carries the row
through its sort and compactions); the JAX package's lax.scan over steps
is a Python loop, its jit is dropped, and the splat is index_add_ on
clamped pixels.  The helper randomness (mutations, acceptance, strategy,
bounce pick) is pcg4d keyed on (seed ^ 0x9E3779B9, chain row, step, dim),
bit for bit the JAX package's.
"""
from __future__ import annotations

import math
from dataclasses import replace

import torch

from tungsten_tpu_torch.integrators.path_tracer import (staged_schedule,
                                                        trace_wave,
                                                        trace_wave_rj)
from tungsten_tpu_torch.utils import rng

LUM = (0.2126, 0.7152, 0.0722)

# Kelemen mutation constants (ref MetropolisSampler.hpp:45-47)
S1 = 1.0 / 1024.0
S2 = 1.0 / 64.0
FACTOR = -math.log(S2 / S1)

# the rj exchange's slots: the continuation sampler's and the NEE
# sampler's coordinates at the chosen bounce
CONT_SLOTS = (rng.BounceDims.BSDF_LOBE, rng.BounceDims.BSDF_SAMPLE,
              rng.BounceDims.BSDF_SAMPLE + 1, rng.BounceDims.BSDF_LOBE2)
NEE_SLOTS = (rng.BounceDims.LIGHT_SELECT, rng.BounceDims.LIGHT_SAMPLE,
             rng.BounceDims.LIGHT_SAMPLE + 1, rng.BounceDims.LIGHT_TRI)


# what the MLT passes did since zero_counts(): Metropolis steps, tape
# traces, the rays traced (the reversible-jump re-traces' too), accepted
# proposals, the reversible-jump re-traces, exchanges proposed and
# exchanges whose inversions held (the
# kernels' launch counters' pattern; render_pass_mlt / _mmlt add to it
# unless given a `stats` dict of their own)
COUNTS = dict(steps=0, traces=0, rays=0, accepted=0, rj_traces=0,
              rj_proposed=0, rj_valid=0)


def zero_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def read_counts() -> dict:
    return {k: int(v) for k, v in COUNTS.items()}


def tape_dims(settings) -> int:
    return rng.DIMS_CAMERA + settings.max_bounces * rng.DIMS_PER_BOUNCE


def tape_dims_bdpt(settings):
    """(camera-region columns, total columns) of a bidirectional tape:
    the camera walk takes [0, cam_cols), the light root and walk (dims
    from LIGHT_DIM_OFFSET on) [cam_cols, D)."""
    nv = settings.bdpt_vertices
    cam_cols = rng.DIMS_CAMERA + nv * rng.DIMS_PER_BOUNCE
    return cam_cols, cam_cols + 16 + nv * rng.DIMS_PER_BOUNCE


def _rows(batch: int, R: int, device):
    """The chains' uint32 row words of `batch`: arange(R) + batch * R."""
    return torch.arange(R, dtype=torch.int64, device=device) + \
        (int(batch) & 0xFFFFFFFF) * R


def _uniform_tape(seed, batch, step, R: int, D: int, device):
    """A fresh uniform tape addressed by (seed, batch, step)."""
    rows = _rows(batch, R, device)
    dims = torch.arange(D, dtype=torch.int64, device=device)
    return rng.random_1d(int(seed), rows[:, None], int(step), dims[None, :])


def _mutate(tape, u):
    """The Kelemen exponential small step on every coordinate (ref
    MetropolisSampler.hpp:43-66); u uniform, the tape's shape.  The
    exponential of the f32 argument is taken in f64 and rounded, so the
    CPU and the card agree bit for bit (their f32 exp differ in the last
    ulp, as XLA's does from both)."""
    negative = u < 0.5
    r = torch.where(negative, u * 2.0, (u - 0.5) * 2.0)
    delta = S2 * torch.exp((FACTOR * r).double()).float()
    v = torch.where(negative, tape - delta, tape + delta)
    v = torch.where(v < 0.0, v + 1.0, v)
    return torch.where(v >= 1.0, v - 1.0, v)


def _lum(rgb):
    return rgb @ torch.tensor(LUM, dtype=torch.float32, device=rgb.device)


def _finite(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _image_point(settings, tape):
    """Dims 0, 1 are the position in the whole image: the pixel (R,) int32
    and the tape with those dims replaced by their fractional parts (the
    box filter's jitter)."""
    w, h = settings.width, settings.height
    x = torch.clamp(tape[:, 0] * w, max=w - 1e-3)
    y = torch.clamp(tape[:, 1] * h, max=h - 1e-3)
    px = x.to(torch.int32)
    py = y.to(torch.int32)
    t2 = tape.clone()
    t2[:, 0] = x - px
    t2[:, 1] = y - py
    return py * w + px, t2


def _pt_settings(settings):
    return replace(settings, filter="box", integrator_type="path_tracer")


def trace_tape(scene, settings, tape, seed, stats=None):
    """The path integrand at PSS points `tape` (R, D): returns (radiance
    (R,3), pixel (R,) int32, luminance (R,)).  `stats` (a dict) adds the
    rays traced to stats["rays"]."""
    R = tape.shape[0]
    pixel, t2 = _image_point(settings, tape)
    zero = torch.zeros((R,), dtype=torch.int32, device=tape.device)
    rad, rays = trace_wave(scene, _pt_settings(settings), pixel, zero, seed,
                           with_stats=True, tape=rng.Tape(t2),
                           **staged_schedule(tape.device))
    _count(stats, rays)
    rad = _finite(rad)
    return rad, pixel, _lum(rad)


def trace_tape_rj(scene, settings, tape, b_pick, seed, stats=None):
    """Trace the current chain states while inverting both techniques at
    each chain's bounce b_pick (path_tracer.trace_wave_rj).  Returns
    (rj_dims (R,4), rj_valid (R,), rj_nee (R,4), rj_rev_valid (R,))."""
    R = tape.shape[0]
    pixel, t2 = _image_point(settings, tape)
    zero = torch.zeros((R,), dtype=torch.int32, device=tape.device)
    _, rj_dims, rj_valid, rj_nee, rj_rev_valid, rays = trace_wave_rj(
        scene, _pt_settings(settings), pixel, zero, seed, b_pick,
        tape=rng.Tape(t2), with_stats=True, **staged_schedule(tape.device))
    _add(stats, rj_traces=1, rays=rays)
    return rj_dims, rj_valid, rj_nee, rj_rev_valid


def trace_tape_bdpt(scene, settings, tape, seed, stats=None):
    """The BDPT measurement at PSS points `tape` (R, D), the bidirectional
    base sampler (ref KelemenMltTracer::traceSample's LightPath pair):
    camera-walk dims read columns [0, cam_cols), the light root's and
    walk's the columns past them.  Returns (radiance (R,3), pixel (R,),
    splat pixels (R,NS), splat values (R,NS,3), the luminance of the
    whole splat vector (R,), which drives acceptance as the reference's
    splats.totalLuminance())."""
    from tungsten_tpu_torch.integrators.bdpt import trace_bdpt
    R = tape.shape[0]
    dev = tape.device
    pixel, t2 = _image_point(settings, tape)
    cam_cols, _ = tape_dims_bdpt(settings)
    bset = replace(settings, filter="box",
                   integrator_type="bidirectional_path_tracer")
    rad, spix, sval, rays = trace_bdpt(
        scene, bset, pixel, torch.zeros((R,), dtype=torch.int32, device=dev),
        seed, max_vertices=settings.bdpt_vertices,
        max_edges=settings.max_bounces,
        tape=rng.Tape(t2, light_cols=cam_cols))
    _count(stats, rays)
    rad = _finite(rad)
    ns = spix.shape[0] // R
    if ns == 0:
        spix2 = torch.zeros((R, 0), dtype=torch.int32, device=dev)
        sval2 = torch.zeros((R, 0, 3), dtype=torch.float32, device=dev)
    else:
        spix2 = spix.reshape(ns, R).T
        sval2 = _finite(sval).reshape(ns, R, 3).transpose(0, 1)
    lum = _lum(rad) + torch.sum(_lum(sval2), dim=-1)
    return rad, pixel, spix2, sval2, lum


def _count(stats, rays):
    _add(stats, traces=1, rays=rays)


def _add(stats, **counts):
    """Add counts (ints or 0-d tensors, summed on their device) into the
    dict `stats`, if one is given."""
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + v


def _helper_draws(seed, rows, i: int, D: int, k: int):
    """The step's helper uniforms: k (R,) draws at dims 0..k-1 and the
    (R, D) mutation draws at dims 4..4+D-1."""
    hseed = (int(seed) & 0xFFFFFFFF) ^ 0x9E3779B9
    one = [rng.random_1d(hseed, rows, i, j) for j in range(k)]
    dims = torch.arange(4, 4 + D, dtype=torch.int64, device=rows.device)
    return one, rng.random_1d(hseed, rows[:, None], i, dims[None, :])


def _acceptance(lum, prop_lum, pw=None):
    """(a, the current state's splat weight, the proposal's)."""
    a = torch.clamp((prop_lum if pw is None else pw * prop_lum) /
                    torch.clamp(lum, min=1e-20), 0.0, 1.0)
    a = torch.where(lum <= 0.0, 1.0 if pw is None else pw, a)
    w_cur = torch.where(lum > 0, (1.0 - a) / torch.clamp(lum, min=1e-20), 0.0)
    w_prop = torch.where(prop_lum > 0, a / torch.clamp(prop_lum, min=1e-20),
                         0.0)
    return a, w_cur, w_prop


def _splat(fb, pixel, rad, wgt):
    n = fb.shape[0]
    fb.index_add_(0, torch.clamp(pixel, 0, n - 1).long(),
                  rad * wgt[..., None])


def _mlt_batch(scene, settings, seed, batch, R: int, n_steps: int,
               init_tape, init_rad, init_pixel, init_lum,
               strategy_prob: float = 0.0, stats=None):
    """n_steps Metropolis mutations of R chains on the path tracer's tape;
    returns (splat framebuffer (n_pixels, 3), tape, radiance, pixel,
    luminance of the final states).  With strategy_prob > 0 a small step
    is, with that probability, the reversible-jump technique exchange.
    `stats` (a dict) gathers steps, traces, rays, acceptances and the
    exchanges proposed and valid (0-d tensors)."""
    n = settings.width * settings.height
    D = init_tape.shape[1]
    dev = init_tape.device
    rows = _rows(batch, R, dev)
    mb = settings.max_bounces
    tape, rad, pixel, lum = init_tape, init_rad, init_pixel, init_lum
    fb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for i in range(n_steps):
        (u_large, u_acc, u_strat, u_bounce), u_mut = _helper_draws(
            seed, rows, i, D, 4)
        large = u_large < settings.mlt_large_step_prob
        small = _mutate(tape, u_mut)
        pw = None
        if strategy_prob > 0.0:
            strat = ~large & (u_strat < strategy_prob)
            b_pick = torch.clamp((u_bounce * mb).to(torch.int32), max=mb - 1)
            rj_dims, rj_valid, rj_nee, rj_rev_valid = trace_tape_rj(
                scene, settings, tape, b_pick, seed, stats)
            dim0 = (rng.DIMS_CAMERA + b_pick.long() * rng.DIMS_PER_BOUNCE)
            cols = dim0[:, None] + torch.tensor(CONT_SLOTS + NEE_SLOTS,
                                                device=dev)[None, :]
            swap = tape.scatter(1, cols, torch.cat([rj_dims, rj_nee], 1))
            ok_swap = rj_valid & rj_rev_valid
            small = torch.where(strat[:, None], swap, small)
            pw = torch.where(strat & ~ok_swap, 0.0, 1.0)
            _add(stats, rj_proposed=torch.sum(strat),
                 rj_valid=torch.sum(strat & ok_swap))
        prop_tape = torch.where(large[:, None], u_mut, small)
        prop_rad, prop_pixel, prop_lum = trace_tape(scene, settings,
                                                    prop_tape, seed, stats)
        a, w_cur, w_prop = _acceptance(lum, prop_lum, pw)
        # two-sided splat (Kelemen): both states contribute each step
        _splat(fb, pixel, rad, w_cur)
        _splat(fb, prop_pixel, prop_rad, w_prop)
        accept = u_acc < a
        _add(stats, steps=1, accepted=torch.sum(accept))
        tape = torch.where(accept[:, None], prop_tape, tape)
        rad = torch.where(accept[:, None], prop_rad, rad)
        pixel = torch.where(accept, prop_pixel, pixel)
        lum = torch.where(accept, prop_lum, lum)
    return fb, tape, rad, pixel, lum


def _mlt_batch_bdpt(scene, settings, seed, batch, R: int, n_steps: int,
                    init_tape, init_rad, init_pixel, init_spix, init_sval,
                    init_lum, stats=None, on_step=None):
    """Metropolis mutations over the bidirectional tape: each state's
    measurement is its own pixel's radiance plus NS lens splats, and both
    sides of every step splat their whole vector with the Kelemen
    weights.  Returns (framebuffer, tape, luminance); `stats` as
    _mlt_batch's, and on_step(i, prop_lum, accept) sees each step's
    proposals."""
    n = settings.width * settings.height
    D = init_tape.shape[1]
    dev = init_tape.device
    rows = _rows(batch, R, dev)
    tape, rad, pixel, spix, sval, lum = (init_tape, init_rad, init_pixel,
                                         init_spix, init_sval, init_lum)
    fb = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def splat_all(pixel, rad, spix, sval, wgt):
        _splat(fb, pixel, rad, wgt)
        if spix.shape[1]:
            _splat(fb, spix.reshape(-1), sval.reshape(-1, 3),
                   wgt[:, None].expand(spix.shape).reshape(-1))

    for i in range(n_steps):
        (u_large, u_acc), u_mut = _helper_draws(seed, rows, i, D, 2)
        large = u_large < settings.mlt_large_step_prob
        prop_tape = torch.where(large[:, None], u_mut, _mutate(tape, u_mut))
        (prop_rad, prop_pixel, prop_spix, prop_sval,
         prop_lum) = trace_tape_bdpt(scene, settings, prop_tape, seed, stats)
        a, w_cur, w_prop = _acceptance(lum, prop_lum)
        splat_all(pixel, rad, spix, sval, w_cur)
        splat_all(prop_pixel, prop_rad, prop_spix, prop_sval, w_prop)
        accept = u_acc < a
        if on_step is not None:
            on_step(i, prop_lum, accept)
        _add(stats, steps=1, accepted=torch.sum(accept))
        tape = torch.where(accept[:, None], prop_tape, tape)
        rad = torch.where(accept[:, None], prop_rad, rad)
        pixel = torch.where(accept, prop_pixel, pixel)
        spix = torch.where(accept[:, None], prop_spix, spix)
        sval = torch.where(accept[:, None, None], prop_sval, sval)
        lum = torch.where(accept, prop_lum, lum)
    return fb, tape, lum


def _bootstrap_batch(scene, settings, seed, batch, R: int, D: int,
                     stats=None):
    """A uniform tape batch and its path-tracer measurement: (tape,
    radiance, pixel, luminance)."""
    tape = _uniform_tape((int(seed) & 0xFFFFFFFF) ^ 0xB007, batch, 0, R, D,
                         scene.device)
    return (tape,) + trace_tape(scene, settings, tape, seed, stats)


def _bootstrap_batch_bdpt(scene, settings, seed, batch, R: int, D: int,
                          stats=None):
    """The same over the bidirectional tape: (tape, radiance, pixel,
    splat pixels, splat values, luminance)."""
    tape = _uniform_tape((int(seed) & 0xFFFFFFFF) ^ 0xB007, batch, 0, R, D,
                         scene.device)
    return (tape,) + trace_tape_bdpt(scene, settings, tape, seed, stats)


def _resample(lum, seed_word: int, batch: int, R: int):
    """R chain seeds drawn from a bootstrap pool by luminance: the cdf's
    left-side search, as jnp.searchsorted."""
    cdf = torch.cumsum(lum, dim=0)
    cdf = cdf / cdf[-1]
    u = rng.random_1d(seed_word, torch.arange(R, dtype=torch.int64,
                                              device=lum.device), batch, 0)
    idx = torch.searchsorted(cdf, u)
    return torch.clamp(idx, 0, lum.shape[0] - 1)


def _chains(settings) -> int:
    n = settings.width * settings.height
    return min(settings.mlt_chains, max(n, 256))


def render_pass_mlt(scene, settings, sample_start, seed, spp_chunk: int = 1,
                    stats=None):
    """One kelemen_mlt or reversible_jump_mlt batch worth `spp_chunk`
    mutations a pixel on average.  Returns ((H, W, 3) framebuffer sum,
    scaled so that render()'s division by the spp recovers the estimate;
    the JAX package's ray estimate R * steps * min(max_bounces, 8)).
    `stats` (a dict; None: COUNTS) takes _mlt_batch's counts."""
    stats = COUNTS if stats is None else stats
    n = settings.width * settings.height
    R = _chains(settings)
    batch = int(sample_start)
    seed = int(seed) & 0xFFFFFFFF
    dev = scene.device
    strategy_prob = settings.mlt_strategy_prob \
        if settings.integrator_type == "reversible_jump_mlt" else 0.0
    # kelemen's reference default mutates a bidirectional base sampler;
    # the technique exchange is the path tracer's, so reversible_jump_mlt
    # stays on its tape
    use_bdpt = settings.mlt_bidirectional and \
        settings.integrator_type == "kelemen_mlt"
    D = tape_dims_bdpt(settings)[1] if use_bdpt else tape_dims(settings)
    boot = _bootstrap_batch_bdpt if use_bdpt else _bootstrap_batch

    # ---- bootstrap pool: b and the chains' seeds (ref
    # KelemenMltTracer.cpp:97-131) ----
    pool_batches = max(1, min(settings.mlt_sample_pool, 4 * R) // R)
    pools = [boot(scene, settings, seed, batch * 97 + pb, R, D, stats)
             for pb in range(pool_batches)]
    pool_lum = torch.cat([p[-1] for p in pools])
    b = float(torch.mean(pool_lum))
    if b <= 0.0:
        return torch.zeros((settings.height, settings.width, 3),
                           dtype=torch.float32, device=dev), R
    idx = _resample(pool_lum, seed ^ 0x5EED, batch, R)
    init = tuple(torch.cat([p[k] for p in pools])[idx]
                 for k in range(len(pools[0])))

    # ---- chains ----
    n_steps = max(1, spp_chunk * n // R)
    if use_bdpt:
        fb, *_ = _mlt_batch_bdpt(scene, settings, seed, batch, R, n_steps,
                                 *init, stats=stats)
    else:
        fb, *_ = _mlt_batch(scene, settings, seed, batch, R, n_steps, *init,
                            strategy_prob=strategy_prob, stats=stats)
    scale = b * n / (R * n_steps)
    # the JAX package's estimate: a path and its NEE rays a bounce
    rays = R * n_steps * min(settings.max_bounces, 8)
    out = fb.reshape(settings.height, settings.width, 3) * scale * spp_chunk
    return out, rays


def render_pass_mmlt(scene, settings, sample_start, seed, spp_chunk: int = 1,
                     stats=None):
    """Multiplexed MLT: chains restricted to one path length k each, with
    budgets proportional to the bootstrap luminance b_k of length k (ref
    MultiplexedMltIntegrator.cpp:88-125), on the bidirectional tape
    (mlt_bidirectional, the BDPT strategies with s + t - 1 = k) or on the
    path tracer's.  Returns as render_pass_mlt; a `stats` dict of the
    caller's also takes the b_k ("b_k") and each length's steps
    ("steps_k")."""
    own = stats is not None
    stats = stats if own else COUNTS
    n = settings.width * settings.height
    R = _chains(settings)
    max_len = min(settings.max_bounces, 8)
    batch = int(sample_start)
    seed = int(seed) & 0xFFFFFFFF
    dev = scene.device
    use_bdpt = settings.mlt_bidirectional
    fb_total = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = 0
    b_ks, inits, length_settings = [], [], []
    for k in range(1, max_len + 1):
        s_k = replace(settings, mlt_path_length=k)
        if use_bdpt:
            init = _bootstrap_batch_bdpt(scene, s_k, seed, batch * 131 + k, R,
                                         tape_dims_bdpt(s_k)[1], stats)
        else:
            init = _bootstrap_batch(scene, s_k, seed, batch * 131 + k, R,
                                    tape_dims(s_k), stats)
        b_ks.append(float(torch.mean(init[-1])))
        inits.append(init)
        length_settings.append(s_k)
    b_sum = sum(b_ks)
    if own:
        stats.update(b_k=b_ks, steps_k=[0] * max_len)
    if b_sum <= 0.0:
        return torch.zeros((settings.height, settings.width, 3),
                           dtype=torch.float32, device=dev), R

    total_samples = spp_chunk * n
    for k, (b_k, init, s_k) in enumerate(zip(b_ks, inits, length_settings),
                                         start=1):
        if b_k <= 0.0:
            continue
        # a chain budget proportional to b_k
        n_steps = max(1, int(total_samples * (b_k / b_sum)) // R)
        if not float(torch.sum(init[-1])) > 0:
            continue
        idx = _resample(init[-1], seed ^ (0x5EED + k), batch, R)
        init_k = tuple(v[idx] for v in init)
        if use_bdpt:
            fb, *_ = _mlt_batch_bdpt(scene, s_k, seed, batch * 131 + k, R,
                                     n_steps, *init_k, stats=stats)
        else:
            fb, *_ = _mlt_batch(scene, s_k, seed, batch * 131 + k, R,
                                n_steps, *init_k, stats=stats)
        if own:
            stats["steps_k"][k - 1] = n_steps
        fb_total = fb_total + fb * (b_k * n / (R * n_steps))
        rays += R * n_steps * k
    out = fb_total.reshape(settings.height, settings.width, 3) * spp_chunk
    return out, rays
