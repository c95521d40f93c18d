"""The port's path-replay gradients through the two-strategy NEE and the
generalized shadow ray, against the JAX package's: tests/test_torch_
replay.py's box (lambert walls only) filled with a homogeneous HG fog
that the camera sits in, 16x16, 1 spp, max_bounces 4; gradients w.r.t.
the medium's sigma_s and sigma_a and the light's emission.

The JAX package's trace_wave_replay cannot give this scene's gradient:
its shadow ray walks its hops in a lax.while_loop
(tungsten_tpu/integrators/path_tracer.py:323), which reverse mode
refuses.  Forward mode goes through it, so the JAX witness is the same
estimator built from the JAX package's own parts:
_init_state(detach=True), then _make_bounce_body(detach=True) until
max_bounces or until no lane is alive (its loop), every state field but
emission and throughput detached between bodies (as the replay's
backward re-runs each body on the detached state), with the tangents of
emission and throughput carried from body to body by jax.jvp (one
compile of the body, run for each of the nine parameter entries).  At 4 bounces
Russian roulette can only rescale the last body's throughput, which no
later body reads, so this and the replay are the same derivative.

One guard is needed for forward mode: area_light_sample's pdf,
r^2 / max(cos * area, 1e-20), has the tangent 0 * inf where the light
faces away (cos <= 0, the sample invalid, its contribution zero), and
the NEE carries that NaN into the emission (78 of the 256 lanes NaN
after 4 bodies without the guard).  The witness wraps the JAX function
so that an invalid sample's pdf carries no tangent; the values are
unchanged, and a valid sample's tangent is untouched.

Tolerance: that of tests/test_torch_replay.py (rtol 1e-3 on entries
above 1e-3 * max|g|; the largest deviation seen is 1e-6 relative).  The
same gradients are also held to plain reverse mode over the port's
unrolled bounce loop (rtol 1e-4), and the emission gradient to central
finite differences (the gate of tests/test_diff.py, 2e-2): emission
enters linearly and moves no decision.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tungsten_tpu.integrators import lights as jlights
from tungsten_tpu.integrators import path_tracer as jpt
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.integrators import path_tracer as tpt
from test_torch_replay import (SEED, _assert_grads_close, _fd, _ids,
                               _jax_params, _with, port_grads, scenes)

FIELDS = ("med_sigma_s", "med_sigma_a", "light_emission")
# lambert walls alone: the box's other BSDFs are tests/test_torch_
# replay.py's
BSDFS = [{"type": "lambert", "albedo": a} for a in (
    [0.7, 0.7, 0.7], [0.7, 0.2, 0.2], [0.4, 0.4, 0.6], [0.6, 0.5, 0.3],
    [0.3, 0.6, 0.3])]


def tape_grads(ts, tset, names):
    """The replay's estimator by reverse mode over the unrolled loop."""
    leaves = [getattr(ts, k).detach().clone().requires_grad_()
              for k in names]
    sc = _with(ts, names, leaves)
    pixel, sample = _ids(tset)
    with torch.no_grad():
        state = tpt._init_state(sc, tset, pixel, sample, SEED)
    body = tpt._make_bounce_body(sc, tset, SEED, replay=True)
    while state["bounce"] < tset.max_bounces and bool(state["alive"].any()):
        out = body(state)
        state = {k: v if k in ("emission", "throughput") or
                 not isinstance(v, torch.Tensor) else v.detach()
                 for k, v in out.items()}
    state["emission"].mean().backward()
    return [x.grad.numpy() for x in leaves]


def _light_sample_without_invalid_tangent(sample):
    def wrapped(*args, **kwargs):
        a = sample(*args, **kwargs)
        pdf = jnp.where(a["valid"], a["pdf"], jax.lax.stop_gradient(a["pdf"]))
        return dict(a, pdf=pdf)
    return wrapped


def jax_witness(js, jset, names):
    """d mean(L) / d names by jax.jvp through the JAX package's detached
    bounce bodies (see the module docstring)."""
    n = jset.width * jset.height
    seed = jnp.uint32(SEED)
    params = _jax_params(js, names)

    @jax.jit
    def step(state, tangent, d_emission, d_throughput):
        """One body on the detached state: its outputs and the tangents
        of emission and throughput."""
        def body(params, emission, throughput):
            sc = _with(js, names, params)
            return jpt._make_bounce_body(sc, jset, seed, detach=True)(
                dict(state, emission=emission, throughput=throughput))
        out, d_out = jax.jvp(
            body, (params, state["emission"], state["throughput"]),
            (tangent, d_emission, d_throughput))
        return out, d_out["emission"], d_out["throughput"]

    prev, sample_fn = jrng._SAMPLER, jlights.area_light_sample
    jrng.set_sampler(jset.stratified_sampler)
    jlights.area_light_sample = _light_sample_without_invalid_tangent(
        sample_fn)
    try:
        state0 = jpt._init_state(js, jset, jnp.arange(n, dtype=jnp.uint32),
                                 jnp.zeros(n, jnp.uint32), seed, True)
        grads = []
        for i, p in enumerate(params):
            g = np.zeros(p.shape, np.float32)
            for idx in np.ndindex(*p.shape):
                tangent = [jnp.zeros_like(x) for x in params]
                tangent[i] = tangent[i].at[idx].set(1.0)
                state, de = state0, jnp.zeros((n, 3))
                dt = jnp.zeros((n, 3))
                while state["bounce"] < jset.max_bounces and \
                        bool(state["alive"].any()):
                    state, de, dt = step(state, tuple(tangent), de, dt)
                g[idx] = float(jnp.mean(de))
            grads.append(g)
    finally:
        jrng._SAMPLER, jlights.area_light_sample = prev, sample_fn
    return grads


@pytest.fixture(scope="module")
def fog(tmp_path_factory):
    js, jset, ts, tset = scenes(tmp_path_factory.mktemp("fog"), fog=True,
                                res=(16, 16), max_bounces=4, bsdfs=BSDFS)
    assert tset.has_media and not tpt._one_sample_mis(tset)
    _, tg, L, stats = port_grads(ts, tset, FIELDS)
    return dict(ts=ts, tset=tset, tg=tg, L=L, stats=stats,
                tape=tape_grads(ts, tset, FIELDS),
                jax=jax_witness(js, jset, FIELDS))


@pytest.mark.parametrize("field", FIELDS)
def test_fog_gradients_match_jax(fog, field):
    i = FIELDS.index(field)
    _assert_grads_close(field, fog["tg"][i], fog["jax"][i])


def test_fog_emission_gradient_matches_finite_differences(fog):
    ts, tset, g = fog["ts"], fog["tset"], fog["tg"]
    values = [getattr(ts, k) for k in FIELDS]
    i = FIELDS.index("light_emission")
    for c in range(3):
        fd = _fd(ts, tset, FIELDS, values, i, (0, c), 1e-2)
        assert g[i][0, c] > 0
        assert abs(fd - g[i][0, c]) / abs(fd) < 2e-2, (c, g[i][0, c], fd)


@pytest.mark.parametrize("field", FIELDS)
def test_fog_gradients_equal_the_unrolled_tape(fog, field):
    i = FIELDS.index(field)
    got, want = fog["tg"][i], fog["tape"][i]
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


def test_fog_replay_is_bitwise(fog):
    stats = fog["stats"]
    assert torch.equal(stats.emission, fog["L"])
    assert stats.bodies == 4
