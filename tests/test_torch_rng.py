"""The port's counter RNG, Sobol' sampler and ray sort key against the
JAX package: bit-equal values on a grid that includes uint32 words
>= 2^31 (held as negative int32 in the port)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu.utils import rng as jrng
from tungsten_tpu.utils import sobol as jsobol
from tungsten_tpu.ops import intersect as jis
from tungsten_tpu_torch.utils import rng as trng
from tungsten_tpu_torch.utils import sobol as tsobol
from tungsten_tpu_torch.ops import intersect as tis

SEEDS = [0, 1, 0xBA5EBA11, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]


def _grid(n=4096, seed=11):
    r = np.random.default_rng(seed)
    pixel = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pixel[:8] = [0, 1, 65535, 65536, (1 << 31) - 1, 1 << 31,
                 (1 << 31) + 7, (1 << 32) - 1]
    sample = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    sample[:64] = np.arange(64)
    dim = r.integers(0, 3000, n).astype(np.uint32)
    return pixel, sample, dim


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture
def uniform_sampler(monkeypatch):
    monkeypatch.setattr(jrng, "_SAMPLER", jrng.SAMPLER_UNIFORM)


@pytest.mark.parametrize("seed", SEEDS)
def test_pcg4d_draws_bit_equal(seed, uniform_sampler):
    pixel, sample, dim = _grid()
    jp, js, jd = jnp.asarray(pixel), jnp.asarray(sample), jnp.asarray(dim)
    js_seed = jnp.uint32(seed)
    a = jrng.random_1d(js_seed, jp, js, jd)
    b = trng.random_1d(seed, _t(pixel), _t(sample), _t(dim))
    assert np.array_equal(_bits(a), _bits(b.numpy()))
    for ja, tb in zip(jrng.random_2d(js_seed, jp, js, jd),
                      trng.random_2d(seed, _t(pixel), _t(sample), _t(dim))):
        assert np.array_equal(_bits(ja), _bits(tb.numpy()))
    for ja, tb in zip(jrng.random_3d(js_seed, jp, js, jd),
                      trng.random_3d(seed, _t(pixel), _t(sample), _t(dim))):
        assert np.array_equal(_bits(ja), _bits(tb.numpy()))
    for ja, tb in zip(jrng.untracked_4d(js_seed, jp, js, jd),
                      trng.untracked_4d(seed, _t(pixel), _t(sample),
                                        _t(dim))):
        assert np.array_equal(_bits(ja), _bits(tb.numpy()))


def test_sobol_direction_numbers_equal():
    assert np.array_equal(jsobol.direction_matrix(),
                          tsobol.direction_matrix())


@pytest.mark.parametrize("seed", SEEDS)
def test_sobol_draws_bit_equal(seed):
    pixel, sample, dim = _grid(n=2048, seed=seed % 97)
    a = jrng._sobol_value(jnp.uint32(seed), jnp.asarray(pixel),
                          jnp.asarray(sample), jnp.asarray(dim))
    b = trng.random_1d(seed, _t(pixel), _t(sample), _t(dim), smp=True)
    assert np.array_equal(_bits(a), _bits(b.numpy()))
    # random_2d/3d consume consecutive dims in Sobol' mode too
    b2 = trng.random_3d(seed, _t(pixel), _t(sample), _t(dim), smp=True)
    for k in range(3):
        ak = jrng._sobol_value(jnp.uint32(seed), jnp.asarray(pixel),
                               jnp.asarray(sample), jnp.asarray(dim + k))
        assert np.array_equal(_bits(ak), _bits(b2[k].numpy()))


class _Box:
    def __init__(self, lo, hi, lib):
        self.bvh_min = lib(np.asarray([lo], np.float32))
        self.bvh_max = lib(np.asarray([hi], np.float32))


def test_ray_sort_key_and_order_match():
    r = np.random.default_rng(5)
    R = 4096
    o = r.uniform(-3, 3, (R, 3)).astype(np.float32)
    o[:512] = 0.25   # shared origins: direction bits break ties
    d = r.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[7] = [0.0, 0.0, 1.0]
    dead = r.uniform(size=R) < 0.3
    lo, hi = [-2.0, -2.5, -1.0], [2.0, 2.5, 3.0]
    jk = np.asarray(jis.ray_sort_key(_Box(lo, hi, jnp.asarray),
                                     jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(dead)))
    tk = tis.ray_sort_key(_Box(lo, hi, torch.from_numpy), torch.from_numpy(o),
                          torch.from_numpy(d), torch.from_numpy(dead))
    assert np.array_equal(jk.astype(np.int64), tk.numpy())
    # as unsigned 32-bit words, dead rays (bit 31) sort last
    order = torch.sort(tk, stable=True)[1].numpy()
    assert np.array_equal(order, np.argsort(jk, kind="stable"))
    assert dead[order][-int(dead.sum()):].all()
