"""Sobol' low-discrepancy sampler (port of tungsten_tpu/utils/sobol.py).

The direction numbers are GENERATED at first use, exactly as the JAX
package generates them: primitive polynomials over GF(2) found by
exhaustive search in increasing order, free initial direction numbers
m_j drawn odd from a fixed-seed numpy generator.  value(index, dim) =
XOR of the direction numbers v_{dim, j} over the set bits of the
(scrambled) index; uint32 words are held as int32 bit patterns.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

NUM_DIMS = 1024
BITS = 32


def _gf2_mulmod(a: int, b: int, p: int, d: int) -> int:
    """(a*b) mod p over GF(2)[x], deg p = d."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> d & 1:
            a ^= p
    return r


def _gf2_powmod(a: int, e: int, p: int, d: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf2_mulmod(r, a, p, d)
        a = _gf2_mulmod(a, a, p, d)
        e >>= 1
    return r


def _prime_factors(n: int):
    out = set()
    f = 2
    while f * f <= n:
        while n % f == 0:
            out.add(f)
            n //= f
        f += 1
    if n > 1:
        out.add(n)
    return out


@functools.lru_cache(maxsize=4)
def _primitive_polys(count: int):
    """First `count` primitive polynomials over GF(2) (excluding x+1),
    in increasing degree/value order, as (poly_bits, degree)."""
    polys = []
    d = 2
    while len(polys) < count:
        order = (1 << d) - 1
        factors = _prime_factors(order)
        for p in range(1 << d | 1, 1 << (d + 1), 2):
            if _gf2_powmod(2, order, p, d) != 1:
                continue
            if any(_gf2_powmod(2, order // q, p, d) == 1 for q in factors):
                continue
            polys.append((p, d))
            if len(polys) >= count:
                break
        d += 1
    return polys


@functools.lru_cache(maxsize=4)
def direction_matrix(num_dims: int = NUM_DIMS) -> np.ndarray:
    """(num_dims, 32) uint32 direction numbers, MSB-aligned."""
    V = np.zeros((num_dims, BITS), np.uint32)
    for j in range(BITS):
        V[0, j] = 1 << (31 - j)
    polys = _primitive_polys(num_dims - 1)
    rng = np.random.default_rng(0x5060701)
    for i, (poly, s) in enumerate(polys, start=1):
        a = [(poly >> (s - k)) & 1 for k in range(1, s)]
        m = [0] * BITS
        for j in range(s):
            m[j] = int(rng.integers(0, 1 << j)) * 2 + 1
        for j in range(s, BITS):
            val = m[j - s] ^ (m[j - s] << s)
            for k in range(1, s):
                if a[k - 1]:
                    val ^= m[j - k] << k
            m[j] = val
        for j in range(BITS):
            V[i, j] = np.uint32(m[j] << (31 - j))
    return V


@functools.lru_cache(maxsize=8)
def device_matrix(device: torch.device) -> torch.Tensor:
    """The direction matrix as an int32 (D, 32) tensor on `device`."""
    return torch.from_numpy(direction_matrix().view(np.int32).copy()).to(
        device)


def sobol_uint(index, dim):
    """Scrambled-index Sobol' value (int32-held uint32); dims wrap mod
    NUM_DIMS.  index/dim are int32 tensors of uint32 words."""
    V = device_matrix(index.device)
    rows = V[(dim.to(torch.int64) & 0xFFFFFFFF) % NUM_DIMS]     # (..., 32)
    shape = torch.broadcast_shapes(index.shape, rows.shape[:-1])
    out = torch.zeros(shape, dtype=torch.int32, device=index.device)
    for j in range(BITS):
        bit = (index >> j) & 1
        out = out ^ (rows[..., j] * bit)
    return out


def validate_matrix(num_dims: int = 16, n: int = 256) -> bool:
    """Each dim's first 2^k points must be a (0, k, 1)-net in base 2
    (perfect stratification), the defining Sobol' property."""
    V = direction_matrix()
    for d in range(num_dims):
        vals = np.zeros(n, np.uint32)
        for i in range(n):
            x, g = 0, i
            j = 0
            while g:
                if g & 1:
                    x ^= int(V[d, j])
                g >>= 1
                j += 1
            vals[i] = x
        u = vals.astype(np.float64) / 2 ** 32
        for k in (4, 16, 64, 256):
            if k > n:
                break
            counts = np.bincount((u * k).astype(int), minlength=k)
            if not (counts == n // k).all():
                return False
    return True
