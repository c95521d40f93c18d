"""Stateless, replay-exact counter RNG (port of tungsten_tpu/utils/rng.py).

Every random number is addressed by (seed, pixel, sample, dim) and hashed
with pcg4d (Jarzynski & Olano, JCGT 2020), drawn from the scrambled
Sobol' sequence of utils/sobol.py when the draw's sampler `smp` is True,
or read from a primary-sample-space `Tape` when `smp` is one (the MLT
integrators).
The JAX package latches the sampler and the tape in module globals
(`set_sampler`, `tape_mode`); here the sampler is an argument that every
draw takes, and each lane reads its own tape row.

torch has no usable uint32 arithmetic, so words live in int32 tensors:
two's-complement multiply and add wrap mod 2^32 exactly as uint32 does,
and every logical `>> k` is written `(x >> k) & mask` because int32's
shift is arithmetic.  The results are bit-equal to the JAX package's.

Dimension layout: dims 0..3 camera, then DIMS_PER_BOUNCE per bounce
(offsets in `BounceDims`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

DIM_CAMERA = 0
DIMS_CAMERA = 4
DIMS_PER_BOUNCE = 20


class BounceDims:
    """Offsets of each per-bounce random decision inside its dim block."""
    LIGHT_SELECT = 0
    LIGHT_SAMPLE = 1
    LIGHT_TRI = 3
    NEE_BSDF_LOBE = 4
    NEE_BSDF_SAMPLE = 5
    NEE_BSDF_LOBE2 = 7
    BSDF_LOBE = 8
    BSDF_SAMPLE = 9
    BSDF_LOBE2 = 11
    ROULETTE = 12
    MEDIUM = 13
    FORWARD = 16


def bounce_dim(bounce, slot):
    return DIMS_CAMERA + bounce * DIMS_PER_BOUNCE + slot


# bidirectional tapes: dims from here on (bdpt.LIGHT_WALK_DIM_OFFSET) are
# the light root's and walk's
LIGHT_DIM_OFFSET = 4096


@dataclass(frozen=True)
class Tape:
    """A primary-sample-space tape: MLT drives the tracer from one
    mutated (D,) vector per chain instead of the counter hash (the
    reference's MetropolisSampler).  A draw at `dim` reads column
    dim mod D of the lane's row and ignores (seed, pixel, sample); lane i
    reads row i, or the row `at(rows)` names for it (the path tracer
    passes its wave state's `lane`, which sorts and compactions move
    with the lane).  light_cols, for bidirectional tapes: dims >=
    LIGHT_DIM_OFFSET read column dim - LIGHT_DIM_OFFSET + light_cols
    instead of wrapping, so camera- and light-walk coordinates take
    separate columns."""
    table: torch.Tensor
    light_cols: int | None = None
    rows: torch.Tensor | None = field(default=None, init=False)

    def at(self, rows):
        """The same tape read through lane rows `rows` (R,)."""
        tape = Tape(self.table, self.light_cols)
        object.__setattr__(tape, "rows", rows.long())
        return tape

    def read(self, dim: int):
        d = self.table.shape[1]
        dim = int(dim)
        if self.light_cols is not None and dim >= LIGHT_DIM_OFFSET:
            dim = dim - LIGHT_DIM_OFFSET + self.light_cols
        col = dim % d
        if self.rows is None:
            return self.table[:, col]
        return self.table[self.rows, col]


def sampler(settings, tape=None):
    """What a draw's `smp` argument takes: the tape when one drives the
    trace, else the settings' choice of Sobol' (True) or pcg4d (False)."""
    return tape if tape is not None else bool(settings.stratified_sampler)


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def u32(x, device=None) -> torch.Tensor:
    """A uint32 word (Python int or integer tensor) as its int32 bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            return x
        v = x.to(torch.int64) & 0xFFFFFFFF
        return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)
    v = int(x) & 0xFFFFFFFF
    if v >= 1 << 31:
        v -= 1 << 32
    return torch.tensor(v, dtype=torch.int32, device=device)


def _shr(x, k: int):
    """Logical right shift of int32-held uint32 words."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def _pcg4d(v0, v1, v2, v3):
    """pcg4d mixing of four uint32 words (int32 tensors); returns four."""
    M = 1664525
    A = 1013904223
    x = v0 * M + A
    y = v1 * M + A
    z = v2 * M + A
    w = v3 * M + A
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ _shr(x, 16)
    y = y ^ _shr(y, 16)
    z = z ^ _shr(z, 16)
    w = w ^ _shr(w, 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _to_unit_float(u):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return _shr(u, 8).to(torch.float32) * (1.0 / (1 << 24))


def _words(seed, pixel, sample_idx, dim):
    dev = _device_of(pixel, sample_idx, dim, seed)
    return (u32(pixel, dev), u32(sample_idx, dev), u32(dim, dev),
            u32(seed, dev))


def _sobol_value(seed, pixel, sample_idx, dim):
    from tungsten_tpu_torch.utils import sobol
    pix, smp, dm, sd = _words(seed, pixel, sample_idx, dim)
    # per-pixel scramble + index permutation in runs of 256
    h, h2, _, _ = _pcg4d(pix, dm, torch.tensor(0x50B0, dtype=torch.int32,
                                                device=pix.device), sd)
    idx = smp ^ (h2 & 0xFF)
    v = sobol.sobol_uint(idx, dm)
    return _to_unit_float(v ^ h)


def random_1d(seed, pixel, sample_idx, dim, smp=False):
    """One uniform float in [0,1) addressed by (seed, pixel, sample, dim).
    `smp`: False (pcg4d), True (Sobol') or a Tape (read the tape)."""
    if isinstance(smp, Tape):
        return smp.read(dim)
    if smp:
        return _sobol_value(seed, pixel, sample_idx, dim)
    x, _, _, _ = _pcg4d(*_words(seed, pixel, sample_idx, dim))
    return _to_unit_float(x)


def random_2d(seed, pixel, sample_idx, dim, smp=False):
    """Two uniform floats; consumes dims [dim, dim+1]."""
    if isinstance(smp, Tape):
        return smp.read(dim), smp.read(dim + 1)
    if smp:
        return (_sobol_value(seed, pixel, sample_idx, dim),
                _sobol_value(seed, pixel, sample_idx, dim + 1))
    x, y, _, _ = _pcg4d(*_words(seed, pixel, sample_idx, dim))
    return _to_unit_float(x), _to_unit_float(y)


def random_3d(seed, pixel, sample_idx, dim, smp=False):
    if isinstance(smp, Tape):
        return smp.read(dim), smp.read(dim + 1), smp.read(dim + 2)
    if smp:
        return (_sobol_value(seed, pixel, sample_idx, dim),
                _sobol_value(seed, pixel, sample_idx, dim + 1),
                _sobol_value(seed, pixel, sample_idx, dim + 2))
    x, y, z, _ = _pcg4d(*_words(seed, pixel, sample_idx, dim))
    return _to_unit_float(x), _to_unit_float(y), _to_unit_float(z)


def untracked_4d(seed, pixel, sample_idx, dim):
    """Four uniforms from one pcg4d hash (never Sobol', never the tape:
    the reference's untracked1D, helper randomness for inversion that
    must not consume or disturb the tape)."""
    x, y, z, w = _pcg4d(*_words(seed, pixel, sample_idx, dim))
    return (_to_unit_float(x), _to_unit_float(y),
            _to_unit_float(z), _to_unit_float(w))
