"""SoA 3-vector math over tensors of shape (..., 3) (port of
tungsten_tpu/utils/vecmath.py).  Every function broadcasts over leading
dims, so the same code serves a single ray or a wavefront of millions."""
from __future__ import annotations

import numpy as np
import torch

PI = float(np.pi)
TWO_PI = 2.0 * PI
FOUR_PI = 4.0 * PI
INV_PI = 1.0 / PI
INV_TWO_PI = 1.0 / TWO_PI
INV_FOUR_PI = 1.0 / FOUR_PI


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def dot3(a, b):
    """Dot product keeping the trailing axis."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(a):
    return torch.sum(a * a, dim=-1)


def length(a):
    return torch.sqrt(length_sq(a))


def normalize(a, eps: float = 0.0):
    n = length(a)
    if eps:
        n = torch.clamp(n, min=eps)
    return a / n[..., None]


def safe_normalize(a):
    return normalize(a, eps=1e-20)


def reflect(w, n):
    return 2.0 * dot3(w, n) * n - w


def lerp(a, b, t):
    return a + (b - a) * t


def luminance(rgb):
    """Rec. 709 luminance."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def ortho_frame(n):
    """Branchless orthonormal basis from unit normal n (Duff et al. 2017):
    returns (tangent, bitangent)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tangent = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx],
                          dim=-1)
    bitangent = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return tangent, bitangent


def to_local(t, b, n, w):
    """World direction -> tangent frame (t,b,n) local coords (z = normal)."""
    return torch.stack([dot(t, w), dot(b, w), dot(n, w)], dim=-1)


def to_global(t, b, n, w):
    """Tangent-frame local coords -> world direction."""
    return t * w[..., 0:1] + b * w[..., 1:2] + n * w[..., 2:3]


def transform_point(mat, p):
    """Apply (..., 4, 4) or (4,4) affine matrix to points (..., 3)."""
    return (torch.einsum("...ij,...j->...i", mat[..., :3, :3], p)
            + mat[..., :3, 3])


def transform_vector(mat, v):
    """Apply rotation/scale part of affine matrix to vectors (..., 3)."""
    return torch.einsum("...ij,...j->...i", mat[..., :3, :3], v)


def max_component(a):
    return torch.amax(a, dim=-1)


def avg_component(a):
    return torch.mean(a, dim=-1)


def where3(mask, a, b):
    """Select whole 3-vectors with a (...,)-shaped bool mask."""
    return torch.where(mask[..., None], a, b)


def clip(x, lo=None, hi=None):
    """torch.clamp(x, lo, hi) with jnp.clip's derivative at a tie.

    jnp.clip is minimum(maximum(x, lo), hi), and jnp.maximum /
    jnp.minimum split the derivative evenly between equal operands, so
    at x == lo or x == hi the JAX package's derivative is 0.5 where
    torch.clamp's is 1.  Where x carries a graph this takes the same
    minimum/maximum route (torch.maximum/minimum split ties the same
    way); without one it is torch.clamp, which gives the same values."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)

    def bound(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.full((), v, dtype=x.dtype, device=x.device)

    if lo is not None:
        x = torch.maximum(x, bound(lo))
    if hi is not None:
        x = torch.minimum(x, bound(hi))
    return x


def take(table, idx):
    """table[idx] along dim 0, through F.embedding: its forward is the
    same one gather, and where the table carries a graph (a parameter
    the replay differentiates) its backward sums each row's cotangents
    with a sort and a segmented reduction; advanced indexing's backward
    on CUDA (indexing_backward_kernel_small_stride) walks each row's
    duplicates one after another, which a wave of a million lanes
    gathering from a table of a few rows turns into a serial chain."""
    rows = torch.nn.functional.embedding(
        idx, table.reshape(table.shape[0], -1))
    return rows.reshape(idx.shape + table.shape[1:])
