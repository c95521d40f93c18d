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


# rows a run of take's backward sums before the runs are added
# (ops/segment_sum.py::ordered_index_add's `block`)
TAKE_BLOCK = 1024


class _Take(torch.autograd.Function):
    """F.embedding's gather with a backward that sums each table row's
    cotangents in a fixed order (ops/segment_sum.py: a stable sort of
    the lanes by row, then runs of TAKE_BLOCK lanes summed in order, then
    the runs), where F.embedding's CUDA backward accumulates with
    atomics (compute_grad_weight_atomic_accumulate) and so changes the
    replay's gradients in their last bits from run to run."""

    @staticmethod
    def forward(ctx, table2d, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table2d.shape[0]
        return torch.nn.functional.embedding(idx, table2d)

    @staticmethod
    def backward(ctx, g):
        from tungsten_tpu_torch.ops.segment_sum import ordered_index_add
        idx, = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        grad = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype,
                           device=g.device)
        return ordered_index_add(grad, idx.reshape(-1).to(torch.int32), g,
                                 block=TAKE_BLOCK), None


def take(table, idx):
    """table[idx] along dim 0, through F.embedding: its forward is the
    same one gather.  Where the table carries a graph (a parameter the
    replay differentiates) on the card, the backward is _Take's, a sort
    and ordered sums (F.embedding's own adds with atomics); on the CPU it
    is F.embedding's, which adds in lane order.  Advanced indexing's
    backward on CUDA (indexing_backward_kernel_small_stride) walks each
    row's duplicates one after another, which a wave of a million lanes
    gathering from a table of a few rows turns into a serial chain."""
    t2 = table.reshape(table.shape[0], -1)
    if t2.requires_grad and t2.is_cuda and torch.is_grad_enabled():
        rows = _Take.apply(t2, idx)
    else:
        rows = torch.nn.functional.embedding(idx, t2)
    return rows.reshape(idx.shape + table.shape[1:])
