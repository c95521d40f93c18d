"""The port's leaf microbenchmark (tungsten_tpu_torch/tools/mxubench.py)
against the TPU tool on the CPU.

K4: the plain version equals tools_mxubench.make_loop_kernel run through
its own pl.pallas_call with the tool's specs in interpret mode, on seeded
bf16 inputs at M 128, K 48, N 128, 3 iterations, with and without the
store chain (rtol 1e-5: bf16 products are exact in f32, the sums differ
only in order).  K5: kA/kB/kC are closures inside bench_variants, so the
plain versions are held against a float64 numpy transcription of
tools_mxubench.py:86-136 at shrunk table widths (rtol 1e-5, and exactly
on the tool's all-ones inputs).  The CUDA kernel itself is held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools_mxubench as tpu_tool
from tungsten_tpu_torch.tools import mxubench as mxb


def _bf16(rng, shape):
    """Seeded values rounded to bf16 (as a torch tensor and as the
    float64 numpy array of the rounded values)."""
    t = torch.from_numpy(rng.uniform(-1.0, 1.0, shape).astype(np.float32)) \
        .to(torch.bfloat16)
    return t, t.float().numpy().astype(np.float64)


@pytest.mark.parametrize("with_stores", [False, True])
def test_mma_loop_plain_equals_pallas_kernel(with_stores):
    M, K, N, iters = 128, 48, 128, 3
    a, a64 = _bf16(np.random.default_rng(3), (K, N))
    fn = pl.pallas_call(
        tpu_tool.make_loop_kernel(M, K, N, iters, with_stores), grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, N), jnp.float32),
        scratch_shapes=[pltpu.VMEM((K, M), jnp.bfloat16)], interpret=True)
    want = np.asarray(fn(jnp.asarray(a64, jnp.bfloat16)))
    row, cs, last = mxb.mma_loop(a, M, iters, with_stores)   # CPU: plain
    assert row.shape == (1, N) and row.dtype == torch.float32
    np.testing.assert_allclose(row.numpy(), want, rtol=1e-5, atol=1e-5)
    # the checksum is every element of every product (float64)
    b = np.zeros((K, M))
    if with_stores:
        for r0, c0, rows in mxb.loop_stores(M, K):
            b[r0:r0 + rows, c0:c0 + 128] = a64[0:rows, 0:128]
    prod = b.T @ a64
    np.testing.assert_allclose(last.numpy(), prod, rtol=1e-5, atol=1e-5)
    assert cs.dtype == torch.float64
    assert abs(cs.item() - iters * prod.sum()) <= 1e-6 * iters * \
        np.abs(prod).sum() + 1e-9
    assert (np.abs(want).sum() > 0) == with_stores


def test_store_chains_transcribe_the_tool():
    # tools_mxubench.py:27-31 and :94-100
    assert mxb.loop_stores(1024, 48) == [
        (ko + 4, c, 6) for ko in (0, 16, 32) for c in (0, 128, 256, 384)]
    assert mxb.loop_stores(512, 16) == [(4, c, 6) for c in (0, 128, 256,
                                                            384)]
    assert mxb.loop_stores(128, 48) == [(4, 0, 6), (20, 0, 6), (36, 0, 6)]
    stores = mxb.variant_a_stores()
    assert len(stores) == 48
    cover = np.zeros((48, 2048), int)
    for r0, c0, rows in stores:
        cover[r0:r0 + rows, c0:c0 + 128] += 1
    assert cover.max() == 1          # no store overwrites another
    assert cover.sum() == 4 * 3 * 128 * (6 + 6 + 4 + 3)


def _numpy_variant(variant, a, tbl, iters):
    """tools_mxubench.py:86-136 in float64 numpy: (row (1, N), every
    product's element sum)."""
    M, K, N = 2048, 48, 128
    acc = np.zeros((1, N))
    total = 0.0
    b_ref = np.zeros((K, M))
    src, src4, src3 = a[0:6, 0:128], a[0:4, 0:128], a[0:3, 0:128]
    for i in range(iters):
        if variant == "a":
            for q in range(4):
                for ko in (0, 16, 32):
                    c = q * 512
                    b_ref[ko + 4:ko + 10, c + 128:c + 256] = src
                    b_ref[ko + 4:ko + 10, c + 256:c + 384] = src
                    b_ref[ko + 0:ko + 4, c + 384:c + 512] = src4
                    b_ref[ko + 4:ko + 7, c:c + 128] = src3
            s = b_ref.T @ a
        else:
            col = (i % 64) * 2048
            b = tbl[:, col:col + M]
            if variant == "b":
                s = b.T @ a
            else:
                s = b.T @ a[0:32] + b[0:16].T @ a[32:48]
        acc = acc + s[0:1]
        total += s.sum()
    return acc, total


@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_leaf_variant_plain_equals_numpy_transcription(variant):
    iters = 4
    rng = np.random.default_rng(9)
    a, a64 = _bf16(rng, (48, 128))
    rows = mxb.TABLE_ROWS[variant]
    # shrunk tables: iters slices of 2048 columns instead of 1024 * 512
    tbl, t64 = _bf16(rng, (rows, iters * 2048)) if rows else (None, None)
    row, cs, _ = mxb.leaf_variant(variant, a, tbl, iters)
    want_row, want_cs = _numpy_variant(variant, a64, t64, iters)
    np.testing.assert_allclose(row.numpy(), want_row, rtol=1e-5, atol=1e-5)
    assert abs(cs.item() - want_cs) <= 1e-6 * abs(want_cs) + 1e-3
    # the tool's all-ones inputs: small integers, equal exactly
    a1, t1 = mxb.ones_inputs(48, 128, torch.device("cpu"), rows)
    if rows:
        t1 = t1[:, :iters * 2048].contiguous()
    row1, cs1, _ = mxb.leaf_variant(variant, a1, t1, iters)
    ones = np.ones((rows or 48, iters * 2048))
    want_row1, want_cs1 = _numpy_variant(variant, np.ones((48, 128)), ones,
                                         iters)
    assert np.array_equal(row1.numpy(), want_row1)
    assert cs1.item() == want_cs1


def test_kernel_parameters():
    """What the launcher hands the kernel: the k steps (kC's third step
    pairs the slice's first 16 rows with a[32:48]), the store list and
    the table stride."""
    p = mxb.make_params(2048, 128, 32, 48, 256, mxb._k_steps("c", 48),
                        tbl_ld=mxb.NCP * 512)
    assert p.nk == 3 and list(p.kstep_b)[:3] == [0, 1, 0]
    assert list(p.kstep_a)[:3] == [0, 1, 2]
    assert p.table == 1 and p.tbl_ld == mxb.NCP * 512
    assert (p.tbl_period, p.tbl_step) == (64, 2048)
    q = mxb.make_params(512, 128, 48, 48, 512, mxb._k_steps(None, 48),
                        mxb.loop_stores(512, 48))
    # the 12 stores of 128 columns, each split over two 64-column tiles
    assert q.nk == 3 and q.n_pieces == 24 and q.table == 0
    pieces, starts = mxb.split_stores(512, mxb.loop_stores(512, 48))
    assert [(q.pc_row[i], q.pc_rows[i], q.pc_col[i], q.pc_src[i],
             q.pc_width[i]) for i in range(24)] == pieces
    assert list(q.tile_piece)[:9] == starts and q.src_rows == 6
    assert q.blocks == 0 and mxb.grid_blocks(q) == 16
    q1 = mxb.make_params(512, 128, 48, 48, 512, mxb._k_steps(None, 48),
                         blocks=1)
    assert q1.n_pieces == 0 and q1.src_rows == 0 and mxb.grid_blocks(q1) == 1


def test_bound_and_report():
    # 2*M*K*N at the card's 989 TFLOP/s; one SM's share of it beside
    ns, by, staged = mxb.bound_ns(512, 48, 128, 512)
    assert by == "operations" and staged == 0
    assert ns == pytest.approx(2 * 512 * 48 * 128 / 989e12 * 1e9)
    ns_sm, by_sm, _ = mxb.bound_ns(512, 48, 128, 512, sms=1)
    assert by_sm == "operations" and ns_sm == pytest.approx(132 * ns)
    ns_b, by_b, staged_b = mxb.bound_ns(2048, 48, 128, 256, table_rows=48)
    assert staged_b == 48 * 2048 * 2 and by_b == "operations"
    # kB's bytes: a, the 64 slices it touches and the outputs at 3.35 TB/s
    nbytes = 48 * 128 * 2 + 64 * staged_b + 128 * 4 + 8
    assert ns_b > nbytes / 3.35e12 * 1e9 / 256
    # the bound beside it is at the SMs of the launch's grid: (128, 48,
    # 128) is four 64x64 tiles, four blocks
    r = mxb.bench(128, 48, 128, iters=2, with_stores=True, device="cpu")
    assert r["name"] == "mma_loop_stores" and r["library_ns"] is None
    assert r["blocks"] == 4
    assert r["sm_bound_ns"] == pytest.approx(132 / 4 * r["bound_ns"])
    assert "ns/matmul" in mxb.format_result(r)


@pytest.mark.parametrize("with_stores", [False, True])
def test_mma_loop_plain_from_a_random_scratch(with_stores):
    """The initial scratch a check of K4's kernel starts from: the plain
    version's products against numpy (rtol 1e-5), the stores landing on
    top of it."""
    M, K, N, iters = 128, 48, 128, 3
    rng = np.random.default_rng(11)
    a, a64 = _bf16(rng, (K, N))
    b0, b64 = _bf16(rng, (K, M))
    kept = b0.clone()
    row, cs, last = mxb.mma_loop(a, M, iters, with_stores, b0=b0)
    assert torch.equal(b0, kept), "the caller's b0 must not be written"
    if with_stores:
        for r0, c0, rows in mxb.loop_stores(M, K):
            b64[r0:r0 + rows, c0:c0 + 128] = a64[0:rows, 0:128]
    prod = b64.T @ a64
    np.testing.assert_allclose(last.numpy(), prod, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(row.numpy(), iters * prod[0:1], rtol=1e-5,
                               atol=1e-5)
    assert abs(cs.item() - iters * prod.sum()) <= 1e-6 * iters * \
        np.abs(prod).sum() + 1e-9


def test_cpu_wrapper_counts_no_launch():
    before = dict(mxb.LAUNCHES)
    a = torch.ones((16, 128), dtype=torch.bfloat16)
    mxb.mma_loop(a, 128, 2, True)
    assert mxb.LAUNCHES == before
    with pytest.raises(ValueError, match="variant"):
        mxb.leaf_variant("d", a)


@pytest.mark.parametrize("M,K,stores", [
    (128, 48, "loop"), (512, 16, "loop"), (512, 48, "loop"),
    (1024, 48, "loop"), (2048, 48, "loop"), (2048, 48, "a")])
def test_split_over_blocks_covers_chain_and_slice_once(M, K, stores):
    """The host's split of the store chain over the kernel's 64-column
    tiles writes every element the tool's chain writes exactly once, from
    the same element of a, each piece inside its own tile; the tiles'
    columns of a table slice cover the slice exactly once for every
    column of tiles."""
    chain = mxb.loop_stores(M, K) if stores == "loop" else \
        mxb.variant_a_stores()
    rows = max(r0 + n for r0, _, n in chain)
    want = np.full((rows, M), -1)        # a's column each B element gets
    for r0, c0, n in chain:
        want[r0:r0 + n, c0:c0 + 128] = np.arange(128)
    got = np.full((rows, M), -1)
    hits = np.zeros((rows, M), int)
    pieces, starts = mxb.split_stores(M, chain)
    assert len(starts) == M // mxb.TILE + 1 and starts[-1] == len(pieces)
    for mt in range(M // mxb.TILE):
        for r0, n, col, src, width in pieces[starts[mt]:starts[mt + 1]]:
            assert mt * 64 <= col and col + width <= (mt + 1) * 64
            assert col % 8 == 0 and src % 8 == 0 and width % 8 == 0
            got[r0:r0 + n, col:col + width] = np.arange(src, src + width)
            hits[r0:r0 + n, col:col + width] += 1
    assert np.array_equal(got, want)
    assert hits.max() == 1 and hits.sum() == (want >= 0).sum()
    tiles = mxb.tile_origins(M, 128)
    assert len(tiles) == (M // 64) * 2
    for n0 in (0, 64):
        cover = np.zeros(M, int)
        for m0, n in tiles:
            if n == n0:
                cover[m0:m0 + mxb.TILE] += 1
        assert (cover == 1).all()
