"""The port's data-parallel render and train step (tungsten_tpu_torch/
parallel/) on gloo ranks on the CPU, against the single-process port and
the JAX package's sharded render.

One spawn of 4 ranks (tests/torch_dist_cases.py::sharded_cases, spawn
start method, a free port) runs every case on the lambert + mirror + env
scene of tests/test_torch_path_tracer.py (32x24, 2 spp, max_bounces 6)
and saves what each rank got; the tests read those files:
  * render_pass_sharded on meshes of 1, 2 and 4 ranks: images bitwise
    equal to each other and to the per-sample trace_wave sum of one
    process (each rank traces its block at full width, and the RNG is
    keyed on (pixel, sample));
  * render_pass_sharded_staged with rebalance_wave between one-bounce
    segments: within rtol 1e-5 / atol 1e-6 of it, as
    tests/test_sharding.py holds the JAX package;
  * train_step_sharded on 2 ranks: the loss and the gradients of the one
    process's trace_wave_replay, summed in another order (rtol 1e-5 on
    entries above 1e-3 * max|g|, the rest within 1e-6 * max|g|);
  * rebalance_wave on 4 ranks: the same rows in the same order as the
    JAX package's on a 4-device CPU mesh, for the imbalanced wave of
    tests/test_sharding.py (4 devices x 32 rays);
  * the 2-rank image against the JAX package's render_pass_sharded on a
    2-device mesh (one JAX compile) under the image gates of
    tests/test_torch_path_tracer.py;
  * device_put_replicated and measure_scaling.
"""
import copy
import functools

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tungsten_tpu.parallel import distributed as jdist
from tungsten_tpu.parallel import sharded as jsharded
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.parallel.distributed import free_port, init_distributed
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_flatten import jax_fields, scene_with_env
import torch_dist_cases

WORLD = 4
SPP = 2
SEED = 0xBA5EBA11
PARAMS = ("light_emission", "tex_const")


def imbalanced_wave(ndev=WORLD, per=32):
    """tests/test_sharding.py's wave: device i's first per*(ndev-i)/ndev
    rays alive, seeded values, pixel ids 0..R-1."""
    R = ndev * per
    alive = np.zeros((R,), bool)
    for i in range(ndev):
        alive[i * per:i * per + (per * (ndev - i)) // ndev] = True
    val = np.random.default_rng(3).random((R, 3)).astype(np.float32)
    return alive, val, np.arange(R, dtype=np.int32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    desc = scene_with_env(tmp, mirror_floor=True)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    torch.save((ts, tset, dict(spp=SPP, seed=SEED, params=PARAMS,
                               rebalance=imbalanced_wave())),
               str(tmp / "scene.pt"))
    mp.spawn(torch_dist_cases.sharded_cases,
             args=(WORLD, free_port(), str(tmp)), nprocs=WORLD, join=True)
    ranks = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return dict(js=js, jset=jset, ts=ts, tset=tset, ranks=ranks)


def _per_sample_sum(ts, tset):
    n = tset.width * tset.height
    pixel = torch.arange(n, dtype=torch.int32)
    acc = torch.zeros((n, 3))
    for s in range(SPP):
        rad = tpt.trace_wave(ts, tset, pixel,
                             torch.full((n,), s, dtype=torch.int32), SEED,
                             min_wave=n + 1)
        acc = acc + torch.where(torch.isfinite(rad), rad, 0.0)
    return acc.reshape(tset.height, tset.width, 3)


def test_images_bitwise_across_mesh_sizes(run):
    ranks = run["ranks"]
    img = ranks[0]["image1"]
    assert img.shape == (24, 32, 3) and torch.isfinite(img).all()
    assert img.mean() > 0
    for nd in (2, 4):
        for r in range(nd):
            assert torch.equal(ranks[r][f"image{nd}"], img), (nd, r)
            assert ranks[r][f"rays{nd}"] == ranks[0]["rays1"] > 0
    assert "image1" not in ranks[1] and "image2" not in ranks[2]


def test_image_equals_per_sample_trace_wave(run):
    want = _per_sample_sum(run["ts"], run["tset"])
    assert torch.equal(run["ranks"][0]["image1"], want)


def test_staged_rebalanced_matches_plain(run):
    plain = run["ranks"][0]["image4"].numpy()
    for r in range(WORLD):
        img, rays = run["ranks"][r]["staged"]
        assert rays == run["ranks"][0]["rays4"]
        np.testing.assert_allclose(img.numpy(), plain, rtol=1e-5, atol=1e-6)


def test_train_step_matches_single_process_replay(run):
    ts, tset = run["ts"], run["tset"]
    n = tset.width * tset.height
    leaves = {k: getattr(ts, k).detach().clone().requires_grad_()
              for k in PARAMS}
    rad = tpt.trace_wave_replay(ts.replace(**leaves), tset,
                                torch.arange(n, dtype=torch.int32),
                                torch.zeros(n, dtype=torch.int32), SEED)
    loss = rad.mean()
    loss.backward()
    for r in (0, 1):
        got_loss, grads = run["ranks"][r]["train"]
        assert float(got_loss) == pytest.approx(float(loss.detach()),
                                                rel=1e-6)
        for k in PARAMS:
            want = leaves[k].grad.numpy()
            got = grads[k].numpy()
            m = np.abs(want).max()
            assert m > 0 and np.isfinite(got).all()
            big = np.abs(want) > 1e-3 * m
            np.testing.assert_allclose(got[big], want[big], rtol=1e-5)
            np.testing.assert_allclose(got[~big], want[~big], atol=1e-6 * m)
    assert run["ranks"][2]["train"] is None


@pytest.fixture(scope="module")
def jax_rebalanced():
    """The JAX package's rebalance_wave on a 4-device CPU mesh."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("dp"),) * 3,
                       out_specs=(P("dp"),) * 3, check_vma=False)
    def go(alive, val, pix):
        s = jdist.rebalance_wave(dict(alive=alive, emission=val, pixel=pix,
                                      bounce=jnp.int32(0)), "dp", WORLD)
        return s["alive"], s["emission"], s["pixel"]

    return [np.asarray(x) for x in jax.jit(go)(
        *map(jnp.asarray, imbalanced_wave()))]


def test_rebalanced_rows_equal_jax(run, jax_rebalanced):
    a2, v2, p2 = jax_rebalanced
    per = a2.shape[0] // WORLD
    counts = []
    for r in range(WORLD):
        alive, val, pix, bounce = run["ranks"][r]["rebalance"]
        blk = slice(r * per, (r + 1) * per)
        assert np.array_equal(alive.numpy(), a2[blk])
        assert np.array_equal(val.numpy(), v2[blk])
        assert np.array_equal(pix.numpy(), p2[blk])
        assert bounce == 0
        counts.append(int(alive.sum()))
    assert sum(counts) == int(imbalanced_wave()[0].sum())
    assert max(counts) - min(counts) <= WORLD


def test_two_rank_image_matches_jax_sharded(run):
    js, jset = run["js"], run["jset"]
    prev = jrng._SAMPLER
    jrng.set_sampler(jset.stratified_sampler)
    try:
        jimg, jrays = jsharded.render_pass_sharded(
            js, jset, jsharded.make_mesh(2), seed=SEED, spp_chunk=SPP)
        jimg = np.asarray(jimg)
    finally:
        jrng._SAMPLER = prev
    img = run["ranks"][0]["image2"].numpy()
    assert img.shape == jimg.shape
    close = np.isclose(img, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() / jimg.mean() - 1.0) <= 1e-4
    assert int(jrays) > 0


def test_scene_replicated_from_rank_zero(run):
    want = run["ts"].tex_const
    cols = torch.arange(12.0).reshape(3, 4).t()
    for r in range(WORLD):
        assert torch.equal(run["ranks"][r]["tex_const"], want)
        assert torch.equal(run["ranks"][r]["columns"], cols)


def test_measure_scaling(run):
    res = run["ranks"][0]["scaling"]
    assert sorted(res) == [1, 2, WORLD]
    for nd, row in res.items():
        assert row["rays"] > 0 and row["seconds"] > 0
        assert row["mrays_per_s"] == pytest.approx(
            row["rays"] / row["seconds"] / 1e6)
    assert res[1]["efficiency"] == 1.0
    assert res[2]["rays"] == res[1]["rays"]
    assert sorted(run["ranks"][2]["scaling"]) == [WORLD]


def test_init_distributed_without_the_launcher_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
