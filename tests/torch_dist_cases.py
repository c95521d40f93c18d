"""Rank functions of tests/test_torch_sharded.py: each spawned rank runs
one of these.  This module imports neither JAX nor tests/conftest.py, so
a spawned child imports it quickly and cleanly."""
import os

import torch
import torch.distributed as dist


def _join(rank, world, port):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    from tungsten_tpu_torch.parallel.distributed import init_distributed
    assert init_distributed(device="cpu", timeout_s=300)


def sharded_cases(rank, world, port, tmpdir):
    """Everything the sharded tests read, on `world` gloo ranks of one
    process group: the scene replicated from rank 0, the image on meshes
    of 1, 2 and 4 ranks, the staged render with rebalance, a train step
    on 2 ranks, rebalance_wave on an imbalanced wave, measure_scaling.
    Each rank saves what it got to rank<r>.pt."""
    _join(rank, world, port)
    from tungsten_tpu_torch.parallel import distributed as D
    from tungsten_tpu_torch.parallel import sharded as S
    scene, settings, cfg = torch.load(os.path.join(tmpdir, "scene.pt"),
                                      weights_only=False)
    out = {}
    # replication: every other rank starts from a perturbed table
    if rank:
        scene.tex_const.add_(1.0)
    D.device_put_replicated(scene, D.make_global_mesh())
    out["tex_const"] = scene.tex_const.clone()
    # a non-contiguous tensor takes rank 0's values in place too
    cols = (torch.arange(12.0).reshape(3, 4) + rank).t()
    D.broadcast_(cols, 0, None)
    out["columns"] = cols.clone()
    spp, seed = cfg["spp"], cfg["seed"]
    for nd in (1, 2, 4):
        got = S.render_pass_sharded(scene, settings, S.make_mesh(nd),
                                    spp_chunk=spp, seed=seed)
        if got is not None:
            out[f"image{nd}"], out[f"rays{nd}"] = got
    out["staged"] = S.render_pass_sharded_staged(
        scene, settings, S.make_mesh(), spp_chunk=spp, seed=seed, segment=1)
    n = settings.width * settings.height

    def loss_fn(rad, pix):
        return torch.sum(torch.where((pix < n)[:, None], rad, 0.0)) / \
            (3 * n)

    out["train"] = S.train_step_sharded(
        scene, settings, S.make_mesh(2), lambda sc, p: sc.replace(**p),
        loss_fn, {k: getattr(scene, k) for k in cfg["params"]}, seed=seed)
    alive, val, pix = (torch.from_numpy(a) for a in cfg["rebalance"])
    per = alive.shape[0] // world
    blk = slice(rank * per, (rank + 1) * per)
    s = D.rebalance_wave(dict(alive=alive[blk], emission=val[blk],
                              pixel=pix[blk], bounce=0), D.make_global_mesh())
    # clones: the unpacked fields view one packed matrix as several types
    out["rebalance"] = (s["alive"].clone(), s["emission"].clone(),
                        s["pixel"].clone(), s["bounce"])
    out["scaling"] = S.measure_scaling(scene, settings, (1, 2, world),
                                       seed=seed)
    torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
