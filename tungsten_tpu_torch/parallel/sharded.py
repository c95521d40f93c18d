"""Multi-device rendering and training: pixels x spp data-parallel over a
mesh of torch.distributed ranks (port of tungsten_tpu/parallel/
sharded.py, with torch.distributed in place of shard_map).

The reference's parallelism is tile data-parallelism on a thread pool
plus manual multi-machine seed-splitting merged by `hdrmanip --merge`.
Here each rank of a 1-D mesh (parallel/distributed.py) holds the whole
flattened scene, traces the contiguous block of (padded) pixel ids that
falls to it, and the blocks meet in one collective at the end (ranks
own disjoint pixels, as the reference's tiles do).  Determinism: the
RNG is keyed on (pixel, sample) and each rank traces its block at full
width, so any mesh size gives a bitwise-identical image.

The differentiable path sums parameter gradients across the mesh: the
data-parallel gradient of the north star.  A rank outside the mesh
takes no part and gets None.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tungsten_tpu_torch.integrators.path_tracer import (
    bank_emission, init_wave, run_bounces, trace_wave, trace_wave_diff)
from tungsten_tpu_torch.parallel.distributed import (
    all_gather_rows, all_reduce, mesh_device_type, mesh_group,
    rebalance_wave)


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> DeviceMesh:
    """A 1-D mesh over the first n_devices ranks (None: every rank).  A
    collective: every rank of the world calls it."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n} outside 1..{world}")
    return DeviceMesh(mesh_device_type(), torch.arange(n),
                      mesh_dim_names=(axis,))


def _mesh_inputs(scene, mesh: DeviceMesh, axis: str, n: int):
    """This rank's contiguous block of the n padded pixel ids (what
    P(axis) gives its device), and the scene.  None off the mesh."""
    _, ndev, me = mesh_group(mesh, axis)
    if me is None:
        return None, scene
    B = n // ndev
    pixels = torch.arange(me * B, (me + 1) * B, dtype=torch.int32,
                          device=scene.device)
    return pixels, scene


def _padded(settings, mesh: DeviceMesh) -> tuple[int, int]:
    n = settings.width * settings.height
    return n, n + (-n) % mesh.size()


def _samples(pixels, sample: int):
    return torch.full(pixels.shape, int(sample), dtype=torch.int32,
                      device=pixels.device)


def render_pass_sharded(scene, settings, mesh: DeviceMesh, sample_start=0,
                        seed=0, spp_chunk: int = 1, axis: str = "dp"):
    """Render spp_chunk samples for every pixel, pixels sharded over the
    mesh: each rank sums its block's per-sample trace_wave radiance
    (full width, non-finite samples dropped), then the blocks are
    gathered and the ray counts summed.  Returns ((H, W, 3) radiance
    sum, total rays traced) on every mesh rank."""
    n, n_pad = _padded(settings, mesh)
    pixels, scene = _mesh_inputs(scene, mesh, axis, n_pad)
    if pixels is None:
        return None
    group = mesh_group(mesh, axis)[0]
    acc = torch.zeros(pixels.shape + (3,), dtype=torch.float32,
                      device=pixels.device)
    rays = torch.zeros((), dtype=torch.int64, device=pixels.device)
    for i in range(spp_chunk):
        rad, r = trace_wave(scene, settings, pixels,
                            _samples(pixels, sample_start + i), seed,
                            with_stats=True, min_wave=pixels.shape[0] + 1)
        acc = acc + torch.where(torch.isfinite(rad), rad, 0.0)
        rays = rays + r
    img = all_gather_rows(acc, group)[:n]
    return (img.reshape(settings.height, settings.width, 3),
            int(all_reduce(rays, group)))


def _alive_total(state, group) -> int:
    return int(all_reduce(torch.sum(state["alive"].to(torch.int64)), group))


def render_pass_sharded_staged(scene, settings, mesh: DeviceMesh,
                               sample_start=0, seed=0, spp_chunk: int = 1,
                               axis: str = "dp", segment: int = 4,
                               rebalance: bool = True):
    """Sharded render with the bounce loop in segments of `segment`
    bodies; between segments the alive rays are redistributed across the
    mesh (rebalance_wave), so drained ranks take over the busy ranks'
    tails.  The loop ends when the whole mesh's wavefront is extinct
    (the summed alive count), not a rank's, and every rank's bounce
    counter advances by the whole segment even where its own rays died
    early: the ranks leave the loop together, and rays dealt to a rank
    that idled keep the bounce (the RNG dimensions) they reached.  Rays
    migrate, so every rank banks into a full frame and the frames are
    summed at the end.  Returns ((H, W, 3) radiance sum, total rays
    traced) on every mesh rank."""
    n, n_pad = _padded(settings, mesh)
    pixels, scene = _mesh_inputs(scene, mesh, axis, n_pad)
    if pixels is None:
        return None
    group, ndev, _ = mesh_group(mesh, axis)
    fb = torch.zeros((n, 3), dtype=torch.float32, device=pixels.device)
    rays = torch.zeros((), dtype=torch.int64, device=pixels.device)
    for i in range(spp_chunk):
        state = init_wave(scene, settings, pixels,
                          _samples(pixels, sample_start + i), seed)
        while state["bounce"] < settings.max_bounces and \
                _alive_total(state, group) > 0:
            end = min(state["bounce"] + segment, settings.max_bounces)
            state = run_bounces(scene, settings, seed, state, end)
            state["bounce"] = end
            if rebalance:
                state = rebalance_wave(state, mesh, ndev, axis)
        fb = fb + bank_emission(state, n)
        rays = rays + state["rays"]
    return (all_reduce(fb, group).reshape(settings.height, settings.width, 3),
            int(all_reduce(rays, group)))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(scene, settings, device_counts, spp: int = 1,
                    seed: int = 0, staged: bool = True):
    """Rays/s scaling over meshes of the first n ranks, for each n in
    device_counts (a collective: every rank calls it).  Each mesh renders
    once to warm up, then once timed.  Returns {n: {rays, seconds,
    mrays_per_s, efficiency}} on the ranks of each mesh, with efficiency
    the per-rank rays/s over the first mesh's."""
    results = {}
    base_per_dev = None
    fn = render_pass_sharded_staged if staged else render_pass_sharded
    for nd in device_counts:
        mesh = make_mesh(nd)
        if mesh.get_coordinate() is None:
            continue
        fn(scene, settings, mesh, seed=seed, spp_chunk=spp)
        _sync(scene.device)
        dist.barrier(group=mesh.get_group())
        t0 = time.perf_counter()
        _, rays = fn(scene, settings, mesh, seed=seed, spp_chunk=spp)
        _sync(scene.device)
        dt = time.perf_counter() - t0
        mrps = rays / dt / 1e6
        per_dev = mrps / nd
        if base_per_dev is None:
            base_per_dev = per_dev
        results[nd] = {"rays": rays, "seconds": dt, "mrays_per_s": mrps,
                       "efficiency": per_dev / base_per_dev}
    return results


def train_step_sharded(scene, settings, mesh: DeviceMesh, param_fn, loss_fn,
                       params: dict, sample_start=0, seed=0,
                       axis: str = "dp"):
    """One differentiable render step, pixels sharded over the mesh and
    parameter gradients summed across it (the data-parallel gradient).

    param_fn(scene, params) -> the scene with params substituted in;
    loss_fn(radiance (B, 3) of this rank's block, pixel ids (B,)) -> this
    rank's scalar part of the loss (padded ids >= W*H are the caller's
    to mask).  Each rank differentiates its part through
    trace_wave_replay; the parts and the gradients are summed.  Returns
    (loss, {name: gradient}) on every mesh rank."""
    _, n_pad = _padded(settings, mesh)
    pixels, scene = _mesh_inputs(scene, mesh, axis, n_pad)
    if pixels is None:
        return None
    group = mesh_group(mesh, axis)[0]
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    rad = trace_wave_diff(param_fn(scene, leaves), settings, pixels,
                          _samples(pixels, sample_start), seed)
    loss = loss_fn(rad, pixels)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: all_reduce(torch.zeros_like(v) if g is None else g, group)
             for (k, v), g in zip(leaves.items(), got)}
    return all_reduce(loss, group), grads
