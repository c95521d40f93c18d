"""Multi-process runtime of the port: torch.distributed bring-up, the
data-parallel mesh over every rank, scene replication, and the
alive-ray rebalancing exchange (port of tungsten_tpu/parallel/
distributed.py).

The reference has no cluster support: its multi-machine story is "run N
seeds on N machines and hdrmanip --merge the outputs".  Here each rank
is one process with one device (or a share of one): `init_distributed`
joins the ranks that torchrun (or any launcher setting its variables)
started, a mesh is a 1-D `DeviceMesh` named "dp" over them, and
framebuffers and gradients are summed with collectives.  NCCL carries
CUDA scenes, gloo CPU ones.  gloo moves CPU tensors only in some of its
collectives (all-to-all among them), so with gloo a CUDA tensor is
staged through a host copy for the exchange: a transport detail, the
work stays on the card.

A single process is untouched: `init_distributed()` does nothing
without the launcher's variables.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tungsten_tpu_torch.device import resolve_device
from tungsten_tpu_torch.integrators.path_tracer import pack_rows, unpack_rows

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_distributed(device=None, backend: str | None = None,
                     timeout_s: float | None = None) -> bool:
    """Join the process group that MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK and LOCAL_RANK (torchrun's names) describe.  `device` is the
    scenes' device (None: CUDA, as every entry point): NCCL for CUDA,
    gloo for the CPU, unless `backend` says otherwise.  A CUDA rank
    takes the card LOCAL_RANK modulo the cards it sees.  `timeout_s`
    bounds each collective's wait (torch's default otherwise).  Returns
    whether a process group is up; safe to call more than once, and
    without the variables it does nothing."""
    if dist.is_initialized():
        return True
    if not all(os.environ.get(k) for k in ENV):
        return False
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0") or 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                    f"{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        **({} if timeout_s is None else
           {"timeout": datetime.timedelta(seconds=timeout_s)}))
    return True


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_device_type() -> str:
    """The DeviceMesh device type of the process group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_global_mesh(axis: str = "dp") -> DeviceMesh:
    """One data-parallel mesh over every rank, in rank order (a launcher
    numbers ranks host-major, so one host's devices form a contiguous
    block and the collectives between them stay on its links)."""
    return DeviceMesh(mesh_device_type(), torch.arange(dist.get_world_size()),
                      mesh_dim_names=(axis,))


def mesh_group(mesh: DeviceMesh, axis: str = "dp"):
    """(process group, ranks in the mesh, this rank's place in it or None
    when this rank is not in the mesh)."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None, mesh.size(), None
    return mesh.get_group(axis), mesh.size(), coord[0]


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The SUM of t over the group (a new tensor on t's device)."""
    if _staged(t, group):
        h = t.detach().cpu()
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t (equal shapes) stacked along dim 0 in group-rank
    order."""
    src = t.detach().cpu() if _staged(t, group) else t.detach().contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def all_to_all_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Block j of t's rows (R / n each) goes to group rank j; block i of
    the result came from group rank i."""
    src = t.cpu() if _staged(t, group) else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def broadcast_(t: torch.Tensor, src: int, group) -> None:
    """Overwrite t (any dtype, any layout, in place) with global rank
    src's t."""
    if t.numel() == 0:
        return
    buf = t if t.is_contiguous() else t.contiguous()
    flat = buf.view(-1).view(torch.uint8)
    if _staged(t, group):
        h = flat.cpu()
        dist.broadcast(h, src=src, group=group)
        flat.copy_(h)
    else:
        dist.broadcast(flat, src=src, group=group)
    if buf is not t:
        t.copy_(buf)


def device_put_replicated(scene, mesh: DeviceMesh, axis: str = "dp"):
    """Replicate a FlatScene across the mesh: every tensor (tuple fields
    too) takes the values of the mesh's first rank, in place.  The ranks
    must hold scenes of the same shapes (flattened from the same file).
    Returns the scene."""
    from dataclasses import fields
    from tungsten_tpu_torch.scene.flatten import TUPLE_FIELDS
    group, _, me = mesh_group(mesh, axis)
    if me is None:
        return scene
    src = int(mesh.mesh.reshape(-1)[0])
    for f in fields(scene):
        v = getattr(scene, f.name)
        for t in (v if f.name in TUPLE_FIELDS else (v,)):
            broadcast_(t, src, group)
    return scene


# ------------------------------------------------------------ rebalance

def _deal_permutation(R: int, ndev: int, device=None) -> torch.Tensor:
    """Round-robin 'deal' layout: position j*ndev+i of the sorted deck
    lands in block i slot j, so each of the ndev all-to-all blocks gets
    every ndev-th ray: an alive-sorted deck splits its alive rays evenly
    across the blocks."""
    B = R // ndev
    ar = torch.arange(R, device=device)
    return (ar % B) * ndev + ar // B


def rebalance_wave(state: dict, mesh: DeviceMesh, ndev: int | None = None,
                   axis: str = "dp") -> dict:
    """All-to-all redistribution of a wavefront across the mesh: sort the
    local rays alive-first, deal them round-robin into one block per
    rank, exchange.  Afterwards every rank holds (to within one ray per
    sender) the same number of alive rays, so drained ranks pick up the
    busy ranks' tails.  Ray identity (pixel, sample) travels in the
    state, so radiance still banks to the right pixels; the width per
    rank is unchanged.  The fields move packed in one f32 matrix (as
    path_tracer._gather_rows packs them); scalars and host values (the
    bounce, the rays counter) pass through."""
    group, n, me = mesh_group(mesh, axis)
    ndev = n if ndev is None else ndev
    R = state["alive"].shape[0]
    if me is None or ndev <= 1 or R % ndev != 0:
        return state
    order = torch.argsort(torch.where(state["alive"], 0, 1).to(torch.int32),
                          stable=True)
    deal = order[_deal_permutation(R, ndev, order.device)]
    rows, specs, passthru = pack_rows(state)
    return unpack_rows(all_to_all_rows(rows[deal], group), specs, passthru)
