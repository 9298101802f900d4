"""Meshes and rank processes.

``make_production_mesh`` describes the production layout (16 × 16, or 2 ×
16 × 16 with "pod") without starting anything; ``make_host_mesh`` builds
a live ``DeviceMesh`` over the ranks of the initialized process group;
``spawn`` starts the rank processes that tests, ``launch.train`` and
``chip_smoke.py`` run under a mesh.

    from repro_torch.launch.mesh import make_host_mesh, spawn

    def work(rank, world):                 # a module-level function
        mesh = make_host_mesh(model=2)
        ...
        return result                      # picklable; the caller gets it

    results = spawn(work, 2, backend="gloo", devices=["cpu", "cpu"])

The backend is never chosen for the caller: "nccl" needs a card for each
rank, "gloo" takes CPU tensors and CUDA tensors alike (it stages CUDA
tensors through the host), so ranks that share one card run gloo, and
their first printed line says that they share it.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List, Sequence

import torch

from repro_torch.dist.sharding import MeshLayout


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """16×16 = 256 ranks per pod; 2 pods = 512 when ``multi_pod``.  A
    layout only: no process group this large starts here."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_host_mesh(model: int = 1, device_type: str = "cpu"):
    """(world / model, model) ``DeviceMesh`` named ("data", "model") over
    the ranks of the initialized process group, for tensors of
    ``device_type``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    model = min(model, n)
    if n % model:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model}")
    ranks = torch.arange(n).reshape(n // model, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def check_backend(backend: str, devices: Sequence[str]) -> None:
    """Refuse a backend that cannot serve these rank devices: NCCL takes
    one card per rank, and neither backend is picked for the caller."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: pass 'gloo' or 'nccl'")
    if backend == "nccl":
        if any(torch.device(d).type != "cuda" for d in devices):
            raise ValueError("nccl needs a CUDA device for every rank")
        if len(set(str(torch.device(d)) for d in devices)) < len(devices):
            raise ValueError("nccl refuses two ranks on one card; ranks "
                             "that share a card run 'gloo'")


def rank_devices(device: str, n: int) -> List[str]:
    """Rank devices for ``device``: every rank on the CPU, or rank r on
    card r mod the card count (all of them on cuda:0 on one card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [str(dev)] * n
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    count = torch.cuda.device_count()
    return [f"cuda:{r % count}" for r in range(n)]


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               devices: Sequence[str], args: tuple, tmp: str,
               timeout_s: float) -> None:
    import torch.distributed as dist
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    here = sum(torch.device(d) == device for d in devices)
    note = (f"; {here} ranks share this device, so no time here is a "
            f"multi-device time" if here > 1 and device.type == "cuda"
            else "")
    print(f"rank {rank}/{world}: backend={backend} device={device}{note}",
          flush=True)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *, backend: str,
          devices: Sequence[str], args: tuple = (),
          timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``nprocs`` spawned processes
    (CUDA cannot fork) joined by ``backend`` over a file rendezvous in a
    temporary directory (no TCP port to clash), each on ``devices[rank]``
    with a ``timeout_s`` collective timeout, so a collective that hangs
    raises.  Returns the ranks' return values in rank order; a rank that
    raises makes ``spawn`` raise (the others are stopped)."""
    import torch.multiprocessing as mp
    if len(devices) != nprocs:
        raise ValueError(f"{nprocs} ranks need {nprocs} devices, got "
                         f"{list(devices)}")
    check_backend(backend, devices)
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    try:
        mp.start_processes(_rank_main,
                           args=(fn, nprocs, backend, list(devices), args,
                                 tmp, timeout_s),
                           nprocs=nprocs, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

