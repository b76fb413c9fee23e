"""Device meshes over ``torch.distributed`` — port of
``repro.launch.mesh``.

The reference builds ``jax.make_mesh`` meshes of one process's devices;
here a mesh is a ``DeviceMesh`` over processes, one rank a device (or
several ranks sharing a device over gloo), built by
``torch.distributed.device_mesh.init_device_mesh``. Nothing in the
environment tells a program of its cluster, so ``make_mesh`` takes the
process group's address (``init_method``: ``tcp://host:port`` or
``file://path``), world size and rank, and the backend and device,
explicitly. ``parallel.runner.ShardMapRunner`` runs the GP programs over
the mesh's data axes (``gp_machine_axes``).
"""
from __future__ import annotations

import datetime
import math

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def rank_device(local_rank: int, device_type: str = "cuda") -> torch.device:
    """A rank's default device: ``cuda:{local_rank % device_count}`` (the
    CUDA card; raises without one), or the CPU when named."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' (with "
            "backend='gloo') to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _check_nccl(backend: str, device: torch.device, world_size: int) -> None:
    """NCCL takes one rank a device: refuse a world that would put two on
    one card before ``init_process_group`` can hang on it."""
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"backend 'nccl' needs CUDA devices; got {device}")
    cards = torch.cuda.device_count()
    if world_size > cards:
        raise ValueError(
            f"backend 'nccl' cannot put {world_size} ranks on {cards} CUDA "
            f"device(s): NCCL refuses two ranks on one device. Use "
            f"backend='gloo' to share a device, or at most {cards} ranks")


def make_mesh(shape, axes, *, rank: int, world_size: int, init_method: str,
              backend: str = "nccl", device=None,
              timeout_s: float = 600.0):
    """An arbitrary mesh (tests / examples): initialize this process's rank
    of a ``world_size`` process group, then the ``DeviceMesh`` of ``shape``
    named ``axes`` over it. ``device`` is this rank's device (by default
    ``rank_device(rank)``, the card); a CUDA device is made current.
    Returns the mesh."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"ranks, the world {world_size}")
    dev = rank_device(rank) if device is None else torch.device(device)
    _check_nccl(backend, dev, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, rank: int,
                         world_size: int, init_method: str,
                         backend: str = "nccl", device=None):
    """The 16 x 16 ("data", "model") single-pod mesh, or 2 x 16 x 16
    ("pod", "data", "model") over two pods: 256 or 512 ranks, one a card.
    Raises unless ``world_size`` is that many ranks."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    need = math.prod(shape)
    if world_size != need:
        raise ValueError(
            f"the production mesh {shape} {axes} needs {need} ranks; this "
            f"world has {world_size}")
    return make_mesh(shape, axes, rank=rank, world_size=world_size,
                     init_method=init_method, backend=backend, device=device)


def gp_machine_axes(mesh) -> tuple[str, ...]:
    """The paper's M machines = all data-parallel axes of the mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in ("pod", "data") if a in names)
