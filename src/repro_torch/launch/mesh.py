"""Mesh definitions: the production meshes of the dry-run and a mesh over
the real ranks.

The port of ``repro.launch.mesh``.  Functions, not module-level
constants: importing this module starts no process group.  The
reference fakes 512 devices with an XLA flag; here the dry-run's ranks
are a ``fake`` process group (``torch.testing``'s ``FakeStore``): one
process plays rank 0 of 256 or 512, its collectives return at once and
move nothing, so a step traced on ``meta`` tensors records what it would
send without a single device.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


def _init_fake(world: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; multi-pod adds a leading 2-pod axis.

    Built on a ``fake`` process group of 256 or 512 ranks (this process
    is rank 0; a group of another size is torn down first): only the
    dry-run (``launch.dryrun``, in a process of its own) calls it.  The
    mesh's device type is ``cpu``; the dry-run's tensors are ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _init_fake(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def under_torchrun() -> bool:
    """True when the process was started by ``torchrun`` (its
    environment names a world size)."""
    return "WORLD_SIZE" in os.environ


def make_host_mesh(model: int = 1, device=None):
    """A ``(world // model, model)`` mesh ``("data", "model")`` over the
    real ranks.

    Starts the process group when none is: under ``torchrun`` from its
    environment (``env://``; each rank takes the card of its
    ``LOCAL_RANK``), in a lone process a one-rank group over an in-process
    store.  The backend is ``nccl`` on ``cuda`` (the default device) and
    ``gloo`` on ``cpu``.  A world that ``model`` does not divide
    raises."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch._device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if under_torchrun():
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        else:
            if dev.type == "cuda":
                torch.cuda.set_device(dev.index or 0)
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"{world} ranks do not split into model-parallel "
                         f"groups of {model}")
    return init_device_mesh(dev.type, (world // model, model),
                            mesh_dim_names=("data", "model"))


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: its card on a ``cuda``
    mesh, the CPU otherwise."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def describe(mesh) -> dict:
    """``{axis: size}``, as the reference prints ``dict(mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
