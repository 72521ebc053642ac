"""Device meshes over ``torch.distributed`` — torch port of
``repro.launch.mesh``.

The port runs SPMD with one process per device: ``torch.distributed.run``
starts the processes (``init_distributed`` reads its environment).
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
``("data", "model")``, or ``("pod", "data", "model")`` for pipeline
parallelism; rank ``r`` sits at the row-major position of ``r`` in the
mesh's shape, as a JAX mesh lays out its devices.

The process group's backend follows the caller's device, never a fallback:
NCCL for a CUDA device, gloo for the CPU.

``make_production_mesh`` is the JAX package's production pod: 16 x 16
over ("data", "model"), or two such pods, 2 x 16 x 16 over ("pod", "data",
"model"), whose ``pod`` axis is a data axis (``axis_info``).  The dry run
(``launch.dryrun``) builds it over a fake world of 256 or 512 ranks.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device=None) -> tuple[int, int, torch.device]:
    """Join the world ``torch.distributed.run`` started: reads ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.
    On the card each process takes the device of its local rank.  Returns
    (rank, world size, device); a process started without ``torchrun`` is
    a world of one (and needs ``MASTER_ADDR``/``MASTER_PORT`` only if it
    asks for more)."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run a gloo world on the CPU")
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():              # a world already joined
        return dist.get_rank(), dist.get_world_size(), device
    if world == 1:
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", str(_free_port()))
    dist.init_process_group(backend_for(device),
                            init_method="env://", rank=rank,
                            world_size=world)
    return rank, world, device


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over every rank of the default group
    (rank r at its row-major place).  Collective: every rank calls it."""
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over the initialised world (real, or the dry
    run's fake one), which must hold 256 ranks (512 with ``multi_pod``).
    Collective."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, AXES_3D, device_type)
    return make_mesh(PRODUCTION_SHAPE, AXES_2D, device_type)


def make_test_mesh(data: int = 2, model: int = 2,
                   device_type: str = "cpu") -> DeviceMesh:
    """A (data, model) mesh over the whole world."""
    return make_mesh((data, model), AXES_2D, device_type)


def parse_mesh(spec: str, device_type: str = "cuda") -> Optional[DeviceMesh]:
    """A (data, model) mesh from a CLI spec like ``"2x2"`` or ``"4x1"``;
    ``"none"`` or ``""`` give None (a meshless run).  The spec's product
    must equal the world size."""
    if not spec or spec.lower() == "none":
        return None
    try:
        data, model = (int(p) for p in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"mesh spec must look like 'DxT', got {spec!r}") \
            from e
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != world:
        raise ValueError(
            f"mesh {spec!r} needs {data * model} ranks but the world has "
            f"{world} (start it with python -m torch.distributed.run "
            f"--nproc-per-node {data * model})")
    return make_test_mesh(data, model, device_type)


def axis_info(mesh: DeviceMesh) -> dict:
    """dp/tp axis naming convention for a mesh."""
    names = mesh.mesh_dim_names or ()
    dp = tuple(a for a in names if a in ("pod", "data"))
    return {"dp_axes": dp, "tp_axis": "model" if "model" in names else None}
