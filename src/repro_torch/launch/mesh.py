"""Device meshes (counterpart of ``repro.launch.mesh``).

The model stack's meshes are ``torch.distributed`` ``DeviceMesh``es with
named dims over the initialised default process group:
:func:`make_production_mesh` ((16, 16) ``("data", "model")``, or (2, 16,
16) with a leading ``"pod"`` axis) and :func:`make_host_mesh` (a small
(data, model) mesh over the ranks there are).  Built on demand; the
process group comes first (``torch.distributed.init_process_group``, or
the launcher's :func:`init_ranks`).  The H100 constants below are what the
dry-run's roofline takes its terms against.

The engine's mesh is another thing: a :class:`DataMesh` is a 1-D ``("data",)`` axis of torch devices, in order:
the sharded hot loop (:mod:`repro_torch.engine.hotloop`) gives shard s the
s-th slice of a sweep's instance axis and keeps that slice's tensors on
``devices[s]``.  Shards do not communicate, so the mesh is only the
ordered device list.  A device may appear more than once: each shard still
gets tensors of its own, so one card (or the CPU) runs S logical shards —
the counterpart of the JAX package's forced host devices.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch import _device

# H100 constants (per card) for the dry-run's roofline terms
PEAK_FLOPS_BF16 = 989e12      # FLOP/s dense; NVIDIA H100 80GB HBM3, 700 W
HBM_BW = 3.35e12              # bytes/s; NVIDIA H100 80GB HBM3, 700 W
NVLINK_BW = 450e9             # bytes/s each way; NVIDIA H100 80GB HBM3, 700 W
CHIP_HBM_BYTES = 80e9         # bytes; NVIDIA H100 80GB HBM3, 700 W


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group (or launch.mesh.init_ranks) "
                           "first")
    return dist.get_world_size()


def _mesh(device: str, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda"):
    """(16, 16) ("data", "model") over 256 ranks, or (2, 16, 16) ("pod",
    "data", "model") over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_host_mesh(model: int = 1, data: int = 1, *, device: str = "cuda"):
    """Small (data, model) mesh over the ranks there are (tests /
    examples), clamped as the JAX package clamps it."""
    n = _world()
    model = min(model, n)
    data = max(1, min(data, n // model))
    return _mesh(device, (data, model), ("data", "model"))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_ranks(device: str = "cuda") -> Tuple[int, int]:
    """Initialise the default process group from the environment
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; one rank when absent) and return
    (rank, world size).  The backend follows the device: NCCL on the card
    (one rank a card: rank r takes card ``LOCAL_RANK`` or r), gloo on the
    CPU.  (gloo on CUDA tensors would let ranks share a card, but its
    functional all-gather, which DTensor issues, fails there on torch
    2.11: ROADMAP Queue 3.)"""
    import torch.distributed as dist
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = _device.resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT") or (_free_port() if world == 1
                                             else "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return rank, world


class DataMesh(NamedTuple):
    """1-D ``("data",)`` mesh: shard s of a sharded engine record lives on
    ``devices[s]``."""

    devices: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}


def make_data_mesh(
    n_devices: Optional[int] = None,
    *,
    device: Union[str, torch.device, Sequence] = "cuda",
) -> DataMesh:
    """1-D ("data",) mesh for the engine's sharded hot loop.

    ``device`` is a device type (default ``"cuda"``: every card of
    ``torch.cuda.device_count()``, ``cuda:0`` first; ``"cpu"``: the one
    host device) or an explicit device list, which may repeat a device.
    The mesh takes the first ``n_devices`` of those (default: all) and
    raises ``ValueError`` unless ``1 <= n_devices <= available``.  The
    engine shards its leading instance axis B over the mesh:
    ``pack_instances(..., mesh=...)`` pads B to a multiple of the axis size
    with born-done dummy instances so every shard carries an equal slice.
    """
    if isinstance(device, (str, torch.device)):
        dev = _device.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            avail = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
        else:
            avail = [dev]
    else:
        avail = [_device.resolve(d) for d in device]
    n = len(avail) if n_devices is None else n_devices
    if not 1 <= n <= len(avail):
        raise ValueError(f"need 1 <= n_devices <= {len(avail)}, got {n}")
    return DataMesh(tuple(avail[:n]))
