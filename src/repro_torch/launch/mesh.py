"""Device meshes (counterpart of ``repro.launch.mesh``).

The model stack's meshes are ``torch.distributed`` ``DeviceMesh``es with
named dims over the initialised default process group:
:func:`make_production_mesh` ((16, 16) ``("data", "model")``, or (2, 16,
16) with a leading ``"pod"`` axis) and :func:`make_host_mesh` (a small
(data, model) mesh over the ranks there are).  Built on demand; the
process group comes first (``torch.distributed.init_process_group``, or
the launcher's :func:`init_ranks`).

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
# the H100's figures (per card; NVIDIA H100 80GB HBM3, 700 W), defined in
# analysis.bounds and named here too for the mesh's callers
from repro_torch.analysis.bounds import (  # noqa: F401
    CHIP_HBM_BYTES,
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
)


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


def init_ranks(device: str = "cuda",
               cards: Optional[int] = None) -> Tuple[int, int]:
    """Initialise the default process group from the environment
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; one rank when absent) and return
    (rank, world size).  The backend follows the device: NCCL on the card
    (one rank a card: rank r takes card ``LOCAL_RANK`` or r, modulo
    ``cards``, the first cards of the host the ranks spread over, default
    every visible one), gloo on the CPU.  Where more ranks than cards
    share a host (``LOCAL_WORLD_SIZE``, else the world), NCCL cannot run:
    the ranks share the cards over gloo, its all-gathers routed through
    c10d (:func:`share_card_gathers`)."""
    import torch.distributed as dist
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = _device.resolve(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = min(cards or torch.cuda.device_count(),
                    torch.cuda.device_count())
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % cards)
        if int(os.environ.get("LOCAL_WORLD_SIZE", world)) > cards:
            share_card_gathers()
        else:
            backend = "nccl"
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT") or (_free_port() if world == 1
                                             else "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return rank, world


_ROUTES: Dict[str, object] = {}


def _c10d_all_gather(inp: torch.Tensor, group_size: int, group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import (ProcessGroup,
                                                    _resolve_process_group)
    group = (group_name if isinstance(group_name, ProcessGroup)
             else _resolve_process_group(group_name))
    out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
    return out


def share_card_gathers(device_type: str = "cuda") -> None:
    """Route the functional all-gather (``_c10d_functional.
    all_gather_into_tensor``, which DTensor's redistributions issue) on
    ``device_type`` tensors through c10d's own ``all_gather_into_tensor``,
    synchronously.  With gloo on CUDA tensors (ranks sharing a card) the
    functional one ends the processes (signal 11 on torch 2.11,
    ``scripts/gloo_card_probe.py``) while c10d's works; the other
    functional collectives work as they are.  Once a process; the
    gathered values are the same."""
    if device_type in _ROUTES:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _c10d_all_gather, device_type.upper())
    _ROUTES[device_type] = lib


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
