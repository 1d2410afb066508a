"""The engine's device mesh (counterpart of ``repro.launch.mesh``'s
``make_data_mesh``).

A :class:`DataMesh` is a 1-D ``("data",)`` axis of torch devices, in order:
the sharded hot loop (:mod:`repro_torch.engine.hotloop`) gives shard s the
s-th slice of a sweep's instance axis and keeps that slice's tensors on
``devices[s]``.  Shards do not communicate, so the mesh is only the
ordered device list.  A device may appear more than once: each shard still
gets tensors of its own, so one card (or the CPU) runs S logical shards —
the counterpart of the JAX package's forced host devices.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch import _device


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
