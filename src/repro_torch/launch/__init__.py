"""Launch helpers of the port (counterpart of ``repro.launch``): the model
stack's ``DeviceMesh``es and the H100 constants (:mod:`.mesh`), the
training launcher (:mod:`.train`), the dry-run planner (:mod:`.dryrun`),
and the 1-D ``("data",)`` device mesh the engine's sharded hot loop splits
a sweep's instance axis over (``DataMesh``)."""

from repro_torch.launch.mesh import (
    DataMesh,
    init_ranks,
    make_data_mesh,
    make_host_mesh,
    make_production_mesh,
)

__all__ = ["DataMesh", "init_ranks", "make_data_mesh", "make_host_mesh",
           "make_production_mesh"]
