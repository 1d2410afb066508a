"""Launch helpers of the port (counterpart of ``repro.launch``): the 1-D
``("data",)`` device mesh the engine's sharded hot loop splits a sweep's
instance axis over (:mod:`.mesh`)."""

from repro_torch.launch.mesh import DataMesh, make_data_mesh

__all__ = ["DataMesh", "make_data_mesh"]
