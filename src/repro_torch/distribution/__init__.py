"""The model stack's mesh layer (counterpart of ``repro.distribution``):
sharding rules from key paths and shapes to specs and DTensor placements
(:mod:`.sharding`), and the activation constraints the model calls, the
identity without a mesh (:mod:`.constraints`)."""
