"""The engine's packer alone on the cell's grid (host clock, synchronised):
``pack_instances`` or ``pack_instances_maxmarg``, as ``run_sweep`` calls
it."""


def read(run):
    spans = run.spans.get("pack")
    return 1e3 * spans[0] if spans else None
