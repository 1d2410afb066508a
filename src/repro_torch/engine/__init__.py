"""Batched protocol engine on tensors (counterpart of ``repro.engine``).

The paper's experiments are sweeps — ε × partition × dataset × protocol —
and every instance is independent, so the data plane batches them: a state
record with a leading instance axis, one selector ``step`` driven by the
host-side hot loop, and on-device communication accounting
(:class:`BatchCommLog`) lowered to ``CommLog.summary`` dicts at the end.
The per-turn scans, the bulk scans over sweep state (:mod:`.dataplane`)
and the refit solver run as hand-written CUDA kernels on the card
(:mod:`repro_torch.kernels`).

Three execution paths share the conventions: MEDIAN / k-party
(:mod:`.median`), MAXMARG (:mod:`.maxmarg`), and the one-way chain
protocols with the §7 baselines (:mod:`.oneway`: reservoir chain plus
batched terminal fits).  ``run_sweep`` buckets a mixed grid across all of
them — or, with ``unified_dispatch=True``, routes MEDIAN + MAXMARG +
SAMPLING through :mod:`.unified`'s mixed-selector superset state, where
the selector is per-row data and one step drives any mix.  The session
pool (:mod:`.session_pool`) streams such sessions through one pinned
launch shape, with the fault model of :mod:`.faults`.  The two-way
selectors also run sharded over a 1-D ("data",) device mesh
(``mesh=``, :func:`repro_torch.launch.mesh.make_data_mesh`): each shard's
slice of the instance axis on its own device.
"""

from repro_torch.engine.state import (
    BatchCommLog,
    EngineData,
    MaxMargState,
    ProtocolInstance,
    ProtocolState,
    SELECTOR_CODES,
    SELECTOR_NAMES,
    UnifiedState,
    from_reference,
    maxmarg_transcript_capacity,
    pack_instances,
    pack_instances_maxmarg,
    pack_instances_unified,
    transcript_capacity,
    unified_transcript_capacity,
)
from repro_torch.engine.median import run_compiled, run_instances, step
from repro_torch.engine import (
    dataplane,
    hotloop,
    maxmarg,
    median,
    oneway,
    unified,
)

_FIT = ("steps", "stages", "lam", "device")
# each selector's options, as the JAX package's ``_ALLOWED``
_ALLOWED = {
    "median": ("eps", "n_angles", "max_epochs", "cut_kernel",
               "extremes_kernel", "compact", "mesh", "donate", "overlap",
               "stats", "device"),
    "maxmarg": ("eps", "max_epochs", "max_support", "warm", "per_node",
                "compact", "fused_kernel", "solver_kernel", "mesh",
                "donate", "overlap", "stats") + _FIT,
    "sampling": ("eps", "vc_dim", "c") + _FIT,
    "naive": _FIT,
    "voting": _FIT,
    "mixing": _FIT,
    "unified": ("eps", "n_angles", "max_epochs", "max_support", "warm",
                "per_node", "compact", "vc_dim", "c", "solver_kernel",
                "width_policy", "stats") + _FIT,
}
_RUNNERS = {"median": run_instances, "maxmarg": maxmarg.run_instances,
            "unified": unified.run_instances,
            **{sel: oneway.run_instances for sel in oneway.ONEWAY_SELECTORS}}


def run_sweep(instances, *, unified_dispatch=False, **kwargs):
    """Dispatch a sweep and return results in input order.

    Instances bucket by (selector, k, d), one engine dispatch per bucket, as
    in the JAX package: the full paper grid (two-way MEDIAN/MAXMARG,
    one-way sampling and the §7 baselines) is one call.  With
    ``unified_dispatch=True`` MEDIAN, MAXMARG and SAMPLING instances bucket
    by (k, d) only and run through :func:`unified.run_instances`, one
    dispatch for any mix (the §7 baselines keep their own either way).
    Each bucket's runner gets only the options its selector accepts
    (``mesh``/``donate`` reach MEDIAN and MAXMARG, ``stats`` those and the
    unified dispatch); an option no selector in the sweep accepts raises
    ``TypeError``; an unknown selector ``ValueError``.

    Launch-shape contract: each bucket's shapes key on the static scenario
    shape (k, d, n_max and cap rounded to multiples of 8, the selector's
    static options) and, for the two-way selectors, the hot loop's
    quantized ``(n_pad, width, use_warm)`` buckets, never on ε, seeds or
    shard contents.
    """
    buckets = {}
    for i, inst in enumerate(instances):
        if inst.selector not in _ALLOWED or inst.selector == "unified":
            raise ValueError(f"unknown selector {inst.selector!r}")
        sel_key = ("unified" if unified_dispatch
                   and inst.selector in SELECTOR_CODES else inst.selector)
        key = (sel_key, len(inst.shards), inst.shards[0][0].shape[1])
        buckets.setdefault(key, []).append(i)
    understood = set().union(*(_ALLOWED[sel] for sel, _k, _d in buckets))
    unknown = set(kwargs) - understood
    if unknown:
        raise TypeError(f"run_sweep got option(s) {sorted(unknown)} that no "
                        f"selector in this sweep accepts")
    out = [None] * len(instances)
    for (selector, _k, _d), idxs in buckets.items():
        opts = {a: kwargs[a] for a in _ALLOWED[selector] if a in kwargs}
        res = _RUNNERS[selector]([instances[i] for i in idxs], **opts)
        for i, r in zip(idxs, res):
            out[i] = r
    return out


__all__ = [
    "BatchCommLog",
    "EngineData",
    "MaxMargState",
    "ProtocolInstance",
    "ProtocolState",
    "SELECTOR_CODES",
    "SELECTOR_NAMES",
    "UnifiedState",
    "dataplane",
    "from_reference",
    "hotloop",
    "maxmarg",
    "maxmarg_transcript_capacity",
    "median",
    "oneway",
    "pack_instances",
    "pack_instances_maxmarg",
    "pack_instances_unified",
    "run_compiled",
    "run_instances",
    "run_sweep",
    "step",
    "transcript_capacity",
    "unified",
    "unified_transcript_capacity",
]
