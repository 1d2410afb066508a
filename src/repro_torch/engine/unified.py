"""Mixed-selector protocol turns over one superset state (counterpart of
``repro.engine.unified``).

``run_sweep`` buckets a grid by selector; a production mix, where MEDIAN,
MAXMARG and one-way SAMPLING sessions interleave and a session pool admits
any of them into any freed slot, needs one dispatch for all of them.  This
module is that dispatch: one ``step`` over
:class:`~repro_torch.engine.state.UnifiedState`, whose per-instance
selector code is data, so the launched program never depends on the mix.

**Masked substeps.**  The turn runs every family's substep over the shared
leaves and merges row by row on the selector:

* the MEDIAN substep is :func:`repro_torch.engine.median.step` on a view
  whose ``done`` masks every non-MEDIAN row (left out when the mix has no
  MEDIAN row);
* the MAXMARG substep is :func:`repro_torch.engine.maxmarg.step` on a view
  masking MEDIAN rows and SAMPLING rows before their fit turn.  A SAMPLING
  row rides the MAXMARG fit: its Vitter reservoir lives in node ``k-1``'s
  transcript, so at its fit turn (``turn ≥ k-1``, coordinator ``k-1``) the
  fit over own ∪ transcript is the sampling oracle's ``X[k-1] ∪
  reservoir`` fit;
* the SAMPLING hop reuses :func:`repro_torch.engine.oneway._make_ingest`
  (the one-way oracle's Vitter process, bit for bit) on the reservoir
  slice of the shared transcript and meters the oracle's per-hop comm.

Each family's writes to a row another family owns are discarded by the
merge, so every row follows its single-selector trajectory: MEDIAN rows
bit for bit (any covering transcript width is), MAXMARG and SAMPLING rows
exact in decisions and comm, their separators equal up to the float
reassociation of padded solver widths.  Both port steps append into their
own copies of the transcript leaves, so the substeps never see each
other's writes.  A substep's view zeroes the fills of the rows it does
not own: their appends then land at the front of that substep's copy and
are discarded, where the JAX package's clamped ``dynamic_update_slice``
writes past a full reservoir are (torch indexing would raise).

On the card the substeps launch the port's kernels: the MEDIAN cut and
extremes scans, the MAXMARG turn scan and the Pegasos stage (PERF.md
rows 1–4); ``run_instances`` resolves the flags once, on for a CUDA
device.  ``hotloop.run_hot`` drives ``step`` at geometric width buckets
by default, so mixed-width traffic stays within O(log cap) launch shapes.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from repro_torch import _device
from repro_torch.engine import dataplane, hotloop, median, oneway
from repro_torch.engine import maxmarg as mm
from repro_torch.engine.state import (
    EngineData,
    MaxMargState,
    ProtocolInstance,
    ProtocolState,
    SEL_MAXMARG,
    SEL_MEDIAN,
    SEL_SAMPLING,
    UnifiedState,
    pack_instances_unified,
)

_I32 = torch.int32


def _median_view(state: UnifiedState) -> ProtocolState:
    """The MEDIAN substep's input: shared leaves aliased (h_v/h_t live in
    the shared h_w/h_b), every non-MEDIAN row masked done, its fills 0."""
    own = state.sel == SEL_MEDIAN
    return ProtocolState(
        dir_ok=state.dir_ok, wx=state.wx, wy=state.wy,
        w_fill=torch.where(own[:, None], state.w_fill, 0),
        lo_w=state.lo_w, hi_w=state.hi_w, turn=state.turn,
        done=state.done | ~own,
        converged=state.converged, epochs=state.epochs,
        h_v=state.h_w, h_t=state.h_b, h_valid=state.h_valid,
        comm=state.comm)


def _maxmarg_view(state: UnifiedState, k: int) -> MaxMargState:
    """The MAXMARG substep's input: MEDIAN rows masked done, SAMPLING rows
    masked until their fit turn (``turn ≥ k-1``, when the coordinator is
    node k-1 and the fit set is the sampling oracle's).  Only MAXMARG rows
    keep their fills: a SAMPLING row's fit-turn appends are discarded."""
    pre_fit = (state.sel == SEL_SAMPLING) & (state.turn < k - 1)
    own = state.sel == SEL_MAXMARG
    return MaxMargState(
        wx=state.wx, wy=state.wy,
        w_fill=torch.where(own[:, None], state.w_fill, 0),
        turn=state.turn,
        done=state.done | (state.sel == SEL_MEDIAN) | pre_fit,
        converged=state.converged, epochs=state.epochs,
        h_w=state.h_w, h_b=state.h_b, h_valid=state.h_valid,
        warm_turn=state.warm_turn, c_w=state.c_w, c_b=state.c_b,
        c_valid=state.c_valid, warm_node=state.warm_node,
        latches=state.latches, comm=state.comm)


def _bc(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (leaf.ndim - 1))


def step(
    data: EngineData,
    V: torch.Tensor,
    state: UnifiedState,
    *,
    k: int,
    max_support: int = 4,
    steps: int = 2000,
    stages: int = 3,
    lam0: float = 1e-3,
    trans_width: Optional[int] = None,
    warm: bool = False,
    per_node: bool = True,
    has_median: bool = True,
    first_turn: bool = False,
    cut_kernel: bool = False,
    extremes_kernel: bool = False,
    fused_kernel: bool = False,
    solver_kernel: Optional[bool] = None,
) -> UnifiedState:
    """Advance every active instance by one turn of its own protocol.

    The options are the union of the per-selector steps' plus
    ``has_median``, which leaves the MEDIAN substep out for median-free
    mixes (the 1-wide stub arcs pass through).  ``trans_width`` caps every
    transcript read as in the per-selector steps and also bounds the
    SAMPLING reservoir slice, so it must cover every hop row's ``res_cap``
    (the hot loop's host view folds ``res_cap`` into the fills).
    """
    is_med = state.sel == SEL_MEDIAN
    is_mm = state.sel == SEL_MAXMARG
    is_samp = state.sel == SEL_SAMPLING
    active = ~state.done

    # -- family substeps over the shared leaves -----------------------------
    med = None
    if has_median:
        med = median.step(
            data, V, _median_view(state), k=k, first_turn=first_turn,
            cut_kernel=cut_kernel, extremes_kernel=extremes_kernel,
            trans_width=trans_width)
    mmo = mm.step(
        data, _maxmarg_view(state, k), k=k, max_support=max_support,
        steps=steps, stages=stages, lam0=lam0, trans_width=trans_width,
        warm=warm, per_node=per_node, fused_kernel=fused_kernel,
        solver_kernel=solver_kernel)

    # -- sampling hop substep (the oracle's Vitter chain, one hop a turn) ---
    hop_act = active & is_samp & (state.turn < k - 1)
    fit_act = active & is_samp & (state.turn >= k - 1)
    hop_t = state.turn.clamp(0, max(k - 2, 0))
    res_w = state.wx.shape[2] if trans_width is None else trans_width
    Xi = hotloop.gather_rows(data.X, hop_t)              # (B, n_max, d)
    yi = hotloop.gather_rows(data.y, hop_t)
    keyb = hotloop.gather_rows(state.hop_keys, hop_t)    # (B, 2)
    resX = state.wx[:, k - 1, :res_w]
    resy = state.wy[:, k - 1, :res_w]
    # only hop rows may write: a finished row's reservoir can be wider than
    # a later, narrower slice
    capb = torch.where(hop_act, state.res_cap, 0)
    rX, ry, sn = oneway._make_ingest(res_w)(
        resX, resy, state.seen, keyb, Xi, yi, capb)
    shipped = torch.minimum(sn, state.res_cap)
    wx_s = state.wx.clone()
    wx_s[:, k - 1, :res_w] = torch.where(hop_act[:, None, None], rX, resX)
    wy_s = state.wy.clone()
    wy_s[:, k - 1, :res_w] = torch.where(hop_act[:, None], ry, resy)
    w_fill_s = state.w_fill.clone()
    w_fill_s[:, k - 1] = torch.where(hop_act, shipped, state.w_fill[:, k - 1])
    # the oracle's per-hop message slot: the forwarded reservoir (possibly
    # empty — still one message), one round a hop; nothing at the fit turn
    hop_i = hop_act.to(_I32)
    comm_s = state.comm._replace(
        points=state.comm.points + torch.where(hop_act, shipped, 0),
        messages=state.comm.messages + hop_i,
        rounds=state.comm.rounds + hop_i)

    # -- per-row merge: each leaf from its owning family --------------------
    def pick(med_leaf, mm_leaf, samp_leaf):
        out = torch.where(_bc(is_mm, samp_leaf), mm_leaf, samp_leaf)
        if med is not None:
            out = torch.where(_bc(is_med, out), med_leaf, out)
        return out

    m_ = med if med is not None else mmo  # unread when has_median is False
    return UnifiedState(
        sel=state.sel,
        dir_ok=m_.dir_ok if med is not None else state.dir_ok,
        lo_w=m_.lo_w if med is not None else state.lo_w,
        hi_w=m_.hi_w if med is not None else state.hi_w,
        wx=pick(m_.wx, mmo.wx, wx_s),
        wy=pick(m_.wy, mmo.wy, wy_s),
        w_fill=pick(m_.w_fill, mmo.w_fill, w_fill_s),
        turn=state.turn + 1,
        done=pick(m_.done, mmo.done, state.done | fit_act),
        converged=pick(m_.converged, mmo.converged,
                       state.converged | fit_act),
        epochs=pick(m_.epochs, mmo.epochs,
                    torch.where(fit_act, k - 1, state.epochs)),
        h_w=(torch.where(is_med[:, None], m_.h_v, mmo.h_w)
             if med is not None else mmo.h_w),
        h_b=(torch.where(is_med, m_.h_t, mmo.h_b)
             if med is not None else mmo.h_b),
        h_valid=(torch.where(is_med, m_.h_valid, mmo.h_valid)
                 if med is not None else mmo.h_valid),
        warm_turn=mmo.warm_turn, c_w=mmo.c_w, c_b=mmo.c_b,
        c_valid=mmo.c_valid, warm_node=mmo.warm_node, latches=mmo.latches,
        seen=torch.where(hop_act, sn, state.seen),
        res_cap=state.res_cap,
        hop_keys=state.hop_keys,
        comm=type(state.comm)(*(pick(a, b, c) for a, b, c in
                                zip(m_.comm if med is not None else comm_s,
                                    mmo.comm, comm_s))),
    )


def _pad_fix(sub: UnifiedState, pad_row: torch.Tensor) -> UnifiedState:
    """Mark gathered pad rows inert: done=True masks them out of every
    substep's decisions, and trusting their (zero) carries keeps the warm
    polish gate from forcing solver work for padding.  Pad rows gather
    ``sel=0``, harmless under ``done``."""
    return sub._replace(done=sub.done | pad_row,
                        h_valid=sub.h_valid | pad_row,
                        c_valid=sub.c_valid | pad_row[:, None],
                        warm_node=sub.warm_node | pad_row[:, None])


def hot_turn(data: EngineData, V: torch.Tensor, state: UnifiedState,
             idx: torch.Tensor, n_act: int, **opts) -> UnifiedState:
    """One compacted mixed turn: gather the ``idx`` rows (the live prefix
    ``n_act``, the tail padding), pad-fix, ``step`` with ``opts``, scatter
    the live rows back in place (``hotloop.gathered_turn``); V passes
    through ungathered."""
    step_fn = functools.partial(step, **opts)
    return hotloop.gathered_turn(
        lambda sub_data, sub: step_fn(sub_data, V, sub),
        _pad_fix, data, state, idx, n_act)


def _host_view(state: UnifiedState, ci: int, *,
               per_node: bool = True) -> torch.Tensor:
    """The hot loop's per-turn host knowledge as one (3, B) i32 tensor:
    done flags, warm-latch flags (MAXMARG rows only — no other family has
    a warm carry), and the width-compaction fills: the per-row max across
    nodes, for SAMPLING rows at least ``res_cap``, so the compacted width
    always covers the reservoir slice."""
    k = state.w_fill.shape[1]
    track = per_node and k > 2
    wflag = state.warm_node[:, ci] if track else state.warm_turn
    wflag = wflag & (state.sel == SEL_MAXMARG)
    fills = state.w_fill.amax(dim=1)
    fills = torch.where(state.sel == SEL_SAMPLING,
                        torch.maximum(fills, state.res_cap), fills)
    return torch.stack([state.done.to(_I32), wflag.to(_I32), fills])


def run_hot(
    data: EngineData,
    V: torch.Tensor,
    state: UnifiedState,
    *,
    k: int,
    max_turns: int,
    max_support: int = 4,
    steps: int = 2000,
    stages: int = 3,
    lam0: float = 1e-3,
    warm: bool = True,
    per_node: bool = True,
    has_median: bool = True,
    compact: bool = True,
    cut_kernel: bool = False,
    extremes_kernel: bool = False,
    fused_kernel: bool = False,
    solver_kernel: Optional[bool] = None,
    width_policy: str = "geometric",
    stats: Optional[dict] = None,
) -> UnifiedState:
    """The mixed sweep as a host-driven turn loop over ``step`` on the
    shared :mod:`repro_torch.engine.hotloop` machinery.  One loop drives
    all three families: the width slack and the one-turn growth bound are
    the largest of the families' own, so every compacted read covers the
    fastest-growing transcript.  ``width_policy`` defaults to
    ``"geometric"`` here, as in the JAX package.  On the H100 neither
    policy ran ``chip_smoke.py`` phase 17a's mixed sweep faster (PERF.md);
    geometric buckets keep the distinct launch shapes to O(log cap), the
    count that CUDA graphs captured per ``hotloop.KEY_LOG`` key would
    pay for.  ``stats`` is threaded to ``hotloop.run_hot`` as in the JAX
    package; with no mesh on this path it records nothing."""
    cap = int(state.wx.shape[2])
    track = per_node and warm
    opts = dict(k=k, max_support=max_support, steps=steps, stages=stages,
                lam0=lam0, per_node=track, has_median=has_median,
                cut_kernel=cut_kernel, extremes_kernel=extremes_kernel,
                fused_kernel=fused_kernel, solver_kernel=solver_kernel)
    width_slack = median.WIDTH_SLACK if has_median else 0
    width_growth = max(2 * k + 2, max_support, mm.VIOL_SHIP * (k - 1))

    def host_view(s, ci):
        return _host_view(s, ci, per_node=track)

    def dispatch_full(d, s, *, t, width, use_warm):
        return step(d, V, s, first_turn=(t == 0), trans_width=width,
                    warm=use_warm, **opts)

    def dispatch_sub(d, s, idx, n_act, *, t, width, use_warm):
        return hot_turn(d, V, s, idx, n_act, first_turn=(t == 0),
                        trans_width=width, warm=use_warm, **opts)

    (final,) = hotloop.run_hot((data,), (state,), k=k, max_turns=max_turns,
                               cap=cap, host_view=host_view,
                               dispatch_full=dispatch_full,
                               dispatch_sub=dispatch_sub, warm=warm,
                               compact=compact, width_slack=width_slack,
                               width_growth=width_growth,
                               width_policy=width_policy, stats=stats)
    return final


def run_instances(
    instances: Sequence[ProtocolInstance],
    *,
    eps: Optional[float] = None,
    n_angles: int = 1024,
    max_epochs: int = 48,
    max_support: int = 4,
    steps: int = 2000,
    stages: int = 3,
    lam: float = 1e-3,
    warm: bool = True,
    per_node: bool = True,
    compact: bool = True,
    vc_dim: Optional[int] = None,
    c: Optional[float] = None,
    solver_kernel: Optional[bool] = None,
    width_policy: str = "geometric",
    stats: Optional[dict] = None,
    device="cuda",
):
    """Run a mixed MEDIAN + MAXMARG + SAMPLING grid as one dispatch path on
    ``device``, with no selector bucketing.

    Returns a :class:`~repro_torch.core.protocols.one_way.ProtocolResult`
    per instance in input order, shaped like the per-selector paths': a
    MEDIAN row recovers ``LinearSeparator(-h_v, h_t)`` from the shared
    separator, a MAXMARG row reports its warm latches, a SAMPLING row its
    ε-net ``sample_size`` with ``rounds = k-1`` and ``converged=True``.
    The scans, the turn scan and the solver run as the CUDA kernels on a
    CUDA device (flags resolved once here), their plain versions on the
    CPU.  ``stats`` (a dict) is the hot loop's observability hook, as in
    the JAX package; this path has no mesh, so it records nothing.

    Launch-shape contract: the state's shapes key on k, d, the padded
    shard size, ``n_angles`` (1 for a median-free mix) and the shared
    ``cap``; the per-turn shapes on the quantized ``(n_pad, width,
    use_warm)`` buckets ``hotloop.KEY_LOG`` records, never on the mix.
    """
    from repro_torch.core import classifiers as clf
    from repro_torch.core import geometry as geo
    from repro_torch.core.protocols.one_way import ProtocolResult

    dev = _device.resolve(device)
    if eps is not None:
        instances = [ProtocolInstance(inst.shards, eps, inst.selector,
                                      inst.seed) for inst in instances]
    on_card = dataplane.use_kernels_default(dev)
    solver_kernel = on_card if solver_kernel is None else solver_kernel
    data, state0, k, _cap = pack_instances_unified(
        instances, n_angles=n_angles, max_epochs=max_epochs,
        max_support=max_support, vc_dim=vc_dim, c=c, device=dev)
    d = int(data.X.shape[3])
    has_median = any(inst.selector == "median" for inst in instances)
    V = (geo.direction_grid(n_angles, device=dev) if has_median
         else torch.zeros((1, d), dtype=torch.float32, device=dev))
    final = run_hot(data, V, state0, k=k, max_turns=k * max_epochs,
                    max_support=max_support, steps=steps, stages=stages,
                    lam0=lam, warm=warm, per_node=per_node,
                    has_median=has_median, compact=compact,
                    cut_kernel=on_card, extremes_kernel=on_card,
                    fused_kernel=on_card, solver_kernel=solver_kernel,
                    width_policy=width_policy, stats=stats)

    converged = final.converged.cpu().numpy()
    epochs = final.epochs.cpu().numpy()
    h_w = final.h_w.cpu().double().numpy()
    h_b = final.h_b.cpu().double().numpy()
    latches = final.latches.cpu().numpy()
    res_cap = final.res_cap.cpu().numpy()
    comm_np = type(final.comm)(*(a.cpu().numpy() for a in final.comm))
    extra = {"engine": True, "batch": len(instances), "unified": True,
             "warm": warm, "compact": compact, "device": str(dev)}
    results: List[ProtocolResult] = []
    for b, inst in enumerate(instances):
        ex = dict(extra, selector=inst.selector)
        if inst.selector == "median":
            h = clf.LinearSeparator(-h_w[b], float(h_b[b]))
            rounds = int(epochs[b]) if converged[b] else max_epochs
            conv = bool(converged[b])
        elif inst.selector == "maxmarg":
            h = clf.LinearSeparator(h_w[b], float(h_b[b]))
            rounds = int(epochs[b]) if converged[b] else max_epochs
            conv = bool(converged[b])
            ex["warm_latches"] = int(latches[b])
        else:
            h = clf.LinearSeparator(h_w[b], float(h_b[b]))
            rounds = k - 1
            conv = True
            ex["sample_size"] = int(res_cap[b])
        results.append(ProtocolResult(
            h, comm_np.summary(b, dim=d), rounds=rounds, converged=conv,
            extra=ex))
    return results
