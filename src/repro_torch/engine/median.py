"""One MEDIAN/k-party turn as ``step(data, V, state) -> state`` on tensors
(counterpart of ``repro.engine.median``).

The certified-pivot epoch protocol (paper §5/§6.2, DESIGN.md), batched over
B independent instances advanced in lock-step; finished instances are
masked no-ops.  Turn structure (coordinator ``ci = turn % k``, per
instance):

1. the coordinator's consistent-threshold ranges (lo, hi), maintained at
   append time;
2. the weighted-median cut scan over its own shard picks direction v
   (``kernels.median_cut``);
3. it broadcasts its ≤2 band points S and (v, lo_c, hi_c); S lands in
   every transcript;
4. ε-early-exit on the coordinator band midpoint;
5. every node's extreme band points along v over own ∪ transcript
   (``kernels.support_margin``); non-coordinators ship theirs;
6. a non-empty global band terminates at its midpoint; an empty one
   broadcasts the violating pair and prunes the direction arc.

Rounding follows the JAX engine's inline path, its CPU default: every
projection is ``(v0*x0) + (v1*x1)`` with one rounding per operation, in the
plain versions and in both CUDA kernels, so band edges built at append time
compare with the same point's projection exactly as in the reference.

``run_hot`` (the ``run_instances`` default) drives ``step`` from the host on
:mod:`repro_torch.engine.hotloop`, capping every transcript read at the live
fill and dropping finished instances; ``run_compiled`` is the cold model, a
plain turn loop at full capacity.  Both are bit-exact against each other.
Each call runs eagerly: there is no ``jit``.  ``step`` is functional (it
copies the transcript leaves once and appends into the copy) unless its
state is donated (``donate=True``: the turn lands in the state's own
tensors).  The hot path runs over a tuple of per-shard records, one on
one device; with a ``mesh`` it runs sharded over the instance axis, each
shard's slice on its own device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from repro_torch import _device
from repro_torch.core.geometry import project, project_each
from repro_torch.engine import dataplane, hotloop
from repro_torch.engine.state import (
    BatchCommLog,
    EngineData,
    ProtocolInstance,
    ProtocolState,
    as_shards,
    pack_instances,
    unshard,
)
from repro_torch.kernels.median_cut import median_cut_scores_plain
from repro_torch.kernels.support_margin import (
    median_extremes_segments_plain,
)

_INF = math.inf
_I32 = torch.int32

# MEDIAN's per-turn append bound on any single transcript *before* the
# stage-5 extremes read: the broadcast S block (≤ 2 rows).
WIDTH_SLACK = 2


_gather_rows = hotloop.gather_rows           # (B, N, ...) × (B,) -> (B, ...)


def _append2(wx, wy, fill, lo_j, hi_j, pts, labs, do, V) -> None:
    """Append a ≤2-row block to each instance's transcript at its fill, in
    place on one node's views: ``wx`` (B, cap, d), ``wy`` (B, cap), ``fill``
    (B,), ``lo_j``/``hi_j`` (B, m).

    ``pts`` (B, 2, d), ``labs`` (B, 2) with label 0 marking invalid rows
    (valid rows first), ``do`` (B,) gating the append.  Writes land at
    ≥ fill, so masked-out appends only touch label-0 scratch rows.  The
    node's threshold ranges are running max/mins, updated here.  The JAX
    package's ``dynamic_update_slice`` would clamp a write past the
    capacity; here the capacity is asserted instead.
    """
    labs = torch.where(do[:, None], labs, 0).to(_I32)
    nvalid = (labs != 0).sum(dim=1, dtype=_I32)

    pv = project(V, pts).transpose(1, 2)                # (B, 2, m)
    lo_j.copy_(torch.maximum(lo_j, pv.masked_fill(
        ~(labs == 1)[:, :, None], -_INF).amax(dim=1)))
    hi_j.copy_(torch.minimum(hi_j, pv.masked_fill(
        ~(labs == -1)[:, :, None], _INF).amin(dim=1)))

    torch._assert_async((fill <= wx.shape[1] - 2).all(),
                        "transcript append past its capacity")
    rows = torch.arange(wx.shape[0], device=wx.device)[:, None]
    at = fill.long()[:, None] + torch.arange(2, device=wx.device)[None, :]
    wx[rows, at] = pts.to(wx.dtype)
    wy[rows, at] = labs
    fill += nvalid


def node_extremes(data: EngineData, wx, wy, v, trans_width, kernel):
    """Stage 5: every node's extreme band points along ``v`` over its own
    rows and its transcript ``wx``, ``wy`` (B, k, cap, ...) read up to
    ``trans_width``, each segment read where it lies.  Returns ``(p_k, q_k,
    has_pk, has_qk, lo_k, hi_k)``: the first-index argmax row over +1 rows
    and argmin row over -1 rows (B, k, d) (row 0 where the class is
    absent), whether each class is present (B, k), and the band edges
    (B, k), -inf / +inf where absent."""
    width = wx.shape[2] if trans_width is None else trans_width
    extremes = (dataplane.median_extremes_segments if kernel
                else median_extremes_segments_plain)
    e = extremes(v, data.X, data.y, wx, wy, width)
    return e.p, e.q, e.has_p, e.has_q, e.lo, e.hi


def step(
    data: EngineData,
    V: torch.Tensor,
    state: ProtocolState,
    *,
    k: int,
    first_turn: bool = False,
    cut_kernel: bool = False,
    extremes_kernel: bool = False,
    trans_width: Optional[int] = None,
    donate: bool = False,
) -> ProtocolState:
    """Advance every active instance by one protocol turn.

    ``trans_width`` caps every per-turn transcript *read* (the coordinator
    band scan and the stage-5 extremes scan) at the first ``trans_width``
    rows; appends still write the full-capacity buffers.  Sound whenever it
    covers every active instance's live fill plus ``WIDTH_SLACK``; rows past
    the fill are label-0 mask identities, so the cap is bit-exact.

    ``first_turn=True`` constant-folds the cut scan: on the fresh state every
    cut scores 0 and the first-max pick is index 0.

    ``cut_kernel``/``extremes_kernel`` route the two scans through
    :mod:`repro_torch.engine.dataplane` — the CUDA kernels for tensors on
    the card, their plain versions on the CPU; off, the plain versions run
    on whatever device the state lives on.  All four give identical
    integers, so the flag never changes a result.

    ``donate=True`` writes the turn into ``state``'s own tensors (the
    appends land in its transcript buffers, every other leaf is copied in)
    and returns ``state``; the default leaves ``state`` untouched.
    """
    B, m = state.dir_ok.shape
    dev = state.dir_ok.device
    rows = torch.arange(B, device=dev)
    ci = state.turn % k                                  # (B,) per-instance
    active = ~state.done
    comm = state.comm
    km1 = k - 1

    # -- 1. coordinator's consistent-threshold ranges over its transcript ---
    Wxc = _gather_rows(state.wx, ci)                     # (B, cap, d)
    Wyc = _gather_rows(state.wy, ci)                     # (B, cap)
    if trans_width is not None:                          # fill-capped read
        Wxc = Wxc[:, :trans_width]
        Wyc = Wyc[:, :trans_width]
    lo = _gather_rows(state.lo_w, ci)                    # (B, m)
    hi = _gather_rows(state.hi_w, ci)

    # -- 2. full-scan weighted-median direction ------------------------------
    Xc = _gather_rows(data.X, ci)                        # (B, n, d)
    yc = _gather_rows(data.y, ci)                        # (B, n)
    if first_turn:
        v_idx = torch.zeros(B, dtype=torch.long, device=dev)
    else:
        cut = dataplane.median_cut if cut_kernel else median_cut_scores_plain
        score = cut(V, state.dir_ok, lo, hi, Xc, yc)
        v_idx = score.argmax(dim=1)                      # (B,) first max
    v = V[v_idx]                                         # (B, d)

    # -- 3. coordinator band + support points S -----------------------------
    XWc = torch.cat([Xc, Wxc], dim=1)                    # (B, n+cap, d)
    yWc = torch.cat([yc, Wyc], dim=1)
    pjc = project_each(XWc, v)
    posm = yWc == 1
    negm = yWc == -1
    has_p = posm.any(dim=1)
    has_q = negm.any(dim=1)
    pj_pos = pjc.masked_fill(~posm, -_INF)
    pj_neg = pjc.masked_fill(~negm, _INF)
    lo_c = torch.where(has_p, pj_pos.amax(dim=1), -_INF)
    hi_c = torch.where(has_q, pj_neg.amin(dim=1), _INF)
    p_pt = XWc[rows, pj_pos.argmax(dim=1)]
    q_pt = XWc[rows, pj_neg.argmin(dim=1)]
    nS = has_p.to(_I32) + has_q.to(_I32)
    # compacted 2-row block: positive extreme first when present
    S_pts = torch.stack([torch.where(has_p[:, None], p_pt, q_pt), q_pt], 1)
    S_lab = torch.stack([torch.where(has_p, 1, torch.where(has_q, -1, 0)),
                         torch.where(has_p & has_q, -1, 0)], 1).to(_I32)

    # comm: S broadcast + direction scalars (v, lo_c, hi_c) to k-1 peers
    act_i = active.to(_I32)
    comm = comm._replace(
        points=comm.points + act_i * nS * km1,
        scalars=comm.scalars + act_i * (4 * km1),
        messages=comm.messages + act_i * (2 * km1),
        rounds=comm.rounds + act_i,
    )

    # S lands in every transcript (the coordinator's own sent-ledger
    # included); the appends write into one copy of the transcript leaves,
    # or into the state's own when it is donated
    wx, wy, w_fill, lo_w, hi_w = ((a if donate else a.clone()) for a in (
        state.wx, state.wy, state.w_fill, state.lo_w, state.hi_w))

    def append_node(j, pts, labs, do):
        _append2(wx[:, j], wy[:, j], w_fill[:, j], lo_w[:, j], hi_w[:, j],
                 pts, labs, do, V)

    for j in range(k):
        append_node(j, S_pts, S_lab, active)

    # -- 4. ε-early-exit on the coordinator band midpoint -------------------
    band_c = torch.isfinite(lo_c) & torch.isfinite(hi_c) & (lo_c < hi_c)
    t_c = 0.5 * (lo_c + hi_c)
    pja = project_each(data.X, v)                        # (B, k, n)
    pred = torch.where(pja < t_c[:, None, None], 1, -1)  # +1 iff v·x < t
    errs = ((pred != data.y) & (data.y != 0)).sum(dim=(1, 2), dtype=_I32)
    term_eps = active & band_c & (errs <= data.budget)
    fire_err = (active & band_c).to(_I32)                # error-report msgs
    comm = comm._replace(scalars=comm.scalars + fire_err * km1,
                         messages=comm.messages + fire_err * km1)

    # -- 5. per-node extremes along v (post-S transcripts, fill-capped) -----
    p_k, q_k, has_pk, has_qk, lo_k, hi_k = node_extremes(
        data, wx, wy, v, trans_width, extremes_kernel)
    lo_g = lo_k.amax(dim=1)
    hi_g = hi_k.amin(dim=1)
    best_p = p_k[rows, lo_k.argmax(dim=1)]               # first max node
    best_q = q_k[rows, hi_k.argmin(dim=1)]

    node_ids = torch.arange(k, device=dev)[None, :]
    n_pts_k = has_pk.to(_I32) + has_qk.to(_I32)
    live = active & ~term_eps
    reply = (live[:, None] & (node_ids != ci[:, None]) & (n_pts_k > 0))
    comm = comm._replace(
        points=comm.points + (reply * n_pts_k).sum(dim=1, dtype=_I32),
        messages=comm.messages + reply.sum(dim=1, dtype=_I32),
    )
    # node i's reply lands in its own sent-ledger and the coordinator's recv
    for i in range(k):
        E_pts = torch.stack([torch.where(has_pk[:, i, None], p_k[:, i],
                                         q_k[:, i]), q_k[:, i]], 1)
        E_lab = torch.stack(
            [torch.where(has_pk[:, i], 1, torch.where(has_qk[:, i], -1, 0)),
             torch.where(has_pk[:, i] & has_qk[:, i], -1, 0)], 1).to(_I32)
        src_active = live & (ci != i)
        for j in range(k):
            append_node(j, E_pts, E_lab, src_active & ((ci == j) | (j == i)))

    # -- 6. non-empty global band: terminate; empty: certified pivot --------
    band_g = lo_g < hi_g
    lo_g2 = torch.where(torch.isfinite(lo_g), lo_g, hi_g - 2.0)
    hi_g2 = torch.where(torch.isfinite(hi_g), hi_g, lo_g2 + 2.0)
    t_star = 0.5 * (lo_g2 + hi_g2)
    fire_band = live & band_g
    comm = comm._replace(
        bits=comm.bits + fire_band.to(_I32) * km1,
        messages=comm.messages + fire_band.to(_I32) * km1,
    )

    fire_pivot = live & ~band_g
    diff = best_q - best_p
    constraint = project(V, diff[:, None, :])[..., 0]    # (B, m)
    new_ok = state.dir_ok & (constraint > 1e-12)
    # the empty band certifies v itself is inconsistent; prune it explicitly
    # so f32 rounding of v·(q*-p*) ≈ 0 can never keep re-proposing v
    new_ok = new_ok & (torch.arange(m, device=dev)[None, :]
                       != v_idx[:, None])
    apply_prune = (fire_pivot & new_ok.any(dim=1))[:, None]
    dir_ok = torch.where(apply_prune, new_ok, state.dir_ok)
    comm = comm._replace(
        points=comm.points + fire_pivot.to(_I32) * (2 * km1),
        messages=comm.messages + fire_pivot.to(_I32) * km1,
    )
    P_pts = torch.stack([best_p, best_q], dim=1)
    P_lab = (fire_pivot[:, None].to(_I32)
             * torch.tensor([1, -1], dtype=_I32, device=dev)[None, :])
    for j in range(k):
        append_node(j, P_pts, P_lab, fire_pivot)

    # -- hypothesis bookkeeping (precedence: band > ε-exit cand > fallback) -
    set_cand = active & band_c
    t_fb = torch.where(torch.isfinite(lo_c) & torch.isfinite(hi_c), t_c, 0.0)
    set_fb = fire_pivot & ~state.h_valid & ~set_cand
    any_set = set_cand | fire_band | set_fb
    h_v = torch.where(any_set[:, None], v, state.h_v)
    h_t = torch.where(fire_band, t_star,
                      torch.where(set_cand, t_c,
                                  torch.where(set_fb, t_fb, state.h_t)))
    h_valid = state.h_valid | any_set

    newly = term_eps | fire_band
    new = ProtocolState(
        dir_ok=dir_ok,
        wx=wx, wy=wy, w_fill=w_fill, lo_w=lo_w, hi_w=hi_w,
        turn=state.turn + 1,
        done=state.done | newly,
        converged=state.converged | newly,
        epochs=torch.where(newly, state.turn // k + 1, state.epochs),
        h_v=h_v, h_t=h_t, h_valid=h_valid,
        comm=comm,
    )
    return hotloop.write_into(state, new) if donate else new


def run_compiled(
    data: EngineData,
    V: torch.Tensor,
    state0: ProtocolState,
    *,
    k: int,
    max_turns: int,
    cut_kernel: bool = False,
    extremes_kernel: bool = False,
) -> ProtocolState:
    """The cold execution model: the constant-folded first turn, then
    ``step`` at the full static capacity until every instance terminates or
    the turn budget is spent — the hot path's differential reference
    (``run_instances(compact=False)``).  The name is the JAX package's; the
    port runs it as a plain Python turn loop."""
    opts = dict(k=k, cut_kernel=cut_kernel, extremes_kernel=extremes_kernel)
    s = step(data, V, state0, first_turn=True, **opts)
    while bool((s.turn.min() < max_turns) & ~s.done.all()):
        s = step(data, V, s, **opts)
    return s


def _pad_fix(sub: ProtocolState, pad_row: torch.Tensor) -> ProtocolState:
    """Mark gathered pad rows inert: done=True masks them out of every
    decision, comm update and append, and the scatter drops them anyway."""
    return sub._replace(done=sub.done | pad_row)


def _host_view(state: ProtocolState, ci) -> torch.Tensor:
    """The hot loop's per-turn host knowledge as one (3, B) i32 tensor:
    done flags, a zero warm row (MEDIAN has no warm carry), and the max
    transcript fill across nodes — stage 5 scans every node's transcript."""
    return torch.stack([state.done.to(_I32),
                        torch.zeros_like(state.done, dtype=_I32),
                        state.w_fill.amax(dim=1)])


def run_hot(
    data: EngineData,
    V: torch.Tensor,
    state: ProtocolState,
    *,
    k: int,
    max_turns: int,
    cut_kernel: bool = False,
    extremes_kernel: bool = False,
    compact: bool = True,
    mesh=None,
    donate: bool = False,
    overlap: Optional[bool] = None,
    stats: Optional[dict] = None,
) -> ProtocolState:
    """The MEDIAN sweep as a host-driven turn loop over ``step`` on the
    shared :mod:`repro_torch.engine.hotloop` machinery: per-turn band and
    extremes scans at ``round_up(max live fill + WIDTH_SLACK, 8)`` rows,
    finished instances dropped from the dispatch.  Both compactions are
    bit-exact against ``run_compiled``.  ``overlap=True`` double-buffers
    the loop (``2k+2`` rows cover one turn's worst fill growth: the S
    block, ≤2 reply rows from each of k-1 peers, and the pivot pair).
    ``donate=True`` writes every turn into the given state's tensors
    instead of a copy of them.

    ``mesh`` (a 1-D ("data",) mesh, ``launch.mesh.make_data_mesh``) runs
    the sweep sharded over the leading B axis: ``data`` and ``state`` are
    split over it (``pack_instances(..., mesh=...)`` gives them split and
    B padded with born-done dummies; a whole record must have B a multiple
    of the axis size), each shard's turn runs on its own device, and
    sub-batch turns come shard-balanced from ``hotloop.balanced_index``.
    A shard runs the unchanged ``step`` on its own slice: MEDIAN decisions
    are per-instance, so no shard reads another's rows.  On the mesh
    ``overlap`` defaults on (off otherwise); ``donate`` stays off, as it
    did not make a sweep faster on the H100 (PERF.md).  It requires
    ``compact=True`` and returns the per-shard records.  ``stats`` collects
    the shard skew (``hotloop.run_hot``).  Every setting is bit-exact:
    MEDIAN is per-instance and any covering width is exact.
    """
    overlap = mesh is not None if overlap is None else overlap
    opts = dict(k=k, cut_kernel=cut_kernel, extremes_kernel=extremes_kernel,
                donate=donate)
    if mesh is None:
        shards = ((data,), (state,))
    elif not compact:
        raise ValueError("sharded sweeps require the compacted hot path")
    else:
        shards = (as_shards(data, mesh), as_shards(state, mesh))
    Vs = {}     # one copy of the direction grid a device
    for d in shards[0]:
        Vs.setdefault(d.X.device, V.to(d.X.device))

    # MEDIAN has no warm carry: run_hot(warm=False) passes use_warm=False
    def dispatch_full(d, s, *, t, width, use_warm):
        return step(d, Vs[d.X.device], s, first_turn=(t == 0),
                    trans_width=width, **opts)

    def dispatch_sub(d, s, idx, n_act, *, t, width, use_warm):
        v = Vs[d.X.device]
        return hotloop.gathered_turn(
            lambda sub_data, sub: step(sub_data, v, sub, first_turn=(t == 0),
                                       trans_width=width, **opts),
            _pad_fix, d, s, idx, n_act)

    final = hotloop.run_hot(*shards, k=k, max_turns=max_turns,
                            cap=int(shards[1][0].wx.shape[2]),
                            host_view=_host_view,
                            dispatch_full=dispatch_full,
                            dispatch_sub=dispatch_sub,
                            compact=compact, width_slack=WIDTH_SLACK,
                            width_growth=2 * k + 2, overlap=overlap,
                            stats=stats, donate=donate)
    return final if mesh is not None else final[0]


def run_instances(
    instances: Sequence[ProtocolInstance],
    *,
    eps: Optional[float] = None,
    n_angles: int = 1024,
    max_epochs: int = 48,
    cut_kernel: Optional[bool] = None,
    extremes_kernel: Optional[bool] = None,
    compact: bool = True,
    mesh=None,
    donate: bool = False,
    overlap: Optional[bool] = None,
    stats: Optional[dict] = None,
    device="cuda",
):
    """Run a batch of MEDIAN/k-party instances as one sweep on ``device``.

    Returns a list of :class:`~repro_torch.core.protocols.one_way.ProtocolResult`,
    one per instance, shaped exactly like the JAX package's.

    ``compact=True`` (the default) runs the host-driven hot path; ``False``
    the cold ``run_compiled``.  ``cut_kernel``/``extremes_kernel`` route the
    per-turn scans through the CUDA kernels (default: on for a CUDA device,
    off on the CPU).  ``mesh`` shards the hot path over a 1-D ("data",)
    device mesh, whose devices take the place of ``device`` (requires
    ``compact=True``; the kernel defaults follow the mesh's first device);
    ``donate``/``overlap`` opt the per-turn dispatches into writing in
    place and the double-buffered host loop (mesh default: ``overlap``
    on).
    ``stats`` (a dict) collects host-side observability — on sharded
    sweeps the per-dispatch shard skew (``hotloop.shard_skew``) — and is
    never read for decisions.

    Launch-shape contract: ``n_angles``, ``max_epochs``, ``k`` and ``d``
    fix the state's shapes; the hot path's per-turn shapes take only the
    quantized ``(n_pad, width)`` buckets that ``hotloop.KEY_LOG`` records.
    """
    from repro_torch.core import classifiers as clf
    from repro_torch.core import geometry as geo
    from repro_torch.core.protocols.one_way import ProtocolResult

    if mesh is not None and not compact:
        raise ValueError("sharded sweeps require the compacted hot path")
    dev = _device.resolve(device if mesh is None else mesh.devices[0])
    if eps is not None:
        instances = [ProtocolInstance(inst.shards, eps) for inst in instances]
    on_card = dataplane.use_kernels_default(dev)
    cut_kernel = on_card if cut_kernel is None else cut_kernel
    extremes_kernel = on_card if extremes_kernel is None else extremes_kernel
    data, state0, k, _cap = pack_instances(
        instances, n_angles=n_angles, max_epochs=max_epochs, mesh=mesh,
        device=dev)
    V = geo.direction_grid(n_angles, device=dev)
    opts = dict(k=k, max_turns=k * max_epochs, cut_kernel=cut_kernel,
                extremes_kernel=extremes_kernel)
    if compact:
        final = run_hot(data, V, state0, mesh=mesh, donate=donate,
                        overlap=overlap, stats=stats, **opts)
    else:
        final = run_compiled(data, V, state0, **opts)
    if mesh is not None:
        final = unshard(final)

    converged = final.converged.cpu().numpy()
    epochs = final.epochs.cpu().numpy()
    h_v = final.h_v.cpu().double().numpy()
    h_t = final.h_t.cpu().double().numpy()
    # one host transfer per counter array, not one per instance×field
    comm_np = BatchCommLog(*(a.cpu().numpy() for a in final.comm))
    extra = {"engine": True, "batch": len(instances),
             "selector": "median", "compact": compact, "device": str(dev)}
    if mesh is not None:
        extra["devices"] = int(mesh.shape["data"])
    results: List[ProtocolResult] = []
    for b in range(len(instances)):
        h = clf.LinearSeparator(-h_v[b], float(h_t[b]))
        results.append(ProtocolResult(
            h,
            comm_np.summary(b, dim=2),
            rounds=int(epochs[b]) if converged[b] else max_epochs,
            converged=bool(converged[b]),
            extra=dict(extra),
        ))
    return results
