"""One MAXMARG k-party turn as ``step(data, state) -> state`` on tensors
(counterpart of ``repro.engine.maxmarg``).

The per-round SVM-refit protocol (paper §4.4 two-way MAXMARG and its §7
k-party form), batched over B independent instances advanced in lock-step;
finished instances are masked no-ops.  Turn structure (coordinator
``ci = turn % k``, per instance):

1. the coordinator fits a max-margin separator on own shard ∪ received
   transcript (the B-batched annealed Pegasos solver,
   :func:`repro_torch.core.classifiers._svm_solve_batch`, whose λ stages
   run as the ``pegasos_stage`` kernel on the card);
2. the active-margin support points (margin within (1+rtol) of the
   minimum, the ``max_support`` smallest by (margin, index)) go to the k-1
   others [k-1 point messages] and land in their transcripts;
3. every node counts the proposal's errors on its own shard;
   non-coordinators report an all-clear bit [k-1 bit messages];
4. every violated non-coordinator ships its 2 most-violated points to the
   coordinator [≤2-point messages];
5. the instance terminates when the global error count is within its ε
   budget.

Steps 2–4 read one fused scan of the proposal, ``maxmarg_turn_scan`` (the
CUDA kernel on the card, its plain version on the CPU or with
``fused_kernel=False``); both return the same integers.

``run_hot`` (the ``run_instances`` default) drives ``step`` from the host on
:mod:`repro_torch.engine.hotloop`: warm refits polish a carried separator
(per node by default: the latest proposal each node verified clean on
everything it knows), the coordinator's transcript read is capped at the
live fill, and finished instances drop out of the dispatch.
``run_compiled`` is the cold model, a plain turn loop at full capacity.
Every protocol decision is the same on both; the separators are two float
approximations of the same transcript-determined optimum.  Each call runs
eagerly; ``step`` is functional (it copies the transcript leaves once and
appends into the copy) unless its state is donated.  The hot path runs over
a tuple of per-shard records, one on one device; with a ``mesh`` it runs
sharded over the instance axis, each shard's slice on its own device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch import _device
from repro_torch.core.classifiers import _svm_solve_batch
from repro_torch.core.geometry import decide
from repro_torch.engine import dataplane, hotloop
from repro_torch.engine.state import (
    EngineData,
    MaxMargState,
    ProtocolInstance,
    as_shards,
    pack_instances_maxmarg,
    unshard,
)
from repro_torch.kernels.support_margin import maxmarg_turn_scan_plain

RTOL = 0.15          # active-margin band width, = classifiers.support_points
VIOL_SHIP = 2        # most-violated points shipped per violated node

_I32 = torch.int32
_gather_rows = hotloop.gather_rows       # (B, N, ...) × (B,) -> (B, ...)


def _append_block(wx, wy, fill, pts, labs, do, node):
    """Append an r-row block to each instance's transcript at its fill, in
    place: ``wx`` (B, k, cap, d), ``wy`` (B, k, cap), ``fill`` (B, k) and
    the node index ``node`` — an int, or a (B,) tensor of per-instance
    nodes (the coordinator).

    ``pts`` (B, r, d), ``labs`` (B, r) with label 0 marking invalid rows
    (valid rows first), ``do`` (B,) gating the append.  Writes land at
    ≥ fill, so masked appends only touch label-0 scratch rows.  The JAX
    package's ``dynamic_update_slice`` would clamp a write past the
    capacity; the transcript capacity's slack keeps every write inside,
    and that is asserted here.
    """
    B, r = labs.shape
    labs = torch.where(do[:, None], labs, 0).to(_I32)
    nvalid = (labs != 0).sum(dim=1, dtype=_I32)
    rows = torch.arange(B, device=wx.device)
    nodes = node if torch.is_tensor(node) else torch.full_like(rows, node)
    f = fill[rows, nodes]
    torch._assert_async((f <= wx.shape[2] - r).all(),
                        "transcript append past its capacity")
    at = f.long()[:, None] + torch.arange(r, device=wx.device)[None, :]
    wx[rows[:, None], nodes[:, None], at] = pts.to(wx.dtype)
    wy[rows[:, None], nodes[:, None], at] = labs
    fill[rows, nodes] = f + nvalid


def _compact_rows(X, y, sel, nsel, r, order=None):
    """Gather the selected rows (≤ r per instance) into a compacted
    (B, r, d) block with label-0 tail slots, in ascending ``order`` (unique
    per-row integer keys < N; default the row index — the order the host
    ships support points in).  Violation replies pass the margin rank."""
    N = X.shape[1]
    if order is None:
        order = torch.arange(N, device=X.device)[None, :].expand(sel.shape)
    idx_key = torch.where(sel, order, N)
    cidx = torch.argsort(idx_key, dim=1, stable=True)[:, :r]      # (B, r)
    pts = torch.gather(X, 1, cidx[..., None].expand(-1, -1, X.shape[2]))
    labs = torch.where(torch.arange(r, device=X.device)[None, :]
                       < nsel[:, None], torch.gather(y, 1, cidx), 0)
    return pts, labs.to(_I32)


def step(
    data: EngineData,
    state: MaxMargState,
    *,
    k: int,
    max_support: int = 4,
    steps: int = 2000,
    stages: int = 3,
    lam0: float = 1e-3,
    trans_width: Optional[int] = None,
    warm: bool = False,
    per_node: bool = True,
    fused_kernel: bool = False,
    solver_kernel: Optional[bool] = None,
    donate: bool = False,
) -> MaxMargState:
    """Advance every active instance by one MAXMARG turn.

    ``trans_width`` caps the coordinator's transcript read at its first
    ``trans_width`` rows — sound whenever it covers every active instance's
    live fill.  ``warm`` polishes a carried separator before the anneal:
    the last proposal the coordinator verified clean when ``per_node`` (and
    k > 2), else the previous turn's proposal.  ``fused_kernel`` routes the
    post-refit scan through :func:`repro_torch.engine.dataplane
    .maxmarg_turn_scan` (the CUDA kernel for tensors on the card, its plain
    version on the CPU) instead of the plain version; both give the same
    integers.  ``solver_kernel`` picks the refit's inner loop, as
    ``_svm_solve_batch``'s ``kernel`` (None: the kernel path on the card).
    ``donate=True`` writes the turn into ``state``'s own tensors (the
    appends land in its transcript buffers, every other leaf is copied in)
    and returns ``state``; the default leaves ``state`` untouched.
    """
    B = state.done.shape[0]
    dev = state.done.device
    d = data.X.shape[3]
    ci = state.turn % k                                # (B,) per-instance
    active = ~state.done
    comm = state.comm

    # -- 1. batched max-margin refit on coord's own ∪ transcript ------------
    Xc = _gather_rows(data.X, ci)                      # (B, n_max, d)
    yc = _gather_rows(data.y, ci)                      # (B, n_max)
    Wxc = _gather_rows(state.wx, ci)                   # (B, cap, d)
    Wyc = _gather_rows(state.wy, ci)                   # (B, cap)
    if trans_width is not None:                        # fill-capped read
        Wxc = Wxc[:, :trans_width]
        Wyc = Wyc[:, :trans_width]
    if Wxc.shape[1]:
        K = torch.cat([Xc, Wxc], dim=1)                # (B, N, d)
        yK = torch.cat([yc, Wyc], dim=1)               # (B, N) i32
    else:                                              # empty transcripts
        K, yK = Xc, yc
    yKf = yK.to(K.dtype)
    if warm:
        if per_node and k > 2:
            # the per-node carry the coordinator verified clean; at k=2 the
            # carry bookkeeping is skipped (see below), so warm falls back
            # to the single previous-turn carry there
            w0 = _gather_rows(state.c_w, ci)
            b0 = _gather_rows(state.c_b, ci)
            wok = _gather_rows(state.c_valid, ci) \
                & _gather_rows(state.warm_node, ci)
        else:
            w0, b0, wok = state.h_w, state.h_b, state.h_valid
        # clean0 is the solver's own polish gate: observability only
        w, b, fit_ok, clean0 = _svm_solve_batch(
            K, yKf, lam0, steps, stages, w0=w0, b0=b0, warm_ok=wok,
            return_gate=True, kernel=solver_kernel)
    else:
        w, b, fit_ok = _svm_solve_batch(K, yKf, lam0, steps, stages,
                                        kernel=solver_kernel)
        clean0 = torch.zeros_like(state.done)

    # -- 2-4 scans: one fused pass over the proposal --------------------------
    scan = (dataplane.maxmarg_turn_scan if fused_kernel
            else maxmarg_turn_scan_plain)
    sup_rank, err_k, viol_rank = scan(
        w, b, K, yK, data.X, data.y, rtol=RTOL, max_support=max_support,
        viol_ship=VIOL_SHIP)

    # -- 2. active-margin support points --------------------------------------
    sel = sup_rank < max_support
    nsel = sel.sum(dim=1, dtype=_I32)
    S_pts, S_lab = _compact_rows(K, yK, sel, nsel, max_support)

    # comm: support broadcast to the k-1 others
    act_i = active.to(_I32)
    comm = comm._replace(
        points=comm.points + act_i * nsel * (k - 1),
        messages=comm.messages + act_i * (k - 1),
        rounds=comm.rounds + act_i,
    )

    track = per_node and k > 2
    if track:
        # the carry bookkeeping's scan of every node's pre-append transcript
        Wx_all = state.wx if trans_width is None \
            else state.wx[:, :, :trans_width]
        Wy_all = state.wy if trans_width is None \
            else state.wy[:, :, :trans_width]
        mT = Wy_all.to(K.dtype) * decide(Wx_all, w, b)   # (B, k, W)
        trans_clean = ((Wy_all == 0) | (mT > 0.0)).all(dim=2)

    # the appends write into one copy of the transcript leaves, or into the
    # state's own when it is donated
    wx, wy, w_fill = ((a if donate else a.clone())
                      for a in (state.wx, state.wy, state.w_fill))
    for j in range(k):
        _append_block(wx, wy, w_fill, S_pts, S_lab, active & (ci != j),
                      node=j)

    # -- 3. per-node error counts + all-clear bits --------------------------
    errs = err_k.sum(dim=1, dtype=_I32)
    comm = comm._replace(
        bits=comm.bits + act_i * (k - 1),
        messages=comm.messages + act_i * (k - 1),
    )

    # -- 4. violated nodes ship their 2 most-violated points ----------------
    n_valid_k = (data.y != 0).sum(dim=2, dtype=_I32)
    node_ids = torch.arange(k, device=dev)[None, :]
    fire = active[:, None] & (node_ids != ci[:, None]) & (err_k > 0)
    nv = torch.clamp(n_valid_k, max=VIOL_SHIP)                    # (B, k)
    comm = comm._replace(
        points=comm.points + torch.where(fire, nv, 0).sum(dim=1, dtype=_I32),
        messages=comm.messages + fire.sum(dim=1, dtype=_I32),
    )
    # every reply lands in the coordinator's transcript (per-instance ci)
    for i in range(k):
        rank_i = viol_rank[:, i]
        V_pts, V_lab = _compact_rows(data.X[:, i], data.y[:, i],
                                     rank_i < VIOL_SHIP, nv[:, i], VIOL_SHIP,
                                     order=rank_i)
        _append_block(wx, wy, w_fill, V_pts, V_lab, fire[:, i], node=ci)

    # -- 5. ε-termination + hypothesis/warm-carry bookkeeping ---------------
    term = active & (errs <= data.budget)
    # single-carry latch precondition: does this proposal already classify
    # the next coordinator's shard cleanly?
    err_next = _gather_rows(err_k, (ci + 1) % k)

    # per-node carries (k > 2 only; at k=2 adoption implies termination):
    # a node adopts this proposal as its carry when it verifies it clean on
    # its own shard (err_k == 0) and on every row of its current
    # transcript; the flags then degrade incrementally — the S block is
    # clean under an adopted carry (its own support set), checked row-wise
    # under a kept one, and any violation reply dirties the coordinator's
    if track:
        is_ci = node_ids == ci[:, None]                  # (B, k)
        viol_any = fire.any(dim=1)                       # (B,)
        adopt = active[:, None] & fit_ok[:, None] & (err_k == 0) \
            & trans_clean
        c_w = torch.where(adopt[..., None], w[:, None, :], state.c_w)
        c_b = torch.where(adopt, b[:, None], state.c_b)
        S = S_pts.to(K.dtype)
        decS = S[:, None, :, 0] * c_w[:, :, None, 0]
        for i in range(1, d):
            decS = decS + S[:, None, :, i] * c_w[:, :, None, i]
        mS = S_lab[:, None, :].to(K.dtype) * (decS + c_b[:, :, None])
        s_clean = ((S_lab[:, None, :] == 0) | (mS > 0.0)).all(dim=2)
        recv = active[:, None] & ~is_ci                  # S recipients
        viol_hit = is_ci & (viol_any & active)[:, None]  # replies landed
        flag_adopt = torch.where(is_ci, ~viol_any[:, None], True)
        flag_keep = state.warm_node & (s_clean | ~recv) & ~viol_hit
        c_valid = state.c_valid | adopt
        warm_node = torch.where(adopt, flag_adopt, flag_keep)
    else:
        c_w, c_b = state.c_w, state.c_b
        c_valid, warm_node = state.c_valid, state.warm_node
    new = MaxMargState(
        wx=wx, wy=wy, w_fill=w_fill,
        turn=state.turn + 1,
        done=state.done | term,
        converged=state.converged | term,
        epochs=torch.where(term, state.turn // k + 1, state.epochs),
        h_w=torch.where(active[:, None], w, state.h_w),
        h_b=torch.where(active, b, state.h_b),
        h_valid=state.h_valid | active,
        warm_turn=torch.where(active, err_next == 0, state.warm_turn),
        c_w=c_w, c_b=c_b,
        c_valid=c_valid,
        warm_node=warm_node,
        latches=state.latches + (active & clean0).to(_I32),
        comm=comm,
    )
    return hotloop.write_into(state, new) if donate else new


def run_compiled(
    data: EngineData,
    state0: MaxMargState,
    *,
    k: int,
    max_turns: int,
    max_support: int = 4,
    steps: int = 2000,
    stages: int = 3,
    lam0: float = 1e-3,
    warm: bool = False,
    per_node: bool = True,
    fused_kernel: bool = False,
    solver_kernel: Optional[bool] = None,
) -> MaxMargState:
    """The cold execution model: ``step`` at the full transcript capacity
    until every instance terminates or the turn budget is spent — with
    ``warm=False`` (the default) the hot path's differential reference.
    The name is the JAX package's; the port runs it as a plain Python turn
    loop."""
    s = state0
    while bool((s.turn.min() < max_turns) & ~s.done.all()):
        s = step(data, s, k=k, max_support=max_support, steps=steps,
                 stages=stages, lam0=lam0, warm=warm,
                 per_node=per_node and warm, fused_kernel=fused_kernel,
                 solver_kernel=solver_kernel)
    return s


def _pad_fix(sub: MaxMargState, pad_row: torch.Tensor) -> MaxMargState:
    """Mark gathered pad rows inert: done=True masks them out of every
    decision and comm update, and trusting their (zero) carries lets the
    warm polish latch them at once (zero data gives every margin +inf), so
    padding never forces an annealing stage the live rows do not need."""
    return sub._replace(done=sub.done | pad_row,
                        h_valid=sub.h_valid | pad_row,
                        c_valid=sub.c_valid | pad_row[:, None],
                        warm_node=sub.warm_node | pad_row[:, None])


def _host_view(state: MaxMargState, ci: int, *,
               per_node: bool = True) -> torch.Tensor:
    """The hot loop's per-turn host knowledge as one (3, B) i32 tensor: done
    flags, the upcoming coordinator's warm-latch flags, and the transcript
    fills the width compaction keys on.  With per-node carries (k > 2) the
    fill row is the max over all nodes, because the carry bookkeeping's
    ``trans_clean`` scan reads every transcript; otherwise only the
    coordinator's transcript is read and its fill keys the cap."""
    k = state.w_fill.shape[1]
    track = per_node and k > 2
    wflag = state.warm_node[:, ci] if track else state.warm_turn
    fills = state.w_fill.amax(dim=1) if track else state.w_fill[:, ci]
    return torch.stack([state.done.to(_I32), wflag.to(_I32), fills])


def run_hot(
    data: EngineData,
    state: MaxMargState,
    *,
    k: int,
    max_turns: int,
    max_support: int = 4,
    steps: int = 2000,
    stages: int = 3,
    lam0: float = 1e-3,
    warm: bool = True,
    per_node: bool = True,
    compact: bool = True,
    fused_kernel: bool = False,
    solver_kernel: Optional[bool] = None,
    mesh=None,
    donate: bool = False,
    overlap: Optional[bool] = None,
    stats: Optional[dict] = None,
) -> MaxMargState:
    """The MAXMARG sweep as a host-driven turn loop over ``step`` on the
    shared :mod:`repro_torch.engine.hotloop` machinery:

    * **width compaction** — the refit reads the coordinator's transcript
      at ``round_up(max live fill, 8)`` rows, not the full capacity;
    * **batch compaction** — finished instances drop out of the dispatch;
    * **warm refits** (``warm=True``) — from turn 1, refits polish a
      carried separator (per node by default, see the module docstring)
      wherever a live instance may latch it.

    Every protocol decision equals ``run_compiled``'s; the separators
    differ only as two float approximations of the same optimum.
    ``overlap=True`` double-buffers the loop; its stale view widens the
    read by the worst one-turn growth, ``max(max_support, 2(k-1))`` rows.
    ``donate=True`` writes every turn into the given state's tensors.

    ``mesh`` (a 1-D ("data",) mesh, ``launch.mesh.make_data_mesh``) runs
    the sweep sharded over the leading B axis, each shard's turn on its own
    device (``pack_instances_maxmarg(..., mesh=...)`` pads B with
    born-done dummies and splits the records); sub-batch turns come
    shard-balanced from ``hotloop.balanced_index``.  On the mesh
    ``overlap`` defaults on (off otherwise); ``donate`` stays off, as it
    did not make a sweep faster on the H100 (PERF.md).  It requires
    ``compact=True`` and returns the per-shard records.  ``stats`` collects
    the shard skew (``hotloop.run_hot``).
    """
    # the carry bookkeeping runs on every turn of a warm per-node run
    # (polished or not) and on none of a cold or single-carry run
    track = per_node and warm
    overlap = mesh is not None if overlap is None else overlap
    opts = dict(k=k, max_support=max_support, steps=steps, stages=stages,
                lam0=lam0, per_node=track, fused_kernel=fused_kernel,
                solver_kernel=solver_kernel, donate=donate)
    if mesh is None:
        shards = ((data,), (state,))
    elif not compact:
        raise ValueError("sharded sweeps require the compacted hot path")
    else:
        shards = (as_shards(data, mesh), as_shards(state, mesh))

    def host_view(s, ci):
        return _host_view(s, ci, per_node=track)

    def dispatch_full(d, s, *, t, width, use_warm):
        return step(d, s, trans_width=width, warm=use_warm, **opts)

    def dispatch_sub(d, s, idx, n_act, *, t, width, use_warm):
        return hotloop.gathered_turn(
            lambda sub_data, sub: step(sub_data, sub, trans_width=width,
                                       warm=use_warm, **opts),
            _pad_fix, d, s, idx, n_act)

    final = hotloop.run_hot(*shards, k=k, max_turns=max_turns,
                            cap=int(shards[1][0].wx.shape[2]),
                            host_view=host_view,
                            dispatch_full=dispatch_full,
                            dispatch_sub=dispatch_sub, warm=warm,
                            compact=compact,
                            width_growth=max(max_support,
                                             VIOL_SHIP * (k - 1)),
                            overlap=overlap, stats=stats, donate=donate)
    return final if mesh is not None else final[0]


def run_instances(
    instances: Sequence[ProtocolInstance],
    *,
    eps: Optional[float] = None,
    max_epochs: int = 48,
    max_support: int = 4,
    steps: int = 2000,
    stages: int = 3,
    lam: float = 1e-3,
    warm: bool = True,
    per_node: bool = True,
    compact: bool = True,
    fused_kernel: Optional[bool] = None,
    solver_kernel: Optional[bool] = None,
    mesh=None,
    donate: bool = False,
    overlap: Optional[bool] = None,
    stats: Optional[dict] = None,
    device="cuda",
):
    """Run a batch of MAXMARG instances as one sweep on ``device``.

    Returns a :class:`~repro_torch.core.protocols.one_way.ProtocolResult`
    per instance, shaped exactly like the JAX package's.

    ``warm``/``compact`` select the hot path (``run_hot``); both False runs
    the cold ``run_compiled``.  ``per_node`` picks the warm-carry mode.
    ``fused_kernel`` and ``solver_kernel`` route the turn scan and the
    refit's λ stages through the CUDA kernels (default: on for a CUDA
    device, off on the CPU).  ``mesh`` shards the hot path over a 1-D
    ("data",) device mesh, whose devices take the place of ``device``
    (requires ``compact=True``; the kernel defaults follow the mesh's
    first device); ``donate``/``overlap`` opt the per-turn dispatches into
    writing in place and the double-buffered host loop (mesh default:
    ``overlap`` on).  ``stats`` (a dict) collects the sharded sweep's shard skew and is
    never read for decisions.

    Launch-shape contract: ``max_epochs``, ``max_support``, ``k`` and ``d``
    fix the state's shapes; the hot path's per-turn shapes take only the
    quantized ``(n_pad, width, use_warm)`` buckets ``hotloop.KEY_LOG``
    records.
    """
    from repro_torch.core import classifiers as clf
    from repro_torch.core.protocols.one_way import ProtocolResult

    if mesh is not None and not compact:
        raise ValueError("sharded sweeps require the compacted hot path")
    dev = _device.resolve(device if mesh is None else mesh.devices[0])
    if eps is not None:
        instances = [ProtocolInstance(inst.shards, eps, "maxmarg")
                     for inst in instances]
    on_card = dataplane.use_kernels_default(dev)
    fused_kernel = on_card if fused_kernel is None else fused_kernel
    solver_kernel = on_card if solver_kernel is None else solver_kernel
    data, state0, k, _cap = pack_instances_maxmarg(
        instances, max_epochs=max_epochs, max_support=max_support,
        mesh=mesh, device=dev)
    opts = dict(k=k, max_turns=k * max_epochs, max_support=max_support,
                steps=steps, stages=stages, lam0=lam, per_node=per_node,
                fused_kernel=fused_kernel, solver_kernel=solver_kernel)
    if warm or compact:
        final = run_hot(data, state0, warm=warm, compact=compact, mesh=mesh,
                        donate=donate, overlap=overlap, stats=stats, **opts)
    else:
        final = run_compiled(data, state0, **opts)
    if mesh is not None:
        final, data = unshard(final), data[0]

    converged = final.converged.cpu().numpy()
    epochs = final.epochs.cpu().numpy()
    h_w = final.h_w.cpu().double().numpy()
    h_b = final.h_b.cpu().double().numpy()
    latches = final.latches.cpu().numpy()
    comm_np = type(final.comm)(*(a.cpu().numpy() for a in final.comm))
    d = data.X.shape[3]
    extra = {"engine": True, "batch": len(instances),
             "selector": "maxmarg", "warm": warm, "compact": compact,
             "per_node": per_node, "device": str(dev)}
    if mesh is not None:
        extra["devices"] = int(mesh.shape["data"])
    results: List[ProtocolResult] = []
    for i in range(len(instances)):
        h = clf.LinearSeparator(h_w[i], float(h_b[i]))
        results.append(ProtocolResult(
            h,
            comm_np.summary(i, dim=d),
            rounds=int(epochs[i]) if converged[i] else max_epochs,
            converged=bool(converged[i]),
            extra=dict(extra, warm_latches=int(latches[i])),
        ))
    return results
