"""The port's SSM mixers (``repro_torch.kernels.rwkv6``,
``repro_torch.kernels.mamba``, ``repro_torch.models.ssm``) against the JAX
package's, on the CPU.

Tolerances: the plain scans against JAX's sequential oracles
``ref.rwkv6_ref`` / ``ref.mamba_ref`` to rtol 1e-5 with atol 1e-6 of the
output's scale in f32 (the same step, with y's dot over the head or state
width summed in another order); against the Pallas kernels run in
interpret mode through ``ops.rwkv6`` / ``ops.selective_scan`` at the JAX
package's own tiers for them (``tests/test_kernels.py``: the chunked WKV
form 1e-3, 5e-3 at the decay extremes; the blocked selective scan 1e-5);
the three mixers (full sequence, prefill from a carried state, decode
steps) to rtol 1e-5 with atol 1e-6 of the scale, outputs and every state
leaf, in f32.  Inputs and weights come from numpy seeds (JAX's initial
weights with their constant leaves drawn away from their constants) and
are handed to both packages.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import repro.configs as JC  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

# the module (the package's name ``rwkv6`` is its wrapper)
rwkv6_module = importlib.import_module("repro_torch.kernels.rwkv6")


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=rtol,
        atol=1e-6 * max(1.0, float(np.abs(want).max())))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# -- the scans --------------------------------------------------------------

def _wkv_inputs(seed, B, S, H, hd, wval=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    if wval is None:   # the JAX tests' decays: sigmoid(N(0,1)) in (0.01, 0.99)
        w = (0.98 / (1 + np.exp(-rng.normal(size=(B, S, H, hd)))) + 0.01)
    else:
        w = np.full((B, S, H, hd), wval)
    u = rng.normal(0, 0.1, (H, hd)).astype(np.float32)
    S0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, S0


def _scan_inputs(seed, B, S, di, ds):
    rng = np.random.default_rng(seed)
    xc = rng.normal(size=(B, S, di)).astype(np.float32)
    delta = np.log1p(np.exp(rng.normal(size=(B, S, di)) - 2)).astype(
        np.float32)
    A = -np.exp(rng.normal(0, 0.5, (di, ds))).astype(np.float32)
    Bs, Cs = (rng.normal(size=(B, S, ds)).astype(np.float32)
              for _ in range(2))
    h0 = rng.normal(size=(B, di, ds)).astype(np.float32)
    return xc, delta, A, Bs, Cs, h0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,hd", [(1, 64, 2, 32), (2, 37, 3, 16),
                                      (2, 1, 4, 64)])
def test_rwkv6_plain_matches_oracle(B, S, H, hd, with_state):
    r, k, v, w, u, S0 = _wkv_inputs(B * S + hd, B, S, H, hd)
    S0 = S0 if with_state else None
    ye, sTe = jref.rwkv6_ref(r, k, v, w, u, S0=S0)
    y, sT = kernels.rwkv6_plain(*_t(r, k, v, w, u),
                                S0=None if S0 is None else _t(S0)[0])
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (B, S, H, hd) and sT.shape == (B, H, hd, hd)
    _close(y, ye)
    _close(sT, sTe)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,di,ds", [(1, 64, 32, 16), (2, 37, 48, 8),
                                       (3, 1, 40, 16)])
def test_mamba_plain_matches_oracle(B, S, di, ds, with_state):
    xc, delta, A, Bs, Cs, h0 = _scan_inputs(B * S + di, B, S, di, ds)
    h0 = h0 if with_state else None
    ye, hTe = jref.mamba_ref(xc, delta, A, Bs, Cs, h0=h0)
    y, hT = kernels.mamba_scan_plain(*_t(xc, delta, A, Bs, Cs),
                                     h0=None if h0 is None else _t(h0)[0])
    assert y.dtype == hT.dtype == torch.float32
    assert y.shape == (B, S, di) and hT.shape == (B, di, ds)
    _close(y, ye)
    _close(hT, hTe)


def test_mamba_plain_converts_first_and_writes_y_in_xc_dtype():
    """bf16 inputs are converted to f32 before any arithmetic (as the TPU
    kernel does); y comes back in bf16, the state in f32."""
    xc, delta, A, Bs, Cs, _ = _scan_inputs(3, 2, 20, 24, 16)
    xb, db, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (xc, delta, Bs, Cs))
    y, hT = kernels.mamba_scan_plain(xb, db, torch.from_numpy(A), Bb, Cb)
    y32, hT32 = kernels.mamba_scan_plain(xb.float(), db.float(),
                                         torch.from_numpy(A), Bb.float(),
                                         Cb.float())
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    assert torch.equal(hT, hT32) and torch.equal(y, y32.to(torch.bfloat16))


# (B, S, H, hd, chunk): the shapes of the JAX package's chunked-WKV tests,
# S not a multiple of the chunk included
@pytest.mark.parametrize("B,S,H,hd,chunk", [(1, 64, 2, 32, 16),
                                            (2, 128, 3, 64, 32),
                                            (1, 96, 1, 16, 32)])
def test_rwkv6_plain_matches_jax_chunked_kernel(B, S, H, hd, chunk):
    r, k, v, w, u, _ = _wkv_inputs(S + hd, B, S, H, hd)
    ye, sTe = jops.rwkv6(*map(jnp.asarray, (r, k, v, w, u)), chunk=chunk,
                         interpret=True)
    y, sT = kernels.rwkv6_plain(*_t(r, k, v, w, u))
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sTe), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("wval", [0.02, 0.999])
def test_rwkv6_plain_at_the_decay_extremes(wval):
    r, k, v, w, _, _ = _wkv_inputs(9, 1, 64, 1, 16, wval=wval)
    u = np.zeros((1, 16), np.float32)
    ye, _ = jops.rwkv6(*map(jnp.asarray, (r, k, v, w, u)), chunk=16,
                       interpret=True)
    y, _ = kernels.rwkv6_plain(*_t(r, k, v, w, u))
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), rtol=5e-3,
                               atol=5e-3)
    yo, sTo = jref.rwkv6_ref(r, k, v, w, u)
    y, sT = kernels.rwkv6_plain(*_t(r, k, v, w, u))
    _close(y, yo)
    _close(sT, sTo)


# (B, S, di, ds, chunk, block_di): the JAX package's selective-scan tests,
# ragged S and di included
@pytest.mark.parametrize("B,S,di,ds,chunk,bdi", [(1, 64, 32, 16, 16, 32),
                                                 (2, 128, 64, 16, 32, 32),
                                                 (1, 100, 48, 8, 32, 16)])
def test_mamba_plain_matches_jax_blocked_kernel(B, S, di, ds, chunk, bdi):
    xc, delta, A, Bs, Cs, _ = _scan_inputs(S * di, B, S, di, ds)
    ye, hTe = jops.selective_scan(*map(jnp.asarray, (xc, delta, A, Bs, Cs)),
                                  chunk=chunk, block_di=bdi, interpret=True)
    y, hT = kernels.mamba_scan_plain(*_t(xc, delta, A, Bs, Cs))
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hTe), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_take_plain_versions_on_cpu_and_write_states_in_place():
    kernels.reset_launches()
    r, k, v, w, u, S0 = _t(*_wkv_inputs(1, 2, 9, 2, 32))
    y, sT = kernels.rwkv6(r, k, v, w, u)
    yp, sTp = kernels.rwkv6_plain(r, k, v, w, u)
    assert torch.equal(y, yp) and torch.equal(sT, sTp)
    state = S0.clone()
    y, sT = kernels.rwkv6(r, k, v, w, u, state=state)
    yp, sTp = kernels.rwkv6_plain(r, k, v, w, u, S0=S0)
    assert sT is state and torch.equal(state, sTp) and torch.equal(y, yp)

    xc, delta, A, Bs, Cs, h0 = _t(*_scan_inputs(2, 2, 9, 40, 16))
    y, hT = kernels.mamba_scan(xc, delta, A, Bs, Cs)
    yp, hTp = kernels.mamba_scan_plain(xc, delta, A, Bs, Cs)
    assert torch.equal(y, yp) and torch.equal(hT, hTp)
    state = h0.clone()
    y, hT = kernels.mamba_scan(xc, delta, A, Bs, Cs, state=state)
    yp, hTp = kernels.mamba_scan_plain(xc, delta, A, Bs, Cs, h0=h0)
    assert hT is state and torch.equal(state, hTp) and torch.equal(y, yp)
    assert kernels.rwkv6.launches == kernels.mamba_scan.launches == 0
    assert kernels.launches()["rwkv6"] == kernels.launches()["mamba_scan"] == 0


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_plain_takes_bf16_rkv_as_their_f32_values(with_state):
    """The time mix hands the kernels r, k, v in the model's dtype: bf16
    widens to f32 exactly, so the function is that of the f32 values, bit
    for bit (the wrapper on the CPU too)."""
    r, k, v, w, u, S0 = _wkv_inputs(21, 2, 19, 3, 32)
    rb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v))
    w, u = torch.from_numpy(w), torch.from_numpy(u)
    S0 = torch.from_numpy(S0) if with_state else None
    y, sT = kernels.rwkv6_plain(rb, kb, vb, w, u, S0=S0)
    y32, sT32 = kernels.rwkv6_plain(rb.float(), kb.float(), vb.float(), w, u,
                                    S0=S0)
    assert y.dtype == sT.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(sT, sT32)
    yw, sw = kernels.rwkv6(rb, kb, vb, w, u,
                           state=None if S0 is None else S0.clone())
    assert torch.equal(yw, y) and torch.equal(sw, sT)


def _fma(a, b, c):
    """fl(a*b + c) for f32 arrays (the product is exact in f64)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _kernel_order_wkv(r, k, v, w, u, S0=None, lanes=4):
    """numpy f32 replica of csrc/rwkv6.cu's order: per step the bonus
    c_t = sum_i fl(fl(r_i u_i) k_i) in 8-row pieces, summed in order and
    folded pairwise (the shuffle butterfly); y_j = each lane's FMA chain of
    r_i S_ij over its interleaved 4-row groups, the lanes' sums added in
    lane order, plus fl(v_j c_t); the state fl(fl(w_i S_ij) + fl(k_i v_j))."""
    f32 = np.float32
    B, S, H, hd = r.shape
    st = (np.zeros((B, H, hd, hd), f32) if S0 is None
          else S0.astype(f32).copy())
    y = np.empty((B, S, H, hd), f32)
    rows = [[4 * (q * lanes + l) + e for q in range(hd // 4 // lanes)
             for e in range(4)] for l in range(lanes)]
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B, H, hd)
        pieces = ((rt * u) * kt).reshape(B, H, hd // 8, 8)
        part = np.zeros((B, H, hd // 8), f32)
        for x in range(8):
            part = part + pieces[..., x]
        while part.shape[-1] > 1:
            part = part[..., 0::2] + part[..., 1::2]
        acc = None
        for lane_rows in rows:
            a = np.zeros((B, H, hd), f32)
            for i in lane_rows:
                a = _fma(rt[..., i, None], st[..., i, :], a)
            acc = a if acc is None else acc + a
        y[:, t] = acc + vt * part[..., 0, None]
        st = wt[..., :, None] * st + kt[..., :, None] * vt[..., None, :]
    return y, st


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,hd", [(2, 37, 3, 64), (1, 20, 2, 32)])
def test_rwkv6_kernel_order_matches_oracle(B, S, H, hd, with_state):
    """The kernel's factored y, y_j = sum_i r_i S_ij + v_j c_t, in its
    summation order, at the f32 tier against ref.rwkv6_ref; its state bit
    for bit against the plain version."""
    r, k, v, w, u, S0 = _wkv_inputs(S + hd + with_state, B, S, H, hd)
    S0 = S0 if with_state else None
    y, sT = _kernel_order_wkv(r, k, v, w, u, S0)
    ye, sTe = jref.rwkv6_ref(r, k, v, w, u, S0=S0)
    _close(torch.from_numpy(y), ye)
    _close(torch.from_numpy(sT), sTe)
    _, sTp = kernels.rwkv6_plain(*_t(r, k, v, w, u),
                                 S0=None if S0 is None else _t(S0)[0])
    np.testing.assert_array_equal(sT, sTp.numpy())


def test_rwkv6_kernel_arguments_refuse_what_the_kernel_does_not_take():
    r, k, v, w, u, S0 = _t(*_wkv_inputs(5, 2, 3, 2, 32))
    check = rwkv6_module.check_kernel_args
    assert check(r, k, v, w, u, S0) == (2, 3, 2, 32)
    bf = torch.bfloat16
    assert check(r.to(bf), k.to(bf), v.to(bf), w, u) == (2, 3, 2, 32)
    for bad in [(r.half(), k.half(), v.half(), w, u),      # f16 inputs
                (r.to(bf), k, v, w, u),                     # mixed types
                (r, k, v, w.to(bf), u),                     # bf16 decay
                (r, k, v, w, u.double()),
                (r, k, v, w, u, S0.to(bf))]:
        with pytest.raises(TypeError):
            check(*bad)
    for bad in [(r[..., :16].contiguous(),) * 3 + (w[..., :16], u),
                (r, k, v, w, u[:1]),
                (r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)]:
        with pytest.raises(ValueError):
            check(*bad)
    flat = torch.zeros(r.numel() + 1)
    shifted = flat[1:].view(r.shape)                        # 4-byte aligned
    with pytest.raises(ValueError, match="16-byte"):
        check(shifted, k, v, w, u)
    with pytest.raises(ValueError, match="16-byte"):
        check(r, k, v, w, u, torch.zeros(S0.numel() + 1)[1:].view(S0.shape))


mamba_module = importlib.import_module("repro_torch.kernels.mamba")


def _kernel_order_scan(xc, delta, A, Bs, Cs, h0=None):
    """f32 replica of csrc/mamba_scan.cu's order: the state rounded as the
    plain version rounds it (one rounding per operation, torch.exp), and
    y_t[i] a chain of fused multiply-adds acc = fma(h[i][s], C_t[s], acc)
    from s = 0 up."""
    x, d, A, Bf, Cf = (torch.from_numpy(a) for a in (xc, delta, A, Bs, Cs))
    B, S, di = x.shape
    h = (torch.zeros((B, di, A.shape[1])) if h0 is None
         else torch.from_numpy(h0).clone())
    y = np.empty((B, S, di), np.float32)
    for t in range(S):
        d_t = d[:, t]
        h = (torch.exp(d_t[..., None] * A) * h
             + (d_t * x[:, t])[..., None] * Bf[:, t, None, :])
        hn, cn = h.numpy(), Cf[:, t].numpy()
        acc = np.zeros((B, di), np.float32)
        for k in range(A.shape[1]):
            acc = _fma(hn[..., k], cn[:, None, k], acc)
        y[:, t] = acc
    return y, h


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,di", [(2, 37, 48), (1, 33, 40), (3, 1, 24)])
def test_mamba_kernel_order_matches_oracle(B, S, di, with_state):
    """The kernel's y, summed in its order, at the f32 tier against
    ref.mamba_ref; its state bit for bit against the plain version."""
    xc, delta, A, Bs, Cs, h0 = _scan_inputs(B + S + di, B, S, di, 16)
    h0 = h0 if with_state else None
    y, hT = _kernel_order_scan(xc, delta, A, Bs, Cs, h0)
    ye, hTe = jref.mamba_ref(xc, delta, A, Bs, Cs, h0=h0)
    _close(torch.from_numpy(y), ye)
    _close(hT, hTe)
    _, hTp = kernels.mamba_scan_plain(*_t(xc, delta, A, Bs, Cs),
                                      h0=None if h0 is None else _t(h0)[0])
    assert torch.equal(hT, hTp)


def test_mamba_kernel_arguments_refuse_what_the_kernel_does_not_take():
    xc, delta, A, Bs, Cs, h0 = _t(*_scan_inputs(8, 2, 5, 40, 16))
    check = mamba_module.check_kernel_args
    assert check(xc, delta, A, Bs, Cs, h0) == (2, 5, 40, 16)
    bf = torch.bfloat16
    assert check(xc.to(bf), delta.to(bf), A, Bs.to(bf), Cs.to(bf)) == \
        (2, 5, 40, 16)
    for bad in [(xc.half(), delta.half(), A, Bs.half(), Cs.half()),
                (xc.to(bf), delta, A, Bs, Cs),              # mixed types
                (xc, delta, A.to(bf), Bs, Cs),               # bf16 A
                (xc, delta, A, Bs, Cs, h0.double())]:
        with pytest.raises(TypeError):
            check(*bad)
    for bad in [(xc, delta, A[:, :8].contiguous(), Bs[..., :8].contiguous(),
                 Cs[..., :8].contiguous()),                 # d_state 8
                (xc, delta[:, :4], A, Bs, Cs),
                (xc, delta, A, Bs, Cs, h0[:1]),
                (xc.transpose(0, 1).contiguous().transpose(0, 1), delta, A,
                 Bs, Cs)]:
        with pytest.raises(ValueError):
            check(*bad)
    with pytest.raises(ValueError, match="16-byte"):
        check(xc, delta, A, Bs, Cs,
              torch.zeros(h0.numel() + 1)[1:].view(h0.shape))
    with pytest.raises(ValueError, match="16-byte"):
        check(torch.zeros(xc.numel() + 1)[1:].view(xc.shape), delta, A, Bs,
              Cs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tmix_hands_rwkv6_the_model_dtype(monkeypatch, dtype):
    """No cast before the kernel: r, k, v arrive in the model's dtype, w and
    u in f32."""
    cfg, jcfg = _cfgs("rwkv6-7b")
    p = {name: torch.from_numpy(a).to(dtype) for name, a in
         _params(jssm.init_rwkv_tmix, jcfg, 0).items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 5, cfg.d_model)).astype(np.float32)).to(dtype)
    seen, original = [], kernels.rwkv6

    def record(r, k, v, w, u, state=None):
        seen.append(tuple(a.dtype for a in (r, k, v, w, u)))
        return original(r, k, v, w, u, state=state)

    monkeypatch.setattr(kernels, "rwkv6", record)
    out, _ = ssm.apply_rwkv_tmix(p, cfg, x)
    assert seen == [(dtype,) * 3 + (torch.float32,) * 2]
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())


def test_wrappers_refuse_other_devices():
    q = torch.ones((1, 3, 2, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.rwkv6(q, q, q, q, torch.ones((2, 32), device="meta"))
    x = torch.ones((1, 3, 40), device="meta")
    bc = torch.ones((1, 3, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.mamba_scan(x, x, torch.ones((40, 16), device="meta"), bc, bc)


# -- the mixers -------------------------------------------------------------

_CONSTANT_LEAVES = {"mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0",
                    "ln_scale", "conv_b", "dt_bias", "D", "A_log"}


def _params(init, jcfg, seed):
    """JAX initial weights as numpy, the constant leaves perturbed."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    out = {}
    for name, a in p.items():
        if name.startswith("mu_"):
            a = rng.uniform(0, 1, a.shape)
        elif name in _CONSTANT_LEAVES:
            a = a + rng.normal(0, 0.1 if name != "w0" else 0.5, a.shape)
        out[name] = np.array(a, np.float32)
    return out


def _cfgs(arch):
    return get_config(arch).reduced(), JC.get_config(arch).reduced()


def _run_both(japply, tapply, jp, cfg, jcfg, x, jstate, tstate):
    want, jnew = japply(jp, jcfg, jnp.asarray(x), jstate)
    got, tnew = tapply({k: torch.from_numpy(a) for k, a in jp.items()}, cfg,
                       torch.from_numpy(x), tstate)
    _close(got, want)
    return jnew, tnew


def _check_states(tstate, jstate):
    assert sorted(tstate) == sorted(jstate)
    for name in tstate:
        _close(tstate[name], jstate[name])


def _walk(japply, tapply, jp, cfg, jcfg, state0, seed, d):
    """Full sequence (no state), then prefill from the carried ``state0``
    (S=7), then three decode steps (S=1), port against JAX."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    _run_both(japply, tapply, jp, cfg, jcfg, x, None, None)
    jstate = {k: jnp.asarray(a) for k, a in state0.items()}
    tstate = {k: torch.from_numpy(a.copy()) for k, a in state0.items()}
    held = dict(tstate)
    xp = rng.normal(size=(2, 7, d)).astype(np.float32)
    jstate, tnew = _run_both(japply, tapply, jp, cfg, jcfg, xp, jstate, tstate)
    assert tnew is tstate and all(tstate[k] is held[k] for k in held)
    _check_states(tstate, jstate)
    for _ in range(3):
        xd = rng.normal(size=(2, 1, d)).astype(np.float32)
        jstate, _ = _run_both(japply, tapply, jp, cfg, jcfg, xd, jstate,
                              tstate)
        _check_states(tstate, jstate)


def test_rwkv_tmix_matches():
    cfg, jcfg = _cfgs("rwkv6-7b")
    H, hd = ssm.rwkv_dims(cfg)
    assert (H, hd) == jssm.rwkv_dims(jcfg) == (8, 32)
    jp = _params(jssm.init_rwkv_tmix, jcfg, 0)
    rng = np.random.default_rng(10)
    state0 = {"shift": rng.normal(size=(2, cfg.d_model)).astype(np.float32),
              "wkv": rng.normal(size=(2, H, hd, hd)).astype(np.float32)}
    _walk(jssm.apply_rwkv_tmix, ssm.apply_rwkv_tmix, jp, cfg, jcfg, state0,
          11, cfg.d_model)


def test_rwkv_cmix_matches():
    cfg, jcfg = _cfgs("rwkv6-7b")
    jp = _params(jssm.init_rwkv_cmix, jcfg, 1)
    state0 = {"shift": np.random.default_rng(12).normal(
        size=(2, cfg.d_model)).astype(np.float32)}
    _walk(jssm.apply_rwkv_cmix, ssm.apply_rwkv_cmix, jp, cfg, jcfg, state0,
          13, cfg.d_model)


def test_mamba_matches():
    cfg, jcfg = _cfgs("jamba-1.5-large-398b")
    di, ds, dc, dtr = ssm.mamba_dims(cfg)
    assert (di, ds, dc, dtr) == jssm.mamba_dims(jcfg) == (512, 16, 4, 16)
    jp = _params(jssm.init_mamba, jcfg, 2)
    rng = np.random.default_rng(14)
    state0 = {"conv": rng.normal(size=(2, dc - 1, di)).astype(np.float32),
              "h": rng.normal(size=(2, di, ds)).astype(np.float32)}
    _walk(jssm.apply_mamba, ssm.apply_mamba, jp, cfg, jcfg, state0, 15,
          cfg.d_model)


@pytest.mark.parametrize("kind", ["rwkv_tmix", "rwkv_cmix", "mamba"])
def test_init_builds_the_jax_leaves(kind):
    arch = "jamba-1.5-large-398b" if kind == "mamba" else "rwkv6-7b"
    cfg, jcfg = _cfgs(arch)
    want = jax.tree.map(np.asarray, getattr(jssm, f"init_{kind}")(
        jax.random.PRNGKey(0), jcfg))
    got = getattr(ssm, f"init_{kind}")(torch.Generator().manual_seed(0), cfg)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape, name
        if name in _CONSTANT_LEAVES:      # constants, not draws
            np.testing.assert_allclose(got[name].numpy(), a, rtol=1e-6)
