"""The port's batched max-margin solver (``repro_torch.core.classifiers``)
held against the JAX package's (``repro.core.classifiers``) on the CPU.

Both packages get the same numpy inputs: fit sets with a margin gap
(0.3) and ragged label-0 padding, one instance with random labels (never
separable), carried separators of which one misclassifies its fit set and
one is not trusted (``warm_ok`` False).

Tolerances:

* ``found`` and the polish gate bits: exact;
* w and b: within 1e-4 of the instance's largest |w_i|, |b| — both sides
  are float approximations of the same optimum: XLA contracts the classic
  loop's multiply-adds into FMAs and sums over N in its own order, and the
  kernel path's twin contracts with an einsum where the port sums in its
  CUDA kernel's order;
* the λ schedule: bit for bit;
* the port's stage loop with and without its early exit: bit for bit.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from repro.core import classifiers as jclf

import torch

from repro_torch.core import classifiers as tclf

STEPS = 300
REL = 1e-4


def _inputs(d, seed, B=6, N=80):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(B, d))
    w_true /= np.linalg.norm(w_true, axis=1, keepdims=True)
    X = rng.normal(size=(B, N, d))
    y = np.where(np.einsum("bnd,bd->bn", X, w_true) > 0, 1.0, -1.0)
    X += 0.3 * y[..., None] * w_true[:, None, :]          # margin gap
    b_true = rng.normal(scale=0.3, size=B)
    X -= b_true[:, None, None] * w_true[:, None, :]
    y[B - 1] = rng.choice([-1.0, 1.0], N)                 # never separable
    for b in range(B):
        y[b, N - 5 * b:] = 0.0                            # ragged padding
    w0 = (3 * w_true).astype(np.float32)
    w0[1] = -w0[1]                                        # a dirty carry
    b0 = (3 * b_true).astype(np.float32)
    warm_ok = np.array([True, True, False, True, True, True])
    return X.astype(np.float32), y.astype(np.float32), w0, b0, warm_ok


def _assert_close(jres, tres):
    np.testing.assert_array_equal(tres[2].numpy(), np.asarray(jres[2]))
    if len(jres) == 4:
        np.testing.assert_array_equal(tres[3].numpy(), np.asarray(jres[3]))
    va = np.concatenate([np.asarray(jres[0]), np.asarray(jres[1])[:, None]],
                        axis=1)
    vb = np.concatenate([tres[0].numpy(), tres[1].numpy()[:, None]], axis=1)
    scale = np.abs(va).max(axis=1, keepdims=True)
    np.testing.assert_array_less(np.abs(va - vb),
                                 np.broadcast_to(REL * scale, va.shape))


@pytest.mark.parametrize("lam0", [1e-3, 1e-2, 0.37])
def test_lambda_schedule_bitwise(lam0):
    """``lam0 * 0.1 ** s`` in f32, as ``_svm_solve_batch``'s stage body
    forms it (classifiers.py's ``lam_s``)."""
    f = jax.jit(lambda lam, s: lam * 0.1 ** s.astype(jnp.float32))
    want = [np.float32(f(jnp.float32(lam0), jnp.int32(s))) for s in range(3)]
    got = tclf.lam_schedule(lam0, 3)
    assert [np.float32(g).tobytes() for g in got] == \
        [w.tobytes() for w in want]


@pytest.mark.parametrize("d", [2, 8, 16])
@pytest.mark.parametrize("kernel", [False, True], ids=["classic", "kernel"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solver_matches_reference(d, kernel, warm):
    """``_svm_solve_batch`` cold and warm, on both inner loops (the JAX
    kernel path runs its jnp twin on the CPU, the port its plain version):
    latch and gate bits exact, separators to the stated tier."""
    X, y, w0, b0, wok = _inputs(d, seed=d)
    kw = dict(w0=w0, b0=b0, warm_ok=wok) if warm else {}
    jres = jclf._svm_solve_batch(
        jnp.asarray(X), jnp.asarray(y), jnp.float32(1e-3), STEPS, 3,
        return_gate=True, kernel=kernel,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tres = tclf._svm_solve_batch(
        torch.from_numpy(X), torch.from_numpy(y), 1e-3, STEPS, 3,
        return_gate=True, kernel=kernel,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    _assert_close(jres, tres)
    assert tres[2][:-1].all() and not tres[2][-1]
    if warm:   # the clean trusted carries pass the gate, the others not
        assert tres[3].tolist() == [True, False, False, True, True, False]


@pytest.mark.parametrize("kernel", [False, True], ids=["classic", "kernel"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_all_stages_with_skipping_equal_the_early_exit(kernel, warm):
    """The card launches every λ stage (the kernel skips latched instances'
    steps); the CPU leaves the loop once every instance has latched, as
    the JAX package does.  Bit for bit the same, here with every instance
    separable so the early exit fires."""
    X, y, w0, b0, wok = (torch.from_numpy(a) for a in _inputs(8, seed=1))
    y = y[:-1].clone()
    X, w0, b0, wok = X[:-1], w0[:-1], b0[:-1], wok[:-1]
    kw = dict(w0=w0, b0=b0, warm_ok=wok) if warm else {}
    out = [tclf._svm_solve_batch(X, y, 1e-3, STEPS, 3, kernel=kernel,
                                 return_gate=True, early_exit=ex, **kw)
           for ex in (True, False)]
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert out[0][2].all()
    jres = jclf._svm_solve_batch(
        jnp.asarray(X.numpy()), jnp.asarray(y.numpy()), jnp.float32(1e-3),
        STEPS, 3, return_gate=True, kernel=kernel,
        **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
    _assert_close(jres, out[1])


def test_untrusted_warm_entry_is_the_cold_entry_bit_for_bit():
    """With no instance allowed to latch (warm_ok all False) the polish
    adds nothing: the anneal from zeros equals the cold entry's."""
    X, y, w0, b0, _ = (torch.from_numpy(a) for a in _inputs(2, seed=4))
    for kernel in (False, True):
        cold = tclf._svm_solve_batch(X, y, 1e-3, STEPS, 2, kernel=kernel)
        warm = tclf._svm_solve_batch(
            X, y, 1e-3, STEPS, 2, kernel=kernel, w0=w0, b0=b0,
            warm_ok=torch.zeros(X.shape[0], dtype=torch.bool))
        for a, b in zip(cold, warm):
            assert torch.equal(a, b)


def test_polish_latches_a_clean_carried_separator():
    """A clean carry latches through the polish with its margin kept, as
    tests/test_maxmarg_warm.py checks for the JAX solver."""
    rng = np.random.default_rng(3)
    n = 150
    Xp = np.stack([-0.5 - rng.random(n), rng.normal(0, 2.0, n)], axis=1)
    Xn = np.stack([+0.5 + rng.random(n), rng.normal(0, 2.0, n)], axis=1)
    X = np.concatenate([Xp, Xn]).astype(np.float32)
    y = np.concatenate([np.ones(n), -np.ones(n)]).astype(np.float32)
    w0, b0, ok0 = tclf.anneal_hard_margin(X, y, steps=1000, device="cpu")
    assert ok0
    w, b, ok, gate = tclf._svm_solve_batch(
        torch.from_numpy(X[None]), torch.from_numpy(y[None]), 1e-3, 1000, 3,
        w0=torch.tensor(w0[None], dtype=torch.float32),
        b0=torch.tensor([b0], dtype=torch.float32),
        warm_ok=torch.ones(1, dtype=torch.bool), return_gate=True)
    assert bool(ok[0]) and bool(gate[0])
    m = y * (X @ w[0].double().numpy() + float(b[0]))
    assert m.min() > 0
    assert m.min() / np.linalg.norm(w[0].numpy()) >= 0.9 * 0.5


def test_single_instance_entries_match_reference():
    """``anneal_hard_margin``, ``fit_max_margin`` and ``support_points`` at
    B=1 against the JAX package's."""
    X, y, _w0, _b0, _ok = _inputs(3, seed=7, B=2)
    Xi, yi = X[0][y[0] != 0], y[0][y[0] != 0]
    ja = jclf.anneal_hard_margin(Xi, yi, steps=STEPS)
    ta = tclf.anneal_hard_margin(Xi, yi, steps=STEPS, device="cpu")
    assert ta[2] == ja[2] and isinstance(ta[1], float)
    np.testing.assert_allclose(ta[0], ja[0], rtol=0,
                               atol=REL * np.abs(ja[0]).max())
    jf = jclf.fit_max_margin(Xi, yi, steps=STEPS)
    tf = tclf.fit_max_margin(Xi, yi, steps=STEPS, device="cpu")
    assert abs(tf.margin - jf.margin) <= REL * abs(jf.margin)
    for rtol, ms in ((0.15, 8), (0.15, 2), (5.0, 4)):
        np.testing.assert_array_equal(
            tclf.support_points(tf, Xi, yi, rtol=rtol, max_support=ms),
            jclf.support_points(jf, Xi, yi, rtol=rtol, max_support=ms))


def _classic_replica(X, y, w, b, lam, nsteps, sqrt):
    """numpy f32 replica of ``_classic_stage`` with the square root
    ``sqrt``: one rounding per operation, margins left to right over d."""
    f = np.float32
    valid = y != 0
    nv = np.maximum(valid.sum(axis=1), 1).astype(f)
    inv_sqrt_lam = f(1.0) / sqrt(lam)
    for i in range(nsteps):
        eta = f(1.0) / (lam * (f(i) + f(2.0)))
        dec = X[:, :, 0] * w[:, None, 0]
        for j in range(1, X.shape[2]):
            dec = dec + X[:, :, j] * w[:, None, j]
        m = y * (dec + b[:, None])
        vy = ((m < f(1.0)) & valid).astype(f) * y
        gsum = (vy[:, :, None] * X).sum(axis=1)     # exact: dyadic X
        gw = lam[:, None] * w - gsum / nv[:, None]
        gb = -vy.sum(axis=1) / nv
        w = w - eta[:, None] * gw
        b = b - eta * gb
        nrm2 = w[:, 0] * w[:, 0]
        for j in range(1, w.shape[1]):
            nrm2 = nrm2 + w[:, j] * w[:, j]
        scale = np.minimum(inv_sqrt_lam / (sqrt(nrm2) + f(1e-12)), f(1.0))
        w, b = w * scale[:, None], b * scale
    return w, b


def _torch_sqrt(x):
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def test_classic_stage_roots_are_correctly_rounded():
    """``_classic_stage`` takes correctly rounded square roots on the CPU,
    as the kernel's ``__fsqrt_rn`` does: on λ values and iterates where
    torch's CPU sqrt is 1 ulp off (found as
    test_torch_kernels.test_plain_sqrt_is_correctly_rounded finds them), a
    step equals its numpy replica with ``np.sqrt`` bit for bit and not the
    replica with torch's root.  X is dyadic, so every sum over the rows is
    exact in any order."""
    rng = np.random.default_rng(0)
    cand = (rng.random(200_000) * 10.0 ** rng.integers(-3, 1, 200_000)
            ).astype(np.float32)
    off = cand[_torch_sqrt(cand) != np.sqrt(cand)]
    B, N, d, nsteps = 64, 12, 2, 3
    lam = off[:B].copy()
    X = (rng.integers(-8, 9, size=(B, N, d)) / 4.0).astype(np.float32)
    y = rng.choice([-1.0, 1.0], size=(B, N)).astype(np.float32)
    y[:, -2:] = 0.0                                     # padding rows
    w = (rng.normal(size=(B, d)) * 40.0).astype(np.float32)   # projected
    b = rng.normal(size=B).astype(np.float32)
    assert len(lam) == B and (_torch_sqrt(lam) != np.sqrt(lam)).all()
    want = _classic_replica(X, y, w, b, lam, nsteps, np.sqrt)
    wrong = _classic_replica(X, y, w, b, lam, nsteps, _torch_sqrt)
    valid = torch.from_numpy(y) != 0
    got = tclf._classic_stage(
        torch.from_numpy(X), torch.from_numpy(y), valid,
        valid.sum(dim=1).clamp_min(1).float(), torch.from_numpy(w),
        torch.from_numpy(b), torch.from_numpy(lam), nsteps)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert not (np.array_equal(wrong[0], want[0])
                and np.array_equal(wrong[1], want[1]))
