"""Gradients through the scan kernels: the grad guard and the chunked VJP.

The WKV and selective-scan kernels write fresh outputs with no autograd
history, so a gradient cannot flow through a raw launch.  Their
``torch.autograd.Function`` (``rwkv6_autograd``, ``mamba_scan_autograd``)
launches the kernel forward and differentiates the plain version backward,
chunk by chunk, as the JAX package's ``models/ssm.py`` ``chunked_scan``
does under ``jax.checkpoint``: the states at chunk boundaries are
recomputed by a no-grad plain pass, then each chunk, last to first, is
recomputed under autograd from its boundary state and differentiated with
the gradient carried back from the chunk after it.  Only one chunk's
per-token states live at a time.  The backward is the same code on the
card and on the CPU and launches no kernel.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

CHUNK = 64    # tokens a recomputed chunk holds (JAX's chunked_scan)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, instead: str, *tensors: torch.Tensor) -> None:
    """Raise if a raw kernel launch on ``tensors`` would drop a gradient:
    the launch writes outputs autograd knows nothing of."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel's outputs carry no gradient, and an input "
            f"requires one; call {instead}")


def chunked_vjp(plain: Callable, inputs: Sequence[torch.Tensor],
                is_seq: Sequence[bool], dy: torch.Tensor,
                dstate: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients of ``plain(*inputs, state0) -> (y, final state)`` for
    output gradients ``dy`` (B, S, ...) and ``dstate`` (or None).  Inputs
    marked ``is_seq`` are (B, S, ...) and cut along axis 1 into chunks of
    :data:`CHUNK` tokens (the last may be short); the others enter every
    chunk whole and their gradients are summed over the chunks.  A state
    of None is the zero state."""
    S, chunk = dy.shape[1], CHUNK
    starts = list(range(0, S, chunk))

    def piece(i, s):
        return inputs[i][:, s:s + chunk] if is_seq[i] else inputs[i]

    with torch.no_grad():
        states = [None]
        for s in starts[:-1]:
            _, st = plain(*(piece(i, s) for i in range(len(inputs))),
                          states[-1])
            states.append(st)
    grads: List[Optional[torch.Tensor]] = [
        torch.empty_like(a) if q else None for a, q in zip(inputs, is_seq)]
    for s, st in zip(reversed(starts), reversed(states)):
        with torch.enable_grad():
            xs = [piece(i, s).detach().requires_grad_()
                  for i in range(len(inputs))]
            st = None if st is None else st.detach().requires_grad_()
            y, end = plain(*xs, st)
            outs, douts = [y], [dy[:, s:s + chunk]]
            if dstate is not None:
                outs.append(end)
                douts.append(dstate)
            got = torch.autograd.grad(outs, xs + ([] if st is None else [st]),
                                      douts)
        for i, g in enumerate(got[:len(inputs)]):
            if is_seq[i]:
                grads[i][:, s:s + chunk] = g
            else:
                grads[i] = g if grads[i] is None else grads[i] + g
        dstate = None if st is None else got[-1]
    return grads
