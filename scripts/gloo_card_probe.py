#!/usr/bin/env python3
"""Which collectives two gloo ranks sharing one CUDA card can run.

DTensor redistributes through ``torch.distributed._functional_collectives``;
two processes on one card cannot use NCCL (it takes one rank a card), so
they would have to use gloo, which stages CUDA tensors through the host.
This spawns a pair of gloo ranks on ``cuda:0`` for each collective in turn
(the four functional ones DTensor issues, and c10d's own all-gather) and
prints each pair's exit codes and results:

    python3 scripts/gloo_card_probe.py

On torch 2.11.0+cu128 on an H100 the functional all-gather ends both
processes with signal 11 (exit code -11); the others return.
"""

import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single", "c10d all_gather_into_tensor")


def _rank(rank, port, op, q):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    torch.cuda.set_device(0)
    from torch.distributed import _functional_collectives as fc
    group = dist.group.WORLD
    x = torch.arange(8.0, device="cuda") + rank
    try:
        if op == "all_reduce":
            y = fc.all_reduce(x, "sum", group)
        elif op == "all_gather_into_tensor":
            y = fc.all_gather_tensor(x, 0, group)
        elif op == "reduce_scatter_tensor":
            y = fc.reduce_scatter_tensor(x, "sum", 0, group)
        elif op == "all_to_all_single":
            y = fc.all_to_all_single(x, None, None, group)
        else:
            y = torch.empty(16, device="cuda")
            dist.all_gather_into_tensor(y, x)
        y = y.wait() if hasattr(y, "wait") else y
        torch.cuda.synchronize()
        q.put((rank, "ok", y.tolist()))
    except Exception as e:      # noqa: BLE001 — reported, not hidden
        q.put((rank, f"{type(e).__name__}: {e}", None))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_card_probe: no CUDA device", file=sys.stderr)
        return 1
    print(torch.__version__, torch.version.cuda)
    ctx = mp.get_context("spawn")
    for i, op in enumerate(OPS):
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank, args=(r, 29700 + i, op, q))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=60)
        got = []
        while not q.empty():
            got.append(q.get())
        print(op, "exit codes", [p.exitcode for p in procs], got,
              flush=True)
        for p in procs:
            if p.is_alive():
                p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
