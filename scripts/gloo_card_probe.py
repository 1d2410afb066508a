#!/usr/bin/env python3
"""Which collectives two gloo ranks sharing one CUDA card can run.

DTensor redistributes through ``torch.distributed._functional_collectives``;
two processes on one card cannot use NCCL (it takes one rank a card), so
they would have to use gloo, which stages CUDA tensors through the host.
This spawns a pair of gloo ranks on ``cuda:0`` for each collective in turn
(the four functional ones DTensor issues, c10d's own all-gather, and the
functional all-gather routed through c10d's by
``repro_torch.launch.mesh.share_card_gathers``, as ranks sharing a card
run it) and prints each pair's exit codes and results:

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
       "all_to_all_single", "c10d all_gather_into_tensor",
       "routed all_gather_into_tensor", "all_reduce (8, 512, 576)",
       "DTensor Partial to Replicate", "DTensor Shard to Replicate, routed")


def _rank(rank, port, op, q):
    import faulthandler
    faulthandler.enable()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    torch.cuda.set_device(0)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
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
        elif op == "routed all_gather_into_tensor":
            from repro_torch.launch.mesh import share_card_gathers
            share_card_gathers()
            y = fc.all_gather_tensor(x, 0, group)
        elif op == "all_reduce (8, 512, 576)":
            big = torch.ones(8, 512, 576, device="cuda") * (rank + 1)
            y = fc.all_reduce(big, "sum", group)
            y = y.wait() if hasattr(y, "wait") else y
            y = y.flatten()[:4]
        elif op.startswith("DTensor"):
            from torch.distributed.tensor import (DTensor, Partial,
                                                  Replicate, Shard)
            from repro_torch.launch.mesh import _mesh, share_card_gathers
            mesh = _mesh("cuda", (1, 2), ("data", "model"))
            if op.endswith("routed"):
                share_card_gathers()
                t = DTensor.from_local(x[None], mesh, [Replicate(), Shard(1)])
            else:
                t = DTensor.from_local(x[None], mesh,
                                       [Replicate(), Partial()])
            y = t.redistribute(mesh, [Replicate(), Replicate()]).to_local()
            y = y.flatten()
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
            p.join(timeout=30)
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
