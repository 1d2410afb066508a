#!/usr/bin/env python3
"""Run the PyTorch port's protocol sweeps and its token models on one
NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. card and build — print the card's name and power limit, build every CUDA
   kernel of ``src/repro_torch/kernels/csrc`` with ``nvcc`` (timed);
2. MEDIAN's kernels against their plain PyTorch versions on the card,
   integer-exact: the cut scan and the extremes scan at the smoke sweep's
   full-batch turn shape, the extremes scan at the sweep's widest turn, and
   crafted ties (duplicate points, bounds built from the points themselves,
   an absent class, all directions disallowed), and the cut scan at its
   edges (all-positive, all-negative and all-padding instances, points at
   ±0 against ±0 bounds, bounds on a point's own projection, ±inf bounds;
   n in {1, 33, 1001}, m in {1, 31, 33, 9000}, B=1); the extremes scan
   also in its two-segment form (stage 5's call: own rows and transcripts
   read where they lie), every output exact, at the full batch, B=1 and
   crafted segments (ties across the boundary, a class in one segment
   only, an empty node, W = 0, odd n and W); each kernel timed with CUDA
   events beside its plain version, the extremes scan (two segments, and
   one on the concatenation) also as device time, with its resident
   blocks;
2b. MAXMARG's kernels against their plain versions on the card, bit for
   bit: the turn scan and the Pegasos stage at the first MAXMARG bucket's
   full-batch turn-1 shape (the stage at nsteps=2000 and at the polish
   shape, t0=1024), the turn scan also at turn 1 of the k4_d2 and k2_d16
   buckets (d=16: its any-d path) and with max_support 12 or viol_ship 9
   (above its register list: more passes), the stage at d=16, both at
   the widest tail turn, and crafted inputs (duplicate rows, a row exactly
   on the band edge, a node without valid rows, an all-padding instance,
   instances that enter latched; the stage also at d=40, its wide path);
   each kernel timed beside its plain version (the turn scan also as
   device time, with its residency), the stage also at d=16;
3. the MEDIAN sweep through ``repro_torch.engine.run_sweep`` on the card,
   with every kernel's launch count set to 0 before it and read after;
   then the same sweep with CUDA events around every cut-scan call (the
   scan's share of the wall, and launches × gap from the per-call times
   and bounds) and around every stage 5 (``median.node_extremes``); the
   extremes (both forms, also as device time) and cut scans held and
   timed at the widest tail turn;
4. MEDIAN card against CPU on a 48-instance subset with noisy tail
   instances: integer outputs exact, separators to 1e-6;
5. the MAXMARG sweep (three buckets, one ``run_sweep`` call) on the card,
   launch counts read around it, outputs checked; then the same sweep
   with CUDA events around every call of the two MAXMARG kernels (each
   one's share of the wall), and both kernels held and timed at the widest
   tail turn (the turn scan also as device time);
6. MAXMARG card against CPU on 56 instances of it, the same solver path on
   both: comm, rounds and convergence exact, separator directions to a
   cosine of 1 - 1e-4;
7. the bulk scans' kernels (consistent-threshold ranges, set-of-uncertainty
   membership) against their plain versions, exactly, batched and at B=1,
   on crafted inputs (points on a band edge, an absent class, an
   all-padding transcript, no direction allowed; d=2 and d=3, the
   membership also at d=64 over 600 directions, more than its shared
   memory holds at once); then the SOU diagnostics path
   (``dataplane.ranges`` / ``dataplane.uncertain``) on the MEDIAN smoke
   sweep's final state at the full batch, launch counts read around it:
   every node's rescan equals the ranges the engine kept at append time,
   and both kernels equal their plain versions there (the membership also
   at B=1 and B=24, below one wave); both timed, the membership also as
   device time at B=3072 and B=1, with its residency and its test round's
   SASS instructions;
8. the one-way sweep through ``run_sweep`` (launch counts read around it):
   RANDOM / NAIVE / VOTING / MIXING over the JAX one-way benchmark's grid
   and a k=4 RANDOM bucket; closed-form metering checked, the ε gate
   counted;
9. the mixed one-way-vs-two-way gap sweep (NAIVE, RANDOM, MEDIAN and
   MAXMARG on the same shards in one ``run_sweep``), launch counts read
   around it, the points each family ships printed per scenario;
10. one-way card against CPU on 48 instances: comm, rounds and sample sizes
   exact, the terminal fit set of RANDOM bit for bit, separators to the
   cosine tier (the card runs the solver's kernel path, the CPU its classic
   loop, as in the JAX package);
11. the flash-attention kernels against their plain version, each call
   through the route ``attention_route`` names (checked by the per-route
   count): ``tc`` at smollm-135m's scoring shape, whisper-medium's encoder,
   qwen2.5-14b's heads and the crafted cases in bf16 (window 128, kv_valid
   under one tile, MQA, ragged Sq 100 against Skv 1500, kv_valid 0);
   ``splitkv`` at Sq 1 and 4 in f32 and bf16 (whisper's cross-attention,
   GQA G 8 with kv_valid, Skv 1500 and 1, hd 32 and 256, a window);
   ``simt`` at the scoring shape and the crafted cases in f32 and bf16 at
   hd 32 and 256: f32 to atol 1e-5, bf16 to rtol = atol = 2e-2 in f32;
   each route timed beside its plain version and
   ``scaled_dot_product_attention`` (the library figure), also as device
   time (CUDA-graph replay): ``tc`` and ``simt`` at the scoring shape,
   ``splitkv`` at whisper's decode-time cross-attention;
12. path A, smollm-135m at full width under the kernel backend:
   ``forward_train`` over a ``synthetic_stream`` batch (B=8, S=2048, bf16),
   exactly 30 kernel launches, all ``tc``, the loss within 2e-2 of the
   plain pass, tokens/s and the kernel's share; then its
   ``TokenServingEngine`` (B=8, prompt 512, cache 1024, 64 greedy tokens),
   where no kernel runs;
13. path B, whisper-medium at full width served (B=8, 1500 encoder frames,
   prompt 4, cache 448, 64 greedy tokens, bf16): exactly 48 + 24 x 64
   launches (24 ``tc`` for the encoder, 24 + 24 x 64 ``splitkv``), prefill
   ms and ms per token, beside the plain backend; then card against CPU
   in f32 with the same weights (smollm-135m B=1 S=128: loss to 1e-5 and 8
   greedy tokens; whisper-medium with 256 frames: 8 tokens), tokens equal
   unless the CPU's top two logits lie within 1e-4, its launches counted
   (54 ``simt``, 216 ``splitkv``);
14. the SSM kernels (the WKV recurrence, the selective scan) against their
   plain versions, y and the final state to max |diff| <= 1e-5 ×
   max(1, max |plain|) in f32 (1e-2 for bf16 y), the scan's final state
   also bit for bit (``torch.equal``): at rwkv6-7b's and Jamba's scoring
   shapes (the scan in bf16 and f32; WKV in f32 and as path C passes it,
   bf16 r, k, v with f32 w), decode (S 1 with a carried state, written in
   place; both input types, the scan also at B 1), S 100, S 1 at B 1, hd
   32, the scan at S 31 and 33 (ragged against its chunk) and di 1000 and
   1001 (ragged against its 128-channel block; 1001 stages scalar), and
   the decay extremes 0.02 and 0.999; the
   flash-attention kernel at the scoring shapes of Jamba (H 64, KV 8),
   grok-1 (H 48, KV 8) and qwen2-vl-2b (H 12, KV 2; each hd 128, B 8,
   S 2048, bf16, causal; ``tc``), held and timed; each scan timed at its path's
   shape and at decode beside
   its plain version and its bound (bytes, or operations with the scan's
   exponentials split between the special-function units and FMA-pipe
   polynomials), WKV in path C's dtypes (and in f32, printed), both at
   scoring and decode also as device time (CUDA-graph replay), the scan
   at prefill's shape (B 8, S 512), with its resident blocks, its waves
   at the scoring shape and its step loop's instructions counted in its
   SASS (``cuobjdump``);
15. path C, rwkv6-7b at full width and depth in bf16: ``forward_train``
   (B=8, S=2048), exactly 32 WKV launches, tokens/s and the kernel's
   share; its ``TokenServingEngine`` (B=8, prompt 512, cache 1024, 64
   greedy tokens), exactly 32 + 32 × 64 launches;
16. path D, Jamba without experts (``jamba_dense``) in bf16: scoring under
   the kernel backend (exactly 7 scan and 1 attention launches, the
   attention ``tc``, the scans' share) and serving (exactly 7 + 7 × 64
   scan launches, no attention launch: the attention layer has a cache);
   then card against CPU in f32 with the same weights at full width cut to
   two layers (rwkv6-7b; Jamba's ``(mamba, mlp), (attn, mlp)``), B=1,
   prompt 32: loss to 1e-5 and 8 greedy tokens under phase 13's tie rule;
17. the unified dispatch and the protocol service (``unified_phase``):
   17a the interleaved MEDIAN / MAXMARG / SAMPLING grid of
   ``unified_instances`` through one ``run_sweep(unified_dispatch=True)``
   and again bucketed, launch counts read around the unified call (the
   cut, extremes and turn scans and the Pegasos stage must launch): MEDIAN
   rows bit for bit, the others exact in comm, rounds, convergence,
   sample sizes and warm latches and to a cosine of 1 - 1e-4, every
   instance's error within ε + 2/n; the unified sweep again at each width
   policy (linear, geometric, geometric, linear; the same tiers against
   the geometric run) with the walls printed beside the bucketed one; the
   kernel calls of the counted unified run are recorded (``_recording``)
   and, for each wrapper, batch size and option set, the widest is
   replayed against its plain version on its inputs, every output exact
   (``_hold_calls``); 17b ``ProtocolService`` over a unified 1024-slot pool
   (``POOL``) with 3072 sessions, each node's 1000 points streamed through
   ``open`` / ``feed`` (4 batches) / ``close`` while the pool runs:
   fault-free, twice under ``POOL_CHAOS``, and fault-free with a
   checkpoint at half the first run's pool turns restored into a fresh
   service — survivors, the second chaos run and the restored run bit for
   bit the fault-free one, quarantined sessions with a reason and no
   result, one launch shape in ``hotloop.KEY_LOG``, launch counts read
   around the four runs; every kernel call of fault-free pool turn
   ``POOL_HOLD_TURN`` (the full 1024-row block at the 1712-wide cap)
   replayed against its plain version, every output exact; sessions/s,
   pool turns and the median ms a pool turn (CUDA-synchronised host
   clock) and the dispatch's share of it printed per run; 17c 24 sessions through ``POOL_SMALL`` pools on the
   card and the CPU, the classic solver loop on both: statuses, comm,
   rounds and convergence exact, MEDIAN to 1e-6, the others to the cosine
   tier;
18. the sharded B axis and the two-way host protocols: 18a
   (``sharded_phase``) the MEDIAN smoke grid (B=3072, and B=3070: born-done
   padding where S does not divide it) and MAXMARG's first bucket (B=1152)
   through ``run_sweep(mesh=...)`` over ``make_data_mesh()`` (every card)
   and over 2 and 4 logical shards on one card, each run bit for bit the
   unsharded result of phase 3 or 5 (MAXMARG without double buffering, as
   phase 5 ran, and once at the mesh default against an unsharded run with
   it), the four turn-loop kernels' launches counted per run, ``stats``
   and the walls printed beside an unsharded run's; the dispatch settings
   timed against each other (``shard_settings``: unsharded, S=1 and S=4
   on one card, donation off and on); and one 4-shard run of each
   recorded (``_turn_gate``), every kernel call of its first full-batch
   turn (MEDIAN's first two) and of its first sub-batch turn replayed
   against the plain versions at the shapes each shard gave it, every
   output exact; 18b
   (``two_way_phase``) ``iterative_support_median_bit`` on data1/2/3 at
   n_per_node=1000, 1024 angles, ε=0.05, and on data3 with 5% label noise
   at ε=0.02 (all 64 rounds), every ``threshold_ranges_one`` call recorded
   and replayed against the plain version (lo and hi exact), card against
   CPU (comm, rounds and convergence exact, separators to 1e-6); 18c
   ``iterative_support_noisy`` at ``examples/noisy_protocol.py``'s sizes
   (data3, n_per_node=500, 5% and 10% noise), every B=1 Pegasos stage
   recorded and replayed against the plain stage bit for bit, card against
   CPU as in 18b (``best_err`` exact too);
19. the MoE, MLA and VLM families (``families_phase``), each at its
   published widths in bf16 under the kernel backend, weights drawn on
   the card, freed before the next: 19a grok-1 cut to 2 layers
   (``forward_train`` B=8 S=2048, exactly 2 attention launches, both
   ``tc``; serving B=8, prompt 512, cache 1024, 64 greedy tokens, no
   launch, every decoded token's MoE on the gather path); 19b DeepSeek-V2
   cut to 2 layers (scoring B=4 S=2048 and serving, no launch: MLA passes
   an explicit scale), served with the faithful and the absorbed decode,
   then the two decodes fed the same tokens in lockstep (their caches
   stay equal), every step's logits compared: in bf16 printed (a
   rounding can move one of 160 experts' top-6 picks, and the output with
   it), in f32 at the same widths held: a pick may differ only where
   either run's top two logits lie within 2e-3; 19c Jamba with its
   experts (``jamba_moe``: in-period layers 4-5, one MoE layer of 16
   experts), scoring exactly 1 ``tc`` and 1 scan launch, serving 1 + 64
   scans and no attention launch; 19d qwen2-vl-2b at full width and depth,
   64 patch embeddings spliced over the first positions with M-RoPE ids on
   a patch grid (scoring exactly 28 ``tc`` launches, serving none); each
   with tokens/s, prefill ms, ms a token and the MoE FFN's share of a
   scoring pass from CUDA events (qwen2-vl: the attention kernel's, its
   device time at that shape from phase 14 over the pass); 19e
   ``moe.route`` card against CPU in f32 at grok-1's and DeepSeek-V2's
   full width, B=8 S=512 (capacity 160 and 24, slots dropped): expert
   ids, ``keep`` and ``dest`` equal (on the batch rows where no pick
   differs, at least half of them), a pick differing only at a near-tie
   (adjacent top-(k+1) probabilities within 1e-6 on the CPU), gates to
   1e-5 and the aux loss to rtol 1e-5; 19f card
   against CPU in f32 with the same weights (grok-1 and DeepSeek-V2 at one
   layer, qwen2-vl at two; B=1, prompt 32): loss to 1e-5 and 8 greedy
   tokens under phase 13's tie rule, DeepSeek-V2 in both decodes,
   exactly 3 ``simt`` launches;
20. training (``training_phase``) through ``repro_torch.train``, the plain
   attention (the flash kernel has no backward): 20a smollm-135m at full
   width and depth, ``Trainer`` B=8 S=2048 bf16 over f32 masters, 20 steps
   (every loss and gradient norm finite, the loss falling; median step,
   training tokens/s, peak memory), then from the same weights
   ``RunFlags(remat=True)`` (step-1 loss equal, peak memory lower),
   microbatches 1 and 2 in f32 one update apart at JAX's tier (and every
   first moment within ``MB_MU_TOL`` of its leaf's scale), a checkpoint
   saved, loaded into a fresh trainer and two more steps equal to two
   more without the reload, and ``python -m
   repro_torch.launch.train`` in-process (5 steps, f32); 20b rwkv6-7b and
   20c Jamba without experts (``(mamba, mlp), (attn, mlp)``) at every
   published width, 2 layers, bf16, 3 steps: exactly 2 WKV and 1 scan
   launches a step (the forward's; the chunked backward launches none),
   gradients finite; 20d every leaf's gradient card against CPU in f32
   (rwkv6-7b and that Jamba at full width, grok-1 and DeepSeek-V2
   reduced; B=1 S=128, two chunks of the scans' backward) within
   ``GRAD_TOL`` of its scale, losses to 1e-5; 20e the raw ``rwkv6``,
   ``mamba_scan`` and ``attention`` wrappers raise on an input that
   requires a gradient;
21. the model stack on a ("data", "model") mesh (``mesh_phase``): 21a
   smollm-135m at full size through the mesh path on one NCCL rank (mesh
   (1, 1), pure data parallel), 3 steps of 20a's ``Trainer``, losses bit
   for bit 20a's, peak memory beside 20a's; 21b one NCCL rank a card on
   every card, spawned (``_mesh_rank``, progress in
   ``build/phase21/rank<r>.log``): rwkv6-7b at 2 layers (and on
   more than one card smollm-135m) trained 3 steps on each mesh of
   ``_mesh_shapes``, losses bit for bit 21a's / 20b's on one card and
   within ``MESH_LOSS_TIER`` of them on more, WKV launches per rank a
   step equal to one rank's; scoring under the
   flash kernel (smollm-135m, Jamba without experts at two layers:
   attention and scan launches per rank), every recorded call of the
   three kernels replayed against its plain version; 21c the planner:
   ``dryrun.plan_case`` of 21a's case on a (1, 1) mesh of a fake process
   group, its argument bytes exactly 21a's tensors', its peak and FLOPs
   printed beside 21a's measured peak and ``model_flops_estimate``.  The
   planner's whole sweep (``python -m repro_torch.launch.dryrun --arch
   all --shape all --mesh both``) needs no card and is not run here: it
   would load the host's cores under the timed phases;
22. the analysis tooling and the examples: 22a every entry of the
   committed tuning cache for this card (``tuning_phase``): the tuned
   kernel at its bucket's main-path shape under the cached plan and under
   its own, bit for bit each other and equal to the plain version, both
   device times beside the bound; 22b the five ``examples_torch`` scripts
   (``examples_phase``) once each on the card at their reduced sizes
   (memory allocated on the card and kernel launches counted: a CPU
   fallback fails); 22c ``plan_cost``'s dot FLOPs, fused bytes and top
   five collectives of 21c's plan.  Every bound this script prints comes
   from ``repro_torch.analysis.bounds``.

Unified and service config: the MAXMARG smoke's settings (below) over
data1/2/3 × ε ∈ {0.05, 0.02, 0.01} at n_per_node=1000, k=2, 1024 angles,
the three families interleaved (B=1152), plus
``data_mixed_hardness(n_per_node=100, k=4)`` × ε ∈ {0.05, 0.02} (B=192);
the service's sessions are the same kind of traffic, 1024 a family, into
``PoolConfig(selector="unified", slots=1024, k=2, n_pad=1000,
n_angles=1024, max_epochs=8, admit_block=64, res_cap=1712)`` (1712 rows
hold the ε=0.01 SAMPLING sessions' ε-net).

MEDIAN smoke config: the shape of the JAX package's engine benchmark grid
(``benchmarks/engine_sweep.py``: data1/2/3 × ε ∈ {0.2, 0.1, 0.05, 0.025},
k=2, n_per_node=1000, 1024 angles, 32 epochs), widened to 256 seeds
(B=3072), with every 24th instance given 10% label noise and ε=0.02 so 128
sessions run the whole 64-turn budget on the compacted hot path.

MAXMARG smoke config: the JAX MAXMARG benchmark's settings
(``benchmarks/maxmarg_sweep.py``: max_epochs=8, max_support=4, steps=2000,
stages=3, λ=1e-3) over three buckets — k=2 d=2 B=1152 (its
``build_instances`` grid, data1/2/3 × ε ∈ {0.05, 0.02, 0.01}, at
n_per_node=1000 over seeds 0–127, every 24th instance with 10% label noise
and ε=0.02), k=4 d=2 B=128 (``data_mixed_hardness(n_per_node=100, k=4)`` ×
ε ∈ {0.05, 0.02} over seeds 0–63) and k=2 d=16 B=64
(``data_highd(n_per_node=200, d=16, margin=0.2)`` at ε=0.05, seeds 0–63).

One-way smoke config: ``benchmarks/baselines_sweep.py``'s grid (4 selectors
× data1/2/3 × ε ∈ {0.1, 0.05}) at n_per_node=1000 over seeds 0–63 (B=1536)
plus ``data_mixed_hardness(n_per_node=100, k=4)`` × ε ∈ {0.05, 0.02} over
seeds 0–63 for RANDOM (B=128, three chain hops); default solver settings
(steps=2000, stages=3, λ=1e-3).  Gap sweep: ``_gap_sweep``'s shape (NAIVE,
RANDOM, MEDIAN, MAXMARG on the same shards; data1/2/3 × ε ∈ {0.1, 0.05};
max_epochs=8) at n_per_node=1000 over seeds 0–15 (B=384).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``nvidia-smi`` name and power limit, and before that
one JSON line with every kernel's launches, error and times (phase 21's
mesh paths included in the launches and errors).

Token models: smollm-135m (``configs/smollm_135m.py``, 134.5 M parameters)
and whisper-medium (``configs/whisper_medium.py``, 811.0 M), full width
and depth; rwkv6-7b (``configs/rwkv6_7b.py``: 32 layers, d 4096, 64 WKV
heads of 64, d_ff 14336, vocab 65536), full width and depth; Jamba
without experts (``configs/jamba_1_5_large_398b.py`` at every published
width, cut to one period of its 9 and with each MoE FFN replaced by a
dense SwiGLU of d_expert's 24576: one period of the MoE model holds four
layers of 16 experts, over 80 GB in bf16).  Random weights from a seeded
generator on the card.  Phase 19: grok-1 (``configs/grok_1_314b.py``)
and DeepSeek-V2 (``configs/deepseek_v2_236b.py``) at every published
width cut to 2 layers (~11.4 B and ~9.3 B parameters with their
untied embeddings and heads), Jamba with its experts (``jamba_moe``, ~11.9
B) and qwen2-vl-2b (``configs/qwen2_vl_2b.py``) at full width and depth.
Phase 20 trains smollm-135m at full width and depth, rwkv6-7b (~0.94 B
parameters by ``param_count``) and Jamba without experts (~2.85 B) at
every published width cut to 2 layers, weights drawn on the card in f32.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

SMOKE = dict(B=3072, n_per_node=1000, n_angles=1024, max_epochs=32,
             noisy_every=24)
SUBSET = 48            # card-against-CPU instances (two of them noisy)
OW_SUBSET = (10, 8)    # one-way card against CPU: per k=2 selector, k=4
MAXMARG = dict(max_epochs=8, max_support=4, steps=2000, stages=3, lam=1e-3)
MM_SUBSET = (48, 8)    # MAXMARG card-against-CPU: bucket 1 and bucket 2
ONEWAY = dict(steps=2000, stages=3, lam=1e-3)   # the one-way solver options
COS_TOL = 1e-4         # the reference's own warm-vs-cold direction tier
SCORING = dict(arch="smollm-135m", B=8, S=2048)          # path A
SERVE_SMOLLM = dict(B=8, prompt=512, cache_len=1024, tokens=64)
# whisper-medium serving: 1500 encoder frames (Whisper's 30 s window,
# arXiv:2212.04356), a 4-token decoder prompt, the decoder's 448 positions
SERVE_WHISPER = dict(B=8, enc_len=1500, prompt=4, cache_len=448, tokens=64)
ATTN_TOL = {"float32": (0.0, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol)
RWKV = dict(arch="rwkv6-7b", B=8, S=2048)                # path C scoring
JAMBA = dict(B=8, S=2048)                                # path D scoring
SERVE_SSM = dict(B=8, prompt=512, cache_len=1024, tokens=64)   # C and D
# the SSM scans, kernel against plain: max |diff| <= tol * max(1, max |plain|)
# per output; the states are f32 in either input type
SSM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# phase 19: the MoE, MLA and VLM families at their published widths in bf16,
# depth cut (grok-1 and DeepSeek-V2 to 2 layers, Jamba to in-period layers
# 4-5 with its experts); scoring shapes, then serving at SERVE_FAMILIES
FAMILY_SCORING = {"grok-1-314b": dict(layers=2, B=8, S=2048),
                  "deepseek-v2-236b": dict(layers=2, B=4, S=2048),
                  "jamba": dict(B=8, S=2048),
                  "qwen2-vl-2b": dict(B=8, S=2048)}
SERVE_FAMILIES = dict(B=8, prompt=512, cache_len=1024, tokens=64)
ROUTE_SHAPE = dict(B=8, S=512)     # 19e: prefill's routing, card against CPU
# phase 20: training (bf16 over f32 masters); 20d card against CPU in f32
TRAIN_SMOLLM = dict(arch="smollm-135m", B=8, S=2048, steps=20, warmup=2,
                    lr=1e-3)
TRAIN_RWKV = dict(layers=2, B=4, S=2048, steps=3)
TRAIN_JAMBA = dict(B=2, S=2048, steps=3)
TRAIN_CHECK = dict(B=1, S=128)     # two 64-token chunks of the scans
GRAD_TOL = 2e-5       # 20d: max |g_card - g_cpu| <= GRAD_TOL max(1, max |g|)
MB_MU_TOL = 1e-5      # 20a: first moments of microbatches 1 and 2, of scale
ABSORB_TIE = 2e-3     # tests/test_mla_absorb.py's tier for the two decodes
# phase 21: the model stack on a ("data", "model") mesh.  21b's jobs
# (``_mesh_jobs``) train as 20a (smollm-135m) and 20b (rwkv6-7b at 2
# layers) do, over NCCL, one rank a card, on every card; then scoring under
# the flash kernel (smollm-135m, and Jamba without experts at two layers:
# the scan and attention kernels per rank).  Two ranks cannot share a card
# here: NCCL takes one rank a card, and gloo's functional all-gather on
# CUDA tensors, which DTensor issues, ends the process (torch 2.11; the
# CPU tests train on two gloo ranks instead)
MESH_STEPS = 3
MESH_SCORING = dict(jamba_B=2, S=2048)
# 21b's losses on more than one card against one rank's, relative (on one
# card, mesh (1, 1), they are bit for bit).  The first step's (the same
# weights, sums in another order): the microbatch tier of
# tests/test_torch_train.py.  Later steps' in bf16, after updates whose
# tiny-gradient entries turn on the gradients' last bits: on four H100s
# (before AdamW reduced each gradient into its moments' layout) the first
# steps read at most 4.81e-6 and the later ones at most 1.71e-4
MESH_LOSS_TIER = (1e-5, 1e-3)
FAMILIES = ("median", "maxmarg", "sampling")   # the unified dispatch's mix
# phase 17b: a unified pool at a service's size; res_cap holds the ε=0.01
# SAMPLING sessions' 1711-row ε-net (the default sizes it at eps=0.05)
POOL = dict(selector="unified", slots=1024, k=2, d=2, n_pad=1000,
            n_angles=1024, max_epochs=8, admit_block=64, res_cap=1712)
POOL_SESSIONS = 3072
POOL_STREAM = dict(chunk=256, batches=4)   # sessions closed a pool turn
POOL_HOLD_TURN = 6     # the fault-free pool turn replayed kernel by kernel
# tests/test_session_pool.py's chaos schedule
POOL_CHAOS = dict(seed=3, p_dropout=0.08, p_drop_msg=0.04, p_straggle=0.08,
                  p_corrupt=0.03)
# phase 17c: card against CPU, the same (classic) solver loop on both
POOL_SMALL = dict(selector="unified", slots=8, k=2, d=2, n_pad=64,
                  n_angles=256, max_epochs=8, solver_kernel=False)


def smoke_instances(B, n_per_node, noisy_every, engine, datasets):
    """The smoke grid: instance i is data{1,2,3}[i % 3] at ε[(i // 3) % 4],
    seed i // 12; every ``noisy_every``-th gets 10% label noise, ε=0.02."""
    gens = (datasets.data1, datasets.data2, datasets.data3)
    epss = (0.2, 0.1, 0.05, 0.025)
    out = []
    for i in range(B):
        shards = gens[i % 3](n_per_node=n_per_node, k=2, seed=i // 12)
        eps = epss[(i // 3) % 4]
        if i % noisy_every == 0:
            shards = datasets.add_label_noise(shards, 0.1, seed=i)
            eps = 0.02
        out.append(engine.ProtocolInstance(shards, eps))
    return out


def crafted_cut_inputs(V, device, seed=0):
    """Cut-scan inputs built to sit on every tie the scan has: duplicate
    points, bounds built by the port's own ``_append2`` from the scanned
    points (so their projections equal lo/hi exactly), an instance with no
    positive points, a padding-only instance, and one with every direction
    disallowed.  Returns ``(V, dir_ok, lo, hi, X, y)``."""
    import torch
    from repro_torch.engine.median import _append2

    rng = np.random.default_rng(seed)
    m = V.shape[0]
    B, n = 6, 64
    X = rng.normal(size=(B, n, 2)).astype(np.float32)
    y = np.where(rng.random((B, n)) < 0.5, 1, -1).astype(np.int32)
    X[:, 32:48] = X[:, 0:16]                  # duplicates, same labels
    X[:, 48:56] = X[:, 16:24]                 # duplicates, flipped labels
    y[:, 48:56] = -y[:, 16:24]
    y[2] = -1                                 # no positive class
    y[3] = 0                                  # padding only
    y[:, 60:] = 0                             # padding rows in every one
    dir_ok = rng.random((B, m)) < 0.8
    dir_ok[4] = False                         # every direction disallowed
    t = lambda a: torch.from_numpy(a).to(device)
    Vd = V.to(device)
    lo = torch.full((B, m), -np.inf, device=device)
    hi = torch.full((B, m), np.inf, device=device)
    # the bounds of a transcript holding rows 0..7 of each instance
    dummy_w = torch.zeros((B, 16, 2), device=device)
    dummy_y = torch.zeros((B, 16), dtype=torch.int32, device=device)
    fill = torch.zeros(B, dtype=torch.int32, device=device)
    for r in range(0, 8, 2):
        _append2(dummy_w, dummy_y, fill, lo, hi, t(X[:, r:r + 2].copy()),
                 t(y[:, r:r + 2].copy()),
                 torch.ones(B, dtype=torch.bool, device=device), Vd)
    return Vd, t(dir_ok), lo, hi, t(X), t(y)


def edge_cut_inputs(geometry, device, B, m, n, seed=0):
    """Cut-scan inputs at the kernel's edges: an all-positive, an
    all-negative and an all-padding instance (when B allows), points at ±0
    against bounds of ±0, bounds equal to a point's own projection (made
    with the scan's rounding), ±inf bounds and disallowed directions, at
    any (B, m, n).  Returns ``(V, dir_ok, lo, hi, X, y)``."""
    import torch

    rng = np.random.default_rng(seed)
    V = geometry.direction_grid(m, device=device)
    X = rng.normal(size=(B, n, 2)).astype(np.float32)
    y = np.where(rng.random((B, n)) < 0.5, 1, -1).astype(np.int32)
    zeros = np.array([[0.0, 0.0], [-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0]],
                     np.float32)
    X[:, :min(4, n)] = zeros[:min(4, n)]
    if n > 8:
        y[:, -3:] = 0                             # padding rows
    for b, lab in zip(range(1, B), (1, -1, 0)):   # one label, or padding
        y[b] = lab
    c = rng.normal(scale=0.5, size=(B, m)).astype(np.float32)
    w = rng.uniform(-0.5, 1.5, size=(B, m)).astype(np.float32)
    lo, hi = c - w / 2, c + w / 2                 # some bands empty
    lo[:, 0::7], hi[:, 1::11] = -np.inf, np.inf
    lo[:, 3::13], hi[:, 5::13], lo[:, 6::13] = 0.0, -0.0, -0.0
    hi[:, 8::13] = 0.0
    dir_ok = rng.random((B, m)) < 0.8
    t = lambda a: torch.from_numpy(a).to(device)
    X, lo, hi = t(X), t(lo), t(hi)
    # a band edge on a point's own projection, rounded as the scan rounds
    pt = X[:, min(5, n - 1)]
    proj = V[:, 0] * pt[:, :1] + V[:, 1] * pt[:, 1:]        # (B, m)
    lo[:, 1::9], hi[:, 2::9] = proj[:, 1::9], proj[:, 2::9]
    return V, t(dir_ok), lo, hi, X, t(y)


def maxmarg_buckets(datasets, engine):
    """The MAXMARG smoke sweep's three buckets as ``(name, instances)``;
    the first bucket's noisy instances are every 24th."""
    gens = (datasets.data1, datasets.data2, datasets.data3)
    b1 = []
    for i in range(1152):
        shards = gens[i % 3](n_per_node=1000, k=2, seed=i // 9)
        eps = (0.05, 0.02, 0.01)[(i // 3) % 3]
        if i % 24 == 0:
            shards = datasets.add_label_noise(shards, 0.1, seed=i)
            eps = 0.02
        b1.append(engine.ProtocolInstance(shards, eps, "maxmarg"))
    b2 = [engine.ProtocolInstance(
        datasets.data_mixed_hardness(n_per_node=100, k=4, seed=i // 2),
        (0.05, 0.02)[i % 2], "maxmarg") for i in range(128)]
    b3 = [engine.ProtocolInstance(
        datasets.data_highd(n_per_node=200, k=2, d=16, seed=i, margin=0.2),
        0.05, "maxmarg") for i in range(64)]
    return [("k2_d2", b1), ("k4_d2", b2), ("k2_d16", b3)]


def crafted_turn_inputs(device, seed=0):
    """Turn-scan inputs built to sit on every tie the scan has, as
    ``(w, b, K, yK, X, y)``: instance 0 has margins that are exact copies
    of the first coordinate (w = (1, 0), b = 0), one row exactly on the
    band edge max(min margin, 1e-12)·f32(1.15) and one a step beyond it;
    instance 1 has equal margins many times over (rank ties broken by
    index) in its fit set and its shards; instance 2 a node without valid
    rows; instance 3 is padding only; instance 4 misclassifies its fit set
    (the band edge clamps to 1e-12); instance 5 is in general position."""
    import torch

    rng = np.random.default_rng(seed)
    B, N, k, n, d = 6, 64, 3, 40, 2
    w = rng.normal(size=(B, d)).astype(np.float32)
    b = rng.normal(size=B).astype(np.float32)
    K = rng.normal(size=(B, N, d)).astype(np.float32)
    yK = np.where(rng.random((B, N)) < 0.5, 1, -1).astype(np.int32)
    X = rng.normal(size=(B, k, n, d)).astype(np.float32)
    y = np.where(rng.random((B, k, n)) < 0.5, 1, -1).astype(np.int32)
    yK[:, -6:] = 0                            # padding rows in every one
    y[:, :, -4:] = 0
    for i in (0, 1):
        w[i], b[i] = (1.0, 0.0), 0.0          # margin = y * x0 exactly
    # instance 0: the band edge
    edge = np.float32(0.5) * np.float32(1.15)
    m0 = rng.uniform(1.0, 3.0, N).astype(np.float32)
    m0[:4] = (0.5, edge, np.nextafter(edge, np.float32(np.inf)), edge)
    K[0, :, 0] = yK[0] * m0
    yK[0, :4] = np.where(yK[0, :4] == 0, 1, yK[0, :4])
    K[0, :4, 0] = yK[0, :4] * m0[:4]
    # instance 1: repeated margins in the fit set and the shards
    K[1, :, 0] = yK[1] * rng.choice(
        np.array([0.75, 0.75, 1.0, 1.25], np.float32), N)
    X[1, :, :, 0] = y[1] * rng.choice(
        np.array([-0.5, -0.5, -0.25, 1.0], np.float32), (k, n))
    y[2, 1] = 0                               # a node without valid rows
    yK[3], y[3] = 0, 0                        # padding only
    K[4] = -yK[4, :, None] * np.abs(K[4]) * np.sign(w[4])   # all wrong
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(w), t(b), t(K), t(yK), t(X), t(y)


def crafted_pegasos_inputs(device, seed=0, d=3):
    """Pegasos-stage inputs with the edge cases of the latch, as ``(X, y,
    nv, w, b, lam, found, w_best, b_best)``: a separable instance with a
    margin, one that enters latched, one of padding only, one with
    duplicate rows, one with random labels (never separable) and one with
    half its rows padding; N spans ten rows per lane of the kernel's warp.
    ``d`` above 16 takes the kernel's wide path."""
    import torch

    rng = np.random.default_rng(seed)
    B, N = 6, 300
    X = rng.normal(size=(B, N, d)).astype(np.float32)
    w_true = rng.normal(size=(B, d)).astype(np.float32)
    proj = np.einsum("bnd,bd->bn", X, w_true)
    y = np.where(proj > 0, 1.0, -1.0).astype(np.float32)
    X += (0.3 * y[..., None] * w_true[:, None, :]
          / np.linalg.norm(w_true, axis=1)[:, None, None]).astype(np.float32)
    y[2] = 0.0                                # padding only
    X[3, 150:] = X[3, :150]                   # duplicate rows
    y[3, 150:] = y[3, :150]
    y[4] = np.where(rng.random(N) < 0.5, 1.0, -1.0)   # not separable
    y[5, ::2] = 0.0                           # half padding
    nv = np.maximum((y != 0).sum(axis=1), 1).astype(np.float32)
    w = np.zeros((B, d), np.float32)
    b = np.zeros(B, np.float32)
    lam = np.full(B, 1e-2, np.float32)
    found = np.zeros(B, bool)
    found[1] = True                           # enters latched
    w_best = rng.normal(size=(B, d)).astype(np.float32)
    b_best = rng.normal(size=B).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return tuple(t(a) for a in (X, y, nv, w, b, lam, found, w_best, b_best))


def crafted_extremes_inputs(device, seed=0):
    """Extremes-scan inputs with ties on both classes: every row duplicated
    (the first of two equal extremes must win), a node without positives
    and a padding-only node.
    Returns ``(v, XW, yW)``."""
    import torch

    rng = np.random.default_rng(seed)
    B, k, nW = 5, 3, 70
    ang = rng.uniform(0, 2 * np.pi, B)
    v = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    XW = rng.normal(size=(B, k, nW, 2)).astype(np.float32)
    yW = np.where(rng.random((B, k, nW)) < 0.5, 1, -1).astype(np.int32)
    XW[:, :, 40:60] = XW[:, :, 0:20]          # every row twice
    yW[:, :, 40:60] = yW[:, :, 0:20]
    yW[:, 1] = np.where(yW[:, 1] == 1, 0, yW[:, 1])   # node 1: no positives
    yW[:, 2] = 0                                       # node 2: padding only
    t = lambda a: torch.from_numpy(a).to(device)
    return t(v), t(XW), t(yW)


def crafted_segment_inputs(device, seed=0, n=41, width=45, cap=48, B=5):
    """Two-segment extremes inputs ``(v, X, y, wx, wy, width)``: every
    transcript starts with a copy of its node's own rows, so the extremes
    tie across the segment boundary (the own row must win); instance 0's
    node 1 has its +1 rows in the transcript only, instance 1's node 0 its
    rows in its own segment only, instance 2's node 2 no rows at all;
    labels past ``width`` are live (the scan must not read them).  An odd
    ``n`` or ``width`` starts rows at every alignment."""
    import torch

    rng = np.random.default_rng(seed)
    k = 3
    ang = rng.uniform(0, 2 * np.pi, B)
    v = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    X = rng.normal(size=(B, k, n, 2)).astype(np.float32)
    y = np.where(rng.random((B, k, n)) < 0.5, 1, -1).astype(np.int32)
    y[:, :, n - n // 8:] = 0                  # padding rows
    wx = rng.normal(size=(B, k, cap, 2)).astype(np.float32)
    wy = np.where(rng.random((B, k, cap)) < 0.5, 1, -1).astype(np.int32)
    c = min(n, width)
    wx[:, :, :c], wy[:, :, :c] = X[:, :, :c], y[:, :, :c]
    y[0, 1] = np.where(y[0, 1] == 1, -1, y[0, 1])       # +1 rows only in
    wy[0, 1, :c] = y[0, 1, :c]                          # the transcript
    wy[0, 1, c:width] = 1
    wy[min(1, B - 1), 0] = 0                            # own rows only
    y[min(2, B - 1), k - 1] = 0                         # no rows at all
    wy[min(2, B - 1), k - 1] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(v), t(X), t(y), t(wx), t(wy), width


def crafted_scan_inputs(device, seed=0, d=2, m=200):
    """Bulk-scan inputs on every edge the scans have, as ``(V, dir_ok, lo,
    hi, X, y, Xw, yw)``: the transcript ``(Xw, yw)`` is made of rows of the
    shard (and the shard holds copies of them), and ``(lo, hi)`` are the
    plain ranges of that transcript, so points sit exactly on band edges;
    instance 1's transcript has no positive class, instance 2's is padding
    only, instance 3 allows no direction, instance 4's shard is padding
    only; padding rows in every shard and transcript."""
    import torch
    from repro_torch import kernels

    rng = np.random.default_rng(seed)
    B, n, nw = 6, 70, 24
    V = rng.normal(size=(m, d))
    V = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    X = rng.normal(size=(B, n, d)).astype(np.float32)
    y = np.where(rng.random((B, n)) < 0.5, 1, -1).astype(np.int32)
    X[:, 40:50] = X[:, 0:10]                  # copies of transcript rows
    y[:, 40:50] = y[:, 0:10]
    y[:, -6:] = 0                             # padding rows in every shard
    y[4] = 0                                  # a shard of padding only
    Xw, yw = X[:, :nw].copy(), y[:, :nw].copy()
    yw[:, 20:] = 0                            # the unfilled tail
    yw[1] = np.where(yw[1] == 1, -1, yw[1])   # no positive class
    yw[2] = 0                                 # padding only
    dir_ok = rng.random((B, m)) < 0.8
    dir_ok[3] = False                         # no direction allowed
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    Vt, Xwt, ywt = t(V), t(Xw), t(yw)
    lo, hi = kernels.threshold_ranges_plain(Vt, Xwt, ywt)
    return Vt, t(dir_ok), lo, hi, t(X), t(y), Xwt, ywt


def crafted_ranges_inputs(device, seed=0, d=2, m=203, n=392, B=5):
    """Ranges-scan inputs on the kernel's edges, as ``(V, Xw, yw)``: a
    batch mixing one transcript of 384 live rows (instance 0, as a noisy
    MEDIAN instance holds, with runs of copies of a point in each class)
    with transcripts of 4 to 48; every instance's live rows interleaved
    with padding, not a prefix; instance 1 has no +1
    row, instance 3 is padding only.  Directions 0 and 5 are the first
    axis, where instances 2 and 4 project to ±0: per class 9 rows (24 in
    instance 4, a list long enough that the kernel bounds it at d = 2),
    the second and the ninth with first coordinate +0 and -0 (the others
    -1, so every other term is -0), the rest on the wrong side of 0.
    Their maximum or minimum is a zero whose sign depends on the order of
    the merge: one row group meets the second row first, more meet the
    ninth (instance 4's third row is a copy of its second).  The default
    m = 203 is not a multiple of 4; an n above a staged chunk (1024 rows
    at d = 2 and 3, 64 at d = 64) spreads the rows over chunks."""
    import torch

    rng = np.random.default_rng(seed)
    V = rng.normal(size=(m, d))
    V = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    V[[0, 5 % m]] = np.eye(d, dtype=np.float32)[0]
    X = rng.normal(size=(B, n, d)).astype(np.float32)
    y = np.zeros((B, n), np.int32)
    live = rng.choice(n, size=min(384, n), replace=False)
    y[0, live] = rng.choice([-1, 1], size=len(live))
    for label in (1, -1):       # runs of copies, as a transcript ships them
        rows = np.flatnonzero(y[0] == label)
        for i in range(1, len(rows)):
            if rng.random() < 0.5:
                X[0, rows[i]] = X[0, rows[i - 1]]
    for b in range(1, B):
        rows = rng.choice(n, size=min(4, n), replace=False)
        y[b, rows] = rng.choice([-1, 1], size=len(rows))
    if B > 1:
        y[1] = np.where(y[1] == 1, -1, y[1])
    for b, k in ((2, 9), (4, 24)):
        if b >= B or n < 2 * k:
            continue
        y[b] = 0
        rows = np.sort(rng.choice(n, size=2 * k, replace=False))
        for label, at, zeros in ((1, rows[0::2], (0.0, -0.0)),
                                 (-1, rows[1::2], (-0.0, 0.0))):
            y[b, at] = label
            X[b, at, 0] = -label * (0.5 + rng.random(k))
            X[b, at[[1, 8]], 1:] = -1.0
            X[b, at[[1, 8]], 0] = zeros
            if b == 4:
                X[b, at[2]] = X[b, at[1]]       # a copy of a zero row
    if B > 3:
        y[3] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(V), t(X), t(y)


def ranges_splits(d, m, n):
    """Every split the ranges kernel has at these shapes, as
    ``support_margin.RangesSplit``s: each tile of its ladder, and where
    the transcripts fit one chunk, each also with three instances (the
    kernel's most) staged together by a block."""
    from repro_torch.kernels import support_margin as sm

    chunk = sm.ranges_chunk(d, n)
    ladder = sm._RANGES_LADDER if d in (2, 3) else sm._RANGES_LADDER_ANY_D
    batches = (1, sm._RANGES_MAX_BATCH) if n <= chunk else (1,)
    return [sm.RangesSplit(w, p, 0, chunk, 0, k) for w, p in ladder
            for k in batches]


def ranges_replica(V, Xw, yw, groups, chunk):
    """numpy replica of ``csrc/threshold_ranges.cu``'s order: per chunk of
    ``chunk`` rows the +1 rows and the -1 rows listed in row order, place s
    of a list going to row group s % ``groups``; each group folds its rows
    chunk after chunk, and the groups' partials fold in group order, a
    value replacing the running one only if strictly greater (lo) or less
    (hi).  So each output is the first of the maximal (minimal) projections
    in the order (group, chunk, place): its sign of zero is the kernel's.
    (The rows the kernel passes over at d = 2 are never maximal.)
    Projections are rounded once per operation, as the kernel's.  Returns
    (lo, hi), each (B, m) f32."""
    V, Xw, yw = (np.asarray(a) for a in (V, Xw, yw))
    B, n, d = Xw.shape
    m = V.shape[0]
    lo = np.full((B, m), -np.inf, np.float32)
    hi = np.full((B, m), np.inf, np.float32)
    for b in range(B):
        for label, out, better in ((1, lo, np.greater), (-1, hi, np.less)):
            order = []
            for c0 in range(0, n, chunk):
                rows = c0 + np.flatnonzero(yw[b, c0:c0 + chunk] == label)
                order += [(s % groups, c0, s, r) for s, r in enumerate(rows)]
            for *_, r in sorted(order):
                p = V[:, 0] * Xw[b, r, 0]
                for c in range(1, d):
                    p = p + V[:, c] * Xw[b, r, c]
                out[b] = np.where(better(p, out[b]), p, out[b])
    return lo, hi


def oneway_buckets(datasets, engine):
    """The one-way smoke sweep as ``(name, instances)``: the JAX one-way
    benchmark's grid at n_per_node=1000 over seeds 0–63 (selector-major, as
    ``build_instances`` orders it), then the k=4 RANDOM bucket."""
    gens = (datasets.data1, datasets.data2, datasets.data3)
    k2 = [engine.ProtocolInstance(gen(n_per_node=1000, k=2, seed=seed), eps,
                                  sel, seed)
          for sel in ("sampling", "naive", "voting", "mixing")
          for gen in gens for eps in (0.1, 0.05) for seed in range(64)]
    k4 = [engine.ProtocolInstance(
        datasets.data_mixed_hardness(n_per_node=100, k=4, seed=i // 2),
        (0.05, 0.02)[i % 2], "sampling", i // 2) for i in range(128)]
    return [("oneway_k2", k2), ("sampling_k4", k4)]


def gap_instances(datasets, engine, seeds=16):
    """``benchmarks/baselines_sweep.py`` ``_gap_sweep``'s mixed grid at
    n_per_node=1000 over ``seeds`` seeds: per (dataset, ε, seed) NAIVE,
    RANDOM, MEDIAN and MAXMARG on the same shards.  Returns the scenario
    names and the instances, four per (scenario, seed)."""
    scenarios, insts = [], []
    for name, gen in (("data1", datasets.data1), ("data2", datasets.data2),
                      ("data3", datasets.data3)):
        for eps in (0.1, 0.05):
            scenarios.append((name, eps))
            for seed in range(seeds):
                shards = gen(n_per_node=1000, k=2, seed=seed)
                insts += [engine.ProtocolInstance(shards, eps, sel, seed)
                          for sel in ("naive", "sampling", "median",
                                      "maxmarg")]
    return scenarios, insts


def _oneway_points(inst, sample_size):
    """The points a one-way instance ships, in closed form from its shard
    sizes (the host loops' message slots): RANDOM forwards min(seen, s_ε) at
    each hop, NAIVE and VOTING every non-last shard, MIXING none."""
    sizes = [len(s[1]) for s in inst.shards]
    if inst.selector == "sampling":
        return sum(min(sum(sizes[:i + 1]), sample_size)
                   for i in range(len(sizes) - 1))
    if inst.selector == "mixing":
        return 0
    return sum(sizes[:-1])


def _uncertain_work(V, dir_ok, lo, hi, X, y, width=128):
    """``(tests, bytes, rounds)`` of the SOU scan on these inputs, from
    :func:`repro_torch.analysis.bounds.uncertain_tests` and
    :func:`~repro_torch.analysis.bounds.uncertain_work`."""
    from repro_torch.analysis import bounds
    tests, rounds = bounds.uncertain_tests(V, dir_ok, lo, hi, X, y, width)
    return (tests, bounds.uncertain_work(V, dir_ok, lo, hi, X, y,
                                         tests=tests).bytes, rounds)


def _time_row(r, reps=(20, 3)):
    """Time a kernel-table row's kernel and plain version with CUDA events
    (medians of ``reps`` calls) beside its bound
    (:func:`repro_torch.analysis.bounds.bound_ms` of the row's ``bytes``,
    ``ops`` and ``exps``), and print the line."""
    from repro_torch.analysis import bounds
    reps = r.get("reps", reps)
    r["ms"] = bounds.median_ms(r["fn"], reps[0])
    r["plain_ms"] = bounds.median_ms(r["plain"], reps[1])
    r["library_ms"] = (bounds.median_ms(r["library"], reps[0])
                       if "library" in r else None)
    peak = r.get("peak", bounds.PEAK_F32)
    work = bounds.Work(r["bytes"], r["ops"], r.get("exps", 0))
    r["bound_ms"], r["bound_by"] = bounds.bound_ms(work, peak)
    if r.get("graph"):
        r["device_ms"] = bounds.graph_ms(r["fn"])
    library = ("" if r["library_ms"] is None
               else f", library {r['library_ms']:.4f} ms")
    device = (f" (device {r['device_ms']:.4f} ms, a CUDA graph)"
              if r.get("graph") else "")
    exps = (f" and {work.exps} exponentials split between the "
            f"special-function units and FMA-pipe polynomials: "
            f"{bounds.ops_ms(work.ops, work.exps, peak):.4g} ms; on the "
            f"special-function units alone "
            f"{work.exps / bounds.PEAK_SFU * 1e3:.4g} ms" if work.exps else "")
    print(f"time {r['name']} at {r['shape']}: kernel {r['ms']:.4f} ms"
          f"{device}, "
          f"plain {r['plain_ms']:.4f} ms{library}, bound "
          f"{r['bound_ms']:.4g} ms ({r['bound_by']}: {r['bytes']} bytes, "
          f"{r['ops']} ops at {peak:.3g} /s{exps})")


def _sass_code(sass, function):
    """[(address, opcode, text)] of the SASS function whose name contains
    ``function``."""
    import re
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        if function not in body.split("\n", 1)[0]:
            continue
        code = []
        for line in body.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                text = m.group(2)
                op = text.split()[1] if text.startswith("@") else \
                    text.split()[0]
                code.append((int(m.group(1), 16), op, text))
        return code
    raise AssertionError(f"no SASS function {function}")


def _step_loop(sass, function):
    """(instructions, MUFU.EX2s, opcode counts) of the innermost loop that
    holds every exponential of the SASS function whose name contains
    ``function``: the span from the target of the backward branch that
    closes it to that branch."""
    import collections
    code = _sass_code(sass, function)
    exps = [a for a, op, _ in code if op.startswith("MUFU.EX2")]
    loops = [(int(text.split()[-1], 16), a) for a, op, text in code
             if op.startswith("BRA") and a >= exps[-1]
             and int(text.split()[-1], 16) <= exps[0]]
    start, end = max(loops)
    ops = [op for a, op, _ in code if start <= a <= end]
    return (len(ops), sum(op.startswith("MUFU.EX2") for op in ops),
            collections.Counter(op.split(".")[0] for op in ops))


def _vote_round(sass, function):
    """(instructions, opcode counts) of one round of a test loop unrolled
    with a vote a round from registers, in the SASS function whose name
    contains ``function``: the median span from one VOTE to the next (the
    second one included) among those that compare (FSETP) and read no
    shared memory (LDS)."""
    import collections
    ops = [op for _, op, _ in _sass_code(sass, function)]
    votes = [i for i, op in enumerate(ops) if op.startswith("VOTE")]
    spans = sorted(((a, b) for a, b in zip(votes, votes[1:])
                    if any(op.startswith("FSETP") for op in ops[a:b])
                    and not any(op.startswith("LDS") for op in ops[a:b])),
                   key=lambda v: v[1] - v[0])
    first, last = spans[len(spans) // 2]
    return (last - first, collections.Counter(
        op.split(".")[0] for op in ops[first + 1:last + 1]))


def _exact(a, b, what):
    """Max |kernel - plain| over integer outputs; raises unless it is 0."""
    diff = (a.long() - b.long()).abs()
    err = int(diff.max()) if diff.numel() else 0
    if err:
        raise AssertionError(f"{what}: kernel and plain version disagree on "
                             f"{int((diff > 0).sum())} of {a.numel()} "
                             f"entries (max |diff| {err})")
    return err


def _same_floats(a, b, what):
    """0.0 if the two float tensors are equal entry for entry (infinities
    included); raises otherwise."""
    bad = ~((a == b) | (a.isnan() & b.isnan()))
    if bool(bad.any()):
        diff = (a.double() - b.double()).abs()[bad]
        raise AssertionError(f"{what}: kernel and plain version disagree on "
                             f"{int(bad.sum())} of {a.numel()} entries (max "
                             f"|diff| {float(diff.max())})")
    return 0.0


def _cosine(va, vb):
    return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))


def _greedy(eng, first, n):
    """``TokenServingEngine.generate``'s loop, keeping each step's gap
    between the two largest logits.  Returns (tokens (B, n), gaps (n, B))."""
    import torch
    tok = torch.as_tensor(first, device=eng.device).reshape(-1, 1).to(
        torch.int32)
    toks, gaps = [], []
    for _ in range(n):
        logits, eng.caches = eng.step(eng.params, eng.caches, tok, eng.pos)
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        tok = logits[:, -1, :].argmax(-1).to(torch.int32).reshape(-1, 1)
        toks.append(tok.cpu().numpy())
        eng.pos += 1
    return np.concatenate(toks, axis=1), np.stack(gaps)


def _same_tokens(got, want, gaps, what, tie=1e-4):
    """Greedy tokens equal, row by row, up to a first difference at a step
    where the reference's two largest logits lie within ``tie``."""
    for r in range(want.shape[0]):
        diff = np.flatnonzero(got[r] != want[r])
        if diff.size:
            t = diff[0]
            print(f"{what} row {r}: token {t} differs (card {got[r, t]}, "
                  f"cpu {want[r, t]}); cpu's top-2 gap {gaps[t][r]!r}")
            if not gaps[t][r] <= tie:
                raise AssertionError(f"{what}: row {r} token {t} differs "
                                     f"with a top-2 gap of {gaps[t][r]}")


def jamba_dense(cfg):
    """Jamba without experts: the published config cut to one period (8
    layers: 7 Mamba, attention at index 4) with every FFN a dense SwiGLU of
    d_ff 24576 (= d_expert, one expert-shaped FFN a token)."""
    import dataclasses
    return dataclasses.replace(
        cfg, name=cfg.name + "-one-period-dense", n_layers=len(cfg.period),
        period=tuple((m, "mlp") for m, _ in cfg.period), moe=None)


def jamba_moe(cfg):
    """Jamba with its experts at every published width: the published
    config cut to its in-period layers 4 and 5, ``(attn, mlp), (mamba,
    moe)``: the attention layer, a Mamba layer and one MoE FFN of 16
    experts at d_expert 24576 (~11.9 B parameters; a whole period's four
    MoE layers are over 77 GB in bf16)."""
    import dataclasses
    return dataclasses.replace(cfg, name=cfg.name + "-layers-4-5",
                               n_layers=2, period=cfg.period[4:6])


def _vlm_grid(batch, width=8, n=None):
    """The M-RoPE ids of the batch's first ``n`` patch positions (all
    patches by default) on a grid ``width`` wide (temporal 0, height
    i // width, width i % width); the other positions keep their own
    position in all three planes, as decode gives it."""
    if "vision_embed" in batch:
        n = batch["vision_embed"].shape[1] if n is None else n
        i = np.arange(n)
        pos = batch["rope_pos"].copy()
        pos[:, :, :n] = np.stack([np.zeros(n), i // width,
                                  i % width])[:, None, :]
        batch["rope_pos"] = pos
    return batch


def _prompt_of(batch, S):
    """The first S tokens with the patches and M-RoPE ids that go with
    them."""
    out = {"tokens": batch["tokens"][:, :S]}
    if "vision_embed" in batch:
        out["vision_embed"] = batch["vision_embed"]
        out["rope_pos"] = batch["rope_pos"][:, :, :S]
    return out


def _host_free_gb():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 1e6
    return float("nan")


def families_phase(dev, attn_ms=None):
    """Phase 19: grok-1 (MoE), DeepSeek-V2 (MoE with MLA, both decodes),
    Jamba with its experts and qwen2-vl (the patch splice) at their
    published widths on the card, scoring and serving through the entry
    points with every launch counted, routing and whole models card
    against CPU in f32.  ``attn_ms`` maps a config's name to the attention
    kernel's device time for one call at its scoring shape (held and timed
    in phase 14; without it qwen2-vl's attention share is not printed).
    Returns (launches per path, attention routes per
    path)."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_stream
    from repro_torch.kernels import flash_attention as fa_module
    from repro_torch.models import layers, model as lm_model, moe as moe_mod
    from repro_torch.serve import ServeConfig, TokenServingEngine

    t_phase = time.perf_counter()
    # the f32 checks hold f32 products: PyTorch's default, checked
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on for f32 matmuls")
    bf16, f32 = torch.bfloat16, torch.float32
    zero = dict.fromkeys(kernels.launches(), 0)
    no_routes = dict.fromkeys(fa_module.ROUTES, 0)
    paths, routes = {}, {}
    sv = SERVE_FAMILIES
    torch.cuda.empty_cache()
    layers.set_attention_impl("kernel")

    def drawn(name, mcfg, dtype):
        t0 = time.perf_counter()
        lm = lm_model.init_lm(mcfg, seed=0, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in lm.parameters())
        print(f"{name}: {n} parameters ({n * dtype.itemsize / 1e9:.2f} GB "
              f"in {dtype}; param_count {mcfg.param_count()}), drawn on the "
              f"card in {time.perf_counter() - t0:.2f} s")
        return lm

    def batch_of(mcfg, B, S, seed=0):
        return _vlm_grid(next(synthetic_stream(
            mcfg, DataConfig(seq_len=S, global_batch=B, seed=seed))))

    def check(what, got, got_routes, expect, want_routes=None):
        want = dict(zero, **expect)
        want_r = dict(no_routes, **(want_routes or {}))
        if got != want or got_routes != want_r:
            raise AssertionError(f"{what} launched {got}, routes "
                                 f"{got_routes}; expected {want}, routes "
                                 f"{want_r}")

    def moe_events(run):
        """Run ``run`` with CUDA events around every call of
        ``moe.apply_moe``; returns (summed event ms, wall ms, calls)."""
        spans, original = [], moe_mod.apply_moe

        def timed(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = original(*a, **kw)
            ev[1].record()
            spans.append(ev)
            return out

        moe_mod.apply_moe = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            moe_mod.apply_moe = original
        return (sum(a.elapsed_time(b) for a, b in spans), wall * 1e3,
                len(spans))

    def score(name, key, mcfg, lm, batch, attn=0, scans=0):
        """Warm up, one counted ``forward_train`` (exactly ``attn`` tc and
        ``scans`` scan launches), 3 timed, one with CUDA events around
        every MoE FFN (without experts, the attention kernel's share from
        its time at this shape in ``attn_ms``)."""
        lm_model.forward_train(lm, mcfg, batch)            # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        loss, met = lm_model.forward_train(lm, mcfg, batch)
        torch.cuda.synchronize()
        got, got_routes = kernels.launches(), dict(kernels.attention.routes)
        expect = {k: v for k, v in (("attention", attn),
                                    ("mamba_scan", scans)) if v}
        check(f"{name} scoring", got, got_routes, expect,
              dict(tc=attn) if attn else None)
        aux = float(met["aux_loss"])
        if not (torch.isfinite(loss) and 0 <= float(met["acc"]) <= 1
                and (aux > 0) == (mcfg.moe is not None)):
            raise AssertionError(f"{name} scoring loss {loss}, acc "
                                 f"{met['acc']}, aux {aux}")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_model.forward_train(lm, mcfg, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        if mcfg.moe is not None:
            span_ms, ev_ms, calls = moe_events(
                lambda: lm_model.forward_train(lm, mcfg, batch))
            share = (f"the {calls} MoE FFN calls take {span_ms:.2f} ms of a "
                     f"{ev_ms:.2f} ms pass ({span_ms / ev_ms:.1%})")
        elif mcfg.name not in (attn_ms or {}):
            share = "the attention kernel's share not timed (phase 14)"
        else:
            span_ms = attn * attn_ms[mcfg.name]
            share = (f"the {attn} attention kernel calls take {attn} x "
                     f"{attn_ms[mcfg.name]:.4f} ms (its device time at this "
                     f"shape, phase 14) = {span_ms:.2f} ms of the median pass "
                     f"({span_ms / (wall * 1e3):.1%})")
        B, S = batch["tokens"].shape
        print(f"{name} scoring B={B} S={S} bf16: loss {float(loss)!r} (aux "
              f"{aux!r}), acc {float(met['acc']):.4f}, launches "
              f"{ {k: v for k, v in got.items() if v} }, routes "
              f"{ {k: v for k, v in got_routes.items() if v} }; "
              f"{wall * 1e3:.2f} ms a pass (median of 3: "
              f"{[round(w * 1e3, 2) for w in walls]}), {B * S / wall:.0f} "
              f"tokens/s; {share}")
        paths[f"{key}_scoring"] = got
        if attn:
            routes[f"{key}_scoring"] = got_routes
        return float(loss)

    def prompt_of(mcfg):
        """A serving prompt: ``sv["prompt"]`` tokens of a batch of its own
        (with 64 patch embeddings for the VLM)."""
        return _prompt_of(batch_of(mcfg, sv["B"], sv["prompt"], seed=1),
                          sv["prompt"])

    def serve(name, key, mcfg, lm, prompt, expect, flags=lm_model.RunFlags()):
        """Warm up, then prefill and greedy-decode ``sv["tokens"]`` with
        the launch counts set to 0 just before (exactly ``expect``, no
        attention launch) and the gather path's calls counted (every MoE
        layer at every decoded token: B=8 tokens a step).  Returns the
        tokens."""
        sc = ServeConfig(batch=sv["B"], cache_len=sv["cache_len"],
                         flags=flags)
        warm = TokenServingEngine(mcfg, lm, sc, device=dev)
        warm.generate(warm.prefill_prompt(prompt)[:, -1].argmax(-1), 2)
        del warm
        eng = TokenServingEngine(mcfg, lm, sc, device=dev)
        gathers, original = [0], moe_mod._moe_gather_path

        def counted(*a, **kw):
            gathers[0] += 1
            return original(*a, **kw)

        moe_mod._moe_gather_path = counted
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            first = eng.prefill_prompt(prompt)[:, -1].argmax(-1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pre_gathers = gathers[0]
            toks = eng.generate(first, sv["tokens"])
            t2 = time.perf_counter()
        finally:
            moe_mod._moe_gather_path = original
        got = kernels.launches()
        check(f"{name} serving", got, dict(kernels.attention.routes), expect)
        n_moe = sum(f == "moe" for _, f in mcfg.period) * mcfg.n_periods
        if (pre_gathers, gathers[0]) != (0, n_moe * sv["tokens"]):
            raise AssertionError(f"{name} serving: {pre_gathers} gather-path "
                                 f"calls at prefill, {gathers[0]} in all; "
                                 f"expected 0 and {n_moe * sv['tokens']}")
        if not (toks.shape == (sv["B"], sv["tokens"])
                and ((toks >= 0) & (toks < mcfg.vocab)).all()):
            raise AssertionError(f"{name} served tokens {toks}")
        pre_ms, tok_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3 / sv["tokens"]
        print(f"{name} serving B={sv['B']} prompt {sv['prompt']} cache "
              f"{sv['cache_len']} bf16{' mla_absorb' if flags.mla_absorb else ''}"
              f": prefill {pre_ms:.2f} ms, {tok_ms:.3f} ms per decoded token "
              f"({sv['tokens']} tokens, {sv['B'] * 1e3 / tok_ms:.0f} "
              f"tokens/s), launches { {k: v for k, v in got.items() if v} }, "
              f"{gathers[0]} gather-path MoE calls")
        paths[f"{key}_serving"] = got
        return toks

    def lockstep(what, mcfg, lm, prompt, dtype, tie):
        """MLA's faithful and absorbed decodes fed the same tokens (the
        faithful one's greedy picks), so their caches stay equal: every
        step's logits compared, and where the picks differ both runs' top
        two logits must lie within ``tie`` (None: printed only)."""
        engs = [TokenServingEngine(mcfg, lm, ServeConfig(
            batch=sv["B"], cache_len=sv["cache_len"], dtype=dtype,
            flags=lm_model.RunFlags(mla_absorb=a)), device=dev)
            for a in (False, True)]
        tok = [e.prefill_prompt(prompt) for e in engs][0][:, -1].argmax(-1)
        tok = tok.to(torch.int32).reshape(-1, 1)
        worst, parted = 0.0, []
        for t in range(sv["tokens"]):
            logits = []
            for e in engs:
                lg, e.caches = e.step(e.params, e.caches, tok, e.pos)
                e.pos += 1
                logits.append(lg[:, -1].float())
            worst = max(worst, float((logits[0] - logits[1]).abs().max()))
            picks = [lg.argmax(-1) for lg in logits]
            top2 = [lg.topk(2, -1).values for lg in logits]
            gaps = [(v[:, 0] - v[:, 1]).cpu().numpy() for v in top2]
            for r in torch.nonzero(picks[0] != picks[1]).flatten().tolist():
                parted.append((t, r, float(gaps[0][r]), float(gaps[1][r])))
            tok = picks[0].to(torch.int32).reshape(-1, 1)
        print(f"{what} faithful and absorbed decodes in lockstep, B="
              f"{sv['B']} prompt {sv['prompt']}, {sv['tokens']} steps: max "
              f"|logit diff| {worst!r}, {len(parted)} of "
              f"{sv['B'] * sv['tokens']} picks differ "
              f"{parted[:8]}{' ...' if len(parted) > 8 else ''}")
        if tie is not None:
            far = [p for p in parted if min(p[2], p[3]) > tie]
            if far:
                raise AssertionError(f"{what}: picks differ at (step, row, "
                                     f"gaps) {far} with both top-2 gaps "
                                     f"above {tie}")

    # -- 19a. grok-1 cut to 2 layers -----------------------------------------
    t0 = time.perf_counter()
    gfull = get_config("grok-1-314b")
    gs = FAMILY_SCORING["grok-1-314b"]
    gcfg = dataclasses.replace(gfull, n_layers=gs["layers"])
    lm = drawn(f"19a grok-1-314b at {gcfg.n_layers} layers", gcfg, bf16)
    batch = batch_of(gcfg, gs["B"], gs["S"])
    score("19a grok-1", "grok", gcfg, lm, batch, attn=gcfg.n_layers)
    serve("19a grok-1", "grok", gcfg, lm, prompt_of(gcfg), {})
    del lm, batch
    torch.cuda.empty_cache()
    print(f"19a: {time.perf_counter() - t0:.1f} s")

    # -- 19b. DeepSeek-V2 cut to 2 layers, both decodes ----------------------
    t0 = time.perf_counter()
    dfull = get_config("deepseek-v2-236b")
    ds = FAMILY_SCORING["deepseek-v2-236b"]
    dcfg = dataclasses.replace(dfull, n_layers=ds["layers"])
    lm = drawn(f"19b deepseek-v2-236b at {dcfg.n_layers} layers", dcfg, bf16)
    batch = batch_of(dcfg, ds["B"], ds["S"])
    # MLA passes an explicit scale: the plain pass, no attention launch
    score("19b deepseek-v2", "deepseek", dcfg, lm, batch)
    prompt = prompt_of(dcfg)
    serve("19b deepseek-v2", "deepseek", dcfg, lm, prompt, {})
    serve("19b deepseek-v2", "deepseek_absorbed", dcfg, lm, prompt, {},
          flags=lm_model.RunFlags(mla_absorb=True))
    # the two decodes in lockstep, in bf16 (printed) and in f32 (held)
    lockstep("19b bf16", dcfg, lm, prompt, bf16, tie=None)
    del lm, batch
    torch.cuda.empty_cache()
    lm = drawn(f"19b deepseek-v2-236b at {dcfg.n_layers} layers", dcfg, f32)
    lockstep("19b f32", dcfg, lm, prompt, f32, tie=ABSORB_TIE)
    del lm
    torch.cuda.empty_cache()
    print(f"19b: {time.perf_counter() - t0:.1f} s")

    # -- 19c. Jamba with its experts (in-period layers 4-5) ------------------
    t0 = time.perf_counter()
    jcfg = jamba_moe(get_config("jamba-1.5-large-398b"))
    lm = drawn(f"19c {jcfg.name} {jcfg.period}", jcfg, bf16)
    js = FAMILY_SCORING["jamba"]
    batch = batch_of(jcfg, js["B"], js["S"])
    n_mamba = sum(m == "mamba" for m, _ in jcfg.period)
    score("19c jamba with experts", "jamba_moe", jcfg, lm, batch,
          attn=jcfg.n_layers - n_mamba, scans=n_mamba)
    serve("19c jamba with experts", "jamba_moe", jcfg, lm, prompt_of(jcfg),
          dict(mamba_scan=n_mamba * (1 + sv["tokens"])))
    del lm, batch
    torch.cuda.empty_cache()
    print(f"19c: {time.perf_counter() - t0:.1f} s")

    # -- 19d. qwen2-vl-2b at full width and depth, patches spliced -----------
    t0 = time.perf_counter()
    qcfg = get_config("qwen2-vl-2b")
    lm = drawn("19d qwen2-vl-2b", qcfg, bf16)
    qs = FAMILY_SCORING["qwen2-vl-2b"]
    batch = batch_of(qcfg, qs["B"], qs["S"])
    print(f"19d: {batch['vision_embed'].shape[1]} patch embeddings spliced, "
          f"M-RoPE ids (3, B, S) {batch['rope_pos'].shape}")
    score("19d qwen2-vl-2b", "qwen2vl", qcfg, lm, batch, attn=qcfg.n_layers)
    serve("19d qwen2-vl-2b", "qwen2vl", qcfg, lm, prompt_of(qcfg), {})
    del lm, batch
    torch.cuda.empty_cache()
    print(f"19d: {time.perf_counter() - t0:.1f} s")

    # -- 19e. routing card against CPU, f32, full width ----------------------
    t0 = time.perf_counter()
    for mcfg in (gfull, dfull):
        mo, d = mcfg.moe, mcfg.d_model
        B, S, K = ROUTE_SHAPE["B"], ROUTE_SHAPE["S"], mo.top_k
        gen = torch.Generator(device=dev).manual_seed(19)
        w = torch.randn((d, mo.n_experts), generator=gen, device=dev) * 0.02
        # a per-row offset leans each row's tokens toward some experts
        x = (torch.randn((B, S, d), generator=gen, device=dev)
             + 0.5 * torch.randn((B, 1, d), generator=gen, device=dev))
        rc = moe_mod.route({"router": w}, mcfg, x)
        wh, xh = w.cpu(), x.cpu()
        rh = moe_mod.route({"router": wh}, mcfg, xh)
        top = torch.softmax((xh @ wh).float(), -1).topk(K + 1, -1).values
        near = ((top[..., :-1] - top[..., 1:]) <= 1e-6).any(-1)   # (B, S)
        ids = rc.expert_ids.cpu()
        differ = (ids != rh.expert_ids).any(-1)
        if bool((differ & ~near).any()):
            raise AssertionError(f"19e {mcfg.name}: expert picks differ at "
                                 f"{int((differ & ~near).sum())} tokens "
                                 f"without a near-tie")
        rows = ~differ.any(-1)       # batch rows where no pick differs
        if int(rows.sum()) < B // 2:
            raise AssertionError(f"19e {mcfg.name}: picks differ in "
                                 f"{B - int(rows.sum())} of {B} rows, too "
                                 f"few left to hold keep and dest")
        for what, a, b in (("keep", rc.keep, rh.keep),
                           ("dest", rc.dest, rh.dest)):
            _exact(a.cpu()[rows], b[rows], f"19e {mcfg.name} {what}")
        gate_err = float((rc.gate_vals.cpu() - rh.gate_vals)[~differ].abs()
                         .max())
        aux_err = abs(float(rc.aux) - float(rh.aux)) / abs(float(rh.aux))
        dropped = int((~rh.keep).sum())
        # the router product sums d terms in another order on each side
        if not (dropped > 0 and gate_err <= 1e-5 and aux_err <= 1e-5):
            raise AssertionError(f"19e {mcfg.name}: {dropped} dropped "
                                 f"slots, gate error {gate_err}, aux "
                                 f"relative error {aux_err}")
        print(f"19e {mcfg.name} routing B={B} S={S} f32 card vs cpu: cap "
              f"{moe_mod.moe_capacity(mcfg, S)}, {dropped} of {B * S * K} "
              f"slots dropped, {int(differ.sum())} tokens' picks differ "
              f"(near-ties within 1e-6: {int(near.sum())} tokens), expert "
              f"ids, keep and dest equal on {int(rows.sum())} of {B} rows, "
              f"gates max |diff| {gate_err!r}, aux relative {aux_err!r}")
        del w, x, wh, xh, rc, rh
    print(f"19e: {time.perf_counter() - t0:.1f} s")

    # -- 19f. card against CPU, f32, the same weights ------------------------
    t0 = time.perf_counter()
    print(f"19f: host memory available {_host_free_gb():.1f} GB")
    torch.cuda.synchronize()
    kernels.reset_launches()
    for mcfg, modes in ((dataclasses.replace(gfull, n_layers=1), (False,)),
                        (dataclasses.replace(dfull, n_layers=1),
                         (False, True)),
                        (dataclasses.replace(qcfg, n_layers=2), (False,))):
        name = f"19f {mcfg.name} at {mcfg.n_layers} layer(s)"
        params = drawn(name, mcfg, f32)
        on_cpu = lm_model.cast_params(params, f32, device="cpu")
        b1 = batch_of(mcfg, 1, 32, seed=1)
        lc, _ = lm_model.forward_train(params, mcfg, b1, dtype=f32)
        lh, _ = lm_model.forward_train(on_cpu, mcfg, b1, dtype=f32)
        if not abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh)):
            raise AssertionError(f"{name} loss card {float(lc)!r}, cpu "
                                 f"{float(lh)!r}")
        prompt = _prompt_of(b1, 32)
        for absorb in modes:
            sc = ServeConfig(batch=1, cache_len=40, dtype=f32,
                             flags=lm_model.RunFlags(mla_absorb=absorb))
            cpu_eng = TokenServingEngine(mcfg, on_cpu, sc, device="cpu")
            lgh = cpu_eng.prefill_prompt(prompt)
            want, gaps = _greedy(cpu_eng, lgh[:, -1].argmax(-1), 8)
            eng = TokenServingEngine(mcfg, params, sc, device=dev)
            lgc = eng.prefill_prompt(prompt)
            got = eng.generate(lgh[:, -1].argmax(-1), 8)
            _same_tokens(got, want, gaps, f"{name} card vs cpu")
            print(f"{name} card vs cpu, B=1 prompt 32, f32"
                  f"{' mla_absorb' if absorb else ''}: loss {float(lc)!r} "
                  f"and {float(lh)!r}, prefill logits max |diff| "
                  f"{float((lgc.cpu() - lgh).abs().max())!r}, 8 greedy "
                  f"tokens card {got.tolist()} cpu {want.tolist()}")
            del eng, cpu_eng
        del params, on_cpu
        torch.cuda.empty_cache()
    got, got_routes = kernels.launches(), dict(kernels.attention.routes)
    # f32 scoring at 32 rows takes the simt route: grok-1's one attention
    # layer and qwen2-vl's two; serving's attention has a cache
    simt = 1 + 2
    check("19f card vs cpu", got, got_routes, dict(attention=simt),
          dict(simt=simt))
    paths["families_card_vs_cpu_f32"] = got
    routes["families_card_vs_cpu_f32"] = got_routes
    print(f"19f: {time.perf_counter() - t0:.1f} s, attention routes "
          f"{ {k: v for k, v in got_routes.items() if v} }")
    layers.set_attention_impl("plain")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return paths, routes


def unified_instances(datasets, engine):
    """Phase 17a's grid: the MAXMARG smoke's first bucket's datasets and ε
    (data1/2/3 × ε ∈ {0.05, 0.02, 0.01}, n_per_node=1000, k=2) with the
    three families interleaved, 384 each (B=1152), then a k=4 bucket,
    ``data_mixed_hardness(n_per_node=100, k=4)`` × ε ∈ {0.05, 0.02}, 64
    each (B=192): multi-hop Vitter chains and k-party MEDIAN."""
    gens = (datasets.data1, datasets.data2, datasets.data3)
    k2 = [engine.ProtocolInstance(
        gens[(i // 3) % 3](n_per_node=1000, k=2, seed=i // 27),
        (0.05, 0.02, 0.01)[(i // 9) % 3], FAMILIES[i % 3], i // 27)
        for i in range(1152)]
    k4 = [engine.ProtocolInstance(
        datasets.data_mixed_hardness(n_per_node=100, k=4, seed=i // 6),
        (0.05, 0.02)[(i // 3) % 2], FAMILIES[i % 3], i // 6)
        for i in range(192)]
    return k2 + k4


def pool_sessions(datasets, n, n_per_node, epss=(0.05, 0.02, 0.01)):
    """Phase 17's service traffic as ``(shards, eps, selector, seed)``:
    session i is family ``FAMILIES[i % 3]`` on data{1,2,3}[(i // 3) % 3]
    at ε ``epss[(i // 9) % len(epss)]``, k=2, seed i // 27."""
    gens = (datasets.data1, datasets.data2, datasets.data3)
    return [(gens[(i // 3) % 3](n_per_node=n_per_node, k=2, seed=i // 27),
             epss[(i // 9) % len(epss)], FAMILIES[i % 3], i // 27)
            for i in range(n)]


def _serve(svc, sessions, *, chunk, batches, stop_at=None, hold_at=None):
    """Stream ``sessions`` through ``svc``: before each pool turn, open,
    feed (every node's rows in ``batches`` pieces) and close the next
    ``chunk`` sessions; then step the pool, until every session is closed
    and the pool drained, or until pool turn ``stop_at`` (no handle is
    open between turns).  Returns the session ids, each pool turn's ms
    (host clock, CUDA-synchronised), how many sessions were closed and the
    kernel calls recorded (``_recording``) during pool turn ``hold_at``."""
    import torch
    sids, ms, calls = [], [], []
    i = 0
    while stop_at is None or svc.pool.pool_turn < stop_at:
        for shards, eps, sel, seed in sessions[i:i + chunk]:
            h = svc.open(eps=eps, selector=sel, seed=seed)
            for node, (X, y) in enumerate(shards):
                for part in np.array_split(np.arange(len(y)), batches):
                    svc.feed(h, node, X[part], y[part])
            sids.append(svc.close(h))
        i = min(i + chunk, len(sessions))
        if i == len(sessions) and svc.pool.drained():
            break
        hold = svc.pool.pool_turn == hold_at
        t0 = time.perf_counter()
        with _recording(lambda: hold) as turn_calls:
            svc.step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        calls += turn_calls
    return sids, ms, i, calls


def _time_dispatch(pool):
    """Wrap ``pool``'s turn dispatch so that each call is timed on the
    host clock between two synchronisations; returns the list the ms go
    to.  A measuring shim of this script: it replaces the pool's private
    ``_dispatch`` on this one object and calls it unchanged."""
    import torch
    spent = []
    dispatch = pool._dispatch

    def timed(rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch(rows)
        torch.cuda.synchronize()
        spent.append(1e3 * (time.perf_counter() - t0))
    pool._dispatch = timed
    return spent


def _bitwise(a, b):
    """Two ProtocolResults equal bit for bit (separator, comm, rounds,
    convergence)."""
    return (np.array_equal(a.classifier.w, b.classifier.w)
            and float(a.classifier.b) == float(b.classifier.b)
            and (a.comm, a.rounds, a.converged)
            == (b.comm, b.rounds, b.converged))


def _same_decisions(a, b, sel, what, median_atol=None):
    """Comm, rounds, convergence, sample size and warm latches exact; a
    MEDIAN separator bit for bit (or to ``median_atol``), the others to a
    cosine above 1 - COS_TOL.  Returns the cosine (1.0 for MEDIAN)."""
    keys = ("sample_size", "warm_latches")
    if ((a.comm, a.rounds, a.converged)
            != (b.comm, b.rounds, b.converged)
            or any(a.extra.get(k) != b.extra.get(k) for k in keys)):
        raise AssertionError(f"{what} ({sel}): {a.comm} {a.rounds} "
                             f"{a.converged} {a.extra} against {b.comm} "
                             f"{b.rounds} {b.converged} {b.extra}")
    va = np.concatenate([a.classifier.w, [a.classifier.b]])
    vb = np.concatenate([b.classifier.w, [b.classifier.b]])
    if sel == "median":
        ok = (np.array_equal(va, vb) if median_atol is None
              else np.abs(va - vb).max() <= median_atol)
        if not ok:
            raise AssertionError(f"{what} (median): separator {va} against "
                                 f"{vb}")
        return 1.0
    cos = _cosine(va, vb)
    if not cos > 1.0 - COS_TOL:
        raise AssertionError(f"{what} ({sel}): separator cosine {cos} ({va} "
                             f"against {vb})")
    return cos


def _path_sites():
    """Where phase 17's path looks up its four kernel wrappers, as
    ``(module, attribute, wrapper name)``: the MEDIAN scans and the MAXMARG
    turn scan through ``engine.dataplane``, the solver's stage through
    ``kernels.pegasos`` (``core.classifiers`` imports it at each call)."""
    from repro_torch.engine import dataplane
    from repro_torch.kernels import pegasos
    return ((dataplane, "median_cut", "median_cut_scores"),
            (dataplane, "median_extremes_segments",
             "median_extremes_segments"),
            (dataplane, "maxmarg_turn_scan", "maxmarg_turn_scan"),
            (pegasos, "pegasos_stage", "pegasos_stage"))


class _Recorder:
    """Stands in for a kernel wrapper where the engine looks it up: while
    ``on()`` holds, each call's arguments are cloned into ``calls``; the
    wrapper then runs as always, and its launch counts for the path (the
    wrapper counts through its module-level name, so ``launches`` is
    forwarded)."""

    def __init__(self, fn, name, calls, on):
        self.fn, self.name, self.calls, self.on = fn, name, calls, on

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kw):
        if self.on():
            import torch
            self.calls.append((self.name, tuple(
                a.clone() if torch.is_tensor(a) else a for a in args),
                dict(kw)))
        return self.fn(*args, **kw)


@contextlib.contextmanager
def _recording(on):
    """While open, the calls the engine makes to phase 17's four kernel
    wrappers while ``on()`` holds are recorded: yields the list of
    ``(wrapper name, arguments, options)``."""
    calls = []
    sites = _path_sites()
    saved = [getattr(mod, attr) for mod, attr, _ in sites]
    try:
        for (mod, attr, name), fn in zip(sites, saved):
            setattr(mod, attr, _Recorder(fn, name, calls, on))
        yield calls
    finally:
        for (mod, attr, _), fn in zip(sites, saved):
            setattr(mod, attr, fn)


def _batched(name, args):
    """A recorded call's first batched input (the cut scan's first
    argument is the shared direction grid)."""
    return args[1 if name == "median_cut_scores" else 0]


def _widest(calls):
    """Of the recorded calls of one wrapper with one batch size and the
    same options, the one with the most input elements."""
    import torch
    best = {}
    for call in calls:
        name, args, kw = call
        tensors = [a for a in args if torch.is_tensor(a)]
        key = (name, _batched(name, args).shape[0],
               tuple(sorted(kw.items())))
        size = sum(t.numel() for t in tensors)
        if key not in best or size > best[key][0]:
            best[key] = (size, call)
    return [call for _, call in best.values()]


def _hold_calls(calls, what):
    """Each recorded call again, the kernel against its plain version on
    the same inputs, every output exactly (the Pegasos stage bit for bit:
    its plain version sums in the kernel's order).  Returns the largest
    |kernel - plain| per counted wrapper name (0 where it returns)."""
    import torch
    from repro_torch import kernels
    errs = {}
    for name, args, kw in calls:
        shapes = [tuple(a.shape) if torch.is_tensor(a) else a for a in args]
        got = getattr(kernels, name)(*args, **kw)
        want = getattr(kernels, name + "_plain")(*args, **kw)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        key = ("median_extremes" if name == "median_extremes_segments"
               else name)
        for i, (g, e) in enumerate(zip(got, want)):
            label = f"{what}: {name} {shapes} {kw}, output {i}"
            err = (_same_floats(g, e, label) if g.is_floating_point()
                   else _exact(g, e, label))
            errs[key] = max(errs.get(key, 0), err)
    return errs


def unified_phase(dev, card):
    """Phase 17: the unified dispatch and the protocol service.  Returns
    the launch counts of the unified sweep and of the service runs, and
    the largest |kernel - plain| of the kernel calls replayed from them."""
    import tempfile
    import torch
    from repro_torch import engine, kernels
    from repro_torch.core import datasets
    from repro_torch.engine import hotloop
    from repro_torch.engine.faults import FaultSchedule
    from repro_torch.engine.session_pool import SessionPool
    from repro_torch.serve import PoolConfig, ProtocolService

    t_phase = time.perf_counter()
    path_kernels = ("median_cut_scores", "median_extremes",
                    "maxmarg_turn_scan", "pegasos_stage")

    # -- 17a. the unified sweep against the bucketed one, on the card -------
    insts = unified_instances(datasets, engine)
    opts = dict(MAXMARG, n_angles=SMOKE["n_angles"])
    hotloop.KEY_LOG.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    with _recording(lambda: True) as ucalls:
        ures = engine.run_sweep(insts, unified_dispatch=True, device=dev,
                                **opts)
    torch.cuda.synchronize()
    unified_counts = kernels.launches()
    u_turns = len(hotloop.KEY_LOG)
    u_widths = sorted({w for _, w, *_ in hotloop.KEY_LOG})
    for name in path_kernels:
        if unified_counts[name] <= 0:
            raise AssertionError(f"the unified sweep never launched {name}")
    # the same sweep at each width policy, alternated, unrecorded
    walls, lres = {"geometric": [], "linear": []}, None
    for policy in ("linear", "geometric", "geometric", "linear"):
        hotloop.KEY_LOG.clear()
        t0 = time.perf_counter()
        res = engine.run_sweep(insts, unified_dispatch=True, device=dev,
                               width_policy=policy, **opts)
        torch.cuda.synchronize()
        walls[policy].append(time.perf_counter() - t0)
        if policy == "linear":
            lres, l_turns = res, len(hotloop.KEY_LOG)
            l_widths = sorted({w for _, w, *_ in hotloop.KEY_LOG})
    t0 = time.perf_counter()
    bres = engine.run_sweep(insts, device=dev, **opts)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    worst, bitwise, excess = 1.0, 0, -1.0
    for i, (inst, u, b, lw) in enumerate(zip(insts, ures, bres, lres)):
        d = inst.shards[0][0].shape[1]
        if not (u.extra["unified"] and u.extra["selector"] == inst.selector
                and u.classifier.w.shape == (d,)
                and np.isfinite(u.classifier.w).all()
                and np.isfinite(u.classifier.b)):
            raise AssertionError(f"unified instance {i}: {u.extra}, "
                                 f"separator {u.classifier.w}")
        worst = min(worst, _same_decisions(u, b, inst.selector,
                                           f"unified instance {i}"))
        worst = min(worst, _same_decisions(
            lw, u, inst.selector, f"unified instance {i}, linear widths"))
        bitwise += _bitwise(u, b)
        X = np.concatenate([s[0] for s in inst.shards])
        y = np.concatenate([s[1] for s in inst.shards])
        err = float(np.mean(u.classifier.predict(X) != y))
        if not err <= inst.eps + 2.0 / len(y):
            raise AssertionError(f"unified instance {i} ({inst.selector}): "
                                 f"error {err} above ε {inst.eps} + 2/n")
        excess = max(excess, err - inst.eps - 2.0 / len(y))
    t0 = time.perf_counter()
    widest = _widest(ucalls)
    held = _hold_calls(widest, "unified sweep")
    n_held, n_calls = len(widest), len(ucalls)
    del widest
    del ucalls
    hold_s = time.perf_counter() - t0
    by_k = {}
    for inst in insts:
        by_k[len(inst.shards)] = by_k.get(len(inst.shards), 0) + 1
    print(f"unified sweep: {len(insts)} instances ("
          f"{', '.join(f'k={k} B={n}' for k, n in by_k.items())}; "
          f"{len(insts) // 3} a family), geometric widths (the default) "
          f"{[round(w, 3) for w in walls['geometric']]} s, {u_turns} turns, "
          f"widths {u_widths}, launches {unified_counts}; linear widths "
          f"{[round(w, 3) for w in walls['linear']]} s, {l_turns} turns, "
          f"widths {l_widths}; bucketed run_sweep {b_wall:.3f} s; against "
          f"the buckets and across the policies MEDIAN bitwise, the others "
          f"exact in comm/rounds/convergence/sample sizes/latches, min "
          f"cosine {worst!r}, {bitwise}/{len(insts)} bitwise to the "
          f"buckets; every instance's error within ε + 2/n (largest excess "
          f"{excess!r}) ({card})")
    print(f"unified sweep kernels against plain: {n_held} of its "
          f"{n_calls} kernel calls (each wrapper's widest at each batch "
          f"size and option set) replayed on the recorded inputs, every "
          f"output exact, in {hold_s:.1f} s")

    # -- 17b. ProtocolService at a service's size ----------------------------
    cfg = PoolConfig(**POOL)
    sessions = pool_sessions(datasets, POOL_SESSIONS, POOL["n_pad"])
    hotloop.KEY_LOG.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    runs, dispatch_ms = {}, {}
    for name, sched in (("fault-free", None),
                        ("chaos a", FaultSchedule(**POOL_CHAOS)),
                        ("chaos b", FaultSchedule(**POOL_CHAOS))):
        svc = ProtocolService(cfg, sched, device=dev)
        dispatch_ms[name] = _time_dispatch(svc.pool)
        t0 = time.perf_counter()
        sids, ms, _, calls = _serve(
            svc, sessions, hold_at=POOL_HOLD_TURN if sched is None else None,
            **POOL_STREAM)
        wall = time.perf_counter() - t0
        runs[name] = (svc, sids, ms, wall)
        if sched is None:
            pcalls = calls
    svc, sids, ms, wall = runs["fault-free"]
    half = svc.pool.pool_turn // 2
    with tempfile.TemporaryDirectory() as tmp:
        # the rest of the stream goes to the restored service: every shard
        # is n_pad rows, so each reservoir keeps its rows in order whatever
        # its handle's seed
        part = ProtocolService(cfg, device=dev)
        t0 = time.perf_counter()
        sids3, ms3, done3, _ = _serve(part, sessions, stop_at=half,
                                      **POOL_STREAM)
        part.checkpoint(tmp)
        resumed = ProtocolService.restore(tmp, device=dev)
        sids4, ms4, _, _ = _serve(resumed, sessions[done3:], **POOL_STREAM)
        if sids3 + sids4 != sids:
            raise AssertionError("the restored service numbered its "
                                 "sessions otherwise")
        runs["checkpoint/restore"] = (resumed, sids, ms3 + ms4,
                                      time.perf_counter() - t0)
    torch.cuda.synchronize()
    service_counts = kernels.launches()
    for name in path_kernels:
        if service_counts[name] <= 0:
            raise AssertionError(f"the service runs never launched {name}")
    keys = set(hotloop.KEY_LOG)
    if len(keys) != 1:
        raise AssertionError(f"the service runs launched at {keys}")
    # one full pool turn's kernel calls, replayed against the plain versions
    held_names = sorted({name for name, _, _ in pcalls})
    if len(held_names) != len(path_kernels):
        raise AssertionError(f"pool turn {POOL_HOLD_TURN} called only "
                             f"{held_names}")
    t0 = time.perf_counter()
    for name, e in _hold_calls(pcalls, f"pool turn {POOL_HOLD_TURN}").items():
        held[name] = max(held.get(name, 0), e)
    shapes = sorted({f"{n} {list(max((t for t in a if torch.is_tensor(t)), key=torch.numel).shape)}"
                     for n, a, _ in pcalls})
    print(f"service kernels against plain: the {len(pcalls)} kernel calls "
          f"of fault-free pool turn {POOL_HOLD_TURN} ({', '.join(shapes)}) "
          f"replayed on the recorded inputs, every output exact, in "
          f"{time.perf_counter() - t0:.1f} s")
    del pcalls
    for sid in sids:
        r = svc.result(sid)
        if svc.status(sid) not in ("converged", "budget_exhausted") or not (
                np.isfinite(r.classifier.w).all()
                and np.isfinite(r.classifier.b)):
            raise AssertionError(f"fault-free session {sid}: "
                                 f"{svc.session(sid)}")
    (ca, _, _, _), (cb, _, _, _) = runs["chaos a"], runs["chaos b"]
    quarantined = 0
    for sid in sids:
        if ca.status(sid) != cb.status(sid) or (
                (ca.result(sid) is None) != (cb.result(sid) is None)):
            raise AssertionError(f"chaos runs disagree on session {sid}")
        if ca.status(sid) == "quarantined":
            quarantined += 1
            if ca.result(sid) is not None or not ca.session(sid)[
                    "quarantine_reason"]:
                raise AssertionError(f"quarantined session {sid}: "
                                     f"{ca.session(sid)}")
            continue
        if not (_bitwise(ca.result(sid), cb.result(sid))
                and _bitwise(ca.result(sid), svc.result(sid))):
            raise AssertionError(f"chaos session {sid} is not bitwise the "
                                 f"fault-free one")
    resumed = runs["checkpoint/restore"][0]
    for sid in sids:
        if resumed.status(sid) != svc.status(sid) or not _bitwise(
                resumed.result(sid), svc.result(sid)):
            raise AssertionError(f"restored session {sid} is not bitwise "
                                 f"the uninterrupted one")
    print(f"service: {POOL_SESSIONS} sessions ({POOL_SESSIONS // 3} a "
          f"family, {POOL['n_pad']} points a node streamed in "
          f"{POOL_STREAM['batches']} batches), {cfg}; one launch shape "
          f"{sorted(keys)}; chaos: {quarantined} quarantined, the rest and "
          f"the second chaos run bitwise the fault-free run; checkpoint at "
          f"pool turn {half} restored bitwise; launches {service_counts}")
    for name, (s_, sids_, ms_, wall_) in runs.items():
        st = s_.stats
        share = (f", the dispatch {sum(dispatch_ms[name]):.1f} of "
                 f"{sum(ms_):.1f} ms" if name in dispatch_ms else "")
        print(f"  service {name}: {len(sids_) / wall_:.1f} sessions/s "
              f"({wall_:.3f} s), {s_.pool.pool_turn} pool turns, median "
              f"{float(np.median(ms_)):.3f} ms a pool turn (max "
              f"{max(ms_):.3f}{share}), converged {st['evicted_converged']}, "
              f"budget {st['evicted_budget']}, quarantined "
              f"{st['quarantined']}, dropouts {st['dropouts']}, stragglers "
              f"{st['straggles']}, corruptions {st['corruptions']} ({card})")

    # -- 17c. card against CPU, the same solver loop -------------------------
    small = PoolConfig(**POOL_SMALL)
    sess = pool_sessions(datasets, 24, POOL_SMALL["n_pad"], (0.1, 0.05))
    pools = {}
    for where in (dev, "cpu"):
        pool = SessionPool(small, device=where)
        for shards, eps, sel, seed in sess:
            pool.submit(shards, eps=eps, selector=sel, seed=seed)
        t0 = time.perf_counter()
        pool.run()
        pools[str(where)] = (pool, time.perf_counter() - t0)
    (pc, c_s), (ph, h_s) = pools[str(dev)], pools["cpu"]
    worst = 1.0
    for sid, (_sh, _e, sel, _sd) in enumerate(sess):
        if pc.sessions[sid]["status"] != ph.sessions[sid]["status"]:
            raise AssertionError(f"pool session {sid}: card "
                                 f"{pc.sessions[sid]}, cpu "
                                 f"{ph.sessions[sid]}")
        worst = min(worst, _same_decisions(pc.results[sid],
                                           ph.results[sid], sel,
                                           f"pool session {sid} card vs cpu",
                                           median_atol=1e-6))
    print(f"service card vs cpu: 24 sessions, {small}: statuses, comm, "
          f"rounds and convergence exact, MEDIAN to 1e-6, min cosine "
          f"{worst!r} (card {c_s:.2f} s, {pc.pool_turn} pool turns; cpu "
          f"{h_s:.2f} s)")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return unified_counts, service_counts, held


def _first_diff(got, want, what):
    """Raise unless two result lists are equal bit for bit (``_bitwise``);
    returns how many were compared."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, {len(want)} "
                             f"expected")
    for i, (a, b) in enumerate(zip(got, want)):
        if not _bitwise(a, b):
            raise AssertionError(
                f"{what}: instance {i} differs: {a.comm} {a.rounds} "
                f"{a.converged} {a.classifier} against {b.comm} {b.rounds} "
                f"{b.converged} {b.classifier}")
    return len(got)


def _turn_gate(stats, full_turns):
    """``on()`` for ``_recording`` over one sharded sweep that fills
    ``stats`` (``hotloop.KEY_LOG`` cleared before it): true while the
    sweep's first ``full_turns`` turns dispatch and while its first
    sub-batch turn does (the first of ``stats["shard_dispatches"]``)."""
    from repro_torch.engine import hotloop

    def on():
        return (len(hotloop.KEY_LOG) <= full_turns
                or stats.get("shard_dispatches", 0) == 1)
    return on


def sharded_phase(dev, med_insts, med_res, mm_insts, mm_res):
    """Phase 18a: the MEDIAN smoke grid and MAXMARG's first bucket sharded
    over ``make_data_mesh()`` (every card) and over 2 and 4 logical shards
    on ``dev``, each run bit for bit against the unsharded results of
    phases 3 and 5 (``med_res``, ``mm_res``), the MEDIAN grid also at
    B=3070 (padded with born-done rows where S does not divide it); then
    the dispatch settings timed (``shard_settings``), and one run of each
    over 4 shards recorded: every kernel call of its first full-batch
    turn and of its first sub-batch turn, shard by shard, replayed against
    the plain versions.  Returns the launch counts summed over the sharded
    runs and the largest |kernel - plain| per wrapper of the replay."""
    import torch
    from repro_torch import engine, kernels
    from repro_torch.engine import hotloop
    from repro_torch.launch.mesh import make_data_mesh

    cfg, mm = SMOKE, MAXMARG
    mopts = dict(n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"])
    meshes = [("all cards", make_data_mesh()),
              ("2 on one card", make_data_mesh(device=[dev] * 2)),
              ("4 on one card", make_data_mesh(device=[dev] * 4))]
    total = dict.fromkeys(kernels.launches(), 0)

    def timed(fn, rows, what):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        for name in rows:
            if counts[name] <= 0:
                raise AssertionError(f"{what} never launched {name}")
        return out, wall, counts

    def sharded(fn, rows, want, what):
        stats = {}
        out, wall, counts = timed(lambda: fn(stats), rows, what)
        n = _first_diff(out, want, what)
        for name, c in counts.items():
            total[name] += c
        print(f"18a {what}: {n} instances bit for bit the unsharded "
              f"sweep's, {wall:.3f} s, launches "
              f"{ {r: counts[r] for r in rows} }, stats {stats}")
        return wall

    med_rows = ("median_cut_scores", "median_extremes")
    mm_rows = ("maxmarg_turn_scan", "pegasos_stage")
    base, base_wall, _ = timed(lambda: engine.run_sweep(
        med_insts, device=dev, **mopts), med_rows, "18a unsharded MEDIAN")
    _first_diff(base, med_res, "18a unsharded MEDIAN against phase 3")
    mm_base, mm_wall, _ = timed(lambda: engine.run_sweep(
        mm_insts, device=dev, **mm), mm_rows, "18a unsharded MAXMARG")
    _first_diff(mm_base, mm_res, "18a unsharded MAXMARG against phase 5")
    print(f"18a unsharded: MEDIAN B={len(med_insts)} {base_wall:.3f} s, "
          f"MAXMARG B={len(mm_insts)} {mm_wall:.3f} s (both bit for bit "
          f"phases 3 and 5)")
    for name, mesh in meshes:
        S = mesh.shape["data"]
        for B in (len(med_insts), len(med_insts) - 2):
            sharded(lambda st: engine.run_sweep(
                med_insts[:B], mesh=mesh, stats=st, device=dev, **mopts),
                med_rows, med_res[:B], f"MEDIAN B={B} over {name} (S={S})")
        # phase 5 ran without double buffering; MAXMARG's polish-skip
        # choices follow the view, so the comparison runs without it too
        sharded(lambda st: engine.run_sweep(
            mm_insts, mesh=mesh, overlap=False, stats=st, device=dev, **mm),
            mm_rows, mm_res, f"MAXMARG B={len(mm_insts)} over {name} "
            f"(S={S}), overlap off")
    # the mesh default (double buffering on) against the unsharded loop
    # with double buffering
    ov, ov_wall, _ = timed(lambda: engine.run_sweep(
        mm_insts, overlap=True, device=dev, **mm), mm_rows,
        "18a unsharded MAXMARG, overlap")
    sharded(lambda st: engine.run_sweep(
        mm_insts, mesh=meshes[1][1], stats=st, device=dev, **mm),
        mm_rows, ov, f"MAXMARG B={len(mm_insts)} over 2 on one card, "
        f"overlap on (unsharded with overlap: {ov_wall:.3f} s)")
    shard_settings(dev, med_insts, med_res, mm_insts, ov)

    # every kernel call of a 4-shard run's first full-batch turn (MEDIAN's
    # first two: the first folds its cut scan away) and first sub-batch
    # turn, at the shapes each shard gives it, against the plain versions
    held = {}
    four = meshes[2][1]
    for what, fn, want, rows, full_turns in (
            ("MEDIAN", lambda st: engine.run_sweep(
                med_insts, mesh=four, stats=st, device=dev, **mopts),
             med_res, med_rows, 2),
            ("MAXMARG", lambda st: engine.run_sweep(
                mm_insts, mesh=four, overlap=False, stats=st, device=dev,
                **mm), mm_res, mm_rows, 1)):
        hotloop.KEY_LOG.clear()
        stats = {}
        with _recording(_turn_gate(stats, full_turns)) as calls:
            out, wall, counts = timed(lambda: fn(stats), rows,
                                      f"18a recorded {what}")
        _first_diff(out, want, f"18a recorded {what} over 4 on one card")
        for name, c in counts.items():
            total[name] += c
        sizes = {}
        for name, args, _kw in calls:
            sizes.setdefault(name, []).append(_batched(name, args).shape[0])
        turn1 = len(want) // 4
        if sorted(sizes) != sorted(
                "median_extremes_segments" if r == "median_extremes" else r
                for r in rows):
            raise AssertionError(f"18a {what}: recorded {sorted(sizes)}")
        if (any(bs.count(turn1) < 4 for bs in sizes.values())
                or all(b == turn1 for bs in sizes.values() for b in bs)):
            raise AssertionError(f"18a {what}: recorded at batch sizes "
                                 f"{sizes}")
        t0 = time.perf_counter()
        for name, e in _hold_calls(calls, f"18a {what} over 4").items():
            held[name] = max(held.get(name, 0), e)
        print(f"18a {what} over 4 on one card, recorded ({wall:.3f} s, bit "
              f"for bit): the {len(calls)} kernel calls of its first "
              f"{full_turns} turn(s) and first sub-batch turn, shard by shard (batch sizes "
              f"{ {n: sorted(set(b)) for n, b in sizes.items()} }), "
              f"replayed against the plain versions, every output exact, in "
              f"{time.perf_counter() - t0:.1f} s")
        del calls
    return total, held


def shard_settings(dev, med_insts, med_res, mm_insts, mm_ov):
    """The dispatch settings against each other on one card: the MEDIAN
    grid and MAXMARG's first bucket, double buffering on, unsharded and
    over meshes of 1 and 4 shards on ``dev``, each with donation off and
    on, run in one order and then the reverse; every run bit for bit its
    reference (``med_res``; ``mm_ov``, the unsharded MAXMARG run with
    double buffering).  Prints and returns the walls per setting."""
    import torch
    from repro_torch import engine
    from repro_torch.launch.mesh import make_data_mesh

    cfg, mm = SMOKE, MAXMARG
    mopts = dict(n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"])
    layouts = [("unsharded", None), ("S=1", make_data_mesh(device=[dev])),
               ("S=4", make_data_mesh(device=[dev] * 4))]
    order = [(lay, mesh, donate) for lay, mesh in layouts
             for donate in (False, True)]
    walls = {}
    for what, insts, want, opts in (("MEDIAN", med_insts, med_res, mopts),
                                    ("MAXMARG", mm_insts, mm_ov, mm)):
        for lay, mesh, donate in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.run_sweep(insts, mesh=mesh, donate=donate,
                                   overlap=True, device=dev, **opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            label = f"donate {'on' if donate else 'off'}"
            _first_diff(out, want, f"18a {what} {lay} {label}")
            walls.setdefault((what, lay, label), []).append(wall)
        print(f"18a settings, {what} B={len(insts)}, overlap on, bit for bit "
              f"in every run (walls in s, in run order then reversed): "
              + "; ".join(f"{lay} {label} {[round(w, 3) for w in ws]}"
                          for (wh, lay, label), ws in walls.items()
                          if wh == what))
    return walls


def _hold_ranges(calls, what):
    """Every recorded ``threshold_ranges_one`` call again, the kernel
    against the plain version on the same inputs, lo and hi exact (signs
    of zero and infinities included)."""
    import torch
    from repro_torch import kernels
    for i, (V, Xw, yw) in enumerate(calls):
        got = kernels.threshold_ranges_one(V, Xw, yw)
        want = kernels.threshold_ranges_plain(V, Xw[None], yw[None])
        for name, g, e in zip(("lo", "hi"), got, want):
            _same_floats(g, e[0], f"{what} call {i}: {name}")
            if not torch.equal(torch.signbit(g), torch.signbit(e[0])):
                raise AssertionError(f"{what} call {i}: {name} signs")
    return len(calls)


def two_way_phase(dev):
    """Phases 18b and 18c: §5's MEDIAN with rotation bits and §8.2's noisy
    MAXMARG on the card, their kernel calls recorded and replayed against
    the plain versions, and each run card against CPU.  Returns the launch
    counts of each protocol's card runs."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import datasets
    from repro_torch.core.protocols import two_way
    from repro_torch.kernels import pegasos

    counts = {}

    def against_cpu(name, fn, sep_atol, wrapper):
        """The card run (the launches of ``wrapper`` counted from 0), then
        the CPU run: comm, rounds, convergence and extras exact, separators
        to ``sep_atol`` of their scale."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        a = fn(dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = kernels.launches()[wrapper]
        t0 = time.perf_counter()
        b = fn("cpu")
        cpu_s = time.perf_counter() - t0
        if (a.comm, a.rounds, a.converged, a.extra) != \
                (b.comm, b.rounds, b.converged, b.extra):
            raise AssertionError(f"{name}: card {a.comm} {a.rounds} "
                                 f"{a.converged} {a.extra}, cpu {b.comm} "
                                 f"{b.rounds} {b.converged} {b.extra}")
        gap = max(float(np.abs(a.classifier.w - b.classifier.w).max()),
                  abs(float(a.classifier.b) - float(b.classifier.b)))
        scale = max(1.0, float(np.abs(b.classifier.w).max()),
                    abs(float(b.classifier.b)))
        if not gap <= sep_atol * scale:
            raise AssertionError(f"{name}: separators {a.classifier} and "
                                 f"{b.classifier}")
        return a, wall, cpu_s, gap, launched

    # -- 18b: iterative_support_median_bit ----------------------------------
    bit_runs = [(f"{g.__name__}", g(n_per_node=1000, k=2, seed=0), 0.05)
                for g in (datasets.data1, datasets.data2, datasets.data3)]
    bit_runs.append(("data3 + 5% noise", datasets.add_label_noise(
        datasets.data3(n_per_node=1000, k=2, seed=0), 0.05, seed=1), 0.02))
    calls = []
    recording = [False]
    real = kernels.threshold_ranges_one

    def record(V, Xw, yw):
        if recording[0]:
            calls.append((V.clone(), Xw.clone(), yw.clone()))
        return real(V, Xw, yw)

    launches_b = 0
    kernels.threshold_ranges_one = record
    try:
        for name, shards, eps in bit_runs:
            def run(device):
                recording[0] = device == dev
                return two_way.iterative_support_median_bit(
                    shards, eps=eps, n_angles=1024, device=device)
            ncalls = len(calls)
            r, wall, cpu_s, gap, launched = against_cpu(
                f"18b {name}", run, 1e-6, "threshold_ranges")
            launches_b += launched
            if launched != len(calls) - ncalls:
                raise AssertionError(f"18b {name}: {launched} launches for "
                                     f"{len(calls) - ncalls} calls")
            print(f"18b median_bit {name} ε={eps}: {r.rounds} rounds, "
                  f"converged {r.converged}, comm {r.comm}, "
                  f"{launched} threshold_ranges_one launches, card "
                  f"{wall:.3f} s ({wall / r.rounds * 1e3:.2f} ms a round), "
                  f"cpu {cpu_s:.2f} s, separator |card - cpu| {gap}")
    finally:
        kernels.threshold_ranges_one = real
    recording[0] = False
    counts["median_bit"] = dict(
        dict.fromkeys(kernels.launches(), 0), threshold_ranges=launches_b)
    if launches_b <= 0:
        raise AssertionError("18b never launched threshold_ranges_one")
    t0 = time.perf_counter()
    n = _hold_ranges(calls, "18b threshold_ranges_one replay")
    print(f"18b: {n} recorded threshold_ranges_one calls replayed, kernel "
          f"and plain version equal in every lo and hi "
          f"({time.perf_counter() - t0:.2f} s)")
    del calls

    # -- 18c: iterative_support_noisy ---------------------------------------
    # the solver looks the stage up in kernels.pegasos at each call; the
    # recorder forwards the wrapper's launch count (it counts through that
    # module-level name)
    recorded = []
    real_stage = pegasos.pegasos_stage
    launches_c = 0
    pegasos.pegasos_stage = _Recorder(real_stage, "pegasos_stage", recorded,
                                      lambda: recording[0])
    try:
        for rate in (0.05, 0.10):
            noisy = datasets.add_label_noise(
                datasets.data3(n_per_node=500, k=2, seed=0), rate=rate)

            def run(device):
                recording[0] = device == dev
                return two_way.iterative_support_noisy(noisy, eps=0.05,
                                                       device=device)
            r, wall, cpu_s, gap, launched = against_cpu(
                f"18c noisy {rate:.0%}", run, 1e-6, "pegasos_stage")
            launches_c += launched
            print(f"18c noisy {rate:.0%}: {r.rounds} rounds, converged "
                  f"{r.converged}, best_err {r.extra['best_err']}, comm "
                  f"{r.comm}, {launched} pegasos_stage launches at B=1, card "
                  f"{wall:.3f} s ({wall / r.rounds * 1e3:.2f} ms a round), "
                  f"cpu {cpu_s:.2f} s, separator |card - cpu| {gap}")
    finally:
        pegasos.pegasos_stage = real_stage
    recording[0] = False
    counts["noisy"] = dict(dict.fromkeys(kernels.launches(), 0),
                           pegasos_stage=launches_c)
    stage_calls = [(args, kw) for _name, args, kw in recorded]
    if launches_c != len(stage_calls) or not stage_calls:
        raise AssertionError(f"18c: {launches_c} stage launches, "
                             f"{len(stage_calls)} calls")
    t0 = time.perf_counter()
    for i, (args, kw) in enumerate(stage_calls):
        if args[0].shape[0] != 1:
            raise AssertionError(f"18c call {i}: B={args[0].shape[0]}")
        got = kernels.pegasos_stage(*args, **kw)
        want = kernels.pegasos_stage_plain(*args, **kw)
        for name, g, e in zip(("w", "b", "mmin", "found", "w_best",
                               "b_best"), got, want):
            if not torch.equal(g, e):
                raise AssertionError(f"18c call {i}: {name} differs from "
                                     f"the plain stage: {g} against {e}")
    print(f"18c: {len(stage_calls)} recorded pegasos_stage calls (B=1, "
          f"N={sorted({a[0].shape[1] for a, _ in stage_calls})}, nsteps "
          f"{sorted({k['nsteps'] for _, k in stage_calls})}) replayed, "
          f"every output bit for bit the plain stage's "
          f"({time.perf_counter() - t0:.2f} s)")
    return counts


def _grads(lm, mcfg, batch):
    """(loss, gradient of every parameter in ``lm.named_parameters()``
    order) of ``forward_train`` in f32 on the weights' device."""
    import torch
    from repro_torch.models import model as lm_model
    lm.requires_grad_()
    loss, _ = lm_model.forward_train(lm, mcfg, batch, dtype=torch.float32)
    return loss.detach(), torch.autograd.grad(loss, list(lm.parameters()))


def _worst_leaf(lm, got, want):
    """The parameter whose gradient lies farthest from ``want`` in units of
    max(1, max |want|): (name, that ratio)."""
    worst = (-1.0, "")
    for (name, _), g, w in zip(lm.named_parameters(), got, want):
        err = float((g.cpu() - w).abs().max()) / max(1.0,
                                                     float(w.abs().max()))
        worst = max(worst, (err, name))
    return worst[1], worst[0]


def training_phase(dev):
    """Phase 20: training on the card through ``repro_torch.train``.

    20a smollm-135m at full width and depth (``Trainer``, bf16 over f32
    masters, plain attention): every step's loss and gradient norm finite
    and the loss falling; remat's step-1 loss equal and its peak memory
    lower; microbatches 1 and 2 in f32 one update apart at JAX's tier,
    their first moments (the gradients) within ``MB_MU_TOL``; a save, load and two more steps equal to two steps without; then
    ``python -m repro_torch.launch.train`` in-process.  20b rwkv6-7b and 20c
    Jamba without experts at every published width, depth cut (2 WKV
    launches a step, 1 scan launch a step: the forward's, none in
    backward).  20d gradients card against CPU in f32.  20e the raw
    wrappers refuse inputs that require a gradient.  Returns the launches
    per path and, for phase 21, 20a's and 20b's losses and peak memory."""
    import copy
    import dataclasses
    import itertools
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_stream
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers, model as lm_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import adamw_update, leaves
    from repro_torch.train import (TrainConfig, Trainer, load_checkpoint,
                                   make_train_step, save_checkpoint)

    t_phase = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on for f32 matmuls")
    bf16, f32 = torch.bfloat16, torch.float32
    zero = dict.fromkeys(kernels.launches(), 0)
    paths = {}
    layers.set_attention_impl("plain")    # no flash backward, as in JAX
    torch.cuda.empty_cache()

    def check(what, got, expect):
        if got != dict(zero, **expect):
            raise AssertionError(f"{what} launched {got}; expected {expect}")

    def stream(mcfg, B, S, seed=0):
        return synthetic_stream(mcfg, DataConfig(seq_len=S, global_batch=B,
                                                 seed=seed))

    def gb(n_bytes):
        return f"{n_bytes / 1e9:.2f} GB"

    def params_equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                    b.parameters()))

    # -- 20a. smollm-135m: the Trainer at full width and depth ---------------
    t0 = time.perf_counter()
    ts = TRAIN_SMOLLM
    cfg = get_config(ts["arch"])
    B, S = ts["B"], ts["S"]
    base = lm_model.init_lm(cfg, seed=0, device=dev)
    tc = TrainConfig(steps=ts["steps"], warmup=ts["warmup"], log_every=1,
                     dtype=bf16, optim=AdamWConfig(lr=ts["lr"]))
    tr = Trainer(cfg, tc, stream(cfg, B, S), params=copy.deepcopy(base))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    tr.run()
    torch.cuda.synchronize()
    got = kernels.launches()
    check("20a smollm-135m training", got, {})
    paths["train_smollm"] = got
    peak = torch.cuda.max_memory_allocated()
    refs = {"20a": dict(losses=[h["loss"] for h in tr.history], peak=peak)}
    losses = [h["loss"] for h in tr.history]
    gnorms = [h["grad_norm"] for h in tr.history]
    if not (len(losses) == ts["steps"]
            and np.isfinite(losses + gnorms).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"20a losses {losses}, grad norms {gnorms}")
    steps_s = np.diff([0.0] + [h["wall_s"] for h in tr.history])
    step_ms = float(np.median(steps_s)) * 1e3
    print(f"20a {cfg.name} training B={B} S={S} bf16 over f32 masters, "
          f"{ts['steps']} steps, lr {ts['lr']} warmup {ts['warmup']}: loss "
          f"{losses[0]!r} -> {losses[-1]!r}, grad norm {gnorms[0]:.4f} -> "
          f"{gnorms[-1]:.4f}; median step {step_ms:.2f} ms (steps "
          f"{[round(float(s) * 1e3, 1) for s in steps_s]}), "
          f"{B * S / (step_ms / 1e3):.0f} training tokens/s, peak "
          f"{gb(peak)} (max_memory_allocated)")

    def wall_ms(fn, reps=3):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        return float(np.median(walls)) * 1e3

    # where a step goes: the forward alone (no autograd) and the update
    # alone (the weights' own values standing in for gradients)
    batch = next(stream(cfg, B, S, seed=1))
    with torch.no_grad():
        fwd_ms = wall_ms(lambda: lm_model.forward_train(tr.params, cfg,
                                                        batch, tc.flags))
    fake = tr.params.tree()
    upd_ms = wall_ms(lambda: adamw_update(tc.optim, tr.params, fake,
                                          tr.opt_state, 1.0))
    print(f"20a step {step_ms:.2f} ms: forward alone (no autograd) "
          f"{fwd_ms:.2f} ms, AdamW update alone {upd_ms:.2f} ms "
          f"({len(leaves(fake))} leaves), the rest (backward with the recomputed "
          f"attention blocks and loss chunks) {step_ms - fwd_ms - upd_ms:.2f}"
          f" ms")
    del tr, fake
    torch.cuda.empty_cache()

    kernels.reset_launches()
    step_loss, step_peak = {}, {}
    for remat in (False, True):
        lm = copy.deepcopy(base)
        opt = adamw_init(lm)
        step = make_train_step(cfg, dataclasses.replace(
            tc, flags=lm_model.RunFlags(remat=remat)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, met = step(lm, opt, batch)
        torch.cuda.synchronize()
        step_loss[remat] = float(met["loss"])
        step_peak[remat] = torch.cuda.max_memory_allocated()
        del lm, opt, met
    if not (abs(step_loss[True] - step_loss[False])
            <= 1e-6 * abs(step_loss[False])
            and step_peak[True] < step_peak[False]):
        raise AssertionError(f"20a remat: losses {step_loss}, peaks "
                             f"{step_peak}")
    same = step_loss[True] == step_loss[False]
    print(f"20a remat: step-1 loss {step_loss[False]!r} without, "
          f"{step_loss[True]!r} with ({'' if same else 'not '}bit for bit); "
          f"peak {gb(step_peak[False])} -> {gb(step_peak[True])}")

    # microbatches 1 and 2 in f32 at JAX's test_microbatch_grad_equivalence
    # tier (its optimiser: AdamWConfig()); where the first step's gradient
    # lies within 100 eps of 0, lr g / (|g| + eps) turns on its last bits:
    # those weights are held to the update's range instead, and every
    # weight's gradient through the first moment (0.1 · clip · g) of the
    # two runs, to MB_MU_TOL of each leaf's scale
    runs = []
    for mb in (1, 2):
        lm = copy.deepcopy(base)
        tcm = dataclasses.replace(tc, dtype=f32, microbatches=mb,
                                  optim=AdamWConfig())
        _, opt, met = make_train_step(cfg, tcm)(lm, adamw_init(lm), batch)
        runs.append((lm, opt, met))
    (l1, o1, m1), (l2, o2, m2) = runs
    lr = tcm.optim.lr * float(m1["lr_scale"])
    worst, tiny_n, mu_worst = -1.0, 0, 0.0
    with torch.no_grad():
        for a, b, mu, mu2 in zip(leaves(l2), leaves(l1), leaves(o1["mu"]),
                                 leaves(o2["mu"])):
            rel = float((mu2 - mu).abs().max()) / max(
                float(mu.abs().max()), 1e-30)
            mu_worst = max(mu_worst, rel)
            if not rel <= MB_MU_TOL:
                raise AssertionError(f"20a microbatches: a first moment "
                                     f"{rel:.3g} of its scale apart")
            tiny = mu.abs() < 0.1 * 100 * tcm.optim.eps   # mu = 0.1 clip g
            diff = (a - b).abs()
            excess = torch.where(tiny, -1.0, diff - (1e-5 + 1e-4 * b.abs()))
            worst = max(worst, float(excess.max()))
            if bool((diff[tiny] > 2 * lr).any()):
                raise AssertionError("20a microbatches: an update beyond lr")
            tiny_n += int(tiny.sum())
    if worst > 0 or abs(float(m1["loss"]) - float(m2["loss"])) > 1e-4 * abs(
            float(m1["loss"])):
        raise AssertionError(f"20a microbatches: weights beyond rtol 1e-4 "
                             f"atol 1e-5 by {worst}, losses {m1['loss']} "
                             f"and {m2['loss']}")
    print(f"20a microbatches 1 and 2, f32, one step: loss "
          f"{float(m1['loss'])!r} and {float(m2['loss'])!r}, every weight "
          f"within rtol 1e-4 atol 1e-5 ({tiny_n} of "
          f"{sum(t.numel() for t in leaves(l1))} with |g| < 100 eps: within "
          f"lr); every first moment within {mu_worst:.3g} of its leaf's "
          f"scale (tier {MB_MU_TOL})")
    del runs, l1, l2, o1, o2
    torch.cuda.empty_cache()

    # save, load into a fresh trainer, two more steps: equal to two more
    # steps without the reload
    batches = list(itertools.islice(stream(cfg, B, S, seed=2), 4))
    tc32 = dataclasses.replace(tc, dtype=f32)
    with tempfile.TemporaryDirectory() as tmp:
        a = Trainer(cfg, tc32, iter(batches), params=copy.deepcopy(base))
        a.run(2)
        save_checkpoint(tmp, a.params, a.opt_state,
                        step=int(a.opt_state["step"]))
        a.run(2)
        lm, opt, step = load_checkpoint(tmp, cfg, device=dev)
        b = Trainer(cfg, tc32, iter(batches[2:]), params=lm)
        b.opt_state = opt
        b.run(2)
        with torch.no_grad():
            worst = max(float((x - y).abs().max() / y.abs().max())
                        for x, y in zip(leaves(b.params), leaves(a.params)))
        state_bits = int(b.opt_state["step"]) == 4 and all(
            torch.equal(x, y) for part in ("mu", "nu") for x, y in zip(
                leaves(b.opt_state[part]), leaves(a.opt_state[part])))
        if not (step == 2 and worst <= 1e-6):
            raise AssertionError(f"20a resume: step {step}, weights differ "
                                 f"by {worst} of a leaf's scale")
        same = ("bit for bit" if params_equal(a.params, b.params)
                else f"to {worst!r} of a leaf's scale")
        print(f"20a resume at step 2, two more steps f32: weights {same}, "
              f"AdamW state {'' if state_bits else 'not '}bit for bit")
        del a, b, lm, opt
        torch.cuda.empty_cache()

        t1 = time.perf_counter()
        kernels.reset_launches()
        last = launch_train.main(["--arch", ts["arch"], "--steps", "5",
                                  "--batch", str(B), "--seq", str(S),
                                  "--ckpt", tmp])
        torch.cuda.synchronize()
        got = kernels.launches()
        check("20a launcher", got, {})
        paths["train_launcher"] = got
        _, _, step = load_checkpoint(tmp, cfg, device="cpu")
        if not (np.isfinite(last["loss"]) and step == 5):
            raise AssertionError(f"20a launcher: {last}, checkpoint step "
                                 f"{step}")
        print(f"20a python -m repro_torch.launch.train --arch {ts['arch']} "
              f"--steps 5 --batch {B} --seq {S} (f32): loss "
              f"{last['loss']!r}, checkpoint at step {step}, "
              f"{time.perf_counter() - t1:.1f} s")
    del base
    torch.cuda.empty_cache()
    print(f"20a: {time.perf_counter() - t0:.1f} s")

    # -- 20b, 20c. the SSM families: one scan launch a mixer a step ----------
    rcfg = dataclasses.replace(get_config("rwkv6-7b"),
                               n_layers=TRAIN_RWKV["layers"])
    jcfg = dataclasses.replace(
        jamba_dense(get_config("jamba-1.5-large-398b")), n_layers=2,
        period=(("mamba", "mlp"), ("attn", "mlp")))
    for tag, mcfg, shape, wrapper in (("20b", rcfg, TRAIN_RWKV, "rwkv6"),
                                      ("20c", jcfg, TRAIN_JAMBA,
                                       "mamba_scan")):
        t0 = time.perf_counter()
        lm = lm_model.init_lm(mcfg, seed=0, device=dev)
        n = sum(t.numel() for t in lm.parameters())
        mixers = sum(m in ("rwkv", "mamba") for m, _ in mcfg.period) * (
            mcfg.n_layers // len(mcfg.period))
        tcs = TrainConfig(steps=shape["steps"], warmup=2, dtype=bf16,
                          optim=AdamWConfig())
        step = make_train_step(mcfg, tcs)
        opt = adamw_init(lm)
        data = stream(mcfg, shape["B"], shape["S"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, logs = [], []
        for _ in range(shape["steps"]):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lm, opt, met = step(lm, opt, next(data))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            got = kernels.launches()
            check(f"{tag} {mcfg.name} training step", got,
                  {wrapper: mixers})
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"{tag} loss {loss}, grad norm {gnorm}")
            logs.append((loss, gnorm))
        paths[f"train_{wrapper}"] = {k: v * shape["steps"]
                                     for k, v in got.items()}
        refs[tag] = dict(losses=[loss for loss, _ in logs],
                         peak=torch.cuda.max_memory_allocated())
        print(f"{tag} {mcfg.name} ({mcfg.n_layers} layers, {n} parameters, "
              f"param_count {mcfg.param_count()}) training B={shape['B']} "
              f"S={shape['S']} bf16 over f32 masters: {got[wrapper]} "
              f"{wrapper} launches a step (none in backward); (loss, grad "
              f"norm) {logs}; steps {[round(w * 1e3, 1) for w in walls]} "
              f"ms, {shape['B'] * shape['S'] / np.median(walls):.0f} "
              f"tokens/s; peak {gb(torch.cuda.max_memory_allocated())}; "
              f"{time.perf_counter() - t0:.1f} s")
        del lm, opt, step, met
        torch.cuda.empty_cache()

    # -- 20d. gradients card against CPU in f32, the same weights -----------
    t0 = time.perf_counter()
    free = _host_free_gb()
    # the CPU side holds f32 weights and gradients: 8 bytes a parameter
    need = 8 * jcfg.param_count() / 1e9 * 1.25
    print(f"20d: host memory available {free:.1f} GB (Jamba at 2 layers "
          f"needs ~{need:.0f} GB)")
    jcheck = jcfg if free > need else jcfg.reduced()
    if jcheck is not jcfg:
        print("20d: Jamba compared at its reduced widths")
    kernels.reset_launches()
    c = TRAIN_CHECK
    for mcfg in (rcfg, jcheck, get_config("grok-1-314b").reduced(),
                 get_config("deepseek-v2-236b").reduced()):
        lm = lm_model.init_lm(mcfg, seed=0, device=dev)
        on_cpu = lm_model.LM(mcfg, lm_model.cast_params(lm, f32,
                                                         device="cpu"))
        b1 = next(stream(mcfg, c["B"], c["S"], seed=1))
        lc, gc = _grads(lm, mcfg, b1)
        t1 = time.perf_counter()
        lh, gh = _grads(on_cpu, mcfg, b1)
        cpu_s = time.perf_counter() - t1
        name, err = _worst_leaf(on_cpu, gc, gh)
        if not (abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
                and err <= GRAD_TOL):
            raise AssertionError(f"20d {mcfg.name}: loss card {float(lc)!r}"
                                 f" cpu {float(lh)!r}; worst leaf {name} "
                                 f"{err!r}")
        print(f"20d {mcfg.name} ({mcfg.n_layers} layers) B={c['B']} "
              f"S={c['S']} f32: loss card {float(lc)!r} cpu {float(lh)!r}; "
              f"every leaf's gradient within {GRAD_TOL} x max(1, max|g|), "
              f"worst {name} {err:.3g} (cpu side {cpu_s:.1f} s)")
        del lm, on_cpu, gc, gh
        torch.cuda.empty_cache()
    got = kernels.launches()
    check("20d card vs cpu", got, dict(rwkv6=rcfg.n_layers, mamba_scan=1))
    paths["train_card_vs_cpu_f32"] = got
    print(f"20d: {time.perf_counter() - t0:.1f} s")

    # -- 20e. the grad guards -------------------------------------------------
    kernels.reset_launches()

    def rnd(*shape, grad=False):
        return torch.rand(shape, device=dev).mul_(0.5).add_(0.25) \
            .requires_grad_(grad)

    calls = {
        "rwkv6": lambda: kernels.rwkv6(rnd(1, 16, 2, 32, grad=True),
                                       rnd(1, 16, 2, 32), rnd(1, 16, 2, 32),
                                       rnd(1, 16, 2, 32), rnd(2, 32)),
        "mamba_scan": lambda: kernels.mamba_scan(
            rnd(1, 16, 32), rnd(1, 16, 32, grad=True), -rnd(32, 16),
            rnd(1, 16, 16), rnd(1, 16, 16)),
        "attention": lambda: kernels.attention(
            rnd(1, 16, 2, 64), rnd(1, 16, 2, 64),
            rnd(1, 16, 2, 64, grad=True), causal=True)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "carry no gradient" not in str(e):
                raise
            print(f"20e {name} on an input that requires a gradient: "
                  f"RuntimeError({str(e)!r})")
        else:
            raise AssertionError(f"20e {name} launched on an input that "
                                 f"requires a gradient")
    check("20e grad guards", kernels.launches(), {})
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return paths, refs


class _ModelRecorder(_Recorder):
    """:class:`_Recorder` for the model's kernels (the flash wrapper also
    counts per route through its module-level name); records only calls
    on the card."""

    @property
    def routes(self):
        return self.fn.routes

    @routes.setter
    def routes(self, r):
        self.fn.routes = r

    def __call__(self, *args, **kw):
        import torch
        if self.on() and torch.is_tensor(args[0]) and args[0].is_cuda:
            self.calls.append((self.name, tuple(
                a.detach().clone() if torch.is_tensor(a) else a
                for a in args), dict(kw)))
        return self.fn(*args, **kw)


@contextlib.contextmanager
def _model_recording(on):
    """While open, the model's calls of the WKV, scan and flash wrappers
    made while ``on()`` holds are recorded (where ``models.ssm`` and
    ``models.layers`` and the scans' autograd Functions look them up):
    yields the list of ``(wrapper name, arguments, options)``."""
    from repro_torch import kernels
    fa, rw, mb = (sys.modules[f"repro_torch.kernels.{m}"]
                  for m in ("flash_attention", "rwkv6", "mamba"))
    sites = ((kernels, "rwkv6", "rwkv6"), (rw, "rwkv6", "rwkv6"),
             (kernels, "mamba_scan", "mamba_scan"),
             (mb, "mamba_scan", "mamba_scan"), (fa, "attention", "attention"))
    calls = []
    saved = [getattr(mod, attr) for mod, attr, _ in sites]
    try:
        for (mod, attr, name), fn in zip(sites, saved):
            setattr(mod, attr, _ModelRecorder(fn, name, calls, on))
        yield calls
    finally:
        for (mod, attr, _), fn in zip(sites, saved):
            setattr(mod, attr, fn)


def _hold_model_calls(calls, what):
    """Each recorded call again, the kernel against its plain version on
    the same inputs: the scans' y and final state to SSM_TOL of their
    scale, attention to ATTN_TOL.  Returns the largest |kernel - plain|
    per wrapper (attention per route, ``attention_<route>``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    errs = {}
    for name, args, kw in calls:
        label = f"{what}: {name} {[tuple(a.shape) for a in args]}"
        if name == "attention":
            route = fa.attention_route(args[0].dtype, args[0].shape[-1],
                                       args[0].shape[1], args[1].shape[1])
            got = kernels.attention(*args, **kw).float()
            want = kernels.attention_plain(*args, **kw).float()
            rtol, atol = ATTN_TOL[str(args[0].dtype).split(".")[1]]
            diff = (got - want).abs()
            if not (bool(torch.isfinite(got).all())
                    and bool((diff <= atol + rtol * want.abs()).all())):
                raise AssertionError(f"{label} ({route}): kernel and plain "
                                     f"version differ by {float(diff.max())}")
            key = f"attention_{route}"
            errs[key] = max(errs.get(key, 0.0), float(diff.max()))
            continue
        got = getattr(kernels, name)(*args, **kw)
        want = getattr(kernels, name + "_plain")(*args)
        for part, g, e in zip(("y", "state"), got, want):
            tol = SSM_TOL[str(g.dtype).split(".")[1]]
            diff = float((g.float() - e.float()).abs().max())
            scale = max(1.0, float(e.float().abs().max()))
            if not (bool(torch.isfinite(g.float()).all())
                    and diff <= tol * scale):
                raise AssertionError(f"{label}: {part} of kernel and plain "
                                     f"version differ by {diff} (scale "
                                     f"{scale})")
            errs[name] = max(errs.get(name, 0.0), diff)
    return errs


def _mesh_config(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "rwkv6-7b":
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_RWKV["layers"])
    return cfg


def _mesh_train_config(arch):
    """The TrainConfig of 20a (smollm-135m) or 20b (rwkv6-7b), and its
    (B, S)."""
    import torch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    if arch == "smollm-135m":
        ts = TRAIN_SMOLLM
        return TrainConfig(steps=ts["steps"], warmup=ts["warmup"],
                           log_every=1, dtype=torch.bfloat16,
                           optim=AdamWConfig(lr=ts["lr"])), ts["B"], ts["S"]
    tr = TRAIN_RWKV
    return TrainConfig(steps=tr["steps"], warmup=2, dtype=torch.bfloat16,
                       optim=AdamWConfig()), tr["B"], tr["S"]


def _mesh_shapes(n):
    """The (data, model) meshes over ``n`` cards: all data and all model
    parallel, or (1, 1) on one card."""
    return [(n, 1), (1, n)] if n > 1 else [(1, 1)]


def _mesh_jobs(n):
    """Phase 21b's training jobs over ``n`` cards, (tag, arch, mesh
    shape): smollm-135m on every mesh but (1, 1) (21a's), rwkv6-7b on
    every mesh."""
    return [(f"{'smollm' if a == 'smollm-135m' else 'rwkv'}_{d}x{m}", a,
             (d, m))
            for d, m in _mesh_shapes(n)
            for a in ("smollm-135m", "rwkv6-7b")
            if (d, m) != (1, 1) or a != "smollm-135m"]


def _mesh_scoring(n):
    """Phase 21b's scoring jobs over ``n`` cards, (tag, arch, mesh shape):
    smollm-135m on every mesh, Jamba without experts on the last."""
    shapes = _mesh_shapes(n)
    return ([(f"score_smollm_{d}x{m}", "smollm-135m", (d, m))
             for d, m in shapes]
            + [(f"score_jamba_{shapes[-1][0]}x{shapes[-1][1]}", "jamba",
                shapes[-1])])


def _mesh_rank_jobs(rank, world, log):
    """Phase 21b on this rank: each of ``_mesh_jobs(world)`` trained
    ``MESH_STEPS`` steps (rwkv6-7b's first step's WKV calls recorded),
    then scoring under the flash kernel (calls recorded), every recorded
    call replayed against its plain version.  ``log`` takes a line of
    progress.  Returns the results."""
    import torch
    from repro_torch import kernels
    from repro_torch.data import DataConfig, synthetic_stream
    from repro_torch.distribution.constraints import set_dp_axes, use_mesh
    from repro_torch.distribution.sharding import (batch_specs, distribute,
                                                   mesh_axes)
    from repro_torch.launch.train import make_launch_mesh, place
    from repro_torch.models import layers, model as lm_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import host_value

    dev = torch.device("cuda")
    out, record = {}, {"on": False}
    with _model_recording(lambda: record["on"]) as calls:
        for tag, arch, shape in _mesh_jobs(world):
            cfg = _mesh_config(arch)
            tc, B, S = _mesh_train_config(arch)
            log(f"{tag}: mesh {shape}")
            mesh = make_launch_mesh("cuda", shape)
            pure_dp = shape[1] == 1
            set_dp_axes(("pod", "data", "model") if pure_dp else None)
            lm = lm_model.init_lm(cfg, seed=0, device=dev)
            params, opt = place(lm, adamw_init(lm), mesh, pure_dp=pure_dp)
            del lm
            step = make_train_step(cfg, tc, mesh, pure_dp)
            log(f"{tag}: placed")
            data = synthetic_stream(cfg, DataConfig(seq_len=S,
                                                    global_batch=B))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res = dict(losses=[], gnorms=[], ms=[], launches=[])
            for i in range(MESH_STEPS):
                batch = next(data)
                kernels.reset_launches()
                record["on"] = i == 0 and arch == "rwkv6-7b"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                torch.cuda.synchronize()
                res["ms"].append((time.perf_counter() - t0) * 1e3)
                record["on"] = False
                res["launches"].append(kernels.launches())
                res["losses"].append(float(host_value(met["loss"])))
                res["gnorms"].append(float(host_value(met["grad_norm"])))
                log(f"{tag} step {i}: loss {res['losses'][-1]!r}, "
                    f"{res['ms'][-1]:.1f} ms")
            res["peak"] = torch.cuda.max_memory_allocated()
            set_dp_axes(None)
            out[tag] = res
            del params, opt, step, met
            torch.cuda.empty_cache()

        # scoring under the flash kernel: smollm-135m on both meshes, Jamba
        # without experts (one Mamba and one attention layer) on the model
        # mesh; no gradient, bf16
        import dataclasses
        from repro_torch.configs import get_config
        layers.set_attention_impl("kernel")
        jcfg = dataclasses.replace(
            jamba_dense(get_config("jamba-1.5-large-398b")), n_layers=2,
            period=(("mamba", "mlp"), ("attn", "mlp")))
        for tag, arch, shape in _mesh_scoring(world):
            cfg = jcfg if arch == "jamba" else get_config(arch)
            B = MESH_SCORING["jamba_B"] if arch == "jamba" else SCORING["B"]
            mesh = make_launch_mesh("cuda", shape)
            lm = lm_model.init_lm(cfg, seed=0, dtype=torch.bfloat16,
                                  device=dev)
            params, _ = place(lm, None, mesh)
            del lm
            host = {k: torch.as_tensor(v).to(mesh.device_type)
                    for k, v in next(synthetic_stream(cfg, DataConfig(
                        seq_len=MESH_SCORING["S"], global_batch=B))).items()}
            batch = distribute(host, batch_specs(mesh_axes(mesh), host),
                               mesh)
            kernels.reset_launches()
            record["on"] = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_mesh(mesh), torch.no_grad():
                loss, _ = lm_model.forward_train(params, cfg, batch)
                loss = float(host_value(loss))
            torch.cuda.synchronize()
            record["on"] = False
            out[tag] = dict(loss=loss, launches=kernels.launches(),
                            routes=dict(kernels.attention.routes),
                            ms=(time.perf_counter() - t0) * 1e3)
            log(f"{tag}: loss {loss!r}")
            del params, batch
            torch.cuda.empty_cache()
        layers.set_attention_impl("plain")
        out["n_calls"] = len(calls)
        out["errs"] = _hold_model_calls(calls, f"21b rank {rank}")
    return out


def _mesh_rank(rank, world, port, q):
    """One of phase 21b's ranks: NCCL, card ``rank``.  Its progress goes
    to ``build/phase21/rank<r>.log`` (with every thread's stack
    should it stall 300 s, or crash)."""
    import faulthandler
    import traceback
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    out_dir = os.path.join(ROOT, "build", "phase21")
    os.makedirs(out_dir, exist_ok=True)
    logf = open(os.path.join(out_dir, f"rank{rank}.log"), "w", buffering=1)
    faulthandler.enable(file=logf)
    faulthandler.dump_traceback_later(300, repeat=True, file=logf)

    def log(line):
        logf.write(f"{time.strftime('%H:%M:%S')} {line}\n")

    try:
        from repro_torch.launch.mesh import init_ranks
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          LOCAL_RANK=str(rank))
        log("init")
        init_ranks("cuda")
        log("ranks up")
        q.put((rank, _mesh_rank_jobs(rank, world, log)))
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        faulthandler.cancel_dump_traceback_later()
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        logf.close()


def mesh_phase(dev, refs, card):
    """Phase 21: the model stack on a ("data", "model") mesh.

    21a smollm-135m at full width and depth through the mesh path on one
    rank (NCCL, mesh (1, 1), pure data parallel as the launcher places
    it): 3 steps of 20a's Trainer, losses bit for bit 20a's, peak memory
    beside 20a's.  21b NCCL over every card, one rank a card, spawned:
    smollm-135m (B=8 S=2048) and rwkv6-7b at 2 layers (B=4 S=2048) on
    the meshes of ``_mesh_shapes`` (n cards: data=n with the weights
    replicated and model=n with the rules' placements, the WKV kernel on
    each rank's 64/n heads; one card: (1, 1), rwkv6-7b alone, smollm-135m
    being 21a), 3 steps each, losses bit for bit 21a's / 20b's on one card
    and within ``MESH_LOSS_TIER`` of them on more, launches per rank a
    step equal to one rank's (0; 2 WKV); then
    scoring under the flash kernel (smollm-135m on each mesh: 30 launches
    a rank; Jamba without experts at two layers on the last: 1 scan and 1
    attention launch a rank), every recorded kernel call replayed against
    its plain version.  21c the
    planner: ``dryrun.plan_case`` for 21a's case on a (1, 1) mesh of a fake
    group (argument bytes exactly 21a's tensors'; peak and FLOPs beside
    the measured peak and ``model_flops_estimate``).  Returns (launches per path, attention routes per
    path, the replays' largest errors)."""
    import copy
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch import kernels
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_stream
    from repro_torch.distribution.constraints import set_dp_axes
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import _free_port, _mesh, init_ranks
    from repro_torch.launch.train import make_launch_mesh, place
    from repro_torch.models import layers, model as lm_model
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    paths, routes = {}, {}
    zero = dict.fromkeys(kernels.launches(), 0)
    layers.set_attention_impl("plain")

    def gb(n):
        return f"{n / 1e9:.3f} GB"

    # -- 21a. one rank through the mesh path --------------------------------
    t0 = time.perf_counter()
    ts = TRAIN_SMOLLM
    cfg = get_config(ts["arch"])
    tc, B, S = _mesh_train_config(ts["arch"])
    init_ranks("cuda")          # NCCL, world size 1
    try:
        mesh = make_launch_mesh("cuda", (1, 1))
        set_dp_axes(("pod", "data", "model"))     # pure DP, as launched
        lm = lm_model.init_lm(cfg, seed=0, device=dev)
        params, opt = place(lm, adamw_init(lm), mesh, pure_dp=True)
        del lm
        real = {"params": sum(p.to_local().numel() * p.element_size()
                              for p in params.parameters()),
                "opt": sum(t.to_local().numel() * t.element_size()
                           for part in ("mu", "nu") for t in
                           leaves(opt[part]))}
        data = synthetic_stream(cfg, DataConfig(seq_len=S, global_batch=B))
        first = next(data)
        real["batch"] = sum(v.nbytes for v in first.values())

        def batches():
            yield first
            yield from data

        tr = Trainer(cfg, tc, batches(), params=params, opt_state=opt,
                     mesh=mesh, pure_dp=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        tr.run(MESH_STEPS, verbose=False)
        torch.cuda.synchronize()
        got = kernels.launches()
        if got != zero:
            raise AssertionError(f"21a launched {got}")
        paths["mesh_smollm_1x1"] = got
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in tr.history]
        want = refs["20a"]["losses"][:MESH_STEPS]
        steps_ms = np.diff([0.0] + [h["wall_s"] for h in tr.history]) * 1e3
        print(f"21a {cfg.name} mesh (1, 1) over NCCL, pure DP, B={B} S={S} "
              f"bf16 over f32 masters, {MESH_STEPS} steps of 20a's Trainer: "
              f"losses {losses} against 20a's {want} "
              f"({'bit for bit' if losses == want else 'NOT bit for bit'});"
              f" steps {[round(float(s), 1) for s in steps_ms]} ms; peak "
              f"{gb(peak)} (20a {gb(refs['20a']['peak'])}); {card}")
        if losses != want:
            raise AssertionError("21a: the mesh of one rank is not 20a")
        del tr, params, opt
    finally:
        set_dp_axes(None)
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"21a: {time.perf_counter() - t0:.1f} s")

    # -- 21b. NCCL over every card, one rank a card ------------------------
    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, port, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        ranks = dict(q.get(timeout=900) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
    for r, res in sorted(ranks.items()):
        if "error" in res:
            raise AssertionError(f"21b rank {r}:\n{res['error']}")
    ref_loss = {"smollm-135m": refs["20a"]["losses"][:MESH_STEPS],
                "rwkv6-7b": refs["20b"]["losses"][:MESH_STEPS]}
    wkv_a_step = dict(zero, rwkv6=TRAIN_RWKV["layers"])
    for tag, arch, shape in _mesh_jobs(world):
        per = [ranks[r][tag] for r in range(world)]
        want = wkv_a_step if arch == "rwkv6-7b" else zero
        for r, res in enumerate(per):
            if any(got != want for got in res["launches"]):
                raise AssertionError(f"21b {tag} rank {r} launched "
                                     f"{res['launches']}; expected {want} "
                                     f"a step")
        if any(res["losses"] != per[0]["losses"] for res in per):
            raise AssertionError(f"21b {tag}: the ranks' losses differ")
        losses, ref = per[0]["losses"], ref_loss[arch]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        tier = ([0.0] * len(rel) if world == 1 else
                [MESH_LOSS_TIER[min(i, 1)] for i in range(len(rel))])
        if not (np.isfinite(losses).all()
                and all(r <= t for r, t in zip(rel, tier))):
            raise AssertionError(f"21b {tag}: losses {losses} against "
                                 f"one rank's {ref} (tier {tier})")
        paths[f"mesh_{tag}"] = {k: sum(res["launches"][i][k] for res in per
                                       for i in range(MESH_STEPS))
                                for k in zero}
        print(f"21b {tag} {arch} mesh (data, model) = {shape} over NCCL, "
              f"{MESH_STEPS} steps: losses {losses} against one rank's "
              f"{ref} ({'bit for bit' if losses == ref else 'rel '}"
              f"{'' if losses == ref else [f'{x:.2e}' for x in rel]}, tier "
              f"{tier}); launches a step a rank "
              f"{ {k: v for k, v in per[0]['launches'][0].items() if v} }; "
              f"ms a step per rank "
              f"{[[round(m, 1) for m in res['ms']] for res in per]}; peak "
              f"per rank {[gb(res['peak']) for res in per]}; {card}")
    n_attn = get_config("smollm-135m").n_layers    # one launch a layer
    for tag, arch, shape in _mesh_scoring(world):
        want = (dict(attention=1, mamba_scan=1) if arch == "jamba"
                else dict(attention=n_attn))
        per = [ranks[r][tag] for r in range(world)]
        for r, res in enumerate(per):
            if res["launches"] != dict(zero, **want):
                raise AssertionError(f"21b {tag} rank {r} launched "
                                     f"{res['launches']}; expected {want}")
        paths[f"mesh_{tag}"] = {k: sum(res["launches"][k] for res in per)
                                for k in zero}
        routes[f"mesh_{tag}"] = {k: sum(res["routes"][k] for res in per)
                                 for k in per[0]["routes"]}
        print(f"21b {tag} mesh {shape}, under the flash kernel, no "
              f"gradient: loss {per[0]['loss']!r}, launches a rank {want}, "
              f"routes {per[0]['routes']}, "
              f"{[round(res['ms'], 1) for res in per]} ms per rank; {card}")
    errs = {}
    for res in ranks.values():
        for k, v in res["errs"].items():
            errs[k] = max(errs.get(k, 0.0), v)
    print(f"21b: {sum(res['n_calls'] for res in ranks.values())} recorded "
          f"kernel calls on {world} rank(s) replayed against their plain "
          f"versions, largest |kernel - plain| {errs}; "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 21c. the planner ---------------------------------------------------
    t0 = time.perf_counter()
    shape = InputShape("phase21a", S, B, "train")
    pol = dr.case_policy(cfg, shape)
    pol.remat = False            # 21a's Trainer runs without remat
    dr.fake_group(1)
    try:
        mesh = _mesh("cpu", (1, 1), ("data", "model"))
        mode = roofline.PlanMode()
        with mode:
            parts = dr.plan_case(cfg, shape, mesh, pol, mode)
        rep = roofline.analyze_plan("phase21a", mode, chips=1,
                                    arg_bytes=sum(parts.values()),
                                    model_flops=roofline.model_flops_estimate(
                                        cfg, shape))
    finally:
        dist.destroy_process_group()
    if parts != real:
        raise AssertionError(f"21c: planned argument bytes {parts}, 21a's "
                             f"tensors {real}")
    print(f"21c plan_case({cfg.name}, B={B} S={S} train, mesh (1, 1), "
          f"policy {pol.param_dtype} weights, {pol.moment_dtype} moments, "
          f"remat off): argument bytes {parts} = 21a's tensors exactly; "
          f"predicted peak (arguments + temporaries) "
          f"{gb(rep.arg_bytes + rep.temp_bytes)} beside 21a's measured "
          f"{gb(peak)}; predicted FLOPs {rep.flops:.4e} beside "
          f"model_flops_estimate {rep.model_flops:.4e}; plan "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return paths, routes, errs, rep


# phase 22b: each example's arguments on the card (train_smollm cut to 30
# steps of its reduced model)
EXAMPLES = (("quickstart", []), ("noisy_protocol", []),
            ("distributed_probe", []), ("serve_decode", []),
            ("train_smollm", ["--steps", "30"]))


def examples_phase(dev):
    """Phase 22b: each ``examples_torch`` script's ``main`` once on the
    card at its reduced size, its peak memory on the card and the kernel
    launches it made printed.  Returns the launches per example."""
    import importlib.util
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa_module

    wrappers = (kernels.median_cut_scores, kernels.median_extremes,
                kernels.maxmarg_turn_scan, kernels.pegasos_stage,
                kernels.threshold_ranges, kernels.uncertain_mask,
                fa_module.attention, kernels.rwkv6, kernels.mamba_scan)
    counts = {}
    for name, argv in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{name}",
            os.path.join(ROOT, "examples_torch", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rows = mod.main(["--device", "cuda", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        counts[name] = {w.__name__: w.launches for w in wrappers
                        if w.launches}
        if not rows or peak == 0:
            raise AssertionError(f"22b {name}: no rows, or nothing "
                                 f"allocated on the card")
        print(f"22b examples_torch/{name}.py --device cuda {' '.join(argv)}"
              f": {len(rows)} rows in {wall:.1f} s, peak "
              f"{peak / 1e6:.1f} MB on the card, launches {counts[name]}")
    if not all(counts[n] for n in ("quickstart", "noisy_protocol",
                                   "distributed_probe", "serve_decode")):
        raise AssertionError(f"22b: an example launched no kernel: {counts}")
    return counts


def tuning_phase(dev, card):
    """Phase 22a: every entry of the committed tuning cache for this card
    (``repro_torch.analysis.autotune``), at its bucket's main-path shape:
    the kernel under the cached plan and under its own plan, bit for bit
    against each other (signs of zero included) and equal to the plain
    version, both timed as device time (``bounds.graph_ms``) beside the
    bound.  Returns the rows printed."""
    import torch
    from repro_torch.analysis import autotune, bounds

    name = torch.cuda.get_device_name(dev)
    rows = []
    for kernel, label, s in autotune.MAIN_PATH:
        shape = autotune.plan_shape(kernel, s)
        plan = autotune.lookup_plan(kernel, name, *shape)
        if plan is None:
            continue
        call, plain, work = autotune.inputs(kernel, s, dev)
        own = autotune.own_plan(kernel, s)
        got, want = call(plan), call(own)
        if not autotune.same_bits(got, want):
            raise AssertionError(f"22a {kernel} at {label}: the cached plan "
                                 f"{plan} and the own plan {own} disagree")
        ref = plain()
        if not all(bool(torch.equal(a, b)) for a, b in zip(want, ref)):
            raise AssertionError(f"22a {kernel} at {label}: the kernel "
                                 f"disagrees with its plain version")
        tuned_ms = bounds.graph_ms(lambda: call(plan), n=20)
        own_ms = bounds.graph_ms(lambda: call(own), n=20)
        bound, by = bounds.bound_ms(work)
        rows.append(dict(kernel=kernel, label=label, plan=plan, own=own,
                         ms=tuned_ms, own_ms=own_ms, bound_ms=bound))
        print(f"22a {kernel} at {label} {shape}: cached plan {plan} "
              f"{tuned_ms:.4f} ms, own plan {own} {own_ms:.4f} ms (device, "
              f"CUDA graph), bound {bound:.4g} ms ({by}); bit for bit, and "
              f"equal to the plain version; {card}")
    if not rows:
        raise AssertionError(f"22a: the tuning cache has no entry for {name}")
    return rows


def _clocks():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import engine, kernels
    from repro_torch.core import datasets, geometry
    from repro_torch.analysis import bounds
    from repro_torch.engine import hotloop, median
    from repro_torch.kernels import _build

    card = _card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(reports) or 'nothing (already built)'}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2. kernels against plain versions -----------------------------------
    cfg = SMOKE
    t0 = time.perf_counter()
    insts = smoke_instances(cfg["B"], cfg["n_per_node"], cfg["noisy_every"],
                            engine, datasets)
    data, s0, k, cap = engine.pack_instances(
        insts, n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"],
        device=dev)
    V = geometry.direction_grid(cfg["n_angles"], device=dev)
    print(f"setup: {cfg['B']} instances packed in "
          f"{time.perf_counter() - t0:.2f} s")

    # turn 1's inputs exactly as step gathers them: the first cut scan of
    # the sweep, at the full batch, with bounds built from shipped points
    s1 = median.step(data, V, s0, k=k, first_turn=True)
    ci = s1.turn % k
    g = median._gather_rows
    cut_args = (V, s1.dir_ok, g(s1.lo_w, ci), g(s1.hi_w, ci),
                g(data.X, ci), g(data.y, ci))
    W = hotloop.quantize_width(int(s1.w_fill.max()) + median.WIDTH_SLACK,
                               cap)
    v1 = V[kernels.median_cut_scores(*cut_args).argmax(dim=1)]
    ext_args = (v1, torch.cat([data.X, s1.wx[:, :, :W]], dim=2),
                torch.cat([data.y, s1.wy[:, :, :W]], dim=2))
    # stage 5's call: own rows and transcripts where they lie
    seg_args = (v1, data.X, data.y, s1.wx, s1.wy, W)

    errs = {"median_cut_scores": 0, "median_extremes": 0}

    def hold_cut(args, what):
        errs["median_cut_scores"] = max(errs["median_cut_scores"], _exact(
            kernels.median_cut_scores(*args),
            kernels.median_cut_scores_plain(*args), what))

    def hold_extremes(args, what):
        for got, want in zip(kernels.median_extremes(*args),
                             kernels.median_extremes_plain(*args)):
            errs["median_extremes"] = max(errs["median_extremes"],
                                          _exact(got, want, what))

    def hold_segments(args, what):
        """The two-segment call against its plain version, every output
        exactly (indices, class flags, rows, band edges)."""
        got = kernels.median_extremes_segments(*args)
        want = kernels.median_extremes_segments_plain(*args)
        for name, g, e in zip(want._fields, got, want):
            check = _same_floats if g.is_floating_point() else _exact
            errs["median_extremes"] = max(errs["median_extremes"],
                                          check(g, e, f"{what}: {name}"))

    hold_cut(cut_args, "cut scan, full batch")
    hold_extremes(ext_args, "extremes scan, full batch")
    hold_segments(seg_args, "extremes scan, two segments, full batch")
    hold_segments(tuple(a[:1] for a in seg_args[:5]) + (W,),
                  "extremes scan, two segments, B=1")
    for seed in range(3):
        hold_cut(crafted_cut_inputs(V, dev, seed), f"cut scan, ties {seed}")
        hold_extremes(crafted_extremes_inputs(dev, seed),
                      f"extremes scan, ties {seed}")
    # two segments: ties across the boundary, a class in one segment only,
    # an empty node, W = 0, odd n and W (unaligned starts), B = 1
    for seed, n_, w_, B_ in [(0, 41, 45, 5), (1, 41, 0, 5), (2, 40, 1, 5),
                             (3, 7, 47, 5), (4, 1000, 33, 5),
                             (5, 999, 48, 1)]:
        hold_segments(crafted_segment_inputs(dev, seed, n=n_, width=w_, B=B_),
                      f"extremes scan, two segments, crafted n={n_} W={w_} "
                      f"B={B_}")
    # the cut scan's edges: one-label and padding-only instances, ±0, ±inf
    # and self-projection bounds; n ragged against the register tile, m
    # against the 32-direction mask and at _MAX_ANGLES, B=1
    for B_, m_, n_ in [(6, 1024, 1), (6, 1024, 33), (6, 1024, 1001),
                       (6, 1, 64), (6, 31, 64), (6, 33, 64),
                       (4, kernels.median_cut._MAX_ANGLES, 1001),
                       (1, 1024, 1000)]:
        hold_cut(edge_cut_inputs(geometry, dev, B_, m_, n_, seed=B_ + n_),
                 f"cut scan, edges B={B_} m={m_} n={n_}")
    print("kernels: integer-exact against the plain versions at the full-"
          "batch turn, on crafted ties and at the cut scan's edges; the "
          "two-segment extremes scan exact in every output")

    m, B, n = cfg["n_angles"], cfg["B"], cut_args[4].shape[1]
    rows = [
        dict(name="median_cut_scores", route="cuda",
             source="src/repro_torch/kernels/csrc/median_cut.cu",
             replaces="src/repro/kernels/median_cut.py:76",
             fn=lambda: kernels.median_cut_scores(*cut_args),
             plain=lambda: kernels.median_cut_scores_plain(*cut_args),
             **bounds.cut_work(*cut_args)._asdict(),
             shape=f"B={B} m={m} n={n}"),
        dict(name="median_extremes", route="cuda",
             source="src/repro_torch/kernels/csrc/median_extremes.cu",
             replaces="src/repro/kernels/support_margin.py:381",
             fn=lambda: kernels.median_extremes_segments(*seg_args),
             plain=lambda: kernels.median_extremes_segments_plain(
                 *seg_args),
             **bounds.extremes_work(*seg_args)._asdict(),
             shape=f"B={B} k={k} n={data.X.shape[2]} W={W}, two segments"),
    ]
    for r in rows:
        _time_row(r)
    def one_seg():
        return kernels.median_extremes(*ext_args)

    team, per_sm = kernels.support_margin.extremes_occupancy(B * k)
    print(f"time median_extremes at {rows[1]['shape']}, device (CUDA "
          f"graph): {bounds.graph_ms(rows[1]['fn']):.4f} ms; one segment (the "
          f"concatenation, {ext_args[1].shape[2]} rows): "
          f"{bounds.median_ms(one_seg, 20):.4f} ms, device "
          f"{bounds.graph_ms(one_seg):.4f} ms; {team} warp(s) a row block, "
          f"{per_sm} blocks of 256 resident an SM")

    # -- 2b. MAXMARG's kernels against plain versions ------------------------
    from repro_torch.core import classifiers
    from repro_torch.engine import maxmarg
    from repro_torch.kernels import support_margin

    mm = MAXMARG
    t0 = time.perf_counter()
    buckets = maxmarg_buckets(datasets, engine)
    mm_insts = buckets[0][1]
    dm, sm0, km, capm = engine.pack_instances_maxmarg(
        mm_insts, max_epochs=mm["max_epochs"],
        max_support=mm["max_support"], device=dev)
    print(f"setup: {sum(len(b) for _, b in buckets)} MAXMARG instances "
          f"built, the first bucket packed, in "
          f"{time.perf_counter() - t0:.2f} s")
    scan_opts = dict(rtol=maxmarg.RTOL, max_support=mm["max_support"],
                     viol_ship=maxmarg.VIOL_SHIP)
    lam0 = classifiers.lam_schedule(mm["lam"], 1)[0]

    def stage_args(K, yK, w=None, b=None, lam=lam0):
        """One cold stage's inputs on a fit set, as the solver forms them
        (at its first λ unless ``lam`` is given)."""
        B, _, d = K.shape
        z_w = torch.zeros((B, d), device=dev)
        z_b = torch.zeros((B,), device=dev)
        K, yK = K.contiguous(), yK.contiguous()
        return (K, yK.float(), (yK != 0).sum(1).clamp_min(1).float(),
                z_w if w is None else w, z_b if b is None else b,
                torch.full((B,), lam, device=dev),
                torch.zeros((B,), dtype=torch.bool, device=dev), z_w, z_b)

    # turn 1's fit set exactly as step gathers it: node 1's shard and its
    # transcript after turn 0, at the hot loop's quantized width
    sm1 = maxmarg.step(dm, sm0, k=km, max_support=mm["max_support"],
                       steps=mm["steps"], stages=mm["stages"],
                       lam0=mm["lam"], fused_kernel=True, solver_kernel=True)
    Wm = hotloop.quantize_width(int(sm1.w_fill[:, 1].max()), capm)
    K1 = torch.cat([dm.X[:, 1], sm1.wx[:, 1, :Wm]], dim=1)
    yK1 = torch.cat([dm.y[:, 1], sm1.wy[:, 1, :Wm]], dim=1)
    peg1 = stage_args(K1, yK1)
    polish1 = stage_args(K1, yK1, sm1.h_w, sm1.h_b)
    w1, b1, _ = classifiers._svm_solve_batch(
        K1, yK1.float(), mm["lam"], mm["steps"], mm["stages"], kernel=True)
    turn1 = (w1, b1, K1, yK1, dm.X, dm.y)
    d16 = buckets[2][1]
    dh, _sh, _, _ = engine.pack_instances_maxmarg(
        d16, max_epochs=mm["max_epochs"], max_support=mm["max_support"],
        device=dev)
    peg16 = stage_args(dh.X[:, 0], dh.y[:, 0])

    def bucket_turn1(insts):
        """Turn 1's turn-scan inputs of a bucket, as step gathers them."""
        db, sb0, kb, capb = engine.pack_instances_maxmarg(
            insts, max_epochs=mm["max_epochs"],
            max_support=mm["max_support"], device=dev)
        sb1 = maxmarg.step(db, sb0, k=kb, max_support=mm["max_support"],
                           steps=mm["steps"], stages=mm["stages"],
                           lam0=mm["lam"], fused_kernel=True,
                           solver_kernel=True)
        Wb = hotloop.quantize_width(int(sb1.w_fill[:, 1].max()), capb)
        Kb = torch.cat([db.X[:, 1], sb1.wx[:, 1, :Wb]], dim=1)
        yKb = torch.cat([db.y[:, 1], sb1.wy[:, 1, :Wb]], dim=1)
        wb, bb, _ = classifiers._svm_solve_batch(
            Kb, yKb.float(), mm["lam"], mm["steps"], mm["stages"],
            kernel=True)
        return wb, bb, Kb, yKb, db.X, db.y

    errs["maxmarg_turn_scan"] = 0
    errs["pegasos_stage"] = 0.0

    def hold_turn(args, what, **kw):
        opts = dict(scan_opts, **kw)
        for got, want in zip(kernels.maxmarg_turn_scan(*args, **opts),
                             kernels.maxmarg_turn_scan_plain(*args, **opts)):
            errs["maxmarg_turn_scan"] = max(errs["maxmarg_turn_scan"],
                                            _exact(got, want, what))

    def hold_stage(args, what, **kw):
        """Bit for bit: the plain version sums in the kernel's order.
        Returns the kernel's outputs."""
        got = kernels.pegasos_stage(*args, **kw)
        want = kernels.pegasos_stage_plain(*args, **kw)
        for name, g, e in zip(("w", "b", "mmin", "found", "w_best",
                               "b_best"), got, want):
            if g.dtype == torch.bool:
                _exact(g, e, f"{what}: {name}")
                continue
            err = float((g.double() - e.double()).abs().max())
            errs["pegasos_stage"] = max(errs["pegasos_stage"], err)
            if not torch.equal(g, e):
                raise AssertionError(
                    f"{what}: {name} differs from the plain version on "
                    f"{int((g != e).sum())} of {g.numel()} entries (max "
                    f"|diff| {err})")
        return got

    hold_turn(turn1, "turn scan, full batch")
    for name, binsts in buckets[1:]:
        hold_turn(bucket_turn1(binsts), f"turn scan, {name} turn 1")
    # above the kernel's register list (8): further passes of its walk
    for ms, vs in ((12, 2), (4, 9)):
        hold_turn(turn1, f"turn scan, max_support {ms}, viol_ship {vs}",
                  max_support=ms, viol_ship=vs)
    hold_stage(peg1, "pegasos stage, full batch", nsteps=mm["steps"])
    hold_stage(polish1, "pegasos polish, full batch",
               nsteps=classifiers.WARM_STEPS, t0=classifiers.WARM_OFFSET)
    hold_stage(peg16, "pegasos stage, d=16", nsteps=mm["steps"])
    for seed in range(3):
        hold_turn(crafted_turn_inputs(dev, seed), f"turn scan, ties {seed}")
        for skip in (False, True):
            hold_stage(crafted_pegasos_inputs(dev, seed),
                       f"pegasos stage, crafted {seed}", nsteps=300,
                       skip_latched=skip)
        hold_stage(crafted_pegasos_inputs(dev, seed, d=40),
                   f"pegasos stage, crafted {seed}, d=40", nsteps=300)
    print("kernels: MAXMARG turn scan and Pegasos stage bit for bit against "
          "the plain versions at the full-batch turn (the turn scan also at "
          "turn 1 of the k4_d2 and k2_d16 buckets and with max_support 12 "
          "and viol_ship 9, above its register list), the polish, d=16, "
          "d=40 and on crafted ties")

    Bm, N1, dd = K1.shape
    mm_rows = [
        dict(name="maxmarg_turn_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/maxmarg_turn.cu",
             replaces="src/repro/kernels/support_margin.py:299",
             fn=lambda: kernels.maxmarg_turn_scan(*turn1, **scan_opts),
             plain=lambda: kernels.maxmarg_turn_scan_plain(*turn1,
                                                           **scan_opts),
             **bounds.turn_work(*turn1, max_support=mm["max_support"],
                                viol_ship=maxmarg.VIOL_SHIP)._asdict(),
             shape=f"B={Bm} N={N1} k={km} n={dm.X.shape[2]} d={dd}",
             reps=(20, 3), graph=True),
        dict(name="pegasos_stage", route="cuda",
             source="src/repro_torch/kernels/csrc/pegasos_stage.cu",
             replaces="src/repro/kernels/pegasos.py:127",
             fn=lambda: kernels.pegasos_stage(*peg1, nsteps=mm["steps"]),
             plain=lambda: kernels.pegasos_stage_plain(*peg1,
                                                       nsteps=mm["steps"]),
             **bounds.pegasos_work(*peg1, nsteps=mm["steps"])._asdict(),
             shape=f"B={Bm} N={N1} d={dd} nsteps={mm['steps']}",
             reps=(5, 2)),
    ]
    for r in mm_rows:
        _time_row(r)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    segs = Bm * (km + 1)
    team, cap_list, per_sm = support_margin.turn_occupancy(
        Bm, N1, km, dm.X.shape[2], dd, mm["max_support"], maxmarg.VIOL_SHIP)
    print(f"maxmarg_turn_scan residency: {per_sm} blocks of 256 an SM on "
          f"{sms} SMs, {8 * per_sm * sms} warps resident; turn 1's {segs} "
          f"segments take {team} warp(s) each, {segs * team} warps "
          f"({segs * team / (8 * per_sm * sms):.3f} waves), a register "
          f"list of {cap_list}")
    print(f"time pegasos_stage at d=16 (B={peg16[0].shape[0]} "
          f"N={peg16[0].shape[1]}): kernel "
          f"{bounds.median_ms(lambda: kernels.pegasos_stage(*peg16, nsteps=mm['steps']), 5):.4f} ms")

    # -- 3. the MEDIAN sweep on the card --------------------------------------
    hotloop.KEY_LOG.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = engine.run_sweep(insts, n_angles=cfg["n_angles"],
                           max_epochs=cfg["max_epochs"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    for name in ("median_cut_scores", "median_extremes"):
        if counts[name] <= 0:
            raise AssertionError(f"the MEDIAN sweep never launched {name}")
    turns = len(hotloop.KEY_LOG)
    noisy = {i for i in range(cfg["B"]) if i % cfg["noisy_every"] == 0}
    conv = [r.converged for r in res]
    print(f"median sweep: {cfg['B']} instances in {wall:.3f} s, {turns} turns, "
          f"{sum(conv)} converged, KEY_LOG size {turns}, launches {counts}, "
          f"tail widths {sorted({w for _, w, *_ in hotloop.KEY_LOG})[-3:]}")
    for i, (inst, r) in enumerate(zip(insts, res)):
        w, b = r.classifier.w, r.classifier.b
        if not (w.shape == (2,) and np.isfinite(w).all() and np.isfinite(b)):
            raise AssertionError(f"instance {i}: separator {w}, {b}")
        if i in noisy:
            if r.converged:
                raise AssertionError(f"noisy instance {i} converged")
            continue
        if not r.converged:
            raise AssertionError(f"separable instance {i} did not converge")
        X = np.concatenate([s[0] for s in inst.shards])
        y = np.concatenate([s[1] for s in inst.shards])
        err = float(np.mean(r.classifier.predict(X) != y))
        if err > inst.eps + 2.0 / len(y):
            raise AssertionError(f"instance {i}: error {err} > ε={inst.eps}")
    # the cut scan's share of the sweep: the same sweep once more, with CUDA
    # events recorded around every call of the cut scan's wrapper
    from repro_torch.engine import dataplane
    cut_calls = []

    def timed_cut(*args):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = cut_original(*args)
        ev[1].record()
        # (events, B, n, live points as a device scalar: no host sync)
        cut_calls.append((ev, args[1].shape[0], args[4].shape[1],
                          (args[5] != 0).sum()))
        return out

    # and around every stage 5 (median.node_extremes: the extremes scan
    # with everything the step does around it)
    stage5_calls = []

    def timed_stage5(data_, *args):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = stage5_original(data_, *args)
        ev[1].record()
        stage5_calls.append((ev, data_.X.shape[0]))
        return out

    cut_original = dataplane.median_cut
    stage5_original = median.node_extremes
    dataplane.median_cut = timed_cut
    median.node_extremes = timed_stage5
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_sweep(insts, n_angles=cfg["n_angles"],
                         max_epochs=cfg["max_epochs"], device=dev)
        torch.cuda.synchronize()
        cut_wall = time.perf_counter() - t0
    finally:
        dataplane.median_cut = cut_original
        median.node_extremes = stage5_original
    m = cfg["n_angles"]
    call_ms = [a.elapsed_time(b) for (a, b), *_ in cut_calls]

    def cut_call_bound(Bc, n_, live):
        """The bound of one recorded call, as _time_row counts it (shapes
        on the meta device, the live points as recorded)."""
        meta = dict(device="meta")
        return bounds.bound_ms(bounds.cut_work(
            torch.empty((m, 2), **meta),
            torch.empty((Bc, m), dtype=torch.bool, **meta),
            *(torch.empty((Bc, m), **meta),) * 2,
            torch.empty((Bc, n_, 2), **meta),
            torch.empty((Bc, n_), dtype=torch.int32, **meta),
            live=int(live)))[0]

    call_bound = [cut_call_bound(Bc, n_, live)
                  for _, Bc, n_, live in cut_calls]
    widths = sorted({Bc for _, Bc, _, _ in cut_calls}, reverse=True)
    print(f"median sweep again with events: {cut_wall:.3f} s wall, "
          f"median_cut_scores {len(cut_calls)} calls {sum(call_ms):.4f} ms "
          f"({sum(call_ms) / 1e3 / cut_wall:.1%} of the wall), bound "
          f"{sum(call_bound):.4f} ms, launches x gap "
          f"{sum(call_ms) - sum(call_bound):.4f} ms; per batch width: "
          + ", ".join(
              f"B={w} {sum(1 for _, Bc, _, _ in cut_calls if Bc == w)} calls "
              f"{sum(t for t, (_, Bc, _, _) in zip(call_ms, cut_calls) if Bc == w):.4f} ms"
              for w in widths))
    del cut_calls
    stage5_ms = [a.elapsed_time(b) for (a, b), _ in stage5_calls]
    print(f"median sweep again with events: stage 5 (node_extremes) "
          f"{len(stage5_ms)} calls {sum(stage5_ms):.4f} ms "
          f"({sum(stage5_ms) / 1e3 / cut_wall:.1%} of the wall); turn 0 "
          f"{stage5_ms[0]:.4f} ms, turn 1 {stage5_ms[1]:.4f} ms (B="
          f"{stage5_calls[1][1]}); per batch width: " + ", ".join(
              f"B={w} {sum(1 for _, Bc in stage5_calls if Bc == w)} calls "
              f"{sum(t for t, (_, Bc) in zip(stage5_ms, stage5_calls) if Bc == w):.4f}"
              f" ms" for w in sorted({Bc for _, Bc in stage5_calls},
                                     reverse=True)))
    del stage5_calls

    # the widest tail turn: the noisy tail at its final width
    tail = [insts[i] for i in sorted(noisy)]
    d_t, st, _, _ = engine.pack_instances(
        tail, n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"],
        device=dev)
    ft = median.run_hot(d_t, V, st, k=k, max_turns=k * cfg["max_epochs"],
                        cut_kernel=True, extremes_kernel=True)
    Wmax = hotloop.quantize_width(int(ft.w_fill.max()) + median.WIDTH_SLACK,
                                  cap)
    wide = (ft.h_v, torch.cat([d_t.X, ft.wx[:, :, :Wmax]], dim=2),
            torch.cat([d_t.y, ft.wy[:, :, :Wmax]], dim=2))
    wide_seg = (ft.h_v, d_t.X, d_t.y, ft.wx, ft.wy, Wmax)
    hold_extremes(wide, "extremes scan, widest turn")
    hold_segments(wide_seg, "extremes scan, two segments, widest turn")
    team, _ = kernels.support_margin.extremes_occupancy(len(tail) * k)
    print(f"time median_extremes at the widest turn (B={len(tail)} "
          f"n={d_t.X.shape[2]} W={Wmax}, {team} warps a row block)"
          + "".join(
              f"; {what}: kernel {bounds.median_ms(lambda: fn(*a), 20):.4f} ms, "
              f"device {bounds.graph_ms(lambda: fn(*a)):.4f} ms, plain "
              f"{bounds.median_ms(lambda: plain(*a), 5):.4f} ms"
              for what, fn, plain, a in [
                  ("two segments", kernels.median_extremes_segments,
                   kernels.median_extremes_segments_plain, wide_seg),
                  (f"one segment (nW={wide[1].shape[2]})",
                   kernels.median_extremes, kernels.median_extremes_plain,
                   wide)]))
    # the cut scan there, its inputs as step gathers them from that state
    ct = ft.turn % k
    tail_cut = (V, ft.dir_ok, g(ft.lo_w, ct), g(ft.hi_w, ct), g(d_t.X, ct),
                g(d_t.y, ct))
    hold_cut(tail_cut, "cut scan, widest tail turn")
    print(f"time median_cut_scores at the widest tail turn (B={len(tail)} "
          f"m={m} n={tail_cut[4].shape[1]}): kernel "
          f"{bounds.median_ms(lambda: kernels.median_cut_scores(*tail_cut), 20):.4f} ms, "
          f"plain {bounds.median_ms(lambda: kernels.median_cut_scores_plain(*tail_cut), 3):.4f} ms")

    # -- 4. card against CPU -------------------------------------------------
    sub = insts[:SUBSET]
    opts = dict(n_angles=cfg["n_angles"], max_epochs=cfg["max_epochs"])
    on_card = engine.run_sweep(sub, device=dev, **opts)
    t0 = time.perf_counter()
    on_cpu = engine.run_sweep(sub, device="cpu", **opts)
    cpu_s = time.perf_counter() - t0
    bitwise = 0
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        if (a.comm, a.rounds, a.converged) != (b.comm, b.rounds, b.converged):
            raise AssertionError(f"instance {i}: card {a.comm} {a.rounds} "
                                 f"{a.converged}, cpu {b.comm} {b.rounds} "
                                 f"{b.converged}")
        np.testing.assert_allclose(a.classifier.w, b.classifier.w, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(a.classifier.b, b.classifier.b, rtol=0,
                                   atol=1e-6)
        bitwise += bool(np.array_equal(a.classifier.w, b.classifier.w)
                        and a.classifier.b == b.classifier.b)
    print(f"card vs cpu: {SUBSET} instances ({sum(i in noisy for i in range(SUBSET))} "
          f"noisy), integer outputs exact, {bitwise}/{SUBSET} separators "
          f"bitwise equal (cpu run {cpu_s:.2f} s)")

    # -- 5. the MAXMARG sweep on the card --------------------------------------
    all_mm = [inst for _, b in buckets for inst in b]
    hotloop.KEY_LOG.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    mres = engine.run_sweep(all_mm, device=dev, **MAXMARG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mm_counts = kernels.launches()
    for name in ("maxmarg_turn_scan", "pegasos_stage"):
        if mm_counts[name] <= 0:
            raise AssertionError(f"the MAXMARG sweep never launched {name}")
    keys = list(hotloop.KEY_LOG)
    print(f"maxmarg sweep: {len(all_mm)} instances "
          f"({', '.join(f'{n} B={len(b)}' for n, b in buckets)}) in "
          f"{wall:.3f} s, {len(keys)} turns, "
          f"{sum(r.converged for r in mres)} converged, KEY_LOG warm hits "
          f"{sum(1 for key in keys if key[2])}, warm latches "
          f"{sum(r.extra['warm_latches'] for r in mres)}, launches "
          f"{mm_counts}")
    i0 = 0
    for name, binsts in buckets:
        for i, (inst, r) in enumerate(zip(binsts, mres[i0:i0 + len(binsts)])):
            d = inst.shards[0][0].shape[1]
            w, b = r.classifier.w, r.classifier.b
            if not (w.shape == (d,) and np.isfinite(w).all()
                    and np.isfinite(b)):
                raise AssertionError(f"{name} {i}: separator {w}, {b}")
            noisy = name == "k2_d2" and i % 24 == 0
            if noisy:
                if r.converged:
                    raise AssertionError(f"noisy instance {i} converged")
                continue
            if not r.converged:
                raise AssertionError(f"{name} {i} did not converge")
            X = np.concatenate([s[0] for s in inst.shards])
            y = np.concatenate([s[1] for s in inst.shards])
            err = float(np.mean(r.classifier.predict(X) != y))
            if err > inst.eps + 2.0 / len(y):
                raise AssertionError(f"{name} {i}: error {err} > "
                                     f"ε={inst.eps}")
        i0 += len(binsts)
    # the port kernels' share of the sweep: the same sweep once more, with
    # CUDA events recorded around every call of the two MAXMARG wrappers
    from repro_torch.engine import dataplane
    from repro_torch.kernels import pegasos as pegasos_module
    spans = {"maxmarg_turn_scan": [], "pegasos_stage": []}

    def timed(name, fn):
        def call(*args, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            spans[name].append(ev)
            return out
        # a wrapper counts its launches through its module-level name,
        # which is this shim during the pass (the counts were read above)
        call.launches = 0
        return call

    originals = (dataplane.maxmarg_turn_scan, pegasos_module.pegasos_stage)
    dataplane.maxmarg_turn_scan = timed("maxmarg_turn_scan", originals[0])
    pegasos_module.pegasos_stage = timed("pegasos_stage", originals[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_sweep(all_mm, device=dev, **MAXMARG)
        torch.cuda.synchronize()
        timed_wall = time.perf_counter() - t0
    finally:
        dataplane.maxmarg_turn_scan, pegasos_module.pegasos_stage = originals
    kern_s = {n: sum(a.elapsed_time(b) for a, b in v) / 1e3
              for n, v in spans.items()}
    print(f"maxmarg sweep again with events: {timed_wall:.3f} s wall, "
          + ", ".join(f"{n} {len(spans[n])} calls {v:.4f} s "
                      f"({v / timed_wall:.2%})" for n, v in kern_s.items())
          + f": the two kernels are {sum(kern_s.values()) / timed_wall:.1%} "
          f"of the wall")

    # the widest tail turn: the noisy instances' fit set at their last fill
    tail = [mm_insts[i] for i in range(0, len(mm_insts), 24)]
    d_t, st, _, _ = engine.pack_instances_maxmarg(
        tail, max_epochs=mm["max_epochs"], max_support=mm["max_support"],
        device=dev)
    ft = maxmarg.run_hot(d_t, st, k=km, max_turns=km * mm["max_epochs"],
                         max_support=mm["max_support"], steps=mm["steps"],
                         stages=mm["stages"], lam0=mm["lam"],
                         fused_kernel=True, solver_kernel=True)
    Wt = hotloop.quantize_width(int(ft.w_fill[:, 0].max()), capm)
    Kt = torch.cat([d_t.X[:, 0], ft.wx[:, 0, :Wt]], dim=1)
    yKt = torch.cat([d_t.y[:, 0], ft.wy[:, 0, :Wt]], dim=1)
    wide_turn = (ft.h_w, ft.h_b, Kt, yKt, d_t.X, d_t.y)
    wide_stage = stage_args(Kt, yKt)
    hold_turn(wide_turn, "turn scan, widest tail turn")
    hold_stage(wide_stage, "pegasos stage, widest tail turn",
               nsteps=mm["steps"])
    team_t = support_margin.turn_occupancy(
        len(tail), Kt.shape[1], km, d_t.X.shape[2], dd, mm["max_support"],
        maxmarg.VIOL_SHIP)[0]
    print(f"time at the widest tail turn (B={len(tail)} N={Kt.shape[1]}, "
          f"{team_t} warp(s) a segment): "
          f"maxmarg_turn_scan "
          f"{bounds.median_ms(lambda: kernels.maxmarg_turn_scan(*wide_turn, **scan_opts), 20):.4f} ms "
          f"(device "
          f"{bounds.graph_ms(lambda: kernels.maxmarg_turn_scan(*wide_turn, **scan_opts)):.4f} ms), "
          f"pegasos_stage "
          f"{bounds.median_ms(lambda: kernels.pegasos_stage(*wide_stage, nsteps=mm['steps']), 5):.4f} ms")

    # -- 6. MAXMARG card against CPU, the same solver path on both -----------
    sub = buckets[0][1][:MM_SUBSET[0]] + buckets[1][1][:MM_SUBSET[1]]
    opts = dict(MAXMARG, fused_kernel=True, solver_kernel=True)
    on_card = engine.run_sweep(sub, device=dev, **opts)
    t0 = time.perf_counter()
    on_cpu = engine.run_sweep(sub, device="cpu", **opts)
    cpu_s = time.perf_counter() - t0
    bitwise, worst, apart = 0, 1.0, []
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        if (a.comm, a.rounds, a.converged) != (b.comm, b.rounds, b.converged):
            raise AssertionError(f"maxmarg instance {i}: card {a.comm} "
                                 f"{a.rounds} {a.converged}, cpu {b.comm} "
                                 f"{b.rounds} {b.converged}")
        va = np.concatenate([a.classifier.w, [a.classifier.b]])
        vb = np.concatenate([b.classifier.w, [b.classifier.b]])
        cos = float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))
        worst = min(worst, cos)
        if not cos > 1.0 - COS_TOL:
            raise AssertionError(f"maxmarg instance {i}: separator cosine "
                                 f"{cos} (card {va}, cpu {vb})")
        if np.array_equal(va, vb):
            bitwise += 1
        else:
            apart.append(f"{i} (max |diff| {np.abs(va - vb).max():.3g}, "
                         f"{'' if a.converged else 'not '}converged)")
    print(f"maxmarg card vs cpu: {len(sub)} instances ({MM_SUBSET[0]} k=2 "
          f"with {len(range(0, MM_SUBSET[0], 24))} noisy, {MM_SUBSET[1]} "
          f"k=4), comm/rounds/convergence exact, min cosine {worst!r}, "
          f"{bitwise}/{len(sub)} separators bitwise equal"
          + (f", apart: {'; '.join(apart)}" if apart else "")
          + f" (cpu run {cpu_s:.2f} s)")

    # -- 7. the bulk scans: kernels against plain versions, then SOU ---------
    from repro_torch.core.sampling import epsilon_net_size
    from repro_torch.engine import oneway

    errs["threshold_ranges"] = 0.0
    errs["uncertain_mask"] = 0

    def hold_ranges(args, what):
        for g, e in zip(kernels.threshold_ranges(*args),
                        kernels.threshold_ranges_plain(*args)):
            errs["threshold_ranges"] = max(errs["threshold_ranges"],
                                           _same_floats(g, e, what))

    def hold_uncertain(args, what):
        errs["uncertain_mask"] = max(errs["uncertain_mask"], _exact(
            kernels.uncertain_mask(*args),
            kernels.uncertain_mask_plain(*args), what))

    for dd in (2, 3):
        for seed in range(2):
            Vc, okc, loc, hic, Xc, yc, Xwc, ywc = crafted_scan_inputs(
                dev, seed, dd)
            what = f"d={dd}, crafted {seed}"
            hold_ranges((Vc, Xwc, ywc), f"ranges of the transcript, {what}")
            hold_ranges((Vc, Xc, yc), f"ranges of the shard, {what}")
            hold_uncertain((Vc, okc, loc, hic, Xc, yc), f"uncertain, {what}")
            lo_b, hi_b = kernels.threshold_ranges_plain(Vc, Xwc, ywc)
            mask_b = kernels.uncertain_mask_plain(Vc, okc, loc, hic, Xc, yc)
            for b in range(Xc.shape[0]):
                lo1, hi1 = kernels.threshold_ranges_one(Vc, Xwc[b], ywc[b])
                _same_floats(lo1, lo_b[b], f"ranges B=1, {what}, {b}")
                _same_floats(hi1, hi_b[b], f"ranges B=1, {what}, {b}")
                _exact(kernels.uncertain_mask_one(Vc, okc[b], loc[b], hic[b],
                                                  Xc[b], yc[b]),
                       mask_b[b], f"uncertain B=1, {what}, {b}")
    # more directions than the SOU kernel's shared memory holds at once
    # (256 at d=64): three chunks, points that hit in one skipped in the next
    hold_uncertain(crafted_scan_inputs(dev, 0, 64, 600)[:6],
                   "uncertain, d=64, m=600")
    # the ranges kernel on its own edges, at every split it has: equal to
    # the plain version, and bit for bit (signs of zero included) to the
    # replica of its merge order; m a multiple of 4 or not, rows over
    # several chunks (1024 rows at d = 2 and 3, 64 at d = 64)
    splits = 0
    for dd, nn, mm in ((2, 392, 203), (2, 1100, 200), (3, 1100, 203),
                       (3, 392, 200), (64, 392, 203)):
        ra = crafted_ranges_inputs(dev, 0, dd, mm, nn)
        what = f"d={dd}, n={nn}, m={mm}"
        hold_ranges(ra, f"ranges, crafted, {what}")
        lo_b, hi_b = kernels.threshold_ranges_plain(*ra)
        for b in range(ra[1].shape[0]):
            lo1, hi1 = kernels.threshold_ranges_one(ra[0], ra[1][b],
                                                    ra[2][b])
            _same_floats(lo1, lo_b[b], f"ranges B=1, crafted, {what}, {b}")
            _same_floats(hi1, hi_b[b], f"ranges B=1, crafted, {what}, {b}")
        for split in ranges_splits(dd, mm, nn):
            got = support_margin._ranges_launch(*ra, split)
            want = ranges_replica(*(a.cpu().numpy() for a in ra),
                                  8 // split.warps, split.chunk)
            for g, p, r, side in zip(got, (lo_b, hi_b), want, ("lo", "hi")):
                errs["threshold_ranges"] = max(
                    errs["threshold_ranges"],
                    _same_floats(g, p, f"ranges {side}, crafted, {what}, "
                                       f"split {split}"))
                bits = g.cpu().numpy().view(np.int32)
                if not np.array_equal(bits, r.view(np.int32)):
                    raise AssertionError(
                        f"ranges {side}, crafted, {what}, split {split}: "
                        f"{int((bits != r.view(np.int32)).sum())} entries "
                        f"differ in their bits from the replica")
            splits += 1
    print("kernels: ranges and uncertainty scans exactly equal to the plain "
          "versions on crafted edges (d=2, d=3; uncertainty also at d=64 "
          "over m=600 directions), batched and at B=1; the ranges kernel "
          f"also at d=64, m=203 and n=1100, and at {splits} (input, split) "
          "pairs bit for bit equal to its replica, ±0 included")

    t0 = time.perf_counter()
    final = median.run_hot(data, V, s0, k=k, max_turns=k * cfg["max_epochs"],
                           cut_kernel=True, extremes_kernel=True)
    torch.cuda.synchronize()
    print(f"median final state for the SOU scans: {cfg['B']} instances in "
          f"{time.perf_counter() - t0:.3f} s, "
          f"{int(final.converged.sum())} converged")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sou = []
    for j in range(k):
        lo_j, hi_j = dataplane.ranges(V, final.wx[:, j], final.wy[:, j])
        for got, kept, side in ((lo_j, final.lo_w[:, j], "lo"),
                                (hi_j, final.hi_w[:, j], "hi")):
            if not torch.equal(got, kept):
                raise AssertionError(
                    f"node {j}: the rescan's {side} differs from the "
                    f"incremental one on {int((got != kept).sum())} entries")
        sou.append(dataplane.uncertain(V, final.dir_ok, lo_j, hi_j,
                                       data.X[:, j], data.y[:, j]))
    torch.cuda.synchronize()
    sou_s = time.perf_counter() - t0
    sou_counts = kernels.launches()
    for name in ("threshold_ranges", "uncertain_mask"):
        if sou_counts[name] <= 0:
            raise AssertionError(f"the SOU scans never launched {name}")
    conv = final.converged
    print(f"sou scans: {k} nodes × {cfg['B']} instances in {sou_s:.4f} s, "
          f"every rescan equal to the incremental ranges, launches "
          f"{sou_counts}")
    scan_args = []
    for j, mask in enumerate(sou):
        live = data.y[:, j] != 0
        size = mask.sum(dim=1).double()
        print(f"sou node {j}: {int(size.sum())} of {int(live.sum())} live "
              f"points uncertain; per instance mean {float(size.mean()):.3f},"
              f" converged {float(size[conv].mean()):.3f}, not converged "
              f"{float(size[~conv].mean()) if (~conv).any() else 0.0:.3f}, "
              f"max {int(size.max())}")
        ra = (V, final.wx[:, j].contiguous(), final.wy[:, j].contiguous())
        lo_p, hi_p = kernels.threshold_ranges_plain(*ra)
        ua = (V, final.dir_ok, lo_p, hi_p, data.X[:, j].contiguous(),
              data.y[:, j].contiguous())
        hold_ranges(ra, f"ranges, final state, node {j}")
        hold_uncertain(ua, f"uncertain, final state, node {j}")
        if not torch.equal(mask, kernels.uncertain_mask_plain(*ua) & live):
            raise AssertionError(f"node {j}: SOU mask differs from the "
                                 f"plain version's")
        scan_args.append((ra, ua))
    # B=1 forms (instance 0 is noisy: no direction is left) and a batch
    # smaller than one wave, whose points the kernel splits over blocks
    ua = scan_args[0][1]
    for b in range(4):
        errs["uncertain_mask"] = max(errs["uncertain_mask"], _exact(
            kernels.uncertain_mask_one(V, *(a[b] for a in ua[1:])),
            kernels.uncertain_mask_plain(V, *(a[b:b + 1] for a in ua[1:]))[0],
            f"uncertain B=1, final state, instance {b}"))
    hold_uncertain((V,) + tuple(a[:24] for a in ua[1:]),
                   "uncertain, final state, 24 instances")
    ra = scan_args[0][0]
    lo_b, hi_b = kernels.threshold_ranges_plain(V, ra[1][:4], ra[2][:4])
    for b in range(4):
        lo1, hi1 = kernels.threshold_ranges_one(V, ra[1][b], ra[2][b])
        _same_floats(lo1, lo_b[b], f"ranges B=1, final state, instance {b}")
        _same_floats(hi1, hi_b[b], f"ranges B=1, final state, instance {b}")
    hold_ranges((V, ra[1][:24], ra[2][:24]),
                "ranges, final state, 24 instances")
    print("kernels: ranges and uncertainty scans exactly equal to the plain "
          "versions on the full-batch final state, at B=24 and at B=1 "
          "(instances 0-3)")

    ra, ua = scan_args[0]
    m, d2, B = V.shape[0], V.shape[1], cfg["B"]
    n_sou = ua[4].shape[1]
    ua_tests, _, ua_rounds = _uncertain_work(*ua)
    scan_rows = [
        dict(name="threshold_ranges", route="cuda",
             source="src/repro_torch/kernels/csrc/threshold_ranges.cu",
             replaces="src/repro/kernels/support_margin.py:131",
             fn=lambda: kernels.threshold_ranges(*ra),
             plain=lambda: kernels.threshold_ranges_plain(*ra),
             **bounds.ranges_work(*ra)._asdict(),
             shape=f"B={B} m={m} cap={ra[1].shape[1]} d={d2}", graph=True),
        dict(name="uncertain_mask", route="cuda",
             source="src/repro_torch/kernels/csrc/uncertain_mask.cu",
             replaces="src/repro/kernels/support_margin.py:449",
             fn=lambda: kernels.uncertain_mask(*ua),
             plain=lambda: kernels.uncertain_mask_plain(*ua),
             **bounds.uncertain_work(*ua, tests=ua_tests)._asdict(),
             shape=f"B={B} m={m} n={ua[4].shape[1]} d={d2}", graph=True),
    ]
    for r in scan_rows:
        _time_row(r)
    # the single-instance TPU kernels are B=1 calls of the same wrappers;
    # instance 0 is noisy: the widest transcript and no point ever hits
    ra1 = (V, ra[1][0], ra[2][0])
    ua1 = tuple(a[0] for a in ua[1:])
    for r in (
            dict(name="threshold_ranges_one",
                 fn=lambda: kernels.threshold_ranges_one(*ra1),
                 plain=lambda: kernels.threshold_ranges_plain(
                     V, ra1[1][None], ra1[2][None]),
                 **bounds.ranges_work(V, ra1[1][None],
                                      ra1[2][None])._asdict(),
                 shape=f"m={m} cap={ra1[1].shape[0]} d={d2}", graph=True),
            dict(name="uncertain_mask_one",
                 fn=lambda: kernels.uncertain_mask_one(V, *ua1),
                 plain=lambda: kernels.uncertain_mask_plain(
                     V, *(a[None] for a in ua1)),
                 **bounds.uncertain_work(
                     V, *(a[None] for a in ua1))._asdict(),
                 shape=f"m={m} n={ua1[3].shape[0]} d={d2}", graph=True)):
        _time_row(r)
    cap_w = ra[1].shape[1]
    for bb in (B, 24, 1):
        split = support_margin.ranges_occupancy(bb, m, cap_w, d2)
        tile = 32 * split.warps * split.per_thread
        print(f"threshold_ranges split at B={bb}: {split}: a block of "
              f"{8 // split.warps} row group(s) of {split.warps} warp(s), "
              f"{split.per_thread} direction(s) a thread, tiles of {tile}; "
              f"{bb * split.tiles} blocks on {sms} SMs "
              f"({bb * split.tiles / (split.per_sm * sms):.3f} waves)")
    parts, chunk, per_sm = support_margin.uncertain_occupancy(B, m, n_sou,
                                                              d2)
    print(f"uncertain_mask residency: {per_sm} blocks of 256 an SM on {sms} "
          f"SMs, a chunk of {chunk} directions; at B={B} {parts} block(s) "
          f"an instance ({B * parts / (per_sm * sms):.3f} waves), at B=24 "
          f"{support_margin.uncertain_occupancy(24, m, n_sou, d2)[0]}, at "
          f"B=1 {support_margin.uncertain_occupancy(1, m, n_sou, d2)[0]}")
    # a round: four directions a lane from registers, one vote
    per_round, ops = _vote_round(_build.sass("uncertain_mask"),
                                 "uncertain_maskILi2E")
    rounds = ua_rounds
    print(f"uncertain_mask SASS (d=2): a round of 128 directions holds "
          f"{per_round} instructions: {dict(ops.most_common())}; at the SOU "
          f"shape {rounds} rounds over the points ({ua_tests} tests), "
          f"{rounds * per_round:.4g} warp instructions, "
          f"{rounds * per_round / (4 * sms * 1.98e9) * 1e3:.4g} ms at one a "
          f"clock on each of {4 * sms} schedulers at 1.98 GHz (the "
          f"instructions each point costs outside the loop not counted)")

    # -- 8. the one-way sweep on the card ------------------------------------
    t0 = time.perf_counter()
    ow = oneway_buckets(datasets, engine)
    all_ow = [inst for _, b in ow for inst in b]
    print(f"setup: {len(all_ow)} one-way instances built in "
          f"{time.perf_counter() - t0:.2f} s")
    # the Pegasos stage at every one-way bucket's fit set, as oneway forms
    # it, bit for bit against its plain version: stage 0 from zeros, then
    # stage 1 from stage 0's iterate with its latched instances skipped
    ow_lams = classifiers.lam_schedule(ONEWAY["lam"], 2)
    per_sel = len(ow[0][1]) // 4
    fit_buckets = [(sel, ow[0][1][i * per_sel:(i + 1) * per_sel])
                   for i, sel in enumerate(("sampling", "naive", "voting",
                                            "mixing"))]
    fit_buckets.append(("sampling k=4", ow[1][1]))
    latched = []
    for what, bucket in fit_buckets:
        Kx, Ky = oneway.fit_set(bucket, device=dev)
        s0 = stage_args(Kx, Ky, lam=ow_lams[0])
        w, b, _mm, found, wb, bb = hold_stage(
            s0, f"pegasos stage 0, {what} fit set", nsteps=ONEWAY["steps"],
            skip_latched=True)
        s1 = s0[:3] + (w, b, torch.full_like(b, ow_lams[1]), found, wb, bb)
        hold_stage(s1, f"pegasos stage 1, {what} fit set",
                   nsteps=ONEWAY["steps"], skip_latched=True)
        latched.append(f"{what} B={Kx.shape[0]} N={Kx.shape[1]} "
                       f"{int(found.sum())} latched")
    print(f"kernels: Pegasos stages 0 and 1 bit for bit against the plain "
          f"version at the one-way fit sets ({'; '.join(latched)} after "
          f"stage 0)")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ores = engine.run_sweep(all_ow, **ONEWAY, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ow_counts = kernels.launches()
    if ow_counts["pegasos_stage"] <= 0:
        raise AssertionError("the one-way sweep never launched pegasos_stage")
    stray = {n: c for n, c in ow_counts.items() if c and n != "pegasos_stage"}
    if stray:
        raise AssertionError(f"the one-way sweep launched {stray}")
    gate = {"sampling": [0, 0], "naive": [0, 0]}
    for i, (inst, r) in enumerate(zip(all_ow, ores)):
        sel, kk = inst.selector, len(inst.shards)
        d = inst.shards[0][0].shape[1]
        s_eps = epsilon_net_size(inst.eps, d + 1) if sel == "sampling" else 0
        want = dict(points=_oneway_points(inst, s_eps),
                    scalars=(kk - 1) * (d + 1) if sel == "mixing" else 0,
                    messages=kk - 1, rounds=kk - 1 if sel == "sampling" else 1)
        got = {f: r.comm[f] for f in want}
        if (r.extra["selector"], r.rounds, r.converged, got) != \
                (sel, want["rounds"], True, want):
            raise AssertionError(f"one-way {i} ({sel}): {r.extra}, rounds "
                                 f"{r.rounds}, comm {r.comm}, want {want}")
        if sel == "sampling" and r.extra["sample_size"] != s_eps:
            raise AssertionError(f"one-way {i}: sample size "
                                 f"{r.extra['sample_size']} != {s_eps}")
        parts = getattr(r.classifier, "parts", [r.classifier])
        if len(parts) != (kk if sel == "voting" else 1) or not all(
                p.w.shape == (d,) and np.isfinite(p.w).all()
                and np.isfinite(p.b) for p in parts):
            raise AssertionError(f"one-way {i} ({sel}): separator "
                                 f"{[(p.w, p.b) for p in parts]}")
        if sel in gate:
            X = np.concatenate([sh[0] for sh in inst.shards])
            y = np.concatenate([sh[1] for sh in inst.shards])
            gate[sel][0] += r.error_on(X, y) <= inst.eps
            gate[sel][1] += 1
    print(f"oneway sweep: {len(all_ow)} instances "
          f"({', '.join(f'{n} B={len(b)}' for n, b in ow)}) in {wall:.3f} s, "
          f"metering exact in closed form, launches {ow_counts}; global "
          f"error <= ε: sampling {gate['sampling'][0]}/{gate['sampling'][1]}"
          f", naive {gate['naive'][0]}/{gate['naive'][1]}")
    spans["pegasos_stage"].clear()
    pegasos_module.pegasos_stage = timed("pegasos_stage", originals[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_sweep(all_ow, **ONEWAY, device=dev)
        torch.cuda.synchronize()
        timed_wall = time.perf_counter() - t0
    finally:
        pegasos_module.pegasos_stage = originals[1]
    peg_s = sum(a.elapsed_time(b) for a, b in spans["pegasos_stage"]) / 1e3
    print(f"oneway sweep again with events: {timed_wall:.3f} s wall, "
          f"pegasos_stage {len(spans['pegasos_stage'])} calls {peg_s:.4f} s: "
          f"{peg_s / timed_wall:.1%} of the wall")

    # -- 9. the mixed one-way-vs-two-way gap sweep ----------------------------
    scenarios, gap = gap_instances(datasets, engine)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    gres = engine.run_sweep(gap, max_epochs=8, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gap_counts = kernels.launches()
    for name in ("median_cut_scores", "median_extremes", "maxmarg_turn_scan",
                 "pegasos_stage"):
        if gap_counts[name] <= 0:
            raise AssertionError(f"the gap sweep never launched {name}")
    for i, (inst, r) in enumerate(zip(gap, gres)):
        if r.extra["selector"] != inst.selector or not (
                np.isfinite(r.classifier.w).all()
                and np.isfinite(r.classifier.b)):
            raise AssertionError(f"gap {i}: {inst.selector} got {r.extra} "
                                 f"{r.classifier}")
    print(f"gap sweep: {len(gap)} instances in {wall:.3f} s, results in "
          f"input order, launches {gap_counts}")
    per = len(gap) // len(scenarios)
    fams = ("naive", "sampling", "median", "maxmarg")
    for si, (name, eps) in enumerate(scenarios):
        block = gres[si * per:(si + 1) * per]
        pts = {f: float(np.mean([r.comm["points"] for r in block[j::4]]))
               for j, f in enumerate(fams)}
        conv = {f: sum(r.converged for r in block[j::4])
                for j, f in enumerate(fams)}
        print(f"gap {name} ε={eps}: mean points "
              + ", ".join(f"{f} {pts[f]:.2f}" for f in fams)
              + f"; naive/median {pts['naive'] / max(pts['median'], 1):.2f}, "
              f"naive/maxmarg {pts['naive'] / max(pts['maxmarg'], 1):.2f}; "
              f"converged median {conv['median']}/{per // 4}, maxmarg "
              f"{conv['maxmarg']}/{per // 4}")

    # -- 10. one-way card against CPU ------------------------------------------
    k2 = ow[0][1]
    per_sel = len(k2) // 4
    step_i = per_sel // OW_SUBSET[0]
    sub = ([k2[s * per_sel + i * step_i] for s in range(4)
            for i in range(OW_SUBSET[0])] + ow[1][1][:OW_SUBSET[1]])
    on_card = engine.run_sweep(sub, device=dev)
    t0 = time.perf_counter()
    on_cpu = engine.run_sweep(sub, device="cpu")
    cpu_s = time.perf_counter() - t0
    bitwise, worst = 0, 1.0
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        if (a.comm, a.rounds, a.converged, a.extra.get("sample_size")) != \
                (b.comm, b.rounds, b.converged, b.extra.get("sample_size")):
            raise AssertionError(f"one-way instance {i}: card {a.comm} "
                                 f"{a.extra}, cpu {b.comm} {b.extra}")
        for pa, pb in zip(getattr(a.classifier, "parts", [a.classifier]),
                          getattr(b.classifier, "parts", [b.classifier])):
            va, vb = np.append(pa.w, pa.b), np.append(pb.w, pb.b)
            cos = _cosine(va, vb)
            worst = min(worst, cos)
            if not cos > 1.0 - COS_TOL:
                raise AssertionError(f"one-way instance {i}: separator "
                                     f"cosine {cos} (card {va}, cpu {vb})")
            bitwise += bool(np.array_equal(va, vb))
    fits = 0
    for group in ([x for x in sub if x.selector == "sampling"
                   and len(x.shards) == 2], ow[1][1][:OW_SUBSET[1]]):
        card_set = oneway.fit_set(group, device=dev)
        cpu_set = oneway.fit_set(group, device="cpu")
        for got, want, what in zip(card_set, cpu_set, ("Kx", "Ky")):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"RANDOM fit set {what} differs between "
                                     f"card and cpu")
        fits += len(group)
    n_sep = sum(len(getattr(r.classifier, "parts", [0])) for r in on_card)
    print(f"oneway card vs cpu: {len(sub)} instances ({OW_SUBSET[0]} per k=2 "
          f"selector, {OW_SUBSET[1]} k=4 sampling), comm/rounds/sample sizes "
          f"exact, {fits} RANDOM fit sets bit for bit, min cosine {worst!r}, "
          f"{bitwise}/{n_sep} separators bitwise equal (card: kernel path, "
          f"cpu: classic loop; cpu run {cpu_s:.2f} s)")

    # -- 11. the flash-attention kernel against its plain version ------------
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_stream
    from repro_torch.kernels import flash_attention as fa_module
    from repro_torch.models import layers, model as lm_model
    from repro_torch.serve import ServeConfig, TokenServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(11)

    def qkv(shapes, dtype):
        qs, ks = shapes
        return tuple(torch.randn(sh, generator=gen, device=dev).to(dtype)
                     for sh in (qs, ks, ks))

    no_routes = dict.fromkeys(fa_module.ROUTES, 0)
    for route in fa_module.ROUTES:
        errs[f"attention_{route}"] = 0.0

    def hold_attention(what, args, **kw):
        """The kernel against its plain version at ATTN_TOL, through the
        route ``attention_route`` names for the call (checked by the
        per-route count).  Returns the kernel's output."""
        q_, k_ = args[0], args[1]
        route = fa_module.attention_route(q_.dtype, q_.shape[-1], q_.shape[1],
                                          k_.shape[1])
        before = kernels.attention.routes[route]
        got = kernels.attention(*args, **kw)
        if kernels.attention.routes[route] != before + 1:
            raise AssertionError(f"flash attention, {what}: not launched "
                                 f"through the {route} route")
        want = kernels.attention_plain(*args, **kw)
        rtol, atol = ATTN_TOL[str(args[0].dtype).split(".")[1]]
        diff = (got.float() - want.float()).abs()
        if not (torch.isfinite(got.float()).all()
                and bool((diff <= atol + rtol * want.float().abs()).all())):
            raise AssertionError(f"flash attention, {what} ({route}): kernel "
                                 f"and plain version differ by up to "
                                 f"{float(diff.max())}")
        key = f"attention_{route}"
        errs[key] = max(errs[key], float(diff.max()))
        print(f"flash attention, {what} ({route}): max |kernel - plain| "
              f"{float(diff.max())!r}")
        return got

    S_sc, B_sc = SCORING["S"], SCORING["B"]
    scoring = ((B_sc, S_sc, 9, 64), (B_sc, S_sc, 3, 64))
    encoder = ((8, 1500, 16, 64), (8, 1500, 16, 64))
    decode = ((8, 1, 16, 64), encoder[1])
    crafted = [   # (what, shapes, kwargs), held in bf16 (tc) and f32 (simt)
        ("window 128", ((2, 1024, 9, 64), (2, 1024, 3, 64)),
         dict(causal=True, window=128)),
        ("kv_valid 40 (less than a tile)", ((2, 100, 4, 64), (2, 300, 4, 64)),
         dict(causal=False, kv_valid=40)),
        ("MQA", ((2, 512, 8, 64), (2, 512, 1, 64)), dict(causal=True)),
        ("ragged Sq 100 against Skv 1500",
         ((3, 100, 16, 64), (3, 1500, 16, 64)), dict(causal=False))]
    cases = [
        # tc: bf16, hd 64 and 128, more than 16 query rows
        ("smollm-135m scoring, bf16", scoring, bf16, dict(causal=True)),
        ("whisper-medium encoder, bf16", encoder, bf16, dict(causal=False)),
        ("qwen2.5-14b heads (H 40, KV 8, hd 128), bf16",
         ((2, 1024, 40, 128), (2, 1024, 8, 128)), bf16, dict(causal=True)),
        *[(f"{w}, bf16", sh, bf16, kw) for w, sh, kw in crafted],
        ("kv_valid 0, hd 128, bf16", ((1, 70, 2, 128), (1, 90, 1, 128)),
         bf16, dict(causal=False, kv_valid=0)),
        # splitkv: at most 16 query rows, any dtype and width
        ("whisper-medium cross-attention at decode, bf16", decode, bf16,
         dict(causal=False)),
        ("whisper-medium cross-attention at prefill, bf16",
         ((8, 4, 16, 64), encoder[1]), bf16, dict(causal=False)),
        ("whisper-medium cross-attention at decode, f32", decode, f32,
         dict(causal=False)),
        ("whisper-medium cross-attention at prefill, f32",
         ((8, 4, 16, 64), encoder[1]), f32, dict(causal=False)),
        ("Sq 4, GQA G 8, kv_valid 700, hd 128, f32",
         ((2, 4, 64, 128), (2, 1500, 8, 128)), f32,
         dict(causal=False, kv_valid=700)),
        ("Sq 1, GQA G 8, kv_valid 700, hd 128, bf16",
         ((2, 1, 64, 128), (2, 1500, 8, 128)), bf16,
         dict(causal=False, kv_valid=700)),
        ("Sq 16, GQA G 8, causal, hd 128, bf16",
         ((2, 16, 64, 128), (2, 1500, 8, 128)), bf16, dict(causal=True)),
        ("Sq 1 against Skv 1, f32", ((2, 1, 8, 64), (2, 1, 1, 64)), f32,
         dict(causal=False)),
        ("Sq 4 against Skv 1, bf16", ((2, 4, 8, 64), (2, 1, 1, 64)), bf16,
         dict(causal=False)),
        ("Sq 9, window 4, hd 32, f32", ((2, 9, 6, 32), (2, 300, 3, 32)), f32,
         dict(causal=True, window=4)),
        ("Sq 3, hd 256, f32", ((1, 3, 4, 256), (1, 333, 2, 256)), f32,
         dict(causal=False)),
        # simt: f32 above 16 rows, bf16 at hd 32 and 256
        ("smollm-135m scoring, f32", scoring, f32, dict(causal=True)),
        *[(f"{w}, f32", sh, f32, kw) for w, sh, kw in crafted],
        ("ragged causal S 1000, hd 32, bf16",
         ((2, 1000, 6, 32), (2, 1000, 3, 32)), bf16, dict(causal=True)),
        ("hd 256, Sq 300 against Skv 333, bf16",
         ((1, 300, 4, 256), (1, 333, 2, 256)), bf16, dict(causal=True)),
        ("hd 256, Sq 300 against Skv 333, f32",
         ((1, 300, 4, 256), (1, 333, 2, 256)), f32, dict(causal=True)),
        ("window 16, hd 32, f32", ((2, 200, 4, 32), (2, 200, 4, 32)), f32,
         dict(causal=True, window=16))]
    for what, shapes, dtype, kw in cases:
        hold_attention(what, qkv(shapes, dtype), **kw)
    # a window wider than the sequence is no window: the same function
    args = qkv(scoring, bf16)
    wide = hold_attention("window 16384 > S, bf16", args, causal=True,
                          window=16384)
    if not torch.equal(wide, kernels.attention(*args, causal=True)):
        raise AssertionError("window 16384 changed the kernel's output at "
                             f"S={S_sc}")
    aq, ak, av = args
    sdpa = F.scaled_dot_product_attention(
        aq.transpose(1, 2), ak.transpose(1, 2), av.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)
    print(f"library check: scaled_dot_product_attention against the plain "
          f"version, max |diff| "
          f"{float((sdpa.float() - wide.float()).abs().max())!r}")

    def attention_row(route, what, qkv_, causal, peak):
        """A kernel-table row of one attention route at one shape, beside
        ``scaled_dot_product_attention`` on the same inputs."""
        qq, kk, vv = qkv_
        if fa_module.attention_route(qq.dtype, qq.shape[-1], qq.shape[1],
                                     kk.shape[1]) != route:
            raise AssertionError(f"{what} does not take the {route} route")
        return dict(
            name=f"flash_attention_{route}", route="cuda",
            attention_route=route,
            source=f"src/repro_torch/kernels/csrc/"
                   f"{fa_module._STEM[route]}.cu",
            replaces="src/repro/kernels/flash_attention.py:81",
            fn=lambda: kernels.attention(qq, kk, vv, causal=causal),
            plain=lambda: kernels.attention_plain(qq, kk, vv, causal=causal),
            library=lambda: F.scaled_dot_product_attention(
                qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                is_causal=causal, enable_gqa=True),
            **bounds.attention_work(qq, kk, vv, causal)._asdict(),
            peak=peak, reps=(20, 3),
            shape=f"{what} q {tuple(qq.shape)} kv {tuple(kk.shape)}"
                  f"{' causal' if causal else ''} {str(qq.dtype)[6:]}")

    def time_attention(r):
        """_time_row, then the kernel's and the library's device times
        (CUDA-graph replay), printed."""
        _time_row(r)
        r["graph_ms"] = bounds.graph_ms(r["fn"])
        r["library_graph_ms"] = bounds.graph_ms(r["library"])
        print(f"time {r['name']} at {r['shape']}, device only (CUDA graph "
              f"of 50 calls): kernel {r['graph_ms']:.4f} ms, library "
              f"{r['library_graph_ms']:.4f} ms")

    attn_rows = [
        attention_row("tc", "smollm-135m scoring", args, True,
                      bounds.PEAK_FLOPS_BF16),
        attention_row("splitkv", "whisper-medium cross-attention at decode",
                      qkv(decode, bf16), False, bounds.PEAK_FLOPS_BF16),
        attention_row("simt", "smollm-135m scoring", qkv(scoring, f32), True,
                      bounds.PEAK_F32)]
    for r in attn_rows:
        time_attention(r)
    for r in attn_rows:
        del r["fn"], r["plain"], r["library"]
    del args, aq, ak, av, wide, sdpa

    # -- 12. path A: smollm-135m scoring, then smollm-135m serving -----------
    scfg = get_config(SCORING["arch"])
    t0 = time.perf_counter()
    smollm = lm_model.init_lm(scfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"smollm-135m: {sum(t.numel() for t in smollm.parameters())} "
          f"parameters (param_count {scfg.param_count()}), drawn on the card "
          f"in {time.perf_counter() - t0:.2f} s")
    sbatch = next(synthetic_stream(scfg, DataConfig(seq_len=S_sc,
                                                    global_batch=B_sc)))
    layers.set_attention_impl("kernel")
    lm_model.forward_train(smollm, scfg, sbatch)        # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    loss_k, met = lm_model.forward_train(smollm, scfg, sbatch)
    torch.cuda.synchronize()
    score_counts = kernels.launches()
    route_counts = {"smollm_scoring": dict(kernels.attention.routes)}
    expect = dict({n: 0 for n in counts}, attention=scfg.n_layers)
    if score_counts != expect or route_counts["smollm_scoring"] != dict(
            no_routes, tc=scfg.n_layers):
        raise AssertionError(f"smollm-135m scoring launched {score_counts}, "
                             f"routes {route_counts['smollm_scoring']}; "
                             f"expected {scfg.n_layers} attention launches, "
                             f"all tc")
    if not torch.isfinite(loss_k):
        raise AssertionError(f"smollm-135m scoring loss {loss_k}")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_model.forward_train(smollm, scfg, sbatch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    score_wall = float(np.median(walls))
    attn_spans = []
    original = fa_module.attention

    def timed_attention(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = original(*a, **kw)
        ev[1].record()
        attn_spans.append(ev)
        return out

    # the wrapper counts its launches through its module-level name, which
    # is this shim during the pass (the counts were read above)
    timed_attention.launches = 0
    timed_attention.routes = dict(no_routes)
    fa_module.attention = timed_attention
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_model.forward_train(smollm, scfg, sbatch)
        torch.cuda.synchronize()
        events_wall = time.perf_counter() - t0
    finally:
        fa_module.attention = original
    attn_s = sum(a.elapsed_time(b) for a, b in attn_spans) / 1e3
    layers.set_attention_impl("plain")
    loss_p, _ = lm_model.forward_train(smollm, scfg, sbatch)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not rel <= 2e-2:
        raise AssertionError(f"smollm-135m scoring loss {float(loss_k)} "
                             f"under the kernel, {float(loss_p)} plain")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_model.forward_train(smollm, scfg, sbatch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"path A, smollm-135m scoring B={B_sc} S={S_sc} bf16: loss "
          f"{float(loss_k)!r} (plain attention {float(loss_p)!r}, relative "
          f"{rel:.3g}), acc {float(met['acc']):.4f}, "
          f"{score_counts['attention']} attention launches; "
          f"{score_wall * 1e3:.2f} ms a pass (median of 5), "
          f"{B_sc * S_sc / score_wall:.0f} tokens/s; with plain attention "
          f"{float(np.median(walls)) * 1e3:.2f} ms, "
          f"{B_sc * S_sc / float(np.median(walls)):.0f} tokens/s; the kernel's "
          f"{len(attn_spans)} launches take {attn_s * 1e3:.2f} ms of a "
          f"{events_wall * 1e3:.2f} ms pass ({attn_s / events_wall:.1%})")

    def serve(cfg, params, sc, prompt, n, impl):
        """Warm up, then prefill and decode ``n`` tokens with the launch
        counts set to 0 just before; returns (tokens, counts, prefill ms,
        ms per token)."""
        layers.set_attention_impl(impl)
        warm = TokenServingEngine(cfg, params, sc, device=dev)
        warm.generate(warm.prefill_prompt(prompt)[:, -1].argmax(-1), 2)
        del warm
        eng = TokenServingEngine(cfg, params, sc, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        first = eng.prefill_prompt(prompt)[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = eng.generate(first, n)
        t2 = time.perf_counter()
        got = kernels.launches()
        if not (toks.shape == (sc.batch, n)
                and ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{cfg.name} served tokens {toks}")
        return toks, got, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / n

    ss = SERVE_SMOLLM
    sprompt = {"tokens": sbatch["tokens"][:, :ss["prompt"]]}
    ssc = ServeConfig(batch=ss["B"], cache_len=ss["cache_len"])
    _, smollm_counts, pre_ms, tok_ms = serve(scfg, smollm, ssc, sprompt,
                                             ss["tokens"], "kernel")
    if any(smollm_counts.values()):
        raise AssertionError(f"smollm-135m serving launched {smollm_counts}; "
                             f"the JAX package routes none of it to a kernel")
    print(f"path B, smollm-135m serving B={ss['B']} prompt {ss['prompt']} "
          f"cache {ss['cache_len']} bf16: prefill {pre_ms:.2f} ms, "
          f"{tok_ms:.3f} ms per decoded token ({ss['tokens']} tokens, "
          f"{ss['B'] * 1e3 / tok_ms:.0f} tokens/s), launches {smollm_counts}")

    # -- 13. path B: whisper-medium serving ----------------------------------
    wcfg = get_config("whisper-medium")
    sw = SERVE_WHISPER
    whisper = lm_model.init_lm(wcfg, seed=0, device=dev)
    print(f"whisper-medium: {sum(t.numel() for t in whisper.parameters())} "
          f"parameters (param_count {wcfg.param_count()})")
    wbatch = next(synthetic_stream(wcfg, DataConfig(seq_len=sw["enc_len"],
                                                    global_batch=sw["B"])))
    wprompt = {"tokens": wbatch["tokens"][:, :sw["prompt"]],
               "audio_embed": wbatch["audio_embed"]}
    wsc = ServeConfig(batch=sw["B"], cache_len=sw["cache_len"],
                      enc_len=sw["enc_len"])
    wtoks, whisper_counts, wpre_ms, wtok_ms = serve(
        wcfg, whisper, wsc, wprompt, sw["tokens"], "kernel")
    route_counts["whisper_serving"] = dict(kernels.attention.routes)
    want_launches = (wcfg.n_enc_layers + wcfg.n_layers
                     + wcfg.n_layers * sw["tokens"])
    expect = dict({n: 0 for n in counts}, attention=want_launches)
    # the encoder's self-attention on the tensor cores; the cross-attention
    # at prefill (4 rows) and at every decoded token (1 row) split the keys
    want_routes = dict(no_routes, tc=wcfg.n_enc_layers,
                       splitkv=wcfg.n_layers * (1 + sw["tokens"]))
    if (whisper_counts != expect
            or route_counts["whisper_serving"] != want_routes):
        raise AssertionError(f"whisper-medium serving launched "
                             f"{whisper_counts}, routes "
                             f"{route_counts['whisper_serving']}; expected "
                             f"{want_launches} attention launches, routes "
                             f"{want_routes}")
    # the plain pass takes query blocks that divide Sq (the JAX package's
    # "xla" backend asserts the same); one block of 1500 encoder rows
    psc = ServeConfig(batch=sw["B"], cache_len=sw["cache_len"],
                      enc_len=sw["enc_len"],
                      flags=lm_model.RunFlags(block_q=sw["enc_len"]))
    ptoks, _, ppre_ms, ptok_ms = serve(wcfg, whisper, psc, wprompt,
                                       sw["tokens"], "plain")
    print(f"path B, whisper-medium serving B={sw['B']} enc {sw['enc_len']} "
          f"prompt {sw['prompt']} cache {sw['cache_len']} bf16: prefill "
          f"{wpre_ms:.2f} ms, {wtok_ms:.3f} ms per decoded token "
          f"({sw['tokens']} tokens), {whisper_counts['attention']} attention "
          f"launches; with plain attention prefill {ppre_ms:.2f} ms, "
          f"{ptok_ms:.3f} ms per token, {int((ptoks == wtoks).sum())} of "
          f"{wtoks.size} tokens the same")

    # card against CPU, f32, the same weights; counted as a path: the f32
    # calls take the simt route (above 16 rows) and the splitkv route
    layers.set_attention_impl("kernel")
    torch.cuda.synchronize()
    kernels.reset_launches()
    for name, mcfg, params, dc, prompt_len in [
            ("smollm-135m", scfg, smollm, DataConfig(seq_len=128,
                                                     global_batch=1, seed=1),
             128),
            ("whisper-medium", wcfg, whisper,
             DataConfig(seq_len=256, global_batch=1, seed=1), 4)]:
        b1 = next(synthetic_stream(mcfg, dc))
        on_cpu = lm_model.cast_params(params, f32, device="cpu")
        if not mcfg.enc_dec:
            lc, _ = lm_model.forward_train(params, mcfg, b1, dtype=f32)
            lh, _ = lm_model.forward_train(on_cpu, mcfg, b1, dtype=f32)
            if not abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh)):
                raise AssertionError(f"{name} loss card {float(lc)!r}, cpu "
                                     f"{float(lh)!r}")
            print(f"{name} card vs cpu, B=1 S=128 f32: loss {float(lc)!r} "
                  f"and {float(lh)!r}")
        prompt = {"tokens": b1["tokens"][:, :prompt_len]}
        enc_len = 0
        if mcfg.enc_dec:
            prompt["audio_embed"] = b1["audio_embed"]
            enc_len = b1["audio_embed"].shape[1]
        sc = ServeConfig(batch=1, cache_len=prompt_len + 8, dtype=f32,
                         enc_len=enc_len)
        card_eng = TokenServingEngine(mcfg, params, sc, device=dev)
        cpu_eng = TokenServingEngine(mcfg, on_cpu, sc, device="cpu")
        lc = card_eng.prefill_prompt(prompt)
        lh = cpu_eng.prefill_prompt(prompt)
        first = lh[:, -1].argmax(-1)
        want, gaps = _greedy(cpu_eng, first, 8)
        got = card_eng.generate(first, 8)
        _same_tokens(got, want, gaps, f"{name} card vs cpu")
        print(f"{name} card vs cpu, f32: prefill logits max |diff| "
              f"{float((lc.cpu() - lh).abs().max())!r}, 8 greedy tokens "
              f"card {got.tolist()} cpu {want.tolist()}")
        del on_cpu, card_eng, cpu_eng
    f32_counts = kernels.launches()
    route_counts["card_vs_cpu_f32"] = dict(kernels.attention.routes)
    # smollm-135m: 30 scoring layers; whisper-medium: 24 encoder layers at
    # 256 frames, then 24 cross-attention calls at prefill and at each of 8
    # decoded tokens (the CPU engine launches nothing)
    want_routes = dict(no_routes, simt=scfg.n_layers + wcfg.n_enc_layers,
                       splitkv=wcfg.n_layers * (1 + 8))
    if (route_counts["card_vs_cpu_f32"] != want_routes
            or f32_counts != dict({n: 0 for n in counts},
                                  attention=sum(want_routes.values()))):
        raise AssertionError(f"card vs cpu in f32 launched {f32_counts}, "
                             f"routes {route_counts['card_vs_cpu_f32']}; "
                             f"expected routes {want_routes}")
    print(f"card vs cpu, f32: attention routes "
          f"{route_counts['card_vs_cpu_f32']}")
    layers.set_attention_impl("plain")

    # -- 14. the SSM kernels against their plain versions --------------------
    import dataclasses
    del smollm, whisper, params
    torch.cuda.empty_cache()
    rcfg = get_config(RWKV["arch"])
    jcfg = jamba_dense(get_config("jamba-1.5-large-398b"))
    R_H, R_hd = rcfg.d_model // rcfg.rwkv.head_dim, rcfg.rwkv.head_dim
    J_di, J_ds = jcfg.ssm.expand * jcfg.d_model, jcfg.ssm.d_state

    def wkv_inputs(B, S, H, hd, wval=None, state=False, dtype=f32):
        """r, k, v in ``dtype`` (path C passes the model's bf16); w, u
        and the state f32."""
        r, k, v = (torch.randn((B, S, H, hd), generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        if wval is None:    # the JAX tests' decays, in (0.01, 0.99)
            w = torch.sigmoid(torch.randn((B, S, H, hd), generator=gen,
                                          device=dev)) * 0.98 + 0.01
        else:
            w = torch.full((B, S, H, hd), wval, device=dev)
        u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
        s0 = (torch.randn((B, H, hd, hd), generator=gen, device=dev)
              if state else None)
        return (r, k, v, w, u), s0

    def scan_inputs(B, S, di, dtype, decay=None, state=False):
        """Δ as the model makes it (softplus near dt_bias's -4.6) and A of
        random magnitudes; or, for a decay extreme, A = -1 and a constant
        Δ = -log(decay), so every exp(Δ A) equals ``decay``."""
        xc = torch.randn((B, S, di), generator=gen, device=dev)
        if decay is None:
            delta = F.softplus(torch.randn((B, S, di), generator=gen,
                                           device=dev) - 4.6)
            A = -torch.exp(torch.randn((di, J_ds), generator=gen,
                                       device=dev) * 0.5)
        else:
            delta = torch.full((B, S, di), -float(np.log(decay)),
                               device=dev)
            A = -torch.ones((di, J_ds), device=dev)
        Bs, Cs = (torch.randn((B, S, J_ds), generator=gen, device=dev)
                  for _ in range(2))
        h0 = (torch.randn((B, di, J_ds), generator=gen, device=dev)
              if state else None)
        return (xc.to(dtype), delta.to(dtype), A, Bs.to(dtype),
                Cs.to(dtype)), h0

    errs["rwkv6"] = errs["mamba_scan"] = 0.0

    def hold_ssm(name, what, args, s0):
        """The wrapper (on a copy of ``s0``, written in place) against its
        plain version: y and the final state to SSM_TOL."""
        state = None if s0 is None else s0.clone()
        y, final = getattr(kernels, name)(*args, state=state)
        yp, fp = getattr(kernels, name + "_plain")(*args, s0)
        if state is not None and final is not state:
            raise AssertionError(f"{name}, {what}: the state was not "
                                 f"written in place")
        out = []
        for part, got, want in (("y", y, yp), ("state", final, fp)):
            tol = SSM_TOL[str(got.dtype).split(".")[1]]
            diff = float((got.float() - want.float()).abs().max())
            scale = max(1.0, float(want.float().abs().max()))
            if not (bool(torch.isfinite(got.float()).all())
                    and diff <= tol * scale):
                raise AssertionError(f"{name}, {what}: {part} of kernel and "
                                     f"plain version differ by up to {diff} "
                                     f"(scale {scale})")
            errs[name] = max(errs[name], diff)
            out.append(f"{part} {diff!r} (of {scale:.4g})")
        if name == "mamba_scan" and not torch.equal(final, fp):
            raise AssertionError(f"{name}, {what}: the final state differs "
                                 f"from the plain version's")
        print(f"{name}, {what}: max |kernel - plain| {', '.join(out)}"
              + (", state bit for bit" if name == "mamba_scan" else ""))

    bf16 = torch.bfloat16
    rw32_args, _ = wkv_inputs(RWKV["B"], RWKV["S"], R_H, R_hd)
    hold_ssm("rwkv6", f"rwkv6-7b scoring {tuple(rw32_args[0].shape)}, f32",
             rw32_args, None)
    # as path C passes them: r, k, v in bf16, w and u f32
    rw_args, _ = wkv_inputs(RWKV["B"], RWKV["S"], R_H, R_hd, dtype=bf16)
    hold_ssm("rwkv6", f"rwkv6-7b scoring {tuple(rw_args[0].shape)}, bf16 "
             f"r, k, v", rw_args, None)
    for what, shape, kw in [
            ("decode, S 1 with a carried state", (8, 1, R_H, R_hd),
             dict(state=True)),
            ("decode, S 1 with a carried state, bf16 r, k, v",
             (8, 1, R_H, R_hd), dict(state=True, dtype=bf16)),
            ("S 100 (ragged against the 16-step chunk), carried state",
             (2, 100, R_H, R_hd), dict(state=True)),
            ("S 1, B 1", (1, 1, R_H, R_hd), {}),
            ("hd 32, S 100, carried state", (2, 100, 8, 32),
             dict(state=True)),
            ("decay w = 0.02, S 2048", (2, 2048, 8, R_hd), dict(wval=0.02)),
            ("decay w = 0.999, S 2048, carried state", (2, 2048, 8, R_hd),
             dict(wval=0.999, state=True))]:
        hold_ssm("rwkv6", what, *wkv_inputs(*shape, **kw))
    sc_args, _ = scan_inputs(JAMBA["B"], JAMBA["S"], J_di, bf16)
    hold_ssm("mamba_scan", f"Jamba scoring {tuple(sc_args[0].shape)} ds "
             f"{J_ds}, bf16", sc_args, None)
    for what, shape, kw in [
            ("Jamba scoring shape, f32", (JAMBA["B"], JAMBA["S"], J_di, f32),
             {}),
            ("decode, S 1 with a carried state, bf16", (8, 1, J_di, bf16),
             dict(state=True)),
            ("decode, S 1 with a carried state, f32", (8, 1, J_di, f32),
             dict(state=True)),
            ("decode, S 1, B 1, carried state, bf16", (1, 1, J_di, bf16),
             dict(state=True)),
            ("di 1000 (not a multiple of the 128-channel block), S 100, "
             "carried state, f32", (2, 100, 1000, f32), dict(state=True)),
            ("di 1000, S 100, carried state, bf16", (2, 100, 1000, bf16),
             dict(state=True)),
            ("di 1001 (rows not 16-byte multiples: scalar staging), S 33, "
             "carried state, f32", (2, 33, 1001, f32), dict(state=True)),
            ("di 1001, S 33, bf16", (2, 33, 1001, bf16), {}),
            ("S 31 (under a 16-step bf16 chunk), carried state, bf16",
             (2, 31, 2048, bf16), dict(state=True)),
            ("S 33 (a chunk and one step past), bf16", (2, 33, 2048, bf16),
             {}),
            ("S 33, f32 (8-step chunks)", (2, 33, 2048, f32), {}),
            ("S 100, carried state, bf16", (2, 100, 2048, bf16),
             dict(state=True)),
            ("S 1, B 1, f32", (1, 1, J_di, f32), {}),
            ("decay exp(ΔA) = 0.02, S 2048, f32", (2, 2048, 2048, f32),
             dict(decay=0.02)),
            ("decay exp(ΔA) = 0.999, S 2048, carried state, f32",
             (2, 2048, 2048, f32), dict(decay=0.999, state=True))]:
        hold_ssm("mamba_scan", what, *scan_inputs(*shape, **kw))
    # Jamba's attention layer at its scoring shape, as path D launches it,
    # held and timed (printed; the JSON line's tc row is smollm-135m's)
    jamba_qkv = qkv(((JAMBA["B"], JAMBA["S"], jcfg.n_heads, jcfg.hd),
                     (JAMBA["B"], JAMBA["S"], jcfg.n_kv, jcfg.hd)), bf16)
    what = f"Jamba scoring (H {jcfg.n_heads}, KV {jcfg.n_kv}, hd {jcfg.hd})"
    hold_attention(f"{what}, bf16", jamba_qkv, causal=True)
    time_attention(attention_row("tc", what, jamba_qkv, True,
                                 bounds.PEAK_FLOPS_BF16))
    del jamba_qkv
    torch.cuda.empty_cache()
    # grok-1's and qwen2-vl's attention layers at their phase-19 scoring
    # shapes, as those paths launch them: held and timed (printed; the
    # device time gives qwen2-vl's attention share in phase 19)
    family_attn_ms = {}
    for name in ("grok-1-314b", "qwen2-vl-2b"):
        fcfg, fs = get_config(name), FAMILY_SCORING[name]
        fqkv = qkv(((fs["B"], fs["S"], fcfg.n_heads, fcfg.hd),
                    (fs["B"], fs["S"], fcfg.n_kv, fcfg.hd)), bf16)
        what = (f"{name} scoring (H {fcfg.n_heads}, KV {fcfg.n_kv}, hd "
                f"{fcfg.hd})")
        hold_attention(f"{what}, bf16", fqkv, causal=True)
        r = attention_row("tc", what, fqkv, True, bounds.PEAK_FLOPS_BF16)
        time_attention(r)
        family_attn_ms[name] = r["graph_ms"]
        del fqkv, r
        torch.cuda.empty_cache()
    rB, rS, rH, rhd = rw_args[0].shape
    sB, sS, sdi = sc_args[0].shape
    ssm_rows = [
        dict(name="rwkv6", route="cuda",
             source="src/repro_torch/kernels/csrc/rwkv6.cu",
             replaces="src/repro/kernels/rwkv6.py:81",
             fn=lambda: kernels.rwkv6(*rw_args),
             plain=lambda: kernels.rwkv6_plain(*rw_args),
             **bounds.wkv_work(*rw_args)._asdict(),
             shape=f"rwkv6-7b scoring r {tuple(rw_args[0].shape)}, bf16 r, "
                   f"k, v and f32 w as path C passes them",
             reps=(50, 3)),
        dict(name="mamba_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/mamba_scan.cu",
             replaces="src/repro/kernels/mamba.py:63",
             fn=lambda: kernels.mamba_scan(*sc_args),
             plain=lambda: kernels.mamba_scan_plain(*sc_args),
             **bounds.scan_work(*sc_args)._asdict(),
             shape=f"Jamba scoring xc {tuple(sc_args[0].shape)} ds {J_ds} "
                   f"bf16")]
    # the attention timing above runs the tensor cores at full power and
    # can leave the clocks down for a moment: let them settle, and print
    # them beside the scans' times
    time.sleep(1.0)
    print(f"clocks before the SSM timing: {_clocks()}")
    for r in ssm_rows:
        _time_row(r)
    for r in ssm_rows:
        print(f"time {r['name']} at {r['shape']}, device (CUDA graph): "
              f"{bounds.graph_ms(r['fn'], n=10):.4f} ms")
    print(f"clocks after: {_clocks()}")
    # the scan's residency and its step loop's instructions, from its SASS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = kernels.mamba.occupancy(bf16)
    blocks = -(-sdi // 128) * sB
    print(f"mamba_scan residency: {per_sm} blocks of 128 an SM in bf16 "
          f"({kernels.mamba.occupancy(f32)} in f32) on {sms} SMs; Jamba's "
          f"scoring grid of {blocks} blocks takes "
          f"{blocks / (per_sm * sms):.3f} waves")
    loop, exps, ops = _step_loop(_build.sass("mamba_scan"),
                                 "mamba_scanI13__nv_bfloat16")
    slots = loop / exps * J_ds * sB * sS * sdi / 32    # warp instructions
    print(f"mamba_scan SASS (bf16): the step loop holds {loop} instructions "
          f"for {exps} exponentials, {loop / exps:.4f} a (step, channel, "
          f"state): {dict(ops.most_common())}; at the scoring shape "
          f"{slots:.4g} warp instructions, "
          f"{slots / (4 * sms * 1.98e9) * 1e3:.4g} ms at one a clock on "
          f"each of {4 * sms} schedulers at 1.98 GHz")
    # the scan at prefill's shape (B=8, S=512), printed
    pre_sc, _ = scan_inputs(SERVE_SSM["B"], SERVE_SSM["prompt"], J_di, bf16)
    pB, pS = SERVE_SSM["B"], SERVE_SSM["prompt"]
    _time_row(dict(name="mamba_scan",
                   shape=f"prefill xc ({pB}, {pS}, {J_di}) ds {J_ds} bf16",
                   fn=lambda: kernels.mamba_scan(*pre_sc),
                   plain=lambda: kernels.mamba_scan_plain(*pre_sc),
                   **bounds.scan_work(*pre_sc)._asdict()), reps=(20, 1))
    del pre_sc
    # the same scoring shape with every input f32 (the first design's only
    # input type), printed
    _time_row(dict(name="rwkv6", shape=f"rwkv6-7b scoring r "
                   f"{tuple(rw32_args[0].shape)}, f32",
                   fn=lambda: kernels.rwkv6(*rw32_args),
                   plain=lambda: kernels.rwkv6_plain(*rw32_args),
                   **bounds.wkv_work(*rw32_args)._asdict()))
    del rw32_args
    # the decode shape (S 1, the state read and written in place), where
    # serving makes all but 32 of its WKV and all but 7 of its scan
    # launches; printed only, the JSON line keeps the scoring shape
    dec_rw, dec_rw0 = wkv_inputs(8, 1, R_H, R_hd, state=True, dtype=bf16)
    dec_rw32, _ = wkv_inputs(8, 1, R_H, R_hd)
    dec_sc, dec_h0 = scan_inputs(8, 1, J_di, bf16, state=True)
    rw_state, sc_state = dec_rw0.clone(), dec_h0.clone()
    dec_rows = [
            dict(name="rwkv6",
                 shape=f"decode r (8, 1, {R_H}, {R_hd}), carried state, "
                       f"bf16 r, k, v",
                 fn=lambda: kernels.rwkv6(*dec_rw, state=rw_state),
                 plain=lambda: kernels.rwkv6_plain(*dec_rw, dec_rw0),
                 **bounds.wkv_work(*dec_rw, state=dec_rw0)._asdict()),
            dict(name="rwkv6",
                 shape=f"decode r (8, 1, {R_H}, {R_hd}), carried state, f32",
                 fn=lambda: kernels.rwkv6(*dec_rw32, state=rw_state),
                 plain=lambda: kernels.rwkv6_plain(*dec_rw32, dec_rw0),
                 **bounds.wkv_work(*dec_rw32, state=dec_rw0)._asdict()),
            dict(name="mamba_scan",
                 shape=f"decode xc (8, 1, {J_di}), carried state, bf16",
                 fn=lambda: kernels.mamba_scan(*dec_sc, state=sc_state),
                 plain=lambda: kernels.mamba_scan_plain(*dec_sc, dec_h0),
                 **bounds.scan_work(*dec_sc, state=dec_h0)._asdict())]
    for r in dec_rows:
        _time_row(r)
    # decode's device time: a CUDA graph of calls, no host launch time
    for r in dec_rows:
        print(f"time {r['name']} at {r['shape']}, device (CUDA graph): "
              f"{bounds.graph_ms(r['fn']):.4f} ms, bound {r['bound_ms']:.4g} ms")
    del rw_args, sc_args, dec_rw, dec_rw32, dec_rw0, dec_sc, dec_h0
    del rw_state, sc_state, dec_rows
    for r in ssm_rows:
        del r["fn"], r["plain"]
    torch.cuda.empty_cache()

    def score(name, mcfg, lm, batch, expect, wrapper, routes=None):
        """Warm up, then one ``forward_train`` with the launch counts set to
        0 just before (exactly ``expect``, and the attention routes
        ``routes``), five timed passes, and one with CUDA events around
        every call of ``kernels.<wrapper>``.  Returns (launches, routes)."""
        lm_model.forward_train(lm, mcfg, batch)            # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        loss, met = lm_model.forward_train(lm, mcfg, batch)
        torch.cuda.synchronize()
        got = kernels.launches()
        got_routes = dict(kernels.attention.routes)
        if (got != dict({n: 0 for n in counts}, **expect)
                or got_routes != dict(no_routes, **(routes or {}))):
            raise AssertionError(f"{name} scoring launched {got}, routes "
                                 f"{got_routes}; expected {expect}, routes "
                                 f"{routes}")
        if not (torch.isfinite(loss) and 0 <= float(met["acc"]) <= 1):
            raise AssertionError(f"{name} scoring loss {loss}, acc "
                                 f"{met['acc']}")
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_model.forward_train(lm, mcfg, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        spans, original = [], getattr(kernels, wrapper)

        def timed(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = original(*a, **kw)
            ev[1].record()
            spans.append(ev)
            return out

        # the model calls the wrapper through the package's name, which is
        # this shim during the pass (the counts were read above)
        setattr(kernels, wrapper, timed)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_model.forward_train(lm, mcfg, batch)
            torch.cuda.synchronize()
            events_wall = time.perf_counter() - t0
        finally:
            setattr(kernels, wrapper, original)
        span_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
        B, S = batch["tokens"].shape
        print(f"{name} scoring B={B} S={S} bf16: loss {float(loss)!r}, acc "
              f"{float(met['acc']):.4f}, launches {got}; {wall * 1e3:.2f} ms "
              f"a pass (median of 5: {[round(w * 1e3, 2) for w in walls]}), "
              f"{B * S / wall:.0f} tokens/s; the {len(spans)} {wrapper} "
              f"launches take {span_s * 1e3:.2f} ms of a "
              f"{events_wall * 1e3:.2f} ms pass ({span_s / events_wall:.1%})")
        return got, got_routes

    def serve_path(name, mcfg, lm, batch, expect):
        sv = SERVE_SSM
        prompt = {"tokens": batch["tokens"][:, :sv["prompt"]]}
        sc = ServeConfig(batch=sv["B"], cache_len=sv["cache_len"])
        _, got, pre, tok = serve(mcfg, lm, sc, prompt, sv["tokens"],
                                 "kernel")
        if (got != dict({n: 0 for n in counts}, **expect)
                or kernels.attention.routes != no_routes):
            raise AssertionError(f"{name} serving launched {got}; expected "
                                 f"{expect}")
        print(f"{name} serving B={sv['B']} prompt {sv['prompt']} cache "
              f"{sv['cache_len']} bf16: prefill {pre:.2f} ms, {tok:.3f} ms "
              f"per decoded token ({sv['tokens']} tokens, "
              f"{sv['B'] * 1e3 / tok:.0f} tokens/s), launches {got}")
        return got

    def drawn(name, mcfg, dtype):
        t0 = time.perf_counter()
        lm = lm_model.init_lm(mcfg, seed=0, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        print(f"{name}: {sum(t.numel() for t in lm.parameters())} "
              f"parameters (param_count {mcfg.param_count()}), drawn on the "
              f"card in {dtype} in {time.perf_counter() - t0:.2f} s")
        return lm

    # -- 15. path C: rwkv6-7b scoring, then serving --------------------------
    layers.set_attention_impl("kernel")
    n_tok = SERVE_SSM["tokens"]
    rwkv = drawn("rwkv6-7b", rcfg, bf16)
    rbatch = next(synthetic_stream(rcfg, DataConfig(
        seq_len=RWKV["S"], global_batch=RWKV["B"])))
    rwkv_scoring, _ = score("path C, rwkv6-7b", rcfg, rwkv, rbatch,
                            dict(rwkv6=rcfg.n_layers), "rwkv6")
    rwkv_serving = serve_path("path C, rwkv6-7b", rcfg, rwkv, rbatch,
                              dict(rwkv6=rcfg.n_layers * (1 + n_tok)))
    del rwkv
    torch.cuda.empty_cache()

    # -- 16. path D: Jamba without experts -----------------------------------
    n_mamba = sum(m == "mamba" for m, _ in jcfg.period)
    print(f"path D config: {jcfg.name} = jamba-1.5-large-398b cut to one "
          f"period with dense FFNs: {jcfg.n_layers} layers "
          f"({n_mamba} Mamba), d {jcfg.d_model}, {jcfg.n_heads} heads / "
          f"{jcfg.n_kv} kv, hd {jcfg.hd}, d_ff {jcfg.d_ff}, vocab "
          f"{jcfg.vocab}, d_state {J_ds}, d_conv {jcfg.ssm.d_conv}, expand "
          f"{jcfg.ssm.expand}, dt_rank {-(-jcfg.d_model // 16)}")
    jamba = drawn("jamba without experts", jcfg, bf16)
    jbatch = next(synthetic_stream(jcfg, DataConfig(
        seq_len=JAMBA["S"], global_batch=JAMBA["B"])))
    jamba_scoring, route_counts["jamba_scoring"] = score(
        "path D, jamba without experts", jcfg, jamba, jbatch,
        dict(mamba_scan=n_mamba, attention=jcfg.n_layers - n_mamba),
        "mamba_scan", routes=dict(tc=jcfg.n_layers - n_mamba))
    jamba_serving = serve_path("path D, jamba without experts", jcfg, jamba,
                               jbatch, dict(mamba_scan=n_mamba * (1 + n_tok)))
    del jamba
    torch.cuda.empty_cache()

    # card against CPU, f32, the same weights, full width at two layers
    for name, mcfg in [
            ("rwkv6-7b", dataclasses.replace(rcfg, n_layers=2)),
            ("jamba without experts", dataclasses.replace(
                jcfg, n_layers=2, period=(("mamba", "mlp"),
                                          ("attn", "mlp"))))]:
        params = drawn(f"{name} at 2 layers", mcfg, f32)
        on_cpu = lm_model.cast_params(params, f32, device="cpu")
        b1 = next(synthetic_stream(mcfg, DataConfig(seq_len=32,
                                                    global_batch=1, seed=1)))
        lc, _ = lm_model.forward_train(params, mcfg, b1, dtype=f32)
        t0 = time.perf_counter()
        lh, _ = lm_model.forward_train(on_cpu, mcfg, b1, dtype=f32)
        if not abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh)):
            raise AssertionError(f"{name} loss card {float(lc)!r}, cpu "
                                 f"{float(lh)!r}")
        sc = ServeConfig(batch=1, cache_len=32 + 8, dtype=f32)
        card_eng = TokenServingEngine(mcfg, params, sc, device=dev)
        cpu_eng = TokenServingEngine(mcfg, on_cpu, sc, device="cpu")
        prompt = {"tokens": b1["tokens"][:, :32]}
        lgc = card_eng.prefill_prompt(prompt)
        lgh = cpu_eng.prefill_prompt(prompt)
        first = lgh[:, -1].argmax(-1)
        want, gaps = _greedy(cpu_eng, first, 8)
        got = card_eng.generate(first, 8)
        _same_tokens(got, want, gaps, f"{name} card vs cpu")
        print(f"{name} card vs cpu, 2 layers, B=1 prompt 32, f32: loss "
              f"{float(lc)!r} and {float(lh)!r}, prefill logits max |diff| "
              f"{float((lgc.cpu() - lgh).abs().max())!r}, 8 greedy tokens "
              f"card {got.tolist()} cpu {want.tolist()} (cpu side "
              f"{time.perf_counter() - t0:.2f} s)")
        del params, on_cpu, card_eng, cpu_eng
        torch.cuda.empty_cache()
    layers.set_attention_impl("plain")

    # -- 17. the unified dispatch and the protocol service ------------------
    unified_counts, service_counts, held = unified_phase(dev, card)
    for name, e in held.items():
        errs[name] = max(errs[name], e)

    # -- 18. the sharded B axis and the two-way host protocols ---------------
    t_phase = time.perf_counter()
    sharded_counts, held = sharded_phase(dev, insts, res, mm_insts,
                                         mres[:len(mm_insts)])
    for name, e in held.items():
        errs[name] = max(errs[name], e)
    protocol_counts = two_way_phase(dev)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")

    # -- 19. the MoE, MLA and VLM families ------------------------------------
    family_counts, family_routes = families_phase(dev, family_attn_ms)
    route_counts.update(family_routes)

    # -- 20. training ----------------------------------------------------------
    train_counts, train_refs = training_phase(dev)

    # -- 21. the model stack on a mesh ----------------------------------------
    mesh_counts, mesh_routes, held, plan = mesh_phase(dev, train_refs,
                                                      card)
    route_counts.update(mesh_routes)
    for name, e in held.items():
        errs[name] = max(errs.get(name, 0.0), e)

    # -- 22. the analysis tooling and the examples -----------------------------
    t_phase = time.perf_counter()
    tuning_phase(dev, card)
    examples_phase(dev)
    print(f"22c plan_cost of 21c's plan: dot FLOPs {plan.dot_flops:.4e} of "
          f"{plan.flops:.4e} FLOPs; fused bytes {plan.bytes_fused:.4e} of "
          f"{plan.bytes_accessed:.4e} ({plan.memory_fused_s * 1e3:.3f} ms "
          f"against {plan.memory_s * 1e3:.3f} ms at the HBM rate); top "
          f"collectives {plan.top_collectives[:5]}")
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")

    paths = {"median": counts, "maxmarg": mm_counts, "sou": sou_counts,
             "oneway": ow_counts, "gap": gap_counts,
             "smollm_scoring": score_counts, "smollm_serving": smollm_counts,
             "whisper_serving": whisper_counts,
             "card_vs_cpu_f32": f32_counts,
             "rwkv_scoring": rwkv_scoring, "rwkv_serving": rwkv_serving,
             "jamba_scoring": jamba_scoring, "jamba_serving": jamba_serving,
             "unified": unified_counts, "service": service_counts,
             "sharded": sharded_counts, **protocol_counts, **family_counts,
             **train_counts, **mesh_counts}
    print(f"launches per path: {paths}")
    print(f"attention launches per route and path: {route_counts}")
    launches = {n: sum(c[n] for c in paths.values()) for n in counts}
    for route in fa_module.ROUTES:
        launches[f"flash_attention_{route}"] = sum(
            c[route] for c in route_counts.values())
        errs[f"flash_attention_{route}"] = errs[f"attention_{route}"]

    print(json.dumps({"kernels": [
        dict(name=r["name"], route=r["route"], source=r["source"],
             replaces=r["replaces"],
             launches=launches[r.get("wrapper", r["name"])],
             max_abs_err=errs[r.get("wrapper", r["name"])], ms=r["ms"],
             plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"])
        for r in rows + mm_rows + scan_rows + attn_rows + ssm_rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
