#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases:

0. Device and build: print the card's name and power limit, build the
   five Hopper kernels from ``src/repro_torch/kernels/csrc`` and print the
   build time and ``ptxas``'s registers, spills and shared memory (for
   each K5 instance by type and head dim, each K1/K2/K4 instance by
   float4 or scalar copies, each K3 instance by feature-slice width as
   well). Exits non-zero when there is no CUDA device.
1. Each kernel against its plain PyTorch twin on the card. K1–K4 on the
   plan tables of the matrices below: exactly on integer-valued data in
   [-4, 4], within the stated tolerance on random fp32 data; K1 and K2
   also with the plan's real-prefix lengths, bit for bit against the
   lengths they derive, and with non-finite B rows against their twins'
   inf/NaN pattern; K3 with NaN Y rows behind zero bitmaps against its
   twin's pattern; K3 and K4 storing at the plan's canonical positions
   against their staged scores placed by the plain combine, bit for
   bit. K5 (flash attention) on random bf16/fp16 data at
   gemma2-9b's
   global and local layer shapes (8192 tokens, 16/8 heads, head dim 256,
   softcap 50), a ragged length, D=128 GQA 32/8, MQA 48/1, moonshot's
   MHA 16/16 and qwen3-moe's GQA 64/4 at D=128 and 8192 tokens, fp16, a
   query offset, scores near the softcap's saturation, and phase 11's
   shapes: zamba2's D=112 layer (32/32 heads, window 4096, 8192 tokens;
   fp16 with softcap 50 at 2048), whisper's non-causal encoder (8 x 1500
   x 1500) and cross attention (8 x 448 x 1500) at D=64, and qwen2-vl's
   GQA 28/4 D=128 layer.
2. Operators at full size on ``mixed_csr(16384, 16384, seed=3)``:
   ``LibraSpMM`` at n=256 and ``LibraSDDMM`` at kf=128, with the configs
   that put about 90% (SpMM) and all (SDDMM) non-zeros on Tensor Cores.
3. GNN inference on a graph of ogbn-arxiv's size (169,343 nodes,
   2.29M edges, ``power_law_csr(169343, 169343, 13.7, seed=1)``): GCN and
   AGNN ``[128, 256, 256, 40]`` (OGB's GCN baseline width) answer three
   requests each, plus ``LibraSDDMM`` with a config that puts 97.8% of the
   edges on Tensor Cores.

4. The dense transformer's path, gemma2-9b at full width: (b) two layers
   (one local, one global) on 8192 tokens, logits through K5 against the
   same model through K5's plain twin; then all 42 layers with float32
   weights drawn on the card from a seeded generator: (a) three scoring
   requests, ``forward_logits`` on 1 × 8192 tokens each, and (c)
   ``generate(batch=4, prompt_len=16, gen=16)``; (d) the decode-step
   logits at the last prompt position against ``forward_logits`` on the
   same prompt; one more request under ``torch.profiler``.
5. GNN training on the same graph: ``GraphOps`` built again with
   ``ExecSpec(tune="off", reorder="on")`` (host seconds, each leg's Tensor
   Core share before and after), K1–K4 against their twins on the tables
   training adds (A^T, and the reordered A, A^T and SDDMM(A)), then GCN
   and AGNN ``[128, 256, 256, 40]`` from phase 3's weights take three
   full-batch SGD steps each (cross-entropy over 40 seeded labels, lr 0.2)
   on both ``GraphOps``: step ms, losses (the last must be below the
   first), peak memory, and launches by plan leg and width. The first
   step's gradients of every weight and β are held to the same step
   through ``backend="torch"``, and both models' logits through the
   reordered ``GraphOps`` to those through the unreordered one.

6. The tuned path (``tune="model"``, ``tune="search"`` with its
   ``PlanCache``, ``reorder="auto"``) at full size: (a) the analytical
   tuner's picks on the mixed matrix (SpMM n=256, SDDMM kf=128) must be
   phase 2's literal configs, with plans equal key for key and applies
   equal bit for bit, and its Hopper footprint (shared memory a block,
   blocks an SM, L2 slice) is printed; (b) the paper's Fig. 11 on the
   card: the cost model's time against the measured apply time at every
   threshold of both sweeps, on the same plans (built in worker processes
   while (a) runs); (c) ``tune="search"`` on the card into a fresh
   ``PlanCache`` for the mixed SpMM and SDDMM: every candidate's config
   and time, the pick against the plain path, and a second construction that
   hits the cache and times nothing; (d) ``GraphOps(tune="model",
   reorder="auto")``: each leg's decision and config, three GCN and AGNN
   requests against the plain path and two training steps each, timed
   beside phases 3 and 5, and the mixed matrix's ``reorder="auto"``
   decline, taken from the cache the second time without the sketch pass.

7. The serving path (``GNNService`` → ``SparseEngine`` →
   ``GraphRegistry`` → ``BatchedSpMM``/``BatchedSDDMM`` → K1–K4), on
   phase 3's graph and weights: (a) GCN and AGNN registered at the
   registry's default ``tune="model"`` (width buckets up to 256) and the
   mixed matrix with integer values as a raw SpMM/SDDMM tenant, warmed;
   (b) three flushes of 8 GCN and 8 AGNN scoring requests (every third
   with 1,000 node ids): flush ms, ms a request, requests/s beside phase
   3's direct latency, every score against the plain path, one
   profiled flush of each model's eight, then one deterministic flush of
   all sixteen against the registered operators called directly, layer
   by layer, bit for bit; (c) raw SpMM requests
   (widths 24-128, with and without edge values) and SDDMM pairs on the
   tenant against direct calls, bit for bit; (d) one packed apply of p =
   2, 4, 8 panels of width 64 against p single applies, on the graph and
   the mixed matrix, with ``pack_limit``; (e) a seeded fault storm over
   the tenant's fast/single/unsegmented sites, twice, and a plan that
   latches fast and single so the unsegmented rung (K1–K4 over the
   compact tables) serves everything; no request may reach the plain
   path, where the card's ladder does not go; (f) a flush sampled into a
   ``PerfLedger`` and its calibration report (the H100 model's measured
   over predicted); (g) ``/metrics``, ``/health``, ``/memory`` (equal to
   the uploaded tensors' bytes) and ``/stats`` from ``serve_http``;
   (h) the batched form of K1–K4 (``stack_phase``): at panel buckets 1,
   2, 4 and 8 (``STACK_PANELS``, width ``STACK_WIDTH``), on the graph's
   AGNN entry and the mixed tenant, the revalued SpMM stack (AGNN's
   path, per-panel edge values) and the SDDMM stack, each exactly one
   launch a stream a stack, every panel bit for bit against its single
   apply on integer data in [-4, 4] and on random fp32 (SpMM under
   deterministic algorithms; SDDMM within the fp32 tolerance), the
   stack's time against the looped single applies; at 8 panels each
   kernel's batched launch bit for bit against its 8 single launches on
   random fp32, timed beside them and its bound.
   (a)-(d) must serve every request on the fast path.

8. The sharded path and the explainer (``dist/``, ``obs/explain.py``),
   eight window shards on ``cuda:0`` applied as one batch
   (``ShardMesh.round_robin(8)`` on one card: each of K1–K4 launches once
   an apply over the stacked tables): (a) ``DistGraphOps`` on
   phase 3's graph at its default ``tune="model"``, the host seconds of
   its A, A^T and SDDMM(A) partitions, each partition's
   ``explain_partition`` (nnz and segment balance, halo rows and waste)
   and each shard's Tensor Core share; (b) sharded applies bit for bit
   against the single-device operators on integer data (deterministic
   algorithms): the mixed matrix registered with ``mesh=`` beside phase
   7's batched tenant (``ShardedSpMM`` n=256 in both layouts, with
   ``edge_vals`` and on one shard; ``ShardedSDDMM`` kf=128), the graph's
   A with edge values and SDDMM(A); sharded against single apply times,
   the halo gathers and the reassembly timed alone, and one profiled
   sharded apply of each kind by kernel group; the batched applies at P
   = 1, 3 and 8 on the mixed matrix bit for bit against the shards
   applied one by one through ``ops.spmm_apply``/``ops.sddmm_apply``
   (integer data, and random fp32 under deterministic algorithms), one
   launch a stream an apply, and at P = 8 each kernel's batched launch
   timed against its per-shard launches with its bound, and the batched
   apply against the shard loop; (c) GCN and AGNN
   ``[128, 256, 256, 40]`` through ``DistGraphOps``: three requests each
   against ``GraphOps(tune="model")`` and three SGD steps each (falling
   losses, first-step gradients against ``backend="torch"``), launches by
   leg and width (one a stream a sharded apply); (d)
   ``GNNService.register_gcn(mesh=)``: a flush of 8 GCN requests beside
   phase 7's batched one (ms, requests/s), the
   scores bit for bit against the ``ShardedSpMM`` called layer by layer
   and within TF32's tolerance of the batched scores, raw requests on the
   sharded mixed tenant bit for bit against direct calls and the batched
   tenant, ``/memory`` against the shards' uploads; (e) ``explain_spmm``/
   ``explain_sddmm(measure=True)`` of phase 2's operators as tables, and
   ``/explain/<graph>`` over ``serve_http`` against ``explain_entry``
   (a sharded graph answers 400).

9. K5's autograd Function (the kernel's forward with its logsumexp and
   the plain chunked backward) alone at K5's timing shapes (gemma2-9b's
   global and local 8192-token layers, D=128 GQA 32/8 at 4096): dQ, dK,
   dV and the logsumexp against the twin's autograd, the backward's time
   and launches beside K5's forward. Phase 12 trains the dense family
   with the others.

10. The MoE family (``models/moe.py``: router, sort-based dispatch,
    experts, shared experts), moonshot-v1-16b-a3b at full width: (a) two
    layers of moonshot-v1-16b-a3b and of qwen3-moe-235b-a22b on 1 × 8192
    tokens, logits and aux through K5 against the same model through the
    twin, the twin's routing pinned to K5's (the routings a near-tie
    flips are counted and printed with the smallest gap); (b) moonshot's
    layer-0 dispatch matrix D, (e·cap) × t = 61,440 × 8,192 with one 1.0
    a kept assignment, built from the port's own slots: ``LibraSpMM(D)``
    equals the sort-based buffer bit for bit, puts nothing on the Tensor
    Cores (K1, which the apply launches on every call, reads no real
    vector; K2 carries D), and both dispatches are timed; (c) moonshot at
    the largest depth that fits (the arithmetic is printed), float32
    weights drawn on the card: three scoring requests of 1 × 8192 tokens
    (ms, tokens/s, aux, peak memory, one K5 launch per layer), one more
    under ``torch.profiler`` by group (K5, expert products, router,
    dispatch/combine, weight casts, unembed, rest) with the idle share,
    ``generate(batch=4, prompt_len=16, gen=16)``, and decode-step logits
    at the last prompt position against ``forward_logits`` at
    ``capacity_factor = n_experts / top_k`` (capacity = tokens, nothing
    drops), each step's routing pinned to the forward's; (d) K5 at
    moonshot's layer (1 × 8192, 16/16 heads, D = 128) beside its twin and
    SDPA, timed in the timing section.
11. The SSM, hybrid, audio and VLM families (``models/mamba2.py``,
    ``models/hybrid.py``, ``models/whisper.py``, the VLM frontend of
    ``models/transformer.py``) at full width: (a) mamba2-130m,
    zamba2-7b (one group of six Mamba2 layers and the shared block),
    whisper-tiny (two encoder and two decoder layers) and qwen2-vl-7b
    cut to two layers, on 1 × 8192 tokens (whisper 8 × 448 decoder
    tokens over 8 × 1500 frames; qwen2-vl with 1024 seeded patch
    embeddings): logits through K5 against the twin, and K5's launches;
    (b) K5 at zamba2's D = 112 layer, whisper's encoder and cross
    shapes and qwen2-vl's layer beside its twin, SDPA and its bound, in
    the timing section; (c) each model at its published depth unless
    free memory forces a cut (the arithmetic is printed), float32
    weights drawn on the card: three scoring requests (ms, tokens/s,
    peak memory, K5 launches a request: 0, 13, 12 and 28), one more
    under ``torch.profiler`` by group (K5, dense products, the SSD's
    einsums and recurrence, conv, weight casts, unembed, rest) with the
    idle share, ``generate(batch=4, prompt_len=16, gen=16)``; (d)
    decode-step logits at the last prompt position against
    ``forward_logits`` within 5e-2·max|ref|.
12. Training of every family at full width (``launch/train.py`` →
    ``train/train_step.py`` → ``models/api.py`` ``loss_fn`` with remat at
    the reference's scopes → AdamW): (a) gemma2-9b (one local, one
    global layer), moonshot-v1-16b-a3b, qwen3-moe-235b-a22b, mamba2-130m
    and qwen2-vl-7b (1024 seeded patch embeddings) cut to two layers,
    zamba2-7b to one group of six and its tail of three, whisper-tiny
    whole (8 × 448 over 8 × 1500 seeded frames), on 1 × 4096 tokens:
    the training loss against the scoring loss bit for bit, K5's
    launches (2 × layers, 2 × groups, 4 + 16 for whisper, 0), and the
    loss and first-step gradients through K5's Function against plain
    autograd through the twin within 2e-2·max|ref| per tensor (MoE
    routing pinned), a tensor beyond it decided by an fp32 run where
    rounding puts either bf16 gradient beyond 2e-2 of it (K5's within
    2e-2·max|g32| of it or 1.5 times the twin's distance); (b)
    ``train_loop`` for each family but qwen3-moe at the largest depth
    that fits (the arithmetic printed; gemma2 cut by
    local/global pairs, zamba2 by whole groups with its tail kept), 2 ×
    4096 tokens a step in 2 microbatches (whisper 2 × 448 over zero
    frames; qwen2-vl's steps take seeded patch embeddings in place of
    the loop's zeros, which give non-finite gradients at this depth in
    both packages), fp32 AdamW moments, three steps: ms a step, loss,
    ``grad_norm``, ``lr``, TFLOP/s (``model_flops``), peak memory, K5's
    launches a step checked, and one more step of one microbatch under
    ``torch.profiler`` by group (K5, attention backward, the SSD, expert
    products, dispatch/combine, router, optimizer, loss head, dense
    products, rest) with the idle share; (c) checkpoint and resume at a
    reduced width against an uninterrupted run, bit for bit (MoE too:
    the gathers' backward accumulates in a fixed order on the card).
13. GSPMD placement on one card (``dist/sharding.py``,
    ``launch/mesh.py``, the steps on a mesh, ``train/compress.py``,
    ``train/elastic.py``), every mesh position on ``cuda:0``: (a)
    ``param_shardings`` of gemma2-9b, moonshot-v1-16b-a3b,
    qwen3-moe-235b-a22b and zamba2-7b at published shapes (``meta``) on
    ``make_production_mesh()`` and ``multi_pod=True``: leaves sharded and
    replicated, the largest position's parameter bytes against the whole
    model's; (b) moonshot at full width, 2 layers, 2 × 4096 tokens on a
    (2, 4) mesh (gd 2, gm 4, capacity 120): logits and one training
    microbatch's gradients through the expert-parallel exchange against
    the no-mesh functions composed over the 8 groups (routing pinned),
    within 2e-2·max|ref|, a (1, 1) mesh against no mesh bit for bit, the
    request timed both ways; (c) gemma2-9b, 2 layers, 1 × 8192 tokens on
    a (1, 16) mesh: K and V repeated twice, K5 at 16/16 and D=256,
    logits equal to those without a mesh bit for bit, K5 timed at 16/16
    against 16/8; (d) on ``make_mesh_for(1)``, one training step equal
    to ``mesh=None``'s bit for bit, ``generate`` equal to a hand loop
    over ``decode_step``, mamba2-130m's serve step the argmax of its
    logits; (e) the int8 cross-pod mean of (d)'s layer gradients over 4
    members within 2·max|g|/127 of the fp32 mean, ``q·scale + err ==
    g32`` exactly, one leaf on the card equal to the CPU bit for bit,
    timed; (f) (d)'s parameters and AdamW state through ``remesh_live``
    on (1, 1) → (2, 2) → (2, 2, 2) → (1, 1) bit for bit, every block a
    view, and ``degrade_plan``'s three cases. Wall time and peak memory
    printed.
14. The reports (``launch/{hlo_analysis,dryrun,report}.py``): (a) the
    dry run on ``meta`` of gemma2-9b ``train_4k``, qwen3-moe-235b-a22b
    ``train_4k``, zamba2-7b ``long_500k`` and moonshot-v1-16b-a3b
    ``decode_32k`` at published size on the (16, 16) production mesh,
    each in its own ``python -m repro_torch.launch.dryrun`` process
    started in phase 0 (no card; they run beside phases 1-13), each
    ``ok``, with the roofline, dry-run and fused-attention tables and
    each trace's seconds; (b) gemma2-9b (one local and one global layer),
    moonshot-v1-16b-a3b (2 layers) at full width and mamba2-130m whole,
    weights drawn from a seed: a 1 × 4096 training step, a 1 × 8192
    prefill and a decode step over an 8192-slot cache, each the dry run's
    own program on the (16, 16) production mesh, run on the card under
    ``OpCounter`` and traced on ``meta``: flops, bytes and op
    counts equal exactly, K5's counted calls equal to its launches, the
    counted peak within 5% of ``torch.cuda.max_memory_allocated()``
    above the arguments (the largest live storages it never counted
    printed if not); each timed beside its roofline terms. Wall time
    printed.

Phases 2 and 3 are the GNN inference path, phase 5's steps the GNN
training path, phase 6's tuned operators the tuned path, phase 7's served
flushes the serving path, phase 8's sharded applies, requests, steps and
flushes the sharded path, phase 10 (c)'s requests and ``generate`` the
MoE path, phase 11 (c)'s requests and ``generate`` the
SSM/hybrid/audio/VLM path, phase 12 (b)'s loops the training path of
every family, phase 13's requests, microbatch, step and ``generate`` on
their meshes the placement path, phase 14 (b)'s counted steps the
reports' path, and phase 4's (a) and (c) the dense main path:
every kernel's launch counter is set to 0 just before each path and read
just after it; within phase 6, the counts
of each part are read as it ends, and those of the Fig. 11 sweep and of
phase 2's operators, applied only to compare with, are logged apart and
left out of the path's (phases 7 and 8 likewise leave out their direct
calls, plain references and timings). Each of K1–K4 must have launched
on the GNN paths, the tuned path, the serving path and the sharded path,
K1 and K3 on the
reordered A and SDDMM(A) (whose tables must hold real vectors and
columns), K5 exactly 42 times (once
per layer) per scoring request on the dense path, once per layer per
scoring request on the MoE path, 0, 13, 12 and 28 times per scoring
request of mamba2-130m, zamba2-7b, whisper-tiny and qwen2-vl-7b, and on
the training path per microbatch twice a checkpointed scope's attention
(2 × depth for the dense, MoE and VLM families, 2 × groups for zamba2,
4 + 16 for whisper, none for mamba2); K1–K4's launches are
also split by matrix, plan leg and width from the per-step counts. GNN
outputs are checked against the port's plain ``backend="torch"`` path on
the card. Then each kernel is timed (CUDA events, median of 20 launches)
beside its plain twin, one PyTorch library call computing the same
stream's function, and its bound (compulsory bytes over 3.35 TB/s or
operations over the data-sheet peak, whichever is larger; for K1–K4 the
bytes count the real non-zeros' or real vectors' table entries, not the
padding, and once each row of a gathered operand that they name, not the
whole operand). K1 and K3 are timed at the operators of phases 2-3 and
where the training path gives them real work (the reordered A at n=256,
the reordered SDDMM(A) at kf=128); K2 also at n=128 and 40, K4 at kf=256,
K5 at gemma2's local shape and at D=128 GQA 32/8. K1 and K3 also run on
their tables with every column folded into the first 4096 rows of the
gathered operand, where every gather hits L2: the all-L2-hit yardstick.
The reordered SDDMM(A) apply is split into its kernels.
Last, one steady GCN and one AGNN request, one apply of each operator of
phase 2 and of the graph's ``LibraSDDMM``, and one steady GCN and one AGNN
training step on the reordered ``GraphOps`` run under ``torch.profiler``:
device busy time, idle share, device time by group and the kernels that
take the most device time.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises.

fp32 matrix products in the plain versions run in full fp32: this script
sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. Only the two Tensor Core
SpMM/SDDMM kernels use TF32, by design; K5 and the dense model compute
in bf16 with fp32 accumulation, and K5's backward (plain PyTorch) in
full fp32.
"""
from __future__ import annotations

import copy
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: ``bound``'s kinds of operation → ``Hardware.peak_for``'s dtype names.
PEAK_DTYPE = {"tf32": "tf32", "fp32": "float32", "bf16": "bfloat16"}

# Tolerances, each with its reason:
# - integer-valued data in [-4, 4]: every kernel equals its twin exactly
#   (TF32 holds such values exactly and fp32 sums of small integers are
#   exact in any order);
# - CUDA-core kernels (fp32 FMA) on random data: rtol 1e-5 and
#   atol 1e-5·max|ref|, for fp32 sums taken in another order;
# - Tensor Core kernels (TF32, 10 mantissa bits) on random data and any
#   output a TF32 stream feeds: max|Δ| ≤ 2e-2·max|ref|;
# - outputs fed by fp32 streams only: max|Δ| ≤ 1e-4·max|ref|;
# - K5 against its twin, and logits through K5 against logits through the
#   twin: max|Δ| ≤ 2e-2·max|ref| (the repo's low-precision tolerance,
#   tests/test_flash_attention.py), and on every row (the last axis: one
#   query head's output, one token's logits) ‖Δ‖₂ ≤ 2e-2·‖ref‖₂. Both
#   round the same values at the same points and differ in the order of
#   fp32 sums, which moves a bf16/fp16 value by at most an ulp (≤ 2^-7
#   relative) here and there. The per-row test scales with the values
#   compared: late causal rows average thousands of keys and are far
#   smaller than max|ref| (row 0 is v[0] itself), so the max test alone
#   would pass a kernel wrong on most rows;
# - decode-step logits against forward logits, 42 bf16 layers:
#   max|Δ| ≤ 5e-2·max|ref|. The two paths round at different points on
#   every sublayer (K5 rounds p to bf16 per 64-key tile, the decode
#   softmax keeps fp32 p over an fp32 cache; the projections run as
#   (8192, d) against (4, d) products), and those bf16-sized differences
#   add up over 84 residual sublayers. Phase 10 (c) holds the MoE path's
#   decode to its forward by the same bound, with each decode step's
#   expert choice pinned to the forward's: the same rounding differences
#   flip near-tied routings, which move a token by O(1);
# - gradients through K5's autograd Function against plain autograd
#   through the twin (phases 9 and 12 (a)): max|Δ| ≤ 2e-2·max|ref| per
#   tensor. The Function's backward keeps P and dP in fp32 and casts dQ,
#   dK, dV to bf16 once; the twin's autograd rounds P and dP to bf16 per
#   64-key block, and K5's forward rounds as the twin does. Near-uniform
#   attention at random weights (whisper's decoder) makes dP − Δ cancel,
#   and both bf16 gradients of its q and k projections then lie 2-5% of
#   max|g32| from the exact one (fp32 compute through the twin in fp32).
#   The backward's Δ is rowsum(P∘dP) in fp32, as autograd's softmax
#   backward has it: inside its loop where one chunk holds every key
#   (whisper's 448-token decoder), else from a pass over the key chunks
#   ahead of the loop.
#   Phase 12 (a) lets the exact gradient decide a tensor beyond the
#   bound, where rounding puts either bf16 gradient more than
#   2e-2·max|g32| from it: K5's max|Δ| from g32 within 2e-2·max|g32|, or
#   at most 1.5 times the twin's. Measured by tools/grad_spread.py over
#   six seeds of whisper-tiny on an H100: 5 tensors beyond the bound (up
#   to 3.1% of max|ref|; 20, up to 3.3%, with the earlier Δ =
#   rowsum(dO∘O) over the bf16 O), K5's distance to g32 on them 0.62-1.46 times the twin's; in
#   L2, over every tensor, 0.84-1.25 times, and the two at most 1.9%
#   apart;
# - K5's logsumexp against the twin's: 1e-3 absolute (ex2.approx and
#   tanh.approx move it by about 1e-6 relative).
FP32_RTOL = 1e-5
TF32_REL = 2e-2
GRAD_REL = 2e-2
WITNESS_RATIO = 1.5
LSE_ATOL = 1e-3
FP32_PATH_REL = 1e-4
BF16_REL = 2e-2
DECODE_REL = 5e-2

# The literal plans of phases 2-3 (about 90% of the mixed matrix's
# non-zeros on K1, all on K3; 97.8% of the graph's on K3). Phase 6 checks
# that the analytical tuner picks exactly these on the card.
MIX_SPMM_CFG = dict(threshold=6, bk=32, ts_tile=32, ts=4, cs=128)
MIX_SDDMM_CFG = dict(threshold=1, bk=16, ts_tile=32, ts=8, cs=128)
GRAPH_SDDMM_CFG = dict(threshold=8, bk=16, ts_tile=32, ts=2, cs=32)

# Rows of the gathered operand that the all-L2-hit yardstick folds every
# column into.
HOT = 4096

# Clock cycles of the device-side sleep that timed launches queue behind
# (about 50 ms at the H100's 1.98 GHz).
SLEEP_CYCLES = 100_000_000

# The shape of each kernel's entry in the kernels line, the same since the
# kernels were first timed: K1 at the mixed LibraSpMM, K3 at the graph's
# LibraSDDMM, K2 and K4 at a GCN and an AGNN layer, K5 at gemma2-9b's
# global layer. K1 and K3 at the reordered GNN legs are timing lines.
KERNELS_LINE = {
    "spmm_mxu": "mixed LibraSpMM n=256",
    "spmm_vpu": "graph GraphOps A n=256",
    "sddmm_mxu": "graph LibraSDDMM kf=128",
    "sddmm_vpu": "graph GraphOps SDDMM kf=128",
    "flash_attention": "gemma2 global S=8192",
}

KERNEL_INFO = {
    "spmm_mxu": ("src/repro/kernels/spmm_mxu.py:121", "tf32"),
    "spmm_vpu": ("src/repro/kernels/spmm_vpu.py:73", "fp32"),
    "sddmm_mxu": ("src/repro/kernels/sddmm_mxu.py:88", "tf32"),
    "sddmm_vpu": ("src/repro/kernels/sddmm_vpu.py:60", "fp32"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:78", "bf16"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")

    from repro_torch import kernels
    from repro_torch.api import ExecSpec
    from repro_torch.core.sddmm import LibraSDDMM
    from repro_torch.core.spmm import LibraSpMM
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_ref,
        visible_pairs,
    )
    from repro_torch.launch.hlo_analysis import Hardware
    from repro_torch.launch.serve import generate
    from repro_torch.models import api as model_api
    from repro_torch.models.gnn import (
        AGNN,
        GCN,
        GraphOps,
        gcn_norm_edges,
        train_step,
    )
    from repro_torch.sparse import mixed_csr, power_law_csr
    from repro_torch.tune.model import TuneConfig

    # H100 SXM data-sheet peaks (dense), which the dry run's roofline
    # reads too.
    hw = Hardware()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ------------------------------------------------ phase 0: device, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        "allow_tf32 set False for matmul and cudnn (plain versions run "
        "full fp32)")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.last_build_seconds:.1f} s)")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())
    for inst, info in kernel_ptxas(_build.last_build_log).items():
        log(f"  ptxas {inst}: {info}")
    # Phase 14 (a)'s dry runs need no card: they trace on meta in their own
    # processes while the card runs phases 1-13.
    report_cells = start_report_cells()

    # ------------------------------------------------ host: matrices, plans
    def timed(label, fn):
        t = time.perf_counter()
        out = fn()
        log(f"host: {label} {time.perf_counter() - t:.1f} s")
        return out

    a_mix = timed("mixed_csr(16384, 16384, seed=3)",
                  lambda: mixed_csr(16384, 16384, seed=3))
    graph = timed("power_law_csr(169343, 169343, 13.7, seed=1)",
                  lambda: power_law_csr(169343, 169343, 13.7, seed=1))
    log(f"host: mixed nnz={a_mix.nnz}, graph nnz={graph.nnz}")
    spmm_mix = timed("LibraSpMM plan (mixed)", lambda: LibraSpMM(
        a_mix, spec=ExecSpec(tune=TuneConfig(**MIX_SPMM_CFG))))
    sddmm_mix = timed("LibraSDDMM plan (mixed)", lambda: LibraSDDMM(
        a_mix, spec=ExecSpec(tune=TuneConfig(**MIX_SDDMM_CFG))))
    gops = timed("GraphOps plans A, A^T, SDDMM(A) (graph, tune=off)",
                 lambda: GraphOps(graph))
    gops_on = timed("GraphOps plans A, A^T, SDDMM(A) (graph, tune=off, "
                    "reorder=on)",
                    lambda: GraphOps(graph, spec=ExecSpec(tune="off",
                                                          reorder="on")))
    sddmm_graph = timed("LibraSDDMM plan (graph)", lambda: LibraSDDMM(
        graph, spec=ExecSpec(tune=TuneConfig(**GRAPH_SDDMM_CFG))))
    for label, plan in (("LibraSpMM mixed", spmm_mix.plan),
                        ("LibraSDDMM mixed", sddmm_mix.plan),
                        ("GraphOps SpMM", gops.arrs.plan),
                        ("GraphOps SpMM A^T", gops.arrs_t.plan),
                        ("GraphOps SDDMM", gops.arrs_sd.plan),
                        ("GraphOps SpMM reordered", gops_on.arrs.plan),
                        ("GraphOps SpMM A^T reordered", gops_on.arrs_t.plan),
                        ("GraphOps SDDMM reordered", gops_on.arrs_sd.plan),
                        ("LibraSDDMM graph", sddmm_graph.plan)):
        log(f"plan: {label}: tc_nnz={plan.meta['tc_nnz']} "
            f"vpu_nnz={plan.meta['vpu_nnz']} "
            f"tc_ratio={plan.meta['tc_ratio']:.4f}")

    norm = torch.from_numpy(gcn_norm_edges(graph)).to(dev)

    def seeded(seed, *shape, integers=False):
        g = torch.Generator().manual_seed(seed)
        if integers:
            t = torch.randint(-4, 5, shape, generator=g).float()
        else:
            t = torch.randn(*shape, generator=g)
        return t.to(dev)

    # ------------------------------------------------ phase 1: kernel twins
    def compare(label, out, want, kind):
        torch.cuda.synchronize()
        if out.shape != want.shape:
            fail(f"{label}: shape {tuple(out.shape)} != {tuple(want.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail(f"{label}: non-finite output")
        out, want = out.float(), want.float()
        err = (out - want).abs().max().item() if out.numel() else 0.0
        scale = want.abs().max().item() if want.numel() else 0.0
        if kind == "exact":
            ok, tol = err == 0.0, "exact"
        elif kind == "fp32":
            ok = bool(torch.allclose(out, want, rtol=FP32_RTOL,
                                     atol=FP32_RTOL * scale))
            tol = f"rtol={FP32_RTOL:g} atol={FP32_RTOL:g}*max|ref|"
        elif kind == "bf16":
            d_row = torch.linalg.vector_norm(out - want, dim=-1)
            r_row = torch.linalg.vector_norm(want, dim=-1)
            worst = ((d_row / r_row.clamp_min(1e-30)).max().item()
                     if d_row.numel() else 0.0)
            ok = (err <= BF16_REL * scale
                  and bool((d_row <= BF16_REL * r_row).all()))
            tol = (f"{BF16_REL:g}*max|ref| and per row ||d||2<={BF16_REL:g}"
                   f"*||ref||2 (worst row {worst:.3e})")
        else:
            rel = {"tf32": TF32_REL, "fp32_path": FP32_PATH_REL,
                   "decode": DECODE_REL, "grad": GRAD_REL}[kind]
            ok, tol = err <= rel * scale, f"{rel:g}*max|ref|"
        log(f"  {label}: max|err|={err:.3e} max|ref|={scale:.3e} "
            f"tol={tol} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{label}: max|err| {err} outside {tol}")
        return err

    def int_edges(a, seed):
        return seeded(seed, a.nnz, integers=True)

    def element_tables(t):
        """The CUDA-core SDDMM operands the apply launches: the Cs segment
        tables when the plan groups tiles, else the per-tile tables."""
        if "vpu_seg_rows" in t:
            return t["vpu_seg_rows"], t["vpu_seg_cols"]
        return t["vpu_rows"], t["vpu_cols"]

    # Every width the main path gives a kernel (GCN layers aggregate at
    # n=256 and 40, AGNN at 128 and 256; AGNN scores at kf=128 and 256),
    # plus one width off the float4 path (n=37, kf=30) for the scalar code.
    spmm_cases = {   # label → (operator tables, matrix, n)
        "mixed LibraSpMM n=256": (spmm_mix.arrays, a_mix, 256),
        "mixed LibraSpMM n=37": (spmm_mix.arrays, a_mix, 37),
        "graph GraphOps A n=256": (gops.arrs, graph, 256),
        "graph GraphOps A n=128": (gops.arrs, graph, 128),
        "graph GraphOps A n=40": (gops.arrs, graph, 40),
    }
    sddmm_cases = {  # label → (operator tables, matrix, kf)
        "mixed LibraSDDMM kf=128": (sddmm_mix.arrays, a_mix, 128),
        "mixed LibraSDDMM kf=30": (sddmm_mix.arrays, a_mix, 30),
        "graph GraphOps SDDMM kf=128": (gops.arrs_sd, graph, 128),
        "graph GraphOps SDDMM kf=256": (gops.arrs_sd, graph, 256),
        "graph LibraSDDMM kf=128": (sddmm_graph.arrays, graph, 128),
    }
    twin_err: dict[tuple[str, str], float] = {}

    def check_spmm(label, pa, a, n, ev_random):
        """K1 and K2 on the tables of one SpMM plan at width n, against
        their twins: integer data, then ``ev_random`` (the values the
        main path gives this plan) with random B."""
        seg = pa.for_backend("cuda", revalue=True)
        for data in ("integer", "random"):
            if data == "integer":
                ev = int_edges(a, 11)
                b = seeded(12, a.k, n, integers=True)
            else:
                ev = ev_random
                b = seeded(13, a.k, n)
            t = ref.revalue_spmm_arrays(seg, ev)
            nseg = t["tc_seg_rank"].shape[0]
            kind = "exact" if data == "integer" else None
            k1_args = (t["tc_seg_vals"], t["tc_seg_cols"], t["tc_seg_rank"],
                       b)
            k1 = kernels.spmm_mxu(*k1_args, n_active=nseg, unique_ranks=True,
                                  seg_len=t["tc_len"])
            twin_err[("spmm_mxu", label)] = compare(
                f"spmm_mxu {label} {data}", k1,
                ref.spmm_tc_compact_ref(*k1_args, nseg), kind or "tf32")
            # As for K2: the plan's lengths against the derived ones.
            if not torch.equal(kernels.spmm_mxu(
                    *k1_args, n_active=nseg, unique_ranks=True), k1):
                fail(f"spmm_mxu {label} {data}: the plan's lengths and the "
                     "derived ones give different results")
            k2 = kernels.spmm_vpu(t["vpu_seg_vals"], t["vpu_seg_cols"], b)
            twin_err[("spmm_vpu", label)] = compare(
                f"spmm_vpu {label} {data}", k2,
                ref.spmm_tile_partials(t["vpu_seg_vals"],
                                       t["vpu_seg_cols"], b),
                kind or "fp32")
            # The main path passes the plan's lengths; phase 1 lets the
            # wrapper derive them from the values. Both must agree.
            if not torch.equal(kernels.spmm_vpu(
                    t["vpu_seg_vals"], t["vpu_seg_cols"], b,
                    seg_len=t["vpu_len"]), k2):
                fail(f"spmm_vpu {label} {data}: the plan's lengths and the "
                     "derived ones give different results")

    def check_sddmm(label, pa, a, kf):
        """K3 and K4 on the tables of one SDDMM plan at width kf, against
        their twins on integer and random data."""
        t = pa.for_backend("cuda")
        for data in ("integer", "random"):
            integers = data == "integer"
            x = seeded(21, a.m, kf, integers=integers)
            y = seeded(22, a.k, kf, integers=integers)
            kind = "exact" if integers else None
            twin_err[("sddmm_mxu", label)] = compare(
                f"sddmm_mxu {label} {data}",
                kernels.sddmm_mxu(t["tc_seg_cols"], t["tc_seg_bitmap"],
                                  t["tc_seg_window"], x, y),
                ref.sddmm_tc_ref(t["tc_seg_cols"], t["tc_seg_bitmap"],
                                 t["tc_seg_window"], x, y),
                kind or "tf32")
            rows, cols = element_tables(t)
            twin_err[("sddmm_vpu", label)] = compare(
                f"sddmm_vpu {label} {data}", kernels.sddmm_vpu(rows, cols, x, y),
                ref.sddmm_pair_scores(rows, cols, x, y), kind or "fp32")
            # The canonical stores of both kernels are their staged
            # scores placed by the plain combine, bit for bit.
            el = "vpu_seg" if "vpu_seg_rows" in t else "vpu"
            got = torch.empty(a.nnz, device=dev)
            kernels.sddmm_mxu(t["tc_seg_cols"], t["tc_seg_bitmap"],
                              t["tc_seg_window"], x, y,
                              out_pos=t["tc_seg_out_pos"], out=got)
            kernels.sddmm_vpu(rows, cols, x, y, out_pos=t[f"{el}_out_pos"],
                              mask=t[f"{el}_mask"], out=got)
            s_el = torch.where(t[f"{el}_mask"],
                               kernels.sddmm_vpu(rows, cols, x, y), 0.0)
            want = ref.scatter_scores(
                kernels.sddmm_mxu(t["tc_seg_cols"], t["tc_seg_bitmap"],
                                  t["tc_seg_window"], x, y),
                t["tc_seg_out_pos"], s_el, t[f"{el}_out_pos"],
                t[f"{el}_mask"], a.nnz)
            if not torch.equal(got, want):
                fail(f"sddmm {label} {data}: the kernels' canonical stores "
                     "differ from their staged scores placed by the plain "
                     "combine")

    log("phase 1: each kernel against its plain twin on the card")
    for label, (pa, a, n) in spmm_cases.items():
        check_spmm(label, pa, a, n, norm if a is graph
                   else torch.from_numpy(a.data).to(dev))
    # K2 reads only each row's real prefix but adds the padding's
    # 0 * B[0] once to every shorter row, and its twin multiplies every
    # slot: with non-finite B rows and an exact-zero weight both give the
    # same inf/NaN pattern, bit for bit, with derived and plan lengths.
    t = ref.revalue_spmm_arrays(gops.arrs.for_backend("cuda", revalue=True),
                                int_edges(graph, 14))
    vv, vc = t["vpu_seg_vals"].clone(), t["vpu_seg_cols"]
    real = torch.nonzero(vv.flatten()).flatten()
    vv.view(-1)[real[0]] = 0.0
    b = seeded(15, graph.k, 40, integers=True)
    b[0] = float("inf")
    b[vc.flatten()[real[1]], :8] = float("nan")
    want = ref.spmm_tile_partials(vv, vc, b)
    for out in (kernels.spmm_vpu(vv, vc, b),
                kernels.spmm_vpu(vv, vc, b, seg_len=t["vpu_len"])):
        same = (out == want) | (out.isnan() & want.isnan())
        torch.cuda.synchronize()
        if not bool(same.all()) or not bool(want.isnan().any()):
            fail("spmm_vpu with non-finite B rows: kernel and twin differ")
    log(f"  spmm_vpu non-finite B, exact-zero weight: "
        f"{int(want.isnan().sum())} NaN and {int(want.isinf().sum())} inf "
        "entries, identical to the twin")
    # K1 likewise, on the mixed matrix's segments (and the graph's one
    # all-padding segment, which reads only B[0]): an exact-zero weight
    # in a real vector, B[0] infinite and a NaN B row that a real vector
    # names.
    for a, pa, n in ((a_mix, spmm_mix.arrays, 256), (graph, gops.arrs, 40)):
        t = ref.revalue_spmm_arrays(pa.for_backend("cuda", revalue=True),
                                    int_edges(a, 16))
        tv, tcols, trank = (t["tc_seg_vals"].clone(), t["tc_seg_cols"],
                            t["tc_seg_rank"])
        nseg = trank.shape[0]
        real = torch.nonzero(tv.flatten()).flatten()
        b = seeded(17, a.k, n, integers=True)
        b[0] = float("inf")
        if real.numel() > 1:
            tv.view(-1)[real[0]] = 0.0
            w, idx = tv.shape[2], int(real[1])
            b[tcols[idx // (8 * w), idx % w], :8] = float("nan")
        want = ref.spmm_tc_compact_ref(tv, tcols, trank, b, nseg)
        for out in (kernels.spmm_mxu(tv, tcols, trank, b, n_active=nseg,
                                     unique_ranks=True),
                    kernels.spmm_mxu(tv, tcols, trank, b, n_active=nseg,
                                     unique_ranks=True,
                                     seg_len=t["tc_len"])):
            same = (out == want) | (out.isnan() & want.isnan())
            torch.cuda.synchronize()
            if not bool(same.all()) or not bool(want.isnan().any()):
                fail(f"spmm_mxu n={n} with non-finite B rows: kernel and "
                     "twin differ")
        log(f"  spmm_mxu n={n} non-finite B, exact-zero weight "
            f"({nseg} segments): {int(want.isnan().sum())} NaN and "
            f"{int(want.isinf().sum())} inf entries, identical to the twin")
    for label, (pa, a, kf) in sddmm_cases.items():
        check_sddmm(label, pa, a, kf)
    # K3 gathers nothing for a zero-bitmap column and scores it 0, as its
    # twin's where(mask, s, 0) does: NaN Y rows that only zero-bitmap
    # columns name (Y[0], the padding's row, among them) leave the scores
    # finite, and a NaN X row gives the twin's pattern bit for bit.
    for label, (pa, a, kf) in sddmm_cases.items():
        if kf != 128:
            continue
        t = pa.for_backend("cuda")
        tcols, tbits, twnd = (t["tc_seg_cols"], t["tc_seg_bitmap"],
                              t["tc_seg_window"])
        named = torch.zeros(a.k, dtype=torch.bool, device=dev)
        named[tcols[tbits != 0].long()] = True
        x = seeded(23, a.m, kf, integers=True)
        y = seeded(24, a.k, kf, integers=True)
        y[~named] = float("nan")
        got = kernels.sddmm_mxu(tcols, tbits, twnd, x, y)
        want = ref.sddmm_tc_ref(tcols, tbits, twnd, x, y)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not bool(torch.isfinite(got).all()):
            fail(f"sddmm_mxu {label}: NaN Y rows behind zero bitmaps")
        # The row of the first kept score of the table.
        first = int(torch.nonzero(tbits.flatten())[0])
        word = int(tbits.flatten()[first])
        x[8 * int(twnd[first // tbits.shape[1]])
          + (word & -word).bit_length() - 1] = float("nan")
        got = kernels.sddmm_mxu(tcols, tbits, twnd, x, y)
        want = ref.sddmm_tc_ref(tcols, tbits, twnd, x, y)
        same = (got == want) | (got.isnan() & want.isnan())
        torch.cuda.synchronize()
        if not bool(same.all()) or not bool(want.isnan().any()):
            fail(f"sddmm_mxu {label}: NaN X row, kernel and twin differ")
        log(f"  sddmm_mxu {label}: {int((~named).sum())} NaN Y rows behind "
            f"zero bitmaps: finite and equal to the twin; a NaN X row: "
            f"{int(want.isnan().sum())} NaN scores, identical to the twin")
    # Nothing of these checks stays alive into the paths timed below.
    del x, y, got, want, same, named, tv, tcols, trank

    # K5 at every shape the dense path gives it, and the other dense
    # models' widths. Inputs are random normal values rounded to the type.
    def qkv(seed, b, sq, sk, h, kv, d, dtype):
        g = torch.Generator(dev).manual_seed(seed)
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, sq, h, d), (b, sk, kv, d),
                                   (b, sk, kv, d)))

    flash_cases = {  # label → (b, sq, sk, h, kv, d, dtype, kwargs: the
        # kernel's, and q_scale to scale Q)
        "gemma2 global S=8192": (1, 8192, 8192, 16, 8, 256, torch.bfloat16,
                                 dict(causal=True, softcap=50.0)),
        "gemma2 local S=8192 window 4096": (
            1, 8192, 8192, 16, 8, 256, torch.bfloat16,
            dict(causal=True, window=4096, softcap=50.0)),
        "gemma2 ragged S=1000": (1, 1000, 1000, 16, 8, 256, torch.bfloat16,
                                 dict(causal=True, softcap=50.0)),
        "GQA 32/8 D=128 S=4096": (1, 4096, 4096, 32, 8, 128, torch.bfloat16,
                                  dict(causal=True)),
        "MQA 48/1 D=128 S=2048": (1, 2048, 2048, 48, 1, 128, torch.bfloat16,
                                  dict(causal=True)),
        "moonshot MHA 16/16 D=128 S=8192": (
            1, 8192, 8192, 16, 16, 128, torch.bfloat16, dict(causal=True)),
        "qwen3-moe GQA 64/4 D=128 S=8192": (
            1, 8192, 8192, 64, 4, 128, torch.bfloat16, dict(causal=True)),
        "gemma2 fp16 S=2048": (1, 2048, 2048, 16, 8, 256, torch.float16,
                               dict(causal=True, softcap=50.0)),
        "q_offset 3072, Sq=1024 Sk=4096 window 2048": (
            2, 1024, 4096, 16, 8, 256, torch.bfloat16,
            dict(causal=True, window=2048, softcap=50.0, q_offset=3072)),
        # Q x 50: |s / sqrt(D)| reaches 2-4x the cap, so most scores sit
        # near it, where an error e in tanh moves a logit by 50 e.
        "gemma2 near-saturation softcap (Q x 50) S=2048": (
            1, 2048, 2048, 16, 8, 256, torch.bfloat16,
            dict(causal=True, softcap=50.0, q_scale=50.0)),
        # Phase 11's shapes: zamba2's shared attention at head dim 112
        # (the 128-column pitch inside the kernel), whisper's non-causal
        # encoder and cross attention (1500 = 23 x 64 + 28 keys), and
        # qwen2-vl's GQA 28/4 layer.
        "zamba2 D=112 S=8192 window 4096": (
            1, 8192, 8192, 32, 32, 112, torch.bfloat16,
            dict(causal=True, window=4096)),
        "zamba2 D=112 fp16 S=2048 softcap 50": (
            1, 2048, 2048, 32, 32, 112, torch.float16,
            dict(causal=True, softcap=50.0)),
        "whisper encoder 8x1500x1500 D=64": (
            8, 1500, 1500, 6, 6, 64, torch.bfloat16, dict(causal=False)),
        "whisper cross 8x448x1500 D=64": (
            8, 448, 1500, 6, 6, 64, torch.bfloat16, dict(causal=False)),
        "qwen2-vl GQA 28/4 D=128 S=8192": (
            1, 8192, 8192, 28, 4, 128, torch.bfloat16, dict(causal=True)),
    }
    for i, (label, (b, sq, sk, h, kv, d, dtype, kw)) in enumerate(
            flash_cases.items()):
        kw = dict(kw)
        q_scale = kw.pop("q_scale", None)
        q, k, v = qkv(50 + i, b, sq, sk, h, kv, d, dtype)
        if q_scale:
            q = (q.float() * q_scale).to(dtype)
        twin_err[("flash_attention", label)] = compare(
            f"flash_attention {label} {str(dtype)[6:]}",
            kernels.flash_attention_fused(q, k, v, **kw),
            flash_attention_ref(q, k, v, **kw), "bf16")
    del q, k, v

    # ------------------------------------------------ phases 2-3: main path
    def tol_kind(*plans):
        return "tf32" if any(p.meta["tc_nnz"] for p in plans) else "fp32_path"

    gcn = GCN([128, 256, 256, 40],
              generator=torch.Generator().manual_seed(0)).to(dev)
    agnn = AGNN([128, 256, 256, 40],
                generator=torch.Generator().manual_seed(1)).to(dev)
    requests = [seeded(100 + i, graph.m, 128) for i in range(3)]
    b_mix = seeded(31, a_mix.k, 256)
    x_mix, y_mix = seeded(32, a_mix.m, 128), seeded(33, a_mix.k, 128)
    x_graph = seeded(34, graph.m, 128)

    results = {}
    counts_by_step = {}
    latency = {"GCN": [], "AGNN": []}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        def step(label, fn):
            before = kernels.launch_counts()
            results[label] = fn()
            after = kernels.launch_counts()
            counts_by_step[label] = {k: after[k] - before[k] for k in after}

        step("LibraSpMM mixed n=256", lambda: spmm_mix(b_mix))
        step("LibraSDDMM mixed kf=128", lambda: sddmm_mix(x_mix, y_mix))
        for name, model, args in (("GCN", gcn, (norm,)), ("AGNN", agnn, ())):
            for i, x in enumerate(requests):
                def serve(model=model, x=x, args=args, name=name):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = model(gops, x, *args)
                    torch.cuda.synchronize()
                    latency[name].append((time.perf_counter() - t) * 1e3)
                    return out
                step(f"{name} request {i}", serve)
        step("LibraSDDMM graph kf=128", lambda: sddmm_graph(x_graph, x_graph))
    torch.cuda.synchronize()
    main_counts = kernels.launch_counts()
    log(f"phases 2-3 (main path) launches: {main_counts}")
    for label, c in counts_by_step.items():
        log(f"  {label}: {c}")
    missing = [k for k, v in main_counts.items()
               if v <= 0 and k != "flash_attention"]
    if missing:
        fail(f"kernels never launched on the GNN path: {missing}")
    applies = {"LibraSpMM mixed n=256": {"spmm": ["mixed LibraSpMM n=256"],
                                         "sddmm": []},
               "LibraSDDMM mixed kf=128": {
                   "spmm": [], "sddmm": ["mixed LibraSDDMM kf=128"]},
               "LibraSDDMM graph kf=128": {
                   "spmm": [], "sddmm": ["graph LibraSDDMM kf=128"]}}
    for i in range(len(requests)):
        applies[f"GCN request {i}"] = gnn_applies("GCN", gcn.dims)
        applies[f"AGNN request {i}"] = gnn_applies("AGNN", agnn.dims)
    by_shape = launches_by_shape(counts_by_step, applies)
    if any(sum(v.values()) != main_counts[k] for k, v in by_shape.items()):
        fail(f"launches by shape {by_shape} do not add up to {main_counts}")
    log(f"phases 2-3 launches by shape: {by_shape}")
    for name, ms in latency.items():
        log(f"phase 3: {name} [128, 256, 256, 40] per-request latency ms: "
            + ", ".join(f"{v:.2f}" for v in ms))
    log(f"phases 2-3: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("phases 2-3: outputs against the plain backend='torch' path on "
        "the card")
    gops_plain = copy.copy(gops)
    gops_plain.backend = "torch"
    with torch.no_grad():
        compare("LibraSpMM mixed n=256", results["LibraSpMM mixed n=256"],
                spmm_mix(b_mix, backend="torch"), tol_kind(spmm_mix.plan))
        compare("LibraSDDMM mixed kf=128",
                results["LibraSDDMM mixed kf=128"],
                sddmm_mix(x_mix, y_mix, backend="torch"),
                tol_kind(sddmm_mix.plan))
        for i, x in enumerate(requests):
            out = results[f"GCN request {i}"]
            if tuple(out.shape) != (graph.m, 40):
                fail(f"GCN logits shape {tuple(out.shape)}")
            compare(f"GCN request {i} logits", out,
                    gcn(gops_plain, x, norm), tol_kind(gops.arrs.plan))
            out = results[f"AGNN request {i}"]
            if tuple(out.shape) != (graph.m, 40):
                fail(f"AGNN logits shape {tuple(out.shape)}")
            compare(f"AGNN request {i} logits", out, agnn(gops_plain, x),
                    tol_kind(gops.arrs.plan, gops.arrs_sd.plan))
        compare("LibraSDDMM graph kf=128",
                results["LibraSDDMM graph kf=128"],
                sddmm_graph(x_graph, x_graph, backend="torch"),
                tol_kind(sddmm_graph.plan))

    # ------------------------------------------------ phase 4: dense path
    dense_counts = dense_phase(torch, np, dev, log, fail, compare, kernels,
                               model_api, get_config, generate)

    # ------------------------------------------------ phase 5: GNN training
    # The reordered legs, then kernels against their twins on the tables
    # the training path adds (A^T, and the reordered A, A^T and SDDMM(A)).
    legs = {"A": ("arrs", norm), "A^T": ("arrs_t", norm[gops.perm_dev]),
            "SDDMM(A)": ("arrs_sd", None)}
    for leg, (attr, _) in legs.items():
        off, on = getattr(gops, attr).plan, getattr(gops_on, attr).plan
        rep = on.meta["reorder"]
        if not rep["enabled"]:
            fail(f"phase 5: the reordered GraphOps leg {leg} is not reordered")
        log(f"phase 5: leg {leg}: reorder report: projected TC fraction at "
            f"the build's threshold {rep['tc_frac_before']:.4f} -> "
            f"{rep['tc_frac_after']:.4f}, window density "
            f"{rep['window_density_before']:.4f} -> "
            f"{rep['window_density_after']:.4f}; plan TC nnz "
            f"{off.meta['tc_nnz']} -> {on.meta['tc_nnz']} of {graph.nnz} "
            f"(tc_ratio {off.meta['tc_ratio']:.4f} -> "
            f"{on.meta['tc_ratio']:.4f})")
    real_vectors = int(gops_on.arrs.tc_len().sum())
    real_columns = int(torch.count_nonzero(
        gops_on.arrs_sd.for_backend("cuda")["tc_seg_bitmap"]))
    log(f"phase 5: reordered A: {real_vectors} real Tensor Core vectors; "
        f"reordered SDDMM(A): {real_columns} real Tensor Core columns")
    if not real_vectors or not real_columns:
        fail("phase 5: the reordered A or SDDMM(A) plan gives K1 or K3 no "
             "real work")
    log("phase 5: kernels against their twins on the training path's "
        "tables")
    for tag, g in (("", gops), (" reordered", gops_on)):
        for leg, widths in (("A", (256, 128, 40)), ("A^T", (256, 40))):
            if leg == "A" and not tag:
                continue          # phase 1 checked these
            attr, ev = legs[leg]
            for n in widths:
                check_spmm(f"graph GraphOps {leg}{tag} n={n}",
                           getattr(g, attr), graph, n, ev)
    for kf in (128, 256):
        check_sddmm(f"graph GraphOps SDDMM(A) reordered kf={kf}",
                    gops_on.arrs_sd, graph, kf)

    # Three full-batch SGD steps of each model on each GraphOps: the
    # training path. Both models start from phase 3's weights. The labels
    # are a teacher's: the argmax of a GCN of the same widths with seeded
    # weights, through the plain path. Labels drawn independently of the
    # features carry no signal, and at this graph's size their gradients
    # average out so far that GCN's mean loss stays the same fp32 number
    # over three steps at lr 0.2; a teacher's labels can be learned.
    dims = gcn.dims
    x_train = seeded(120, graph.m, dims[0])
    with torch.no_grad():
        teacher = GCN(dims, generator=torch.Generator().manual_seed(121))
        labels = teacher.to(dev)(gops_plain, x_train, norm).argmax(-1)
    del teacher
    log(f"phase 5: labels from a seeded teacher GCN: "
        f"{int(torch.unique(labels).numel())} of {dims[-1]} classes used, "
        f"the largest {int(torch.bincount(labels).max())} of {graph.m} "
        "nodes")
    runs = [(f"{name} reorder {r}", g, model, args, r == "on")
            for r, g in (("off", gops), ("on", gops_on))
            for name, model, args in (("GCN", gcn, (norm,)),
                                      ("AGNN", agnn, ()))]
    train_counts_by_step, train_applies, trained = {}, {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for label, g, model0, args, reordered in runs:
        model = copy.deepcopy(model0)
        losses, ms = [], []
        for i in range(3):
            step_label = f"{label} step {i}"
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = train_step(model, g, x_train, labels, *args, lr=0.2)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            after = kernels.launch_counts()
            train_counts_by_step[step_label] = {
                k: after[k] - before[k] for k in after}
            train_applies[step_label] = gnn_applies(
                label.split()[0], dims, train=True, reordered=reordered)
            losses.append(loss.item())
            if i == 0:
                grads0 = [p.grad.clone() for p in model.parameters()]
        trained[label] = (losses, ms, grads0)
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()
    train_peak = torch.cuda.max_memory_allocated()
    log(f"phase 5 (training path) launches: {train_counts}")
    for label, c in train_counts_by_step.items():
        log(f"  {label}: {c}")
    missing = [k for k, v in train_counts.items()
               if v <= 0 and k != "flash_attention"]
    if missing:
        fail(f"kernels never launched on the training path: {missing}")
    train_by_shape = launches_by_shape(train_counts_by_step, train_applies)
    log(f"phase 5 launches by leg and width: {train_by_shape}")
    for kern, leg in (("spmm_mxu", "graph GraphOps A reordered"),
                      ("sddmm_mxu", "graph GraphOps SDDMM(A) reordered")):
        if not any(k.startswith(leg) for k in train_by_shape[kern]):
            fail(f"phase 5: {kern} never launched on {leg}")
    for label, (losses, ms, _) in trained.items():
        log(f"phase 5: {label} [128, 256, 256, 40] training step ms (host "
            f"clock, first apart): first {ms[0]:.2f}; then "
            + ", ".join(f"{v:.2f}" for v in ms[1:])
            + "; losses " + ", ".join(repr(v) for v in losses))
    log(f"phase 5: peak device memory {train_peak / 2**30:.2f} GiB")
    flat = [label for label, (losses, _, _) in trained.items()
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]]
    if flat:
        fail(f"phase 5: the loss did not fall in {flat}")

    log("phase 5: first-step gradients against the same step through "
        "backend='torch' on the card; logits reordered against unreordered")
    for label, g, model0, args, _ in runs:
        plain = copy.copy(g)
        plain.backend = "torch"
        model = copy.deepcopy(model0)
        train_step(model, plain, x_train, labels, *args, lr=0.2)
        plans = [g.arrs.plan, g.arrs_t.plan]
        if label.startswith("AGNN"):
            plans.append(g.arrs_sd.plan)
        kind = tol_kind(*plans)
        names = [n for n, _ in model0.named_parameters()]
        for name, got, p in zip(names, trained[label][2],
                                model.parameters()):
            compare(f"{label} first-step gradient {name}", got, p.grad, kind)
    with torch.no_grad():
        for name, model, args in (("GCN", gcn, (norm,)), ("AGNN", agnn, ())):
            compare(f"{name} logits, GraphOps reorder on against off",
                    model(gops_on, x_train, *args),
                    model(gops, x_train, *args),
                    tol_kind(gops_on.arrs.plan, gops_on.arrs_sd.plan))

    def median_ms(fn, reps=20):
        """Median device time of ``fn`` over ``reps`` runs, each between two
        CUDA events. The runs are queued behind a device-side sleep of
        about 50 ms, so the card runs them back to back and the events
        time the card, not the host's launch path, which takes longer than
        a short kernel. An event recorded right after the sleep shows
        whether the sleep outlasted the host's enqueue of all the runs; if
        not, the runs are timed again behind a sleep four times as long,
        and if that is outlasted too, a line names the measurement (by
        the line of ``fn`` in this file): its times include the host's
        launch path (a plain twin that waits on the card does)."""
        fn()
        torch.cuda.synchronize()
        for cycles in (SLEEP_CYCLES, 4 * SLEEP_CYCLES):
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
            for s, e in ev:
                s.record()
                fn()
                e.record()
            queued = not slept.query()
            torch.cuda.synchronize()
            if queued:
                break
        else:
            log(f"  (timing at chip_smoke.py:{fn.__code__.co_firstlineno}: "
                f"the host's enqueue of {reps} runs outlasted a sleep of "
                f"{cycles} cycles; these times include the host's launch "
                "path)")
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    def bound(nbytes, ops, kind):
        """The least time the card could take: bytes over HBM's rate or
        operations of ``kind`` over its peak, whichever is longer."""
        t_bytes = nbytes / hw.hbm_bw * 1e3
        t_ops = ops / hw.peak_for(PEAK_DTYPE[kind]) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # ------------------------------------------------ phase 6: tuned path
    tuned_counts = tuned_phase(
        torch, np, log, fail, compare, tol_kind, spec0=ExecSpec(),
        a_mix=a_mix, graph=graph, norm=norm, spmm_mix=spmm_mix,
        sddmm_mix=sddmm_mix, b_mix=b_mix, x_mix=x_mix, y_mix=y_mix, gcn=gcn,
        agnn=agnn, requests=requests, x_train=x_train, labels=labels,
        latency=latency, trained=trained)

    # ------------------------------------------------ phase 7: serving path
    serving_counts, served = serving_phase(
        torch, np, log, fail, compare, dev=dev, graph=graph, a_mix=a_mix,
        norm=norm, gcn=gcn, agnn=agnn, gops_plain=gops_plain,
        latency=latency, median_ms=median_ms, bound=bound)

    # ------------------------------------------------ phase 8: sharded path
    sharded_counts = sharded_phase(
        torch, np, log, fail, compare, dev=dev, graph=graph, norm=norm,
        gcn=gcn, agnn=agnn, requests=requests, x_train=x_train,
        labels=labels, spmm_mix=spmm_mix, sddmm_mix=sddmm_mix,
        served=served, median_ms=median_ms, bound=bound)
    del served

    # ------------------------------------------------ phase 9: K5's Function
    function_phase(torch, dev, log, fail, compare, get_config, median_ms)

    # ------------------------------------------------ phase 10: MoE path
    moe_counts = moe_phase(torch, np, dev, log, fail, compare, kernels,
                           get_config, median_ms)

    # ------------------------------------------------ phase 11: families
    family_counts = families_phase(torch, np, dev, log, fail, compare,
                                   kernels, get_config)

    # ------------------------------------------------ phase 12: training
    training_counts = training_phase(torch, np, dev, log, fail, kernels,
                                     get_config)

    # ------------------------------------------------ phase 13: placement
    placement_counts = placement_phase(torch, np, dev, log, fail, compare,
                                       kernels, get_config, median_ms)

    # ------------------------------------------------ phase 14: reports
    report_counts = reports_phase(torch, np, dev, log, fail, kernels,
                                  get_config, report_cells)

    # ------------------------------------------------ timing and bounds
    coo_rows = {id(a): a.to_coo()[0] for a in (a_mix, graph)}

    def stream_csr(a, pos, vals):
        """CSR tensor of the non-zeros at canonical positions ``pos``."""
        p = np.sort(pos[pos >= 0].astype(np.int64))
        rows = coo_rows[id(a)][p]
        crow = np.zeros(a.m + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=a.m), out=crow[1:])
        v = vals[torch.from_numpy(p).to(dev)]
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow).to(dev),
            torch.from_numpy(a.indices[p].astype(np.int64)).to(dev), v,
            size=(a.m, a.k))

    entries = []

    # The kernels line counts the launches of the GNN paths: inference
    # (phases 2-3), training (phase 5), the tuned path (phase 6), the
    # serving path (phase 7) and the sharded path (phase 8).
    gnn_counts = {k: main_counts[k] + train_counts[k] + tuned_counts[k]
                  + serving_counts[k] + sharded_counts[k]
                  for k in main_counts}
    log(f"kernels line launches by path: inference {main_counts}, "
        f"training {train_counts}, tuned {tuned_counts}, serving "
        f"{serving_counts}, sharded {sharded_counts}; K5: dense "
        f"{dense_counts['flash_attention']}, MoE "
        f"{moe_counts['flash_attention']}, SSM/hybrid/audio/VLM "
        f"{family_counts['flash_attention']}, training "
        + ", ".join(f"{arch} {c['flash_attention']}"
                    for arch, c in training_counts.items())
        + f", placement {placement_counts['flash_attention']}, reports "
        f"{report_counts['flash_attention']}")

    def record(name, label, ms, plain_ms, library_ms, nb, ops):
        """Log one kernel's times and bound; at the kernel's shape in
        KERNELS_LINE, also make it the kernel's entry in the kernels
        line."""
        replaces, kind = KERNEL_INFO[name]
        bound_ms, bound_by = bound(nb, ops, kind)
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        log(f"  {name} [{label}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nb / 1e6:.1f} MB, {ops / 1e9:.2f} G {kind} ops)")
        if KERNELS_LINE[name] != label:
            return
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": (dense_counts[name] + moe_counts[name]
                         + family_counts[name]
                         + sum(c[name] for c in training_counts.values())
                         + placement_counts[name] + report_counts[name]
                         if name == "flash_attention"
                         else gnn_counts[name]),
            "max_abs_err": twin_err[(name, label)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})

    log("timing: kernel and plain twin, CUDA events, median of 20 / 3 runs")

    def yardstick(name, label, fn):
        """The kernel on its own tables with every column folded into the
        first HOT rows of the gathered operand: every gather hits L2."""
        log(f"  {name} [{label}], every gather an L2 hit (columns folded "
            f"into the first {HOT} rows): {median_ms(fn):.4f} ms")

    # K1 at LibraSpMM mixed n=256 (the operator's own values), the kernels
    # line's shape, and where the training path gives it real work: the
    # reordered GraphOps A at a GCN layer (normalized edges, n=256). Both
    # with the plan's lengths, as the main path calls it. Bytes: the real
    # vectors' 8 values and column (36 bytes each), the lengths and ranks,
    # once each B row that a real vector names, and the output; operations
    # 2 x real non-zeros x n.
    b_graph = seeded(36, graph.k, 256)
    for label, pa, a, vals, b in (
            ("mixed LibraSpMM n=256", spmm_mix.arrays, a_mix,
             torch.from_numpy(a_mix.data).to(dev), b_mix),
            ("graph GraphOps A reordered n=256", gops_on.arrs, graph, norm,
             b_graph)):
        t = ref.revalue_spmm_arrays(pa.for_backend("cuda", revalue=True),
                                    vals)
        nseg = t["tc_seg_rank"].shape[0]
        k1 = (t["tc_seg_vals"], t["tc_seg_cols"], t["tc_seg_rank"], b)
        k1_kw = dict(n_active=nseg, unique_ranks=True, seg_len=t["tc_len"])
        k1_out = kernels.spmm_mxu(*k1, **k1_kw)
        vectors = int(t["tc_len"].sum())
        real = (torch.arange(k1[1].shape[1], device=dev)
                < t["tc_len"][:, None])
        b_rows = distinct_rows(torch, k1[1][real])
        b_read = b_rows * b.shape[1] * b.element_size()
        lib_a = stream_csr(a, pa.host["tc_pos"].ravel(), vals)
        k1_bytes = vectors * 36 + b_read + nbytes(t["tc_len"],
                                                  t["tc_seg_rank"], k1_out)
        log(f"  spmm_mxu [{label}] bytes: {vectors} real vectors of "
            f"{k1[1].numel()} slots, naming {b_rows} of B's {b.shape[0]} "
            f"rows: {k1_bytes / 1e6:.1f} MB (B counted whole: "
            f"{(k1_bytes - b_read + nbytes(b)) / 1e6:.1f} MB; the padded "
            f"tables too: {nbytes(*k1, k1_out) / 1e6:.1f} MB)")
        record("spmm_mxu", label,
               median_ms(lambda: kernels.spmm_mxu(*k1, **k1_kw)),
               median_ms(lambda: ref.spmm_tc_compact_ref(*k1, nseg), reps=3),
               median_ms(lambda: torch.sparse.mm(lib_a, b)), k1_bytes,
               2 * int(torch.count_nonzero(t["tc_seg_vals"])) * b.shape[1])
        hot = t["tc_seg_cols"] % HOT
        yardstick("spmm_mxu", label,
                  lambda: kernels.spmm_mxu(t["tc_seg_vals"], hot, *k1[2:],
                                           **k1_kw))
        del k1_out, hot, t, k1, real
    del b_graph
    # K2 at a GCN layer (GraphOps A with normalized edges, n=256) with the
    # plan's lengths, as the main path calls it; also at the other widths
    # the main path gives it (AGNN's first aggregation n=128, GCN's last
    # n=40). Bytes: the real (value, column) pairs, the lengths, once each
    # B row that a row's real prefix names, and the partials; operations
    # 2 x real pairs x n.
    t = ref.revalue_spmm_arrays(gops.arrs.for_backend("cuda", revalue=True),
                                norm)
    real = int(np.count_nonzero(gops.arrs.host["vpu_seg_pos"] >= 0))
    prefix = (torch.arange(t["vpu_seg_cols"].shape[1], device=dev)
              < t["vpu_len"][:, None])
    b_rows = distinct_rows(torch, t["vpu_seg_cols"][prefix])
    del prefix
    lib_a = stream_csr(graph, gops.arrs.host["vpu_pos"].ravel(), norm)
    for n in (256, 128, 40):
        label = f"graph GraphOps A n={n}"
        b_gcn = seeded(41, graph.k, n)
        k2 = (t["vpu_seg_vals"], t["vpu_seg_cols"], b_gcn)
        k2_out = kernels.spmm_vpu(*k2, seg_len=t["vpu_len"])
        k2_ms = median_ms(lambda: kernels.spmm_vpu(*k2,
                                                   seg_len=t["vpu_len"]))
        lib_ms = median_ms(lambda: torch.sparse.mm(lib_a, b_gcn))
        b_read = b_rows * n * b_gcn.element_size()
        k2_bytes = real * 8 + b_read + nbytes(t["vpu_len"], k2_out)
        log(f"  spmm_vpu [{label}] bytes: {real} real pairs naming {b_rows} "
            f"of B's {graph.k} rows: {k2_bytes / 1e6:.1f} MB (B counted "
            f"whole: {(k2_bytes - b_read + nbytes(b_gcn)) / 1e6:.1f} MB)")
        if n == 256:
            record("spmm_vpu", label, k2_ms,
                   median_ms(lambda: ref.spmm_tile_partials(*k2), reps=3),
                   lib_ms, k2_bytes, 2 * real * n)
        else:
            bound_ms, bound_by = bound(k2_bytes, 2 * real * n, "fp32")
            log(f"  spmm_vpu [{label}]: {k2_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}")
    del k2, k2_out, b_gcn, t
    # K3 at LibraSDDMM graph kf=128 (the kernels line's shape), where the
    # training path gives it real work (the reordered GraphOps SDDMM(A) at
    # AGNN's first layer, kf=128) and, as a timing line, on the mixed
    # matrix; K4 at the AGNN first layer (kf=128) and, as a timing line, at
    # its later layers (kf=256). On the graph X and Y are one tensor, as in
    # AGNN. K3's bytes: the real columns' (column, bitmap) pairs, the
    # window ids, once each X row of a window with a real column and each
    # Y row a real column names (a row of the one tensor once), and the
    # scores; K4's: the real (row, column) pairs, once each X and Y row
    # they name, and the real scores.
    x_graph256 = seeded(35, graph.m, 256)
    for name, pa, a, label, xg, yg in (
            ("sddmm_mxu", sddmm_graph.arrays, graph,
             "graph LibraSDDMM kf=128", x_graph, x_graph),
            ("sddmm_mxu", gops_on.arrs_sd, graph,
             "graph GraphOps SDDMM(A) reordered kf=128", x_graph, x_graph),
            ("sddmm_mxu", sddmm_mix.arrays, a_mix, "mixed LibraSDDMM kf=128",
             x_mix, y_mix),
            ("sddmm_vpu", gops.arrs_sd, graph, "graph GraphOps SDDMM kf=128",
             x_graph, x_graph),
            ("sddmm_vpu", gops.arrs_sd, graph, "graph GraphOps SDDMM kf=256",
             x_graph256, x_graph256)):
        t = pa.for_backend("cuda")
        host = pa.host
        kf = xg.shape[1]
        if name == "sddmm_mxu":
            args = (t["tc_seg_cols"], t["tc_seg_bitmap"], t["tc_seg_window"],
                    xg, yg)
            kern, twin = kernels.sddmm_mxu, ref.sddmm_tc_ref
            pos = host["tc_out_pos"].ravel()
            useful = int(np.count_nonzero(pos >= 0))
            real = args[1] != 0
            columns = int(real.sum())
            xr = (args[2][real.any(1)].long()[:, None] * 8
                  + torch.arange(8, device=dev)).reshape(-1)
            xr, yr = xr[xr < xg.shape[0]], args[0][real]
            out = kern(*args)
            table_bytes = columns * 8 + nbytes(args[2], out)
            del out, real
        else:
            args = (*element_tables(t), xg, yg)
            kern, twin = kernels.sddmm_vpu, ref.sddmm_pair_scores
            pos = np.where(host["vpu_mask"], host["vpu_out_pos"], -1).ravel()
            useful = int(host["vpu_mask"].sum())
            mask = t["vpu_seg_mask" if "vpu_seg_rows" in t else "vpu_mask"]
            xr, yr = args[0][mask], args[1][mask]
            table_bytes = useful * 12
            del mask
        if yg is xg:
            xy_rows = distinct_rows(torch, xr, yr)
            what = f"{xy_rows} of X = Y's {xg.shape[0]} rows"
        else:
            xy_rows = distinct_rows(torch, xr) + distinct_rows(torch, yr)
            what = f"{xy_rows} rows of X and Y"
        nb = table_bytes + xy_rows * kf * xg.element_size()
        whole = table_bytes + nbytes(xg) + (nbytes(yg) if yg is not xg else 0)
        log(f"  {name} [{label}] bytes: {useful} real scores, {what}: "
            f"{nb / 1e6:.1f} MB (X and Y counted whole: {whole / 1e6:.1f} MB)")
        del xr, yr
        lib_a = stream_csr(a, pos, torch.ones(a.nnz, device=dev))
        # The yardstick only: the port never calls it.
        library_ms = median_ms(lambda: torch.sparse.sampled_addmm(
            lib_a, xg, yg.t(), beta=0.0))
        ms = median_ms(lambda: kern(*args))
        if label in ("graph GraphOps SDDMM(A) reordered kf=128",
                     "graph LibraSDDMM kf=128",
                     "graph GraphOps SDDMM kf=128"):
            record(name, label, ms, median_ms(lambda: twin(*args), reps=3),
                   library_ms, nb, 2 * useful * kf)
        else:
            bound_ms, bound_by = bound(nb, 2 * useful * kf,
                                       KERNEL_INFO[name][1])
            log(f"  {name} [{label}]: {ms:.4f} ms, library {library_ms:.4f} "
                f"ms, bound {bound_ms:.4f} ms by {bound_by}")
        if name == "sddmm_mxu":
            hot = args[0] % HOT
            yardstick(name, label, lambda: kern(hot, *args[1:]))
            del hot
    del x_graph256

    # The SDDMM apply on the reordered SDDMM(A) at AGNN's first layer
    # (kf=128), split: the X gather into the reordered rows, then both
    # kernels storing at the plan's canonical positions (no combine: the
    # padding slots store nothing).
    log("timing: the SDDMM apply on the reordered SDDMM(A), split into its "
        "kernels")
    t = gops_on.arrs_sd.for_backend("cuda")
    rows, cols = element_tables(t)
    el = "vpu_seg" if "vpu_seg_rows" in t else "vpu"
    scores = torch.empty(graph.nnz, device=dev)
    tc_args = (t["tc_seg_cols"], t["tc_seg_bitmap"], t["tc_seg_window"],
               x_graph, x_graph)
    tc_kw = dict(out_pos=t["tc_seg_out_pos"], out=scores)
    el_kw = dict(out_pos=t[f"{el}_out_pos"], mask=t[f"{el}_mask"],
                 out=scores)
    apply_ms = median_ms(lambda: gops_on._sddmm_apply(x_graph, x_graph))
    k3_ms = median_ms(lambda: kernels.sddmm_mxu(*tc_args, **tc_kw))
    k4_ms = median_ms(lambda: kernels.sddmm_vpu(rows, cols, x_graph,
                                                x_graph, **el_kw))
    slots, live = (gops_on.arrs_sd.plan.meta[k]
                   for k in ("sddmm_slots", "sddmm_live"))
    log(f"  SDDMM(A) reordered kf=128: apply {apply_ms:.4f} ms (X gathered "
        f"into the reordered rows, both kernels); K3 {k3_ms:.4f} ms, K4 "
        f"{k4_ms:.4f} ms ({(k3_ms + k4_ms) / apply_ms:.3f} of the apply) "
        f"over {slots} slots, {slots - live} of them padding")
    del scores, t, rows, cols

    # K5 at gemma2-9b's global layer (the costliest attention call of a
    # scoring request). The library yardstick is one SDPA call; SDPA has
    # no softcap, so K5 is also timed with softcap 0, the same function.
    shape = (1, 8192, 8192, 16, 8, 256)
    q, k, v = qkv(70, *shape, torch.bfloat16)
    kw = dict(causal=True, softcap=50.0)
    k5_out = kernels.flash_attention_fused(q, k, v, **kw)
    k5_ms = median_ms(lambda: kernels.flash_attention_fused(q, k, v, **kw))
    k5_nocap_ms = median_ms(lambda: kernels.flash_attention_fused(
        q, k, v, causal=True))
    plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # The yardstick only: the port never calls it.
    library_ms = median_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    def k5_pairs(b, sq, sk, h, causal=True, window=0, **_):
        """Unmasked (query, key) pairs: the work these inputs need, by the
        formula that K5's wrapper reports to the op counter."""
        return visible_pairs(b, sq, sk, h, causal=causal, window=window)

    b, sq, sk, h, kv, d = shape
    pairs = k5_pairs(b, sq, sk, h, **kw)
    log(f"  flash_attention: softcap 0 (SDPA's function) {k5_nocap_ms:.4f} "
        f"ms; {pairs / (b * h) / 1e6:.2f} M (q, k) pairs per head")
    record("flash_attention", "gemma2 global S=8192", k5_ms, plain_ms,
           library_ms, nbytes(q, k, v, k5_out), 4 * d * pairs)
    del q, k, v, qt, kt, vt, k5_out
    # K5 at gemma2's local layer and at the D = 128 width of the other
    # dense configs (timing lines only; the kernels line keeps the global
    # shape). SDPA has no sliding window without a materialised mask, so
    # the local shape has no library time. Moonshot's layer (the MoE
    # path's, phase 10) is also timed against the twin, and qwen3-moe's
    # (phase 10 (a)'s) beside SDPA.
    for label, shape, kw in (
            ("gemma2 local S=8192 window 4096", (1, 8192, 8192, 16, 8, 256),
             dict(causal=True, window=4096, softcap=50.0)),
            ("GQA 32/8 D=128 S=4096", (1, 4096, 4096, 32, 8, 128),
             dict(causal=True)),
            ("moonshot MHA 16/16 D=128 S=8192", (1, 8192, 8192, 16, 16, 128),
             dict(causal=True)),
            ("qwen3-moe GQA 64/4 D=128 S=8192", (1, 8192, 8192, 64, 4, 128),
             dict(causal=True))):
        b, sq, sk, h, kv, d = shape
        q, k, v = qkv(71, *shape, torch.bfloat16)
        out = kernels.flash_attention_fused(q, k, v, **kw)
        ms = median_ms(lambda: kernels.flash_attention_fused(q, k, v, **kw))
        if label.startswith("moonshot"):
            plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                 reps=3)
            log(f"  flash_attention [{label}] (phase 10 (d)): plain twin "
                f"{plain_ms:.4f} ms")
        lib = "null"
        if not kw.get("window"):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = "{:.4f}".format(median_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)))
            del qt, kt, vt
        pairs = k5_pairs(b, sq, sk, h, **kw)
        bound_ms, bound_by = bound(nbytes(q, k, v, out), 4 * d * pairs,
                                   "bf16")
        log(f"  flash_attention [{label}]: {ms:.4f} ms, library (SDPA) "
            f"{lib} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({pairs / (b * h) / 1e6:.2f} M pairs per head, "
            f"{4 * d * pairs / ms / 1e9:.1f} TFLOP/s)")
        del q, k, v, out
    # Phase 11 (b): K5 at the shapes the SSM/hybrid/audio/VLM families
    # give it, each beside its twin and SDPA. SDPA has no sliding window
    # without a materialised mask, so zamba2's SDPA time is of the full
    # causal attention: not the same function, a yardstick only.
    for label, shape, kw in (
            ("zamba2 D=112 S=8192 window 4096", (1, 8192, 8192, 32, 32, 112),
             dict(causal=True, window=4096)),
            ("whisper encoder 8x1500x1500 D=64", (8, 1500, 1500, 6, 6, 64),
             dict(causal=False)),
            ("whisper cross 8x448x1500 D=64", (8, 448, 1500, 6, 6, 64),
             dict(causal=False)),
            ("qwen2-vl GQA 28/4 D=128 S=8192", (1, 8192, 8192, 28, 4, 128),
             dict(causal=True))):
        b, sq, sk, h, kv, d = shape
        q, k, v = qkv(72, *shape, torch.bfloat16)
        out = kernels.flash_attention_fused(q, k, v, **kw)
        ms = median_ms(lambda: kernels.flash_attention_fused(q, k, v, **kw))
        plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, **kw),
                             reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], enable_gqa=True))
        del qt, kt, vt
        pairs = k5_pairs(b, sq, sk, h, **kw)
        bound_ms, bound_by = bound(nbytes(q, k, v, out), 4 * d * pairs,
                                   "bf16")
        log(f"  flash_attention [{label}] (phase 11 (b)): {ms:.4f} ms, "
            f"plain twin {plain_ms:.4f} ms, library (SDPA"
            + (", no window" if kw.get("window") else "")
            + f") {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({pairs / (b * h) / 1e6:.2f} M pairs per head, "
            f"{4 * d * pairs / ms / 1e9:.1f} TFLOP/s)")
        del q, k, v, out

    # ------------------------------------------------ profile: one request
    # Device time by kernel for one steady request of each model. This is
    # a measurement, not a check: a profiler that records no device time
    # is reported as such.
    log("profile: one steady request per model and one apply per "
        "operator (torch.profiler, device time by kernel)")
    for name, run in (("GCN", lambda: gcn(gops, requests[0], norm)),
                      ("AGNN", lambda: agnn(gops, requests[0]))):
        profile_request(torch, log, name, run, classify_gnn)
    for name, run in (("LibraSpMM mixed n=256", lambda: spmm_mix(b_mix)),
                      ("LibraSDDMM mixed kf=128",
                       lambda: sddmm_mix(x_mix, y_mix)),
                      ("LibraSDDMM graph kf=128",
                       lambda: sddmm_graph(x_graph, x_graph))):
        profile_request(torch, log, name, run)
    log("profile: one steady training step per model, GraphOps reorder on")
    for name, model, args in (("GCN", gcn, (norm,)), ("AGNN", agnn, ())):
        model = copy.deepcopy(model)
        profile_request(
            torch, log, f"{name} training step (reorder on)",
            lambda: train_step(model, gops_on, x_train, labels, *args,
                               lr=0.2),
            classify_gnn, grad=True)

    if sorted(e["name"] for e in entries) != sorted(KERNELS_LINE):
        fail(f"the kernels line holds {[e['name'] for e in entries]}")
    log(f"wall time {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_ptxas(build_log: str) -> dict[str, str]:
    """Registers, spills and shared memory of each K1–K5 instance, from
    the ``ptxas -v`` report. K1's, K3's and K5's shared memory is
    dynamic, so ptxas reports none: K5 takes (128 + 4 · 64) · Dp · 2
    bytes (Dp the row pitch, D rounded up to a multiple of 64) plus 1 KB
    of alignment slack, as ``launch`` in
    ``csrc/flash_attention.cu`` requests; K1 two stages of 32 B rows at a
    pitch of nt + 4 and 8 value rows of 40 (nt = 128 columns at n >= 128);
    K3 two stages a warp of a chunk's Y rows (32, or 16 at kF = 128) and
    8 X rows at a pitch of kF + 16 (16 at kF = 16), 8 rows of earlier
    scores and the chunk's bitmaps and indices. K2 and K4 use only the
    static shared memory ptxas reports."""
    out, inst, spill = {}, None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst, spill = _instance(m.group(1)), ""
        if inst is None:
            continue
        if "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name, dynamic = inst
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = (f"{m.group(1)} registers a thread; {spill}; "
                         f"shared memory {smem.group(1) if smem else 0} "
                         f"bytes static, {dynamic} dynamic")
            inst = None
    return out


def _instance(entry: str):
    """(label, dynamic shared memory bytes) of a K1–K5 entry function's
    mangled name, or None for another kernel."""
    k5 = re.search(r"flash_attention_kernelI(13__nv_bfloat16|6__half)"
                   r"Li(\d+)E", entry)
    if k5:
        d = int(k5.group(2))
        dtype = "bf16" if "bfloat16" in k5.group(1) else "fp16"
        pitch = (d + 63) // 64 * 64
        return f"K5 <{dtype}, D={d}>", (128 + 4 * 64) * pitch * 2 + 1024
    vpu = re.search(r"(spmm|sddmm)_vpu_kernelILi(\d+)E", entry)
    if vpu:
        kind = "float4" if vpu.group(2) == "4" else "scalar"
        return f"{'K2' if vpu.group(1) == 'spmm' else 'K4'} <{kind}>", 0
    # K1's and K3's dynamic shared memory, as the tuner's footprint model
    # reads it from csrc/spmm_mxu.cu and csrc/sddmm_mxu.cu.
    from repro_torch.tune.model import (
        K1_TILE_COLS,
        k1_smem_bytes,
        k3_smem_bytes,
    )

    k1 = re.search(r"spmm_mxu_kernelILb([01])E", entry)
    if k1:
        kind = "float4" if k1.group(1) == "1" else "scalar"
        return f"K1 <{kind}>", k1_smem_bytes(K1_TILE_COLS)
    k3 = re.search(r"sddmm_mxu_kernelILi(\d+)ELb([01])E", entry)
    if k3:
        kf = int(k3.group(1))
        kind = "float4" if k3.group(2) == "1" else "scalar"
        return f"K3 <{kind}, {kf} features>", k3_smem_bytes(kf)
    return None


def gnn_applies(model, dims, *, train=False, reordered=False):
    """The sparse applies of one GNN request or training step, by plan leg
    (A, A^T, SDDMM(A)) and width: a GCN layer aggregates at its output
    width, an AGNN layer scores and aggregates at its input width. A
    training step adds the VJPs' applies: GCN an A^T apply a layer (dB;
    the fixed edge values need no dv); AGNN an SDDMM a layer (dv of the
    attention) and, past the first layer, whose input needs no gradient,
    A^T for dB plus A and A^T for the scores' dX and dY."""
    tag = " reordered" if reordered else ""
    a, at, sd = (f"graph GraphOps {leg}{tag}"
                 for leg in ("A", "A^T", "SDDMM(A)"))
    if model == "GCN":
        spmm = [f"{a} n={d}" for d in dims[1:]]
        sddmm = []
        if train:
            spmm += [f"{at} n={d}" for d in dims[1:]]
    else:
        spmm = [f"{a} n={d}" for d in dims[:-1]]
        sddmm = [f"{sd} kf={d}" for d in dims[:-1]]
        if train:
            sddmm += sddmm
            for d in dims[1:-1]:
                spmm += [f"{at} n={d}", f"{a} n={d}", f"{at} n={d}"]
    return {"spmm": spmm, "sddmm": sddmm}


def launches_by_shape(counts_by_step, applies_by_step):
    """Launches of K1–K4 by matrix, plan leg and width, from the per-step
    counts and each step's applies ({"spmm": [labels], "sddmm": [...]});
    every apply launches both of its operator's kernels once. Fails if a
    step's count differs from its number of applies."""
    widths = {"spmm": {}, "sddmm": {}}
    for step, counts in counts_by_step.items():
        for op, names in applies_by_step[step].items():
            for kern in (f"{op}_mxu", f"{op}_vpu"):
                if counts[kern] != len(names):
                    fail(f"{step}: {counts[kern]} {kern} launches, expected "
                         f"{len(names)} ({names})")
            for label in names:
                widths[op][label] = widths[op].get(label, 0) + 1
    return {f"{op}_{s}": dict(w) for op, w in widths.items()
            for s in ("mxu", "vpu")}


def classify_gnn(key: str) -> str:
    """The group of a kernel of a GNN request or training step."""
    k = key.lower()
    for kern, group in (("spmm_mxu", "K1 spmm_mxu"),
                        ("spmm_vpu", "K2 spmm_vpu"),
                        ("sddmm_mxu", "K3 sddmm_mxu"),
                        ("sddmm_vpu", "K4 sddmm_vpu"),
                        ("indexfunc", "combines (index_add_)"),
                        ("scatter_gather", "scatter_reduce (softmax max)")):
        if kern in k:
            return group
    if any(w in k for w in ("index_elementwise", "indexselect", "gather")):
        return "gathers (revaluation, permutes, softmax)"
    if any(w in k for w in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "dense products (torch.matmul)"
    return "rest (elementwise, reductions, copies)"


def profile_request(torch, log, name, run, classify=None, grad=False):
    """Run ``run()`` twice under ``torch.profiler``, the first as a
    warm-up step, and print the second's device busy time, span, idle
    shares and top kernels; with ``classify`` (kernel name → group) also
    the device time by group. Autograd is off unless ``grad`` (a
    training step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    # The profiler missed the first kernel launched after it started (the
    # operators' first kernel was absent from their profiles), so a first
    # run is a warm-up step whose events are discarded.
    with torch.set_grad_enabled(grad), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Device-side events only (kernels, memcpy, memset): a CPU op's
    # device time repeats that of the kernels it launched, and the step's
    # own device-side range ("ProfilerStep#") spans all of them.
    def on_device(e):
        return (e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep"))

    rows = sorted(((getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
                    e.count, e.key) for e in prof.key_averages()
                   if on_device(e)), reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if on_device(e))
    if not rows or not spans:
        log(f"  {name}: wall {wall_ms:.3f} ms (profiled); the profiler "
            "recorded no device time")
        return
    # Busy time is the union of the device intervals of this one run;
    # the span runs from its first device event's start to its last
    # one's end, so busy / span is the device's share of the request
    # once work has reached it, and busy / wall the share of the whole
    # profiled request, host launch overhead included.
    busy_ms, span_ms = (us / 1e3 for us in busy_and_span(spans))
    log(f"  {name} (one profiled request): wall {wall_ms:.3f} ms, "
        f"device span {span_ms:.3f} ms, device busy {busy_ms:.3f} ms; "
        f"idle share of span {1 - busy_ms / span_ms:.3f}, of wall "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    if classify is not None:
        groups: dict[str, list] = {}
        for ms, count, key in rows:
            g = groups.setdefault(classify(key), [0.0, 0])
            g[0] += ms
            g[1] += count
        total = sum(g[0] for g in groups.values())
        for group, (ms, count) in sorted(groups.items(),
                                         key=lambda kv: -kv[1][0]):
            log(f"    {group}: {ms:.3f} ms over {count} launches "
                f"({ms / total:.3f} of device time)")
    for ms, count, key in rows[:10]:
        log(f"    {ms:9.4f} ms  x{count:<4d} {key[:90]}")


def dense_phase(torch, np, dev, log, fail, compare, kernels, model_api,
                get_config, generate):
    """Phase 4: gemma2-9b's forward and serving path at full width.

    Returns the launch counts of the dense main path ((a) and (c))."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import layers

    cfg = get_config("gemma2-9b")
    seq = 8192

    def tokens(seed, b, s):
        g = torch.Generator(dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)

    # (b) Two layers (one local, one global) at full width: logits through
    # K5 against the same model through K5's plain twin.
    cfg2 = cfg.scaled(n_layers=2)
    model = model_api.init_params(torch.Generator(dev).manual_seed(2), cfg2,
                                  device=dev)
    toks = tokens(200, 1, seq)
    with torch.no_grad():
        out, _ = model_api.forward_logits(model, {"tokens": toks}, cfg2)
        with mock.patch.object(layers, "flash_attention_fused",
                               flash_attention_ref):
            want, _ = model_api.forward_logits(model, {"tokens": toks}, cfg2)
    log("phase 4 (b): gemma2-9b, 2 layers, 1 x 8192 tokens")
    compare("logits through K5 against logits through the twin", out, want,
            "bf16")
    del model, out, want
    torch.cuda.empty_cache()

    t = time.perf_counter()
    model = model_api.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                  device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 4: gemma2-9b, {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"float32 parameters drawn on the card in "
        f"{time.perf_counter() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    # (a) three scoring requests and (c) one generate: the dense main path.
    requests = [tokens(300 + i, 1, seq) for i in range(3)]
    latency, k5_by_step = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with torch.no_grad():
        for i, toks in enumerate(requests):
            before = kernels.launch_counts()["flash_attention"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = model_api.forward_logits(model, {"tokens": toks}, cfg)
            torch.cuda.synchronize()
            latency.append((time.perf_counter() - t) * 1e3)
            k5_by_step[f"request {i}"] = (
                kernels.launch_counts()["flash_attention"] - before)
            if (tuple(logits.shape) != (1, seq, cfg.vocab)
                    or logits.dtype != torch.float32):
                fail(f"scoring logits {tuple(logits.shape)} {logits.dtype}")
            if not bool(torch.isfinite(logits).all()):
                fail(f"request {i}: non-finite logits")
            top = max(logits.max().item(), -logits.min().item())
            if top > cfg.logit_softcap:
                fail(f"request {i}: |logit| {top} above the softcap")
            del logits
        peak = torch.cuda.max_memory_allocated()
        before = kernels.launch_counts()["flash_attention"]
        gen_toks, gen_s = generate(cfg, 4, 16, 16, params=model, device=dev)
        k5_by_step["generate"] = (
            kernels.launch_counts()["flash_attention"] - before)
    torch.cuda.synchronize()
    dense_counts = kernels.launch_counts()
    log(f"phase 4 (main path) launches: {dense_counts}; K5 by step: "
        f"{k5_by_step}")
    for i in range(3):
        if k5_by_step[f"request {i}"] != cfg.n_layers:
            fail(f"K5 launched {k5_by_step[f'request {i}']} times in "
                 f"scoring request {i}, not {cfg.n_layers}")
    log("phase 4 (a): scoring request latency ms (1 x 8192 tokens, first "
        "apart): first " + f"{latency[0]:.2f}; then "
        + ", ".join(f"{v:.2f}" for v in latency[1:]))
    log(f"phase 4 (a): peak device memory {peak / 2**30:.2f} GiB")
    if gen_toks.shape != (4, 16) or gen_toks.min() < 0 \
            or gen_toks.max() >= cfg.vocab:
        fail(f"generate returned {gen_toks.shape} tokens out of range")
    log(f"phase 4 (c): generate(batch=4, prompt_len=16, gen=16): "
        f"{gen_s * 1e3:.1f} ms for 31 decode steps, "
        f"{gen_toks.size / gen_s:.1f} tok/s; sample "
        f"{gen_toks[0][:8].tolist()}")

    # Decode-step logits at the last prompt position against the
    # forward logits of the same prompt (generate's prompt, seed 0).
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32)).to(dev)
    with torch.no_grad():
        fwd, _ = model_api.forward_logits(model, {"tokens": prompt}, cfg)
        cache = model_api.init_cache(cfg, 4, 16, dtype=torch.float32,
                                     device=dev)
        for t in range(16):
            lg, cache = model_api.decode_step(model, cache,
                                              prompt[:, t:t + 1], t + 1, cfg)
    log("phase 4 (d): decode against forward at the last prompt position")
    compare("decode-step logits against forward_logits", lg[:, 0],
            fwd[:, -1], "decode")
    same = (lg[:, 0].argmax(-1) == fwd[:, -1].argmax(-1)).float().mean()
    log(f"  greedy tokens agree in {same.item():.2f} of the 4 rows")

    log("profile: one steady scoring request (torch.profiler)")

    def classify(key):
        k = key.lower()
        if "flash_attention_kernel" in k:
            return "K5 flash_attention"
        if any(w in k for w in ("gemm", "nvjet", "cutlass", "xmma",
                                "cublas")):
            return "dense products (torch.matmul)"
        return "rest (casts, norms, rope, softcap, elementwise)"

    profile_request(torch, log, "gemma2-9b scoring request",
                    lambda: model_api.forward_logits(
                        model, {"tokens": requests[0]}, cfg),
                    classify)
    del model, cache
    torch.cuda.empty_cache()
    return dense_counts


def function_phase(torch, dev, log, fail, compare, get_config, median_ms):
    """Phase 9: K5's autograd Function alone at K5's timing shapes
    (:data:`FUNCTION_CASES`): gradients and logsumexp against the twin's
    autograd, the backward's time and launches beside K5's forward."""
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    cfg = get_config("gemma2-9b")
    log("phase 9: K5's Function: gradients and logsumexp against the "
        f"twin's autograd, backward {cfg.attn_chunk}-key chunks")
    for i, (label, ((b, sq, sk, h, kv, d), kw)) in enumerate(
            FUNCTION_CASES.items()):
        # The twin's autograd keeps, per 64-key block, four fp32 score
        # tensors and the fp32 accumulator; cut heads (not the sequence)
        # if that would not fit in 70% of what is free.
        free = torch.cuda.mem_get_info(dev)[0]
        while (-(-sk // 64) * b * h * sq * (4 * 64 + d) * 4 > 0.7 * free
               and kv > 1):
            h, kv = h // 2, kv // 2
        if (h, kv) != FUNCTION_CASES[label][0][3:5]:
            log(f"  {label}: the twin's autograd does not fit at "
                f"{FUNCTION_CASES[label][0][3]}/{FUNCTION_CASES[label][0][4]}"
                f" heads; compared at {h}/{kv}")
        g = torch.Generator(dev).manual_seed(90 + i)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for shape in ((b, sq, h, d), (b, sk, kv, d),
                                          (b, sk, kv, d)))
        do = torch.randn((b, sq, h, d), generator=g, device=dev).to(
            torch.bfloat16)
        args = (kw["causal"], kw.get("window", 0), kw.get("softcap", 0.0),
                0)
        out, lse = fa._forward(q, k, v, *args, True)
        want_out, want_lse = fa.flash_attention_ref(q, k, v, **kw,
                                                    return_lse=True)
        torch.cuda.synchronize()
        lse_err = (lse - want_lse).abs().max().item()
        log(f"  {label} ({h}/{kv} heads): lse max|err|={lse_err:.3e} "
            f"tol={LSE_ATOL:g} {'ok' if lse_err <= LSE_ATOL else 'MISMATCH'}")
        if not lse_err <= LSE_ATOL:
            fail(f"phase 9: {label}: K5's lse off by {lse_err}")
        compare(f"{label} forward with lse", out, want_out, "bf16")
        del want_out, want_lse
        got, want = [], []
        for fn, acc in ((lambda *t: fa.flash_attention_grad(
                *t, chunk=cfg.attn_chunk, **kw), got),
                        (lambda *t: fa.flash_attention_ref(*t, **kw), want)):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            acc.extend(torch.autograd.grad(fn(*ins), ins, do))
            del ins
        for name, a, w in zip(("dQ", "dK", "dV"), got, want):
            compare(f"{label} {name}", a, w, "grad")
        del got, want
        torch.cuda.empty_cache()
        fwd_ms = median_ms(lambda: fa.flash_attention_fused(q, k, v, **kw))
        fwd_lse_ms = median_ms(lambda: fa._forward(q, k, v, *args, True))
        bwd_ms = median_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, lse, do, chunk=cfg.attn_chunk, **kw), reps=5)
        bwd_launches = device_launches(torch, lambda: fa.flash_attention_bwd_ref(
            q, k, v, lse, do, chunk=cfg.attn_chunk, **kw))
        log(f"  {label}: K5 forward {fwd_ms:.4f} ms ({fwd_lse_ms:.4f} ms "
            f"with lse); backward (plain PyTorch, {cfg.attn_chunk}-key "
            f"chunks) {bwd_ms:.4f} ms over {bwd_launches} launches")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")


#: Phase 9's shapes: K5's timing shapes in the kernels line and its
#: timing lines (label → ((b, sq, sk, h, kv, d), kernel kwargs)).
FUNCTION_CASES = {
    "gemma2 global S=8192": ((1, 8192, 8192, 16, 8, 256),
                             dict(causal=True, softcap=50.0)),
    "gemma2 local S=8192 window 4096": (
        (1, 8192, 8192, 16, 8, 256),
        dict(causal=True, window=4096, softcap=50.0)),
    "GQA 32/8 D=128 S=4096": ((1, 4096, 4096, 32, 8, 128),
                              dict(causal=True)),
}


def device_launches(torch, run) -> int:
    """Kernels (device-side events) that one call of ``run`` launches,
    counted by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


#: CUPTI's own events on the host, which list the kernels of the launch
#: they stalled a second time.
CUPTI_OVERHEAD = ("Command Buffer Full", "Activity Buffer Request")

#: Forward operators of the loss head outside ``layers.unembed``.
LOSS_OPS = ("aten::log_softmax", "aten::_log_softmax", "aten::gather")


def profile_training_step(torch, log, name, run, extra=()):
    """Run ``run()`` (one training step) twice under ``torch.profiler``,
    the first as a warm-up, and print the second's device busy time,
    idle share and device time by group:

    - K5 (forward and recompute): device events named ``flash_attention``;
    - the attention backward: kernels launched under the Function's
      backward node (``FlashAttentionBackward``);
    - the optimizer: kernels under ``apply_updates``, labelled here;
    - the loss head: ``layers.unembed`` (labelled here), log_softmax and
      the gather, and the backward nodes of those forward operators
      (matched by autograd's sequence number);
    - each ``(label, module, function)`` of ``extra`` (phase 12: the SSD,
      expert products, dispatch/combine, the router): kernels under the
      function, forward and recompute, and the backward nodes of its
      forward operators, as for the loss head;
    - dense products: the other GEMM kernels;
    - rest: the other kernels, and any device time no operator claimed.
    """
    import contextlib
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from repro_torch.models import layers
    from repro_torch.train import optimizer as opt

    patches = [("optimizer", opt, "apply_updates"),
               ("loss head", layers, "unembed"), *extra]
    labels = {label for label, _, _ in patches}

    def labelled(label, fn):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    with contextlib.ExitStack() as stack:
        for label, mod, attr in patches:
            stack.enter_context(mock.patch.object(
                mod, attr, labelled(label, getattr(mod, attr))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    t_read = time.perf_counter()
    device, groups, stalls = group_kernel_time(
        prof.profiler.kineto_results.events(), labels, DeviceType)
    if not device:
        log(f"  {name}: wall {wall_ms:.1f} ms (profiled); the profiler "
            "recorded no device time")
        return
    busy_ns, span_ns = busy_and_span(sorted(device))
    device_us = sum(e - s for s, e in device) / 1e3
    claimed = sum(g[0] for g in groups.values())
    rest = groups.setdefault(
        "rest (norms, rope, casts, residuals, elementwise)", [0.0, 0])
    rest[0] += max(0.0, device_us - claimed)
    log(f"  {name} (one profiled step): wall {wall_ms:.1f} ms, device span "
        f"{span_ns / 1e6:.1f} ms, busy {busy_ns / 1e6:.1f} ms; idle share of "
        f"span {1 - busy_ns / span_ns:.3f}, of wall "
        f"{max(0.0, 1 - busy_ns / 1e6 / wall_ms):.3f}; {len(device)} "
        f"kernels, {device_us / 1e3:.1f} ms of kernel time "
        f"({claimed / 1e3:.1f} ms claimed by an operator; {stalls} "
        "launches stalled on a full queue); the trace read and grouped in "
        f"{time.perf_counter() - t_read:.1f} s")
    for group, (us, count) in sorted(groups.items(),
                                     key=lambda kv: -kv[1][0]):
        log(f"    {group}: {us / 1e3:.1f} ms over {count} launches "
            f"({us / device_us:.3f} of kernel time)")


#: ``RecordScope.BACKWARD_FUNCTION``: an autograd node's range.
BACKWARD_SCOPE = 1


def group_kernel_time(raw, labels, DeviceType):
    """Device time and launches by group (see :func:`profile_training_step`)
    from the profiler's raw events ``raw``
    (``prof.profiler.kineto_results.events()``), read directly: building
    ``prof.events()`` costs about 0.6 ms a kernel, 27 s for zamba2's
    step. Returns the (start, end) ns of every kernel, copy and fill
    (user annotations left out), the groups (label → [µs, launches]),
    and the launches that stalled on a full queue.

    A kernel belongs to the CPU operator whose correlation id is its
    linked one (a stalled launch is listed again under CUPTI's overhead
    event: counted once, under the operator); an operator's ancestors
    are the ranges of its thread that enclose it, found as
    ``prof.events()`` finds them, by start and then longest first. Each
    operator gets (the nearest enclosing backward node, the nearest
    label, whether under the Function's backward) from its parent's."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    device, kernels, ops = [], [], {}
    for e in raw:
        kind = e.device_type()
        if kind == cuda:
            if e.is_user_annotation() or e.name().startswith("ProfilerStep"):
                continue
            device.append((e.start_ns(), e.end_ns()))
            kernels.append(e)
        elif (kind == cpu and not e.is_async()
              and e.start_thread_id() == e.end_thread_id()):
            ops.setdefault(e.start_thread_id(), []).append(e)

    info, launcher, stalled, by_seq = {}, {}, set(), {}
    for thread_ops in ops.values():
        thread_ops.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        stack = []
        for e in thread_ops:
            while stack and (e.start_ns() >= stack[-1].end_ns()
                             or e.end_ns() > stack[-1].end_ns()):
                stack.pop()
            up = info[id(stack[-1])] if stack else (None, None, False)
            name = e.name()
            info[id(e)] = mine = (
                e if e.scope() == BACKWARD_SCOPE else up[0],
                name if name in labels
                else "loss head" if name in LOSS_OPS else up[1],
                up[2] or "FlashAttentionBackward" in name)
            stack.append(e)
            if name in CUPTI_OVERHEAD:
                stalled.add(e.correlation_id())
            else:
                launcher[e.correlation_id()] = e
            if e.sequence_nr() >= 0 and mine[0] is None and mine[1]:
                by_seq[(e.sequence_nr(), e.start_thread_id())] = mine[1]

    def group_of(op, kernel):
        root, label, under_fa_backward = info[id(op)]
        if under_fa_backward:
            return "attention backward (plain PyTorch)"
        if label is None and root is not None:
            label = by_seq.get((root.sequence_nr(), root.fwd_thread_id()))
        if label:
            return label
        if any(w in kernel.lower() for w in GEMM_NAMES):
            return "dense products (torch.matmul)"
        return "rest (norms, rope, casts, residuals, elementwise)"

    groups: dict[str, list] = {
        "K5 flash_attention (forward and recompute)": [0.0, 0]}
    stalls = 0
    for k in kernels:
        kernel, us = k.name(), (k.end_ns() - k.start_ns()) / 1e3
        op = launcher.get(k.linked_correlation_id())
        stalls += k.linked_correlation_id() in stalled
        if "flash_attention_kernel" in kernel:
            g = groups["K5 flash_attention (forward and recompute)"]
        elif op is None:
            continue
        else:
            g = groups.setdefault(group_of(op, kernel), [0.0, 0])
        g[0] += us
        g[1] += 1
    return device, groups, stalls


def busy_and_span(spans) -> tuple[float, float]:
    """Busy time (the union of the intervals) and span (first start to
    last end) of sorted (start, end) pairs, in their unit."""
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


#: Phase 10's scoring length: the dense path's (phase 4).
MOE_SEQ = 8192


def routing(torch, moe, pin=None):
    """A patch of ``moe.router_topk`` and the record it fills: each call's
    expert choice (``topi``) and the smallest gap between a token's k-th
    and (k+1)-th router probability (``gap``). With ``pin`` (call index →
    the choice an earlier run made there), every call chooses as pinned,
    its weights renormalised over this call's own probabilities and its
    aux loss counted over the pinned choice, and ``apart`` counts the
    tokens whose own top-k set differs: a near-tie
    that rounding flips moves such a token by O(1), which no tolerance on
    rounding covers, so values are compared with the routing pinned and
    the flips are reported beside them."""
    from unittest import mock

    real = moe.router_topk
    rec = {"topi": [], "apart": 0, "gap": float("inf")}

    def route(logits, k):
        topv, topi, aux = real(logits, k)
        probs = torch.softmax(logits.float(), dim=-1)
        top = probs.topk(k + 1, dim=-1).values
        rec["gap"] = min(rec["gap"],
                         (top[..., k - 1] - top[..., k]).min().item())
        if pin is not None:
            want = pin(len(rec["topi"]))
            rec["apart"] += int((topi.sort(-1).values
                                 != want.sort(-1).values).any(-1).sum())
            picked = probs.gather(-1, want)
            topv = picked / torch.clamp(picked.sum(-1, keepdim=True),
                                        min=1e-9)
            topi = want
            e = logits.shape[-1]
            f_e = torch.bincount(want.reshape(-1), minlength=e).float()
            aux = e * torch.sum(f_e / f_e.sum()
                                * probs.reshape(-1, e).mean(dim=0))
        rec["topi"].append(topi)
        return topv, topi, aux

    return mock.patch.object(moe, "router_topk", route), rec


def moe_phase(torch, np, dev, log, fail, compare, kernels, get_config,
              median_ms):
    """Phase 10: the MoE family's serving path, moonshot-v1-16b-a3b at
    full width.

    (a) two layers of moonshot-v1-16b-a3b and of qwen3-moe-235b-a22b on
    1 × 8192 tokens: logits and aux through K5 against the same model
    through the twin, the twin's routing pinned to K5's; (b) moonshot's
    layer-0 dispatch matrix, built from the port's own slots, through
    ``LibraSpMM``: bit for bit against the sort-based buffer, no non-zero
    on the Tensor Cores (K1 reads no real vector), K2 launched, and the
    two dispatches timed side by side; (c) moonshot at the largest depth
    that fits (the arithmetic is printed): three scoring requests, one
    more profiled by group, ``generate(4, 16, 16)``, and decode against
    forward at ``capacity_factor = n_experts / top_k``.

    Returns the launch counts of the MoE main path ((c)'s requests and
    ``generate``)."""
    from unittest import mock

    from repro_torch.core.spmm import LibraSpMM
    from repro_torch.core.windows import nnz1_fraction
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.launch.serve import generate
    from repro_torch.models import api, layers, moe
    from repro_torch.sparse import coo_to_csr

    t_phase = time.perf_counter()
    seq, gib = MOE_SEQ, 2**30

    def tokens(cfg, seed, b, s):
        g = torch.Generator(dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)

    # (a) Two layers of each MoE config at full width: K5 against the
    # twin. Layer 0's MoE input and parameters of moonshot's forward are
    # kept for (b).
    captured = {}
    real_block = moe.moe_block

    def capture(p, x, cfg):
        captured.setdefault("layer 0", (p["router"], x))
        return real_block(p, x, cfg)

    for seed, name in ((2, "moonshot-v1-16b-a3b"),
                       (3, "qwen3-moe-235b-a22b")):
        cfg2 = get_config(name).scaled(n_layers=2)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        model = api.init_params(torch.Generator(dev).manual_seed(seed), cfg2,
                                device=dev)
        weights = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        toks = tokens(cfg2, 400 + seed, 1, seq)
        with torch.no_grad():
            patch, rec = routing(torch, moe)
            block = capture if name.startswith("moonshot") else real_block
            with patch, mock.patch.object(moe, "moe_block", block):
                out, aux = api.forward_logits(model, {"tokens": toks}, cfg2)
            peak = torch.cuda.max_memory_allocated()
            patch, pinned = routing(torch, moe, pin=rec["topi"].__getitem__)
            with patch, mock.patch.object(layers, "flash_attention_fused",
                                          flash_attention_ref):
                want, want_aux = api.forward_logits(model, {"tokens": toks},
                                                    cfg2)
        log(f"phase 10 (a): {name}, 2 layers, 1 x {seq} tokens, "
            f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
            f"float32 parameters: aux {aux.item()!r} through K5, "
            f"{want_aux.item()!r} through the twin; {pinned['apart']} of "
            f"{2 * seq} (token, layer) routings of the twin's own differ "
            f"from K5's run (pinned to K5's; smallest k-th to (k+1)-th "
            f"router probability gap {rec['gap']:.3e}); peak "
            f"{peak / gib:.2f} GiB, {live / gib:.2f} GiB of it live before")
        compare(f"{name} logits through K5 against the twin", out, want,
                "bf16")
        compare(f"{name} aux through K5 against the twin", aux.reshape(1),
                want_aux.reshape(1), "bf16")
        if name.startswith("moonshot"):
            cfg_m = cfg2
            layer_params = sum(p.numel() for p in model.layers[0].parameters())
            outer_params = model.embedding.numel() + model.final_norm.numel()
            activations = peak - live - weights
            router, x0 = (t.clone() for t in captured.pop("layer 0"))
            x0 = x0.reshape(seq, -1)
        del model, out, want, aux, want_aux, rec, pinned, toks
    torch.cuda.empty_cache()

    # (b) The dispatch matrix D of moonshot's layer 0, (e·cap) × t, one 1.0
    # a kept assignment, from the port's own slots, through LibraSpMM.
    e, k, cd = cfg_m.n_experts, cfg_m.top_k, layers.dtype_of(
        cfg_m, "compute_dtype")
    with torch.no_grad():
        _, topi, _ = moe.router_topk(x0.float() @ router, k)
        cap = moe._capacity(cfg_m, seq, 4)
        buf, slots = moe._local_dispatch(x0, topi, e, k, cap, cd)
    s = slots.reshape(-1).cpu().numpy()
    kept = s < e * cap
    t = time.perf_counter()
    d_mat = coo_to_csr(e * cap, seq, s[kept].astype(np.int32),
                       np.repeat(np.arange(seq, dtype=np.int32), k)[kept],
                       np.ones(int(kept.sum()), np.float32))
    op = LibraSpMM(d_mat)
    host_s = time.perf_counter() - t
    xf = x0.float()
    kernels.reset_launch_counts()
    got = op(xf)
    counts_b = kernels.launch_counts()
    log(f"phase 10 (b): moonshot layer 0's dispatch matrix {d_mat.m} x "
        f"{d_mat.k}, {d_mat.nnz} non-zeros ({int((~kept).sum())} of "
        f"{seq * k} assignments dropped at capacity {cap}), NNZ-1 "
        f"fraction {nnz1_fraction(d_mat):.4f}, tc_ratio {op.tc_ratio!r}; "
        f"COO->CSR and LibraSpMM plan {host_s:.2f} s on the host; "
        f"launches {counts_b} (K1 over {op.arrays.tc_len().numel()} "
        "empty segment)")
    if op.tc_ratio != 0.0:
        fail(f"phase 10 (b): LibraSpMM puts {op.tc_ratio} of the dispatch "
             "on the Tensor Cores")
    # The apply launches both streams on every call, as the reference's
    # does: with no Tensor Core work K1 runs over the plan's one empty
    # segment, whose real-vector count is 0, so it reads nothing.
    tc_vectors = int(op.arrays.tc_len().sum())
    if tc_vectors != 0 or counts_b["spmm_mxu"] > 1 \
            or counts_b["spmm_vpu"] < 1:
        fail(f"phase 10 (b): the dispatch launched {counts_b} with "
             f"{tc_vectors} real Tensor Core vectors")
    compare("LibraSpMM(D)(x) against the sort-based dispatch buffer", got,
            buf.reshape(e * cap, -1), "exact")
    with torch.no_grad():
        libra_ms = median_ms(lambda: op(xf))
        sort_ms = median_ms(lambda: moe._local_dispatch(x0, topi, e, k, cap,
                                                        cd))
    log(f"phase 10 (b): dispatch of {seq} tokens x {x0.shape[1]} (a timing "
        f"line, not the main path): LibraSpMM apply (fp32, K2 and its "
        f"combine) {libra_ms:.4f} ms; sort-based dispatch (bf16) "
        f"{sort_ms:.4f} ms")
    del op, got, buf, slots, xf, x0, router, topi, d_mat

    # (c) Full width at the largest depth that fits, fp32 weights.
    cfg = get_config("moonshot-v1-16b-a3b")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    margin = 0.05 * total
    room = free - margin - activations - 4 * outer_params
    depth = min(cfg.n_layers, max(2, int(room // (4 * layer_params))))
    log(f"phase 10 (c): depth {depth}: free {free / 1e9:.2f} GB of "
        f"{total / 1e9:.2f}, less a {margin / 1e9:.2f} GB margin, less (a)'s "
        f"peak above its weights {activations / 1e9:.2f} GB, less 4 B x "
        f"{outer_params / 1e6:.1f} M embedding and final-norm parameters "
        f"({4 * outer_params / 1e9:.2f} GB), leaves {room / 1e9:.2f} GB = "
        f"{room / (4 * layer_params):.2f} layers of 4 B x "
        f"{layer_params / 1e6:.1f} M ({4 * layer_params / 1e9:.3f} GB); the "
        f"{cfg.n_layers} layers would take "
        f"{4 * (outer_params + cfg.n_layers * layer_params) / 1e9:.1f} GB "
        "of weights alone")
    cfgd = cfg.scaled(n_layers=depth)
    t = time.perf_counter()
    model = api.init_params(torch.Generator(dev).manual_seed(0), cfgd,
                            device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 10 (c): moonshot-v1-16b-a3b, {depth} layers, "
        f"{n_params / 1e9:.3f} B float32 parameters drawn on the card in "
        f"{time.perf_counter() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB allocated")
    requests = [tokens(cfgd, 500 + i, 1, seq) for i in range(3)]
    latency, auxes, k5_by_step = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with torch.no_grad():
        for i, toks in enumerate(requests):
            before = kernels.launch_counts()["flash_attention"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, aux = api.forward_logits(model, {"tokens": toks}, cfgd)
            torch.cuda.synchronize()
            latency.append((time.perf_counter() - t) * 1e3)
            k5_by_step[f"request {i}"] = (
                kernels.launch_counts()["flash_attention"] - before)
            if (tuple(logits.shape) != (1, seq, cfgd.vocab)
                    or logits.dtype != torch.float32):
                fail(f"phase 10 (c): logits {tuple(logits.shape)} "
                     f"{logits.dtype}")
            # NaN propagates through amax/amin; no logits-sized temporary
            # (isfinite allocates one beside its fp32 abs).
            if not bool(torch.isfinite(torch.stack(
                    [logits.amax(), logits.amin()])).all()):
                fail(f"phase 10 (c): request {i}: non-finite logits")
            auxes.append(aux.item())
            del logits
        peak = torch.cuda.max_memory_allocated()
        before = kernels.launch_counts()["flash_attention"]
        gen_toks, gen_s = generate(cfgd, 4, 16, 16, params=model, device=dev)
        k5_by_step["generate"] = (
            kernels.launch_counts()["flash_attention"] - before)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"phase 10 (main path) launches: {counts}; K5 by step: "
        f"{k5_by_step}")
    for i in range(3):
        if k5_by_step[f"request {i}"] != depth:
            fail(f"phase 10 (c): K5 launched {k5_by_step[f'request {i}']} "
                 f"times in scoring request {i}, not {depth}")
    if not all(0.9 < a < 4.0 for a in auxes):
        fail(f"phase 10 (c): aux {auxes} outside (0.9, 4.0)")
    log("phase 10 (c): scoring request latency ms (1 x 8192 tokens, first "
        f"apart): first {latency[0]:.2f}; then "
        + ", ".join(f"{v:.2f}" for v in latency[1:])
        + "; tokens/s " + ", ".join(f"{seq / v * 1e3:.0f}" for v in latency)
        + f"; aux {auxes}; peak device memory {peak / gib:.2f} GiB")
    if gen_toks.shape != (4, 16) or gen_toks.min() < 0 \
            or gen_toks.max() >= cfgd.vocab:
        fail(f"phase 10 (c): generate returned {gen_toks.shape} tokens out "
             "of range")
    log(f"phase 10 (c): generate(batch=4, prompt_len=16, gen=16): "
        f"{gen_s * 1e3:.1f} ms for 31 decode steps, "
        f"{gen_toks.size / gen_s:.1f} tok/s; sample "
        f"{gen_toks[0][:8].tolist()}")

    log("profile: one steady moonshot scoring request (torch.profiler)")
    profile_moe_request(torch, log, f"moonshot-v1-16b-a3b ({depth} layers) "
                        "scoring request",
                        lambda: api.forward_logits(
                            model, {"tokens": requests[0]}, cfgd), model)

    # Decode-step logits at the last prompt position against the
    # forward logits of the same prompt (generate's, seed 0), where the
    # capacity reaches the tokens of either call (cap = t) and nothing
    # drops; each decode step's routing is pinned to the forward's at its
    # position.
    nodrop = cfgd.scaled(capacity_factor=cfgd.n_experts / cfgd.top_k)
    b, plen = 4, 16
    if any(moe._capacity(nodrop, n, 4) != n for n in (b, b * plen)):
        fail("phase 10 (c): the capacity does not reach the tokens")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfgd.vocab, (b, plen)).astype(np.int32)).to(dev)
    model.cfg = nodrop
    with torch.no_grad():
        patch, fwd_rec = routing(torch, moe)
        with patch:
            fwd, _ = api.forward_logits(model, {"tokens": prompt}, nodrop)
        cache = api.init_cache(nodrop, b, plen, dtype=torch.float32,
                               device=dev)
        patch, dec = routing(torch, moe, pin=lambda i: fwd_rec["topi"][
            i % depth][:, i // depth:i // depth + 1])
        with patch:
            for t in range(plen):
                lg, cache = api.decode_step(model, cache,
                                            prompt[:, t:t + 1], t + 1, nodrop)
    model.cfg = cfgd
    log(f"phase 10 (c): decode against forward at the last prompt position "
        f"(capacity_factor {nodrop.capacity_factor:.4f}: cap = t); "
        f"{dec['apart']} of {b * plen * depth} (token, layer) routings of "
        f"the decode's own differ from the forward's (pinned to the "
        f"forward's; smallest gap {min(fwd_rec['gap'], dec['gap']):.3e})")
    compare("decode-step logits against forward_logits", lg[:, 0],
            fwd[:, -1], "decode")
    del model, cache, fwd, lg, requests
    torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s; main path (c) "
        f"launches {counts}")
    return counts


#: Phase 11's families: arch → (scoring batch, tokens a row, (a)'s cut
#: to two layers at full width). whisper scores 448 decoder tokens, its
#: published text context (arXiv:2212.04356), over 1500 frames; zamba2's
#: two layers are one group of six and the shared block, its smallest
#: cut that keeps an attention.
FAMILIES = {
    "mamba2-130m": (1, 8192, dict(n_layers=2)),
    "zamba2-7b": (1, 8192, dict(n_layers=6)),
    "whisper-tiny": (8, 448, dict(n_layers=2, n_enc_layers=2)),
    "qwen2-vl-7b": (1, 8192, dict(n_layers=2)),
}


def k5_per_request(cfg) -> int:
    """K5 launches of one scoring request of ``cfg``: none in Mamba2, one
    a shared-attention application in the hybrid, whisper's encoder
    layers and two a decoder layer (self and cross), one a layer
    otherwise."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "audio":
        return (cfg.n_enc_layers or cfg.n_layers) + 2 * cfg.n_layers
    return cfg.n_layers


def family_batch(torch, dev, cfg, seed, b, s):
    """A seeded scoring batch: tokens, and whisper's frame embeddings or
    qwen2-vl's ``n_patches`` patch embeddings."""
    g = torch.Generator(dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device=dev)}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn(
            (b, cfg.n_audio_ctx, cfg.d_model), generator=g, device=dev)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.n_patches, cfg.d_model), generator=g, device=dev)
    return batch


def families_phase(torch, np, dev, log, fail, compare, kernels, get_config):
    """Phase 11: the SSM, hybrid, audio and VLM families' serving path,
    each at full width.

    (a) each family cut to two layers (:data:`FAMILIES`): logits through
    K5 against the same model through the twin, and K5's launches; (c)
    each at its published depth unless free memory forces a cut (the
    arithmetic is printed): three scoring requests (ms, tokens/s, peak
    memory, K5 launches a request: 0, 13, 12 and 28), one more profiled
    by group with its idle share, ``generate(4, 16, 16)``; (d) decode-step
    logits at the last prompt position against ``forward_logits`` of the
    same prompt (whisper over zero frames, as ``generate`` encodes).
    K5 at these families' shapes is timed in the timing section ((b)).

    Returns the launch counts of the families' main path ((c)'s requests
    and ``generate``, all four families)."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.launch.serve import generate
    from repro_torch.models import api, layers

    t_phase = time.perf_counter()
    gib = 2**30

    def meta_params(cfg) -> int:
        return sum(p.numel() for p in api.init_params(
            None, cfg, device="meta").parameters())

    activations = {}
    for seed, (name, (b, s, cut)) in enumerate(FAMILIES.items()):
        cfg2 = get_config(name).scaled(**cut)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        model = api.init_params(torch.Generator(dev).manual_seed(seed),
                                cfg2, device=dev)
        weights = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        batch = family_batch(torch, dev, cfg2, 600 + seed, b, s)
        with torch.no_grad():
            kernels.reset_launch_counts()
            out, _ = api.forward_logits(model, batch, cfg2)
            k5 = kernels.launch_counts()["flash_attention"]
            peak = torch.cuda.max_memory_allocated()
            with mock.patch.object(layers, "flash_attention_fused",
                                   flash_attention_ref):
                want, _ = api.forward_logits(model, batch, cfg2)
        activations[name] = peak - live - weights
        log(f"phase 11 (a): {name}, {cfg2.n_layers} layers at full width, "
            f"{b} x {s} tokens, {weights / 4e9:.3f} B float32 parameters: "
            f"{k5} K5 launches; peak {peak / gib:.2f} GiB, "
            f"{activations[name] / 1e9:.2f} GB of it above the weights")
        if k5 != k5_per_request(cfg2):
            fail(f"phase 11 (a): {name}: K5 launched {k5} times, not "
                 f"{k5_per_request(cfg2)}")
        compare(f"{name} logits through K5 against the twin", out, want,
                "bf16")
        del model, out, want, batch

    counts = {}
    kernels.reset_launch_counts()
    for seed, (name, (b, s, _)) in enumerate(FAMILIES.items()):
        t_family = time.perf_counter()
        cfg = get_config(name)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        margin = 0.05 * total
        room = free - margin - activations[name]
        n_params = meta_params(cfg)
        depth = cfg.n_layers
        while depth > 1 and 4 * meta_params(cfg.scaled(n_layers=depth)) \
                > room:
            depth -= 1
        log(f"phase 11 (c): {name}: {n_params / 1e9:.3f} B parameters at "
            f"{cfg.n_layers} layers, {4 * n_params / 1e9:.2f} GB in float32; "
            f"free {free / 1e9:.2f} GB of {total / 1e9:.2f}, less a "
            f"{margin / 1e9:.2f} GB margin, less (a)'s activations "
            f"{activations[name] / 1e9:.2f} GB, leaves {room / 1e9:.2f} GB: "
            f"depth {depth} of {cfg.n_layers}"
            + ("" if depth == cfg.n_layers else " (cut to fit)"))
        cfgd = cfg.scaled(n_layers=depth)
        t = time.perf_counter()
        model = api.init_params(torch.Generator(dev).manual_seed(0), cfgd,
                                device=dev)
        torch.cuda.synchronize()
        log(f"phase 11 (c): {name}: weights drawn on the card in "
            f"{time.perf_counter() - t:.1f} s; "
            f"{torch.cuda.memory_allocated() / gib:.2f} GiB allocated")
        requests = [family_batch(torch, dev, cfgd, 700 + 10 * seed + i, b, s)
                    for i in range(3)]
        latency, k5_by_step = [], {}
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for i, batch in enumerate(requests):
                k5_0 = kernels.launch_counts()["flash_attention"]
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, _ = api.forward_logits(model, batch, cfgd)
                torch.cuda.synchronize()
                latency.append((time.perf_counter() - t) * 1e3)
                k5_by_step[f"request {i}"] = (
                    kernels.launch_counts()["flash_attention"] - k5_0)
                if (tuple(logits.shape) != (b, s, cfgd.vocab)
                        or logits.dtype != torch.float32):
                    fail(f"phase 11 (c): {name}: logits "
                         f"{tuple(logits.shape)} {logits.dtype}")
                if not bool(torch.isfinite(torch.stack(
                        [logits.amax(), logits.amin()])).all()):
                    fail(f"phase 11 (c): {name}: request {i}: non-finite "
                         "logits")
                del logits
            peak = torch.cuda.max_memory_allocated()
            k5_0 = kernels.launch_counts()["flash_attention"]
            gen_toks, gen_s = generate(cfgd, 4, 16, 16, params=model,
                                       device=dev)
            k5_by_step["generate"] = (
                kernels.launch_counts()["flash_attention"] - k5_0)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        counts[name] = {k: after[k] - before[k] for k in after}
        want = k5_per_request(cfgd)
        log(f"phase 11 (c): {name}: launches {counts[name]}; K5 by step: "
            f"{k5_by_step}")
        for i in range(3):
            if k5_by_step[f"request {i}"] != want:
                fail(f"phase 11 (c): {name}: K5 launched "
                     f"{k5_by_step[f'request {i}']} times in scoring "
                     f"request {i}, not {want}")
        log(f"phase 11 (c): {name} scoring request latency ms ({b} x {s} "
            f"tokens, first apart): first {latency[0]:.2f}; then "
            + ", ".join(f"{v:.2f}" for v in latency[1:])
            + "; tokens/s "
            + ", ".join(f"{b * s / v * 1e3:.0f}" for v in latency)
            + f"; peak device memory {peak / gib:.2f} GiB")
        if gen_toks.shape != (4, 16) or gen_toks.min() < 0 \
                or gen_toks.max() >= cfgd.vocab:
            fail(f"phase 11 (c): {name}: generate returned "
                 f"{gen_toks.shape} tokens out of range")
        log(f"phase 11 (c): {name}: generate(batch=4, prompt_len=16, "
            f"gen=16): {gen_s * 1e3:.1f} ms for 31 decode steps, "
            f"{gen_toks.size / gen_s:.1f} tok/s; sample "
            f"{gen_toks[0][:8].tolist()}")
        profile_labelled_request(
            torch, log, f"{name} ({depth} layers) scoring request",
            lambda: api.forward_logits(model, requests[0], cfgd), model,
            FAMILY_LABELS, classify_family)

        # (d) Decode-step logits at the last prompt position against the
        # forward logits of generate's prompt (seed 0).
        pb, plen = 4, 16
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfgd.vocab, (pb, plen)).astype(np.int32)).to(dev)
        fbatch = {"tokens": prompt}
        with torch.no_grad():
            cache = api.init_cache(cfgd, pb, plen, dtype=torch.float32,
                                   device=dev)
            if cfgd.family == "audio":
                frames = torch.zeros((pb, cfgd.n_audio_ctx, cfgd.d_model),
                                     device=dev)
                fbatch["frame_embeds"] = frames
                xk, xv = model.enc_kv(model.encode(frames))
                cache["xk"], cache["xv"] = xk.float(), xv.float()
            fwd, _ = api.forward_logits(model, fbatch, cfgd)
            for t in range(plen):
                lg, cache = api.decode_step(model, cache,
                                            prompt[:, t:t + 1], t + 1, cfgd)
        compare(f"{name} decode-step logits against forward_logits",
                lg[:, 0], fwd[:, -1], "decode")
        del model, cache, fwd, lg, requests
        torch.cuda.empty_cache()
        log(f"phase 11: {name}: {time.perf_counter() - t_family:.1f} s")
    total_counts = {k: sum(c[k] for c in counts.values())
                    for k in next(iter(counts.values()))}
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s; main path (c) "
        f"launches {total_counts}")
    return total_counts


#: Phase 12's families: (a)'s cut (the smallest depth that holds the
#: family's structure at full width: gemma2's one local and one global
#: layer, zamba2's one group of six and its tail of three), (a)'s batch
#: (b, s), and (b)'s global batch and sequence (None: (a) only), 4096
#: tokens a row as ``train_4k`` (``models/config.py``).
TRAIN_FAMILIES = {
    "gemma2-9b": (dict(n_layers=2), (1, 4096), (2, 4096)),
    "moonshot-v1-16b-a3b": (dict(n_layers=2), (1, 4096), (2, 4096)),
    "qwen3-moe-235b-a22b": (dict(n_layers=2), (1, 4096), None),
    "mamba2-130m": (dict(n_layers=2), (1, 4096), (2, 4096)),
    "zamba2-7b": (dict(n_layers=9), (1, 4096), (2, 4096)),
    "whisper-tiny": ({}, (8, 448), (2, 448)),
    "qwen2-vl-7b": (dict(n_layers=2), (1, 4096), (2, 4096)),
}

#: Phase 12 (c)'s configs: each family's structure (MoE routing and
#: shared expert, the SSD, the hybrid's group and tail, GQA, M-RoPE, the
#: stub frontends) at a width whose checkpoints take seconds to write;
#: whisper-tiny whole. K5's head dims stay its own (128, zamba2's 112).
RESUME_CUTS = {
    "gemma2-9b": dict(n_layers=2, d_model=512, n_heads=4, n_kv=2,
                      d_head=128, d_ff=1024, vocab=4096),
    "moonshot-v1-16b-a3b": dict(n_layers=2, d_model=512, n_heads=4, n_kv=4,
                                d_head=128, d_ff=256, moe_d_ff=256,
                                n_experts=8, top_k=2, vocab=4096),
    "mamba2-130m": dict(n_layers=2, d_model=512, vocab=4096),
    "zamba2-7b": dict(n_layers=9, d_model=512, n_heads=4, n_kv=4,
                      d_head=112, d_ff=1024, vocab=4096),
    "whisper-tiny": {},
    "qwen2-vl-7b": dict(n_layers=2, d_model=512, n_heads=8, n_kv=2,
                        d_head=128, d_ff=1024, vocab=4096, n_patches=64),
}


def k5_per_pass(cfg) -> int:
    """K5 launches of one loss and backward (one microbatch) under remat:
    every checkpointed scope runs its attention twice (forward and
    recompute): a layer of the dense, MoE and VLM models, a group of the hybrid
    (its tail has none), a decoder layer of whisper (self and cross
    attention), whose encoder runs once; Mamba2 has none."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return 2 * (cfg.n_layers // cfg.hybrid_attn_every)
    if cfg.family == "audio":
        return (cfg.n_enc_layers or cfg.n_layers) + 4 * cfg.n_layers
    return 2 * cfg.n_layers


def max_abs(torch, x, y=None) -> float:
    """max|x - y| (or max|x|) in fp32, 2^26 elements at a time, so that no
    temporary of a whole expert tensor is made (qwen3-moe's weights and
    three gradient sets leave a few GB of the card); inf where a value is
    not finite."""
    x = x.reshape(-1)
    y = None if y is None else y.reshape(-1)
    out = 0.0
    for i in range(0, x.numel(), 1 << 26):
        d = x[i:i + (1 << 26)].float()
        if y is not None:
            d = d - y[i:i + (1 << 26)].float()
        lo, hi = (v.item() for v in torch.aminmax(d))
        if not (abs(lo) < float("inf") and abs(hi) < float("inf")):
            return float("inf")
        out = max(out, -lo, hi)
    return out


def training_phase(torch, np, dev, log, fail, kernels, get_config):
    """Phase 12: training of every family at full width.

    (a) each family at the smallest depth that holds its structure
    (:data:`TRAIN_FAMILIES`), 1 × 4096 tokens (whisper 8 × 448 over 8 ×
    1500 seeded frames, qwen2-vl with 1024 seeded patch embeddings): the
    training loss (K5 in the Function, remat) against the scoring loss
    under ``no_grad`` bit for bit, K5's launches against
    :func:`k5_per_pass`, and the loss and first-step gradients against
    the same model through plain autograd over the twin (MoE routing
    pinned to the first run's), a gradient beyond the bound held to an
    fp32 run through the twin in fp32 (:data:`WITNESS_RATIO`); (b)
    ``launch/train.py`` ``train_loop`` at the largest depth that fits
    (the arithmetic printed: 16 B a parameter and (a)'s peak above its
    weights), 2 × 4096 tokens a step
    in 2 microbatches (whisper 2 × 448 over zero frames; qwen2-vl with
    seeded patch embeddings in place of the loop's zeros), three steps
    with K5's launches checked, and one more step of one microbatch
    profiled by group; (c) checkpoint and resume at :data:`RESUME_CUTS`,
    bit for bit against an uninterrupted run.

    Returns each family's launch counts on the training path, (b)'s
    loops."""
    import tempfile
    from unittest import mock

    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import flops
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.hlo_analysis import Hardware
    from repro_torch.models import api, layers, mamba2, moe
    from repro_torch.models.config import InputShape
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    gib = 2**30
    bf16_peak = Hardware().peak_for("bfloat16")

    def twin_grad(q, k, v, *, causal, window, softcap, q_offset, chunk):
        """Plain autograd through K5's twin, 1024 query rows at a time,
        each slice under ``torch.utils.checkpoint``: attention rows are
        independent, and a slice's twin skips only key blocks masked for
        all its rows, which changes no value. The slices hold the twin's
        per-block fp32 scores to one slice's at a time (qwen3-moe's 64
        heads would otherwise keep about 26 GB a layer)."""
        del chunk
        return torch.cat([checkpoint(
            fa.flash_attention_ref, q[:, r:r + 1024], k, v, causal=causal,
            window=window, softcap=softcap, q_offset=q_offset + r,
            use_reentrant=False) for r in range(0, q.shape[1], 1024)], dim=1)

    def training_batch(cfg, seed, b, s):
        batch = family_batch(torch, dev, cfg, seed, b, s)
        labels = torch.roll(batch["tokens"], -1, 1)
        labels[:, -1] = -1
        batch["labels"] = labels
        return batch

    def meta_params(cfg) -> int:
        return sum(p.numel() for p in api.init_params(
            None, cfg, device="meta").parameters())

    # (a) Each family's smallest full-width cut: K5 against the twin.
    activations = {}
    for seed, (name, (cut, (b, s), _)) in enumerate(TRAIN_FAMILIES.items()):
        t_family = time.perf_counter()
        cfg = get_config(name).scaled(**cut)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        live0 = torch.cuda.memory_allocated()
        model = api.init_params(torch.Generator(dev).manual_seed(20 + seed),
                                cfg, device=dev)
        n = sum(p.numel() for p in model.parameters())
        batch = training_batch(cfg, 800 + seed, b, s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        patch, rec = routing(torch, moe)
        with patch:
            loss = api.loss_fn(model, batch, cfg)
            loss.backward()
        torch.cuda.synchronize()
        k5 = kernels.launch_counts()["flash_attention"]
        peak = torch.cuda.max_memory_allocated() - live0
        # Above the weights: the gradients that exist at the peak are not
        # known, so they count as activations; (b) adds them again in its
        # 16 B a parameter, which leaves room for the allocator's slack.
        activations[name] = peak - 4 * n
        t_k5 = time.perf_counter() - t_family

        # K5's gradients in bf16, so that qwen3-moe's weights and both
        # gradient sets fit on the card together; the rounding moves a
        # compared error by at most 2^-9 of max|g|.
        g_k5 = {k: p.grad.to(torch.bfloat16)
                for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            score = api.loss_fn(model, batch, cfg)
        pin = rec["topi"].__getitem__
        patch, pinned = routing(torch, moe, pin=pin)
        t = time.perf_counter()
        with patch, mock.patch.object(layers, "flash_attention_grad",
                                      twin_grad):
            twin_loss = api.loss_fn(model, batch, cfg)
            twin_loss.backward()
        torch.cuda.synchronize()
        t_twin = time.perf_counter() - t
        flips = (f"; routing pinned, {pinned['apart']} token choices "
                 f"flipped, smallest gap {rec['gap']:.3e}"
                 if cfg.family == "moe" else "")
        log(f"phase 12 (a): {name}, {cfg.n_layers} layers at full width, "
            f"{b} x {s} tokens, {n / 1e9:.3f} B float32 parameters: loss "
            f"{loss.item()!r} training (K5 in the Function, remat), "
            f"{score.item()!r} scoring (no_grad), {twin_loss.item()!r} "
            f"through the twin's autograd; K5 launches {k5}; the step's "
            f"peak {peak / gib:.2f} GiB above {live0 / gib:.2f} GiB live, "
            f"{activations[name] / 1e9:.2f} GB of it beyond the weights"
            f"{flips}")
        if k5 != k5_per_pass(cfg):
            fail(f"phase 12 (a): {name}: K5 launched {k5} times, not "
                 f"{k5_per_pass(cfg)}")
        if loss.item() != score.item() or not np.isfinite(loss.item()):
            fail(f"phase 12 (a): {name}: the training loss differs from the "
                 "scoring loss")
        log(f"phase 12 (a): {name}: the loss and first-step gradients "
            "through K5's Function against plain autograd through the twin")
        worst, beyond = (0.0, ""), []
        for pname, p in [("loss", None), *model.named_parameters()]:
            got, want = ((loss.detach(), twin_loss.detach()) if p is None
                         else (g_k5[pname], p.grad))
            err, scale = max_abs(torch, got, want), max_abs(torch, want)
            ok = err <= GRAD_REL * scale
            worst = max(worst, (err / max(scale, 1e-30), pname))
            log(f"  {name} d{pname}: max|err|={err:.3e} max|ref|="
                f"{scale:.3e} tol={GRAD_REL:g}*max|ref| "
                f"{'ok' if ok else 'beyond: to the fp32 witness'}")
            if not ok:
                beyond.append(pname)
        log(f"phase 12 (a): {name}: at most {worst[0]:.3e}*max|ref| "
            f"(d{worst[1]}); {time.perf_counter() - t_family:.1f} s (the K5 "
            f"run with the weights drawn {t_k5:.1f} s, the twin's "
            f"{t_twin:.1f} s)")
        if beyond:
            # The exact gradient (fp32 compute through the twin in fp32,
            # the routing pinned likewise) decides each such leaf.
            g_twin = {k: p.grad.to(torch.bfloat16)
                      for k, p in model.named_parameters() if k in beyond}
            model.zero_grad(set_to_none=True)
            model.cfg = cfg.scaled(compute_dtype="float32")
            patch, _ = routing(torch, moe, pin=pin)
            with patch, mock.patch.object(layers, "flash_attention_grad",
                                          twin_grad):
                api.loss_fn(model, batch, model.cfg).backward()
            model.cfg = cfg
            exact = dict(model.named_parameters())
            for pname in beyond:
                if pname == "loss":
                    fail(f"phase 12 (a): {name}: the loss through the "
                         "Function is beyond 2e-2 of the twin's")
                    continue
                g32 = exact[pname].grad
                s32 = max_abs(torch, g32)
                e_fn = max_abs(torch, g_k5[pname], g32)
                e_tw = max_abs(torch, g_twin[pname], g32)
                ok = (max(e_fn, e_tw) > GRAD_REL * s32
                      and e_fn <= max(WITNESS_RATIO * e_tw, GRAD_REL * s32))
                log(f"  {name} d{pname} against fp32 (max|g32| {s32:.3e}): "
                    f"K5 {e_fn / s32:.3e}*max|g32|, the twin "
                    f"{e_tw / s32:.3e} {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"phase 12 (a): {name} d{pname}: K5 {e_fn} and the "
                         f"twin {e_tw} from fp32, max|g32| {s32}")
            del g_twin, exact
        del model, g_k5, loss, score, twin_loss, batch, rec, pinned
        del p, got, want
        torch.cuda.empty_cache()

    # (b) train_loop at the largest depth that fits.
    profile_extra = {
        "moe": [("expert products", moe, "_experts"),
                ("expert products", layers, "mlp_block"),
                ("dispatch/combine", moe, "_local_dispatch"),
                ("dispatch/combine", moe, "_local_combine"),
                ("router", moe, "router_topk")],
        "ssm": [("SSD (einsums and recurrence)", mamba2, "ssd_scan")],
        "hybrid": [("SSD (einsums and recurrence)", mamba2, "ssd_scan")],
    }
    real_make = train_launch.ts.make_train_step
    counts = {}
    microbatches, steps = 2, 3
    ocfg = opt.OptConfig(warmup_steps=min(10, steps // 5 + 1),
                         total_steps=steps)
    kernels.reset_launch_counts()
    for name, (_, _, geometry) in TRAIN_FAMILIES.items():
        if geometry is None:
            continue
        t_family = time.perf_counter()
        global_batch, seq = geometry
        cfg = get_config(name)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        margin = 0.05 * total
        room = free - margin - activations[name]
        # Whole groups with the tail kept; gemma2's local/global pairs.
        unit_d = (cfg.hybrid_attn_every if cfg.family == "hybrid"
                  else 2 if cfg.local_global else 1)
        tail = cfg.n_layers % unit_d
        depths = range(cfg.n_layers, tail, -unit_d)
        depth = next((d for d in depths
                      if 16 * meta_params(cfg.scaled(n_layers=d)) <= room),
                     None)
        if depth is None:
            fail(f"phase 12 (b): {name}: not even "
                 f"{depths[-1]} layers fit in {room / 1e9:.2f} GB")
        outer = meta_params(cfg.scaled(n_layers=tail))
        unit = meta_params(cfg.scaled(n_layers=tail + unit_d)) - outer
        n_full = meta_params(cfg)
        log(f"phase 12 (b): {name}: depth {depth} of {cfg.n_layers}: free "
            f"{free / 1e9:.2f} GB of {total / 1e9:.2f}, less a "
            f"{margin / 1e9:.2f} GB margin, less (a)'s peak above its "
            f"weights {activations[name] / 1e9:.2f} GB, leaves "
            f"{room / 1e9:.2f} GB; 16 B a parameter (fp32 weight, "
            f"gradient, two AdamW moments): {16 * outer / 1e9:.2f} GB "
            "outside the repeated "
            + ("groups (embedding, final norm, shared block, tail), "
               if cfg.family == "hybrid" else "layers (embedding, norms), ")
            + f"{16 * unit / 1e9:.2f} GB a "
            + ("group of six" if cfg.family == "hybrid"
               else "local/global pair" if unit_d == 2 else "layer")
            + f"; the {cfg.n_layers} layers would take "
            f"{16 * n_full / 1e9:.1f} GB"
            + ("" if depth == cfg.n_layers else " (cut to fit)"))
        cfgd = cfg.scaled(n_layers=depth)
        records = []

        def counted_make(*a, **kw):
            step = real_make(*a, **kw)

            def run(model, state, batch):
                if "patch_embeds" in batch:
                    # The loop's zero patch embeddings give non-finite
                    # gradients at this depth, in both packages: a
                    # position whose residual stream is zero at every
                    # layer passes its gradient through each norm at
                    # rsqrt(eps) = 1000 times (ROADMAP §3). Seeded ones
                    # stand for the frontend's output, as in (a).
                    g = torch.Generator(dev).manual_seed(900 + len(records))
                    batch = dict(batch, patch_embeds=torch.randn(
                        batch["patch_embeds"].shape, generator=g,
                        device=dev))
                torch.cuda.synchronize()
                before = kernels.launch_counts()["flash_attention"]
                t = time.perf_counter()
                m = step(model, state, batch)
                torch.cuda.synchronize()
                records.append(((time.perf_counter() - t) * 1e3,
                                {k: float(v) for k, v in m.items()},
                                kernels.launch_counts()["flash_attention"]
                                - before, (model, state, batch)))
                return m
            return run

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        before = kernels.launch_counts()
        t = time.perf_counter()
        with mock.patch.object(train_launch.ts, "make_train_step",
                               counted_make):
            model, losses = train_launch.train_loop(
                cfgd, steps, global_batch, seq, microbatches=microbatches,
                log_every=steps, device=dev)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
        after = kernels.launch_counts()
        counts[name] = {k: after[k] - before[k] for k in after}
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"phase 12 (b): {name} at full width, {depth} layers, "
            f"{n_params / 1e9:.3f} B float32 parameters, {global_batch} x "
            f"{seq} tokens a step in {microbatches} microbatches, {ocfg}; "
            f"train_loop {loop_s:.1f} s ({steps} steps, weights drawn on the "
            "card)")
        want_k5 = k5_per_pass(cfgd) * microbatches
        for i, (ms, m, k5, _) in enumerate(records):
            log(f"  step {i}: {ms:.1f} ms, loss {m['loss']!r}, grad_norm "
                f"{m['grad_norm']!r}, lr {m['lr']!r}, K5 launches {k5}")
            if k5 != want_k5:
                fail(f"phase 12 (b): {name}: step {i} launched K5 {k5} "
                     f"times, not {want_k5}")
        if len(records) != steps or not all(np.isfinite(losses)):
            fail(f"phase 12 (b): {name}: {len(records)} steps, losses "
                 f"{losses}")
        mf = flops.model_flops(cfgd, InputShape(name, seq, global_batch,
                                                "train"))
        steady = statistics.median(r[0] for r in records[1:])
        log(f"phase 12 (b): {name}: step ms (first apart): first "
            f"{records[0][0]:.1f}; then "
            + ", ".join(f"{r[0]:.1f}" for r in records[1:])
            + f"; peak device memory {peak / gib:.2f} GiB, "
            f"{(peak - live) / gib:.2f} GiB above the {live / gib:.2f} GiB "
            f"live before the loop; model_flops {mf / 1e12:.2f} TFLOP a "
            f"step (launch/flops.py), {mf / steady / 1e9:.1f} TFLOP/s over "
            f"the steady step, {mf / steady / bf16_peak * 1e3:.3f} "
            f"of {bf16_peak / 1e12:.0f} TFLOP/s bf16")
        # The profiled step is one microbatch of the batch: the trace of
        # a whole step (up to 75,000 kernels for zamba2) takes up to 42 s
        # to read, and a microbatch's kernels are the step's, halved.
        _, _, _, (pmodel, pstate, pbatch) = records[-1]
        pbatch = {k: v[:global_batch // microbatches]
                  for k, v in pbatch.items()}
        step = real_make(cfgd, ocfg, microbatches=1)
        profile_training_step(
            torch, log, f"{name} ({depth} layers) training step of one "
            "microbatch", lambda: step(pmodel, pstate, pbatch),
            profile_extra.get(cfgd.family, ()))
        del model, pmodel, pstate, pbatch, records, step
        torch.cuda.empty_cache()
        log(f"phase 12 (b): {name}: {time.perf_counter() - t_family:.1f} s")

    # (c) Checkpoint and resume at a reduced width.
    for name, cut in RESUME_CUTS.items():
        t = time.perf_counter()
        small = get_config(name).scaled(**cut)
        seq = 448 if small.family == "audio" else 512
        kw = dict(global_batch=2, seq_len=seq, log_every=100, device=dev)
        before = kernels.launch_counts()["flash_attention"]
        with tempfile.TemporaryDirectory() as d:
            _, first = train_launch.train_loop(small, 2, ckpt_dir=d, **kw)
            resumed, rest = train_launch.train_loop(small, 3, ckpt_dir=d,
                                                    resume=True, **kw)
            saved = ckpt.available_steps(d)
        whole, losses = train_launch.train_loop(small, 3, **kw)
        k5_c = kernels.launch_counts()["flash_attention"] - before
        dp = max((a - b).abs().max().item()
                 for a, b in zip(resumed.parameters(), whole.parameters()))
        log(f"phase 12 (c): {name} {cut or '(whole)'}, 2 x {seq} tokens: 2 "
            f"steps {first} + resume {rest} against 3 steps {losses}; "
            f"checkpoints {saved}; max |dparam| {dp!r}; K5 launches {k5_c}; "
            f"{time.perf_counter() - t:.1f} s")
        if saved != [2, 3] or first + rest != losses or dp != 0.0:
            fail(f"phase 12 (c): {name}: the resumed run differs from the "
                 "uninterrupted one")
        del resumed, whole
        torch.cuda.empty_cache()
    log(f"phase 12: wall time {time.perf_counter() - t_phase:.1f} s; main "
        f"path (b) launches {counts}")
    return counts


#: Phase 13 (a)'s models, at published width and depth, built on the
#: ``meta`` device: shapes only.
PLACEMENT_MODELS = ("gemma2-9b", "moonshot-v1-16b-a3b",
                    "qwen3-moe-235b-a22b", "zamba2-7b")


def placement_phase(torch, np, dev, log, fail, compare, kernels, get_config,
                    median_ms):
    """Phase 13: GSPMD placement on one card.

    (a) ``param_shardings`` of :data:`PLACEMENT_MODELS` on
    ``make_production_mesh()`` and ``multi_pod=True`` (256 and 512
    positions, all on ``cuda:0``): the reference's leaves sharded and
    replicated, and the largest per-position parameter bytes against the
    whole model's; (b) moonshot-v1-16b-a3b at full width, 2 layers, 2 ×
    4096 tokens on a ``(2, 4)`` mesh (gd 2, gm 4, 1024 tokens a group,
    capacity 120): logits and one training microbatch's gradients
    through the expert-parallel exchange against the no-mesh functions
    composed by hand over the 8 groups (routing pinned), a ``(1, 1)``
    mesh against no mesh bit for bit, and the request timed both ways;
    (c) gemma2-9b at full width, 2 layers, 1 × 8192 tokens on a ``(1,
    16)`` mesh: K and V repeated twice, K5 at 16/16 heads, logits equal
    to those without a mesh bit for bit, K5 timed at 16/16 against
    16/8; (d) on ``make_mesh_for(1)``: (c)'s model takes one training
    step that equals the step with ``mesh=None`` bit for bit,
    ``generate`` equals a hand loop over ``decode_step``, and
    mamba2-130m's serve step returns the argmax of its logits; (e) the
    cross-pod int8 mean of (d)'s layer gradients over a ``pod`` axis of
    4 members against the fp32 mean, ``quantize_leaf``'s exact
    decomposition, one leaf on the card against the CPU bit for bit;
    (f) (d)'s parameters and AdamW state through ``remesh_live`` on (1,
    1) → (2, 2) → (2, 2, 2) → (1, 1), bit for bit, and
    ``degrade_plan``'s three cases.

    Returns the launch counts of the paths it drives: (b)'s and (c)'s
    requests and (b)'s microbatch on their meshes, (d)'s step and
    ``generate``."""
    import contextlib
    import math
    from unittest import mock

    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import make_mesh_for
    from repro_torch.models import api, layers, moe
    from repro_torch.train import compress, elastic
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    gib = 2**30
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts = dict.fromkeys(kernels.launch_counts(), 0)

    def driven(fn):
        """A main-path call: the counts set to 0 just before, read and
        added to the phase's just after."""
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        for k, v in got.items():
            counts[k] += v
        return out, got["flash_attention"]

    # (a) The rules at deployment scale, from shapes alone.
    for name in PLACEMENT_MODELS:
        t = time.perf_counter()
        model = api.init_params(None, get_config(name), device="meta")
        params = dict(model.named_parameters())
        whole = sum(p.numel() * p.element_size() for p in params.values())
        for label, mesh in (("(16, 16)", mesh_lib.make_production_mesh()),
                            ("(2, 16, 16)", mesh_lib.make_production_mesh(
                                multi_pod=True))):
            specs = sh.leaf_specs(mesh, params)
            sharded = sum(any(e is not None for e in spec)
                          for _, spec in specs.values())
            per_pos = np.zeros(mesh.size)
            index = {pos: i for i, pos in enumerate(mesh.positions())}
            for pname, s in sh.param_shardings(mesh, params).items():
                p = params[pname]
                block = math.prod(s.shard_shape(p.shape)) * p.element_size()
                held = [index[pos] for pos, idx in s.indices_map(
                    p.shape).items() if idx is not None]
                per_pos[held] += block
            if not 0 < per_pos.max() <= whole:
                fail(f"phase 13 (a): {name} on {label}: {per_pos.max()} "
                     f"bytes a position of {whole}")
            log(f"phase 13 (a): {name} on {label} ({mesh.size} positions "
                f"on {sorted({str(d) for d in mesh.devices.flat})}): "
                f"{sharded} of {len(specs)} leaves sharded, "
                f"{len(specs) - sharded} replicated; largest position "
                f"{per_pos.max() / gib:.3f} GiB of the whole "
                f"{whole / gib:.2f} GiB ({per_pos.max() / whole:.4f}), "
                f"smallest {per_pos.min() / gib:.3f} GiB")
        log(f"phase 13 (a): {name}: {time.perf_counter() - t:.1f} s")
        del model, params

    # (b) The expert-parallel exchange at full width.
    t = time.perf_counter()
    cfg = get_config("moonshot-v1-16b-a3b").scaled(n_layers=2)
    model = api.init_params(torch.Generator(dev).manual_seed(130), cfg,
                            device=dev)
    g = torch.Generator(dev).manual_seed(131)
    toks = torch.randint(0, cfg.vocab, (2, 4096), generator=g, device=dev)
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    mesh8 = sh.make_mesh((2, 4), ("data", "model"))
    with sh.activation_context(mesh8):
        gd, gm = sh.batch_shard_count(), sh.model_axis_size()
    tg = (2 // gd) * (4096 // gm)
    cap = max(4, min(int(cfg.capacity_factor * tg * cfg.top_k
                         / cfg.n_experts), tg))
    log(f"phase 13 (b): moonshot-v1-16b-a3b, 2 layers at full width, 2 x "
        f"4096 tokens on {mesh8}: gd {gd}, gm {gm}, {tg} tokens a group, "
        f"capacity {cap}, {cfg.n_experts // gm} experts a model rank")
    if (gd, gm, tg, cap) != (2, 4, 1024, 120):
        fail(f"phase 13 (b): groups {(gd, gm, tg, cap)}, not (2, 4, 1024, "
             "120)")
    real_block = moe.moe_block

    def composed(p, x, cfg_):
        """The no-mesh functions over the 8 groups by hand: each group's
        dispatch at the group capacity, all experts, its combine."""
        b, s, d = x.shape
        e, k = cfg_.n_experts, cfg_.top_k
        cd = layers.dtype_of(cfg_, "compute_dtype")
        topv, topi, aux = moe.router_topk(x.float() @ p["router"], k)
        bl, sl = b // gd, s // gm
        rows = []
        for di in range(gd):
            cols = []
            for mj in range(gm):
                blk = (slice(di * bl, (di + 1) * bl),
                       slice(mj * sl, (mj + 1) * sl))
                buf, slot = moe._local_dispatch(
                    x[blk].reshape(bl * sl, d), topi[blk].reshape(bl * sl, k),
                    e, k, cap, cd)
                cols.append(moe._local_combine(
                    moe._experts(p, buf, cd), slot,
                    topv[blk].reshape(bl * sl, k).to(cd)).reshape(bl, sl, d))
            rows.append(torch.cat(cols, dim=1))
        out = torch.cat(rows)
        if cfg_.n_shared_experts:
            out = out + layers.mlp_block(p["shared"], x, cfg_)
        return out, aux

    patch, rec = routing(torch, moe)
    with torch.no_grad(), patch, sh.activation_context(mesh8):
        (out_ep, _), k5_b = driven(lambda: api.forward_logits(
            model, {"tokens": toks}, cfg))
    patch, pinned = routing(torch, moe, pin=rec["topi"].__getitem__)
    with torch.no_grad(), patch, mock.patch.object(moe, "moe_block",
                                                   composed):
        out_comp, _ = api.forward_logits(model, {"tokens": toks}, cfg)
    log(f"phase 13 (b): logits through the exchange (K5 launches {k5_b}) "
        f"against the composition, routing pinned ({pinned['apart']} of "
        f"{2 * 2 * 4096} (token, layer) choices of the composition's own "
        f"differ; smallest gap {rec['gap']:.3e})")
    compare("phase 13 (b) logits, exchange against composition", out_ep,
            out_comp, "bf16")
    del out_comp
    with torch.no_grad():
        plain, _ = api.forward_logits(model, {"tokens": toks}, cfg)
        with sh.activation_context(make_mesh_for(1)):
            one, _ = api.forward_logits(model, {"tokens": toks}, cfg)
    if not torch.equal(plain, one):
        fail("phase 13 (b): the (1, 1) mesh's logits differ from no mesh's")
    log("phase 13 (b): the (1, 1) mesh's logits equal no mesh's bit for "
        "bit")
    del plain, one, out_ep

    def grads_of(*patches):
        """One training microbatch's gradients under ``patches``."""
        model.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as stack:
            for cm in patches:
                stack.enter_context(cm)
            api.loss_fn(model, batch, cfg).backward()
        out = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    patch, rec = routing(torch, moe)
    g_ep, k5_bt = driven(lambda: grads_of(patch,
                                          sh.activation_context(mesh8)))
    patch, pinned = routing(torch, moe, pin=rec["topi"].__getitem__)
    g_comp = grads_of(patch, mock.patch.object(moe, "moe_block", composed))
    log(f"phase 13 (b): one training microbatch through the exchange (K5 "
        f"launches {k5_bt}) against the composition's autograd, routing "
        f"pinned ({pinned['apart']} choices apart)")
    worst = max((compare(f"phase 13 (b) d{n}", g_ep[n], g_comp[n], "grad")
                 / max(g_comp[n].abs().max().item(), 1e-30), n)
                for n in g_comp)
    log(f"phase 13 (b): gradients at most {worst[0]:.3e}*max|ref| apart "
        f"({worst[1]})")
    del g_ep, g_comp

    def request(mesh):
        def run():
            with torch.no_grad():
                if mesh is None:
                    return api.forward_logits(model, {"tokens": toks}, cfg)
                with sh.activation_context(mesh):
                    return api.forward_logits(model, {"tokens": toks}, cfg)
        return run

    ep_ms = median_ms(request(mesh8), reps=3)
    flat_ms = median_ms(request(None), reps=3)
    log(f"phase 13 (b): a 2 x 4096 request {ep_ms:.1f} ms on the (2, 4) "
        f"mesh (8 groups of capacity {cap}), {flat_ms:.1f} ms without one "
        f"(one group of 8192 tokens, capacity "
        f"{moe._capacity(cfg, 8192, 4)}); {time.perf_counter() - t:.1f} s")
    del model, batch, toks, labels
    torch.cuda.empty_cache()

    # (c) K and V repeated under a model axis of 16.
    t = time.perf_counter()
    cfg = get_config("gemma2-9b").scaled(n_layers=2)
    model = api.init_params(torch.Generator(dev).manual_seed(132), cfg,
                            device=dev)
    g = torch.Generator(dev).manual_seed(133)
    toks = torch.randint(0, cfg.vocab, (1, 8192), generator=g, device=dev)
    mesh16 = sh.make_mesh((1, 16), ("data", "model"))
    shapes = []
    real_fused = layers.flash_attention_fused

    def seen(q, k, v, **kw):
        shapes.append((q.shape[2], k.shape[2], q.shape[3]))
        return real_fused(q, k, v, **kw)

    with torch.no_grad(), mock.patch.object(layers, "flash_attention_fused",
                                            seen):
        with sh.activation_context(mesh16):
            rep = sh.kv_repeat_for_tp(cfg.n_kv, cfg.n_heads)
            (out16, _), k5_c = driven(lambda: api.forward_logits(
                model, {"tokens": toks}, cfg))
        out8, _ = api.forward_logits(model, {"tokens": toks}, cfg)
    log(f"phase 13 (c): gemma2-9b, 2 layers at full width, 1 x 8192 tokens "
        f"on {mesh16}: kv_repeat_for_tp({cfg.n_kv}, {cfg.n_heads}) = {rep}; "
        f"K5 launched {k5_c} times at (heads, KV heads, D) {shapes[:k5_c]}, "
        f"then {shapes[k5_c:]} without the mesh")
    if rep != 2 or k5_c != 2 or shapes[:2] != [(16, 16, 256)] * 2 \
            or shapes[2:] != [(16, 8, 256)] * 2:
        fail(f"phase 13 (c): repeat {rep}, K5 at {shapes}")
    if not torch.equal(out16, out8):
        fail("phase 13 (c): the logits under the KV repeat differ from "
             f"those without: max|d| {max_abs(torch, out16, out8)}")
    log("phase 13 (c): logits under the repeat equal those without, bit for "
        "bit")
    del out16, out8
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((1, 8192, 16, 256), (1, 8192, 8, 256),
                             (1, 8192, 8, 256)))
    kr, vr = (t_.repeat_interleave(2, dim=2) for t_ in (k, v))
    kw = dict(causal=True, softcap=50.0)
    if not torch.equal(kernels.flash_attention_fused(q, kr, vr, **kw),
                       kernels.flash_attention_fused(q, k, v, **kw)):
        fail("phase 13 (c): K5 at 16/16 over repeated K, V differs from "
             "16/8")
    ms16 = median_ms(lambda: kernels.flash_attention_fused(q, kr, vr, **kw))
    ms8 = median_ms(lambda: kernels.flash_attention_fused(q, k, v, **kw))
    log(f"phase 13 (c): K5 at gemma2's global layer (1 x 8192, D=256, "
        f"softcap 50): 16/16 over repeated K, V {ms16:.4f} ms, 16/8 "
        f"{ms8:.4f} ms (equal outputs); {time.perf_counter() - t:.1f} s")
    del q, k, v, kr, vr

    # (d) The steps on make_mesh_for(1).
    t = time.perf_counter()
    mesh1 = make_mesh_for(1)
    ocfg = opt.OptConfig(warmup_steps=1, total_steps=10)
    g = torch.Generator(dev).manual_seed(134)
    toks = torch.randint(0, cfg.vocab, (1, 4096), generator=g, device=dev)
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    ref_model = api.init_params(torch.Generator(dev).manual_seed(132), cfg,
                                device=dev)
    state = opt.init_opt_state(dict(ref_model.named_parameters()), ocfg)
    m_none = ts.make_train_step(cfg, ocfg)(ref_model, state, batch)
    del state
    state = opt.init_opt_state(dict(model.named_parameters()), ocfg)
    m_one, k5_d = driven(lambda: ts.make_train_step(cfg, ocfg, mesh1)(
        model, state, batch))
    same = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 ref_model.parameters()))
    log(f"phase 13 (d): gemma2-9b 2 layers, one step of 1 x 4096 on "
        f"{mesh1} (K5 launches {k5_d}): loss {float(m_one['loss'])!r}, "
        f"grad_norm {float(m_one['grad_norm'])!r}; mesh=None: loss "
        f"{float(m_none['loss'])!r}, grad_norm "
        f"{float(m_none['grad_norm'])!r}; parameters equal: {same}")
    if not same or any(not torch.equal(m_one[k], m_none[k])
                       for k in ("loss", "grad_norm", "lr")):
        fail("phase 13 (d): the (1, 1) step differs from mesh=None's")
    del ref_model
    torch.cuda.empty_cache()
    (toks_gen, _), _ = driven(lambda: generate(cfg, 4, 16, 16,
                                                params=model, device=dev))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32)).to(dev)
    cache = api.init_cache(cfg, 4, 32, dtype=torch.float32, device=dev)
    hand = []
    with torch.no_grad():
        for i in range(31):
            tok = prompt[:, i:i + 1] if i < 16 else hand[-1]
            lg, cache = api.decode_step(model, cache, tok, i + 1, cfg)
            if i >= 15:
                hand.append(torch.argmax(lg[:, -1], dim=-1).to(
                    torch.int32)[:, None])
    hand = torch.cat(hand, dim=1).cpu().numpy()
    log(f"phase 13 (d): generate(4, 16, 16) through make_serve_step on "
        f"{mesh1}: tokens equal a hand loop over decode_step: "
        f"{bool((hand == toks_gen).all())}")
    if not (hand == toks_gen).all():
        fail("phase 13 (d): generate's tokens differ from the hand loop's")
    del cache
    cfg_m = get_config("mamba2-130m")
    mamba = api.init_params(torch.Generator(dev).manual_seed(135), cfg_m,
                            device=dev)
    tok = torch.randint(0, cfg_m.vocab, (4, 1), generator=g, device=dev)
    with torch.no_grad():
        got, _ = ts.make_serve_step(cfg_m, mesh1)(
            mamba, api.init_cache(cfg_m, 4, 8, device=dev), tok, 1)
        lg, _ = api.decode_step(mamba, api.init_cache(cfg_m, 4, 8,
                                                      device=dev),
                                tok, 1, cfg_m)
    want = torch.argmax(lg, dim=-1).to(torch.int32)
    log(f"phase 13 (d): mamba2-130m serve step (serve_sample) returns "
        f"{got.dtype} {tuple(got.shape)}, the argmax of its logits: "
        f"{torch.equal(got, want)}")
    if got.dtype != torch.int32 or not torch.equal(got, want):
        fail("phase 13 (d): mamba2-130m's serve step is not the argmax")
    del mamba
    log(f"phase 13 (d): {time.perf_counter() - t:.1f} s")

    # (e) Cross-pod int8 mean of (d)'s layer gradients over 4 members.
    t = time.perf_counter()
    with sh.activation_context(mesh1):
        api.loss_fn(model, batch, cfg).backward()
    grads_all = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    grads = {n: gr for n, gr in grads_all.items() if n != "embedding"}
    del grads_all
    members = 4
    errs = [{n: torch.randn(gr.shape, generator=g, device=dev)
             .mul_(1e-2 * gr.abs().max()) for n, gr in grads.items()}
            for _ in range(members)]
    outs, new_errs = compress.crosspod_mean_compressed(
        [grads] * members, errs, axis="pod")
    worst = 0.0
    for n, gr in grads.items():
        g32 = [gr.float() + e[n] for e in errs]
        mean = torch.stack(g32).mean(0)
        bound = 2 * (max(x.abs().max().item() for x in g32) / 127.0 + 1e-6)
        err = max((o[n] - mean).abs().max().item() for o in outs)
        worst = max(worst, err / bound)
        if err > bound or any(not torch.equal(o[n], outs[0][n])
                              for o in outs):
            fail(f"phase 13 (e): {n}: {err} from the fp32 mean, bound "
                 f"{bound}")
        q, scale, e2 = compress.quantize_leaf(gr, errs[0][n])
        if not torch.equal(q.float() * scale + e2, g32[0]):
            fail(f"phase 13 (e): {n}: q·scale + err != g32")
    leaf = "layers.0.attn.wq"
    cpu_out, cpu_err = compress.crosspod_mean_compressed(
        [{leaf: grads[leaf].cpu()}] * members,
        [{leaf: e[leaf].cpu()} for e in errs])
    if not all(torch.equal(a[leaf].cpu(), b[leaf]) for a, b in
               zip(outs + new_errs, cpu_out + cpu_err)):
        fail(f"phase 13 (e): {leaf} on the card differs from the CPU")
    del outs, new_errs
    comp_ms = median_ms(lambda: compress.crosspod_mean_compressed(
        [grads] * members, errs), reps=3)
    numel = sum(gr.numel() for gr in grads.values())
    log(f"phase 13 (e): {len(grads)} layer gradient leaves of gemma2-9b "
        f"({numel / 1e6:.1f} M elements; the embedding's left out), "
        f"{members} pod members: every leaf within "
        f"{worst:.3f} of 2·max|g|/127 from the fp32 mean, g32 = q·scale + "
        f"err exactly, {leaf} on the card equal to the CPU bit for bit; "
        f"{comp_ms:.1f} ms a reduction; int8 payload {numel / 1e6:.1f} MB "
        f"a member against {4 * numel / 1e6:.1f} MB in fp32; "
        f"{time.perf_counter() - t:.1f} s")
    del grads, errs

    # (f) Elastic re-placement of (d)'s parameters and AdamW state.
    t = time.perf_counter()
    tree = {"params": {n: p.detach() for n, p in model.named_parameters()},
            "opt": state}
    flat = dict(sh._flat_names(tree))
    live = torch.cuda.memory_allocated()
    placed = sh.device_put(tree, sh.param_shardings(mesh1, tree))
    path = [mesh1]
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model")),
                        ((1, 1), ("data", "model"))):
        mesh = sh.make_mesh(shape, axes)
        placed = elastic.remesh_live(placed, mesh)
        path.append(mesh)
        back = dict(sh._flat_names(sh.gather(placed)))
        views = all(blk.untyped_storage().data_ptr()
                    == flat[n].untyped_storage().data_ptr()
                    for n, pl in sh._flat_names(placed)
                    for blk in pl.blocks.values())
        if back.keys() != flat.keys() or not all(
                torch.equal(back[n], flat[n]) for n in flat) or not views:
            fail(f"phase 13 (f): {shape}: the state differs after "
                 "remesh_live, or a block is not a view")
        blocks = sum(len(pl.blocks) for _, pl in sh._flat_names(placed))
        log(f"phase 13 (f): remesh_live to {shape}: {len(flat)} tensors in "
            f"{blocks} blocks, all views; gathered state equal bit for bit; "
            f"{(torch.cuda.memory_allocated() - live) / 2**20:.1f} MiB "
            "allocated beyond the state")
    cases = {(3, (16, 16)): (15, 16), (17, (16, 16)): (14, 16),
             (1, (2, 16, 16)): (2, 15, 16)}
    got = {c: elastic.degrade_plan(*c) for c in cases}
    log(f"phase 13 (f): degrade_plan {got}; {time.perf_counter() - t:.1f} s")
    if got != cases:
        fail(f"phase 13 (f): degrade_plan {got} != {cases}")
    del placed, tree, flat, model, state, batch
    torch.cuda.empty_cache()
    log(f"phase 13: wall time {time.perf_counter() - t_phase:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / gib:.2f} GiB; "
        f"main path launches {counts}; K5 at 16/16, D=256 under the KV "
        f"repeat: {k5_c}")
    return counts


#: Phase 14 (a)'s cells: (arch, shape), traced on ``meta`` at published
#: size on the (16, 16) production mesh.
REPORT_CELLS = (("gemma2-9b", "train_4k"), ("qwen3-moe-235b-a22b", "train_4k"),
                ("zamba2-7b", "long_500k"), ("moonshot-v1-16b-a3b", "decode_32k"))
#: Phase 14 (b)'s programs: arch → layers at full width (None: whole),
#: each run at the ``InputShape`` fields (name, seq_len, global_batch,
#: kind) below: a decode cell's cache holds seq_len slots, seq_len - 1
#: of them filled.
COUNTED_MODELS = {"gemma2-9b": 2, "moonshot-v1-16b-a3b": 2,
                  "mamba2-130m": None}
COUNTED_SHAPES = (("train 1 x 4096", 4096, 1, "train"),
                  ("prefill 1 x 8192", 8192, 1, "prefill"),
                  ("decode at 8191", 8192, 1, "decode"))
#: How far the counted peak may lie from the card's
#: ``max_memory_allocated`` above the arguments: the caching allocator
#: rounds each block to 512 bytes and ops keep internal scratch (sorts,
#: cuBLAS workspaces) that no dispatch mode sees.
PEAK_REL = 5e-2


def start_report_cells():
    """Start phase 14 (a)'s dry runs, one ``python -m
    repro_torch.launch.dryrun`` process a cell, all at once; they are
    killed at exit if still running. Returns ``(processes, out_dir)``."""
    import atexit
    import os
    import tempfile

    out_dir = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch.replace("-", "_"), "--shape", shape, "--mesh", "single",
         "--out-dir", out_dir.name], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape in REPORT_CELLS]

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out_dir.cleanup()

    atexit.register(stop)
    return procs, out_dir.name


def reports_phase(torch, np, dev, log, fail, kernels, get_config,
                  report_cells):
    """Phase 14: the reports (``launch/{hlo_analysis,dryrun,report}.py``).

    (a) :data:`REPORT_CELLS` through ``python -m
    repro_torch.launch.dryrun`` on ``meta`` at published size on the (16,
    16) mesh, in the processes :func:`start_report_cells` started in
    phase 0: each must exit 0 with status ``ok``; the roofline, dry-run
    and fused-attention tables and each trace's seconds are printed.
    (b) :data:`COUNTED_MODELS` at full width (gemma2's one local and one
    global layer) at :data:`COUNTED_SHAPES`: a 1 × 4096 training step, a
    1 × 8192 prefill and a decode step over an 8192-slot cache, each the
    dry run's own program (``dryrun.cell_program``, on the (16, 16)
    production mesh: K/V repeated to the model axis, the MoE's grouped
    dispatch and exchange), run on the card with weights drawn from a
    seed under ``OpCounter`` and traced on ``meta`` by
    ``dryrun.trace_cell``: flops, bytes and op counts equal exactly, K5's
    counted calls equal to its launches, the counted peak within
    :data:`PEAK_REL` of ``torch.cuda.max_memory_allocated()`` above the
    arguments; then each is timed (CUDA events, one run after the counted
    one) beside its roofline terms.

    Returns the launch counts of (b)'s runs on the card."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import report
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import InputShape

    t_phase = time.perf_counter()
    counts = dict.fromkeys(kernels.launch_counts(), 0)

    # (a) The dry run at published size, shapes only.
    procs, out_dir = report_cells
    for (arch, shape), proc in zip(REPORT_CELLS, procs):
        out, _ = proc.communicate()
        name = f"{arch.replace('-', '_')}_{shape}_single.json"
        path = pathlib.Path(out_dir) / name
        cell = json.loads(path.read_text()) if path.exists() else {}
        if proc.returncode or cell.get("status") != "ok":
            fail(f"phase 14 (a): {arch} {shape}: exit {proc.returncode}, "
                 f"status {cell.get('status')}\n{out[-3000:]}\n"
                 f"{cell.get('traceback', '')}")
        r, b = cell["roofline"], cell["bytes_per_device"]
        log(f"phase 14 (a): {arch} {shape} on meta, {cell['n_chips']} "
            f"positions, {cell['microbatches']} microbatches: traced in "
            f"{cell['trace_s']} s (its own process, beside phases 1-13), "
            f"{sum(v['calls'] for v in cell['by_op'].values())} ops; per "
            f"position {r['flops_per_dev']:.4e} flops, "
            f"{r['hbm_bytes_per_dev']:.4e} bytes, arguments "
            f"{b['arguments'] / 2**30:.3f} GiB, temp "
            f"{b['temp'] / 2**30:.3f} GiB")
    log("phase 14 (a): roofline (NVIDIA H100 80GB HBM3, 700 W, data "
        "sheet):\n" + report.roofline_table("single", out_dir))
    log("phase 14 (a): dry run:\n" + report.dryrun_table("single", out_dir))
    log("phase 14 (a): fused attention:\n"
        + report.fused_attention_projection(out_dir))

    # (b) The dry run's own cell programs on the card against meta.
    card = torch.device("cuda", torch.cuda.current_device())
    hw = H.Hardware()
    for arch, layers in COUNTED_MODELS.items():
        cfg = get_config(arch)
        if layers:
            cfg = cfg.scaled(n_layers=layers)
        for shape in (InputShape(*f) for f in COUNTED_SHAPES):
            _, ref, _, _ = dryrun.trace_cell(
                cfg, shape, make_production_mesh(device="meta"),
                device="meta")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            _, fn, args, _ = dryrun.cell_program(
                cfg, shape, make_production_mesh(device=card), device=card,
                seed=140)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            counter = H.OpCounter(baseline=args)
            with counter:
                out = fn(*args)
            torch.cuda.synchronize()
            got = kernels.launch_counts()
            for k, v in got.items():
                counts[k] += v
            measured = torch.cuda.max_memory_allocated() - base
            st = counter.stats(out)
            label = f"phase 14 (b): {arch} {shape.name}"
            off = abs(st.temp_bytes - measured) / max(measured, 1)
            if off > PEAK_REL:
                missed = sorted(
                    ((t.untyped_storage().nbytes(), tuple(t.shape), t.dtype)
                     for t in gc_tensors(torch, dev)
                     if not counter.knows(t.untyped_storage())),
                    key=lambda m: m[0], reverse=True)[:8]
                fail(f"{label}: counted peak {st.temp_bytes} bytes, the "
                     f"card's {measured} above the arguments ({off:.4f} "
                     f"apart); the largest live storages it never counted: "
                     f"{missed}")
            del out
            for field in ("flops", "hbm_bytes", "flops_by_dtype", "by_op",
                          "kernel_calls"):
                if getattr(st, field) != getattr(ref, field):
                    mine, theirs = getattr(st, field), getattr(ref, field)
                    if isinstance(mine, dict):
                        mine = {k: v for k, v in mine.items()
                                if theirs.get(k) != v}
                        theirs = {k: theirs.get(k) for k in mine}
                    fail(f"{label}: {field} on the card {mine} differs from "
                         f"meta's {theirs}")
            k5 = st.by_op.get("flash_attention", {}).get("calls", 0)
            if k5 != got["flash_attention"]:
                fail(f"{label}: K5 counted {k5} times, launched "
                     f"{got['flash_attention']}")
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            rl = H.roofline_from_stats(st, hw)
            top = max(rl.compute_s, rl.memory_s) * 1e3
            by_dtype = {k: f"{v:.4e}" for k, v in st.flops_by_dtype.items()}
            log(f"{label}: cuda equals meta ({st.flops:.6e} flops "
                f"{by_dtype}, {st.hbm_bytes:.6e} bytes, "
                f"{sum(st.op_calls().values())} ops; meta peak "
                f"{ref.temp_bytes}); K5 {k5} calls = launches; counted "
                f"peak {st.temp_bytes / 2**30:.4f} GiB, card "
                f"{measured / 2**30:.4f} GiB above "
                f"{st.arg_bytes / 2**30:.3f} GiB of arguments ({off:.4f} "
                f"apart); {ms:.3f} ms measured, "
                f"compute {rl.compute_s * 1e3:.3f} ms, memory "
                f"{rl.memory_s * 1e3:.3f} ms, max(term)/measured "
                f"{top / ms:.3f}")
            del args, fn
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    log(f"phase 14: wall time {time.perf_counter() - t_phase:.1f} s; main "
        f"path launches {counts}")
    return counts


def gc_tensors(torch, dev):
    """The tensors on ``dev`` that Python still reaches (phase 14's report
    of a peak that misses)."""
    import gc

    return [o for o in gc.get_objects()
            if isinstance(o, torch.Tensor) and o.device.type == dev.type]


#: Kernel-name fragments of cuBLAS/CUTLASS products.
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


#: ``profile_moe_request``'s labels: (module, function) → label.
MOE_LABELS = {("moe", "router_topk"): "router",
              ("moe", "_local_dispatch"): "dispatch/combine",
              ("moe", "_local_combine"): "dispatch/combine",
              ("moe", "_experts"): "experts",
              ("layers", "mlp_block"): "experts",
              ("layers", "unembed"): "unembed",
              ("moe", "moe_block"): "moe block"}


def classify_moe(e, kernel: str, shapes) -> str:
    """The group of a kernel named ``kernel`` that the profiler's CPU
    operator event ``e`` launched, from ``e`` and its ancestors: a copy
    under an ``aten::_to_copy`` of a tensor of a parameter's shape (one of
    ``shapes``) is a weight cast; else the innermost
    :data:`MOE_LABELS` range decides (see :func:`profile_moe_request`)."""
    gemm = any(w in kernel.lower() for w in GEMM_NAMES)
    names = set(MOE_LABELS.values())
    label = None
    while e is not None:
        if e.name == "aten::_to_copy" and label is None:
            ins = getattr(e, "input_shapes", None) or [[]]
            if tuple(ins[0]) in shapes:
                return "weight casts (fp32 -> bf16 per use)"
        if e.name in names and label is None:
            label = e.name
        e = e.cpu_parent
    if label == "experts":
        return ("expert products (bmm, shared expert)" if gemm
                else "experts' elementwise (silu, product)")
    if label == "moe block":
        return "router" if gemm else "rest (norms, rope, residuals)"
    if label is None:
        return ("attention products (q, k, v, o)" if gemm
                else "rest (norms, rope, residuals)")
    return label


#: Phase 11's labels: (module, function) → label.
FAMILY_LABELS = {("mamba2", "ssd_scan"): "SSD einsums and recurrence",
                 ("mamba2", "_causal_conv"): "conv",
                 ("layers", "unembed"): "unembed"}


def classify_family(e, kernel: str, shapes) -> str:
    """The group of a kernel of phase 11's families, as
    :func:`classify_moe` finds it: a weight cast, else the innermost
    :data:`FAMILY_LABELS` range, else a dense product (any other GEMM:
    the projections and MLPs) or the rest."""
    names = set(FAMILY_LABELS.values())
    label = None
    while e is not None:
        if e.name == "aten::_to_copy" and label is None:
            ins = getattr(e, "input_shapes", None) or [[]]
            if tuple(ins[0]) in shapes:
                return "weight casts (fp32 -> bf16 per use)"
        if e.name in names and label is None:
            label = e.name
        e = e.cpu_parent
    if label is None:
        return ("dense products" if any(w in kernel.lower()
                                        for w in GEMM_NAMES)
                else "rest (norms, rope, residuals)")
    return label


def profile_moe_request(torch, log, name, run, model):
    """Run ``run()`` (one MoE scoring request) twice under
    ``torch.profiler`` (:func:`profile_labelled_request`), with these
    groups:

    - K5: device events named ``flash_attention``;
    - weight casts: copies under an ``aten::_to_copy`` whose input has a
      parameter's shape (the per-use fp32 → bf16 casts);
    - expert products and the experts' elementwise work: under
      ``moe._experts`` and the shared expert's ``layers.mlp_block``;
    - router: ``moe.router_topk`` and the products made directly in
      ``moe.moe_block`` (its ``x @ router``);
    - dispatch/combine: ``moe._local_dispatch`` and ``moe._local_combine``
      (the sort, searchsorted, gathers and scatters);
    - unembed: ``layers.unembed``;
    - attention products: the other GEMMs (q, k, v, o);
    - rest: the other kernels, and device time no operator claimed."""
    profile_labelled_request(torch, log, name, run, model, MOE_LABELS,
                             classify_moe)


def profile_labelled_request(torch, log, name, run, model, labels,
                             classify):
    """Run ``run()`` (one scoring request) twice under ``torch.profiler``,
    the first as a warm-up, with each function of ``labels`` ((module,
    function) → label) under a ``record_function`` range of its label,
    and print the second run's device busy time, idle share and device
    time by group: K5 (device events named ``flash_attention``), and for
    every other kernel ``classify(operator event, kernel name, parameter
    shapes)`` of the operator that launched it; device time that no
    operator claimed goes to the rest."""
    import contextlib
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from repro_torch.models import layers, mamba2, moe

    modules = {"moe": moe, "layers": layers, "mamba2": mamba2}
    shapes = {tuple(p.shape) for p in model.parameters()}

    def labelled(label, fn):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    with contextlib.ExitStack() as stack:
        for (mod, attr), label in labels.items():
            mod = modules[mod]
            stack.enter_context(mock.patch.object(
                mod, attr, labelled(label, getattr(mod, attr))))
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                record_shapes=True,
                schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        log(f"  {name}: wall {wall_ms:.1f} ms (profiled); the profiler "
            "recorded no device time")
        return
    busy_us, span_us = busy_and_span(sorted(
        (e.time_range.start, e.time_range.end) for e in device))
    groups: dict[str, list] = {"K5 flash_attention": [0.0, 0]}
    for e in device:
        if "flash_attention_kernel" in e.name:
            g = groups["K5 flash_attention"]
            g[0] += e.time_range.end - e.time_range.start
            g[1] += 1
    stalls = 0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        if e.name in CUPTI_OVERHEAD:
            stalls += 1
            continue
        for kern in e.kernels:
            if "flash_attention_kernel" in kern.name:
                continue
            g = groups.setdefault(classify(e, kern.name, shapes), [0.0, 0])
            g[0] += kern.duration
            g[1] += 1
    device_us = sum(e.time_range.end - e.time_range.start for e in device)
    claimed = sum(g[0] for g in groups.values())
    rest = groups.setdefault("rest (norms, rope, residuals)", [0.0, 0])
    rest[0] += max(0.0, device_us - claimed)
    log(f"  {name} (one profiled request): wall {wall_ms:.1f} ms, device "
        f"span {span_us / 1e3:.1f} ms, busy {busy_us / 1e3:.1f} ms; idle "
        f"share of span {1 - busy_us / span_us:.3f}, of wall "
        f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f}; {len(device)} "
        f"kernels, {device_us / 1e3:.1f} ms of kernel time "
        f"({claimed / 1e3:.1f} ms claimed by an operator; {stalls} "
        "launches stalled on a full queue)")
    for group, (us, count) in sorted(groups.items(),
                                     key=lambda kv: -kv[1][0]):
        log(f"    {group}: {us / 1e3:.1f} ms over {count} launches "
            f"({us / device_us:.3f} of kernel time)")


# Thresholds of the paper's Fig. 11 sweeps (the reference's own:
# modeled_best_threshold and modeled_best_sddmm_threshold).
FIG11_SPMM = tuple(range(1, 10))
FIG11_SDDMM = (1, 8, 16, 24, 32, 48, 64, 129)
PLAN_FIELDS = ("threshold", "bk", "ts_tile", "ts", "cs")

_FIG11_A = None   # the worker process's matrix (set by _fig11_init)


def _fig11_init(src, m, k, indptr, indices, data):
    """Initializer of a Fig.-11 plan worker: the port on its path and the
    matrix, sent once per worker."""
    global _FIG11_A
    sys.path.insert(0, src)
    from repro_torch.sparse import SparseCSR

    _FIG11_A = SparseCSR(m, k, indptr, indices, data)


def _fig11_plan(op, threshold):
    """One plan of a Fig.-11 sweep: the operator's defaults at
    ``threshold``, as ``modeled_best_threshold`` builds it."""
    from repro_torch.core import preprocess

    build = (preprocess.preprocess_spmm if op == "spmm"
             else preprocess.preprocess_sddmm)
    return build(_FIG11_A, threshold)


def fields(cfg):
    """A config's plan-shaping fields, as a dict."""
    return {f: getattr(cfg, f) for f in PLAN_FIELDS}


def tuned_phase(torch, np, log, fail, compare, tol_kind, *, spec0, a_mix,
                graph, norm, spmm_mix, sddmm_mix, b_mix, x_mix, y_mix, gcn,
                agnn, requests, x_train, labels, latency, trained):
    """Phase 6: the tuned path (``tune="model"``, ``tune="search"`` with
    its PlanCache, ``reorder="auto"``) at full size, through K1-K4.

    ``spec0`` is the base spec (the card's defaults). Returns the launch
    counts of the tuned path: those of (a)'s model-tuned operators, (c)'s
    ``tune="search"`` constructions and applies, and (d)'s GraphOps and
    ``reorder="auto"`` operators. Every count is set to 0 at the phase's
    start, and each part's counts are taken as it ends; the Fig. 11
    sweep and the applies of phase 2's literal-config operators, made only
    to compare with, are logged apart and left out."""
    import concurrent.futures
    import multiprocessing
    import os
    import tempfile
    from unittest import mock

    from repro_torch import kernels
    from repro_torch.core import preprocess
    from repro_torch.core.formats import PlanArrays, _host_arrays
    from repro_torch.core.sddmm import LibraSDDMM
    from repro_torch.core.spmm import LibraSpMM
    from repro_torch.core.threshold import (
        HardwareModel,
        empirical_threshold,
        model_sddmm_time,
        model_spmm_time,
    )
    from repro_torch.core.windows import num_windows
    from repro_torch.kernels.ops import sddmm_apply, spmm_apply
    from repro_torch.models.gnn import GraphOps, train_step
    from repro_torch.obs.trace import Tracer, use_tracer
    from repro_torch.tune import (
        PlanCache,
        sddmm_candidates,
        search,
        spmm_candidates,
    )

    t_phase = time.perf_counter()
    dev = spec0.torch_device()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    counts_at, last = {}, kernels.launch_counts()
    path = {k: 0 for k in last}

    def mark(label, on_path=True):
        """Take the launches since the last mark as part ``label``'s; they
        count towards the tuned path's when ``on_path``."""
        nonlocal last
        torch.cuda.synchronize()
        now = kernels.launch_counts()
        counts_at[label] = {k: now[k] - last[k] for k in now
                            if k != "flash_attention"}
        if on_path:
            for k in now:
                path[k] += now[k] - last[k]
        last = now
        log(f"phase 6: {label} done at {time.perf_counter() - t_phase:.1f} "
            "s of the phase")

    # (b)'s plans build in worker processes while (a) runs here: the
    # mixed matrix's SDDMM plan takes most of 20 s of host time each.
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=ctx, initializer=_fig11_init,
            initargs=(str(ROOT / "src"), a_mix.m, a_mix.k, a_mix.indptr,
                      a_mix.indices, a_mix.data)) as pool:
        futures = {("sddmm", t): pool.submit(_fig11_plan, "sddmm", t)
                   for t in FIG11_SDDMM}
        futures.update({("spmm", t): pool.submit(_fig11_plan, "spmm", t)
                        for t in FIG11_SPMM})

        # (a) The analytical tuner on the card's model: its picks on the
        # mixed matrix must be phase 2's literal configs, and its plans
        # and applies those of phase 2's operators.
        log(f"phase 6 (a): tune='model' on the mixed matrix (H100 model "
            f"{HardwareModel()}); Fig. 11 plans building in {workers} "
            "worker processes")
        tr = Tracer()
        t = time.perf_counter()
        with use_tracer(tr):
            spmm_model = LibraSpMM(a_mix, spec=spec0.replace(
                tune="model", tune_n=256))
            sddmm_model = LibraSDDMM(a_mix, spec=spec0.replace(
                tune="model", tune_kf=128))
        log(f"  host: both model-tuned plans {time.perf_counter() - t:.1f} s")
        for span in tr.to_dict():
            log(f"  {span['name']} {span['attrs']['op']}: "
                + ", ".join(f"{k}={v}" for k, v in span["attrs"].items()
                            if k != "op")
                + f" ({span['dur_s'] * 1e3:.1f} ms)")
        mark("(a) model-tuned builds")
        for label, op, literal, want_op, args in (
                ("LibraSpMM n=256", spmm_model, MIX_SPMM_CFG, spmm_mix,
                 (b_mix,)),
                ("LibraSDDMM kf=128", sddmm_model, MIX_SDDMM_CFG, sddmm_mix,
                 (x_mix, y_mix))):
            got = fields(op.tune_config)
            log(f"  {label}: model pick {got} (literal {literal})")
            if got != literal:
                fail(f"phase 6 (a): the model's {label} pick {got} is not "
                     f"the literal config {literal}")
            host, want = _host_arrays(op.plan), _host_arrays(want_op.plan)
            if list(host) != list(want) or not all(
                    np.array_equal(host[k], want[k]) for k in host):
                fail(f"phase 6 (a): the model's {label} plan differs from "
                     "the literal config's")
            # index_add_ adds in any order on the card; its deterministic
            # form makes the two applies comparable bit for bit. The
            # literal-config apply is no run of the tuned path.
            torch.use_deterministic_algorithms(True)
            try:
                ref_out = want_op(*args)
                mark(f"(a) {label}, literal config", on_path=False)
                out = op(*args)
                mark(f"(a) {label}, model-tuned")
            finally:
                torch.use_deterministic_algorithms(False)
            if not torch.equal(out, ref_out):
                fail(f"phase 6 (a): the model's {label} apply differs from "
                     "the literal config's")
            log(f"  {label}: plan equal key for key, apply equal bit for "
                f"bit ({tuple(out.shape)})")
        del spmm_model, sddmm_model, out, ref_out

        t = time.perf_counter()
        plans = {key: fut.result() for key, fut in futures.items()}
        log(f"phase 6 (b): Fig. 11 plans gathered after another "
            f"{time.perf_counter() - t:.1f} s")

    # (b) The paper's Fig. 11 on the H100: the cost model's time and the
    # card's (host clock around 10 applies after a synchronized warm-up,
    # empirical_threshold, in two passes over the thresholds) at each
    # threshold, on the same plans.
    hw = HardwareModel()
    nwin = num_windows(a_mix.m)
    sweeps = (
        ("SpMM n=256", "spmm", FIG11_SPMM,
         lambda p: model_spmm_time(p, 256, hw),
         lambda arrs: spmm_apply(arrs, b_mix, m=a_mix.m, nwin=nwin),
         MIX_SPMM_CFG["threshold"]),
        ("SDDMM kf=128", "sddmm", FIG11_SDDMM,
         lambda p: model_sddmm_time(p, 128, hw),
         lambda arrs: sddmm_apply(arrs, x_mix, y_mix, nnz=a_mix.nnz),
         MIX_SDDMM_CFG["threshold"]))
    for label, op, thresholds, model_time, apply_op, pick in sweeps:
        modeled = {t: model_time(plans[op, t]) for t in thresholds}
        passes = [empirical_threshold(
            lambda t: PlanArrays(plans[op, t], dev).for_backend("cuda"),
            apply_op, thresholds, reps=10) for _ in range(2)]
        log(f"phase 6 (b): Fig. 11 {label} on the mixed matrix "
            "(threshold: modeled ms, measured ms in passes 1 and 2, "
            "Tensor Core share)")
        for t in thresholds:
            log(f"  {t:4d}: {modeled[t] * 1e3:9.4f}  "
                + "  ".join(f"{m[t] * 1e3:9.4f}" for m in passes)
                + f"  {plans[op, t].meta['tc_ratio']:.4f}")
        best_m = min(modeled, key=lambda t: (modeled[t], t))
        for i, measured in enumerate(passes, 1):
            best_e = min(measured, key=lambda t: (measured[t], t))
            log(f"  {label} pass {i}: modeled argmin {best_m}, the card's "
                f"break-even (measured argmin) {best_e}; the tuner's pick "
                f"{pick} measures {measured[pick] * 1e3:.4f} ms against the "
                f"best {measured[best_e] * 1e3:.4f} ms")
    del plans
    mark("(b) Fig. 11 sweep", on_path=False)
    log(f"phase 6 (b): Fig. 11 sweep launches (not the tuned path's): "
        f"{counts_at['(b) Fig. 11 sweep']}")

    timer_calls = [0]
    real_timer = search.median_timer

    def counted_timer(*args, **kw):
        timer = real_timer(*args, **kw)

        def count(fn):
            timer_calls[0] += 1
            return timer(fn)
        return count

    with tempfile.TemporaryDirectory(prefix="repro_torch_tune_") as root:
        # (c) The empirical search on the card, into a fresh PlanCache,
        # then the same construction again: a cache hit that times nothing.
        pc = PlanCache(root)
        searches = (
            ("mixed LibraSpMM n=256", LibraSpMM, a_mix,
             dict(tune_n=256), lambda a: spmm_candidates(
                 a, n=256, mode="hybrid", threshold=None, backend="cuda"),
             (b_mix,)),
            ("mixed LibraSDDMM kf=128", LibraSDDMM, a_mix,
             dict(tune_kf=128), lambda a: sddmm_candidates(
                 a, kf=128, mode="hybrid", threshold=None, backend="cuda"),
             (x_mix, y_mix)))
        for label, cls, a, widths, grid, args in searches:
            spec = spec0.replace(tune="search", tune_backend="cuda",
                                 tune_cache=pc, **widths)
            tr = Tracer()
            timer_calls[0] = 0
            t = time.perf_counter()
            with use_tracer(tr), mock.patch.object(
                    search, "median_timer", counted_timer):
                op = cls(a, spec=spec)
            build_s = time.perf_counter() - t
            cands = grid(a)
            # The search nests under the build's plan.build > plan.tune.
            todo, found = tr.to_dict(), []
            while todo:
                node = todo.pop()
                todo.extend(node.get("children", ()))
                found += [node] if node["name"] == "tune.search" else []
            (span,) = found
            events = [e["attrs"] for e in span["events"]]
            if timer_calls[0] != len(cands) or len(events) != len(cands):
                fail(f"phase 6 (c): {label}: {timer_calls[0]} timings of "
                     f"{len(cands)} candidates")
            best = span["attrs"]["best"]
            log(f"phase 6 (c): {label}: tune='search' on the card, "
                f"{len(cands)} candidates, {build_s:.1f} s on the host "
                "(median of 3 applies each, host clock)")
            for i, (cand, ev) in enumerate(zip(cands, events)):
                tag = {0: " (default)", 1: " (model)"}.get(i, "")
                log(f"  #{i}{tag}: {fields(cand)} "
                    f"{ev['seconds'] * 1e3:.4f} ms"
                    + ("  <- pick" if i == best else ""))
            if fields(op.tune_config) != fields(cands[best]):
                fail(f"phase 6 (c): {label}: the operator's config "
                     f"{fields(op.tune_config)} is not the pick")
            with torch.no_grad():
                compare(f"searched {label} against backend='torch'",
                        op(*args), op(*args, backend="torch"),
                        tol_kind(op.plan))
            hits = pc.stats()["hits"]
            timer_calls[0] = 0
            t = time.perf_counter()
            with mock.patch.object(search, "median_timer", counted_timer):
                again = cls(a, spec=spec)
            if (timer_calls[0] or again.tune_config.source != "cache"
                    or pc.stats()["hits"] != hits + 1
                    or fields(again.tune_config) != fields(op.tune_config)):
                fail(f"phase 6 (c): {label}: the second construction timed "
                     f"{timer_calls[0]} candidates (source "
                     f"{again.tune_config.source})")
            log(f"  second construction: a cache hit, 0 timings, "
                f"{time.perf_counter() - t:.1f} s on the host (the plan "
                "build)")
            del op, again
        log(f"phase 6 (c): PlanCache {pc.stats()}")
        mark("(c)")

        # (d) The GNN path tuned: GraphOps with tune="model" and
        # reorder="auto", three requests and two training steps of each
        # model, against the plain path and phases 3 and 5 (tune="off").
        t = time.perf_counter()
        gops_t = GraphOps(graph, spec=spec0.replace(
            tune="model", reorder="auto", tune_cache=root))
        log(f"phase 6 (d): GraphOps(tune='model', reorder='auto') plans "
            f"A, A^T, SDDMM(A) {time.perf_counter() - t:.1f} s on the host")
        for leg, arrs, cfg in (("A", gops_t.arrs, gops_t.cfg),
                               ("A^T", gops_t.arrs_t, gops_t.cfg_t),
                               ("SDDMM(A)", gops_t.arrs_sd, gops_t.cfg_sd)):
            rep = arrs.plan.meta["reorder"]
            log(f"  leg {leg}: reorder {'on' if rep['enabled'] else 'off'} "
                f"(projected gain {rep.get('gain', 0.0):+.4f}); config "
                f"{fields(cfg)}; tc_ratio {arrs.plan.meta['tc_ratio']:.4f}")
        plain = copy.copy(gops_t)
        plain.backend = "torch"
        tuned_ms = {"GCN": [], "AGNN": []}
        for name, model, args in (("GCN", gcn, (norm,)), ("AGNN", agnn, ())):
            kind = tol_kind(gops_t.arrs.plan, *(
                [gops_t.arrs_sd.plan] if name == "AGNN" else []))
            with torch.no_grad():
                for i, x in enumerate(requests):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = model(gops_t, x, *args)
                    torch.cuda.synchronize()
                    tuned_ms[name].append((time.perf_counter() - t) * 1e3)
                    compare(f"tuned {name} request {i} logits against "
                            "backend='torch'", out, model(plain, x, *args),
                            kind)
        step_ms = {}
        for name, model0, args in (("GCN", gcn, (norm,)),
                                   ("AGNN", agnn, ())):
            model = copy.deepcopy(model0)
            step_ms[name], losses = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                loss = train_step(model, gops_t, x_train, labels, *args,
                                  lr=0.2)
                torch.cuda.synchronize()
                step_ms[name].append((time.perf_counter() - t) * 1e3)
                losses.append(loss.item())
            if not all(np.isfinite(losses)):
                fail(f"phase 6 (d): tuned {name} losses {losses}")
            off = trained[f"{name} reorder off"][1]
            on = trained[f"{name} reorder on"][1]
            log(f"phase 6 (d): {name} [128, 256, 256, 40] tuned: requests "
                + ", ".join(f"{v:.2f}" for v in tuned_ms[name])
                + " ms (phase 3, tune='off': "
                + ", ".join(f"{v:.2f}" for v in latency[name])
                + "); training steps "
                + ", ".join(f"{v:.2f}" for v in step_ms[name])
                + " ms (phase 5, tune='off', steady: reorder off "
                + ", ".join(f"{v:.2f}" for v in off[1:]) + "; on "
                + ", ".join(f"{v:.2f}" for v in on[1:]) + "); losses "
                + ", ".join(repr(v) for v in losses))
        del gops_t, plain, out
        mark("(d) GNN")

        # reorder="auto" on the mixed matrix declines, and a second build
        # takes the cached decline without the sketch pass.
        spec = spec0.replace(reorder="auto", tune_n=256, tune_cache=root)
        t = time.perf_counter()
        first = LibraSpMM(a_mix, spec=spec)
        first_s = time.perf_counter() - t
        with mock.patch.object(preprocess, "reorder_rows",
                               wraps=preprocess.reorder_rows) as sketch:
            t = time.perf_counter()
            second = LibraSpMM(a_mix, spec=spec)
            second_s = time.perf_counter() - t
        rep = first.plan.meta["reorder"]
        if rep["enabled"] or sketch.call_count or \
                second.plan.meta["reorder"] != rep:
            fail(f"phase 6 (d): mixed reorder='auto' {rep}, second build "
                 f"sketched {sketch.call_count} times")
        log(f"phase 6 (d): mixed LibraSpMM reorder='auto': declined (gain "
            f"{rep['gain']:+.4f}), {first_s:.1f} s; again from the cached "
            f"decision without sketching, {second_s:.1f} s")
        with torch.no_grad():
            mark("(d) mixed builds")
            want = spmm_mix(b_mix)
            mark("(d) mixed, phase 2's operator", on_path=False)
            compare("mixed LibraSpMM reorder='auto' against phase 2's",
                    second(b_mix), want, "tf32")
        del first, second, want
    mark("(d) mixed")
    log(f"phase 6 (tuned path) launches: {path}; by part: {counts_at}")
    missing = [k for k, v in path.items()
               if v <= 0 and k != "flash_attention"]
    if missing:
        fail(f"kernels never launched on the tuned path: {missing}")
    log(f"phase 6: {time.perf_counter() - t_phase:.1f} s")
    return path


def serving_phase(torch, np, log, fail, compare, *, dev, graph, a_mix, norm,
                  gcn, agnn, gops_plain, latency, median_ms, bound):
    """Phase 7: the serving path (``GNNService`` → ``SparseEngine`` →
    ``GraphRegistry`` → ``BatchedSpMM``/``BatchedSDDMM`` → K1–K4) at
    full width on phase 3's graph and weights.

    Returns the launch counts of the serving path: the served flushes of
    (b) scoring, (c) raw requests, (e) the fault storms and (f) the
    sampled flush, and (h)'s batched stacks; and the registry, service,
    engine, the eight scoring feature sets and the mixed tenant's matrix,
    which phase 8 serves beside. Every count is set to 0 at the phase's start and each
    part's counts are taken as it ends; the direct calls, plain-path
    references and (d)'s timings, made only to compare with, are logged
    apart and left out."""
    import tempfile
    import urllib.request

    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import spmm_apply
    from repro_torch.obs import calibrate
    from repro_torch.obs.ledger import PerfLedger
    from repro_torch.serve import (
        FaultPlan,
        FaultRule,
        GNNService,
        GraphRegistry,
        ResiliencePolicy,
        ServeError,
        SparseEngine,
        as_csr,
    )

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    counts_at, last = {}, kernels.launch_counts()
    path = {k: 0 for k in last}

    def mark(label, on_path=True):
        """Take the launches since the last mark as part ``label``'s; they
        count towards the serving path's when ``on_path``."""
        nonlocal last
        torch.cuda.synchronize()
        now = kernels.launch_counts()
        counts_at[label] = {k: now[k] - last[k] for k in now
                            if k != "flash_attention"}
        if on_path:
            for k in now:
                path[k] += now[k] - last[k]
        last = now
        log(f"phase 7: {label} done at {time.perf_counter() - t_phase:.1f} "
            f"s; launches {counts_at[label]}"
            + ("" if on_path else " (not on the path)"))

    def clean(eng, part):
        """(a)-(d) serve every request on the fast path: no failure and no
        degraded answer."""
        h = eng.health()
        if h["failures"] or h["degraded_served"] or h["errors_returned"]:
            fail(f"phase 7 {part}: serve_failures_total {h['failures']}, "
                 f"serve_degraded_served_total {h['degraded_served']}, "
                 f"errors {h['errors_returned']}")

    def ints(gen, *shape):
        return torch.randint(-4, 5, shape, generator=gen,
                             device=dev).float()

    # (a) Registration at the registry's default tune="model"; widths of
    # 256 need a 256-wide bucket.
    reg = GraphRegistry(width_buckets=(32, 64, 128, 256), device=str(dev))
    eng = SparseEngine(reg)
    svc = GNNService(eng)
    for name, call in (("GCN", lambda: svc.register_gcn("gcn", graph, gcn)),
                       ("AGNN", lambda: svc.register_agnn("agnn", graph,
                                                          agnn))):
        t = time.perf_counter()
        call()
        log(f"phase 7 (a): {name} registered in "
            f"{time.perf_counter() - t:.1f} s (host)")
    # The raw-operator tenant: the mixed matrix with non-zero integer
    # values in [-4, 4], so served and direct results compare bit for bit.
    rng = np.random.default_rng(3)
    mixed = as_csr(a_mix, (rng.integers(1, 5, a_mix.nnz) * rng.choice(
        [-1, 1], a_mix.nnz)).astype(np.float32))
    t = time.perf_counter()
    reg.register(mixed, name="mixed", ops=("spmm", "sddmm"))
    log(f"phase 7 (a): mixed tenant registered in "
        f"{time.perf_counter() - t:.1f} s (host)")
    entries = {n: reg.resolve(n) for n in ("gcn::graph", "agnn::graph",
                                           "mixed")}
    for n, entry in entries.items():
        for kind, op in sorted(entry.ops.items()):
            cfg = op.op.tune_config
            log(f"  {n} {kind}: {cfg}; Tensor Core share "
                f"{op.op.tc_ratio:.4f}")
    t = time.perf_counter()
    warmed = {op: reg.warm("mixed", op) for op in ("spmm", "sddmm")}
    mark("(a) warm-up of the mixed tenant", on_path=False)
    log(f"phase 7 (a): warm {warmed} applies prepared in "
        f"{time.perf_counter() - t:.1f} s; exec caches: spmm "
        f"{len(entries['mixed'].op('spmm').op._apply_cache)}, sddmm "
        f"{len(entries['mixed'].op('sddmm')._cache)}; registry "
        f"{reg.stats()}")

    # (b) Scoring: three rounds of 8 GCN and 8 AGNN requests, one flush a
    # round. The same 16 seeded feature sets every round; every third
    # request asks for 1,000 seeded node ids.
    gen = torch.Generator(dev).manual_seed(700)
    feats = [torch.randn(graph.m, 128, generator=gen, device=dev)
             for _ in range(8)]
    ids = torch.randperm(graph.m, generator=gen, device=dev)[:1000]
    subs = [(model, i, ids if i % 3 == 2 else None)
            for model in ("gcn", "agnn") for i in range(8)]
    rounds = []
    with torch.no_grad():
        for r in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rids = [svc.submit(m, feats[i], node_ids=nid)
                    for m, i, nid in subs]
            out = svc.flush()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            rounds.append((ms, [out[rid] for rid in rids]))
            log(f"phase 7 (b): round {r}: flush {ms:.2f} ms for "
                f"{len(subs)} requests, {ms / len(subs):.2f} ms a request, "
                f"{len(subs) / ms * 1e3:.1f} requests/s")
        mark("(b) scoring, three rounds")
        clean(eng, "(b)")
        log(f"phase 7 (b): phase 3's direct request latency ms: GCN "
            + ", ".join(f"{v:.2f}" for v in latency["GCN"]) + "; AGNN "
            + ", ".join(f"{v:.2f}" for v in latency["AGNN"]))
        log("phase 7 (b): every score against the plain backend='torch' "
            "path (the same weights)")
        for k, (model, i, nid) in enumerate(subs):
            want = (gcn(gops_plain, feats[i], norm) if model == "gcn"
                    else agnn(gops_plain, feats[i]))
            if nid is not None:
                want = want[nid]
            for r, (_, outs) in enumerate(rounds):
                got = outs[k]
                if isinstance(got, ServeError):
                    fail(f"phase 7 (b): {model} request {k} round {r}: "
                         f"{got}")
                compare(f"{model} request {i} round {r}"
                        + (" (node ids)" if nid is not None else ""),
                        got, want, "tf32")
        mark("(b) plain-path references", on_path=False)

        # Where a served request's time goes: one flush of each model's
        # eight requests under torch.profiler (after a warm-up flush).
        def flush_of(model):
            def run():
                for m, i, nid in subs:
                    if m == model:
                        svc.submit(m, feats[i], node_ids=nid)
                svc.flush()
            return run

        for model in ("gcn", "agnn"):
            profile_request(torch, log,
                            f"served {model.upper()} flush of 8 requests",
                            flush_of(model), classify_gnn)
        mark("(b) profiled flushes, two of each model")
        clean(eng, "(b)")

        # One more flush under deterministic algorithms (the SpMM
        # combine's index_add_ adds in any order on the card), against the
        # registered operators called directly, layer by layer, as the
        # engine calls them: panels zero-padded to their bucket width.
        # All sixteen scorings of the rounds above, GCN and AGNN.
        # warn_only: cuBLAS, which runs the dense h @ W of both sides,
        # refuses deterministic mode without CUBLAS_WORKSPACE_CONFIG; on
        # one stream it gives the same bits for the same call.
        det = list(subs)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t = time.perf_counter()
            rids = [svc.submit(m, feats[i], node_ids=nid)
                    for m, i, nid in det]
            out = svc.flush()
            torch.cuda.synchronize()
            log(f"phase 7 (b): deterministic flush of {len(det)} requests "
                f"{(time.perf_counter() - t) * 1e3:.2f} ms")
            mark("(b) scoring under deterministic algorithms")
            direct = {"gcn": direct_gcn, "agnn": direct_agnn}
            for rid, (model, i, nid) in zip(rids, det):
                want = direct[model](reg, svc, feats[i])
                if nid is not None:
                    want = want[nid]
                if not torch.equal(out[rid], want):
                    fail(f"phase 7 (b): {model} request {i} served differs "
                         "from the direct layer-by-layer calls")
            mark("(b) direct layer-by-layer calls", on_path=False)
        finally:
            torch.use_deterministic_algorithms(False)
        clean(eng, "(b)")
        log(f"phase 7 (b): {len(det)} served scores equal the direct calls "
            "bit for bit (deterministic algorithms)")

    # (c) Raw requests on the mixed tenant: SpMM panels of several widths,
    # with and without edge values, and SDDMM pairs, against direct calls
    # of the registered operators on the same (padded) panels.
    gen = torch.Generator(dev).manual_seed(701)
    m_entry = entries["mixed"]
    op_m, sd_m = m_entry.op("spmm").op, m_entry.op("sddmm").op
    raw = []
    for w in (24, 32, 64, 100, 128):
        raw.append(("spmm", w, dict(b=ints(gen, mixed.k, w))))
        raw.append(("spmm", w, dict(b=ints(gen, mixed.k, w),
                                    edge_vals=ints(gen, mixed.nnz))))
    for w in (32, 64, 128):
        raw.append(("sddmm", w, dict(x=ints(gen, mixed.m, w),
                                     y=ints(gen, mixed.k, w))))
    eng_c = SparseEngine(reg)
    torch.use_deterministic_algorithms(True)
    try:
        rids = [eng_c.submit("mixed", op, **kw) for op, _, kw in raw]
        out = eng_c.flush()
        mark("(c) raw requests")
        for rid, (op, w, kw) in zip(rids, raw):
            bw = reg.width_bucket(w)
            pad = (lambda t: torch.nn.functional.pad(t, (0, bw - w)))
            if op == "sddmm":
                want = sd_m(pad(kw["x"]), pad(kw["y"]))
            elif "edge_vals" in kw:
                arrs = ref.revalue_spmm_arrays(op_m.arrays.for_backend(
                    "cuda", revalue=True), kw["edge_vals"])
                want = spmm_apply(arrs, pad(kw["b"]), m=op_m.m,
                                  nwin=op_m.nwin)[:, :w]
            else:
                want = op_m(pad(kw["b"]))[:, :w]
            if not torch.equal(out[rid], want):
                err = (out[rid] - want).abs().max().item()
                fail(f"phase 7 (c): {op} width {w}"
                     + (" edge_vals" if "edge_vals" in kw else "")
                     + f": served differs from the direct call (max|err| "
                     f"{err})")
        mark("(c) direct calls", on_path=False)
    finally:
        torch.use_deterministic_algorithms(False)
    clean(eng_c, "(c)")
    st = eng_c.stats()
    log(f"phase 7 (c): {len(raw)} raw requests equal the direct calls bit "
        f"for bit; padding waste {st['padding_waste']:.4f}, occupancy "
        f"{st['bucket_occupancy']:.4f}, exec-cache hits "
        f"{st['exec_cache_hits']}, misses {st['exec_cache_misses']}, "
        f"applies {st['panels_executed']}")

    # (d) One packed apply of p panels against p single applies (w = 64),
    # on the graph and the mixed matrix: what PACK_BUDGET_BYTES should
    # price on the card.
    from repro_torch.serve import registry as registry_mod

    gen = torch.Generator(dev).manual_seed(702)
    for label, n, entry in (("graph (GCN)", "gcn::graph",
                             entries["gcn::graph"]),
                            ("mixed", "mixed", m_entry)):
        op = entry.op("spmm").op
        log(f"phase 7 (d): {label}: pack_limit at w=64 is "
            f"{reg.pack_limit(entry, 64)} (PACK_BUDGET_BYTES "
            f"{registry_mod.PACK_BUDGET_BYTES}, {entry.spmm_vpu_elems} "
            "CUDA-core elements)")
        for p in (2, 4, 8):
            wide = torch.randn(op.k, 64 * p, generator=gen, device=dev)
            singles = [wide[:, 64 * j:64 * (j + 1)].contiguous()
                       for j in range(p)]
            packed_ms = median_ms(lambda: op(wide))
            single_ms = median_ms(lambda: [op(b) for b in singles])
            log(f"  {label} p={p}: packed {packed_ms:.4f} ms, {p} singles "
                f"{single_ms:.4f} ms (ratio {packed_ms / single_ms:.3f})")
        del wide, singles
    mark("(d) packed against single applies", on_path=False)
    clean(eng, "(d)")

    # (e) A seeded fault storm over the mixed tenant's sites; every rid
    # gets its result or a typed ServeError, and each result equals the
    # unfaulted one bit for bit. The same seed twice gives the same
    # histograms. Then a plan that latches the fast and single rungs
    # serves every request on the unsegmented rung: K1-K4 over the
    # compact tables.
    gen = torch.Generator(dev).manual_seed(703)
    storm_subs = [("mixed", "spmm", dict(b=ints(gen, mixed.k, w)))
                  for w in (32, 64, 64, 128)]
    storm_subs += [("mixed", "spmm", dict(b=ints(gen, mixed.k, 32),
                                          edge_vals=ints(gen, mixed.nnz)))]
    storm_subs += [("mixed", "sddmm", dict(x=ints(gen, mixed.m, w),
                                           y=ints(gen, mixed.k, w)))
                   for w in (32, 128)]
    sites = [("mixed", op, s) for op in ("spmm", "sddmm")
             for s in ("fast", "single", "unsegmented")]
    torch.use_deterministic_algorithms(True)
    try:
        want = SparseEngine(reg).serve(storm_subs)
        want = [want[k] for k in sorted(want)]
        mark("(e) unfaulted answers", on_path=False)

        def storm(plan, label):
            e = SparseEngine(reg, faults=plan, sleep=lambda s: None,
                             resilience=ResiliencePolicy(
                                 validate=True, attempts_per_rung=2))
            got = e.serve(storm_subs)
            got = [got[k] for k in sorted(got)]
            mark(f"(e) {label}")
            enc = []
            for j, (g, w) in enumerate(zip(got, want)):
                if isinstance(g, ServeError):
                    enc.append(("error", type(g).__name__, g.reason))
                elif not torch.equal(g, w):
                    fail(f"phase 7 (e) {label}: request {j} differs from "
                         "its unfaulted answer")
                else:
                    enc.append("ok")
            h = e.health()
            hist = {k: h[k] for k in ("failures", "degraded_served",
                                      "retry_hist", "retries",
                                      "errors_returned", "faults_injected")}
            log(f"phase 7 (e) {label}: fired {plan.log}; results {enc}; "
                f"{hist}")
            return enc, hist, list(plan.log)

        kinds = ("raise", "resource", "nan")
        runs = [storm(FaultPlan.storm(2026, sites, n_faults=8, max_k=3,
                                      kinds=kinds, times=(1, 2, -1)),
                      f"storm run {i}") for i in range(2)]
        if runs[0] != runs[1]:
            fail("phase 7 (e): the same seed gave different histograms")
        if not runs[0][2]:
            fail("phase 7 (e): the storm fired no fault")
        before = kernels.launch_counts()
        _, hist, _ = storm(FaultPlan([
            FaultRule(kth=1, graph="mixed", strategy=s, times=-1)
            for s in ("fast", "single")]), "fast and single latched")
        after = kernels.launch_counts()
        unseg = {k: after[k] - before[k] for k in after
                 if k != "flash_attention"}
        log(f"phase 7 (e): unsegmented rung launches (compact tables): "
            f"{unseg}")
        for _, h_, _ in runs:
            if "torch" in h_["degraded_served"]:
                fail("phase 7 (e): a request was served on the plain path")
        if hist["degraded_served"] != {"unsegmented": len(storm_subs)}:
            fail(f"phase 7 (e): expected every request on the unsegmented "
                 f"rung, got {hist['degraded_served']}")
        if not all(unseg.values()):
            fail(f"phase 7 (e): a kernel never launched on the unsegmented "
                 f"rung: {unseg}")
    finally:
        torch.use_deterministic_algorithms(False)

    # (f) One flush with every packed SpMM apply sampled into a perf ledger
    # under a temporary directory; the H100 model's measured/predicted.
    with tempfile.TemporaryDirectory() as tmp:
        led = PerfLedger(tmp)
        eng_f = SparseEngine(reg, ledger=led, sample_every=1)
        gen = torch.Generator(dev).manual_seed(704)
        for _ in range(4):
            eng_f.submit("gcn::graph", "spmm",
                         b=torch.randn(graph.k, 256, generator=gen,
                                       device=dev))
            for w in (64, 128):
                eng_f.submit("mixed", "spmm",
                             b=torch.randn(mixed.k, w, generator=gen,
                                           device=dev))
        eng_f.flush()
        mark("(f) sampled flush")
        clean(eng_f, "(f)")
        samples = led.samples()
        for s_ in samples:
            log(f"  sample {s_['sig'][:10]} w={s_['width']}: wall "
                f"{s_['wall_s'] * 1e3:.4f} ms, predicted "
                f"{s_['predicted_s'] * 1e3:.4f} ms, ratio "
                f"{s_['wall_s'] / s_['predicted_s']:.2f}, analytic "
                f"{s_['hlo_flops'] / 1e9:.3f} GFLOP "
                f"{s_['hlo_bytes'] / 1e6:.1f} MB")
        rep = calibrate.calibration_report(samples)
        log(f"phase 7 (f): {len(samples)} samples; calibration "
            + "; ".join(f"{k}: n={v['n']} geomean measured/predicted "
                        f"{v['geomean_ratio']:.3f}"
                        for k, v in rep["regimes"].items()))

    # (g) The scrape endpoint.
    srv = eng.serve_http(port=0)
    try:
        def get(path):
            with urllib.request.urlopen(srv.url + path, timeout=30) as r:
                return r.read().decode()

        body = get("/metrics")
        series = [ln for ln in body.splitlines()
                  if ln and not ln.startswith("#")]
        health = json.loads(get("/health"))
        memory = json.loads(get("/memory"))
        stats = json.loads(get("/stats"))
    finally:
        srv.stop()
    uploaded = sum(v.numel() * v.element_size()
                   for e in entries.values() for op in e.ops.values()
                   for _, v in op.op.arrays.resident_items())
    log(f"phase 7 (g): /metrics {len(series)} series; /health breakers "
        f"{sorted(health['breakers'])}; /stats served {stats['served']}; "
        f"/memory resident {memory['resident_bytes']} B "
        f"({memory['by_view']}), uploaded tensors {uploaded} B")
    if memory["resident_bytes"] != uploaded:
        fail(f"phase 7 (g): /memory {memory['resident_bytes']} B != the "
             f"uploaded tensors' {uploaded} B")

    # (h) The batched form of K1-K4 on the registered tables.
    stack_phase(torch, log, fail, compare, dev=dev,
                tenants={"graph (AGNN)": entries["agnn::graph"],
                         "mixed": m_entry},
                mark=mark, median_ms=median_ms, bound=bound)

    missing = [k for k, v in path.items() if k != "flash_attention" and v <= 0]
    log(f"phase 7 (serving path) launches: {path}")
    if missing:
        fail(f"kernels never launched on the serving path: {missing}")
    log(f"phase 7: wall time {time.perf_counter() - t_phase:.1f} s")
    return path, dict(reg=reg, svc=svc, eng=eng, feats=feats, mixed=mixed)


STACK_PANELS = (1, 2, 4, 8)
STACK_WIDTH = 128
STACK_STREAMS = {"spmm_mxu": 1, "spmm_vpu": 1, "sddmm_mxu": 1,
                 "sddmm_vpu": 1}


def distinct_rows(torch, *ids) -> int:
    """Rows of a gathered operand that the index tensors ``ids`` name
    together: what a kernel must read at least once."""
    return int(torch.unique(torch.cat(
        [i.reshape(-1).long() for i in ids])).numel())


def real_prefix(torch, table, lengths):
    """The entries of a ``(rows, slots)`` table within each row's real
    length."""
    slot = torch.arange(table.shape[-1], device=table.device)
    return table[slot < lengths[..., None]]


def batched_kernel_rows(torch, kernels, log, fail, median_ms, bound, *,
                        label, calls, p):
    """Each kernel's batched launch against its ``p`` single launches, at
    the shapes of one batched apply (random fp32): bit for bit where the
    kernel stores (K1 with unique ranks, K2, K3, K4), else within the
    fp32 tolerance, and both timed, beside the batched work's bound.
    ``calls`` maps a kernel name to ``(args, kw, element, nbytes, ops,
    kind)``: its batched arguments, ``element(i)`` giving element
    ``i``'s ``(args, kw)``, and the batched call's compulsory bytes and
    operations. Returns the timing rows."""
    rows = []
    for name, (args, kw, element, nb, ops, kind) in calls.items():
        fn = getattr(kernels, name)
        out = fn(*args, **kw)
        stores = name != "spmm_mxu" or kw["unique_ranks"]
        for i in range(p):
            a_i, kw_i = element(i)
            one = fn(*a_i, **kw_i)
            if stores and not torch.equal(out[i], one):
                err = (out[i] - one).abs().max().item()
                fail(f"{label}: {name} element {i} of the batched launch "
                     f"differs from its single launch (max|err| {err})")
            if not stores and not torch.allclose(
                    out[i], one, rtol=FP32_RTOL,
                    atol=FP32_RTOL * one.abs().max().item()):
                fail(f"{label}: {name} element {i} outside the fp32 "
                     "tolerance of its single launch")
        del out, one
        singles = [element(i) for i in range(p)]
        ms = median_ms(lambda: fn(*args, **kw))
        loop_ms = median_ms(lambda: [fn(*a_i, **kw_i)
                                     for a_i, kw_i in singles])
        bound_ms, bound_by = bound(nb, ops, kind)
        log(f"  {name} [{label}, batch {p}]: batched {ms:.4f} ms, {p} "
            f"single launches {loop_ms:.4f} ms (ratio {ms / loop_ms:.3f}), "
            f"bound {bound_ms:.4f} ms by {bound_by} ({nb / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} G {kind} ops)"
            + ("" if stores else "; atomic adds: within the fp32 tolerance"))
        rows.append({"kernel": name, "label": label, "batch": p, "ms": ms,
                     "looped_ms": loop_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
    return rows


def _el(x, ndim, i):
    """Element ``i`` of a batched operand, or the shared operand itself."""
    return x[i] if x.dim() == ndim + 1 else x


def _copies(x, ndim, p):
    """How many copies of ``x`` a batch of ``p`` reads: ``p`` when it
    carries a batch axis (one an element), else 1 (shared)."""
    return p if x.dim() == ndim + 1 else 1


def spmm_kernel_calls(torch, t, b):
    """K1's and K2's batched calls of one SpMM apply over the tables ``t``
    (shared by the batch or each with a leading batch axis) and the dense
    stack ``b`` ``(p, k, n)``, for :func:`batched_kernel_rows`. Bytes:
    each table once (once an element when it has its own), each B row
    that a real entry names once a panel, and the outputs; operations 2 x
    real non-zeros x n a panel."""
    p, n = b.shape[0], b.shape[2]
    seg = "_seg" if "tc_seg_vals" in t else ""
    vals, cols = t[f"tc{seg}_vals"], t[f"tc{seg}_cols"]
    rank, lens = t["tc_seg_rank" if seg else "tc_rank"], t["tc_len"]
    n_active = (rank.shape[-1] if seg
                else t["tc_active_row"].shape[-1] // 8)
    unique = bool(seg)
    vseg = "_seg" if "vpu_seg_vals" in t else ""
    v2, c2, l2 = t[f"vpu{vseg}_vals"], t[f"vpu{vseg}_cols"], t["vpu_len"]

    def size(*ts):
        return sum(x.numel() * x.element_size() for x in ts)

    # Real entries over the distinct tables (every element's when the
    # column table has a batch axis); a value table a panel reads its
    # values once a panel.
    vec = real_prefix(torch, cols, lens)
    pairs = real_prefix(torch, c2, l2)
    real1 = int(torch.count_nonzero(vals)) * p // _copies(vals, 3, p)
    real2 = int(torch.count_nonzero(v2)) * p // _copies(v2, 2, p)
    rows1 = sum(distinct_rows(torch, real_prefix(
        torch, _el(cols, 2, i), _el(lens, 1, i))) for i in range(p))
    rows2 = sum(distinct_rows(torch, real_prefix(
        torch, _el(c2, 2, i), _el(l2, 1, i))) for i in range(p))
    b1 = (vec.numel() * (32 * _copies(vals, 3, p) // _copies(cols, 2, p)
                         + 4)
          + size(lens, rank) + rows1 * n * 4 + p * n_active * 8 * n * 4)
    b2 = (pairs.numel() * (4 * _copies(v2, 2, p) // _copies(c2, 2, p) + 4)
          + size(l2) + rows2 * n * 4 + p * c2.shape[-2] * n * 4)
    kw1 = dict(n_active=n_active, unique_ranks=unique)
    return {
        "spmm_mxu": (
            (vals, cols, rank, b), dict(kw1, seg_len=lens),
            lambda i: ((_el(vals, 3, i), _el(cols, 2, i), _el(rank, 1, i),
                        b[i]), dict(kw1, seg_len=_el(lens, 1, i))),
            b1, 2 * real1 * n, "tf32"),
        "spmm_vpu": (
            (v2, c2, b), dict(seg_len=l2),
            lambda i: ((_el(v2, 2, i), _el(c2, 2, i), b[i]),
                       dict(seg_len=_el(l2, 1, i))),
            b2, 2 * real2 * n, "fp32"),
    }


def sddmm_kernel_calls(torch, t, x, y):
    """K3's and K4's batched calls of one SDDMM apply over the tables
    ``t`` and the dense stacks ``x`` ``(p, m, kf)``, ``y`` ``(p, k,
    kf)``, for :func:`batched_kernel_rows`. Bytes: the real columns'
    (column, bitmap) pairs and the window ids (K3), the real (row,
    column) pairs (K4), once each or once an element, each X and Y row
    they name once a panel, and the scores (K3 every slot, K4 the real
    ones); operations 2 x real scores x kf a panel."""
    p, kf = x.shape[0], x.shape[2]
    seg = "_seg" if "tc_seg_cols" in t else ""
    cols, bits = t[f"tc{seg}_cols"], t[f"tc{seg}_bitmap"]
    win, tc_pos = t[f"tc{seg}_window"], t[f"tc{seg}_out_pos"]
    vseg = "_seg" if "vpu_seg_rows" in t else ""
    rows4, cols4 = t[f"vpu{vseg}_rows"], t[f"vpu{vseg}_cols"]
    mask = t[f"vpu{vseg}_mask"]
    useful3 = int((tc_pos >= 0).sum()) * p // _copies(tc_pos, 3, p)
    useful4 = int(mask.sum()) * p // _copies(mask, 2, p)
    b3 = b4 = 0
    for i in range(p):
        real = _el(bits, 2, i) != 0
        xr = (_el(win, 1, i)[real.any(-1)].long()[:, None] * 8
              + torch.arange(8, device=x.device)).reshape(-1)
        xr = xr[xr < x.shape[1]]
        b3 += (distinct_rows(torch, xr)
               + distinct_rows(torch, _el(cols, 2, i)[real])) * kf * 4
        m_i = _el(mask, 2, i)
        b4 += (distinct_rows(torch, _el(rows4, 2, i)[m_i])
               + distinct_rows(torch, _el(cols4, 2, i)[m_i])) * kf * 4
        if i < _copies(bits, 2, p):
            b3 += int(real.sum()) * 8 + _el(win, 1, i).numel() * 4
        if i < _copies(mask, 2, p):
            b4 += int(m_i.sum()) * 8
    b3 += p * cols.shape[-2] * 8 * cols.shape[-1] * 4
    b4 += useful4 * 4
    return {
        "sddmm_mxu": (
            (cols, bits, win, x, y), {},
            lambda i: ((_el(cols, 2, i), _el(bits, 2, i), _el(win, 1, i),
                        x[i], y[i]), {}),
            b3, 2 * useful3 * kf, "tf32"),
        "sddmm_vpu": (
            (rows4, cols4, x, y), {},
            lambda i: ((_el(rows4, 2, i), _el(cols4, 2, i), x[i], y[i]), {}),
            b4, 2 * useful4 * kf, "fp32"),
    }


def stack_phase(torch, log, fail, compare, *, dev, tenants, mark, median_ms,
                bound):
    """Phase 7 (h): the batched form of K1–K4 on the serving tier's
    tables. For each tenant (name → registry entry) and panel bucket p in
    ``STACK_PANELS``, at width ``STACK_WIDTH``: the revalued SpMM stack
    (AGNN's path: per-panel edge values) and the SDDMM stack, exactly one
    launch a stream a stack. Integer data in [-4, 4]: every panel bit for
    bit against its single apply. Random fp32: the SpMM panels bit for
    bit under deterministic algorithms (the combine's ``index_add_``
    then adds in a fixed order), the SDDMM panels within the fp32
    tolerance; the stacks' times against the p single applies looped. At
    the last bucket, each kernel's batched launch against its single
    launches (:func:`batched_kernel_rows`). The stacks count towards the
    serving path (``mark``); the single applies and launches made to
    compare with do not."""
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref

    w = STACK_WIDTH
    for label, entry in tenants.items():
        sp, sd = entry.op("spmm").op, entry.op("sddmm").op
        arrs = sp.arrays.for_backend("cuda", revalue=True)
        arrs_sd = sd.arrays.for_backend("cuda")
        gen = torch.Generator(dev).manual_seed(705)
        for p in STACK_PANELS:
            for data in ("integer", "random"):
                if data == "integer":
                    def draw(*shape):
                        return torch.randint(-4, 5, shape, generator=gen,
                                             device=dev).float()
                else:
                    def draw(*shape):
                        return torch.randn(*shape, generator=gen,
                                           device=dev)
                b, ev = draw(p, sp.k, w), draw(p, entry.nnz)
                x, y = draw(p, sd.m, w), draw(p, sd.k, w)
                tag = f"phase 7 (h): {label} p={p} {data}"
                torch.use_deterministic_algorithms(data == "random")
                try:
                    before = kernels.launch_counts()
                    got = ops.spmm_apply_stack(arrs, b, m=sp.m, nwin=sp.nwin,
                                               edge_vals=ev)
                    torch.use_deterministic_algorithms(False)
                    got_sd = ops.sddmm_apply_stack(arrs_sd, x, y, nnz=sd.nnz)
                    after = kernels.launch_counts()
                    mark(f"(h) {label} p={p} {data}: the two stacks")
                    launched = {k: after[k] - before[k]
                                for k in STACK_STREAMS}
                    if launched != STACK_STREAMS:
                        fail(f"{tag}: launches {launched}, expected one a "
                             "stream a stack")
                    torch.use_deterministic_algorithms(data == "random")
                    for i in range(p):
                        one = ops.spmm_apply(ref.revalue_spmm_arrays(
                            arrs, ev[i]), b[i], m=sp.m, nwin=sp.nwin)
                        if not torch.equal(got[i], one):
                            err = (got[i] - one).abs().max().item()
                            fail(f"{tag}: SpMM panel {i} differs from its "
                                 f"single apply (max|err| {err})")
                finally:
                    torch.use_deterministic_algorithms(False)
                ones = torch.stack([ops.sddmm_apply(arrs_sd, x[i], y[i],
                                                    nnz=sd.nnz)
                                    for i in range(p)])
                if data == "integer":
                    if not torch.equal(got_sd, ones):
                        fail(f"{tag}: an SDDMM panel differs from its "
                             "single apply")
                else:
                    compare(f"{tag}: SDDMM stack against its {p} single "
                            f"applies (bit for bit: "
                            f"{bool(torch.equal(got_sd, ones))})",
                            got_sd, ones, "fp32")
                del got, got_sd, ones
                mark(f"(h) {label} p={p} {data}: single applies",
                     on_path=False)
            # Times of the random stacks against the p single applies.
            stack_ms = median_ms(lambda: ops.spmm_apply_stack(
                arrs, b, m=sp.m, nwin=sp.nwin, edge_vals=ev), reps=5)
            loop_ms = median_ms(lambda: [ops.spmm_apply(
                ref.revalue_spmm_arrays(arrs, ev[i]), b[i], m=sp.m,
                nwin=sp.nwin) for i in range(p)], reps=5)
            sd_ms = median_ms(lambda: ops.sddmm_apply_stack(
                arrs_sd, x, y, nnz=sd.nnz), reps=5)
            sd_loop_ms = median_ms(lambda: [ops.sddmm_apply(
                arrs_sd, x[i], y[i], nnz=sd.nnz) for i in range(p)], reps=5)
            log(f"phase 7 (h): {label} p={p} w={w}: revalued SpMM stack "
                f"{stack_ms:.4f} ms, {p} single applies {loop_ms:.4f} ms "
                f"(ratio {stack_ms / loop_ms:.3f}); SDDMM stack "
                f"{sd_ms:.4f} ms, {p} single applies {sd_loop_ms:.4f} ms "
                f"(ratio {sd_ms / sd_loop_ms:.3f})")
            if p == STACK_PANELS[-1]:
                t = ref.revalue_spmm_arrays(arrs, ev)
                batched_kernel_rows(
                    torch, kernels, log, fail, median_ms, bound,
                    label=f"{label} stack w={w}", p=p,
                    calls={**spmm_kernel_calls(torch, t, b),
                           **sddmm_kernel_calls(torch, arrs_sd, x, y)})
                del t
            del b, ev, x, y
            mark(f"(h) {label} p={p}: timings", on_path=False)


def classify_sharded(key: str) -> str:
    """The group of a kernel of a sharded apply."""
    k = key.lower()
    for kern, group in (("spmm_mxu", "K1 spmm_mxu"),
                        ("spmm_vpu", "K2 spmm_vpu"),
                        ("sddmm_mxu", "K3 sddmm_mxu"),
                        ("sddmm_vpu", "K4 sddmm_vpu"),
                        ("indexfunc", "combines (index_add_)"),
                        ("catarray", "concatenations (the combine's rows "
                         "and partials)")):
        if kern in k:
            return group
    # index_select by an int32 index is a halo gather (the halo maps are
    # int32); by an int64 one, x_take or the reassembly gather.
    if "gather_kernel" in k or "indexselect" in k:
        return ("halo gathers" if ", int>" in k
                else "reassembly and x_take gathers")
    if "index_elementwise" in k:
        return "revaluation gathers (edge values)"
    return "rest (elementwise, fills, copies)"


def shard_tc_share(part) -> list[float]:
    """Each shard's Tensor Core share of its non-zeros, from the stacked
    position maps (real entries are ``>= 0``)."""
    key = "tc_pos" if "tc_pos" in part.stacked else "tc_out_pos"
    return [float((part.stacked[key][s.index] >= 0).sum()) / max(s.nnz, 1)
            for s in part.shards]


def shard_loop(torch, part, dev, *operands, edge_vals=None):
    """The shards of ``part`` applied one by one through
    ``ops.spmm_apply``/``ops.sddmm_apply`` on their own tables, and
    reassembled: what a batched sharded apply must equal."""
    from repro_torch.kernels import ops, ref

    outs = []
    if part.kind == "spmm":
        (b,) = operands
        if edge_vals is not None and part.edge_perm is not None:
            edge_vals = edge_vals.index_select(0, part.index("edge_perm",
                                                             dev))
        for p in range(part.n_shards):
            arrs = part.arrays(p, dev)
            local = arrs.for_backend("cuda", revalue=edge_vals is not None)
            if edge_vals is not None:
                local = ref.revalue_spmm_arrays(local, edge_vals)
            outs.append(ops.spmm_apply(local, b.index_select(0, arrs["halo"]),
                                       m=part.rows_pad, nwin=part.wmax))
        return torch.cat(outs).index_select(0, part.index("out_gather", dev))
    x, y = operands
    panels = x.index_select(0, part.index("x_take", dev)).split(part.rows_pad)
    for p in range(part.n_shards):
        arrs = part.arrays(p, dev)
        outs.append(ops.sddmm_apply(arrs.for_backend("cuda"), panels[p],
                                    y.index_select(0, arrs["halo"]),
                                    nnz=part.nnz_pad))
    return torch.cat(outs).index_select(0, part.index("nnz_gather", dev))


SHARD_COUNTS = (1, 3, 8)


def sharded_phase(torch, np, log, fail, compare, *, dev, graph, norm, gcn,
                  agnn, requests, x_train, labels, spmm_mix, sddmm_mix,
                  served, median_ms, bound):
    """Phase 8: window-sharded Libra (``dist/``) and the plan explainer on
    one card, eight shards on ``cuda:0`` applied as one batch.

    (a) ``DistGraphOps`` on phase 3's graph at its default
    ``tune="model"``: host seconds of the A, A^T and SDDMM(A) partitions,
    each one's ``explain_partition`` and each shard's Tensor Core share.
    (b) Sharded applies against the single-device operators, bit for bit
    on integer data under deterministic algorithms: the mixed matrix's
    ``ShardedSpMM`` (n=256; both layouts, with ``edge_vals``, and one
    shard) and ``ShardedSDDMM`` (kf=128), built by registering it with
    ``mesh=`` beside phase 7's batched tenant, and the graph's A (with
    ``edge_vals``) and SDDMM(A) partitions against
    ``GraphOps(tune="model")``; sharded against single apply times, and
    one profiled sharded apply of each kind split into K1–K4, the halo
    gathers, the combines and the reassembly; the batched applies of the
    mixed matrix at P in ``SHARD_COUNTS`` against the shards applied one
    by one (:func:`shard_loop`), bit for bit on integer and, under
    deterministic algorithms, random data, one launch a stream an apply;
    at P = 8 the batched apply and each kernel's batched launch timed
    against the shard loop. (c) GCN and AGNN ``[128, 256, 256, 40]``
    through ``DistGraphOps``: three requests each against
    ``GraphOps(tune="model")``, three SGD steps each (losses must fall,
    first-step gradients against the plain path), launches split by
    leg and width. (d) ``GNNService.register_gcn(mesh=)``: a flush
    of 8 GCN requests beside phase 7's batched one, the scores bit for bit
    against the sharded operator called layer by layer (deterministic)
    and within TF32's tolerance of the batched scores; raw requests on
    the sharded mixed tenant bit for bit against direct calls and the
    batched tenant, every one on the fast path. (e) ``explain_spmm``/
    ``explain_sddmm(measure=True)`` of phase 2's operators, and
    ``/explain/<graph>`` over ``serve_http`` (a sharded graph: 400).

    Returns the sharded path's launches: (b)'s sharded applies, (c)'s
    requests and steps, (d)'s served flushes. The single-device
    references, the plain path, timings and profiles are left out."""
    import urllib.error
    import urllib.parse
    import urllib.request
    from unittest import mock

    from repro_torch import kernels
    from repro_torch.api import ExecSpec
    from repro_torch.dist import (
        DistGraphOps,
        ShardedSDDMM,
        ShardedSpMM,
        ShardMesh,
        partition_sddmm,
        partition_spmm,
        sddmm_sharded,
        spmm_sharded,
    )
    from repro_torch.dist import gnn as dist_gnn
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import spmm_apply
    from repro_torch.models.gnn import GraphOps, train_step
    from repro_torch.obs.explain import (
        explain_entry,
        explain_partition,
        explain_sddmm,
        explain_spmm,
        render_table,
    )
    from repro_torch.obs.serve_http import _jsonable
    from repro_torch.serve import ServeError, SparseEngine

    n_shards = 8
    reg, svc, eng, feats, mixed = (served[k] for k in (
        "reg", "svc", "eng", "feats", "mixed"))
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    counts_at, last = {}, kernels.launch_counts()
    path = {k: 0 for k in last}

    def mark(label, on_path=True):
        """Take the launches since the last mark as part ``label``'s; they
        count towards the sharded path's when ``on_path``."""
        nonlocal last
        torch.cuda.synchronize()
        now = kernels.launch_counts()
        counts_at[label] = {k: now[k] - last[k] for k in now
                            if k != "flash_attention"}
        if on_path:
            for k in now:
                path[k] += now[k] - last[k]
        last = now
        log(f"phase 8: {label} done at {time.perf_counter() - t_phase:.1f} "
            f"s; launches {counts_at[label]}"
            + ("" if on_path else " (not on the path)"))

    def clean(e, part):
        h = e.health()
        if h["failures"] or h["degraded_served"] or h["errors_returned"]:
            fail(f"phase 8 {part}: serve_failures_total {h['failures']}, "
                 f"serve_degraded_served_total {h['degraded_served']}, "
                 f"errors {h['errors_returned']}")

    gen = torch.Generator(dev).manual_seed(800)

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=gen, device=dev).float()

    def pad(t, w):
        return torch.nn.functional.pad(t, (0, w - t.shape[1]))

    def show_partition(label, part, host_s=None):
        rep = explain_partition(part)
        share = shard_tc_share(part)
        took = "" if host_s is None else f" {host_s:.1f} s (host);"
        log(f"phase 8 (a): {label}:{took} shard nnz "
            f"{rep['shard_nnz']}; nnz max/mean "
            f"{rep['nnz_balance']['max_over_mean']:.4f}, segment max/mean "
            f"{rep['segment_balance']['max_over_mean']:.4f} (segments "
            f"{rep['shard_segments']}); halo rows {rep['halo_rows']}, halo "
            f"waste {rep['halo_waste_frac']:.4f}; shard thresholds "
            f"{[s.cfg.threshold for s in part.shards]}; Tensor Core share "
            "by shard " + ", ".join(f"{x:.4f}" for x in share)
            + f"; wmax {part.wmax}, stacked "
            f"{sum(v.nbytes for v in part.stacked.values()) / 2**20:.1f} "
            "MiB (host)")

    # (a) The graph's partitions, timed one by one as DistGraphOps builds
    # them (A, A^T, SDDMM(A)).
    mesh = ShardMesh.round_robin(n_shards)
    log(f"phase 8 (a): {mesh} ({torch.cuda.device_count()} card(s))")
    host_s = []

    def timed(fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            host_s.append(time.perf_counter() - t)
            return out
        return run

    with mock.patch.object(dist_gnn, "partition_spmm",
                           timed(dist_gnn.partition_spmm)), \
            mock.patch.object(dist_gnn, "partition_sddmm",
                              timed(dist_gnn.partition_sddmm)):
        gd = DistGraphOps(graph, mesh)
    for leg, part, s_ in zip(("A", "A^T", "SDDMM(A)"),
                             (gd.part, gd.part_t, gd.part_sd), host_s):
        show_partition(f"DistGraphOps {leg}", part, s_)

    # (b) The mixed matrix with integer values, registered with mesh= beside
    # phase 7's batched tenant of the same matrix: the entry's
    # ShardedSpMM/ShardedSDDMM against the batched tenant's operators.
    t = time.perf_counter()
    reg.register(mixed, name="mixed8", ops=("spmm", "sddmm"), mesh=mesh)
    mixed_s = time.perf_counter() - t
    m8 = reg.resolve("mixed8")
    sh_sp, sh_sd = m8.op("spmm"), m8.op("sddmm")
    op_m, sd_m = (reg.resolve("mixed").op(k).op for k in ("spmm", "sddmm"))
    log(f"phase 8 (b): mixed tenant registered with mesh= in {mixed_s:.1f} "
        "s (host: its SpMM and SDDMM partitions)")
    show_partition("mixed tenant SpMM", sh_sp.part)
    show_partition("mixed tenant SDDMM", sh_sd.part)
    row_sp = ShardedSpMM(sh_sp.part, mesh,
                         spec=ExecSpec(b_layout="rowshard"))
    row_sd = ShardedSDDMM(sh_sd.part, mesh,
                          spec=ExecSpec(b_layout="rowshard"))
    t = time.perf_counter()
    one = ShardedSpMM(mixed, ShardMesh.round_robin(1))
    log(f"phase 8 (b): one-shard mixed SpMM partition "
        f"{time.perf_counter() - t:.1f} s (host)")
    # The graph's single-device reference at the same tune="model".
    t = time.perf_counter()
    gops = GraphOps(graph, spec=ExecSpec(tune="model", device=str(dev)))
    log(f"phase 8 (b): GraphOps(tune='model') plans "
        f"{time.perf_counter() - t:.1f} s (host), the single-device "
        "reference of (b) and (c)")
    b, ev = ints(mixed.k, 256), ints(mixed.nnz)
    x, y = ints(mixed.m, 128), ints(mixed.k, 128)
    gb, gev, gx = ints(graph.k, 256), ints(graph.nnz), ints(graph.m, 128)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = {"mixed SpMM n=256": sh_sp(b),
               "mixed SpMM n=256 rowshard": row_sp(b),
               "mixed SpMM n=256 edge_vals": sh_sp(b, edge_vals=ev),
               "mixed SpMM n=256, one shard": one(b),
               "mixed SDDMM kf=128": sh_sd(x, y),
               "mixed SDDMM kf=128 rowshard": row_sd(x, y),
               "graph A n=256 edge_vals": gd._spmm(gd.part, gb,
                                                   edge_vals=gev),
               "graph SDDMM(A) kf=128": gd._sddmm(gx, gx)}
        mark("(b) sharded applies")
        arrs = ref.revalue_spmm_arrays(
            op_m.arrays.for_backend("cuda", revalue=True), ev)
        want = {"mixed SpMM n=256": op_m(b),
                "mixed SpMM n=256 edge_vals": spmm_apply(
                    arrs, b, m=op_m.m, nwin=op_m.nwin),
                "mixed SDDMM kf=128": sd_m(x, y),
                "graph A n=256 edge_vals": gops._a_apply(gev, gb),
                "graph SDDMM(A) kf=128": gops._sddmm_apply(gx, gx)}
        want["mixed SpMM n=256 rowshard"] = want["mixed SpMM n=256"]
        want["mixed SpMM n=256, one shard"] = want["mixed SpMM n=256"]
        want["mixed SDDMM kf=128 rowshard"] = want["mixed SDDMM kf=128"]
        mark("(b) single-device applies", on_path=False)
        for label, out in got.items():
            if not torch.equal(out, want[label]):
                err = (out - want[label]).abs().max().item()
                fail(f"phase 8 (b): sharded {label} differs from the "
                     f"single-device apply (max|err| {err})")
        del arrs, want
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"phase 8 (b): {len(got)} sharded applies equal the single-device "
        "ones bit for bit (integer data, deterministic algorithms)")
    del got
    log("phase 8 (b): sharded against single-device apply ms (CUDA events, "
        "median of 20)")
    for label, sh, single in (
            ("mixed SpMM n=256", lambda: sh_sp(b), lambda: op_m(b)),
            ("mixed SDDMM kf=128", lambda: sh_sd(x, y), lambda: sd_m(x, y)),
            ("graph A n=256 edge_vals",
             lambda: gd._spmm(gd.part, gb, edge_vals=gev),
             lambda: gops._a_apply(gev, gb)),
            ("graph SDDMM(A) kf=128", lambda: gd._sddmm(gx, gx),
             lambda: gops._sddmm_apply(gx, gx))):
        sh_ms, one_ms = median_ms(sh), median_ms(single)
        log(f"  {label}: sharded ({n_shards} shards) {sh_ms:.4f} ms, single "
            f"device {one_ms:.4f} ms (ratio {sh_ms / one_ms:.3f})")
    # Its pieces, each timed alone: the halo gather (one over the stacked
    # halo maps), and the reassembly (one gather of the batch's output).
    for label, part, operand in (
            ("mixed SpMM n=256", sh_sp.part, b),
            ("graph SDDMM(A) kf=128", gd.part_sd, gx)):
        halo = part.stacked_arrays(dev)["halo"].reshape(-1)
        halo_ms = median_ms(lambda: operand.index_select(0, halo))
        if part.kind == "spmm":
            flat = torch.zeros(n_shards * part.rows_pad, operand.shape[1],
                               device=dev)
            gather = part.index("out_gather", dev)
        else:
            flat = torch.zeros(n_shards * part.nnz_pad, device=dev)
            gather = part.index("nnz_gather", dev)
        re_ms = median_ms(lambda: flat.index_select(0, gather))
        log(f"  {label}: the halo gather {halo_ms:.4f} ms "
            f"({halo.numel()} rows), reassembly {re_ms:.4f} ms")
        del flat, halo
    for label, run in (("sharded SpMM mixed n=256", lambda: sh_sp(b)),
                       ("sharded SpMM graph A n=256 edge_vals",
                        lambda: gd._spmm(gd.part, gb, edge_vals=gev)),
                       ("sharded SDDMM(A) graph kf=128",
                        lambda: gd._sddmm(gx, gx))):
        profile_request(torch, log, label, run, classify_sharded)
    mark("(b) timings and profiles", on_path=False)
    del one, row_sp, row_sd

    # The batched applies at P = 1, 3 and 8 against the shard loop: the
    # mixed tenant's partitions at P = 8, partitions of the same matrix
    # at the registry's spec for the others.
    parts = {n_shards: (sh_sp.part, sh_sd.part)}
    for n_p in SHARD_COUNTS:
        if n_p not in parts:
            t = time.perf_counter()
            parts[n_p] = (partition_spmm(mixed, n_p, spec=sh_sp.spec),
                          partition_sddmm(mixed, n_p, spec=sh_sd.spec))
            log(f"phase 8 (b): mixed partitions at P={n_p} "
                f"{time.perf_counter() - t:.1f} s (host)")
    want_launches = {"spmm_mxu": 2, "spmm_vpu": 2, "sddmm_mxu": 1,
                     "sddmm_vpu": 1}
    for n_p in SHARD_COUNTS:
        psp, psd = parts[n_p]
        mesh_p = ShardMesh.round_robin(n_p)
        for data in ("integer", "random"):
            if data == "integer":
                draw = ints
            else:
                def draw(*shape):
                    return torch.randn(*shape, generator=gen, device=dev)
            b_, ev_ = draw(mixed.k, 256), draw(mixed.nnz)
            x_, y_ = draw(mixed.m, 128), draw(mixed.k, 128)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                before = kernels.launch_counts()
                got = (spmm_sharded(psp, b_, mesh=mesh_p),
                       spmm_sharded(psp, b_, mesh=mesh_p, edge_vals=ev_),
                       sddmm_sharded(psd, x_, y_, mesh=mesh_p))
                after = kernels.launch_counts()
                mark(f"(b) batched sharded applies, P={n_p}, {data}")
                launched = {k: after[k] - before[k] for k in want_launches}
                if launched != want_launches:
                    fail(f"phase 8 (b): P={n_p} {data}: launches "
                         f"{launched}, expected {want_launches} (one a "
                         "stream an apply)")
                want = (shard_loop(torch, psp, dev, b_),
                        shard_loop(torch, psp, dev, b_, edge_vals=ev_),
                        shard_loop(torch, psd, dev, x_, y_))
                mark(f"(b) shard loop, P={n_p}, {data}", on_path=False)
            finally:
                torch.use_deterministic_algorithms(False)
            for what, g, w_ in zip(("SpMM n=256", "SpMM n=256 edge_vals",
                                    "SDDMM kf=128"), got, want):
                if not torch.equal(g, w_):
                    err = (g - w_).abs().max().item()
                    fail(f"phase 8 (b): P={n_p} {data} {what}: the batched "
                         f"apply differs from the shard loop (max|err| "
                         f"{err})")
            del got, want
        log(f"phase 8 (b): P={n_p}: the batched sharded applies equal the "
            "shards applied one by one, bit for bit (integer data; random "
            "fp32 under deterministic algorithms), one launch a stream an "
            "apply")
    # At P = 8: the batched apply and each kernel's batched launch against
    # the shard loop and the per-shard launches (random fp32).
    psp, psd = parts[n_shards]
    rb = torch.randn(mixed.k, 256, generator=gen, device=dev)
    rx = torch.randn(mixed.m, 128, generator=gen, device=dev)
    ry = torch.randn(mixed.k, 128, generator=gen, device=dev)
    for what, run, loop in (
            ("SpMM n=256", lambda: spmm_sharded(psp, rb, mesh=mesh),
             lambda: shard_loop(torch, psp, dev, rb)),
            ("SDDMM kf=128", lambda: sddmm_sharded(psd, rx, ry, mesh=mesh),
             lambda: shard_loop(torch, psd, dev, rx, ry))):
        ms, loop_ms = median_ms(run), median_ms(loop)
        log(f"phase 8 (b): mixed {what}, P={n_shards}: batched apply "
            f"{ms:.4f} ms, the {n_shards} shards applied one by one "
            f"{loop_ms:.4f} ms (ratio {ms / loop_ms:.3f})")
    t_sp = psp.stacked_arrays(dev)
    t_sd = psd.stacked_arrays(dev)
    halo_sp, halo_sd = t_sp["halo"], t_sd["halo"]
    b_halo = rb.index_select(0, halo_sp.reshape(-1)).view(
        *halo_sp.shape, rb.shape[1])
    y_halo = ry.index_select(0, halo_sd.reshape(-1)).view(
        *halo_sd.shape, ry.shape[1])
    panels = rx.index_select(0, psd.index("x_take", dev)).view(
        n_shards, psd.rows_pad, rx.shape[1])
    batched_kernel_rows(
        torch, kernels, log, fail, median_ms, bound,
        label=f"mixed sharded P={n_shards}", p=n_shards,
        calls={**spmm_kernel_calls(torch, t_sp.for_backend("cuda"), b_halo),
               **sddmm_kernel_calls(torch, t_sd.for_backend("cuda"), panels,
                                    y_halo)})
    del parts, psp, psd, rb, rx, ry, b_halo, y_halo, panels
    mark("(b) the batched form against the shard loop: timings",
         on_path=False)

    # (c) GCN and AGNN through DistGraphOps from phase 3's weights.
    counts_by_step, applies, ms_by = {}, {}, {"GCN": [], "AGNN": []}
    outs = {}
    with torch.no_grad():
        for name, model, args in (("GCN", gcn, (norm,)), ("AGNN", agnn, ())):
            for i, xr in enumerate(requests):
                before = kernels.launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                outs[(name, i)] = model(gd, xr, *args)
                torch.cuda.synchronize()
                ms_by[name].append((time.perf_counter() - t) * 1e3)
                after = kernels.launch_counts()
                counts_by_step[f"{name} request {i}"] = {
                    k: after[k] - before[k] for k in after}
                applies[f"{name} request {i}"] = gnn_applies(name,
                                                             model.dims)
        mark("(c) DistGraphOps requests")
        for (name, i), out in outs.items():
            model = gcn if name == "GCN" else agnn
            args = (norm,) if name == "GCN" else ()
            if tuple(out.shape) != (graph.m, 40):
                fail(f"phase 8 (c): {name} logits shape {tuple(out.shape)}")
            compare(f"DistGraphOps {name} request {i} logits against "
                    "GraphOps(tune='model')", out,
                    model(gops, requests[i], *args), "tf32")
        mark("(c) GraphOps(tune='model') references", on_path=False)
    del outs, gops
    for name, ms in ms_by.items():
        log(f"phase 8 (c): DistGraphOps {name} [128, 256, 256, 40] request "
            "ms: " + ", ".join(f"{v:.2f}" for v in ms))
    trained = {}
    for name, model0, args in (("GCN", gcn, (norm,)), ("AGNN", agnn, ())):
        model = copy.deepcopy(model0)
        losses, ms = [], []
        for i in range(3):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = train_step(model, gd, x_train, labels, *args, lr=0.2)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            after = kernels.launch_counts()
            counts_by_step[f"{name} step {i}"] = {k: after[k] - before[k]
                                                  for k in after}
            applies[f"{name} step {i}"] = gnn_applies(name, model.dims,
                                                      train=True)
            losses.append(loss.item())
            if i == 0:
                grads0 = [p.grad.clone() for p in model.parameters()]
        trained[name] = (losses, ms, grads0)
        log(f"phase 8 (c): DistGraphOps {name} training step ms "
            + ", ".join(f"{v:.2f}" for v in ms) + "; losses "
            + ", ".join(f"{v:.6f}" for v in losses))
        if not losses[-1] < losses[0]:
            fail(f"phase 8 (c): the {name} loss did not fall: {losses}")
    mark("(c) DistGraphOps training steps")
    # The shards apply as one batch: a launch a stream a sharded apply.
    by_shape = launches_by_shape(counts_by_step, applies)
    log(f"phase 8 (c) launches by leg and width (one batched launch a "
        f"stream a sharded apply of {n_shards} shards): "
        + str(by_shape).replace("GraphOps", "DistGraphOps"))
    plain = copy.copy(gd)
    plain.backend = "torch"
    for name, model0, args in (("GCN", gcn, (norm,)), ("AGNN", agnn, ())):
        model = copy.deepcopy(model0)
        train_step(model, plain, x_train, labels, *args, lr=0.2)
        names = [n for n, _ in model.named_parameters()]
        for pname, got_g, p in zip(names, trained[name][2],
                                   model.parameters()):
            compare(f"DistGraphOps {name} first-step gradient {pname} "
                    "against backend='torch'", got_g, p.grad, "tf32")
    mark("(c) plain-path gradients", on_path=False)
    del plain, trained

    # (d) The GCN served on a mesh beside phase 7's batched GCN: one
    # warm-up and one timed flush of the eight feature sets each.
    t = time.perf_counter()
    svc.register_gcn("gcn8", graph, gcn, mesh=mesh)
    log(f"phase 8 (d): sharded GCN registered in "
        f"{time.perf_counter() - t:.1f} s (host)")
    show_partition("served GCN A (normalized)",
                   reg.resolve("gcn8::graph").op("spmm").part)
    flush_ms, scores = {}, {}
    with torch.no_grad():
        for model in ("gcn8", "gcn", "gcn8", "gcn"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rids = [svc.submit(model, f) for f in feats]
            out = svc.flush()
            torch.cuda.synchronize()
            flush_ms[model] = (time.perf_counter() - t) * 1e3
            scores[model] = [out[r] for r in rids]
            if model == "gcn8":
                mark("(d) sharded GCN flush")
            else:
                mark("(d) phase 7's batched GCN flush", on_path=False)
        clean(eng, "(d)")
        for model, label in (("gcn8", "sharded"), ("gcn", "batched")):
            ms = flush_ms[model]
            log(f"phase 8 (d): {label} GCN flush of {len(feats)} requests "
                f"{ms:.2f} ms, {ms / len(feats):.2f} ms a request, "
                f"{len(feats) / ms * 1e3:.1f} requests/s")
        for i, (got_s, want_b) in enumerate(zip(scores["gcn8"],
                                                scores["gcn"])):
            if isinstance(got_s, ServeError):
                fail(f"phase 8 (d): sharded GCN request {i}: {got_s}")
            compare(f"sharded GCN request {i} against the batched one",
                    got_s, want_b, "tf32")
        del scores
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            rids = [svc.submit("gcn8", f) for f in feats]
            out = svc.flush()
            mark("(d) sharded GCN flush, deterministic algorithms")
            for i, rid in enumerate(rids):
                if not torch.equal(out[rid], direct_gcn(reg, svc, feats[i],
                                                        name="gcn8")):
                    fail(f"phase 8 (d): sharded GCN request {i} differs "
                         "from the ShardedSpMM called layer by layer")
            mark("(d) direct layer-by-layer calls", on_path=False)
        finally:
            torch.use_deterministic_algorithms(False)
        log(f"phase 8 (d): {len(feats)} sharded GCN scores equal the "
            "ShardedSpMM called layer by layer bit for bit")
    # Raw requests on the sharded mixed tenant and on the batched one in
    # one flush, against direct calls of the sharded operators.
    raw = []
    for w in (32, 64, 128):
        raw.append(("spmm", w, dict(b=ints(mixed.k, w))))
        raw.append(("spmm", w, dict(b=ints(mixed.k, w),
                                    edge_vals=ints(mixed.nnz))))
    for w in (32, 128):
        raw.append(("sddmm", w, dict(x=ints(mixed.m, w),
                                     y=ints(mixed.k, w))))
    eng_d = SparseEngine(reg)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rids = [(eng_d.submit("mixed8", op, **kw),
                 eng_d.submit("mixed", op, **kw)) for op, _, kw in raw]
        out = eng_d.flush()
        mark("(d) raw requests, sharded and batched tenants")
        for (rs, rb), (op, w, kw) in zip(rids, raw):
            bw = reg.width_bucket(w)
            if op == "sddmm":
                want = sh_sd(pad(kw["x"], bw), pad(kw["y"], bw))
            else:
                want = sh_sp(pad(kw["b"], bw),
                             edge_vals=kw.get("edge_vals"))[:, :w]
            if not (torch.equal(out[rs], want)
                    and torch.equal(out[rs], out[rb])):
                fail(f"phase 8 (d): raw {op} width {w}"
                     + (" edge_vals" if "edge_vals" in kw else "")
                     + ": the sharded tenant differs from the direct call "
                     "or the batched tenant")
        mark("(d) direct sharded calls", on_path=False)
    finally:
        torch.use_deterministic_algorithms(False)
    clean(eng_d, "(d)")
    st = eng_d.stats()
    log(f"phase 8 (d): {len(raw)} raw requests on the sharded tenant equal "
        f"the direct calls and the batched tenant bit for bit; pack_limit "
        f"at w=64 sharded {reg.pack_limit(m8, 64)} (CUDA-core elements a "
        f"shard {m8.spmm_vpu_elems}), batched "
        f"{reg.pack_limit(reg.resolve('mixed'), 64)}; applies "
        f"{st['panels_executed']}, exec-cache hits {st['exec_cache_hits']}, "
        f"misses {st['exec_cache_misses']}")
    mem = reg.memory_report()
    sharded_bytes = sum(arr.resident_nbytes() for n in ("mixed8",
                                                        "gcn8::graph")
                        for op in reg.resolve(n).ops.values()
                        for arr in op.arrays)
    graphs = {g["graph"]: g["bytes"] for g in mem["graphs"]}
    booked = sum(graphs.get(reg.resolve(n).key, 0)
                 for n in ("mixed8", "gcn8::graph"))
    log(f"phase 8 (d): /memory of the sharded entries {booked} B, their "
        f"shards' uploaded tensors {sharded_bytes} B")
    if booked != sharded_bytes:
        fail("phase 8 (d): /memory disagrees with the shards' uploads")

    # (e) The explainer: phase 2's operators measured, and /explain.
    for label, op, fn, w in (("LibraSpMM mixed", spmm_mix, explain_spmm, 256),
                             ("LibraSDDMM mixed", sddmm_mix, explain_sddmm,
                              128)):
        rep = fn(op, measure=True, width=w, reps=5)
        log(render_table(rep, title=f"phase 8 (e): explain {label}"))
    srv = eng.serve_http(port=0)
    try:
        name = "gcn::graph"
        with urllib.request.urlopen(
                f"{srv.url}/explain/{urllib.parse.quote(name)}",
                timeout=60) as r:
            served_doc = json.loads(r.read().decode())
        local = json.loads(json.dumps(explain_entry(reg, name),
                                      default=_jsonable))
        if served_doc != local:
            fail("phase 8 (e): /explain differs from explain_entry")
        try:
            urllib.request.urlopen(f"{srv.url}/explain/"
                                   f"{urllib.parse.quote('gcn8::graph')}",
                                   timeout=60)
            fail("phase 8 (e): /explain of a sharded graph answered")
        except urllib.error.HTTPError as exc:
            if exc.code != 400:
                fail(f"phase 8 (e): /explain of a sharded graph: {exc.code}")
    finally:
        srv.stop()
    log(f"phase 8 (e): /explain/{name} equals explain_entry "
        f"(tc_fraction {served_doc['tc_fraction']:.4f}, occupancy "
        f"{served_doc['occupancy']['blocks_per_sm']} blocks an SM); the "
        "sharded graph answers 400")
    mark("(e) explainer", on_path=False)

    missing = [k for k, v in path.items() if k != "flash_attention" and v <= 0]
    log(f"phase 8 (sharded path) launches: {path}")
    if missing:
        fail(f"kernels never launched on the sharded path: {missing}")
    log(f"phase 8: wall time {time.perf_counter() - t_phase:.1f} s")
    return path


def direct_gcn(reg, svc, x, name="gcn"):
    """A GCN scoring through the registered operator called directly
    (the ``ShardedSpMM`` itself for a sharded entry), layer by layer, each
    panel zero-padded to its width bucket as the engine pads it."""
    import torch

    model = svc._models[name]
    entry = reg.resolve(model.graph)
    op = entry.op("spmm") if entry.sharded else entry.op("spmm").op
    h = x
    for i, layer in enumerate(model.params):
        b = h @ layer["w"]
        w = b.shape[1]
        h = op(torch.nn.functional.pad(b, (0, reg.width_bucket(w) - w)))[
            :, :w]
        if i < len(model.params) - 1:
            h = torch.relu(h)
    return h


def direct_agnn(reg, svc, x):
    """An AGNN scoring through the registered operators called directly,
    layer by layer: the SDDMM on the normalized features, the edge
    softmax, and the revalued SpMM, panels padded to their buckets."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import spmm_apply
    from repro_torch.models.gnn import edge_softmax

    model = svc._models["agnn"]
    entry = reg.resolve(model.graph)
    sp, sd = entry.op("spmm").op, entry.op("sddmm").op

    def pad(t):
        return torch.nn.functional.pad(
            t, (0, reg.width_bucket(t.shape[1]) - t.shape[1]))

    h = x
    for i, layer in enumerate(model.params):
        hn = h / torch.clamp(torch.linalg.vector_norm(
            h, dim=-1, keepdim=True), min=1e-9)
        att = edge_softmax(model, sd(pad(hn), pad(hn)) * layer["beta"])
        arrs = ref.revalue_spmm_arrays(
            sp.arrays.for_backend("cuda", revalue=True), att)
        w = h.shape[1]
        h = spmm_apply(arrs, pad(h), m=sp.m, nwin=sp.nwin)[:, :w]
        h = h @ layer["w"]
        if i < len(model.params) - 1:
            h = torch.relu(h)
    return h


if __name__ == "__main__":
    sys.exit(main())
