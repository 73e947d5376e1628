#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: drives its training and serving paths
on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases,
each printed as JSON lines; any failure raises and the script exits
non-zero without the final result line:

  1. the card's name and power limit (nvidia-smi); build the four CUDA
     kernels from ``src/repro_torch/csrc`` (one nvcc per source, in
     parallel), with ptxas's registers, spills, shared memory and
     performance warnings of each kernel and the dynamic shared memory of
     the tensor-core variants;
  2. each kernel against its plain PyTorch version on the card: gossip
     (f32 and bf16 variants) and PME average on small odd shapes (isolated
     node, star hub, NaN-poisoned padding, more receivers than one tile)
     and at the training paths' largest leaf [4, 276,824,064] (gossip: f32
     for path A, bf16 for path D and for E5's replica mix over 16 sender
     rows, each bit-equal to the f32 slots chain rounded to its type);
     flash attention on the JAX tests'
     sweep (f32, bf16), on ragged, windowed, D = 128 and 40/8 GQA bf16
     shapes (one query row, one key past a tile, a window longer than S,
     20/4 GQA, three batch rows of a ragged S), at path C's [8, 2048, 32,
     64] bf16 and at path L2's half of the heads ([8, 2048, 16, 64];
     qwen3-14b's 20 on 4 KV heads, D = 128);
     SSD intra-chunk on the JAX tests' shapes, on short-chunk and G > 1
     bf16 shapes, at path C's [8, 16, 128, 64, 64] bf16, at path L2's 32
     heads and at mamba2-1.3b's N = 128; gossip (f32)
     and PME average at path F3's fc1 [4, 401,408]; the PME average's
     receiver range (r = 1 and 2 of m = 4, what a rank of a sharded step
     computes) at path B's largest leaf in bf16 and at F3's fc1 in f32,
     and at path K's r = m = 4 on path A's largest leaf in f32, equal to
     the square launch's rows and to its plain version.  Each row
     names the variant it launched (tensor_cores or cuda_cores).  Max
     error, kernel / plain / library times (CUDA events, median), the
     least time the card could take (bound) and the share of it reached;
  3. path A: the trainer CLI, stablelm-1.6b at full width and depth, PaME
     with the sparse exchange, 4 nodes, 3 steps — the gossip kernel must
     launch 11 times a step;
  4. path B: ``run_pame`` on the same model with ``PaMEConfig()``
     defaults (exact masks, dense exchange), 2 steps — the PME-average
     kernel must launch 10 times a step;
  5. one ``pame_step`` of each path with injected draws at full width and
     2 layers, through the kernels and through the plain versions: new
     params within one bf16 ulp;
  6. path C: ``ServeLoop`` on zamba2-1.2b at full width and depth (38
     layers) with both kernel flags, 4 node models, 8 prompts of 2048
     tokens, 32 generated, one round serving local models and one the
     consensus mean — flash must launch 7 and SSD 38 times per prefill,
     all of them their tensor-core variants,
     every logit be finite and each node return [8, 32] tokens; then one
     node's prefill through the kernels and through the plain route: in
     f32 within 1e-3 (relative logit error), in bf16 no further from the
     f32 logits than the plain route (within 1.1x);
  7. path D: the trainer CLI with each of the five baselines (dpsgd,
     dfedsam, choco, beer, anq_nids) on path A's model and flags at 12
     layers (full width), 2 steps each — finite losses, the bf16 gossip
     kernel launched 11 times a step (22 for beer), no f32 launch, peak
     memory under 80 GB; `run_pame` with exchange="compressed" and
     "compressed_q8" at 12 layers, 2 steps each — finite losses and the
     Eq.-(8) wire bits at 64 and 8 value bits;
  8. one step of each baseline with injected draws through the kernel
     route and through the plain contraction (f32 slots, rounded once), at
     full width and 2 layers: every state tree within one floored bf16 ulp;
  9. path E: dynamic networks on path A's model through the trainer CLI,
     3 steps each — E1 PaME under the harsh i.i.d. scenario (f32 gossip,
     11 a step), E3 D-PSGD under Markov bursts and sessions with bounded
     staleness 2 (bf16 gossip, 11), E4 PaME under message loss, crashes and
     delayed delivery (f32, 11), E5 CHOCO with per-receiver replicas under
     loss and lossy-link bursts (bf16, 11), E6 BEER (22) and ANQ-NIDS (11)
     with replicas under loss at 8 layers (full width: their replica trees
     do not fit at full depth) — then E2, `Algorithm.bind` with PaME's
     dense exact exchange under churn (PME average, 10 a step): finite
     losses, launch counts, realized metrics, peaks under 80 GB;
 10. one dynamic, one temporal and one fault step of D-PSGD and of PaME,
     and one fault step of rep-CHOCO, rep-BEER and rep-ANQ-NIDS, at full
     width and 2 layers with injected network and compression uniforms,
     through the kernels and through the plain contraction: 0 bf16 ulps,
     f32 leaves bit-equal, ring snapshots and replicas included, the
     launches of each step counted;
 11. path F: the paper's own tasks at the JAX benchmark's settings, each
     run's s/step, peak, launches of each kernel and its own result — F1
     Example 1 through examples/quickstart_torch.py's entry points
     (`run_pame` under the stop rule: the objective below half its start;
     the registry race of PaME and D-PSGD, f32 gossip; the Theorem-1
     demo); F2 Example 2, all six algorithms through the registry on 32
     nodes, 50 steps (f32 gossip, one launch a step, two for BEER;
     objectives fall, ANQ-NIDS recorded either way); F3 Example 3 on
     Fashion-MNIST's size (60,000 synthetic images, the last 512 held
     out), C = 7: PaME through `run_pame` (PME average on fc1, one launch
     a step) and D-PSGD through the registry (f32 gossip, 6 a step), 80
     steps, held-out accuracy at least 0.5, and the width-2 CNN with the
     tree partition and p_leaf (C = 3, 60 steps, f32 gossip 6 a step);
     F4 Example 4, ResNet-20 on CIFAR-10's size (50,000) under
     Dirichlet(0.3), PaME, 40 steps (PME average, 5 a step); 5 profiled
     steps of F3's PaME and of F4: launches, device-busy time, wall time
     and idle share a step;
 12. one PaME and one D-PSGD step of the CNN and of ResNet-20 through the
     kernels and through the plain routes (D-PSGD 0 f32 ulps, PaME's
     exchange within one ulp), and each model's forward on the card
     against the CPU within rtol 1e-5 with the TF32 pin (recorded without);
 13. path G: serve-while-train with elastic membership through
     `repro_torch.launch.serve_train` — G1 on stablelm-1.6b at full width
     and depth, PaME (f32 gossip, 11 a step at every m), rush traffic, 12
     steps in chunks of 3, m = 4 -> 5 -> 4 through join@3, partition@6,
     heal@9 and leave@10, consensus serving of 8 x 512-token prompts (16
     generated) on 2 nodes a round: finite losses, conformant joins and
     leaves, green monitors with no cross-component mass, deferrals,
     served <= arrived, [8, 16] tokens from finite logits, a peak under 80
     GB; G2 at 2 layers: a join at step 5 catching up from the step-4
     checkpoint (the joiner's rows the donor's checkpointed rows bit for
     bit) and the trainer resuming at step 4 from its own checkpoints,
     each save's and restore's seconds and bytes; parity phase G: a paced
     PaME and D-PSGD step (node 1 deferred) through the kernel and the
     plain routes (0 ulps), `retire_state` and `expand_state` on the card
     against the CPU (within one bf16 ulp);
 14. path H: batched seed and config lanes — H1 the trainer CLI with
     --seeds 2 on path A's model at full width and 12 layers (kappa_i = 2, so
     that step 2's exchange separates the lanes): 11 f32 gossip launches a
     step for both lanes, finite losses that differ, peak under 80 GB; H2
     Example 3 as the JAX heterogeneity bench runs it (the CNN, C = 7,
     PaME through `bind_batched` with the sparse exchange) at L = 1 and
     L = 5 seeds, 80 steps each: gossip launches a step equal at both,
     held-out accuracy of every lane's node-mean model at least 0.5,
     `lane_finals`, 5 profiled steps of each, then 10 steps of the same
     grid under a dynamic network (H2dyn) at L = 1 and 5 (the lanes'
     realizations folded into one step: 6 gossip launches a step at
     both); H1dyn H1 with --edge-drop 0.2 --churn 0.1 (11 f32 launches a
     step, as H1; its peak beside H1's); H3 ResNet-20 under
     Dirichlet(0.3) through `bind_batched(seeds=range(5), mixing="dense")`:
     5 PME-average launches a step, all with the lane axis, losses that
     fall in every lane; H4 H2's grid at L = 1 and 5 under a temporal
     scenario with staleness 2 (PaME), message loss and crashes (CHOCO
     with replicas) and bursty serving pacing (PaME), 10 steps each: 6
     gossip launches a step at both lane counts, finite losses in every
     lane; parity phase H: one batched step of 2 lanes
     through the kernels against each lane unbatched (0 ulps) for PaME
     sparse, PaME dense exact and D-PSGD bf16 at full width and 2 layers
     and for the CNN, the same step through the plain routes (phases 5 and
     8's tolerance), and a NaN lane leaving the other bit-equal; and one
     step of 3 CNN lanes under each network form (dynamic, temporal,
     faults, pacing), each lane bit-equal to its seed's unbatched step,
     the plain route within 1e-5, a NaN lane isolated.  Phase 2
     times the lane forms: the PME average's lane axis at [2, 4,
     276,824,064] bf16 and [5, 4, 36,864] f32, the gossip kernel on the
     lane-offset table at H1's embedding, [8, 205,520,896] f32;
 15. path I: the remaining LM architectures — I1 the trainer CLI on
     deepseek-v2-lite-16b (MLA and MoE) at full width and 3 layers (the
     dense first layer and 2 MoE layers), PaME sparse on 4 nodes, 3 steps:
     the f32 gossip kernel once a leaf a step (28), finite losses, peak
     under 80 GB; then one node's train_loss and backward without remat
     and with the "full" and "dots" policies: equal losses, each peak
     recorded; I2 deepseek-v2-lite-16b served at full width and depth (27
     layers, one node model, 8 x 2048-token prompts in query chunks of 512,
     32 generated): MLA's chunked prefill, its cache and the absorbed
     decode through 26 MoE layers; I3 qwen3-14b served at full width and
     depth with use_flash (40 flash launches a prefill, D = 128, 40 heads
     on 8 KV heads); I4 minitron-4b, internvl2-2b (patch embeddings before
     the prompt), musicgen-large, yi-34b and deepseek-v2-236b (q_lora) at
     full width and 2 layers: one train_loss and backward, one prefill of
     2 x 256 tokens and 4 decoded tokens, all finite; qwen3-14b's chunked
     GQA prefill (2 x 1024 tokens, chunks of 512) within 2e-2 of the
     unchunked route on its bf16 logits; I5 sgd, momentum and adam on a
     quadratic over a tree on the card, the objective below 1e-3 of its
     start.  Phase 2 times the f32 gossip kernel at I1's largest leaf [4,
     369,098,752] and flash at I3's shape q [8, 2048, 40, 128] on 8 KV
     heads (against SDPA with its GQA flag);
 16. path R: same seed, same bits, with no switch set by the script — F3's
     and F4's PaME runs, I1 and H2dyn at 5 lanes, each run twice from one
     seed: parameters equal leaf for leaf; the trainer at full width and
     2 layers, 6 steps, against 3 steps, a checkpoint and a resume to 6:
     the resumed state equal to the uninterrupted one;
 17. path J: the four input shapes of `repro_torch.configs.shapes` at full
     width and depth, batch the only cut (each record names it) — J1
     train_4k: the trainer CLI in a fresh process with --compile-cache
     (the gossip kernel must be built into that directory) and --remat,
     stablelm-1.6b, PaME sparse on 4 nodes x 2 x 4096 tokens, 3
     steps (11 f32 gossip launches a step); J2 prefill_32k: stablelm-1.6b
     with use_flash, 8 x 32,768 tokens into caches of 32,768 (flash once a
     layer) and J3 decode_32k: 16 greedy tokens on them; J4 long_500k at
     its real batch of 1 through `config_for_shape`: J4a stablelm-1.6b
     (window 4096, flash's window branch at 524,288 tokens), J4b
     mamba2-1.3b (SSD at N = 128, 48 launches), J4c zamba2-1.2b (7 flash,
     38 SSD), each a 524,288-token prefill into ring caches of 4096 and 32
     tokens past the wrap, the ring then holding exactly the last 4096
     positions; finite logits, prefill ms, decode ms a token, peaks under
     80 GB; parity phase J: J4a's flash call and J4b's SSD call as the
     models make them at 2 layers, full width and 8192 tokens, against the
     plain versions with phase 2's tolerances; J1-dry: the dry run's own
     train step (`dryrun.build_train`, m = 4, remat) once on the card at
     J1's batch, its max_memory_allocated; J5: the dry run's CLI
     (`repro_torch.launch.dryrun`, the card's memory) on J1-J4's combos
     (the prefills the card ran through flash and SSD with `--variant
     kernels`), J5_WORKERS (3) processes at a time on the host, started
     in the background after phase 2 (they trace beside paths A-I and
     never touch the card) and read here, each record's bytes, FLOPs,
     memory and (train)
     collective bytes at 8 devices (JAX's convention; by kind and by use:
     the exchange, the gradient's gather, the metrics) beside the measured
     seconds and peak:
     the dry run's peak within 10% of the card's for J1-dry, J2 and J4a-c.  Phase 2 holds flash at J2's shape [8, 32768, 32, 64], full
     causal (row 4j: the last batch row whole and the last 4096 query rows
     of every batch row, against the plain version a block of query rows
     at a time), and at 524,288 tokens with a 4096-key window: J4a's
     attention [1, 524288, 32, 64] (row 4w) and qwen3-14b's long_500k
     attention [1, 524288, 40, 128] on 8 KV heads (row 4L, past 2^31
     elements a batch row), against the plain version run in blocks of
     4096 rows;
 18. path K (after path R, before path J): the sharded PaME step
     (`pame_step(..., param_shardings=)`) in a process of its own, an NCCL
     process group of one rank and a (1, 1, 1) mesh (`make_logical_mesh`),
     path A's model at full width and depth on 4 nodes, node rows 0.01
     apart: the dense exchange (PME average, 10 launches a step, each with
     its receiver range in the sharded step), sparse (f32 gossip, 11),
     compressed and compressed_q8 (no kernel), each sharded step (the
     tensor-parallel route: `lm_grad_fn` takes a view) `torch.equal` to the
     unsharded one (state and loss_mean), and for dense and sparse the
     gather-whole route (a grad_fn that takes none) too; seconds a step,
     peaks and the collective wrapper's counts (one rank: 0 bytes); then
     the network cases (`NET_CASES`: path A's graph with node 1 offline,
     the edge 2-3 down, nodes 2 and 3 read one step back from the
     `temporal` ring, node 3's one message lost): the dense step under the
     realization (PME average, 10 a step), the sparse step under the
     realization, the delivery masks and the stale self view (f32 gossip,
     11), the dense step with the self view (the plain average, as JAX
     routes it: no launch), both routes `torch.equal` to the unsharded
     step, wire_bits too;
 19. path L (after path K, before path J): sharded serving
     (`prefill` / `decode_step` / `ServeLoop` with ``shardings=``,
     `sharding.serving_shardings`), a prefill of 8 x 2048-token prompts and
     greedy decode steps (31 in L1, 7 in L2).  L1: in a process of its
     own, an NCCL process group of one rank and a (1, 1, 1) mesh,
     zamba2-1.2b and stablelm-1.6b
     at full width and depth with flash and SSD: the sharded prefill's
     logits, the tokens, every decode step's logits and the caches
     `torch.equal` to the unsharded run's, flash 7 and SSD 38 launches a
     prefill (stablelm-1.6b: flash 24), prefill ms and decode ms a token.
     L2: two processes sharing the card, a gloo process group over CUDA
     tensors and a (1, 1, 2) mesh, zamba2-1.2b at full depth and
     qwen3-14b at full width and 10 layers: each rank draws the whole
     parameters from seed 0 in turn and keeps its pieces, and launches
     flash (and SSD) on its half of the heads; the parent first runs the
     unsharded bf16 prefill and greedy decode, and the unsharded f32
     prefill and decode (plain route) fed the bf16 run's tokens, at the
     same weights, 8 tokens generated; the ranks' decode steps are fed
     those tokens too.  Held, over bf16's own distance from f32 (by the
     largest difference and by the relative L2 norm): the split prefill's
     and decode steps' logits at most L2_ERROR_RATIO (1.25) from the
     unsharded bf16 logits (measured: about 1, the bf16 partial sums'
     rounding); a third prefill with the row-parallel partial sums taken
     and reduced in f32 at most L2_F32_RATIO (1.0); a fourth with one
     wrong head (two heads' `attn/wo` rows swapped on rank 1) more than
     L2_ERROR_RATIO.  Recorded beside it the argmaxes' agreement with
     the unsharded tokens, each rank's peak beside the dry run's
     per-device peak of the same step (`dryrun.sharded_serving`), and the
     collective calls and bytes by use.  J5 then also sizes prefill_32k,
     decode_32k and long_500k of every arch at the dry run's layout of 8
     devices with a model axis of 8 (`j5_t8_arch`: per-device memory and
     collective bytes);
 20. path M (after path L, before path J): the tensor-parallel train step
     on ranks sharing the card through gloo over CUDA tensors, path A's
     model (stablelm-1.6b in bf16, full width, 4 nodes, 4 x 128 tokens a
     node), one dense step (the PME average, receiver range r = m) and one
     sparse (f32 gossip): M1 two ranks at (1, 1, 2) at full depth, M2 four
     at (1, 2, 2) and M2_LAYERS (4) (the fsdp gathers and their
     reduce-scatters).  The parent
     first runs the unsharded bf16 step and an f32 step at the same weights
     on the plain route; each rank draws the whole state in turn and keeps
     its pieces, runs the gather-whole route (a grad_fn that takes no view:
     the unsharded step's numbers), then the tensor-parallel route, each
     node's gradient pieces held against the gather-whole route's as they
     come.  Held, over bf16's own distance from f32 (by the largest
     difference and by the relative L2 norm): every node's gradient, the
     new state and loss_mean at most M_ERROR_RATIO (1.25); a dense step
     with layer 0's MLP input taken into its rank's columns without its
     entry op (the backward's sum over `model` left out) more than it;
     each rank's peak below the gather-whole route's.  Recorded: seconds a
     step of both routes, each rank's peak, the collective bytes by use
     and the launches.  J5 holds each rank's peak within 10 % of the dry
     run's of the same step (`m_dry`) and records rank 0's collective bytes
     beside the dry run's;
 21. path N (after path M, before path J): the network cases of path K
     with node rows across two ranks sharing the card (gloo over CUDA
     tensors, a (2, 1, 1) mesh, two nodes a rank), path A's model in bf16
     at full width and N_LAYERS (4) layers: the parent first runs the
     unsharded steps alone on the card, then each rank draws the stacks in
     turn, keeps its rows and runs the tensor-parallel route of every case
     (path K holds the gather-whole route).  Held: each rank's
     rows of every new state equal to the parent's by a 64-bit digest of
     every row (`row_digests`), loss_mean, wire_bits and comm_nodes equal,
     the launches (PME average with its receiver range r = 2, f32 gossip
     over the gathered four-row sender stack, none for the self view), and
     `freeze_dropped(shardings=)` equal to the unsharded freeze with the
     offline node's rows back bit for bit.  Recorded: each rank's peak and
     seconds a step.  Phase 2 times both launch forms: the PME average at
     r = 2 (r0 = 0 and 2) and the gossip kernel's two receivers of four
     senders, at path N's largest leaf;
 22. the kernel table line, then the result line.

Exits non-zero with no result when no CUDA device is present, or when the
port's sources are not beside this script.
"""
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()  # the script's start: J5 emits its start and end from it

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM data-sheet peaks (see PERF.md): HBM bytes/s, f32 (non-tensor)
# FLOP/s, bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
BIG_N = 24 * 2048 * 5632  # the largest leaf of stablelm-1.6b (w_gate / w_up / w_down)
FC1_N = 7 * 7 * 64 * 128  # the Example-3 CNN's fc1, path F3's largest leaf
# path I1's largest leaf: deepseek-v2-lite-16b's stacked routed experts
# (w_gate / w_up / w_down) over its 2 MoE layers
I1_LEAF_N = 2 * 64 * 2048 * 1408
M = 4
# elements (columns) at a time in the comparisons and the plain contraction:
# a full-width replica leaf is then never copied whole into f32
CHUNK = 1 << 26
# the parity phases' depth: full width, 2 layers, so that both routes'
# states and the injected uniforms fit beside each other (BEER at full
# depth holds 57.5 GB of state and would need 46 GB of uniforms)
PARITY_LAYERS = 2
# path D's depth (full width): cut from 24 so that the script, path E
# included, stays within the time paths A-D took before path E
PATH_D_LAYERS = 12


def model_args(algo):
    """The trainer CLI's flags of paths A and D: stablelm-1.6b at full width
    and depth, 4 nodes, 4 x 128 tokens a node."""
    return ["--arch", "stablelm-1.6b", "--variant", "full", "--algo", algo,
            "--nodes", str(M), "--batch", "4", "--seq", "128"]


# path C: zamba2-1.2b serving, 8 prompts of 2048 tokens, 32 generated
SERVE = dict(prompt_len=2048, gen=32, batch=8, seed=0)
FLASH_SITES, MAMBA_LAYERS = 7, 38  # zamba2-1.2b: shared-block sites, Mamba2 layers


def emit(**kw):
    print(json.dumps(kw, sort_keys=True), flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps, name="pme_"):
    """The median of a kernel's own durations on the card: `reps` calls of
    fn() (after a warm one) under ``torch.profiler``'s CUDA activity, the
    kernels whose name holds `name`.  Beside `time_ms` (CUDA events around
    the call, the host's work in the wrapper included), what the card
    spent."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    if not 1 <= len(times) <= reps:  # CUPTI may drop a record; never invents one
        fail(f"the profiler saw {len(times)} {name} kernels of {reps} launched")
    return statistics.median(times)


def bf16_ulps(got, want):
    """max |got - want| in units of one bf16 ulp of want."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
    return ((got.float() - w).abs() / ulp).max().item()


def ulps_floored(got, want, mantissa=7):
    """max |got - want| in ulps of max(|want|, max|want| / 256) in a type
    with `mantissa` stored bits (bf16 7, f32 23): below 1/256 of the
    output's scale, f32 sums taken in another order differ by more than an
    ulp of the tiny value itself.  CHUNK elements at a time."""
    import torch

    floor = chunked_max(lambda w: w.abs().max().float(), want) / 256
    worst = 0.0
    for g, w in zip(got.reshape(-1).split(CHUNK), want.reshape(-1).split(CHUNK)):
        w = w.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp(min=max(floor, 2.0 ** -126)))) - mantissa)
        worst = max(worst, ((g.float() - w).abs() / ulp).max().item())
    return worst


def chunked_max(fn, *tensors):
    """max over CHUNK-element slices of fn(slices...) (a 0-d tensor each):
    a full-size f32 temporary of a 2.7e9-element output would be 10.7 GB."""
    flat = [t.reshape(-1) for t in tensors]
    return max(fn(*(f[i:i + CHUNK] for f in flat)).item()
               for i in range(0, flat[0].numel(), CHUNK))


def bound(bytes_, flops, peak=BF16_FLOPS):
    """(least ms, what bounds it): the larger of bytes over the HBM rate and
    operations over the peak."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def free():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_gossip(dev):
    """The gossip kernel's f32 and bf16 variants on odd shapes and at the
    training paths' largest leaf.  f32: equal to the slots chain bit for
    bit and to the plain version within 1e-6.  bf16: equal bit for bit to
    the f32 slots chain on x.float() rounded once to bf16.  Returns the
    largest-leaf row of each variant."""
    import torch
    from repro_torch.core import mixing
    from repro_torch.core.mixing import make_mixer
    from repro_torch.core.topology import build_topology
    from repro_torch.kernels.gossip.ops import gather_terms_kernel
    from repro_torch.kernels.gossip.ref import gather_terms_ref
    from repro_torch.serve import membership

    def case(name, nbrs, w, pad, xs, reps=0):
        terms = [(w, x) for x in xs]
        clean = torch.where(pad, torch.zeros_like(w), w) if pad is not None else w
        dtype = xs[0].dtype
        got = gather_terms_kernel(nbrs, terms, pad=pad)
        plain = gather_terms_ref(nbrs, [(clean, x) for x in xs])
        # the kernel's arithmetic: f32 slots chain, rounded once to x's type
        slots = [o.to(dtype) for o in
                 mixing.gather_terms(nbrs, [(clean, x.float()) for x in xs], impl="slots")]
        torch.cuda.synchronize()
        err = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, plain))
        scale = max(1.0, max(p.float().abs().max().item() for p in plain))
        same = all(torch.equal(g, s) for g, s in zip(got, slots))
        finite = all(torch.isfinite(g).all().item() for g in got)
        row = {"kernel": "gossip_gather", "variant": "bf16" if dtype == torch.bfloat16 else "f32",
               "case": name, "m": nbrs.shape[0], "senders": xs[0].shape[0],
               "n": xs[0][0].numel(), "k": nbrs.shape[1], "terms": len(xs),
               "equals_f32_slots_rounded": same, "finite": finite}
        if dtype == torch.float32:
            row.update(max_abs_err=err, tol=1e-6 * scale)
            ok = err <= 1e-6 * scale
        else:  # the plain version rounds its f32 matmul once too: within 1 ulp
            row.update(max_abs_err=max((g.float() - s.float()).abs().max().item()
                                       for g, s in zip(got, slots)),
                       plain_bf16_ulps_floored=max(ulps_floored(g, p)
                                                   for g, p in zip(got, plain)),
                       tol="bit-equal to the f32 slots chain rounded to bf16")
            ok = row["plain_bf16_ulps_floored"] <= 1.0
        del slots, plain, got
        if not (ok and same and finite):
            emit(**row)
            fail(f"gossip kernel disagrees with its plain version ({name}, {row['variant']})")
        if reps:
            free()  # the segsum library call below holds [m * k, n] f32 products
            m, k = nbrs.shape
            n = xs[0][0].numel()
            row["ms"] = time_ms(lambda: gather_terms_kernel(nbrs, terms, pad=pad), reps)
            row["plain_ms"] = time_ms(lambda: gather_terms_ref(nbrs, terms, pad=pad), reps)
            row["library_ms"] = time_ms(
                lambda: mixing.gather_terms(nbrs, terms, pad=pad, impl="segsum"), reps)
            # the sender rows the function reads: those its unpadded slots
            # name (a rank's receivers may leave rows of the stack unread)
            row["senders_read"] = int(torch.unique(nbrs if pad is None else nbrs[~pad]).numel())
            bytes_ = (len(xs) * (row["senders_read"] + m) * n * xs[0].element_size()
                      + nbrs.numel() * 4 + w.numel() * 4)
            flops = 2 * len(xs) * m * k * n  # f32 multiply-adds on the CUDA cores
            row["bound_ms"], row["bound_by"] = bound(bytes_, flops, F32_FLOPS)
            row["bound_share"] = row["bound_ms"] / row["ms"]
        emit(**row)
        return row

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)

    def from_topo(kind, m, **kw):
        nbrs, w, is_self = (torch.as_tensor(x, device=dev) for x in
                            build_topology(kind, m, **kw).mixing_padded())
        pad = (nbrs == torch.arange(m, device=dev)[:, None]) & ~is_self
        return nbrs, torch.where(pad, torch.full_like(w, float("nan")), w), pad

    iso_nbrs = torch.tensor([[1, 0], [0, 1], [0, 2], [3, 3]], device=dev)
    iso_w = torch.tensor([[0.5, 0.5], [0.5, 0.5], [1.0, 0.0], [1.0, float("nan")]], device=dev)
    iso_pad = torch.tensor([[0, 0], [0, 0], [0, 0], [0, 1]], dtype=torch.bool, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        t = "" if dtype == torch.float32 else "-bf16"
        cast = lambda *s: rnd(*s).to(dtype)  # noqa: E731
        case("er-m7-n257" + t, *from_topo("erdos_renyi", 7, p=0.5, seed=3),
             [cast(7, 257), cast(7, 257)])
        case("star-hub-nan-pad" + t, *from_topo("star", 9), [cast(9, 1000)])
        x = cast(4, 11)
        case("isolated-node" + t, iso_nbrs, iso_w, iso_pad, [x])
        out = gather_terms_kernel(iso_nbrs, [(iso_w, x)], pad=iso_pad)[0]
        if not torch.equal(out[3], x[3]):
            fail(f"gossip kernel changed an isolated node's own row ({dtype})")
        case("ring-m40" + t, *from_topo("ring", 40), [cast(40, 130)])
    case("er-m7-n2056-bf16", *from_topo("erdos_renyi", 7, p=0.5, seed=3),
         [rnd(7, 2056).to(torch.bfloat16)])

    # the path's largest leaf: PME payload + count walks over path A's table
    topo = build_topology("erdos_renyi", M, p=0.5, seed=0)
    nbrs, valid = (torch.as_tensor(v, device=dev) for v in topo.neighbor_matrix_padded())
    sel = valid.clone()
    sel[0] = False  # a silent receiver, as between communication rounds
    mask = torch.rand((M, BIG_N), generator=g, device=dev) < 0.2
    payload = torch.randn((M, BIG_N), generator=g, device=dev).to(torch.bfloat16) * mask
    xs = [payload.float(), mask.float()]
    del payload, mask
    row = case("path-a-largest-leaf", nbrs, sel.float(), ~valid, xs, reps=5)
    del xs
    free()
    # path G1's largest leaf at m = 5: the same walks over the table of the
    # graph its join@3 grows (one node attached to two)
    nbrs, valid = (torch.as_tensor(v, device=dev) for v in
                   membership.grown_topology(topo, 1, degree=2, seed=0).neighbor_matrix_padded())
    sel = valid.clone()
    sel[0] = False
    mask = torch.rand((M + 1, BIG_N), generator=g, device=dev) < 0.2
    payload = torch.randn((M + 1, BIG_N), generator=g, device=dev).to(torch.bfloat16) * mask
    xs = [payload.float(), mask.float()]
    del payload, mask
    row_grown = case("path-g1-grown-largest-leaf", nbrs, sel.float(), ~valid, xs, reps=5)
    del xs
    free()
    # path I1's largest leaf (deepseek-v2-lite-16b's routed experts): the
    # same walks over path A's table
    nbrs, valid = (torch.as_tensor(v, device=dev) for v in topo.neighbor_matrix_padded())
    sel = valid.clone()
    sel[0] = False
    mask = torch.rand((M, I1_LEAF_N), generator=g, device=dev) < 0.2
    payload = torch.randn((M, I1_LEAF_N), generator=g, device=dev).to(torch.bfloat16) * mask
    xs = [payload.float(), mask.float()]
    del payload, mask
    row_i1 = case("path-i1-largest-leaf", nbrs, sel.float(), ~valid, xs, reps=5)
    del xs
    free()
    # path M's launch: a rank's piece of path A's largest leaf over `model`
    # (half its columns), the same walks over path A's table
    mask = torch.rand((M, BIG_N // 2), generator=g, device=dev) < 0.2
    payload = torch.randn((M, BIG_N // 2), generator=g, device=dev).to(torch.bfloat16) * mask
    xs = [payload.float(), mask.float()]
    del payload, mask
    row_m = case("path-m-rank-piece", nbrs, sel.float(), ~valid, xs, reps=5)
    del xs
    free()
    # path N's launch on rank 1: its two receivers (nodes 2 and 3) walking
    # the gathered four-row sender stack of path N's largest leaf
    mask = torch.rand((M, N_LEAF_N), generator=g, device=dev) < 0.2
    payload = torch.randn((M, N_LEAF_N), generator=g, device=dev).to(torch.bfloat16) * mask
    xs = [payload.float(), mask.float()]
    del payload, mask
    row_n = case("path-n-rank-receivers", nbrs[2:], sel.float()[2:], ~valid[2:], xs, reps=5)
    del xs
    free()
    # path D's largest leaf: one bf16 term over the baselines' sparse Mixer
    mx = make_mixer(topo, "sparse", device=dev)
    x = torch.randn((M, BIG_N), generator=g, device=dev).to(torch.bfloat16)
    row_bf16 = case("path-d-largest-leaf-bf16", mx.pm.nbrs, mx.pm.w, mx.pm.pad, [x], reps=5)
    del x
    free()
    # path E5's largest leaf: rep-CHOCO's replica mix, a held leaf [4, d + 1,
    # n] read in place as 16 sender rows, as `mixing.mix_replicated` hands
    # it to the kernel; row-stochastic weights with one lost link (weight 0)
    d = int(valid.shape[1])
    held = torch.randn((M, d + 1, BIG_N), generator=g, device=dev).to(torch.bfloat16)
    w = torch.rand((M, d + 1), generator=g, device=dev)
    w[0, 0] = 0.0
    w /= w.sum(dim=1, keepdim=True)
    row_rep = case("path-e5-replica-mix-largest-leaf-bf16", mixing.replica_table(M, d, dev), w,
                   None, [held.view(M * (d + 1), BIG_N)], reps=3)
    del held
    free()
    # path F3's largest leaf: D-PSGD's f32 mix of the CNN's fc1 on the complete graph
    mx = make_mixer(build_topology("complete", M), "sparse", device=dev)
    x = torch.randn((M, FC1_N), generator=g, device=dev)
    row_fc1 = case("path-f3-fc1", mx.pm.nbrs, mx.pm.w, mx.pm.pad, [x], reps=50)
    return {"f32": row, "bf16": row_bf16, "bf16_replicas": row_rep, "f32_fc1": row_fc1,
            "f32_grown": row_grown, "f32_path_i": row_i1, "f32_path_m": row_m,
            "f32_path_n": row_n}


def check_pme(dev):
    import torch
    from repro_torch.core import pme
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.kernels.pme_average.ref import pme_average_ref

    g = torch.Generator(device=dev).manual_seed(1)

    def case(name, w, masks, a, reps=0):
        got = pme_average_cuda(w, masks, a)
        plain = pme_average_ref(w, masks.to(w.dtype), a)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        if w.dtype == torch.float32:
            scale = max(1.0, plain.abs().max().item())
            ok, tol = err <= 1e-6 * scale, 1e-6 * scale
        else:
            ulps = bf16_ulps(got, plain)
            ok, tol = ulps <= 1.0, "1 bf16 ulp"
        row = {"kernel": "pme_average", "case": name, "m": w.shape[0], "n": w.shape[1],
               "dtype": str(w.dtype), "mask": str(masks.dtype), "max_abs_err": err, "tol": tol}
        if not ok or not torch.isfinite(got).all():
            emit(**row)
            fail(f"pme_average kernel disagrees with its plain version ({name})")
        if reps:
            m, n = w.shape
            row["ms"] = time_ms(lambda: pme_average_cuda(w, masks, a), reps)
            row["plain_ms"] = time_ms(lambda: pme_average_ref(w, masks, a), reps)

            def library():  # the einsum form of repro/core/pme.py:158-161
                wm = torch.where(masks, w, 0)
                at = a.to(w.dtype)
                agg = torch.einsum("jn,ji->in", wm, at)
                cnt = torch.einsum("jn,ji->in", masks.to(w.dtype), at)
                return torch.where(cnt > 0, agg / cnt.clamp(min=1), w)

            row["library_ms"] = time_ms(library, reps)
            bytes_ = m * n * (2 * w.element_size() + masks.element_size()) + a.numel() * 4
            flops = 4 * m * m * n
            row["bound_ms"] = max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            row["bound_by"] = "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"
            row["device_ms"] = device_ms(lambda: pme_average_cuda(w, masks, a), reps)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
            row["inputs_digest"] = inputs_digest(w, masks, a)
        emit(**row)
        return row

    def sel(m, p=0.5):
        a = ((torch.rand((m, m), generator=g, device=dev) < p)
             & ~torch.eye(m, dtype=torch.bool, device=dev)).float()
        a[:, 1] = 0  # receiver 1 isolated: keeps its own row
        return a

    for dtype in (torch.float32, torch.bfloat16):
        for name, m, n in (("m7-n257", 7, 257), ("m37-more-receivers-than-a-tile", 37, 130)):
            w = torch.randn((m, n), generator=g, device=dev).to(dtype)
            masks = torch.rand((m, n), generator=g, device=dev) < 0.3
            case(f"{name}-{dtype}", w, masks, sel(m))
            case(f"{name}-mask-in-w-type-{dtype}", w, masks.to(dtype), sel(m))
        star = torch.zeros((9, 9), device=dev)
        star[1:, 0] = 1  # hub 0 hears every leaf node
        star[0, 1:] = 1  # every leaf hears the hub
        w = torch.randn((9, 4096), generator=g, device=dev).to(dtype)
        case(f"star-hub-{dtype}", w, torch.rand((9, 4096), generator=g, device=dev) < 0.2, star)

    # the path's largest leaf: bf16 W, exact masks, path B's selection
    w = torch.randn((M, BIG_N), generator=g, device=dev).to(torch.bfloat16)
    masks = pme.sample_coordinate_masks(g, M, BIG_N, round(0.2 * BIG_N))
    a = torch.zeros((M, M), device=dev)
    a[[1, 0, 3, 2], [0, 1, 2, 3]] = 1
    row = case("path-b-largest-leaf", w, masks, a, reps=5)
    del w, masks
    free()
    # path F3's PaME leaf: the CNN's fc1 in f32, exact masks at p = 0.3, a
    # selection of t_i = 2 of 3 neighbours on the complete graph
    ta = f3_topology_arrays(dev)
    comm = torch.ones(M, dtype=torch.bool, device=dev)
    a = pme.sample_neighbor_selection(g, ta.nbrs, ta.valid, ta.t, comm)
    w = torch.randn((M, FC1_N), generator=g, device=dev)
    masks = pme.sample_coordinate_masks(g, M, FC1_N, round(0.3 * FC1_N))
    row_fc1 = case("path-f3-fc1", w, masks, a, reps=50)
    return row, row_fc1


def check_pme_range(dev):
    """The PME average's receiver range (every row sends, receivers r0 ...
    r0 + r - 1, what a rank of a sharded step computes for its nodes)
    against its plain version, at r = 1 (r0 = 1: a rank of node = 4) and
    r = 2 (r0 = 2: of node = 2) of m = 4, at path B's largest leaf in bf16
    (row 1r) and at F3's fc1 in f32 (row 1rf), at path K's own launch,
    r = m = 4 (r0 = 0: its one rank) on path A's largest leaf in f32 (row
    1rk), at path M's, r = m = 4 on a rank's half of that leaf's
    columns in bf16 (row 1rm), and at path N's, r = 2 (r0 = 0 and 2: its
    two ranks) of path N's largest leaf in bf16 (row 1rn); phase 2's
    tolerances.  The bound counts what the function needs:
    m·n reads of W and of the masks (the receivers' own rows are among
    the senders' rows) and r·n writes; the kernel takes a receiver's fill
    from its row as read for the sums."""
    import torch
    from repro_torch.core import pme
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.kernels.pme_average.ref import pme_average_ref

    g = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    halves = ((1, 1), (2, 2))
    for name, n, dtype, p, reps, ranges in (
            ("1r", BIG_N, torch.bfloat16, 0.2, 5, halves),
            ("1rf", FC1_N, torch.float32, 0.3, 50, halves),
            ("1rk", BIG_N, torch.float32, 0.2, 5, ((0, M),)),
            ("1rm", BIG_N // 2, torch.bfloat16, 0.2, 5, ((0, M),)),
            ("1rn", N_LEAF_N, torch.bfloat16, 0.2, 5, ((0, 2), (2, 2)))):
        w = torch.randn((M, n), generator=g, device=dev).to(dtype)
        masks = pme.sample_coordinate_masks(g, M, n, round(p * n))
        a = ((torch.rand((M, M), generator=g, device=dev) < 0.6)
             & ~torch.eye(M, dtype=torch.bool, device=dev)).float()
        a[:, 1] = 0  # receiver 1 hears nobody: its own row is the fill
        for r0, r in ranges:
            got = pme_average_cuda(w, masks, a, receivers=(r0, r))
            plain = pme_average_ref(w, masks.to(dtype), a, receivers=(r0, r))
            square = pme_average_cuda(w, masks, a)
            torch.cuda.synchronize()
            err = (got.float() - plain.float()).abs().max().item()
            if dtype == torch.float32:
                tol = 1e-6 * max(1.0, plain.abs().max().item())
                ok = err <= tol
            else:
                tol = "1 bf16 ulp"
                ok = bf16_ulps(got, plain) <= 1.0
            # path N's two ranks take r = 2 at r0 = 0 and 2: its keys carry r0
            key = f"{name}-r{r}" + (f"@{r0}" if name == "1rn" else "")
            row = {"kernel": "pme_average", "case": f"receivers-{key}", "m": M, "n": n,
                   "r0": r0, "r": r, "dtype": str(dtype), "max_abs_err": err, "tol": tol,
                   "square_rows_equal": bool(torch.equal(got, square[r0:r0 + r]))}
            if not ok or not row["square_rows_equal"] or not torch.isfinite(got).all():
                emit(**row)
                fail(f"pme_average's receiver range disagrees ({row['case']})")
            del square, plain
            row["ms"] = time_ms(lambda: pme_average_cuda(w, masks, a, receivers=(r0, r)), reps)
            row["plain_ms"] = time_ms(
                lambda: pme_average_ref(w, masks, a, receivers=(r0, r)), reps)

            def library():  # the einsum form over the receivers' columns
                wm = torch.where(masks, w, 0)
                at = a[:, r0:r0 + r].to(w.dtype)
                agg = torch.einsum("jn,ji->in", wm, at)
                cnt = torch.einsum("jn,ji->in", masks.to(w.dtype), at)
                return torch.where(cnt > 0, agg / cnt.clamp(min=1), w[r0:r0 + r])

            row["library_ms"] = time_ms(library, reps)
            bytes_ = M * n * w.element_size() + M * n * masks.element_size() \
                + r * n * w.element_size() + a.numel() * 4
            row["bound_ms"], row["bound_by"] = bound(bytes_, 4 * M * r * n, F32_FLOPS)
            row["device_ms"] = device_ms(
                lambda: pme_average_cuda(w, masks, a, receivers=(r0, r)), reps)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
            row["inputs_digest"] = inputs_digest(w, masks, a)
            emit(**row)
            rows[key] = row
        del w, masks, got
        free()
    return rows


def check_lanes(dev):
    """The lane forms at path H's shapes.  PME average with its lane axis
    at [2, 4, BIG_N] bf16 (path B's leaf, 2 lanes) and at H3's largest
    leaf [5, 4, 36,864] f32; the gossip kernel on the lane-offset table of
    2 lanes of path A's graph, [8, H1_LEAF_N] f32, PaME's two walks (H1's
    largest leaf, the embedding).  Each against its plain version (the PME average's lane
    loop, the dense scatter product) and, lane by lane, against one
    single-lane launch (bit-equal).  Library: the lane-batched einsum
    (PME) and one batched matmul a term over the lanes' [m, m] scatter
    matrices (gossip).  Bound: L times the bytes of one lane."""
    import torch
    from repro_torch.core import pme
    from repro_torch.core.topology import build_topology
    from repro_torch.kernels.gossip.ops import gather_terms_kernel
    from repro_torch.kernels.gossip.ref import gather_terms_ref
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.kernels.pme_average.ref import pme_average_ref

    g = torch.Generator(device=dev).manual_seed(5)
    rows = {}

    def pme_case(name, w, masks, a, reps):
        lanes, m, n = w.shape
        got = pme_average_cuda(w, masks, a)
        plain = pme_average_ref(w, masks.to(w.dtype), a)
        torch.cuda.synchronize()
        row = {"kernel": "pme_average", "variant": "lanes", "case": name, "lanes": lanes,
               "m": m, "n": n, "dtype": str(w.dtype),
               "max_abs_err": (got.float() - plain.float()).abs().max().item(),
               "lanes_bit_equal_single": all(torch.equal(got[lane], pme_average_cuda(
                   w[lane], masks[lane], a[lane])) for lane in range(lanes))}
        if w.dtype == torch.float32:
            ok = row["max_abs_err"] <= 1e-6 * max(1.0, plain.abs().max().item())
        else:
            row["bf16_ulps"] = bf16_ulps(got, plain)
            ok = row["bf16_ulps"] <= 1.0
        del got, plain
        free()
        if not (ok and row["lanes_bit_equal_single"]):
            emit(**row)
            fail(f"pme_average lane axis disagrees ({name})")
        row["ms"] = time_ms(lambda: pme_average_cuda(w, masks, a), reps)
        row["plain_ms"] = time_ms(lambda: pme_average_ref(w, masks.to(w.dtype), a), reps)

        def library():  # the einsum form with the lane axis
            wm = torch.where(masks, w, 0)
            at = a.to(w.dtype)
            agg = torch.einsum("ljn,lji->lin", wm, at)
            cnt = torch.einsum("ljn,lji->lin", masks.to(w.dtype), at)
            return torch.where(cnt > 0, agg / cnt.clamp(min=1), w)

        row["library_ms"] = time_ms(library, reps)
        bytes_ = lanes * (m * n * (2 * w.element_size() + masks.element_size()) + m * m * 4)
        row["bound_ms"], row["bound_by"] = bound(bytes_, 4 * lanes * m * m * n, F32_FLOPS)
        row["device_ms"] = device_ms(lambda: pme_average_cuda(w, masks, a), reps)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
        row["inputs_digest"] = inputs_digest(w, masks, a)
        emit(**row)
        return row

    # path B's largest leaf, two lanes: bf16 W, exact masks, two selections
    w = torch.randn((2, M, BIG_N), generator=g, device=dev).to(torch.bfloat16)
    masks = torch.stack([pme.sample_coordinate_masks(g, M, BIG_N, round(0.2 * BIG_N))
                         for _ in range(2)])
    a = torch.zeros((2, M, M), device=dev)
    a[0, [1, 0, 3, 2], [0, 1, 2, 3]] = 1
    a[1, [2, 3, 0, 1], [0, 1, 2, 3]] = 1
    rows["pme_lanes"] = pme_case("path-h-lanes-largest-leaf", w, masks, a, reps=5)
    del w, masks
    free()
    # H3's largest leaf (a stage-3 3x3 conv of ResNet-20), five lanes
    ta = f3_topology_arrays(dev)
    comm = torch.ones(M, dtype=torch.bool, device=dev)
    n3 = 3 * 3 * 64 * 64
    a = torch.stack([pme.sample_neighbor_selection(g, ta.nbrs, ta.valid, ta.t, comm)
                     for _ in range(H_SEEDS)])
    w = torch.randn((H_SEEDS, M, n3), generator=g, device=dev)
    masks = torch.stack([pme.sample_coordinate_masks(g, M, n3, round(0.3 * n3))
                         for _ in range(H_SEEDS)])
    rows["pme_lanes_h3"] = pme_case("path-h3-resnet-conv-5-lanes", w, masks, a, reps=50)
    del w, masks

    # H1's largest leaf (the embedding at H1_LAYERS layers): PaME's payload
    # and count walks over 2 lanes of path A's table, folded (every slot of
    # lane l offset by l·m)
    lanes = 2
    nbrs, valid = (torch.as_tensor(v, device=dev) for v in
                   build_topology("erdos_renyi", M, p=0.5, seed=0).neighbor_matrix_padded())
    sel = valid.clone()
    sel[0] = False  # a silent receiver, as between communication rounds
    fnbrs = torch.cat([nbrs + lane * M for lane in range(lanes)]).to(torch.int32)
    fsel, fpad = sel.float().repeat(lanes, 1), (~valid).repeat(lanes, 1)
    mask = torch.rand((lanes * M, H1_LEAF_N), generator=g, device=dev) < 0.2
    payload = torch.randn((lanes * M, H1_LEAF_N), generator=g, device=dev)
    payload = payload.to(torch.bfloat16) * mask
    xs = [payload.float(), mask.float()]
    del payload, mask
    terms = [(fsel, x) for x in xs]
    got = gather_terms_kernel(fnbrs, terms, pad=fpad)
    plain = gather_terms_ref(fnbrs, terms, pad=fpad)
    torch.cuda.synchronize()
    row = {"kernel": "gossip_gather", "variant": "f32_lanes", "case": "path-h1-folded-embedding",
           "lanes": lanes, "m": lanes * M, "n": H1_LEAF_N, "k": int(nbrs.shape[1]), "terms": 2,
           "max_abs_err": max((o - p).abs().max().item() for o, p in zip(got, plain)),
           "tol": 1e-6 * max(1.0, max(p.abs().max().item() for p in plain))}
    del plain
    free()
    row["lanes_bit_equal_single"] = all(
        torch.equal(o[lane * M:(lane + 1) * M], one)
        for lane in range(lanes)
        for o, one in zip(got, gather_terms_kernel(
            nbrs.to(torch.int32), [(sel.float(), x[lane * M:(lane + 1) * M]) for x in xs],
            pad=~valid)))
    del got
    free()
    if not (row["max_abs_err"] <= row["tol"] and row["lanes_bit_equal_single"]):
        emit(**row)
        fail("gossip kernel on the lane-offset table disagrees with its plain version "
             "or with one launch a lane")
    rows_i = torch.arange(M, device=dev)[:, None].expand_as(nbrs)
    scatter = torch.zeros((M, M), device=dev).index_put_(
        (rows_i, nbrs.long()), torch.where(~valid, 0.0, sel.float()), accumulate=True)
    scatter = scatter.expand(lanes, M, M).contiguous()
    row["ms"] = time_ms(lambda: gather_terms_kernel(fnbrs, terms, pad=fpad), 5)
    row["plain_ms"] = time_ms(lambda: gather_terms_ref(fnbrs, terms, pad=fpad), 5)
    row["library_ms"] = time_ms(
        lambda: [torch.bmm(scatter, x.view(lanes, M, H1_LEAF_N)) for x in xs], 5)
    bytes_ = 2 * (2 * lanes * M) * H1_LEAF_N * 4 + fnbrs.numel() * 4 + fsel.numel() * 4
    row["bound_ms"], row["bound_by"] = bound(
        bytes_, 2 * 2 * lanes * M * nbrs.shape[1] * H1_LEAF_N, F32_FLOPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit(**row)
    rows["gossip_f32_lanes"] = row
    del xs, terms
    free()
    return rows


def f3_topology_arrays(dev):
    """Path F3's topology arrays: the complete graph on M nodes, EX3_CFG."""
    from repro_torch.core import build_topology, pame

    return pame.make_topology_arrays(build_topology("complete", M), pame.PaMEConfig(**EX3_CFG),
                                     seed=0, device=dev)


def _hold(kernel, case, got, want, plain_work, row):
    """Hold a kernel's output against its plain version fed the same inputs
    in f32: 1e-5 x scale for an f32 output, one bf16 ulp (floored at 1/256
    of the scale) for a bf16 one."""
    import torch

    absdiff = lambda a, b: (a.float() - b.float()).abs().max()  # noqa: E731
    err = chunked_max(absdiff, got, want)
    scale = max(1.0, chunked_max(lambda w: w.abs().max(), want))
    if got.dtype == torch.float32:
        ok, tol = err <= 1e-5 * scale, 1e-5 * scale
    else:
        row["bf16_ulps"] = chunked_max(lambda g, w: torch.tensor(bf16_ulps(g, w)), got, want)
        row["bf16_ulps_floored"] = ulps_floored(got, want)
        ok, tol = row["bf16_ulps_floored"] <= 1.0, "1 bf16 ulp (floored)"
        # against the plain version in the working type
        row["err_vs_plain_bf16"] = chunked_max(absdiff, got, plain_work)
    row.update(kernel=kernel, case=case, max_abs_err=err, tol=tol)
    if not ok or not torch.isfinite(got).all():
        emit(**row)
        fail(f"{kernel} kernel disagrees with its plain version ({case})")


def check_flash(dev):
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_variant
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device=dev).manual_seed(2)

    def case(name, b, s, h, kv, d, win, dtype, reps=0):
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
        got = flash_attention_cuda(q, k, v, window=win)
        want = attention_ref(q.float(), k.float(), v.float(), win)
        plain = attention_ref(q, k, v, win) if dtype != torch.float32 else want
        torch.cuda.synchronize()
        row = {"shape": [b, s, h, kv, d], "window": win, "dtype": str(dtype),
               "variant": flash_variant(dtype, d)}
        _hold("flash_attention", name, got, want, plain, row)
        del want, plain
        if reps:
            row["ms"] = time_ms(lambda: flash_attention_cuda(q, k, v, window=win), reps)
            row["plain_ms"] = time_ms(lambda: attention_ref(q, k, v, win), reps)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, heads, S, D]
            row["library_ms"] = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=kv != h), reps)
            flops = 4 * b * h * d * (s * (s + 1) // 2)  # q.k and p.v, causal half
            bytes_ = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            row["bound_ms"], row["bound_by"] = bound(bytes_, flops)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["bound_ms_f32_cuda_cores"] = bound(bytes_, flops, F32_FLOPS)[0]
            row["flops"], row["bytes"] = flops, bytes_
        emit(**row)
        return row

    # tests/test_kernels.py's sweep: window < block, extreme GQA
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 64, 4, 2, 16, None), (1, 128, 4, 4, 32, None), (2, 64, 4, 2, 16, 24),
                      (1, 64, 8, 1, 64, None), (1, 32, 2, 2, 8, 5)):
            case(f"sweep-{shape}-{dtype}", *shape, dtype)
    # the tensor-core variant: S not a multiple of a tile, a window inside
    # one tile, D = 128, qwen3's 40/8 grouping; one query row, one key past
    # a 64-key tile, a window longer than S, 20/4 GQA at D = 128, three
    # batch rows of a ragged S
    for shape in ((2, 300, 4, 2, 64, None), (1, 1000, 2, 1, 64, 5), (1, 200, 4, 4, 128, 70),
                  (1, 130, 40, 8, 128, None), (1, 1, 2, 1, 64, None), (1, 65, 4, 2, 128, None),
                  (1, 300, 4, 2, 64, 1000), (1, 257, 20, 4, 128, None),
                  (3, 333, 4, 1, 64, None)):
        case(f"tc-{shape}", *shape, torch.bfloat16)
    row = case("path-c", 8, 2048, 32, 32, 64, None, torch.bfloat16, reps=10)
    free()
    # path I3's shape: qwen3-14b's 8 x 2048-token prefill, 40 heads on 8 KV heads
    row_i3 = case("path-i3", 8, 2048, 40, 8, 128, None, torch.bfloat16, reps=10)
    free()
    # path L2's shapes: a rank's half of zamba2-1.2b's and of qwen3-14b's heads
    rows_l2 = {"path-l2-zamba2": case("path-l2-zamba2", 8, 2048, 16, 16, 64, None,
                                      torch.bfloat16, reps=10)}
    free()
    rows_l2["path-l2-qwen3"] = case("path-l2-qwen3", 8, 2048, 20, 4, 128, None, torch.bfloat16,
                                    reps=10)
    free()
    return row, row_i3, rows_l2


def check_ssd(dev):
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_cuda, ssd_variant
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

    gen = torch.Generator(device=dev).manual_seed(3)

    def case(name, b, nc, l, h, p, g, n, dtype, reps=0):
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
        xc = rnd(b, nc, l, h, p).to(dtype)
        dtc = torch.rand((b, nc, l, h), generator=gen, device=dev) * 0.2 + 0.01
        cum = torch.cumsum(dtc * -torch.exp(rnd(h) * 0.2), dim=2)
        bc, cc = rnd(b, nc, l, g, n).to(dtype), rnd(b, nc, l, g, n).to(dtype)
        y, st = ssd_intra_chunk_cuda(xc, dtc, cum, bc, cc, h // g)
        y_r, st_r = ssd_intra_chunk_ref(xc.float(), dtc, cum, bc.float(), cc.float(), h // g)
        y_p = ssd_intra_chunk_ref(xc, dtc, cum, bc, cc, h // g)[0] if dtype != torch.float32 else y_r
        torch.cuda.synchronize()
        row = {"shape": [b, nc, l, h, p, g, n], "dtype": str(dtype),
               "variant": ssd_variant(dtype, l, p, n)}
        _hold("ssd_intra_chunk", name, y, y_r, y_p, row)
        st_err = (st - st_r).abs().max().item()
        row["state_max_abs_err"] = st_err
        if st_err > 1e-5 * max(1.0, st_r.abs().max().item()) or not torch.isfinite(st).all():
            emit(**row)
            fail(f"ssd_intra_chunk state disagrees with its plain version ({name})")
        row["max_abs_err"] = max(row["max_abs_err"], st_err)
        del y_r, st_r, y_p
        if reps:
            row["ms"] = time_ms(lambda: ssd_intra_chunk_cuda(xc, dtc, cum, bc, cc, h // g), reps)
            row["plain_ms"] = time_ms(lambda: ssd_intra_chunk_ref(xc, dtc, cum, bc, cc, h // g), reps)
            row["library_ms"] = None  # no single PyTorch call computes this function
            pairs = l * (l + 1) // 2
            flops = 2 * b * nc * h * (pairs * (n + p) + l * p * n)  # W, W x, state (causal half)
            bytes_ = (2 * xc.numel() + 2 * bc.numel()) * xc.element_size() \
                + 2 * dtc.numel() * 4 + st.numel() * 4
            row["bound_ms"], row["bound_by"] = bound(bytes_, flops)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["bound_ms_f32_cuda_cores"] = bound(bytes_, flops, F32_FLOPS)[0]
            row["flops"], row["bytes"] = flops, bytes_
        emit(**row)
        return row

    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 3, 16, 4, 8, 2, 8), (1, 2, 32, 2, 16, 1, 4), (1, 1, 8, 8, 4, 4, 16)):
            case(f"jax-{shape}-{dtype}", *shape, dtype)
    # the tensor-core variant: a short chunk, G > 1, P = 128 with N = 48
    for shape in ((1, 3, 64, 4, 64, 1, 64), (2, 2, 128, 8, 32, 2, 32), (1, 2, 112, 4, 128, 2, 48)):
        case(f"tc-{shape}", *shape, torch.bfloat16)
    row = case("path-c", 8, 16, 128, 64, 64, 1, 64, torch.bfloat16, reps=10)
    free()
    # mamba2-1.3b's chunk: the same heads with a 128-wide state (path J4b's)
    row_n128 = case("mamba2-1.3b-n128", 8, 16, 128, 64, 64, 1, 128, torch.bfloat16, reps=10)
    free()
    # path L2's chunk: a rank's half of zamba2-1.2b's heads
    row_l2 = case("path-l2-zamba2", 8, 16, 128, 32, 64, 1, 64, torch.bfloat16, reps=10)
    free()
    return row, row_n128, row_l2


def windowed_plain(q, k, v, window):
    """Causal attention with a window of `window` keys in plain PyTorch at
    any length: each block of `window` query rows through `attention_ref`
    on the 2 x window positions that hold its keys (the rows before the
    block are dropped).  The same function as the kernel's; its score
    buffer is [.., 2w, 2w] a block instead of [.., S, S]."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref

    s = q.shape[1]
    out = torch.empty_like(q)
    for lo in range(0, s, window):
        first, hi = max(0, lo - window), min(s, lo + window)
        out[:, lo:hi] = attention_ref(q[:, first:hi], k[:, first:hi], v[:, first:hi],
                                      window)[:, lo - first:]
    return out


def causal_plain_rows(q, k, v, lo, block):
    """Query rows lo..S of causal attention (no window) in plain PyTorch:
    `attention_ref`'s math (scores in the inputs' type, then an f32 softmax,
    f64 for f64 inputs)
    on `block` query rows at a time, each block against the keys up to its
    last row, so the score buffer is [.., block, <= S] instead of [.., S, S]."""
    import torch
    from repro_torch.kernels.flash_attention.ref import NEG_INF

    b, s, h, d = q.shape
    kvh = k.shape[2]
    out = torch.empty((b, s - lo, h, d), dtype=q.dtype, device=q.device)
    for a in range(lo, s, block):
        e = min(s, a + block)
        qg = q[:, a:e].reshape(b, e - a, kvh, h // kvh, d)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k[:, :e]).to(
            torch.promote_types(q.dtype, torch.float32)) * d ** -0.5
        i = torch.arange(a, e, device=q.device)[:, None]
        j = torch.arange(e, device=q.device)[None, :]
        scores = torch.where((j <= i)[None, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out[:, a - lo:e - lo] = torch.einsum(
            "bkgst,btkh->bskgh", probs.to(v.dtype), v[:, :e]).reshape(b, e - a, h, d)
        del scores, probs
    return out


def check_flash_j2(dev):
    """Row 4j: the flash kernel at path J2's shape, stablelm-1.6b's
    attention over 8 x 32,768 tokens, full causal (up to 512 K/V tiles a
    query tile).  The plain version cannot hold [8, 32, 32768, 32768]
    scores, so two slices of the one launch's output are held against
    `causal_plain_rows` in f32 within one floored bf16 ulp, as phase 2
    holds flash: the last batch row whole (every head and query row) and
    the last 4096 query rows of every batch row.  The plain version's time
    is that of the first slice (one batch row of 8) in bf16; the library
    call is SDPA with is_causal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_variant

    cfg = get_config("stablelm-1.6b", "full")
    b, s, h, kv, d = J2_BATCH, 32_768, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    got = flash_attention_cuda(q, k, v)
    row = {"shape": [b, s, h, kv, d], "window": None, "dtype": "torch.bfloat16",
           "variant": flash_variant(q.dtype, d)}
    last = [x[-1:] for x in (q, k, v)]
    want = causal_plain_rows(*(x.float() for x in last), 0, 512)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain = causal_plain_rows(*last, 0, 512)
    end.record()
    torch.cuda.synchronize()
    _hold("flash_attention", "4j path-j2 last batch row", got[-1:], want, plain, row)
    row["plain_ms_one_batch_row"] = start.elapsed_time(end)
    part = {}
    lo = s - 4096
    want = causal_plain_rows(q.float(), k.float(), v.float(), lo, 128)
    plain = causal_plain_rows(q, k, v, lo, 128)
    _hold("flash_attention", "4j path-j2 last 4096 rows", got[:, lo:], want, plain, part)
    row["last_rows"] = {key: part[key] for key in
                        ("max_abs_err", "bf16_ulps", "bf16_ulps_floored", "err_vs_plain_bf16")}
    row["max_abs_err"] = max(row["max_abs_err"], part["max_abs_err"])
    del want, plain, got
    free()
    row["ms"] = time_ms(lambda: flash_attention_cuda(q, k, v), 3)
    row["plain_ms"] = None  # [8, 32, 32768, 32768] f32 scores: 1.1 TB
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 3)
    flops = 4 * b * h * d * (s * (s + 1) // 2)  # q.k and p.v, causal half
    bytes_ = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    row["bound_ms"], row["bound_by"] = bound(bytes_, flops)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["flops"], row["bytes"] = flops, bytes_
    emit(**row)
    del q, k, v, qt, kt, vt
    free()
    return row


def check_flash_long(dev):
    """The flash kernel at 524,288 tokens with a 4096-key window: row 4w at
    path J4a's stablelm-1.6b attention [1, 524288, 32, 64] and row 4L at
    qwen3-14b's long_500k attention [1, 524288, 40, 128] on 8 KV heads
    (S x H x D = 2.68e9, past 2^31: the kernel's 64-bit offsets).  Every
    row against `windowed_plain` in f32 within one floored bf16 ulp, as
    phase 2 holds flash; the plain version's time is `windowed_plain`'s in
    bf16.  No library call computes a sliding window without a dense
    [S, S] mask (275 GB at this S), so the library column is None."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_variant
    from repro_torch.launch.dryrun import band_pairs

    g = torch.Generator(device=dev).manual_seed(4)
    rows = {}
    for name, h, kv, d in (("4w path-j4a", 32, 32, 64), ("4L qwen3-14b long_500k", 40, 8, 128)):
        b, s, win = 1, J_LONG, J_WINDOW
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
        got = flash_attention_cuda(q, k, v, window=win)
        want = windowed_plain(q.float(), k.float(), v.float(), win)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = windowed_plain(q, k, v, win)
        end.record()
        torch.cuda.synchronize()
        row = {"shape": [b, s, h, kv, d], "window": win, "dtype": "torch.bfloat16",
               "variant": flash_variant(q.dtype, d)}
        _hold("flash_attention", name, got, want, plain, row)
        del want, plain, got
        free()
        row["plain_ms"] = start.elapsed_time(end)
        row["ms"] = time_ms(lambda: flash_attention_cuda(q, k, v, window=win), 3)
        row["library_ms"] = None
        flops = 4 * b * h * d * band_pairs(s, win)  # q.k and p.v over the window band
        bytes_ = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        row["bound_ms"], row["bound_by"] = bound(bytes_, flops)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["flops"], row["bytes"] = flops, bytes_
        emit(**row)
        rows[name.split()[0]] = row
        del q, k, v
        free()
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the training paths
# ---------------------------------------------------------------------------
def path_a():
    import torch
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.launch import train

    steps = 3
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = train.main(model_args("pame") + ["--steps", str(steps), "--chunk", "1",
                                           "--device", "cuda"])
    launches = gossip_gather.launches
    row = {"phase": "path_a", "steps": out["steps"], "loss": out["loss"],
           "s_per_step": out["seconds"], "peak_bytes": torch.cuda.max_memory_allocated(),
           "gossip_launches": launches, "gossip_variant_launches": gossip_gather.variant_launches,
           "pme_average_launches": pme_average_cuda.launches}
    emit(**row)
    if gossip_gather.variant_launches != {"f32": 11 * steps, "bf16": 0} \
            or not all(math.isfinite(x) for x in out["loss"]):
        fail("path A: expected 11 f32 gossip launches a step and finite losses")
    free()
    return launches


def _task(dev, layers=None, variant="full"):
    """Path A's model, graph and batch; `layers` cuts the depth (`variant`
    "smoke" for the CPU rehearsals)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_lm_task

    cfg = get_config("stablelm-1.6b", variant)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    return make_lm_task(cfg, M, 4, 128, 0, "erdos_renyi", dev)


def path_b(dev):
    import torch
    from repro_torch.core import PaMEConfig, run_pame
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda

    steps = 2
    topo, params0, grad_fn, make_batch = _task(dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    state, hist = run_pame(1, params0, M, grad_fn, make_batch, topo, PaMEConfig(),
                           num_steps=steps, chunk_size=1, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = pme_average_cuda.launches
    row = {"phase": "path_b", "steps": hist["steps_run"], "loss": hist["loss"],
           "s_per_step": secs / steps, "peak_bytes": torch.cuda.max_memory_allocated(),
           "pme_average_launches": launches, "gossip_launches": gossip_gather.launches,
           "depth": int(params0["groups"][0]["0_attn"]["ln"].shape[0])}
    emit(**row)
    if launches != 10 * steps or not all(math.isfinite(x) for x in hist["loss"]):
        fail("path B: expected 10 pme_average launches a step and finite losses")
    del state, params0
    free()
    return launches


def parity(dev):
    """One pame_step of each of paths A and B with injected draws, through
    the kernels and through the plain versions (REPRO_TORCH_GOSSIP_IMPL=slots),
    at full width and PARITY_LAYERS layers (the script's time budget)."""
    import torch
    from repro_torch.core import pame, pme
    from repro_torch.core.mixing import ENV_VAR
    from repro_torch.tree import tree_flatten, tree_unflatten

    topo, params0, grad_fn, make_batch = _task(dev, PARITY_LAYERS)
    g = torch.Generator(device=dev).manual_seed(7)
    leaves, treedef = tree_flatten(params0)
    # distinct node models, so the exchange averages different values
    stacked = [(x.unsqueeze(0) + 0.01 * torch.randn((M,) + tuple(x.shape), generator=g,
                                                   device=dev)).to(x.dtype) for x in leaves]
    del params0, leaves
    batch = make_batch(0)
    results = {}
    for name, cfg in (
        ("path_a", pame.PaMEConfig(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0,
                                   mask_mode="bernoulli", mixing="sparse")),
        ("path_b", pame.PaMEConfig()),
    ):
        ta = pame.make_topology_arrays(topo, cfg, seed=0, device=dev)
        comm = torch.ones(M, dtype=torch.bool, device=dev)
        if cfg.mixing == "sparse":
            draws = {"sel": pme.sample_neighbor_selection_padded(g, ta.nbrs, ta.valid, ta.t, comm)}
        else:
            draws = {"a": pme.sample_neighbor_selection(g, ta.nbrs, ta.valid, ta.t, comm)}
        draws["masks"] = [
            pme.sample_coordinate_masks(g, M, x[0].numel(), max(1, round(cfg.p * x[0].numel())))
            if cfg.mask_mode == "exact" else pme.sample_bernoulli_masks(g, cfg.p, tuple(x.shape))
            for x in stacked
        ]
        state = pame.pame_init(3, tree_unflatten(treedef, stacked), M, cfg)
        outs = {}
        for impl in ("kernel", "slots"):
            if impl == "slots":
                os.environ[ENV_VAR] = "slots"
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, metrics = pame.pame_step(state, batch, grad_fn, ta, cfg, draws=draws)
                torch.cuda.synchronize()
                outs[impl + "_step_s"] = time.perf_counter() - t0
            finally:
                os.environ.pop(ENV_VAR, None)
            # park the result on the host while the other route runs
            outs[impl] = [x.cpu() for x in tree_flatten(new.params)[0]]
            outs[impl + "_loss"] = float(metrics["loss_mean"])
            del new, metrics
            free()
        ulps = max(bf16_ulps(a.to(dev), b.to(dev)) for a, b in zip(outs["kernel"], outs["slots"]))
        # the exchange alone (kernel route, same draws): the rest of a step
        # is the four nodes' forward + backward and the local update
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cfg.mixing == "sparse":
            v_bar = pme.pme_average_pytree_padded(
                None, state.params, ta.nbrs, draws["sel"], cfg.p, mode=cfg.mask_mode,
                pad=~ta.valid, masks=draws["masks"])
        else:
            v_bar = pme.pme_average_pytree(None, state.params, draws["a"], cfg.p,
                                           mode=cfg.mask_mode, masks=draws["masks"])
        torch.cuda.synchronize()
        exchange_s = time.perf_counter() - t0
        del v_bar
        results[name] = {"max_bf16_ulps": ulps, "loss_kernel": outs["kernel_loss"],
                         "loss_plain": outs["slots_loss"], "step_s_kernel": outs["kernel_step_s"],
                         "step_s_plain": outs["slots_step_s"], "exchange_s_kernel": exchange_s,
                         "layers": PARITY_LAYERS}
        emit(phase="parity", path=name, **results[name])
        del draws, state, outs
        free()
        if ulps > 1.0:
            fail(f"{name}: kernel and plain routes differ by more than one bf16 ulp")
    return results


# ---------------------------------------------------------------------------
# path D: the five baselines (bf16 gossip kernel), PaME's compressed exchange
# ---------------------------------------------------------------------------
# bf16 gossip launches a step, from the code: one Mixer.mix (dpsgd,
# dfedsam, choco), two Mixer.mix_lazy (beer) or one mix_nids_quantized
# (anq_nids) per leaf, each one launch; stablelm-1.6b has 11 leaves
BASELINES = {"dpsgd": 11, "dfedsam": 11, "choco": 11, "beer": 22, "anq_nids": 11}
PEAK_LIMIT = 80e9
PARITY_ULPS = 1.0


def _reset_counts():
    """Every kernel's launch counts to 0."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_cuda

    for fn in (gossip_gather, pme_average_cuda, flash_attention_cuda, ssd_intra_chunk_cuda):
        fn.launches = 0
        if hasattr(fn, "variant_launches"):
            fn.variant_launches = dict.fromkeys(fn.variant_launches, 0)
        if hasattr(fn, "lane_launches"):
            fn.lane_launches = 0
        if hasattr(fn, "range_launches"):
            fn.range_launches = 0


def path_d():
    """The trainer CLI with each baseline, stablelm-1.6b at full width and
    PATH_D_LAYERS layers, 4 nodes, sparse mixing, 2 steps: finite losses,
    the bf16 gossip launches of BASELINES a step (no f32 one) and a peak
    under 80 GB."""
    import torch
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.launch import train

    steps = 2
    rows = {}
    for algo, per_step in BASELINES.items():
        free()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        out = train.main(model_args(algo) + ["--layers", str(PATH_D_LAYERS), "--steps",
                                             str(steps), "--chunk", "1", "--device", "cuda"])
        launches = dict(gossip_gather.variant_launches)
        rows[algo] = row = {
            "steps": out["steps"], "loss": out["loss"], "s_per_step": out["seconds"],
            "seconds": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated(),
            "gossip_launches": launches, "pme_average_launches": pme_average_cuda.launches,
            "expected_bf16_launches": per_step * steps, "layers": PATH_D_LAYERS}
        emit(phase="path_d", algo=algo, **row)
        if launches != {"f32": 0, "bf16": per_step * steps}:
            fail(f"path D ({algo}): expected {per_step} bf16 gossip launches a step, got {launches}")
        if not all(math.isfinite(x) for x in out["loss"]) or out["steps"] != steps:
            fail(f"path D ({algo}): losses not finite or steps missing")
        if row["peak_bytes"] >= PEAK_LIMIT:
            fail(f"path D ({algo}): peak {row['peak_bytes']} bytes is not under 80 GB")
    free()
    return rows


def path_d_compressed(dev):
    """`run_pame` with the compressed exchanges on path D's model (full
    width, PATH_D_LAYERS layers), 2 steps each: finite losses, no gossip or
    PME-average launch (the exchange is two einsums a leaf), and the
    Eq.-(8) wire bits at 64 and 8 value bits,
    realized (the messages of this run's communicating receivers) and
    expected (the registry's formula, recomputed here)."""
    import numpy as np
    import torch
    from repro_torch.core import PaMEConfig, run_pame
    from repro_torch.core.algorithms import PaMEHp, get_algorithm
    from repro_torch.core.pame import make_topology_arrays
    from repro_torch.core.pme import message_bits
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.tree import tree_leaves

    steps = 2
    topo, params0, grad_fn, make_batch = _task(dev, PATH_D_LAYERS)
    n = sum(x.numel() for x in tree_leaves(params0))
    rows = {}
    for exchange, value_bits in (("compressed", 64), ("compressed_q8", 8)):
        cfg = PaMEConfig(exchange=exchange)
        free()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        state, hist = run_pame(1, params0, M, grad_fn, make_batch, topo, cfg,
                               num_steps=steps, chunk_size=1, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del state
        ta = make_topology_arrays(topo, cfg, seed=0)  # run_pame's own arrays
        t, kappa = ta.t.numpy(), ta.kappa.numpy()
        bits = message_bits(max(1, int(round(cfg.p * n))), n, value_bits)
        realized = [float(t[(k % kappa) == 0].sum()) * bits for k in range(steps)]
        inv_kappa = float(np.mean([1.0 / k for k in range(cfg.kappa_lo, cfg.kappa_hi + 1)]))
        formula = float(np.maximum(1, np.floor(cfg.nu * topo.degrees)).sum()) * inv_kappa * bits
        expected = get_algorithm("pame").bind(
            grad_fn, topo, PaMEHp(exchange=exchange), device=dev).wire_bits_for(params0)
        rows[exchange] = row = {
            "steps": hist["steps_run"], "loss": hist["loss"], "s_per_step": secs / steps,
            "layers": PATH_D_LAYERS,
            "peak_bytes": torch.cuda.max_memory_allocated(), "value_bits": value_bits,
            "bits_per_message": bits, "wire_bits_realized": realized,
            "wire_bits_expected_per_step": expected, "wire_bits_formula": formula,
            "gossip_launches": gossip_gather.launches,
            "pme_average_launches": pme_average_cuda.launches}
        emit(phase="path_d_compressed", exchange=exchange, **row)
        if not all(math.isfinite(x) for x in hist["loss"]) or hist["steps_run"] != steps:
            fail(f"compressed exchange ({exchange}): losses not finite or steps missing")
        if expected != formula or realized[0] <= 0:
            fail(f"compressed exchange ({exchange}): wire bits {expected} != Eq. (8) {formula}")
        if gossip_gather.launches or pme_average_cuda.launches:
            fail(f"compressed exchange ({exchange}): launched a kernel it does not run")
    del params0
    free()
    if not rows["compressed_q8"]["wire_bits_expected_per_step"] < \
            rows["compressed"]["wire_bits_expected_per_step"]:
        fail("the int8 payloads do not cost fewer wire bits than the 64-bit ones")
    return rows


@contextlib.contextmanager
def plain_contraction():
    """Every padded gossip contraction of `repro_torch.core.mixing` through
    its plain version, the arithmetic the kernel must equal: the slots chain
    on f32 copies of the operands, rounded once to their type.  Each output
    element reads its own column only, so the chain runs CHUNK columns at a
    time."""
    import torch
    from repro_torch.core import mixing

    kernel_route = mixing.gather_terms

    def plain(nbrs, terms, *, pad=None, impl=None):
        outs = []
        for w, x in terms:
            w = w if pad is None else torch.where(pad, torch.zeros_like(w), w)
            x2 = x.reshape(x.shape[0], -1)
            out = torch.empty((nbrs.shape[0], x2.shape[1]), dtype=x.dtype, device=x.device)
            for c in range(0, x2.shape[1], CHUNK):
                out[:, c:c + CHUNK] = mixing._gather_terms_slots(
                    nbrs, [(w, x2[:, c:c + CHUNK].float())])[0]
            outs.append(out.view((nbrs.shape[0],) + tuple(x.shape[1:])))
        return tuple(outs)

    mixing.gather_terms = plain
    try:
        yield
    finally:
        mixing.gather_terms = kernel_route


def path_d_parity(dev, cfg=None, batch=4, seq=128, tol=PARITY_ULPS):
    """One step of each baseline with injected draws from the same state,
    through the kernel route and through `plain_contraction`; every state
    tree compared in floored bf16 ulps, within PARITY_ULPS.  Everything
    else in the step is the same code on the same bf16 values, so a
    kernel that equals its plain version gives 0 ulps.  The states are
    the model's weights plus seeded noise for every field (surrogates near
    the weights, trackers at gradient scale), so that every mixing and
    every cancellation (mixed − x) sees real values.  stablelm-1.6b at full
    width, PARITY_LAYERS layers, unless `cfg` says otherwise (the CPU
    tests rehearse this phase on a tiny config)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import baselines as B
    from repro_torch.core.compression import qsgd, rand_k
    from repro_torch.core.mixing import make_mixer
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.launch.train import make_lm_task
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    if cfg is None:
        cfg = get_config("stablelm-1.6b", "full").replace(n_layers=PARITY_LAYERS)
    topo, params0, grad_fn, make_batch = make_lm_task(cfg, M, batch, seq, 0, "erdos_renyi", dev)
    data = make_batch(0)
    # impl="kernel": the CUDA kernel on the card, its f32 plain version on
    # the CPU (where the default would be the bf16 slots chain)
    mixer = make_mixer(topo, "sparse", impl="kernel", device=dev)
    leaves0, treedef = tree_flatten(params0)
    del params0
    sizes = [x.numel() for x in leaves0]

    def tree(seed, scale, around=1.0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tree_unflatten(treedef, [
            (around * x.float().unsqueeze(0)
             + scale * torch.randn((M,) + tuple(x.shape), generator=gen, device=dev)).to(x.dtype)
            for x in leaves0])

    def uniforms(seed, dtype=torch.float32):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.rand((M, n), generator=gen, device=dev, dtype=dtype) for n in sizes]

    lr, rho = 0.05, 0.01  # the CLI's defaults
    runs = {
        "dpsgd": (lambda: B.DPSGDState(tree(1, 0.01), 0, 3),
                  lambda st: B.dpsgd_step(st, data, grad_fn, mixer, lr), None),
        "dfedsam": (lambda: B.DFedSAMState(tree(1, 0.01), 0, 3),
                    lambda st: B.dfedsam_step(st, data, grad_fn, mixer, lr, rho=rho), None),
        "choco": (lambda: B.ChocoState(tree(1, 0.01), tree(2, 0.01), 0, 3),
                  lambda st, d: B.choco_step(st, data, grad_fn, mixer, lr,
                                             rand_k(0.3, rescale=False), 0.3, draws=d),
                  lambda: {"q": uniforms(7)}),
        "beer": (lambda: B.BeerState(tree(1, 0.01), tree(2, 0.01), tree(3, 1e-3, 0.0),
                                     tree(4, 1e-3, 0.0), tree(5, 1e-3, 0.0), 0, 3),
                 lambda st, d: B.beer_step(st, data, grad_fn, mixer, lr,
                                           rand_k(0.2, rescale=False), 0.4, draws=d),
                 lambda: {"h": uniforms(3), "z": uniforms(5)}),
        "anq_nids": (lambda: B.NidsState(tree(1, 0.01), tree(2, 0.01, 2.0), tree(3, 0.01),
                                         tree(4, 0.01, 2.0), 0, 3),
                     lambda st, d: B.nids_step(st, data, grad_fn, mixer, lr, qsgd(16), draws=d),
                     lambda: {"q": uniforms(11, torch.bfloat16)}),
    }
    results = {}
    for name, (make, step, make_draws) in runs.items():
        draws = make_draws() if make_draws else None
        outs = {}
        for route in ("kernel", "plain"):
            state = make()
            gossip_gather.variant_launches["bf16"] = 0
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (plain_contraction() if route == "plain" else contextlib.nullcontext()):
                new, metrics = step(state, draws) if draws is not None else step(state)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            outs[route] = {"state": new, "loss": float(metrics["loss_mean"]),
                           "s": time.perf_counter() - t0,
                           "launches": gossip_gather.variant_launches["bf16"]}
            del state, new
        fields = [f for f in outs["kernel"]["state"]._fields if f not in ("step", "key")]
        ulps = {f: max(ulps_floored(a, b) for a, b in zip(
                    tree_leaves(getattr(outs["kernel"]["state"], f)),
                    tree_leaves(getattr(outs["plain"]["state"], f))))
                for f in fields}
        results[name] = row = {
            "max_bf16_ulps_floored": max(ulps.values()), "per_field": ulps,
            "loss_kernel": outs["kernel"]["loss"], "loss_plain": outs["plain"]["loss"],
            "step_s_kernel": outs["kernel"]["s"], "step_s_plain": outs["plain"]["s"],
            "bf16_launches_kernel_route": outs["kernel"]["launches"],
            "bf16_launches_plain_route": outs["plain"]["launches"],
            "tol_ulps": tol, "layers": cfg.n_layers}
        emit(phase="parity_d", algo=name, **row)
        del outs, draws
        free()
        if row["max_bf16_ulps_floored"] > tol:
            fail(f"path D parity ({name}): kernel and plain routes differ by "
                 f"{row['max_bf16_ulps_floored']} bf16 ulps (> {tol})")
        if dev.type == "cuda" and (row["bf16_launches_kernel_route"] != BASELINES[name]
                                   or row["bf16_launches_plain_route"]):
            fail(f"path D parity ({name}): the kernel route did not run the bf16 kernel "
                 f"{BASELINES[name]} times, or the plain route ran it")
    return results


# ---------------------------------------------------------------------------
# path E: dynamic networks (scenarios, Markov dynamics with staleness, faults)
# ---------------------------------------------------------------------------
# the depth at which the replicated fault variants of BEER and ANQ-NIDS fit
# one card at full width: 8 layers make a copy 1.23 GB, so BEER's 5 trees and
# 2 replica trees (44 copies) hold 54 GB and ANQ-NIDS's 4 + 2 (40) 49 GB
REP_LAYERS = 8
# (run, algo, flags, gossip launches a step by variant); every run through
# the trainer CLI on path A's model, graph and batch, 3 steps of one
PATH_E = (
    ("E1", "pame", ["--scenario", "harsh"], {"f32": 11, "bf16": 0}),
    # --straggler 0.5 gives the temporal scenario stragglers, so that the
    # staleness ring is read as well as written
    ("E3", "dpsgd", ["--scenario", "flaky_links", "--burst", "0.1,0.5", "--session",
                     "0.05,0.5", "--staleness", "2", "--straggler", "0.5"],
     {"f32": 0, "bf16": 11}),
    ("E4", "pame", ["--loss-rate", "0.1", "--crash", "0.02,0.25", "--msg-delay", "0.2,2"],
     {"f32": 11, "bf16": 0}),
    ("E5", "choco", ["--loss-rate", "0.1", "--loss-burst", "0.05,0.3"], {"f32": 0, "bf16": 11}),
    ("E6", "beer", ["--loss-rate", "0.1", "--layers", str(REP_LAYERS)], {"f32": 0, "bf16": 22}),
    ("E6", "anq_nids", ["--loss-rate", "0.1", "--layers", str(REP_LAYERS)],
     {"f32": 0, "bf16": 11}),
)
E_STEPS = 3
E_METRICS = ("wire_bits", "comm_nodes", "alive_nodes", "stale_nodes", "dropped_msgs",
             "col_defect", "crashed_nodes", "surrogate_desync")


def path_e():
    """The trainer CLI under each dynamic network of PATH_E, 3 steps of one:
    finite losses, the gossip launches of PATH_E a step, peak under 80 GB;
    then E2, `Algorithm.bind(..., scenario=churn)` with PaME's dense exact
    exchange (`PaMEHp()`, the CLI's PaME draws Bernoulli masks, which the
    PME-average kernel does not serve): 10 PME-average launches a step."""
    import torch
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.launch import train

    rows = {}
    launches = {"f32": 0, "bf16": 0, "pme_average": 0}
    for run, algo, flags, per_step in PATH_E:
        free()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        out = train.main(model_args(algo) + flags + ["--steps", str(E_STEPS), "--chunk", "1",
                                                     "--device", "cuda"])
        got = dict(gossip_gather.variant_launches)
        row = {"run": run, "algo": algo, "flags": flags, "steps": out["steps"],
               "loss": out["loss"], "s_per_step": out["seconds"],
               "seconds": time.perf_counter() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "gossip_launches": got, "pme_average_launches": pme_average_cuda.launches,
               "expected_gossip_launches": {k: v * E_STEPS for k, v in per_step.items()},
               "staleness_hist": out["staleness_hist"]}
        row.update({k: out["metrics"][k] for k in E_METRICS if k in out["metrics"]})
        rows[f"{run}-{algo}"] = row
        emit(phase="path_e", **row)
        for v in ("f32", "bf16"):
            launches[v] += got[v]
        if got != row["expected_gossip_launches"] or pme_average_cuda.launches:
            fail(f"path E ({run}, {algo}): expected gossip launches "
                 f"{row['expected_gossip_launches']}, got {got} (and "
                 f"{pme_average_cuda.launches} PME-average launches)")
        if not all(math.isfinite(x) for x in out["loss"]) or out["steps"] != E_STEPS:
            fail(f"path E ({run}, {algo}): losses not finite or steps missing")
        if row["peak_bytes"] >= PEAK_LIMIT:
            fail(f"path E ({run}, {algo}): peak {row['peak_bytes']} bytes is not under 80 GB")
    rows["E2-pame"] = row = path_e2()
    launches["pme_average"] = row["pme_average_launches"]
    free()
    return rows, launches


def path_e2():
    import torch
    from repro_torch.core.algorithms import PaMEHp, get_algorithm
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda

    dev = torch.device("cuda")
    free()
    topo, params0, grad_fn, make_batch = _task(dev)
    bound = get_algorithm("pame").bind(grad_fn, topo, PaMEHp(), mixing="dense",
                                       scenario=get_scenario("churn"), device=dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    state, hist = bound.make_runner(chunk_size=1)(1, params0, M, make_batch, E_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    row = {"run": "E2", "algo": "pame", "flags": ["mixing=dense", "scenario=churn", "PaMEHp()"],
           "steps": hist["steps_run"], "loss": hist["loss"], "s_per_step": secs / E_STEPS,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "pme_average_launches": pme_average_cuda.launches,
           "gossip_launches": dict(gossip_gather.variant_launches),
           "expected_pme_average_launches": 10 * E_STEPS}
    row.update({k: hist[k] for k in E_METRICS if k in hist})
    emit(phase="path_e", **row)
    del state, params0
    if pme_average_cuda.launches != 10 * E_STEPS or gossip_gather.launches:
        fail(f"path E (E2): expected {10 * E_STEPS} PME-average launches and no gossip "
             f"launch, got {pme_average_cuda.launches} and {gossip_gather.launches}")
    if not all(math.isfinite(x) for x in hist["loss"]) or hist["steps_run"] != E_STEPS:
        fail("path E (E2): losses not finite or steps missing")
    if row["peak_bytes"] >= PEAK_LIMIT:
        fail(f"path E (E2): peak {row['peak_bytes']} bytes is not under 80 GB")
    return row


@contextlib.contextmanager
def plain_routes():
    """`plain_contraction` for every `Mixer`, and the f32 slots chain for
    PaME's padded exchange (REPRO_TORCH_GOSSIP_IMPL=slots), which the f32
    kernel variant equals bit for bit."""
    from repro_torch.core.mixing import ENV_VAR

    before = os.environ.get(ENV_VAR)
    os.environ[ENV_VAR] = "slots"
    try:
        with plain_contraction():
            yield
    finally:
        if before is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = before


# parity phase E's steps: (algo, networks, gossip variant, launches a step)
PARITY_E = (
    ("dpsgd", ("dynamic", "temporal", "fault"), "bf16", 11),
    ("pame", ("dynamic", "temporal", "fault"), "f32", 11),
    # the replicated fault steps of E5 and E6, under E5's message loss
    ("choco", ("loss",), "bf16", BASELINES["choco"]),
    ("beer", ("loss",), "bf16", BASELINES["beer"]),
    ("anq_nids", ("loss",), "bf16", BASELINES["anq_nids"]),
)
# the replicated steps' state fields seeded as (around, scale): around x
# the weights plus scale x noise, so that every replica mix and repair sees
# real, desynced values (BEER's trackers start from the batch's gradients)
REP_SEEDS = {
    "choco": {"held": (1.0, 0.01)},
    "beer": {"h_held": (1.0, 0.01), "z_held": (0.0, 1e-3)},
    "anq_nids": {"c": (2.0, 0.01), "hat_z": (1.0, 0.01), "hat_c": (2.0, 0.01),
                 "z_reps": (1.0, 0.01), "c_reps": (2.0, 0.01)},
}


def path_e_parity(dev, cfg=None, batch=4, seq=128):
    """Parity phase E (`_network_parity` over PARITY_E)."""
    return _network_parity(dev, PARITY_E, "e", cfg, batch, seq)


def _network_parity(dev, steps, phase, cfg=None, batch=4, seq=128):
    """One `_dynamic_step`, one `_temporal_step` and one `_fault_step` of
    D-PSGD and of PaME, and one `_fault_step` of rep-CHOCO, rep-BEER and
    rep-ANQ-NIDS under E5's message loss, through `Algorithm.bind`, with
    the same injected network and compression uniforms, through the kernel
    route and through `plain_routes`, from the same seeded state and carry
    (the ring's snapshots noisy copies of the weights, so that a delayed
    node sends other values; the replicas noisy copies of the surrogates, and
    node 1's links pending, so that a delivered message repairs them).
    Parity phase G runs the paced steps of `steps` the same way, the event
    clock's draws injected so that node 1 defers its exchange; a network
    named "...-grown" runs on path G1's graph after its join (one node
    attached to two, `membership.grown_topology`), from a 5-row state that
    `membership.expand_state` grows out of the 4-node one, as G1 does.
    Both routes run the same code but the contraction, so the kernel must
    give 0 ulps: the bf16 gossip variant (D-PSGD and the replica mixes)
    equals the f32 slots chain rounded once, the f32 variant (PaME) the
    f32 slots chain; every state leaf and ring snapshot compared in
    floored bf16 ulps, f32 leaves bit for bit.  stablelm-1.6b at full
    width, PARITY_LAYERS layers, unless `cfg` says otherwise (the CPU
    tests rehearse this phase on a tiny config)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import faults, scenarios, temporal
    from repro_torch.core.algorithms import PaMEHp, get_algorithm
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.launch.train import lm_batch_fn, make_lm_task
    from repro_torch.serve import membership
    from repro_torch.serve.events import ArrivalProcess, ServePacing
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    label = f"path {phase.upper()} parity"
    if cfg is None:
        cfg = get_config("stablelm-1.6b", "full").replace(n_layers=PARITY_LAYERS)
    topo, params0, grad_fn, make_batch = make_lm_task(cfg, M, batch, seq, 0, "erdos_renyi", dev)
    data = make_batch(0)
    leaves0, treedef = tree_flatten(params0)
    del params0
    sizes = [x.numel() for x in leaves0]
    k = 3  # the global step index of the parity step (ring slot k mod D)
    # path G1's graph after join@3 (its --join-degree 2, --seed 0)
    grown = membership.grown_topology(topo, 1, degree=2, seed=0)

    def tree(seed, scale=0.01):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tree_unflatten(treedef, [
            (x.float().unsqueeze(0) + scale * torch.randn((M,) + tuple(x.shape), generator=gen,
                                                          device=dev)).to(x.dtype)
            for x in leaves0])

    def seed_field(leaves, seed, around, scale):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for x, w in zip(leaves, leaves0):
            for row in x:  # a node at a time: no f32 copy of a replica leaf
                row.copy_(torch.randn(row.shape, generator=gen, device=dev).mul_(scale)
                          .add_(w.float() * around))

    def uniforms(m, d):
        # node 1 straggles (delayed on the temporal path), node 2 is late
        # on the fault path, one link direction drops; the rest is seeded
        g = torch.Generator().manual_seed(5)
        edge = torch.rand((m, d), generator=g)
        strag = torch.rand(m, generator=g).clamp(min=0.6)
        strag[1] = 0.0
        delay = torch.rand(m, generator=g).clamp(min=0.6)
        delay[2] = 0.0
        loss = torch.rand((m, d), generator=g).clamp(min=0.3)
        loss[0, 0] = 0.0
        net = {"edge": edge, "node": torch.ones(m), "strag": strag}
        # the event clock: node 1 gets 20 requests, serves 4 and defers
        arrivals = torch.zeros(m, dtype=torch.int32)
        arrivals[1] = 20
        return {"scenario": net, "temporal": dict(net),
                "faults": {"loss": loss, "burst": torch.ones((m, d)), "crash": torch.ones(m),
                           "delay": delay},
                "pacing": {"mod": torch.ones(m), "arrivals": arrivals}}

    def compression(algo, m):
        # the baselines' compression uniforms, one [m, n] row per leaf
        gen = torch.Generator(device=dev).manual_seed(11)
        rows = lambda dtype=torch.float32: [  # noqa: E731
            torch.rand((m, n), generator=gen, device=dev, dtype=dtype) for n in sizes]
        return {"choco": lambda: {"q": rows()}, "beer": lambda: {"h": rows(), "z": rows()},
                "anq_nids": lambda: {"q": rows(torch.bfloat16)}}.get(algo, lambda: None)()

    networks = {
        "dynamic": dict(scenario=scenarios.Scenario(name="e", edge_drop=0.2, straggler=0.3)),
        "temporal": dict(scenario=temporal.TemporalScenario(
            name="e", burst_down=0.2, burst_up=0.5, straggler=0.3, staleness=2)),
        "fault": dict(faults=faults.FaultModel(name="e", loss=0.1, delay=0.3, max_delay=2)),
        "loss": dict(faults=faults.FaultModel(name="e", loss=0.1, burst_down=0.05,
                                              burst_up=0.3)),
        # path G1's clock (the rush preset, capacity 4, defer above 8)
        "paced": dict(pacing=ServePacing(ArrivalProcess(name="g", rate=4.0, burst_rate=16.0,
                                                        p_up=0.1, p_down=0.1),
                                         capacity=4, defer_threshold=8)),
    }
    hps = {"pame": PaMEHp(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0, mask_mode="bernoulli")}
    results = {}
    for algo, nets, variant, per_step in steps:
        spec = get_algorithm(algo)
        hp = hps.get(algo) or spec.hp_cls(lr=0.05)
        for net in nets:
            grow = net.endswith("-grown")
            kw = networks[net.removesuffix("-grown")]
            t = grown if grow else topo
            m, batch_m = t.m, (lm_batch_fn(cfg, t.m, batch, seq, 0, dev)(0) if grow else data)
            bound = spec.bind(grad_fn, t, hp, device=dev, **kw)
            outs = {}
            for route in ("kernel", "plain"):
                draws = uniforms(m, t.max_degree)  # the same seeded draws for both routes
                draws["algo"] = compression(algo, m)
                if grow:  # the joiner clones its donor's rows, as at G1's join
                    state = spec.bind(grad_fn, topo, hp, device=dev, **kw).init(
                        3, tree(1), data if spec.needs_batch0 else None)
                    state = membership.expand_state(state, M,
                                                    membership.default_donors(t, M))
                else:
                    state = bound.init(3, tree(1), data if spec.needs_batch0 else None)
                if algo in REP_SEEDS:
                    for i, (field, (around, scale)) in enumerate(REP_SEEDS[algo].items()):
                        seed_field(tree_leaves(getattr(state, field)), 20 + i, around, scale)
                    pending = bound.scen_arrays.valid.cpu().clone()
                    pending[torch.arange(m) != 1] = False
                    state = state._replace(pending=pending)
                aux = None
                if bound.carries_aux:
                    aux = bound.aux_init(state)
                    if getattr(aux, "ring", None) is not None:
                        for r in tree_leaves(aux.ring):  # older snapshots: other values
                            r.copy_(r.float().add_(0.01 * torch.randn(
                                r.shape, generator=torch.Generator(device=dev).manual_seed(9),
                                device=dev)).to(r.dtype))
                _reset_counts()
                with (plain_routes() if route == "plain" else contextlib.nullcontext()):
                    res = bound.step(state, batch_m, k, aux, draws=draws)
                new, metrics = res[0], res[1]
                new_aux = res[2] if len(res) == 3 else None
                outs[route] = {
                    "leaves": tree_leaves((new, getattr(new_aux, "ring", None))),
                    "loss": float(metrics["loss_mean"]),
                    "stale_nodes": int(metrics.get("stale_nodes", 0)),
                    "deferred_nodes": int(metrics.get("deferred_nodes", 0)),
                    "repair_bits": float(metrics.get("repair_bits", 0.0)),
                    "launches": dict(gossip_gather.variant_launches)}
                del state, aux, new, new_aux, res, draws
                free()
            ulps, f32_equal = 0.0, True
            for a, b in zip(outs["kernel"]["leaves"], outs["plain"]["leaves"]):
                if not isinstance(a, torch.Tensor) or not a.is_floating_point():
                    continue
                if a.dtype == torch.float32:
                    f32_equal = f32_equal and torch.equal(a, b)
                else:
                    ulps = max(ulps, ulps_floored(a, b))
            results[f"{algo}-{net}"] = row = {
                "max_bf16_ulps_floored": ulps, "f32_bit_equal": f32_equal,
                "loss_kernel": outs["kernel"]["loss"], "loss_plain": outs["plain"]["loss"],
                "stale_nodes": outs["kernel"]["stale_nodes"],
                "deferred_nodes": outs["kernel"]["deferred_nodes"],
                "repair_bits": outs["kernel"]["repair_bits"],
                "launches_kernel_route": outs["kernel"]["launches"],
                "launches_plain_route": outs["plain"]["launches"],
                "expected_launches": {variant: per_step}, "layers": cfg.n_layers, "m": m}
            emit(phase=f"parity_{phase}", algo=algo, network=net, **row)
            del outs
            free()
            if ulps != 0.0 or not f32_equal:
                fail(f"{label} ({algo}, {net}): kernel and plain routes differ "
                     f"({ulps} bf16 ulps, f32 bit-equal: {f32_equal})")
            if dev.type == "cuda" and (row["launches_kernel_route"][variant] != per_step
                                       or sum(row["launches_plain_route"].values())):
                fail(f"{label} ({algo}, {net}): the kernel route did not launch the "
                     f"{variant} gossip kernel {per_step} times, or the plain route launched it")
            if net in ("temporal", "fault") and row["stale_nodes"] != 1:
                fail(f"{label} ({algo}, {net}): expected one delayed node")
            if net.startswith("paced") and row["deferred_nodes"] != 1:
                fail(f"{label} ({algo}, {net}): expected one deferred node")
            if algo in REP_SEEDS and not row["repair_bits"] > 0:
                fail(f"{label} ({algo}, {net}): no pending replica was repaired")
    return results


# ---------------------------------------------------------------------------
# path C: serving zamba2-1.2b (flash attention and SSD kernels)
# ---------------------------------------------------------------------------
def path_c(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_cuda
    from repro_torch.models import init_params, prefill
    from repro_torch.serve import ServeLoop
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("zamba2-1.2b", "full").replace(use_flash=True, use_ssd_kernel=True)
    t0 = time.perf_counter()
    params0 = init_params(0, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    # distinct node models: seed-0 weights plus a little per-node noise
    stacked = tree_map(lambda x: (x.unsqueeze(0) + 0.01 * torch.randn(
        (M,) + tuple(x.shape), generator=g, device=dev)).to(x.dtype), params0)
    del params0
    n_params = sum(x[0].numel() for x in tree_leaves(stacked))
    loop = ServeLoop(cfg, device=dev, **SERVE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tc = lambda fn: fn.variant_launches["tensor_cores"]  # noqa: E731
    rounds, finite = {}, True
    for policy in ("local", "consensus"):
        f0, s0 = tc(flash_attention_cuda), tc(ssd_intra_chunk_cuda)
        n0 = flash_attention_cuda.launches + ssd_intra_chunk_cuda.launches
        t = time.perf_counter()
        stats = loop.serve_round(stacked, [0, 1, 2, 3], policy=policy)
        secs = time.perf_counter() - t
        per = {"flash": tc(flash_attention_cuda) - f0, "ssd": tc(ssd_intra_chunk_cuda) - s0}
        others = flash_attention_cuda.launches + ssd_intra_chunk_cuda.launches - n0 \
            - per["flash"] - per["ssd"]
        shapes = sorted({tuple(st["tokens"].shape) for st in stats.values()})
        finite = finite and all(st["logits_finite"] for st in stats.values())
        rounds[policy] = {
            "seconds": secs, "launches": per, "cuda_core_launches": others, "token_shapes": shapes,
            "prefill_ms": [st["prefill_ms"] for st in stats.values()],
            "decode_ms_per_token": [st["decode_ms"] / (SERVE["gen"] - 1) for st in stats.values()],
            "tokens_per_s": [st["tokens_per_s"] for st in stats.values()],
        }
        emit(phase="path_c", policy=policy, **rounds[policy])
        if per != {"flash": M * FLASH_SITES, "ssd": M * MAMBA_LAYERS} or others:
            fail(f"path C ({policy}): expected {FLASH_SITES} flash and {MAMBA_LAYERS} SSD "
                 f"launches per prefill of the tensor-core variants, {M} prefills; got {per} "
                 f"and {others} of the CUDA-core variants")
        if shapes != [(SERVE["batch"], SERVE["gen"])]:
            fail(f"path C ({policy}): expected [{SERVE['batch']}, {SERVE['gen']}] tokens per node")
    launches = {"flash": tc(flash_attention_cuda), "ssd": tc(ssd_intra_chunk_cuda)}
    peak = torch.cuda.max_memory_allocated()
    emit(phase="path_c_done", params_per_node=n_params, depth=cfg.n_layers, setup_s=setup_s,
         peak_bytes=peak, logits_finite=finite, launches=launches)
    if not finite:
        fail("path C: a prefill or decode logit was not finite")

    # One node's prefill through the kernels and through the plain route
    # (flags off), in bf16 and with the weights upcast to f32.  In bf16 both
    # routes sit some 15 % (relative) from the f32 logits at this depth with
    # random weights (PERF.md, PR 12), so the bf16 check is that the kernel
    # route is no further from f32 than the plain route; in f32 the two
    # routes differ only by summation order.
    node = tree_map(lambda x: x[0], stacked)
    del stacked
    free()
    batch = ServeLoop(cfg, device=dev, **SERVE).make_batch()  # node 0's prompts
    plain_cfg = cfg.replace(use_flash=False, use_ssd_kernel=False)
    logits = {}
    with torch.inference_mode():
        node32 = tree_map(lambda x: x.float(), node)
        for name, p, c in (("kernel", node, cfg), ("plain", node, plain_cfg),
                           ("kernel_f32", node32, cfg.replace(dtype="float32")),
                           ("plain_f32", node32, plain_cfg.replace(dtype="float32"))):
            logits[name] = prefill(p, c, batch, loop.capacity)[0]
            free()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).float().mean().item()  # noqa: E731
    lk, lp, lf = logits["kernel"], logits["plain"], logits["plain_f32"]
    row = {"rel_logit_err": rel(lk, lp), "argmax_agree": agree(lk, lp), "rows": lk.shape[0],
           "kernel_vs_f32": rel(lk, lf), "plain_vs_f32": rel(lp, lf),
           "kernel_argmax_agree_f32": agree(lk, lf), "plain_argmax_agree_f32": agree(lp, lf),
           "f32_rel_logit_err": rel(logits["kernel_f32"], lf), "f32_tol": 1e-3,
           "f32_argmax_agree": agree(logits["kernel_f32"], lf)}
    emit(phase="path_c_parity", **row)
    del node, node32, logits, lk, lp, lf
    free()
    if row["f32_rel_logit_err"] > 1e-3:
        fail(f"path C: f32 kernel and plain prefill logits differ by "
             f"{row['f32_rel_logit_err']} (relative) > 1e-3")
    if row["kernel_vs_f32"] > 1.1 * row["plain_vs_f32"]:
        fail("path C: the bf16 kernel route is further from the f32 logits than the plain route")
    return launches


# ---------------------------------------------------------------------------
# path F: the paper's own tasks (Examples 1-4)
# ---------------------------------------------------------------------------
# Fashion-MNIST's and CIFAR-10's training-set sizes (the synthetic stand-ins
# of `repro_torch.data`); the last HELD samples stay out of the partition
# and score the node-mean model
FMNIST = dict(n=60000, shape=(28, 28, 1), seed=0, sep=3.0)
CIFAR = dict(n=50000, shape=(32, 32, 3), seed=1, sep=2.0)
HELD = 512
F_BATCH = 32  # per node, as examples/cnn_heterogeneity.py and the benchmark
# examples/cnn_heterogeneity.py's PaME config (the benchmark's run_fl too)
EX3_CFG = dict(nu=0.7, p=0.3, gamma=1.002, sigma0=10.0, kappa_lo=2, kappa_hi=4)
# the wide-CNN headline of the benchmark: leaf order b1 b2 c1 c2 fc1 fc2
WIDE_P_LEAF = (1.0, 1.0, 0.8, 0.4, 0.15, 0.8)
WIDE_CLASSES = 3
# F2's race: the benchmark's vs_baselines (Figs 8-10) on 32 nodes; 50 steps
# (cut from 100: six host-bound runs of 32 nodes' gradients took 15.5 s)
F2 = dict(m=32, n=1000, spn=128, steps=50, levels=16)
# each path's steps; path F's share of the script's clock is ~45 s
F_STEPS = dict(ex1=400, race=8, cnn=80, wide=60, resnet=40, profile=5)
# parity phase F: D-PSGD's step through the f32 gossip kernel equals the
# slots chain bit for bit (0 ulps); PaME's dense exact exchange through the
# PME-average kernel against the einsum (sums of <= m terms in another
# order) within one f32 ulp, and its whole step within 1e-5 of the scale;
# the forward on the card against the CPU within rtol 1e-5 with the TF32 pin
PARITY_F_ULPS = 0.0
PARITY_F_PME_ULPS = 1.0
PARITY_F_RTOL = 1e-5


def _example(name):
    """A port example under ``examples/`` as a module (its entry points)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "examples",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counts():
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda

    return dict(gossip_gather.variant_launches, pme_average=pme_average_cuda.launches)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _start(dev):
    import torch

    free()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    return time.perf_counter()


def _finish(dev, t0, steps, row, expected):
    """Seconds a step, peak, launches (and a step) into `row`; on the card
    the launches must be `expected` (per kernel, for the whole run)."""
    import torch

    _sync(dev)
    secs = time.perf_counter() - t0
    got = _counts()
    row.update(seconds=secs, s_per_step=secs / max(steps, 1), launches=got,
               launches_per_step={k: v / max(steps, 1) for k, v in got.items()},
               peak_bytes=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None)
    if dev.type == "cuda" and got != dict({"f32": 0, "bf16": 0, "pme_average": 0}, **expected):
        emit(**row)
        fail(f"path F ({row['run']}): expected launches {expected}, got {got}")


def _falls(losses, k=5):
    """The mean of the last k values below the mean of the first k."""
    k = max(1, min(k, len(losses) // 2))
    return sum(losses[-k:]) / k < sum(losses[:k]) / k


def pame_bits(dev, topo, cfg, params0):
    """Expected Eq.-(8) bits a step of `run_pame` (the registry's count)."""
    from repro_torch.core import algorithms as ALG

    return ALG.get_algorithm("pame").bind(None, topo, cfg, mixing="dense",
                                          device=dev).wire_bits_for(params0)


def logreg_problem(dev, m, n, spn=128, seed=0, lam=1e-3):
    """Example 2 in torch, the benchmark's `logreg_problem`
    (benchmarks/common.py): per-node loss and gradient, the objective over
    the training split, and the accuracy on 32 test samples a node."""
    import numpy as np
    import torch
    from repro_torch.data import make_logistic_regression

    a, b, _ = make_logistic_regression(m, spn + 32, n, seed=seed)
    put = lambda v: torch.as_tensor(np.ascontiguousarray(v), device=dev)  # noqa: E731
    a_tr, b_tr, a_te, b_te = put(a[:, :spn]), put(b[:, :spn]), put(a[:, spn:]), put(b[:, spn:])

    def softplus(z):  # log(1 + e^z), as jnp.logaddexp(0, z)
        return torch.logaddexp(torch.zeros_like(z), z)

    def grad_fn(w, batch, key):
        aa, yy = batch
        z = aa @ w
        loss = torch.mean(softplus(z) - yy * z) + 0.5 * lam * torch.sum(w ** 2)
        g = aa.T @ (torch.sigmoid(z) - yy) / aa.shape[0] + lam * w
        return loss, g

    def objective(w):
        z = torch.einsum("mbn,n->mb", a_tr, w)
        return (torch.sum(torch.mean(softplus(z) - b_tr * z, dim=1))
                + 0.5 * lam * m * torch.sum(w ** 2))

    def accuracy(w):
        z = torch.einsum("mbn,n->mb", a_te, w)
        return float(((z > 0).float() == b_te).float().mean())

    return (a_tr, b_tr), grad_fn, objective, accuracy


def images(spec):
    """The synthetic image set of `spec` (FMNIST or CIFAR)."""
    from repro_torch.data import SyntheticClassification

    return SyntheticClassification.make(spec["n"], spec["shape"], 10, seed=spec["seed"],
                                        sep=spec["sep"])


def vision_task(dev, ds, partition, apply_fn, batch=F_BATCH):
    """On image set `ds` (its last HELD samples held out): the per-node
    shards `partition(labels)` of the rest, a batch_fn moving each
    node-stacked numpy batch to `dev`, the ce_loss grad_fn of `apply_fn`,
    and the held-out accuracy of a node-mean model."""
    import torch
    from repro_torch.data import NodeBatcher
    from repro_torch.models.cnn import ce_loss
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    train = {"x": ds.images[:-HELD], "y": ds.labels[:-HELD]}
    parts = partition(train["y"])
    nb = NodeBatcher(train, parts, batch_size=batch, seed=0)
    held_x = torch.as_tensor(ds.images[-HELD:], device=dev)
    held_y = torch.as_tensor(ds.labels[-HELD:], device=dev)

    def batch_fn(k):
        b = nb.next()
        return {"x": torch.as_tensor(b["x"], device=dev), "y": torch.as_tensor(b["y"], device=dev)}

    def grad_fn(params, b, key):
        leaves, treedef = tree_flatten(params)
        loss = ce_loss(apply_fn(params, b["x"]), b["y"])
        return loss.detach(), tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))

    def accuracy(stacked):
        with torch.no_grad():
            logits = apply_fn(tree_map(lambda x: x.mean(0), stacked), held_x)
        return float((logits.argmax(-1) == held_y).float().mean())

    return {"batch_fn": batch_fn, "grad_fn": grad_fn, "accuracy": accuracy,
            "shards": [len(p) for p in parts]}


def profile_steps(dev, run, steps):
    """Launch overhead of `run()` (`steps` steps, ends in a host sync),
    after warm-up: the wall time of one unprofiled call, then under
    ``torch.profiler`` with CUDA activity only (no CPU-op tracing, whose
    post-processing takes seconds at thousands of launches a step) the
    device kernels, copies and launch calls it made and the device-busy
    time (the union of their spans); idle share = 1 - busy / wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    t0 = time.perf_counter()
    run()
    _sync(dev)
    wall = time.perf_counter() - t0
    if dev.type != "cuda":
        return {"wall_s_per_step": wall / steps}
    t_enter = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        setup = t0 - t_enter
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    t0 = time.perf_counter()
    spans, kernels, copies, launch_calls = [], 0, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernelEx"):
            launch_calls += 1
    busy_us, end = 0.0, -math.inf
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
    busy = busy_us * 1e-6
    return {"wall_s_per_step": wall / steps, "wall_s_per_step_profiled": wall_prof / steps,
            "device_kernels_per_step": kernels / steps, "copies_per_step": copies / steps,
            "launch_calls_per_step": launch_calls / steps, "busy_s_per_step": busy / steps,
            "idle_share": 1.0 - busy / wall, "profiler_saw_device": kernels > 0,
            "profiler_setup_s": setup, "postprocess_s": time.perf_counter() - t0}


def path_f1(dev, steps=None):
    """Example 1 through examples/quickstart_torch.py's entry points:
    `run_pame` under the stop rule (16 x 200: no leaf reaches the PME
    kernel's 2^17 floor), the registry race of PaME and D-PSGD on the sparse
    exchange (the f32 gossip kernel, one launch a step each), the Theorem-1
    demo."""
    import torch
    from repro_torch.core import build_topology

    steps = steps or F_STEPS
    qs = _example("quickstart_torch")
    rows = {}
    t0 = _start(dev)
    ex1 = qs.example1(dev, steps["ex1"])
    rows["F1-pame"] = row = {"run": "F1-pame"}
    _finish(dev, t0, ex1["steps_run"], row, {})
    row.update(objective_first=ex1["objective"][0], objective_last=ex1["objective"][-1],
               steps_run=ex1["steps_run"], recovery_error=ex1["recovery_error"],
               wire_bits_per_step=pame_bits(
                   dev, build_topology("erdos_renyi", qs.M, p=0.4, seed=1), qs.CFG,
                   torch.zeros(qs.N)))
    emit(phase="path_f", **row)
    if not row["objective_last"] < 0.5 * row["objective_first"]:
        fail("path F (F1): the objective did not fall below half its start")
    t0 = _start(dev)
    race = qs.race(dev, steps["race"])
    rows["F1-race"] = row = {"run": "F1-race", "steps": steps["race"]}
    for name, h in race.items():
        row[name] = {"loss_first": h["loss"][0], "loss_last": h["loss"][-1],
                     "wire_bits_per_step": h["wire_bits_per_step"], "seconds": h["seconds"]}
    _finish(dev, t0, 2 * steps["race"], row, {"f32": 2 * steps["race"]})
    emit(phase="path_f", **row)
    if not all(row[n]["loss_last"] < row[n]["loss_first"] for n in race):
        fail("path F (F1 race): a loss did not fall")
    t0 = _start(dev)
    th = qs.theorem1(dev, 2000)
    bias = lambda v: float(abs(v - th["target"]).mean())  # noqa: E731
    row = {"run": "F1-theorem1", "mean_abs_err_count_weighted": bias(th["count_weighted"]),
           "mean_abs_err_naive": bias(th["naive"])}
    _finish(dev, t0, 2000, row, {})
    emit(phase="path_f", **row)
    return rows


def path_f2(dev, m=None, n=None, steps=None):
    """Example 2, the race of Figs 8-10: all six algorithms through the
    registry on the sparse exchange with the benchmark's hyperparameters,
    logistic regression on 32 nodes: finite losses, the objective below its
    start (ANQ-NIDS at 16 QSGD levels is recorded either way), accuracy and
    wire bits, the f32 gossip kernel one launch a step (two for BEER)."""
    import torch
    from repro_torch.core import PaMEConfig, build_topology
    from repro_torch.core import algorithms as ALG

    m, n, steps = m or F2["m"], n or F2["n"], steps or F2["steps"]
    topo = build_topology("erdos_renyi", m, p=0.4, seed=0)
    batch, grad_fn, objective, accuracy = logreg_problem(dev, m, n, spn=F2["spn"], seed=0)
    hps = {
        "pame": PaMEConfig(nu=0.2, p=0.2, gamma=1.002, sigma0=1.0, kappa_lo=3, kappa_hi=7),
        "dpsgd": ALG.DPSGDHp(lr=0.1),
        "dfedsam": ALG.DFedSAMHp(lr=0.1, rho=0.01),
        "choco": ALG.ChocoHp(lr=0.05, gossip_gamma=0.3, comp_frac=0.3),
        "beer": ALG.BeerHp(lr=0.05, gossip_gamma=0.4, comp_frac=0.2),
        "anq_nids": ALG.AnqNidsHp(lr=0.1, qsgd_levels=F2["levels"]),
    }
    rows = {}
    for name in ALG.list_algorithms():
        bound = ALG.get_algorithm(name).bind(grad_fn, topo, hps[name], mixing="sparse",
                                             device=dev)
        t0 = _start(dev)
        state, h = bound.run(0, torch.zeros(n), m, lambda k: batch, steps,
                             objective_fn=objective, tol_std=0.0, chunk_size=25)
        rows[name] = row = {"run": f"F2-{name}"}
        _finish(dev, t0, steps, row, {"f32": (2 if name == "beer" else 1) * steps})
        row.update(steps=h["steps_run"], loss_first=h["loss"][0], loss_last=h["loss"][-1],
                   objective_first=h["objective"][0], objective_last=h["objective"][-1],
                   accuracy=accuracy(bound.params_of(state).mean(dim=0)),
                   wire_bits_per_step=h["wire_bits_per_step"],
                   wire_bits_total=h["wire_bits_total"])
        row["descends"] = row["objective_last"] < row["objective_first"]
        emit(phase="path_f", **row)
        if not all(math.isfinite(x) for x in h["loss"]) or h["steps_run"] != steps:
            fail(f"path F (F2 {name}): losses not finite or steps missing")
        if not row["descends"] and name != "anq_nids":
            fail(f"path F (F2 {name}): the objective did not fall")
    return rows


def path_f3(dev, ds=None, spec=FMNIST, steps=None):
    """Example 3 on Fashion-MNIST's size: the CNN under label skew (C = 7,
    4 nodes, complete graph): PaME through `run_pame` (dense exact: the
    PME-average kernel takes fc1, one launch a step), D-PSGD through the
    registry (f32 gossip, one launch a leaf a step), and the width-2 CNN
    through the registry with the tree partition, p_leaf and Bernoulli
    masks (the benchmark's headline, C = 3).  Loss falls, held-out accuracy
    of the node-mean model at least 0.5 (the width-1 runs).  Then 5 profiled
    steps of the PaME run.  `ds`, when given, is `images(spec)` made ahead."""
    from repro_torch.core import PaMEConfig, build_topology, run_pame
    from repro_torch.core import algorithms as ALG
    from repro_torch.data import label_skew_partition
    from repro_torch.models.cnn import cnn_apply, cnn_init
    from repro_torch.tree import tree_leaves

    steps = steps or F_STEPS
    topo = build_topology("complete", M)
    rows = {}
    ds = images(spec) if ds is None else ds
    task = vision_task(dev, ds, lambda y: label_skew_partition(y, M, 7, seed=0), cnn_apply)
    cfg = PaMEConfig(**EX3_CFG)

    def pame_run(k):
        return run_pame(0, cnn_init(1, device=dev), M, task["grad_fn"], task["batch_fn"], topo,
                        cfg, num_steps=k, tol_std=0.0, chunk_size=min(k, 40), device=dev)

    runs = (
        ("F3-pame", 1, steps["cnn"], pame_run),
        ("F3-dpsgd", 6, steps["cnn"], lambda k: ALG.get_algorithm("dpsgd").bind(
            task["grad_fn"], topo, ALG.DPSGDHp(lr=0.05), mixing="sparse", device=dev).run(
            0, cnn_init(1, device=dev), M, task["batch_fn"], k, tol_std=0.0,
            chunk_size=min(k, 40))),
    )
    for name, per_step, k, run in runs:
        t0 = _start(dev)
        state, h = run(k)
        rows[name] = row = {"run": name}
        _finish(dev, t0, k, row, {"pme_average" if name == "F3-pame" else "f32": per_step * k})
        row.update(steps=h["steps_run"], loss_first=h["loss"][0], loss_last=h["loss"][-1],
                   accuracy=task["accuracy"](state.params), shards=task["shards"],
                   wire_bits_per_step=h.get("wire_bits_per_step")
                   or pame_bits(dev, topo, cfg, cnn_init(1, device=dev)))
        emit(phase="path_f", **row)
        if not (_falls(h["loss"]) and row["accuracy"] >= 0.5):
            fail(f"path F ({name}): the loss did not fall or accuracy {row['accuracy']} < 0.5")
    # the profile reuses F3-pame's warm state of the libraries: 5 fresh steps
    prof = profile_steps(dev, lambda: pame_run(steps["profile"]), steps["profile"])
    rows["F3-pame"]["profile"] = prof
    emit(phase="path_f_profile", run="F3-pame", **prof)

    wide = vision_task(dev, ds, lambda y: label_skew_partition(y, M, WIDE_CLASSES, seed=0),
                       cnn_apply)
    hp = ALG.PaMEHp(partition="tree", p_leaf=WIDE_P_LEAF, mask_mode="bernoulli", **EX3_CFG)
    bound = ALG.get_algorithm("pame").bind(wide["grad_fn"], topo, hp, mixing="sparse",
                                           device=dev)
    params0 = cnn_init(1, width=2, device=dev)
    t0 = _start(dev)
    state, h = bound.run(0, params0, M, wide["batch_fn"], steps["wide"], tol_std=0.0,
                         chunk_size=min(steps["wide"], 30))
    rows["F3-wide"] = row = {"run": "F3-wide"}
    _finish(dev, t0, steps["wide"], row, {"f32": 6 * steps["wide"]})
    row.update(steps=h["steps_run"], loss_first=h["loss"][0], loss_last=h["loss"][-1],
               accuracy=wide["accuracy"](state.params),
               params=sum(x.numel() for x in tree_leaves(params0)),
               wire_bits_per_step=h["wire_bits_per_step"], shards=wide["shards"])
    emit(phase="path_f", **row)
    if not _falls(h["loss"]):
        fail("path F (F3-wide): the loss did not fall")
    return rows


def path_f4(dev, ds=None, spec=CIFAR, steps=None):
    """Example 4 on CIFAR-10's size: ResNet-20 under Dirichlet(0.3) skew,
    4 nodes, PaME through `run_pame` (dense exact: the five stage-3 3x3
    convs of 36,864 coordinates reach the PME-average kernel, five launches
    a step): finite loss that falls.  Then 5 profiled steps.  `ds`, when
    given, is `images(spec)` made ahead."""
    from repro_torch.core import PaMEConfig, build_topology, run_pame
    from repro_torch.data import dirichlet_partition
    from repro_torch.models.cnn import resnet20_apply, resnet20_init

    steps = steps or F_STEPS
    topo = build_topology("complete", M)
    task = vision_task(dev, images(spec) if ds is None else ds, lambda y: dirichlet_partition(y, M, 0.3, seed=0),
                       resnet20_apply)
    cfg = PaMEConfig(**EX3_CFG)

    def run(k):
        return run_pame(0, resnet20_init(1, device=dev), M, task["grad_fn"], task["batch_fn"],
                        topo, cfg, num_steps=k, tol_std=0.0, chunk_size=min(k, 40), device=dev)

    t0 = _start(dev)
    state, h = run(steps["resnet"])
    row = {"run": "F4-pame"}
    _finish(dev, t0, steps["resnet"], row, {"pme_average": 5 * steps["resnet"]})
    row.update(steps=h["steps_run"], loss_first=h["loss"][0], loss_last=h["loss"][-1],
               accuracy=task["accuracy"](state.params), shards=task["shards"],
               wire_bits_per_step=pame_bits(dev, topo, cfg, resnet20_init(1, device=dev)))
    emit(phase="path_f", **row)
    if not (all(math.isfinite(x) for x in h["loss"]) and _falls(h["loss"])):
        fail("path F (F4): the loss is not finite or did not fall")
    row["profile"] = prof = profile_steps(dev, lambda: run(steps["profile"]), steps["profile"])
    emit(phase="path_f_profile", run="F4-pame", **prof)
    return {"F4-pame": row}


def path_f(dev, data):
    """F1-F4 (`data`: futures of F3's and F4's image sets); the launches of
    each kernel over the path's runs (each run read just after it ran with
    the counts at 0)."""
    rows = {}
    for fn, args in ((path_f1, ()), (path_f2, ()), (path_f3, ("F3",)), (path_f4, ("F4",))):
        t = time.perf_counter()
        ds = [data[a].result() for a in args]
        waited = time.perf_counter() - t
        rows.update(fn(dev, *ds))
        emit(phase=f"{fn.__name__}_done", seconds=time.perf_counter() - t,
             waited_for_data_s=waited)
    launches = {"f32": 0, "bf16": 0, "pme_average": 0}
    for r in rows.values():
        if "launches" in r:
            for k in launches:
                launches[k] += r["launches"][k]
    return rows, launches


@contextlib.contextmanager
def _tf32_convs():
    """The CNN's convolutions with cuDNN's TF32 allowed (the TF32 pin
    lifted; the scope's other pins kept)."""
    import torch
    from repro_torch.models import cnn

    pin = cnn._ieee_fp32

    @contextlib.contextmanager
    def allow():
        with pin():
            torch.backends.cudnn.allow_tf32 = True
            yield

    cnn._ieee_fp32 = allow
    try:
        yield
    finally:
        cnn._ieee_fp32 = pin


def path_f_parity(dev, sizes=None):
    """One PaME step (dense exact exchange) and one D-PSGD step (sparse
    Mixer) of the CNN and of ResNet-20, from distinct node models with the
    same injected draws, through the kernels and through `plain_routes()`
    (the convolutions' own scope pins cuDNN's deterministic algorithms and
    IEEE fp32); then each model's forward on the card
    against the CPU forward, with the TF32 pin and without it.  Tolerances:
    PARITY_F_ULPS, PARITY_F_PME_ULPS, PARITY_F_RTOL.  `sizes` shrinks the
    batches (the CPU tests rehearse this phase)."""
    import torch
    from repro_torch.core import baselines as B
    from repro_torch.core import build_topology, make_mixer, pame, pme
    from repro_torch.data import SyntheticClassification
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.models.cnn import ce_loss, cnn_apply, cnn_init, resnet20_apply
    from repro_torch.models.cnn import resnet20_init
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    sizes = sizes or {"batch": F_BATCH, "forward": 64}
    topo = build_topology("complete", M)
    cfg = pame.PaMEConfig(**EX3_CFG)
    ta = pame.make_topology_arrays(topo, cfg, seed=0, device=dev)
    mixer = make_mixer(topo, "sparse", device=dev)
    results = {}
    models = (("cnn", cnn_init, cnn_apply, FMNIST, 1), ("resnet20", resnet20_init,
                                                        resnet20_apply, CIFAR, 5))
    for name, init, apply_fn, spec, pme_per_step in models:
        g = torch.Generator(device=dev).manual_seed(7)
        leaves, treedef = tree_flatten(init(1, device=dev))
        stacked = [x.unsqueeze(0) + 0.01 * torch.randn((M,) + tuple(x.shape), generator=g,
                                                        device=dev) for x in leaves]
        ds = SyntheticClassification.make(M * sizes["batch"] + sizes["forward"],
                                          spec["shape"], 10, seed=spec["seed"], sep=spec["sep"])
        nb = M * sizes["batch"]
        batch = {"x": torch.as_tensor(ds.images[:nb], device=dev).view(
                     (M, sizes["batch"]) + spec["shape"]),
                 "y": torch.as_tensor(ds.labels[:nb], device=dev).view(M, sizes["batch"])}

        def grad_fn(params, b, key):
            ls, td = tree_flatten(params)
            loss = ce_loss(apply_fn(params, b["x"]), b["y"])
            return loss.detach(), tree_unflatten(td, list(torch.autograd.grad(loss, ls)))

        comm = torch.ones(M, dtype=torch.bool, device=dev)
        draws = {"a": pme.sample_neighbor_selection(g, ta.nbrs, ta.valid, ta.t, comm),
                 "masks": [pme.sample_coordinate_masks(g, M, x[0].numel(),
                                                       max(1, round(cfg.p * x[0].numel())))
                           for x in stacked]}
        outs = {}
        for route in ("kernel", "plain"):
            with plain_routes() if route == "plain" else contextlib.nullcontext():
                state = pame.pame_init(3, tree_unflatten(treedef, stacked), M, cfg)
                v_bar = pme.pme_average_pytree(None, state.params, draws["a"], cfg.p,
                                               mode="exact", masks=draws["masks"])
                _reset_counts()
                new, _ = pame.pame_step(state, batch, grad_fn, ta, cfg, draws=draws)
                pme_n = pme_average_cuda.launches
                _reset_counts()
                st = B.DPSGDState(tree_unflatten(treedef, [x.clone() for x in stacked]), 0, 3)
                dp, _ = B.dpsgd_step(st, batch, grad_fn, mixer, 0.05)
                _sync(dev)
                outs[route] = {"v_bar": tree_leaves(v_bar), "pame": tree_leaves(new.params),
                               "dpsgd": tree_leaves(dp.params), "pme_launches": pme_n,
                               "gossip_launches": dict(gossip_gather.variant_launches)}
        k, p = outs["kernel"], outs["plain"]
        row = {
            "model": name, "leaves": len(leaves),
            "pame_exchange_f32_ulps": max(ulps_floored(a, b, 23) for a, b in
                                          zip(k["v_bar"], p["v_bar"])),
            "pame_step_f32_ulps": max(ulps_floored(a, b, 23) for a, b in
                                      zip(k["pame"], p["pame"])),
            "pame_step_rel_err": max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                                     for a, b in zip(k["pame"], p["pame"])),
            "dpsgd_step_f32_ulps": max(ulps_floored(a, b, 23) for a, b in
                                       zip(k["dpsgd"], p["dpsgd"])),
            "pme_launches_kernel_route": k["pme_launches"],
            "pme_launches_plain_route": p["pme_launches"],
            "gossip_launches_kernel_route": k["gossip_launches"],
            "gossip_launches_plain_route": p["gossip_launches"],
            "tol": {"dpsgd_ulps": PARITY_F_ULPS, "pame_exchange_ulps": PARITY_F_PME_ULPS,
                    "pame_step_rel": PARITY_F_RTOL}}
        del outs, k, p
        # the forward on the card against the CPU forward, pinned and not
        params = tree_unflatten(treedef, leaves)
        x = torch.as_tensor(ds.images[nb:], device=dev)
        with torch.no_grad():
            want = apply_fn(tree_unflatten(treedef, [t.cpu() for t in leaves]), x.cpu())
            got = apply_fn(params, x).cpu()
            with _tf32_convs():
                got_tf32 = apply_fn(params, x).cpu()
        scale = want.abs().max().item()
        row["forward_rel_err_ieee"] = (got - want).abs().max().item() / scale
        row["forward_rel_err_tf32"] = (got_tf32 - want).abs().max().item() / scale
        if dev.type == "cuda":
            row["forward_ms_ieee"] = time_ms(lambda: apply_fn(params, x), 10)
            with _tf32_convs():
                row["forward_ms_tf32"] = time_ms(lambda: apply_fn(params, x), 10)
        results[name] = row
        emit(phase="parity_f", **row)
        free()
        if row["dpsgd_step_f32_ulps"] > PARITY_F_ULPS \
                or row["pame_exchange_f32_ulps"] > PARITY_F_PME_ULPS \
                or row["pame_step_rel_err"] > PARITY_F_RTOL:
            fail(f"path F parity ({name}): kernel and plain routes differ beyond the tolerance")
        if row["forward_rel_err_ieee"] > PARITY_F_RTOL:
            fail(f"path F parity ({name}): the forward on the card is "
                 f"{row['forward_rel_err_ieee']} off the CPU's (> {PARITY_F_RTOL})")
        if dev.type == "cuda" and (
                row["pme_launches_kernel_route"] != pme_per_step
                or row["gossip_launches_kernel_route"] != {"f32": len(leaves), "bf16": 0}
                or row["pme_launches_plain_route"]
                or any(row["gossip_launches_plain_route"].values())):
            fail(f"path F parity ({name}): the kernel route did not run the kernels "
                 f"({pme_per_step} PME, {len(leaves)} gossip) or the plain route ran one")
    return results


# ---------------------------------------------------------------------------
# path G: serve-while-train with elastic membership
# ---------------------------------------------------------------------------
# G1: stablelm-1.6b at full width and depth, PaME (sparse, f32 gossip kernel,
# 11 launches a step), rush traffic, m = 4 -> 5 -> 4 through a join, a
# partition and its heal, and a leave; consensus serving of 8 x 512-token
# prompts, 16 generated, on 2 nodes a round
G1_ARGS = ["--arch", "stablelm-1.6b", "--variant", "full", "--algo", "pame", "--mixing",
           "sparse", "--nodes", str(M), "--batch", "4", "--seq", "128", "--steps", "12",
           "--chunk", "3", "--arrival", "rush", "--serve-capacity", "4",
           "--defer-threshold", "8", "--prompt-len", "512", "--gen", "16",
           "--serve-batch", "8", "--serve-nodes", "2", "--serve-policy", "consensus",
           "--chaos", "join@3:1,partition@6:2,heal@9,leave@10:1"]
# G2: checkpoint catch-up at full width, 2 layers (a save is about 4.9 GB)
G2_ARGS = ["--arch", "stablelm-1.6b", "--variant", "full", "--algo", "pame", "--nodes",
           str(M), "--batch", "4", "--seq", "128", "--layers", "2", "--steps", "6",
           "--chunk", "2", "--join", "5:1", "--arrival", "off", "--ckpt-every", "2",
           "--prompt-len", "512", "--gen", "16", "--serve-batch", "8"]
# the trainer saves at step 4 only (each save takes ~10 s of the host)
G2_TRAIN = model_args("pame") + ["--layers", "2", "--chunk", "2", "--ckpt-every", "4"]
G_PER_STEP = 11  # f32 gossip launches a step of PaME's sparse exchange (11 leaves)
# parity phase G: a paced PaME and D-PSGD step, node 1 deferred by its queue;
# PaME's also on G1's grown 5-node graph
PARITY_G = (("pame", ("paced", "paced-grown"), "f32", 11), ("dpsgd", ("paced",), "bf16", 11))


def _value(argv, flag):
    return argv[argv.index(flag) + 1]


def path_g1(dev, argv=G1_ARGS, per_step=G_PER_STEP):
    """`serve_train.main` on G1_ARGS: every loss finite, the f32 gossip
    kernel `per_step` times a step at every m (no bf16 launch), each join
    and leave conformant (the leave at its leaf type's tolerance), the
    monitors green with zero cross-component mass in the window, deferrals
    and served <= arrived, every serve round [batch, gen] tokens from
    finite logits, the peak under 80 GB.  `argv` and `per_step` let the CPU
    tests rehearse it at a tiny size."""
    import torch
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.launch import serve_train

    steps, gen, sb = (int(_value(argv, f)) for f in ("--steps", "--gen", "--serve-batch"))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    state, rec = serve_train.main(argv + ["--device", dev.type])
    seconds = time.perf_counter() - t0
    launches = dict(gossip_gather.variant_launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    del state
    free()
    for c in rec["chunks"]:
        emit(phase="path_g1_chunk", k=c["k"], m=c["m"], s_per_step=c["seconds"] / c["steps"],
             loss=c["loss"], deferred=c.get("deferred"), comp_gap=c.get("comp_gap"),
             peak_bytes_so_far=c["peak_bytes"])
    for r in rec["serves"]:
        for i, st in r["nodes"].items():
            emit(phase="path_g1_serve", k=r["k"], m=r["m"], node=i, prefill_ms=st["prefill_ms"],
                 decode_ms_per_token=st["decode_ms"] / (gen - 1),
                 tokens_per_s=st["tokens_per_s"], tokens=list(st["tokens"]),
                 logits_finite=st["logits_finite"],
                 latency_rounds=(r["latency_rounds"] or {}).get(i),
                 peak_bytes_so_far=r["peak_bytes"])
    for ev in rec["events"]:
        emit(phase="path_g1_event", **ev)
    row = {"steps": rec["steps"], "seconds": seconds, "peak_bytes": peak,
           "gossip_launches": launches, "summary": rec["summary"],
           "m_after_events": [ev["m_after"] for ev in rec["events"]]}
    emit(phase="path_g1", **row)
    losses = rec["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"path G1: expected {steps} finite losses, got {losses}")
    if cuda and launches != {"f32": per_step * steps, "bf16": 0}:
        fail(f"path G1: expected {per_step} f32 gossip launches a step, got {launches}")
    if row["m_after_events"] != [M + 1, M + 1, M + 1, M]:
        fail(f"path G1: expected m = 4 -> 5 -> 4, got {row['m_after_events']}")
    kinds = {ev["kind"]: ev for ev in rec["events"]}
    conf = [all(kinds[k]["conformance"].values()) for k in ("join", "leave")]
    if not all(conf) or not kinds["join"]["incumbents_untouched"] \
            or not kinds["join"]["joiners_equal_source"] or "leave_check" not in kinds["leave"]:
        fail("path G1: a join or leave was not conformant")
    if not (kinds["partition"]["monitor"].get("green") and kinds["heal"]["monitor"].get("green")
            and kinds["partition"]["monitor"]["cross_mass"] == 0.0):
        fail("path G1: the partition or heal monitor was not green")
    summ = rec["summary"]
    if not summ["deferred_node_rounds"] > 0 or not summ["served"] <= summ["arrived"]:
        fail(f"path G1: expected deferrals and served <= arrived, got {summ}")
    for r in rec["serves"]:
        for i, st in r["nodes"].items():
            if tuple(st["tokens"]) != (sb, gen) or not st["logits_finite"]:
                fail(f"path G1: serve@{r['k']} node {i} gave {st['tokens']} tokens, "
                     f"finite logits {st['logits_finite']}")
    if peak is not None and peak >= PEAK_LIMIT:
        fail(f"path G1: peak {peak} bytes is not under 80 GB")
    return launches["f32"]


def path_g2(dev, argv=G2_ARGS, train_argv=G2_TRAIN, per_step=G_PER_STEP):
    """Checkpoint catch-up: `serve_train.main` on G2_ARGS with a fresh
    --ckpt-dir (the joiner at step 5 reports catch-up=ckpt@4, its rows equal
    its donor's rows in the step-4 checkpoint bit for bit, the incumbents'
    rows are untouched), then the trainer for 4 steps and for 6 from one
    --ckpt-dir (it resumes at step 4).  Each save's and restore's seconds
    and bytes; the directories are removed at the end."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.launch import serve_train, train
    from repro_torch.tree import tree_leaves, tree_map

    root = tempfile.mkdtemp(prefix="chip_smoke_g2_")
    seen = {}

    def observe(rec, state):
        # the joiner's rows against its donor's rows in the checkpoint the
        # run says it caught up from, read back independently
        if rec["kind"] != "join":
            return
        m_old, m_new = rec["m_before"], rec["m_after"]
        stacked = lambda x: isinstance(x, torch.Tensor) and x.dim() >= 1 \
            and x.shape[0] == m_new  # noqa: E731
        tmpl = {"state": tree_map(lambda x: x[:m_old] if stacked(x) else x, state)}
        src = restore_checkpoint(ckpt, tmpl, int(rec["catch_up"].split("@")[1]))["state"]
        pairs = [(x, s) for x, s in zip(tree_leaves(state), tree_leaves(src)) if stacked(x)]
        seen["joiner_equals_ckpt_donor"] = all(
            torch.equal(x[m_old + j], s[d].to(x.device))
            for x, s in pairs for j, d in enumerate(rec["donors"]))
        del tmpl, src, pairs

    try:
        ckpt = os.path.join(root, "serve_train")
        _reset_counts()
        state, rec = serve_train.main(argv + ["--ckpt-dir", ckpt, "--device", dev.type],
                                      observe=observe)
        del state
        free()
        g_launches = gossip_gather.variant_launches["f32"]
        join = [ev for ev in rec["events"] if ev["kind"] == "join"][0]
        row = {"catch_up": join["catch_up"], "donors": join["donors"],
               "incumbents_untouched": join["incumbents_untouched"],
               "joiners_equal_source": join["joiners_equal_source"],
               "saves": rec["checkpoints"], "catch_up_restores": rec["catch_up_restores"],
               "losses": rec["losses"], "gossip_f32_launches": g_launches, **seen}
        shutil.rmtree(ckpt)
        tdir = os.path.join(root, "train")
        _reset_counts()
        first = train.main(train_argv + ["--steps", "4", "--ckpt-dir", tdir,
                                         "--device", dev.type])
        second = train.main(train_argv + ["--steps", "6", "--ckpt-dir", tdir,
                                          "--device", dev.type])
        t_launches = gossip_gather.variant_launches["f32"]
        row.update(train_start=second["start"], train_saves=first["checkpoints"]
                   + second["checkpoints"], train_restore=second["restore"],
                   train_losses=first["loss"] + second["loss"], train_gossip_f32=t_launches)
        emit(phase="path_g2", **row)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if row["catch_up"] != "ckpt@4" or not row.get("joiner_equals_ckpt_donor") \
            or not row["incumbents_untouched"] or not row["joiners_equal_source"]:
        fail(f"path G2: expected catch-up=ckpt@4 with the donor's checkpointed rows, got {row}")
    if row["train_start"] != 4:
        fail(f"path G2: the trainer resumed at {row['train_start']}, not at step 4")
    if not all(math.isfinite(x) for x in row["losses"] + row["train_losses"]):
        fail("path G2: a loss was not finite")
    steps = int(_value(argv, "--steps"))
    if dev.type == "cuda" and (g_launches != per_step * steps or t_launches != per_step * 6):
        fail(f"path G2: expected {per_step} f32 gossip launches a step, got {g_launches} "
             f"and {t_launches}")
    return g_launches + t_launches


def path_g_parity(dev, cfg=None, batch=4, seq=128):
    """Parity phase G: the paced steps of PARITY_G through the kernel and the
    plain routes (`_network_parity`, 0 ulps), then `retire_state` (the last
    node leaves) and `expand_state` (one joiner cloning node 1) of a
    distinct-node parameter stack on the card against the same calls on a
    CPU copy, within one floored bf16 ulp.  stablelm-1.6b at full width and
    PARITY_LAYERS layers unless `cfg` says otherwise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.core.topology import build_topology
    from repro_torch.serve import membership
    from repro_torch.tree import tree_leaves, tree_map

    rows = _network_parity(dev, PARITY_G, "g", cfg, batch, seq)
    if cfg is None:
        cfg = get_config("stablelm-1.6b", "full").replace(n_layers=PARITY_LAYERS)
    g = torch.Generator(device=dev).manual_seed(13)
    stacked = tree_map(lambda x: (x.float().unsqueeze(0) + 0.01 * torch.randn(
        (M,) + tuple(x.shape), generator=g, device=dev)).to(x.dtype),
        init_params(0, cfg, device=dev))
    host = tree_map(lambda x: x.cpu(), stacked)
    topo = build_topology("erdos_renyi", M, p=0.5, seed=0)
    row = {"layers": cfg.n_layers}
    for name, fn in (("retire", lambda t: membership.retire_state(t, topo, (M - 1,))),
                     ("expand", lambda t: membership.expand_state(t, M, [1]))):
        _sync(dev)
        t0 = time.perf_counter()
        got = fn(stacked)
        _sync(dev)
        row[f"{name}_s_card"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fn(host)
        row[f"{name}_s_cpu"] = time.perf_counter() - t0
        row[f"{name}_max_bf16_ulps_floored"] = max(
            ulps_floored(a, b.to(dev)) for a, b in zip(tree_leaves(got), tree_leaves(want)))
        del got, want
        free()
    emit(phase="parity_g_membership", **row)
    del stacked, host
    free()
    if row["retire_max_bf16_ulps_floored"] > PARITY_ULPS \
            or row["expand_max_bf16_ulps_floored"] > PARITY_ULPS:
        fail(f"path G parity: retire_state or expand_state on the card is more than "
             f"{PARITY_ULPS} bf16 ulp from the CPU's ({row})")
    rows["membership"] = row
    return rows


# ---------------------------------------------------------------------------
# path H: batched seed and config lanes
# ---------------------------------------------------------------------------
# H1: path A's CLI with --seeds 2 at full width and path D's 12 layers: at
# the full 24 the first step needs about 77 GB of the card's 80 (63.57 GiB
# held when the last MLP leaf's exchange asked for another 8.25 GiB, on an
# H100 80GB HBM3): two lanes double the state and the exchange's f32
# transients.  kappa_i = 2: with path A's periods (7, 6, 5, 4 at seed 0) no
# node exchanges between steps 0 and 4, and two lanes from the same weights
# run the same first three steps.
H1_LAYERS = PATH_D_LAYERS
# H1's largest leaf: the embedding (vocab × d_model), larger than an MLP
# leaf (layers × d_model × d_ff) at H1_LAYERS layers
H1_LEAF_N = max(100352 * 2048, H1_LAYERS * 2048 * 5632)
H1_ARGS = ["--seeds", "2", "--kappa-lo", "2", "--kappa-hi", "2"]
H_SEEDS = 5
# H2 runs F3's steps, H3 fewer than F4's 40 (five lanes' gradients a step),
# H2's dynamic grid a few
H_STEPS = dict(cnn=80, resnet=20, profile=5, dynamic=10)
# H2's dynamic network: the i.i.d. link drops and churn of path E's
# dynamic runs
H_SCENARIO = dict(name="flaky", churn=0.1, edge_drop=0.2, seed=5)
PARITY_H_ULPS = 0.0  # batched against unbatched, both through the kernels


def path_h1(dev, layers=H1_LAYERS):
    """The trainer CLI with --seeds 2: path A's model and flags, two lanes
    of PaME with the sparse exchange, 3 steps.  The f32 gossip kernel must
    launch 11 times a step for both lanes together, the lanes' losses be
    finite and differ, the peak stay under 80 GB."""
    import numpy as np
    import torch
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.launch import train

    steps = 3
    depth = [] if layers is None else ["--layers", str(layers)]
    t0 = _start(dev)
    out = train.main(model_args("pame") + depth + H1_ARGS + ["--steps", str(steps), "--chunk",
                                                            "1", "--device", "cuda"])
    _sync(dev)
    lanes = np.asarray(out["metrics"]["loss_mean"])
    row = {"phase": "path_h1", "steps": out["steps"], "lane_losses": lanes.tolist(),
           "s_per_step": out["seconds"], "seconds": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated(), "layers": layers or 24,
           "gossip_variant_launches": dict(gossip_gather.variant_launches)}
    emit(**row)
    if row["gossip_variant_launches"] != {"f32": 11 * steps, "bf16": 0}:
        fail("path H1: expected 11 f32 gossip launches a step for both lanes")
    if lanes.shape != (steps, 2) or not np.isfinite(lanes).all() or lanes[-1, 0] == lanes[-1, 1]:
        fail("path H1: the two lanes' losses must be finite and differ")
    if row["peak_bytes"] >= PEAK_LIMIT:
        fail(f"path H1: peak {row['peak_bytes']} B over {PEAK_LIMIT}")
    free()
    return row


def _lane_accuracy(task, params, lanes):
    """Held-out accuracy of each lane's node-mean model."""
    from repro_torch.tree import tree_map

    return [task["accuracy"](tree_map(lambda x: x[lane], params)) for lane in range(lanes)]


def path_h2(dev, ds=None, spec=FMNIST, steps=None):
    """Example 3 as the JAX `heterogeneity` bench runs it: the CNN under
    label skew C = 7 (F3's data, EX3_CFG, complete graph, batch 32), PaME
    through `bind_batched` with the sparse exchange, at L = 1 and L = 5
    seeds with the same steps.  Gossip launches a step equal at both (one
    a leaf), held-out accuracy of every lane's node-mean model at least
    0.5, `lane_finals(hist, "loss")`, and 5 profiled steps of each.  Then
    the same grid under a dynamic network (H_SCENARIO) at L = 1 and L = 5:
    the lanes' realizations are folded too, so the exchange launches once
    a leaf for all lanes (6 a step at both), which the card must show."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import build_topology
    from repro_torch.core.scenarios import Scenario
    from repro_torch.data import label_skew_partition
    from repro_torch.models.cnn import cnn_apply, cnn_init

    steps = steps or H_STEPS
    topo = build_topology("complete", M)
    task = vision_task(dev, images(spec) if ds is None else ds,
                       lambda y: label_skew_partition(y, M, 7, seed=0), cnn_apply)
    rows = {}
    for lanes in (1, H_SEEDS):
        ba = ALG.get_algorithm("pame").bind_batched(
            task["grad_fn"], topo, [ALG.PaMEHp(**EX3_CFG)], seeds=range(lanes), mixing="sparse",
            device=dev)

        def run(k):
            return ba.run(cnn_init(1, device=dev), M, task["batch_fn"], k,
                          chunk_size=min(k, 40))

        k = steps["cnn"]
        t0 = _start(dev)
        state, h = run(k)
        name = f"H2-L{lanes}"
        rows[name] = row = {"run": name, "lanes": lanes, "folded": lanes > 1}
        _finish(dev, t0, k, row, {"f32": 6 * k})
        row.update(s_per_step_per_lane=row["s_per_step"] / lanes,
                   loss_first=h["loss"][0].tolist(),
                   lane_final_loss=ALG.lane_finals(h, "loss").tolist(),
                   accuracy=_lane_accuracy(task, ba.params_of(state), lanes),
                   wire_bits_per_step=h["wire_bits_per_step"].tolist(),
                   steps_run=h["steps_run"].tolist())
        emit(phase="path_h", **row)
        if min(row["accuracy"]) < 0.5 or not all(math.isfinite(x) for x in
                                                 row["lane_final_loss"]):
            fail(f"path H ({name}): a lane's accuracy is below 0.5 or its loss not finite")
        row["profile"] = prof = profile_steps(dev, lambda: run(steps["profile"]),
                                              steps["profile"])
        emit(phase="path_h_profile", run=name, **prof)
        del state, ba
    if rows["H2-L1"]["launches_per_step"] != rows[f"H2-L{H_SEEDS}"]["launches_per_step"]:
        fail("path H2: gossip launches a step differ between 1 and 5 lanes")
    k = steps["dynamic"]
    for lanes in (1, H_SEEDS):
        ba = ALG.get_algorithm("pame").bind_batched(
            task["grad_fn"], topo, [ALG.PaMEHp(**EX3_CFG)], seeds=range(lanes), mixing="sparse",
            scenario=Scenario(**H_SCENARIO), device=dev)
        t0 = _start(dev)
        state, h = ba.run(cnn_init(1, device=dev), M, task["batch_fn"], k, chunk_size=k)
        name = f"H2dyn-L{lanes}"
        rows[name] = row = {"run": name, "lanes": lanes, "folded": lanes > 1}
        _finish(dev, t0, k, row, {"f32": 6 * k})
        row.update(s_per_step_per_lane=row["s_per_step"] / lanes,
                   lane_final_loss=ALG.lane_finals(h, "loss").tolist(),
                   wire_bits_per_step=h["wire_bits_per_step"].tolist())
        emit(phase="path_h", **row)
        if not all(math.isfinite(x) for x in row["lane_final_loss"]):
            fail(f"path H ({name}): a lane's loss is not finite")
        del state, ba
    return rows


def path_h3(dev, ds=None, spec=CIFAR, steps=None, batch=F_BATCH):
    """Example 4's ResNet-20 under Dirichlet(0.3), F4's settings, through
    `bind_batched(seeds=range(5), mixing="dense")` with exact masks: the
    PME-average kernel's lane axis 5 times a step (F4's count, not 25);
    finite losses that fall in every lane."""
    import numpy as np
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import build_topology
    from repro_torch.data import dirichlet_partition
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.models.cnn import resnet20_apply, resnet20_init

    steps = steps or H_STEPS
    k = steps["resnet"]
    topo = build_topology("complete", M)
    task = vision_task(dev, images(spec) if ds is None else ds,
                       lambda y: dirichlet_partition(y, M, 0.3, seed=0), resnet20_apply, batch)
    ba = ALG.get_algorithm("pame").bind_batched(
        task["grad_fn"], topo, [ALG.PaMEHp(**EX3_CFG)], seeds=range(H_SEEDS), mixing="dense",
        device=dev)
    t0 = _start(dev)
    state, h = ba.run(resnet20_init(1, device=dev), M, task["batch_fn"], k,
                      chunk_size=min(k, 40))
    row = {"run": "H3", "lanes": H_SEEDS, "folded": True}
    _finish(dev, t0, k, row, {"pme_average": 5 * k})
    losses = np.asarray(h["loss"])
    row.update(s_per_step_per_lane=row["s_per_step"] / H_SEEDS,
               pme_lane_launches=pme_average_cuda.lane_launches,
               loss_first=losses[0].tolist(), lane_final_loss=ALG.lane_finals(h, "loss").tolist(),
               accuracy=_lane_accuracy(task, ba.params_of(state), H_SEEDS))
    emit(phase="path_h", **row)
    falls = [_falls(losses[:, lane].tolist()) for lane in range(H_SEEDS)]
    if not (np.isfinite(losses).all() and all(falls)):
        fail(f"path H3: a lane's loss is not finite or did not fall ({falls})")
    if dev.type == "cuda" and row["pme_lane_launches"] != 5 * k:
        fail("path H3: the PME-average launches did not take the lane axis")
    del state, ba
    free()
    return {"H3": row}


def h4_forms():
    """H4's three network forms: (name, algorithm, its hyperparameters,
    bind_batched's network argument)."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.temporal import TemporalScenario
    from repro_torch.serve.events import ServePacing, get_arrival

    return (
        ("temporal", "pame", ALG.PaMEHp(**EX3_CFG),
         dict(scenario=TemporalScenario(name="stale", straggler=0.4, staleness=2,
                                        burst_down=0.05, burst_up=0.3, seed=4))),
        ("faults", "choco", ALG.ChocoHp(lr=0.05),
         dict(faults=FaultModel(name="lossy_crashy", loss=0.1, crash=0.05, rejoin=0.5,
                                seed=3))),
        ("paced", "pame", ALG.PaMEHp(**EX3_CFG),
         dict(pacing=ServePacing(get_arrival("bursty"), capacity=2, defer_threshold=3))),
    )


def path_h4(dev, ds=None, spec=FMNIST, steps=None):
    """H2's CNN grid (label skew C = 7, complete graph, batch 32) at L = 1
    and L = 5 seeds under a TemporalScenario with staleness D = 2 (PaME
    sparse), a FaultModel with message loss and crashes (CHOCO with
    per-receiver replicas) and a ServePacing with bursty arrivals (PaME
    sparse), 10 steps each: every form's lanes folded into one step, so 6
    f32 gossip launches a step (one a leaf: PaME's exchange, CHOCO's
    replica mix) at both lane counts; a finite loss in every lane."""
    import numpy as np
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import build_topology
    from repro_torch.data import label_skew_partition
    from repro_torch.models.cnn import cnn_apply, cnn_init

    steps = steps or H_STEPS
    k = steps["dynamic"]
    topo = build_topology("complete", M)
    task = vision_task(dev, images(spec) if ds is None else ds,
                       lambda y: label_skew_partition(y, M, 7, seed=0), cnn_apply)
    rows = {}
    for form, algo, hp, net in h4_forms():
        for lanes in (1, H_SEEDS):
            ba = ALG.get_algorithm(algo).bind_batched(
                task["grad_fn"], topo, [hp], seeds=range(lanes), mixing="sparse", device=dev,
                **net)
            t0 = _start(dev)
            state, h = ba.run(cnn_init(1, device=dev), M, task["batch_fn"], k, chunk_size=k)
            name = f"H4-{form}-L{lanes}"
            rows[name] = row = {"run": name, "form": form, "algo": algo, "lanes": lanes,
                                "folded": lanes > 1}
            _finish(dev, t0, k, row, {"f32": 6 * k})
            row.update(s_per_step_per_lane=row["s_per_step"] / lanes,
                       lane_final_loss=ALG.lane_finals(h, "loss").tolist(),
                       wire_bits_per_step=h["wire_bits_per_step"].tolist())
            for key in ("stale_nodes", "crashed_nodes", "dropped_msgs", "deferred_nodes"):
                if key in h:
                    row[f"{key}_total"] = np.asarray(h[key]).sum(axis=0).tolist()
            emit(phase="path_h", **row)
            if not all(math.isfinite(x) for x in row["lane_final_loss"]):
                fail(f"path H ({name}): a lane's loss is not finite")
            del state, ba
        if rows[f"H4-{form}-L1"]["launches_per_step"] != \
                rows[f"H4-{form}-L{H_SEEDS}"]["launches_per_step"]:
            fail(f"path H4 ({form}): gossip launches a step differ between 1 and 5 lanes")
    free()
    return rows


def path_h1dyn(dev, h1, layers=H1_LAYERS):
    """H1 under a dynamic network: the trainer CLI with --seeds 2
    --edge-drop 0.2 --churn 0.1 on path A's model at H1's depth, 3 steps.
    The two lanes' realizations fold into one step, so the f32 gossip
    kernel launches 11 times a step as in H1's static run; finite losses;
    the peak within a few GB of H1's (`h1`, its row)."""
    import numpy as np
    import torch
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.launch import train

    steps = 3
    t0 = _start(dev)
    out = train.main(model_args("pame") + ["--layers", str(layers)] + H1_ARGS
                     + ["--edge-drop", "0.2", "--churn", "0.1", "--steps", str(steps),
                        "--chunk", "1", "--device", "cuda"])
    _sync(dev)
    lanes = np.asarray(out["metrics"]["loss_mean"])
    row = {"phase": "path_h1dyn", "steps": out["steps"], "lane_losses": lanes.tolist(),
           "s_per_step": out["seconds"], "seconds": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated(), "layers": layers,
           "h1_peak_bytes": h1["peak_bytes"],
           "alive_nodes": out["metrics"].get("alive_nodes"),
           "gossip_variant_launches": dict(gossip_gather.variant_launches)}
    emit(**row)
    if row["gossip_variant_launches"] != {"f32": 11 * steps, "bf16": 0}:
        fail("path H1dyn: expected 11 f32 gossip launches a step for both lanes, as H1")
    if lanes.shape != (steps, 2) or not np.isfinite(lanes).all():
        fail("path H1dyn: the two lanes' losses must be finite")
    if row["peak_bytes"] >= PEAK_LIMIT:
        fail(f"path H1dyn: peak {row['peak_bytes']} B over {PEAK_LIMIT}")
    free()
    return row


def path_h(dev, data):
    """H2, H3 and H4 (`data`: the futures of F3's and F4's image sets); the
    launches of each kernel over them."""
    rows = {}
    for fn, key in ((path_h2, "F3"), (path_h3, "F4"), (path_h4, "F3")):
        t = time.perf_counter()
        rows.update(fn(dev, data[key].result()))
        emit(phase=f"{fn.__name__}_done", seconds=time.perf_counter() - t)
    launches = {"f32": 0, "bf16": 0, "pme_average": 0}
    for r in rows.values():
        for k in launches:
            launches[k] += r["launches"][k]
    return rows, launches


def path_h_parity(dev, cfg=None, batch=4, seq=128, cnn_sizes=None):
    """One lane-batched step of 2 lanes through the kernels against each
    lane stepped unbatched through the kernels (0 ulps: f32 and bf16 leaves
    bit-equal), for PaME's sparse exchange (path A's config), PaME's dense
    exact exchange (path B's), D-PSGD on the bf16 Mixer at full width and
    PARITY_LAYERS layers, and for the CNN (PaME sparse, f32); the same
    batched step through the plain routes within phases 5 and 8's
    tolerance (one bf16 ulp, floored for D-PSGD; 1e-5 of the scale for the
    f32 CNN); and lane 0 poisoned with a NaN leaving lane 1 bit-equal.
    Each lane's node models differ (seeded noise)."""
    import torch
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import build_topology
    from repro_torch.data import SyntheticClassification
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.models.cnn import ce_loss, cnn_apply, cnn_init
    from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

    seeds = [3, 4]
    if cfg is None:
        from repro_torch.configs import get_config

        cfg = get_config("stablelm-1.6b", "full").replace(n_layers=PARITY_LAYERS)
    from repro_torch.launch.train import make_lm_task

    topo, params0, lm_grad, make_batch = make_lm_task(cfg, M, batch, seq, 0, "erdos_renyi", dev)
    lm_batch = make_batch(0)
    cnn_sizes = cnn_sizes or {"batch": F_BATCH}
    ds = SyntheticClassification.make(M * cnn_sizes["batch"], FMNIST["shape"], 10,
                                      seed=FMNIST["seed"], sep=FMNIST["sep"])
    cnn_batch = {"x": torch.as_tensor(ds.images, device=dev).view(
                     (M, cnn_sizes["batch"]) + FMNIST["shape"]),
                 "y": torch.as_tensor(ds.labels, device=dev).view(M, cnn_sizes["batch"])}

    def cnn_grad(params, b, key):
        ls, td = tree_flatten(params)
        loss = ce_loss(cnn_apply(params, b["x"]), b["y"])
        return loss.detach(), tree_unflatten(td, list(torch.autograd.grad(loss, ls)))

    lm_hp = ALG.PaMEHp(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0, mask_mode="bernoulli")
    cases = (
        ("pame-sparse", "pame", lm_hp, "sparse", lm_grad, params0, lm_batch, topo),
        ("pame-dense-exact", "pame", ALG.PaMEHp(), "dense", lm_grad, params0, lm_batch, topo),
        ("dpsgd-bf16", "dpsgd", ALG.DPSGDHp(lr=0.05), "sparse", lm_grad, params0, lm_batch, topo),
        ("cnn-pame-sparse", "pame", ALG.PaMEHp(**EX3_CFG), "sparse", cnn_grad,
         cnn_init(1, device=dev), cnn_batch, build_topology("complete", M)),
    )
    results = {}
    for name, algo, hp, mixing_mode, grad_fn, p0, b, tp in cases:
        ba = ALG.get_algorithm(algo).bind_batched(grad_fn, tp, [hp], seeds=seeds,
                                                  mixing=mixing_mode, device=dev)
        g = torch.Generator(device=dev).manual_seed(11)
        state = ba.init(p0, M)
        with torch.no_grad():  # distinct node models in each lane
            for x in tree_leaves(ba.params_of(state)):
                x.add_((0.01 * torch.randn(x.shape, generator=g, device=dev)).to(x.dtype))
        params = [x.clone() for x in tree_leaves(ba.params_of(state))]
        treedef = tree_flatten(ba.params_of(state))[1]

        def start(lanes_params):
            """The batched state with the given [L, M, ...] parameter leaves."""
            st = ba.init(p0, M)
            for x, v in zip(tree_leaves(ba.params_of(st)), lanes_params):
                x.copy_(v)
            return st

        def batched(route="kernel", poison=False):
            st = start(params)
            if poison:
                tree_leaves(ba.params_of(st))[0][0, 1].view(-1)[0] = float("nan")
            with plain_routes() if route == "plain" else contextlib.nullcontext():
                _reset_counts()
                new, _ = ba.step(st, b)
                _sync(dev)
            out = [x.clone() for x in tree_leaves(ba.params_of(new))]
            return out, dict(gossip_gather.variant_launches), pme_average_cuda.launches

        got, g_launches, p_launches = batched()
        worst, equal = 0.0, True
        for lane, seed in enumerate(seeds):
            bound = ALG.get_algorithm(algo).bind(grad_fn, tp, hp, mixing=mixing_mode, device=dev)
            st = bound.init(seed, tree_unflatten(treedef, [x[lane].clone() for x in params]))
            new, _ = bound.step(st, b)
            _sync(dev)
            for gl, wl in zip(got, tree_leaves(bound.params_of(new))):
                equal = equal and torch.equal(gl[lane], wl)
                worst = max(worst, ulps_floored(gl[lane], wl,
                                                7 if wl.dtype == torch.bfloat16 else 23))
            del st, new
        plain, _, _ = batched("plain")
        poisoned, _, _ = batched(poison=True)
        row = {"case": name, "lanes": len(seeds), "bit_equal": equal,
               "batched_vs_unbatched_ulps": worst,
               "gossip_launches": g_launches, "pme_average_launches": p_launches,
               "nan_lane_isolated": all(torch.equal(a[1], c[1]) for a, c in zip(poisoned, got)),
               "poisoned_lane_finite": all(bool(torch.isfinite(a[0]).all()) for a in poisoned)}
        if name.startswith("cnn"):
            row["plain_rel_err"] = max(((a - c).abs().max() / c.abs().max().clamp(min=1e-30))
                                       .item() for a, c in zip(got, plain))
            ok_plain = row["plain_rel_err"] <= PARITY_F_RTOL
        else:
            row["plain_bf16_ulps"] = max((
                (ulps_floored(a, c) if algo == "dpsgd" else bf16_ulps(a, c))
                for a, c in zip(got, plain) if a.dtype == torch.bfloat16), default=0.0)
            ok_plain = row["plain_bf16_ulps"] <= PARITY_ULPS
        results[name] = row
        emit(phase="parity_h", **row)
        del got, plain, poisoned, params, state, ba
        free()
        if not equal or worst > PARITY_H_ULPS or not ok_plain or not row["nan_lane_isolated"]:
            fail(f"path H parity ({name}): batched and unbatched steps differ, the plain "
                 "route is out of tolerance, or a NaN lane reached the other")
        # one launch a leaf for both lanes: every leaf through the gossip
        # kernel (sparse), the leaves of at least 2^17 elements a lane
        # through the PME average (dense)
        leaves = tree_leaves(p0)
        want = (len(leaves) if mixing_mode == "sparse"
                else sum(M * x.numel() >= 1 << 17 for x in leaves))
        if dev.type == "cuda" and g_launches["f32"] + g_launches["bf16"] + p_launches != want:
            fail(f"path H parity ({name}): {want} exchange launches expected for both lanes")
    results.update(path_h_parity_forms(dev, cnn_grad, cnn_batch))
    return results


def parity_forms():
    """Parity phase H's network forms on the CNN: (case, algorithm, its
    hyperparameters, bind's network argument).  The paced form's pacing
    defers nodes from step 0 (queues past 1 request)."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.scenarios import Scenario
    from repro_torch.serve.events import ServePacing, get_arrival

    forms = [("cnn-scenario", "pame", ALG.PaMEHp(**EX3_CFG), dict(scenario=Scenario(
        **H_SCENARIO)))]
    for form, algo, hp, net in h4_forms():
        if form == "paced":
            net = dict(pacing=ServePacing(get_arrival("rush"), capacity=2, defer_threshold=1))
        forms.append((f"cnn-{form}", algo, hp, net))
    return forms


def path_h_parity_forms(dev, grad_fn, batch, seeds=(3, 4, 5)):
    """One step of each network form (dynamic scenario, temporal with
    staleness 2, faults with CHOCO's replicas, pacing) on 3 lanes of the
    CNN with distinct node models: the folded step through the kernels
    equals each lane's unbatched `bind(...).step` through the kernels bit
    for bit (its seed folded into the network, fault and pace keys), with
    no switch set for it; the same step through `plain_routes()` within
    1e-5 of the scale (phase 12's f32 tolerance); a NaN in lane 0 leaving
    lanes 1 and 2 bit-equal; one gossip launch a leaf for all lanes."""
    import torch
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import build_topology
    from repro_torch.core.pme import fold_in
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.models.cnn import cnn_init
    from repro_torch.tree import tree_leaves

    topo = build_topology("complete", M)
    p0 = cnn_init(1, device=dev)
    n_leaves = len(tree_leaves(p0))
    results = {}
    for name, algo, hp, net in parity_forms():
        alg = ALG.get_algorithm(algo)
        ba = alg.bind_batched(grad_fn, topo, [hp], seeds=list(seeds), mixing="sparse",
                              device=dev, **net)
        g = torch.Generator(device=dev).manual_seed(13)
        noise = [0.01 * torch.randn(x.shape, generator=g, device=dev)
                 for x in tree_leaves(ba.params_of(ba.init(p0, M, batch)))]

        def start(bound_init, lane=None):
            """A fresh state with the lanes' noise (lane `lane`'s only, for
            an unbatched state) added to its parameters."""
            st = bound_init()
            with torch.no_grad():
                for x, v in zip(tree_leaves(ba.params_of(st)), noise):
                    x.add_(v if lane is None else v[lane])
            return st

        def batched(route="kernel", poison=False):
            st = start(lambda: ba.init(p0, M, batch))
            if poison:
                tree_leaves(ba.params_of(st))[0][0, 1].view(-1)[0] = float("nan")
            aux = ba.aux_init(st) if ba.carries_aux else None
            with plain_routes() if route == "plain" else contextlib.nullcontext():
                _reset_counts()
                out = ba.step(st, batch, 0, aux) if ba.carries_aux else ba.step(st, batch, 0)
                _sync(dev)
            return ([x.clone() for x in tree_leaves(ba.params_of(out[0]))],
                    dict(gossip_gather.variant_launches))

        got, launches = batched()
        equal, worst = True, 0.0
        for lane, seed in enumerate(seeds):
            b = alg.bind(grad_fn, topo, hp, mixing="sparse", device=dev, **net)
            b.scen_arrays = b.scen_arrays._replace(key=fold_in(b.scen_arrays.key, seed))
            if b.faulty:
                b.fault_key = fold_in(int(b.faults.seed), seed)
            if b.paced:
                b.pace_key = fold_in(int(b.pacing.process.seed), seed)
            st = start(lambda: b.init(seed, ALG.B.stack_params(p0, M), batch), lane)
            aux = b.aux_init(st) if b.carries_aux else None
            new = (b.step(st, batch, 0, aux) if b.carries_aux else b.step(st, batch, 0))[0]
            _sync(dev)
            for gl, wl in zip(got, tree_leaves(b.params_of(new))):
                equal = equal and torch.equal(gl[lane], wl)
                worst = max(worst, ulps_floored(gl[lane], wl, 23))
            del st, new
        plain, _ = batched("plain")
        poisoned, _ = batched(poison=True)
        row = {"case": name, "algo": algo, "lanes": len(seeds), "bit_equal": equal,
               "batched_vs_unbatched_ulps": worst, "gossip_launches": launches,
               "plain_rel_err": max(((a - c).abs().max() / c.abs().max().clamp(min=1e-30))
                                    .item() for a, c in zip(got, plain)),
               "nan_lane_isolated": all(torch.equal(a[lane], c[lane]) for a, c in
                                        zip(poisoned, got) for lane in (1, 2))}
        results[name] = row
        emit(phase="parity_h", **row)
        del got, plain, poisoned, ba
        free()
        if not equal or worst > PARITY_H_ULPS or row["plain_rel_err"] > PARITY_F_RTOL \
                or not row["nan_lane_isolated"]:
            fail(f"path H parity ({name}): folded and unbatched steps differ, the plain "
                 "route is out of tolerance, or a NaN lane reached another")
        if dev.type == "cuda" and launches != {"f32": n_leaves, "bf16": 0}:
            fail(f"path H parity ({name}): {n_leaves} f32 gossip launches expected for "
                 f"all lanes, got {launches}")
    return results


# ---------------------------------------------------------------------------
# path I: the remaining LM architectures (MLA, MoE, chunked prefill, remat,
# untied heads, the VLM and audio stand-ins, the optimizers)
# ---------------------------------------------------------------------------
I_LM = "deepseek-v2-lite-16b"
# I1: the trainer at full width and 3 layers (the dense first layer and 2
# MoE layers: 1,460,430,848 parameters a node, about stablelm-1.6b's);
# 4 full-depth copies (31.0 GB each in bf16) do not fit in 80 GB
I1_LAYERS = 3
I_STEPS = 3
# I2 and I3: one node model at full depth, path C's prompts; I2 prefills
# in query chunks of 512
I_SERVE = dict(prompt_len=2048, gen=32, batch=8, seed=0)
I2_CHUNK = 512
# I4: the other five new configs at full width, cut to 2 layers (deepseek-
# v2-236b: its dense first layer and one MoE layer); one prefill of 2 x 256
# tokens and 4 decoded tokens
I4_ARCHS = ("minitron-4b", "internvl2-2b", "musicgen-large", "yi-34b", "deepseek-v2-236b")
I4_LAYERS = 2
I4_SERVE = dict(prompt_len=256, gen=5, batch=2, seed=0)
# qwen3-14b's chunked GQA route against the unchunked one (bf16 logits)
I4_CHUNK = dict(prompt_len=1024, chunk=512, atol=2e-2)
REMAT_POLICIES = (None, "full", "dots")


def _n_leaves(arch, layers):
    """Leaves of `arch`'s tree at `layers` layers (its smoke variant has the
    same tree)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch, "smoke").replace(n_layers=layers)
    return len(tree_leaves(init_params(0, cfg, device="cpu")))


def _loss_and_grads(params, cfg, batch):
    """One train_loss and its backward on one node: (loss, grads)."""
    import torch
    from repro_torch.models import train_loss
    from repro_torch.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    loss = train_loss(tree_unflatten(treedef, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def path_i1(dev, variant="full", layers=I1_LAYERS, batch=4, seq=128, remat_batch=8,
            remat_seq=2048):
    """deepseek-v2-lite-16b through the trainer CLI (PaME, sparse exchange,
    4 nodes, 3 steps): the f32 gossip kernel once a leaf a step, finite
    losses, peak under 80 GB.  Then one node's train_loss and backward on
    remat_batch x remat_seq tokens (where activations, not the weights and
    gradients, set the peak) without remat and with the "full" and "dots"
    policies: the three losses equal (the MoE layer and every other op on
    the path sum in a fixed order), whether the gradients are equal too,
    each run's peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.launch import train
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves, tree_map

    leaves = _n_leaves(I_LM, layers)
    t0 = _start(dev)
    out = train.main(["--arch", I_LM, "--variant", variant, "--algo", "pame", "--nodes", str(M),
                      "--batch", str(batch), "--seq", str(seq), "--layers", str(layers),
                      "--steps", str(I_STEPS), "--chunk", "1", "--device", dev.type])
    _sync(dev)
    row = {"phase": "path_i1", "arch": I_LM, "layers": layers, "steps": out["steps"],
           "loss": out["loss"], "s_per_step": out["seconds"], "seconds": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
           "leaves": leaves, "gossip_variant_launches": dict(gossip_gather.variant_launches)}
    emit(**row)
    if dev.type == "cuda" and row["gossip_variant_launches"] != {"f32": leaves * I_STEPS,
                                                                 "bf16": 0}:
        fail(f"path I1: expected {leaves} f32 gossip launches a step (one a leaf)")
    if not all(math.isfinite(x) for x in out["loss"]):
        fail("path I1: a loss is not finite")
    if dev.type == "cuda" and row["peak_bytes"] >= PEAK_LIMIT:
        fail(f"path I1: peak {row['peak_bytes']} B over {PEAK_LIMIT}")
    launches = row["gossip_variant_launches"]["f32"]
    free()

    cfg = get_config(I_LM, variant).replace(n_layers=layers)
    params = init_params(0, cfg, device=dev)
    b = tree_map(lambda x: x[0], lm_batch_fn(cfg, 1, remat_batch, remat_seq, 0, dev)(0))
    remat, base = {}, None
    for policy in REMAT_POLICIES:
        c = cfg.replace(remat=policy is not None, remat_policy=policy or "full")
        t0 = _start(dev)
        loss, grads = _loss_and_grads(params, c, b)
        _sync(dev)
        r = {"loss": loss.item(), "seconds": time.perf_counter() - t0,
             "peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
             "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads),
             "tokens": [remat_batch, remat_seq]}
        if base is None:  # the reference gradients wait on the host
            base = [g.cpu() for g in grads]
        else:
            r["grads_equal"] = all(torch.equal(g.cpu(), w) for g, w in zip(grads, base))
        remat[policy or "none"] = r
        emit(phase="path_i1_remat", policy=policy or "none", **r)
        del grads
    del base, params
    free()
    if len({r["loss"] for r in remat.values()}) != 1 or not all(
            r["grads_finite"] and math.isfinite(r["loss"]) for r in remat.values()):
        fail(f"path I1: remat changed the loss or a gradient is not finite ({remat})")
    row["remat"] = remat
    return row, launches


def _serve(dev, cfg, serve, name):
    """One node model of `cfg` from seed 0 through `ServeLoop.serve_node`:
    its prefill ms, decode ms a token, tokens/s and peak; the tokens must be
    [batch, gen] from finite logits."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.serve import ServeLoop
    from repro_torch.tree import tree_leaves

    t0 = _start(dev)
    params = init_params(0, cfg, device=dev)
    loop = ServeLoop(cfg, device=dev, **serve)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    _reset_counts()
    st = loop.serve_node(params)
    row = {"run": name, "arch": cfg.name, "layers": cfg.n_layers, "setup_s": setup_s,
           "params": sum(x.numel() for x in tree_leaves(params)),
           "prefill_ms": st["prefill_ms"], "decode_ms_per_token": st["decode_ms"] / (serve["gen"] - 1),
           "tokens_per_s": st["tokens_per_s"], "token_shape": list(st["tokens"].shape),
           "logits_finite": st["logits_finite"], "offset": loop.offset,
           "peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None}
    del params
    free()
    if not st["logits_finite"] or row["token_shape"] != [serve["batch"], serve["gen"]]:
        emit(phase="path_i", **row)
        fail(f"path {name}: expected [{serve['batch']}, {serve['gen']}] tokens from finite logits")
    return row


def path_i2(dev, cfg=None, serve=None):
    """deepseek-v2-lite-16b served at full width and depth (27 layers, one
    node model): MLA's chunked prefill (chunks of 512), the MLA cache and
    the absorbed decode through 26 MoE layers."""
    from repro_torch.configs import get_config

    cfg = cfg or get_config(I_LM, "full").replace(prefill_chunk=I2_CHUNK)
    row = _serve(dev, cfg, serve or I_SERVE, "I2")
    row["prefill_chunk"] = cfg.prefill_chunk
    emit(phase="path_i", **row)
    return row


def path_i3(dev, cfg=None, serve=None):
    """qwen3-14b served at full width and depth (40 layers, one node model)
    with use_flash: the flash kernel's tensor-core variant once a layer a
    prefill (D = 128, 40 heads on 8 KV heads)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    cfg = cfg or get_config("qwen3-14b", "full").replace(use_flash=True)
    row = _serve(dev, cfg, serve or I_SERVE, "I3")
    row["flash_variant_launches"] = dict(flash_attention_cuda.variant_launches)
    emit(phase="path_i", **row)
    if dev.type == "cuda" and row["flash_variant_launches"]["tensor_cores"] != cfg.n_layers:
        fail(f"path I3: expected {cfg.n_layers} flash launches of the tensor-core variant")
    return row, row["flash_variant_launches"]["tensor_cores"]


def path_i4(dev, variant="full", layers=I4_LAYERS, serve=None, chunk=None, archs=I4_ARCHS):
    """Each other new config at full width, cut to `layers` layers, on one
    node: one train_loss and backward (finite loss and gradients), and a
    prefill with decoded tokens through `ServeLoop` (finite logits; the
    vlm's patch embeddings come before the prompt).  Then qwen3-14b's
    chunked GQA prefill against its unchunked one, bf16 logits within
    atol."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.serve import ServeLoop

    serve, chunk = serve or I4_SERVE, chunk or I4_CHUNK
    rows = {}
    for arch in archs:
        cfg = get_config(arch, variant).replace(n_layers=layers)
        t0 = _start(dev)
        params = init_params(0, cfg, device=dev)
        batch = ServeLoop(cfg, device=dev, **serve).make_batch()
        loss, grads = _loss_and_grads(params, cfg, batch)
        _sync(dev)
        row = {"run": "I4", "arch": arch, "layers": layers, "loss": loss.item(),
               "train_seconds": time.perf_counter() - t0,
               "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads),
               "train_peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
               "batch_shapes": {k: list(v.shape) for k, v in batch.items()}}
        del grads, params
        row.update(_serve(dev, cfg, serve, f"I4 {arch}"))
        rows[arch] = row
        emit(phase="path_i", **row)
        if not (math.isfinite(row["loss"]) and row["grads_finite"]):
            fail(f"path I4 ({arch}): the loss or a gradient is not finite")

    cfg = get_config("qwen3-14b", variant).replace(n_layers=layers)
    t0 = _start(dev)
    params = init_params(0, cfg, device=dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (serve["batch"], chunk["prompt_len"])), device=dev)
    with torch.inference_mode():
        got = prefill(params, cfg.replace(prefill_chunk=chunk["chunk"]), {"tokens": toks},
                      chunk["prompt_len"])[0]
        want = prefill(params, cfg, {"tokens": toks}, chunk["prompt_len"])[0]
    row = {"run": "I4 qwen3-14b chunked prefill", "layers": layers,
           "prompt": [serve["batch"], chunk["prompt_len"]], "chunk": chunk["chunk"],
           "max_abs_err": (got - want).abs().max().item(), "atol": chunk["atol"],
           "logit_scale": want.abs().max().item(), "finite": bool(torch.isfinite(got).all()),
           "argmax_agree": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
           "seconds": time.perf_counter() - t0}
    emit(phase="path_i", **row)
    del params, got, want
    free()
    if not row["finite"] or row["max_abs_err"] > chunk["atol"]:
        fail("path I4: qwen3-14b's chunked prefill is not within atol of the unchunked route")
    rows["qwen3-14b chunked"] = row
    return rows


def path_i5(dev, steps=200):
    """sgd, momentum and adam (`repro_torch.optim`) on a quadratic over a
    tree on the card (an f32 and a bf16 leaf), as the JAX package's
    optimizer test runs them: the objective must fall below 1e-3 of where
    it started."""
    import torch
    from repro_torch.optim import adam, apply_updates, momentum, sgd
    from repro_torch.tree import tree_flatten, tree_unflatten

    g = torch.Generator(device=dev).manual_seed(0)
    target = {"w": torch.randn(8, generator=g, device=dev),
              "b": torch.randn(4096, generator=g, device=dev).to(torch.bfloat16)}
    rows = {}
    for name, opt in (("sgd", sgd(0.1)), ("momentum", momentum(0.05)), ("adam", adam(0.1))):
        params = {"w": torch.zeros(8, device=dev),
                  "b": torch.zeros(4096, dtype=torch.bfloat16, device=dev)}
        state = opt.init(params)

        def objective(p):
            return sum(torch.sum((p[k].float() - target[k].float()) ** 2) for k in p)

        first = objective(params).item()
        t0 = time.perf_counter()
        for _ in range(steps):
            leaves, td = tree_flatten(params)
            leaves = [x.detach().requires_grad_(True) for x in leaves]
            grads = tree_unflatten(td, list(torch.autograd.grad(
                objective(tree_unflatten(td, leaves)), leaves)))
            updates, state = opt.update(grads, state, params)
            params = apply_updates(params, updates)
        _sync(dev)
        rows[name] = {"first": first, "last": objective(params).item(), "steps": steps,
                      "seconds": time.perf_counter() - t0,
                      "devices": sorted({str(x.device) for x in tree_flatten(params)[0]})}
        emit(phase="path_i5", optimizer=name, **rows[name])
        if not rows[name]["last"] < 1e-3 * first:
            fail(f"path I5: {name} did not bring the objective below 1e-3 of its start")
    return rows


def path_i(dev):
    """I1-I5; the f32 gossip launches of I1 and the flash launches of I3."""
    rows = {}
    t = time.perf_counter()
    rows["I1"], gossip_launches = path_i1(dev)
    emit(phase="path_i1_done", seconds=time.perf_counter() - t)
    for name, fn in (("I2", path_i2), ("I3", path_i3), ("I4", path_i4), ("I5", path_i5)):
        t = time.perf_counter()
        rows[name] = fn(dev)
        emit(phase=f"path_{name.lower()}_done", seconds=time.perf_counter() - t)
    rows["I3"], flash_launches = rows["I3"]
    return rows, gossip_launches, flash_launches


# ---------------------------------------------------------------------------
# path R: same seed, same bits (the repeat phase and the resume on the card)
# ---------------------------------------------------------------------------
# the repeat phase's steps: F3's and F4's PaME runs, H2dyn at 5 lanes
R_STEPS = dict(cnn=40, resnet=10, dynamic=10)
# the resume: the trainer at full width and 2 layers, 6 steps, a
# checkpoint at step 3
RESUME_ARGS = model_args("pame") + ["--layers", "2", "--chunk", "1"]
RESUME_STEPS, RESUME_AT = 6, 3


def _host_leaves(tree):
    import torch
    from repro_torch.tree import tree_leaves

    return [x.detach().cpu() for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _equal_leaves(want_host, tree) -> bool:
    """Every tensor leaf of `tree` equal to the host copies `want_host`."""
    import torch
    from repro_torch.tree import tree_leaves

    got = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    return len(got) == len(want_host) and all(
        torch.equal(g.detach().cpu(), w) for g, w in zip(got, want_host))


def path_repeat(dev, data, steps=None, i1_variant="full", i1_layers=I1_LAYERS):
    """Same seed, same bits, through the normal entry points with no switch
    set by this script: F3's PaME run (`run_pame`, the CNN's convolutions,
    the PME-average kernel), F4's (ResNet-20), I1 (the trainer CLI on
    deepseek-v2-lite-16b at 3 layers: MLA, MoE and the embedding's
    backward, the gossip kernel) and H2dyn at 5 lanes (`bind_batched`
    under H_SCENARIO, the folded exchange), each run twice from one seed:
    the final parameters equal leaf for leaf (`torch.equal`).  Each run's
    seconds a step; the launches of both runs of each (for the kernel
    line).  `data`: the futures of F3's and F4's image sets."""
    import torch
    from repro_torch.core import PaMEConfig, build_topology, run_pame
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.scenarios import Scenario
    from repro_torch.data import dirichlet_partition, label_skew_partition
    from repro_torch.launch import train
    from repro_torch.models.cnn import cnn_apply, cnn_init, resnet20_apply, resnet20_init

    steps = steps or R_STEPS
    topo = build_topology("complete", M)
    cfg = PaMEConfig(**EX3_CFG)

    def vision(key, partition, apply_fn):
        # a fresh task each run: its NodeBatcher starts from the same seed
        return vision_task(dev, data[key].result(), partition, apply_fn)

    def f3():
        task = vision("F3", lambda y: label_skew_partition(y, M, 7, seed=0), cnn_apply)
        return run_pame(0, cnn_init(1, device=dev), M, task["grad_fn"], task["batch_fn"],
                        topo, cfg, num_steps=steps["cnn"], tol_std=0.0, device=dev)[0].params

    def f4():
        task = vision("F4", lambda y: dirichlet_partition(y, M, 0.3, seed=0), resnet20_apply)
        return run_pame(0, resnet20_init(1, device=dev), M, task["grad_fn"],
                        task["batch_fn"], topo, cfg, num_steps=steps["resnet"], tol_std=0.0,
                        device=dev)[0].params

    def i1():
        return train.main(["--arch", I_LM, "--variant", i1_variant, "--algo", "pame",
                           "--nodes", str(M), "--batch", "4", "--seq", "128", "--layers",
                           str(i1_layers), "--steps", str(I_STEPS), "--chunk", "1",
                           "--device", dev.type], return_state=True)["state"].params

    def h2dyn():
        task = vision("F3", lambda y: label_skew_partition(y, M, 7, seed=0), cnn_apply)
        ba = ALG.get_algorithm("pame").bind_batched(
            task["grad_fn"], topo, [ALG.PaMEHp(**EX3_CFG)], seeds=range(H_SEEDS),
            mixing="sparse", scenario=Scenario(**H_SCENARIO), device=dev)
        return ba.params_of(ba.run(cnn_init(1, device=dev), M, task["batch_fn"],
                                   steps["dynamic"], chunk_size=steps["dynamic"])[0])

    rows, launches = {}, {"f32": 0, "bf16": 0, "pme_average": 0}
    for name, run, k in (("F3-pame", f3, steps["cnn"]), ("F4-pame", f4, steps["resnet"]),
                         ("I1", i1, I_STEPS), (f"H2dyn-L{H_SEEDS}", h2dyn, steps["dynamic"])):
        t0 = _start(dev)
        first = _host_leaves(run())  # on the host: I1's state is 11.7 GB
        _sync(dev)
        t1 = time.perf_counter()
        free()
        second = run()
        _sync(dev)
        t2 = time.perf_counter()
        got = _counts()
        for key in launches:
            launches[key] += got[key]
        rows[name] = row = {"run": name, "steps": k, "equal": _equal_leaves(first, second),
                            "leaves": len(first), "s_per_run": [t1 - t0, t2 - t1],
                            "launches": got,
                            "switches": [bool(torch.backends.cudnn.deterministic),
                                         bool(torch.are_deterministic_algorithms_enabled())]}
        emit(phase="path_repeat", **row)
        del first, second
        free()
        if not row["equal"]:
            fail(f"path R ({name}): two runs from one seed differ")
        if any(row["switches"]):
            fail(f"path R ({name}): a determinism switch is left on after the run")
    return rows, launches


def path_resume(dev, argv=RESUME_ARGS, steps=RESUME_STEPS, at=RESUME_AT):
    """The trainer CLI (`argv`: path A's model at full width and 2 layers)
    run for `steps` steps uninterrupted, and run to step `at` with a
    checkpoint there and again to `steps` resuming from it: the resumed
    run's final state equals the uninterrupted one's, tensor for tensor.
    The save's and restore's seconds and bytes; the launches (for the
    kernel line)."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    t0 = _start(dev)
    try:
        whole = train.main(argv + ["--steps", str(steps), "--device", dev.type],
                           return_state=True)
        want = _host_leaves(whole["state"])
        del whole
        free()
        first = train.main(argv + ["--steps", str(at), "--ckpt-dir", root, "--ckpt-every",
                                   str(at), "--device", dev.type])
        # a period past the run: the resumed run saves nothing more
        second = train.main(argv + ["--steps", str(steps), "--ckpt-dir", root,
                                    "--ckpt-every", str(10 * steps), "--device", dev.type],
                            return_state=True)
        _sync(dev)
        row = {"phase": "path_resume", "steps": steps, "at": at, "start": second["start"],
               "equal": _equal_leaves(want, second["state"]), "tensors": len(want),
               "save": first["checkpoints"], "restore": second["restore"],
               "seconds": time.perf_counter() - t0, "launches": _counts()}
        del second
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(**row)
    free()
    if row["start"] != at or not row["equal"]:
        fail(f"path R (resume): the run resumed at {row['start']} (expected {at}) or its "
             "state differs from the uninterrupted run's")
    return row


# ---------------------------------------------------------------------------
# the dynamic network of paths K and N: a realization, a stale self view and
# delivery masks on path A's graph
# ---------------------------------------------------------------------------
# path A's graph (Erdos-Renyi p = 0.5, seed 0: edges 0-1, 0-2, 0-3, 2-3):
# node 1 offline, the edge 2-3 down, nodes 2 and 3 late by one step (read at
# the ring's snapshot of the step before; they take part through their stale
# rows, as the temporal scenario's delayed stragglers do), and node 3's
# message from node 0 lost (receiver, sender), so node 3 fills from its
# fresh row alone
NET_OFFLINE, NET_LATE, NET_EDGE_DOWN, NET_LOST = 1, (2, 3), (2, 3), (3, 0)
NET_STALENESS = 2  # the ring's depth
# (name, PaMEConfig fields, the inputs the step takes: "r" the realization,
# "d" the delivery masks, "s" the self view); the PaMEConfig defaults
# otherwise (exact masks), as path K's exchanges
NET_CASES = (("dense-real", {}, "r"), ("sparse-net", {"mixing": "sparse"}, "rds"),
             ("dense-self", {}, "rs"))
# the CPU rehearsals' tokens a node (batch, sequence): the smoke model's
# vocabulary makes path A's 4 x 128 cost seconds a step on one thread
NET_SMOKE_TOKENS = (1, 16)
# 0x9E3779B97F4A7C15 as a signed int64: `row_digests`' position hash
DIGEST_K = -0x61C8864680B583EB


def net_inputs(topo):
    """The network's realization (`scenarios.realization_from_masks` with
    node NET_OFFLINE offline and the edge NET_EDGE_DOWN down; the late
    nodes are delayed, not excluded) and the delivery masks ([m, d], node
    NET_LOST[0]'s slot of NET_LOST[1] lost), CPU tensors."""
    import torch
    from repro_torch.core import scenarios

    arrays = scenarios.make_scenario_arrays(topo, scenarios.Scenario())
    nbrs = arrays.nbrs.tolist()
    edge_up = torch.ones(arrays.nbrs.shape, dtype=torch.bool)
    a, b = NET_EDGE_DOWN
    edge_up[a, nbrs[a].index(b)] = edge_up[b, nbrs[b].index(a)] = False
    alive = torch.ones(M, dtype=torch.bool)
    alive[NET_OFFLINE] = False
    real = scenarios.realization_from_masks(arrays, edge_up, alive,
                                            torch.zeros(M, dtype=torch.bool))
    delivered = torch.ones(arrays.nbrs.shape, dtype=torch.bool)
    recv, send = NET_LOST
    delivered[recv, nbrs[recv].index(send)] = False
    return real, delivered


def net_leaf(prev, g, rows=slice(None)):
    """One leaf's fresh and delayed stacks from its stack of the step before,
    `prev` [M, ...]: fresh = prev + 0.01 N(0, 1) from `g`; delayed = fresh
    with the late nodes' rows read from the snapshot ring
    (`temporal.ring_init` holds step 0's parameters, step 1 reads its late
    nodes one step back, then `ring_push` writes the fresh stack into slot
    1).  Nodes `rows` of each, contiguous."""
    import torch
    from repro_torch.core import temporal

    fresh = (prev + 0.01 * torch.randn(prev.shape, generator=g, device=prev.device)) \
        .to(prev.dtype)
    ring = temporal.ring_init(prev, NET_STALENESS)
    late = list(NET_LATE)
    delayed = fresh.clone()
    delayed[late] = ring[(1 - 1) % NET_STALENESS][late]
    temporal.ring_push(ring, fresh, 1, NET_STALENESS)
    if not torch.equal(ring[1], fresh):
        fail("the snapshot ring's slot 1 is not the pushed stack")
    del ring
    return fresh[rows].contiguous(), delayed[rows].contiguous()


def net_task(dev, variant="full", layers=None, rows=slice(None)):
    """Path A's model (bf16 at full size; `layers` deep), its graph, grad_fn
    and batch (path A's 4 x 128 tokens a node; NET_SMOKE_TOKENS for the
    smoke variant), and the network's stacks of nodes `rows` (`net_leaf`):
    the step before is path K's stack (node rows 0.01 apart, seed 5), the
    fresh noise from seed 6, drawn whole leaf by leaf, so that every
    process gets the same values.  Returns (topo, grad_fn, batch, fresh,
    delayed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_lm_task
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg = get_config("stablelm-1.6b", variant)
    cfg = cfg.replace(n_layers=layers) if layers else cfg
    batch, seq = NET_SMOKE_TOKENS if variant == "smoke" else (4, 128)
    topo, params0, grad_fn, make_batch = make_lm_task(cfg, M, batch, seq, 0, "erdos_renyi",
                                                      dev)
    g_prev = torch.Generator(device=dev).manual_seed(5)
    g_fresh = torch.Generator(device=dev).manual_seed(6)
    leaves, treedef = tree_flatten(params0)
    del params0
    fresh, delayed = [], []
    for i, x in enumerate(leaves):
        prev = (x.unsqueeze(0) + 0.01 * torch.randn((M,) + tuple(x.shape), generator=g_prev,
                                                    device=dev)).to(x.dtype)
        leaves[i] = None
        f, d = net_leaf(prev, g_fresh, rows)
        fresh.append(f)
        delayed.append(d)
        del prev, x, f, d
    free()
    return (topo, grad_fn, make_batch(0), tree_unflatten(treedef, fresh),
            tree_unflatten(treedef, delayed))


def row_digests(tree):
    """Each leaf's rows' 64-bit digests, [[int] a row] in JAX leaf order: the
    wrapping sum over a row's elements of their bits times a hash of their
    position (CHUNK elements at a time).  Equal rows give equal digests; two
    different rows share one by a 2^-64 coincidence, so digests stand in for
    `torch.equal` between processes that cannot hold each other's states."""
    import torch
    from repro_torch.tree import tree_leaves

    out = []
    for x in tree_leaves(tree):
        ity = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        rows = []
        for row in x.reshape(x.shape[0], -1):
            acc = torch.zeros((), dtype=torch.int64, device=x.device)
            for i in range(0, row.numel(), CHUNK):
                v = row[i:i + CHUNK].view(ity).to(torch.int64)
                pos = torch.arange(i + 1, i + 1 + v.numel(), dtype=torch.int64,
                                   device=x.device).mul_(DIGEST_K)
                acc += (v * pos).sum()
                del v, pos
            rows.append(int(acc))
        out.append(rows)
    return out


def inputs_digest(*tensors):
    """A kernel row's inputs as one digest (16 hex digits of the SHA-256 of
    their `row_digests`): two runs that print the same one drew the same
    inputs bit for bit.  tools/pme_ab.py prints it beside its rows too."""
    import hashlib

    return hashlib.sha256(json.dumps(row_digests(list(tensors))).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# path K: the sharded PaME step over a (1, 1, 1) mesh of one NCCL rank
# ---------------------------------------------------------------------------
# the exchanges of path K: (name, PaMEConfig fields, kernel launches a step
# of the unsharded and of the sharded step)
K_EXCHANGES = (
    ("dense", {}, {"pme_average": 10, "gossip_f32": 0}),
    ("sparse", {"mixing": "sparse"}, {"pme_average": 0, "gossip_f32": 11}),
    ("compressed", {"exchange": "compressed"}, {"pme_average": 0, "gossip_f32": 0}),
    ("compressed_q8", {"exchange": "compressed_q8"}, {"pme_average": 0, "gossip_f32": 0}),
)
K_SCRIPT = "import sys, chip_smoke; chip_smoke.path_k_rank(*sys.argv[1:])"


def path_k_rank(device_type="cuda", variant="full"):
    """Path K's process: an NCCL process group of one rank (gloo on the
    CPU), a (1, 1, 1) (node, fsdp, model) mesh (`make_logical_mesh`), path
    A's model (stablelm-1.6b at full width and depth, 4 nodes, 4 x 128
    tokens a node, node rows 0.01 apart); for each exchange one unsharded
    `pame_step` and one sharded (`param_shardings=`, the tensor-parallel
    route: `lm_grad_fn` takes a view), and for the dense and sparse
    exchanges one sharded with a grad_fn that takes none (the gather-whole
    route), from the same state, key and batch: the new state and loss_mean
    equal (`torch.equal`).  Prints one K_RESULT line."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.core import pame
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type)
    card = dev.type == "cuda"
    if not card:
        # the CPU's multithreaded embedding backward sums in no fixed order
        torch.set_num_threads(1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if card else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                            **({"device_id": torch.device("cuda", 0)} if card else {}))
    layout = {"node": 1, "fsdp": 1, "model": 1}
    mesh = make_logical_mesh(device_type=device_type, layout=layout)
    coord = shd.mesh_coords(mesh)
    topo, params0, grad_fn, make_batch = _task(dev, variant=variant)
    whole_fn = lambda p, b, k: grad_fn(p, b, k)  # noqa: E731 (takes no view)
    g = torch.Generator(device=dev).manual_seed(5)
    leaves, treedef = tree_flatten(params0)
    stacked = tree_unflatten(treedef, [
        (x.unsqueeze(0) + 0.01 * torch.randn((M,) + tuple(x.shape), generator=g, device=dev))
        .to(x.dtype) for x in leaves])
    del params0, leaves
    batch = make_batch(0)
    rows = {}
    try:
        for name, fields, want in K_EXCHANGES:
            cfg = pame.PaMEConfig(**fields)
            ta = pame.make_topology_arrays(topo, cfg, seed=0, device=dev)
            state = pame.pame_init(1, stacked, M, cfg)
            out, equal = {}, {}
            routes = (("unsharded", grad_fn), ("sharded", grad_fn))
            if name in ("dense", "sparse"):
                routes += (("gather_whole", whole_fn),)
            for how, fn in routes:
                sharded = None
                st, b = state, batch
                if how != "unsharded":
                    place = shd.state_shardings(state, layout)
                    sharded = shd.MeshShardings(mesh, place.params)
                    st = shd.shard_tree(state, place, layout, coord)
                    b = pame.shard_batch(batch, sharded, fn)
                _reset_counts()
                shd.reset_collective_counts()
                free()
                if card:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                new, metrics = pame.pame_step(st, b, fn, ta, cfg, param_shardings=sharded)
                _sync(dev)
                out[how] = {"loss": metrics["loss_mean"], "s": time.perf_counter() - t0,
                            "peak_bytes": torch.cuda.max_memory_allocated() if card else 0,
                            "launches": _k_launches(), "collectives": shd.collective_counts()}
                del metrics, st, b
                if how == "unsharded":  # kept to hold each sharded route's state against
                    ref = new
                else:  # one route's new state beside the reference at a time
                    equal[how] = all(torch.equal(x, y) for x, y in zip(
                        tree_leaves(ref.params), tree_leaves(new.params))) \
                        and torch.equal(ref.sigma, new.sigma) \
                        and torch.equal(out["unsharded"]["loss"], out[how]["loss"])
                    del new
            u, s = out["unsharded"], out["sharded"]
            rows[name] = {"exchange": name, "bit_equal": bool(equal["sharded"]),
                          "loss": float(s["loss"]), "finite": bool(torch.isfinite(s["loss"])),
                          "s_step_sharded": s["s"], "s_step_unsharded": u["s"],
                          "peak_bytes_sharded": s["peak_bytes"],
                          "peak_bytes_unsharded": u["peak_bytes"],
                          "launches_sharded": s["launches"], "launches_unsharded": u["launches"],
                          "want_launches": want, "collectives": s["collectives"]}
            if "gather_whole" in out:
                gw = out["gather_whole"]
                rows[name].update(gather_whole_bit_equal=bool(equal["gather_whole"]),
                                  s_step_gather_whole=gw["s"],
                                  peak_bytes_gather_whole=gw["peak_bytes"],
                                  launches_gather_whole=gw["launches"],
                                  collectives_gather_whole=gw["collectives"])
            del out, u, s, state, ref
            free()
        del stacked
        free()
        rows.update(_k_network(dev, variant, mesh, layout, coord, grad_fn, whole_fn))
    finally:
        dist.destroy_process_group()
    print("K_RESULT " + json.dumps(rows), flush=True)


def _k_launches():
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda

    return {"pme_average": pme_average_cuda.launches,
            "pme_average_range": pme_average_cuda.range_launches,
            "gossip_f32": gossip_gather.variant_launches["f32"],
            "gossip_bf16": gossip_gather.variant_launches["bf16"]}


def _k_network(dev, variant, mesh, layout, coord, grad_fn, whole_fn):
    """Path K's network cases (NET_CASES) on its one rank: for each, the
    unsharded step (its new state kept in pinned host memory), then the
    tensor-parallel and the gather-whole routes from the same state, key,
    batch, realization, delivery masks and self view, each held leaf by
    leaf with `torch.equal` (state, sigma, loss_mean and wire_bits)."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.core import pame
    from repro_torch.tree import tree_leaves

    card = dev.type == "cuda"
    topo, _, batch, fresh, delayed = net_task(dev, variant)
    real, delivered = net_inputs(topo)
    # the unsharded step's new state waits in pinned host memory (one
    # buffer a leaf, every case's state has the same shapes) while each
    # route's runs on the card: 11.5 GB each at full depth
    ref = [torch.empty(x.shape, dtype=x.dtype, pin_memory=card) for x in tree_leaves(fresh)]
    rows = {}
    for name, fields, net in NET_CASES:
        cfg = pame.PaMEConfig(**fields)
        ta = pame.make_topology_arrays(topo, cfg, seed=0, device=dev)
        state = pame.pame_init(1, delayed if "s" in net else fresh, M, cfg)
        kw = dict(realization=real, self_params=fresh if "s" in net else None,
                  delivered=delivered if "d" in net else None)
        out, equal = {}, {}
        for how, fn in (("unsharded", grad_fn), ("sharded", grad_fn),
                        ("gather_whole", whole_fn)):
            sharded, st, b, self_view = None, state, batch, kw["self_params"]
            if how != "unsharded":
                place = shd.state_shardings(state, layout)
                sharded = shd.MeshShardings(mesh, place.params)
                st = shd.shard_tree(state, place, layout, coord)
                b = pame.shard_batch(batch, sharded, fn)
                if self_view is not None:
                    self_view = shd.shard_tree(self_view, place.params, layout, coord)
            _reset_counts()
            shd.reset_collective_counts()
            free()
            if card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            new, met = pame.pame_step(st, b, fn, ta, cfg, param_shardings=sharded,
                                      **dict(kw, self_params=self_view))
            _sync(dev)
            out[how] = {"loss": met["loss_mean"], "wire_bits": met["wire_bits"],
                        "comm_nodes": int(met["comm_nodes"]), "s": time.perf_counter() - t0,
                        "peak_bytes": torch.cuda.max_memory_allocated() if card else 0,
                        "launches": _k_launches()}
            del met, st, b
            if how == "unsharded":
                for r, x in zip(ref, tree_leaves(new.params)):
                    r.copy_(x)
                ref_sigma = new.sigma.cpu()
            else:  # leaf by leaf back on the card
                equal[how] = (all(torch.equal(x, y.to(dev, non_blocking=True))
                                  for x, y in zip(tree_leaves(new.params), ref))
                              and torch.equal(new.sigma.cpu(), ref_sigma)
                              and all(torch.equal(out["unsharded"][k], out[how][k])
                                      for k in ("loss", "wire_bits")))
            del new
            free()
        u, sh, gw = out["unsharded"], out["sharded"], out["gather_whole"]
        rows[f"net-{name}"] = {
            "exchange": name, "inputs": net, "bit_equal": bool(equal["sharded"]),
            "gather_whole_bit_equal": bool(equal["gather_whole"]),
            "loss": float(sh["loss"]), "finite": bool(torch.isfinite(sh["loss"])),
            "wire_bits": float(sh["wire_bits"]), "comm_nodes": sh["comm_nodes"],
            "s_step_sharded": sh["s"], "s_step_unsharded": u["s"],
            "s_step_gather_whole": gw["s"], "peak_bytes_sharded": sh["peak_bytes"],
            "peak_bytes_unsharded": u["peak_bytes"], "peak_bytes_gather_whole": gw["peak_bytes"],
            "launches_sharded": sh["launches"], "launches_unsharded": u["launches"],
            "launches_gather_whole": gw["launches"],
            "want_launches": {"pme_average": 10 if name == "dense-real" else 0,
                              "gossip_f32": 11 if name == "sparse-net" else 0},
            "collectives": shd.collective_counts()}
        del out, state
        free()
    del fresh, delayed, ref
    free()
    return rows


def path_k(dev, variant="full"):
    """Path K on the card: `path_k_rank` in a process of its own.  Each
    exchange's sharded step (tensor-parallel) must equal the unsharded one
    bit for bit, and so must the dense and sparse exchanges' gather-whole
    route; each launches what it does: the PME average 10 times a step
    (dense, every sharded launch with its receiver range r0 = 0, r = m),
    the f32 gossip kernel 11 times (sparse), neither kernel for the
    compressed exchanges (on the CPU, no kernel at all).  One card cannot
    show a collective between ranks (NCCL takes one rank a device); the
    wrapper's counts of this rank's calls are recorded."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", K_SCRIPT, dev.type, variant],
                         capture_output=True, text=True, env=_env(), cwd=HERE, timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("K_RESULT ")]
    if res.returncode != 0 or not lines:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
        fail(f"path K: the sharded step's process exited {res.returncode}")
    rows = json.loads(lines[0][len("K_RESULT "):])
    sharded_routes = {name: ["sharded"] + (["gather_whole"] if name in ("dense", "sparse")
                                           else []) for name, _, _ in K_EXCHANGES}
    sharded_routes.update({f"net-{name}": ["sharded", "gather_whole"]
                           for name, _, _ in NET_CASES})
    cases = [(name, want) for name, _, want in K_EXCHANGES] + [
        (f"net-{name}", rows[f"net-{name}"]["want_launches"]) for name, _, _ in NET_CASES]
    for name, want in cases:
        if dev.type != "cuda":
            want = dict.fromkeys(want, 0)
        row = rows[name]
        if name.startswith("net-"):
            # the realized wire bits: 3 messages sent (node 3's lost one
            # charged too), the 3 participants communicating
            if not (row["wire_bits"] > 0 and row["comm_nodes"] == M - 1):
                fail(f"path K ({name}): wire_bits {row['wire_bits']}, comm_nodes "
                     f"{row['comm_nodes']}")
        emit(phase="path_k", arch="stablelm-1.6b", nodes=M, layout=[1, 1, 1], **row)
        su = row["launches_unsharded"]
        ok_launches = (su["pme_average"] == want["pme_average"] and su["pme_average_range"] == 0
                       and su["gossip_f32"] == want["gossip_f32"] and su["gossip_bf16"] == 0)
        for how in sharded_routes[name]:
            sh = row[f"launches_{how}"]
            ok_launches &= (sh["pme_average"] == sh["pme_average_range"] == want["pme_average"]
                            and sh["gossip_f32"] == want["gossip_f32"] and sh["gossip_bf16"] == 0)
        equal = row["bit_equal"] and row.get("gather_whole_bit_equal", True)
        if not (equal and row["finite"] and ok_launches):
            fail(f"path K ({name}): a sharded route is not the unsharded step bit for bit, "
                 f"or launched other kernels than {want}")
        if max(row["peak_bytes_sharded"], row["peak_bytes_unsharded"],
               row.get("peak_bytes_gather_whole", 0)) >= PEAK_LIMIT:
            fail(f"path K ({name}): peak over {PEAK_LIMIT}")
    emit(phase="path_k_done", seconds=time.perf_counter() - t0)
    return {"pme_average": sum(r["launches_unsharded"]["pme_average"]
                               + sum(r[f"launches_{how}"]["pme_average"]
                                     for how in sharded_routes[n]) for n, r in rows.items()),
            "pme_average_range": sum(r[f"launches_{how}"]["pme_average_range"]
                                     for n, r in rows.items() for how in sharded_routes[n]),
            "f32": sum(r["launches_unsharded"]["gossip_f32"]
                       + sum(r[f"launches_{how}"]["gossip_f32"] for how in sharded_routes[n])
                       for n, r in rows.items())}


# ---------------------------------------------------------------------------
# path L: sharded serving over a (node, fsdp, model) mesh
# ---------------------------------------------------------------------------
L1_ARCHS = ("zamba2-1.2b", "stablelm-1.6b")
# L2: (arch, depth; None for the full depth)
L2_RUNS = (("zamba2-1.2b", None), ("qwen3-14b", 10))
# the phase-2 row timing each L2 arch's launches: (the parent's whole
# heads, a rank's half)
L2_ROWS = {"zamba2-1.2b": ("path-c", "path-l2-zamba2"), "qwen3-14b": ("path-i3", "path-l2-qwen3")}
# L2's prompts: path C's, 8 generated (through gloo, zamba2-1.2b regathers
# its fused in_proj each token: 1.5-1.8 s a token on an H100 80GB HBM3 at
# 700 W, PERF.md)
L2_SERVE = dict(SERVE, gen=8)
# L2's bound: the split run's logits (the prefill's, and the decode steps'
# fed the unsharded run's tokens) at most this many times as far from the
# unsharded bf16 logits as those are from the f32 logits, by the largest
# difference and by the relative L2 norm.  The row-parallel partial sums
# are rounded to bf16 before they are summed (XLA's partitioned dot does
# the same), and that adds about as much as bf16's own error: 0.99 and
# 1.13 (largest), 1.02 and 1.04 (norm) for the prefills of zamba2-1.2b
# and qwen3-14b on an H100 80GB HBM3 at 700 W (PERF.md); their decode
# steps 0.91-0.99.  Two more prefills place it: the partial sums taken and
# reduced in f32 (0.58-0.85, held at L2_F32_RATIO: no more error than
# bf16's own) and one wrong head (two heads' rows of one `attn/wo` swapped
# on rank 1: 10-24), which must exceed it
L2_ERROR_RATIO = 1.25
L2_F32_RATIO = 1.0
# the CPU rehearsal's prompts (tests/test_torch_sharded_serving.py)
L_SMOKE_SERVE = dict(prompt_len=16, gen=4, batch=4, seed=0)
# a rank of paths L, M and N: a function of this module on its arguments
RANK_SCRIPT = "import sys, chip_smoke; chip_smoke.{}(*sys.argv[1:])"


def _l_config(arch, variant, layers=None):
    """Path L's config: flash and SSD on, bf16 (the smoke configs are f32)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, variant).replace(use_flash=True, use_ssd_kernel=True,
                                            dtype="bfloat16")
    return cfg.replace(n_layers=layers) if layers else cfg


def _l_serve(variant, serve=SERVE):
    return serve if variant == "full" else L_SMOKE_SERVE


def _sites(cfg):
    """(flash launches, SSD launches) of one prefill of `cfg`."""
    from repro_torch.models.model import layer_groups

    count = lambda kinds: sum(g.repeat * sum(k in kinds for k in g.pattern)  # noqa: E731
                              for g in layer_groups(cfg))
    return count(("attn", "shared_block")), count(("mamba",))


def _serve_run(dev, cfg, params, loop, shardings=None, forced=None):
    """One prefill of `loop`'s next prompts (this rank's rows under
    `shardings`) and ``loop.gen - 1`` greedy decode steps
    (`serve.decode_greedy`; with `forced`, a [B, gen] token matrix, each
    step is fed its token instead of the last argmax): the prefill logits,
    each step's logits, the tokens (the argmaxes), the caches, prefill ms,
    decode ms a token and the kernels' launches in the prefill."""
    import torch
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.serving import decode_greedy

    batch = loop.make_batch()
    _reset_counts()
    logits = []
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        lg, caches = prefill(params, cfg, batch, loop.capacity, shardings=shardings)
        tok = torch.argmax(lg, -1).to(torch.int32)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: sum(v.values()) for k, v in _kernel_counts().items()}
        logits.append(lg)

        start = loop.prompt_len + loop.offset

        def dc(p, t, pos, c):
            if forced is not None:
                t = forced[:, pos - start]
            out, c = decode_step(p, cfg, t, pos, c, shardings=shardings)
            logits.append(out)
            return out, c

        t0 = time.perf_counter()
        tokens = decode_greedy(dc, params, tok, caches, loop.prompt_len, loop.gen, loop.offset)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return {"logits": logits, "tokens": tokens, "caches": caches, "prefill_ms": prefill_ms,
            "decode_ms_per_token": decode_s * 1e3 / (loop.gen - 1), "launches": launches}


def _pg(device_type, rank, world, port, timeout=None):
    """The default process group: NCCL on the card for one rank, gloo over
    CUDA tensors for two ranks sharing it (NCCL takes one rank a device),
    gloo on the CPU; `timeout` seconds for a collective (torch's default
    when None)."""
    import datetime

    import torch
    import torch.distributed as dist

    card = device_type == "cuda"
    backend = ("nccl" if world == 1 else "cuda:gloo,cpu:gloo") if card else "gloo"
    kw = {"device_id": torch.device("cuda", 0)} if card and world == 1 else {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, **kw)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def path_l1_rank(device_type="cuda", variant="full"):
    """Path L1's process: one rank, a (1, 1, 1) mesh; for each of L1_ARCHS
    the unsharded serving run, the sharded one on the rank's pieces
    (`shard_tree`, here whole copies) and the unsharded one again (its
    times; the first carries the process's warm-up).  Prints one
    L1_RESULT line."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.models import init_params
    from repro_torch.serve import ServeLoop
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device_type)
    if dev.type != "cuda":
        torch.set_num_threads(1)
    _pg(device_type, 0, 1, _free_port())
    layout = {"node": 1, "fsdp": 1, "model": 1}
    mesh = make_logical_mesh(device_type=device_type, layout=layout)
    rows = {}
    try:
        for arch in L1_ARCHS:
            cfg = _l_config(arch, variant)
            params = init_params(0, cfg, device=dev)
            sh = shd.serving_shardings(mesh, params)
            mine = shd.shard_tree(params, sh.params, layout, shd.mesh_coords(mesh))
            serve = _l_serve(variant)
            runs = {}
            for how, p, shardings in (("unsharded", params, None), ("sharded", mine, sh),
                                      ("unsharded_again", params, None)):
                shd.reset_collective_counts()
                runs[how] = _serve_run(dev, cfg, p, ServeLoop(cfg, device=dev, **serve),
                                       shardings)
                runs[how]["collectives"] = shd.collective_counts()
            u, s = runs["unsharded"], runs["sharded"]
            equal = (len(u["logits"]) == len(s["logits"])
                     and all(torch.equal(a, b) for a, b in zip(u["logits"], s["logits"]))
                     and torch.equal(u["tokens"], s["tokens"])
                     and all(torch.equal(a, b) for a, b in zip(tree_leaves(u["caches"]),
                                                               tree_leaves(s["caches"]))))
            finite = all(bool(torch.isfinite(x).all()) for x in s["logits"])
            rows[arch] = {
                "arch": arch, "layers": cfg.n_layers, "bit_equal": bool(equal),
                "finite": finite, "token_shape": list(s["tokens"].shape),
                "sites": _sites(cfg), "collectives": s["collectives"],
                **{f"{k}_{how}": runs[how][k] for how in runs
                   for k in ("prefill_ms", "decode_ms_per_token", "launches")}}
            del runs, u, s, params, mine
            free()
    finally:
        dist.destroy_process_group()
    print("L1_RESULT " + json.dumps(rows), flush=True)


@contextlib.contextmanager
def _f32_partials():
    """Inside: every row-parallel product (`layers.row_linear`, as the
    attention, MLP and Mamba blocks call it) takes its partial product in
    f32, all-reduces it in f32 and rounds the sum once (L2's diagnostic
    prefill; the program rounds each partial to the activations' type and
    sums in that type, as XLA's partitioned dot does)."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.models import attention, layers, mlp, ssm

    plain = layers.row_linear

    def f32_row_linear(x, w, sv, k, x_lo=0):
        if w.shape[0] == k:
            return plain(x, w, sv, k, x_lo)
        lo, hi = sv.span(w, 0, k)
        part = torch.matmul(x.narrow(-1, lo - x_lo, hi - lo).float(), w.float())
        return shd.all_reduce(part, sv.mesh, ("model",), use="activations").to(x.dtype)

    mods = (attention, mlp, ssm)
    for mod in mods:
        mod.row_linear = f32_row_linear
    try:
        yield
    finally:
        for mod in mods:
            mod.row_linear = plain


@contextlib.contextmanager
def _wrong_head(params, cfg, planted):
    """Inside, where `planted`: the rows of the first two heads of the first
    `attn/wo` piece of `params` (its first layer) swapped, so that two heads'
    outputs go through each other's projection; swapped back after."""
    def find(tree):
        if isinstance(tree, dict):
            if "wo" in tree:
                return tree["wo"]
            tree = list(tree.values())
        for sub in tree if isinstance(tree, (list, tuple)) else ():
            found = find(sub)
            if found is not None:
                return found
        return None

    hd = cfg.head_dim
    wo = find(params)
    wo = wo[0] if wo.dim() == 3 else wo

    def swap():
        if planted:
            first = wo[:hd].clone()
            wo[:hd].copy_(wo[hd:2 * hd])
            wo[hd:2 * hd].copy_(first)

    swap()
    try:
        yield
    finally:
        swap()


def _diffs(got, ref):
    """(largest |got - ref|, |got - ref| / |ref| in the L2 norm) over the
    logits of a run's steps (lists of [B, vocab] f32)."""
    import torch

    got, ref = torch.stack(got), torch.stack(ref)
    return (got - ref).abs().max().item(), ((got - ref).norm() / ref.norm()).item()


def path_l2_rank(rank, ref_path, device_type="cuda", variant="full", port="0"):
    """Path L2's process `rank` of two: a (1, 1, 2) mesh; for each of
    L2_RUNS the whole parameters drawn from seed 0 one rank at a time, this
    rank's pieces kept, the sharded serving run of `ServeLoop`'s prompts
    fed the parent's tokens (`ref_path`), and two more sharded prefills:
    the partial sums reduced in f32 (`_f32_partials`) and one wrong head
    (`_wrong_head`, on rank 1).  Prints one L2_RESULT line: per run the
    prefill's and the decode steps' logits' distances from the parent's
    unsharded bf16 logits (and the two prefills'), the argmaxes'
    agreement with the parent's tokens, its peak, launches, heads and
    collectives."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.models import init_params, prefill
    from repro_torch.serve import ServeLoop

    rank, world = int(rank), 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device_type)
    card = dev.type == "cuda"
    if not card:
        torch.set_num_threads(1)
    _pg(device_type, rank, world, int(port))
    layout = {"node": 1, "fsdp": 1, "model": world}
    mesh = make_logical_mesh(device_type=device_type, layout=layout)
    coord = shd.mesh_coords(mesh)
    refs = torch.load(ref_path)
    rows = {}
    try:
        for arch, layers in L2_RUNS:
            cfg = _l_config(arch, variant, layers)
            for turn in range(world):  # one whole draw on the card at a time
                if turn == rank:
                    params = init_params(0, cfg, device=dev)
                    sh = shd.serving_shardings(mesh, params)
                    mine = shd.shard_tree(params, sh.params, layout, coord)
                    del params
                    free()
                dist.barrier()
            if card:
                torch.cuda.reset_peak_memory_stats()
            shd.reset_collective_counts()
            ref = refs[arch]
            serve = _l_serve(variant, L2_SERVE)
            r = _serve_run(dev, cfg, mine, ServeLoop(cfg, device=dev, **serve), sh,
                           forced=ref["tokens"].to(dev))
            counts, gathered = shd.collective_counts(), shd.gathered_over_model()
            peak = torch.cuda.max_memory_allocated() if card else None
            logits = [x.float().cpu() for x in r["logits"]]
            extra = {}
            loop = ServeLoop(cfg, device=dev, **serve)
            batch = loop.make_batch()  # the same prompts
            for name, scope in (("f32_partials", _f32_partials()),
                                ("wrong_head", _wrong_head(mine, cfg, rank == 1))):
                with torch.inference_mode(), scope:
                    lg = prefill(mine, cfg, batch, loop.capacity, shardings=sh)[0]
                extra[name] = _diffs([lg.float().cpu()], ref["bf16"][:1])
                del lg
            prefill_d = _diffs(logits[:1], ref["bf16"][:1])
            decode_d = _diffs(logits[1:], ref["bf16"][1:])
            rows[arch] = {
                "arch": arch, "layers": cfg.n_layers, "rank": rank,
                "heads": shd.serve_view(sh).heads(cfg.n_heads),
                "ssd_heads": shd.serve_view(sh).heads(cfg.ssm_heads) if _sites(cfg)[1] else None,
                "max_abs_vs_bf16": prefill_d[0], "rel_vs_bf16": prefill_d[1],
                "decode_max_abs_vs_bf16": decode_d[0], "decode_rel_vs_bf16": decode_d[1],
                "f32_partials_max_abs_vs_bf16": extra["f32_partials"][0],
                "f32_partials_rel_vs_bf16": extra["f32_partials"][1],
                "wrong_head_max_abs_vs_bf16": extra["wrong_head"][0],
                "wrong_head_rel_vs_bf16": extra["wrong_head"][1],
                "token_agree": (r["tokens"].cpu() == ref["tokens"]).float().mean().item(),
                "finite": all(bool(torch.isfinite(x).all()) for x in r["logits"]),
                "token_shape": list(r["tokens"].shape), "peak_bytes": peak,
                "prefill_ms": r["prefill_ms"], "decode_ms_per_token": r["decode_ms_per_token"],
                "launches": r["launches"], "sites": _sites(cfg),
                "collectives": counts, "gathered_over_model": gathered}
            del r, mine, sh, logits
            free()
    finally:
        dist.destroy_process_group()
    print("L2_RESULT " + json.dumps(rows), flush=True)


def _rank_children(path, script, tag, argvs, timeout, env=None):
    """Path `path`'s ranks: `script` (a function of this module) in a
    process of its own once a list of arguments in `argvs`, all at once,
    under `env` (`_env()` when None); the line each printed that starts with
    `tag`, parsed.  No rank outlives the call.  A rank that exits without
    its line fails the path, with every such rank's tail on stderr (the
    first to fail may be any of them)."""
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT.format(script), *argv],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env or _env(), cwd=HERE) for argv in argvs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout))
    finally:  # no rank outlives the path
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results, failed = [], []
    for rank, (proc, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
        if proc.returncode != 0 or not lines:
            print(f"path {path} rank {rank}:", out[-4000:], err[-4000:], file=sys.stderr)
            failed.append(f"rank {rank} exited {proc.returncode}")
            continue
        results.append(json.loads(lines[0][len(tag) + 1:]))
    if failed:
        fail(f"path {path}: {script}: {', '.join(failed)}")
    return results


def path_l1(dev, variant="full"):
    """Path L1 on the card: `path_l1_rank` in a process of its own.  The
    sharded run must equal the unsharded one bit for bit and launch flash
    and SSD as often a prefill (on the CPU: no launch)."""
    (rows,) = _rank_children("L1", "path_l1_rank", "L1_RESULT", [[dev.type, variant]], 900)
    launches = {"flash": 0, "ssd": 0}  # all at path C's shape (row 4 / row 5)
    for arch, row in rows.items():
        emit(phase="path_l1", layout=[1, 1, 1], **row)
        flash, ssd = row["sites"] if dev.type == "cuda" else (0, 0)
        want = {"flash": flash, "ssd": ssd}
        if not (row["bit_equal"] and row["finite"]
                and row["launches_sharded"] == row["launches_unsharded"] == want):
            fail(f"path L1 ({arch}): the sharded serving run is not the unsharded one bit for "
                 f"bit, or launched {row['launches_sharded']} against {want} a prefill")
        for k in launches:
            launches[k] += sum(row[f"launches_{how}"][k]
                               for how in ("unsharded", "sharded", "unsharded_again"))
    return launches


def path_l2(dev, variant="full", ratio=L2_ERROR_RATIO):
    """Path L2: the parent's unsharded references, then two ranks on a
    (1, 1, 2) mesh (see the module's docstring), then the dry run's
    per-device peak of the same step.  Held, by the largest difference and
    by the relative L2 norm from the unsharded bf16 logits, over bf16's own
    distance from the f32 logits: the split prefill's and its decode
    steps' (fed the unsharded run's tokens; f32 decode fed them too) at
    most `ratio` (`L2_ERROR_RATIO` on the card; the CPU rehearsal's smoke
    widths put both at a bf16 ulp or two of the logits, and it passes
    1.5), the prefill with the partial sums reduced in f32 at most
    `L2_F32_RATIO`, and the prefill with one wrong head more than `ratio`."""
    import tempfile

    import torch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.serve import ServeLoop
    from repro_torch.tree import tree_map

    serve = _l_serve(variant, L2_SERVE)
    refs = {}
    # launches by the phase-2 row of their shape (L2_ROWS)
    launches = {row: {"flash": 0, "ssd": 0} for rows in L2_ROWS.values() for row in rows}
    for arch, layers in L2_RUNS:
        cfg = _l_config(arch, variant, layers)
        params = init_params(0, cfg, device=dev)
        u = _serve_run(dev, cfg, params, ServeLoop(cfg, device=dev, **serve))
        for k in ("flash", "ssd"):
            launches[L2_ROWS[arch][0]][k] += u["launches"][k]
        with torch.inference_mode():
            p32 = tree_map(lambda x: x.float(), params)
        del params
        free()
        cfg32 = cfg.replace(dtype="float32", use_flash=False, use_ssd_kernel=False)
        r32 = _serve_run(dev, cfg32, p32, ServeLoop(cfg32, device=dev, **serve),
                         forced=u["tokens"])
        refs[arch] = {"bf16": [x.float().cpu() for x in u["logits"]],
                      "f32": [x.cpu() for x in r32["logits"]],
                      "tokens": u["tokens"].cpu(), "prefill_ms": u["prefill_ms"],
                      "decode_ms_per_token": u["decode_ms_per_token"]}
        del u, p32, r32
        free()
    with tempfile.TemporaryDirectory(prefix="repro_torch_l2_") as tmp:
        ref_path = os.path.join(tmp, "refs.pt")
        torch.save(refs, ref_path)
        port = str(_free_port())
        ranks = _rank_children("L2", "path_l2_rank", "L2_RESULT",
                               [[str(r), ref_path, dev.type, variant, port] for r in range(2)],
                               900)
    for arch, layers in L2_RUNS:
        cfg = _l_config(arch, variant, layers)
        ref = refs[arch]
        bf16_err, bf16_rel = _diffs(ref["bf16"][:1], ref["f32"][:1])
        bf16_dec_err, bf16_dec_rel = _diffs(ref["bf16"][1:], ref["f32"][1:])
        shape = InputShape("L2", serve["prompt_len"], serve["batch"], "prefill")
        t0 = time.perf_counter()
        dry = dryrun.sharded_serving(cfg, shape, "prefill", {"node": 1, "fsdp": 1, "model": 2},
                                     serve["batch"])
        dry_s = time.perf_counter() - t0
        for rows in ranks:
            row = rows[arch]
            ratios = {
                "max_abs_ratio": row["max_abs_vs_bf16"] / bf16_err,
                "rel_ratio": row["rel_vs_bf16"] / bf16_rel,
                "decode_max_abs_ratio": row["decode_max_abs_vs_bf16"] / bf16_dec_err,
                "decode_rel_ratio": row["decode_rel_vs_bf16"] / bf16_dec_rel,
                "f32_partials_max_abs_ratio": row["f32_partials_max_abs_vs_bf16"] / bf16_err,
                "f32_partials_rel_ratio": row["f32_partials_rel_vs_bf16"] / bf16_rel,
                "wrong_head_max_abs_ratio": row["wrong_head_max_abs_vs_bf16"] / bf16_err,
                "wrong_head_rel_ratio": row["wrong_head_rel_vs_bf16"] / bf16_rel}
            emit(phase="path_l2", layout=[1, 1, 2], bf16_vs_f32=bf16_err,
                 bf16_rel_vs_f32=bf16_rel, bf16_decode_vs_f32=bf16_dec_err,
                 bf16_decode_rel_vs_f32=bf16_dec_rel, ratio=ratio, f32_ratio=L2_F32_RATIO,
                 **ratios, unsharded_prefill_ms=ref["prefill_ms"],
                 unsharded_decode_ms_per_token=ref["decode_ms_per_token"],
                 dry_per_device_peak_bytes=dry["per_device_memory"]["peak_bytes"],
                 dry_collective_bytes_by_use=dry["by_use"], dry_trace_s=dry_s, **row)
            flash, ssd = row["sites"] if dev.type == "cuda" else (0, 0)
            if row["launches"] != {"flash": flash, "ssd": ssd} or not row["finite"] \
                    or row["token_shape"] != [serve["batch"], serve["gen"]]:
                fail(f"path L2 ({arch}, rank {row['rank']}): launches {row['launches']} "
                     f"against {(flash, ssd)} a prefill, or non-finite logits")
            held = (max(ratios[k] for k in ("max_abs_ratio", "rel_ratio", "decode_max_abs_ratio",
                                            "decode_rel_ratio")) <= ratio
                    and max(ratios["f32_partials_max_abs_ratio"],
                            ratios["f32_partials_rel_ratio"]) <= L2_F32_RATIO
                    and min(ratios["wrong_head_max_abs_ratio"],
                            ratios["wrong_head_rel_ratio"]) > ratio)
            if not held:
                fail(f"path L2 ({arch}, rank {row['rank']}): over bf16's own distance from "
                     f"f32, the split run is {ratios}: the prefill and decode must be at most "
                     f"{ratio}, the f32 partial sums at most {L2_F32_RATIO} and the wrong head "
                     f"more than {ratio}")
            for k in ("flash", "ssd"):
                launches[L2_ROWS[arch][1]][k] += row["launches"][k]
    return launches


def path_l(dev, variant="full", ratio=L2_ERROR_RATIO):
    """Paths L1 and L2; the flash and SSD launches of both, by the phase-2
    row of their shape."""
    t0 = time.perf_counter()
    l1 = path_l1(dev, variant)
    emit(phase="path_l1_done", seconds=time.perf_counter() - t0)
    t1 = time.perf_counter()
    l2 = path_l2(dev, variant, ratio)
    emit(phase="path_l2_done", seconds=time.perf_counter() - t1)
    l2["path-c"] = {k: l1[k] + l2["path-c"][k] for k in l1}
    return l2


# ---------------------------------------------------------------------------
# path M: the tensor-parallel train step on ranks sharing the card
# ---------------------------------------------------------------------------
# (name, (node, fsdp, model), depth (None: the full depth), exchanges,
# whether the negative control runs).  Through gloo every collective is
# staged through the host (chip run 3 of PR 24: M1's gather-whole step 17.6-
# 19.7 s, its tensor-parallel step 7.9 s, the parent's references 29.5-34.1 s
# an exchange at full depth), so that the script stays within the chip
# tool's 1200 s, M1 runs the dense step at full depth, and M2 the dense step,
# the negative control and the sparse step at M2_LAYERS layers
M2_LAYERS = 4
M_RUNS = (("M1", (1, 1, 2), None, ("dense",), False),
          ("M2", (1, 2, 2), M2_LAYERS, ("dense", "sparse"), True))
# the dense step (the PME average, receiver range r = m) and the sparse one
# (f32 gossip); the PaMEConfig defaults otherwise (exact masks), as path K
M_EXCHANGES = {"dense": {}, "sparse": {"mixing": "sparse"}}
# the split step's gradients at most this many times as far from the
# unsharded bf16 step's as those are from the f32 step's at the same weights,
# by the largest difference and by the relative L2 norm, and its new state by
# the relative L2 norm; the negative control (one layer's MLP input taken into
# its rank's columns without `Serve.enter`) must read above it.  The new
# state's largest difference is recorded, not held: a bf16 element that
# rounds the other way in two bf16 steps moves by one ulp, twice the half ulp
# by which rounding puts a bf16 state from an f32 one, so its ratio sits near
# 2 wherever the gradients agree closely (1.98 on the CPU rehearsal at 8
# smoke layers)
M_ERROR_RATIO = L2_ERROR_RATIO
M_NO_ENTRY = "groups/0/1_mlp"
# loss_mean, one f32 scalar whose bf16 routes differ in steps of the bf16
# logits' rounding (2^-13 near 12): chip run 2 of PR 24 read bf16's own
# distance from f32 as 2 such steps and the split step's as 5, a ratio of one
# sample (2.56).  It is held relative to itself instead, at most this share of
# |loss_mean| (run 2: 5.1e-5; the CPU rehearsal 9.4e-5); the ratio is recorded
M_LOSS_REL = 2e-4
# elements at a time in path M's comparisons
M_CHUNK = 1 << 24
M_DRY_SCRIPT = "import sys, chip_smoke; chip_smoke.m_dry(sys.argv[1:])"


def _m_task(dev, variant, layers):
    """Path A's model (bf16; the smoke config cast to bf16 for the CPU
    rehearsal), `layers` deep, its graph, grad_fn and batch, and the
    node-stacked state from seed 0 with node rows 0.01 apart (path K's)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_lm_task
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg = get_config("stablelm-1.6b", variant).replace(dtype="bfloat16")
    cfg = cfg.replace(n_layers=layers) if layers else cfg
    topo, params0, grad_fn, make_batch = make_lm_task(cfg, M, 4, 128, 0, "erdos_renyi", dev)
    g = torch.Generator(device=dev).manual_seed(5)
    leaves, treedef = tree_flatten(params0)
    stacked = tree_unflatten(treedef, [
        (x.unsqueeze(0) + 0.01 * torch.randn((M,) + tuple(x.shape), generator=g, device=dev))
        .to(x.dtype) for x in leaves])
    return cfg, topo, stacked, grad_fn, make_batch(0)


class _Dist:
    """The largest |got - want| and the squared L2 norms of got - want and
    of want, summed in f64 over M_CHUNK-element slices; `owned` False
    leaves a piece out of the sums (another rank counts it)."""

    def __init__(self):
        self.max, self.d2, self.w2 = 0.0, 0.0, 0.0

    def add(self, got, want, owned=True):
        import torch

        g, w = got.reshape(-1), want.reshape(-1)
        for i in range(0, g.numel(), M_CHUNK):
            wf = w[i:i + M_CHUNK].float()
            d = g[i:i + M_CHUNK].float() - wf
            self.max = max(self.max, d.abs().max().item())
            if owned:
                self.d2 += torch.sum(d * d, dtype=torch.float64).item()
                self.w2 += torch.sum(wf * wf, dtype=torch.float64).item()
            del d, wf

    def reduce(self):
        """The sums over every rank of the default group (its max over them)."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([self.d2, self.w2], dtype=torch.float64)
        dist.all_reduce(t)
        m = torch.tensor([self.max], dtype=torch.float64)
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        self.d2, self.w2, self.max = float(t[0]), float(t[1]), float(m[0])
        return self

    def result(self):
        return {"max_abs": self.max, "rel": math.sqrt(self.d2 / self.w2) if self.w2 else 0.0}


@contextlib.contextmanager
def _gossip_impl(impl):
    """Inside: the exchange's contraction forced to `impl` (the variable
    `core.mixing` reads at each call)."""
    old = os.environ.get("REPRO_TORCH_GOSSIP_IMPL")
    os.environ["REPRO_TORCH_GOSSIP_IMPL"] = impl
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_GOSSIP_IMPL", None)
        else:
            os.environ["REPRO_TORCH_GOSSIP_IMPL"] = old


@contextlib.contextmanager
def _no_entry(path):
    """Inside: the block at `path` takes its input into its rank's columns
    without `Serve.enter`, the backward's sum over `model` left out (path
    M's negative control)."""
    from repro_torch import sharding as shd

    enter = shd.Serve.enter
    shd.Serve.enter = lambda self, x: x if self.path == path else enter(self, x)
    try:
        yield
    finally:
        shd.Serve.enter = enter


def _m_refs(dev, variant, layers, exchanges):
    """Path M's references, in the parent: for each of `exchanges` the
    unsharded bf16 step and an f32 step at the same weights (its gradients
    kept on the host; its exchange through the kernels in f32, as the plain
    route's f32 buffers do not fit beside the f32 state at full width):
    bf16's distance from f32 for each node's gradient, the new state and
    loss_mean, and the bf16 step's loss_mean and per-leaf f64 sums (the
    gather-whole route on the ranks must give them).  Returns them by
    exchange, and the kernels' launches."""
    import torch

    threads = torch.get_num_threads()
    if dev.type != "cuda":  # as the ranks: the CPU's embedding backward sums in no fixed order
        torch.set_num_threads(1)
    try:
        return _m_refs_steps(dev, variant, layers, exchanges)
    finally:
        torch.set_num_threads(threads)


def _m_refs_steps(dev, variant, layers, exchanges):
    import torch
    from repro_torch.core import pame, pme
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.launch.train import lm_grad_fn
    from repro_torch.tree import tree_leaves, tree_map

    cfg, topo, stacked, grad_fn, batch = _m_task(dev, variant, layers)
    grad32 = lm_grad_fn(cfg.replace(dtype="float32"))
    # the leaves the dense exchange sends to the PME-average kernel
    pme_leaves = sum(x.numel() >= pme._KERNEL_MIN_ELEMS for x in tree_leaves(stacked))
    n_leaves = len(tree_leaves(stacked))
    # the bf16 state waits on the host while the f32 step runs
    host = tree_map(lambda x: x.cpu(), stacked)
    del stacked
    free()
    refs = {}
    _reset_counts()
    for name in exchanges:
        pcfg = pame.PaMEConfig(**M_EXCHANGES[name])
        ta = pame.make_topology_arrays(topo, pcfg, seed=0, device=dev)
        g32 = []

        def rec32(p, b, k, view=None):
            loss, g = grad32(p, b, k, view=view)
            g32.append([x.cpu() for x in tree_leaves(g)])
            return loss, g

        t0 = time.perf_counter()
        s32 = pame.pame_init(1, tree_map(lambda x: x.to(dev, torch.float32), host), M, pcfg)
        new32, met32 = pame.pame_step(s32, batch, rec32, ta, pcfg)
        del s32
        free()
        grad, seen = _Dist(), []

        def cmp16(p, b, k, view=None):
            loss, g = grad_fn(p, b, k, view=view)
            for x, r in zip(tree_leaves(g), g32[len(seen)]):
                grad.add(x, r.to(dev))
            seen.append(True)
            return loss, g

        new16, met16 = pame.pame_step(
            pame.pame_init(1, tree_map(lambda x: x.to(dev), host), M, pcfg), batch, cmp16, ta,
            pcfg)
        state = _Dist()
        for x, r in zip(tree_leaves(new16.params), tree_leaves(new32.params)):
            state.add(x, r)
        refs[name] = {"grad": grad.result(), "state": state.result(),
                      "loss_bf16": float(met16["loss_mean"]),
                      "loss_f32": float(met32["loss_mean"]),
                      "sums": [x.double().sum().item() for x in tree_leaves(new16.params)],
                      "s": time.perf_counter() - t0,
                      "launches": {"pme_average": pme_leaves if name == "dense" else 0,
                                   "gossip_f32": n_leaves if name == "sparse" else 0}}
        del new32, new16, met32, met16, g32
        free()
    return refs, {"pme_average": pme_average_cuda.launches,
                  "pme_average_range": pme_average_cuda.range_launches,
                  "f32": gossip_gather.variant_launches["f32"]}


def path_m_rank(rank, world, layout, device_type="cuda", variant="full", port="0",
                layers="0", exchanges="dense", negative="0"):
    """Path M's process `rank` of `world` ranks sharing the card (gloo over
    CUDA tensors; on the CPU gloo): a (node, fsdp, model) mesh of `layout`
    ("1x2x2"), path A's model `layers` deep (0: full depth), each rank
    drawing the whole state in turn and keeping its pieces.  For each of
    `exchanges` ("dense,sparse"): the gather-whole route (a grad_fn that
    takes no view; each node's gradient cut to this rank's piece and kept
    on the host), then the tensor-parallel route (`lm_grad_fn`), each
    node's gradient pieces held against the gather-whole route's as they
    come; the new state and loss_mean likewise; with `negative` "1", for
    the dense exchange a third step with one entry left out (`_no_entry`).
    Prints one M_RESULT line: the distances summed over the ranks, each
    route's seconds and peaks (the step's own: max_memory_allocated less
    what was allocated before it, plus its state and batch; over the
    whole step and from the first node's gradient on), the tensor-parallel
    step's collective counts and launches, and the gather-whole route's
    new-state f64 sums."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.core import pame
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.tree import tree_leaves

    rank, world, layers = int(rank), int(world), int(layers) or None
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device_type)
    card = dev.type == "cuda"
    if not card:
        torch.set_num_threads(1)
    _pg(device_type, rank, world, int(port))
    sizes = dict(zip(("node", "fsdp", "model"), map(int, layout.split("x"))))
    mesh = make_logical_mesh(device_type=device_type, layout=sizes)
    coord = shd.mesh_coords(mesh)
    t_init = time.perf_counter()
    for turn in range(world):  # one whole draw on the card at a time
        if turn == rank:
            cfg, topo, stacked, grad_fn, batch = _m_task(dev, variant, layers)
            place = shd.state_shardings(pame.pame_init(1, stacked, M, pame.PaMEConfig()), sizes)
            sharded = shd.MeshShardings(mesh, place.params)
            mine = shd.shard_tree(stacked, place.params, sizes, coord)
            del stacked
            free()
        dist.barrier()
    t_init = time.perf_counter() - t_init
    whole_fn = lambda p, b, k: grad_fn(p, b, k)  # noqa: E731 (takes no view)
    specs = [tuple(s[1:]) for s in shd.leaf_specs(mine, place.params)]
    owned = [shd.owns(s, coord) for s in specs]
    marks = {}

    def mark():
        """At a step's first gradient: its peak so far, and a fresh peak."""
        if card and not marks:
            marks["exchange"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def measured(fn, state, b, pcfg, ta):
        free()
        marks.clear()
        before = torch.cuda.memory_allocated() if card else 0
        if card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        shd.reset_collective_counts()
        t0 = time.perf_counter()
        new, met = pame.pame_step(state, b, fn, ta, pcfg, param_shardings=sharded)
        _sync(dev)
        s = time.perf_counter() - t0
        args = sum(x.numel() * x.element_size() for x in tree_leaves((state, b))
                   if isinstance(x, torch.Tensor))
        grads = torch.cuda.max_memory_allocated() if card else 0
        return new, met, {
            "s": s,
            "peak_bytes": max(grads, marks.get("exchange", 0)) - before + args if card else None,
            "gradient_peak_bytes": grads - before + args if card else None,
            "collectives": shd.collective_counts(), "launches": _k_launches()}

    rows = {}
    try:
        for name in exchanges.split(","):
            pcfg = pame.PaMEConfig(**M_EXCHANGES[name])
            ta = pame.make_topology_arrays(topo, pcfg, seed=0, device=dev)
            state = pame.pame_init(1, mine, M, pcfg)  # this rank's rows
            recorded = []

            def record(p, b, k):
                mark()
                loss, g = whole_fn(p, b, k)
                recorded.append([shd.cut(x, s, sizes, coord).cpu()
                                 for x, s in zip(tree_leaves(g), specs)])
                return loss, g

            gw_new, gw_met, gw = measured(record, state, pame.shard_batch(batch, sharded, record),
                                          pcfg, ta)
            row = {"gather_whole": gw, "gw_loss": float(gw_met["loss_mean"])}
            # the gather-whole route's new state, each leaf's f64 sum over the ranks
            sums = torch.tensor([x.double().sum().item() if own else 0.0
                                 for x, own in zip(tree_leaves(gw_new.params), owned)],
                                dtype=torch.float64)
            dist.all_reduce(sums)
            row["gw_sums"] = sums.tolist()
            runs = (("tensor_parallel", None),) + (
                (("no_entry", M_NO_ENTRY),) if name == "dense" and negative == "1" else ())
            for how, planted in runs:
                grad, seen = _Dist(), []

                def compare(p, b, k, view=None):
                    mark()
                    loss, g = grad_fn(p, b, k, view=view)
                    for x, r, own in zip(tree_leaves(g), recorded[len(seen)], owned):
                        grad.add(x, r.to(dev), own)
                    seen.append(True)
                    return loss, g

                scope = _no_entry(planted) if planted else contextlib.nullcontext()
                with scope:
                    new, met, info = measured(compare, state,
                                              pame.shard_batch(batch, sharded, compare),
                                              pcfg, ta)
                st = _Dist()
                for x, r, own in zip(tree_leaves(new.params), tree_leaves(gw_new.params),
                                     owned):
                    st.add(x, r, own)
                info.update(grad=grad.reduce().result(), state=st.reduce().result(),
                            loss=float(met["loss_mean"]),
                            loss_abs=abs(float(met["loss_mean"]) - row["gw_loss"]),
                            finite=bool(torch.isfinite(met["loss_mean"])))
                row[how] = info
                del new, met
            rows[name] = row
            del gw_new, recorded, state
            free()
    finally:
        dist.destroy_process_group()
    print("M_RESULT " + json.dumps({"rank": rank, "layout": sizes, "layers": cfg.n_layers,
                                    "init_s": t_init, "rows": rows}), flush=True)


def path_m(dev, variant="full", ratio=M_ERROR_RATIO, runs=M_RUNS):
    """Path M: the parent's references (`_m_refs`), then each of `runs` on
    its ranks (`path_m_rank`, all sharing the card).  Held, for each
    exchange, over the unsharded bf16 step's distance from the f32 step's:
    every node's gradient (by the largest difference and by the relative
    L2 norm) and the new state (by the relative L2 norm) of the
    tensor-parallel route at most `ratio` from the gather-whole route's
    (which must be the unsharded bf16 step:
    its loss_mean equal and its new state's per-leaf f64 sums within 1e-9
    relatively), its loss_mean within M_LOSS_REL of it, and the negative
    control's gradient more than `ratio`; finite losses; on the card a
    PME-average launch a step a rank for each leaf of at least
    `pme._KERNEL_MIN_ELEMS` elements over the m nodes (dense, every one
    with its receiver range: 10 at full depth) and an f32 gossip launch for
    each leaf (sparse); and each rank's peak from
    the first node's gradient on below the gather-whole route's.  Returns
    the rows by run (each rank's peaks and seconds a step of both routes,
    the collectives by use) and the launches."""
    t0 = time.perf_counter()
    refs = {}
    launches = {"pme_average": 0, "pme_average_range": 0, "f32": 0}
    rows = {}
    for run, layout, layers, exchanges, negative in runs:
        t1 = time.perf_counter()
        refs, counted = _m_refs(dev, variant, layers, exchanges)
        launches = {k: launches[k] + counted[k] for k in launches}
        refs_s = time.perf_counter() - t1
        world = math.prod(layout)
        port = str(_free_port())
        tag = "x".join(map(str, layout))
        t1 = time.perf_counter()
        ranks = _rank_children(f"M ({tag})", "path_m_rank", "M_RESULT",
                               [[str(r), str(world), tag, dev.type, variant, port,
                                 str(layers or 0), ",".join(exchanges), str(int(negative))]
                                for r in range(world)], 900)
        rows[run] = {"layout": layout, "layers": ranks[0]["layers"], "refs_s": refs_s,
                     "seconds": time.perf_counter() - t1, "ranks": []}
        for res in ranks:
            for name in exchanges:
                row, r = res["rows"][name], refs[name]
                loss_ref = abs(r["loss_bf16"] - r["loss_f32"])
                ratios = {}
                for how in ("tensor_parallel", "no_entry"):
                    if how not in row:
                        continue
                    got = row[how]
                    ratios[how] = {
                        "grad_max_abs": got["grad"]["max_abs"] / r["grad"]["max_abs"],
                        "grad_rel": got["grad"]["rel"] / r["grad"]["rel"],
                        "state_max_abs": got["state"]["max_abs"] / r["state"]["max_abs"],
                        "state_rel": got["state"]["rel"] / r["state"]["rel"],
                        "loss": got["loss_abs"] / loss_ref if loss_ref else None}
                tp = row["tensor_parallel"]
                sums_rel = max(abs(a - b) / max(abs(b), 1e-30)
                               for a, b in zip(row["gw_sums"], r["sums"]))
                emit(phase="path_m", run=run, layout=list(layout), rank=res["rank"],
                     layers=res["layers"], exchange=name, ratio=ratio, ratios=ratios,
                     bf16_vs_f32={"grad": r["grad"], "state": r["state"], "loss": loss_ref},
                     loss_rel=tp["loss_abs"] / abs(row["gw_loss"]), loss_rel_bound=M_LOSS_REL,
                     tensor_parallel=tp, gather_whole=row["gather_whole"],
                     no_entry=row.get("no_entry"), gw_loss=row["gw_loss"],
                     ref_loss_bf16=r["loss_bf16"], gw_sums_max_rel=sums_rel, ref_s=r["s"],
                     init_s=res["init_s"])
                want = dict(r["launches"], pme_average_range=r["launches"]["pme_average"])
                if dev.type != "cuda":
                    want = dict.fromkeys(want, 0)
                got_l = {k: tp["launches"][k] for k in want}
                held = ratios["tensor_parallel"]
                tp_held = (max(held["grad_max_abs"], held["grad_rel"], held["state_rel"]) <= ratio
                           and tp["loss_abs"] <= M_LOSS_REL * abs(row["gw_loss"]))
                neg = ratios.get("no_entry")
                neg_held = neg is None or min(neg["grad_max_abs"], neg["grad_rel"]) > ratio
                if not (tp_held and neg_held and tp["finite"] and got_l == want
                        and row["gw_loss"] == r["loss_bf16"] and sums_rel <= 1e-9):
                    fail(f"path M ({run}, rank {res['rank']}, {name}): over bf16's own distance "
                         f"from f32 the tensor-parallel step is {ratios} (at most {ratio}; the "
                         f"negative control more), its loss_mean {tp['loss_abs']} off (at most "
                         f"{M_LOSS_REL} of it), launches {got_l} against {want}, the "
                         f"gather-whole route's loss {row['gw_loss']} against the unsharded "
                         f"{r['loss_bf16']}, its sums {sums_rel} apart")
                for how in ("tensor_parallel", "gather_whole", "no_entry"):
                    if how in row:
                        n = row[how]["launches"]
                        launches["pme_average"] += n["pme_average"]
                        launches["pme_average_range"] += n["pme_average_range"]
                        launches["f32"] += n["gossip_f32"]
                if name == "dense":
                    gw = row["gather_whole"]
                    rows[run]["ranks"].append({
                        "rank": res["rank"], "peak_bytes": tp["peak_bytes"],
                        "gradient_peak_bytes": tp["gradient_peak_bytes"],
                        "gather_whole_peak_bytes": gw["peak_bytes"],
                        "gather_whole_gradient_peak_bytes": gw["gradient_peak_bytes"],
                        "s_step": tp["s"], "gather_whole_s_step": gw["s"],
                        "collectives": tp["collectives"]})
        for r in rows[run]["ranks"]:
            if dev.type == "cuda" and \
                    not r["gradient_peak_bytes"] < r["gather_whole_gradient_peak_bytes"]:
                fail(f"path M ({run}): rank {r['rank']}'s peak from the first gradient on, "
                     f"{r['gradient_peak_bytes']}, is not below the gather-whole route's "
                     f"{r['gather_whole_gradient_peak_bytes']}")
        emit(phase=f"path_m_{run.lower()}_done", seconds=rows[run]["seconds"], refs_s=refs_s)
    emit(phase="path_m_done", seconds=time.perf_counter() - t0)
    return rows, launches


def m_dry(argv):
    """One of J5's path-M records, written as the dry run's ``--out`` file:
    `dryrun.sharded_collectives` of path M's dense step (path A's model in
    bf16, 4 nodes, 4 x 128 tokens a node, exact masks) at ``--layout``
    ("1x2x2"), with the exchange's kernels on their route (the dry run's
    tensors are the CPU's, where the contraction would take its plain
    version): rank 0's collective bytes by use and its peak."""
    import argparse

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.pame import PaMEConfig
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    for flag in ("--layout", "--out"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--device-bytes", type=float, required=True)
    ap.add_argument("--size", default="full")
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config("stablelm-1.6b", args.size).replace(dtype="bfloat16")
    cfg = cfg.replace(n_layers=args.layers) if args.layers else cfg
    layout = dict(zip(("node", "fsdp", "model"), map(int, args.layout.split("x"))))
    t0 = time.perf_counter()
    with _gossip_impl("kernel"):
        rec = dryrun.sharded_collectives(cfg, InputShape("M", 128, M * 4, "train"), layout, M * 4,
                                         m=M, pame_cfg=PaMEConfig())
    with open(args.out, "w") as f:
        json.dump({"m": dict(rec, layout=layout, layers=cfg.n_layers,
                             trace_s=time.perf_counter() - t0)}, f)


# ---------------------------------------------------------------------------
# path N: the sharded PaME step under the dynamic network, node rows across
# two ranks sharing the card
# ---------------------------------------------------------------------------
# path N's depth, cut from 24 for time, not for memory.  Each rank holds
# the fresh and the delayed stacks of its two nodes, and the dense step with
# the self view takes the plain average (JAX's routing) with its f32
# temporaries of the largest leaf beside them; both ranks run each step at
# once.  On an H100 80GB HBM3 at 700 W, at 23 and 20 layers a rank ran out
# of memory (34.63 GiB allocated beside the other rank and the parent) and
# 16 layers fit (a rank's peak 32.8 GB); but every step gathers the other
# rank's rows through gloo, staged through the host: 9.9-16.8 s a step at 12
# layers, the ranks 50.2-59.5 s of the script.  The gather scales with the
# parameters (4 layers: 0.60 of 12's), and the script must end within
# 1200 s with path M1 at full depth
N_LAYERS = 4
# path N's largest leaf (the MLP's at full depth, the embedding's below 18 layers)
N_LEAF_N = max(100352 * 2048, (N_LAYERS or 24) * 2048 * 5632)
N_LAYOUT = {"node": 2, "fsdp": 1, "model": 1}
N_TIMEOUT = 600  # seconds: a rank's collectives, and the ranks' processes


def _n_record(dev, new, met, t0):
    """A step's record: its new state's row digests (params, then sigma),
    loss_mean, wire_bits, comm_nodes, seconds, peak and launches."""
    import torch

    _sync(dev)
    return {"digests": row_digests(new.params) + row_digests([new.sigma]),
            "loss": float(met["loss_mean"]), "wire_bits": float(met["wire_bits"]),
            "comm_nodes": int(met["comm_nodes"]), "s": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
            "launches": _k_launches()}


def _n_refs(dev, variant, layers):
    """Path N's references, in the parent, alone on the card: each network
    case's unsharded step from the whole stacks (`net_task`), its record
    (`_n_record`), and for the first case `freeze_dropped` after it (the
    offline node's rows back).  Returns the records by case, the frozen
    state's digests, the launches each rank's step should make (the PME
    average once a leaf of at least `pme._KERNEL_MIN_ELEMS` elements over
    the m nodes, the f32 gossip kernel once a leaf) and the parent's
    launches."""
    import torch
    from repro_torch.core import pame, pme, scenarios
    from repro_torch.tree import tree_leaves

    threads = torch.get_num_threads()
    if dev.type != "cuda":  # as the ranks: the CPU's embedding backward sums in no fixed order
        torch.set_num_threads(1)
    try:
        topo, grad_fn, batch, fresh, delayed = net_task(dev, variant, layers)
        real, delivered = net_inputs(topo)
        n_pme = sum(x.numel() >= pme._KERNEL_MIN_ELEMS for x in tree_leaves(fresh))
        n_leaves = len(tree_leaves(fresh))
        refs, frozen = {}, None
        counted = {"pme_average": 0, "f32": 0}
        for name, fields, net in NET_CASES:
            cfg = pame.PaMEConfig(**fields)
            ta = pame.make_topology_arrays(topo, cfg, seed=0, device=dev)
            state = pame.pame_init(1, delayed if "s" in net else fresh, M, cfg)
            t0 = _start(dev)
            new, met = pame.pame_step(state, batch, grad_fn, ta, cfg, realization=real,
                                      self_params=fresh if "s" in net else None,
                                      delivered=delivered if "d" in net else None)
            refs[name] = _n_record(dev, new, met, t0)
            counted["pme_average"] += refs[name]["launches"]["pme_average"]
            counted["f32"] += refs[name]["launches"]["gossip_f32"]
            if frozen is None:
                f = scenarios.freeze_dropped(real.alive, state, new)
                frozen = row_digests(f.params) + row_digests([f.sigma])
                del f
            del new, met, state
            free()
        del fresh, delayed
        free()
    finally:
        torch.set_num_threads(threads)
    none = {"pme_average": 0, "pme_average_range": 0, "gossip_f32": 0, "gossip_bf16": 0}
    want = {"dense-real": dict(none, pme_average=n_pme, pme_average_range=n_pme),
            "sparse-net": dict(none, gossip_f32=n_leaves), "dense-self": none}
    return refs, frozen, want, counted


def path_n_rank(rank, device_type="cuda", variant="full", port="0", layers="0"):
    """Path N's process `rank` of two sharing the card (gloo over CUDA
    tensors; on the CPU gloo): a (2, 1, 1) (node, fsdp, model) mesh, so the
    rank holds nodes 2·rank and 2·rank + 1 whole, path A's model `layers`
    deep (0: the full depth), the network's fresh and delayed stacks
    (`net_task`, each rank drawing the whole leaves in turn and keeping
    its rows).  For each network case (NET_CASES) the tensor-parallel
    route (`lm_grad_fn`; path K holds the gather-whole route on one rank)
    from this rank's pieces and the same key, batch, realization, delivery
    masks and self view: the record of `_n_record` (this rank's rows'
    digests); after the first case's step
    `freeze_dropped(..., shardings=)`, whether the offline node's rows
    came back bit for bit (`torch.equal`, on the rank that holds it) and
    the frozen rows' digests.  Prints one N_RESULT line."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.core import pame, scenarios
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.tree import tree_leaves, tree_map

    rank, layers = int(rank), int(layers) or None
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device_type)
    if dev.type != "cuda":
        torch.set_num_threads(1)
    _pg(device_type, rank, 2, int(port), timeout=N_TIMEOUT)
    mesh = make_logical_mesh(device_type=device_type, layout=N_LAYOUT)
    coord = shd.mesh_coords(mesh)
    mine = shd.node_rows(shd.MeshShardings(mesh, None), M)
    t_init = time.perf_counter()
    for turn in range(2):  # one whole draw on the card at a time
        if turn == rank:
            topo, grad_fn, batch, fresh, delayed = net_task(dev, variant, layers, mine)
        dist.barrier()
    t_init = time.perf_counter() - t_init
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    real, delivered = net_inputs(topo)
    # the placements of the whole state, from its shapes alone
    shapes = tree_map(lambda x: torch.empty((M,) + tuple(x.shape[1:]), dtype=x.dtype,
                                            device="meta"), fresh)
    place = shd.state_shardings(pame.pame_init(1, shapes, M, pame.PaMEConfig()), N_LAYOUT)
    sharded = shd.MeshShardings(mesh, place.params)
    cases, freeze = {}, {}
    try:
        for name, fields, net in NET_CASES:
            cfg = pame.PaMEConfig(**fields)
            ta = pame.make_topology_arrays(topo, cfg, seed=0, device=dev)
            state = pame.pame_init(1, delayed if "s" in net else fresh, M, cfg)
            b = pame.shard_batch(batch, sharded, grad_fn)
            t0 = _start(dev)
            new, met = pame.pame_step(state, b, grad_fn, ta, cfg, param_shardings=sharded,
                                      realization=real, self_params=fresh if "s" in net else None,
                                      delivered=delivered if "d" in net else None)
            cases[name] = _n_record(dev, new, met, t0)
            del met, b
            if not freeze:
                frozen = scenarios.freeze_dropped(real.alive, state, new, shardings=sharded)
                i = NET_OFFLINE - mine.start
                freeze = {"digests": row_digests(frozen.params) + row_digests([frozen.sigma]),
                          "restored": None if not mine.start <= NET_OFFLINE < mine.stop
                          else all(torch.equal(x[i], y[i]) for x, y in zip(
                              tree_leaves((frozen.params, frozen.sigma)),
                              tree_leaves((state.params, state.sigma))))}
                del frozen
            del new, state
            free()
    finally:
        dist.destroy_process_group()
    print("N_RESULT " + json.dumps({"rank": rank, "rows": [mine.start, mine.stop],
                                    "init_s": t_init, "held_bytes": held, "cases": cases,
                                    "freeze": freeze}),
          flush=True)


def path_n(dev, variant="full", layers=N_LAYERS):
    """Path N: the parent's unsharded references alone on the card
    (`_n_refs`), then two ranks sharing it at (2, 1, 1) (`path_n_rank`).
    Held for every network case and rank: the rank's rows of the
    new state (params and sigma) equal to the parent's rows of the
    unsharded step's by their digests (`row_digests`), loss_mean,
    wire_bits and comm_nodes equal, finite losses, and on the card the
    launches of `_n_refs`' `want` (every PME-average launch with its
    receiver range r = 2); `freeze_dropped(shardings=)` equal to the
    parent's unsharded freeze by the digests, and the offline node's rows
    back bit for bit on the rank that holds it.  Returns the rows (each
    rank's peak and seconds a step) and the launches."""
    import torch

    t0 = time.perf_counter()
    refs, frozen, want, counted = _n_refs(dev, variant, layers)
    free()
    refs_s = time.perf_counter() - t0
    if dev.type == "cuda":  # what the parent keeps on the card beside the ranks
        emit(phase="path_n_refs", seconds=refs_s,
             parent_reserved_bytes=torch.cuda.memory_reserved(),
             parent_allocated_bytes=torch.cuda.memory_allocated())
    else:
        want = {k: dict.fromkeys(w, 0) for k, w in want.items()}
    t1 = time.perf_counter()
    port = str(_free_port())
    # expandable segments: the ranks' leaf-sized transients differ in size
    # leaf by leaf, and the cached blocks they leave would not be reused
    ranks = _rank_children("N", "path_n_rank", "N_RESULT",
                           [[str(r), dev.type, variant, port, str(layers or 0)]
                            for r in range(2)], N_TIMEOUT,
                           env=dict(_env(), PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    rows = {"layout": [2, 1, 1], "layers": layers, "refs_s": refs_s,
            "seconds": time.perf_counter() - t1, "ranks": []}
    launches = {"pme_average": counted["pme_average"], "pme_average_range": 0,
                "pme_average_range_r0": {0: 0, 2: 0}, "f32": counted["f32"], "f32_ranks": 0}
    for res in ranks:
        lo, hi = res["rows"]
        cut = lambda digests: [d[lo:hi] for d in digests]  # noqa: E731 (the rank's rows)
        rank_row = {"rank": res["rank"], "nodes": [lo, hi], "init_s": res["init_s"],
                    "held_bytes": res["held_bytes"], "cases": {}}
        for name, _, net in NET_CASES:
            ref, got = refs[name], res["cases"][name]
            case = {k: got[k] for k in ("s", "peak_bytes", "launches", "loss", "wire_bits",
                                        "comm_nodes")}
            case.update(inputs=net, bit_equal=(
                got["digests"] == cut(ref["digests"])
                and all(got[k] == ref[k] for k in ("loss", "wire_bits", "comm_nodes"))))
            if not (case["bit_equal"] and math.isfinite(got["loss"])
                    and got["launches"] == want[name]):
                emit(phase="path_n", rank=res["rank"], case=name, **case,
                     want_launches=want[name], ref_loss=ref["loss"],
                     ref_wire_bits=ref["wire_bits"])
                fail(f"path N (rank {res['rank']}, {name}): the rank's rows are not the "
                     f"unsharded step's bit for bit, or it launched {got['launches']} "
                     f"against {want[name]}")
            launches["pme_average"] += got["launches"]["pme_average"]
            launches["pme_average_range"] += got["launches"]["pme_average_range"]
            launches["pme_average_range_r0"][lo] += got["launches"]["pme_average_range"]
            launches["f32"] += got["launches"]["gossip_f32"]
            launches["f32_ranks"] += got["launches"]["gossip_f32"]
            rank_row["cases"][name] = case
        fz = res["freeze"]
        rank_row["freeze_restored"] = fz["restored"] is not False
        rank_row["freeze_equal"] = fz["digests"] == cut(frozen)
        rank_row["holds_offline"] = fz["restored"] is not None
        if not (rank_row["freeze_restored"] and rank_row["freeze_equal"]):
            fail(f"path N (rank {res['rank']}): freeze_dropped(shardings=) did not give the "
                 f"offline node's rows back, or differs from the unsharded freeze")
        emit(phase="path_n", layout=[2, 1, 1], layers=layers, **rank_row)
        rows["ranks"].append(rank_row)
    if sum(r["holds_offline"] for r in rows["ranks"]) != 1:
        fail("path N: the offline node's rows were not on exactly one rank")
    emit(phase="path_n_done", seconds=time.perf_counter() - t0, refs_s=refs_s,
         ranks_s=rows["seconds"], refs={k: {"s": r["s"], "peak_bytes": r["peak_bytes"],
                                            "launches": r["launches"]}
                                        for k, r in refs.items()})
    return rows, launches


# ---------------------------------------------------------------------------
# path J: the four input shapes (configs/shapes.py) at full width and depth
# ---------------------------------------------------------------------------
J_LONG, J_WINDOW = 524_288, 4096  # long_500k's sequence and window (configs/shapes.py)
# J1: train_4k through the trainer CLI, 4 nodes x J1_BATCH sequences of
# 4096 tokens with each layer checkpointed (global batch 256 cut to 8)
J1_BATCH = 2
# J2 / J3: prefill_32k and decode_32k on one node model, batch cut to 8
# (6.4 GB of KV a sequence: 32 need 205 GB, 128 need 824 GB)
J2_BATCH = 8
J3_GEN = 16
# J4: long_500k at its real batch of 1, 32 decoded tokens past the ring's wrap
J4_GEN = 32
J4 = (("J4a", "stablelm-1.6b", dict(use_flash=True)),
      ("J4b", "mamba2-1.3b", dict(use_ssd_kernel=True)),
      ("J4c", "zamba2-1.2b", dict(use_flash=True, use_ssd_kernel=True)))
# the dry run's combos of J1-J4 (J5), one CLI call each, the longest
# traces (J4b's and J4c's 48 and 38 SSM layers at 524,288 tokens, J1's
# backward and its sharded step at 8 fake ranks) first
# backward) first.  The prefills the card ran through flash and SSD take the
# kernels variant, whose memory trace follows those kernels' route (its
# FLOPs are the baseline's: the FLOP trace stays on the plain versions)
KERNELS = ["--variant", "kernels"]
J5 = (("J4b", ["--arch", "mamba2-1.3b", "--shape", "long_500k", "--kind", "prefill", *KERNELS]),
      ("J4c", ["--arch", "zamba2-1.2b", "--shape", "long_500k", "--kind", "prefill", *KERNELS]),
      ("J1", ["--arch", "stablelm-1.6b", "--shape", "train_4k", "--nodes", str(M),
              "--batch", str(M * J1_BATCH)]),
      ("J2", ["--arch", "stablelm-1.6b", "--shape", "prefill_32k", "--batch", str(J2_BATCH),
              *KERNELS]),
      ("J3", ["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--batch", str(J2_BATCH)]),
      ("J4a", ["--arch", "stablelm-1.6b", "--shape", "long_500k", "--kind", "prefill",
               *KERNELS]),
      ("J4a-decode", ["--arch", "stablelm-1.6b", "--shape", "long_500k"]),
      ("J4b-decode", ["--arch", "mamba2-1.3b", "--shape", "long_500k"]),
      ("J4c-decode", ["--arch", "zamba2-1.2b", "--shape", "long_500k"]))
# J5's sharded serving records (`j5_t8_arch`): every arch's prefill_32k,
# decode_32k and long_500k at 8 devices with a model axis of 8, one process
# an arch
J5_T8_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
J5_T8_SCRIPT = "import sys, chip_smoke; chip_smoke.j5_t8_arch(sys.argv[1:])"
# J5's dry runs at a time.  They start after phase 2 and trace on the
# host while the card runs the paths after it (a dry run is one thread; the
# host has 8 cores), and path J reads their records
J5_WORKERS = 3
J5_BG_SCRIPT = "import sys, chip_smoke; chip_smoke.j5_background(*sys.argv[1:])"
# the dry run's peak against the card's max_memory_allocated, by J5 combo
# and the measured run it sizes: within this share either way
J5_PEAK_TOL = 0.10
J5_PEAK_RUNS = ("J1", "J2", "J4a", "J4b", "J4c")
# the parity phase's sub-sequence (2 layers, full width)
PARITY_J_SEQ = 8192

J1_SCRIPT = """
import json, sys, torch
from repro_torch.kernels.gossip.kernel import gossip_gather
from repro_torch.launch import train
out = train.main(json.loads(sys.argv[1]))
card = torch.cuda.is_available()
if card:
    torch.cuda.synchronize()
print("J1_RESULT " + json.dumps({
    "loss": out["loss"], "s_per_step": out["seconds"], "steps": out["steps"],
    "peak_bytes": torch.cuda.max_memory_allocated() if card else None,
    "gossip_variant_launches": gossip_gather.variant_launches}), flush=True)
"""


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


def run_dryruns(device_bytes, out_dir, combos=J5, workers=J5_WORKERS):
    """J5: the dry run's CLI on its combos, `workers` processes at a time
    on the host (the dry run allocates nothing and never touches the card:
    the card's memory is passed in).  Returns the records by name; a
    process still running 300 s after its start is killed and fails the
    path."""
    timeout = 300
    procs, errors = [], []

    def run(name, argv):
        # a combo runs the dry run's CLI, or a script given as ["-c", ...]
        cmd = [sys.executable, *(() if argv[0] == "-c" else ("-m", "repro_torch.launch.dryrun")),
               *argv, "--device-bytes", str(device_bytes),
               "--out", os.path.join(out_dir, f"{name}.json")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, env=_env(), cwd=HERE)
        procs.append(proc)
        try:
            log, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            errors.append(f"{name}: still running after {timeout} s")
            return
        if proc.returncode != 0:
            errors.append(f"{name}: exit {proc.returncode}\n{log[-2000:]}")

    try:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            for f in [pool.submit(run, name, argv) for name, argv in combos]:
                f.result()
    finally:  # no dry run outlives the script
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        fail("path J5: a dry run failed:\n" + "\n".join(errors))
    recs = {}
    for name, _ in combos:
        with open(os.path.join(out_dir, f"{name}.json")) as f:
            found = list(json.load(f).values())
        if len(found) == 1:
            recs[name] = found[0]
        else:  # one record a shape
            recs.update({f"{name}-{rec['shape']}": rec for rec in found})
    return recs


def j5_background(device_bytes, out_dir, combos):
    """`run_dryruns` in the process `start_dryruns` starts: the records,
    and the seconds they took, into ``records.json`` in `out_dir`."""
    t = time.perf_counter()
    recs = run_dryruns(float(device_bytes), out_dir, [tuple(c) for c in json.loads(combos)])
    with open(os.path.join(out_dir, "records.json"), "w") as f:
        json.dump({"seconds": time.perf_counter() - t, "records": recs}, f)


def start_dryruns(device_bytes, combos):
    """J5's dry runs in the background: `j5_background` in a process of its
    own, in a session of its own, so that `finish_dryruns`, or the script's
    exit on a failure, stops it and every dry run it started at once.  The
    dry runs only trace on the host, J5_WORKERS at a time, beside the paths
    the card runs meanwhile."""
    import atexit
    import shutil
    import signal
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="repro_torch_dryrun_")
    log = open(os.path.join(out_dir, "background.log"), "w+")
    proc = subprocess.Popen([sys.executable, "-c", J5_BG_SCRIPT, str(device_bytes), out_dir,
                             json.dumps(combos)], stdout=log, stderr=subprocess.STDOUT,
                            env=_env(), cwd=HERE, start_new_session=True)
    emit(phase="path_j5_start", at_s=time.perf_counter() - T0, combos=len(combos),
         workers=J5_WORKERS)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        log.close()
        shutil.rmtree(out_dir, ignore_errors=True)

    atexit.register(stop)
    return {"proc": proc, "dir": out_dir, "stop": stop}


def finish_dryruns(handle, timeout=900):
    """Waits for `start_dryruns`' process (at most `timeout` seconds more)
    and returns its records by name, its own seconds and the seconds waited
    here.  Fails the path if it failed or is still running."""
    t = time.perf_counter()
    proc = handle["proc"]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    waited = time.perf_counter() - t
    try:
        if proc.returncode != 0:
            with open(os.path.join(handle["dir"], "background.log")) as f:
                tail = f.read()[-4000:]
            fail(f"path J5: the dry runs exited {proc.returncode} after {waited:.0f} s of "
                 f"waiting:\n{tail}")
        with open(os.path.join(handle["dir"], "records.json")) as f:
            out = json.load(f)
    finally:
        handle["stop"]()
    return out["records"], out["seconds"], waited


def j5_t8_combos():
    """J5's sharded serving combos, one an arch: (name, arguments)."""
    from repro_torch.configs import all_arch_names

    return tuple((f"T8-{arch}", ["-c", J5_T8_SCRIPT, "--arch", arch])
                 for arch in all_arch_names())


def j5_t8_arch(argv):
    """One arch's J5 sharded serving records, written as the dry run's
    ``--out`` file ({shape: record}): for each of J5_T8_SHAPES, the step of
    the shape's own kind and batch at the layout the dry run gives
    ``--devices 8 --model-axis 8``, through `dryrun.sharded_serving` (its
    collective bytes, the leaves gathered over `model`, one rank's peak)."""
    import argparse

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import INPUT_SHAPES, config_for_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import logical_layout

    ap = argparse.ArgumentParser()
    for flag in ("--arch", "--out"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--device-bytes", type=float, required=True)
    ap.add_argument("--size", default="full")
    args = ap.parse_args(argv)
    base = get_config(args.arch, args.size)
    recs = {}
    for name in J5_T8_SHAPES:
        shape = INPUT_SHAPES[name]
        cfg = config_for_shape(base, shape)
        layout = logical_layout(cfg, 8, model_axis=8, param_budget=args.device_bytes / 2)
        t0 = time.perf_counter()
        rec = dryrun.sharded_serving(cfg, shape, shape.kind, layout, shape.global_batch)
        recs[name] = dict(rec, arch=args.arch, shape=name, kind=shape.kind,
                          global_batch=shape.global_batch, layout=dict(layout, devices=8),
                          trace_s=time.perf_counter() - t0)
    with open(args.out, "w") as f:
        json.dump(recs, f)


def path_j1(dev, batch=J1_BATCH, seq=4096, variant="full"):
    """train_4k through the trainer CLI in a fresh process with
    --compile-cache: stablelm-1.6b, PaME sparse on 4 nodes, batch x 4096
    tokens a node, each layer checkpointed, 3 steps.  The gossip kernel
    must be built into the cache directory and launch 11 times a step (f32),
    the losses be finite and the peak under 80 GB."""
    import shutil
    import tempfile

    cache = tempfile.mkdtemp(prefix="repro_torch_compile_cache_")
    steps = 3
    argv = ["--arch", "stablelm-1.6b", "--variant", variant, "--algo", "pame", "--nodes", str(M),
            "--batch", str(batch), "--seq", str(seq), "--steps", str(steps), "--chunk", "1",
            "--remat", "--device", dev.type, "--compile-cache", cache]
    free()
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-c", J1_SCRIPT, json.dumps(argv)],
                             capture_output=True, text=True, env=_env(), cwd=HERE, timeout=600)
        built = sorted(os.listdir(cache))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("J1_RESULT ")]
    if res.returncode != 0 or not lines:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
        fail(f"path J1: the trainer exited {res.returncode}")
    out = json.loads(lines[0][len("J1_RESULT "):])
    row = {"phase": "path_j1", "shape": "train_4k", "arch": "stablelm-1.6b",
           "reduced": {"global_batch": [256, M * batch]}, "nodes": M, "seq": seq,
           "remat": "full", "seconds": time.perf_counter() - t0, "built_in_cache": built,
           "cache_logged": f"[train] compilation cache at {cache}" in res.stdout, **out}
    emit(**row)
    want = {"f32": 11 * steps, "bf16": 0} if dev.type == "cuda" else {"f32": 0, "bf16": 0}
    if row["gossip_variant_launches"] != want:
        fail(f"path J1: expected gossip launches {want}")
    if dev.type == "cuda" and not any(f.startswith("gossip_gather-") for f in built):
        fail(f"path J1: the gossip kernel was not built into --compile-cache ({built})")
    if not row["cache_logged"] or not all(math.isfinite(x) for x in row["loss"]):
        fail("path J1: no compilation-cache line, or a loss is not finite")
    if dev.type == "cuda" and row["peak_bytes"] >= PEAK_LIMIT:
        fail(f"path J1: peak {row['peak_bytes']} B over {PEAK_LIMIT}")
    return row


def path_j1_dry(dev, batch=J1_BATCH, seq=4096, variant="full"):
    """J1-dry: the dry run's own train step (`dryrun.build_train`: PaME's
    dense exchange with Bernoulli masks on a ring, m = 4, each layer
    checkpointed) once on the card with real tensors at J1's batch,
    stablelm-1.6b at full width and depth: its max_memory_allocated from
    the state and batch in place, for J5 to hold the dry run's peak
    against.  J1 itself runs the trainer's sparse step, another step."""
    import numpy as np
    import torch
    from repro_torch.configs import INPUT_SHAPES, config_for_shape, get_config
    from repro_torch.core.pame import PaMEState
    from repro_torch.launch.dryrun import build_train
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    cfg = config_for_shape(get_config("stablelm-1.6b", variant),
                           INPUT_SHAPES["train_4k"]).replace(remat=True)
    free()
    params0 = init_params(0, cfg, device=dev)
    stacked = tree_map(lambda x: x.unsqueeze(0).expand((M,) + tuple(x.shape)).contiguous(),
                       params0)
    del params0
    state = PaMEState(params=stacked, sigma=torch.full((M,), 5.0, device=dev), step=0, key=0)
    del stacked
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (M, batch, seq)).astype(np.int32), device=dev)
    step = build_train(cfg, M, device=dev)
    free()
    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() if card else None
    t0 = time.perf_counter()
    _, metrics = step(state, {"tokens": tokens})
    _sync(dev)
    row = {"phase": "path_j1_dry", "shape": "train_4k", "arch": "stablelm-1.6b", "nodes": M,
           "batch": batch, "seq": seq, "remat": "full", "exchange": "dense bernoulli",
           "seconds": time.perf_counter() - t0, "loss": float(metrics["loss_mean"]),
           "argument_bytes": before,
           "peak_bytes": torch.cuda.max_memory_allocated() if card else None}
    del state, metrics, tokens
    free()
    emit(**row)
    if not math.isfinite(row["loss"]) or (card and row["peak_bytes"] >= PEAK_LIMIT):
        fail("path J1-dry: a loss is not finite or the peak is over the card")
    return row


def _kernel_counts():
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_cuda

    return {"flash": dict(flash_attention_cuda.variant_launches),
            "ssd": dict(ssd_intra_chunk_cuda.variant_launches)}


def _ring(caches):
    """The positions of the first attention cache of the tree (layer 0),
    or None for an attention-free model."""
    for group in caches:
        for key, c in sorted(group.items()):
            if hasattr(c, "positions"):
                return c.positions[0]
    return None


def serve_shape(dev, cfg, batch, seq, capacity, gen, run, prompt_seed=0):
    """One node model of `cfg` from seed 0: prefill `batch` x `seq` random
    tokens into caches of `capacity`, then `gen` greedy tokens through
    `decode_step` (`serve.decode_greedy`).  Prefill ms, decode ms a token,
    tokens/s, the peak, each kernel's launches in the prefill, finite
    logits, and the first attention cache's ring positions afterwards."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve.serving import decode_greedy

    free()
    t0 = time.perf_counter()
    params = init_params(0, cfg, device=dev)
    toks = torch.as_tensor(np.random.default_rng(prompt_seed).integers(
        0, cfg.vocab, (batch, seq)).astype(np.int32), device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    finite = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, {"tokens": toks}, capacity)
        tok = torch.argmax(logits, -1).to(torch.int32)
        finite.append(torch.isfinite(logits).all())
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
        launches = _kernel_counts()

        def dc(p, t, pos, c):
            out, c = decode_step(p, cfg, t, pos, c)
            finite.append(torch.isfinite(out).all())
            return out, c

        t0 = time.perf_counter()
        out = decode_greedy(dc, params, tok, caches, seq, gen + 1).cpu().numpy()
        decode_s = time.perf_counter() - t0
        ring = _ring(caches)
        ring = None if ring is None else ring.cpu().numpy()
    row = {"run": run, "arch": cfg.name, "layers": cfg.n_layers, "batch": batch, "seq": seq,
           "capacity": capacity, "window": cfg.window, "setup_s": setup_s,
           "prefill_ms": prefill_ms, "decode_tokens": gen,
           "decode_ms_per_token": decode_s * 1e3 / gen, "tokens_per_s": batch * gen / decode_s,
           "prefill_peak_bytes": prefill_peak,
           "peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
           "prefill_launches": launches, "token_shape": list(out.shape),
           "logits_finite": bool(torch.stack(finite).all())}
    if ring is not None:
        last = seq + gen - 1  # the last decoded token's position
        row["ring"] = {"min": int(ring.min()), "max": int(ring.max()),
                       "slots_0_3": ring[:4].tolist(), "wrapped": seq >= capacity}
        # the ring holds exactly the last `capacity` positions (-1 in the
        # slots a short run left empty)
        held = list(range(max(0, last - capacity + 1), last + 1))
        row["ring_ok"] = sorted(ring.tolist()) == [-1] * (capacity - len(held)) + held
    del params, caches, logits
    free()
    emit(phase="path_j", **row)
    if not row["logits_finite"] or row["token_shape"] != [batch, gen + 1]:
        fail(f"path {run}: expected [{batch}, {gen + 1}] tokens from finite logits")
    if ring is not None and not row["ring_ok"]:
        fail(f"path {run}: the ring does not hold the last {capacity} positions")
    if dev.type == "cuda" and row["peak_bytes"] >= PEAK_LIMIT:
        fail(f"path {run}: peak {row['peak_bytes']} B over {PEAK_LIMIT}")
    return row


def path_j2(dev, batch=J2_BATCH, gen=J3_GEN, seq=None, variant="full"):
    """prefill_32k and decode_32k: stablelm-1.6b with use_flash, one node
    model, batch x 32,768 tokens into caches of capacity 32,768 (flash once
    a layer, full causal), then `gen` tokens (decode_32k's step, plain)."""
    from repro_torch.configs import INPUT_SHAPES, cache_capacity, config_for_shape, get_config

    shape = INPUT_SHAPES["prefill_32k"]
    cfg = config_for_shape(get_config("stablelm-1.6b", variant), shape).replace(use_flash=True)
    seq = seq or shape.seq_len
    row = serve_shape(dev, cfg, batch, seq, min(seq, cache_capacity(cfg, shape)), gen, "J2+J3")
    row["reduced"] = {"global_batch": {"prefill_32k": [32, batch], "decode_32k": [128, batch]}}
    want = cfg.n_layers if dev.type == "cuda" else 0
    if row["prefill_launches"]["flash"]["tensor_cores"] != want:
        fail(f"path J2: expected {want} flash launches of the tensor-core variant")
    return row


def path_j4(dev, seq=J_LONG, gen=J4_GEN, variant="full", runs=J4):
    """long_500k at batch 1 through `config_for_shape` (a 4096-token window
    on stablelm-1.6b and on zamba2-1.2b's shared attention; mamba2-1.3b
    native): a prefill of `seq` tokens into ring caches of
    `cache_capacity`, then `gen` tokens past the ring's wrap.  Flash once
    an attention site (its window branch), SSD once a Mamba2 layer."""
    from repro_torch.configs import INPUT_SHAPES, cache_capacity, config_for_shape, get_config
    from repro_torch.models.model import layer_groups

    shape = INPUT_SHAPES["long_500k"]
    rows = {}
    for run, arch, flags in runs:
        cfg = config_for_shape(get_config(arch, variant), shape).replace(**flags)
        rows[run] = row = serve_shape(dev, cfg, 1, seq, cache_capacity(cfg, shape), gen, run)
        groups = layer_groups(cfg)
        sites = sum(g.repeat for g in groups if g.pattern[0] in ("attn", "shared_block"))
        mamba = sum(g.repeat * g.pattern.count("mamba") for g in groups)
        want = ({"flash": sites if cfg.use_flash else 0,
                 "ssd": mamba if cfg.use_ssd_kernel else 0}
                if dev.type == "cuda" else {"flash": 0, "ssd": 0})
        got = {k: row["prefill_launches"][k]["tensor_cores"] for k in ("flash", "ssd")}
        row["want_launches"] = want
        if got != want:
            fail(f"path {run}: expected tensor-core launches {want}, got {got}")
    return rows


@contextlib.contextmanager
def _capture(module, name, store):
    """Record the arguments of the first call of ``module.name`` (a kernel
    wrapper the model calls through its module) while the block runs."""
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        if not store:
            store.append(([a.clone() if hasattr(a, "clone") else a for a in args], kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def path_j_parity(dev, seq=PARITY_J_SEQ, layers=PARITY_LAYERS):
    """J4's kernels against their plain versions on the card at 2 layers and
    full width, on a sub-sequence where the plain versions fit: the flash
    call of J4a's first layer (stablelm-1.6b, window 4096) and the SSD
    call of J4b's first layer (mamba2-1.3b, N = 128), both as the model
    makes them in a prefill of `seq` tokens, held within phase 2's
    tolerances (flash and SSD y: one floored bf16 ulp against the f32 plain
    version; SSD state: 1e-5 x scale); and each model's last-position
    logits through the kernels and through the plain route, in bf16."""
    import numpy as np
    import torch
    from repro_torch.configs import INPUT_SHAPES, config_for_shape, get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    from repro_torch.models import init_params, prefill

    shape = INPUT_SHAPES["long_500k"]
    rows = {}
    for run, arch, flags, module, name in (
            ("J4a", "stablelm-1.6b", dict(use_flash=True), flash_ops, "flash_attention"),
            ("J4b", "mamba2-1.3b", dict(use_ssd_kernel=True), ssd_ops, "ssd_intra_chunk")):
        cfg = config_for_shape(get_config(arch, "full"), shape).replace(n_layers=layers)
        params = init_params(0, cfg, device=dev)
        toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, seq)),
                               device=dev)
        calls = []
        with torch.inference_mode():
            with _capture(module, name, calls):
                kern = prefill(params, cfg.replace(**flags), {"tokens": toks}, seq)[0]
            plain = prefill(params, cfg, {"tokens": toks}, seq)[0]
        args, kwargs = calls[0]
        row = {"run": run, "arch": arch, "layers": layers, "seq": seq,
               "shapes": [list(a.shape) for a in args if hasattr(a, "shape")],
               "logit_rel_err": ((kern - plain).norm() / plain.norm()).item(),
               "argmax_agree": (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()}
        if run == "J4a":
            q, k, v = args
            got = flash_attention_cuda(q, k, v, window=kwargs["window"])
            want = attention_ref(q.float(), k.float(), v.float(), kwargs["window"])
            row["window"] = kwargs["window"]
            _hold("flash_attention", "parity-j4a", got, want,
                  attention_ref(q, k, v, kwargs["window"]), row)
        else:
            xc, dtc, cum, bc, cc, rep = args
            got, st = ssd_intra_chunk_cuda(xc, dtc, cum, bc, cc, rep)
            y_r, st_r = ssd_intra_chunk_ref(xc.float(), dtc, cum, bc.float(), cc.float(), rep)
            _hold("ssd_intra_chunk", "parity-j4b", got, y_r,
                  ssd_intra_chunk_ref(xc, dtc, cum, bc, cc, rep)[0], row)
            row["state_max_abs_err"] = (st - st_r).abs().max().item()
            if row["state_max_abs_err"] > 1e-5 * max(1.0, st_r.abs().max().item()):
                emit(phase="parity_j", **row)
                fail("parity J: the SSD state disagrees with its plain version")
        emit(phase="parity_j", **row)
        rows[run] = row
        del params, calls, args, kern, plain
        free()
    return rows


def m_dry_combos(runs=M_RUNS):
    """J5's path-M records, one a run of path M: (name, arguments)."""
    return tuple((f"M-{run}", ["-c", M_DRY_SCRIPT, "--layout", "x".join(map(str, layout)),
                               "--layers", str(layers or 0)])
                 for run, layout, layers, _, _ in runs)


def hold_m_dry(dev, m_rows, dry):
    """J5 on path M: each rank's peak of the tensor-parallel dense step
    within J5_PEAK_TOL of the dry run's per-device peak of the same step
    (on the card), and rank 0's collective bytes by use beside the dry
    run's.  Returns the misses."""
    misses = []
    for run, row in m_rows.items():
        rec = dry[f"M-{run}"]
        dry_peak = rec["per_device_memory"]["peak_bytes"]
        ranks = row["ranks"]
        got = {kind: {u: int(round(b)) for u, b in c["by_use"].items()}
               for kind, c in ranks[0]["collectives"].items()}
        emit(phase="path_j5_m", run=run, layout=row["layout"], layers=row["layers"],
             dry_per_device_peak_bytes=dry_peak,
             peaks=[r["peak_bytes"] for r in ranks],
             peak_ratios=[dry_peak / r["peak_bytes"] if r["peak_bytes"] else None
                          for r in ranks],
             gather_whole_peaks=[r["gather_whole_peak_bytes"] for r in ranks],
             dry_collective_bytes_by_use=rec["by_use"], collective_bytes_by_use=got,
             collective_bytes_equal=got == rec["by_use"], trace_s=rec["trace_s"])
        for r in ranks:
            if dev.type == "cuda" and abs(dry_peak / r["peak_bytes"] - 1) > J5_PEAK_TOL:
                misses.append(f"M-{run} rank {r['rank']}: dry run {dry_peak} B against the "
                              f"card's {r['peak_bytes']} B")
    return misses


def j5_combos():
    """J5's combos, the longest traces (J4b, J4c, then J1: 105, 83 and 43 s
    of tracing on the H100 machine's host) first, so that none starts
    last."""
    return J5[:3] + j5_t8_combos() + m_dry_combos() + J5[3:]


def path_j(dev, m_rows, dry_runs):
    """J1-J4 on the card, then the records of J5's dry runs (`dry_runs`,
    as `start_dryruns` returned it) beside what J1-J4 and path M
    measured."""
    rows = {}
    for name, fn in (("J1", path_j1), ("J2", path_j2), ("J4", path_j4)):
        t = time.perf_counter()
        rows[name] = fn(dev)
        emit(phase=f"path_{name.lower()}_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    rows["parity"] = path_j_parity(dev)
    emit(phase="parity_j_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    rows["J1-dry"] = path_j1_dry(dev)
    emit(phase="path_j1_dry_done", seconds=time.perf_counter() - t)
    dry, dry_s, waited_s = finish_dryruns(dry_runs)
    # J1's dry-run combo is the dry run's own step, which J1-dry ran on the
    # card (J1 runs the trainer's sparse step); the others size the runs
    measured = {"J1": (rows["J1-dry"]["seconds"], rows["J1-dry"]["peak_bytes"]),
                "J2": (rows["J2"]["prefill_ms"] / 1e3, rows["J2"]["prefill_peak_bytes"]),
                "J3": (rows["J2"]["decode_ms_per_token"] / 1e3, rows["J2"]["peak_bytes"])}
    for run in ("J4a", "J4b", "J4c"):
        r = rows["J4"][run]
        measured[run] = (r["prefill_ms"] / 1e3, r["prefill_peak_bytes"])
        measured[run + "-decode"] = (r["decode_ms_per_token"] / 1e3, r["peak_bytes"])
    misses = hold_m_dry(dev, m_rows, dry) if m_rows else []
    for name, rec in dry.items():
        if name.startswith("M-"):
            continue
        if name.startswith("T8-"):
            emit(phase="path_j5_t8", run=name, arch=rec["arch"], shape=rec["shape"],
                 kind=rec["kind"], global_batch=rec["global_batch"], layout=rec["layout"],
                 per_device_memory=rec["per_device_memory"], collective_bytes=rec["bytes"],
                 collective_bytes_by_use=rec["by_use"], collective_calls=rec["calls"],
                 gathered_over_model=rec["gathered_over_model"], trace_s=rec["trace_s"])
            continue
        secs, peak = measured[name]
        flops = rec.get("flops_band", rec["flops"])
        dry_peak = rec["memory"]["peak_bytes"]
        emit(phase="path_j5", run=name, arch=rec["arch"], shape=rec["shape"], kind=rec["kind"],
             variant=rec["variant"], reduced=rec.get("reduced"), flops_counted=rec["flops"],
             flops_kernel_route=flops, param_bytes=rec["param_bytes"],
             state_bytes=rec.get("state_bytes"), input_bytes=rec["input_bytes"],
             cache_bytes=rec["cache_bytes"], resident_bytes=rec["resident_bytes"],
             memory=rec["memory"], fits_one_card=rec["fits_one_card"],
             layout_8=rec["layout"], per_device_bytes_8=rec["per_device_bytes"],
             collective_bytes_8=rec["collective_bytes"],
             collective_bytes_total_8=rec["collective_bytes_total"],
             collective_bytes_by_use_8=rec.get("collective_bytes_by_use"),
             collective_calls_8=rec.get("collective_calls"),
             collective_m=rec.get("collective_m"), collective_note=rec.get("collective_note"),
             measured_s=secs, measured_peak_bytes=peak,
             peak_ratio=dry_peak / peak if peak else None,
             bf16_peak_share=flops / (secs * BF16_FLOPS), trace_s=rec["trace_s"],
             mem_trace_s=rec["mem_trace_s"], collective_trace_s=rec.get("collective_trace_s"))
        if name in J5_PEAK_RUNS and dev.type == "cuda" \
                and abs(dry_peak / peak - 1) > J5_PEAK_TOL:
            misses.append(f"{name}: dry run {dry_peak} B against the card's {peak} B")
    emit(phase="path_j5_done", at_s=time.perf_counter() - T0, seconds=dry_s,
         waited_s=waited_s, records=len(dry))
    if misses:
        fail(f"path J5: the dry run's peak is not within {J5_PEAK_TOL:.0%} of the card's:\n"
             + "\n".join(misses))
    if any(rec["collective_bytes"] is None for name, rec in dry.items()
           if not name.startswith(("T8-", "M-"))):
        fail("path J5: a record has no collective bytes")
    if any(rec["bytes"]["all_reduce"] <= 0 for name, rec in dry.items()
           if name.startswith("T8-")):
        fail("path J5: a sharded serving record at a model axis of 8 all-reduced nothing")
    return rows


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, SRC)
    os.environ.pop("REPRO_TORCH_GOSSIP_IMPL", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    # path F's image sets (set-up: ~20 s of numpy on the card's host) are
    # made in the background while the kernels build and paths A-E run
    pool = concurrent.futures.ThreadPoolExecutor(2)
    data = {"F3": pool.submit(images, FMNIST), "F4": pool.submit(images, CIFAR)}
    pool.shutdown(wait=False)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    emit(phase="env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0))
    build_s = _build.build()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln
                 or "Performance Loss" in ln]
             for k, v in _build.BUILD_LOG.items()}
    from repro_torch.kernels.flash_attention.kernel import tc_smem_bytes as flash_smem
    from repro_torch.kernels.ssd_scan.kernel import tc_smem_bytes as ssd_smem

    # dynamic shared memory of a tensor-core block (ptxas counts static only)
    smem = {"flash_tc_kernel<64>": flash_smem(64), "flash_tc_kernel<128>": flash_smem(128),
            "ssd_tc_kernel path C": ssd_smem(128, 64, 64),
            "ssd_tc_kernel mamba2-1.3b": ssd_smem(128, 64, 128)}
    emit(phase="build", seconds=build_s, ptxas=ptxas, tc_dynamic_smem_bytes=smem)
    t = time.perf_counter()
    gossip = check_gossip(dev)
    pme_row, pme_fc1 = check_pme(dev)
    pme_range = check_pme_range(dev)
    flash, flash_i3, flash_l2 = check_flash(dev)
    check_flash_j2(dev)
    flash_long = check_flash_long(dev)
    ssd, ssd_n128, ssd_l2 = check_ssd(dev)
    lane_rows = check_lanes(dev)
    emit(phase="kernels_checked", seconds=time.perf_counter() - t)
    # J5's dry runs trace on the host from here on, beside paths A-I
    dry_runs = start_dryruns(torch.cuda.get_device_properties(0).total_memory, j5_combos())

    t = time.perf_counter()
    gossip_launches = path_a()
    emit(phase="path_a_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    pme_launches = path_b(dev)
    emit(phase="path_b_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    parity(dev)
    emit(phase="parity_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    serve_launches = path_c(dev)
    emit(phase="path_c_total", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    baselines = path_d()
    emit(phase="path_d_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    path_d_compressed(dev)
    emit(phase="path_d_compressed_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    path_d_parity(dev)
    emit(phase="parity_d_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    e_rows, e_launches = path_e()
    emit(phase="path_e_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    path_e_parity(dev)
    emit(phase="parity_e_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    _, f_launches = path_f(dev, data)
    emit(phase="path_f_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    path_f_parity(dev)
    emit(phase="parity_f_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    g_launches = path_g1(dev)
    emit(phase="path_g1_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    g_launches += path_g2(dev)
    emit(phase="path_g2_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    path_g_parity(dev)
    emit(phase="parity_g_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    h1 = path_h1(dev)
    emit(phase="path_h1_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    h1dyn = path_h1dyn(dev, h1)
    emit(phase="path_h1dyn_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    h_rows, h_launches = path_h(dev, data)
    emit(phase="path_h_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    path_h_parity(dev)
    emit(phase="parity_h_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    _, i_gossip, i_flash = path_i(dev)
    emit(phase="path_i_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    _, r_launches = path_repeat(dev, data)
    emit(phase="path_repeat_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    resume = path_resume(dev)
    emit(phase="path_resume_done", seconds=time.perf_counter() - t)
    r_launches = {k: v + resume["launches"][k] for k, v in r_launches.items()}
    t = time.perf_counter()
    k_launches = path_k(dev)
    emit(phase="path_k_total", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    l_launches = path_l(dev)
    emit(phase="path_l_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    m_rows, m_launches = path_m(dev)
    emit(phase="path_m_total", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    _, n_launches = path_n(dev)
    emit(phase="path_n_total", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    j = path_j(dev, m_rows, dry_runs)
    emit(phase="path_j_done", seconds=time.perf_counter() - t)
    tc = lambda r, k: r["prefill_launches"][k]["tensor_cores"]  # noqa: E731
    j_gossip = j["J1"]["gossip_variant_launches"]["f32"]
    j_flash = tc(j["J2"], "flash") + tc(j["J4"]["J4a"], "flash") + tc(j["J4"]["J4c"], "flash")
    j_ssd = {run: tc(j["J4"][run], "ssd") for run in ("J4b", "J4c")}
    # path H's f32 launches (H1, H1dyn, H2 static and dynamic, H4); those on
    # lane-offset tables (H1, H1dyn, and H2, H2dyn and H4 at 5 lanes) are the
    # f32_lanes variant's
    h1_f32 = h1["gossip_variant_launches"]["f32"] + h1dyn["gossip_variant_launches"]["f32"]
    h_f32 = h1_f32 + h_launches["f32"]
    h_folded = h1_f32 + sum(r["launches"]["f32"] for r in h_rows.values() if r["folded"])
    bf16_launches = sum(r["gossip_launches"]["bf16"] for r in baselines.values())
    # each path's launches, read just after the path ran with the counts at 0
    f32_launches = (gossip_launches + e_launches["f32"] + f_launches["f32"] + g_launches
                    + h_f32 + i_gossip + j_gossip + r_launches["f32"] + k_launches["f32"]
                    + m_launches["f32"] + n_launches["f32"])
    bf16_launches += e_launches["bf16"] + f_launches["bf16"]
    pme_launches += e_launches["pme_average"] + f_launches["pme_average"] \
        + h_launches["pme_average"] + r_launches["pme_average"] + k_launches["pme_average"] \
        + m_launches["pme_average"] + n_launches["pme_average"]

    def entry(name, source, replaces, launches, row):
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"]}
        if "variant" in row:
            e["variant"] = row["variant"]
        if "device_ms" in row:
            e["device_ms"] = row["device_ms"]
        return e

    def variant(launches, row):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "case",
                "device_ms")
        return {k: row[k] for k in keys if k in row} | {"launches": launches}

    g32 = entry("gossip_gather", "src/repro_torch/csrc/gossip_gather.cu",
                "src/repro/kernels/gossip/kernel.py:95", f32_launches + bf16_launches,
                gossip["f32"])
    # top-level times are the f32 variant's (path A); each variant's own
    # launches (f32: paths A, E1, E4; bf16: paths D, E3, E5, E6) and times
    g32["variants"] = {"f32": variant(f32_launches, gossip["f32"]),
                       "bf16": variant(bf16_launches, gossip["bf16"])}
    # the replica mixes of E5 and E6 (among the bf16 launches), timed at
    # E5's largest held leaf: 16 sender rows into 4 receivers
    rep_launches = sum(r["gossip_launches"]["bf16"] for k, r in e_rows.items()
                       if k.split("-")[0] in ("E5", "E6"))
    g32["variants"]["bf16_replicas"] = variant(rep_launches, gossip["bf16_replicas"])
    # path F's f32 launches (F1 race, F2, F3 D-PSGD and wide CNN), timed at F3's fc1
    g32["variants"]["f32_path_f"] = variant(f_launches["f32"], gossip["f32_fc1"])
    # path R's f32 launches (the repeat phase's I1 and H2dyn runs, the
    # resume's three trainer runs; among the f32 launches), timed at path
    # A's largest leaf (the resume's model at 2 layers)
    g32["variants"]["f32_path_r"] = variant(r_launches["f32"], gossip["f32"])
    # path G's f32 launches (G1 at full depth, G2 at 2 layers; among the f32
    # launches), timed at the largest training leaf on G1's grown 5-node graph
    g32["variants"]["f32_path_g"] = variant(g_launches, gossip["f32_grown"])
    # the f32 launches on lane-offset tables (H1 at 2 lanes, H2 at 5; among
    # the f32 launches), timed at H1's largest leaf folded over 2 lanes
    g32["variants"]["f32_lanes"] = variant(h_folded, lane_rows["gossip_f32_lanes"])
    # path I1's f32 launches (deepseek-v2-lite-16b; among the f32 launches),
    # timed at its largest leaf, the routed experts of its 2 MoE layers
    g32["variants"]["f32_path_i"] = variant(i_gossip, gossip["f32_path_i"])
    # path J1's f32 launches (train_4k on path A's model; among the f32
    # launches), timed at the same largest leaf as path A
    g32["variants"]["f32_path_j"] = variant(j_gossip, gossip["f32"])
    # path K's f32 launches (the sparse exchange's unsharded and sharded
    # steps, the sharded one over the gathered sender stack; among the f32
    # launches), timed at path A's largest leaf
    g32["variants"]["f32_path_k"] = variant(k_launches["f32"], gossip["f32"])
    # path M's f32 launches (the sparse exchange on the ranks sharing the
    # card, both routes; among the f32 launches), timed at a rank's piece
    # of path A's largest leaf
    g32["variants"]["f32_path_m"] = variant(m_launches["f32"], gossip["f32_path_m"])
    # path N's f32 launches on its two ranks (the sparse network case, each
    # rank's two receivers over the gathered sender stack; among the f32
    # launches, with the parent's unsharded ones at row 2's shape), timed at
    # rank 1's receivers of path N's largest leaf
    g32["variants"]["f32_path_n"] = variant(n_launches["f32_ranks"], gossip["f32_path_n"])
    pme = entry("pme_average", "src/repro_torch/csrc/pme_average.cu",
                "src/repro/kernels/pme_average/kernel.py:46", pme_launches, pme_row)
    # path F's launches (F3 PaME on fc1, F4 on five ResNet-20 convs), timed at F3's fc1
    pme["variants"] = {"path_f": variant(f_launches["pme_average"], pme_fc1),
                       # path R's launches (the repeat phase's F3 and F4
                       # runs), timed at F3's fc1
                       "path_r": variant(r_launches["pme_average"], pme_fc1),
                       # H3's launches, all with the lane axis, timed at H3's
                       # largest leaf over its 5 lanes
                       "lanes": variant(h_launches["pme_average"], lane_rows["pme_lanes_h3"]),
                       # path K's launches with a receiver range (the dense
                       # exchange's sharded step on its one rank), timed at
                       # their own form, row 1rk: r = m = 4 of path A's
                       # largest leaf in f32
                       "receivers": variant(k_launches["pme_average_range"],
                                            pme_range["1rk-r4"]),
                       # path M's launches (the dense exchange on the ranks
                       # sharing the card, every one with its receiver range
                       # r = m), timed at their own form, row 1rm
                       "path_m": variant(m_launches["pme_average_range"], pme_range["1rm-r4"]),
                       # path N's launches on its ranks (the dense network
                       # case, receiver range r = 2 of m = 4), rank 0's at
                       # r0 = 0 and rank 1's at r0 = 2, each timed at its
                       # own form, row 1rn
                       "path_n_r0_0": variant(n_launches["pme_average_range_r0"][0],
                                              pme_range["1rn-r2@0"]),
                       "path_n_r0_2": variant(n_launches["pme_average_range_r0"][2],
                                              pme_range["1rn-r2@2"])}
    l_flash = {row: n["flash"] for row, n in l_launches.items()}
    l_ssd = {row: n["ssd"] for row, n in l_launches.items()}
    fa = entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:78",
               serve_launches["flash"] + i_flash + j_flash + sum(l_flash.values()), flash)
    # top-level times are path C's shape; path I3's launches (qwen3-14b) at
    # its own; path J's (J2 full causal at 32,768, J4a and J4c windowed at
    # 524,288) at J4a's windowed attention, row 4w; path L's whole-head
    # launches (L1, L2's unsharded references) at path C's and I3's shapes,
    # a rank's half of the heads at L2's own (rows 4h, 4qh)
    fa["variants"] = {"path_c": variant(serve_launches["flash"], flash),
                      "path_i": variant(i_flash, flash_i3),
                      "path_j": variant(j_flash, flash_long["4w"]),
                      "path_l": variant(l_flash["path-c"], flash),
                      "path_l_i3": variant(l_flash["path-i3"], flash_i3),
                      "path_l2_zamba2": variant(l_flash["path-l2-zamba2"],
                                                flash_l2["path-l2-zamba2"]),
                      "path_l2_qwen3": variant(l_flash["path-l2-qwen3"],
                                               flash_l2["path-l2-qwen3"])}
    sd = entry("ssd_intra_chunk", "src/repro_torch/csrc/ssd_intra_chunk.cu",
               "src/repro/kernels/ssd_scan/kernel.py:53",
               serve_launches["ssd"] + sum(j_ssd.values()) + sum(l_ssd.values()), ssd)
    # top-level times are path C's chunk (N = 64, row 5); J4b's launches at
    # mamba2-1.3b's N = 128 (row 6), J4c's (zamba2-1.2b) at row 5's, path
    # L's whole-head launches at row 5's, a rank's half at L2's own (row 5h)
    sd["variants"] = {"path_c": variant(serve_launches["ssd"], ssd),
                      "path_j4b_n128": variant(j_ssd["J4b"], ssd_n128),
                      "path_j4c": variant(j_ssd["J4c"], ssd),
                      "path_l": variant(l_ssd["path-c"], ssd),
                      "path_l2_zamba2": variant(l_ssd["path-l2-zamba2"], ssd_l2)}
    kernels = [g32, pme, fa, sd]
    emit(phase="total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
