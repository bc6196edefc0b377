#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card, exits 0 on success

Phases (each raises on failure; the script then exits non-zero):

1. card: prints ``nvidia-smi --query-gpu=name,power.limit`` for the card.
2. build: compiles the hand-written CUDA kernels from the sources in the
   checkout (``bluefog_tpu_torch/parallel/csrc``) and prints the seconds and
   ptxas's register, spill, warning and performance-loss lines for each
   kernel.
3. kernels: each kernel (K1 forward, K2 dq, K3 dk/dv) against its plain
   PyTorch version on the card in bf16, B=1 H=16 D=128 S=1024, causal on
   and off, offsets (0,0), (S,0), (0,S), (64,0), (0,64), (37,0); Sq=1024
   against Sk=640; a ragged S with D=64; D=64 at S=8192. Then at the main
   path's shape (S=8192): the errors, a repeat launch of K1, K2 and K3 that
   must match bit for bit, each kernel's time (CUDA events), its plain
   version's time, the bound (``kernel_bounds``), and the time of
   ``scaled_dot_product_attention`` as a yardstick.
4. train: the port's main path — ``bf.init()`` (NCCL, world 1), the flash
   ``TransformerLM`` at the repo's headline width (d_model 2048, 16 heads
   of 128, d_ff 8192, vocab 32768, bf16 compute, f32 params) under
   ``DistributedNeighborAllreduceOptimizer`` around Adam (lr 1e-3), batch
   1 x 8192 tokens, 2 warm-up and 5 timed steps. The launch counts are set
   to 0 just before and read just after; each kernel must show ``LAYERS``
   launches per step. Before that, a small model checks flash logits and
   gradients against dense attention on the card.
5. context, at the main path's shape (bf16, causal, S=8192): (a) a
   virtual ring of 4 ranks of 2048 tokens, the port's own ring step
   functions in lock-step with Python lists rolled for the rotation,
   against ``flash_attention`` over the whole sequence (output, dq, dk, dv
   within ``TOL_RING``; 16 launches of each kernel; two planted faults
   beyond the limit; each direction's ms summed over the virtual ranks
   beside the full-sequence kernels'); (b) the headline LM with
   ``ring_attention_shard(causal=True, use_flash=True)`` as its attention
   at world 1 (NCCL) under plain Adam, 2 warm-up and 5 timed steps:
   ms/step, tokens/s, peak memory, losses equal to the train phase's
   (``TOL_RING_LOSS``), ``LAYERS`` launches of each kernel per step; (d)
   ``checkpoint.save``, ``save_async`` + ``wait_pending`` and ``restore``
   of that LM's Adam state in a temporary directory the phase removes:
   bytes, seconds, the sidecar, and a restored run bit-identical to the
   original after one more step each; (c) ``cp_loss_fn`` with the einsum
   ring and with Ulysses on the headline model, two Adam steps each: the
   first loss against dense ``lm_loss`` (``TOL_CP_LOSS``), ms/step and
   peak memory (the dense f32 score blocks are 4 GiB each).
6. optimizers (world 1, NCCL): (a) the collectives surface on a
   ``[4096, 2048]`` tensor in f32 and bf16 (``allgather``, ``allgather_v``,
   ``neighbor_allgather``, ``pair_gossip`` with itself at 0.75/0.25,
   ``hierarchical_neighbor_allreduce``, the hierarchical-local
   ``allreduce``, the in-place ``_`` forms and one ``*_nonblocking`` form
   of each kind through ``poll``/``synchronize``), each at max abs error 0
   from its closed form, a second ``synchronize`` raising; (b) the headline
   LM under ``DistributedShardedAllreduceOptimizer`` (ZeRO-1) around Adam,
   2 warm-up and 5 timed steps: ms/step, tokens/s, peak memory, falling
   losses, ``LAYERS`` launches of each kernel per step; (c) 3 steps each
   of ``DistributedGradientAllreduceOptimizer`` twice (the card's
   run-to-run floor) and of ZeRO-1 from the same seed, the largest
   per-tensor parameter difference within ``TOL_ZERO1``, and a planted
   fault (the updated shard written back shifted by one element) beyond
   it; (d) ``DistributedHierarchicalNeighborAllreduceOptimizer`` against
   ``DistributedNeighborAllreduceOptimizer`` the same way; (e) NCCL's
   ``reduce_scatter`` and ``all_gather`` of the 335,562,752-element f32
   buffer (out of place and in place, as the step runs them), CUDA events,
   beside the copy bound.
7. ce check: ``chunked_ce_loss`` against the full-logits ``lm_loss`` on the
   headline model in bf16, one batch: the loss and every gradient within
   ``TOL_CE_*``; one chunk's targets rolled by one position must land
   beyond a limit.
8. lm_bench: ``python -m bluefog_tpu_torch.lm_bench``'s ``run`` at its
   defaults (the headline, plain Adam, 3 warm-up and 20 timed steps) in
   three forms: full logits, ``--chunked-ce``, ``--remat --chunked-ce``.
   Each prints its JSON line (ms/step, tokens/s, mfu against the H100's
   bf16 peak) and its peak memory; each kernel must launch ``LAYERS`` times
   a step (K1 twice that under remat), and the chunked forms must peak
   below the full-logits form.
9. moe: (a) a small bf16 MoE LM, flash against dense attention (the
   share of tokens routed apart, then logits and gradients over the tokens
   routed alike); (b) a SwitchFFN in f32 on the card against the CPU; (c)
   the MoE LM at the headline width (8 experts, blocks 1 and 3 MoE) under the
   decentralized optimizer with ``chunked_ce_loss``, 2 warm-up and 5 timed
   steps: ms/step, tokens/s, mfu, peak memory, falling losses, ``LAYERS``
   launches of each kernel per step.
10. experts: (a) a virtual expert-parallel group of 8 ranks of 1024 tokens
   at the headline MoE width (d 2048, d_ff 8192, E 8, bf16): the package's
   local steps (``switch_send``, ``expert_ffn``, ``switch_combine``) for
   every virtual rank, the lists transposed for each all-to-all, against
   the dense ``SwitchFFN`` oracle: outputs and the gradients of x, gate, up
   and down at capacity factor 8 within ``TOL_EP``; at 2.0 the kept tokens
   within it, the dropped ones exactly 0 and their count the routing's; a
   planted fault beyond it; each direction's ms summed over the virtual
   ranks beside the oracle's. (b) The expert-parallel MoE LM at the
   headline width, world 1 (E=1, blocks 1 and 3 MoE), ``ep_lm_loss_fn``
   with flash attention under plain Adam, 2 warm-up and 5 timed steps:
   the first loss against the dense E=1 model's (``TOL_EP_LOSS``),
   ms/step, tokens/s, peak memory, ``LAYERS`` launches of each kernel per
   step. (c) The examples at world 1: ``benchmark.py`` at its defaults,
   ``resnet.py`` with a checkpoint and a resume, ``moe.py --experts 1``,
   ``mnist.py`` (one epoch), ``average_consensus.py``, ``optimization.py``
   for each method, and ``resnet_from_torch`` on a ResNet-50 checkpoint in
   torchvision's names (eval logits bit-identical to the source model's).
11. parallel, at the headline width: (a) a virtual tensor-parallel group
   of 4 (each rank 4 heads, d_ff 2048, vocab 8192, embedding features
   512; ``tensor.tp_logits`` over the list of the ranks' models, sums for
   the all-reduces and cats for the all-gathers) against the dense flash
   model: logits and every rank's gradient within ``TOL_TP``, 16 launches
   of each kernel per forward and backward, two planted faults beyond the
   limit, each direction's ms summed over the virtual ranks beside the
   dense model's. (b) A virtual pipeline of 4 stages (one layer each, 4
   microbatches of 1 x 8192; the tick schedule with the handoff a list
   roll) against the dense model on the same 4 sequences: logits and every
   stage's and ``rest``'s gradient within ``TOL_PP``, the plain and fused
   losses against ``lm_loss`` within ``TOL_PP_LOSS``, launches, a planted
   fault, ms and peak memory of each form. (c) World 1 on NCCL:
   ``tp_loss_fn`` under plain Adam (losses bit-identical to plain Adam on
   ``lm_loss``) and ``pp_train_step_fn`` on 2 x 8192 in 2 microbatches,
   plain and fused (``TOL_PP_LOSS``, ``TOL_PP_TRAIN``), 2 warm-up and 5
   timed steps each: ms/step, tokens/s, peak memory, launches; a planted
   fault (each step trained on the first microbatch alone) beyond
   ``TOL_PP_TRAIN``.
12. vision: ResNet-50 at full width (1000 classes, 224x224), the model of
   ``python -m bluefog_tpu_torch.bench``. A check of the bf16
   ``channels_last`` model against the same weights in f32 on the card
   (logits, every gradient, the BN buffers after one train-mode forward;
   ``fold_bn=True`` against unfolded eval logits), then the benchmark's own
   step (``bench.setup()``: batch 128, ``DistributedNeighborAllreduceOptimizer``
   around SGD 0.1/0.9, 10 warm-up and 100 timed steps) with img/s per card,
   ms/step, peak memory and falling losses, then 20 steps fed from host
   uint8 batches through ``prefetch_to_device``. Convolutions, BN and
   pooling are cuDNN's and PyTorch's: this path launches none of K1-K3.
13. observability, on the main path (world 1, NCCL): (a) the headline LM,
   2 warm-up and 5 steps under ``start_timeline``: the trace is chrome
   JSON whose first event is the clock anchor and which holds 7 balanced
   ``STEP`` spans under the optimizer's name; ``metrics.snapshot()`` shows
   the ``opt.step`` gauge and the ``opt.step_sec`` count at 7;
   ``step_report()`` reports step 7 and its ``step_sec`` within
   ``OBS_STEP_TOL_MS`` of the trace's last ``STEP``; ``prometheus_text()``
   parses line by line; ``flight_dump()`` reads back through
   ``pack_dump``/``unpack_dump`` and ``analyze_dump``; each kernel launches
   ``LAYERS`` times a step. Prints the trace's events and bytes and the
   flight ring's records per step. (b) ``torch.profiler`` over one step
   (after one under the profiler's warm-up): every K1-K3 launch inside
   the ``<name>.STEP`` range, and the planted bare ``loss.backward()``
   trace must fail that check. (c) In a fresh
   job, a step fed targets of half the sequence raises ``ValueError`` and
   leaves ``bf_flight_<rank>.json`` under ``BFT_FLIGHT_DIR`` with the
   ``fatal.opt.step`` instant. (d) Collection only against the timeline
   plus a 1 s Prometheus publisher, in alternating blocks: the LM (5 steps
   a block, on/off within ``OBS_LM_RATIO``) and ``bench.setup()``'s
   ResNet-50 step (20 a block, recorded), ms/step and host issue ms.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke.json")

# the main path: the repo's LM headline (scripts/lm_bench.py:128-145) at its
# own depth, one sequence of SEQ tokens, WARMUP untimed then STEPS timed steps
LAYERS = 4
SEQ = 8192
WARMUP = 2
STEPS = 5

# H100 SXM data-sheet peaks (dense): bf16 tensor cores (the peak that
# ``lm_bench``'s mfu divides by), HBM3 bandwidth.
from bluefog_tpu_torch.lm_bench import H100_BF16_PEAK as PEAK_BF16  # noqa: E402
PEAK_BYTES = 3.35e12

# kernel checks in bf16 against the plain versions. The forward rounds p to
# bf16 at another row max than its plain version (running vs final), so its
# error is a few bf16 ulps of o/l. The backward kernels run every product in
# bf16 (g, P and dS rounded; the plain version keeps g, P and dp in f32), so
# max|err| / max|plain| is a few ulps of the largest value; measured on an
# H100 (PERF.md): o/l <= 1.8e-3, dq/dk/dv <= 5.9e-3, m 2.9e-6, l 2.6e-6
# relative. A missing alpha rescale or a dropped K tile moves m, l or o/l by
# orders of magnitude more.
TOL_FWD = 5e-3      # max |o/l - plain o/l|, S=1024 and S=8192
TOL_BWD = 1e-2      # normalised dq, dk, dv, S=1024 and S=8192
TOL_M = 1e-4        # row max of the scores (f32 accumulation both sides)
TOL_L = 1e-4        # relative row sum
TOL_MODEL = 5e-2    # flash vs dense logits, bf16 model, max|err|/max|ref|

# the vision phase: ResNet-50 at full width (1000 classes, 224x224), the
# model of ``bluefog_tpu_torch/bench.py``. The check runs VISION_BATCH images
# through the bf16 channels_last model and through the same weights in f32
# (TF32 off); each error is max|bf16 - f32| / max|f32|, for the gradients
# per parameter tensor (one the bf16 backward leaves without a gradient
# reads 1) and for the BN buffers on what one train-mode forward moved them
# by. The fold compares f32 eval logits of ``fold_bn=True`` (weights from
# ``fold_batchnorm``) with the unfolded model's. Measured on an H100
# (PERF.md): logits 9.0e-3, gradients max 0.61 (a BN scale) / median 0.36
# per tensor and 0.20 in L2 over all of them, BN statistics 1.2e-2, fold
# 3.3e-7. bf16 gradients of a random-init ResNet are that far from f32 in
# flax too once XLA rounds at every bf16 op, as eager PyTorch does
# (``scripts/torch_port_bf16_grad_probe.py``). The limits sit 1.4-2x above
# the measured values, the gradient max below 1. The check holds the card's
# bf16 route to its f32 one, so a fault common to both is the CPU tests'
# to catch (against flax); it must catch each of VISION_FAULTS, planted in
# the bf16 model alone.
VISION_BATCH = 8
TOL_VISION_LOGITS = 2e-2
TOL_VISION_GRAD = 0.9          # per tensor, the largest
TOL_VISION_GRAD_MEDIAN = 0.5   # per tensor, the median
TOL_VISION_GRAD_L2 = 0.3       # all gradients as one vector
TOL_VISION_STATS = 2.5e-2
TOL_VISION_FOLD = 1e-5
# the faults: block 8's residual branch dropped; the input's H and W
# swapped (a wrong permute); block 8's branch cut out of the backward alone
# (its output detached, the forward unchanged)
VISION_FAULTS = ("drop_branch", "swap_hw", "detach_branch")
HOST_DATA_STEPS = 20

# the ce check: ``chunked_ce_loss`` (chunks of CE_CHUNK tokens) against the
# full-logits ``lm_loss`` on the headline model (bf16, seed 0) and one batch,
# both through the flash kernels: the loss's relative error, and each
# parameter gradient's max|chunked - full| / max|full| (the largest over the
# tensors) and the relative L2 of all of them as one vector. Both compute the
# same bf16 products; cuBLAS may take another algorithm for a 1024-row chunk
# than for 8192 rows, and the chunks' bf16 lm_head gradients are summed in
# bf16. Measured on an H100 (PERF.md): loss 8.8e-8 (one f32 ulp of 10.88),
# gradient max 1.03e-2, L2 1.19e-3; the limits sit 2-23x above. The planted
# fault (one chunk's targets rolled by one position) must land beyond a
# limit: it read loss 6.9e-5, gradient max 0.34, L2 0.25.
CE_CHUNK = 1024
TOL_CE_LOSS = 2e-6
TOL_CE_GRAD = 2.5e-2
TOL_CE_GRAD_L2 = 3e-3

# the MoE phase. (a) a small bf16 MoE LM (E=4), flash against dense
# attention: the router's logits are bf16, so two experts' logits often tie
# and a token can go either way under the two attentions (1-5 of 640 tokens
# at every seed tried on the CPU's plain flash, 2 on the H100); the share
# routed apart is held to TOL_ROUTED_APART (a wrong router sends most tokens
# elsewhere), and the loss over the tokens routed alike, its gradients and
# those tokens' logits to TOL_MODEL. (b) one SwitchFFN in f32 on the card
# (TF32 off) against the same weights on the CPU, output and gradients
# normalised as ``nerr`` (measured 9.6e-7 and 8.2e-7), identical routing.
# (c) the MoE LM at the headline width (E=8, the package's default, blocks
# 1 and 3 MoE) trained with ``chunked_ce_loss`` under the decentralized
# optimizer.
MOE_EXPERTS = 8
TOL_ROUTED_APART = 2e-2
TOL_SWITCH = 1e-5

# the experts phase. (a) A virtual expert-parallel group of EP_N ranks of
# EP_TOKENS tokens at the headline MoE width (d 2048, d_ff 8192, E = EP_N,
# bf16 compute, f32 parameters): the package's local steps (``switch_send``,
# ``expert_ffn``, ``switch_combine``) for every virtual rank in one process,
# the lists transposed for each all-to-all, against the dense ``SwitchFFN``
# oracle on the same weights, run rank by rank so that the router's
# products have the virtual ranks' shapes and route alike (checked). The
# tokens share an offset that raises expert 0's router logit by EP_SKEW
# (the others' logits are N(0, 1)), so expert 0 draws more than its
# capacity at EP_DROP_FACTOR and drops tokens on every rank.
# At capacity factor EP_N nothing drops: the outputs and the gradients of
# x, gate, up and down as ``nerr`` within TOL_EP. At EP_DROP_FACTOR the kept
# tokens within TOL_EP, the dropped ones exactly 0, their count equal to the
# count from the routing (each expert's tokens past its capacity, in token
# order). The planted fault (rank 0's buffer for its busiest expert
# delivered to the next expert) must land beyond TOL_EP. (b) The
# expert-parallel MoE LM at the headline width at world 1 (E = 1: one
# expert per rank is the only layout;
# blocks 1 and 3 MoE), ``ep_lm_loss_fn`` with flash attention under plain
# Adam: the first loss against the dense-mode E = 1 model on the same
# weights (``lm_loss`` plus the aux term, exactly 1 per MoE layer at E = 1),
# relative, within TOL_EP_LOSS. (c) The examples at world 1 on the card.
EP_N = 8
EP_TOKENS = 1024
EP_DROP_FACTOR = 2.0
EP_SKEW = 1.0
EP_FAULTS = ("wrong_expert",)
# measured on an H100 (PERF.md): out, dx and dgate 0 (each output row is
# the same bf16 products in both), dup 3.2e-3-4.2e-3 and ddown
# 3.7e-3-4.1e-3 (the weight gradients sum the tokens in another order);
# the planted fault read 0.83-0.92
TOL_EP = 1e-2
# (b) measured 1.3e-7 (one f32 ulp of the loss): at E=1 the dispatch is a
# copy and the expert the dense FFN on twice the rows
TOL_EP_LOSS = 1e-6

# the parallel phase, at the headline width (bf16 compute, f32 parameters,
# flash attention). (a) A virtual tensor-parallel group of TP_N ranks: each
# holds its slices (4 heads, d_ff 2048, vocab 8192, embedding features 512),
# and the port's step functions (``tensor.tp_logits`` over a list of the
# ranks' models) run them in lock-step, a sum over the list standing for
# each all-reduce and a cat for each all-gather, on B=1 x SEQ tokens. The
# logits and every rank's gradient of every parameter (sum of the ranks'
# losses, each the dense loss) against the dense flash model's, sliced to
# the rank, as ``nerr`` within TOL_TP: each row-parallel product is TP_N
# bf16 partial products summed and rounded again where the dense model
# rounds one product. TP_N * LAYERS launches of each kernel (at H = 4) per
# forward and backward. Planted faults: qkv sliced as contiguous rows (not
# each rank's heads), and one rank's row-parallel partial left out of the
# sum. (b) A virtual pipeline of PP_N stages, one layer each, over PP_N
# sequences of SEQ in PP_N microbatches of one: the port's tick schedule
# (``pipeline.pp_schedule`` / ``pp_fused_schedule``) with the handoff a
# roll of the list, against the dense model on the same sequences: logits
# and every stage's and ``rest``'s gradient within TOL_PP, the plain and
# fused losses against ``lm_loss`` within TOL_PP_LOSS (relative); the
# handoff rolled the wrong way must land beyond TOL_PP. (c) World 1 on
# NCCL: ``tp_loss_fn`` under plain Adam on the headline batch, each loss
# bit-identical to plain Adam on ``lm_loss`` from the same seed (n = 1: the
# same ops); ``pp_train_step_fn`` on PP_TRAIN_B x SEQ with PP_TRAIN_M
# microbatches, plain and fused, against plain Adam on ``lm_loss``: the
# first loss (same weights; the microbatch mean reassociates) within
# TOL_PP_LOSS, every loss within TOL_PP_TRAIN (relative): the weight
# gradients are bf16 products per microbatch summed in f32, where the dense
# step sums both sequences inside one bf16 product, and Adam carries the
# difference into the later steps. The planted fault (each step trained on
# the first microbatch alone, its loss read over the whole batch) must land
# beyond TOL_PP_TRAIN.
TP_N = 4
PP_N = 4
PP_TRAIN_B = 2
PP_TRAIN_M = 2
TP_FAULTS = ("contiguous_qkv", "drop_partial")
PP_FAULTS = ("handoff_backwards",)
# predicted before their first run on the card; measured on an H100
# (PERF.md): logits 8.4e-3, gradients 1.0e-2 (TP); logits 0, gradients
# 4.6e-3, losses 0 (PP); the PP training losses within 5.1e-4, the first
# within 8.8e-8 (about one f32 rounding of a loss near 10.9)
TOL_TP = 5e-2
TOL_PP = 2e-2
TOL_PP_LOSS = 1e-6
TOL_PP_TRAIN = 5e-3

# the optimizers phase. (a) every op at world 1 against its closed form in
# plain torch on OPS_SHAPE, exactly. (c) and (d): the largest over the
# parameter tensors of |a - b|_2 / |b - p0|_2 after OPT_CHECK_STEPS Adam
# steps from one seed (p0 the initial parameters): the difference of two
# runs against the distance the reference run moved. The reference's
# run-to-run floor measured 0 on an H100 (PERF.md: the step is
# deterministic there), so the limit is 0; the planted fault read 32.1.
OPS_SHAPE = (4096, 2048)
OPT_CHECK_STEPS = 3
TOL_ZERO1 = 0.0

# the context phase, at the main path's shape (B=1, H=16, D=128, S=SEQ,
# bf16, causal). (a) A virtual ring of RING_N ranks of SEQ/RING_N tokens:
# the port's own step functions (``ring_forward_step``,
# ``ring_backward_step``) in lock-step for every virtual rank, Python lists
# rolled for the rotation, against ``flash_attention`` over the whole
# sequence: each output and dq/dk/dv as max|ring - full| / max|full|. Both
# sides run K1-K3 in bf16; the ring merges its blocks' partials in f32 and
# rounds each block's P against that block's row max, the full pass
# against its running one. Measured on an H100 (PERF.md): out 2.8e-4, dq
# 3.3e-4, dk 2.0e-3, dv 2.7e-3; TOL_RING sits 2.2x above the largest. Each
# of RING_FAULTS (the block's k_off taken as me*Sk; one step's merge
# dropped on the last rank) must land beyond it: they read 1.18 and 2.4e-2.
# (b) The headline LM with the flash ring as its attn_fn at world 1 under
# plain Adam: its one merge per layer is exact, so each loss equals the
# flagship's at the same step; measured 0, and TOL_RING_LOSS (relative)
# allows about ten f32 ulps. (c) ``cp_loss_fn`` (einsum ring and Ulysses,
# f32 softmax) at world 1: the loss before the first step against
# ``lm_loss`` with dense f32 attention (``reference_attention``) on the
# same weights, relative; measured 2.2e-6 (ring) and 8.8e-8 (Ulysses),
# TOL_CP_LOSS 4.6x above. (d) The checkpoint: a restored run and the
# original, one more step each, bit for bit.
RING_N = 4
RING_FAULTS = ("k_off", "drop_merge")
TOL_RING = 6e-3
TOL_RING_LOSS = 1e-6
TOL_CP_LOSS = 1e-5

# the observability phase. (a) The headline main path, WARMUP + STEPS
# steps under ``start_timeline``: the trace's last STEP span against
# ``step_report()["step_sec"]`` within OBS_STEP_TOL_MS (both time the same
# host interval, a few spans apart). (b) ``torch.profiler`` over one step
# (after a warm-up one): each kernel's launch (the ``cudaLaunchKernel``
# its kernel record's ``correlation`` id names) inside the optimizer's
# ``<name>.STEP`` range, LAYERS launches each; the kernels as the profiler
# names them. (d) Off (collection only) against on (timeline + a 1 s
# Prometheus publisher) in turns, OBS_ROUNDS rounds of off, on, on, off,
# each block after OBS_ISSUE_PROBES steps timed one by one for the host's
# issue: the LM's ms/step on/off within OBS_LM_RATIO (a few dozen
# microsecond spans against a step of ~62 ms the device is busy for 0.97
# of; measured 0.9999-1.0078 on an H100, PERF.md); ResNet-50's is
# recorded, not gated.
OBS_STEP_TOL_MS = 1.0
OBS_LM_RATIO = 1.05
OBS_ROUNDS = 2
OBS_LM_STEPS = 5
OBS_VISION_STEPS = 20
OBS_ISSUE_PROBES = 3
OBS_KERNELS = {name: re.compile(rf"\b{name}_kernel\b")
               for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.eE+-]+$")
_PROM_TYPE = re.compile(
    r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)$")
_PROM_HELP = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* \S")

KERNELS = {
    "flash_fwd": ("bluefog_tpu_torch/parallel/csrc/flash_fwd.cu",
                  "bluefog_tpu/parallel/flash.py:79"),
    "flash_bwd_dq": ("bluefog_tpu_torch/parallel/csrc/flash_bwd.cu",
                     "bluefog_tpu/parallel/flash.py:283"),
    "flash_bwd_dkv": ("bluefog_tpu_torch/parallel/csrc/flash_bwd.cu",
                      "bluefog_tpu/parallel/flash.py:314"),
}


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def ptxas_lines(log: str) -> list:
    """The lines of a kernel build log worth reading: registers, spills,
    warnings, errors, and ptxas's performance-loss notes (a serialised
    wgmma shows only there)."""
    keys = ("registers", "spill", "warning", "error", "performance")
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln.lower() for k in keys)]


def nerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-6))


def check_kernels(fl, torch, B, Sq, Sk, H, D, offsets, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(Sq + D)
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, Sk, H, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    g = torch.randn((B, Sq, H, D), generator=gen, device=dev)
    for causal in (True, False):
        for q_off, k_off in offsets:
            o, m, l = fl.flash_block(q, k, v, q_off, k_off, causal=causal)
            po, pm, pl = fl.flash_block_plain(q, k, v, q_off, k_off,
                                              causal=causal)
            torch.cuda.synchronize()
            den = pl.clamp_min(1.0)[..., None]   # l >= 1 on a live row
            e_o = float(((o - po) / den).abs().max())
            e_m = float((m - pm).abs().max())
            e_l = float(((l - pl).abs() / pl.clamp_min(1.0)).max())
            out = (po / pl.clamp_min(1e-30)[..., None]).to(torch.bfloat16)
            d_term = (g * out.float()).sum(-1)
            args = (q, k, v, g, d_term, pm, pl, q_off, k_off)
            dq = fl.flash_bwd_dq(*args, causal=causal)
            dk, dv = fl.flash_bwd_dkv(*args, causal=causal)
            pdq, pdk, pdv = fl.flash_block_bwd_plain(*args, causal=causal)
            torch.cuda.synchronize()
            errs = {"o": e_o, "m": e_m, "l": e_l, "dq": nerr(dq, pdq),
                    "dk": nerr(dk, pdk), "dv": nerr(dv, pdv)}
            for name, t in (("o", o), ("m", m), ("l", l), ("dq", dq),
                            ("dk", dk), ("dv", dv)):
                if not torch.isfinite(t).all():
                    raise RuntimeError(f"kernel output {name} not finite")
            log(f"check Sq={Sq} Sk={Sk} D={D} causal={causal} "
                f"offs=({q_off},{k_off}) "
                + " ".join(f"{n}={e:.3e}" for n, e in errs.items()))
            limits = {"o": TOL_FWD, "m": TOL_M, "l": TOL_L, "dq": TOL_BWD,
                      "dk": TOL_BWD, "dv": TOL_BWD}
            bad = {n: e for n, e in errs.items() if not e <= limits[n]}
            if bad:
                raise RuntimeError(f"kernel disagrees with its plain version "
                                   f"beyond tolerance {limits}: {bad}")


def kernel_bounds(B: int, S: int, H: int, D: int) -> dict:
    """Least time on the card for each kernel at [B, S, H, D], causal, offsets
    0: the larger of its products' FLOPs over the bf16 peak (every product
    runs in bf16) and its bytes over the memory rate (each input read once,
    each output written once). Returns {name: {"bound_ms", "bound_by"}}."""
    pairs = B * H * S * (S + 1) // 2         # causal live (q, k) pairs
    prod = 2.0 * pairs * D                   # FLOP of one [q,k]x[.,D] product
    bf16_in = B * S * H * D * 2
    f32_row = B * S * H * D * 4
    stats = B * S * H * 4
    work = {
        # K1: s, P.V; reads q, k, v, writes o, m, l
        "flash_fwd": (2, 3 * bf16_in + f32_row + 2 * stats),
        # K2: s, dp, dq; reads q, k, v, g (f32), m, l, d, writes dq
        "flash_bwd_dq": (3, 3 * bf16_in + 2 * f32_row + 3 * stats),
        # K3: s, dp, dv, dk; reads the same, writes dk, dv
        "flash_bwd_dkv": (4, 3 * bf16_in + 3 * f32_row + 3 * stats),
    }
    out = {}
    for name, (n_prod, nbytes) in work.items():
        op_s = n_prod * prod / PEAK_BF16
        byte_s = nbytes / PEAK_BYTES
        out[name] = {"bound_ms": max(op_s, byte_s) * 1e3,
                     "bound_by": "operations" if op_s >= byte_s else "bytes"}
    return out


def kernel_bench(fl, torch, dev, B, S, H, D) -> dict:
    """Times at the main path's shape; returns per-kernel measurements."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    g = torch.randn((B, S, H, D), generator=gen, device=dev)
    o, m, l = fl.flash_block(q, k, v, 0, 0, causal=True)
    out = (o / l[..., None]).to(torch.bfloat16)
    d_term = (g * out.float()).sum(-1)
    args = (q, k, v, g, d_term, m, l, 0, 0)
    res = {}
    res["flash_fwd"] = {
        "ms": cuda_ms(lambda: fl.flash_block(q, k, v, 0, 0, causal=True), 10),
        "plain_ms": cuda_ms(lambda: fl.flash_block_plain(q, k, v, 0, 0,
                                                         causal=True), 2),
    }
    res["flash_bwd_dq"] = {
        "ms": cuda_ms(lambda: fl.flash_bwd_dq(*args, causal=True), 10),
        "plain_ms": cuda_ms(lambda: fl.flash_bwd_dq_plain(*args, causal=True),
                            2),
    }
    res["flash_bwd_dkv"] = {
        "ms": cuda_ms(lambda: fl.flash_bwd_dkv(*args, causal=True), 10),
        "plain_ms": cuda_ms(lambda: fl.flash_bwd_dkv_plain(*args,
                                                           causal=True), 2),
    }
    # yardstick: one PyTorch call computing the same function; the port
    # never calls it. [B, H, S, D] layout, as SDPA takes it.
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    gt = g.to(torch.bfloat16).transpose(1, 2).contiguous()
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10)

    def fwd_bwd():
        y = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(y, (qt, kt, vt), gt)

    sdpa_bwd = cuda_ms(fwd_bwd, 10) - sdpa_fwd
    res["flash_fwd"]["library_ms"] = sdpa_fwd
    res["flash_fwd"]["library_call"] = "scaled_dot_product_attention fwd"
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        res[name]["library_ms"] = sdpa_bwd
        res[name]["library_call"] = ("scaled_dot_product_attention bwd "
                                     "(dq, dk and dv together)")

    for name, bound in kernel_bounds(B, S, H, D).items():
        res[name].update(bound)
    for name, r in res.items():
        log(f"bench {name} S={S}: ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']:.4f}")
    return res


def _switch_ffns(model) -> list:
    from bluefog_tpu_torch.parallel import SwitchFFN

    return [m for m in model.modules() if isinstance(m, SwitchFFN)]


def _routed_alike(model_a, model_b, toks):
    """[B, S] bool: the tokens that every MoE layer of the two models sends
    to the same expert on one forward of ``toks``."""
    import torch

    seen = {}
    hooks = [mod.register_forward_pre_hook(
        lambda m, args, key=key: seen.setdefault(key, []).append(
            m.route(args[0])[1]))
        for key, model in enumerate((model_a, model_b))
        for mod in _switch_ffns(model)]
    with torch.no_grad():
        model_a(toks)
        model_b(toks)
    for h in hooks:
        h.remove()
    return torch.stack([a == b for a, b in zip(seen[0], seen[1])]).all(0)


def model_check(bf, fl, torch, dev, num_experts: int = 0,
                seed: int = 3) -> dict:
    """Flash vs dense attention in a small bf16 model on the card. With
    ``num_experts`` an MoE LM whose one MoE block is the last: a token whose
    two best router logits tie in bf16 can go to another expert under each
    attention, which changes that token's logits alone, so the share routed
    apart is held to ``TOL_ROUTED_APART`` and the loss (mean over the
    tokens routed alike), its gradients and those tokens' logits to
    ``TOL_MODEL``."""
    import torch.nn.functional as F
    from bluefog_tpu_torch.parallel.context import reference_attention
    from functools import partial

    def build(attn):
        return bf.models.TransformerLM(
            vocab_size=512, num_layers=2, num_heads=2, d_model=256, d_ff=1024,
            dtype=torch.bfloat16, attn_fn=attn, num_experts=num_experts,
            device=dev, seed=seed)

    flash_m = build(fl.flash_attention)
    dense_m = build(partial(reference_attention, causal=True))
    gen = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, 512, (2, 320), generator=gen, device=dev)
    batch = (toks, toks.roll(-1, dims=1))
    loss = bf.models.lm_loss
    keep = torch.ones_like(toks, dtype=torch.bool)
    if num_experts:
        keep = _routed_alike(flash_m, dense_m, toks)

        def loss(model, batch):
            logits = model(batch[0])
            nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  batch[1].reshape(-1), reduction="none")
            return (nll * keep.flatten()).sum() / keep.sum()
    lf = loss(flash_m, batch)
    ld = loss(dense_m, batch)
    lf.backward()
    ld.backward()
    with torch.no_grad():
        e_logits = nerr(flash_m(toks)[keep], dense_m(toks)[keep])
    e_grad = max(nerr(a.grad, b.grad) for a, b in
                 zip(flash_m.parameters(), dense_m.parameters()))
    apart = 1.0 - float(keep.float().mean())
    label = f"moe (E={num_experts}) model check, tokens routed alike" \
        if num_experts else "model check"
    log(f"{label}: logits err={e_logits:.3e} grad err={e_grad:.3e} "
        f"loss flash={float(lf.detach()):.5f} dense={float(ld.detach()):.5f}"
        + (f"; share routed apart={apart:.4e}" if num_experts else ""))
    if not (e_logits <= TOL_MODEL and e_grad <= TOL_MODEL):
        raise RuntimeError("flash model disagrees with dense attention")
    if not apart <= TOL_ROUTED_APART:
        raise RuntimeError(f"flash and dense attention sent {apart:.4e} of "
                           f"the tokens to other experts")
    return {"logits": e_logits, "grad": e_grad, "routed_apart": apart}


def headline_model(bf, torch, dev, attn_fn, **moe):
    """``TransformerLM`` at the repo's headline width with ``LAYERS`` layers
    (bf16 compute, f32 parameters, seed 0); ``moe`` takes ``num_experts``
    and ``moe_every``."""
    return bf.models.TransformerLM(
        vocab_size=32768, num_layers=LAYERS, num_heads=16, d_model=2048,
        d_ff=8192, dtype=torch.bfloat16, attn_fn=attn_fn, device=dev, seed=0,
        **moe)


def headline_batch(torch, dev, seq: int = SEQ):
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, 32768, (1, seq), generator=gen, device=dev)
    return toks, toks.roll(-1, dims=1)


def chunked_lm_loss(model, batch):
    """``chunked_ce_loss`` in the optimizer's ``loss_fn(model, batch)``."""
    from bluefog_tpu_torch.parallel import chunked_ce_loss

    return chunked_ce_loss(model, *batch, chunk=CE_CHUNK)


def headline(bf, torch, dev, attn_fn, seq: int = SEQ, loss_fn=None,
             **moe):
    """The main path's model, optimizer and batch (seeded, random weights).

    ``headline_model`` under ``DistributedNeighborAllreduceOptimizer``
    around Adam (lr 1e-3) with ``loss_fn`` (default ``lm_loss``), one
    repeated batch of ``seq`` tokens. Needs ``bf.init()`` first.
    """
    model = headline_model(bf, torch, dev, attn_fn, **moe)
    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), model,
        loss_fn or bf.models.lm_loss)
    return model, opt, headline_batch(torch, dev, seq)


def _train_steps(fl, torch, opt, batch) -> dict:
    """``WARMUP`` then ``STEPS`` timed steps, the launch counts set to 0
    just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fl.reset_launch_counts()
    losses = []
    for _ in range(WARMUP):
        losses.append(opt.step(batch)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        losses.append(opt.step(batch)["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / STEPS
    return {"counts": dict(fl.launch_counts), "dt": dt,
            "losses": [float(x) for x in losses],
            "peak": torch.cuda.max_memory_allocated()}


def _check_training(label: str, run: dict, per_step: int) -> None:
    total = WARMUP + STEPS
    for name, c in run["counts"].items():
        if c != per_step * total:
            raise RuntimeError(f"{label}: {name} launched {c} times in "
                               f"{total} steps, expected {per_step} a step")
    losses = run["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{label}: loss did not fall on a repeated "
                           f"batch {losses}")


def train(bf, fl, torch) -> dict:
    bf.init()                                    # NCCL, world of one
    dev = torch.device("cuda", torch.cuda.current_device())
    model, opt, batch = headline(bf, torch, dev, fl.flash_attention)
    run = _train_steps(fl, torch, opt, batch)
    dt, counts, losses, peak = (run["dt"], run["counts"], run["losses"],
                                run["peak"])
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train: layers={LAYERS} seq={SEQ} params={n_params} "
        f"ms/step={dt * 1e3:.3f} tokens/s={SEQ / dt:.1f} "
        f"peak_mem_GiB={peak / 2**30:.3f}")
    log("train losses: " + " ".join(f"{x:.5f}" for x in losses))
    log(f"train launches: {counts}")
    _check_training("train", run, LAYERS)
    bf.shutdown()
    return {"counts": counts, "ms_per_step": dt * 1e3,
            "tokens_per_s": SEQ / dt, "peak_bytes": peak, "losses": losses}


def ops_check(bf, torch, dev) -> dict:
    """(a) The collectives surface at world 1 on an ``OPS_SHAPE`` tensor in
    f32 and bf16, each against its closed form written in plain torch: max
    abs error 0, shapes equal. Raises otherwise, when an in-place form does
    not return its input, or when a second ``synchronize`` of a handle does
    not raise."""
    gen = torch.Generator(device=dev).manual_seed(21)
    base = torch.randn(OPS_SHAPE, generator=gen, device=dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = base.to(dt)
        got = {
            "allgather": (bf.allgather(x), x),
            "allgather_v": (bf.allgather_v(x), x),
            "neighbor_allgather": (bf.neighbor_allgather(x), x[:0]),
            "pair_gossip": (bf.pair_gossip(x, [0], 0.75, 0.25),
                            0.75 * x + 0.25 * x),
            "hierarchical_neighbor_allreduce": (
                bf.hierarchical_neighbor_allreduce(x), x),
            "allreduce(is_hierarchical_local)": (
                bf.allreduce(x, is_hierarchical_local=True), x),
        }
        for name, fn in (
                ("allreduce_", bf.allreduce_),
                ("broadcast_", lambda y: bf.broadcast_(y, 0)),
                ("allreduce_nonblocking_", lambda y: bf.synchronize(
                    bf.allreduce_nonblocking_(y))),
                ("broadcast_nonblocking_", lambda y: bf.synchronize(
                    bf.broadcast_nonblocking_(y, 0)))):
            y = x.clone()
            if fn(y) is not y:
                raise RuntimeError(f"{name} did not return its input")
            got[name] = (y, x)
        issued = {
            "allreduce_nonblocking": (bf.allreduce_nonblocking(x), x),
            "broadcast_nonblocking": (bf.broadcast_nonblocking(x, 0), x),
            "allgather_nonblocking": (bf.allgather_nonblocking(x), x),
            "allgather_v_nonblocking": (bf.allgather_v_nonblocking(x), x),
            "pair_gossip_nonblocking": (bf.pair_gossip_nonblocking(
                x, [0], 0.75, 0.25), 0.75 * x + 0.25 * x),
            "neighbor_allreduce_nonblocking": (
                bf.neighbor_allreduce_nonblocking(x), x),
            "hierarchical_neighbor_allreduce_nonblocking": (
                bf.hierarchical_neighbor_allreduce_nonblocking(x), x),
            "neighbor_allgather_nonblocking": (
                bf.neighbor_allgather_nonblocking(x), x[:0]),
        }
        for name, (h, want) in issued.items():
            while not bf.poll(h):
                time.sleep(1e-4)
            got[name] = (bf.synchronize(h), want)
            try:
                bf.synchronize(h)
            except ValueError:
                pass
            else:
                raise RuntimeError(f"a second synchronize of {name} did not "
                                   f"raise")
        torch.cuda.synchronize()
        for name, (out, want) in got.items():
            if out.shape != want.shape or out.dtype != want.dtype:
                raise RuntimeError(
                    f"{name} ({dt}): {out.dtype}{tuple(out.shape)} where "
                    f"{want.dtype}{tuple(want.shape)}")
            errs[f"{name} {str(dt)[6:]}"] = float(
                (out.float() - want.float()).abs().max()) \
                if out.numel() else 0.0
    log(f"ops check (world 1, {list(OPS_SHAPE)}, f32 and bf16): "
        f"{len(errs)} results, max abs err {max(errs.values()):.1e}")
    bad = {k: e for k, e in errs.items() if e != 0.0}
    if bad:
        raise RuntimeError(f"ops disagree with their closed forms: {bad}")
    return errs


def zero1_train(bf, fl, torch, dev) -> dict:
    """(b) The headline LM under ``DistributedShardedAllreduceOptimizer``
    around Adam (lr 1e-3), ``WARMUP`` then ``STEPS`` timed steps."""
    model = headline_model(bf, torch, dev, fl.flash_attention)
    opt = bf.DistributedShardedAllreduceOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), model,
        bf.models.lm_loss)
    run = _train_steps(fl, torch, opt, headline_batch(torch, dev))
    dt = run["dt"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"zero1 train: layers={LAYERS} seq={SEQ} params={n_params} "
        f"ms/step={dt * 1e3:.3f} tokens/s="
        f"{SEQ / dt:.1f} peak_mem_GiB={run['peak'] / 2**30:.3f}")
    log("zero1 train losses: " + " ".join(f"{x:.5f}" for x in run["losses"]))
    log(f"zero1 train launches: {run['counts']}")
    _check_training("zero1 train", run, LAYERS)
    return {"counts": run["counts"], "ms_per_step": dt * 1e3,
            "tokens_per_s": SEQ / dt, "peak_bytes": run["peak"],
            "losses": run["losses"], "params": n_params}


def _shift_written_shard(opt) -> None:
    """The planted fault: every update of the shard is written back one
    element off (the shard rolled by one after the optimizer's step). A
    step hook holds no reference to the optimizer: a patched ``step``
    closing over it would make a cycle that keeps the model's buffers on
    the card until the garbage collector runs."""
    (shard,) = opt.base.param_groups[0]["params"]
    opt.base.register_step_post_hook(
        lambda *_: shard.data.copy_(shard.data.roll(1)))


def _check_steps(bf, fl, torch, dev, cls, plant=False) -> list:
    """The parameters after ``OPT_CHECK_STEPS`` Adam steps of the headline
    LM (seed 0) under ``cls`` on the headline batch."""
    model = headline_model(bf, torch, dev, fl.flash_attention)
    opt = cls(torch.optim.Adam(model.parameters(), lr=1e-3), model,
              bf.models.lm_loss)
    if plant:
        _shift_written_shard(opt)
    batch = headline_batch(torch, dev)
    for _ in range(OPT_CHECK_STEPS):
        opt.step(batch)
    return [p.detach().clone() for p in model.parameters()]


def param_diff(a, b, p0) -> float:
    """max over tensors of |a - b|_2 / |b - p0|_2, in f64."""
    import torch

    norm = torch.linalg.vector_norm
    return max(float(norm(x - y, dtype=torch.float64)
                     / norm(y - z, dtype=torch.float64))
               for x, y, z in zip(a, b, p0))


def optimizer_checks(bf, fl, torch, dev) -> dict:
    """(c) ZeRO-1 and (d) the hierarchical optimizer against their world-1
    references, each within ``TOL_ZERO1`` of the reference's own
    run-to-run floor; the planted fault must land beyond it."""
    p0 = [p.detach().clone() for p in headline_model(
        bf, torch, dev, fl.flash_attention).parameters()]
    runs = {}
    for key, cls, plant in (
            ("ref", bf.DistributedGradientAllreduceOptimizer, False),
            ("ref again", bf.DistributedGradientAllreduceOptimizer, False),
            ("zero1", bf.DistributedShardedAllreduceOptimizer, False),
            ("zero1 planted", bf.DistributedShardedAllreduceOptimizer, True),
            ("flagship", bf.DistributedNeighborAllreduceOptimizer, False),
            ("hierarchical",
             bf.DistributedHierarchicalNeighborAllreduceOptimizer, False)):
        runs[key] = _check_steps(bf, fl, torch, dev, cls, plant)
        torch.cuda.empty_cache()
    diffs = {"floor": param_diff(runs["ref again"], runs["ref"], p0),
             "zero1": param_diff(runs["zero1"], runs["ref"], p0),
             "planted": param_diff(runs["zero1 planted"], runs["ref"], p0),
             "hierarchical": param_diff(runs["hierarchical"],
                                        runs["flagship"], p0)}
    log(f"optimizer checks ({OPT_CHECK_STEPS} Adam steps, headline LM, "
        f"max over tensors of |a-b|/|b-p0|): gradient allreduce twice "
        f"(floor)={diffs['floor']:.3e} zero1 vs gradient allreduce="
        f"{diffs['zero1']:.3e} hierarchical vs flagship="
        f"{diffs['hierarchical']:.3e} planted (shard written back shifted "
        f"by one)={diffs['planted']:.3e}; limit TOL_ZERO1={TOL_ZERO1}")
    bad = {k: v for k, v in diffs.items()
           if k != "planted" and not v <= TOL_ZERO1}
    if bad:
        raise RuntimeError(f"optimizers disagree beyond TOL_ZERO1="
                           f"{TOL_ZERO1}: {bad}")
    if diffs["planted"] <= TOL_ZERO1:
        raise RuntimeError(f"the optimizer check missed the planted fault: "
                           f"{diffs}")
    return diffs


def flat_collectives(torch, dev, numel: int) -> dict:
    """(e) NCCL's reduce-scatter and all-gather of one f32 buffer of
    ``numel`` elements at world 1, out of place and in place (the ZeRO-1
    step's form), CUDA events; the copy bound reads and writes it once."""
    import torch.distributed as dist

    from bluefog_tpu_torch.ops.collectives import (_all_gather_flat,
                                                   _reduce_scatter_flat)

    flat = torch.ones(numel, device=dev)
    out = torch.empty_like(flat)
    res = {
        "reduce_scatter": cuda_ms(lambda: _reduce_scatter_flat(
            out, flat, op=dist.ReduceOp.SUM), 10),
        "all_gather": cuda_ms(lambda: _all_gather_flat(out, flat), 10),
        "reduce_scatter in place": cuda_ms(lambda: _reduce_scatter_flat(
            flat, flat, op=dist.ReduceOp.SUM), 10),
        "all_gather in place": cuda_ms(lambda: _all_gather_flat(flat, flat),
                                       10),
    }
    bound = 2 * numel * 4 / PEAK_BYTES * 1e3
    log(f"flat collectives ({numel} f32, {numel * 4 / 1e9:.3f} GB, world 1): "
        + " ".join(f"{k}={v:.4f} ms" for k, v in res.items())
        + f"; copy bound {bound:.4f} ms")
    return dict(res, bound_ms=bound)


def optimizers(bf, fl, torch) -> dict:
    """The optimizers phase, (a)-(e), in one world of one over NCCL. Raises
    when it leaves device memory allocated behind it."""
    before = torch.cuda.memory_allocated()
    bf.init()
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        res = {"ops": ops_check(bf, torch, dev)}
        torch.cuda.empty_cache()
        res["zero1_train"] = zero1_train(bf, fl, torch, dev)
        torch.cuda.empty_cache()
        res["checks"] = optimizer_checks(bf, fl, torch, dev)
        torch.cuda.empty_cache()
        res["flat_collectives"] = flat_collectives(
            torch, dev, res["zero1_train"]["params"])
    finally:
        bf.shutdown()
    left = torch.cuda.memory_allocated() - before
    if left > 2**20:
        raise RuntimeError(f"the optimizers phase left {left} bytes "
                           f"allocated on the card")
    return res

def _roll(xs: list) -> list:
    """One rotation of the virtual ring: rank i's item moves to rank i+1."""
    return xs[-1:] + xs[:-1]


def _shards(x, n: int) -> list:
    return [t.contiguous() for t in x.chunk(n, dim=1)]


def _k_off(r: int, t: int, n: int, sk: int, fault) -> int:
    """Rank r's key offset at step t: block (r - t) % n, or the planted
    ``k_off`` fault's r."""
    return (r if fault == "k_off" else (r - t) % n) * sk


def _vring_forward(qs, ks, vs, use_flash: bool, fault=None,
                   check: bool = False, causal: bool = True) -> list:
    """The virtual ring's forward over the ranks' shards: the port's
    ``ring_forward_step`` for every rank in lock-step, the K/V lists rolled
    for the rotation; returns each rank's ``(out, m, l)``. ``check`` raises
    when a state leaves the finite numbers (a fully masked block, blk > me,
    must leave it as it was)."""
    import torch
    from bluefog_tpu_torch.parallel import context as cx

    n, sq, sk = len(qs), qs[0].shape[1], ks[0].shape[1]
    states = [cx.ring_forward_init(x) for x in qs]
    kc, vc = ks, vs
    for t in range(n):
        for r in range(n):
            new = cx.ring_forward_step(qs[r], kc[r], vc[r], states[r],
                                       r * sq, _k_off(r, t, n, sk, fault),
                                       causal, use_flash)
            if not (fault == "drop_merge" and r == n - 1 and t == 1):
                states[r] = new
            if check and not all(bool(torch.isfinite(x).all())
                                 for x in states[r]):
                raise RuntimeError(f"virtual ring: rank {r} step {t} "
                                   f"(block {(r - t) % n}) not finite")
        kc, vc = _roll(kc), _roll(vc)
    return [cx.ring_forward_finish(st, qs[0].dtype) for st in states]


def _vring_backward(qs, ks, vs, fin, gs, use_flash: bool, fault=None,
                    causal: bool = True) -> list:
    """The virtual ring's backward: ``ring_backward_step`` for every rank,
    K/V and the dk/dv accumulators rolled each step (the last roll brings
    dk/dv home); returns each rank's ``(dq, dk, dv, stats)``."""
    from bluefog_tpu_torch.parallel import context as cx

    n, sq, sk = len(qs), qs[0].shape[1], ks[0].shape[1]
    grads = [cx.ring_backward_init(qs[r], ks[r], vs[r], *fin[r], gs[r])
             for r in range(n)]
    kc, vc = ks, vs
    for t in range(n):
        grads = [cx.ring_backward_step(qs[r], kc[r], vc[r], grads[r],
                                       r * sq, _k_off(r, t, n, sk, fault),
                                       causal, use_flash)
                 for r in range(n)]
        kc, vc = _roll(kc), _roll(vc)
        dks, dvs = _roll([s[1] for s in grads]), _roll([s[2] for s in grads])
        grads = [(s[0], dk, dv, s[3]) for s, dk, dv in zip(grads, dks, dvs)]
    return grads


def virtual_ring(q, k, v, g, n: int, use_flash: bool, fault=None,
                 causal: bool = True) -> tuple:
    """Ring attention over ``n`` virtual ranks in one process (the port's
    step functions, lists rolled for the rotation). ``q, k, v, g`` are
    whole sequences; returns the whole ``(out, dq, dk, dv)`` assembled from
    the ranks' shards. ``fault`` plants one of ``RING_FAULTS``."""
    import torch

    qs, ks, vs, gs = (_shards(x, n) for x in (q, k, v, g))
    fin = _vring_forward(qs, ks, vs, use_flash, fault, True, causal)
    grads = _vring_backward(qs, ks, vs, fin, gs, use_flash, fault, causal)
    return (torch.cat([f[0] for f in fin], 1),
            *(torch.cat([s[i] for s in grads], 1).to(q.dtype)
              for i in range(3)))


def _ring_direction_ms(torch, q, k, v, g, n: int) -> dict:
    """CUDA-event ms of the virtual ring's forward (n^2 K1 steps and their
    merges) and backward (n^2 K2+K3 steps and their sums), each summed over
    the virtual ranks; the same n^2 kernel calls alone; the full-sequence
    K1 and K2+K3."""
    from bluefog_tpu_torch.parallel import flash as fl

    qs, ks, vs, gs = (_shards(x, n) for x in (q, k, v, g))
    s = qs[0].shape[1]
    fin = _vring_forward(qs, ks, vs, True)
    stats = [(gs[r].float(), (gs[r].float() * fin[r][0].float()).sum(-1),
              *fin[r][1:]) for r in range(n)]
    blocks = [(r, (r - t) % n) for t in range(n) for r in range(n)]

    def fwd_kernels():
        for r, blk in blocks:
            fl.flash_block(qs[r], ks[blk], vs[blk], r * s, blk * s,
                           causal=True)

    def bwd_kernels():
        for r, blk in blocks:
            fl.flash_block_bwd(qs[r], ks[blk], vs[blk], *stats[r], r * s,
                               blk * s, causal=True)

    o, m, l = fl.flash_block(q, k, v, 0, 0, causal=True)
    out = (o / l[..., None]).to(q.dtype)
    d_term = (g * out.float()).sum(-1)
    return {"ring fwd": cuda_ms(lambda: _vring_forward(qs, ks, vs, True), 5),
            "ring fwd K1 alone": cuda_ms(fwd_kernels, 5),
            "full K1": cuda_ms(
                lambda: fl.flash_block(q, k, v, 0, 0, causal=True), 5),
            "ring bwd": cuda_ms(
                lambda: _vring_backward(qs, ks, vs, fin, gs, True), 5),
            "ring bwd K2+K3 alone": cuda_ms(bwd_kernels, 5),
            "full K2+K3": cuda_ms(
                lambda: fl.flash_block_bwd(q, k, v, g, d_term, m, l, 0, 0,
                                           causal=True), 5)}


def ring_check(fl, torch, dev, B, S, H, D) -> dict:
    """(a) The virtual ring of ``RING_N`` against ``flash_attention`` over
    the whole sequence: errors within ``TOL_RING``, ``RING_N``^2 launches
    of each kernel, each planted fault beyond the limit, and the ms of
    each direction beside the full-sequence kernels'."""
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    g = torch.randn((B, S, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    full = fl.flash_attention(qq, kk, vv, causal=True)
    full.backward(g)
    ref = (full.detach(), qq.grad, kk.grad, vv.grad)
    del qq, kk, vv, full
    names = ("out", "dq", "dk", "dv")

    def errors(run):
        return {nm: nerr(a, b) for nm, a, b in zip(names, run, ref)}

    torch.cuda.synchronize()
    fl.reset_launch_counts()
    errs = errors(virtual_ring(q, k, v, g.float(), RING_N, True))
    torch.cuda.synchronize()
    counts = dict(fl.launch_counts)
    planted = {f: errors(virtual_ring(q, k, v, g.float(), RING_N, True, f))
               for f in RING_FAULTS}
    ms = _ring_direction_ms(torch, q, k, v, g.float(), RING_N)
    log(f"ring check (virtual ring of {RING_N}, {S // RING_N} tokens each, "
        f"vs flash_attention over S={S}): "
        + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
        + f"; limit TOL_RING={TOL_RING}; launches {counts}")
    for f, e in planted.items():
        log(f"ring check, planted {f}: "
            + " ".join(f"{n}={v:.3e}" for n, v in e.items()))
    log("ring ms (CUDA events, summed over the virtual ranks): "
        + " ".join(f"{n}={t:.4f}" for n, t in ms.items()))
    want = RING_N * RING_N
    if any(c != want for c in counts.values()):
        raise RuntimeError(f"virtual ring launches {counts}, expected {want} "
                           f"of each kernel")
    bad = {n: e for n, e in errs.items() if not e <= TOL_RING}
    if bad:
        raise RuntimeError(f"the virtual ring disagrees with full-sequence "
                           f"flash beyond TOL_RING={TOL_RING}: {bad}")
    for f, e in planted.items():
        if all(v <= TOL_RING for v in e.values()):
            raise RuntimeError(f"the ring check missed the planted fault "
                               f"{f}: {e}")
    return {"errors": errs, "planted": planted, "launches": counts,
            "ms": ms}


def _plain_adam(model, loss_fn):
    """Plain ``torch.optim.Adam`` (lr 1e-3) behind the wrappers'
    ``step(batch) -> {"loss": ...}``."""
    import types

    import torch

    adam = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step(batch):
        adam.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        adam.step()
        return {"loss": loss.detach()}

    return types.SimpleNamespace(step=step, base=adam, model=model)


def ring_train(bf, fl, torch, dev, flagship: list):
    """(b) The headline LM with ``ring_attention_shard(causal=True,
    use_flash=True)`` as its attention at world 1, plain Adam: ms/step,
    tokens/s, peak memory, losses against the flagship's, ``LAYERS``
    launches of each kernel per step. Returns the results, the model and
    its Adam."""
    from functools import partial

    from bluefog_tpu_torch.parallel import ring_attention_shard

    attn = partial(ring_attention_shard, causal=True, use_flash=True)
    model = headline_model(bf, torch, dev, attn)
    opt = _plain_adam(model, bf.models.lm_loss)
    run = _train_steps(fl, torch, opt, headline_batch(torch, dev))
    dt = run["dt"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], flagship))
    log(f"ring train (flash ring attn_fn, world 1, plain Adam): layers="
        f"{LAYERS} seq={SEQ} ms/step={dt * 1e3:.3f} tokens/s="
        f"{SEQ / dt:.1f} peak_mem_GiB={run['peak'] / 2**30:.3f}")
    log("ring train losses: " + " ".join(f"{x:.5f}" for x in run["losses"])
        + f"; largest relative difference from the flagship's {rel:.3e} "
        f"(limit TOL_RING_LOSS={TOL_RING_LOSS})")
    log(f"ring train launches: {run['counts']}")
    _check_training("ring train", run, LAYERS)
    if not rel <= TOL_RING_LOSS:
        raise RuntimeError(f"the flash-ring LM's losses {run['losses']} "
                           f"differ from the flagship's {flagship}")
    res = {"counts": run["counts"], "ms_per_step": dt * 1e3,
           "tokens_per_s": SEQ / dt, "peak_bytes": run["peak"],
           "losses": run["losses"], "vs_flagship": rel}
    return res, opt


def cp_check(bf, torch, dev) -> dict:
    """(c) ``cp_loss_fn`` (ring, then Ulysses) on the headline model at
    world 1, two plain Adam steps each: the first loss against ``lm_loss``
    with dense attention on the same weights, the losses, ms/step and peak
    memory. Each einsum ring block and each Ulysses score tensor is a dense
    f32 [1, 16, 8192, 8192]: 4 GiB."""
    from functools import partial

    from bluefog_tpu_torch.parallel import cp_loss_fn, reference_attention

    batch = headline_batch(torch, dev)
    model = headline_model(bf, torch, dev,
                           partial(reference_attention, causal=True))
    with torch.no_grad():
        ref = float(bf.models.lm_loss(model, batch))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    res = {"dense_loss": ref}
    for kind in ("ring", "ulysses"):
        model.load_state_dict(start)
        opt = _plain_adam(model, cp_loss_fn(model, kind=kind))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [float(opt.step(batch)["loss"]) for _ in range(2)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 2
        peak = torch.cuda.max_memory_allocated()
        rel = abs(losses[0] - ref) / abs(ref)
        log(f"cp {kind} (cp_loss_fn, world 1, headline model): losses "
            + " ".join(f"{x:.6f}" for x in losses)
            + f"; dense lm_loss {ref:.6f}, relative error {rel:.3e} (limit "
            f"TOL_CP_LOSS={TOL_CP_LOSS}); ms/step={dt * 1e3:.1f} "
            f"peak_mem_GiB={peak / 2**30:.3f}")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"cp {kind}: non-finite loss {losses}")
        if not rel <= TOL_CP_LOSS:
            raise RuntimeError(f"cp {kind}: loss {losses[0]} against dense "
                               f"{ref}: {rel:.3e} > {TOL_CP_LOSS}")
        if not losses[1] < losses[0]:
            raise RuntimeError(f"cp {kind}: loss did not fall {losses}")
        res[kind] = {"losses": losses, "rel_err": rel, "ms_per_step":
                     dt * 1e3, "peak_bytes": peak}
        del opt
        torch.cuda.empty_cache()
    return res


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def checkpoint_check(bf, torch, dev, trained) -> dict:
    """(d) Save the ring LM's Adam state (``save``, then ``save_async`` and
    ``wait_pending``) into a temporary directory the phase removes, restore
    each into a fresh model and Adam, and hold the restored state and one
    more step of each run to the original's, bit for bit."""
    import shutil
    import tempfile
    from functools import partial

    from bluefog_tpu_torch import checkpoint as ck
    from bluefog_tpu_torch.parallel import ring_attention_shard

    attn = partial(ring_attention_shard, causal=True, use_flash=True)
    batch = headline_batch(torch, dev)
    tmp = tempfile.mkdtemp(prefix="bft_ckpt_")
    try:
        paths = {"save": os.path.join(tmp, "sync"),
                 "save_async": os.path.join(tmp, "async")}
        times = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(paths["save"], trained, step=WARMUP + STEPS)
        times["save"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.save_async(paths["save_async"], trained, step=WARMUP + STEPS)
        times["save_async returns"] = time.perf_counter() - t0
        ck.wait_pending()
        times["save_async + wait_pending"] = time.perf_counter() - t0
        nbytes = {k: _dir_bytes(p) for k, p in paths.items()}
        meta = ck.read_meta(paths["save"])

        def state(opt):
            out = [p.detach() for p in opt.model.parameters()]
            for entry in opt.base.state.values():
                out += [t for t in entry.values() if torch.is_tensor(t)]
            return out

        want = [t.clone() for t in state(trained)]
        same = {}
        for key in ("save_async", "save"):
            # seed 0's initial weights: the restore must replace them
            fresh = _plain_adam(headline_model(bf, torch, dev, attn),
                                bf.models.lm_loss)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, step = ck.restore(paths[key], fresh)
            torch.cuda.synchronize()
            times[f"restore ({key})"] = time.perf_counter() - t0
            got = state(fresh)
            same[key] = step == WARMUP + STEPS and len(got) == len(want) \
                and all(torch.equal(a, b) for a, b in zip(got, want))
            if key == "save_async":
                del fresh, got
                torch.cuda.empty_cache()
        trained.step(batch)
        fresh.step(batch)
        cont = all(torch.equal(a, b) for a, b in zip(state(fresh),
                                                     state(trained)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"checkpoint (ring LM, Adam, world 1): bytes {nbytes} sidecar {meta}")
    log("checkpoint seconds: " + " ".join(f"{k}={v:.3f}"
                                          for k, v in times.items()))
    log(f"checkpoint restored bit-identical: {same}; one more step each, "
        f"bit-identical: {cont}")
    if not (all(same.values()) and cont):
        raise RuntimeError(f"the checkpoint did not restore the state bit "
                           f"for bit: restored {same}, continued {cont}")
    if meta is None or meta.get("world") != 1 or \
            meta.get("step") != WARMUP + STEPS:
        raise RuntimeError(f"checkpoint sidecar {meta}")
    return {"bytes": nbytes, "seconds": times, "meta": meta}


def context(bf, fl, torch, flagship: list) -> dict:
    """The context phase (a)-(d), (b)-(d) in one world of one over NCCL."""
    dev = torch.device("cuda", 0)
    res = {"ring_check": ring_check(fl, torch, dev, 1, SEQ, 16, 128)}
    torch.cuda.empty_cache()
    bf.init()
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        res["ring_train"], trained = ring_train(bf, fl, torch, dev, flagship)
        res["checkpoint"] = checkpoint_check(bf, torch, dev, trained)
        del trained
        torch.cuda.empty_cache()
        res["cp"] = cp_check(bf, torch, dev)
    finally:
        bf.shutdown()
    return res



def _ce_errors(grads_full, loss_full, grads, loss) -> tuple:
    """The errors, and the name of the parameter with the largest."""
    diff = sum(float((g - grads_full[n]).float().square().sum())
               for n, g in grads.items())
    norm = sum(float(f.float().square().sum()) for f in grads_full.values())
    per = {n: nerr(g, grads_full[n]) for n, g in grads.items()}
    worst = max(per, key=per.get)
    return {"loss": abs(loss - loss_full) / abs(loss_full),
            "grad": per[worst], "grad_l2": math.sqrt(diff / norm)}, worst


def ce_check(bf, fl, torch, dev) -> dict:
    """``chunked_ce_loss`` against ``lm_loss`` on the headline model (bf16,
    flash) and one batch: the loss and every gradient, within the
    ``TOL_CE_*`` limits; then with one chunk's targets rolled by one
    position, which must land beyond a limit."""
    from bluefog_tpu_torch.parallel import chunked_ce_loss

    model = headline_model(bf, torch, dev, fl.flash_attention)
    toks, tgts = headline_batch(torch, dev)

    def loss_and_grads(loss):
        model.zero_grad(set_to_none=True)
        loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in
                                      model.named_parameters()}

    loss_full, grads_full = loss_and_grads(bf.models.lm_loss(model,
                                                             (toks, tgts)))
    loss_c, grads_c = loss_and_grads(chunked_ce_loss(model, toks, tgts,
                                                     chunk=CE_CHUNK))
    errs, worst = _ce_errors(grads_full, loss_full, grads_c, loss_c)
    rolled = tgts.clone()
    rolled[:, :CE_CHUNK] = tgts[:, :CE_CHUNK].roll(1, dims=1)
    loss_f, grads_f = loss_and_grads(chunked_ce_loss(model, toks, rolled,
                                                     chunk=CE_CHUNK))
    planted, worst_f = _ce_errors(grads_full, loss_full, grads_f, loss_f)
    limits = {"loss": TOL_CE_LOSS, "grad": TOL_CE_GRAD,
              "grad_l2": TOL_CE_GRAD_L2}

    def beyond(e):
        return sorted(n for n, v in e.items() if not v <= limits[n])

    log(f"ce check (headline model, bf16, chunk {CE_CHUNK}): loss full="
        f"{loss_full:.6f} chunked={loss_c:.6f} rel err={errs['loss']:.3e} "
        f"grad max={errs['grad']:.3e} ({worst}) l2={errs['grad_l2']:.3e}")
    log(f"ce check, planted (chunk 0's targets rolled by one): loss "
        f"{loss_f:.6f} rel err={planted['loss']:.3e} grad max="
        f"{planted['grad']:.3e} ({worst_f}) l2={planted['grad_l2']:.3e}; "
        f"beyond the limits: {beyond(planted)}")
    if beyond(errs):
        raise RuntimeError(f"chunked_ce_loss disagrees with lm_loss beyond "
                           f"{limits}: {errs}")
    if not beyond(planted):
        raise RuntimeError(f"the ce check missed the planted fault: "
                           f"{planted}")
    return {"errors": errs, "planted": planted}


LM_BENCH_FORMS = (("full logits", False, False), ("chunked ce", False, True),
                  ("remat + chunked ce", True, True))


def lm_bench_phase(fl, torch, dev) -> dict:
    """``lm_bench.run`` at its defaults in the three forms, each with the
    launch counts and the peak memory reset just before and read just
    after. Raises on a non-finite loss, on launch counts other than the
    layers' per step (K1 twice under remat: the recompute), or unless the
    chunked forms peak below the full-logits form."""
    from bluefog_tpu_torch import lm_bench

    args = lm_bench.DEFAULTS
    steps = args["warmup"] + args["steps"]
    out = {}
    for name, remat, chunked in LM_BENCH_FORMS:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fl.reset_launch_counts()
        res = lm_bench.run(**args, remat=remat, chunked_ce=chunked,
                           device=dev)
        counts = dict(fl.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        log(f"lm_bench {name}: peak_mem_GiB={peak / 2**30:.3f} launches "
            f"{counts}")
        layers = args["num_layers"]
        want = {"flash_fwd": layers * (2 if remat else 1),
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
        bad = {k: c for k, c in counts.items() if c != want[k] * steps}
        if bad:
            raise RuntimeError(f"lm_bench {name}: launches {bad} in {steps} "
                               f"steps, expected {want} a step")
        if not math.isfinite(res["final_loss"]):
            raise RuntimeError(f"lm_bench {name}: non-finite loss {res}")
        out[name] = dict(res, peak_bytes=peak, counts=counts)
    full = out["full logits"]["peak_bytes"]
    for name in ("chunked ce", "remat + chunked ce"):
        if not out[name]["peak_bytes"] < full:
            raise RuntimeError(f"lm_bench {name} peaked at "
                               f"{out[name]['peak_bytes']} bytes, not below "
                               f"the full logits' {full}")
    return out


def switch_check(bf, torch, dev) -> dict:
    """One f32 SwitchFFN (d 256, d_ff 1024, E 4) on the card with TF32 off
    against the same weights on the CPU: output and every gradient within
    ``TOL_SWITCH`` (``nerr``), routing identical."""
    gen = torch.Generator().manual_seed(17)
    x = torch.randn((2, 320, 256), generator=gen)
    cot = torch.randn((2, 320, 256), generator=gen)
    weights = bf.parallel.SwitchFFN(256, 4, 1024, device="cpu",
                                    seed=5).state_dict()
    outs, grads, routes = {}, {}, {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # a true f32 product
    try:
        for where in ("cpu", dev):
            mod = bf.parallel.SwitchFFN(256, 4, 1024, device=where)
            mod.load_state_dict(weights)
            xw = x.to(where, copy=True).requires_grad_(True)
            y = mod(xw)
            (y * cot.to(where)).sum().backward()
            key = str(where)
            outs[key] = y.detach().cpu()
            grads[key] = [xw.grad.cpu()] + [p.grad.cpu()
                                            for p in mod.parameters()]
            routes[key] = mod.route(xw.detach())[1].cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu, card = "cpu", str(dev)
    errs = {"out": nerr(outs[card], outs[cpu]),
            "grad": max(nerr(a, b) for a, b in zip(grads[card], grads[cpu]))}
    same = bool(torch.equal(routes[card], routes[cpu]))
    experts = len(set(routes[cpu].flatten().tolist()))
    log(f"switch check (f32, d 256, d_ff 1024, E 4, card vs CPU): out="
        f"{errs['out']:.3e} grad max={errs['grad']:.3e} routing identical="
        f"{same} experts used={experts}")
    if not (errs["out"] <= TOL_SWITCH and errs["grad"] <= TOL_SWITCH):
        raise RuntimeError(f"SwitchFFN on the card disagrees with the CPU "
                           f"beyond {TOL_SWITCH}: {errs}")
    if not same:
        raise RuntimeError("SwitchFFN routed tokens differently on the card")
    return dict(errs, routing_identical=same)


def moe_train(bf, fl, torch) -> dict:
    """The MoE LM at the headline width (``MOE_EXPERTS`` experts, blocks 1
    and 3 MoE) under ``DistributedNeighborAllreduceOptimizer`` around Adam
    with ``chunked_ce_loss``: ms/step, tokens/s, mfu, peak memory, losses,
    and ``LAYERS`` launches of each kernel per step."""
    from bluefog_tpu_torch import lm_bench

    bf.init()
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        model, opt, batch = headline(
            bf, torch, dev, fl.flash_attention, loss_fn=chunked_lm_loss,
            num_experts=MOE_EXPERTS, moe_every=2)
        run = _train_steps(fl, torch, opt, batch)
    finally:
        bf.shutdown()
    dt = run["dt"]
    n_mat = lm_bench.matmul_param_count(model)
    n_params = sum(p.numel() for p in model.parameters())
    flops = lm_bench.model_flops(n_mat, 1, SEQ, LAYERS, 2048)
    mfu = flops / dt / PEAK_BF16
    log(f"moe train: E={MOE_EXPERTS} layers={LAYERS} (MoE blocks 1, 3) "
        f"seq={SEQ} params={n_params} matmul params={n_mat} "
        f"TFLOP/step={flops / 1e12:.3f} ms/step={dt * 1e3:.3f} "
        f"tokens/s={SEQ / dt:.1f} mfu={mfu:.4f} "
        f"peak_mem_GiB={run['peak'] / 2**30:.3f}")
    log("moe train losses: " + " ".join(f"{x:.5f}" for x in run["losses"]))
    log(f"moe train launches: {run['counts']}")
    _check_training("moe train", run, LAYERS)
    return {"counts": run["counts"], "ms_per_step": dt * 1e3,
            "tokens_per_s": SEQ / dt, "mfu": mfu, "peak_bytes": run["peak"],
            "params": n_params, "matmul_params": n_mat,
            "losses": run["losses"]}


def _vexperts(torch, gate, up, down, xs, capacity: int, dtype,
              fault=None) -> tuple:
    """The virtual group's forward: ``switch_send`` on every rank, the send
    buffers transposed (expert j gets every rank's block j, in rank order),
    ``expert_ffn`` with expert j's weights, the results transposed back and
    ``switch_combine`` on every rank. Returns each rank's output and its
    ``switch_send`` tuple. ``fault="wrong_expert"`` delivers rank 0's
    buffer for the expert most of its tokens chose to the next expert, and
    that one's to it."""
    from bluefog_tpu_torch.parallel import expert as ex

    n = len(xs)
    sent = [ex.switch_send(gate, x, n, capacity, dtype) for x in xs]
    swap = {}
    if fault == "wrong_expert":
        e = int(torch.bincount(sent[0][4], minlength=n).argmax())
        swap = {e: (e + 1) % n, (e + 1) % n: e}
    recv = []
    for j in range(n):
        blocks = [s[0][j] for s in sent]
        blocks[0] = sent[0][0][swap.get(j, j)]
        recv.append(torch.stack(blocks))
    ys = [ex.expert_ffn(recv[j], up[j:j + 1], down[j:j + 1], dtype)
          for j in range(n)]
    outs = [ex.switch_combine(s[1], torch.stack([y[r] for y in ys]), s[2],
                              xs[r].dtype) for r, s in enumerate(sent)]
    return outs, sent


def _kept_by_routing(torch, best, n: int, capacity: int):
    """[t] bool: a token is kept when at most ``capacity`` tokens before it
    (itself included), in token order, chose its expert."""
    seen = [0] * n
    kept = []
    for e in best.tolist():
        seen[e] += 1
        kept.append(seen[e] <= capacity)
    return torch.tensor(kept, device=best.device)


def virtual_experts(torch, dev, t: int, d: int, d_ff: int, n: int, dtype,
                    drop_factor: float = EP_DROP_FACTOR,
                    skew: float = EP_SKEW, seed: int = 41,
                    timed: bool = False) -> dict:
    """(a) The virtual expert-parallel group of ``n`` ranks of ``t`` tokens
    against the dense ``SwitchFFN`` oracle: errors at capacity factor n, the
    drop check at ``drop_factor``, ``EP_FAULTS`` planted, and with
    ``timed`` the CUDA-event ms of each direction summed over the virtual
    ranks beside the oracle's."""
    from bluefog_tpu_torch.parallel import SwitchFFN

    oracle = SwitchFFN(d, n, d_ff, dtype, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g0 = oracle.gate.detach()[:, 0]
    x = (torch.randn((n * t, d), generator=gen, device=dev)
         + skew * g0 / g0.square().sum())
    cot = torch.randn((n * t, d), generator=gen, device=dev)
    xs_of = lambda a: list(a.split(t))  # noqa: E731
    xo = x.clone().requires_grad_(True)
    want = torch.cat([oracle(xr) for xr in xs_of(xo)])
    want.backward(cot)
    ref = {"out": want.detach(), "dx": xo.grad, "dgate": oracle.gate.grad,
           "dup": oracle.up.grad, "ddown": oracle.down.grad}
    ws = [w.detach().clone().requires_grad_(True)
          for w in (oracle.gate, oracle.up, oracle.down)]
    xv = x.clone().requires_grad_(True)
    outs, sent = _vexperts(torch, *ws, xs_of(xv), math.ceil(n * t / n),
                           dtype)
    got = torch.cat(outs)
    got.backward(cot)
    errors = {k: nerr(a, ref[k]) for k, a in (
        ("out", got.detach()), ("dx", xv.grad), ("dgate", ws[0].grad),
        ("dup", ws[1].grad), ("ddown", ws[2].grad))}
    with torch.no_grad():
        routes = [oracle.route(xr)[1] for xr in xs_of(x)]
        same = all(bool(torch.equal(s[4], r)) for s, r in zip(sent, routes))
        planted = {f: nerr(torch.cat(_vexperts(
            torch, *ws, xs_of(x), t, dtype, fault=f)[0]), ref["out"])
            for f in EP_FAULTS}
        cap = math.ceil(drop_factor * t / n)
        outs, sent = _vexperts(torch, *ws, xs_of(x), cap, dtype)
        kept = torch.cat([_kept_by_routing(torch, s[4], n, cap)
                          for s in sent])
        got = torch.cat(outs)
        counts = [torch.bincount(s[4], minlength=n) for s in sent]
        expected = sum(int((c - cap).clamp_min(0).sum()) for c in counts)
        drops = {"capacity": cap, "kept_err": nerr(got[kept],
                                                    ref["out"][kept]),
                 "dropped_max": float(got[~kept].abs().max())
                 if bool((~kept).any()) else 0.0,
                 "dropped": int((~kept).sum()),
                 "zero_rows": int((got.abs().amax(-1) == 0).sum()),
                 "expected": expected}
    res = {"errors": errors, "drops": drops, "planted": planted,
           "routing_identical": same}
    if timed:
        res["ms"] = _experts_ms(torch, oracle, ws, x, cot, t, cap, dtype)
    return res


def _experts_ms(torch, oracle, ws, x, cot, t: int, cap: int, dtype) -> dict:
    """CUDA-event ms of the virtual group at capacity ``cap``, forward
    alone and forward plus backward, summed over its ranks, and of the
    dense oracle over all the tokens at once."""
    xs = list(x.split(t))

    def v_fwd():
        with torch.no_grad():
            _vexperts(torch, *ws, xs, cap, dtype)

    def v_both():
        outs, _ = _vexperts(torch, *ws, xs, cap, dtype)
        torch.cat(outs).backward(cot)

    def o_fwd():
        with torch.no_grad():
            oracle(x)

    def o_both():
        oracle(x).backward(cot)

    ms = {"virtual fwd": cuda_ms(v_fwd, 10), "virtual fwd+bwd":
          cuda_ms(v_both, 10), "oracle fwd": cuda_ms(o_fwd, 10),
          "oracle fwd+bwd": cuda_ms(o_both, 10)}
    ms["virtual bwd"] = ms["virtual fwd+bwd"] - ms["virtual fwd"]
    ms["oracle bwd"] = ms["oracle fwd+bwd"] - ms["oracle fwd"]
    return ms


def experts_check(torch, dev) -> dict:
    """(a) at the headline MoE width, bf16: the limits, the drop count, the
    planted faults and the times."""
    res = virtual_experts(torch, dev, EP_TOKENS, 2048, 8192, EP_N,
                          torch.bfloat16, timed=True)
    e, dr = res["errors"], res["drops"]
    log(f"experts check (virtual group of {EP_N}, {EP_TOKENS} tokens each, "
        f"d 2048, d_ff 8192, bf16, vs the dense SwitchFFN): "
        + " ".join(f"{k}={v:.3e}" for k, v in e.items())
        + f"; limit TOL_EP={TOL_EP}; routing identical="
        f"{res['routing_identical']}")
    log(f"experts drops (capacity factor {EP_DROP_FACTOR}, capacity "
        f"{dr['capacity']}): kept err={dr['kept_err']:.3e} dropped max="
        f"{dr['dropped_max']} dropped={dr['dropped']} zero rows="
        f"{dr['zero_rows']} expected from the routing={dr['expected']}")
    for f, v in res["planted"].items():
        log(f"experts check, planted {f}: out={v:.3e}")
    log("experts ms (CUDA events, summed over the virtual ranks, capacity "
        f"factor {EP_DROP_FACTOR}): "
        + " ".join(f"{k}={v:.4f}" for k, v in res["ms"].items()))
    if not res["routing_identical"]:
        raise RuntimeError("the virtual group routed apart from the oracle")
    bad = {k: v for k, v in e.items() if not v <= TOL_EP}
    if bad or not dr["kept_err"] <= TOL_EP:
        raise RuntimeError(f"the virtual expert group disagrees with the "
                           f"dense oracle beyond TOL_EP={TOL_EP}: {bad} "
                           f"{dr}")
    if not (dr["dropped_max"] == 0.0 and dr["dropped"] == dr["expected"]
            == dr["zero_rows"] and dr["expected"] > 0):
        raise RuntimeError(f"the dropped tokens are not the routing's: {dr}")
    for f, v in res["planted"].items():
        if v <= TOL_EP:
            raise RuntimeError(f"the experts check missed the planted "
                               f"fault {f}: {v}")
    return res


def ep_train(bf, fl, torch) -> dict:
    """(b) The expert-parallel MoE LM at the headline width, world 1 (E=1,
    blocks 1 and 3 MoE), ``ep_lm_loss_fn`` with flash attention under
    plain Adam: the first loss against the dense-mode E=1 model's, ms/step,
    tokens/s, peak memory, falling losses, ``LAYERS`` launches of each
    kernel per step; beside it the dense E=1 model's ms/step and peak under
    the same Adam (what the dispatch costs where it routes nothing)."""
    from bluefog_tpu_torch.parallel import ep_lm_loss_fn

    bf.init()
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        batch = headline_batch(torch, dev)
        dense = headline_model(bf, torch, dev, fl.flash_attention,
                               num_experts=1, moe_every=2)
        with torch.no_grad():
            want = float(bf.models.lm_loss(dense, batch)) + 0.01 * 2
        base = _train_steps(fl, torch, _plain_adam(dense, bf.models.lm_loss),
                            batch)
        del dense
        torch.cuda.empty_cache()
        model = headline_model(bf, torch, dev, fl.flash_attention,
                               num_experts=1, moe_every=2,
                               expert_axis="expert")
        opt = _plain_adam(model, ep_lm_loss_fn(model))
        run = _train_steps(fl, torch, opt, batch)
    finally:
        bf.shutdown()
    dt = run["dt"]
    rel = abs(run["losses"][0] - want) / abs(want)
    log(f"ep train (expert-parallel MoE LM, E=1, world 1, plain Adam): "
        f"layers={LAYERS} (MoE blocks 1, 3) seq={SEQ} ms/step="
        f"{dt * 1e3:.3f} tokens/s={SEQ / dt:.1f} peak_mem_GiB="
        f"{run['peak'] / 2**30:.3f}")
    log("ep train losses: " + " ".join(f"{x:.5f}" for x in run["losses"])
        + f"; first against the dense E=1 model's {want:.5f}: relative "
        f"{rel:.3e} (limit TOL_EP_LOSS={TOL_EP_LOSS})")
    log(f"ep train, the dense E=1 model the same way: ms/step="
        f"{base['dt'] * 1e3:.3f} peak_mem_GiB={base['peak'] / 2**30:.3f}")
    log(f"ep train launches: {run['counts']}")
    _check_training("ep train", run, LAYERS)
    if not rel <= TOL_EP_LOSS:
        raise RuntimeError(f"the expert-parallel LM's loss {run['losses'][0]}"
                           f" differs from the dense model's {want}")
    return {"counts": run["counts"], "ms_per_step": dt * 1e3,
            "tokens_per_s": SEQ / dt, "peak_bytes": run["peak"],
            "losses": run["losses"], "vs_dense": rel,
            "dense_ms_per_step": base["dt"] * 1e3,
            "dense_peak_bytes": base["peak"]}


def _tp_models(torch, dense, n: int, fault=None) -> list:
    """The virtual group's models: rank r's copy of ``dense`` holding its
    slices (``tensor.tp_layout`` and ``shard_of``, as ``tp_shard_params``
    cuts them). ``fault="contiguous_qkv"`` gives rank r the r-th contiguous
    rows of ``qkv`` instead of its heads' q, k and v rows."""
    import copy

    from bluefog_tpu_torch.parallel import tensor as tp

    layout = tp.tp_layout(dense, n)
    models = []
    for r in range(n):
        m = copy.deepcopy(dense)
        with torch.no_grad():
            for name, dim in layout.items():
                if dim is None:
                    continue
                mod, leaf = tp._owner(m, name)
                full = getattr(mod, leaf)
                part = tp.shard_of(name, full, dim, r, n)
                if fault == "contiguous_qkv" and name.endswith("qkv.weight"):
                    w = full.shape[0] // n
                    part = full[r * w:(r + 1) * w]
                setattr(mod, leaf, torch.nn.Parameter(part.clone()))
        m.tp_ranks = n
        m.zero_grad(set_to_none=True)
        models.append(m)
    return models, layout


def _tp_loss(torch, logits: list, targets):
    """The sum of the virtual ranks' losses, each the dense ``lm_loss``."""
    import torch.nn.functional as F

    return sum(F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                               targets.reshape(-1)) for lg in logits)


def virtual_tp(bf, fl, torch, dense, batch, n: int = TP_N,
               timed: bool = False) -> dict:
    """(a) The virtual tensor-parallel group of ``n`` ranks against
    ``dense``: logits and every rank's gradient (``nerr`` against the dense
    gradient sliced to the rank, the largest over ranks and parameters),
    the launch counts of one forward and backward, the planted faults, and
    with ``timed`` each direction's CUDA-event ms summed over the virtual
    ranks beside the dense model's."""
    from bluefog_tpu_torch.parallel import tensor as tp

    toks, tgts = batch
    dense.zero_grad(set_to_none=True)
    with torch.no_grad():
        want = dense(toks)
    bf.models.lm_loss(dense, batch).backward()
    models, layout = _tp_models(torch, dense, n)
    fl.reset_launch_counts()
    logits = tp.tp_logits(models, [toks] * n)
    _tp_loss(torch, logits, tgts).backward()
    launches = dict(fl.launch_counts)
    errors = {"logits": max(nerr(lg.detach(), want.detach())
                            for lg in logits)}
    worst = (0.0, None)
    for r, m in enumerate(models):
        for name, dim in layout.items():
            ref = dense.get_parameter(name).grad
            if dim is not None:
                ref = tp.shard_of(name, ref, dim, r, n)
            e = nerr(m.get_parameter(name).grad, ref)
            worst = max(worst, (e, name))
    errors["grad"], errors["grad_worst"] = worst
    del logits
    planted = {}
    with torch.no_grad():
        bad, _ = _tp_models(torch, dense, n, fault="contiguous_qkv")
        planted["contiguous_qkv"] = nerr(tp.tp_logits(bad, [toks] * n)[0],
                                         want)
        del bad
        reduce = tp.model_reduce
        tp.model_reduce = lambda xs, group=None: reduce(
            [torch.zeros_like(xs[0]), *xs[1:]], group)
        try:
            planted["drop_partial"] = nerr(
                tp.tp_logits(models, [toks] * n)[0], want)
        finally:
            tp.model_reduce = reduce
    res = {"errors": errors, "planted": planted, "launches": launches}
    if timed:
        res["ms"] = _tp_ms(torch, dense, models, batch, n)
    return res


def _tp_ms(torch, dense, models, batch, n: int) -> dict:
    from bluefog_tpu_torch.parallel import tensor as tp

    toks, tgts = batch

    def v_fwd():
        with torch.no_grad():
            tp.tp_logits(models, [toks] * n)

    def v_both():
        for m in models:
            m.zero_grad(set_to_none=True)
        _tp_loss(torch, tp.tp_logits(models, [toks] * n), tgts).backward()

    def d_fwd():
        with torch.no_grad():
            dense(toks)

    def d_both():
        dense.zero_grad(set_to_none=True)
        _tp_loss(torch, [dense(toks)], tgts).backward()

    ms = {"virtual fwd": cuda_ms(v_fwd, 5), "virtual fwd+bwd":
          cuda_ms(v_both, 5), "dense fwd": cuda_ms(d_fwd, 5),
          "dense fwd+bwd": cuda_ms(d_both, 5)}
    ms["virtual bwd"] = ms["virtual fwd+bwd"] - ms["virtual fwd"]
    ms["dense bwd"] = ms["dense fwd+bwd"] - ms["dense fwd"]
    return ms


def tp_check(bf, fl, torch, dev) -> dict:
    """(a) at the headline width: the limits, the launches, the planted
    faults and the times."""
    dense = headline_model(bf, torch, dev, fl.flash_attention)
    res = virtual_tp(bf, fl, torch, dense, headline_batch(torch, dev),
                     timed=True)
    e = res["errors"]
    log(f"tp check (virtual group of {TP_N}, {16 // TP_N} heads, d_ff "
        f"{8192 // TP_N}, vocab {32768 // TP_N} each, B=1 x {SEQ}, bf16, "
        f"vs the dense flash model): logits={e['logits']:.3e} "
        f"grad={e['grad']:.3e} (worst {e['grad_worst']}); limit "
        f"TOL_TP={TOL_TP}")
    log(f"tp check launches (one forward and backward): {res['launches']}")
    for f, v in res["planted"].items():
        log(f"tp check, planted {f}: logits={v:.3e}")
    log("tp ms (CUDA events, summed over the virtual ranks): "
        + " ".join(f"{k}={v:.4f}" for k, v in res["ms"].items()))
    if not (e["logits"] <= TOL_TP and e["grad"] <= TOL_TP):
        raise RuntimeError(f"the virtual TP group disagrees with the dense "
                           f"model beyond TOL_TP={TOL_TP}: {e}")
    want = TP_N * LAYERS
    if any(c != want for c in res["launches"].values()):
        raise RuntimeError(f"tp check: expected {want} launches of each "
                           f"kernel, got {res['launches']}")
    for f, v in res["planted"].items():
        if v <= TOL_TP:
            raise RuntimeError(f"the tp check missed the planted fault "
                               f"{f}: {v}")
    return res


def _pp_leaves(torch, dense, n: int):
    """Fresh leaves for a virtual pipeline of ``n`` stages: each stage's
    ``[1, per, ...]`` chunk and the rest, from ``dense``'s weights."""
    from bluefog_tpu_torch.parallel import pipeline as pp

    sd = {k: v.detach() for k, v in dense.state_dict().items()}
    stacked, rest = pp.pp_stack_params(sd, n)
    stages = [{k: v[s:s + 1].clone().requires_grad_()
               for k, v in stacked.items()} for s in range(n)]
    return stages, {k: v.clone().requires_grad_() for k, v in rest.items()}


def _pp_logits(dense, stages, rest, toks, handoff):
    """The virtual pipeline's plain forward: every sequence of ``toks`` a
    microbatch, the embedding and the head around ``pp_schedule``."""
    from bluefog_tpu_torch.parallel import pipeline as pp

    n = len(stages)
    x = pp._module(dense.embed, "weight", rest["embed.weight"], toks)
    mb = x.reshape((x.shape[0], 1) + tuple(x.shape[1:]))
    outs = pp.pp_schedule(dense, stages, list(range(n)), n, handoff, mb)
    x = pp._module(dense.final_norm, "scale", rest["final_norm.scale"],
                   outs[-1].reshape(x.shape))
    return pp._module(dense.lm_head, "weight", rest["lm_head.weight"],
                      x).float()


def _pp_fused(torch, dense, stages, rest, toks, tgts):
    from bluefog_tpu_torch.parallel import pipeline as pp

    n = len(stages)
    parts = pp.pp_fused_schedule(dense, stages, list(range(n)), n,
                                 pp.virtual_handoff, rest, toks[:, None],
                                 tgts[:, None])
    return torch.stack(parts).sum() / toks.shape[0]


def _pp_grad_err(dense, stages, rest) -> tuple:
    per = next(iter(stages[0].values())).shape[1]
    worst = (0.0, None)
    for s, st in enumerate(stages):
        for k, t in st.items():
            for j in range(per):
                ref = dense.get_parameter(f"block_{s * per + j}.{k}").grad
                worst = max(worst, (nerr(t.grad[0, j], ref),
                                    f"block_{s * per + j}.{k}"))
    for k, t in rest.items():
        worst = max(worst, (nerr(t.grad, dense.get_parameter(k).grad), k))
    return worst


def _zero(stages, rest) -> None:
    for t in [*(v for st in stages for v in st.values()), *rest.values()]:
        t.grad = None


def virtual_pp(bf, fl, torch, dense, batch, n: int = PP_N,
               timed: bool = False) -> dict:
    """(b) The virtual pipeline of ``n`` stages against ``dense`` on the
    sequences of ``batch`` (one microbatch each): logits, gradients, the
    plain and fused losses, the launches of one plain forward and
    backward, the planted fault; with ``timed`` the ms and peak memory of
    each form's forward and backward."""
    import torch.nn.functional as F
    from bluefog_tpu_torch.parallel import pipeline as pp

    toks, tgts = batch
    dense.zero_grad(set_to_none=True)
    want_loss = bf.models.lm_loss(dense, batch)
    want_loss.backward()
    stages, rest = _pp_leaves(torch, dense, n)
    fl.reset_launch_counts()
    logits = _pp_logits(dense, stages, rest, toks, pp.virtual_handoff)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgts.reshape(-1))
    loss.backward()
    launches = dict(fl.launch_counts)
    with torch.no_grad():
        want = dense(toks)
        errors = {"logits": nerr(logits.detach(), want)}
        del logits
        # each stage handed the output of the stage after it (zeros where
        # that one was idle)
        zero = torch.zeros((1, toks.shape[1], dense.embed.weight.shape[1]),
                           dtype=dense.dtype, device=toks.device)
        planted = {"handoff_backwards": nerr(_pp_logits(
            dense, stages, rest, toks,
            lambda xs, step: [zero if x is None else x for x in
                              pp.virtual_handoff(xs, -step)]), want)}
        del want
    errors["grad"], errors["grad_worst"] = _pp_grad_err(dense, stages, rest)
    _zero(stages, rest)
    fused = _pp_fused(torch, dense, stages, rest, toks, tgts)
    fused.backward()
    errors["fused_grad"], errors["fused_grad_worst"] = _pp_grad_err(
        dense, stages, rest)
    wl = float(want_loss.detach())
    losses = {"dense": wl, "plain": float(loss.detach()),
              "fused": float(fused.detach())}
    errors["plain_loss"] = abs(losses["plain"] - wl) / abs(wl)
    errors["fused_loss"] = abs(losses["fused"] - wl) / abs(wl)
    res = {"errors": errors, "planted": planted, "launches": launches,
           "losses": losses}
    if timed:
        res["ms"], res["peak_bytes"] = _pp_ms(torch, dense, stages, rest,
                                              batch)
    return res


def _pp_ms(torch, dense, stages, rest, batch):
    """CUDA-event ms of one forward and backward of each form (and of the
    dense model), with each one's peak memory."""
    import torch.nn.functional as F
    from bluefog_tpu_torch.parallel import pipeline as pp

    toks, tgts = batch

    def plain():
        _zero(stages, rest)
        lg = _pp_logits(dense, stages, rest, toks, pp.virtual_handoff)
        F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                        tgts.reshape(-1)).backward()

    def fused():
        _zero(stages, rest)
        _pp_fused(torch, dense, stages, rest, toks, tgts).backward()

    def whole():
        dense.zero_grad(set_to_none=True)
        lg = dense(toks)
        F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                        tgts.reshape(-1)).backward()

    ms, peak = {}, {}
    for key, fn in (("plain", plain), ("fused", fused), ("dense", whole)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[key] = torch.cuda.max_memory_allocated()
        ms[key] = cuda_ms(fn, 3, warmup=0)
    return ms, peak


def pp_check(bf, fl, torch, dev) -> dict:
    """(b) at the headline width, one layer per stage."""
    dense = headline_model(bf, torch, dev, fl.flash_attention)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, 32768, (PP_N, SEQ), generator=gen, device=dev)
    res = virtual_pp(bf, fl, torch, dense, (toks, toks.roll(-1, dims=1)),
                     timed=True)
    e = res["errors"]
    log(f"pp check (virtual pipeline of {PP_N} stages, {LAYERS // PP_N} "
        f"layer(s) each, {PP_N} microbatches of 1 x {SEQ}, bf16, vs the "
        f"dense flash model): logits={e['logits']:.3e} grad={e['grad']:.3e} "
        f"(worst {e['grad_worst']}) fused grad={e['fused_grad']:.3e}; limit "
        f"TOL_PP={TOL_PP}")
    log(f"pp check losses: {res['losses']}; relative plain="
        f"{e['plain_loss']:.3e} fused={e['fused_loss']:.3e} (limit "
        f"TOL_PP_LOSS={TOL_PP_LOSS})")
    log(f"pp check launches (one plain forward and backward): "
        f"{res['launches']}")
    for f, v in res["planted"].items():
        log(f"pp check, planted {f}: logits={v:.3e}")
    log("pp ms (CUDA events, forward and backward): "
        + " ".join(f"{k}={v:.3f}" for k, v in res["ms"].items())
        + "; peak_mem_GiB: " + " ".join(
            f"{k}={v / 2**30:.3f}" for k, v in res["peak_bytes"].items()))
    bad = {k: e[k] for k in ("logits", "grad", "fused_grad")
           if not e[k] <= TOL_PP}
    bad.update({k: e[k] for k in ("plain_loss", "fused_loss")
                if not e[k] <= TOL_PP_LOSS})
    if bad:
        raise RuntimeError(f"the virtual pipeline disagrees with the dense "
                           f"model: {bad}")
    fwd = PP_N * LAYERS            # M microbatches x L layers
    expect = {"flash_fwd": 2 * fwd, "flash_bwd_dq": fwd,
              "flash_bwd_dkv": fwd}
    if res["launches"] != expect:
        raise RuntimeError(f"pp check: expected launches {expect}, got "
                           f"{res['launches']}")
    for f, v in res["planted"].items():
        if v <= TOL_PP:
            raise RuntimeError(f"the pp check missed the planted fault "
                               f"{f}: {v}")
    return res


def _pp_one_microbatch(torch, model, batch, params, optimizer,
                       pp_train_init, pp_train_step_fn, pp_loss_fn) -> list:
    """The planted fault of (c): ``WARMUP + STEPS`` pipelined steps, each
    trained on the batch's first microbatch alone; each step's loss is
    read over the whole batch (``pp_loss_fn``, no gradient) before it."""
    stage, rest, adam = pp_train_init(model, None, params, optimizer)
    step = pp_train_step_fn(model, None, adam, 1)
    whole = pp_loss_fn(model, None, PP_TRAIN_M)
    mb = batch[0].shape[0] // PP_TRAIN_M
    losses = []
    for _ in range(WARMUP + STEPS):
        with torch.no_grad():
            losses.append(float(whole(stage, rest, batch)))
        step(stage, rest, tuple(t[:mb] for t in batch))
    del stage, rest, adam
    torch.cuda.empty_cache()
    return losses


def parallel_train(bf, fl, torch) -> dict:
    """(c) World 1 on NCCL: ``tp_loss_fn`` and ``pp_train_step_fn`` (plain
    and fused) at the headline width, each beside plain Adam on
    ``lm_loss`` from the same seed on the same batch."""
    import functools
    import types

    from bluefog_tpu_torch.parallel import (pp_loss_fn, pp_train_init,
                                            pp_train_step_fn, tp_loss_fn,
                                            tp_shard_params)

    bf.init()
    out = {}
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        batch = headline_batch(torch, dev)
        model = headline_model(bf, torch, dev, fl.flash_attention)
        out["dense"] = _train_steps(fl, torch, _plain_adam(
            model, bf.models.lm_loss), batch)
        del model
        model = tp_shard_params(
            headline_model(bf, torch, dev, fl.flash_attention))
        out["tp"] = _train_steps(fl, torch, _plain_adam(
            model, tp_loss_fn(model)), batch)
        del model
        gen = torch.Generator(device=dev).manual_seed(3)
        toks = torch.randint(0, 32768, (PP_TRAIN_B, SEQ), generator=gen,
                             device=dev)
        pbatch = (toks, toks.roll(-1, dims=1))
        model = headline_model(bf, torch, dev, fl.flash_attention)
        out["pp dense"] = _train_steps(fl, torch, _plain_adam(
            model, bf.models.lm_loss), pbatch)
        for key, fused in (("pp", False), ("pp fused", True)):
            params = headline_model(bf, torch, dev,
                                    fl.flash_attention).state_dict()
            stage, rest, adam = pp_train_init(
                model, None, params,
                functools.partial(torch.optim.Adam, lr=1e-3))
            del params
            step = pp_train_step_fn(model, None, adam, PP_TRAIN_M, fused)
            opt = types.SimpleNamespace(
                step=lambda b, step=step, stage=stage, rest=rest:
                {"loss": step(stage, rest, b)})
            out[key] = _train_steps(fl, torch, opt, pbatch)
            del stage, rest, adam
            torch.cuda.empty_cache()
        planted = _pp_one_microbatch(torch, model, pbatch, headline_model(
            bf, torch, dev, fl.flash_attention).state_dict(), functools.partial(
                torch.optim.Adam, lr=1e-3), pp_train_init, pp_train_step_fn,
            pp_loss_fn)
    finally:
        bf.shutdown()
    res = {}
    for key, run in out.items():
        tokens = (PP_TRAIN_B if key.startswith("pp") else 1) * SEQ
        dt = run["dt"]
        ref = out["pp dense" if key.startswith("pp") else "dense"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref))
        log(f"parallel train ({key}, world 1, plain Adam, B="
            f"{tokens // SEQ} x {SEQ}): ms/step={dt * 1e3:.3f} tokens/s="
            f"{tokens / dt:.1f} peak_mem_GiB={run['peak'] / 2**30:.3f}")
        log(f"parallel train ({key}) losses: "
            + " ".join(f"{x:.5f}" for x in run["losses"])
            + f"; largest relative difference from plain Adam on lm_loss "
            f"{rel:.3e}")
        log(f"parallel train ({key}) launches: {run['counts']}")
        res[key] = {"counts": run["counts"], "ms_per_step": dt * 1e3,
                    "tokens_per_s": tokens / dt, "peak_bytes": run["peak"],
                    "losses": run["losses"], "vs_dense": rel}
    _check_training("parallel train (tp)", out["tp"], LAYERS)
    if res["tp"]["vs_dense"] != 0.0:
        raise RuntimeError(f"tp_loss_fn at n=1 is not bit-identical to "
                           f"lm_loss: {res['tp']['losses']} vs "
                           f"{res['dense']['losses']}")
    per_step = PP_TRAIN_M * LAYERS
    ref_pp = out["pp dense"]["losses"]
    for key in ("pp", "pp fused"):
        # K1 runs twice per layer and microbatch: forward and recompute
        run = dict(out[key], counts={k: v // (2 if k == "flash_fwd" else 1)
                                     for k, v in out[key]["counts"].items()})
        _check_training(f"parallel train ({key})", run, per_step)
        first = abs(run["losses"][0] - ref_pp[0]) / abs(ref_pp[0])
        res[key]["first_vs_dense"] = first
        log(f"parallel train ({key}): first loss relative {first:.3e} "
            f"(limit TOL_PP_LOSS={TOL_PP_LOSS}), all "
            f"{res[key]['vs_dense']:.3e} (limit TOL_PP_TRAIN={TOL_PP_TRAIN})")
        if not (first <= TOL_PP_LOSS
                and res[key]["vs_dense"] <= TOL_PP_TRAIN):
            raise RuntimeError(f"{key}: losses {res[key]['losses']} differ "
                               f"from plain Adam's {ref_pp}")
    rels = [abs(a - b) / abs(b) for a, b in zip(planted, ref_pp)]
    first, rel = rels[0], max(rels)
    res["pp planted"] = {"losses": planted, "first_vs_dense": first,
                         "vs_dense": rel}
    log("parallel train, planted one_microbatch (each step trained on the "
        "first microbatch alone): losses " + " ".join(
            f"{x:.5f}" for x in planted) + f"; first relative {first:.3e}, "
        f"all {rel:.3e} (limit TOL_PP_TRAIN={TOL_PP_TRAIN})")
    if rel <= TOL_PP_TRAIN:
        raise RuntimeError(f"the pp training check missed the planted "
                           f"fault one_microbatch: {rel}")
    return res


def parallel(bf, fl, torch, dev) -> dict:
    """The parallel phase (a)-(c)."""
    res = {"tp_check": tp_check(bf, fl, torch, dev)}
    torch.cuda.empty_cache()
    res["pp_check"] = pp_check(bf, fl, torch, dev)
    torch.cuda.empty_cache()
    res["train"] = parallel_train(bf, fl, torch)
    return res


def _torchvision_names(model) -> dict:
    """The port's ResNet ``state_dict`` under torchvision's names (the
    inverse of ``resnet_from_torch``'s renaming), for a checkpoint in
    torchvision's format made from the port's own model."""
    stages = {"BottleneckBlock": [3, 4, 6, 3],
              "BasicBlock": [2, 2, 2, 2]}[model.block_name]
    where = [(s + 1, b) for s, count in enumerate(stages)
             for b in range(count)]
    bn = {"scale": "weight", "bias": "bias", "mean": "running_mean",
          "var": "running_var"}
    out = {}
    for name, t in model.state_dict().items():
        *mods, leaf = name.split(".")
        if mods[0] == "conv_init":
            key = "conv1.weight"
        elif mods[0] == "bn_init":
            key = f"bn1.{bn[leaf]}"
        elif mods[0] == "head":
            key = f"fc.{leaf}"
        else:
            s, b = where[int(mods[0].rsplit("_", 1)[1])]
            kind, _, c = mods[1].partition("_")
            if kind == "Conv":
                sub = f"conv{int(c) + 1}.{leaf}"
            elif kind == "BatchNorm":
                sub = f"bn{int(c) + 1}.{bn[leaf]}"
            elif kind == "conv":            # conv_proj
                sub = f"downsample.0.{leaf}"
            else:                           # norm_proj
                sub = f"downsample.1.{bn[leaf]}"
            key = f"layer{s}.{b}.{sub}"
        out[key] = t
    return out


def examples_check(bf, torch, dev) -> dict:
    """(c) The examples at world 1 on the card, each through its ``main``:
    ``benchmark.py`` at its defaults (its img/s line), a short
    ``resnet.py`` run with a checkpoint and a resume, ``moe.py --experts
    1``, ``mnist.py`` for one epoch, ``average_consensus.py``,
    ``optimization.py`` for each method (``push_diging`` raising); then
    ``resnet_from_torch`` on a ResNet-50 checkpoint in torchvision's
    names: the loaded model's eval logits bit-identical to the source's."""
    import tempfile

    from bluefog_tpu_torch.examples import (average_consensus, benchmark,
                                            mnist, moe, optimization, resnet)
    from bluefog_tpu_torch.utils import resnet_from_torch

    res, secs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    res["benchmark_img_per_s"] = timed("benchmark", lambda: benchmark.main([]))
    with tempfile.TemporaryDirectory(prefix="bft_resnet_") as tmp:
        common = ["--epochs", "2", "--steps-per-epoch", "10",
                  "--checkpoint-format", os.path.join(tmp, "ck-{epoch}")]
        hist, _ = timed("resnet", lambda: resnet.train(
            resnet.parse_args(common)))
        common[1] = "3"
        hist2, _ = timed("resnet resume", lambda: resnet.train(
            resnet.parse_args(common + ["--resume-from",
                                        os.path.join(tmp, "ck-2")])))
        if not (len(hist) == 2 and len(hist2) == 1 and os.path.isdir(
                os.path.join(tmp, "ck-3"))):
            raise RuntimeError(f"resnet.py resume ran {hist2} after {hist}")
        res["resnet_history"] = hist + hist2
    timed("moe", lambda: moe.main(["--experts", "1"]))
    res["mnist_accuracy"] = timed("mnist", lambda: mnist.main(["--epochs",
                                                               "1"]))
    if timed("average_consensus", lambda: average_consensus.main([])) != 0:
        raise RuntimeError("average_consensus.py failed")
    res["optimization"] = {}
    for method in ("diffusion", "exact_diffusion", "gradient_tracking"):
        mse = timed(method, lambda: optimization.main(
            ["--method", method, "--task", "linear_regression",
             "--max-iter", "200"]))
        res["optimization"][method] = mse[-1]
        if not mse[-1] < 1e-3:
            raise RuntimeError(f"optimization.py {method}: {mse[-1]}")
    try:
        optimization.main(["--method", "push_diging", "--max-iter", "1"])
        raise RuntimeError("push_diging did not raise")
    except NotImplementedError as e:
        log(f"push_diging: {e}")

    from bluefog_tpu_torch.models.layers import BatchNorm

    src = bf.models.ResNet50(device=dev, seed=3).eval()
    gen = torch.Generator(device=dev).manual_seed(4)
    _redraw_norms(src, torch, gen)
    with torch.no_grad():
        for mod in src.modules():
            if isinstance(mod, BatchNorm):
                mod.mean.normal_(0.0, 0.1, generator=gen)
                mod.var.uniform_(0.5, 1.5, generator=gen)
    dst = bf.models.ResNet50(device=dev, seed=5).eval()
    dst.load_state_dict(resnet_from_torch(_torchvision_names(src), 50))
    x = torch.randn((8, 224, 224, 3), generator=gen, device=dev)
    with torch.no_grad():
        same = bool(torch.equal(src(x), dst(x)))
    res["resnet_from_torch_identical"] = same
    log(f"examples (world 1 on the card): seconds "
        + " ".join(f"{k}={v:.2f}" for k, v in secs.items())
        + f"; benchmark img/s={res['benchmark_img_per_s']:.1f}; mnist "
        f"accuracy={res['mnist_accuracy']:.3f}; optimization final errors "
        f"{res['optimization']}; resnet_from_torch ResNet-50 eval logits "
        f"bit-identical={same}")
    if not same:
        raise RuntimeError("resnet_from_torch: the loaded ResNet-50's logits "
                           "differ from the source model's")
    res["seconds"] = secs
    return res


def _redraw_norms(model, torch, gen) -> None:
    """BN scales ~ U(0.5, 1.5), those initialised to zero (each block's
    last) ~ U(0.1, 0.3), biases ~ N(0, 0.1): every residual branch carries
    gradient, and the branches stay small as the zero init intends. The
    draw of ``_init`` in ``tests/test_torch_port_vision.py`` (which also
    redraws the buffers; here one train-mode forward sets what is compared)."""
    from bluefog_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                lo, hi = (0.5, 1.5) if bool(mod.scale.any()) else (0.1, 0.3)
                mod.scale.uniform_(lo, hi, generator=gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)


def _plant(fault: str, model) -> None:
    """Plant one of ``VISION_FAULTS`` in ``model``."""
    import torch.nn.functional as F

    block = model.BottleneckBlock_8
    if fault == "drop_branch":
        block.forward = F.relu
    elif fault == "swap_hw":
        model.register_forward_pre_hook(lambda m, a: (a[0].transpose(1, 2),))
    elif fault == "detach_branch":
        block.BatchNorm_2.register_forward_hook(lambda m, a, y: y.detach())
    else:
        raise ValueError(f"unknown fault {fault!r}")


def _vision_errors(bf, torch, dev, fault=None) -> tuple:
    """The bf16-vs-f32 errors of ResNet-50 (seed 0), with ``fault`` planted
    in the bf16 model; the fold too when no fault is. Returns the errors,
    the parameter names ranked by gradient error and those errors."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(13)
    m16 = bf.models.ResNet50(dtype=torch.bfloat16, device=dev, seed=0)
    _redraw_norms(m16, torch, gen)
    m32 = bf.models.ResNet50(dtype=torch.float32, device=dev, seed=0)
    m32.load_state_dict(m16.state_dict())
    if fault is not None:
        _plant(fault, m16)
    start = {k: v.clone() for k, v in m32.named_buffers()}
    x = torch.randn((VISION_BATCH, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (VISION_BATCH,), generator=gen, device=dev)
    logits = {}
    for m in (m16, m32):
        out = m.train()(x)
        F.cross_entropy(out, y).backward()
        logits[m] = out.detach()
    torch.cuda.synchronize()
    errs = {"logits": nerr(logits[m16], logits[m32])}
    g32 = {n: p.grad for n, p in m32.named_parameters()}
    g16 = {n: torch.zeros_like(p) if p.grad is None else p.grad.float()
           for n, p in m16.named_parameters()}
    grads = {n: nerr(g, g32[n]) for n, g in g16.items()}
    ranked = sorted(grads, key=grads.get)
    errs["grad"] = grads[ranked[-1]]
    errs["grad_median"] = grads[ranked[len(ranked) // 2]]
    diff = sum(float((g - g32[n]).square().sum()) for n, g in g16.items())
    norm = sum(float(g.square().sum()) for g in g32.values())
    errs["grad_l2"] = math.sqrt(diff / norm)
    b32 = dict(m32.named_buffers())
    errs["stats"] = max(nerr(b - start[n], b32[n] - start[n])
                        for n, b in m16.named_buffers())
    if fault is None:
        m32.eval()
        folded = bf.models.ResNet50(dtype=torch.float32, fold_bn=True,
                                    device=dev).eval()
        folded.load_state_dict(bf.models.fold_batchnorm(m32.state_dict()))
        with torch.no_grad():
            errs["fold"] = nerr(folded(x), m32(x))
    return errs, ranked, grads


def vision_check(bf, torch, dev) -> dict:
    """ResNet-50 (full width, seed 0) in bf16 ``channels_last`` against the
    same weights in f32 on the card: logits, every parameter gradient, the
    BN buffers after one train-mode forward, and folded against unfolded
    f32 eval logits. Raises past the ``TOL_VISION_*`` limits, or when one of
    ``VISION_FAULTS`` planted in the bf16 model stays within all of them."""
    limits = {"logits": TOL_VISION_LOGITS, "grad": TOL_VISION_GRAD,
              "grad_median": TOL_VISION_GRAD_MEDIAN,
              "grad_l2": TOL_VISION_GRAD_L2, "stats": TOL_VISION_STATS,
              "fold": TOL_VISION_FOLD}

    def beyond(errs):
        return {n: e for n, e in errs.items() if not e <= limits[n]}

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # a true f32 reference
    try:
        errs, ranked, grads = _vision_errors(bf, torch, dev)
        planted = {f: _vision_errors(bf, torch, dev, f)[0]
                   for f in VISION_FAULTS}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log("vision grad errors, largest: " + " ".join(
        f"{n}={grads[n]:.3e}" for n in ranked[-4:]))
    log(f"vision check ResNet-50 B={VISION_BATCH} 224x224, bf16 vs f32: "
        f"logits={errs['logits']:.3e} grad max={errs['grad']:.3e} "
        f"({ranked[-1]}) median={errs['grad_median']:.3e} "
        f"l2={errs['grad_l2']:.3e} bn_stats={errs['stats']:.3e}; fold_bn "
        f"vs unfolded f32 eval logits={errs['fold']:.3e}")
    bad = beyond(errs)
    if bad:
        raise RuntimeError(f"vision check beyond its limits {limits}: {bad}")
    for fault, e in planted.items():
        log(f"vision check, planted {fault}: " + " ".join(
            f"{n}={v:.3e}" for n, v in e.items())
            + f"; beyond the limits: {sorted(beyond(e))}")
        if not beyond(e):
            raise RuntimeError(f"the vision check missed the planted fault "
                               f"{fault}: {e}")
    return dict(errs, worst_grad=ranked[-1])


def vision_train(bf, torch, card: str) -> dict:
    """The root benchmark's step on the port (``bluefog_tpu_torch.bench``):
    ResNet-50 at 128 per card, 224x224, DistributedNeighborAllreduceOptimizer
    around SGD 0.1/0.9, ``bench.WARMUP`` then ``ITERS * BATCHES_PER_ITER``
    timed steps on the resident synthetic batch; then ``HOST_DATA_STEPS``
    steps fed from the uint8 host pool through ``prefetch_to_device``
    (prefetch 2). Raises on a non-finite loss or a loss that does not fall
    (the synthetic labels are all 0)."""
    import itertools

    from bluefog_tpu_torch import bench
    from bluefog_tpu_torch.utils import prefetch_to_device

    opt, batch, sync = bench.setup()
    try:
        dev = batch[0].device
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = bench.ITERS * bench.BATCHES_PER_ITER
        res = bench.run(opt, itertools.repeat(batch), sync, bench.WARMUP,
                        steps)
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in opt.model.parameters())
        img_s = bench.BATCH_PER_CHIP * steps / res["seconds"]
        losses = res["losses"]
        log(f"vision train ({card}): ResNet-50 batch "
            f"{bench.BATCH_PER_CHIP} {bench.IMAGE}x{bench.IMAGE} params="
            f"{n_params} steps={bench.WARMUP}+{steps} img/s/card="
            f"{img_s:.1f} ms/step={res['seconds'] / steps * 1e3:.3f} "
            f"peak_mem_GiB={peak / 2**30:.3f} vs_baseline="
            f"{img_s / bench.BASELINE_IMG_SEC_PER_DEVICE:.3f} "
            f"({bench.BASELINE})")
        log(f"vision losses: first {losses[0]:.5f} last {losses[-1]:.5f}")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"non-finite vision loss {losses}")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"vision loss did not fall {losses}")
        feed = prefetch_to_device(
            bench.host_batch_pool(bench.BATCH_PER_CHIP), size=2, device=dev)
        host = bench.run(opt, feed, sync, 2, HOST_DATA_STEPS)
        host_img_s = bench.BATCH_PER_CHIP * HOST_DATA_STEPS / host["seconds"]
        log(f"vision host data ({card}): uint8 pool, prefetch 2, "
            f"{HOST_DATA_STEPS} steps, img/s/card={host_img_s:.1f} "
            f"ms/step={host['seconds'] / HOST_DATA_STEPS * 1e3:.3f}")
        if not all(math.isfinite(x) for x in host["losses"]):
            raise RuntimeError(f"non-finite host-data loss {host['losses']}")
    finally:
        bf.shutdown()
    return {"img_per_s": img_s, "ms_per_step": res["seconds"] / steps * 1e3,
            "peak_bytes": peak, "params": n_params,
            "first_loss": losses[0], "last_loss": losses[-1],
            "host_img_per_s": host_img_s}


def _step_spans(events: list, cat: str) -> list:
    """(begin, end) ts of each ``STEP`` span of ``cat`` in a chrome trace;
    raises unless every span of the trace balances on its (cat, tid)
    lane."""
    open_at: dict = {}
    steps = []
    for e in events:
        key = (e.get("cat"), e.get("tid"))
        if e.get("ph") == "B":
            open_at.setdefault(key, []).append(e)
        elif e.get("ph") == "E":
            if not open_at.get(key):
                raise RuntimeError(f"timeline: E without B on {key}")
            b = open_at[key].pop()
            if b["name"] == "STEP" and b["cat"] == cat:
                steps.append((b["ts"], e["ts"]))
    if any(open_at.values()):
        raise RuntimeError(f"timeline: unclosed spans {open_at}")
    return steps


def _check_prometheus(text: str) -> int:
    """Parse the exposition line by line; returns the sample count."""
    lines = text.strip().splitlines()
    samples = 0
    for i, line in enumerate(lines):
        if line.startswith("# TYPE"):
            name = line.split()[2]
            ok = _PROM_TYPE.match(line) and i > 0 and \
                lines[i - 1].startswith(f"# HELP {name} ")
        elif line.startswith("#"):
            ok = _PROM_HELP.match(line)
        else:
            ok = _PROM_SAMPLE.match(line)
            samples += 1
        if not ok:
            raise RuntimeError(f"prometheus_text: bad line {line!r}")
    return samples


def obs_timeline(bf, fl, torch, dev, tmp: str) -> dict:
    """(a) The main path under the timeline: the trace, the metrics, the
    step report, the Prometheus text and a dump read back."""
    from bluefog_tpu_torch.runtime import flight

    model, opt, batch = headline(bf, torch, dev, fl.flash_attention)
    prefix = os.path.join(tmp, "tl_")
    if not bf.start_timeline(prefix):
        raise RuntimeError("start_timeline refused")
    run = _train_steps(fl, torch, opt, batch)
    bf.stop_timeline()
    _check_training("observability", run, LAYERS)
    total = WARMUP + STEPS
    path = f"{prefix}{bf.rank()}.json"
    with open(path) as f:
        events = json.load(f)
    first = events[0]
    if first.get("name") != "bf.clock_sync_us" or first.get("ph") != "C":
        raise RuntimeError(f"timeline: first event {first} is not the "
                           f"clock anchor")
    spans = _step_spans(events, opt.name)
    snap = bf.metrics.snapshot()
    gauge = snap["gauges"].get("opt.step")
    count = snap["hists"]["opt.step_sec"]["count"]
    rep = bf.step_report()
    last_ms = (spans[-1][1] - spans[-1][0]) / 1e3 if spans else math.nan
    gap_ms = abs(rep["step_sec"] * 1e3 - last_ms)
    samples = _check_prometheus(bf.metrics.prometheus_text())
    dump_path = bf.flight_dump(path=os.path.join(tmp, "dump.json"))
    with open(dump_path) as f:
        doc = json.load(f)
    back = flight.unpack_dump(flight.pack_dump(doc))
    rep_dump = flight.analyze_dump(back)
    log(f"obs timeline: {len(spans)} STEP spans under {opt.name}, "
        f"opt.step gauge {gauge}, opt.step_sec count {count}, "
        f"step_report step {rep['step']} step_sec "
        f"{rep['step_sec'] * 1e3:.3f} ms vs the trace's last STEP "
        f"{last_ms:.3f} ms (|diff| {gap_ms:.4f} ms, limit "
        f"{OBS_STEP_TOL_MS}), prometheus samples {samples}, dump "
        f"{os.path.getsize(dump_path)} bytes read back, step "
        f"{rep_dump and rep_dump['step']}")
    per_step = {"events": len(events) / total,
                "bytes": os.path.getsize(path) / total,
                "flight_records": doc["recorded"] / total}
    log(f"obs per step: trace events {per_step['events']:.2f}, trace bytes "
        f"{per_step['bytes']:.1f}, flight records "
        f"{per_step['flight_records']:.2f} ({len(events)} events, "
        f"{os.path.getsize(path)} bytes, {doc['recorded']} records in "
        f"{total} steps)")
    log(f"obs launches: {run['counts']}")
    bad = []
    if len(spans) != total:
        bad.append(f"{len(spans)} STEP spans, expected {total}")
    if gauge != total or count != total or rep["step"] != total:
        bad.append(f"gauge {gauge}, count {count}, report step "
                   f"{rep['step']}, expected {total}")
    if not gap_ms <= OBS_STEP_TOL_MS:
        bad.append(f"step_report step_sec off the trace by {gap_ms} ms")
    if back != doc or rep_dump is None or rep_dump["step"] != total:
        bad.append("the dump did not read back")
    if bad:
        raise RuntimeError("observability (a): " + "; ".join(bad))
    return {"model": model, "opt": opt, "batch": batch,
            "step_gap_ms": gap_ms, "per_step": per_step,
            "counts": run["counts"], "ms_per_step": run["dt"] * 1e3}


def _profile_events(torch, fn, path: str) -> list:
    """Chrome events of a ``torch.profiler`` trace (CPU and CUDA) of
    ``fn()``, the device synchronised inside the window. A first, untraced
    ``fn()`` under the profiler's warm-up comes before: in a window opened
    cold, CUPTI can miss the first kernel records (one K1 of a profiled
    bare backward went missing once on an H100)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def launches_in_range(events: list, range_name: str) -> dict:
    """Per kernel of ``OBS_KERNELS``: ``(launches, inside)``, the kernel
    records of the trace and how many of them were launched (the host's
    ``cudaLaunchKernel`` record of the same ``correlation`` id) inside a
    ``range_name`` range. The launches of the backward kernels come from
    the autograd engine's thread: inside means inside in time."""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") == range_name]
    host = {e["args"]["correlation"]: e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}
    out = {}
    for name, pattern in OBS_KERNELS.items():
        launches = inside = 0
        for e in events:
            if e.get("cat") != "kernel" or not pattern.search(
                    e.get("name", "")):
                continue
            launches += 1
            h = host.get(e.get("args", {}).get("correlation"))
            if h is not None and any(
                    lo <= h["ts"] and h["ts"] + h.get("dur", 0.0) <= hi
                    for lo, hi in ranges):
                inside += 1
        out[name] = (launches, inside)
    return out


def obs_profiler(bf, torch, a: dict, tmp: str) -> dict:
    """(b) The profiler bridge on one step of the main path, and the
    planted fault: a bare ``loss.backward()`` traced the same way."""
    opt, model, batch = a["opt"], a["model"], a["batch"]
    rng = f"{opt.name}.STEP"
    events = _profile_events(torch, lambda: opt.step(batch),
                             os.path.join(tmp, "profile_step.json"))
    got = launches_in_range(events, rng)

    def bare():
        model.zero_grad(set_to_none=True)
        bf.models.lm_loss(model, batch).backward()

    planted = launches_in_range(
        _profile_events(torch, bare, os.path.join(tmp, "profile_bare.json")),
        rng)
    log(f"obs profiler: {len(events)} trace events; (launches, inside "
        f"{rng}) per kernel {got}; planted bare backward {planted}")
    want = (LAYERS, LAYERS)
    if any(v != want for v in got.values()):
        raise RuntimeError(f"observability (b): kernel launches outside "
                           f"the {rng} range or missing: {got}, expected "
                           f"{want} each")
    if any(v[0] != LAYERS for v in planted.values()) or \
            all(v == want for v in planted.values()):
        raise RuntimeError(f"observability (b): the planted bare backward "
                           f"passed the check or lost its launches: "
                           f"{planted}")
    return {"launches": got, "planted": planted}


def obs_postmortem(bf, torch, a: dict, tmp: str) -> dict:
    """(c) A step fed a wrongly shaped batch (the targets cut to half the
    sequence) in a fresh job: the exception propagates, and
    ``bf_flight_<rank>.json`` under ``BFT_FLIGHT_DIR`` holds the
    ``fatal.opt.step`` instant."""
    opt, (toks, tgts) = a["opt"], a["batch"]
    bf.shutdown()
    os.environ["BFT_FLIGHT_DIR"] = tmp
    try:
        bf.init()
        try:
            opt.step((toks, tgts[:, :SEQ // 2]))
        except ValueError as exc:
            raised = f"{type(exc).__name__}: {exc}"
        else:
            raise RuntimeError("observability (c): a wrongly shaped batch "
                               "did not raise")
    finally:
        del os.environ["BFT_FLIGHT_DIR"]
    from bluefog_tpu_torch.runtime import flight

    path = os.path.join(tmp, f"bf_flight_{bf.rank()}.json")
    with open(path) as f:
        doc = json.load(f)
    instants = [doc["names"][n] for k, n in zip(doc["events"]["kind"],
                                                doc["events"]["name"])
                if k == flight.INSTANT]
    log(f"obs postmortem: raised {raised[:120]!r}; {path} reason "
        f"{doc['meta']['reason']!r}, instants {instants}")
    if "fatal.opt.step" not in instants or \
            "ValueError" not in (doc["meta"]["exception"] or ""):
        raise RuntimeError(f"observability (c): the dump lacks the fatal "
                           f"step: {doc['meta']}, {instants}")
    torch.cuda.synchronize()
    return {"reason": doc["meta"]["reason"], "instants": instants}


def _obs_blocks(bf, step, sync, steps: int, tmp: str, label: str,
                rounds: int = OBS_ROUNDS) -> dict:
    """Off/on blocks in turns (``rounds`` of off, on, on, off): each block
    first times the host's issue of OBS_ISSUE_PROBES steps, each from an
    idle device (host clock around ``step()``, synchronised before and
    after), then ``steps`` steps timed to a synchronise. On: the timeline
    and a 1 s Prometheus publisher, each on-block's file checked for a
    publication."""
    out = {"off": [], "on": [], "issue_off": [], "issue_on": [],
           "published": 0}
    prom = os.path.join(tmp, f"{label}.prom")
    for i, mode in enumerate(["off", "on", "on", "off"] * rounds):
        if mode == "on":
            os.environ["BFT_METRICS_PROM"] = prom
            os.environ["BFT_METRICS_INTERVAL"] = "1"
            bf.start_timeline(os.path.join(tmp, f"{label}_{i}_"))
            bf.metrics.start_publisher_if_needed()
        try:
            issue = 0.0
            for _ in range(OBS_ISSUE_PROBES):
                sync()
                t0 = time.perf_counter()
                step()
                issue += time.perf_counter() - t0
            sync()
            out[f"issue_{mode}"].append(issue / OBS_ISSUE_PROBES * 1e3)
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            sync()
            out[mode].append((time.perf_counter() - t0) / steps * 1e3)
        finally:
            if mode == "on":
                bf.metrics.stop_publisher()
                bf.stop_timeline()
                del os.environ["BFT_METRICS_PROM"]
                del os.environ["BFT_METRICS_INTERVAL"]
        if os.path.exists(prom):
            out["published"] += 1
            os.remove(prom)
    out["ratio"] = sum(out["on"]) / sum(out["off"])
    return out


def obs_overhead(bf, torch, a: dict, card: str, tmp: str) -> dict:
    """(d) The optional part's cost: the LM (gated) and ResNet-50."""
    from bluefog_tpu_torch import bench

    opt, batch = a["opt"], a["batch"]
    lm = _obs_blocks(bf, lambda: opt.step(batch), torch.cuda.synchronize,
                     OBS_LM_STEPS, tmp, "lm")
    bf.shutdown()
    vopt, vbatch, sync = bench.setup()
    try:
        for _ in range(bench.WARMUP):
            vopt.step(vbatch)
        vision = _obs_blocks(bf, lambda: vopt.step(vbatch), sync,
                             OBS_VISION_STEPS, tmp, "resnet50")
    finally:
        bf.shutdown()
    for label, r in (("LM", lm), ("ResNet-50", vision)):
        log(f"obs overhead ({card}) {label}: ms/step off "
            f"{[round(x, 4) for x in r['off']]} on "
            f"{[round(x, 4) for x in r['on']]}, on/off {r['ratio']:.4f}; "
            f"host issue ms off {[round(x, 4) for x in r['issue_off']]} "
            f"on {[round(x, 4) for x in r['issue_on']]}; on-blocks with a "
            f"publication {r['published']} of {2 * OBS_ROUNDS}")
    if not lm["ratio"] <= OBS_LM_RATIO:
        raise RuntimeError(f"observability (d): LM on/off {lm['ratio']:.4f}"
                           f" above {OBS_LM_RATIO}")
    return {"lm": lm, "resnet50": vision}


def observability(bf, fl, torch, card: str) -> dict:
    """Phase 13: (a) timeline and metrics, (b) the profiler bridge, (c) a
    postmortem on the card, (d) the overhead of the optional part."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bft_obs_") as tmp:
        bf.init()
        dev = torch.device("cuda", torch.cuda.current_device())
        a = obs_timeline(bf, fl, torch, dev, tmp)
        b = obs_profiler(bf, torch, a, tmp)
        c = obs_postmortem(bf, torch, a, tmp)
        d = obs_overhead(bf, torch, a, card, tmp)
    wall = time.perf_counter() - t0
    log(f"obs wall: {wall:.1f} s")
    return {"step_gap_ms": a["step_gap_ms"], "per_step": a["per_step"],
            "counts": a["counts"], "ms_per_step": a["ms_per_step"],
            "profiler": b, "postmortem": c, "overhead": d, "wall_s": wall}


def max_abs_errs(fl, torch, dev, B, S, H, D) -> dict:
    """Each kernel's max |kernel - plain| at the main path's shape.

    Forward on o/l; raises when o/l is off by more than ``TOL_FWD`` or a
    gradient, normalised by its plain version's largest value, by more
    than ``TOL_BWD``, or when a second launch of K1, K2 or K3 on the same
    inputs does not repeat the first bit for bit.
    """
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    g = torch.randn((B, S, H, D), generator=gen, device=dev)
    o, m, l = fl.flash_block(q, k, v, 0, 0, causal=True)
    repeats = {"flash_fwd": all(torch.equal(a, b) for a, b in zip(
        (o, m, l), fl.flash_block(q, k, v, 0, 0, causal=True)))}
    po, pm, pl = fl.flash_block_plain(q, k, v, 0, 0, causal=True)
    out = (po / pl[..., None]).to(torch.bfloat16)
    d_term = (g * out.float()).sum(-1)
    args = (q, k, v, g, d_term, pm, pl, 0, 0)
    errs = {"flash_fwd": float((o / l[..., None]
                                - po / pl[..., None]).abs().max())}
    normed = {}
    del o, m, l, po
    dq = fl.flash_bwd_dq(*args, causal=True)
    repeats["flash_bwd_dq"] = torch.equal(dq, fl.flash_bwd_dq(*args,
                                                              causal=True))
    pdq = fl.flash_bwd_dq_plain(*args, causal=True)
    errs["flash_bwd_dq"] = float((dq - pdq).abs().max())
    normed["flash_bwd_dq"] = nerr(dq, pdq)
    del dq, pdq
    dk, dv = fl.flash_bwd_dkv(*args, causal=True)
    dk2, dv2 = fl.flash_bwd_dkv(*args, causal=True)
    repeats["flash_bwd_dkv"] = torch.equal(dk, dk2) and torch.equal(dv, dv2)
    del dk2, dv2
    pdk, pdv = fl.flash_bwd_dkv_plain(*args, causal=True)
    errs["flash_bwd_dkv"] = max(float((dk - pdk).abs().max()),
                                float((dv - pdv).abs().max()))
    normed["flash_bwd_dkv"] = max(nerr(dk, pdk), nerr(dv, pdv))
    log(f"max_abs_err at S={S} (fwd on o/l, limit {TOL_FWD}): {errs}")
    log(f"normalised backward err at S={S} (limit {TOL_BWD}): {normed}")
    log(f"repeat launches bit-identical at S={S}: {repeats}")
    if not all(repeats.values()):
        raise RuntimeError(f"a kernel did not repeat: {repeats}")
    bad = {n: e for n, e in normed.items() if not e <= TOL_BWD}
    if not errs["flash_fwd"] <= TOL_FWD:
        bad["flash_fwd"] = errs["flash_fwd"]
    if bad:
        raise RuntimeError(f"kernel disagrees with its plain version at the "
                           f"main path's shape S={S}: {bad}")
    return errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.parallel import _build
    from bluefog_tpu_torch.parallel import flash as fl

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.1f} s")
    for name, text in logs.items():
        for line in ptxas_lines(text):
            log(f"  {name}: {line}")

    dev = torch.device("cuda", 0)
    B, H, D = 1, 16, 128
    check_kernels(fl, torch, B, 1024, 1024, H, D,
                  [(0, 0), (1024, 0), (0, 1024), (64, 0), (0, 64), (37, 0)],
                  dev)
    check_kernels(fl, torch, B, 1024, 640, H, D, [(0, 0), (37, 0)], dev)
    check_kernels(fl, torch, B, 1000, 1000, 4, 64, [(0, 0), (37, 0)], dev)
    check_kernels(fl, torch, B, SEQ, SEQ, 8, 64, [(0, 0)], dev)
    torch.cuda.empty_cache()
    # max_abs_err: kernel vs plain at the main path's shape, bf16
    errs = max_abs_errs(fl, torch, dev, B, SEQ, H, D)
    torch.cuda.empty_cache()
    bench = kernel_bench(fl, torch, dev, B, SEQ, H, D)
    torch.cuda.empty_cache()
    model_check(bf, fl, torch, dev)
    torch.cuda.empty_cache()

    run = train(bf, fl, torch)
    torch.cuda.empty_cache()
    ctx = context(bf, fl, torch, run["losses"])
    torch.cuda.empty_cache()
    opts = optimizers(bf, fl, torch)
    torch.cuda.empty_cache()
    ce = ce_check(bf, fl, torch, dev)
    torch.cuda.empty_cache()
    lm_bench_runs = lm_bench_phase(fl, torch, dev)
    torch.cuda.empty_cache()
    moe = {"check": model_check(bf, fl, torch, dev, num_experts=4),
           "switch": switch_check(bf, torch, dev)}
    torch.cuda.empty_cache()
    moe["train"] = moe_train(bf, fl, torch)
    torch.cuda.empty_cache()
    experts = {"check": experts_check(torch, dev)}
    torch.cuda.empty_cache()
    experts["train"] = ep_train(bf, fl, torch)
    torch.cuda.empty_cache()
    experts["examples"] = examples_check(bf, torch, dev)
    torch.cuda.empty_cache()
    par = parallel(bf, fl, torch, dev)
    torch.cuda.empty_cache()
    vision = dict(check=vision_check(bf, torch, dev))
    torch.cuda.empty_cache()
    vision["train"] = vision_train(bf, torch, card)
    torch.cuda.empty_cache()
    obs = observability(bf, fl, torch, card)

    kernels = []
    for name, (src, tpu) in KERNELS.items():
        r = bench[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": run["counts"][name], "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_call": r["library_call"],
            "launches_by_path": {
                "train": run["counts"][name],
                f"virtual ring of {RING_N}": ctx["ring_check"]["launches"][
                    name],
                "flash ring LM": ctx["ring_train"]["counts"][name],
                "expert-parallel MoE LM": experts["train"]["counts"][name],
                f"virtual TP group of {TP_N}": par["tp_check"]["launches"][
                    name],
                f"virtual pipeline of {PP_N}": par["pp_check"]["launches"][
                    name],
                "tp_loss_fn LM": par["train"]["tp"]["counts"][name],
                "pp_train_step_fn LM": par["train"]["pp"]["counts"][name],
                "pp_train_step_fn LM, fused": par["train"]["pp fused"][
                    "counts"][name],
                "observability LM": obs["counts"][name]},
        })
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": card, "kernels": kernels, "train": run,
                   "context": ctx, "optimizers": opts, "ce": ce,
                   "lm_bench": lm_bench_runs,
                   "moe": moe, "experts": experts, "parallel": par,
                   "vision": vision, "observability": obs}, f,
                  indent=1)
    log(f"wall: {time.perf_counter() - t_start:.1f} s after the card check")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
