#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card, exits 0 on success

(``python3 chip_smoke.py --liveness-helper`` is the CPU peer process that
phase 15 starts itself; ``python3 chip_smoke.py --launch-helper`` is the
rank phase 19 launches through the port's launcher.)

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
   for each method but ``push_diging`` (its halved mass needs an
   out-neighbour), and ``resnet_from_torch`` on a ResNet-50 checkpoint in
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
14. wire, the control plane on the main path (world 1, NCCL): the native
   library (``csrc/bf_runtime.cc``) is built with g++ beside the kernels;
   ``BFT_CP_HOST``/``BFT_CP_PORT`` on a free loopback port with a job
   secret, ``BFT_INCARNATION`` and a ``WIRE_INTERVAL`` s metrics cadence.
   (a) ``bf.init()`` attaches and serves; the headline LM of 13(a), whose
   losses must equal 13(a)'s bit for bit and its launches 13(a)'s. (b)
   ``cluster_health()`` shows rank 0 at the last step, a second raw client
   reads the same step with ``read_cluster_health`` once the publisher has
   ticked, the snapshot carries the native client and server counters, the
   log prefix reads ``inc WIRE_INC``. (e) Medians of ``fetch_add`` and of
   ``put_bytes``/``get_bytes`` of one packed metrics snapshot and of 4 MiB
   (striped), not gated. (c) The second client bumps the dump trigger;
   ``poll_remote_trigger`` fires once, the dump under ``BFT_FLIGHT_DIR``
   holds the native transport's ring and its ``bf.flight.0`` KV tail
   decodes; a planted client with the wrong secret is refused. (d) Two
   ``shard_server.py`` processes started by file path as a replicated ring
   under a ``ShardRouter``: ``WIRE_FETCH_ADDS`` fetch_adds with shard 1
   SIGKILLed halfway end at exactly that count, a replicated ``put_max``
   key survives.
15. liveness, failure detection and the telemetry plane beside the main
   path: this process is controller 0 of a control plane of 2 (loopback, a
   job secret), controller 1 this script run with ``--liveness-helper``, a
   CPU process (gloo, a world of one) that only heartbeats; heartbeats
   every 0.25 s, a peer silent 2 s dead, time series published every
   0.5 s, the tuner on, stalls flagged after 1 s. (a) The LM of 13(a):
   losses bit for bit and launches 13(a)'s; ms/step against 13(a)'s and
   the wire phase's; then 5 s more of its steps, and the median
   ``PeerMonitor._tick`` and ``TimeSeriesStore.sample`` in us. (b) An
   outside client reads ``bf.ts.0`` (the bound series; ``opt.step.rate``
   within 10 % of 1000/ms-per-step), ``bf.tune.0`` (the trail) and no
   ``bf.tune.demoted``. (c) A handle over a 9 s device sleep on a side
   stream: the watchdog flags it once (``watchdog.stalls``, one ``STALL``
   instant, one ``watchdog-stall`` dump) and ``synchronize(timeout=0.5)``
   raises a ``RuntimeError`` with the no-dead-peer diagnosis. (d) The
   helper SIGKILLed: ``dead_controllers()``/``dead_ranks()`` are {1} within
   2.75 s, the epoch rises, ``synchronize`` raises ``PeerLostError`` with
   ``dead == {1}`` and a dump; after the sleep the retry returns. (e) The
   helper again as incarnation 1: a suspect, still dead, until its
   ``complete_quarantine()``; each transition bumps the epoch. (f) The
   helper's ``bf.shutdown()`` shows in ``shutdown_requested()`` within
   3 intervals and this process's own shutdown does not wait out its
   grace.
16. windows, the one-sided window layer (``ops/windows.py``): (a) the
   collective plane at world 1 (NCCL) on the headline LM's seeded
   parameters packed into one f32 row of 335,562,752 elements with
   ``fusion.pack``: ``win_create``, ``win_put(self_weight=0.5)``,
   ``win_accumulate``, ``win_get``, ``win_update`` (clone and reset),
   ``win_update_then_collect``, ``win_fence``, ``get_win_version``,
   ``win_mutex``/``win_lock`` and associated p on and off, each against
   its closed form at n = 1 bit for bit; the ms of ``win_put`` and
   ``win_update`` beside their bytes bound, the peak memory, and 0 bytes
   left after ``win_free``. (b) A virtual window group of WIN_VN ranks on
   ExponentialTwoGraph (d_max 3), rows of WIN_ROW elements in f32 and
   bf16, through the port's per-rank receiver step (``fold_arrival``:
   the slot blend, the p mail and the version bump on each virtual rank's
   scalar host), ``combine`` and ``p_combine``, with a device copy for
   the P2P round, against an f64 oracle: a dynamic partial-destination
   put with its versions, stacked accumulates with self scaling,
   WIN_PS_ROUNDS rounds of push-sum with sum(p) = 8 and the numerators'
   mass conserved (``TOL_WIN``, ``TOL_WIN_MASS``); a planted slot off by
   one must fail. (c) The hosted
   plane on a loopback control plane of one, the mailbox cap raised to
   WIN_CAP_MB: ``win_create`` publishes the row; per codec of
   WIN_CODECS one full-width deposit of the card's row through the
   window's encode, ``_pack_deposit``, the tagged append, the drain and
   ``_finish_deposit`` into slot 0, copied back to the card: the row bit
   for bit (``none``), decode(encode(row)) bit for bit (int8, fp8), the
   row exactly with the error-feedback residual added (top-k); the wire
   bytes and the ms of each leg.
17. window optimizers on the main path (the headline LM of the train
   phase, same seed and batch, 2 warm-up and 5 timed steps): (a) at world 1
   on NCCL, the collective plane: ``DistributedWinPutOptimizer``,
   ``DistributedPullGetOptimizer`` and ``DistributedPushSumOptimizer``;
   at n = 1 each gossip combines with self weight 1.0 in f32 and p stays
   1.0, so the losses must equal the train phase's and the final
   parameters a ``DistributedNeighborAllreduceOptimizer`` run's, bit for
   bit; ms/step against train's, peak memory, ``LAYERS`` launches of each
   kernel a step, the host-timed PACK/gossip/UNPACK legs. (b) win-put and
   push-sum with ``BFT_WIN_SHARD=8``, bit for bit again; ``pack_shard`` and
   ``scatter_shard`` alone (CUDA events); a planted scatter of each shard
   into the next shard's pieces must change the losses. (c) The hosted
   plane on a loopback control plane of one (``BFT_WIN_PLANE=hosted``): the
   raw 1.34 GB row refused without a shard factor or a codec, naming both
   knobs; then with ``BFT_WIN_SHARD=8`` win-put and push-sum for 3
   communicating steps: losses bit for bit, push-sum's ``pushsum.mass``
   equal to ``pushsum.minted``, each step's pack, D2H, publish, drain, H2D
   and scatter ms, the step time over (a)'s. (d) In (c)'s win-put run,
   ``BFT_SERVE_PUBLISH_EVERY=1``: ``fetch_snapshot`` reads back the
   post-gossip parameters bit for bit; the publish seconds and wire bytes.
   (e) ``benchmark.py`` with ``win_put``, ``pull_get`` and ``push_sum``
   and an epoch of ``resnet.py --dist-optimizer win_put`` at world 1. The
   phase raises when it leaves more than 1 MiB allocated on the card.
18. serving, train-while-serve on the main path: (0) K1 at the serve
   batch (B=SERVE_BATCH, H=16, D=128, S=8192, causal) against its plain
   version one sequence at a time, each sequence's rows equal to a launch
   on it alone bit for bit, its ms beside its bound. Then ``bf.init()`` on
   a loopback control plane of one (``BFT_SERVE_PUBLISH_EVERY=1``,
   ``BFT_SERVE_SHARDS=8``, ``BFT_TRACE_SERVE=1``, ``BFT_SLO``): the
   headline LM under ``DistributedWinPutOptimizer`` around Adam 1e-3 as the
   trainer, and a ``ServeClient`` in this process on the card whose
   ``model_fn`` runs the same architecture over the snapshot's leaves
   (``torch.func.functional_call`` on a skeleton on the meta device, by
   ``named_parameters()`` in the publisher's leaf order) and answers each
   8192-token request with its last position's f32 logits, every batch
   padded to SERVE_BATCH rows. Every step must advance ``serve.publishes``.
   (a) SERVE_STEPS lockstep steps: ``refresh()`` to the step's version,
   then SERVE_BATCH requests equal a direct forward of the trainer's own
   parameters over the same stacked batch bit for bit, with ``LAYERS``
   K1 launches per served batch and no K2/K3 (the counts set to 0 just
   before, read just after); SERVE_IDLE_S of SERVE_SUBMITTERS submitter
   threads with the trainer idle, then SERVE_LOAD_STEPS steps while they
   keep requests flowing: every answer equals one saved version's answer
   for its sequence (none torn); requests/s and p50/p99 latency of both;
   the trainer's ms/step publishing alone and with the client serving
   beside phase 17(a)'s win-put; each version's pull s and MB/s, the
   swap's H2D ms; the served function's decode ms at batch 1 and
   SERVE_BATCH (CUDA events). (c) ``flight.serve_report()`` over the ring:
   the traced requests counted, the median phase coverage in [0.9, 1.1],
   ``decode`` the largest phase, the p50/p99 gauges set, the lineage of the
   serving version naming its step. (d) ``python -m
   bluefog_tpu_torch.launcher`` as subprocesses against the job: ``--serve
   --once --device cuda`` (its swap line), ``--status`` (the serving-plane
   lines, a client heartbeating), ``--top --once`` and ``--dump`` (rank
   0's ring); (e) at the same time ``examples/serving.py`` on the card
   (``SERVING OK``). Two planted faulty swaps (SERVE_FAULTS: the reference
   published before its copy lands, one leaf slice corrupted) must each
   show as answers that match no version. (b) With
   ``BFT_SERVE_QUEUE_MAX=2`` and a model that waits on an event (a control
   plane of its own): a flood sheds with gate ``queue_full`` and
   ``stats()['shed']`` equals the shed count. Peak memory.
19. launch, the port's launcher and torch frontend on the main path: the
   parent releases its tensors, then (a) runs ``python -m
   bluefog_tpu_torch.launcher -H localhost:1 --timeline-filename <tmp>/tl_
   --verbose -- python3 chip_smoke.py --launch-helper`` (a timeout of its
   own): the helper checks that ``WORLD_SIZE=1``, ``RANK=0``,
   ``MASTER_ADDR``, ``BFT_TIMELINE``, ``BFT_LOG_LEVEL`` and the job secret
   reached it, ``bf.init()`` joins through ``env://`` over NCCL on
   ``cuda:0``, and it trains the headline LM of phase 4 (same seed and
   batch) from a user's loop, ``zero_grad`` / ``lm_loss`` / ``backward`` /
   ``step`` under ``torch_frontend.DistributedTorchOptimizer`` around Adam
   1e-3, 2 warm-up and 5 timed steps, and prints one JSON line. The child
   must exit 0, its losses equal phase 4's bit for bit (at world 1 the
   combine multiplies by 1.0 in f32), each kernel launch ``LAYERS`` times
   a step, its timeline hold 7 ``STEP`` spans each with its
   ``NEIGHBOR_ALLREDUCE``, and its stderr the debug line of the
   ``env://`` join. Its ms/step beside phase 4's. (b) ``--simulate 2 --
   python -m bluefog_tpu_torch.examples.torch_average_consensus``: both
   ranks on the CPU over gloo beside the card, ``TORCH CONSENSUS OK``.

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

import numpy as np

T_IMPORTED = time.perf_counter()
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
# names them. A trace in which CUPTI lost records (a ``cudaLaunchKernel``
# with no kernel record of its ``correlation`` id, a kernel short of
# LAYERS) is taken again, at most OBS_TRACE_ATTEMPTS traces in all: on an
# H100 a window's first few dozen kernel records go missing now and then,
# less often after a warm-up step but not never. (d) Off (collection
# only) against on (timeline + a 1 s Prometheus publisher) in turns,
# OBS_ROUNDS rounds of off, on, on, off,
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
OBS_TRACE_ATTEMPTS = 5
OBS_KERNELS = {name: re.compile(rf"\b{name}_kernel\b")
               for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.eE+-]+$")
_PROM_TYPE = re.compile(
    r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)$")
_PROM_HELP = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* \S")

# Phase 14, the wire: the control plane forced at world 1 on a free
# loopback port with a job secret and incarnation WIRE_INC, metrics
# published every WIRE_INTERVAL s. (a) The headline LM as in 13(a): its
# losses must equal 13(a)'s bit for bit (publication changes no number).
# (b) The step must reach the KV within WIRE_WAIT_S. (d) Two shard server
# processes in a replicated ring: WIRE_FETCH_ADDS fetch_adds on a key of
# shard 1, SIGKILL of shard 1 halfway; the counter must end at exactly
# WIRE_FETCH_ADDS. (e) Medians of WIRE_REPS calls, not gated.
WIRE_INTERVAL = 0.5
WIRE_INC = 3
WIRE_WAIT_S = 10.0
WIRE_FETCH_ADDS = 200
WIRE_REPS = 200
WIRE_BULK_REPS = 20
WIRE_STRIPE_BYTES = 4 << 20

# Phase 15, liveness: the card's process is controller 0 of a control
# plane of LIVE_WORLD controllers; controller 1 is this script run with
# HELPER_ARG, a CPU process (gloo, world of one) that only heartbeats.
# Heartbeats every LIVE_HB_INTERVAL s, a peer silent LIVE_HB_TIMEOUT s is
# dead; time series published every LIVE_TS_INTERVAL s; the tuner on,
# ticking every LIVE_TUNE_INTERVAL s (it floors this at 0.5 s); the
# watchdog flags a handle older than LIVE_STALL_S s. (a) After the LM of
# 13(a), LIVE_RATE_S s more of its steps for the published step rate,
# which must lie within LIVE_RATE_TOL of 1000/ms-per-step; LIVE_TICK_REPS
# ticks and samples timed. (c) A device sleep of LIVE_SLEEP_S s on a side
# stream behind an event is the stalled op; synchronize's probe deadline
# is LIVE_SYNC_PROBE_S. (d) Death must be seen within the timeout plus 3
# intervals of the SIGKILL. (f) The shutdown grace is LIVE_GRACE_S, so a
# shutdown that waited it out shows.
# the windows phase (16). (a) The headline LM's parameters packed into one
# f32 row (335,562,752 elements) as a window at world 1; WIN_TIME_REPS timed
# calls of win_put and win_update. (b) A virtual group of WIN_VN ranks on
# ExponentialTwoGraph (d_max 3), WIN_ROW elements a row, against an f64
# oracle: f32 rounds once per op (measured max|err|/max|oracle| in PERF.md),
# bf16 once per cast (2^-9 each, a few casts per value); the mass is the sum
# of the numerators over every rank, relative to the inputs' (1 + 0.5 randn,
# so it cannot cancel): on an H100 it read 3.170e-12 (f32) and 3.019e-5
# (bf16) in three runs of the seeded data, and each limit sits about 5x
# above its reading. A slot off by one moves a value by O(1). (c) One
# full-width deposit per codec; the cap holds one f32 row (1280 MiB) and
# its record headers.
WIN_VN = 8
WIN_ROW = 64 << 20
WIN_PS_ROUNDS = 5
WIN_TIME_REPS = 5
TOL_WIN = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_WIN_MASS = {"float32": 1.6e-11, "bfloat16": 1.5e-4}
WIN_CODECS = ("none", "int8", "fp8", "topk:0.01")
WIN_CAP_MB = 1600

# the window optimizers phase (17). At world 1 each gossip combines the
# row with self weight 1.0 in f32 and push-sum's p stays 1.0, so every run
# must equal the train phase's neighbor-allreduce run bit for bit (losses
# and final parameters): no tolerance. (b) shards the row WINOPT_SHARD ways;
# the planted fault writes each combined shard into the next shard's
# pieces. (c) runs WINOPT_HOSTED_STEPS communicating steps on the hosted
# plane (a raw f32 row of 1.34 GB is above the server's 1 GiB message
# ceiling: the shard factor brings each row to 167.8 MB).
WINOPT_KINDS = ("DistributedWinPutOptimizer", "DistributedPullGetOptimizer",
                "DistributedPushSumOptimizer")
WINOPT_SHARD = 8
WINOPT_HOSTED_STEPS = 3
WINOPT_FAULTS = ("scatter_next_shard",)
WINOPT_LEGS = ("pack", "d2h", "publish", "drain", "h2d", "scatter")

HELPER_ARG = "--liveness-helper"
LIVE_WORLD = 2
LIVE_HB_INTERVAL = 0.25
LIVE_HB_TIMEOUT = 2.0
LIVE_TS_INTERVAL = 0.5
LIVE_TUNE_INTERVAL = 0.25
LIVE_STALL_S = 1.0
LIVE_RATE_S = 5.0
LIVE_RATE_TOL = 0.10
LIVE_TICK_REPS = 100
LIVE_SLEEP_S = 9.0
LIVE_SYNC_PROBE_S = 0.5
LIVE_GRACE_S = 5.0
LIVE_WAIT_S = 20.0

# Phase 18, serving: the trainer (controller 0 of a loopback control plane
# of one) publishes a snapshot every step in SERVE_SHARDS pull units (the
# 1.34 GB f32 vector is one blob above the server's 1 GiB message ceiling
# otherwise, and every publish would fail); a ServeClient in this process
# answers SERVE_SEQ-token requests with the last position's f32 logits.
# The served function pads every batch to SERVE_BATCH rows, so an answer's
# bits depend on its own sequence and its version's weights only: lockstep
# answers must equal a direct forward bit for bit, and every answer under
# load must equal one version's answer for its sequence (no tolerance).
SERVE_BATCH = 4
SERVE_SHARDS = 8
SERVE_STEPS = 3           # lockstep steps, each checked before the next
SERVE_LOAD_STEPS = 3      # steps trained while submitters keep requests in
SERVE_POOL = 8            # distinct request sequences (seed 18)
SERVE_SUBMITTERS = 4
SERVE_IDLE_S = 3.0
SERVE_POLL_S = 0.2
SERVE_WAIT_S = 120.0
SERVE_SLO = "serve_p99:10s@5m,serve_avail:99@5m"
SERVE_FAULTS = ("publish_before_copy", "corrupt_leaf_slice")
SERVE_CLI_TIMEOUT = 180.0

# phase 19, launch: the user-loop LM as the one rank of ``bfrun -H
# localhost:1``, this script run with LAUNCH_ARG; then the torch frontend's
# consensus example under ``bfrun --simulate LAUNCH_SIM`` on the CPU
LAUNCH_ARG = "--launch-helper"
LAUNCH_TIMEOUT = 300.0
LAUNCH_SIM = 2
LAUNCH_SIM_TIMEOUT = 120.0
LAUNCH_RESULT = "LAUNCH_RESULT "
LAUNCH_STAGE = "LAUNCH_STAGE "

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


def _train_steps(fl, torch, opt, batch, warmup: int = WARMUP,
                 steps: int = STEPS) -> dict:
    """``warmup`` then ``steps`` timed steps, the launch counts set to 0
    just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fl.reset_launch_counts()
    losses = []
    for _ in range(warmup):
        losses.append(opt.step(batch)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(opt.step(batch)["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
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
    ``optimization.py`` for each method but ``push_diging`` (a world of
    one has no out-neighbour to take the mass it halves); then
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
    # push-DIGing is not run here: each round keeps half of every rank's
    # mass for an out-neighbour, and a world of one has none, so v halves
    # each round and y/v overflows (JAX's and the reference's alike); the
    # CPU tests run it at world 4 against JAX
    log("push_diging: not run at world 1 (no out-neighbour takes the "
        "mass it halves)")

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
            "counts": run["counts"], "ms_per_step": run["dt"] * 1e3,
            "losses": run["losses"]}


def _profile_events(torch, fn, path: str) -> list:
    """Chrome events of a ``torch.profiler`` trace (CPU and CUDA) of
    ``fn()``, the device synchronised inside the window. A first, untraced
    ``fn()`` under the profiler's warm-up comes before: in a window opened
    cold, CUPTI can miss the first kernel records (one K1 of a profiled
    bare backward went missing once on an H100). It still can after the
    warm-up, more rarely: ``_complete_trace`` takes such a trace again."""
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


def lost_launches(events: list) -> int:
    """The host's kernel launches of the trace whose kernel record (the
    same ``correlation`` id) CUPTI did not deliver."""
    on_device = {e["args"]["correlation"] for e in events
                 if e.get("cat") == "kernel"
                 and "correlation" in e.get("args", {})}
    return sum(1 for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "LaunchKernel" in e.get("name", "")
               and e.get("args", {}).get("correlation") not in on_device)


def _complete_trace(torch, fn, path: str, rng: str) -> tuple:
    """``_profile_events`` of ``fn``, taken again while the trace lost
    records: some kernel of ``OBS_KERNELS`` short of LAYERS records and a
    launch without its kernel record. Returns the first complete trace's
    events, its ``launches_in_range`` and the incomplete traces' counts;
    raises after OBS_TRACE_ATTEMPTS incomplete ones. A kernel short of
    LAYERS in a trace that lost nothing is returned as it is."""
    dropped = []
    for _ in range(OBS_TRACE_ATTEMPTS):
        events = _profile_events(torch, fn, path)
        got = launches_in_range(events, rng)
        lost = lost_launches(events)
        if lost and any(v[0] < LAYERS for v in got.values()):
            dropped.append({"lost_launches": lost, "counts": got})
            continue
        return events, got, dropped
    raise RuntimeError(f"observability (b): the profiler lost kernel "
                       f"records in each of {OBS_TRACE_ATTEMPTS} traces: "
                       f"{dropped}")


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
    events, got, dropped = _complete_trace(
        torch, lambda: opt.step(batch),
        os.path.join(tmp, "profile_step.json"), rng)

    def bare():
        model.zero_grad(set_to_none=True)
        bf.models.lm_loss(model, batch).backward()

    _, planted, dropped_bare = _complete_trace(
        torch, bare, os.path.join(tmp, "profile_bare.json"), rng)
    log(f"obs profiler: {len(events)} trace events; (launches, inside "
        f"{rng}) per kernel {got}; planted bare backward {planted}; traces "
        f"that lost records, taken again: step {dropped}, bare "
        f"{dropped_bare}")
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
    return {"launches": got, "planted": planted,
            "retraced": {"step": dropped, "bare": dropped_bare}}


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
            bf.metrics.start_publisher_if_needed(has_heartbeat=False)
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
            "losses": a["losses"], "profiler": b, "postmortem": c,
            "overhead": d, "wall_s": wall}


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _median_us(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def wire_lm(bf, fl, torch, obs: dict) -> dict:
    """(a) The headline LM of 13(a) with the control plane attached and
    metrics published every WIRE_INTERVAL s: its losses equal 13(a)'s bit
    for bit, its launches 13(a)'s."""
    from bluefog_tpu_torch.runtime import control_plane as cp

    if not cp.active():
        raise RuntimeError("wire (a): bf.init attached no control plane")
    dev = torch.device("cuda", torch.cuda.current_device())
    model, opt, batch = headline(bf, torch, dev, fl.flash_attention)
    run = _train_steps(fl, torch, opt, batch)
    _check_training("wire", run, LAYERS)
    ratio = run["dt"] * 1e3 / obs["ms_per_step"]
    log(f"wire train (control plane attached, publication every "
        f"{WIRE_INTERVAL} s): ms/step={run['dt'] * 1e3:.3f} against 13(a)'s "
        f"{obs['ms_per_step']:.3f} (ratio {ratio:.4f}); losses "
        + " ".join(f"{x:.5f}" for x in run["losses"])
        + f"; launches {run['counts']}")
    if run["losses"] != obs["losses"]:
        raise RuntimeError(f"wire (a): losses {run['losses']} differ from "
                           f"13(a)'s {obs['losses']}")
    if run["counts"] != obs["counts"]:
        raise RuntimeError(f"wire (a): launches {run['counts']} differ "
                           f"from 13(a)'s {obs['counts']}")
    return {"counts": run["counts"], "ms_per_step": run["dt"] * 1e3,
            "ratio_to_obs": ratio, "losses": run["losses"]}


def wire_views(bf, ext) -> dict:
    """(b) What a user reads: ``cluster_health()`` in the job, a raw
    client's ``read_cluster_health`` from outside it (waiting for the
    publisher's tick), the native counters in the snapshot, the log
    prefix."""
    from bluefog_tpu_torch.runtime import metrics
    from bluefog_tpu_torch.runtime.logging import _RankPrefixFilter

    total = WARMUP + STEPS
    inside = bf.cluster_health()["ranks"][0]["step"]
    deadline = time.monotonic() + WIRE_WAIT_S
    outside = None
    while time.monotonic() < deadline and outside != total:
        r0 = metrics.read_cluster_health(ext)["ranks"].get(0)
        outside = r0 and r0["step"]
        time.sleep(0.05)
    snap = bf.metrics.snapshot()
    native = {k: v for k, v in snap["counters"].items()
              if k.startswith(("cp.client.ops.", "cp.server.ops."))}
    prefix = _RankPrefixFilter._prefix()
    log(f"wire views: cluster_health step {inside}, read_cluster_health "
        f"from a second client step {outside}, native counters {native}, "
        f"log prefix {prefix!r}")
    bad = []
    if inside != total or outside != total:
        bad.append(f"steps {inside}/{outside}, expected {total}")
    if not native.get("cp.client.ops.put_bytes") or             not native.get("cp.server.ops.put_bytes"):
        bad.append("the snapshot lacks the native counters")
    if prefix != f"[rank 0 / inc {WIRE_INC}] ":
        bad.append(f"log prefix {prefix!r}")
    if bad:
        raise RuntimeError("wire (b): " + "; ".join(bad))
    return {"step": inside, "native_counters": len(native)}


def wire_times(bf, ext, card: str) -> dict:
    """(e) Medians over the loopback wire: fetch_add, put_bytes/get_bytes
    of one packed metrics snapshot and of WIRE_STRIPE_BYTES (striped over
    the client's connection pool)."""
    from bluefog_tpu_torch.runtime import metrics

    blob = metrics.pack_snapshot(bf.metrics.snapshot())
    big = os.urandom(WIRE_STRIPE_BYTES)
    out = {"fetch_add_us": _median_us(
        lambda: ext.fetch_add("smoke.ctr", 1), WIRE_REPS)}
    for label, data, reps in (("snapshot", blob, WIRE_REPS),
                              ("4MiB", big, WIRE_BULK_REPS)):
        out[f"put_bytes_{label}_us"] = _median_us(
            lambda: ext.put_bytes(f"smoke.{label}", data), reps)
        out[f"get_bytes_{label}_us"] = _median_us(
            lambda: ext.get_bytes(f"smoke.{label}"), reps)
        if ext.get_bytes(f"smoke.{label}") != data:
            raise RuntimeError(f"wire (e): {label} bytes did not read back")
    out["snapshot_bytes"] = len(blob)
    out["striped_streams"] = ext.streams
    log(f"wire times ({card}): medians in us over {WIRE_REPS} calls "
        f"({WIRE_BULK_REPS} for 4 MiB): " + json.dumps(
            {k: round(v, 2) if isinstance(v, float) else v
             for k, v in out.items()}))
    return out


def wire_dump(bf, ext, tmp: str, port: int) -> dict:
    """(c) The remote dump: the second client bumps the trigger, one poll
    fires one dump under BFT_FLIGHT_DIR with a non-empty native ring and a
    KV tail that decodes; a client with the wrong secret is refused."""
    from bluefog_tpu_torch.runtime import control_plane as cp
    from bluefog_tpu_torch.runtime import flight, native

    ext.fetch_add(flight.TRIGGER_KEY, 1)
    fired = [flight.poll_remote_trigger(cp.client()) for _ in range(2)]
    with open(os.path.join(tmp, "bf_flight_0.json")) as f:
        doc = json.load(f)
    tail = flight.unpack_dump(ext.get_bytes(flight.DATA_KEY_FMT.format(
        rank=0)))
    ack = ext.get(flight.ACK_KEY_FMT.format(rank=0))
    try:
        native.ControlPlaneClient("127.0.0.1", port, 7,
                                  secret="not-the-secret", streams=1)
        refused = False
    except OSError:
        refused = True
    log(f"wire dump: polls {fired}, dump reason {doc['meta']['reason']!r}, "
        f"native ring {len(doc['native'])} events, KV tail reason "
        f"{tail['meta']['reason']!r} inc {tail['meta']['inc']}, ack {ack}; "
        f"planted wrong secret refused: {refused}")
    if fired != [True, False] or not doc["native"] or ack != 1 or             tail["meta"]["reason"] != "remote-trigger #1" or             tail["meta"]["inc"] != WIRE_INC or not refused:
        raise RuntimeError("wire (c): the remote dump or the planted wrong "
                           "secret failed")
    return {"native_events": len(doc["native"]), "refused": refused}


def wire_shards(secret: str) -> dict:
    """(d) Two ``shard_server.py`` processes started by file path as a
    replicated ring, a ``ShardRouter`` over them: WIRE_FETCH_ADDS
    fetch_adds on a key of shard 1 and a replicated put_max, shard 1
    SIGKILLed halfway; the counter ends at exactly WIRE_FETCH_ADDS and the
    replicated key survives."""
    import signal

    from bluefog_tpu_torch.runtime.router import ShardRouter

    script = os.path.join(HERE, "bluefog_tpu_torch", "runtime",
                          "shard_server.py")
    procs = []
    try:
        ports = []
        for i in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, script, "--port", "0", "--world", "1",
                 "--shard", str(i), "--expect-peers"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
            line = procs[-1].stdout.readline()
            if not line.startswith("BF_SHARD_PORT"):
                raise RuntimeError(f"wire (d): shard {i} said {line!r}")
            ports.append(int(line.split()[1]))
        ring = ",".join(f"127.0.0.1:{p}" for p in ports)
        for proc in procs:
            proc.stdin.write(f"BF_SHARD_PEERS {ring}\n")
            proc.stdin.flush()
        for i, proc in enumerate(procs):
            line = proc.stdout.readline()
            if not line.startswith("BF_SHARD_READY"):
                raise RuntimeError(f"wire (d): shard {i} said {line!r}")
        router = ShardRouter([("127.0.0.1", p) for p in ports], 0,
                             secret=secret, streams=1)
        key = next(f"smoke.ctr.{j}" for j in range(64)
                   if router.shard_of(f"smoke.ctr.{j}") == 1)
        router.put_max("bf.cp.smoke.max", 4242)
        seen = []
        t0 = time.perf_counter()
        for n in range(WIRE_FETCH_ADDS):
            if n == WIRE_FETCH_ADDS // 2:
                procs[1].send_signal(signal.SIGKILL)
                procs[1].wait()
            seen.append(router.fetch_add(key, 1))
        secs = time.perf_counter() - t0
        final, kept = router.get(key), router.get("bf.cp.smoke.max")
        dead = router.dead_shards()
        router.close()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    log(f"wire shards: {WIRE_FETCH_ADDS} fetch_adds across a SIGKILL of "
        f"shard 1 in {secs * 1e3:.1f} ms, counter {final}, pre-add values "
        f"contiguous {seen == list(range(WIRE_FETCH_ADDS))}, replicated key "
        f"{kept}, dead shards {sorted(dead)}")
    if final != WIRE_FETCH_ADDS or seen != list(range(WIRE_FETCH_ADDS)) \
            or kept != 4242 or dead != {1}:
        raise RuntimeError("wire (d): the counter or the replicated key did "
                           "not survive the shard's death")
    return {"counter": final, "seconds": secs}


def wire(bf, fl, torch, card: str, obs: dict) -> dict:
    """Phase 14: the headline LM under ``bf.init`` with the control plane
    attached, then its views, times, remote dump and shard failover."""
    from bluefog_tpu_torch.runtime import native

    t0 = time.perf_counter()
    native.load()
    secret = "chip-smoke-" + os.urandom(8).hex()
    port = _free_port()
    # BFT_CYCLE_TIME: the stall watchdog, the remote trigger's poller in a
    # job of one controller, waits out the phase, so (c)'s two polls are
    # the only ones
    env = {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(port),
           "BFT_CP_SECRET": secret, "BFT_INCARNATION": str(WIRE_INC),
           "BFT_METRICS_INTERVAL": str(WIRE_INTERVAL),
           "BFT_CP_BACKOFF_MS": "20", "BFT_CYCLE_TIME": "600000"}
    with tempfile.TemporaryDirectory(prefix="bft_wire_") as tmp:
        env["BFT_FLIGHT_DIR"] = tmp
        os.environ.update(env)
        try:
            bf.init()
            a = wire_lm(bf, fl, torch, obs)
            ext = native.ControlPlaneClient("127.0.0.1", port, 1,
                                            secret=secret)
            try:
                b = wire_views(bf, ext)
                e = wire_times(bf, ext, card)
                c = wire_dump(bf, ext, tmp, port)
            finally:
                ext.close()
            bf.shutdown()
            d = wire_shards(secret)
        finally:
            bf.shutdown()
            for k in env:
                del os.environ[k]
    e["native_build_s"] = native.build_seconds
    e["lm_ratio_to_obs"] = a["ratio_to_obs"]
    wall = time.perf_counter() - t0
    log(f"wire ({card}): native library build {native.build_seconds} s, LM "
        f"step with the wire / 13(a)'s {a['ratio_to_obs']:.4f}; phase wall "
        f"{wall:.1f} s")
    return {"counts": a["counts"], "lm": a, "views": b, "dump": c,
            "shards": d, "times": e, "wall_s": wall}


class _Helper:
    """Controller 1 of the liveness phase: this script run with HELPER_ARG
    (``_helper_main``), driven by lines on its stdin; its stdout lines
    arrive through a reader thread, so every wait has a timeout."""

    def __init__(self, env: dict) -> None:
        import queue
        import threading

        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), HELPER_ARG],
            env=env, cwd=HERE, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        self.lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line.strip())

    def expect(self, prefix: str) -> str:
        """The helper's next line, which must start with ``prefix``."""
        import queue

        try:
            line = self.lines.get(timeout=LIVE_WAIT_S)
        except queue.Empty:
            raise RuntimeError(f"liveness: the helper said nothing in "
                               f"{LIVE_WAIT_S} s (expected {prefix!r}; "
                               f"exit code {self.proc.poll()})") from None
        if not line.startswith(prefix):
            raise RuntimeError(f"liveness: the helper said {line!r}, "
                               f"expected {prefix!r}")
        return line

    def say(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def kill(self) -> None:
        import signal

        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=LIVE_WAIT_S)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.kill()


def _helper_main() -> int:
    """The helper's body: on ``INIT`` from stdin, ``bf.init(device="cpu")``
    over gloo (a world of one) as controller 1 of the control plane its
    environment names, then only heartbeats. ``COMPLETE`` finishes its
    quarantine, ``SHUTDOWN`` calls ``bf.shutdown()``. It imports before
    it is told to start, so its import overlaps the card's work."""
    sys.path.insert(0, HERE)
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.runtime import heartbeat

    print("HELPER_IMPORTED", flush=True)
    if sys.stdin.readline().strip() != "INIT":
        return 1
    bf.init(device="cpu")
    print(f"HELPER_UP quarantined={heartbeat.quarantine_pending()}",
          flush=True)
    while True:
        cmd = sys.stdin.readline().strip()
        if cmd == "COMPLETE":
            heartbeat.complete_quarantine()
            print("HELPER_COMPLETED", flush=True)
        elif cmd == "SHUTDOWN":
            bf.shutdown()
            print("HELPER_DOWN", flush=True)
            return 0
        elif not cmd:
            return 1  # stdin closed: the card's process is gone


def _wait_until(cond, what: str, limit: float = LIVE_WAIT_S) -> float:
    """Poll ``cond`` every 10 ms; the seconds it took, or raise after
    ``limit``."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > limit:
            raise RuntimeError(f"liveness: {what} not within {limit} s")
        time.sleep(0.01)
    return time.monotonic() - t0


def _ts_slots(doc: dict, name: str, slots: dict) -> None:
    """Fold one ``bf.ts`` document's delta of series ``name`` into
    ``slots`` (slot start in seconds -> value)."""
    rec = doc.get("series", {}).get(name)
    if not rec:
        return
    t = rec["t0_ms"]
    for dt, v in zip([0] + rec["dt_ms"], rec["v"]):
        t += dt
        slots[t / 1000.0] = v


def live_lm(bf, fl, torch, obs: dict, wire_ms: float, ext) -> dict:
    """(a) The LM of 13(a) with the monitor, the sampler and the tuner
    ticking: losses and launches 13(a)'s; then LIVE_RATE_S s more of its
    steps while a thread reads ``bf.ts.0`` through ``ext`` (an outside
    client), for (b)'s rate check; then the median ``PeerMonitor._tick``
    (a second monitor on a connection of its own) and
    ``TimeSeriesStore.sample``."""
    import threading

    from bluefog_tpu_torch.runtime import control_plane as cp
    from bluefog_tpu_torch.runtime import heartbeat, timeseries

    dev = torch.device("cuda", torch.cuda.current_device())
    model, opt, batch = headline(bf, torch, dev, fl.flash_attention)
    run = _train_steps(fl, torch, opt, batch)
    _check_training("liveness", run, LAYERS)
    ms = run["dt"] * 1e3
    if run["losses"] != obs["losses"]:
        raise RuntimeError(f"liveness (a): losses {run['losses']} differ "
                           f"from 13(a)'s {obs['losses']}")
    if run["counts"] != obs["counts"]:
        raise RuntimeError(f"liveness (a): launches {run['counts']} differ "
                           f"from 13(a)'s {obs['counts']}")

    slots: dict = {}
    stop = threading.Event()

    def poll() -> None:
        while not stop.wait(0.2):
            doc = timeseries.read_rank(ext, 0)
            if doc:
                _ts_slots(doc, "opt.step.rate", slots)

    reader = threading.Thread(target=poll, daemon=True)
    reader.start()
    torch.cuda.synchronize()
    t_start, p0, n = time.time(), time.perf_counter(), 0
    while time.perf_counter() - p0 < LIVE_RATE_S:
        opt.step(batch)
        torch.cuda.synchronize()
        n += 1
    rate_ms = (time.perf_counter() - p0) / n * 1e3
    t_end = time.time()
    # the last interior sample reaches the KV within a publication
    time.sleep(2 * LIVE_TS_INTERVAL + 1.0)
    stop.set()
    reader.join(timeout=LIVE_WAIT_S)
    del model, opt

    mon = heartbeat.PeerMonitor(cp.process_index(), cp.world())
    mon._cl = cp.extra_client()
    try:
        tick_us = _median_us(mon._tick, LIVE_TICK_REPS)
    finally:
        mon.stop()
    sample_us = _median_us(timeseries.store().sample, LIVE_TICK_REPS)
    log(f"liveness train (monitor, sampler and tuner ticking): ms/step="
        f"{ms:.3f}, against 13(a)'s {obs['ms_per_step']:.3f} (ratio "
        f"{ms / obs['ms_per_step']:.4f}) and the wire phase's {wire_ms:.3f} "
        f"(ratio {ms / wire_ms:.4f}); losses " + " ".join(
            f"{x:.5f}" for x in run["losses"]) + f"; launches "
        f"{run['counts']}; then {n} steps in {LIVE_RATE_S} s at "
        f"{rate_ms:.3f} ms/step, each closed by a synchronize")
    log(f"liveness costs on this host: median PeerMonitor._tick "
        f"{tick_us:.1f} us, median TimeSeriesStore.sample {sample_us:.1f} us "
        f"({LIVE_TICK_REPS} calls each)")
    return {"counts": run["counts"], "losses": run["losses"],
            "ms_per_step": ms, "ratio_to_obs": ms / obs["ms_per_step"],
            "ratio_to_wire": ms / wire_ms, "rate_ms_per_step": rate_ms,
            "rate_window": (t_start, t_end), "rate_slots": slots,
            "tick_us": tick_us, "sample_us": sample_us}


def live_views(a: dict, ext) -> dict:
    """(b) What the job publishes, read through the outside client: the
    bound series in ``bf.ts.0``, its step rate within LIVE_RATE_TOL of
    1000/ms-per-step over the slots wholly inside the stepping window; the
    tuner's trail ``bf.tune.0``; no ``bf.tune.demoted`` (no window, so no
    lever moved)."""
    from bluefog_tpu_torch.runtime import timeseries

    doc = timeseries.read_rank(ext, 0)
    bound = {"opt.step", "opt.step.rate", "membership.epoch",
             "hb.dead_peers", "hb.suspect_peers"}
    missing = sorted(bound - set(doc["latest"] if doc else ()))
    t_start, t_end = a["rate_window"]
    # a sample in the slot starting at s covers (s - 1, s + 1) at most
    inside = sorted(v for s, v in a["rate_slots"].items()
                    if s - 1.0 >= t_start and s + 1.0 <= t_end)
    want = 1000.0 / a["rate_ms_per_step"]
    rate = inside[len(inside) // 2] if inside else math.nan
    trail_blob = ext.get_bytes("bf.tune.0")
    trail = json.loads(bytes(trail_blob).decode()) if trail_blob else {}
    demoted = ext.get_bytes("bf.tune.demoted")
    log(f"liveness views: bf.ts.0 seq {doc and doc['seq']} with "
        f"{len(doc['latest']) if doc else 0} series, bound series missing "
        f"{missing}; opt.step.rate slots inside the window {inside} "
        f"(median {rate:.3f}/s) against 1000/ms-per-step {want:.3f}/s "
        f"(limit {LIVE_RATE_TOL:.0%}); bf.tune.0 rank "
        f"{trail.get('rank')} levels {trail.get('levels')} demoted "
        f"{trail.get('demoted')} decisions {len(trail.get('decisions', []))}"
        f", {time.time() - trail.get('t', 0):.2f} s old; bf.tune.demoted "
        f"{len(demoted)} bytes")
    bad = []
    if missing:
        bad.append(f"bf.ts.0 lacks {missing}")
    if len(inside) < 2 or not abs(rate - want) <= LIVE_RATE_TOL * want:
        bad.append(f"published step rate {rate} (from {inside}) against "
                   f"{want}")
    if trail.get("rank") != 0 or trail.get("demoted") or \
            trail.get("levels") or not time.time() - trail["t"] < 5.0:
        bad.append(f"bf.tune.0 trail {trail}")
    if demoted:
        bad.append("bf.tune.demoted was published with no window")
    if bad:
        raise RuntimeError("liveness (b): " + "; ".join(bad))
    return {"series": len(doc["latest"]), "rate_slots": inside,
            "rate_per_s": rate, "want_per_s": want}


class _EventWork:
    """A ``Work`` over a CUDA event, as NCCL's is: ``is_completed``
    queries the event, ``wait`` orders the current stream after it."""

    def __init__(self, ev) -> None:
        self.ev = ev

    def is_completed(self) -> bool:
        return self.ev.query()

    def wait(self) -> bool:
        self.ev.wait()
        return True


def _device_sleep(torch, seconds: float):
    """Queue a spin of about ``seconds`` on a side stream (the card's
    cycles per ms measured first) and an event behind it; returns the
    stream and the event."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    torch.cuda._sleep(50_000_000)
    t1.record()
    t1.synchronize()
    per_ms = 50_000_000 / t0.elapsed_time(t1)
    side = torch.cuda.Stream()
    ev = torch.cuda.Event()
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(per_ms * seconds * 1e3))
        ev.record(side)
    return side, ev


def _dump_instants(path: str, name: str) -> tuple:
    """(reason, count of instant ``name``) of the flight dump at path."""
    from bluefog_tpu_torch.runtime import flight

    with open(path) as f:
        doc = json.load(f)
    names = doc["names"]
    n = sum(1 for k, i in zip(doc["events"]["kind"], doc["events"]["name"])
            if k == flight.INSTANT and names[i] == name)
    return doc["meta"]["reason"], n


def live_stall(bf, torch, tmp: str) -> dict:
    """(c) A handle whose op is a LIVE_SLEEP_S s device sleep: the watchdog
    flags it once (one ``watchdog.stalls``, one ``STALL`` instant on the
    timeline, one ``watchdog-stall`` dump) and not again a cycle later;
    ``synchronize`` with a LIVE_SYNC_PROBE_S s deadline raises a plain
    ``RuntimeError`` with the no-dead-peer diagnosis and keeps the
    handle."""
    from bluefog_tpu_torch.runtime import handles, metrics, native

    prefix = os.path.join(tmp, "live_tl_")
    if not bf.start_timeline(prefix):
        raise RuntimeError("liveness (c): start_timeline refused")
    side, ev = _device_sleep(torch, LIVE_SLEEP_S)
    h = handles.allocate("liveness.sleep", [_EventWork(ev)],
                         lambda: "slept")
    flag_s = _wait_until(lambda: metrics.counter("watchdog.stalls").value,
                         "the watchdog's flag", LIVE_STALL_S + 5.0)
    time.sleep(1.2)  # a full watchdog cycle more: no second flag
    stalls = metrics.counter("watchdog.stalls").value
    bf.stop_timeline()
    with open(f"{prefix}{bf.rank()}.json") as f:
        instants = [e for e in json.load(f)
                    if e.get("ph") == "i" and e.get("name") == "STALL"]
    dump = os.path.join(tmp, "bf_flight_0.json")
    reason, marks = _dump_instants(dump, "fatal.watchdog.stall")
    t0 = time.monotonic()
    try:
        handles.synchronize(h, timeout=LIVE_SYNC_PROBE_S)
        err = None
    except RuntimeError as exc:
        err = exc
    probe_s = time.monotonic() - t0
    log(f"liveness stall: flagged {flag_s:.2f} s after the handle was "
        f"issued (stall threshold {LIVE_STALL_S} s, 1 s watchdog cycle); "
        f"watchdog.stalls "
        f"{stalls}, STALL instants {len(instants)} "
        f"({[e.get('cat') for e in instants]}), dump {reason!r} with "
        f"{marks} fatal.watchdog.stall; synchronize(timeout="
        f"{LIVE_SYNC_PROBE_S}) raised {type(err).__name__} after "
        f"{probe_s:.2f} s: {err}")
    bad = []
    if stalls != 1 or len(instants) != 1 or \
            instants[0].get("cat") != "liveness.sleep":
        bad.append(f"flagged {stalls} times, {len(instants)} instants")
    if reason != "watchdog-stall" or marks != 1:
        bad.append(f"dump {reason!r} with {marks} marks")
    if type(err) is not RuntimeError or isinstance(
            err, native.PeerLostError) or \
            "no peer is reported dead" not in str(err):
        bad.append(f"synchronize raised {err!r}")
    if h not in handles.outstanding():
        bad.append("the handle did not stay valid")
    if bad:
        raise RuntimeError("liveness (c): " + "; ".join(bad))
    return {"handle": h, "event": ev, "stream": side, "flag_s": flag_s,
            "probe_s": probe_s}


def live_death(bf, torch, helper: _Helper, c: dict, tmp: str) -> dict:
    """(d) SIGKILL the helper: ``dead_controllers()`` and ``dead_ranks()``
    become {1} within the timeout plus 3 intervals, the epoch rises,
    ``hb.dead_transitions`` is 1; ``synchronize`` on (c)'s handle, the
    sleep still running, raises ``PeerLostError`` with ``dead == {1}``
    after a ``fatal`` dump; after the sleep the retry returns."""
    from bluefog_tpu_torch.runtime import handles, metrics, native

    epoch0 = bf.membership_epoch()
    t_kill = time.monotonic()
    helper.kill()
    latency = _wait_until(lambda: bf.dead_controllers() == {1},
                          "controller 1's death")
    # the monitor adds to its dead set first, then bumps the epoch (a KV
    # round trip) and counts the transition: read them once counted
    _wait_until(lambda: metrics.counter("hb.dead_transitions").value,
                "the death's transition count", 5.0)
    dead_ranks = bf.dead_ranks()
    epoch1 = bf.membership_epoch()
    transitions = metrics.counter("hb.dead_transitions").value
    bound = LIVE_HB_TIMEOUT + 3 * LIVE_HB_INTERVAL
    if c["event"].query():
        raise RuntimeError("liveness (d): the device sleep ended before "
                           "the synchronize it must outlast")
    try:
        handles.synchronize(c["handle"], timeout=LIVE_SYNC_PROBE_S)
        lost = None
    except RuntimeError as exc:
        lost = exc
    reason, marks = _dump_instants(os.path.join(tmp, "bf_flight_0.json"),
                                   "fatal.synchronize")
    t0 = time.monotonic()
    out = handles.synchronize(c["handle"], timeout=LIVE_SLEEP_S + 10.0)
    torch.cuda.synchronize()
    retry_s = time.monotonic() - t0
    log(f"liveness death: dead_controllers {{1}} {latency:.3f} s after the "
        f"SIGKILL (limit {bound} s), dead_ranks {sorted(dead_ranks)}, epoch "
        f"{epoch0} -> {epoch1}, hb.dead_transitions {transitions}; "
        f"synchronize raised {type(lost).__name__} dead="
        f"{getattr(lost, 'dead', None)}, dump {reason!r} with {marks} "
        f"fatal.synchronize; the retry returned {out!r} after "
        f"{retry_s:.2f} s, {time.monotonic() - t_kill:.2f} s after the kill")
    bad = []
    if not latency <= bound or dead_ranks != {1}:
        bad.append(f"death seen after {latency} s, dead ranks {dead_ranks}")
    if not epoch1 > epoch0 or transitions != 1:
        bad.append(f"epoch {epoch0} -> {epoch1}, {transitions} transitions")
    if not isinstance(lost, native.PeerLostError) or lost.dead != {1}:
        bad.append(f"synchronize raised {lost!r}")
    if reason != "synchronize: PeerLostError" or marks != 1:
        bad.append(f"dump {reason!r} with {marks} marks")
    if out != "slept" or not c["event"].query():
        bad.append(f"the retry returned {out!r}")
    if bad:
        raise RuntimeError("liveness (d): " + "; ".join(bad))
    return {"detect_s": latency, "bound_s": bound, "epoch": [epoch0, epoch1],
            "retry_s": retry_s}


def live_rejoin(bf, helper: _Helper) -> dict:
    """(e) The helper again (a process started with the first, waiting),
    as incarnation 1: its resumed heartbeat makes controller 1 a suspect
    that stays dead, also through 4 more ticks; only its
    ``complete_quarantine()`` takes it out of both sets; each transition
    bumps the epoch."""
    from bluefog_tpu_torch.runtime import metrics

    epochs = [bf.membership_epoch()]
    helper.expect("HELPER_IMPORTED")
    helper.say("INIT")
    up = helper.expect("HELPER_UP")
    suspect_s = _wait_until(lambda: bf.suspect_controllers() == {1},
                            "controller 1 as a suspect")
    # each transition's epoch bump lands before its count: read after it
    _wait_until(lambda: metrics.counter("hb.suspect_transitions").value,
                "the suspect transition's count", 5.0)
    epochs.append(bf.membership_epoch())
    fenced = []
    t0 = time.monotonic()
    while time.monotonic() - t0 < 4 * LIVE_HB_INTERVAL:
        fenced.append(bf.suspect_controllers() == {1} and
                      bf.dead_controllers() == {1})
        time.sleep(0.02)
    helper.say("COMPLETE")
    helper.expect("HELPER_COMPLETED")
    readmit_s = _wait_until(
        lambda: not bf.dead_controllers() and not bf.suspect_controllers(),
        "controller 1's re-admission")
    _wait_until(lambda: metrics.counter("hb.readmissions").value,
                "the re-admission's count", 5.0)
    epochs.append(bf.membership_epoch())
    counts = {k: metrics.counter(k).value for k in
              ("hb.suspect_transitions", "hb.readmissions")}
    log(f"liveness rejoin: helper {up!r}; suspect {suspect_s:.3f} s after "
        f"it came up, dead and suspect through {len(fenced)} polls over 4 "
        f"intervals: {all(fenced)}; re-admitted {readmit_s:.3f} s after "
        f"complete_quarantine; epochs {epochs}; {counts}")
    bad = []
    if up != "HELPER_UP quarantined=True" or not all(fenced):
        bad.append(f"{up!r}, fenced {all(fenced)}")
    if not epochs[0] < epochs[1] < epochs[2]:
        bad.append(f"epochs {epochs}")
    if counts != {"hb.suspect_transitions": 1, "hb.readmissions": 1}:
        bad.append(f"counters {counts}")
    if bad:
        raise RuntimeError("liveness (e): " + "; ".join(bad))
    return {"suspect_s": suspect_s, "readmit_s": readmit_s,
            "epochs": epochs}


def live_shutdown(bf, helper: _Helper) -> dict:
    """(f) The helper's ``bf.shutdown()`` reaches this process's
    ``shutdown_requested()`` within 3 intervals; then this process's own
    ``bf.shutdown()`` returns without waiting out the LIVE_GRACE_S s
    grace."""
    if bf.shutdown_requested():
        raise RuntimeError("liveness (f): shutdown requested too early")
    t0 = time.monotonic()
    helper.say("SHUTDOWN")
    seen_s = _wait_until(bf.shutdown_requested, "the helper's shutdown")
    helper.expect("HELPER_DOWN")
    rc = helper.proc.wait(timeout=LIVE_WAIT_S)
    t0 = time.monotonic()
    bf.shutdown()
    down_s = time.monotonic() - t0
    log(f"liveness shutdown: shutdown_requested {seen_s:.3f} s after the "
        f"helper was told (limit {3 * LIVE_HB_INTERVAL} s), the helper "
        f"exited {rc}; this process's bf.shutdown() took {down_s:.3f} s "
        f"(grace {LIVE_GRACE_S} s)")
    if not seen_s <= 3 * LIVE_HB_INTERVAL or rc != 0 or \
            not down_s < LIVE_GRACE_S:
        raise RuntimeError(f"liveness (f): seen after {seen_s} s, helper "
                           f"exit {rc}, shutdown {down_s} s")
    return {"seen_s": seen_s, "shutdown_s": down_s}


def liveness(bf, fl, torch, card: str, obs: dict, wire_run: dict) -> dict:
    """Phase 15: failure detection and the telemetry plane beside the LM,
    (a)-(f), the card's process controller 0 of LIVE_WORLD."""
    from bluefog_tpu_torch.runtime import native

    t0 = time.perf_counter()
    secret = "chip-smoke-" + os.urandom(8).hex()
    port = _free_port()
    common = {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(port),
              "BFT_CP_WORLD": str(LIVE_WORLD), "BFT_CP_SECRET": secret,
              "BFT_HEARTBEAT_INTERVAL": str(LIVE_HB_INTERVAL),
              "BFT_HEARTBEAT_TIMEOUT": str(LIVE_HB_TIMEOUT),
              "BFT_SHUTDOWN_GRACE": str(LIVE_GRACE_S),
              "BFT_CP_BACKOFF_MS": "20"}
    env = dict(common, BFT_CP_RANK="0", BFT_TS_INTERVAL=str(LIVE_TS_INTERVAL),
               BFT_TUNE="1", BFT_TUNE_INTERVAL=str(LIVE_TUNE_INTERVAL),
               BFT_STALL_WARNING_TIME=str(LIVE_STALL_S),
               BFT_FLIGHT_MIN_INTERVAL="0")
    helper_env = {k: v for k, v in os.environ.items()
                  if not k.startswith("BFT_")}
    helper_env.update(common, BFT_CP_RANK="1", BFT_TS_DISABLE="1")
    helpers: list = []
    out = {}
    with tempfile.TemporaryDirectory(prefix="bft_live_") as tmp:
        env["BFT_FLIGHT_DIR"] = helper_env["BFT_FLIGHT_DIR"] = tmp
        os.environ.update(env)
        try:
            # both helper processes now (the second is (e)'s incarnation
            # 1): their imports take seconds and overlap
            helpers.append(_Helper(helper_env))
            helpers.append(_Helper(dict(helper_env, BFT_INCARNATION="1")))
            helpers[0].expect("HELPER_IMPORTED")
            bf.init()
            helpers[0].say("INIT")
            helpers[0].expect("HELPER_UP quarantined=False")
            ext = native.ControlPlaneClient("127.0.0.1", port, 100,
                                            secret=secret, streams=1)
            try:
                _wait_until(lambda: ext.get("bf.hb.1") != 0,
                            "the helper's first heartbeat")
                out["lm"] = live_lm(bf, fl, torch, obs,
                                    wire_run["lm"]["ms_per_step"], ext)
                out["views"] = live_views(out["lm"], ext)
            finally:
                ext.close()
            out["lm"].pop("rate_slots")
            c = live_stall(bf, torch, tmp)
            out["death"] = live_death(bf, torch, helpers[0], c, tmp)
            out["stall"] = {k: c[k] for k in ("flag_s", "probe_s")}
            out["rejoin"] = live_rejoin(bf, helpers[1])
            out["shutdown"] = live_shutdown(bf, helpers[1])
        finally:
            for helper in helpers:
                helper.close()
            bf.shutdown()
            for k in env:
                del os.environ[k]
    out["wall_s"] = time.perf_counter() - t0
    out["counts"] = out["lm"]["counts"]
    log(f"liveness ({card}): LM step with the monitor, sampler and tuner / "
        f"13(a)'s {out['lm']['ratio_to_obs']:.4f}, / the wire phase's "
        f"{out['lm']['ratio_to_wire']:.4f}; tick {out['lm']['tick_us']:.1f} "
        f"us, sample {out['lm']['sample_us']:.1f} us; death seen "
        f"{out['death']['detect_s']:.3f} s after the SIGKILL; shutdown "
        f"{out['shutdown']['shutdown_s']:.3f} s; phase wall "
        f"{out['wall_s']:.1f} s")
    return out


# -- phase 16: the window layer ---------------------------------------------


def _win_oracle_blend(mails_o, lay, xs_o, tables, accumulate: bool) -> None:
    """The f64 oracle of one exchange: ``mail[dst][k] (+)= x[src] * w``
    for every edge its source names this call."""
    for src, table in enumerate(tables):
        for dst, w in table.items():
            k = lay.slot_of[dst][src]
            if accumulate:
                mails_o[dst][k] += xs_o[src] * w
            else:
                mails_o[dst][k] = xs_o[src] * w


def _win_vexchange(W, lay, mails, hosts, xs, ps, tables, accumulate: bool,
                   fault=None) -> None:
    """One exchange of the virtual group through the port's own receiver
    step (``windows.fold_arrival``): rank ``me``'s arrival on each shift is
    a device copy of its in-neighbour's tensor, in place of the P2P round,
    with the sender's weight for ``me`` or inactive (the scratch slot) and
    the sender's p (``ps``, None with associated p off); the p mail and
    the version bump land on ``hosts[me]``, as on the exchange's receiving
    side. ``fault="slot_off_by_one"`` writes each active arrival one slot
    over."""
    for me in range(lay.n):
        for si, s in enumerate(lay.shifts):
            if not lay.has_edge[si, me]:
                continue
            src = (me - s) % lay.n
            w = tables[src].get(me)
            slot = int(lay.slot[si, me])
            if fault == "slot_off_by_one" and w is not None:
                slot = (slot + 1) % lay.d_max
            if W.fold_arrival(mails[me], hosts[me], me, slot, xs[src].clone(),
                              w is not None, 0.0 if w is None else w,
                              0.0 if ps is None else ps[src], accumulate,
                              ps is not None):
                hosts[me].bump_versions([(me, slot)])


def _win_nerr(torch, got: list, want: list) -> float:
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g.double() - w).abs().max()) for g, w in
               zip(got, want)) / max(scale, 1e-30)


def win_virtual(bf, torch, dev, dtype, fault=None) -> dict:
    """(b) A virtual window group of WIN_VN ranks on ExponentialTwoGraph
    (d_max 3 at 8), one WIN_ROW-element tensor each, driven through the
    port's per-rank steps (the slot write and scratch redirect, the
    accumulate's read-add-write, ``combine`` with reset, ``p_combine``)
    against an f64 oracle on the card: a dynamic partial-destination put
    read back with distinct slot weights; stacked accumulates with self
    scaling; WIN_PS_ROUNDS rounds of push-sum. Returns the errors."""
    from bluefog_tpu_torch.ops import windows as W

    n, row = WIN_VN, WIN_ROW
    lay = W._GraphLayout(bf.topology_util.ExponentialTwoGraph(n), n)
    d = lay.d_max
    gen = torch.Generator(device=dev).manual_seed(16)
    xs = [(1.0 + 0.5 * torch.randn(row, generator=gen, device=dev)).to(dtype)
          for _ in range(n)]
    xs_o = [x.double() for x in xs]
    out = {}

    def fresh():
        return ([torch.zeros((d + 1, row), dtype=dtype, device=dev)
                 for _ in range(n)],
                [torch.zeros((d, row), dtype=torch.float64, device=dev)
                 for _ in range(n)],
                [W._LocalWinHost("virtual", n, d, r) for r in range(n)])

    # a dynamic partial-destination put: each rank writes its right
    # neighbour only (weight 2); the other edges' writes land in scratch
    # and bump no version
    mails, mails_o, hosts = fresh()
    tables = [{(r + 1) % n: 2.0} for r in range(n)]
    _win_vexchange(W, lay, mails, hosts, xs, None, tables, False, fault)
    _win_oracle_blend(mails_o, lay, xs_o, tables, False)
    if fault is None:
        for r in range(n):
            want_v = np.zeros(d, np.int64)
            want_v[lay.slot_of[r][(r - 1) % n]] = 1
            if not np.array_equal(hosts[r].version[r], want_v):
                raise RuntimeError(
                    f"windows (b): rank {r}'s versions after the partial "
                    f"put are {hosts[r].version[r].tolist()}, expected "
                    f"{want_v.tolist()}")
    got, want = [], []
    for r in range(n):
        nw = [0.1 * (k + 1) for k in range(d)]
        got.append(W.combine(xs[r], mails[r], 0.5, nw, reset=range(d)))
        want.append(0.5 * xs_o[r] + sum(
            float(np.float32(w)) * mails_o[r][k] for k, w in enumerate(nw)))
        if fault is None and float(mails[r][:d].abs().max()) != 0.0:
            raise RuntimeError("windows (b): reset left a slot non-zero")
    out["partial_put"] = _win_nerr(torch, got, want)
    del got, want, mails, mails_o
    if fault is not None:
        return out

    # stacked accumulates (weight 0.5 to every out-neighbour), each
    # followed by the self scaling x * 0.5, then the full collect
    mails, mails_o, hosts = fresh()
    tables = [{dst: 0.5 for dst in lay.out_nbrs[r]} for r in range(n)]
    for _ in range(2):
        _win_vexchange(W, lay, mails, hosts, xs, None, tables, True)
        _win_oracle_blend(mails_o, lay, xs_o, tables, True)
    got, want = [], []
    for r in range(n):
        self_r = (xs[r].float() * 0.5).to(dtype)
        got.append(W.combine(self_r, mails[r], 1.0, [1.0] * d,
                             reset=range(d)))
        want.append(0.5 * xs_o[r] + mails_o[r].sum(0))
    out["stacked_acc"] = _win_nerr(torch, got, want)
    del got, want, mails, mails_o

    # push-sum: numerators and p through WIN_PS_ROUNDS rounds of
    # accumulate (1/(outdeg+1) to self and to every out-neighbour) and
    # collect, against the same algebra in f64
    mails, mails_o, hosts = fresh()
    num = [x.clone() for x in xs]
    num_o = [x.clone() for x in xs_o]
    p = [1.0] * n
    for _ in range(WIN_PS_ROUNDS):
        sw = [1.0 / (len(lay.out_nbrs[r]) + 1) for r in range(n)]
        tables = [{dst: sw[r] for dst in lay.out_nbrs[r]} for r in range(n)]
        _win_vexchange(W, lay, mails, hosts, num, p, tables, True)
        _win_oracle_blend(mails_o, lay, num_o, tables, True)
        acc = W._win_acc_dtype(dtype)
        num = [(num[r].to(acc) * float(np.float32(sw[r]))).to(dtype)
               for r in range(n)]
        num_o = [num_o[r] * sw[r] for r in range(n)]
        p = [p[r] * sw[r] for r in range(n)]
        for r in range(n):
            num[r] = W.combine(num[r], mails[r], 1.0, [1.0] * d,
                               reset=range(d))
            num_o[r] = num_o[r] + mails_o[r].sum(0)
            mails_o[r].zero_()
            p[r] = W.p_combine(1.0, p[r], [1.0] * d,
                               hosts[r].read_p_mail_owned()[r])
            hosts[r].write_p_mail_rows({r: np.zeros(d)})
    # the oracle's p: each round keeps sw * p and adds each in-neighbour's
    # sw * p, in f64
    q = [1.0] * n
    for _ in range(WIN_PS_ROUNDS):
        sw = [1.0 / (len(lay.out_nbrs[r]) + 1) for r in range(n)]
        q = [sw[r] * q[r] + sum(q[src] * sw[src] for src in lay.in_nbrs[r])
             for r in range(n)]
    out["pushsum"] = _win_nerr(torch, num, num_o)
    out["p_sum"] = sum(p)
    out["p_err"] = max(abs(a - b) for a, b in zip(p, q))
    mass0 = sum(float(x.sum(dtype=torch.float64)) for x in xs_o)
    mass = sum(float(x.double().sum()) for x in num)
    out["mass_rel"] = abs(mass - mass0) / abs(mass0)
    return out


def win_collective(bf, torch, dev, card: str) -> tuple:
    """(a) The collective plane at world 1 on the headline LM's seeded
    parameters packed into one f32 row: every op against its closed form
    at n = 1, the ms of ``win_put`` and ``win_update`` beside their bytes
    bound, peak memory, and nothing left on the card after ``win_free``.
    Returns (results, the packed row)."""
    import gc

    from bluefog_tpu_torch.ops import fusion

    model = headline_model(bf, torch, dev, None)
    params = [p.detach() for p in model.parameters()]
    spec = fusion.make_spec(params)
    row = fusion.pack(params, spec)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    numel = row.numel()
    if row.dtype != torch.float32 or numel != spec.total:
        raise RuntimeError(f"windows (a): packed row {row.dtype} {numel}")
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    name = "win16"
    bad = []

    def same(label, got, want):
        if not torch.equal(got, want):
            bad.append(label)

    if not bf.win_create(row, name) or bf.win_create(row, name):
        bad.append("win_create")
    same("update after create", bf.win_update(name, clone=True), row)
    half, quarter = row * 0.5, row * 0.25
    bf.win_put(row, name, self_weight=0.5)
    same("win_put self_weight 0.5", bf.win_update(name, clone=True), half)
    bf.win_accumulate(row, name, self_weight=0.25)
    same("win_accumulate self_weight 0.25",
         bf.win_update(name, clone=True), quarter)
    if not bf.win_get(name):
        bad.append("win_get")
    same("win_get leaves self", bf.win_update(name, clone=True), quarter)
    same("win_update 2.0 reset", bf.win_update(
        name, self_weight=2.0, neighbor_weights={}, reset=True), half)
    same("win_update_then_collect", bf.win_update_then_collect(name), half)
    if not bf.win_fence(name) or bf.get_win_version(name) != {}:
        bad.append("win_fence / get_win_version")
    with bf.win_mutex(name, for_self=True), bf.win_lock(name):
        pass
    bf.turn_on_win_ops_with_associated_p()
    bf.win_accumulate(row, name, self_weight=0.5)
    p1 = bf.win_associated_p(name)
    bf.win_update(name, self_weight=2.0, neighbor_weights={})
    p2 = list(bf.win_associated_p_all(name))
    bf.turn_off_win_ops_with_associated_p()
    bf.win_accumulate(row, name, self_weight=0.5)
    p3 = bf.win_associated_p(name)
    if (p1, p2, p3) != (0.5, [1.0], 1.0):
        bad.append(f"associated p {(p1, p2, p3)}")
    del half, quarter
    put_ms = cuda_ms(lambda: bf.win_put(row, name, self_weight=0.5),
                     WIN_TIME_REPS)
    upd_ms = cuda_ms(lambda: bf.win_update(name), WIN_TIME_REPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - m0
    bf.win_free(name)
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - m0
    if left:
        bad.append(f"win_free left {left} bytes on the card")
    if bad:
        raise RuntimeError("windows (a): " + "; ".join(bad))
    # each of put (the self scaling) and update (the self combine) at n = 1
    # reads the row once and writes it once
    bound = 2 * numel * 4 / PEAK_BYTES * 1e3
    out = {"numel": numel, "put_ms": put_ms, "update_ms": upd_ms,
           "bound_ms": bound, "peak_bytes": peak, "left_bytes": left}
    log(f"windows (a) ({card}): the collective plane at world 1 on the "
        f"packed headline parameters ({numel} f32): every closed form "
        f"exact; win_put {put_ms:.4f} ms and win_update {upd_ms:.4f} ms "
        f"(bytes bound {bound:.4f} ms at 3.35 TB/s each); peak "
        f"{peak / 2**30:.3f} GiB above the row; 0 bytes left after win_free")
    return out, row


def win_hosted_wire(bf, torch, dev, row, card: str) -> dict:
    """(c) The hosted wire at full width on a loopback control plane of one
    (``BFT_WIN_PLANE=hosted``, the mailbox cap raised to WIN_CAP_MB to hold
    one full deposit): ``win_create`` publishes the row (int8 state: a raw
    f32 row is above the server's 1 GiB message ceiling); then, per codec,
    one deposit of the card's row through the window's own path
    (``_encode_row``, ``_pack_deposit``, the tagged append, the drain's
    reassembly, ``_finish_deposit`` into slot 0), the slot copied back to
    the card and held to its exact expectation."""
    from bluefog_tpu_torch.ops import codec as cd
    from bluefog_tpu_torch.ops import fusion
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.runtime import control_plane as cp

    # BFT_WIN_CODEC=int8 at creation: the published state row rides int8
    # (a raw f32 row of 1.34 GB is above the server's 1 GiB per-message
    # ceiling); each deposit below sets its own codec
    env = {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(_free_port()),
           "BFT_WIN_PLANE": "hosted", "BFT_CP_MAILBOX_MAX_MB": str(WIN_CAP_MB),
           "BFT_WIN_CODEC": "int8", "BFT_CYCLE_TIME": "600000"}
    out = {"codecs": {}}
    os.environ.update(env)
    try:
        bf.init()
        t = time.perf_counter()
        bf.win_create(row, "win16h", zero_init=True)
        out["create_ms"] = (time.perf_counter() - t) * 1e3
        win = W._get_window("win16h")
        if not win.hosted or win.layout.d_max != 1:
            raise RuntimeError("windows (c): not a hosted window of one slot")
        n = row.numel()
        key = win._dep_key(0, 0)
        wire_t = W._win_wire_dtype(win.mail_dtype)
        cl = cp.client()
        folds = []
        finish = win._finish_deposit

        def timed_finish(pair, pend):
            t0 = time.perf_counter()
            finish(pair, pend)
            folds.append(time.perf_counter() - t0)

        win._finish_deposit = timed_finish
        for seq, spec in enumerate(WIN_CODECS, 1):
            win.codec = cd.resolve(spec)
            win._ef_rows.clear()
            win._ef_ref.clear()
            win._mail_rows[0][0][...] = 0.0
            ms = {}
            t = time.perf_counter()
            host = fusion.to_host(row)
            ms["d2h"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            if win.codec is None:
                payload = np.ascontiguousarray(cd.cast(
                    host * np.float32(1.0), wire_t))
                cid = 0
            else:
                payload, _, _ = win._encode_row(0, host, wire_t, W._DEP_PUT)
                cid = win.codec.cid
            ms["encode"] = (time.perf_counter() - t) * 1e3
            recs = W._pack_deposit(W._DEP_PUT, 0, 0.0, payload,
                                   codec_id=cid, wt=1.0)
            tags = W._deposit_tags(seq, len(recs))
            names = [key] * len(recs)
            if W._precheck_mailbox_cap(win, names, recs,
                                       [(0, 0, 0)] * len(recs)):
                raise RuntimeError("windows (c): the mailbox cap refuses "
                                   "the deposit")
            t = time.perf_counter()
            replies = cl.append_bytes_tagged_many(names, recs, tags)
            ms["append"] = (time.perf_counter() - t) * 1e3
            if min(replies) < 0:
                raise RuntimeError(f"windows (c): append refused {replies}")
            folds.clear()
            t = time.perf_counter()
            win._drain_deposits()
            drain = (time.perf_counter() - t) * 1e3
            if len(folds) != 1:
                raise RuntimeError(f"windows (c): {len(folds)} deposits "
                                   "drained, not 1")
            ms["fold"] = folds[0] * 1e3
            ms["take"] = drain - ms["fold"]
            slot = win._mail_rows[0][0]
            t = time.perf_counter()
            back = fusion.from_host(slot, torch.float32, dev)
            torch.cuda.synchronize()
            ms["h2d"] = (time.perf_counter() - t) * 1e3
            if win.codec is None:
                ok = torch.equal(back, row)
            elif win.codec.error_feedback:
                ok = np.array_equal(slot + win._ef_rows[0], host)
            else:
                ok = np.array_equal(slot, win.codec.decode(
                    win.codec.encode(host), np.float32, n))
            if not ok:
                raise RuntimeError(f"windows (c): the {spec} fold is not "
                                   "its expected row")
            wire = sum(memoryview(r).nbytes for r in recs)
            out["codecs"][spec] = dict(ms, wire_bytes=wire,
                                       raw_bytes=n * 4)
            del back, payload, recs, host
            log(f"windows (c) ({card}) {spec}: {wire} wire bytes "
                f"({wire / (n * 4):.4f} of the row), exact; ms: "
                + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
        win._finish_deposit = finish
        bf.win_free("win16h")
    finally:
        bf.shutdown()
        for k in env:
            del os.environ[k]
    log(f"windows (c) ({card}): win_create publishes the {row.numel()}-"
        f"element row (int8 state) in {out['create_ms']:.1f} ms")
    return out


def windows(bf, torch, card: str) -> dict:
    """Phase 16: the window layer, (a)-(c)."""
    import gc

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    bf.init()
    try:
        a, row = win_collective(bf, torch, dev, card)
    finally:
        bf.shutdown()
    torch.cuda.empty_cache()
    b = {}
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).split(".")[1]
        r = win_virtual(bf, torch, dev, dtype)
        gc.collect()
        torch.cuda.empty_cache()
        planted = win_virtual(bf, torch, dev, dtype,
                              fault="slot_off_by_one")["partial_put"]
        gc.collect()
        torch.cuda.empty_cache()
        tol, mass_tol = TOL_WIN[label], TOL_WIN_MASS[label]
        log(f"windows (b) ({card}) virtual group of {WIN_VN}, rows of "
            f"{WIN_ROW} {label}: max|err|/max|oracle| partial put "
            f"{r['partial_put']:.3e}, stacked accumulates "
            f"{r['stacked_acc']:.3e}, push-sum x{WIN_PS_ROUNDS} "
            f"{r['pushsum']:.3e} (limit {tol}); sum(p) {r['p_sum']!r}, p "
            f"err {r['p_err']:.3e}; mass rel err {r['mass_rel']:.3e} "
            f"(limit {mass_tol}); planted slot_off_by_one {planted:.3e}")
        worst = max(r["partial_put"], r["stacked_acc"], r["pushsum"])
        if not (worst <= tol and r["mass_rel"] <= mass_tol
                and abs(r["p_sum"] - WIN_VN) <= 1e-12
                and r["p_err"] <= 1e-12):
            raise RuntimeError(f"windows (b) {label}: {r}")
        if not planted > tol:
            raise RuntimeError(f"windows (b) {label}: the planted "
                               f"slot_off_by_one passed ({planted})")
        b[label] = dict(r, planted=planted)
    c = win_hosted_wire(bf, torch, dev, row, card)
    del row
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"windows ({card}): phase wall {wall:.1f} s")
    return {"collective": a, "virtual": b, "hosted": c, "wall_s": wall}


def _winopt_legs(metrics, before=None) -> dict:
    """The optimizer's host-timed legs: (count, sum) of each histogram, or
    the mean ms of each since ``before``."""
    names = ("opt.pack_sec", "opt.gossip_sec", "opt.unpack_sec")
    now = {n: (metrics.histogram(n).count, metrics.histogram(n).sum)
           for n in names}
    if before is None:
        return now
    return {n.split(".")[1][:-4]: (now[n][1] - before[n][1]) * 1e3
            / max(1, now[n][0] - before[n][0]) for n in names}


def _winopt_lm(bf, fl, torch, dev, cls: str, ref=None, warmup=WARMUP,
               steps=STEPS, check=True) -> dict:
    """The headline LM of the train phase (same seed, same batch) under
    ``cls`` (a window optimizer, or the reference neighbor allreduce):
    ``warmup`` + ``steps`` steps, the launch counts, the host-timed legs,
    and whether its final parameters equal ``ref``'s bit for bit (``ref``
    None: they are returned, cloned, as the reference)."""
    from bluefog_tpu_torch.runtime import metrics

    model = headline_model(bf, torch, dev, fl.flash_attention)
    opt = getattr(bf, cls)(torch.optim.Adam(model.parameters(), lr=1e-3),
                           model, bf.models.lm_loss)
    before = _winopt_legs(metrics)
    run = _train_steps(fl, torch, opt, headline_batch(torch, dev),
                       warmup, steps)
    if check:
        _check_training(cls, run, LAYERS)
    out = {"counts": run["counts"], "ms_per_step": run["dt"] * 1e3,
           "peak_bytes": run["peak"], "losses": run["losses"],
           "legs_ms": _winopt_legs(metrics, before)}
    params = [p.detach() for p in model.parameters()]
    if ref is None:
        out["params"] = [p.clone() for p in params]
    else:
        out["params_equal"] = all(torch.equal(a, b)
                                  for a, b in zip(params, ref))
    if hasattr(opt, "free"):
        opt.free()
    del opt, model, params
    torch.cuda.empty_cache()
    return out


def _winopt_line(label: str, r: dict, card: str, base_ms: float) -> None:
    log(f"window optimizers {label} ({card}): ms/step="
        f"{r['ms_per_step']:.3f} (train's {base_ms:.3f}, ratio "
        f"{r['ms_per_step'] / base_ms:.4f}) peak_mem_GiB="
        f"{r['peak_bytes'] / 2**30:.3f} launches {r['counts']}; host legs "
        "ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["legs_ms"].items())
        + f"; losses {' '.join(f'{x:.5f}' for x in r['losses'])}; "
        f"bit for bit: losses {r['losses_equal']}, parameters "
        f"{r['params_equal']}")


def winopt_collective(bf, fl, torch, card: str, train_run: dict) -> dict:
    """17(a) and (b): the collective plane at world 1 (NCCL), each kind,
    then win-put and push-sum with the row sharded WINOPT_SHARD ways, and
    the planted scatter into the next shard."""
    from bluefog_tpu_torch.ops import fusion

    bf.init()
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        ref = _winopt_lm(bf, fl, torch, dev,
                         "DistributedNeighborAllreduceOptimizer")
        if ref["losses"] != train_run["losses"]:
            raise RuntimeError(f"window optimizers: the reference run's "
                               f"losses {ref['losses']} are not the train "
                               f"phase's {train_run['losses']}")
        params = ref.pop("params")
        out = {"reference": ref, "collective": {}, "sharded": {}}
        base = train_run["ms_per_step"]
        for cls in WINOPT_KINDS:
            r = _winopt_lm(bf, fl, torch, dev, cls, ref=params)
            r["losses_equal"] = r["losses"] == train_run["losses"]
            _winopt_line(f"(a) {cls}", r, card, base)
            out["collective"][cls] = r
        os.environ["BFT_WIN_SHARD"] = str(WINOPT_SHARD)
        try:
            for cls in WINOPT_KINDS[::2]:
                r = _winopt_lm(bf, fl, torch, dev, cls, ref=params)
                r["losses_equal"] = r["losses"] == train_run["losses"]
                _winopt_line(f"(b) {cls}, S={WINOPT_SHARD}", r, card, base)
                out["sharded"][cls] = r
            # the shard functions alone on the LM's parameters, CUDA events
            model = headline_model(bf, torch, dev, fl.flash_attention)
            ps = list(model.parameters())
            from bluefog_tpu_torch.ops import partition

            spec = fusion.make_spec(ps, shard=partition.spec_for_tree(
                model, WINOPT_SHARD))
            row = fusion.pack_shard(ps, spec, 1)
            out["pack_shard_ms"] = cuda_ms(
                lambda: fusion.pack_shard(ps, spec, 1), 5)
            out["scatter_shard_ms"] = cuda_ms(
                lambda: fusion.scatter_shard(ps, row, spec, 1), 5)
            out["shard_row_elements"] = spec.shard.row_len
            del model, ps, row
            torch.cuda.empty_cache()
            log(f"window optimizers (b) ({card}): pack_shard "
                f"{out['pack_shard_ms']:.3f} ms, scatter_shard "
                f"{out['scatter_shard_ms']:.3f} ms for a row of "
                f"{out['shard_row_elements']} f32 elements")
            real = fusion.scatter_shard

            def planted(tensors, buf, spec, shard):
                return real(tensors, buf, spec,
                            (shard + 1) % spec.shard.factor)

            fusion.scatter_shard = planted
            try:
                r = _winopt_lm(bf, fl, torch, dev, WINOPT_KINDS[0],
                               ref=params, warmup=1, steps=2, check=False)
            finally:
                fusion.scatter_shard = real
            caught = r["losses"] != train_run["losses"][:3]
            log(f"window optimizers (b) ({card}), planted "
                f"{WINOPT_FAULTS[0]}: losses {r['losses']} against "
                f"{train_run['losses'][:3]}: caught {caught}")
            out["planted"] = {"losses": r["losses"], "caught": caught}
        finally:
            del os.environ["BFT_WIN_SHARD"]
        del params
    finally:
        bf.shutdown()
    bad = [k for part in ("collective", "sharded")
           for k, r in out[part].items()
           if not (r["losses_equal"] and r["params_equal"])]
    if bad:
        raise RuntimeError(f"window optimizers: not bit for bit with the "
                           f"train phase: {bad}")
    if not out["planted"]["caught"]:
        raise RuntimeError("window optimizers: the planted "
                           f"{WINOPT_FAULTS[0]} passed")
    return out


class _Legs:
    """Times the hosted step's legs: each wrapped function's wall seconds
    (the card synchronized around it), summed per leg."""

    def __init__(self, torch, fusion, W) -> None:
        self.sec = {k: 0.0 for k in WINOPT_LEGS}
        self._undo = []
        sync = torch.cuda.synchronize

        def wrap(owner, attr, leg):
            real = getattr(owner, attr)

            def timed(*a, **k):
                sync()
                t0 = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    sync()
                    self.sec[leg] += time.perf_counter() - t0

            setattr(owner, attr, timed)
            self._undo.append((owner, attr, real))

        wrap(fusion, "pack_shard", "pack")
        wrap(W, "to_host", "d2h")
        wrap(W.Window, "_publish_selves", "publish")
        wrap(W.Window, "_drain_deposits", "drain")
        wrap(W, "from_host", "h2d")
        wrap(fusion, "scatter_shard", "scatter")

    def close(self) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)


def winopt_hosted(bf, fl, torch, card: str, train_run: dict,
                  coll: dict) -> dict:
    """17(c) and (d): the hosted plane on a loopback control plane of one
    (``BFT_WIN_PLANE=hosted``, ``BFT_WIN_SHARD=8``): the full-width row's
    refusal without a shard factor or a codec, then win-put (publishing a
    serving snapshot every step) and push-sum for WINOPT_HOSTED_STEPS
    communicating steps: losses bit for bit, the legs in ms, push-sum's
    mass against its minted, the snapshot read back bit for bit."""
    from bluefog_tpu_torch.ops import fusion
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.runtime import control_plane as cp
    from bluefog_tpu_torch.runtime import metrics
    from bluefog_tpu_torch.serving import snapshot

    env = {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(_free_port()),
           "BFT_WIN_PLANE": "hosted", "BFT_CYCLE_TIME": "600000"}
    os.environ.update(env)
    out = {"runs": {}}
    try:
        bf.init()
        dev = torch.device("cuda", torch.cuda.current_device())
        model = headline_model(bf, torch, dev, fl.flash_attention)
        try:
            bf.DistributedWinPutOptimizer(
                torch.optim.Adam(model.parameters(), lr=1e-3), model,
                bf.models.lm_loss)
            raise RuntimeError("window optimizers (c): a raw full-width "
                               "hosted row was not refused")
        except ValueError as e:
            msg = str(e)
            if "BFT_WIN_SHARD" not in msg or "BFT_WIN_CODEC" not in msg:
                raise
            out["refusal"] = msg
            log(f"window optimizers (c) ({card}): unsharded full width "
                f"refused: {msg}")
        del model
        torch.cuda.empty_cache()
        os.environ["BFT_WIN_SHARD"] = str(WINOPT_SHARD)
        for cls in WINOPT_KINDS[::2]:
            snap = cls == WINOPT_KINDS[0]
            if snap:
                os.environ["BFT_SERVE_PUBLISH_EVERY"] = "1"
            try:
                model = headline_model(bf, torch, dev, fl.flash_attention)
                opt = getattr(bf, cls)(
                    torch.optim.Adam(model.parameters(), lr=1e-3), model,
                    bf.models.lm_loss)
                win = W._get_window(opt._win_names[0])
                if not (win.hosted and win.shard_factor == WINOPT_SHARD):
                    raise RuntimeError("window optimizers (c): not a "
                                       "hosted sharded window")
                legs = _Legs(torch, fusion, W)
                pubs = metrics.counter("serve.publish_wire_bytes").value
                try:
                    run = _train_steps(fl, torch, opt,
                                       headline_batch(torch, dev), 0,
                                       WINOPT_HOSTED_STEPS)
                finally:
                    legs.close()
                r = {"counts": run["counts"],
                     "ms_per_step": run["dt"] * 1e3,
                     "peak_bytes": run["peak"], "losses": run["losses"],
                     "legs_ms": {k: v * 1e3 / WINOPT_HOSTED_STEPS
                                 for k, v in legs.sec.items()},
                     "row_bytes": int(win._rows[0].nbytes)}
                r["losses_equal"] = run["losses"] == \
                    train_run["losses"][:WINOPT_HOSTED_STEPS]
                a_ms = coll["collective"][cls]["ms_per_step"]
                r["ratio_to_a"] = r["ms_per_step"] / a_ms
                want = {k: LAYERS * WINOPT_HOSTED_STEPS for k in KERNELS}
                if run["counts"] != want:
                    raise RuntimeError(f"window optimizers (c) {cls}: "
                                       f"launches {run['counts']}")
                if cls == "DistributedPushSumOptimizer":
                    r["mass"] = metrics.gauge("pushsum.mass").value
                    r["minted"] = metrics.gauge("pushsum.minted").value
                    r["mass_exact"] = r["mass"] == r["minted"]
                if snap:
                    t0 = time.perf_counter()
                    got = snapshot.fetch_snapshot(cp.client())
                    r["fetch_s"] = time.perf_counter() - t0
                    leaves, ver, wire = got
                    r["snapshot"] = {
                        "version": ver, "fetch_wire_bytes": wire,
                        "publish_s": metrics.gauge("serve.publish_sec").value,
                        "publish_wire_bytes": metrics.counter(
                            "serve.publish_wire_bytes").value - pubs,
                        "shards": snapshot.fetch_meta(cp.client()).shards,
                        "equal": ver == WINOPT_HOSTED_STEPS and all(
                            np.array_equal(a, p.detach().cpu().numpy())
                            for a, p in zip(leaves, model.parameters()))}
                    del leaves
                opt.free()
                del opt, model
                torch.cuda.empty_cache()
            finally:
                os.environ.pop("BFT_SERVE_PUBLISH_EVERY", None)
            log(f"window optimizers (c) ({card}) hosted {cls}, S="
                f"{WINOPT_SHARD} (rows of {r['row_bytes']} bytes): ms/step="
                f"{r['ms_per_step']:.3f} ({r['ratio_to_a']:.3f}x (a)'s "
                f"{a_ms:.3f}); legs ms a step: "
                + ", ".join(f"{k} {v:.2f}" for k, v in r["legs_ms"].items())
                + f"; losses bit for bit {r['losses_equal']}"
                + (f"; mass {r['mass']!r} minted {r['minted']!r}"
                   if "mass" in r else "")
                + f"; launches {r['counts']}")
            if "snapshot" in r:
                sn = r["snapshot"]
                log(f"window optimizers (d) ({card}): snapshot version "
                    f"{sn['version']} in {sn['shards']} shards, publish "
                    f"{sn['publish_s']:.3f} s, {sn['publish_wire_bytes']} "
                    f"wire bytes over {WINOPT_HOSTED_STEPS} publishes, "
                    f"fetch {r['fetch_s']:.3f} s; read back bit for bit "
                    f"{sn['equal']}")
            out["runs"][cls] = r
    finally:
        bf.shutdown()
        for k in list(env) + ["BFT_WIN_SHARD"]:
            os.environ.pop(k, None)
    for cls, r in out["runs"].items():
        if not r["losses_equal"]:
            raise RuntimeError(f"window optimizers (c) {cls}: losses "
                               f"{r['losses']} are not the train phase's")
        if not r.get("mass_exact", True):
            raise RuntimeError(f"window optimizers (c) {cls}: mass "
                               f"{r['mass']!r} != minted {r['minted']!r}")
        if not r.get("snapshot", {}).get("equal", True):
            raise RuntimeError("window optimizers (d): the snapshot is not "
                               "the post-gossip parameters")
    return out


def winopt_examples(bf, torch, card: str) -> dict:
    """17(e): the examples' window kinds at world 1 on the card:
    ``benchmark.py`` with each window optimizer (ResNet-50, batch 64, short
    timing) and an epoch of ``resnet.py --dist-optimizer win_put``."""
    from bluefog_tpu_torch.examples import benchmark, resnet

    out = {}
    for kind in ("win_put", "pull_get", "push_sum"):
        t0 = time.perf_counter()
        rate = benchmark.main(["--dist-optimizer", kind,
                               "--num-warmup-batches", "2",
                               "--num-batches-per-iter", "5",
                               "--num-iters", "2"])
        out[kind] = {"img_per_s": rate, "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    hist, _ = resnet.train(resnet.parse_args(
        ["--epochs", "1", "--steps-per-epoch", "10", "--dist-optimizer",
         "win_put"]))
    out["resnet_win_put"] = {"history": hist, "s": time.perf_counter() - t0}
    log(f"window optimizers (e) ({card}): benchmark.py img/s "
        + ", ".join(f"{k} {v['img_per_s']:.1f}" for k, v in out.items()
                    if k != "resnet_win_put")
        + f"; resnet.py win_put epoch loss {hist[0][0]:.4f}")
    if not all(v["img_per_s"] > 0 for k, v in out.items()
               if k != "resnet_win_put") or not math.isfinite(hist[0][0]):
        raise RuntimeError(f"window optimizers (e): {out}")
    return out


def window_optimizers(bf, fl, torch, card: str, train_run: dict) -> dict:
    """Phase 17, (a)-(e). Raises when it leaves more than 1 MiB allocated
    on the card."""
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    res = winopt_collective(bf, fl, torch, card, train_run)
    res.update(winopt_hosted(bf, fl, torch, card, train_run, res))
    res["examples"] = winopt_examples(bf, torch, card)
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - before
    if left > 2**20:
        raise RuntimeError(f"the window optimizers phase left {left} bytes "
                           f"allocated on the card")
    res["wall_s"] = time.perf_counter() - t0
    log(f"window optimizers ({card}): phase wall {res['wall_s']:.1f} s")
    return res


def serve_k1_check(fl, torch, dev) -> dict:
    """18(0): K1 at the serve batch (B=SERVE_BATCH, H=16, D=128, S=SEQ,
    causal) against its plain version one sequence at a time (the dense
    scores of the whole batch would take ~70 GB); each sequence's rows of
    the batched launch must equal a launch on that sequence alone bit for
    bit. Also K1's ms at this shape beside its bound."""
    B, S, H, D = SERVE_BATCH, SEQ, 16, 128
    gen = torch.Generator(device=dev).manual_seed(18)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    o, m, l = fl.flash_block(q, k, v, 0, 0, causal=True)
    errs = {"o": 0.0, "m": 0.0, "l": 0.0}
    alone = True
    for b in range(B):
        sl = slice(b, b + 1)
        qb, kb, vb = (t[sl].contiguous() for t in (q, k, v))
        po, pm, pl = fl.flash_block_plain(qb, kb, vb, 0, 0, causal=True)
        errs["o"] = max(errs["o"], float(
            ((o[sl] - po) / pl.clamp_min(1.0)[..., None]).abs().max()))
        errs["m"] = max(errs["m"], float((m[sl] - pm).abs().max()))
        errs["l"] = max(errs["l"], float(
            ((l[sl] - pl).abs() / pl.clamp_min(1.0)).max()))
        del po, pm, pl
        one = fl.flash_block(qb, kb, vb, 0, 0, causal=True)
        alone = alone and all(torch.equal(x[sl], y)
                              for x, y in zip((o, m, l), one))
    finite = all(bool(torch.isfinite(t).all()) for t in (o, m, l))
    del o, m, l
    ms = cuda_ms(lambda: fl.flash_block(q, k, v, 0, 0, causal=True), 5)
    bound = kernel_bounds(B, S, H, D)["flash_fwd"]
    log(f"serving (0) K1 at B={B} S={S} H={H} D={D} causal against its "
        f"plain version: " + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
        + f" (limits o {TOL_FWD}, m {TOL_M}, l {TOL_L}); each sequence "
        f"equal to its own launch bit for bit {alone}; ms={ms:.4f} "
        f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']})")
    limits = {"o": TOL_FWD, "m": TOL_M, "l": TOL_L}
    bad = {n: e for n, e in errs.items() if not e <= limits[n]}
    if bad or not alone or not finite:
        raise RuntimeError(f"serving (0): K1 at B={B} disagrees with its "
                           f"plain version: {bad}, alone {alone}, finite "
                           f"{finite}")
    return {"errs": errs, "alone_bit_equal": alone, "ms": ms, **bound}


def _digest(row) -> str:
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(row).tobytes()).hexdigest()


def _serve_forward(torch, skeleton, names):
    """The served function: the LM's last-position f32 logits for a batch
    of token rows, over ``params`` (the snapshot's leaves in the
    publisher's order, bound to ``names``) on ``skeleton``'s structure."""
    from torch.func import functional_call

    def forward(params, xs):
        return functional_call(skeleton, dict(zip(names, params)),
                               (xs,))[:, -1]
    return forward


def _padded(torch, forward, rows: int):
    """``forward`` on a batch padded with zero rows to ``rows``: one served
    shape, so a row's answer is the same bits in any batch."""
    def model_fn(params, xs):
        n = xs.shape[0]
        if n < rows:
            xs = torch.cat([xs, xs.new_zeros((rows - n,) + tuple(
                xs.shape[1:]))])
        return forward(params, xs)[:n]
    return model_fn


class _Load:
    """SERVE_SUBMITTERS threads that keep requests in flight (each waits
    for its answer, then submits the next, a pool sequence drawn from its
    own seeded generator) until stopped: latencies, and the digest of every
    answer by its pool index."""

    def __init__(self, sc, pool) -> None:
        import threading

        self.sc, self.pool = sc, pool
        self.stop = threading.Event()
        self.mu = threading.Lock()
        self.lat, self.seen, self.errors = [], {}, []
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True)
                        for i in range(SERVE_SUBMITTERS)]
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()

    def _run(self, i: int) -> None:
        rng = np.random.default_rng(100 + i)
        while not self.stop.is_set():
            j = int(rng.integers(len(self.pool)))
            t0 = time.perf_counter()
            try:
                y = self.sc.infer(self.pool[j], timeout=SERVE_WAIT_S)
            except Exception as e:  # noqa: BLE001 — reported by finish()
                with self.mu:
                    self.errors.append(repr(e))
                return
            dt = time.perf_counter() - t0
            key = (j, _digest(y))
            with self.mu:
                self.lat.append(dt)
                self.seen[key] = self.seen.get(key, 0) + 1

    def finish(self, label: str) -> dict:
        self.stop.set()
        for t in self.threads:
            t.join(SERVE_WAIT_S)
        wall = time.perf_counter() - self.t0
        if self.errors or any(t.is_alive() for t in self.threads):
            raise RuntimeError(f"serving {label}: a submitter failed: "
                               f"{self.errors}")
        lat = sorted(self.lat)
        n = len(lat)
        if not n:
            raise RuntimeError(f"serving {label}: no request completed")
        return {"requests": n, "wall_s": wall, "req_per_s": n / wall,
                "p50_ms": lat[n // 2] * 1e3,
                "p99_ms": lat[min(n - 1, int(0.99 * n))] * 1e3,
                "max_ms": lat[-1] * 1e3, "seen": self.seen}


def _served_batch(fl, torch, sc, reqs) -> tuple:
    """Submit ``reqs`` at once; their answers and the launch counts of the
    batches that served them (set to 0 just before, read just after)."""
    b0 = sc.stats()["batches"]
    fl.reset_launch_counts()
    futs = [sc.submit(r) for r in reqs]
    answers = [f.result(SERVE_WAIT_S) for f in futs]
    counts = dict(fl.launch_counts)
    return answers, counts, sc.stats()["batches"] - b0


def _refs(torch, forward, versions: dict, pool, dev) -> dict:
    """{version: {(pool index, digest)}}: each saved version's answer to
    every pool sequence, SERVE_BATCH sequences a forward."""
    out = {}
    with torch.inference_mode():
        for v, params in versions.items():
            out[v] = set()
            for i in range(0, len(pool), SERVE_BATCH):
                xs = torch.from_numpy(pool[i:i + SERVE_BATCH]).to(dev)
                ys = forward(params, xs).cpu().numpy()
                out[v].update((i + j, _digest(y)) for j, y in enumerate(ys))
    return out


def _plant_swap(torch, sc, fault: str, dev) -> tuple:
    """A faulty swap for ``sc``: ``publish_before_copy`` returns fresh
    tensors whose copy is queued on a side stream behind a 2 s device spin
    (they read as NaN until it lands) without waiting for it;
    ``corrupt_leaf_slice`` copies correctly, then adds 1.0 to a slice of
    the first block's first leaf. Returns the faulty ``_to_device`` and a
    list that receives the side stream to wait on after the check."""
    real = sc._to_device
    streams = []
    if fault == "corrupt_leaf_slice":
        def to_device(leaves):
            out = real(leaves)
            out[1].view(-1)[:64] += 1.0
            return out
        return to_device, streams

    def to_device(leaves):
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                for a in leaves]
        out = [torch.full(tuple(a.shape), float("nan"), device=dev)
               for a in leaves]
        torch.cuda.current_stream().synchronize()
        side, _ = _device_sleep(torch, 2.0)
        with torch.cuda.stream(side):
            for t, h in zip(out, host):
                t.copy_(h, non_blocking=True)
        streams.append(side)
        return out          # no wait: the copy is still queued
    return to_device, streams


def _serve_cli(tmp: str, port: int, device: str) -> dict:
    """18(d) and (e): the four attach modes as subprocesses against the
    job's control plane, and the example with a control plane of its own,
    all at once, each under SERVE_CLI_TIMEOUT; ``--serve`` and the example
    on ``device``."""
    cp = f"127.0.0.1:{port}"
    mod = [sys.executable, "-m", "bluefog_tpu_torch.launcher"]
    cmds = {
        "serve": mod + ["--serve", "--once", "--device", device, "--cp",
                        cp, "--serve-timeout", "120"],
        "status": mod + ["--status", "--cp", cp],
        "top": mod + ["--top", "--once", "--cp", cp],
        "dump": mod + ["--dump", "--cp", cp, "--out",
                       os.path.join(tmp, "dump"), "--dump-timeout", "60"],
        "example": [sys.executable, "-m",
                    "bluefog_tpu_torch.examples.serving", "--device",
                    device],
    }
    base = dict(os.environ, PYTHONPATH=HERE)
    own = {k: v for k, v in base.items()
           if not k.startswith(("BFT_CP_", "BFT_SERVE_", "BFT_SLO",
                                "BFT_TRACE_"))}
    procs = {name: subprocess.Popen(
        cmd, cwd=HERE, env=own if name == "example" else base,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, cmd in cmds.items()}
    out = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=SERVE_CLI_TIMEOUT)
            out[name] = {"rc": p.returncode, "stdout": so, "stderr": se}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _check_cli(out: dict, tmp: str, card: str) -> dict:
    def fail(name, why):
        r = out[name]
        raise RuntimeError(f"serving (d/e) {name}: {why}; rc {r['rc']}\n"
                           f"{r['stdout'][-2000:]}\n{r['stderr'][-2000:]}")

    for name, r in out.items():
        if r["rc"] != 0:
            fail(name, "exited non-zero")
    swap = [ln for ln in out["serve"]["stdout"].splitlines()
            if ln.startswith("bfrun --serve: snapshot v")]
    if not swap:
        fail("serve", "no swap line")
    clients = re.search(r"serve clients: (\d+)/(\d+) heartbeating",
                        out["status"]["stdout"])
    if "serving plane" not in out["status"]["stdout"] or not clients \
            or int(clients.group(1)) < 1:
        fail("status", "no serving-plane lines with a live client")
    if "rank(s)" not in out["top"]["stdout"]:
        fail("top", "no frame")
    path = os.path.join(tmp, "dump", "flight_0.json")
    if not os.path.exists(path):
        fail("dump", "no flight_0.json")
    with open(path) as f:
        doc = json.load(f)
    n_events = len(doc["events"]["kind"])
    if not n_events:
        fail("dump", "an empty tail")
    if "SERVING OK" not in out["example"]["stdout"]:
        fail("example", "no SERVING OK")
    res = {"swap_line": swap[0], "clients": clients.group(0),
           "dump_events": n_events,
           "top_lines": len(out["top"]["stdout"].splitlines())}
    log(f"serving (d) ({card}): --serve --once: {swap[0]!r}; --status: "
        f"{res['clients']}; --top --once: {res['top_lines']} lines; "
        f"--dump: {n_events} events in flight_0.json")
    log("serving (e): examples/serving.py on the card: "
        + " | ".join(ln for ln in out["example"]["stdout"].splitlines()
                     if ln.startswith(("step", "SERVING"))))
    return res


def serve_admission(torch, card: str) -> dict:
    """18(b): BFT_SERVE_QUEUE_MAX=2 (soft 1, batches of 1) and a model that
    waits on an event, on a control plane of its own with a small
    snapshot: of 8 submissions one parks in the model, two fill the queue
    and the rest must shed with gate ``queue_full``; ``stats()['shed']``
    equals the shed count, and the admitted ones answer once released."""
    import threading

    from bluefog_tpu_torch.runtime import native
    from bluefog_tpu_torch.serving import (RequestShed, ServeClient,
                                           SnapshotPublisher)

    knobs = {"BFT_SERVE_QUEUE_MAX": "2", "BFT_SERVE_QUEUE_SOFT": "1",
             "BFT_SERVE_BATCH": "1", "BFT_SERVE_POLL_S": "0.05"}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    release = threading.Event()

    def slow(params, xs):
        release.wait(30)
        return xs

    try:
        with native.ControlPlaneServer(world=1) as srv:
            pcl = native.ControlPlaneClient("127.0.0.1", srv.port, 0)
            SnapshotPublisher(pcl, shards=1).publish(
                [np.zeros(10, np.float32)], 1)
            sc = ServeClient([("127.0.0.1", srv.port)], slow)
            try:
                if not sc.wait_ready(30):
                    raise RuntimeError("serving (b): no snapshot")
                futs, gates = [], []
                for i in range(8):
                    try:
                        futs.append((i, sc.submit(np.full(2, i, np.float32))))
                    except RequestShed as exc:
                        gates.append(exc.gate)
                    time.sleep(0.02)
                shed_stat = sc.stats()["shed"]
                release.set()
                answered = all(np.array_equal(f.result(30),
                                              np.full(2, i, np.float32))
                               for i, f in futs)
            finally:
                release.set()
                sc.close()
            pcl.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    res = {"shed": len(gates), "gates": sorted(set(gates)),
           "stats_shed": shed_stat, "admitted": len(futs),
           "answered": answered}
    log(f"serving (b) ({card}): 8 submissions at queue max 2: "
        f"{res['admitted']} admitted, {res['shed']} shed (gates "
        f"{res['gates']}), stats()['shed'] {shed_stat}, admitted answered "
        f"{answered}")
    if not gates or set(gates) != {"queue_full"} or shed_stat != len(gates) \
            or not answered:
        raise RuntimeError(f"serving (b): admission {res}")
    return res


def serving(bf, fl, torch, card: str, winput_ms=None) -> dict:
    """Phase 18, (0) and (a)-(e): see the module's docstring. Raises on
    any failed check; ``winput_ms`` is phase 17(a)'s win-put ms/step."""
    from bluefog_tpu_torch.runtime import control_plane as cp
    from bluefog_tpu_torch.runtime import flight, metrics
    from bluefog_tpu_torch.serving import snapshot

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {"k1": serve_k1_check(fl, torch, dev)}
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="bf_serve_")
    port = _free_port()
    env = {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(port),
           "BFT_SERVE_PUBLISH_EVERY": "1",
           "BFT_SERVE_SHARDS": str(SERVE_SHARDS),
           "BFT_SERVE_BATCH": str(SERVE_BATCH),
           "BFT_SERVE_POLL_S": str(SERVE_POLL_S),
           "BFT_TRACE_SERVE": "1", "BFT_SLO": SERVE_SLO,
           "BFT_FLIGHT_CAPACITY": "65536", "BFT_FLIGHT_DIR": tmp,
           "BFT_METRICS_INTERVAL": "1"}
    os.environ.update(env)
    torch.cuda.reset_peak_memory_stats()
    sc = None
    try:
        bf.init()
        model = headline_model(bf, torch, dev, fl.flash_attention)
        opt = bf.DistributedWinPutOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3), model,
            bf.models.lm_loss)
        batch = headline_batch(torch, dev)
        names = [n for n, _ in model.named_parameters()]
        skeleton = headline_model(bf, torch, dev, fl.flash_attention)
        skeleton.to_empty(device="meta")
        forward = _serve_forward(torch, skeleton, names)
        ref_forward = _serve_forward(torch, model, names)
        pool = np.random.default_rng(18).integers(
            0, 32768, (SERVE_POOL, SEQ)).astype(np.int64)

        sc = bf.serve_client(_padded(torch, forward, SERVE_BATCH),
                             start=False)
        h2d_ms, swaps, last = [], [], {}
        to_device, install = sc._to_device, sc._install

        def timed_to_device(leaves):
            last["leaves"] = leaves
            t0 = time.perf_counter()
            out = to_device(leaves)
            h2d_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def logged_install(leaves, ver, wire, dt):
            done = install(leaves, ver, wire, dt)
            if done:
                swaps.append({"version": ver, "wire_bytes": wire,
                              "pull_s": dt, "mb_per_s": wire / dt / 1e6,
                              "h2d_ms": h2d_ms[-1]})
            return done

        sc._to_device, sc._install = timed_to_device, logged_install
        sc.start()

        def step(label: str) -> float:
            pubs = metrics.counter("serve.publishes").value
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(opt.step(batch)["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if metrics.counter("serve.publishes").value != pubs + 1:
                raise RuntimeError(f"serving {label}: the step did not "
                                   "publish a snapshot (serve.publishes "
                                   f"stayed at {pubs})")
            if not math.isfinite(loss):
                raise RuntimeError(f"serving {label}: loss {loss}")
            return dt

        # (a) lockstep: each step's version served, bit for bit
        lock, serve_counts, saved = [], {k: 0 for k in KERNELS}, {}
        for i in range(SERVE_STEPS):
            dt = step("(a) lockstep")
            ver = snapshot.current_version(cp.client())
            deadline = time.monotonic() + SERVE_WAIT_S
            while sc.refresh() < ver:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"serving (a): version {ver} never "
                                       "served")
                time.sleep(0.05)
            reqs = [pool[(SERVE_BATCH * i + j) % SERVE_POOL]
                    for j in range(SERVE_BATCH)]
            answers, counts, nb = _served_batch(fl, torch, sc, reqs)
            for k in KERNELS:
                serve_counts[k] += counts[k]
            with torch.inference_mode():
                direct = model(torch.from_numpy(np.stack(reqs)).to(dev))[
                    :, -1].cpu().numpy()
            equal = all(np.array_equal(a, d) for a, d in zip(answers, direct))
            lock.append({"version": ver, "ms_per_step": dt * 1e3,
                         "batches": nb, "counts": counts, "equal": equal,
                         "finite": bool(np.isfinite(direct).all())})
            log(f"serving (a) lockstep ({card}): step {i + 1} "
                f"{dt * 1e3:.1f} ms with its publish, version {ver} served;"
                f" {len(reqs)} answers equal the direct forward bit for bit "
                f"{equal}; {nb} batch(es), launches {counts}")
            want = {"flash_fwd": LAYERS * nb, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}
            if not equal or counts != want or not lock[-1]["finite"]:
                raise RuntimeError(f"serving (a): lockstep {lock[-1]}, "
                                   f"launches expected {want}")
        saved[ver] = [p.detach().clone() for p in model.parameters()]

        # (a) under load: idle first, then while the trainer trains
        idle = _Load(sc, pool)
        time.sleep(SERVE_IDLE_S)
        idle_r = idle.finish("(a) idle")
        load = _Load(sc, pool)
        load_ms = []
        for _ in range(SERVE_LOAD_STEPS):
            load_ms.append(step("(a) under load") * 1e3)
            saved[snapshot.current_version(cp.client())] = [
                p.detach().clone() for p in model.parameters()]
        time.sleep(2 * SERVE_POLL_S)
        deadline = time.monotonic() + SERVE_WAIT_S
        while sc.version() < max(saved) and time.monotonic() < deadline:
            time.sleep(0.05)            # the last version answers too
        time.sleep(0.5)
        load_r = load.finish("(a) under load")
        per_ver = _refs(torch, ref_forward, saved, pool, dev)
        refs = set().union(*per_ver.values())
        by_ver = {v: sum(c for key, c in load_r["seen"].items()
                         if key in one) for v, one in per_ver.items()}
        torn = {k: c for r in (idle_r, load_r) for k, c in r["seen"].items()
                if k not in refs}
        lock_ms = [x["ms_per_step"] for x in lock]
        for label, r in (("idle", idle_r), ("while training", load_r)):
            log(f"serving (a) {label} ({card}): {r['requests']} requests "
                f"in {r['wall_s']:.2f} s, {r['req_per_s']:.2f} req/s, "
                f"latency p50 {r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} "
                f"ms max {r['max_ms']:.2f} ms")
        log(f"serving (a) under load: answers by version {by_ver}; "
            f"answers matching no saved version {sum(torn.values())}")
        if torn:
            raise RuntimeError(f"serving (a): {sum(torn.values())} torn "
                               "answers under load")
        res["lockstep"] = lock
        res["idle"] = {k: v for k, v in idle_r.items() if k != "seen"}
        res["load"] = {k: v for k, v in load_r.items() if k != "seen"}
        res["load"]["by_version"] = {str(k): v for k, v in by_ver.items()}
        res["trainer"] = {"lockstep_ms": lock_ms, "load_ms": load_ms,
                          "winput_17a_ms": winput_ms}
        log(f"serving (a) trainer ({card}): ms/step with a publish "
            f"{' '.join(f'{x:.1f}' for x in lock_ms)}, with a publish and "
            f"the client serving {' '.join(f'{x:.1f}' for x in load_ms)}"
            + (f"; phase 17(a) win-put {winput_ms:.3f} ms/step "
               f"(ratio {np.median(load_ms) / winput_ms:.2f})"
               if winput_ms else ""))

        # decode ms of the served function at batch 1 and SERVE_BATCH
        params = sc.params()
        dec = {}
        with torch.inference_mode():
            for b in (1, SERVE_BATCH):
                xs = torch.from_numpy(pool[:b]).to(dev)
                dec[b] = cuda_ms(lambda: forward(params, xs), 3)
        res["decode_ms"] = dec
        res["swaps"] = swaps
        log(f"serving (a) swaps ({card}): " + "; ".join(
            f"v{s['version']} {s['wire_bytes']} wire bytes pulled in "
            f"{s['pull_s']:.3f} s ({s['mb_per_s']:.1f} MB/s), H2D "
            f"{s['h2d_ms']:.1f} ms" for s in swaps))
        log(f"serving (a) decode ({card}): " + ", ".join(
            f"batch {b} {ms:.3f} ms" for b, ms in dec.items())
            + f" (CUDA events; served batches are padded to {SERVE_BATCH})")
        del params

        # (c) tracing and SLOs over the ring
        time.sleep(3 * SERVE_POLL_S)     # a poll tick sets the gauges
        rep = flight.serve_report()
        n_req = sc.stats()["requests"]
        covs = sorted(t["coverage"] for t in rep["traces"]) if rep else [0]
        med = covs[len(covs) // 2]
        p50 = metrics.gauge("slo.request_p50_us").value
        p99 = metrics.gauge("slo.request_p99_us").value
        largest = max(rep["phases"], key=lambda p: rep["phases"][p][
            "p50_us"]) if rep else None
        lin = snapshot.read_lineage(cp.client(), sc.version())
        res["trace"] = {"requests": rep["requests"] if rep else 0,
                        "submitted": n_req, "median_coverage": med,
                        "p50_us": p50, "p99_us": p99, "largest": largest,
                        "lineage": lin}
        log(f"serving (c) ({card}): serve_report over the ring:\n"
            + (flight.format_serve_report(rep) if rep else "(none)")
            + f"\n  {n_req} requests submitted; median phase coverage "
            f"{med:.4f}; gauges slo.request_p50_us {p50:.0f} "
            f"slo.request_p99_us {p99:.0f}; largest phase {largest}; "
            f"lineage of v{sc.version()} {lin}")
        if not rep or not 0.99 * n_req <= rep["requests"] <= n_req \
                or not 0.9 <= med <= 1.1 or not p50 > 0 or not p99 >= p50 \
                or largest != "decode" or not lin \
                or lin["step"] != sc.version():
            raise RuntimeError(f"serving (c): {res['trace']}")

        # (d) the attach modes and (e) the example, as subprocesses
        res["cli"] = _check_cli(_serve_cli(tmp, port, dev.type), tmp, card)

        # the planted faults: each faulty swap must show as torn answers
        res["faults"] = {}
        reqs = [pool[j] for j in range(SERVE_BATCH)]
        for fault in SERVE_FAULTS:
            bad, side = _plant_swap(torch, sc, fault, dev)
            sc._to_device = bad
            sc._install(last["leaves"], sc.version() + 1, 0, 1.0)
            answers, _, _ = _served_batch(fl, torch, sc, reqs)
            caught = sum((j, _digest(a)) not in refs
                         for j, a in enumerate(answers))
            for st in side:
                st.synchronize()
            sc._to_device = timed_to_device
            res["faults"][fault] = caught
            log(f"serving planted {fault}: {caught}/{len(answers)} answers "
                "match no version (must be > 0)")
            if not caught:
                raise RuntimeError(f"serving: the planted {fault} was not "
                                   "caught")
        sc.close()
        sc = None
        opt.free()
        del saved, model, opt, skeleton
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        if sc is not None:
            sc.close()
        bf.shutdown()
        for k in env:
            os.environ.pop(k, None)
    torch.cuda.empty_cache()
    res["admission"] = serve_admission(torch, card)
    res["serve_counts"] = serve_counts
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"serving ({card}): peak_mem_GiB {res['peak_bytes'] / 2**30:.3f}; "
        f"serve LM launches {serve_counts}; phase wall "
        f"{res['wall_s']:.1f} s")
    return res


def _launch_helper_imports() -> tuple:
    """The modules the launch helper runs: ``torch.distributed``, the
    package, its torch frontend and the flash kernels' module."""
    sys.path.insert(0, HERE)
    import torch.distributed as dist

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import torch_frontend as bft
    from bluefog_tpu_torch.parallel import flash as fl

    return dist, bf, bft, fl


def _launch_helper_main() -> int:
    """The helper's body: the one rank of ``bfrun -H localhost:1``. It
    checks the environment the launcher gave it, joins through ``env://``
    over NCCL on ``cuda:0`` and trains the headline LM from a user's loop
    (``zero_grad``, ``lm_loss``, ``backward``, ``step``) under
    ``DistributedTorchOptimizer`` around Adam, phase 4's seed and batch,
    WARMUP untimed and STEPS timed steps with the launch counts set to 0
    just before and read just after. Prints a ``LAUNCH_STAGE`` line as
    each leg ends (the parent stamps their arrival) and one
    ``LAUNCH_RESULT`` JSON line."""
    def stage(name: str) -> None:
        print(LAUNCH_STAGE + name, flush=True)

    stage("started")
    import torch

    want = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
            "LOCAL_WORLD_SIZE": "1", "BFT_LOG_LEVEL": "debug"}
    got = {k: os.environ.get(k) for k in want}
    if got != want:
        raise RuntimeError(f"launch helper: environment {got}, not {want}")
    for k in ("MASTER_ADDR", "MASTER_PORT", "BFT_TIMELINE", "BFT_CP_SECRET"):
        if not os.environ.get(k):
            raise RuntimeError(f"launch helper: {k} did not reach it")
    dist, bf, bft, fl = _launch_helper_imports()
    stage("imported")
    bf.init()
    stage("initialized")
    dev = bf.runtime.state._global_state().device
    if (str(dev), dist.get_backend(), bf.size()) != ("cuda:0", "nccl", 1):
        raise RuntimeError(f"launch helper: joined {dev} over "
                           f"{dist.get_backend()} at world {bf.size()}")
    model = headline_model(bf, torch, dev, fl.flash_attention)
    opt = bft.DistributedTorchOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), model)
    batch = headline_batch(torch, dev)
    torch.cuda.synchronize()
    stage("model built")

    def step():
        opt.zero_grad()
        loss = bf.models.lm_loss(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fl.reset_launch_counts()
    losses = [step() for _ in range(WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / STEPS
    counts = dict(fl.launch_counts)
    out = {"losses": [float(x) for x in losses], "ms_per_step": dt * 1e3,
           "counts": counts,
           "per_step": {k: c / (WARMUP + STEPS) for k, c in counts.items()},
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "world": bf.size(), "device": str(dev),
           "backend": dist.get_backend()}
    stage("trained")
    bf.shutdown()
    print(LAUNCH_RESULT + json.dumps(out), flush=True)
    return 0


def _launch_env() -> dict:
    """This process's environment for a launcher subprocess: the package
    beside this file importable, no launcher or port variables of its
    own."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BFT_") and k not in (
               "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _timed_run(cmd: list, timeout: float) -> tuple:
    """Run ``cmd`` (a launcher) from this file's directory, stamping each
    line of its output with the seconds since the start as it arrives;
    returns ``(rc, [(s, stdout line)], [(s, stderr line)], wall s)``.
    After ``timeout`` the launcher gets SIGTERM (it interrupts its ranks),
    then SIGKILL, and this raises."""
    import threading

    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=HERE, env=_launch_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    out, err = [], []

    def pump(stream, into):
        for ln in stream:
            into.append((time.perf_counter() - t0, ln.rstrip("\n")))

    readers = [threading.Thread(target=pump, args=(p.stdout, out)),
               threading.Thread(target=pump, args=(p.stderr, err))]
    for t in readers:
        t.start()
    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.terminate()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        raise RuntimeError(f"launch: {cmd} ran past {timeout} s")
    finally:
        for t in readers:
            t.join()
    return rc, out, err, time.perf_counter() - t0


def _text(lines: list) -> str:
    return "\n".join(ln for _, ln in lines)[-4000:]


def launch_lm(torch, card: str, train_run: dict, tmp: str) -> dict:
    """19(a): the user-loop LM through ``python -m
    bluefog_tpu_torch.launcher -H localhost:1 --timeline-filename
    --verbose``: the child's exit code, its losses against phase 4's bit
    for bit (at world 1 the combine multiplies by 1.0 in f32), LAYERS
    launches of each kernel a step, the timeline's STEP and
    NEIGHBOR_ALLREDUCE spans, the debug log lines."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    prefix = os.path.join(tmp, "tl_")
    rc, out, err, wall = _timed_run(
        [sys.executable, "-m", "bluefog_tpu_torch.launcher", "-H",
         "localhost:1", "--timeline-filename", prefix, "--verbose", "--",
         sys.executable, os.path.join(HERE, "chip_smoke.py"), LAUNCH_ARG],
        LAUNCH_TIMEOUT)
    if rc != 0:
        raise RuntimeError(f"launch: the launched LM exited with {rc}:\n"
                           f"{_text(out)}\n{_text(err)}")
    lines = [ln for _, ln in out if ln.startswith(LAUNCH_RESULT)]
    if len(lines) != 1:
        raise RuntimeError(f"launch: {len(lines)} result lines:\n"
                           f"{_text(out)}")
    r = json.loads(lines[0][len(LAUNCH_RESULT):])
    # the seconds since the launcher started at which each leg ended
    legs = {ln[len(LAUNCH_STAGE):]: t for t, ln in out
            if ln.startswith(LAUNCH_STAGE)}
    legs["shut down"] = next(t for t, ln in out
                             if ln.startswith(LAUNCH_RESULT))
    legs["exited"] = wall
    if r["losses"] != train_run["losses"]:
        raise RuntimeError(f"launch: user-loop losses {r['losses']} differ "
                           f"from phase 4's {train_run['losses']}")
    bad = {k: v for k, v in r["per_step"].items() if v != LAYERS}
    if bad or set(r["per_step"]) != set(KERNELS):
        raise RuntimeError(f"launch: launches a step {r['per_step']}, "
                           f"expected {LAYERS} of each kernel")
    with open(f"{prefix}0.json") as f:
        events = json.load(f)
    name = "DistributedTorchOptimizer"
    steps = _step_spans(events, name)
    mixes = [e for e in events if e.get("ph") == "B" and
             e.get("cat") == name and e.get("name") == "NEIGHBOR_ALLREDUCE"]
    inside = sum(any(b <= e["ts"] <= end for b, end in steps) for e in mixes)
    total = WARMUP + STEPS
    if (len(steps), len(mixes), inside) != (total, total, total):
        raise RuntimeError(f"launch: timeline holds {len(steps)} STEP and "
                           f"{len(mixes)} NEIGHBOR_ALLREDUCE spans "
                           f"({inside} inside a STEP), expected {total}")
    debug = [ln for _, ln in err if "[DEBUG]" in ln]
    joined = [ln for ln in debug if "joined through env://" in ln]
    init = [ln for _, ln in err
            if "initialized: rank 0 of 1 on cuda:0 (nccl)" in ln]
    if not joined or not init:
        raise RuntimeError(f"launch: debug log lines missing:\n{_text(err)}")
    log(f"launch (a) user-loop LM via bfrun -H localhost:1 ({card}): "
        f"rc 0, wall {wall:.1f} s, world {r['world']} on {r['device']} "
        f"({r['backend']}), ms/step {r['ms_per_step']:.3f} against "
        f"train's {train_run['ms_per_step']:.3f} "
        f"({r['ms_per_step'] / train_run['ms_per_step']:.4f}x), "
        f"peak_mem_GiB {r['peak_bytes'] / 2**30:.3f}")
    log("launch (a) losses (equal to train's bit for bit): "
        + " ".join(f"{x:.5f}" for x in r["losses"]))
    log(f"launch (a) launches: {r['counts']}; timeline {len(events)} "
        f"events, {len(steps)} STEP, {len(mixes)} NEIGHBOR_ALLREDUCE; "
        f"{len(debug)} debug lines: {joined[0].strip()}")
    log("launch (a) legs, s since the launcher started: " + ", ".join(
        f"{name} {t:.1f}" for name, t in legs.items()))
    return {**r, "wall_s": wall, "legs_s": legs,
            "timeline_events": len(events), "debug_lines": len(debug)}


def launch_simulate(card: str) -> dict:
    """19(b): ``--simulate LAUNCH_SIM`` runs the torch frontend's consensus
    example as LAUNCH_SIM processes on the CPU over gloo beside the card:
    every rank prints device cpu, rank 0 ``TORCH CONSENSUS OK``."""
    rc, out, err, wall = _timed_run(
        [sys.executable, "-m", "bluefog_tpu_torch.launcher", "--simulate",
         str(LAUNCH_SIM), "--", sys.executable, "-m",
         "bluefog_tpu_torch.examples.torch_average_consensus"],
        LAUNCH_SIM_TIMEOUT)
    ranks = sorted(ln for _, ln in out if ln.startswith("rank "))
    want = [f"rank {r} of {LAUNCH_SIM} on device cpu"
            for r in range(LAUNCH_SIM)]
    done = [t for t, ln in out if ln == "TORCH CONSENSUS OK"]
    if rc != 0 or ranks != want or not done:
        raise RuntimeError(f"launch: --simulate {LAUNCH_SIM} exited with "
                           f"{rc}, ranks {ranks}:\n{_text(out)}\n"
                           f"{_text(err)}")
    dev_line = [ln for _, ln in out if ln.startswith("max deviation")]
    # the seconds since the launcher started: every rank initialized, the
    # rounds done, every process gone
    legs = {"initialized": max(t for t, ln in out if ln.startswith("rank ")),
            "consensus": done[0], "exited": wall}
    log(f"launch (b) --simulate {LAUNCH_SIM} beside the card ({card}): "
        f"rc 0, wall {wall:.1f} s, {'; '.join(ranks)}; "
        f"{dev_line[0] if dev_line else ''}; TORCH CONSENSUS OK")
    log("launch (b) legs, s since the launcher started: " + ", ".join(
        f"{name} {t:.1f}" for name, t in legs.items()))
    return {"wall_s": wall, "legs_s": legs, "ranks": ranks}


def launch(torch, card: str, train_run: dict) -> dict:
    """Phase 19: the port's launcher on the card's machine."""
    import shutil

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="bft_launch_")
    try:
        out = {"lm": launch_lm(torch, card, train_run, tmp),
               "simulate": launch_simulate(card)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    log(f"launch: phase wall {out['wall_s']:.1f} s")
    return out


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
    # the start-up's legs, each timed: a slow start shows which one it was
    marks = [("", T_IMPORTED)]
    import torch

    marks.append(("torch import", time.perf_counter()))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    marks.append(("CUDA check", time.perf_counter()))
    sys.path.insert(0, HERE)
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.parallel import _build
    from bluefog_tpu_torch.parallel import flash as fl

    marks.append(("package import", time.perf_counter()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    marks.append(("nvidia-smi", time.perf_counter()))
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log("start-up after the script's imports (s): " + ", ".join(
        f"{name} {t - marks[i - 1][1]:.1f}"
        for i, (name, t) in enumerate(marks) if i))

    t_start = t0 = time.perf_counter()
    # the control plane's library (phase 14) builds with g++ beside nvcc
    import threading

    from bluefog_tpu_torch.runtime import native
    native_build = threading.Thread(target=native.build, daemon=True)
    native_build.start()
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
    torch.cuda.empty_cache()
    native_build.join()
    wire_run = wire(bf, fl, torch, card, obs)
    torch.cuda.empty_cache()
    live = liveness(bf, fl, torch, card, obs, wire_run)
    torch.cuda.empty_cache()
    win = windows(bf, torch, card)
    torch.cuda.empty_cache()
    winopt = window_optimizers(bf, fl, torch, card, run)
    torch.cuda.empty_cache()
    serve = serving(bf, fl, torch, card, winopt["collective"][
        "DistributedWinPutOptimizer"]["ms_per_step"])
    torch.cuda.empty_cache()
    launched = launch(torch, card, run)

    short = {"DistributedWinPutOptimizer": "win-put",
             "DistributedPullGetOptimizer": "pull-get",
             "DistributedPushSumOptimizer": "push-sum"}
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
                "observability LM": obs["counts"][name],
                "wire LM": wire_run["counts"][name],
                "liveness LM": live["counts"][name],
                **{f"{short[c]} LM": r["counts"][name]
                   for c, r in winopt["collective"].items()},
                **{f"{short[c]} LM, S={WINOPT_SHARD}": r["counts"][name]
                   for c, r in winopt["sharded"].items()},
                **{f"hosted {short[c]} LM, S={WINOPT_SHARD}":
                   r["counts"][name] for c, r in winopt["runs"].items()},
                "serve LM": serve["serve_counts"][name],
                "user-loop LM via bfrun": launched["lm"]["counts"][name]},
        })
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": card, "kernels": kernels, "train": run,
                   "context": ctx, "optimizers": opts, "ce": ce,
                   "lm_bench": lm_bench_runs,
                   "moe": moe, "experts": experts, "parallel": par,
                   "vision": vision, "observability": obs,
                   "wire": wire_run, "liveness": live, "windows": win,
                   "window_optimizers": winopt, "serving": serve,
                   "launch": launched},
                  f, indent=1)
    log(f"wall: {time.perf_counter() - t_start:.1f} s after the card check")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [HELPER_ARG]:
        sys.exit(_helper_main())
    if sys.argv[1:] == [LAUNCH_ARG]:
        sys.exit(_launch_helper_main())
    sys.exit(main())
