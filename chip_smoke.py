#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it, phase by phase.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result line):

  0. setup — the card's name and power limit, torch/CUDA versions, and the
     build of every kernel under ``src/repro_torch/csrc`` (gemm,
     paged_attention, flash_attention: one ``nvcc`` per source, all
     started together); ``cuobjdump -sass`` must find the tensor cores'
     instructions in the built libraries: ``HGMMA`` (wgmma) in the GEMM's,
     ``HMMA`` (mma.sync) in flash attention's;
  1. kernels vs their plain PyTorch versions at the main paths' shapes (and
     at phases 11-15's: mamba2-1.3b's and zamba2-2.7b's decode GEMMs,
     whisper-small's 51,865-wide tied head, the forwards' GEMMs of phases
     13-15, flash attention at head dim 80 and non-causal over 1,500 keys)
     (bf16; tolerances below; flash attention's rows also in L2), the lean
     GEMM bitwise equal to the pipelined one at equal blocks (at every GEMM
     shape), each timed with CUDA events beside its plain version, its
     bound and the library call (``torch.matmul`` for the GEMMs,
     ``scaled_dot_product_attention`` for flash attention); at the
     forward's GEMM shapes also the one-stage kernel at its own block (what
     the ring buys), and at the decode shapes the host's microseconds a
     GEMM call beside ``torch.matmul``'s; ``paged_attention_cuda`` at the
     paged engine's shape and at serving's cache lengths (12 rows: 4,096
     tokens full and ragged, 32,768 full, minitron-4b's and qwen2.5-32b's
     head groups at 4,096 in pages of 16), each also held in L2 row by row,
     bitwise equal to itself on a second call, and timed on the device
     with ``torch.profiler`` beside the CUDA events, with the share of its
     bytes bound and its number of splits; the training attention
     (``phase1_flash_training``: the log-sum-exp forward and the two
     backward kernels) against its plain versions at the train cell's
     layer (4 x 2,048), zamba2's head dim 80 and whisper's non-causal
     encoder and cross-attention, row by row, bitwise twice, timed at the
     first beside ``scaled_dot_product_attention``'s forward and
     backward; the SSD scan kernels (``phase1_ssd``: three forward and six
     backward launches) at the Mamba2 cell's layer and zamba2's d_state
     64 against their plain versions and ``_ssd_chunked`` with its autograd
     (``SSD_FP32_TOL``, ``SSD_BF16_TOL``), bitwise twice, timed beside
     ``_ssd_chunked`` and the bound; last, the GEMM autograd
     Function (``ops.GemmFn``) at the training shapes of phase 16 (M = 8 x
     512; ``gemm_backward_check``), with a unit-scale dC: its output, dA and dB through
     ``gemm_cuda`` at the big class's blocks and ``gemm_cuda_lean`` at the
     little class's against the same Function on their plain versions,
     and ``gemm_cuda``'s against ``torch.matmul`` autograd, element by
     element and row by row in L2 (``GEMM_ROW_TOL``); each backward
     product on each kernel with one K-tile of its reduction planted as
     dropped must fail that check; ``gemm_cuda_lean`` bitwise equal to ``gemm_cuda`` at equal
     blocks, the two backward products of each kernel timed beside
     ``torch.matmul`` and their bound, and the transposed copies timed
     apart;
  2. the dense serving engine on the full-width 24-layer internlm2-1.8b
     (random weights from a fixed seed), through ``repro_torch.launch.serve``:
     every GEMM of the decode recurrence must launch ``gemm_cuda``;
  3. the paged engine on the same requests: 24 ``paged_attention_cuda``
     launches per step, first-step logits within tolerance of phase 2;
  4. the one-shot path under ``--device-class little``: ``gemm_cuda_lean``;
  5. a teacher-forced replay of phase 2's tokens: at every generated step,
     the paged path's and the little class's logits against the dense
     big-class path on the same inputs (random weights make greedy decode
     collapse onto a repeated token, so equal tokens prove little);
  6. the reduced model's prefill logits on the card (both classes, dense
     and paged) against the same code's plain versions on the CPU;
  7. the full-sequence forward on the full-width 32-layer minitron-4b
     (random weights from seed 0) over 2 random prompts of 2048 tokens:
     the logits-only prefill (32 ``flash_attention_cuda`` launches a
     forward, every GEMM through ``gemm_cuda``) and the eval loss on the
     tokens shifted by one; the same forward with its attention through
     ``chunked_attention`` (logits within ``LOGIT_TOL``); row 0's first 32
     positions replayed token by token through the dense decode step
     (logits within ``LOGIT_TOL`` at every position);
  8. one decode step of the full-width internlm2-1.8b at a long cache: a
     paged state of 12 rows at the last position of a 4,096-token cache
     (random bf16 K/V, built directly), timed over a few steps (24
     ``paged_attention_cuda`` launches each), traced once with
     ``torch.profiler`` (attention's device share of the step), and its
     logits held within ``LOGIT_TOL`` of the same step through the gather
     route;
  9. the measured loop: ``repro_torch.tuning.tune`` searches, two-stage and
     timed on the card's clock, the forward's GEMM shapes and the decode
     step's (spec ``h100``) and the decode step's again (``h100-little``)
     into ``chiprun_out/tuning_cache.json``; every winning block runs on its
     kernel against its plain version (and lean == pipelined bitwise where
     both run it); with ``REPRO_TORCH_TUNING_CACHE`` set, the control trees
     report ``block_source == "tuned"`` by the reference's Loop-3 rule, the
     host's cost of a lookup is timed, and the minitron-4b forward runs
     tuned, analytical, and tuned with the cache file re-checked on every
     lookup, in turns (median of 3 each, tuned logits within ``LOGIT_TOL``
     of analytical); 128 x 64 x 128 against 128 x 64 x 256 at 4096 x 3072 x
     1024; then ``repro_torch.launch.serve`` with ``--trace`` and
     ``--metrics``: the step-time probe must time both classes' kernels on
     the card, the scheduler must observe them, the metric families and
     the trace's summary must be there, and the tokens must equal phase
     2's; last, ``AsymmetricMesh.from_calibration`` from the cost model and
     from the probe's measured seconds;
 10. the energy objectives on the full-width internlm2-1.8b: the engine
     under ``--objective perf``, ``energy`` and ``edp`` on 3 requests over 2
     x 4 slots; under ``energy`` the big pod parks, the modeled joules fall
     below ``perf``'s with the same tokens; then 16 requests on the same
     engine un-park it (joules are modeled from ``PowerModel``, not read);
 11. the full-width qwen2-moe-a2.7b (random bf16 weights from seed 0, 28.6
     GB): the dense engine (7 ``gemm_cuda`` a layer plus the LM head a
     recurrence step), the paged engine (24 ``paged_attention_cuda`` a
     step at a group of 1, a private phantom lane a slot), the one-shot
     path under the little class (``gemm_cuda_lean``); the engine's tokens
     equal the one-shot path's over the padded batch; a teacher-forced
     replay of those tokens (paged and little against dense) under the
     routing-aware rule (``MIN_ROUTE_AGREE``); the expert einsums timed and
     one decode step traced against the 7.4 ms expert-bytes bound;
 12. ring decode at mixtral-8x7b's full widths, 4 of its 32 layers: 12 rows
     at position 6,000 of a 4,096-token ring (random bf16 K/V built
     directly), dense and paged: the new K/V lands at slot 6000 % 4096, the
     gather route equals the dense ring bitwise, and ``paged_attention_cuda``
     is within ``LOGIT_TOL`` of it under the routing-aware rule;
 13. the full-width mamba2-1.3b (random weights from seed 0; nothing cut):
     ``paged="on"`` refused and ``"auto"`` dense, then phase 2's requests
     through the dense engine (one ``gemm_cuda`` a recurrence step, the LM
     head: the Mamba2 projections are plain products, as in the reference)
     and the one-shot path under the little class (``gemm_cuda_lean``);
     engine == one-shot over the padded batch; one mixed-length admission
     round (16 and 8 tokens) against the short request alone, printed and
     not held (the reference's behaviour); ``launch/score.py``'s forward
     and loss; the forward over 2 x 2048 tokens (the chunked SSD scan)
     against the recurrence over its first ``RECUR_LEN`` positions (the
     bulk prefill from decode, then the last steps token by token) within
     ``LOGIT_TOL``; one decode step of the
     12-row slot table timed and traced against its bytes bound;
 14. the same for the full-width zamba2-2.7b (the shared attention+GLU
     block nine times a step, 64 ``gemm_cuda`` a step; its forward runs
     ``flash_attention_cuda`` at head dim 80), plus its forward through
     ``chunked_attention`` within ``LOGIT_TOL``;
 15. the full-width whisper-small (2 x 448 decoder tokens over 2 x 1,500
     random frames) and pixtral-12b backbone (2 x 2048 random embeddings):
     ``launch/score.py``'s forward and loss, the forward timed against its
     operations bound and traced, the forward through ``chunked_attention``
     within ``LOGIT_TOL``, and decode steps (whisper's cross K/V from
     ``encode``) within ``LOGIT_TOL`` of the forward's logits;
 16. training the full-width internlm2-1.8b (random fp32 masters from
     seed 0) through ``launch/train.py``'s trainer: 8 x 512 tokens a step,
     6 steps and one injected failure at step 2 that restores the step-0
     checkpoint (written to a temporary directory the phase deletes);
     every step launches 675 ``gemm_cuda`` (169 forward, 168 recomputed,
     338 backward) and the training attention's kernels
     (``train_attention_launches``: 48 log-sum-exp forwards, 24 of each
     backward kernel), no inference flash launch and no
     ``chunked_attention`` call; the step-0 loss finite, within 0.5 of ln
     V and within ``TRAIN_EVAL_LOSS_TOL`` of the eval loss (the inference
     flash kernel) on the same batch; the replayed step-0 loss bitwise
     equal, later ones within ``TRAIN_REPLAY_RTOL``; step ms, tokens/s,
     peak memory, the checkpoint's bytes, save and restore seconds beside
     free disk and host memory; one step under the little class's tree
     (675 ``gemm_cuda_lean``, no ``gemm_cuda``) and one step traced in
     three segments against the GEMMs' operations bound and AdamW's bytes
     bound (the split by family only from a trace that saw every GEMM
     launched, up to ``TRACE_ATTEMPTS`` steps tried);
 17. training the full-width qwen2-moe-a2.7b at ``MOE_TRAIN_LAYERS`` of its
     24 layers through ``launch/train.py``'s trainer (its step, so no
     checkpoint is written): 6 steps of 8 x 512 tokens, each launching 115
     ``gemm_cuda`` (29 forward, 28 recomputed, 58 backward), the training
     attention's kernels for its 4 layers and no other kernel; the step-0 loss within ``TRAIN_EVAL_LOSS_TOL`` of the eval
     loss (the flash kernel), the router's aux loss above 0 and finite,
     grad norms finite; the share of routing decisions the training and
     eval forwards agree on (printed); one step under the little tree (115
     ``gemm_cuda_lean``); one traced step split by kernel family (the
     experts' bf16 cuBLAS ``bmm``, fp32 cuBLAS, indexing, AdamW, ...)
     against the GEMMs' and the experts' operations bounds and AdamW's
     bytes bound;
 18. the same at full width and depth for mamba2-1.3b (3 ``gemm_cuda`` a
     step: the head's forward and backward) and zamba2-2.7b (255), 4 steps
     each, and mamba2's layer 0 block: its output's, input's and
     parameters' gradients against the same block in float64 (the SSD in
     its quadratic form) within ``BLOCK_GRAD_ROW_TOL`` of each row's norm
     at each of ``BLOCK_GRAD_SEEDS``, and each planted fault of
     ``BLOCK_FAULTS`` in the float64 block outside it;
 19. gradient steps of the full-width whisper-small through
     ``make_loss_fn``, ``value_and_grad`` and ``adamw_update`` over 2 x 448
     tokens and 1,500 frames: 771 ``gemm_cuda`` a step and the training
     attention's kernels for its 36 attentions (12 encoder, 12 decoder, 12
     cross); the step-0 loss within ``TRAIN_EVAL_LOSS_TOL`` of the eval
     loss, which runs ``flash_attention_cuda``; one traced step against
     its bounds.
 20. mixed serving (the class-sharded step) of the full-width internlm2-1.8b,
     phase 2's weights and requests, through ``launch/serve.py
     --class-sharded on``: the big pod's rows on ``gemm_cuda``, the little
     pod's on ``gemm_cuda_lean``, each pod on its own CUDA stream.  The
     dense engine, the paged engine and the one-shot path: 169
     ``gemm_cuda`` and 169 ``gemm_cuda_lean`` a recurrence step (paged:
     also 24 ``paged_attention_cuda`` a pod), a planted fault (the same
     step with both pods under the big tree) failing that count; the
     engine's tokens equal the one-shot path's; the paged engine's
     first-step logits within ``LOGIT_TOL`` of the dense engine's; a
     teacher-forced replay of the tokens, each pod's rows within
     ``LOGIT_TOL`` of its class's single-program path; the summary's
     ``shard_classes``; one traced mixed step whose GEMMs run on two
     distinct streams (held), their overlap and the step's wall time
     beside the single-program step's and the mixed step's on one stream
     (printed);
 21. mixed training of the full-width internlm2-1.8b through
     ``launch/train.py``'s trainer (``--heterogeneous --class-sharded
     on``): 8 x 512 tokens split over the pods by the chunk table; step 0's
     loss within ``TRAIN_EVAL_LOSS_TOL``, global gradient norm within
     ``MIXED_GRAD_NORM_RTOL`` and every gradient slice (a leaf, or one
     layer of the layer stack's) within ``MIXED_GRAD_SLICE_RTOL`` relative
     L2 of the single-class step on the same params and batch (the little
     pod's weight zeroed in the epilogue must fail the norm and the
     slices, its gradients of one layer zeroed the slices); 3 steps of 675
     ``gemm_cuda`` and 675 ``gemm_cuda_lean`` each, and the training
     attention's kernels for both pods' 24 layers; step ms, tokens/s and
     peak memory beside phase 16's; then ``gemm_backward_check`` at a
     pod's shapes (M = 6 x 512).
 22. the fault-tolerant fleet serving the full-width internlm2-1.8b (phase
     2's weights, shared by the engines of a lane, each engine built as
     ``launch/serve._fleet`` builds it, paged, 4 slots) on bench_fleet's
     bursty trace (3 bursts of 8 requests 4 ticks apart, prompts of 16, 32
     and 48 tokens, 16 new tokens each): the single engine (the yardstick),
     a fleet of 2 with no fault (one tick traced: wall and device busy ms),
     engine 0 killed at tick 6 (queue migrated, in-flight retried; driven
     through ``run_async`` with every request streamed, the chunks joined
     to its tokens; the survivor's post-kill rate beside the single
     engine's, on the modeled clock), ``engine_stall``, ``admission_fail``
     and ``latency_spike`` on engine 0 at tick 2 for 3 ticks (the first
     burst), a big-only engine (``gemm_cuda``) beside a little-only one
     (``gemm_cuda_lean``), and ``launch/serve.py --fleet 2`` against phase
     2's tokens.  Every lane: each request completes exactly once, its
     tokens and the logits behind each of them (read around each engine's
     decode and prefill) bitwise equal to a single engine's of its class;
     169 GEMMs and 24 ``paged_attention_cuda`` a recurrence step an engine;
     no tensor of the path off the card.  A planted fault (engine 1 with
     the middle layer's ``wo`` scaled by 1.01) must differ in the logits
     of every request it served.
 23. the static verifier and the dry-run held against the card's own
     counters.  (a) ``python -m repro_torch.analysis`` over the port's
     files with the contract checks on (its class specs read the card's
     shared memory) and over phase 9's tuning cache: clean.  (b) Every
     block of the control trees ``analysis.configcheck.shipped_trees``
     builds for the kernel backend (three shapes, both classes, both
     coarse loops) launches on the kernel its tree names and matches its
     plain version; a block the contract rejects for shared memory (128 x
     256 x 256 in a two-stage ring) is refused by the wrapper with a
     ``ValueError`` and never launched.  (c) ``launch/dryrun.py`` on the
     meta device at the shapes of phases 8, 7 and 16 (no step run again):
     its GEMM funnel's calls and 2·M·N·K equal the card's launch counters
     of those phases (169, 225 and 675 a step), minitron's operations
     bound is PERF.md's 35.7 ms within ``FWD_BOUND_RTOL``, each cell's
     roofline bound lies below the card's measured time of that step, and
     the training cell's bytes lie within ``DRYRUN_MEM_RTOL`` of phase
     16's peak.
 24. the multi-card half on one card: 4 spawned ranks (``launch.mesh
     .spawn_ranks``) share the card over ``gloo`` as a (data=2, model=2)
     mesh (NCCL refuses two ranks on one device; the collectives stage
     through host memory) and run internlm2-1.8b at full width and 12 of
     its 24 layers (``SPMD_LAYERS``), FSDP over ``data`` and tensor
     parallelism over ``model``: (a) 3 training steps
     of phase 16's 8 x 512 tokens through ``launch/train.py``'s trainer
     from seed 0, losses within ``SPMD_LOSS_RTOL`` and grad norms within
     ``SPMD_NORM_RTOL`` of the one-card trainer's on the same seed and
     batches (run here first), 339 ``gemm_cuda`` a step a rank at the
     local shapes, the training attention's kernels on its local heads
     (24 log-sum-exp forwards, 12 of each backward kernel) and no other
     kernel, each rank's collective bytes a step
     by kind equal to the dry-run's count for the cell at (2,2); (b)
     ``reshard`` to (data=4, model=1) and one more step, held the same
     way; (c) one decode step of 12 rows at the last position of a
     4,096-token cache split over ``model`` (random bf16 K/V built one
     layer at a time from a seed), logits within ``LOGIT_TOL`` of the
     one-card step, and a prefill of 12 x 512 tokens on the ranks' local
     heads (12 ``flash_attention_cuda`` a rank), its last positions'
     logits within ``LOGIT_TOL`` of the one-card forward's; rank 0's
     ``gemm_cuda`` at a local shape and ``flash_attention_cuda`` at the
     prefill's local shape (6 rows x 512, 8 query and 4 KV heads) against
     their plain versions, within ``BF16_TOL`` (flash also
     ``FLASH_ROW_TOL``).  Per-rank
     peak GB beside the dry-run's bytes and step wall ms are printed: the
     ranks share one card, so these are not a multi-card step time.
 25. the MoE, Mamba2, hybrid and enc-dec families on the same 4 ranks at
     (data=2, model=2), one ``spawn_ranks`` running them in turn at full
     width, depth cut for time (``P25_FAMILIES``): qwen2-moe-a2.7b at 1 of
     24 layers, mamba2-1.3b at 4 of 48, zamba2-2.7b at 6 of 54 (2
     training steps each through ``launch/train.py``'s trainer, against
     one card's trainer at the same cut, seed and batches, run here; the
     Mamba2 families' second step starts on the ranks from one card's
     state after the first), whisper-small whole (2 gradient steps
     through ``trainer.sharded_train_step``, phase 19's first two), each
     with a decode step of 12 rows and a prefill (whisper: its encoder +
     decoder forward);
     mamba2-1.3b also a decode step at a batch of 1, its 64 SSM heads split
     over (data, model), 16 a rank; mixtral-8x7b at 2 of 32 layers, two
     ring decode steps at a batch of 1 at positions 6,000 and 6,001 of its
     4,096-token ring split over (data, model), 1,024 slots a rank, and
     one at 12 rows.  Held per family: every step's loss within
     ``SPMD_LOSS_RTOL`` and grad norm within ``SPMD_NORM_RTOL`` of one
     card's, gathered logits within ``LOGIT_TOL`` of one card's (the MoE
     routing of one card forced on the ranks: a near tie breaks alike),
     each rank's ``gemm_cuda`` and ``flash_attention_cuda`` launches equal
     to one card's, each rank's collective bytes by kind equal to the
     dry-run's for the same cell, each rank's training (mixtral: ring)
     step peak within ``P25_MEM_RTOL`` of the dry-run's bytes, and rank
     0's ``gemm_cuda`` and ``flash_attention_cuda`` at a rank-local shape
     of the family against their plain versions.  The serving steps'
     peaks, the bytes allocated at their start and their requested
     growth are printed beside the dry-run's bytes and arguments (not
     held: the dry-run counts the plain GEMM backend and only the
     arguments a step reads).  ``python3 chip_smoke.py --phase25``
     runs phase 0 and this phase alone (whisper's one-card steps then run
     here too); ``--phase24`` phase 0 and phase 24 alone.
 26. the class-sharded step a rank a pod: 2 spawned ranks share the card
     over ``gloo`` as a (pod=2, data=1, model=1) mesh, pod 0 the big class
     (``gemm_cuda``) and pod 1 the little one (``gemm_cuda_lean``), each
     rank drawing the full-width internlm2-1.8b from seed 0 (digests held
     equal across the ranks).  (a) ``launch/serve.py --class-sharded on
     --one-shot`` on the ranks, and phase 20's teacher-forced replay
     through ``serve.mixed_decode_step`` on a rank's pod mesh: each pod's
     logits bitwise equal to that pod's rows of phase 20's stream step,
     the tokens bitwise the stream path's, 169 launches a recurrence step
     of the rank's own kernel and none of the other; (b) the dense and
     paged engines on phase 20's requests: completed == submitted on
     both ranks, tokens bitwise phase 20's stream engines' and equal on
     both ranks, 24 ``paged_attention_cuda`` a step a rank on its pod's
     page partition, a rank's KV bytes half the stream engine's; (c) 3
     mixed training steps of 8 x 512 tokens (12 padded rows) at 12 of 24
     layers (``SPMD_LAYERS``): losses and grad norms within
     ``POD_LOSS_RTOL`` of the same-cut stream mixed trainer's (run here
     first), 339 launches a step a rank of its own kernel, all-reduce
     bytes a step a rank equal to the dry-run's for the cell on the
     abstract pod mesh, each step's peak within ``P25_MEM_RTOL`` of the
     dry-run's bytes; then a straggler hook (each rank its own times,
     pod 1 slow) gives both ranks the same new split.  The mixed decode
     step's wall ms on the ranks is printed beside the stream step's.
     Phase 20's stream results are its references (made here when
     ``--phase26`` runs phase 0 and this phase alone).
 ``python3 chip_smoke.py --mamba2`` runs phase 0, the SSD scan kernels'
 check of phase 1 and the Mamba2 phases' gates alone (13, 14 and 18, each
 scan of the block gates through the kernels, none through
 ``_ssd_chunked``), details in ``chiprun_out/chip_smoke_mamba2.json``.
 Each of phases 17-19 and 21 ends with the GEMM autograd Function's check
 of phase 1 at its own step's shapes, both classes (``gemm_backward_check``).

Each of phases 2-4, the forward of phase 7, the steps of phase 8, the
engines and the kernel step of phases 11 and 12, the paths of phases
13-15, the training runs and little-tree steps of phases 16-17, the
training runs of phase 18, the steps of phase 19, the paths and steps
of phases 20-21, the lanes of phase 22 and each rank's steps and paths of
phases 24, 25 and 26 resets the kernels' launch counters just before it and
reads them just after; the launches of phases 1, 5, 6, 10 and the
comparisons of phases 7, 8, 11, 12, 13-15 and 20 count for no path.  The engines' tokens/s are smoke readings over a few steps, not
throughputs: ``python -m repro_torch.launch.profile_decode`` measures those.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Tolerances (max |kernel - plain| <= ATOL + RTOL * |plain|), per dtype as in
# tests/test_backend_parity.py: bf16 outputs round to 8 mantissa bits.
BF16_TOL = 2e-2
FP32_TOL = 1e-4
# Logits of the paged path (CUDA kernel, online softmax) or the little
# class against the dense big-class path: bf16 residual streams through
# 24 layers; logits have a standard deviation near 0.9.  The same bound
# holds the forward's flash kernel against chunked_attention and against
# the decode step (phase 7): those attentions differ in where they round
# p to bf16 (before or after normalising), a bf16 ulp of the attention
# output, which 32 layers of bf16 residual stream carry to the logits
# (standard deviation near 1.1 at minitron-4b's width).
LOGIT_TOL = 0.25
# The GEMM autograd Function's output and gradients (phase 1), also in L2
# relative to each row's norm: both sides round the same fp32 sums to bf16
# (at most 2^-9 of an element), a fraction of a percent of a row; a product
# that skipped one K-tile of 64 of its reduction moves a row by sqrt(64 / K)
# of its norm at unit-scale operands, 2.6% at the head's dA (K = 92,544)
# and more at every other backward shape.
GEMM_ROW_TOL = 1e-2
# Flash attention's rows, in L2 relative to the row's own norm: late causal
# rows average up to 2048 values of v down to a few hundredths, where
# BF16_TOL's absolute 0.02 is wide; a row that lost a key block moves by
# tens of percent, the kernel's own rounding by well under one.
FLASH_ROW_TOL = 2e-2
# A Mamba2 block's output rows, the chunked scan against the recurrence on
# the same inputs, in L2 relative to the row's norm: the scan rounds its
# output to bf16 before adding D·x (the reference's order) and sums in
# another order, 0.7% of a row at full width; a row that lost the state a
# chunk carries in moves by tens of percent.  Its final fp32 state is held
# to the same bound in L2 (3.5e-6 of its norm on the CPU at full width).
BLOCK_ROW_TOL = 2e-2
# The SSD scan kernels against their plain versions and _ssd_chunked
# (phase 1), relative L2: the fp32 outputs (the final state, ddt, dA) within
# SSD_FP32_TOL (the operands' high and low pairs keep about 16 bits, sums in
# other orders: readings about 3e-6); the bf16 ones (y, dx, dB, dC) within
# SSD_BF16_TOL (a value whose fp32 sum lands across a bf16 rounding boundary
# moves a bf16 step: readings about 1e-4).  The scan at the Mamba2 cell's
# layer: 4 x 2,048 tokens, 64 heads of 64, d_state 128, one group, chunk 256.
SSD_FP32_TOL, SSD_BF16_TOL = 1e-4, 1e-3
SSD_SHAPE = (4, 2048, 64, 1, 128, 256)   # rows, seq, heads, groups, d_state, chunk

PEAK_BF16 = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
HBM_BW = 3.35e12     # bytes/s, H100 SXM data sheet

ARCH = "internlm2-1.8b"
BATCH, PROMPT_LEN, GEN_LEN = 8, 16, 8
# The forward of phase 7: full-width minitron-4b over 2 x 2048 tokens.
FWD_ARCH, FWD_BATCH, FWD_SEQ, REPLAY_LEN = "minitron-4b", 2, 2048, 32
# Tokens per KV page of the paged engine: three pages per 24-token slot, so
# the kernel walks a real page table (the default, min block.bm = 64, would
# give each slot a single page).
PAGE_SIZE = 8
# The MoE model of phase 11 and the ring of phase 12 (mixtral-8x7b's widths
# at RING_LAYERS of its 32 layers: 93 GB of bf16 weights do not fit a card).
MOE_ARCH, RING_ARCH, RING_LAYERS, RING_POS = "qwen2-moe-a2.7b", "mixtral-8x7b", 4, 6000
# Paged attention at serving's cache lengths (phase 1), 12 rows each:
# (label, the config whose heads it takes, page size, pages a row, rows);
# qwen2-moe-a2.7b's group of 1 also at its paged engine's 24-token slot.
LONG_PAGED_CASES = (
    ("4096-full", ARCH, 64, 64, "full"),
    ("4096-ragged", ARCH, 64, 64, "random"),
    ("32768-full", ARCH, 64, 512, "full"),
    ("minitron-4b-4096-full", "minitron-4b", 16, 256, "full"),
    ("qwen2.5-32b-4096-full", "qwen2.5-32b", 16, 256, "full"),
    ("qwen2-moe-engine", MOE_ARCH, PAGE_SIZE, 3, "random"),
    ("qwen2-moe-4096-full", MOE_ARCH, 64, 64, "full"),
    ("mixtral-ring-6000", RING_ARCH, 64, 64, "ring"),
)
# The long-cache decode step (phase 8): full-width internlm2-1.8b, 12 rows
# at the last position of a 4,096-token cache in pages of 64.
LONG_ROWS, LONG_CACHE, LONG_PS, LONG_STEPS = 12, 4096, 64, 5
# The routing-aware rule (phases 11, 12): at least this share of the top-k
# decisions of two routes must agree.  Two float routes (the paged kernel's
# online softmax against the gather, the little class's blocks) differ in
# the last bits; where two experts' probabilities are that close a choice
# flips, and the flipped token's hidden state then differs at O(1), so its
# later layers' and later steps' choices flip too: a free replay of the
# full-width qwen2-moe on an H100 agreed on 0.83 of its decisions.  A dispatch fault (wrong experts, a lost or
# shifted row) agrees by chance only: top-4 of 60 experts, about 4/60 of
# the decisions.
MIN_ROUTE_AGREE = 0.5
# The energy phase (10): 3 requests over 2 pods of 4 slots, so the little
# pod alone holds the load with the hysteresis margin to spare.
ENERGY_BATCH, ENERGY_SLOTS = 3, 4
# The recurrent families (phases 13, 14), served at full width, and the
# enc-dec and embedding-input forwards (phase 15): whisper-small over its
# published 448-token decoder context and 1,500 encoder frames.
SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH, EMBED_ARCH = "mamba2-1.3b", "zamba2-2.7b", "whisper-small", "pixtral-12b"
DEC_CTX, ENC_DECODE_STEPS, REPLAY_TAIL = 448, 8, 4
# The recurrence of phases 13 and 14 replays the first RECUR_LEN positions
# of the 2 x 2048 forward's tokens (two of the scan's 256-step chunks, so the
# state it carries across a chunk is checked): a decode step costs the host
# about a tenth of a second, and all 2048 would take minutes per model.
RECUR_LEN = 512


def gemm_shapes(cfg) -> list:
    """``((K, N), calls)`` of every GEMM of one decode step or forward: q, k
    and v, o, the GLU's (dense) or the shared expert's (MoE) gate, up and
    down, the LM head (``transformer.gemm_shapes``)."""

    from repro_torch.models import transformer as T

    return T.gemm_shapes(cfg)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BW, n_ops / PEAK_BF16
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, args_list, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call with CUDA events, cycling over input sets
    (so weight matrices are cold in the 50 MB L2, as in a decode step)."""

    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, args, calls: int = 200) -> float:
    """Host microseconds per call: back-to-back calls on the host clock,
    before the card is waited on (at decode shapes each kernel is shorter
    than its call, so the launch queue stays short)."""

    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def row_rel_err(got, ref) -> float:
    """The largest ``|got - ref| / |ref|`` over the rows (last axis) in L2."""

    diff = (got.float() - ref.float()).norm(dim=-1)
    return float((diff / ref.float().norm(dim=-1).clamp_min(1e-30)).max())


def within(torch, got, ref, tol: float) -> tuple[bool, float]:
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    ok = bool(torch.isfinite(g).all()) and bool((err <= tol + tol * r.abs()).all())
    return ok, float(err.max())


def phase0(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 0: built {sorted(logs)} in {build_s:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, log in logs.items():
        with open(os.path.join(OUT_DIR, f"nvcc_{name}.log"), "w") as f:
            f.write(log)
    # The redesigned kernels must reach the tensor cores: wgmma compiles to
    # HGMMA, mma.sync to HMMA.
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass_counts = {}
    for name, ins in (("gemm", "HGMMA"), ("flash_attention", "HMMA")):
        sass = subprocess.run([cuobjdump, "-sass", build.library_path(name)],
                              capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump -sass {name} failed: {sass.stderr.strip()[-500:]}")
        sass_counts[name] = {ins: sass.stdout.count(ins)}
        check(sass_counts[name][ins] > 0, f"no {ins} instruction in the {name} library")
    print(f"phase 0: tensor-core instructions in the SASS {sass_counts}", flush=True)
    return card, sass_counts


def phase1(torch, detail: dict) -> dict:
    """Kernels against their plain versions; returns the per-kernel records."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.configs import get_config
    from repro_torch.runtime.paging import divisor_page_size

    cfg = get_config(ARCH)
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    big, little = asym.execution_context("big"), asym.execution_context("little")
    check(big.backend() == "cuda" and little.backend() == "cuda_lean",
          f"class kernels {big.backend()} / {little.backend()}, want cuda / cuda_lean")
    m = asym.n_pods * asym.batch_layout(BATCH).c_max  # the engine's slot table
    d, L = cfg.d_model, cfg.n_layers
    # (K, N) of every GEMM in one decode step, with its count per step.
    step_shapes = gemm_shapes(cfg)
    check(sum(c for _, c in step_shapes) == 7 * L + 1, "step shape counts")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def operands(mm, k, n):
        a = torch.randn((mm, k), generator=gen, device="cuda").to(torch.bfloat16)
        copies = max(1, math.ceil(128e6 / (k * n * 2)))  # > L2, weights arrive cold
        bs = [(torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
              for _ in range(min(copies, 4 if k * n > 50e6 else copies))]
        return a, bs

    def step_gemms(name, ctx, fn, plain, shapes, label):
        """Every GEMM shape of one decode step (``shapes``, M = the slot
        table) on ``fn`` against its plain version, lean == pipelined
        bitwise, timed beside the plain version, ``torch.matmul`` and the
        bound; returns the step's totals and the largest error."""

        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_s": 0.0, "ops_s": 0.0, "host_ms": 0.0, "library_host_ms": 0.0}
        max_err = 0.0
        for (k, n), count in shapes:
            cfgb = ctx.block_config(m, k, n, "bfloat16", 2)
            a, bs = operands(m, k, n)
            got, ref = fn(a, bs[0], cfgb), plain(a, bs[0], cfgb)
            torch.cuda.synchronize()
            ok, err = within(torch, got, ref, BF16_TOL)
            check(ok, f"{name} {m}x{k}x{n} {cfgb}: max err {err} over tol {BF16_TOL}")
            other = (G.gemm_cuda if fn is G.gemm_cuda_lean else G.gemm_cuda_lean)(a, bs[0], cfgb)
            check(torch.equal(got, other), f"lean != pipelined bitwise at {m}x{k}x{n} {cfgb}")
            max_err = max(max_err, err)
            iters = 10 if n > 50000 else 50
            t_k = time_ms(torch, lambda x, y: fn(x, y, cfgb), [(a, b) for b in bs], iters)
            t_p = time_ms(torch, lambda x, y: plain(x, y, cfgb), [(a, b) for b in bs], max(3, iters // 5))
            t_l = time_ms(torch, torch.matmul, [(a, b) for b in bs], iters)
            h_k = host_us(torch, lambda x, y: fn(x, y, cfgb), (a, bs[0]))
            h_l = host_us(torch, torch.matmul, (a, bs[0]))
            n_bytes = (m * k + k * n + m * n) * 2
            b_ms, by = bound_ms(n_bytes, 2 * m * k * n)
            rows.append({"kernel": name, "model": label, "shape": [m, k, n],
                         "block": [cfgb.bm, cfgb.bk, cfgb.bn],
                         "calls_per_step": count, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                         "host_us": h_k, "library_host_us": h_l,
                         "bound_ms": b_ms, "bound_by": by, "max_abs_err": err})
            print(f"  {name} {label} {m}x{k}x{n} block {cfgb.bm}x{cfgb.bk}x{cfgb.bn}: err {err:.3g} "
                  f"kernel {t_k:.4f} ms plain {t_p:.4f} matmul {t_l:.4f} bound {b_ms:.4f} ({by}); "
                  f"host {h_k:.1f} us a call, matmul {h_l:.1f} us", flush=True)
            for key, val in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms),
                             ("host_ms", h_k / 1e3), ("library_host_ms", h_l / 1e3)):
                tot[key] += count * val
            tot["bytes_s"] += count * n_bytes / HBM_BW
            tot["ops_s"] += count * 2 * m * k * n / PEAK_BF16
            del a, bs, got, ref, other
        print(f"  {name} over one {label} decode step ({sum(c for _, c in shapes)} GEMMs): kernel "
              f"{tot['ms']:.2f} ms, matmul {tot['library_ms']:.2f} ms; host {tot['host_ms']:.2f} ms, "
              f"matmul's {tot['library_host_ms']:.2f} ms", flush=True)
        return tot, max_err

    records = {}
    rows = []
    moe_cfg = get_config(MOE_ARCH)
    for name, ctx, fn, plain in (
        ("gemm_cuda", big, G.gemm_cuda, G.gemm_plain),
        ("gemm_cuda_lean", little, G.gemm_cuda_lean, G.gemm_lean_plain),
    ):
        tot, max_err = step_gemms(name, ctx, fn, plain, step_shapes, ARCH)
        detail[f"{name}_decode_step"] = tot
        # qwen2-moe-a2.7b's step (phase 11): k and v at 16 KV heads, the
        # shared expert's K = 5632, the 151,936-wide LM head.
        moe_tot, moe_err = step_gemms(name, ctx, fn, plain, gemm_shapes(moe_cfg), MOE_ARCH)
        detail[f"{name}_moe_decode_step"] = moe_tot
        # The recurrent families' steps (phases 13, 14): mamba2-1.3b's head
        # alone, zamba2-2.7b's shared block nine times and its head; and
        # whisper-small's tied head, N = 51,865 (not a multiple of 8).
        wcfg = get_config(ENCDEC_ARCH)
        later = {}
        for label, shapes in ((SSM_ARCH, gemm_shapes(get_config(SSM_ARCH))),
                              (HYBRID_ARCH, gemm_shapes(get_config(HYBRID_ARCH))),
                              (f"{ENCDEC_ARCH} head", [((wcfg.d_model, wcfg.vocab), 1)])):
            later[label], err_l = step_gemms(name, ctx, fn, plain, shapes, label)
            max_err = max(max_err, err_l)
        detail[f"{name}_later_decode_steps"] = later
        records[name] = {
            "max_abs_err": max(max_err, moe_err), "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_s"] >= tot["ops_s"] else "operations",
            "moe_step": {k: moe_tot[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            **{f"{label}_step": {k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
               for label, t in later.items()},
        }

    # The qkv projections with bias (qwen2-moe-a2.7b): the class's kernel,
    # then the fp32 bias, against the plain product plus the bias.
    from repro_torch.kernels import ops

    a, bs = operands(m, d, d)
    bias = torch.randn((d,), generator=gen, device="cuda")
    for ctx in (big, little):
        with ctx:
            got = ops.linear(a, bs[0], bias)
        ok, err = within(torch, got, (G.gemm_plain(a, bs[0]).float() + bias).to(torch.bfloat16), BF16_TOL)
        check(ok, f"{ctx.device_class} qkv projection with bias: max err {err}")
        print(f"  {ctx.device_class} {m}x{d}x{d} projection with bias: err {err:.3g}", flush=True)
    del a, bs

    # The tree shape, with the big and the little class's blocks.
    for name, ctx, fn, plain in (("gemm_cuda", big, G.gemm_cuda, G.gemm_plain),
                                 ("gemm_cuda_lean", little, G.gemm_cuda_lean, G.gemm_lean_plain)):
        blk = ctx.tree.block
        a = torch.randn((1024, 1024), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((1024, 1024), generator=gen, device="cuda") / 32).to(torch.bfloat16)
        got, ref = fn(a, b, blk), plain(a, b, blk)
        other = (G.gemm_cuda if fn is G.gemm_cuda_lean else G.gemm_cuda_lean)(a, b, blk)
        torch.cuda.synchronize()
        ok, err = within(torch, got, ref, BF16_TOL)
        check(ok, f"{name} tree shape {blk}: max err {err}")
        check(torch.equal(got, other), f"lean != pipelined bitwise at the tree shape {blk}")
        t_k = time_ms(torch, lambda x, y: fn(x, y, blk), [(a, b)], 20)
        t_l = time_ms(torch, torch.matmul, [(a, b)], 20)
        b_ms, by = bound_ms(3 * 1024 * 1024 * 2, 2 * 1024 ** 3)
        rows.append({"kernel": name, "shape": [1024, 1024, 1024], "block": [blk.bm, blk.bk, blk.bn],
                     "calls_per_step": 0, "ms": t_k, "library_ms": t_l, "bound_ms": b_ms,
                     "bound_by": by, "max_abs_err": err})
        print(f"  {name} tree 1024^3 block {blk.bm}x{blk.bk}x{blk.bn}: err {err:.3g} "
              f"kernel {t_k:.4f} ms matmul {t_l:.4f} bound {b_ms:.4f} ({by})", flush=True)

    def forward_gemms(label, fm, shapes, one_stage):
        """The big class's GEMMs of one forward (M = ``fm`` rows) against
        fp32 ``torch.matmul``, lean == pipelined bitwise, timed beside
        ``torch.matmul`` and the bound; with ``one_stage`` also the
        one-stage kernel at its own block (what the ring buys)."""

        tot = {"ms": 0.0, "lean_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "gemms": 0}
        max_err = 0.0
        for (k, n), count in shapes:
            cfgb = big.block_config(fm, k, n, "bfloat16", 2)
            a, bs = operands(fm, k, n)
            got = G.gemm_cuda(a, bs[0], cfgb)
            torch.cuda.synchronize()
            ok, err = within(torch, got, torch.matmul(a.float(), bs[0].float()), BF16_TOL)
            check(ok, f"gemm_cuda {fm}x{k}x{n} {cfgb}: max err {err} over tol {BF16_TOL}")
            check(torch.equal(got, G.gemm_cuda_lean(a, bs[0], cfgb)),
                  f"lean != pipelined bitwise at {fm}x{k}x{n} {cfgb}")
            max_err = max(max_err, err)
            iters = 2 if n > 50000 else 5
            row = {"kernel": "gemm_cuda", "model": label, "shape": [fm, k, n],
                   "block": [cfgb.bm, cfgb.bk, cfgb.bn], "calls_per_forward": count,
                   "max_abs_err": err}
            t_k = time_ms(torch, lambda x, y: G.gemm_cuda(x, y, cfgb), [(a, b) for b in bs], iters, 1)
            t_l = time_ms(torch, torch.matmul, [(a, b) for b in bs], iters, 1)
            b_ms, by = bound_ms((fm * k + k * n + fm * n) * 2, 2 * fm * k * n)
            row.update(ms=t_k, library_ms=t_l, bound_ms=b_ms, bound_by=by)
            note = ""
            if one_stage:
                # The one-stage kernel at the block its model derives.
                lean_blk = G.resolve_block_config(fm, k, n, torch.bfloat16, stages=1)
                ok, lean_err = within(torch, G.gemm_cuda_lean(a, bs[0], lean_blk),
                                      torch.matmul(a.float(), bs[0].float()), BF16_TOL)
                check(ok, f"gemm_cuda_lean {fm}x{k}x{n} {lean_blk}: max err {lean_err} over tol {BF16_TOL}")
                t_one = time_ms(torch, lambda x, y: G.gemm_cuda_lean(x, y, lean_blk),
                                [(a, b) for b in bs], iters, 1)
                row.update(lean_block=[lean_blk.bm, lean_blk.bk, lean_blk.bn], lean_ms=t_one)
                tot["lean_ms"] += count * t_one
                note = f" (one stage at {lean_blk.bm}x{lean_blk.bk}x{lean_blk.bn}: {t_one:.4f})"
            rows.append(row)
            print(f"  gemm_cuda {label} forward {fm}x{k}x{n} block {cfgb.bm}x{cfgb.bk}x{cfgb.bn}: "
                  f"err {err:.3g} kernel {t_k:.4f} ms{note} matmul {t_l:.4f} bound {b_ms:.4f} ({by})",
                  flush=True)
            for key, val in (("ms", t_k), ("library_ms", t_l), ("bound_ms", b_ms)):
                tot[key] += count * val
            tot["gemms"] += count
            del a, bs, got
        print(f"  gemm_cuda over one {label} forward ({tot['gemms']} GEMMs): kernel {tot['ms']:.1f} ms"
              + (f" (one stage {tot['lean_ms']:.1f} ms)" if one_stage else "")
              + f", matmul {tot['library_ms']:.1f} ms, bound {tot['bound_ms']:.1f} ms", flush=True)
        return tot, max_err

    # The GEMMs of one forward of phase 7 (M = B x S rows), big class.
    fcfg = get_config(FWD_ARCH)
    fm, fl = FWD_BATCH * FWD_SEQ, fcfg.n_layers
    detail["gemm_cuda_forward"], _ = forward_gemms(FWD_ARCH, fm, gemm_shapes(fcfg), True)
    check(detail["gemm_cuda_forward"]["gemms"] == 7 * fl + 1, "forward GEMM count")
    # The later phases' forwards: mamba2-1.3b's head, zamba2-2.7b's shared
    # block and head, pixtral-12b's 40 layers (M = 2 x 2048), whisper-small's
    # decoder (M = 2 x 448, the tied head) and its encoder and cross K/V
    # (M = 2 x 1,500).
    wd, wff, wnl = wcfg.d_model, wcfg.d_ff, wcfg.n_layers
    later_fwd = {}
    for label, m_rows, shapes in (
        (SSM_ARCH, fm, gemm_shapes(get_config(SSM_ARCH))),
        (HYBRID_ARCH, fm, gemm_shapes(get_config(HYBRID_ARCH))),
        (EMBED_ARCH, fm, gemm_shapes(get_config(EMBED_ARCH))),
        (f"{ENCDEC_ARCH} decoder", 2 * DEC_CTX, [((wd, wd), 6 * wnl), ((wd, wff), wnl),
                                                 ((wff, wd), wnl), ((wd, wcfg.vocab), 1)]),
        (f"{ENCDEC_ARCH} encoder", 2 * wcfg.enc_frames, [((wd, wd), 4 * wcfg.enc_layers + 2 * wnl),
                                                          ((wd, wff), wcfg.enc_layers),
                                                          ((wff, wd), wcfg.enc_layers)]),
    ):
        later_fwd[label], err_f = forward_gemms(label, m_rows, shapes, False)
        records["gemm_cuda"]["max_abs_err"] = max(records["gemm_cuda"]["max_abs_err"], err_f)
    detail["gemm_cuda_later_forwards"] = later_fwd
    records["gemm_cuda"]["later_forwards"] = {k: {x: v[x] for x in ("ms", "library_ms", "bound_ms", "gemms")}
                                              for k, v in later_fwd.items()}

    # fp32 output of the pipelined kernel at one decode shape.
    cfgb = big.block_config(m, d, d, "bfloat16", 2)
    a, bs = operands(m, d, d)
    got = G.gemm_cuda(a, bs[0], cfgb, out_dtype=torch.float32)
    ok, err = within(torch, got, G.gemm_plain(a, bs[0], cfgb, out_dtype=torch.float32), FP32_TOL)
    check(ok, f"gemm_cuda fp32 output: max err {err} over tol {FP32_TOL}")
    check(torch.equal(got, G.gemm_cuda_lean(a, bs[0], cfgb, out_dtype=torch.float32)),
          "lean != pipelined bitwise in fp32")
    print(f"  gemm_cuda fp32 out {m}x{d}x{d}: err {err:.3g}", flush=True)

    # Paged attention at the paged engine's shape (phase 3), then at the
    # cache lengths serving runs (12 rows, head dim 128; internlm2-1.8b's
    # 16 / 8 heads, then minitron-4b's and qwen2.5-32b's groups).
    seq_cap = PROMPT_LEN + GEN_LEN
    ps = divisor_page_size(seq_cap, PAGE_SIZE)
    w = seq_cap // ps
    n_pages = asym.n_pods * (asym.batch_layout(BATCH).c_max + 1) * w
    n_sm = PA.sm_count(torch.device("cuda"))
    paged = []
    for label, arch, page, width, kind in (("engine", ARCH, ps, w, "random"),
                                           *LONG_PAGED_CASES):
        pcfg = get_config(arch)
        row = paged_case(torch, PA, gen, m, pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim,
                         n_pages if label == "engine" else m * width + 1, page, width, kind, n_sm)
        row["label"] = label
        row["calls_per_step"] = L if label == "engine" else 0
        if label == "engine":
            row["host_us"] = host_us(torch, PA.paged_attention_cuda, row.pop("args"))
        row.pop("args", None)
        paged.append(row)
        print(f"  paged_attention_cuda {label} B={m} H={pcfg.n_heads}/{pcfg.n_kv_heads} ps={page} "
              f"W={width} ({kind} rows) {row['n_split']} x {row['split_pages']} pages: "
              f"err {row['max_abs_err']:.3g} (row {row['max_row_rel_err']:.3g}) kernel {row['ms']:.4f} ms "
              f"(device {row['device_ms']:.4f}) plain {row['plain_ms']:.4f} bound {row['bound_ms']:.5f} "
              f"({row['bound_by']}, {100 * row['bound_share']:.1f}% of it, "
              f"{row['gb_per_s']:.0f} GB/s)"
              + (f"; host {row['host_us']:.1f} us a call" if "host_us" in row else ""), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    rows.extend(paged)
    eng = paged[0]
    records["paged_attention_cuda"] = {
        "max_abs_err": max(r["max_abs_err"] for r in paged), "ms": L * eng["ms"],
        "plain_ms": L * eng["plain_ms"], "library_ms": None, "bound_ms": L * eng["bound_ms"],
        "bound_by": eng["bound_by"], "device_ms": L * eng["device_ms"],
        "cases": [{k: r[k] for k in ("label", "shape", "n_split", "split_pages", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_share", "max_abs_err",
                                     "max_row_rel_err")} for r in paged[1:]],
    }
    detail["phase1"] = rows
    return records


def paged_case(torch, PA, gen, b, hq, hkv, dh, n_p, page, width, kind, n_sm) -> dict:
    """One paged-attention call against the gather route: "full" rows
    attend their whole cache; "ring" rows sit at ``RING_POS``, past the end
    of a ring cache, where every slot is visible; "random" rows a random
    prefix, with a dead row (every table entry unallocated) and a row aged
    past the cache."""

    from repro_torch.runtime.paging import SENTINEL

    s_cache = width * page
    q = torch.randn((b, hq, dh), generator=gen, device="cuda").to(torch.bfloat16)
    pk = torch.randn((n_p, page, hkv, dh), generator=gen, device="cuda").to(torch.bfloat16)
    pv = torch.randn((n_p, page, hkv, dh), generator=gen, device="cuda").to(torch.bfloat16)
    table = torch.randperm(n_p, generator=gen, device="cuda")[:b * width].reshape(b, width).int()
    if kind in ("full", "ring"):
        pos = torch.full((b,), s_cache - 1 if kind == "full" else RING_POS, dtype=torch.int32,
                         device="cuda")
    else:
        pos = torch.randint(0, s_cache, (b,), generator=gen, device="cuda", dtype=torch.int32)
        table[0] = int(SENTINEL)       # a dead row: every entry unallocated
        pos[1] = s_cache + 7           # a row aged past the cache
    args = (q, pk, pv, table, pos)
    got = PA.paged_attention_cuda(*args)
    ref = PA.paged_attention_torch(*args)
    again = PA.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    label = f"B={b} H={hq}/{hkv} ps={page} W={width} {kind}"
    ok, err = within(torch, got, ref, BF16_TOL)
    check(ok, f"paged_attention_cuda {label}: max err {err} over tol {BF16_TOL}")
    row_err = row_rel_err(got, ref)
    check(row_err <= FLASH_ROW_TOL,
          f"paged_attention_cuda {label}: a row off by {row_err:.3g} of its norm, over {FLASH_ROW_TOL}")
    check(torch.equal(got, again), f"paged_attention_cuda {label}: two calls differ")
    del got, ref, again
    big = s_cache > 8192
    t_k = time_ms(torch, PA.paged_attention_cuda, [args], 20 if big else 50)
    dev = device_ms(torch, lambda: PA.paged_attention_cuda(*args), 10, "paged_")
    t_p = time_ms(torch, PA.paged_attention_torch, [args], 3 if big else 10, 1)
    attended = torch.clamp(pos.long() + 1, max=s_cache).sum().item()
    n_bytes = (2 * attended * hkv * dh * 2 + 2 * b * hq * dh * 2 + table.numel() * 4 + pos.numel() * 4)
    b_ms, by = bound_ms(n_bytes, 4 * attended * hq * dh)
    plan = PA.split_plan(b, hkv, width, page, n_sm)
    return {"kernel": "paged_attention_cuda", "shape": [b, hq, hkv, dh, n_p, page, width],
            "rows": kind, "n_split": plan.n_split, "split_pages": plan.pages, "ms": t_k,
            "device_ms": dev, "plain_ms": t_p, "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "bound_share": b_ms / t_k, "gb_per_s": n_bytes / (t_k * 1e-3) / 1e9,
            "attended": attended, "max_abs_err": err, "max_row_rel_err": row_err, "args": args}


def device_ms(torch, fn, calls: int, key: str) -> float:
    """Device milliseconds a call of the kernels whose name holds ``key``,
    from a ``torch.profiler`` trace of ``calls`` back-to-back calls (CUDA
    events over back-to-back calls read the host's rate when a call's
    device time is shorter than its host time)."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type != DeviceType.CPU and key in e.name]
    check(bool(evs), f"the profiler saw no kernel named *{key}*")
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / calls


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves visible, per (batch row, head)."""

    n = 0
    for i in range(sq):
        qi = i + sk - sq
        hi = min(sk, qi + 1) if causal else sk
        lo = max(0, qi - window + 1) if window is not None else 0
        n += max(0, hi - lo)
    return n


def phase1_flash(torch, detail: dict) -> dict:
    """flash_attention_cuda against its plain version: the forward's layer
    shape, a ragged suffix, a window and a non-causal call; then the later
    phases' shapes (head dim 80; non-causal over 1,500 keys)."""

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA

    cfg = get_config(FWD_ARCH)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    zcfg, wcfg = get_config(HYBRID_ARCH), get_config(ENCDEC_ARCH)
    zheads, wheads = (zcfg.n_heads, zcfg.n_kv_heads, zcfg.head_dim), (wcfg.n_heads, wcfg.n_kv_heads, wcfg.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, record = [], None
    for label, b, sq, sk, causal, window, (hq, hkv, d) in (
        ("layer", FWD_BATCH, FWD_SEQ, FWD_SEQ, True, None, heads),
        ("suffix", FWD_BATCH, 100, 300, True, None, heads),
        ("window", FWD_BATCH, FWD_SEQ, FWD_SEQ, True, 256, heads),
        ("non-causal", FWD_BATCH, FWD_SEQ, FWD_SEQ, False, None, heads),
        # zamba2-2.7b's shared block (head dim 80), whisper-small's encoder,
        # decoder, cross-attention in the forward and in a decode step.
        (f"{HYBRID_ARCH} shared", FWD_BATCH, FWD_SEQ, FWD_SEQ, True, None, zheads),
        (f"{ENCDEC_ARCH} encoder", 2, wcfg.enc_frames, wcfg.enc_frames, False, None, wheads),
        (f"{ENCDEC_ARCH} decoder", 2, DEC_CTX, DEC_CTX, True, None, wheads),
        (f"{ENCDEC_ARCH} cross", 2, DEC_CTX, wcfg.enc_frames, False, None, wheads),
        (f"{ENCDEC_ARCH} cross decode", LONG_ROWS, 1, wcfg.enc_frames, False, None, wheads),
    ):
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        kern = lambda q, k, v: FA.flash_attention_cuda(q, k, v, causal=causal, window=window)  # noqa: E731
        plain = lambda q, k, v: FA.flash_attention_torch(q, k, v, causal=causal, window=window)  # noqa: E731
        got, ref = kern(q, k, v), plain(q, k, v)
        torch.cuda.synchronize()
        ok, err = within(torch, got, ref, BF16_TOL)
        check(ok and got.shape == q.shape, f"flash_attention_cuda {label}: max err {err} over tol {BF16_TOL}")
        row_err = row_rel_err(got, ref)
        check(row_err <= FLASH_ROW_TOL,
              f"flash_attention_cuda {label}: a row off by {row_err:.3g} of its norm, over {FLASH_ROW_TOL}")
        t_k = time_ms(torch, kern, [(q, k, v)], 10)
        t_p = time_ms(torch, plain, [(q, k, v)], 3)
        # The library's call on its own (B, H, S, D) layout; its causal mask
        # is top-left aligned, so the suffix and the window pass theirs.
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        qi = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
        ki = torch.arange(sk, device="cuda")[None, :]
        mask = None
        if causal and (sq != sk or window is not None):
            mask = qi >= ki
            if window is not None:
                mask &= (qi - ki) < window
        is_causal = causal and mask is None
        sdpa = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, is_causal=is_causal, enable_gqa=True)
        lib = sdpa(qt, kt, vt).transpose(1, 2)
        torch.cuda.synchronize()
        _, lib_err = within(torch, lib, ref, BF16_TOL)
        t_l = time_ms(torch, sdpa, [(qt, kt, vt)], 10)
        pairs = visible_pairs(sq, sk, causal, window)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        b_ms, by = bound_ms(n_bytes, 4 * b * hq * d * pairs)
        row = {"kernel": "flash_attention_cuda", "label": label, "shape": [b, sq, sk, hq, hkv, d],
               "causal": causal, "window": window, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
               "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": by,
               "visible_pairs": pairs, "max_abs_err": err, "max_row_rel_err": row_err}
        rows.append(row)
        print(f"  flash_attention_cuda {label} B={b} Sq={sq} Sk={sk} H={hq}/{hkv} D={d} "
              f"causal={causal} window={window}: err {err:.3g} (row {row_err:.3g}) kernel {t_k:.4f} ms "
              f"plain {t_p:.4f} "
              f"sdpa {t_l:.4f} (err {lib_err:.3g}) bound {b_ms:.4f} ({by})", flush=True)
        if label == "layer":
            record = row
    detail["phase1_flash"] = rows
    n = cfg.n_layers  # one call a layer: the kernels line counts one forward
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), "ms": n * record["ms"],
            "plain_ms": n * record["plain_ms"], "library_ms": n * record["library_ms"],
            "bound_ms": n * record["bound_ms"], "bound_by": record["bound_by"],
            "cases": [{k: r[k] for k in ("label", "shape", "causal", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", "max_abs_err", "max_row_rel_err")}
                      for r in rows if r is not record]}


def grad_row_err(got, ref) -> float:
    """The largest ``|got - ref|`` over the rows (last axis) in L2, over the
    larger of the row's norm and ``ref``'s mean row norm (a query that sees
    one key has a dQ row of rounding noise)."""

    diff = (got.float() - ref.float()).norm(dim=-1)
    norms = ref.float().norm(dim=-1)
    return float((diff / norms.clamp_min(float(norms.mean()))).max())


def phase1_flash_training(torch) -> dict:
    """The training attention (``FlashAttentionFn``: the log-sum-exp forward
    and the two backward kernels) against its plain versions at the train
    cell's layer shape (internlm2-1.8b, ``TRAIN_ATTN_BATCH`` x
    ``TRAIN_ATTN_SEQ``, causal), zamba2's head dim 80 and whisper's
    non-causal encoder and cross-attention: dQ, dK, dV within
    ``FLASH_ROW_TOL`` of the plain backward row by row (``grad_row_err``),
    the output bitwise the inference kernel's, two backward calls bitwise
    equal.  At the train shape: a forward and a backward timed (CUDA
    events), the plain versions once, ``scaled_dot_product_attention``'s
    forward and backward as a yardstick (the port never calls it), and the
    bound: the forward's two products and the backward's five (dV, dP, dQ,
    dK and the recomputed S) at the bf16 peak."""

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA

    cfg, zcfg, wcfg = get_config(ARCH), get_config(HYBRID_ARCH), get_config(ENCDEC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(7)
    out: dict = {"cases": []}
    for label, b, sq, sk, causal, c in (
        ("train", TRAIN_ATTN_BATCH, TRAIN_ATTN_SEQ, TRAIN_ATTN_SEQ, True, cfg),
        (f"{HYBRID_ARCH} shared", 1, TRAIN_ATTN_SEQ, TRAIN_ATTN_SEQ, True, zcfg),
        (f"{ENCDEC_ARCH} encoder", 2, wcfg.enc_frames, wcfg.enc_frames, False, wcfg),
        (f"{ENCDEC_ARCH} cross", 2, DEC_CTX, wcfg.enc_frames, False, wcfg),
    ):
        hq, hkv, d = c.n_heads, c.n_kv_heads, c.head_dim
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def forward():
            return FA.flash_attention_cuda(*leaves, causal=causal)

        o = forward()
        grads = torch.autograd.grad(o, leaves, dout, retain_graph=True)
        again = torch.autograd.grad(o, leaves, dout, retain_graph=True)
        t0 = time.perf_counter()
        o_p, lse_p = FA.flash_attention_torch(q, k, v, causal=causal, with_lse=True)
        want = FA.flash_attention_bwd_torch(q, k, v, o_p, dout, lse_p, causal=causal)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = [grad_row_err(g, w) for g, w in zip(grads, want)]
        with torch.no_grad():
            inference = FA.flash_attention_cuda(q, k, v, causal=causal)
        check(torch.equal(o.detach(), inference), f"training forward {label}: output differs from inference's")
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"training backward {label}: two calls differ")
        check(max(errs) <= FLASH_ROW_TOL, f"training backward {label}: dq/dk/dv rows off by {errs}")
        case = {"label": label, "shape": [b, sq, sk, hq, hkv, d], "causal": causal, "row_err": errs}
        if label == "train":
            fwd_ms = time_ms(torch, lambda: forward(), [()], 10)
            bwd_ms = time_ms(torch, lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True), [()], 10)
            tq, tk, tv = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))

            def sdpa():
                y = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True, enable_gqa=True)
                return torch.autograd.grad(y, (tq, tk, tv), dout.transpose(1, 2))

            lib_ms = time_ms(torch, sdpa, [()], 10)
            fwd_flops = 4 * b * hq * d * visible_pairs(sq, sk, causal, None)
            n_bytes = (3 * q.numel() + 3 * k.numel() + 3 * v.numel() + 2 * q.numel()) * 2
            b_ms, by = bound_ms(n_bytes, 3.5 * fwd_flops)
            case.update(ms=fwd_ms + bwd_ms, forward_ms=fwd_ms, backward_ms=bwd_ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=b_ms, bound_by=by,
                        tflops=3.5 * fwd_flops / (fwd_ms + bwd_ms) / 1e9)
            out.update({k_: case[k_] for k_ in ("ms", "forward_ms", "backward_ms", "plain_ms", "library_ms",
                                                "bound_ms", "bound_by", "tflops", "shape")})
        out["cases"].append(case)
        print(f"  training attention {label} B={b} Sq={sq} Sk={sk} H={hq}/{hkv} D={d} causal={causal}: "
              f"dq/dk/dv rows {[round(e, 5) for e in errs]}, bitwise twice"
              + (f"; forward {case['forward_ms']:.3f} + backward {case['backward_ms']:.3f} ms "
                 f"({case['tflops']:.0f} TFLOP/s), plain {plain_ms:.1f}, sdpa {case['library_ms']:.3f}, "
                 f"bound {case['bound_ms']:.3f} ({case['bound_by']})" if "ms" in case else ""), flush=True)
    return out


def phase1_ssd(torch) -> dict:
    """The SSD scan kernels (``kernels/ssd.ssd_scan_cuda``: three forward
    launches, six backward) at the Mamba2 cell's layer (``SSD_SHAPE``) and
    at zamba2's d_state 64: the output, the final state and the five
    gradients against the plain versions (``ssd_fwd_torch`` /
    ``ssd_bwd_torch``, fp32 on the card) and against ``_ssd_chunked`` with
    its autograd, the route before, in relative L2; two backward calls
    bitwise equal.  At the cell's layer: the forward and the forward with
    its backward timed (CUDA events), ``_ssd_chunked``'s the same way, the
    plain versions once, and the bound ``portbench.families.ssm.ssd_bound_s``
    (the backward counted twice the forward, as ``ssd_roofline.train``
    counts it)."""

    from portbench.families import ssm as FS
    from repro_torch.configs import SSMConfig
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import ssm as S

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    gen = torch.Generator(device="cuda").manual_seed(11)
    out: dict = {"cases": []}
    rows_, seq_, heads_, groups_, n_cell, chunk_ = SSD_SHAPE
    for label, b, s, h, g, n, q in (("cell", *SSD_SHAPE), (f"{HYBRID_ARCH} d_state 64", 2, 2048, 80, 1, 64, 256)):
        bf = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
        x, Bm, Cm, dy = bf(b, s, h, 64), bf(b, s, g, n), bf(b, s, g, n), bf(b, s, h, 64)
        A = -(1.0 + 15.0 * torch.rand(h, generator=gen, device="cuda"))
        dt = torch.exp(math.log(1e-4) + (math.log(0.1) - math.log(1e-4))
                       * torch.rand((b, s, h), generator=gen, device="cuda"))
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        cfg = SSMConfig(d_model=h * 32, d_state=n, headdim=64, chunk=q)

        def kernel_step():
            y, _ = SSD.ssd_scan_cuda(*leaves, q)
            return (y,) + torch.autograd.grad(y, leaves, dy)

        def chunked_step():
            y, _ = S._ssd_chunked(*leaves, cfg)
            return (y,) + torch.autograd.grad(y, leaves, dy)

        got, again = kernel_step(), kernel_step()
        check(all(torch.equal(a, b_) for a, b_ in zip(got, again)), f"ssd scan {label}: two calls differ")
        t0 = time.perf_counter()
        y_p, _ = SSD.ssd_fwd_torch(x, dt, A, Bm, Cm, q)
        plain = (y_p,) + SSD.ssd_bwd_torch(x, dt, A, Bm, Cm, q, dy)[:5]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        chunked = chunked_step()
        names = ("y", "dx", "ddt", "dA", "dB", "dC")
        errs = {ref: {k: rel(a, w) for k, a, w in zip(names, got, want)}
                for ref, want in (("plain", plain), ("chunked", chunked))}
        for ref, e in errs.items():
            for k, v in e.items():
                tol = SSD_FP32_TOL if got[names.index(k)].dtype == torch.float32 else SSD_BF16_TOL
                check(v <= tol, f"ssd scan {label}: {k} off the {ref} version by {v}, over {tol}")
        case = {"label": label, "shape": [b, s, h, g, n, q], "rel_err": errs}
        if label == "cell":
            with torch.no_grad():
                fwd_ms = time_ms(torch, lambda: SSD.ssd_scan_cuda(x, dt, A, Bm, Cm, q), [()], 10)
                fwd_before = time_ms(torch, lambda: S._ssd_chunked(x, dt, A, Bm, Cm, cfg), [()], 3)
            step_ms = time_ms(torch, kernel_step, [()], 10)
            step_before = time_ms(torch, chunked_step, [()], 3)
            tags = dict(rows=b, seq=s, heads=h, headdim=64, d_state=n, groups=g, chunk=q)
            bound = 3 * FS.ssd_bound_s(tags, {"bf16_flops": PEAK_BF16, "hbm_bytes_per_s": HBM_BW}) * 1e3
            case.update(forward_ms=fwd_ms, ms=step_ms, backward_ms=step_ms - fwd_ms,
                        forward_before_ms=fwd_before, before_ms=step_before, plain_ms=plain_ms,
                        bound_ms=bound, roofline=bound / step_ms)
            out.update({k_: case[k_] for k_ in ("forward_ms", "ms", "backward_ms", "forward_before_ms",
                                                "before_ms", "plain_ms", "bound_ms", "roofline", "shape")})
        out["cases"].append(case)
        print(f"  ssd scan {label} B={b} S={s} H={h} G={g} N={n} Q={q}: "
              f"{ {ref: {k: f'{v:.1e}' for k, v in e.items()} for ref, e in errs.items()} }, bitwise twice"
              + (f"; forward {case['forward_ms']:.3f} ms (before {case['forward_before_ms']:.2f}), forward "
                 f"and backward {case['ms']:.3f} ms (before {case['before_ms']:.2f}), plain {plain_ms:.0f}, "
                 f"bound {case['bound_ms']:.4f} ({100 * case['roofline']:.2f}%)" if "ms" in case else ""),
              flush=True)
        del got, again, plain, chunked, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase7(torch, counts, reset) -> dict:
    """The full-sequence forward at full width: prefill logits, eval loss,
    the kernel against chunked_attention in place, and the decode replay."""

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.kernels import gemm as G
    from repro_torch.models import model_zoo as Z

    cfg = get_config(FWD_ARCH)
    t0 = time.perf_counter()
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (FWD_BATCH, FWD_SEQ), dtype=np.int32), device="cuda")
    big = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("big")
    check(big.backend() == "cuda", f"big class GEMM backend {big.backend()}")
    prefill, loss_fn = Z.make_prefill_fn(cfg), Z.make_loss_fn(cfg)
    per_fwd = {"gemm_cuda": 7 * cfg.n_layers + 1, "flash_attention_cuda": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()

    # The main path: one warm-up and three timed forwards, then the loss.
    reset()
    walls = []
    with big:
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
        prefill_launches = counts()["gemm_cuda"]
        prefill_flops = G.LAUNCH_FLOPS["gemm_cuda"]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = loss_fn(params, batch)
        torch.cuda.synchronize()
        loss_s = time.perf_counter() - t0
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall = sorted(walls)[1]
    print(f"phase 7: {cfg.name} forward logits {tuple(logits.shape)} {logits.dtype}; wall "
          f"{[round(w, 4) for w in walls]} s (median {wall:.4f} s, {FWD_BATCH * FWD_SEQ / wall:.0f} "
          f"tokens/s); loss {float(loss):.6f} (ln V = {math.log(cfg.vocab):.4f}) in {loss_s:.4f} s; "
          f"launches over 5 forwards {launches}; peak {peak_gb:.2f} GB; init {init_s:.1f} s",
          flush=True)
    for name, n in per_fwd.items():
        check(launches[name] == 5 * n, f"{name} launches {launches[name]} != 5 x {n}")
    check(launches["paged_attention_cuda"] == 0 and launches["gemm_cuda_lean"] == 0,
          f"the forward launched other kernels: {launches}")
    check(tuple(logits.shape) == (FWD_BATCH, FWD_SEQ, cfg.vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "forward logits not finite")
    check(math.isfinite(float(loss)) and abs(float(loss) - math.log(cfg.vocab)) < 3.0,
          f"eval loss {float(loss)} far from ln V = {math.log(cfg.vocab):.3f} for random weights")
    split = profile_run(torch, lambda: prefill(params, {"tokens": toks}), big)
    print(f"  one traced forward: wall {split['wall_ms']:.1f} ms, device busy {split['busy_ms']:.1f} ms "
          f"(idle {split['idle_share']:.3f}); device ms by kernel: "
          f"{ {k: round(v, 2) for k, v in split['ms'].items()} }; launches {split['count']}", flush=True)

    # The kernel in place: the same forward with chunked_attention.
    with big:
        t0 = time.perf_counter()
        ref = Z.make_prefill_fn(cfg, attn_backend="flash_attn_torch")(params, {"tokens": toks})
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
    diff = (logits.float() - ref.float()).abs()
    dmax, dmean = float(diff.max()), float(diff.mean())
    argmax_eq = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    del diff, ref
    print(f"  flash vs chunked_attention forward: max |logit diff| {dmax:.4f} (tol {LOGIT_TOL}), "
          f"mean {dmean:.5f}, equal argmax {argmax_eq:.4f}; chunked forward {chunked_s:.3f} s",
          flush=True)
    check(dmax <= LOGIT_TOL, f"flash vs chunked logits differ by {dmax}")

    # Forward against decode: row 0's first positions, token by token.
    state = Z.init_decode_state(cfg, 1, REPLAY_LEN, device="cuda")
    decode = Z.make_decode_fn(cfg)
    steps = []
    with torch.no_grad(), big:
        for t in range(REPLAY_LEN):
            lg, state = decode(params, {"tokens": toks[:1, t:t + 1]}, state, t)
            steps.append(float((lg[0, 0].float() - logits[0, t].float()).abs().max()))
    print(f"  decode replay vs forward, max |logit diff| per position: "
          f"{[round(x, 4) for x in steps]} (tol {LOGIT_TOL})", flush=True)
    check(all(math.isfinite(x) and x <= LOGIT_TOL for x in steps),
          f"decode vs forward logits differ by {max(steps)}")
    return {"arch": cfg.name, "batch": FWD_BATCH, "seq": FWD_SEQ, "walls_s": walls,
            "wall_s": wall, "tokens_per_s": FWD_BATCH * FWD_SEQ / wall, "loss": float(loss),
            "ce": float(metrics["ce"]), "loss_s": loss_s, "launches_5_forwards": launches,
            "gemm_launches_4_prefills": prefill_launches, "gemm_flops_4_prefills": prefill_flops,
            "launches_per_forward": per_fwd, "peak_gb": peak_gb, "init_s": init_s,
            "chunked_forward_s": chunked_s, "flash_vs_chunked_max": dmax,
            "flash_vs_chunked_mean": dmean, "flash_vs_chunked_argmax_equal": argmax_eq,
            "decode_replay_max": steps, "traced_forward": split}


def profile_run(torch, run, ctx) -> dict:
    """One run (a forward, a decode step) under ``torch.profiler``: its
    device busy time (the union of kernel intervals) and the device time by
    kernel family."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_decode import _union_us

    torch.cuda.synchronize()
    with ctx, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    check(bool(dev), "the profiler saw no device activity in the run")
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    ms, count, by_name = {}, {}, {}
    for e in dev:
        name = e.name.lower()
        fam = ("gemm_cuda" if "gemm_kernel<" in name else
               "flash_attention_cuda" if "flash_attention_kernel" in name else
               "paged_attention_cuda" if "paged_" in name else
               "library_gemm" if any(k in name for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")) else
               "other")
        ms[fam] = ms.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
        count[fam] = count.get(fam, 0) + 1
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "ms": ms, "count": count, "top_kernels_ms": [[n[:90], t] for n, t in top]}


def phase8(torch, counts, reset) -> dict:
    """One decode step of full-width internlm2-1.8b at a long cache: a paged
    state built directly (random bf16 K/V in every page, every row at the
    cache's last position; prefilling 4,096 tokens through the decode
    recurrence would take minutes), timed with CUDA-synchronised steps,
    traced once, and held to the same step through the gather route."""

    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.core import execution as X
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.kernels import gemm as G
    from repro_torch.models import model_zoo as Z

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    w = LONG_CACHE // LONG_PS
    state = Z.init_decode_state_paged(cfg, LONG_ROWS * w, LONG_PS, device="cuda")
    for key in ("pages_k", "pages_v"):
        state[key].normal_(generator=gen)
    table = torch.randperm(LONG_ROWS * w, generator=gen, device="cuda").reshape(LONG_ROWS, w).int()
    pos = torch.full((LONG_ROWS,), LONG_CACHE - 1, dtype=torch.int32, device="cuda")
    toks = torch.randint(0, cfg.vocab, (LONG_ROWS, 1), generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": toks, "page_table": table}
    big = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("big")
    decode = Z.make_decode_fn(cfg)

    def step():
        return decode(params, batch, state, pos)[0]  # rewrites position 4,095 with the same K/V

    def timed(n):
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return out, walls

    with torch.no_grad(), big:
        reset()
        step()  # warm-up
        logits, walls = timed(LONG_STEPS)
        launches = counts()
        gemm_flops = G.LAUNCH_FLOPS["gemm_cuda"]
        trace = profile_run(torch, step, big)
        # The same step with its attention through the gather route.
        with mock.patch.dict(X.BACKENDS, {"paged_attn_cuda": X.BACKENDS["paged_attn_torch"]}):
            step()
            ref, ref_walls = timed(3)
    check(launches["paged_attention_cuda"] == cfg.n_layers * (1 + LONG_STEPS),
          f"paged launches {launches['paged_attention_cuda']} != {cfg.n_layers} x {1 + LONG_STEPS}")
    check(tuple(logits.shape) == (LONG_ROWS, 1, cfg.vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "long-cache logits not finite")
    diff = float((logits.float() - ref.float()).abs().max())
    wall, ref_wall = sorted(walls)[len(walls) // 2], sorted(ref_walls)[1]
    paged_ms = trace["ms"].get("paged_attention_cuda", 0.0)
    print(f"phase 8: {cfg.name} decode step at a {LONG_CACHE}-token cache, {LONG_ROWS} rows: wall "
          f"{[round(x * 1e3, 2) for x in walls]} ms (median {wall * 1e3:.2f} ms, {LONG_ROWS / wall:.1f} "
          f"tokens/s), gather route {ref_wall * 1e3:.2f} ms; launches {launches}", flush=True)
    print(f"  one traced step: wall {trace['wall_ms']:.2f} ms, device busy {trace['busy_ms']:.2f} ms "
          f"(idle {trace['idle_share']:.3f}); device ms by kernel "
          f"{ {k: round(v, 3) for k, v in trace['ms'].items()} }, launches {trace['count']}; "
          f"paged attention {paged_ms:.3f} ms = {paged_ms / trace['busy_ms']:.3f} of the busy time", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"  kernel vs gather route: max |logit diff| {diff:.4f} (tol {LOGIT_TOL}); "
          f"phase 8 took {phase_s:.1f} s", flush=True)
    check(diff <= LOGIT_TOL, f"long-cache step: kernel vs gather route logits differ by {diff}")
    return {"arch": cfg.name, "phase_s": phase_s, "rows": LONG_ROWS, "cache": LONG_CACHE, "page_size": LONG_PS,
            "walls_s": walls, "wall_s": wall, "tokens_per_s": LONG_ROWS / wall,
            "steps_counted": 1 + LONG_STEPS, "gemm_cuda_flops": gemm_flops,
            "gather_walls_s": ref_walls, "gather_wall_s": ref_wall, "launches": launches,
            "traced_step": trace, "paged_device_share": paged_ms / trace["busy_ms"],
            "logit_diff_vs_gather": diff}


def phase9(torch, counts, reset, tok2) -> dict:
    """The measured loop: tune on the card, consume the cache, serve with
    the step-time probe feeding the DAS scheduler, calibrate the ratios."""

    import numpy as np

    from repro_torch import observability as OBS
    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.core.blocking import H100, MIN_PIPELINE_STAGES, BlockConfig, derive_block_config
    from repro_torch.core.control_tree import build_control_trees
    from repro_torch.kernels import gemm as G
    from repro_torch.models import model_zoo as Z
    from repro_torch.observability import report
    from repro_torch.tuning import cache as C
    from repro_torch.tuning import measure as M
    from repro_torch.tuning import tune
    from repro_torch.tuning.ratio import ClassMeasurement

    t_phase = time.perf_counter()
    out: dict = {}
    cfg, fcfg = get_config(ARCH), get_config(FWD_ARCH)
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    m_dec = mesh.n_pods * mesh.batch_layout(BATCH).c_max  # the engine's slot table
    # Distinct shapes only: a repeated one would be a cache hit, not a search.
    dec = list(dict.fromkeys((m_dec, k, n) for (k, n), _ in gemm_shapes(cfg)))
    fwd = list(dict.fromkeys((FWD_BATCH * FWD_SEQ, k, n) for (k, n), _ in gemm_shapes(fcfg)))
    os.makedirs(OUT_DIR, exist_ok=True)
    cache_path = os.path.join(OUT_DIR, "tuning_cache.json")
    if os.path.exists(cache_path):
        os.remove(cache_path)

    # (a) The two-stage search, timed on the card, into a fresh cache.
    searches = []
    for spec, shapes in (("h100", fwd + dec), ("h100-little", dec)):
        t0 = time.perf_counter()
        summary = tune.main(["--spec", spec, "--backend", "wallclock", "--two-stage", "on",
                             "--shapes", ",".join("x".join(map(str, s)) for s in shapes),
                             "--cache", cache_path])
        print(f"  tuned {spec}: {len(shapes)} shapes in {time.perf_counter() - t0:.1f} s", flush=True)
        for r in summary["shapes"]:
            check(not r["cache_hit"] and r["n_candidates"] > 0, f"{spec} {r['shape']}: no search ran")
            print(f"    {spec} {'x'.join(map(str, r['shape']))}: analytical "
                  f"{'x'.join(map(str, r['analytical']))} {r['analytical_time_s'] * 1e3:.4f} ms; "
                  f"winner {'x'.join(map(str, r['best']))} {r['best_backend']} "
                  f"{r['best_time_s'] * 1e3:.4f} ms ({r['speedup_vs_analytical']:.3f}x); "
                  f"{r['n_candidates']} timed, {r['n_pruned']} pruned, {r['search_s']:.2f} s", flush=True)
            searches.append({"spec": spec, **r})
    out["searches"] = searches
    cache = C.TuningCache.load(cache_path)
    check(len(cache.entries) == len(fwd) + 2 * len(dec), f"cache holds {len(cache.entries)} entries")

    # (b) Every winning block through its kernel against its plain version.
    gen = torch.Generator(device="cuda").manual_seed(9)
    for r in searches:
        mm, k, n = r["shape"]
        blk = BlockConfig(bm=r["best"][0], bk=r["best"][1], bn=r["best"][2])
        a = torch.randn((mm, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
        kern = G.GEMM_KERNELS[r["best_backend"]]
        got = kern(a, b, blk)
        ok, err = within(torch, got, G.gemm_plain(a, b, blk), BF16_TOL)
        check(ok, f"tuned {r['spec']} {mm}x{k}x{n} {blk} on {r['best_backend']}: max err {err}")
        both = blk.smem_bytes(MIN_PIPELINE_STAGES) <= H100.smem_bytes  # the pipelined ring holds it too
        if both:
            other = (G.gemm_cuda if r["best_backend"] == "cuda_lean" else G.gemm_cuda_lean)(a, b, blk)
            check(torch.equal(got, other), f"tuned block {blk}: lean != pipelined bitwise")
        r["max_abs_err"], r["bitwise_both"] = err, both
        del a, b, got
    print(f"  every tuned block within {BF16_TOL} of its plain version; lean == pipelined bitwise "
          f"where both run ({sum(r['bitwise_both'] for r in searches)} of {len(searches)})", flush=True)

    # (c) The cache consumed: trees, the tuned forward against the analytical.
    os.environ[C.ENV_VAR] = cache_path
    try:
        trees = {}
        for shape in dict.fromkeys(dec + fwd):
            rows = mesh.control_trees(shape)
            cols = build_control_trees({c.name: c.spec for c in mesh.classes}, *shape,
                                       backend="cuda", coarse_loop="cols")
            for name, tree in rows.items():
                held = cache.get(tree.spec.name, "bfloat16", *shape)
                if held is None:
                    continue
                # Loop 3 honours another class's entry only at the anchor's bk.
                want = "tuned" if name == "big" or held.bk == rows["big"].block.bk else "analytical"
                check(tree.block_source == want, f"{name} tree at {shape}: {tree.block_source}, want {want}")
                check(cols[name].block_source == "tuned", f"{name} cols tree at {shape} not tuned")
            trees["x".join(map(str, shape))] = {
                n: [t.block_source, [t.block.bm, t.block.bk, t.block.bn], t.backend]
                for n, t in rows.items()}
        print(f"  control trees (rows): {trees}", flush=True)
        out["trees"] = trees

        params = Z.init_params(fcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, fcfg.vocab, (FWD_BATCH, FWD_SEQ), dtype=np.int32), device="cuda")
        prefill = Z.make_prefill_fn(fcfg)
        big = mesh.execution_context("big")
        blocks = {s: (big.block_config(*s, "bfloat16", 2),
                      derive_block_config(*s, spec=big.spec)) for s in fwd}
        print("  forward blocks (tuned / analytical): "
              f"{ {'x'.join(map(str, s)): [[t.bm, t.bk, t.bn], [a.bm, a.bk, a.bn]] for s, (t, a) in blocks.items()} }",
              flush=True)
        # The host's cost of a lookup: every GEMM call asks the cache.
        t0 = time.perf_counter()
        for _ in range(1000):
            os.stat(cache_path)
        stat_us = (time.perf_counter() - t0) * 1e3
        lookup_us = {}
        for label in ("tuned", "analytical"):
            if label == "tuned":
                os.environ[C.ENV_VAR] = cache_path
            else:
                os.environ.pop(C.ENV_VAR, None)
            t0 = time.perf_counter()
            for _ in range(200):
                for s in fwd:
                    big.block_config(*s, "bfloat16", 2)
            lookup_us[label] = (time.perf_counter() - t0) / (200 * len(fwd)) * 1e6
        print(f"  host cost: os.stat of the cache file {stat_us:.2f} us; a GEMM call's block "
              f"lookup {lookup_us['tuned']:.2f} us tuned, {lookup_us['analytical']:.2f} us analytical",
              flush=True)
        out["host_us"] = {"stat": stat_us, "lookup": lookup_us}

        def forward(label: str):
            # "tuned-stat" re-checks the cache file's mtime on every lookup,
            # as the cache did before STAT_INTERVAL_S: the lookup's host cost.
            C.STAT_INTERVAL_S = 0.0 if label == "tuned-stat" else interval
            if label == "analytical":
                os.environ.pop(C.ENV_VAR, None)
            else:
                os.environ[C.ENV_VAR] = cache_path
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad(), big:
                logits = prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(counts()["gemm_cuda"] == 7 * fcfg.n_layers + 1, f"forward GEMM launches {counts()}")
            return logits, wall

        interval = C.STAT_INTERVAL_S
        arms = ("tuned", "analytical", "tuned-stat")
        for label in arms:  # warm-up
            forward(label)
        walls = {label: [] for label in arms}
        logits = {}
        for i in range(3):
            for label in (arms if i % 2 == 0 else arms[::-1]):
                logits[label], w = forward(label)
                walls[label].append(w)
        C.STAT_INTERVAL_S = interval
        diff = float((logits["tuned"].float() - logits["analytical"].float()).abs().max())
        med = {k: sorted(v)[1] for k, v in walls.items()}
        print(f"  {FWD_ARCH} forward {FWD_BATCH} x {FWD_SEQ}: "
              + "; ".join(f"{k} {[round(w * 1e3, 2) for w in v]} ms (median {med[k] * 1e3:.2f})"
                          for k, v in walls.items())
              + f"; max |logit diff| tuned vs analytical {diff:.4f} (tol {LOGIT_TOL})", flush=True)
        check(diff <= LOGIT_TOL, f"tuned vs analytical forward logits differ by {diff}")
        out["forward"] = {"walls_s": walls, "median_s": med, "logit_diff": diff,
                          "blocks": {"x".join(map(str, s)): [[t.bm, t.bk, t.bn], [a.bm, a.bk, a.bn]]
                                     for s, (t, a) in blocks.items()}}
        del params, logits
        gc.collect()
        torch.cuda.empty_cache()

        # PERF.md's open question: 128 x 128 or 128 x 256 at 4096 x 3072 x 1024.
        shape = (FWD_BATCH * FWD_SEQ, fcfg.d_model, fcfg.n_kv_heads * fcfg.head_dim)
        ana = derive_block_config(*shape)
        wide = BlockConfig(bm=128, bk=ana.bk, bn=256)
        q7 = {}
        for label, blk in (("analytical", ana), ("128x256", wide), ("analytical", ana), ("128x256", wide)):
            q7.setdefault(label, []).append(M.wallclock_time(*shape, blk, device="cuda"))
        print(f"  {'x'.join(map(str, shape))}: analytical {ana.bm}x{ana.bk}x{ana.bn} "
              f"{[round(t * 1e3, 4) for t in q7['analytical']]} ms, {wide.bm}x{wide.bk}x{wide.bn} "
              f"{[round(t * 1e3, 4) for t in q7['128x256']]} ms (device time)", flush=True)
        out["question_128x128_vs_128x256"] = {"shape": list(shape), "analytical": [ana.bm, ana.bk, ana.bn],
                                               "ms": {k: [t * 1e3 for t in v] for k, v in q7.items()}}

        # (d) The traced engine: the probe measures on the card, the DAS
        # scheduler observes, the tokens stay phase 2's.
        os.environ[C.ENV_VAR] = cache_path
        trace_path = os.path.join(OUT_DIR, "serve_trace.json")
        metrics_path = os.path.join(OUT_DIR, "serve_metrics.json")
        reset()
        summary, tok9, eng, wall9 = run_serve(
            ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
             "--gen-len", str(GEN_LEN), "--seed", "0", "--trace", trace_path, "--metrics", metrics_path])
        launches = counts()
    finally:
        os.environ.pop(C.ENV_VAR, None)
    check(not OBS.enabled(), "tracing still on after the traced serve")
    probe = eng.pod_time_hook
    sched = eng.asym.scheduler
    with open(metrics_path) as f:
        snap = json.load(f)
    fams = ("engine_queue_depth", "engine_slot_occupancy", "engine_admissions_total",
            "engine_tokens_total", "engine_tokens_per_s", "engine_decode_step_seconds",
            "probe_refreshes_total", "probe_row_seconds")
    missing = [f for f in fams if f not in snap]
    check(not missing, f"metrics snapshot lacks {missing}")
    row_s = {s["labels"]["device_class"]: s["value"] for s in snap["probe_row_seconds"]["samples"]}
    refreshes = snap["probe_refreshes_total"]["samples"][0]["value"]
    events, _ = report.load_events(trace_path)
    summ = report.summarize(events)
    spans = sorted({e["name"] for e in events})
    same = bool(np.array_equal(tok9, tok2))
    print(f"  traced engine: {summary['tokens_per_s']} tokens/s smoke reading, wall {wall9:.2f} s; "
          f"probe refreshes {refreshes:g}, row seconds {row_s}; scheduler rates "
          f"{[round(float(r), 4) for r in sched.rates]}, drift {sched.drift():.4f}, rebalances "
          f"{eng.stats.rebalances}; launches {launches}; tokens equal phase 2: {same}", flush=True)
    check(probe.refreshes > 0 and refreshes > 0, "the probe never refreshed on the card")
    check({"big", "little"} <= set(row_s) and all(v > 0 for v in row_s.values()),
          f"probe_row_seconds per class: {row_s}")
    check(launches["gemm_cuda_lean"] > 0, "the probe never launched gemm_cuda_lean under little")
    check(summary.get("trace") == trace_path and summary.get("metrics") == metrics_path,
          "serve summary lacks its trace/metrics paths")
    check("engine.decode_step" in summ and "probe.refresh" in summ,
          f"report.summarize of the trace lacks the engine's and the probe's spans: {spans}")
    check(same, "the traced, tuned engine's tokens differ from phase 2's")

    # (e) The ratios: typed, cost model, and the probe's measurement.
    classes = biglittle_classes(chips_per_pod=1)
    cost = AsymmetricMesh.from_calibration(classes, backend="cost-model", batch_tile=1)
    rows = probe.probe_shape[0]
    measured = AsymmetricMesh.from_calibration(
        classes, backend="wallclock", batch_tile=1, probe_shape=probe.probe_shape,
        measurements=[ClassMeasurement(c, rows, probe.last_measured[c]) for c in ("big", "little")])
    ratios = {"typed": [c.rel_throughput for c in classes], "cost-model": list(cost.calibration.ratios),
              "probe": list(measured.calibration.ratios)}
    print(f"  little/big ratio: typed {ratios['typed'][1]}, cost model {ratios['cost-model'][1]:.4f}, "
          f"probe {ratios['probe'][1]:.4f} (probe seconds at {'x'.join(map(str, probe.probe_shape))}: "
          f"{ {k: round(v * 1e6, 2) for k, v in probe.last_measured.items()} } us)", flush=True)
    out.update({"serve": summary, "serve_wall_s": wall9, "tokens_equal_phase2": same,
                "probe_row_seconds": row_s, "probe_refreshes": refreshes,
                "probe_seconds": probe.last_measured, "scheduler_rates": [float(r) for r in sched.rates],
                "drift": sched.drift(), "rebalances": eng.stats.rebalances, "launches": launches,
                "report_spans": spans, "ratios": ratios,
                "phase_s": time.perf_counter() - t_phase})
    print(f"  phase 9 took {out['phase_s']:.1f} s", flush=True)
    return out


def phase5(torch, tokens) -> dict:
    """Teacher-forced replay of ``tokens`` (the dense engine's): the max
    |logit difference| at every generated step of the paged path and of
    the little class's tree against the dense big-class path."""

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.models import model_zoo as Z
    from repro_torch.runtime.paging import divisor_page_size

    cfg = get_config(ARCH)
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    decode = Z.make_decode_fn(cfg)
    b, total = tokens.shape
    ps = divisor_page_size(total, PAGE_SIZE)
    w = total // ps
    toks = torch.as_tensor(tokens, device="cuda")

    def logits(cls, paged):
        if paged:
            state = Z.init_decode_state_paged(cfg, b * w, ps, device="cuda")
            extra = {"page_table": torch.arange(b * w, dtype=torch.int32,
                                                device="cuda").reshape(b, w)}
        else:
            state, extra = Z.init_decode_state(cfg, b, total, device="cuda"), {}
        out = []
        with torch.no_grad(), mesh.execution_context(cls):
            for t in range(total - 1):
                lg, state = decode(params, dict(extra, tokens=toks[:, t:t + 1]), state, t)
                if t >= PROMPT_LEN - 1:
                    out.append(lg[:, 0].float())
        return out

    want = logits("big", paged=False)
    diffs = {}
    for label, cls, paged in (("paged", "big", True), ("little", "little", False)):
        got = logits(cls, paged)
        diffs[label] = [float((g - r).abs().max()) for g, r in zip(got, want)]
        print(f"  {label} vs dense, max |logit diff| per generated step: "
              f"{[round(x, 4) for x in diffs[label]]} (tol {LOGIT_TOL})", flush=True)
        check(all(math.isfinite(x) and x <= LOGIT_TOL for x in diffs[label]),
              f"{label} vs dense logits differ by {max(diffs[label])}")
    return diffs


def phase6(torch) -> dict:
    """The port on the card against the port on the CPU, on a small input:
    the reduced model's prefill logits through the CUDA kernels (each
    class's GEMM, dense and paged attention) within the bf16 tolerance of
    the same code's plain versions on the CPU, same weights."""

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.models import model_zoo as Z

    cfg = get_config(ARCH).reduced()
    b, plen, ps = 4, 8, 4
    weights = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on = lambda tree, dev: ({k: on(v, dev) for k, v in tree.items()}  # noqa: E731
                            if isinstance(tree, dict) else tree.to(dev))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (b, plen), dtype=np.int32)
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1, backend="cuda")
    prefill = Z.make_prefill_fn(cfg, with_cache=True)

    def logits(device, cls, paged):
        batch = {"tokens": torch.as_tensor(prompts, device=device)}
        if paged:
            state = Z.init_decode_state_paged(cfg, b * plen // ps, ps, device=device)
            batch["page_table"] = torch.arange(b * plen // ps, dtype=torch.int32,
                                               device=device).reshape(b, plen // ps)
        else:
            state = Z.init_decode_state(cfg, b, plen, device=device)
        with torch.no_grad(), mesh.execution_context(cls):
            out, _ = prefill(on(weights, device), batch, state, 0)
        return out

    errs = {}
    for cls in ("big", "little"):
        want = logits("cpu", cls, paged=False)
        for paged in (False, True):
            got = logits("cuda", cls, paged)
            torch.cuda.synchronize()
            ok, err = within(torch, got.cpu(), want, BF16_TOL)
            label = f"{cls}{' paged' if paged else ''}"
            print(f"  {label}: prefill logits {tuple(got.shape)} max err vs CPU {err:.4g}", flush=True)
            check(ok and got.shape == (b, 1, cfg.vocab), f"{label}: card vs CPU logits err {err}")
            errs[label] = err
    return errs


def run_serve(argv, params=None):
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    summary, tokens, engine = serve.serve(serve.build_parser().parse_args(argv), params=params)
    return summary, tokens, engine, time.perf_counter() - t0


class RouteLog:
    """Records every MoE routing (``moe.route``'s outputs, and its top-k
    expert ids as ``calls``) made while it is entered, call by call.  Given
    ``shared``, another log, it routes nothing itself and hands out that
    log's routings in order: the two runs then share their routing."""

    def __init__(self, shared: "RouteLog" = None):
        self.shared = shared

    def __enter__(self):
        from unittest import mock

        from repro_torch.models import moe as M

        self.calls, self.routes = [], []
        real = M.route
        given = iter(self.shared.routes) if self.shared is not None else None

        def route(p, x, cfg):
            out = next(given) if given is not None else real(p, x, cfg)
            self.routes.append(out)
            self.calls.append(out[1].cpu().numpy())
            return out

        self._patch = mock.patch.object(M, "route", route)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def comparable(want_calls, got_calls, steps: int, cap: int, n_experts: int):
    """The routing-aware rule.  ``*_calls``: (groups, tokens, k) expert ids
    in call order (``steps`` x layers calls).  A token depends on its own
    row's decisions at this step and the earlier ones, and, through the
    capacity positions (counted in group order), on the decisions before
    it in its group, but only where some expert's decisions exceed the
    capacity ``cap``.  So a token is comparable if its own decisions agreed
    in every layer at every step so far and no expert overflowed in its
    group in either route, or if no decision before it in its group (at
    this step or an earlier one) differs.  Returns the share of agreeing
    decisions, the (steps, groups, tokens) mask of comparable tokens, and
    the mask of tokens whose own decisions agreed in every layer at that
    step."""

    import numpy as np

    want, got = np.stack(want_calls), np.stack(got_calls)  # (calls, G, T, k)
    agree = want == got
    g, t = agree.shape[1:3]
    own = agree.all(-1).reshape(steps, -1, g, t).all(1)  # (steps, G, T)
    first = np.where(own.all(-1), t, np.argmin(own, axis=-1))
    first = np.minimum.accumulate(first, axis=0)
    prefix = np.arange(t)[None, None, :] < first[..., None]

    def overflow(idx):  # (steps, G): an expert chose past its capacity in some layer
        counts = (idx[..., None] == np.arange(n_experts)).sum(axis=(2, 3))  # (calls, G, E)
        return (counts > cap).any(-1).reshape(steps, -1, g).any(1)

    clean = np.logical_and.accumulate(~(overflow(want) | overflow(got)), axis=0)
    own_so_far = np.logical_and.accumulate(own, axis=0)
    mask = prefix | (own_so_far & clean[..., None])
    return float(agree.mean()), mask, own


def phase10(torch) -> dict:
    """The energy objectives on the full-width internlm2-1.8b: perf, energy
    and edp on 3 requests over 2 x ENERGY_SLOTS slots, then a load of 16."""

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as Z

    cfg = get_config(ARCH)
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    base = ["--arch", ARCH, "--batch", str(ENERGY_BATCH), "--prompt-len", str(PROMPT_LEN),
            "--gen-len", str(GEN_LEN), "--seed", "0", "--slots-per-pod", str(ENERGY_SLOTS)]
    runs, engines, toks = {}, {}, {}
    for obj in ("perf", "energy", "edp"):
        summary, tok, eng, wall = run_serve(base + ["--objective", obj], params=params)
        e = summary["engine"]
        runs[obj] = {k: e[k] for k in ("energy_j", "tokens_per_j", "modeled_decode_s", "tokens",
                                       "pod_parks", "pod_unparks", "parked_pods")}
        runs[obj].update(objective=summary["objective"], wall_s=wall,
                         pods=sorted({c.pod for c in eng.completions}))
        engines[obj], toks[obj] = eng, tok
        print(f"  {obj}: modeled {e['energy_j']:.6g} J over {e['tokens']} tokens "
              f"({e['tokens_per_j']} tokens/J, modeled), parks {e['pod_parks']}, unparks "
              f"{e['pod_unparks']}, parked {e['parked_pods']}, served on pods {runs[obj]['pods']}; "
              f"wall {wall:.2f} s", flush=True)
        check(summary["objective"] == obj, f"summary objective {summary['objective']}")
    perf, energy = runs["perf"], runs["energy"]
    check(perf["pod_parks"] == 0 and perf["parked_pods"] == [], f"perf parked: {perf}")
    check(energy["pod_parks"] >= 1 and energy["parked_pods"] == [0], f"energy did not park pod 0: {energy}")
    check(0 < energy["energy_j"] < perf["energy_j"], f"energy joules {energy['energy_j']} !< perf's {perf['energy_j']}")
    check(energy["tokens_per_j"] > perf["tokens_per_j"], "energy tokens/J not above perf's")
    for obj in ("energy", "edp"):
        check(np.array_equal(toks[obj], toks["perf"]), f"{obj} tokens differ from perf's")

    # Load ramps: 16 requests on the energy engine's 2 x ENERGY_SLOTS slots.
    eng = engines["energy"]
    more = np.random.default_rng(1).integers(0, cfg.vocab, (16, PROMPT_LEN), dtype=np.int32)
    out = eng.generate(more, GEN_LEN)
    print(f"  energy engine under 16 requests: parks {eng.stats.pod_parks}, unparks "
          f"{eng.stats.pod_unparks}, parked now {eng.parked_pods}; modeled {eng.stats.energy_j:.6g} J",
          flush=True)
    check(out.shape == (16, PROMPT_LEN + GEN_LEN) and bool((out[:, PROMPT_LEN:] >= 0).all()),
          f"loaded run tokens {out.shape}")
    check(eng.stats.pod_unparks >= 1, "16 requests did not un-park the big pod")
    runs["loaded"] = {"pod_parks": eng.stats.pod_parks, "pod_unparks": eng.stats.pod_unparks,
                      "energy_j": eng.stats.energy_j, "parked_pods": eng.parked_pods}
    return runs


def phase11(torch, counts, reset) -> dict:
    """qwen2-moe-a2.7b at full width: the dense and paged engines, the
    one-shot little path, engine == one-shot, the routing-aware replay, and
    where a decode step's device time goes against the expert-bytes bound."""

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as Z

    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = tree_bytes(params) / 1e9
    print(f"  {cfg.name}: {weights_gb:.2f} GB of weights, init {init_s:.1f} s", flush=True)
    per_step = sum(c for _, c in gemm_shapes(cfg))
    check(per_step == 7 * cfg.n_layers + 1, f"{per_step} GEMMs a step")
    base = ["--arch", MOE_ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--gen-len", str(GEN_LEN), "--seed", "0"]
    out: dict = {"weights_gb": weights_gb, "init_s": init_s}

    # The dense engine: every GEMM of the recurrence on gemm_cuda.
    reset()
    sd, tokd, engd, walld = run_serve(base, params=params)
    cd = counts()
    stepsd = PROMPT_LEN * engd.stats.admission_rounds + engd._step_calls
    print(f"  dense engine: smoke reading {sd['tokens_per_s']} tokens/s, warm-up {sd['compile_s']} s, "
          f"wall {walld:.2f} s; launches {cd}; recurrence steps {stepsd}", flush=True)
    check(sd["exec_backend"] == "cuda", f"dense engine ran {sd['exec_backend']}")
    check(cd["gemm_cuda"] == per_step * stepsd, f"gemm_cuda launches {cd['gemm_cuda']} != {per_step} x {stepsd}")
    check(cd["gemm_cuda_lean"] == cd["paged_attention_cuda"] == cd["flash_attention_cuda"] == 0,
          f"the dense engine launched other kernels: {cd}")
    check(tokd.shape == (BATCH, PROMPT_LEN + GEN_LEN) and bool(((tokd >= 0) & (tokd < cfg.vocab)).all()),
          f"dense tokens {tokd.shape}")
    check(bool(torch.isfinite(engd.prefill_logits.float()).all()), "dense engine logits not finite")

    # The paged engine: paged_attention_cuda at a group of 1, a private
    # phantom lane a slot.
    reset()
    sp, tokp, engp, wallp = run_serve(base + ["--paged", "on", "--page-size", str(PAGE_SIZE)], params=params)
    cp = counts()
    stepsp = PROMPT_LEN * engp.stats.admission_rounds + engp._step_calls
    kv = sp["engine"]["kv_pool"]
    print(f"  paged engine: smoke reading {sp['tokens_per_s']} tokens/s, wall {wallp:.2f} s; launches {cp}; "
          f"{kv['pages_per_slot']} pages of {kv['page_size']} a slot, {kv['phantom_pages']} phantom pages "
          f"for {engp.n_slots} slots", flush=True)
    check(cp["paged_attention_cuda"] == cfg.n_layers * stepsp,
          f"paged launches {cp['paged_attention_cuda']} != {cfg.n_layers} x {stepsp}")
    check(cp["gemm_cuda"] == per_step * stepsp, "paged engine GEMM launches")
    check(kv["phantom_pages"] == engp.n_slots * kv["pages_per_slot"], f"phantom pages {kv}")
    agree_p = float((tokp[:, PROMPT_LEN:] == tokd[:, PROMPT_LEN:]).mean())

    # The one-shot path under the little class's tree.
    reset()
    sl, tokl, _, walll = run_serve(base + ["--one-shot", "--device-class", "little"], params=params)
    cl = counts()
    agree_l = float((tokl[:, PROMPT_LEN:] == tokd[:, PROMPT_LEN:]).mean())
    print(f"  one-shot little ({sl['exec_backend']}): smoke reading {sl['tokens_per_s']} tokens/s, wall "
          f"{walll:.2f} s; launches {cl}; equal generated tokens vs dense: paged {agree_p:.3f}, "
          f"little {agree_l:.3f}", flush=True)
    check(sl["exec_backend"] == "cuda_lean", f"little ran {sl['exec_backend']}")
    check(cl["gemm_cuda_lean"] == per_step * (PROMPT_LEN + GEN_LEN), f"lean launches {cl['gemm_cuda_lean']}")

    # The engine against the one-shot path over the padded batch (the
    # engine's slot table; capacity routing couples its rows), big class.
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    padded, order = serve.pad_requests(tokd[:, :PROMPT_LEN], mesh.batch_layout(BATCH))
    with mesh.execution_context("big"):
        ref, _ = serve.generate(cfg, params, padded, GEN_LEN, PROMPT_LEN + GEN_LEN, device="cuda")
    same = bool(np.array_equal(ref[order], tokd))
    print(f"  engine == one-shot over the padded batch ({padded.shape[0]} rows): {same}", flush=True)
    check(same, "the engine's tokens differ from the one-shot path's over the padded batch")

    replay, state = moe_replay(torch, cfg, params, ref, mesh)
    out.update({"dense": sd, "paged": sp, "one_shot_little": sl, "walls_s": [walld, wallp, walll],
                "launches": {"dense": cd, "paged": cp, "one_shot_little": cl},
                "recurrence_steps": {"dense": stepsd, "paged": stepsp},
                "token_agreement": {"paged": agree_p, "little": agree_l},
                "engine_equals_one_shot": same, "replay": replay})
    out["device"] = moe_step_time(torch, cfg, params, state, ref, mesh)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 11 took {out['phase_s']:.1f} s", flush=True)
    return out


def moe_replay(torch, cfg, params, tokens, mesh):
    """Teacher-forced replay of ``tokens`` (the padded batch's 12 rows),
    the paged path and the little class's tree against the dense big-class
    path at every generated step, two ways.  *Free*: each path decodes the
    tokens on its own state (phase 5's method); a routing flip then carries
    through that path's caches into every later step.  *Forced*: at each
    generated step the two paths also take the step from a copy of the
    dense path's state (the paged arena laid out as the dense lanes), so
    only that step's arithmetic can differ.  Routing-aware rule throughout
    (:func:`comparable`).  Returns the record and the dense final state."""

    from repro_torch.models import model_zoo as Z
    from repro_torch.models import moe as M
    from repro_torch.runtime.paging import divisor_page_size

    decode = Z.make_decode_fn(cfg)
    b, total = tokens.shape
    nl, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    ps = divisor_page_size(total, PAGE_SIZE)
    w = total // ps
    cap, n_e = M._capacity(b, cfg.moe), cfg.moe.n_experts
    toks = torch.as_tensor(tokens, device="cuda")
    # Page r·w + j holds slots [j·ps, (j+1)·ps) of row r: the dense lanes' order.
    table = torch.arange(b * w, dtype=torch.int32, device="cuda").reshape(b, w)
    paths = (("paged", "big", True), ("little", "little", False))

    def as_state(dense, paged):
        if not paged:
            return {k: v.clone() for k, v in dense.items()}
        return {"pages_" + k: v.reshape(nl, b * w, ps, hkv, dh).clone() for k, v in dense.items()}

    def step(cls, paged, state, t):
        extra = {"page_table": table} if paged else {}
        with mesh.execution_context(cls):
            lg, _ = decode(params, dict(extra, tokens=toks[:, t:t + 1]), state, t)
        return lg[:, 0].float()

    dense = Z.init_decode_state(cfg, b, total, device="cuda")
    free = {label: as_state(dense, paged) for label, _, paged in paths}
    logs = {k: [] for k in ("dense", "paged", "little")}
    rec = {label: {"forced": [], "free_diff": [], "shared_diff": []} for label, _, _ in paths}
    with torch.no_grad():
        for t in range(total - 1):
            before = {k: v.clone() for k, v in dense.items()} if t >= PROMPT_LEN - 1 else None
            with RouteLog() as rd:
                want = step("big", False, dense, t)
            logs["dense"].extend(rd.calls)
            for label, cls, paged in paths:
                with RouteLog() as rf:
                    got = step(cls, paged, free[label], t)
                logs[label].extend(rf.calls)
                if before is None:
                    continue
                rec[label]["free_diff"].append((got - want).abs().amax(dim=-1).cpu().numpy())
                with RouteLog() as rg:
                    forced = step(cls, paged, as_state(before, paged), t)
                share, mask, _ = comparable(rd.calls, rg.calls, 1, cap, n_e)
                d = (forced - want).abs().amax(dim=-1).cpu().numpy()
                rows = mask[0, 0]
                rec[label]["forced"].append({"step": t, "route_agree": share, "compared": int(rows.sum()),
                                             "max_logit_diff": float(d[rows].max()) if rows.any() else None})
                with RouteLog(shared=rd):  # the dense step's own routing, shared
                    shared = step(cls, paged, as_state(before, paged), t)
                rec[label]["shared_diff"].append(float((shared - want).abs().max()))
    for label, _, _ in paths:
        steps = total - 1
        share, mask, own = comparable(logs["dense"], logs[label], steps, cap, n_e)
        gen = mask[PROMPT_LEN - 1:, 0]  # (generated steps, rows)
        free_d = [float(d[m].max()) if m.any() else None for d, m in zip(rec[label]["free_diff"], gen)]
        forced = rec[label]["forced"]
        f_share = sum(f["route_agree"] for f in forced) / len(forced)
        f_cmp = sum(f["compared"] for f in forced)
        f_diff = [f["max_logit_diff"] for f in forced]
        s_diff = rec[label].pop("shared_diff")
        rec[label].update({"free_route_agree": share, "free_compared": int(gen.sum()),
                           "free_max_logit_diff": free_d, "forced_route_agree": f_share,
                           "forced_compared": f_cmp, "shared_route_max_logit_diff": s_diff,
                           "tokens": int(gen.size)})
        del rec[label]["free_diff"]
        fmt = lambda xs: [None if x is None else round(x, 4) for x in xs]  # noqa: E731
        print(f"  replay {label} vs dense, free (each path on its own caches): {share:.4f} of the "
              f"routing decisions agree; {int(gen.sum())} of {gen.size} generated tokens comparable, "
              f"max |logit diff| per step {fmt(free_d)}", flush=True)
        print(f"  replay {label} vs dense, forced (each step from the dense path's state): "
              f"{f_share:.4f} of the decisions agree (least accepted {MIN_ROUTE_AGREE}); {f_cmp} of "
              f"{gen.size} tokens comparable, max |logit diff| per step {fmt(f_diff)} (tol {LOGIT_TOL}); "
              f"with the dense step's routing shared, every token: {fmt(s_diff)}", flush=True)
        for what, x in (("free", share), ("forced", f_share)):
            check(x >= MIN_ROUTE_AGREE, f"replay {label} ({what}): routing agrees on {x} < {MIN_ROUTE_AGREE}")
        for what, xs in (("free", free_d), ("forced", f_diff), ("shared routing", s_diff)):
            check(all(x is None or (math.isfinite(x) and x <= LOGIT_TOL) for x in xs),
                  f"replay {label} ({what}): logits differ by {fmt(xs)} (tol {LOGIT_TOL})")
    return rec, dense


def moe_step_time(torch, cfg, params, state, tokens, mesh) -> dict:
    """One dense decode step of the 12-row slot table: CUDA-synchronised
    walls, one ``torch.profiler`` trace, and the expert einsums alone (72
    batched products over every expert) against the expert-bytes bound."""

    from repro_torch.models import model_zoo as Z

    decode = Z.make_decode_fn(cfg)
    b, total = tokens.shape
    toks = torch.as_tensor(tokens[:, -1:], device="cuda")
    big = mesh.execution_context("big")

    def step():
        return decode(params, {"tokens": toks}, state, total - 1)[0]  # rewrites the last position

    walls = []
    with torch.no_grad(), big:
        step()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        trace = profile_run(torch, step, big)
    from repro_torch.models import moe as M

    moe, e, d, f = params["blocks"]["moe"], cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    cap = M._capacity(b, cfg.moe)  # the step's rows route as one group
    buf = torch.randn((e, cap, d), device="cuda").to(torch.bfloat16)

    def experts():
        for i in range(cfg.n_layers):
            h = torch.bmm(buf, moe["w1"][i]) * torch.bmm(buf, moe["w3"][i])
            torch.bmm(h, moe["w2"][i])

    expert_ms = time_ms(torch, experts, [()], 5, 1)
    expert_bytes = cfg.n_layers * 3 * e * d * f * 2
    bound = expert_bytes / HBM_BW * 1e3
    wall = sorted(walls)[1]
    lib = trace["ms"].get("library_gemm", 0.0)
    print(f"  one dense decode step, 12 rows: wall {[round(x * 1e3, 2) for x in walls]} ms; traced wall "
          f"{trace['wall_ms']:.2f} ms, device busy {trace['busy_ms']:.2f} ms (idle {trace['idle_share']:.3f}); "
          f"device ms by kernel {({k: round(v, 3) for k, v in trace['ms'].items()})}, launches "
          f"{trace['count']}; cuBLAS products (the expert einsums, the router's and the shared gate's) "
          f"{lib:.3f} ms = {lib / trace['busy_ms']:.3f} of the busy time", flush=True)
    print(f"  the 72 expert einsums alone: {expert_ms:.3f} ms (CUDA events) against their bytes bound "
          f"{bound:.3f} ms ({expert_bytes / 1e9:.2f} GB at {HBM_BW / 1e12:.2f} TB/s): "
          f"{bound / expert_ms:.3f} of the bound; the step's device busy time is "
          f"{trace['busy_ms'] / bound:.2f}x the bound, its wall {wall * 1e3 / bound:.2f}x", flush=True)
    check(trace["busy_ms"] > 0 and math.isfinite(expert_ms), "no device time for the MoE step")
    return {"walls_s": walls, "wall_s": wall, "traced_step": trace, "library_gemm_ms": lib,
            "expert_einsums_ms": expert_ms, "expert_bytes": expert_bytes, "expert_bound_ms": bound}


def phase12(torch, counts, reset) -> dict:
    """Ring decode at mixtral-8x7b's full widths, RING_LAYERS layers: one
    step of 12 rows at RING_POS on a 4,096-token ring, dense and paged."""

    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.core import execution as X
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import moe as M

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(RING_ARCH), n_layers=RING_LAYERS)
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows, win, ps = LONG_ROWS, cfg.swa_window, LONG_PS
    w, nl = win // ps, cfg.n_layers
    dense = Z.init_decode_state(cfg, rows, RING_POS + 1, device="cuda")
    check(dense["k"].shape[2] == win, f"ring of {dense['k'].shape[2]} slots, want {win}")
    for key in ("k", "v"):
        dense[key].normal_(generator=gen)
    table = torch.randperm(rows * w, generator=gen, device="cuda").reshape(rows, w).int()

    def to_pages(state):  # page table[r, j] holds slots [j·ps, (j+1)·ps) of row r
        out = Z.init_decode_state_paged(cfg, rows * w, ps, device="cuda")
        for key in ("k", "v"):
            out["pages_" + key][:, table.flatten().long()] = state[key].reshape(
                nl, rows * w, ps, cfg.n_kv_heads, cfg.head_dim)
        return out

    paged, paged_gather, paged_shared = to_pages(dense), to_pages(dense), to_pages(dense)
    before = {k: v.clone() for k, v in dense.items()}
    toks = torch.randint(0, cfg.vocab, (rows, 1), generator=gen, device="cuda", dtype=torch.int32)
    pos = torch.full((rows,), RING_POS, dtype=torch.int32, device="cuda")
    big = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("big")
    decode = Z.make_decode_fn(cfg)
    with torch.no_grad(), big:
        with RouteLog() as rd:
            ld = decode(params, {"tokens": toks}, dense, pos)[0]
        reset()
        t0 = time.perf_counter()
        with RouteLog() as rp:
            lp = decode(params, {"tokens": toks, "page_table": table}, paged, pos)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        with mock.patch.dict(X.BACKENDS, {"paged_attn_cuda": X.BACKENDS["paged_attn_torch"]}):
            lg = decode(params, {"tokens": toks, "page_table": table}, paged_gather, pos)[0]
        # The kernel's step again, the dense step's routing shared: every
        # row comparable.
        with RouteLog(shared=rd):
            ls = decode(params, {"tokens": toks, "page_table": table}, paged_shared, pos)[0]
    slot = RING_POS % win
    moved = (dense["k"] != before["k"]).any(dim=(3, 4))  # (layers, rows, slots)  # repro_torch: noqa=RPR001 -- reads the ring state after the steps on purpose: did each row's write land
    landed = bool(moved[:, :, slot].all()) and int(moved.sum()) == nl * rows
    page = table[:, slot // ps].long()
    same_l0 = torch.equal(paged["pages_k"][0, page, slot % ps], dense["k"][0, :, slot])  # repro_torch: noqa=RPR001 -- reads the paged arena after the step on purpose: the write against the dense one
    share, mask, own = comparable(rd.calls, rp.calls, 1, M._capacity(rows, cfg.moe), cfg.moe.n_experts)
    d = (lp.float() - ld.float()).abs().amax(dim=-1)[:, 0].cpu().numpy()
    cmp_rows = mask[0, 0]
    diff = float(d[cmp_rows].max()) if cmp_rows.any() else None
    gather_same = torch.equal(lg, ld)
    shared_diff = float((ls.float() - ld.float()).abs().max())
    print(f"  {RING_ARCH} at {nl} of 32 layers, {rows} rows at position {RING_POS} of a {win}-token ring: "
          f"new K/V at slot {slot} only: {landed}; layer 0's paged K equals the dense ring's: {same_l0}; "
          f"gather route == dense ring bitwise: {gather_same}; launches {launches}; paged step wall "
          f"{wall * 1e3:.2f} ms", flush=True)
    print(f"  paged_attention_cuda vs dense ring: {share:.4f} of the routing decisions agree "
          f"(least accepted {MIN_ROUTE_AGREE}); {int(cmp_rows.sum())} of {rows} rows comparable, max "
          f"|logit diff| {diff} (tol {LOGIT_TOL}); rows whose own routing agreed: "
          f"{float(d[own[0, 0]].max()) if own[0, 0].any() else None}; with the dense step's routing "
          f"shared, every row: {shared_diff:.4f}", flush=True)
    check(landed, "the ring step did not write exactly slot pos % window")
    check(same_l0, "layer 0's new paged K differs from the dense ring's")
    check(gather_same, "the gather route's ring step differs from the dense ring's")
    check(launches["paged_attention_cuda"] == nl, f"paged launches {launches}")
    check(bool(torch.isfinite(lp.float()).all()), "ring logits not finite")
    check(share >= MIN_ROUTE_AGREE, f"ring step: routing agrees on {share}")
    check(diff is None or diff <= LOGIT_TOL, f"ring step: paged vs dense logits differ by {diff}")
    check(shared_diff <= LOGIT_TOL, f"ring step, routing shared: logits differ by {shared_diff}")
    return {"arch": RING_ARCH, "layers": nl, "rows": rows, "window": win, "pos": RING_POS, "slot": slot,
            "landed": landed, "gather_equal": gather_same, "route_agree": share,
            "compared_rows": int(cmp_rows.sum()), "max_logit_diff": diff,
            "shared_route_max_logit_diff": shared_diff, "launches": launches,
            "paged_step_wall_s": wall, "phase_s": time.perf_counter() - t_phase}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def timed_forward(torch, fn, n: int = 3):
    """A warm-up and ``n`` CUDA-synchronised calls: the last output and the walls."""

    out = fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def recurrent_phase(torch, counts, reset, arch: str) -> dict:
    """A Mamba2 family at full width (phases 13, 14): ``paged="auto"`` stays
    dense and ``"on"`` is refused; the dense engine and the one-shot path
    under the little class through ``repro_torch.launch.serve``; engine ==
    one-shot over the padded batch; one mixed-length admission round
    against the short request alone (printed, not held: the reference's
    behaviour); ``launch/score.py``'s forward and loss; the forward over 2
    x 2048 tokens against the model's recurrence over its first RECUR_LEN
    positions (measured), and three blocks' chunked scan against their
    recurrence (held); for the hybrid also the forward through
    ``chunked_attention`` (measured) and the shared block alone, flash
    against ``chunked_attention`` and its ring decode against its forward
    (held); one decode step of the 12-row slot table timed and traced
    against its bytes bound."""

    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.launch import score as SC
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as TX
    from repro_torch.runtime.serving import ServingEngine

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = tree_bytes(params) / 1e9
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"  {cfg.name}: {n_params / 1e9:.3f} B params, {weights_gb:.2f} GB, init {init_s:.1f} s",
          flush=True)
    per_step = sum(c for _, c in gemm_shapes(cfg))
    every = cfg.shared_attn_every
    check(per_step == (1 + 7 * (cfg.n_layers // every) if every else 1), f"{per_step} GEMMs a step")
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    seq_cap = PROMPT_LEN + GEN_LEN
    try:
        ServingEngine(cfg, params, mesh, seq_cap=seq_cap, paged="on", device="cuda")
        fail(f"{cfg.name}: paged='on' was not refused")
    except ValueError as e:
        refusal = str(e)
    check("paged='on'" in refusal, f"refusal {refusal!r}")
    base = ["--arch", arch, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--gen-len", str(GEN_LEN), "--seed", "0"]
    out: dict = {"arch": cfg.name, "params_b": n_params / 1e9, "weights_gb": weights_gb,
                 "init_s": init_s, "paged_on_refusal": refusal}

    # The dense engine, through "--paged auto".
    reset()
    sd, tokd, engd, walld = run_serve(base + ["--paged", "auto"], params=params)
    cd = counts()
    stepsd = PROMPT_LEN * engd.stats.admission_rounds + engd._step_calls
    kv = sd["engine"]["kv_pool"]
    print(f"  dense engine (--paged auto): smoke reading {sd['tokens_per_s']} tokens/s, warm-up "
          f"{sd['compile_s']} s, wall {walld:.2f} s; launches {cd}; recurrence steps {stepsd}; "
          f"state {kv['kv_bytes'] / 1e9:.3f} GB on {engd.n_slots} slots", flush=True)
    check(not kv["paged"] and not engd.paged, "paged='auto' paged a recurrent state")
    check(sd["exec_backend"] == "cuda", f"dense engine ran {sd['exec_backend']}")
    check(cd["gemm_cuda"] == per_step * stepsd, f"gemm_cuda launches {cd['gemm_cuda']} != {per_step} x {stepsd}")
    check(cd["gemm_cuda_lean"] == cd["paged_attention_cuda"] == cd["flash_attention_cuda"] == 0,
          f"the dense engine launched other kernels: {cd}")
    check(tokd.shape == (BATCH, PROMPT_LEN + GEN_LEN) and bool(((tokd >= 0) & (tokd < cfg.vocab)).all()),
          f"dense tokens {tokd.shape}")
    check(bool(torch.isfinite(engd.prefill_logits.float()).all()), "dense engine logits not finite")
    del engd

    # The one-shot path under the little class's tree.
    reset()
    sl, tokl, _, walll = run_serve(base + ["--one-shot", "--device-class", "little"], params=params)
    cl = counts()
    agree_l = float((tokl[:, PROMPT_LEN:] == tokd[:, PROMPT_LEN:]).mean())
    print(f"  one-shot little ({sl['exec_backend']}): smoke reading {sl['tokens_per_s']} tokens/s, wall "
          f"{walll:.2f} s; launches {cl}; equal generated tokens vs the engine {agree_l:.3f}", flush=True)
    check(sl["exec_backend"] == "cuda_lean", f"little ran {sl['exec_backend']}")
    check(cl["gemm_cuda_lean"] == per_step * (PROMPT_LEN + GEN_LEN), f"lean launches {cl['gemm_cuda_lean']}")

    # The engine against the one-shot path over the padded batch, big class.
    padded, order = serve.pad_requests(tokd[:, :PROMPT_LEN], mesh.batch_layout(BATCH))
    with mesh.execution_context("big"):
        ref, _ = serve.generate(cfg, params, padded, GEN_LEN, seq_cap, device="cuda")
    same = bool(np.array_equal(ref[order], tokd))
    print(f"  engine == one-shot over the padded batch ({padded.shape[0]} rows): {same}", flush=True)
    check(same, "the engine's tokens differ from the one-shot path's over the padded batch")

    # One mixed-length admission round: a 16- and an 8-token prompt.
    def served(prompts):
        eng = ServingEngine(cfg, params, mesh, seq_cap=seq_cap, slots_per_pod=2, device="cuda")
        rids = [eng.submit(p, GEN_LEN) for p in prompts]
        done = {c.rid: c.tokens.tolist() for c in eng.run()}
        return [done[r] for r in rids]

    short = tokd[1, :PROMPT_LEN // 2]
    alone, mixed = served([short])[0], served([tokd[0, :PROMPT_LEN], short])[1]
    mixed_same, first_same = alone == mixed, alone[len(short)] == mixed[len(short)]
    print(f"  mixed-length round (16 and 8 tokens): the short request's tokens equal its run alone: "
          f"{mixed_same} (the first generated token {'equal' if first_same else 'differs'}; "
          f"the reference pads the round and the recurrent state absorbs the pad steps)", flush=True)

    # launch/score.py: the forward and the loss, 2 x 2048 tokens.
    args = SC.build_parser().parse_args(["--arch", arch, "--batch", str(FWD_BATCH),
                                         "--seq-len", str(FWD_SEQ), "--seed", "0"])
    reset()
    score = SC.score(args, params=params)
    cs = counts()
    n_flash = cfg.n_layers // every if every else 0
    print(f"  launch/score.py: forward {score['forward_s']} s ({score['tokens_per_s']} tokens/s, the "
          f"first call), loss {score['loss']:.6f} (ln V = {math.log(cfg.vocab):.4f}); launches {cs}",
          flush=True)
    check(cs["gemm_cuda"] == 2 * per_step and cs["flash_attention_cuda"] == 2 * n_flash,
          f"score launches {cs}")
    check(math.isfinite(score["loss"]) and abs(score["loss"] - math.log(cfg.vocab)) < 3.0,
          f"eval loss {score['loss']} far from ln V")

    # The forward (the SSD chunked scan) against the recurrence.
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (FWD_BATCH, FWD_SEQ), dtype=np.int32), device="cuda")
    big = mesh.execution_context("big")
    prefill = Z.make_prefill_fn(cfg)
    torch.cuda.reset_peak_memory_stats()
    with big:
        logits, walls = timed_forward(torch, lambda: prefill(params, {"tokens": toks}))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall = sorted(walls)[1]
    check(tuple(logits.shape) == (FWD_BATCH, FWD_SEQ, cfg.vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "forward logits not finite")
    print(f"  forward 2 x {FWD_SEQ}: walls {[round(w, 4) for w in walls]} s (median {wall:.4f} s, "
          f"{FWD_BATCH * FWD_SEQ / wall:.0f} tokens/s); peak {peak_gb:.2f} GB", flush=True)
    split = profile_run(torch, lambda: prefill(params, {"tokens": toks}), big)
    print(f"  one traced forward: wall {split['wall_ms']:.1f} ms, device busy {split['busy_ms']:.1f} ms "
          f"(idle {split['idle_share']:.3f}); device ms by kernel "
          f"{ {k: round(v, 2) for k, v in split['ms'].items()} }", flush=True)
    out["forward"] = {"walls_s": walls, "wall_s": wall, "tokens_per_s": FWD_BATCH * FWD_SEQ / wall,
                      "peak_gb": peak_gb, "traced": split, "score": score, "score_launches": cs}
    if every:  # the shared block's attention through chunked_attention
        with big:
            chunked = Z.make_prefill_fn(cfg, attn_backend="flash_attn_torch")(params, {"tokens": toks})
        dmax = float((logits.float() - chunked.float()).abs().max())
        drow = row_rel_err(logits[:, -8:], chunked[:, -8:])
        print(f"  the model's forward, flash vs chunked_attention (measured, not held: 54 random-init "
              f"Mamba2 layers after the first shared block grow the two attentions' last-bit "
              f"difference): max |logit diff| {dmax:.4f}, the last rows off by {drow:.4f} of their norm",
              flush=True)
        # The shared block alone at full width, flash against chunked_attention, held.
        gen = torch.Generator(device="cuda").manual_seed(14)
        x = torch.randn((FWD_BATCH, FWD_SEQ, cfg.d_model), generator=gen, device="cuda")
        x = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(torch.bfloat16)
        shared = TX._cast_params(params["shared"])  # as the forward casts it
        positions = torch.arange(FWD_SEQ, device="cuda")[None, :]
        reset()
        with torch.no_grad(), big:
            yf = TX._apply_attn_block(shared, x, cfg, positions)[0]
            launched = counts()["flash_attention_cuda"]
            yc = TX._apply_attn_block(shared, x, cfg, positions, attn_backend="flash_attn_torch")[0]
        brow = row_rel_err(yf, yc)
        print(f"  the shared block alone, flash vs chunked_attention: rows off by {brow:.5f} of their norm "
              f"(tol {FLASH_ROW_TOL}), max |diff| {float((yf.float() - yc.float()).abs().max()):.4f}; "
              f"flash launches {launched}", flush=True)
        check(launched == 1 and bool(torch.isfinite(yf.float()).all()) and brow <= FLASH_ROW_TOL,
              f"the shared block, flash vs chunked: rows off by {brow} (launches {launched})")
        # Its decode over RECUR_LEN positions (a ring of the cache's length,
        # no live mask, as the hybrid decodes it) against its forward, held.
        sc = FWD_SEQ
        ring = {k: torch.zeros((1, FWD_BATCH, sc, cfg.n_kv_heads, cfg.head_dim), dtype=torch.bfloat16,
                               device="cuda") for k in ("k", "v")}
        ring_cfg = dataclasses.replace(TX.attn_config(cfg), window=sc)
        with torch.no_grad(), big:
            yd = torch.cat([TX._decode_attn_block(params["shared"], x[:, t:t + 1], cfg, ring_cfg, ring, 0,
                                                  None, t, None) for t in range(RECUR_LEN)], dim=1)
            ycd = TX._apply_attn_block(params["shared"], x[:, :RECUR_LEN], cfg, positions[:, :RECUR_LEN],
                                       attn_backend="flash_attn_torch")[0]
        drow_dec = row_rel_err(yd, ycd)
        print(f"  the shared block's decode over {RECUR_LEN} positions vs its forward: rows off by "
              f"{drow_dec:.5f} of their norm (tol {FLASH_ROW_TOL})", flush=True)
        check(bool(torch.isfinite(yd.float()).all()) and drow_dec <= FLASH_ROW_TOL,
              f"the shared block's decode vs its forward: rows off by {drow_dec}")
        out["forward"].update(flash_vs_chunked_max=dmax, flash_vs_chunked_row=drow,
                              shared_block_flash_vs_chunked_row=brow, shared_block_decode_row=drow_dec)
        del chunked, x, yf, yc, yd, ycd, ring
    # The model's recurrence against its forward, measured: through 48 or
    # 54 random-init layers the two paths' bf16 roundings (the forward
    # casts the block's fp32 leaves to bf16 and rounds the scan's output,
    # as the reference does) grow to the size of the logits themselves, so
    # this is printed, not held; the blocks are held below.
    t0 = time.perf_counter()
    state = Z.init_decode_state(cfg, FWD_BATCH, FWD_SEQ, device="cuda")
    decode = Z.make_decode_fn(cfg)
    head = RECUR_LEN - REPLAY_TAIL
    model = {"max_logit_diff": [], "row_rel": [], "argmax_equal": []}
    with torch.no_grad(), big:
        lg, state = Z.make_prefill_fn(cfg, with_cache=True)(params, {"tokens": toks[:, :head]}, state, 0)
        for t in range(head - 1, RECUR_LEN):
            if t >= head:
                lg, state = decode(params, {"tokens": toks[:, t:t + 1]}, state, t)
            got, want = lg[:, 0].float(), logits[:, t].float()
            check(bool(torch.isfinite(got).all()), "recurrence logits not finite")
            model["max_logit_diff"].append(float((got - want).abs().max()))
            model["row_rel"].append(row_rel_err(got, want))
            model["argmax_equal"].append(float((got.argmax(-1) == want.argmax(-1)).float().mean()))
        torch.cuda.synchronize()
    recur_s = time.perf_counter() - t0
    print(f"  the model's recurrence over {RECUR_LEN} positions ({recur_s:.1f} s) vs its forward at positions "
          f"{head - 1}..{RECUR_LEN - 1} (measured, not held): max |logit diff| "
          f"{[round(x, 4) for x in model['max_logit_diff']]}, rows off by {[round(x, 4) for x in model['row_rel']]} "
          f"of their norm, equal argmax {model['argmax_equal']}; logits' std {float(logits.float().std()):.4f}",
          flush=True)
    out["forward"].update(recurrence_s=recur_s, model_recurrence=model)
    del state, logits

    # The SSD chunked scan against the recurrence, block by block at full
    # width: layers 0, L/2 and L-1 on the same unit-RMS bf16 inputs over
    # RECUR_LEN positions (two chunks), each block's own params.
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((FWD_BATCH, RECUR_LEN, cfg.d_model), generator=gen, device="cuda")
    x = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(torch.bfloat16)
    blocks = {}
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import layers as L

    scans0, fallbacks0 = SSD.LAUNCHES["ssd_scan_cuda"], L.CUDA_CALLS["ssd_chunked"]
    for i in (0, cfg.n_layers // 2, cfg.n_layers - 1):
        pm = TX.layer_params(params["blocks"], i)["mamba"]
        with torch.no_grad():
            y_scan, final = S.apply_mamba2(pm, x, cfg.ssm)
            st = S.init_mamba2_state(FWD_BATCH, cfg.ssm, device="cuda")
            y_rec = torch.cat([S.decode_mamba2(pm, x[:, t:t + 1], cfg.ssm, st)[0]
                               for t in range(RECUR_LEN)], dim=1)
        row = row_rel_err(y_scan, y_rec)
        state_rel = float((final - st["ssm"]).norm() / st["ssm"].norm())
        blocks[i] = {"row_rel": row, "state_rel": state_rel,
                     "max_abs": float((y_scan.float() - y_rec.float()).abs().max())}
        check(bool(torch.isfinite(y_scan.float()).all()) and row <= BLOCK_ROW_TOL,
              f"layer {i}: scan vs recurrence rows off by {row} of their norm, over {BLOCK_ROW_TOL}")
        check(state_rel <= BLOCK_ROW_TOL, f"layer {i}: final state off by {state_rel}, over {BLOCK_ROW_TOL}")
    check(SSD.LAUNCHES["ssd_scan_cuda"] - scans0 == 3 and L.CUDA_CALLS["ssd_chunked"] == fallbacks0,
          f"the block gate's scans: {SSD.LAUNCHES['ssd_scan_cuda'] - scans0} through the kernels, "
          f"{L.CUDA_CALLS['ssd_chunked'] - fallbacks0} through _ssd_chunked (want 3, 0)")
    print(f"  the chunked scan vs the recurrence, block by block over {RECUR_LEN} positions: "
          f"{ {i: {k: round(v, 7) for k, v in b.items()} for i, b in blocks.items()} } (rows within "
          f"{BLOCK_ROW_TOL} of their norm, the final state within it in L2)", flush=True)
    out["forward"]["blocks_scan_vs_recurrence"] = blocks
    del x

    # One decode step of the 12-row slot table: the padded batch's state
    # after its prompts, timed and traced against its bytes bound.
    b = padded.shape[0]
    state = Z.init_decode_state(cfg, b, seq_cap, device="cuda")
    ptoks = torch.as_tensor(padded, device="cuda")
    with torch.no_grad(), big:
        Z.make_prefill_fn(cfg, with_cache=True)(params, {"tokens": ptoks}, state, 0)
    nxt = torch.as_tensor(ref[:, PROMPT_LEN:PROMPT_LEN + 1], device="cuda")

    def step():
        return decode(params, {"tokens": nxt}, state, PROMPT_LEN)[0]

    with torch.no_grad(), big:
        _, step_walls = timed_forward(torch, step)
        trace = profile_run(torch, step, big)
    state_b = tree_bytes(state)  # repro_torch: noqa=RPR001 -- the size of the state the prefill filled, read after it on purpose
    shared_b = tree_bytes(params["shared"]) if every else 0
    weights_b = tree_bytes(params) - tree_bytes(params.get("embed", {})) + b * cfg.d_model * 2
    step_bytes = weights_b + (cfg.n_layers // every - 1) * shared_b if every else weights_b
    step_bytes += 2 * state_b  # the state read and written
    bound = step_bytes / HBM_BW * 1e3
    sw = sorted(step_walls)[1]
    print(f"  one decode step, {b} rows: walls {[round(x * 1e3, 2) for x in step_walls]} ms; traced wall "
          f"{trace['wall_ms']:.2f} ms, device busy {trace['busy_ms']:.2f} ms (idle {trace['idle_share']:.3f}); "
          f"device ms by kernel {({k: round(v, 3) for k, v in trace['ms'].items()})}, launches "
          f"{trace['count']}; bytes bound {bound:.3f} ms ({step_bytes / 1e9:.3f} GB: weights "
          f"{weights_b / 1e9:.3f}" + (f", the shared block's {shared_b / 1e9:.3f} x {cfg.n_layers // every}"
                                      if every else "")
          + f", state {state_b / 1e9:.3f} read and written); busy {trace['busy_ms'] / bound:.2f}x the bound, "
          f"wall {sw * 1e3 / bound:.2f}x", flush=True)
    check(trace["busy_ms"] > 0, "no device time for the decode step")
    out.update({"dense": sd, "one_shot_little": sl, "walls_s": [walld, walll],
                "launches": {"dense": cd, "one_shot_little": cl, "score": cs},
                "recurrence_steps": stepsd, "little_token_agreement": agree_l,
                "engine_equals_one_shot": same, "mixed_round_equals_alone": mixed_same,
                "mixed_round": {"alone": alone, "mixed": mixed},
                "step": {"walls_s": step_walls, "wall_s": sw, "traced": trace, "bytes": step_bytes,
                         "weights_bytes": weights_b, "state_bytes": state_b, "shared_bytes": shared_b,
                         "bound_ms": bound}})
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  {cfg.name} took {out['phase_s']:.1f} s", flush=True)
    return out


def phase15(torch, counts, reset) -> dict:
    """whisper-small and pixtral-12b at full width: the forward and the
    eval loss through ``launch/score.py``, the forward against the chunked
    forward, and decode steps against the forward's logits (whisper's
    cross K/V from ``encode`` + ``encode_cross_kv``)."""

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.launch import score as SC
    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo as Z

    out: dict = {}
    big = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("big")
    for arch, seq in ((ENCDEC_ARCH, DEC_CTX), (EMBED_ARCH, FWD_SEQ)):
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in _leaves(params))
        print(f"  {cfg.name}: {n_params / 1e9:.3f} B params, {tree_bytes(params) / 1e9:.2f} GB, "
              f"init {init_s:.1f} s", flush=True)
        encdec = cfg.family == "encdec"
        if encdec:
            el, dl = cfg.enc_layers, cfg.n_layers
            per_fwd = {"gemm_cuda": 6 * el + 10 * dl + 1, "flash_attention_cuda": el + 2 * dl}
        else:
            per_fwd = {"gemm_cuda": sum(c for _, c in gemm_shapes(cfg)),
                       "flash_attention_cuda": cfg.n_layers}
        args = SC.build_parser().parse_args(["--arch", arch, "--batch", "2", "--seq-len", str(seq),
                                             "--seed", "0"])
        batch, labels = SC.make_batch(cfg, 2, seq, 0, torch.device("cuda"))
        prefill = Z.make_prefill_fn(cfg)
        torch.cuda.reset_peak_memory_stats()
        reset()
        score = SC.score(args, params=params)  # the forward and the loss, through the CLI's entry point
        with big:
            logits, walls = timed_forward(torch, lambda: prefill(params, batch))
        launches = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        wall = sorted(walls)[1]
        for name, n in per_fwd.items():
            check(launches[name] == 6 * n, f"{cfg.name}: {name} launches {launches[name]} != 6 x {n}")
        check(launches["gemm_cuda_lean"] == launches["paged_attention_cuda"] == 0, f"launches {launches}")
        check(tuple(logits.shape) == (2, seq, cfg.vocab), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits.float()).all()), "forward logits not finite")
        check(math.isfinite(score["loss"]) and abs(score["loss"] - math.log(cfg.vocab)) < 3.0,
              f"eval loss {score['loss']} far from ln V")
        # The operations bound: every GEMM's 2MKN and every attention's 4·H·D
        # a visible (query, key) pair, at the tensor cores' peak.
        if encdec:
            d, ff, se = cfg.d_model, cfg.d_ff, cfg.enc_frames
            gemm_ops = 2 * 2 * (se * (4 * el + 2 * dl) * d * d + se * el * 2 * d * ff
                                + seq * (6 * dl * d * d + 2 * dl * d * ff + d * cfg.vocab))
            hd = cfg.n_heads * cfg.head_dim
            attn_ops = 4 * 2 * hd * (el * visible_pairs(se, se, False, None)
                                     + dl * visible_pairs(seq, seq, True, None) + dl * seq * se)
        else:
            gemm_ops = 2 * 2 * seq * sum(k * n * c for (k, n), c in gemm_shapes(cfg))
            attn_ops = 4 * 2 * cfg.n_heads * cfg.head_dim * cfg.n_layers * visible_pairs(seq, seq, True, None)
        ops_ms = (gemm_ops + attn_ops) / PEAK_BF16 * 1e3
        split = profile_run(torch, lambda: prefill(params, batch), big)
        print(f"  forward 2 x {seq}: walls {[round(w, 4) for w in walls]} s (median {wall:.4f} s, "
              f"{2 * seq / wall:.0f} tokens/s); operations bound {ops_ms:.2f} ms "
              f"({(gemm_ops + attn_ops) / 1e12:.2f} TFLOP): {ops_ms / (wall * 1e3):.3f} of it; loss "
              f"{score['loss']:.6f} (ln V = {math.log(cfg.vocab):.4f}); launches over 6 forwards "
              f"{launches}; peak {peak_gb:.2f} GB", flush=True)
        print(f"  one traced forward: wall {split['wall_ms']:.1f} ms, device busy {split['busy_ms']:.1f} ms "
              f"(idle {split['idle_share']:.3f}); device ms by kernel "
              f"{ {k: round(v, 2) for k, v in split['ms'].items()} }", flush=True)
        with big:
            chunked = Z.make_prefill_fn(cfg, attn_backend="flash_attn_torch")(params, batch)
        dmax = float((logits.float() - chunked.float()).abs().max())
        del chunked
        print(f"  flash vs chunked_attention forward: max |logit diff| {dmax:.4f} (tol {LOGIT_TOL})",
              flush=True)
        check(dmax <= LOGIT_TOL, f"{cfg.name}: flash vs chunked logits differ by {dmax}")

        # Decode steps against the forward's logits.
        decode = Z.make_decode_fn(cfg)
        n_steps = ENC_DECODE_STEPS if encdec else REPLAY_TAIL
        with torch.no_grad(), big:
            state = Z.init_decode_state(cfg, 2, seq, device="cuda")
            if encdec:
                enc = E.encode(params, cfg, batch["frames"])
                xcfg = E._acfg(cfg, causal=False)
                for i in range(cfg.n_layers):
                    xkv = {k: v[i] for k, v in params["dec_blocks"]["xkv"].items()}
                    state["cross_k"][i], state["cross_v"][i] = L.encode_cross_kv(xkv, enc, xcfg)
            reset()
            steps = []
            for t in range(n_steps):
                key = "tokens" if encdec else "embeds"
                lg, state = decode(params, {key: batch[key][:, t:t + 1]}, state, t)
                steps.append(float((lg[:, 0].float() - logits[:, t].float()).abs().max()))
            torch.cuda.synchronize()
        dec_launches = counts()
        print(f"  {n_steps} decode steps vs the forward, max |logit diff| per position "
              f"{[round(x, 4) for x in steps]} (tol {LOGIT_TOL}); launches {dec_launches}", flush=True)
        check(all(math.isfinite(x) and x <= LOGIT_TOL for x in steps),
              f"{cfg.name}: decode vs forward logits differ by {max(steps)}")
        if encdec:
            check(dec_launches["flash_attention_cuda"] == n_steps * cfg.n_layers,
                  f"cross-attention launches {dec_launches}")
        out[arch] = {"params_b": n_params / 1e9, "init_s": init_s, "walls_s": walls, "wall_s": wall,
                     "tokens_per_s": 2 * seq / wall, "ops_bound_ms": ops_ms,
                     "ops_bound_share": ops_ms / (wall * 1e3), "score": score, "launches": launches,
                     "per_forward": per_fwd, "peak_gb": peak_gb, "traced": split,
                     "flash_vs_chunked_max": dmax, "decode_max_logit_diff": steps,
                     "decode_launches": dec_launches, "phase_s": time.perf_counter() - t_phase}
        print(f"  {cfg.name} took {out[arch]['phase_s']:.1f} s", flush=True)
        del params, logits, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


# The training step of phase 16: full-width internlm2-1.8b, 8 x 512 tokens
# (M = 4,096 rows in every GEMM), 6 steps and one failure at step 2 that
# restores the step-0 checkpoint.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_FAIL_AT = 8, 512, 6, 2
# The benchmark's train cell's shape, where phase 1 times the training
# attention.
TRAIN_ATTN_BATCH, TRAIN_ATTN_SEQ = 4, 2048
# The step-0 training loss (fp32 masters cast at use; the training flash
# forward, whose output is the inference kernel's) against the eval loss
# on the same batch (the inference flash kernel): a few thousandths at
# most, the training graph's other order of the same bf16 casts.
TRAIN_EVAL_LOSS_TOL = 0.01
# Later replayed losses against the first run's: the embedding's backward
# scatters with atomics, so the step-0 update differs in the last bits.
TRAIN_REPLAY_RTOL = 1e-3
# The trainer's GEMM shapes (K, N) (internlm2-1.8b).
TRAIN_SHAPES = ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048), (2048, 92544))


def train_gemm_flops(cfg, b: int, s: int) -> dict:
    """Operations of the GEMMs of one training step over ``b`` x ``s``
    tokens (``step_gemm_shapes``): the forward (every projection and the
    head), the recompute (the layers again, not the head) and the backward
    (two products per forward GEMM)."""

    fwd = sum(2 * m * k * n * c for m, k, n, c in step_gemm_shapes(cfg, b, s))
    head = 2 * b * s * cfg.d_model * cfg.vocab
    return {"forward": fwd, "remat": fwd - head, "backward": 2 * fwd}


def phase1_backward(torch, detail: dict, records: dict) -> None:
    """The GEMM autograd Function's backward at internlm2-1.8b's training
    shapes (M = 8 x 512), through ``gemm_backward_check``; the kernels'
    ``max_abs_err`` takes its errors, and ``train_backward_step`` its step
    totals."""

    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    shapes = step_gemm_shapes(cfg, TRAIN_BATCH, TRAIN_SEQ)
    check({(k, n) for _, k, n, _ in shapes} == set(TRAIN_SHAPES)
          and sum(c for *_, c in shapes) == 7 * cfg.n_layers + 1, f"training shapes {shapes}")
    res = gemm_backward_check(torch, ARCH, shapes, seed=2)
    tot = res["totals"]
    for name in ("gemm_cuda", "gemm_cuda_lean"):
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], res["max_abs_err"][name])
        records[name]["train_backward_step"] = {"ms": tot[name], "plain_ms": tot[f"{name}_plain"],
                                                "library_ms": tot["library_ms"],
                                                "bound_ms": tot["bound_ms"],
                                                "transpose_ms": tot["transpose_ms"]}
    detail["train_backward_gemms"] = res


def gemm_backward_check(torch, label: str, shapes: list, seed: int) -> dict:
    """The GEMM autograd Function's backward on the card at a training
    step's shapes (``shapes``: (M, K, N, calls) of its forward GEMMs): the
    output, dA and dB through ``gemm_cuda`` (the big class's blocks) and
    ``gemm_cuda_lean`` (the little class's) against the same Function on
    their plain versions, and ``gemm_cuda``'s against ``torch.matmul``
    autograd, each within ``BF16_TOL`` and ``GEMM_ROW_TOL``; for each
    backward product on each kernel, a planted dropped K-tile failing that
    check; ``gemm_cuda_lean`` bitwise equal to ``gemm_cuda`` at equal
    blocks (the output and both gradients); the two backward products on
    both kernels timed against their plain versions, ``torch.matmul`` and
    their bound, the transposed copies apart; totals over a step (each
    shape times its calls).  ``torch.matmul`` reduces in fp32 here
    (``allow_bf16_reduced_precision_reduction`` off), as the kernels do."""

    import dataclasses

    from repro_torch.core import control_tree as CT
    from repro_torch.core import execution as X
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops

    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    big, little = asym.execution_context("big"), asym.execution_context("little")
    plain_big = X.context_for_tree(dataclasses.replace(big.tree, backend="torch_ref"))
    plain_little = X.context_for_tree(dataclasses.replace(little.tree, backend="torch_ref_lean"))
    classes = (("gemm_cuda", big, plain_big, G.gemm_cuda, G.gemm_plain),
               ("gemm_cuda_lean", little, plain_little, G.gemm_cuda_lean, G.gemm_lean_plain))
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls: dict = {}
    for m, k, n, c in shapes:  # q and o share a shape
        calls[(m, k, n)] = calls.get((m, k, n), 0) + c

    def grads(ctx, a, b, dc, fn=None):
        a, b = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        with ctx:
            out = (fn or ops.gemm)(a, b)
            out.backward(dc)
        return out.detach(), a.grad, b.grad

    def close(got, ref) -> tuple[bool, float, float]:
        ok, err = within(torch, got, ref, BF16_TOL)
        row = row_rel_err(got, ref)
        return ok and row <= GEMM_ROW_TOL, err, row

    rows, tot, max_err = [], {}, {name: 0.0 for name, *_ in classes}
    for (m, k, n), count in calls.items():
        # Unit-scale dC: dA's entries are O(sqrt(N / K)) and dB's
        # O(sqrt(M)), far above BF16_TOL's absolute part.
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
        dc = torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
        row_err, row_abs, plain_grads = 0.0, {name: 0.0 for name, *_ in classes}, {}
        for kernel, ctx, plain_ctx, _, _ in classes:
            G.reset_launches()
            got = grads(ctx, a, b, dc)
            torch.cuda.synchronize()
            check(G.LAUNCHES[kernel] == 3 and sum(G.LAUNCHES.values()) == 3,
                  f"the Function under {kernel}'s class launched {G.LAUNCHES} at {m}x{k}x{n}")
            plain_grads[kernel] = grads(plain_ctx, a, b, dc)
            refs = [("the plain version", plain_grads[kernel])]
            if kernel == "gemm_cuda":
                refs.append(("torch.matmul autograd", grads(big, a, b, dc, torch.matmul)))
            for name, x, *want in zip(("out", "dA", "dB"), got, *(r for _, r in refs)):
                for (ref_label, _), y in zip(refs, want):
                    ok, e, r = close(x, y)
                    check(ok, f"GemmFn {name} {m}x{k}x{n} under {kernel}'s class blocks: max err {e}, "
                              f"row L2 {r} vs {ref_label} over {BF16_TOL} / {GEMM_ROW_TOL}")
                    if ref_label == "the plain version":
                        row_abs[kernel], row_err = max(row_abs[kernel], e), max(row_err, r)
            max_err[kernel] = max(max_err[kernel], row_abs[kernel])
            del got, refs
        # Lean == pipelined bitwise at equal blocks: one hand-built block
        # (the big class's for the forward shape) for every product.
        blk = big.block_config(m, k, n, "bfloat16", 2)
        pair = [grads(X.context_for_tree(CT.ControlTree(device_class=f"hand-{be}", block=blk,
                                                        backend=be)), a, b, dc)
                for be in ("cuda", "cuda_lean")]
        for name, x, y in zip(("out", "dA", "dB"), *pair):
            check(torch.equal(x, y), f"lean != pipelined bitwise for {name} at {m}x{k}x{n} {blk}")
        del pair
        # The two backward products on each kernel at its class's blocks,
        # against torch.matmul on the same (untransposed) operands; then a
        # planted fault: the product on the kernel with the middle K-tile of
        # its reduction zeroed (what a kernel that skipped it would return)
        # must fail the check above against the class's plain gradient.
        bt, at = b.t().contiguous(), a.t().contiguous()
        row = {"shape": [m, k, n], "calls_per_step": count, "max_abs_err": row_abs,
               "max_row_rel_err": row_err}
        for prod, x, y, lx, ly, g in (("dA", dc, bt, dc, b.t(), 1), ("dB", at, dc, a.t(), dc, 2)):
            mm, kk, nn = x.shape[0], x.shape[1], y.shape[1]
            b_ms, by = bound_ms((mm * kk + kk * nn + mm * nn) * 2, 2 * mm * kk * nn)
            rec = {"shape": [mm, kk, nn], "bound_ms": b_ms, "bound_by": by,
                   "library_ms": time_ms(torch, torch.matmul, [(lx, ly)], 5, 1)}
            for name, ctx, _, fn, plain in classes:
                blk = ctx.block_config(mm, kk, nn, "bfloat16", 2)
                t0 = blk.bk * ((kk // blk.bk) // 2)
                dropped = x.clone()
                dropped[:, t0:t0 + blk.bk] = 0
                ok, e, r = close(fn(dropped, y, blk), plain_grads[name][g])
                check(not ok, f"{prod} {mm}x{kk}x{nn} on {name} with K-tile [{t0}, {t0 + blk.bk}) "
                              f"dropped passed the check (max err {e}, row L2 {r})")
                del dropped
                rec[name] = {"block": [blk.bm, blk.bk, blk.bn],
                             "ms": time_ms(torch, lambda p, q: fn(p, q, blk), [(x, y)], 5, 1),
                             "plain_ms": time_ms(torch, lambda p, q: plain(p, q, blk), [(x, y)], 1, 1),
                             "dropped_k_tile": {"k0": t0, "bk": blk.bk, "max_abs_err": e,
                                                "max_row_rel_err": r}}
            row[prod] = rec
        row["transpose_ms"] = {
            "B": time_ms(torch, lambda t: t.t().contiguous(), [(b,)], 5, 1),
            "A": time_ms(torch, lambda t: t.t().contiguous(), [(a,)], 5, 1),
        }
        rows.append(row)
        drop = {p: min(row[p][name]["dropped_k_tile"]["max_row_rel_err"] for name, *_ in classes)
                for p in ("dA", "dB")}
        print(f"  GemmFn backward {label} {m}x{k}x{n} (x{count} a step): err "
              f"{max(row_abs.values()):.3g}, row L2 {row_err:.3g} (both classes); a dropped K-tile "
              f"shows row L2 {drop['dA']:.3g} (dA) {drop['dB']:.3g} (dB); dA {row['dA']['shape']} "
              f"gemm_cuda {row['dA']['gemm_cuda']['ms']:.4f} ms lean {row['dA']['gemm_cuda_lean']['ms']:.4f} "
              f"matmul {row['dA']['library_ms']:.4f} bound {row['dA']['bound_ms']:.4f}; dB "
              f"{row['dB']['shape']} gemm_cuda {row['dB']['gemm_cuda']['ms']:.4f} lean "
              f"{row['dB']['gemm_cuda_lean']['ms']:.4f} matmul {row['dB']['library_ms']:.4f} bound "
              f"{row['dB']['bound_ms']:.4f}; transposes B {row['transpose_ms']['B']:.4f} "
              f"A {row['transpose_ms']['A']:.4f} ms", flush=True)
        del a, b, dc, bt, at, plain_grads
    step = lambda f: sum(r["calls_per_step"] * f(r) for r in rows)  # noqa: E731
    for name, *_ in classes:
        tot[name] = step(lambda r: r["dA"][name]["ms"] + r["dB"][name]["ms"])
        tot[f"{name}_plain"] = step(lambda r: r["dA"][name]["plain_ms"] + r["dB"][name]["plain_ms"])
    tot["library_ms"] = step(lambda r: r["dA"]["library_ms"] + r["dB"]["library_ms"])
    tot["bound_ms"] = step(lambda r: r["dA"]["bound_ms"] + r["dB"]["bound_ms"])
    tot["transpose_ms"] = step(lambda r: r["transpose_ms"]["A"] + r["transpose_ms"]["B"])
    tot["launches"] = 2 * sum(calls.values())
    print(f"  the backward GEMMs of one {label} training step ({tot['launches']} products): gemm_cuda "
          f"{tot['gemm_cuda']:.2f} ms (plain {tot['gemm_cuda_plain']:.2f}), lean "
          f"{tot['gemm_cuda_lean']:.2f} (plain {tot['gemm_cuda_lean_plain']:.2f}), matmul {tot['library_ms']:.2f}, "
          f"bound {tot['bound_ms']:.2f}; their transposed copies {tot['transpose_ms']:.2f} ms", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    return {"rows": rows, "totals": tot, "max_abs_err": max_err}


def kernel_family(name: str) -> str:
    """The family of a kernel by its name: ``gemm_cuda``; the flash
    attention kernels (the training forward and backward); cuBLAS in bf16
    on the tensor cores (the MoE experts' ``bmm``, the Mamba2 projections)
    or in fp32 (the router's einsums: TF32 is off);
    indexing (gathers, scatters, ``index_put``); copies; the element-wise
    rest."""

    name = name.lower()
    if "gemm_kernel<" in name:
        return "gemm_cuda"
    if "flash_attention" in name:
        return "flash_attention"
    if any(k in name for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")):
        tensor_core = any(k in name for k in ("bf16", "bfloat16", "nvjet", "tensorop", "gmma", "hmma"))
        return "cublas_bf16" if tensor_core else "cublas_fp32"
    if any(k in name for k in ("index", "scatter", "gather")):
        return "index_scatter"
    return "copies" if "copy" in name else "element_wise"


def _families(events, names: dict | None = None) -> dict:
    """Device ms by family of a list of kernel events; ``names`` collects
    each family's ms by kernel name."""

    ms: dict = {}
    for e in events:
        fam, t = kernel_family(e.name), e.time_range.elapsed_us() / 1e3
        ms[fam] = ms.get(fam, 0.0) + t
        if names is not None:
            by = names.setdefault(fam, {})
            by[e.name[:120]] = by.get(e.name[:120], 0.0) + t
    return ms


# Traced training steps to try for one whose trace holds an event for
# every GEMM launched: the profiler has dropped a few kernel events of a
# step's segments (3 of 169 and 2 of 506, spin kernels around each segment
# meant to absorb it; zamba2's backward 1-2 of 191 in each try of two
# calls, 8 tries), and the split by family below reads kernels by their
# position, which a lost event shifts.
TRACE_ATTEMPTS = 3


def traced_train_step(torch, trainer, batch, counts, n: int) -> dict:
    """One training step of ``trainer`` (its ``loss_fn``, ``params``,
    ``opt_state``, ``opt_cfg`` and ``exec_ctx``) in three profiled segments
    (forward and loss, backward, optimizer), the card synchronised between
    them: device busy and idle share, and device ms by family.  Kernels run
    in launch order on one stream, so the cross-entropy is what runs after
    the forward's last GEMM (the head) and before the backward's first.
    The backward segment's GEMMs are the recomputed forward's and the
    backward products; the recompute is taken as the forward's GEMM time
    less the head's (the same ``n`` - 1 launches at the same blocks: ``n``
    is the forward's), the rest is the backward's.  That split holds only
    for a trace with an event for every GEMM launched: up to
    ``TRACE_ATTEMPTS`` steps are traced for one, and ``"ms"`` is None (the
    split unavailable) when none is complete; ``"ms_by_name"`` (the families
    by kernel name, the cross-entropy and the GEMMs' roles not split out)
    is there either way, a lower bound from an incomplete trace."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_decode import _union_us
    from repro_torch.optim import adamw as O

    state = {}

    def forward():
        state["loss"], _ = trainer.loss_fn(trainer.params, batch)

    def backward():  # leaves the loss does not reach (the enc-dec's unused xattn K/V) get zeros
        leaves = O.tree_leaves(trainer.params)
        grads = torch.autograd.grad(state.pop("loss"), leaves, allow_unused=True)
        state["grads"] = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves)]

    def optimizer():
        tree = O.tree_unflatten(trainer.params, state.pop("grads"))
        trainer.params, trainer.opt_state, _ = O.adamw_update(trainer.params, tree, trainer.opt_state,
                                                              trainer.opt_cfg)

    def guard():
        """Spin kernels (filtered out of the trace) on both sides of a
        segment, so that events the profiler loses as it starts or stops
        are theirs."""

        for _ in range(8):
            torch.cuda._sleep(10_000)
        torch.cuda.synchronize()

    is_gemm = lambda e: "gemm_kernel<" in e.name.lower()  # noqa: E731
    dur = lambda evs: sum(e.time_range.elapsed_us() for e in evs) / 1e3  # noqa: E731
    attempts = []
    for _ in range(TRACE_ATTEMPTS):
        seg = {}
        for label, run in (("forward", forward), ("backward", backward), ("optimizer", optimizer)):
            torch.cuda.synchronize()
            c0 = counts()["gemm_cuda"]
            with trainer.exec_ctx, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                guard()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                guard()
            dev = sorted((e for e in prof.events() if e.device_type != DeviceType.CPU
                          and "spin_kernel" not in e.name), key=lambda e: e.time_range.start)
            check(bool(dev), f"the profiler saw no device activity in the {label} segment")
            gemm_us = [round(e.time_range.elapsed_us(), 1) for e in dev if is_gemm(e)]
            seg[label] = {"wall_ms": wall, "busy_ms": _union_us((e.time_range.start, e.time_range.end)
                                                                for e in dev) / 1e3,
                          "gemm_launches": counts()["gemm_cuda"] - c0,
                          "gemm_events": len(gemm_us), "events": dev,
                          "first_last_gemm_us": gemm_us[:4] + gemm_us[-4:]}
        check(seg["forward"]["gemm_launches"] == n and seg["backward"]["gemm_launches"] == 3 * n - 1,
              f"traced GEMM launches {seg['forward']['gemm_launches']} / {seg['backward']['gemm_launches']}")
        attempts.append({k: {"gemm_events": v["gemm_events"], "gemm_launches": v["gemm_launches"]}
                         for k, v in seg.items()})
        if all(v["gemm_events"] == v["gemm_launches"] for v in seg.values()):
            break
    complete = all(v["gemm_events"] == v["gemm_launches"] for v in seg.values())
    ms, names = None, {}
    if complete:
        fams = {}
        for label, sg in seg.items():
            dev = sg["events"]
            gemm_idx = [i for i, e in enumerate(dev) if is_gemm(e)]
            if label == "forward":
                fams[label] = _families(dev[:gemm_idx[-1] + 1], names)
                fams[label]["cross_entropy"] = dur(dev[gemm_idx[-1] + 1:])
                fams[label]["head_gemm"] = dur([dev[gemm_idx[-1]]])
            elif label == "backward":
                fams[label] = _families(dev[gemm_idx[0]:], names)
                fams[label]["cross_entropy"] = dur(dev[:gemm_idx[0]])
            else:
                fams[label] = {"optimizer": dur(dev)}
        fwd, bwd = fams["forward"], fams["backward"]
        remat = fwd["gemm_cuda"] - fwd.pop("head_gemm")
        ms = {"gemm_cuda_forward": fwd.pop("gemm_cuda"), "gemm_cuda_remat": remat,
              "gemm_cuda_backward": bwd.pop("gemm_cuda") - remat}
        for f in fams.values():
            for k, v in f.items():
                ms[k] = ms.get(k, 0.0) + v
    # The sums by kernel name alone read no position: from a trace that lost
    # events they are lower bounds, short by the lost kernels only.
    by_name = _families(seg["forward"]["events"] + seg["backward"]["events"])
    by_name["optimizer"] = dur(seg["optimizer"]["events"])
    for sg in seg.values():
        del sg["events"]
    wall = sum(s["wall_ms"] for s in seg.values())
    busy = sum(s["busy_ms"] for s in seg.values())
    top = {fam: dict(sorted(by.items(), key=lambda kv: -kv[1])[:8]) for fam, by in names.items()}
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall, "ms": ms,
            "ms_by_name": by_name, "complete": complete, "attempts": attempts, "segments": seg,
            "kernels_by_family": top}


def timed_step(torch, counts, fn):
    """``fn()`` timed on the host with the card synchronised on both sides;
    returns its result and ``{"wall_s", "launches"}`` (the launches it
    made, by kernel)."""

    c0 = counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    c1 = counts()
    return out, {"wall_s": wall, "launches": {k: c1[k] - c0[k] for k in c1}}


def eval_loss_of(torch, loss_fn, params, batch, ctx, counts, reset) -> tuple[float, dict]:
    """The eval loss of ``batch`` under ``inference_mode`` (attention on the
    flash kernel) and the launches it made."""

    reset()
    with ctx, torch.inference_mode():
        loss = float(loss_fn(params, batch)[0])
    return loss, counts()


def train_attention_launches(attn: int) -> dict:
    """A training step's flash launches with ``attn`` attention calls a
    forward: the log-sum-exp forward in the forward and again in the
    recompute, each backward kernel once, no inference launch and no
    ``chunked_attention`` call on the card."""

    return {"flash_attention_cuda": 0, "flash_attention_fwd_lse": 2 * attn,
            "flash_attention_bwd_dq": attn, "flash_attention_bwd_dkdv": attn, "chunked_attention": 0}


def train_scan_launches(scans: int) -> dict:
    """A training step's SSD scan launches with ``scans`` Mamba2 scans a
    forward: each forward kernel in the forward and again in the
    recompute, each backward kernel once, no ``_ssd_chunked`` call on the
    card."""

    from repro_torch.kernels import ssd as SSD

    return {"ssd_scan_cuda": 2 * scans, **{k: 2 * scans for k in SSD.FWD_KERNELS},
            **{k: scans for k in SSD.BWD_KERNELS}, "ssd_chunked": 0}


def check_train_steps(cfg, steps: list, per_step: int, eval_loss: float, attn: int,
                      scans: int = 0) -> None:
    """Each of ``steps`` (``launches``, ``loss``, ``grad_norm``, the MoE's
    ``aux``) launched ``per_step`` ``gemm_cuda``, the training attention's
    kernels for ``attn`` attention calls a forward
    (``train_attention_launches``), the SSD scan's for ``scans`` scans a
    forward (``train_scan_launches``) and no other kernel, with a finite
    loss and a finite, positive grad norm (and aux); the step-0 loss within
    ``TRAIN_EVAL_LOSS_TOL`` of the eval loss on the same batch."""

    want = {"gemm_cuda": per_step, **train_attention_launches(attn), **train_scan_launches(scans)}
    for i, s in enumerate(steps):
        lc = s["launches"]
        check(all(v == want.get(k, 0) for k, v in lc.items()),
              f"{cfg.name} step {i} launched {lc}, want {want} and no other kernel")
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) and s["grad_norm"] > 0,
              f"{cfg.name} step {i}: loss {s['loss']}, grad_norm {s['grad_norm']}")
        if cfg.family == "moe":
            check(math.isfinite(s["aux"]) and s["aux"] > 0, f"{cfg.name} step {i}: aux {s['aux']}")
    check(abs(steps[0]["loss"] - eval_loss) <= TRAIN_EVAL_LOSS_TOL,
          f"{cfg.name} step-0 training loss {steps[0]['loss']} vs eval loss {eval_loss}")


def little_tree_step(torch, trainer, batch, counts, per_step: int) -> dict:
    """One step of ``trainer`` under the little class's tree: every GEMM of
    the forward, the recompute and the backward on ``gemm_cuda_lean``."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes

    ctx = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("little")
    check(ctx.backend() == "cuda_lean", f"little backend {ctx.backend()}")
    big_ctx, trainer.exec_ctx = trainer.exec_ctx, ctx
    try:
        metrics, rec = timed_step(torch, counts, lambda: trainer.train_step(batch))
    finally:
        trainer.exec_ctx = big_ctx
    lc = rec["launches"]
    print(f"  one step under the little tree: {rec['wall_s'] * 1e3:.1f} ms, loss {float(metrics['loss']):.5f}, "
          f"launches {lc}", flush=True)
    check(lc["gemm_cuda_lean"] == per_step and lc["gemm_cuda"] == 0,
          f"little-tree step launched {lc}, want {per_step} gemm_cuda_lean and no gemm_cuda")
    check(math.isfinite(float(metrics["loss"])), "little-tree loss not finite")
    return {"ms": rec["wall_s"] * 1e3, "launches": lc}


def traced_bounds(torch, trainer, batch, counts, cfg, b: int, s: int, n_params: int, step_s: float, *,
                  transpose_ms: float | None = None, expert_flops: float | None = None) -> dict:
    """One traced step of ``trainer`` (``traced_train_step``) beside its
    bounds: the GEMMs' operations (``train_gemm_flops`` over ``b`` x ``s``
    tokens) at the bf16 peak, AdamW's bytes (7 fp32 words a parameter: read
    the master, its gradient and two moments, write three) at the memory
    rate, and, given ``expert_flops``, the MoE experts' ``bmm``;
    ``transpose_ms`` (phase 1's transposed copies of a step) is printed
    beside the copies.  ``step_s`` is the untraced median step."""

    n = forward_gemm_calls(cfg)
    traced = traced_train_step(torch, trainer, batch, counts, n)
    flops = train_gemm_flops(cfg, b, s)
    gemm_bound = sum(flops.values()) / PEAK_BF16 * 1e3
    opt_bytes = 7 * 4 * n_params
    opt_bound = opt_bytes / HBM_BW * 1e3
    tm = traced["ms"]
    gemm_ms = sum(v for k, v in tm.items() if k.startswith("gemm_cuda")) if tm else None
    idle_untraced = 1 - traced["busy_ms"] / (step_s * 1e3)
    seen = [[a[k]["gemm_events"] for k in a] for a in traced["attempts"]]
    print(f"  traced step ({len(seen)} tried; GEMM events the profiler saw {seen} of "
          f"{[g['gemm_launches'] for g in traced['segments'].values()]} launched): wall "
          f"{traced['wall_ms']:.1f} ms, device busy {traced['busy_ms']:.1f} ms (idle "
          f"{traced['idle_share']:.3f} traced, {idle_untraced:.3f} of the untraced median step"
          f"{'' if traced['complete'] else '; the trace lost events, so busy is a lower bound'})", flush=True)
    if tm:
        note = "" if transpose_ms is None else f"; of the copies, the transposes {transpose_ms:.1f} ms (phase 1)"
        print(f"  device ms by family { {k: round(v, 2) for k, v in sorted(tm.items())} }{note}", flush=True)
    else:
        print(f"  device ms by family: unavailable (no trace of {TRACE_ATTEMPTS} held every GEMM "
              f"launched; the split reads kernels by position); by kernel name, lower bounds "
              f"{ {k: round(v, 2) for k, v in sorted(traced['ms_by_name'].items())} }", flush=True)
    for fam in ("cublas_bf16", "cublas_fp32", "index_scatter"):
        top = list(traced["kernels_by_family"].get(fam, {}).items())[:3]
        if top:
            print(f"    {fam}: {[(k[:60], round(v, 2)) for k, v in top]}", flush=True)
    gemm_read = "unavailable" if gemm_ms is None else f"{gemm_ms:.1f} ms ({gemm_bound / gemm_ms:.3f} of the bound)"
    opt_read = "unavailable" if not tm else f"{tm['optimizer']:.1f} ms"
    extra = ""
    if expert_flops is not None:
        bmm_read = f"{tm['cublas_bf16']:.1f} ms" if tm and "cublas_bf16" in tm else "unavailable"
        extra = (f"; the experts' bmm {expert_flops / 1e12:.2f} TFLOP -> {expert_flops / PEAK_BF16 * 1e3:.1f} "
                 f"ms, measured (cuBLAS bf16) {bmm_read}")
    print(f"  bounds: GEMMs {sum(flops.values()) / 1e12:.2f} TFLOP (forward {flops['forward'] / 1e12:.2f}, "
          f"remat {flops['remat'] / 1e12:.2f}, backward {flops['backward'] / 1e12:.2f}) -> {gemm_bound:.1f} ms "
          f"at 989 TFLOP/s, measured {gemm_read}; AdamW {opt_bytes / 1e9:.1f} GB -> {opt_bound:.1f} ms at "
          f"3.35 TB/s, measured {opt_read}{extra}", flush=True)
    return {"traced_step": traced, "idle_share_untraced_step": idle_untraced, "gemm_flops": flops,
            "gemm_bound_ms": gemm_bound, "gemm_traced_ms": gemm_ms, "optimizer_bytes": opt_bytes,
            "optimizer_bound_ms": opt_bound}


def phase16(torch, counts, reset, transpose_ms: float) -> dict:
    """Training full-width internlm2-1.8b through ``launch/train.py``'s
    code path: 6 steps, one injected failure at step 2 restoring the
    step-0 checkpoint, launch counts, losses, memory, checkpoint I/O, one
    step under the little class's tree and one traced step.
    ``transpose_ms`` is phase 1's time of a step's transposed copies (the
    trace cannot tell them from the casts: both are copy kernels)."""

    import shutil
    import statistics
    import tempfile

    from repro_torch.kernels import gemm as G
    from repro_torch.launch import train as TL
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim import adamw as O
    from repro_torch.runtime.trainer import SimulatedFailure

    def mem_available_gb() -> float:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 1e9
        return float("nan")

    t_phase = time.perf_counter()
    ckdir = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        args = TL.build_parser().parse_args([
            "--arch", ARCH, "--steps", str(TRAIN_STEPS), "--global-batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt-dir", ckdir, "--ckpt-every", "100", "--seed", "0"])
        fails = {TRAIN_FAIL_AT}

        def hook(step):
            if step in fails:
                fails.discard(step)
                raise SimulatedFailure(step)

        t0 = time.perf_counter()
        trainer = TL.make_trainer(args, failure_hook=hook)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = trainer.arch
        check(trainer.exec_ctx.backend() == "cuda", f"trainer exec_backend {trainer.exec_ctx.backend()}")
        n_params = sum(p.numel() for p in O.tree_leaves(trainer.params))
        batch0, _ = trainer.next_batch(0)
        check(tuple(batch0["tokens"].shape) == (TRAIN_BATCH, TRAIN_SEQ), f"batch {batch0['tokens'].shape}")
        eval_loss, eval_launches = eval_loss_of(torch, Z.make_loss_fn(cfg), trainer.params, batch0,
                                                trainer.exec_ctx, counts, reset)
        check(eval_launches["flash_attention_cuda"] == cfg.n_layers, f"the eval loss launched {eval_launches}")

        # Instrument the loop: each step's launches and wall, the save's and
        # the restore's seconds.
        steps, io = [], {"saves": [], "writes": [], "restores": []}
        orig_step, orig_ckpt, orig_restart = trainer.train_step, trainer._checkpoint, trainer._restart
        orig_write = trainer.ckpt._write

        def step_fn(batch):
            out, rec = timed_step(torch, counts, lambda: orig_step(batch))
            steps.append({"step": trainer.step, **rec})
            return out

        def ckpt_fn():
            io["disk_free_gb"] = shutil.disk_usage(ckdir).free / 1e9
            io["mem_available_gb"] = mem_available_gb()
            t = time.perf_counter()
            orig_ckpt()
            io["saves"].append(time.perf_counter() - t)

        def write_fn(*a):
            t = time.perf_counter()
            orig_write(*a)
            io["writes"].append(time.perf_counter() - t)

        def restart_fn():
            t = time.perf_counter()
            trainer.ckpt.wait()
            t_wait = time.perf_counter() - t
            t = time.perf_counter()
            orig_restart()
            torch.cuda.synchronize()
            io["restores"].append({"wait_s": t_wait, "restore_s": time.perf_counter() - t})

        trainer.train_step, trainer._checkpoint, trainer._restart = step_fn, ckpt_fn, restart_fn
        trainer.ckpt._write = write_fn
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        history = trainer.run()
        run_s = time.perf_counter() - t0
        launches = counts()
        gemm_flops = G.LAUNCH_FLOPS["gemm_cuda"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_dir = os.path.join(ckdir, "step_00000000")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        trainer.train_step = orig_step

        n_steps = len(history)
        per_step = 4 * forward_gemm_calls(cfg) - 1
        losses = [h["loss"] for h in history]
        walls = [s["wall_s"] for s in steps]
        step_s = statistics.median(walls[-4:])
        print(f"phase 16: {cfg.name} ({n_params / 1e9:.3f} B parameters) trained {n_steps} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {run_s:.1f} s with {trainer.restarts} restart; "
              f"losses {[round(x, 5) for x in losses]}; eval loss of batch 0 {eval_loss:.5f}; "
              f"step wall {[round(w, 4) for w in walls]} s (median of steps 2-5 {step_s * 1e3:.1f} ms, "
              f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s); launches {launches}; peak "
              f"{peak_gb:.2f} GB; init {init_s:.1f} s", flush=True)
        print(f"  checkpoint: {ckpt_bytes / 1e9:.2f} GB; save {io['saves']} s on the loop, write "
              f"{io['writes']} s on its thread; restore {io['restores']}; free disk "
              f"{io.get('disk_free_gb', float('nan')):.1f} GB, host memory available "
              f"{io.get('mem_available_gb', float('nan')):.1f} GB", flush=True)
        check(n_steps == TRAIN_STEPS + TRAIN_FAIL_AT and trainer.restarts == 1 and trainer.step == TRAIN_STEPS,
              f"steps {n_steps}, restarts {trainer.restarts}, step {trainer.step}")
        check_train_steps(cfg, [{**s, **h} for s, h in zip(steps, history)], per_step, eval_loss,
                          cfg.n_layers)
        check(launches["gemm_cuda"] == per_step * n_steps, f"gemm_cuda launches {launches['gemm_cuda']}")
        check(abs(losses[0] - math.log(cfg.vocab)) < 0.5,
              f"step-0 loss {losses[0]} not within 0.5 of ln V = {math.log(cfg.vocab):.3f}")
        # history: steps 0 .. FAIL_AT-1, then the replay from step 0.
        first, replay = history[:TRAIN_FAIL_AT], history[TRAIN_FAIL_AT:2 * TRAIN_FAIL_AT]
        check(replay[0]["loss"] == first[0]["loss"], f"replayed step-0 loss {replay[0]['loss']} != "
              f"{first[0]['loss']}")
        bitwise = [r["loss"] == f["loss"] for f, r in zip(first, replay)]
        for f, r in zip(first, replay):
            check(abs(r["loss"] - f["loss"]) <= TRAIN_REPLAY_RTOL * abs(f["loss"]),
                  f"replayed loss {r['loss']} vs {f['loss']}")
        print(f"  replay of steps 0-{TRAIN_FAIL_AT - 1}: bitwise equal {bitwise}; "
              f"grad_norm {[round(h['grad_norm'], 4) for h in history]}; lr {[h['lr'] for h in history]}",
              flush=True)

        batch, _ = trainer.next_batch(TRAIN_STEPS)
        out = {
            "arch": cfg.name, "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "losses": losses, "eval_loss_step0": eval_loss, "replay_bitwise": bitwise,
            "grad_norms": [h["grad_norm"] for h in history], "lrs": [h["lr"] for h in history],
            "restarts": trainer.restarts, "step_walls_s": walls, "step_ms": step_s * 1e3,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "run_s": run_s, "init_s": init_s,
            "peak_gb": peak_gb, "ckpt_bytes": ckpt_bytes, "ckpt_io": io, "launches": launches,
            "steps_run": n_steps, "gemm_cuda_flops": gemm_flops,
            "launches_per_step": per_step, "transpose_ms_phase1": transpose_ms,
            "little_step": little_tree_step(torch, trainer, batch, counts, per_step),
            **traced_bounds(torch, trainer, batch, counts, cfg, TRAIN_BATCH, TRAIN_SEQ, n_params, step_s,
                            transpose_ms=transpose_ms),
        }
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 16 took {out['phase_s']:.1f} s", flush=True)
    return out


# Training the other families (phases 17-19), 8 x 512 tokens a step as in
# phase 16 unless named.  qwen2-moe-a2.7b keeps MOE_TRAIN_LAYERS of its 24
# layers: fp32 masters, their gradients, AdamW's two moments and the bf16
# cast take 18 B a parameter, 258 GB for the 14.32 B parameters of 24
# layers and 52.3 GB for the 2.905 B of 4.
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, FAMILY_TRAIN_STEPS = 4, 6, 4
# whisper-small's gradient steps: phase 15's batch, its published 448-token
# decoder context over 1,500 frames, 2 rows.
ENCDEC_TRAIN_BATCH = 2
# One Mamba2 block's gradients against the float64 block (phase 18): 2 rows
# of 512 tokens (two of the scan's 256-step chunks, so the gradient of the
# state carried across a chunk is held), input and cotangent drawn from each
# of BLOCK_GRAD_SEEDS, each gradient row within BLOCK_GRAD_ROW_TOL of its
# norm.  The bf16 block rounds a dozen intermediates (the projections, the
# convs, the scan's output, the gate, the norm) that float64 keeps; every
# planted fault of BLOCK_FAULTS in the float64 block must put some row
# outside the limit, at every seed.  The sound block's worst row is the input
# gradient's (its four paths' contributions partly cancel), the subtlest
# fault is norm_eps; PERF.md gives both readings on an H100 for these seeds,
# and the limit lies between them.
BLOCK_GRAD_ROWS, BLOCK_GRAD_ROW_TOL = 2, 5e-2
BLOCK_GRAD_SEEDS = tuple(range(1, 13))
BLOCK_FAULTS = {
    "chunk_state": "each 256-token chunk run apart: the conv history and the state across the boundary dropped",
    "no_D": "the D skip dropped",
    "exclusive_cumsum": "the decay from s to t summed over dt_s .. dt_t-1 (an exclusive cumsum)",
    "norm_eps": "the gated norm's eps 1e-2 in place of 1e-5",
}


def forward_gemm_calls(cfg) -> int:
    """``ops.gemm`` calls of one forward (``step_gemm_shapes``).  A
    training step launches 4n - 1 of them: the forward, its recompute less
    the head, and two backward products each."""

    return sum(c for *_, c in step_gemm_shapes(cfg, 1, 1))


def step_gemm_shapes(cfg, b: int, s: int) -> list:
    """``(M, K, N, calls)`` of every forward GEMM of a training step over
    ``b`` x ``s`` tokens: the decoder-only families' (``gemm_shapes``) at M
    = b x s; the enc-dec's at its frames' rows (6 an encoder layer: q, k,
    v, o, the MLP's two; the cross K and V of each decoder layer) and at
    its tokens' (10 a decoder layer less the cross K and V, the tied
    head)."""

    if cfg.family != "encdec":
        return [(b * s, k, n, c) for (k, n), c in gemm_shapes(cfg)]
    d, ff, le, ld = cfg.d_model, cfg.d_ff, cfg.enc_layers, cfg.n_layers
    me, md = b * cfg.enc_frames, b * s
    return [(me, d, d, 4 * le + 2 * ld), (me, d, ff, le), (me, ff, d, le),
            (md, d, d, 6 * ld), (md, d, ff, ld), (md, ff, d, ld), (md, d, cfg.vocab, 1)]


def mamba2_block_f64(torch, p, x, cfg, fault: str | None = None):
    """A Mamba2 block in float64, written apart from ``models/ssm.py``: the
    projections, the causal depthwise convs and the SSD in its quadratic
    form (every position against every earlier one, no chunks).  ``p``
    holds one layer's params, ``x`` is (B, S, D); returns (B, S, D).
    ``fault`` plants one of ``BLOCK_FAULTS`` (not ``chunk_state``, which
    ``mamba2_block_grads`` makes by cutting the sequence)."""

    import torch.nn.functional as F

    b, s, _ = x.shape
    h, hp, n, gn = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.n_groups * cfg.d_state

    def conv(u, w, bias):
        pad = F.pad(u, (0, 0, cfg.d_conv - 1, 0))
        return F.silu(sum(pad[:, i:i + s] * w[i] for i in range(cfg.d_conv)) + bias)

    z = x @ p["wz"]
    xu = conv(x @ p["wx"], p["conv_w_x"], p["conv_b_x"]).reshape(b, s, h, hp)
    bc = conv(x @ p["wbc"], p["conv_w_bc"], p["conv_b_bc"])
    rep = h // cfg.n_groups
    bm = bc[..., :gn].reshape(b, s, cfg.n_groups, n).repeat_interleave(rep, dim=2)
    cm = bc[..., gn:].reshape(b, s, cfg.n_groups, n).repeat_interleave(rep, dim=2)
    dt = F.softplus(x @ p["wdt"] + p["dt_bias"])                             # (B, S, H)
    a = -torch.exp(p["A_log"]) * dt
    cum = torch.cumsum(a, dim=1) - (a if fault == "exclusive_cumsum" else 0)
    cum = cum.transpose(1, 2)                                                # (B, H, S)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal, cum[:, :, :, None] - cum[:, :, None, :],
                      torch.full((), -torch.inf, dtype=x.dtype, device=x.device))
    scores = torch.einsum("bthn,bshn->bhts", cm, bm) * torch.exp(seg) * dt.transpose(1, 2)[:, :, None, :]
    y = torch.einsum("bhts,bshp->bthp", scores, xu)
    if fault != "no_D":
        y = y + p["D"][None, None, :, None] * xu
    y = y.reshape(b, s, h * hp) * F.silu(z)
    eps = 1e-2 if fault == "norm_eps" else 1e-5
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + eps) * p["norm_w"]
    return y @ p["out_proj"]


def mamba2_block_grads(torch, masters, cfg, seed: int) -> dict:
    """One Mamba2 block at full width on the card: its output's, its
    input's and every parameter's gradient through the model's block
    (``ssm.apply_mamba2`` on the bf16 cast of the fp32 masters, as training
    casts them) against the float64 block on the same values and the same
    unit-scale cotangent, in L2 relative to each row's norm (a vector's one
    row); then against the float64 block with each planted fault of
    ``BLOCK_FAULTS``: its worst row over every leaf the faulty block still
    reaches, and over the parameters' gradients alone."""

    from repro_torch.models import ssm as S

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (BLOCK_GRAD_ROWS, TRAIN_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_(True)
    ct = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    from repro_torch.kernels import ssd as SSD

    pb = {k: v.detach().to(torch.bfloat16).requires_grad_(True) for k, v in masters.items()}
    launched = dict(SSD.LAUNCHES)
    y, _ = S.apply_mamba2(pb, x, cfg)
    y.backward(ct)
    kernel_scans = {k: SSD.LAUNCHES[k] - launched[k] for k in ("ssd_scan_cuda", "ssd_bwd_dx")}
    got = {"y": y.detach(), "x": x.grad, **{k: v.grad for k, v in pb.items()}}
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    rel = lambda a, b: row_rel_err(a if a.ndim > 1 else a[None], b if b.ndim > 1 else b[None])  # noqa: E731

    def against(fault):
        pd = {k: v.detach().double().requires_grad_(True) for k, v in pb.items()}
        xd = x.detach().double().requires_grad_(True)
        if fault == "chunk_state":
            yd = torch.cat([mamba2_block_f64(torch, pd, xd[:, i:i + cfg.chunk], cfg)
                            for i in range(0, shape[1], cfg.chunk)], dim=1)
        else:
            yd = mamba2_block_f64(torch, pd, xd, cfg, fault)
        yd.backward(ct.double())
        want = {"y": yd.detach(), "x": xd.grad, **{k: v.grad for k, v in pd.items()}}
        return {k: rel(got[k].double(), want[k]) for k in sorted(got) if want[k] is not None}

    faults = {}
    for fault in BLOCK_FAULTS:
        e = against(fault)
        faults[fault] = {"worst": list(max(e.items(), key=lambda kv: kv[1])), "x": e["x"],
                         "worst_param": list(max(((k, v) for k, v in e.items() if k not in ("x", "y")),
                                                 key=lambda kv: kv[1]))}
    return {"rows": list(shape[:2]), "max_row_rel_err": against(None), "finite": finite, "faults": faults,
            "kernel_scans": kernel_scans}


def check_mamba2_block(torch, masters, cfg) -> dict:
    """Layer 0's Mamba2 block against float64 (``mamba2_block_grads``) at
    each of ``BLOCK_GRAD_SEEDS``: every gradient row within
    ``BLOCK_GRAD_ROW_TOL``, and every planted fault, at every seed, outside
    it."""

    runs = {seed: mamba2_block_grads(torch, masters, cfg, seed) for seed in BLOCK_GRAD_SEEDS}
    worst = {seed: max(r["max_row_rel_err"].items(), key=lambda kv: kv[1]) for seed, r in runs.items()}
    by_leaf = {k: max(r["max_row_rel_err"][k] for r in runs.values()) for k in runs[BLOCK_GRAD_SEEDS[0]]
               ["max_row_rel_err"]}
    print(f"  layer 0's Mamba2 block, {BLOCK_GRAD_ROWS} x {TRAIN_SEQ} tokens a seed, against float64 (tol "
          f"{BLOCK_GRAD_ROW_TOL}): worst row by seed {[(s, k, round(v, 4)) for s, (k, v) in worst.items()]}; "
          f"by leaf over the seeds { {k: round(v, 4) for k, v in by_leaf.items()} }", flush=True)
    for seed, r in runs.items():
        check(r["kernel_scans"] == {"ssd_scan_cuda": 1, "ssd_bwd_dx": 1},
              f"the block's scan at seed {seed} did not run the SSD kernels: {r['kernel_scans']}")
        check(r["finite"] and worst[seed][1] <= BLOCK_GRAD_ROW_TOL,
              f"the Mamba2 block's gradients off float64 by {worst[seed][1]} ({worst[seed][0]}) at seed "
              f"{seed}, over {BLOCK_GRAD_ROW_TOL}")
    for fault, what in BLOCK_FAULTS.items():
        reads = {seed: r["faults"][fault] for seed, r in runs.items()}
        least = min(reads.items(), key=lambda kv: kv[1]["worst"][1])
        print(f"  planted fault {fault} ({what}): worst row (leaf, all leaves, parameters alone) by seed "
              f"{[(s, v['worst'][0], round(v['worst'][1], 4), round(v['worst_param'][1], 4)) for s, v in reads.items()]}",
              flush=True)
        check(least[1]["worst"][1] > BLOCK_GRAD_ROW_TOL,
              f"planted fault {fault} passed the block check at seed {least[0]} ({least[1]['worst']})")
    return {"seeds": runs, "tol": BLOCK_GRAD_ROW_TOL}


def train_family(torch, counts, reset, arch: str, *, steps: int, layers: int | None = None,
                 little: bool = False, block_check: bool = False) -> dict:
    """Train ``arch`` at full width (depth cut to ``layers``) through
    ``launch/train.py``'s trainer: ``steps`` steps of TRAIN_BATCH x
    TRAIN_SEQ tokens (``check_train_steps``: each 4n - 1 ``gemm_cuda``, n
    the forward's GEMMs, and no other kernel; the step-0 loss against the
    eval loss, whose attention runs the flash kernel); step ms (median of
    the steps after the first two, after the first for 4 steps), tokens/s
    and peak memory; for the MoE the share of routing decisions the
    training and eval forwards agree on (printed: random init makes
    routing fragile); with ``little`` one step under the little class's
    tree; with ``block_check`` layer 0's Mamba2 block against float64; one
    traced step against its bounds; the step's GEMM backward against the
    plain versions (``gemm_backward_check``).  The loop calls the
    trainer's step: ``run`` would first save a step-0 checkpoint (35 GB
    for the MoE)."""

    import dataclasses
    import shutil
    import statistics
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as TL
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import moe as M
    from repro_torch.optim import adamw as O

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    per_step = 4 * forward_gemm_calls(cfg) - 1
    ckdir = tempfile.mkdtemp(prefix="repro_torch_train_")
    real_route = M.route
    try:
        args = TL.build_parser().parse_args([
            "--arch", arch, "--steps", str(steps), "--global-batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt-dir", ckdir, "--seed", "0"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = TL.make_trainer(args, cfg=cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(trainer.exec_ctx.backend() == "cuda", f"trainer exec_backend {trainer.exec_ctx.backend()}")
        n_params = sum(p.numel() for p in O.tree_leaves(trainer.params))
        batch0, _ = trainer.next_batch(0)

        # The MoE's routing: layer by layer, the eval forward's and the
        # training step 0's (its forward, not the recompute).
        routes = {"eval": [], "train": []}
        mode = {"now": "eval"}

        def route(p, x, mcfg):
            out = real_route(p, x, mcfg)
            if len(routes[mode["now"]]) < cfg.n_layers:
                routes[mode["now"]].append(out[1].clone())
            return out

        if cfg.family == "moe":
            M.route = route
        eval_loss, eval_launches = eval_loss_of(torch, Z.make_loss_fn(cfg), trainer.params, batch0,
                                                trainer.exec_ctx, counts, reset)
        mode["now"] = "train"

        steps_rec = []
        reset()
        for step in range(steps):
            batch, _ = trainer.next_batch(step)
            metrics, rec = timed_step(torch, counts, lambda: trainer.train_step(batch))
            steps_rec.append({**rec, **{k: float(v) for k, v in metrics.items()}})
            trainer.step += 1
            M.route = real_route
        launches = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        losses = [s["loss"] for s in steps_rec]
        walls = [s["wall_s"] for s in steps_rec]
        step_s = statistics.median(walls[2:] if steps > 4 else walls[1:])
        agree = None
        if cfg.family == "moe":
            agree = float(torch.stack([(a == b).float().mean() for a, b in
                                       zip(routes["train"], routes["eval"])]).mean())
        print(f"  {cfg.name} ({cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters): {steps} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens; losses {[round(x, 5) for x in losses]}; eval loss "
              f"{eval_loss:.5f} (launches {eval_launches}); grad_norm "
              f"{[round(s['grad_norm'], 4) for s in steps_rec]}"
              f"{'; aux ' + str([round(s['aux'], 6) for s in steps_rec]) if cfg.family == 'moe' else ''}; "
              f"step wall {[round(w, 4) for w in walls]} s (median {step_s * 1e3:.1f} ms, "
              f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s); launches {launches} "
              f"({per_step} gemm_cuda a step); peak {peak_gb:.2f} GB; init {init_s:.1f} s"
              f"{'' if agree is None else f'; train vs eval routing agrees on {agree:.3f} of decisions'}",
              flush=True)
        check_train_steps(cfg, steps_rec, per_step, eval_loss, eval_launches["flash_attention_cuda"],
                          eval_launches["ssd_scan_cuda"])
        out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "losses": losses, "eval_loss_step0": eval_loss,
               "eval_launches": eval_launches, "steps": steps_rec, "step_ms": step_s * 1e3,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "peak_gb": peak_gb, "init_s": init_s,
               "launches": launches, "launches_per_step": per_step, "routing_agreement": agree}
        if little:
            out["little_step"] = little_tree_step(torch, trainer, trainer.next_batch(steps)[0], counts, per_step)
        if block_check:
            out["block_grads"] = check_mamba2_block(
                torch, {k: v[0] for k, v in trainer.params["blocks"]["mamba"].items()}, cfg.ssm)

        expert_flops = None
        if cfg.family == "moe":
            # The experts' three products a layer over every capacity slot:
            # forward, recompute and the backward's two products each.
            from repro_torch.models.moe import _capacity

            rows = TRAIN_BATCH * _capacity(TRAIN_SEQ, cfg.moe)
            expert_flops = 4 * cfg.n_layers * 3 * 2 * cfg.moe.n_experts * rows * cfg.d_model * cfg.moe.d_ff_expert
            out["expert_flops"], out["expert_bound_ms"] = expert_flops, expert_flops / PEAK_BF16 * 1e3
        out.update(traced_bounds(torch, trainer, trainer.next_batch(steps + 1)[0], counts, cfg, TRAIN_BATCH,
                                 TRAIN_SEQ, n_params, step_s, expert_flops=expert_flops))
        del trainer, batch, batch0
        gc.collect()
        torch.cuda.empty_cache()
        out["backward_products"] = gemm_backward_check(torch, cfg.name,
                                                       step_gemm_shapes(cfg, TRAIN_BATCH, TRAIN_SEQ), seed=4)
    finally:
        M.route = real_route
        shutil.rmtree(ckdir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  {cfg.name} took {out['phase_s']:.1f} s", flush=True)
    return out


def phase19(torch, counts, reset) -> dict:
    """Gradient steps of the full-width whisper-small (random fp32 masters
    from seed 0) through ``make_loss_fn``, ``value_and_grad`` and
    ``adamw_update``, over 2 x 448 tokens and 1,500 frames from
    ``launch/score.make_batch``: 771 ``gemm_cuda`` a step (193 forward, 192
    recomputed: the encoder always, the decoder under remat; 386 backward)
    and no flash attention; the step-0 loss within ``TRAIN_EVAL_LOSS_TOL``
    of the eval loss, which runs ``flash_attention_cuda``; step ms, one
    traced step against its bounds (the device's idle share), the step's
    GEMM backward against the plain versions."""

    import statistics

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.launch import score as SC
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim import adamw as O

    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    n = forward_gemm_calls(cfg)
    per_step = 4 * n - 1
    params = O.tree_map(lambda p: p.requires_grad_(True),
                        Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                                      dtype=torch.float32))
    n_params = sum(p.numel() for p in O.tree_leaves(params))
    ctx = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("big")
    state = types.SimpleNamespace(loss_fn=Z.make_loss_fn(cfg), params=params, opt_state=O.init_opt_state(params),
                                  opt_cfg=O.AdamWConfig(total_steps=FAMILY_TRAIN_STEPS), exec_ctx=ctx)
    del params
    batch, labels = SC.make_batch(cfg, ENCDEC_TRAIN_BATCH, DEC_CTX, 0, "cuda")
    batch["labels"] = labels
    eval_loss, eval_launches = eval_loss_of(torch, state.loss_fn, state.params, batch, ctx, counts, reset)

    def step():
        with ctx:
            loss, _, grads = O.value_and_grad(state.loss_fn, state.params, batch)
            state.params, state.opt_state, om = O.adamw_update(state.params, grads, state.opt_state,
                                                               state.opt_cfg)
        return {"loss": loss, "grad_norm": om["grad_norm"]}

    torch.cuda.reset_peak_memory_stats()
    rec = []
    reset()
    for _ in range(FAMILY_TRAIN_STEPS):
        metrics, r = timed_step(torch, counts, step)
        rec.append({**r, **{k: float(v) for k, v in metrics.items()}})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median([r["wall_s"] for r in rec[1:]])
    print(f"phase 19: {cfg.name} ({n_params / 1e9:.3f} B parameters) {FAMILY_TRAIN_STEPS} gradient steps of "
          f"{ENCDEC_TRAIN_BATCH} x {DEC_CTX} tokens over {cfg.enc_frames} frames: losses "
          f"{[round(r['loss'], 5) for r in rec]}; eval loss {eval_loss:.5f} (launches {eval_launches}); "
          f"grad_norm {[round(r['grad_norm'], 4) for r in rec]}; step wall "
          f"{[round(r['wall_s'], 4) for r in rec]} s (median {step_s * 1e3:.1f} ms); launches a step "
          f"{rec[0]['launches']} ({per_step} gemm_cuda); peak {peak_gb:.2f} GB", flush=True)
    check(n == 193, f"whisper-small's forward makes {n} GEMMs, want 193")
    check(eval_launches["flash_attention_cuda"] > 0, f"the eval loss launched {eval_launches}")
    check_train_steps(cfg, rec, per_step, eval_loss, eval_launches["flash_attention_cuda"])
    out = {"arch": cfg.name, "params": n_params, "batch": ENCDEC_TRAIN_BATCH, "dec_tokens": DEC_CTX,
           "frames": cfg.enc_frames, "eval_loss_step0": eval_loss, "eval_launches": eval_launches,
           "steps": rec, "step_ms": step_s * 1e3, "peak_gb": peak_gb, "launches_per_step": per_step,
           "launches": {k: sum(r["launches"][k] for r in rec) for k in rec[0]["launches"]},
           **traced_bounds(torch, state, batch, counts, cfg, ENCDEC_TRAIN_BATCH, DEC_CTX, n_params, step_s)}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out["backward_products"] = gemm_backward_check(torch, cfg.name,
                                                   step_gemm_shapes(cfg, ENCDEC_TRAIN_BATCH, DEC_CTX), seed=4)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 19 took {out['phase_s']:.1f} s", flush=True)
    return out


# The class-sharded mixed step (phases 20, 21): the big pod's rows on
# gemm_cuda, the little pod's on gemm_cuda_lean, each pod on its own CUDA
# stream.  Every recurrence step of a mixed decode launches a full decode
# step's GEMMs on each pod; the paged one also 24 paged_attention_cuda on
# each pod's page partition.
MIXED = ["--class-sharded", "on"]
MIXED_SHARDS = [(0, "big", "cuda"), (1, "little", "cuda_lean")]
# Timed decode steps of each variant of phase 20 (in turns).
MIXED_TIMED_STEPS = 5
# Phase 21: the global gradient norm of the mixed step's step 0 against
# the single-class step's, same params and batch.  Each pod's dB = Aᵀ·dC
# comes back rounded to bf16 (an operand's dtype) before the epilogue sums
# the pods in fp32, where the single-class step rounds one sum: two
# roundings of 2^-9 each bound an element's relative difference by 2^-8
# (0.4%), and the little pod's other block shapes move the fp32 sums by
# far less; a norm, a root of a sum over 1.9 B squares, moves less than
# its worst element.  So 2% holds the sound step with a factor of five to
# spare, while a pod's weight dropped from the epilogue removes a quarter
# of the tokens (the little pod's 2 rows of 8) and moves the norm by tens
# of percent.
MIXED_GRAD_NORM_RTOL = 0.02
# Phase 21 also holds the gradients slice by slice: every leaf, the layer
# stack's split into its 24 layers, by the relative L2 of (mixed -
# single-class), the worst slice against MIXED_GRAD_SLICE_RTOL.  A norm
# misses errors that keep the total (rows of the wrong pod, a leaf
# swapped, part of one pod lost); a slice cannot hide them.  The sound
# step differs by the roundings above, compounded through the little
# pod's other blocks over 24 layers; the worst slice is one summed over
# every token and rounded once a pod (a norm weight, the embedding),
# where the two pods' terms partly cancel and a rounding of 2^-9 grows
# against their sum to a percent or two.  The planted fault zeroes the
# little pod's gradients of one layer in the epilogue, which moves the
# global norm by a few tenths of a percent at most but takes the little
# pod's share, at least the 14.4% its whole weight moved the norm by
# (AS), out of that layer's slices.
# 5% sits between the two with a factor of two or more on each side.
MIXED_GRAD_SLICE_RTOL = 0.05
MIXED_FAULT_LAYER = 12


def mixed_launches(c: dict, steps: int, paged: bool, gemms: int, attn: int = 0) -> str | None:
    """Why ``c`` (a run's launches) is not ``steps`` mixed steps (``gemms``
    ``gemm_cuda`` and ``gemm_cuda_lean`` each a step, 2 x 24
    ``paged_attention_cuda`` when ``paged``, and the training attention's
    kernels for ``attn`` attention calls a step, both pods'), or None when
    it is."""

    want = {"gemm_cuda": gemms * steps, "gemm_cuda_lean": gemms * steps,
            "paged_attention_cuda": 2 * 24 * steps if paged else 0,
            **{k: v * steps for k, v in train_attention_launches(attn).items()}}
    bad = {k: (c[k], v) for k, v in want.items() if c[k] != v}
    return f"launches (got, want) {bad}" if bad else None


def stream_overlap(torch, prof) -> dict:
    """The kernels of a traced run by CUDA stream (``device_resource_id``):
    each stream's busy ms (the union of its kernels' intervals), the GEMMs
    on it, and how long the two busiest streams ran kernels at once."""

    from torch.autograd import DeviceType

    from repro_torch.launch.profile_decode import _union_us

    dev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    check(bool(dev), "the profiler saw no device activity in the mixed step")
    by_stream: dict = {}
    for e in dev:
        by_stream.setdefault(e.device_resource_id, []).append(e)

    def merged(events):
        out = []
        for s, t in sorted((e.time_range.start, e.time_range.end) for e in events):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    rows = {sid: {"busy_ms": _union_us((e.time_range.start, e.time_range.end) for e in evs) / 1e3,
                  "kernels": len(evs), "gemms": sum("gemm_kernel<" in e.name.lower() for e in evs)}
            for sid, evs in by_stream.items()}
    pods = sorted((sid for sid in rows if rows[sid]["gemms"]), key=lambda s: -rows[s]["gemms"])[:2]
    both = 0.0
    if len(pods) == 2:
        a, b = merged(by_stream[pods[0]]), merged(by_stream[pods[1]])
        i = j = 0
        while i < len(a) and j < len(b):
            both += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
            if a[i][1] < b[j][1]:
                i += 1
            else:
                j += 1
    busy = _union_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    shorter = min((rows[s]["busy_ms"] for s in pods), default=0.0)
    return {"streams": {str(k): v for k, v in rows.items()}, "gemm_streams": [str(s) for s in pods],
            "busy_ms": busy, "overlap_ms": both / 1e3,
            "overlap_share_of_shorter_pod": both / 1e3 / shorter if shorter else 0.0}


def phase20(torch, counts, reset, s2: dict) -> dict:
    """Mixed serving of the full-width internlm2-1.8b (phase 2's weights and
    requests) through ``launch/serve.py --class-sharded on``: the dense
    engine, the paged engine and the one-shot path, their launch counts, a
    planted fault (both pods under the big tree), engine == one-shot,
    paged vs dense logits, a teacher-forced replay of each pod's rows
    against its class's single-program path, the provenance, one traced
    mixed step (the pods' kernels on two streams, their overlap) and its
    wall time beside the single-program step's and the mixed step's on one
    stream."""

    import statistics

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import execution as X
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.distributed.sharding import pod_decode_specs
    from repro_torch.launch import serve as SV
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as Z

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    gemms = 7 * cfg.n_layers + 1
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    base = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--gen-len", str(GEN_LEN), "--seed", "0"] + MIXED
    runs = {}
    for label, extra in (("dense", []), ("paged", ["--paged", "on", "--page-size", str(PAGE_SIZE)]),
                         ("one_shot", ["--one-shot"])):
        reset()
        s, tok, eng, wall = run_serve(base + extra, params=params)
        c = counts()
        steps = PROMPT_LEN * eng.stats.admission_rounds + eng._step_calls if eng else PROMPT_LEN + GEN_LEN
        why = mixed_launches(c, steps, label == "paged", gemms)
        shards = [(p, cls, be) for p, cls, _, be in s["shard_classes"]]
        print(f"phase 20: mixed {label}: {s['device_class']} ({s['exec_backend']}) shards "
              f"{s['shard_classes']}; smoke reading {s['tokens_per_s']} tokens/s, wall {wall:.2f} s; "
              f"recurrence steps {steps}; launches {c}", flush=True)
        check(why is None, f"phase 20 mixed {label}: {why}")
        check(s["class_sharded"] is True and s["device_class"] == "mixed", f"phase 20 {label}: {s}")
        check(shards == MIXED_SHARDS, f"phase 20 {label} shard classes {s['shard_classes']}")
        check(tok.shape == (BATCH, PROMPT_LEN + GEN_LEN), f"phase 20 {label} tokens {tok.shape}")
        runs[label] = {"summary": s, "tokens": tok, "engine": eng, "wall_s": wall, "launches": c,
                       "steps": steps}
    dense, paged = runs["dense"]["engine"], runs["paged"]["engine"]
    check(np.array_equal(runs["dense"]["tokens"], runs["one_shot"]["tokens"]),
          "phase 20: the mixed engine's tokens differ from the mixed one-shot path's")
    busy = torch.as_tensor([c.slot for c in dense.completions], device="cuda")
    dlog = float((paged.prefill_logits[busy].float() - dense.prefill_logits[busy].float()).abs().max())
    print(f"  engine == one-shot: True; paged vs dense first-step max |logit diff| {dlog:.4f} "
          f"(tol {LOGIT_TOL})", flush=True)
    check(dlog <= LOGIT_TOL, f"phase 20: paged vs dense logits differ by {dlog}")

    # The planted fault: the same step with both pods under the big tree.
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    big = asym.execution_context("big")
    rows = dense.n_slots
    state = Z.init_decode_state(cfg, rows, PROMPT_LEN + GEN_LEN, device="cuda")
    in_specs, out_specs = pod_decode_specs(state, batch_keys=("tokens", "live"))
    faulty = X.class_sharded(Z.make_decode_fn(cfg), mesh=make_host_mesh(pod=2), contexts=[big, big],
                             pod_class=[0, 1], in_specs=in_specs, out_specs=out_specs)
    batch = {"tokens": torch.zeros((rows, 1), dtype=torch.int32, device="cuda"),
             "live": torch.ones(rows, dtype=torch.bool, device="cuda")}
    pos = torch.zeros(rows, dtype=torch.int32, device="cuda")
    reset()
    with torch.no_grad():
        faulty(params, batch, state, pos)
    torch.cuda.synchronize()
    caught = mixed_launches(counts(), 1, False, gemms)
    print(f"  planted fault (both pods under the big tree): {caught}", flush=True)
    check(caught is not None, "phase 20: the launch check passed a step with both pods under big")

    # Teacher-forced replay of the dense engine's tokens over the padded
    # batch: the mixed step's big rows against the big path's, its little
    # rows against the little path's.
    layout = asym.batch_layout(BATCH)
    padded, _ = SV.pad_requests(runs["dense"]["tokens"], layout)
    c_max, total = layout.c_max, PROMPT_LEN + GEN_LEN
    toks = torch.as_tensor(padded, device="cuda")
    step = SV.mixed_decode_step(cfg, asym, make_host_mesh(pod=2), len(padded), total)
    decode = Z.make_decode_fn(cfg)

    def replay(fn, ctx):
        st, out = Z.init_decode_state(cfg, len(padded), total, device="cuda"), []
        with torch.no_grad(), ctx:
            for t in range(total - 1):
                lg, st = fn(params, {"tokens": toks[:, t:t + 1]}, st, t)
                if t >= PROMPT_LEN - 1:
                    out.append(lg[:, 0].float())
        return out

    mixed, replay_ms = pod_replay(torch, step, params, padded, total, len(padded))
    streams = {"tokens": {k: r["tokens"] for k, r in runs.items()},
               "kv": {k: r["engine"].kv_stats() for k, r in runs.items() if r["engine"] is not None},
               "replay": mixed, "replay_tokens": padded, "replay_ms": replay_ms}
    mixed = [m.cuda() for m in mixed]
    diffs = {}
    for pod, cls in enumerate(("big", "little")):
        ref = replay(decode, asym.execution_context(cls))
        sl = slice(pod * c_max, (pod + 1) * c_max)
        diffs[cls] = [float((m[sl] - r[sl]).abs().max()) for m, r in zip(mixed, ref)]
        print(f"  replay, the {cls} pod's rows against the {cls} class's single-program path: max "
              f"|logit diff| per step {[round(x, 4) for x in diffs[cls]]} (tol {LOGIT_TOL})", flush=True)
        check(all(math.isfinite(x) and x <= LOGIT_TOL for x in diffs[cls]),
              f"phase 20 replay: the {cls} pod differs by {max(diffs[cls])}")

    # One traced mixed step, and the step's wall time: single program,
    # mixed (a stream a pod), mixed on one stream, in turns.
    batch = {"tokens": dense.tokens, "live": torch.ones(rows, dtype=torch.bool, device="cuda")}
    pos = torch.full((rows,), total - 2, dtype=torch.int32, device="cuda")
    mesh = dense.mesh

    def single():
        with big:
            return decode(params, batch, dense.state, pos)

    def one_stream():
        mesh.pod_streams = lambda: [None] * mesh.n_pods
        try:
            return dense._decode(params, batch, dense.state, pos)
        finally:
            del mesh.pod_streams

    variants = {"single": single, "mixed": lambda: dense._decode(params, batch, dense.state, pos),
                "mixed_one_stream": one_stream}
    walls = {k: [] for k in variants}
    with torch.no_grad():
        for fn in variants.values():
            fn()  # warm
        for _ in range(MIXED_TIMED_STEPS):
            for k, fn in variants.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[k].append((time.perf_counter() - t0) * 1e3)
        traced = {}
        for k in ("single", "mixed"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                variants[k]()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            traced[k] = {"wall_ms": wall_ms, **stream_overlap(torch, prof)}
    med = {k: statistics.median(v) for k, v in walls.items()}
    tm = traced["mixed"]
    phase2_ms = s2["engine"]["decode_s"] / max(s2["engine"]["decode_steps"], 1) * 1e3
    print(f"  decode step wall ms (median of {MIXED_TIMED_STEPS}, in turns): single program "
          f"{med['single']:.2f}, mixed {med['mixed']:.2f}, mixed on one stream "
          f"{med['mixed_one_stream']:.2f}; phase 2's engine step {phase2_ms:.2f}", flush=True)
    print(f"  traced: single program wall {traced['single']['wall_ms']:.2f} ms, busy "
          f"{traced['single']['busy_ms']:.2f}; mixed wall {tm['wall_ms']:.2f}, busy {tm['busy_ms']:.2f}, "
          f"GEMM streams {tm['gemm_streams']} of {tm['streams']}, the pods' kernels overlap "
          f"{tm['overlap_ms']:.3f} ms ({tm['overlap_share_of_shorter_pod']:.3f} of the shorter pod's busy)",
          flush=True)
    check(len(tm["gemm_streams"]) == 2 and all(tm["streams"][s]["gemms"] for s in tm["gemm_streams"]),
          f"phase 20: the traced mixed step's GEMMs ran on streams {tm['streams']}, want two")
    out = {"runs": {k: {kk: v for kk, v in r.items() if kk not in ("engine", "tokens")}
                    for k, r in runs.items()},
           "paged_vs_dense_logit_diff": dlog, "planted_fault": caught, "replay_logit_diff": diffs,
           "step_wall_ms": walls, "step_wall_ms_median": med, "phase2_engine_step_ms": phase2_ms,
           "traced": traced, "streams": streams}
    del runs, dense, paged, params
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 20 took {out['phase_s']:.1f} s", flush=True)
    return out


def grad_slices(tree, prefix: str = "") -> list:
    """``(name, tensor)`` of every leaf of a gradient tree in key order,
    the layer stack's leaves (under ``blocks``) one slice a layer."""

    out = []
    for key in sorted(tree):
        leaf, name = tree[key], prefix + key
        if isinstance(leaf, dict):
            out += grad_slices(leaf, name + "/")
        elif name.startswith("blocks/"):
            out += [(f"{name}[{i}]", leaf[i]) for i in range(leaf.shape[0])]
        else:
            out.append((name, leaf))
    return out


def worst_slice(torch, got, ref) -> tuple:
    """``(rel, name)``: the largest relative L2 of ``got - ref`` over the
    slices of ``grad_slices``, and that slice's name."""

    worst = (0.0, "")
    for (name, g), (want, r) in zip(grad_slices(got), grad_slices(ref), strict=True):
        check(name == want, f"gradient trees differ: {name} vs {want}")
        r = r.float()
        ref_n = float(torch.linalg.vector_norm(r))
        diff = float(torch.linalg.vector_norm(g.float() - r))
        worst = max(worst, (diff / ref_n if ref_n else 0.0 if diff == 0 else math.inf, name))
    return worst


def phase21(torch, counts, reset, train16: dict) -> dict:
    """Mixed training of the full-width internlm2-1.8b through
    ``launch/train.py``'s trainer with ``--heterogeneous --class-sharded
    on``: 8 x 512 tokens a step split over the pods by the chunk table;
    step 0's gradients against the single-class step on the same params and
    batch (the loss, the global norm, the worst slice; planted faults in
    the epilogue: the little pod's weight zeroed, its gradients of layer
    ``MIXED_FAULT_LAYER`` zeroed), then 3 steps of 675 ``gemm_cuda`` and
    675 ``gemm_cuda_lean`` each, then the GEMM Function's backward check
    at a pod's shapes."""

    import shutil
    import statistics
    import tempfile

    from repro_torch.launch import train as TL
    from repro_torch.optim import adamw as O
    from repro_torch.runtime import trainer as TR

    t_phase = time.perf_counter()
    ckdir = tempfile.mkdtemp(prefix="repro_torch_mixed_")
    try:
        args = TL.build_parser().parse_args([
            "--arch", ARCH, "--steps", "3", "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--heterogeneous", "--ckpt-dir", ckdir, "--seed", "0"] + MIXED)
        trainer = TL.make_trainer(args)
        cfg, step_fn = trainer.arch, trainer.class_sharded_step
        per_step = 4 * forward_gemm_calls(cfg) - 1
        shards = [(p.pod, p.device_class, p.backend) for p in step_fn.provenance]
        check(trainer.class_sharded_enabled() and shards == MIXED_SHARDS, f"phase 21 shards {shards}")
        batch0, layout = trainer.next_batch(0)

        def grads_of(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _, g = fn()
            norm = float(O.global_norm(g))
            return float(loss), norm, (time.perf_counter() - t0) * 1e3, g

        with trainer.exec_ctx:
            l_one, n_one, ms_one, g_one = grads_of(lambda: O.accumulate_gradients(
                trainer.loss_fn, trainer.params, batch0, 1))
        reset()
        l_mix, n_mix, ms_mix, g = grads_of(lambda: step_fn(trainer.params, batch0))
        c_mix = counts()
        worst = worst_slice(torch, g, g_one)
        del g
        real = TR.weighted_mean_epilogue

        def faulty(epilogue):
            """The mixed step with ``epilogue`` in the real one's place."""

            TR.weighted_mean_epilogue = epilogue
            try:
                return TR.build_class_sharded_grad_step(trainer.loss_fn, trainer.asym, trainer.mesh)
            finally:
                TR.weighted_mean_epilogue = real

        def drop_little(outs, shard_args, axis):  # the little pod's weight w_1 zeroed
            args = list(shard_args)
            p, b = args[1]
            args[1] = (p, dict(b, mask=torch.zeros_like(b["mask"])))
            return real(outs, args, axis)

        def drop_layer(outs, shard_args, axis):  # the little pod's gradients of one layer zeroed
            loss, metrics, g = outs[1]
            cut = torch.tensor([MIXED_FAULT_LAYER], device=loss.device)
            g = dict(g, blocks=O.tree_map(lambda x: x.index_fill(0, cut, 0), g["blocks"]))
            return real([outs[0], (loss, metrics, g)], shard_args, axis)

        faults = {}
        for name, epilogue in (("little pod's weight zeroed", drop_little),
                               (f"little pod's layer {MIXED_FAULT_LAYER} zeroed", drop_layer)):
            l_f, n_f, _, g = grads_of(lambda: faulty(epilogue)(trainer.params, batch0))
            faults[name] = {"loss": l_f, "grad_norm_rel": abs(n_f / n_one - 1),
                            "worst_slice": worst_slice(torch, g, g_one)}
            del g
        del g_one
        rel = abs(n_mix / n_one - 1)
        f_pod = faults["little pod's weight zeroed"]
        # Both gradients again, in turns after the first (allocator-warming) call.
        ms_mix = min(ms_mix, grads_of(lambda: step_fn(trainer.params, batch0))[2])
        with trainer.exec_ctx:
            ms_one = grads_of(lambda: O.accumulate_gradients(trainer.loss_fn, trainer.params, batch0, 1))[2]
        # The mixed gradient traced once: the pods' kernels by stream (printed).
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(trainer.params, batch0)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        traced = {"wall_ms": traced_ms, **stream_overlap(torch, prof)}
        del prof
        print(f"phase 21: {cfg.name}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens split {layout.sizes} over pods of "
              f"{layout.c_max} rows; step 0: loss mixed {l_mix:.5f} vs single-class {l_one:.5f}; grad norm "
              f"{n_mix:.5f} vs {n_one:.5f} (rel {rel:.2e}, tol {MIXED_GRAD_NORM_RTOL}); worst slice rel L2 "
              f"{worst[0]:.2e} at {worst[1]} (tol {MIXED_GRAD_SLICE_RTOL}); gradient wall ms mixed "
              f"{ms_mix:.1f} vs single-class {ms_one:.1f} (12 padded rows, each timed after a first call); "
              f"launches {c_mix}", flush=True)
        for name, f in faults.items():
            print(f"  planted fault, the {name}: loss {f['loss']:.5f}, norm rel {f['grad_norm_rel']:.2e}, "
                  f"worst slice rel L2 {f['worst_slice'][0]:.3f} at {f['worst_slice'][1]}", flush=True)
        print(f"  traced mixed gradient: wall {traced['wall_ms']:.1f} ms, busy {traced['busy_ms']:.1f}, "
              f"GEMMs by stream { {k: v['gemms'] for k, v in traced['streams'].items()} }, the pods' "
              f"kernels overlap {traced['overlap_ms']:.2f} ms ({traced['overlap_share_of_shorter_pod']:.3f} "
              f"of the shorter pod's busy)", flush=True)
        check(abs(l_mix - l_one) <= TRAIN_EVAL_LOSS_TOL, f"phase 21 step-0 loss {l_mix} vs {l_one}")
        check(rel <= MIXED_GRAD_NORM_RTOL, f"phase 21 step-0 grad norm {n_mix} vs {n_one}")
        check(worst[0] <= MIXED_GRAD_SLICE_RTOL, f"phase 21 step-0 gradient slice {worst}")
        check(f_pod["grad_norm_rel"] > MIXED_GRAD_NORM_RTOL, f"phase 21: the zeroed pod's norm passed {f_pod}")
        for name, f in faults.items():
            check(f["worst_slice"][0] > MIXED_GRAD_SLICE_RTOL, f"phase 21: the fault ({name}) passed {f}")
        check(mixed_launches(c_mix, 1, False, per_step, 2 * cfg.n_layers) is None,
              f"phase 21 step-0 launches {c_mix}")

        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(3):
            batch, _ = trainer.next_batch(i)
            metrics, rec = timed_step(torch, counts, lambda: trainer.train_step(batch))
            steps.append({**rec, **{k: float(v) for k, v in metrics.items()}})
            why = mixed_launches(rec["launches"], 1, False, per_step, 2 * cfg.n_layers)
            check(why is None, f"phase 21 step {i}: {why}")
            check(math.isfinite(steps[-1]["loss"]) and math.isfinite(steps[-1]["grad_norm"]),
                  f"phase 21 step {i}: {steps[-1]}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_s = statistics.median(s["wall_s"] for s in steps[1:])
        print(f"  3 mixed steps: losses {[round(s['loss'], 5) for s in steps]}, grad_norm "
              f"{[round(s['grad_norm'], 4) for s in steps]}, wall {[round(s['wall_s'], 4) for s in steps]} s "
              f"(median of steps 1-2 {step_s * 1e3:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s), "
              f"peak {peak_gb:.2f} GB; phase 16's single-class step {train16['step_ms']:.1f} ms, "
              f"{train16['tokens_per_s']:.0f} tokens/s, peak {train16['peak_gb']:.2f} GB", flush=True)
        out = {"sizes": layout.sizes, "c_max": layout.c_max, "loss_mixed": l_mix, "loss_single": l_one,
               "grad_norm_mixed": n_mix, "grad_norm_single": n_one, "grad_norm_rel": rel,
               "worst_slice_rel": worst, "faults": faults, "grad_ms_mixed": ms_mix,
               "grad_ms_single": ms_one, "traced_grad": traced, "step0_launches": c_mix, "steps": steps, "step_ms": step_s * 1e3,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "peak_gb": peak_gb,
               "launches": {k: sum(s["launches"][k] for s in steps) for k in steps[0]["launches"]},
               "phase16": {k: train16[k] for k in ("step_ms", "tokens_per_s", "peak_gb")}}
        del trainer, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        # Each pod's GEMMs ran at its own rows (M = c_max x seq): the
        # Function's check of phase 1 at those shapes, both classes.
        out["backward_products"] = gemm_backward_check(
            torch, f"{cfg.name} mixed pod", step_gemm_shapes(cfg, layout.c_max, TRAIN_SEQ), seed=5)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 21 took {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 22: the fault-tolerant fleet
# ---------------------------------------------------------------------------

# bench_fleet's lanes at full width, on its bursty trace: FLEET_BURSTS bursts
# of FLEET_BURST requests FLEET_GAP ticks apart, prompt lengths cycling over
# FLEET_PLENS, FLEET_GEN new tokens each, on engines of FLEET_SLOTS slots
# (bench_fleet's 2 pods x 2), paged in pages of PAGE_SIZE; a row's cache (64
# tokens) stays under paged attention's MIN_SPLIT, so each call runs one split.
# A recurrence step (a prefill position or a decode step) costs the host about
# 60 ms, so the fault-matrix lanes and the planted fault serve the first burst
# only.
FLEET_BURSTS, FLEET_BURST, FLEET_GAP = 3, 8, 4
FLEET_PLENS, FLEET_GEN, FLEET_SLOTS = (16, 32, 48), 16, 4
FLEET_KILL_TICK, FLEET_TRACE_TICK = 6, 2
FLEET_FAULTS = ("engine_stall", "admission_fail", "latency_spike")
# The planted fault: engine 1 of a 2-engine fleet runs with the middle
# layer's attention output projection scaled by this factor.
FLEET_FAULT_SCALE = 1.01


def fleet_trace(cfg) -> list:
    """``[(arrival tick, prompt), ...]``, the same for every lane."""

    import numpy as np

    rng = np.random.default_rng(7)
    trace = []
    for b in range(FLEET_BURSTS):
        for i in range(FLEET_BURST):
            plen = FLEET_PLENS[(b * FLEET_BURST + i) % len(FLEET_PLENS)]
            trace.append((b * FLEET_GAP, rng.integers(0, cfg.vocab, (plen,), dtype=np.int32)))
    return trace


def fleet_engine(cfg, params, device, classes=None, backend="auto"):
    """One engine as ``launch/serve._fleet`` builds it (its own mesh, the
    shared ``params``), paged, with FLEET_SLOTS slots over its pods."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.runtime.serving import ServingEngine

    classes = classes or biglittle_classes(chips_per_pod=1)
    asym = AsymmetricMesh(classes, strategy="ca-das", batch_tile=1, backend=backend)
    return ServingEngine(cfg, params, asym, seq_cap=max(FLEET_PLENS) + FLEET_GEN,
                         slots_per_pod=FLEET_SLOTS // len(classes), paged="on", page_size=PAGE_SIZE,
                         device=device)


class FleetLog:
    """Counts each engine's recurrence steps (prefill positions and decode
    steps) and keeps the logits behind every generated token, read around
    the engine's decode and bulk prefill, by ``(engine, engine rid)``."""

    def __init__(self, engines):
        self.steps = [0] * len(engines)
        self.rows: dict = {}
        for e, eng in enumerate(engines):
            self._wrap(e, eng)

    def _keep(self, e, eng, logits, admitted_only: bool):
        import numpy as np

        for slot in np.nonzero(eng.slot_rid >= 0)[0]:
            if admitted_only and int(slot) in eng._slot_req:
                continue  # a busy row: the round's prefill logits are not its
            self.rows.setdefault((e, int(eng.slot_rid[slot])), []).append(logits[slot, -1])

    def _wrap(self, e, eng):
        decode, prefill = eng._decode, eng._prefill_program

        def counted_decode(params, batch, state, pos):
            logits, state = decode(params, batch, state, pos)
            self.steps[e] += 1
            self._keep(e, eng, logits, admitted_only=False)
            return logits, state

        def counted_prefill(batch, state, plens):
            out = prefill(batch, state, plens)
            self.steps[e] += batch["tokens"].shape[1]
            self._keep(e, eng, eng.prefill_logits, admitted_only=True)
            return out

        eng._decode, eng._prefill_program = counted_decode, counted_prefill

    def by_rid(self, torch, fleet) -> dict:
        """``{fleet rid: (tokens, (FLEET_GEN, V) logits, engine)}`` of the
        completed requests (an engine completion is matched to the fleet's
        by its token array, which the fleet hands on as is)."""

        import numpy as np

        done = {id(c.tokens): c for c in fleet.completions}
        out = {}
        for e, eng in enumerate(fleet.engines):
            for ec in eng.completions:
                fc = done[id(ec.tokens)]
                rows = self.rows[(e, ec.rid)]
                check(len(rows) == len(fc.tokens) - fc.prompt_len,
                      f"phase 22: request {fc.rid} kept {len(rows)} logits rows")
                out[fc.rid] = (np.asarray(fc.tokens), torch.stack(rows), e)
        return out


def fleet_differ(torch, got: dict, want: dict, rids=None) -> tuple[list, list]:
    """The rids whose tokens, and those whose logits, differ bitwise."""

    import numpy as np

    rids = sorted(want) if rids is None else rids
    toks = [r for r in rids if not np.array_equal(got[r][0], want[r][0])]
    logits = [r for r in rids if not torch.equal(got[r][1], want[r][1])]
    return toks, logits


def fleet_drive(torch, fleet, trace, log, *, plan=None, snap_engine=None, trace_tick=None):
    """bench_fleet's ``drive``: submit by the arrival trace, tick to the
    end.  Returns ``(wall_s, postkill, traced)``: the survivor's (tokens,
    modeled s) from the kill tick on, and the traced tick's reading (the
    profiler's own set-up and tear-down are left out of ``wall_s``)."""

    import contextlib

    from repro_torch.runtime import faults

    snap = traced = None
    overhead = 0.0
    sync(torch, fleet.engines[0].device)
    t0 = time.perf_counter()
    with faults.injected(plan) if plan is not None else contextlib.nullcontext():
        i = tick = 0
        while True:
            while i < len(trace) and trace[i][0] <= tick:
                fleet.submit(trace[i][1], FLEET_GEN)
                i += 1
            if i >= len(trace) and len(fleet.completions) == len(trace):
                break
            if snap_engine is not None and tick == FLEET_KILL_TICK - 1:
                e = fleet.engines[snap_engine]
                snap = (e.stats.tokens, e.stats.modeled_decode_s)
            if tick + 1 == trace_tick:
                t1 = time.perf_counter()
                traced = fleet_traced_tick(torch, fleet, log)
                overhead = time.perf_counter() - t1 - traced["wall_ms"] / 1e3
            else:
                fleet.tick()
            tick += 1
            check(tick <= 10_000, "phase 22: the fleet failed to converge")
    sync(torch, fleet.engines[0].device)
    wall = time.perf_counter() - t0 - overhead
    postkill = None
    if snap is not None:
        e = fleet.engines[snap_engine]
        postkill = (e.stats.tokens - snap[0], e.stats.modeled_decode_s - snap[1])
    return wall, postkill, traced


def fleet_drive_streamed(torch, fleet, trace, plan, survivor: int):
    """The kill lane through the async surface: ``submit_async`` by the
    arrival trace, ``run_async`` between arrivals, and a ``stream(rid)``
    consumer on every request.  Returns ``(wall_s, postkill, chunks)``."""

    import asyncio

    import numpy as np

    from repro_torch.runtime import faults

    chunks: dict = {}
    snap = []
    stops = sorted({t for t, _ in trace if t > 0} | {FLEET_KILL_TICK - 1})

    async def consume(rid):
        async for ch in fleet.stream(rid):
            chunks[rid].append(np.asarray(ch))

    async def main():
        tasks, i = [], 0
        with faults.injected(plan):
            for stop in stops + [None]:
                while i < len(trace) and trace[i][0] <= fleet.stats.ticks:
                    rid = await fleet.submit_async(trace[i][1], FLEET_GEN)
                    chunks[rid] = []
                    tasks.append(asyncio.ensure_future(consume(rid)))
                    i += 1
                if fleet.stats.ticks == FLEET_KILL_TICK - 1:
                    e = fleet.engines[survivor]
                    snap.append((e.stats.tokens, e.stats.modeled_decode_s))
                await fleet.run_async(max_ticks=stop)
            check(i == len(trace), f"phase 22: {len(trace) - i} arrivals never submitted")
        await asyncio.gather(*tasks)

    sync(torch, fleet.engines[0].device)
    t0 = time.perf_counter()
    asyncio.run(main())
    sync(torch, fleet.engines[0].device)
    wall = time.perf_counter() - t0
    check(len(snap) == 1, "phase 22: no snapshot before the kill tick")
    e = fleet.engines[survivor]
    return wall, (e.stats.tokens - snap[0][0], e.stats.modeled_decode_s - snap[0][1]), chunks


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fleet_traced_tick(torch, fleet, log) -> dict:
    """One fleet tick under ``torch.profiler``: its wall and device busy ms
    and the recurrence steps the engines ran in it."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_decode import _union_us

    steps0 = list(log.steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    busy = _union_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    return {"tick": fleet.stats.ticks, "wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if wall_ms else None, "kernels": len(dev),
            "steps": [b - a for a, b in zip(steps0, log.steps)]}


def fleet_modeled_tps(fleet) -> float:
    """bench_fleet's ``_fleet_tps``: tokens over the slowest engine's
    modeled seconds (engines given a device each would run side by side)."""

    tokens = sum(e.stats.tokens for e in fleet.engines)
    span = max(e.stats.modeled_decode_s for e in fleet.engines)
    return tokens / span if span > 0 else 0.0


def on_device(torch, tree, device) -> bool:
    if isinstance(tree, dict):
        return all(on_device(torch, v, device) for v in tree.values())
    return not isinstance(tree, torch.Tensor) or tree.device.type == device.type


def fleet_lanes(torch, cfg, params, device, counts, reset, tok2, serve_argv: list) -> dict:
    """The lanes of phase 22 (see ``phase22``).  ``tok2`` are the tokens of
    ``serve_argv`` through one engine.  On the CPU (a debugging run at the
    reduced size) launches are not held: the wrappers run their plain
    versions there, and no tick is traced."""

    import numpy as np

    from repro_torch import observability as OBS
    from repro_torch.core.asymmetric import biglittle_classes
    from repro_torch.runtime import faults
    from repro_torch.runtime.fleet import Fleet

    cuda = device.type == "cuda"
    check(not OBS.enabled(), "phase 22 needs observability off (the step-time probe would launch GEMMs)")
    trace = fleet_trace(cfg)
    n_req, gemms, layers = len(trace), 7 * cfg.n_layers + 1, cfg.n_layers
    big_cls, little_cls = biglittle_classes(chips_per_pod=1)
    lanes: dict = {}
    held: dict = {}

    def hold_launches(label, c, kinds, steps):
        want = {"gemm_cuda": 0, "gemm_cuda_lean": 0, "paged_attention_cuda": 0, "flash_attention_cuda": 0}
        for kind, (n, paged) in zip(kinds, steps):
            want[f"gemm_{kind}"] += gemms * n
            want["paged_attention_cuda"] += layers * n if paged else 0
        bad = {k: (c[k], v) for k, v in want.items() if c[k] != v}
        check(not bad, f"phase 22 {label}: launches (got, want) {bad}")

    def lane(label, fleet, log, wall, n, **extra):
        c = counts()
        st = fleet.stats
        check(st.submitted == st.completed == n, f"phase 22 {label}: {st.completed} of {st.submitted}")
        check(st.duplicate_completions == 0, f"phase 22 {label}: duplicate completions")
        check(sorted(x.rid for x in fleet.completions) == list(range(n)), f"phase 22 {label}: rids")
        kinds = [e.asym.execution_context().backend() for e in fleet.engines]
        if cuda:
            hold_launches(label, c, kinds, [(n, True) for n in log.steps])
        if cuda:
            check(on_device(torch, params, device) and all(
                on_device(torch, e.state, device) and e.tokens.device.type == "cuda"
                for e in fleet.engines), f"phase 22 {label}: a tensor of the path is off the card")
        gen = sum(len(x.tokens) - x.prompt_len for x in fleet.completions)
        rec = {"wall_s": wall, "wall_tokens_per_s": gen / wall,
               "modeled_tokens_per_s": fleet_modeled_tps(fleet), "fleet": st.snapshot(),
               "steps": list(log.steps), "launches": c, "backends": kinds,
               "engine_tokens": [e.stats.tokens for e in fleet.engines],
               "calibrated_tps": [e.calibrated_tps() for e in fleet.engines], **extra}
        counters = {k: v for k, v in st.snapshot().items() if v}
        print(f"  {label}: wall {wall:.2f} s, {rec['wall_tokens_per_s']:.1f} tokens/s on the card, "
              f"modeled {rec['modeled_tokens_per_s']:.1f} tokens/s; counters {counters}; recurrence "
              f"steps {log.steps}; launches {c}", flush=True)
        lanes[label] = rec
        return rec

    def run(label, engines, reqs=trace, **kw):
        fleet, log = Fleet(engines), FleetLog(engines)
        reset()
        wall, _, traced = fleet_drive(torch, fleet, reqs, log, **kw)
        rec = lane(label, fleet, log, wall, len(reqs), traced_tick=traced)
        return fleet, log.by_rid(torch, fleet), rec

    # 1. The single engine: the yardstick.
    _, want, r1 = run("single", [fleet_engine(cfg, params, device)])

    # 2. No fault, two engines; one tick traced.
    _, got, r2 = run("nofault", [fleet_engine(cfg, params, device) for _ in range(2)],
                     trace_tick=FLEET_TRACE_TICK if cuda else None)
    check(all(t > 0 for t in r2["engine_tokens"]), f"phase 22 nofault: an engine idled {r2['engine_tokens']}")
    held["nofault"] = fleet_differ(torch, got, want)
    if r2["traced_tick"]:
        t = r2["traced_tick"]
        print(f"  nofault, tick {t['tick']} traced: wall {t['wall_ms']:.2f} ms, device busy "
              f"{t['busy_ms']:.2f} ms ({t['idle_share']:.3f} idle), {t['kernels']} kernels, "
              f"recurrence steps {t['steps']}", flush=True)

    # 3 and 6. The kill, through the async surface with every request streamed.
    plan = faults.FaultPlan([faults.FaultEvent(point="pod_death", engine=0, tick=FLEET_KILL_TICK)])
    engines = [fleet_engine(cfg, params, device) for _ in range(2)]
    f3, log3 = Fleet(engines), FleetLog(engines)
    reset()
    wall3, (pk_tok, pk_s), chunks = fleet_drive_streamed(torch, f3, trace, plan, survivor=1)
    postkill = pk_tok / pk_s if pk_s > 0 else 0.0
    r3 = lane("kill", f3, log3, wall3, n_req, postkill_tokens_per_s=postkill,
              standalone_tokens_per_s=r1["modeled_tokens_per_s"],
              recovered=postkill >= 0.8 * r1["modeled_tokens_per_s"])
    st3 = f3.stats
    check(st3.engine_kills == 1 and st3.migrated > 0 and st3.retries > 0,
          f"phase 22 kill: kills {st3.engine_kills}, migrated {st3.migrated}, retries {st3.retries}")
    retried = sorted(c.rid for c in f3.completions if c.attempts > 1)
    for c in f3.completions:
        got = np.concatenate(chunks[c.rid]) if chunks[c.rid] else np.zeros(0, np.int32)
        check(np.array_equal(got, c.tokens[c.prompt_len:]),
              f"phase 22 stream: request {c.rid}'s chunks do not join to its tokens")
    check(bool(retried), "phase 22 stream: no streamed request was retried across the kill")
    r3["retried_rids"] = retried
    held["kill"] = fleet_differ(torch, log3.by_rid(torch, f3), want)
    print(f"  kill: the survivor's post-kill rate {postkill:.1f} modeled tokens/s against the single "
          f"engine's {r1['modeled_tokens_per_s']:.1f} (recovered: {r3['recovered']}); the streams of "
          f"{len(chunks)} requests joined to their tokens, {len(retried)} of them retried {retried}",
          flush=True)
    del f3, log3, engines, chunks

    # 4. The other fault points, as in test_fault_matrix_bit_identical, on
    # the first burst.
    burst = trace[:FLEET_BURST]
    counter = {"engine_stall": "stalled_ticks", "admission_fail": "admission_faults",
               "latency_spike": "latency_spikes"}
    for point in FLEET_FAULTS:
        plan = faults.FaultPlan([faults.FaultEvent(point=point, engine=0, tick=2, duration=3)])
        _, got, r4 = run(point, [fleet_engine(cfg, params, device) for _ in range(2)], burst, plan=plan)
        check(r4["fleet"][counter[point]] == 3, f"phase 22 {point}: {counter[point]} {r4['fleet']}")
        held[point] = fleet_differ(torch, got, want, sorted(got))

    # 5. Heterogeneous: a big-only engine on gemm_cuda and a little-only one
    # on gemm_cuda_lean; each request held to a single engine of its class
    # (the little engine's requests served again by one little engine).
    _, got, r5 = run("hetero", [fleet_engine(cfg, params, device, [big_cls]),
                                fleet_engine(cfg, params, device, [little_cls], "cuda_lean")])
    served = [sorted(r for r, v in got.items() if v[2] == e) for e in range(2)]
    _, alone, _ = run("single_little", [fleet_engine(cfg, params, device, [little_cls], "cuda_lean")],
                      [(0, trace[r][1]) for r in served[1]])
    want_little = {r: alone[i] for i, r in enumerate(served[1])}
    tps = r5["calibrated_tps"]
    r5.update(served=served, share=[len(s) / n_req for s in served],
              predicted_share=[t / sum(tps) for t in tps])
    print(f"  hetero: backends {r5['backends']}, calibrated tps {tps}; share of the requests served "
          f"{[round(s, 3) for s in r5['share']]}, predicted by rate "
          f"{[round(p, 3) for p in r5['predicted_share']]}", flush=True)
    check(all(served), f"phase 22 hetero: an engine served nothing {served}")
    check(r5["backends"][1] == "cuda_lean" and r5["backends"][0] == ("cuda" if cuda else "matmul"),
          f"phase 22 hetero: {r5['backends']}")
    held["hetero_big"] = fleet_differ(torch, got, want, served[0])
    held["hetero_little"] = fleet_differ(torch, got, want_little, served[1])

    # The planted fault: engine 1 serves with one layer's wo scaled (the
    # first burst).
    blocks = params["blocks"]
    wo = blocks["attn"]["wo"].clone()
    mid = cfg.n_layers // 2
    wo[mid] = (wo[mid].float() * FLEET_FAULT_SCALE).to(wo.dtype)
    faulty = {**params, "blocks": {**blocks, "attn": {**blocks["attn"], "wo": wo}}}
    _, got, rp = run("planted", [fleet_engine(cfg, params, device), fleet_engine(cfg, faulty, device)],
                     burst)
    on = [sorted(r for r, v in got.items() if v[2] == e) for e in range(2)]
    d0, d1 = fleet_differ(torch, got, want, on[0]), fleet_differ(torch, got, want, on[1])
    rp.update(served=on, engine0_differ=d0, engine1_differ=d1)
    print(f"  planted fault (engine 1, layer {mid}'s wo x {FLEET_FAULT_SCALE}): of engine 1's "
          f"{len(on[1])} requests {len(d1[1])} differ in logits, {len(d1[0])} in tokens; of engine 0's "
          f"{len(on[0])}, {len(d0[1])} and {len(d0[0])}", flush=True)
    check(bool(on[1]) and len(d1[1]) == len(on[1]), "phase 22: the comparison missed the planted fault")
    check(not d0[0] and not d0[1], "phase 22: engine 0 differs beside the planted fault")
    del faulty, wo

    # 7. --fleet 2 through launch/serve.py, against one engine on its requests.
    reset()
    s7, tok7, f7, wall7 = run_serve(serve_argv + ["--fleet", "2"], params=params)
    c7 = counts()
    plen = int(serve_argv[serve_argv.index("--prompt-len") + 1])
    steps7 = [plen * e.stats.admission_rounds + e._step_calls for e in f7.engines]
    if cuda:
        hold_launches("serve", c7, [e.asym.execution_context().backend() for e in f7.engines],
                      [(n, False) for n in steps7])
    fs = s7["engine"]["fleet"]
    print(f"  serve --fleet 2: path {s7['path']}, {fs['completed']} of {fs['submitted']} completed, "
          f"wall {wall7:.2f} s, recurrence steps {steps7}, launches {c7}; tokens equal one engine's: "
          f"{bool(np.array_equal(tok7, tok2))}", flush=True)
    check(s7["path"] == "fleet:2", f"phase 22 serve: path {s7['path']}")
    check(fs["completed"] == fs["submitted"] == len(tok2) and fs["duplicate_completions"] == 0,
          f"phase 22 serve: {fs}")
    check(np.array_equal(tok7, tok2), "phase 22 serve: --fleet 2's tokens differ from one engine's")
    lanes["serve"] = {"wall_s": wall7, "fleet": fs, "steps": steps7, "launches": c7,
                      "tokens_per_s": s7["tokens_per_s"]}

    print(f"  held against the single engine (rids differing in tokens, in logits): {held}", flush=True)
    for label, (toks, logits) in held.items():
        check(not toks and not logits, f"phase 22 {label}: requests {toks} / {logits} differ from "
              f"the single engine's tokens / logits")
    return {"lanes": lanes, "held": held}


def phase22(torch, counts, reset, tok2) -> dict:
    """The fault-tolerant fleet serving the full-width internlm2-1.8b (phase
    2's weights, shared by every engine of a lane; engines built as
    ``launch/serve._fleet`` builds them, paged) on bench_fleet's bursty
    trace: the single engine (the yardstick), a fleet of 2 with no fault,
    engine 0 killed (queue migrated, in-flight retried; driven through
    ``run_async`` with every request streamed), each other fault point, a
    big-only engine beside a little-only one, a planted fault, and
    ``launch/serve.py --fleet 2``.  Each lane: every request exactly once,
    tokens and per-step logits bitwise equal to a single engine's, launches
    169 GEMMs and 24 paged attentions a recurrence step an engine."""

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as Z

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    base = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--gen-len", str(GEN_LEN), "--seed", "0"]
    out = fleet_lanes(torch, cfg, params, torch.device("cuda"), counts, reset, tok2, base)
    del params
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 22 took {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 23: the static verifier and the dry-run against the card's counters
# ---------------------------------------------------------------------------

# The block the contract rejects for shared memory: a two-stage ring of 128
# x 256 x 256 needs 393,248 B, a block may claim 232,448 B on an H100.
REJECTED_BLOCK = (128, 256, 256)
# minitron-4b's forward over 2 x 2048: the GEMMs' operations bound of
# PERF.md §6 row 1, 35.7 ms at 989 TFLOP/s; the dry-run's funnel FLOPs must
# give it within FWD_BOUND_RTOL (the table rounds it to a tenth of a ms).
FWD_OPS_BOUND_MS = 35.7
FWD_BOUND_RTOL = 0.01
# The training cell's bytes (the arguments and the most bytes the step's
# own tensors held at once, counted on the meta device at their exact
# sizes) against phase 16's torch.cuda.max_memory_allocated: the caching
# allocator rounds every block up (to 512 B, a large one to 2 MiB), and
# phase 16's peak spans six steps, the checkpoint's save and its restore,
# where the dry-run counts one step.  15%.
DRYRUN_MEM_RTOL = 0.15


def phase23(torch, fwd: dict, long_step: dict, train: dict) -> dict:
    """(a) the port's analyzer over its files and phase 9's tuning cache;
    (b) the shipped trees' blocks on the kernel and a rejected block
    refused; (c) the dry-run at the shapes of phases 8, 7 and 16 against
    the launch counters, times and peak memory those phases measured."""

    from repro_torch.analysis import cli as AC
    from repro_torch.analysis import configcheck as CC
    from repro_torch.configs import ShapeSpec
    from repro_torch.core.blocking import BlockConfig
    from repro_torch.kernels import gemm as G
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    from repro_torch.tuning.candidates import SPECS

    t_phase = time.perf_counter()
    out: dict = {}

    # (a) The analyzer, contract checks on, its specs the card's own.
    optin = int(torch.cuda.get_device_properties(0).shared_memory_per_block_optin)
    check(SPECS["h100"].smem_bytes == optin and SPECS["h100-little"].smem_bytes == optin // 2,
          f"class specs' shared memory {SPECS['h100'].smem_bytes} / "
          f"{SPECS['h100-little'].smem_bytes}, the card's {optin}")
    cache = os.path.join(OUT_DIR, "tuning_cache.json")
    check(os.path.exists(cache), f"phase 9's tuning cache {cache} is missing")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *AC.default_paths("."), cache],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300,
    )
    out["analyzer"] = {"rc": res.returncode, "s": time.perf_counter() - t0,
                       "stderr": res.stderr.strip()[-300:], "card_smem_optin": optin}
    print(f"phase 23: python -m repro_torch.analysis over {len(AC.default_paths(ROOT))} paths and "
          f"phase 9's cache: rc {res.returncode} ({res.stderr.strip()[-80:]}) in "
          f"{out['analyzer']['s']:.1f} s; class specs at the card's {optin} B", flush=True)
    check(res.returncode == 0, f"the port's analyzer found: {res.stdout.strip()[-2000:]}")

    # (b) Every block the shipped trees name, on its kernel, against its
    # plain version; then a block the contract rejects, refused unlaunched.
    gen = torch.Generator(device="cuda").manual_seed(23)
    counter = {"cuda": "gemm_cuda", "cuda_lean": "gemm_cuda_lean"}
    plain = {"cuda": G.gemm_plain, "cuda_lean": G.gemm_lean_plain}
    blocks, max_err = [], 0.0
    for (m, k, n), _, loop, trees in CC.shipped_trees(backends=("cuda",)):
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
        for name, tree in trees.items():
            blk = tree.block
            check(not CC.block_problems(blk, tree.spec, CC.consumer_stages(tree.backend), (m, k, n)),
                  f"shipped tree {name} {m}x{k}x{n} {loop}: the contract rejects {blk}")
            before = dict(G.LAUNCHES)
            got = G.GEMM_KERNELS[tree.backend](a, b, blk)
            ref = plain[tree.backend](a, b, blk)
            torch.cuda.synchronize()
            ok, err = within(torch, got, ref, BF16_TOL)
            launched = {c: G.LAUNCHES[c] - before[c] for c in before}
            check(launched == {c: int(c == counter[tree.backend]) for c in before},
                  f"{name} {m}x{k}x{n} {loop}: launches {launched}")
            check(ok, f"{name} {m}x{k}x{n} {loop} {blk} on {tree.backend}: max err {err}")
            max_err = max(max_err, err)
            blocks.append({"shape": [m, k, n], "loop": loop, "class": name, "kernel": tree.backend,
                           "block": [blk.bm, blk.bk, blk.bn], "max_abs_err": err})
    rej = BlockConfig(*REJECTED_BLOCK)
    problems = CC.block_problems(rej, SPECS["h100"], CC.consumer_stages("cuda"), (1024, 1024, 1024))
    check(any("393248 B" in p for p in problems), f"the contract does not reject {rej}: {problems}")
    a = torch.randn((1024, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    refused = []
    before = dict(G.LAUNCHES)
    for label, call in (("_launch, 2 stages", lambda: G._launch(a, a, rej, torch.bfloat16, 2, "gemm_cuda")),
                        ("gemm_cuda", lambda: G.gemm_cuda(a, a, rej))):
        try:
            call()
        except ValueError as e:
            refused.append(f"{label}: {e}")
        else:
            fail(f"{label} launched the rejected block {rej}")
    torch.cuda.synchronize()
    check(G.LAUNCHES == before, f"the rejected block launched: {G.LAUNCHES} vs {before}")
    out["shipped_blocks"] = blocks
    out["rejected"] = {"block": list(REJECTED_BLOCK), "contract": problems, "refused": refused}
    print(f"  {len(blocks)} shipped-tree blocks on their kernels (max err {max_err:.3g}, tol {BF16_TOL}): "
          f"{sorted({tuple(x['block']) + (x['kernel'],) for x in blocks})}; {rej} refused: "
          f"{[r.split(':')[0] for r in refused]}", flush=True)

    # (c) The dry-run at the shapes phases 8, 7 and 16 ran, against what the
    # card counted and measured there (no step runs again).
    cells = {
        "decode": (ARCH, ShapeSpec("phase8", LONG_CACHE, LONG_ROWS, "decode"),
                   long_step["launches"]["gemm_cuda"], long_step["gemm_cuda_flops"],
                   long_step["steps_counted"], long_step["wall_s"]),
        "forward": (FWD_ARCH, ShapeSpec("phase7", FWD_SEQ, FWD_BATCH, "prefill"),
                    fwd["gemm_launches_4_prefills"], fwd["gemm_flops_4_prefills"], 4, fwd["wall_s"]),
        "train": (ARCH, ShapeSpec("phase16", TRAIN_SEQ, TRAIN_BATCH, "train"),
                  train["launches"]["gemm_cuda"], train["gemm_cuda_flops"], train["steps_run"],
                  train["step_ms"] / 1e3),
    }
    out["cells"] = {}
    for label, (arch, shape, card_calls, card_flops, steps, measured_s) in cells.items():
        rec = D.run_cell(arch, shape, write=False)
        check(rec.get("ok"), f"dry-run {label}: {rec.get('error')}")
        cost = rec["hlo_cost"]
        t = R.terms(cost)
        bound_s = max(t["compute_s"], t["memory_flash_s"], t["collective_s"])
        row = {"arch": arch, "batch": shape.global_batch, "seq": shape.seq_len,
               "gemm_calls": cost["gemm_calls"], "card_calls_per_step": card_calls / steps,
               "gemm_flops": cost["gemm_flops"], "card_flops_per_step": card_flops / steps,
               "flops": cost["flops"], "bytes": cost["bytes"],
               "attn_score_bytes": cost["attn_score_bytes"], **t, "bound_s": bound_s,
               "measured_s": measured_s, "memory": rec["memory"], "fits": rec["fits"],
               "lower_s": rec["lower_s"], "exec_backend": rec["exec_backend"]}
        out["cells"][label] = row
        print(f"  dry-run {label} ({arch}, {shape.global_batch} x {shape.seq_len}): funnel "
              f"{cost['gemm_calls']} calls, {cost['gemm_flops']:.6g} FLOP; card {card_calls} over "
              f"{steps} steps, {card_flops:.6g}; compute {t['compute_s'] * 1e3:.3f} ms, memory "
              f"{t['memory_s'] * 1e3:.3f} (flash {t['memory_flash_s'] * 1e3:.3f}); bound "
              f"{bound_s * 1e3:.3f} ms against the card's {measured_s * 1e3:.2f} ms; total "
              f"{rec['memory']['total_bytes'] / 1e9:.3f} GB; ran in {rec['lower_s']} s", flush=True)
        check(card_calls == cost["gemm_calls"] * steps,
              f"{label}: funnel {cost['gemm_calls']} calls, the card {card_calls} over {steps} steps")
        check(card_flops == int(cost["gemm_flops"]) * steps,
              f"{label}: funnel {cost['gemm_flops']} FLOP, the card {card_flops} over {steps} steps")
        check(bound_s < measured_s,
              f"{label}: roofline bound {bound_s * 1e3:.3f} ms not below the card's {measured_s * 1e3:.3f} ms")
    fwd_ms = out["cells"]["forward"]["gemm_flops"] / R.PEAK_FLOPS * 1e3
    check(abs(fwd_ms - FWD_OPS_BOUND_MS) <= FWD_BOUND_RTOL * FWD_OPS_BOUND_MS,
          f"minitron's operations bound {fwd_ms:.3f} ms, PERF.md's {FWD_OPS_BOUND_MS}")
    total = out["cells"]["train"]["memory"]["total_bytes"]
    peak = train["peak_gb"] * 1e9
    print(f"  minitron's operations bound {fwd_ms:.3f} ms (PERF.md {FWD_OPS_BOUND_MS}, tol "
          f"{FWD_BOUND_RTOL:.0%}); training cell {total / 1e9:.3f} GB against phase 16's peak "
          f"{peak / 1e9:.3f} GB ({total / peak - 1:+.1%}, tol {DRYRUN_MEM_RTOL:.0%})", flush=True)
    check(abs(total - peak) <= DRYRUN_MEM_RTOL * peak,
          f"training cell {total / 1e9:.3f} GB vs phase 16's peak {peak / 1e9:.3f} GB")
    out.update(fwd_ops_bound_ms=fwd_ms, train_total_vs_peak=total / peak - 1,
               phase_s=time.perf_counter() - t_phase)
    print(f"  phase 23 took {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 24: the multi-card half, 4 ranks sharing the card
# ---------------------------------------------------------------------------

# (data, model) of the training and decode mesh, and of the reshard's.
SPMD_MESH, SPMD_RESHARD = (2, 2), (4, 1)
SPMD_STEPS = 3
# internlm2-1.8b at full width, 12 of its 24 layers: depth cut for the
# script's time limit when phase 25 came (the whole depth took 148-174 s
# on an NVIDIA H100 80GB HBM3 at 700 W, most of it gloo moving the state).
SPMD_LAYERS = 12
# Against the one-card trainer on the same seed and batches, as the CPU
# tests hold the port to the reference (tests/test_torch_train.py).
SPMD_LOSS_RTOL, SPMD_NORM_RTOL = 1e-2, 3e-2
# The decode step and the prefill of (c): 12 rows at the last position of
# a 4,096-token cache; 12 x 512 prompt tokens, the last SPMD_LAST logits.
SPMD_ROWS, SPMD_CACHE, SPMD_PREFILL, SPMD_LAST = 12, 4096, 512, 4
SPMD_TIMEOUT_S = 900


def spmd_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(ARCH), n_layers=SPMD_LAYERS)


def spmd_train_args(steps: int):
    from repro_torch.launch import train as TL

    return TL.build_parser().parse_args([
        "--arch", ARCH, "--steps", str(steps), "--global-batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--ckpt-every", "100", "--seed", "0"])


def spmd_serving_inputs(torch, cfg, device, mesh=None):
    """Phase 24's decode state (full on one card, a rank's part on a
    mesh: every layer's K and V drawn whole from one seed, then cut), the
    decode tokens and positions and the prefill tokens, all from seeds."""

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model_zoo as Z

    gen = torch.Generator(device=device).manual_seed(3)
    state = Z.init_decode_state(cfg, SPMD_ROWS, SPMD_CACHE, device=device, mesh=mesh)
    spec = SH.cache_pspec(mesh, (cfg.n_layers, SPMD_ROWS, SPMD_CACHE, cfg.n_kv_heads, cfg.head_dim)) \
        if mesh is not None else None
    for layer in range(cfg.n_layers):
        for key in ("k", "v"):
            full = torch.randn((SPMD_ROWS, SPMD_CACHE, cfg.n_kv_heads, cfg.head_dim), generator=gen,
                               device=device, dtype=torch.bfloat16)
            part = full if spec is None else SH.local_slice(full[None], spec, mesh)[0]
            state[key][layer].copy_(part)
            del full, part
    toks = torch.randint(0, cfg.vocab, (SPMD_ROWS, 1), generator=gen, device=device, dtype=torch.int32)
    ptoks = torch.randint(0, cfg.vocab, (SPMD_ROWS, SPMD_PREFILL), generator=gen, device=device,
                          dtype=torch.int32)
    pos = torch.full((SPMD_ROWS,), SPMD_CACHE - 1, dtype=torch.int32, device=device)
    if mesh is not None:
        rows = SH.batch_pspec(mesh, SPMD_ROWS)
        toks, ptoks, pos = (SH.local_slice(t, rows, mesh) for t in (toks, ptoks, pos))
    return state, toks, ptoks, pos


def phase24_rank(rank: int, plan: dict) -> dict:
    """One rank of phase 24 (a spawned process, the card shared): (a) and
    (b)'s training steps, then (c)'s decode step and prefill."""

    import torch

    from repro_torch.core import execution as X
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import spmd
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as Z

    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict = {"rank": rank}
    mesh = make_host_mesh(data=SPMD_MESH[0], model=SPMD_MESH[1], device="cuda")
    t0 = time.perf_counter()
    trainer = TL.make_trainer(spmd_train_args(SPMD_STEPS + 1), cfg=spmd_config(), mesh=mesh)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["backend"] = mesh.transport
    seen: dict = {}

    def note(kind, nbytes):
        seen[kind] = seen.get(kind, 0) + nbytes

    C.COLLECTIVE_OBSERVERS.append(note)
    steps = []
    for i in range(SPMD_STEPS + 1):
        if i == SPMD_STEPS:
            torch.cuda.reset_peak_memory_stats()
            trainer.reshard(make_host_mesh(data=SPMD_RESHARD[0], model=SPMD_RESHARD[1], device="cuda"))
            out["peak_gb_reshard"] = torch.cuda.max_memory_allocated() / 1e9
        batch, _ = trainer.next_batch(i)
        seen.clear()
        G.reset_launches()
        FA.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "wall_s": time.perf_counter() - t, "rows": int(batch["tokens"].shape[0]),
                      "launches": {**G.LAUNCHES, **FA.LAUNCHES}, "collective_bytes": dict(seen),
                      "mesh": dict(trainer.mesh.shape), "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    C.COLLECTIVE_OBSERVERS.remove(note)
    out["steps"] = steps
    del trainer, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (c): serving params (bf16, no FSDP) drawn leaf by leaf from phase 8's seed.
    cfg = spmd_config()
    mesh = make_host_mesh(data=SPMD_MESH[0], model=SPMD_MESH[1], device="cuda")
    specs = Z.param_specs(cfg, mesh, fsdp=False)
    params = spmd.init_sharded(lambda g, d: Z.init_params(cfg, g, d),
                               torch.Generator(device="cuda").manual_seed(0), specs, mesh)
    state, toks, ptoks, pos = spmd_serving_inputs(torch, cfg, "cuda", mesh)
    decode = Z.make_decode_fn(cfg, mesh=mesh, batch=SPMD_ROWS, seq_len=SPMD_CACHE)
    prefill = Z.make_prefill_fn(cfg, mesh=mesh)
    seen.clear()
    C.COLLECTIVE_OBSERVERS.append(note)
    with torch.no_grad():
        G.reset_launches()
        FA.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = decode(params, {"tokens": toks}, state, pos)
        torch.cuda.synchronize()
        out["decode"] = {"wall_s": time.perf_counter() - t, "launches": {**G.LAUNCHES, **FA.LAUNCHES},
                         "collective_bytes": dict(seen)}
        C.COLLECTIVE_OBSERVERS.remove(note)
        full = C.all_gather(C.all_gather(logits, mesh, "model", 2), mesh, SH.dp_axes(mesh), 0)
        del state
        G.reset_launches()
        FA.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        plog = prefill(params, {"tokens": ptoks})[:, -SPMD_LAST:].contiguous()
        torch.cuda.synchronize()
        out["prefill"] = {"wall_s": time.perf_counter() - t, "launches": {**G.LAUNCHES, **FA.LAUNCHES}}
        pfull = C.all_gather(C.all_gather(plog, mesh, "model", 2), mesh, SH.dp_axes(mesh), 0)
    out["peak_gb_serve"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_gb"] = max([st["peak_gb"] for st in steps] + [out["peak_gb_reshard"], out["peak_gb_serve"]])
    if rank == 0:
        out["decode"]["logits"] = full.float().cpu()
        out["prefill"]["logits"] = pfull.float().cpu()
        # One product at a rank-local shape (wq's columns of one model rank).
        gen = torch.Generator(device="cuda").manual_seed(11)
        a = torch.randn((TRAIN_BATCH * TRAIN_SEQ // SPMD_MESH[0], cfg.d_model), generator=gen,
                        device="cuda").bfloat16()
        b = (torch.randn((cfg.d_model, cfg.n_heads * cfg.head_dim // SPMD_MESH[1]), generator=gen,
                         device="cuda") / math.sqrt(cfg.d_model)).bfloat16()
        ctx = X.default_context()
        blk = ctx.block_config(a.shape[0], a.shape[1], b.shape[1], "bfloat16", 2)
        got, ref = G.gemm_cuda(a, b, blk), G.gemm_plain(a, b, blk)
        ok, err = within(torch, got, ref, BF16_TOL)
        out["local_gemm"] = {"shape": [a.shape[0], a.shape[1], b.shape[1]], "ok": ok, "max_abs_err": err,
                             "block": [blk.bm, blk.bk, blk.bn]}
        # The prefill's attention at its rank-local shape: this rank's rows,
        # its model rank's query heads and their KV heads.
        m = SPMD_MESH[1]
        rows, s = ptoks.shape
        q = torch.randn((rows, s, cfg.n_heads // m, cfg.head_dim), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((rows, s, cfg.n_kv_heads // m, cfg.head_dim), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        got, ref = FA.flash_attention_cuda(q, k, v, causal=True), FA.flash_attention_torch(q, k, v, causal=True)
        torch.cuda.synchronize()
        ok, err = within(torch, got, ref, BF16_TOL)
        row_err = row_rel_err(got, ref)
        out["local_flash"] = {"shape": [rows, s, s, q.shape[2], k.shape[2], cfg.head_dim],
                              "ok": ok and got.shape == q.shape and row_err <= FLASH_ROW_TOL,
                              "max_abs_err": err, "row_err": row_err}
    return out


def phase24(torch, counts, reset) -> dict:
    """The multi-card half on one card: the one-card references, the
    dry-run's counts, then 4 ranks (``phase24_rank``) and their checks."""

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import RankMesh, spawn_ranks
    from repro_torch.models import model_zoo as Z

    t_phase = time.perf_counter()
    cfg = spmd_config()
    # The one-card trainer on the same seed and batches.
    trainer = TL.make_trainer(spmd_train_args(SPMD_STEPS + 1), cfg=spmd_config())
    one = []
    for i in range(SPMD_STEPS + 1):
        batch, _ = trainer.next_batch(i)
        m = trainer.train_step(batch)
        one.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    del trainer, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    # The one-card decode step and prefill on phase 8's weights.
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    state, toks, ptoks, pos = spmd_serving_inputs(torch, cfg, "cuda")
    with torch.no_grad():
        one_decode = Z.make_decode_fn(cfg)(params, {"tokens": toks}, state, pos)[0].float().cpu()
        del state
        one_prefill = Z.make_prefill_fn(cfg)(params, {"tokens": ptoks})[:, -SPMD_LAST:].float().cpu()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # The dry-run's counts for the same cells on the abstract meshes.
    train_shape = ShapeSpec("phase24_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    dry = {}
    for sizes in (SPMD_MESH, SPMD_RESHARD):
        rec = D.run_cell(cfg, train_shape, mesh=RankMesh.abstract(("data", "model"), sizes),
                         seq_shard=False, write=False)
        check(rec["ok"], f"dry-run at {sizes}: {rec.get('error')}")
        dry[sizes] = rec
    rec = D.run_cell(cfg, ShapeSpec("phase24_decode", SPMD_CACHE, SPMD_ROWS, "decode"),
                     mesh=RankMesh.abstract(("data", "model"), SPMD_MESH), write=False)
    check(rec["ok"], f"dry-run decode: {rec.get('error')}")
    dry["decode"] = rec

    # The prefill splits the heads over model (rank 0 holds its flash call
    # at that local shape against the plain version).
    check(cfg.n_heads % SPMD_MESH[1] == 0 and cfg.n_kv_heads % SPMD_MESH[1] == 0,
          f"{cfg.name}'s heads {cfg.n_heads}/{cfg.n_kv_heads} do not split {SPMD_MESH[1]} ways")
    t0 = time.perf_counter()
    ranks = spawn_ranks(phase24_rank, SPMD_MESH[0] * SPMD_MESH[1], {}, device="cuda",
                        timeout=SPMD_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    per_step = 4 * forward_gemm_calls(cfg) - 1
    r0 = ranks[0]
    for r in ranks:
        for i, st in enumerate(r["steps"]):
            sizes = SPMD_MESH if i < SPMD_STEPS else SPMD_RESHARD
            lc = st["launches"]
            want = {"gemm_cuda": per_step, **train_attention_launches(cfg.n_layers)}
            check(all(v == want.get(k, 0) for k, v in lc.items()),
                  f"rank {r['rank']} step {i} launched {lc}, want {want} and no other kernel")
            want = {k: v for k, v in dry[sizes]["hlo_cost"]["by_collective"].items()}
            check(st["collective_bytes"] == want,
                  f"rank {r['rank']} step {i}: collective bytes {st['collective_bytes']} != dry-run {want}")
        check(r["decode"]["collective_bytes"] == dry["decode"]["hlo_cost"]["by_collective"],
              f"rank {r['rank']} decode collective bytes {r['decode']['collective_bytes']} != dry-run "
              f"{dry['decode']['hlo_cost']['by_collective']}")
        check(r["decode"]["launches"]["gemm_cuda"] == forward_gemm_calls(cfg),
              f"rank {r['rank']} decode launches {r['decode']['launches']}")
        check(r["prefill"]["launches"]["flash_attention_cuda"] == cfg.n_layers
              and r["prefill"]["launches"]["gemm_cuda"] == forward_gemm_calls(cfg),
              f"rank {r['rank']} prefill launches {r['prefill']['launches']}")
    for i, (o, st) in enumerate(zip(one, r0["steps"])):
        check(abs(st["loss"] - o["loss"]) <= SPMD_LOSS_RTOL * abs(o["loss"]),
              f"step {i} loss {st['loss']} vs one card {o['loss']}")
        check(abs(st["grad_norm"] - o["grad_norm"]) <= SPMD_NORM_RTOL * abs(o["grad_norm"]),
              f"step {i} grad_norm {st['grad_norm']} vs one card {o['grad_norm']}")
    dlog = float((r0["decode"]["logits"] - one_decode).abs().max())
    plog = float((r0["prefill"]["logits"] - one_prefill).abs().max())
    check(tuple(r0["decode"]["logits"].shape) == tuple(one_decode.shape), "decode logits shape")
    check(bool(torch.isfinite(r0["decode"]["logits"]).all()), "sharded decode logits not finite")
    check(dlog <= LOGIT_TOL, f"sharded decode logits differ from one card's by {dlog}")
    check(plog <= LOGIT_TOL, f"sharded prefill logits differ from one card's by {plog}")
    check(r0["local_gemm"]["ok"], f"gemm_cuda at a rank-local shape: {r0['local_gemm']}")
    check(r0["local_flash"]["ok"], f"flash_attention_cuda at the prefill's rank-local shape "
          f"(tol {BF16_TOL}, row tol {FLASH_ROW_TOL}): {r0['local_flash']}")

    walls = [[round(st["wall_s"] * 1e3, 1) for st in r["steps"]] for r in ranks]
    peaks = [round(r["peak_gb"], 2) for r in ranks]
    step_peaks = [[round(st["peak_gb"], 2) for st in r["steps"]] for r in ranks]
    dry_gb = {f"{s[0]}x{s[1]}": dry[s]["memory"]["total_bytes"] / 1e9 for s in (SPMD_MESH, SPMD_RESHARD)}
    print(f"phase 24: {cfg.name} on a (data={SPMD_MESH[0]}, model={SPMD_MESH[1]}) mesh of "
          f"{len(ranks)} ranks sharing the card over {r0['backend']}: losses "
          f"{[round(st['loss'], 5) for st in r0['steps']]} vs one card {[round(o['loss'], 5) for o in one]}; "
          f"grad norms {[round(st['grad_norm'], 4) for st in r0['steps']]} vs "
          f"{[round(o['grad_norm'], 4) for o in one]} (the last step after reshard to "
          f"{SPMD_RESHARD})", flush=True)
    print(f"  step wall ms by rank {walls} (ranks share one card over gloo: not a multi-card step "
          f"time); launches a step a rank {r0['steps'][0]['launches']}; collective bytes a step a rank "
          f"{r0['steps'][0]['collective_bytes']} = dry-run; after reshard {r0['steps'][-1]['collective_bytes']}",
          flush=True)
    print(f"  peak GB by rank and step {step_peaks}, with the reshard's moves "
          f"{[round(r['peak_gb_reshard'], 2) for r in ranks]}, serving "
          f"{[round(r['peak_gb_serve'], 2) for r in ranks]}, whole run {peaks} (sum {sum(peaks):.2f}); "
          f"dry-run GB a device {dry_gb}; init {[round(r['init_s'], 1) for r in ranks]} s", flush=True)
    check(sum(peaks) < 80, f"the ranks' peaks {peaks} exceed the card's 80 GB")
    print(f"  decode step at a {SPMD_CACHE}-token cache split over model, {SPMD_ROWS} rows: max |logit diff| "
          f"{dlog:.4f} vs one card (tol {LOGIT_TOL}), wall {[round(r['decode']['wall_s'] * 1e3, 1) for r in ranks]} "
          f"ms; prefill {SPMD_ROWS} x {SPMD_PREFILL}: last {SPMD_LAST} positions' max |logit diff| "
          f"{plog:.4f}, {r0['prefill']['launches']['flash_attention_cuda']} flash launches a rank; "
          f"rank 0's gemm_cuda at {r0['local_gemm']['shape']} max err {r0['local_gemm']['max_abs_err']:.4f}, "
          f"flash_attention_cuda at (B, Sq, Sk, Hq, Hkv, D) {r0['local_flash']['shape']} max err "
          f"{r0['local_flash']['max_abs_err']:.4f} (row {r0['local_flash']['row_err']:.3g})",
          flush=True)
    out = {
        "mesh": list(SPMD_MESH), "reshard": list(SPMD_RESHARD), "backend": r0["backend"],
        "one_card": one, "ranks": [{k: v for k, v in r.items() if k not in ("decode", "prefill")}
                                   | {"decode_wall_s": r["decode"]["wall_s"],
                                      "prefill_wall_s": r["prefill"]["wall_s"]} for r in ranks],
        "decode_logit_diff": dlog, "prefill_logit_diff": plog, "per_step": per_step,
        "dry_run": {f"{s[0]}x{s[1]}": {"collective_bytes": dry[s]["hlo_cost"]["by_collective"],
                                       "total_bytes": dry[s]["memory"]["total_bytes"]}
                    for s in (SPMD_MESH, SPMD_RESHARD)},
        "launches": {"gemm_cuda": sum(st["launches"]["gemm_cuda"] for r in ranks for st in r["steps"]),
                     "flash_attention_cuda": sum(r["prefill"]["launches"]["flash_attention_cuda"]
                                                 for r in ranks)},
        "ranks_s": ranks_s, "local_gemm": r0["local_gemm"], "local_flash": r0["local_flash"],
    }
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 24 took {out['phase_s']:.1f} s (the ranks {ranks_s:.1f} s)", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 25: the MoE, Mamba2, hybrid and enc-dec families on the mesh of ranks
# ---------------------------------------------------------------------------

# The families in the order the ranks run them: (arch, layers kept, the
# AdamW schedule's steps (its one-card phase's) or None for no training,
# whether each training step after the first starts on the ranks from one
# card's state after the step before).  Depth is cut for the script's time
# limit, never width: qwen2-moe-a2.7b 1 of 24 layers, mamba2-1.3b 4 of 48,
# zamba2-2.7b 6 of 54 (one group and its shared block), mixtral-8x7b 2 of
# 32 (about 6 GB of bf16); whisper-small runs whole and repeats phase 19's
# first steps.  The Mamba2 families restart each later step from one
# card's state: AdamW's first update is lr * sign(g), and a gradient entry
# whose sign its last bits decide moves by 2 lr, so two free-running
# copies part by 2-4% in their second step's grad norm (on an NVIDIA H100
# 80GB HBM3 at 700 W); restarted, the step measures the sharding alone.
# qwen2-moe's state (about 14 GB) would take longer to pass than the step.
P25_FAMILIES = (
    (MOE_ARCH, 1, MOE_TRAIN_STEPS, False),
    (SSM_ARCH, 4, FAMILY_TRAIN_STEPS, True),
    (HYBRID_ARCH, 6, FAMILY_TRAIN_STEPS, True),
    (ENCDEC_ARCH, None, FAMILY_TRAIN_STEPS, False),
    (RING_ARCH, 2, None, False),
)
P25_STEPS = 2
# The ring decode at a batch of 1: positions P25_RING_POS, +1 of a
# 4,096-token ring whose slots split over (data, model), 1,024 a rank.
P25_RING_POS, P25_RING_STEPS = 6000, 2
# A rank's peak against the dry-run's bytes for its cell.
P25_MEM_RTOL = 0.05
P25_TIMEOUT_S = 900


def p25_config(arch: str, layers):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def p25_fill(torch, cfg, state, rows: int, seq_len: int, mesh, seed: int):
    """Every decode-state leaf drawn whole, layer by layer, from one seed and
    cut to this rank's part (the state's ``cache_pspec``): the same numbers
    on one card and on the mesh."""

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model_zoo as Z

    gen = torch.Generator(device="cuda").manual_seed(seed)
    specs = Z.decode_state_specs(cfg, mesh, rows, seq_len) if mesh is not None else None
    whole = Z.decode_state_spec(cfg, rows, seq_len)

    def walk(node, full, spec):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], full[k], spec[k] if spec is not None else None)
            return
        for i in range(node.shape[0]):
            t = torch.randn(tuple(full.shape[1:]), generator=gen, device="cuda",
                            dtype=torch.float32).to(node.dtype)
            node[i].copy_(t if spec is None else SH.local_slice(t[None], spec, mesh)[0])
            del t

    walk(state, whole, specs)
    return state


def p25_inputs(torch, cfg, mesh=None):
    """The serving inputs of a family (decode tokens at 12 rows, the
    prefill's tokens, whisper's frames), all from seeds; on a mesh this
    rank's rows."""

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import score as SC

    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {"toks": torch.randint(0, cfg.vocab, (SPMD_ROWS, 1), generator=gen, device="cuda",
                                 dtype=torch.int32)}
    if cfg.family == "encdec":
        out["fwd"] = SC.make_batch(cfg, ENCDEC_TRAIN_BATCH, DEC_CTX, 1, "cuda")[0]
    elif cfg.swa_window is None:
        out["fwd"] = {"tokens": torch.randint(0, cfg.vocab, (SPMD_ROWS, SPMD_PREFILL), generator=gen,
                                              device="cuda", dtype=torch.int32)}
    else:
        out["one"] = torch.randint(0, cfg.vocab, (1, P25_RING_STEPS), generator=gen, device="cuda",
                                   dtype=torch.int32)
    if cfg.family == "ssm":  # a batch of 1: the state's heads over (data, model)
        out["one"] = torch.randint(0, cfg.vocab, (1, 1), generator=gen, device="cuda", dtype=torch.int32)
    if mesh is not None:
        out["toks"] = SH.local_slice(out["toks"], SH.batch_pspec(mesh, SPMD_ROWS), mesh)
        if "fwd" in out:
            b = next(iter(out["fwd"].values())).shape[0]
            out["fwd"] = {k: SH.local_slice(v, SH.batch_pspec(mesh, b), mesh)
                          for k, v in out["fwd"].items()}
    return out


def p25_cache(cfg) -> int:
    """The decode cell's sequence: phase 24's 4,096-token cache (a ring of
    the window for mixtral, whisper's 448-token decoder context)."""

    if cfg.family == "encdec":
        return DEC_CTX
    return P25_RING_POS + P25_RING_STEPS if cfg.swa_window else SPMD_CACHE


@contextlib.contextmanager
def p25_routing(torch, ids=None, mesh=None):
    """``moe.route`` recording its top-k ids (``ids`` None) or, given a
    list, taking them in call order, each over the whole batch's routing
    groups (a rank routing its own groups takes its block): one card's
    routing forced on the ranks, so that a near tie breaks alike."""

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe as M

    real, got, calls = M.route, [], [0]

    def route(p, x, mcfg):
        gate_w, idx, probs = real(p, x, mcfg)
        if ids is None:
            got.append(idx.cpu())
            return gate_w, idx, probs
        idx = ids[calls[0]].to(x.device)
        calls[0] += 1
        g = x.shape[0]
        if idx.shape[0] != g:
            i = mesh.index(SH.dp_axes(mesh))
            idx = idx[i * g:(i + 1) * g]
        gw = probs.gather(-1, idx)
        return gw / torch.clamp(gw.sum(-1, keepdim=True), min=1e-9), idx, probs

    M.route = route
    try:
        yield got
    finally:
        M.route = real


def p25_serve(torch, cfg, params, mesh, ids, counts=None, reset=None):
    """A family's decode step(s) at 12 rows (mixtral: two ring steps at a
    batch of 1 past the window, then one at 12 rows) and its prefill
    (whisper: the encoder + decoder forward), on one card or as a rank's
    part (``mesh``), the MoE routing forced to ``ids`` when given.  Returns
    each item's logits (whole on rank 0 of a mesh), launches, collective
    bytes, wall and peak, and the routing taken."""

    from repro_torch.distributed import collectives as C
    from repro_torch.models import model_zoo as Z

    inp = p25_inputs(torch, cfg, mesh)
    seq_len = p25_cache(cfg)
    items = []
    if cfg.swa_window:
        items.append(("ring1", 1, inp["one"], None))
    elif "one" in inp:
        items.append(("one", 1, inp["one"], None))
    items.append(("decode", SPMD_ROWS, inp["toks"], None))
    if "fwd" in inp:
        items.append(("prefill", None, None, inp["fwd"]))
    out, routes, seen = {}, [], {}
    it = iter(ids or ())

    def note(kind, nbytes):
        seen[kind] = seen.get(kind, 0) + nbytes

    for name, rows, toks, fwd in items:
        with p25_routing(torch, next(it, None) if ids else None, mesh) as got:
            if fwd is not None:
                serve_fn = Z.make_prefill_fn(cfg, mesh=mesh)
                args = [(params, fwd)]
                b = next(iter(fwd.values())).shape[0] * (1 if mesh is None else mesh.size(("data",)))
            else:
                state = p25_fill(torch, cfg, Z.init_decode_state(cfg, rows, seq_len, device="cuda",
                                                                 mesh=mesh),
                                 rows, seq_len, mesh, seed=3)
                serve_fn = Z.make_decode_fn(cfg, mesh=mesh, batch=rows, seq_len=seq_len)
                b = rows
                # This rank's part of dim 2: a KV cache's slots, an SSM state's heads.
                dim2 = (state["mamba"]["ssm"] if "mamba" in state else state["k"]).shape[2]
                if name == "ring1":
                    args = [(params, {"tokens": toks[:, j:j + 1]}, state,
                             torch.full((1,), P25_RING_POS + j, dtype=torch.int32, device="cuda"))
                            for j in range(P25_RING_STEPS)]
                else:
                    pos = P25_RING_POS if cfg.swa_window else seq_len - 1
                    args = [(params, {"tokens": toks}, state,
                             torch.full((toks.shape[0],), pos, dtype=torch.int32, device="cuda"))]
            logits, launches, coll, walls, peaks, bases = None, [], [], [], [], []
            with torch.no_grad():
                for a in args:
                    seen.clear()
                    C.COLLECTIVE_OBSERVERS.append(note)
                    torch.cuda.synchronize()
                    if reset is not None:
                        reset()
                    torch.cuda.reset_peak_memory_stats()
                    bases.append((torch.cuda.memory_allocated(),
                                  torch.cuda.memory_stats().get("requested_bytes.all.current", 0)))
                    t = time.perf_counter()
                    res = serve_fn(*a)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t)
                    peaks.append((torch.cuda.max_memory_allocated(),
                                  torch.cuda.memory_stats().get("requested_bytes.all.peak", 0)))
                    C.COLLECTIVE_OBSERVERS.remove(note)
                    if counts is not None:
                        c1 = counts()
                        launches.append({k: c1[k] for k in ("gemm_cuda", "flash_attention_cuda")})
                    coll.append(dict(seen))
                    lg = res[0] if isinstance(res, tuple) else res
                    if fwd is not None:
                        lg = lg[:, -SPMD_LAST:].contiguous()
                    logits = lg if logits is None else torch.cat([logits, lg], 1)
                if mesh is not None:
                    logits = Z.gather_logits(logits, cfg, mesh, b)
            if fwd is None:
                del state
        routes.append(got)
        out[name] = {"logits": logits.float().cpu(), "launches": launches, "collective_bytes": coll,
                     "wall_s": walls, "peak_bytes": peaks, "base_bytes": bases,
                     "dim2": None if fwd is not None else dim2}
        gc.collect()
        torch.cuda.empty_cache()
    return out, routes


def p25_local_kernels(torch, cfg) -> dict:
    """Rank 0's ``gemm_cuda`` at one rank-local shape of the family (its
    attention's q projection, or mamba2's head: this rank's columns of the
    whole) and ``flash_attention_cuda`` at its prefill's local heads,
    against their plain versions."""

    from repro_torch.core import execution as X
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G

    m = SPMD_MESH[1]
    gen = torch.Generator(device="cuda").manual_seed(11)
    n = cfg.n_heads * cfg.head_dim // m if cfg.n_heads else cfg.vocab // m
    a = torch.randn((TRAIN_BATCH * TRAIN_SEQ // SPMD_MESH[0], cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    b = (torch.randn((cfg.d_model, n), generator=gen, device="cuda") / math.sqrt(cfg.d_model)).bfloat16()
    blk = X.default_context().block_config(a.shape[0], a.shape[1], b.shape[1], "bfloat16", 2)
    got, ref = G.gemm_cuda(a, b, blk), G.gemm_plain(a, b, blk)
    ok, err = within(torch, got, ref, BF16_TOL)
    out = {"gemm": {"shape": [a.shape[0], a.shape[1], b.shape[1]], "ok": ok, "max_abs_err": err}}
    if cfg.n_heads and cfg.swa_window is None:
        rows = (ENCDEC_TRAIN_BATCH if cfg.family == "encdec" else SPMD_ROWS) // SPMD_MESH[0]
        s = DEC_CTX if cfg.family == "encdec" else SPMD_PREFILL
        q = torch.randn((rows, s, cfg.n_heads // m, cfg.head_dim), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((rows, s, cfg.n_kv_heads // m, cfg.head_dim), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        got, ref = FA.flash_attention_cuda(q, k, v, causal=True), FA.flash_attention_torch(q, k, v, causal=True)
        torch.cuda.synchronize()
        ok, err = within(torch, got, ref, BF16_TOL)
        row = row_rel_err(got, ref)
        out["flash"] = {"shape": [rows, s, s, q.shape[2], k.shape[2], cfg.head_dim],
                        "ok": ok and row <= FLASH_ROW_TOL, "max_abs_err": err, "row_err": row}
    return out


def p25_train(torch, cfg, total_steps: int, mesh=None, counts=None, reset=None, state_path=None,
              save=False) -> list:
    """``P25_STEPS`` training steps of the family from seed 0, the one-card
    phase's AdamW schedule (``total_steps``): the trainer of
    ``launch/train.py`` (8 x 512 tokens), or whisper's gradient step (phase
    19's batch, ``make_loss_fn`` and AdamW; on a mesh
    ``trainer.sharded_train_step``).  With ``state_path`` (a trainer's
    family) one card writes its params and AdamW state after each step
    but the last there (``save``), and the ranks start each step after the
    first from it, cut to their shards.  Each step's loss, grad norm,
    wall, launches, collective bytes and peak bytes."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import spmd
    from repro_torch.launch import score as SC
    from repro_torch.launch import train as TL
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim import adamw as O
    from repro_torch.runtime.trainer import sharded_train_step

    seen: dict = {}

    def note(kind, nbytes):
        seen[kind] = seen.get(kind, 0) + nbytes

    if cfg.family == "encdec":
        ctx = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("big")
        gen = torch.Generator(device="cuda").manual_seed(0)
        init = lambda g, d: Z.init_params(cfg, g, d, dtype=torch.float32)  # noqa: E731
        opt_cfg = O.AdamWConfig(total_steps=total_steps)
        batch, labels = SC.make_batch(cfg, ENCDEC_TRAIN_BATCH, DEC_CTX, 0, "cuda")
        batch["labels"] = labels
        if mesh is None:
            params = O.tree_map(lambda p: p.requires_grad_(True), init(gen, "cuda"))
            loss_fn = Z.make_loss_fn(cfg)
        else:
            loss_fn = Z.make_loss_fn(cfg, mesh=mesh)
            params = O.tree_map(lambda p: p.requires_grad_(True),
                                spmd.init_sharded(init, gen, loss_fn.layout.specs, mesh))
            rows = SH.batch_pspec(mesh, ENCDEC_TRAIN_BATCH)
            batch = {k: SH.local_slice(v, rows, mesh) for k, v in batch.items()}
        st = types.SimpleNamespace(params=params, opt=O.init_opt_state(params))
        del params

        def step(_):
            with ctx:
                if mesh is not None:
                    st.params, st.opt, m = sharded_train_step(loss_fn, st.params, st.opt, batch, opt_cfg,
                                                              loss_fn.layout)
                    return m
                loss, _, grads = O.value_and_grad(loss_fn, st.params, batch)
                st.params, st.opt, om = O.adamw_update(st.params, grads, st.opt, opt_cfg)
                return {"loss": loss, "grad_norm": om["grad_norm"]}
        holder = st
    else:
        args = TL.build_parser().parse_args([
            "--arch", cfg.name, "--steps", str(total_steps), "--global-batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt-every", "100", "--seed", "0"])
        holder = TL.make_trainer(args, cfg=cfg, mesh=mesh)

        def step(i):
            m = holder.train_step(holder.next_batch(i)[0])
            holder.step += 1
            return m

        def restart(i):
            """The ranks' state for step ``i``: one card's after step ``i - 1``."""

            with torch.no_grad():
                st = torch.load(f"{state_path}.{i}.pt", map_location="cpu", mmap=True, weights_only=True)
                specs = holder.layout.specs
                holder.params = spmd.shard_tree(st["params"], specs, mesh, device="cuda", requires_grad=True)
                holder.opt_state = {"m": spmd.shard_tree(st["opt"]["m"], specs, mesh, device="cuda"),
                                    "v": spmd.shard_tree(st["opt"]["v"], specs, mesh, device="cuda"),
                                    "step": st["opt"]["step"].to("cuda")}
            del st
            gc.collect()
            torch.cuda.empty_cache()

        def keep(i):
            """One card's state after step ``i``, for the ranks' step ``i + 1``."""

            cpu = lambda t: t.detach().cpu()  # noqa: E731
            torch.save({"params": O.tree_map(cpu, holder.params),
                        "opt": {"m": O.tree_map(cpu, holder.opt_state["m"]),
                                "v": O.tree_map(cpu, holder.opt_state["v"]),
                                "step": cpu(holder.opt_state["step"])}},
                       f"{state_path}.{i + 1}.pt")

    rec = []
    for i in range(P25_STEPS):
        if state_path and mesh is not None and i > 0:
            restart(i)
        seen.clear()
        C.COLLECTIVE_OBSERVERS.append(note)
        torch.cuda.synchronize()
        if reset is not None:
            reset()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m = step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        C.COLLECTIVE_OBSERVERS.remove(note)
        r = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "wall_s": wall,
             "collective_bytes": dict(seen), "peak_bytes": torch.cuda.max_memory_allocated()}
        if counts is not None:
            c1 = counts()
            r["launches"] = {k: c1[k] for k in ("gemm_cuda", "flash_attention_cuda", "flash_attention_fwd_lse",
                                                "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")}
        rec.append(r)
        if save and i + 1 < P25_STEPS:
            keep(i)
    del holder, m
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase25_rank(rank: int, plan: dict) -> dict:
    """One rank of phase 25 (a spawned process, the card shared): each
    family in turn, its training steps, then its serving steps (the MoE
    routing forced to one card's), every count read around its own step."""

    import torch

    from repro_torch.distributed import spmd
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as Z

    torch.backends.cuda.matmul.allow_tf32 = False

    def counts():
        return {**G.LAUNCHES, **FA.LAUNCHES}

    def reset():
        G.reset_launches()
        FA.reset_launches()

    mesh = make_host_mesh(data=SPMD_MESH[0], model=SPMD_MESH[1], device="cuda")
    out = {"rank": rank, "backend": mesh.transport, "families": {}}
    for arch, layers, total, replay in P25_FAMILIES:
        t0 = time.perf_counter()
        cfg = p25_config(arch, layers)
        fam: dict = {}
        if total:
            fam["train"] = p25_train(torch, cfg, total, mesh, counts, reset,
                                     state_path=plan["states"].get(arch))
        params = spmd.init_sharded(lambda g, d: Z.init_params(cfg, g, d),
                                   torch.Generator(device="cuda").manual_seed(0),
                                   Z.param_specs(cfg, mesh, fsdp=False), mesh)
        fam["serve"], _ = p25_serve(torch, cfg, params, mesh, plan["routes"].get(arch), counts, reset)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            fam["local"] = p25_local_kernels(torch, cfg)
        else:
            for item in fam["serve"].values():
                item.pop("logits")
        fam["wall_s"] = time.perf_counter() - t0
        out["families"][arch] = fam
    return out


def phase25(torch, counts, reset, one_card_train: dict) -> dict:
    """The other families on the mesh of ranks: one card's references (its
    training steps at the families' cuts and its serving steps here;
    ``one_card_train`` gives those an earlier phase ran: whisper's), the
    dry-run's counts at the same cells, then 4 ranks (``phase25_rank``)
    and their checks."""

    import shutil
    import tempfile

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import RankMesh, spawn_ranks
    from repro_torch.models import model_zoo as Z

    t_phase = time.perf_counter()
    one: dict = {}
    routes: dict = {}
    # One card's state after each step but the last, for the ranks to restart from.
    state_dir = tempfile.mkdtemp(prefix="repro_torch_p25_")
    states = {arch: os.path.join(state_dir, arch) for arch, _, total, replay in P25_FAMILIES
              if total and replay}
    for arch, layers, total, replay in P25_FAMILIES:
        cfg = p25_config(arch, layers)
        # Heads and widths split 2 ways (the prefill's local heads, the SSM heads).
        m = SPMD_MESH[1]
        heads = [cfg.n_heads, cfg.n_kv_heads] if cfg.n_heads else []
        if cfg.ssm is not None:
            heads.append(cfg.ssm.d_inner // cfg.ssm.headdim)
        check(all(h % m == 0 for h in heads), f"{arch}'s heads {heads} do not split {m} ways")
        one[arch] = {"train": one_card_train.get(arch)}
        if total and one[arch]["train"] is None:
            one[arch]["train"] = p25_train(torch, cfg, total, None, counts, reset,
                                           state_path=states.get(arch), save=arch in states)
        params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        serve, got = p25_serve(torch, cfg, params, None, None, counts, reset)
        one[arch]["serve"] = serve
        if cfg.family == "moe":
            routes[arch] = got
        del params
        gc.collect()
        torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase

    # The dry-run's counts for the same cells on the abstract (2, 2) mesh.
    t0 = time.perf_counter()
    amesh = RankMesh.abstract(("data", "model"), SPMD_MESH)
    dry: dict = {}
    for arch, layers, total, _ in P25_FAMILIES:
        cfg = p25_config(arch, layers)
        seq_len = p25_cache(cfg)
        cells = {"decode": (ShapeSpec("p25_decode", seq_len, SPMD_ROWS, "decode"), None)}
        if cfg.swa_window:
            cells["ring1"] = (ShapeSpec("p25_ring1", seq_len, 1, "decode"), None)
        elif cfg.family == "ssm":
            cells["one"] = (ShapeSpec("p25_one", seq_len, 1, "decode"), None)
        if cfg.family == "encdec":
            mt = lambda *s, dt=torch.bfloat16: torch.zeros(s, dtype=dt, device="meta")  # noqa: E731
            fr = mt(ENCDEC_TRAIN_BATCH, cfg.enc_frames, cfg.d_model)
            tok = mt(ENCDEC_TRAIN_BATCH, DEC_CTX, dt=torch.int32)
            cells["train"] = (ShapeSpec("p25_train", DEC_CTX, ENCDEC_TRAIN_BATCH, "train"),
                              {"frames": fr, "tokens": tok, "labels": tok})
            cells["prefill"] = (ShapeSpec("p25_prefill", DEC_CTX, ENCDEC_TRAIN_BATCH, "prefill"),
                                {"frames": fr, "tokens": tok})
        elif cfg.swa_window is None:
            cells["prefill"] = (ShapeSpec("p25_prefill", SPMD_PREFILL, SPMD_ROWS, "prefill"), None)
            if total:
                cells["train"] = (ShapeSpec("p25_train", TRAIN_SEQ, TRAIN_BATCH, "train"), None)
        dry[arch] = {}
        for name, (shape, batch) in cells.items():
            rec = D.run_cell(cfg, shape, mesh=amesh, seq_shard=False, write=False, batch=batch)
            check(rec["ok"], f"dry-run {arch} {name}: {rec.get('error')}")
            dry[arch][name] = rec
    t_dry = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(phase25_rank, SPMD_MESH[0] * SPMD_MESH[1], {"routes": routes, "states": states},
                            device="cuda", timeout=P25_TIMEOUT_S)
    finally:
        shutil.rmtree(state_dir, ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    out: dict = {"mesh": list(SPMD_MESH), "backend": r0["backend"], "families": {}, "one_card_s": t_one,
                 "dry_run_s": t_dry, "ranks_s": ranks_s,
                 "launches": {"gemm_cuda": 0, "flash_attention_cuda": 0}}
    for arch, layers, total, replay in P25_FAMILIES:
        cfg = p25_config(arch, layers)
        fams = [r["families"][arch] for r in ranks]
        f0, ref, drec = fams[0], one[arch], dry[arch]
        res: dict = {"layers": cfg.n_layers, "wall_s": [f["wall_s"] for f in fams]}
        if total:
            for i, (o, st) in enumerate(zip(ref["train"], f0["train"])):
                check(abs(st["loss"] - o["loss"]) <= SPMD_LOSS_RTOL * abs(o["loss"]),
                      f"{arch} step {i} loss {st['loss']} vs one card {o['loss']}")
                check(abs(st["grad_norm"] - o["grad_norm"]) <= SPMD_NORM_RTOL * abs(o["grad_norm"]),
                      f"{arch} step {i} grad_norm {st['grad_norm']} vs one card {o['grad_norm']}")
            want = ref["train"][0]["launches"]
            total_bytes = drec["train"]["memory"]["total_bytes"]
            for f in fams:
                for i, st in enumerate(f["train"]):
                    check(all(st["launches"][k] == want.get(k, 0) for k in st["launches"]),
                          f"{arch} step {i} launches {st['launches']} vs one card {want}")
                    check(st["collective_bytes"] == drec["train"]["hlo_cost"]["by_collective"],
                          f"{arch} step {i} collective bytes {st['collective_bytes']} != dry-run "
                          f"{drec['train']['hlo_cost']['by_collective']}")
                    check(abs(st["peak_bytes"] - total_bytes) <= P25_MEM_RTOL * total_bytes,
                          f"{arch} step {i} peak {st['peak_bytes'] / 1e9:.3f} GB vs dry-run "
                          f"{total_bytes / 1e9:.3f} GB")
                    out["launches"]["gemm_cuda"] += st["launches"]["gemm_cuda"]
            res.update(losses=[st["loss"] for st in f0["train"]], one_losses=[o["loss"] for o in ref["train"]],
                       grad_norms=[st["grad_norm"] for st in f0["train"]],
                       one_grad_norms=[o["grad_norm"] for o in ref["train"]],
                       restarted=replay,
                       step_wall_s=[[st["wall_s"] for st in f["train"]] for f in fams],
                       step_peak_gb=[[st["peak_bytes"] / 1e9 for st in f["train"]] for f in fams],
                       dry_train_gb=total_bytes / 1e9,
                       train_collective_bytes=f0["train"][0]["collective_bytes"],
                       train_launches=f0["train"][0]["launches"])
        for name, item in f0["serve"].items():
            want = ref["serve"][name]
            diff = float((item["logits"] - want["logits"]).abs().max())
            check(tuple(item["logits"].shape) == tuple(want["logits"].shape),
                  f"{arch} {name} logits {tuple(item['logits'].shape)} vs {tuple(want['logits'].shape)}")
            check(bool(torch.isfinite(item["logits"]).all()), f"{arch} {name} logits not finite")
            check(diff <= LOGIT_TOL, f"{arch} {name} logits differ from one card's by {diff} (tol {LOGIT_TOL})")
            for f in fams:
                got = f["serve"][name]
                for j, lc in enumerate(got["launches"]):
                    one_lc = want["launches"][j]
                    check(lc == one_lc, f"{arch} {name} launches {lc} vs one card {one_lc}")
                    check(got["collective_bytes"][j] == drec[name]["hlo_cost"]["by_collective"],
                          f"{arch} {name} collective bytes {got['collective_bytes'][j]} != dry-run "
                          f"{drec[name]['hlo_cost']['by_collective']}")
                    out["launches"]["gemm_cuda"] += lc["gemm_cuda"]
                    out["launches"]["flash_attention_cuda"] += lc["flash_attention_cuda"]
            res[name] = {"logit_diff": diff,
                         "launches": item["launches"][0],
                         "collective_bytes": item["collective_bytes"][0],
                         "wall_ms": [[round(w * 1e3, 1) for w in f["serve"][name]["wall_s"]] for f in fams],
                         "peak_gb": [max(p[0] for p in f["serve"][name]["peak_bytes"]) / 1e9 for f in fams],
                         "base_gb": [max(p[0] for p in f["serve"][name]["base_bytes"]) / 1e9 for f in fams],
                         "req_growth_gb": [max(p[1] - b[1] for p, b in zip(f["serve"][name]["peak_bytes"],
                                                                          f["serve"][name]["base_bytes"])) / 1e9
                                           for f in fams],
                         "dry_gb": drec[name]["memory"]["total_bytes"] / 1e9,
                         "dry_arg_gb": drec[name]["memory"]["argument_bytes"] / 1e9}
        # A batch of 1 splits mixtral's ring (4,096 slots) and mamba2's 64
        # SSM heads over (data, model): a quarter a rank.
        for name in ("ring1", "one"):
            if name in f0["serve"]:
                whole = ref["serve"][name]["dim2"]
                check(all(f["serve"][name]["dim2"] * SPMD_MESH[0] * SPMD_MESH[1] == whole for f in fams),
                      f"{arch} {name}: a rank holds {f0['serve'][name]['dim2']} of {whole}")
                res[name + "_per_rank"] = [f0["serve"][name]["dim2"], whole]
        if not total:  # mixtral: the ring step's peak against its dry-run cell
            for f in fams:
                peak = max(p[0] for p in f["serve"]["ring1"]["peak_bytes"])
                want_b = drec["ring1"]["memory"]["total_bytes"]
                check(abs(peak - want_b) <= P25_MEM_RTOL * want_b,
                      f"{arch} ring step peak {peak / 1e9:.3f} GB vs dry-run {want_b / 1e9:.3f} GB")
        loc = f0["local"]
        check(loc["gemm"]["ok"], f"{arch}: gemm_cuda at a rank-local shape: {loc['gemm']}")
        if "flash" in loc:
            check(loc["flash"]["ok"], f"{arch}: flash_attention_cuda at a rank-local shape: {loc['flash']}")
        res["local"] = loc
        out["families"][arch] = res
        line = f"  {arch} ({cfg.n_layers} layers):"
        if total:
            line += (f" losses {[round(x, 5) for x in res['losses']]} vs one card "
                     f"{[round(x, 5) for x in res['one_losses']]}; grad norms "
                     f"{[round(x, 4) for x in res['grad_norms']]} vs {[round(x, 4) for x in res['one_grad_norms']]} "
                     f"(restarted from one card's state: {res['restarted']}); "
                     f"step ms {[[round(w * 1e3) for w in ws] for ws in res['step_wall_s']]}; peak GB "
                     f"{[[round(p, 2) for p in ps] for ps in res['step_peak_gb']]} vs dry-run "
                     f"{res['dry_train_gb']:.3f}; launches a step a rank {res['train_launches']}; "
                     f"collective bytes {res['train_collective_bytes']} = dry-run;")
        for name in f0["serve"]:
            r = res[name]
            line += (f" {name}: max |logit diff| {r['logit_diff']:.4f} (tol {LOGIT_TOL}), launches "
                     f"{r['launches']}, bytes {r['collective_bytes']}, ms {r['wall_ms'][0]}, peak GB "
                     f"{[round(p, 3) for p in r['peak_gb']]} from {[round(p, 3) for p in r['base_gb']]} "
                     f"(requested growth {[round(p, 4) for p in r['req_growth_gb']]}; dry-run {r['dry_gb']:.4f}, "
                     f"its arguments {r['dry_arg_gb']:.4f});")
        line += f" rank 0's kernels at local shapes {loc}; ranks' wall {[round(w, 1) for w in res['wall_s']]} s"
        print(line, flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 25 took {out['phase_s']:.1f} s (one card {t_one:.1f} s, dry-run {t_dry:.1f} s, "
          f"the ranks {ranks_s:.1f} s)", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 26: the class-sharded step a rank a pod, 2 ranks sharing the card
# ---------------------------------------------------------------------------

# The pods as ranks: (pod, data, model), pod 0 the big class on gemm_cuda
# and pod 1 the little class on gemm_cuda_lean, as in phases 20-21.
POD_MESH = (2, 1, 1)
# (c)'s mixed training steps at SPMD_LAYERS of the 24 layers (phase 24's
# cut): each rank holds a whole fp32 replica with AdamW's moments (about 18
# GB at 12 layers, 30 GB at 24); with the activations, the gathered
# gradients and two CUDA contexts, 24 layers do not fit the card twice.
POD_STEPS = 3
# Against the same-cut stream mixed step on one card (phase 26 runs it
# first): the epilogue's sums are a + b on both sides, AdamW runs on every
# rank on the same reduced gradients.
POD_LOSS_RTOL = POD_NORM_RTOL = 1e-6
# (c)'s straggler feedback: each rank's pod_time_hook gives other times;
# every rank's scheduler takes its own pod's entry, gathered (pod 1 slow).
POD_TIMES = ([1.0, 9.0], [2.0, 10.0])
POD_TIMEOUT_S = 600


def pod_serve_argv(*extra) -> list:
    return ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--gen-len", str(GEN_LEN), "--seed", "0"] + MIXED + list(extra)


POD_PATHS = {"dense": [], "paged": ["--paged", "on", "--page-size", str(PAGE_SIZE)],
             "one_shot": ["--one-shot"]}


def pod_train_args(steps: int):
    from repro_torch.launch import train as TL

    return TL.build_parser().parse_args([
        "--arch", ARCH, "--steps", str(steps), "--global-batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--ckpt-every", "100", "--seed", "0", "--heterogeneous"] + MIXED)


def pod_replay(torch, step, params, padded, total: int, rows: int) -> tuple:
    """Teacher-forced replay of ``padded`` through the mixed decode
    ``step`` (phase 20's): the logits of the generated positions, one
    (rows, vocab) fp32 tensor a step, on the host, and every step's wall
    ms (CUDA-synchronised)."""

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as Z

    cfg = get_config(ARCH)
    toks = torch.as_tensor(padded, device="cuda")
    st, out, walls = Z.init_decode_state(cfg, rows, total, device="cuda"), [], []
    with torch.no_grad():
        for t in range(total - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, st = step(params, {"tokens": toks[:, t:t + 1]}, st, t)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if t >= PROMPT_LEN - 1:
                out.append(lg[:, 0].float().cpu())
    return out, walls


def pod_streams(torch) -> dict:
    """Phase 20's stream references, made here when phase 26 runs alone:
    the three mixed paths' tokens, the engines' KV bytes, and the stream
    step's replay of the dense engine's tokens."""

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.launch import serve as SV
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as Z

    cfg = get_config(ARCH)
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    out = {"tokens": {}, "kv": {}}
    for label, extra in POD_PATHS.items():
        _, tok, eng, _ = run_serve(pod_serve_argv(*extra), params=params)
        out["tokens"][label] = tok
        if eng is not None:
            out["kv"][label] = eng.kv_stats()
        del eng
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    padded, _ = SV.pad_requests(out["tokens"]["dense"], asym.batch_layout(BATCH))
    total = PROMPT_LEN + GEN_LEN
    step = SV.mixed_decode_step(cfg, asym, make_host_mesh(pod=2), len(padded), total)
    out["replay"], out["replay_ms"] = pod_replay(torch, step, params, padded, total, len(padded))
    out["replay_tokens"] = padded
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase26_rank(rank: int, plan: dict) -> dict:
    """One pod's rank of phase 26 (a spawned process, the card shared):
    (a) the one-shot mixed decode and the stream step's replay, (b) the
    dense and paged engines, (c) the mixed training steps and the
    straggler feedback; each path's launches read just after it."""

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import RankMesh, make_host_mesh
    from repro_torch.models import model_zoo as Z

    torch.backends.cuda.matmul.allow_tf32 = False

    def counts():
        return {**G.LAUNCHES, **PA.LAUNCHES, **FA.LAUNCHES}

    def reset():
        G.reset_launches()
        PA.reset_launches()
        FA.reset_launches()

    mesh = make_host_mesh(pod=POD_MESH[0], device="cuda")
    check(isinstance(mesh, RankMesh) and mesh.shape == dict(zip(("pod", "data", "model"), POD_MESH)),
          f"rank {rank}: make_host_mesh(pod=2) gave {mesh}")
    out: dict = {"rank": rank, "pod": mesh.coord("pod"), "backend": mesh.transport, "paths": {}}
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    C.check_replicas(params, mesh)  # every rank drew the same weights
    out["init_s"] = time.perf_counter() - t0
    for label, extra in POD_PATHS.items():
        reset()
        t = time.perf_counter()
        s, tok, eng, _ = run_serve(pod_serve_argv(*extra), params=params)
        torch.cuda.synchronize()
        rec = {"wall_s": time.perf_counter() - t, "launches": counts(), "tokens": tok,
               "summary": {k: s[k] for k in ("class_sharded", "device_class", "shard_classes",
                                             "pod_ranks", "tokens_per_s")}}
        if eng is not None:
            rec.update(steps=PROMPT_LEN * eng.stats.admission_rounds + eng._step_calls,
                       kv=eng.kv_stats(), completed=eng.stats.completed,
                       submitted=int(eng._next_rid), pod=eng.pod)
        else:
            rec["steps"] = PROMPT_LEN + GEN_LEN
        out["paths"][label] = rec
        del eng
    # The stream step's replay on the ranks: the rank's pod's rows.
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    padded = plan["replay_tokens"]
    total = PROMPT_LEN + GEN_LEN
    step = SV.mixed_decode_step(cfg, asym, mesh, len(padded), total)
    rows = len(padded) // POD_MESH[0]
    reset()
    lg, out["replay_ms"] = pod_replay(torch, step, params, padded, total, rows)
    out["replay_launches"] = counts()
    pod = out["pod"]
    out["replay"] = [x[pod * rows:(pod + 1) * rows].clone() for x in lg]
    del params, lg, step
    gc.collect()
    torch.cuda.empty_cache()

    # (c): the mixed training steps, a pod a rank.
    t0 = time.perf_counter()
    trainer = TL.make_trainer(pod_train_args(POD_STEPS), cfg=spmd_config())
    torch.cuda.synchronize()
    out["train_init_s"] = time.perf_counter() - t0
    check(trainer.pod_ranks and trainer.class_sharded_step.pod == pod,
          f"rank {rank}: the trainer is not a rank a pod ({trainer.mesh})")
    out["shards"] = [(p.pod, p.device_class, p.backend) for p in trainer.class_sharded_step.provenance]
    seen: dict = {}

    def note(kind, nbytes):
        seen[kind] = seen.get(kind, 0) + nbytes

    steps = []
    for i in range(POD_STEPS):
        batch, layout = trainer.next_batch(i)
        seen.clear()
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        C.COLLECTIVE_OBSERVERS.append(note)
        t = time.perf_counter()
        try:
            m = trainer.train_step(batch)
            torch.cuda.synchronize()
        finally:
            C.COLLECTIVE_OBSERVERS.remove(note)
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "wall_s": time.perf_counter() - t, "launches": counts(),
                      "collective_bytes": dict(seen), "peak_bytes": torch.cuda.max_memory_allocated(),
                      "rows": int(batch["tokens"].shape[0]), "sizes": layout.sizes})
    out["steps"] = steps
    # The straggler feedback: this rank's hook, its own pod's entry gathered.
    trainer.pod_time_hook = lambda step: POD_TIMES[rank]
    before = trainer.asym.batch_layout(TRAIN_BATCH).sizes
    trainer.asym.observe_step(layout.sizes, trainer.pod_times(trainer.pod_time_hook(POD_STEPS)))
    out["das"] = {"before": before, "after": trainer.asym.batch_layout(TRAIN_BATCH).sizes,
                  "rates": [float(r) for r in trainer.asym.scheduler.rates]}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del trainer
    return out


def phase26(torch, counts, reset, streams=None) -> dict:
    """The class-sharded step a rank a pod: the one-card references (phase
    20's stream results, made here when it did not run; the same-cut
    stream mixed trainer), the dry-run's counts on the abstract pod mesh,
    then 2 ranks (``phase26_rank``) and their checks."""

    import statistics

    import numpy as np

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import RankMesh, spawn_ranks

    t_phase = time.perf_counter()
    if streams is None:
        streams = pod_streams(torch)
    t_streams = time.perf_counter() - t_phase
    cfg = spmd_config()
    # The same-cut stream mixed trainer on one card, and its batches.
    trainer = TL.make_trainer(pod_train_args(POD_STEPS), cfg=cfg)
    check(trainer.class_sharded_enabled() and not trainer.pod_ranks, "phase 26: the stream trainer")
    one = []
    for i in range(POD_STEPS):
        batch, layout = trainer.next_batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        one.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "wall_s": time.perf_counter() - t0})
    shape = ShapeSpec("phase26_train", TRAIN_SEQ, int(batch["tokens"].shape[0]), "train")
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    del trainer, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    t_dry = time.perf_counter()
    dry = D.run_cell(cfg, shape, little_spec="h100-little", batch=meta_batch, write=False,
                     mesh=RankMesh.abstract(("pod", "data", "model"), POD_MESH))
    check(dry["ok"], f"dry-run a rank a pod: {dry.get('error')}")
    t_dry = time.perf_counter() - t_dry

    t0 = time.perf_counter()
    ranks = spawn_ranks(phase26_rank, POD_MESH[0], {"replay_tokens": streams["replay_tokens"]},
                        device="cuda", timeout=POD_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    gemms = 7 * 24 + 1
    kernels = ("gemm_cuda", "gemm_cuda_lean")
    for r in ranks:
        pod, own = r["pod"], kernels[r["pod"]]
        check(r["backend"] == "gloo", f"rank {r['rank']} backend {r['backend']}")
        for label, p in r["paths"].items():
            c, paged = p["launches"], label == "paged"
            want = {**dict.fromkeys(c, 0), own: gemms * p["steps"],
                    "paged_attention_cuda": 24 * p["steps"] if paged else 0}
            check(c == want, f"phase 26 rank {r['rank']} {label}: launches {c}, want {want}")
            check(np.array_equal(p["tokens"], streams["tokens"][label]),
                  f"phase 26 rank {r['rank']} {label}: tokens differ from the stream pods'")
            check(p["summary"]["class_sharded"] and p["summary"]["pod_ranks"] == POD_MESH[0]
                  and [tuple(x[:2]) for x in p["summary"]["shard_classes"]] == [(0, "big"), (1, "little")],
                  f"phase 26 rank {r['rank']} {label}: {p['summary']}")
            if label != "one_shot":
                check(p["completed"] == p["submitted"] == BATCH and p["pod"] == pod,
                      f"phase 26 rank {r['rank']} {label}: completed {p['completed']} of {p['submitted']}")
                key = "kv_bytes" if label == "dense" else "arena_kv_bytes"
                check(2 * p["kv"]["pod_kv_bytes"] == streams["kv"][label][key],
                      f"phase 26 rank {r['rank']} {label}: KV bytes {p['kv']['pod_kv_bytes']} vs the "
                      f"stream engine's {streams['kv'][label][key]}")
        rows = r["replay"][0].shape[0]
        for t, (got, want) in enumerate(zip(r["replay"], streams["replay"], strict=True)):
            check(torch.equal(got, want[pod * rows:(pod + 1) * rows]),
                  f"phase 26 rank {r['rank']}: replay step {t} logits differ from the stream step's")
        check(r["replay_launches"][own] == gemms * (PROMPT_LEN + GEN_LEN - 1)
              and r["replay_launches"][kernels[1 - pod]] == 0,
              f"phase 26 rank {r['rank']} replay launches {r['replay_launches']}")
        check(r["shards"] == MIXED_SHARDS, f"phase 26 rank {r['rank']} shards {r['shards']}")
        per_step = 4 * forward_gemm_calls(cfg) - 1
        total_bytes = dry["memory"]["total_bytes"]
        for i, (st, o) in enumerate(zip(r["steps"], one, strict=True)):
            c = st["launches"]
            want = {own: per_step, **train_attention_launches(cfg.n_layers)}
            check(all(v == want.get(k, 0) for k, v in c.items()),
                  f"phase 26 rank {r['rank']} step {i}: launches {c}, want {want} and no other kernel")
            check(abs(st["loss"] - o["loss"]) <= POD_LOSS_RTOL * abs(o["loss"]),
                  f"phase 26 rank {r['rank']} step {i}: loss {st['loss']} vs the stream step's {o['loss']}")
            check(abs(st["grad_norm"] - o["grad_norm"]) <= POD_NORM_RTOL * abs(o["grad_norm"]),
                  f"phase 26 rank {r['rank']} step {i}: grad norm {st['grad_norm']} vs {o['grad_norm']}")
            check(st["collective_bytes"] == dry["hlo_cost"]["by_collective"],
                  f"phase 26 rank {r['rank']} step {i}: collective bytes {st['collective_bytes']} != "
                  f"dry-run {dry['hlo_cost']['by_collective']}")
            check(abs(st["peak_bytes"] - total_bytes) <= P25_MEM_RTOL * total_bytes,
                  f"phase 26 rank {r['rank']} step {i}: peak {st['peak_bytes'] / 1e9:.3f} GB vs dry-run "
                  f"{total_bytes / 1e9:.3f} GB")
    r0, r1 = ranks
    for label in POD_PATHS:
        check(np.array_equal(r0["paths"][label]["tokens"], r1["paths"][label]["tokens"]),
              f"phase 26 {label}: the ranks' tokens differ")
    check(r0["das"] == r1["das"] and r0["das"]["after"] != r0["das"]["before"],
          f"phase 26: the straggler feedback's split {r0['das']} vs {r1['das']}")

    walls = [[round(st["wall_s"], 2) for st in r["steps"]] for r in ranks]
    # The mixed decode step's wall ms: the replay's steps after the first
    # (each rank one pod, its logits gathered; the stream step the pods in turn).
    step_ms = {"stream": statistics.median(streams["replay_ms"][1:]),
               "ranks": [statistics.median(r["replay_ms"][1:]) for r in ranks]}
    print(f"phase 26: {ARCH} a rank a pod, {len(ranks)} ranks sharing the card over {r0['backend']}: "
          f"(a) one-shot and the stream step's replay bitwise the stream pods' ({GEN_LEN} steps); "
          f"(b) dense and paged engines' tokens bitwise, {BATCH} of {BATCH} completed on each rank, "
          f"KV bytes a rank {r0['paths']['dense']['kv']['pod_kv_bytes']} / "
          f"{r0['paths']['paged']['kv']['pod_kv_bytes']} of the stream engines' "
          f"{streams['kv']['dense']['kv_bytes']} / {streams['kv']['paged']['arena_kv_bytes']}; "
          f"launches by rank {[{k: r['paths'][k]['launches'] for k in POD_PATHS} for r in ranks]}",
          flush=True)
    print(f"  (c) {cfg.n_layers} of 24 layers: losses {[round(st['loss'], 6) for st in r0['steps']]} vs "
          f"stream {[round(o['loss'], 6) for o in one]}, grad norms "
          f"{[round(st['grad_norm'], 6) for st in r0['steps']]} vs {[round(o['grad_norm'], 6) for o in one]}; "
          f"step wall s by rank {walls} (gloo through the host: not a multi-card time); all-reduce bytes a "
          f"step a rank {r0['steps'][0]['collective_bytes']} = dry-run; peak GB by rank "
          f"{[[round(st['peak_bytes'] / 1e9, 2) for st in r['steps']] for r in ranks]} vs dry-run "
          f"{dry['memory']['total_bytes'] / 1e9:.2f}; split {r0['das']['before']} -> {r0['das']['after']} "
          f"on both ranks", flush=True)
    print(f"  mixed decode step wall ms (median of the replay's {len(r0['replay_ms']) - 1} steps after the "
          f"first): a rank a pod {[round(x, 2) for x in step_ms['ranks']]}, the pods as streams "
          f"{step_ms['stream']:.2f}; the stream trainer's steps {[round(o['wall_s'], 3) for o in one]} s",
          flush=True)
    out = {"mesh": list(POD_MESH), "backend": r0["backend"], "one_card": one, "step_ms": step_ms,
           "ranks": [{k: v for k, v in r.items() if k not in ("paths", "replay")}
                     | {"paths": {k: {kk: vv for kk, vv in p.items() if kk != "tokens"}
                                  for k, p in r["paths"].items()}} for r in ranks],
           "dry_run": {"collective_bytes": dry["hlo_cost"]["by_collective"],
                       "total_bytes": dry["memory"]["total_bytes"]},
           "launches": {k: sum(p["launches"][k] for r in ranks for p in r["paths"].values())
                        + sum(st["launches"][k] for r in ranks for st in r["steps"])
                        for k in ("gemm_cuda", "gemm_cuda_lean", "paged_attention_cuda")},
           "streams_s": t_streams, "dry_run_s": t_dry, "ranks_s": ranks_s}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 26 took {out['phase_s']:.1f} s (stream references {t_streams:.1f} s, dry-run "
          f"{t_dry:.1f} s, the ranks {ranks_s:.1f} s)", flush=True)
    return out


def main() -> None:
    t_script = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch is missing: run from the root of a checkout")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import layers as L

    detail: dict = {}
    card, detail["sass"] = phase0(torch)
    detail["card"] = card

    def counts():  # the launches by kernel; chunked_attention's and _ssd_chunked's calls on the card
        return {**G.LAUNCHES, **PA.LAUNCHES, **FA.LAUNCHES, **SSD.LAUNCHES, **L.CUDA_CALLS}

    def reset():
        G.reset_launches()
        PA.reset_launches()
        FA.reset_launches()
        SSD.reset_launches()
        for k in L.CUDA_CALLS:
            L.CUDA_CALLS[k] = 0

    alone = sys.argv[1:]
    if alone == ["--mamba2"]:  # phase 0, the scan kernels and the Mamba2 phases' gates alone
        runs = {"ssd_scan": phase1_ssd(torch)}
        for phase, arch in ((13, SSM_ARCH), (14, HYBRID_ARCH)):
            print(f"phase {phase} alone: {arch} at full width", flush=True)
            runs[f"phase{phase}"] = recurrent_phase(torch, counts, reset, arch)
            gc.collect()
            torch.cuda.empty_cache()
        for arch in (SSM_ARCH, HYBRID_ARCH):
            print(f"phase 18 alone: training {arch} at full width and depth", flush=True)
            runs[f"phase18_{arch}"] = train_family(torch, counts, reset, arch, steps=FAMILY_TRAIN_STEPS,
                                                   block_check=arch == SSM_ARCH)
            gc.collect()
            torch.cuda.empty_cache()
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_mamba2.json"), "w") as f:
            json.dump(runs, f, indent=1, default=str)
        print(json.dumps({"ok": True, "alone": "--mamba2"}))
        return

    if alone and set(alone) <= {"--phase24", "--phase25", "--phase26"}:  # alone (and phase 0)
        runs = {}
        if "--phase24" in alone:
            print("phase 24 alone: the multi-card half", flush=True)
            runs["phase24"] = phase24(torch, counts, reset)
        if "--phase25" in alone:  # whisper's one-card steps run here too
            print("phase 25 alone: the other families on the mesh of ranks", flush=True)
            runs["phase25"] = phase25(torch, counts, reset, {})
        if "--phase26" in alone:  # phase 20's stream references run here too
            print("phase 26 alone: the class-sharded step a rank a pod", flush=True)
            runs["phase26"] = phase26(torch, counts, reset)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_alone.json"), "w") as f:
            json.dump(runs, f, indent=1, default=str)
        print(json.dumps({k + "_s": v["phase_s"] for k, v in runs.items()}))
        return

    print("phase 1: kernels vs plain versions (bf16 tol "
          f"{BF16_TOL}, fp32 tol {FP32_TOL})", flush=True)
    records = phase1(torch, detail)
    records["flash_attention_cuda"] = phase1_flash(torch, detail)
    print(f"phase 1: the training attention's forward and backward kernels (M = {TRAIN_ATTN_BATCH} x "
          f"{TRAIN_ATTN_SEQ})", flush=True)
    records["flash_attention_cuda"]["train_attention_step"] = phase1_flash_training(torch)
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 1: the SSD scan kernels, forward and backward, at the Mamba2 cell's layer", flush=True)
    records["ssd_scan_cuda"] = phase1_ssd(torch)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 1: the GEMM autograd Function's backward at the training shapes "
          f"(M = {TRAIN_BATCH} x {TRAIN_SEQ})", flush=True)
    phase1_backward(torch, detail, records)

    base = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--gen-len", str(GEN_LEN), "--seed", "0"]
    gemms_per_step = 7 * 24 + 1

    # Phase 2: the dense engine.
    reset()
    s2, tok2, eng2, wall2 = run_serve(base)
    c2 = counts()
    steps2 = PROMPT_LEN * eng2.stats.admission_rounds + eng2._step_calls
    print(f"phase 2: dense engine {s2['arch']} smoke reading {s2['tokens_per_s']} tokens/s "
          f"({eng2.stats.decode_steps} steady steps), warm-up {s2['compile_s']} s, "
          f"wall {wall2:.2f} s; launches {c2}; recurrence steps {steps2}", flush=True)
    check(s2["exec_backend"] == "cuda", f"dense engine ran {s2['exec_backend']}")
    check(c2["gemm_cuda"] == gemms_per_step * steps2,
          f"gemm_cuda launches {c2['gemm_cuda']} != {gemms_per_step} x {steps2}")
    check(tok2.shape == (BATCH, PROMPT_LEN + GEN_LEN), f"dense tokens {tok2.shape}")
    check(((tok2 >= 0) & (tok2 < 92544)).all(), "dense tokens out of vocabulary")
    lg2 = eng2.prefill_logits
    check(lg2 is not None and bool(torch.isfinite(lg2.float()).all()), "dense logits not finite")
    launches = {"gemm_cuda": c2["gemm_cuda"]}

    # Phase 3: the paged engine on the same requests.
    reset()
    s3, tok3, eng3, wall3 = run_serve(base + ["--paged", "on", "--page-size", str(PAGE_SIZE)])
    c3 = counts()
    steps3 = PROMPT_LEN * eng3.stats.admission_rounds + eng3._step_calls
    print(f"phase 3: paged engine smoke reading {s3['tokens_per_s']} tokens/s, warm-up {s3['compile_s']} s, "
          f"wall {wall3:.2f} s; launches {c3}; page size {eng3.pool.spec.page_size} "
          f"x {eng3.pool.spec.pages_per_slot}", flush=True)
    check(c3["paged_attention_cuda"] == 24 * steps3,
          f"paged launches {c3['paged_attention_cuda']} != 24 x {steps3}")
    check(c3["gemm_cuda"] == gemms_per_step * steps3, "paged engine GEMM launches")
    busy = torch.as_tensor([c.slot for c in eng2.completions], device="cuda")
    lg3 = eng3.prefill_logits
    dlog = float((lg3[busy].float() - lg2[busy].float()).abs().max())
    agree = float((tok3[:, PROMPT_LEN:] == tok2[:, PROMPT_LEN:]).mean())
    print(f"  paged vs dense: first-step max |logit diff| {dlog:.4f} (tol {LOGIT_TOL}), "
          f"equal generated tokens {agree:.3f}", flush=True)
    check(dlog <= LOGIT_TOL, f"paged vs dense logits differ by {dlog}")
    launches["paged_attention_cuda"] = c3["paged_attention_cuda"]

    # Phase 4: the one-shot path under the little class's tree.
    reset()
    s4, tok4, _, wall4 = run_serve(base + ["--one-shot", "--device-class", "little"])
    c4 = counts()
    agree4 = float((tok4[:, PROMPT_LEN:] == tok2[:, PROMPT_LEN:]).mean())
    print(f"phase 4: one-shot little ({s4['exec_backend']}) smoke reading {s4['tokens_per_s']} tokens/s, "
          f"wall {wall4:.2f} s; launches {c4}; equal generated tokens vs phase 2 {agree4:.3f}",
          flush=True)
    check(s4["exec_backend"] == "cuda_lean", f"little ran {s4['exec_backend']}")
    check(c4["gemm_cuda_lean"] > 0, "gemm_cuda_lean never launched on the little path")
    check(c4["gemm_cuda_lean"] == gemms_per_step * (PROMPT_LEN + GEN_LEN), "lean launch count")
    launches["gemm_cuda_lean"] = c4["gemm_cuda_lean"]

    print("phase 5: teacher-forced replay of phase 2's tokens", flush=True)
    replay = phase5(torch, tok2)

    print(f"phase 6: the card against the CPU at the reduced size (bf16 tol {BF16_TOL})",
          flush=True)
    detail["phase6"] = phase6(torch)

    del eng2, eng3, lg2, lg3
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 7: the full-sequence forward, {FWD_ARCH} at full width, "
          f"{FWD_BATCH} x {FWD_SEQ} tokens", flush=True)
    fwd = phase7(torch, counts, reset)
    detail["forward"] = fwd
    launches["flash_attention_cuda"] = fwd["launches_5_forwards"]["flash_attention_cuda"]

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8: one decode step at a long cache, {ARCH} at full width", flush=True)
    detail["long_cache_step"] = phase8(torch, counts, reset)

    gc.collect()
    torch.cuda.empty_cache()
    print("phase 9: the measured loop: tune on the card, consume the cache, serve with the "
          "step-time probe feeding the scheduler", flush=True)
    detail["measured_loop"] = phase9(torch, counts, reset, tok2)

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10: the energy objectives, {ARCH} at full width (modeled joules)", flush=True)
    detail["energy"] = phase10(torch)

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11: {MOE_ARCH} at full width: engines, one-shot, replay, device time", flush=True)
    moe = phase11(torch, counts, reset)
    detail["moe"] = moe

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12: ring decode at {RING_ARCH}'s full widths, {RING_LAYERS} layers", flush=True)
    ring = phase12(torch, counts, reset)
    detail["ring"] = ring

    later = {}
    for phase, arch in ((13, SSM_ARCH), (14, HYBRID_ARCH)):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase {phase}: {arch} at full width: engines, one-shot, forward vs recurrence, "
              f"device time", flush=True)
        later[arch] = recurrent_phase(torch, counts, reset, arch)
    detail["recurrent"] = later

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15: {ENCDEC_ARCH} and {EMBED_ARCH} at full width: forward, loss, decode", flush=True)
    fwd15 = phase15(torch, counts, reset)
    detail["encdec_embeds"] = fwd15

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16: training {ARCH} at full width through launch/train.py, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, one failure at step {TRAIN_FAIL_AT}", flush=True)
    train = phase16(torch, counts, reset, records["gemm_cuda"]["train_backward_step"]["transpose_ms"])
    detail["train"] = train

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 17: training {MOE_ARCH} at full width, {MOE_TRAIN_LAYERS} of 24 layers, through "
          f"launch/train.py's trainer, {MOE_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens",
          flush=True)
    train_moe = train_family(torch, counts, reset, MOE_ARCH, steps=MOE_TRAIN_STEPS,
                             layers=MOE_TRAIN_LAYERS, little=True)
    detail["train_moe"] = train_moe
    train_ssm = {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 18: training {arch} at full width and depth through launch/train.py's trainer, "
              f"{FAMILY_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens", flush=True)
        train_ssm[arch] = train_family(torch, counts, reset, arch, steps=FAMILY_TRAIN_STEPS,
                                       block_check=arch == SSM_ARCH)
    detail["train_ssm"] = train_ssm
    gc.collect()
    torch.cuda.empty_cache()
    train_encdec = phase19(torch, counts, reset)
    detail["train_encdec"] = train_encdec
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20: mixed serving, {ARCH} at full width through launch/serve.py --class-sharded on: "
          f"the big pod on gemm_cuda, the little pod on gemm_cuda_lean, a CUDA stream each", flush=True)
    mixed_serve = phase20(torch, counts, reset, s2)
    streams20 = mixed_serve.pop("streams")  # phase 26's references (tensors: not in the detail)
    detail["mixed_serve"] = mixed_serve
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 21: mixed training, {ARCH} at full width through launch/train.py's trainer with "
          f"--class-sharded on, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step", flush=True)
    mixed_train = phase21(torch, counts, reset, train)
    detail["mixed_train"] = mixed_train
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 22: the fault-tolerant fleet, {ARCH} at full width: N paged engines behind one "
          f"front on bench_fleet's bursty trace, under every fault point", flush=True)
    fleet = phase22(torch, counts, reset, tok2)
    detail["fleet"] = fleet
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 23: the static verifier and the dry-run against the card's own counters",
          flush=True)
    detail["verifier_dryrun"] = phase23(torch, fwd, detail["long_cache_step"], train)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 24: the multi-card half, {ARCH} at full width and {SPMD_LAYERS} layers on a (data={SPMD_MESH[0]}, "
          f"model={SPMD_MESH[1]}) mesh of ranks sharing the card", flush=True)
    spmd_run = phase24(torch, counts, reset)
    detail["spmd"] = spmd_run
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 25: the MoE, Mamba2, hybrid and enc-dec families at full width on a (data="
          f"{SPMD_MESH[0]}, model={SPMD_MESH[1]}) mesh of ranks sharing the card", flush=True)
    spmd_families = phase25(torch, counts, reset, {ENCDEC_ARCH: train_encdec["steps"][:P25_STEPS]})
    detail["spmd_families"] = spmd_families
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 26: the class-sharded step a rank a pod, {ARCH} at full width: {POD_MESH[0]} ranks "
          f"sharing the card, the big pod's on gemm_cuda and the little pod's on gemm_cuda_lean",
          flush=True)
    pod_ranks = phase26(torch, counts, reset, streams20)
    detail["pod_ranks"] = pod_ranks
    del streams20
    for run in (train_moe, *train_ssm.values(), train_encdec, mixed_train):
        for name, err in run["backward_products"]["max_abs_err"].items():
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)

    meta = {
        "gemm_cuda": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:182"),
        "gemm_cuda_lean": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:273"),
        "paged_attention_cuda": ("src/repro_torch/csrc/paged_attention.cu",
                                 "src/repro/kernels/paged_attention.py:176"),
        "flash_attention_cuda": ("src/repro_torch/csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:80"),
    }
    per = {
        "gemm_cuda": "ms: one decode step of the serving path (169 GEMMs at M = 12); "
                     "launches: the dense engine run",
        "gemm_cuda_lean": "ms: one decode step under the little class (169 GEMMs); "
                          "launches: the one-shot run",
        "paged_attention_cuda": "ms: one decode step (24 calls at the engine's 24-token slot); "
                                "launches: the paged engine run; cases: one call at each of "
                                "serving's cache lengths",
        "flash_attention_cuda": f"ms: one forward of {FWD_ARCH} at {FWD_BATCH} x {FWD_SEQ} "
                                f"(32 calls, one a layer); launches: 4 prefill forwards and "
                                f"one loss forward",
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"], "per": per[name],
        })
    kernels[0]["launches_forward"] = fwd["launches_5_forwards"]["gemm_cuda"]
    # The launches of phase 11's and 12's paths, each read from its own run.
    moe_launches = {
        "gemm_cuda": {"qwen2_moe_dense_engine": moe["launches"]["dense"]["gemm_cuda"]},
        "gemm_cuda_lean": {"qwen2_moe_one_shot_little": moe["launches"]["one_shot_little"]["gemm_cuda_lean"]},
        "paged_attention_cuda": {"qwen2_moe_paged_engine": moe["launches"]["paged"]["paged_attention_cuda"],
                                 "mixtral_ring_step": ring["launches"]["paged_attention_cuda"]},
        "flash_attention_cuda": {},
    }
    # Phases 13-15, each path's launches read from its own run.
    for arch, rec in later.items():
        key = arch.split("-")[0]
        moe_launches["gemm_cuda"][f"{key}_dense_engine"] = rec["launches"]["dense"]["gemm_cuda"]
        moe_launches["gemm_cuda"][f"{key}_score"] = rec["launches"]["score"]["gemm_cuda"]
        moe_launches["gemm_cuda_lean"][f"{key}_one_shot_little"] = \
            rec["launches"]["one_shot_little"]["gemm_cuda_lean"]
        if rec["launches"]["score"]["flash_attention_cuda"]:
            moe_launches["flash_attention_cuda"][f"{key}_score"] = \
                rec["launches"]["score"]["flash_attention_cuda"]
    for arch, rec in fwd15.items():
        key = arch.split("-")[0]
        for name in ("gemm_cuda", "flash_attention_cuda"):
            moe_launches[name][f"{key}_forwards"] = rec["launches"][name]
            if rec["decode_launches"][name]:
                moe_launches[name][f"{key}_decode"] = rec["decode_launches"][name]
    moe_launches["gemm_cuda"]["internlm2_train"] = train["launches"]["gemm_cuda"]
    for name in ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        moe_launches["flash_attention_cuda"][f"internlm2_train_{name}"] = train["launches"][name]
    moe_launches["gemm_cuda_lean"]["internlm2_train_little_step"] = \
        train["little_step"]["launches"]["gemm_cuda_lean"]
    # Phases 17-19, each training run's launches read from its own run.
    moe_launches["gemm_cuda"]["qwen2_moe_train"] = train_moe["launches"]["gemm_cuda"]
    moe_launches["gemm_cuda_lean"]["qwen2_moe_train_little_step"] = \
        train_moe["little_step"]["launches"]["gemm_cuda_lean"]
    for arch, rec in train_ssm.items():
        moe_launches["gemm_cuda"][f"{arch.split('-')[0]}_train"] = rec["launches"]["gemm_cuda"]
    moe_launches["gemm_cuda"]["whisper_train"] = train_encdec["launches"]["gemm_cuda"]
    # Phases 20-21, the mixed step: each path's launches read from its own run.
    for label, run in mixed_serve["runs"].items():
        for name in ("gemm_cuda", "gemm_cuda_lean", "paged_attention_cuda"):
            if run["launches"][name]:
                moe_launches[name][f"internlm2_mixed_{label}"] = run["launches"][name]
    for name in ("gemm_cuda", "gemm_cuda_lean"):
        moe_launches[name]["internlm2_mixed_train"] = mixed_train["launches"][name]
    # Phase 24, the ranks: the steps' launches summed over the ranks.
    moe_launches["gemm_cuda"]["internlm2_spmd_train_4_ranks"] = spmd_run["launches"]["gemm_cuda"]
    moe_launches["flash_attention_cuda"]["internlm2_spmd_prefill_4_ranks"] = \
        spmd_run["launches"]["flash_attention_cuda"]
    # Phase 25, the other families' steps on the ranks, summed over the ranks.
    moe_launches["gemm_cuda"]["families_spmd_4_ranks"] = spmd_families["launches"]["gemm_cuda"]
    moe_launches["flash_attention_cuda"]["families_spmd_prefill_4_ranks"] = \
        spmd_families["launches"]["flash_attention_cuda"]
    # Phase 26, the pods as ranks: every path's and step's launches, summed over the ranks.
    for name in ("gemm_cuda", "gemm_cuda_lean", "paged_attention_cuda"):
        moe_launches[name]["internlm2_pod_ranks_2"] = pod_ranks["launches"][name]
    # Phase 22, the fleet: each lane's launches read from its own run.
    for label, run in fleet["lanes"].items():
        for name in ("gemm_cuda", "gemm_cuda_lean", "paged_attention_cuda"):
            if run["launches"][name]:
                moe_launches[name][f"internlm2_fleet_{label}"] = run["launches"][name]
    for row in kernels:
        row["launches_later_paths"] = moe_launches[row["name"]]
        for key, val in records[row["name"]].items():
            if key.endswith("_step") or key in ("later_forwards", "cases"):
                row[key] = val
    for row in kernels:  # 13: onto the tensor cores (wgmma + TMA, mma.sync); 15: the split walk
        row["redesigned_in"] = 13
        if row["name"] == "paged_attention_cuda":
            row["redesigned_in"] = 15
            row["device_ms"] = records[row["name"]]["device_ms"]
    detail["engines"] = {"dense": s2, "paged": s3, "one_shot_little": s4,
                         "paged_vs_dense_logit_diff": dlog, "paged_token_agreement": agree,
                         "little_token_agreement": agree4, "replay_logit_diff": replay}
    detail["script_s"] = time.perf_counter() - t_script
    print(f"chip_smoke.py: every phase passed in {detail['script_s']:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_detail.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
