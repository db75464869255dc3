#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile N] [--out DIR] [--kernels-only]
                          [--tp-only]

Phases, in this order:

1. the card's name and power limit, as nvidia-smi prints them;
2. build of the hand-written kernels from ``src/repro_torch/kernels``,
   one ``nvcc`` per source, all started together; the count of HGMMA
   (wgmma) instructions in each tensor-core kernel of K3 and of K1/K2,
   and of HMMA (mma.sync) in each of K4's, from ``cuobjdump -sass``
   where the toolkit has it; the timer's
   self-check (``timer_self_check``: a 4-byte ``zero_()`` must read at
   most 0.010 ms, so the host's dispatch gap is outside the window);
3. kernels: K1 (spec_verify) and K2 (tree_verify) against their plain
   PyTorch versions on the card, each case on every route its shape can
   take (the library's table, then the other route through
   ``ops.launch_on_route``: the tensor cores for bf16 at D 64 / 128, the
   split CUDA cores), at granite-3-8b's head shapes (widths on both
   sides of the table's threshold, windows, permuted slots, empty rows,
   blind queries, B = 1), K1 also at zamba2-1.2b's shared attention
   (Hq=Hk=32, D=64, window 4096), both at moonshot-v1-16b-a3b's (16/16,
   G = 1), yi-6b's (32/4, G = 8) and phi4-mini-3.8b's (24/8, G = 3)
   heads of 128 and whisper-tiny's (6/6 of 64), K1 at the cross blocks'
   shapes (llama-3.2-vision-11b's 32/8 heads of 128 over 1601 image
   tokens, whisper-tiny's 6/6 of 64 over 1500 frames; T = 1, 9, 32 at
   zero positions, bf16 and f32; each route also held to the f32 plain
   version at the reference's own scale, where planted faults, the last
   key dropped or a ragged tile's padding let in, must fail:
   ``scaled_check``), K1 at phase 7's own shapes (granite's heads in
   bf16, B = 2 slots on caches of 60 at T = 1, 5, 8, 9 and of 128 at
   T = 1, 16, at live counts its workloads reach and on permuted slots;
   each route also under the scaled check, where planted faults, a
   row's newest key dropped, its empty slots or a ragged tile's padding
   let in, must fail: ``serving_kernels_check``), and both at every
   other head dim they are built for; K2 on random draft trees
   (siblings at one position, a query that sees no key) and, under an
   all-true mask, bitwise equal to K1 on each route, every wrapper
   call free of host syncs under
   ``torch.cuda.set_sync_debug_mode("error")``; K3 (flash_attention: the forward,
   dQ and dK/dV) against the plain forward and backward on both routes
   of its (dtype, D) table (the tensor cores for bf16 at D 64 and 128,
   the CUDA cores for f32 and for bf16 at D 32 and 256): granite's and
   zamba2's head shapes — causal, non-causal, window 256, q_offset > 0
   with Tq != Tk, lengths at the 64-row and 64-key tile edges (1, 63,
   65, 129, 300), rows that see no key (0, LSE -inf, no gradient) —,
   D = 32, 64, 256, and phi4-mini-3.8b's G = 3 (the tensor cores' Gt = 1
   packing), yi-6b's G = 8 and whisper-tiny's encoder (B 8, 1500 frames,
   6/6 heads of 64, non-causal; the forward also under
   ``scaled_check``), repeat launches bitwise equal (see
   ``flash_kernels_check``); K4 (ssd_scan) against its plain version at
   both SSM models' head shapes and tests/test_kernels.py's SSD cases,
   each case on every route its shape can take (the recurrent route up to
   T = 64, the tensor cores for bf16, the CUDA cores) and at every n_split
   of each route, bitwise the same across n_split (see
   ``ssd_kernels_check``), the N = 16 and 32 instances included; K4's
   backward (ssd_scan_bwd) against its plain version ``ssd_bwd_ref`` and
   autograd through the plain forward at the tiny configs', mamba2-370m's
   and zamba2-1.2b's heads (b 2, and the models' heads also at the
   trainers' 16 x 448), T on and off the chunk, f32 and bf16, with
   and without an initial state, zero-dt steps and rows, on each route
   of its table (the tensor cores for bf16, the CUDA cores for both),
   repeat calls bitwise equal, bf16 under ``scaled_check``'s measure
   with planted faults fed through each route (``ssd_bwd_check``); K3's
   backward at the cross blocks' training shapes under
   ``scaled_check`` (``cross_bwd_check``); row invariance, the rule
   that a row's bits depend only on the row (``kernels/row_gemm``): the
   row-invariant product (``row_gemm``, mma.sync in bf16, FMAs in f32)
   against its plain version at granite-3-8b's products on 2048 rows,
   its rows bitwise across 1, 2, 8, 9, 64, 256 and 2048 rows, alone and
   on tp=2's column halves, its batched form at moonshot's experts
   (``row_gemm_check``); the row reductions (``row_reduce``: RMSNorm,
   the logits' log-sum-exp) likewise (``row_reduce_check``); K1 and K2's
   first query of each row bitwise at B 1 / 4 / 8 and T 1 / 9 / 33 /
   512, bf16 and f32 (``verify_row_check``); and PyTorch's own matmul,
   RMSNorm and log-sum-exp row by row, printed (``library_row_probe``);
3b. production layout (``production_phase``), after the kernel checks:
   (a) the four cached step builders of ``launch/steps.py`` on a
   one-rank production context, granite-3-8b at full width and 2 of 40
   layers, bf16, 8 x 2048 slots: a 512-token contiguous prefill (K/V
   bitwise and ``slot_pos`` equal to the engine's scatter forward on
   the same inputs), 16 greedy decodes, a verify of 9 and a three-path
   tree verify (every greedy token equal to the engine forward's argmax
   on the same caches), each kernel's launches counted over the builder
   calls alone; (b) K1 at the production prefill's widths, T = 512 (S
   2048) and 2048 (S 2560), through the wrapper and both routes against
   its plain version, and at the reference's scale against the f32 plain
   version, where three planted faults (key 0 dropped, causality off by
   one, the empty slots let in) must fail; each width timed beside its
   plain version, SDPA and its bound; (c) ``prod_rank`` in two gloo
   ranks on the card: the production ``build_train_step`` of
   granite-3-8b and moonshot-v1-16b-a3b (2 and 3 layers, full width, f32)
   at tp = 2 against the same at tp = 1 on each rank: loss, grad norm,
   every gradient leaf and the update (in units of lr) within
   ``PROD_TOL``, the MoE layers' capacity drops equal, every dispatch's
   drops and slots those of a plain numpy slot rule (``_slot_rule``),
   each rank's launches those of a train step (``_train_step_want``);
   K3 timed at a rank's heads in f32; K1 (T = 1, 512) and K2 (T = 7) with
   partials (``lse=True``: o in f32 and each row's log-sum-exp) at a
   rank's share of (d)'s cache on every route against their plain
   versions, blind rows (0, -inf) included, two shares merged against
   the whole cache's call, and timed beside the whole cache's call, SDPA
   on the share and the merge alone; (d) in the same two ranks, before
   (c): the four cached builders at tp = 2 on each rank's pieces of (a)'s
   weights and of its cache (1024 of the 2048 slots a rank, the prefill's
   window [768, 1280) across both) on (a)'s inputs, against (a)'s run
   (prefill at ``PROD_START``): every greedy token equal where (a)'s
   top-2 margin exceeds ``PROD_MARGIN`` of scale, the cache gathered
   after the prefill and at the end (``slot_pos`` exactly, K/V within
   ``PROD_CACHE_TOL`` of scale), K1 2 x 18 and K2 2 launches a rank and
   no plain call; two planted faults must fail the cache check (the last
   rank's partial left out of the merge, a rank's writes on another
   rank's slots); (c) and (d) run on the first model group of four gloo
   ranks laid out as a (2, 2) mesh (``PROD_DATA`` x ``TP``), which then
   run (e): the four cached builders on the mesh, each data rank on its
   half of (a)'s rows and each model rank on its half of the slots,
   held to (a) as (d) is (K1 2 x 18 and K2 2 launches a rank), and the
   production ``build_train_step`` of both archs on the mesh (FSDP of
   the ``embed`` axis over ``data``, 2 of the 4 rows a data rank)
   against one rank on a hand-built context with the data axis and no
   group (the MoE layers' capacity from each data shard's rows, the
   shards one after another), run on each rank in turn and held at
   ``PROD_TOL`` as (c) is; two planted faults (the gradient of the
   leaves whole on ``data`` left unsummed, the loss's denominator left
   local) must fail that gate; each rank's bytes into the data axes'
   collectives printed; K3 timed at a data rank's rows and K1 / K2's
   partials at its share of the cache;
4. linear slice: a full-width granite-3-8b Seer rollout at
   ``LINEAR_LAYERS`` (10) of its 40 layers (random weights from a seed,
   bf16) on two instances
   through the port's entry points, with its checks: every group finishes, every
   cached attention launched K1, at most one host sync per engine step,
   dispatch free of host syncs under
   ``torch.cuda.set_sync_debug_mode("error")``, every product through
   ``row_gemm`` (7 a layer and the unembedding), every norm and
   log-sum-exp through ``row_reduce``, no plain call, and a repeat run
   bit-identical; then a third pass on the second rollout, its group
   suffix trees warm from the pass before, whose responses must equal
   the cold pass's (other batches and step widths, the same tokens), and
   a fourth at ``SHIFT_TEMPERATURE``, the tree slice's yardstick; then
   the row probe
   (``row_probe``): the cached forward's every product, norm, RoPE,
   attention and routing output of a slot alone equal to that slot's in
   an 8-slot step, and a decode's to the first position of a verify of
   9, bitwise, each op that differs printed (the same probe with
   PyTorch's operations in their place is printed, not gated); moonshot
   likewise in the MoE slice (phase 11);
5. tree engine: one full-width tree-mode ``Instance`` driven with
   branching drafts (a bad trunk, a good side branch); at each step the
   fused tree step is held against the sync oracle run from the same
   state (same tokens and accept counts, same ``slot_pos``, bitwise
   equal K/V at every committed slot), with one host sync and one K2
   launch per layer per fused step, and dispatch free of host syncs;
6. tree slice: the linear slice's rollout with ``spec_mode="tree"`` and
   three draft paths, a warm pass at temperature 1.0 then a measured one
   at ``SHIFT_TEMPERATURE`` drafting from the warm group suffix trees
   (every attention through K2, none through K1, at most one host sync
   per step, drafts accepted, branching trees verified), set beside the
   linear slice's shifted pass;
7. serving, faults and tracing: the reference's own real-engine
   workloads (``bench_engine_faults``, ``bench_observability`` and
   ``bench_serving`` of ``benchmarks/common.py``) on granite-3-8b at
   ``LINEAR_LAYERS`` (10) of its 40 layers, every dispatch under sync
   debug 'error'
   (``serving_phase``).  Faults: a warm no-fault oracle, then the bench's
   schedule (a crash, a short stall, a long stall the watchdog escalates,
   a fetch failing past its retries, a corrupt blob), and its traced
   repeat: every request at the oracle's length, every recovery path
   fired, one host sync per engine step, the repeat bit-identical, no
   token lost against the oracle (a request that differs is printed with
   its first differing position and its recovery path before the check
   fails).  Tracing: an untraced and two traced runs,
   traced = untraced bitwise, conserved timelines whose ticks tile, a
   lossless Chrome round trip, the same JSON twice, the shared schema.
   Open-loop serving: seeded Poisson arrivals through ``serve``, the
   t = 0 trace equal to the closed loop, nothing shed at 1x, something
   shed at 2x, its repeat identical.  K1 once per layer per fused step,
   no other kernel and no plain attention call; then K1 on copies of
   the inputs the phase gave it (``_k1_inputs``: layer 0's call at the
   1st, 2nd, 4th, 8th ... step of each shape, every width the phase ran)
   against its plain version through the wrapper and on both routes,
   and against the f32 plain version at the reference's scale
   (``phase_kernels_check``);
8. training: ``RLTrainer`` at granite-3-8b's full width and 12 layers
   (f32 masters, AdamW, bf16 activations), two sync iterations of
   rollout -> reward -> GRPO train step -> weight push on the copy task
   (see ``training_phase`` for its checks: K3 launches per train step,
   no plain attention, the rollout on the pushed weights, a bitwise
   repeat of a train step, K3 against the plain attention); then the
   crash gap: the same granite, two sync iterations of a small rollout
   without and with one crash, gated bitwise: responses and rewards
   equal, loss and grad-norm gaps 0.0, no rollout logprob differing
   (``crash_gap_phase``); then the training of
   every other arch the reference trains, at full width: one sync
   ``RLTrainer`` iteration of moonshot-v1-16b-a3b (at
   ``moe_train_layers()``: 1 dense + 3 MoE layers), mamba2-370m and
   zamba2-1.2b whole (``rl_training_phase``), and ``make_train_step`` of
   llama-3.2-vision-11b (one cell: 5 self layers and its cross block) and
   whisper-tiny whole on a batch with seeded image embeddings or audio
   frames (``modality_training_phase``); each checks its train step's
   launches (K3 twice per attention application forward, one dQ and one
   dK/dV; K4 twice per Mamba2 block forward, one backward; no K1/K2, no
   plain call), a nonzero gradient in every leaf, a MoE model's aux
   loss, a bitwise repeat of the train step, and its rollout's K1 / K4
   launches and host syncs;
9. hybrid slice: a full-width zamba2-1.2b Seer rollout at 14 of its 38
   Mamba2 blocks (``CUT_LAYERS``: two cells of 6 blocks, each followed
   by the shared attention, and the 2-block tail; random bf16 weights
   from seed 0) with the linear slice's settings, a cold pass,
   its bit-identical repeat and a warm pass (``rec_slice``): K4 once per
   block and K1 once per attention application per forward, replays
   included, no plain attention or SSD call, at most one host sync per
   step, dispatch free of host syncs; then the hybrid engine phase, the
   fused step against the sync oracle from the same state, bitwise
   (``rec_engine_check``);
10. SSM slice: the same for a full-width mamba2-370m at 8 of its 48
   blocks (no attention), 4 groups x 4, 64 new tokens;
11. MoE slice: a full-width moonshot-v1-16b-a3b Seer rollout at 4 of
   its 48 layers (one dense, 3 MoE of 64 experts top-6 and 2 shared, each
   expert run on every token as the reference serves; 16/16 heads of 128;
   random bf16 weights from seed 0, the router in f32) with the linear
   slice's settings on caches of 1024 positions: a cold pass, its
   bit-identical repeat and a warm pass (``rec_slice``, one rollout on
   the card at a time), K1 once per layer per fused step, no K2, no
   plain attention, at most one host sync per step, dispatch free of
   host syncs, drafts accepted on the warm pass; then the MoE tree
   engine phase (``tree_engine_check`` on moonshot); then the serving
   CLI (``repro_torch.launch.serve.main``) on cuda with its default arch
   (yi-6b tiny) and with moonshot-v1-16b-a3b, llama-3.2-vision-11b and
   whisper-tiny tiny, every request finished (it runs after phase 12);
12. VLM and audio slices: a full-width, full-depth llama-3.2-vision-11b
   (40 self layers, a cross block over 1601 image tokens after every
   5th; random bf16 weights from seed 0) and whisper-tiny (4 encoder
   and 4 decoder layers, 1500 frames) Seer rollout, 4 groups x 4, 64
   new tokens, on the zero frontend stub (``rec_slice``: cold pass,
   bit-identical repeat, warm pass; K1 once per self layer and once per
   cross block per fused step, those inside the cross blocks counted
   apart; no K2, no K3 and no plain attention call in a rollout; at
   most one host sync per step; dispatch free of host syncs; building a
   whisper rollout runs the encoder on each instance, K3 4 times an
   instance); then, on seeded random image embeddings, the VLM tree
   engine phase (``tree_engine_check``: K2 per self layer, K1 per cross
   block) and, on seeded random audio frames, the audio engine phase
   (``rec_engine_check``: the linear fused step against the sync oracle
   from the same state, every cache leaf bitwise); and for each model
   the device time of one batched export and import of 8 slots with and
   without the cross memory their blobs carry (``blob_time``);
13. timing: each kernel at the shape its slice gave it, beside its plain
   version, a library call where one computes the same function, and
   the card's bound, each held against its plain version on the timed
   inputs; K1 and K2 also at fixed widths (T = 1, 9, 33, 64 at 384 live
   slots; K1 at zamba2's and at moonshot's heads T = 1, 9, 64; K1 at the
   VLM's and whisper's self-attention and cross blocks, the cross blocks
   at each slice's commonest width and T = 1, 9, 32 beside K3's
   non-causal forward on the same inputs, the route the port does not
   take there; K2 at the VLM tree engine's commonest width; K3 at the
   audio encoder), with their route, n_split,
   both routes' times at those widths, three rounds each (min,
   median, max of the round medians) and the wrapper's host time per
   call, and a check that every bf16 width runs the tensor cores (one
   route per dtype and head dim); ``row_gemm`` at granite's products
   (wq, wk, wg, wd, the unembedding) on 8, 256 and 2048 rows and the
   linear slice's commonest width, beside ``torch.matmul`` (cuBLAS) and
   its plain version, and the row reductions at that width
   (``row_gemm_time``, ``row_reduce_time``); K3 also at zamba2-1.2b's
   head shape, with each entry's
   TFLOP/s and share of its bound.  Every time is taken by
   ``_time_rounds``: CUDA events around each call after an L2 flush, the
   device spinning (``torch.cuda._sleep``) before the start event for
   twice the host's longest enqueue of the call, so the window holds
   device work only.  The ``kernels`` line has one
   row per kernel and path that runs it (its ``path``), with that path's
   ``launches`` (K1:
   the granite linear slice, the serving, faults and tracing phase, the
   hybrid cold pass, the MoE cold pass, and the VLM and whisper cold
   passes, each as self-attention and
   cross blocks; K2: the tree slice and the MoE and VLM tree engine
   phases; K3: the training phase's two train steps and the building of
   the whisper cold pass's rollout; K4: the hybrid and the SSM cold
   passes; K4's backward: the zamba2 and mamba2 train steps, timed at
   their shape, 16 x 448, on both routes with each of its kernels'
   profiled time, by ``ssd_bwd_time``; ``row_gemm`` and the two row
   reductions: the linear slice's cold pass) and
   that path's shape's timing; K4 also at fixed
   widths (``ssd_time_table``: T = 1, 3, 5, 9, 33, 64 and each SSM slice's
   cold and warm commonest, both models' heads on 8 slots) with route,
   n_split, bound on the route's units and its share, the kernel's own
   duration from torch.profiler, plain time and the wrapper's host time
   per call;
14. tensor parallel (``tp_phase``): the engine's tensor parallelism
   (``SeerRollout(tp=)``) in two ranks that share the card over gloo
   (``repro_torch.launch.mesh.spawn``, the backend named: NCCL refuses
   two ranks on one device), started after every model above is freed
   and every kernel library built.  At full width and a cut depth
   (``TP_MODELS``), bf16, 4 groups x 4, 64 new tokens: granite-3-8b (2
   of 40 layers), moonshot-v1-16b-a3b (3 of 48: one dense, two MoE) and
   zamba2-1.2b (its ``CUT_LAYERS`` depth), each at tp=None and tp=1 on
   rank 0 (the whole weights) and twice at tp=2 on both ranks (each
   rank's shard drawn layer by layer from the same seed); granite also a
   tree pass and a pass with every column-parallel product sliced from
   the unsharded one (``ColumnProducts``); then granite at 2 layers in
   f32 with TF32 off.  Gates: tp=1 bitwise tp=None (tokens, logprobs,
   engine steps, host syncs, launches); each rank's tp=2 repeat bitwise
   and the ranks equal (tokens, logprobs, lockstep digests); one host
   sync per engine step on each rank; ``tokens_lost`` 0; the kernels per
   forward as on one device; K1 and K2 at the shard shapes, each rank's
   heads with the unsharded split bitwise the unsharded call's heads,
   and held to the plain version; the sliced passes (bf16 and f32)
   bitwise tp=None run under tp=2's cost model (``_schedule_of``: tp's
   cost model sets MBA's draft budgets and so the batches), and the f32
   sliced probe (every gathered activation of a prefill chunk and a
   decode step, ``tp_probe``) bitwise tp=None, so that any difference the
   port's own code makes (a gather's order, the head and K/V shards, K1's
   split, sampling) fails; and with the row-invariant products, granite's
   tp=2 rollouts (bf16 and f32) equal to that oracle in every response,
   each rank's column products bitwise the unsharded product's columns,
   the f32 probe's gathered activations bitwise tp=None's.  moonshot's
   and zamba2's tp=2 against tp=None, and tp's schedule against
   tp=None's, are printed.
   Per-rank walls and collectives per step are printed as what they
   are: two ranks on one card are no measure of tp's speed.  K1 / K2 are
   timed at rank 0's heads (the ``*/tp2`` rows of the ``kernels``
   line).

Each phase's wall time is printed as it ends.  The line before the last
is the ``kernels`` JSON record; the last line
is ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before either.  Without a CUDA device, or without the repository beside
it, the script exits non-zero and prints no result.  ``--kernels-only``
stops after phase 3's K1 / K2 and K4 checks and their timing tables (no
slices, no result line; K4's table also times every route and n_split
at the fixed widths): the quick measurements of a kernel change.
``--tp-only`` runs phase 14 after the build and the K1 / K2 checks (no
result line).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published peaks of one H100 SXM (dense): memory bytes/s, and the
# operation rate of each input type (bf16 on the tensor cores, f32 on
# the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# tolerances of tests/test_kernels.py (spec_verify against its oracle)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SPEC_VERIFY_TPU = "src/repro/kernels/spec_verify/kernel.py:87"
TREE_VERIFY_TPU = "src/repro/kernels/spec_verify/kernel.py:94"
SPEC_VERIFY_SRC = "src/repro_torch/kernels/spec_verify/csrc/spec_verify.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:89"
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_TPU = "src/repro/kernels/ssd_scan/kernel.py:57"
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_BWD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu"
# tolerances of K4 against its plain version (tests/test_kernels.py holds
# the Pallas kernel to its oracle at 1e-4 in f32)
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the slice's rollout: 8 GRPO groups of 4 (32 requests on 2 x 8 slots,
# so requests queue and migrate), 128 new tokens in chunks of 32
GROUPS, GROUP_SIZE, NEW_TOKENS, CHUNK_SIZE = 8, 4, 128, 32
# the training phase: granite-3-8b's full width at this depth (f32
# masters, gradients and AdamW moments of all 40 layers would need 131 GB),
# prompts of BOS + 383 copy-task tokens
TRAIN_LAYERS, TRAIN_PROMPT = 12, 384
# the tree slice's measured pass and its linear yardstick sample at this
# temperature from group suffix trees of passes at 1.0, as a later RL
# iteration's policy partly follows and partly leaves the responses of
# earlier ones: with the engine row-invariant, a pass at the trees' own
# temperature replays them exactly (a linear warm pass accepts ~99.8% of
# its drafts) and proposes one path a context, no branching tree
SHIFT_TEMPERATURE = 0.9
# the linear and tree slices' depth (the tree engine's and, since the KV
# cache across ranks joined the production phase, the serving, faults and
# tracing phase's too): 10 of granite-3-8b's 40 layers (the script's time
# limit on a slow host: 20 took ~80 s less than 40 for the slices, ~50 s
# for the serving phase, whose counters the workloads fix, not the depth;
# 10 since the data axis's stage joined the production phase, ~90 s)
LINEAR_LAYERS = 10
# the SSM slice's rollout (mamba2-370m): 4 groups of 4, 64 new tokens
SSM_GROUPS, SSM_NEW_TOKENS = 4, 64
# K1's head shapes on each path that runs it: Hq, Hk, D, window; and of
# the other configs the port serves (yi-6b G = 8, phi4-mini-3.8b G = 3)
K1_SHAPES = {"granite-3-8b": (32, 8, 128, 0),
             "zamba2-1.2b": (32, 32, 64, 4096),
             "moonshot-v1-16b-a3b": (16, 16, 128, 0),
             "yi-6b": (32, 4, 128, 0),
             "phi4-mini-3.8b": (24, 8, 128, 0),
             "llama-3.2-vision-11b": (32, 8, 128, 0),
             "whisper-tiny": (6, 6, 64, 0)}
# the MoE slice: moonshot-v1-16b-a3b at full width on 2 x 8 slots of
# this many positions, 64 new tokens (as the SSM slice: the script's time
# limit)
MOE_ARCH, MOE_CACHE_LEN, MOE_NEW_TOKENS = "moonshot-v1-16b-a3b", 1024, 64
# depth of the hybrid, SSM and MoE slices, cut for the script's time
# limit (the host's eager dispatch makes a pass's time grow with depth):
# zamba2-1.2b keeps two cells of 6 blocks and the 2-block
# tail of its 38 (the shared attention's second application and the
# state offsets past the first cell), mamba2-370m 8 of 48 blocks,
# moonshot-v1-16b-a3b 4 of 48 layers (one dense, 3 MoE; 16 and 8 until
# the data axis's stage joined the production phase)
CUT_LAYERS = {"zamba2-1.2b": 14, "mamba2-370m": 8, MOE_ARCH: 4}
# the configs whose heads K1 / K2 are checked at beside granite's
NEW_HEADS = ("moonshot-v1-16b-a3b", "yi-6b", "phi4-mini-3.8b",
             "whisper-tiny")
# the serving CLI's new tokens a request (its default)
SERVE_NEW_TOKENS = 48
# the VLM and audio slices: llama-3.2-vision-11b (40 self layers, 8 cross
# blocks; 20.2 GB of bf16 weights) and whisper-tiny (4 encoder, 4 decoder
# layers) at full width and depth, 4 groups of 4, 64 new tokens each
VLM_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "whisper-tiny"
CROSS_GROUPS, CROSS_NEW_TOKENS = 4, 64
# the cross blocks' shapes: Hq, Hk, D and the memory's length (image
# tokens, audio frames); K1 is checked and timed there at these widths
# (decode, a verify, a prefill chunk)
CROSS_SHAPES = {VLM_ARCH: (32, 8, 128, 1601), AUDIO_ARCH: (6, 6, 64, 1500)}
CROSS_WIDTHS = (1, 9, 32)
# the audio encoder's attention: B, T (frames), Hq, Hk, D; non-causal
ENCODER_SHAPE = (8, 1500, 6, 6, 64)
# over 1500-1601 keys an output is an average of ~1/sqrt(Tm) (rms ~0.04),
# so TOL's bf16 3e-2 is as large as the values.  At those shapes every
# output is also held to the plain version computed in f32 from the same
# (bf16-rounded) inputs, relative to the reference's own scale: rms(err) /
# rms(ref) and max|err| / max|ref|.  A bf16 output rounds to within 2^-8
# of each value (rms ~0.2% of it); a kernel that drops the last key or lets
# a ragged tile's padding into the softmax is off by 1.4-2.6% (both are
# planted below and must fail)
REL_RMS_TOL, REL_MAX_TOL = 5e-3, 2 ** -6


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


def _sv_inputs(torch, np, *, B, T, S, Hq, Hk, D, dtype, seed, live=None):
    """Inputs of K1.  With ``live`` (B,) the cache holds positions
    0..live-1 in slots 0..live-1 and the queries sit at the last T of
    them, as in the engine; without it (the kernel check), rows alternate
    between that layout and slots permuted at random, the last row's
    cache is empty and one query of the row before it sees no key."""
    rng = np.random.default_rng(seed)
    q, k, v = _normals(torch, seed, dtype, (B, T, Hq, D), (B, S, Hk, D),
                       (B, S, Hk, D))
    k_pos = np.full((B, S), -1, np.int32)
    if live is not None:
        q_pos = np.asarray(live)[:, None] - T + np.arange(T)[None]
        for b in range(B):
            k_pos[b, :live[b]] = np.arange(live[b])
    else:
        base = rng.integers(50, min(S - T, 700), size=(B, 1))
        q_pos = base + np.arange(T)[None]
        for b in range(B):
            n = min(int(base[b, 0]) + T, S)
            slots = rng.permutation(S)[:n] if b % 2 else np.arange(n)
            k_pos[b, slots] = np.arange(n)
        k_pos[B - 1] = -1
        q_pos[B - 2, 0] = -1
    return (q, k, v, torch.from_numpy(q_pos.astype(np.int32)).to("cuda"),
            torch.from_numpy(k_pos).to("cuda"))


def _normals(torch, seed: int, dtype: str, *shapes) -> list:
    """Standard normals of each shape, drawn on the card in f32 from a
    generator seeded with ``seed`` and cast to ``dtype``: the kernel
    checks' caches are drawn where they are used (a host draw of each
    full cache is slow, and the checks run some two hundred)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(s, generator=g, device="cuda").to(dt)
            for s in shapes]


def _bound_ms(q, k, q_pos, k_pos, window, dtype, tree=None, lse=False):
    """Least time for one K1 call (K2 with ``tree``) on these inputs, and
    what sets it: K/V rows of the slots some query of the row can see, q,
    out and both position arrays, each moved once, plus for K2 the mask
    bytes of every (query, slot) the positional mask leaves open (the
    others need not be read), against 4*Hq*D operations per visible
    (query, key).  ``lse``: the partials' call, out in f32 and a 4-byte
    log-sum-exp a row."""
    from repro_torch.kernels.spec_verify.ref import pos_mask
    B, T, Hq, D = q.shape
    Hk = k.shape[2]
    pos = pos_mask(q_pos, k_pos, window)                     # (B,T,S)
    vis = pos if tree is None else pos & tree
    n_vis = int(vis.sum())
    n_slots = int(vis.any(dim=1).sum())
    es = q.element_size()
    nbytes = (2 * q.numel() * es + 4 * (q_pos.numel() + k_pos.numel())
              + 2 * n_slots * Hk * D * es)
    if tree is not None:
        nbytes += T * int(pos.any(dim=1).sum())
    if lse:
        nbytes += q.numel() * (4 - es) + 4 * B * T * Hq
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * Hq * D * n_vis / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


_SPIN = {}


def _spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per device millisecond,
    measured once with CUDA events."""
    if "per_ms" not in _SPIN:
        n = 1 << 22
        torch.cuda._sleep(1000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(n)
        b.record()
        torch.cuda.synchronize()
        _SPIN["per_ms"] = n / a.elapsed_time(b)
    return _SPIN["per_ms"]


# timing rounds of every measured call: each a median of its calls,
# reported as the min, median and max of the rounds
ROUNDS = 3


def _host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds per call of ``fn``: enqueue only, the device not
    waited for (``calls`` back to back, then one synchronize); the median
    of ``ROUNDS`` rounds."""
    per = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append(1e6 * (time.perf_counter() - t) / calls)
        torch.cuda.synchronize()
    return sorted(per)[len(per) // 2]


def _time_rounds(torch, fn, iters: int, flush=None) -> dict:
    """Device time of ``fn``: ``ROUNDS`` rounds, each the median of
    ``iters`` calls timed by CUDA events; the min, median and max of the
    round medians.  ``flush`` runs before each call, outside the timed
    window.  Before each start event the device spins
    (``torch.cuda._sleep``) for twice the longest host enqueue of ``fn``
    seen in warm-up, so that every kernel of ``fn`` is queued before the
    start event is reached: the window holds device work only, never the
    host's dispatch gap.  The median, not the mean: one slow stretch of
    the card should not decide a figure."""
    fn()
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    spin = int(2e3 * max(host) * _spin_cycles_per_ms(torch))
    meds = []
    for _ in range(ROUNDS):
        pairs = []
        for _ in range(iters):
            if flush is not None:
                flush()
            torch.cuda._sleep(spin)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        meds.append(times[len(times) // 2])
    spread = sorted(meds)
    return {"min": spread[0], "median": spread[len(spread) // 2],
            "max": spread[-1], "rounds": meds,
            "host_enqueue_us": 1e6 * max(host)}


def _time_ms(torch, fn, iters: int, flush=None) -> float:
    """The median of ``_time_rounds``' round medians."""
    return _time_rounds(torch, fn, iters, flush)["median"]


def timer_self_check(torch) -> float:
    """The timed window of one tiny kernel (a 4-byte ``zero_()``) after an
    L2 flush; above 0.010 ms the host's gap is still inside the window."""
    tiny = torch.empty(1, dtype=torch.int32, device="cuda")
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    t = _time_rounds(torch, tiny.zero_, 50, scratch.zero_)
    check(t["max"] <= 0.010, f"timer self-check: a 4-byte zero_() reads "
          f"{t['max']:.4f} ms (> 0.010): the host's gap is in the window")
    return t["max"]


def _no_sync(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: raises
    if the call synchronises the host with the device."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _routes(dtype: str, D: int) -> tuple:
    """The routes a (dtype, head dim) can take: the CUDA cores always, the
    tensor cores for bf16 at D 64 and 128."""
    if dtype == "bfloat16" and D in (64, 128):
        return ("cuda_cores", "tensor_cores")
    return ("cuda_cores",)


def _route_outputs(torch, ops, q, k, v, qp, kp, tm, window, dtype, D):
    """K1 (K2 with ``tm``) launched twice on each route the shape can
    take, K2 also under an all-true mask beside K1 on that route: {route:
    (out, repeat bit-equal, all-true K2 == K1 or None)}."""
    res = {}
    for r in _routes(dtype, D):
        out = ops.launch_on_route(r, q, k, v, qp, kp, tm, window=window)
        out2 = ops.launch_on_route(r, q, k, v, qp, kp, tm, window=window)
        same_k1 = None
        if tm is not None:
            k2_all = ops.launch_on_route(r, q, k, v, qp, kp,
                                         torch.ones_like(tm), window=window)
            k1 = ops.launch_on_route(r, q, k, v, qp, kp, window=window)
            same_k1 = torch.equal(k2_all, k1)
        res[r] = (out, torch.equal(out, out2), same_k1)
    return res


def kernels_check(torch, np, *, B, S, T_list) -> list:
    """K1 against its plain version at the head shapes of both paths that
    run it, on every route each shape can take (the wrapper's own route
    first, from the library's table, then the other through
    ``ops.launch_on_route``): granite-3-8b's attention (Hq=32, Hk=8,
    D=128) at widths on both sides of the tensor cores' 64 packed rows,
    window 0 and 256, bf16 and f32, permuted slots, an empty row and a
    blind query (both exactly 0), and B = 1 with a live count that does
    not divide among the splits; zamba2-1.2b's shared attention (Hq=Hk=32,
    D=64, window 4096, its step widths); moonshot-v1-16b-a3b's (16/16, G =
    1), yi-6b's (32/4, G = 8), phi4-mini-3.8b's (24/8, G = 3) and
    whisper-tiny's (6/6 of 64) heads at every width of ``T_list`` in bf16
    (both routes) and at T 1, 9 in f32 (llama-3.2-vision-11b's self
    layers have granite's heads); each on the main path's cache;
    then each other head dim it is built for on a small cache, so that
    every instance of the kernel ran on the card.  Every launch is
    repeated and must be bitwise equal; the wrapper's call runs under
    sync debug "error" (sizing the split workspace needs no host sync).
    Each row names the path whose shape it has."""
    from repro_torch.kernels.spec_verify import ops
    rows = []
    hq, hk, d, _ = K1_SHAPES["granite-3-8b"]
    cases = [("granite-3-8b", B, S, T, hq, hk, d, dt, 0, None)
             for T in T_list for dt in ("bfloat16", "float32")]
    cases += [("granite-3-8b", B, S, T, hq, hk, d, dt, 256, None)
              for T, dt in ((9, "bfloat16"), (17, "bfloat16"),
                            (64, "bfloat16"), (128, "bfloat16"),
                            (1, "float32"), (65, "float32"))]
    cases += [("granite-3-8b", 1, S, T, hq, hk, d, dt, 0, [333])
              for T, dt in ((1, "bfloat16"), (64, "bfloat16"),
                            (1, "float32"))]
    hq, hk, d, win = K1_SHAPES["zamba2-1.2b"]
    cases += [("zamba2-1.2b", B, S, T, hq, hk, d, dt, w, None)
              for T in (1, 9, 64, 65) for dt in ("bfloat16", "float32")
              for w in (0, win)]
    for name in NEW_HEADS:
        hq, hk, d, _ = K1_SHAPES[name]
        cases += [(name, B, S, T, hq, hk, d, "bfloat16", 0, None)
                  for T in T_list]
        cases += [(name, B, S, T, hq, hk, d, "float32", 0, None)
                  for T in (1, 9)]
    cases += [("small", 4, 512, 9, 8, 2, D, dt, w, None)
              for D in ops.HEAD_DIMS if D != 128
              for dt, w in (("bfloat16", 0), ("float32", 64))]
    for shape, B, S, T, Hq, Hk, D, dtype, window, live in cases:
        q, k, v, qp, kp = _sv_inputs(torch, np, B=B, T=T, S=S, Hq=Hq, Hk=Hk,
                                     D=D, dtype=dtype, seed=T + window + D,
                                     live=live)
        rows.append(_k1_case(torch, shape, q, k, v, qp, kp, window,
                             empty_rows=live is None,
                             note=None if live is None else f"live {live[0]}"))
    return rows


def _k1_case(torch, shape, q, k, v, qp, kp, window, *, empty_rows,
             note=None) -> dict:
    """One K1 case: the wrapper (under sync debug "error") and each route
    its shape can take, launched twice, against the plain version at TOL;
    with ``empty_rows`` the last row's cache is empty and the first query
    of the row before it sees no key, and both must come back 0."""
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_ref
    B, T, Hq, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    dtype = str(q.dtype).removeprefix("torch.")
    route, n_split = ops.plan(q.dtype, B, T, Hq, Hk, D, S)
    out = _no_sync(torch, lambda: ops.spec_verify(q, k, v, qp, kp,
                                                  window=window))
    ref = spec_verify_ref(q, k, v, qp, kp, window=window)
    by_route = _route_outputs(torch, ops, q, k, v, qp, kp, None, window,
                              dtype, D)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    what = f"B={B} T={T} S={S} Hq={Hq} Hk={Hk} D={D} {dtype} " \
        f"window={window}"
    check(torch.equal(out, by_route[route][0]),
          f"spec_verify: the wrapper and its route {route} differ ({what})")
    errs = {}
    for r, (o, det, _) in by_route.items():
        errs[r] = float((o.float() - ref.float()).abs().max())
        ok = torch.allclose(o.float(), ref.float(), atol=tol, rtol=tol)
        check(bool(ok), f"spec_verify disagrees with its plain version "
              f"on {r}: {what} max|err|={errs[r]}")
        check(det, f"spec_verify: repeat launch on {r} not bit-equal "
              f"({what})")
        if empty_rows:
            empty = o[B - 1].float().abs().max().item() == 0.0 and \
                o[B - 2, 0].float().abs().max().item() == 0.0
            check(empty, f"spec_verify: rows with no visible key not 0 "
                  f"on {r} ({what})")
    log(f"  spec_verify {shape} {what}: route {route} (n_split {n_split}); "
        f"max|err| " + ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
        + f" (tol {tol}); repeats bit-equal; wrapper free of host syncs"
        + ("; empty rows and blind query 0" if empty_rows else "")
        + (f"; {note}" if note else ""))
    return {"shape": shape, "B": B, "S": S, "T": T, "Hq": Hq, "Hk": Hk,
            "D": D, "dtype": dtype, "window": window, "route": route,
            "n_split": n_split, "errs_by_route": errs,
            "max_abs_err": max(errs.values()), "tol": tol,
            "empty_rows_zero": empty_rows, "deterministic": True}


def _cross_inputs(torch, np, *, B, T, Tm, Hq, Hk, D, dtype, seed):
    """Inputs of K1 as a cross block gives them: q (B,T,Hq,D) against a
    contiguous memory k, v (B,Tm,Hk,D) with no scratch slot, every query
    and key at position 0 (every key visible)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to("cuda", dt)
    zeros = torch.zeros((B, max(T, Tm)), dtype=torch.int32, device="cuda")
    return (arr(B, T, Hq, D), arr(B, Tm, Hk, D), arr(B, Tm, Hk, D),
            zeros[:, :T].contiguous(), zeros[:, :Tm].contiguous())


def _scaled_err(out, ref32) -> tuple:
    """(rms(err) / rms(ref), max|err| / max|ref|) of ``out`` against the
    f32 plain version ``ref32``."""
    e = out.float() - ref32
    return (float(e.pow(2).mean().sqrt() / ref32.pow(2).mean().sqrt()),
            float(e.abs().max() / ref32.abs().max()))


def _scaled_ok(errs: tuple) -> bool:
    return errs[0] <= REL_RMS_TOL and errs[1] <= REL_MAX_TOL


def _planted_faults(torch, plain, k, v, dtype, tile: int = 64) -> dict:
    """Outputs of two wrong kernels over a memory k, v (B, Tm, Hk, D) whose
    length is no multiple of ``tile``, each the f32 plain version ``plain(k,
    v)`` over a changed memory, rounded to ``dtype``: the last key dropped,
    and the last tile's padding (zero keys up to a multiple of ``tile``)
    let into the softmax."""
    B, Tm = k.shape[:2]
    z = k.new_zeros((B, -Tm % tile) + tuple(k.shape[2:]))
    return {"last key dropped": plain(k[:, :-1], v[:, :-1]).to(dtype),
            f"{z.shape[1]} padded keys admitted":
            plain(torch.cat([k, z], 1), torch.cat([v, z], 1)).to(dtype)}


def scaled_check(torch, outs: dict, plain, k, v, what: str,
                 faults=None) -> dict:
    """Holds each output of ``outs`` ({name: tensor}) to the plain version
    computed in f32 from the same inputs (``plain(k, v)``, k and v f32)
    within REL_RMS_TOL / REL_MAX_TOL of the reference's scale, and checks
    that each planted fault fails that bound: ``faults`` ({name: a wrong
    kernel's output}), by default ``_planted_faults``.  Returns {name:
    (rel rms, rel max)}, the faults' included."""
    k32, v32 = k.float(), v.float()
    ref32 = plain(k32, v32)
    dtype = next(iter(outs.values())).dtype
    if faults is None:
        faults = _planted_faults(torch, plain, k32, v32, dtype)
    errs = {n: _scaled_err(o, ref32) for n, o in outs.items()}
    for n, e in errs.items():
        check(_scaled_ok(e), f"{what}: {n} off its f32 plain version: "
              f"rms(err)/rms(ref) {e[0]:.2e} (limit {REL_RMS_TOL}), "
              f"max|err|/max|ref| {e[1]:.2e} (limit {REL_MAX_TOL:.2e})")
    for n, f in faults.items():
        e = errs[f"fault: {n}"] = _scaled_err(f, ref32)
        check(not _scaled_ok(e), f"{what}: the planted fault '{n}' passes "
              f"the scaled check ({e[0]:.2e}, {e[1]:.2e})")
    log(f"  {what} against f32: " + ", ".join(
        f"{n} {a:.2e}/{b:.2e}" for n, (a, b) in errs.items())
        + f" (rel rms/rel max; limits {REL_RMS_TOL}/{REL_MAX_TOL:.2e}"
        + (", faults must exceed them)" if faults else ")"))
    return errs


def _cross_plain(torch, q, qp):
    """K1's plain version in f32 over a memory of any length at zero
    positions, for ``scaled_check``."""
    from repro_torch.kernels.spec_verify.ref import spec_verify_ref
    q32 = q.float()
    return lambda k, v: spec_verify_ref(
        q32, k, v, qp, torch.zeros(k.shape[:2], dtype=torch.int32,
                                   device=k.device))


def cross_kernels_check(torch, np, *, B) -> list:
    """K1 at the cross blocks' shapes (``CROSS_SHAPES``: llama-3.2-vision's
    32/8 heads of 128 over 1601 image tokens, whisper-tiny's 6/6 heads of
    64 over 1500 frames; memory lengths that are no multiple of a tile)
    at T = 1, 9 and 32, bf16 and f32, on every route each takes, at zero
    positions (``_k1_case``); each route's output also held to the f32
    plain version at the reference's scale (``scaled_check``)."""
    from repro_torch.kernels.spec_verify import ops
    rows = []
    for model, (Hq, Hk, D, Tm) in CROSS_SHAPES.items():
        for T in CROSS_WIDTHS:
            for dtype in ("bfloat16", "float32"):
                q, k, v, qp, kp = _cross_inputs(
                    torch, np, B=B, T=T, Tm=Tm, Hq=Hq, Hk=Hk, D=D,
                    dtype=dtype, seed=T + D)
                row = _k1_case(torch, f"{model}/cross", q, k, v, qp, kp, 0,
                               empty_rows=False, note="zero positions")
                outs = {r: ops.launch_on_route(r, q, k, v, qp, kp)
                        for r in _routes(dtype, D)}
                row["scaled_errs"] = scaled_check(
                    torch, outs, _cross_plain(torch, q, qp), k, v,
                    f"spec_verify {model}/cross T={T} {dtype}")
                rows.append(row)
    return rows


def _time_routes(torch, ops, q, k, v, qp, kp, tm, window, dtype, iters,
                 flush) -> dict:
    """At the fixed widths (and the production prefill's), each route the
    shape can take timed through
    ``ops.launch_on_route`` (K2 with ``tm``): {route: spread}; the
    measurement that fixes the route table."""
    T, D = q.shape[1], q.shape[3]
    routes = _routes(dtype, D)
    widths = VERIFY_WIDTHS + tuple(t for t, _ in PROD_K1_WIDTHS)
    if T not in widths or len(routes) < 2:
        return {}
    return {r: _time_rounds(torch, lambda: ops.launch_on_route(
        r, q, k, v, qp, kp, tm, window=window), iters, flush)
        for r in routes}


def kernels_time(torch, np, *, B, S, T, live, model="granite-3-8b",
                 dtype="bfloat16", iters=50, split_like=None) -> dict:
    """Time K1, its plain version and SDPA (the yardstick, never called
    by the port) on one main-path shape of ``model``'s attention
    (``K1_SHAPES``), with L2 flushed before each; ``split_like``: the
    shape is a tensor-parallel rank's heads of a layer of these (Hq,
    Hk), whose n_split the wrapper takes."""
    import torch.nn.functional as F
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import pos_mask, spec_verify_ref
    Hq, Hk, D, window = K1_SHAPES[model]
    q, k, v, qp, kp = _sv_inputs(torch, np, B=B, T=T, S=S, Hq=Hq, Hk=Hk,
                                 D=D, dtype=dtype, seed=7, live=live)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    n0 = dict(ops.launches)
    out = ops.spec_verify(q, k, v, qp, kp, window=window,
                          split_like=split_like)
    ref = spec_verify_ref(q, k, v, qp, kp, window=window)
    err = float((out.float() - ref.float()).abs().max())
    check(err <= TOL[dtype] * (1 + float(ref.float().abs().max())),
          f"spec_verify ({model} timing shape) max|err|={err}")
    def k1():
        return ops.spec_verify(q, k, v, qp, kp, window=window,
                               split_like=split_like)
    t = _time_rounds(torch, k1, iters, flush)
    host_us = _host_us(torch, k1)
    plain_ms = _time_ms(torch, lambda: spec_verify_ref(q, k, v, qp, kp,
                                                       window=window),
                        max(iters // 5, 5), flush)
    # SDPA on the same values in its (B, H, T, D) layout with the same
    # boolean mask; the transposes are made outside the timed window
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = pos_mask(qp, kp, window)[:, None]

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    lt = _time_rounds(torch, lib, iters, flush)
    bound_ms, bound_by = _bound_ms(q, k, qp, kp, window, dtype)
    route, n_split = ops.plan(q.dtype, B, T, Hq, Hk, D, S,
                              n_split=ops.split_of(q.dtype, B, T, D, S,
                                                   split_like))
    route_ms = _time_routes(torch, ops, q, k, v, qp, kp, None, window, dtype,
                            iters, flush)
    ops.launches.update(n0)      # timing launches are not a slice's
    return {"model": model, "T": T, "Hq": Hq, "Hk": Hk, "D": D,
            "window": window, "dtype": dtype,
            "live_mean": float(np.mean(live)), "route": route,
            "n_split": n_split, "route_ms": route_ms,
            "ms": t["median"], "ms_spread": t, "host_us": host_us,
            "plain_ms": plain_ms, "library_ms": lt["median"],
            "library_spread": lt, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def _tree_inputs(torch, np, *, B, T, S, Hq, Hk, D, dtype, seed, live=None):
    """Inputs of K2: each row a random draft tree of T nodes (the anchor
    and T-1 nodes, siblings at duplicate positions) over a cache of
    committed positions, laid out as the engine lays it out (node c at
    slot anchor+c), with the ancestor mask.  The anchor sits at
    ``live[b] - 1`` (or at random); without ``live`` the last query of
    the last row sees no key."""
    rng = np.random.default_rng(seed)
    q, k, v = _normals(torch, seed, dtype, (B, T, Hq, D), (B, S, Hk, D),
                       (B, S, Hk, D))
    anchors = (np.asarray(live) - 1 if live is not None
               else rng.integers(50, min(S - T, 700), size=B))
    q_pos = np.zeros((B, T), np.int32)
    k_pos = np.full((B, S), -1, np.int32)
    tree = np.zeros((B, T, S), bool)
    for b in range(B):
        a = int(anchors[b])
        k_pos[b, :a + 1] = np.arange(a + 1)
        parent = [-1] + [int(rng.integers(0, j)) for j in range(1, T)]
        depth = [0] * T
        for j in range(1, T):
            depth[j] = depth[parent[j]] + 1
        for j in range(T):
            q_pos[b, j] = a + depth[j]
            tree[b, j, :a + 1] = True
            node = j
            while node >= 0:
                tree[b, j, a + node] = True
                node = parent[node]
            k_pos[b, a + j] = q_pos[b, j]
    if live is None:
        tree[B - 1, T - 1] = False
    return (q, k, v, torch.from_numpy(q_pos).to("cuda"),
            torch.from_numpy(k_pos).to("cuda"),
            torch.from_numpy(tree).to("cuda"))


def tree_kernels_check(torch, np, *, B, S, T_list) -> list:
    """K2 against its plain version at the main path's head shapes, on
    random trees, T in ``T_list`` (decode, tree verify and prefill
    widths on both sides of the tensor cores' 64 packed rows), bf16 and
    f32, window 0 and 256, on every route each shape can take; repeat
    launches bit-equal, the query that sees no key exactly 0, and with an
    all-true mask K2 bitwise equal to K1 on the same route, the wrapper's
    call free of host syncs.  Then B = 1, the heads of moonshot-v1-16b-a3b,
    yi-6b and phi4-mini-3.8b at every width (bf16, both routes) and T = 9
    in f32, and each other head dim on a small cache."""
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import tree_verify_ref
    rows = []
    cases = [("granite-3-8b", B, S, T, 32, 8, 128, dt, w) for T in T_list
             for dt in ("bfloat16", "float32") for w in (0, 256)]
    cases += [("granite-3-8b", 1, S, T, 32, 8, 128, "bfloat16", 0)
              for T in (1, 9, 64)]
    for name in NEW_HEADS:
        hq, hk, d, _ = K1_SHAPES[name]
        cases += [(name, B, S, T, hq, hk, d, "bfloat16", 0) for T in T_list]
        cases += [(name, B, S, 9, hq, hk, d, "float32", 0)]
    cases += [("small", 4, 512, 9, 8, 2, D, dt, w) for D in ops.HEAD_DIMS
              if D != 128 for dt, w in (("bfloat16", 0), ("float32", 64))]
    for shape, B, S, T, Hq, Hk, D, dtype, window in cases:
        q, k, v, qp, kp, tm = _tree_inputs(
            torch, np, B=B, T=T, S=S, Hq=Hq, Hk=Hk, D=D, dtype=dtype,
            seed=100 + T + window + D)
        route, n_split = ops.plan(q.dtype, B, T, Hq, Hk, D, S)
        out = _no_sync(torch, lambda: ops.tree_verify(q, k, v, qp, kp, tm,
                                                      window=window))
        ref = tree_verify_ref(q, k, v, qp, kp, tm, window=window)
        by_route = _route_outputs(torch, ops, q, k, v, qp, kp, tm, window,
                                  dtype, D)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        what = f"B={B} T={T} S={S} Hq={Hq} Hk={Hk} D={D} {dtype} " \
            f"window={window}"
        check(torch.equal(out, by_route[route][0]),
              f"tree_verify: the wrapper and its route {route} differ "
              f"({what})")
        errs = {}
        for r, (o, det, same_k1) in by_route.items():
            errs[r] = float((o.float() - ref.float()).abs().max())
            ok = torch.allclose(o.float(), ref.float(), atol=tol, rtol=tol)
            check(bool(ok), f"tree_verify disagrees with its plain version "
                  f"on {r}: {what} max|err|={errs[r]}")
            check(o[B - 1, T - 1].float().abs().max().item() == 0.0,
                  f"tree_verify: a query with no visible key is not 0 on "
                  f"{r} ({what})")
            check(det, f"tree_verify: repeat launch on {r} not bit-equal "
                  f"({what})")
            check(same_k1, f"tree_verify with an all-true mask is not "
                  f"bitwise K1 on {r} ({what})")
        err = max(errs.values())
        rows.append({"shape": shape, "B": B, "S": S, "T": T, "Hq": Hq,
                     "Hk": Hk, "D": D, "dtype": dtype, "window": window,
                     "route": route,
                     "n_split": n_split, "errs_by_route": errs,
                     "max_abs_err": err, "tol": tol, "empty_query_zero": True,
                     "deterministic": True, "all_true_equals_k1": True})
        log(f"  tree_verify {what}: route {route} (n_split {n_split}); "
            f"max|err| " + ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
            + f" (tol {tol}); blind query 0, repeats bit-equal, all-true "
            f"mask == K1 on every route, wrapper free of host syncs")
    return rows


def tree_kernels_time(torch, np, *, B, S, T, live, model="granite-3-8b",
                      dtype="bfloat16", iters=50, split_like=None) -> dict:
    """Time K2, K1 on the same inputs (without the mask), K2's plain
    version and SDPA with the combined boolean mask (the yardstick, never
    called by the port), at ``model``'s heads (``K1_SHAPES``, window 0),
    with L2 flushed before each call; ``split_like`` as
    ``kernels_time``'s."""
    import torch.nn.functional as F
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import pos_mask, tree_verify_ref
    Hq, Hk, D, _ = K1_SHAPES[model]
    q, k, v, qp, kp, tm = _tree_inputs(torch, np, B=B, T=T, S=S, Hq=Hq,
                                       Hk=Hk, D=D, dtype=dtype, seed=17,
                                       live=live)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    n0 = dict(ops.launches)
    out = ops.tree_verify(q, k, v, qp, kp, tm, split_like=split_like)
    ref = tree_verify_ref(q, k, v, qp, kp, tm)
    err = float((out.float() - ref.float()).abs().max())
    check(err <= TOL[dtype] * (1 + float(ref.float().abs().max())),
          f"tree_verify (timing shape) max|err|={err}")
    def k2():
        return ops.tree_verify(q, k, v, qp, kp, tm, split_like=split_like)
    t = _time_rounds(torch, k2, iters, flush)
    host_us = _host_us(torch, k2)
    k1_ms = _time_ms(torch, lambda: ops.spec_verify(
        q, k, v, qp, kp, split_like=split_like), iters, flush)
    plain_ms = _time_ms(torch, lambda: tree_verify_ref(q, k, v, qp, kp, tm),
                        max(iters // 5, 5), flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (pos_mask(qp, kp) & tm)[:, None]

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    lt = _time_rounds(torch, lib, iters, flush)
    bound_ms, bound_by = _bound_ms(q, k, qp, kp, 0, dtype, tree=tm)
    route, n_split = ops.plan(q.dtype, B, T, Hq, Hk, D, S,
                              n_split=ops.split_of(q.dtype, B, T, D, S,
                                                   split_like))
    route_ms = _time_routes(torch, ops, q, k, v, qp, kp, tm, 0, dtype, iters,
                            flush)
    ops.launches.update(n0)      # timing launches are not a slice's
    return {"model": model, "T": T, "Hq": Hq, "Hk": Hk, "D": D, "window": 0,
            "dtype": dtype, "live_mean": float(np.mean(live)),
            "route": route, "n_split": n_split, "route_ms": route_ms,
            "ms": t["median"], "ms_spread": t, "host_us": host_us,
            "k1_ms": k1_ms, "plain_ms": plain_ms,
            "library_ms": lt["median"], "library_spread": lt,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


def _spread(t) -> str:
    return f"{t['median']:.4f} [{t['min']:.4f}-{t['max']:.4f}]"


def log_verify_time(name, tm) -> None:
    """One timing row of K1 or K2: card ms as median [min-max] of the
    round medians, host microseconds per call, plain, SDPA, bound."""
    heads = f" Hq={tm['Hq']} Hk={tm['Hk']} D={tm['D']} window " \
        f"{tm['window']}" if "Hq" in tm else ""
    k1 = f" (K1 on the same inputs {tm['k1_ms']:.4f})" if "k1_ms" in tm \
        else ""
    both = "".join(f"; on {r} {_spread(x)}"
                   for r, x in tm["route_ms"].items())
    log(f"  {name} timing T={tm['T']}{heads} live~{tm['live_mean']:.0f} "
        f"bf16, route {tm['route']} (n_split {tm['n_split']}): "
        f"{_spread(tm['ms_spread'])} ms{k1}, host {tm['host_us']:.1f} "
        f"us/call{both}; plain {tm['plain_ms']:.4f} ms; SDPA "
        f"{_spread(tm['library_spread'])} ms; bound {tm['bound_ms']:.4f} "
        f"ms ({tm['bound_by']})")


# K1 / K2 check widths at granite's heads (G = 4), each checked on both
# routes: the table sends T = 1 to the split CUDA cores and T >= 2 to the
# tensor cores; 15/16/17, 63/64/65 and 128 pack 60-68, 256-260 and 512
# rows, around the 64-row tiles' edges
CHECK_WIDTHS = (1, 2, 3, 9, 15, 16, 17, 33, 64, 65, 128)
# fixed widths at 384 live slots of every row, comparable across runs:
# K1 and K2 at granite-3-8b's heads, K1 also at zamba2-1.2b's
VERIFY_WIDTHS = (1, 9, 33, 64)
ZAMBA_WIDTHS = (1, 9, 64)
MOE_WIDTHS = (1, 9, 64)


def verify_time_table(torch, np, *, B, S, extra=(), zamba_extra=(),
                      tree_extra=(), moe_extra=(), moe_tree_extra=()) -> dict:
    """K1 and K2 timed at the fixed widths (and each slice's commonest
    widths, ``extra``: (T, live) pairs) with ``kernels_time`` and
    ``tree_kernels_time``; K1 at moonshot-v1-16b-a3b's heads at the MoE
    slice's commonest width and T = 1, 9, 64, K2 there at the MoE tree
    engine's commonest width."""
    fixed = [(T, np.full(B, 384)) for T in VERIFY_WIDTHS]
    zfixed = [(T, np.full(B, 384)) for T in ZAMBA_WIDTHS]
    mfixed = [(T, np.full(B, 384)) for T in MOE_WIDTHS]
    out = {"spec_verify": [kernels_time(torch, np, B=B, S=S, T=T, live=lv)
                           for T, lv in list(extra) + fixed],
           "spec_verify/zamba2-1.2b": [
               kernels_time(torch, np, B=B, S=S, T=T, live=lv,
                            model="zamba2-1.2b")
               for T, lv in list(zamba_extra) + zfixed],
           "tree_verify": [tree_kernels_time(torch, np, B=B, S=S, T=T,
                                             live=lv)
                           for T, lv in list(tree_extra) + fixed],
           f"spec_verify/{MOE_ARCH}": [
               kernels_time(torch, np, B=B, S=S, T=T, live=lv,
                            model=MOE_ARCH)
               for T, lv in list(moe_extra) + mfixed],
           f"tree_verify/{MOE_ARCH}": [
               tree_kernels_time(torch, np, B=B, S=S, T=T, live=lv,
                                 model=MOE_ARCH)
               for T, lv in moe_tree_extra]}
    for name, rows in out.items():
        for tm in rows:
            log_verify_time(name, tm)
    # the route the table gives the engine's bf16 shapes: the tensor cores
    # at every width (one route per dtype and head dim, decode included)
    for name, rows in out.items():
        wrong = [(tm["T"], tm["route"]) for tm in rows
                 if tm["route"] != "tensor_cores"]
        check(not wrong, f"{name}: widths off the tensor cores {wrong}")
    return out


def _fa_inputs(torch, np, *, B, Tq, Tk, Hq, Hk, D, dtype, seed):
    """q, k, v, dO of K3 on the card, from a numpy seed."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to("cuda", dt)
    return (arr(B, Tq, Hq, D), arr(B, Tk, Hk, D), arr(B, Tk, Hk, D),
            arr(B, Tq, Hq, D))


def _flash_case(torch, q, k, v, do, *, q_offset, causal, window,
                scaled=False) -> dict:
    """One K3 case: the forward, dQ and dK/dV launched twice each on
    (q, k, v, do), held against the plain forward and backward at TOL
    (o, LSE, dq, dk, dv), rows that see nothing 0 with no gradient,
    repeat launches bitwise equal; with ``scaled`` (a non-causal forward
    over a long memory) the forward's output is also held to the f32
    plain version at the reference's scale (``scaled_check``).  Raises
    CheckFailed on any miss."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    B, Tq, Hq, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    dtype = str(q.dtype).removeprefix("torch.")
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    o, lse = ops.forward_kernel(q, k, v, **kw)
    o2, lse2 = ops.forward_kernel(q, k, v, **kw)
    g = ops.backward_kernels(q, k, v, o, lse, do, **kw)
    g2 = ops.backward_kernels(q, k, v, o, lse, do, **kw)
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
    g_ref = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    errs, ok = {}, True
    for name, a, b in (("o", o, o_ref), ("dq", g[0], g_ref[0]),
                       ("dk", g[1], g_ref[1]), ("dv", g[2], g_ref[2])):
        errs[name] = float((a.float() - b.float()).abs().max())
        ok = ok and torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
    seen = torch.isfinite(lse_ref)
    ok = ok and torch.equal(torch.isfinite(lse), seen) and \
        torch.allclose(lse[seen], lse_ref[seen], atol=tol, rtol=tol)
    blind = ~seen.transpose(1, 2)                          # (B, Tq, Hq)
    n_blind = int(blind.sum())
    empty = n_blind == 0 or (
        float(o[blind].float().abs().max()) == 0.0
        and float(g[0][blind].float().abs().max()) == 0.0)
    det = torch.equal(o, o2) and torch.equal(lse, lse2) and all(
        torch.equal(a, b) for a, b in zip(g, g2))
    route = ops.route(q.dtype, D)
    what = f"B={B} Tq={Tq} Tk={Tk} Hq={Hq} Hk={Hk} D={D} q_offset=" \
        f"{q_offset} causal={causal} window={window} {dtype} ({route})"
    log(f"  flash_attention {what}: max|err| " + ", ".join(
        f"{n} {e:.2e}" for n, e in errs.items()) + f" (tol {tol}); "
        f"{n_blind} blind rows 0: {empty}; repeat bit-equal: {det}")
    check(bool(ok), f"flash_attention disagrees with its plain version:"
          f" {what} {errs}")
    check(empty, f"flash_attention: a row that sees nothing is not 0 "
          f"({what})")
    check(det, f"flash_attention: repeat launch not bit-equal ({what})")
    row = {"B": B, "Tq": Tq, "Tk": Tk, "Hq": Hq, "Hk": Hk, "D": D,
           "q_offset": q_offset, "causal": causal, "window": window,
           "dtype": dtype, "route": route, "max_abs_err": max(errs.values()),
           "errs": errs, "tol": tol, "blind_rows": n_blind,
           "blind_rows_zero": empty, "deterministic": det}
    if scaled:
        assert not causal and q_offset == 0 and window == 0
        q32 = q.float()
        row["scaled_errs"] = scaled_check(
            torch, {"forward": o}, lambda k_, v_: flash_attention_fwd_ref(
                q32, k_, v_, causal=False)[0], k, v,
            f"flash_attention forward {what}")
    return row


def flash_kernels_check(torch, np) -> list:
    """K3's forward, dQ and dK/dV against the plain forward and backward
    on the card, on both routes of the library's (dtype, D) table: the
    tensor cores (bf16 at D 64 and 128) and the CUDA cores (f32, and bf16
    at D 32 and 256).  granite-3-8b head shapes (Hq 32, Hk 8, D 128) in
    bf16 and f32: causal, non-causal, window 256 and q_offset > 0, Tq !=
    Tk, a case whose later rows see no key; then at granite's and
    zamba2-1.2b's (Hq = Hk = 32, D 64) head shapes in bf16, lengths at the
    edges of the 64-row and 64-key tiles (Tq, Tk of 1, 63, 65, 129, 300),
    q_offset > 0 with window 256, rows that see nothing; f32 on a few of
    those; then D = 32, 64 and 256 on a small case; then phi4-mini-3.8b's
    (24/8, G = 3) and yi-6b's (32/4, G = 8) heads of 128; then
    whisper-tiny's encoder (``ENCODER_SHAPE``: B 8, 1500 frames, 6/6
    heads of 64, non-causal, bf16: a ragged last tile on both sides).
    Repeat launches bitwise equal, rows that see nothing 0 (LSE -inf, no
    gradient)."""
    rows = []
    # B, Tq, Tk, Hq, Hk, D, q_offset, causal, window
    shapes = [(2, 512, 512, 32, 8, 128, 0, True, 0),
              (2, 300, 300, 32, 8, 128, 0, False, 0),
              (2, 300, 300, 32, 8, 128, 0, True, 256),
              (2, 200, 700, 32, 8, 128, 500, True, 0),
              (1, 64, 100, 32, 8, 128, 200, True, 128)]
    cases = [c + (dt,) for c in shapes for dt in ("bfloat16", "float32")]
    # tile edges: (B, Tq, Tk, q_offset, causal, window) at both head shapes
    edges = [(1, 1, 1, 0, True, 0), (1, 63, 63, 0, True, 0),
             (1, 65, 65, 0, True, 0), (1, 129, 129, 0, False, 0),
             (1, 1, 129, 128, True, 0), (2, 65, 300, 235, True, 0),
             (1, 129, 63, 0, False, 0), (1, 129, 300, 171, True, 256),
             (1, 65, 100, 200, True, 128)]
    for Hq, Hk, D in ((32, 8, 128), (32, 32, 64)):
        cases += [(B, Tq, Tk, Hq, Hk, D, off, causal, win, "bfloat16")
                  for B, Tq, Tk, off, causal, win in edges]
    cases += [(B, Tq, Tk, 32, 8, 128, off, causal, win, "float32")
              for B, Tq, Tk, off, causal, win in (edges[1], edges[4],
                                                 edges[7])]
    cases += [(2, 100, 100, 8, 2, D, 0, True, w, dt) for D in (32, 64, 256)
              for dt, w in (("bfloat16", 0), ("float32", 64))]
    # phi4-mini-3.8b's G = 3 (the tensor cores' Gt = 1 packing) and yi-6b's
    # G = 8: the training shape, tile edges, a window and q_offset, f32
    for name in ("phi4-mini-3.8b", "yi-6b"):
        Hq, Hk, D, _ = K1_SHAPES[name]
        cases += [(2, 512, 512, Hq, Hk, D, 0, True, 0, "bfloat16"),
                  (2, 300, 300, Hq, Hk, D, 0, False, 0, "bfloat16")]
        cases += [(B, Tq, Tk, Hq, Hk, D, off, causal, win, "bfloat16")
                  for B, Tq, Tk, off, causal, win in (edges[2], edges[5],
                                                     edges[7], edges[8])]
        cases += [(1, 65, 300, Hq, Hk, D, 235, True, 0, "float32")]
    B, T, Hq, Hk, D = ENCODER_SHAPE
    cases.append((B, T, T, Hq, Hk, D, 0, False, 0, "bfloat16"))
    for B, Tq, Tk, Hq, Hk, D, off, causal, win, dtype in cases:
        q, k, v, do = _fa_inputs(torch, np, B=B, Tq=Tq, Tk=Tk, Hq=Hq, Hk=Hk,
                                 D=D, dtype=dtype, seed=Tq + Tk + D + win)
        rows.append(_flash_case(
            torch, q, k, v, do, q_offset=off, causal=causal, window=win,
            scaled=(B, Tq, Hq, Hk, D) == ENCODER_SHAPE and not causal))
    return rows


def _flash_ops(B, T, Hq, D, which, causal=True):
    """Operations of one K3 call at a square shape: T(T+1)/2 visible
    (query, key) pairs per query head when causal, T^2 when not, 2*D
    operations per pair and matrix product; forward: S, P V; dq: S, dP,
    dS K; dkdv: S, dP, P^T dO, dS^T Q."""
    n_mm = {"forward": 2, "dq": 3, "dkdv": 4}[which]
    pairs = T * (T + 1) // 2 if causal else T * T
    return n_mm * 2 * D * B * Hq * pairs


def _flash_bound_ms(B, T, Hq, Hk, D, dtype, which, causal=True):
    """Least time of one K3 call at a square shape (the causal training
    shape, the non-causal encoder): the bytes it must move (each input
    read once, each output written once) over the memory rate against
    its matrix products (``_flash_ops``) over the peak rate of its input
    type."""
    es = 2 if dtype == "bfloat16" else 4
    q_bytes, kv_bytes = B * T * Hq * D * es, B * T * Hk * D * es
    rows_f32 = B * Hq * T * 4
    nbytes = {"forward": 2 * q_bytes + 2 * kv_bytes + rows_f32,
              "dq": 3 * q_bytes + 2 * kv_bytes + 2 * rows_f32,
              "dkdv": 2 * q_bytes + 4 * kv_bytes + 2 * rows_f32}[which]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = _flash_ops(B, T, Hq, D, which, causal) / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def encoder_flash_time(torch, np, iters=50) -> dict:
    """K3's forward at whisper-tiny's encoder (``ENCODER_SHAPE``,
    non-causal, bf16: the only K3 call of the serving path), beside the
    plain forward, SDPA's forward (the yardstick) and the bound; held to
    the plain forward first (``_flash_case``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref
    B, T, Hq, Hk, D = ENCODER_SHAPE
    q, k, v, do = _fa_inputs(torch, np, B=B, Tq=T, Tk=T, Hq=Hq, Hk=Hk, D=D,
                             dtype="bfloat16", seed=9)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    n0 = dict(ops.launches)
    res = {"B": B, "T": T, "Hq": Hq, "Hk": Hk, "D": D, "causal": False,
           "dtype": "bfloat16", "route": ops.route(q.dtype, D),
           "check": _flash_case(torch, q, k, v, do, q_offset=0,
                                causal=False, window=0, scaled=True)}

    def fwd():
        return ops.forward_kernel(q, k, v, causal=False)
    t = _time_rounds(torch, fwd, iters, flush)
    res.update(ms=t["median"], ms_spread=t, host_us=_host_us(torch, fwd))
    ops.launches.update(n0)      # timing launches are not a slice's
    res["plain_ms"] = _time_ms(torch, lambda: flash_attention_fwd_ref(
        q, k, v, causal=False), 5, flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad():
        lt = _time_rounds(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt), iters, flush)
    res.update(library_ms=lt["median"], library_spread=lt)
    res["bound_ms"], res["bound_by"] = _flash_bound_ms(
        B, T, Hq, Hk, D, "bfloat16", "forward", causal=False)
    res["tflops"] = _flash_ops(B, T, Hq, D, "forward", False) / (
        res["ms"] * 1e9)
    res["max_abs_err"] = res["check"]["errs"]["o"]
    return res


def cross_kernels_time(torch, np, *, model, T, B=8, iters=50) -> dict:
    """K1 at ``model``'s cross block (``CROSS_SHAPES``) at width T, zero
    positions, bf16: its route and n_split, the other route (K3's
    non-causal forward over the same memory, which the port does not
    call there), K1's plain version, SDPA without a mask (the yardstick)
    and the bound; L2 flushed before each call.  Both kernels are held
    to the f32 plain version at the reference's scale first
    (``scaled_check``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_ref
    Hq, Hk, D, Tm = CROSS_SHAPES[model]
    dtype = "bfloat16"
    q, k, v, qp, kp = _cross_inputs(torch, np, B=B, T=T, Tm=Tm, Hq=Hq,
                                    Hk=Hk, D=D, dtype=dtype, seed=11 + T)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    n0, f0 = dict(ops.launches), dict(fa_ops.launches)
    ref = spec_verify_ref(q, k, v, qp, kp)
    out = ops.spec_verify(q, k, v, qp, kp)
    k3_out = fa_ops.forward_kernel(q, k, v, causal=False)[0]
    scaled = scaled_check(torch, {"K1": out, "K3": k3_out},
                          _cross_plain(torch, q, qp), k, v,
                          f"cross attention ({model}, T={T})")
    err = float((out.float() - ref.float()).abs().max())
    k3_err = float((k3_out.float() - ref.float()).abs().max())

    def k1():
        return ops.spec_verify(q, k, v, qp, kp)
    t = _time_rounds(torch, k1, iters, flush)
    k3 = _time_rounds(torch, lambda: fa_ops.forward_kernel(
        q, k, v, causal=False), iters, flush)
    host_us = _host_us(torch, k1)
    plain_ms = _time_ms(torch, lambda: spec_verify_ref(q, k, v, qp, kp),
                        max(iters // 5, 5), flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lt = _time_rounds(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True), iters, flush)
    ops.launches.update(n0)      # timing launches are not a slice's
    fa_ops.launches.update(f0)
    bound_ms, bound_by = _bound_ms(q, k, qp, kp, 0, dtype)
    route, n_split = ops.plan(q.dtype, B, T, Hq, Hk, D, Tm)
    return {"model": model, "T": T, "Tm": Tm, "Hq": Hq, "Hk": Hk, "D": D,
            "dtype": dtype, "route": route, "n_split": n_split,
            "ms": t["median"], "ms_spread": t, "host_us": host_us,
            "k3_ms": k3["median"], "k3_spread": k3, "k3_max_abs_err": k3_err,
            "plain_ms": plain_ms, "library_ms": lt["median"],
            "library_spread": lt, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "scaled_errs": scaled}


def flash_kernels_time(torch, np, *, B=32, T=512, Hq=32, Hk=8, D=128,
                       dtype="bfloat16", iters=50) -> dict:
    """K3's forward, dQ and dK/dV at a causal training shape (granite-3-8b's
    heads by default), beside the plain forward and backward, SDPA forward
    and backward (the yardstick, never called by the port) and each
    kernel's bound; medians of CUDA-event timed calls with L2 flushed
    before each.  Each entry's achieved TFLOP/s (``_flash_ops`` over its
    time) and its share of the bound (bound over time).  The timed inputs
    are first held against the plain versions (``_flash_case``): the
    shape the train step runs is the one checked."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    q, k, v, do = _fa_inputs(torch, np, B=B, Tq=T, Tk=T, Hq=Hq, Hk=Hk, D=D,
                             dtype=dtype, seed=5)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    n0 = dict(ops.launches)
    res = {"B": B, "T": T, "Hq": Hq, "Hk": Hk, "D": D, "dtype": dtype,
           "route": ops.route(q.dtype, D),
           "check": _flash_case(torch, q, k, v, do, q_offset=0, causal=True,
                                window=0)}
    o, lse = ops.forward_kernel(q, k, v)
    delta = ops.bwd_delta(o, do)
    res["forward_ms"] = _time_ms(torch, lambda: ops.forward_kernel(q, k, v),
                                 iters, flush)
    res["dq_ms"] = _time_ms(torch, lambda: ops.dq_kernel(
        q, k, v, do, lse, delta), iters, flush)
    res["dkdv_ms"] = _time_ms(torch, lambda: ops.dkdv_kernel(
        q, k, v, do, lse, delta), iters, flush)
    res["backward_ms"] = _time_ms(torch, lambda: ops.backward_kernels(
        q, k, v, o, lse, do), iters, flush)
    ops.launches.update(n0)      # timing launches are not a slice's
    res["plain_forward_ms"] = _time_ms(
        torch, lambda: flash_attention_fwd_ref(q, k, v), 5, flush)
    res["plain_backward_ms"] = _time_ms(
        torch, lambda: flash_attention_bwd_ref(q, k, v, o, lse, do), 5,
        flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    with torch.no_grad():
        res["library_forward_ms"] = _time_ms(torch, sdpa, iters, flush)
    out = sdpa()
    res["library_backward_ms"] = _time_ms(
        torch, lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True), iters, flush)
    res["library_fwd_bwd_ms"] = _time_ms(
        torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
        iters, flush)
    for which in ("forward", "dq", "dkdv"):
        res[f"{which}_bound_ms"], res[f"{which}_bound_by"] = \
            _flash_bound_ms(B, T, Hq, Hk, D, dtype, which)
        res[f"{which}_tflops"] = _flash_ops(B, T, Hq, D, which) / (
            res[f"{which}_ms"] * 1e9)
        res[f"{which}_bound_share"] = \
            res[f"{which}_bound_ms"] / res[f"{which}_ms"]
    return res


# kernel names in SASS: tc::flash_fwd_wgmma<128, ...> mangles to
# ...tc15flash_fwd_wgmmaILi128E, tc::verify_wgmma<64, true> to
# ...tc12verify_wgmmaILi64ELb1EE
FLASH_WGMMA = r"\d(flash_[a-z]+_wgmma)ILi(\d+)E"
VERIFY_WGMMA = r"\d(verify_wgmma)ILi(\d+)ELb([01])E"
# ssd_tensor_cores<64, 32> mangles to ...16ssd_tensor_coresILi64ELi32EE
SSD_MMA = r"\d(ssd_tensor_cores)ILi(\d+)ELi(\d+)E"


def hgmma_counts(lib_path, pattern, opcode="HGMMA") -> dict:
    """``opcode`` instructions (HGMMA: wgmma in SASS; HMMA: mma.sync) in
    each tensor-core kernel of a built library whose name matches
    ``pattern`` (the kernel's name, then its template arguments), from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(pattern, line)
        if "Function : " in line:
            cur = f"{m.group(1)}<{','.join(m.groups()[1:])}>" if m else None
            if cur:
                counts[cur] = 0
        elif cur and opcode in line:
            counts[cur] += 1
    return counts


# ---------------------------------------------------------------------------
# phase 4: the linear slice
# ---------------------------------------------------------------------------


def _tensors(tree) -> list:
    """The distinct tensors of a parameter tree (a block shared by several
    cells, like Zamba2's attention, once)."""
    seen = {}

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        else:
            seen[id(x)] = x
    walk(tree)
    return list(seen.values())


def build_model(torch, name: str = "granite-3-8b", layers: int = 0):
    """Full-width random weights of ``name`` from seed 0, at full depth or
    at ``layers`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n = sum(w.numel() for w in _tensors(params))
    what = f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}"
    if cfg.arch_type in ("ssm", "hybrid"):
        what = (f"Mamba2 d_inner {cfg.d_inner}, {cfg.ssm_nheads} SSD heads x "
                f"P {cfg.ssm_head_dim} x N {cfg.ssm_state}, G "
                f"{cfg.ssm_ngroups}")
        if cfg.arch_type == "hybrid":
            what += (f"; shared attention {cfg.num_heads}/{cfg.num_kv_heads} "
                     f"heads of {cfg.head_dim} every "
                     f"{cfg.hybrid_attn_every} blocks, d_ff {cfg.d_ff}")
    elif cfg.arch_type == "vlm":
        what += (f"; a cross block every {cfg.cross_attn_every} layers over "
                 f"{cfg.num_image_tokens} image tokens")
    elif cfg.arch_type == "audio":
        what += (f"; {cfg.encoder_layers} encoder layers over "
                 f"{cfg.num_audio_frames} frames, a cross block per decoder "
                 "layer")
    log(f"  {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {what}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; {n / 1e9:.3f} B params made "
        f"in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def modality_embeds(torch, np, cfg, batch: int, seed: int):
    """Seeded random image embeddings or audio frames (batch, Tm, d_model)
    in ``cfg.dtype`` on the card: the zero stub would make every cross
    K/V 0 and hide a wrong cross path."""
    from repro_torch.device import torch_dtype
    from repro_torch.models.transformer import cross_len
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((batch, cross_len(cfg), cfg.d_model),
                            dtype=np.float32)
    return torch.from_numpy(e).to("cuda", torch_dtype(cfg.dtype))


def make_prompts(np, cfg, n_groups: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(192, 384, size=n_groups)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
            for n in lens]


def make_rollout(cfg, params, cache_len=2048, device="cuda", **kw):
    from repro_torch.core import SeerRollout
    return SeerRollout(cfg, params, n_instances=2, max_slots=8,
                       cache_len=cache_len, chunk_size=CHUNK_SIZE,
                       policy="seer", spec_decode=True, device=device, **kw)


def _plain_calls() -> int:
    """Calls of the plain attention, SSD, product and row-reduction
    versions so far."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.row_gemm import ref as rg_ref
    from repro_torch.kernels.row_reduce import ref as rr_ref
    from repro_torch.kernels.spec_verify import ref as sv_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    return sum(sum(m.calls.values())
               for m in (sv_ref, ssd_ref, fa_ref, rg_ref, rr_ref))


def _counters():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.row_gemm import ops as rg_ops
    from repro_torch.kernels.row_reduce import ops as rr_ops
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return ops, ssd_ops, fa_ops, rg_ops, rr_ops


def _reset_launches() -> None:
    for mod in _counters():
        mod.reset_launches()


def _launches() -> dict:
    """Launches of K1, K2, K4, K3 (forward, dQ, dK/dV), the row-invariant
    product (row_gemm) and row reductions (rms_norm, logsumexp) so far."""
    out = {}
    for mod in _counters():
        out.update(mod.launches)
    return out


def run_rollout(torch, ro, prompts, group_size=GROUP_SIZE,
                new_tokens=NEW_TOKENS, temperature=1.0):
    """One ``ro.run`` over the slice's groups (sampled at
    ``temperature``), its launch counts set to 0
    just before and read just after; also its plain-version calls, its
    recurrent-state replays, its peak device memory, its KV blobs
    (slots exported and imported, bytes exported, host seconds spent
    moving them) and, of its K1 launches, those made inside cross blocks
    (``cross_launches``)."""
    from repro_torch.core import make_groups
    groups = make_groups(prompts, group_size=group_size,
                         max_new_tokens=new_tokens, seed=3,
                         temperature=temperature)
    st = ro.steps
    inv0, hs0, rp0 = st.invocations, st.host_syncs, st.replays
    by0 = dict(st.invocations_by_kind)
    nodes0 = [(i.tree_nodes, i.tree_branch_nodes) for i in ro.instances]
    blob_keys = ("slots_exported", "slots_imported", "migration_bytes_out",
                 "migration_host_seconds")
    blobs0 = {k_: sum(getattr(i, k_) for i in ro.instances)
              for k_ in blob_keys}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain0 = _plain_calls()
    _reset_launches()
    with _cross_launches() as cross:
        t0 = time.perf_counter()
        res = ro.run(groups)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"responses": res.responses(), "wall_s": wall,
            "logprobs": {r.req_id: list(r.logprobs) for g in res.groups
                         for r in g.requests},
            "launches": _launches(), "cross_launches": cross[0],
            "replays": st.replays - rp0,
            "plain_calls": _plain_calls() - plain0,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "fused_steps": st.invocations - inv0,
            "by_kind": {k_: n - by0.get(k_, 0) for k_, n in
                        st.invocations_by_kind.items()
                        if n - by0.get(k_, 0)},
            "host_syncs": st.host_syncs - hs0, "stats": res.stats,
            "tree_nodes": sum(i.tree_nodes - n[0] for i, n in
                              zip(ro.instances, nodes0)),
            "tree_branch_nodes": sum(i.tree_branch_nodes - n[1] for i, n in
                                     zip(ro.instances, nodes0)),
            "blobs": {k_: sum(getattr(i, k_) for i in ro.instances)
                      - blobs0[k_] for k_ in blob_keys},
            "finished": all(g.all_finished for g in res.groups)}


@contextlib.contextmanager
def _cross_launches():
    """Counts, in the list it yields, the K1 launches made inside
    ``transformer._cross_attn`` while the block runs (the wrapper's own
    count, read before and after each cross block)."""
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.models import transformer
    inner, n = transformer._cross_attn, [0]

    def counted(*a, **kw):
        n0 = ops.launches["spec_verify"]
        out = inner(*a, **kw)
        n[0] += ops.launches["spec_verify"] - n0
        return out
    transformer._cross_attn = counted
    try:
        yield n
    finally:
        transformer._cross_attn = inner


def sync_debug_steps(torch, np, cfg, params, n_steps: int = 8,
                     cache_len: int = 2048) -> dict:
    """Dispatch engine steps (prefill, decode and verify with drafts)
    under ``set_sync_debug_mode("error")``; commit outside it."""
    from repro_torch.engine import EngineSeq, Instance, StepFunctions
    steps = StepFunctions(cfg)
    inst = Instance(cfg, params, steps, max_slots=8, cache_len=cache_len,
                    device="cuda")
    rng = np.random.default_rng(11)
    for i in range(4):
        inst.admit(EngineSeq(f"s{i}", "g", rng.integers(
            0, cfg.vocab_size, size=40 + 30 * i).tolist(), seed=i,
            temperature=1.0, max_new_tokens=64))
    kinds, syncs = [], []
    for it in range(n_steps):
        drafts = {i: [inst.slots[i].last_token] * (8 if it % 2 else 2)
                  for i in inst.decode_slots()}
        s0 = steps.host_syncs
        ticket = _no_sync(torch, lambda: inst.dispatch_step(drafts))
        inst.commit_step(ticket)
        syncs.append(steps.host_syncs - s0)
        kinds.append(ticket.T if ticket is not None else 0)
    check(all(s == 1 for s in syncs), f"host syncs per step {syncs}")
    return {"step_T": kinds, "host_syncs_per_step": syncs}


# ---------------------------------------------------------------------------
# phase 5: the tree engine against its sync oracle
# ---------------------------------------------------------------------------


def _snapshot(inst):
    """A copy of ``inst`` that shares nothing the next step writes: the
    cache (scratch slots included), the seqs, the step counters."""
    import copy
    from repro_torch.engine import StepFunctions
    from repro_torch.models.transformer import clone_cache
    shadow = copy.copy(inst)
    shadow.cache = clone_cache(inst.cache)
    shadow.slots = [copy.deepcopy(x) for x in inst.slots]
    shadow.steps = StepFunctions(inst.cfg)
    return shadow


def tree_engine_check(torch, np, cfg, params, n_tokens: int = 24,
                      cache_len: int = 2048, embeds=None) -> dict:
    """One tree-mode instance driven with ``build_token_tree([bad,
    good])`` drafts (``good`` from a no-draft run of the same requests,
    ``bad`` that trunk perturbed).  Before each fused step the instance
    is snapshotted and the sync oracle's tree step runs on the snapshot
    with the same drafts; both must commit the same tokens and accept
    counts, leave the same ``slot_pos`` and bitwise equal K/V at every
    committed slot.  Each fused step dispatches under
    ``set_sync_debug_mode("error")``, costs one host sync and launches K2
    once per self-attention layer and K1 once per cross block (a VLM's or
    audio model's; none elsewhere).  A VLM or audio instance is built on
    ``embeds`` (its modality embeddings).  The launch counts are set to 0
    before the checked run and returned with it (fused steps and oracle
    steps), with the fused steps' widths."""
    from repro_torch.engine import (EngineSeq, Instance, StepFunctions,
                                    build_token_tree)
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.models.transformer import n_attn_layers, n_cross_layers
    V, L, L_cross = cfg.vocab_size, n_attn_layers(cfg), n_cross_layers(cfg)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, V, size=int(n)).tolist()
               for n in rng.integers(100, 300, size=8)]

    def new_instance():
        inst = Instance(cfg, params, StepFunctions(cfg), max_slots=8,
                        cache_len=cache_len, spec_mode="tree",
                        modality_embeds=embeds, device="cuda")
        seqs = [EngineSeq(f"t{i}", f"g{i}", p, seed=i, temperature=1.0,
                          max_new_tokens=n_tokens)
                for i, p in enumerate(prompts)]
        check([inst.admit(s) for s in seqs] == list(range(8)),
              "slots not admitted in order")
        return inst, seqs

    base, seqs = new_instance()
    while not all(s.finished for s in seqs):
        base.run_step()
    streams = [s.generated for s in seqs]
    del base

    inst, seqs = new_instance()
    steps = rescues = accepted = 0
    widths = {}
    _reset_launches()
    while not all(s.finished for s in seqs):
        drafts = {}
        for i, s in enumerate(seqs):
            good = streams[i][len(s.generated):len(s.generated) + 2]
            if s.finished or s.prefilling or not good:
                continue
            drafts[i] = build_token_tree([[(x + 7) % V for x in good],
                                          good])
        shadow = _snapshot(inst)
        want = shadow._run_step_sync_tree(drafts)
        n0, h0 = dict(ops.launches), inst.steps.host_syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            ticket = inst.dispatch_step(drafts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        k2 = ops.launches["tree_verify"] - n0["tree_verify"]
        k1 = ops.launches["spec_verify"] - n0["spec_verify"]
        got = inst.commit_step(ticket)
        steps += 1
        if ticket is not None:
            widths[ticket.T] = widths.get(ticket.T, 0) + 1
        check(inst.steps.host_syncs - h0 == 1,
              f"tree step {steps}: {inst.steps.host_syncs - h0} host syncs")
        check(k2 == L and k1 == L_cross,
              f"tree step {steps}: K2 launches {k2}, K1 launches {k1}")
        check({i: (t, a) for i, (t, _, a) in got.items()} ==
              {i: (t, a) for i, (t, _, a) in want.items()},
              f"tree step {steps}: fused {got} != sync oracle {want}")
        sp = inst.cache["slot_pos"]
        check(torch.equal(sp, shadow.cache["slot_pos"]),
              f"tree step {steps}: slot_pos differs from the oracle's")
        live = sp >= 0
        for name in ("k", "v"):
            check(torch.equal(inst.cache[name][:, live],
                              shadow.cache[name][:, live]),
                  f"tree step {steps}: {name} differs from the oracle's "
                  "at a committed slot")
        for i, (toks, _, a) in got.items():
            accepted += a
            if a and i in drafts and drafts[i].winner_rank(toks[:a]) == 1:
                rescues += 1
        del shadow
        check(steps < 200, "tree engine phase does not finish")
    return {"steps": steps, "accepted": accepted,
            "side_branch_steps": rescues, "tree_nodes": inst.tree_nodes,
            "tree_branch_nodes": inst.tree_branch_nodes,
            "tokens": sum(len(s.generated) for s in seqs),
            "launches": _launches(), "steps_by_T": widths,
            "live_mean": float(np.mean([len(p) + n_tokens // 2
                                        for p in prompts]))}


# ---------------------------------------------------------------------------
# phases 3 and 9-11: the SSD kernel (K4), the hybrid and SSM slices
# ---------------------------------------------------------------------------


def _ssd_inputs(torch, np, *, b, T, nh, P, G, N, dtype, seed, init,
                strided):
    """Inputs of K4 on the card from a numpy seed.  ``strided``: x, B and
    C are views into one (b, T, nh*P + 2*G*N) row, as ``mamba_block``
    hands them over.  The last row's dt is 0 throughout (an inactive
    slot: its state must come back unchanged)."""
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to("cuda", dt_)
    if strided:
        row = arr(b, T, nh * P + 2 * G * N)
        x = row[..., :nh * P].reshape(b, T, nh, P)
        Bm = row[..., nh * P:nh * P + G * N].reshape(b, T, G, N)
        Cm = row[..., nh * P + G * N:].reshape(b, T, G, N)
    else:
        x, Bm, Cm = arr(b, T, nh, P), arr(b, T, G, N), arr(b, T, G, N)
    dt = rng.uniform(0.01, 0.2, size=(b, T, nh)).astype(np.float32)
    if b > 1:
        dt[b - 1] = 0.0
    A = -rng.uniform(0.5, 1.5, size=(nh,)).astype(np.float32)
    S0 = rng.normal(size=(b, nh, P, N)).astype(np.float32) if init else None
    return (x, torch.from_numpy(dt).cuda(), torch.from_numpy(A).cuda(), Bm,
            Cm, None if S0 is None else torch.from_numpy(S0).cuda())


# (name, b, nh, P, G, N): the two models' SSD head shapes on 8 slots
SSD_MODEL_SHAPES = [("zamba2-1.2b", 8, 64, 64, 1, 64),
                    ("mamba2-370m", 8, 32, 64, 1, 128)]
# b, T, nh, P, G, N, chunk, with_init: tests/test_kernels.py's
# SSD_CASES, then the state widths N = 16 (the tiny configs' heads, and P
# 64, which the tensor cores take at N = 16) and N = 32 at widths the
# recurrent route takes, so that every kernel instance the table can
# reach is held to the plain version
SSD_TEST_CASES = [(2, 128, 4, 64, 1, 128, 64, False),
                  (1, 96, 8, 32, 2, 64, 32, True),
                  (2, 32, 2, 64, 1, 128, 128, True),
                  (1, 256, 4, 64, 4, 32, 64, False),
                  (2, 9, 8, 32, 1, 16, 256, True),
                  (2, 33, 8, 32, 1, 16, 256, True),
                  (2, 33, 4, 64, 1, 16, 256, True),
                  (2, 9, 4, 64, 2, 32, 256, True)]


def _ssd_run(ops, route, n_split, x, dt, A, Bm, Cm, S0, chunk,
             out_state=None):
    """K4 on ``route`` (None: the wrapper, i.e. the table) at ``n_split``
    (None: the table's)."""
    if route is None and n_split is None:
        return ops.ssd_chunk_scan(x, dt, A, Bm, Cm, S0, chunk,
                                  out_state=out_state)
    return ops.launch_on_route(route, x, dt, A, Bm, Cm, S0, chunk,
                               out_state=out_state, n_split=n_split)


def _ssd_route_case(torch, ops, route, args, chunk, b, want_kept):
    """One K4 case on one route at each n_split the route can take: the
    outputs at the table's n_split, and whether a repeat launch, every
    other n_split and the in-place update (``out_state = init_state``)
    gave the same bits, and whether the zero-dt row kept its state."""
    x, dt, A, Bm, Cm, S0 = args
    T, P, N = x.shape[1], x.shape[3], Bm.shape[3]
    _, n0 = ops.plan(x.dtype, b, T, x.shape[2], P, N, route)
    n_run = None if route is None else n0
    y, s = _ssd_run(ops, route, n_run, *args, chunk)
    y2, s2 = _ssd_run(ops, route, n_run, *args, chunk)
    det = torch.equal(y, y2) and torch.equal(s, s2)
    splits = [n0] if route is None else ops.split_options(route, x.dtype,
                                                          T, P, N)
    split_same = True
    for n in splits:
        if n != n0:
            yn, sn = _ssd_run(ops, route, n, *args, chunk)
            split_same = split_same and torch.equal(yn, y) and \
                torch.equal(sn, s)
    inplace = True
    if S0 is not None:
        s3 = S0.clone()
        y3, _ = _ssd_run(ops, route, n_run, x, dt, A, Bm, Cm, s3, chunk,
                         out_state=s3)
        inplace = torch.equal(s3, s) and torch.equal(y3, y)
    kept = b == 1 or torch.equal(s[b - 1], want_kept)
    return y, s, {"n_split": n0, "splits": splits, "deterministic": det,
                  "split_invariant": split_same, "in_place": inplace,
                  "zero_dt_row_kept": kept}


def ssd_kernels_check(torch, np) -> list:
    """K4 against its plain version on the card, each case on every route
    its shape can take (the wrapper's, from the library's table, then
    each other through ``ops.launch_on_route``: the recurrent route up to
    T = 64, the tensor cores for bf16, the CUDA cores always) and on
    each route at every n_split it can take: both models' head shapes on
    8 slots (x, B, C strided as the model passes them) at T = 1, 2, 9,
    33, 64, 65 (decode, the engine's verify and prefill widths) and 300
    (two chunks of 256, padded), with and without an initial state, then
    ``SSD_TEST_CASES`` (tests/test_kernels.py's, G = 2 and 4 among them,
    and N = 16 and 32 on every route that takes them); f32 at
    1e-4 and bf16 at 3e-2 (absolute and relative).  On each route: a
    repeat launch, every other n_split and the in-place update
    (out_state = init_state) bitwise the same, the zero-dt row's state
    unchanged bit for bit.  Across routes the results agree at the
    tolerance only (logged).  Then chunk independence: chunks of 64, 128
    and 256 over T = 300 agree at 2e-4 on every route."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    cases = [(name, b, T, nh, P, G, N, 256, init, dt, True)
             for name, b, nh, P, G, N in SSD_MODEL_SHAPES
             for T in (1, 2, 9, 33, 64, 65, 300) for init in (True, False)
             for dt in ("float32", "bfloat16")]
    cases += [("tests", b, T, nh, P, G, N, chunk, init, dt, False)
              for b, T, nh, P, G, N, chunk, init in SSD_TEST_CASES
              for dt in ("float32", "bfloat16")]
    rows = []
    for i, (name, b, T, nh, P, G, N, chunk, init, dtype, strided) in \
            enumerate(cases):
        args = _ssd_inputs(torch, np, b=b, T=T, nh=nh, P=P, G=G, N=N,
                           dtype=dtype, seed=i, init=init, strided=strided)
        x, dt, A, Bm, Cm, S0 = args
        yr, sr = ssd_ref(*args, chunk)
        kept_ref = S0[b - 1] if S0 is not None else torch.zeros_like(
            sr[b - 1])
        routes = ops.routes_of(x.dtype, T, P, N)
        table, _ = ops.plan(x.dtype, b, T, nh, P, N)
        yw, sw = ops.ssd_chunk_scan(*args, chunk)
        outs, facts = {}, {}
        for r in routes:
            y, s, f = _ssd_route_case(torch, ops, r, args, chunk, b,
                                      kept_ref)
            outs[r], facts[r] = (y, s), f
        torch.cuda.synchronize()
        tol = SSD_TOL[dtype]
        what = f"{name} b={b} T={T} nh={nh} P={P} G={G} N={N} chunk=" \
            f"{chunk} init={init} {dtype}"
        y0, s0 = outs[routes[0]]
        check(torch.equal(yw, y0) and torch.equal(sw, s0),
              f"ssd_scan: the wrapper and its route {table} differ ({what})")
        errs = {}
        for r, (y, s) in outs.items():
            errs[r] = max(float((y.float() - yr.float()).abs().max()),
                          float((s - sr).abs().max()))
            ok = torch.allclose(y.float(), yr.float(), atol=tol, rtol=tol) \
                and torch.allclose(s, sr, atol=tol, rtol=tol)
            f = facts[r]
            check(bool(ok), f"ssd_scan disagrees with its plain version on "
                  f"{r}: {what} max|err|={errs[r]}")
            check(f["deterministic"], f"ssd_scan: repeat launch on {r} not "
                  f"bit-equal ({what})")
            check(f["split_invariant"], f"ssd_scan: results on {r} depend "
                  f"on n_split {f['splits']} ({what})")
            check(f["zero_dt_row_kept"], f"ssd_scan: a zero-dt row's state "
                  f"changed on {r} ({what})")
            check(f["in_place"], f"ssd_scan: in-place state update differs "
                  f"on {r} ({what})")
        gap = max((max(float((y.float() - y0.float()).abs().max()),
                       float((s - s0).abs().max()))
                   for y, s in outs.values()), default=0.0)
        rows.append({"shape": name, "b": b, "T": T, "nh": nh, "P": P,
                     "G": G, "N": N, "chunk": chunk, "init": init,
                     "dtype": dtype, "strided": strided, "route": table,
                     "errs_by_route": errs,
                     "splits_by_route": {r: facts[r]["splits"]
                                         for r in facts},
                     "max_abs_err": max(errs.values()), "tol": tol,
                     "route_gap": gap, "deterministic": True,
                     "zero_dt_row_kept": True, "in_place": True,
                     "split_invariant": True})
        log(f"  ssd_scan {what}: route {table}; max|err| " + ", ".join(
            f"{r} {e:.3e} (n_split {facts[r]['splits']})"
            for r, e in errs.items()) + f" (tol {tol}); gap between routes "
            f"{gap:.3e}; on each route repeat, every n_split and in place "
            f"bit-equal, zero-dt row kept")
    args = _ssd_inputs(torch, np, b=2, T=300, nh=8, P=64, G=1, N=64,
                       dtype="float32", seed=99, init=True, strided=False)
    gap = 0.0
    for r in ops.routes_of(torch.float32, 300, 64, 64):
        outs = [_ssd_run(ops, r, None, *args, c) for c in (64, 128, 256)]
        gap = max([gap] + [max(float((y - outs[0][0]).abs().max()),
                               float((s - outs[0][1]).abs().max()))
                           for y, s in outs[1:]])
    log(f"  ssd_scan chunk independence (T=300, chunks 64/128/256, every "
        f"route): max gap {gap:.3e} (tol 2e-4)")
    check(gap <= 2e-4, f"ssd_scan: results depend on the chunk ({gap})")
    rows.append({"chunk_independence_gap": gap, "max_abs_err": 0.0})
    return rows


def _round_operand(torch, v, how):
    """An f32 operand as a tensor-core product would take it: rounded to
    bf16, to TF32 (10 mantissa bits, to nearest, as cvt.rna.tf32.f32), or
    split into a hi + lo pair of bf16 values."""
    if how == "bf16":
        return v.to(torch.bfloat16).float()
    if how == "tf32":
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


# the operand choices of the tensor-core route, and its own
SSD_OPERANDS = ("bf16", "tf32", "hi_lo")
SSD_TC_OPERANDS = "hi_lo"


def ssd_operand_errors(torch, np, widths=(9, 64)) -> list:
    """The error each operand choice of the tensor-core route would give:
    one chunk of K4's chunked form in plain PyTorch on the card, C B^T and
    the bf16 operands exact, f32 sums, the f32 operands W, B o w and S
    rounded per ``_round_operand``, held to ``ssd_ref`` at both models'
    head shapes (b 8, bf16, the timing inputs) at the 3e-2 tolerance:
    max |err| of y and of the state, and the worst err / (atol + rtol
    |ref|) (above 1 fails)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    rows = []
    for name, b, nh, P, G, N in SSD_MODEL_SHAPES:
        for T in widths:
            x, dt, A, Bm, Cm, S0 = _ssd_inputs(
                torch, np, b=b, T=T, nh=nh, P=P, G=G, N=N, dtype="bfloat16",
                seed=7, init=True, strided=True)
            yr, sr = ssd_ref(x, dt, A, Bm, Cm, S0, 256)
            xf = x.float().permute(0, 2, 1, 3)                 # (b,nh,T,P)
            Bh = Bm.float().repeat_interleave(nh // G, 2).permute(0, 2, 1, 3)
            Ch = Cm.float().repeat_interleave(nh // G, 2).permute(0, 2, 1, 3)
            dth = dt.permute(0, 2, 1)                           # (b,nh,T)
            cs = torch.cumsum(dth * A[None, :, None], dim=-1)
            causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                           device="cuda"))
            W = torch.where(causal, (Ch @ Bh.transpose(-1, -2))
                            * torch.exp(cs[..., :, None] - cs[..., None, :])
                            * dth[..., None, :], 0.0)
            wst = dth * torch.exp(cs[..., -1:] - cs)            # (b,nh,T)
            for how in SSD_OPERANDS:
                rnd = lambda v: _round_operand(torch, v, how)   # noqa: E731
                y = _round_operand(torch, W, how) @ xf + torch.exp(cs)[
                    ..., None] * (Ch @ rnd(S0).transpose(-1, -2))
                s = torch.exp(cs[..., -1])[..., None, None] * S0 + \
                    xf.transpose(-1, -2) @ rnd(Bh * wst[..., None])
                y = y.permute(0, 2, 1, 3).to(torch.bfloat16).float()
                errs = {}
                for k, got, want in (("y", y, yr.float()), ("state", s, sr)):
                    gap = (got - want).abs()
                    errs[k] = (float(gap.max()), float(
                        (gap / (3e-2 + 3e-2 * want.abs())).max()))
                rows.append({"model": name, "T": T, "operands": how,
                             "y_max_abs_err": errs["y"][0],
                             "state_max_abs_err": errs["state"][0],
                             "worst_share_of_tol": max(errs["y"][1],
                                                       errs["state"][1])})
                log(f"  ssd_scan operands {how} ({name} heads, T={T}): "
                    f"max|err| y {errs['y'][0]:.3e}, state "
                    f"{errs['state'][0]:.3e}; worst share of the 3e-2 "
                    f"tolerance {rows[-1]['worst_share_of_tol']:.3f}"
                    + (" (the route's)" if how == SSD_TC_OPERANDS else ""))
    return rows


def _ssd_bound_ms(b, T, nh, P, G, N, es, route, chunk=256):
    """Least time of one K4 call on ``route``: the state read once and
    written once, x, B, C, dt read and y written once, over the memory
    rate, against the operations this call needs (2 per multiply-add)
    over the rate of the units its route runs the products on (the bf16
    tensor cores on ``tensor_cores``, the f32 CUDA cores otherwise): C S^T
    and the state update for each head and token, W x over each head's
    causal pairs of a chunk, and C B^T over those pairs once per group
    (every head of a group shares it)."""
    state = 2 * b * nh * P * N * 4
    nbytes = state + b * T * (2 * nh * P * es + 2 * G * N * es + nh * 4)
    Q = min(chunk, T)
    full, rest = divmod(T, Q)
    pairs = full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2
    ops_ = 2 * (b * nh * (2 * T * P * N + pairs * P) + b * G * pairs * N)
    rate = PEAK_OPS["bfloat16" if route == "tensor_cores" else "float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_ / rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def _kernels_us(torch, fn, flush, match: str, calls: int = 10) -> dict:
    """The median device duration per call, in microseconds, of each
    kernel whose name holds ``match`` (keyed by the name after it, up to
    its template arguments) over ``calls`` calls of ``fn`` (each after
    ``flush``), from torch.profiler's kernel records in launch order; a
    kernel launched k times a call sums each call's k records, or, where
    the profiler lost a record, takes k times their mean."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush()
            fn()
        torch.cuda.synchronize()
    durs = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type.name == "CUDA" and match in e.name:
            key = e.name.split(match, 1)[1].split("<")[0].split("(")[0]
            durs.setdefault(key, []).append(e.time_range.elapsed_us())
    out = {}
    for key, d in durs.items():
        per = max(1, round(len(d) / calls))
        if len(d) == per * calls:
            d = sorted(sum(d[i:i + per]) for i in range(0, len(d), per))
            out[key] = d[len(d) // 2]
        else:
            out[key] = per * sum(d) / len(d)
    return out


def _ssd_timing_inputs(torch, np, *, b, nh, P, G, N, T):
    """The inputs of a timed K4 call (bf16 x, B, C strided as the model
    passes them, f32 dt and state) and an L2 flush."""
    args = _ssd_inputs(torch, np, b=b, T=T, nh=nh, P=P, G=G, N=N,
                       dtype="bfloat16", seed=7, init=True, strided=True)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    return args, scratch.zero_


def ssd_call_time(torch, np, *, b, nh, P, G, N, T, iters=50) -> dict:
    """K4 through its entry point ``ops.ssd_chunk_scan`` alone, whose
    signature every version of K4 keeps (so the same code times a parent
    tree's kernel), at one main-path call: bf16 x, B, C strided as the
    model passes them, f32 dt and state, the state updated in place, L2
    flushed before each call.  The timed window (``_time_rounds``), the
    kernel's own duration (``_kernels_us``; K4's kernels are all named
    ssd_*), the wrapper's host us per call, the plain version's time and
    the error against it."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    (x, dt, A, Bm, Cm, S0), flush = _ssd_timing_inputs(
        torch, np, b=b, nh=nh, P=P, G=G, N=N, T=T)
    n0 = dict(ops.launches)
    y, s = ops.ssd_chunk_scan(x, dt, A, Bm, Cm, S0, 256)
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, S0, 256)
    err = max(float((y.float() - yr.float()).abs().max()),
              float((s - sr).abs().max()))
    check(torch.allclose(y.float(), yr.float(), atol=3e-2, rtol=3e-2) and
          torch.allclose(s, sr, atol=3e-2, rtol=3e-2),
          f"ssd_scan (timing shape b={b} nh={nh} P={P} N={N}, T={T}) "
          f"max|err|={err}")
    state = S0.clone()

    def k4():
        return ops.ssd_chunk_scan(x, dt, A, Bm, Cm, state, 256,
                                  out_state=state)
    t = _time_rounds(torch, k4, iters, flush)
    kernel_us = sum(_kernels_us(torch, k4, flush, "ssd_", 30).values()) \
        or None
    host_us = _host_us(torch, k4)
    plain_ms = _time_ms(torch, lambda: ssd_ref(x, dt, A, Bm, Cm, state, 256),
                        max(iters // 5, 5), flush)
    ops.launches.update(n0)      # timing launches are not a slice's
    return {"b": b, "T": T, "nh": nh, "P": P, "N": N, "dtype": "bfloat16",
            "ms": t["median"], "ms_spread": t, "kernel_us": kernel_us,
            "host_us": host_us, "plain_ms": plain_ms, "library_ms": None,
            "max_abs_err": err}


def ssd_kernels_time(torch, np, *, name, b, nh, P, G, N, T, iters=50,
                     sweep=False) -> dict:
    """``ssd_call_time`` with the call's route and n_split from the
    library's table and the bound on that route's units; with ``sweep``
    also each route the shape can take at each n_split it can take (the
    measurement that fixes the library's table)."""
    from repro_torch.kernels.ssd_scan import ops
    tm = ssd_call_time(torch, np, b=b, nh=nh, P=P, G=G, N=N, T=T,
                       iters=iters)
    route, n_split = ops.plan(torch.bfloat16, b, T, nh, P, N)
    sweep_ms = {}
    n0 = dict(ops.launches)
    if sweep:
        (x, dt, A, Bm, Cm, state), flush = _ssd_timing_inputs(
            torch, np, b=b, nh=nh, P=P, G=G, N=N, T=T)
    for r in ops.routes_of(torch.bfloat16, T, P, N) if sweep else ():
        for n in ops.split_options(r, torch.bfloat16, T, P, N):
            sweep_ms[f"{r}/{n}"] = _time_rounds(
                torch, lambda: ops.launch_on_route(
                    r, x, dt, A, Bm, Cm, state, 256, out_state=state,
                    n_split=n), iters, flush)
    ops.launches.update(n0)
    bound_ms, bound_by = _ssd_bound_ms(b, T, nh, P, G, N, 2, route)
    return {"model": name, **tm, "route": route, "n_split": n_split,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / tm["ms"], "sweep_ms": sweep_ms}


# K4's backward: (name, nh, P, G, N, chunk, widths) of the tiny configs'
# heads, two groups of four heads (chunks of two blocks, so that the group
# logic meets off-diagonal tiles and slices of heads) and both models'
# heads, each at b 2 with T on the chunk, off it (a ragged last chunk) and
# one short chunk (Q = T); all but the tiny heads also at the shape the
# trainers give it (``ssd_bwd_train_shape``); each also under strong decay
# (``_ssd_bwd_inputs``) at its second width
SSD_BWD_SHAPES = [("tiny", 8, 32, 1, 16, 32, (64, 45)),
                  ("two groups", 8, 32, 2, 32, 128, (128, 300, 100)),
                  ("mamba2-370m", 32, 64, 1, 128, 256, (256, 300, 130)),
                  ("zamba2-1.2b", 64, 64, 1, 64, 256, (256, 300, 130))]
SSD_BWD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# the tensor-core route against the CUDA-core route on the same bf16
# inputs: hi + lo operands round to ~2^-16, so each gradient agrees to
# 2^-12 of its scale (dx beyond its own bf16 rounding); a route that fed
# only the hi halves would miss by ~2^-9
ROUTE_GAP_TOL = 2 ** -12
# dA under strong decay in f32: a sum of large terms of both signs, so
# that f32 plain versions in other orders land ~1e-4 of its scale apart
# (against the same computation in f64: ssd_bwd_ref up to 9.4e-5, the
# routes' decomposition 1.7e-4, at the models' heads), held at 1e-3;
# every other gradient, and dA elsewhere, at SSD_TOL
SSD_DA_STRONG_TOL = 1e-3


def ssd_bwd_train_shape() -> tuple:
    """(b, T) of the SSM and hybrid trainers' K4 backward calls: the
    training batch, 16 rows of 448 tokens (a chunk of 256 and a ragged
    one of 192)."""
    return ARCH_TRAIN_GROUPS * GROUP_SIZE, ARCH_TRAIN_PROMPT + ARCH_TRAIN_NEW


def _ssd_bwd_inputs(torch, np, *, b, T, nh, P, G, N, dtype, seed, init,
                    strong=False):
    """K4's inputs (``_ssd_inputs``: the last row's dt 0 throughout) with
    five more zero-dt steps inside row 0, and a seeded dy in x's dtype.
    ``strong``: dt in (1, 3) and A = -1, so that the decay summed over a
    block of 64 steps passes 64 (exp of it overflows f32 past ~88)."""
    x, dt, A, Bm, Cm, S0 = _ssd_inputs(torch, np, b=b, T=T, nh=nh, P=P,
                                       G=G, N=N, dtype=dtype, seed=seed,
                                       init=init, strided=False)
    if strong:
        rng = np.random.default_rng(seed + 2)
        dt = torch.from_numpy(rng.uniform(1.0, 3.0, size=(b, T, nh)).astype(
            np.float32)).cuda()
        if b > 1:
            dt[b - 1] = 0.0
        A = torch.full_like(A, -1.0)
    dt[0, T // 3:T // 3 + 5] = 0.0
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.normal(size=(b, T, nh, P)).astype(
        np.float32)).to("cuda", x.dtype)
    return x, dt, A, Bm, Cm, S0, dy


def _ssd_autograd(torch, x, dt, A, Bm, Cm, S0, chunk, dy):
    """The gradients by autograd through the plain forward ``ssd_ref``
    (f32), in ``SSD_BWD_GRADS`` order."""
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    ins = [t.detach().float().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    s0 = None if S0 is None else S0.detach().clone().requires_grad_()
    y, _ = ssd_ref(*ins, s0, chunk)
    grads = torch.autograd.grad((y * dy.float()).sum(),
                                ins + ([s0] if s0 is not None else []))
    return list(grads) + ([None] if s0 is None else [])


def _ssd_bwd_errs(torch, what, got, want) -> dict:
    """Each gradient's (rel rms, rel max) against the f32 plain version;
    None gradients where the plain version makes none; finite values."""
    errs = {}
    for g, a, w in zip(SSD_BWD_GRADS, got, want):
        check((a is None) == (w is None),
              f"{what}: {g} made where it should not be, or not made")
        if a is None:
            continue
        check(bool(torch.isfinite(a).all()), f"{what}: {g} not finite")
        errs[g] = _scaled_err(a, w)
    return errs


def _route_gaps(torch, got, base) -> dict:
    """Each gradient of one route against another route's on the same
    inputs, as a share of the latter's scale: max |a - b| / max |b|; a
    bf16 gradient (dx) counts each element's gap only beyond one bf16 step
    of its magnitude, since the routes may round one value to
    neighbours."""
    out = {}
    for g, a, b_ in zip(SSD_BWD_GRADS, got, base):
        if a is None:
            continue
        a, b_, bf16 = a.float(), b_.float(), a.dtype == torch.bfloat16
        gap = (a - b_).abs()
        if bf16:
            mag = torch.maximum(a.abs(), b_.abs()).clamp_min(1e-30)
            gap = (gap - torch.exp2(torch.floor(torch.log2(mag)) - 7)
                   ).clamp_min(0.0)
        out[g] = float(gap.max() / b_.abs().max().clamp_min(1e-30))
    return out


def ssd_bwd_check(torch, np) -> list:
    """K4's backward on the card at SSD_BWD_SHAPES' heads (b 2, and all
    but the tiny heads also at the trainers' b 16 x T 448), f32 and bf16,
    with and without an initial state, zero-dt steps and a zero-dt row,
    under Mamba2's usual decay and under strong decay, on every route the
    shape can take (``ops.launch_bwd_on_route``: the tensor cores for
    bf16, the CUDA cores for both dtypes): f32 held to its plain version
    ``ref.ssd_bwd_ref`` and to autograd through ``ssd_ref`` at 1e-4 of
    each gradient's scale (tests/test_kernels.py's SSD tolerance; dA
    under strong decay at ``SSD_DA_STRONG_TOL``); bf16 by
    ``scaled_check``'s measure against the f32 plain version on the same
    inputs, with two planted faults fed through the same route (the last
    step's dy dropped; the initial state, or else the chunk boundary's
    state, ignored) that must fail it, and the tensor-core route within
    ``ROUTE_GAP_TOL`` of the CUDA-core route on the same inputs; a
    repeated call bitwise equal; the entry point ``ops.ssd_scan_bwd``
    bitwise equal to the table's route."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref
    n0 = dict(ops.launches)
    rows, seed = [], 100
    for name, nh, P, G, N, chunk, widths in SSD_BWD_SHAPES:
        cases = [(2, T, False) for T in widths] + [(2, widths[1], True)]
        if name != "tiny":
            cases.append(ssd_bwd_train_shape() + (False,))
        for b, T, strong in cases:
            for dtype in ("float32", "bfloat16"):
                for init in (False, True):
                    seed += 1
                    args = _ssd_bwd_inputs(torch, np, b=b, T=T, nh=nh, P=P,
                                           G=G, N=N, dtype=dtype, seed=seed,
                                           init=init, strong=strong)
                    x, dt, A, Bm, Cm, S0, dy = args
                    f32 = [t.float() for t in (x, dt, A, Bm, Cm)]
                    want = ssd_bwd_ref(*f32, S0, chunk, dy.float())
                    auto = _ssd_autograd(torch, x, dt, A, Bm, Cm, S0, chunk,
                                         dy) if dtype == "float32" else None
                    routes = ops.bwd_routes_of(x.dtype, P, N, min(chunk, T))
                    entry = ops.ssd_scan_bwd(x, dt, A, Bm, Cm, S0, chunk, dy)
                    case = (f"ssd_scan_bwd {name} b={b} T={T} "
                            f"chunk={chunk} {dtype}"
                            f"{' init' if init else ''}"
                            f"{' strong decay' if strong else ''}")
                    by_route = {}
                    for route in routes:
                        what = f"{case} on {route}"
                        got = by_route[route] = ops.launch_bwd_on_route(
                            route, x, dt, A, Bm, Cm, S0, chunk, dy)
                        again = ops.launch_bwd_on_route(route, x, dt, A, Bm,
                                                        Cm, S0, chunk, dy)
                        torch.cuda.synchronize()
                        same = all(a is None and b_ is None
                                   or torch.equal(a, b_)
                                   for a, b_ in zip(got, again))
                        check(same, f"{what}: a repeated call differs")
                        if route == routes[0]:
                            check(all(a is None and e is None
                                      or torch.equal(a, e)
                                      for a, e in zip(got, entry)),
                                  f"{what}: ssd_scan_bwd differs from the "
                                  "table's route")
                        errs = _ssd_bwd_errs(torch, what, got, want)
                        row = {"shape": name, "b": b, "T": T, "chunk": chunk,
                               "dtype": dtype, "init": init,
                               "strong_decay": strong, "route": route,
                               "max_abs_err": max(
                                   float((a.float() - w).abs().max())
                                   for a, w in zip(got, want)
                                   if a is not None),
                               "errs": errs}
                        if dtype == "float32":
                            for g, a, w, v in zip(SSD_BWD_GRADS, got, want,
                                                  auto):
                                if a is None:
                                    continue
                                rel = errs[g][1]
                                rel_auto = float(
                                    (a - v).abs().max()
                                    / v.abs().max().clamp_min(1e-30))
                                tol = (SSD_DA_STRONG_TOL if strong and
                                       g == "dA" else SSD_TOL["float32"])
                                check(rel <= tol and rel_auto <= tol,
                                      f"{what}: {g} max|err|/max|ref| "
                                      f"{rel:.2e} against ssd_bwd_ref, "
                                      f"{rel_auto:.2e} against autograd "
                                      f"(limit {tol})")
                            row["autograd_ok"] = True
                        else:
                            for g, e in errs.items():
                                check(_scaled_ok(e), f"{what}: {g} off its "
                                      f"f32 plain version: {e[0]:.2e}/"
                                      f"{e[1]:.2e} (limits {REL_RMS_TOL}/"
                                      f"{REL_MAX_TOL:.2e})")
                            row["faults"] = _ssd_bwd_faults(
                                torch, ops, route, args, chunk, want, what)
                        rows.append(row)
                        log(f"  {what}: " + ", ".join(
                            f"{g} {a:.1e}/{b_:.1e}" for g, (a, b_) in
                            errs.items()) + " (rel rms/rel max against the "
                            "f32 plain version)" + (
                                "; faults fail: " + ", ".join(
                                    f"{k} (worst "
                                    f"{max(e[0] for e in v.values()):.1e})"
                                    for k, v in row["faults"].items())
                                if "faults" in row else
                                "; autograd through ssd_ref agrees"))
                    if dtype == "bfloat16":
                        gaps = _route_gaps(torch, by_route["tensor_cores"],
                                          by_route["cuda_cores"])
                        check(max(gaps.values()) <= ROUTE_GAP_TOL,
                              f"{case}: the tensor-core route off the "
                              "CUDA-core route: " + ", ".join(
                                  f"{g} {v:.2e}" for g, v in gaps.items())
                              + f" of scale (limit {ROUTE_GAP_TOL:.2e})")
                        rows[-1]["route_gap"] = gaps
                        log(f"  {case}: tensor cores against CUDA cores "
                            + ", ".join(f"{g} {v:.1e}"
                                        for g, v in gaps.items())
                            + " of scale")
    ops.launches.update(n0)      # check launches are not a path's
    return rows


def _ssd_bwd_faults(torch, ops, route, args, chunk, want, what) -> dict:
    """Two planted faults fed through ``route``: the last step's dy
    dropped; the initial state ignored, or else (T past one chunk) the
    first chunk's output state, by running the route on the tail alone.
    Each must fail the scaled check against the f32 plain version
    ``want``; returns each fault's errors."""
    x, dt, A, Bm, Cm, S0, dy = args
    T = x.shape[1]
    dy_cut = dy.clone()
    dy_cut[:, -1] = 0
    faults = {"last step's dy dropped": (ops.launch_bwd_on_route(
        route, x, dt, A, Bm, Cm, S0, chunk, dy_cut), want)}
    if S0 is not None:
        faults["initial state ignored"] = (ops.launch_bwd_on_route(
            route, x, dt, A, Bm, Cm, None, chunk, dy), want)
    elif T > chunk:
        tail = [t[:, chunk:] for t in (x, dt)] + [A] + \
            [t[:, chunk:] for t in (Bm, Cm)]
        faults["chunk boundary's state ignored"] = (
            ops.launch_bwd_on_route(route, *tail, None, chunk,
                                    dy[:, chunk:]),
            [w if w is None or w.dim() == 1 else w[:, chunk:]
             for w in want])
    out = {}
    for fname, (fgot, fwant) in faults.items():
        ferrs = {g: _scaled_err(f, w) for g, f, w in
                 zip(SSD_BWD_GRADS, fgot, fwant)
                 if f is not None and w is not None}
        out[fname] = ferrs
        check(not all(_scaled_ok(e) for e in ferrs.values()),
              f"{what}: the planted fault '{fname}' passes the scaled check")
    return out


def _ssd_bwd_bound_ms(b, T, nh, P, G, N, es, chunk=256, init=False):
    """Least time of one K4 backward call (no final state's gradient, as
    in training), its deciding unit and its byte time.  Bytes: x, dy, B,
    C, dt read once and dx, ddt, dB, dC (f32) written once, over the
    memory rate.  Operations (2 per multiply-add) that these inputs need,
    each product counted on the cheapest unit that meets its check: the
    bf16 tensor cores, an f32 operand as its hi/lo bf16 pair (two
    products), as the tensor-core route runs it.  Per causal pair of a
    chunk: C.B once per group (every head of a group shares it) and dy.x
    per head, of exact bf16 operands (1x); dx's term W.dy per head (P)
    and dB's and dC's terms (N each) once per group, the heads' f32
    weights summed first (2x); per head, token and state element (P N,
    an f32 state or weighted row: 2x) only where the chunk's boundary
    state or its gradient is nonzero: the chunk states (every chunk but
    the last: the last one's output is not used), r = dS.B (dx's boundary
    term) and dB's boundary term (every chunk but the last: its dS is 0),
    the reverse pass and dC's boundary term (every chunk but the first,
    whose input state is 0, unless ``init``)."""
    nbytes = b * T * (2 * nh * P * es + 2 * G * N * es + nh * 4) \
        + b * T * (nh * P * es + nh * 4 + 2 * G * N * 4) + nh * 8
    Q = min(chunk, T)
    full, rest = divmod(T, Q)
    pairs = full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2
    t_head = T - (rest or Q)          # tokens of every chunk but the last
    t_tail = T if init else T - Q     # ... but the first
    ops_bf16 = 2 * b * (pairs * (G * N + nh * P + 2 * (nh * P + 2 * G * N))
                        + 2 * nh * P * N * (3 * t_head + 2 * t_tail))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_bf16 / PEAK_OPS["bfloat16"]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations", 1e3 * t_bytes


def ssd_bwd_time(torch, np, *, name, b, nh, P, G, N, T, iters=20) -> dict:
    """K4's backward timed at a training call's shape (bf16 x, B, C, dy,
    f32 dt, no initial state, L2 flushed before each call; a training
    batch of b rows of T tokens) on the table's route and on the other
    route (``ops.launch_bwd_on_route``), each with its kernels' own
    durations from torch.profiler (``_kernels_us``), beside its plain
    version, its bound and its workspace; no single PyTorch call computes
    it (library: none).  Each route's gradients are first held to the f32
    plain version by ``scaled_check``'s measure."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref
    x, dt, A, Bm, Cm, _, dy = _ssd_bwd_inputs(
        torch, np, b=b, T=T, nh=nh, P=P, G=G, N=N, dtype="bfloat16",
        seed=11, init=False)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_
    n0 = dict(ops.launches)
    want = ssd_bwd_ref(*[t.float() for t in (x, dt, A, Bm, Cm)], None, 256,
                       dy.float())
    routes, err = {}, 0.0
    for route in ops.bwd_routes_of(x.dtype, P, N, min(256, T)):
        got = ops.launch_bwd_on_route(route, x, dt, A, Bm, Cm, None, 256, dy)
        for g, a, w in zip(SSD_BWD_GRADS, got, want):
            if a is not None:
                e = _scaled_err(a, w)
                check(_scaled_ok(e), f"ssd_scan_bwd timing ({name} heads) "
                      f"b={b} T={T} on {route}: {g} off its f32 plain "
                      f"version: {e[0]:.2e}/{e[1]:.2e} (limits "
                      f"{REL_RMS_TOL}/{REL_MAX_TOL:.2e})")
        if not routes:
            err = max(float((a.float() - w).abs().max())
                      for a, w in zip(got, want) if a is not None)

        def call(route=route):
            return ops.launch_bwd_on_route(route, x, dt, A, Bm, Cm, None,
                                           256, dy)
        t = _time_rounds(torch, call, iters, flush)
        routes[route] = {"ms": t["median"], "ms_spread": t,
                         "kernels_us": _kernels_us(torch, call, flush,
                                                   "ssd_bwd_")}
    plain_ms = _time_ms(torch, lambda: ssd_bwd_ref(
        x, dt, A, Bm, Cm, None, 256, dy), max(iters // 5, 3), flush)
    ops.launches.update(n0)
    bound_ms, bound_by, bytes_ms = _ssd_bwd_bound_ms(b, T, nh, P, G, N, 2)
    first = next(iter(routes))
    tm = routes[first]
    return {"model": name, "b": b, "T": T, "nh": nh, "P": P, "N": N,
            "dtype": "bfloat16", "route": first, "ms": tm["ms"],
            "ms_spread": tm["ms_spread"], "routes": routes,
            "scratch_bytes": 4 * ops.bwd_scratch_floats(b, T, nh, P, G, N,
                                                        256),
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes_bound_ms": bytes_ms,
            "bound_share": bound_ms / tm["ms"], "max_abs_err": err}


def ssd_bwd_time_table(torch, np) -> list:
    """``ssd_bwd_time`` at both SSM models' heads at the trainers' shape
    (``ssd_bwd_train_shape``), logged."""
    bwd_b, bwd_T = ssd_bwd_train_shape()
    out = []
    for name, _, nh, P, G, N in SSD_MODEL_SHAPES:
        tm = ssd_bwd_time(torch, np, name=name, b=bwd_b, nh=nh, P=P, G=G,
                          N=N, T=bwd_T)
        out.append(tm)
        log(f"  ssd_scan_bwd timing ({tm['model']} heads) b={tm['b']} "
            f"T={tm['T']} nh={tm['nh']} P={tm['P']} N={tm['N']} bf16, "
            f"route {tm['route']}: {_spread(tm['ms_spread'])} ms; plain "
            f"{tm['plain_ms']:.4f} ms; bound {tm['bound_ms']:.4f} ms "
            f"({tm['bound_by']}, {tm['bound_share']:.3f} of it; bytes alone "
            f"{tm['bytes_bound_ms']:.4f} ms); library: none; workspace "
            f"{tm['scratch_bytes'] / 1e6:.1f} MB")
        for route, r in tm["routes"].items():
            log(f"    {route}: {_spread(r['ms_spread'])} ms; kernels (us, "
                "profiler): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                          r["kernels_us"].items()))
    return out


# K4's fixed widths: decode, the warm passes' verify widths (T = 3, 5, 9),
# a verify width past 32 and the prefill chunk
SSD_WIDTHS = (1, 3, 5, 9, 33, 64)


def _us(t) -> str:
    return "not measured" if t is None else f"{t:.2f}"


def ssd_time_table(torch, np, extra=None, sweep=True) -> dict:
    """K4 timed at both models' head shapes (b 8, bf16, state in place)
    at the fixed widths and each model's ``extra`` widths (the slices'
    commonest), with route, n_split, time [min-max], the kernel's own
    duration, bound and its share, plain time and wrapper host us per
    call; ``sweep`` also times every route and n_split at the fixed
    widths."""
    out = {}
    for name, b, nh, P, G, N in SSD_MODEL_SHAPES:
        widths = list(dict.fromkeys(list((extra or {}).get(name, ()))
                                    + list(SSD_WIDTHS)))
        rows = out[name] = []
        for T in widths:
            tm = ssd_kernels_time(torch, np, name=name, b=b, nh=nh, P=P,
                                  G=G, N=N, T=T,
                                  sweep=sweep and T in SSD_WIDTHS)
            rows.append(tm)
            swept = "".join(f"; {k} {_spread(v)}"
                            for k, v in tm["sweep_ms"].items())
            log(f"  ssd_scan timing ({name} heads) b={b} T={T} nh={nh} "
                f"P={P} N={N} bf16, state in place, route {tm['route']} "
                f"(n_split {tm['n_split']}): {_spread(tm['ms_spread'])} ms, "
                f"kernel {_us(tm['kernel_us'])} us (profiler), host "
                f"{tm['host_us']:.1f} us/call; plain "
                f"{tm['plain_ms']:.4f} ms; bound {tm['bound_ms']:.4f} ms "
                f"({tm['bound_by']}, {tm['bound_share']:.3f} of it)"
                + swept)
    return out


def rec_rollout_checks(r, cfg, which: str) -> None:
    """A rollout of an SSM, hybrid, MoE, VLM or audio model went through
    its kernels: every group finished; per forward (replays included) one
    K4 launch per Mamba2 block and one K1 launch per attention layer (a
    hybrid's shared-attention applications) and per cross block (those
    counted inside the cross blocks), no K2, no K3 (the audio encoder ran
    when the instances were built); no plain attention or SSD call; at
    most one host sync per step."""
    from repro_torch.models.transformer import (n_attn_layers,
                                                n_cross_layers, n_ssm_layers)
    fw = r["fused_steps"] + r["replays"]
    L_ssm, L_cross = n_ssm_layers(cfg), n_cross_layers(cfg)
    L_attn = n_attn_layers(cfg) + L_cross
    n = r["launches"]
    check(r["finished"], f"{which}: not every group finished")
    check(L_ssm == 0 or n["ssd_scan"] > 0, f"{which}: K4 launched no time")
    check(n["ssd_scan"] == fw * L_ssm, f"{which}: K4 launches "
          f"{n['ssd_scan']} != ({r['fused_steps']} steps + {r['replays']} "
          f"replays) x {L_ssm}")
    check(n["spec_verify"] == fw * L_attn, f"{which}: K1 launches "
          f"{n['spec_verify']} != {fw} forwards x {L_attn}")
    check(L_attn == 0 or n["spec_verify"] > 0, f"{which}: K1 launched no "
          "time")
    check(r["cross_launches"] == fw * L_cross, f"{which}: K1 launches in "
          f"cross blocks {r['cross_launches']} != {fw} forwards x {L_cross}")
    check(n["tree_verify"] == 0, f"{which}: K2 launched")
    check(n["flash_attention"] == 0, f"{which}: K3 launched in the rollout")
    check(r["plain_calls"] == 0, f"{which}: {r['plain_calls']} plain "
          "attention / SSD calls on the card")
    check(r["host_syncs"] <= r["stats"].steps, f"{which}: host syncs "
          f"{r['host_syncs']} > steps {r['stats'].steps}")


def rec_slice(torch, np, cfg, params, *, groups, new_tokens, seed,
              cache_len=2048) -> dict:
    """The Seer rollout of an SSM, hybrid, MoE, VLM or audio model: a cold
    pass, its repeat (bit-identical responses and launch counts), and a
    warm pass on the repeat's rollout, whose group suffix trees hold the
    streams of the pass before (drafts accepted; on SSM and hybrid models
    replays with a partly accepted mask); each pass with
    ``rec_rollout_checks``.  The first pass's rollout is dropped before
    the second is built, so that one rollout's caches are on the card at
    a time.  Building a rollout of an audio model runs the encoder on
    each instance: K3 ``encoder_layers`` times an instance (its launches
    counted around each build)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    prompts = make_prompts(np, cfg, groups, seed=seed)
    runs, builds = [], []
    for i in range(2):
        if i:
            del ro
            gc.collect()
            torch.cuda.empty_cache()
        fa_ops.reset_launches()
        ro = make_rollout(cfg, params, cache_len=cache_len)
        builds.append(fa_ops.launches["flash_attention"])
        runs.append(run_rollout(torch, ro, prompts, new_tokens=new_tokens))
    want = len(ro.instances) * (cfg.encoder_layers
                                if cfg.arch_type == "audio" else 0)
    check(builds == [want] * 2, f"{cfg.name}: K3 launches per rollout "
          f"build {builds}, want {want}")
    ro.reset_acceptance_profile()
    warm = run_rollout(torch, ro, prompts, new_tokens=new_tokens)
    del ro
    gc.collect()
    torch.cuda.empty_cache()
    cold = runs[0]
    for which, r in (("cold pass", cold), ("repeat", runs[1]),
                     ("warm pass", warm)):
        rec_rollout_checks(r, cfg, f"{cfg.name} {which}")
    check(runs[1]["responses"] == cold["responses"],
          f"{cfg.name}: repeat rollout not bit-identical")
    check(runs[1]["launches"] == cold["launches"] and
          runs[1]["replays"] == cold["replays"],
          f"{cfg.name}: repeat rollout launched its kernels a different "
          "number of times")
    check(warm["stats"].accepted > 0, f"{cfg.name}: the warm pass accepted "
          "no draft")
    lens = [len(x) for x in cold["responses"].values()]
    check(all(n_ == new_tokens for n_ in lens),
          f"{cfg.name}: response lengths {sorted(set(lens))}")

    def rep(r):
        st = r["stats"]
        return {"tokens": st.tokens, "steps": st.steps,
                "fused_steps": r["fused_steps"], "replays": r["replays"],
                "chunks": st.chunks, "migrations": st.migrations,
                "drafted": st.drafted, "accepted": st.accepted,
                "mean_acceptance": st.mean_acceptance,
                "host_syncs": r["host_syncs"], "launches": r["launches"],
                "cross_launches": r["cross_launches"], "blobs": r["blobs"],
                "tokens_per_step": st.tokens / r["fused_steps"],
                "fused_by_T": r["by_kind"], "wall_s": r["wall_s"],
                "tokens_per_s": st.tokens / r["wall_s"],
                "peak_mem_gb": r["peak_mem_gb"]}
    out = {"requests": len(lens), "cold": rep(cold),
           "k3_per_build": builds[0],
           "repeat": rep(runs[1]),
           "repeat_wall_s": runs[1]["wall_s"],
           "repeat_tokens_per_s": runs[1]["stats"].tokens / runs[1]["wall_s"],
           "warm": rep(warm),
           "warm_same_responses": sum(warm["responses"][k] == v for k, v in
                                      cold["responses"].items())}
    for which in ("cold", "warm"):
        x = out[which]
        log(f"  {which} pass: tokens {x['tokens']}, engine steps "
            f"{x['fused_steps']} ({x['replays']} with a replay), chunks "
            f"{x['chunks']}, migrations {x['migrations']}, drafted "
            f"{x['drafted']}, accepted {x['accepted']}, tokens per step "
            f"{x['tokens_per_step']:.3f}; launches {x['launches']}, host "
            f"syncs {x['host_syncs']}; blobs {x['blobs']}; wall "
            f"{x['wall_s']:.3f} s, "
            f"{x['tokens_per_s']:.1f} tokens/s, peak {x['peak_mem_gb']:.1f} "
            f"GB; steps by T {x['fused_by_T']}")
    log(f"  repeat of the cold pass bit-identical (wall "
        f"{out['repeat_wall_s']:.3f} s, {out['repeat_tokens_per_s']:.1f} "
        f"tokens/s, peak {out['repeat']['peak_mem_gb']:.1f} GB); warm "
        f"responses equal to the cold pass "
        f"{out['warm_same_responses']}/{len(lens)}")
    return out


def blob_time(torch, cfg, params, n: int = 8, live: int = 512) -> dict:
    """Device time of one batched KV export of ``n`` slots (``live``
    positions each) and of its import, with the cross-attention memory
    the blobs carry and without it (the same call on the cache without
    ``cross_k`` / ``cross_v``): what a VLM's or audio model's memory adds
    to every migration."""
    from repro_torch.engine import Instance, StepFunctions
    inst = Instance(cfg, params, StepFunctions(cfg), max_slots=n,
                    cache_len=2048, device="cuda")
    export = inst.steps.export_batch((live,) * n)
    slots = torch.arange(n, device="cuda")
    bare = {k: v for k, v in inst.cache.items()
            if not k.startswith("cross_")}
    blobs = export(inst.cache, slots)
    out = {"slots": n, "live": live, "cross_bytes_per_slot": sum(
        inst.cache[k][:, 0].numel() * inst.cache[k].element_size()
        for k in ("cross_k", "cross_v"))}
    for name, cache in (("with_cross", inst.cache), ("without", bare)):
        out[f"export_{name}_ms"] = _time_ms(
            torch, lambda: export(cache, slots), 20)
        out[f"import_{name}_ms"] = _time_ms(
            torch, lambda: StepFunctions.import_batch(cache, slots, blobs),
            20)
    return out


def rec_engine_check(torch, np, cfg, params, n_tokens: int = 24,
                     embeds=None) -> dict:
    """One full-width instance of an SSM, hybrid or audio model driven
    with good drafts (from a draft-free run of the same requests) on even
    slots and bad ones (the good ones perturbed) on odd slots.  Once the
    prompts are prefilled, before each fused step the instance is
    snapshotted and the sync oracle (host acceptance; on a recurrent
    model the host-side restore and replay) runs on the snapshot with the
    same drafts: both commit the same tokens and accept counts and leave
    every cache leaf (``ssm``, ``conv``, K/V, ``slot_pos``, the
    cross-attention memory) bitwise equal.  Each fused step dispatches
    under ``set_sync_debug_mode("error")``, costs one host sync, replays
    on a recurrent model, and launches K4 once per block and K1 once per
    attention layer and cross block per forward.  An audio instance is
    built on ``embeds`` (its frames)."""
    from repro_torch.engine import EngineSeq, Instance, StepFunctions
    from repro_torch.models.transformer import (n_attn_layers,
                                                n_cross_layers, n_ssm_layers)
    V = cfg.vocab_size
    L_ssm = n_ssm_layers(cfg)
    L_attn = n_attn_layers(cfg) + n_cross_layers(cfg)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, V, size=int(n)).tolist()
               for n in rng.integers(100, 300, size=8)]

    def new_instance():
        inst = Instance(cfg, params, StepFunctions(cfg), max_slots=8,
                        cache_len=2048, modality_embeds=embeds,
                        device="cuda")
        seqs = [EngineSeq(f"h{i}", f"g{i}", p, seed=i, temperature=1.0,
                          max_new_tokens=n_tokens)
                for i, p in enumerate(prompts)]
        check([inst.admit(s) for s in seqs] == list(range(8)),
              "slots not admitted in order")
        return inst, seqs

    base, seqs = new_instance()
    while not all(s.finished for s in seqs):
        base.run_step()
    streams = [s.generated for s in seqs]
    del base

    inst, seqs = new_instance()
    while inst.prefilling_slots():
        inst.run_step()
    steps = accepted = rejected = 0
    while not all(s.finished for s in seqs):
        drafts = {}
        for i, s in enumerate(seqs):
            good = streams[i][len(s.generated):len(s.generated) + 3]
            if s.finished or not good:
                continue
            drafts[i] = good if i % 2 == 0 else [(x + 7) % V for x in good]
        shadow = _snapshot(inst)
        want = shadow._run_step_sync(drafts)
        n0, h0, r0 = _launches(), inst.steps.host_syncs, inst.steps.replays
        torch.cuda.set_sync_debug_mode("error")
        try:
            ticket = inst.dispatch_step(drafts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        n1 = _launches()
        rp = inst.steps.replays - r0
        got = inst.commit_step(ticket)
        steps += 1
        check(inst.steps.host_syncs - h0 == 1,
              f"{cfg.name} step {steps}: {inst.steps.host_syncs - h0} host "
              "syncs")
        check(rp == (1 if drafts and L_ssm else 0),
              f"{cfg.name} step {steps}: {rp} replays with drafts {drafts}")
        check(n1["ssd_scan"] - n0["ssd_scan"] == (1 + rp) * L_ssm and
              n1["spec_verify"] - n0["spec_verify"] == (1 + rp) * L_attn,
              f"{cfg.name} step {steps}: launches {n0} -> {n1}")
        check({i: (t, a) for i, (t, _, a) in got.items()} ==
              {i: (t, a) for i, (t, _, a) in want.items()},
              f"{cfg.name} step {steps}: fused {got} != sync oracle {want}")
        for k, t in inst.cache.items():
            check(torch.equal(t, shadow.cache[k]),
                  f"{cfg.name} step {steps}: cache leaf {k} differs from "
                  "the oracle's")
        for i, (_, _, a) in got.items():
            accepted += a
            rejected += a < len(drafts.get(i, []))
        del shadow
        check(steps < 200, f"{cfg.name} engine phase does not finish")
    check(accepted > 0 and rejected > 0, f"{cfg.name} engine phase: "
          f"accepted {accepted}, rejected rows {rejected}")
    return {"steps": steps, "accepted": accepted, "rejected_rows": rejected,
            "replays": inst.steps.replays,
            "tokens": sum(len(s.generated) for s in seqs)}


# ---------------------------------------------------------------------------
# phase 8: the GRPO trainer
# ---------------------------------------------------------------------------


def _digest(torch, tree) -> list:
    """Per-leaf fingerprints of a parameter tree that change with any bit:
    the int64 sums of each leaf's 32-bit words, plain and weighted by
    position (mod a prime), in the trainer's leaf order."""
    from repro_torch.training.optim import tree_items
    out = []
    for _, t in tree_items(tree):
        w = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        idx = torch.arange(w.numel(), device=w.device) % 1_000_003
        out.append(torch.stack([w.sum(), (w * idx).sum()]))
    return torch.stack(out).cpu().tolist()


def _plain_flash(torch):
    """An autograd Function that runs K3's plain forward and backward on
    the card: the oracle of the training phase, never on its path."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            o, lse = flash_attention_fwd_ref(q, k, v, causal=causal,
                                             window=window)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.kw = dict(causal=causal, window=window)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return (*flash_attention_bwd_ref(q, k, v, o, lse, do, **ctx.kw),
                    None, None)

    def attention(q, k, v, *, q_offset=0, causal=True, window=0):
        return PlainFlash.apply(q, k, v, causal, window)
    return attention


def _grad_norms(torch, cfg, trainer, batch):
    """Loss of ``grpo_loss`` on ``batch`` and the gradient's norm per JAX
    leaf and in all (the trainer's parameters, no update)."""
    from repro_torch.training.grpo import grpo_loss
    from repro_torch.training.optim import global_norm, jax_leaf, tree_items
    loss, _ = grpo_loss(cfg, trainer.params, batch, gcfg=trainer.gcfg)
    paths, leaves = zip(*tree_items(trainer.params))
    grads = torch.autograd.grad(loss, leaves)
    sq = {}
    for path, g in zip(paths, grads):
        key = "/".join(jax_leaf(path))
        sq[key] = sq.get(key, 0.0) + float(g.float().square().sum())
    total = float(global_norm(list(grads)))
    return float(loss.detach()), {k: v ** 0.5 for k, v in sq.items()}, total


def training_phase(torch, np, profile: bool = False) -> dict:
    """``RLTrainer`` at granite-3-8b's full width, TRAIN_LAYERS layers,
    f32 masters from seed 0 and bf16 activations: 2 sync iterations of a
    Seer rollout (copy task over the whole vocabulary, 8 groups x 4,
    prompts of 384 tokens, 128 new tokens at temperature 1, 2 instances x
    8 slots x 2048, chunk 32, linear speculation)
    and one train step on the (32, 512) batch, then the weight push.
    Checks: finite losses; the second rollout decodes under the pushed
    copy; per train step K3 launches 2 x layers forward (recompute) and
    layers of dQ and dK/dV, K1 none, no plain attention; K1 only in the
    rollouts, at most one host sync per engine step; the first train
    step repeated from the same state (masters re-made from the seed,
    zero moments) bitwise equal in loss and parameters; and K3 against
    the plain attention (forward and backward) on 4 of the batch's
    sequences, loss and gradient norms within the bf16 tolerance.  With
    ``profile``, one more train step under torch.profiler."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import make_task
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.spec_verify import ops as sv
    from repro_torch.models import attention as attn_mod
    from repro_torch.training.loop import RLConfig, RLTrainer
    from repro_torch.training.optim import tree_items

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=TRAIN_LAYERS)
    L = cfg.num_layers
    # prompt bodies from the whole vocabulary: a random policy's response
    # then holds about one token of its prompt in 128, so the copy task's
    # in-prompt term gives rewards that differ within a group (nonzero
    # advantages, a real gradient); over 8 content tokens every reward
    # would be 0
    task = make_task("copy", cfg.vocab_size, prompt_len=TRAIN_PROMPT - 1,
                     response_len=NEW_TOKENS, content_vocab=0)
    rl = RLConfig(n_groups=GROUPS, group_size=GROUP_SIZE,
                  max_new_tokens=NEW_TOKENS, temperature=1.0, iterations=2,
                  train_steps_per_iter=1, seed=0, n_instances=2,
                  max_slots=8, cache_len=2048, chunk_size=CHUNK_SIZE,
                  spec_decode=True, device="cuda", log=log)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = RLTrainer(cfg, task, rl)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(tr.params))
    log(f"  trainer: granite-3-8b width, {L} layers, {n_params / 1e9:.3f} B "
        f"f32 master params + AdamW moments + bf16 serving copy, made in "
        f"{time.perf_counter() - t0:.1f} s")

    rollouts = []
    train_step, roll_run = tr.train_step, tr.rollout.run
    rec = _StepRecorder(torch, train_step)

    def counted_rollout(groups):
        st = tr.rollout.steps
        n_fa, n_sv = dict(fa.launches), sv.launches["spec_verify"]
        inv0, hs0 = st.invocations, st.host_syncs
        pushed = tr.updater.params is not None and all(
            inst.params is tr.updater.params for inst in tr.rollout.instances)
        res = roll_run(groups)
        rollouts.append({
            "fused_steps": st.invocations - inv0,
            "host_syncs": st.host_syncs - hs0, "steps": res.stats.steps,
            "tokens": res.stats.tokens, "migrations": res.stats.migrations,
            "k1": sv.launches["spec_verify"] - n_sv,
            "k3": sum(fa.launches[k] - n_fa[k] for k in n_fa),
            "on_pushed_copy": pushed, "version": tr.updater.version,
            "finished": all(g.all_finished for g in res.groups)})
        return res

    tr.train_step, tr.rollout.run = rec, counted_rollout
    fa.reset_launches()
    sv.reset_launches()
    plain0 = sum(fa_ref.calls.values())
    t0 = time.perf_counter()
    hist = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    plain_calls = sum(fa_ref.calls.values()) - plain0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tr.train_step, tr.rollout.run = train_step, roll_run

    check(len(hist) == 2 and all(np.isfinite(h.loss) for h in hist),
          f"training losses {[h.loss for h in hist]}")
    adv = rec.first["batch"]["advantages"]
    check(bool((adv != 0).any()) and all(
        h.metrics["grad_norm"] > 0 for h in hist),
          "zero advantages or a zero gradient: the train steps test nothing")
    check(plain_calls == 0, f"{plain_calls} plain attention calls on the "
          "card")
    want = _train_step_want(cfg)
    for i, st in enumerate(rec.steps):
        got = {k: st[k] for k in want}
        check(got == want, f"train step {i}: launches {got}, want {want}")
    for i, ro in enumerate(rollouts):
        check(ro["finished"], f"rollout {i}: not every group finished")
        check(ro["k3"] == 0, f"rollout {i} launched K3 {ro['k3']} times")
        check(ro["k1"] == ro["fused_steps"] * L,
              f"rollout {i}: K1 launches {ro['k1']} != {ro['fused_steps']} "
              f"steps x {L}")
        check(ro["host_syncs"] <= ro["steps"],
              f"rollout {i}: host syncs {ro['host_syncs']} > steps "
              f"{ro['steps']}")
    check(not rollouts[0]["on_pushed_copy"] and rollouts[1]["on_pushed_copy"]
          and rollouts[1]["version"] == 1,
          "the second rollout did not run on the pushed weights")
    wq = tr.params["layers"][0]["attn"]["wq"]
    check(torch.equal(tr.updater.params["layers"][0]["attn"]["wq"],
                      wq.detach().to(torch.bfloat16)),
          "the pushed copy is not the masters cast to bf16")

    # the first train step again, from the same state: masters re-made
    # from the seed, zero moments, the same batch
    log("  repeat of the first train step from the same state")
    repeat_equal = _repeat_first_step(torch, cfg, rec, tr.params,
                                      tr.opt_state, seed=rl.seed)
    check(repeat_equal, "repeated train step not bitwise equal")

    # K3 against the plain attention, forward and backward, on 4 of the
    # batch's sequences
    log("  K3 against the plain attention on 4 sequences of the batch")
    sub = {k: v[:4] for k, v in rec.first["batch"].items()}
    torch.use_deterministic_algorithms(True)
    try:
        loss_k3, norms_k3, total_k3 = _grad_norms(torch, cfg, tr, sub)
        calls0 = sum(fa_ref.calls.values())
        kernel = attn_mod.flash_attention
        attn_mod.flash_attention = _plain_flash(torch)
        try:
            loss_pl, norms_pl, total_pl = _grad_norms(torch, cfg, tr, sub)
        finally:
            attn_mod.flash_attention = kernel
    finally:
        torch.use_deterministic_algorithms(False)
    check(sum(fa_ref.calls.values()) - calls0 == 3 * L,
          "the oracle did not run the plain attention")
    tol = TOL["bfloat16"]
    worst = max(abs(norms_k3[k] - norms_pl[k]) / max(norms_pl[k], 1e-30)
                for k in norms_pl)
    oracle_ok = abs(loss_k3 - loss_pl) <= tol * max(abs(loss_pl), 1.0) \
        and abs(total_k3 - total_pl) <= tol * total_pl and worst <= tol
    check(oracle_ok, f"K3 train step against plain attention: loss "
          f"{loss_k3} vs {loss_pl}, grad norm {total_k3} vs {total_pl}, "
          f"worst leaf-norm gap {worst:.3e}")
    prof_rep = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            train_step(tr.params, tr.opt_state, rec.first["batch"])
            torch.cuda.synchronize()
            t_step = time.perf_counter() - t1
        prof_rep = _profile_summary(prof, t_step)
    return {
        "profile": prof_rep,
        "layers": L, "params": n_params, "wall_s": wall,
        "peak_mem_gb": peak_gb, "launches": launches,
        "plain_calls": plain_calls, "train_steps": rec.steps,
        "rollouts": rollouts,
        "iterations": [{"loss": h.loss, "reward": h.mean_reward,
                        "rollout_s": h.rollout_seconds,
                        "train_s": h.train_seconds,
                        "push_s": h.weight_update_seconds,
                        "iteration_s": h.rollout_seconds + h.train_seconds
                        + h.weight_update_seconds,
                        "tokens": h.tokens, "grad_norm":
                        h.metrics["grad_norm"]} for h in hist],
        "repeat_bitwise": repeat_equal,
        "oracle": {"loss_k3": loss_k3, "loss_plain": loss_pl,
                   "grad_norm_k3": total_k3, "grad_norm_plain": total_pl,
                   "worst_leaf_norm_rel_gap": worst}}


def _step_counts() -> dict:
    """Launches of every kernel and calls of every plain version so far."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.spec_verify import ref as sv_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    out = _launches()
    out["plain_calls"] = sum(sv_ref.calls.values()) + sum(
        ssd_ref.calls.values()) + sum(fa_ref.calls.values())
    return out


def _attn_ssm_layers(cfg) -> tuple:
    """(attention applications, Mamba2 blocks) of one cache-free forward:
    self-attention layers, a hybrid's shared attention once per cell, a
    VLM's cross blocks, an audio model's encoder layers and its decoder's
    self and cross blocks."""
    L = cfg.num_layers
    if cfg.arch_type == "ssm":
        return 0, L
    if cfg.arch_type == "hybrid":
        return L // cfg.hybrid_attn_every, L
    if cfg.arch_type == "vlm":
        return L + L // cfg.cross_attn_every, 0
    if cfg.arch_type == "audio":
        return cfg.encoder_layers + 2 * L, 0
    return L, 0


def _train_step_want(cfg) -> dict:
    """Launches of one train step (forward, recomputed forward, backward):
    K3's forward twice per attention application and one dQ and one
    dK/dV; K4's forward twice per Mamba2 block and one backward; no K1
    or K2 and no plain version."""
    n_attn, n_ssm = _attn_ssm_layers(cfg)
    return {"flash_attention": 2 * n_attn, "flash_attention_dq": n_attn,
            "flash_attention_dkdv": n_attn, "ssd_scan": 2 * n_ssm,
            "ssd_scan_bwd": n_ssm, "spec_verify": 0, "tree_verify": 0,
            "plain_calls": 0}


class _StepRecorder:
    """Wraps a train step: each call under deterministic algorithms, its
    launch and plain-call counts, loss and the first call's batch, loss
    and parameter digest (the repeat's bar)."""

    def __init__(self, torch, step):
        self.torch, self.step = torch, step
        self.steps, self.first = [], {}

    def __call__(self, params, opt_state, batch):
        torch = self.torch
        n0 = _step_counts()
        torch.use_deterministic_algorithms(True)
        try:
            out = self.step(params, opt_state, batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        n1 = _step_counts()
        rec = {k: n1[k] - n0.get(k, 0) for k in n1}
        rec["loss"] = float(out[2])
        rec["metrics"] = {k: float(v) for k, v in out[3].items()}
        self.steps.append(rec)
        if not self.first:
            self.first.update(batch=batch, loss=out[2].clone(),
                              digest=_digest(torch, params))
        return out


def _repeat_first_step(torch, cfg, rec, params, opt_state, seed=0) -> bool:
    """The first recorded train step again from the same state: masters
    re-made from ``seed``, zero moments and step, the same batch; True
    when its loss and parameters equal the first's bitwise."""
    from repro_torch.models import init_params
    from repro_torch.training.optim import tree_items
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fresh = init_params(cfg, gen, device="cuda", dtype="float32")
    with torch.no_grad():
        for (_, a), (_, b) in zip(tree_items(params), tree_items(fresh)):
            a.copy_(b)
        for tree in (opt_state.mu, opt_state.nu):
            for _, t in tree_items(tree):
                t.zero_()
        opt_state.step.zero_()
    del fresh
    torch.use_deterministic_algorithms(True)
    try:
        _, _, loss, _ = rec.step(params, opt_state, rec.first["batch"])
        digest = _digest(torch, params)
    finally:
        torch.use_deterministic_algorithms(False)
    return bool(torch.equal(loss, rec.first["loss"])) and \
        digest == rec.first["digest"]


def _train_checks(torch, np, cfg, name, rec, grad_norms, repeat_equal):
    """The gates every new arch's training shares: finite losses, each
    train step's launches as ``_train_step_want``, a nonzero gradient in
    every parameter leaf, a MoE model's aux loss finite and nonzero, the
    repeat of the first train step bitwise equal."""
    want = _train_step_want(cfg)
    for i, st in enumerate(rec.steps):
        check(np.isfinite(st["loss"]), f"{name}: train step {i} loss "
              f"{st['loss']}")
        got = {k: st.get(k, 0) for k in want}
        check(got == want, f"{name}: train step {i} launches {got}, want "
              f"{want}")
        if cfg.num_experts:
            aux = st["metrics"]["aux_loss"]
            check(np.isfinite(aux) and aux > 0, f"{name}: aux loss {aux}")
    zero = [k for k, v in grad_norms.items() if not v > 0]
    check(not zero, f"{name}: zero gradient in {zero}")
    check(repeat_equal, f"{name}: the repeated first train step is not "
          "bitwise equal")


# the new archs' trainers: the training phase's prompts (BOS + 383
# copy-task tokens over the whole vocabulary, so that a random policy's
# rewards differ within a group), 64 new tokens, 4 groups of 4 (a
# training batch of 16 x 448 tokens: two SSD chunks at the models' chunk
# of 256, the second ragged); moonshot's vocabulary of 163,840 makes an
# in-prompt hit rarer, so it decodes 128 tokens (16 x 512)
ARCH_TRAIN_PROMPT, ARCH_TRAIN_NEW, ARCH_TRAIN_GROUPS = TRAIN_PROMPT, 64, 4
ARCH_NEW_TOKENS = {MOE_ARCH: 128}
# the VLM / audio train step's batch: 8 sequences of 128 tokens
MODAL_TRAIN_BATCH = 8
# depth of the new archs' training phases where their training state does
# not fit (or the script's time would not): moonshot-v1-16b-a3b at the
# depth whose f32 masters, gradients and AdamW moments (16 bytes a
# parameter) are no larger than the granite training phase's
# (``moe_train_layers``), llama-3.2-vision-11b at one cell (5 self layers
# and its cross block); mamba2-370m, zamba2-1.2b and whisper-tiny whole
TRAIN_CUT = {VLM_ARCH: 5}


def moe_train_layers(arch=MOE_ARCH) -> int:
    """The deepest cut of ``arch`` whose parameters are no more than the
    granite training phase's (granite-3-8b at TRAIN_LAYERS)."""
    import dataclasses
    from repro_torch.configs import get_config
    budget = dataclasses.replace(get_config("granite-3-8b"),
                                 num_layers=TRAIN_LAYERS).num_params()
    cfg = get_config(arch)
    L = 1
    while L < cfg.num_layers and dataclasses.replace(
            cfg, num_layers=L + 1).num_params() <= budget:
        L += 1
    return L


def _arch_cfg(arch, layers=0):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def rl_training_phase(torch, np, arch, layers=0) -> dict:
    """One sync ``RLTrainer`` iteration of ``arch`` at full width (at
    ``layers`` layers when given), f32 masters from seed 0, bf16
    activations: a Seer rollout of ARCH_TRAIN_GROUPS x 4 requests (copy
    task over the whole vocabulary, prompts of ARCH_TRAIN_PROMPT, 64 new
    tokens, moonshot 128, 2 instances x 8 slots of 512, chunk 32, linear
    speculation), a
    GRPO train step, the weight push.  Checks (``_train_checks``): the
    train step's launches (K3 and K4 forward twice per layer, one dQ,
    dK/dV and K4 backward per layer, no K1/K2, no plain version), a
    nonzero gradient in every parameter leaf, a MoE model's aux loss,
    the first train step repeated bitwise; the rollout: every group
    finished, no K3 or K4 backward, K1 once per attention layer per fused
    step, at most one host sync per engine step."""
    from repro_torch.data.tasks import make_task
    from repro_torch.training.loop import RLConfig, RLTrainer
    from repro_torch.training.optim import tree_items
    cfg = _arch_cfg(arch, layers)
    new_tokens = ARCH_NEW_TOKENS.get(arch, ARCH_TRAIN_NEW)
    task = make_task("copy", cfg.vocab_size,
                     prompt_len=ARCH_TRAIN_PROMPT - 1,
                     response_len=new_tokens, content_vocab=0)
    rl = RLConfig(n_groups=ARCH_TRAIN_GROUPS,
                  group_size=GROUP_SIZE, max_new_tokens=new_tokens,
                  temperature=1.0, iterations=1, train_steps_per_iter=1,
                  seed=0, n_instances=2, max_slots=8, cache_len=512,
                  chunk_size=CHUNK_SIZE, spec_decode=True, device="cuda",
                  log=log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = RLTrainer(cfg, task, rl)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(tr.params))
    log(f"  trainer: {arch} at full width, {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B f32 master params + AdamW moments + bf16 "
        f"serving copy, made in {time.perf_counter() - t0:.1f} s")
    rec = _StepRecorder(torch, tr.train_step)
    rollouts, roll_run = [], tr.rollout.run

    def counted_rollout(groups):
        st = tr.rollout.steps
        inv0, hs0, rp0 = st.invocations, st.host_syncs, st.replays
        n0 = _step_counts()
        res = roll_run(groups)
        n1 = _step_counts()
        rollouts.append({"fused_steps": st.invocations - inv0,
                         "replays": st.replays - rp0,
                         "host_syncs": st.host_syncs - hs0,
                         "steps": res.stats.steps, "tokens": res.stats.tokens,
                         "launches": {k: n1[k] - n0.get(k, 0) for k in n1},
                         "finished": all(g.all_finished
                                         for g in res.groups)})
        return res
    tr.train_step, tr.rollout.run = rec, counted_rollout
    t0 = time.perf_counter()
    hist = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tr.train_step, tr.rollout.run = rec.step, roll_run
    n_attn, n_ssm = _attn_ssm_layers(cfg)
    for i, ro in enumerate(rollouts):
        n = ro["launches"]
        fw = ro["fused_steps"] + ro["replays"]
        check(ro["finished"], f"{arch} rollout {i}: not every group "
              "finished")
        check(n["flash_attention"] + n["flash_attention_dq"]
              + n["flash_attention_dkdv"] + n["ssd_scan_bwd"]
              + n["tree_verify"] == 0,
              f"{arch} rollout {i}: a training kernel or K2 launched ({n})")
        check(n["spec_verify"] == fw * n_attn and
              n["ssd_scan"] == fw * n_ssm,
              f"{arch} rollout {i}: K1 {n['spec_verify']}, K4 "
              f"{n['ssd_scan']}; want ({ro['fused_steps']} steps + "
              f"{ro['replays']} replays) x {n_attn} and x {n_ssm}")
        check(n["plain_calls"] == 0, f"{arch} rollout {i}: plain calls")
        check(ro["host_syncs"] <= ro["steps"], f"{arch} rollout {i}: host "
              f"syncs {ro['host_syncs']} > steps {ro['steps']}")
    adv = rec.first["batch"]["advantages"]
    check(bool((adv != 0).any()), f"{arch}: zero advantages: the train "
          "step tests nothing")
    _, norms, total = _grad_norms(torch, cfg, tr, rec.first["batch"])
    repeat_equal = _repeat_first_step(torch, cfg, rec, tr.params,
                                      tr.opt_state)
    _train_checks(torch, np, cfg, arch, rec, norms, repeat_equal)
    out = {"arch": arch, "layers": cfg.num_layers, "params": n_params,
           "wall_s": wall, "peak_mem_gb": peak_gb,
           "train_steps": rec.steps, "rollouts": rollouts,
           "repeat_bitwise": repeat_equal, "grad_norm_total": total,
           "iterations": [{"loss": h.loss, "reward": h.mean_reward,
                           "rollout_s": h.rollout_seconds,
                           "train_s": h.train_seconds,
                           "push_s": h.weight_update_seconds,
                           "tokens": h.tokens, "metrics": h.metrics}
                          for h in hist]}
    del tr
    return out


def modality_training_phase(torch, np, arch, layers=0) -> dict:
    """``make_train_step`` of ``arch`` (a VLM or audio model, which no
    ``RLTrainer`` trains in either package) at full width (``layers``
    layers when given), f32 masters from seed 0, on a packed GRPO batch
    of MODAL_TRAIN_BATCH sequences of ARCH_TRAIN_PROMPT prompt and 64
    response tokens
    carrying seeded ``image_embeds`` / ``audio_frames``; then the same
    gates as the trainers' (``_train_checks``)."""
    import types
    from repro_torch.models import init_params
    from repro_torch.training.grpo import GRPOConfig
    from repro_torch.training.loop import make_train_step, master_params
    from repro_torch.training.optim import (OptConfig, init_opt_state,
                                            tree_items)
    cfg = _arch_cfg(arch, layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = master_params(init_params(cfg, gen, device="cuda",
                                       dtype="float32"), "cuda")
    opt_state = init_opt_state(params)
    n_params = sum(t.numel() for _, t in tree_items(params))
    B, S = MODAL_TRAIN_BATCH, ARCH_TRAIN_PROMPT + ARCH_TRAIN_NEW
    rng = np.random.default_rng(5)
    mask = np.zeros((B, S), np.float32)
    mask[:, ARCH_TRAIN_PROMPT:] = 1.0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
                 np.int32),
             "loss_mask": mask,
             "old_logprobs": (-np.log(cfg.vocab_size) + rng.normal(
                 0, 0.3, size=(B, S))).astype(np.float32),
             "advantages": rng.normal(size=(B,)).astype(np.float32),
             "rewards": rng.random(B).astype(np.float32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    key = "image_embeds" if cfg.arch_type == "vlm" else "audio_frames"
    batch[key] = modality_embeds(torch, np, cfg, B, seed=9)
    gcfg = GRPOConfig()
    rec = _StepRecorder(torch, make_train_step(cfg, gcfg, OptConfig()))
    log(f"  {arch}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B f32 "
        f"master params; a train step on {B} x {S} tokens with seeded "
        f"{key} {tuple(batch[key].shape)}")
    t0 = time.perf_counter()
    params, opt_state, loss, _ = rec(params, opt_state, batch)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, norms, total = _grad_norms(
        torch, cfg, types.SimpleNamespace(params=params, gcfg=gcfg), batch)
    repeat_equal = _repeat_first_step(torch, cfg, rec, params, opt_state)
    _train_checks(torch, np, cfg, arch, rec, norms, repeat_equal)
    return {"arch": arch, "layers": cfg.num_layers, "params": n_params,
            "step_s": wall, "peak_mem_gb": peak_gb, "train_steps": rec.steps,
            "repeat_bitwise": repeat_equal, "grad_norm_total": total}


# the SSM and hybrid trainers, whose train step runs K4's backward once per
# Mamba2 block
TRAIN_STEP_ARCHS = ("mamba2-370m", "zamba2-1.2b")


def train_step_time(torch, np, arch, steps=5) -> dict:
    """Warm GRPO train steps of ``arch`` at full width and depth through
    ``make_train_step`` alone, for before/after measurements of the train
    step outside the smoke run (a signature every version of the port
    keeps, so the same code times a parent tree's port: import this
    module, put the tree's ``src`` first on ``sys.path`` and call this;
    PERF.md names the command): f32
    masters from seed 0 and a seeded batch of ARCH_TRAIN_GROUPS x
    GROUP_SIZE rows of ARCH_TRAIN_PROMPT + ARCH_TRAIN_NEW tokens (the
    trainers' shape); one warm-up step, then ``steps`` steps each timed by
    the host clock between synchronizations, with K4's backward's
    launches per step; one more step under torch.profiler: its device
    time and K4's backward's kernels' share of it (named ``ssd_bwd_*``;
    a tree whose kernels are named otherwise reads 0)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import init_params
    from repro_torch.training.grpo import GRPOConfig
    from repro_torch.training.loop import make_train_step, master_params
    from repro_torch.training.optim import OptConfig, init_opt_state
    cfg = _arch_cfg(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = master_params(init_params(cfg, gen, device="cuda",
                                       dtype="float32"), "cuda")
    opt_state = init_opt_state(params)
    B, S = ARCH_TRAIN_GROUPS * GROUP_SIZE, ARCH_TRAIN_PROMPT + ARCH_TRAIN_NEW
    rng = np.random.default_rng(5)
    mask = np.zeros((B, S), np.float32)
    mask[:, ARCH_TRAIN_PROMPT:] = 1.0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
                 np.int32),
             "loss_mask": mask,
             "old_logprobs": (-np.log(cfg.vocab_size) + rng.normal(
                 0, 0.3, size=(B, S))).astype(np.float32),
             "advantages": rng.normal(size=(B,)).astype(np.float32),
             "rewards": rng.random(B).astype(np.float32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    step = make_train_step(cfg, GRPOConfig(), OptConfig())
    params, opt_state, loss, _ = step(params, opt_state, batch)
    torch.cuda.synchronize()
    walls, launches = [], []
    for _ in range(steps):
        n0 = ssd_ops.launches["ssd_scan_bwd"]
        t0 = time.perf_counter()
        params, opt_state, loss, _ = step(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(ssd_ops.launches["ssd_scan_bwd"] - n0)
    check(bool(torch.isfinite(loss)), f"{arch} train step: loss {loss}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    dev = bwd = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t and e.device_type.name == "CUDA":
            dev += t / 1e3
            if "ssd_bwd_" in e.key:
                bwd += t / 1e3
    ws = sorted(walls)
    return {"arch": arch, "layers": cfg.num_layers, "B": B, "S": S,
            "step_s": ws[len(ws) // 2], "steps_s": walls,
            "k4_bwd_launches": launches, "device_ms": dev,
            "k4_bwd_ms": bwd, "k4_bwd_share": bwd / max(dev, 1e-9),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def log_arch_training(r) -> None:
    st = r["train_steps"][0]
    launches = ", ".join(f"{k} {st[k]}" for k in (
        "flash_attention", "flash_attention_dq", "flash_attention_dkdv",
        "ssd_scan", "ssd_scan_bwd", "spec_verify", "tree_verify",
        "plain_calls"))
    m = st["metrics"]
    log(f"  {r['arch']} ({r['layers']} layers, {r['params'] / 1e9:.3f} B "
        f"params): loss {st['loss']:+.6e}, grad norm {m['grad_norm']:.4f}, "
        f"aux loss {m['aux_loss']:.6f}; per train step {launches}; repeat "
        f"bitwise equal: {r['repeat_bitwise']}; every leaf's gradient "
        f"nonzero; peak memory {r['peak_mem_gb']:.1f} GB")
    for i, (it, ro) in enumerate(zip(r.get("iterations", ()),
                                     r.get("rollouts", ()))):
        log(f"  iteration {i}: rollout {it['rollout_s']:.3f} s "
            f"({ro['steps']} engine steps, {ro['host_syncs']} host syncs, "
            f"K1 {ro['launches']['spec_verify']}, K4 "
            f"{ro['launches']['ssd_scan']}), train {it['train_s']:.3f} s, "
            f"push {it['push_s']:.3f} s; reward {it['reward']:.4f}")
    if "step_s" in r:
        log(f"  train step {r['step_s']:.3f} s (first, with its warm-up)")


def _crash_run(torch, cfg, task, crash: bool) -> dict:
    """Two sync iterations of the crash-gap trainer (see
    ``crash_gap_phase``), with or without the crash; the trainer is
    dropped on return."""
    from repro_torch.core.faults import FaultEvent, FaultInjector
    from repro_torch.training.loop import RLConfig, RLTrainer
    inj = FaultInjector([FaultEvent(tick=4, kind="crash",
                                    instance_id="inst0")]) if crash else None
    rl = RLConfig(n_groups=8, group_size=2, max_new_tokens=32,
                  temperature=1.0, iterations=2, seed=0, n_instances=2,
                  max_slots=4, cache_len=512, chunk_size=8,
                  spec_decode=False, fault_injector=inj, device="cuda",
                  log=lambda s: None)
    tr = RLTrainer(cfg, task, rl)
    sampled, groups_of = [], tr._sample_groups

    def keep(it):
        groups = groups_of(it)
        sampled.extend(groups)
        return groups
    tr._sample_groups = keep
    # each train step under deterministic algorithms, as the training
    # phase's repeat runs it: the same batch must give the same update
    step = tr.train_step

    def deterministic_step(*args):
        torch.use_deterministic_algorithms(True)
        try:
            return step(*args)
        finally:
            torch.use_deterministic_algorithms(False)
    tr.train_step = deterministic_step
    hist = tr.run()
    torch.cuda.synchronize()
    out = {"losses": [h.loss for h in hist],
           "grad_norms": [h.metrics["grad_norm"] for h in hist],
           "rewards": [h.mean_reward for h in hist],
           "responses": {r.req_id: list(r.generated)
                         for g in sampled for r in g.requests},
           "logprobs": {r.req_id: [float(x) for x in r.logprobs]
                        for g in sampled for r in g.requests},
           "finished": all(r.finished for g in sampled for r in g.requests),
           "crashes": sum(i.crashes for i in tr.rollout.instances)}
    tr._sample_groups = groups_of = None
    return out


def crash_gap_phase(torch, np) -> dict:
    """What a crash changes in the trainer's inputs on the card: the
    training phase's granite (TRAIN_LAYERS layers, f32 masters, bf16
    rollout), two sync iterations of a small rollout (8 groups x 2 of the
    training phase's prompts, 32 new tokens, 2 instances x 4 slots,
    chunks of 8, no drafting) without and with one crash of inst0 at
    tick 4; the differences in losses, grad norms and rollout logprobs,
    and whether the responses and rewards are equal.  The crash replay
    keeps the logprobs its tokens were recorded with, and the engine
    path's products, norms and attention are row-invariant, so the
    rebatching after the crash changes no bit.  Gates: the crash happened
    and every group finished; responses and rewards equal, the loss and
    grad-norm gaps 0.0 and no rollout logprob differing, in both
    iterations (the reference asserts this of itself,
    tests/test_faults.py)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import make_task
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=TRAIN_LAYERS)
    task = make_task("copy", cfg.vocab_size, prompt_len=TRAIN_PROMPT - 1,
                     response_len=32, content_vocab=0)
    runs = []
    for crash in (False, True):
        runs.append(_crash_run(torch, cfg, task, crash))
        gc.collect()
        torch.cuda.empty_cache()
    base, crashed = runs
    check(crashed["crashes"] >= 1 and base["crashes"] == 0,
          f"crash gap: crashes {base['crashes']} / {crashed['crashes']}")
    check(base["finished"] and crashed["finished"],
          "crash gap: a request did not finish")
    per_iter = {}
    for rid, toks in base["responses"].items():
        other = crashed["responses"][rid]
        first = next((i for i, (a, b) in enumerate(zip(toks, other))
                      if a != b), None)
        if first is None and len(toks) != len(other):
            first = min(len(toks), len(other))
        # logprobs compared over the tokens both runs share
        n = len(toks) if first is None else first
        lp_a, lp_b = base["logprobs"][rid][:n], crashed["logprobs"][rid][:n]
        it = per_iter.setdefault(rid.split("-")[0], {
            "responses": 0, "responses_differing": 0, "first_differing": [],
            "logprobs": 0, "logprobs_differing": 0, "logprob_max_gap": 0.0})
        it["responses"] += 1
        if first is not None:
            it["responses_differing"] += 1
            it["first_differing"].append(first)
        it["logprobs"] += n
        it["logprobs_differing"] += sum(a != b for a, b in zip(lp_a, lp_b))
        it["logprob_max_gap"] = max([it["logprob_max_gap"]] + [
            abs(a - b) for a, b in zip(lp_a, lp_b)])
    out = {"loss_gaps": [abs(a - b) for a, b in zip(base["losses"],
                                                    crashed["losses"])],
           "grad_norm_gaps": [abs(a - b) for a, b in zip(
               base["grad_norms"], crashed["grad_norms"])],
           "losses": [base["losses"], crashed["losses"]],
           "iterations": per_iter,
           "responses_equal": base["responses"] == crashed["responses"],
           "rewards_equal": base["rewards"] == crashed["rewards"],
           "crashes": crashed["crashes"]}
    log(f"  crash gap (granite, {TRAIN_LAYERS} layers, 2 sync iterations, "
        f"inst0 crashed at tick 4 of the first rollout): loss gaps "
        f"{out['loss_gaps']}, grad-norm gaps {out['grad_norm_gaps']}; "
        f"responses equal {out['responses_equal']}, rewards equal "
        f"{out['rewards_equal']}")
    for name, it in sorted(per_iter.items()):
        log(f"    {name}: {it['responses_differing']} of {it['responses']} "
            f"responses differ (first differing token at "
            f"{sorted(it['first_differing'])}); over the tokens both runs "
            f"share, {it['logprobs_differing']} of {it['logprobs']} "
            f"logprobs differ, by at most {it['logprob_max_gap']:.3e}")
    check(out["responses_equal"] and out["rewards_equal"],
          "crash gap: the crash changed the responses or the rewards")
    check(all(g == 0.0 for g in out["loss_gaps"] + out["grad_norm_gaps"]),
          f"crash gap: loss gaps {out['loss_gaps']}, grad-norm gaps "
          f"{out['grad_norm_gaps']} (want 0.0)")
    check(len(per_iter) == 2 and not any(
        it["logprobs_differing"] or it["responses_differing"]
        for it in per_iter.values()),
          f"crash gap: logprobs or responses differ: {per_iter}")
    return out


def cross_bwd_check(torch, np) -> list:
    """K3's backward at the cross blocks' training shapes (``CROSS_SHAPES``:
    the VLM's 32/8 heads of 128 over 1601 image tokens, whisper's 6/6
    heads of 64 over 1500 frames), non-causal, bf16, a batch of 2 rows
    of the training batch's 448 queries: ``_flash_case`` (forward, dQ, dK/dV at TOL,
    repeat bitwise, the forward at the reference's scale), then dQ, dK
    and dV each held to the f32 plain backward at the reference's scale
    (``scaled_check``), with planted faults that must fail: for dQ the
    last key dropped and a ragged tile's padding let in, for dK and dV
    the last query's dO dropped and the padding let in."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    rows = []
    for arch, (Hq, Hk, D, Tm) in CROSS_SHAPES.items():
        B, T = 2, ARCH_TRAIN_PROMPT + ARCH_TRAIN_NEW
        q, k, v, do = _fa_inputs(torch, np, B=B, Tq=T, Tk=Tm, Hq=Hq, Hk=Hk,
                                 D=D, dtype="bfloat16", seed=Tm + D)
        row = _flash_case(torch, q, k, v, do, q_offset=0, causal=False,
                          window=0, scaled=True)
        o, lse = ops.forward_kernel(q, k, v, causal=False)
        dq, dk, dv = ops.backward_kernels(q, k, v, o, lse, do, causal=False)
        q32, do32 = q.float(), do.float()

        def plain(k_, v_, do_=do32, q_=q32):
            o_, lse_ = flash_attention_fwd_ref(q_, k_, v_, causal=False)
            return flash_attention_bwd_ref(q_, k_, v_, o_, lse_, do_,
                                           causal=False)
        what = f"flash_attention backward {arch} cross B={B} Tq={T} Tk={Tm}"
        errs = scaled_check(torch, {"dq": dq}, lambda k_, v_: plain(
            k_, v_)[0], k, v, what)
        k32, v32 = k.float(), v.float()
        z = k32.new_zeros((B, -Tm % 64) + tuple(k.shape[2:]))
        padded = plain(torch.cat([k32, z], 1), torch.cat([v32, z], 1))
        do_cut = do32.clone()
        do_cut[:, -1] = 0.0
        cut = plain(k32, v32, do_cut)
        for i, name in ((1, "dk"), (2, "dv")):
            errs.update(scaled_check(
                torch, {name: (dk, dv)[i - 1]},
                lambda k_, v_, i=i: plain(k_, v_)[i], k, v, what,
                faults={"last query's dO dropped": cut[i].to(q.dtype),
                        f"{z.shape[1]} padded keys admitted":
                        padded[i][:, :Tm].to(q.dtype)}))
        row["arch"], row["bwd_scaled_errs"] = arch, errs
        rows.append(row)
    return rows


# the record_function range around each MoE layer in ``profile_steps``
MOE_RANGE = "moe_layer"


def profile_steps(torch, cfg, params, n_steps: int,
                  cache_len: int = 2048) -> dict:
    """torch.profiler over decode steps of one full instance: device time
    by kernel name, and the device's busy share of the window.  On a MoE
    model each MoE layer (``moe_forward``) runs inside a
    ``record_function`` range for the window, and the device time of the
    kernels launched in those ranges is its share."""
    import contextlib
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.engine import EngineSeq, Instance, StepFunctions
    from repro_torch.models import transformer
    inst = Instance(cfg, params, StepFunctions(cfg), max_slots=8,
                    cache_len=cache_len, device="cuda")
    rng = np.random.default_rng(5)
    for i in range(8):
        inst.admit(EngineSeq(f"p{i}", f"g{i % 2}", rng.integers(
            0, cfg.vocab_size, size=300).tolist(), seed=i, temperature=1.0,
            max_new_tokens=10_000))
    while inst.prefilling_slots():
        inst.run_step()
    for _ in range(3):
        inst.run_step()
    torch.cuda.synchronize()
    moe_forward = transformer.moe_forward

    def moe_ranged(*a, **kw):
        with record_function(MOE_RANGE):
            return moe_forward(*a, **kw)
    with contextlib.ExitStack() as stack:
        if cfg.arch_type == "moe":
            transformer.moe_forward = moe_ranged
            stack.callback(setattr, transformer, "moe_forward", moe_forward)
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        for it in range(n_steps):
            drafts = {i: [inst.slots[i].last_token] * 8
                      for i in inst.decode_slots()} if it % 2 else {}
            inst.run_step(drafts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"steps": n_steps, **_profile_summary(prof, wall)}
    if cfg.arch_type == "moe":
        moe = [e for e in prof.key_averages() if e.key == MOE_RANGE
               and e.device_type.name == "CPU"]
        t = sum(getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0.0) for e in moe) / 1e3
        out["moe_layer_ms"] = t
        out["shares"]["moe_layer"] = t / max(out["device_ms"], 1e-9)
    return out


# each kernel library's CUDA kernels, by the names the profiler records:
# K1 / K2 on either route and the split merge, K3 on either route
# (flash_{fwd,dq,dkdv}_{wgmma,kernel}), K4 on each of its routes, K4's
# backward's seven kernels (ssd_bwd_{prep,states,tiles,rows,cols,finish,
# reduce})
KERNEL_NAMES = {"spec_verify": ("verify_cores", "verify_wgmma",
                                "merge_splits"),
                "flash_attention": ("flash_fwd_", "flash_dq_",
                                    "flash_dkdv_"),
                "ssd_scan": ("ssd_recurrent", "ssd_tensor_cores",
                             "ssd_cores"),
                "ssd_scan_bwd": ("ssd_bwd_",)}


def _profile_summary(prof, wall: float) -> dict:
    """Device time by kernel name over a profiled window of ``wall``
    seconds, and the device's busy share of it."""
    rows = []
    dev_total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        # a record_function range's device-side span is not a kernel
        if t and e.device_type.name == "CUDA" and e.key != MOE_RANGE:
            rows.append((e.key, t / 1e3, e.count))
            dev_total += t / 1e3
    rows.sort(key=lambda r: -r[1])
    shares = {name: sum(t for k, t, _ in rows if any(f in k for f in names))
              / max(dev_total, 1e-9) for name, names in KERNEL_NAMES.items()}
    return {"wall_ms": wall * 1e3, "device_ms": dev_total,
            "busy_share": dev_total / max(wall * 1e3, 1e-9),
            "shares": shares, "top": rows[:25]}


# ---------------------------------------------------------------------------
# phase 7: serving, faults and tracing.  The reference's three real-engine
# workloads (benchmarks/common.py: bench_engine_faults, bench_observability
# and bench_serving) restated on a package's API (``port_api``): the card
# runs them on the port, and the CPU tests run the same functions on the
# JAX package and on the port and hold the two equal
# ---------------------------------------------------------------------------

# the faults and tracing workloads: 3 groups x 2, 14 new tokens, seed 5;
# the faults workload on 3 instances, the tracing workload on 2
BENCH_GROUPS, BENCH_GROUP_SIZE, BENCH_NEW_TOKENS, BENCH_SEED = 3, 2, 14, 5
FAULT_INSTANCES, TRACE_INSTANCES = 3, 2
# the open-loop workload: 12 groups x 2 of 10-token prompts and 10 new
# tokens (no spread), two tenants (name, weight, tokens/s), chunks of 16
SERVE_GROUPS, SERVE_PROMPT, SERVE_GEN, SERVE_SEED = 12, 10, 10, 11
SERVE_TENANTS = (("a", 2.0, 120.0), ("b", 1.0, 120.0))
SERVE_CHUNK, SERVE_CACHE = 16, 128
# the faults and tracing workloads' cache: the longest prompt, the new
# tokens and 32 slots of headroom (60 slots, no multiple of K1's 64-key
# tile)
BENCH_CACHE = 6 + 4 * (BENCH_GROUPS - 1) + BENCH_NEW_TOKENS + 32
# K1 at the phase's own shapes, B = 2 slots: (cache, T, the two rows'
# live counts).  The faults and tracing cache at decode, the crash
# replay's widths 5 and 9 and prefill chunks of 8; the open-loop cache at
# decode and prefill chunks of 16; live counts from a prompt's first
# chunk to a whole response (a row with fewer live slots than T has
# queries that see no key, as a short prompt's padded chunk)
SERVING_K1_CASES = ((BENCH_CACHE, 1, (7, 28)), (BENCH_CACHE, 5, (12, 28)),
                    (BENCH_CACHE, 8, (6, 14)), (BENCH_CACHE, 9, (9, 27)),
                    (SERVE_CACHE, 1, (11, 20)), (SERVE_CACHE, 16, (10, 20)))
# K1 calls kept from the phase's own run (``_k1_inputs``): per (B, T, S),
# layer 0's call of the 1st, 2nd, 4th, 8th ... engine step of that shape
K1_KEPT_PER_SHAPE = 12
# the RolloutStats counters of the faults workload's record
FAULT_COUNTERS = (
    "instance_crashes", "watchdog_escalations", "stuck_ticks",
    "recovered_requests", "recovered_via_blob", "recovered_via_replay",
    "recovery_redecode_tokens", "recovery_replay_tokens",
    "faulted_remaining_tokens", "fetch_failures", "fetch_degraded",
    "corrupt_blobs", "fetch_backoff_seconds")


def port_api(device):
    """The names the three workloads call, from the port, its rollouts
    on ``device``."""
    import functools
    import types
    from repro_torch.core import (FaultEvent, FaultInjector, SeerRollout,
                                  make_groups)
    from repro_torch.core.workload import (ArrivalFeed, LengthSampler,
                                           PoissonArrivals, TenantSpec,
                                           TraceArrivals, serve)
    from repro_torch.engine import StepFunctions
    from repro_torch.obs import (PHASES, Tracer, format_attribution,
                                 tail_attribution, timelines_from_events)
    from repro_torch.obs.trace import SCHEMA_KEYS, schema_keys
    return types.SimpleNamespace(
        SeerRollout=functools.partial(SeerRollout, device=device),
        make_groups=make_groups, FaultEvent=FaultEvent,
        FaultInjector=FaultInjector, ArrivalFeed=ArrivalFeed,
        LengthSampler=LengthSampler, PoissonArrivals=PoissonArrivals,
        TenantSpec=TenantSpec, TraceArrivals=TraceArrivals, serve=serve,
        StepFunctions=StepFunctions, PHASES=PHASES, Tracer=Tracer,
        format_attribution=format_attribution,
        tail_attribution=tail_attribution,
        timelines_from_events=timelines_from_events,
        SCHEMA_KEYS=SCHEMA_KEYS, schema_keys=schema_keys)


def bench_prompts(cfg) -> list:
    """Prompts of 6, 10 and 14 tokens: slots reach their chunk boundaries
    out of step, so a crash finds victims both at a boundary and inside a
    chunk."""
    return [[(7 * g + 3 * j) % (cfg.vocab_size - 2) + 1
             for j in range(6 + 4 * g)] for g in range(BENCH_GROUPS)]


def bench_groups(api, cfg):
    return api.make_groups(bench_prompts(cfg), group_size=BENCH_GROUP_SIZE,
                           max_new_tokens=BENCH_NEW_TOKENS, seed=BENCH_SEED)


def bench_rollout(api, cfg, params, n_instances: int, **kw):
    """The faults and tracing workloads' rollout: 2 slots an instance
    on caches of ``BENCH_CACHE``, chunks of 5, prefill chunks of 8, no
    drafting (``gamma_max`` 8 sizes the crash replay's verify steps),
    takeover and in-place renewal off (every chunk boundary is a pool
    round trip), the watchdog at 3 ticks and 3 fetch retries."""
    args = dict(n_instances=n_instances, max_slots=2,
                cache_len=BENCH_CACHE, chunk_size=5, prefill_chunk=8,
                admit_into_draining=False,
                final_chunk_inplace=False, policy="seer", spec_decode=False,
                gamma_max=8, base_seed=7, watchdog_ticks=3, fetch_retries=3)
    args.update(kw)
    return api.SeerRollout(cfg, params, **args)


def _kinds_since(steps, kinds0: dict) -> dict:
    """Fused steps by kind (``"fused:T"``) since ``kinds0``."""
    return {k: n - kinds0.get(k, 0) for k, n in
            steps.invocations_by_kind.items() if n - kinds0.get(k, 0)}


def _measured_run(ro, run):
    """``run()`` (a ``ro.run`` or ``serve``) -> (its value, its engine
    steps, host syncs, fused steps by kind and host seconds)."""
    st = ro.steps
    hs0, by0 = st.host_syncs, dict(st.invocations_by_kind)
    n0 = sum(i.steps_run for i in ro.instances)
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    return out, {"engine_steps": sum(i.steps_run for i in ro.instances) - n0,
                 "host_syncs": st.host_syncs - hs0,
                 "fused_by_T": _kinds_since(st, by0), "wall_s": wall}


def fault_schedule(api, ticks: int) -> list:
    """The faults workload's schedule on an oracle run of ``ticks`` ticks:
    a late crash, a short stall below the watchdog, a long stall it
    escalates, fetch failures past the retry budget on the first
    re-admission wave, a corrupt blob mid-run, and failures within the
    budget later."""
    T = ticks
    return [api.FaultEvent(tick=max(2, (3 * T) // 5), kind="crash",
                           instance_id="inst1"),
            api.FaultEvent(tick=3, kind="stuck", instance_id="inst2",
                           ticks=2),
            api.FaultEvent(tick=max(4, T // 3), kind="stuck",
                           instance_id="inst0", ticks=8),
            api.FaultEvent(tick=2, kind="fetch_fail", count=3),
            api.FaultEvent(tick=max(3, T // 2), kind="corrupt", count=1),
            api.FaultEvent(tick=max(4, T // 2 + 2), kind="fetch_fail",
                           count=2)]


def faults_workload(api, cfg, params, guard=None, steps=None) -> dict:
    """bench_engine_faults's real-engine runs: a warm no-fault oracle,
    then the schedule on a fresh rollout sharing the oracle's step
    functions (a crashed instance stays dead), each measured run after a
    fault-free warm run of its rollout; then the faulted run again on
    another fresh rollout, traced, whose ``recovery`` instants name each
    victim's path.  ``tokens_lost`` counts as the bench does: mismatches
    plus length differences against the oracle.  ``guard(ro)`` wraps a
    rollout's dispatch before its measured run; ``steps``: the rollouts'
    step functions (new ones by default)."""
    def one(ro, injector=None, tracer=None):
        ro.run(bench_groups(api, cfg))
        ro.faults = injector
        ro.tracer = tracer
        if guard is not None:
            guard(ro)
        res, rec = _measured_run(ro, lambda: ro.run(bench_groups(api, cfg)))
        s = res.stats.snapshot()
        rec.update(ticks=s["ticks"], **{k: s[k] for k in FAULT_COUNTERS})
        return res.responses(), rec

    steps = steps or api.StepFunctions(cfg)
    kinds0 = dict(steps.invocations_by_kind)
    oracle, orec = one(bench_rollout(api, cfg, params, FAULT_INSTANCES,
                                     steps=steps))
    faulted, frec = one(
        bench_rollout(api, cfg, params, FAULT_INSTANCES, steps=steps),
        api.FaultInjector(fault_schedule(api, orec["ticks"])))
    tr = api.Tracer()
    again, arec = one(
        bench_rollout(api, cfg, params, FAULT_INSTANCES, steps=steps),
        api.FaultInjector(fault_schedule(api, orec["ticks"])), tracer=tr)
    paths: dict = {}
    for e in tr.events():
        if e["name"] == "recovery" and e["ph"] == "i":
            paths.setdefault(e["track"], set()).add(e["args"]["kind"])
    lost, first = {}, {}
    for rid, want in oracle.items():
        got = faulted.get(rid, [])
        n = sum(a != b for a, b in zip(want, got)) + abs(len(want) -
                                                         len(got))
        if n:
            lost[rid] = n
            first[rid] = next((j for j, (a, b) in enumerate(zip(want, got))
                               if a != b), min(len(want), len(got)))
    return {"schedule": [{"tick": e.tick, "kind": e.kind,
                          "instance_id": e.instance_id, "ticks": e.ticks,
                          "count": e.count}
                         for e in fault_schedule(api, orec["ticks"])],
            "oracle": orec, "faulted": frec, "repeat": arec,
            "responses": {"oracle": oracle, "faulted": faulted},
            "lengths_equal": all(len(faulted.get(r, ())) == len(t)
                                 for r, t in oracle.items()),
            "tokens_lost": sum(lost.values()), "lost_by_request": lost,
            "first_difference": first,
            "recovery_paths": {r: sorted(k) for r, k in
                               sorted(paths.items())},
            "repeat_identical": again == faulted and all(
                arec[k] == frec[k] for k in frec if k != "wall_s"),
            "step_kinds": _kinds_since(steps, kinds0)}


def trace_workload(api, cfg, params, guard=None, steps=None) -> dict:
    """bench_observability's engine runs: one untraced run and two traced
    ones of the faults workload's rollout on 2 instances, fault-free.
    The first traced run's Chrome JSON, timelines and tail attribution,
    and the invariants the bench gates: traced = untraced (responses,
    engine steps, host syncs), conservation, exact tick tiling, a lossless
    Chrome round trip, the same JSON from both traced runs, the shared
    schema and phase names.  ``guard(ro)`` wraps each traced rollout's
    dispatch; ``steps`` as in ``faults_workload``."""
    import json as _json
    steps = steps or api.StepFunctions(cfg)
    kinds0 = dict(steps.invocations_by_kind)

    def one(tracer=None):
        ro = bench_rollout(api, cfg, params, TRACE_INSTANCES, steps=steps,
                           tracer=tracer)
        if guard is not None and tracer is not None:
            guard(ro)
        return _measured_run(ro, lambda: ro.run(bench_groups(api, cfg)))

    res_off, off = one()
    tr, tr2 = api.Tracer(), api.Tracer()
    res_on, on = one(tr)
    _, on2 = one(tr2)
    evs = tr.events()
    tls = api.timelines_from_events(evs)
    rep = api.tail_attribution(tls)
    done = [tl for tl in tls.values() if tl.finished]
    chrome = tr.to_chrome()
    text = _json.dumps(chrome, sort_keys=True)
    phases = sorted({e["name"] for e in evs
                     if e["cat"] == "request" and e["ph"] == "X"})
    return {"untraced": off, "traced": on, "traced_again": on2,
            "bit_identical": res_on.responses() == res_off.responses()
            and on["engine_steps"] == off["engine_steps"]
            and on["host_syncs"] == off["host_syncs"],
            "events": len(evs), "finished": len(done),
            "conserved": rep["conserved"]
            and all(tl.conserved() for tl in done),
            "tick_tiling_exact": all(
                sum(b - a for _, a, b in tl.segments)
                == tl.end_tick - tl.submit_tick for tl in done),
            "chrome_roundtrip": api.Tracer.from_chrome(
                _json.loads(text)) == evs,
            "chrome_deterministic": _json.dumps(
                tr2.to_chrome(), sort_keys=True) == text,
            "schema_ok": api.schema_keys(evs) == sorted(api.SCHEMA_KEYS),
            "phases": phases, "phases_ok": set(phases) <= set(api.PHASES),
            "chrome": chrome, "attribution": rep,
            "attribution_text": api.format_attribution(rep),
            "responses": res_on.responses(),
            "step_kinds": _kinds_since(steps, kinds0)}


def serving_workload(api, cfg, params, guard=None, steps=None) -> dict:
    """bench_serving's engine runs: seeded Poisson arrivals of 12 groups
    through ``serve`` (``run_stream(arrivals=)``).  The closed-loop run of
    the same groups calibrates the sustainable rate (groups per tick), a
    t = 0 trace of them must reproduce it (tokens, engine steps, host
    syncs), a deadline-free run at 0.75x sets the SLO deadline (1.5x its
    largest modeled admission delay), then 1x (0.75x sustainable), 2x and
    a repeat of 2x run under that deadline.  ``guard(ro)`` wraps each
    rollout's dispatch; ``steps`` as in ``faults_workload``."""
    import dataclasses
    steps = steps or api.StepFunctions(cfg)
    kinds0 = dict(steps.invocations_by_kind)
    tenants = tuple(api.TenantSpec(n, weight=w, token_rate=r)
                    for n, w, r in SERVE_TENANTS)
    lengths = api.LengthSampler(prompt_len=SERVE_PROMPT, gen_mean=SERVE_GEN,
                                gen_sigma=0.0)

    def rollout():
        ro = api.SeerRollout(cfg, params, n_instances=2, max_slots=2,
                             cache_len=SERVE_CACHE, chunk_size=SERVE_CHUNK,
                             base_seed=0, steps=steps)
        if guard is not None:
            guard(ro)
        return ro

    def proc(rate):
        return api.PoissonArrivals(rate, SERVE_GROUPS, seed=SERVE_SEED,
                                   tenants=tenants, lengths=lengths)

    def feed_for(process, groups=None):
        return api.ArrivalFeed(process, vocab_size=cfg.vocab_size,
                               group_size=BENCH_GROUP_SIZE,
                               ticks_per_second=1.0, seed=SERVE_SEED,
                               groups=groups)

    def build_groups(trace):
        builder = feed_for(api.TraceArrivals(trace))
        return [builder._build_group(a) for a in trace]

    def open_run(rate, deadline):
        ro = rollout()
        feed = feed_for(proc(rate))
        rep, m = _measured_run(ro, lambda: api.serve(
            ro, feed, slo_deadline_s=deadline))
        res = rep.pop("result")
        rep.update(rate_groups_per_tick=rate, engine_steps=res.stats.steps,
                   idle_ticks=res.stats.idle_ticks,
                   offer_delay_max=res.stats.offer_delay_max,
                   host_syncs=m["host_syncs"], fused_by_T=m["fused_by_T"],
                   wall_s=m["wall_s"])
        return rep

    cal_trace = proc(1.0).trace()
    ro = rollout()
    res_cl, cl = _measured_run(ro, lambda: ro.run(build_groups(cal_trace)))
    sustainable = SERVE_GROUPS / max(res_cl.stats.ticks, 1)
    t0_trace = [dataclasses.replace(a, t=0.0) for a in cal_trace]
    ro_eq = rollout()
    feed_eq = feed_for(api.TraceArrivals(t0_trace),
                       groups=build_groups(cal_trace))
    rep_eq, eq = _measured_run(ro_eq, lambda: api.serve(ro_eq, feed_eq))
    res_eq = rep_eq.pop("result")
    rate_1x, rate_2x = 0.75 * sustainable, 2.0 * sustainable
    floor = rollout()._queue_cost_per_token * SERVE_CHUNK
    cal = open_run(rate_1x, None)
    deadline = 1.5 * max(cal["offer_delay_max"], floor)
    one_x = open_run(rate_1x, deadline)
    two_x = open_run(rate_2x, deadline)
    two_x_rep = open_run(rate_2x, deadline)
    return {"closed_loop": {"ticks": res_cl.stats.ticks,
                            "engine_steps": res_cl.stats.steps,
                            "tokens": res_cl.stats.tokens,
                            "host_syncs": cl["host_syncs"],
                            "fused_by_T": cl["fused_by_T"],
                            "wall_s": cl["wall_s"]},
            "closed_loop_equivalent":
                res_eq.responses() == res_cl.responses()
                and res_eq.stats.steps == res_cl.stats.steps
                and eq["host_syncs"] == cl["host_syncs"],
            "sustainable_rate_groups_per_tick": sustainable,
            "slo_deadline_s": deadline, "calibration": cal,
            "one_x": one_x, "two_x": two_x, "two_x_repeat": two_x_rep,
            "deterministic":
                two_x_rep["shed_indices"] == two_x["shed_indices"]
                and two_x_rep["latency_ticks"] == two_x["latency_ticks"]
                and two_x_rep["admitted_groups"] == two_x["admitted_groups"],
            "responses": res_cl.responses(),
            "step_kinds": _kinds_since(steps, kinds0)}


def dispatch_guard(torch):
    """``guard(ro)``: each of ``ro``'s instances dispatches its steps under
    ``set_sync_debug_mode("error")``, so a host sync in a dispatch
    raises."""
    def guard(ro):
        for inst in ro.instances:
            def guarded(*a, _inner=inst.dispatch_step, **kw):
                return _no_sync(torch, lambda: _inner(*a, **kw))
            inst.dispatch_step = guarded
    return guard


def _slot_faults(torch, k, v, kp, tile: int = 64) -> dict:
    """Inputs of three wrong K1s over a slot cache (f32 k, v (B,S,Hk,D),
    k_pos (B,S)): each row's newest key dropped, its empty slots let in
    at position 0, and, where S is no multiple of ``tile``, the last
    tile's padding (zero keys at position 0) let in.  {name: (k, v,
    k_pos)}."""
    B, S = kp.shape
    newest = kp.clone()
    rows = torch.arange(B, device=kp.device)
    # an empty row's argmax is one of its -1 slots: it stays empty
    newest[rows, kp.long().argmax(1)] = -1
    out = {"newest key dropped": (k, v, newest),
           "empty slots let in": (k, v, kp.clamp(min=0))}
    pad = -S % tile
    if pad:
        z = k.new_zeros((B, pad) + tuple(k.shape[2:]))
        out[f"{pad} padded keys let in"] = (
            torch.cat([k, z], 1), torch.cat([v, z], 1),
            torch.cat([kp, kp.new_zeros((B, pad))], 1))
    return out


def slot_scaled_check(torch, q, k, v, qp, kp, window, what: str,
                      faults: bool) -> dict:
    """``scaled_check`` of each route K1 takes at this slot-cache shape,
    with ``faults`` against the planted faults of ``_slot_faults``.
    Where no query sees a key the outputs must be exactly 0 (there is no
    scale to hold them to)."""
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_ref
    dtype = str(q.dtype).removeprefix("torch.")
    outs = {r: ops.launch_on_route(r, q, k, v, qp, kp, window=window)
            for r in _routes(dtype, q.shape[3])}
    q32 = q.float()

    def plain(k_, v_, kp_=kp):
        return spec_verify_ref(q32, k_, v_, qp, kp_, window=window)
    if not bool(plain(k.float(), v.float()).abs().max() > 0):
        for r, o in outs.items():
            check(not bool(o.abs().max() > 0), f"{what}: {r} is not 0 "
                  "where no query sees a key")
        log(f"  {what}: no query sees a key, every route 0")
        return {}
    wrong = {n: plain(*args).to(q.dtype) for n, args in _slot_faults(
        torch, k.float(), v.float(), kp).items()} if faults else {}
    return scaled_check(torch, outs, plain, k, v, what, faults=wrong)


def serving_kernels_check(torch, np) -> list:
    """K1 at the serving phase's own shapes (``SERVING_K1_CASES``:
    granite-3-8b's heads in bf16, B = 2 slots on the faults and tracing
    workloads' cache of 60 and the open-loop workload's of 128, at each
    width the phase runs), through the wrapper and on both routes
    (``_k1_case``): at the cases' live counts, then with permuted slots,
    an empty row and a blind query; each route also held to the f32
    plain version at the reference's scale, where planted faults must
    fail (``slot_scaled_check``)."""
    hq, hk, d, window = K1_SHAPES["granite-3-8b"]
    rows = []
    for S, T, live in SERVING_K1_CASES:
        for lv in (list(live), None):
            q, k, v, qp, kp = _sv_inputs(
                torch, np, B=2, T=T, S=S, Hq=hq, Hk=hk, D=d,
                dtype="bfloat16", seed=S + T, live=lv)
            note = "permuted slots" if lv is None else f"live {lv}"
            row = _k1_case(torch, "granite-3-8b/serving", q, k, v, qp, kp,
                           window, empty_rows=lv is None, note=note)
            row["scaled_errs"] = slot_scaled_check(
                torch, q, k, v, qp, kp, window,
                f"spec_verify serving B=2 T={T} S={S} {note}", faults=True)
            rows.append(row)
    return rows


@contextlib.contextmanager
def _k1_inputs(n_layers: int, per_shape: int = K1_KEPT_PER_SHAPE):
    """Keeps device copies (no host sync) of the inputs the model gives
    K1 while the block runs: per (B, T, S), layer 0's call of the 1st,
    2nd, 4th, 8th ... engine step of that shape, at most ``per_shape``.
    Yields {(B, T, S): [(step, q, k, v, q_pos, k_pos, window)]}."""
    from repro_torch.models import attention
    inner, calls, kept = attention.spec_verify, {}, {}

    def keep(q, k, v, q_pos, k_pos, *, window=0, split_like=None,
             lse=False):
        key = (q.shape[0], q.shape[1], k.shape[1])
        i = calls[key] = calls.get(key, -1) + 1
        step, layer = divmod(i, n_layers)
        got = kept.setdefault(key, [])
        if layer == 0 and step & (step - 1) == 0 and len(got) < per_shape:
            got.append((step,) + tuple(x.clone() for x in
                                       (q, k, v, q_pos, k_pos)) + (window,))
        return inner(q, k, v, q_pos, k_pos, window=window,
                     split_like=split_like, lse=lse)
    attention.spec_verify = keep
    try:
        yield kept
    finally:
        attention.spec_verify = inner


def phase_kernels_check(torch, kept: dict) -> list:
    """K1 on the inputs the phase gave it (``_k1_inputs``): each kept
    call through the wrapper and on both routes against the plain
    version (``_k1_case``), and against the f32 plain version at the
    reference's scale (``slot_scaled_check``)."""
    rows = []
    for (B, T, S), calls in sorted(kept.items()):
        for step, q, k, v, qp, kp, window in calls:
            live = [int(n) for n in (kp >= 0).sum(1).tolist()]
            note = f"the phase's own call, step {step} of its shape, " \
                f"live {live}"
            row = _k1_case(torch, "granite-3-8b/serving", q, k, v, qp, kp,
                           window, empty_rows=False, note=note)
            row.update(kept_step=step, live=live)
            row["scaled_errs"] = slot_scaled_check(
                torch, q, k, v, qp, kp, window,
                f"spec_verify serving B={B} T={T} S={S} {note}",
                faults=False)
            rows.append(row)
    return rows


def _reference_record() -> dict:
    """The reference's own record of the three workloads on granite-3-8b
    tiny (``results/bench/BENCH_rollout.json``), printed beside the
    card's."""
    with open(os.path.join(ROOT, "results", "bench",
                           "BENCH_rollout.json")) as f:
        rec = json.load(f)
    return {k: rec.get(k, {}) for k in ("engine_faults", "serving",
                                        "observability")}


SERVE_REPORT_KEYS = ("offered_groups", "admitted_groups", "shed_groups",
                     "shed_indices", "elapsed_ticks", "latency_ticks",
                     "completed_requests", "goodput_tokens_per_tick",
                     "queue_depth_peak", "queue_depth_mean", "engine_steps",
                     "idle_ticks")


def serving_phase(torch, np, cfg, params) -> dict:
    """Phase 7: the faults, tracing and open-loop workloads on the card
    (``faults_workload``, ``trace_workload``, ``serving_workload``), every
    dispatch under sync debug 'error', the launch counts set to 0 just
    before and read just after.  Each workload's numbers are printed
    (beside the reference's record on granite-3-8b tiny) before its
    gates are checked."""
    api = port_api("cuda")
    guard = dispatch_guard(torch)
    L = cfg.num_layers
    ref = _reference_record()
    plain0 = _plain_calls()
    _reset_launches()
    with _k1_inputs(L) as kept:
        t0 = time.perf_counter()
        f = faults_workload(api, cfg, params, guard)
        t1 = time.perf_counter()
        o = trace_workload(api, cfg, params, guard)
        t2 = time.perf_counter()
        s = serving_workload(api, cfg, params, guard)
        t3 = time.perf_counter()
    launches = _launches()
    plain = _plain_calls() - plain0
    by_T: dict = {}
    for w in (f, o, s):
        for k, n in w["step_kinds"].items():
            by_T[k] = by_T.get(k, 0) + n
    fused = sum(by_T.values())
    # K1 on the inputs the run gave it (its launches are not the phase's)
    kept_T = {T for _, T, _ in kept}
    k1_checks = phase_kernels_check(torch, kept)
    del kept
    out = {"faults": f, "trace": o, "serving": s, "launches": launches,
           "plain_calls": plain, "fused_steps": fused, "fused_by_T": by_T,
           "k1_checks": k1_checks,
           "wall_s": {"faults": t1 - t0, "trace": t2 - t1,
                      "serving": t3 - t2}}

    rf = ref["engine_faults"].get("faulted", {})
    log(f"  faults ({t1 - t0:.1f} s): schedule {f['schedule']}")
    for which in ("oracle", "faulted", "repeat"):
        r_ = f[which]
        log(f"  {which}: engine steps {r_['engine_steps']}, ticks "
            f"{r_['ticks']}, host syncs {r_['host_syncs']}, wall "
            f"{r_['wall_s']:.3f} s, steps by T {r_['fused_by_T']}")
    log("  recovery counters, card vs the reference's record: " + ", ".join(
        f"{k} {f['faulted'][k]}/{rf.get(k)}" for k in ("engine_steps",
                                                       "ticks")
        + FAULT_COUNTERS) + "; equal: " + str(all(
            f["faulted"][k] == rf.get(k) for k in ("engine_steps", "ticks")
            + FAULT_COUNTERS)))
    log(f"  tokens_lost {f['tokens_lost']} (reference "
        f"{ref['engine_faults'].get('tokens_lost')}); recovery paths "
        f"{f['recovery_paths']}; repeat (traced) bit-identical "
        f"{f['repeat_identical']}")
    for rid, n in f["lost_by_request"].items():
        log(f"  differs from the oracle: {rid}, {n} tokens, first at "
            f"position {f['first_difference'][rid]}, recovery path "
            f"{f['recovery_paths'].get(rid, 'none')}")
    ro_ = ref["observability"]
    log(f"  tracing ({t2 - t1:.1f} s): {o['events']} events (reference "
        f"{ro_.get('events')}), {o['finished']} finished timelines, "
        f"traced = untraced {o['bit_identical']}, conserved "
        f"{o['conserved']}, ticks tile {o['tick_tiling_exact']}, Chrome "
        f"round trip {o['chrome_roundtrip']}, same JSON twice "
        f"{o['chrome_deterministic']}, schema {o['schema_ok']}, phases "
        f"{o['phases']}; host syncs untraced {o['untraced']['host_syncs']} "
        f"/ traced {o['traced']['host_syncs']} for engine steps "
        f"{o['untraced']['engine_steps']} / {o['traced']['engine_steps']}")
    for line in o["attribution_text"].splitlines():
        log(f"    {line}")
    rs = ref["serving"]
    log(f"  open-loop serving ({t3 - t2:.1f} s): closed loop "
        f"{s['closed_loop']}, t = 0 trace equivalent "
        f"{s['closed_loop_equivalent']}; sustainable "
        f"{s['sustainable_rate_groups_per_tick']:.6f} groups/tick "
        f"(reference {rs.get('sustainable_rate_groups_per_tick')}), SLO "
        f"deadline {s['slo_deadline_s']:.6e} s (reference "
        f"{rs.get('slo_deadline_s')})")
    for which, key in (("calibration (0.75x, no deadline)", "calibration"),
                       ("1x", "one_x"), ("2x", "two_x"),
                       ("2x repeat", "two_x_repeat")):
        r_ = s[key]
        log(f"  {which}: " + ", ".join(f"{k} {r_[k]}"
                                      for k in SERVE_REPORT_KEYS)
            + f", host syncs {r_['host_syncs']}, wall {r_['wall_s']:.3f} s")
        if key in rs:
            log(f"    reference: " + ", ".join(
                f"{k} {rs[key].get(k)}" for k in SERVE_REPORT_KEYS))
    log(f"  K1 launches {launches['spec_verify']} = {fused} fused steps x "
        f"{L}; steps by T {by_T}")
    rel = [e for c in k1_checks for e in c["scaled_errs"].values()]
    log(f"  K1 on {len(k1_checks)} of the phase's own calls (widths "
        f"{sorted(kept_T)}): max|err| "
        f"{max(c['max_abs_err'] for c in k1_checks):.3e} (tol "
        f"{TOL['bfloat16']}), rel rms / rel max against f32 at most "
        f"{max((e[0] for e in rel), default=0.0):.2e} / "
        f"{max((e[1] for e in rel), default=0.0):.2e}")

    # faults
    check(f["lengths_equal"] and all(
        len(t) == BENCH_NEW_TOKENS for t in f["responses"]["oracle"].values()),
        "faults: a request did not finish at the oracle's length")
    fr = f["faulted"]
    for k in ("recovered_via_blob", "recovered_via_replay",
              "watchdog_escalations", "corrupt_blobs", "fetch_degraded"):
        check(fr[k] > 0, f"faults: recovery path {k} never fired")
    for which in ("oracle", "faulted", "repeat"):
        check(f[which]["host_syncs"] == f[which]["engine_steps"],
              f"faults ({which}): host syncs {f[which]['host_syncs']} != "
              f"engine steps {f[which]['engine_steps']}")
    check(f["repeat_identical"], "faults: the repeat of the faulted run "
          "is not bit-identical")
    check(f["tokens_lost"] == 0, f"faults: tokens_lost "
          f"{f['tokens_lost']} (printed above, by request)")
    # tracing
    check(o["bit_identical"], "tracing: traced run differs from untraced")
    for which in ("untraced", "traced", "traced_again"):
        check(o[which]["host_syncs"] == o[which]["engine_steps"],
              f"tracing ({which}): host syncs != engine steps")
    check(o["finished"] == BENCH_GROUPS * BENCH_GROUP_SIZE,
          f"tracing: {o['finished']} finished timelines")
    for k in ("conserved", "tick_tiling_exact", "chrome_roundtrip",
              "chrome_deterministic", "schema_ok", "phases_ok"):
        check(o[k], f"tracing: {k} fails")
    # open-loop serving
    check(s["closed_loop_equivalent"], "serving: the t = 0 trace differs "
          "from the closed-loop run")
    check(s["one_x"]["shed_groups"] == 0 and
          s["one_x"]["admitted_groups"] == SERVE_GROUPS,
          f"serving: 1x shed {s['one_x']['shed_indices']}")
    check(s["two_x"]["shed_groups"] >= 1, "serving: 2x shed nothing")
    check(s["deterministic"], "serving: the 2x repeat differs")
    check(s["closed_loop"]["host_syncs"] == s["closed_loop"]["engine_steps"],
          "serving (closed loop): host syncs != engine steps")
    for key in ("calibration", "one_x", "two_x", "two_x_repeat"):
        check(s[key]["host_syncs"] == s[key]["engine_steps"],
              f"serving ({key}): host syncs {s[key]['host_syncs']} != "
              f"engine steps {s[key]['engine_steps']}")
    # kernels
    check(launches["spec_verify"] > 0, "the phase launched K1 no time")
    check(launches["spec_verify"] == fused * L, f"K1 launches "
          f"{launches['spec_verify']} != {fused} fused steps x {L}")
    for k in ("tree_verify", "flash_attention", "ssd_scan"):
        check(launches[k] == 0, f"the phase launched {k}")
    check(plain == 0, f"{plain} plain attention calls on the card")
    run_T = {int(k.split(":")[1]) for k in by_T}
    check(kept_T == run_T, f"K1 checked on the phase's own calls at widths "
          f"{sorted(kept_T)}, the phase ran {sorted(run_T)}")
    return out


# ---------------------------------------------------------------------------
# row invariance: the engine path's products (row_gemm) and reductions
# (row_reduce), K1 / K2 at every width, and the cached forward's rows
# ---------------------------------------------------------------------------

ROW_GEMM_SRC = "src/repro_torch/kernels/row_gemm/csrc/row_gemm.cu"
ROW_REDUCE_SRC = "src/repro_torch/kernels/row_reduce/csrc/row_reduce.cu"
# the JAX package computes these with XLA, no Pallas kernel: its sites
LIN_REF = "src/repro/models/common.py:97"
RMS_NORM_REF = "src/repro/models/common.py:102"
LOGSUMEXP_REF = "src/repro/engine/sampling.py:131"
ROW_GEMM_MMA = r"\d(gemm_bf16)ILb([01])E"
# granite-3-8b's products (K, N): the attention's, the MLP's and the tied
# unembedding (W = embed^T, its K contiguous)
ROW_GEMM_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024),
                   "wg": (4096, 12800), "wd": (12800, 4096),
                   "unembed": (4096, 49155)}
# rows of a product: a decode of 8 slots, a mixed chunk of 32 on 8 slots,
# the production prefill; and every row count the invariance is held at
ROW_GEMM_TIME_M = (8, 256, 2048)
ROW_GEMM_CHECK_M = (1, 2, 8, 9, 64, 256, 2048)
# moonshot-v1-16b-a3b's experts: E, d, eff
MOE_EXPERT_SHAPE = (64, 2048, 1408)


def _row_weight(torch, K, N, dtype, seed, k_major=False):
    """A (K, N) weight on the card at 1/sqrt(K), its columns contiguous,
    or (``k_major``) its rows: the transpose of an (N, K) tensor, as the
    tied unembedding's ``embed.T``."""
    (w,) = _normals(torch, seed, "float32", (N, K) if k_major else (K, N))
    w = (w * K ** -0.5).to(getattr(torch, dtype))
    return w.T if k_major else w


def _scale_err(got, want) -> tuple:
    """(max |got - want|, the tensor's scale max(1, max |want|))."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()), max(1.0, float(w.abs().max()))


def row_gemm_check(torch, np) -> list:
    """``row_gemm`` against its plain version at granite-3-8b's product
    shapes (``ROW_GEMM_SHAPES``, K x N; the unembedding's W k-contiguous)
    on 2048 rows, in bf16 and f32, within TOL of the tensor's scale; then
    bitwise: the first M rows of products of M in ``ROW_GEMM_CHECK_M``
    rows equal those of the 2048-row product, a sample of rows computed
    alone (M = 1) equal theirs, and ``x @ W[:, cols]`` equals
    ``(x @ W)[:, cols]`` for tp=2's column halves; the batched form at
    moonshot-v1-16b-a3b's experts (E 64, d 2048, eff 1408: the up and down
    products on the MoE layer's strided views, 8 and 72 tokens against
    each token alone) and the experts' combine ((T, 1, E) x (T, E, d) on a
    transposed view)."""
    from repro_torch.kernels.row_gemm import ops as rg
    from repro_torch.kernels.row_gemm import ref as rg_ref
    out = []
    n0 = dict(rg.launches)
    for dtype in ("bfloat16", "float32"):
        tol = TOL[dtype]
        for i, (name, (K, N)) in enumerate(ROW_GEMM_SHAPES.items()):
            W = _row_weight(torch, K, N, dtype, 40 + i, name == "unembed")
            (A,) = _normals(torch, 60 + i, dtype, (max(ROW_GEMM_CHECK_M), K))
            check(rg.build().row_gemm_splits(int(dtype == "bfloat16"), K)
                  == rg.n_split(A.dtype, K), f"row_gemm: the library's "
                  f"split table and ops.n_split differ at K={K}")
            full = rg.row_gemm(A, W)
            want = rg_ref.row_gemm_ref(A, W)
            err, scale = _scale_err(full, want)
            check(err <= tol * scale, f"row_gemm {name} {dtype}: max|err| "
                  f"{err:.3e} > {tol} x scale {scale:.3e}")
            rows = [r for r in (0, 1, 7, 8, 63, 255, 2047)
                    if r < A.shape[0]]
            alone = {r: rg.row_gemm(A[r:r + 1], W) for r in rows}
            bad = []
            for M in ROW_GEMM_CHECK_M:
                part = rg.row_gemm(A[:M], W)
                if not torch.equal(part, full[:M]):
                    bad.append(f"M={M}")
                bad += [f"row {r} alone vs M={M}" for r in rows
                        if r < M and not torch.equal(part[r:r + 1],
                                                     alone[r])]
            half = N // 2
            for lo, hi in ((0, half), (half, N)):
                Wc = W[:, lo:hi].contiguous()
                for M in (8, 256):
                    if not torch.equal(rg.row_gemm(A[:M], Wc),
                                       full[:M, lo:hi]):
                        bad.append(f"columns [{lo}, {hi}) at M={M}")
            check(not bad, f"row_gemm {name} {dtype} not row-invariant: "
                  f"{bad[:6]}")
            out.append({"shape": f"granite-3-8b/{name}", "dtype": dtype,
                        "K": K, "N": N, "max_abs_err": err, "scale": scale,
                        "row_invariant": True})
            del W, A, full, want, alone
        E, d, eff = MOE_EXPERT_SHAPE
        wg = _row_weight(torch, d, E * eff, dtype, 80)
        wd = (_row_weight(torch, eff, E * d, dtype, 81)
              .reshape(eff, E, d).transpose(0, 1).contiguous())
        (x,) = _normals(torch, 82, dtype, (72, d))
        bad = []
        errs = []
        for T in (8, 72):
            xe = x[:T].expand(E, T, d)
            h = rg.row_bmm(xe, wg.view(d, E, eff).transpose(0, 1))
            y = rg.row_bmm(h, wd)
            for got, want in (
                    (h, rg_ref.row_bmm_ref(xe, wg.view(d, E, eff)
                                           .transpose(0, 1))),
                    (y, rg_ref.row_bmm_ref(h, wd))):
                errs.append(_scale_err(got, want))
            for t in (0, T - 1):
                ht = rg.row_bmm(x[t:t + 1].expand(E, 1, d),
                                wg.view(d, E, eff).transpose(0, 1))
                yt = rg.row_bmm(ht, wd)
                if not (torch.equal(ht, h[:, t:t + 1])
                        and torch.equal(yt, y[:, t:t + 1])):
                    bad.append(f"token {t} of {T}")
        (comb,) = _normals(torch, 83, dtype, (72, 1, E))
        y_all = y.transpose(0, 1)                      # (T, E, d), a view
        mix = rg.row_bmm(comb, y_all)
        errs.append(_scale_err(mix, rg_ref.row_bmm_ref(comb, y_all)))
        if not torch.equal(rg.row_bmm(comb[:8], y_all[:8]), mix[:8]):
            bad.append("the combine at 8 tokens")
        for err, scale in errs:
            check(err <= tol * scale, f"row_bmm {dtype}: max|err| {err:.3e} "
                  f"> {tol} x scale {scale:.3e}")
        check(not bad, f"row_bmm {dtype} not row-invariant: {bad}")
        out.append({"shape": f"{MOE_ARCH}/experts", "dtype": dtype,
                    "max_abs_err": max(e for e, _ in errs),
                    "scale": max(s for _, s in errs),
                    "row_invariant": True})
        del wg, wd, x, h, y, comb, mix
        _free(torch)
    rg.launches.update(n0)
    for c in out:
        log(f"  row_gemm {c['shape']} {c['dtype']}: max|err| "
            f"{c['max_abs_err']:.3e} (scale {c['scale']:.3e}); rows bitwise "
            f"across M {list(ROW_GEMM_CHECK_M)}, alone and column halves")
    return out


def row_reduce_check(torch, np) -> list:
    """``rms_norm`` (granite's d 4096, moonshot's 2048; bf16 and f32) and
    ``logsumexp`` (vocabularies 49155 and 163840, f32) against their
    plain versions within TOL of scale, and bitwise across the call's rows
    (1, 8, 72, 264, 2048 rows against the first 8 alone)."""
    from repro_torch.kernels.row_reduce import ops as rr
    from repro_torch.kernels.row_reduce import ref as rr_ref
    n0 = dict(rr.launches)
    out = []
    for name, d, dtype in (("rms_norm", 4096, "bfloat16"),
                           ("rms_norm", 2048, "bfloat16"),
                           ("rms_norm", 4096, "float32"),
                           ("logsumexp", 49155, "float32"),
                           ("logsumexp", 163840, "float32")):
        (x,) = _normals(torch, 90 + d % 97, dtype, (2048, d))
        if name == "rms_norm":
            (w,) = _normals(torch, 91, "float32", (d,))

            def fn(t):
                return rr.rms_norm(t, w, 1e-5)
            want = rr_ref.rms_norm_ref(x, w, 1e-5)
        else:
            x = x * 4.0

            def fn(t):
                return rr.logsumexp(t)
            want = rr_ref.logsumexp_ref(x)
        full = fn(x)
        err, scale = _scale_err(full, want)
        check(err <= TOL[dtype] * scale, f"{name} d={d} {dtype}: max|err| "
              f"{err:.3e} > {TOL[dtype]} x scale {scale:.3e}")
        bad = [M for M in (1, 8, 72, 264, 2048)
               if not torch.equal(fn(x[:M]), full[:M])]
        bad += [f"row {r} alone" for r in range(8)
                if not torch.equal(fn(x[r:r + 1]), full[r:r + 1])]
        check(not bad, f"{name} d={d} {dtype} not row-invariant: {bad}")
        out.append({"shape": f"{name}/{d}", "dtype": dtype,
                    "max_abs_err": err, "scale": scale,
                    "row_invariant": True})
        log(f"  {name} d={d} {dtype}: max|err| {err:.3e} (scale "
            f"{scale:.3e}); rows bitwise across 1-2048 rows and alone")
        del x, full, want
    rr.launches.update(n0)
    return out


LIBRARY_PROBE_M = (1, 72, 264, 2048)


def library_row_probe(torch, np) -> list:
    """What PyTorch's own operations do with a row as the call's row count
    changes (the cause the row-invariant kernels remove; printed, not
    gated): ``torch.matmul`` (cuBLAS) at granite's wq, wk, wg and the
    tied unembedding, a ``torch.mean``-based RMSNorm and
    ``torch.logsumexp`` over granite's vocabulary: the first 8 rows of
    calls of ``LIBRARY_PROBE_M`` rows (1: each row alone) against the
    same rows of an 8-row call, how many differ and by how much."""
    from repro_torch.kernels.row_reduce.ref import rms_norm_rows
    out = []
    d = ROW_GEMM_SHAPES["wq"][0]
    (x,) = _normals(torch, 97, "bfloat16", (max(LIBRARY_PROBE_M), d))
    (w,) = _normals(torch, 98, "float32", (d,))
    weights = {n: _row_weight(torch, *ROW_GEMM_SHAPES[n], "bfloat16", 40 + i,
                              n == "unembed")
               for i, n in enumerate(ROW_GEMM_SHAPES) if n != "wd"}
    logits = (x.float() @ weights["unembed"].float()) * 0.5
    cases = [(f"torch.matmul {n}", x, lambda t, W=W: t @ W)
             for n, W in weights.items()]
    cases += [("RMSNorm (torch.mean)", x, lambda t: rms_norm_rows(t, w)),
              ("torch.logsumexp", logits,
               lambda t: torch.logsumexp(t, dim=-1))]
    for name, x, fn in cases:
        eight = fn(x[:8])
        rec = {"op": name}
        gap = 0.0
        for M in LIBRARY_PROBE_M:
            got = (torch.cat([fn(x[r:r + 1]) for r in range(8)]) if M == 1
                   else fn(x[:M])[:8])
            rec[f"rows_differing_at_{M}"] = int(
                (got != eight).reshape(8, -1).any(dim=1).sum())
            gap = max(gap, float((got.float() - eight.float()).abs().max()))
        rec["max_gap"] = gap
        out.append(rec)
        log(f"  {name}: of 8 rows, differing from the 8-row call's at "
            + ", ".join(f"{M} rows {rec[f'rows_differing_at_{M}']}"
                        for M in LIBRARY_PROBE_M) + f" (max gap {gap:.3e})")
    return out


def verify_row_check(torch, np) -> list:
    """K1 and K2 through the wrappers at granite-3-8b's heads (S 2048,
    bf16 on the tensor cores, f32 on the CUDA cores in shares of S): each
    batch row's first query, at T in {1, 9, 33, 512} and B in {1, 4, 8},
    bitwise the B = 8, T = 1 call's (K2 with the first query's mask row
    the same in every call, random mask rows after it)."""
    from repro_torch.kernels.spec_verify import ops
    Hq, Hk, D, _ = K1_SHAPES["granite-3-8b"]
    S, Bmax, Tmax = 2048, 8, 512
    n0 = dict(ops.launches)
    out = []
    rng = np.random.default_rng(21)
    live = rng.integers(300, S - Tmax, size=Bmax)
    for dtype in ("bfloat16", "float32"):
        q, k, v = _normals(torch, 23, dtype, (Bmax, Tmax, Hq, D),
                           (Bmax, S, Hk, D), (Bmax, S, Hk, D))
        k_pos = np.full((Bmax, S), -1, np.int32)
        for b in range(Bmax):
            n = int(live[b]) + Tmax
            slots = rng.permutation(S)[:n] if b % 2 else np.arange(n)
            k_pos[b, slots] = np.arange(n)
        kp = torch.from_numpy(k_pos).to("cuda")
        qp = torch.from_numpy((live[:, None] + np.arange(Tmax)[None])
                              .astype(np.int32)).to("cuda")
        tm = torch.from_numpy(rng.random((Bmax, Tmax, S)) < 0.9).to("cuda")
        tm[:, 0] = torch.from_numpy(rng.random((Bmax, S)) < 0.9).to("cuda")
        for name in ("spec_verify", "tree_verify"):
            def call(B, T):
                args = (q[:B, :T].contiguous(), k[:B], v[:B],
                        qp[:B, :T].contiguous(), kp[:B])
                if name == "tree_verify":
                    return ops.tree_verify(*args, tm[:B, :T].contiguous())
                return ops.spec_verify(*args)
            base = call(Bmax, 1)[:, 0]
            bad = [(B, T) for B in (1, 4, 8) for T in (1, 9, 33, Tmax)
                   if not torch.equal(call(B, T)[:, 0], base[:B])]
            route = ops.plan(q.dtype, Bmax, 1, Hq, Hk, D, S)
            check(not bad, f"{name} {dtype} ({route[0]}): a first query "
                  f"differs from the B=8, T=1 call's at (B, T) {bad}")
            out.append({"kernel": name, "dtype": dtype, "route": route[0],
                        "n_split": route[1], "row_invariant": True})
            log(f"  {name} {dtype} ({route[0]}, n_split {route[1]}): each "
                f"row's first query bitwise at B 1/4/8 x T 1/9/33/{Tmax}")
        del q, k, v, tm
    ops.launches.update(n0)
    return out


def probe_forward(torch, cfg, params, tokens, positions, cache, mask=None,
                  library=False) -> list:
    """One cached ``forward`` with the output of every product, norm,
    RoPE, attention and routing call of the stack recorded in order, as
    [(op, tensor)], then the logits and their log-sum-exp.  ``library``:
    with PyTorch's own operations in place of the row-invariant ones
    (``torch.matmul``, ``torch.bmm``, the ``torch.mean`` RMSNorm,
    ``torch.logsumexp``), to name what they change."""
    from repro_torch.kernels.row_reduce import ops as rr
    from repro_torch.kernels.row_reduce.ref import rms_norm_rows
    from repro_torch.models import forward, moe, transformer
    rec, saved = [], []

    def patch(mod, name, fn=None):
        inner = getattr(mod, name)
        use = fn or inner

        def recorded(*a, **kw):
            y = use(*a, **kw)
            # the stack's outputs are laid out (B, T, ...); the MoE layer's
            # flattened (tokens, ...), its experts' products (E, tokens,
            # ...) (their combine, (tokens, 1, E) x (tokens, E, d), not)
            layout = "batched" if mod is transformer else "flat"
            if name == "bmm" and not (a[0].shape[1] == 1 and
                                      a[0].shape[2] == cfg.num_experts):
                layout = "experts"
            rec.append((name, y, layout))
            return y
        saved.append((mod, name, inner))
        setattr(mod, name, recorded)
    lin = (lambda x, w: x @ w.to(x.dtype)) if library else None
    patch(transformer, "lin", lin)
    patch(transformer, "rms_norm", rms_norm_rows if library else None)
    patch(transformer, "apply_rope")
    patch(transformer, "attention")
    patch(moe, "lin", lin)
    patch(moe, "bmm", torch.bmm if library else None)
    patch(moe, "_route")
    try:
        logits, cache, _ = forward(cfg, params, tokens, positions, cache,
                                   token_mask=mask)
    finally:
        for mod, name, inner in reversed(saved):
            setattr(mod, name, inner)
    lf = logits.float()
    rec.append(("logits", logits, "batched"))
    rec.append(("logsumexp", torch.logsumexp(lf, dim=-1) if library
                else rr.logsumexp(lf), "batched"))
    return rec


def _slot_part(t, B, T, rows, keep, layout):
    """The part of an op's output that belongs to batch rows ``rows`` and
    their first ``keep`` positions, in (row, position, ...) order, from
    its ``layout``: "batched" (B, T, ...), "flat" (B * T, ...) or
    "experts" (E, B * T, ...)."""
    if layout == "experts":
        x = t.reshape(t.shape[0], B, T, *t.shape[2:]).movedim(0, 2)
    elif layout == "flat":
        x = t.reshape(B, T, *t.shape[1:])
    else:
        x = t
    check(tuple(x.shape[:2]) == (B, T), f"row probe: a {layout} output "
          f"{tuple(t.shape)} of a forward of {B} x {T}")
    return x[rows, :keep]


def _probe_diffs(torch, a, b, parts_a, parts_b) -> list:
    """Ops of two recorded forwards whose parts differ: (index, op, max
    gap); the two must have run the same ops."""
    check([n for n, _, _ in a] == [n for n, _, _ in b],
          "row probe: the two forwards ran different ops")
    out = []
    for i, ((name, x, ts), (_, y, _)) in enumerate(zip(a, b)):
        xs = x if isinstance(x, tuple) else (x,)
        ys = y if isinstance(y, tuple) else (y,)
        for xt, yt in zip(xs, ys):
            px, py = parts_a(xt, ts), parts_b(yt, ts)
            if not torch.equal(px, py):
                gap = float((px.float() - py.float()).abs().max()) \
                    if px.is_floating_point() else float("nan")
                out.append((i, name, gap))
                break
    return out


def probe_inputs(np, cfg, B: int, seed: int) -> tuple:
    """``row_probe``'s steps as numpy arrays: the prefill (tokens,
    positions, token mask: prompts of 20-99 tokens), then the pending
    token and 8 drafts of each row, and their positions."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 100, size=B)
    T0 = int(lens.max())
    tok = rng.integers(0, cfg.vocab_size, (B, T0)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T0, dtype=np.int32), (B, T0)).copy()
    mask = np.arange(T0)[None] < lens[:, None]
    pending = rng.integers(0, cfg.vocab_size, (B, 9)).astype(np.int32)
    vpos = (lens[:, None] + np.arange(9)[None]).astype(np.int32)
    return tok, pos, mask, pending, vpos


def row_probe(torch, np, cfg, params, device="cuda", B=8, S=256, seed=5,
              library=False) -> dict:
    """The cached forward's rows (``probe_forward``): 8 slots prefilled
    with prompts of 20-100 tokens, then (a) a decode step of the 8 slots
    against each slot's step alone on a copy of its own cache row (rows
    0 and B - 1), and (b) that decode (T = 1) against the first position
    of a verify of 9 tokens from the same state (``probe_inputs``).
    Returns each comparison's differing ops in order ((index, op, max
    gap)), the count of ops recorded and the decode's logits; the
    engine's path must differ in none."""
    from repro_torch.models import forward, init_cache
    from repro_torch.models.transformer import clone_cache
    steps = [torch.from_numpy(x).to(device)
             for x in probe_inputs(np, cfg, B, seed)]
    tok, pos, mask, pending, vpos = steps
    nxt = vpos[:, 0]
    cache = init_cache(cfg, B, S, device=device)
    forward(cfg, params, tok, pos, cache, token_mask=mask)
    dec = probe_forward(torch, cfg, params, pending[:, :1].contiguous(),
                        nxt[:, None].contiguous(), clone_cache(cache),
                        library=library)
    ver = probe_forward(torch, cfg, params, pending, vpos.contiguous(),
                        clone_cache(cache), library=library)
    out = {"ops": len(dec), "logits": dec[-2][1], "verify": _probe_diffs(
        torch, dec, ver,
        lambda t, ts: _slot_part(t, B, 1, slice(None), 1, ts),
        lambda t, ts: _slot_part(t, B, 9, slice(None), 1, ts)),
        "alone": []}
    for b in (0, B - 1):
        one = init_cache(cfg, 1, S, device=device)
        for name, leaf in cache.items():
            bdim = 0 if name == "slot_pos" else 1
            one[name].copy_(leaf.narrow(bdim, b, 1))
        alone = probe_forward(torch, cfg, params,
                              pending[b:b + 1, :1].contiguous(),
                              nxt[b:b + 1, None].contiguous(), one,
                              library=library)
        out["alone"] += [(b, *d) for d in _probe_diffs(
            torch, dec, alone,
            lambda t, ts: _slot_part(t, B, 1, b, 1, ts),
            lambda t, ts: _slot_part(t, 1, 1, 0, 1, ts))]
    return out


def log_row_probe(name, pr, gate=True) -> None:
    """Print a ``row_probe``'s differing ops; with ``gate`` fail on any."""
    for what, key in (("a slot alone against the 8-slot step", "alone"),
                      ("a decode against the first position of a verify "
                       "of 9", "verify")):
        diffs = pr[key]
        log(f"  row probe {name}: {what}: {len(diffs)} of {pr['ops']} "
            f"recorded ops differ" + ("" if not diffs else ": " + ", ".join(
                f"{d[-3]}#{d[-2]} ({d[-1]:.2e})" for d in diffs[:8])))
        if gate:
            check(not diffs, f"row probe {name}: {what}: ops differ "
                  f"{diffs[:8]}")


def _row_gemm_bound_ms(M, K, N, dtype) -> tuple:
    es = 2 if dtype == "bfloat16" else 4
    t_bytes = es * (M * K + K * N + M * N) / HBM_BYTES_PER_S
    t_ops = 2.0 * M * N * K / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def row_gemm_time(torch, np, shapes=None, Ms=ROW_GEMM_TIME_M,
                  iters=30) -> list:
    """``row_gemm`` in bf16 at granite-3-8b's products and the given row
    counts: its time, the plain version's and ``torch.matmul``'s (cuBLAS,
    the yardstick, never called on the engine path), each first held to
    the plain version; the bound (bytes or operations), L2 flushed before
    each call."""
    from repro_torch.kernels.row_gemm import ops as rg
    from repro_torch.kernels.row_gemm import ref as rg_ref
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    n0 = dict(rg.launches)
    out = []
    for i, (name, (K, N)) in enumerate((shapes or ROW_GEMM_SHAPES).items()):
        W = _row_weight(torch, K, N, "bfloat16", 40 + i, name == "unembed")
        for M in Ms:
            (A,) = _normals(torch, 70 + M % 89, "bfloat16", (M, K))
            got = rg.row_gemm(A, W)
            err, scale = _scale_err(got, rg_ref.row_gemm_ref(A, W))
            check(err <= TOL["bfloat16"] * scale,
                  f"row_gemm timing {name} M={M}: max|err| {err:.3e}")
            t = _time_rounds(torch, lambda: rg.row_gemm(A, W), iters,
                             scratch.zero_)
            lib = _time_rounds(torch, lambda: torch.matmul(A, W), iters,
                               scratch.zero_)
            plain = _time_ms(torch, lambda: rg_ref.row_gemm_ref(A, W),
                             max(iters // 5, 5), scratch.zero_)
            bound_ms, bound_by = _row_gemm_bound_ms(M, K, N, "bfloat16")
            out.append({"shape": name, "M": M, "K": K, "N": N,
                        "n_split": rg.n_split(torch.bfloat16, K),
                        "ms": t["median"], "ms_spread": t,
                        "library_ms": lib["median"], "library_spread": lib,
                        "plain_ms": plain, "bound_ms": bound_ms,
                        "bound_by": bound_by, "max_abs_err": err})
            tm = out[-1]
            log(f"  row_gemm timing {name} M={M} K={K} N={N} bf16 (n_split "
                f"{tm['n_split']}): {_spread(t)} ms; torch.matmul (cuBLAS) "
                f"{_spread(lib)} ms; plain {plain:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / tm['ms']:.3f} "
                f"of it")
            del A, got
        del W
    rg.launches.update(n0)
    return out


def row_reduce_time(torch, np, M, iters=50) -> dict:
    """``rms_norm`` at (M, 4096) bf16 and ``logsumexp`` at (M, 49155) f32
    (granite's), each beside its plain version and one PyTorch call
    (``torch.nn.functional.rms_norm``, ``torch.logsumexp``), bound by
    bytes, L2 flushed before each."""
    import torch.nn.functional as F
    from repro_torch.kernels.row_reduce import ops as rr
    from repro_torch.kernels.row_reduce import ref as rr_ref
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    n0 = dict(rr.launches)
    (x,) = _normals(torch, 99, "bfloat16", (M, 4096))
    (w,) = _normals(torch, 91, "float32", (4096,))
    (lg,) = _normals(torch, 100, "float32", (M, 49155))
    out = {}
    for name, fn, plain, lib, nbytes in (
            ("rms_norm", lambda: rr.rms_norm(x, w),
             lambda: rr_ref.rms_norm_ref(x, w),
             (lambda: F.rms_norm(x, (4096,), w.to(x.dtype), 1e-5))
             if hasattr(F, "rms_norm") else None, 4 * M * 4096 + 4 * 4096),
            ("logsumexp", lambda: rr.logsumexp(lg),
             lambda: rr_ref.logsumexp_ref(lg),
             lambda: torch.logsumexp(lg, dim=-1), 4 * M * 49155 + 4 * M)):
        err, scale = _scale_err(fn(), plain())
        check(err <= 3e-2 * scale, f"{name} timing: max|err| {err:.3e}")
        t = _time_rounds(torch, fn, iters, scratch.zero_)
        lt = _time_ms(torch, lib, iters, scratch.zero_) if lib else None
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        out[name] = {"M": M, "ms": t["median"], "ms_spread": t,
                     "plain_ms": _time_ms(torch, plain, iters,
                                          scratch.zero_),
                     "library_ms": lt, "bound_ms": bound_ms,
                     "bound_by": "bytes", "max_abs_err": err}
        r = out[name]
        log(f"  {name} timing M={M}: {_spread(t)} ms; plain "
            f"{r['plain_ms']:.4f} ms; library "
            + (f"{lt:.4f}" if lt is not None else "none") + f" ms; bound "
            f"{bound_ms:.4f} ms (bytes)")
    rr.launches.update(n0)
    return out


# ---------------------------------------------------------------------------
# phase 14: tensor parallel
# ---------------------------------------------------------------------------

# the engine's tensor parallelism on the one card: tp = 1 (a one-rank
# group) and tp = 2 (two ranks sharing the card, over gloo, named so in
# the launch: NCCL refuses two ranks on one device).  Each model at full
# width and a cut depth, so that the earlier phases keep theirs: every
# gather of a card tensor over gloo waits for the card and goes through
# host memory, and at 40 granite layers (80 gathers a step) one tp=2
# rollout took 42.5-46.7 s and the phase 271.6 s on an NVIDIA H100 80GB
# HBM3 at 700 W.  granite-3-8b at TP_GRANITE_LAYERS of its 40 layers,
# moonshot-v1-16b-a3b at 3 of 48 (one dense, two MoE: its MoE loop still
# runs twice; each tp=2 pass of 4 layers took ~36 s on a slow host),
# zamba2-1.2b at its CUT_LAYERS depth; caches of 2048 positions
# (moonshot 1024); 4 groups x 4, 64 new tokens, bf16, two tp=2 passes of
# each (the repeat gate); then granite at TP_F32_LAYERS in f32 (TF32 off),
# 32 new tokens.  Granite's 4 layers became 2 when the data axis's stage
# joined the production phase, which runs at this depth too
TP = 2
TP_GROUPS, TP_NEW_TOKENS = 4, 64
TP_GRANITE_LAYERS = 2
TP_MODELS = (("granite-3-8b", TP_GRANITE_LAYERS, 2048),
             (MOE_ARCH, 3, MOE_CACHE_LEN),
             ("zamba2-1.2b", CUT_LAYERS["zamba2-1.2b"], 2048))
TP_F32_LAYERS, TP_F32_NEW_TOKENS = TP_GRANITE_LAYERS, 32
# the card both ranks run on
TP_DEVICE = "cuda:0"
NOT_A_SPEED = ("two ranks sharing one card over gloo (every collective "
               "staged through host memory) are no measure of tensor "
               "parallelism's speed")


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _tp_params(torch, cfg, sctx):
    """``cfg``'s random weights from seed 0 — the same draws at every tp
    — whole, or this rank's shard cut layer by layer as they are drawn
    (``init_params(sctx=)``)."""
    from repro_torch.models import init_params
    gen = torch.Generator(device=TP_DEVICE)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=TP_DEVICE, sctx=sctx)
    torch.cuda.synchronize()
    return params


@contextlib.contextmanager
def _schedule_of(tp):
    """Rollouts built inside take the cost model of tensor-parallel degree
    ``tp`` whatever their own.  ``SeerRollout(tp=k)`` models its steps
    with ``ForwardCostModel(tp=k)``, as the reference does, and the draft
    budgets (MBA), and with them the engine's batches and their GEMMs'
    row counts, follow that model: a one-device rollout under tp=k's
    model runs tp=k's schedule, the oracle of a tp=k pass whose products
    are the one-device ones (``ColumnProducts``)."""
    from repro_torch.core import rollout
    inner = rollout.ForwardCostModel
    rollout.ForwardCostModel = lambda cfg, hw, **_: inner(cfg, hw, tp=tp)
    try:
        yield
    finally:
        rollout.ForwardCostModel = inner


def tp_run(torch, cfg, params, prompts, tp, cache_len, new_tokens=None,
           warm=False, cols=None, schedule_tp=None, **kw) -> dict:
    """``run_rollout`` of the phase's traffic on a ``SeerRollout(tp=tp)``,
    with the collectives it ran (``sharding.traffic``) and each
    instance's lockstep record (host uploads compared across the group,
    their running digest); ``warm``: after a first pass on the same
    rollout (its group suffix trees then draft), as the tree slice;
    ``cols`` (a ``ColumnProducts``): every column-parallel product sliced
    from the unsharded one (``sliced_products`` counts them);
    ``schedule_tp``: under that degree's cost model (``_schedule_of``)."""
    from repro_torch import sharding
    with (_schedule_of(schedule_tp) if schedule_tp is not None
          else contextlib.nullcontext()):
        ro = make_rollout(cfg, params, cache_len=cache_len, tp=tp,
                          device=TP_DEVICE, **kw)
    if warm:
        run_rollout(torch, ro, prompts, new_tokens=new_tokens or
                    TP_NEW_TOKENS)
        ro.reset_acceptance_profile()
    sharding.reset_traffic()
    with (cols.installed(sliced=True) if cols is not None
          else contextlib.nullcontext()):
        n0 = cols.calls if cols is not None else 0
        r = run_rollout(torch, ro, prompts,
                        new_tokens=new_tokens or TP_NEW_TOKENS)
        r["sliced_products"] = cols.calls - n0 if cols is not None else 0
    r["traffic"] = dict(sharding.traffic)
    r["lockstep"] = [(i.lockstep_checks, i.lockstep_digest)
                     for i in ro.instances]
    del ro
    _free(torch)
    return r


class ColumnProducts:
    """The column-parallel products of a dense model's sharded forward
    (``wq``, ``wk``, ``wv``, ``wg`` and ``wu`` of each layer), while
    installed as ``transformer.lin`` (``installed``): each is computed as
    the rank runs it, ``x @ W[:, cols]`` on its shard, and as the same
    columns of the unsharded product ``x @ W`` on the same x
    (``steps.param_shard`` of the product).  ``sliced`` hands the
    forward the latter, so that every other piece of the sharded path
    (the gathers' order, the head and K/V shards, K1 / K2 on them with the
    unsharded split, sampling) meets the one-device path's inputs and
    must give its bits; ``record`` keeps both products of each call for
    ``product_gaps``."""

    def __init__(self, cfg, whole: dict, mine: dict, sctx):
        self.cfg, self.sctx = cfg, sctx
        self.leaves = {}
        for i, (lw, lm) in enumerate(zip(whole["layers"], mine["layers"])):
            for blk, names in (("attn", ("wq", "wk", "wv")),
                               ("mlp", ("wg", "wu"))):
                for n in names:
                    if lm[blk][n].shape != lw[blk][n].shape:
                        self.leaves[id(lm[blk][n])] = (i, blk, n,
                                                       lw[blk][n])
        check(len(self.leaves) == 5 * len(whole["layers"]),
              f"ColumnProducts: {len(self.leaves)} sharded column leaves "
              f"for {len(whole['layers'])} layers")
        self.sliced = self.record = False
        self.width, self.calls, self.records = 0, 0, []

    def lin(self, x, w):
        from repro_torch.launch.steps import param_shard
        from repro_torch.models.common import lin
        hit = self.leaves.get(id(w))
        if hit is None:
            return lin(x, w)
        layer, blk, name, whole = hit
        y = lin(x, whole)
        cut = param_shard(self.cfg, blk, name, y.reshape(-1, y.shape[-1]),
                          self.sctx).reshape(*y.shape[:-1], -1)
        own = lin(x, w) if self.record or not self.sliced else None
        if self.record:
            self.records.append((self.width, layer, name, x.shape, own, cut))
        self.calls += self.sliced
        return cut if self.sliced else own

    @contextlib.contextmanager
    def installed(self, sliced: bool, record: bool = False):
        from repro_torch.models import transformer
        inner = transformer.lin
        self.sliced, self.record = sliced, record
        transformer.lin = self.lin
        try:
            yield self
        finally:
            transformer.lin = inner
            self.sliced = self.record = False

    def product_gaps(self, torch) -> list:
        """Each recorded call: the rank's product against the same
        columns of the unsharded one, bitwise or by how much."""
        out = []
        for T, layer, name, xs, own, cut in self.records:
            same = bool(torch.equal(own, cut))
            out.append({"T": T, "layer": layer, "weight": name,
                        "M": int(math.prod(xs[:-1])), "K": int(xs[-1]),
                        "N": int(own.shape[-1]), "equal": same,
                        "max_gap": 0.0 if same else
                        float((own.float() - cut.float()).abs().max())})
        self.records.clear()
        return out


def tp_probe(torch, np, cfg, params, sctx, cols=None) -> list:
    """Every activation the exact layers gather (``sharding.whole_columns``:
    o before ``wo``, h before ``wd``, vocab-split logits) and the logits,
    of a 16-token prefill chunk and a decode step on 8 seeded rows, as
    (step width T, kind, layer, tensor on the host); at tp=None the same
    call sites see the whole activations.  ``cols``: the installed
    ``ColumnProducts``, told each forward's width."""
    from repro_torch import sharding
    from repro_torch.models import forward, init_cache
    rec = []
    inner = sharding.whole_columns
    width = [0]

    def recording(t, full, sctx_):
        out = inner(t, full, sctx_)
        kind = "o" if full == cfg.num_heads * cfg.head_dim else \
            "h" if full == cfg.d_ff else "logits"
        layer = sum(w == width[0] and k == kind for w, k, _, _ in rec)
        rec.append((width[0], kind, layer, out.detach().float().cpu()))
        return out
    rng = np.random.default_rng(5)
    B = 8
    cache = init_cache(cfg, B, 256, device=TP_DEVICE, sctx=sctx)
    sharding.whole_columns = recording
    try:
        for T, start in ((16, 0), (1, 16)):
            width[0] = T
            if cols is not None:
                cols.width = T
            tok = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, T)).astype(np.int32)).to(TP_DEVICE)
            pos = (start + torch.arange(T, dtype=torch.int32)).expand(
                B, T).contiguous().to(TP_DEVICE)
            logits, cache, _ = forward(cfg, params, tok, pos, cache,
                                       sctx=sctx)
            rec.append((T, "final logits", cfg.num_layers,
                        logits.float().cpu()))
    finally:
        sharding.whole_columns = inner
    return rec


def _probe_gaps(torch, want: list, got: list) -> list:
    """``tp_probe`` records side by side: each activation bitwise equal
    to the one-device path's, or its largest gap."""
    check(len(want) == len(got), f"tp probe: {len(got)} activations "
          f"gathered, the one-device path {len(want)}")
    return [{"T": T, "kind": k, "layer": i, "shape": list(a.shape),
             "equal": bool(torch.equal(a, b)),
             "max_gap": float((a - b).abs().max())}
            for (T, k, i, a), (_, _, _, b) in zip(want, got)]


def _tp_model(torch, np, rank, arch, layers, cache_len) -> dict:
    """One model's runs on this rank: tp=None and tp=1 on rank 0 alone
    (the whole weights; the other rank waits), then tp=2 twice on both
    ranks (the repeat must be bitwise); a dense
    model (granite) also a tree pass and a pass with every column product
    sliced from the unsharded one (``ColumnProducts``; every rank holds
    the whole weights for it), and on rank 0 its oracle, tp=None under
    tp=2's schedule (``_schedule_of``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import engine_group
    cfg = _arch_cfg(arch, layers)
    dense = cfg.arch_type == "dense"
    prompts = make_prompts(np, cfg, TP_GROUPS, seed=1)
    runs = {}
    t0 = time.perf_counter()
    whole = _tp_params(torch, cfg, None) if rank == 0 or dense else None
    if rank == 0:
        for tp in (None, 1):
            runs[tp] = tp_run(torch, cfg, whole, prompts, tp, cache_len)
        if dense:
            runs["oracle"] = tp_run(torch, cfg, whole, prompts, None,
                                    cache_len, schedule_tp=TP)
    if not dense:
        whole = None
        _free(torch)
    dist.barrier()
    sctx = engine_group(TP)
    runs["params_s"] = -time.perf_counter()
    params = _tp_params(torch, cfg, sctx)
    runs["params_s"] += time.perf_counter()
    runs["shard_gb"] = sum(w.numel() * w.element_size()
                           for w in _tensors(params)) / 1e9
    runs[TP] = [tp_run(torch, cfg, params, prompts, TP, cache_len)
                for _ in range(2)]
    if dense:
        runs["tree"] = tp_run(torch, cfg, params, prompts, TP, cache_len,
                              warm=True, spec_mode="tree", multipath_top_k=3)
        runs["sliced"] = tp_run(torch, cfg, params, prompts, TP, cache_len,
                                cols=ColumnProducts(cfg, whole, params, sctx))
    del params, whole
    _free(torch)
    runs["wall_s"] = time.perf_counter() - t0
    return runs


def _tp_f32(torch, np, rank) -> dict:
    """granite-3-8b at full width and TP_F32_LAYERS layers in f32: the
    rollout and ``tp_probe`` at tp=None (rank 0; the rollout also under
    tp=2's schedule) and at tp=2, each tp=2 one also with every column
    product sliced from the unsharded one (``ColumnProducts``); rank 0
    compares the probes with tp=None's, every rank its own column
    products with the unsharded ones."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.launch.mesh import engine_group
    cfg = dataclasses.replace(_arch_cfg("granite-3-8b", TP_F32_LAYERS),
                              dtype="float32")
    prompts = make_prompts(np, cfg, TP_GROUPS, seed=1)
    out = {}
    whole = _tp_params(torch, cfg, None)
    if rank == 0:
        out["none"] = tp_run(torch, cfg, whole, prompts, None, 2048,
                             new_tokens=TP_F32_NEW_TOKENS)
        out["oracle"] = tp_run(torch, cfg, whole, prompts, None, 2048,
                               new_tokens=TP_F32_NEW_TOKENS, schedule_tp=TP)
        oracle = tp_probe(torch, np, cfg, whole, None)
    dist.barrier()
    sctx = engine_group(TP)
    mine = _tp_params(torch, cfg, sctx)
    cols = ColumnProducts(cfg, whole, mine, sctx)
    out["two"] = tp_run(torch, cfg, mine, prompts, TP, 2048,
                        new_tokens=TP_F32_NEW_TOKENS)
    out["sliced"] = tp_run(torch, cfg, mine, prompts, TP, 2048,
                           new_tokens=TP_F32_NEW_TOKENS, cols=cols)
    with cols.installed(sliced=False, record=True):
        own = tp_probe(torch, np, cfg, mine, sctx, cols)
    out["products"] = cols.product_gaps(torch)
    with cols.installed(sliced=True):
        sliced = tp_probe(torch, np, cfg, mine, sctx, cols)
    if rank == 0:
        out["probe"] = _probe_gaps(torch, oracle, own)
        out["sliced_probe"] = _probe_gaps(torch, oracle, sliced)
    del whole, mine, cols
    _free(torch)
    return out


def tp_rank(rank: int, world: int, device, out_dir: str) -> None:
    """One rank of the tensor-parallel phase, started by ``tp_phase``
    through ``repro_torch.launch.mesh.spawn`` (gloo, both ranks on the
    card); writes what it saw to ``out_dir/rank{rank}.pkl``."""
    import pickle

    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "models": {}}
    for arch, layers, cache_len in TP_MODELS:
        out["models"][arch] = _tp_model(torch, np, rank, arch, layers,
                                        cache_len)
    out["f32"] = _tp_f32(torch, np, rank)
    # each rollout's peak (``run_rollout`` resets the counter before it)
    runs = [r for m in out["models"].values() for k, r in m.items()
            if k in (None, 1, "tree", "sliced", "oracle")]
    runs += [r for m in out["models"].values() for r in m[TP]]
    runs += [r for k, r in out["f32"].items()
             if k in ("none", "two", "sliced", "oracle")]
    out["peak_mem_gb"] = max(r["peak_mem_gb"] for r in runs)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _tp_shards(Hq, Hk):
    from repro_torch.sharding import head_shard
    return [head_shard(Hq, Hk, TP, r) for r in range(TP)]


def tp_kernels_check(torch, np, widths: dict, tree_widths) -> list:
    """K1 at the phase's shard shapes: at every width each model's tp=2
    runs used, each rank's heads through the wrapper with ``split_like``
    (the unsharded n_split) equal those heads of the unsharded call,
    bitwise; the shard shape also held to the plain version on both
    routes (``_k1_case``).  K2 the same at the granite tree pass's
    widths.  bf16, B = 8, the models' caches, permuted slots, an empty
    row and a blind query."""
    from repro_torch.kernels.spec_verify import ops
    rows = []
    for arch, (Hq, Hk, D, window), S in (
            ("granite-3-8b", K1_SHAPES["granite-3-8b"], 2048),
            (MOE_ARCH, K1_SHAPES[MOE_ARCH], MOE_CACHE_LEN),
            ("zamba2-1.2b", K1_SHAPES["zamba2-1.2b"], 2048)):
        shards = _tp_shards(Hq, Hk)
        for T in sorted(widths[arch]):
            q, k, v, qp, kp = _sv_inputs(torch, np, B=8, T=T, S=S, Hq=Hq,
                                         Hk=Hk, D=D, dtype="bfloat16",
                                         seed=300 + T, live=None)
            whole = ops.spec_verify(q, k, v, qp, kp, window=window)
            for r, hs in enumerate(shards):
                qs = q[:, :, hs.q_lo:hs.q_hi].contiguous()
                ks = k[:, :, hs.kv_lo:hs.kv_hi].contiguous()
                vs = v[:, :, hs.kv_lo:hs.kv_hi].contiguous()
                part = _no_sync(torch, lambda: ops.spec_verify(
                    qs, ks, vs, qp, kp, window=window, split_like=(Hq, Hk)))
                check(torch.equal(part, whole[:, :, hs.q_lo:hs.q_hi]),
                      f"spec_verify {arch} T={T}: rank {r}'s heads with the "
                      "unsharded split differ from the unsharded call's")
            row = _k1_case(torch, f"{arch}/tp{TP}", qs, ks, vs, qp, kp,
                           window, empty_rows=True,
                           note=f"rank {TP - 1}'s heads of {Hq}/{Hk}; every "
                           "rank's heads bitwise the unsharded call's")
            row["bitwise_shards"] = True
            rows.append(row)
    from repro_torch.kernels.spec_verify.ref import tree_verify_ref
    Hq, Hk, D, _ = K1_SHAPES["granite-3-8b"]
    for T in sorted(tree_widths):
        q, k, v, qp, kp, tm = _tree_inputs(torch, np, B=8, T=T, S=2048,
                                           Hq=Hq, Hk=Hk, D=D,
                                           dtype="bfloat16", seed=400 + T)
        whole = ops.tree_verify(q, k, v, qp, kp, tm)
        err = 0.0
        for r, hs in enumerate(_tp_shards(Hq, Hk)):
            qs = q[:, :, hs.q_lo:hs.q_hi].contiguous()
            ks = k[:, :, hs.kv_lo:hs.kv_hi].contiguous()
            vs = v[:, :, hs.kv_lo:hs.kv_hi].contiguous()
            part = _no_sync(torch, lambda: ops.tree_verify(
                qs, ks, vs, qp, kp, tm, split_like=(Hq, Hk)))
            check(torch.equal(part, whole[:, :, hs.q_lo:hs.q_hi]),
                  f"tree_verify T={T}: rank {r}'s heads differ from the "
                  "unsharded call's")
            ref = tree_verify_ref(qs, ks, vs, qp, kp, tm)
            err = max(err, float((part.float() - ref.float()).abs().max()))
            check(bool(torch.allclose(part.float(), ref.float(),
                                      atol=TOL["bfloat16"],
                                      rtol=TOL["bfloat16"])),
                  f"tree_verify granite-3-8b/tp{TP} T={T}: rank {r}'s heads "
                  f"disagree with the plain version, max|err|={err}")
        rows.append({"shape": f"granite-3-8b/tp{TP}/tree", "T": T,
                     "Hq": Hq // TP, "Hk": Hk // TP, "D": D,
                     "bitwise_shards": True, "max_abs_err": err})
        log(f"  tree_verify granite-3-8b/tp{TP} T={T}: each rank's heads "
            f"with the unsharded split bitwise the unsharded call's; "
            f"max|err| against the plain version {err:.3e} (tol "
            f"{TOL['bfloat16']})")
    return rows


def _differing(a: dict, b: dict) -> dict:
    """Requests whose responses differ: req -> first differing position."""
    out = {}
    for rid, want in a.items():
        got = b.get(rid, [])
        if got != want:
            out[rid] = next((j for j, (x, y) in enumerate(zip(want, got))
                             if x != y), min(len(want), len(got)))
    return out


def _tp_gates(name, cfg, runs0, runs1, new_tokens, dense=False) -> dict:
    """The hard gates of one model's runs (rank 0's and rank 1's): tp=1
    bitwise tp=None (tokens, logprobs, engine steps, host syncs); each
    rank's tp=2 repeat bitwise; both ranks the same
    tokens, logprobs and lockstep digests; one host sync per engine step
    on each rank; every request's full length; the kernels per forward as
    on one device.  A dense model's pass with the column products sliced
    from the unsharded ones (``ColumnProducts``) must equal its oracle,
    tp=None under tp=2's schedule, bitwise: what remains between tp=2 and
    that oracle is then cuBLAS's."""
    none, one = runs0[None], runs0[1]
    for key in ("responses", "logprobs", "fused_steps", "host_syncs",
                "by_kind", "launches", "replays"):
        check(one[key] == none[key], f"tp {name}: tp=1 and tp=None differ "
              f"in {key}")
    extra = ("tree", "sliced") if dense else ()
    for rank, runs in enumerate((runs0, runs1)):
        first, again = runs[TP]
        for key in ("responses", "logprobs", "fused_steps", "launches",
                    "replays", "lockstep"):
            check(again[key] == first[key], f"tp {name}: rank {rank}'s "
                  f"tp={TP} repeat differs in {key}")
        for r_ in runs[TP] + [runs[k] for k in extra]:
            check(r_["host_syncs"] == r_["fused_steps"], f"tp {name}: rank "
                  f"{rank}: host syncs {r_['host_syncs']} != engine steps "
                  f"{r_['fused_steps']}")
            check(all(c > 0 for c, _ in r_["lockstep"]), f"tp {name}: an "
                  "instance compared no host batch across the ranks")
        rec_rollout_checks(first, cfg, f"tp {name} rank {rank}")
    for key in ("responses", "logprobs", "fused_steps", "lockstep"):
        check(runs0[TP][0][key] == runs1[TP][0][key], f"tp {name}: the "
              f"ranks differ in {key}")
    a, b = runs0[TP][0], runs1[TP][0]
    lost = sum(sum(x != y for x, y in zip(a["responses"][rid], got))
               + abs(len(a["responses"][rid]) - len(got))
               for rid, got in b["responses"].items())
    short = sum(new_tokens - len(x) for x in a["responses"].values())
    check(lost == 0 and short == 0, f"tp {name}: tokens_lost {lost}, "
          f"{short} tokens short of the requests' lengths")
    if dense:
        _sliced_gates(f"tp {name}", runs0["oracle"],
                      [runs0["sliced"], runs1["sliced"]])
    return {"tokens_lost": lost, "short": short}


def _sliced_gates(name, oracle, sliced) -> None:
    """Each rank's pass with the one-device column products
    (``ColumnProducts``) bitwise its oracle, tp=None under tp=2's schedule:
    tokens, logprobs, engine steps by width, launches, host syncs."""
    for rank, sl in enumerate(sliced):
        check(sl["sliced_products"] > 0, f"{name}: rank {rank}'s sliced "
              "pass sliced no product")
        for key in ("responses", "logprobs", "fused_steps", "by_kind",
                    "launches", "host_syncs"):
            check(sl[key] == oracle[key], f"{name}: rank {rank}'s tp={TP} "
                  f"pass with the unsharded products' columns differs from "
                  f"tp=None under tp={TP}'s schedule in {key}: the port's "
                  "own fault")


def _equal_responses(a: dict, b: dict) -> int:
    return len(a["responses"]) - len(_differing(a["responses"],
                                                b["responses"]))


def _feeds(p: dict, act: dict) -> bool:
    """Whether column product ``p`` of ``tp_probe``'s forwards (a
    prefill chunk, then a decode step on its cache) feeds the gathered
    activation ``act``: a product of an earlier layer, or of ``act``'s
    own (only ``wq`` / ``wk`` / ``wv`` for an attention output o); for the
    decode step also, through the cache, the prefill's products of the
    earlier layers and its ``wk`` / ``wv`` of ``act``'s own."""
    if p["T"] != act["T"]:
        return p["T"] > act["T"] and (p["layer"] < act["layer"] or (
            p["layer"] == act["layer"] and p["weight"] in ("wk", "wv")))
    if p["layer"] != act["layer"] or act["kind"] != "o":
        return p["layer"] <= act["layer"]
    return p["weight"] in ("wq", "wk", "wv")


def _product_summary(products: list) -> dict:
    """Column products by (T, weight): calls, how many are not bitwise
    and the largest gap."""
    out = {}
    for p in products:
        s = out.setdefault(f"T={p['T']} {p['weight']} M={p['M']} K={p['K']}"
                           f" N={p['N']}", {"calls": 0, "not_bitwise": 0,
                                            "max_gap": 0.0})
        s["calls"] += 1
        s["not_bitwise"] += not p["equal"]
        s["max_gap"] = max(s["max_gap"], p["max_gap"])
    return out


def tp_phase(torch, np) -> dict:
    """The engine's tensor parallelism on the card: ``tp_rank`` in two
    gloo ranks on cuda:0 (the parent's models freed first; every kernel
    library already built, so no rank builds), then, in this process,
    the gates (``_tp_gates``), K1 / K2 at the shard shapes
    (``tp_kernels_check``), the bf16 and f32 comparisons of tp=2 with
    tp=None, and the K1 / K2 timings at the shard shapes.  The engine
    path's products are row- and column-invariant (``row_gemm``), so
    granite's tp=2 rollouts, bf16 and f32, must equal tp=None run under
    tp=2's cost model (``_schedule_of``) in every response, each rank's
    column products the unsharded product's columns on the same input
    bitwise, and the f32 probe's gathered activations tp=None's bitwise;
    the passes with every column product sliced from the unsharded one
    (``ColumnProducts``) must equal that oracle bitwise too.  tp's
    schedule itself (its cost model changes MBA's budgets and so the
    batches) and the MoE and hybrid models are printed, not gated."""
    import pickle
    import tempfile

    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    ranks = []
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        spawn(tp_rank, TP, backend="gloo", device=TP_DEVICE, args=(tmp,))
        for r in range(TP):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    rep = {"ranks_wall_s": time.perf_counter() - t0, "models": {},
           "peak_mem_gb": [x["peak_mem_gb"] for x in ranks]}
    widths, tree_widths = {}, set()
    for arch, layers, cache_len in TP_MODELS:
        cfg = _arch_cfg(arch, layers)
        dense = cfg.arch_type == "dense"
        r0, r1 = (x["models"][arch] for x in ranks)
        gates = _tp_gates(arch, cfg, r0, r1, TP_NEW_TOKENS, dense=dense)
        none, two = r0[None], r0[TP][0]
        diff = _differing(none["responses"], two["responses"])
        widths[arch] = {int(k.split(":")[1]) for k in two["by_kind"]}
        m = {"layers": cfg.num_layers, "requests": len(none["responses"]),
             "tokens": two["stats"].tokens, "fused_steps": two["fused_steps"],
             "k1_launches": two["launches"]["spec_verify"],
             "k4_launches": two["launches"]["ssd_scan"],
             "by_kind": two["by_kind"], "host_syncs": two["host_syncs"],
             "wall_s": {"none": none["wall_s"], "one": r0[1]["wall_s"],
                        "two": [[x["wall_s"] for x in r_[TP]]
                                for r_ in (r0, r1)]},
             "traffic": two["traffic"], "shard_gb": [r0["shard_gb"],
                                                     r1["shard_gb"]],
             "bf16_responses_equal_to_tp_none":
                 len(none["responses"]) - len(diff),
             "bf16_first_difference": diff, **gates,
             "model_wall_s": [r0["wall_s"], r1["wall_s"]]}
        steps_ = two["fused_steps"]
        log(f"  {arch} ({cfg.num_layers} layers, full width): tp=1 bitwise "
            f"tp=None (tokens, logprobs, {r0[1]['fused_steps']} engine "
            f"steps, host syncs); tp={TP} repeat bitwise on both ranks, "
            f"ranks equal, 1 host sync a step, tokens_lost 0; "
            f"{steps_} engine steps, K1 {m['k1_launches']}"
            + (f", K4 {m['k4_launches']}" if m["k4_launches"] else "")
            + f" launches a rank; shard {r0['shard_gb']:.1f} GB a rank")
        log(f"    walls: tp=None {none['wall_s']:.1f} s, tp=1 "
            f"{r0[1]['wall_s']:.1f} s, tp={TP} ranks {m['wall_s']['two']} "
            f"s; collectives a step {two['traffic']['all_gather'] / steps_:.1f}"
            f" gathers, {two['traffic']['all_gather_bytes'] / steps_ / 1e6:.3f}"
            f" MB sent a rank, {two['traffic']['lockstep'] / steps_:.1f} "
            f"lockstep digests — {NOT_A_SPEED}")
        log(f"    bf16: tp={TP} responses equal to tp=None "
            f"{m['bf16_responses_equal_to_tp_none']}/{m['requests']}"
            + (f"; first differing positions {sorted(diff.values())}"
               if diff else ""))
        if dense:
            sl, orc = r0["sliced"], r0["oracle"]
            m["same_schedule"] = {
                "oracle_fused_steps": orc["fused_steps"],
                "tp_none_fused_steps": none["fused_steps"],
                "oracle_responses_equal_to_tp_none":
                    _equal_responses(none, orc),
                "tp2_responses_equal_to_oracle": _equal_responses(orc, two),
                "sliced_equal_to_oracle": True,
                "sliced_products": sl["sliced_products"],
                "wall_s": sl["wall_s"]}
            s_ = m["same_schedule"]
            check(s_["tp2_responses_equal_to_oracle"] == m["requests"],
                  f"tp {arch} bf16: tp={TP} equals tp=None under its "
                  f"schedule in {s_['tp2_responses_equal_to_oracle']} of "
                  f"{m['requests']} responses")
            log(f"    tp={TP}'s cost model changes the draft budgets and so "
                f"the batches: tp=None under tp={TP}'s schedule "
                f"{orc['fused_steps']} engine steps (tp=None "
                f"{none['fused_steps']}), responses equal to tp=None's "
                f"{s_['oracle_responses_equal_to_tp_none']}/{m['requests']};"
                f" tp={TP} equal to it {s_['tp2_responses_equal_to_oracle']}"
                f"/{m['requests']}; with the unsharded products' columns "
                f"({sl['sliced_products']} column products a rank) tp={TP} "
                f"is it bitwise (tokens, logprobs, steps by width, launches,"
                f" host syncs) on both ranks")
            tr = r0["tree"]
            check(tr["finished"], "tp tree pass: not every group finished")
            check(tr["launches"]["tree_verify"] == tr["fused_steps"]
                  * cfg.num_layers and tr["launches"]["spec_verify"] == 0,
                  f"tp tree pass: launches {tr['launches']} for "
                  f"{tr['fused_steps']} steps x {cfg.num_layers} layers")
            check(tr["launches"] == r1["tree"]["launches"] and
                  tr["responses"] == r1["tree"]["responses"],
                  "tp tree pass: the ranks differ")
            check(tr["stats"].accepted > 0, "tp tree pass: no draft "
                  "accepted")
            tree_widths = {int(k.split(":")[1]) for k in tr["by_kind"]}
            m["tree"] = {"fused_steps": tr["fused_steps"],
                         "k2_launches": tr["launches"]["tree_verify"],
                         "accepted": tr["stats"].accepted,
                         "tree_branch_nodes": tr["tree_branch_nodes"],
                         "by_kind": tr["by_kind"], "wall_s": tr["wall_s"]}
            log(f"    tree pass (tp={TP}, 3 paths, after a warm pass): "
                f"{tr['fused_steps']} "
                f"engine steps, K2 {tr['launches']['tree_verify']} launches"
                f" a rank, accepted {tr['stats'].accepted}, branching nodes "
                f"{tr['tree_branch_nodes']}, 1 host sync a step, ranks equal")
        rep["models"][arch] = m

    log(f"  K1 / K2 at the shard shapes against the unsharded call")
    rep["kernel_checks"] = tp_kernels_check(torch, np, widths, tree_widths)

    f0 = ranks[0]["f32"]
    none, two, sl, orc = f0["none"], f0["two"], f0["sliced"], f0["oracle"]
    check(two["responses"] == ranks[1]["f32"]["two"]["responses"],
          "tp f32: the ranks differ")
    _sliced_gates("tp f32", orc, [x["f32"]["sliced"] for x in ranks])
    sliced_bad = [p for p in f0["sliced_probe"] if not p["equal"]]
    check(not sliced_bad, "tp f32: with the unsharded products' columns the "
          "sharded forward's gathered activations differ from tp=None's "
          f"(the port's own fault): {sliced_bad[:3]}")
    f32_diff = _differing(none["responses"], two["responses"])
    probe = f0["probe"]
    bad = [p for p in probe if not p["equal"]]
    products = {f"rank {r}": _product_summary(x["f32"]["products"])
                for r, x in enumerate(ranks)}
    n_prod = sum(len(x["f32"]["products"]) for x in ranks)
    n_bad = sum(not p["equal"] for x in ranks for p in x["f32"]["products"])
    rep["f32"] = {"layers": TP_F32_LAYERS, "new_tokens": TP_F32_NEW_TOKENS,
                  "responses_equal": len(none["responses"]) - len(f32_diff),
                  "requests": len(none["responses"]),
                  "first_difference": f32_diff, "probe": probe,
                  "oracle_fused_steps": orc["fused_steps"],
                  "tp_none_fused_steps": none["fused_steps"],
                  "tp2_responses_equal_to_oracle": _equal_responses(orc, two),
                  "sliced_probe_equal": True, "sliced_rollout_equal": True,
                  "column_products": products,
                  "fused_steps": two["fused_steps"]}
    log(f"  f32 granite-3-8b ({TP_F32_LAYERS} layers, TF32 off, "
        f"{TP_F32_NEW_TOKENS} tokens): tp={TP} responses equal to tp=None "
        f"{rep['f32']['responses_equal']}/{rep['f32']['requests']}; "
        f"gathered activations equal to tp=None's "
        f"{len(probe) - len(bad)}/{len(probe)}; under tp={TP}'s schedule "
        f"({orc['fused_steps']} engine steps, tp=None {none['fused_steps']})"
        f" tp={TP} responses equal to tp=None's "
        f"{rep['f32']['tp2_responses_equal_to_oracle']}/"
        f"{rep['f32']['requests']}; "
        f"with the unsharded products' columns the rollout "
        f"({sl['sliced_products']} products) bitwise its oracle and all "
        f"{len(probe)} activations bitwise tp=None's on both ranks")
    for p in bad[:6]:
        log(f"    differs (T={p['T']}): {p['kind']} of layer {p['layer']} "
            f"{p['shape']}: max gap {p['max_gap']:.3e}")
    log(f"  the ranks' column products against the same columns of the "
        f"unsharded product on the same input: {n_prod - n_bad}/{n_prod} "
        "bitwise")
    for r, summ in products.items():
        for k_, s_ in summ.items():
            if s_["not_bitwise"]:
                log(f"    {r}: {k_} {s_['not_bitwise']}/{s_['calls']} "
                    f"layers not bitwise, max gap {s_['max_gap']:.3e}")
    if bad:
        first = bad[0]
        feeding = [(r, p) for r, x in enumerate(ranks)
                   for p in x["f32"]["products"]
                   if not p["equal"] and _feeds(p, first)]
        log(f"    the first differing activation ({first['kind']} of layer "
            f"{first['layer']}, T={first['T']}) is fed by "
            f"{len(feeding)} non-bitwise column products: " + ", ".join(
                f"rank {r} layer {p['layer']} {p['weight']} T={p['T']} "
                f"({p['max_gap']:.1e})" for r, p in feeding[:8]))
        # with the sliced products bitwise tp=None, a differing activation
        # needs a differing product at or before it
        check(bool(feeding), "tp f32: an activation differs from tp=None "
              "but no column product feeding it does: the port's own fault")
    check(n_bad == 0 and not bad, f"tp f32: {n_bad} of {n_prod} column "
          f"products not bitwise the unsharded product's columns, "
          f"{len(bad)} gathered activations differ from tp=None's")
    check(rep["f32"]["tp2_responses_equal_to_oracle"] ==
          rep["f32"]["requests"], f"tp f32: tp={TP} equals tp=None under "
          f"its schedule in {rep['f32']['tp2_responses_equal_to_oracle']} "
          f"of {rep['f32']['requests']} responses")
    rep["open_fault"] = bool(f32_diff or bad or n_bad or any(
        m_["bf16_first_difference"] for m_ in rep["models"].values()))

    # K1 / K2 / K4 timed at the shard shapes: each model's commonest tp=2
    # width, contexts halfway through the responses
    timing = {}
    for arch, layers, cache_len in TP_MODELS:
        cfg = _arch_cfg(arch, layers)
        Hq, Hk, D, window = K1_SHAPES[arch]
        hs = _tp_shards(Hq, Hk)[0]
        K1_SHAPES[f"{arch}/tp{TP}"] = (hs.q_hi - hs.q_lo, hs.kv_hi - hs.kv_lo,
                                       D, window)
        prompts = make_prompts(np, cfg, TP_GROUPS, seed=1)
        live = np.asarray([min(len(p) + TP_NEW_TOKENS // 2, cache_len)
                           for p in prompts for _ in range(GROUP_SIZE)][:8])
        by = rep["models"][arch]["by_kind"]
        T = int(max(by, key=by.get).split(":")[1])
        timing[arch] = kernels_time(torch, np, B=8, S=cache_len, T=T,
                                    live=live, model=f"{arch}/tp{TP}",
                                    split_like=(Hq, Hk))
        log_verify_time(f"spec_verify/{arch}/tp{TP} (rank 0's heads, the "
                        "unsharded split)", timing[arch])
        if arch == "granite-3-8b":
            tby = rep["models"][arch]["tree"]["by_kind"]
            tT = int(max(tby, key=tby.get).split(":")[1])
            timing["tree"] = tree_kernels_time(
                torch, np, B=8, S=cache_len, T=tT, live=live,
                model=f"{arch}/tp{TP}", split_like=(Hq, Hk))
            log_verify_time(f"tree_verify/{arch}/tp{TP} (rank 0's heads)",
                            timing["tree"])
    rep["timing"] = timing
    rep["phase_s"] = time.perf_counter() - t0
    return rep


# ---------------------------------------------------------------------------
# the production layout: one-rank cached steps, K1 at prefill widths, the
# train step on two ranks
# ---------------------------------------------------------------------------

# (a) granite-3-8b at full width, cut in depth as the tensor-parallel phase
# cuts it, on an 8 x 2048 cache: a 512-token contiguous prefill, 16
# greedy decodes, a verify of gamma + 1 tokens, a three-path tree verify
PROD_LAYERS = TP_GRANITE_LAYERS
PROD_B, PROD_S, PROD_PREFILL, PROD_DECODES, PROD_GAMMA = 8, 2048, 512, 16, 8
# the prefill's first position: its window [768, 1280) spans the two
# ranks' halves of the cache in (d), and every later step lies on rank 1
PROD_START = 768
# (d) the same steps at tp = 2 against (a)'s one-rank run, bf16: a greedy
# token must equal (a)'s where (a)'s top-2 logit margin exceeds this share
# of the step's largest |logit| (bf16's tolerance: the ranks' merge and
# row-parallel sums round otherwise); the gathered K/V within this share
# of (a)'s largest |value|; slot_pos exactly
PROD_MARGIN, PROD_CACHE_TOL = 3e-2, 3e-2
# (b) K1 at the production prefill's widths: (T, S) with S past T, so
# that empty slots exist for a planted fault to let in
PROD_K1_WIDTHS = ((512, 2048), (2048, 2560))
# (c) the train step at tp = 2 against tp = 1, f32: (arch, layers) at full
# width, and its batch (rows x tokens) drawn from this many distinct token
# ids (repeated tokens crowd the MoE layers' experts, so that capacity
# drops happen on random weights)
PROD_TRAIN = (("granite-3-8b", PROD_LAYERS), (MOE_ARCH, 3))
# (e) the data axis over ranks: a (PROD_DATA, TP) mesh of four gloo ranks
# on the card runs (a)'s cached steps, each data rank on its rows, and
# PROD_TRAIN's train steps with FSDP of the embed axis over data
PROD_DATA = 2
PROD_MESH = f"({PROD_DATA}, {TP})"
PROD_TRAIN_B, PROD_TRAIN_S, PROD_TRAIN_VOCAB = 4, 256, 16
# tp = 2 against tp = 1 in f32 (row-parallel and sequence-sharded sums in
# other orders): loss 1e-5 of max(|loss|, 1) (the on-policy GRPO loss
# cancels to ~0); the grad norm 1e-4 of itself; each gradient leaf (as
# AdamW's first moment holds it after the step) 1e-4 of its largest
# value.  The update (parameters after the step less before) in units of
# the step's lr: AdamW's first step moves an element by lr (g / (|g| +
# eps) + wd p), about +-lr, so on the elements whose first moment is
# above "held" of its leaf's largest (there the gradient check fixes the
# sign) and above "floor" (|g| = floor / (1 - beta1) = 1e-6, a hundred
# times AdamW's eps: a step above 0.99 lr) tp = 2's update is within
# "update" x lr of tp = 1's (a step not taken is lr off, a flipped sign
# 2 lr; f32 rounding of a parameter near 1 is ~0.02 lr), and tp = 1's is
# at least "moved" x lr
PROD_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grads": 1e-4,
            "held": 1e-3, "floor": 1e-7, "update": 0.125, "moved": 0.5}


def three_path_tree(torch, first, pos0, vocab):
    """A tree of 7 nodes a row, on the card: the root (``first`` (B,), at
    ``pos0``) with three children, each with one child (three paths), as
    the tree-verify step takes it: tokens, positions, slot_index (slot
    ``pos0 + node``), mask (row 1's last node masked) and the
    ancestor-or-self ``within`` (B, 7, 7)."""
    parent = [-1, 0, 0, 0, 1, 2, 3]
    depth = [0, 1, 1, 1, 2, 2, 2]
    n = len(parent)
    B = first.shape[0]
    within = torch.zeros((n, n), dtype=torch.bool)
    for i in range(n):
        j = i
        while j >= 0:
            within[i, j] = True
            j = parent[j]
    dev = first.device
    node = torch.arange(n, device=dev, dtype=torch.int32)
    toks = (first[:, None] + 7 * node[None]
            + torch.arange(B, device=dev, dtype=torch.int32)[:, None]
            * (node[None] > 0)) % vocab
    pos = (pos0 + torch.tensor(depth, dtype=torch.int32, device=dev)
           ).expand(B, n).contiguous()
    slots = (pos0 + node).expand(B, n).contiguous()
    mask = torch.ones((B, n), dtype=torch.bool, device=dev)
    mask[1, -1] = False
    return (toks.to(torch.int32), pos, slots, mask,
            within.to(dev).expand(B, n, n).contiguous())


def production_steps(torch, np, device, save_to=None) -> dict:
    """(a) The four cached builders of ``launch/steps.py`` on a one-rank
    production context (``make_shard_ctx(small_mesh(1))``), granite-3-8b
    at full width and ``PROD_LAYERS`` layers, bf16, ``PROD_B`` x
    ``PROD_S`` slots: ``build_prefill_step`` on a ``PROD_PREFILL``-token
    contiguous prefill, ``PROD_DECODES`` ``build_serve_step`` decodes, a
    ``build_verify_step`` of ``PROD_GAMMA`` + 1 tokens and a
    ``build_tree_verify_step`` on a three-path tree, with the launches of
    each kernel counted from zero over these calls alone.  Then the same
    inputs through the engine's forward (the slot scatter) on a copy of
    the empty cache: the prefill's ``slot_pos`` exactly and its K/V
    bitwise (the same projections, written another way), every greedy
    token of the other steps exactly (the engine forward's argmax on the
    same caches), and the caches equal at the end.  The prefill starts at
    ``PROD_START``.  With ``save_to`` the run is written there for (d)
    (``prod_a.pt``, on the host): every step's inputs and greedy tokens,
    the engine forward's logits of the steps after the prefill, and the
    cache after the prefill and at the end."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_shard_ctx, small_mesh
    from repro_torch.models.transformer import (clone_cache, forward,
                                                init_cache)
    cfg, params = build_model(torch, "granite-3-8b", PROD_LAYERS)
    L = cfg.num_layers
    sctx = make_shard_ctx(small_mesh(1), train=False)
    B, S, T = PROD_B, PROD_S, PROD_PREFILL
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)).astype(
        np.int32)).to(device)
    pos = (PROD_START + torch.arange(T, dtype=torch.int32, device=device)
           ).expand(B, T).contiguous()
    cache = init_cache(cfg, B, S, device=device)
    oracle = clone_cache(cache)

    def col(p, n=1):
        return p + torch.arange(n, dtype=torch.int32,
                                device=device).expand(B, n)

    calls = []                                # (kind, inputs, tokens)
    _reset_launches()
    plain0 = _plain_calls()
    t0 = time.perf_counter()
    cache = steps.build_prefill_step(cfg, sctx)(params, tok, pos, cache)
    after_prefill = clone_cache(cache)
    serve = steps.build_serve_step(cfg, sctx)
    nxt, p = tok[:, -1], PROD_START + T
    for _ in range(PROD_DECODES):
        inp = (nxt[:, None].contiguous(), col(p))
        nxt, cache = serve(params, *inp, cache)
        calls.append(("serve", inp, nxt))
        p += 1
    n = PROD_GAMMA + 1
    cand = torch.stack([nxt] + [(nxt + 1 + (i % 2)) % cfg.vocab_size
                                for i in range(n - 1)], 1).to(torch.int32)
    inp = (cand, col(p, n))
    got, cache = steps.build_verify_step(cfg, sctx)(params, *inp, cache)
    calls.append(("verify", inp, got))
    tree = three_path_tree(torch, nxt, p + n, cfg.vocab_size)
    got, cache = steps.build_tree_verify_step(cfg, sctx)(params, *tree,
                                                        cache)
    calls.append(("tree", tree, got))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    plain = _plain_calls() - plain0
    want = {"spec_verify": L * (1 + PROD_DECODES + 1), "tree_verify": L}
    for k_, v_ in want.items():
        check(launches[k_] == v_, f"production steps: {k_} launches "
              f"{launches[k_]} != {v_}")
    check(plain == 0, f"production steps: {plain} plain attention calls")

    with torch.no_grad():
        _, oracle, _ = forward(cfg, params, tok, pos, oracle, logits=False)
        check(torch.equal(oracle["slot_pos"], after_prefill["slot_pos"]),
              "production prefill: slot_pos differs from the scatter path's")
        for key in ("k", "v"):
            check(torch.equal(oracle[key], after_prefill[key]),
                  f"production prefill: {key} not bitwise the scatter "
                  "path's")
        equal = 0
        logits_of = []
        for kind, inp, got in calls:
            if kind == "tree":
                toks, tpos, slots, mask, within = inp
                logits, oracle, _ = forward(cfg, params, toks, tpos, oracle,
                                            token_mask=mask,
                                            slot_index=slots,
                                            within_mask=within)
            else:
                logits, oracle, _ = forward(cfg, params, *inp, oracle)
            want_t = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            if kind == "serve":
                want_t = want_t[:, -1]
                logits = logits[:, -1]
            logits_of.append(logits.float().cpu())
            check(torch.equal(got, want_t), f"production {kind} step: "
                  "greedy tokens differ from the engine forward's")
            equal += got.numel()
        for key in ("k", "v", "slot_pos"):
            check(torch.equal(oracle[key], cache[key]),
                  f"production steps: the caches' {key} differ at the end")
    if save_to:
        def host(c):
            return {k_: c[k_].cpu() for k_ in ("k", "v", "slot_pos")}
        torch.save({"inputs": [("prefill", (tok.cpu(), pos.cpu()))]
                    + [(kind, tuple(x.cpu() for x in inp))
                       for kind, inp, _ in calls],
                    "tokens": [got.cpu() for _, _, got in calls],
                    "logits": logits_of, "after_prefill":
                    host(after_prefill), "final": host(cache)},
                   os.path.join(save_to, "prod_a.pt"))
    rep = {"layers": L, "B": B, "S": S, "prefill_T": T,
           "prefill_start": PROD_START,
           "decodes": PROD_DECODES, "verify_T": n, "tree_nodes": 7,
           "launches": {k_: launches[k_] for k_ in want},
           "tokens_equal": equal, "wall_s": wall,
           "tree_live": T + PROD_DECODES + n}
    log(f"  granite-3-8b ({L} layers, full width, bf16) on a one-rank "
        f"production context: prefill of {T} tokens at {PROD_START} (K/V "
        f"bitwise and slot_pos equal to the scatter path's), "
        f"{PROD_DECODES} decodes, a "
        f"verify of {n}, a tree of 7 nodes: {equal} greedy tokens equal to "
        f"the engine forward's; K1 {launches['spec_verify']}, K2 "
        f"{launches['tree_verify']} launches, no plain call; {wall:.2f} s")
    del params, cache, oracle, after_prefill
    _free(torch)
    return rep


def _prefill_faults(torch, k, v, kp) -> dict:
    """Inputs of three wrong K1s on a prefill's slot cache (f32 k, v
    (B,S,Hk,D), k_pos (B,S)): the key at position 0 dropped (every query
    loses one, the first all it had), causality off by one (each query
    also sees the next position) and the empty slots let in at position
    0.  {name: (k, v, k_pos)}."""
    first = kp.clone()
    first[kp == 0] = -1
    shifted = torch.where(kp > 0, kp - 1, kp)
    return {"key 0 dropped": (k, v, first),
            "one key past causal": (k, v, shifted),
            "empty slots let in": (k, v, kp.clamp(min=0))}


def prefill_kernels_check(torch, np) -> list:
    """(b) K1 at the production prefill's widths (``PROD_K1_WIDTHS``,
    granite-3-8b's heads, bf16, B = ``PROD_B``): queries at positions
    0..T-1 over slots 0..T-1 of a longer cache, as the prefill step
    writes them, through the wrapper and on both routes against the plain
    version (``_k1_case``, repeats bitwise), then held to the f32 plain
    version at the reference's scale with three planted faults that must
    fail (``_prefill_faults``); at T = 512 also on permuted slots with an
    empty row and a blind query."""
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_ref
    hq, hk, d, window = K1_SHAPES["granite-3-8b"]
    rows = []
    for T, S in PROD_K1_WIDTHS:
        for live in ([T] * PROD_B, None):
            if live is None and T != PROD_K1_WIDTHS[0][0]:
                continue
            q, k, v, qp, kp = _sv_inputs(torch, np, B=PROD_B, T=T, S=S,
                                         Hq=hq, Hk=hk, D=d,
                                         dtype="bfloat16", seed=T + 1,
                                         live=live)
            note = "prefill layout" if live else "permuted slots"
            row = _k1_case(torch, "granite-3-8b/prefill", q, k, v, qp, kp,
                           window, empty_rows=live is None, note=note)
            if live:
                outs = {r: ops.launch_on_route(r, q, k, v, qp, kp,
                                               window=window)
                        for r in _routes("bfloat16", d)}
                q32 = q.float()

                def plain(k_, v_, kp_=kp):
                    return spec_verify_ref(q32, k_, v_, qp, kp_,
                                           window=window)
                wrong = {n_: plain(*a).to(q.dtype) for n_, a in
                         _prefill_faults(torch, k.float(), v.float(),
                                         kp).items()}
                row["scaled_errs"] = scaled_check(
                    torch, outs, plain, k, v,
                    f"spec_verify prefill B={PROD_B} T={T} S={S}",
                    faults=wrong)
                del outs, wrong
            rows.append(row)
            del q, k, v, qp, kp
            _free(torch)
    return rows


def prefill_kernels_time(torch, np) -> list:
    """K1 at each production prefill width: the wrapper's time, each
    route's, the plain version's, SDPA's on the same mask and the bound
    (``kernels_time``)."""
    out = []
    for T, S in PROD_K1_WIDTHS:
        tm = kernels_time(torch, np, B=PROD_B, S=S, T=T,
                          live=np.full(PROD_B, T), iters=20)
        tm["S"] = S
        log_verify_time(f"spec_verify prefill S={S}", tm)
        out.append(tm)
        _free(torch)
    return out


def _prod_batch(torch, np, cfg, device):
    """A GRPO batch of ``PROD_TRAIN_B`` x ``PROD_TRAIN_S`` tokens drawn
    from ``PROD_TRAIN_VOCAB`` ids, responses from a quarter of the way
    in, old logprobs near a uniform policy's, seeded."""
    rng = np.random.default_rng(11)
    B, S = PROD_TRAIN_B, PROD_TRAIN_S
    ids = rng.choice(cfg.vocab_size, PROD_TRAIN_VOCAB, replace=False)
    mask = np.zeros((B, S), np.float32)
    mask[:, S // 4:] = 1.0
    mask[1, 3 * S // 4:] = 0.0
    b = {"tokens": ids[rng.integers(0, PROD_TRAIN_VOCAB, (B, S))].astype(
             np.int32),
         "loss_mask": mask,
         "old_logprobs": (-np.log(cfg.vocab_size)
                          + rng.normal(0, 0.3, (B, S))).astype(np.float32),
         "advantages": rng.normal(size=(B,)).astype(np.float32),
         "rewards": rng.random(B).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _prod_pieces(torch, cfg, sctx, device, stagger=False) -> dict:
    """This rank's pieces (``steps.param_shards`` under ``sctx``) of
    ``cfg``'s seed-0 f32 weights.  ``stagger``: the ranks of the process
    group draw the whole weights and cut their pieces one after another,
    so that no two hold the whole model on the card at once."""
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    turns = range(dist.get_world_size()) if stagger else (None,)
    for turn in turns:
        if turn is None or turn == dist.get_rank():
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
            whole = init_params(cfg, gen, device=device, dtype="float32")
            pieces = steps.param_shards(cfg, whole, sctx)
            del whole
            _free(torch)
        if turn is not None:
            dist.barrier()
    return pieces


def _prod_train(torch, np, cfg, sctx, device, keep, pieces=None) -> dict:
    """One ``build_train_step`` step of one arch under ``sctx`` (this
    rank's pieces of the seed-0 f32 weights, ``_prod_pieces``, or a copy
    of ``pieces`` when given; its rows of the batch): its loss and
    metrics, the MoE layers' capacity drops summed over the ranks, the
    kernel launches of the step, the dispatch records' disagreements
    with the plain slot rule (``_slot_rule_misses``), and ``keep`` of two
    trees of this rank's pieces: the gradient, as AdamW's first moment
    after one step holds it ((1 - beta1) x the clipped gradient), and
    the update (parameters after the step less before)."""
    from repro_torch import sharding
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.training.optim import (init_opt_state, tree_items,
                                            tree_map)
    if pieces is None:
        params = _prod_pieces(torch, cfg, sctx, device)
    else:
        params = tree_map(lambda t: t.detach().clone(), pieces)
    params = tree_map(lambda t: t.requires_grad_(), params)
    batch = steps.batch_shards(cfg, sctx, _prod_batch(torch, np, cfg,
                                                      device))
    step = steps.build_train_step(cfg, sctx)
    state = init_opt_state(params)
    before = tree_map(lambda t: t.detach().clone(), params)
    _reset_launches()
    plain0 = _plain_calls()
    moe.DISPATCH_LOG = []
    sharding.reset_traffic()
    t0 = time.perf_counter()
    params, state, loss, met = step(params, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traffic = dict(sharding.traffic)
    launches = _launches()
    launches["plain_calls"] = _plain_calls() - plain0
    drops = torch.zeros((), dtype=torch.int64, device=device)
    routed = 0
    for r in moe.DISPATCH_LOG:
        drops += (r["local"] & ~r["valid"]).sum()
        routed += r["ids"].numel()
    misses = _slot_rule_misses(np, moe.DISPATCH_LOG, cfg.num_experts)
    moe.DISPATCH_LOG = None
    drops = int(sharding.all_reduce(sharding.all_reduce(drops, sctx),
                                    sctx.over("dp")))
    for (_, b), (_, a) in zip(tree_items(before), tree_items(params)):
        torch.sub(a.detach(), b, out=b)          # the update, in place
    update = before
    out = {"loss": float(loss), "grad_norm": float(met["grad_norm"]),
           "aux_loss": float(met["aux_loss"]), "lr": float(met["lr"]),
           "drops": drops, "routed": routed, "slot_rule_misses": misses,
           "launches": launches, "step_wall_s": wall, "traffic": traffic,
           "grads": keep(state.mu), "update": keep(update)}
    del params, state, update
    _free(torch)
    return out


def _slot_rule(np, ids, E, C):
    """The capacity dispatch's slot rule in plain numpy, every expert on
    one rank: ids (T, k) -> (slot, valid), each (T * k,) in flattened
    (token, k) order: a pair's rank in its expert by an exclusive
    cumsum, kept below C at slot expert * C + rank, else dropped."""
    e = ids.reshape(-1).astype(np.int64)
    onehot = (e[:, None] == np.arange(E)[None]).astype(np.int64)
    pos = np.take_along_axis(np.cumsum(onehot, 0) - onehot, e[:, None],
                             1)[:, 0]
    valid = pos < C
    return np.where(valid, e * C + pos, E * C), valid


def _slot_rule_misses(np, records, E) -> int:
    """(token, k) pairs of the dispatch records (``moe.DISPATCH_LOG``)
    whose drop or slot differs from ``_slot_rule`` on the same ids: of
    the pairs routed to a record's experts [e0, e0 + E_loc), the kept
    ones at slot - e0 x C, the rest dropped."""
    misses = 0
    for r in records:
        e0, C = r["e0"], r["C"]
        slot, valid = _slot_rule(np, r["ids"].cpu().numpy(), E, C)
        local = r["local"].cpu().numpy()
        misses += int((local & (valid != r["valid"].cpu().numpy())).sum())
        kept = local & valid
        misses += int((slot[kept] - e0 * C
                       != r["slot"].cpu().numpy()[kept]).sum())
    return misses


def _prod_gaps(one, two, device) -> dict:
    """The gaps of this rank's tp = 2 pieces (``two``, on the host) to the
    same pieces of tp = 1 (``one``, on ``device``), taken on ``device``
    leaf by leaf: per leaf (max|gap|, max|tp=1 value|) of the gradient
    (AdamW's first moment); and of the update, in units of tp = 1's lr
    over the elements whose tp = 1 gradient is above
    ``PROD_TOL["held"]`` of its leaf's largest and above
    ``PROD_TOL["floor"]``: the largest gap, tp = 1's smallest |update|
    and the count of those elements."""
    import torch
    from repro_torch.training.optim import tree_items
    g2, u2 = dict(tree_items(two["grads"])), dict(tree_items(two["update"]))
    u1 = dict(tree_items(one["update"]))
    lr = one["lr"]
    grads = {}
    gap, moved, held = 0.0, math.inf, 0
    for path, g in tree_items(one["grads"]):
        top = g.abs().max()
        grads[path] = (float((g - g2[path].to(device)).abs().max()),
                       float(top))
        mask = g.abs() > torch.clamp(PROD_TOL["held"] * top,
                                     min=PROD_TOL["floor"])
        if not bool(mask.any()):
            continue
        a = u1[path][mask]
        gap = max(gap, float((a - u2[path].to(device)[mask]).abs().max())
                  / lr)
        moved = min(moved, float(a.abs().min()) / lr)
        held += int(mask.sum())
    keys = ("loss", "grad_norm", "aux_loss", "lr", "drops", "routed")
    return {"one": {k_: one[k_] for k_ in keys},
            "two": {k_: two[k_] for k_ in keys},
            "slot_rule_misses": (one["slot_rule_misses"],
                                 two["slot_rule_misses"]),
            "launches": two["launches"], "launches_tp1": one["launches"],
            "step_wall_s": (one["step_wall_s"], two["step_wall_s"]),
            "grads": grads, "update_gap_lr": gap, "update_moved_lr": moved,
            "update_held": held, "update_total": sum(
                t.numel() for _, t in tree_items(one["update"]))}


def _scaled_gap(got, want) -> float:
    """max|got - want| / max|want| (f32; 0 against an all-zero want)."""
    top = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(top, 1e-30)


def _cache_gaps(torch, got, want, device) -> dict:
    """(d)'s gathered cache against (a)'s (on the host): ``slot_pos``
    slots that differ, and K/V's ``_scaled_gap``."""
    out = {"slot_pos_diff": int((got["slot_pos"] != want["slot_pos"].to(
        device)).sum())}
    for k_ in ("k", "v"):
        out[k_] = _scaled_gap(got[k_], want[k_].to(device))
    return out


# the names of each cached step's inputs in (a)'s record, as
# ``steps.batch_shards`` cuts their rows
PROD_STEP_INPUTS = {"prefill": ("tokens", "positions"),
                    "serve": ("tokens", "positions"),
                    "verify": ("tokens", "positions"),
                    "tree": ("tokens", "positions", "slot_index", "mask",
                             "within")}


def _prod_cached(torch, np, rank, device, tmp, sctx, faults=True) -> dict:
    """(d) The four cached builders under ``sctx`` (the production
    context of the model axis at tp = ``TP``; in (e) also of the data
    axis) on this rank's pieces of granite-3-8b (``PROD_LAYERS`` layers,
    full width, bf16, the seed-0 weights of (a)) and of the ``PROD_B`` x
    ``PROD_S`` cache (``steps.init_cache``: ``PROD_S`` / tp slots of its
    rows a rank), on its rows of (a)'s inputs (``prod_a.pt``,
    ``steps.batch_shards``): each kernel's launches and the plain calls
    counted from zero over the builder calls alone, the greedy tokens and
    the builders' logits against (a)'s on the same rows, the cache
    gathered whole (``gather_cache``) after the prefill and at the end;
    then, with ``faults``, two planted faults, each a prefill on a fresh
    piece gathered the same way: the last rank's partial left out of the
    merge, and this rank's writes landing on another rank's slots (its
    span swapped).  On rank 0 the cache's gaps to (a) are taken on the
    card; the checks are ``_prod_cached_checks``'."""
    import dataclasses
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import init_params, transformer
    a = torch.load(os.path.join(tmp, "prod_a.pt"))
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=PROD_LAYERS)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    whole = init_params(cfg, gen, device=device)
    params = steps.param_shards(cfg, whole, sctx)
    del whole
    _free(torch)
    logits = []
    real = transformer.forward

    def recorder(*args, **kw):
        out = real(*args, **kw)
        if out[0] is not None:
            logits.append(out[0])
        return out
    transformer.forward = recorder
    try:
        build = {"prefill": steps.build_prefill_step(cfg, sctx),
                 "serve": steps.build_serve_step(cfg, sctx),
                 "verify": steps.build_verify_step(cfg, sctx),
                 "tree": steps.build_tree_verify_step(cfg, sctx)}
    finally:
        transformer.forward = real
    lo_b, hi_b = steps.batch_piece(PROD_B, sctx)
    inputs = []
    for kind, inp in a["inputs"]:
        names = PROD_STEP_INPUTS[kind]
        mine = steps.batch_shards(cfg, sctx, dict(zip(
            names, (x.to(device) for x in inp))))
        inputs.append((kind, [mine[n] for n in names]))

    def prefill(cache):
        return build["prefill"](params, *inputs[0][1], cache)
    cache = steps.init_cache(cfg, PROD_B, PROD_S, sctx, device=device)
    piece = int(cache["slot_pos"].shape[1])
    _reset_launches()
    plain0 = _plain_calls()
    sharding.reset_traffic()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = prefill(cache)
    torch.cuda.synchronize()
    walls = {"prefill": time.perf_counter() - t0}
    whole_c = steps.gather_cache(cfg, cache, sctx)
    gaps = {"prefill": _cache_gaps(torch, whole_c, a["after_prefill"],
                                   device) if rank == 0 else None}
    del whole_c
    tokens = []
    t0 = time.perf_counter()
    for kind, inp in inputs[1:]:
        got, cache = build[kind](params, *inp, cache)
        tokens.append(got)
    torch.cuda.synchronize()
    walls["steps"] = time.perf_counter() - t0
    # the gather and the gaps between the prefill and the steps launch
    # none of the port's kernels
    launches = _launches()
    plain = _plain_calls() - plain0
    traffic = dict(sharding.traffic)
    whole_c = steps.gather_cache(cfg, cache, sctx)
    gaps["final"] = (_cache_gaps(torch, whole_c, a["final"], device)
                     if rank == 0 else None)
    del whole_c, cache
    # tokens against (a)'s on the rank's rows where (a)'s top-2 margin is
    # above PROD_MARGIN of the step's largest |logit|; each step's
    # logits' scaled gap
    held = equal_held = other = other_equal = 0
    logit_gaps = []
    for got, want, wl, gl in zip(tokens, a["tokens"], a["logits"],
                                 logits):
        wl = wl[lo_b:hi_b].to(device)
        if gl.dim() == 3 and wl.dim() == 2:
            gl = gl[:, -1]
        logit_gaps.append(_scaled_gap(gl, wl))
        top2 = wl.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > PROD_MARGIN * float(
            wl.abs().max())
        same = got == want[lo_b:hi_b].to(device)
        held += int(sure.sum())
        equal_held += int((same & sure).sum())
        other += int((~sure).sum())
        other_equal += int((same & ~sure).sum())
    del logits, tokens
    _free(torch)
    out = {"layers": cfg.num_layers, "piece": piece, "rows": hi_b - lo_b,
           "launches": launches, "plain_calls": plain, "walls": walls,
           "traffic": traffic, "gaps": gaps, "faults": {},
           "logit_gaps": logit_gaps, "held": held,
           "equal_held": equal_held, "other": other,
           "other_equal": other_equal,
           "want": {"spec_verify": cfg.num_layers * (2 + PROD_DECODES),
                    "tree_verify": cfg.num_layers}}
    if not faults:
        del params, a
        _free(torch)
        return out
    # the planted faults: a prefill each on a fresh piece, gathered
    merge = sharding.merge_ranks

    def left_out(o, lse, ctx, heads=None):
        if ctx.rank == ctx.tp_size - 1:
            lse = torch.full_like(lse, -math.inf)
        return merge(o, lse, ctx, heads)
    sharding.merge_ranks = left_out
    try:
        whole_c = steps.gather_cache(cfg, prefill(steps.init_cache(
            cfg, PROD_B, PROD_S, sctx, device=device)), sctx)
    finally:
        sharding.merge_ranks = merge
    out["faults"]["the last rank's partial left out of the merge"] = (
        _cache_gaps(torch, whole_c, a["after_prefill"], device)
        if rank == 0 else None)
    del whole_c
    fresh = steps.init_cache(cfg, PROD_B, PROD_S, sctx, device=device)
    span = fresh[steps.SEQ_SPAN]
    other_rank = dataclasses.replace(sctx, rank=(sctx.rank + 1)
                                     % sctx.tp_size)
    lo, hi = steps.seq_piece(PROD_S, other_rank)
    fresh[steps.SEQ_SPAN] = torch.tensor([lo, hi, PROD_S])
    fresh = prefill(fresh)
    fresh[steps.SEQ_SPAN] = span
    whole_c = steps.gather_cache(cfg, fresh, sctx)
    out["faults"]["writes on another rank's slots"] = (
        _cache_gaps(torch, whole_c, a["after_prefill"], device)
        if rank == 0 else None)
    del whole_c, fresh, params, a
    _free(torch)
    return out


def _prod_cached_checks(ranks, key="cached", what=f"tp={TP}",
                        row_ranks=(0,)) -> dict:
    """(d)'s gates over the ranks (and (e)'s, ``key`` "cached_e"): each
    rank's launches those derived from the config (K1 a layer for the
    prefill, each decode and the verify; K2 a layer for the tree) and no
    plain call; every held token equal to (a)'s; the gathered
    ``slot_pos`` equal and K/V within ``PROD_CACHE_TOL`` after the
    prefill and at the end; each planted fault off (a)'s cache past
    those bounds.  The token counts returned are summed over
    ``row_ranks``, whose rows make the batch; the logits' gaps are the
    largest over the ranks."""
    r0 = ranks[0][key]
    for r, rank in enumerate(ranks):
        c = rank[key]
        for k_, v_ in c["want"].items():
            check(c["launches"][k_] == v_, f"production cached steps at "
                  f"{what}, rank {r}: {k_} launches {c['launches'][k_]} "
                  f"!= {v_}")
        check(c["plain_calls"] == 0, f"production cached steps at {what}, "
              f"rank {r}: {c['plain_calls']} plain attention calls")
        check(c["traffic"] == r0["traffic"], "production cached steps: the "
              "ranks ran different collectives")
        check(c["equal_held"] == c["held"], f"production cached steps at "
              f"{what}, rank {r}: {c['held'] - c['equal_held']} of "
              f"{c['held']} greedy tokens above the margin differ from "
              "the one-rank run's")

    def ok(g):
        return g["slot_pos_diff"] == 0 and max(g["k"], g["v"]) \
            <= PROD_CACHE_TOL
    for when, g in r0["gaps"].items():
        check(ok(g), f"production cached steps at {what}: the gathered "
              f"cache after the {when} off the one-rank run's: {g}")
    for name, g in r0["faults"].items():
        check(not ok(g), f"production cached steps: the planted fault "
              f"'{name}' passes the cache check: {g}")
    out = dict(r0)
    for k_ in ("held", "equal_held", "other", "other_equal"):
        out[k_] = sum(ranks[r][key][k_] for r in row_ranks)
    out["logit_gaps"] = [max(g) for g in zip(*(rank[key]["logit_gaps"]
                                               for rank in ranks))]
    return out


def _share_inputs(torch, np, T, seed, tree=False, B=PROD_B):
    """A rank's share of (d)'s cache, bf16 at granite's heads: B =
    ``B`` rows (default ``PROD_B``; (e)'s data rank holds ``PROD_B`` /
    ``PROD_DATA``) of ``PROD_S`` / ``TP`` slots, the second half's
    (positions ``PROD_S`` / 2 .. of a window from ``PROD_START``), its
    first slots live up to the step's queries; queries at the last T
    positions, so that a prefill's early rows see no key of the share.
    K2 (``tree``): an ancestor chain's mask over the step's own slots."""
    hq, hk, d, _ = K1_SHAPES["granite-3-8b"]
    S = PROD_S // TP
    lo = PROD_S // TP
    end = PROD_START + PROD_PREFILL + (PROD_DECODES if T <= 8 else 0)
    q, k, v = _normals(torch, seed, "bfloat16", (B, T, hq, d),
                       (B, S, hk, d), (B, S, hk, d))
    qp = (end - T + torch.arange(T, dtype=torch.int32, device="cuda")
          ).expand(B, T).contiguous()
    kp = torch.full((B, S), -1, dtype=torch.int32, device="cuda")
    n = end - lo
    kp[:, :n] = lo + torch.arange(n, dtype=torch.int32, device="cuda")
    tm = None
    if tree:
        tm = torch.ones((B, T, S), dtype=torch.bool, device="cuda")
        tm[:, :, n - T:n] = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                                  device="cuda"))
    return q, k, v, qp, kp, tm


def _first_half(torch, kp):
    """Slot positions of rank 0's half of (d)'s cache beside a share
    ``kp`` of the second half: slot s holds position s from
    ``PROD_START`` on."""
    pos = torch.arange(PROD_S // TP, dtype=torch.int32,
                       device=kp.device).expand_as(kp)
    return torch.where(pos >= PROD_START, pos, -1).contiguous()


def share_kernels_check(torch, np, B=PROD_B) -> list:
    """K1 (T = 1 and ``PROD_PREFILL``) and K2 (the tree step's 7) with
    ``lse=True`` at a rank's share of (d)'s cache (``_share_inputs``), on
    every route each takes, launched twice: o (f32) and the log-sum-exp
    against the plain version's (``lse=True``) at bf16's tolerance, -inf
    exactly where the plain version's is (a row that sees no key of the
    share, whose o is 0), repeats bitwise; and the two ranks' partials
    merged (``merge_lse``) against the whole cache's call."""
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import (merge_lse,
                                                     spec_verify_ref,
                                                     tree_verify_ref)
    rows = []
    for T, tree in ((1, False), (PROD_PREFILL, False), (7, True)):
        q, k, v, qp, kp, tm = _share_inputs(torch, np, T, 31 + T, tree, B)
        plain = (spec_verify_ref(q, k, v, qp, kp, lse=True) if tm is None
                 else tree_verify_ref(q, k, v, qp, kp, tm, lse=True))
        blind = torch.isneginf(plain[1])
        errs = {}
        name = "tree_verify" if tree else "spec_verify"
        for r in _routes("bfloat16", q.shape[3]):
            o, lse = ops.launch_on_route(r, q, k, v, qp, kp, tm, lse=True)
            o2, lse2 = ops.launch_on_route(r, q, k, v, qp, kp, tm, lse=True)
            check(o.dtype == torch.float32 and torch.equal(o, o2)
                  and torch.equal(lse, lse2), f"{name} (lse, rank share "
                  f"T={T}) on {r}: f32 output, repeats bitwise")
            check(torch.equal(torch.isneginf(lse), blind)
                  and bool((o[blind] == 0).all()), f"{name} (lse, rank "
                  f"share T={T}) on {r}: blind rows not (0, -inf)")
            e_o = float((o - plain[0]).abs().max())
            e_l = float((lse[~blind] - plain[1][~blind]).abs().max()) \
                if bool((~blind).any()) else 0.0
            errs[r] = max(e_o, e_l)
            check(e_o <= TOL["bfloat16"] and e_l <= TOL["bfloat16"],
                  f"{name} (lse, rank share T={T}) on {r}: o off by "
                  f"{e_o:.3e}, lse by {e_l:.3e}")
        # rank 0's share (the window's first half, seen whole) merged
        # with this one against the whole cache's call
        k0, v0 = _normals(torch, 77 + T, "bfloat16", k.shape, k.shape)
        kp0 = _first_half(torch, kp)
        tm0 = None if tm is None else torch.ones_like(tm)
        p0 = ops.launch_on_route("cuda_cores", q, k0, v0, qp, kp0, tm0,
                                 lse=True)
        p1 = ops.launch_on_route("cuda_cores", q, k, v, qp, kp, tm,
                                 lse=True)
        kw, vw = torch.cat([k0, k], 1), torch.cat([v0, v], 1)
        kpw = torch.cat([kp0, kp], 1)
        whole = (ops.launch_on_route("cuda_cores", q, kw, vw, qp, kpw)
                 if tm is None else ops.launch_on_route(
                     "cuda_cores", q, kw, vw, qp, kpw,
                     torch.cat([tm0, tm], 2).contiguous()))
        e_m = float((merge_lse([p0, p1]) - whole.float()).abs().max())
        check(e_m <= TOL["bfloat16"], f"{name} (rank share T={T}): the "
              f"ranks' merged partials off the whole cache's call by "
              f"{e_m:.3e}")
        log(f"  {name} lse=True at a rank's share (B={B}, T={T}, "
            f"{PROD_S // TP} slots): max|err| " + ", ".join(
                f"{r} {e:.3e}" for r, e in errs.items())
            + f" (o and lse; tol {TOL['bfloat16']}); {int(blind.sum())} "
            f"blind rows (0, -inf) on every route; repeats bitwise; two "
            f"shares merged vs the whole cache {e_m:.3e}")
        rows.append({"shape": f"granite-3-8b/share{'/tree' if tree else ''}",
                     "B": B, "T": T, "S": PROD_S // TP,
                     "errs_by_route": errs, "max_abs_err": max(errs.values()),
                     "merge_err": e_m, "blind_rows": int(blind.sum()),
                     "tol": TOL["bfloat16"]})
        del q, k, v, k0, v0, kw, vw
        _free(torch)
    return rows


def share_kernels_time(torch, np, B=PROD_B) -> dict:
    """K1 with ``lse=True`` at a rank's share (T = 1 and
    ``PROD_PREFILL`` over ``PROD_S`` / ``TP`` slots, ``_share_inputs``)
    beside its plain version, SDPA on the same share (boolean mask), the
    same call without partials on the whole cache of ``PROD_S`` slots
    (both halves live as in (d)), and the bound (q, o f32, the lse, the
    positions and the K/V of the slots some row sees, once each); the
    merge of two ranks' partials (``merge_lse``) alone; K2 likewise at
    the tree step's 7.  L2 flushed before each call."""
    import torch.nn.functional as F
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import (merge_lse, pos_mask,
                                                     spec_verify_ref,
                                                     tree_verify_ref)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()
    n0 = dict(ops.launches)
    out = {}
    for T, tree in ((1, False), (PROD_PREFILL, False), (7, True)):
        q, k, v, qp, kp, tm = _share_inputs(torch, np, T, 31 + T, tree, B)
        if tm is None:
            def call():
                return ops.spec_verify(q, k, v, qp, kp, lse=True)

            def plain():
                return spec_verify_ref(q, k, v, qp, kp, lse=True)
        else:
            def call():
                return ops.tree_verify(q, k, v, qp, kp, tm, lse=True)

            def plain():
                return tree_verify_ref(q, k, v, qp, kp, tm, lse=True)
        t = _time_rounds(torch, call, 20, flush)
        plain_ms = _time_ms(torch, plain, 5, flush)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = pos_mask(qp, kp)
        if tm is not None:
            mask = mask & tm
        mask = mask[:, None]
        lt = _time_rounds(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 20, flush)
        # the whole cache: rank 0's half live too
        kw, vw = torch.cat([k, k], 1), torch.cat([v, v], 1)
        kpw = torch.cat([_first_half(torch, kp), kp], 1).contiguous()
        if tm is None:
            whole_ms = _time_ms(torch, lambda: ops.spec_verify(
                q, kw, vw, qp, kpw), 20, flush)
        else:
            tmw = torch.cat([torch.ones_like(tm), tm], 2).contiguous()
            whole_ms = _time_ms(torch, lambda: ops.tree_verify(
                q, kw, vw, qp, kpw, tmw), 20, flush)
        parts = [call(), call()]
        merge_ms = _time_ms(torch, lambda: merge_lse(parts), 20, flush)
        b_ms, b_by = _bound_ms(q, k, qp, kp, 0, "bfloat16", tree=tm,
                               lse=True)
        route, n_split = ops.plan(q.dtype, *q.shape[:3], k.shape[2],
                                  q.shape[3], k.shape[1])
        key = f"{'tree' if tree else 'k1'}_T{T}"
        out[key] = {"T": T, "S": k.shape[1], "route": route,
                    "n_split": n_split, "ms": t["median"], "ms_spread": t,
                    "plain_ms": plain_ms, "library_ms": lt["median"],
                    "library_spread": lt, "whole_ms": whole_ms,
                    "merge_ms": merge_ms, "bound_ms": b_ms,
                    "bound_by": b_by}
        log(f"  {'tree_verify' if tree else 'spec_verify'} lse=True at a "
            f"rank's share T={T} over {k.shape[1]} slots (B={B}, "
            f"bf16, route {route}, n_split {n_split}): "
            f"{_spread(t)} ms; the whole cache's {2 * k.shape[1]} slots "
            f"without partials {whole_ms:.4f} ms; SDPA on the share "
            f"{_spread(lt)} ms; plain {plain_ms:.4f} ms; the merge of two "
            f"ranks' partials {merge_ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by})")
        del q, k, v, kw, vw, parts
        _free(torch)
    ops.launches.update(n0)      # timing launches are not a path's
    return out


def _model_axis(ctx):
    """``ctx`` (a context of the (``PROD_DATA``, ``TP``) mesh) with its
    data axes dropped: the production context of its model group alone,
    (c)'s and (d)'s."""
    import dataclasses
    return dataclasses.replace(ctx, dp=(), axis_sizes=(), coords=(),
                               dp_group=None, fsdp_group=None,
                               pod_group=None)


def _on_data(torch, cfg, sctx):
    """``keep`` of (e)'s faulted steps: the leaves whole on ``data`` of a
    tree of this rank's pieces, on the host, by path."""
    from repro_torch.launch import steps
    from repro_torch.training.optim import tree_items

    def keep(t):
        whole = steps.walk_leaves(t, lambda x, kind, name: steps.data_piece(
            cfg, kind, name, sctx) is None)
        return {path: x.detach().cpu() for (path, x), (_, w) in zip(
            tree_items(t), tree_items(whole)) if w}
    return keep


def _data_faults(torch):
    """(e)'s planted faults: (name, a context manager that plants it)."""
    import contextlib

    from repro_torch import sharding
    from repro_torch.training import grpo

    @contextlib.contextmanager
    def patched(module, name, fn):
        real = getattr(module, name)
        setattr(module, name, fn(real))
        try:
            yield
        finally:
            setattr(module, name, real)

    def local_denom(real):
        def sums(terms, sctx):
            out = real(terms, sctx)
            return torch.cat([torch.stack(terms)[:1], out[1:]])
        return sums
    return (("the gradient of each leaf whole on data left unsummed over "
             "data", lambda: patched(sharding, "data_whole",
                                     lambda real: lambda t, sctx: t)),
            ("the loss's denom left local",
             lambda: patched(grpo, "_global_sums", local_denom)))


def _fault_gaps(one, fault, device) -> dict:
    """A faulted step of (e) against the oracle's (``one``, this rank's
    pieces on ``device``): loss and grad norm, and each kept gradient
    leaf's largest gap against its largest value; ``passes`` whether
    ``PROD_TOL`` holds them all (it must not)."""
    from repro_torch.training.optim import tree_items
    grads = dict(tree_items(one["grads"]))
    worst = 0.0
    for path, g in fault["grads"].items():
        want = grads[path]
        top = float(want.abs().max())
        worst = max(worst, float((g.to(device) - want).abs().max())
                    / max(top, 1e-30))
    loss_ok = abs(fault["loss"] - one["loss"]) <= PROD_TOL["loss"] * max(
        abs(one["loss"]), 1.0)
    norm_ok = abs(fault["grad_norm"] - one["grad_norm"]) \
        <= PROD_TOL["grad_norm"] * one["grad_norm"]
    return {"loss": fault["loss"], "grad_norm": fault["grad_norm"],
            "leaves": len(fault["grads"]), "grad_rel_err": worst,
            "passes": loss_ok and norm_ok and worst <= PROD_TOL["grads"]}


def prod_rank(rank: int, world: int, device, out_dir: str) -> None:
    """A rank of the production layout's checks on ranks: four gloo
    ranks on the card laid out as a (``PROD_DATA``, ``TP``) mesh.  On
    its first model group (ranks 0 and 1; the others wait): (d) the
    cached steps at tp = 2 (``_prod_cached``), then per arch of
    ``PROD_TRAIN`` (c) the step at tp = 2 (``_prod_train``, this rank's
    pieces kept on the host).  On all four, (e): the cached steps on the
    mesh (each data rank on its rows), then per arch the step on the
    mesh, with FSDP, granite's also with each planted fault
    (``_data_faults``); then on each rank in turn, the others idle with
    their memory freed, the oracles: the one-rank step on a hand-built
    context with the data axis and no group (the MoE layers' data shards
    one after another; for a dense arch the tp = 1 step too), cut to this
    rank's pieces on the card and held to them there (``_prod_gaps``,
    ``_fault_gaps``); writes ``out_dir/prod{rank}.pkl``, with rank 0's
    wall clock at the start and the end of each stage (``stamps``)."""
    import dataclasses
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh, make_shard_ctx
    from repro_torch.sharding import ShardCtx
    from repro_torch.training.optim import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((PROD_DATA, TP), ("data", "model"))
    train4 = make_shard_ctx(mesh, train=True)
    two_ctx = _model_axis(train4)
    one_ctx = dataclasses.replace(two_ctx, group=None, tp_size=1, rank=0,
                                  host_group=None)
    data_ctx = ShardCtx(tp_size=1, dp=("data",), exact=False,
                        axis_sizes=(("data", PROD_DATA),))
    first = mesh.index("data") == 0
    out = {"stamps": [("start", time.time())]}

    out["peak_gb"] = {}

    def stamp(name):
        out["stamps"].append((name, time.time()))
        if torch.cuda.is_available():
            out["peak_gb"][name] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
    serve4 = make_shard_ctx(mesh, train=False)
    if first:
        out["cached"] = _prod_cached(torch, np, rank, device, out_dir,
                                     _model_axis(serve4))
    dist.barrier()
    stamp(f"(d) cached steps tp={TP}")
    out["cached_e"] = _prod_cached(torch, np, rank, device, out_dir, serve4,
                                   faults=False)
    dist.barrier()
    stamp(f"(e) cached steps {PROD_MESH}")

    def host(t):
        return tree_map(lambda x: x.detach().cpu(), t)
    for arch, layers in PROD_TRAIN:
        cfg = dataclasses.replace(_arch_cfg(arch, layers), dtype="float32")
        two = (_prod_train(torch, np, cfg, two_ctx, device, keep=host)
               if first else None)
        _free(torch)
        dist.barrier()
        stamp(f"(c) {arch} tp={TP}")
        base = _prod_pieces(torch, cfg, train4, device, stagger=True)
        four = _prod_train(torch, np, cfg, train4, device, keep=host,
                           pieces=base)
        _free(torch)
        dist.barrier()
        stamp(f"(e) {arch} {PROD_MESH}")
        faults = {}
        if not cfg.num_experts:
            for name, plant in _data_faults(torch):
                with plant():
                    faults[name] = _prod_train(
                        torch, np, cfg, train4, device,
                        keep=_on_data(torch, cfg, train4), pieces=base)
                _free(torch)
            dist.barrier()
            stamp(f"(e) {arch} planted faults")
        del base
        for r in range(world):
            dist.barrier()
            if rank == r:
                both = first and not cfg.num_experts
                one = _prod_train(torch, np, cfg, data_ctx, device,
                                  keep=lambda t: {
                                      "e": steps.param_shards(cfg, t, train4),
                                      "c": steps.param_shards(cfg, t, two_ctx)
                                      if both else None})
                mine = dict(one, grads=one["grads"]["e"],
                            update=one["update"]["e"])
                out[arch + "/data"] = _prod_gaps(mine, four, device)
                out[arch + "/data"].update(
                    layers=cfg.num_layers, want=_train_step_want(cfg),
                    traffic_e=four["traffic"],
                    faults={n: _fault_gaps(mine, f, device)
                            for n, f in faults.items()})
                if first:
                    if not both:
                        del one, mine
                        _free(torch)
                        one = _prod_train(
                            torch, np, cfg, one_ctx, device,
                            keep=lambda t: {"c": steps.param_shards(
                                cfg, t, two_ctx)})
                    out[arch] = _prod_gaps(dict(
                        one, grads=one["grads"]["c"],
                        update=one["update"]["c"]), two, device)
                    out[arch].update(layers=cfg.num_layers,
                                     want=_train_step_want(cfg))
                del one
            _free(torch)
        del two, four, faults
        _free(torch)
        dist.barrier()
        stamp(f"{arch} oracles on each rank")
    with open(os.path.join(out_dir, f"prod{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _prod_checks(arch, ranks, key=None, what=f"tp={TP}",
                 oracle="tp=1") -> dict:
    """(c) tp = 2 against tp = 1 at ``PROD_TOL`` over both ranks' pieces
    (and (e), ``key`` "<arch>/data": the mesh against its one-rank
    oracle over the four ranks' pieces): losses, grad norm, aux loss,
    every gradient leaf (its largest gap against its largest value, over
    the ranks), the update of the elements the gradient check holds
    (``_prod_gaps``), equal capacity drops, every rank's dispatch in both
    runs equal to the plain slot rule, and each rank's launches those of
    a train step."""
    key = key or arch
    r0 = ranks[0][key]
    one, two = r0["one"], r0["two"]
    for r in ranks:
        check(r[key]["two"] == two, f"{arch}: the ranks' {what} losses, "
              "norms or drops differ")
        for k_, v_ in r[key]["want"].items():
            got = r[key]["launches"].get(k_, 0)
            check(got == v_, f"{arch} production train step at {what}: "
                  f"{k_} {got} != {v_}")
    for k_ in ("loss", "aux_loss"):
        check(abs(two[k_] - one[k_]) <= PROD_TOL["loss"] * max(
            abs(one[k_]), 1.0), f"{arch}: {k_} {what} {two[k_]} vs {oracle} "
            f"{one[k_]}")
    check(abs(two["grad_norm"] - one["grad_norm"]) <= PROD_TOL["grad_norm"]
          * one["grad_norm"], f"{arch}: grad norm {what} {two['grad_norm']} "
          f"vs {oracle} {one['grad_norm']}")
    check(two["drops"] == one["drops"], f"{arch}: capacity drops {what} "
          f"{two['drops']} vs {oracle} {one['drops']}")
    worst = 0.0
    for path in r0["grads"]:
        err = max(r[key]["grads"][path][0] for r in ranks)
        scale = max(r[key]["grads"][path][1] for r in ranks)
        check(scale > 0, f"{arch}: gradient {path} is zero")
        check(err <= PROD_TOL["grads"] * scale, f"{arch}: gradient {path} "
              f"off by {err:.3e} of scale {scale:.3e}")
        worst = max(worst, err / scale)
    misses = [r[key]["slot_rule_misses"] for r in ranks]
    check(all(m == (0, 0) for m in misses), f"{arch}: (token, k) pairs "
          f"whose drop or slot differs from the plain slot rule, "
          f"({oracle}, {what}) a rank: {misses}")
    gap = max(r[key]["update_gap_lr"] for r in ranks)
    moved = min(r[key]["update_moved_lr"] for r in ranks)
    held = sum(r[key]["update_held"] for r in ranks)
    total = sum(r[key]["update_total"] for r in ranks)
    check(held > 0, f"{arch}: no update element held")
    check(gap <= PROD_TOL["update"], f"{arch}: {what}'s update off {oracle}'s "
          f"by {gap:.3e} lr")
    check(moved >= PROD_TOL["moved"], f"{arch}: {oracle}'s update moved an "
          f"element held by only {moved:.3e} lr")
    return {"layers": r0["layers"], "one": one, "two": two,
            "grad_rel_err": worst, "update_gap_lr": gap,
            "update_moved_lr": moved, "update_held": held,
            "update_total": total,
            "launches": r0["launches"], "launches_tp1": r0["launches_tp1"],
            "step_wall_s": [r[key]["step_wall_s"] for r in ranks]}


def _data_bytes(traffic) -> str:
    """A rank's bytes into the data axes' collectives, from
    ``sharding.traffic``."""
    names = (("data_all_gather", "FSDP gathers"),
             ("data_reduce_scatter", "reduce-scatters over data"),
             ("dp_all_reduce", "all-reduces over the data-parallel group"),
             ("data_all_reduce", "all-reduces over data"))
    return ", ".join(f"{traffic[k_ + '_bytes'] / 1e9:.3f} GB in "
                     f"{traffic[k_]} {what}" for k_, what in names
                     if traffic[k_])


def production_phase(torch, np) -> dict:
    """The phase "production layout": (a) ``production_steps`` (saved for
    (d) and (e)), (b) ``prefill_kernels_check`` and
    ``prefill_kernels_time``, K1 / K2's partials at a rank's share
    (``share_kernels_check``, ``share_kernels_time``) of (d) and of (e),
    then ``prod_rank`` in four gloo ranks on the card (a (``PROD_DATA``,
    ``TP``) mesh): (d) the cached steps at tp = 2 against (a)
    (``_prod_cached_checks``) and (c) the train step at tp = 2 against
    tp = 1 (``_prod_checks``) on the first model group, (e) the cached
    steps on the mesh against (a) and its train step against the
    one-rank oracle with the data axis, whose planted faults must fail;
    with rank 0's stages timed."""
    import pickle
    import tempfile

    from repro_torch.launch.mesh import spawn
    ranks = []
    world = PROD_DATA * TP
    with tempfile.TemporaryDirectory(prefix="prod_") as tmp:
        rep = {"steps": production_steps(torch, np, TP_DEVICE, save_to=tmp)}
        log("  K1 at the production prefill's widths")
        rep["k1_checks"] = prefill_kernels_check(torch, np)
        rep["k1_time"] = prefill_kernels_time(torch, np)
        rep["tree_time"] = tree_kernels_time(
            torch, np, B=PROD_B, S=PROD_S, T=7,
            live=np.full(PROD_B, rep["steps"]["tree_live"]))
        log_verify_time("tree_verify (production tree step)",
                        rep["tree_time"])
        log("  K1 / K2 partials (lse=True) at a rank's share of (d)'s "
            "cache and of (e)'s (its data rank's rows)")
        rep["share_checks"] = share_kernels_check(torch, np)
        rep["share_time"] = share_kernels_time(torch, np)
        rows_e = PROD_B // PROD_DATA
        rep["share_checks_e"] = share_kernels_check(torch, np, B=rows_e)
        rep["share_time_e"] = share_kernels_time(torch, np, B=rows_e)
        _free(torch)
        t0, clock0 = time.perf_counter(), time.time()
        spawn(prod_rank, world, backend="gloo", device=TP_DEVICE,
              args=(tmp,))
        clock1 = time.time()
        for r in range(world):
            with open(os.path.join(tmp, f"prod{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    rep["train_wall_s"] = time.perf_counter() - t0
    # rank 0's stages on the wall clock: its start after the spawn, (d),
    # (e)'s cached steps, then per arch (c)'s tp = 2 step and (e)'s on
    # the mesh (weights made, stepped, pieces to the host), (e)'s planted
    # faults, the oracles (one on each rank in turn, gaps on the card),
    # the exit
    stamps = [("spawn", clock0)] + ranks[0]["stamps"] + [("exit", clock1)]
    rep["train_stages_s"] = {name: b - a for (_, a), (name, b) in zip(
        stamps, stamps[1:])}
    first = ranks[:TP]
    c = rep["cached"] = _prod_cached_checks(first)
    g = c["gaps"]
    log(f"  (d) granite-3-8b ({c['layers']} layers, full width, bf16) "
        f"cached steps at tp={TP} ({c['piece']} of {PROD_S} slots a rank) "
        f"against (a)'s one-rank run: {c['equal_held']} of {c['held']} "
        f"greedy tokens above the margin ({PROD_MARGIN} of scale) equal, "
        f"{c['other_equal']} of the {c['other']} others; logits' scaled "
        f"gap max {max(c['logit_gaps']):.3e}; gathered cache after the "
        f"prefill {g['prefill']}, at the end {g['final']} (K/V limit "
        f"{PROD_CACHE_TOL}); a rank's launches " + ", ".join(
            f"{k_} {v_}" for k_, v_ in sorted(c["launches"].items()) if v_)
        + f", no plain call; walls prefill {c['walls']['prefill']:.2f} s, "
        f"the other steps {c['walls']['steps']:.2f} s; planted faults: "
        + "; ".join(f"{n} {f_}" for n, f_ in c["faults"].items()))
    e = rep["cached_e"] = _prod_cached_checks(
        ranks, key="cached_e", what=PROD_MESH,
        row_ranks=tuple(range(0, world, TP)))
    g = e["gaps"]
    log(f"  (e) the same cached steps on the {PROD_MESH} mesh ({e['rows']} "
        f"of {PROD_B} rows and {e['piece']} of {PROD_S} slots a rank) "
        f"against (a): {e['equal_held']} of {e['held']} greedy tokens "
        f"above the margin equal, {e['other_equal']} of the {e['other']} "
        f"others; logits' scaled gap max {max(e['logit_gaps']):.3e}; "
        f"gathered cache after the prefill {g['prefill']}, at the end "
        f"{g['final']}; a rank's launches " + ", ".join(
            f"{k_} {v_}" for k_, v_ in sorted(e["launches"].items()) if v_)
        + f", no plain call; walls prefill {e['walls']['prefill']:.2f} s, "
        f"the other steps {e['walls']['steps']:.2f} s")
    rep["train"], rep["train_e"] = {}, {}
    for arch, _ in PROD_TRAIN:
        r = rep["train"][arch] = _prod_checks(arch, first)
        one, two = r["one"], r["two"]
        log(f"  {arch} ({r['layers']} layers, full width, f32) train step "
            f"at tp={TP} against tp=1: loss {two['loss']:.6e} / "
            f"{one['loss']:.6e}, grad norm {two['grad_norm']:.6e} / "
            f"{one['grad_norm']:.6e}, gradients within "
            f"{r['grad_rel_err']:.2e} of each leaf's scale, the update "
            f"within {r['update_gap_lr']:.2e} lr of tp=1's on the "
            f"{r['update_held']} of {r['update_total']} elements held "
            f"(tp=1's at least {r['update_moved_lr']:.3f} lr there); "
            f"capacity drops {two['drops']} / {one['drops']} of "
            f"{one['routed']} routed pairs, every pair's drop and slot "
            f"the plain rule's; a rank's launches " + ", ".join(
                f"{k_} {v_}" for k_, v_ in sorted(r["launches"].items())
                if v_) + f"; step walls (tp=1, tp={TP}) "
            f"{r['step_wall_s'][0]}")
        key = arch + "/data"
        r = rep["train_e"][arch] = _prod_checks(
            arch, ranks, key=key, what=PROD_MESH,
            oracle="the one-rank oracle")
        one, two = r["one"], r["two"]
        faults = {n: [rk[key]["faults"][n] for rk in ranks]
                  for n in ranks[0][key]["faults"]}
        for n, per_rank in faults.items():
            check(not any(f_["passes"] for f_ in per_rank),
                  f"{arch} on the {PROD_MESH} mesh: the planted fault "
                  f"'{n}' passes the train step's gate: {per_rank}")
        r["faults"] = faults
        r["traffic"] = ranks[0][key]["traffic_e"]
        log(f"  (e) {arch} train step on the {PROD_MESH} mesh (FSDP of "
            f"embed over data, {PROD_TRAIN_B // PROD_DATA} of "
            f"{PROD_TRAIN_B} rows a data rank) against the one-rank oracle "
            f"with the data axis: loss {two['loss']:.6e} / "
            f"{one['loss']:.6e}, grad norm {two['grad_norm']:.6e} / "
            f"{one['grad_norm']:.6e}, gradients within "
            f"{r['grad_rel_err']:.2e} of each leaf's scale, the update "
            f"within {r['update_gap_lr']:.2e} lr on the "
            f"{r['update_held']} of {r['update_total']} elements held; "
            f"capacity drops {two['drops']} / {one['drops']}, every "
            f"pair's drop and slot the plain rule's; a rank's launches "
            + ", ".join(f"{k_} {v_}" for k_, v_ in sorted(
                r["launches"].items()) if v_)
            + f"; rank 0 sent {_data_bytes(r['traffic'])}; step walls "
            f"(oracle, mesh) {r['step_wall_s'][0]}"
            + "".join(f"; planted fault '{n}': loss {f_[0]['loss']:.6e}, "
                      f"grad norm {f_[0]['grad_norm']:.6e}, gradients of "
                      f"{f_[0]['leaves']} leaves whole on data within "
                      f"{max(x['grad_rel_err'] for x in f_):.2e} of "
                      f"scale: fails" for n, f_ in faults.items()))
    # K3 at a rank's granite heads and the train step's shape, f32: (c)'s
    # and (e)'s (a data rank's rows)
    hq, hk, d, _ = K1_SHAPES["granite-3-8b"]
    rep["flash_time"] = flash_kernels_time(
        torch, np, B=PROD_TRAIN_B, T=PROD_TRAIN_S, Hq=hq // TP, Hk=hk // TP,
        D=d, dtype="float32", iters=20)
    rep["flash_time_e"] = flash_kernels_time(
        torch, np, B=PROD_TRAIN_B // PROD_DATA, T=PROD_TRAIN_S, Hq=hq // TP,
        Hk=hk // TP, D=d, dtype="float32", iters=20)
    rep["peak_gb"] = [r_["peak_gb"] for r_ in ranks]
    log("  each rank's peak device memory a stage (GB): " + "; ".join(
        f"rank {i}: " + ", ".join(f"{k_} {v_:.1f}" for k_, v_ in p_.items())
        for i, p_ in enumerate(rep["peak_gb"])))
    log(f"  ranks {rep['train_wall_s']:.1f} s (" + ", ".join(
        f"{k_} {v_:.1f}" for k_, v_ in rep["train_stages_s"].items())
        + f" s) — {world} ranks sharing one card over gloo (every "
        "collective staged through host memory) are no measure of the "
        "layout's speed")
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0,
                    help="profile this many engine steps and one train "
                    "step (0: off)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, check K1, K2 and K4 and time them at the "
                    "fixed widths, then stop (no slices, no result line)")
    ap.add_argument("--tp-only", action="store_true",
                    help="build, check K1 and K2, then run the "
                    "tensor-parallel phase and stop (no result line)")
    ap.add_argument("--out", default=None,
                    help="directory for the full JSON report and traces")
    args = ap.parse_args()

    # cuBLAS is deterministic only with a fixed workspace, set before
    # CUDA starts (the training phase repeats a train step bitwise)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.row_gemm import ops as rg_ops
    from repro_torch.kernels.row_reduce import ops as rr_ops
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = args.out
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}

    card = card_line()
    log(card)
    report["card"] = card
    device_kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    t_phase = [t0]
    report["phase_s"] = {}

    def phase_done(name):
        now = time.perf_counter()
        report["phase_s"][name] = now - t_phase[0]
        log(f"phase {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    libs = (ops.LIBRARY, fa_ops.LIBRARY, ssd_ops.LIBRARY,
            ssd_ops.BWD_LIBRARY, rg_ops.LIBRARY, rr_ops.LIBRARY)
    build.build_all(libs)
    log("build (one nvcc each, in parallel): " + ", ".join(
        f"{lib.source.name} -> sm_90a in {lib.seconds:.1f} s"
        for lib in libs) + f"; {time.perf_counter() - t0:.1f} s in all")
    report["build_seconds"] = {lib.name: lib.seconds for lib in libs}
    if out_dir:
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write("\n".join(lib.log for lib in libs))
    want = {"K3": (fa_ops.LIBRARY, FLASH_WGMMA, "HGMMA",
                   [f"flash_{w}_wgmma<{D}>" for w in ("fwd", "dq", "dkdv")
                    for D in (64, 128)]),
            "K1/K2": (ops.LIBRARY, VERIFY_WGMMA, "HGMMA",
                      [f"verify_wgmma<{D},{t}>" for D in (64, 128)
                       for t in (0, 1)]),
            # K4's tensor-core route runs mma.sync (HMMA in SASS)
            "K4": (ssd_ops.LIBRARY, SSD_MMA, "HMMA",
                   [f"ssd_tensor_cores<{n},{pt}>"
                    for n, pt in ssd_ops.TC_INSTANCES]),
            # row_gemm's bf16 kernel runs mma.sync too
            "row_gemm": (rg_ops.LIBRARY, ROW_GEMM_MMA, "HMMA",
                         ["gemm_bf16<0>", "gemm_bf16<1>"])}
    for kname, (lib, pattern, opcode, names) in want.items():
        hgmma = hgmma_counts(lib.path(), pattern, opcode)
        report[f"{kname.lower().replace('/', '_')}_hgmma"] = hgmma
        if hgmma is None:
            log(f"{kname} {opcode} instructions in SASS: not available (no "
                "cuobjdump)")
            continue
        log(f"{kname} {opcode} instructions in SASS: " + ", ".join(
            f"{k} {v}" for k, v in sorted(hgmma.items())))
        for name in names:
            check(hgmma.get(name, 0) > 0, f"no {opcode} in {name}'s SASS")

    report["timer_self_check_ms"] = timer_self_check(torch)
    log(f"timer self-check: a 4-byte zero_() after an L2 flush reads "
        f"{report['timer_self_check_ms']:.4f} ms (max of 3 round medians; "
        f"limit 0.010)")
    phase_done("build")

    B, S = 8, 2048

    def tensor_parallel():
        log(f"tensor parallel: tp=1 and tp={TP} (two gloo ranks on cuda:0) "
            f"at full width on " + ", ".join(
                f"{a} ({n} layers)" for a, n, _ in TP_MODELS)
            + f", {TP_GROUPS} groups x {GROUP_SIZE}, {TP_NEW_TOKENS} "
            f"tokens, bf16; granite at {TP_F32_LAYERS} layers in f32")
        _free(torch)
        rep_ = report["tensor_parallel"] = tp_phase(torch, np)
        log(f"  ranks {rep_['ranks_wall_s']:.1f} s (spawn, weights, every "
            f"run), the largest rollout peak of each rank "
            f"{rep_['peak_mem_gb']} GB; the phase "
            f"{rep_['phase_s']:.1f} s — {NOT_A_SPEED}")
        phase_done("tensor parallel")
        return rep_

    def finish_kernels_only():
        if out_dir:
            with open(os.path.join(out_dir, "report.json"), "w") as f:
                json.dump(report, f, indent=1, default=str)
        log(card)
        return 0

    def ssd_kernels():
        log("kernels: ssd_scan (K4) against its plain version")
        report["ssd_kernel_checks"] = ssd_kernels_check(torch, np)
        log("ssd_scan: the tensor-core route's operand choices, emulated")
        report["ssd_operand_errors"] = ssd_operand_errors(torch, np)
        log("kernels: ssd_scan_bwd (K4's backward) against its plain "
            "version and autograd through the plain forward")
        report["ssd_bwd_checks"] = ssd_bwd_check(torch, np)

    log("kernels: spec_verify (K1) against its plain version")
    report["kernel_checks"] = kernels_check(torch, np, B=B, S=S,
                                            T_list=CHECK_WIDTHS)
    log("kernels: spec_verify (K1) at the cross blocks' shapes")
    report["cross_kernel_checks"] = cross_kernels_check(torch, np, B=B)
    log("kernels: spec_verify (K1) at the serving phase's shapes")
    report["serving_kernel_checks"] = serving_kernels_check(torch, np)

    log("kernels: tree_verify (K2) against its plain version")
    report["tree_kernel_checks"] = tree_kernels_check(
        torch, np, B=B, S=S, T_list=CHECK_WIDTHS)

    log("kernels: row_gemm (the engine path's products) against its plain "
        "version, and row by row")
    report["row_gemm_checks"] = row_gemm_check(torch, np)
    log("kernels: row_reduce (RMSNorm, the logits' log-sum-exp) against "
        "their plain versions, and row by row")
    report["row_reduce_checks"] = row_reduce_check(torch, np)
    log("kernels: K1 / K2 row by row: each row's first query at every "
        "width and batch")
    report["verify_row_checks"] = verify_row_check(torch, np)
    log("PyTorch's own operations row by row (what the row-invariant "
        "kernels remove; printed, not gated)")
    report["library_row_probe"] = library_row_probe(torch, np)

    if args.tp_only:
        tensor_parallel()
        return finish_kernels_only()

    if args.kernels_only:
        ssd_kernels()
        log("K1 / K2 timing at the fixed widths")
        report["verify_time"] = verify_time_table(torch, np, B=B, S=S)
        log("K4 timing at the fixed widths")
        report["ssd_time"] = ssd_time_table(torch, np)
        log("K4's backward timing at the trainers' shape")
        report["ssd_bwd_time"] = ssd_bwd_time_table(torch, np)
        log("row_gemm timing at granite-3-8b's products")
        report["row_gemm_time"] = row_gemm_time(torch, np)
        return finish_kernels_only()

    log("kernels: flash_attention (K3) forward, dQ and dK/dV against "
        "their plain versions")
    report["flash_kernel_checks"] = flash_kernels_check(torch, np)
    log("kernels: flash_attention (K3) backward at the cross blocks' "
        "training shapes")
    report["cross_bwd_checks"] = cross_bwd_check(torch, np)

    ssd_kernels()
    phase_done("kernel checks")

    log(f"production layout: granite-3-8b ({PROD_LAYERS} layers) "
        f"cached steps on one rank and at tp={TP}, K1 at the prefill "
        f"widths {[t for t, _ in PROD_K1_WIDTHS]}, the train step of "
        + ", ".join(f"{a} ({n} layers)" for a, n in PROD_TRAIN)
        + f" at tp={TP} against tp=1, f32, and (e) the cached and train "
        f"steps on a {PROD_MESH} mesh (data x model; FSDP over data) "
        f"against one rank (four gloo ranks on {TP_DEVICE})")
    _free(torch)
    prod = report["production"] = production_phase(torch, np)
    phase_done("production layout")

    log("linear slice: granite-3-8b Seer rollout on the card")
    cfg, params = build_model(torch, layers=LINEAR_LAYERS)
    L = cfg.num_layers
    prompts = make_prompts(np, cfg, GROUPS, seed=1)
    report["sync_debug"] = sync_debug_steps(torch, np, cfg, params)
    log(f"  dispatch under sync debug 'error': T per step "
        f"{report['sync_debug']['step_T']}, host syncs "
        f"{report['sync_debug']['host_syncs_per_step']}")
    runs = []
    for _ in range(2):
        ro = make_rollout(cfg, params)
        runs.append(run_rollout(torch, ro, prompts))
    # a third pass on the second rollout, its group CSTs warm from the
    # second pass (a replay of its responses: gated equal below), then a
    # fourth at SHIFT_TEMPERATURE, the like-for-like yardstick of the tree
    # slice's measured pass (same method, linear drafts)
    ro.reset_acceptance_profile()
    lw = run_rollout(torch, ro, prompts)
    ro.reset_acceptance_profile()
    lsh = run_rollout(torch, ro, prompts, temperature=SHIFT_TEMPERATURE)
    del ro
    r = runs[0]
    st = r["stats"]
    k1_launches = r["launches"]["spec_verify"]
    check(r["finished"], "not every group finished")
    check(k1_launches > 0, "the rollout launched K1 no time")
    check(k1_launches == r["fused_steps"] * L,
          f"K1 launches {k1_launches} != cached forwards "
          f"{r['fused_steps']} x {L}")
    check(r["launches"]["tree_verify"] == 0,
          "the linear rollout launched K2")
    check(r["host_syncs"] <= st.steps,
          f"host syncs {r['host_syncs']} > steps {st.steps}")
    check(runs[1]["responses"] == r["responses"],
          "repeat rollout not bit-identical")
    check(runs[1]["launches"] == r["launches"],
          "repeat rollout launched K1 a different number of times")
    want_rows = {"row_gemm": 7 * L + 1, "rms_norm": 2 * L + 1,
                 "logsumexp": 1}
    for k_, per in want_rows.items():
        check(r["launches"][k_] == r["fused_steps"] * per,
              f"{k_} launches {r['launches'][k_]} != cached forwards "
              f"{r['fused_steps']} x {per}")
    check(r["plain_calls"] == 0, f"the linear slice made {r['plain_calls']} "
          "plain calls on the card")
    lens = [len(x) for x in r["responses"].values()]
    check(all(n == NEW_TOKENS for n in lens),
          f"response lengths {sorted(set(lens))}")
    slice_rep = {
        "layers": L, "requests": len(lens),
        "tokens": st.tokens, "steps": st.steps, "chunks": st.chunks,
        "migrations": st.migrations, "drafted": st.drafted,
        "accepted": st.accepted, "mean_acceptance": st.mean_acceptance,
        "host_syncs": r["host_syncs"], "k1_launches": k1_launches,
        "fused_steps": r["fused_steps"],
        "tokens_per_step": st.tokens / r["fused_steps"],
        "fused_by_T": r["by_kind"],
        "wall_s": [x["wall_s"] for x in runs],
        "tokens_per_s": [st.tokens / x["wall_s"] for x in runs],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    lwst = lw["stats"]
    check(lw["finished"], "linear warm pass: not every group finished")
    check(lw["launches"]["spec_verify"] == lw["fused_steps"] * L,
          "linear warm pass: K1 launches != steps x layers")
    check(lw["host_syncs"] <= lwst.steps, "linear warm pass: host syncs > "
          "steps")
    # the warm pass batches other rows and step widths than the cold one
    # (drafts verified, other migrations), and the engine is row-invariant
    check(sum(lw["responses"][k] == v for k, v in r["responses"].items())
          == len(lens), "linear warm pass: responses differ from the cold "
          "pass's")
    slice_rep["warm"] = {
        "fused_steps": lw["fused_steps"],
        "tokens_per_step": lwst.tokens / lw["fused_steps"],
        "drafted": lwst.drafted, "accepted": lwst.accepted,
        "mean_acceptance": lwst.mean_acceptance, "wall_s": lw["wall_s"],
        "tokens_per_s": lwst.tokens / lw["wall_s"],
        "same_responses": sum(lw["responses"][k] == v
                              for k, v in r["responses"].items())}
    shst = lsh["stats"]
    check(lsh["finished"] and lsh["launches"]["spec_verify"] ==
          lsh["fused_steps"] * L and lsh["host_syncs"] <= shst.steps,
          "linear shifted pass: unfinished, or K1 launches or host syncs "
          "off")
    slice_rep["shifted"] = {
        "temperature": SHIFT_TEMPERATURE,
        "fused_steps": lsh["fused_steps"],
        "tokens_per_step": shst.tokens / lsh["fused_steps"],
        "drafted": shst.drafted, "accepted": shst.accepted,
        "mean_acceptance": shst.mean_acceptance, "wall_s": lsh["wall_s"],
        "tokens_per_s": shst.tokens / lsh["wall_s"]}
    report["slice"] = slice_rep
    log(f"  tokens {st.tokens}, steps {st.steps}, chunks {st.chunks}, "
        f"migrations {st.migrations}, drafted {st.drafted}, accepted "
        f"{st.accepted} (mean acceptance {st.mean_acceptance:.4f}), "
        f"tokens per engine step {slice_rep['tokens_per_step']:.3f}")
    log(f"  K1 launches {k1_launches} = {r['fused_steps']} cached "
        f"forwards x {L}; row_gemm {r['launches']['row_gemm']} = x "
        f"(7 x {L} + 1), rms_norm {r['launches']['rms_norm']} = x (2 x {L} "
        f"+ 1), logsumexp {r['launches']['logsumexp']}; no plain call; host "
        f"syncs {r['host_syncs']} <= steps {st.steps}; fused steps by T "
        f"{r['by_kind']}")
    log(f"  wall s {[round(x, 3) for x in slice_rep['wall_s']]}, "
        f"tokens/s {[round(x, 1) for x in slice_rep['tokens_per_s']]}, "
        f"repeat bit-identical: True, peak memory "
        f"{slice_rep['peak_mem_gb']:.1f} GB")
    w_ = slice_rep["warm"]
    log(f"  warm pass (group CSTs from the pass before): engine steps "
        f"{w_['fused_steps']}, tokens per step {w_['tokens_per_step']:.3f}"
        f", drafted {w_['drafted']}, accepted {w_['accepted']}, wall "
        f"{w_['wall_s']:.3f} s, {w_['tokens_per_s']:.1f} tokens/s, "
        f"responses equal to the cold pass: {w_['same_responses']}/"
        f"{len(lens)}")
    sh_ = slice_rep["shifted"]
    log(f"  shifted pass (temperature {SHIFT_TEMPERATURE}, group CSTs from "
        f"the passes at 1.0): engine steps {sh_['fused_steps']}, tokens per "
        f"step {sh_['tokens_per_step']:.3f}, drafted {sh_['drafted']}, "
        f"accepted {sh_['accepted']}, wall {sh_['wall_s']:.3f} s, "
        f"{sh_['tokens_per_s']:.1f} tokens/s")
    if args.profile:
        report["profile"] = profile_steps(torch, cfg, params, args.profile)
        p = report["profile"]
        log(f"  profile of {p['steps']} steps: wall {p['wall_ms']:.1f} "
            f"ms, device {p['device_ms']:.1f} ms (busy share "
            f"{p['busy_share']:.3f})")
        for k_, t_, n_ in p["top"][:12]:
            log(f"    {t_:10.3f} ms  x{n_:<6d} {k_[:90]}")

    log(f"row probe: granite-3-8b ({L} layers) cached forward row by row: a "
        "slot alone against the 8-slot step, a decode against a verify's "
        "first position")
    report["row_probe"] = {"granite-3-8b": {
        "port": row_probe(torch, np, cfg, params),
        "library": row_probe(torch, np, cfg, params, library=True)}}
    log_row_probe("granite-3-8b", report["row_probe"]["granite-3-8b"]["port"])
    log_row_probe("granite-3-8b with PyTorch's operations (not gated)",
                  report["row_probe"]["granite-3-8b"]["library"], gate=False)
    phase_done("linear slice")

    log("tree engine: fused tree steps against the sync oracle")
    te = tree_engine_check(torch, np, cfg, params)
    report["tree_engine"] = te
    log(f"  {te['steps']} steps, each equal to the sync oracle from the "
        f"same state (tokens, accept counts, slot_pos, K/V at committed "
        f"slots), 1 host sync and {L} K2 launches each, dispatch clean "
        f"under sync debug 'error'; {te['accepted']} drafts accepted, "
        f"{te['side_branch_steps']} row-steps accepted along the side "
        f"branch; tree nodes {te['tree_nodes']} (branching "
        f"{te['tree_branch_nodes']})")

    phase_done("tree engine")

    log("tree slice: the same rollout with spec_mode='tree', 3 paths: a "
        "warm pass at temperature 1.0, then the measured pass at "
        f"{SHIFT_TEMPERATURE}")
    ro = make_rollout(cfg, params, spec_mode="tree", multipath_top_k=3)
    warm = run_rollout(torch, ro, prompts)
    ro.reset_acceptance_profile()
    tr = run_rollout(torch, ro, prompts, temperature=SHIFT_TEMPERATURE)
    del ro
    tst = tr["stats"]
    k2_launches = tr["launches"]["tree_verify"]
    for which, x in (("warm", warm), ("measured", tr)):
        check(x["finished"], f"tree rollout ({which}): not every group "
              "finished")
        check(x["launches"]["tree_verify"] == x["fused_steps"] * L,
              f"tree rollout ({which}): K2 launches "
              f"{x['launches']['tree_verify']} != {x['fused_steps']} "
              f"steps x {L}")
        check(x["launches"]["spec_verify"] == 0,
              f"tree rollout ({which}): K1 launched "
              f"{x['launches']['spec_verify']} times")
        check(x["host_syncs"] <= x["stats"].steps,
              f"tree rollout ({which}): host syncs {x['host_syncs']} > "
              f"steps {x['stats'].steps}")
    check(tst.accepted > 0, "tree rollout accepted no draft")
    check(tr["tree_branch_nodes"] > 0, "tree rollout verified no branching "
          "tree")
    tree_rep = {
        "tokens": tst.tokens, "steps": tst.steps,
        "fused_steps": tr["fused_steps"],
        "tokens_per_step": tst.tokens / tr["fused_steps"],
        "drafted": tst.drafted, "accepted": tst.accepted,
        "mean_acceptance": tst.mean_acceptance,
        "tree_nodes": tr["tree_nodes"],
        "tree_branch_nodes": tr["tree_branch_nodes"],
        "migrations": tst.migrations, "host_syncs": tr["host_syncs"],
        "k2_launches": k2_launches, "fused_by_T": tr["by_kind"],
        "wall_s": tr["wall_s"], "tokens_per_s": tst.tokens / tr["wall_s"],
        "same_responses_as_linear": sum(
            tr["responses"][k] == v for k, v in lsh["responses"].items()),
        "warm": {"fused_steps": warm["fused_steps"],
                 "drafted": warm["stats"].drafted,
                 "accepted": warm["stats"].accepted,
                 "tree_nodes": warm["tree_nodes"],
                 "tree_branch_nodes": warm["tree_branch_nodes"],
                 "wall_s": warm["wall_s"],
                 "tokens_per_s": warm["stats"].tokens / warm["wall_s"]}}
    report["tree_slice"] = tree_rep
    log(f"  measured pass: tokens {tst.tokens}, engine steps "
        f"{tr['fused_steps']}, tokens per step "
        f"{tree_rep['tokens_per_step']:.3f}, drafted {tst.drafted}, "
        f"accepted {tst.accepted} (mean acceptance "
        f"{tst.mean_acceptance:.4f}), tree nodes {tr['tree_nodes']} "
        f"(branching {tr['tree_branch_nodes']}), migrations "
        f"{tst.migrations}, wall {tr['wall_s']:.3f} s, "
        f"{tree_rep['tokens_per_s']:.1f} tokens/s")
    log(f"  K2 launches {k2_launches} = {tr['fused_steps']} x {L}, K1 0; "
        f"host syncs {tr['host_syncs']} <= steps {tst.steps}; steps by "
        f"T {tr['by_kind']}; warm pass {warm['fused_steps']} steps, "
        f"drafted {warm['stats'].drafted}, accepted "
        f"{warm['stats'].accepted}, branching nodes "
        f"{warm['tree_branch_nodes']}, "
        f"{tree_rep['warm']['tokens_per_s']:.1f} tokens/s")
    log(f"  against the linear shifted pass: tokens per step "
        f"{tree_rep['tokens_per_step']:.3f} vs {sh_['tokens_per_step']:.3f}"
        f", tokens/s {tree_rep['tokens_per_s']:.1f} vs "
        f"{sh_['tokens_per_s']:.1f}, responses equal "
        f"{tree_rep['same_responses_as_linear']}/{len(lens)}")
    phase_done("tree slice")

    log("serving, faults and tracing: the reference's faults, tracing and "
        "open-loop workloads on granite-3-8b")
    del params
    _free(torch)
    cfg, params = build_model(torch, layers=LINEAR_LAYERS)
    srv = serving_phase(torch, np, cfg, params)
    report["serving_phase"] = srv
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("serving, faults and tracing")

    log(f"training: GRPO trainer at granite-3-8b width, {TRAIN_LAYERS} "
        "layers, 2 sync iterations")
    trn = training_phase(torch, np, profile=bool(args.profile))
    report["training"] = trn
    for i, it in enumerate(trn["iterations"]):
        ro = trn["rollouts"][i]
        log(f"  iteration {i}: rollout {it['rollout_s']:.3f} s ({ro['steps']}"
            f" engine steps, {ro['host_syncs']} host syncs, {ro['k1']} K1 "
            f"launches, {ro['migrations']} migrations), train "
            f"{it['train_s']:.3f} s, weight push {it['push_s']:.3f} s, "
            f"iteration {it['iteration_s']:.3f} s; loss {it['loss']:+.6e}, "
            f"grad norm {it['grad_norm']:.4f}, reward {it['reward']:.4f}")
    st0 = trn["train_steps"][0]
    log(f"  per train step: K3 forward {st0['flash_attention']} (2 x "
        f"{trn['layers']}, recompute), dQ {st0['flash_attention_dq']}, "
        f"dK/dV {st0['flash_attention_dkdv']}, K1 {st0['spec_verify']}, "
        f"plain attention calls {trn['plain_calls']}; second rollout on "
        f"the pushed copy; repeat bitwise equal: {trn['repeat_bitwise']}; "
        f"peak memory {trn['peak_mem_gb']:.1f} GB")
    o = trn["oracle"]
    log(f"  K3 against plain attention (4 sequences): loss "
        f"{o['loss_k3']:+.6e} vs {o['loss_plain']:+.6e}, grad norm "
        f"{o['grad_norm_k3']:.6f} vs {o['grad_norm_plain']:.6f}, worst "
        f"leaf-norm gap {o['worst_leaf_norm_rel_gap']:.3e}")
    if trn["profile"]:
        p = trn["profile"]
        log(f"  profile of one train step: wall {p['wall_ms']:.1f} ms, "
            f"device {p['device_ms']:.1f} ms (busy share "
            f"{p['busy_share']:.3f}); K3 "
            f"{p['shares']['flash_attention']:.3f} of device time")
        for k_, t_, n_ in p["top"][:15]:
            log(f"    {t_:10.3f} ms  x{n_:<6d} {k_[:90]}")
    # the trainer's closures hold tensors in reference cycles: collect
    # them, so that the next phases' peak memory is theirs
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("training")

    log("crash gap: the training phase's granite with and without a crash")
    report["crash_gap"] = crash_gap_phase(torch, np)
    phase_done("crash gap")

    arch_train = report["arch_training"] = {}
    for arch, layers, kind in (
            (MOE_ARCH, moe_train_layers(), "rl"),
            ("mamba2-370m", TRAIN_CUT.get("mamba2-370m", 0), "rl"),
            ("zamba2-1.2b", TRAIN_CUT.get("zamba2-1.2b", 0), "rl"),
            (VLM_ARCH, TRAIN_CUT.get(VLM_ARCH, 0), "modal"),
            (AUDIO_ARCH, TRAIN_CUT.get(AUDIO_ARCH, 0), "modal")):
        log(f"training: {arch} at full width" + (
            f", {layers} layers" if layers else ", full depth") + (
            ": one sync RLTrainer iteration" if kind == "rl" else
            ": make_train_step on a batch with seeded modality inputs"))
        fn = rl_training_phase if kind == "rl" else modality_training_phase
        arch_train[arch] = fn(torch, np, arch, layers)
        log_arch_training(arch_train[arch])
        gc.collect()
        torch.cuda.empty_cache()
        phase_done(f"training {arch}")

    rec = {}
    for arch, groups, new_tokens in (("zamba2-1.2b", GROUPS, NEW_TOKENS),
                                     ("mamba2-370m", SSM_GROUPS,
                                      SSM_NEW_TOKENS)):
        kind = "hybrid" if arch.startswith("zamba2") else "SSM"
        log(f"{kind} slice: {arch} Seer rollout on the card, {groups} groups "
            f"x {GROUP_SIZE}, {new_tokens} new tokens")
        rcfg, rparams = build_model(torch, arch, CUT_LAYERS[arch])
        sd = sync_debug_steps(torch, np, rcfg, rparams)
        log(f"  dispatch under sync debug 'error': T per step "
            f"{sd['step_T']}, host syncs {sd['host_syncs_per_step']}")
        rep_ = rec_slice(torch, np, rcfg, rparams, groups=groups,
                         new_tokens=new_tokens, seed=1)
        rep_["sync_debug"] = sd
        if kind == "hybrid":
            log(f"hybrid engine: {arch} fused steps against the sync "
                "oracle")
            he = rec_engine_check(torch, np, rcfg, rparams)
            rep_["engine"] = he
            log(f"  {he['steps']} steps, each equal to the sync oracle from "
                f"the same state (tokens, accept counts, ssm, conv, K/V, "
                f"slot_pos bitwise), 1 host sync each, {he['replays']} "
                f"replays, dispatch clean under sync debug 'error'; "
                f"{he['accepted']} drafts accepted, {he['rejected_rows']} "
                "row-steps with a rejected draft")
        if args.profile:
            rep_["profile"] = profile_steps(torch, rcfg, rparams,
                                            args.profile)
            p = rep_["profile"]
            log(f"  profile of {p['steps']} steps: wall {p['wall_ms']:.1f} "
                f"ms, device {p['device_ms']:.1f} ms (busy share "
                f"{p['busy_share']:.3f}); K4 {p['shares']['ssd_scan']:.3f} "
                f"and K1 {p['shares']['spec_verify']:.3f} of device time")
            for k_, t_, n_ in p["top"][:12]:
                log(f"    {t_:10.3f} ms  x{n_:<6d} {k_[:90]}")
        rec[arch] = rep_
        del rparams
        gc.collect()
        torch.cuda.empty_cache()
    report["hybrid_slice"] = rec["zamba2-1.2b"]
    report["ssm_slice"] = rec["mamba2-370m"]
    phase_done("hybrid and SSM slices")

    log(f"MoE slice: {MOE_ARCH} Seer rollout on the card, {GROUPS} groups x "
        f"{GROUP_SIZE}, {MOE_NEW_TOKENS} new tokens, {MOE_CACHE_LEN} "
        "positions a slot")
    mcfg, mparams = build_model(torch, MOE_ARCH, CUT_LAYERS[MOE_ARCH])
    log(f"  {mcfg.num_layers} layers: {mcfg.first_dense_layers} dense (d_ff "
        f"{mcfg.d_ff}), {mcfg.num_layers - mcfg.first_dense_layers} MoE "
        f"({mcfg.num_experts} experts of {mcfg.moe_d_ff}, top-"
        f"{mcfg.moe_top_k}, {mcfg.num_shared_experts} shared); weights "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")
    sd = sync_debug_steps(torch, np, mcfg, mparams, cache_len=MOE_CACHE_LEN)
    log(f"  dispatch under sync debug 'error': T per step {sd['step_T']}, "
        f"host syncs {sd['host_syncs_per_step']}")
    log(f"row probe: {MOE_ARCH} ({mcfg.num_layers} layers) cached forward "
        "row by row")
    report["row_probe"][MOE_ARCH] = {
        "port": row_probe(torch, np, mcfg, mparams),
        "library": row_probe(torch, np, mcfg, mparams, library=True)}
    log_row_probe(MOE_ARCH, report["row_probe"][MOE_ARCH]["port"])
    log_row_probe(f"{MOE_ARCH} with PyTorch's operations (not gated)",
                  report["row_probe"][MOE_ARCH]["library"], gate=False)
    gc.collect()
    torch.cuda.empty_cache()
    moe = rec_slice(torch, np, mcfg, mparams, groups=GROUPS,
                    new_tokens=MOE_NEW_TOKENS, seed=1,
                    cache_len=MOE_CACHE_LEN)
    moe["sync_debug"] = sd
    phase_done("MoE slice")

    log(f"MoE tree engine: {MOE_ARCH} fused tree steps against the sync "
        "oracle")
    mte = tree_engine_check(torch, np, mcfg, mparams,
                            cache_len=MOE_CACHE_LEN)
    moe["tree_engine"] = mte
    log(f"  {mte['steps']} steps, each equal to the sync oracle from the "
        f"same state (tokens, accept counts, slot_pos, K/V at committed "
        f"slots), 1 host sync and {mcfg.num_layers} K2 launches each, "
        f"dispatch clean under sync debug 'error'; {mte['accepted']} drafts "
        f"accepted, {mte['side_branch_steps']} row-steps along the side "
        f"branch; tree nodes {mte['tree_nodes']} (branching "
        f"{mte['tree_branch_nodes']}); K2 launches in the phase (fused and "
        f"oracle steps) {mte['launches']['tree_verify']}; steps by T "
        f"{mte['steps_by_T']}")
    if args.profile:
        moe["profile"] = profile_steps(torch, mcfg, mparams, args.profile,
                                       cache_len=MOE_CACHE_LEN)
        p = moe["profile"]
        log(f"  profile of {p['steps']} steps: wall {p['wall_ms']:.1f} ms, "
            f"device {p['device_ms']:.1f} ms (busy share "
            f"{p['busy_share']:.3f}); MoE layers "
            f"{p['shares']['moe_layer']:.3f} ({p['moe_layer_ms']:.1f} ms) "
            f"and K1 {p['shares']['spec_verify']:.3f} of device time")
        for k_, t_, n_ in p["top"][:12]:
            log(f"    {t_:10.3f} ms  x{n_:<6d} {k_[:90]}")
    report["moe_slice"] = moe
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("MoE tree engine")

    cross = {}
    for arch in (VLM_ARCH, AUDIO_ARCH):
        kind = "VLM" if arch == VLM_ARCH else "audio"
        log(f"{kind} slice: {arch} Seer rollout on the card, {CROSS_GROUPS} "
            f"groups x {GROUP_SIZE}, {CROSS_NEW_TOKENS} new tokens")
        xcfg, xparams = build_model(torch, arch)
        sd = sync_debug_steps(torch, np, xcfg, xparams)
        log(f"  dispatch under sync debug 'error': T per step "
            f"{sd['step_T']}, host syncs {sd['host_syncs_per_step']}")
        rep_ = rec_slice(torch, np, xcfg, xparams, groups=CROSS_GROUPS,
                         new_tokens=CROSS_NEW_TOKENS, seed=1)
        rep_["sync_debug"] = sd
        c_ = rep_["cold"]
        log(f"  K1 launches in the cold pass {c_['launches']['spec_verify']}"
            f", of them in cross blocks {c_['cross_launches']}; K3 launches "
            f"per rollout build {rep_['k3_per_build']}")
        phase_done(f"{kind} slice")
        bt = rep_["blob_time"] = blob_time(torch, xcfg, xparams)
        log(f"  one batched export of {bt['slots']} slots ({bt['live']} "
            f"positions each) {bt['export_with_cross_ms']:.4f} ms, "
            f"{bt['export_without_ms']:.4f} ms without the cross memory "
            f"({bt['cross_bytes_per_slot'] / 1e6:.1f} MB a slot); its import "
            f"{bt['import_with_cross_ms']:.4f} ms, "
            f"{bt['import_without_ms']:.4f} ms without")
        embeds = modality_embeds(torch, np, xcfg, 8, seed=7)
        if kind == "VLM":
            log(f"VLM tree engine: {arch} fused tree steps against the sync "
                "oracle, seeded random image embeddings")
            te_ = tree_engine_check(torch, np, xcfg, xparams, embeds=embeds)
            rep_["tree_engine"] = te_
            log(f"  {te_['steps']} steps, each equal to the sync oracle from "
                f"the same state (tokens, accept counts, slot_pos, K/V at "
                f"committed slots), 1 host sync, {xcfg.num_layers} K2 and "
                f"{xcfg.num_layers // xcfg.cross_attn_every} K1 launches "
                f"each, dispatch clean under sync debug 'error'; "
                f"{te_['accepted']} drafts accepted, "
                f"{te_['side_branch_steps']} row-steps along the side "
                f"branch; tree nodes {te_['tree_nodes']} (branching "
                f"{te_['tree_branch_nodes']}); K2 launches in the phase "
                f"{te_['launches']['tree_verify']}; steps by T "
                f"{te_['steps_by_T']}")
        else:
            log(f"audio engine: {arch} fused steps against the sync oracle, "
                "seeded random audio frames")
            ae = rec_engine_check(torch, np, xcfg, xparams, embeds=embeds)
            rep_["engine"] = ae
            log(f"  {ae['steps']} steps, each equal to the sync oracle from "
                f"the same state (tokens, accept counts, K/V, slot_pos, "
                f"cross memory bitwise), 1 host sync each, dispatch clean "
                f"under sync debug 'error'; {ae['accepted']} drafts "
                f"accepted, {ae['rejected_rows']} row-steps with a rejected "
                "draft")
        if args.profile:
            rep_["profile"] = profile_steps(torch, xcfg, xparams,
                                            args.profile)
            p = rep_["profile"]
            log(f"  profile of {p['steps']} steps: wall {p['wall_ms']:.1f} "
                f"ms, device {p['device_ms']:.1f} ms (busy share "
                f"{p['busy_share']:.3f}); K1 "
                f"{p['shares']['spec_verify']:.3f} of device time")
            for k_, t_, n_ in p["top"][:12]:
                log(f"    {t_:10.3f} ms  x{n_:<6d} {k_[:90]}")
        cross[arch] = rep_
        del xparams, embeds
        gc.collect()
        torch.cuda.empty_cache()
        phase_done(f"{kind} engine")
    vlm, aud = cross[VLM_ARCH], cross[AUDIO_ARCH]
    report["vlm_slice"], report["audio_slice"] = vlm, aud

    log("serving CLI: repro_torch.launch.serve on cuda")
    from repro_torch.launch import serve
    report["serve"] = {}
    for flags in ([], ["--arch", MOE_ARCH], ["--arch", VLM_ARCH],
                  ["--arch", AUDIO_ARCH]):
        t_ = time.perf_counter()
        rep_ = serve.main(flags + ["--max-new-tokens", str(SERVE_NEW_TOKENS),
                                   "--device", "cuda"])
        wall_ = time.perf_counter() - t_
        check(rep_["tokens"] > 0 and rep_["tokens"] ==
              rep_["requests"] * SERVE_NEW_TOKENS, f"serve {rep_['arch']}: "
              f"tokens {rep_['tokens']} for {rep_['requests']} requests of "
              f"{SERVE_NEW_TOKENS}")
        report["serve"][rep_["arch"]] = rep_
        log(f"  serve --arch {rep_['arch']} (tiny): {rep_['requests']} "
            f"requests, tokens {rep_['tokens']} (every request finished), "
            f"engine steps {rep_['engine_steps']}, migrations "
            f"{rep_['migrations']}, drafted {rep_['drafted']}, accepted "
            f"{rep_['accepted']}; {wall_:.1f} s in all")
    phase_done("serving CLI")

    def commonest_T(by_kind):
        return int(max(by_kind, key=by_kind.get).split(":")[1])

    # each kernel's timing shape follows its slice: its most frequent step
    # width, and each slot's context halfway through; then the fixed
    # widths at 384 live slots (``verify_time_table``).  K1 also at
    # zamba2's shared attention, at the hybrid passes' commonest widths
    # (same prompt lengths, so the same live contexts)
    live = np.asarray([min(len(p) + NEW_TOKENS // 2, S)
                       for p in prompts for _ in range(GROUP_SIZE)][:B])
    hyb = rec["zamba2-1.2b"]
    # the MoE slice: the same prompt lengths (seed 1), halfway through its
    # responses; its tree engine phase at its prompts' halfway contexts
    moe_live = np.asarray([min(len(p) + MOE_NEW_TOKENS // 2, S)
                           for p in prompts for _ in range(GROUP_SIZE)][:B])
    moe_T = commonest_T(moe["cold"]["fused_by_T"])
    mte_T = max(mte["steps_by_T"], key=mte["steps_by_T"].get)
    vt = verify_time_table(
        torch, np, B=B, S=S, extra=[(commonest_T(r["by_kind"]), live)],
        zamba_extra=[(T, live) for T in dict.fromkeys(
            commonest_T(hyb[p_]["fused_by_T"]) for p_ in ("cold", "warm"))],
        tree_extra=[(commonest_T(tr["by_kind"]), live)],
        moe_extra=[(moe_T, moe_live)],
        moe_tree_extra=[(mte_T, np.full(B, int(mte["live_mean"])))])
    report["kernel_time"] = vt["spec_verify"]
    report["hybrid_kernel_time"] = vt["spec_verify/zamba2-1.2b"]
    report["tree_kernel_time"] = vt["tree_verify"]
    report["moe_kernel_time"] = vt[f"spec_verify/{MOE_ARCH}"]
    report["moe_tree_kernel_time"] = vt[f"tree_verify/{MOE_ARCH}"]
    # K1 at the serving phase's shape: its commonest width on 2 slots of
    # the open-loop workload's cache (most of the phase's steps), contexts
    # halfway through its responses
    srv_t = kernels_time(torch, np, B=2, S=SERVE_CACHE,
                         T=commonest_T(srv["fused_by_T"]),
                         live=np.full(2, SERVE_PROMPT + SERVE_GEN // 2))
    report["serving_kernel_time"] = srv_t
    log_verify_time("spec_verify (serving, faults and tracing)", srv_t)

    # K4 at each SSM slice's cold and warm passes' commonest widths, then
    # the fixed widths (no single PyTorch call computes SSD); the kernels
    # line takes the cold pass's
    cold_T = {arch: commonest_T(rec[arch]["cold"]["fused_by_T"])
              for arch in rec}
    st_ = ssd_time_table(torch, np, sweep=False, extra={
        arch: [cold_T[arch], commonest_T(rec[arch]["warm"]["fused_by_T"])]
        for arch in rec})
    report["ssd_time"] = st_
    report["ssd_kernel_time"] = [
        next(tm for tm in st_[arch] if tm["T"] == cold_T[arch])
        for arch, *_ in SSD_MODEL_SHAPES]

    # K4's backward at the SSM and hybrid trainers' train step shape: 16
    # rows of 448 tokens (a chunk of 256 and a ragged one), bf16, no
    # initial state
    bwd_t = report["ssd_bwd_time"] = ssd_bwd_time_table(torch, np)

    # K3 at granite-3-8b's heads (the training phase's shape) and at
    # zamba2-1.2b's (Hq = Hk = 32, D 64)
    ft = flash_kernels_time(torch, np)
    fz = flash_kernels_time(torch, np, Hq=32, Hk=32, D=64)
    report["flash_kernel_time"] = ft
    report["flash_kernel_time_zamba2"] = fz
    for f_, name in ((ft, "granite-3-8b"), (fz, "zamba2-1.2b")):
        log(f"  flash_attention timing ({name} heads) B={f_['B']} T="
            f"{f_['T']} Hq={f_['Hq']} Hk={f_['Hk']} D={f_['D']} causal bf16 "
            f"({f_['route']}): " + "; ".join(
                f"{w} {f_[f'{w}_ms']:.4f} ms ({f_[f'{w}_tflops']:.1f} "
                f"TFLOP/s, bound {f_[f'{w}_bound_ms']:.4f} "
                f"{f_[f'{w}_bound_by']}, {f_[f'{w}_bound_share']:.3f} of "
                f"it)" for w in ("forward", "dq", "dkdv")))
        log(f"    backward in all {f_['backward_ms']:.4f} ms; plain forward "
            f"{f_['plain_forward_ms']:.4f}, plain backward "
            f"{f_['plain_backward_ms']:.4f}; SDPA forward "
            f"{f_['library_forward_ms']:.4f}, backward "
            f"{f_['library_backward_ms']:.4f}, forward + backward "
            f"{f_['library_fwd_bwd_ms']:.4f}")

    # the VLM and audio slices: K1 at each model's self-attention (the
    # cold pass's commonest width, contexts halfway through the responses
    # of the first CROSS_GROUPS groups' prompts) and cross blocks (that
    # width, then CROSS_WIDTHS), K2 at the VLM tree engine's commonest
    # width, K3 at the encoder
    x_live = np.asarray([min(len(p) + CROSS_NEW_TOKENS // 2, S)
                         for p in prompts[:CROSS_GROUPS]
                         for _ in range(GROUP_SIZE)][:B])
    x_T = {a: commonest_T(cross[a]["cold"]["fused_by_T"]) for a in cross}
    self_t = {a: kernels_time(torch, np, B=B, S=S, T=x_T[a], live=x_live,
                              model=a) for a in cross}
    cross_t = {a: [cross_kernels_time(torch, np, model=a, T=T)
                   for T in dict.fromkeys((x_T[a],) + CROSS_WIDTHS)]
               for a in cross}
    vte = vlm["tree_engine"]
    vte_T = max(vte["steps_by_T"], key=vte["steps_by_T"].get)
    vlm_tree_t = tree_kernels_time(torch, np, B=B, S=S, T=vte_T,
                                   live=np.full(B, int(vte["live_mean"])),
                                   model=VLM_ARCH)
    enc_t = encoder_flash_time(torch, np)
    report["cross_kernel_time"] = {"self": self_t, "cross": cross_t,
                                   "vlm_tree": vlm_tree_t, "encoder": enc_t}
    for a in cross:
        log_verify_time(f"spec_verify/{a} (self-attention)", self_t[a])
        for tm in cross_t[a]:
            log(f"  spec_verify/{a} cross timing T={tm['T']} over "
                f"{tm['Tm']} keys Hq={tm['Hq']} Hk={tm['Hk']} D={tm['D']} "
                f"bf16, route {tm['route']} (n_split {tm['n_split']}): "
                f"{_spread(tm['ms_spread'])} ms, host {tm['host_us']:.1f} "
                f"us/call; other route (K3 non-causal forward) "
                f"{_spread(tm['k3_spread'])} ms; plain {tm['plain_ms']:.4f} "
                f"ms; SDPA {_spread(tm['library_spread'])} ms; bound "
                f"{tm['bound_ms']:.4f} ms ({tm['bound_by']})")
    log_verify_time(f"tree_verify/{VLM_ARCH}", vlm_tree_t)
    log(f"  flash_attention encoder timing ({AUDIO_ARCH}) B={enc_t['B']} "
        f"T={enc_t['T']} Hq={enc_t['Hq']} Hk={enc_t['Hk']} D={enc_t['D']} "
        f"non-causal bf16 ({enc_t['route']}): forward "
        f"{_spread(enc_t['ms_spread'])} ms ({enc_t['tflops']:.1f} TFLOP/s), "
        f"host {enc_t['host_us']:.1f} us/call; plain {enc_t['plain_ms']:.4f} "
        f"ms; SDPA {_spread(enc_t['library_spread'])} ms; bound "
        f"{enc_t['bound_ms']:.4f} ms ({enc_t['bound_by']})")

    # row_gemm at granite's products: a decode of 8 slots, a mixed chunk
    # of 32 on 8 slots, the production prefill and the linear slice's
    # commonest width (8 slots x T); the row reductions at that width
    lin_M = 8 * commonest_T(r["by_kind"])
    rgt = report["row_gemm_time"] = row_gemm_time(
        torch, np, Ms=tuple(sorted(set(ROW_GEMM_TIME_M) | {lin_M})))
    rrt = report["row_reduce_time"] = row_reduce_time(torch, np, lin_M)

    def kernel_row(name, tpu, path, launches, checks, tm,
                   source=SPEC_VERIFY_SRC):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": tpu, "path": path, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in checks),
                "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "library_ms": tm["library_ms"]}

    # the forward's max_abs_err is that of o, dQ's of dq, dK/dV's of dk
    # and dv; plain_ms and library_ms of the two backward kernels are the
    # whole backward's (dq, dk, dv: no one call computes less)
    outputs = {"forward": ("o",), "dq": ("dq",), "dkdv": ("dk", "dv")}

    def flash_row(name, which, plain, library):
        errs = [{"max_abs_err": max(c["errs"][o] for o in outputs[which])}
                for c in report["flash_kernel_checks"] + [ft["check"],
                                                          fz["check"]]]
        return kernel_row(
            name, FLASH_TPU, "granite-3-8b training, 2 train steps",
            trn["launches"][name], errs,
            {"ms": ft[f"{which}_ms"], "plain_ms": ft[plain],
             "bound_ms": ft[f"{which}_bound_ms"],
             "bound_by": ft[f"{which}_bound_by"], "library_ms": ft[library]},
            source=FLASH_SRC)

    # a kernel that several paths run has a row for each: its first
    # path's row holds every check but those at the other paths' shapes
    def checks_of(rows_, shape, other=False):
        shapes = {shape} if isinstance(shape, str) else set(shape)
        return [c for c in rows_ if (c.get("shape") in shapes) != other]
    z_cold, m_cold = hyb["cold"], rec["mamba2-370m"]["cold"]
    k1_checks = report["kernel_checks"] + report["cross_kernel_checks"]
    cross_shapes = [f"{a}/cross" for a in cross]

    def cross_rows(a, kind):
        """K1 on the ``a`` slice's cold pass: its self-attention (heads
        checked as ``shape``) and its cross blocks."""
        cold = cross[a]["cold"]
        n_cross = cold["cross_launches"]
        shape = "granite-3-8b" if a == VLM_ARCH else a
        return [kernel_row(f"spec_verify/{a}", SPEC_VERIFY_TPU,
                           f"{a} {kind} slice, cold pass, self-attention",
                           cold["launches"]["spec_verify"] - n_cross,
                           checks_of(k1_checks, shape) + [self_t[a]],
                           self_t[a]),
                kernel_row(f"spec_verify/{a}/cross", SPEC_VERIFY_TPU,
                           f"{a} {kind} slice, cold pass, cross blocks",
                           n_cross, checks_of(k1_checks, f"{a}/cross")
                           + cross_t[a], cross_t[a][0])]
    rows = [kernel_row("spec_verify", SPEC_VERIFY_TPU,
                       "granite-3-8b linear slice, cold pass", k1_launches,
                       checks_of(k1_checks, ["zamba2-1.2b", MOE_ARCH,
                                             AUDIO_ARCH] + cross_shapes,
                                 other=True),
                       report["kernel_time"][0]),
            kernel_row("spec_verify/serving", SPEC_VERIFY_TPU,
                       "granite-3-8b serving, faults and tracing phase",
                       srv["launches"]["spec_verify"],
                       report["serving_kernel_checks"] + srv["k1_checks"]
                       + [srv_t], srv_t),
            kernel_row("spec_verify/zamba2-1.2b", SPEC_VERIFY_TPU,
                       "zamba2-1.2b hybrid slice, cold pass",
                       z_cold["launches"]["spec_verify"],
                       checks_of(report["kernel_checks"], "zamba2-1.2b"),
                       report["hybrid_kernel_time"][0]),
            kernel_row(f"spec_verify/{MOE_ARCH}", SPEC_VERIFY_TPU,
                       f"{MOE_ARCH} MoE slice, cold pass",
                       moe["cold"]["launches"]["spec_verify"],
                       checks_of(report["kernel_checks"], MOE_ARCH),
                       report["moe_kernel_time"][0]),
            *cross_rows(VLM_ARCH, "VLM"),
            *cross_rows(AUDIO_ARCH, "audio"),
            kernel_row("tree_verify", TREE_VERIFY_TPU,
                       "granite-3-8b tree slice, measured pass", k2_launches,
                       checks_of(report["tree_kernel_checks"],
                                 (MOE_ARCH, AUDIO_ARCH), other=True),
                       report["tree_kernel_time"][0]),
            kernel_row(f"tree_verify/{VLM_ARCH}", TREE_VERIFY_TPU,
                       f"{VLM_ARCH} VLM tree engine (fused steps and their "
                       "sync oracle)", vte["launches"]["tree_verify"],
                       checks_of(report["tree_kernel_checks"],
                                 "granite-3-8b") + [vlm_tree_t], vlm_tree_t),
            kernel_row(f"tree_verify/{MOE_ARCH}", TREE_VERIFY_TPU,
                       f"{MOE_ARCH} MoE tree engine (fused steps and their "
                       "sync oracle)", mte["launches"]["tree_verify"],
                       checks_of(report["tree_kernel_checks"], MOE_ARCH),
                       report["moe_tree_kernel_time"][0]),
            flash_row("flash_attention", "forward", "plain_forward_ms",
                      "library_forward_ms"),
            flash_row("flash_attention_dq", "dq", "plain_backward_ms",
                      "library_backward_ms"),
            flash_row("flash_attention_dkdv", "dkdv", "plain_backward_ms",
                      "library_backward_ms"),
            kernel_row(f"flash_attention/{AUDIO_ARCH}", FLASH_TPU,
                       f"{AUDIO_ARCH} audio slice, the cold pass's rollout "
                       "build (the encoder on each instance)",
                       aud["k3_per_build"], [enc_t], enc_t,
                       source=FLASH_SRC),
            kernel_row("ssd_scan", SSD_TPU,
                       "zamba2-1.2b hybrid slice, cold pass",
                       z_cold["launches"]["ssd_scan"],
                       checks_of(report["ssd_kernel_checks"], "mamba2-370m",
                                 other=True),
                       report["ssd_kernel_time"][0], source=SSD_SRC),
            kernel_row("ssd_scan/mamba2-370m", SSD_TPU,
                       "mamba2-370m SSM slice, cold pass",
                       m_cold["launches"]["ssd_scan"],
                       checks_of(report["ssd_kernel_checks"], "mamba2-370m"),
                       report["ssd_kernel_time"][1], source=SSD_SRC),
            *[kernel_row(
                "ssd_scan_bwd" + ("" if name == "zamba2-1.2b" else
                                  f"/{name}"),
                SSD_TPU,
                f"{name} training, one train step",
                arch_train[name]["train_steps"][0]["ssd_scan_bwd"],
                checks_of(report["ssd_bwd_checks"], name) + [tm], tm,
                source=SSD_BWD_SRC)
              for name, tm in zip(("zamba2-1.2b", "mamba2-370m"), bwd_t)]]

    # the engine path's products and row reductions, through the linear
    # slice's cold pass (timed at granite's wg and its commonest width)
    rr_checks = report["row_reduce_checks"]
    rows += [
        kernel_row("row_gemm", LIN_REF, "granite-3-8b linear slice, cold "
                   "pass (every product of the cached forward)",
                   r["launches"]["row_gemm"],
                   report["row_gemm_checks"] + rgt,
                   next(t for t in rgt if t["shape"] == "wg"
                        and t["M"] == lin_M), source=ROW_GEMM_SRC),
        kernel_row("row_reduce/rms_norm", RMS_NORM_REF, "granite-3-8b "
                   "linear slice, cold pass", r["launches"]["rms_norm"],
                   [c for c in rr_checks if c["shape"].startswith("rms")]
                   + [rrt["rms_norm"]], rrt["rms_norm"],
                   source=ROW_REDUCE_SRC),
        kernel_row("row_reduce/logsumexp", LOGSUMEXP_REF, "granite-3-8b "
                   "linear slice, cold pass (the sampled tokens' "
                   "logprobs)", r["launches"]["logsumexp"],
                   [c for c in rr_checks if c["shape"].startswith("log")]
                   + [rrt["logsumexp"]], rrt["logsumexp"],
                   source=ROW_REDUCE_SRC)]

    # the production layout: K1 through the one-rank cached steps (timed
    # at the prefill's width), K2 through its tree step, K3 through rank
    # 0's gradient of granite at tp=2 (timed at a rank's heads, f32)
    pl_ = prod["steps"]["launches"]

    def prod_flash_row(name, which, plain, library, e=False):
        fl_ = prod["flash_time_e" if e else "flash_time"]
        train = prod["train_e" if e else "train"]["granite-3-8b"]
        errs = [{"max_abs_err": max(fl_["check"]["errs"][o]
                                    for o in outputs[which])}]
        where = (f"on the {PROD_MESH} mesh (FSDP over data)" if e
                 else f"tp={TP}")
        return kernel_row(
            f"{name}/production" + (f"/{PROD_DATA}x{TP}" if e else ""),
            FLASH_TPU, f"granite-3-8b production train step {where}, "
            "rank 0, one step", train["launches"][name], errs,
            {"ms": fl_[f"{which}_ms"], "plain_ms": fl_[plain],
             "bound_ms": fl_[f"{which}_bound_ms"],
             "bound_by": fl_[f"{which}_bound_by"],
             "library_ms": fl_[library]}, source=FLASH_SRC)
    rows += [
        kernel_row("spec_verify/production", SPEC_VERIFY_TPU,
                   f"granite-3-8b production layout, one rank: a "
                   f"{PROD_PREFILL}-token contiguous prefill, "
                   f"{PROD_DECODES} decodes, a verify of {PROD_GAMMA + 1}",
                   pl_["spec_verify"], prod["k1_checks"] + prod["k1_time"],
                   prod["k1_time"][0]),
        kernel_row("tree_verify/production", TREE_VERIFY_TPU,
                   "granite-3-8b production layout, one rank: the tree "
                   "verify step", pl_["tree_verify"],
                   checks_of(report["tree_kernel_checks"], "granite-3-8b")
                   + [prod["tree_time"]], prod["tree_time"]),
        prod_flash_row("flash_attention", "forward", "plain_forward_ms",
                       "library_forward_ms"),
        prod_flash_row("flash_attention_dq", "dq", "plain_backward_ms",
                       "library_backward_ms"),
        prod_flash_row("flash_attention_dkdv", "dkdv", "plain_backward_ms",
                       "library_backward_ms")]
    # (d): K1 / K2 with partials on rank 0's half of the cache, timed at
    # a rank's share (the prefill's width; the tree step's)
    sh_, cd_ = prod["share_time"], prod["cached"]["launches"]
    rows += [
        kernel_row(f"spec_verify/production/tp{TP}", SPEC_VERIFY_TPU,
                   f"granite-3-8b production layout tp={TP}, rank 0: the "
                   "cached steps on its half of the cache (lse=True)",
                   cd_["spec_verify"],
                   checks_of(prod["share_checks"], "granite-3-8b/share"),
                   sh_[f"k1_T{PROD_PREFILL}"]),
        kernel_row(f"tree_verify/production/tp{TP}", TREE_VERIFY_TPU,
                   f"granite-3-8b production layout tp={TP}, rank 0: the "
                   "tree verify step on its half of the cache (lse=True)",
                   cd_["tree_verify"],
                   checks_of(prod["share_checks"],
                             "granite-3-8b/share/tree"), sh_["tree_T7"])]
    # (e): K3 through rank 0's gradient of granite on the mesh (timed at
    # a data rank's rows), K1 / K2 with partials through its cached steps
    # on its rows and half of the cache (timed at that share)
    she, ce_ = prod["share_time_e"], prod["cached_e"]["launches"]
    mesh_ = f"{PROD_DATA}x{TP}"
    rows += [
        prod_flash_row("flash_attention", "forward", "plain_forward_ms",
                       "library_forward_ms", e=True),
        prod_flash_row("flash_attention_dq", "dq", "plain_backward_ms",
                       "library_backward_ms", e=True),
        prod_flash_row("flash_attention_dkdv", "dkdv", "plain_backward_ms",
                       "library_backward_ms", e=True),
        kernel_row(f"spec_verify/production/{mesh_}", SPEC_VERIFY_TPU,
                   f"granite-3-8b production layout on the {PROD_MESH} "
                   "mesh, rank 0: the cached steps on its rows and half "
                   "of the cache (lse=True)", ce_["spec_verify"],
                   checks_of(prod["share_checks_e"], "granite-3-8b/share"),
                   she[f"k1_T{PROD_PREFILL}"]),
        kernel_row(f"tree_verify/production/{mesh_}", TREE_VERIFY_TPU,
                   f"granite-3-8b production layout on the {PROD_MESH} "
                   "mesh, rank 0: the tree verify step on its rows and "
                   "half of the cache (lse=True)", ce_["tree_verify"],
                   checks_of(prod["share_checks_e"],
                             "granite-3-8b/share/tree"), she["tree_T7"])]

    phase_done("timing")

    tpr = tensor_parallel()
    tp_checks = tpr["kernel_checks"]

    def tp_row(name, tpu, arch, path, launches, shape, tm, source):
        return kernel_row(name, tpu, f"{arch} tensor parallel tp={TP}, rank "
                          f"0, {path}", launches,
                          checks_of(tp_checks, shape) + [tm], tm,
                          source=source)
    g_ = tpr["models"]["granite-3-8b"]
    rows += [
        tp_row(f"spec_verify/tp{TP}", SPEC_VERIFY_TPU, "granite-3-8b",
               f"first tp={TP} rollout", g_["k1_launches"],
               f"granite-3-8b/tp{TP}", tpr["timing"]["granite-3-8b"],
               SPEC_VERIFY_SRC),
        tp_row(f"tree_verify/tp{TP}", TREE_VERIFY_TPU, "granite-3-8b",
               "tree pass", g_["tree"]["k2_launches"],
               f"granite-3-8b/tp{TP}/tree", tpr["timing"]["tree"],
               SPEC_VERIFY_SRC),
        *[tp_row(f"spec_verify/{a}/tp{TP}", SPEC_VERIFY_TPU, a,
                 f"first tp={TP} rollout", tpr["models"][a]["k1_launches"],
                 f"{a}/tp{TP}", tpr["timing"][a], SPEC_VERIFY_SRC)
          for a in (MOE_ARCH, "zamba2-1.2b")],
        kernel_row(f"ssd_scan/tp{TP}", SSD_TPU,
                   f"zamba2-1.2b tensor parallel tp={TP}, rank 0, first "
                   f"tp={TP} rollout (Mamba2 blocks whole on each rank)",
                   tpr["models"]["zamba2-1.2b"]["k4_launches"],
                   checks_of(report["ssd_kernel_checks"], "mamba2-370m",
                             other=True),
                   report["ssd_kernel_time"][0], source=SSD_SRC)]

    report["wall_total_s"] = time.perf_counter() - t0
    log(f"whole run: {report['wall_total_s']:.1f} s")
    if out_dir:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    print(f"chip_smoke: started at {time.time():.1f}", file=sys.stderr,
          flush=True)
    try:
        rc = main()
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
    print(f"chip_smoke: done at {time.time():.1f}", file=sys.stderr,
          flush=True)
    sys.stdout.flush()
    # every process it started has been joined: the interpreter's
    # teardown of this one (the CUDA context, the profiler's state) is
    # skipped, as it took minutes after a whole run on the card
    os._exit(rc)
