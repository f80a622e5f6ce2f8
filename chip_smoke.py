#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any mismatch or exception exits non-zero:

1. prints the card's name and power limit and its compute mode
   (``nvidia-smi``);
2. builds the four CUDA sources in ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` each, in parallel), prints the build seconds and, for every
   kernel, its registers, static shared memory, stack and local-memory
   spills (``ptxas -v``);
3. kernel phase: each kernel against its plain PyTorch version on the
   card, bit for bit: pack_rows (aligned and with rows off 16-byte
   boundaries; no path calls it), popcount_rows (bool rows read in
   place), coverage_multi (from the sorted int64 window bounds) and
   phase_step (from the regions' bool planes, read back as the engine
   reads it) at the main path's shapes (fig3_weak, W=256: a 256 x 16384
   plane, 2W = 512 bounds) and at edge shapes (for phase_step ragged and
   unaligned caps that differ between regions, W=1, base=-1 rows,
   INT32_MAX pads, row mask or none, the width limit, one region more
   than a launch takes; for popcount_rows R = 1, C = 0 and C = 1, ragged
   tails, rows 1-15 bytes off 16-byte boundaries, a column window and
   every other row of a wider plane, mask bytes of 2 and 0xff; for
   coverage_multi n < 2, all-equal bounds, a start equal to an end,
   duplicate starts and ends, bounds past INT32_MAX, n = 5000); and
   ``RegionDirectory.dirty_counts`` and ``shared_intervals`` of one
   'kernels'-tier region at fig3_weak's shape, timed (host clock, each
   call ending on the host's read) and traced (device activities a
   call); the page_diff kernels
   diff_encode (with and without its change bounds), diff_apply and the
   in-place merges diff_apply_ and diff_apply_rows_ at the reference
   path's shapes (1, 256) and
   (1, 1024), a batched (4096, 1024) and a ragged (5, 1001), with -0.0,
   NaN-payload, equal-NaN and denormal words and mask bytes of -1 and 2
   (compared on their bits); the model kernels flash_attention (at the
   internlm2-1.8b prefill shape in float32 and bfloat16, a ragged S, a
   window with a softcap, MQA, the reduced shape, and the prefill shapes
   of moonshot-v1-16b-a3b, qwen2-vl-72b and musicgen-medium at B=4,
   S=511; 2e-5 in float32, rtol 8e-3 / atol 2e-3 in bfloat16) and
   ssd_chunk (at the mamba2-2.7b prefill shape with grouped and per-cell
   B/C rows, in bfloat16, reduced and ragged; 1e-4).  Prints, after
   the rank-select phase (5a), each kernel's median time (CUDA events;
   for the page_diff kernels and the protocol-sweep kernels also their C
   entry's, and for the protocol-sweep kernels one launch's device time
   from torch.profiler, and phase_step's flush with its read-back), the
   plain version's, the yardstick (``torch.count_nonzero`` for
   popcount_rows, ``torch.cumsum`` of the sorted deltas, the scan that
   the kernel replaces, for coverage_multi, ``torch.where`` for the
   merges, ``scaled_dot_product_attention`` for flash_attention) and
   the bound: the larger of the bytes over the HBM rate and the
   operations over the peak of the units that run them (bfloat16
   attention on the tensor cores; float32 attention and ssd_chunk as
   three TF32 tensor-core products each, a third of the TF32 peak), and
   which of the two it is (for the rank-select kernels also the bound
   on packed words, the parent design's operands);
4. main-path phase: the W=256 batched points of fig2_strong, fig3_weak,
   fig5_strong, fig6_weak and fig7_md (samhita and samhita_page, Jacobi
   and MD in lock and reduction modes) on the 'fused' tier, plus the two
   fig2_strong points on 'kernels', at the benchmark harness's settings
   (IB_2013, fetch_batch=16, iters=4).  Every point's traffic must equal
   its ``BENCH_scale.json`` row field for field and its modeled time must
   round to the row's ``t_model_s``; the launch counters must show that
   each run went through the kernels (phase_step on 'fused',
   popcount_rows and coverage_multi on 'kernels'), and that no point
   launched pack_rows (every kernel reads the bool planes itself); the
   lock points' spans must run through ``span_all``'s grant groups
   (``span_workers_vec`` > 0, ``span_serial_workers`` 0), and on 'fused'
   their hoisted flush must launch phase_step with its row mask;
4a. span phase (slice D): the two W=256 batched fig6_lock_contention
   rows (samhita and samhita_page) on 'fused' and samhita on 'kernels',
   at benchmarks/lock_contention.py's settings and the meta's
   iterations, each equal to its ``BENCH_scale.json`` row (traffic
   field for field, ``t_model_s``, ``span_vec``, ``span_serial``), with
   phase_step launched with its row mask on 'fused' and popcount_rows
   and coverage_multi on 'kernels'; then lock_contention at W=256 under
   a roomy cache (grant groups) and a tight one (every span pass
   serializes), on the card and on the CPU under both drivers: traffic
   and clocks bit-equal across the four runs, stats equal between card
   and CPU.  Prints walls and peak device memory beside the card's
   ``nvidia-smi`` line;
4b. race phase (slice E): the 12 committed fig11_races rows (W = 16, 64,
   256 x samhita, samhita_page x loop, batched) at benchmarks/races.py's
   settings on 'fused', each with detection off and then on: the two
   runs' traffic equal and clocks bit-equal, the on run equal to its
   ``BENCH_scale.json`` row (traffic field for field, ``t_model_s``,
   ``race_ww``, ``race_rw``, ``span_vec``, ``span_serial``), and the
   W=256 batched samhita row once more on 'kernels'; the W=256 batched
   fig6_weak and fig7_md lock points (samhita) with detection on, their
   committed rows unchanged, Jacobi flagging nothing and MD exactly the
   page-level false sharing of its blocks (``md_false_sharing``; the
   reference flags the same set); four race-family traces
   (``race_program``, cache_pages None, 3, 6, 9) on 'fused' and
   'kernels' under both drivers, equal to the same runs on the CPU (race
   sets, stats, traffic, clocks), the cached ones launching the
   rank-select kernels; then the W=256 batched samhita fig11 point
   traced with detection off and on (detection on at most twice the
   device activities of off; both counts, idle shares and walls
   printed);
4c. serving phase (slice F): the 12 committed fig8_kv_serving rows (W =
   16, 64, 256 x samhita, samhita_page x loop, batched) at
   benchmarks/kv_serving.py's settings on 'fused', and the W=256 batched
   samhita row on 'kernels': each equal to its ``BENCH_scale.json`` row
   (traffic field for field, ``t_model_s``, every ``srv_*`` counter,
   ``danger_*`` and ``span_*``), with phase_step launched on 'fused'
   (take_and_cut too in the batched rows), popcount_rows,
   coverage_multi, take_first_k and kth_set_index on 'kernels', and
   pack_rows on neither.  Prints the modeled p50/p99 latency, tokens/s,
   walls and peak device memory;
4d. recovery phase (slice F): the 12 committed fig9_recovery rows at
   benchmarks/recovery.py's settings (``ChaosNet`` seed 11, drop rate
   0.05, a straggler monitor) on 'fused', and the W=256 batched samhita
   row on 'kernels': the uninjected run equal to its row (traffic,
   ``t_model_s``, chaos and straggler counters), its checkpoint saved
   and loaded with equal clocks, a ``ChaosHarness`` run with one crash
   bit-equal to it and its event counters equal to the committed
   recovery CSVs'; then a snapshot taken on the card mid-program and
   restored on the CPU, and one taken on the CPU and restored on the
   card, all finishing bit-equal.  Prints ``t_ckpt``, ``t_restore``,
   ``t_recovery``, walls and ``ckpt_bytes``;
4e. cluster phase (slice G): 6 of the 12 committed fig10_availability
   rows at W=256 (both drivers), ``samhita_s1`` and ``_s4`` clean and
   ``samhita_s4_fault``, at benchmarks/availability.py's settings (8 pages a
   worker, the recovery program, ``ChaosNet`` and straggler settings, 3
   RPC attempts; the faulted rows SIGKILL the last rank and partition
   rank 0's replies, recovered by respawn) but a 1.0 s deadline floor
   (``CARD_RPC_TIMEOUT_S``) on 'fused': ``ClusterRuntime`` spawns 1
   or 4 shard processes, each a full replica with its planes on the
   card.  Each run is bit-equal to a single-process run on the card,
   its round digests in lockstep with that run's, and equal to its
   ``BENCH_scale.json`` row (``t_model_s``, ``tr_*``, ``rec_*``, chaos
   and straggler counters); every shard reports ``cuda``, and the
   shards' own launch counters (their ``gather`` replies) show
   phase_step and no pack_rows.
   Prints each row's wall, events/s, p50/p99 barrier-round latency,
   largest round latency and RPC retries;
5. spill phase: the six W=256 batched capacity-pressure points
   (fig4_spill fits and spills, fig4_spill_heavy, fig4_refetch,
   fig5_spill, fig7_md_spill) on 'fused' at the harness's cache settings,
   plus fig4_refetch and fig7_md_spill on 'kernels'.  Each must match its
   ``BENCH_scale.json`` row as above and its committed danger counters
   (``artifacts/bench/*.csv``); the launch counters must show
   popcount_rows, phase_step and take_and_cut launched on 'fused' and
   take_first_k and kth_set_index on 'kernels', and pack_rows launched
   on neither; no rank-select call (take_upto_row, lru_take) may call
   pack_rows.
   Prints the histogram of the victim scans' (run length, k);
5a. rank-select phase: take_first_k, kth_set_index and take_and_cut on
   bool run rows read in place, and the one-run take_run (fused and
   not), against their plain versions bit for bit, at the lru_take shape
   of fig4_spill (256 runs of 32768 columns), on every victim-scan run
   of the spill phase, and at edge cases (k = 0, k < 0, k past the
   count, k = INT32_MAX, ranks by value, empty rows, ragged last words,
   R = 1, C = 1, rows 1 byte off 16-byte boundaries in a plane that ends
   mid-word, a column window and every other row of a wider plane);
   timed (wrapper, C entry, one launch on the device) at the lru_take
   shape and at the commonest victim scan, whose whole scan (the host
   mask to the card, one launch, one copy back) is timed and traced on
   'fused' and 'kernels';
6. reference phase: the per-page reference engine with page values on
   the card.  The program of ``examples/dsm_jacobi.py`` at n=32, W=4
   (fine/lock for 700 iterations, converging to max error < 0.05;
   fine/reduction and page/lock for 100), and the W=256 samhita Jacobi
   (lock), MD (lock) and STREAM points at the harness's sizes, iters 2:
   metadata-only against the scale engine (traffic exact, clocks allclose
   1e-9), with values bit-equal to the same run on the CPU (traffic,
   clocks, final values); and a false-sharing program (ordinary writes of
   disjoint words of shared pages, fine and page protocols), bit-equal to
   the CPU and every word at its last write.  Each run's page_diff
   launches must equal its CPU twin's wrapper calls, and each of the
   four page_diff kernels must launch; prints walls and peak device
   memory;
7. profile phase: the device busy share and device activities of the
   two samhita fig6_weak points (lock, reduction), of fig4_refetch and
   fig7_md_spill and of the reference engine's W=256 Jacobi with
   values, each from a separate torch.profiler run that traces the
   device's activities only; the lock point may issue at most twice the
   reduction point's device activities;
8. model phase (slices M and H): one model resident at a time, float32
   weights drawn on the card from seed 0, serves 8 requests (the
   reference server's, prompts up to 511 tokens, 16 new tokens) in waves
   of 4: internlm2-1.8b, mamba2-2.7b and musicgen-medium at full width and
   depth, moonshot-v1-16b-a3b (MoE, 64 experts, top-6) at full width with
   depth cut to 24 of 48 layers and qwen2-vl-72b (M-RoPE) at full width
   with depth cut to 8 of 80 (the cuts keep the float32 weights on the
   card: 57.5 and 38 GB); token models through ``launch.serve.serve``,
   the ``embeds`` models (musicgen, qwen2-vl) through ``generate`` on
   N(0, 1) prompt embeddings, qwen2-vl's with (3, B, S) positions of
   text then an image grid.  flash_attention must launch once per
   attention layer per wave (24, 24, 48, 8 x 2) and ssd_chunk once per
   SSD layer (64 x 2), decode neither; logits finite, tokens in range
   and the served ones; prints prefill and per-token decode walls,
   tokens/s, peak device memory and a traced wave's device time by
   kernel (the eight largest, and the port's own kernels whatever their
   rank).  Then each model with depth cut to 1 layer (the only cut)
   against the same weights on the CPU on its first wave (both waves
   until the sp phase needed the time): MoE routes equal but for near
   ties within 1e-4 of router probability (counted; outputs after a
   route difference in a row not compared), teacher-forced logits within
   1e-3 and greedy tokens equal but for near ties.  grok-1-314b and
   jamba-1.5-large-398b (MoE beside SSD layers), which no card holds at
   full width, run reduced: the same serve run and checks on the card
   (flash_attention 1 x 2, ssd_chunk 7 x 2 for jamba), then all layers
   against the CPU;
9. train phase (slice I): internlm2-1.8b at full width and depth
   (1,889,110,016 float32 parameters drawn on the card from seed 0)
   trained by ``make_train_step`` (AdamW, remat "full") for 4 steps on
   ``make_pipeline``'s synthetic batches of 2 x 4096 tokens (the train_4k
   shape's sequence, its global batch of 256 cut to 2): loss and grad
   norm finite, flash_attention launched 2 x 24 times a step and no other
   kernel; prints each step's wall, tokens/s, model TFLOP/s and peak
   device memory.  Then its full-width 2-layer twin, one train step on
   the card against the CPU on one batch of 1 x 512 tokens (loss within
   1e-4, grad norm 1e-4 relative, every gradient leaf 1e-3 of its largest
   value, the card's AdamW on the CPU's gradients within 1e-6); the
   Trainer on the card at tests/test_trainer.py's settings, 8 steps, a
   failure injected at step 6 and restarted from the step-4 checkpoint,
   bit-equal to the uninjected run; and jamba-1.5-large-398b reduced (MoE
   beside SSD layers), one train step card against CPU, routes first;
9a. regc phase (slice J): RegC gradient sync across processes.  (a) The
   full-width 2-layer internlm2-1.8b takes one ``make_train_step`` step
   on a global batch of 4 x 2048 in 2 microbatches in this process (its
   loss, grad norm and gradients kept on the host); then two ranks,
   spawned on the card and joined over gloo (NCCL refuses two ranks on
   one device), draw the same parameters and take one
   ``make_train_step_regc`` step each from them under
   benchmarks/regc_training.py's four policies (lazy_object, lazy_bucket
   at 64 MiB buckets, eager_object, int8_ring): loss within 1e-4, grad
   norm 1e-4 relative (int8_ring 4e-3), the psum policies' synced
   gradients 1e-3 of each leaf's largest value and int8_ring's 2e-2 of it
   and the reference test's ring bound, |ring - psum| / (|psum| + 1e-3)
   < 0.05, elementwise (and on its own input on the card), both ranks'
   parameters and moments equal after
   every step (a positional checksum of their bits), the counted
   collectives equal to the rule for this tree; prints each step's wall,
   the sync's wall, bytes, messages, the backend, the host staging and
   each rank's peak memory over its steps (the one-process gradients
   held on the host, pinned, and compared leaf by leaf on the card).  (b) ``launch.train --path regc
   --sync-compression int8_ring`` on 2 ranks under
   ``python -m torch.distributed.run``, 6 steps, checkpoints every 3:
   both ranks end on the same loss and rank 0's checkpoint holds step 6.
9b. tp phase (slice K): tensor, expert and FSDP parallelism of
   training.  moonshot-v1-16b-a3b at full width (d_model 2048, 16
   heads, 64 experts of d_ff 1408, top-6, vocabulary 163840), remat
   "full", sequences of 1024, ``DEFAULT_RULES`` (what
   ``launch.specs.rules_for`` gives an MoE train shape, as the
   reference's), parameters drawn on the card
   from seed 0.  (a) 1 layer, mesh (1, 2) ("data", "model"), a global
   batch of 2, one step each with ``moe_impl`` dense and ep from the
   same state; (b) 1 layer, mesh (2, 2) (FSDP over data, two dispatch
   groups, the data-axis gradient sums), a global batch of 4, ep.  Each
   run: first the one-process ``make_train_step`` step in this process
   with ``moe_block`` at the run's groups (the ep runs with each group's
   aux loss averaged), its scalars, routes and gradients kept on the
   host (a float32 file under ``build/``), the card freed; then 2 or 4
   ranks spawned on the card over gloo draw the same parameters, keep
   their blocks (``shard_state``) and take the sharded step: loss within
   1e-4, grad norm 1e-4 relative, every gradient block within 1e-3 of
   its leaf's largest |value|, the sharded AdamW of the one-process
   gradients within 1e-6 of AdamW's own, MoE routes equal but for
   counted near ties (``compare_routes``), ``aux_loss`` within 1e-6,
   ``expert_load`` equal, and every block held by several ranks
   bit-equal (a positional checksum); flash_attention launched twice a
   layer a rank (forward and remat).  Prints each rank's step wall, the
   collectives' bytes and messages a rank by kind and axes, the bytes
   staged through the host, the peak memory a rank and the backend.
9c. serve-tp phase (slice L): serving under a sharding context, the
   model phase's first wave of 4 requests left-padded to 496 tokens and
   8 new ones (float32 caches of 504 positions), float32 parameters
   drawn on the card from seed 0.  (a) internlm2-1.8b whole (24 layers)
   under ``SMALL_SERVE_RULES`` on mesh (2, 2) ("data", "model"): rows
   over data; q heads, vocabulary and the KV cache's positions over
   model; (b) mamba2-2.7b whole (64 layers), the same rules on (1, 2):
   the SSD inner dim over model; (c) llama3-405b at full width, 1 of 126
   layers, ``DECODE_2D_RULES`` with ``gather_fsdp=False`` on (2, 2):
   d_model over data, heads, d_ff and vocabulary over model, positions
   over both, no weight ever gathered.  Each run: the one-process
   ``make_prefill_step`` / ``make_serve_step`` wave, greedy, in this
   process (logits to a float32 file under ``build/``, the card freed);
   then 2 or 4 ranks spawned on the card over gloo ((a) and (c) share
   one start of 4) draw the same parameters a leaf at a time, in turn,
   keep their blocks and serve the wave fed the one-process tokens: logits within 1e-3 of the one
   process's at every step, greedy tokens equal but for counted near
   ties, every rank's tokens equal, every cache buffer the rank's block
   (``max_len / n`` KV positions, or its conv channels and SSD heads),
   no parameter gathered in (c), flash_attention launched 24 (a) and 1
   (c) times a rank and ssd_chunk 64 (b) in the prefill, neither in
   decode.  Prints a rank's prefill wall and decode ms a token, the
   collectives' bytes and messages (prefill; decode a token) by kind and
   axes, the bytes staged through the host, the peak memory a rank and
   the cache bytes a rank against one process.
9d. sp phase (slice M): training under the serving half's mechanisms,
   float32 parameters drawn on the card from seed 0, sequences of 1024,
   remat "full", mesh (2, 2) ("data", "model").  (a) mamba2-2.7b at full
   width, 2 of its 64 layers, ``TRAIN_SP_RULES`` (the residual saved at
   each super-block boundary split over model, the SSD inner dim over
   model, FSDP over data), ``adamw8bit``, a global batch of 4; (b)
   internlm2-1.8b at full width, 1 of its 24 layers, ``DECODE_2D_RULES``
   with ``gather_fsdp=False`` (batch whole; d_model over data; heads,
   d_ff and vocabulary over model), AdamW, a global batch of 2.  Each
   run's one-process ``make_train_step`` step first (its gradients to a
   float32 file under ``build/``, the card freed), after 9c's
   comparators; then the 4 ranks of 9c's (a) and (c), in the same start
   and after serving, draw the same parameters a leaf at a time, keep
   their blocks and take both sharded steps: loss within
   1e-4, grad norm 1e-4 relative, every gradient block within 1e-3 of
   its leaf's largest |value|, the sharded optimiser on the one-process
   gradients against the one-process optimiser on the same gradients
   and square norm ((a): int8 codes and scales bit-equal; (b): within
   1e-6), every block held by several ranks bit-equal, each checkpoint
   of (a) saving 512 of the 1024 positions, no parameter gathered in
   (b), ssd_chunk launched 4 times a rank in (a) and flash_attention 2
   in (b) (forward and remat).  Prints a rank's step wall and peak
   memory and the one process's, the collectives' bytes and messages by
   kind and axes, the bytes staged through the host and the optimiser
   state's bytes a rank against AdamW's.
9e. launch phase (slice N): the launch analysis (``launch.dryrun``) on
   walls and counters the phases above took; no step runs on the card.
   (a) The train phase's cell, counted on ``meta`` as the one rank of
   an ``AbstractMesh``: counted FLOPs and ``model_flops``, model TFLOP/s
   of each over the train phase's step walls, the roofline bound and its
   dominant term at ``PEAK_FLOPS_F32``, ``total_live`` against the
   train phase's ``max_memory_allocated``; ``memory_per_device.
   arguments`` equal to the bytes of the parameters, optimiser state and
   batch the train phase held, no kernel launched.  (b) 9d's cell (b)
   on an ``AbstractMesh`` at each of its 4 ranks: each rank's collective
   bytes and messages by (kind, axes) equal to what that rank counted in
   9d, no parameter gathered.  Prints the phase's wall.

TF32 is off for every float comparison (printed at the start).  The
launch counters are set to 0 just before each of the path phases (the
race phase's traced runs come after its reading; the model phase:
before each serve run; the cluster phase reads its shard processes'
counters, which start at 0) and read just after; a kernel's
``launches`` in the table is the sum of the readings.  Each phase
prints its wall as it ends (``phase <name>: <s> s``).  The line before
the last is the kernel table as one
JSON object; the last line is ``{"ok": true, "device": {...}}``.  Full
results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import csv
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM dense peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and bfloat16 on the tensor cores; a shape's FLOP bound takes the
# rate of the units its kernel runs it on
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# ssd_chunk (float32, and bfloat16 widened) and float32 flash_attention
# run their products on the tensor cores as three TF32 products of split
# operands: a third of the 495 TFLOP/s TF32 peak
TF32_SPLIT_FLOPS_PER_S = 495e12 / 3
SOURCES = {"protocol_sweep": "src/repro_torch/kernels/csrc/protocol_sweep.cu",
           "page_diff": "src/repro_torch/kernels/csrc/page_diff.cu",
           "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_chunk.cu"}
# flash_attention's prefill shapes (B, Hq, Hkv, S, D) of the MoE, M-RoPE
# and embeds models the model phase serves: B = 4 requests a wave, S = 511
# the longest prompt the server makes
FLASH_MODEL_SHAPES = (("moonshot-v1-16b-a3b", (4, 16, 16, 511, 128)),
                      ("qwen2-vl-72b", (4, 64, 8, 511, 128)),
                      ("musicgen-medium", (4, 24, 24, 511, 64)))
# flash_attention's shape on the train path: internlm2-1.8b's layers at the
# train phase's batch, B = 2 sequences of S = 4096 (64 query tiles, 128
# key tiles of the float32 kernel)
FLASH_TRAIN_SHAPE = ("internlm2-1.8b train", (2, 16, 8, 4096, 128))
# and on the regc path (phase 9a): the one-process step's microbatch of
# B = 2 sequences of S = 2048, and a rank's microbatch of B = 1
FLASH_REGC_SHAPES = (("internlm2-1.8b regc one-process", (2, 16, 8, 2048, 128)),
                     ("internlm2-1.8b regc rank", (1, 16, 8, 2048, 128)))
# phase 9b's shape a rank: moonshot-v1-16b-a3b's 16 heads split over two
# model ranks, 2 rows of 1024 a rank in (a) and (b)
FLASH_TP_SHAPES = (("moonshot-v1-16b-a3b tp rank", (2, 8, 8, 1024, 128)),)
# phase 9c's prefill shapes a rank (S = 496): (a) internlm2-1.8b, 2 rows,
# 8 of its 16 q heads reading 4 of its 8 kv heads; (c) llama3-405b, all 4
# rows, 64 of its 128 q heads reading 4 of its 8 kv heads
FLASH_SERVE_TP_SHAPES = (
    ("internlm2-1.8b serve-tp rank", (2, 8, 4, 496, 128)),
    ("llama3-405b serve-tp rank", (4, 64, 4, 496, 128)))
# phase 9d's shape a rank: (b) internlm2-1.8b, both rows of 1024, 8 of
# its 16 q heads reading 4 of its 8 kv heads
FLASH_SP_SHAPES = (("internlm2-1.8b sp rank", (2, 8, 4, 1024, 128)),)
# and ssd_chunk's: 9c's (b) mamba2-2.7b's 40 of 80 heads a rank, 4 rows of
# 2 chunks of 256 (S = 496 padded), one B/C row per 40 heads; 9d's (a)
# the same cells: 2 rows of 4 chunks of 256, 40 heads
SSD_SERVE_TP_SHAPE = ("mamba2-2.7b serve-tp and sp rank",
                      (320, 256, 64, 128, 40))
TPU_KERNELS = {
    "pack_rows": "src/repro/kernels/protocol_sweep.py:134",
    "popcount_rows": "src/repro/kernels/protocol_sweep.py:232",
    "coverage_multi": "src/repro/kernels/protocol_sweep.py:333",
    "phase_step": "src/repro/kernels/protocol_sweep.py:426",
    "take_first_k": "src/repro/kernels/protocol_sweep.py:266",
    "kth_set_index": "src/repro/kernels/protocol_sweep.py:310",
    "take_and_cut": "src/repro/kernels/protocol_sweep.py:415",
    "diff_encode": "src/repro/kernels/page_diff.py:54",
    "diff_apply": "src/repro/kernels/page_diff.py:78",
    "diff_apply_": "src/repro/kernels/page_diff.py:78",
    "diff_apply_rows_": "src/repro/kernels/page_diff.py:78",
    "flash_attention": "src/repro/kernels/flash_attention.py:79",
    "ssd_chunk": "src/repro/kernels/ssd_chunk.py:52",
}
# the CUDA source of each kernel
SOURCE_OF = {**dict.fromkeys(TPU_KERNELS, "protocol_sweep"),
             "diff_encode": "page_diff", "diff_apply": "page_diff",
             "diff_apply_": "page_diff", "diff_apply_rows_": "page_diff",
             "flash_attention": "flash_attention", "ssd_chunk": "ssd_chunk"}
ITERS = 4
W = 256
PROTO = {"samhita": "fine", "samhita_page": "page"}
# benchmark sizes (benchmarks/{stream_triad,jacobi,molecular_dynamics}.py)
N_TRIAD = 16 << 20
N_JACOBI = 4096
N_PARTICLES = 8192
# benchmarks/lock_contention.py: N_BASE, n_locks, sweeps
LOCK_N = 1 << 20
LOCK_LOCKS = 8
LOCK_SWEEPS = 2
# the span phase's cache settings: room for every page a worker touches
# (4 of its block, 1 striped, 1 hot), and fewer than its block's pages
LOCK_CACHES = (("roomy", 64), ("tight", 3))
# race phase (benchmarks/races.py's N_BASE, N_LOCKS and W sweep), and
# the seeds of the four race_program traces with cache_pages None, 3, 6, 9
RACE_N = 1 << 20
RACE_LOCKS = 4
RACE_CORES = (16, 64, 256)
RACE_SEEDS = (24, 13, 6, 39)
# serving phase: benchmarks/kv_serving.py's settings (CORES, REQ_PER_SLOT,
# TOK_WORDS, MAX_TOKENS, ATTN_WINDOW, CACHE_PAGES, N_TENANTS, SEED; its
# burst_mean is max(2, W // 8) and gap_max 2)
SERVE_CORES = (16, 64, 256)
SERVE_REQ_PER_SLOT = 3
SERVE_TOK_WORDS = 64
SERVE_MAX_TOKENS = 96
SERVE_ATTN_WINDOW = 32
SERVE_CACHE_PAGES = 4
SERVE_TENANTS = 16
SERVE_SEED = 7
# recovery phase: benchmarks/recovery.py's settings (PAGE_WORDS,
# PAGES_PER_WORKER, CORES, DROP_RATE, CHAOS_SEED; its straggler window 4
# and patience 2, and the crash at tick 3 * max(1, iters // 2) on worker
# W // 2)
RECOVERY_PAGE_WORDS = 1024
RECOVERY_PAGES_PER_WORKER = 16
RECOVERY_CORES = (16, 64, 256)
RECOVERY_DROP_RATE = 0.05
RECOVERY_CHAOS_SEED = 11
# cluster phase: benchmarks/availability.py's settings (PAGES_PER_WORKER,
# SHARDS, RPC_TIMEOUT_S, RPC_ATTEMPTS; the recovery program and chaos
# settings above), on the W=256 rows of both drivers (the W=16 rows run
# on the CPU, in tests/test_torch_cluster.py).  The smoke runs 6 of the
# 12 rows: of its SHARDS (1, 2, 4) the 1- and 4-shard clean rows and the
# 4-shard faulted ones; the 2-shard rows and the 1-shard faulted ones
# (176 s of the phase's 320 s on an H100) were cut for the tp phase's time;
# 2 shards with a kill and a partition run on the card in
# tests/test_torch_cuda.py, and the cut rows' kinds on the CPU in
# tests/test_torch_cluster*.py
AVAIL_PAGES_PER_WORKER = 8
AVAIL_SHARDS = (1, 4)
AVAIL_FAULT_SHARDS = (4,)
AVAIL_GROUPS = ((256, "loop"), (256, "batched"))
AVAIL_RPC_TIMEOUT_S = 0.25
AVAIL_RPC_ATTEMPTS = 3
# the deadline floor on the card: with four shard processes a W=256 span
# round takes up to 2.6 s there, past the 0.25 s floor's 1.75 s chain (a
# false detection); 1.0 s gives a 7 s chain.  The rec_* counters do not
# depend on it (a kill shows as EOF, a partition after every attempt)
CARD_RPC_TIMEOUT_S = 1.0


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def host(x):
    """A read's values as a host numpy array (a tensor is copied back)."""
    import numpy as np
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def dsm_jacobi(rt, n: int = 32, iters: int = 700, mode: str = "lock"):
    """The program of ``examples/dsm_jacobi.py`` (its ``run``) on a
    reference runtime with values: the 2-D Poisson problem -lap(u) = f
    with a manufactured solution, row blocks across ``rt.W`` workers, the
    residual accumulated under a lock span (``lock``) or through the
    reduction extension.  The stencil and residual arithmetic stay numpy
    on the host; each read is copied back, so any difference between two
    runs is the engine's.  Returns (final u (n, n) float32, max error
    against the analytic solution)."""
    import numpy as np
    res_lock = 0
    W = rt.W
    u, uold, fga, res = (rt.alloc(n * n), rt.alloc(n * n), rt.alloc(n * n),
                         rt.alloc(1))
    xs = np.linspace(0, 1, n)
    uu, vv = np.meshgrid(xs, xs)
    u_star = np.sin(np.pi * uu) * np.sin(np.pi * vv)
    h = 1.0 / (n - 1)
    f_np = (2 * np.pi ** 2 * u_star).astype(np.float32)
    rt.write(0, fga, 0, n * n, f_np.ravel())
    rt.barrier()
    rows = n // W
    for _ in range(iters):
        for w in range(W):                                # uold = u
            lo = w * rows * n
            hi = ((w + 1) * rows if w < W - 1 else n) * n
            rt.write(w, uold, lo, hi, rt.read(w, u, lo, hi))
        rt.barrier()
        for w in range(W):                                # stencil
            r0 = max(w * rows, 1)
            r1 = min((w + 1) * rows if w < W - 1 else n, n - 1)
            block = host(rt.read(w, uold, (r0 - 1) * n,
                                 (r1 + 1) * n)).reshape(-1, n)
            fblk = host(rt.read(w, fga, r0 * n, r1 * n)).reshape(-1, n)
            new = block[1:-1].copy()
            new[:, 1:-1] = 0.25 * (block[:-2, 1:-1] + block[2:, 1:-1]
                                   + block[1:-1, :-2] + block[1:-1, 2:]
                                   + h * h * fblk[:, 1:-1])
            local_res = float(np.abs(new - block[1:-1]).sum())
            rt.write(w, u, r0 * n, r1 * n, new.ravel())
            if mode == "lock":
                with rt.span(w, res_lock):
                    cur = host(rt.read(w, res, 0, 1))
                    rt.write(w, res, 0, 1, np.array(
                        [float(cur[0]) + local_res], np.float32))
            else:
                rt.reduce(w, "residual", local_res)
        rt.barrier()
        if mode == "lock":                                # residual read
            host(rt.read(0, res, 0, 1))
            with rt.span(0, res_lock):                    # and reset
                rt.write(0, res, 0, 1, np.zeros(1, np.float32))
        else:
            rt.reduction_result("residual")
        rt.barrier()
    final = host(rt.read(0, u, 0, n * n)).reshape(n, n)
    return final, float(np.abs(final - u_star).max())


def false_sharing(rt, rounds: int = 8, seed: int = 0):
    """Ordinary writes of disjoint words of four shared pages by every
    worker (each word has one owner), a span of another worker flushing
    between two rounds of writes, then a barrier: the second round
    refetches pages invalidated while dirty and overlays the pending
    words on them (the fetch overlay, ``diff_apply``), and every flush
    merges only its dirty words onto home (``diff_apply_``).  Returns
    (the values worker 0 reads at the end, the last value written to each
    word): equal for a correct engine."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = 4 * rt.page_words
    g = rt.alloc(n)
    owner = rng.integers(0, rt.W, n)
    last = np.zeros(n, np.float32)
    for r in range(rounds):
        for half in range(2):
            for w in range(rt.W):
                mine = np.flatnonzero(owner == w)
                for wd in np.unique(rng.choice(mine, 8)):
                    v = np.float32(rng.standard_normal())
                    rt.write(w, g, int(wd), int(wd) + 1, np.array([v]))
                    last[wd] = v
            if half == 0:
                with rt.span(r % rt.W, 0):
                    pass
        rt.barrier()
    return host(rt.read(0, g, 0, n)), last


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def timed_ms(torch, fn, n: int = 50, rounds: int = 5) -> float:
    """Median over ``rounds`` of the per-call time of ``n`` back-to-back
    calls, from CUDA events (warm-up first)."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / n)
    return statistics.median(per)


def profiled_ms(torch, fn, name: str, n: int = 100):
    """Median device time of one launch of the kernel whose name holds
    ``name``, over ``n`` calls of ``fn`` traced by torch.profiler: the
    kernel alone, without the host's launch cost.  A trace that recorded
    none of them (seen once on the card) is taken again, up to twice;
    when a trace recorded no device event at all the third time (the
    profiler on that card lost its device trace: seen once, in the
    rank-select phase after the cluster phase), None: the device time is
    not measured, and the kernel's CUDA-event time stands alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        times = [e.time_range.elapsed_us() for e in seen if name in e.name]
        if times:
            return statistics.median(times) * 1e-3
    if not seen:
        print(f"torch.profiler recorded no device event in 3 traces of "
              f"{name}: its device time is not measured", flush=True)
        return None
    raise AssertionError(f"torch.profiler recorded no {name} kernel among "
                         f"{sorted({e.name for e in seen})}")


def phase_step_read(torch, ps, fn, inp):
    """``fn`` (the kernel's wrapper or its plain version) on ``inp``, read
    back as the engine reads it: (counts, keys, words) as tensors, the
    entries sorted by key."""
    R, W_ = len(inp[0]), inp[0][0].shape[0]
    return tuple(torch.from_numpy(a.copy())
                 for a in ps.read_phase_step(fn(*inp), R, W_))


def make_same(torch):
    """``same(name, a, b)``: a kernel's result ``a`` (a tensor or a tuple
    of them) against its plain version's ``b``, bit for bit; raises on a
    difference, returns the largest absolute difference (0)."""
    def same(name, a, b):
        if isinstance(a, tuple):
            return max(same(name, x, y) for x, y in zip(a, b))
        torch.cuda.synchronize()
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel != plain version")
        if a.dtype == torch.bool:
            return 0
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0
    return same


def kernel_phase(torch, np, ps, dev):
    rng = np.random.default_rng(2013)
    results = {}
    same = make_same(torch)

    def t(a):
        return torch.as_tensor(a, device=dev)

    # --- pack_rows: the dirty plane of fig3_weak's A region, W=256 ----
    # (no path calls it: every kernel reads the bool planes itself),
    # aligned and with every row 1 byte off a 16-byte boundary (a view
    # one byte into a buffer)
    C = 16384
    plane = t(rng.random((W, C)) < 0.5)
    buf = torch.zeros(W * C + 16, dtype=torch.bool, device=dev)
    shifted = buf[1:1 + W * C].view(W, C)
    shifted.copy_(plane)
    err = same("pack_rows", ps.pack_rows(plane), ps._pack_rows_plain(plane))
    err = max(err, same("pack_rows", ps.pack_rows(shifted),
                        ps._pack_rows_plain(shifted)))
    for (w_, c_) in ((1, 1), (3, 31), (37, 1000), (W, 16385), (5, 16),
                     (2, 48), (9, 33), (W, 517)):
        p = t(rng.random((w_, c_)) < 0.3)
        err = max(err, same("pack_rows", ps.pack_rows(p),
                            ps._pack_rows_plain(p)))
        wide = torch.full((w_, -(-c_ // 32) + 3), -1, dtype=torch.int32,
                          device=dev)
        ref = torch.zeros_like(wide)
        ref[:, :-3] = ps._pack_rows_plain(p)
        err = max(err, same("pack_rows(out)", ps.pack_rows(p, out=wide),
                            ref))
    nw = -(-C // 32)
    stream = torch.cuda.current_stream().cuda_stream
    pack_entry = ps._KERNELS.entry("pack_rows")

    def pack_timed(pl, shape):
        o = ps.pack_rows(pl)
        args = (pl.data_ptr(), o.data_ptr(), W, C, nw, stream)
        return dict(shape=shape, ms=timed_ms(torch, lambda: ps.pack_rows(pl)),
                    c_entry_ms=timed_ms(torch, lambda: pack_entry(*args)),
                    profiled_ms=profiled_ms(torch, lambda: pack_entry(*args),
                                            "pack_rows_kernel"),
                    plain_ms=timed_ms(torch, lambda: ps._pack_rows_plain(pl),
                                      10),
                    library_ms=None, bytes=W * C + W * nw * 4)
    results["pack_rows"] = dict(
        err=err, unaligned=pack_timed(shifted, [W, C, "rows 1 B off 16"]),
        **pack_timed(plane, [W, C]))

    results.update(count_and_cover(torch, np, ps, dev, rng, same, plane,
                                   shifted))

    # --- phase_step: R=3 regions, W=256, caps 16384 (fig3_weak) -------
    # from the bool planes, no row mask, as the engine calls it; edges:
    # ragged and unaligned caps that differ between regions, dead rows,
    # W=1, a sparse mask, the width limit, and one region more than a
    # launch takes (two launches)
    R = 3
    read = lambda fn, inp: phase_step_read(torch, ps, fn, inp)  # noqa
    main = ps.phase_step_inputs(rng, R, W, (C,) * R, dev, False, False)
    err = same("phase_step", read(ps.phase_step, main),
               read(ps._phase_step_plain, main))
    n_regions = ps.MAX_PHASE_STEP_REGIONS + 1
    for (r_, w_, caps, dead, mask, step) in (
            (3, 7, (150, 161, 99), True, True, None),
            (1, 1, (40,), False, False, None),
            (2, 64, (1000, 1003), True, True, 7),
            (3, W, (517, 16383, 2049), True, False, None),
            (3, W, (16384, 16385, 4000), False, True, 301),
            (1, ps.MAX_PHASE_STEP_W, (40,), True, True, None),
            (n_regions, 16, tuple(rng.integers(1, 700, n_regions)), True,
             True, 3)):
        inp = ps.phase_step_inputs(rng, r_, w_, caps, dev, dead, mask, step)
        err = max(err, same("phase_step", read(ps.phase_step, inp),
                            read(ps._phase_step_plain, inp)))
    # timed at the main shape and with windows stacked ~50 deep (every
    # dirty word a candidate: the most entries, the most bounds walked)
    stacked = ps.phase_step_inputs(rng, R, W, (C,) * R, dev, False, False,
                                   301)
    step_entry = ps._KERNELS.entry("phase_step")
    timed = {}
    for key, inp in (("main", main), ("stacked", stacked)):
        n_cand = read(ps.phase_step, inp)[1].shape[0]
        out = ps.phase_step(*inp)
        ws = ps.phase_step_ws(torch.cuda.current_device())
        desc = (ctypes.c_longlong * (3 * R))(
            *[x.data_ptr() for x in inp[0]],
            *[g.data_ptr() for g in inp[1]], *[C] * R)
        args = (desc, None, out.data_ptr(), ws.data_ptr(), R, W,
                W * R * nw, stream)
        timed[key] = dict(
            shape=[R, W, C] + ([] if key == "main" else ["windows 301 apart"]),
            candidate_words=n_cand,
            ms=timed_ms(torch, lambda i=inp: ps.phase_step(*i)),
            c_entry_ms=timed_ms(torch, lambda a=args: step_entry(*a)),
            profiled_ms=profiled_ms(torch, lambda a=args: step_entry(*a),
                                    "phase_step_kernel"),
            flush_ms=timed_ms(torch, lambda i=inp: ps.read_phase_step(
                ps.phase_step(*i), R, W), 20),
            plain_ms=timed_ms(torch, lambda i=inp: ps._phase_step_plain(*i),
                              3, 3),
            library_ms=None,
            # the planes read once, the geometry read, counts, n and the
            # candidate entries written
            bytes=R * W * C + R * 3 * W * 4 + R * W * 8 + 8 + 16 * n_cand)
        print(f"phase_step flush {key} (launch, then counts and {n_cand} "
              "candidate words read back) "
              f"{timed[key]['flush_ms'] * 1e3:.2f} us", flush=True)
    results["phase_step"] = dict(err=err, stacked=timed["stacked"],
                                 **timed["main"])
    results.update(page_diff_phase(torch, np, rng, dev))
    results.update(model_kernel_phase(torch, np, dev))
    return results


def flush_windows(np, rng, C: int):
    """fig3_weak's window layout for one region of W rows: row w's
    window starts at w * (C - 1) pages and is C pages long (it shares
    its last page with the next row's window) or, for about half the
    rows, between C/2 and C pages.
    Returns host int64 (starts, ends) in row order."""
    starts = np.arange(W, dtype=np.int64) * (C - 1)
    length = np.where(rng.random(W) < 0.5, C,
                      rng.integers(C // 2, C + 1, W))
    return starts, starts + length


def directory_calls(torch, np, dev, C: int = 16384):
    """``RegionDirectory.dirty_counts`` and ``shared_intervals`` of one
    'kernels'-tier region at fig3_weak's flush shape (W = 256 rows of
    ``C`` pages, ``flush_windows``, half the cells of each window
    dirty), checked against numpy, then timed: the wall of one call
    (host clock over 200 back-to-back calls, each ending on the host's
    read, median of 5) and the device activities of one call (three
    traces of 10 calls each).  Uses only the directory's interface, so
    it times any tree's port (``sweep_probe.py``)."""
    from repro_torch.core.directory import RegionDirectory
    rng = np.random.default_rng(3)
    starts, ends = flush_windows(np, rng, C)
    d = RegionDirectory(W, 0, 0, int(ends.max()), backend="kernels",
                        device=dev)
    for w in range(W):
        d.ensure(w, int(starts[w]), int(ends[w]))
    cells = ((rng.random((W, C)) < 0.5)
             & (np.arange(C)[None, :] < (ends - starts)[:, None]))
    d.dirty.copy_(torch.as_tensor(cells, device=dev))
    if not np.array_equal(d.dirty_counts(), cells.sum(axis=1)):
        raise AssertionError("dirty_counts != numpy row sums")
    # the pages covered twice, page by page: a C-page window shares its
    # last page with the next row's
    cover = np.zeros(int(ends.max()) + 1, np.int64)
    np.add.at(cover, starts, 1)
    np.add.at(cover, ends, -1)
    edge = np.diff(np.concatenate([[0], np.cumsum(cover) >= 2, [0]]))
    want = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    got = d.shared_intervals()
    if not (want[0].size and all(map(np.array_equal, got, want))):
        raise AssertionError(f"shared_intervals: {got[0].size} intervals, "
                             f"{want[0].size} expected")
    out = {}
    for name, fn in (("dirty_counts", d.dirty_counts),
                     ("shared_intervals", d.shared_intervals)):
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            walls.append((time.perf_counter() - t0) / 200 * 1e3)
        traced = [device_activities(torch, lambda f=fn: [
            f() for _ in range(10)]) / 10 for _ in range(3)]
        out[name] = dict(shape=[W, C], wall_ms=statistics.median(walls),
                         device_activities=statistics.median(traced),
                         traced=traced)
        print(f"directory {name} ['kernels', W={W}, cap {C}]: wall "
              f"{out[name]['wall_ms'] * 1e3:.2f} us, "
              f"{out[name]['device_activities']} device activities a call "
              f"(three traces of 10 calls: {traced})", flush=True)
    return out


def count_and_cover(torch, np, ps, dev, rng, same, plane, shifted):
    """popcount_rows and coverage_multi against their plain versions on
    the card, bit for bit, at fig3_weak's shapes (``plane``: its W x
    16384 dirty plane, and ``shifted``, the same rows 1 byte off 16-byte
    boundaries; 2W = 512 sorted bounds) and the edges listed below;
    timed (wrapper, C entry alone, one launch on the device, the plain
    version, the library yardstick), with the directory calls that run
    them (``directory_calls``)."""
    results = {}
    C = plane.shape[1]
    stream = torch.cuda.current_stream().cuda_stream

    def t(a):
        return torch.as_tensor(a, device=dev)

    # --- popcount_rows: fig3_weak's dirty plane, read in place --------
    # (dirty_counts; evict_rows reads column windows of the plane);
    # edges: R = 1, C = 0 and C = 1, ragged tails, rows 1-15 bytes off
    # 16-byte boundaries (a view into a buffer that the plane ends), a
    # column window and every other row of a wider plane, mask bytes of
    # 2 and 0xff
    def popcount_same(p):
        return same("popcount_rows", ps.popcount_rows(p),
                    ps._popcount_rows_bool_plain(p.contiguous()))

    err = popcount_same(plane)
    err = max(err, popcount_same(shifted))
    mask_bytes = np.array([0, 1, 2, 255], np.uint8)
    for (r_, c_) in ((1, 0), (1, 1), (3, 0), (4, 1), (1, 1024), (7, 1025),
                     (37, 31), (5, 17), (W, 1000), (W, 16385)):
        for off in (0, 1, 5, 8, 15):
            raw = torch.zeros(r_ * c_ + off, dtype=torch.uint8, device=dev)
            p = raw[off:].view(r_, c_)
            p.copy_(t(rng.choice(mask_bytes, (r_, c_))))
            err = max(err, popcount_same(p.view(torch.bool)))
        wide = t(rng.random((2 * r_, c_ + 9)) < 0.5)
        err = max(err, popcount_same(wide[:r_, 3:3 + c_]))
        err = max(err, popcount_same(wide[::2, 7:7 + c_]))
    pop_entry = ps._KERNELS.entry("popcount_rows")
    counts = torch.empty(W, dtype=torch.int64, device=dev)
    pop_args = (plane.data_ptr(), C, W, C, counts.data_ptr(), stream)
    results["popcount_rows"] = dict(
        err=err, shape=[W, C],
        ms=timed_ms(torch, lambda: ps.popcount_rows(plane)),
        c_entry_ms=timed_ms(torch, lambda: pop_entry(*pop_args)),
        profiled_ms=profiled_ms(torch, lambda: pop_entry(*pop_args),
                                "popcount_rows_kernel"),
        plain_ms=timed_ms(torch, lambda: ps._popcount_rows_bool_plain(plane),
                          10),
        library_ms=timed_ms(torch, lambda: torch.count_nonzero(plane, 1)),
        library="torch.count_nonzero", bytes=W * C + W * 8)

    # --- coverage_multi: fig3_weak's 2W = 512 sorted bounds -----------
    # (int64, as the directory caches them on the card: windows every
    # C - 1 pages, so neighbours share a page); edges: n < 2, all-equal
    # bounds, a start equal to an end, duplicate starts and ends, bounds
    # past INT32_MAX, n = 5000
    def cover_same(b):
        b = t(np.asarray(b, np.int64))
        return same("coverage_multi", ps.coverage_multi(b),
                    ps._coverage_multi_plain(b))

    starts, ends = flush_windows(np, np.random.default_rng(3), C)
    cover_main = t(np.stack([np.sort(starts), np.sort(ends)]))
    err = cover_same(cover_main.cpu().numpy())
    for n, span, length, base in ((0, 1, 1, 0), (1, 1, 9, 0), (2, 1, 1, 0),
                                  (7, 1, 1, 40), (64, 6, 3, 0),
                                  (255, 0, 40, 0), (257, 0, 40, 0),
                                  (40, 0, 50, (1 << 33) + 17),
                                  (5000, 20000, 300, 0)):
        st = base + rng.integers(0, span or 4 * n, n)
        en = st + rng.integers(0, length, n)
        err = max(err, cover_same(np.stack([np.sort(st), np.sort(en)])))
    err = max(err, cover_same([[0, 10, 10, 20, 30], [10, 10, 20, 30, 30]]))
    n_cov = cover_main.shape[1]
    cover_entry = ps._KERNELS.entry("coverage_multi")
    cover_out = torch.empty(4 * n_cov, dtype=torch.int64, device=dev)
    cover_args = (cover_main.data_ptr(), n_cov, cover_out.data_ptr(), stream)
    order = torch.sort(cover_main.reshape(-1), stable=True).indices
    delta = torch.where(order < n_cov, 1, -1).to(torch.int32)
    results["coverage_multi"] = dict(
        err=err, shape=[2, n_cov],
        ms=timed_ms(torch, lambda: ps.coverage_multi(cover_main)),
        c_entry_ms=timed_ms(torch, lambda: cover_entry(*cover_args)),
        profiled_ms=profiled_ms(torch, lambda: cover_entry(*cover_args),
                                "coverage_multi_kernel"),
        plain_ms=timed_ms(torch,
                          lambda: ps._coverage_multi_plain(cover_main)),
        library_ms=timed_ms(torch, lambda: torch.cumsum(delta, 0)),
        library="torch.cumsum of the sorted deltas (the scan replaced)",
        bytes=2 * n_cov * 8 + 4 * n_cov * 8)
    calls = directory_calls(torch, np, dev)
    results["popcount_rows"]["dirty_counts"] = calls["dirty_counts"]
    results["coverage_multi"]["shared_intervals"] = calls["shared_intervals"]
    return results


def report_kernels(results):
    """Each kernel's bound (the larger of its bytes over the HBM rate and
    its operations over the peak of the units that run them), printed
    with its timings, at every timed shape; ``packed_bytes`` adds the
    rank-select kernels' bound on the parent design's packed words."""
    for name, r in results.items():
        # a second timed shape: the fig4_spill lru_take shape of the
        # rank-select kernels, a batched page_diff call, flash_attention
        # in bfloat16, ssd_chunk on the per-cell B/C layout, pack_rows on
        # unaligned rows, phase_step with stacked windows
        for shape in [r] + [r[k] for k in ("lru", "batched", "bf16",
                                           "per_cell", "unaligned",
                                           "stacked")
                            if k in r] + r.get("models", []):
            t_bytes = shape["bytes"] / HBM_BYTES_PER_S * 1e3
            peak = shape.get("flops_per_s", F32_FLOPS_PER_S)
            t_ops = shape.get("flops", 0) / peak * 1e3
            shape["bound_ms"] = max(t_bytes, t_ops)
            shape["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
            lib = ("" if shape.get("library_ms") is None else
                   f"  {r['library']} {shape['library_ms'] * 1e3:.2f} us")
            err = f"  max_abs_err={r['err']}" if shape is r else ""
            if "c_entry_ms" in shape:
                err += f"  C entry alone {shape['c_entry_ms'] * 1e3:.2f} us"
            if shape.get("profiled_ms") is not None:
                err += (f"  on the device {shape['profiled_ms'] * 1e3:.2f} us "
                        "(profiler)")
            elif "profiled_ms" in shape:
                err += "  on the device not measured (profiler)"
            if "packed_bytes" in shape:
                shape["packed_bound_ms"] = (shape["packed_bytes"]
                                            / HBM_BYTES_PER_S * 1e3)
                err += (f"  [bound on packed words "
                        f"{shape['packed_bound_ms'] * 1e3:.6f} us]")
            print(f"kernel {name:15s} shape={shape['shape']}{err}  kernel "
                  f"{shape['ms'] * 1e3:.2f} us  plain "
                  f"{shape['plain_ms'] * 1e3:.2f} us{lib}  bound "
                  f"{shape['bound_ms'] * 1e3:.6f} us ({shape['bound_by']}: "
                  f"{t_bytes * 1e3:.3f} us of bytes, {t_ops * 1e3:.3f} us "
                  f"of operations at {peak / 1e12:g} TFLOP/s)", flush=True)
    return results


def page_diff_inputs(np, rng, n: int, w: int):
    """Pages and twins with ~10% of the words changed plus every edge bit
    pattern (-0.0 against +0.0, two NaN payloads, equal NaN bits,
    denormals), and an apply mask of 0, 1, -1 and 2 bytes."""
    twin = rng.standard_normal((n, w)).astype(np.float32)
    curr = np.where(rng.random((n, w)) < 0.1,
                    rng.standard_normal((n, w)).astype(np.float32), twin)
    cb, tb = curr.view(np.int32), twin.view(np.int32)
    edges = [(0x80000000, 0x00000000), (0x7FC00001, 0x7FC00002),
             (0x7FC00005, 0x7FC00005), (0x00000001, 0x00000000),
             (0x807FFFFF, 0x00000002)]
    for k, (c, t) in enumerate(edges):
        i, j = k % n, (7 * k + 3) % w
        cb[i, j] = np.uint32(c).view(np.int32)
        tb[i, j] = np.uint32(t).view(np.int32)
    mask = rng.choice(np.array([0, 0, 0, 1, -1, 2], np.int8), (n, w))
    return curr, twin, mask


BOUNDS_CASES = ("none", "first", "last", "signed_zero", "nan", "random")


def page_diff_bounds_inputs(np, rng, case: str, n: int, w: int):
    """curr and twin (n, w) float32 whose diff is one edge of the change
    bounds: no changed word, one at word 0, one at word w - 1, -0.0
    against +0.0, NaN payloads (beside equal NaN bits, no change), or ~10%
    of the words (``BOUNDS_CASES``)."""
    twin = rng.standard_normal((n, w)).astype(np.float32)
    curr = twin.copy()
    cb, tb = curr.view(np.int32), twin.view(np.int32)
    if case == "first":
        curr[:, 0] += 1.0
    elif case == "last":
        curr[:, w - 1] += 1.0
    elif case == "signed_zero":
        twin[:, w // 3] = 0.0
        curr[:, w // 3] = -0.0
    elif case == "nan":
        tb[:, w // 2] = 0x7FC00002
        cb[:, w // 2] = 0x7FC00001
        cb[:, w // 5] = tb[:, w // 5] = 0x7FC00005
    elif case == "random":
        curr = np.where(rng.random((n, w)) < 0.1,
                        rng.standard_normal((n, w)).astype(np.float32), twin)
    return curr, twin


def page_diff_phase(torch, np, rng, dev):
    """diff_encode and the merges (diff_apply, in place diff_apply_, the
    row-indexed diff_apply_rows_) against their plain versions bit for
    bit (on int32 views: NaN payloads compare as bits) at the path's
    shapes (1, 256) and (1, 1024), a batched (4096, 1024) and a ragged
    (5, 1001), with every edge bit pattern; diff_encode also with its
    change bounds (``bounds=True``, the release's form) on every case of
    ``page_diff_bounds_inputs``; the in-place merge also on one
    page (W,), the row merge into a home of 2n + 3 pages; timed at
    (1, 1024) and (4096, 1024), wrapper and C entry (diff_encode in the
    release's form).  ``torch.where`` on a
    bool mask made beforehand is the merges' yardstick (``out=`` the
    destination for the in-place one); no single call computes
    diff_encode's three outputs or the row merge.  Bytes: 13 a word for
    diff_encode (plus 12 a page of counts and bounds) and diff_apply, each
    input read
    once and the output written once; the in-place merges need only the
    mask (1 a word) and, for the words whose mask is set in this run's
    data, vals read and dst written (8 a set word), plus 8 a row index
    for diff_apply_rows_."""
    from repro_torch.kernels import page_diff as pd

    def bits_err(name, got, want):
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            a = a.view(torch.int32) if a.dtype == torch.float32 else a
            b = b.view(torch.int32) if b.dtype == torch.float32 else b
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{name}: kernel != plain version")
        return 0

    def home_rows(n, w):
        n_home = 2 * n + 3
        home = torch.as_tensor(rng.standard_normal((n_home, w)),
                               dtype=torch.float32, device=dev)
        rows = torch.as_tensor(np.sort(rng.choice(n_home, n, replace=False)),
                               device=dev)
        return home, rows

    names = ("diff_encode", "diff_apply", "diff_apply_", "diff_apply_rows_")
    errs = dict.fromkeys(names, 0)
    timed = {}
    for n, w in ((1, 256), (1, 1024), (4096, 1024), (5, 1001)):
        curr, twin, mask = (torch.as_tensor(a, device=dev) for a in
                            page_diff_inputs(np, rng, n, w))
        enc = pd.diff_encode(curr, twin)
        errs["diff_encode"] = max(errs["diff_encode"], bits_err(
            "diff_encode", enc, pd._diff_encode_plain(curr, twin)))
        for case in BOUNDS_CASES:  # the change bounds' edges
            c, t_ = (torch.as_tensor(a, device=dev) for a in
                     page_diff_bounds_inputs(np, rng, case, n, w))
            bits_err(f"diff_encode(bounds=True) {case}",
                     pd.diff_encode(c, t_, bounds=True),
                     pd._diff_encode_plain(c, t_, True))
        home, rows = home_rows(n, w)
        for m in (mask, enc[0]):
            want = pd._diff_apply_plain(twin, m, curr)
            bits_err("diff_apply", [pd.diff_apply(twin, m, curr)], [want])
            got = twin.clone()
            pd.diff_apply_(got, m, curr)
            bits_err("diff_apply_", [got], [want])
            page, ref = twin[-1].clone(), twin[-1].clone()
            pd.diff_apply_(page, m[-1], curr[-1])
            bits_err("diff_apply_ (W,)", [page],
                     [pd._diff_apply_plain_(ref, m[-1], curr[-1])])
            got, ref = home.clone(), home.clone()
            pd.diff_apply_rows_(got, rows, m, curr)
            bits_err("diff_apply_rows_", [got], [
                pd._diff_apply_rows_plain_(ref, rows, m, curr)])
        rebuilt = pd.diff_apply(twin, enc[0], enc[1])
        bits_err("diff round trip", [rebuilt], [curr])
        if (n, w) in ((1, 1024), (4096, 1024)):
            timed[(n, w)] = (curr, twin, mask, home, rows)
    # the C entries called with operands bound once (no checks, no
    # allocation): the events then time the kernel where the wrapper's
    # host cost is below the device time
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in names:
        res = {}
        fn = pd._KERNELS.entry(name)
        for (n, w), (curr, twin, mask, home, rows) in timed.items():
            bmask = mask != 0
            lib, nbytes = None, 13 * n * w
            merged = n * w + 8 * int(bmask.sum())  # the in-place merges
            if name == "diff_encode":
                # the release's form: the change bounds with the count
                kern = lambda c=curr, t=twin: pd.diff_encode(  # noqa
                    c, t, bounds=True)
                plain = lambda c=curr, t=twin: pd._diff_encode_plain(  # noqa
                    c, t, True)
                m_, v_, k_ = pd.diff_encode(curr, twin, bounds=True)
                args = (curr.data_ptr(), twin.data_ptr(), m_.data_ptr(),
                        v_.data_ptr(), k_.data_ptr(), n, w, stream)
                nbytes += 12 * n
            elif name == "diff_apply":
                kern = lambda c=curr, t=twin, m=mask: pd.diff_apply(t, m, c)  # noqa
                plain = lambda c=curr, t=twin, m=mask: (  # noqa
                    pd._diff_apply_plain(t, m, c))
                o_ = torch.empty_like(twin)
                args = (twin.data_ptr(), mask.data_ptr(), curr.data_ptr(),
                        o_.data_ptr(), n * w, stream)
                lib = timed_ms(torch, lambda c=curr, t=twin, b=bmask:
                               torch.where(b, c, t))
            elif name == "diff_apply_":
                d = twin.clone()
                kern = lambda c=curr, d=d, m=mask: pd.diff_apply_(d, m, c)  # noqa
                plain = lambda c=curr, d=d, m=mask: (  # noqa
                    pd._diff_apply_plain_(d, m, c))
                args = (d.data_ptr(), mask.data_ptr(), curr.data_ptr(),
                        n * w, stream)
                lib = timed_ms(torch, lambda c=curr, d=d, b=bmask:
                               torch.where(b, c, d, out=d))
                nbytes = merged
            else:
                kern = lambda c=curr, h=home, r=rows, m=mask: (  # noqa
                    pd.diff_apply_rows_(h, r, m, c))
                plain = lambda c=curr, h=home, r=rows, m=mask: (  # noqa
                    pd._diff_apply_rows_plain_(h, r, m, c))
                args = (home.data_ptr(), rows.data_ptr(), mask.data_ptr(),
                        curr.data_ptr(), n, w, home.shape[0], stream)
                nbytes = merged + 8 * n
            res[(n, w)] = dict(shape=[n, w], ms=timed_ms(torch, kern),
                               c_entry_ms=timed_ms(torch, lambda f=fn, a=args:
                                                   f(*a)),
                               plain_ms=timed_ms(torch, plain, 10),
                               library_ms=lib, bytes=nbytes)
        out[name] = dict(err=errs[name], library=(
            "torch.where" if name in ("diff_apply", "diff_apply_") else None),
                         batched=res[(4096, 1024)], **res[(1, 1024)])
    return out


def rank_entry_calls(torch, ps, live, k):
    """name -> (wrapper call, C entry call) of the three rank-select
    entries on bool ``live`` (R, C) with ranks ``k``: an int32 vector on
    the card, or an int for one row (by value, as the replay passes it).
    The C entry calls hold the tensors behind their pointers."""
    stream = torch.cuda.current_stream().cuda_stream
    R, C = live.shape
    entry = ps._KERNELS.entry
    take = torch.empty((R, C), dtype=torch.bool, device=live.device)
    cut = torch.empty(R, dtype=torch.int64, device=live.device)
    kp, kv = (None, k) if isinstance(k, int) else (k.data_ptr(), 0)
    head = (live.data_ptr(), live.stride(0), R, C, kp, kv)
    tp, cp = take.data_ptr(), cut.data_ptr()
    keep = (live, k, take, cut)
    return {
        "take_first_k": (
            lambda: ps.take_first_k(live, k),
            lambda _=keep: entry("take_first_k")(*head, tp, None, stream)),
        "kth_set_index": (
            lambda: ps.kth_set_index(live, k),
            lambda _=keep: entry("kth_set_index")(*head, cp, None, stream)),
        "take_and_cut": (
            lambda: ps.take_and_cut(live, k),
            lambda _=keep: entry("take_and_cut")(*head, tp, cp, None,
                                                 stream)),
    }


def rank_bytes(name: str, R: int, C: int, vector: bool, packed: bool):
    """Bytes a rank-select entry must move: its rows read once (bool
    cells, or the parent design's packed words), the take written once
    (the same), ranks read (int32 when a vector) and cuts written
    (int64)."""
    row = 4 * -(-C // 32) if packed else C
    take = {"take_first_k": R * row, "kth_set_index": 0,
            "take_and_cut": R * row}[name]
    cut = 0 if name == "take_first_k" else 8 * R
    return R * row + take + cut + (4 * R if vector else 0)


def victim_scan(torch, d, live, k: int):
    """One refetch-replay victim scan as ``_danger_replay`` makes it: the
    host's live mask copied to the card, ``take_upto_row``, the victim
    columns and the cut on the host."""
    return d.take_upto_row(torch.as_tensor(live, device=d.device), k)


def device_activities(torch, fn) -> int:
    """The device activities (kernels, copies, sets) torch.profiler
    records over one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def rank_select_phase(torch, np, ps, dev, scans, same):
    """take_first_k, kth_set_index and take_and_cut, and the one-run
    ``take_run``, against their plain versions on the card, bit for bit,
    over random and edge ranks (k = 0, k < 0, k equal to and past the
    row's count, INT32_MAX; int32 vectors, and ranks by value for one
    row) on bool rows read in place: the lru_take shape of fig4_spill
    (W=256 runs of 32768 columns, one block a row), the spill phase's
    victim-scan runs (``scans``: (run length, k) -> [count, an example
    live mask]), R = 1 / C = 1, ragged last words, rows of one warp and
    of several scan rounds, rows 1 byte off 16-byte boundaries in a
    plane that ends mid-word at its allocation's end, a column window of
    a wider plane and every other row of one.  Timed (wrapper, C entry
    alone, one launch on the device) at the lru_take shape and at the
    commonest (run length, k) of the victim scans, whose scan (the host
    mask to the card, ``take_run``, the one copy back) is also timed
    (host clock) and traced (device activities) on 'fused' and
    'kernels'.  Bytes: the bool rows read once, the take written once,
    ranks read, cuts written; ``packed_bytes`` the same on the parent
    design's packed words."""
    from repro_torch.core.directory import RegionDirectory
    rng = np.random.default_rng(18)
    i32max = np.iinfo(np.int32).max
    def both(live, k):
        return (ps._take_first_k_bool_plain(live, k),
                ps._kth_set_index_bool_plain(live, k))

    calls = {
        "take_first_k": (ps.take_first_k, ps._take_first_k_bool_plain),
        "kth_set_index": (ps.kth_set_index, ps._kth_set_index_bool_plain),
        "take_and_cut": (ps.take_and_cut, both),
    }
    errs = dict.fromkeys(calls, 0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def check(live):
        plane = live.cpu().numpy()
        R_, C_ = plane.shape
        tot = plane.sum(axis=1)
        for k in (rng.integers(0, C_ + 1, R_), np.zeros(R_), np.full(R_, -5),
                  tot, tot + 1, np.maximum(tot - 1, 1), np.full(R_, i32max)):
            k64 = t(np.asarray(k, np.int64))
            for kk in [k64.to(torch.int32)] + ([int(k[0])] if R_ == 1
                                               else []):
                for name, (kern, plain) in calls.items():
                    errs[name] = max(errs[name], same(
                        name, kern(live, kk), plain(live.contiguous(), k64)))
            if R_ == 1:
                for kk in {int(k[0]), 1, int(tot[0])}:
                    for fused in (True, False):
                        got = ps.read_take_run(ps.take_run(live[0], kk,
                                                           fused))
                        want = ps.read_take_run(ps._take_run_plain(
                            live[0].contiguous(), kk))
                        if got[0] != want[0] or not np.array_equal(got[1],
                                                                   want[1]):
                            raise AssertionError(
                                f"take_run (fused={fused}): kernel "
                                f"{got} != plain version {want}")

    def rows(R_, C_):
        live = rng.random((R_, C_)) < rng.random((R_, 1))
        live[0] = True
        if R_ > 2:
            live[-1] = False                           # an empty row
        return t(live)

    lru = rows(W, 32768)
    check(lru)
    for (L, _k), (_n, example) in scans.items():
        check(t(example)[None])
    for R_, C_ in ((1, 1), (1, 32), (3, 31), (5, 1000), (4, 1024),
                   (3, 1025), (2, 256 * 4 * 32 + 8195)):
        check(rows(R_, C_))
    # rows 1 byte off 16-byte boundaries, the plane ending mid-word at the
    # end of its allocation; a column window; every other row
    for R_, C_ in ((W, 16385), (3, 1001), (1, 9)):
        buf = torch.zeros(R_ * C_ + 1, dtype=torch.bool, device=dev)
        shifted = buf[1:].view(R_, C_)
        shifted.copy_(rows(R_, C_))
        check(shifted)
        wide = rows(2 * R_, C_ + 7)
        check(wide[:R_, 3:3 + C_])
        check(wide[::2, 5:5 + C_])
    for w_, a, b in ((0, 3, 10), (1, 17, 1000), (2, 64, 1130)):
        check(lru[w_, a:b][None])

    # timed: the lru_take shape, and the commonest victim scan
    (L, k_run), (n_run, example) = max(scans.items(),
                                       key=lambda kv: kv[1][0])
    run = t(example)[None]
    lru_k = t(rng.integers(0, 32768, W).astype(np.int32))
    timed = {}
    for key, live, k in (("lru", lru, lru_k), ("run", run, k_run)):
        R_, C_ = live.shape
        for name, (wrapper, c_entry) in rank_entry_calls(
                torch, ps, live, k).items():
            kp = (k.to(torch.int64) if isinstance(k, torch.Tensor)
                  else t(np.array([k], np.int64)))
            plain = calls[name][1]
            timed.setdefault(name, {})[key] = dict(
                shape=[R_, C_] + ([f"k={k}"] if key == "run" else []),
                ms=timed_ms(torch, wrapper),
                c_entry_ms=timed_ms(torch, c_entry),
                profiled_ms=profiled_ms(torch, c_entry,
                                        "rank_select_kernel"),
                plain_ms=timed_ms(torch, lambda: plain(live, kp), 10, 3),
                bytes=rank_bytes(name, R_, C_, key == "lru", False),
                packed_bytes=rank_bytes(name, R_, C_, key == "lru", True))
    nz = np.flatnonzero(example)
    scan = {"run": [L, k_run], "scans": n_run}
    for backend in ("fused", "kernels"):
        d = RegionDirectory(1, 0, 0, 64, backend=backend, device=dev)
        cols, cut = victim_scan(torch, d, example, k_run)
        if not np.array_equal(cols, nz[:k_run]) or cut != nz[k_run - 1] + 1:
            raise AssertionError(f"victim scan [{backend}]: ({cols}, {cut})"
                                 f" != ({nz[:k_run]}, {nz[k_run - 1] + 1})")
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(200):
                victim_scan(torch, d, example, k_run)
            walls.append((time.perf_counter() - t0) / 200 * 1e3)
        # three traces of 10 scans each: one trace in a run on the card
        # recorded none of a single scan's activities
        traced = [device_activities(torch, lambda: [
            victim_scan(torch, d, example, k_run) for _ in range(10)]) / 10
            for _ in range(3)]
        scan[backend] = dict(wall_ms=statistics.median(walls),
                             device_activities=statistics.median(traced),
                             traced=traced)
        print(f"victim scan [{backend:7s}] run of {L} columns, k={k_run} "
              f"({n_run} of the spill phase's scans): wall "
              f"{scan[backend]['wall_ms'] * 1e3:.2f} us, "
              f"{scan[backend]['device_activities']} device activities a "
              f"scan (three traces of 10 scans: {traced})", flush=True)
    return {name: dict(err=errs[name], library_ms=None, lru=r["lru"],
                       victim_scan=scan, **r["run"])
            for name, r in timed.items()}


def flash_inputs(torch, np, rng, B, Hq, Hkv, S, D, dtype, dev):
    """q (B, Hq, S, D), k and v (B, Hkv, S, D): N(0, 0.25) values made in
    float32 and rounded once to ``dtype``, as tests/test_kernels.py."""
    return [torch.as_tensor(rng.standard_normal(shape) * 0.5,
                            dtype=torch.float32, device=dev).to(dtype)
            for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


def ssd_inputs(torch, np, rng, M, Q, P, N, rep, dtype, dev):
    """x (M, Q, P), dt and cum (M, Q, 1) float32, B and C (M // rep, Q, N),
    as tests/test_kernels.py makes them: dt = softplus(normal), cum the
    running sum of -softplus(normal), B and C at 0.3 scale."""
    def sp(a):
        return np.log1p(np.exp(a))

    def t(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).to(dt)
    return (t(rng.standard_normal((M, Q, P)), dtype),
            t(sp(rng.standard_normal((M, Q, 1)))),
            t(np.cumsum(-sp(rng.standard_normal((M, Q, 1))), axis=1)),
            t(rng.standard_normal((M // rep, Q, N)) * 0.3, dtype),
            t(rng.standard_normal((M // rep, Q, N)) * 0.3, dtype))


def flash_work(B, Hq, S, D, itemsize, Hkv):
    """(flops, bytes) causal flash_attention needs: 4 D flops per unmasked
    (query, key) pair, S(S+1)/2 of them, in each of the B*Hq heads (q.k and
    p.v; the softmax's few operations a pair are not counted), q, k and v
    read once and the output written once.  The flops go over
    BF16_FLOPS_PER_S in bfloat16 and TF32_SPLIT_FLOPS_PER_S in float32,
    which the kernel takes as three TF32 tensor-core products."""
    pairs = S * (S + 1) // 2
    return (4 * D * pairs * B * Hq,
            itemsize * (2 * B * Hq * S * D + 2 * B * Hkv * S * D))


def ssd_work(M, Q, P, N, rep, itemsize):
    """(flops, bytes) ssd_chunk needs: C.B^T over the Q(Q+1)/2 causal
    pairs (2N flops each) once per B/C group, i.e. for M // rep of the
    cells (the rep heads of a group share it, as the reference's
    ssd_chunked forms it once per group); per cell the scores times x
    (2P a pair) and the (P, N) state over Q rows (2PN each); x, B and C
    read once (B and C one row per group of ``rep`` cells), dt and cum in
    float32, y and the state written once in float32.  The flops go over
    TF32_SPLIT_FLOPS_PER_S: the kernel keeps f32 accuracy with three TF32
    tensor-core products per product."""
    pairs = Q * (Q + 1) // 2
    flops = ((M // rep) * pairs * 2 * N
             + M * (pairs * 2 * P + 2 * Q * P * N))
    return flops, (itemsize * (M * Q * P + 2 * (M // rep) * Q * N)
                   + 4 * (2 * M * Q + M * Q * P + M * P * N))


def model_kernel_phase(torch, np, dev):
    """flash_attention and ssd_chunk against their plain versions on the
    card, absolute and relative: attention in float32 within 2e-5 and SSD
    within 1e-4, as in tests/test_kernels.py; attention in bfloat16 within
    rtol 8e-3 / atol 2e-3 (both sides sum in float32 from the same
    bfloat16 inputs, the kernel with p kept to 16 bits, and round once to
    bfloat16, so they differ by the float32 reordering and at most one
    bfloat16 ulp, 2^-7 of the value):
    attention at the internlm2-1.8b prefill shape (B=4, Hq=16,
    Hkv=8, S=512, D=128) in float32 and bfloat16, at a ragged S=333, with
    window 64 and softcap 50, with MQA (Hkv=1) and at the reduced shape
    (D=16, window 16, softcap 30); SSD at the mamba2-2.7b shape (M=640
    cells = 4 rows x 2 chunks x 80 heads, Q=256, P=64, N=128) with one B/C
    row per 80 heads as the model passes it, the same per cell, in
    bfloat16, and at the reduced Q=32, P=16, N=16; attention also at the
    prefill shapes of the MoE, M-RoPE and embeds models
    (``FLASH_MODEL_SHAPES``), at the train phase's shape
    (``FLASH_TRAIN_SHAPE``, float32, S = 4096), at the regc phase's
    two (``FLASH_REGC_SHAPES``, float32, S = 2048) and at a rank's of the
    tp phase (``FLASH_TP_SHAPES``, float32, S = 1024) and at a rank's of
    the serve-tp phase (``FLASH_SERVE_TP_SHAPES``, float32, S = 496; SSD
    at ``SSD_SERVE_TP_SHAPE``, also the sp phase's) and at a rank's of
    the sp phase (``FLASH_SP_SHAPES``, float32, S = 1024).  Timed at the
    first
    shapes (and in bfloat16, per cell, and at each model, train and regc
    shape); the library yardstick of
    attention is scaled_dot_product_attention (timed, used nowhere in the
    port); SSD has none."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    rng = np.random.default_rng(2024)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("internlm2 prefill", (4, 16, 8, 512, 128), f32, {}),
             ("internlm2 prefill bf16", (4, 16, 8, 512, 128), bf16, {}),
             ("ragged S=333", (4, 16, 8, 333, 128), f32, {}),
             ("window 64 softcap 50", (4, 16, 8, 512, 128), f32,
              {"window": 64, "softcap": 50.0}),
             ("MQA", (4, 16, 1, 512, 128), f32, {}),
             ("reduced D=16", (4, 4, 2, 40, 16), f32,
              {"window": 16, "softcap": 30.0})]
    model_cases = [(f"{arch} prefill", shape)
                   for arch, shape in FLASH_MODEL_SHAPES] + [
                       FLASH_TRAIN_SHAPE, *FLASH_REGC_SHAPES,
                       *FLASH_TP_SHAPES, *FLASH_SERVE_TP_SHAPES,
                       *FLASH_SP_SHAPES]
    cases += [(label, shape, f32, {}) for label, shape in model_cases]
    errs, timed = [], {}
    for label, (B, Hq, Hkv, S, D), dtype, kw in cases:
        q, k, v = flash_inputs(torch, np, rng, B, Hq, Hkv, S, D, dtype, dev)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        rtol, atol = (8e-3, 2e-3) if dtype == bf16 else (2e-5, 2e-5)
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=rtol,
                              atol=atol):
            raise AssertionError(f"flash_attention {label}: kernel != plain "
                                 f"version (max abs err {err}, rtol {rtol}, "
                                 f"atol {atol})")
        print(f"kernel flash_attention {label:22s} {(B, Hq, Hkv, S, D)} "
              f"{dtype} {kw}: max_abs_err {err:.3e} (rtol {rtol}, atol "
              f"{atol})", flush=True)
        errs.append({"case": label, "max_abs_err": err, "rtol": rtol,
                     "atol": atol})
        if label.startswith("internlm2 prefill"):
            timed[dtype] = (q, k, v)
        elif label in dict(model_cases):
            timed[label] = (q, k, v)
    out = {}
    for key, (q, k, v) in timed.items():
        dtype = q.dtype
        B, Hq, S, D = q.shape
        flops, nbytes = flash_work(B, Hq, S, D, q.element_size(), k.shape[1])
        out[key] = dict(
            shape=[B, Hq, k.shape[1], S, D, str(dtype)],
            ms=timed_ms(torch, lambda: fa.flash_attention(q, k, v), 20),
            plain_ms=timed_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v), 5, 3),
            library_ms=timed_ms(torch, lambda: (
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=D ** -0.5,
                    enable_gqa=True)), 20),
            flops=flops, bytes=nbytes, flops_per_s=(
                BF16_FLOPS_PER_S if dtype == bf16
                else TF32_SPLIT_FLOPS_PER_S))
    results = {"flash_attention": dict(
        err=max(e["max_abs_err"] for e in errs), cases=errs,
        library="scaled_dot_product_attention", bf16=out.pop(bf16),
        models=[dict(out[label], case=label) for label, _ in model_cases],
        **out.pop(f32))}

    cases = [("mamba2 prefill, grouped B/C", (640, 256, 64, 128, 80), f32),
             ("mamba2 prefill, per-cell B/C", (640, 256, 64, 128, 1), f32),
             ("mamba2 prefill bf16", (640, 256, 64, 128, 80), bf16),
             ("reduced", (32, 32, 16, 16, 8), f32),
             ("ragged Q=100", (6, 100, 64, 128, 2), f32),
             (SSD_SERVE_TP_SHAPE[0], SSD_SERVE_TP_SHAPE[1], f32)]
    errs, timed = [], {}
    for label, (M, Q, P, N, rep), dtype in cases:
        args = ssd_inputs(torch, np, rng, M, Q, P, N, rep, dtype, dev)
        got, want = sc.ssd_chunk(*args), sc.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                   for g, w in zip(got, want)):
            raise AssertionError(f"ssd_chunk {label}: kernel != plain "
                                 f"version (max abs err {err}, tol 1e-4)")
        print(f"kernel ssd_chunk {label:30s} {(M, Q, P, N, rep)} {dtype}: "
              f"max_abs_err {err:.3e} (tol 1e-4)", flush=True)
        errs.append({"case": label, "max_abs_err": err, "tol": 1e-4})
        if label.startswith("mamba2 prefill,") or label == \
                SSD_SERVE_TP_SHAPE[0]:
            timed[rep] = args
    out = {}
    for rep, args in timed.items():
        M, Q, P = args[0].shape
        N = args[3].shape[2]
        flops, nbytes = ssd_work(M, Q, P, N, rep, 4)
        out[rep] = dict(
            shape=[M, Q, P, N, rep], ms=timed_ms(
                torch, lambda a=args: sc.ssd_chunk(*a), 20),
            plain_ms=timed_ms(torch, lambda a=args: sc.ssd_chunk_plain(*a),
                              5, 3),
            library_ms=None, flops=flops, bytes=nbytes,
            flops_per_s=TF32_SPLIT_FLOPS_PER_S)
    results["ssd_chunk"] = dict(
        err=max(e["max_abs_err"] for e in errs), cases=errs,
        per_cell=out[1], models=[dict(out[SSD_SERVE_TP_SHAPE[1][4]],
                                      case=SSD_SERVE_TP_SHAPE[0])],
        **out[80])
    return results


# ---------------------------------------------------------------------------
# model phase
# ---------------------------------------------------------------------------


def compare_routes(torch, got, want, first, p0, margin):
    """Hold one forward pass's MoE routing ``got`` against ``want``: lists
    of ``models.layers.ROUTES`` entries, one per MoE layer in order, over
    B rows of S tokens at positions p0.. (S = T // B, B = len(first)).

    ``first`` (a list, updated in place) holds each row's first position
    whose outputs may differ between the two runs: a token whose route
    differs changes its own output and, through attention or the SSD
    state, every later position of its row in the later layers.  A token
    before it (clean) must route the same (the same top-k set) unless it
    is a near tie, the K-th and (K+1)-th of ``want``'s probabilities
    within ``margin`` (a difference of the float32 sums on the two sides
    then picks either); and must keep the same choices (not dropped at
    capacity) unless some token of the layer routed differently (it shifts
    the stable order behind it).  A route or kept-set difference taints
    its row from its position on.  Raises ``AssertionError`` otherwise.
    Returns counts: ``near_ties`` (clean tokens routed differently),
    ``downstream`` (tainted tokens routed differently), ``dropped_differ``
    (clean tokens kept differently), ``max_prob_err`` (of clean tokens
    routed the same) and ``max_tie_gap``."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} MoE calls against {len(want)}")
    B = len(first)
    out = dict(near_ties=0, downstream=0, dropped_differ=0,
               max_prob_err=0.0, max_tie_gap=0.0)
    for layer, (g, w) in enumerate(zip(got, want)):
        ge, we = g["top_e"].cpu().long(), w["top_e"].cpu().long()
        T, K = we.shape
        S = T // B
        pos = p0 + torch.arange(S)
        clean = (pos[None, :] < torch.as_tensor(first)[:, None]).reshape(T)
        diff = (ge.sort(-1).values != we.sort(-1).values).any(-1)
        wp = w["probs"].cpu().float()
        E = wp.shape[-1]
        top = wp.topk(min(K + 1, E), dim=-1).values
        gap = (top[:, K - 1] - top[:, K] if K < E
               else torch.full((T,), float("inf")))
        bad = diff & clean & (gap > margin)
        if bad.any():
            t = int(bad.nonzero()[0])
            raise AssertionError(
                f"MoE layer {layer}: token {t} (row {t // S}, position "
                f"{p0 + t % S}) routes to {ge[t].tolist()} against "
                f"{we[t].tolist()} with a gap of {float(gap[t]):.3e} between "
                f"its K-th and (K+1)-th probabilities (margin {margin})")
        tied = diff & clean
        out["near_ties"] += int(tied.sum())
        out["downstream"] += int((diff & ~clean).sum())
        if tied.any():
            out["max_tie_gap"] = max(out["max_tie_gap"],
                                     float(gap[tied].max()))
        same = clean & ~diff
        if same.any():
            out["max_prob_err"] = max(out["max_prob_err"], float(
                (g["probs"].cpu().float() - wp)[same].abs().max()))
        gk = torch.where(g["keep"].cpu(), ge, -1).sort(-1).values
        wk = torch.where(w["keep"].cpu(), we, -1).sort(-1).values
        kdiff = (gk != wk).any(-1) & ~diff
        if (kdiff & clean).any() and not diff.any():
            raise AssertionError(f"MoE layer {layer}: tokens "
                                 f"{(kdiff & clean).nonzero()[:, 0].tolist()}"
                                 " kept other choices with no route "
                                 "difference in the layer")
        out["dropped_differ"] += int((kdiff & clean).sum())
        src = (diff | kdiff).reshape(B, S)
        for b in range(B):
            hit = src[b].nonzero()
            if len(hit):
                first[b] = min(first[b], p0 + int(hit[0]))
    return out


# the model phase's full-width runs: (arch, depth, the CPU twin's depth);
# depth None is the config's own.  moonshot-v1-16b-a3b keeps 24 of its 48
# layers and qwen2-vl-72b 8 of its 80 (float32 at full depth, 112 GB and
# 291 GB, would not fit the card's 80 GB); widths are the published ones.
# The twins keep 1 layer (2 until the serve-tp phase needed the time:
# the CPU side of qwen2-vl's 2-layer twin alone took 48 s)
MODEL_RUNS = (("internlm2-1.8b", None, 1), ("mamba2-2.7b", None, 1),
              ("moonshot-v1-16b-a3b", 24, 1), ("qwen2-vl-72b", 8, 1),
              ("musicgen-medium", None, 1))
# archs that fit no card at full width (a jamba super-block alone holds four
# MoE layers of 9.66 B parameters): their reduced configs, card against CPU
REDUCED_RUNS = ("grok-1-314b", "jamba-1.5-large-398b")
# near-tie margin of MoE routing between the card and the CPU (router
# probabilities; compare_routes), and the logits' tolerance
ROUTE_MARGIN = 1e-4
TWIN_TOL = 1e-3


def mrope_positions(np, B, S):
    """(3, B, S) int32 M-RoPE positions of a prompt that holds an image:
    4 text positions, the same on the temporal, height and width axes,
    then the image's patches row by row on a grid 8 wide, the temporal
    axis held at 4 and the height and width axes counting rows and
    columns from it, as Qwen2-VL numbers them.  With distinct axes each
    section of the rotary frequencies turns by its own position (equal
    axes would make M-RoPE plain RoPE)."""
    n = min(S, 4)
    i = np.arange(S - n)
    t = np.r_[np.arange(n), np.full(i.size, n)]
    h = np.r_[np.arange(n), n + i // 8]
    w = np.r_[np.arange(n), n + i % 8]
    grid = np.stack([t, h, w]).astype(np.int32)[:, None]
    return np.broadcast_to(grid, (3, B, S)).copy()


def prompt_of(np, cfg, toks, rng):
    """The prompt batch of a (B, S) token wave: the tokens, or in an
    ``embeds`` config N(0, 1) float32 embeddings of its shape drawn from
    ``rng`` (as tests/test_system.py draws them); under M-RoPE also
    ``mrope_positions``, text then an image grid."""
    B, S = toks.shape
    if cfg.input_mode == "embeds":
        p = {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                           dtype=np.float32)}
    else:
        p = {"tokens": toks}
    if cfg.mrope:
        p["positions"] = mrope_positions(np, B, S)
    return p


def model_prompts(np, cfg, requests, batch: int):
    """Each wave's prompt batch (``prompt_of`` of ``launch.serve.waves``;
    embeddings from numpy seed 0)."""
    from repro_torch.launch.serve import waves
    rng = np.random.default_rng(0)
    return [prompt_of(np, cfg, toks, rng) for toks in waves(requests, batch)]


def serve_model(torch, cfg, params, requests, prompts, batch, max_new):
    """Serve a model's requests on the card: ``launch.serve.serve`` for a
    token config, ``serve.decode.generate`` wave by wave on the prompt
    embeddings for an ``embeds`` one (the server answers token prompts
    only).  Returns each wave's tokens and walls, as ``serve``."""
    from repro_torch.launch.serve import serve
    from repro_torch.serve.decode import generate
    if cfg.input_mode == "tokens":
        return serve(cfg, params, requests, batch=batch, max_new=max_new,
                     device="cuda")
    tokens, walls = [], []
    for prompt in prompts:
        w = {"prompt_len": prompt["embeds"].shape[1]}
        t0 = time.perf_counter()
        out = generate(cfg, params, prompt, max_new_tokens=max_new,
                       device="cuda", walls=w)
        tokens.append(out.cpu().numpy())
        w["wall_s"] = time.perf_counter() - t0
        walls.append(w)
    return tokens, walls


def layer_counts(cfg) -> dict:
    """Launches one prefill makes: flash_attention once per attention
    layer, ssd_chunk once per SSD layer."""
    kinds = [spec.kind for spec in cfg.pattern] * cfg.n_superblocks
    return {"flash_attention": kinds.count("attn"),
            "ssd_chunk": kinds.count("ssm")}


def to_device(params, device):
    return {k: ([{n: t.to(device) for n, t in b.items()} for b in v]
                if k == "blocks" else v.to(device))
            for k, v in params.items()}


def step_logits(torch, cfg, params, prompt, forced, device, routes=None):
    """Every step's logits of one wave through the serving steps a user
    calls (``make_prefill_step``, then ``make_serve_step`` on the decode
    batches ``generate`` builds), the decode fed the tokens ``forced``
    (B, T) instead of its own argmax (teacher forcing, so a near tie
    cannot change what follows): (T, B, V) float32 on the host.
    ``prompt`` is a (B, S) token array or a prompt batch.  Float32
    caches, as ``generate``.  ``routes``, when a list, receives each
    pass's MoE routing (the pass's ``models.layers.ROUTES`` on the
    host)."""
    from repro_torch.models import layers
    from repro_torch.serve.decode import (make_prefill_step,
                                          make_serve_step, prompt_len,
                                          step_batch)
    if not isinstance(prompt, dict):
        prompt = {"tokens": prompt}
    batch = {k: torch.as_tensor(v, device=device) for k, v in prompt.items()}
    S, T = prompt_len(batch), forced.shape[1]

    def logged(fn, *args):
        if routes is None:
            return fn(*args)
        layers.ROUTES = []
        try:
            out = fn(*args)
            routes.append([{k: v.cpu() for k, v in r.items()}
                           for r in layers.ROUTES])
        finally:
            layers.ROUTES = None
        return out

    logits, caches = logged(make_prefill_step(
        cfg, max_len=S + T, cache_dtype=torch.float32), params, batch)
    out = [logits.cpu()]
    step = make_serve_step(cfg)
    f = torch.as_tensor(forced, device=device)
    for i in range(T - 1):
        _, logits, caches = logged(step, params, step_batch(
            cfg, params, f[:, i], S + i), caches, S + i)
        out.append(logits.cpu())
    return torch.stack(out)


def twin_compare(torch, np, cfg, card_params, cpu_params, prompts, tokens,
                 tol=TWIN_TOL, margin=ROUTE_MARGIN):
    """The card against the CPU on the same parameters: each wave's step
    logits on the card (their argmax the card's served ``tokens``) and on
    the CPU (plain kernel versions), both teacher-forced with the card's
    tokens.  MoE routing first, pass by pass (``compare_routes``): a
    token may route differently only at a near tie (router probabilities'
    K-th and (K+1)-th within ``margin``, ten times the largest probability
    difference of the tokens that route the same, which this checks), and
    the logits of a position at or after a route difference in its row
    are not compared.  The rest: logits within ``tol`` (absolute and
    relative), the CPU's greedy token the card's except where the CPU's
    top two logits lie within ``tol`` (counted as near ties).  Returns
    (the largest logit difference, near-tie tokens, route counts)."""
    from repro_torch.serve.decode import prompt_len
    err, ties = 0.0, 0
    counts = dict(near_ties=0, downstream=0, dropped_differ=0,
                  max_prob_err=0.0, max_tie_gap=0.0, skipped_logits=0)
    for prompt, toks in zip(prompts, tokens):
        card_routes, cpu_routes = [], []
        card = step_logits(torch, cfg, card_params, prompt, toks, "cuda",
                           card_routes)
        if not np.array_equal(card.argmax(-1).T.numpy(), toks):
            raise AssertionError(f"{cfg.name}: the serving steps' tokens "
                                 "differ from the served ones")
        cpu = step_logits(torch, cfg, cpu_params, prompt, toks, "cpu",
                          cpu_routes)
        B, S = toks.shape[0], prompt_len(prompt)
        first = [1 << 62] * B
        for i, (g, w) in enumerate(zip(card_routes, cpu_routes)):
            c = compare_routes(torch, g, w, first, 0 if i == 0 else S + i - 1,
                               margin)
            for k, v in c.items():
                counts[k] = (max(counts[k], v) if k.startswith("max")
                             else counts[k] + v)
        pos = S - 1 + torch.arange(card.shape[0])
        clean = pos[:, None] < torch.as_tensor(first)[None, :]     # (T, B)
        counts["skipped_logits"] += int((~clean).sum())
        if clean.any():
            err = max(err, float((card - cpu)[clean].abs().max()))
        if not torch.allclose(card[clean], cpu[clean], rtol=tol, atol=tol):
            raise AssertionError(f"{cfg.name}: card logits differ from the "
                                 f"CPU's (max abs err {err}, tol {tol})")
        top2 = cpu.topk(2, dim=-1).values
        tied = (top2[..., 0] - top2[..., 1]) <= tol
        differ = (cpu.argmax(-1) != torch.as_tensor(toks).T) & clean
        if (differ & ~tied).any():
            raise AssertionError(f"{cfg.name}: greedy tokens differ from the "
                                 "CPU's away from a near tie")
        ties += int(differ.sum())
    if counts["max_prob_err"] > margin / 10:
        raise AssertionError(f"{cfg.name}: router probabilities differ by "
                             f"{counts['max_prob_err']:.3e} between the card "
                             f"and the CPU, over a tenth of the near-tie "
                             f"margin {margin}")
    return err, ties, counts


def trace_generate(torch, cfg, params, prompt, max_new):
    """One traced ``generate`` of ``prompt`` (a wave's prompt batch) on
    the card (outside the counted serve run): its wall, the device busy
    share (the union of the intervals of every device activity
    torch.profiler records) and the device time by kernel name, largest
    first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.decode import generate, prompt_len
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(cfg, params, prompt, max_new_tokens=max_new,
                 device="cuda", walls=walls)
        wall = time.perf_counter() - t0
    # the raw trace's device events (ns), as ``traced`` reads them:
    # ``prof.events()`` would first build the event tree of every host op
    # (16-47 s a wave on an H100 80GB HBM3 at 700 W, against a 1-3 s
    # traced wall)
    acts = [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()]
    if not acts:
        print(f"trace {cfg.name}: torch.profiler recorded no device "
              "activity; busy share not measured", flush=True)
        return {"traced_wall_s": wall, "device_busy_s": None}
    by_name = {}
    for name, a, b in acts:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    busy, end = 0.0, float("-inf")
    for a, b in sorted((a, b) for _, a, b in acts):
        busy += max(0.0, b - max(a, end)) * 1e-9
        end = max(end, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the port's own kernels are reported whatever their rank
    top += [(n, t) for n, t in by_name.items()
            if ("flash_kernel" in n or "ssd_chunk_kernel" in n)
            and (n, t) not in top]
    print(f"trace {cfg.name} one wave (prompt {prompt_len(prompt)}, "
          f"{max_new} tokens): traced wall {wall:.3f} s (prefill "
          f"{walls['prefill_s']:.3f} s, decode {walls['decode_s']:.3f} s), "
          f"device busy {busy:.3f} s, "
          f"idle share {1 - busy / wall:.4f}, {len(acts)} device "
          "activities; device seconds by kernel: "
          + "; ".join(f"{n[:60]} {t:.4f}" for n, t in top), flush=True)
    return {"traced_wall_s": wall, "walls": walls, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "device_activities": len(acts),
            "device_s_by_kernel": dict(top)}


def model_phase(torch, np):
    """The model serving path (slices M and H) on the card.

    (a) Each of ``runs`` in turn (one resident at a time) at full width,
    at its stated depth (internlm2-1.8b, mamba2-2.7b and musicgen-medium
    full; moonshot-v1-16b-a3b 24 of 48 layers, qwen2-vl-72b 8 of 80),
    float32 parameters drawn on the card from a torch.Generator seeded 0,
    answers 8 requests made as the reference's server makes them (seed 0,
    prompt lengths in [4, 512), max_new 16) in waves of 4: token configs
    through ``launch.serve.serve``, the ``embeds`` configs (musicgen,
    qwen2-vl) through ``generate`` on N(0, 1) prompt embeddings of the
    same wave shapes (``model_prompts``; qwen2-vl's M-RoPE positions
    text then an image grid, ``mrope_positions``).  The launch counters
    are set to 0 just before and read just after: flash_attention must
    launch once per attention layer per wave and ssd_chunk once per SSD
    layer per wave, decode launching neither.
    Every token lies in the vocabulary; the serving steps, teacher-forced
    with the served tokens, give finite logits whose argmax is the served
    token.  Then the same model with depth cut to 1 layer (width and
    every other setting full), parameters drawn on the card from seed 0
    and copied to the CPU: served on the card, then held against the CPU
    on its first wave by ``twin_compare`` (logits within 1e-3: float32
    sums of up to 29568
    terms in another order on each side, through two layers and the LM
    head; MoE routes equal but for near ties).
    (b) Each of ``reduced`` (grok-1-314b; jamba-1.5-large-398b, where MoE
    layers sit beside SSD layers) at its reduced config, all layers: the
    same serve run, launch and token checks on the card, then the same
    parameters held against the CPU by ``twin_compare``.
    Returns (rows, the model path's launches)."""
    import dataclasses as dc
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.model import init_model_params
    n_req, batch, max_len, max_new = 8, 4, 528, 16
    counters = {"flash_attention": fa, "ssd_chunk": sc}
    rows, launches = [], dict.fromkeys(counters, 0)
    plan = ([(get_config(a), depth, twin) for a, depth, twin in MODEL_RUNS]
            + [(get_reduced(a), None, None) for a in REDUCED_RUNS])
    for full, depth, twin_depth in plan:
        cfg = full if depth is None else dc.replace(full, n_layers=depth)
        arch = cfg.name
        requests = make_requests(cfg.vocab_size, n_req, max_len, max_new, 0)
        prompts = model_prompts(np, cfg, requests, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_model_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        for mod in counters.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        tokens, walls = serve_model(torch, cfg, params, requests, prompts,
                                    batch, max_new)
        serve_s = time.perf_counter() - t0
        launched = {k: m.LAUNCHES[k] for k, m in counters.items()}
        want = {k: n * len(prompts) for k, n in layer_counts(cfg).items()}
        if launched != want:
            raise AssertionError(f"{arch}: launches {launched}, expected "
                                 f"{want}")
        for k in launches:
            launches[k] += launched[k]
        peak = torch.cuda.max_memory_allocated()
        for prompt, toks in zip(prompts, tokens):
            if toks.min() < 0 or toks.max() >= cfg.vocab_size:
                raise AssertionError(f"{arch}: token out of range")
            lg = step_logits(torch, cfg, params, prompt, toks, "cuda")
            if not torch.isfinite(lg).all():
                raise AssertionError(f"{arch}: non-finite logits")
            if not np.array_equal(lg.argmax(-1).T.numpy(), toks):
                raise AssertionError(f"{arch}: the serving steps' greedy "
                                     "tokens differ from the served ones")
        prefill = [w["prefill_s"] for w in walls]
        per_tok = [w["decode_s"] / (max_new - 1) for w in walls]
        tok_s = n_req * max_new / sum(w["wall_s"] for w in walls)
        row = {"arch": arch, "depth": cfg.n_layers,
               "full_depth": full.n_layers, "width": cfg.d_model,
               "params": cfg.param_count(), "init_s": init_s,
               "serve_s": serve_s, "walls": walls, "tokens_per_s": tok_s,
               "max_memory_allocated": peak, "launches": launched,
               "sample": tokens[0][0, :8].tolist()}
        print(f"model {arch} width {cfg.d_model}, {cfg.n_layers} of "
              f"{full.n_layers} layers ({cfg.param_count()} params, f32): "
              f"init {init_s:.3f} s, serve {serve_s:.3f} s; prefill wall "
              f"per wave {[round(x, 4) for x in prefill]} s at prompt "
              f"lengths {[w['prompt_len'] for w in walls]}; decode wall per "
              f"token {[round(x * 1e3, 3) for x in per_tok]} ms (the f32 "
              f"weights read once at the HBM rate: "
              f"{cfg.param_count() * 4 / HBM_BYTES_PER_S * 1e3:.3f} ms); "
              f"{tok_s:.2f} tokens/s; peak device memory {peak} B; "
              f"launches {launched}", flush=True)
        if twin_depth is not None:
            row["trace"] = trace_generate(torch, cfg, params, prompts[0],
                                          max_new)
            del params
            torch.cuda.empty_cache()
            cfg = dc.replace(full, n_layers=twin_depth)
            params = init_model_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
            tokens, _ = serve_model(torch, cfg, params, requests, prompts,
                                    batch, max_new)
        t0 = time.perf_counter()
        cpu_params = to_device(params, "cpu")
        # a full-width twin against the CPU on its first wave: the second
        # repeats the mechanism and doubled the CPU's share of the phase
        n_cmp = 1 if twin_depth is not None else len(prompts)
        err, ties, routes = twin_compare(torch, np, cfg, params, cpu_params,
                                         prompts[:n_cmp], tokens[:n_cmp])
        twin_s = time.perf_counter() - t0
        print(f"model {arch} width {cfg.d_model}, {cfg.n_layers} layers: "
              f"card vs CPU logits max abs err {err:.3e} (tol {TWIN_TOL}), "
              f"greedy tokens equal ({ties} near-tie differences); MoE "
              f"routes {routes} (margin {ROUTE_MARGIN}); {twin_s:.1f} s",
              flush=True)
        row.update(twin_depth=cfg.n_layers, twin_max_abs_err=err,
                   twin_tol=TWIN_TOL, twin_near_ties=ties, twin_routes=routes,
                   route_margin=ROUTE_MARGIN, twin_s=twin_s)
        rows.append(row)
        del params, cpu_params
        torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

# (a): internlm2-1.8b at full width and depth, the train_4k shape's
# sequence (4096) with its global batch of 256 cut to 2, four steps of
# AdamW under remat "full"
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 4
# (b): the full-width 2-layer twin on one batch of 1 x 512 tokens; its
# tolerances: loss absolute, grad norm relative, each gradient leaf
# relative to its largest |value|, the card's AdamW update on the CPU's
# gradients against the CPU's update (absolute on parameters, relative
# to the leaf's largest |value| on the moments)
TWIN_LAYERS, TWIN_SEQ = 2, 512
TRAIN_LOSS_TOL = 1e-4
TRAIN_NORM_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_OPT_TOL = 1e-6
# (c): the Trainer at tests/test_trainer.py's settings, 8 steps,
# checkpoints every 4, a failure injected at step 6
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_FAIL_AT = 8, 4, 6


def kernel_counters():
    """Every kernel module of the port, by name (their LAUNCHES merged)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_diff as pd
    from repro_torch.kernels import protocol_sweep as ps
    from repro_torch.kernels import ssd_chunk as sc
    return (ps, pd, fa, sc)


def reset_counters():
    for mod in kernel_counters():
        mod.reset_launches()


def read_counters() -> dict:
    out = {}
    for mod in kernel_counters():
        out.update(mod.LAUNCHES)
    return out


def train_batch(np, cfg, B, S, step=0, seed=0):
    """The synthetic stream's batch ``step`` (``data.SyntheticTokens``):
    tokens and targets, plus N(0, 1) embeddings in an ``embeds`` config and
    (3, B, S) positions under M-RoPE."""
    from repro_torch.data import SyntheticTokens
    batch = SyntheticTokens(cfg.vocab_size, S, B, seed).batch_at(step)
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        del batch["tokens"]
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope:
        batch["positions"] = mrope_positions(np, B, S)
    return batch


def train_twin(torch, np, cfg, card_params, batch, hp,
               margin=ROUTE_MARGIN, device="cuda"):
    """One train step of ``cfg`` from ``card_params`` on ``batch`` (numpy)
    on the card, against the CPU on the same parameters.

    The card runs ``make_train_step`` from zero AdamW moments; both sides
    then run the step's two halves, ``value_and_grad`` of the loss (MoE routes logged and
    held to each other first, ``compare_routes``) and ``adamw_update``.
    Checks: the card's step equal to its own two halves; loss within
    ``TRAIN_LOSS_TOL``, grad norm within ``TRAIN_NORM_RTOL``, every
    gradient leaf within ``TRAIN_GRAD_TOL`` of its largest |value|; and
    the card's ``adamw_update`` of the CPU's gradients against the CPU's
    own: parameters within ``TRAIN_OPT_TOL``, moments within it relative
    to the leaf's largest |value| (this keeps the optimiser's exactness
    apart from the gradients' summation order: a first Adam step is about
    lr * sign(g), which noise in a tiny gradient would flip).  Returns a
    row of the errors, the route counts, the launches of the card's step
    (``step_launches``) and those of the step and its halves on the card
    together (``launches``: the halves run the same forward and remat
    again).  ``device``
    names the card's side (``"cpu"`` rehearses the function on the CPU,
    against itself)."""
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.train.train_step import make_train_step, value_and_grad
    from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map
    cpu_params = tree_map(lambda t: t.cpu(), card_params)
    sides = {"card": card_params, "cpu": cpu_params}
    batches = {side: {k: torch.as_tensor(v, device=p["embed"].device)
                      for k, v in batch.items()} for side, p in sides.items()}
    opts = {side: init_opt_state(p) for side, p in sides.items()}
    reset_counters()
    stepped, _, step_m = make_train_step(cfg, hp)(
        card_params, opts["card"], batches["card"], 0)
    sync(torch, device)
    launched = read_counters()
    lr = float(step_m["lr"])

    def loss_f(p, b):
        return M.loss_fn(cfg, p, b, attn_impl=hp.attn_impl, remat=hp.remat,
                         ce_chunk=hp.ce_chunk,
                         remat_segment=hp.remat_segment)
    out, routes = {}, {}
    reset_counters()
    for side, p in sides.items():
        layers.ROUTES = []
        try:
            (loss, _), grads = value_and_grad(loss_f, p, batches[side])
            routes[side] = [{k: v.detach().cpu() for k, v in r.items()}
                            for r in layers.ROUTES]
        finally:
            layers.ROUTES = None
        out[side] = (loss, grads, adamw_update(p, grads, opts[side], 0, lr,
                                               hp.adamw))
    sync(torch, device)
    halves = read_counters()
    first = [1 << 62] * batch["targets"].shape[0]
    route_counts = compare_routes(torch, routes["card"], routes["cpu"],
                                  first, 0, margin)
    if route_counts["near_ties"] or route_counts["max_prob_err"] > margin / 10:
        raise AssertionError(f"{cfg.name}: MoE routes differ between the "
                             f"card and the CPU: {route_counts}")
    (gl, gg, (gp, _, gn)), (wl, wg, (wp, wo, wn)) = out["card"], out["cpu"]
    if not (torch.equal(step_m["loss"], gl) and torch.equal(step_m["grad_norm"], gn)
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves(stepped), tree_leaves(gp)))):
        raise AssertionError(f"{cfg.name}: make_train_step differs from "
                             "its value_and_grad and adamw_update")
    row = {"loss_err": abs(float(gl) - float(wl)),
           "grad_norm_rel_err": abs(float(gn) - float(wn)) / float(wn),
           "loss": float(wl), "grad_norm": float(wn), "routes": route_counts,
           "step_launches": launched,
           "launches": {k: v + halves[k] for k, v in launched.items()}}
    if not (np.isfinite(float(gl)) and row["loss_err"] <= TRAIN_LOSS_TOL
            and row["grad_norm_rel_err"] <= TRAIN_NORM_RTOL):
        raise AssertionError(f"{cfg.name}: train step differs from the "
                             f"CPU's: {row}")
    grad_err, worst = 0.0, None
    for (k, a), b in zip(tree_flatten(gg), tree_leaves(wg)):
        e = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
        if e > grad_err:
            grad_err, worst = e, k
    row.update(grad_err=grad_err, grad_err_leaf=worst)
    if grad_err > TRAIN_GRAD_TOL:
        raise AssertionError(f"{cfg.name}: gradient {worst} differs from the "
                             f"CPU's by {grad_err:.3e} of its largest value")
    # the optimiser alone: the card's update of the CPU's gradients
    to_card = lambda t: t.to(device)  # noqa: E731
    cp, co, _ = adamw_update(card_params, tree_map(to_card, wg),
                             opts["card"], 0, lr, hp.adamw)
    p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(cp), tree_leaves(wp)))
    o_err = max(float((a.cpu() - b).abs().max())
                / max(float(b.abs().max()), 1e-30)
                for a, b in zip(tree_leaves(co), tree_leaves(wo)))
    row.update(opt_param_err=p_err, opt_moment_rel_err=o_err)
    if p_err > TRAIN_OPT_TOL or o_err > TRAIN_OPT_TOL:
        raise AssertionError(f"{cfg.name}: the card's AdamW update differs "
                             f"from the CPU's: parameters {p_err:.3e}, "
                             f"moments {o_err:.3e}")
    return row


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_trainer(torch, cfg, ckpt_dir, injector, device="cuda"):
    """The port's Trainer on the card at tests/test_trainer.py's settings,
    ``TRAINER_STEPS`` steps, checkpoints every ``TRAINER_CKPT_EVERY``."""
    from repro_torch.data import DataConfig
    from repro_torch.train.train_step import TrainHParams
    from repro_torch.train.trainer import Trainer, TrainerConfig
    hp = TrainHParams(lr=1e-3, warmup=2, total_steps=TRAINER_STEPS,
                      remat=None, ce_chunk=32)
    tc = TrainerConfig(total_steps=TRAINER_STEPS,
                       ckpt_every=TRAINER_CKPT_EVERY, ckpt_dir=str(ckpt_dir),
                       log_every=1000, ckpt_async=True)
    data = DataConfig(kind="synthetic", vocab_size=cfg.vocab_size,
                      seq_len=32, global_batch=4)
    return Trainer(cfg, hp, tc, data, injector=injector,
                   log_fn=lambda *_: None, device=device).run()


def train_phase(torch, np, card, steps=TRAIN_STEPS, device="cuda",
                full=None, seq=TRAIN_SEQ, twin_seq=TWIN_SEQ):
    """One-process training (slice I) on the card.

    (a) internlm2-1.8b at full width and depth, float32 parameters drawn
    on the card from a torch.Generator seeded 0 (``init_train_state``),
    trained by ``make_train_step`` (AdamW, remat "full") for ``steps``
    steps on ``make_pipeline``'s synthetic batches of 2 x 4096 tokens:
    loss and grad norm finite at every step, flash_attention launched
    2 x 24 times a step (the forward and the remat's recompute; the
    backward recomputes the plain version) and no other kernel.  Prints
    each step's wall, tokens/s, model TFLOP/s (6 N tokens a step; the
    remat's second forward, 2 N tokens, is not counted) and peak memory.
    (b) The same config with depth cut to 2 layers, parameters drawn on
    the card and copied to the CPU: one train step on each side on the
    synthetic stream's first 1 x 512 batch (``train_twin``).
    (c) The Trainer on the card at tests/test_trainer.py's settings, run
    once uninjected and once with a failure at step 6 (one restart from
    the step-4 checkpoint): final parameters and moments bit-equal.
    (d) jamba-1.5-large-398b reduced (MoE beside SSD layers): one train
    step on the card against the CPU (``train_twin``, routes compared
    first); both autograd Functions run.
    Returns (rows, the train path's launches: (a), (b)'s and (d)'s card
    steps and (c)'s two runs).  ``device="cpu"`` with a small ``full``
    config, ``seq`` and ``twin_seq`` rehearses the phase on the CPU
    (against itself; launch checks hold there as counted calls do not)."""
    import dataclasses as dc
    import shutil
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.ft import FailureInjector
    from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                              make_train_step)
    from repro_torch.utils.tree import tree_bytes, tree_leaves
    rows, launches = {}, {}

    def count(reading):
        for k, v in reading.items():
            launches[k] = launches.get(k, 0) + v

    card_run = torch.device(device).type == "cuda"

    def check_launches(c, row, passes):
        """The card's step of ``c`` launches each kernel ``passes`` times a
        layer of its kind (the forward, and the remat's rerun), and its
        halves once more as many."""
        n = layer_counts(c)
        step = {k: n.get(k, 0) * passes * card_run
                for k in row["step_launches"]}
        if (row["step_launches"], row["launches"]) != (
                step, {k: 2 * v for k, v in step.items()}):
            raise AssertionError(
                f"{c.name}: launches {row['step_launches']} in the step, "
                f"{row['launches']} with its halves; expected {step} and "
                "twice that")

    def draw(c):
        return init_train_state(c, torch.Generator(device=device).manual_seed(
            0), device=device)

    # (a) full width and depth
    cfg = full or get_config(TRAIN_ARCH)
    hp = TrainHParams(lr=3e-4, warmup=2, total_steps=100, remat="full",
                      ce_chunk=min(1024, seq))
    if card_run:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    params, opt = draw(cfg)
    # what the step holds before it runs (the launch phase's arguments)
    held = {"params": tree_bytes(params), "opt_state": tree_bytes(opt)}
    step_fn = make_train_step(cfg, hp)
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=TRAIN_BATCH),
                         device=device)
    walls, metrics = [], []
    reset_counters()
    try:
        for _ in range(steps):
            step, batch = next(pipe)
            held.setdefault("batch", tree_bytes(batch))
            sync(torch, device)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch, step)
            m = {k: float(v) for k, v in m.items()}     # ends on the card
            walls.append(time.perf_counter() - t0)
            metrics.append(m)
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"{cfg.name} step {step}: {m}")
    finally:
        pipe.close()
    reading = read_counters()
    want = {k: 0 for k in reading}
    want["flash_attention"] = (2 * layer_counts(cfg)["flash_attention"]
                               * steps if card_run else 0)
    if reading != want:
        raise AssertionError(f"{cfg.name} training: launches {reading}, "
                             f"expected {want}")
    count(reading)
    peak = torch.cuda.max_memory_allocated() if card_run else None
    n, tokens = cfg.param_count(), TRAIN_BATCH * seq
    flops = 6 * n * tokens
    tflops = [flops / w / 1e12 for w in walls]
    rows["full"] = {"arch": cfg.name, "layers": cfg.n_layers,
                    "width": cfg.d_model, "params": n,
                    "batch": TRAIN_BATCH, "seq": seq,
                    "remat": hp.remat, "walls_s": walls,
                    "tokens_per_s": [tokens / w for w in walls],
                    "model_tflops": tflops, "metrics": metrics,
                    "max_memory_allocated": peak, "launches": reading,
                    "held_bytes": held}
    print(f"train {cfg.name} width {cfg.d_model}, {cfg.n_layers} layers "
          f"({n} params, f32), batch {TRAIN_BATCH} x {seq}, remat "
          f"{hp.remat}: wall per step {[round(w, 4) for w in walls]} s, "
          f"tokens/s {[round(tokens / w, 1) for w in walls]}, model TFLOP/s "
          f"(6 N tokens = {flops:.4g} a step) {[round(t, 2) for t in tflops]}"
          f"; loss {[round(m['loss'], 5) for m in metrics]}, grad norm "
          f"{[round(m['grad_norm'], 5) for m in metrics]}; peak device "
          f"memory {peak} B; launches {reading}; {card}", flush=True)
    del params, opt, step_fn
    if card_run:
        torch.cuda.empty_cache()

    # (b) the full-width 2-layer twin
    twin = dc.replace(cfg, n_layers=TWIN_LAYERS)
    params = draw(twin)[0]
    t0 = time.perf_counter()
    row = train_twin(torch, np, twin, params,
                     train_batch(np, twin, 1, twin_seq),
                     dc.replace(hp, ce_chunk=min(1024, twin_seq)),
                     device=device)
    row["wall_s"] = time.perf_counter() - t0
    check_launches(twin, row, 2)
    count(row["launches"])
    rows["twin"] = row
    print(f"train {twin.name} width {twin.d_model}, {twin.n_layers} layers "
          f"({twin.param_count()} params), 1 x {twin_seq} tokens, card vs "
          f"CPU: loss {row['loss']:.6f} err {row['loss_err']:.3e} (tol "
          f"{TRAIN_LOSS_TOL}), grad norm {row['grad_norm']:.6f} rel err "
          f"{row['grad_norm_rel_err']:.3e} (tol {TRAIN_NORM_RTOL}), worst "
          f"gradient leaf {row['grad_err_leaf']} {row['grad_err']:.3e} of its "
          f"largest value (tol {TRAIN_GRAD_TOL}); AdamW on the CPU's "
          f"gradients: parameters {row['opt_param_err']:.3e}, moments "
          f"{row['opt_moment_rel_err']:.3e} (tol {TRAIN_OPT_TOL}); launches "
          f"{row['launches']}; {row['wall_s']:.1f} s", flush=True)
    del params
    if card_run:
        torch.cuda.empty_cache()

    # (c) the Trainer: restart after an injected failure, bit-equal
    small = get_reduced(TRAIN_ARCH)
    root = ROOT / "chiprun_out" / "train_ckpts"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    reset_counters()
    ref = train_trainer(torch, small, root / "clean", None, device)
    rec = train_trainer(torch, small, root / "injected",
                        FailureInjector(at_steps=[TRAINER_FAIL_AT]), device)
    sync(torch, device)
    reading = read_counters()
    count(reading)
    shutil.rmtree(root, ignore_errors=True)
    equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves([ref["params"], ref["opt"]]),
        tree_leaves([rec["params"], rec["opt"]])))
    if rec["restarts"] != 1 or rec["step"] != TRAINER_STEPS or not equal:
        raise AssertionError(f"Trainer restart: restarts {rec['restarts']}, "
                             f"step {rec['step']}, bit-equal {equal}")
    # steps run: the clean run's, the injected run's before the failure,
    # and its replay from the last checkpoint; one forward a step (no remat)
    want = (layer_counts(small)["flash_attention"]
            * (2 * TRAINER_STEPS + TRAINER_FAIL_AT - TRAINER_CKPT_EVERY)
            if card_run else 0)
    if reading["flash_attention"] != want:
        raise AssertionError(f"Trainer runs: launches {reading}, expected "
                             f"flash_attention {want}")
    rows["trainer"] = {"restarts": rec["restarts"], "bit_equal": equal,
                       "losses": [h["loss"] for h in rec["history"]],
                       "wall_s": time.perf_counter() - t0,
                       "launches": reading}
    print(f"train Trainer {small.name} reduced, {TRAINER_STEPS} steps, "
          f"checkpoints every {TRAINER_CKPT_EVERY}, failure at step "
          f"{TRAINER_FAIL_AT}: {rec['restarts']} restart, final parameters "
          f"and moments bit-equal to the uninjected run; losses "
          f"{[round(h['loss'], 5) for h in rec['history']]}; launches "
          f"{reading}; {rows['trainer']['wall_s']:.1f} s", flush=True)

    # (d) jamba reduced: MoE beside SSD layers, both autograd Functions
    jamba = get_reduced("jamba-1.5-large-398b")
    row = train_twin(torch, np, jamba, draw(jamba)[0],
                     train_batch(np, jamba, 2, 64),
                     dc.replace(hp, remat=None, ce_chunk=64), device=device)
    check_launches(jamba, row, 1)
    count(row["launches"])
    rows["jamba"] = row
    print(f"train {jamba.name} reduced, card vs CPU: loss err "
          f"{row['loss_err']:.3e}, grad norm rel err "
          f"{row['grad_norm_rel_err']:.3e}, worst gradient leaf "
          f"{row['grad_err_leaf']} {row['grad_err']:.3e}; AdamW "
          f"{row['opt_param_err']:.3e} / {row['opt_moment_rel_err']:.3e}; "
          f"routes {row['routes']}; launches {row['launches']}", flush=True)
    return rows, launches


# ---------------------------------------------------------------------------
# phase 9a: RegC gradient sync across processes (slice J)
# ---------------------------------------------------------------------------

# (a): two ranks share the card over gloo; the full-width 2-layer twin;
# a global batch of 4 x 2048 (2 rows a rank) in 2 microbatches; one step
# a policy from the same state, benchmarks/regc_training.py's four, with
# lazy_bucket at the default 64 MiB buckets
REGC_RANKS, REGC_BATCH, REGC_SEQ, REGC_MICRO = 2, 4, 2048, 2
REGC_POLICIES = (
    ("lazy_object", {"ordinary_sync": "lazy", "granularity": "object"}),
    ("lazy_bucket", {"ordinary_sync": "lazy", "granularity": "bucket"}),
    ("eager_object", {"ordinary_sync": "eager", "granularity": "object"}),
    ("int8_ring", {"ordinary_sync": "lazy", "granularity": "object",
                   "compression": "int8_ring"}))
# the int8 ring: tests/test_regc_sync.py's bound |ring - psum| / (|psum|
# + 1e-3) < 0.05 on its own input and elementwise on the full-width
# gradients (their 1e-3 floor sits above the ring's error there, not at
# reduced width); each gradient leaf within 2e-2 of its largest |value|
# and the grad norm within 4e-3, relative: about 3x and 10x the ring's
# errors on the card (7.475e-3 and 3.716e-4 at full width; 7.3e-3 and
# 9.6e-5 at reduced width on the CPU), where a lossless sync is held to
# TRAIN_GRAD_TOL and TRAIN_NORM_RTOL
REGC_RING_TOL = 0.05
REGC_RING_LEAF_TOL, REGC_RING_NORM_TOL = 2e-2, 4e-3
# (b): launch.train --path regc, int8_ring, under torch.distributed.run
REGC_LAUNCH_STEPS, REGC_LAUNCH_CKPT_EVERY = 6, 3


def tree_digest(torch, tree):
    """Per leaf, the sum of its 32-bit words (as int64) and their sum
    weighted by position: two ranks' trees of equal digests hold equal
    bits but for a collision of both 64-bit sums.  On the host."""
    from repro_torch.utils.tree import tree_leaves
    return torch.cat([leaf_digest(torch, leaf) for leaf in tree_leaves(tree)])


DIGEST_CHUNK = 1 << 26


def leaf_digest(torch, leaf):
    """``tree_digest`` of one leaf, summed ``DIGEST_CHUNK`` words at a time
    (int64 sums wrap alike in any grouping), so its temporaries stay
    under 1.1 GB whatever the leaf's size."""
    words = leaf.detach().contiguous().view(torch.int32).reshape(-1)
    total = torch.zeros(2, dtype=torch.int64, device=words.device)
    for a in range(0, words.numel(), DIGEST_CHUNK):
        w = words[a:a + DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(a + 1, a + 1 + w.numel(), dtype=torch.int64,
                           device=w.device)
        total += torch.stack([w.sum(), (w * pos).sum()])
        del w, pos
    return total.cpu()


def regc_counts(sizes, policy: dict, n_micro: int, world: int) -> dict:
    """The collectives one rank counts in a step: (bytes, messages) of
    all-reduce and collective-permute.  The gradients sync once (lazy)
    or every microbatch (eager) as one vector a leaf (object) or a bucket
    (closed once it holds ``bucket_bytes``); psum: one all-reduce of 4
    bytes an element; int8_ring: 2 (world - 1) hops of two permutes,
    ceil(n / world) bytes of codes and a 4-byte scale; then the loss's
    4-byte all-reduce."""
    from repro_torch.regc_sync.policies import RegCSyncPolicy
    pol = RegCSyncPolicy(**policy)
    flats = list(sizes)
    if pol.granularity == "bucket":
        flats, cur = [], 0
        for n in sizes:
            cur += n
            if cur * 4 >= pol.bucket_bytes:
                flats.append(cur)
                cur = 0
        flats += [cur] if cur else []
    syncs = n_micro if pol.ordinary_sync == "eager" else 1
    if pol.compression == "int8_ring":
        hops = 2 * (world - 1)
        return {"all-reduce": (4, 1), "collective-permute": (
            syncs * sum(hops * -(-n // world) + hops * 4 for n in flats),
            syncs * 2 * hops * len(flats))}
    return {"all-reduce": (syncs * 4 * sum(flats) + 4, syncs * len(flats) + 1),
            "collective-permute": (0, 0)}


def regc_rank(cfg, hp, batch, grads_path, sizes, one, digest0, device,
              ring_elementwise=True):
    """One rank of (a): the four policies' steps, checked on the rank
    against the one-process step (``one``: loss and grad norm; gradients
    in the float32 file ``grads_path``, kept on the host and brought to
    the device a leaf at a time).  Returns the rows and the rank's peak
    memory over the steps; raises after the last policy if any failed,
    with every row."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import rank_device
    from repro_torch.regc_sync import policies as P
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step_regc)
    from repro_torch.utils.tree import tree_flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    card_run = dev.type == "cuda"
    t_setup = time.perf_counter()
    mesh = make_host_mesh((world,), ("data",))
    # the reference test's ring bound on its own kind of input, here
    x = (torch.arange(world * 64, dtype=torch.float32).reshape(world, 64)
         / 100.0 - 2.0)
    ring = P.ring_allreduce_int8(x[rank].to(dev), "data", world,
                                 mesh=mesh).cpu()
    psum = x.double().sum(0)
    ring_input_err = float(((ring.double() - psum).abs()
                            / (psum.abs() + 1e-3)).max())
    if not ring_input_err < REGC_RING_TOL:
        raise AssertionError(f"int8 ring on the reference test's input: "
                             f"{ring_input_err} of its bound")
    params, opt = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if tree_digest(torch, params).tolist() != digest0:
        raise AssertionError(f"rank {rank}: parameters differ from the "
                             "one-process step's")
    flat = np.load(grads_path, mmap_mode="r")
    bounds = np.cumsum([0] + list(sizes))
    ref = [torch.from_numpy(np.array(flat[a:b]))
           for a, b in zip(bounds[:-1], bounds[1:])]
    del flat
    if card_run:
        ref = [t.pin_memory() for t in ref]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    setup_s = time.perf_counter() - t_setup
    if card_run:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rows, failed = {}, []
    for tag, policy in REGC_POLICIES:
        step = make_train_step_regc(
            cfg, dataclasses.replace(hp, sync=P.RegCSyncPolicy(**policy)),
            mesh)
        reset_counters()
        P.reset_collectives()
        P.SYNC_WALLS = []
        sync(torch, dev)
        t0 = time.perf_counter()
        try:
            p2, o2, m, g = step(params, opt, batch, 0, with_grads=True)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            wall = time.perf_counter() - t0
        finally:
            walls, P.SYNC_WALLS = P.SYNC_WALLS, None
        row = {"wall_s": wall, "sync_walls_s": walls, "loss": loss,
               "grad_norm": gnorm, "loss_err": abs(loss - one["loss"]),
               "grad_norm_rel_err": abs(gnorm - one["grad_norm"])
               / one["grad_norm"],
               "bytes": dict(P.COLLECTIVE_BYTES),
               "messages": dict(P.COLLECTIVE_MSGS),
               "staged": dict(P.STAGED), "launches": read_counters()}
        ring = policy.get("compression") == "int8_ring"
        worst, elem = (0.0, None), 0.0
        for (k, leaf), want in zip(tree_flatten(g), ref):
            want = want.to(dev)
            diff = (leaf.reshape(-1) - want).abs()
            e = float(diff.max()) / max(float(want.abs().max()), 1e-30)
            if e > worst[0]:
                worst = (e, k)
            if ring:
                elem = max(elem, float((diff / (want.abs() + 1e-3)).max()))
            del diff, want
        row.update(grad_err=worst[0], grad_err_leaf=worst[1])
        if ring:
            row.update(ring_elementwise=elem, ring_input_err=ring_input_err)
        mine = tree_digest(torch, [p2, o2])
        theirs = [torch.zeros_like(mine) for _ in range(world)]
        dist.all_gather(theirs, mine)
        row["ranks_equal"] = all(torch.equal(t, mine) for t in theirs)
        counted = {k: (row["bytes"][k], row["messages"][k])
                   for k in row["bytes"]}
        row["counts_ok"] = counted == regc_counts(sizes, policy, hp.n_micro,
                                                  world)
        del p2, o2, m, g
        tol = REGC_RING_LEAF_TOL if ring else TRAIN_GRAD_TOL
        norm_tol = REGC_RING_NORM_TOL if ring else TRAIN_NORM_RTOL
        if not (np.isfinite(loss) and row["loss_err"] <= TRAIN_LOSS_TOL
                and row["grad_norm_rel_err"] <= norm_tol
                and row["grad_err"] <= tol and row["ranks_equal"]
                and row["counts_ok"]
                and not (ring and ring_elementwise
                         and not elem < REGC_RING_TOL)):
            failed.append(tag)
        rows[tag] = row
    if failed:
        raise AssertionError(f"rank {rank}: {failed} failed; rows {rows}")
    peak = torch.cuda.max_memory_allocated(dev) if card_run else None
    return {"rank": rank, "device": str(dev), "rows": rows, "peak": peak,
            "setup_s": setup_s}


def regc_launch(torch, work: Path, device: str) -> dict:
    """(b): ``launch.train --path regc`` on ``REGC_RANKS`` ranks under
    ``python -m torch.distributed.run --standalone``."""
    import os
    from repro_torch.checkpoint import latest_step
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(REGC_RANKS), "-m", "repro_torch.launch.train",
         "--path", "regc", "--sync-compression", "int8_ring", "--backend",
         "gloo", "--device", device, "--steps", str(REGC_LAUNCH_STEPS),
         "--ckpt-every", str(REGC_LAUNCH_CKPT_EVERY), "--ckpt-dir",
         str(work / "ckpts")],
        cwd=work, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launch.train --path regc exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    done = [x for x in lines if x.startswith("done: ")]
    ranks = [x for x in lines if x.startswith("ranks: ")]
    if len(done) != 1 or len(ranks) != 1:
        raise AssertionError(f"launch.train printed {done} {ranks}")
    losses = json.loads(ranks[0].split("final_losses=")[1].split(
        " launches=")[0])
    launched = json.loads(ranks[0].split(" launches=")[1].replace("'", '"'))
    step = latest_step(work / "ckpts")
    if (len(losses) != REGC_RANKS or len(set(losses)) != 1
            or not done[0].startswith(f"done: step={REGC_LAUNCH_STEPS} ")
            or step != REGC_LAUNCH_STEPS):
        raise AssertionError(f"launch.train --path regc: {done[0]}, "
                             f"{ranks[0]}, checkpoint step {step}")
    return {"done": done[0], "ranks": ranks[0], "final_losses": losses,
            "ckpt_step": step, "wall_s": wall, "launches": launched}


def regc_phase(torch, np, card, device="cuda", cfg=None, seq=REGC_SEQ,
               launch=True):
    """Phase 9a (see the module's note).  Returns (rows, the regc path's
    launches: the one-process step's, the ranks' and (b)'s).  ``device=
    "cpu"`` with a small ``cfg`` and ``seq`` rehearses it on the CPU.
    The ring's elementwise bound is held at full width only (a ``cfg``
    given, it is printed, not held)."""
    ring_elementwise = cfg is None
    import shutil
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                              make_train_step)
    from repro_torch.utils.tree import tree_flatten
    cfg = cfg or dataclasses.replace(get_config(TRAIN_ARCH),
                                     n_layers=TWIN_LAYERS)
    hp = TrainHParams(lr=3e-4, warmup=2, total_steps=100, remat="full",
                      ce_chunk=min(1024, seq), n_micro=REGC_MICRO)
    card_run = torch.device(device).type == "cuda"
    work = ROOT / "build" / "regc_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    batch = train_batch(np, cfg, REGC_BATCH, seq)
    # the one-process step on the global batch; its results to the host
    if card_run:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    digest0 = tree_digest(torch, params).tolist()
    reset_counters()
    t0 = time.perf_counter()
    _, _, m, grads = make_train_step(cfg, hp)(
        params, opt, {k: torch.as_tensor(v, device=device)
                      for k, v in batch.items()}, 0, with_grads=True)
    one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "wall_s": time.perf_counter() - t0, "launches": read_counters(),
           "peak": torch.cuda.max_memory_allocated() if card_run else None}
    leaves = tree_flatten(grads)
    sizes = [g.numel() for _, g in leaves]
    out = np.lib.format.open_memmap(work / "grads.npy", mode="w+",
                                    dtype=np.float32, shape=(sum(sizes),))
    off = 0
    for (_, g), n in zip(leaves, sizes):
        out[off:off + n] = g.reshape(-1).cpu().numpy()
        off += n
    out.flush()
    del out, params, opt, grads, m, leaves
    if card_run:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(
        REGC_RANKS, "chip_smoke:regc_rank",
        (cfg, hp, batch, str(work / "grads.npy"), sizes, one, digest0,
         device, ring_elementwise), backend="gloo", init_method=f"file://{work / 'store'}",
        timeout_s=600)
    ranks_wall = time.perf_counter() - t0
    (work / "grads.npy").unlink()
    per_step = 2 * REGC_MICRO * layer_counts(cfg)["flash_attention"]
    launches = dict(one["launches"])
    for r in ranks:
        for tag, row in r["rows"].items():
            want = per_step if card_run else 0
            if row["launches"]["flash_attention"] != want:
                raise AssertionError(f"rank {r['rank']} {tag}: launches "
                                     f"{row['launches']}, flash_attention "
                                     f"{want} expected")
            for k, v in row["launches"].items():
                launches[k] += v
    if one["launches"]["flash_attention"] != (per_step if card_run else 0):
        raise AssertionError(f"one-process step: launches {one['launches']}")
    print(f"regc {cfg.name} width {cfg.d_model}, {cfg.n_layers} layers "
          f"({cfg.param_count()} params, f32), global batch {REGC_BATCH} x "
          f"{seq} in {REGC_MICRO} microbatches, remat {hp.remat}: one-process "
          f"step {one['wall_s']:.3f} s, loss {one['loss']:.6f}, grad norm "
          f"{one['grad_norm']:.6f}, peak {one['peak']} B; {REGC_RANKS} ranks "
          f"on {ranks[0]['device']} over gloo ({ranks_wall:.1f} s with "
          f"their start); {card}", flush=True)
    for tag, _ in REGC_POLICIES:
        rs = [r["rows"][tag] for r in ranks]
        extra = (f", ring elementwise |ring - psum| / (|psum| + 1e-3) "
                 f"{rs[0]['ring_elementwise']:.4g} (reference input "
                 f"{rs[0]['ring_input_err']:.4g})" if "ring_input_err"
                 in rs[0] else "")
        print(f"regc {tag}: step wall {[round(r['wall_s'], 4) for r in rs]}"
              f" s, sync walls {[[round(w, 4) for w in r['sync_walls_s']] for r in rs]}"
              f" s, loss err {rs[0]['loss_err']:.3e}, grad norm rel err "
              f"{rs[0]['grad_norm_rel_err']:.3e}, worst gradient leaf "
              f"{rs[0]['grad_err_leaf']} {max(r['grad_err'] for r in rs):.3e}"
              f" of its largest value{extra}; bytes {rs[0]['bytes']}, "
              f"messages {rs[0]['messages']} a rank (rule kept), backend "
              f"gloo, staged to the host {rs[0]['staged']}; ranks equal "
              f"{all(r['ranks_equal'] for r in rs)}; launches "
              f"{ {k: v for k, v in rs[0]['launches'].items() if v} } a "
              "rank", flush=True)
    print(f"regc peak device memory by rank over the four steps and their "
          f"checks: {[r['peak'] for r in ranks]} B; set-up (mesh, "
          f"parameters, the one-process gradients loaded to the host) "
          f"{[round(r['setup_s'], 2) for r in ranks]} s", flush=True)
    rows = {"one_process": one, "ranks": ranks, "ranks_wall_s": ranks_wall}
    if launch:
        b = regc_launch(torch, work, "cuda" if card_run else "cpu")
        want = (REGC_LAUNCH_STEPS * REGC_RANKS
                * layer_counts(get_reduced(TRAIN_ARCH))["flash_attention"]
                if card_run else 0)
        if b["launches"]["flash_attention"] != want:
            raise AssertionError(f"launch.train: launches {b['launches']}, "
                                 f"flash_attention {want} expected")
        for k, v in b["launches"].items():
            launches[k] = launches.get(k, 0) + v
        rows["launch"] = b
        print(f"regc launch.train --path regc --sync-compression int8_ring, "
              f"{REGC_RANKS} ranks under torch.distributed.run: "
              f"{b['done']}; final losses {b['final_losses']}; checkpoint "
              f"step {b['ckpt_step']}; launches {b['launches']}; "
              f"{b['wall_s']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return rows, launches


# ---------------------------------------------------------------------------
# phase 9b: tensor, expert and FSDP parallelism of training (slice K)
# ---------------------------------------------------------------------------

# moonshot-v1-16b-a3b at full width, DEFAULT_RULES (``launch.specs.
# rules_for`` at train_4k, an MoE's), remat "full", sequences of 1024:
# (a) 1 layer (2 until the serve-tp phase needed the time) on a (1, 2)
# ("data", "model") mesh, a global batch of 2, one step with moe_impl
# dense and one with ep from the same state; (b) 1 layer on a (2, 2)
# mesh (FSDP over data, two dispatch groups), a global batch of 4, ep.
# (tag, mesh, layers, batch, impls)
TP_ARCH, TP_SEQ = "moonshot-v1-16b-a3b", 1024
TP_RUNS = (("a", (1, 2), 1, 2, ("dense", "ep")),
           ("b", (2, 2), 1, 4, ("ep",)))
TP_AXES = ("data", "model")
# aux_loss: float32 sums of the router's probabilities in another order
# (1e-6 absolute of a loss near 1); expert_load (whole counts) equal
# unless a routing near tie was counted
TP_AUX_TOL = 1e-6


def tp_groups(cfg, shape, impl):
    """The one-process comparator's MoE groups and aux definition for a
    run on ``shape``: the dense block's ``moe_groups`` (as many as the
    batch's data shards), or the ep block's one a data shard with each
    shard's aux loss averaged."""
    n = shape[TP_AXES.index("data")]
    ep = impl == "ep" and cfg.moe.n_experts % shape[1] == 0
    return n, ep and n > 1


def tp_rank(cfg, hp, batch, impls, shape, work, one, device):
    """One rank of phase 9b: for each ``impls`` entry, the sharded step
    from the seeded state, checked here against the one-process step of
    ``one`` (loss, grad norm, routes, aux_loss, expert_load; gradients
    in a float32 file of ``work``, read a block at a time) and the
    sharded AdamW update of those gradients against AdamW's own on them.
    Returns the rows (each with the rank's peak memory over its
    step); raises after the last impl if any check failed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import collectives as C
    from repro_torch.models import layers
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_param
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.train import train_step as T
    from repro_torch.utils.tree import (tree_flatten, tree_leaves,
                                        tree_unflatten)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = rank_device(device)
    card_run = dev.type == "cuda"
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_host_mesh(shape, TP_AXES)
    work = Path(work)
    offs = np.cumsum([0] + one["sizes"])
    shapes = [p.shape for p in SH.spec_leaves(param_specs(cfg))]

    def block(f, i, spec):
        """Leaf ``i``'s block of this rank from the host file ``f``."""
        a = f[offs[i]:offs[i + 1]].reshape(shapes[i])
        idx = []
        for n, e in zip(shapes[i], spec):
            axes = SH.entry_axes(e)
            k = n // mesh.size(axes) if axes else n
            j = mesh.block_index(axes) if axes else 0
            idx.append(slice(j * k, (j + 1) * k))
        return torch.from_numpy(np.array(a[tuple(idx)])).to(dev)

    # the seeded parameters drawn a leaf at a time, in init_params's
    # order, each digested and cut to this rank's block before the next
    # (every impl lays them out alike: ``rules_for``'s table for an MoE
    # train shape, DEFAULT_RULES): a full leaf at most
    # on the card at once
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks, digest = [], []
    rules = getattr(SH, run_rules(cfg, "train_4k"))
    for pspec, spec in zip(SH.spec_leaves(param_specs(cfg)),
                           T.leaf_specs(cfg, SH.ShardingCtx(mesh, rules))):
        leaf = init_param(pspec, gen, torch.float32)
        digest.append(leaf_digest(torch, leaf))
        blocks.append(SH.owned_block(leaf, spec, mesh))
        del leaf
    if torch.cat(digest).tolist() != one["digest"]:
        raise AssertionError(f"rank {rank}: parameters differ from the "
                             "one-process step's")
    params = tree_unflatten(param_specs(cfg), blocks)
    del blocks
    if card_run:
        torch.cuda.empty_cache()
    tbatch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    setup_s = time.perf_counter() - t_start
    rows, failed = {}, []
    for impl in impls:
        ctx = SH.ShardingCtx(mesh, rules, moe_impl=impl)
        specs = T.leaf_specs(cfg, ctx)
        t_eval = time.perf_counter()
        layers.ROUTES = []
        try:
            _, mts = T.eval_loss(cfg, hp, params, tbatch, ctx)
            routes = [{k: v.detach().cpu() for k, v in r.items()}
                      for r in layers.ROUTES]
        finally:
            layers.ROUTES = None
        # this rank's rows of the one-process routes
        layout = SH.RankLayout.for_batch(ctx, batch["targets"].shape[0])
        rows_loc = batch["targets"].shape[0] // layout.n_blocks
        t_loc = rows_loc * batch["targets"].shape[1]
        lo = (mesh.block_index(layout.batch_axes) if layout.batch_axes
              else 0) * t_loc
        want = [{k: v[lo:lo + t_loc] for k, v in r.items()}
                for r in one["routes"][impl]]
        route_counts = compare_routes(torch, routes, want, [1 << 62] *
                                      rows_loc, 0, ROUTE_MARGIN)
        opt = init_opt_state(params)
        if card_run:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        eval_s = time.perf_counter() - t_eval
        reset_counters()
        C.reset_collectives()
        t0 = time.perf_counter()
        p2, o2, m, g = T.make_train_step(cfg, hp, ctx)(
            params, opt, tbatch, 0, with_grads=True)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if card_run else None
        launched = read_counters()
        coll = {f"{k} {'x'.join(a)}": (C.COLLECTIVE_BYTES[(k, a)],
                                       C.COLLECTIVE_MSGS[(k, a)])
                for k, a in sorted(C.COLLECTIVE_BYTES)}
        ref = one["impl"][impl]
        t_check = time.perf_counter()
        row = {"wall_s": wall, "setup_s": setup_s, "eval_s": eval_s,
               "loss": loss, "grad_norm": gnorm,
               "loss_err": abs(loss - ref["loss"]),
               "grad_norm_rel_err": abs(gnorm - ref["grad_norm"])
               / ref["grad_norm"],
               "aux_err": abs(float(mts["aux_loss"]) - ref["aux_loss"]),
               "load_equal": mts["expert_load"].cpu().tolist()
               == ref["expert_load"], "routes": route_counts,
               "collectives": coll, "staged": dict(C.STAGED), "peak": peak,
               "launches": launched}
        # every block held by several ranks: the same bits on each
        mine = tree_digest(torch, [p2, o2, g])
        theirs = [torch.zeros_like(mine) for _ in range(world)]
        dist.all_gather(theirs, mine)
        keys = [[tuple(mesh.block_index(SH.entry_axes(e), r) if e else 0
                       for e in spec) for r in range(world)]
                for spec in specs * 4]          # params, m, v, grads
        row["replicas_equal"] = all(
            torch.equal(theirs[r][2 * j:2 * j + 2], mine[2 * j:2 * j + 2])
            for j, ks in enumerate(keys) for r in range(world)
            if ks[r] == ks[rank])
        row["replicated_leaves"] = sum(
            any(ks[r] == ks[rank] for r in range(world) if r != rank)
            for ks in keys[:len(specs)])
        del p2, o2
        # the gradients against the one-process step's, a block at a time
        grads_f = np.load(work / f"grads_{impl}.npy", mmap_mode="r")
        ref_blocks, worst = [], (0.0, None)
        for i, ((k, leaf), spec) in enumerate(zip(tree_flatten(g), specs)):
            want_g = block(grads_f, i, spec)
            e = float((leaf - want_g).abs().max()) / max(
                one["grad_max"][impl][i], 1e-30)
            if e > worst[0]:
                worst = (e, k)
            ref_blocks.append(want_g)
        del grads_f
        row.update(grad_err=worst[0], grad_err_leaf=worst[1])
        ref_grads = tree_unflatten(g, ref_blocks)
        del g, ref_blocks
        # the optimiser alone: the sharded update of the one-process
        # gradients against the one-process AdamW of them (elementwise
        # given the clip's scale, so taken a leaf at a time on the blocks)
        q2 = T.apply_sharded_update(params, ref_grads, opt, 0, m["lr"], hp,
                                    specs, mesh)[0]
        norm = torch.tensor(ref["grad_norm"], dtype=torch.float32,
                            device=dev)
        scale = torch.clamp(hp.adamw.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        no_clip = dataclasses.replace(hp.adamw, clip_norm=None)
        row["opt_param_err"] = 0.0
        for p_, g_, got in zip(tree_leaves(params), tree_leaves(ref_grads),
                               tree_leaves(q2)):
            want_p = adamw_update([p_], [g_ * scale],
                                  init_opt_state([p_]), 0, m["lr"],
                                  no_clip)[0][0]
            row["opt_param_err"] = max(row["opt_param_err"], float(
                (got - want_p).abs().max()))
            del want_p
        del q2, ref_grads, opt
        if card_run:
            torch.cuda.empty_cache()
        row["check_s"] = time.perf_counter() - t_check
        if not (np.isfinite(loss) and row["loss_err"] <= TRAIN_LOSS_TOL
                and row["grad_norm_rel_err"] <= TRAIN_NORM_RTOL
                and row["grad_err"] <= TRAIN_GRAD_TOL
                and row["opt_param_err"] <= TRAIN_OPT_TOL
                and row["aux_err"] <= TP_AUX_TOL
                and (row["load_equal"] or route_counts["near_ties"])
                and row["replicas_equal"]):
            failed.append(impl)
        rows[impl] = row
    if failed:
        raise AssertionError(f"rank {rank}: {failed} failed; rows {rows}")
    return {"rank": rank, "device": str(dev), "rows": rows}


def tp_one_process(torch, np, cfg, hp, batch, impls, shape, work, device):
    """The comparator of a phase 9b run: for each distinct MoE grouping of
    ``impls``, the one-process step on the card from the seeded state;
    its gradients written to a float32 file of ``work`` (one vector,
    leaves in order), its scalars, routes and per-leaf largest
    |gradient| returned."""
    from repro_torch.models import layers
    from repro_torch.models.model import init_model_params
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train import train_step as T
    from repro_torch.utils.tree import tree_leaves
    card_run = torch.device(device).type == "cuda"
    tbatch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out = {"impl": {}, "routes": {}, "grad_max": {}, "walls": {},
           "write_s": 0.0}
    params = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    out["digest"] = tree_digest(torch, params).tolist()
    out["sizes"] = [p.numel() for p in tree_leaves(params)]
    if card_run:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    done = {}
    for impl in impls:
        groups, group_aux = tp_groups(cfg, shape, impl)
        key = (groups, group_aux)
        if key in done:
            for d in ("impl", "routes", "grad_max"):
                out[d][impl] = out[d][done[key]]
            (work / f"grads_{impl}.npy").symlink_to(
                work / f"grads_{done[key]}.npy")
            continue
        done[key] = impl
        layers.ROUTES = []
        try:
            _, mts = T.eval_loss(cfg, hp, params, tbatch, moe_groups=groups,
                                 moe_group_aux=group_aux)
            out["routes"][impl] = [{k: v.detach().cpu()
                                    for k, v in r.items()}
                                   for r in layers.ROUTES]
        finally:
            layers.ROUTES = None
        opt = init_opt_state(params)
        sync(torch, device)
        t0 = time.perf_counter()
        new_p, new_opt, m, grads = T.make_train_step(
            cfg, hp, moe_groups=groups, moe_group_aux=group_aux)(
            params, opt, tbatch, 0, with_grads=True)
        loss = float(m["loss"])
        out["walls"][impl] = time.perf_counter() - t0
        del new_p, new_opt
        out["impl"][impl] = {
            "loss": loss, "grad_norm": float(m["grad_norm"]),
            "aux_loss": float(mts["aux_loss"]),
            "expert_load": mts["expert_load"].cpu().tolist()}
        del opt, m, mts
        out["grad_max"][impl] = [float(g.abs().max())
                                 for g in tree_leaves(grads)]
        t0 = time.perf_counter()
        f = np.lib.format.open_memmap(
            work / f"grads_{impl}.npy", mode="w+", dtype=np.float32,
            shape=(sum(out["sizes"]),))
        off = 0
        for leaf in tree_leaves(grads):
            n = leaf.numel()
            f[off:off + n] = leaf.reshape(-1).cpu().numpy()
            off += n
        # the ranks read the file's pages from the page cache: no flush
        del f, grads
        out["write_s"] += time.perf_counter() - t0
    out["peak"] = torch.cuda.max_memory_allocated() if card_run else None
    del params
    if card_run:
        torch.cuda.empty_cache()
    return out


def tp_phase(torch, np, card, device="cuda", cfg=None, seq=TP_SEQ,
             runs=TP_RUNS):
    """Phase 9b (see the module's note).  Returns (rows, the tp path's
    launches: the ranks' steps').  ``device="cpu"`` with a small ``cfg``
    and ``seq`` rehearses it on the CPU."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.train.train_step import TrainHParams
    import gc
    card_run = torch.device(device).type == "cuda"
    base = cfg or get_config(TP_ARCH)
    hp = TrainHParams(lr=3e-4, warmup=2, total_steps=100, remat="full",
                      ce_chunk=min(1024, seq))
    out, launches = {}, {}
    if card_run:
        # the card is shared with up to four ranks: this process keeps
        # nothing of the earlier phases on it
        gc.collect()
        torch.cuda.empty_cache()
        print(f"tp: this process holds {torch.cuda.memory_allocated()} B "
              f"on the card ({torch.cuda.memory_reserved()} B reserved) "
              "before the phase", flush=True)
    for tag, shape, n_layers, B, impls in runs:
        run_cfg = dataclasses.replace(base, n_layers=n_layers)
        work = ROOT / "build" / "tp_smoke"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        batch = train_batch(np, run_cfg, B, seq)
        t0 = time.perf_counter()
        one = tp_one_process(torch, np, run_cfg, hp, batch, impls, shape,
                             work, device)
        one_s = time.perf_counter() - t0
        if card_run:
            gc.collect()
            torch.cuda.empty_cache()
            parent = (torch.cuda.memory_allocated(),
                      torch.cuda.memory_reserved())
        t0 = time.perf_counter()
        ranks = spawn_ranks(
            int(np.prod(shape)), "chip_smoke:tp_rank",
            (run_cfg, hp, batch, impls, shape, str(work), one, device),
            backend="gloo", init_method=f"file://{work / 'store'}",
            timeout_s=600)
        ranks_s = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)
        per_step = 2 * layer_counts(run_cfg)["flash_attention"]
        for r in ranks:
            for impl, row in r["rows"].items():
                got = row["launches"]["flash_attention"]
                if got != (per_step if card_run else 0):
                    raise AssertionError(
                        f"tp ({tag}) rank {r['rank']} {impl}: "
                        f"flash_attention launched {got} times, "
                        f"{per_step if card_run else 0} expected")
                for k, v in row["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        print(f"tp ({tag}) {run_cfg.name} width {run_cfg.d_model}, "
              f"{run_cfg.n_layers} layers ({run_cfg.param_count()} params, "
              f"f32), mesh {dict(zip(TP_AXES, shape))} "
              f"{run_rules(run_cfg, 'train_4k')}, "
              f"global batch {B} x {seq}, remat {hp.remat}: one-process "
              f"steps {[round(w, 3) for w in one['walls'].values()]} s, "
              f"peak {one['peak']} B, gradients to the host file "
              f"{one['write_s']:.1f} s, with set-up {one_s:.1f} s; "
              f"{len(ranks)} ranks on {ranks[0]['device']} over gloo "
              f"({ranks_s:.1f} s with their start; this process holding "
              f"{parent if card_run else None} B allocated, reserved); "
              f"{card}", flush=True)
        for impl in impls:
            rs = [r["rows"][impl] for r in ranks]
            ref = one["impl"][impl]
            print(f"tp ({tag}) {impl}: step wall "
                  f"{[round(r['wall_s'], 3) for r in rs]} s (a rank's "
                  f"set-up {rs[0]['setup_s']:.1f} s, routes and stats "
                  f"forward {rs[0]['eval_s']:.1f} s, checks "
                  f"{rs[0]['check_s']:.1f} s), loss "
                  f"{rs[0]['loss']:.6f} (one-process {ref['loss']:.6f}, err "
                  f"{max(r['loss_err'] for r in rs):.3e}), grad norm rel err "
                  f"{max(r['grad_norm_rel_err'] for r in rs):.3e}, worst "
                  f"gradient leaf {rs[0]['grad_err_leaf']} "
                  f"{max(r['grad_err'] for r in rs):.3e} of its largest "
                  f"value, AdamW on the one-process gradients "
                  f"{max(r['opt_param_err'] for r in rs):.3e}, aux_loss err "
                  f"{max(r['aux_err'] for r in rs):.3e}, expert_load equal "
                  f"{all(r['load_equal'] for r in rs)}, routes "
                  f"{rs[0]['routes']}; replicas equal "
                  f"{all(r['replicas_equal'] for r in rs)} "
                  f"({rs[0]['replicated_leaves']} leaves replicated on rank "
                  f"0); peak {[r['peak'] for r in rs]} B a rank; "
                  f"flash_attention {rs[0]['launches']['flash_attention']} "
                  f"a rank; backend gloo, staged {rs[0]['staged']}; "
                  f"collectives (bytes, messages) a rank "
                  f"{rs[0]['collectives']}", flush=True)
        out[tag] = {"one_process": {k: v for k, v in one.items()
                                    if k not in ("routes",)},
                    "ranks": ranks, "one_s": one_s, "ranks_s": ranks_s}
    return out, launches


# ---------------------------------------------------------------------------
# phase 9c: serving under a sharding context (slice L)
# ---------------------------------------------------------------------------

# (tag, arch, depth (None: the config's own), rules, gather_fsdp, mesh):
# (a) internlm2-1.8b whole under SMALL_SERVE_RULES (what rules_for gives
# its decode shape): batch over 'data', q heads, vocab and
# the KV cache's positions over 'model'; (b) mamba2-2.7b whole, the same
# rules: ssm_in over 'model'; (c) llama3-405b at full width, 1 of its 126
# layers, DECODE_2D_RULES with gather_fsdp=False (the no-regather decode
# the reference wrote that table for): d_model over 'data', heads, d_ff,
# vocab over 'model', positions over both
# (the rules: ``launch.specs.rules_for`` at a shape of the registry, with
# an override of ``NAMED_RULES`` or none; ``run_rules``)
SERVE_TP_RUNS = (
    ("a", "internlm2-1.8b", None, ("decode_32k", None), True, (2, 2)),
    ("b", "mamba2-2.7b", None, ("decode_32k", None), True, (1, 2)),
    ("c", "llama3-405b", 1, ("decode_32k", "decode2d"), False, (2, 2)))
SERVE_TP_AXES = ("data", "model")
# the model phase's first wave of 4 requests (seed 0), left-padded to 496
# tokens, and 8 new ones (16 until the sp phase needed the time): caches
# of max_len 504, which 2 and 4 divide
SERVE_TP_B, SERVE_TP_S, SERVE_TP_NEW = 4, 496, 8
# phase 9d, in the start of 9c's ranks on its mesh (2, 2):
# (tag, arch, depth, rules, gather_fsdp, optimiser, global batch), all on
# a (2, 2) ("data", "model") mesh, sequences of 1024, remat "full":
# (a) mamba2-2.7b at full width, 2 of its 64 layers, TRAIN_SP_RULES
# (seq_sp and ssm_in over model, FSDP over data), adamw8bit, 4 rows;
# (b) internlm2-1.8b at full width, 1 of its 24 layers, DECODE_2D_RULES
# with gather_fsdp=False (batch whole; d_model over data; heads, d_ff
# and vocabulary over model; no weight gathered), AdamW, 2 rows
SP_RUNS = (("a", "mamba2-2.7b", 2, ("train_4k", "train_sp"), True,
            "adamw8bit", 4),
           ("b", "internlm2-1.8b", 1, ("train_4k", "decode2d"), False,
            "adamw", 2))
SP_SHAPE, SP_SEQ = (2, 2), 1024
SP_AXES = ("data", "model")


def run_rules(cfg, shape_name, override=None) -> str:
    """The name in ``models.sharding`` of a run's rules table:
    ``launch.specs.rules_for`` of ``cfg`` at the registry's shape
    ``shape_name``, given the ``NAMED_RULES`` entry ``override`` (or
    none)."""
    from repro_torch.configs import get_shape
    from repro_torch.launch.specs import rules_for
    from repro_torch.models import sharding as SH
    rules = rules_for(cfg, get_shape(shape_name),
                      SH.NAMED_RULES[override] if override else None)
    return next(k for k, v in vars(SH).items()
                if k.endswith("_RULES") and v is rules)


def serve_tp_prompt(np, cfg, B=SERVE_TP_B, S=SERVE_TP_S):
    """The first ``B`` of the model phase's requests (``make_requests``,
    seed 0, prompts under 512 tokens), left-padded with token 0 to ``S``
    (a longer one would keep its last ``S``): a (B, S) int32 array."""
    from repro_torch.launch.serve import make_requests
    # the model phase's requests: their max_new of 16 sets the lengths
    reqs = make_requests(cfg.vocab_size, 2 * B, 528, 16, 0)[:B]
    toks = np.zeros((B, S), np.int32)
    for j, p in enumerate(reqs):
        p = p[-S:]
        toks[j, S - len(p):] = p
    return toks


def synced(torch, dev) -> float:
    """The host clock after the device's queued work has ended."""
    sync(torch, dev)
    return time.perf_counter()


def serve_tp_steps(torch, cfg, params, toks, forced, ctx, new, dev):
    """One wave through the serving entry points a user calls
    (``make_prefill_step``, then ``make_serve_step`` on decode batches of
    one token), float32 caches of ``S + new`` positions, under ``ctx``
    (None: one process).  The decode is fed ``forced`` (B, new) tokens
    (teacher forcing: a near tie cannot change what follows) or, without
    it, its own greedy tokens.  Returns the logits (new, B, V) float32
    and the greedy tokens (B, new) on the host, the caches, each span's
    wall (ending in a synchronise), kernel launches, collectives (bytes,
    messages) by kind and axes and the bytes staged through the host."""
    from repro_torch.models import collectives as C
    from repro_torch.serve.decode import make_prefill_step, make_serve_step
    S = toks.shape[1]
    prompt = {"tokens": torch.as_tensor(toks, device=dev)}
    prefill = make_prefill_step(cfg, ctx, max_len=S + new,
                                cache_dtype=torch.float32)
    step = make_serve_step(cfg, ctx)
    out = {}

    def reading():
        coll = {f"{k} {'x'.join(a)}": (C.COLLECTIVE_BYTES[(k, a)],
                                       C.COLLECTIVE_MSGS[(k, a)])
                for k, a in sorted(C.COLLECTIVE_BYTES)}
        return {"launches": read_counters(), "collectives": coll,
                "staged": dict(C.STAGED),
                "param_gathers": dict(C.PARAM_GATHERS)}
    with torch.no_grad():
        synced(torch, dev)
        reset_counters()
        C.reset_collectives()
        t0 = time.perf_counter()
        logits, caches = prefill(params, prompt)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out["prefill_s"] = synced(torch, dev) - t0
        out["prefill"] = reading()
        steps, own = [logits], [tok]
        reset_counters()
        C.reset_collectives()
        t0 = time.perf_counter()
        for t in range(1, new):
            feed = tok if forced is None else torch.as_tensor(
                forced[:, t - 1], device=dev)
            tok, logits, caches = step(params, {"tokens": feed[:, None]},
                                       caches, S + t - 1)
            steps.append(logits)
            own.append(tok)
        out["decode_s"] = synced(torch, dev) - t0
        out["decode"] = reading()
    out["logits"] = torch.stack(steps).cpu()
    out["tokens"] = torch.stack(own, dim=1).cpu().numpy()
    out["caches"] = caches
    return out


def model_launches(reading: dict) -> dict:
    return {k: reading[k] for k in ("flash_attention", "ssd_chunk")}


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for pair in caches
               for t in pair)


def serve_tp_one_process(torch, np, cfg, toks, logits_path, device):
    """The comparator of a phase 9c run: the seeded parameters on the
    card, one wave greedy in this process; its logits written to the
    float32 file ``logits_path``, its tokens, walls, digest and peak
    returned, and the card freed."""
    from repro_torch.models.model import init_model_params
    card_run = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    params = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    out = {"digest": tree_digest(torch, params).tolist(),
           "init_s": time.perf_counter() - t0}
    if card_run:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = serve_tp_steps(torch, cfg, params, toks, None, None,
                         SERVE_TP_NEW, torch.device(device))
    out["peak"] = torch.cuda.max_memory_allocated() if card_run else None
    np.save(logits_path, run.pop("logits").numpy())
    out["cache_bytes"] = cache_bytes(run.pop("caches"))
    out.update(run)
    del params
    if card_run:
        torch.cuda.empty_cache()
    return out


def serve_tp_rank(runs, shape, work, ones, device, sp=None):
    """One rank of phase 9c, for each of ``runs`` (tag, config, rules,
    gather_fsdp, prompt) on the mesh ``shape`` in turn: the seeded
    parameters drawn a leaf at a time, one rank after another (one whole
    leaf on the card at once: llama3's embedding alone is 8.4 GB), cut
    to this rank's blocks; the wave served under the run's ctx, fed the
    one-process tokens (``ones[tag]``); checked against the one-process
    logits (a float32 file of ``work``) and tokens, the other ranks'
    tokens, the cache blocks, the parameter gathers (none under the
    no-regather tables) and the launches; then, with ``sp`` = (runs,
    comparators) on phase 9d's mesh, its runs in the same start
    (``sp_rank_run``).  Returns (the rows by tag, phase 9d's rows by tag
    or None); raises if a check failed."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(device)
    mesh = make_host_mesh(shape, SERVE_TP_AXES)
    rows = {}
    for tag, cfg, rules, gather_fsdp, toks in runs:
        rows[tag] = serve_tp_rank_run(cfg, rules, gather_fsdp, mesh, toks,
                                      Path(work) / f"logits_{tag}.npy",
                                      ones[tag], dev)
    if sp is None:
        return rows, None
    sp_runs, sp_ones = sp
    return rows, {tag: sp_rank_run(tag, cfg, rules, gf, opt_impl, batch, mesh,
                                   Path(work) / f"grads_sp_{tag}.npy",
                                   sp_ones[tag], dev)
                  for tag, cfg, rules, gf, opt_impl, batch in sp_runs}


def serve_tp_rank_run(cfg, rules, gather_fsdp, mesh, toks, logits_path,
                      one, dev):
    """One run of ``serve_tp_rank``: the row; raises if a check failed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_param
    from repro_torch.utils.tree import tree_unflatten
    t_start = time.perf_counter()
    card_run = dev.type == "cuda"
    rank, world = dist.get_rank(), dist.get_world_size()
    ctx = SH.ShardingCtx(mesh, getattr(SH, rules), gather_fsdp=gather_fsdp)
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks, digest = [], []
    for pspec, spec in zip(SH.spec_leaves(param_specs(cfg)),
                           SH.spec_leaves(SH.param_shardings(
                               param_specs(cfg), ctx))):
        for r in range(world):
            if r == rank:
                leaf = init_param(pspec, gen, torch.float32)
                digest.append(leaf_digest(torch, leaf))
                blocks.append(SH.owned_block(leaf, spec, mesh))
                del leaf
                if card_run:
                    torch.cuda.empty_cache()
            dist.barrier()
    if torch.cat(digest).tolist() != one["digest"]:
        raise AssertionError(f"rank {rank}: parameters differ from the "
                             "one-process run's")
    params = tree_unflatten(param_specs(cfg), blocks)
    del blocks
    param_bytes = sum(t.numel() * t.element_size() for t in
                      SH.spec_leaves(params))
    if card_run:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    forced = one["tokens"]
    run = serve_tp_steps(torch, cfg, params, toks, forced, ctx,
                         SERVE_TP_NEW, dev)
    peak = torch.cuda.max_memory_allocated(dev) if card_run else None
    t_check = time.perf_counter()
    want = torch.from_numpy(np.load(logits_path))
    got = run.pop("logits")
    err = float((got - want).abs().max())
    # greedy tokens: equal to the one-process ones but at near ties of
    # its logits (the two tokens' logits within TWIN_TOL)
    mine = torch.from_numpy(run["tokens"]).long()
    ref_t = torch.from_numpy(forced).long()
    differ = (mine != ref_t)
    gap = (want.gather(-1, ref_t.T[..., None])
           - want.gather(-1, mine.T[..., None]))[..., 0].T
    ties = int(differ.sum())
    tie_ok = bool((gap[differ].abs() <= TWIN_TOL).all())
    theirs = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(theirs, mine)
    ranks_equal = all(torch.equal(t, mine) for t in theirs)
    # every cache buffer is this rank's block; the KV cache's positions
    # (or the SSM caches' channels and heads) split as the spec says
    specs = SH.cache_specs(cfg, ctx, toks.shape[0], toks.shape[1]
                           + SERVE_TP_NEW)
    full = SH.cache_shapes(cfg, toks.shape[0], toks.shape[1] + SERVE_TP_NEW)
    blocks_ok = all(
        tuple(t.shape) == ctx.block_shape(f, s) and any(e is not None
                                                        for e in s[2:])
        for pair, fs, ss in zip(run["caches"], full, specs)
        for t, f, s in zip(pair, fs, ss))
    positions = [t.shape[2] for (t, _), ls in zip(run["caches"], cfg.pattern)
                 if ls.kind == "attn"]
    n_dec = SERVE_TP_NEW - 1
    row = {"rank": rank, "device": str(dev), "setup_s": setup_s,
           "prefill_s": run["prefill_s"],
           "decode_ms_per_token": run["decode_s"] / n_dec * 1e3,
           "prefill": run["prefill"], "decode": run["decode"],
           "decode_per_token": {k: (b / n_dec, m / n_dec) for k, (b, m) in
                                run["decode"]["collectives"].items()},
           "peak": peak, "param_bytes": param_bytes,
           "cache_bytes": cache_bytes(run["caches"]),
           "kv_positions": positions, "cache_specs": specs,
           "logits_err": err, "near_ties": ties, "ranks_equal": ranks_equal,
           "blocks_ok": blocks_ok}
    del run, params
    if card_run:
        torch.cuda.empty_cache()
    row["check_s"] = time.perf_counter() - t_check
    n = layer_counts(cfg)
    expect = n if card_run else dict.fromkeys(n, 0)
    pre, dec = row["prefill"]["launches"], row["decode"]["launches"]
    failed = [what for what, ok in (
        ("logits", err <= TWIN_TOL), ("near ties", tie_ok),
        ("ranks' tokens", ranks_equal), ("cache blocks", blocks_ok),
        ("parameter gathers", gather_fsdp or not
         row["prefill"]["param_gathers"]["messages"]
         + row["decode"]["param_gathers"]["messages"]),
        ("prefill launches", all(pre[k] == v for k, v in expect.items())),
        ("decode launches", all(dec[k] == 0 for k in expect)))
        if not ok]
    if failed:
        raise AssertionError(f"rank {rank}: {failed} failed; row {row}")
    return row


def serve_tp_phase(torch, np, card, device="cuda", runs=SERVE_TP_RUNS,
                   configs=None, sp_runs=SP_RUNS, sp_configs=None,
                   sp_seq=SP_SEQ):
    """Phases 9c and 9d (see the module's note).  The runs on one mesh
    share one start of their ranks: each run's one-process comparator
    first (each freeing the card), then the ranks serve the runs in
    turn; on phase 9d's mesh they then take its sharded steps
    (``sp_runs``; none when empty).  Returns (rows, the serve-tp path's
    launches: the ranks' prefills', phase 9d's rows and the sp path's
    launches).  ``device="cpu"`` with ``configs`` and ``sp_configs``
    (tag -> a small config) and a short ``sp_seq`` rehearses it on the
    CPU."""
    import gc
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.ranks import spawn_ranks
    card_run = torch.device(device).type == "cuda"
    out, launches, sp_out, sp_launches = {}, {}, {}, {}
    shapes = list(dict.fromkeys(shape for *_, shape in runs))
    if sp_runs and SP_SHAPE not in shapes:
        raise ValueError(f"phase 9d's mesh {SP_SHAPE} is none of 9c's")
    for shape in shapes:
        group = [r for r in runs if r[-1] == shape]
        work = ROOT / "build" / "serve_tp_smoke"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        plan, ones, one_s = [], {}, {}
        for tag, arch, depth, rules, gf, _ in group:
            cfg = (configs or {}).get(tag) or get_config(arch)
            if depth is not None:
                cfg = dataclasses.replace(cfg, n_layers=depth)
            if card_run:
                gc.collect()
                torch.cuda.empty_cache()
            toks = serve_tp_prompt(np, cfg)
            t0 = time.perf_counter()
            ones[tag] = serve_tp_one_process(torch, np, cfg, toks,
                                             work / f"logits_{tag}.npy",
                                             device)
            one_s[tag] = time.perf_counter() - t0
            plan.append((tag, cfg, run_rules(cfg, *rules), gf, toks))
        sp = None
        if sp_runs and shape == SP_SHAPE:
            sp = sp_comparators(torch, np, sp_runs, work, device,
                                sp_configs, sp_seq)
        if card_run:
            gc.collect()
            torch.cuda.empty_cache()
            parent = (torch.cuda.memory_allocated(),
                      torch.cuda.memory_reserved())
        t0 = time.perf_counter()
        got = spawn_ranks(
            int(np.prod(shape)), "chip_smoke:serve_tp_rank",
            (plan, shape, str(work),
             {t: {"digest": o["digest"], "tokens": o["tokens"]}
              for t, o in ones.items()}, device, sp and sp[:2]),
            backend="gloo", init_method=f"file://{work / 'store'}",
            timeout_s=900)
        ranks_s = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)
        ranks = [r for r, _ in got]
        if sp is not None:
            sp_out, sp_launches = sp_report(sp, [r for _, r in got],
                                            ranks_s, card)
        print(f"serve-tp {[t for t, *_ in plan]}: {len(ranks)} ranks on "
              f"{ranks[0][plan[0][0]]['device']} over gloo, "
              f"{dict(zip(SERVE_TP_AXES, shape))}, {ranks_s:.1f} s with "
              f"their start (this process holding "
              f"{parent if card_run else None} B allocated, reserved); "
              f"{card}", flush=True)
        for tag, cfg, rules, gf, toks in plan:
            rows = [r[tag] for r in ranks]
            one, r0 = ones[tag], rows[0]
            for r in rows:
                for k, v in r["prefill"]["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            print(f"serve-tp ({tag}) {cfg.name} width {cfg.d_model}, "
                  f"{cfg.n_layers} layers ({cfg.param_count()} params, "
                  f"f32), mesh {dict(zip(SERVE_TP_AXES, shape))} {rules} "
                  f"gather_fsdp={gf}, {toks.shape[0]} x {toks.shape[1]} "
                  f"prompt + {SERVE_TP_NEW} new: one process prefill "
                  f"{one['prefill_s']:.4f} s, decode "
                  f"{one['decode_s'] / (SERVE_TP_NEW - 1) * 1e3:.3f} ms a "
                  f"token, peak {one['peak']} B, caches "
                  f"{one['cache_bytes']} B (with set-up {one_s[tag]:.1f} s)"
                  f"; {card}", flush=True)
            print(f"serve-tp ({tag}) ranks: prefill "
                  f"{[round(r['prefill_s'], 4) for r in rows]} s, decode "
                  f"{[round(r['decode_ms_per_token'], 3) for r in rows]} ms "
                  f"a token (set-up {r0['setup_s']:.1f} s, checks "
                  f"{r0['check_s']:.1f} s); logits err "
                  f"{max(r['logits_err'] for r in rows):.3e} (tol "
                  f"{TWIN_TOL}), near ties {r0['near_ties']}, ranks' tokens "
                  f"equal {all(r['ranks_equal'] for r in rows)}, cache "
                  f"blocks {all(r['blocks_ok'] for r in rows)} (KV "
                  f"positions a rank {sorted(set(r0['kv_positions']))}, "
                  f"cache {r0['cache_bytes']} B a rank against "
                  f"{one['cache_bytes']} B); parameters "
                  f"{r0['param_bytes']} B a rank, gathered in prefill "
                  f"{r0['prefill']['param_gathers']} and decode "
                  f"{r0['decode']['param_gathers']}; peak "
                  f"{[r['peak'] for r in rows]} B a rank; launches prefill "
                  f"{model_launches(r0['prefill']['launches'])} decode "
                  f"{model_launches(r0['decode']['launches'])} a rank; "
                  "backend gloo", flush=True)
            print(f"serve-tp ({tag}) a rank's collectives (bytes, "
                  f"messages): prefill {r0['prefill']['collectives']}, "
                  f"staged {r0['prefill']['staged']}; decode a token "
                  f"{r0['decode_per_token']}, staged "
                  f"{r0['decode']['staged']} in {SERVE_TP_NEW - 1} tokens",
                  flush=True)
            one["tokens"] = one["tokens"].tolist()
            out[tag] = {"one_process": one, "ranks": rows,
                        "one_s": one_s[tag], "ranks_s": ranks_s,
                        "mesh": list(shape)}
    return out, launches, sp_out, sp_launches


# ---------------------------------------------------------------------------
# phase 9d: training under the serving half's mechanisms (slice M)
# ---------------------------------------------------------------------------



def sp_hp(opt_impl, seq=SP_SEQ):
    from repro_torch.train.train_step import TrainHParams
    return TrainHParams(lr=3e-4, warmup=2, total_steps=100, remat="full",
                        ce_chunk=min(1024, seq), opt_impl=opt_impl)


def sp_zero_state(torch, cfg, ctx, params, opt_impl):
    """This rank's blocks of the zero optimiser state, laid out as
    ``sharding.opt_shardings`` lays it out, made on the blocks (no whole
    leaf): AdamW's moments as the parameters' blocks; the int8 codes as
    the parameter's block and the scales as their own spec's."""
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import param_specs
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.optim.quantized import scale_shape
    from repro_torch.utils.tree import tree_leaves, tree_unflatten
    if opt_impl == "adamw":
        return init_opt_state(params)
    out = []
    for s, p in zip(SH.spec_leaves(param_specs(cfg)), tree_leaves(params)):
        sc = ctx.block_shape(scale_shape(s.shape), SH.q8_specs(s, ctx)[1])
        out.append({"m_q": torch.zeros_like(p, dtype=torch.int8),
                    "m_s": torch.zeros(sc, device=p.device),
                    "v_q": torch.zeros_like(p, dtype=torch.int8),
                    "v_s": torch.zeros(sc, device=p.device)})
    return tree_unflatten(params, out)


def sp_one_process(torch, np, cfg, hp, batch, grads_path, device):
    """The comparator of a phase 9d run: the one-process ``make_train_step``
    step from the seeded parameters on the card; its gradients written to
    the float32 file ``grads_path`` (one vector, leaves in order), its
    scalars, per-leaf largest |gradient|, digest, wall and peak returned,
    and the card freed."""
    from repro_torch.models.model import init_model_params
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.optim.quantized import init_opt_state_q8
    from repro_torch.train import train_step as T
    from repro_torch.utils.tree import tree_leaves
    card_run = torch.device(device).type == "cuda"
    tbatch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    params = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    out = {"digest": tree_digest(torch, params).tolist(),
           "sizes": [p.numel() for p in tree_leaves(params)]}
    opt = (init_opt_state_q8(params) if hp.opt_impl == "adamw8bit"
           else init_opt_state(params))
    if card_run:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new_p, new_o, m, grads = T.make_train_step(cfg, hp)(
        params, opt, tbatch, 0, with_grads=True)
    out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               lr=float(m["lr"]), wall_s=time.perf_counter() - t0)
    out["peak"] = torch.cuda.max_memory_allocated() if card_run else None
    out["opt_bytes"] = sum(t.numel() * t.element_size()
                           for t in tree_leaves(new_o))
    del new_p, new_o, opt
    out["grad_max"] = [float(g.abs().max()) for g in tree_leaves(grads)]
    t0 = time.perf_counter()
    f = np.lib.format.open_memmap(grads_path, mode="w+", dtype=np.float32,
                                  shape=(sum(out["sizes"]),))
    off = 0
    for leaf in tree_leaves(grads):
        n = leaf.numel()
        f[off:off + n] = leaf.reshape(-1).cpu().numpy()
        off += n
    del f, grads, params
    out["write_s"] = time.perf_counter() - t0
    if card_run:
        torch.cuda.empty_cache()
    return out


def sp_saved_positions(torch, cfg, hp, ctx, params, tbatch, seq):
    """The positions of the residual each checkpoint of the loss's
    forward saves (a forward alone, under ``hp.remat``): the dim 1 of
    every saved tensor of this rank's (rows, *, d_model) shape whose
    positions are the sequence's or a block of it."""
    from repro_torch.models.model import loss_fn
    from repro_torch.train import train_step as T
    from repro_torch.utils.tree import tree_leaves, tree_unflatten
    layout = T.batch_layout(cfg, ctx, tbatch)
    rows = tbatch["targets"].shape[0] // layout.n_blocks
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    saved = []

    def pack(t):
        if t.dim() == 3 and t.shape[0] == rows \
                and t.shape[2] == cfg.d_model and seq % t.shape[1] == 0:
            saved.append(int(t.shape[1]))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss_fn(cfg, tree_unflatten(params, leaves),
                T.local_rows(cfg, tbatch, layout), attn_impl=hp.attn_impl,
                remat=hp.remat, ce_chunk=hp.ce_chunk, layout=layout)
    return saved


def sp_rank_run(tag, cfg, rules, gather_fsdp, opt_impl, batch, mesh,
                grads_path, one, dev):
    """One run of ``sp_rank``: the seeded parameters drawn a leaf at a
    time and cut to this rank's blocks; the sharded step under the run's
    ctx from the zero optimiser state; checked against the one-process
    step (loss, grad norm, gradient blocks from ``grads_path``), the
    sharded optimiser on the one-process gradients against the
    one-process optimiser on them (int8 codes and scales bit-equal, or
    AdamW within ``TRAIN_OPT_TOL``), the replicas, the saved boundary's
    positions (``seq_sp``), the parameter gathers (none without
    ``gather_fsdp``) and the launches.  Returns the row."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.models import collectives as C
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_param
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.optim.quantized import (adamw8bit_update,
                                             init_opt_state_q8)
    from repro_torch.train import train_step as T
    from repro_torch.utils.tree import (tree_flatten, tree_leaves,
                                        tree_unflatten)
    t_start = time.perf_counter()
    card_run = dev.type == "cuda"
    rank, world = dist.get_rank(), dist.get_world_size()
    ctx = SH.ShardingCtx(mesh, getattr(SH, rules), gather_fsdp=gather_fsdp)
    hp = sp_hp(opt_impl, batch["targets"].shape[1])
    specs = T.leaf_specs(cfg, ctx)
    pspecs = SH.spec_leaves(param_specs(cfg))
    offs = np.cumsum([0] + one["sizes"])
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks, digest = [], []
    for pspec, spec in zip(pspecs, specs):
        leaf = init_param(pspec, gen, torch.float32)
        digest.append(leaf_digest(torch, leaf))
        blocks.append(SH.owned_block(leaf, spec, mesh))
        del leaf
    if torch.cat(digest).tolist() != one["digest"]:
        raise AssertionError(f"rank {rank}: parameters differ from the "
                             "one-process step's")
    params = tree_unflatten(param_specs(cfg), blocks)
    del blocks
    if card_run:
        torch.cuda.empty_cache()
    tbatch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    opt = sp_zero_state(torch, cfg, ctx, params, opt_impl)
    opt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(opt))
    adamw_bytes = 8 * sum(t.numel() for t in tree_leaves(params))
    if card_run:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    reset_counters()
    C.reset_collectives()
    t0 = time.perf_counter()
    p2, o2, m, g = T.make_train_step(cfg, hp, ctx)(params, opt, tbatch, 0,
                                                   with_grads=True)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if card_run else None
    launched = read_counters()
    coll = {f"{k} {'x'.join(a)}": (C.COLLECTIVE_BYTES[(k, a)],
                                   C.COLLECTIVE_MSGS[(k, a)])
            for k, a in sorted(C.COLLECTIVE_BYTES)}
    staged, gathers = dict(C.STAGED), dict(C.PARAM_GATHERS)
    t_check = time.perf_counter()
    row = {"rank": rank, "device": str(dev), "wall_s": wall,
           "setup_s": setup_s, "loss": loss, "grad_norm": gnorm,
           "loss_err": abs(loss - one["loss"]),
           "grad_norm_rel_err": abs(gnorm - one["grad_norm"])
           / one["grad_norm"], "collectives": coll, "staged": staged,
           "param_gathers": gathers, "peak": peak, "launches": launched,
           "opt_bytes": opt_bytes, "adamw_bytes": adamw_bytes}
    # every block held by several ranks: the same bits on each
    ospecs = SH.spec_leaves(SH.opt_shardings(param_specs(cfg), ctx,
                                             opt_impl))
    mine = tree_digest(torch, [p2, o2, g])
    theirs = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(theirs, mine)
    keys = [[tuple(mesh.block_index(SH.entry_axes(e), r) if e else 0
                   for e in spec) for r in range(world)]
            for spec in specs + ospecs + specs]
    row["replicas_equal"] = all(
        torch.equal(theirs[r][2 * j:2 * j + 2], mine[2 * j:2 * j + 2])
        for j, ks in enumerate(keys) for r in range(world)
        if ks[r] == ks[rank])
    del p2, o2
    # the gradient blocks against the one-process step's
    grads_f = np.load(grads_path, mmap_mode="r")

    def whole(i):
        return grads_f[offs[i]:offs[i + 1]].reshape(pspecs[i].shape)

    def block(i, spec):
        a = whole(i)
        for dim, e in enumerate(spec):
            axes = SH.entry_axes(e)
            if axes:
                n = a.shape[dim] // mesh.size(axes)
                a = np.take(a, range(mesh.block_index(axes) * n,
                                     (mesh.block_index(axes) + 1) * n),
                            axis=dim)
        return torch.from_numpy(np.array(a)).to(dev)
    worst, ref_blocks = (0.0, None), []
    for i, ((k, leaf), spec) in enumerate(zip(tree_flatten(g), specs)):
        want = block(i, spec)
        e = float((leaf - want).abs().max()) / max(one["grad_max"][i],
                                                    1e-30)
        if e > worst[0]:
            worst = (e, k)
        ref_blocks.append(want)
    row.update(grad_err=worst[0], grad_err_leaf=worst[1])
    ref_grads = tree_unflatten(g, ref_blocks)
    del g, ref_blocks
    # the sharded optimiser on the one-process gradients against the
    # one-process optimiser on the same gradients and square norm, a
    # leaf at a time (elementwise given the clip's scale; a whole leaf on
    # the card at once)
    lr = torch.tensor(one["lr"], dtype=torch.float32, device=dev)
    sq = T.sharded_sq_norm(ref_grads, specs, mesh)
    q8 = T.q8_shards(cfg, ctx) if opt_impl == "adamw8bit" else None
    q2, qo, _ = T.apply_sharded_update(params, ref_grads, opt, 0, lr, hp,
                                       specs, mesh, q8)
    row["opt_err"] = 0.0
    if opt_impl == "adamw8bit":
        row["opt_bits_equal"] = True
        state = tree_leaves(qo)
        for i, (pspec, spec) in enumerate(zip(pspecs, specs)):
            full_g = torch.from_numpy(np.array(whole(i))).to(dev)
            zero = torch.zeros_like(full_g)
            _, st, _ = adamw8bit_update([zero], [full_g],
                                        init_opt_state_q8([zero]), 0, lr,
                                        hp.adamw, sq_norm=sq)
            del full_g, zero
            got = state[4 * i:4 * i + 4]        # m_q, m_s, v_q, v_s
            sspec = SH.q8_specs(pspec, ctx)
            for (name, want), t in zip(sorted(st[0].items()), got):
                sp = sspec[0] if name.endswith("_q") else sspec[1]
                want_b = SH.local_block(want, sp, mesh)
                if not torch.equal(want_b, t):
                    row["opt_bits_equal"] = False
                    row["opt_err"] = max(row["opt_err"], float(
                        (want_b.float() - t.float()).abs().max()))
            del st
    else:
        norm = torch.sqrt(sq)
        scale = torch.clamp(hp.adamw.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        no_clip = dataclasses.replace(hp.adamw, clip_norm=None)
        for p_, g_, got in zip(tree_leaves(params), tree_leaves(ref_grads),
                               tree_leaves(q2)):
            want_p = adamw_update([p_], [g_ * scale], init_opt_state([p_]),
                                  0, lr, no_clip)[0][0]
            row["opt_err"] = max(row["opt_err"], float(
                (got - want_p).abs().max()))
            del want_p
    del q2, qo, ref_grads, grads_f
    # the residual each checkpoint saves: this rank's block of positions
    # over the seq_sp axes
    seq = batch["targets"].shape[1]
    row["saved_positions"] = sp_saved_positions(torch, cfg, hp, ctx, params,
                                                tbatch, seq)
    layout = T.batch_layout(cfg, ctx, tbatch)
    row["sp_block"] = seq // (mesh.size(layout.sp_axes) if layout.sp_axes
                              else 1)
    del params, opt
    if card_run:
        torch.cuda.empty_cache()
    row["check_s"] = time.perf_counter() - t_check
    n = layer_counts(cfg)
    expect = {k: 2 * v if card_run else 0 for k, v in n.items()}
    # under seq_sp nothing else saves (rows, S / n, d_model)
    saved_ok = not layout.sp_axes or (row["saved_positions"].count(
        row["sp_block"]) == cfg.n_superblocks)
    failed = [what for what, ok in (
        ("loss", np.isfinite(loss) and row["loss_err"] <= TRAIN_LOSS_TOL),
        ("grad norm", row["grad_norm_rel_err"] <= TRAIN_NORM_RTOL),
        ("gradients", row["grad_err"] <= TRAIN_GRAD_TOL),
        ("optimiser", row.get("opt_bits_equal", True)
         and row["opt_err"] <= TRAIN_OPT_TOL),
        ("replicas", row["replicas_equal"]),
        ("saved boundary", saved_ok),
        ("parameter gathers", gather_fsdp or not gathers["messages"]),
        ("launches", all(launched[k] == v for k, v in expect.items())))
        if not ok]
    if failed:
        raise AssertionError(f"rank {rank} ({tag}): {failed} failed; row "
                             f"{row}")
    row["run_s"] = time.perf_counter() - t_start
    return row


def sp_comparators(torch, np, runs, work, device, configs=None, seq=SP_SEQ):
    """Phase 9d's one-process steps, one a run (its gradients to
    ``work``'s ``grads_sp_<tag>.npy``, the card freed after each): the
    runs as the ranks take them, their comparators and walls."""
    import gc
    from repro_torch.configs import get_config
    card_run = torch.device(device).type == "cuda"
    plan, ones, one_s = [], {}, {}
    for tag, arch, depth, rules, gf, opt_impl, B in runs:
        cfg = (configs or {}).get(tag) or dataclasses.replace(
            get_config(arch), n_layers=depth)
        batch = train_batch(np, cfg, B, seq)
        t0 = time.perf_counter()
        ones[tag] = sp_one_process(torch, np, cfg, sp_hp(opt_impl, seq),
                                   batch, work / f"grads_sp_{tag}.npy",
                                   device)
        one_s[tag] = time.perf_counter() - t0
        plan.append((tag, cfg, run_rules(cfg, *rules), gf, opt_impl,
                     batch))
        if card_run:
            gc.collect()
            torch.cuda.empty_cache()
    return plan, ones, one_s


def sp_report(sp, ranks, ranks_s, card):
    """Phase 9d's lines from the comparators ``sp`` (``sp_comparators``)
    and the ranks' rows: (rows, the sp path's launches: the ranks'
    steps')."""
    plan, ones, one_s = sp
    out, launches = {}, {}
    walls = [sum(r[t]["run_s"] for t in r) for r in ranks]
    print(f"sp {[t for t, *_ in plan]}: {len(ranks)} ranks on "
          f"{ranks[0][plan[0][0]]['device']} over gloo in serve-tp's start, "
          f"{dict(zip(SP_AXES, SP_SHAPE))}; the runs "
          f"{max(walls):.1f} s a rank (the start and serving: "
          f"{ranks_s - max(walls):.1f} s), the comparators "
          f"{sum(one_s.values()):.1f} s; {card}", flush=True)
    for tag, cfg, rules, gf, opt_impl, batch in plan:
        rows = [r[tag] for r in ranks]
        one, r0 = ones[tag], rows[0]
        for r in rows:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        B, S = batch["targets"].shape
        print(f"sp ({tag}) {cfg.name} width {cfg.d_model}, {cfg.n_layers} "
              f"layers ({cfg.param_count()} params, f32), mesh "
              f"{dict(zip(SP_AXES, SP_SHAPE))} {rules} gather_fsdp={gf}, "
              f"{opt_impl}, global batch {B} x {S}, remat full: one-process "
              f"step {one['wall_s']:.3f} s, peak {one['peak']} B, optimiser "
              f"state {one['opt_bytes']} B, gradients to the host file "
              f"{one['write_s']:.1f} s (with set-up {one_s[tag]:.1f} s); "
              f"{card}", flush=True)
        print(f"sp ({tag}) ranks: step wall "
              f"{[round(r['wall_s'], 3) for r in rows]} s (set-up "
              f"{r0['setup_s']:.1f} s, checks {r0['check_s']:.1f} s), loss "
              f"{r0['loss']:.6f} (one-process {one['loss']:.6f}, err "
              f"{max(r['loss_err'] for r in rows):.3e}), grad norm rel err "
              f"{max(r['grad_norm_rel_err'] for r in rows):.3e}, worst "
              f"gradient leaf {r0['grad_err_leaf']} "
              f"{max(r['grad_err'] for r in rows):.3e} of its largest value, "
              f"{opt_impl} on the one-process gradients: bits equal "
              f"{all(r.get('opt_bits_equal', True) for r in rows)}, err "
              f"{max(r['opt_err'] for r in rows):.3e}; replicas equal "
              f"{all(r['replicas_equal'] for r in rows)}; saved boundary "
              f"positions {sorted(set(r0['saved_positions']))} (block "
              f"{r0['sp_block']} of {S}); parameters gathered "
              f"{r0['param_gathers']}; peak {[r['peak'] for r in rows]} B a "
              f"rank; optimiser state {r0['opt_bytes']} B a rank (AdamW's "
              f"{r0['adamw_bytes']} B); launches "
              f"{model_launches(r0['launches'])} a rank; backend gloo",
              flush=True)
        print(f"sp ({tag}) a rank's collectives (bytes, messages): "
              f"{r0['collectives']}, staged {r0['staged']}", flush=True)
        out[tag] = {"one_process": {k: v for k, v in one.items()
                                    if k not in ("digest",)},
                    "ranks": rows, "one_s": one_s[tag], "ranks_s": ranks_s}
    return out, launches

# ---------------------------------------------------------------------------
# launch phase: launch analysis (slice N)
# ---------------------------------------------------------------------------


def collective_rows(C) -> dict:
    """The collectives' counters as phase 9d's rows keep them:
    ``"<kind> <axes>"`` -> (bytes, messages)."""
    return {f"{k} {'x'.join(a)}": (C.COLLECTIVE_BYTES[(k, a)],
                                   C.COLLECTIVE_MSGS[(k, a)])
            for k, a in sorted(C.COLLECTIVE_BYTES)}


def launch_phase(torch, np, card, trains, sps, cfg=None, sp_cfg=None,
                 sp_seq=SP_SEQ):
    """Slice N, the launch analysis, on walls and counters that earlier
    phases took (no step runs on the card).  (a) The train phase's cell
    (``cfg``, by default internlm2-1.8b whole; float32, the train phase's
    batch and sequence, remat "full", AdamW) counted on ``meta`` as rank
    0 of a one-rank ``AbstractMesh``: counted FLOPs and ``model_flops``,
    the model TFLOP/s of each over the train phase's step walls, the
    roofline bound and its dominant term at ``PEAK_FLOPS_F32``, and
    ``total_live`` beside the train phase's ``max_memory_allocated``.
    Checks: ``memory_per_device.arguments`` equal to the bytes the train
    phase held as parameters, optimiser state and batch, and no kernel
    launched.  (b) Phase 9d's cell (b) (``sp_cfg``, by default
    internlm2-1.8b at full width, 1 layer; ``DECODE_2D_RULES`` with
    ``gather_fsdp=False``, AdamW, 2 x ``sp_seq``) on an ``AbstractMesh``
    at each of its 4 ranks: every rank's ``COLLECTIVE_BYTES`` and
    ``COLLECTIVE_MSGS`` by (kind, axes) equal to what that rank counted
    in 9d, and no parameter gathered.  Returns the rows; raises if a
    check failed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import (count_step, peak_flops,
                                           roofline_terms)
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.specs import model_flops
    from repro_torch.models import collectives as C
    from repro_torch.models import sharding as SH
    rows = {}

    # (a) the train phase's cell
    full = trains["full"]
    cfg = cfg or get_config(TRAIN_ARCH)
    shape = ShapeConfig("train", "train", full["seq"], full["batch"])
    reset_counters()
    mem, st, count_s = count_step(
        cfg, shape, AbstractMesh((1, 1), ("data", "model")),
        hp=sp_hp("adamw", full["seq"]), param_dtype=torch.float32)
    launched = read_counters()
    mf = model_flops(cfg, shape)
    roof = roofline_terms(st, 1, mf, peak_flops(torch.float32))
    held = sum(full["held_bytes"].values())
    peak = full["max_memory_allocated"]
    ratio = mem["total_live"] / peak if peak else None
    rows["train"] = {
        "arch": cfg.name, "batch": full["batch"], "seq": full["seq"],
        "count_s": count_s, "flops": st.flops, "model_flops": mf,
        "dot_count": st.dot_count, "ops": st.ops,
        "tflops_counted": [st.flops / w / 1e12 for w in full["walls_s"]],
        "tflops_model": [mf / w / 1e12 for w in full["walls_s"]],
        "memory_per_device": mem, "held_bytes": full["held_bytes"],
        "max_memory_allocated": peak, "live_over_peak": ratio,
        "roofline": roof, "launches": launched}
    print(f"launch (a) {cfg.name}, {cfg.n_layers} layers, f32, batch "
          f"{full['batch']} x {full['seq']}, remat full, AdamW, counted on "
          f"meta in {count_s:.2f} s ({st.ops} ops, {st.dot_count:.0f} "
          f"matmuls): counted {st.flops:.6e} FLOPs, model_flops {mf:.6e} "
          f"(model/counted {mf / st.flops:.4f}); TFLOP/s over the train "
          f"phase's step walls: counted "
          f"{[round(t, 2) for t in rows['train']['tflops_counted']]}, "
          f"model {[round(t, 2) for t in rows['train']['tflops_model']]}; "
          f"roofline at {roof['peak_flops']:.4g} FLOP/s: compute "
          f"{roof['t_compute_s']:.4f} s, memory {roof['t_memory_s']:.4f} "
          f"s, bound {roof['bound_s']:.4f} s ({roof['dominant']}); "
          f"total_live {mem['total_live']} B (arguments "
          f"{mem['arguments']} + created {mem['peak_created']}) against "
          f"max_memory_allocated {peak} B, ratio "
          f"{ratio if ratio is None else round(ratio, 4)}; {card}",
          flush=True)
    failed = [what for what, ok in (
        ("arguments", mem["arguments"] == held),
        ("launches", not any(launched.values()))) if not ok]
    if failed:
        raise AssertionError(f"launch (a): {failed}: arguments "
                             f"{mem['arguments']} B against {held} B held "
                             f"({full['held_bytes']}), launches {launched}")

    # (b) phase 9d's cell (b) at each of its ranks
    tag, arch, depth, rules, gf, opt_impl, B = next(
        r for r in SP_RUNS if r[0] == "b")
    sp_cfg = sp_cfg or dataclasses.replace(get_config(arch),
                                           n_layers=depth)
    table = getattr(SH, run_rules(sp_cfg, *rules))
    shape = ShapeConfig("sp", "train", sp_seq, B)
    ranks = sps[tag]["ranks"]
    got, t0 = [], time.perf_counter()
    for r in range(len(ranks)):
        _, st, _ = count_step(
            sp_cfg, shape, AbstractMesh(SP_SHAPE, SP_AXES, r),
            hp=sp_hp(opt_impl, sp_seq), param_dtype=torch.float32,
            rules_override=table, gather_fsdp=gf)
        got.append({"rank": r, "collectives": collective_rows(C),
                    "param_gathers": dict(C.PARAM_GATHERS),
                    "flops": st.flops})
    count_s = time.perf_counter() - t0
    bad = [r for r, (g, row) in enumerate(zip(got, ranks))
           if row["rank"] != r or g["collectives"] != row["collectives"]
           or g["param_gathers"]["messages"] or g["param_gathers"]["bytes"]]
    rows["sp"] = {"arch": sp_cfg.name, "layers": sp_cfg.n_layers,
                  "rules": run_rules(sp_cfg, *rules), "count_s": count_s,
                  "ranks": got, "equal": not bad}
    print(f"launch (b) {sp_cfg.name}, {sp_cfg.n_layers} layer(s), "
          f"{rows['sp']['rules']} gather_fsdp={gf}, mesh "
          f"{dict(zip(SP_AXES, SP_SHAPE))}, batch {B} x {sp_seq}: "
          f"{len(got)} abstract ranks counted in {count_s:.2f} s; a rank's "
          f"collectives (bytes, messages) {got[0]['collectives']}, counted "
          f"FLOPs {[g['flops'] for g in got]}; equal to 9d's ranks "
          f"{not bad}, parameters gathered "
          f"{[g['param_gathers']['messages'] for g in got]}", flush=True)
    if bad:
        raise AssertionError(
            f"launch (b): ranks {bad} differ from phase 9d's: abstract "
            f"{[got[r] for r in bad]}, 9d "
            f"{[(ranks[r]['rank'], ranks[r]['collectives']) for r in bad]}")
    return rows


# ---------------------------------------------------------------------------
# main-path phase
# ---------------------------------------------------------------------------


def main_points():
    pts = []
    for series in ("samhita", "samhita_page"):
        pts.append(("fig2_strong", series, series, "stream", None, N_TRIAD))
        pts.append(("fig3_weak", series, series, "stream", None, N_TRIAD * W))
        n_weak = int(N_JACOBI * W ** 0.5)
        n_weak -= n_weak % max(W, 64)
        for mode in ("lock", "reduction"):
            tag = f"{series}_{mode}"
            pts.append(("fig5_strong", tag, series, "jacobi", mode, N_JACOBI))
            pts.append(("fig6_weak", tag, series, "jacobi", mode, n_weak))
            pts.append(("fig7_md", tag, series, "md", mode, N_PARTICLES))
    return pts


def run_point(torch, make_runtime, apps, IB_2013, app, series, mode, n,
              backend):
    t0 = time.perf_counter()
    rt = make_runtime(W, protocol=PROTO[series], cost=IB_2013,
                      fetch_batch=16, backend=backend, device="cuda")
    if app == "stream":
        apps.stream_triad(rt, n, ITERS, driver="batched")
    elif app == "jacobi":
        apps.jacobi(rt, n, ITERS, mode=mode, driver="batched")
    else:
        apps.molecular_dynamics(rt, n, ITERS, mode=mode, driver="batched")
    torch.cuda.synchronize()
    return rt, time.perf_counter() - t0


def main_path_phase(torch, ps):
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    rows = {(r["section"], r["protocol"], r["W"], r.get("driver")): r
            for r in json.loads(
                (ROOT / "BENCH_scale.json").read_text())["rows"]}
    runs = [(p, "fused") for p in main_points()]
    runs += [(p, "kernels") for p in main_points() if p[0] == "fig2_strong"]
    # every kernel reads the bool planes itself: no pack_rows anywhere
    need = {"fused": ("phase_step",),
            "kernels": ("popcount_rows", "coverage_multi")}
    out = []
    ps.reset_launches()
    for (sec, tag, series, app, mode, n), backend in runs:
        before = dict(ps.LAUNCHES)
        masked = ps.ROWMASK_LAUNCHES["phase_step"]
        rt, wall = run_point(torch, make_runtime, apps, IB_2013, app,
                             series, mode, n, backend)
        launched = {k: ps.LAUNCHES[k] - before[k] for k in ps.LAUNCHES}
        masked = ps.ROWMASK_LAUNCHES["phase_step"] - masked
        span = {k: rt.stats[k] for k in ("span_workers_vec",
                                         "span_serial_workers")}
        if mode == "lock" and (not span["span_workers_vec"]
                               or span["span_serial_workers"]
                               or (backend == "fused" and not masked)):
            raise AssertionError(f"{sec} {tag} [{backend}]: spans did not "
                                 f"run as grant groups ({span}, phase_step "
                                 f"{masked} times with a row mask)")
        row = rows[(sec, tag, W, "batched")]
        traffic = {f"tr_{f.name}": getattr(rt.traffic, f.name)
                   for f in dataclasses.fields(rt.traffic)}
        bad = {k: (v, row[k]) for k, v in traffic.items() if v != row[k]}
        t_model = round(rt.time, 6)
        if bad or t_model != row["t_model_s"]:
            raise AssertionError(
                f"{sec} {tag} [{backend}]: traffic drift {bad}, t_model "
                f"{t_model} vs committed {row['t_model_s']}")
        idle = [k for k in need[backend] if launched[k] == 0]
        if idle:
            raise AssertionError(f"{sec} {tag} [{backend}]: kernels {idle} "
                                 "never launched")
        if launched["pack_rows"]:
            raise AssertionError(f"{sec} {tag} [{backend}]: launched "
                                 f"pack_rows {launched['pack_rows']} "
                                 "times, which no path needs")
        print(f"main {sec:11s} {tag:23s} [{backend:7s}] wall "
              f"{wall:.3f} s  t_model {t_model}  launches {launched}  "
              f"phase_step with a row mask {masked}  {span}", flush=True)
        out.append({"section": sec, "series": tag, "W": W,
                    "backend": backend, "wall_s": wall, "t_model_s": t_model,
                    "launches": launched, "rowmask_phase_step": masked,
                    **span, **traffic})
    return out, dict(ps.LAUNCHES)


# ---------------------------------------------------------------------------
# span phase
# ---------------------------------------------------------------------------


def section_rows(section: str):
    """(protocol, W, driver) -> the committed rows of ``section``, and the
    iteration count ``BENCH_scale.json``'s meta names."""
    bench = json.loads((ROOT / "BENCH_scale.json").read_text())
    return ({(r["protocol"], r["W"], r.get("driver")): r
             for r in bench["rows"] if r["section"] == section},
            int(bench["meta"]["iters"]))


def run_lock_point(torch, series, backend, device, iters, driver="batched",
                   cache_pages=None):
    """One lock_contention point at the harness's settings
    (benchmarks/lock_contention.py): (runtime, wall seconds, peak device
    memory or None on the CPU)."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = make_runtime(W, protocol=PROTO[series], cost=IB_2013,
                      fetch_batch=16, cache_pages=cache_pages,
                      backend=backend, device=device)
    apps.lock_contention(rt, LOCK_N, iters, n_locks=LOCK_LOCKS,
                         sweeps=LOCK_SWEEPS, driver=driver)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rt, wall, torch.cuda.max_memory_allocated() if on_card else None


def span_phase(torch, ps, card, device="cuda"):
    """Slice D, consistency-region spans through ``span_all``.  (a) The
    two W=256 batched fig6_lock_contention rows (samhita, samhita_page)
    on 'fused' and samhita on 'kernels', at the harness's settings: each
    run's traffic equal to its ``BENCH_scale.json`` row field for field,
    its modeled time rounding to the row's ``t_model_s``, its span path
    counters equal to the row's ``span_vec``/``span_serial``; on the card
    the hoisted masked flush must have launched phase_step with its row
    mask on 'fused', popcount_rows and coverage_multi on 'kernels'.
    (b) lock_contention at W=256 under a roomy cache (nothing evicts: the
    grant groups with their touch bookkeeping) and a tight one (every
    span pass serializes), samhita on 'fused', 2 iterations, under the
    batched and the loop driver on ``device`` and on the CPU: traffic
    and clocks bit-equal across all four runs, stats equal between the
    device and the CPU for each driver.  Prints walls and peak device
    memory beside ``card``.  Returns (rows, launches of the phase)."""
    on_card = device != "cpu"
    committed, iters = section_rows("fig6_lock_contention")
    need = {"fused": ("phase_step",),
            "kernels": ("popcount_rows", "coverage_multi")}
    out = []
    ps.reset_launches()
    for series, backend in (("samhita", "fused"), ("samhita_page", "fused"),
                            ("samhita", "kernels")):
        before = dict(ps.LAUNCHES)
        masked = ps.ROWMASK_LAUNCHES["phase_step"]
        rt, wall, mem = run_lock_point(torch, series, backend, device, iters)
        launched = {k: ps.LAUNCHES[k] - before[k] for k in ps.LAUNCHES}
        masked = ps.ROWMASK_LAUNCHES["phase_step"] - masked
        row = committed[series, W, "batched"]
        traffic = {f"tr_{f.name}": getattr(rt.traffic, f.name)
                   for f in dataclasses.fields(rt.traffic)}
        span = {"span_vec": rt.stats["span_workers_vec"],
                "span_serial": rt.stats["span_serial_workers"]}
        bad = {k: (v, row[k]) for k, v in {**traffic, **span}.items()
               if v != row[k]}
        t_model = round(rt.time, 6)
        if bad or t_model != row["t_model_s"]:
            raise AssertionError(
                f"fig6_lock_contention {series} [{backend}]: drift {bad}, "
                f"t_model {t_model} vs committed {row['t_model_s']}")
        if on_card:
            idle = [k for k in need[backend] if launched[k] == 0]
            if idle or (backend == "fused" and masked == 0):
                raise AssertionError(
                    f"fig6_lock_contention {series} [{backend}]: kernels "
                    f"{idle} never launched, phase_step {masked} times "
                    "with a row mask")
        print(f"span fig6_lock_contention {series:12s} [{backend:7s}] wall "
              f"{wall:.3f} s  peak {mem} B  t_model {t_model}  {span}  "
              f"phase_step with a row mask {masked}  launches {launched}  "
              f"({card})", flush=True)
        out.append({"section": "fig6_lock_contention", "series": series,
                    "W": W, "backend": backend, "wall_s": wall,
                    "max_memory_allocated": mem, "t_model_s": t_model,
                    "rowmask_phase_step": masked, "launches": launched,
                    **span, **traffic})
    for label, cache_pages in LOCK_CACHES:
        runs = {}
        for dev in dict.fromkeys((device, "cpu")):
            for driver in ("batched", "loop"):
                runs[dev, driver] = run_lock_point(
                    torch, "samhita", "fused", dev, 2, driver, cache_pages)
        ref = runs[device, "batched"][0]
        for (dev, driver), (rt, wall, mem) in runs.items():
            ctx = f"lock_contention cache {label} ({cache_pages}) {dev} " \
                  f"{driver}"
            if (dataclasses.asdict(rt.traffic)
                    != dataclasses.asdict(ref.traffic)
                    or rt.clock.tobytes() != ref.clock.tobytes()):
                raise AssertionError(f"{ctx}: traffic or clocks differ from "
                                     f"{device} batched")
            if rt.stats != runs[device, driver][0].stats:
                raise AssertionError(f"{ctx}: stats differ from {device}")
            print(f"span {ctx:42s} wall {wall:.3f} s  peak {mem} B  "
                  f"t_model {rt.time:.6f}  span_vec "
                  f"{rt.stats['span_workers_vec']}  span_serial "
                  f"{rt.stats['span_serial_workers']}  ({card})",
                  flush=True)
            out.append({"section": "lock_contention_cache", "cache": label,
                        "cache_pages": cache_pages, "device": dev,
                        "driver": driver, "wall_s": wall,
                        "max_memory_allocated": mem,
                        "t_model_s": rt.time,
                        "stats": dict(rt.stats),
                        "traffic": dataclasses.asdict(rt.traffic)})
        st = ref.stats
        grouped = st["span_workers_vec"] > 0 and not st["span_serial_workers"]
        if grouped != (label == "roomy") or (
                label == "tight" and not st["span_serial_calls"]):
            raise AssertionError(f"lock_contention cache {label}: span path "
                                 f"counters {st}")
    return out, dict(ps.LAUNCHES)


# ---------------------------------------------------------------------------
# race phase
# ---------------------------------------------------------------------------


def run_race_point(torch, series, W_, driver, backend, device, iters,
                   detect):
    """One race_audit point at benchmarks/races.py's settings:
    (runtime, wall seconds ending in a synchronise on the card)."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    t0 = time.perf_counter()
    rt = make_runtime(W_, protocol=PROTO[series], cost=IB_2013,
                      fetch_batch=16, backend=backend, device=device,
                      detect_races=detect)
    apps.race_audit(rt, RACE_N, iters, n_locks=RACE_LOCKS, driver=driver)
    if device != "cpu":
        torch.cuda.synchronize()
    return rt, time.perf_counter() - t0


def race_program(seed: int):
    """The race-family trace of ``seed``: a copy of the test suite's
    ``trace_fuzz.race_trace_params`` and ``gen_race_program`` (the tests
    hold the two equal), as (params, events).  Clean traces are race-free
    by construction; racy ones splice in same-phase W/W writes, a
    write-to-read handoff without its barrier, and one shared range
    under different locks."""
    import numpy as np
    rng = np.random.default_rng(50_000 + seed)
    W_ = int(rng.integers(2, 5))
    pw = int(rng.choice([8, 16, 32]))
    n_words = pw * int(rng.integers(12, 32))
    p = dict(W=W_, page_words=pw, n_words=n_words,
             cache_pages=[None, 3, 6, 9][seed % 4],
             proto=("fine", "page", "ideal")[seed % 3], racy=bool(seed % 2))
    ids = np.arange(W_, dtype=np.int64)
    chunk = max(n_words // (W_ * pw), 1) * pw
    own_lo = ids * chunk
    own_hi = np.minimum(own_lo + chunk, n_words)
    shared_hi = min(n_words, max(2 * pw, chunk))
    prog = []
    for k in range(6):
        pick = int(rng.integers(0, 4))
        if pick == 0:
            prog.append(("phase", [(0, own_lo, own_hi)],
                         [(0, own_lo, own_hi)]))
        elif pick == 1:
            hi = np.full(W_, int(rng.integers(2, n_words + 1)), np.int64)
            prog.append(("phase", [(0, np.zeros(W_, np.int64), hi)], []))
        elif pick == 2:
            lo, hi = np.zeros(W_, np.int64), np.full(W_, shared_hi)
            prog.append(("span_phase", np.zeros(W_, np.int64),
                         [(1, lo, hi)], [(1, lo, hi)]))
        else:
            lo = (ids + k) % W_ * chunk
            hi = np.minimum(lo + chunk, n_words)
            prog.append(("phase", [(0, lo, hi)], [(0, lo, hi)]))
        prog.append(("barrier",))
    if not p["racy"]:
        return p, prog

    def pick_range():
        a, b = (int(x) for x in rng.choice(W_, 2, replace=False))
        x = int(rng.integers(0, max(n_words - 2 * pw, 1)))
        return a, b, x

    def gadget_ww():
        a, b, x = pick_range()
        lo, hi = own_lo.copy(), own_hi.copy()
        lo[a] = lo[b] = x
        hi[a] = hi[b] = min(x + int(rng.integers(1, 2 * pw)), n_words)
        return [("phase", [], [(0, lo, hi)])]

    def gadget_rw():
        a, b, x = pick_range()
        x_hi = min(x + int(rng.integers(1, 2 * pw)), n_words)
        lo_w, hi_w = own_lo.copy(), own_hi.copy()
        lo_w[a], hi_w[a] = x, x_hi
        lo_r, hi_r = own_lo.copy(), own_hi.copy()
        lo_r[b], hi_r[b] = x, x_hi
        return [("phase", [], [(0, lo_w, hi_w)]),
                ("phase", [(0, lo_r, hi_r)], [])]

    def gadget_span_race():
        lo, hi = np.zeros(W_, np.int64), np.full(W_, shared_hi)
        return [("span_phase", ids % 2, [(1, lo, hi)], [(1, lo, hi)])]

    gadgets = (gadget_ww, gadget_rw, gadget_span_race)
    for _ in range(int(rng.integers(1, 4))):
        gev = gadgets[int(rng.integers(0, 3))]()
        pos = int(rng.integers(0, len(prog) + 1))
        prog[pos:pos] = gev
    return p, prog


def run_race_program(torch, seed, backend, device, driver):
    """``race_program(seed)`` with detection on, through ``session``:
    (runtime, wall seconds)."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm.session import session
    p, prog = race_program(seed)
    t0 = time.perf_counter()
    rt = make_runtime(p["W"], page_words=p["page_words"],
                      protocol=p["proto"], prefetch=1,
                      model_mechanism=False, cache_pages=p["cache_pages"],
                      backend=backend, device=device, detect_races=True)
    gas = [rt.alloc(p["n_words"]) for _ in range(2)]
    s = session(rt, driver)
    for ev in prog:
        if ev[0] == "phase":
            s.phase(reads=[(gas[g], lo, hi) for g, lo, hi in ev[1]],
                    writes=[(gas[g], lo, hi) for g, lo, hi in ev[2]])
        elif ev[0] == "span_phase":
            s.span(ev[1], reads=[(gas[g], lo, hi) for g, lo, hi in ev[2]],
                   writes=[(gas[g], lo, hi) for g, lo, hi in ev[3]])
        else:
            rt.barrier()
    if device != "cpu":
        torch.cuda.synchronize()
    return rt, time.perf_counter() - t0


def md_false_sharing(rt, n_particles: int, ndim: int = 3) -> set:
    """The races that page-granular detection must flag in
    ``apps.molecular_dynamics``, computed from its declared blocks alone:
    its regions are pos, vel, acc and force (allocated in that order),
    each worker writes its own particles' words, and blocks that do not
    end on a page boundary share pages with a neighbour's.  Force is
    written in the force phase (a 'ww' per shared page and pair of
    workers); pos, vel and acc are read and written in the update phase
    (a 'ww' and an 'rw' per shared page and pair).  Barriers order
    everything else, and the energy spans share one lock."""
    import numpy as np
    W_, pw = rt.W, rt.page_words
    chunk = n_particles // W_
    p0 = np.arange(W_, dtype=np.int64) * chunk
    p1 = p0 + chunk
    p1[-1] = n_particles
    lo, hi = p0 * ndim, p1 * ndim
    out = set()
    for region, kinds in ((0, ("ww", "rw")), (1, ("ww", "rw")),
                          (2, ("ww", "rw")), (3, ("ww",))):
        base = rt.dirs[region].page_lo
        first = base + lo // pw
        last = base + (np.maximum(hi - 1, lo)) // pw
        for a in range(W_):
            for b in range(a + 1, W_):
                for page in range(max(first[a], first[b]),
                                  min(last[a], last[b]) + 1):
                    out.update((int(page), a, b, k) for k in kinds)
    return out


def race_phase(torch, ps, card, device="cuda", cores=RACE_CORES):
    """Slice E, race detection on the scale engine.  (a) The committed
    fig11_races rows (``cores`` x samhita, samhita_page x loop, batched)
    at benchmarks/races.py's settings on 'fused', each run with detection
    off and then on: the two runs' traffic equal and their modeled times
    bit-equal, and the on run equal to its ``BENCH_scale.json`` row
    (traffic field for field, ``t_model_s``, ``race_ww``, ``race_rw``,
    ``span_vec``, ``span_serial``); the largest batched samhita row once
    more on 'kernels'.  (b) The main path's W=256 batched fig6_weak and
    fig7_md lock points (samhita) with detection on: their committed
    rows unchanged, nothing flagged in Jacobi, and in MD exactly the
    page-level false sharing of its blocks (``md_false_sharing``).  (c) The four ``race_program``
    traces of ``RACE_SEEDS`` (cache_pages None, 3, 6, 9) on 'fused' and
    'kernels' under both drivers on ``device`` and on the CPU: race sets,
    stats, traffic and clocks equal.  On the card the launch counters
    must show phase_step on 'fused' and popcount_rows and coverage_multi
    on 'kernels' in (a), and the rank-select kernels in the cached
    traces of (c).  Returns (rows, launches of the phase)."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    on_card = device != "cpu"
    committed, iters = section_rows("fig11_races")
    bench = {(r["section"], r["protocol"], r["W"], r.get("driver")): r
             for r in json.loads(
                 (ROOT / "BENCH_scale.json").read_text())["rows"]}
    out = []
    ps.reset_launches()

    def checked(name, rt, row, want_races=True):
        traffic = {f"tr_{f.name}": getattr(rt.traffic, f.name)
                   for f in dataclasses.fields(rt.traffic)}
        got = dict(traffic)
        if want_races:
            got.update(race_ww=rt.stats["race_ww"],
                       race_rw=rt.stats["race_rw"],
                       span_vec=rt.stats["span_workers_vec"],
                       span_serial=rt.stats["span_serial_workers"])
        bad = {k: (v, row[k]) for k, v in got.items() if v != row[k]}
        t_model = round(rt.time, 6)
        if bad or t_model != row["t_model_s"]:
            raise AssertionError(f"{name}: drift {bad}, t_model {t_model} "
                                 f"vs committed {row['t_model_s']}")
        return traffic, t_model

    runs = [(series, W_, driver, "fused") for W_ in cores
            for driver in ("loop", "batched")
            for series in ("samhita", "samhita_page")]
    runs.append(("samhita", cores[-1], "batched", "kernels"))
    need = {"fused": ("phase_step",),
            "kernels": ("popcount_rows", "coverage_multi")}
    for series, W_, driver, backend in runs:
        before = dict(ps.LAUNCHES)
        off, wall_off = run_race_point(torch, series, W_, driver, backend,
                                       device, iters, False)
        on, wall_on = run_race_point(torch, series, W_, driver, backend,
                                     device, iters, True)
        launched = {k: ps.LAUNCHES[k] - before[k] for k in ps.LAUNCHES}
        name = f"fig11_races {series} W={W_} {driver} [{backend}]"
        if (dataclasses.asdict(on.traffic) != dataclasses.asdict(off.traffic)
                or on.clock.tobytes() != off.clock.tobytes()):
            raise AssertionError(f"{name}: detection changed traffic or "
                                 "clocks")
        traffic, t_model = checked(name, on, committed[series, W_, driver])
        if on_card:
            idle = [k for k in need[backend] if launched[k] == 0]
            if idle:
                raise AssertionError(f"{name}: kernels {idle} never "
                                     "launched")
        overhead = (wall_on - wall_off) / wall_off
        print(f"race {name:44s} wall on {wall_on:.3f} s off "
              f"{wall_off:.3f} s (detect_overhead {overhead:.3f})  "
              f"t_model {t_model}  race_ww {on.stats['race_ww']} race_rw "
              f"{on.stats['race_rw']}  launches {launched}  ({card})",
              flush=True)
        out.append({"section": "fig11_races", "series": series, "W": W_,
                    "driver": driver, "backend": backend,
                    "wall_on_s": wall_on, "wall_off_s": wall_off,
                    "detect_overhead": overhead, "t_model_s": t_model,
                    "race_ww": on.stats["race_ww"],
                    "race_rw": on.stats["race_rw"], "launches": launched,
                    **traffic})
    for sec, tag, series, app, mode, n in main_points():
        if sec not in ("fig6_weak", "fig7_md") or tag != "samhita_lock":
            continue
        t0 = time.perf_counter()
        rt = make_runtime(W, protocol=PROTO[series], cost=IB_2013,
                          fetch_batch=16, backend="fused", device=device,
                          detect_races=True)
        run = apps.jacobi if app == "jacobi" else apps.molecular_dynamics
        run(rt, n, ITERS, mode=mode, driver="batched")
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = f"{sec} {tag} detecting"
        want = md_false_sharing(rt, n) if app == "md" else set()
        counts = {k: sum(r[3] == k for r in want) for k in ("ww", "rw")}
        if rt.races != want or counts != {"ww": rt.stats["race_ww"],
                                          "rw": rt.stats["race_rw"]}:
            raise AssertionError(
                f"{name}: flagged {len(rt.races)} races, {len(want)} "
                f"expected ({len(rt.races ^ want)} differ)")
        traffic, t_model = checked(name, rt, bench[sec, tag, W, "batched"],
                                   want_races=False)
        print(f"race {name:44s} wall {wall:.3f} s  t_model {t_model}  "
              f"races {counts} (as expected)  ({card})", flush=True)
        out.append({"section": sec, "series": tag, "W": W,
                    "detect_races": True, "wall_s": wall,
                    "t_model_s": t_model, "race_ww": counts["ww"],
                    "race_rw": counts["rw"], **traffic})
    ranked = {"fused": ("take_and_cut",),
              "kernels": ("take_first_k", "kth_set_index")}
    for seed in RACE_SEEDS:
        p, _ = race_program(seed)
        for backend in ("fused", "kernels"):
            for driver in ("batched", "loop"):
                before = dict(ps.LAUNCHES)
                rt, wall = run_race_program(torch, seed, backend, device,
                                            driver)
                launched = {k: ps.LAUNCHES[k] - before[k]
                            for k in ps.LAUNCHES}
                cpu, _ = run_race_program(torch, seed, backend, "cpu",
                                          driver)
                name = (f"race trace {seed} (W={p['W']}, {p['proto']}, "
                        f"cache {p['cache_pages']}) {driver} [{backend}]")
                if (rt.races != cpu.races or rt.stats != cpu.stats
                        or dataclasses.asdict(rt.traffic)
                        != dataclasses.asdict(cpu.traffic)
                        or rt.clock.tobytes() != cpu.clock.tobytes()):
                    raise AssertionError(f"{name}: {device} and the CPU "
                                         "differ")
                if bool(rt.races) != p["racy"]:
                    raise AssertionError(f"{name}: {len(rt.races)} races "
                                         f"flagged, racy={p['racy']}")
                if on_card and p["cache_pages"] is not None and (
                        driver == "batched"):
                    idle = [k for k in ranked[backend] if launched[k] == 0]
                    if idle:
                        raise AssertionError(f"{name}: rank-select kernels "
                                             f"{idle} never launched")
                print(f"race {name:56s} wall {wall:.3f} s  "
                      f"{len(rt.races)} races  launches {launched}",
                      flush=True)
                out.append({"section": "race_trace", "seed": seed, **p,
                            "driver": driver, "backend": backend,
                            "wall_s": wall, "races": len(rt.races),
                            "launches": launched})
    return out, dict(ps.LAUNCHES)


def race_profile(torch, card, cores=RACE_CORES):
    """The largest batched samhita fig11 point on 'fused', traced with
    detection off and on (``traced``): detection on may issue at most
    twice the device activities of detection off.  Prints both counts,
    both idle shares and both walls (``detect_overhead``)."""
    _, iters = section_rows("fig11_races")
    res = {}
    for detect in (False, True):
        res[detect] = traced(torch, lambda d=detect: run_race_point(
            torch, "samhita", cores[-1], "batched", "fused", "cuda", iters,
            d))
    off, on = res[False], res[True]
    overhead = (on["traced_wall_s"] - off["traced_wall_s"]) / off[
        "traced_wall_s"]
    print(f"profile fig11_races samhita W={cores[-1]} batched: detection "
          f"on {on['device_activities']} device activities, idle share "
          f"{on['idle_share']}, wall {on['traced_wall_s']:.3f} s; off "
          f"{off['device_activities']}, idle share {off['idle_share']}, "
          f"wall {off['traced_wall_s']:.3f} s (detect_overhead "
          f"{overhead:.3f})  ({card})", flush=True)
    if (not off["device_activities"]
            or on["device_activities"] > 2 * off["device_activities"]):
        raise AssertionError(
            f"fig11_races: detection on issued {on['device_activities']} "
            f"device activities against {off['device_activities']} off "
            "(at most twice as many expected)")
    return [dict(on, section="fig11_races", series="samhita",
                 detect_races=True),
            dict(off, section="fig11_races", series="samhita",
                 detect_races=False, detect_overhead=overhead)]


# ---------------------------------------------------------------------------
# serving and recovery phases
# ---------------------------------------------------------------------------


def run_serve_point(torch, series, W_, driver, backend, device):
    """One kv_serving point at benchmarks/kv_serving.py's settings:
    (runtime, report, wall seconds ending in a synchronise on the card,
    peak device memory or None on the CPU)."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = make_runtime(W_, protocol=PROTO[series], cost=IB_2013,
                      fetch_batch=16, cache_pages=SERVE_CACHE_PAGES,
                      backend=backend, device=device)
    rep = apps.kv_serving(rt, SERVE_REQ_PER_SLOT * W_,
                          tok_words=SERVE_TOK_WORDS,
                          max_tokens=SERVE_MAX_TOKENS,
                          attn_window=SERVE_ATTN_WINDOW,
                          n_tenants=SERVE_TENANTS,
                          burst_mean=max(2, W_ // 8), gap_max=2,
                          seed=SERVE_SEED, driver=driver)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rt, rep, wall, torch.cuda.max_memory_allocated() if on_card \
        else None


def serve_fields(rt, rep) -> dict:
    """A kv_serving run's gated fields, as the bench names them: ``tr_*``,
    the ``srv_*`` workload counters and the danger and span counters."""
    st = rt.stats
    return {**{f"tr_{f.name}": getattr(rt.traffic, f.name)
               for f in dataclasses.fields(rt.traffic)},
            "srv_requests": int(rep.latencies().size),
            "srv_prefill_tok": rep.prefill_tokens,
            "srv_decode_tok": rep.decode_tokens,
            "srv_steps": rep.steps, "srv_admit_spans": rep.admit_spans,
            "srv_admitted": rep.admitted,
            "srv_idle_slot_steps": rep.idle_slot_steps,
            "srv_peak_queue": rep.peak_queue,
            "srv_evict_rounds": st["evict_batch_rounds"],
            "danger_vec": st["danger_vec_ops"],
            "danger_scalar": st["danger_scalar_ops"],
            "danger_shared": st["danger_shared_ops"],
            "span_vec": st["span_workers_vec"],
            "span_serial": st["span_serial_workers"]}


def serving_phase(torch, ps, card, device="cuda", cores=SERVE_CORES):
    """Slice F, the serving workload.  The committed fig8_kv_serving rows
    (``cores`` x samhita, samhita_page x loop, batched) on 'fused', and the
    largest batched samhita row once more on 'kernels', at
    benchmarks/kv_serving.py's settings: each run equal to its
    ``BENCH_scale.json`` row (traffic field for field, ``t_model_s``,
    the ``srv_*``, ``danger_*`` and ``span_*`` counters).  On the card
    the launch counters must show phase_step on 'fused' (take_and_cut
    too in the batched rows, which evict in batched rounds),
    popcount_rows, coverage_multi, take_first_k and kth_set_index on
    'kernels', and pack_rows nowhere.  Prints each run's modeled p50 and
    p99 latency, tokens/s, wall and peak device memory beside ``card``.
    Returns (rows, launches of the phase)."""
    import numpy as np
    on_card = device != "cpu"
    committed, _ = section_rows("fig8_kv_serving")
    runs = [(series, W_, driver, "fused") for W_ in cores
            for driver in ("loop", "batched")
            for series in ("samhita", "samhita_page")]
    runs.append(("samhita", cores[-1], "batched", "kernels"))
    need = {"fused": ("phase_step",),
            "kernels": ("popcount_rows", "coverage_multi", "take_first_k",
                        "kth_set_index")}
    out = []
    ps.reset_launches()
    for series, W_, driver, backend in runs:
        before = dict(ps.LAUNCHES)
        rt, rep, wall, mem = run_serve_point(torch, series, W_, driver,
                                             backend, device)
        launched = {k: ps.LAUNCHES[k] - before[k] for k in ps.LAUNCHES}
        name = f"fig8_kv_serving {series} W={W_} {driver} [{backend}]"
        row = committed[series, W_, driver]
        got = serve_fields(rt, rep)
        bad = {k: (v, row[k]) for k, v in got.items() if v != row[k]}
        t_model = round(rt.time, 6)
        if bad or t_model != row["t_model_s"]:
            raise AssertionError(f"{name}: drift {bad}, t_model {t_model} "
                                 f"vs committed {row['t_model_s']}")
        if on_card:
            want = list(need[backend])
            if backend == "fused" and got["srv_evict_rounds"]:
                want.append("take_and_cut")
            idle = [k for k in want if launched[k] == 0]
            if idle or launched["pack_rows"]:
                raise AssertionError(
                    f"{name}: kernels {idle} never launched, pack_rows "
                    f"{launched['pack_rows']} times")
        lat = rep.latencies()
        p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
        print(f"serve {name:44s} wall {wall:.3f} s  peak {mem} B  t_model "
              f"{t_model}  p50 {p50:.6f} ms p99 {p99:.6f} ms (modeled)  "
              f"{rep.tokens_per_s():.1f} tokens/s  span_vec "
              f"{got['span_vec']} span_serial {got['span_serial']}  "
              f"launches {launched}  ({card})", flush=True)
        out.append({"section": "fig8_kv_serving", "series": series,
                    "W": W_, "driver": driver, "backend": backend,
                    "wall_s": wall, "max_memory_allocated": mem,
                    "t_model_s": t_model, "p50_ms": p50, "p99_ms": p99,
                    "tokens_per_s": rep.tokens_per_s(),
                    "launches": launched, **got})
    return out, dict(ps.LAUNCHES)


def recovery_program(W_: int, n_words: int, iters: int):
    """benchmarks/recovery.py's ``gen_program``: per iteration one bulk
    phase (block reads, rotating writes, worker 0 dragging a heavy
    compute tail: the straggler), one span pass on 4 striped locks, and a
    barrier (the checkpoint cut)."""
    import numpy as np
    ids = np.arange(W_, dtype=np.int64)
    chunk = n_words // W_
    prog = []
    for it in range(iters):
        r = (ids + it) % W_
        reads = [(0, ids * chunk, np.minimum((ids + 1) * chunk, n_words))]
        writes = [(0, r * chunk,
                   np.where(r == W_ - 1, n_words, (r + 1) * chunk))]
        flops = np.zeros(W_)
        flops[0] = 5e6
        prog.append(("phase", reads, writes, flops))
        lo = np.full(W_, (it * 7) % max(n_words - 8, 1), np.int64)
        prog.append(("span_phase", ids % 4, [(0, lo, lo + 8)],
                     [(0, lo.copy(), lo.copy() + 8)]))
        prog.append(("barrier",))
    return prog


def recovery_event(rt, ev, gas, driver: str):
    """benchmarks/recovery.py's ``apply_event``: one ``recovery_program``
    event on either driver (``ft.harness_ticks`` decides who ticks)."""
    W_ = rt.W
    if ev[0] == "phase":
        _, reads, writes, flops = ev
        r = [(gas[g], lo, hi) for g, lo, hi in reads]
        wr = [(gas[g], lo, hi) for g, lo, hi in writes]
        if driver == "batched":
            rt.phase_all(reads=r, writes=wr, flops=flops)
            return
        for w in range(W_):
            rt.phase(w, reads=[(ga, int(lo[w]), int(hi[w]))
                               for ga, lo, hi in r],
                     writes=[(ga, int(lo[w]), int(hi[w]))
                             for ga, lo, hi in wr],
                     flops=float(flops[w]))
    elif ev[0] == "span_phase":
        _, locks, reads, writes = ev
        r = [(gas[g], lo, hi) for g, lo, hi in reads]
        wr = [(gas[g], lo, hi) for g, lo, hi in writes]
        if driver == "batched":
            rt.span_all(None, locks, reads=r, writes=wr)
            return
        for w in range(W_):
            with rt.span(w, int(locks[w])):
                for ga, lo, hi in r:
                    rt.read(w, ga, int(lo[w]), int(hi[w]))
                for ga, lo, hi in wr:
                    rt.write(w, ga, int(lo[w]), int(hi[w]))
    else:
        rt.barrier()


def recovery_csv():
    """(series, W, driver) -> the committed recovery CSV rows' event
    counters (``artifacts/bench/recovery.csv`` and ``recovery_loop.csv``)."""
    out = {}
    for name in ("recovery", "recovery_loop"):
        with open(ROOT / "artifacts" / "bench" / f"{name}.csv") as f:
            for r in csv.DictReader(f):
                out[(r["series"], int(r["p"]), r["driver"])] = {
                    k: int(r[k]) for k in ("n_events", "n_checkpoints",
                                           "n_crashes", "replayed_events")}
    return out


def recovery_maker(series, W_, backend, device):
    """benchmarks/recovery.py's runtime factory: the harness's settings with
    a ``ChaosNet`` and a ``StragglerMonitor`` attached."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm.costmodel import IB_2013, ChaosNet
    from repro_torch.ft import StragglerMonitor

    def make():
        return make_runtime(
            W_, protocol=PROTO[series], cost=IB_2013, fetch_batch=16,
            page_words=RECOVERY_PAGE_WORDS, backend=backend, device=device,
            chaos=ChaosNet(seed=RECOVERY_CHAOS_SEED,
                           drop_rate=RECOVERY_DROP_RATE),
            straggler=StragglerMonitor(W_, window=4, patience=2))
    return make


def chaos_fields(rt) -> dict:
    return {k: rt.stats[k] for k in ("chaos_msgs", "chaos_drops",
                                     "chaos_inval_retries",
                                     "straggler_checks", "straggler_flags")}


def recovery_phase(torch, ps, card, device="cuda", cores=RECOVERY_CORES):
    """Slice F, crash recovery.  (a) The committed fig9_recovery rows
    (``cores`` x samhita, samhita_page x loop, batched) on 'fused', and the
    largest batched samhita row once more on 'kernels', at
    benchmarks/recovery.py's settings (``ChaosNet`` seed 11 at a 5% drop
    rate, a straggler monitor, max(3, iters // 2) iterations for the
    meta's iters, as benchmarks/run.py passes them): the uninjected
    run equal to its ``BENCH_scale.json`` row (traffic field for field,
    ``t_model_s``, the chaos and straggler counters); its checkpoint
    saved and loaded back with equal clocks; a ``ChaosHarness`` run with
    one crash at tick 3 * max(1, iters // 2) on worker W // 2 landing
    bit-equal to the uninjected run, with the committed recovery CSV's
    event counters.  On the card the launch counters must show
    phase_step on 'fused', popcount_rows on 'kernels', and pack_rows
    nowhere.  (b) The largest batched samhita
    program snapshotted at its middle barrier on ``device`` and restored
    on the CPU, and snapshotted on the CPU and restored on ``device``:
    all four finish bit-equal.  Prints ``t_ckpt``, ``t_restore``,
    ``t_recovery``, the uninjected wall and ``ckpt_bytes`` beside
    ``card``.  Returns (rows, launches of the phase)."""
    import tempfile

    from repro_torch.core import RegCScaleRuntime
    from repro_torch.ft import (ChaosHarness, FailureInjector,
                                assert_bit_equal, load_runtime,
                                run_uninjected, save_runtime)
    on_card = device != "cpu"
    committed, meta_iters = section_rows("fig9_recovery")
    # benchmarks/run.py runs the recovery section at max(3, iters // 2)
    iters = max(3, meta_iters // 2)
    counters = recovery_csv()
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)

    def synced():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    runs = [(series, W_, driver, "fused") for W_ in cores
            for driver in ("loop", "batched")
            for series in ("samhita", "samhita_page")]
    runs.append(("samhita", cores[-1], "batched", "kernels"))
    # the program's rotating blocks leave no page under two windows dirty,
    # so the 'kernels' flush needs no coverage sweep
    need = {"fused": ("phase_step",), "kernels": ("popcount_rows",)}
    out = []
    ps.reset_launches()
    for series, W_, driver, backend in runs:
        before = dict(ps.LAUNCHES)
        n_words = RECOVERY_PAGE_WORDS * RECOVERY_PAGES_PER_WORKER * W_
        prog = recovery_program(W_, n_words, iters)
        make = recovery_maker(series, W_, backend, device)
        name = f"fig9_recovery {series} W={W_} {driver} [{backend}]"
        t0 = synced()
        base = run_uninjected(make, [n_words], driver, prog, recovery_event)
        t_wall = synced() - t0
        row = committed[series, W_, driver]
        got = {**{f"tr_{f.name}": getattr(base.traffic, f.name)
                  for f in dataclasses.fields(base.traffic)},
               **chaos_fields(base)}
        bad = {k: (v, row[k]) for k, v in got.items() if v != row[k]}
        t_model = round(base.time, 6)
        if bad or t_model != row["t_model_s"]:
            raise AssertionError(f"{name}: drift {bad}, t_model {t_model} "
                                 f"vs committed {row['t_model_s']}")
        with tempfile.TemporaryDirectory(dir=scratch) as td:
            t0 = synced()
            save_runtime(base, td, 0)
            t_ckpt = synced() - t0
            ckpt_bytes = sum(f.stat().st_size for f in
                             (Path(td) / "step_000000000").iterdir())
            t0 = synced()
            restored = load_runtime(td, 0, backend=backend, device=device)
            t_restore = synced() - t0
        if restored.clock.tobytes() != base.clock.tobytes():
            raise AssertionError(f"{name}: restored clocks differ")
        inj = FailureInjector(at_steps=[(3 * max(1, iters // 2), W_ // 2)])
        with tempfile.TemporaryDirectory(dir=scratch) as td:
            t0 = synced()
            rec, rep = ChaosHarness(make, [n_words], driver, td,
                                    recovery_event, injector=inj).run(prog)
            t_recovery = synced() - t0
        assert_bit_equal(rec, base, name)
        events = {"n_events": rep.n_events,
                  "n_checkpoints": rep.n_checkpoints,
                  "n_crashes": rep.n_crashes,
                  "replayed_events": rep.n_replayed_events}
        if events != counters[series, W_, driver]:
            raise AssertionError(f"{name}: recovery counters {events} vs "
                                 f"committed {counters[series, W_, driver]}")
        launched = {k: ps.LAUNCHES[k] - before[k] for k in ps.LAUNCHES}
        if on_card:
            idle = [k for k in need[backend] if launched[k] == 0]
            if idle or launched["pack_rows"]:
                raise AssertionError(
                    f"{name}: kernels {idle} never launched, pack_rows "
                    f"{launched['pack_rows']} times")
        print(f"recovery {name:42s} wall {t_wall:.3f} s  t_ckpt "
              f"{t_ckpt:.4f} s  t_restore {t_restore:.4f} s  t_recovery "
              f"{t_recovery:.3f} s  ckpt_bytes {ckpt_bytes}  t_model "
              f"{t_model}  {events}  {chaos_fields(base)}  launches "
              f"{launched}  ({card})", flush=True)
        out.append({"section": "fig9_recovery", "series": series, "W": W_,
                    "driver": driver, "backend": backend, "wall_s": t_wall,
                    "t_ckpt_s": t_ckpt, "t_restore_s": t_restore,
                    "t_recovery_wall_s": t_recovery,
                    "ckpt_bytes": ckpt_bytes, "t_model_s": t_model,
                    "launches": launched, **events, **got})
    # (b) a snapshot crosses between the card and the CPU both ways
    W_ = cores[-1]
    n_words = RECOVERY_PAGE_WORDS * RECOVERY_PAGES_PER_WORKER * W_
    prog = recovery_program(W_, n_words, iters)
    cut = 3 * max(1, iters // 2)          # the barrier the crash hits
    finished = []
    for here, there in ((device, "cpu"), ("cpu", device)):
        rt = recovery_maker("samhita", W_, "fused", here)()
        gas = [rt.alloc(n_words)]
        for ev in prog[:cut]:
            recovery_event(rt, ev, gas, "batched")
        moved = RegCScaleRuntime.from_snapshot(*rt.snapshot(), device=there)
        for run in (rt, moved):
            g = [run.gas_for_region(0, n_words)]
            for ev in prog[cut:]:
                recovery_event(run, ev, g, "batched")
            finished.append(run)
    for run in finished[1:]:
        assert_bit_equal(run, finished[0], "snapshot across devices")
    print(f"recovery snapshot at event {cut} of the W={W_} samhita program: "
          f"{device} -> cpu and cpu -> {device} finish bit-equal "
          f"(t_model {finished[0].time:.6f})", flush=True)
    return out, dict(ps.LAUNCHES)


# ---------------------------------------------------------------------------
# cluster phase
# ---------------------------------------------------------------------------


def avail_cfg(W_: int, backend: str, device) -> dict:
    """benchmarks/availability.py's shard config: samhita, fetch_batch
    16, IB_2013, ``ChaosNet`` seed 11 at 5% loss and a straggler monitor
    (window 4, k 4.0, abs_floor_s 1e-4, patience 2), on ``backend`` and
    ``device``."""
    from repro_torch.dsm.costmodel import IB_2013
    return dict(n_workers=W_, page_words=RECOVERY_PAGE_WORDS,
                protocol=PROTO["samhita"], cache_pages=None, fetch_batch=16,
                cost=dataclasses.asdict(IB_2013), detect_races=False,
                chaos=dict(seed=RECOVERY_CHAOS_SEED,
                           drop_rate=RECOVERY_DROP_RATE),
                straggler=dict(n_workers=W_, window=4, k=4.0,
                               abs_floor_s=1e-4, patience=2),
                backend=backend, device=str(device))


def avail_faults(iters: int, n_shards: int):
    """benchmarks/availability.py's ``_fault_schedule``: SIGKILL the last
    rank at the span event of iteration max(1, iters // 2) (mid-
    iteration, so the replay suffix is not empty), then a reply
    partition on rank 0 three events later."""
    kill_step = 3 * max(1, iters // 2) + 2
    return [("kill", kill_step, n_shards - 1),
            ("partition_s2c", min(3 * iters, kill_step + 3), 0)]


def cluster_phase(torch, ps, card, device="cuda", groups=AVAIL_GROUPS,
                  shards=AVAIL_SHARDS, rpc_timeout_s=AVAIL_RPC_TIMEOUT_S,
                  fault_shards=None):
    """Slice G, the sharded multi-process cluster.  For each (W, driver)
    of ``groups``, the committed fig10_availability rows of ``shards``
    (``samhita_s<n>`` clean and, for the shard counts of
    ``fault_shards`` (all by default), ``_fault``) on 'fused', at
    benchmarks/availability.py's settings and max(3, iters // 2)
    iterations for the meta's iters: the recovery program with 8 pages a
    worker run by ``ClusterRuntime`` in n spawned shard processes, each a
    full replica on ``device``; the faulted rows SIGKILL the last rank
    and partition rank 0's replies, recovered by respawn.  Every run is
    bit-equal to a single-process run on ``device`` and its per-round
    digests are in lockstep with that run's; each row equals its
    ``BENCH_scale.json`` row in every field but the wall (``t_model_s``,
    ``tr_*``, ``rec_*``, chaos and straggler counters); every shard
    reports its runtime on ``device``'s type, and the gathered stats show
    the fused flush dispatched in the shards.  On the card the shards'
    own launch counters (their ``gather`` replies) must show phase_step
    and no pack_rows.  Prints each row's wall, events/s, p50/p99 barrier
    round latency, largest round latency and RPC retries beside
    ``card``, and how long the shards took to start (spawn, ``import
    torch``, first CUDA context, kernel load).  Returns (rows, the
    shards' launches summed over the rows)."""
    import tempfile

    import numpy as np

    from repro_torch.cluster import ClusterRuntime, make_runtime, state_digest
    from repro_torch.ft import FailureInjector, assert_bit_equal
    from repro_torch.ft.coherence import harness_ticks
    on_card = device != "cpu"
    want = torch.device(device).type
    committed, meta_iters = section_rows("fig10_availability")
    iters = max(3, meta_iters // 2)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    skip = {"section", "protocol", "W", "driver", "t_wall_s"}
    launches = dict.fromkeys(ps.LAUNCHES, 0)
    out = []
    for W_, driver in groups:
        n_words = RECOVERY_PAGE_WORDS * AVAIL_PAGES_PER_WORKER * W_
        cfg = avail_cfg(W_, "fused", device)
        prog = recovery_program(W_, n_words, iters)
        # the single-process run with its per-event digests, ticking as
        # the shards do
        base = make_runtime(cfg)
        gas = [base.alloc(n_words)]
        digests = {}
        for i, ev in enumerate(prog):
            if harness_ticks(ev, driver):
                base.chaos_tick()
            recovery_event(base, ev, gas, driver)
            digests[i] = state_digest(base)
        for n_shards in shards:
            for fault in (False, True):
                if fault and n_shards not in (fault_shards or shards):
                    continue
                series = f"samhita_s{n_shards}" + ("_fault" if fault else "")
                name = f"fig10_availability {series} W={W_} {driver}"
                inj = (FailureInjector(cluster_at=avail_faults(iters,
                                                               n_shards))
                       if fault else None)
                with tempfile.TemporaryDirectory(dir=scratch) as td:
                    t0 = time.perf_counter()
                    with ClusterRuntime(
                            cfg, [n_words], n_shards=n_shards, driver=driver,
                            apply_ref=("chip_smoke", "recovery_event"),
                            root=td, injector=inj,
                            rpc_timeout_s=rpc_timeout_s,
                            rpc_attempts=AVAIL_RPC_ATTEMPTS) as cluster:
                        # the shards' start: spawn, import, first context
                        t_start = time.perf_counter() - t0
                        res = cluster.run(prog)
                        got_digests = dict(cluster.digests)
                    t_wall = time.perf_counter() - t0
                rep = res.report
                assert_bit_equal(res, base, name)
                if got_digests != digests:
                    bad = sorted(i for i in digests
                                 if got_digests.get(i) != digests[i])
                    raise AssertionError(f"{name}: round digests out of "
                                         f"lockstep at events {bad}")
                row = committed[series, W_, driver]
                got = {"t_model_s": round(res.time, 6),
                       "total_bytes": res.traffic.total_bytes,
                       **rep.counters(),
                       **{f"tr_{f.name}": getattr(res.traffic, f.name)
                          for f in dataclasses.fields(res.traffic)},
                       **chaos_fields(res)}
                if set(got) != set(row) - skip:
                    raise AssertionError(f"{name}: fields {sorted(got)} vs "
                                         f"committed {sorted(row)}")
                bad = {k: (v, row[k]) for k, v in got.items() if v != row[k]}
                if bad:
                    raise AssertionError(f"{name}: drift {bad}")
                off = {r: d for r, d in res.devices.items()
                       if torch.device(d).type != want}
                if off or not res.devices:
                    raise AssertionError(f"{name}: shards on {res.devices}, "
                                         f"expected {want}")
                if res.stats["fused_dispatches"] <= 0:
                    raise AssertionError(f"{name}: no fused flush in the "
                                         "shards")
                if on_card and (res.launches["phase_step"] == 0
                                or res.launches["pack_rows"]):
                    raise AssertionError(f"{name}: shard launches "
                                         f"{res.launches}")
                for k in launches:
                    launches[k] += res.launches.get(k, 0)
                bar_ms = np.asarray(rep.bar_wall_s) * 1e3
                # the largest round of each event kind, the first round
                # (each process's first calls) apart
                kinds = {}
                for i, w in rep.round_wall_s:
                    kind = "first" if i == 0 else prog[i][0]
                    kinds[kind] = max(kinds.get(kind, 0.0), w * 1e3)
                fields = {
                    "wall_s": t_wall, "start_s": t_start,
                    "events_per_s": rep.n_events / t_wall,
                    "bar_p50_ms": float(np.percentile(bar_ms, 50)),
                    "bar_p99_ms": float(np.percentile(bar_ms, 99)),
                    "max_round_ms": max(kinds.values()),
                    "max_round_ms_by_kind": kinds,
                    "rpc_retries": rep.rpc_retries,
                    "rpc_retry_model_s": rep.rpc_retry_model_s}
                print(f"cluster {name:44s} wall {t_wall:.3f} s (start "
                      f"{t_start:.3f} s)  "
                      f"{fields['events_per_s']:.2f} events/s  barrier p50 "
                      f"{fields['bar_p50_ms']:.3f} p99 "
                      f"{fields['bar_p99_ms']:.3f} ms  largest round "
                      f"{fields['max_round_ms']:.3f} ms "
                      + str({k: round(v, 3) for k, v in kinds.items()})
                      + f"  rpc_retries {rep.rpc_retries}  "
                      f"{rep.counters()}  shards "
                      f"{sorted(set(res.devices.values()))}  launches "
                      f"{res.launches}  ({card})", flush=True)
                out.append({"section": "fig10_availability",
                            "series": series, "W": W_, "driver": driver,
                            "n_shards": n_shards, "backend": "fused",
                            "rpc_timeout_s": rpc_timeout_s,
                            "devices": res.devices,
                            "launches": res.launches, **fields, **got})
    return out, launches


# ---------------------------------------------------------------------------
# spill phase
# ---------------------------------------------------------------------------


def spill_points():
    """(section, series, app, app kwargs, n, cache_pages, iters) of the six
    W=256 capacity-pressure rows, at the harness's settings
    (benchmarks/stream_triad.py spill/spill_heavy, jacobi.py spill,
    molecular_dynamics.py spill)."""
    triad_cache = 3 * (N_TRIAD // 1024) + 64
    n_rot = (1 << 17) * W                     # 128 pages per worker
    md_pages = -(-(N_PARTICLES * 3) // 1024)
    return [
        ("fig4_spill", "samhita_fits", "stream_triad", {}, N_TRIAD * W,
         triad_cache, 4),
        ("fig4_spill", "samhita_spills", "stream_triad", {},
         N_TRIAD * W * 2, triad_cache, 4),
        ("fig4_spill_heavy", "samhita_rot", "stream_spill", {"sweeps": 2},
         n_rot, (3 * (n_rot // 1024)) // (2 * W), 2),
        ("fig4_refetch", "samhita_refetch", "stream_refetch",
         {"sweeps": 2, "width_pages": 8}, n_rot, 20, 2),
        ("fig5_spill", "samhita_spill", "jacobi", {"mode": "reduction"},
         N_JACOBI, max((3 * (N_JACOBI * N_JACOBI // 1024)) // (2 * W), 8),
         2),
        ("fig7_md_spill", "samhita_spill", "molecular_dynamics",
         {"mode": "reduction"}, N_PARTICLES, max(md_pages // 2, 4), 2),
    ]


def committed_danger():
    """(section, series, W, driver) -> committed danger counters, from the
    benchmark CSVs."""
    out = {}
    for name in ("stream_triad", "jacobi", "molecular_dynamics"):
        with open(ROOT / "artifacts" / "bench" / f"{name}.csv") as f:
            for r in csv.DictReader(f):
                if r.get("danger_vec"):
                    out[(r["figure"], r["series"], int(r["p"]),
                         r["driver"])] = {
                        k: int(r[k]) for k in ("danger_vec", "danger_scalar",
                                               "danger_shared")}
    return out


def run_spill_point(torch, point, backend, device="cuda"):
    """One spill point (an entry of ``spill_points``) on ``backend``:
    (runtime, wall seconds, host clock ending in a synchronise)."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    _sec, _tag, app, kw, n, cache_pages, iters = point
    t0 = time.perf_counter()
    rt = make_runtime(W, protocol="fine", cost=IB_2013, fetch_batch=16,
                      cache_pages=cache_pages, backend=backend,
                      device=device)
    getattr(apps, app)(rt, n, iters, driver="batched", **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    return rt, time.perf_counter() - t0


def spill_phase(torch, ps, device="cuda"):
    """The six spill rows on 'fused' and the two refetch-replay rows on
    'kernels'; every check of the main-path phase, plus the committed
    danger counters and the rank-select launches.  The rank-select calls
    (``take_upto_row``, ``lru_take``) are watched: none may call
    pack_rows (the kernels read the bool runs), and each victim scan's
    (run length, k) is counted, with the first live mask of each pair.
    Returns (rows, launches, {(run length, k): [count, live mask]})."""
    from repro_torch.core.directory import RegionDirectory as RD
    rows = {(r["section"], r["protocol"], r["W"], r.get("driver")): r
            for r in json.loads(
                (ROOT / "BENCH_scale.json").read_text())["rows"]}
    scans = {}
    rank_packs = []
    plain_rank = {n: getattr(RD, n) for n in ("take_upto_row", "lru_take")}

    def watched(name):
        def call(self, live, k, *args):
            if name == "take_upto_row":
                seen = scans.setdefault((int(live.shape[0]), int(k)),
                                        [0, None])
                seen[0] += 1
                if seen[1] is None:
                    seen[1] = live.cpu().numpy().copy()
            packs = ps.CALLS["pack_rows"]
            out = plain_rank[name](self, live, k, *args)
            rank_packs.append(ps.CALLS["pack_rows"] - packs)
            return out
        return call
    danger = committed_danger()
    runs = [(pt, "fused") for pt in spill_points()]
    runs += [(pt, "kernels") for pt in spill_points()
             if pt[0] in ("fig4_refetch", "fig7_md_spill")]
    need = {"fused": ("popcount_rows", "phase_step", "take_and_cut"),
            "kernels": ("take_first_k", "kth_set_index")}
    per_backend = {b: dict.fromkeys(ps.LAUNCHES, 0) for b in need}
    out = []
    ps.reset_launches()
    for point, backend in runs:
        sec, tag, cache_pages = point[0], point[1], point[5]
        before = dict(ps.LAUNCHES)
        for name in plain_rank:
            setattr(RD, name, watched(name))
        try:
            rt, wall = run_spill_point(torch, point, backend, device)
        finally:
            for name, fn in plain_rank.items():
                setattr(RD, name, fn)
        launched = {k: ps.LAUNCHES[k] - before[k] for k in ps.LAUNCHES}
        for k, v in launched.items():
            per_backend[backend][k] += v
        row = rows[(sec, tag, W, "batched")]
        traffic = {f"tr_{f.name}": getattr(rt.traffic, f.name)
                   for f in dataclasses.fields(rt.traffic)}
        bad = {k: (v, row[k]) for k, v in traffic.items() if v != row[k]}
        t_model = round(rt.time, 6)
        counters = {"danger_vec": rt.stats["danger_vec_ops"],
                    "danger_scalar": rt.stats["danger_scalar_ops"],
                    "danger_shared": rt.stats["danger_shared_ops"]}
        want = danger.get((sec, tag, W, "batched"))
        if want is not None and counters != want:
            bad["danger"] = (counters, want)
        if bad or t_model != row["t_model_s"]:
            raise AssertionError(
                f"{sec} {tag} [{backend}]: drift {bad}, t_model {t_model} "
                f"vs committed {row['t_model_s']}")
        print(f"spill {sec:16s} {tag:15s} [{backend:7s}] wall {wall:.3f} s"
              f"  t_model {t_model}  {counters}  launches {launched}",
              flush=True)
        out.append({"section": sec, "series": tag, "W": W,
                    "backend": backend, "cache_pages": cache_pages,
                    "wall_s": wall, "t_model_s": t_model,
                    "launches": launched, "stats": dict(rt.stats),
                    **traffic})
    if device == "cuda":
        for backend, names in need.items():
            idle = [k for k in names if per_backend[backend][k] == 0]
            if idle:
                raise AssertionError(f"spill phase [{backend}]: kernels "
                                     f"{idle} never launched")
            if per_backend[backend]["pack_rows"]:
                raise AssertionError(
                    f"spill phase [{backend}]: launched pack_rows "
                    f"{per_backend[backend]['pack_rows']} times, which no "
                    "path needs")
    if any(rank_packs):
        raise AssertionError(f"spill phase: {sum(rank_packs)} pack_rows "
                             "calls inside take_upto_row / lru_take")
    hist = sorted(((n, key) for key, (n, _) in scans.items()), reverse=True)
    print(f"spill victim scans {sum(n for n, _ in hist)} (count, (run "
          f"length, k)): {hist}; rank-select calls {len(rank_packs)}, "
          "none calling pack_rows", flush=True)
    return out, dict(ps.LAUNCHES), scans


# ---------------------------------------------------------------------------
# reference phase
# ---------------------------------------------------------------------------


def same_run(a, b, ctx: str):
    """Two reference runtimes' traffic, per-worker traffic and clocks,
    bit for bit."""
    fields = [f.name for f in dataclasses.fields(a.traffic)]
    tr = [[getattr(t, f) for f in fields]
          for t in [a.traffic] + a.per_worker_traffic]
    tr_b = [[getattr(t, f) for f in fields]
            for t in [b.traffic] + b.per_worker_traffic]
    if tr != tr_b or a.clock.tobytes() != b.clock.tobytes():
        raise AssertionError(f"{ctx}: traffic or clocks differ "
                             f"({a.traffic} vs {b.traffic})")


def reference_phase(torch, np, device="cuda", W_=W,
                    sizes=(N_JACOBI, N_PARTICLES, N_TRIAD),
                    jacobi_iters=(700, 100, 100), iters=2):
    """The per-page reference engine (slice C).  (a) the program of
    examples/dsm_jacobi.py with values at n=32, W=4, 256-word pages:
    fine/lock (converges, max error < 0.05), fine/reduction and page/lock;
    (b) the paper's apps at W_ on the reference, samhita: Jacobi and MD in
    lock mode and STREAM at the harness's sizes, ``iters`` iterations:
    metadata-only against the scale engine (traffic exact, clocks
    allclose 1e-9), and with page values on ``device`` against the same
    run on the CPU (bit-equal traffic, clocks, page values).  On the card
    every run's diff_encode/diff_apply launches must equal the wrapper
    calls its CPU twin counted.  Returns (rows, launches of the phase)."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    from repro_torch.kernels import page_diff as pd
    on_card = device != "cpu"

    def timed(run, d):
        if d != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before, calls = dict(pd.LAUNCHES), dict(pd.CALLS)
        t0 = time.perf_counter()
        out = run(d)
        if d != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: pd.LAUNCHES[k] - before[k] for k in pd.LAUNCHES}
        called = {k: pd.CALLS[k] - calls[k] for k in pd.CALLS}
        mem = torch.cuda.max_memory_allocated() if d != "cpu" else None
        return out, wall, launched, called, mem

    def twins(name, run, values_of):
        """``run`` on the device and on the CPU, checked bit for bit."""
        (rt, *rest), wall, launched, _, mem = timed(run, device)
        row = {"point": name, "wall_s": wall, "max_memory_allocated": mem,
               "launches": launched, "traffic": dataclasses.asdict(
                   rt.traffic), "t_model_s": rt.time}
        if on_card:
            (cpu, *cpu_rest), cpu_wall, _, cpu_calls, _ = timed(run, "cpu")
            same_run(rt, cpu, name)
            got, want = values_of(rt, rest), values_of(cpu, cpu_rest)
            if got.tobytes() != want.tobytes():
                raise AssertionError(f"{name}: values differ from the CPU run")
            if launched != cpu_calls:
                raise AssertionError(f"{name}: launches {launched} != CPU "
                                     f"wrapper calls {cpu_calls}")
            row["cpu_wall_s"] = cpu_wall
        print(f"reference {name:34s} wall {wall:.3f} s  cpu twin "
              f"{row.get('cpu_wall_s', float('nan')):.3f} s  peak "
              f"{mem} B  launches {launched}  t_model {rt.time:.6f}",
              flush=True)
        return row, rt, rest

    rows = []
    pd.reset_launches()
    for proto, mode, it in zip(("fine", "fine", "page"),
                               ("lock", "reduction", "lock"), jacobi_iters):
        def run(d, proto=proto, mode=mode, it=it):
            rt = make_runtime(4, engine="reference", page_words=256,
                              protocol=proto, device=d)
            return (rt, *dsm_jacobi(rt, 32, it, mode))
        row, _, (u, err) = twins(f"dsm_jacobi {proto}/{mode} x{it}", run,
                                 lambda rt, rest: rest[0])
        if it >= 700 and not err < 0.05:
            raise AssertionError(f"dsm_jacobi {proto}/{mode}: max error "
                                 f"{err} >= 0.05, the solver diverged")
        row["max_error"] = err
        rows.append(row)
    for proto in ("fine", "page"):
        def run(d, proto=proto):
            rt = make_runtime(4, engine="reference", page_words=256,
                              protocol=proto, device=d)
            return (rt, *false_sharing(rt))
        row, _, (got, last) = twins(f"false sharing {proto} x8", run,
                                    lambda rt, rest: rest[0])
        if got.tobytes() != last.tobytes():
            raise AssertionError(f"false sharing {proto}: a word lost its "
                                 "last write")
        rows.append(row)
    n_jac, n_md, n_triad = sizes
    for app, n, kw in (("jacobi", n_jac, {"mode": "lock"}),
                       ("molecular_dynamics", n_md, {"mode": "lock"}),
                       ("stream_triad", n_triad, {})):
        def run(d, app=app, n=n, kw=kw, values=True):
            rt = make_runtime(W_, engine="reference", cost=IB_2013,
                              track_values=values, device=d)
            getattr(apps, app)(rt, n, iters, **kw)
            return (rt,)
        name = f"{app} {kw.get('mode', '')} W={W_} n={n}"
        (meta,), meta_wall, _, _, _ = timed(
            lambda d: run(d, values=False), device)
        scale = make_runtime(W_, cost=IB_2013, model_mechanism=False,
                             fetch_batch=1, device=device)
        getattr(apps, app)(scale, n, iters, **kw)
        if (dataclasses.asdict(meta.traffic)
                != dataclasses.asdict(scale.traffic)
                or not np.allclose(scale.clock, meta.clock, rtol=1e-9,
                                   atol=1e-12)):
            raise AssertionError(f"{name}: reference {meta.traffic} / "
                                 f"{meta.time} vs scale {scale.traffic} / "
                                 f"{scale.time}")
        print(f"reference {name:34s} metadata-only wall {meta_wall:.3f} s"
              f"  = scale engine  t_model {meta.time:.6f}", flush=True)
        row, _, _ = twins(name + " values", run,
                          lambda rt, rest: rt.home.cpu().numpy())
        row.update(meta_wall_s=meta_wall, meta_traffic=dataclasses.asdict(
            meta.traffic), meta_t_model_s=meta.time)
        rows.append(row)
    if on_card:
        idle = [k for k, v in pd.LAUNCHES.items() if v == 0]
        if idle:
            raise AssertionError(f"reference phase: kernels {idle} never "
                                 "launched")
    return rows, dict(pd.LAUNCHES)


def traced(torch, run):
    """Run ``run`` (which returns (anything, wall seconds)) under
    torch.profiler, tracing the device's activities only (host ops are
    not recorded: their events cost the reference Jacobi's run more than
    its wall to record and collect): its wall, the number of device
    activities recorded (kernels, copies, sets), the union of their
    intervals (device busy seconds) and the idle share of the wall; busy
    and idle are None when the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = run()
    # the raw trace's device events (in µs), the ones ``prof.events()``
    # turns into FunctionEvents: reading them here skips building the
    # event tree of every host op, which takes minutes on the reference
    # Jacobi's millions of host events
    spans = sorted((e.start_ns() * 1e-3, e.end_ns() * 1e-3)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not getattr(e, "is_hidden_event", lambda: False)())
    row = {"traced_wall_s": wall, "device_activities": len(spans),
           "device_busy_s": None, "idle_share": None}
    if spans:
        busy_us, end = 0.0, float("-inf")
        for a, b in spans:
            busy_us += max(0.0, b - max(a, end))
            end = max(end, b)
        busy = busy_us * 1e-6
        row.update(device_busy_s=busy, idle_share=1 - busy / wall)
    return row


def profile_phase(torch):
    """Device busy share of two fig6_weak points (samhita, lock and
    reduction mode) and of the fig4_refetch and fig7_md_spill points (the
    refetch replay's victim scans), on 'fused', and of the
    reference engine's W=256 Jacobi (lock, page values on the card, iters
    2), each in a separate traced run: the union of the intervals of every
    device activity torch.profiler records (kernels, copies, sets) over
    the run's wall.  The lock point (its spans through ``span_all``) may
    issue at most twice the reduction point's device activities.  The
    walls of the path phases above are untraced."""
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    runs = [(sec, tag, lambda a=app, s=series, m=mode, n=n: run_point(
                torch, make_runtime, apps, IB_2013, a, s, m, n, "fused"))
            for sec, tag, series, app, mode, n in main_points()
            if sec == "fig6_weak" and series == "samhita"]
    runs += [(pt[0], pt[1], lambda pt=pt: run_spill_point(torch, pt,
                                                          "fused"))
             for pt in spill_points()
             if pt[0] in ("fig4_refetch", "fig7_md_spill")]

    def reference_jacobi():
        t0 = time.perf_counter()
        rt = make_runtime(W, engine="reference", cost=IB_2013, device="cuda")
        apps.jacobi(rt, N_JACOBI, 2, mode="lock")
        torch.cuda.synchronize()
        return rt, time.perf_counter() - t0
    runs.append(("reference", "jacobi_lock_values", reference_jacobi))
    out = []
    for sec, tag, run in runs:
        row = {"section": sec, "series": tag, **traced(torch, run)}
        if row["device_busy_s"] is None:
            print(f"profile {sec} {tag}: torch.profiler recorded no device "
                  "activity; device busy share not measured", flush=True)
        else:
            print(f"profile {sec} {tag} traced wall "
                  f"{row['traced_wall_s']:.3f} s  device busy "
                  f"{row['device_busy_s'] * 1e3:.3f} ms "
                  f"({row['device_activities']} device activities)  idle "
                  f"share {row['idle_share']:.4f}", flush=True)
        out.append(row)
    # lock mode's spans run as grant groups around one hoisted flush: the
    # lock point issues at most twice the reduction point's activities
    weak = {r["series"]: r for r in out if r["section"] == "fig6_weak"}
    lock, red = weak["samhita_lock"], weak["samhita_reduction"]
    print(f"profile fig6_weak samhita: lock {lock['device_activities']} "
          f"device activities, idle share {lock['idle_share']}; reduction "
          f"{red['device_activities']}, idle share {red['idle_share']}",
          flush=True)
    if (not red["device_activities"]
            or lock["device_activities"] > 2 * red["device_activities"]):
        raise AssertionError(
            f"fig6_weak samhita lock: {lock['device_activities']} device "
            f"activities against the reduction point's "
            f"{red['device_activities']} (at most twice as many expected)")
    return out


def kernel_resources(_build):
    """Print each kernel's registers, static shared memory, stack and
    local-memory spills as ``ptxas -v`` reported them when its source was
    built (names demangled by ``cu++filt`` where the toolkit has it); the
    dynamic shared memory a kernel opts in to at launch is not in it.
    Returns the rows."""
    import shutil
    rows = [dict(k, source=src) for src in SOURCES
            for k in _build.resources(f"{src}.cu")]
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = [r["name"] for r in rows]
    if Path(filt).exists():
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True, timeout=60).stdout
        demangled = out.splitlines()
        if len(demangled) == len(names):
            names = demangled
    for r, name in zip(rows, names):
        short = name.strip()
        if short.endswith(")"):  # drop the parameter list
            depth = 0
            for i in range(len(short) - 1, -1, -1):
                depth += {")": 1, "(": -1}.get(short[i], 0)
                if depth == 0:
                    short = short[:i]
                    break
        for noise in ("void ", "(anonymous namespace)::", "<unnamed>::",
                      "(int)", "(bool)"):
            short = short.replace(noise, "")
        r["kernel"] = short
        print(f"ptxas {r['source']:15s} {short[:90]:90s} {r['registers']:3d} "
              f"registers, {r['smem_bytes']} B static shared, stack "
              f"{r['stack_bytes']} B, spill stores {r['spill_stores']} B, "
              f"spill loads {r['spill_loads']} B", flush=True)
    spills = [r["kernel"] for r in rows if r["spill_stores"] or
              r["spill_loads"]]
    print(f"ptxas: {len(rows)} kernels, {len(spills)} with local-memory "
          f"spills {spills}", flush=True)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch finds no CUDA device")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}; run "
                    "from the root of a checkout")
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels import protocol_sweep as ps

    card = card_line()
    print(card, flush=True)
    # the cluster phase's shards open CUDA contexts beside this process's
    print(f"compute mode: {compute_mode()}", flush=True)
    # float32 products in full float32 (no TF32) for every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    _build.build(*(Path(p).name for p in SOURCES.values()))
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    resources = kernel_resources(_build)

    phase_s = {"build": build_s}

    def phase(name, fn, *args, **kw):
        # each phase's wall, printed as it ends: the smoke's time budget
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    dev = torch.device("cuda")
    kernels = phase("kernel", kernel_phase, torch, np, ps, dev)
    points, launches = phase("main path", main_path_phase, torch, ps)
    spans, span_launches = phase("span", span_phase, torch, ps, card)
    races, race_launches = phase("race", race_phase, torch, ps, card)
    races += phase("race profile", race_profile, torch, card)
    serves, serve_launches = phase("serving", serving_phase, torch, ps,
                                   card)
    recoveries, recovery_launches = phase("recovery", recovery_phase,
                                          torch, ps, card)
    clusters, cluster_launches = phase(
        "cluster", cluster_phase, torch, ps, card,
        rpc_timeout_s=CARD_RPC_TIMEOUT_S, fault_shards=AVAIL_FAULT_SHARDS)
    spills, spill_launches, scans = phase("spill", spill_phase, torch, ps)
    # the rank-select kernels, timed at the spill phase's commonest scan
    kernels.update(phase("rank-select", rank_select_phase, torch, np, ps,
                         dev, scans, make_same(torch)))
    report_kernels(kernels)
    references, ref_launches = phase("reference", reference_phase, torch,
                                     np)
    profiled = phase("profile", profile_phase, torch)
    models, model_launches = phase("model", model_phase, torch, np)
    trains, train_launches = phase("train", train_phase, torch, np, card)
    regcs, regc_launches = phase("regc", regc_phase, torch, np, card)
    tps, tp_launches = phase("tp", tp_phase, torch, np, card)
    serve_tps, serve_tp_launches, sps, sp_launches = phase(
        "serve-tp and sp", serve_tp_phase, torch, np, card)
    launch_rows = phase("launch", launch_phase, torch, np, card, trains, sps)

    total = {k: launches[k] + spill_launches[k] + span_launches[k]
             + race_launches[k] + serve_launches[k] + recovery_launches[k]
             + cluster_launches[k] for k in ps.LAUNCHES}
    total.update(ref_launches)
    total.update(model_launches)
    for k, v in (list(train_launches.items()) + list(regc_launches.items())
                 + list(tp_launches.items())
                 + list(serve_tp_launches.items())
                 + list(sp_launches.items())):
        total[k] = total.get(k, 0) + v
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[SOURCE_OF[name]],
         "replaces": TPU_KERNELS[name], "launches": total[name],
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in kernels.items()]}
    print(f"launches on the main path: {launches}", flush=True)
    print(f"launches on the spill path: {spill_launches}", flush=True)
    print(f"launches on the reference path: {ref_launches}", flush=True)
    print(f"launches on the model path: {model_launches}", flush=True)
    print(f"launches on the train path: {train_launches}", flush=True)
    print(f"launches on the regc path: {regc_launches}", flush=True)
    print(f"launches on the tp path: {tp_launches}", flush=True)
    print(f"launches on the serve-tp path: {serve_tp_launches}", flush=True)
    print(f"launches on the sp path: {sp_launches}", flush=True)
    print(f"launches on the span path: {span_launches}", flush=True)
    print(f"launches on the race path: {race_launches}", flush=True)
    print(f"launches on the serving path: {serve_launches}", flush=True)
    print(f"launches on the recovery path: {recovery_launches}", flush=True)
    print(f"launches on the cluster path (in the shards): "
          f"{cluster_launches}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "phase_s": phase_s,
         "resources": resources,
         "kernel_phase": kernels,
         "points": points, "span_points": spans, "race_points": races,
         "serving_points": serves, "recovery_points": recoveries,
         "cluster_points": clusters,
         "spill_points": spills,
         "reference_points": references, "models": models,
         "train": trains, "launches_train": train_launches,
         "regc": regcs, "launches_regc": regc_launches,
         "tp": tps, "launches_tp": tp_launches,
         "serve_tp": serve_tps, "launches_serve_tp": serve_tp_launches,
         "sp": sps, "launches_sp": sp_launches, "launch": launch_rows,
         "victim_scans": [[L, k, n] for (L, k), (n, _) in scans.items()],
         "launches_main": launches, "launches_span": span_launches,
         "launches_race": race_launches,
         "launches_serving": serve_launches,
         "launches_recovery": recovery_launches,
         "launches_cluster": cluster_launches,
         "launches_spill": spill_launches,
         "launches_reference": ref_launches, "launches_model": model_launches,
         "profile": profiled, **table}, indent=1) + "\n")
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
