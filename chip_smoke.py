#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``lfm_quant_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout around this file; it
imports nothing of JAX. Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``lfm_quant_tpu_torch/csrc`` and print the
   build time and the compiler's register report;
3. hold every kernel against its plain PyTorch version on the card (TF32
   off): first at small awkward shapes (odd batch, T = 1, H not a
   multiple of 4, an all-invalid row, f32 and bf16; up to H 128 bf16
   reaches the tensor-core forwards and backwards, f32 the 3xTF32 ones,
   H 12 and 8 zero-padded to 16; H 136 the CUDA-core kernels, and the
   launch counters must say so; gathers that take
   the span copies and the narrow stores, and indices outside the panel)
   — the forward kernels on their outputs, the backward kernels on every
   gradient (scaled by its largest magnitude: f32 atol 1e-5, bf16 0.05,
   the tensor-core backwards' f32 weight gradients 1e-4), the gathers
   bitwise; then at the shapes the main paths give them — the serving
   dispatches of the c2 and c3 panels, and the c2 train step (B 2048, T
   60, H 128) on a real index batch from ``stacked_epoch`` — timing
   each kernel with CUDA events around one call (``ms``, the host's
   wrapper work included) and by its device time alone (``device_ms``:
   launches queued behind a device sleep), and its plain version, beside
   the kernel's bound:
   in bf16 the tensor-core forward (at 16, 32 and 64 rows per block too,
   and at the serving dispatches beside one cuDNN ``torch.nn.LSTM`` /
   ``GRU`` call on the same inputs with every step valid, its yardstick),
   its hoisted mode (row 1, beside the CUDA-core hoisted kernel on the
   same inputs in turns, and its seed grid bitwise equal to one-seed
   launches), both tensor-core backwards (the hoisted one beside the
   CUDA-core hoisted kernel on the same inputs, its private launcher),
   each backward's ``torch.matmul`` yardstick for its weight-gradient
   products; in float32 at the train step the 3xTF32 forwards (rows 3
   and 1, beside ``rnn_fused_fwd.cu`` on the same inputs, in turns; row 3
   beside cuDNN in float32) and backwards (rows 4 and 2, beside
   ``rnn_bwd.cu``), the fused forward's seed grid (S 3, b shared: bitwise
   equal to one-seed calls), the hoisted forms' seed grid (rows 1 and 2,
   S 3, W_h shared: one launch and one call, bitwise equal to one-seed
   calls, within atol 1e-5); the same four rows at hidden 120 (the
   3xTF32 kernels zero-padded to 128: the kernel's device time apart from
   the pads' ``pad_ms``, beside the CUDA-core kernels) and at hidden 160
   (``rnn_fused_fwd.cu`` and ``rnn_bwd.cu``, the route above 128), each
   f32 row beside its bound (of the unpadded work) at 3xTF32 and at the
   CUDA cores' rate and its library yardstick (TF32 off); two launches of
   each backward on the same inputs must give bitwise equal gradients;
4. serve: a ``ScoringService`` on the card with the c2 LSTM, the c3
   GRU, the c4 transformer and the lru universes at full width (random
   weights from a seed), warmed up, then closed-loop requests from 4
   threads; every served score vector is checked against the plain path
   on the card, and each universe's kernels' launch counters must have
   moved while it was served;
5. train c2: ``Trainer.fit`` trains c2 (LSTM, full width and data, bf16)
   for one epoch on the kernels, then the same steps from the same init
   and sampler order run through the plain path on the card (plain
   recurrence differentiated by autograd, plain gather); the per-step
   losses must agree within atol and rtol 0.05 and be finite, and the
   training kernels' counters must have moved. A few steps of the
   hoisted form (``scan_impl="pallas"``: the tensor-core hoisted forward
   and backward), of the GRU at c2's geometry, fused and hoisted, of both
   cells and both forms in float32 (the 3xTF32 forwards and backwards),
   and of the same four at hidden 120 (the 3xTF32 kernels, zero-padded)
   run the same way, and no CUDA-core kernel may launch in any; the
   float32 four at hidden 160 and at hidden 400 must launch the float32
   grid forwards (``rnn_fwd_tf32_grid.cu``) and the backwards the route
   gives them (the grid backward at 400), and the bf16 four at hidden 528
   the bf16 grid forwards and backwards (``rnn_fwd_grid.cu``,
   ``rnn_bwd_grid.cu``); on a grid backward one of each a step, the fused
   backward on the forward's xw in five kernels. The hoisted bf16
   step and the fused float32 step are also
   timed with their backward as routed and sent to the CUDA-core kernel,
   the fused float32 step with its forward so, and the fused float32
   hidden-120 step on its route and with every width sent to the CUDA
   cores, in turns.
   Prints steps/s,
   firm-months/s, ms per step, the forward, backward and optimizer times
   of one step and the device time by kernel;
6. the c5 ensemble (64 seeds of the LSTM, hidden 128, bf16, 8000 firms x
   660 months): at its train step's shape (S 64 x B 2048, T 60, H 128;
   the layer-0 input of a real stacked batch) the seed-batched fused
   forward and backward must be bitwise equal to one-seed launches with
   the same rows per block at the first, a middle and the last seed
   (``C5_CHECK_SEEDS``; the 64 one-seed launches and the plain version
   over the 64 seeds are timed), an operand of seed extent 1 (m) bitwise
   equal to its broadcast copy, and both within the plain version's
   tolerances; the seed-folded gather exact. Then ``EnsembleTrainer``
   trains c5 for one epoch (52 steps and the validation sweep) on the
   kernels from a seeded init: its first 2 steps' per-seed losses against
   the plain path on the card (``seed_block`` 8) within atol 0.05 + rtol
   0.05; one step moves the gather, tensor-core forward and backward
   counters by exactly 1 and no CUDA-core counter. Prints ms per step,
   seed-steps/s, firm-months/s, the epoch's wall time, the device's busy
   share of profiled steps and the peak memory;
7. the c5 backtest: the ensemble phase 6 trained is written to a run dir
   and reloaded through ``load_forecaster``; its test-split forecasts (64
   seeds; one seed-grid launch of the fused forward per month and seed
   chunk, counted), those of the split's first 8 months held to the
   plain path on the card (atol 0.05 + rtol 0.05); ``mean``,
   ``mean_minus_std@0.5`` and ``@2`` are aggregated and backtested in one
   ``run_scoring_pipeline`` pass on the card, and each report is held to
   the numpy engine run on the same host-fetched scores at the tolerances
   of ``tests/test_jax_backtest.py``. Prints the predict time, the
   scoring time against the numpy engine's, and the peak memory;
8. the c2 walk-forward: ``run_walkforward`` on c2 at full width, cut to 2
   folds of 1 epoch (step 12, val 24 months), each fold run and counted
   on its own (fold 1 resumes from fold 0's snapshot): each fold's steps
   launch the gather, the fused forward and its backward once per step
   (the forward also in the validation sweep and the forecast); the
   stitched validity is exactly the eligible cells of the two windows;
   the stitched panel is scored on the card (mode ``mean``) and held to
   the numpy engine. Prints the time of each fold and of the scoring;
9. c3 at full width (the GRU, hidden 128, bf16, 8000 x 480, the full
   cross-section: Bf the widest train pool rounded up, 8 x Bf windows a
   step; the rank-IC loss; ``n_data_shards`` 8 resolves to 1 in one
   process; epochs cut to 1): the gather, row 3 (beside one cuDNN
   ``nn.GRU`` call) and row 4 held to their plain versions and timed at
   the c3 step's shapes; the first 3 steps from the seeded init,
   counted, against the plain path on the card (atol 0.05 + rtol 0.05,
   finite); one step launches the gather, the tensor-core fused forward
   and its backward exactly once and nothing else; then ms per step,
   firm-months/s and the peak memory of steady steps, their profile (by
   kernel and by op group as in 11), one epoch with its validation sweep
   on the kernels (its wall time and peak memory), and the rank-IC
   loss's forward and backward, profiled alone, as a share of the step's
   device time, beside rows 3 and 4;
10. c3 on 2 processes that share the card (gloo, a ``file://``
   rendezvous in a temporary directory, ``n_data_shards`` 2, the kernels
   phase 2 built): each rank's first 3 steps' losses and grad norms and
   its month-sharded validation sweep within the training gate of phase
   9's one process, each rank's kernels launched, its ms per step; a
   rank that fails or outlives the limit fails the phase;
11. c4 at full width (the transformer, dim 64, depth 2, 4 heads, bf16,
   8000 x 480, 16 x 512 windows a step; ``n_data_shards`` 16 resolves to
   1; epochs cut to 1): the gather at the step's shape against its plain
   version; the first 3 steps against the plain path on the card (the
   plain gather; atol 0.05 + rtol 0.05, finite); one step launching the
   gather exactly once and nothing else; ms per step, firm-months/s and
   peak memory of steady steps, the device's busy share and the step's
   device time by op group (LayerNorm's forward and backward, timed in
   profiler ranges its modules open; attention's mask/softmax, the GEMMs,
   GELU, the other reductions, the gather, the optimizer, the rest); one
   epoch with its sweep, counted;
12. lru at c2's geometry as c4, then lru64 (64 LRU seeds at c5's
   geometry, ``seed_block`` 8; its seed-folded gather reported under the
   seed-fold row's label): 3 steps' per-seed losses against the plain
   path, the first block equal to an unblocked ensemble of its members,
   ms per step and peak memory;
13. c1 (the MLP) as c4; lc (window 240, 8 x 128 windows, ``n_seq_shards``
   8 resolving to 1) as c4 without the epoch, its attention scores
   ``[1024, 4, 240, 240]``;
14. MC-dropout: c4 with dropout 0.1 trains 3 steps twice from the seed
   (bitwise the same losses), then ``predict(mc_samples=4)`` of its test
   split: one gather launch per month chunk, samples that differ, a
   bitwise replay by ``mc_seed``, the plain predict's validity;
15. the seq axis: lc (window 240) and then lru (window 60) with
   ``n_seq_shards`` 2 on 2 processes sharing the card (as phase 10): the
   gather at each rank's sub-window (120 and 30 months) exact against
   its plain version; on each rank the ring at lc's step (layer 0's
   q/k/v blocks, f32 operands) against full attention in f32 (atol and
   rtol 1e-5), the first 3 steps' losses and grad norms within the
   training gate of phases 13 and 12's one process, the gather launched
   once a step and nothing else, ms per step and peak memory; one hop of
   the ring and its host staging alone timed, and their share of the
   step;
16. the seed axis: c5's 64 members on 2 processes sharing the card (32
   each): the seed-grid rows 3 and 4 and the seed-folded gather at the
   32-seed block (rank 0's first stacked batch, as phase 6 holds the
   64-seed one: the first, a middle and the last seed bitwise one-seed
   launches and within the plain version's tolerance); on each rank its
   members' first 2 steps' per-seed losses against phase 6's one
   process, rows 3 and 4 and the gather once a step, the forecasts of 3
   test months gathered over the seeds against phase 6's, ms per step
   and peak memory;
17. the factorized recurrences at c2's geometry (bf16): the LSTM at
   ``factor_rank`` 32 and the GRU at ``n_groups`` 4 as c4 without the
   epoch: 3 steps against the plain gather, one step launching the
   gather once and no recurrence kernel, ms per step and peak memory;
18. the serving stack: c2 and c3 at full width on one ``ScoringService``
   behind the HTTP front door (``serve/http.py make_http_server`` on
   127.0.0.1, port 0): closed-loop HTTP clients (req/s, the client's and
   the service's p50/p99, each request phase's mean and p99, every score
   held to the plain path on the card); the same load with
   ``LFM_METRICS=0`` and ``LFM_FLIGHT=0`` in turns (the plane's req/s
   overhead; a one-request-at-a-time pass bitwise equal either way);
   transient dispatch faults (retried, the pass bitwise equal); permanent
   faults until the circuit opens (``/healthz`` and ``/score`` 503 with
   ``Retry-After``, the half-open probe closes it, exactly one incident
   bundle); a small bounded queue offered twice what it admits (sheds,
   the admitted p99); an expired deadline (504, no kernel launched); c2
   refreshed for one epoch under load (no request dropped, each response
   one generation's and held to its plain path, rows 3 and 4 launched);
   then one ``{"serving_stack": {...}}`` line;
19. the heteroscedastic forward: c2 with ``loss="nll"`` for one epoch
   through ``run_experiment``, ``predict("test", return_variance=True)``
   held to the plain path on the card (mean and variance at the gate,
   the variance finite and > 0), timed with and without the variance; the
   backtest entry's ``--mode mean_minus_total_std`` on its run dir held
   to the numpy engine (``REPORT_TOL``); c5's 64 seeds the same way
   (``[64, N, T]`` variances, the report scored on the card); a two-fold
   heteroscedastic c2 walk-forward whose ``walkforward.npz`` carries the
   variances;
20. the async pipeline and preemption: c2 for 3 epochs under the four
   ``LFM_ASYNC`` x ``LFM_ASYNC_CKPT`` settings (history, best and
   early-stop epochs and restored params bitwise equal, else within the
   training gate with the decisions exact and the finding logged; one
   counted host sync per epoch; each epoch's wall), the device's gaps
   between epochs with the pipeline off and on (``torch.profiler``, 2
   epochs), c5 for 2 epochs with the pipeline on and off (epoch 0
   against phase 6's), and
   ``python -m lfm_quant_tpu_torch.train --preset c2 --epochs 3`` as a
   subprocess SIGTERM'd at its third checkpoint write (exit 75) and
   resumed (the uninterrupted fit's history and best params);
21. ``LFM_BUCKETS=1``: c2 and c5 for one epoch on the bucket ladder (the
   padded-cell counters, the ms per epoch), rows 3 and 4 and the gather
   at the smallest and the largest bucket (one seed for c2, the seed grid
   for c5) against their plain versions, the bucketed predict against
   the max-shape one within the gate;
22. the native sampler: c5's sampler geometry on the Python and the
   native engine (one epoch's host ms, the structure checks), then c2
   for one epoch with ``sampler_engine="native"``;
23. durable serving: c2 and c3 published into a store and scored on
   three months each, the service closed; ``python -m
   lfm_quant_tpu_torch.serve --persist DIR --restore --http PORT`` in a
   fresh process (each probe ``bit_equal``, 0 nvcc builds, one panel
   upload per universe, rows 3 and 5 launched, the same months bitwise
   over HTTP; its restore wall and first-response latency beside the
   cold register-and-warmup); a publisher SIGKILLed at
   ``manifest_write`` (``--refresh``), then a restore here: the old
   generation, bitwise, the staged one swept;
24. the fleet: two members (``python -m lfm_quant_tpu_torch.serve.fleet``)
   start from the store on the card and pass the join gate; four
   closed-loop HTTP clients through the ``FleetRouter`` over one member,
   then over both with one SIGKILLed mid-run (0 client errors, every
   response bitwise the pre-kill scores, failovers counted; req/s,
   p50/p99 before and after, goodput against one member); a replacement
   joins, and a second generation of c2 reaches both live members
   through ``/sync``;
25. entry telemetry: ``python -m lfm_quant_tpu_torch.train --preset c2
   --epochs 1`` and ``python -m lfm_quant_tpu_torch.backtest --run-dir``:
   their traces hold ``fit``, ``eval``, ``sample``, ``h2d``, ``predict``
   and ``score``, rendered by ``scripts/trace_report.py``; then one
   ``{"durable": ..., "fleet": ..., "entry_telemetry": ...}`` line;
26. stacked runs on c2 at full width: ``run_config_sweep`` (the
   ``--sweep-grid`` path) of a 4-config LR x weight-decay grid for 2
   epochs as one stack and one fit after another (each run's per-step
   losses within the training gate, epochs run, best epoch and ranking
   equal, its best val IC and best params within ``STACK_IC_LIMIT`` and
   ``STACK_PARAM_LIMIT`` of its sequential fit's, a planted control --
   sequential run 0 in place of each run, as a stack that collapsed its
   members' lr and weight decay would train them -- rejected wherever
   the lr differs, one seed-grid launch of rows 3-5 a stacked step;
   configs/hour both ways, ms per stacked step, the busy share over
   stacked steps,
   peak memory), ``run_walkforward(foldstack=True)`` over 3 folds of a
   rolling window against the sequential sweep (the same gates but the
   params, the stitched forecasts within the gate, folds/hour both
   ways), and the
   train entry's ``main`` for one epoch on a CSV panel (1000 x 240, two
   derived features) parsed natively without pandas; then one
   ``{"stacked_runs": ...}`` line;
27. c5 on the hoisted recurrence (``scan_impl="pallas"``, the JAX
   package's seed rules ``_make_scan._fwd_vmap`` and ``_bwd_vmap``): rows
   1 and 2 at the train step (S 64 x B 2048, T 60, H 128), one launch and
   one call for all seeds, three seeds bitwise equal to one-seed launches
   and within the plain version's tolerance, m of seed extent 1 bitwise
   its broadcast copy, timed beside 64 one-seed calls, the bound and the
   plain version; then ``EnsembleTrainer`` for 2 steps (each one gather,
   one forward launch and one backward call for the 64 seeds, nothing
   else) and a predict of 3 test months, counted; the losses against
   phase 6's plain path, the forecasts against the plain predict from the
   same params (atol 0.05 + rtol 0.05); ms per step and the step's peak
   memory beside phase 6's fused step;
28. every hidden width: c2 at hidden 256 (LSTM and GRU, bf16, on the
   CUDA-core kernels: rows 1-4 at its train step with the rows per block
   each launch chose, timed; 3 steps against the plain path, counted; the
   LSTM served from a ``ScoringService`` universe, every score against
   the plain path), rows 1-4 at hidden 320 and 512 (B 2048, T 60) against
   their plain versions (timed at 512), the CUDA-core seed grid at hidden
   256 (S 3, m shared: every seed bitwise its one-seed call), and two
   3-seed c2 ensembles with ``scan_impl="pallas"`` (hidden 256 on the CUDA
   cores, float32 on the 3xTF32 kernels) for 2 steps, one launch of each
   kernel a step, against the plain path; rows 4 and 2 in
   bf16 at hidden 528 on the bf16 grid in turns with ``rnn_bwd.cu``,
   beside cuDNN, its seed grids, and row 4 at the grid's widest, 1520;
   rows 3 and 1 there on the bf16 grid forward in turns with
   ``rnn_fused_fwd.cu``, beside cuDNN (bitwise repeatable and the same at
   two group sizes and at 64 and 128 rows, a 3-seed grid bitwise its
   one-seed calls, a grid past the card refused, the barrier waits, the
   recurrence's share, the all-gather's rate), the fused row 4 handed the
   forward's xw (five kernels, bitwise the row 4 that forms its own), rows
   3 and 1 at H 530 (Hp 544), 1024 and (row 3) 1520, and the c2 LSTM at
   hidden 528 served, every score against the plain path; rows 3 and 1 in
   float32 at hidden 400 on the float32 grid forward in turns with
   ``rnn_fused_fwd.cu`` beside cuDNN and the bound (h_all and c_all
   within atol 1e-5 of the plain version), its seed grid, a float32 grid
   past the card refused, the fused row 4 handed its xw (five kernels,
   within the scaled 1e-5), and rows 3 and 1 at 1024 held and timed;
29. print one ``{"kernels": [...]}`` line (launches: phases 4, 5, 8, 9,
   10, 11-15, 17-23, 26's sequential fits and 28's one-seed runs for the
   one-seed rows, 6, 7, 16, 19-21, 26's stacks, 27 and 28's ensembles for
   the seed rows);
30. print the result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC_REPO = "lfm_quant_tpu/ops"
H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores, H100 SXM
# An f32-accurate product on the tensor cores: 3xTF32, three TF32 products
# (495 TFLOP/s dense, H100 SXM) per f32 product.
H100_3XTF32_FLOPS = 495e12 / 3
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM
BF16_TOL = 0.05  # atol and rtol: the JAX package's own bf16 bound
F32_TOL = 1e-5   # atol: the JAX package's f32 bound for the fused op
# Scaled atol of the tensor-core backward's f32 weight gradients: its
# split of d_gates reads near 4e-6 at the c2 train step, rounding d_gates
# once to bf16 near 2e-3 (scripts/torch_mma_variants.py --kernel bwd).
MMA_WGRAD_TOL = 1e-4
GATES = {"lstm": 4, "gru": 3}
TRAIN_STEPS_SHORT = 4  # steps of the hoisted and GRU training runs
HOISTED_STEPS = 32     # timed steps of each backward in step_in_turns
# The widths of the float32 rows beside the c2 step's 128: one off a
# multiple of 16, which runs zero-padded on the 3xTF32 kernels; one above
# 128, where the forwards run on the float32 grid (rnn_fwd_tf32_grid.cu)
# and the backwards on the 3xTF32 cluster (rnn_bwd_tf32.cu), whose
# training runs and 3-seed ensemble are that cluster's main path; and one
# past the cluster's widths, whose training runs are the float32 grids'
# (rnn_fwd_tf32_grid.cu, rnn_bwd_tf32_grid.cu) main path. A bf16 width
# past the cluster kernels' 512, whose training runs are the bf16 grids'
# main path (rnn_fwd_grid.cu, rnn_bwd_grid.cu), and those grids' widest.
PADDED_HIDDEN = 120
F32_CLUSTER_HIDDEN = 160
PAST_CAP_HIDDEN = 400
CORE_BF16_HIDDEN = 528
BF16_GRID_WIDEST = 1520
# The device's sleep (clock cycles, about 10 ms) while the host queues the
# launches that device_ms times.
SLEEP_CYCLES = 20_000_000

# name → (source in the port, the TPU kernel it replaces). The CUDA-core
# kernels (float32 past 1024, bf16 past 1520) run on no main path since
# the grids took every width to 1024 and 1520: they are held and timed as
# the grids' "[before]" on the same inputs, the forwards in float32 at
# hidden 160 and 400 (and at 528 in bf16: suffixed records), the
# backwards at 528 in bf16. Measured at B 2048, T 60 (the kernels line
# keeps the largest shape). The 3xTF32 kernels (``*_tf32_*``) are
# measured in float32 at the c2 train step, at hidden 120, zero-padded to
# 128, and (the backwards, on a cluster) at hidden 160-384 (phase 28), the
# float32 grids (``*_grid_*``) at 400 (and 640 and 1024: suffixed
# records), the bf16 grids (``*_grid_bf16_*``) at 528 (and rows 3 and 4 at
# 1520: suffixed); the bf16 ones at the c2 train step and the serving
# dispatches.
SOURCES = {
    "rnn_fused_fwd_lstm": ("csrc/rnn_fused_fwd.cu", "pallas_rnn.py:626"),
    "rnn_fused_fwd_gru": ("csrc/rnn_fused_fwd.cu", "pallas_rnn.py:652"),
    "rnn_fused_fwd_tf32_lstm": ("csrc/rnn_fwd_tf32.cu", "pallas_rnn.py:626"),
    "rnn_fused_fwd_tf32_gru": ("csrc/rnn_fwd_tf32.cu", "pallas_rnn.py:652"),
    "rnn_fwd_tf32_lstm": ("csrc/rnn_fwd_tf32.cu", "pallas_rnn.py:135"),
    "rnn_fwd_tf32_gru": ("csrc/rnn_fwd_tf32.cu", "pallas_rnn.py:158"),
    "rnn_fused_fwd_mma_lstm": ("csrc/rnn_fused_fwd_mma.cu",
                               "pallas_rnn.py:626"),
    "rnn_fused_fwd_mma_gru": ("csrc/rnn_fused_fwd_mma.cu",
                              "pallas_rnn.py:652"),
    "rnn_fwd_mma_lstm": ("csrc/rnn_fused_fwd_mma.cu", "pallas_rnn.py:135"),
    "rnn_fwd_mma_gru": ("csrc/rnn_fused_fwd_mma.cu", "pallas_rnn.py:158"),
    "rnn_fused_bwd_lstm": ("csrc/rnn_bwd.cu", "pallas_rnn.py:673"),
    "rnn_fused_bwd_gru": ("csrc/rnn_bwd.cu", "pallas_rnn.py:739"),
    "rnn_fused_bwd_mma_lstm": ("csrc/rnn_fused_bwd_mma.cu",
                               "pallas_rnn.py:673"),
    "rnn_fused_bwd_mma_gru": ("csrc/rnn_fused_bwd_mma.cu",
                              "pallas_rnn.py:739"),
    "rnn_fwd_lstm": ("csrc/rnn_fused_fwd.cu", "pallas_rnn.py:135"),
    "rnn_fwd_gru": ("csrc/rnn_fused_fwd.cu", "pallas_rnn.py:158"),
    "rnn_bwd_lstm": ("csrc/rnn_bwd.cu", "pallas_rnn.py:184"),
    "rnn_bwd_gru": ("csrc/rnn_bwd.cu", "pallas_rnn.py:243"),
    "rnn_bwd_mma_lstm": ("csrc/rnn_fused_bwd_mma.cu", "pallas_rnn.py:184"),
    "rnn_bwd_mma_gru": ("csrc/rnn_fused_bwd_mma.cu", "pallas_rnn.py:243"),
    "rnn_fused_bwd_tf32_lstm": ("csrc/rnn_bwd_tf32.cu", "pallas_rnn.py:673"),
    "rnn_fused_bwd_tf32_gru": ("csrc/rnn_bwd_tf32.cu", "pallas_rnn.py:739"),
    "rnn_bwd_tf32_lstm": ("csrc/rnn_bwd_tf32.cu", "pallas_rnn.py:184"),
    "rnn_bwd_tf32_gru": ("csrc/rnn_bwd_tf32.cu", "pallas_rnn.py:243"),
    "rnn_fused_fwd_cluster_lstm": ("csrc/rnn_fwd_cluster.cu",
                                   "pallas_rnn.py:626"),
    "rnn_fused_fwd_cluster_gru": ("csrc/rnn_fwd_cluster.cu",
                                  "pallas_rnn.py:652"),
    "rnn_fwd_cluster_lstm": ("csrc/rnn_fwd_cluster.cu", "pallas_rnn.py:135"),
    "rnn_fwd_cluster_gru": ("csrc/rnn_fwd_cluster.cu", "pallas_rnn.py:158"),
    "rnn_fused_bwd_cluster_lstm": ("csrc/rnn_bwd_cluster.cu",
                                   "pallas_rnn.py:673"),
    "rnn_fused_bwd_cluster_gru": ("csrc/rnn_bwd_cluster.cu",
                                  "pallas_rnn.py:739"),
    "rnn_bwd_cluster_lstm": ("csrc/rnn_bwd_cluster.cu", "pallas_rnn.py:184"),
    "rnn_bwd_cluster_gru": ("csrc/rnn_bwd_cluster.cu", "pallas_rnn.py:243"),
    "rnn_fused_bwd_grid_lstm": ("csrc/rnn_bwd_tf32_grid.cu",
                                "pallas_rnn.py:673"),
    "rnn_fused_bwd_grid_gru": ("csrc/rnn_bwd_tf32_grid.cu",
                               "pallas_rnn.py:739"),
    "rnn_bwd_grid_lstm": ("csrc/rnn_bwd_tf32_grid.cu", "pallas_rnn.py:184"),
    "rnn_bwd_grid_gru": ("csrc/rnn_bwd_tf32_grid.cu", "pallas_rnn.py:243"),
    "rnn_fused_fwd_grid_lstm": ("csrc/rnn_fwd_tf32_grid.cu",
                                "pallas_rnn.py:626"),
    "rnn_fused_fwd_grid_gru": ("csrc/rnn_fwd_tf32_grid.cu",
                               "pallas_rnn.py:652"),
    "rnn_fwd_grid_lstm": ("csrc/rnn_fwd_tf32_grid.cu", "pallas_rnn.py:135"),
    "rnn_fwd_grid_gru": ("csrc/rnn_fwd_tf32_grid.cu", "pallas_rnn.py:158"),
    "rnn_fused_bwd_grid_bf16_lstm": ("csrc/rnn_bwd_grid.cu",
                                     "pallas_rnn.py:673"),
    "rnn_fused_bwd_grid_bf16_gru": ("csrc/rnn_bwd_grid.cu",
                                    "pallas_rnn.py:739"),
    "rnn_bwd_grid_bf16_lstm": ("csrc/rnn_bwd_grid.cu", "pallas_rnn.py:184"),
    "rnn_bwd_grid_bf16_gru": ("csrc/rnn_bwd_grid.cu", "pallas_rnn.py:243"),
    "rnn_fused_fwd_grid_bf16_lstm": ("csrc/rnn_fwd_grid.cu",
                                     "pallas_rnn.py:626"),
    "rnn_fused_fwd_grid_bf16_gru": ("csrc/rnn_fwd_grid.cu",
                                    "pallas_rnn.py:652"),
    "rnn_fwd_grid_bf16_lstm": ("csrc/rnn_fwd_grid.cu", "pallas_rnn.py:135"),
    "rnn_fwd_grid_bf16_gru": ("csrc/rnn_fwd_grid.cu", "pallas_rnn.py:158"),
    "window_gather": ("csrc/window_gather.cu", "pallas_gather.py:100"),
}
# The served universes: preset → (requests, the kernels its dispatches
# launch).
SERVED = {
    "c2": (48, ("rnn_fused_fwd_mma_lstm", "window_gather")),
    "c3": (24, ("rnn_fused_fwd_mma_gru", "window_gather")),
    "c4": (24, ("window_gather",)),
    "lru": (24, ("window_gather",)),
}
# The seed-batched launches at the c5 train step: line name → (launch
# counter, source, the TPU kernel it replaces and its seed rule).
SEED_SOURCES = {
    "rnn_fused_fwd_mma_lstm_seeds": (
        "rnn_fused_fwd_mma_lstm", "csrc/rnn_fused_fwd_mma.cu",
        "pallas_rnn.py:626 (seed grid: _fwd_vmap :919)"),
    "rnn_fused_bwd_mma_lstm_seeds": (
        "rnn_fused_bwd_mma_lstm", "csrc/rnn_fused_bwd_mma.cu",
        "pallas_rnn.py:673 (seed grid: _bwd_vmap :951)"),
    "window_gather_seeds": (
        "window_gather", "csrc/window_gather.cu",
        "pallas_gather.py:100 (seed fold: _call_vmap :169)"),
    "rnn_fwd_mma_lstm_seeds": (
        "rnn_fwd_mma_lstm", "csrc/rnn_fused_fwd_mma.cu",
        "pallas_rnn.py:135 (seed grid: _make_scan._fwd_vmap :504)"),
    "rnn_bwd_mma_lstm_seeds": (
        "rnn_bwd_mma_lstm", "csrc/rnn_fused_bwd_mma.cu",
        "pallas_rnn.py:184 (seed grid: _make_scan._bwd_vmap :541)"),
    "rnn_fwd_tf32_lstm_seeds": (
        "rnn_fwd_tf32_lstm", "csrc/rnn_fwd_tf32.cu",
        "pallas_rnn.py:135 (seed grid: _make_scan._fwd_vmap :504)"),
    "rnn_bwd_tf32_lstm_seeds": (
        "rnn_bwd_tf32_lstm", "csrc/rnn_bwd_tf32.cu",
        "pallas_rnn.py:184 (seed grid: _make_scan._bwd_vmap :541)"),
    "rnn_fwd_lstm_seeds": (
        "rnn_fwd_lstm", "csrc/rnn_fused_fwd.cu",
        "pallas_rnn.py:135 (seed grid: _make_scan._fwd_vmap :504)"),
    "rnn_bwd_lstm_seeds": (
        "rnn_bwd_lstm", "csrc/rnn_bwd.cu",
        "pallas_rnn.py:184 (seed grid: _make_scan._bwd_vmap :541)"),
    "rnn_fwd_cluster_lstm_seeds": (
        "rnn_fwd_cluster_lstm", "csrc/rnn_fwd_cluster.cu",
        "pallas_rnn.py:135 (seed grid: _make_scan._fwd_vmap :504)"),
    "rnn_bwd_cluster_lstm_seeds": (
        "rnn_bwd_cluster_lstm", "csrc/rnn_bwd_cluster.cu",
        "pallas_rnn.py:184 (seed grid: _make_scan._bwd_vmap :541)"),
    "rnn_bwd_grid_lstm_seeds": (
        "rnn_bwd_grid_lstm", "csrc/rnn_bwd_tf32_grid.cu",
        "pallas_rnn.py:184 (seed grid: _make_scan._bwd_vmap :541)"),
    "rnn_bwd_grid_bf16_lstm_seeds": (
        "rnn_bwd_grid_bf16_lstm", "csrc/rnn_bwd_grid.cu",
        "pallas_rnn.py:184 (seed grid: _make_scan._bwd_vmap :541)"),
    "rnn_fwd_grid_bf16_lstm_seeds": (
        "rnn_fwd_grid_bf16_lstm", "csrc/rnn_fwd_grid.cu",
        "pallas_rnn.py:135 (seed grid: _make_scan._fwd_vmap :504)"),
    "rnn_fwd_grid_lstm_seeds": (
        "rnn_fwd_grid_lstm", "csrc/rnn_fwd_tf32_grid.cu",
        "pallas_rnn.py:135 (seed grid: _make_scan._fwd_vmap :504)"),
}
PLAIN_STEPS = 3      # steps of each model held against the plain path
TIMED_STEPS = 4      # steps of each model timed
PROFILE_STEPS = 1    # steps of each model under the profiler (its events
#                      of many small kernels cost seconds a step to read)
C3_KERNELS = ("window_gather", "rnn_fused_fwd_mma_gru",
              "rnn_fused_bwd_mma_gru")
CARD_RANKS = 2       # phases 10, 15 and 16's processes on the one card
RANKS_TIMEOUT_S = 600
C5_PLAIN_STEPS = 2   # c5 steps held against the plain path
C5_CHECK_SEEDS = (0, 31, 63)  # c5 seeds held bitwise to one-seed launches
C5_PLAIN_BLOCK = 8   # seed_block of the plain path (its autograd memory)
C5_PREDICT_MONTHS = 3  # test months phase 16's gathered forecasts cover
C5_PLAIN_PREDICT_MONTHS = 8  # phase 7's test months held to the plain path
GATHER_NO_LIBRARY = (
    "no single PyTorch call: one advanced index reads the raw rows; the "
    "window also needs the validity column split off and the masked and "
    "pre-panel months zero-filled (the plain version's three ops)")
# Phase 7: the aggregation modes backtested in one pass.
C5_MODES = ("mean", ("mean_minus_std", 0.5), ("mean_minus_std", 2.0))
# tests/test_jax_backtest.py's TOL: the device engine against the numpy
# engine (float32 series; report math shared).
REPORT_TOL = dict(ret=2e-6, ic=5e-4, profile=2e-6, turn=1e-6)
# Phase 8: the c2 walk-forward, cut from the preset's 30 epochs.
WF_FOLDS, WF_STEP, WF_VAL, WF_EPOCHS = 2, 12, 24, 1
CUDA_CORE = ("rnn_fused_fwd_lstm", "rnn_fused_fwd_gru", "rnn_fused_bwd_lstm",
             "rnn_fused_bwd_gru", "rnn_fwd_lstm", "rnn_fwd_gru",
             "rnn_bwd_lstm", "rnn_bwd_gru")
TF32 = tuple(f"rnn_{form}_tf32_{cell}" for form in ("fused_fwd", "fwd",
                                                    "fused_bwd", "bwd")
             for cell in ("lstm", "gru"))
GRID = tuple(f"rnn_{form}_grid_{cell}"
             for form in ("fused_fwd", "fwd", "fused_bwd", "bwd")
             for cell in ("lstm", "gru"))


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the script's log, stamped with the seconds since it
    started (where the wall goes)."""
    print(f"[chip_smoke {time.perf_counter() - T_START:6.1f}] {msg}",
          flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10, launches: int = 10) -> float:
    """Median device time of one ``fn`` call with the host's time taken
    out: the device sleeps while the host queues ``launches`` calls, which
    then run back to back between two CUDA events. Fails if the host had
    not queued them all before the sleep ended (the device would have
    waited for it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms >= slept.elapsed_time(start):
            fail(f"device_ms: queueing {launches} calls took {host_ms:.3f} "
                 f"ms, longer than the device's sleep "
                 f"({slept.elapsed_time(start):.3f} ms)")
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def kernel_ms(fn, reps: int = 10, launches: int = 10) -> dict:
    """A kernel's two times: ``ms``, one call between CUDA events with the
    host's wrapper work and launch inside them (``time_ms``, the reading
    the kernels line has always given), and ``device_ms``, the device's
    time alone (``device_ms``)."""
    return dict(ms=time_ms(fn, reps=reps),
                device_ms=device_ms(fn, reps=reps, launches=launches))


def host_ms(fn, reps: int = 10) -> float:
    """Median host time (ms) of one ``fn`` call started on an idle device:
    the wrapper's work and the launches' enqueue."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def worst_excess(got, want, atol: float, rtol: float):
    """(max |got - want|, max of |got - want| - (atol + rtol |want|))."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return err.max().item(), (err - (atol + rtol * w.abs())).max().item()


def scaled_err(got, want) -> float:
    """max |got - want| / max |want|: the JAX tests' gradient rule."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / (w.abs().max() + 1e-9)).item()


def grads_close(name: str, got, want, dtype, wgrad_tol=None) -> float:
    """Every gradient of a backward within the scaled tolerance, the
    weight gradients (all but the first) within ``wgrad_tol`` where given;
    returns the worst scaled error."""
    import torch

    base = F32_TOL if dtype == torch.float32 else BF16_TOL
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        tol = wgrad_tol if i > 0 and wgrad_tol is not None else base
        err = scaled_err(g, w)
        if not (err <= tol) or not torch.isfinite(g).all():
            fail(f"{name}: scaled error {err} over {tol}")
        worst = max(worst, err)
    return worst


def widest_dispatch(panel, data, rows: int):
    """The widest serving dispatch of a panel: ``rows`` months of its widest
    width bucket, as ``serving_batch`` builds them → ``(firm_idx [rows,
    width], time_idx [rows])`` int32 numpy."""
    from lfm_quant_tpu_torch.buckets import width_ladder
    from lfm_quant_tpu_torch.data.windows import DateBatchSampler

    sampler = DateBatchSampler(panel, data.window, 1, 8,
                               min_valid_months=data.min_valid_months,
                               min_cross_section=1, require_target=False)
    cols = sampler.months_with_anchors()
    width = max(width_ladder(sampler.cross_section(int(t)).size
                             for t in cols))
    return serving_batch(sampler.cross_section, cols, width, rows)


def serving_batch(entry_pools, cols, width: int, rows: int):
    """An index batch as the batcher builds it: ``rows`` months whose
    pools fall in the ``width`` bucket, pad columns repeating the last
    firm, at weight 0."""
    import numpy as np

    from lfm_quant_tpu_torch.buckets import bucket_width

    picked = [t for t in cols if bucket_width(entry_pools(t).size) == width]
    picked = picked[-rows:]
    if len(picked) < rows:
        fail(f"only {len(picked)} months in the {width} bucket")
    fi = np.zeros((rows, width), np.int32)
    ti = np.zeros((rows,), np.int32)
    for i, t in enumerate(picked):
        pool = entry_pools(t)
        fi[i, :pool.size] = pool
        fi[i, pool.size:] = pool[-1]
        ti[i] = t
    return fi, ti


def gather_bound(fi, ti, window: int, fp: int, n_months: int,
                 itemsize: int) -> float:
    """Least time (ms) for the gather on these indices: each panel row the
    windows touch read once, the outputs written once, the indices read,
    all at the card's memory rate (it does no arithmetic)."""
    import numpy as np

    touched = np.zeros((int(fi.max()) + 1, n_months), bool)
    for d in range(fi.shape[0]):
        lo = max(0, int(ti[d]) - window + 1)
        touched[np.unique(fi[d])[:, None],
                np.arange(lo, int(ti[d]) + 1)[None, :]] = True
    read = int(touched.sum()) * fp * itemsize + fi.nbytes + ti.nbytes
    out = fi.size * window * ((fp - 1) * itemsize + 1)
    return (read + out) / H100_BYTES_PER_S * 1e3


def rnn_bound(kind: str, cell: str, B: int, T: int, H: int,
              itemsize: int, save_c: bool = False, seeds: int = 1,
              f32_flops: float = H100_3XTF32_FLOPS):
    """Least time (ms) of one recurrence kernel call, and what bounds it:
    its products' operations at the peak for its operand type against
    each input read once and each output written once at the memory rate.
    An f32 product that must hold f32 accuracy runs at ``f32_flops``: by
    default 3xTF32 on the tensor cores (495 / 3 TFLOP/s), the least time;
    ``H100_F32_FLOPS`` gives the CUDA cores' 67 TFLOP/s.

    Per row and step, one [H] @ [H, G*H] product is 2 G H^2 operations:
    the fused forward does 2 (x and h side), the hoisted forward 1, the
    fused backward 6 (2 recomputed, dh and dhin, dW_x and dW_h) and the
    hoisted backward 3. Bytes: the fused forms stream hin [B,T,H], the
    hoisted ones xw [B,T,G*H]; the forwards write h (serving: no c); the
    backwards read h_all, c_all (LSTM) and dh, write dhin or dxw, and the
    f32 weight gradients. A forward that saves c_all (``save_c``, LSTM)
    also writes it. ``seeds``: a seed-batched call of that many seeds,
    each of B rows with its own weights."""
    G = GATES[cell]
    GH = G * H
    products = {"fused_fwd": 2, "fwd": 1, "fused_bwd": 6, "bwd": 3}[kind]
    B *= seeds
    ops = products * 2.0 * GH * H * B * T
    seq = B * T * H * itemsize
    xw = B * T * GH * itemsize
    weights = seeds * (2 * H + 1) * GH * itemsize
    c_all = seq if save_c and cell == "lstm" else 0
    if kind == "fused_fwd":
        nbytes = 2 * seq + c_all + B * T + weights
    elif kind == "fwd":
        nbytes = xw + seq + c_all + B * T + seeds * H * GH * itemsize
    else:
        states = (3 if cell == "lstm" else 2) * seq
        if kind == "fused_bwd":
            nbytes = (seq + states + seq + weights
                      + seeds * (2 * H + 1) * GH * 4)
        else:
            nbytes = xw + states + xw + seeds * H * GH * (itemsize + 4)
        nbytes += B * T
    peak = H100_BF16_FLOPS if itemsize == 2 else f32_flops
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rnn_inputs(torch, gen, cell, B, T, H, dtype):
    G = GATES[cell] * H
    hin = torch.randn(B, T, H, generator=gen).to(dtype).cuda()
    wx = (0.3 * torch.randn(H, G, generator=gen)).to(dtype).cuda()
    b = (0.1 * torch.randn(G, generator=gen)).to(dtype).cuda()
    wh = (0.3 * torch.randn(H, G, generator=gen)).to(dtype).cuda()
    m = (torch.rand(B, T, generator=gen) < 0.75).cuda()
    m[0] = False  # an all-invalid row stays at the zero state
    return hin, wx, b, wh, m


def check_gather(torch, kernels, where: str, xm, fi_np, ti_np, window: int,
                 fp: int, n_months: int, row: str = "window_gather"):
    """The gather at a main path's index batch ``[D, Bf]``: exact against
    its plain version, timed beside its bound, kept under the kernels
    line's ``row`` (a seed-folded batch under ``window_gather_seeds``).
    Returns its windows."""
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed
    from lfm_quant_tpu_torch.ops.gather import gather_windows

    fi = torch.from_numpy(fi_np).cuda()
    ti = torch.from_numpy(ti_np).cuda()
    x, m = gather_windows(xm, fi, ti, window, fp=fp)
    xr, mr = gather_windows_packed(xm, fi, ti, window, fp=fp)
    torch.cuda.synchronize()
    if not (torch.equal(x, xr) and torch.equal(m, mr)):
        fail(f"gather at the {where} shape differs")
    del xr, mr
    report(kernels, row, where, dict(
        shape=list(x.shape), max_abs_err=0.0, tolerance="exact",
        **kernel_ms(lambda: gather_windows(xm, fi, ti, window, fp=fp),
                    launches=20),
        plain_ms=time_ms(lambda: gather_windows_packed(xm, fi, ti, window,
                                                       fp=fp)),
        bound_ms=gather_bound(fi_np, ti_np, window, fp, n_months,
                              xm.element_size()),
        bound_by="bytes", library_ms=None, library_note=GATHER_NO_LIBRARY))
    return x, m


def check_small(torch, gen) -> None:
    """Kernels against plain versions at small awkward shapes: odd batch,
    T = 1, H not a multiple of 4 or 16 (zero-padded onto the tensor
    cores), H above 128 (the CUDA-core kernels), all-invalid rows, young
    and tail anchors, a panel shorter than the window, float32 and
    bfloat16."""
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.ops.gather import gather_windows

    for cell in ("lstm", "gru"):
        for dt, atol, rtol in ((torch.float32, F32_TOL, 0.0),
                               (torch.bfloat16, BF16_TOL, BF16_TOL)):
            for B, T, H in ((13, 7, 12), (37, 1, 16), (3, 9, 8),
                            (37, 9, 64), (21, 5, 16), (7, 5, 136)):
                hin, wx, b, wh, m = rnn_inputs(torch, gen, cell, B, T, H, dt)
                xw = (hin.float() @ wx.float() + b.float()).to(dt)
                # Up to H 128 bf16 takes the tensor-core forwards and
                # backwards and f32 the 3xTF32 ones (12 and 8 zero-padded
                # to 16); at H 136 f32 keeps the CUDA-core ones and bf16
                # takes the cluster forwards and backwards (padded to 144).
                mma = R._mma_route(dt, H) == "mma"
                tags = {"mma": "mma_", "tf32": "tf32_", "cluster": "cluster_",
                        "grid": "grid_", "simt": ""}
                tag = tags[R._mma_route(dt, H, "bwd")]
                fwd_tag = tags[R._mma_route(dt, H)]
                fwd_kernel = f"rnn_fused_fwd_{fwd_tag}{cell}"
                hoist_fwd = f"rnn_fwd_{fwd_tag}{cell}"
                bwd_kernel = f"rnn_fused_bwd_{tag}{cell}"
                hoist_kernel = f"rnn_bwd_{tag}{cell}"
                _build.reset_launch_counts()
                with torch.no_grad():
                    fused = R.rnn_scan_fused(cell, hin, wx, b, wh, m)
                    hoisted = R.rnn_scan(cell, xw, wh, m)
                    counts = _build.launch_counts()
                    if counts[fwd_kernel] != 1 or counts[hoist_fwd] != 1:
                        fail(f"fwd {cell} {dt} {(B, T, H)} did not launch "
                             f"{fwd_kernel} and {hoist_fwd}: {counts}")
                    pairs = (
                        ("fused fwd", fused,
                         R.rnn_scan_fused_reference(cell, hin, wx, b, wh, m)),
                        ("fwd", hoisted,
                         R.rnn_scan_reference(cell, xw, wh, m)))
                for form, out, ref in pairs:
                    torch.cuda.synchronize()
                    err, excess = worst_excess(out, ref, atol, rtol)
                    if excess > 0 or out[0].abs().max().item() != 0:
                        fail(f"rnn {form} {cell} {dt} {(B, T, H)}: max err "
                             f"{err}")
                # The backwards on saved states from the plain forward.
                dh = torch.randn(B, T, H, generator=gen).to(dt).cuda()
                h, c = R.rnn_scan_states(
                    cell, hin.float() @ wx.float() + b.float(), wh, m)
                h, c = h.to(dt), (None if c is None else c.to(dt))
                _build.reset_launch_counts()
                got = R.rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh)
                if _build.launch_counts()[bwd_kernel] != 1:
                    fail(f"fused bwd {cell} {dt} {(B, T, H)} did not launch "
                         f"{bwd_kernel}")
                e4 = grads_close(
                    f"fused bwd {cell} {dt} {(B, T, H)}", got,
                    R.rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m,
                                                   h, c, dh), dt,
                    MMA_WGRAD_TOL if mma else None)
                hx, cx = R.rnn_scan_states(cell, xw, wh, m)
                _build.reset_launch_counts()
                got = R.rnn_scan_bwd(cell, xw, wh, m, hx, cx, dh)
                if _build.launch_counts()[hoist_kernel] != 1:
                    fail(f"hoisted bwd {cell} {dt} {(B, T, H)} did not "
                         f"launch {hoist_kernel}")
                e2 = grads_close(
                    f"bwd {cell} {dt} {(B, T, H)}", got,
                    R.rnn_scan_bwd_reference(cell, xw, wh, m, hx, cx, dh),
                    dt, MMA_WGRAD_TOL if mma else None)
                log(f"small rnn {cell} {str(dt)[6:]} B,T,H={(B, T, H)} "
                    f"fwd ok ({fwd_kernel}, {hoist_fwd}), bwd scaled err "
                    f"fused {e4:.3g} ({bwd_kernel}) hoisted {e2:.3g} "
                    f"({hoist_kernel}) ok")
    # The gathers: span copies (c2's fp 21 and W 60 in both types, fp 6
    # in f32; lane-padded to Fp 32 in bf16) and narrow stores (F < 8 in
    # bf16, F = 7, young anchors); the last shape with anchors past the
    # panel's end and before its start and firm indices outside it
    # (clamped, as XLA clamps a gather: held to the plain gather of the
    # clamped indices).
    for dt in (torch.float32, torch.bfloat16):
        for N, T, fp, W, D, Bf, pad in (
                (7, 23, 4, 9, 5, 13, 0), (7, 5, 4, 9, 3, 6, 0),
                (11, 64, 6, 60, 4, 33, 0), (7, 30, 8, 9, 3, 10, 0),
                (9, 80, 21, 60, 6, 37, 0), (9, 80, 21, 60, 6, 37, 11),
                (9, 80, 21, 60, 5, 37, -1)):
            xm = torch.randn(N, T, fp + max(pad, 0), generator=gen)
            xm[..., fp - 1] = (torch.rand(N, T, generator=gen) < 0.8).float()
            xm[..., fp:] = 0.0
            xm = xm.to(dt).cuda()
            fi = torch.randint(0, N, (D, Bf), generator=gen,
                               dtype=torch.int32).cuda()
            ti = torch.randint(0, T, (D,), generator=gen,
                               dtype=torch.int32).cuda()
            ti[0], ti[-1] = 0, T - 1  # youngest and newest anchors
            if pad < 0:
                ti[1:4] = torch.tensor([T + 5, -3, 2 * W], dtype=torch.int32)
                fi[2, :3] = torch.tensor([-4, N, N + 7], dtype=torch.int32)
            x, m = gather_windows(xm, fi, ti, W, fp=fp)
            xr, mr = gather_windows_packed(xm, fi.clamp(0, N - 1), ti, W,
                                           fp=fp)
            torch.cuda.synchronize()
            if not (torch.equal(x.view(torch.uint8), xr.view(torch.uint8))
                    and torch.equal(m, mr)):
                fail(f"gather {dt} {(N, T, fp, W, D, Bf, pad)} differs")
            log(f"small gather {str(dt)[6:]} N,T,fp,W,D,Bf,pad="
                f"{(N, T, fp, W, D, Bf, pad)} exact ok")


def report(kernels: dict, name: str, where: str, rec: dict) -> None:
    """Keep one kernel measurement and print it as a JSON line."""
    kernels.setdefault(name, []).append(rec)
    log("kernel " + json.dumps(dict(name=name, at=where, **rec)))


def cudnn_module(torch, cell: str, hin, wx, b, wh):
    """``torch.nn.LSTM`` or ``torch.nn.GRU`` holding the row's weights →
    ``(module, perm)``: W_x^T and W_h^T with the JAX gate order permuted
    for the GRU (PyTorch's r, z, n; ``perm`` maps PyTorch's gate rows to
    the JAX columns), ``forget_bias`` 1 folded into the f slice of
    ``b_ih``, ``b_hh`` 0."""
    H = wh.shape[0]
    mod = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(
        hin.shape[-1], H, batch_first=True).to(device=hin.device,
                                                dtype=hin.dtype)
    bias = b.float().clone()
    if cell == "lstm":
        perm = torch.arange(4 * H, device=hin.device)
        bias[H:2 * H] += 1.0
    else:
        perm = torch.cat([torch.arange(H, 2 * H), torch.arange(H),
                          torch.arange(2 * H, 3 * H)]).to(hin.device)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(wx.t()[perm])
        mod.weight_hh_l0.copy_(wh.t()[perm])
        mod.bias_ih_l0.copy_(bias[perm])
        mod.bias_hh_l0.zero_()
    return mod, perm


def cudnn_bwd_yardstick(torch, cell: str, hin, wx, b, wh, dh,
                        hoisted: bool = False, tol: float = BF16_TOL) -> dict:
    """Rows 4 and 2's ``library_ms``: one ``torch.autograd.grad`` over a
    saved cuDNN forward (:func:`cudnn_module`, TF32 off, every step valid)
    with the row's upstream gradient ``dh`` — the same function only when
    no step is masked. Row 4 (``hin``, ``wx``, ``b``): dhin, dW_x, db and
    dW_h; row 2 (``hoisted``: ``hin`` is xw, W_x the identity and b 0, as
    :func:`hoisted_yardstick`): dxw and dW_h, and cuDNN also computes
    dW_ih, a [G H, G H] product the row does not do. Held first to the
    plain backward with m all ones at the row's scaled bound ``tol`` (bf16
    0.05, float32 1e-5); the record gives its error and says whether it
    differs or cuDNN refused. The port never makes this call."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, _ = hin.shape
    if hoisted:
        G = hin.shape[-1]
        wx = torch.eye(G, dtype=hin.dtype, device=hin.device)
        b = torch.zeros(G, dtype=hin.dtype, device=hin.device)
    mod, perm = cudnn_module(torch, cell, hin, wx, b, wh)
    x = hin.detach().clone().requires_grad_(True)
    params = (mod.weight_ih_l0, mod.bias_ih_l0, mod.weight_hh_l0)
    ones = torch.ones(B, T, dtype=torch.bool, device=hin.device)
    xw = hin if hoisted else hin.float() @ wx.float() + b.float()
    h, c = R.rnn_scan_states(cell, xw, wh, ones, 1.0, True)
    h, c = h.to(hin.dtype), None if c is None else c.to(hin.dtype)
    try:
        out = mod(x)[0]
    except RuntimeError as exc:
        return dict(library_ms=None, library_note=(
            f"cuDNN refused {hin.dtype}: {str(exc).splitlines()[0]}"))
    inputs = (x, *params)

    def grad():
        return torch.autograd.grad(out, inputs, dh, retain_graph=True)

    gx, gwi, gbi, gwh = grad()
    unperm = (lambda g: torch.empty_like(g).index_copy_(0, perm, g))
    dwx, db, dwh = unperm(gwi).t(), unperm(gbi), unperm(gwh).t()
    if hoisted:
        got = (gx, dwh)
        want = R.rnn_scan_bwd_reference(cell, hin, wh, ones, h, c, dh)
    else:
        got = (gx, dwx, db, dwh)
        want = R.rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, ones,
                                              h, c, dh)
    torch.cuda.synchronize()
    err = max(scaled_err(g, w) for g, w in zip(got, want))
    del gx, gwi, gbi, gwh, dwx, db, dwh, got, want, h, c
    note = ("cuDNN backward over a saved forward, every step valid" + (
        "; it also computes dW_ih, a [G H, G H] product row 2 does not do"
        if hoisted else "") + (
        "" if err <= tol else  # NaN too
        "; differs from the plain backward over the scaled tolerance"))
    rec = dict(library_ms=time_ms(grad, reps=3),
               library_scaled_err=err, library_note=note)
    del out, x
    return rec


def cudnn_yardstick(torch, cell: str, hin, wx, b, wh, atol: float,
                    rtol: float) -> dict:
    """Row 3's ``library_ms``: one cuDNN call (``torch.nn.LSTM`` or
    ``torch.nn.GRU``, TF32 off) on the same inputs with every step valid
    — the same function only when no step is masked. Its weights are the
    row's (:func:`cudnn_module`). Held first to the plain version with m
    all ones
    at the row's tolerance, then timed; the record gives its error and
    says whether it differs (over the row's tolerance) or cuDNN refused
    the dtype. The port never makes this call. Row 1's is the same call
    on ``xw`` with W_x the identity and b 0 (:func:`hoisted_yardstick`)."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, _ = hin.shape
    mod, _ = cudnn_module(torch, cell, hin, wx, b, wh)
    with torch.no_grad():
        ones = torch.ones(B, T, dtype=torch.bool, device=hin.device)
        want = R.rnn_scan_fused_reference(cell, hin, wx, b, wh, ones)
        try:
            out = mod(hin)[0]
        except RuntimeError as exc:
            return dict(library_ms=None, library_note=(
                f"cuDNN refused {hin.dtype}: {str(exc).splitlines()[0]}"))
        torch.cuda.synchronize()
        err, excess = worst_excess(out, want, atol, rtol)
        del out, want
        note = ("cuDNN, every step valid" if excess <= 0 else  # NaN too
                "cuDNN, every step valid; differs from the plain version "
                "over the row's tolerance")
        return dict(library_ms=time_ms(lambda: mod(hin)),
                    library_max_abs_err=err, library_note=note)


def hoisted_yardstick(torch, cell: str, xw, wh, atol: float,
                      rtol: float) -> dict:
    """Row 1's ``library_ms``: the cuDNN call of :func:`cudnn_yardstick`
    on the hoisted projection ``xw [B, T, G H]`` with W_x the identity and
    b 0 — the same recurrence when no step is masked (cuDNN takes no
    per-step mask), at the cost of one more [G H, G H] product."""
    G = xw.shape[-1]
    eye = torch.eye(G, dtype=xw.dtype, device=xw.device)
    zeros = torch.zeros(G, dtype=xw.dtype, device=xw.device)
    return cudnn_yardstick(torch, cell, xw, eye, zeros, wh, atol, rtol)


def check_fused_fwd(torch, kernels, where: str, cell: str, hin, wx, b, wh,
                    mm, save_c: bool) -> None:
    """Row 3 at a main path's shape in bf16: the tensor-core kernel (the
    route's choice at this H) against the plain version, timed beside the
    bound, and at 16, 32 and 64 rows per block; at the serving dispatches
    (no c_all) beside the cuDNN yardstick (:func:`cudnn_yardstick`)."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    name = f"rnn_fused_fwd_mma_{cell}"
    if R._mma_route(hin.dtype, H) != "mma":
        fail(f"rnn fused fwd {cell} at {where}: the route is not mma")
    want_h, want_c = R.rnn_scan_states(
        cell, hin.float() @ wx.float() + b.float(), wh, mm, 1.0, save_c)

    def run():
        return R._fused_states(cell, hin, wx, b, wh, mm, 1.0, save_c)

    bound, by = rnn_bound("fused_fwd", cell, B, T, H, hin.element_size(),
                          save_c)
    plain_ms = time_ms(lambda: R.rnn_scan_states(
        cell, hin.float() @ wx.float() + b.float(), wh, mm, 1.0, save_c),
        reps=3, warmup=1)
    h, c = run()
    torch.cuda.synchronize()
    err, excess = worst_excess(h, want_h, BF16_TOL, BF16_TOL)
    if c is not None:
        c_err, c_excess = worst_excess(c, want_c, BF16_TOL, BF16_TOL)
        err, excess = max(err, c_err), max(excess, c_excess)
    if excess > 0 or not torch.isfinite(h).all():
        fail(f"{name} at {where}: max err {err}")
    del h, c, want_h, want_c
    ms = kernel_ms(run)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    library = (dict(library_ms=None) if save_c else cudnn_yardstick(
        torch, cell, hin, wx, b, wh, BF16_TOL, BF16_TOL))
    report(kernels, name, where, dict(
        shape=[B, T, H], save_c=save_c, max_abs_err=err,
        tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}", **ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, **library,
        rows_per_block=R._mma_rows(B, sms),
        rows_ms={rows: time_ms(lambda: R._launch_fwd_mma(
            cell, hin, wx, b, wh, mm, 1.0, save_c, rows))
            for rows in R.MMA_ROWS}))
    log(f"rnn fused fwd {cell} at {where}: tensor cores {ms['ms']:.4f} ms "
        f"(device {ms['device_ms']:.4f}), bound {bound:.4f} ms")
    torch.cuda.empty_cache()


def check_train_shapes(torch, trainer, kernels, gen) -> None:
    """Rows 1, 2, 3 and 4 at the c2 train step's shape: the layer-0 input
    of a real index batch (the first batch of ``stacked_epoch(0)``), LSTM
    with the model's own weights and GRU with seeded ones, in bf16 (the
    kernels of the route) and in float32 (the CUDA-core lane, on the same
    inputs). Each kernel against its plain version, timed beside its bound
    (row 3 saving c_all, as the training forward does); each backward
    twice for bitwise equal weight gradients."""
    from lfm_quant_tpu_torch.ops import rnn as R

    b = trainer.train_sampler.stacked_epoch(0)
    fi = torch.from_numpy(b.firm_idx[0]).cuda()
    ti = torch.from_numpy(b.time_idx[0]).cuda()
    model = trainer.model
    cd = model.dtype
    H = model.hidden
    with torch.no_grad():
        x, m = trainer._gather(fi, ti)
        W = x.shape[-2]
        B = x.shape[0] * x.shape[1]
        hin = model.embed(x.reshape(B, W, -1), dtype=cd)
        mm = m.reshape(B, W)
    for cell in ("lstm", "gru"):
        G = GATES[cell] * H
        if cell == "lstm":
            wx = model.xproj[0].kernel.detach().to(cd)
            bb = model.xproj[0].bias.detach().to(cd)
            wh = model.h_proj[0].detach().to(cd)
        else:
            sd = H ** -0.5
            wx = (sd * torch.randn(H, G, generator=gen)).to(cd).cuda()
            bb = (0.1 * torch.randn(G, generator=gen)).to(cd).cuda()
            wh = (sd * torch.randn(H, G, generator=gen)).to(cd).cuda()
        dh = (0.1 * torch.randn(B, W, H, generator=gen)).to(cd).cuda()
        with torch.no_grad():
            # Row 3, the fused forward, saving c_all for the backward.
            check_fused_fwd(torch, kernels, "c2 train step", cell, hin, wx,
                            bb, wh, mm, save_c=True)
            xw = (hin.float() @ wx.float() + bb.float()).to(cd)
            # Row 1, the hoisted forward.
            check_hoisted_fwd(torch, kernels, cell, xw, wh, mm)
            # Row 4, the fused backward, on the plain forward's states.
            check_fused_bwd(torch, kernels, cell, hin, wx, bb, wh, mm, dh)
            # Row 2, the hoisted backward.
            check_hoisted_bwd(torch, kernels, cell, xw, wh, mm, dh)
            del xw
            # The CUDA-core lane in float32 on the same inputs.
            check_f32_lane(torch, kernels, cell, hin, wx, bb, wh, mm, dh,
                           gen)
    torch.cuda.empty_cache()


def check_hoisted_fwd(torch, kernels, cell: str, xw, wh, mm) -> None:
    """Row 1 at the c2 train step in bf16: the hoisted mode of the
    tensor-core forward through ``rnn_scan`` (counted, nothing else
    launched) against the plain version at atol/rtol 0.05, timed in turns
    with ``rnn_fused_fwd.cu``'s hoisted mode (its private launcher) on the
    same inputs (tensor cores, CUDA cores, CUDA cores, tensor cores: ``ms``
    and ``device_ms`` the first reading) beside the bound and the plain
    version; then its seed grid: S 3 (xw and m per seed, W_h shared) in one
    counted launch, bitwise equal to three one-seed launches with the same
    rows per block."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, G = xw.shape
    H = wh.shape[0]
    name = f"rnn_fwd_mma_{cell}"
    if R._mma_route(xw.dtype, H) != "mma":
        fail(f"rnn fwd {cell} at the train shape: the route is not mma")
    runs = {"mma": lambda: R.rnn_scan(cell, xw, wh, mm),
            "cuda_core": lambda: R._launch_fwd(
                cell, True, xw, None, None, wh, mm, 1.0, False)[0]}
    ref = R.rnn_scan_reference(cell, xw, wh, mm)
    errs = {}
    for kind, run in runs.items():
        _build.reset_launch_counts()
        out = run()
        counts = _build.launch_counts()
        launched = name if kind == "mma" else f"rnn_fwd_{cell}"
        if counts[launched] != 1 or sum(counts.values()) != 1:
            fail(f"rnn fwd {cell} ({kind}) at the train shape: launched "
                 f"{counts}")
        torch.cuda.synchronize()
        err, excess = worst_excess(out, ref, BF16_TOL, BF16_TOL)
        if excess > 0 or not torch.isfinite(out).all() or \
                out.shape != ref.shape:
            fail(f"rnn fwd {cell} ({kind}) at the train shape: max err {err}")
        errs[kind] = err
        del out
    turns = {kind: [] for kind in runs}
    for kind in ("mma", "cuda_core", "cuda_core", "mma"):
        turns[kind].append(kernel_ms(runs[kind], reps=5, launches=4))
    # The seed grid: one launch for three seeds against three launches.
    S = 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = R._mma_rows(B, sms, S, hoisted=True)
    xw3 = torch.stack([xw, -xw, (0.5 * xw.float()).to(xw.dtype)])
    m3 = torch.stack([mm, mm.flip(0), mm.roll(1, dims=1)])
    _build.reset_launch_counts()
    h3, c3 = R._launch_scan_fwd_mma(cell, xw3, wh[None], m3, 1.0, True)
    if _build.launch_counts()[name] != 1:
        fail(f"{name} seed grid: launched {_build.launch_counts()}")
    for s in range(S):
        h1, c1 = R._launch_scan_fwd_mma(cell, xw3[s], wh, m3[s], 1.0, True,
                                        rows)
        if not torch.equal(h3[s], h1) or (c3 is not None
                                          and not torch.equal(c3[s], c1)):
            fail(f"{name} seed grid differs from the one-seed launch at "
                 f"seed {s}")
    del xw3, m3, h3, c3, h1, c1
    bound, by = rnn_bound("fwd", cell, B, T, H, xw.element_size())
    rec = dict(shape=[B, T, H], max_abs_err=errs["mma"],
               tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}",
               **turns["mma"][0], plain_ms=time_ms(
                   lambda: R.rnn_scan_reference(cell, xw, wh, mm), reps=3,
                   warmup=1),
               bound_ms=bound, bound_by=by,
               **hoisted_yardstick(torch, cell, xw, wh, BF16_TOL, BF16_TOL),
               rows_per_block=R._mma_rows(B, sms, hoisted=True),
               seed_grid_bitwise=True,
               cuda_core_ms=turns["cuda_core"][0]["ms"],
               cuda_core_device_ms=turns["cuda_core"][0]["device_ms"],
               cuda_core_max_abs_err=errs["cuda_core"],
               turns_ms={k: [t["ms"] for t in v] for k, v in turns.items()})
    report(kernels, name, "c2 train step", rec)
    log(f"rnn fwd {cell} (hoisted) at the c2 train step: tensor cores "
        f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), CUDA cores "
        f"{rec['cuda_core_ms']:.4f} (device {rec['cuda_core_device_ms']:.4f})"
        f", in turns {rec['turns_ms']}; bound {bound:.4f} ms; seed grid "
        f"(S {S}) bitwise")
    torch.cuda.empty_cache()


def check_hoisted_bwd(torch, kernels, cell: str, xw, wh, mm, dh) -> None:
    """Row 2 at the c2 train step in bf16: the tensor-core hoisted backward
    (the route's choice at this H), twice for bitwise equal dW_h, against
    the plain version (dxw at atol and rtol 0.05 and at scaled atol 0.05,
    dW_h at ``MMA_WGRAD_TOL``) and timed beside its bound, the CUDA-core
    hoisted kernel (its private
    launcher) on the same inputs and the ``library_ms`` yardstick, dW_h
    as one f32 ``torch.matmul`` (h_{t-1}^T d_hw) that the port never
    makes."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, G = xw.shape
    H = wh.shape[0]
    name = f"rnn_bwd_mma_{cell}"
    if R._mma_route(xw.dtype, H) != "mma":
        fail(f"rnn bwd {cell} at the train shape: the route is not mma")
    hx, cx = R.rnn_scan_states(cell, xw, wh, mm)
    hx, cx = hx.to(xw.dtype), (None if cx is None else cx.to(xw.dtype))
    args = (cell, xw, wh, mm, hx, cx, dh)
    want = R.rnn_scan_bwd_reference(*args)
    plain_ms = time_ms(lambda: R.rnn_scan_bwd_reference(*args), reps=3,
                       warmup=1)
    _, d_hw, h_prev = R._scan_bwd_core(cell, xw.float(), wh, mm, hx, cx, dh,
                                       1.0)
    a_h, d_h = h_prev.reshape(-1, H), d_hw.reshape(-1, G)
    library_ms = time_ms(lambda: torch.matmul(a_h.T, d_h))
    del d_hw, h_prev, a_h, d_h
    runs = {"mma": lambda: R.rnn_scan_bwd(*args),
            "cuda_core": lambda: R._launch_bwd(
                cell, False, xw, None, None, wh, mm, hx, cx, dh, 1.0)}
    ms, errs = {}, {}
    for kind, run in runs.items():
        one = run()
        two = run()
        torch.cuda.synchronize()
        if not torch.equal(one[1], two[1]):
            fail(f"rnn bwd {cell} ({kind}): two launches differ")
        errs[kind] = grads_close(
            f"bwd {cell} ({kind}) at the train shape", one, want, xw.dtype,
            MMA_WGRAD_TOL if kind == "mma" else None)
        if kind == "mma":
            wgrad_err = scaled_err(one[1], want[1])
            err, excess = worst_excess(one[0], want[0], BF16_TOL, BF16_TOL)
            if excess > 0:
                fail(f"rnn bwd {cell} (mma): dxw max err {err}")
        del one, two
        ms[kind] = kernel_ms(run, reps=5, launches=4)
    bound, by = rnn_bound("bwd", cell, B, T, H, xw.element_size())
    report(kernels, name, "c2 train step", dict(
        shape=[B, T, H], max_abs_err=errs["mma"], wgrad_scaled_err=wgrad_err,
        bitwise_repeatable=True,
        tolerance=f"scaled atol {BF16_TOL}, dW_h {MMA_WGRAD_TOL}",
        **ms["mma"], cuda_core_ms=ms["cuda_core"]["ms"],
        cuda_core_device_ms=ms["cuda_core"]["device_ms"],
        cuda_core_max_abs_err=errs["cuda_core"], plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=library_ms))
    mma, simt = ms["mma"]["ms"], ms["cuda_core"]["ms"]
    log(f"rnn bwd {cell} (hoisted) at the c2 train step: tensor cores "
        f"{mma:.4f} ms, CUDA cores {simt:.4f} ms ({simt / mma:.2f}x), bound "
        f"{bound:.4f} ms, dW_h matmul (library) {library_ms:.4f} ms")
    del want, hx, cx
    torch.cuda.empty_cache()


def f32_bounds(kind: str, cell: str, B: int, T: int, H: int,
               save_c: bool = False) -> dict:
    """A float32 row's bound at both f32-accurate rates: ``bound_ms`` and
    ``bound_by`` at 3xTF32 on the tensor cores (the least time),
    ``bound_f32_simt_ms`` at 67 TFLOP/s on the CUDA cores."""
    t, by = rnn_bound(kind, cell, B, T, H, 4, save_c)
    simt, _ = rnn_bound(kind, cell, B, T, H, 4, save_c,
                        f32_flops=H100_F32_FLOPS)
    return dict(bound_ms=t, bound_by=by, bound_f32_simt_ms=simt)


def check_f32_lane(torch, kernels, cell: str, hin, wx, b, wh, mm, dh,
                   gen) -> None:
    """The float32 lane at the c2 train step, where the float32 training
    runs launch it: rows 3 and 1 (:func:`f32_fwd_rows`), the fused form's
    seed grid (:func:`f32_seed_grid`), and rows 4 and 2 on the 3xTF32
    kernels (:func:`f32_bwd_rows`); then the same four rows on the same
    rows of the batch at hidden :data:`PADDED_HIDDEN` (the first 120
    units: the 3xTF32 kernels zero-padded to 128, timed apart from their
    pads and beside the CUDA-core kernels on the same inputs), and rows 3
    and 1 at :data:`F32_CLUSTER_HIDDEN` (the float32 grid forward, timed
    in turns with ``rnn_fused_fwd.cu``; the backwards there are phase
    28's), seeded weights.
    Bounds at both f32 rates, of the unpadded work."""
    from lfm_quant_tpu_torch.ops import rnn as R

    f32 = torch.float32
    hin, wx, b, wh, dh = (t.to(f32) for t in (hin, wx, b, wh, dh))
    B, T, H = hin.shape
    if R._mma_route(f32, H) != "tf32" or R._mma_route(f32, H, "bwd") != \
            "tf32":
        fail("the float32 lane is not the 3xTF32 forward and backward")
    xw = hin @ wx + b
    with torch.no_grad():
        f32_fwd_rows(torch, kernels, "c2 train step", cell, hin, wx, b, wh,
                     mm, xw)
        f32_seed_grid(torch, cell, hin, wx, b, wh, mm, gen)
    f32_hoisted_seed_grid(torch, kernels, cell, xw, wh, mm, dh)
    if cell == "lstm":
        f32_stack_memory(torch, hin, wx, b, wh, mm, dh)
    with torch.no_grad():
        h, c = R.rnn_scan_states(cell, xw, wh, mm, 1.0, True)
    f32_bwd_rows(torch, kernels, "c2 train step", cell, hin, wx, b, wh, mm,
                 h, c, dh, xw)
    del h, c, xw
    for H2 in (PADDED_HIDDEN, F32_CLUSTER_HIDDEN):
        G2 = GATES[cell] * H2
        sd = H2 ** -0.5
        wx2, wh2 = ((sd * torch.randn(H2, G2, generator=gen)).cuda()
                    for _ in range(2))
        b2 = (0.1 * torch.randn(G2, generator=gen)).cuda()
        if H2 <= H:  # the first H2 units of the same rows
            hin2 = hin[..., :H2].contiguous()
            dh2 = dh[..., :H2].contiguous()
        else:
            hin2 = torch.randn(B, T, H2, generator=gen).cuda()
            dh2 = (0.1 * torch.randn(B, T, H2, generator=gen)).cuda()
        xw2 = hin2 @ wx2 + b2
        where = f"B {B}, T {T}, H {H2}"
        with torch.no_grad():
            f32_fwd_rows(torch, kernels, where, cell, hin2, wx2, b2, wh2, mm,
                         xw2)
        if H2 <= 128:
            with torch.no_grad():
                h2, c2 = R.rnn_scan_states(cell, xw2, wh2, mm, 1.0, True)
            f32_bwd_rows(torch, kernels, where, cell, hin2, wx2, b2, wh2, mm,
                         h2, c2, dh2, xw2)
            del h2, c2
        del hin2, dh2, xw2
    torch.cuda.empty_cache()


def padded_times(torch, form: str, cell: str, ops, rest, route_call) -> dict:
    """A padded row's times apart (hidden width off a multiple of 16, the
    3xTF32 kernels at the padded width): ``device_ms`` the kernel alone on
    operands padded beforehand, ``pad_ms`` the pads and the slices back
    alone, ``route_device_ms`` the route's whole call (all device time)."""
    from lfm_quant_tpu_torch.ops import rnn as R

    H = ops[R._PAD_FORMS[form][0].rindex("w")].shape[-2]
    launch = R._tensor_core_launcher("tf32", form)
    padded = R._pad_operands(form, cell, ops)
    out = launch(cell, *padded, *rest)

    def pads():
        R._pad_operands(form, cell, ops)
        R._unpad_outputs(form, cell, H, out)

    return dict(
        padded_width=R._padded_width(H),
        device_ms=device_ms(lambda: launch(cell, *padded, *rest), reps=5,
                            launches=2),
        pad_ms=device_ms(pads, reps=5, launches=2),
        route_device_ms=device_ms(route_call, reps=5, launches=2))


def f32_fwd_rows(torch, kernels, where: str, cell: str, hin, wx, b, wh, mm,
                 xw, before: bool = True, name_suffix: str = "") -> None:
    """Rows 3 and 1 in float32, saving c_all as training does, through the
    route at this H (counted, nothing else launched): at H <= 128 the
    3xTF32 forward, above 128 the float32 grid forward
    (``rnn_fwd_tf32_grid.cu``, with its group, rows, groups and barrier
    waits); with ``before``, timed in turns with ``rnn_fused_fwd.cu`` (its
    private launcher) on the same inputs (route, CUDA cores, CUDA cores,
    route: ``ms`` and ``device_ms`` are the first reading, ``turns_ms`` all
    four), the CUDA-core kernel held to the plain version too and, above
    128, recorded under its own name (the table's "[before]"), and at a
    padded width with its pads apart (:func:`padded_times`). Beside both
    bounds, the plain version and, for row 3, the cuDNN yardstick. h_all
    and c_all within atol 1e-5 of the plain version (the JAX f32 bound on
    the op's output). ``name_suffix`` names the records (``@h1024``)."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    route = R._mma_route(torch.float32, H)
    padded = R._padded_width(H) != H
    want = R.rnn_scan_states(cell, xw, wh, mm, 1.0, True)
    library = cudnn_yardstick(torch, cell, hin, wx, b, wh, F32_TOL, 0.0)
    tag = {"tf32": "tf32_", "grid": "grid_"}[route]
    for kind, fused in (("fused_fwd", True), ("fwd", False)):
        form = "fused_" if fused else ""
        name = f"rnn_{form}fwd_{tag}{cell}"
        core_name = f"rnn_{form}fwd_{cell}"
        ops = (hin, wx, b, wh, mm) if fused else (xw, wh, mm)
        if fused:
            runs = {"route": lambda: R._fused_states(
                cell, hin, wx, b, wh, mm, 1.0, True)}
            plain_ms = time_ms(lambda: R.rnn_scan_states(
                cell, hin @ wx + b, wh, mm, 1.0, True), reps=3, warmup=1)
        else:
            runs = {"route": lambda: R._scan_states_any(
                cell, xw, wh, mm, 1.0, True)}
            plain_ms = time_ms(lambda: R.rnn_scan_states(
                cell, xw, wh, mm, 1.0, True), reps=3, warmup=1)
        if before:
            runs["cuda_core"] = (lambda f=fused: R._launch_fwd(
                cell, not f, ops[0], *((wx, b) if f else (None, None)),
                wh, mm, 1.0, True))
        errs = {}
        for mode, run in runs.items():
            _build.reset_launch_counts()
            out = run()
            counts = _build.launch_counts()
            launched = name if mode == "route" else core_name
            if counts[launched] != 1 or sum(counts.values()) != 1:
                fail(f"{launched} ({mode}) at {where}: launched {counts}")
            torch.cuda.synchronize()
            err, excess = {}, 0.0
            for state, got, ref in zip("hc", out, want):
                if got is None:  # the GRU has no c_all
                    continue
                if got.shape != ref.shape or not torch.isfinite(got).all():
                    fail(f"{launched} (float32) at {where}: {state} not "
                         f"finite of shape {tuple(ref.shape)}")
                err[state], x = worst_excess(got, ref, F32_TOL, 0.0)
                excess = max(excess, x)
            if excess > 0:
                fail(f"{launched} (float32) at {where}: max err {err} (atol "
                     f"{F32_TOL})")
            errs[mode] = err
            del out
        turns = {mode: [] for mode in runs}
        order = (("route", "cuda_core", "cuda_core", "route")
                 if "cuda_core" in runs else ("route",))
        for mode in order:
            turns[mode].append(kernel_ms(runs[mode], reps=5 if before
                                         else 2, launches=2))
        bounds = f32_bounds(kind, cell, B, T, H, True)
        rec = dict(shape=[B, T, H], dtype="float32", save_c=True,
                   plain_ms=plain_ms, **bounds,
                   **(library if fused else hoisted_yardstick(
                       torch, cell, xw, wh, F32_TOL, 0.0)),
                   tolerance=f"atol {F32_TOL}",
                   max_abs_err=max(errs["route"].values()),
                   max_abs_err_by_state=errs["route"], **turns["route"][0],
                   host_ms=host_ms(runs["route"], reps=5 if before else 2))
        if route == "grid":
            stats = {}
            R._launch_fwd_grid(cell, fused, *((hin, wx, b) if fused else
                                              (xw, None, None)), wh, mm,
                               1.0, True, stats=stats)
            torch.cuda.synchronize()
            cyc = stats["cycles"].double().cpu()
            rec.update(group=stats["group"], rows=stats["rows"],
                       groups=stats["groups"],
                       ctas_at_once=stats["ctas_at_once"],
                       kernels_a_call=stats["kernels"],
                       barrier_wait_share_mean=float(
                           (cyc[:, 0] / cyc[:, 1]).mean()))
        if "cuda_core" in runs:
            rec.update(cuda_core_ms=turns["cuda_core"][0]["ms"],
                       cuda_core_device_ms=turns["cuda_core"][0]["device_ms"],
                       cuda_core_max_abs_err=max(errs["cuda_core"].values()),
                       turns_ms={m: [t["ms"] for t in v]
                                 for m, v in turns.items()})
            if route == "grid":
                report(kernels, core_name + name_suffix, where, dict(
                    shape=[B, T, H], dtype="float32", save_c=True,
                    max_abs_err=max(errs["cuda_core"].values()),
                    rows_per_block=R._simt_rows(cell, kind, H, hin.device),
                    **turns["cuda_core"][0], plain_ms=plain_ms, **bounds,
                    **{k: v for k, v in rec.items()
                       if k.startswith("library")}))
        if padded:
            rec.update(padded_times(torch, kind, cell, ops, (1.0, True),
                                    runs["route"]))
        report(kernels, name + name_suffix, where, rec)
        log(f"{name} (float32) at {where}: {rec['ms']:.4f} ms (device "
            f"{rec['device_ms']:.4f}, host {rec['host_ms']:.4f}"
            + (f", pads {rec['pad_ms']:.4f}" if padded else "") + ")"
            + (f", {rec['groups']} groups of {rec['group']} CTAs x "
               f"{rec['rows']} rows ({rec['kernels_a_call']} kernels), "
               f"barrier waits "
               f"{100 * rec['barrier_wait_share_mean']:.1f}%"
               if route == "grid" else "")
            + (f", rnn_fused_fwd.cu {rec['cuda_core_ms']:.4f} (device "
               f"{rec['cuda_core_device_ms']:.4f}), in turns "
               f"{rec['turns_ms']}" if "cuda_core_ms" in rec else "")
            + f"; bound {rec['bound_ms']:.4f} (3xTF32) / "
            f"{rec['bound_f32_simt_ms']:.4f} (CUDA cores); library "
            f"{rec['library_ms']}; errors {errs}")
    torch.cuda.empty_cache()


def f32_seed_grid(torch, cell: str, hin, wx, b, wh, mm, gen) -> None:
    """The float32 fused forward's seed grid at the c2 train step: S = 3
    seeds (hin, W_x, W_h and m per seed, b of seed extent 1) in one
    counted call, bitwise equal to three one-seed calls, each within atol
    1e-5 of the plain version."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    S = 3
    hin3 = torch.stack([hin, -hin, 0.5 * hin])
    wx3, wh3 = (torch.stack([w, 0.9 * w, w + 0.02 * torch.randn(
        w.shape, generator=gen).cuda()]) for w in (wx, wh))
    m3 = torch.stack([mm, mm.flip(0), mm.roll(1, dims=1)])
    b1 = b[None]
    _build.reset_launch_counts()
    h, c = R._fused_states(cell, hin3, wx3, b1, wh3, m3, 1.0, True)
    if _build.launch_counts()[f"rnn_fused_fwd_tf32_{cell}"] != 1:
        fail(f"the float32 seed grid launched {_build.launch_counts()}")
    worst = 0.0
    for s in range(S):
        h1, c1 = R._fused_states(cell, hin3[s], wx3[s], b, wh3[s], m3[s],
                                 1.0, True)
        if not torch.equal(h[s], h1) or (c is not None
                                         and not torch.equal(c[s], c1)):
            fail(f"float32 seed grid differs from the one-seed call at "
                 f"seed {s}")
        want = R.rnn_scan_states(cell, hin3[s] @ wx3[s] + b, wh3[s], m3[s],
                                 1.0, False)[0]
        err, excess = worst_excess(h1, want, F32_TOL, 0.0)
        if excess > 0:
            fail(f"float32 seed grid seed {s}: max err {err}")
        worst = max(worst, err)
    log(f"rnn_fused_fwd_tf32_{cell} seed grid (S {S}, b shared) at the c2 "
        f"train step: one launch, bitwise equal to {S} one-seed calls, max "
        f"err {worst:.3g} (atol {F32_TOL})")
    del h, c, hin3, wx3, wh3, m3
    torch.cuda.empty_cache()


def f32_stack_memory(torch, hin, wx, b, wh, mm, dh) -> None:
    """One float32 fused LSTM layer stacked over 64 seeds, c5's ensemble
    shape in float32 (S 64 x B 2048, T 60, H 128: the c2 step's rows and
    weights for every seed, m shared): forward and backward through
    autograd, as training runs them, where the 3xTF32 forward's xw scratch
    (16 GB) becomes the backward's d_gates buffer, against the forward
    without a graph and then the backward, which makes its own xw (one
    more GEMM). Peak device memory of each above the operands', and the
    gradients of the two within the scaled f32 bound."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    S = 64
    hin_s, dh_s = (t.expand(S, *t.shape).contiguous() for t in (hin, dh))
    wx_s, b_s, wh_s = (t.expand(S, *t.shape).contiguous()
                       for t in (wx, b, wh))
    m1 = mm[None]

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base, \
            _build.launch_counts()

    ops = [t.requires_grad_() for t in (hin_s, wx_s, b_s, wh_s)]

    def carried():
        with torch.enable_grad():
            h = R.rnn_scan_fused("lstm", *ops, m1)
            torch.autograd.backward(h, dh_s)
        return tuple(t.grad for t in ops)

    def apart():
        with torch.no_grad():
            h, c = R._fused_states("lstm", *ops, m1, 1.0, True)
            return R.rnn_scan_fused_bwd("lstm", *ops, m1, h, c, dh_s, 1.0)

    got, peak_carried, counts = peak(carried)
    if counts["rnn_fused_fwd_tf32_lstm"] != 1 or \
            counts["rnn_fused_bwd_tf32_lstm"] != 1:
        fail(f"float32 stack: launched {counts}")
    want, peak_apart, _ = peak(apart)
    worst = grads_close("float32 stack, xw carried to the backward", got,
                        want, torch.float32)
    log(f"float32 LSTM stack S {S} x B {hin.shape[0]}, T {hin.shape[1]}, "
        f"H {hin.shape[2]}: peak {peak_carried / 2**30:.3f} GiB with the "
        f"forward's xw carried to the backward, {peak_apart / 2**30:.3f} "
        f"GiB with the backward's own xw; gradients agree to scaled "
        f"{worst:.3g}")
    del got, want, ops, hin_s, dh_s, wx_s, b_s, wh_s
    torch.cuda.empty_cache()


def f32_bwd_rows(torch, kernels, where: str, cell: str, hin, wx, b, wh, mm,
                 h, c, dh, xw, name_suffix: str = "",
                 plain_reps: int = 3) -> None:
    """Rows 4 and 2 in float32 through the public backwards, on the route's
    kernels at this H (``rnn_bwd_tf32.cu`` up to ``TF32_MAX_WIDTH``: at H
    <= 128 its 1- or 2-CTA form, zero-padded to the next multiple of 16
    where H is off one, above 128 W_h split over a cluster of 2-4 CTAs;
    ``rnn_bwd_tf32_grid.cu`` past it, to 1024): each launched once per
    call (counted), twice for bitwise equal outputs, against its plain
    version at scaled atol 1e-5, timed beside both bounds, the plain
    version and the ``library_ms`` yardstick — at H <= 128 the
    weight-gradient products (and, fused, dhin) as f32 ``torch.matmul``
    with TF32 off; above 128 cuDNN's f32 backward over a saved forward
    (every step valid, :func:`cudnn_bwd_yardstick`), the products kept as
    ``products_ms``. The port makes neither. ``rnn_bwd.cu`` (its private
    launcher) is held to the plain version and timed on the same inputs,
    on the grid route in turns with it (grid, CUDA cores, CUDA cores,
    grid: ``turns_ms``), and above 128 also recorded under its own name
    (the table's "[before]"); a cluster's size, rows and clusters at once
    (the grid's group, rows, groups and CTAs at once) are kept, and a
    padded row's pads timed apart (:func:`padded_times`). Records carry
    ``name_suffix``."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    dev = hin.device
    route = R._mma_route(torch.float32, H, "bwd")
    tag = {"tf32": "tf32_", "grid": "grid_"}.get(route, "")
    wide = H > 128
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, fused in (("fused_bwd", True), ("bwd", False)):
        name = f"rnn_{'fused_' if fused else ''}bwd_{tag}{cell}"
        core_name = f"rnn_{'fused_' if fused else ''}bwd_{cell}"
        if fused:
            args = (cell, hin, wx, b, wh, mm, h, c, dh)
            public, plain = R.rnn_scan_fused_bwd, R.rnn_scan_fused_bwd_reference
            simt_args = args[1:]
        else:
            args = (cell, xw, wh, mm, h, c, dh)
            public, plain = R.rnn_scan_bwd, R.rnn_scan_bwd_reference
            simt_args = (xw, None, None, wh, mm, h, c, dh)
        want = plain(*args)
        _build.reset_launch_counts()
        one = public(*args)
        counts = _build.launch_counts()
        if counts[name] != 1 or sum(counts.values()) != 1:
            fail(f"{name} (float32) at {where}: the route launched "
                 f"{_build.launch_counts()}")
        two = public(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(one, two)):
            fail(f"{name} (float32): two launches differ")
        err = grads_close(f"{name} (float32) at {where}", one, want,
                          torch.float32)
        wgrad_err = max(scaled_err(g, w) for g, w in zip(one[1:], want[1:]))
        del one, two

        def core(a=simt_args, f=fused):
            return R._launch_bwd(cell, f, *a, 1.0)

        core_err = None
        # Past 400 the grid is not timed beside rnn_bwd.cu (a CUDA-core
        # call takes up to seconds there; cut for the script's time).
        in_turns = route == "tf32" or (route == "grid"
                                       and H <= PAST_CAP_HIDDEN)
        if in_turns:
            _build.reset_launch_counts()
            got = core()
            if _build.launch_counts()[core_name] != 1:
                fail(f"{core_name} (float32) at {where}: launched "
                     f"{_build.launch_counts()}")
            core_err = grads_close(f"{core_name} (float32) at {where}", got,
                                   want, torch.float32)
            del got
        del want
        d_xw, d_hw, h_prev = R._scan_bwd_core(cell, xw, wh, mm, h, c, dh,
                                              1.0)
        a_h, d_h = h_prev.reshape(-1, H), d_hw.reshape(B * T, -1)
        if fused:
            a_x, d_x = hin.reshape(-1, H), d_xw.reshape(B * T, -1)
            products_ms = time_ms(lambda: (torch.matmul(a_x.T, d_x),
                                           torch.matmul(a_h.T, d_h),
                                           torch.matmul(d_x, wx.T)))
            del a_x, d_x
        else:
            products_ms = time_ms(lambda: torch.matmul(a_h.T, d_h))
        del d_xw, d_hw, h_prev, a_h, d_h
        if wide:
            library = cudnn_bwd_yardstick(torch, cell, hin if fused else xw,
                                          wx, b, wh, dh, hoisted=not fused,
                                          tol=F32_TOL)
            library["products_ms"] = products_ms
            torch.cuda.empty_cache()
        else:
            library = dict(library_ms=products_ms)

        def run(a=args, f=public):
            return f(*a)

        common = dict(shape=[B, T, H], dtype="float32",
                      tolerance=f"scaled atol {F32_TOL}",
                      plain_ms=time_ms(lambda a=args: plain(*a),
                                       reps=plain_reps, warmup=1),
                      **f32_bounds(kind, cell, B, T, H), **library)
        # Fewer readings past 400, where a call takes up to 0.2 s.
        rec = dict(max_abs_err=err, wgrad_scaled_err=wgrad_err,
                   bitwise_repeatable=True,
                   **kernel_ms(run, reps=5 if H <= 400 else 2,
                               launches=2 if H <= 400 else 1),
                   **common)
        if route == "grid":
            rec.update(grid_shape(torch, cell, B, H, dev))
        if route == "grid" and in_turns:
            # In turns with rnn_bwd.cu on the same inputs.
            cc = kernel_ms(core, reps=2, launches=1)
            again = time_ms(core, reps=1, warmup=0)
            rec.update(cuda_core_ms=cc["ms"],
                       cuda_core_device_ms=cc["device_ms"],
                       cuda_core_max_abs_err=core_err,
                       turns_ms=dict(grid=[rec["ms"], time_ms(run, reps=3)],
                                     cuda_core=[cc["ms"], again]))
            report(kernels, core_name + name_suffix, where, dict(
                max_abs_err=core_err,
                rows_per_block=R._simt_rows(cell, kind, H, dev), **cc,
                **common))
        if route == "tf32":
            cc = kernel_ms(core, reps=2 if wide else 5, launches=2)
            rec.update(cuda_core_ms=cc["ms"],
                       cuda_core_device_ms=cc["device_ms"],
                       cuda_core_max_abs_err=core_err)
            if wide:
                props = torch.cuda.get_device_properties(dev)
                limit = props.shared_memory_per_block_optin
                C = R._tf32_cluster(cell, H, limit)
                rows = R._tf32_rows(cell, H, C, B, 1, limit,
                                    props.multi_processor_count)
                rec.update(cluster=C, rows_per_cluster=rows,
                           clusters_at_once=R._tf32_bwd_check(cell, H, C,
                                                              rows, dev))
                report(kernels, core_name + name_suffix, where, dict(
                    max_abs_err=core_err,
                    rows_per_block=R._simt_rows(cell, kind, H, dev), **cc,
                    **common))
        if R._padded_width(H) != H:
            rec.update(padded_times(torch, kind, cell, args[1:], (1.0,),
                                    run))
        report(kernels, name + name_suffix, where, rec)
        log(f"{name} (float32) at {where}: "
            + (f"{rec['cluster']} CTAs x {rec['rows_per_cluster']} rows a "
               f"cluster, {rec['clusters_at_once']} at once, "
               if "cluster" in rec else "")
            + (f"{rec['groups']} groups of {rec['group']} CTAs x "
               f"{rec['rows']} rows, {rec['ctas_at_once']} CTAs at once, "
               if "group" in rec else "")
            + (f"in turns {rec['turns_ms']}, " if "turns_ms" in rec else "")
            + f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}"
            + (f", pads {rec['pad_ms']:.4f}" if "pad_ms" in rec else "")
            + "), rnn_bwd.cu "
            f"{rec.get('cuda_core_ms', rec['ms']):.4f}, bound "
            f"{rec['bound_ms']:.4f} (3xTF32) / "
            f"{rec['bound_f32_simt_ms']:.4f} (CUDA cores), plain "
            f"{rec['plain_ms']:.4f}, library {rec['library_ms']} "
            f"({rec.get('library_note', 'products')})")
        torch.cuda.empty_cache()


def grid_shape(torch, cell: str, B: int, H: int, dev) -> dict:
    """The grid backward's launch at this shape (one seed): CTAs a group,
    rows a work item, groups, CTAs the card holds at once."""
    from lfm_quant_tpu_torch.ops import rnn as R

    props = torch.cuda.get_device_properties(dev)
    limit, sms = (props.shared_memory_per_block_optin,
                  props.multi_processor_count)
    n = R._grid_size(cell, H, limit, sms)
    rows = R._grid_rows(cell, H, n, B, 1, limit, sms)
    ctas = R._grid_check(cell, H, n, rows, dev)
    return dict(group=n, rows=rows, groups=min(ctas // n, -(-B // rows)),
                ctas_at_once=ctas)


def check_fused_bwd(torch, kernels, cell: str, hin, wx, b, wh, mm,
                    dh, where: str = "c2 train step") -> None:
    """Row 4 at a train step (``where``) in bf16: the tensor-core kernels (the
    route's choice at this H), twice for bitwise equal weight gradients,
    against the plain version (the weight gradients at ``MMA_WGRAD_TOL``)
    and timed beside the bound; the ``library_ms`` yardstick of the
    weight-gradient products, two f32 ``torch.matmul`` calls (hin^T d_xw
    + h_{t-1}^T d_hw) that the port never makes; and the time of the two
    packings of W_x that the wrapper makes when the forward's is not
    passed in."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    if R._mma_route(hin.dtype, H) != "mma":
        fail(f"rnn fused bwd {cell} at the {where}: the route is not mma")
    xw = hin.float() @ wx.float() + b.float()
    h, c = R.rnn_scan_states(cell, xw, wh, mm)
    h, c = h.to(hin.dtype), (None if c is None else c.to(hin.dtype))
    args = (cell, hin, wx, b, wh, mm, h, c, dh)
    want = R.rnn_scan_fused_bwd_reference(*args)
    plain_ms = time_ms(lambda: R.rnn_scan_fused_bwd_reference(*args),
                       reps=3, warmup=1)
    # The yardstick: f32 products of the operands the kernels reduce.
    d_xw, d_hw, h_prev = R._scan_bwd_core(cell, xw, wh, mm, h, c, dh, 1.0)
    a_x = hin.float().reshape(-1, H)
    a_h = h_prev.reshape(-1, H)
    d_x = d_xw.reshape(B * T, -1)
    d_h = d_hw.reshape(B * T, -1)
    library_ms = time_ms(lambda: (torch.matmul(a_x.T, d_x),
                                  torch.matmul(a_h.T, d_h)))
    del xw, d_xw, d_hw, h_prev, a_x, a_h, d_x, d_h
    bound, by = rnn_bound("fused_bwd", cell, B, T, H, hin.element_size())
    name = f"rnn_fused_bwd_mma_{cell}"

    def run():
        return R.rnn_scan_fused_bwd(*args)

    one = run()
    two = run()
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(one[1:], two[1:])):
        fail(f"{name}: two launches differ")
    err = grads_close(f"{name} at the {where}", one, want, hin.dtype,
                      MMA_WGRAD_TOL)
    wgrad_err = max(scaled_err(g, w) for g, w in zip(one[1:], want[1:]))
    del one, two, want
    ms = kernel_ms(run, reps=5, launches=4)
    report(kernels, name, where, dict(
        shape=[B, T, H], max_abs_err=err, wgrad_scaled_err=wgrad_err,
        bitwise_repeatable=True,
        tolerance=f"scaled atol {BF16_TOL}, weight gradients "
                  f"{MMA_WGRAD_TOL}",
        **ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=library_ms,
        pack_wx_ms=time_ms(lambda: R.pack_fragments(wx)),
        pack_wxt_ms=time_ms(lambda: R.pack_fragments(wx, transpose=True))))
    log(f"rnn fused bwd {cell} at the {where}: tensor cores "
        f"{ms['ms']:.4f} ms (device {ms['device_ms']:.4f}), bound "
        f"{bound:.4f} ms, weight-gradient matmuls (library) {library_ms:.4f} "
        f"ms")
    torch.cuda.empty_cache()


def profile_device(torch, fn, label: str, stats: dict = None) -> dict:
    """Device time by kernel name over ``fn`` under ``torch.profiler``,
    and the device's busy share of the wall time (summed kernel times over
    the wall clock); returns the device ms by kernel name (empty when the
    trace holds no device time) and puts the wall ms in ``stats``.
    Informational: it runs after the launch counts were read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if stats is not None:
        stats["wall_ms"] = wall_ms
    by_name = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    if not busy:
        log(f"profile {label}: no device time in the trace (not measured)")
        return by_name
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} "
        f"ms ({100 * busy / wall_ms:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    return by_name


def counted(label: str, must_move, fn, must_not=()):
    """Run one main path with every launch counter set to 0 just before
    and read just after; fail if a kernel of the path did not launch, or
    if one of ``must_not`` did."""
    from lfm_quant_tpu_torch.ops import _build

    _build.reset_launch_counts()
    out = fn()
    counts = _build.launch_counts()
    log(f"launches during {label}: "
        f"{ {k: n for k, n in counts.items() if n} }")
    for k in must_move:
        if counts[k] == 0:
            fail(f"kernel {k} was not launched by the {label} path")
    for k in must_not:
        if counts[k]:
            fail(f"kernel {k} was launched by the {label} path")
    return out, counts


def train_variant(cfg, **model_changes):
    """``cfg`` with its model config changed (kind, scan_impl, bf16)."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model_changes))


def plain_variant(cfg):
    """The plain path of ``cfg``: plain recurrence (autograd) and gather."""
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, gather_impl="xla"),
        model=dataclasses.replace(cfg.model, scan_impl="xla"))


def losses_agree(label: str, got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not (np.isfinite(got).all()
                                       and np.isfinite(want).all()):
        fail(f"{label}: losses {got} / {want} not finite of one shape")
    err = np.abs(got - want)
    if (err > BF16_TOL + BF16_TOL * np.abs(want)).any():
        fail(f"{label}: per-step losses differ from the plain path by up "
             f"to {err.max()}")
    return float(err.max())


def short_run(torch, cfg, splits, n_steps: int):
    """``n_steps`` train steps of a fresh Trainer on the card from the
    seeded init and the epoch-0 sampler order → per-step losses."""
    from lfm_quant_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, splits, device="cuda")
    state = trainer.init_state()
    b = trainer.train_sampler.stacked_epoch(0)
    fi, ti, w = trainer._batch(b)
    losses = []
    for k in range(n_steps):
        state, ms = trainer.step(state, fi[k], ti[k], w[k])
        losses.append(ms["loss"])
    return [float(v) for v in torch.stack(losses).cpu()]


def profile_step(torch, trainer, state, fi, ti, w) -> None:
    """The forward (gather, model, loss), backward and optimizer times of
    one train step, with CUDA events."""
    from lfm_quant_tpu_torch.ops.losses import finalize_loss

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    keys = list(state.params)
    trainer.model.train()
    torch.cuda.synchronize()
    ev[0].record()
    loss = finalize_loss(*trainer._loss_parts(fi, ti, w))
    ev[1].record()
    grads = torch.autograd.grad(loss, [state.params[k] for k in keys])
    ev[2].record()
    trainer.opt.step(state.params, dict(zip(keys, grads)), state.opt_state)
    ev[3].record()
    ev[3].synchronize()
    log(f"one c2 step: forward {ev[0].elapsed_time(ev[1]):.3f} ms, "
        f"backward {ev[1].elapsed_time(ev[2]):.3f} ms, optimizer "
        f"{ev[2].elapsed_time(ev[3]):.3f} ms")


def train_phase(torch, cfg, splits, totals: dict) -> None:
    """Phase 5: c2 for one epoch on the kernels against the plain path,
    then the short hoisted, GRU and float32 runs, and the hoisted step's
    time by backward; each run's launches are added to ``totals``."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.loop import Trainer

    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, epochs=1))
    trainer = Trainer(cfg, splits, device="cuda")
    K = trainer._steps_per_epoch
    t0 = time.perf_counter()
    summary, counts = counted(
        "c2 training (fused)", ("rnn_fused_fwd_mma_lstm",
                                "rnn_fused_bwd_mma_lstm", "window_gather"),
        trainer.fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, n in counts.items():
        totals[k] += n
    rec = summary["history"][0]
    log(f"train c2 (kernels): {K} steps + val sweep in {wall:.3f} s; "
        f"train_loss {rec['train_loss']:.6f} grad_norm "
        f"{rec['grad_norm']:.6f} val_ic {rec['val_ic']:.6f} val_mse "
        f"{rec['val_mse']:.6f}; {summary['firm_months_per_sec']:.1f} "
        f"firm-months/s over the epoch")
    plain = Trainer(plain_variant(cfg), splits, device="cuda")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    plain_summary = plain.fit()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if any(_build.launch_counts().values()):
        fail(f"the plain path launched kernels: {_build.launch_counts()}")
    err = losses_agree("c2 fused vs plain", summary["step_losses"],
                       plain_summary["step_losses"])
    prec = plain_summary["history"][0]
    log(f"train c2 (plain path on the card): {plain_wall:.3f} s; "
        f"train_loss {prec['train_loss']:.6f} val_ic {prec['val_ic']:.6f}; "
        f"per-step losses agree within {err:.4g} (tol {BF16_TOL} + "
        f"{BF16_TOL}|plain|) over {len(summary['step_losses'])} steps")

    # Steady-state step time, one profiled step and the device's view.
    state = trainer.state
    b = trainer.train_sampler.stacked_epoch(1)
    fi, ti, w = trainer._batch(b)
    n = min(8, K)

    def steps():
        s = state
        for k in range(n):
            s, _ = trainer.step(s, fi[k], ti[k], w[k])

    steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / n
    fm = float(b.weight[:n].sum()) * cfg.data.window / n
    log(f"train c2 steady state: {1e3 * per_step:.3f} ms/step, "
        f"{1 / per_step:.2f} steps/s, {fm / per_step:.1f} firm-months/s "
        f"({n} steps, host clock around synchronized work)")
    profile_step(torch, trainer, state, fi[0], ti[0], w[0])
    profile_device(torch, steps, f"c2 train, {n} steps")
    del trainer, plain
    torch.cuda.empty_cache()

    # The hoisted form (forward and backward on the tensor cores in bf16),
    # the GRU at c2's geometry, both cells and both forms in float32 (the
    # 3xTF32 forwards and backwards), the same at hidden 120 (the 3xTF32
    # kernels zero-padded to 128): no CUDA-core kernel in any; the float32
    # four at hidden 160 and at hidden 400 (the float32 grid forwards, the
    # backwards of the route: the grid's fused form on the forward's xw,
    # five kernels), the bf16 four at hidden 528 (past the cluster kernels:
    # the bf16 grid forwards and backwards, the fused backward on the
    # forward's xw, five kernels): no CUDA-core kernel in any; a few steps
    # each.
    h120 = dict(cfg.model.kwargs, hidden=PADDED_HIDDEN)
    h528 = dict(cfg.model.kwargs, hidden=CORE_BF16_HIDDEN)
    # Past 512 in bf16 no kernel runs but the bf16 grids.
    not_core = TF32 + GRID + CUDA_CORE + tuple(
        k for k in _build.LAUNCHES if "_mma_" in k or "_cluster_" in k)
    runs = (("c2 training (hoisted)", train_variant(cfg, scan_impl="pallas"),
             ("rnn_fwd_mma_lstm", "rnn_bwd_mma_lstm", "window_gather"),
             CUDA_CORE),
            ("c2 training (fused, float32)", train_variant(cfg, bf16=False),
             ("rnn_fused_fwd_tf32_lstm", "rnn_fused_bwd_tf32_lstm",
              "window_gather"), CUDA_CORE),
            ("c2 training (hoisted, float32)",
             train_variant(cfg, scan_impl="pallas", bf16=False),
             ("rnn_fwd_tf32_lstm", "rnn_bwd_tf32_lstm", "window_gather"),
             CUDA_CORE),
            ("GRU training (fused)", train_variant(cfg, kind="gru"),
             ("rnn_fused_fwd_mma_gru", "rnn_fused_bwd_mma_gru",
              "window_gather"), ()),
            ("GRU training (fused, float32)",
             train_variant(cfg, kind="gru", bf16=False),
             ("rnn_fused_fwd_tf32_gru", "rnn_fused_bwd_tf32_gru",
              "window_gather"), CUDA_CORE),
            ("GRU training (hoisted)",
             train_variant(cfg, kind="gru", scan_impl="pallas"),
             ("rnn_fwd_mma_gru", "rnn_bwd_mma_gru", "window_gather"),
             CUDA_CORE),
            ("GRU training (hoisted, float32)",
             train_variant(cfg, kind="gru", scan_impl="pallas", bf16=False),
             ("rnn_fwd_tf32_gru", "rnn_bwd_tf32_gru", "window_gather"),
             CUDA_CORE),
            ("c2 training (fused, float32, hidden 120)",
             train_variant(cfg, bf16=False, kwargs=h120),
             ("rnn_fused_fwd_tf32_lstm", "rnn_fused_bwd_tf32_lstm",
              "window_gather"), CUDA_CORE),
            ("c2 training (hoisted, float32, hidden 120)",
             train_variant(cfg, scan_impl="pallas", bf16=False, kwargs=h120),
             ("rnn_fwd_tf32_lstm", "rnn_bwd_tf32_lstm", "window_gather"),
             CUDA_CORE),
            ("GRU training (fused, float32, hidden 120)",
             train_variant(cfg, kind="gru", bf16=False, kwargs=h120),
             ("rnn_fused_fwd_tf32_gru", "rnn_fused_bwd_tf32_gru",
              "window_gather"), CUDA_CORE),
            ("GRU training (hoisted, float32, hidden 120)",
             train_variant(cfg, kind="gru", scan_impl="pallas", bf16=False,
                           kwargs=h120),
             ("rnn_fwd_tf32_gru", "rnn_bwd_tf32_gru", "window_gather"),
             CUDA_CORE),
            *((f"{name} training ({form}, float32, hidden {hidden})",
               train_variant(cfg, kind=cell, bf16=False,
                             kwargs=dict(cfg.model.kwargs, hidden=hidden),
                             **({} if form == "fused"
                                else dict(scan_impl="pallas"))),
               (*f32_route_names(cell, hidden, form == "fused"),
                "window_gather"), CUDA_CORE)
              for hidden in (F32_CLUSTER_HIDDEN, PAST_CAP_HIDDEN)
              for name, cell in (("c2", "lstm"), ("GRU", "gru"))
              for form in ("fused", "hoisted")),
            ("c2 training (fused, hidden 528)", train_variant(cfg, kwargs=h528),
             ("rnn_fused_fwd_grid_bf16_lstm", "rnn_fused_bwd_grid_bf16_lstm",
              "window_gather"), not_core),
            ("c2 training (hoisted, hidden 528)",
             train_variant(cfg, scan_impl="pallas", kwargs=h528),
             ("rnn_fwd_grid_bf16_lstm", "rnn_bwd_grid_bf16_lstm",
              "window_gather"), not_core),
            ("GRU training (fused, hidden 528)",
             train_variant(cfg, kind="gru", kwargs=h528),
             ("rnn_fused_fwd_grid_bf16_gru", "rnn_fused_bwd_grid_bf16_gru",
              "window_gather"), not_core),
            ("GRU training (hoisted, hidden 528)",
             train_variant(cfg, kind="gru", scan_impl="pallas", kwargs=h528),
             ("rnn_fwd_grid_bf16_gru", "rnn_bwd_grid_bf16_gru",
              "window_gather"), not_core))
    for label, run_cfg, must, must_not in runs:
        grid = any("_grid_" in k and "_bwd_" in k for k in must)
        got, counts = counted(label, must, lambda: grid_kernels_seen(
            short_run, torch, run_cfg, splits, TRAIN_STEPS_SHORT), must_not)
        got, seen = got
        for k, n_launch in counts.items():
            totals[k] += n_launch
        if grid:
            # One grid forward and one grid backward a step; the fused
            # backward takes the forward's xw (five kernels, not six), in
            # bf16 and in float32.
            want_k = 5 if "fused" in label else 4
            if (any(counts[k] != TRAIN_STEPS_SHORT for k in must)
                    or seen != [want_k] * TRAIN_STEPS_SHORT):
                fail(f"{label}: launches {counts}, the grid backward's "
                     f"kernels a call {seen}, not one of each a step and "
                     f"{want_k} kernels")
            log(f"{label}: one grid forward and one {want_k}-kernel grid "
                f"backward a step ({seen})")
        want = short_run(torch, plain_variant(run_cfg), splits,
                         TRAIN_STEPS_SHORT)
        err = losses_agree(label, got, want)
        log(f"{label}: {TRAIN_STEPS_SHORT} steps, losses "
            f"{[round(v, 6) for v in got]} agree with the plain path within "
            f"{err:.4g}")
        torch.cuda.empty_cache()

    # Informational, after the counted runs: each step with its backward
    # (and the float32 fused step with its forward) as routed and sent to
    # the CUDA-core kernel, in turns; the float32 hidden-120 step with its
    # route (the 3xTF32 kernels, padded) and with every width sent to the
    # CUDA cores (rnn_fused_fwd.cu and rnn_bwd.cu), in turns.
    from lfm_quant_tpu_torch.ops import rnn as R

    step_in_turns(torch, runs[0][1], splits, "c2 (hoisted)",
                  "_launch_scan_bwd_mma", {
                      "tensor cores": R._launch_scan_bwd_mma,
                      "CUDA cores": lambda cell, *a: R._launch_bwd(
                          cell, False, a[0], None, None, *a[1:])})
    step_in_turns(torch, runs[1][1], splits, "c2 (fused, float32)",
                  "_launch_bwd_tf32", {"tensor cores (3xTF32)":
                                       R._launch_bwd_tf32,
                                       "CUDA cores": cuda_core_bwd})
    step_in_turns(torch, runs[1][1], splits, "c2 (fused, float32)",
                  "_launch_fwd_tf32", {
                      "tensor cores (3xTF32)": R._launch_fwd_tf32,
                      "CUDA cores": cuda_core_fwd}, part="forward")
    step_in_turns(torch, runs[7][1], splits,
                  "c2 (fused, float32, hidden 120)", "_mma_route", {
                      "tensor cores (3xTF32, padded to 128)": R._mma_route,
                      "CUDA cores": lambda *a, **k: "simt"},
                  part="recurrence")


def grid_kernels_seen(fn, *args):
    """``fn(*args)`` with every bf16 grid backward's kernel count recorded
    (``ops.rnn._launch_bwd_grid``'s ``stats``) → (its result, the counts,
    one a call); the launcher restored after."""
    from lfm_quant_tpu_torch.ops import rnn as R

    real = R._launch_bwd_grid
    seen = []

    def launch(*a, stats=None, **kw):
        st = {} if stats is None else stats
        out = real(*a, stats=st, **kw)
        if "kernels" in st:
            seen.append(st["kernels"])
        return out

    R._launch_bwd_grid = launch
    try:
        return fn(*args), seen
    finally:
        R._launch_bwd_grid = real


def f32_route_names(cell: str, H: int, fused: bool) -> tuple:
    """The counters of the float32 forward and backward that the route
    (``ops/rnn.py _mma_route``) takes at hidden ``H``, fused or
    hoisted."""
    import torch

    from lfm_quant_tpu_torch.ops import rnn as R

    tags = {"tf32": "tf32_", "grid": "grid_", "simt": ""}
    form = "fused_" if fused else ""
    return tuple(f"rnn_{form}{d}_{tags[R._mma_route(torch.float32, H, d)]}"
                 f"{cell}" for d in ("fwd", "bwd"))


def cuda_core_bwd(*a, xw=None):
    """``_launch_bwd_tf32``'s stand-in on ``rnn_bwd.cu``, which forms its
    own xw (the forward's, ``xw``, goes unused)."""
    from lfm_quant_tpu_torch.ops import rnn as R

    return R._launch_bwd(*a)


def cuda_core_fwd(cell, fused, *a, keep_xw=False):
    """``_launch_fwd_tf32``'s stand-in on ``rnn_fused_fwd.cu``: no xw
    scratch, so the backward makes its own xw."""
    from lfm_quant_tpu_torch.ops import rnn as R

    out = R._launch_fwd(cell, not fused, *a)
    return (*out, None) if keep_xw else out


def step_in_turns(torch, cfg, splits, label: str, attr: str, modes: dict,
                  part: str = "backward") -> None:
    """``cfg``'s train step in ms per step with ``ops.rnn.<attr>`` (the
    launcher of the route's ``part``, its backward or forward) set to each
    of ``modes`` in turn: ``HOISTED_STEPS`` steps each, twice, host clock
    around synchronised work, and the peak device memory of each turn
    above what was allocated before it; the launcher restored after."""
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, splits, device="cuda")
    state = trainer.init_state()
    fi, ti, w = trainer._batch(trainer.train_sampler.stacked_epoch(1))
    n = min(HOISTED_STEPS, fi.shape[0])

    def per_step():
        s = state
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for k in range(n):  # warm
            s, _ = trainer.step(s, fi[k], ti[k], w[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n):
            s, _ = trainer.step(s, fi[k], ti[k], w[k])
        torch.cuda.synchronize()
        return (1e3 * (time.perf_counter() - t0) / n,
                torch.cuda.max_memory_allocated() - base)

    routed = getattr(R, attr)
    times = {mode: [] for mode in modes}
    peaks = {mode: [] for mode in modes}
    try:
        for _ in range(2):
            for mode, launcher in modes.items():
                setattr(R, attr, launcher)
                t, peak = per_step()
                times[mode].append(t)
                peaks[mode].append(peak)
    finally:
        setattr(R, attr, routed)
    log(f"train {label} steady state, ms/step in turns: "
        + ", ".join(f"{part} on the {mode} "
                    f"{[round(t, 3) for t in times[mode]]}"
                    for mode in modes) + f" ({n} steps each); peak MB "
        + ", ".join(f"{mode} {[round(p / 2**20, 1) for p in peaks[mode]]}"
                    for mode in modes))
    del trainer, state
    torch.cuda.empty_cache()


def check_seed_batched(torch, trainer, kernels, where: str = "c5 train step",
                       check=None, timed=None) -> None:
    """The c5 train step's seed-batched launches (S 64 x B 2048, T 60, H
    128, LSTM, bf16; ``trainer``'s seeds) on the layer-0 input of the
    first stacked batch of epoch 0 and the model's seeded weights: the
    gather folded over the seeds, exact; the fused forward and backward
    each bitwise equal to one-seed launches with the same rows per block
    (every seed, or those of ``check``), m of seed extent 1 bitwise equal
    to its broadcast copy, and each checked seed within the plain
    version's tolerance; each timed beside its bound, the one-seed
    launches and the plain version (one seed at a time) of the seeds of
    ``timed`` (default: the checked ones); row 4's
    library yardstick is the per-seed weight-gradient products as one f32
    ``torch.bmm`` (random operands of the products' shapes). Recorded
    under ``where``."""
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.ops.gather import gather_windows

    trainer.init_state()  # the seeded init of every member
    (fi_all, ti_all, _), _ = trainer._build_epoch(0)
    fi, ti = fi_all[0], ti_all[0]  # [S, D, Bf]
    S, D, Bf = fi.shape
    check = list(range(S) if check is None else check)
    timed = check if timed is None else list(timed)
    W, fp = trainer.window, trainer.fp
    xm = trainer.dev["xm"]
    x, m = gather_windows(xm, fi, ti, W, fp=fp)
    for s in range(S):
        xr, mr = gather_windows_packed(xm, fi[s], ti[s], W, fp=fp)
        if not (torch.equal(x[s], xr) and torch.equal(m[s], mr)):
            fail(f"seed-folded gather differs at seed {s}")
    fi_np = fi.reshape(S * D, Bf).cpu().numpy()
    ti_np = ti.reshape(S * D).cpu().numpy()
    report(kernels, "window_gather_seeds", where, dict(
        shape=list(x.shape), max_abs_err=0.0, tolerance="exact",
        **kernel_ms(lambda: gather_windows(xm, fi, ti, W, fp=fp),
                    launches=20),
        plain_ms=time_ms(lambda: gather_windows_packed(
            xm, fi.reshape(S * D, Bf), ti.reshape(S * D), W, fp=fp)),
        bound_ms=gather_bound(fi_np, ti_np, W, fp, xm.shape[1],
                              xm.element_size()),
        bound_by="bytes", library_ms=None, library_note=GATHER_NO_LIBRARY))
    model = trainer.model
    cd = model.dtype
    B = D * Bf
    with torch.no_grad():
        hin = model.embed(x.reshape(S, B, W, -1), dtype=cd)
        mm = m.reshape(S, B, W)
        wx = model.xproj[0].kernel.detach().to(cd)
        bb = model.xproj[0].bias.detach().to(cd)
        wh = model.h_proj[0].detach().to(cd)
    del x, m
    H = hin.shape[-1]
    cell = "lstm"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = R._mma_rows(B, sms, S)
    args = (cell, hin, wx, bb, wh, mm, 1.0, True)

    # Row 3: one launch for all seeds against 64 one-seed launches.
    h, c = R._fused_states(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for s in check:
        h1, c1 = R._launch_fwd_mma(cell, hin[s], wx[s], bb[s], wh[s], mm[s],
                                   1.0, True, rows)
        if not (torch.equal(h[s], h1) and torch.equal(c[s], c1)):
            fail(f"seed-batched fused fwd differs from the one-seed launch "
                 f"at seed {s}")
        want_h, want_c = R.rnn_scan_states(
            cell, hin[s].float() @ wx[s].float() + bb[s].float(), wh[s],
            mm[s], 1.0, True)
        for got, want in ((h1, want_h), (c1, want_c)):
            err, excess = worst_excess(got, want, BF16_TOL, BF16_TOL)
            if excess > 0 or not torch.isfinite(got).all():
                fail(f"seed-batched fused fwd seed {s}: max err {err}")
            worst = max(worst, err)
    shared, _ = R._fused_states(cell, hin, wx, bb, wh, mm[:1], 1.0, False)
    full, _ = R._fused_states(cell, hin, wx, bb, wh,
                              mm[:1].expand(S, B, W).contiguous(), 1.0,
                              False)
    if not torch.equal(shared, full):
        fail("seed-batched fused fwd: m of seed extent 1 differs from its "
             "broadcast copy")
    del shared, full, h1, c1, want_h, want_c
    bound, by = rnn_bound("fused_fwd", cell, B, W, H, 2, True, seeds=S)
    ms = kernel_ms(lambda: R._fused_states(*args), reps=5, launches=2)
    singles_ms = time_ms(lambda: [R._launch_fwd_mma(
        cell, hin[s], wx[s], bb[s], wh[s], mm[s], 1.0, True, rows)
        for s in timed], reps=3, warmup=1)
    plain_ms = time_ms(lambda: [R.rnn_scan_states(
        cell, hin[s].float() @ wx[s].float() + bb[s].float(), wh[s], mm[s],
        1.0, True) for s in timed], reps=1, warmup=0)
    report(kernels, "rnn_fused_fwd_mma_lstm_seeds", where, dict(
        shape=[S, B, W, H], rows_per_block=rows, bitwise_vs_single=True,
        seeds_checked=len(check),
        max_abs_err=worst, tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}",
        **ms, single_seed_launches_ms=singles_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None, library_note=(
            "no single PyTorch call: torch.nn.LSTM takes one weight set "
            "per call, so 64 seeds are 64 calls")))
    log(f"seed-batched fused fwd at the {where}: {ms['ms']:.3f} ms for {S} "
        f"seeds in one launch, {singles_ms:.3f} ms in {len(timed)} one-seed "
        f"launches, bound {bound:.3f} ms")

    # Row 4 on the forward's states.
    gen = torch.Generator(device="cuda").manual_seed(5)
    dh = (0.1 * torch.randn(S, B, W, H, generator=gen, device="cuda")).to(cd)
    bargs = (cell, hin, wx, bb, wh, mm, h, c, dh)
    got = R.rnn_scan_fused_bwd(*bargs)
    torch.cuda.synchronize()
    worst = wgrad = 0.0
    for s in check:
        one = R.rnn_scan_fused_bwd(cell, *(t[s] for t in bargs[1:]))
        if not all(torch.equal(g[s], o) for g, o in zip(got, one)):
            fail(f"seed-batched fused bwd differs from the one-seed call at "
                 f"seed {s}")
        want = R.rnn_scan_fused_bwd_reference(cell, *(t[s] for t in
                                                       bargs[1:]))
        worst = max(worst, grads_close(f"seed-batched fused bwd seed {s}",
                                       one, want, cd, MMA_WGRAD_TOL))
        wgrad = max(wgrad, max(scaled_err(g, w)
                               for g, w in zip(one[1:], want[1:])))
    del one, want
    shared = R.rnn_scan_fused_bwd(cell, hin, wx, bb, wh, mm[:1], h, c, dh)
    full = R.rnn_scan_fused_bwd(cell, hin, wx, bb, wh,
                                mm[:1].expand(S, B, W).contiguous(), h, c,
                                dh)
    if not all(torch.equal(a, z) for a, z in zip(shared, full)):
        fail("seed-batched fused bwd: m of seed extent 1 differs from its "
             "broadcast copy")
    del shared, full, got
    torch.cuda.empty_cache()
    bound, by = rnn_bound("fused_bwd", cell, B, W, H, 2, seeds=S)
    ms = kernel_ms(lambda: R.rnn_scan_fused_bwd(*bargs), reps=3, launches=1)
    singles_ms = time_ms(lambda: [R.rnn_scan_fused_bwd(
        cell, *(t[s] for t in bargs[1:])) for s in timed], reps=1)
    plain_ms = time_ms(lambda: [R.rnn_scan_fused_bwd_reference(
        cell, *(t[s] for t in bargs[1:])) for s in timed], reps=1,
        warmup=0)
    del h, c, dh, bargs
    torch.cuda.empty_cache()
    # The yardstick: dW_x and dW_h of every seed in one f32 bmm, [S, 2H,
    # B T] @ [S, B T, 4H] (the LSTM's d_hw is d_xw).
    a = torch.randn(S, 2 * H, B * W, generator=gen, device="cuda")
    d = torch.randn(S, B * W, 4 * H, generator=gen, device="cuda")
    library_ms = time_ms(lambda: torch.bmm(a, d), reps=5)
    del a, d
    torch.cuda.empty_cache()
    report(kernels, "rnn_fused_bwd_mma_lstm_seeds", where, dict(
        shape=[S, B, W, H], bitwise_vs_single=True, max_abs_err=worst,
        seeds_checked=len(check),
        wgrad_scaled_err=wgrad,
        tolerance=f"scaled atol {BF16_TOL}, weight gradients "
                  f"{MMA_WGRAD_TOL}",
        **ms, single_seed_launches_ms=singles_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=library_ms))
    log(f"seed-batched fused bwd at the {where}: {ms['ms']:.3f} ms for {S} "
        f"seeds in one call, {singles_ms:.3f} ms in {len(timed)} one-seed "
        f"calls, bound {bound:.3f} ms, library bmm {library_ms:.3f} ms")
    del hin, mm
    torch.cuda.empty_cache()


def ensemble_steps(torch, cfg, splits, n_steps: int, date_range=None,
                   device: str = "cuda"):
    """``n_steps`` c5 steps of a fresh ``EnsembleTrainer`` on the card from
    the seeded init and the epoch-0 sampler orders → per-step per-seed
    losses ``[n_steps][S]`` (this rank's members in a seed-sharded
    group); with ``date_range``, also the forecasts of that month range
    from the state after them, at the valid cells (``[S, cells]``, every
    member's), and the validity ``[N, T]``."""
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer

    trainer = EnsembleTrainer(cfg, splits, device=device)
    state = trainer.init_state()
    (fi, ti, w), _ = trainer._build_epoch(0)
    losses = []
    for k in range(n_steps):
        state, ms = trainer.step(state, fi[k], ti[k], w[k])
        losses.append(ms["loss"])
    losses = torch.stack(losses).cpu().tolist()
    if date_range is None:
        return losses
    trainer.state = state
    fc, valid = trainer.predict(date_range=date_range)
    return losses, (fc[:, valid], valid)


def c5_phase(torch, cfg, splits, kernels, seed_launches):
    """Phase 6: c5, the 64-seed ensemble, for one epoch on the kernels;
    its epoch's launches go to ``seed_launches``. Returns the trained
    ensemble, and what phase 16 is held to: the first steps' per-seed
    losses and the forecasts of :data:`C5_PREDICT_MONTHS` test months
    after them."""
    import numpy as np

    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer

    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, epochs=1))
    trainer = EnsembleTrainer(cfg, splits, device="cuda")
    check_seed_batched(torch, trainer, kernels, check=C5_CHECK_SEEDS,
                       timed=range(cfg.n_seeds))

    # The first steps against the plain path on the card.
    lo = splits.range_of("test")[0]
    span = (lo, lo + C5_PREDICT_MONTHS)
    got, fc = ensemble_steps(torch, cfg, splits, C5_PLAIN_STEPS,
                             date_range=span)
    one = {"losses": got, "predict": fc, "range": span}
    _build.reset_launch_counts()
    plain_cfg = dataclasses.replace(plain_variant(cfg),
                                    seed_block=C5_PLAIN_BLOCK)
    t0 = time.perf_counter()
    want = ensemble_steps(torch, plain_cfg, splits, C5_PLAIN_STEPS)
    plain_s = time.perf_counter() - t0
    if any(_build.launch_counts().values()):
        fail(f"the plain c5 path launched kernels: {_build.launch_counts()}")
    err = losses_agree("c5 fused vs plain", got, want)
    one["plain_losses"] = want  # phase 27's reference too
    log(f"c5: {C5_PLAIN_STEPS} steps x 64 seeds agree with the plain path "
        f"(seed_block {C5_PLAIN_BLOCK}, {plain_s:.1f} s) within {err:.4g}; "
        f"first step's losses {min(got[0]):.5f} .. {max(got[0]):.5f}")
    torch.cuda.empty_cache()

    # One step: each kernel of the step exactly once, for all 64 seeds.
    state = trainer.init_state()
    (fi, ti, w), _ = trainer._build_epoch(1)
    _build.reset_launch_counts()
    state, _ = trainer.step(state, fi[0], ti[0], w[0])
    counts = _build.launch_counts()
    for k in ("window_gather", "rnn_fused_fwd_mma_lstm",
              "rnn_fused_bwd_mma_lstm"):
        if counts[k] != 1:
            fail(f"one c5 step launched {k} {counts[k]} times, not once")
    if any(counts[k] for k in CUDA_CORE):
        fail(f"a c5 step launched a CUDA-core kernel: {counts}")
    log(f"launches in one c5 step (64 seeds): "
        f"{ {k: n for k, n in counts.items() if n} }")

    # Steady state: ms per step, memory, the device's view.
    n = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def steps():
        st = state
        for k in range(1, n + 1):
            st, _ = trainer.step(st, fi[k], ti[k], w[k])

    steps()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / n
    fm = float(w[1:n + 1].sum()) * cfg.data.window / n
    S = cfg.n_seeds
    one["step_ms"], one["peak_gib"] = 1e3 * per_step, peak
    log(f"train c5 steady state: {1e3 * per_step:.3f} ms/step, "
        f"{1 / per_step:.3f} steps/s, {S / per_step:.1f} seed-steps/s, "
        f"{fm / per_step:.1f} firm-months/s ({n} steps of {S} seeds, host "
        f"clock around synchronized work); peak memory {peak:.2f} GiB")
    profile_device(torch, steps, f"c5 train, {n} steps of {S} seeds")
    del state
    torch.cuda.empty_cache()

    # One epoch with its validation sweep, the main path of the slice.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary, counts = counted(
        "c5 training", ("window_gather", "rnn_fused_fwd_mma_lstm",
                        "rnn_fused_bwd_mma_lstm"), trainer.fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    K = trainer._steps_per_epoch
    if counts["rnn_fused_bwd_mma_lstm"] != K or counts["window_gather"] != K:
        fail(f"c5 epoch of {K} steps: launches {counts}")
    if any(counts[k] for k in CUDA_CORE):
        fail(f"the c5 epoch launched a CUDA-core kernel: {counts}")
    for k, v in counts.items():
        seed_launches[k] += v
    one["epoch_losses"] = summary["step_losses"]  # phase 20's reference
    rec = summary["history"][0]
    if not all(np.isfinite(rec[k]) for k in ("train_loss", "val_ic",
                                             "val_ic_std")):
        fail(f"c5 epoch: {rec}")
    log(f"train c5 (kernels): {K} steps + val sweep in {wall:.3f} s; "
        f"train_loss {rec['train_loss']:.6f} val_ic {rec['val_ic']:.6f} "
        f"val_ic_std {rec['val_ic_std']:.6f}; "
        f"{summary['firm_months_per_sec']:.1f} firm-months/s over the epoch; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # The validation sweep alone, on the best state.
    vb = trainer.val_sampler.stacked_cross_sections()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev = trainer.evaluate()
    sweep = time.perf_counter() - t0
    M, pool = vb.firm_idx.shape
    C = min(cfg.data.dates_per_batch, M)
    log(f"c5 validation sweep: {sweep:.3f} s for {M} months x a {pool}-firm "
        f"pool x {S} seeds ({-(-M // C)} month chunks x "
        f"{-(-S // trainer._seed_chunk(C * pool))} seed chunks); ic_mean "
        f"{ev['ic_mean']:.6f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return trainer, one


def reports_match(label: str, got, want) -> dict:
    """The device engine's report against the numpy engine's at
    ``REPORT_TOL`` (``tests/test_jax_backtest.py assert_reports_match``):
    months, skipped months and dates exact, the monthly series within
    their float32 bounds, CAGR rtol 1e-4, Sharpe rtol 1e-3. Returns the
    largest differences."""
    import numpy as np

    if (got.n_months, got.n_skipped_months) != (want.n_months,
                                                 want.n_skipped_months) \
            or not np.array_equal(got.dates, want.dates):
        fail(f"{label}: months {got.n_months}/{got.n_skipped_months} "
             f"against the numpy engine's {want.n_months}/"
             f"{want.n_skipped_months}, or other dates")
    errs = {}
    for field, tol in (("monthly_returns", "ret"), ("monthly_bench", "ret"),
                       ("monthly_ic", "ic"), ("quantile_profile", "profile"),
                       ("turnover", "turn"), ("mean_ic", "ic"),
                       ("mean_ret_ic", "ic")):
        err = float(np.max(np.abs(np.asarray(getattr(got, field), np.float64)
                                  - np.asarray(getattr(want, field)))))
        if not err <= REPORT_TOL[tol]:
            fail(f"{label}: {field} differs from the numpy engine by {err} "
                 f"(atol {REPORT_TOL[tol]})")
        errs[field] = err
    for field, rtol, atol in (("cagr", 1e-4, 1e-6),
                              ("sharpe_ann", 1e-3, 1e-4)):
        a, b = getattr(got, field), getattr(want, field)
        if not abs(a - b) <= atol + rtol * abs(b):
            fail(f"{label}: {field} {a} against the numpy engine's {b}")
        errs[field] = abs(a - b)
    return errs


def c5_backtest_phase(torch, trainer, panel, totals, seed_launches
                      ) -> None:
    """Phase 7: the c5 ensemble trained by phase 6, written to a run dir
    and reloaded through ``load_forecaster``; its test-split forecasts
    (64 seeds, one seed-grid launch of the fused forward per month and
    seed chunk) held to the plain path on the card; three aggregation
    modes backtested in one ``run_scoring_pipeline`` pass and each report
    held to the numpy engine on the same host-fetched scores. The
    predict's gathers (one [8, Bf] gather per month chunk, shared by every
    seed) go to ``totals``, its seed-grid launches to ``seed_launches``."""
    import tempfile

    import numpy as np

    from lfm_quant_tpu_torch.backtest import engine
    from lfm_quant_tpu_torch.backtest.torch_engine import (
        aggregate_scores_device,
        run_scoring_pipeline,
    )
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.ensemble import (
        EnsembleTrainer,
        write_ensemble_run_dir,
    )
    from lfm_quant_tpu_torch.train.forecast import load_forecaster
    from lfm_quant_tpu_torch.train.loop import predict_batch

    cfg = trainer.cfg
    S = cfg.n_seeds
    with tempfile.TemporaryDirectory() as run_dir:
        write_ensemble_run_dir(run_dir, trainer)
        t0 = time.perf_counter()
        model, splits, is_ensemble = load_forecaster(run_dir, panel=panel,
                                                     device="cuda")
        load_s = time.perf_counter() - t0
    if not is_ensemble or not all(
            torch.equal(p, trainer.state.params[k])
            for k, p in model.state.params.items()):
        fail("c5 run dir: load_forecaster did not restore the trained "
             "ensemble")
    del trainer
    torch.cuda.empty_cache()

    # The forecast on the kernels, counted.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (stacked, valid), counts = counted(
        "c5 predict (test split)", ("window_gather",
                                    "rnn_fused_fwd_mma_lstm"),
        lambda: model.predict("test"), must_not=CUDA_CORE)
    predict_ms = 1e3 * (time.perf_counter() - t0)
    predict_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    months = np.nonzero(valid.any(axis=0))[0]
    pool = int(valid.sum(axis=0).max())
    M, bf = predict_batch(cfg, splits, "test", None, True).firm_idx.shape
    C = min(cfg.data.dates_per_batch, M)
    month_chunks = -(-M // C)
    chunks = (month_chunks * -(-S // model._seed_chunk(C * bf))
              * model.model.layers)
    if counts["rnn_fused_fwd_mma_lstm"] != chunks or \
            counts["window_gather"] != month_chunks:
        fail(f"c5 predict: launches {counts} for {month_chunks} month "
             f"chunks (one gather each) and {chunks} (month, seed, layer) "
             "chunks of the fused forward")
    totals["window_gather"] += counts["window_gather"]
    seed_launches["rnn_fused_fwd_mma_lstm"] += counts[
        "rnn_fused_fwd_mma_lstm"]
    if stacked.shape != (S, panel.n_firms, panel.n_months) or \
            not np.isfinite(stacked).all() or stacked[:, ~valid].any():
        fail(f"c5 predict: forecasts {stacked.shape}, finite "
             f"{np.isfinite(stacked).all()}, zero outside the valid cells")
    log(f"c5 predict (test split, {months.size} months x up to {pool} "
        f"firms x {S} seeds): {predict_ms:.1f} ms on the kernels, "
        f"{counts['window_gather']} gathers and "
        f"{counts['rnn_fused_fwd_mma_lstm']} seed-grid launches of the fused "
        f"forward; run dir reloaded in {load_s:.2f} s; peak memory "
        f"{predict_peak:.2f} GiB")
    # The same predict, timed warm, on the gather kernel and on the plain
    # gather (the fused forward on both): what the gather kernel saves.
    warm = {}
    for impl in ("kernel", "plain"):
        model.gather_impl = impl
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict("test")
        warm.setdefault(impl, []).append(1e3 * (time.perf_counter() - t0))
    model.gather_impl = "kernel"
    log(f"c5 predict warm: {', '.join(f'{x:.1f}' for x in warm['kernel'])}"
        f" ms on the gather kernel; "
        f"{', '.join(f'{x:.1f}' for x in warm['plain'])} ms on the plain "
        "gather (host clock, host copy of the forecasts included)")
    profile_device(torch, lambda: model.predict("test"),
                   f"c5 predict, test split, {S} seeds")

    # The plain path on the card, from the same params, over the test
    # split's first C5_PLAIN_PREDICT_MONTHS months (the plain path of 64
    # seeds takes about 0.3 s a month), the kernels' forecast of the same
    # months beside it.
    lo = splits.range_of("test")[0]
    span = (lo, lo + C5_PLAIN_PREDICT_MONTHS)
    got, got_valid = model.predict(date_range=span)
    plain = EnsembleTrainer(plain_variant(cfg), splits, device="cuda")
    plain.state = plain.init_state({k: p.detach().cpu().numpy()
                                    for k, p in model.state.params.items()})
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    want, want_valid = plain.predict(date_range=span)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if any(_build.launch_counts().values()):
        fail(f"the plain c5 predict launched kernels: "
             f"{_build.launch_counts()}")
    del plain
    torch.cuda.empty_cache()
    if not np.array_equal(want_valid, got_valid) or not got_valid.any():
        fail("c5 predict: the plain path's valid cells differ")
    err = np.abs(got[:, got_valid] - want[:, got_valid])
    if (err > BF16_TOL + BF16_TOL * np.abs(want[:, got_valid])).any():
        fail(f"c5 predict: forecasts differ from the plain path by up to "
             f"{err.max()}")
    log(f"c5 predict matches the plain path on the card "
        f"({int(got_valid.sum())} cells x {S} seeds, months {span}): max abs "
        f"err {err.max():.4g} (tol {BF16_TOL} + {BF16_TOL}|plain|); plain "
        f"path {plain_ms:.1f} ms")
    del want, err, got

    # Three modes backtested in one pass, against the numpy engine.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reports = run_scoring_pipeline(stacked, valid, panel, modes=C5_MODES,
                                   device="cuda")
    torch.cuda.synchronize()
    score_ms = 1e3 * (time.perf_counter() - t0)
    score_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    scores, svalid, specs = aggregate_scores_device(stacked, valid, C5_MODES,
                                                    device="cuda")
    scores = scores.cpu().numpy()
    t0 = time.perf_counter()
    refs = [engine.aggregate_ensemble(stacked, valid, m, lam)
            for m, lam in specs]
    agg_np_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref_reports = {engine.mode_label(m, lam): engine.run_backtest(
        scores[g], svalid, panel) for g, (m, lam) in enumerate(specs)}
    bt_np_ms = 1e3 * (time.perf_counter() - t0)
    agg_err = max(float(np.abs(scores[g] - r[0]).max())
                  for g, r in enumerate(refs))
    if agg_err > 1e-5:
        fail(f"c5 aggregation differs from the numpy engine by {agg_err}")
    if list(reports) != list(ref_reports):
        fail(f"c5 scoring: modes {list(reports)}")
    for label, rep in reports.items():
        errs = reports_match(f"c5 {label}", rep, ref_reports[label])
        log(f"c5 backtest {label}: {rep.summary()}; against the numpy "
            f"engine: cagr {errs['cagr']:.3g}, sharpe {errs['sharpe_ann']:.3g}"
            f", monthly returns {errs['monthly_returns']:.3g}, ic "
            f"{errs['monthly_ic']:.3g}")
    log(f"c5 scoring ({len(specs)} modes x {panel.n_months} months x "
        f"{panel.n_firms} firms from [{S}, N, T] forecasts): "
        f"{score_ms:.1f} ms on the card (aggregate + backtest, host to "
        f"host; peak {score_peak:.2f} GiB) against the numpy engine's "
        f"{agg_np_ms:.1f} ms to aggregate + {bt_np_ms:.1f} ms to backtest; "
        f"aggregation within {agg_err:.3g} of numpy")
    del model, stacked, scores
    torch.cuda.empty_cache()


def walkforward_phase(torch, cfg, panel, totals) -> None:
    """Phase 8: ``run_walkforward`` on c2 at full width, two folds in one
    call, as ``--walk-forward`` runs it: one trainer, built for fold 0 and
    rebound for fold 1. Counted as one main path, and per fold by wrapping
    the trainer's ``fit`` and ``predict``: each fold's fit launches the
    gather and the fused backward once per step (the fused forward also
    in its validation sweep), its predict the gather once per month chunk
    and the fused forward once per chunk and layer; the folds' launches
    add up to the sweep's. The stitched validity is exactly the eligible
    cells of the two 12-month windows; the stitched panel is scored on the
    card (``score_stitched``, mode "mean") and held to the numpy engine.
    The launches go to ``totals``."""
    import tempfile

    import numpy as np

    from lfm_quant_tpu_torch.backtest import engine
    from lfm_quant_tpu_torch.backtest.torch_engine import (
        run_scoring_pipeline,
    )
    from lfm_quant_tpu_torch.data.windows import anchor_index
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.loop import Trainer, predict_batch
    from lfm_quant_tpu_torch.train.walkforward import (
        run_walkforward,
        score_stitched,
        walkforward_folds,
    )

    preset_epochs = cfg.optim.epochs
    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, epochs=WF_EPOCHS))
    d = cfg.data
    # The train entry point's default first train_end: 60% into the panel.
    start = int(panel.dates[int(panel.n_months * 0.6)])
    folds = walkforward_folds(panel, start, WF_STEP, WF_VAL, WF_FOLDS)
    log(f"c2 walk-forward: {panel.n_firms} firms x {panel.n_months} months,"
        f" LSTM hidden {cfg.model.kwargs.get('hidden')}, bf16; cut from the "
        f"preset: epochs {preset_epochs} -> {WF_EPOCHS}, folds -> "
        f"{WF_FOLDS} (--wf-folds), step {WF_STEP} months, val {WF_VAL} "
        f"months, start {start} (the default); folds {folds}")

    # Per-fold launches and times, read around the trainer's own calls.
    fold_log = []

    def since(before):
        after = _build.launch_counts()
        return {k: after[k] - before.get(k, 0) for k in after}

    def timed(fn):
        torch.cuda.synchronize()
        before, t0 = _build.launch_counts(), time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, since(before), 1e3 * (time.perf_counter() - t0)

    def fit(self, *args, **kwargs):
        out, counts, ms = timed(lambda: real_fit(self, *args, **kwargs))
        fold_log.append({"trainer": self, "steps": out["steps"],
                         "fit": counts, "fit_ms": ms})
        return out

    def predict(self, *args, **kwargs):
        out, counts, ms = timed(lambda: real_predict(self, *args, **kwargs))
        rec = fold_log[-1]
        rec.update(predict=counts, predict_ms=ms, months=predict_batch(
            self.cfg, self.splits, "test", kwargs["date_range"],
            True).firm_idx.shape[0], layers=self.model.layers)
        return out

    real_fit, real_predict = Trainer.fit, Trainer.predict
    Trainer.fit, Trainer.predict = fit, predict
    try:
        with tempfile.TemporaryDirectory() as out:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (fc, valid, summary), counts = counted(
                "c2 walk-forward (2 folds)",
                ("window_gather", "rnn_fused_fwd_mma_lstm",
                 "rnn_fused_bwd_mma_lstm"),
                lambda: run_walkforward(
                    cfg, panel, start=start, step_months=WF_STEP,
                    val_months=WF_VAL, n_folds=WF_FOLDS, out_dir=out,
                    device="cuda"),
                must_not=CUDA_CORE)
            sweep_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        Trainer.fit, Trainer.predict = real_fit, real_predict
    for name, n in counts.items():
        totals[name] += n
    if len(fold_log) != WF_FOLDS or len(summary["folds"]) != WF_FOLDS:
        fail(f"c2 walk-forward: {len(fold_log)} fits, records "
             f"{summary['folds']}")
    if any(f["trainer"] is not fold_log[0]["trainer"] for f in fold_log):
        fail("c2 walk-forward: a fold built a new trainer instead of "
             "rebinding the sweep's one")
    sums = {k: sum(f["fit"][k] + f["predict"][k] for f in fold_log)
            for k in counts}
    if sums != counts:
        fail(f"c2 walk-forward: the folds' launches {sums} do not add up "
             f"to the sweep's {counts}")
    C = d.dates_per_batch
    for k, f in enumerate(fold_log):
        fi, pr = f["fit"], f["predict"]
        chunks = -(-f["months"] // min(C, f["months"]))
        if not (fi["window_gather"] == fi["rnn_fused_bwd_mma_lstm"]
                == f["steps"] > 0) or fi["rnn_fused_fwd_mma_lstm"] <= \
                f["steps"]:
            fail(f"c2 walk-forward fold {k} fit: {f['steps']} steps, "
                 f"launches {fi}")
        if pr["window_gather"] != chunks or pr["rnn_fused_bwd_mma_lstm"] \
                or pr["rnn_fused_fwd_mma_lstm"] != chunks * f["layers"]:
            fail(f"c2 walk-forward fold {k} predict: {chunks} month "
                 f"chunks, launches {pr}")
    for k in range(1, WF_FOLDS):
        if folds[k][2][0] < folds[k - 1][2][1]:
            fail(f"c2 walk-forward: fold {k}'s window overlaps the last")
    elig = anchor_index(panel, d.window, d.min_valid_months)
    want_valid = np.zeros_like(elig)
    for _, _, (lo, hi) in folds:
        want_valid[:, lo:hi] = elig[:, lo:hi]
    if not np.array_equal(valid, want_valid) or \
            not np.isfinite(fc).all() or fc[~valid].any():
        fail("c2 walk-forward: the stitched validity is not the eligible "
             "cells of the fold windows, or the forecasts are not finite "
             "and zero elsewhere")
    for k, (f, rec) in enumerate(zip(fold_log, summary["folds"])):
        log(f"c2 walk-forward fold {k} (train to {rec['train_end']}, val "
            f"to {rec['val_end']}, forecast months {rec['pred_months']}): "
            f"fit {f['fit_ms']:.1f} ms ({f['steps']} steps + val sweep), "
            f"predict {f['predict_ms']:.1f} ms ({rec['n_pred_cells']} "
            f"cells); best_val_ic {rec['best_val_ic']:.6f}; launches: fit "
            f"{ {n: c for n, c in f['fit'].items() if c} }, predict "
            f"{ {n: c for n, c in f['predict'].items() if c} }")
    log(f"c2 walk-forward sweep ({WF_FOLDS} folds, one trainer rebound "
        f"per fold, fold run dirs and snapshots written): {sweep_ms:.1f} "
        "ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    digest = score_stitched(fc, valid, panel, ["mean"], device="cuda")
    torch.cuda.synchronize()
    score_ms = 1e3 * (time.perf_counter() - t0)
    rep = run_scoring_pipeline(fc, valid, panel, device="cuda")["mean"]
    t0 = time.perf_counter()
    ref = engine.run_backtest(fc, valid, panel)
    np_ms = 1e3 * (time.perf_counter() - t0)
    errs = reports_match("c2 walk-forward, mean", rep, ref)
    if digest["mean"]["summary"] != rep.summary():
        fail("c2 walk-forward: score_stitched and the pipeline disagree")
    log(f"c2 walk-forward scored on the card (mode mean): {score_ms:.1f} ms "
        f"against the numpy engine's {np_ms:.1f} ms; {rep.summary()}; "
        f"cagr within {errs['cagr']:.3g} of numpy")
    torch.cuda.empty_cache()


def c3_config(n_data_shards: int = 1):
    """c3 at full width, cut to one epoch (its 30 epochs are not run)."""
    from lfm_quant_tpu_torch.config import get_preset

    cfg = get_preset("c3")
    return dataclasses.replace(
        cfg, n_data_shards=n_data_shards,
        optim=dataclasses.replace(cfg.optim, epochs=1))


def c3_splits(cfg):
    from lfm_quant_tpu_torch.data.panel import PanelSplits
    from lfm_quant_tpu_torch.train.loop import default_split_dates, \
        resolve_panel

    panel = resolve_panel(cfg.data)
    return PanelSplits.by_date(panel, *default_split_dates(panel, cfg.data),
                               train_start=cfg.data.train_start)


def first_steps(torch, trainer, n_steps: int):
    """``n_steps`` steps of ``trainer`` from the seeded init on epoch 0's
    batches → (per-step losses, per-step grad norms, the state)."""
    state = trainer.init_state()
    fi, ti, w = trainer._batch(trainer.train_sampler.stacked_epoch(0))
    losses, gnorms = [], []
    for k in range(n_steps):
        state, ms = trainer.step(state, fi[k], ti[k], w[k])
        losses.append(ms["loss"])
        gnorms.append(ms["grad_norm"])
    return ([float(v) for v in torch.stack(losses).cpu()],
            [float(v) for v in torch.stack(gnorms).cpu()], state)


def check_c3_step_shapes(torch, trainer, kernels, gen) -> None:
    """The gather, row 3 and row 4 at the c3 train step's shapes (the
    GRU's own weights, bf16): the first batch of ``stacked_epoch(0)``,
    ``[8, Bf]`` windows, B = 8 Bf rows. Row 3 beside one cuDNN
    ``nn.GRU`` call (a GRU saves no c_all: the training forward is the
    serving one), row 4 beside its weight-gradient products."""
    b = trainer.train_sampler.stacked_epoch(0)
    d = trainer.cfg.data
    model = trainer.model
    cd = model.dtype
    with torch.inference_mode():
        x, m = check_gather(torch, kernels, "c3 train step",
                            trainer.dev["xm"], b.firm_idx[0], b.time_idx[0],
                            d.window, trainer.fp, trainer.panel.n_months)
        B = x.shape[0] * x.shape[1]
        hin = model.embed(x.reshape(B, d.window, -1), dtype=cd)
        mm = m.reshape(B, d.window)
        del x, m
        wx = model.xproj[0].kernel.detach().to(cd)
        bb = model.xproj[0].bias.detach().to(cd)
        wh = model.h_proj[0].detach().to(cd)
        check_fused_fwd(torch, kernels, "c3 train step", "gru", hin, wx, bb,
                        wh, mm, save_c=False)
        dh = (0.1 * torch.randn(tuple(hin.shape), generator=gen)).to(
            cd).cuda()
        check_fused_bwd(torch, kernels, "gru", hin, wx, bb, wh, mm, dh,
                        where="c3 train step")
        del hin, mm, dh
    torch.cuda.empty_cache()


def c3_phase(torch, kernels, totals: dict, gen) -> dict:
    """Phase 9: c3 (the rank-IC GRU, full cross-section) through
    :func:`model_phase` on its three kernels (its step's shapes by
    :func:`check_c3_step_shapes`), then its rank-IC loss alone. Returns
    what phase 10 is held to: the first steps' losses and grad norms and
    the sweep after them."""
    from lfm_quant_tpu_torch.data.windows import gather_targets

    cfg = c3_config()
    res = model_phase(
        torch, kernels, totals, cfg, c3_splits(cfg), "c3",
        expect=C3_KERNELS, once_a_step=("rnn_fused_bwd_mma_gru",
                                        "window_gather"),
        shapes=lambda tr: check_c3_step_shapes(torch, tr, kernels, gen),
        sweep=True)
    trainer, (fi, ti, w), n = res["trainer"], res["batch"], \
        res["profiled_steps"]
    d = cfg.data
    Bf = trainer.train_sampler.firms_per_date

    # The rank-IC loss alone, forward and backward, on a step's outputs.
    with torch.no_grad():
        x, m = trainer._gather(fi[1], ti[1])
        out = trainer._apply(x, m).float()
        y = gather_targets(trainer.dev["targets"], fi[1], ti[1])
        del x, m
    out.requires_grad_(True)

    def loss_once():
        num, den = trainer.loss_parts(out, y, w[1])
        (num / den).backward()

    loss_ms = time_ms(loss_once, reps=5, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss_once()
    torch.cuda.synchronize()
    loss_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    by_loss = profile_device(torch, lambda: [loss_once() for _ in range(n)],
                             f"c3 rank-IC loss forward and backward, {n} "
                             f"times")
    by_step = res["by_step"]
    step_dev = sum(by_step.values())
    if step_dev and by_loss:
        shares = {
            "rank-IC loss": sum(by_loss.values()),
            "row 3 (rnn_fwd_mma_kernel)": sum(
                v for k, v in by_step.items() if "rnn_fwd_mma" in k),
            "row 4 (rnn_bwd_mma_*)": sum(
                v for k, v in by_step.items() if "rnn_bwd_mma" in k),
            "gather": sum(v for k, v in by_step.items()
                          if "window_gather" in k)}
        log("c3 step device time " + f"{step_dev / n:.3f} ms: " + ", ".join(
            f"{k} {v / n:.3f} ms ({100 * v / step_dev:.1f}%)"
            for k, v in shares.items()))
    log(f"c3 rank-IC loss alone: {loss_ms:.3f} ms forward and backward "
        f"(CUDA events), {loss_peak:.2f} GiB above its inputs; pairwise "
        f"array [{d.dates_per_batch}, {Bf}, {Bf}] f32 = "
        f"{d.dates_per_batch * Bf * Bf * 4 / 2 ** 20:.0f} MiB")
    one = {k: res[k] for k in ("losses", "grad_norms", "eval", "ms_step")}
    del out, y, trainer, res
    torch.cuda.empty_cache()
    return one


def c3_rank_job(n_steps: int, timed_steps: int) -> dict:
    """One rank of phase 10, in its own process: c3 at full width,
    date-sharded over the job's ranks, on card 0 with the kernels phase 2
    built. Its first steps from the seeded init, the month-sharded sweep
    after them, their launches, then the time of ``timed_steps`` more."""
    import torch

    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.loop import Trainer
    from lfm_quant_tpu_torch.utils import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    cfg = c3_config(n_data_shards=D.world_size())
    trainer = Trainer(cfg, c3_splits(cfg), device="cuda:0")
    _build.reset_launch_counts()
    losses, gnorms, state = first_steps(torch, trainer, n_steps)
    ev = trainer.evaluate()
    counts = _build.launch_counts()
    fi, ti, w = trainer._batch(trainer.train_sampler.stacked_epoch(1))
    state, _ = trainer.step(state, fi[0], ti[0], w[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, timed_steps + 1):
        state, _ = trainer.step(state, fi[k], ti[k], w[k])
    torch.cuda.synchronize()
    return {"rank": D.rank(), "n_data": trainer.mesh.n_data,
            "losses": losses, "grad_norms": gnorms, "eval": ev,
            "launches": counts, "built_here": _build.BUILD_INFO["seconds"],
            "ms_step": 1e3 * (time.perf_counter() - t0) / timed_steps,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def two_ranks_phase(torch, one: dict, totals: dict) -> None:
    """Phase 10: c3 on ``CARD_RANKS`` processes that share the one card
    (:func:`run_on_ranks`), ``n_data_shards`` = the ranks. Each rank's
    first steps' losses and grad norms and its month-sharded sweep are
    held to phase 9's one process within the training gate; each rank's
    kernels must have launched."""
    import numpy as np

    t0 = time.perf_counter()
    ranks = run_on_ranks("phase 10, c3", "chip_smoke:c3_rank_job",
                         dict(n_steps=PLAIN_STEPS, timed_steps=TIMED_STEPS))
    wall = time.perf_counter() - t0
    worst = 0.0
    for got in ranks:
        r = got["rank"]
        if got["n_data"] != CARD_RANKS:
            fail(f"rank {r}: n_data {got['n_data']}, not {CARD_RANKS}")
        for k in C3_KERNELS:
            if got["launches"][k] < PLAIN_STEPS:
                fail(f"rank {r}: {k} launched {got['launches'][k]} times "
                     f"in {PLAIN_STEPS} steps")
            totals[k] += got["launches"][k]
        worst = max(worst,
                    losses_agree(f"rank {r} losses", got["losses"],
                                 one["losses"]),
                    losses_agree(f"rank {r} grad norms", got["grad_norms"],
                                 one["grad_norms"]),
                    losses_agree(f"rank {r} sweep (ic, mse)",
                                 [got["eval"]["ic"], got["eval"]["mse"]],
                                 [one["eval"]["ic"], one["eval"]["mse"]]))
        if got["eval"]["n_months"] != one["eval"]["n_months"]:
            fail(f"rank {r}: sweep over {got['eval']['n_months']} months")
    if not np.array_equal(ranks[0]["losses"], ranks[1]["losses"]):
        fail(f"the ranks' losses differ: {[g['losses'] for g in ranks]}")
    log(f"c3 on {CARD_RANKS} ranks sharing the card (gloo): job {wall:.1f} s; "
        f"losses, grad norms and the sweep within {worst:.4g} of one "
        f"process (tol {BF16_TOL} + {BF16_TOL}|one|); "
        + "; ".join(f"rank {g['rank']}: {g['ms_step']:.3f} ms/step, peak "
                    f"{g['peak_gib']:.2f} GiB, launches "
                    f"{ {k: g['launches'][k] for k in C3_KERNELS} }"
                    for g in ranks)
        + f"; one process {one['ms_step']:.3f} ms/step")


# ---------------------------------------------------------------------------
# Phases 11-14: the other model families (the MLP, transformer and LRU)
# ---------------------------------------------------------------------------

LRU64_BLOCK = 8       # lru64's seed_block: one block's activations
MC_SAMPLES = 4        # phase 14's MC-dropout samples
MC_DROPOUT = 0.1      # phase 14's c4 variant
# The profile of a model's step by op group: LayerNorm's forward and
# backward first (:data:`LN_RANGE`); every other profiled aten op's own
# device time goes to the first group that names it; the gather is read
# from its kernel, the optimizer from its own profile.
LN_GROUP = "LayerNorm (forward and backward)"
LN_RANGE = "chip_smoke::LayerNorm"
OP_GROUPS = (
    ("attention mask/softmax", ("masked_fill", "_softmax", "softmax",
                                "where")),
    ("GEMMs", ("mm", "bmm", "addmm", "baddbmm", "addbmm")),
    ("GELU", ("gelu",)),
    ("reductions (pooling, loss)", ("mean", "sum")),
)


def panel_of(cfg, cache: dict):
    """The config's panel, built once per distinct data config."""
    from lfm_quant_tpu_torch.train.loop import resolve_panel

    d = cfg.data
    key = (d.n_firms, d.n_months, d.n_features, d.start_yyyymm, d.horizon,
           d.panel_seed, d.het_noise, d.panel_path)
    if key not in cache:
        t0 = time.perf_counter()
        cache[key] = resolve_panel(d)
        log(f"{cfg.name}: panel {cache[key].features.shape} built in "
            f"{time.perf_counter() - t0:.1f} s")
    return cache[key]


def splits_of(cfg, cache: dict):
    from lfm_quant_tpu_torch.data.panel import PanelSplits
    from lfm_quant_tpu_torch.train.loop import default_split_dates

    panel = panel_of(cfg, cache)
    return PanelSplits.by_date(panel, *default_split_dates(panel, cfg.data),
                               train_start=cfg.data.train_start)


def one_epoch(cfg, **changes):
    """``cfg`` cut to one epoch (its preset's 20 or 30 are not run)."""
    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, epochs=1), **changes)


def not_gather():
    from lfm_quant_tpu_torch.ops import _build

    return tuple(k for k in _build.LAUNCHES if k != "window_gather")


def layernorm_ranges(torch, model) -> list:
    """Put each LayerNorm module's forward in a profiler range named
    :data:`LN_RANGE` (a forward pre-hook opens it, a forward hook closes
    it) → the hooks' handles, to remove."""
    from lfm_quant_tpu_torch.models.heads import LayerNorm

    def enter(mod, args):
        mod._chip_smoke_range = torch.profiler.record_function(LN_RANGE)
        mod._chip_smoke_range.__enter__()

    def leave(mod, args, out):
        mod._chip_smoke_range.__exit__(None, None, None)
        del mod._chip_smoke_range

    handles = []
    for mod in model.modules():
        if isinstance(mod, LayerNorm):
            handles += [mod.register_forward_pre_hook(enter),
                        mod.register_forward_hook(leave)]
    return handles


def layernorm_events(events) -> set:
    """The ids of a trace's LayerNorm events: the forward's (inside a
    :data:`LN_RANGE`) and the backward's (the autograd nodes those ops
    made, matched by sequence number, and what the nodes call)."""
    def under(e, pred):
        while e is not None:
            if pred(e):
                return True
            e = e.cpu_parent
        return False

    fwd = [e for e in events if under(e, lambda a: a.name == LN_RANGE)]
    seqs = {e.sequence_nr for e in fwd
            if getattr(e, "sequence_nr", -1) >= 0}
    bwd = [e for e in events if under(e, lambda a: a.name.startswith(
        "autograd::engine::evaluate_function") and getattr(
            a, "sequence_nr", -1) in seqs)]
    return {id(e) for e in fwd + bwd}


def profile_groups(torch, trainer, state, fi, ti, w, n: int,
                   label: str) -> dict:
    """Device time of ``n`` train steps by op group (LayerNorm, then
    :data:`OP_GROUPS`, the gather, the optimizer, the rest), from two
    ``torch.profiler`` traces: the forward and backward
    (``Trainer._grads``, LayerNorm's forwards in ranges), then the
    optimizer updates on the gradients they gave. Informational."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA

    def own_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        return us / 1e3

    def kernel(e):
        return getattr(e, "device_type", None) == cuda and not (
            getattr(e, "is_user_annotation", False) or e.name == LN_RANGE)

    def traced(fn):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return prof.events()

    trainer.model.train()
    grads = []
    handles = layernorm_ranges(torch, trainer.model)
    try:
        ev = traced(lambda: grads.extend(
            trainer._grads(state, fi[k], ti[k], w[k])[1] for k in range(n)))
    finally:
        for h in handles:
            h.remove()
    opt = traced(lambda: [trainer.opt.step(state.params, g, state.opt_state)
                          for g in grads])
    total = sum(own_ms(e) for e in ev if kernel(e))
    opt_ms = sum(own_ms(e) for e in opt if kernel(e))
    if not total:
        log(f"profile {label}: no device time in the trace (not measured)")
        return {}
    ln = layernorm_events(ev)
    groups = dict.fromkeys([LN_GROUP] + [g for g, _ in OP_GROUPS], 0.0)
    for e in ev:
        if getattr(e, "device_type", None) == cuda or \
                not e.name.startswith("aten::"):
            continue
        if id(e) in ln:
            groups[LN_GROUP] += own_ms(e)
            continue
        op = e.name[len("aten::"):]
        for g, names in OP_GROUPS:
            if op.split("_backward")[0].rstrip("_") in names or \
                    op in names:
                groups[g] += own_ms(e)
                break
    groups["the gather"] = sum(own_ms(e) for e in ev
                               if kernel(e) and "window_gather" in e.name)
    groups["other (residuals, casts, layouts, scan, dropout, "
           "kernels)"] = total - sum(groups.values())
    groups["optimizer"] = opt_ms
    step = (total + opt_ms) / n
    log(f"profile {label}: device time {step:.3f} ms per step: " + ", ".join(
        f"{g} {v / n:.3f} ms ({100 * v / (step * n):.1f}%)"
        for g, v in groups.items()))
    return {g: v / n for g, v in groups.items()}


def model_phase(torch, kernels: dict, totals: dict, cfg, splits,
                label: str, expect=("window_gather",), once_a_step=None,
                shapes=None, sweep: bool = False, epoch: bool = True
                ) -> dict:
    """One model on its kernels at full width: the kernels at the train
    step's shapes against their plain versions (``shapes(trainer)``;
    default the gather alone); the first :data:`PLAIN_STEPS` steps from
    the seeded init, counted, against the plain path on the card (the
    training gate, finite), then (``sweep``) the validation sweep after
    them; one step launching each kernel of ``expect`` exactly once and
    nothing else; ms per step, firm-months/s and peak memory of steady
    steps, the device's busy share and the step's profile by op group;
    then (``epoch``) one epoch with its validation sweep, counted, with
    each kernel of ``once_a_step`` (default ``expect``) launched once a
    step.
    Returns the numbers, the trainer, a batch of epoch 1 and the step's
    device ms by kernel."""
    import numpy as np

    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.loop import Trainer

    others = tuple(k for k in _build.LAUNCHES if k not in expect)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, splits, device="cuda")
    if trainer.mesh.n_data != 1:
        fail(f"{label} in one process: n_data {trainer.mesh.n_data}, not 1")
    d = cfg.data
    Bf = trainer.train_sampler.firms_per_date
    K = trainer._steps_per_epoch
    log(f"{label}: trainer in {time.perf_counter() - t0:.1f} s; "
        f"n_data_shards {cfg.n_data_shards}, n_seq_shards "
        f"{cfg.n_seq_shards} resolve to 1 in one process; {K} steps of "
        f"{d.dates_per_batch} x {Bf} = {d.dates_per_batch * Bf} windows "
        f"of {d.window} months (firms_per_date {d.firms_per_date}; 0 is "
        f"the widest pool)")
    if shapes is not None:
        shapes(trainer)
    else:
        b = trainer.train_sampler.stacked_epoch(0)
        with torch.inference_mode():
            check_gather(torch, kernels, f"{label} train step",
                         trainer.dev["xm"], b.firm_idx[0], b.time_idx[0],
                         d.window, trainer.fp, trainer.panel.n_months)
    torch.cuda.empty_cache()

    # The first steps on the kernels against the plain path on the card,
    # counted (lc's main path is these steps: it runs no epoch).
    (losses, gnorms, state), counts = counted(
        f"{label}'s first {PLAIN_STEPS} steps", expect,
        lambda: first_steps(torch, trainer, PLAIN_STEPS), must_not=others)
    for k, v in counts.items():
        totals[k] += v
    ev = trainer.evaluate() if sweep else None
    plain = Trainer(plain_variant(cfg), splits, device="cuda")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    want, want_gn, _ = first_steps(torch, plain, PLAIN_STEPS)
    plain_s = time.perf_counter() - t0
    if any(_build.launch_counts().values()):
        fail(f"the plain {label} path launched kernels: "
             f"{_build.launch_counts()}")
    err = losses_agree(f"{label} kernels vs plain", losses, want)
    log(f"{label}: {PLAIN_STEPS} steps agree with the plain path "
        f"({plain_s:.1f} s) within {err:.4g}: losses {losses} / {want}, "
        f"grad norms {gnorms} / {want_gn}" + (
            f"; sweep after them ic {ev['ic']:.6f} mse {ev['mse']:.6f}"
            if sweep else ""))
    del plain
    torch.cuda.empty_cache()

    # One step: each kernel of the path once, nothing else.
    fi, ti, w = trainer._batch(trainer.train_sampler.stacked_epoch(1))
    _build.reset_launch_counts()
    state, _ = trainer.step(state, fi[0], ti[0], w[0])
    counts = _build.launch_counts()
    if any(counts[k] != 1 for k in expect) or \
            sum(counts.values()) != len(expect):
        fail(f"one {label} step launched {counts}: not {list(expect)} "
             "once each")
    log(f"launches in one {label} step: "
        f"{ {k: n for k, n in counts.items() if n} }")

    # Steady state: ms per step, memory, the device's view.
    n = min(TIMED_STEPS, K - 1)

    def steps():
        st = state
        for k in range(1, n + 1):
            st, _ = trainer.step(st, fi[k], ti[k], w[k])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / n
    fm = float(w[1:n + 1].sum()) * d.window / n
    log(f"train {label} steady state: {1e3 * per_step:.3f} ms/step, "
        f"{1 / per_step:.2f} steps/s, {fm / per_step:.1f} firm-months/s ({n} "
        f"steps, host clock around synchronized work); peak memory "
        f"{peak:.2f} GiB")
    p = min(PROFILE_STEPS, n)

    def profiled():
        st = state
        for k in range(1, p + 1):
            st, _ = trainer.step(st, fi[k], ti[k], w[k])

    by_step = profile_device(torch, profiled, f"{label} train, {p} step(s)")
    profile_groups(torch, trainer, state, fi[1:], ti[1:], w[1:], p, label)
    out = {"trainer": trainer, "losses": losses, "grad_norms": gnorms,
           "eval": ev, "ms_step": 1e3 * per_step, "peak_gib": peak,
           "batch": (fi, ti, w), "timed_steps": n, "profiled_steps": p,
           "by_step": by_step}
    del state
    torch.cuda.empty_cache()
    if not epoch:
        return out

    # One epoch with its validation sweep: the main path, counted.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary, counts = counted(f"{label} training", expect, trainer.fit,
                              must_not=others)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(counts[k] != K for k in (once_a_step or expect)):
        fail(f"{label} epoch of {K} steps: launches {counts}")
    for k, v in counts.items():
        totals[k] += v
    rec = summary["history"][0]
    if not all(np.isfinite(rec[k]) for k in ("train_loss", "grad_norm",
                                             "val_ic", "val_mse")):
        fail(f"{label} epoch: {rec}")
    log(f"train {label} (kernels): {K} steps + val sweep in {wall:.3f} s; "
        f"train_loss {rec['train_loss']:.6f} grad_norm "
        f"{rec['grad_norm']:.6f} val_ic {rec['val_ic']:.6f} val_mse "
        f"{rec['val_mse']:.6f}; {summary['firm_months_per_sec']:.1f} "
        f"firm-months/s over the epoch; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return out


def lru64_phase(torch, kernels: dict, totals: dict, cfg, splits) -> dict:
    """lru64 (64 LRU seeds at c5's geometry, ``seed_block``
    :data:`LRU64_BLOCK`): its first steps' per-seed losses against the
    plain path on the card, the block's seeds equal to an unblocked
    ensemble of as many seeds (the same members), one step's gather
    launch, ms per step and the peak memory."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer

    cfg = one_epoch(cfg, seed_block=LRU64_BLOCK)
    trainer = EnsembleTrainer(cfg, splits, device="cuda")
    (fi, ti, w), _ = trainer._build_epoch(0)
    with torch.inference_mode():
        check_gather(torch, kernels, "lru64 train step (64 seeds folded)",
                     trainer.dev["xm"], fi[0].cpu().numpy().reshape(
                         -1, fi.shape[-1]),
                     ti[0].cpu().numpy().reshape(-1), cfg.data.window,
                     trainer.fp, trainer.panel.n_months,
                     row="window_gather_seeds")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    got = ensemble_steps(torch, cfg, splits, PLAIN_STEPS)
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if counts["window_gather"] != PLAIN_STEPS * cfg.n_seeds // \
            LRU64_BLOCK or sum(counts.values()) != counts["window_gather"]:
        fail(f"lru64's {PLAIN_STEPS} steps launched {counts}: not the "
             "gather once a block")
    for k, v in counts.items():
        totals[k] += v
    want = ensemble_steps(torch, plain_variant(cfg), splits, PLAIN_STEPS)
    err = losses_agree("lru64 kernel vs plain", got, want)
    # The block is a pure re-batching: seeds [0, block) of the blocked run
    # are the members of an unblocked ensemble of that many seeds.
    alone = ensemble_steps(torch, dataclasses.replace(
        cfg, n_seeds=LRU64_BLOCK, seed_block=0), splits, PLAIN_STEPS)
    import numpy as np

    block = np.asarray(got)[:, :LRU64_BLOCK]
    diff = np.abs(block - np.asarray(alone))
    if (diff > 1e-6 * np.abs(block)).any():
        fail(f"lru64 seed_block {LRU64_BLOCK}: the block's losses differ "
             f"from the unblocked run's by {diff.max()}")
    log(f"lru64: {PLAIN_STEPS} steps x 64 seeds (seed_block "
        f"{LRU64_BLOCK}) agree with the plain path within {err:.4g}; the "
        f"first block's losses against an unblocked {LRU64_BLOCK}-seed "
        f"ensemble of the same members: first step bitwise "
        f"{bool((diff[0] == 0).all())}, max diff {diff.max():.3g} (rtol "
        f"1e-6); first step's losses {min(got[0]):.5f} .. "
        f"{max(got[0]):.5f}; peak memory {peak:.2f} GiB")
    torch.cuda.empty_cache()

    state = trainer.init_state()
    n = TIMED_STEPS

    def steps():
        st = state
        for k in range(1, n + 1):
            st, _ = trainer.step(st, fi[k], ti[k], w[k])

    steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / n
    S = cfg.n_seeds
    fm = float(w[1:n + 1].sum()) * cfg.data.window / n
    log(f"train lru64 steady state: {1e3 * per_step:.3f} ms/step, "
        f"{S / per_step:.1f} seed-steps/s, {fm / per_step:.1f} "
        f"firm-months/s ({n} steps of {S} seeds in blocks of {LRU64_BLOCK}); "
        f"peak memory {peak:.2f} GiB")
    profile_device(torch, lambda: trainer.step(state, fi[1], ti[1], w[1]),
                   "lru64 train, 1 step")
    del state, trainer
    torch.cuda.empty_cache()
    return {"ms_step": 1e3 * per_step, "peak_gib": peak}


def lc_scores_shape(torch, trainer) -> list:
    """The shape of the first block's attention scores on a train batch:
    its input ``[rows, W, dim]`` through a forward hook."""
    seen = []
    attn = trainer.model.blocks[0].attn
    hook = attn.register_forward_hook(
        lambda mod, args, out: seen.append(
            [args[0].shape[0], mod.heads, args[0].shape[-2],
             args[0].shape[-2]]))
    try:
        b = trainer.train_sampler.stacked_epoch(0)
        fi, ti, _ = trainer._batch(b)
        with torch.no_grad():
            trainer._apply(*trainer._gather(fi[0], ti[0]))
    finally:
        hook.remove()
    return seen[0]


def mc_dropout_phase(torch, cfg, splits, totals: dict,
                     no_dropout_losses) -> None:
    """Phase 14: the c4 variant with dropout trains 3 steps twice from the
    same seed (bitwise the same losses, which differ from dropout 0's);
    ``predict(mc_samples=4)`` on its test split: one gather launch per
    month chunk shared by the samples, samples that differ, a bitwise
    replay by ``mc_seed``, another seed's other draws, and the plain
    predict's validity."""
    import numpy as np

    from lfm_quant_tpu_torch.train.loop import Trainer

    kw = dict(cfg.model.kwargs, dropout=MC_DROPOUT)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             kwargs=kw))
    trainer = Trainer(cfg, splits, device="cuda")
    a, _, state = first_steps(torch, trainer, PLAIN_STEPS)
    b, _, _ = first_steps(torch, Trainer(cfg, splits, device="cuda"),
                       PLAIN_STEPS)
    if a != b or not np.isfinite(a).all():
        fail(f"c4 with dropout: the same seed gave losses {a} and {b}")
    if a == list(no_dropout_losses):
        fail("c4 with dropout: the losses equal dropout 0's")
    log(f"c4 dropout {MC_DROPOUT}: {PLAIN_STEPS} steps replay bitwise "
        f"from the seed: {a} (dropout 0: {list(no_dropout_losses)})")
    trainer.state = state
    t0 = time.perf_counter()
    (stacked, valid), counts = counted(
        "c4 MC-dropout predict", ("window_gather",),
        lambda: trainer.predict("test", mc_samples=MC_SAMPLES, mc_seed=0),
        must_not=not_gather())
    mc_s = time.perf_counter() - t0
    for k, v in counts.items():
        totals[k] += v
    from lfm_quant_tpu_torch.train.loop import predict_batch

    M = predict_batch(cfg, splits, "test", None, True).firm_idx.shape[0]
    chunks = -(-M // min(cfg.data.dates_per_batch, M))
    if counts["window_gather"] != chunks:
        fail(f"MC predict: {counts['window_gather']} gather launches for "
             f"{chunks} month chunks (once per chunk, shared by the "
             f"{MC_SAMPLES} samples)")
    again, _ = trainer.predict("test", mc_samples=MC_SAMPLES, mc_seed=0)
    other, _ = trainer.predict("test", mc_samples=MC_SAMPLES, mc_seed=1)
    plain, plain_valid = trainer.predict("test")
    n, t = splits.panel.n_firms, splits.panel.n_months
    if stacked.shape != (MC_SAMPLES, n, t) or not np.isfinite(stacked).all():
        fail(f"MC predict: shape {stacked.shape}, finite "
             f"{np.isfinite(stacked).all()}")
    if not np.array_equal(stacked, again):
        fail("MC predict: the same mc_seed did not replay bitwise")
    if np.array_equal(stacked, other):
        fail("MC predict: another mc_seed drew the same samples")
    if not np.array_equal(valid, plain_valid) or not valid.any():
        fail("MC predict: validity differs from the plain predict's")
    spread = float(stacked.std(axis=0)[valid].mean())
    if not spread > 0:
        fail("MC predict: the samples do not differ")
    log(f"c4 MC-dropout predict: {MC_SAMPLES} samples of the test split "
        f"({M} months, {int(valid.sum())} cells) in {mc_s:.3f} s, "
        f"{chunks} gather launches; mean per-cell sample std {spread:.5f} "
        f"(forecast std {float(plain[valid].std()):.5f}); replayed "
        f"bitwise by mc_seed; validity equals the plain predict's")


def new_models_phases(torch, kernels: dict, totals: dict, cache: dict
                      ) -> dict:
    """Phases 11-14: c4, lru and lru64, c1 and lc, MC-dropout. Returns
    what phase 15 is held to: lru's and lc's first steps' losses and grad
    norms, ms per step and peak memory in one process."""
    from lfm_quant_tpu_torch.config import get_preset

    # ---- 11. c4 at full width -------------------------------------------
    c4 = one_epoch(get_preset("c4"))
    splits4 = splits_of(c4, cache)
    res4 = model_phase(torch, kernels, totals, c4, splits4, "c4")
    del res4["trainer"]
    torch.cuda.empty_cache()

    # ---- 12. lru (c2 geometry) and lru64 (c5 geometry) -------------------
    lru = one_epoch(get_preset("lru"))
    res_lru = model_phase(torch, kernels, totals, lru, splits_of(lru, cache),
                          "lru")
    keep = ("losses", "grad_norms", "ms_step", "peak_gib")
    one = {"lru": {k: res_lru[k] for k in keep}}
    del res_lru
    torch.cuda.empty_cache()
    lru64 = get_preset("lru64")
    lru64_phase(torch, kernels, totals, lru64, splits_of(lru64, cache))

    # ---- 13. c1 (the MLP) and lc (window 240) ------------------------------
    c1 = one_epoch(get_preset("c1"))
    model_phase(torch, kernels, totals, c1, splits_of(c1, cache), "c1")
    lc = one_epoch(get_preset("lc"))
    res_lc = model_phase(torch, kernels, totals, lc, splits_of(lc, cache),
                         "lc", epoch=False)
    shape = lc_scores_shape(torch, res_lc["trainer"])
    want = [lc.data.dates_per_batch * lc.data.firms_per_date,
            lc.model.kwargs["heads"], lc.data.window, lc.data.window]
    if shape != want:
        fail(f"lc attention scores {shape}, not {want}")
    log(f"lc: attention scores {shape} per block and step")
    one["lc"] = {k: res_lc[k] for k in keep}
    del res_lc
    torch.cuda.empty_cache()

    # ---- 14. MC-dropout ---------------------------------------------------
    mc_dropout_phase(torch, c4, splits4, totals, res4["losses"])
    torch.cuda.empty_cache()
    return one


# ---------------------------------------------------------------------------
# Phases 15-17: the seq and seed axes over ranks, the factorized recurrences
# ---------------------------------------------------------------------------

RING_TOL = 1e-5      # ring attention against full attention in f32 (atol
                     # and rtol: tests/test_ring.py's bound)
# Phase 17: c2's geometry with each factorization.
FACTORED = (("lstm", {"factor_rank": 32}), ("gru", {"n_groups": 4}))


def seq_config(preset: str):
    """``preset`` cut to one epoch, its window split over
    :data:`CARD_RANKS` ranks."""
    from lfm_quant_tpu_torch.config import get_preset

    return one_epoch(get_preset(preset), n_seq_shards=CARD_RANKS)


def full_attention(torch, q, k, v, m):
    """Dense masked attention in f32 (the reference of
    ``tests/test_ring.py``): rows with no valid key give 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~m[:, None, None, :], -1e30)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
    return torch.where(m.any(dim=-1)[:, None, None, None], o,
                       torch.zeros_like(o))


def ring_check(torch, trainer, fi, ti) -> dict:
    """On this seq rank, at the lc step's shapes (the first batch, the
    seeded params): layer 0's q, k and v of the FULL window, full
    attention over them in f32, and ``ring_attention`` of this rank's
    blocks (f32 operands: the bf16 values) against its rows; then the
    ring in bf16 as the step runs it, one hop of its packed K/V and the
    hop's host staging alone, timed (every rank runs the same calls: the
    hops pair up)."""
    from lfm_quant_tpu_torch.parallel import ring

    mesh, model = trainer.mesh, trainer.model
    cd = model.dtype
    attn = model.blocks[0].attn
    with torch.inference_mode():
        x, m = trainer._gather(fi, ti)
        W = x.shape[-2]
        x, m = x.reshape(-1, W, x.shape[-1]), m.reshape(-1, W)
        z = model.embed(x.to(cd), dtype=cd) + model.pos_emb.to(cd)
        y = model.blocks[0].ln1(z)
        q, k, v = (p(y, dtype=cd).transpose(-3, -2)
                   for p in (attn.query, attn.key, attn.value))
        del x, z, y
        want = ring.window_block(full_attention(
            torch, q.float(), k.float(), v.float(), m), mesh)
        qb, kb, vb = (ring.window_block(t, mesh) for t in (q, k, v))
        mb = ring.window_block(m, mesh, axis=-1)
        got = ring.ring_attention(qb.float(), kb.float(), vb.float(), mb,
                                  mesh)
        torch.cuda.synchronize()
        err = (got - want).abs()
        excess = float((err - RING_TOL - RING_TOL * want.abs()).max())
        out = {"max_abs_err": float(err.max()), "excess": excess,
               "shape": list(qb.shape)}
        del got, want, q, k, v
        torch.cuda.empty_cache()
        out["ring_ms"] = time_ms(lambda: ring.ring_attention(qb, kb, vb, mb,
                                                             mesh), reps=5)
        packed = torch.cat([kb.reshape(-1), vb.reshape(-1),
                            mb.to(kb.dtype).reshape(-1)])
        out["hop_bytes"] = packed.numel() * packed.element_size()
        out["hop_ms"] = time_ms(lambda: ring._shift(packed, mesh, 1), reps=5)
        out["staging_ms"] = time_ms(
            lambda: packed.to("cpu").to(packed.device), reps=5)
    return out


def seq_rank_job(preset: str, n_steps: int, timed_steps: int) -> dict:
    """One rank of phase 15, in its own process: ``preset`` at full width
    with its window split over the job's ranks, on card 0 with the
    kernels phase 2 built. The gather at this rank's sub-window, the ring
    against full attention (lc), the first steps from the seeded init and
    their launches, then the time of ``timed_steps`` more and the peak
    memory."""
    import torch

    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.loop import Trainer, sub_window
    from lfm_quant_tpu_torch.utils import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    cfg = seq_config(preset)
    trainer = Trainer(cfg, splits_of(cfg, {}), device="cuda:0")
    mesh = trainer.mesh
    out = {"rank": D.rank(), "n_seq": mesh.n_seq,
           "built_here": _build.BUILD_INFO["seconds"]}
    wl, shift = sub_window(cfg.data.window, mesh)
    fi, ti, w = trainer._batch(trainer.train_sampler.stacked_epoch(0))
    with torch.inference_mode():
        x, _ = trainer._gather(fi[0], ti[0] - shift, window=wl)
    out["sub_window"], out["shift"] = list(x.shape), shift
    del x
    if cfg.model.kind == "transformer":
        out["ring"] = ring_check(torch, trainer, fi[0], ti[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out["losses"], out["grad_norms"], state = first_steps(torch, trainer,
                                                          n_steps)
    out["launches"] = _build.launch_counts()
    fi, ti, w = trainer._batch(trainer.train_sampler.stacked_epoch(1))
    state, _ = trainer.step(state, fi[0], ti[0], w[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, timed_steps + 1):
        state, _ = trainer.step(state, fi[k], ti[k], w[k])
    torch.cuda.synchronize()
    out["ms_step"] = 1e3 * (time.perf_counter() - t0) / timed_steps
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def run_on_ranks(label: str, target: str, payload: dict) -> list:
    """``target`` on :data:`CARD_RANKS` processes sharing the card (gloo:
    NCCL refuses two ranks on one device; a ``file://`` rendezvous in a
    temporary directory), each loading phase 2's build; a rank that
    fails, outlives the limit or rebuilt the kernels fails the phase:
    there is no fallback to one process."""
    import shutil
    import tempfile

    from lfm_quant_tpu_torch.parallel.launch import run_ranks

    tmp = tempfile.mkdtemp(prefix="lfm_ranks_")
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(CARD_RANKS, target, payload, tmp,
                          RANKS_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"{label}, {CARD_RANKS} ranks on one card: {e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"{label}: {CARD_RANKS} ranks on the card, job "
        f"{time.perf_counter() - t0:.1f} s")
    for got in ranks:
        if got["built_here"] is not None:
            fail(f"{label} rank {got['rank']} rebuilt the kernels "
                 f"({got['built_here']} s)")
    return ranks


def seq_ranks_phase(torch, kernels: dict, totals: dict, one: dict,
                    cache: dict) -> None:
    """Phase 15: lc (window 240) and lru (window 60) with the window split
    over :data:`CARD_RANKS` processes sharing the card. The gather at each
    rank's sub-window against its plain version; on each rank: the ring
    against full attention in f32 (lc), the first steps' losses and grad
    norms within the training gate of phases 13 and 12's one process,
    the gather launched once a step at the sub-window and nothing else,
    ms per step and peak memory; the hop's and its staging's share."""
    import numpy as np

    from lfm_quant_tpu_torch.parallel.mesh import DataMesh
    from lfm_quant_tpu_torch.train.loop import Trainer, sub_window

    for preset in ("lc", "lru"):
        cfg = seq_config(preset)
        d = cfg.data
        splits = splits_of(cfg, cache)
        tr = Trainer(dataclasses.replace(cfg, n_seq_shards=1), splits,
                     device="cuda")
        b = tr.train_sampler.stacked_epoch(0)
        with torch.inference_mode():
            for r in range(CARD_RANKS):
                wl, shift = sub_window(d.window, DataMesh(
                    n_seq=CARD_RANKS, seq_rank=r))
                check_gather(torch, kernels, f"{preset} seq rank {r} "
                             f"sub-window", tr.dev["xm"], b.firm_idx[0],
                             b.time_idx[0] - shift, wl, tr.fp,
                             tr.panel.n_months)
        del tr
        torch.cuda.empty_cache()
        ranks = run_on_ranks(
            f"phase 15, {preset}", "chip_smoke:seq_rank_job",
            dict(preset=preset, n_steps=PLAIN_STEPS,
                 timed_steps=TIMED_STEPS))
        ref = one[preset]
        worst = 0.0
        for got in ranks:
            r = got["rank"]
            wl = d.window // CARD_RANKS
            if got["n_seq"] != CARD_RANKS or got["sub_window"][-2] != wl:
                fail(f"{preset} rank {r}: n_seq {got['n_seq']}, sub-window "
                     f"{got['sub_window']}")
            counts = got["launches"]
            if counts["window_gather"] != PLAIN_STEPS or \
                    sum(counts.values()) != PLAIN_STEPS:
                fail(f"{preset} rank {r}: {PLAIN_STEPS} steps launched "
                     f"{counts}, not the gather once a step")
            totals["window_gather"] += counts["window_gather"]
            worst = max(worst,
                        losses_agree(f"{preset} rank {r} losses",
                                     got["losses"], ref["losses"]),
                        losses_agree(f"{preset} rank {r} grad norms",
                                     got["grad_norms"], ref["grad_norms"]))
            if "ring" in got and got["ring"]["excess"] > 0:
                fail(f"{preset} rank {r}: ring attention differs from full "
                     f"attention by {got['ring']['max_abs_err']}")
        if not np.array_equal(ranks[0]["losses"], ranks[1]["losses"]):
            fail(f"{preset}: the seq ranks' losses differ: "
                 f"{[g['losses'] for g in ranks]}")
        log(f"{preset} on {CARD_RANKS} seq ranks (window {d.window}, "
            f"{d.window // CARD_RANKS} per rank): losses and grad norms "
            f"within {worst:.4g} of one process (tol {BF16_TOL} + "
            f"{BF16_TOL}|one|): " + "; ".join(
                f"rank {g['rank']}: {g['ms_step']:.3f} ms/step, peak "
                f"{g['peak_gib']:.2f} GiB, sub-window {g['sub_window']} "
                f"(shift {g['shift']})" for g in ranks)
            + f"; one process {ref['ms_step']:.3f} ms/step, peak "
            f"{ref['peak_gib']:.2f} GiB")
        for g in ranks:
            if "ring" not in g:
                continue
            rg = g["ring"]
            depth = cfg.model.kwargs["depth"]
            # A step's hops: n_seq - 1 per layer forward, as many backward.
            hops = 2 * depth * (CARD_RANKS - 1)
            log(f"lc rank {g['rank']} ring: q/k/v blocks {rg['shape']} "
                f"against full attention in f32, max abs err "
                f"{rg['max_abs_err']:.3g} (tol {RING_TOL} + {RING_TOL}"
                f"|full|); ring attention (bf16) {rg['ring_ms']:.3f} ms; one "
                f"hop of {rg['hop_bytes'] / 2 ** 20:.1f} MiB "
                f"{rg['hop_ms']:.3f} ms, of which the host staging alone "
                f"{rg['staging_ms']:.3f} ms; {hops} hops a step = "
                f"{100 * hops * rg['hop_ms'] / g['ms_step']:.1f}% of the "
                f"step ({100 * hops * rg['staging_ms'] / g['ms_step']:.1f}% "
                f"staging)")


def c5_rank_job(n_steps: int, timed_steps: int, span) -> dict:
    """One rank of phase 16, in its own process: c5 at full width with its
    64 members split over the job's ranks, on card 0 with the kernels
    phase 2 built. The first steps from the seeded init and their
    launches, the gathered forecasts of ``span`` after them (at the valid
    cells) and their launches, then the time of ``timed_steps`` more and
    the peak memory."""
    import torch

    from lfm_quant_tpu_torch.config import get_preset
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
    from lfm_quant_tpu_torch.utils import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    cfg = one_epoch(get_preset("c5"))
    trainer = EnsembleTrainer(cfg, splits_of(cfg, {}), device="cuda:0")
    out = {"rank": D.rank(), "seeds": list(trainer.seeds),
           "built_here": _build.BUILD_INFO["seconds"]}
    state = trainer.init_state()
    (fi, ti, w), _ = trainer._build_epoch(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses = []
    for k in range(n_steps):
        state, ms = trainer.step(state, fi[k], ti[k], w[k])
        losses.append(ms["loss"])
    out["losses"] = torch.stack(losses).cpu().tolist()
    out["launches"] = _build.launch_counts()
    trainer.state = state
    _build.reset_launch_counts()
    fc, valid = trainer.predict(date_range=tuple(span))
    out["predict"] = (fc[:, valid], valid)
    out["predict_launches"] = _build.launch_counts()
    for k in range(n_steps, n_steps + timed_steps + 1):
        if k == n_steps + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, _ = trainer.step(state, fi[k], ti[k], w[k])
    torch.cuda.synchronize()
    out["ms_step"] = 1e3 * (time.perf_counter() - t0) / timed_steps
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def seed_ranks_phase(torch, kernels: dict, totals: dict, seed_launches: dict,
                     one: dict, cache: dict) -> None:
    """Phase 16: c5 with its 64 members split over :data:`CARD_RANKS`
    processes sharing the card (32 a rank). The seed-grid launches at the
    32-seed block (the rank's first stacked batch: rows 3 and 4 and the
    seed-folded gather, against one-seed launches and the plain version);
    on each rank: its members' first steps' per-seed losses against phase
    6's one process, rows 3 and 4 and the seed-folded gather launched
    once a step, the gathered forecasts against the one process, ms per
    step and peak memory."""
    import numpy as np

    from lfm_quant_tpu_torch.config import get_preset
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer

    cfg = one_epoch(get_preset("c5"))
    S = cfg.n_seeds
    per = S // CARD_RANKS
    # The 32-seed block alone is rank 0's members: the same seeded init,
    # the same sampler orders.
    block = EnsembleTrainer(dataclasses.replace(cfg, n_seeds=per),
                            splits_of(cfg, cache), device="cuda")
    check_seed_batched(torch, block, kernels,
                       where=f"c5 seed block (S {per}, rank 0 of "
                             f"{CARD_RANKS})", check=(0, per // 2, per - 1))
    del block
    torch.cuda.empty_cache()
    ranks = run_on_ranks("phase 16, c5", "chip_smoke:c5_rank_job",
                         dict(n_steps=C5_PLAIN_STEPS,
                              timed_steps=TIMED_STEPS, span=one["range"]))
    want = np.asarray(one["losses"])
    fc1, valid1 = one["predict"]
    worst = 0.0
    for got in ranks:
        r = got["rank"]
        if got["seeds"] != list(range(r * per, (r + 1) * per)):
            fail(f"c5 rank {r}: members {got['seeds']}")
        counts = got["launches"]
        for k in ("window_gather", "rnn_fused_fwd_mma_lstm",
                  "rnn_fused_bwd_mma_lstm"):
            if counts[k] != C5_PLAIN_STEPS:
                fail(f"c5 rank {r}: {k} launched {counts[k]} times in "
                     f"{C5_PLAIN_STEPS} steps, not once a step")
        if any(counts[k] for k in CUDA_CORE):
            fail(f"c5 rank {r} launched a CUDA-core kernel: {counts}")
        pc = got["predict_launches"]
        if not (pc["window_gather"] and pc["rnn_fused_fwd_mma_lstm"]):
            fail(f"c5 rank {r}: predict launched {pc}")
        for c in (counts, pc):
            for k, v in c.items():
                seed_launches[k] += v
        worst = max(worst, losses_agree(
            f"c5 rank {r} per-seed losses", got["losses"],
            want[:, r * per:(r + 1) * per]))
        fc, valid = got["predict"]
        if not np.array_equal(valid, valid1) or fc.shape != fc1.shape:
            fail(f"c5 rank {r}: forecasts of {fc.shape} / validity differ")
        worst = max(worst, losses_agree(f"c5 rank {r} forecasts", fc, fc1))
    log(f"c5 on {CARD_RANKS} seed ranks ({per} members each): per-seed "
        f"losses of {C5_PLAIN_STEPS} steps and the gathered forecasts of "
        f"{C5_PREDICT_MONTHS} test months ({fc1.shape[1]} cells x {S} "
        f"seeds) within {worst:.4g} of one process (tol {BF16_TOL} + "
        f"{BF16_TOL}|one|): " + "; ".join(
            f"rank {g['rank']}: {g['ms_step']:.3f} ms/step, "
            f"{per / g['ms_step'] * 1e3:.1f} seed-steps/s, peak "
            f"{g['peak_gib']:.2f} GiB" for g in ranks))


def factored_phase(torch, kernels: dict, totals: dict, cache: dict) -> None:
    """Phase 17: the factorized recurrences at c2's geometry (bf16): the
    low-rank LSTM and the grouped GRU of :data:`FACTORED` through
    :func:`model_phase` without the epoch: the gather at the step's
    shape, the first steps against the same model on the plain gather,
    one step launching the gather once and no recurrence kernel (the JAX
    XLA scan's route: a loop over the window), ms per step and peak
    memory."""
    from lfm_quant_tpu_torch.config import get_preset

    c2 = get_preset("c2")
    for cell, kw in FACTORED:
        cfg = one_epoch(train_variant(c2, kind=cell, kwargs=dict(
            c2.model.kwargs, **kw)))
        label = f"c2 {cell} " + ", ".join(f"{k} {v}" for k, v in kw.items())
        res = model_phase(torch, kernels, totals, cfg, splits_of(cfg, cache),
                          label, epoch=False)
        if res["trainer"].model.scan_impl != "loop":
            fail(f"{label}: scan_impl {res['trainer'].model.scan_impl}")
        del res
        torch.cuda.empty_cache()


# ---- phase 18: the serving stack ------------------------------------------

STACK_SERVED = {"c2": "rnn_fused_fwd_mma_lstm", "c3": "rnn_fused_fwd_mma_gru"}
STACK_CLIENTS = 4         # closed-loop HTTP clients
STACK_REQUESTS = 128      # requests of the step-1 load and each step-2 turn
STACK_MONTHS = 48         # months per universe the clients draw from
STACK_SEQ_MONTHS = 12     # months per universe of the bitwise sequential pass
STACK_FAULT_EVERY = 4     # step 3: every 4th dispatch attempt fails
STACK_QUEUE_MAX = 4       # step 5: the bounded queue
STACK_BURSTS = 24         # step 5: bursts of 2 x STACK_QUEUE_MAX submits
STACK_BREAKER = 3         # step 4: consecutive failures that open it


def http_get(port: int, path: str):
    """One GET on the front door → ``(status, headers, body bytes,
    client ms)``."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=120) as resp:
            body = resp.read()
            return resp.status, dict(resp.headers), body, \
                (time.perf_counter() - t0) * 1e3
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read(), \
            (time.perf_counter() - t0) * 1e3


def http_load(port: int, months: dict, n_requests: int, seed: int,
              stop=None) -> list:
    """Closed loop over HTTP: :data:`STACK_CLIENTS` threads draw (universe,
    month) from seeded streams and GET ``/score`` until ``n_requests``
    are spent (or, with ``stop``, until it is set). Returns one record per
    request: ``(universe, month, status, body dict, client ms)``."""
    import threading

    import numpy as np

    names = sorted(months)
    budget = iter(range(n_requests if stop is None else 1 << 30))
    lock = threading.Lock()
    out = []

    def client(k: int) -> None:
        rng = np.random.default_rng([seed, k])
        while True:
            with lock:
                if next(budget, None) is None:
                    return
            if stop is not None and stop.is_set():
                return
            u = names[int(rng.integers(len(names)))]
            m = months[u][int(rng.integers(len(months[u])))]
            status, _, body, ms = http_get(port,
                                           f"/score?universe={u}&month={m}")
            rec = (u, m, status, json.loads(body), ms)
            with lock:
                out.append(rec)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(STACK_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        fail("phase 18: an HTTP client did not finish")
    return out


def load_summary(recs: list, wall_s: float) -> dict:
    """req/s over the wall, the client's and the service's p50/p99, and the
    mean and p99 of each phase of the served requests."""
    import numpy as np

    ok = [r for r in recs if r[2] == 200]
    out = {"requests": len(recs), "ok": len(ok),
           "req_per_s": len(ok) / wall_s if wall_s > 0 else None}
    if not ok:
        return out
    client = np.asarray([r[4] for r in ok])
    served = np.asarray([r[3]["latency_ms"] for r in ok])
    out.update(client_p50_ms=float(np.percentile(client, 50)),
               client_p99_ms=float(np.percentile(client, 99)),
               p50_ms=float(np.percentile(served, 50)),
               p99_ms=float(np.percentile(served, 99)))
    for ph in ("queue_ms", "batch_ms", "retry_ms", "dispatch_ms"):
        v = np.asarray([r[3]["phases"][ph] for r in ok])
        out[ph] = {"mean": float(v.mean()),
                   "p99": float(np.percentile(v, 99))}
    out["retries"] = int(sum(r[3]["phases"]["retries"] for r in ok))
    return out


def log_load(label: str, s: dict) -> None:
    phases = ", ".join(
        f"{ph[:-3]} {s[ph]['mean']:.3f}/{s[ph]['p99']:.3f}"
        for ph in ("queue_ms", "batch_ms", "retry_ms", "dispatch_ms")
        if ph in s)
    log(f"phase 18 {label}: {s['ok']}/{s['requests']} ok, "
        f"{s['req_per_s']:.2f} req/s, client p50 "
        f"{s.get('client_p50_ms', 0):.3f} p99 {s.get('client_p99_ms', 0):.3f}"
        f" ms, served p50 {s.get('p50_ms', 0):.3f} p99 "
        f"{s.get('p99_ms', 0):.3f} ms; phases mean/p99 ms: {phases}")


class PlainRefs:
    """The plain path's scores on the card per (universe, generation,
    month), computed once each: the served scores' reference."""

    def __init__(self, universes: dict):
        self.paths = {(u, 0): p for u, (_, _, p) in universes.items()}
        self.cache = {}

    def check(self, label: str, u: str, gen: int, month: int,
              firm_idx, scores) -> float:
        import numpy as np

        key = (u, gen, month)
        if key not in self.cache:
            plain = self.paths[(u, gen)]
            pool = np.asarray(firm_idx, np.int32)
            t = int(np.searchsorted(plain.panel.dates, month))
            if plain.panel.dates[t] != month:
                fail(f"{label}: month {month} not in the {u} panel")
            self.cache[key] = (pool, plain.score(
                pool[None, :], np.asarray([t], np.int32),
                np.ones((1, pool.size), np.float32))[0])
        pool, want = self.cache[key]
        got = np.asarray(scores, np.float32)
        if not np.array_equal(np.asarray(firm_idx), pool) or \
                got.shape != want.shape or not np.isfinite(got).all():
            fail(f"{label}: {u} gen {gen} {month}: served firms/shape "
                 "differ from the plain path's, or non-finite scores")
        err = np.abs(got - want)
        if (err > BF16_TOL + BF16_TOL * np.abs(want)).any():
            fail(f"{label}: {u} gen {gen} {month}: served scores differ "
                 f"from the plain path by up to {err.max()}")
        return float(err.max())

    def check_all(self, label: str, recs: list, gens=None) -> float:
        worst = 0.0
        for u, m, status, body, _ in recs:
            if status != 200:
                fail(f"{label}: {u}/{m} answered {status}: {body}")
            gen = body["generation"]
            if gens is not None and gen not in gens.get(u, (0,)):
                fail(f"{label}: {u}/{m} from generation {gen}")
            worst = max(worst, self.check(label, u, gen, m,
                                          body["firm_idx"], body["scores"]))
        return worst


def sequential_pass(service, months: dict) -> dict:
    """Score a fixed list of months one request at a time (rows bucket
    1): the same dispatch geometry in every pass, so passes compare
    bitwise."""
    out = {}
    for u in sorted(months):
        for m in months[u][::max(1, len(months[u]) // STACK_SEQ_MONTHS)][
                :STACK_SEQ_MONTHS]:
            out[(u, m)] = service.score(u, m).scores
    return out


def serving_stack_phase(torch, totals: dict, cache: dict) -> dict:
    """Phase 18: the serving stack behind the HTTP front door. c2 and c3 at
    full width (random weights from the presets' seeds) on one
    ``ScoringService`` behind ``make_http_server`` on 127.0.0.1, port 0:

    1. :data:`STACK_CLIENTS` closed-loop HTTP clients: req/s, the client's
       and the service's p50/p99, each phase's mean and p99; every served
       score vector held to the plain path on the card; kernels A and B
       launched;
    2. the same load with ``LFM_METRICS=0`` and ``LFM_FLIGHT=0``, in
       turns with the plane on (on, off, on, off): the plane's req/s
       overhead; a sequential pass (rows bucket 1) bitwise equal with the
       plane on and off;
    3. transient ``serve_dispatch`` faults (every
       :data:`STACK_FAULT_EVERY`-th attempt, so each retry succeeds):
       every response held to the plain path, the sequential pass bitwise
       equal to step 2's, the retry counter moved;
    4. permanent faults until the circuit opens: ``/healthz`` 503, ``/score``
       503 with ``Retry-After``, the half-open probe closes it after the
       cooldown, exactly one incident bundle;
    5. ``queue_max`` :data:`STACK_QUEUE_MAX`, bursts of twice that: sheds,
       the admitted requests' p99;
    6. a request whose deadline has passed: 504 and no kernel launch;
    7. c2 refreshed for one epoch while the clients keep sending: no
       request dropped, every response one generation's and held to that
       generation's plain path, rows 3 and 4 launched, p99 during it.

    Returns the summary the script prints as one JSON line."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from lfm_quant_tpu_torch.config import get_preset
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.serve import ScoringService, incident
    from lfm_quant_tpu_torch.serve.errors import (DeadlineError, ShedError,
                                                  http_status)
    from lfm_quant_tpu_torch.serve.http import make_http_server
    from lfm_quant_tpu_torch.train.loop import Predictor
    from lfm_quant_tpu_torch.utils import faults, flight

    universes = {}
    for name in STACK_SERVED:
        cfg = get_preset(name)
        panel = panel_of(cfg, cache)
        universes[name] = (cfg, panel, Predictor(plain_variant(cfg), panel))
    refs = PlainRefs(universes)
    # build_info's backend: "cuda" on the card (a CPU rehearsal reads
    # "cpu").
    backend = "cuda" if torch.cuda.is_available() else "cpu"
    inc_dir = tempfile.mkdtemp(prefix="lfm_incidents_")
    summary = {}
    faults.configure("")
    service = ScoringService(device="cuda", max_rows=8,
                             breaker_threshold=STACK_BREAKER,
                             incident_dir=inc_dir)
    httpd = make_http_server(service, 0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        for name, (cfg, panel, _) in universes.items():
            t0 = time.perf_counter()
            service.register(name, cfg, panel)
            torch.cuda.synchronize()
            log(f"phase 18 {name}: registered, warmed and stamped in "
                f"{time.perf_counter() - t0:.1f} s")
        # Requests draw from STACK_MONTHS months per universe spread over
        # its serveable range (every width bucket it has), so the plain
        # path's references are computed once per month.
        months = {}
        for u in universes:
            ms = service.serveable_months(u)
            months[u] = ms[::max(1, len(ms) // STACK_MONTHS)]
        status, _, body, _ = http_get(port, "/healthz")
        if status != 200 or not json.loads(body)["ok"]:
            fail(f"phase 18: /healthz {status} before any load: {body}")

        def timed_load(seed, n=STACK_REQUESTS, stop=None):
            t0 = time.perf_counter()
            recs = http_load(port, months, n, seed, stop=stop)
            return recs, time.perf_counter() - t0

        # ---- 1. the load ------------------------------------------------
        service.reset_stats()
        (recs, wall), counts = counted(
            "phase 18 step 1 (HTTP load)",
            tuple(STACK_SERVED.values()) + ("window_gather",),
            lambda: timed_load(1))
        for k, n in counts.items():
            totals[k] += n
        st = service.stats()
        s1 = load_summary(recs, wall)
        log_load("step 1 (plane on)", s1)
        worst = refs.check_all("phase 18 step 1", recs)
        log(f"phase 18 step 1: served scores within {worst:.4g} of the "
            f"plain path; service {st['completed']} completed, "
            f"{st['batches']} batches, occupancy {st['mean_occupancy']}, "
            f"{st['req_per_s']:.2f} req/s")
        summary["load"] = s1
        summary["load"]["mean_occupancy"] = st["mean_occupancy"]
        code, _, body, _ = http_get(port, "/stats")
        if code != 200 or json.loads(body)["completed"] != STACK_REQUESTS:
            fail(f"phase 18 step 1: /stats {code} {body[:200]!r}")
        code, hdr, body, _ = http_get(port, "/metrics")
        text = body.decode()
        if code != 200 or "lfm_serve_latency_ms_count" not in text or \
                f'backend="{backend}"' not in text:
            fail(f"phase 18 step 1: /metrics {code} {text[:300]!r}")

        # ---- 2. the plane off, in turns -------------------------------
        seq_on = sequential_pass(service, months)
        rps = {"on": [s1["req_per_s"]], "off": []}
        seq_off = None
        for turn, plane in enumerate(("off", "on", "off")):
            if plane == "off":
                os.environ["LFM_METRICS"] = "0"
                flight.configure(0)
            try:
                (recs, wall), counts = counted(
                    f"phase 18 step 2 (plane {plane})",
                    tuple(STACK_SERVED.values()) + ("window_gather",),
                    lambda: timed_load(1))
                if plane == "off" and seq_off is None:
                    seq_off = sequential_pass(service, months)
            finally:
                os.environ.pop("LFM_METRICS", None)
                flight.configure()
            for k, n in counts.items():
                totals[k] += n
            s = load_summary(recs, wall)
            log_load(f"step 2 turn {turn + 2} (plane {plane})", s)
            refs.check_all(f"phase 18 step 2 ({plane})", recs)
            rps[plane].append(s["req_per_s"])
        for key, want in seq_on.items():
            if not np.array_equal(seq_off[key], want):
                fail(f"phase 18 step 2: {key} scores differ bitwise with "
                     "the metrics plane and the flight recorder off")
        on, off = float(np.mean(rps["on"])), float(np.mean(rps["off"]))
        summary["plane"] = {"req_per_s_on": rps["on"],
                            "req_per_s_off": rps["off"],
                            "overhead_pct": 100.0 * (off - on) / off}
        log(f"phase 18 step 2: {len(seq_on)} sequential responses bitwise "
            f"equal with the plane on and off; req/s on {rps['on']}, off "
            f"{rps['off']}: metrics_overhead_pct "
            f"{summary['plane']['overhead_pct']:.2f}")

        # ---- 3. transient faults -----------------------------------------
        r0 = service.stats()["retries"]
        faults.configure("serve_dispatch:at=" + "+".join(
            str(k) for k in range(1, 8192, STACK_FAULT_EVERY)))
        try:
            recs, wall = timed_load(3)
            seq_faulty = sequential_pass(service, months)
        finally:
            faults.configure("")
        s3 = load_summary(recs, wall)
        log_load("step 3 (transient faults)", s3)
        worst = refs.check_all("phase 18 step 3", recs)
        for key, want in seq_on.items():
            if not np.array_equal(seq_faulty[key], want):
                fail(f"phase 18 step 3: {key} scores differ bitwise under "
                     "transient faults")
        retries = service.stats()["retries"] - r0
        if retries <= 0:
            fail("phase 18 step 3: the retry counter did not move")
        summary["faults"] = {"retries": retries, "req_per_s":
                             s3["req_per_s"], "p99_ms": s3["p99_ms"],
                             "retry_ms": s3["retry_ms"]}
        log(f"phase 18 step 3: {retries} retries, {len(recs)} responses "
            f"within {worst:.4g} of the plain path, the sequential pass "
            "bitwise equal")

        # ---- 4. the circuit breaker ---------------------------------------
        u0, m0 = "c2", months["c2"][-1]
        faults.configure("serve_dispatch:kind=permanent")
        try:
            codes = [http_get(port, f"/score?universe={u0}&month={m0}")[0]
                     for _ in range(STACK_BREAKER)]
            service.incidents.wait()
            hz = http_get(port, "/healthz")
            sc = http_get(port, f"/score?universe={u0}&month={m0}")
        finally:
            faults.configure("")
        if codes != [500] * STACK_BREAKER:
            fail(f"phase 18 step 4: failing dispatches answered {codes}")
        if hz[0] != 503 or json.loads(hz[2]).get("circuit") != "open":
            fail(f"phase 18 step 4: /healthz {hz[0]} {hz[2]!r}")
        if sc[0] != 503 or "Retry-After" not in sc[1]:
            fail(f"phase 18 step 4: /score {sc[0]} {sc[1]}")
        time.sleep(service.batcher._breaker_cooldown_s + 0.05)
        probe = http_get(port, f"/score?universe={u0}&month={m0}")
        hz2 = http_get(port, "/healthz")
        if probe[0] != 200 or hz2[0] != 200 or \
                json.loads(hz2[2]).get("circuit") != "closed":
            fail(f"phase 18 step 4: the half-open probe answered "
                 f"{probe[0]}, /healthz {hz2[0]} {hz2[2]!r}")
        refs.check("phase 18 step 4", u0, 0, m0,
                   json.loads(probe[2])["firm_idx"],
                   json.loads(probe[2])["scores"])
        bundles = incident.find_bundles(inc_dir)
        if len(bundles) != 1:
            fail(f"phase 18 step 4: {len(bundles)} incident bundles")
        meta = json.load(open(os.path.join(bundles[0], "incident.json")))
        if meta["trigger"] != "breaker_open" or \
                meta["host"].get("backend") != backend:
            fail(f"phase 18 step 4: bundle {meta['trigger']} "
                 f"{meta['host']}")
        summary["breaker"] = {"opens": service.stats()["breaker_opens"],
                              "retry_after": sc[1]["Retry-After"],
                              "bundle_files": sorted(meta["files"]),
                              "device": meta["host"].get("device")}
        log(f"phase 18 step 4: {STACK_BREAKER} failures opened the circuit "
            f"(/healthz 503, /score 503 Retry-After {sc[1]['Retry-After']}),"
            f" the probe closed it; one bundle ({meta['trigger']}, "
            f"{meta['files']['flight.jsonl']}, host device "
            f"{meta['host'].get('device')})")

        # ---- 5. shedding ----------------------------------------------------
        service.reset_stats()
        service.batcher.queue_max = STACK_QUEUE_MAX
        admitted, shed = [], 0
        try:
            rng = np.random.default_rng(5)
            for _ in range(STACK_BURSTS):
                futs = []
                for _ in range(2 * STACK_QUEUE_MAX):
                    u = ("c2", "c3")[int(rng.integers(2))]
                    futs.append(service.submit(
                        u, months[u][int(rng.integers(len(months[u])))]))
                for f in futs:
                    try:
                        admitted.append(f.result(timeout=120))
                    except ShedError as e:
                        if http_status(e) != 429:
                            fail("phase 18 step 5: shed is not a 429")
                        shed += 1
        finally:
            service.batcher.queue_max = 256
        st = service.stats()
        if shed == 0 or st["shed"] != shed:
            fail(f"phase 18 step 5: {shed} sheds (stats {st['shed']})")
        if st["queue_peak"] > STACK_QUEUE_MAX:
            fail(f"phase 18 step 5: queue peak {st['queue_peak']}")
        for r in admitted:
            refs.check("phase 18 step 5", r.universe, r.generation,
                       r.month, r.firm_idx, r.scores)
        lat = [r.latency_ms for r in admitted]
        summary["shed"] = {"offered": 2 * STACK_QUEUE_MAX * STACK_BURSTS,
                           "shed": shed, "admitted": len(admitted),
                           "p99_ms": float(np.percentile(lat, 99))}
        log(f"phase 18 step 5: queue_max {STACK_QUEUE_MAX}, "
            f"{summary['shed']['offered']} offered in bursts of "
            f"{2 * STACK_QUEUE_MAX}: {shed} shed (429), {len(admitted)} "
            f"admitted, p99 {summary['shed']['p99_ms']:.3f} ms, queue peak "
            f"{st['queue_peak']}")

        # ---- 6. an expired deadline -----------------------------------------
        torch.cuda.synchronize()

        def expired():
            f = service.submit("c2", months["c2"][0], deadline_ms=1e-3)
            try:
                f.result(timeout=60)
            except DeadlineError as e:
                return http_status(e)
            fail("phase 18 step 6: the expired request was served")

        code, _ = counted("phase 18 step 6 (expired deadline)", (),
                          expired, must_not=tuple(_build.LAUNCHES))
        if code != 504:
            fail(f"phase 18 step 6: answered {code}, not 504")
        log("phase 18 step 6: the expired request failed with 504 and "
            "launched no kernel")

        # ---- 7. refresh under load ------------------------------------------
        cfg2, panel2, _ = universes["c2"]
        splits2 = splits_of(cfg2, cache)
        stop = threading.Event()
        service.reset_stats()
        box = {}

        def load():
            box["recs"], box["wall"] = timed_load(7, stop=stop)

        def refresh():
            clients = threading.Thread(target=load)
            clients.start()
            try:
                t0 = time.perf_counter()
                box["entry"] = service.refresh("c2", splits2, epochs=1)
                torch.cuda.synchronize()
                box["refresh_s"] = time.perf_counter() - t0
            finally:
                time.sleep(0.5)  # the new generation serves under load
                stop.set()
                clients.join(timeout=900)

        _, counts = counted(
            "phase 18 step 7 (refresh under load)",
            ("rnn_fused_fwd_mma_lstm", "rnn_fused_bwd_mma_lstm",
             "rnn_fused_fwd_mma_gru", "window_gather"), refresh)
        for k, n in counts.items():
            totals[k] += n
        entry = box["entry"]
        if entry.generation != 1:
            fail(f"phase 18 step 7: refreshed to generation "
                 f"{entry.generation}")
        new = {k: v.detach().float().cpu().numpy()
               for k, v in entry.predictor.state.params.items()}
        refs.paths[("c2", 1)] = Predictor(plain_variant(cfg2), panel2, new)
        recs = box["recs"]
        s7 = load_summary(recs, box["wall"])
        log_load("step 7 (refresh under load)", s7)
        worst = refs.check_all("phase 18 step 7", recs,
                               gens={"c2": (0, 1), "c3": (0,)})
        gens = sorted({r[3]["generation"] for r in recs if r[0] == "c2"})
        direct = service.score("c2", months["c2"][-1])
        if direct.generation != 1:
            fail("phase 18 step 7: the new generation is not served")
        refs.check("phase 18 step 7 (new generation)", "c2", 1,
                   direct.month, direct.firm_idx, direct.scores)
        summary["refresh"] = {"refresh_s": box["refresh_s"],
                              "responses": len(recs),
                              "c2_generations": gens,
                              "p99_ms": s7["p99_ms"],
                              "client_p99_ms": s7["client_p99_ms"],
                              "req_per_s": s7["req_per_s"]}
        log(f"phase 18 step 7: c2 refreshed for one epoch in "
            f"{box['refresh_s']:.3f} s under load; {len(recs)} responses, "
            f"none dropped, c2 generations {gens}, every one within "
            f"{worst:.4g} of its generation's plain path; p99 during the "
            f"refresh {s7['p99_ms']:.3f} ms (client {s7['client_p99_ms']:.3f}"
            " ms)")
    finally:
        faults.configure("")
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        service.close()
        shutil.rmtree(inc_dir, ignore_errors=True)
    del universes, refs
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# Phases 19-22: the training leftovers
# ---------------------------------------------------------------------------

PIPE_EPOCHS = 3     # phase 20's fits, cut from the preset's 30
C5_PIPE_EPOCHS = 2  # phase 20's c5 fits: epoch 1 rides the lookahead
# Phase 20's profiled c2 fits: one epoch boundary each (cut from 3).
GAP_EPOCHS = 2
# (LFM_ASYNC, LFM_ASYNC_CKPT): the four settings of phase 20.
KNOBS = ((0, 0), (0, 1), (1, 0), (1, 1))
# History fields that must agree across the settings.
DET_FIELDS = ("epoch", "train_loss", "grad_norm", "val_ic", "val_mse",
              "val_ic_std")
# Phase 21: the kernels of the path, held at the bucket shapes.
TRAIN_KERNELS = ("window_gather", "rnn_fused_fwd_mma_lstm",
                 "rnn_fused_bwd_mma_lstm")


def nll_variant(cfg, **changes):
    """``cfg`` cut to one epoch with the heteroscedastic head (``loss=
    "nll"``: the head's second output is log σ²)."""
    return dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, epochs=1, loss="nll"), **changes)


def close_to(label: str, got, want) -> float:
    """``got`` within atol and rtol :data:`BF16_TOL` of ``want`` and
    finite; returns the largest difference."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{label}: {got.shape} against {want.shape}, or not finite")
    err = np.abs(got - want)
    if (err > BF16_TOL + BF16_TOL * np.abs(want)).any():
        fail(f"{label}: differs from the plain path by up to {err.max()}")
    return float(err.max()) if err.size else 0.0


def variance_checked(torch, label: str, model, plain, turns: int = 2,
                     span=None) -> dict:
    """``predict("test", return_variance=True)`` of ``model`` on the
    kernels (counted: the gather and the fused forward) against
    ``plain``'s on the card from the same params (over the month range
    ``span`` when given: the plain path of 64 seeds is slow): the mean
    and the aleatoric variance within the gate, the variance finite and
    > 0 on every valid cell and 0 elsewhere; the test split's predict
    timed warm with and without the variance (``turns`` times each).
    Returns the launches, the host arrays and the times."""
    import numpy as np

    from lfm_quant_tpu_torch.ops import _build

    (fc, var, valid), counts = counted(
        f"{label} predict with variance", ("window_gather",
                                           "rnn_fused_fwd_mma_lstm"),
        lambda: model.predict("test", return_variance=True),
        must_not=CUDA_CORE)
    if not (np.isfinite(var[..., valid]).all() and
            (var[..., valid] > 0).all()) or var[..., ~valid].any():
        fail(f"{label}: variance not finite and > 0 on the valid cells, "
             "0 elsewhere")
    kw = {"date_range": span} if span else {"split": "test"}
    got_fc, got_var, got_valid = ((fc, var, valid) if span is None else
                                  model.predict(return_variance=True, **kw))
    _build.reset_launch_counts()
    want_fc, want_var, want_valid = plain.predict(return_variance=True,
                                                  **kw)
    if any(_build.launch_counts().values()):
        fail(f"the plain {label} predict launched kernels")
    if not np.array_equal(got_valid, want_valid):
        fail(f"{label}: the plain path's valid cells differ")
    v = got_valid
    err_fc = close_to(f"{label} mean", got_fc[..., v], want_fc[..., v])
    err_var = close_to(f"{label} variance", got_var[..., v],
                       want_var[..., v])
    times = {"variance": [], "point": []}
    for kind in ("variance", "point") * turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict("test", return_variance=kind == "variance")
        times[kind].append(1e3 * (time.perf_counter() - t0))
    log(f"{label} predict with variance: {fc.shape}, mean within "
        f"{err_fc:.4g} and variance within {err_var:.4g} of the plain path "
        f"({int(v.sum())} cells{f', months {span}' if span else ''}) "
        f"(tol {BF16_TOL} + {BF16_TOL}|plain|), variance "
        f"{var[..., valid].min():.4g} .. {var[..., valid].max():.4g}; warm "
        f"ms with variance {', '.join(f'{t:.1f}' for t in times['variance'])}"
        f", point {', '.join(f'{t:.1f}' for t in times['point'])} (host "
        "clock, host copies included)")
    return {"counts": counts, "fc": fc, "var": var, "valid": valid,
            "ms": times}


def total_std_reports(label: str, fc, var, valid, panel, device_report
                      ) -> None:
    """A ``mean_minus_total_std`` report on the card against the numpy
    engine's on the same forecasts and variances (``REPORT_TOL``)."""
    from lfm_quant_tpu_torch.backtest import engine

    stacked = fc if fc.ndim == 3 else fc[None]
    avar = var if var.ndim == 3 else var[None]
    agg, v = engine.aggregate_ensemble(stacked, valid,
                                       "mean_minus_total_std", 1.0,
                                       aleatoric_var=avar)
    ref = engine.run_backtest(agg, v, panel)
    errs = reports_match(f"{label} mean_minus_total_std", device_report,
                         ref)
    log(f"{label} mean_minus_total_std: CAGR {device_report.cagr:+.4%}, "
        f"Sharpe {device_report.sharpe_ann:.3f}, {device_report.n_months} "
        f"months; against the numpy engine: cagr {errs['cagr']:.3g}, "
        f"monthly returns {errs['monthly_returns']:.3g}, ic "
        f"{errs['monthly_ic']:.3g}")


def variance_phase(torch, cfg2, cfg5, totals: dict, seed_launches: dict,
                   cache: dict) -> dict:
    """Phase 19: the heteroscedastic forward. c2 with ``loss="nll"`` for
    one epoch through ``run_experiment``, its test split predicted with
    the variance (against the plain path), the backtest entry's
    ``mean_minus_total_std`` on its run dir (against the numpy engine);
    c5's 64 seeds the same way (``[64, N, T]`` variances, scored on the
    card); a two-fold heteroscedastic c2 walk-forward whose
    ``walkforward.npz`` carries the stitched variances."""
    import tempfile
    import types

    import numpy as np

    from lfm_quant_tpu_torch.backtest.__main__ import main as backtest_main
    from lfm_quant_tpu_torch.backtest.torch_engine import (
        run_scoring_pipeline,
    )
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
    from lfm_quant_tpu_torch.train.loop import Trainer, run_experiment
    from lfm_quant_tpu_torch.train.walkforward import run_walkforward

    out = {}
    panel2 = panel_of(cfg2, cache)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = nll_variant(cfg2, out_dir=tmp)
        t0 = time.perf_counter()
        (summary, trainer, splits), counts = counted(
            "c2 nll training", TRAIN_KERNELS,
            lambda: run_experiment(cfg, panel=panel2, device="cuda"),
            must_not=CUDA_CORE)
        fit_s = time.perf_counter() - t0
        for k, n in counts.items():
            totals[k] += n
        rec = summary["history"][0]
        if not all(np.isfinite(rec[k]) for k in ("train_loss", "val_ic")):
            fail(f"c2 nll epoch: {rec}")
        log(f"c2 nll: one epoch in {fit_s:.2f} s, train_loss (nll) "
            f"{rec['train_loss']:.6f} val_ic {rec['val_ic']:.6f}")
        plain = Trainer(plain_variant(cfg), splits, device="cuda")
        plain.state = plain.init_state({k: p.detach().cpu().numpy()
                                        for k, p in trainer.state.params
                                        .items()})
        res = variance_checked(torch, "c2 nll", trainer, plain)
        for k, n in res["counts"].items():
            totals[k] += n
        out["c2_predict_ms"] = res["ms"]
        del plain
        report_path = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        (_, counts) = counted(
            "c2 backtest --mode mean_minus_total_std",
            ("window_gather", "rnn_fused_fwd_mma_lstm"),
            lambda: backtest_main(["--run-dir", summary["run_dir"],
                                   "--mode", "mean_minus_total_std",
                                   "--json-out", report_path]))
        bt_s = time.perf_counter() - t0
        for k, n in counts.items():
            totals[k] += n
        with open(report_path) as fh:
            got = types.SimpleNamespace(**json.load(fh))
        total_std_reports("c2 backtest entry", res["fc"], res["var"],
                          res["valid"], splits.panel, got)
        log(f"c2 backtest entry (load, predict with variance, score): "
            f"{bt_s:.2f} s")
        del trainer

        # The two-fold heteroscedastic walk-forward.
        start = int(panel2.dates[int(panel2.n_months * 0.6)])
        wf_dir = os.path.join(tmp, "wf")
        (fc, valid, wf), counts = counted(
            "c2 nll walk-forward (2 folds)", TRAIN_KERNELS,
            lambda: run_walkforward(cfg, panel2, start=start,
                                    step_months=WF_STEP, val_months=WF_VAL,
                                    n_folds=WF_FOLDS, out_dir=wf_dir,
                                    score_modes=["mean_minus_total_std"],
                                    device="cuda"),
            must_not=CUDA_CORE)
        for k, n in counts.items():
            totals[k] += n
        data = np.load(os.path.join(wf_dir, "walkforward.npz"))
        var = data["variance"] if "variance" in data else None
        if var is None or var.shape != fc.shape or not (
                np.isfinite(var[valid]).all() and (var[valid] > 0).all()):
            fail("c2 nll walk-forward: walkforward.npz carries no finite "
                 "positive variance of the forecast's shape")
        log(f"c2 nll walk-forward: {WF_FOLDS} folds, walkforward.npz "
            f"{sorted(data.files)}, variance {var[valid].min():.4g} .. "
            f"{var[valid].max():.4g} over {int(valid.sum())} cells; "
            f"{next(iter(wf['backtest'].values()))['summary']}")
    torch.cuda.empty_cache()

    # c5: 64 heteroscedastic seeds.
    splits5 = splits_of(cfg5, cache)
    cfg = nll_variant(cfg5)
    trainer = EnsembleTrainer(cfg, splits5, device="cuda")
    t0 = time.perf_counter()
    summary, counts = counted("c5 nll training", TRAIN_KERNELS, trainer.fit,
                              must_not=CUDA_CORE)
    fit_s = time.perf_counter() - t0
    for k, n in counts.items():
        seed_launches[k] += n
    rec = summary["history"][0]
    log(f"c5 nll: one epoch of {cfg.n_seeds} seeds in {fit_s:.2f} s, "
        f"train_loss (nll) {rec['train_loss']:.6f} val_ic "
        f"{rec['val_ic']:.6f}")
    plain = EnsembleTrainer(plain_variant(cfg), splits5, device="cuda")
    plain.state = plain.init_state({k: p.detach().cpu().numpy()
                                    for k, p in trainer.state.params.items()})
    lo = splits5.range_of("test")[0]
    res = variance_checked(torch, "c5 nll", trainer, plain, turns=1,
                           span=(lo, lo + C5_PREDICT_MONTHS))
    del plain
    torch.cuda.empty_cache()
    if res["var"].shape != (cfg.n_seeds, splits5.panel.n_firms,
                            splits5.panel.n_months):
        fail(f"c5 nll variances {res['var'].shape}")
    totals["window_gather"] += res["counts"]["window_gather"]
    seed_launches["rnn_fused_fwd_mma_lstm"] += res["counts"][
        "rnn_fused_fwd_mma_lstm"]
    out["c5_predict_ms"] = res["ms"]
    t0 = time.perf_counter()
    rep, = run_scoring_pipeline(res["fc"], res["valid"], splits5.panel,
                                modes=["mean_minus_total_std"],
                                aleatoric_var=res["var"],
                                device="cuda").values()
    score_ms = 1e3 * (time.perf_counter() - t0)
    total_std_reports("c5 on the card", res["fc"], res["var"], res["valid"],
                      splits5.panel, rep)
    log(f"c5 mean_minus_total_std scored on the card in {score_ms:.1f} ms")
    del trainer, res
    torch.cuda.empty_cache()
    return out


def kernel_gaps(torch, fn) -> dict:
    """``fn`` under ``torch.profiler``: the wall, the device's busy time
    (the union of its kernels' intervals) and the gaps between them, the
    three largest first (with lock-step epochs, the epochs' boundaries).
    Empty when the trace holds no device time (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and e.time_range.end > e.time_range.start)
    if not spans:
        return {"out": out, "wall_ms": wall_ms}
    busy, gaps = 0.0, []
    lo, hi = spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            # (the gap, where it starts: ms after the first kernel)
            gaps.append(((s - hi) / 1e3, (hi - spans[0][0]) / 1e3))
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    span_ms = (spans[-1][1] - spans[0][0]) / 1e3
    return {"out": out, "wall_ms": wall_ms, "busy_ms": busy / 1e3,
            "first_to_last_ms": span_ms,
            "idle_ms": span_ms - busy / 1e3,
            "top_gaps_ms": sorted(gaps, reverse=True)[:4]}


def run_history(run_dir: str) -> dict:
    """metrics.jsonl → {epoch: record}, the last line of an epoch winning
    (a resumed run appends)."""
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            out[int(rec["epoch"])] = {k: rec[k] for k in DET_FIELDS if k in rec}
    return out


def fits_agree(torch, label: str, runs: dict) -> bool:
    """The fits of ``runs`` (name → (summary, params)) against the first:
    history, best and early-stop epochs and restored params. Bitwise when
    they are; else the decisions exact and the step losses within the
    training gate, and a finding logged. Returns whether bitwise."""
    import numpy as np

    names = list(runs)
    ref_s, ref_p = runs[names[0]]
    bitwise = True
    for name in names[1:]:
        s, p = runs[name]
        for k in ("best_epoch", "epochs_run"):
            if s[k] != ref_s[k]:
                fail(f"{label}: {name} {k} {s[k]} against {ref_s[k]}")
        same = ([{k: r[k] for k in DET_FIELDS if k in r}
                 for r in s["history"]] ==
                [{k: r[k] for k in DET_FIELDS if k in r}
                 for r in ref_s["history"]]
                and s["step_losses"] == ref_s["step_losses"]
                and all(torch.equal(p[k], ref_p[k]) for k in p))
        if not same:
            bitwise = False
            losses_agree(f"{label}: {name}",
                         np.asarray(s["step_losses"]).ravel(),
                         np.asarray(ref_s["step_losses"]).ravel())
            err = max(float((p[k].float() - ref_p[k].float()).abs().max())
                      for k in p)
            log(f"{label}: {name} NOT bitwise equal to {names[0]} (the "
                f"decisions are; step losses within the gate; restored "
                f"params differ by up to {err:.4g})")
    log(f"{label}: {len(names)} fits {'bitwise equal' if bitwise else 'agree within the gate'}"
        f" (history, best epoch {ref_s['best_epoch']}, epochs run "
        f"{ref_s['epochs_run']}, restored best params)")
    return bitwise


def pipeline_phase(torch, cfg2, cfg5, totals: dict, seed_launches: dict,
                   one5: dict, cache: dict) -> dict:
    """Phase 20: the pipeline and preemption. c2 for
    :data:`PIPE_EPOCHS` epochs under the four ``LFM_ASYNC`` ×
    ``LFM_ASYNC_CKPT`` settings (agreement, one counted host sync per
    epoch, each epoch's wall), the inter-epoch device gaps with the
    pipeline off and on (``torch.profiler``, :data:`GAP_EPOCHS` epochs),
    c5 for :data:`C5_PIPE_EPOCHS` epochs with the pipeline on and off (and
    its first steps against phase 6's), then ``python -m
    lfm_quant_tpu_torch.train --preset c2`` as a real subprocess
    SIGTERM'd at its third checkpoint write (exit 75) and resumed (the
    history and best params of the uninterrupted fit)."""
    import tempfile

    import numpy as np

    from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
    from lfm_quant_tpu_torch.train.loop import Trainer
    from lfm_quant_tpu_torch.utils import telemetry

    out = {}
    splits2 = splits_of(cfg2, cache)
    cfg = dataclasses.replace(cfg2, optim=dataclasses.replace(
        cfg2.optim, epochs=PIPE_EPOCHS))
    saved_env = {k: os.environ.get(k) for k in ("LFM_ASYNC",
                                                "LFM_ASYNC_CKPT")}

    def knobs(loop, ckpt):
        os.environ["LFM_ASYNC"], os.environ["LFM_ASYNC_CKPT"] = (
            str(loop), str(ckpt))

    runs, dirs = {}, {}
    tmp = tempfile.mkdtemp(prefix="lfm_pipe_")
    try:
        for loop, ckpt in KNOBS:
            knobs(loop, ckpt)
            name = f"LFM_ASYNC={loop} LFM_ASYNC_CKPT={ckpt}"
            run_dir = dirs[loop, ckpt] = os.path.join(tmp, f"r{loop}{ckpt}")
            trainer = Trainer(cfg, splits2, run_dir=run_dir, device="cuda")
            snap = telemetry.COUNTERS.snapshot()
            torch.cuda.synchronize()
            t0, start = time.perf_counter(), time.time()
            summary, counts = counted(f"c2 x{PIPE_EPOCHS} ({name})",
                                      TRAIN_KERNELS, trainer.fit,
                                      must_not=CUDA_CORE)
            wall = time.perf_counter() - t0
            syncs = telemetry.COUNTERS.delta(snap).get("host_syncs", 0)
            if syncs != summary["epochs_run"]:
                fail(f"c2 ({name}): {syncs} counted host syncs in "
                     f"{summary['epochs_run']} epochs")
            for k, n in counts.items():
                totals[k] += n
            # Each epoch from the fit's start or the last epoch's record to
            # its own record (the host's clock when the epoch settled).
            ts = [start] + [r["ts"] for r in summary["history"]]
            epoch_s = [b - a for a, b in zip(ts, ts[1:])]
            out[name] = {"wall_s": wall, "epoch_s": epoch_s}
            log(f"c2 x{PIPE_EPOCHS} ({name}): {wall:.3f} s, epochs "
                f"{', '.join(f'{e:.3f}' for e in epoch_s)} s, one counted "
                f"host sync per epoch, best epoch {summary['best_epoch']}")
            runs[name] = (summary, {k: p.detach().clone() for k, p in
                                    trainer.state.params.items()})
            del trainer
        out["bitwise"] = fits_agree(torch, "c2 under the four settings",
                                    runs)
        del runs
        torch.cuda.empty_cache()

        # The device's gaps between epochs, the pipeline off and on.
        gap_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, epochs=GAP_EPOCHS))
        for loop in (0, 1):
            knobs(loop, loop)
            trainer = Trainer(gap_cfg, splits2, device="cuda")
            gaps = kernel_gaps(torch, trainer.fit)
            if "busy_ms" not in gaps:
                log(f"c2 gaps (LFM_ASYNC={loop}): no device time in the "
                    "trace (not measured)")
                continue
            out[f"gaps_async{loop}"] = {k: v for k, v in gaps.items()
                                        if k != "out"}
            log(f"c2 x{GAP_EPOCHS} under the profiler (LFM_ASYNC={loop}, "
                f"LFM_ASYNC_CKPT={loop}): wall {gaps['wall_ms']:.1f} ms, "
                f"device busy {gaps['busy_ms']:.1f} ms, idle "
                f"{gaps['idle_ms']:.1f} ms between the first and the last "
                f"kernel, largest gaps (ms, at ms after the first kernel) "
                f"{', '.join(f'{g:.2f} at {t:.0f}' for g, t in gaps['top_gaps_ms'])}")
            del trainer
        torch.cuda.empty_cache()

        # c5 with the pipeline on and off; its first two steps (before the
        # two-epoch schedule parts from the one-epoch one: the first
        # update's step size is 0) against phase 6's.
        splits5 = splits_of(cfg5, cache)
        c5 = dataclasses.replace(cfg5, optim=dataclasses.replace(
            cfg5.optim, epochs=C5_PIPE_EPOCHS))
        c5_runs = {}
        for loop in (1, 0):
            knobs(loop, 1)
            trainer = EnsembleTrainer(c5, splits5, device="cuda")
            snap = telemetry.COUNTERS.snapshot()
            t0 = time.perf_counter()
            summary, counts = counted(
                f"c5 x{C5_PIPE_EPOCHS} (LFM_ASYNC={loop})", TRAIN_KERNELS,
                trainer.fit, must_not=CUDA_CORE)
            wall = time.perf_counter() - t0
            syncs = telemetry.COUNTERS.delta(snap).get("host_syncs", 0)
            if syncs != summary["epochs_run"]:
                fail(f"c5 (LFM_ASYNC={loop}): {syncs} host syncs in "
                     f"{summary['epochs_run']} epochs")
            for k, n in counts.items():
                seed_launches[k] += n
            out[f"c5_wall_s_async{loop}"] = wall
            log(f"c5 x{C5_PIPE_EPOCHS} (LFM_ASYNC={loop}): {wall:.2f} s; "
                f"val_ic {[round(r['val_ic'], 6) for r in summary['history']]}")
            c5_runs[f"LFM_ASYNC={loop}"] = (summary, {
                k: p.detach().clone() for k, p in
                trainer.state.params.items()})
            del trainer
            torch.cuda.empty_cache()
        fits_agree(torch, f"c5 x{C5_PIPE_EPOCHS}, the pipeline on and off",
                   c5_runs)
        got = np.asarray(c5_runs["LFM_ASYNC=1"][0]["step_losses"][:2])
        want = np.asarray(one5["epoch_losses"][:2])
        err = losses_agree("c5 pipelined, first two steps vs phase 6",
                           got.ravel(), want.ravel())
        log(f"c5 pipelined: the first two steps' {got.size} per-seed losses "
            f"{'bitwise equal to' if np.array_equal(got, want) else f'within {err:.4g} of'}"
            " phase 6's")
        del c5_runs

        # A real preemption of the entry point, and its resume. Lock-step
        # (LFM_ASYNC=0): the signal at the third write (epoch 1's) stops
        # the run before epoch 2, which the resume trains. (With the
        # lookahead epoch 2 is already queued, and settles, before the
        # stop: the in-process and CPU tests cover that order.)
        env = dict(os.environ, PYTHONPATH=ROOT, LFM_ASYNC="0",
                   LFM_ASYNC_CKPT="1")
        env.pop("LFM_FAULTS", None)
        out_dir = os.path.join(tmp, "cli")
        cmd = [sys.executable, "-m", "lfm_quant_tpu_torch.train", "--preset",
               "c2", "--epochs", str(PIPE_EPOCHS), "--out", out_dir]
        t0 = time.perf_counter()
        cut = subprocess.run(
            cmd, env=dict(env, LFM_FAULTS="ckpt_write:at=2,kind=sigterm"),
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        cut_s = time.perf_counter() - t0
        if cut.returncode != 75:
            fail(f"preempted c2 run exited {cut.returncode}, not 75: "
                 f"{cut.stderr[-1500:]}")
        run_dir = os.path.join(out_dir, cfg.name, "seed0")
        part = run_history(run_dir)
        t0 = time.perf_counter()
        done = subprocess.run(cmd + ["--resume"], env=env,
                              capture_output=True, text=True, timeout=600,
                              cwd=ROOT)
        resume_s = time.perf_counter() - t0
        if done.returncode != 0:
            fail(f"resumed c2 run exited {done.returncode}: "
                 f"{done.stderr[-1500:]}")
        ref_dir = dirs[0, 1]
        got_h, want_h = run_history(run_dir), run_history(ref_dir)
        got_p = CheckpointManager(os.path.join(run_dir, "ckpt",
                                               "best")).restore()["params"]
        want_p = CheckpointManager(os.path.join(ref_dir, "ckpt",
                                                "best")).restore()["params"]
        if sorted(got_h) != sorted(want_h):
            fail(f"resumed c2: epochs {sorted(got_h)} against "
                 f"{sorted(want_h)}")
        exact = got_h == want_h and all(torch.equal(got_p[k], want_p[k])
                                        for k in want_p)
        if not exact:
            losses_agree("resumed c2 train loss",
                         [got_h[e]["train_loss"] for e in sorted(got_h)],
                         [want_h[e]["train_loss"] for e in sorted(want_h)])
            if out["bitwise"]:
                fail("resumed c2 differs from the uninterrupted fit though "
                     "the four settings were bitwise equal")
        log(f"c2 entry point SIGTERM'd at its third checkpoint write: exit "
            f"75 after {cut_s:.1f} s with epochs {sorted(part)} recorded; "
            f"--resume exit 0 in {resume_s:.1f} s; history and best params "
            f"{'bitwise equal to' if exact else 'within the gate of'} the "
            f"uninterrupted fit")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return out


def bucket_batches(trainer, parts) -> list:
    """Every bucket's first index batch, ``(lookback, fi, ti)``: a
    training bucket's first step (``[D, w]``, or ``[S, D, w]`` for the
    ensemble) and an eval bucket's first month chunk (``[C, w]``, tiled
    over the seeds for the ensemble)."""
    out = [(lb, fi[0], ti[0]) for lb, (fi, ti, _) in parts]
    ensemble = hasattr(trainer, "n_local")
    C = trainer.cfg.data.dates_per_batch
    for (lb, _), b, _ in trainer.val_sampler.bucketed_cross_sections():
        fi = torch_from(b.firm_idx[:C], trainer.device)
        ti = torch_from(b.time_idx[:C], trainer.device)
        if ensemble:
            # As many seeds as one chunk of the sweep runs at this width.
            seeds = trainer._seed_chunk(fi.numel())
            fi = fi.expand(seeds, *fi.shape).contiguous()
            ti = ti.expand(seeds, *ti.shape).contiguous()
        out.append((lb, fi, ti))
    return out


def torch_from(a, device):
    import torch

    return torch.from_numpy(a).to(device)


def bucket_kernels(torch, label: str, trainer, batches, where: str) -> None:
    """Rows 3 and 4 and the gather at a bucket's shape: of ``batches``
    (:func:`bucket_batches`), the ``where`` ("smallest" or "largest" by
    lookback × width) one's layer-0 input through the model's own
    weights, each one counted launch, against the plain versions (the
    gather exactly, the forward at the gate, the backward's gradients
    scaled as the kernel checks hold them; three seeds of a seed grid)."""
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed
    from lfm_quant_tpu_torch.models.heads import dense_apply
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.ops.gather import gather_windows

    lb, fi, ti = (min if where == "smallest" else max)(
        batches, key=lambda p: (p[0] * p[1].shape[-1], p[0]))
    fi, ti = fi.contiguous(), ti.contiguous()
    xm, fp = trainer.dev["xm"], trainer.fp
    _build.reset_launch_counts()
    x, m = gather_windows(xm, fi, ti, lb, fp=fp)
    if _build.launch_counts()["window_gather"] != 1:
        fail(f"{label} {where} bucket: the gather did not launch once")
    seeded = fi.dim() == 3
    flat = (fi.reshape(-1, fi.shape[-1]), ti.reshape(-1))
    xr, mr = gather_windows_packed(xm, *flat, lb, fp=fp)
    if not (torch.equal(x.reshape(xr.shape), xr)
            and torch.equal(m.reshape(mr.shape), mr)):
        fail(f"{label} {where} bucket: the gather differs")
    model = trainer.model
    cd = model.dtype
    lead = (fi.shape[0],) if seeded else ()
    B = fi.shape[-2] * fi.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(lb)
    # The first seeds' weights (all of them for a training batch).
    own = (lambda t: t[:fi.shape[0]].detach()) if seeded else (
        lambda t: t.detach())
    with torch.no_grad():
        hin = dense_apply(x.reshape(*lead, B, lb, -1),
                          own(model.embed.kernel), own(model.embed.bias), cd)
        mm = m.reshape(*lead, B, lb)
        wx = own(model.xproj[0].kernel).to(cd)
        bb = own(model.xproj[0].bias).to(cd)
        wh = own(model.h_proj[0]).to(cd)
        _build.reset_launch_counts()
        h, c = R._fused_states("lstm", hin, wx, bb, wh, mm, 1.0, True)
        dh = (0.1 * torch.randn(h.shape, generator=gen,
                                device="cuda")).to(cd)
        got = R.rnn_scan_fused_bwd("lstm", hin, wx, bb, wh, mm, h, c, dh)
        counts = _build.launch_counts()
    if (counts["rnn_fused_fwd_mma_lstm"], counts["rnn_fused_bwd_mma_lstm"]
            ) != (1, 1):
        fail(f"{label} {where} bucket: launches {counts}")
    worst = grad = 0.0
    S = fi.shape[0]
    for s in ((0, S // 2, S - 1) if seeded else (None,)):
        pick = (lambda t: t[s]) if seeded else (lambda t: t)
        want_h, want_c = R.rnn_scan_states(
            "lstm", pick(hin).float() @ pick(wx).float() + pick(bb).float(),
            pick(wh), pick(mm), 1.0, True)
        for g, w in ((pick(h), want_h), (pick(c), want_c)):
            err, excess = worst_excess(g, w, BF16_TOL, BF16_TOL)
            if excess > 0 or not torch.isfinite(g).all():
                fail(f"{label} {where} bucket: fused fwd err {err}")
            worst = max(worst, err)
        want = R.rnn_scan_fused_bwd_reference(
            "lstm", *(pick(t) for t in (hin, wx, bb, wh, mm, h, c, dh)))
        grad = max(grad, grads_close(
            f"{label} {where} bucket fused bwd", [pick(t) for t in got],
            want, cd, MMA_WGRAD_TOL))
    log(f"{label} {where} bucket (lookback {lb}, width {fi.shape[-1]}"
        f"{f', {fi.shape[0]} seeds' if seeded else ''}): the gather exact, "
        f"row 3 within {worst:.4g}, row 4 within {grad:.4g} (scaled) of "
        "the plain versions, one launch each")
    torch.cuda.empty_cache()


def buckets_phase(torch, cfg2, cfg5, totals: dict, seed_launches: dict,
                  pipe: dict, cache: dict) -> None:
    """Phase 21: ``LFM_BUCKETS=1``. c2 and c5 for one epoch each on the
    bucket ladder (c2's epoch and predict timed in turns against the max
    shape's); rows 3 and 4 and the gather at the smallest and the largest
    bucket (one seed for c2, the seed grid for c5); the bucketed predict
    against the max-shape predict within the gate; the padded cells
    (``bucket_cells_*``)."""
    import numpy as np

    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
    from lfm_quant_tpu_torch.train.loop import Trainer
    from lfm_quant_tpu_torch.utils import telemetry

    prev = os.environ.get("LFM_BUCKETS")
    try:
        for label, cfg, cls, launches in (
                ("c2", cfg2, Trainer, totals),
                ("c5", cfg5, EnsembleTrainer, seed_launches)):
            splits = splits_of(cfg, cache)
            # c2 in turns (max shape, bucketed, bucketed, max shape); c5
            # bucketed once (its max-shape epoch: phases 6 and 20).
            turns = (0, 1, 1, 0) if label == "c2" else (1,)
            walls = {0: [], 1: []}
            for k, on in enumerate(turns):
                os.environ["LFM_BUCKETS"] = str(on)
                trainer = cls(one_epoch(cfg), splits, device="cuda")
                snap = telemetry.COUNTERS.snapshot()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                summary, counts = counted(
                    f"{label} {'bucketed' if on else 'max-shape'} epoch",
                    TRAIN_KERNELS, trainer.fit, must_not=CUDA_CORE)
                walls[on].append(time.perf_counter() - t0)
                for key, n in counts.items():
                    launches[key] += n
                if on and not np.isfinite(summary["history"][0]["val_ic"]):
                    fail(f"{label} bucketed epoch: {summary['history']}")
                if on and len(walls[1]) == 1:
                    d = telemetry.COUNTERS.delta(snap)
                    geo = (trainer.samplers[0] if label == "c5"
                           else trainer.train_sampler).bucket_geometry()
                    summ = geo.summary(cfg.data.dates_per_batch)
                    bucketed, cells = trainer, (d, summ, summary)
                else:
                    del trainer
            trainer = bucketed
            d, summ, summary = cells
            log(f"{label} buckets: train "
                f"{dict((f'{k[0]}x{k[1]}', int(v.size)) for k, v in geo.train_buckets.items())}"
                f" dates, eval "
                f"{dict((f'{k[0]}x{k[1]}', int(v.size)) for k, v in geo.eval_buckets.items())}"
                f" months; {summary['steps']} steps over "
                f"{d['bucket_dispatches']} buckets; train cells dispatched / "
                f"max shape "
                f"{d['bucket_cells_dispatched'] / d['bucket_cells_max_shape']:.4f}"
                f", real / dispatched "
                f"{d['bucket_cells_real'] / d['bucket_cells_dispatched']:.4f};"
                f" eval cells "
                f"{summ['eval_cells_bucketed'] / summ['eval_cells_max_shape']:.4f}"
                f" of the max shape's; one epoch (host clock, the sweep "
                f"included) bucketed {', '.join(f'{w:.3f}' for w in walls[1])}"
                f" s, max shape {', '.join(f'{w:.3f}' for w in walls[0]) or 'phases 6 and 20'}"
                f"{' s' if walls[0] else ''}")
            parts, _ = (trainer._build_bucketed_epoch(0) if label == "c5"
                        else trainer._bucketed_build(0))
            batches = bucket_batches(trainer, parts)
            for where in ("smallest", "largest"):
                bucket_kernels(torch, label, trainer, batches, where)
            del parts, batches
            # The bucketed predict against the max-shape one, in turns.
            flag = "_bucketed" if label == "c5" else "_bucketed_eval"
            ms = {True: [], False: []}
            for k, on in enumerate((True, False) * (2 if label == "c2"
                                                    else 1)):
                setattr(trainer, flag, on)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if k == 0:
                    (fc, valid), counts = counted(
                        f"{label} bucketed predict",
                        ("window_gather", "rnn_fused_fwd_mma_lstm"),
                        lambda: trainer.predict("test"), must_not=CUDA_CORE)
                    totals["window_gather"] += counts["window_gather"]
                    launches["rnn_fused_fwd_mma_lstm"] += counts[
                        "rnn_fused_fwd_mma_lstm"]
                elif k == 1:
                    want, want_valid = trainer.predict("test")
                else:
                    trainer.predict("test")
                ms[on].append(1e3 * (time.perf_counter() - t0))
            if not np.array_equal(valid, want_valid):
                fail(f"{label} bucketed predict: valid cells differ")
            err = close_to(f"{label} bucketed predict", fc[..., valid],
                           want[..., valid])
            log(f"{label} bucketed predict: "
                f"{', '.join(f'{x:.1f}' for x in ms[True])} ms against the "
                f"max shape's {', '.join(f'{x:.1f}' for x in ms[False])} ms "
                f"(host clock, the host scatter included), forecasts within "
                f"{err:.4g}{' (bitwise)' if np.array_equal(fc, want) else ''}")
            del trainer, bucketed, fc, want
            torch.cuda.empty_cache()
    finally:
        if prev is None:
            os.environ.pop("LFM_BUCKETS", None)
        else:
            os.environ["LFM_BUCKETS"] = prev


def native_phase(torch, cfg2, cfg5, totals: dict, cache: dict) -> None:
    """Phase 22: the native sampler. c5's sampler geometry (64 members'
    samplers over the 8000 x 660 panel): one epoch's host sampling on the
    Python and the native engine, and the structure checks of the JAX
    ``tests/test_native.py:168-200`` on the native epoch; then c2 for one
    epoch with ``sampler_engine="native"``."""
    import numpy as np

    from lfm_quant_tpu_torch import native
    from lfm_quant_tpu_torch.data.windows import DateBatchSampler
    from lfm_quant_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    if not native.available():
        fail("the native sampler did not build (g++)")
    log(f"native sampler built and loaded in {time.perf_counter() - t0:.2f} "
        f"s ({native.library_path().name})")
    splits = splits_of(cfg5, cache)
    d = cfg5.data
    ms = {}
    samplers = [DateBatchSampler(
        splits.panel, d.window, d.dates_per_batch, d.firms_per_date,
        seed=cfg5.seed + s, min_valid_months=d.min_valid_months,
        date_range=splits.train_range) for s in range(cfg5.n_seeds)]
    for engine in ("python", "native", "python", "native"):
        for s in samplers:  # the members' samplers, one engine or the other
            s.engine, s._native = engine, None
        t0 = time.perf_counter()
        epochs = [s.stacked_epoch(0) for s in samplers]
        ms.setdefault(engine, []).append(1e3 * (time.perf_counter() - t0))
    nat = DateBatchSampler(splits.panel, d.window, d.dates_per_batch,
                           d.firms_per_date, seed=cfg5.seed,
                           min_valid_months=d.min_valid_months,
                           date_range=splits.train_range, engine="native")
    py = DateBatchSampler(splits.panel, d.window, d.dates_per_batch,
                          d.firms_per_date, seed=cfg5.seed,
                          min_valid_months=d.min_valid_months,
                          date_range=splits.train_range, engine="python")
    b_nat, b_py = nat.stacked_epoch(0), py.stacked_epoch(0)
    dates = b_nat.time_idx.ravel()
    if nat.batches_per_epoch() != py.batches_per_epoch() or \
            b_nat.firm_idx.shape != b_py.firm_idx.shape or \
            np.unique(dates).size != dates.size or \
            not np.isin(dates, nat._dates).all():
        fail("native epoch: other shapes than the Python engine's, or a "
             "date drawn twice or outside the training dates")
    K, D, Bf = b_nat.firm_idx.shape
    for k in range(K):
        for j in range(D):
            t = int(b_nat.time_idx[k, j])
            pool = nat._firms_by_date[t]
            fi, w = b_nat.firm_idx[k, j], b_nat.weight[k, j]
            real = fi[w > 0]
            if not np.isin(fi, pool).all() or \
                    np.unique(real).size != real.size or \
                    (w > 0).sum() != min(pool.size, Bf):
                fail(f"native epoch: batch {k} date {t} breaks the "
                     "sampler's contract")
    if not np.array_equal(nat.stacked_epoch(0).firm_idx, b_nat.firm_idx):
        fail("native epoch: not deterministic")
    log(f"c5 sampler geometry ({cfg5.n_seeds} members, {K} x [{D}, {Bf}] "
        f"an epoch): one epoch's host sampling "
        f"{', '.join(f'{x:.1f}' for x in ms['python'])} ms on the Python "
        f"engine, {', '.join(f'{x:.1f}' for x in ms['native'])} ms on the "
        f"native one; the native epoch holds the structure checks")
    del epochs, samplers
    splits2 = splits_of(cfg2, cache)
    cfg = one_epoch(cfg2, data=dataclasses.replace(
        cfg2.data, sampler_engine="native"))
    trainer = Trainer(cfg, splits2, device="cuda")
    if not trainer.train_sampler._use_native():
        fail("c2 with sampler_engine='native' did not take the native "
             "sampler")
    t0 = time.perf_counter()
    summary, counts = counted("c2 with the native sampler", TRAIN_KERNELS,
                              trainer.fit, must_not=CUDA_CORE)
    for k, n in counts.items():
        totals[k] += n
    rec = summary["history"][0]
    if not np.isfinite(rec["val_ic"]):
        fail(f"c2 native epoch: {rec}")
    log(f"c2 with the native sampler: one epoch in "
        f"{time.perf_counter() - t0:.2f} s, train_loss "
        f"{rec['train_loss']:.6f} val_ic {rec['val_ic']:.6f}")
    del trainer
    torch.cuda.empty_cache()


DURABLE = ("c2", "c3")    # phases 23-24: the universes published
DURABLE_MONTHS = 3        # months per universe scored before the exit
DURABLE_REQUESTS = 32     # the restored process's load
FLEET_MONTHS = 24         # months per universe the fleet's clients draw
FLEET_REQUESTS = 192      # each fleet load's requests
FLEET_KILL_AFTER = 64     # responses before the member is SIGKILLed
MEMBER_READY_S = 400      # a member's start-up limit (restore included)
ROW3 = ("rnn_fused_fwd_mma_lstm", "rnn_fused_fwd_mma_gru")


def free_port() -> int:
    """A port no one listens on (bound and released: the sealed machine
    has no one else to take it)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT, **extra)
    for k in ("LFM_FAULTS", "LFM_ZOO_PERSIST", "LFM_FLEET"):
        if k not in extra:
            env.pop(k, None)
    return env


def wait_json_line(proc, log_path: str, key: str, timeout_s: float) -> dict:
    """The first JSON line holding ``key`` that a subprocess printed into
    ``log_path``; fails if it exits first or the time runs out."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        with open(log_path) as fh:
            for line in fh:
                if line.startswith("{") and f'"{key}"' in line:
                    return json.loads(line)
        if proc.poll() is not None:
            with open(log_path) as fh:
                fail(f"subprocess exited {proc.returncode} before its "
                     f"{key!r} line: {fh.read()[-2000:]}")
        time.sleep(0.2)
    proc.kill()
    fail(f"no {key!r} line within {timeout_s} s")


def scores_over_http(port: int, months: dict) -> dict:
    """One request at a time (rows bucket 1, the probe's geometry):
    ``{(universe, month): float32 scores}``."""
    import numpy as np

    out = {}
    for u in sorted(months):
        for m in months[u]:
            status, _, body, _ = http_get(port,
                                          f"/score?universe={u}&month={m}")
            if status != 200:
                fail(f"{u}/{m} answered {status}: {body[:300]}")
            out[(u, m)] = np.asarray(json.loads(body)["scores"], np.float32)
    return out


def same_bits(label: str, got: dict, want: dict) -> None:
    import numpy as np

    for key, ref in want.items():
        if key not in got or not np.array_equal(got[key], ref):
            fail(f"{label}: {key} scores are not bitwise equal to the "
                 "scores served before")
    log(f"{label}: {len(want)} score vectors bitwise equal")


def durable_phase(torch, totals: dict, cache: dict, tmp: str) -> dict:
    """Phase 23: durable serving. c2 and c3 at full width (random weights
    from the presets' seeds) are registered with a store and published
    into it (each register timed: the cold register-and-warmup, the
    commit included), :data:`DURABLE_MONTHS` months of each are scored one
    at a time, and the service is closed. Then:

    1. ``python -m lfm_quant_tpu_torch.serve --preset c2 --persist DIR
       --restore --http PORT`` in a fresh process: each universe's probe
       ``bit_equal``, 0 kernel builds, one panel upload per universe, rows
       3 and 5 launched by its load, its restore wall and first-response
       latency; the same months over HTTP bitwise equal to the scores
       before the exit;
    2. the same command with ``--refresh`` and ``LFM_FAULTS=
       manifest_write:at=0,kind=sigkill``: the refresh's publish of
       generation 1 dies by SIGKILL before the manifest's rename;
    3. a restore in this process, counted: generation 0 of both, bitwise
       the scores before the exit, the crashed publish's dir swept.

    Returns the store's path and the reference scores for phase 24."""
    from lfm_quant_tpu_torch.config import get_preset
    from lfm_quant_tpu_torch.serve import ScoringService

    store = os.path.join(tmp, "store")
    names, cold_s, commit_s = {}, {}, {}
    months, pre = {}, {}
    with ScoringService(device="cuda", max_rows=8,
                        persist_dir=store) as svc:
        record = svc.store.record_publish

        def timed_record(entry, **kw):
            t0 = time.perf_counter()
            out = record(entry, **kw)
            commit_s[entry.universe] = time.perf_counter() - t0
            return out

        svc.store.record_publish = timed_record
        for name in DURABLE:
            cfg = get_preset(name)
            panel = panel_of(cfg, cache)
            names[name] = cfg.name
            t0 = time.perf_counter()
            svc.register(cfg.name, cfg, panel)
            torch.cuda.synchronize()
            cold_s[name] = time.perf_counter() - t0
            log(f"phase 23: {name} registered, warmed and published in "
                f"{cold_s[name]:.3f} s (the commit "
                f"{commit_s[cfg.name]:.3f} s)")
        for name, u in names.items():
            ms = svc.serveable_months(u)
            months[u] = ms[::len(ms) // DURABLE_MONTHS][:DURABLE_MONTHS]
            for m in months[u]:
                pre[(u, m)] = svc.score(u, m).scores
        manifest = json.load(open(os.path.join(store, "manifest.json")))
    torch.cuda.empty_cache()
    log(f"phase 23: store committed ({sorted(manifest['universes'])}); "
        "the publishing service is closed")

    # 1. A fresh process restores and serves.
    port = free_port()
    log_path = os.path.join(tmp, "restore.log")
    cmd = [sys.executable, "-m", "lfm_quant_tpu_torch.serve", "--preset",
           "c2", "--persist", store, "--restore", "--requests",
           str(DURABLE_REQUESTS), "--threads", "4", "--http", str(port)]
    with open(log_path, "w") as fh:
        proc = subprocess.Popen(cmd, env=cli_env(), cwd=ROOT, stdout=fh,
                                stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        stats = wait_json_line(proc, log_path, "restore_s", 600)
        proc_s = time.perf_counter() - t0
        got = {(r["universe"], r["generation"], r["probe"])
               for r in stats["restored"]}
        want = {(u, 0, "bit_equal") for u in names.values()}
        if got != want:
            fail(f"phase 23: restored {got}, want {want}")
        if stats["restore_compiles"] != 0:
            fail(f"phase 23: the restore built the kernels "
                 f"({stats['restore_compiles']} nvcc builds)")
        if stats["restore_panel_h2d"] != len(names):
            fail(f"phase 23: {stats['restore_panel_h2d']} panel uploads "
                 f"for {len(names)} universes")
        launches = stats["kernel_launches"]
        for k in ("rnn_fused_fwd_mma_lstm", "window_gather"):
            if not launches.get(k):
                fail(f"phase 23: the restored process's load did not "
                     f"launch {k}")
        for k, n in launches.items():
            totals[k] += n
        time.sleep(0.5)  # the front door binds after the stats line
        after = scores_over_http(port, months)
        same_bits("phase 23 restored process", after, pre)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    out = {"cold_register_s": cold_s,
           "commit_s": {k: commit_s[v] for k, v in names.items()},
           "restore_s": stats["restore_s"],
           "first_response_ms": stats["first_response_ms"],
           "restore_process_to_stats_s": proc_s,
           "restored_load_req_per_s": stats["req_per_s"],
           "restored_load_p50_ms": stats["p50_ms"],
           "restored_load_p99_ms": stats["p99_ms"]}
    log(f"phase 23: restore {stats['restore_s']:.3f} s for "
        f"{len(names)} universes (0 builds, {len(names)} panel uploads), "
        f"first response {stats['first_response_ms']:.3f} ms; cold "
        "register-and-warmup " + ", ".join(
            f"{k} {v:.3f} s" for k, v in cold_s.items()))

    # 2. A publisher killed at the commit point.
    kill_log = os.path.join(tmp, "killed.log")
    with open(kill_log, "w") as fh:
        killed = subprocess.run(
            cmd[:-2] + ["--refresh", "--requests", "16"],
            env=cli_env(LFM_FAULTS="manifest_write:at=0,kind=sigkill"),
            cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT, timeout=600)
    if killed.returncode != -9:
        fail(f"phase 23: the publisher exited {killed.returncode}, not by "
             f"SIGKILL: {open(kill_log).read()[-2000:]}")
    staged = [d for d in os.listdir(os.path.join(store, "universes",
                                                 names["c2"]))
              if d.startswith("gen_00001")]
    log(f"phase 23: publisher SIGKILLed at manifest_write (staged, "
        f"uncommitted: {staged})")

    # 3. The restore after the crash, in this process, counted.
    with ScoringService(device="cuda", max_rows=8,
                        persist_dir=store) as svc:
        t0 = time.perf_counter()
        restored, counts = counted(
            "the restore after the crash",
            ROW3 + ("window_gather",), svc.restore)
        wall = time.perf_counter() - t0
        for k, n in counts.items():
            totals[k] += n
        if sorted((r["universe"], r["generation"], r["probe"])
                  for r in restored) != sorted(want):
            fail(f"phase 23: after the crash restored {restored}")
        after = {(u, m): svc.score(u, m).scores for (u, m) in pre}
        same_bits("phase 23 after the SIGKILL", after, pre)
        for u in names.values():
            udir = os.path.join(store, "universes", u)
            gens = sorted(d for d in os.listdir(udir)
                          if d.startswith("gen_"))
            if gens != ["gen_00000"]:
                fail(f"phase 23: {u} holds {gens} after the sweep")
        out["restore_after_kill_s"] = wall
    torch.cuda.empty_cache()
    log(f"phase 23: the old generation restored in {wall:.3f} s, bitwise; "
        "the staged generation swept")
    return {"store": store, "names": names, "months": months, "pre": pre,
            "summary": out}


def fleet_load(port: int, months: dict, n_requests: int, seed: int,
               kill=None) -> list:
    """:data:`STACK_CLIENTS` closed-loop clients on ``/score`` until
    ``n_requests`` answered; ``kill`` (a callable) runs once
    :data:`FLEET_KILL_AFTER` have. Records ``(universe, month, status,
    body, client ms, done at)``; the kill's time is the last record's
    ``done at`` before it, returned as the list's ``kill_at``."""
    import threading

    import numpy as np

    names = sorted(months)
    lock = threading.Lock()
    recs = []
    state = {"issued": 0, "kill_at": None}

    def client(k: int) -> None:
        rng = np.random.default_rng([seed, k])
        while True:
            with lock:
                if state["issued"] >= n_requests:
                    return
                state["issued"] += 1
            u = names[int(rng.integers(len(names)))]
            m = months[u][int(rng.integers(len(months[u])))]
            status, _, body, ms = http_get(port,
                                           f"/score?universe={u}&month={m}")
            fire = False
            with lock:
                recs.append((u, m, status, json.loads(body), ms,
                             time.perf_counter()))
                if kill is not None and state["kill_at"] is None and \
                        len(recs) >= FLEET_KILL_AFTER:
                    state["kill_at"] = time.perf_counter()
                    fire = True
            if fire:
                kill()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(STACK_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        fail("phase 24: a fleet client did not finish")
    return recs, state["kill_at"]


def fleet_summary(recs: list, wall_s: float) -> dict:
    import numpy as np

    ms = np.asarray([r[4] for r in recs])
    return {"requests": len(recs),
            "req_per_s": len(recs) / wall_s,
            "client_p50_ms": float(np.percentile(ms, 50)),
            "client_p99_ms": float(np.percentile(ms, 99))}


def fleet_phase(torch, totals: dict, durable: dict, tmp: str) -> dict:
    """Phase 24: the fleet on the one card. Two members (``python -m
    lfm_quant_tpu_torch.serve.fleet``, each its own CUDA context) start
    from phase 23's store at once and pass the join gate (restore
    ``bit_equal``, at the fence, the store's probe scored through each
    bitwise; 0 kernel builds, one panel upload per universe). Behind
    ``make_http_server`` on a ``FleetRouter``, :data:`STACK_CLIENTS`
    closed-loop HTTP clients run :data:`FLEET_REQUESTS` requests over a
    one-member fleet (the baseline), then over both members, the primary
    SIGKILLed after :data:`FLEET_KILL_AFTER` responses: no client error,
    every response bitwise equal to a sequential pass made before the
    kill (itself bitwise phase 23's scores), ``fleet_failovers`` > 0;
    req/s and client p50/p99 before and after the kill, goodput against
    the baseline. A replacement member joins; a second generation of c2
    published to the store reaches both live members through ``/sync``,
    bitwise the publisher's scores."""
    import signal
    import threading

    import numpy as np

    from lfm_quant_tpu_torch.config import get_preset
    from lfm_quant_tpu_torch.serve import ScoringService, ZooStore, fleet
    from lfm_quant_tpu_torch.serve.http import make_http_server
    from lfm_quant_tpu_torch.utils import telemetry

    store, names, pre = durable["store"], durable["names"], durable["pre"]
    procs, servers = [], []
    summary = {}

    def serve(front):
        httpd = make_http_server(front, 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
        return httpd.server_address[1]

    def spawn(k):
        rf = os.path.join(tmp, f"ready_m{k}.json")
        procs.append(fleet.spawn_member(store, ready_file=rf))
        return procs[-1], rf

    def admit(coord, k, info):
        for r in info["restore"]:
            if r["probe"] != "bit_equal":
                fail(f"phase 24: member m{k} restored {r}")
        if info["restore_compiles"] != 0 or \
                info["restore_panel_h2d"] != len(names):
            fail(f"phase 24: member m{k} paid {info['restore_compiles']} "
                 f"builds, {info['restore_panel_h2d']} panel uploads")
        member = fleet.HttpMember(f"m{k}",
                                  f"http://127.0.0.1:{info['port']}",
                                  pid=info["pid"])
        coord.add_member(member)
        return member

    try:
        t0 = time.perf_counter()
        specs = [spawn(k) for k in range(2)]
        infos = [fleet.wait_member_ready(p, rf, MEMBER_READY_S)
                 for p, rf in specs]
        summary["members_ready_s"] = time.perf_counter() - t0
        gated = ZooStore(store, readonly=True)
        coord = fleet.FleetCoordinator(store=gated)
        members = [admit(coord, k, info) for k, info in enumerate(infos)]
        log(f"phase 24: 2 members ready in {summary['members_ready_s']:.1f}"
            " s and admitted (bit_equal, at the fence "
            f"{coord.fence()}, 0 builds)")
        router = fleet.FleetRouter(coord, breaker=1, cooldown_ms=60_000,
                                   retries=3)
        all_months = {}
        for u in names.values():
            ms = members[0].serveable_months(u)
            all_months[u] = ms[::max(1, len(ms) // FLEET_MONTHS)][
                :FLEET_MONTHS]
        ref_port = serve(router)
        ref = scores_over_http(ref_port, all_months)
        same_bits("phase 24 the phase-23 months through the router",
                  scores_over_http(ref_port, durable["months"]), pre)

        def check(label, recs):
            for u, m, status, body, _, _ in recs:
                if status != 200:
                    fail(f"{label}: {u}/{m} answered {status}: {body}")
                got = np.asarray(body["scores"], np.float32)
                if not np.array_equal(got, ref[(u, m)]):
                    fail(f"{label}: {u}/{m} is not bitwise the pre-kill "
                         "scores")

        # The one-member baseline.
        one = fleet.FleetCoordinator(store=gated)
        one.add_member(members[0])
        one_port = serve(fleet.FleetRouter(one, retries=3))
        t0 = time.perf_counter()
        recs, _ = fleet_load(one_port, all_months, FLEET_REQUESTS, 0)
        base = fleet_summary(recs, time.perf_counter() - t0)
        check("phase 24 one member", recs)
        summary["one_member"] = base

        # Two members, the primary killed mid-run.
        victim = coord.route(names["c2"])[0]
        vproc = procs[int(victim[1:])]
        snap = telemetry.COUNTERS.snapshot()
        two_port = serve(router)
        t0 = time.perf_counter()
        recs, kill_at = fleet_load(
            two_port, all_months, FLEET_REQUESTS, 1,
            kill=lambda: os.kill(vproc.pid, signal.SIGKILL))
        wall = time.perf_counter() - t0
        d = telemetry.COUNTERS.delta(snap)
        check("phase 24 through the kill", recs)
        before = [r for r in recs if r[5] <= kill_at]
        after = [r for r in recs if r[5] > kill_at]
        if not d.get("fleet_failovers"):
            fail(f"phase 24: no failover counted ({d})")
        if coord.slot(victim).state != "out" or not router.health()["ok"]:
            fail(f"phase 24: after the kill {router.health()}")
        two = fleet_summary(recs, wall)
        two.update(before=fleet_summary(before, kill_at - t0),
                   after=fleet_summary(after, t0 + wall - kill_at),
                   failovers=d.get("fleet_failovers", 0),
                   reroutes=d.get("fleet_reroutes", 0),
                   client_errors=sum(r[2] != 200 for r in recs),
                   goodput_vs_one_member=two["req_per_s"]
                   / base["req_per_s"])
        summary["two_members_kill"] = two
        log(f"phase 24 one member: {base['req_per_s']:.2f} req/s, client "
            f"p50 {base['client_p50_ms']:.3f} p99 "
            f"{base['client_p99_ms']:.3f} ms")
        log(f"phase 24 two members, {victim} SIGKILLed after "
            f"{len(before)} responses: {two['req_per_s']:.2f} req/s "
            f"({two['goodput_vs_one_member']:.3f}x the one-member fleet), "
            f"before p50 {two['before']['client_p50_ms']:.3f} p99 "
            f"{two['before']['client_p99_ms']:.3f} ms, after p50 "
            f"{two['after']['client_p50_ms']:.3f} p99 "
            f"{two['after']['client_p99_ms']:.3f} ms; "
            f"{two['failovers']} failovers, 0 client errors, every "
            "response bitwise")

        # A replacement, then a second generation through the fence.
        p, rf = spawn(2)
        members.append(admit(coord, 2,
                             fleet.wait_member_ready(p, rf, MEMBER_READY_S)))
        cfg = get_preset("c2")
        with ScoringService(device="cuda", max_rows=8,
                            persist_dir=store) as svc:
            svc.restore()
            svc.register(names["c2"],
                         dataclasses.replace(cfg, seed=cfg.seed + 1),
                         svc.zoo.current(names["c2"]).panel)
            new = {(u, m): svc.score(u, m).scores
                   for (u, m) in pre if u == names["c2"]}
        torch.cuda.empty_cache()
        if coord.fence()[names["c2"]] != 1:
            fail(f"phase 24: fence {coord.fence()} after the publish")
        out = coord.sync_members()
        live = [m for m in members if m.name != victim]
        for m in live:
            res = out["members"][m.name]
            if not res["up_to_date"] or res["synced"] != 1:
                fail(f"phase 24: {m.name} sync {res}")
            got = {(u, mo): m.score(u, mo, timeout_s=120).scores
                   for (u, mo) in new}
            same_bits(f"phase 24 {m.name} at generation 1", got, new)
        if any(np.array_equal(new[k], pre[k]) for k in new):
            fail("phase 24: generation 1 scores equal generation 0's")
        summary["sync"] = {m.name: out["members"][m.name] for m in live}
        log(f"phase 24: generation 1 of c2 reached {[m.name for m in live]}"
            " through /sync, bitwise the publisher's")
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return summary


def entry_telemetry_phase(tmp: str) -> dict:
    """Phase 25: telemetry around the entry points. ``python -m
    lfm_quant_tpu_torch.train --preset c2 --epochs 1`` and ``python -m
    lfm_quant_tpu_torch.backtest --run-dir`` on its run dir, each in its
    own process; their ``spans.jsonl`` holds the trainer's ``fit``,
    ``eval``, ``sample`` and ``h2d`` spans and the backtest's ``predict``
    and ``score``, and the unchanged ``scripts/trace_report.py`` renders
    the run (one fit, one epoch, one host sync an epoch)."""
    out_dir = os.path.join(tmp, "train")
    t0 = time.perf_counter()
    train = subprocess.run(
        [sys.executable, "-m", "lfm_quant_tpu_torch.train", "--preset", "c2",
         "--epochs", "1", "--out", out_dir], env=cli_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    train_s = time.perf_counter() - t0
    if train.returncode != 0:
        fail(f"phase 25: train exited {train.returncode}: "
             f"{train.stderr[-2000:]}")
    summary = json.loads(train.stdout[train.stdout.index("{"):])
    run_dir = summary["run_dir"]
    t0 = time.perf_counter()
    bt = subprocess.run(
        [sys.executable, "-m", "lfm_quant_tpu_torch.backtest", "--run-dir",
         run_dir], env=cli_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    backtest_s = time.perf_counter() - t0
    if bt.returncode != 0:
        fail(f"phase 25: backtest exited {bt.returncode}: "
             f"{bt.stderr[-2000:]}")
    with open(os.path.join(run_dir, "spans.jsonl")) as fh:
        spans = [json.loads(line) for line in fh if line.strip()]
    names = {s["name"] for s in spans}
    need = {"fit", "eval", "sample", "h2d", "predict", "score"}
    if not need <= names:
        fail(f"phase 25: spans {sorted(need - names)} missing")
    script = os.path.join(ROOT, "scripts", "trace_report.py")
    rep = subprocess.run([sys.executable, script, run_dir, "--json"],
                         capture_output=True, text=True, timeout=120)
    text = subprocess.run([sys.executable, script, run_dir],
                          capture_output=True, text=True, timeout=120)
    if rep.returncode != 0 or text.returncode != 0:
        fail(f"phase 25: trace_report failed: {rep.stderr[-1000:]}"
             f"{text.stderr[-1000:]}")
    report = json.loads(rep.stdout)
    if report["n_fits"] != 1 or report["n_epochs"] != 1 or \
            report["syncs_per_epoch"] != 1.0:
        fail(f"phase 25: trace_report read {report['n_fits']} fits, "
             f"{report['n_epochs']} epochs, {report['syncs_per_epoch']} "
             "host syncs an epoch")
    for line in text.stdout.splitlines()[:14]:
        log(f"phase 25 trace_report | {line}")
    spans_s = {n: sum(s["dur_s"] for s in spans if s["name"] == n)
               for n in sorted(need)}
    log(f"phase 25: train {train_s:.1f} s, backtest {backtest_s:.1f} s "
        "(each process's start included); span totals " + ", ".join(
            f"{n} {v:.4f} s" for n, v in spans_s.items()))
    return {"train_s": train_s, "backtest_s": backtest_s,
            "span_s": spans_s, "epochs_per_hour": report["epochs_per_hour"]}


# ---- phase 26: stacked runs ----------------------------------------------

SWEEP_GRID = "lr=1e-3,3e-4;weight_decay=1e-4,0"  # the sweep's 4 configs
SWEEP_EPOCHS = 2      # cut from the preset's 30
FOLDS, FOLD_EPOCHS, FOLD_TRAIN = 3, 1, 120  # rolling 120-month windows
CSV_FIRMS, CSV_MONTHS = 1000, 240
CSV_DERIVED = ("mom_12_1", "vol_6")
STACK_TIMED_STEPS = 8  # stacked steps timed and profiled
# The final-state gate of a stack against its sequential fits: each run's
# best val IC and best params, about 10x the largest gaps sound stacks
# showed on an H100 (best val ICs 9.42e-6 folds, 4.65e-6 sweep; best
# params 2.11e-3). A stack run with its members' lr collapsed to member
# 0's came out 0.0196 and 0.0258 away.
STACK_IC_LIMIT = 1e-4
STACK_PARAM_LIMIT = 0.02
# The stacked path's kernels: the gather's seed fold and the seed grids of
# rows 3 and 4 (c2's members are the runs).
STACK_KERNELS = ("window_gather", "rnn_fused_fwd_mma_lstm",
                 "rnn_fused_bwd_mma_lstm")


def stacked_losses(torch, capture: list, n_runs: int):
    """The per-step losses ``[steps, runs]`` a stacked fit's epochs
    returned (captured around ``StackedRuns.dispatch_epoch``)."""
    return torch.cat([v.float().cpu() for v in capture]).numpy().reshape(
        -1, n_runs)


def runs_agree(label: str, stacked, sequential, stk_runs, seq_runs
               ) -> dict:
    """A stack against its sequential fits: each run's per-step losses
    within the training gate, its epochs run and best epoch equal;
    whether the losses came out bitwise."""
    import numpy as np

    if len(sequential) != stacked.shape[1]:
        fail(f"{label}: {len(sequential)} sequential fits for "
             f"{stacked.shape[1]} stacked runs")
    worst, bitwise = 0.0, True
    for r, (want, a, b) in enumerate(zip(sequential, stk_runs, seq_runs)):
        if (a["epochs_run"], a["best_epoch"]) != (b["epochs_run"],
                                                  b["best_epoch"]):
            fail(f"{label} run {r}: stacked epochs/best "
                 f"{a['epochs_run']}/{a['best_epoch']}, sequential "
                 f"{b['epochs_run']}/{b['best_epoch']}")
        got = stacked[:len(want), r]
        worst = max(worst, losses_agree(f"{label} run {r}", got, want))
        bitwise &= bool(np.array_equal(got, np.asarray(want, np.float32)))
    return {"max_abs_err": worst, "bitwise": bitwise}


def best_params(run_dir: str) -> dict:
    """A run dir's ``ckpt/best`` params, on the host."""
    from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager

    return CheckpointManager(os.path.join(run_dir, "ckpt",
                                          "best")).restore()["params"]


def params_gap(a: dict, b: dict) -> float:
    """The largest absolute difference between two param trees."""
    if set(a) != set(b):
        fail(f"param trees differ in their leaves: {sorted(set(a) ^ set(b))}")
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def finals_gaps(stk_runs, seq_runs, params: bool) -> dict:
    """Each run's best val IC (and with ``params`` its best params from
    its run dir) against its sequential fit's: the largest gaps."""
    ic = max(abs(a["best_val_ic"] - b["best_val_ic"])
             for a, b in zip(stk_runs, seq_runs))
    out = {"best_val_ic_max_err": ic}
    if params:
        out["best_params_max_err"] = max(
            params_gap(best_params(a["run_dir"]), best_params(b["run_dir"]))
            for a, b in zip(stk_runs, seq_runs))
    return out


def finals_agree(label: str, gaps: dict) -> None:
    """The final-state gate of a stack against its sequential fits:
    :data:`STACK_IC_LIMIT` on the best val ICs, :data:`STACK_PARAM_LIMIT`
    on the best params."""
    if gaps["best_val_ic_max_err"] > STACK_IC_LIMIT or \
            gaps.get("best_params_max_err", 0.0) > STACK_PARAM_LIMIT:
        fail(f"{label}: the best val ICs or params differ from the "
             f"sequential fits' by {gaps} (limits {STACK_IC_LIMIT}, "
             f"{STACK_PARAM_LIMIT})")


def collapsed_control(grid, seq_losses, seq_runs) -> list:
    """The planted control: sequential run 0 standing in for every run,
    as a stack that collapsed its members' lr and weight decay to member
    0's would train them (one seed, one sampler). For each other run,
    whether the phase's gates (the per-step losses' training gate, the
    final-state limits) reject it (``must_reject``: its lr differs from
    run 0's)."""
    import numpy as np

    p0 = best_params(seq_runs[0]["run_dir"])
    out = []
    for k in range(1, len(grid)):
        a = np.asarray(seq_losses[0], np.float64)
        b = np.asarray(seq_losses[k], np.float64)
        loss_err = float(np.abs(a - b).max())
        rec = {"config": grid[k], "loss_max_err": loss_err,
               "losses_rejected": bool((np.abs(a - b) > BF16_TOL + BF16_TOL
                                        * np.abs(b)).any()),
               "best_val_ic_err": abs(seq_runs[0]["best_val_ic"]
                                      - seq_runs[k]["best_val_ic"]),
               "best_params_err": params_gap(
                   p0, best_params(seq_runs[k]["run_dir"]))}
        rec["rejected"] = (rec["losses_rejected"]
                           or rec["best_val_ic_err"] > STACK_IC_LIMIT
                           or rec["best_params_err"] > STACK_PARAM_LIMIT)
        rec["must_reject"] = grid[k].get("lr") != grid[0].get("lr")
        out.append(rec)
    return out


def stacked_phase(torch, cfg2, panel, totals: dict, seed_launches: dict,
                  tmp: str) -> dict:
    """Phase 26: stacked runs on c2 at full width. (a) ``run_config_sweep``
    over :data:`SWEEP_GRID` (``--sweep-grid``), the 4 configs as one stack
    and then one fit after another: each run's per-step losses within the
    training gate, epochs run, best epoch and the ranking equal, its best
    val IC and best params within the final-state limits, the planted
    control (:func:`collapsed_control`) rejected where it must be; the
    stack's launches counted (one seed-grid launch of rows 3-5 a step for
    all 4 runs), configs/hour both ways, ms per stacked step, the card's
    busy share over stacked steps, peak memory. (b) ``run_walkforward
    (foldstack=True)`` (``--wf-foldstack``), 3 folds of a rolling window,
    against the sequential sweep: the same gates, the stitched forecasts
    within the gate, folds/hour both ways. (c) ``python -m
    lfm_quant_tpu_torch.train`` for one epoch on a CSV panel (1000 firms x
    240 months written by ``write_long_csv``, two derived features),
    parsed by the native engine without pandas; its ``main`` in this
    process. (d) the phase's wall.
    The stacks' launches go to ``seed_launches`` (the seed rows), the
    sequential fits' to ``totals``."""
    import numpy as np

    from lfm_quant_tpu_torch.data.compustat import (load_compustat_csv,
                                                    write_long_csv)
    from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
    from lfm_quant_tpu_torch.train import stacked as ST
    from lfm_quant_tpu_torch.train.loop import Trainer, default_split_dates
    from lfm_quant_tpu_torch.train.walkforward import run_walkforward

    t_phase = time.perf_counter()
    capture, seq_losses = [], []
    real_dispatch, real_fit = ST.StackedRuns.dispatch_epoch, Trainer.fit

    def dispatch(self, carry, args):
        carry, vals = real_dispatch(self, carry, args)
        capture.append(vals["loss"])
        return carry, vals

    split_s = {"build": 0.0, "fit": 0.0}
    real_init, real_stack_fit = ST.StackedRuns.__init__, ST.StackedRuns.fit

    def timed_init(self, *a, **k):
        t0 = time.perf_counter()
        real_init(self, *a, **k)
        split_s["build"] += time.perf_counter() - t0

    def timed_fit(self, *a, **k):
        t0 = time.perf_counter()
        out = real_stack_fit(self, *a, **k)
        split_s["fit"] += time.perf_counter() - t0
        return out

    def fit(self, *a, **k):
        out = real_fit(self, *a, **k)
        seq_losses.append(out["step_losses"])
        return out

    def run(label, fn, stacked: bool):
        """One main path, counted, on the wall clock, peak memory."""
        capture.clear()
        seq_losses.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, counts = counted(label, STACK_KERNELS, fn, must_not=CUDA_CORE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, n in counts.items():
            (seed_launches if stacked else totals)[k] += n
        return out, counts, wall, torch.cuda.max_memory_allocated() / 2**30

    out = {}
    ST.StackedRuns.dispatch_epoch, Trainer.fit = dispatch, fit
    ST.StackedRuns.__init__, ST.StackedRuns.fit = timed_init, timed_fit
    try:
        # (a) the config sweep.
        cfg = dataclasses.replace(cfg2, optim=dataclasses.replace(
            cfg2.optim, epochs=SWEEP_EPOCHS))
        grid = ST.parse_sweep_grid(SWEEP_GRID)
        R = len(grid)
        log(f"phase 26 sweep: c2 at full width ({panel.n_firms} firms x "
            f"{panel.n_months} months, LSTM hidden "
            f"{cfg.model.kwargs.get('hidden')}, bf16), grid {grid}, epochs "
            f"cut {cfg2.optim.epochs} -> {SWEEP_EPOCHS}")
        # ms per stacked step and the card's busy share over them, first:
        # they also warm the member stack's shapes before the timed sweeps.
        runs = [dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, **g)) for g in grid]
        splits = PanelSplits.by_date(panel, *default_split_dates(
            panel, cfg.data))
        eng = ST.StackedRuns(runs, [splits] * R, panel, device="cuda")
        state = eng.init_carry().state
        (fi, ti, w, _), _ = eng.build_epoch(0)
        box = {"state": state, "k": 0}

        def stacked_step():
            k = box["k"] % fi.shape[0]
            box["state"], _ = eng.trainer.step(box["state"], fi[k], ti[k],
                                               w[k])
            box["k"] += 1

        step_ms = time_ms(stacked_step, reps=STACK_TIMED_STEPS)
        one = Trainer(cfg, splits, device="cuda")
        one_state = one.init_state()
        b = one.train_sampler.stacked_epoch(0)
        f1, t1, w1 = one._batch(b)
        one_box = {"state": one_state}

        def one_step():
            one_box["state"], _ = one.step(one_box["state"], f1[0], t1[0],
                                           w1[0])

        one_ms = time_ms(one_step, reps=STACK_TIMED_STEPS)
        prof = {}
        by_name = profile_device(
            torch, lambda: [stacked_step() for _ in range(STACK_TIMED_STEPS)],
            f"{STACK_TIMED_STEPS} stacked c2 steps ({R} runs)", prof)
        busy = (sum(by_name.values()) / prof["wall_ms"]) if by_name else None
        del eng, one, state, one_state, box, one_box
        torch.cuda.empty_cache()
        split_s.update(build=0.0, fit=0.0)
        stk, counts, stk_s, stk_gib = run(
            "phase 26 stacked c2 sweep", lambda: ST.run_config_sweep(
                cfg, grid, panel=panel, out_dir=os.path.join(tmp, "stk"),
                stacked=True, device="cuda"), True)
        stk_loss = stacked_losses(torch, capture, R)
        stk_split = dict(split_s)
        seq, seq_counts, seq_s, seq_gib = run(
            "phase 26 sequential c2 sweep", lambda: ST.run_config_sweep(
                cfg, grid, panel=panel, out_dir=os.path.join(tmp, "seq"),
                stacked=False, device="cuda"), False)
        if not (stk["stacked"] or {}).get("enabled") or seq["stacked"]:
            fail(f"phase 26 sweep: stacked {stk['stacked']}, sequential "
                 f"{seq['stacked']}")
        if stk["best_index"] != seq["best_index"]:
            fail(f"phase 26 sweep: best config {stk['best_index']} stacked,"
                 f" {seq['best_index']} sequential")
        agree = runs_agree("phase 26 sweep", stk_loss, seq_losses,
                           stk["runs"], seq["runs"])
        finals = finals_gaps(stk["runs"], seq["runs"], params=True)
        control = collapsed_control(grid, seq_losses, seq["runs"])
        steps = stk_loss.shape[0]
        if counts["rnn_fused_bwd_mma_lstm"] != steps or \
                counts["window_gather"] != steps or \
                seq_counts["rnn_fused_bwd_mma_lstm"] != R * steps:
            fail(f"phase 26 sweep: {steps} stacked steps of {R} runs "
                 f"launched {counts}; the sequential fits {seq_counts}")
        sweep = {
            "configs": R, "epochs": SWEEP_EPOCHS, "steps": steps,
            "stacked_s": stk_s, "sequential_s": seq_s,
            "configs_per_hour_stacked": R * 3600 / stk_s,
            "configs_per_hour_sequential": R * 3600 / seq_s,
            "ms_per_stacked_step": step_ms, "ms_per_one_run_step": one_ms,
            "busy_share": busy, "peak_gib_stacked": stk_gib,
            "peak_gib_sequential": seq_gib,
            "stacked_build_s": stk_split["build"],
            "stacked_fit_s": stk_split["fit"], "launches": {
                k: n for k, n in counts.items() if n}, **agree, **finals,
            "control": control}
        log(f"phase 26 sweep: stacked {stk_s:.2f} s (the stack's build "
            f"{stk_split['build']:.2f} s, its fit {stk_split['fit']:.2f} s), "
            f"sequential {seq_s:.2f} s: "
            f"{sweep['configs_per_hour_stacked']:.1f} "
            f"against {sweep['configs_per_hour_sequential']:.1f} configs/h;"
            f" {step_ms:.3f} ms per stacked step ({R} runs; one run "
            f"{one_ms:.3f}), busy "
            + (f"{100 * busy:.1f}%" if busy else "not measured")
            + f", peak {stk_gib:.2f} GiB (sequential {seq_gib:.2f}); "
            f"per-step losses within {agree['max_abs_err']:.3g} of the "
            f"sequential fits, bitwise {agree['bitwise']}; best val ICs "
            f"within {finals['best_val_ic_max_err']:.3g}, best params within "
            f"{finals['best_params_max_err']:.3g} (limits {STACK_IC_LIMIT}, "
            f"{STACK_PARAM_LIMIT}); best config {grid[stk['best_index']]}")
        for rec in control:
            log(f"phase 26 control, run 0 in place of {rec['config']}: "
                f"losses within {rec['loss_max_err']:.3g} (training gate "
                f"{'rejects' if rec['losses_rejected'] else 'passes'}), best "
                f"val IC {rec['best_val_ic_err']:.3g}, best params "
                f"{rec['best_params_err']:.3g}: "
                f"{'rejected' if rec['rejected'] else 'NOT rejected'}")
        finals_agree("phase 26 sweep", finals)
        for rec in control:
            if rec["must_reject"] and not rec["rejected"]:
                fail(f"phase 26 control: the gates pass run 0 in place of "
                     f"{rec['config']}: {rec}")
        out["sweep"] = sweep

        # (b) the fold stack.
        cfg = dataclasses.replace(cfg2, optim=dataclasses.replace(
            cfg2.optim, epochs=FOLD_EPOCHS))
        start = int(panel.dates[int(panel.n_months * 0.6)])
        wf = dict(start=start, step_months=WF_STEP, val_months=WF_VAL,
                  n_folds=FOLDS, train_months=FOLD_TRAIN, device="cuda")
        split_s.update(build=0.0, fit=0.0)
        (fc_k, v_k, sk), counts, fstk_s, _ = run(
            "phase 26 fold-stacked c2 walk-forward", lambda: run_walkforward(
                cfg, panel, out_dir=os.path.join(tmp, "wf_stk"),
                foldstack=True, **wf), True)
        fstk_split = dict(split_s)
        n_folds = len(sk["folds"])
        fold_loss = stacked_losses(torch, capture, n_folds)
        (fc_s, v_s, ss), seq_counts, fseq_s, _ = run(
            "phase 26 sequential c2 walk-forward", lambda: run_walkforward(
                cfg, panel, out_dir=os.path.join(tmp, "wf_seq"), **wf),
            False)
        if not (sk.get("foldstack") or {}).get("enabled"):
            fail(f"phase 26 fold stack: not stacked ({sk.get('foldstack')})")
        fagree = runs_agree("phase 26 fold stack", fold_loss, seq_losses,
                            sk["folds"], ss["folds"])
        ffinals = finals_gaps(sk["folds"], ss["folds"], params=False)
        err = np.abs(fc_k - fc_s)
        if not np.array_equal(v_k, v_s) or not np.isfinite(fc_k).all() or \
                (err > BF16_TOL + BF16_TOL * np.abs(fc_s)).any():
            fail(f"phase 26 fold stack: stitched forecasts differ from the "
                 f"sequential sweep's by up to {err.max()}")
        fsteps = fold_loss.shape[0]
        if counts["rnn_fused_bwd_mma_lstm"] != fsteps:
            fail(f"phase 26 fold stack: {fsteps} stacked steps launched "
                 f"{counts}")
        folds = {
            "folds": n_folds, "epochs": FOLD_EPOCHS,
            "train_months": FOLD_TRAIN, "steps": fsteps,
            "stacked_s": fstk_s, "sequential_s": fseq_s,
            "folds_per_hour_stacked": n_folds * 3600 / fstk_s,
            "folds_per_hour_sequential": n_folds * 3600 / fseq_s,
            "forecast_max_abs_err": float(err.max()),
            "stacked_build_s": fstk_split["build"],
            "stacked_fit_s": fstk_split["fit"],
            "launches": {k: n for k, n in counts.items() if n}, **fagree,
            **ffinals}
        log(f"phase 26 fold stack: {n_folds} folds (rolling {FOLD_TRAIN} "
            f"months, epochs cut {cfg2.optim.epochs} -> {FOLD_EPOCHS}) "
            f"stacked {fstk_s:.2f} s (build {fstk_split['build']:.2f} s, "
            f"fit and predictions {fstk_split['fit']:.2f} s), sequential "
            f"{fseq_s:.2f} s: "
            f"{folds['folds_per_hour_stacked']:.1f} against "
            f"{folds['folds_per_hour_sequential']:.1f} folds/h; losses "
            f"within {fagree['max_abs_err']:.3g}, bitwise "
            f"{fagree['bitwise']}, best val ICs within "
            f"{ffinals['best_val_ic_max_err']:.3g}; stitched forecasts within "
            f"{err.max():.3g}")
        finals_agree("phase 26 fold stack", ffinals)
        out["foldstack"] = folds
    finally:
        ST.StackedRuns.dispatch_epoch, Trainer.fit = real_dispatch, real_fit
        ST.StackedRuns.__init__, ST.StackedRuns.fit = real_init, real_stack_fit
    torch.cuda.empty_cache()

    # (c) the train entry on a CSV panel, parsed natively.
    t0 = time.perf_counter()
    synth = synthetic_panel(n_firms=CSV_FIRMS, n_months=CSV_MONTHS,
                            n_features=cfg2.data.n_features,
                            seed=cfg2.data.panel_seed)
    csv = os.path.join(tmp, "panel.csv")
    rows = write_long_csv(synth, csv)
    write_s = time.perf_counter() - t0
    had_pandas = "pandas" in sys.modules
    t0 = time.perf_counter()
    loaded = load_compustat_csv(csv, engine="native")
    parse_s = time.perf_counter() - t0
    if "pandas" in sys.modules and not had_pandas:
        fail("phase 26 CSV: the native load imported pandas")
    if loaded.n_features != synth.n_features or not 0 < int(
            loaded.valid.sum()) <= rows or \
            not np.isfinite(loaded.features).all():
        fail(f"phase 26 CSV: parsed {loaded.features.shape} with "
             f"{int(loaded.valid.sum())} valid cells from {rows} rows")
    cfg = dataclasses.replace(
        cfg2, name="c2_csv",
        data=dataclasses.replace(cfg2.data, panel_path=csv,
                                 derived_features=CSV_DERIVED),
        optim=dataclasses.replace(cfg2.optim, epochs=1))
    path = os.path.join(tmp, "c2_csv.json")
    with open(path, "w") as fh:
        fh.write(cfg.to_json())
    # The entry point's main, in this process (phase 25 runs it as a
    # process of its own).
    import contextlib
    import io

    from lfm_quant_tpu_torch.train.__main__ import main as train_main

    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = train_main(["--config", path, "--out",
                         os.path.join(tmp, "csv_run")])
    train_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 26 CSV: the train entry returned {rc}")
    text = printed.getvalue()
    summary = json.loads(text[text.index("{"):])
    if summary["epochs_run"] != 1 or not np.isfinite(summary["best_val_ic"]):
        fail(f"phase 26 CSV: {summary}")
    try:
        import pandas  # noqa: F401

        have_pandas = True
    except ImportError:
        have_pandas = False
    csv_rec = {"rows": rows, "features": loaded.n_features + len(
        CSV_DERIVED), "write_s": write_s, "native_parse_s": parse_s,
        "train_entry_s": train_s, "pandas_installed": have_pandas,
        "best_val_ic": summary["best_val_ic"]}
    log(f"phase 26 CSV: {rows} rows written in {write_s:.2f} s, parsed "
        f"natively in {parse_s:.2f} s (pandas installed: {have_pandas}); "
        f"the train entry on it ({loaded.n_features} + "
        f"{len(CSV_DERIVED)} derived features) {train_s:.1f} s, "
        f"best_val_ic {summary['best_val_ic']:.6f}")
    out["csv"] = csv_rec
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 26: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phases 27-28: the hoisted recurrence's seed rules, every hidden width
# ---------------------------------------------------------------------------

WIDE_HIDDEN = 256         # phase 28's model: c2 at a width past the caps
WIDE_WIDTHS = (512,)      # rows 1-4 held at this width too
# Rows 4 and 2 in float32 above 128: the 3xTF32 cluster's width 160 (4
# CTAs in the LSTM, 2 in the GRU) and the grid's past its cap at 176 (at
# 256, 384, 400 and 640: groups of 17 and 40 CTAs in the LSTM at 400 and
# 640; 13 and 27 in the GRU); 384 and 640 have no main path (suffixed
# records). 320 and 1024 were cut for the time the grids' readings take.
F32_WIDE_WIDTHS = (160, 256, 384, PAST_CAP_HIDDEN, 640)
# The float32 grid forward's widest, rows 3 and 1 held and timed once (one
# group of 128 CTAs; no "[before]").
F32_FWD_WIDEST = 1024
# The bf16 grid forward's widths past 528 held to the plain version: H 530
# (zero-padded to 544), 1024 and the widest, 1520 (row 3 alone).
FWD_GRID_WIDTHS = (530, 1024, 1520)
WIDE_STEPS = 3            # steps of each wide run held to the plain path
WIDE_REQUESTS = 16        # requests served from the wide universe
GRID_SEEDS = 3            # the seed grids held at the c2 step and at H 256
GRID_STEPS = 2            # steps of the 3-seed ensembles on those grids
NO_SEED_LIBRARY = ("no single PyTorch call: torch.nn.LSTM takes one weight "
                   "set per call, so S seeds are S calls")


def seed_grid_held(torch, label: str, stacked, one_seed, seeds) -> None:
    """Each seed of a seed-stacked call's outputs bitwise those of its
    one-seed call (``one_seed(s)``), or fail."""
    for s in seeds:
        one = one_seed(s)
        for got, want in zip(stacked, one):
            if (got is None) != (want is None) or (
                    got is not None and not torch.equal(got[s], want)):
                fail(f"{label}: seed {s} differs from its one-seed call")


def check_hoisted_seeds(torch, trainer, kernels,
                        where: str = "c5 train step") -> None:
    """Rows 1 and 2 under the seed rules (``_make_scan._fwd_vmap`` :504 and
    ``_bwd_vmap`` :541) at the c5 train step (S 64 x B 2048, T 60, H 128,
    LSTM, bf16): the hoisted projection of the layer-0 input of the first
    stacked batch of epoch 0, with the ensemble's seeded W_x, b and W_h.
    One counted launch of the tensor-core hoisted forward and one call of
    its backward for all 64 seeds; the seeds of
    :data:`C5_CHECK_SEEDS` bitwise equal to one-seed launches with the
    same rows per block and within the plain version's tolerance; m of
    seed extent 1 bitwise equal to its broadcast copy; each timed beside
    its bound, 64 one-seed calls in a loop and the plain version over the
    64 seeds; row 2's yardstick the per-seed dW_h products as one f32
    ``torch.bmm``."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.ops.gather import gather_windows

    trainer.init_state()  # the seeded init of every member
    (fi_all, ti_all, _), _ = trainer._build_epoch(0)
    fi, ti = fi_all[0], ti_all[0]
    S, D, Bf = fi.shape
    W = trainer.window
    x, m = gather_windows(trainer.dev["xm"], fi, ti, W, fp=trainer.fp)
    model = trainer.model
    cd, H, B = model.dtype, model.hidden, D * Bf
    cell = "lstm"
    with torch.no_grad():
        hin = model.embed(x.reshape(S, B, W, -1), dtype=cd)
        xw = model.xproj[0](hin, dtype=cd).contiguous()
        wh = model.h_proj[0].detach().to(cd)
        mm = m.reshape(S, B, W)
    del x, m, hin
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = R._mma_rows(B, sms, S, hoisted=True)
    fwd, bwd = f"rnn_fwd_mma_{cell}", f"rnn_bwd_mma_{cell}"

    _build.reset_launch_counts()
    with torch.no_grad():
        h, c = R._scan_states_any(cell, xw, wh, mm, 1.0, True)
    if _build.launch_counts()[fwd] != 1:
        fail(f"the 64-seed hoisted forward launched {_build.launch_counts()}")
    seed_grid_held(torch, f"{fwd} seed grid", (h, c), lambda s:
                   R._launch_scan_fwd_mma(cell, xw[s], wh[s], mm[s], 1.0,
                                          True, rows), C5_CHECK_SEEDS)
    worst = 0.0
    for s in C5_CHECK_SEEDS:
        want = R.rnn_scan_states(cell, xw[s], wh[s], mm[s], 1.0, True)
        for got, ref in zip((h[s], c[s]), want):
            err, excess = worst_excess(got, ref, BF16_TOL, BF16_TOL)
            if excess > 0 or not torch.isfinite(got).all():
                fail(f"{fwd} seed grid seed {s}: max err {err}")
            worst = max(worst, err)
    with torch.no_grad():
        shared = R._scan_states_any(cell, xw, wh, mm[:1], 1.0, False)[0]
        full = R._scan_states_any(cell, xw, wh, mm[:1].expand(
            S, B, W).contiguous(), 1.0, False)[0]
    if not torch.equal(shared, full):
        fail(f"{fwd} seed grid: m of seed extent 1 differs from its "
             f"broadcast copy")
    del shared, full
    bound, by = rnn_bound("fwd", cell, B, W, H, 2, True, seeds=S)
    ms = kernel_ms(lambda: R._scan_states_any(cell, xw, wh, mm, 1.0, True),
                   reps=2, launches=1)
    loop_ms = time_ms(lambda: [R._launch_scan_fwd_mma(
        cell, xw[s], wh[s], mm[s], 1.0, True) for s in range(S)], reps=2,
        warmup=1)
    plain_ms = time_ms(lambda: [R.rnn_scan_states(
        cell, xw[s], wh[s], mm[s], 1.0, True) for s in range(S)], reps=1,
        warmup=0)
    report(kernels, f"{fwd}_seeds", where, dict(
        shape=[S, B, W, H], rows_per_block=rows, bitwise_vs_single=True,
        seeds_checked=len(C5_CHECK_SEEDS), max_abs_err=worst,
        tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}", **ms,
        single_seed_loop_ms=loop_ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, library_note=NO_SEED_LIBRARY))
    log(f"seed-batched hoisted fwd at the {where}: {ms['ms']:.3f} ms for {S} "
        f"seeds in one launch (device {ms['device_ms']:.3f}), {loop_ms:.3f} "
        f"ms in {S} one-seed launches, bound {bound:.3f} ms")

    gen = torch.Generator(device="cuda").manual_seed(6)
    dh = (0.1 * torch.randn(S, B, W, H, generator=gen, device="cuda")).to(cd)
    args = (cell, xw, wh, mm, h, c, dh)
    _build.reset_launch_counts()
    got = R.rnn_scan_bwd(*args)
    if _build.launch_counts()[bwd] != 1:
        fail(f"the 64-seed hoisted backward launched "
             f"{_build.launch_counts()}")
    seed_grid_held(torch, f"{bwd} seed grid", got, lambda s: R.rnn_scan_bwd(
        cell, *(t[s] for t in args[1:])), C5_CHECK_SEEDS)
    worst = wgrad = 0.0
    for s in C5_CHECK_SEEDS:
        one = tuple(g[s] for g in got)
        want = R.rnn_scan_bwd_reference(cell, *(t[s] for t in args[1:]))
        worst = max(worst, grads_close(f"{bwd} seed grid seed {s}", one,
                                       want, cd, MMA_WGRAD_TOL))
        wgrad = max(wgrad, scaled_err(one[1], want[1]))
    del got, one, want
    torch.cuda.empty_cache()
    bound, by = rnn_bound("bwd", cell, B, W, H, 2, seeds=S)
    ms = kernel_ms(lambda: R.rnn_scan_bwd(*args), reps=2, launches=1)
    loop_ms = time_ms(lambda: [R.rnn_scan_bwd(
        cell, *(t[s] for t in args[1:])) for s in range(S)], reps=1)
    plain_ms = time_ms(lambda: [R.rnn_scan_bwd_reference(
        cell, *(t[s] for t in args[1:])) for s in range(S)], reps=1,
        warmup=0)
    del xw, h, c, dh, args
    torch.cuda.empty_cache()
    # The yardstick: dW_h of every seed in one f32 bmm, [S, H, B T] @ [S,
    # B T, 4H] (the LSTM's d_hw is d_xw).
    a = torch.randn(S, H, B * W, generator=gen, device="cuda")
    d = torch.randn(S, B * W, 4 * H, generator=gen, device="cuda")
    library_ms = time_ms(lambda: torch.bmm(a, d), reps=5)
    del a, d
    torch.cuda.empty_cache()
    report(kernels, f"{bwd}_seeds", where, dict(
        shape=[S, B, W, H], bitwise_vs_single=True,
        seeds_checked=len(C5_CHECK_SEEDS), max_abs_err=worst,
        wgrad_scaled_err=wgrad,
        tolerance=f"scaled atol {BF16_TOL}, dW_h {MMA_WGRAD_TOL}", **ms,
        single_seed_loop_ms=loop_ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=library_ms))
    log(f"seed-batched hoisted bwd at the {where}: {ms['ms']:.3f} ms for {S} "
        f"seeds in one call (device {ms['device_ms']:.3f}), {loop_ms:.3f} ms "
        f"in {S} one-seed calls, bound {bound:.3f} ms, library bmm "
        f"{library_ms:.3f} ms")


def c5_hoisted_phase(torch, cfg, splits, kernels, seed_launches,
                     one5: dict) -> None:
    """Phase 27: c5 with ``scan_impl="pallas"`` (the hoisted recurrence,
    the JAX package's seed rules): rows 1 and 2 held at the train step
    (:func:`check_hoisted_seeds`); then the main path, counted: the first
    :data:`C5_PLAIN_STEPS` steps of an ``EnsembleTrainer`` from the seeded
    init (each step one gather, one forward launch and one backward call
    for all 64 seeds, nothing else) and the forecasts of
    :data:`C5_PREDICT_MONTHS` test months after them; the losses held to
    phase 6's plain path (the same init and sampler orders), the forecasts
    to the plain predict from the same params (the trainer's model and
    gather switched to their plain versions); ms per step and the step's
    peak memory beside phase 6's fused step. Its launches go to
    ``seed_launches``."""
    import numpy as np

    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer

    cfg = train_variant(cfg, scan_impl="pallas")
    trainer = EnsembleTrainer(cfg, splits, device="cuda")
    if trainer.model.scan_impl != "hoisted":
        fail(f"c5 with scan_impl='pallas' built {trainer.model.scan_impl}")
    check_hoisted_seeds(torch, trainer, kernels)
    torch.cuda.empty_cache()

    lo = splits.range_of("test")[0]
    span = (lo, lo + C5_PREDICT_MONTHS)
    must = ("window_gather", "rnn_fwd_mma_lstm", "rnn_bwd_mma_lstm")
    state = trainer.init_state()
    (fi, ti, w), _ = trainer._build_epoch(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses = []
    for k in range(C5_PLAIN_STEPS):
        state, ms = trainer.step(state, fi[k], ti[k], w[k])
        losses.append(ms["loss"])
        if k == 0:
            first = {n: v for n, v in _build.launch_counts().items() if v}
            if first != dict.fromkeys(must, 1):
                fail(f"one c5 hoisted step (64 seeds) launched {first}, not "
                     f"each of {must} once")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer.state = state
    fc, valid = trainer.predict(date_range=span)
    counts = _build.launch_counts()
    log(f"launches during c5 hoisted ({C5_PLAIN_STEPS} steps, predict of "
        f"months {span}): { {n: v for n, v in counts.items() if v} }")
    for n in must:
        if counts[n] == 0:
            fail(f"kernel {n} was not launched by the c5 hoisted path")
    if any(v for n, v in counts.items() if n not in must):
        fail(f"the c5 hoisted path launched another kernel: {counts}")
    for n, v in counts.items():
        seed_launches[n] += v
    got = torch.stack(losses).cpu().tolist()
    err = losses_agree("c5 hoisted vs plain", got, one5["plain_losses"])
    log(f"c5 hoisted: {C5_PLAIN_STEPS} steps x 64 seeds agree with phase 6's "
        f"plain path within {err:.4g}; step peak memory {peak:.2f} GiB")

    # The plain path from the same params: the same trainer with the plain
    # recurrence and the plain gather (a second ensemble's set-up costs
    # seconds).
    trainer.model.scan_impl, trainer.gather_impl = "plain", "plain"
    _build.reset_launch_counts()
    want, want_valid = trainer.predict(date_range=span)
    if any(_build.launch_counts().values()):
        fail(f"the plain c5 predict launched {_build.launch_counts()}")
    trainer.model.scan_impl, trainer.gather_impl = "hoisted", "kernel"
    if not np.array_equal(valid, want_valid) or not valid.any() or \
            not np.isfinite(fc).all():
        fail("c5 hoisted predict: validity differs or forecasts not finite")
    perr = np.abs(fc[:, valid] - want[:, valid])
    if (perr > BF16_TOL + BF16_TOL * np.abs(want[:, valid])).any():
        fail(f"c5 hoisted predict: forecasts differ from the plain path by "
             f"up to {perr.max()}")
    log(f"c5 hoisted predict of months {span} ({int(valid.sum())} cells x 64 "
        f"seeds) within {perr.max():.4g} of the plain predict from the same "
        f"params (tol {BF16_TOL} + {BF16_TOL}|plain|)")

    # Steady steps: ms per step and peak memory beside phase 6's fused.
    n = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def steps():
        st = state
        for k in range(1, n + 1):
            st, _ = trainer.step(st, fi[k], ti[k], w[k])

    steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    per_step = 1e3 * (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train c5 hoisted steady state: {per_step:.3f} ms/step ({n} steps "
        f"of 64 seeds, host clock around synchronized work), peak memory "
        f"{peak:.2f} GiB; the fused c5 step (phase 6) {one5['step_ms']:.3f} "
        f"ms/step, peak {one5['peak_gib']:.2f} GiB")
    del trainer, state
    torch.cuda.empty_cache()


def f32_hoisted_seed_grid(torch, kernels, cell: str, xw, wh, mm, dh,
                          where: str = "c2 train step") -> None:
    """Rows 1 and 2 in float32 under the seed rules at the c2 train step:
    S = 3 (xw, m and dh per seed, W_h of seed extent 1) through the
    3xTF32 hoisted forms, one counted launch of the forward and one call
    of the backward, each seed bitwise equal to a one-seed call and within
    atol 1e-5 (gradients scaled) of the plain version; each timed beside
    its bound, three one-seed calls and the plain version."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    S = GRID_SEEDS
    B, T, H = dh.shape
    xw3 = torch.stack([xw, -xw, 0.5 * xw])
    m3 = torch.stack([mm, mm.flip(0), mm.roll(1, dims=1)])
    dh3 = torch.stack([dh, dh.flip(0), -dh])
    wh1 = wh[None]
    fwd, bwd = f"rnn_fwd_tf32_{cell}", f"rnn_bwd_tf32_{cell}"
    _build.reset_launch_counts()
    with torch.no_grad():
        h, c = R._scan_states_any(cell, xw3, wh1, m3, 1.0, True)
    args = (cell, xw3, wh1, m3, h, c, dh3)
    got = R.rnn_scan_bwd(*args)
    counts = _build.launch_counts()
    if counts[fwd] != 1 or counts[bwd] != 1:
        fail(f"the float32 hoisted seed grid launched {counts}")
    seed_grid_held(torch, f"{fwd} seed grid", (h, c), lambda s:
                   R._scan_states_any(cell, xw3[s], wh, m3[s], 1.0, True),
                   range(S))
    seed_grid_held(torch, f"{bwd} seed grid", got, lambda s: R.rnn_scan_bwd(
        cell, xw3[s], wh, m3[s], h[s], None if c is None else c[s],
        dh3[s]), range(S))
    err_f = err_b = 0.0
    for s in range(S):
        want = R.rnn_scan_states(cell, xw3[s], wh, m3[s], 1.0, True)
        for g, ref in zip((h[s], None if c is None else c[s]), want):
            if ref is None:
                continue
            e, excess = worst_excess(g, ref, F32_TOL, 0.0)
            if excess > 0:
                fail(f"{fwd} seed grid seed {s}: max err {e}")
            err_f = max(err_f, e)
        want = R.rnn_scan_bwd_reference(cell, xw3[s], wh, m3[s], h[s],
                                        None if c is None else c[s], dh3[s])
        err_b = max(err_b, grads_close(f"{bwd} seed grid seed {s}",
                                       tuple(g[s] for g in got), want,
                                       torch.float32))
    del got
    one_fwd = (lambda: [R._scan_states_any(cell, xw3[s], wh, m3[s], 1.0, True)
                        for s in range(S)])
    one_bwd = (lambda: [R.rnn_scan_bwd(cell, xw3[s], wh, m3[s], h[s],
                                       None if c is None else c[s], dh3[s])
                        for s in range(S)])
    for name, kind, run, singles, plain, err in (
            (fwd, "fwd", lambda: R._scan_states_any(cell, xw3, wh1, m3, 1.0,
                                                    True), one_fwd,
             lambda: [R.rnn_scan_states(cell, xw3[s], wh, m3[s], 1.0, True)
                      for s in range(S)], err_f),
            (bwd, "bwd", lambda: R.rnn_scan_bwd(*args), one_bwd,
             lambda: [R.rnn_scan_bwd_reference(
                 cell, xw3[s], wh, m3[s], h[s], None if c is None else c[s],
                 dh3[s]) for s in range(S)], err_b)):
        bound, by = rnn_bound(kind, cell, B, T, H, 4, kind == "fwd",
                              seeds=S)
        rec = dict(shape=[S, B, T, H], dtype="float32", shared="W_h",
                   bitwise_vs_single=True, seeds_checked=S, max_abs_err=err,
                   tolerance=f"atol {F32_TOL}" if kind == "fwd" else
                   f"scaled atol {F32_TOL}", **kernel_ms(run, reps=5,
                                                         launches=2),
                   single_seed_loop_ms=time_ms(singles, reps=3),
                   plain_ms=time_ms(plain, reps=1, warmup=1),
                   bound_ms=bound, bound_by=by,
                   bound_f32_simt_ms=rnn_bound(
                       kind, cell, B, T, H, 4, kind == "fwd", seeds=S,
                       f32_flops=H100_F32_FLOPS)[0])
        if kind == "fwd":
            rec.update(library_ms=None, library_note=NO_SEED_LIBRARY)
        else:
            a = torch.randn(S, H, B * T, device="cuda")
            d = torch.randn(S, B * T, GATES[cell] * H, device="cuda")
            rec["library_ms"] = time_ms(lambda: torch.bmm(a, d), reps=5)
            del a, d
        report(kernels, f"{name}_seeds", where, rec)
        log(f"{name} seed grid (S {S}, W_h shared) at the {where}: "
            f"{rec['ms']:.4f} ms in one call against {S} one-seed calls' "
            f"{rec['single_seed_loop_ms']:.4f}; bitwise each, max err "
            f"{err:.3g}")
    del xw3, m3, dh3, h, c, args
    torch.cuda.empty_cache()


def wide_rows(torch, kernels, where: str, cell: str, hin, wx, b, wh, mm, dh,
              timed=(), name_suffix: str = "") -> None:
    """Rows 1-4 at a bf16 hidden width past 128: each on its route, the
    tensor cores with W_h split across a cluster (``rnn_fwd_cluster.cu``,
    ``rnn_bwd_cluster.cu``, counted under ``rnn_{form}_cluster_{cell}``;
    the backwards on the states the plain forward gives), and on the
    CUDA-core kernel (``rnn_fused_fwd.cu``, ``rnn_bwd.cu``, launched
    directly by ``_launch_fwd`` and ``_launch_bwd``: the float32 route,
    and the bf16 route past 512). Each launch counted once, against its
    plain version (bf16 atol/rtol 0.05, gradients scaled 0.05). ``timed``
    forms go beside their bound, their plain version and their library
    yardstick (cuDNN: the forward call for rows 3 and 1, the backward over
    a saved forward for rows 4 and 2, whose weight-gradient products alone
    are kept too as ``wgrad_products_ms``); a timed form is recorded
    twice, on the cluster (its cluster size, rows per cluster, clusters at
    once, and the CUDA-core time on the same inputs) and on the CUDA cores
    (under the CUDA-core name, as before: the backwards' "[before]").
    Records carry ``name_suffix``."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    dev = hin.device
    cd = hin.dtype
    if R._mma_route(cd, H) != "cluster" or R._mma_route(cd, H, "bwd") != \
            "cluster":
        fail(f"hidden {H} is not on the cluster forward and backward")
    xw32 = hin.float() @ wx.float() + b.float()
    xw = xw32.to(cd)
    want_f = R.rnn_scan_states(cell, xw32, wh, mm, 1.0, True)
    want_x = R.rnn_scan_states(cell, xw, wh, mm, 1.0, True)
    sf = tuple(None if t is None else t.to(cd) for t in want_f)
    sx = tuple(None if t is None else t.to(cd) for t in want_x)
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    Hp = R._padded_width(H)
    runs = {
        "fused_fwd": (lambda: R._fused_states(cell, hin, wx, b, wh, mm, 1.0,
                                              True),
                      lambda: R._launch_fwd(cell, False, hin, wx, b, wh, mm,
                                            1.0, True),
                      lambda: R.rnn_scan_states(
                          cell, hin.float() @ wx.float() + b.float(), wh,
                          mm, 1.0, True), want_f),
        "fwd": (lambda: R._scan_states_any(cell, xw, wh, mm, 1.0, True),
                lambda: R._launch_fwd(cell, True, xw, None, None, wh, mm,
                                      1.0, True),
                lambda: R.rnn_scan_states(cell, xw, wh, mm, 1.0, True),
                want_x),
        "fused_bwd": (lambda: R.rnn_scan_fused_bwd(cell, hin, wx, b, wh, mm,
                                                   *sf, dh),
                      lambda: R._launch_bwd(cell, True, hin, wx, b, wh, mm,
                                            *sf, dh, 1.0),
                      lambda: R.rnn_scan_fused_bwd_reference(
                          cell, hin, wx, b, wh, mm, *sf, dh), None),
        "bwd": (lambda: R.rnn_scan_bwd(cell, xw, wh, mm, *sx, dh),
                lambda: R._launch_bwd(cell, False, xw, None, None, wh, mm,
                                      *sx, dh, 1.0),
                lambda: R.rnn_scan_bwd_reference(cell, xw, wh, mm, *sx, dh),
                None)}

    def held(label, fn, name, want, fwd):
        """One counted launch of ``fn`` (only ``name``) held to ``want``
        → the largest error (the backwards' scaled)."""
        _build.reset_launch_counts()
        with torch.no_grad():
            got = fn()
        counts = _build.launch_counts()
        if counts[name] != 1 or sum(counts.values()) != 1:
            fail(f"{label}: launched {counts}")
        if not fwd:
            return grads_close(label, got, want, cd)
        err = 0.0
        for g, w in zip(got, want):
            if w is None:
                continue
            e, excess = worst_excess(g, w, BF16_TOL, BF16_TOL)
            if excess > 0 or not torch.isfinite(g).all():
                fail(f"{label}: max err {e}")
            err = max(err, e)
        return err

    for form, (run, core, plain, want) in runs.items():
        fwd = form.endswith("fwd")
        name = f"rnn_{form}_cluster_{cell}"
        core_name = f"rnn_{form}_{cell}"
        if not fwd:
            want = plain()
        err = held(f"{name} at {where}", run, name, want, fwd)
        core_err = held(f"{core_name} at {where}", core, core_name, want,
                        fwd)
        del want
        size, rows_of, check = (
            (R._cluster_size, R._cluster_rows, R._cluster_check) if fwd else
            (R._cluster_bwd_size, R._cluster_bwd_rows, R._cluster_bwd_check))
        C = size(cell, Hp, limit)
        rows = rows_of(cell, Hp, C, B, 1, limit, props.multi_processor_count)
        at_once = check(cell, form.startswith("fused"), Hp, C, rows, dev)
        shape_of = (f"{C} CTAs x {rows} rows a cluster, {at_once} clusters "
                    f"at once")
        if form not in timed:
            log(f"{name} at {where}: {shape_of}, max err {err:.4g}; "
                f"{core_name} max err {core_err:.4g}")
            continue
        bound, by = rnn_bound(form, cell, B, T, H, hin.element_size(), fwd)
        if form == "fused_fwd":
            library = cudnn_yardstick(torch, cell, hin, wx, b, wh, BF16_TOL,
                                      BF16_TOL)
        elif form == "fwd":
            library = hoisted_yardstick(torch, cell, xw, wh, BF16_TOL,
                                        BF16_TOL)
        else:
            library = cudnn_bwd_yardstick(
                torch, cell, hin if form == "fused_bwd" else xw, wx, b, wh,
                dh, hoisted=form == "bwd")
            torch.cuda.empty_cache()
            # The weight-gradient products of the row alone, in f32.
            d_xw, d_hw, h_prev = R._scan_bwd_core(
                cell, xw32, wh, mm, *(sf if form == "fused_bwd" else sx), dh,
                1.0)
            a_h, d_h = h_prev.reshape(-1, H), d_hw.reshape(B * T, -1)
            if form == "fused_bwd":
                a_x, d_x = hin.float().reshape(-1, H), d_xw.reshape(B * T, -1)
                lib = (lambda: (torch.matmul(a_x.T, d_x),
                                torch.matmul(a_h.T, d_h)))
            else:
                lib = (lambda: torch.matmul(a_h.T, d_h))
            library["wgrad_products_ms"] = time_ms(lib, reps=3)
            del d_xw, d_hw, h_prev, a_h, d_h, lib
        plain_ms = time_ms(plain, reps=1, warmup=1)
        common = dict(shape=[B, T, H], dtype=str(cd).replace("torch.", ""),
                      plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                      **library)
        tol = (f"atol {BF16_TOL} + rtol {BF16_TOL}" if fwd else
               f"scaled atol {BF16_TOL}")
        core_t = kernel_ms(core, reps=2, launches=1)
        report(kernels, core_name + name_suffix, where, dict(
            rows_per_block=R._simt_rows(cell, form, H, dev),
            max_abs_err=core_err, tolerance=tol, **core_t, **common))
        report(kernels, name + name_suffix, where, dict(
            cluster=C, rows_per_cluster=rows, clusters_at_once=at_once,
            max_abs_err=err, tolerance=tol,
            **kernel_ms(run, reps=5, launches=3),
            cuda_core_ms=core_t["ms"],
            cuda_core_device_ms=core_t["device_ms"], **common))
        rec = kernels[name + name_suffix][-1]
        log(f"{name} at {where}: {shape_of}, {rec['ms']:.4f} ms (device "
            f"{rec['device_ms']:.4f}), bound {bound:.4f} ms, library "
            f"{rec.get('library_ms')}, CUDA cores {rec['cuda_core_ms']:.4f}"
            + (f", weight-gradient products {rec['wgrad_products_ms']:.4f}"
               if not fwd else ""))
        torch.cuda.empty_cache()
    del xw32, xw, want_f, want_x, sf, sx
    torch.cuda.empty_cache()


def wide_seed_grid(torch, kernels, cell: str, hin, wx, b, wh, mm, dh,
                   where: str) -> None:
    """The seed grids at hidden 256 in bf16, S = 3 (m of seed extent 1,
    shared): the forwards and backwards on the cluster route and on the
    CUDA-core kernels (launched directly), each one counted launch (call)
    for all seeds and each seed bitwise equal to its one-seed call; the
    hoisted forwards and backwards timed beside their bound, three
    one-seed calls and the plain version."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    S = GRID_SEEDS
    B, T, H = hin.shape
    stack = (lambda t, f: torch.stack([t, f(t), t.flip(0)]))
    hin3 = stack(hin, lambda t: -t)
    wx3, wh3 = (stack(w, lambda t: 0.9 * t) for w in (wx, wh))
    b3 = stack(b, lambda t: -t)
    dh3 = stack(dh, lambda t: -t)
    m1 = mm[None]
    xw3 = (hin3.float() @ wx3.float()[:, None] + b3.float()[:, None, None]
           ).to(hin.dtype)
    one = {}
    with torch.no_grad():
        sf = R._fused_states(cell, hin3, wx3, b3, wh3, m1, 1.0, True)
        sx = R._scan_states_any(cell, xw3, wh3, m1, 1.0, True)
    core = R._launch_fwd
    calls = {
        "fused_fwd": (f"rnn_fused_fwd_cluster_{cell}",
                      lambda: R._fused_states(cell, hin3, wx3, b3, wh3, m1,
                                              1.0, True),
                      lambda s: R._fused_states(cell, hin3[s], wx3[s], b3[s],
                                                wh3[s], mm, 1.0, True)),
        "fwd": (f"rnn_fwd_cluster_{cell}",
                lambda: R._scan_states_any(cell, xw3, wh3, m1, 1.0, True),
                lambda s: R._scan_states_any(cell, xw3[s], wh3[s], mm, 1.0,
                                             True)),
        "fused_fwd_core": (f"rnn_fused_fwd_{cell}",
                           lambda: core(cell, False, hin3, wx3, b3, wh3, m1,
                                        1.0, True),
                           lambda s: core(cell, False, hin3[s], wx3[s], b3[s],
                                          wh3[s], mm, 1.0, True)),
        "fwd_core": (f"rnn_fwd_{cell}",
                     lambda: core(cell, True, xw3, None, None, wh3, m1, 1.0,
                                  True),
                     lambda s: core(cell, True, xw3[s], None, None, wh3[s],
                                    mm, 1.0, True)),
        "fused_bwd": (f"rnn_fused_bwd_cluster_{cell}",
                      lambda: R.rnn_scan_fused_bwd(cell, hin3, wx3, b3, wh3,
                                                   m1, *sf, dh3),
                      lambda s: R.rnn_scan_fused_bwd(
                          cell, hin3[s], wx3[s], b3[s], wh3[s], mm,
                          *(None if t is None else t[s] for t in sf),
                          dh3[s])),
        "bwd": (f"rnn_bwd_cluster_{cell}",
                lambda: R.rnn_scan_bwd(cell, xw3, wh3, m1, *sx, dh3),
                lambda s: R.rnn_scan_bwd(
                    cell, xw3[s], wh3[s], mm,
                    *(None if t is None else t[s] for t in sx), dh3[s])),
        "fused_bwd_core": (f"rnn_fused_bwd_{cell}",
                           lambda: R._launch_bwd(cell, True, hin3, wx3, b3,
                                                 wh3, m1, *sf, dh3, 1.0),
                           lambda s: R._launch_bwd(
                               cell, True, hin3[s], wx3[s], b3[s], wh3[s], mm,
                               *(None if t is None else t[s] for t in sf),
                               dh3[s], 1.0)),
        "bwd_core": (f"rnn_bwd_{cell}",
                     lambda: R._launch_bwd(cell, False, xw3, None, None, wh3,
                                           m1, *sx, dh3, 1.0),
                     lambda s: R._launch_bwd(
                         cell, False, xw3[s], None, None, wh3[s], mm,
                         *(None if t is None else t[s] for t in sx), dh3[s],
                         1.0))}
    for form, (name, run, single) in calls.items():
        _build.reset_launch_counts()
        with torch.no_grad():
            got = run()
        counts = _build.launch_counts()
        if counts[name] != 1 or sum(counts.values()) != 1:
            fail(f"{name} seed grid launched {counts}")
        seed_grid_held(torch, f"{name} seed grid", got, single, range(S))
        one[form] = got
        del got
    log(f"seed grids (S {S}, m shared) at {where}: the cluster and CUDA-core "
        f"forwards and backwards one launch each, every seed bitwise its "
        f"one-seed call")
    for form in ("fwd", "fwd_core", "bwd", "bwd_core"):
        name, run, single = calls[form]
        kind = "bwd" if form.startswith("bwd") else "fwd"
        if kind == "fwd":
            plain = (lambda: [R.rnn_scan_states(cell, xw3[s], wh3[s], mm, 1.0,
                                                True) for s in range(S)])
            err = 0.0
            for s in range(S):
                want = R.rnn_scan_states(cell, xw3[s], wh3[s], mm, 1.0, True)
                for g, w in zip((one[form][0][s], one[form][1][s]), want):
                    e, excess = worst_excess(g, w, BF16_TOL, BF16_TOL)
                    if excess > 0 or not torch.isfinite(g).all():
                        fail(f"{name} seed grid seed {s}: max err {e}")
                    err = max(err, e)
            library = dict(library_ms=None, library_note=NO_SEED_LIBRARY)
        else:
            args = [(cell, xw3[s], wh3[s], mm,
                     *(None if t is None else t[s] for t in sx), dh3[s])
                    for s in range(S)]
            plain = (lambda: [R.rnn_scan_bwd_reference(*a) for a in args])
            err = max(grads_close(f"{name} seed grid seed {s}",
                                  tuple(g[s] for g in one[form]),
                                  R.rnn_scan_bwd_reference(*args[s]),
                                  hin.dtype) for s in range(S))
            a = torch.randn(S, H, B * T, device="cuda")
            d = torch.randn(S, B * T, GATES[cell] * H, device="cuda")
            library = dict(library_ms=time_ms(lambda: torch.bmm(a, d),
                                              reps=3))
            del a, d
        bound, by = rnn_bound(kind, cell, B, T, H, hin.element_size(),
                              kind == "fwd", seeds=S)
        blocks = (dict(rows_per_block=R._simt_rows(cell, kind, H,
                                                   hin.device))
                  if form.endswith("_core") else {})
        report(kernels, f"{name}_seeds", where, dict(
            shape=[S, B, T, H], dtype=str(hin.dtype).replace("torch.", ""),
            shared="m", **blocks, bitwise_vs_single=True,
            seeds_checked=S, max_abs_err=err,
            tolerance=(f"atol {BF16_TOL} + rtol {BF16_TOL}" if kind == "fwd"
                       else f"scaled atol {BF16_TOL}"),
            **kernel_ms(run, reps=2, launches=1),
            single_seed_loop_ms=time_ms(lambda: [single(s) for s in range(S)],
                                        reps=2, warmup=1),
            plain_ms=time_ms(plain, reps=1, warmup=1), bound_ms=bound,
            bound_by=by, **library))
    del one, sf, sx, hin3, wx3, wh3, b3, dh3, xw3
    torch.cuda.empty_cache()


def f32_wide_rows(torch, kernels, gen) -> None:
    """Phase 28's float32 rows 4 and 2 above 128 (B 2048, T 60, seeded
    weights at H^-1/2, both cells) at :data:`F32_WIDE_WIDTHS`, through
    :func:`f32_bwd_rows`: the 3xTF32 cluster (its size, rows and clusters
    at once) up to ``TF32_MAX_WIDTH`` and the grid (its group, rows and
    groups) past it, beside ``rnn_bwd.cu`` on the same inputs (also
    recorded under its own name), the plain version, both bounds and
    cuDNN's f32 backward. At hidden 256 the route's seed grids (S 3, W_h
    shared; fused and hoisted: one counted call, each seed bitwise its
    one-seed call); at
    :data:`PAST_CAP_HIDDEN` rows 3 and 1 on the float32 grid forward in
    turns with ``rnn_fused_fwd.cu`` (:func:`f32_fwd_rows`), row 4 handed
    the forward's xw (:func:`xw_handover`), row 4's split by kernel and
    barrier wait (:func:`grid_split`) and the grids' seed grids
    (:func:`grid_seeds`, :func:`fwd_grid_seeds`); rows 3 and 1 at
    :data:`F32_FWD_WIDEST` on the grid forward alone (held, timed once).
    Then a cluster the card refuses (the LSTM's 176 on 2 CTAs) and grids
    it cannot hold at once (one group more than it takes, backward and
    forward), which must raise."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T = 2048, 60
    f32 = dict(generator=gen, device="cuda")
    for H in F32_WIDE_WIDTHS:
        for cell in ("lstm", "gru"):
            G = GATES[cell] * H
            sd = H ** -0.5
            hin = torch.randn(B, T, H, **f32)
            wx, wh = (sd * torch.randn(H, G, **f32) for _ in range(2))
            bb = 0.1 * torch.randn(G, **f32)
            mm = torch.rand(B, T, **f32) < 0.75
            dh = 0.1 * torch.randn(B, T, H, **f32)
            xw = hin @ wx + bb
            with torch.no_grad():
                h, c = R.rnn_scan_states(cell, xw, wh, mm, 1.0, True)
            where = f"B {B}, T {T}, H {H}"
            f32_bwd_rows(torch, kernels, where, cell, hin, wx, bb, wh, mm, h,
                         c, dh, xw, plain_reps=1,
                         name_suffix=f"@h{H}" if H in (384, 640, 1024)
                         else "")
            if H == PAST_CAP_HIDDEN:
                with torch.no_grad():
                    f32_fwd_rows(torch, kernels, where, cell, hin, wx, bb,
                                 wh, mm, xw)
                xw_handover(torch, kernels, where, cell, hin, wx, bb, wh, mm,
                            dh)
                grid_split(torch, kernels, where, cell, hin, wx, bb, wh, mm,
                           h, c, dh)
                if cell == "lstm":
                    grid_seeds(torch, kernels, cell, hin, wx, bb, wh, mm, dh,
                               xw)
                    fwd_grid_seeds(torch, kernels, cell, hin, wx, bb, wh, mm,
                                   xw)
            if H == WIDE_HIDDEN and cell == "lstm":
                S = GRID_SEEDS
                stack = (lambda t, f: torch.stack([t, f(t), t.flip(0)]))
                xw3, hin3, dh3 = (stack(t, lambda v: -v)
                                  for t in (xw, hin, dh))
                wx3, b3 = stack(wx, lambda v: 0.9 * v), stack(bb, lambda v: -v)
                m3 = stack(mm, lambda v: ~v)
                with torch.no_grad():
                    sx = R._scan_states_any(cell, xw3, wh[None], m3, 1.0,
                                            True)
                    sf = R._fused_states(cell, hin3, wx3, b3, wh[None], m3,
                                         1.0, True)
                for name, run, single in (
                        (f32_route_names(cell, H, False)[1],
                         lambda: R.rnn_scan_bwd(cell, xw3, wh[None], m3, *sx,
                                                dh3),
                         lambda s: R.rnn_scan_bwd(
                             cell, xw3[s], wh, m3[s],
                             *(None if t is None else t[s] for t in sx),
                             dh3[s])),
                        (f32_route_names(cell, H, True)[1],
                         lambda: R.rnn_scan_fused_bwd(cell, hin3, wx3, b3,
                                                      wh[None], m3, *sf, dh3),
                         lambda s: R.rnn_scan_fused_bwd(
                             cell, hin3[s], wx3[s], b3[s], wh, m3[s],
                             *(None if t is None else t[s] for t in sf),
                             dh3[s]))):
                    _build.reset_launch_counts()
                    got = run()
                    counts = _build.launch_counts()
                    if counts[name] != 1 or sum(counts.values()) != 1:
                        fail(f"{name} seed grid at H {H}: launched {counts}")
                    seed_grid_held(torch, f"{name} seed grid (float32, H "
                                   f"{H}, W_h shared)", got, single,
                                   range(S))
                    del got
                log(f"float32 seed grids at H {H} (S {S}, W_h shared): the "
                    f"backwards of the route one call each, every seed "
                    f"bitwise its one-seed call")
                del xw3, hin3, dh3, wx3, b3, m3, sx, sf
            del hin, wx, wh, bb, mm, dh, xw, h, c
            torch.cuda.empty_cache()
    # No fallback: a cluster the card cannot hold raises.
    hin = torch.randn(16, 3, 176, **f32)
    wx, wh = (176 ** -0.5 * torch.randn(176, 704, **f32) for _ in range(2))
    bb = torch.zeros(704, device="cuda")
    mm = torch.ones(16, 3, dtype=torch.bool, device="cuda")
    h, c = R.rnn_scan_states("lstm", hin @ wx + bb, wh, mm, 1.0, True)
    _build.reset_launch_counts()
    try:
        R._launch_bwd_tf32("lstm", True, hin, wx, bb, wh, mm, h, c, h, 1.0,
                           cluster=2, rows=16)
    except ValueError as exc:
        log(f"the LSTM at H 176 on 2 CTAs is refused: {exc}")
    else:
        fail("the LSTM at H 176 ran on 2 CTAs, past the card's shared "
             "memory")
    if any(_build.launch_counts().values()):
        fail(f"a refused cluster launched {_build.launch_counts()}")
    del hin, wx, wh, bb, mm, h, c
    # Nor a grid: one group more than the card holds at once raises.
    hin = torch.randn(37, 3, 400, **f32)
    wx, wh = (400 ** -0.5 * torch.randn(400, 1600, **f32) for _ in range(2))
    bb = torch.zeros(1600, device="cuda")
    mm = torch.ones(37, 3, dtype=torch.bool, device="cuda")
    h, c = R.rnn_scan_states("lstm", hin @ wx + bb, wh, mm, 1.0, True)
    shape = grid_shape(torch, "lstm", 37, 400, hin.device)
    n, ctas = shape["group"], shape["ctas_at_once"]
    _build.reset_launch_counts()
    try:
        R._launch_bwd_grid("lstm", True, hin, wx, bb, wh, mm, h, c, h, 1.0,
                           group=n, rows=64, groups=ctas // n + 1)
    except RuntimeError as exc:
        log(f"the LSTM at H 400 on {ctas // n + 1} groups of {n} CTAs "
            f"({ctas} at once) is refused: {exc}")
    else:
        fail(f"the LSTM at H 400 ran {ctas // n + 1} groups of {n} CTAs, "
             f"more than the card's {ctas} at once")
    if any(_build.launch_counts().values()):
        fail(f"a refused grid launched {_build.launch_counts()}")
    # And the float32 grid forward: refused before any launch, its xw GEMM
    # included.
    props = torch.cuda.get_device_properties(hin.device)
    n = R._fwd_grid_size("lstm", 400, props.shared_memory_per_block_optin,
                         props.multi_processor_count)
    ctas = R._fwd_grid_check("lstm", True, 400, n, 64, hin.device)
    _build.reset_launch_counts()
    try:
        R._launch_fwd_grid("lstm", True, hin, wx, bb, wh, mm, 1.0, True,
                           group=n, rows=64, groups=ctas // n + 1)
    except RuntimeError as exc:
        log(f"the float32 LSTM forward at H 400 on {ctas // n + 1} groups "
            f"of {n} CTAs ({ctas} at once) is refused: {exc}")
    else:
        fail(f"the float32 LSTM forward at H 400 ran {ctas // n + 1} groups "
             f"of {n} CTAs, more than the card's {ctas} at once")
    if any(_build.launch_counts().values()):
        fail(f"a refused grid forward launched {_build.launch_counts()}")
    del hin, wx, wh, bb, mm, h, c
    torch.cuda.empty_cache()
    # The float32 grid forward at its widest: one group of 128 CTAs.
    H = F32_FWD_WIDEST
    for cell in ("lstm", "gru"):
        G = GATES[cell] * H
        hin = torch.randn(B, T, H, **f32)
        wx, wh = (H ** -0.5 * torch.randn(H, G, **f32) for _ in range(2))
        bb = 0.1 * torch.randn(G, **f32)
        mm = torch.rand(B, T, **f32) < 0.75
        with torch.no_grad():
            f32_fwd_rows(torch, kernels, f"B {B}, T {T}, H {H}", cell, hin,
                         wx, bb, wh, mm, hin @ wx + bb, before=False,
                         name_suffix=f"@h{H}")
        del hin, wx, wh, bb, mm
        torch.cuda.empty_cache()


def core_bf16_rows(torch, kernels, gen) -> None:
    """Rows 4 and 2 in bf16 at :data:`CORE_BF16_HIDDEN` (B 2048, T 60,
    seeded weights at H^-1/2, both cells) on the bf16 grid backward
    (``rnn_bwd_grid.cu``, the route past 512): through the public
    backwards, one counted call each, bitwise repeatable, within the bf16
    bound of the plain version (gradients scaled, 0.05), timed beside the
    bound, the plain version and cuDNN's backward and in turns with
    ``rnn_bwd.cu`` on the same inputs (grid, CUDA cores, CUDA cores, grid;
    ``rnn_bwd.cu`` held to the plain version too and recorded under its own
    name: the table's "[before]"); rows 3 and 1 there on the bf16 grid
    forward (:func:`fwd_grid_rows`, with the fused row 4 handed its xw);
    the LSTM's seed grids there (:func:`grid_seeds`); and rows 4 and 3 of
    the LSTM at the grids' widest Hp, :data:`BF16_GRID_WIDEST`, against
    cuDNN (suffixed records)."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T = 2048, 60
    bf = torch.bfloat16
    rnd = dict(generator=gen, device="cuda")
    for cell, H in (("lstm", CORE_BF16_HIDDEN), ("gru", CORE_BF16_HIDDEN),
                    ("lstm", BF16_GRID_WIDEST)):
        widest = H == BF16_GRID_WIDEST
        G = GATES[cell] * H
        hin = torch.randn(B, T, H, **rnd).to(bf)
        wx, wh = ((H ** -0.5 * torch.randn(H, G, **rnd)).to(bf)
                  for _ in range(2))
        b = (0.1 * torch.randn(G, **rnd)).to(bf)
        mm = torch.rand(B, T, **rnd) < 0.75
        dh = (0.1 * torch.randn(B, T, H, **rnd)).to(bf)
        xw32 = hin.float() @ wx.float() + b.float()
        xw = xw32.to(bf)
        where = f"B {B}, T {T}, H {H}"
        dev = hin.device
        for kind, fused in (("fused_bwd", True), ("bwd", False)):
            if widest and not fused:
                continue
            form = "fused_" if fused else ""
            name = f"rnn_{form}bwd_grid_bf16_{cell}"
            core_name = f"rnn_{form}bwd_{cell}"
            h, c = R.rnn_scan_states(cell, xw32 if fused else xw, wh, mm,
                                     1.0, True)
            h, c = h.to(bf), None if c is None else c.to(bf)
            if fused:
                args = (cell, hin, wx, b, wh, mm, h, c, dh)
                public, plain = (R.rnn_scan_fused_bwd,
                                 R.rnn_scan_fused_bwd_reference)
                simt_args = args[1:]
            else:
                args = (cell, xw, wh, mm, h, c, dh)
                public, plain = R.rnn_scan_bwd, R.rnn_scan_bwd_reference
                simt_args = (xw, None, None) + args[2:]
            if R._mma_route(bf, H, "bwd") != "grid":
                fail(f"bf16 hidden {H} is not on the bf16 grid")
            want = plain(*args)
            _build.reset_launch_counts()
            got = public(*args)
            counts = _build.launch_counts()
            if counts[name] != 1 or sum(counts.values()) != 1:
                fail(f"{name} at {where}: launched {counts}")
            again = public(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                fail(f"{name} at {where}: two calls differ")
            err = grads_close(f"{name} at {where}", got, want, bf)
            del got, again

            def run(a=args, f=public):
                return f(*a)

            def core(a=simt_args, f=fused):
                return R._launch_bwd(cell, f, *a, 1.0)

            core_rec = {}
            if not widest:
                _build.reset_launch_counts()
                got = core()
                if _build.launch_counts()[core_name] != 1:
                    fail(f"{core_name} (bf16) at {where}: launched "
                         f"{_build.launch_counts()}")
                core_rec["max_abs_err"] = grads_close(
                    f"{core_name} (bf16) at {where}", got, want, bf)
                del got
            del want
            library = cudnn_bwd_yardstick(torch, cell, hin if fused else xw,
                                          wx, b, wh, dh, hoisted=not fused)
            torch.cuda.empty_cache()
            bound, by = rnn_bound(kind, cell, B, T, H, 2)
            common = dict(shape=[B, T, H], dtype="bfloat16",
                          tolerance=f"scaled atol {BF16_TOL}",
                          plain_ms=time_ms(lambda a=args, f=plain: f(*a),
                                           reps=1, warmup=1),
                          bound_ms=bound, bound_by=by, **library)
            rec = dict(max_abs_err=err, bitwise_repeatable=True,
                       **kernel_ms(run, reps=2, launches=1), **common)
            props = torch.cuda.get_device_properties(dev)
            limit, sms = (props.shared_memory_per_block_optin,
                          props.multi_processor_count)
            n = R._grid_size(cell, H, limit, sms, bf)
            rows = R._grid_rows(cell, H, n, B, 1, limit, sms, bf)
            ctas = R._grid_check(cell, H, n, rows, dev, bf)
            rec.update(group=n, rows=rows, groups=min(ctas // n,
                                                      -(-B // rows)),
                       ctas_at_once=ctas)
            if not widest:
                # In turns with rnn_bwd.cu on the same inputs.
                cc = kernel_ms(core, reps=1, launches=1)
                again = time_ms(core, reps=1, warmup=0)
                rec.update(cuda_core_ms=cc["ms"],
                           cuda_core_device_ms=cc["device_ms"],
                           cuda_core_max_abs_err=core_rec["max_abs_err"],
                           turns_ms=dict(grid=[rec["ms"],
                                               time_ms(run, reps=2)],
                                         cuda_core=[cc["ms"], again]))
                report(kernels, core_name, where, dict(
                    core_rec, rows_per_block=R._simt_rows(cell, kind, H,
                                                          dev), **cc,
                    **common))
            report(kernels, name + ("@h%d" % H if widest else ""), where,
                   rec)
            log(f"{name} at {where}: {rec['groups']} groups of {n} CTAs x "
                f"{rows} rows, {rec['ms']:.4f} ms (device "
                f"{rec['device_ms']:.4f})"
                + (f", in turns {rec['turns_ms']}, rnn_bwd.cu "
                   f"{rec['cuda_core_ms']:.4f}" if not widest else "")
                + f", bound {bound:.4f}, plain {rec['plain_ms']:.4f}, "
                f"library {rec['library_ms']}, max err {err:.3g}")
            del h, c
            torch.cuda.empty_cache()
        fwd_grid_rows(torch, kernels, where, cell, hin, wx, b, wh, mm, xw,
                      dh, widest)
        if cell == "lstm" and not widest:
            grid_seeds(torch, kernels, cell, hin, wx, b, wh, mm, dh, xw)
        del hin, wx, wh, b, mm, dh, xw32, xw
        torch.cuda.empty_cache()


def fwd_grid_rows(torch, kernels, where: str, cell: str, hin, wx, b, wh, mm,
                  xw, dh, widest: bool = False) -> None:
    """Rows 3 and 1 in bf16 past 512 on the bf16 grid forward
    (``rnn_fwd_grid.cu``, the route to Hp 1520), saving c_all as training
    does: through the public forwards (``_fused_states``,
    ``_scan_states_any``), one counted launch each and nothing else, h_all
    and c_all within atol 0.05 + rtol 0.05 of the plain version, bitwise
    repeatable and the same bits from a larger group, from one of about
    half the CTAs (at 528 the fewest that fit: the backward's rule), from
    128 rows a work item and from one group; timed beside the bound, the
    plain version, cuDNN's forward and ``rnn_fused_fwd.cu`` on the same inputs in turns
    (grid, CUDA cores, CUDA cores, grid; ``rnn_fused_fwd.cu`` held to the
    plain version too and recorded as ``<name>@h<H>``: the table's
    "[before]"), with the group, rows and groups chosen, the barrier waits
    (the kernel's own clock), the recurrence's device time and share of
    row 3 (``torch.profiler``; "not measured" where it sees no device time)
    and the all-gather's bytes and rate. Then the fused row 4 handed the
    forward's xw (:func:`xw_handover`), the LSTM's seed grids
    (:func:`fwd_grid_seeds`) and a grid past the card, refused before any
    launch. ``widest``: row 3 alone, timed beside the bound, the plain
    version and cuDNN (``<name>@h<H>``)."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    bf = torch.bfloat16
    dev = hin.device
    if R._mma_route(bf, H) != "grid":
        fail(f"the bf16 forward at hidden {H} is not on the grid")
    props = torch.cuda.get_device_properties(dev)
    limit, sms = (props.shared_memory_per_block_optin,
                  props.multi_processor_count)
    xw32 = hin.float() @ wx.float() + b.float()
    for kind, fused in (("fused_fwd", True), ("fwd", False)):
        if widest and not fused:
            continue
        form = "fused_" if fused else ""
        name = f"rnn_{form}fwd_grid_bf16_{cell}"
        core_name = f"rnn_{form}fwd_{cell}"
        xin, xwx, xb = (hin, wx, b) if fused else (xw, None, None)
        if fused:
            run = (lambda: R._fused_states(cell, hin, wx, b, wh, mm, 1.0,
                                           True))
            want = R.rnn_scan_states(cell, xw32, wh, mm, 1.0, True)
            plain = (lambda: R.rnn_scan_fused_reference(cell, hin, wx, b, wh,
                                                        mm))
            library = cudnn_yardstick(torch, cell, hin, wx, b, wh, BF16_TOL,
                                      BF16_TOL)
        else:
            run = (lambda: R._scan_states_any(cell, xw, wh, mm, 1.0, True))
            want = R.rnn_scan_states(cell, xw, wh, mm, 1.0, True)
            plain = (lambda: R.rnn_scan_reference(cell, xw, wh, mm))
            library = hoisted_yardstick(torch, cell, xw, wh, BF16_TOL,
                                        BF16_TOL)

        def held(label, out):
            err = 0.0
            for got, ref in zip(out, want):
                if got is None:  # the GRU has no c_all
                    continue
                e, excess = worst_excess(got, ref, BF16_TOL, BF16_TOL)
                if excess > 0 or not torch.isfinite(got.float()).all():
                    fail(f"{label} (bf16) at {where}: max err {e}")
                err = max(err, e)
            return err

        _build.reset_launch_counts()
        out = run()
        counts = _build.launch_counts()
        if counts[name] != 1 or sum(counts.values()) != 1:
            fail(f"{name} at {where}: launched {counts}")
        err = held(name, out)
        again = run()
        if not all(torch.equal(p, q) for p, q in zip(out, again)
                   if p is not None):
            fail(f"{name} at {where}: two calls differ")
        del again
        n = R._fwd_grid_size(cell, H, limit, sms, bf)
        rows = R._fwd_grid_rows(cell, H, n, limit, sms, bf)
        pairs = [] if widest else [dict(group=n, rows=64, groups=1)]
        for other in ((n + 3, n // 2 + 1) if not widest else ()):
            for r in R.GRID_ROWS:
                if (other <= sms and R._grid_takes(H, other, r, bf)
                        and R._fwd_grid_smem(cell, H, other, r, bf)
                        <= limit):
                    pairs.append(dict(group=other, rows=r))
        for kw in pairs:
            other = R._launch_fwd_grid(cell, fused, xin, xwx, xb, wh, mm,
                                       1.0, True, **kw)
            if not all(torch.equal(p, q) for p, q in zip(out, other)
                       if p is not None):
                fail(f"{name} at {where}: {kw} changes the bits")
            del other
        del out
        stats = {}
        R._launch_fwd_grid(cell, fused, xin, xwx, xb, wh, mm, 1.0, True,
                           stats=stats)
        torch.cuda.synchronize()
        cyc = stats["cycles"].double().cpu()
        share = cyc[:, 0] / cyc[:, 1]
        bound, by = rnn_bound(kind, cell, B, T, H, 2, save_c=True)
        rec = dict(shape=[B, T, H], dtype="bfloat16", save_c=True,
                   max_abs_err=err, tolerance=f"atol {BF16_TOL} + rtol "
                   f"{BF16_TOL}", bitwise_repeatable=True,
                   bitwise_at=[dict(group=n, rows=rows)] + pairs,
                   group=n, rows=rows, groups=stats["groups"],
                   ctas_at_once=stats["ctas_at_once"],
                   kernels_a_call=stats["kernels"],
                   barrier_wait_share_mean=float(share.mean()),
                   barrier_wait_share_max=float(share.max()),
                   **kernel_ms(run, reps=3, launches=2),
                   plain_ms=time_ms(plain, reps=1, warmup=1),
                   bound_ms=bound, bound_by=by, **library)
        if not widest:
            # In turns with rnn_fused_fwd.cu on the same inputs.
            def core(a=(xin, xwx, xb), f=fused):
                return R._launch_fwd(cell, not f, *a, wh, mm, 1.0, True)

            core_err = held(core_name, core())
            cc = kernel_ms(core, reps=1, launches=1)
            rec.update(cuda_core_ms=cc["ms"],
                       cuda_core_device_ms=cc["device_ms"],
                       cuda_core_max_abs_err=core_err,
                       turns_ms=dict(grid=[rec["ms"],
                                           time_ms(run, reps=2)],
                                     cuda_core=[cc["ms"], time_ms(
                                         core, reps=1, warmup=0)]))
            report(kernels, f"{core_name}@h{H}", where, dict(
                shape=[B, T, H], dtype="bfloat16", save_c=True,
                max_abs_err=core_err, rows_per_block=R._simt_rows(
                    cell, kind, H, dev), **cc, plain_ms=rec["plain_ms"],
                bound_ms=bound, bound_by=by, **library))
            # The recurrence's device time, and the all-gather: every CTA
            # of a group reads the group's whole h_{t-1} row block each
            # step but the first.
            by_name = profile_device(
                torch, lambda: [R._launch_fwd_grid(
                    cell, fused, xin, xwx, xb, wh, mm, 1.0, True)
                    for _ in range(2)], f"{name} ({where})")
            recur = sum(ms for k, ms in by_name.items()
                        if "rnn_fwd_grid_kernel" in k) / 2
            gathered = (T - 1) * -(-B // rows) * n * rows * H * 2
            rec.update(
                recurrence_device_ms=recur or "not measured",
                recurrence_share=(recur / (sum(by_name.values()) / 2)
                                  if recur else "not measured"),
                barrier_wait_ms=(float(share.mean()) * recur if recur
                                 else "not measured"),
                all_gather_bytes=gathered,
                all_gather_gb_per_s=(gathered / recur / 1e6 if recur
                                     else "not measured"))
        report(kernels, name + ("@h%d" % H if widest else ""), where, rec)
        log(f"{name} at {where}: {rec['groups']} groups of {n} CTAs x "
            f"{rows} rows ({stats['kernels']} kernels), {rec['ms']:.4f} ms "
            f"(device {rec['device_ms']:.4f})"
            + (f", in turns {rec['turns_ms']}, rnn_fused_fwd.cu "
               f"{rec['cuda_core_ms']:.4f}; recurrence "
               f"{rec['recurrence_device_ms']} ms device" if not widest
               else "")
            + f"; barrier waits {100 * float(share.mean()):.1f}% of the "
            f"recurrence's cycles; bound {bound:.4f}, plain "
            f"{rec['plain_ms']:.4f}, library {rec['library_ms']}, max err "
            f"{err:.3g}; bitwise at {rec['bitwise_at']}")
        torch.cuda.empty_cache()
    if widest:
        return
    xw_handover(torch, kernels, where, cell, hin, wx, b, wh, mm, dh)
    if cell == "lstm":
        fwd_grid_seeds(torch, kernels, cell, hin, wx, b, wh, mm, xw)
    # A grid of one group more than the card holds: refused before any
    # launch, the xw GEMM included.
    n = R._fwd_grid_size(cell, H, limit, sms, bf)
    ctas = R._fwd_grid_check(cell, True, H, n, 64, dev, bf)
    _build.reset_launch_counts()
    try:
        R._launch_fwd_grid(cell, True, hin, wx, b, wh, mm, 1.0, True,
                           group=n, rows=64, groups=ctas // n + 1)
    except RuntimeError as exc:
        if any(_build.launch_counts().values()):
            fail(f"a refused grid forward counted a launch: {exc}")
        log(f"the {cell} forward at H {H} on {ctas // n + 1} groups of {n} "
            f"CTAs ({ctas} at once) is refused: {exc}")
    else:
        fail(f"the {cell} forward at H {H} on {ctas // n + 1} groups of {n} "
             f"CTAs ran: the card holds {ctas} at once")


def xw_handover(torch, kernels, where: str, cell: str, hin, wx, b, wh, mm,
                dh) -> None:
    """The fused row 4 on the grid handed the grid forward's f32 xw
    scratch (as ``_FusedScan`` hands it over), in ``hin``'s dtype: five
    kernels, where the row 4 that forms its own xw launches six. bf16:
    every gradient bitwise that row 4's (both xw GEMMs are one call of the
    same GEMM); float32: every gradient within the scaled f32 bound of it
    and of the plain version (the forward's xw is a CUDA-core f32 sum, the
    backward's own a 3xTF32 GEMM). Both timed in turns, each given a fresh
    copy of the scratch outside the timed window, and on the device alone,
    as ``rnn_fused_bwd_grid_[bf16_]<cell>_xw``."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    bf = hin.dtype == torch.bfloat16
    tag = "bf16_" if bf else ""
    with torch.no_grad():
        h, c, xw = R._launch_fwd_grid(cell, True, hin, wx, b, wh, mm, 1.0,
                                      True, keep_xw=True)
    saved = xw.clone()
    own, given = {}, {}
    want = R._launch_bwd_grid(cell, True, hin, wx, b, wh, mm, h, c, dh, 1.0,
                              stats=own)
    got = R._launch_bwd_grid(cell, True, hin, wx, b, wh, mm, h, c, dh, 1.0,
                             xw=xw, stats=given)
    if (own["kernels"], given["kernels"]) != (6, 5):
        fail(f"the fused {hin.dtype} grid backward at {where} launched "
             f"{own['kernels']} kernels on its own xw, {given['kernels']} "
             f"on the forward's, not 6 and 5")
    if bf:
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"the fused bf16 grid backward at {where}: the forward's "
                 f"xw changes the bits")
        err = 0.0
    else:
        plain = R.rnn_scan_fused_bwd_reference(
            cell, *(t.double() for t in (hin, wx, b, wh)), mm,
            *(None if t is None else t.double() for t in (h, c, dh)))
        err = max(grads_close(f"row 4 on the forward's xw at {where}", got,
                              plain, torch.float32),
                  grads_close(f"row 4 on the forward's xw against its own "
                              f"at {where}", got, want, torch.float32))
        del plain
    del got, want

    def timed(fn, setup, reps=3):
        times = []
        for _ in range(reps):
            setup()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    refill = (lambda: xw.copy_(saved))
    mine = (lambda: R._launch_bwd_grid(cell, True, hin, wx, b, wh, mm, h, c,
                                       dh, 1.0))
    handed = (lambda: R._launch_bwd_grid(cell, True, hin, wx, b, wh, mm, h,
                                         c, dh, 1.0, xw=xw))
    turns = dict(own=[timed(mine, refill)], given=[timed(handed, refill)])
    turns["given"].append(timed(handed, refill))
    turns["own"].append(timed(mine, refill))
    # The device alone: the scratch's values set no kernel's work, so the
    # calls queued back to back run on what the last one left.
    rec = dict(shape=[B, T, H], dtype=str(hin.dtype).replace("torch.", ""),
               bitwise_vs_own_xw=bf, max_scaled_err=err,
               kernels_given_xw=given["kernels"],
               kernels_own_xw=own["kernels"], turns_ms=turns,
               ms=statistics.median(turns["given"]),
               device_ms=device_ms(handed, reps=3, launches=2),
               own_xw_ms=statistics.median(turns["own"]),
               own_xw_device_ms=device_ms(mine, reps=3, launches=2))
    report(kernels, f"rnn_fused_bwd_grid_{tag}{cell}_xw", where, rec)
    log(f"row 4 on the {hin.dtype} grid at {where} handed the forward's "
        f"xw: {given['kernels']} kernels (own xw: {own['kernels']}), "
        + ("bitwise the same" if bf else f"within {err:.3g} (scaled)")
        + f"; in turns {turns} ms; device {rec['device_ms']:.4f} (own "
        f"{rec['own_xw_device_ms']:.4f})")
    del h, c, xw, saved
    torch.cuda.empty_cache()


def fwd_grid_seeds(torch, kernels, cell: str, hin, wx, b, wh, mm,
                   xw) -> None:
    """The grid forward's seed grids (``_fwd_vmap`` :920,
    ``_make_scan._fwd_vmap`` :504; S 3, W_h shared) in ``hin``'s dtype:
    rows 3 and 1 one counted launch each, each seed bitwise its one-seed
    call; row 1 held to the plain version per seed and timed beside its
    bound, three one-seed calls and the plain version, as
    ``rnn_fwd_grid_[bf16_]<cell>_seeds``."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    S = GRID_SEEDS
    B, T, H = hin.shape
    bf = hin.dtype == torch.bfloat16
    tag, dname = ("bf16_", "bf16") if bf else ("", "float32")
    atol, rtol = (BF16_TOL, BF16_TOL) if bf else (F32_TOL, 0.0)
    stack = (lambda t, f: torch.stack([t, f(t), t.flip(0)]))
    xw3, hin3 = (stack(t, lambda v: -v) for t in (xw, hin))
    wx3, b3 = stack(wx, lambda v: 0.9 * v), stack(b, lambda v: -v)
    m3 = stack(mm, lambda v: ~v)
    err = 0.0
    with torch.no_grad():
        for name, run, single in (
                (f"rnn_fwd_grid_{tag}{cell}",
                 lambda: R._scan_states_any(cell, xw3, wh[None], m3, 1.0,
                                            True),
                 lambda s: R._scan_states_any(cell, xw3[s], wh, m3[s], 1.0,
                                              True)),
                (f"rnn_fused_fwd_grid_{tag}{cell}",
                 lambda: R._fused_states(cell, hin3, wx3, b3, wh[None], m3,
                                         1.0, True),
                 lambda s: R._fused_states(cell, hin3[s], wx3[s], b3[s], wh,
                                           m3[s], 1.0, True))):
            _build.reset_launch_counts()
            got = run()
            counts = _build.launch_counts()
            if counts[name] != 1 or sum(counts.values()) != 1:
                fail(f"{name} seed grid at H {H}: launched {counts}")
            seed_grid_held(torch, f"{name} seed grid ({dname}, H {H}, "
                           f"W_h shared)", got, single, range(S))
            if name.startswith("rnn_fwd_"):
                for s in range(S):
                    want = R.rnn_scan_states(cell, xw3[s], wh, m3[s], 1.0,
                                             True)
                    for g, w in zip(got, want):
                        if w is None:
                            continue
                        e, excess = worst_excess(g[s], w, atol, rtol)
                        if excess > 0:
                            fail(f"{name} seed grid seed {s}: max err {e}")
                        err = max(err, e)
            del got
        bound, by = rnn_bound("fwd", cell, B, T, H, hin.element_size(),
                              save_c=True, seeds=S)
        hoisted = (lambda: R._scan_states_any(cell, xw3, wh[None], m3, 1.0,
                                              True))
        rec = dict(shape=[S, B, T, H], dtype=str(hin.dtype)[6:],
                   shared="W_h", bitwise_vs_single=True, seeds_checked=S,
                   max_abs_err=err, tolerance=f"atol {atol} + rtol {rtol}",
                   **kernel_ms(hoisted, reps=3, launches=1),
                   single_seed_loop_ms=time_ms(lambda: [
                       R._scan_states_any(cell, xw3[s], wh, m3[s], 1.0, True)
                       for s in range(S)], reps=2, warmup=1),
                   plain_ms=time_ms(lambda: [R.rnn_scan_reference(
                       cell, xw3[s], wh, m3[s]) for s in range(S)], reps=1,
                       warmup=1),
                   bound_ms=bound, bound_by=by, library_ms=None,
                   library_note=NO_SEED_LIBRARY)
    report(kernels, f"rnn_fwd_grid_{tag}{cell}_seeds",
           f"B {B}, T {T}, H {H}", rec)
    log(f"grid forward seed grids at H {H} (S {S}, W_h shared): one launch "
        f"each, every seed bitwise its one-seed call; hoisted "
        f"{rec['ms']:.4f} ms against {S} one-seed calls' "
        f"{rec['single_seed_loop_ms']:.4f}, max err {err:.3g}")
    del xw3, hin3, wx3, b3, m3
    torch.cuda.empty_cache()


def fwd_grid_widths(torch, gen) -> None:
    """Rows 3 and 1 in bf16 on the grid forward past 528 (B 256, T 12,
    seeded weights at H^-1/2, both cells; an all-invalid row): at
    :data:`FWD_GRID_WIDTHS` (H 530 zero-padded to 544 through the public
    forwards' ``padded_launch``; the widest, 1520, row 3 alone) within
    atol 0.05 + rtol 0.05 of the plain version, one counted launch, the
    all-invalid row exactly zero, bitwise repeatable."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T = 256, 12
    rnd = dict(generator=gen, device="cuda")
    for H in FWD_GRID_WIDTHS:
        for cell in ("lstm", "gru"):
            G = GATES[cell] * H
            hin = torch.randn(B, T, H, **rnd).to(torch.bfloat16)
            wx, wh = ((H ** -0.5 * torch.randn(H, G, **rnd)).to(
                torch.bfloat16) for _ in range(2))
            b = (0.1 * torch.randn(G, **rnd)).to(torch.bfloat16)
            mm = torch.rand(B, T, **rnd) < 0.75
            mm[0] = False
            xw32 = hin.float() @ wx.float() + b.float()
            xw = xw32.to(torch.bfloat16)
            for fused in ((True,) if H == BF16_GRID_WIDEST
                          else (True, False)):
                name = f"rnn_{'fused_' if fused else ''}fwd_grid_bf16_{cell}"
                run = ((lambda: R._fused_states(cell, hin, wx, b, wh, mm, 1.0,
                                                True)) if fused else
                       (lambda: R._scan_states_any(cell, xw, wh, mm, 1.0,
                                                   True)))
                with torch.no_grad():
                    _build.reset_launch_counts()
                    out = run()
                    counts = _build.launch_counts()
                    if counts[name] != 1 or sum(counts.values()) != 1:
                        fail(f"{name} at H {H}: launched {counts}")
                    want = R.rnn_scan_states(cell, xw32 if fused else xw,
                                             wh, mm, 1.0, True)
                    err = 0.0
                    for got, ref in zip(out, want):
                        if ref is None:
                            continue
                        e, excess = worst_excess(got, ref, BF16_TOL,
                                                 BF16_TOL)
                        if (excess > 0 or got[0].float().any()
                                or not torch.isfinite(got.float()).all()):
                            fail(f"{name} at B {B}, T {T}, H {H}: max err "
                                 f"{e}, all-invalid row zero: "
                                 f"{not got[0].float().any()}")
                        err = max(err, e)
                    if not all(torch.equal(p, q) for p, q in zip(out, run())
                               if p is not None):
                        fail(f"{name} at H {H}: two calls differ")
                log(f"{name} at B {B}, T {T}, H {H} (Hp "
                    f"{R._padded_width(H)}): within {err:.3g} of the plain "
                    f"version, bitwise repeatable")
            del hin, wx, wh, b, mm, xw32, xw
            torch.cuda.empty_cache()


#: The grid recurrence's kernels by name (substrings of the profiler's
#: names) → the part of row 4 each is.
GRID_PARTS = {"xw GEMM": "tf32_gemm_kernel<false, false>",
              "gates GEMM": "tf32_gemm_kernel<false, true>",
              "dhin GEMM": "tf32_gemm_kernel<true, false>",
              "recurrence": "rnn_bwd_tf32_grid_kernel",
              "weight gradients": "rnn_bwd_tf32_wgrad_kernel",
              "slices' sum": "rnn_bwd_tf32_slices_kernel"}


def grid_split(torch, kernels, where: str, cell: str, hin, wx, b, wh, mm,
               h, c, dh) -> None:
    """Row 4 on the grid backward split by kernel (:data:`GRID_PARTS`,
    device ms by ``torch.profiler`` over two calls, halved; "not measured"
    where the profiler sees no device time, as late in the whole script it
    has: ``scripts/torch_cluster_variants.py --direction bwd_grid`` gives
    the split in a process of its own), the
    recurrence's barrier waits (each CTA's SM cycles waiting at its
    group's barriers over its cycles in all, by the kernel's own clock:
    mean and largest share, and that share of the recurrence's ms), and
    the all-gather's bytes (every CTA of a group reads the group's whole
    d_hw row block each step but the last) with their rate over the
    recurrence's device time. Recorded as ``<row>_split`` (informational:
    after the counted runs)."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    stats = {}

    def run():
        return R._launch_bwd_grid(cell, True, hin, wx, b, wh, mm, h, c, dh,
                                  1.0, stats=stats)

    run()
    torch.cuda.synchronize()
    by_name = profile_device(torch, lambda: [run() for _ in range(2)],
                             f"row 4 on the grid ({cell}, {where})")
    torch.cuda.synchronize()
    cyc = stats["cycles"].double().cpu()
    share = cyc[:, 0] / cyc[:, 1]
    n, rows = stats["group"], stats["rows"]
    gathered = ((T - 1) * -(-B // rows) * n * rows * GATES[cell] * H * 4)
    split, recur = None, None
    if by_name:
        split = {part: sum(ms / 2 for name, ms in by_name.items()
                           if key in name)
                 for part, key in GRID_PARTS.items()}
        split["other"] = sum(by_name.values()) / 2 - sum(split.values())
        recur = split["recurrence"]
    rec = dict(shape=[B, T, H], dtype="float32",
               device_ms_by_part=split or "not measured", group=n,
               rows=rows, groups=stats["groups"],
               barrier_wait_share_mean=float(share.mean()),
               barrier_wait_share_max=float(share.max()),
               barrier_wait_ms=float(share.mean()) * recur if recur else None,
               all_gather_bytes=gathered,
               all_gather_gb_per_s=gathered / recur / 1e6 if recur else None)
    report(kernels, f"rnn_fused_bwd_grid_{cell}_split", where, rec)
    log(f"row 4 on the grid ({cell}, {where}): device ms "
        + (", ".join(f"{k} {v:.3f}" for k, v in split.items()) if split
           else "not measured")
        + f"; barrier waits {100 * float(share.mean()):.1f}% of the "
        f"recurrence's cycles (largest {100 * float(share.max()):.1f}%); "
        f"all-gather {gathered / 1e9:.2f} GB at "
        f"{rec['all_gather_gb_per_s']} GB/s")
    del stats
    torch.cuda.empty_cache()


def grid_seeds(torch, kernels, cell: str, hin, wx, b, wh, mm, dh,
               xw) -> None:
    """A grid backward's seed grids (S 3, W_h shared), in ``hin``'s dtype:
    float32 at :data:`PAST_CAP_HIDDEN`, bf16 at :data:`CORE_BF16_HIDDEN`.
    Fused and hoisted, one counted call each, each seed bitwise its
    one-seed call; the hoisted one held to the plain version per seed
    (scaled atol 1e-5; bf16 0.05) and timed beside its bound, three
    one-seed calls, the plain version and one f32 ``torch.bmm`` of the
    per-seed dW_h products, as ``rnn_bwd_grid_[bf16_]<cell>_seeds``."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    S = GRID_SEEDS
    B, T, H = hin.shape
    dtype = hin.dtype
    tag = "bf16_" if dtype == torch.bfloat16 else ""
    stack = (lambda t, f: torch.stack([t, f(t), t.flip(0)]))
    xw3, hin3, dh3 = (stack(t, lambda v: -v) for t in (xw, hin, dh))
    wx3, b3 = stack(wx, lambda v: 0.9 * v), stack(b, lambda v: -v)
    m3 = stack(mm, lambda v: ~v)
    with torch.no_grad():
        sx = R._scan_states_any(cell, xw3, wh[None], m3, 1.0, True)
        sf = R._fused_states(cell, hin3, wx3, b3, wh[None], m3, 1.0, True)
    pick = (lambda st, s: tuple(None if t is None else t[s] for t in st))
    hoisted = (lambda: R.rnn_scan_bwd(cell, xw3, wh[None], m3, *sx, dh3))
    one = (lambda s: R.rnn_scan_bwd(cell, xw3[s], wh, m3[s], *pick(sx, s),
                                    dh3[s]))
    for name, run, single in (
            (f"rnn_bwd_grid_{tag}{cell}", hoisted, one),
            (f"rnn_fused_bwd_grid_{tag}{cell}",
             lambda: R.rnn_scan_fused_bwd(cell, hin3, wx3, b3, wh[None], m3,
                                          *sf, dh3),
             lambda s: R.rnn_scan_fused_bwd(cell, hin3[s], wx3[s], b3[s], wh,
                                            m3[s], *pick(sf, s), dh3[s]))):
        _build.reset_launch_counts()
        got = run()
        counts = _build.launch_counts()
        if counts[name] != 1 or sum(counts.values()) != 1:
            fail(f"{name} seed grid at H {H}: launched {counts}")
        seed_grid_held(torch, f"{name} seed grid ({dtype}, H {H}, W_h "
                       f"shared)", got, single, range(S))
        if name.startswith("rnn_bwd_"):
            err = max(grads_close(
                f"{name} seed grid seed {s}", tuple(g[s] for g in got),
                R.rnn_scan_bwd_reference(cell, xw3[s], wh, m3[s],
                                         *pick(sx, s), dh3[s]),
                dtype) for s in range(S))
        del got
    del hin3, wx3, b3, sf
    bound, by = rnn_bound("bwd", cell, B, T, H, hin.element_size(),
                          seeds=S)
    a = torch.randn(S, H, B * T, device="cuda")
    d = torch.randn(S, B * T, GATES[cell] * H, device="cuda")
    library = time_ms(lambda: torch.bmm(a, d), reps=3)
    del a, d
    rec = dict(shape=[S, B, T, H], dtype=str(dtype).replace("torch.", ""),
               shared="W_h", bitwise_vs_single=True, seeds_checked=S,
               max_abs_err=err, tolerance="scaled atol " + str(
                   BF16_TOL if tag else F32_TOL),
               **kernel_ms(hoisted, reps=3, launches=1),
               single_seed_loop_ms=time_ms(
                   lambda: [one(s) for s in range(S)], reps=2, warmup=1),
               plain_ms=time_ms(lambda: [R.rnn_scan_bwd_reference(
                   cell, xw3[s], wh, m3[s], *pick(sx, s), dh3[s])
                   for s in range(S)], reps=1, warmup=1),
               bound_ms=bound, bound_by=by, library_ms=library)
    report(kernels, f"rnn_bwd_grid_{tag}{cell}_seeds",
           f"B {B}, T {T}, H {H}", rec)
    log(f"grid seed grids at H {H} (S {S}, W_h shared): one call each, "
        f"every seed bitwise its one-seed call; hoisted {rec['ms']:.4f} ms "
        f"against {S} one-seed calls' {rec['single_seed_loop_ms']:.4f}, "
        f"max err {err:.3g}")
    del xw3, dh3, m3, sx
    torch.cuda.empty_cache()


def served_scores_agree(name: str, cfg, panel, plain, responses) -> float:
    """Every served score vector of ``responses`` finite, over the month's
    pool, and within atol 0.05 + rtol 0.05 of the plain path ``plain`` (a
    ``Predictor`` of the plain variant) → the largest error."""
    import numpy as np

    from lfm_quant_tpu_torch.data.windows import DateBatchSampler

    sampler = DateBatchSampler(panel, cfg.data.window, 1, 8,
                               min_valid_months=cfg.data.min_valid_months,
                               min_cross_section=1, require_target=False)
    col = {int(panel.dates[t]): int(t)
           for t in sampler.months_with_anchors()}
    worst = 0.0
    for resp in responses:
        t = col[resp.month]
        pool = sampler.cross_section(t)
        if not np.array_equal(resp.firm_idx, pool):
            fail(f"{name} {resp.month}: served firms differ from the pool")
        if resp.scores.shape != pool.shape or \
                not np.isfinite(resp.scores).all():
            fail(f"{name} {resp.month}: scores not finite of shape "
                 f"{pool.shape}")
        want = plain.score(pool[None, :], np.asarray([t], np.int32),
                           np.ones((1, pool.size), np.float32))[0]
        err = np.abs(resp.scores - want)
        if (err > BF16_TOL + BF16_TOL * np.abs(want)).any():
            fail(f"{name} {resp.month}: served scores differ from the "
                 f"plain path by up to {err.max()}")
        worst = max(worst, float(err.max()))
    return worst


def serve_wide(torch, name: str, cfg, panel, must, never,
               totals: dict) -> None:
    """``cfg`` served from one ``ScoringService`` universe:
    :data:`WIDE_REQUESTS` requests from 4 threads, counted (``must``
    launched, none of ``never``), every score held to the plain path on
    the card; logs the dispatches' peak device memory above what was
    allocated before the load."""
    from lfm_quant_tpu_torch.serve import ScoringService
    from lfm_quant_tpu_torch.serve.__main__ import drive_load
    from lfm_quant_tpu_torch.train.loop import Predictor

    with ScoringService(device="cuda", max_rows=8) as service:
        t0 = time.perf_counter()
        service.register(name, cfg, panel)
        torch.cuda.synchronize()
        reg_s = time.perf_counter() - t0
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        responses, counts = counted(
            f"serving {name}", must,
            lambda: drive_load(service, name, WIDE_REQUESTS, 4), never)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        st = service.stats()
    if st["completed"] != WIDE_REQUESTS or st["dispatch_errors"]:
        fail(f"serve {name}: {st}")
    for k, n in counts.items():
        totals[k] += n
    worst = served_scores_agree(name, cfg, panel,
                                Predictor(plain_variant(cfg), panel),
                                responses)
    log(f"serve {name}: registered and warmed in {reg_s:.1f} s; "
        f"{WIDE_REQUESTS} requests in {wall:.3f} s, p50 "
        f"{st['p50_ms']:.3f} ms, p99 {st['p99_ms']:.3f} ms; dispatch peak "
        f"{peak / 2**20:.1f} MB above the registered universe; every score "
        f"within {worst:.4g} of the plain path (tol {BF16_TOL} + "
        f"{BF16_TOL}|plain|)")
    torch.cuda.empty_cache()


def wide_phase(torch, cfg2, splits2, kernels, totals, seed_launches,
               gen) -> None:
    """Phase 28: every hidden width the JAX kernels take, bf16 above 128
    on the tensor cores with W_h split across a cluster both ways
    (``rnn_fwd_cluster.cu``, ``rnn_bwd_cluster.cu``), the float32
    forwards above 128 on the float32 grid (``rnn_fwd_tf32_grid.cu``),
    the float32 backwards above 128 on the 3xTF32 tensor cores on a
    cluster (``rnn_bwd_tf32.cu``) and on the grid
    (``rnn_bwd_tf32_grid.cu``), as the route gives them, and the seed
    grids of rows 1 and 2 off the H <= 128 tensor cores.

    (a) c2 at ``{"hidden": 256}`` (:data:`WIDE_HIDDEN`), LSTM and GRU,
    bf16: rows 1-4 at its train step (the layer-0 input of a real index
    batch, the model's seeded weights; timed on the cluster and on the
    CUDA cores, under each kernel's name), then :data:`WIDE_STEPS` steps
    from the seeded init, fused and hoisted, counted (the cluster forward
    and backward; no CUDA-core kernel, no H <= 128 tensor-core kernel),
    held to the plain path on the card, and the same four in float32
    (the float32 grid forwards, the backwards of the route; no CUDA-core
    kernel); (b) the LSTM served from one
    ``ScoringService`` universe (:func:`serve_wide`; counted likewise,
    every score held to the plain path), and at :data:`CORE_BF16_HIDDEN`
    (the bf16 grid forward); (c)
    rows 1-4 at :data:`WIDE_WIDTHS` (B 2048, T 60, seeded weights at
    H^-1/2) against their plain versions, each timed, rows 4 and 2 in
    float32 at :data:`F32_WIDE_WIDTHS` (:func:`f32_wide_rows`), rows 1-4
    in bf16 at :data:`CORE_BF16_HIDDEN` and rows 3 and 4 at
    :data:`BF16_GRID_WIDEST` on the bf16 grids (:func:`core_bf16_rows`),
    rows 3 and 1 at :data:`FWD_GRID_WIDTHS` (:func:`fwd_grid_widths`); (d)
    the
    seed grids at hidden 256 (:func:`wide_seed_grid`) and, as the main
    paths of the hoisted forms' grids, 3-seed c2 ensembles with
    ``scan_impl="pallas"``: bf16 at hidden 256 (the cluster forward and
    backward), float32 at hidden 128 (3xTF32), at :data:`F32_CLUSTER_HIDDEN`
    and at :data:`PAST_CAP_HIDDEN` (the float32 grid forward, the backward
    of the route),
    and bf16 at :data:`CORE_BF16_HIDDEN` (the bf16 grid forward and
    backward), for
    :data:`GRID_STEPS` steps each, counted into ``seed_launches``, held to
    the plain path. Single-seed launches go to ``totals``."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.loop import Trainer

    # The H <= 128 tensor-core kernels and the CUDA-core kernels: the
    # hidden-256 runs launch none of them.
    not_wide = tuple(k for k in _build.LAUNCHES
                     if "_mma_" in k or "_tf32_" in k) + CUDA_CORE
    gen = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 28)
    for cell in ("lstm", "gru"):
        cfg = train_variant(cfg2, kind=cell, kwargs=dict(
            cfg2.model.kwargs, hidden=WIDE_HIDDEN))
        trainer = Trainer(cfg, splits2, device="cuda")
        b = trainer.train_sampler.stacked_epoch(0)
        fi = torch.from_numpy(b.firm_idx[0]).cuda()
        ti = torch.from_numpy(b.time_idx[0]).cuda()
        model = trainer.model
        cd = model.dtype
        with torch.no_grad():
            x, m = trainer._gather(fi, ti)
            W = x.shape[-2]
            B = x.shape[0] * x.shape[1]
            hin = model.embed(x.reshape(B, W, -1), dtype=cd)
            wx = model.xproj[0].kernel.detach().to(cd)
            bb = model.xproj[0].bias.detach().to(cd)
            wh = model.h_proj[0].detach().to(cd)
        mm = m.reshape(B, W)
        dh = (0.1 * torch.randn(B, W, WIDE_HIDDEN, generator=gen,
                                device="cuda")).to(cd)
        del x, m, trainer
        where = f"c2 hidden {WIDE_HIDDEN} train step"
        wide_rows(torch, kernels, where, cell, hin, wx, bb, wh, mm, dh,
                  timed=("fused_fwd", "fwd", "fused_bwd", "bwd"))
        if cell == "lstm":
            wide_seed_grid(torch, kernels, cell, hin, wx, bb, wh, mm, dh,
                           f"B {B}, T {W}, H {WIDE_HIDDEN}")
        del hin, wx, bb, wh, mm, dh
        torch.cuda.empty_cache()
        # The float32 runs: the float32 grid forwards, the backwards of
        # the route; no CUDA-core kernel, no bf16 or cluster kernel.
        not_f32 = tuple(k for k in _build.LAUNCHES
                        if "_mma_" in k or "_cluster_" in k) + CUDA_CORE
        for form, run_cfg, must, never in (
                ("fused, bf16", cfg, (f"rnn_fused_fwd_cluster_{cell}",
                                      f"rnn_fused_bwd_cluster_{cell}",
                                      "window_gather"), not_wide),
                ("hoisted, bf16", train_variant(cfg, scan_impl="pallas"),
                 (f"rnn_fwd_cluster_{cell}", f"rnn_bwd_cluster_{cell}",
                  "window_gather"), not_wide),
                ("fused, float32", train_variant(cfg, bf16=False),
                 (*f32_route_names(cell, WIDE_HIDDEN, True),
                  "window_gather"), not_f32),
                ("hoisted, float32",
                 train_variant(cfg, scan_impl="pallas", bf16=False),
                 (*f32_route_names(cell, WIDE_HIDDEN, False),
                  "window_gather"), not_f32)):
            label = f"c2 {cell} hidden {WIDE_HIDDEN} training ({form})"
            got, counts = counted(label, must, lambda: short_run(
                torch, run_cfg, splits2, WIDE_STEPS), never)
            for k, n in counts.items():
                totals[k] += n
            want = short_run(torch, plain_variant(run_cfg), splits2,
                             WIDE_STEPS)
            err = losses_agree(label, got, want)
            log(f"{label}: {WIDE_STEPS} steps, losses "
                f"{[round(v, 6) for v in got]} agree with the plain path "
                f"within {err:.4g}")
            torch.cuda.empty_cache()
        if cell == "lstm":
            serve_wide(torch, f"c2_h{WIDE_HIDDEN}", cfg, splits2.panel,
                       ("rnn_fused_fwd_cluster_lstm", "window_gather"),
                       not_wide, totals)
    # The LSTM at hidden 528 served: the bf16 grid forward and its xw
    # scratch in every dispatch; no other recurrence kernel.
    serve_wide(torch, f"c2_h{CORE_BF16_HIDDEN}", train_variant(
        cfg2, kwargs=dict(cfg2.model.kwargs, hidden=CORE_BF16_HIDDEN)),
        splits2.panel, ("rnn_fused_fwd_grid_bf16_lstm", "window_gather"),
        not_wide + tuple(k for k in _build.LAUNCHES if "_cluster_" in k
                         or "_bwd" in k), totals)

    # Rows 1-4 at the wider widths, seeded weights.
    B, T = 2048, 60
    for H in WIDE_WIDTHS:
        for cell in ("lstm", "gru"):
            G = GATES[cell] * H
            sd = H ** -0.5
            bf = dict(generator=gen, device="cuda")
            hin = torch.randn(B, T, H, **bf).to(torch.bfloat16)
            wx, wh = ((sd * torch.randn(H, G, **bf)).to(torch.bfloat16)
                      for _ in range(2))
            bb = (0.1 * torch.randn(G, **bf)).to(torch.bfloat16)
            mm = torch.rand(B, T, **bf) < 0.75
            dh = (0.1 * torch.randn(B, T, H, **bf)).to(torch.bfloat16)
            wide_rows(torch, kernels, f"B {B}, T {T}, H {H}", cell, hin, wx,
                      bb, wh, mm, dh,
                      timed=("fused_fwd", "fwd", "fused_bwd", "bwd"),
                      name_suffix=f"@h{H}")
            del hin, wx, wh, bb, mm, dh
            torch.cuda.empty_cache()
    f32_wide_rows(torch, kernels, gen)
    core_bf16_rows(torch, kernels, gen)
    fwd_grid_widths(torch, gen)

    # The hoisted forms' seed grids on a main path: 3-seed ensembles.
    for label, run_cfg, must in (
            (f"c2 {GRID_SEEDS}-seed ensemble (hoisted, bf16, hidden "
             f"{WIDE_HIDDEN})",
             train_variant(cfg2, scan_impl="pallas", kwargs=dict(
                 cfg2.model.kwargs, hidden=WIDE_HIDDEN)),
             ("rnn_fwd_cluster_lstm", "rnn_bwd_cluster_lstm",
              "window_gather")),
            (f"c2 {GRID_SEEDS}-seed ensemble (hoisted, float32)",
             train_variant(cfg2, scan_impl="pallas", bf16=False),
             ("rnn_fwd_tf32_lstm", "rnn_bwd_tf32_lstm", "window_gather")),
            (f"c2 {GRID_SEEDS}-seed ensemble (hoisted, float32, hidden "
             f"{F32_CLUSTER_HIDDEN})",
             train_variant(cfg2, scan_impl="pallas", bf16=False,
                           kwargs=dict(cfg2.model.kwargs,
                                       hidden=F32_CLUSTER_HIDDEN)),
             (*f32_route_names("lstm", F32_CLUSTER_HIDDEN, False),
              "window_gather")),
            (f"c2 {GRID_SEEDS}-seed ensemble (hoisted, float32, hidden "
             f"{PAST_CAP_HIDDEN})",
             train_variant(cfg2, scan_impl="pallas", bf16=False,
                           kwargs=dict(cfg2.model.kwargs,
                                       hidden=PAST_CAP_HIDDEN)),
             (*f32_route_names("lstm", PAST_CAP_HIDDEN, False),
              "window_gather")),
            (f"c2 {GRID_SEEDS}-seed ensemble (hoisted, hidden "
             f"{CORE_BF16_HIDDEN})",
             train_variant(cfg2, scan_impl="pallas", kwargs=dict(
                 cfg2.model.kwargs, hidden=CORE_BF16_HIDDEN)),
             ("rnn_fwd_grid_bf16_lstm", "rnn_bwd_grid_bf16_lstm",
              "window_gather"))):
        run_cfg = dataclasses.replace(run_cfg, n_seeds=GRID_SEEDS)
        got, counts = counted(label, must, lambda: ensemble_steps(
            torch, run_cfg, splits2, GRID_STEPS))
        if any(counts[k] != GRID_STEPS for k in must) or any(
                v for k, v in counts.items() if k not in must):
            fail(f"{label}: launches {counts}, not each of {must} once a "
                 f"step")
        for k, n in counts.items():
            seed_launches[k] += n
        want = ensemble_steps(torch, plain_variant(run_cfg), splits2,
                              GRID_STEPS)
        err = losses_agree(label, got, want)
        log(f"{label}: {GRID_STEPS} steps, one launch of each kernel a step "
            f"for all {GRID_SEEDS} seeds; per-seed losses agree with the "
            f"plain path within {err:.4g}")
        torch.cuda.empty_cache()


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "lfm_quant_tpu_torch")):
        fail("lfm_quant_tpu_torch/ is not beside chip_smoke.py: run it "
             "from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on a card")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    def since(what: str) -> None:
        log(f"{what} done at {time.perf_counter() - t_start:.1f} s")

    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)

    import numpy as np

    from lfm_quant_tpu_torch.config import get_preset
    from lfm_quant_tpu_torch.data.panel import PanelSplits
    from lfm_quant_tpu_torch.data.windows import DateBatchSampler
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.serve import ScoringService
    from lfm_quant_tpu_torch.serve.__main__ import drive_load
    from lfm_quant_tpu_torch.train.loop import (
        Predictor,
        Trainer,
        default_split_dates,
        resolve_panel,
    )

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    kernel = ""
    for line in (_build.BUILD_INFO["ptxas"] or "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            log(f"ptxas: {kernel}: {line.strip()}")

    # ---- 3. kernels against their plain versions ------------------------
    gen = torch.Generator().manual_seed(0)
    check_small(torch, gen)

    # The serving universes, and their plain paths on the card: the same
    # seeded params and device panel through the plain gather and the
    # plain recurrence (scan_impl / gather_impl "xla").
    universes = {}
    panels = {}
    for name in SERVED:
        cfg = get_preset(name)
        panel = panel_of(cfg, panels)
        universes[name] = (cfg, panel, Predictor(plain_variant(cfg), panel))

    max_rows = 8
    kernels = {}
    for name, cell in (("c2", "lstm"), ("c3", "gru")):
        cfg, panel, plain = universes[name]
        d = cfg.data
        fi_np, ti_np = widest_dispatch(panel, d, max_rows)
        xm = plain.dev["xm"]
        fp = panel.n_features + 1
        with torch.inference_mode():
            # Gather at the dispatch shape: exact.
            x, m = check_gather(torch, kernels, f"{name} serving", xm, fi_np,
                                ti_np, d.window, fp, panel.n_months)
            # The recurrence on the layer-0 input this batch produces.
            model = plain.model
            cd = model.dtype or torch.float32
            B = x.shape[0] * x.shape[1]
            hin = model.embed(x.reshape(B, d.window, -1).to(cd), dtype=cd)
            mm = m.reshape(B, d.window)
            wx = model.xproj[0].kernel.to(cd)
            b = model.xproj[0].bias.to(cd)
            wh = model.h_proj[0].to(cd)
            check_fused_fwd(torch, kernels, f"{name} serving", cell, hin, wx,
                            b, wh, mm, save_c=False)
            del x, m, hin
        torch.cuda.empty_cache()

    # The train step's shapes: a c2 trainer on the card (seeded init).
    cfg2, panel2, _ = universes["c2"]
    splits2 = PanelSplits.by_date(
        panel2, *default_split_dates(panel2, cfg2.data),
        train_start=cfg2.data.train_start)
    check_train_shapes(torch, Trainer(cfg2, splits2, device="cuda"),
                       kernels, gen)

    since("phase 3")
    # ---- 4. serve ---------------------------------------------------------
    totals = dict.fromkeys(_build.LAUNCHES, 0)
    served = {}
    with ScoringService(device="cuda", max_rows=max_rows) as service:
        for name, (cfg, panel, _) in universes.items():
            t0 = time.perf_counter()
            service.register(name, cfg, panel)
            torch.cuda.synchronize()
            log(f"{name}: registered and warmed in "
                f"{time.perf_counter() - t0:.1f} s")

        def serve(name, n_requests):
            service.reset_stats()
            t0 = time.perf_counter()
            served[name] = drive_load(service, name, n_requests, 4)
            wall = time.perf_counter() - t0
            st = service.stats()
            log(f"serve {name}: {st['completed']} requests in "
                f"{wall:.3f} s, {st['req_per_s']:.2f} req/s, p50 "
                f"{st['p50_ms']:.3f} ms, p99 {st['p99_ms']:.3f} ms, "
                f"occupancy {st['mean_occupancy']:.3f}, batches "
                f"{st['batches']}")
            if st["completed"] != n_requests or st["dispatch_errors"]:
                fail(f"serve {name}: {st}")

        # Each universe counted on its own: its kernels must move.
        for name, (n_requests, must) in SERVED.items():
            _, counts = counted(f"serving {name}", must,
                                lambda: serve(name, n_requests))
            for k, n in counts.items():
                totals[k] += n
        profile_device(torch, lambda: drive_load(service, "c2", 32, 4,
                                                 seed=1),
                       "c2 serving, 32 requests from 4 threads")

    worst = 0.0
    for name, responses in served.items():
        cfg, panel, plain = universes[name]
        worst = max(worst, served_scores_agree(name, cfg, panel, plain,
                                               responses))
    log(f"served scores match the plain path on the card: max abs err "
        f"{worst:.4g} (tol {BF16_TOL} + {BF16_TOL}|plain|) over "
        f"{sum(len(v) for v in served.values())} responses")
    del universes, served
    torch.cuda.empty_cache()

    since("phase 4")
    # ---- 5. train ---------------------------------------------------------
    train_phase(torch, cfg2, splits2, totals)

    since("phase 5")
    # ---- 6. the c5 ensemble ---------------------------------------------
    cfg5 = get_preset("c5")
    splits5 = splits_of(cfg5, panels)
    panel5 = splits5.panel
    seed_launches = dict.fromkeys(_build.LAUNCHES, 0)
    trainer5, one5 = c5_phase(torch, cfg5, splits5, kernels, seed_launches)

    since("phase 6")
    # ---- 7. c5 backtest ---------------------------------------------------
    c5_backtest_phase(torch, trainer5, panel5, totals, seed_launches)
    del trainer5, panel5  # splits5 stays for phase 27

    since("phase 7")
    # ---- 8. c2 walk-forward ---------------------------------------------
    walkforward_phase(torch, cfg2, panel2, totals)
    del panel2  # splits2 stays for phase 28

    since("phase 8")
    # ---- 9. c3 training at full width -----------------------------------
    one = c3_phase(torch, kernels, totals, gen)

    since("phase 9")
    # ---- 10. two ranks on the one card ----------------------------------
    two_ranks_phase(torch, one, totals)

    since("phase 10")
    # ---- 11-14. the MLP, transformer and LRU ----------------------------
    one = new_models_phases(torch, kernels, totals, panels)

    since("phase 14")
    # ---- 15. the seq axis: lc and lru on two ranks -----------------------
    seq_ranks_phase(torch, kernels, totals, one, panels)

    since("phase 15")
    # ---- 16. the seed axis: c5 on two ranks ------------------------------
    seed_ranks_phase(torch, kernels, totals, seed_launches, one5, panels)

    since("phase 16")
    # ---- 17. the factorized recurrences ----------------------------------
    factored_phase(torch, kernels, totals, panels)

    since("phase 17")
    # ---- 18. the serving stack behind the HTTP front door -------------
    stack = serving_stack_phase(torch, totals, panels)
    print(json.dumps({"serving_stack": stack}), flush=True)

    since("phase 18")
    # ---- 19. the heteroscedastic forward -------------------------------
    variance_phase(torch, cfg2, cfg5, totals, seed_launches, panels)

    since("phase 19")
    # ---- 20. the async pipeline and preemption -------------------------
    pipe = pipeline_phase(torch, cfg2, cfg5, totals, seed_launches, one5,
                          panels)

    since("phase 20")
    # ---- 21. training-side geometry buckets ----------------------------
    buckets_phase(torch, cfg2, cfg5, totals, seed_launches, pipe, panels)

    since("phase 21")
    # ---- 22. the native sampler ----------------------------------------
    native_phase(torch, cfg2, cfg5, totals, panels)

    since("phase 22")
    # ---- 23-25. durable serving, the fleet, entry telemetry -------------
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="lfm_durable_")
    try:
        durable = durable_phase(torch, totals, panels, tmp)
        panel2 = panel_of(cfg2, panels)
        del panels
        fleet_out = fleet_phase(torch, totals, durable, tmp)
        entry = entry_telemetry_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"durable": durable["summary"], "fleet": fleet_out,
                      "entry_telemetry": entry}, default=str), flush=True)

    since("phase 25")
    # ---- 26. stacked runs: the config sweep, the fold stack, CSV ------
    tmp = tempfile.mkdtemp(prefix="lfm_stacked_")
    try:
        stacked = stacked_phase(torch, cfg2, panel2, totals, seed_launches,
                                tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del panel2
    print(json.dumps({"stacked_runs": stacked}, default=str), flush=True)

    since("phase 26")
    # ---- 27. c5 on the hoisted recurrence: the seed rules --------------
    c5_hoisted_phase(torch, cfg5, splits5, kernels, seed_launches, one5)
    del splits5

    since("phase 27")
    # ---- 28. every hidden width, the grids off the tensor cores -------
    wide_phase(torch, cfg2, splits2, kernels, totals, seed_launches, gen)
    del splits2

    since("phase 28")
    # ---- 29. kernels line -----------------------------------------------
    line = []
    fields = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms")
    f32_fields = fields + ("bound_f32_simt_ms",)
    for k, (src, rep) in SOURCES.items():
        # The largest shape the main paths gave the kernel.
        meas = max(kernels[k], key=lambda r: int(np.prod(r["shape"])))
        f32 = meas.get("dtype") == "float32"
        rec = {f: meas.get(f) for f in (f32_fields if f32 else fields)}
        if f32:
            rec["dtype"] = meas["dtype"]
        line.append(dict(name=k, route="cuda",
                         source=f"lfm_quant_tpu_torch/{src}",
                         replaces=f"{SRC_REPO}/{rep}", launches=totals[k],
                         **rec))
    # The seed-batched launches: measured at the c5 train step (the hoisted
    # rows' grids off the tensor cores at the c2 step and at hidden 256),
    # launches counted over the seed-stacked main paths.
    for k, (counter, src, rep) in SEED_SOURCES.items():
        meas = {f: kernels[k][0].get(f) for f in fields}
        line.append(dict(name=k, route="cuda",
                         source=f"lfm_quant_tpu_torch/{src}",
                         replaces=f"{SRC_REPO}/{rep}",
                         launches=seed_launches[counter], **meas))
    print(json.dumps({"kernels": line}), flush=True)

    since("phase 29")
    # ---- 30. result -----------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
