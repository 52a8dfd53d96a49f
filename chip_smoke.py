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
   equal to one-seed calls); the same four rows at hidden 120 (the
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
   float32 four at hidden 160 must launch the CUDA-core forwards and
   backwards. The hoisted bf16 step and the fused float32 step are also
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
   forward and backward must be bitwise equal to 64 one-seed launches
   with the same rows per block, an operand of seed extent 1 (m) bitwise
   equal to its broadcast copy, and both within the plain version's
   tolerances; the seed-folded gather exact. Then ``EnsembleTrainer``
   trains c5 for one epoch (52 steps and the validation sweep) on the
   kernels from a seeded init: its first 3 steps' per-seed losses against
   the plain path on the card (``seed_block`` 8) within atol 0.05 + rtol
   0.05; one step moves the gather, tensor-core forward and backward
   counters by exactly 1 and no CUDA-core counter. Prints ms per step,
   seed-steps/s, firm-months/s, the epoch's wall time, the device's busy
   share of profiled steps and the peak memory;
7. the c5 backtest: the ensemble phase 6 trained is written to a run dir
   and reloaded through ``load_forecaster``; its test-split forecasts (64
   seeds; one seed-grid launch of the fused forward per month and seed
   chunk, counted) are held to the plain path on the card (atol 0.05 +
   rtol 0.05); ``mean``,
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
   members' first 3 steps' per-seed losses against phase 6's one
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
19. print one ``{"kernels": [...]}`` line (launches: phases 4, 5, 8, 9,
   10, 11-15, 17 and 18 for the one-seed rows, 6, 7 and 16 for the seed
   rows);
20. print the result line ``{"ok": true, "device": {...}}`` last.
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
# multiple of 16, which runs zero-padded on the 3xTF32 kernels, and one
# above 128, the CUDA-core kernels' route (their main-path witness).
PADDED_HIDDEN = 120
CUDA_CORE_HIDDEN = 160
# The device's sleep (clock cycles, about 10 ms) while the host queues the
# launches that device_ms times.
SLEEP_CYCLES = 20_000_000

# name → (source in the port, the TPU kernel it replaces). The CUDA-core
# kernels run on the main paths in float32 at hidden 160 (H > 128, where
# the tensor cores do not reach) and are measured there (B 2048, T 60).
# The 3xTF32 kernels (``*_tf32_*``) are measured in float32 at the c2
# train step (the kernels line) and at hidden 120, zero-padded to 128
# (logged records); the bf16 ones at the c2 train step and the serving
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
}
PLAIN_STEPS = 3      # steps of each model held against the plain path
TIMED_STEPS = 4      # steps of each model timed and profiled
C3_KERNELS = ("window_gather", "rnn_fused_fwd_mma_gru",
              "rnn_fused_bwd_mma_gru")
CARD_RANKS = 2       # phases 10, 15 and 16's processes on the one card
RANKS_TIMEOUT_S = 600
C5_PLAIN_STEPS = 3   # c5 steps held against the plain path
C5_PLAIN_BLOCK = 8   # seed_block of the plain path (its autograd memory)
C5_PREDICT_MONTHS = 3  # test months phase 16's gathered forecasts cover
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


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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
        nbytes = xw + seq + c_all + B * T + H * GH * itemsize
    else:
        states = (3 if cell == "lstm" else 2) * seq
        if kind == "fused_bwd":
            nbytes = (seq + states + seq + weights
                      + seeds * (2 * H + 1) * GH * 4)
        else:
            nbytes = xw + states + xw + H * GH * (itemsize + 4)
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
                # to 16); H 136 keeps the CUDA-core ones.
                mma = R._mma_route(dt, H) == "mma"
                tags = {"mma": "mma_", "tf32": "tf32_", "simt": ""}
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


def cudnn_yardstick(torch, cell: str, hin, wx, b, wh, atol: float,
                    rtol: float) -> dict:
    """Row 3's ``library_ms``: one cuDNN call (``torch.nn.LSTM`` or
    ``torch.nn.GRU``, TF32 off) on the same inputs with every step valid
    — the same function only when no step is masked. Its weights are the
    row's: W_x^T and W_h^T with the JAX gate order permuted for the GRU
    (PyTorch's r, z, n), ``forget_bias`` 1 folded into the f slice of
    ``b_ih``, ``b_hh`` 0. Held first to the plain version with m all ones
    at the row's tolerance, then timed; the record gives its error and
    says whether it differs (over the row's tolerance) or cuDNN refused
    the dtype. The port never makes this call. Row 1's is the same call
    on ``xw`` with W_x the identity and b 0 (:func:`hoisted_yardstick`)."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, _ = hin.shape
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
    pads and beside the CUDA-core kernels on the same inputs) and at
    :data:`CUDA_CORE_HIDDEN` (``rnn_fused_fwd.cu`` and ``rnn_bwd.cu``, the
    route above 128), seeded weights. Bounds at both f32 rates, of the
    unpadded work."""
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
    if cell == "lstm":
        f32_stack_memory(torch, hin, wx, b, wh, mm, dh)
    with torch.no_grad():
        h, c = R.rnn_scan_states(cell, xw, wh, mm, 1.0, True)
    f32_bwd_rows(torch, kernels, "c2 train step", cell, hin, wx, b, wh, mm,
                 h, c, dh, xw)
    del h, c, xw
    for H2 in (PADDED_HIDDEN, CUDA_CORE_HIDDEN):
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
            h2, c2 = R.rnn_scan_states(cell, xw2, wh2, mm, 1.0, True)
        f32_bwd_rows(torch, kernels, where, cell, hin2, wx2, b2, wh2, mm, h2,
                     c2, dh2, xw2)
        del hin2, dh2, xw2, h2, c2
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
                 xw) -> None:
    """Rows 3 and 1 in float32, saving c_all as training does, through the
    route at this H (counted, nothing else launched): at H <= 128 the
    3xTF32 forward, timed in turns with ``rnn_fused_fwd.cu`` (its private
    launcher) on the same inputs (3xTF32, CUDA cores, CUDA cores, 3xTF32:
    ``ms`` and ``device_ms`` are the first reading, ``turns_ms`` all four)
    and, at a padded width, with its pads apart (:func:`padded_times`);
    above 128 ``rnn_fused_fwd.cu`` itself. Beside both bounds, the plain
    version and, for row 3, the cuDNN yardstick. h_all and c_all within
    atol 1e-5 of the plain version (the JAX f32 bound on the op's
    output)."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    route = R._mma_route(torch.float32, H)
    padded = R._padded_width(H) != H
    want = R.rnn_scan_states(cell, xw, wh, mm, 1.0, True)
    library = cudnn_yardstick(torch, cell, hin, wx, b, wh, F32_TOL, 0.0)
    for kind, fused in (("fused_fwd", True), ("fwd", False)):
        form = "fused_" if fused else ""
        name = f"rnn_{form}fwd_{'tf32_' if route == 'tf32' else ''}{cell}"
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
        if route == "tf32":
            runs["cuda_core"] = (lambda f=fused: R._launch_fwd(
                cell, not f, ops[0], *((wx, b) if f else (None, None)),
                wh, mm, 1.0, True))
        errs = {}
        for mode, run in runs.items():
            _build.reset_launch_counts()
            out = run()
            counts = _build.launch_counts()
            launched = name if mode == "route" else f"rnn_{form}fwd_{cell}"
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
            turns[mode].append(kernel_ms(runs[mode], reps=5, launches=2))
        rec = dict(shape=[B, T, H], dtype="float32", save_c=True,
                   plain_ms=plain_ms, **f32_bounds(kind, cell, B, T, H, True),
                   **(library if fused else hoisted_yardstick(
                       torch, cell, xw, wh, F32_TOL, 0.0)),
                   tolerance=f"atol {F32_TOL}",
                   max_abs_err=max(errs["route"].values()),
                   max_abs_err_by_state=errs["route"], **turns["route"][0],
                   host_ms=host_ms(runs["route"]))
        if "cuda_core" in runs:
            rec.update(cuda_core_ms=turns["cuda_core"][0]["ms"],
                       cuda_core_device_ms=turns["cuda_core"][0]["device_ms"],
                       cuda_core_max_abs_err=max(errs["cuda_core"].values()),
                       turns_ms={m: [t["ms"] for t in v]
                                 for m, v in turns.items()})
        if padded:
            rec.update(padded_times(torch, kind, cell, ops, (1.0, True),
                                    runs["route"]))
        report(kernels, name, where, rec)
        log(f"{name} (float32) at {where}: {rec['ms']:.4f} ms (device "
            f"{rec['device_ms']:.4f}, host {rec['host_ms']:.4f}"
            + (f", pads {rec['pad_ms']:.4f}" if padded else "") + ")"
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
                 h, c, dh, xw) -> None:
    """Rows 4 and 2 in float32 through the public backwards, on the route's
    kernels at this H (``rnn_bwd_tf32.cu`` at H <= 128, zero-padded to the
    next multiple of 16 where H is off one; ``rnn_bwd.cu`` above): each
    launched once per call (counted), twice for bitwise equal outputs,
    against its plain version at scaled atol 1e-5, timed beside both
    bounds, the plain version and the ``library_ms`` yardstick — the
    weight-gradient products (and, fused, dhin) as f32 ``torch.matmul``
    with TF32 off, which the port never makes. On the 3xTF32 route
    ``rnn_bwd.cu`` (its private launcher) is timed on the same inputs, and
    a padded row's pads apart from its kernel (:func:`padded_times`)."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    route = R._mma_route(torch.float32, H, "bwd")
    tag = "tf32_" if route == "tf32" else ""
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, fused in (("fused_bwd", True), ("bwd", False)):
        name = f"rnn_{'fused_' if fused else ''}bwd_{tag}{cell}"
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
        del one, two, want
        d_xw, d_hw, h_prev = R._scan_bwd_core(cell, xw, wh, mm, h, c, dh,
                                              1.0)
        a_h, d_h = h_prev.reshape(-1, H), d_hw.reshape(B * T, -1)
        if fused:
            a_x, d_x = hin.reshape(-1, H), d_xw.reshape(B * T, -1)
            library_ms = time_ms(lambda: (torch.matmul(a_x.T, d_x),
                                          torch.matmul(a_h.T, d_h),
                                          torch.matmul(d_x, wx.T)))
            del a_x, d_x
        else:
            library_ms = time_ms(lambda: torch.matmul(a_h.T, d_h))
        del d_xw, d_hw, h_prev, a_h, d_h

        def run(a=args, f=public):
            return f(*a)

        rec = dict(shape=[B, T, H], dtype="float32", max_abs_err=err,
                   wgrad_scaled_err=wgrad_err, bitwise_repeatable=True,
                   tolerance=f"scaled atol {F32_TOL}",
                   **kernel_ms(run, reps=5, launches=2),
                   plain_ms=time_ms(lambda a=args: plain(*a), reps=3,
                                    warmup=1),
                   **f32_bounds(kind, cell, B, T, H), library_ms=library_ms)
        if route == "tf32":
            cc = kernel_ms(lambda a=simt_args, f=fused: R._launch_bwd(
                cell, f, *a, 1.0), reps=5, launches=2)
            rec.update(cuda_core_ms=cc["ms"],
                       cuda_core_device_ms=cc["device_ms"])
        if R._padded_width(H) != H:
            rec.update(padded_times(torch, kind, cell, args[1:], (1.0,),
                                    run))
        report(kernels, name, where, rec)
        log(f"{name} (float32) at {where}: {rec['ms']:.4f} ms (device "
            f"{rec['device_ms']:.4f}"
            + (f", pads {rec['pad_ms']:.4f}" if "pad_ms" in rec else "")
            + "), rnn_bwd.cu "
            f"{rec.get('cuda_core_ms', rec['ms']):.4f}, bound "
            f"{rec['bound_ms']:.4f} (3xTF32) / "
            f"{rec['bound_f32_simt_ms']:.4f} (CUDA cores), library "
            f"{library_ms:.4f} ms")
        torch.cuda.empty_cache()


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


def profile_device(torch, fn, label: str) -> dict:
    """Device time by kernel name over ``fn`` under ``torch.profiler``,
    and the device's busy share of the wall time (summed kernel times over
    the wall clock); returns the device ms by kernel name (empty when the
    trace holds no device time). Informational: it runs after the launch
    counts were read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    # kernels zero-padded to 128): no CUDA-core kernel in any; and the
    # float32 four at hidden 160 (the CUDA-core forwards and backwards): a
    # few steps each.
    h120 = dict(cfg.model.kwargs, hidden=PADDED_HIDDEN)
    h160 = dict(cfg.model.kwargs, hidden=CUDA_CORE_HIDDEN)
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
            ("c2 training (fused, float32, hidden 160)",
             train_variant(cfg, bf16=False, kwargs=h160),
             ("rnn_fused_fwd_lstm", "rnn_fused_bwd_lstm", "window_gather"),
             ()),
            ("c2 training (hoisted, float32, hidden 160)",
             train_variant(cfg, scan_impl="pallas", bf16=False, kwargs=h160),
             ("rnn_fwd_lstm", "rnn_bwd_lstm", "window_gather"), ()),
            ("GRU training (fused, float32, hidden 160)",
             train_variant(cfg, kind="gru", bf16=False, kwargs=h160),
             ("rnn_fused_fwd_gru", "rnn_fused_bwd_gru", "window_gather"),
             ()),
            ("GRU training (hoisted, float32, hidden 160)",
             train_variant(cfg, kind="gru", scan_impl="pallas", bf16=False,
                           kwargs=h160),
             ("rnn_fwd_gru", "rnn_bwd_gru", "window_gather"), ()))
    for label, run_cfg, must, must_not in runs:
        got, counts = counted(label, must, lambda: short_run(
            torch, run_cfg, splits, TRAIN_STEPS_SHORT), must_not)
        for k, n_launch in counts.items():
            totals[k] += n_launch
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
                       check=None) -> None:
    """The c5 train step's seed-batched launches (S 64 x B 2048, T 60, H
    128, LSTM, bf16; ``trainer``'s seeds) on the layer-0 input of the
    first stacked batch of epoch 0 and the model's seeded weights: the
    gather folded over the seeds, exact; the fused forward and backward
    each bitwise equal to one-seed launches with the same rows per block
    (every seed, or those of ``check``), m of seed extent 1 bitwise equal
    to its broadcast copy, and each checked seed within the plain
    version's tolerance; each timed beside its bound, the checked seeds'
    one-seed launches and the plain version (one seed at a time); row 4's
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
        for s in check], reps=3, warmup=1)
    plain_ms = time_ms(lambda: [R.rnn_scan_states(
        cell, hin[s].float() @ wx[s].float() + bb[s].float(), wh[s], mm[s],
        1.0, True) for s in check], reps=1, warmup=0)
    report(kernels, "rnn_fused_fwd_mma_lstm_seeds", where, dict(
        shape=[S, B, W, H], rows_per_block=rows, bitwise_vs_single=True,
        seeds_checked=len(check),
        max_abs_err=worst, tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}",
        **ms, single_seed_launches_ms=singles_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None, library_note=(
            "no single PyTorch call: torch.nn.LSTM takes one weight set "
            "per call, so 64 seeds are 64 calls")))
    log(f"seed-batched fused fwd at the {where}: {ms['ms']:.3f} ms for {S} "
        f"seeds in one launch, {singles_ms:.3f} ms in {len(check)} one-seed "
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
        cell, *(t[s] for t in bargs[1:])) for s in check], reps=1)
    plain_ms = time_ms(lambda: [R.rnn_scan_fused_bwd_reference(
        cell, *(t[s] for t in bargs[1:])) for s in check], reps=1,
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
        f"seeds in one call, {singles_ms:.3f} ms in {len(check)} one-seed "
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
    check_seed_batched(torch, trainer, kernels)

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
    for impl in ("kernel", "plain", "kernel", "plain"):
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

    # The plain path on the card, from the same params.
    plain = EnsembleTrainer(plain_variant(cfg), splits, device="cuda")
    plain.state = plain.init_state({k: p.detach().cpu().numpy()
                                    for k, p in model.state.params.items()})
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    want, want_valid = plain.predict("test")
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if any(_build.launch_counts().values()):
        fail(f"the plain c5 predict launched kernels: "
             f"{_build.launch_counts()}")
    del plain
    torch.cuda.empty_cache()
    if not np.array_equal(want_valid, valid):
        fail("c5 predict: the plain path's valid cells differ")
    err = np.abs(stacked[:, valid] - want[:, valid])
    if (err > BF16_TOL + BF16_TOL * np.abs(want[:, valid])).any():
        fail(f"c5 predict: forecasts differ from the plain path by up to "
             f"{err.max()}")
    log(f"c5 predict matches the plain path on the card ({int(valid.sum())} "
        f"cells x {S} seeds): max abs err {err.max():.4g} (tol {BF16_TOL} + "
        f"{BF16_TOL}|plain|); plain path {plain_ms:.1f} ms")
    del want, err

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
        res["timed_steps"]
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
    by_step = profile_device(torch, steps, f"{label} train, {n} steps")
    profile_groups(torch, trainer, state, fi[1:], ti[1:], w[1:], n, label)
    out = {"trainer": trainer, "losses": losses, "grad_norms": gnorms,
           "eval": ev, "ms_step": 1e3 * per_step, "peak_gib": peak,
           "batch": (fi, ti, w), "timed_steps": n, "by_step": by_step}
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
    profile_device(torch, lambda: steps(), f"lru64 train, {n} steps")
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


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "lfm_quant_tpu_torch")):
        fail("lfm_quant_tpu_torch/ is not beside chip_smoke.py: run it "
             "from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on a card")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
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
        sampler = DateBatchSampler(panel, cfg.data.window, 1, 8,
                                   min_valid_months=cfg.data.min_valid_months,
                                   min_cross_section=1, require_target=False)
        col = {int(panel.dates[t]): int(t)
               for t in sampler.months_with_anchors()}
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
    log(f"served scores match the plain path on the card: max abs err "
        f"{worst:.4g} (tol {BF16_TOL} + {BF16_TOL}|plain|) over "
        f"{sum(len(v) for v in served.values())} responses")
    del universes, served
    torch.cuda.empty_cache()

    # ---- 5. train ---------------------------------------------------------
    train_phase(torch, cfg2, splits2, totals)

    # ---- 6. the c5 ensemble ---------------------------------------------
    cfg5 = get_preset("c5")
    splits5 = splits_of(cfg5, panels)
    panel5 = splits5.panel
    seed_launches = dict.fromkeys(_build.LAUNCHES, 0)
    trainer5, one5 = c5_phase(torch, cfg5, splits5, kernels, seed_launches)

    # ---- 7. c5 backtest ---------------------------------------------------
    c5_backtest_phase(torch, trainer5, panel5, totals, seed_launches)
    del trainer5, panel5, splits5

    # ---- 8. c2 walk-forward ---------------------------------------------
    walkforward_phase(torch, cfg2, panel2, totals)
    del panel2, splits2

    # ---- 9. c3 training at full width -----------------------------------
    one = c3_phase(torch, kernels, totals, gen)

    # ---- 10. two ranks on the one card ----------------------------------
    two_ranks_phase(torch, one, totals)

    # ---- 11-14. the MLP, transformer and LRU ----------------------------
    one = new_models_phases(torch, kernels, totals, panels)

    # ---- 15. the seq axis: lc and lru on two ranks -----------------------
    seq_ranks_phase(torch, kernels, totals, one, panels)

    # ---- 16. the seed axis: c5 on two ranks ------------------------------
    seed_ranks_phase(torch, kernels, totals, seed_launches, one5, panels)

    # ---- 17. the factorized recurrences ----------------------------------
    factored_phase(torch, kernels, totals, panels)

    # ---- 18. the serving stack behind the HTTP front door -------------
    stack = serving_stack_phase(torch, totals, panels)
    print(json.dumps({"serving_stack": stack}), flush=True)
    del panels

    # ---- 19. kernels line -----------------------------------------------
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
    # The seed-batched launches: measured at the c5 train step, launches
    # counted over the c5 epoch.
    for k, (counter, src, rep) in SEED_SOURCES.items():
        meas = {f: kernels[k][0].get(f) for f in fields}
        line.append(dict(name=k, route="cuda",
                         source=f"lfm_quant_tpu_torch/{src}",
                         replaces=f"{SRC_REPO}/{rep}",
                         launches=seed_launches[counter], **meas))
    print(json.dumps({"kernels": line}), flush=True)

    # ---- 20. result -----------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
