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
   multiple of 4, an all-invalid row, f32 and bf16; bf16 at H 16 and 64
   reaches the tensor-core fused forward and both backwards, the rest the
   CUDA-core ones, and the launch counters must say so; gathers that take
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
   in bf16 the tensor-core forward (at 16, 32 and 64 rows per block too),
   both tensor-core backwards (the hoisted one beside the CUDA-core
   hoisted kernel on the same inputs, its private launcher), the hoisted
   CUDA-core forward, each backward's ``torch.matmul`` yardstick for its
   weight-gradient products; in float32 at the train step the CUDA-core
   lane (rows 1 to 4); two launches of each backward on the same inputs
   must give bitwise equal weight gradients;
4. serve: a ``ScoringService`` on the card with the c2 LSTM and the c3
   GRU universes at full width (random weights from a seed), warmed up,
   then closed-loop requests from 4 threads; every served score vector is
   checked against the plain path on the card, and the serving kernels'
   launch counters must have moved during the run;
5. train c2: ``Trainer.fit`` trains c2 (LSTM, full width and data, bf16)
   for one epoch on the kernels, then the same steps from the same init
   and sampler order run through the plain path on the card (plain
   recurrence differentiated by autograd, plain gather); the per-step
   losses must agree within atol and rtol 0.05 and be finite, and the
   training kernels' counters must have moved. A few steps of the
   hoisted form (``scan_impl="pallas"``: the CUDA-core forward, the
   tensor-core hoisted backward), of the GRU at c2's geometry, fused and
   hoisted, and of both cells and both forms in float32 (the CUDA-core
   kernels) run the same way; the hoisted bf16 step is also timed with
   its backward as routed and sent to the CUDA-core kernel, in turns.
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
7. print one ``{"kernels": [...]}`` line;
8. print the result line ``{"ok": true, "device": {...}}`` last.
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
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM
BF16_TOL = 0.05  # atol and rtol: the JAX package's own bf16 bound
F32_TOL = 1e-5   # atol: the JAX package's f32 bound for the fused op
# Scaled atol of the tensor-core backward's f32 weight gradients: its
# split of d_gates reads near 4e-6 at the c2 train step, rounding d_gates
# once to bf16 near 2e-3 (scripts/torch_mma_variants.py --kernel bwd).
MMA_WGRAD_TOL = 1e-4
GATES = {"lstm": 4, "gru": 3}
TRAIN_STEPS_SHORT = 4  # steps of the hoisted and GRU training runs
HOISTED_STEPS = 32     # timed steps of each backward in the hoisted c2 step
# The device's sleep (clock cycles, about 10 ms) while the host queues the
# launches that device_ms times.
SLEEP_CYCLES = 20_000_000

# name → (source in the port, the TPU kernel it replaces). The CUDA-core
# kernels of the fused form and of the hoisted backward run on the main
# paths in float32 only and are measured in float32 at the c2 train step;
# the hoisted forward runs in both and is measured in both.
SOURCES = {
    "rnn_fused_fwd_lstm": ("csrc/rnn_fused_fwd.cu", "pallas_rnn.py:626"),
    "rnn_fused_fwd_gru": ("csrc/rnn_fused_fwd.cu", "pallas_rnn.py:652"),
    "rnn_fused_fwd_mma_lstm": ("csrc/rnn_fused_fwd_mma.cu",
                               "pallas_rnn.py:626"),
    "rnn_fused_fwd_mma_gru": ("csrc/rnn_fused_fwd_mma.cu",
                              "pallas_rnn.py:652"),
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
    "window_gather": ("csrc/window_gather.cu", "pallas_gather.py:100"),
}
SERVE_KERNELS = ("rnn_fused_fwd_mma_lstm", "rnn_fused_fwd_mma_gru",
                 "window_gather")
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
C5_PLAIN_STEPS = 3   # c5 steps held against the plain path
C5_PLAIN_BLOCK = 8   # seed_block of the plain path (its autograd memory)
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
              itemsize: int, save_c: bool = False, seeds: int = 1):
    """Least time (ms) of one recurrence kernel call, and what bounds it:
    its products' operations at the peak for its operand type against
    each input read once and each output written once at the memory rate.

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
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_F32_FLOPS
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


def check_small(torch, gen) -> None:
    """Kernels against plain versions at small awkward shapes: odd batch,
    T = 1, H not a multiple of 4, all-invalid rows, young and tail
    anchors, a panel shorter than the window, float32 and bfloat16."""
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.ops.gather import gather_windows

    for cell in ("lstm", "gru"):
        for dt, atol, rtol in ((torch.float32, F32_TOL, 0.0),
                               (torch.bfloat16, BF16_TOL, BF16_TOL)):
            for B, T, H in ((13, 7, 12), (37, 1, 16), (3, 9, 8),
                            (37, 9, 64), (21, 5, 16)):
                hin, wx, b, wh, m = rnn_inputs(torch, gen, cell, B, T, H, dt)
                xw = (hin.float() @ wx.float() + b.float()).to(dt)
                # bf16 at H 16 and 64 takes the tensor-core forward and
                # backwards; f32 and the odd widths keep the CUDA-core ones.
                mma = R._mma_route(dt, H) == "mma"
                fwd_kernel = f"rnn_fused_fwd_{'mma_' if mma else ''}{cell}"
                bwd_kernel = f"rnn_fused_bwd_{'mma_' if mma else ''}{cell}"
                hoist_kernel = f"rnn_bwd_{'mma_' if mma else ''}{cell}"
                _build.reset_launch_counts()
                with torch.no_grad():
                    fused = R.rnn_scan_fused(cell, hin, wx, b, wh, m)
                    if _build.launch_counts()[fwd_kernel] != 1:
                        fail(f"fused fwd {cell} {dt} {(B, T, H)} did not "
                             f"launch {fwd_kernel}")
                    pairs = (
                        ("fused fwd", fused,
                         R.rnn_scan_fused_reference(cell, hin, wx, b, wh, m)),
                        ("fwd", R.rnn_scan(cell, xw, wh, m),
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
                    f"fwd ok ({fwd_kernel}), bwd scaled err fused {e4:.3g} "
                    f"({bwd_kernel}) hoisted {e2:.3g} ({hoist_kernel}) ok")
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


def check_fused_fwd(torch, kernels, where: str, cell: str, hin, wx, b, wh,
                    mm, save_c: bool) -> None:
    """Row 3 at a main path's shape in bf16: the tensor-core kernel (the
    route's choice at this H) against the plain version, timed beside the
    bound, and at 16, 32 and 64 rows per block."""
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
    report(kernels, name, where, dict(
        shape=[B, T, H], save_c=save_c, max_abs_err=err,
        tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}", **ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by,
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
    isz = hin.element_size()
    shape = [B, W, H]
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
            out = R.rnn_scan(cell, xw, wh, mm)
            ref = R.rnn_scan_reference(cell, xw, wh, mm)
            torch.cuda.synchronize()
            err, excess = worst_excess(out, ref, BF16_TOL, BF16_TOL)
            if excess > 0 or not torch.isfinite(out).all():
                fail(f"rnn fwd {cell} at the train shape: max err {err}")
            bound, by = rnn_bound("fwd", cell, B, W, H, isz)
            report(kernels, f"rnn_fwd_{cell}", "c2 train step", dict(
                shape=shape, max_abs_err=err,
                tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}",
                **kernel_ms(lambda: R.rnn_scan(cell, xw, wh, mm)),
                plain_ms=time_ms(lambda: R.rnn_scan_reference(
                    cell, xw, wh, mm), reps=3, warmup=1),
                bound_ms=bound, bound_by=by))
            del out, ref
            # Row 4, the fused backward, on the plain forward's states.
            check_fused_bwd(torch, kernels, cell, hin, wx, bb, wh, mm, dh)
            # Row 2, the hoisted backward.
            check_hoisted_bwd(torch, kernels, cell, xw, wh, mm, dh)
            del xw
            # The CUDA-core lane in float32 on the same inputs.
            check_f32_lane(torch, kernels, cell, hin, wx, bb, wh, mm, dh)
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


def check_f32_lane(torch, kernels, cell: str, hin, wx, b, wh, mm,
                   dh) -> None:
    """The CUDA-core kernels in float32 at the c2 train step, where the
    float32 training runs launch them: rows 3 and 1 (the fused and the
    hoisted forward, saving c_all as training does), rows 4 and 2 (the
    fused and the hoisted backward, each twice for bitwise equal weight
    gradients), each against its plain version at the JAX package's f32
    bound (atol 1e-5; gradients scaled by their largest magnitude) and
    timed beside its bound at the f32 peak outside the tensor cores (TF32
    would not hold 1e-5). The hoisted forward's float32 record goes under
    ``f32`` in its bf16 record, the others are their kernels' records."""
    from lfm_quant_tpu_torch.ops import rnn as R

    f32 = torch.float32
    hin, wx, b, wh, dh = (t.to(f32) for t in (hin, wx, b, wh, dh))
    B, T, H = hin.shape
    if R._mma_route(f32, H) != "simt":
        fail("the float32 lane is not the CUDA-core route")
    xw = hin @ wx + b

    def fwd_check(name, kind, run, want):
        out = run()
        torch.cuda.synchronize()
        err, excess = 0.0, 0.0
        for got, ref in zip(out, want):
            if got is None:
                continue
            e, x = worst_excess(got, ref, F32_TOL, 0.0)
            err, excess = max(err, e), max(excess, x)
            if not torch.isfinite(got).all():
                excess = float("inf")
        if excess > 0:
            fail(f"{name} (float32) at the train shape: max err {err}")
        del out
        bound, by = rnn_bound(kind, cell, B, T, H, 4, save_c=True)
        return dict(shape=[B, T, H], dtype="float32", save_c=True,
                    max_abs_err=err, tolerance=f"atol {F32_TOL}",
                    **kernel_ms(run, reps=5, launches=2), bound_ms=bound,
                    bound_by=by, library_ms=None)

    with torch.no_grad():
        want = R.rnn_scan_states(cell, xw, wh, mm, 1.0, True)
        plain_ms = time_ms(lambda: R.rnn_scan_states(
            cell, hin @ wx + b, wh, mm, 1.0, True), reps=3, warmup=1)
        rec = fwd_check(f"rnn_fused_fwd_{cell}", "fused_fwd",
                        lambda: R._fused_states(cell, hin, wx, b, wh, mm,
                                                1.0, True), want)
        report(kernels, f"rnn_fused_fwd_{cell}", "c2 train step",
               dict(rec, plain_ms=plain_ms))
        rec = fwd_check(f"rnn_fwd_{cell}", "fwd",
                        lambda: R._scan_states_any(cell, xw, wh, mm, 1.0,
                                                   True), want)
        rec["plain_ms"] = time_ms(lambda: R.rnn_scan_states(
            cell, xw, wh, mm, 1.0, True), reps=3, warmup=1)
        kernels[f"rnn_fwd_{cell}"][-1]["f32"] = rec
        log("kernel " + json.dumps(dict(name=f"rnn_fwd_{cell}",
                                        at="c2 train step", **rec)))
        h, c = want
        del want
    for kind, name, args, plain in (
            ("fused_bwd", f"rnn_fused_bwd_{cell}",
             (cell, hin, wx, b, wh, mm, h, c, dh),
             R.rnn_scan_fused_bwd_reference),
            ("bwd", f"rnn_bwd_{cell}", (cell, xw, wh, mm, h, c, dh),
             R.rnn_scan_bwd_reference)):
        run = ((lambda a=args: R.rnn_scan_fused_bwd(*a)) if kind ==
               "fused_bwd" else (lambda a=args: R.rnn_scan_bwd(*a)))
        want = plain(*args)
        one = run()
        two = run()
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(one[1:], two[1:])):
            fail(f"{name} (float32): two launches differ")
        err = grads_close(f"{name} (float32) at the train shape", one, want,
                          f32)
        del one, two, want
        bound, by = rnn_bound(kind, cell, B, T, H, 4)
        report(kernels, name, "c2 train step", dict(
            shape=[B, T, H], dtype="float32", max_abs_err=err,
            bitwise_repeatable=True, tolerance=f"scaled atol {F32_TOL}",
            **kernel_ms(run, reps=5, launches=2),
            plain_ms=time_ms(lambda a=args: plain(*a), reps=3, warmup=1),
            bound_ms=bound, bound_by=by, library_ms=None))
    del h, c, xw
    torch.cuda.empty_cache()


def check_fused_bwd(torch, kernels, cell: str, hin, wx, b, wh, mm,
                    dh) -> None:
    """Row 4 at the c2 train step in bf16: the tensor-core kernels (the
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
        fail(f"rnn fused bwd {cell} at the train shape: the route is not mma")
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
    err = grads_close(f"{name} at the train shape", one, want, hin.dtype,
                      MMA_WGRAD_TOL)
    wgrad_err = max(scaled_err(g, w) for g, w in zip(one[1:], want[1:]))
    del one, two, want
    ms = kernel_ms(run, reps=5, launches=4)
    report(kernels, name, "c2 train step", dict(
        shape=[B, T, H], max_abs_err=err, wgrad_scaled_err=wgrad_err,
        bitwise_repeatable=True,
        tolerance=f"scaled atol {BF16_TOL}, weight gradients "
                  f"{MMA_WGRAD_TOL}",
        **ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=library_ms,
        pack_wx_ms=time_ms(lambda: R.pack_fragments(wx)),
        pack_wxt_ms=time_ms(lambda: R.pack_fragments(wx, transpose=True))))
    log(f"rnn fused bwd {cell} at the c2 train step: tensor cores "
        f"{ms['ms']:.4f} ms (device {ms['device_ms']:.4f}), bound "
        f"{bound:.4f} ms, weight-gradient matmuls (library) {library_ms:.4f} "
        f"ms")
    torch.cuda.empty_cache()


def profile_device(torch, fn, label: str) -> None:
    """Device time by kernel name over ``fn`` under ``torch.profiler``,
    and the device's busy share of the wall time (summed kernel times over
    the wall clock). Informational: it runs after the launch counts were
    read."""
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
        return
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} "
        f"ms ({100 * busy / wall_ms:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")


def counted(label: str, must_move, fn):
    """Run one main path with every launch counter set to 0 just before
    and read just after; fail if a kernel of the path did not launch."""
    from lfm_quant_tpu_torch.ops import _build

    _build.reset_launch_counts()
    out = fn()
    counts = _build.launch_counts()
    log(f"launches during {label}: "
        f"{ {k: n for k, n in counts.items() if n} }")
    for k in must_move:
        if counts[k] == 0:
            fail(f"kernel {k} was not launched by the {label} path")
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
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    keys = list(state.params)
    trainer.model.train()
    torch.cuda.synchronize()
    ev[0].record()
    loss = trainer._loss(fi, ti, w)
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

    # The hoisted form (its backward on the tensor cores in bf16), the GRU
    # at c2's geometry, and both cells and both forms in float32 (the
    # CUDA-core kernels): a few steps each.
    runs = (("c2 training (hoisted)", train_variant(cfg, scan_impl="pallas"),
             ("rnn_fwd_lstm", "rnn_bwd_mma_lstm", "window_gather")),
            ("c2 training (fused, float32)", train_variant(cfg, bf16=False),
             ("rnn_fused_fwd_lstm", "rnn_fused_bwd_lstm", "window_gather")),
            ("c2 training (hoisted, float32)",
             train_variant(cfg, scan_impl="pallas", bf16=False),
             ("rnn_fwd_lstm", "rnn_bwd_lstm", "window_gather")),
            ("GRU training (fused)", train_variant(cfg, kind="gru"),
             ("rnn_fused_fwd_mma_gru", "rnn_fused_bwd_mma_gru",
              "window_gather")),
            ("GRU training (fused, float32)",
             train_variant(cfg, kind="gru", bf16=False),
             ("rnn_fused_fwd_gru", "rnn_fused_bwd_gru", "window_gather")),
            ("GRU training (hoisted)",
             train_variant(cfg, kind="gru", scan_impl="pallas"),
             ("rnn_fwd_gru", "rnn_bwd_mma_gru", "window_gather")),
            ("GRU training (hoisted, float32)",
             train_variant(cfg, kind="gru", scan_impl="pallas", bf16=False),
             ("rnn_fwd_gru", "rnn_bwd_gru", "window_gather")))
    for label, run_cfg, must in runs:
        got, counts = counted(label, must, lambda: short_run(
            torch, run_cfg, splits, TRAIN_STEPS_SHORT))
        for k, n_launch in counts.items():
            totals[k] += n_launch
        want = short_run(torch, plain_variant(run_cfg), splits,
                         TRAIN_STEPS_SHORT)
        err = losses_agree(label, got, want)
        log(f"{label}: {TRAIN_STEPS_SHORT} steps, losses "
            f"{[round(v, 6) for v in got]} agree with the plain path within "
            f"{err:.4g}")
        torch.cuda.empty_cache()
    hoisted_step(torch, runs[0][1], splits)


def hoisted_step(torch, cfg, splits) -> None:
    """The hoisted bf16 c2 step (``scan_impl="pallas"``) in ms per step,
    with its backward as routed (the tensor-core hoisted mode) and sent to
    the CUDA-core hoisted kernel (``_launch_bwd``, the route for float32),
    in turns: ``HOISTED_STEPS`` steps each, twice, host clock around
    synchronised work. Informational: it runs after the launch counts of
    the hoisted run were read."""
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, splits, device="cuda")
    state = trainer.init_state()
    fi, ti, w = trainer._batch(trainer.train_sampler.stacked_epoch(1))
    n = min(HOISTED_STEPS, fi.shape[0])

    def cuda_core(cell, xw, wh, m, h_all, c_all, dh, forget_bias):
        return R._launch_bwd(cell, False, xw, None, None, wh, m, h_all, c_all,
                             dh, forget_bias)

    def per_step():
        s = state
        for k in range(n):  # warm
            s, _ = trainer.step(s, fi[k], ti[k], w[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n):
            s, _ = trainer.step(s, fi[k], ti[k], w[k])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    routed = R._launch_scan_bwd_mma
    times = {"tensor_cores": [], "cuda_cores": []}
    try:
        for _ in range(2):
            for mode, launcher in (("tensor_cores", routed),
                                   ("cuda_cores", cuda_core)):
                R._launch_scan_bwd_mma = launcher
                times[mode].append(per_step())
    finally:
        R._launch_scan_bwd_mma = routed
    log("train c2 (hoisted) steady state, ms/step in turns: "
        + ", ".join(f"backward on the {label} "
                    f"{[round(t, 3) for t in times[mode]]}"
                    for mode, label in (("tensor_cores", "tensor cores"),
                                        ("cuda_cores", "CUDA cores")))
        + f" ({n} steps each)")
    del trainer, state
    torch.cuda.empty_cache()


def check_seed_batched(torch, trainer, kernels) -> None:
    """The c5 train step's seed-batched launches (S 64 x B 2048, T 60, H
    128, LSTM, bf16) on the layer-0 input of the first stacked batch of
    epoch 0 and the model's seeded weights: the gather folded over the
    seeds, exact; the fused forward and backward each bitwise equal to 64
    one-seed launches with the same rows per block, m of seed extent 1
    bitwise equal to its broadcast copy, and each seed within the plain
    version's tolerance; each timed beside its bound, the 64 one-seed
    launches and the plain version (one seed at a time); row 4's library
    yardstick is the per-seed weight-gradient products as one f32
    ``torch.bmm`` (random operands of the products' shapes)."""
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.ops.gather import gather_windows

    trainer.init_state()  # the seeded init of every member
    (fi_all, ti_all, _), _ = trainer._build_epoch(0)
    fi, ti = fi_all[0], ti_all[0]  # [S, D, Bf]
    S, D, Bf = fi.shape
    W, fp = trainer.window, trainer.fp
    xm = trainer.dev["xm"]
    x, m = gather_windows(xm, fi, ti, W, fp=fp)
    for s in range(S):
        xr, mr = gather_windows_packed(xm, fi[s], ti[s], W, fp=fp)
        if not (torch.equal(x[s], xr) and torch.equal(m[s], mr)):
            fail(f"seed-folded gather differs at seed {s}")
    fi_np = fi.reshape(S * D, Bf).cpu().numpy()
    ti_np = ti.reshape(S * D).cpu().numpy()
    report(kernels, "window_gather_seeds", "c5 train step", dict(
        shape=list(x.shape), max_abs_err=0.0, tolerance="exact",
        **kernel_ms(lambda: gather_windows(xm, fi, ti, W, fp=fp),
                    launches=20),
        plain_ms=time_ms(lambda: gather_windows_packed(
            xm, fi.reshape(S * D, Bf), ti.reshape(S * D), W, fp=fp)),
        bound_ms=gather_bound(fi_np, ti_np, W, fp, xm.shape[1],
                              xm.element_size()),
        bound_by="bytes", library_ms=None))
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
    for s in range(S):
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
        for s in range(S)], reps=3, warmup=1)
    plain_ms = time_ms(lambda: [R.rnn_scan_states(
        cell, hin[s].float() @ wx[s].float() + bb[s].float(), wh[s], mm[s],
        1.0, True) for s in range(S)], reps=1, warmup=0)
    report(kernels, "rnn_fused_fwd_mma_lstm_seeds", "c5 train step", dict(
        shape=[S, B, W, H], rows_per_block=rows, bitwise_vs_single=True,
        max_abs_err=worst, tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}",
        **ms, single_seed_launches_ms=singles_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None))
    log(f"seed-batched fused fwd at the c5 train step: {ms['ms']:.3f} ms "
        f"for 64 seeds in one launch, {singles_ms:.3f} ms in 64 launches, "
        f"bound {bound:.3f} ms")

    # Row 4 on the forward's states.
    gen = torch.Generator(device="cuda").manual_seed(5)
    dh = (0.1 * torch.randn(S, B, W, H, generator=gen, device="cuda")).to(cd)
    bargs = (cell, hin, wx, bb, wh, mm, h, c, dh)
    got = R.rnn_scan_fused_bwd(*bargs)
    torch.cuda.synchronize()
    worst = wgrad = 0.0
    for s in range(S):
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
        cell, *(t[s] for t in bargs[1:])) for s in range(S)], reps=1)
    plain_ms = time_ms(lambda: [R.rnn_scan_fused_bwd_reference(
        cell, *(t[s] for t in bargs[1:])) for s in range(S)], reps=1,
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
    report(kernels, "rnn_fused_bwd_mma_lstm_seeds", "c5 train step", dict(
        shape=[S, B, W, H], bitwise_vs_single=True, max_abs_err=worst,
        wgrad_scaled_err=wgrad,
        tolerance=f"scaled atol {BF16_TOL}, weight gradients "
                  f"{MMA_WGRAD_TOL}",
        **ms, single_seed_launches_ms=singles_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=library_ms))
    log(f"seed-batched fused bwd at the c5 train step: {ms['ms']:.3f} ms "
        f"for 64 seeds in one call, {singles_ms:.3f} ms in 64 calls, bound "
        f"{bound:.3f} ms, library bmm {library_ms:.3f} ms")
    del hin, mm
    torch.cuda.empty_cache()


def ensemble_steps(torch, cfg, splits, n_steps: int):
    """``n_steps`` c5 steps of a fresh ``EnsembleTrainer`` on the card from
    the seeded init and the epoch-0 sampler orders → per-step per-seed
    losses ``[n_steps][S]``."""
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer

    trainer = EnsembleTrainer(cfg, splits, device="cuda")
    state = trainer.init_state()
    (fi, ti, w), _ = trainer._build_epoch(0)
    losses = []
    for k in range(n_steps):
        state, ms = trainer.step(state, fi[k], ti[k], w[k])
        losses.append(ms["loss"])
    return torch.stack(losses).cpu().tolist()


def c5_phase(torch, cfg, splits, kernels, seed_launches) -> None:
    """Phase 6: c5, the 64-seed ensemble, for one epoch on the kernels;
    its epoch's launches go to ``seed_launches``."""
    import numpy as np

    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer

    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, epochs=1))
    trainer = EnsembleTrainer(cfg, splits, device="cuda")
    check_seed_batched(torch, trainer, kernels)

    # The first steps against the plain path on the card.
    got = ensemble_steps(torch, cfg, splits, C5_PLAIN_STEPS)
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
    del trainer
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
    from lfm_quant_tpu_torch.data.windows import (
        DateBatchSampler,
        gather_windows_packed,
    )
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops.gather import gather_windows
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
    for line in (_build.BUILD_INFO["ptxas"] or "").splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    # ---- 3. kernels against their plain versions ------------------------
    gen = torch.Generator().manual_seed(0)
    check_small(torch, gen)

    # The serving universes, and their plain paths on the card: the same
    # seeded params and device panel through the plain gather and the
    # plain recurrence (scan_impl / gather_impl "xla").
    universes = {}
    for name in ("c2", "c3"):
        cfg = get_preset(name)
        t0 = time.perf_counter()
        panel = resolve_panel(cfg.data)
        universes[name] = (cfg, panel, Predictor(plain_variant(cfg), panel))
        log(f"{name}: panel {panel.features.shape} built in "
            f"{time.perf_counter() - t0:.1f} s")

    max_rows = 8
    kernels = {}
    for name, cell in (("c2", "lstm"), ("c3", "gru")):
        cfg, panel, plain = universes[name]
        d = cfg.data
        fi_np, ti_np = widest_dispatch(panel, d, max_rows)
        xm = plain.dev["xm"]
        fp = panel.n_features + 1
        fi = torch.from_numpy(fi_np).cuda()
        ti = torch.from_numpy(ti_np).cuda()
        with torch.inference_mode():
            # Gather at the dispatch shape: exact.
            x, m = gather_windows(xm, fi, ti, d.window, fp=fp)
            xr, mr = gather_windows_packed(xm, fi, ti, d.window, fp=fp)
            torch.cuda.synchronize()
            if not (torch.equal(x, xr) and torch.equal(m, mr)):
                fail(f"gather at the {name} dispatch shape differs")
            report(kernels, "window_gather", f"{name} serving", dict(
                shape=list(x.shape), max_abs_err=0.0, tolerance="exact",
                **kernel_ms(lambda: gather_windows(xm, fi, ti, d.window,
                                                   fp=fp), launches=20),
                plain_ms=time_ms(lambda: gather_windows_packed(
                    xm, fi, ti, d.window, fp=fp)),
                bound_ms=gather_bound(fi_np, ti_np, d.window, fp,
                                      panel.n_months, xm.element_size()),
                bound_by="bytes"))
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
            del x, xr, m, mr, hin
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

        def serve_all():
            for name, n_requests in (("c2", 48), ("c3", 24)):
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

        _, counts = counted("serving", SERVE_KERNELS, serve_all)
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
    t0 = time.perf_counter()
    panel5 = resolve_panel(cfg5.data)
    splits5 = PanelSplits.by_date(
        panel5, *default_split_dates(panel5, cfg5.data),
        train_start=cfg5.data.train_start)
    log(f"c5: panel {panel5.features.shape} built in "
        f"{time.perf_counter() - t0:.1f} s")
    seed_launches = dict.fromkeys(_build.LAUNCHES, 0)
    c5_phase(torch, cfg5, splits5, kernels, seed_launches)

    # ---- 7. kernels line ------------------------------------------------
    line = []
    fields = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms")
    for k, (src, rep) in SOURCES.items():
        # The largest shape the main paths gave the kernel.
        meas = max(kernels[k], key=lambda r: int(np.prod(r["shape"])))
        rec = {f: meas.get(f) for f in fields}
        if "dtype" in meas:
            rec["dtype"] = meas["dtype"]
        if "f32" in meas:
            rec["f32"] = {f: meas["f32"].get(f) for f in fields}
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

    # ---- 8. result ------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
