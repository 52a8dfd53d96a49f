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
   reaches the tensor-core fused forward and backward, the rest the
   CUDA-core ones, and the launch counters must say so) — the forward
   kernels on their outputs, the backward kernels on every gradient
   (scaled by its largest magnitude: f32 atol 1e-5, bf16 0.05, the
   tensor-core backward's f32 weight gradients 1e-4); then at
   the shapes the main paths give them — the serving dispatches of the c2
   and c3 panels, and the c2 train step (B 2048, T 60, H 128) on a real
   index batch from ``stacked_epoch`` — timing kernel and plain version
   with CUDA events beside the kernel's bound; the fused forward and the
   fused backward at those shapes both on the tensor cores and on the
   CUDA cores (their private launchers), on the same inputs, the
   tensor-core forward at 16, 32 and 64 rows per block, and one
   ``torch.matmul`` yardstick for the backward's weight-gradient
   products; and two launches of each backward on the same inputs must
   give bitwise equal weight gradients;
4. serve: a ``ScoringService`` on the card with the c2 LSTM and the c3
   GRU universes at full width (random weights from a seed), warmed up,
   then closed-loop requests from 4 threads; every served score vector is
   checked against the plain path on the card, and the serving kernels'
   launch counters must have moved during the run;
5. train: ``Trainer.fit`` trains c2 (LSTM, full width and data, bf16)
   for one epoch on the kernels, then the same steps from the same init
   and sampler order run through the plain path on the card (plain
   recurrence differentiated by autograd, plain gather); the per-step
   losses must agree within atol and rtol 0.05 and be finite, and the
   training kernels' counters must have moved. A few steps of the
   hoisted form (``scan_impl="pallas"``), of the GRU at c2's geometry,
   fused and hoisted, and of both cells in float32 (their fused forward
   and backward on the CUDA cores) run the same way. Prints steps/s,
   firm-months/s, ms per step, the forward, backward and optimizer times
   of one step and the device time by kernel;
6. print one ``{"kernels": [...]}`` line;
7. print the result line ``{"ok": true, "device": {...}}`` last.
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

# name → (source in the port, the TPU kernel it replaces)
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
    "window_gather": ("csrc/window_gather.cu", "pallas_gather.py:100"),
}
SERVE_KERNELS = ("rnn_fused_fwd_mma_lstm", "rnn_fused_fwd_mma_gru",
                 "window_gather")


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
              itemsize: int, save_c: bool = False):
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
    also writes it."""
    G = GATES[cell]
    GH = G * H
    products = {"fused_fwd": 2, "fwd": 1, "fused_bwd": 6, "bwd": 3}[kind]
    ops = products * 2.0 * GH * H * B * T
    seq = B * T * H * itemsize
    xw = B * T * GH * itemsize
    weights = (2 * H + 1) * GH * itemsize
    c_all = seq if save_c and cell == "lstm" else 0
    if kind == "fused_fwd":
        nbytes = 2 * seq + c_all + B * T + weights
    elif kind == "fwd":
        nbytes = xw + seq + c_all + B * T + H * GH * itemsize
    else:
        states = (3 if cell == "lstm" else 2) * seq
        if kind == "fused_bwd":
            nbytes = seq + states + seq + weights + (2 * H + 1) * GH * 4
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
                # backward; f32 and the odd widths keep the CUDA-core ones.
                mma = R._mma_route(dt, H) == "mma"
                fwd_kernel = f"rnn_fused_fwd_{'mma_' if mma else ''}{cell}"
                bwd_kernel = f"rnn_fused_bwd_{'mma_' if mma else ''}{cell}"
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
                e2 = grads_close(
                    f"bwd {cell} {dt} {(B, T, H)}",
                    R.rnn_scan_bwd(cell, xw, wh, m, hx, cx, dh),
                    R.rnn_scan_bwd_reference(cell, xw, wh, m, hx, cx, dh),
                    dt)
                log(f"small rnn {cell} {str(dt)[6:]} B,T,H={(B, T, H)} "
                    f"fwd ok ({fwd_kernel}), bwd scaled err fused {e4:.3g} "
                    f"({bwd_kernel}) hoisted {e2:.3g} ok")
    for dt in (torch.float32, torch.bfloat16):
        for N, T, fp, W, D, Bf in ((7, 23, 4, 9, 5, 13), (7, 5, 4, 9, 3, 6),
                                   (11, 64, 6, 60, 4, 33)):
            xm = torch.randn(N, T, fp, generator=gen)
            xm[..., fp - 1] = (torch.rand(N, T, generator=gen) < 0.8).float()
            xm = xm.to(dt).cuda()
            fi = torch.randint(0, N, (D, Bf), generator=gen,
                               dtype=torch.int32).cuda()
            ti = torch.randint(0, T, (D,), generator=gen,
                               dtype=torch.int32).cuda()
            ti[0], ti[-1] = 0, T - 1  # youngest and newest anchors
            x, m = gather_windows(xm, fi, ti, W, fp=fp)
            xr, mr = gather_windows_packed(xm, fi, ti, W, fp=fp)
            torch.cuda.synchronize()
            if not (torch.equal(x, xr) and torch.equal(m, mr)):
                fail(f"gather {dt} {(N, T, fp, W, D, Bf)} differs")
            log(f"small gather {str(dt)[6:]} N,T,fp,W,D,Bf="
                f"{(N, T, fp, W, D, Bf)} exact ok")


def report(kernels: dict, name: str, where: str, rec: dict) -> None:
    """Keep one kernel measurement and print it as a JSON line."""
    kernels.setdefault(name, []).append(rec)
    log("kernel " + json.dumps(dict(name=name, at=where, **rec)))


def check_fused_fwd(torch, kernels, where: str, cell: str, hin, wx, b, wh,
                    mm, save_c: bool) -> None:
    """Row 3 at a main path's shape: the tensor-core kernel (the route's
    choice for bf16 at this H) and the CUDA-core kernel (its private
    launcher) on the same inputs, each against the plain version and
    timed beside the bound, and the tensor-core kernel at 16, 32 and 64
    rows per block."""
    from lfm_quant_tpu_torch.ops import rnn as R

    B, T, H = hin.shape
    if R._mma_route(hin.dtype, H) != "mma":
        fail(f"rnn fused fwd {cell} at {where}: the route is not mma")
    want_h, want_c = R.rnn_scan_states(
        cell, hin.float() @ wx.float() + b.float(), wh, mm, 1.0, save_c)
    runs = {
        f"rnn_fused_fwd_mma_{cell}": lambda: R._fused_states(
            cell, hin, wx, b, wh, mm, 1.0, save_c),
        f"rnn_fused_fwd_{cell}": lambda: R._launch_fwd(
            cell, False, hin, wx, b, wh, mm, 1.0, save_c),
    }
    bound, by = rnn_bound("fused_fwd", cell, B, T, H, hin.element_size(),
                          save_c)
    plain_ms = time_ms(lambda: R.rnn_scan_states(
        cell, hin.float() @ wx.float() + b.float(), wh, mm, 1.0, save_c),
        reps=3, warmup=1)
    ms = {}
    for name, run in runs.items():
        h, c = run()
        torch.cuda.synchronize()
        err, excess = worst_excess(h, want_h, BF16_TOL, BF16_TOL)
        if c is not None:
            c_err, c_excess = worst_excess(c, want_c, BF16_TOL, BF16_TOL)
            err, excess = max(err, c_err), max(excess, c_excess)
        if excess > 0 or not torch.isfinite(h).all():
            fail(f"{name} at {where}: max err {err}")
        del h, c
        ms[name] = time_ms(run)
        rec = dict(shape=[B, T, H], save_c=save_c, max_abs_err=err,
                   tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}",
                   ms=ms[name], plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by)
        if "mma" in name:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            rec["rows_per_block"] = R._mma_rows(B, sms)
            rec["rows_ms"] = {rows: time_ms(lambda: R._launch_fwd_mma(
                cell, hin, wx, b, wh, mm, 1.0, save_c, rows))
                for rows in R.MMA_ROWS}
        report(kernels, name, where, rec)
    mma, simt = ms[f"rnn_fused_fwd_mma_{cell}"], ms[f"rnn_fused_fwd_{cell}"]
    log(f"rnn fused fwd {cell} at {where}: tensor cores {mma:.4f} ms, CUDA "
        f"cores {simt:.4f} ms ({simt / mma:.2f}x), bound {bound:.4f} ms")
    del want_h, want_c
    torch.cuda.empty_cache()


def check_train_shapes(torch, trainer, kernels, gen) -> None:
    """Rows 1, 2, 3 and 4 at the c2 train step's shape: the layer-0 input
    of a real index batch (the first batch of ``stacked_epoch(0)``), LSTM
    with the model's own weights and GRU with seeded ones, bf16. Each
    kernel against its plain version, timed beside its bound (row 3
    saving c_all, as the training forward does); each backward twice for
    bitwise equal weight gradients."""
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
                ms=time_ms(lambda: R.rnn_scan(cell, xw, wh, mm)),
                plain_ms=time_ms(lambda: R.rnn_scan_reference(
                    cell, xw, wh, mm), reps=3, warmup=1),
                bound_ms=bound, bound_by=by))
            del out, ref
            # Row 4, the fused backward, on the plain forward's states.
            check_fused_bwd(torch, kernels, cell, hin, wx, bb, wh, mm, dh)
            # Row 2, the hoisted backward.
            hx, cx = R.rnn_scan_states(cell, xw, wh, mm)
            args = (cell, xw, wh, mm, hx, cx, dh)
            one = R.rnn_scan_bwd(*args)
            two = R.rnn_scan_bwd(*args)
            if not torch.equal(one[1], two[1]):
                fail(f"rnn bwd {cell}: two launches differ")
            err = grads_close(f"bwd {cell} at the train shape", one,
                              R.rnn_scan_bwd_reference(*args), cd)
            bound, by = rnn_bound("bwd", cell, B, W, H, isz)
            report(kernels, f"rnn_bwd_{cell}", "c2 train step", dict(
                shape=shape, max_abs_err=err, bitwise_repeatable=True,
                tolerance=f"scaled atol {BF16_TOL}",
                ms=time_ms(lambda: R.rnn_scan_bwd(*args), reps=5),
                plain_ms=time_ms(lambda: R.rnn_scan_bwd_reference(*args),
                                 reps=3, warmup=1),
                bound_ms=bound, bound_by=by))
            del one, two, hx, cx, xw
    torch.cuda.empty_cache()


def check_fused_bwd(torch, kernels, cell: str, hin, wx, b, wh, mm,
                    dh) -> None:
    """Row 4 at the c2 train step: the tensor-core kernels (the route's
    choice for bf16 at this H) and the CUDA-core kernels (their private
    launcher) on the same inputs, each twice for bitwise equal weight
    gradients, against the plain version (the tensor cores' weight
    gradients at ``MMA_WGRAD_TOL``) and timed beside the bound; the
    ``library_ms`` yardstick of the weight-gradient products, two f32
    ``torch.matmul`` calls (hin^T d_xw + h_{t-1}^T d_hw) that the port
    never makes; and the time of the two packings of W_x that the
    tensor-core wrapper makes when the forward's is not passed in."""
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
    runs = {
        f"rnn_fused_bwd_mma_{cell}": lambda: R.rnn_scan_fused_bwd(*args),
        f"rnn_fused_bwd_{cell}": lambda: R._launch_bwd(
            cell, True, hin, wx, b, wh, mm, h, c, dh, 1.0),
    }
    ms = {}
    for name, run in runs.items():
        one = run()
        two = run()
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(one[1:], two[1:])):
            fail(f"{name}: two launches differ")
        mma = "mma" in name
        err = grads_close(f"{name} at the train shape", one, want,
                          hin.dtype, MMA_WGRAD_TOL if mma else None)
        wgrad_err = max(scaled_err(g, w) for g, w in zip(one[1:], want[1:]))
        del one, two
        ms[name] = time_ms(run, reps=5)
        rec = dict(
            shape=[B, T, H], max_abs_err=err, wgrad_scaled_err=wgrad_err,
            bitwise_repeatable=True,
            tolerance=f"scaled atol {BF16_TOL}"
            + (f", weight gradients {MMA_WGRAD_TOL}" if mma else ""),
            ms=ms[name], plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=library_ms if mma else None)
        if mma:
            rec["pack_wx_ms"] = time_ms(lambda: R.pack_fragments(wx))
            rec["pack_wxt_ms"] = time_ms(
                lambda: R.pack_fragments(wx, transpose=True))
        report(kernels, name, "c2 train step", rec)
    mma, simt = ms[f"rnn_fused_bwd_mma_{cell}"], ms[f"rnn_fused_bwd_{cell}"]
    log(f"rnn fused bwd {cell} at the c2 train step: tensor cores "
        f"{mma:.4f} ms, CUDA cores {simt:.4f} ms ({simt / mma:.2f}x), bound "
        f"{bound:.4f} ms, weight-gradient matmuls (library) {library_ms:.4f} "
        f"ms")
    del want
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
    then the short hoisted and GRU runs."""
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

    # The hoisted form, the GRU at c2's geometry, and both cells in
    # float32 (whose fused forward and backward are the CUDA-core
    # kernels): a few steps each.
    runs = (("c2 training (hoisted)", train_variant(cfg, scan_impl="pallas"),
             ("rnn_fwd_lstm", "rnn_bwd_lstm", "window_gather")),
            ("c2 training (fused, float32)", train_variant(cfg, bf16=False),
             ("rnn_fused_fwd_lstm", "rnn_fused_bwd_lstm", "window_gather")),
            ("GRU training (fused)", train_variant(cfg, kind="gru"),
             ("rnn_fused_fwd_mma_gru", "rnn_fused_bwd_mma_gru",
              "window_gather")),
            ("GRU training (fused, float32)",
             train_variant(cfg, kind="gru", bf16=False),
             ("rnn_fused_fwd_gru", "rnn_fused_bwd_gru", "window_gather")),
            ("GRU training (hoisted)",
             train_variant(cfg, kind="gru", scan_impl="pallas"),
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

    from lfm_quant_tpu_torch.buckets import width_ladder
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
        sampler = DateBatchSampler(panel, d.window, 1, 8,
                                   min_valid_months=d.min_valid_months,
                                   min_cross_section=1, require_target=False)
        cols = sampler.months_with_anchors()
        width = max(width_ladder(sampler.cross_section(int(t)).size
                                 for t in cols))
        fi_np, ti_np = serving_batch(sampler.cross_section, cols, width,
                                     max_rows)
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
                ms=time_ms(lambda: gather_windows(xm, fi, ti, d.window,
                                                  fp=fp)),
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

    # ---- 6. kernels line ------------------------------------------------
    line = []
    for k, (src, rep) in SOURCES.items():
        # The largest shape the main paths gave the kernel.
        meas = max(kernels[k], key=lambda r: int(np.prod(r["shape"])))
        meas = {f: meas.get(f) for f in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}
        line.append(dict(name=k, route="cuda",
                         source=f"lfm_quant_tpu_torch/{src}",
                         replaces=f"{SRC_REPO}/{rep}", launches=totals[k],
                         **meas))
    print(json.dumps({"kernels": line}), flush=True)

    # ---- 7. result ------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
