#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``lfm_quant_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout around this file; it
imports nothing of JAX. Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``lfm_quant_tpu_torch/csrc`` and print the
   build time and the compiler's register report;
3. hold every kernel against its plain PyTorch version on the card,
   first at small awkward shapes, then at the shapes the serving path
   gives it (real index batches of the c2 and c3 panels), and time both
   with CUDA events (TF32 off);
4. serve: a ``ScoringService`` on the card with the c2 LSTM and the c3
   GRU universes at full width (random weights from a seed), warmed up,
   then closed-loop requests from 4 threads; every served score vector is
   checked against the plain path on the card, and every kernel's launch
   counter must have moved during the run;
5. print one ``{"kernels": [...]}`` line;
6. print the result line ``{"ok": true, "device": {...}}`` last.
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
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM
BF16_TOL = 0.05  # atol and rtol: the JAX package's own bf16 bound
F32_TOL = 1e-5   # atol: the JAX package's f32 bound for the fused op


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


def rnn_bound(cell: str, B: int, T: int, H: int, itemsize: int):
    """Least time (ms) for the fused recurrence: 4 * G * H * H operations
    per row and step (the two products) at the bf16 tensor-core peak,
    against hin in, h out, the mask and the weights at the memory rate."""
    G = 4 if cell == "lstm" else 3
    ops = 4.0 * G * H * H * B * T
    nbytes = 2 * B * T * H * itemsize + B * T + (2 * H + 1) * G * H * itemsize
    t_ops = ops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_small(torch, gen) -> None:
    """Kernels against plain versions at small awkward shapes: odd batch,
    H not a multiple of 4, all-invalid rows, young and tail anchors, a
    panel shorter than the window, float32 and bfloat16."""
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed
    from lfm_quant_tpu_torch.ops.gather import gather_windows
    from lfm_quant_tpu_torch.ops.rnn import (
        rnn_scan_fused,
        rnn_scan_fused_reference,
    )

    for cell, G in (("lstm", 4), ("gru", 3)):
        for dt, atol, rtol in ((torch.float32, F32_TOL, 0.0),
                               (torch.bfloat16, BF16_TOL, BF16_TOL)):
            for B, T, H in ((13, 7, 12), (37, 5, 16), (3, 9, 8)):
                hin = torch.randn(B, T, H, generator=gen).to(dt).cuda()
                wx = (0.3 * torch.randn(H, G * H, generator=gen)).to(dt).cuda()
                b = (0.1 * torch.randn(G * H, generator=gen)).to(dt).cuda()
                wh = (0.3 * torch.randn(H, G * H, generator=gen)).to(dt).cuda()
                m = (torch.rand(B, T, generator=gen) < 0.75).cuda()
                m[0] = False  # an all-invalid row stays at the zero state
                out = rnn_scan_fused(cell, hin, wx, b, wh, m)
                ref = rnn_scan_fused_reference(cell, hin, wx, b, wh, m)
                torch.cuda.synchronize()
                err, excess = worst_excess(out, ref, atol, rtol)
                if excess > 0 or out[0].abs().max().item() != 0:
                    fail(f"rnn {cell} {dt} {(B, T, H)}: max err {err}")
                log(f"small rnn {cell} {str(dt)[6:]} B,T,H={(B, T, H)} "
                    f"max_abs_err={err:.3g} ok")
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


def report(kernels: dict, name: str, universe: str, rec: dict) -> None:
    """Keep one kernel measurement and print it as a JSON line."""
    kernels.setdefault(name, []).append(rec)
    log("kernel " + json.dumps(dict(name=name, universe=universe, **rec)))


def profile_serving(torch, service, drive_load) -> None:
    """Where a served request's time goes: device time by kernel name over
    a closed-loop c2 load under ``torch.profiler``, and the device's busy
    share of the wall time (summed kernel times over the wall clock).
    Informational: it runs after the launch counts were read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    drive_load(service, "c2", 8, 4)  # warm the profiler's own path
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drive_load(service, "c2", 32, 4, seed=1)
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
        log("profile: no device time in the trace (not measured)")
        return
    log(f"profile c2, 32 requests from 4 threads: wall {wall_ms:.2f} ms, "
        f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")


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
    from lfm_quant_tpu_torch.data.windows import (
        DateBatchSampler,
        gather_windows_packed,
    )
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops.gather import gather_windows
    from lfm_quant_tpu_torch.ops.rnn import (
        rnn_scan_fused,
        rnn_scan_fused_reference,
    )
    from lfm_quant_tpu_torch.serve import ScoringService
    from lfm_quant_tpu_torch.serve.__main__ import drive_load
    from lfm_quant_tpu_torch.train.loop import Predictor, resolve_panel

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
        plain_cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, gather_impl="xla"),
            model=dataclasses.replace(cfg.model, scan_impl="xla"))
        universes[name] = (cfg, panel, Predictor(plain_cfg, panel))
        log(f"{name}: panel {panel.features.shape} built in "
            f"{time.perf_counter() - t0:.1f} s")

    max_rows = 8
    kernels = {}
    for name, cell in (("c2", "lstm"), ("c3", "gru")):
        cfg, panel, plain = universes[name]
        d = cfg.data
        sampler = DateBatchSampler(panel, d.window, d.min_valid_months,
                                   require_target=False)
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
            g_ms = time_ms(lambda: gather_windows(xm, fi, ti, d.window,
                                                  fp=fp))
            g_plain = time_ms(lambda: gather_windows_packed(
                xm, fi, ti, d.window, fp=fp))
            g_bound = gather_bound(fi_np, ti_np, d.window, fp,
                                   panel.n_months, xm.element_size())
            report(kernels, "window_gather", name, dict(
                shape=list(x.shape), max_abs_err=0.0, tolerance="exact",
                ms=g_ms, plain_ms=g_plain, bound_ms=g_bound,
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
            out = rnn_scan_fused(cell, hin, wx, b, wh, mm)
            ref = rnn_scan_fused_reference(cell, hin, wx, b, wh, mm)
            torch.cuda.synchronize()
            err, excess = worst_excess(out, ref, BF16_TOL, BF16_TOL)
            if excess > 0 or not torch.isfinite(out).all():
                fail(f"rnn {cell} at B={B}: max err {err}")
            r_ms = time_ms(lambda: rnn_scan_fused(cell, hin, wx, b, wh, mm))
            r_plain = time_ms(lambda: rnn_scan_fused_reference(
                cell, hin, wx, b, wh, mm), reps=5)
            r_bound, r_by = rnn_bound(cell, B, d.window, model.hidden,
                                      hin.element_size())
            report(kernels, f"rnn_fused_fwd_{cell}", name, dict(
                shape=list(hin.shape), max_abs_err=err,
                tolerance=f"atol {BF16_TOL} + rtol {BF16_TOL}", ms=r_ms,
                plain_ms=r_plain, bound_ms=r_bound, bound_by=r_by))
            del x, xr, m, mr, hin, out, ref
        torch.cuda.empty_cache()

    # The c2 dispatch at 8 rows of 4096 (32768 sequences), both cells.
    cfg, panel, plain = universes["c2"]
    with torch.inference_mode():
        B, T, H = 32768, cfg.data.window, 128
        hin = (0.5 * torch.randn(B, T, H, generator=gen)).to(
            torch.bfloat16).cuda()
        mm = (torch.rand(B, T, generator=gen) < 0.9).cuda()
        for cell, G in (("lstm", 4), ("gru", 3)):
            sd = H ** -0.5
            wx = (sd * torch.randn(H, G * H, generator=gen)).to(
                torch.bfloat16).cuda()
            wh = (sd * torch.randn(H, G * H, generator=gen)).to(
                torch.bfloat16).cuda()
            b = torch.zeros(G * H, dtype=torch.bfloat16, device="cuda")
            out = rnn_scan_fused(cell, hin, wx, b, wh, mm)
            ref = rnn_scan_fused_reference(cell, hin, wx, b, wh, mm)
            torch.cuda.synchronize()
            err, excess = worst_excess(out, ref, BF16_TOL, BF16_TOL)
            if excess > 0:
                fail(f"rnn {cell} at B=32768: max err {err}")
            r_ms = time_ms(lambda: rnn_scan_fused(cell, hin, wx, b, wh, mm),
                           reps=5)
            r_bound, r_by = rnn_bound(cell, B, T, H, 2)
            log(f"rnn {cell} B,T,H=(32768, {T}, {H}) random inputs "
                f"max_abs_err={err:.4g}: kernel {r_ms:.3f} ms, bound "
                f"{r_bound:.4f} ms ({r_by})")
        del hin, mm, out, ref
    torch.cuda.empty_cache()

    # ---- 4. serve ---------------------------------------------------------
    served = {}
    with ScoringService(device="cuda", max_rows=max_rows) as service:
        for name, (cfg, panel, _) in universes.items():
            t0 = time.perf_counter()
            service.register(name, cfg, panel)
            torch.cuda.synchronize()
            log(f"{name}: registered and warmed in "
                f"{time.perf_counter() - t0:.1f} s")
        _build.reset_launch_counts()
        for name, n_requests in (("c2", 64), ("c3", 32)):
            service.reset_stats()
            t0 = time.perf_counter()
            served[name] = drive_load(service, name, n_requests, 4)
            wall = time.perf_counter() - t0
            st = service.stats()
            log(f"serve {name}: {st['completed']} requests in {wall:.3f} s, "
                f"{st['req_per_s']:.2f} req/s, p50 {st['p50_ms']:.3f} ms, "
                f"p99 {st['p99_ms']:.3f} ms, occupancy "
                f"{st['mean_occupancy']:.3f}, batches {st['batches']}")
            if st["completed"] != n_requests or st["dispatch_errors"]:
                fail(f"serve {name}: {st}")
        launches = _build.launch_counts()
        profile_serving(torch, service, drive_load)
    log(f"launches during serving: {launches}")
    for k, n in launches.items():
        if n == 0:
            fail(f"kernel {k} was not launched by the serving path")

    worst = 0.0
    for name, responses in served.items():
        cfg, panel, plain = universes[name]
        sampler = DateBatchSampler(panel, cfg.data.window,
                                   cfg.data.min_valid_months,
                                   require_target=False)
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

    # ---- 5. kernels line ------------------------------------------------
    sources = {
        "rnn_fused_fwd_lstm": ("lfm_quant_tpu_torch/csrc/rnn_fused_fwd.cu",
                               f"{SRC_REPO}/pallas_rnn.py:626"),
        "rnn_fused_fwd_gru": ("lfm_quant_tpu_torch/csrc/rnn_fused_fwd.cu",
                              f"{SRC_REPO}/pallas_rnn.py:652"),
        "window_gather": ("lfm_quant_tpu_torch/csrc/window_gather.cu",
                          f"{SRC_REPO}/pallas_gather.py:100"),
    }
    line = []
    for k, (src, rep) in sources.items():
        # The largest dispatch shape the serving path gave the kernel.
        meas = max(kernels[k], key=lambda r: int(np.prod(r["shape"])))
        line.append(dict(name=k, route="cuda", source=src, replaces=rep,
                         launches=launches[k], library_ms=None, **meas))
    print(json.dumps({"kernels": line}), flush=True)

    # ---- 6. result ------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
