#!/usr/bin/env python3
"""Where the time of the tensor-core recurrence kernels goes, on the card.

    python3 scripts/torch_mma_variants.py [--kernel fwd|bwd]
                                          [--variants a,b+c] [--out FILE]
                                          [--parent FILE]

Builds variants of ``lfm_quant_tpu_torch/csrc/rnn_fused_fwd_mma.cu``
(``--kernel fwd``, the default) or ``rnn_fused_bwd_mma.cu`` (``bwd``),
each made from the committed source by named text substitutions (``b+c``
applies both), into separate shared libraries (one ``nvcc`` each, all
started together), and times every variant with CUDA events at the main
paths' shapes, T 60, H 128, bf16, random seeded inputs: the forward at
c2 serving (LSTM B 16384), c3 serving (GRU B 32768) and the c2 train step
(LSTM B 2048 with c_all), each at the rows per block it is built for; the
backward, fused and hoisted, at the c2 train step (LSTM and GRU, B 2048),
where a variant fits in shared memory. Variants that keep the arithmetic
are held to the plain version (forward: bf16 atol/rtol 0.05; backward:
gradients scaled by their largest magnitude, atol 0.05 for the bf16 dhin
or dxw and 1e-4 for the f32 weight gradients, which rounding d_gates once
to bf16 fails);
``alt_*`` variants change the numerics and only record their error;
``diag_*`` ones remove a part of the work and give wrong numbers on
purpose, to show what that part costs. ``--parent FILE`` (``--kernel
bwd``) adds the variant ``parent``, built from another version of the
backward source (for example an earlier commit's, unpacked with ``git
archive``), and records for every variant of the fused backward whether
its outputs are bitwise those of ``parent``. Prints one line per measurement and writes them as JSON lines to
``--out`` (default ``build/mma_variants/fwd.jsonl`` or ``bwd.jsonl``).
Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lfm_quant_tpu_torch", "csrc")
SRC = {"fwd": os.path.join(CSRC, "rnn_fused_fwd_mma.cu"),
       "bwd": os.path.join(CSRC, "rnn_fused_bwd_mma.cu")}
BUILD = os.path.join(ROOT, "build", "mma_variants")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I", CSRC]

_FAST_MATH = [
    ("  return __frcp_rn(1.0f + expf(-v));\n}\n",
     "  return __fdividef(1.0f, 1.0f + __expf(-v));\n}\n\n"
     "__device__ __forceinline__ float fast_tanh(float v) {\n"
     "  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * v));\n}\n"),
    ("tanhf(", "fast_tanh("),
]
FWD_VARIANTS = {
    "base": [],
    "fast_math": _FAST_MATH,
    # Diagnostics: W_x's fragments read from the shared W_h instead of L2;
    # the transcendentals replaced by the identity; no products.
    "diag_no_wx_l2": [("bx[n] = __ldg(wx_w + koff + n * 32);",
                       "bx[n] = wh_w[koff + n * 32];")],
    # No products at all (nor W_x reads): the step's other work alone.
    "diag_no_products": [("for (int kk = 0; kk < KT; ++kk) {",
                          "for (int kk = 0; kk < 0; ++kk) {")],
    "diag_no_transcendentals": [
        ("  return __frcp_rn(1.0f + expf(-v));\n",
         "  return v;\n}\n\n__device__ __forceinline__ float ident(float v) {\n"
         "  return v;\n"),
        ("tanhf(", "ident("),
    ],
}
_IDENTITY = [
    ("  return __frcp_rn(1.0f + expf(-v));\n",
     "  return v;\n}\n\n__device__ __forceinline__ float ident(float v) {\n"
     "  return v;\n"),
    ("tanhf(", "ident("),
]
BWD_VARIANTS = {
    "base": [],
    # d_gates rounded once to bf16 in every product with it (one term).
    "alt_round_once": [("constexpr int kSplit = 2;",
                        "constexpr int kSplit = 1;")],
    # 32 rows per block of the reverse recurrence instead of 16.
    "rows_32": [("constexpr int kRowTiles = 1;",
                 "constexpr int kRowTiles = 2;")],
    # Diagnostics: the reverse recurrence alone (no weight gradients); its
    # products removed; the transcendentals replaced by the identity.
    "diag_no_wgrad": [("\n  const int M = B * Tn;\n",
                       "\n  return err;\n  const int M = B * Tn;\n")],
    "diag_no_products": [("for (int kk = 0; kk < KT; ++kk) {",
                          "for (int kk = 0; kk < 0; ++kk) {"),
                         ("for (int ks = 0; ks < KB; ++ks) {",
                          "for (int ks = 0; ks < 0; ++ks) {")],
    "diag_no_transcendentals": _IDENTITY,
}
# The hoisted mode's xw_t staged in shared memory by cp.async, double
# buffered beside the h_{t-1} tiles ([rows, G H + 8] bf16, in the place of
# the fused mode's bias), instead of loaded a step ahead into registers.
BWD_VARIANTS["xw_staged"] = [
    ("              (hoist ? 2 : 4) * (size_t)rows * (H + 8) +\n",
     "              (hoist ? 2 * (size_t)rows * (H + 8 + G * H + 8)\n"
     "                     : 4 * (size_t)rows * (H + 8)) +\n"),
    ("  float* bias_s = reinterpret_cast<float*>(dg_s + kSplit * BB * LG);\n",
     "  float* bias_s = reinterpret_cast<float*>(dg_s + kSplit * BB * LG);\n"
     "  __nv_bfloat16* xw_s = dg_s + kSplit * BB * LG;  // HOIST\n"),
    ("      cp_async16(hd + r * LD + k, hv ? h_all + (row - 1) * H + k : h_all,\n"
     "                 hv ? 16 : 0);\n    }\n",
     "      cp_async16(hd + r * LD + k, hv ? h_all + (row - 1) * H + k : h_all,\n"
     "                 hv ? 16 : 0);\n    }\n"
     "    if (HOIST)\n"
     "      for (int i = tid; i < BB * (GH / 8); i += nth) {\n"
     "        const int r = i / (GH / 8);\n"
     "        const int k = (i - r * (GH / 8)) * 8;\n"
     "        const bool in = r < nr;\n"
     "        const size_t row = (size_t)(r0 + r) * Tn + t;\n"
     "        cp_async16(xw_s + (buf * BB + r) * (GH + 8) + k,\n"
     "                   in ? hin + row * GH + k : hin, in ? 16 : 0);\n"
     "      }\n"),
    ("  if (HOIST) load_xw(Tn - 1);\n", ""),
    ("    if (HOIST && t > 0) load_xw(t - 1);\n", ""),
    ("__bfloat1622float2(xwn[rt][i >> 1][q < G ? q : 0])",
     "__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(\n"
     "                          xw_s + (cur * BB + rt * 16 + row_l +\n"
     "                                  8 * (i >> 1)) * (GH + 8) +\n"
     "                          (q < G ? q : 0) * H + u))"),
]
VARIANTS = {"fwd": FWD_VARIANTS, "bwd": BWD_VARIANTS}
# Forward: (where, cell, B, save_c, rows per block)
SHAPES = (("c2 serving", "lstm", 16384, False, (64, 32)),
          ("c3 serving", "gru", 32768, False, (64, 32)),
          ("c2 8192 rows", "lstm", 8192, False, (64, 32, 16)),
          ("c2 train step", "lstm", 2048, True, (16, 32)))
# The backward's scaled bound on dW_x, db and dW_h (as chip_smoke.py).
WGRAD_TOL = 1e-4
# Backward: (where, cell, B)
BWD_SHAPES = (("c2 train step", "lstm", 2048),
              ("c2 train step", "gru", 2048))
# The hoisted backward: (where, cell, B)
HOISTED_SHAPES = (("c2 train step, hoisted", "lstm", 2048),
                  ("c2 train step, hoisted", "gru", 2048))


def variant_source(kernel: str, name: str, parent=None) -> str:
    if name == "parent":
        return open(parent).read()
    src = open(SRC[kernel]).read()
    for part in name.split("+"):
        for old, new in VARIANTS[kernel][part]:
            if old not in src:
                raise SystemExit(f"variant {part}: pattern not in the "
                                 f"source:\n{old}")
            src = src.replace(old, new)
    return src


def build(kernel: str, names, parent=None):
    os.makedirs(BUILD, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for name in names:
        cu = os.path.join(BUILD, f"{kernel}-{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(kernel, name, parent))
        procs[name] = subprocess.Popen(
            [nvcc, *FLAGS, cu, "-o",
             os.path.join(BUILD, f"{kernel}-{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cll = ctypes.c_longlong
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] ptxas: {line.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(BUILD, f"{kernel}-{name}.so"))
        if kernel == "fwd":
            lib.lfm_rnn_fused_fwd_mma.argtypes = (
                [ci] + [vp] * 7 + [ci] * 5 + [cll] * 5 + [cf, vp])
            lib.lfm_rnn_fused_fwd_mma.restype = ci
        else:
            lib.lfm_rnn_fused_bwd_mma.argtypes = (
                [ci] + [vp] * 13 + [ci, vp] + [ci] * 4 + [cll] * 5
                + [cf, vp])
            lib.lfm_rnn_fused_bwd_mma.restype = ci
            lib.lfm_rnn_fused_bwd_mma_smem.argtypes = [ci, ci]
            lib.lfm_rnn_fused_bwd_mma_smem.restype = ctypes.c_longlong
            if not hasattr(lib, "lfm_rnn_scan_bwd_mma"):
                libs[name] = lib  # a source without the hoisted mode
                continue
            lib.lfm_rnn_scan_bwd_mma.argtypes = (
                [ci] + [vp] * 9 + [ci, vp] + [ci] * 4 + [cll] * 3
                + [cf, vp])
            lib.lfm_rnn_scan_bwd_mma.restype = ci
            lib.lfm_rnn_scan_bwd_mma_smem.argtypes = [ci, ci]
            lib.lfm_rnn_scan_bwd_mma_smem.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def time_ms(torch, fn, reps=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run_fwd(torch, R, libs, names, card, gen, out) -> None:
    T, H = 60, 128
    for where, cell, B, save_c, row_choices in SHAPES:
        G = (4 if cell == "lstm" else 3) * H
        hin = torch.randn(B, T, H, generator=gen).bfloat16().cuda()
        wx = (torch.randn(H, G, generator=gen) / H ** 0.5).bfloat16().cuda()
        b = (0.1 * torch.randn(G, generator=gen)).bfloat16().cuda()
        wh = (torch.randn(H, G, generator=gen) / H ** 0.5).bfloat16().cuda()
        m = (torch.rand(B, T, generator=gen) < 0.8).cuda()
        keep = m.to(torch.uint8)
        ref_h, ref_c = R.rnn_scan_states(
            cell, hin.float() @ wx.float() + b.float(), wh, m, 1.0, save_c)
        wxp = R.pack_fragments(wx)
        whp = R.pack_fragments(wh)
        for rows in row_choices:
            h = torch.empty((B, T, H), dtype=torch.bfloat16, device="cuda")
            c = torch.empty_like(h) if save_c else None
            for name in names:
                lib = libs[name]

                def run():
                    err = lib.lfm_rnn_fused_fwd_mma(
                        0 if cell == "lstm" else 1, hin.data_ptr(),
                        wxp.data_ptr(), b.data_ptr(), whp.data_ptr(),
                        keep.data_ptr(), h.data_ptr(),
                        None if c is None else c.data_ptr(), 1, B, T, H,
                        rows, 0, 0, 0, 0, 0, 1.0,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"{name}: CUDA error {err}")

                run()
                torch.cuda.synchronize()
                err = (h.float() - ref_h.float()).abs().max().item()
                if save_c:
                    err = max(err, (c.float() - ref_c.float()).abs()
                              .max().item())
                ok = bool((h.float() - ref_h.float()).abs().le(
                    0.05 + 0.05 * ref_h.float().abs()).all())
                if not name.startswith("diag_") and not ok:
                    raise SystemExit(f"{name} {where} rows {rows}: max err "
                                     f"{err}")
                rec = dict(variant=name, at=where, cell=cell, B=B,
                           rows_per_block=rows, save_c=save_c,
                           ms=time_ms(torch, run), max_abs_err=err,
                           card=card)
                print(json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")


def run_bwd(torch, R, libs, names, card, gen, out) -> None:
    T, H = 60, 128
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for where, cell, B in BWD_SHAPES:
        code = 0 if cell == "lstm" else 1
        G = (4 if cell == "lstm" else 3) * H
        hin = torch.randn(B, T, H, generator=gen).bfloat16().cuda()
        wx = (torch.randn(H, G, generator=gen) / H ** 0.5).bfloat16().cuda()
        b = (0.1 * torch.randn(G, generator=gen)).bfloat16().cuda()
        wh = (torch.randn(H, G, generator=gen) / H ** 0.5).bfloat16().cuda()
        m = (torch.rand(B, T, generator=gen) < 0.8).cuda()
        dh = (0.1 * torch.randn(B, T, H, generator=gen)).bfloat16().cuda()
        keep = m.to(torch.uint8)
        h, c = R.rnn_scan_states(cell, hin.float() @ wx.float() + b.float(),
                                 wh, m)
        h, c = h.bfloat16(), (None if c is None else c.bfloat16())
        want = R.rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m, h, c,
                                              dh)
        wxp = R.pack_fragments(wx)
        wxtp = R.pack_fragments(wx, transpose=True)
        S = R._slices(B * T)
        total = 2 * H * G + G
        dx = torch.empty_like(hin)
        dgx = torch.empty((B, T, G), dtype=torch.float32, device="cuda")
        dhn = torch.empty((B, T, H), dtype=torch.float32, device="cuda")
        partial = torch.empty((S, total), dtype=torch.float32, device="cuda")
        dw = torch.empty((total,), dtype=torch.float32, device="cuda")
        parent_bits = None
        for name in (["parent"] if "parent" in libs else []) + names:
            lib = libs[name]
            rows = 32 if "rows_32" in name.split("+") else 16
            smem = lib.lfm_rnn_fused_bwd_mma_smem(code, H)
            if smem > limit:
                print(f"{name} {cell}: {smem} bytes of shared memory, over "
                      f"the card's {limit}: not run", flush=True)
                continue

            def run():
                err = lib.lfm_rnn_fused_bwd_mma(
                    code, hin.data_ptr(), wxp.data_ptr(),
                    wxtp.data_ptr(), b.data_ptr(), wh.data_ptr(),
                    keep.data_ptr(), h.data_ptr(),
                    None if c is None else c.data_ptr(), dh.data_ptr(),
                    dx.data_ptr(), dgx.data_ptr(), dhn.data_ptr(),
                    partial.data_ptr(), S, dw.data_ptr(), 1, B, T, H, 0, 0,
                    0, 0, 0, 1.0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            hg = H * G
            got = (dx, dw[:hg].view(H, G), dw[hg:hg + G],
                   dw[hg + G:].view(H, G))
            errs = [((g.float() - w.float()).abs().max()
                     / (w.float().abs().max() + 1e-9)).item()
                    for g, w in zip(got, want)]
            enforced = not name.startswith(("diag_", "alt_"))
            if enforced and not (errs[0] <= 0.05
                                 and max(errs[1:]) <= WGRAD_TOL):
                raise SystemExit(f"{name} {cell}: scaled errors {errs}")
            if parent_bits is None and "parent" in libs:
                parent_bits = [g.clone() for g in got]
                continue  # timed in its turn among the variants
            rec = dict(variant=name, at=where, cell=cell, B=B,
                       rows_per_block=rows, smem_bytes=smem,
                       ms=time_ms(torch, run),
                       scaled_err=dict(zip(("dhin", "dW_x", "db", "dW_h"),
                                           errs)),
                       card=card)
            if parent_bits is not None:
                rec["bitwise_vs_parent"] = all(
                    torch.equal(g, p) for g, p in zip(got, parent_bits))
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
    run_bwd_hoisted(torch, R, libs, names, card, gen, out)


def run_bwd_hoisted(torch, R, libs, names, card, gen, out) -> None:
    """The hoisted mode (``lfm_rnn_scan_bwd_mma``) at HOISTED_SHAPES: dxw
    and dW_h against ``rnn_scan_bwd_reference``."""
    T, H = 60, 128
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for where, cell, B in HOISTED_SHAPES:
        code = 0 if cell == "lstm" else 1
        G = (4 if cell == "lstm" else 3) * H
        xw = torch.randn(B, T, G, generator=gen).bfloat16().cuda()
        wh = (torch.randn(H, G, generator=gen) / H ** 0.5).bfloat16().cuda()
        m = (torch.rand(B, T, generator=gen) < 0.8).cuda()
        dh = (0.1 * torch.randn(B, T, H, generator=gen)).bfloat16().cuda()
        keep = m.to(torch.uint8)
        h, c = R.rnn_scan_states(cell, xw, wh, m)
        want = R.rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
        S = R._slices(B * T)
        dxw = torch.empty_like(xw)
        dgx = torch.empty((B, T, G), dtype=torch.float32, device="cuda")
        partial = torch.empty((S, H * G), dtype=torch.float32, device="cuda")
        dw = torch.empty((H * G,), dtype=torch.float32, device="cuda")
        for name in names:
            lib = libs[name]
            if not hasattr(lib, "lfm_rnn_scan_bwd_mma_smem"):
                continue
            smem = lib.lfm_rnn_scan_bwd_mma_smem(code, H)
            if smem > limit:
                print(f"{name} {cell} hoisted: {smem} bytes of shared "
                      f"memory, over the card's {limit}: not run", flush=True)
                continue

            def run():
                err = lib.lfm_rnn_scan_bwd_mma(
                    code, xw.data_ptr(), wh.data_ptr(), keep.data_ptr(),
                    h.data_ptr(), None if c is None else c.data_ptr(),
                    dh.data_ptr(), dxw.data_ptr(), dgx.data_ptr(),
                    partial.data_ptr(), S, dw.data_ptr(), 1, B, T, H, 0, 0,
                    0, 1.0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            errs = [((g.float() - w.float()).abs().max()
                     / (w.float().abs().max() + 1e-9)).item()
                    for g, w in zip((dxw, dw.view(H, G)), want)]
            enforced = not name.startswith(("diag_", "alt_"))
            if enforced and not (errs[0] <= 0.05 and errs[1] <= WGRAD_TOL):
                raise SystemExit(f"{name} {cell} hoisted: scaled errors "
                                 f"{errs}")
            rec = dict(variant=name, at=where, cell=cell, B=B,
                       rows_per_block=16, smem_bytes=smem,
                       ms=time_ms(torch, run),
                       scaled_err=dict(zip(("dxw", "dW_h"), errs)),
                       card=card)
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    ap.add_argument("--variants", default=None,
                    help="comma-separated; default: every variant")
    ap.add_argument("--out", default=None)
    ap.add_argument("--parent", default=None,
                    help="another version of the backward source (variant "
                         "'parent', --kernel bwd)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    from lfm_quant_tpu_torch.ops import rnn as R

    kernel = args.kernel
    names = (args.variants or ",".join(VARIANTS[kernel])).split(",")
    if args.parent and kernel == "bwd" and "parent" not in names:
        names.append("parent")
    out_path = args.out or os.path.join(BUILD, f"{kernel}.jsonl")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = build(kernel, names, args.parent)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    with open(out_path, "w") as out:
        (run_fwd if kernel == "fwd" else run_bwd)(torch, R, libs, names, card,
                                                  gen, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
