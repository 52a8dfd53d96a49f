#!/usr/bin/env python3
"""Where the time of the tensor-core fused forward goes, on the card.

    python3 scripts/torch_mma_variants.py [--variants a,b] [--out DIR]

Builds variants of ``lfm_quant_tpu_torch/csrc/rnn_fused_fwd_mma.cu``,
each made from the committed source by named text substitutions, into
separate shared libraries (one ``nvcc`` each, all started together), and
times every variant at the main paths' shapes (c2 serving: LSTM B 16384;
c3 serving: GRU B 32768; c2 train step: LSTM B 2048 with c_all; T 60, H
128, bf16, random seeded inputs) and rows per block, with CUDA events.
Variants that keep the arithmetic are held to the plain version (bf16
atol/rtol 0.05); the diagnostic ones (``diag_*``) remove a part of the
work and give wrong numbers on purpose, to show what that part costs.
Prints one line per measurement and writes them as JSON lines to
``--out`` (default ``chiprun_out/mma_variants.jsonl``). Needs a CUDA card
and ``nvcc``; imports nothing of JAX.
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
SRC = os.path.join(ROOT, "lfm_quant_tpu_torch", "csrc", "rnn_fused_fwd_mma.cu")
BUILD = os.path.join(ROOT, "build", "mma_variants")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]

_FAST_MATH = [
    ("  return __frcp_rn(1.0f + expf(-v));\n}\n",
     "  return __fdividef(1.0f, 1.0f + __expf(-v));\n}\n\n"
     "__device__ __forceinline__ float fast_tanh(float v) {\n"
     "  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * v));\n}\n"),
    ("tanhf(", "fast_tanh("),
]
VARIANTS = {
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
# (where, cell, B, save_c, rows per block)
SHAPES = (("c2 serving", "lstm", 16384, False, (64, 32)),
          ("c3 serving", "gru", 32768, False, (64, 32)),
          ("c2 8192 rows", "lstm", 8192, False, (64, 32, 16)),
          ("c2 train step", "lstm", 2048, True, (16, 32)))


def variant_source(name: str) -> str:
    src = open(SRC).read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: pattern not in the source:\n"
                             f"{old}")
        src = src.replace(old, new)
    return src


def build(names):
    os.makedirs(BUILD, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for name in names:
        cu = os.path.join(BUILD, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        procs[name] = subprocess.Popen(
            [nvcc, *FLAGS, cu, "-o", os.path.join(BUILD, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] ptxas: {line.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(BUILD, f"{name}.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lfm_rnn_fused_fwd_mma.argtypes = (
            [ci] + [vp] * 7 + [ci] * 4 + [ctypes.c_float, vp])
        lib.lfm_rnn_fused_fwd_mma.restype = ci
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "mma_variants.jsonl"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    from lfm_quant_tpu_torch.ops import rnn as R

    names = args.variants.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = build(names)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    T, H = 60, 128
    with open(args.out, "w") as out:
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
                            None if c is None else c.data_ptr(), B, T, H, rows,
                            1.0, torch.cuda.current_stream().cuda_stream)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
