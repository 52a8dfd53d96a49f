#!/usr/bin/env python3
"""Where the time of the tensor-core recurrence kernels goes, on the card.

    python3 scripts/torch_mma_variants.py
        [--kernel fwd|bwd|bwd_tf32|fwd_tf32] [--variants a,b+c]
        [--out FILE] [--parent FILE]

Builds variants of ``lfm_quant_tpu_torch/csrc/rnn_fused_fwd_mma.cu``
(``--kernel fwd``, the default), ``rnn_fused_bwd_mma.cu`` (``bwd``),
``rnn_bwd_tf32.cu`` (``bwd_tf32``, the float32 backward in 3xTF32: timed
fused and hoisted at the c2 train step in float32, held to the plain
version at scaled atol 1e-5, each at the smallest cluster whose shared
memory fits) or ``rnn_fwd_tf32.cu`` (``fwd_tf32``, the float32 forward in
3xTF32: fused and hoisted at the c2 train step, saving c_all, held to the
plain version at atol 1e-5; the hoisted form is the recurrence alone, the
variant ``diag_gemm_only`` the fused form's GEMM alone; device time; first
each numerics variant's distance from a float64 evaluation and from the
plain version, fused and on the plain version's xw),
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
its outputs are bitwise those of ``parent`` (``--kernel bwd_tf32``: the
same for both forms of the float32 backward; ``--kernel fwd``: h and c of
the fused forward at every shape and block size). The 3xTF32 sources are built
with ``csrc/tf32_common.cuh`` written into them, so a variant may change
the shared code too. Prints one line per measurement and writes them as
JSON lines to ``--out`` (default ``build/mma_variants/<kernel>.jsonl``).
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
       "bwd": os.path.join(CSRC, "rnn_fused_bwd_mma.cu"),
       "bwd_tf32": os.path.join(CSRC, "rnn_bwd_tf32.cu"),
       "fwd_tf32": os.path.join(CSRC, "rnn_fwd_tf32.cu")}
TF32_HEADER = os.path.join(CSRC, "tf32_common.cuh")
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
# The identity in the 3xTF32 sources, whose sigmoid lives in the shared
# header's namespace.
_IDENTITY_TF32 = _IDENTITY + [("using lfm_tf32::sigmoid;\n",
                               "using lfm_tf32::sigmoid;\n"
                               "using lfm_tf32::ident;\n")]
# The float32 backward: 16 rows per CTA instead of 32 (two waves of 2-CTA
# clusters at B 2048); the recurrence's mma chains unbroken (all of k in
# one accumulator: the tensor cores' truncating accumulation); the
# recurrence alone (no weight gradients or dhin; the fused form keeps its
# first GEMM); the recurrence's products removed.
TF32_VARIANTS = {
    "base": [],
    "alt_long_chains": [("constexpr int kChainK = 64;",
                         "constexpr int kChainK = 1 << 20;")],
    "rows_16": [("constexpr int kRowTiles = 2;",
                 "constexpr int kRowTiles = 1;")],
    "diag_recur_only": [("\n  const size_t smem2 = wgrad_smem_bytes(",
                         "\n  return err;\n  const size_t smem2 = "
                         "wgrad_smem_bytes(")],
    "diag_no_products": [("for (int kc = 0; kc < H; kc += kChainK) {",
                          "for (int kc = 0; kc < 0; kc += kChainK) {"),
                         ("for (int jc = 0; jc < GHc; jc += kChainK) {",
                          "for (int jc = 0; jc < 0; jc += kChainK) {")],
    # The units' exchange without its cluster barrier (the peer's partial
    # is read unsynchronised: wrong numbers).
    "diag_no_cluster_barrier": [
        ("      cluster_arrive();\n      cluster_wait();\n#pragma unroll\n",
         "      __syncthreads();\n#pragma unroll\n")],
    "diag_no_transcendentals": _IDENTITY_TF32,
    # The fused form without its last GEMM (dhin).
    "diag_no_dhin": [("  return launch_gemm<true>(dgx, wx,",
                      "  return err;\n  return launch_gemm<true>(dgx, wx,")],
    # Both halves of the split by cvt.rna.tf32.f32 (one conversion
    # instruction each) instead of integer operations.
    "cvt_rna": [
        ("  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(v - __uint_as_float(hi));\n"
         "  lo = (RN_LO ? lo + 0x1000u : lo) & 0xFFFFE000u;\n",
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : \"f\"(v));\n"
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(lo)\n"
         "      : \"f\"(v - __uint_as_float(hi)));\n")],
}
# The float32 forward: the recurrence's mma chains of 32 of k and of 64 (the
# backward's); xw_t added first, as the gate sums' start; the fused form's
# xw by the backward's 3xTF32 GEMM on the tensor cores; lo truncated (as
# the backward splits) instead of rounded; the fourth product a_lo b_lo
# (4xTF32); the fused form's GEMM alone; the recurrence's cluster barrier
# replaced by a block barrier (the peer's h_t is read unsynchronised:
# wrong numbers, the exchange's wait); its products removed; the
# transcendentals replaced by the identity; the stores of h_t and c_t to
# device memory removed.
FWD_TF32_VARIANTS = {
    "base": [],
    "alt_chain32": [("constexpr int kRecurChainK = 8;",
                     "constexpr int kRecurChainK = 32;")],
    "alt_chain64": [("constexpr int kRecurChainK = 8;",
                     "constexpr int kRecurChainK = 64;")],
    "alt_xw_first": [("constexpr bool kXwLast = true;",
                      "constexpr bool kXwLast = false;")],
    "alt_tf32_gemm": [("        launch_sgemm(xin, wx, b,",
                       "        lfm_tf32::launch_gemm<false>(xin, wx, b,")],
    "diag_gemm_only": [("  const SeedStrides st{fused ? s_gates : s_xin,",
                        "  if (fused) return cudaSuccess;\n"
                        "  const SeedStrides st{fused ? s_gates : s_xin,")],
    "diag_no_cluster_barrier": [
        ("    cluster_wait();  // h_{t-1} of every unit",
         "    // h_{t-1} of every unit"),
        ("    cluster_arrive();\n", "    __syncthreads();\n"),
        # One cluster barrier before the exit, so no CTA leaves while its
        # peer still stores into it.
        ("  cluster_wait();\n}\n",
         "  cluster_wait();\n  cluster_arrive();\n  cluster_wait();\n}\n")],
    "alt_truncated_lo": [("constexpr bool kRoundLo = true;",
                          "constexpr bool kRoundLo = false;")],
    "alt_4x": [("  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);\n",
                "  mma_tf32(d, a.lo, b.lo[0], b.lo[1]);\n"
                "  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);\n")],
    "diag_no_products": [("for (int kc = 0; kc < H; kc += kRecurChainK) {",
                          "for (int kc = 0; kc < 0; kc += kRecurChainK) {")],
    "diag_no_transcendentals": _IDENTITY_TF32,
    "diag_no_stores": [("        if (r >= nr) continue;\n",
                        "        if (r >= 0) continue;\n")],
}
VARIANTS = {"fwd": FWD_VARIANTS, "bwd": BWD_VARIANTS,
            "bwd_tf32": TF32_VARIANTS, "fwd_tf32": FWD_TF32_VARIANTS}
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
    include = '#include "tf32_common.cuh"\n'
    if include in src:
        header = open(TF32_HEADER).read().replace("#pragma once\n", "")
        src = src.replace(include, header)
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
        if kernel == "fwd_tf32":
            lib.lfm_rnn_fwd_tf32.argtypes = (
                [ci, ci] + [vp] * 8 + [ci] * 4 + [cll] * 5 + [cf, vp])
            lib.lfm_rnn_fwd_tf32.restype = ci
            lib.lfm_rnn_fwd_tf32_smem.argtypes = [ci, ci]
            lib.lfm_rnn_fwd_tf32_smem.restype = ctypes.c_longlong
        elif kernel == "bwd_tf32":
            lib.lfm_rnn_bwd_tf32.argtypes = (
                [ci, ci] + [vp] * 12 + [ci, vp] + [ci] * 5 + [cll] * 5
                + [cf, vp])
            lib.lfm_rnn_bwd_tf32.restype = ci
            lib.lfm_rnn_bwd_tf32_smem.argtypes = [ci, ci, ci]
            lib.lfm_rnn_bwd_tf32_smem.restype = ctypes.c_longlong
        elif kernel == "fwd":
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
            parent_bits = None
            for name in (["parent"] if "parent" in libs else []) + names:
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
                outs = [h] + ([c] if save_c else [])
                if parent_bits is None and "parent" in libs:
                    parent_bits = [o.clone() for o in outs]
                if parent_bits is not None:
                    rec["bitwise_vs_parent"] = all(
                        torch.equal(o, p) for o, p in zip(outs, parent_bits))
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


def run_bwd_tf32(torch, R, libs, names, card, gen, out) -> None:
    """The float32 backward (``lfm_rnn_bwd_tf32``), fused and hoisted, LSTM
    and GRU, at the c2 train step (B 2048, T 60, H 128): every output held
    to the plain version at scaled atol 1e-5 (``alt_*`` and ``diag_*``
    variants only record their errors), timed in device time."""
    T, H, B = 60, 128, 2048
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    f32 = torch.float32
    for cell in ("lstm", "gru"):
        code = 0 if cell == "lstm" else 1
        G = (4 if cell == "lstm" else 3) * H
        hin = torch.randn(B, T, H, generator=gen).cuda()
        wx = (torch.randn(H, G, generator=gen) / H ** 0.5).cuda()
        b = (0.1 * torch.randn(G, generator=gen)).cuda()
        wh = (torch.randn(H, G, generator=gen) / H ** 0.5).cuda()
        m = (torch.rand(B, T, generator=gen) < 0.8).cuda()
        dh = (0.1 * torch.randn(B, T, H, generator=gen)).cuda()
        keep = m.to(torch.uint8)
        for fused in (True, False):
            xw = hin @ wx + b
            h, c = R.rnn_scan_states(cell, xw, wh, m)
            if fused:
                want = R.rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh,
                                                      m, h, c, dh)
            else:
                want = R.rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
            S = R._slices(B * T)
            total = 2 * H * G + G if fused else H * G
            dx = torch.empty(B, T, H, dtype=f32, device="cuda")
            dgx = torch.empty((B, T, G), dtype=f32, device="cuda")
            dhn = torch.empty((B, T, H), dtype=f32, device="cuda")
            partial = torch.empty((S, total), dtype=f32, device="cuda")
            dw = torch.empty((total,), dtype=f32, device="cuda")
            parent_bits = None
            for name in (["parent"] if "parent" in libs else []) + names:
                lib = libs[name]
                fits = [C for C in (1, 2)
                        if 0 < lib.lfm_rnn_bwd_tf32_smem(code, H, C) <= limit]
                if not fits:
                    print(f"{name} {cell}: no cluster size fits", flush=True)
                    continue
                C = fits[0]

                def run():
                    err = lib.lfm_rnn_bwd_tf32(
                        code, int(fused), (hin if fused else xw).data_ptr(),
                        wx.data_ptr(), b.data_ptr(), wh.data_ptr(),
                        keep.data_ptr(), h.data_ptr(),
                        None if c is None else c.data_ptr(), dh.data_ptr(),
                        dx.data_ptr(), dgx.data_ptr(), dhn.data_ptr(),
                        partial.data_ptr(), S, dw.data_ptr(), 1, B, T, H, C,
                        0, 0, 0, 0, 0, 1.0,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"{name}: CUDA error {err}")

                run()
                torch.cuda.synchronize()
                hg = H * G
                got = ((dx, dw[:hg].view(H, G), dw[hg:hg + G],
                        dw[hg + G:].view(H, G)) if fused
                       else (dgx, dw.view(H, G)))
                errs = [((g - w.float()).abs().max()
                         / (w.float().abs().max() + 1e-9)).item()
                        for g, w in zip(got, want)]
                if not name.startswith(("diag_", "alt_")) and max(errs) > 1e-5:
                    raise SystemExit(f"{name} {cell}: scaled errors {errs}")
                if parent_bits is None and "parent" in libs:
                    parent_bits = [g.clone() for g in got]
                    continue  # timed in its turn among the variants
                rec = dict(variant=name, at="c2 train step, float32",
                           form="fused" if fused else "hoisted", cell=cell,
                           B=B, cluster=C,
                           smem_bytes=lib.lfm_rnn_bwd_tf32_smem(code, H, C),
                           ms=device_time_ms(torch, run),
                           scaled_err=dict(zip(
                               ("dhin", "dW_x", "db", "dW_h") if fused
                               else ("dxw", "dW_h"), errs)), card=card)
                if parent_bits is not None:
                    rec["bitwise_vs_parent"] = all(
                        torch.equal(g, p) for g, p in zip(got, parent_bits))
                print(json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")
            del want, dgx, dhn, partial, dx, h, c, parent_bits
            torch.cuda.empty_cache()


def test_inputs(torch, cell):
    """The inputs of ``tests/test_torch_kernels.py``
    test_tf32_fwd_matches_plain at H 128, B 2053 (T 9, weights 0.3 N(0, 1),
    its seed, row 0 all-invalid)."""
    import numpy as np

    B, T, H = 2053, 9, 128
    G = (4 if cell == "lstm" else 3) * H
    rng = np.random.default_rng(B + H)
    arrays = [rng.standard_normal((B, T, H)),
              0.3 * rng.standard_normal((H, G)),
              0.1 * rng.standard_normal((G,)),
              0.3 * rng.standard_normal((H, G))]
    hin, wx, b, wh = (torch.from_numpy(a.astype(np.float32)).cuda()
                      for a in arrays)
    mk = rng.random((B, T)) < 0.75
    mk[0] = False
    return hin, wx, b, wh, torch.from_numpy(mk).cuda()


def c2_train_inputs(torch):
    """The float32 c2 train step as ``chip_smoke.py`` builds it: the
    layer-0 input of the first batch of ``stacked_epoch(0)`` (B 2048, T
    60, H 128) and the mask; the LSTM's own seeded weights and, for the
    GRU, seeded ones of sd H^-1/2 → {cell: (hin, wx, b, wh, m)}."""
    import dataclasses

    from lfm_quant_tpu_torch.config import get_preset
    from lfm_quant_tpu_torch.data.panel import PanelSplits
    from lfm_quant_tpu_torch.train.loop import (
        Trainer,
        default_split_dates,
        resolve_panel,
    )

    cfg = get_preset("c2")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             bf16=False))
    panel = resolve_panel(cfg.data)
    splits = PanelSplits.by_date(panel, *default_split_dates(panel, cfg.data),
                                 train_start=cfg.data.train_start)
    trainer = Trainer(cfg, splits, device="cuda")
    batch = trainer.train_sampler.stacked_epoch(0)
    model = trainer.model
    with torch.no_grad():
        x, m = trainer._gather(torch.from_numpy(batch.firm_idx[0]).cuda(),
                               torch.from_numpy(batch.time_idx[0]).cuda())
        W = x.shape[-2]
        B = x.shape[0] * x.shape[1]
        hin = model.embed(x.reshape(B, W, -1), dtype=model.dtype)
        m = m.reshape(B, W)
        H = model.hidden
        lstm = (model.xproj[0].kernel.detach().float(),
                model.xproj[0].bias.detach().float(),
                model.h_proj[0].detach().float())
    gen = torch.Generator().manual_seed(1)
    sd = H ** -0.5
    gru = ((sd * torch.randn(H, 3 * H, generator=gen)).cuda(),
           (0.1 * torch.randn(3 * H, generator=gen)).cuda(),
           (sd * torch.randn(H, 3 * H, generator=gen)).cuda())
    return {"lstm": (hin, *lstm, m), "gru": (hin, *gru, m)}


def fwd_tf32_accuracy(torch, R, libs, names, card, out) -> None:
    """Each numerics variant's fused forward, its recurrence alone on the
    plain version's xw (what the GEMM adds is the difference),
    ``rnn_fused_fwd.cu`` and the plain float32 version against the plain
    formulas in float64 (``rnn_scan_states`` on float64 operands), on two
    inputs: the card test's (:func:`test_inputs`) and the float32 c2 train
    step's (:func:`c2_train_inputs`), both held at atol 1e-5 on h and c:
    max |x - x64| and max |x - plain| for x = h, c."""
    c2 = c2_train_inputs(torch)
    for (where, cell), args in [(("card test", c), test_inputs(torch, c))
                                for c in ("lstm", "gru")] + [
            (("c2 train step", c), c2[c]) for c in ("lstm", "gru")]:
        hin, wx, b, wh, m = args
        B, T, H = hin.shape
        code = 0 if cell == "lstm" else 1
        G = wx.shape[1]
        xw64 = hin.double() @ wx.double() + b.double()
        want = R.rnn_scan_states(cell, xw64, wh.double(), m, 1.0, True)
        xw = hin @ wx + b
        plain = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
        runs = {"plain float32": lambda: plain,
                "rnn_fused_fwd.cu": lambda: R._launch_fwd(
                    cell, False, hin, wx, b, wh, m, 1.0, True)}
        keep = m.to(torch.uint8)
        scratch = torch.empty(B, T, G, device="cuda")
        for name in names:
            if name.startswith("diag_"):
                continue

            def run(lib=libs[name], fused=True):
                h = torch.empty(B, T, H, device="cuda")
                c = torch.empty_like(h) if cell == "lstm" else None
                err = lib.lfm_rnn_fwd_tf32(
                    code, int(fused), (hin if fused else xw).data_ptr(),
                    wx.data_ptr(), b.data_ptr(), wh.data_ptr(),
                    keep.data_ptr(), h.data_ptr(),
                    None if c is None else c.data_ptr(), scratch.data_ptr(),
                    1, B, T, H, 0, 0, 0, 0, 0, 1.0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
                return h, c

            runs[name] = run
            runs[f"{name}, on the plain xw"] = (
                lambda run=run: run(fused=False))
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            # The x side: the GEMM's (in the scratch after a fused run) or
            # the plain version's, against float64 and the plain one; bias
            # is the mean error toward |xw| (negative: toward zero).
            x = (xw if name == "plain float32" else scratch
                 if name in libs else None)
            xs = None if x is None else dict(
                vs_float64=(x.double() - xw64).abs().max().item(),
                vs_plain=(x - xw).abs().max().item(),
                mean_abs_vs_float64=(x.double() - xw64).abs().mean().item(),
                bias_vs_float64=((x.double() - xw64)
                                 * xw64.sign()).mean().item(),
                max_abs=xw64.abs().max().item())
            rec = dict(variant=name, at=f"accuracy, float32, {where}",
                       cell=cell, B=B, T=T, H=H,
                       vs_float64={k: (g.double() - w).abs().max().item()
                                   for k, g, w in zip("hc", got, want)
                                   if g is not None},
                       vs_plain={k: (g - p).abs().max().item()
                                 for k, g, p in zip("hc", got, plain)
                                 if g is not None},
                       max_abs_c=None if want[1] is None
                       else want[1].abs().max().item(), xw=xs, card=card)
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
        del want, plain, scratch, xw, xw64
        torch.cuda.empty_cache()


def run_fwd_tf32(torch, R, libs, names, card, gen, out) -> None:
    """The float32 forward (``lfm_rnn_fwd_tf32``), fused and hoisted (the
    recurrence alone), LSTM and GRU, at the c2 train step (B 2048, T 60, H
    128) saving c_all: h and c held to the plain version at atol 1e-5
    (``alt_*`` and ``diag_*`` variants only record their errors), timed in
    device time. First :func:`fwd_tf32_accuracy`."""
    fwd_tf32_accuracy(torch, R, libs, names, card, out)
    T, B = 60, 2048
    f32 = torch.float32
    for cell in ("lstm", "gru"):
        code = 0 if cell == "lstm" else 1
        for H in (128,):
            G = (4 if cell == "lstm" else 3) * H
            hin = torch.randn(B, T, H, generator=gen).cuda()
            wx = (torch.randn(H, G, generator=gen) / H ** 0.5).cuda()
            b = (0.1 * torch.randn(G, generator=gen)).cuda()
            wh = (torch.randn(H, G, generator=gen) / H ** 0.5).cuda()
            m = (torch.rand(B, T, generator=gen) < 0.8).cuda()
            keep = m.to(torch.uint8)
            xw = hin @ wx + b
            want = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
            h = torch.empty(B, T, H, dtype=f32, device="cuda")
            c = torch.empty_like(h) if cell == "lstm" else None
            scratch = torch.empty(B, T, G, dtype=f32, device="cuda")
            for fused in (True, False):
                for name in names:
                    if name == "diag_gemm_only" and not fused:
                        continue
                    lib = libs[name]

                    def run():
                        err = lib.lfm_rnn_fwd_tf32(
                            code, int(fused),
                            (hin if fused else xw).data_ptr(),
                            wx.data_ptr(), b.data_ptr(), wh.data_ptr(),
                            keep.data_ptr(), h.data_ptr(),
                            None if c is None else c.data_ptr(),
                            scratch.data_ptr(), 1, B, T, H, 0, 0, 0, 0, 0,
                            1.0, torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise SystemExit(f"{name}: CUDA error {err}")

                    run()
                    torch.cuda.synchronize()
                    errs = [(g - w).abs().max().item() for g, w in
                            zip((h, c), want) if g is not None]
                    if not name.startswith(("diag_", "alt_")) and \
                            not max(errs) <= 1e-5:
                        raise SystemExit(f"{name} {cell} H {H}: max errors "
                                         f"{errs}")
                    rec = dict(variant=name, at="c2 train step, float32",
                               form="fused" if fused else "hoisted",
                               cell=cell, B=B, H=H,
                               smem_bytes=lib.lfm_rnn_fwd_tf32_smem(code, H),
                               ms=device_time_ms(torch, run),
                               max_abs_err=dict(zip(("h", "c"), errs)),
                               card=card)
                    print(json.dumps(rec), flush=True)
                    out.write(json.dumps(rec) + "\n")
            del hin, wx, wh, xw, want, h, c, scratch
            torch.cuda.empty_cache()


def device_time_ms(torch, fn, reps=5, launches=4):
    """Median device time of one call: the device sleeps while the host
    queues ``launches`` calls, then they run back to back between two CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(VARIANTS), default="fwd")
    ap.add_argument("--variants", default=None,
                    help="comma-separated; default: every variant")
    ap.add_argument("--out", default=None)
    ap.add_argument("--parent", default=None,
                    help="another version of the source (variant 'parent', "
                         "--kernel fwd, bwd or bwd_tf32)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    from lfm_quant_tpu_torch.ops import rnn as R

    kernel = args.kernel
    names = (args.variants or ",".join(VARIANTS[kernel])).split(",")
    if args.parent and kernel in ("fwd", "bwd", "bwd_tf32") and \
            "parent" not in names:
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
        run = {"fwd": run_fwd, "bwd": run_bwd, "bwd_tf32": run_bwd_tf32,
               "fwd_tf32": run_fwd_tf32}
        run[kernel](torch, R, libs, names, card, gen, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
