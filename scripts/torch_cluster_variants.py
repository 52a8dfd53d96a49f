#!/usr/bin/env python3
"""The bfloat16 forward and backward above hidden 128
(``csrc/rnn_fwd_cluster.cu``, ``csrc/rnn_bwd_cluster.cu``, and past 512
``csrc/rnn_bwd_grid.cu``) and the float32 backward above 128
(``csrc/rnn_bwd_tf32.cu``, and past 384 ``csrc/rnn_bwd_tf32_grid.cu``) at
every cluster size and rows per cluster (group size and rows per work
item) they take, on the card.

    python3 scripts/torch_cluster_variants.py [--widths 256 320 512]
        [--batch 2048] [--steps 60] [--reps 5]
        [--direction fwd|bwd|both|bwd_tf32|bwd_grid|bwd_grid_bf16|
                     fwd_grid_bf16]
        [--out FILE]

For rows 3 (fused: the bf16 GEMM into the f32 xw scratch, then the
cluster recurrence) and 1 (hoisted: the recurrence on a bf16 xw), LSTM
and GRU, on B x T x H bf16 operands made from a seed (weights at scale
H^-1/2, 75% of the steps valid, c_all saved), times every (CTAs per
cluster, rows per cluster) pair that ``ops/rnn.py _cluster_takes`` allows
and the card's shared memory holds: ms per call between CUDA events (the
mean of ``--reps`` back-to-back calls after two warm-up calls), the
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``), and
whether h_all and c_all equal those of the pair the wrapper picks
(``_cluster_size``, ``_cluster_rows``) bitwise: a row's sums depend on
neither. The picked pair is marked. Prints the card's name and power
limit, then one JSON line per case, also written to ``--out`` (default
``build/cluster_variants.jsonl``). Needs a CUDA card and ``nvcc``;
imports nothing of JAX.

``--direction bwd`` (or ``both``) does the same for rows 4 (fused: the
xw GEMM, the cluster recurrence, the weight gradients and dhin) and 2
(hoisted: the recurrence and dW_h) on the states of the plain forward
and an upstream gradient from the same seed, over the pairs
``_cluster_bwd_takes`` allows (the picked pair ``_cluster_bwd_size``,
``_cluster_bwd_rows``). A backward's bits depend on the rows per cluster
only where the cluster size is the same (its reduce-scatter adds C
partials), so ``bitwise_as_picked`` is given for the picked size's pairs
and null for the others. For the picked pair it also profiles two calls
(``torch.profiler``, CUDA activity) and gives each kernel's device ms a
call (``kernels_ms``): where a backward's time goes.

``--diag base,diag_no_recompute,..`` (with ``--direction bwd``) also
builds variants of ``csrc/rnn_bwd_cluster.cu`` made by named text
substitutions (:data:`BWD_DIAG`; ``a+b`` applies both), each with
``csrc/window_gather.cu`` (the error strings) into its own library under
``build/cluster_variants/`` (one ``nvcc`` each, all started together),
and times each at the picked pair, rows 4 and 2 (the recurrence's device
ms from the profiler, ``recur_ms``): ``diag_*`` variants remove a part of
each step's work and give wrong numbers on purpose, to show what that
part costs. ``file:PATH`` builds another version of the source as it is
(an earlier commit's, from ``git show``), to time the two in one call.

``--direction bwd_tf32`` does the backward's cases in float32 on the
3xTF32 cluster form of ``csrc/rnn_bwd_tf32.cu`` (the pairs
``_tf32_takes`` allows at C 2-16, the picked pair ``_tf32_cluster``,
``_tf32_rows``), with ``--diag`` variants of that source
(:data:`TF32_DIAG`).

``--direction bwd_grid`` does them on the grid backward past 384
(``csrc/rnn_bwd_tf32_grid.cu``): every (CTAs a group, rows a work item)
pair with a distinct number of chunks a CTA that ``_grid_takes`` allows
and the card holds (the picked pair ``_grid_size``, ``_grid_rows``),
``bitwise_as_picked`` for all of them (a (row, unit)'s sums do not depend
on the pair), the picked pair's kernels by device ms and its barrier
waits (each CTA's share of its cycles, ``wait_share``), and ``--diag``
variants of that source (:data:`GRID_DIAG`).

``--direction bwd_grid_bf16`` does the same in bfloat16 on the grid
backward past 512 (``csrc/rnn_bwd_grid.cu``, :data:`BF16_GRID_DIAG`),
and for the picked pair also gives the all-gather's L2 reads: the bytes a
call (``gather_bytes``: every CTA of a group reads each valid row's d_hw
hi and lo, G H bf16 each, at every step but the first) and their rate
over the recurrence kernel's device time (``gather_gb_per_s``).

``--direction fwd_grid_bf16`` does rows 3 (fused: the xw GEMM, then the
grid recurrence) and 1 (hoisted) on the bf16 grid forward past 512
(``csrc/rnn_fwd_grid.cu``): every (group, rows) pair with a distinct
number of chunks a CTA (the picked pair ``_fwd_grid_size``,
``_fwd_grid_rows``), ``bitwise_as_picked`` for all, the picked pair's
kernels by device ms, its barrier waits, the all-gather's bytes (every
CTA of a group reads each valid row's h_{t-1}, H bf16, at every step but
the first) and rate, and ``--diag`` variants of that source
(:data:`FWD_GRID_DIAG`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lfm_quant_tpu_torch", "csrc")
GATES = {"lstm": 4, "gru": 3}
_STORE = ("            *reinterpret_cast<float2*>(dst + r * LR + lu) = "
          "make_float2(\n"
          "                pacc[s][rt][2 * half], pacc[s][rt][2 * half + 1]);")
# The stored values kept alive without the stores (an empty asm that
# reads them), so the carry's products are not dropped with them.
_SINK = ("            (void)dst;\n"
         "            asm volatile(\"\" ::\"f\"(pacc[s][rt][2 * half]),\n"
         "                         \"f\"(pacc[s][rt][2 * half + 1]));")
#: Named text substitutions of ``csrc/rnn_bwd_cluster.cu`` (``--diag``):
#: the recompute's and the carry product's mma; the reduce-scatter's
#: distributed-shared-memory stores; those stores and the step's two
#: cluster barriers (the first and last barrier stay: no CTA leaves while
#: a peer runs); the cell's device-memory outputs.
BWD_DIAG = {
    "base": [],
    "diag_no_recompute": [(
        "mma_bf16(acc[rt][CELL == kGru && q == 2 ? 3 : q], a, bh[q]);",
        "(void)bh;")],
    "diag_no_partial": [("mma_bf16(pacc[s][rt], a[rt][p], bk);",
                         "(void)bk;")],
    "diag_no_exchange": [(_STORE, _SINK)],
    "diag_no_sync": [
        (_STORE, _SINK),
        ("      if (pass == 0) cluster_wait();", ""),
        ("    cluster_arrive();\n    // While the partials",
         "    // While the partials"),
        ("    cluster_wait();  // every rank's", "    //"),
        ("    cluster_arrive();  // this CTA's buffer is read", "")],
    "diag_no_outputs": [("          if (r < nr) {",
                         "          if (r < 0) {")],
}
#: The same diagnostics for the cluster form of ``csrc/rnn_bwd_tf32.cu``
#: (``--direction bwd_tf32``), its h tile's load, the partials stored into
#: the CTA's own buffer (``diag_local_store``: what the remote stores
#: cost), and three candidates: 32-bit ``st.shared::cluster`` stores in
#: place of generic ones (``st_cluster``), 8 chunks a pass at 16 rows
#: (``chunk_regs_8``), the small terms of each 3xTF32 product in
#: accumulators of their own (``split_terms``).
TF32_DIAG = {
    "base": [],
    "diag_no_recompute": [(
        "          for (int q = 0; q < G; ++q) mma3(cacc[rt][q], a, hb[q]);",
        "          (void)hb;")],
    "diag_no_partial": [(
        "              for (int rt = 0; rt < RT; ++rt) mma3(cacc[s][rt], "
        "a[rt], b);", "              (void)b;")],
    "diag_no_exchange": BWD_DIAG["diag_no_exchange"],
    "diag_no_sync": BWD_DIAG["diag_no_sync"],
    "diag_no_outputs": BWD_DIAG["diag_no_outputs"],
    "diag_no_hload": [("    if (t > 0) load_h(t - 1);\n", "")],
    "diag_local_store": [(
        "        float* dst = cluster.map_shared_rank(recv_s + (size_t)"
        "rank * BB * LR,\n                                             p);",
        "        float* dst = recv_s + (size_t)rank * BB * LR + 0 * p;")],
    "st_cluster": [
        ("constexpr int kChunks = 4;\n",
         "constexpr int kChunks = 4;\n"
         "__device__ __forceinline__ uint32_t cluster_addr(const float* p,\n"
         "                                                 int rank) {\n"
         "  uint32_t r;\n"
         "  asm volatile(\"mapa.shared::cluster.u32 %0, %1, %2;\\n\"\n"
         "               : \"=r\"(r)\n"
         "               : \"r\"((uint32_t)__cvta_generic_to_shared(p)),"
         " \"r\"(rank));\n"
         "  return r;\n}\n"
         "__device__ __forceinline__ void st_cluster(uint32_t a, float x,\n"
         "                                           float y) {\n"
         "  asm volatile(\"st.shared::cluster.v2.f32 [%0], {%1, %2};\\n\""
         " ::\"r\"(a),\n"
         "               \"f\"(x), \"f\"(y) : \"memory\");\n}\n"),
        ("        float* dst = cluster.map_shared_rank(recv_s + (size_t)"
         "rank * BB * LR,\n                                             p);",
         "        const uint32_t dst = cluster_addr(recv_s + (size_t)rank * BB"
         " * LR, p);"),
        (_STORE, "            st_cluster(dst + 4 * (r * LR + lu), "
         "pacc[s][rt][2 * half],\n"
         "                       pacc[s][rt][2 * half + 1]);")],
    "chunk_regs_8": [("  constexpr int NCH = kChunks;  ",
                      "  constexpr int NCH = 8 / RT;   ")],
    # Each product's two small terms in an accumulator of their own, so a
    # chain's dependent mma are one a k-step, not three.
    "split_terms": [
        ("// Kernel 1 above 128, per seed",
         "__device__ __forceinline__ void mma3s(float (&big)[4],\n"
         "                                      float (&small)[4],\n"
         "                                      const FragA& a,\n"
         "                                      const FragB& b) {\n"
         "  lfm_tf32::mma_tf32(small, a.lo, b.hi[0], b.hi[1]);\n"
         "  lfm_tf32::mma_tf32(small, a.hi, b.lo[0], b.lo[1]);\n"
         "  lfm_tf32::mma_tf32(big, a.hi, b.hi[0], b.hi[1]);\n}\n\n"
         "// Kernel 1 above 128, per seed"),
        ("          float cacc[NCH][RT][4];\n",
         "          float cacc[NCH][RT][4], cs[NCH][RT][4] = {};\n"),
        ("              for (int rt = 0; rt < RT; ++rt) mma3(cacc[s][rt], "
         "a[rt], b);",
         "              for (int rt = 0; rt < RT; ++rt)\n"
         "                mma3s(cacc[s][rt], cs[s][rt], a[rt], b);"),
        ("              for (int i = 0; i < 4; ++i) pacc[s][rt][i] += "
         "cacc[s][rt][i];",
         "              for (int i = 0; i < 4; ++i)\n"
         "                pacc[s][rt][i] += cacc[s][rt][i] + cs[s][rt][i];"),
        ("hs[rt][q][i] = 0.0f;\n    for (int kc = 0; kc < H; kc += kChainK) "
         "{\n      float cacc[RT][G][4];\n",
         "hs[rt][q][i] = 0.0f;\n    for (int kc = 0; kc < H; kc += kChainK) "
         "{\n      float cacc[RT][G][4], cs[RT][G][4] = {};\n"),
        ("          for (int q = 0; q < G; ++q) mma3(cacc[rt][q], a, hb[q]);",
         "          for (int q = 0; q < G; ++q)\n"
         "            mma3s(cacc[rt][q], cs[rt][q], a, hb[q]);"),
        ("          for (int i = 0; i < 4; ++i) hs[rt][q][i] += "
         "cacc[rt][q][i];",
         "          for (int i = 0; i < 4; ++i)\n"
         "            hs[rt][q][i] += cacc[rt][q][i] + cs[rt][q][i];")],
}
#: The grid backward (``--direction bwd_grid``): the carry's products
#: removed; the all-gather's loads removed (each stage's slot read as it
#: is); the group's barrier reduced to the CTA's own (no wait for the other
#: CTAs: wrong numbers, the barrier's cost).
GRID_DIAG = {
    "base": [],
    "diag_no_product": [("          mma3(cacc, a, b);", "          (void)b;")],
    "diag_no_gather": [("          cp_async16(dst + r * LA + kc, src, ok ? 16 "
                        ": 0);", "          (void)dst;\n          (void)src;")],
    "diag_no_barrier": [("      group_barrier(ctr, target, n, waited);",
                         "      __syncthreads();")],
    # The stages tried before the kept 64 columns in 2: 32 columns in 4
    # (3 in flight), in 2, and 64 in 3. Two accumulator chains a warp,
    # alternate k-steps (added at each chain's end).
    "stage_k32_4": [("constexpr int kStageK = 64;",
                     "constexpr int kStageK = 32;"),
                    ("constexpr int kStages = 2;",
                     "constexpr int kStages = 4;")],
    "stage_k32_2": [("constexpr int kStageK = 64;",
                     "constexpr int kStageK = 32;")],
    "stage_k64_3": [("constexpr int kStages = 2;",
                     "constexpr int kStages = 3;")],
    "ilp2": [
        ("      float cacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n",
         "      float cacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
         "      float cacc2[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"),
        ("        for (int kk = 0; kk < kn; kk += 8) {\n"
         "          FragA a;\n"
         "          frag_a(a, ap[kk], ap[8 * LA + kk], ap[kk + 4], "
         "ap[8 * LA + kk + 4]);\n"
         "          FragB b;\n"
         "          frag_b(b, bp[kk], bp[kk + 4]);\n"
         "          mma3(cacc, a, b);\n"
         "        }\n",
         "        for (int kk = 0; kk < kn; kk += 16) {\n"
         "          FragA a, a2;\n"
         "          frag_a(a, ap[kk], ap[8 * LA + kk], ap[kk + 4], "
         "ap[8 * LA + kk + 4]);\n"
         "          frag_a(a2, ap[kk + 8], ap[8 * LA + kk + 8], ap[kk + 12], "
         "ap[8 * LA + kk + 12]);\n"
         "          FragB b, b2;\n"
         "          frag_b(b, bp[kk], bp[kk + 4]);\n"
         "          frag_b(b2, bp[kk + 8], bp[kk + 12]);\n"
         "          mma3(cacc, a, b);\n"
         "          mma3(cacc2, a2, b2);\n"
         "        }\n"),
        ("            acc[i] += cacc[i];\n            cacc[i] = 0.0f;\n",
         "            acc[i] += cacc[i] + cacc2[i];\n"
         "            cacc[i] = 0.0f;\n            cacc2[i] = 0.0f;\n")],
}
#: The bf16 grid backward (``--direction bwd_grid_bf16``): the carry's two
#: mma a k-step removed; the all-gather's loads removed; the group's
#: barrier reduced to the CTA's own; candidates: 3 or 4 stages of 64
#: columns, 4 of 32, 2 of 128.
BF16_GRID_DIAG = {
    "base": [],
    "diag_no_product": [("          mma_bf16(cacc, ahi, b);\n"
                         "          mma_bf16(cacc, alo, b);",
                         "          (void)b;")],
    "diag_no_gather": [("          cp_async16(dst + pr * LA + kc, ok ? src : "
                        "xb, ok ? 16 : 0);",
                        "          (void)dst;\n          (void)src;")],
    "diag_no_barrier": GRID_DIAG["diag_no_barrier"],
    "stage_k64_3": [("constexpr int kStages = 2;",
                     "constexpr int kStages = 3;")],
    "stage_k64_4": [("constexpr int kStages = 2;",
                     "constexpr int kStages = 4;")],
    "stage_k32_4": [("constexpr int kStageK = 64;",
                     "constexpr int kStageK = 32;"),
                    ("constexpr int kStages = 2;",
                     "constexpr int kStages = 4;")],
    "stage_k128_2": [("constexpr int kStageK = 64;",
                      "constexpr int kStageK = 128;")],
}
#: The bf16 grid forward (``--direction fwd_grid_bf16``): the product's
#: mma removed; the all-gather's loads removed (each stage's slot read as
#: it is); the group's barrier reduced to the CTA's own; candidates: 3 or
#: 4 stages of 64 columns, 2 or 3 of 128.
FWD_GRID_DIAG = {
    "base": [],
    "diag_no_product": [("              mma_bf16(acc[q], a, make_uint2(b2[0], "
                         "b2[1]));", "              (void)b2;")],
    "diag_no_gather": [("        cp_async16(dst + r * LA + kc, ok ? src : "
                        "hs, ok ? 16 : 0);",
                        "        (void)dst;\n        (void)src;")],
    "diag_no_barrier": [("      if (t + 1 < Tn) group_barrier(ctr, target, "
                         "n, waited);", "      __syncthreads();")],
    "stage_k64_3": BF16_GRID_DIAG["stage_k64_3"],
    "stage_k64_4": BF16_GRID_DIAG["stage_k64_4"],
    "stage_k128_2": BF16_GRID_DIAG["stage_k128_2"],
    "stage_k128_3": BF16_GRID_DIAG["stage_k128_2"] + [
        ("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
}
#: Per direction with variants: the source, its substitutions, the entry
#: point and its ctypes signature, the recurrence kernel's name.
SOURCES = {
    "bwd": ("rnn_bwd_cluster.cu", BWD_DIAG, "lfm_rnn_bwd_cluster", 7,
            "rnn_bwd_cluster_kernel"),
    "bwd_tf32": ("rnn_bwd_tf32.cu", TF32_DIAG, "lfm_rnn_bwd_tf32", 6,
                 "rnn_bwd_tf32_cluster_kernel"),
    "bwd_grid": ("rnn_bwd_tf32_grid.cu", GRID_DIAG, "lfm_rnn_bwd_tf32_grid",
                 7, "rnn_bwd_tf32_grid_kernel"),
    "bwd_grid_bf16": ("rnn_bwd_grid.cu", BF16_GRID_DIAG,
                      "lfm_rnn_bwd_grid_bf16", 7, "rnn_bwd_grid_kernel"),
    "fwd_grid_bf16": ("rnn_fwd_grid.cu", FWD_GRID_DIAG, "lfm_rnn_fwd_grid",
                      7, "rnn_fwd_grid_kernel"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[256, 320, 512])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--direction", choices=("fwd", "bwd", "both",
                                            "bwd_tf32", "bwd_grid",
                                            "bwd_grid_bf16", "fwd_grid_bf16"),
                    default="fwd")
    ap.add_argument("--diag", default="",
                    help="variants of the backward source, comma-separated")
    ap.add_argument("--picked-only", action="store_true",
                    help="bwd_tf32: time the picked pair alone")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "cluster_variants.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from lfm_quant_tpu_torch.ops import rnn as R

    kind = (args.direction
            if args.direction in ("bwd_tf32", "bwd_grid", "bwd_grid_bf16",
                                  "fwd_grid_bf16")
            else "bwd")
    diag = build_diag(args.diag.split(","), kind) if args.diag else {}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    sms = props.multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(20)
    B, T = args.batch, args.steps
    bf = torch.bfloat16
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        for H in args.widths:
            for cell in ("lstm", "gru"):
                G = GATES[cell] * H
                rnd = dict(generator=gen, device="cuda")
                if kind == "bwd_tf32":
                    tf32_cases(torch, R, out, card, diag, cell, B, T, H,
                               rnd, limit, sms, args.reps, args.picked_only)
                    continue
                if kind in ("bwd_grid", "bwd_grid_bf16"):
                    grid_cases(torch, R, out, card, diag, cell, B, T, H,
                               rnd, limit, sms, args.reps, args.picked_only,
                               bf if kind == "bwd_grid_bf16"
                               else torch.float32)
                    continue
                if kind == "fwd_grid_bf16":
                    fwd_grid_cases(torch, R, out, card, diag, cell, B, T, H,
                                   rnd, limit, sms, args.reps,
                                   args.picked_only)
                    continue
                hin = torch.randn(B, T, H, **rnd).to(bf)
                wx = (H ** -0.5 * torch.randn(H, G, **rnd)).to(bf)
                wh = (H ** -0.5 * torch.randn(H, G, **rnd)).to(bf)
                b = (0.1 * torch.randn(G, **rnd)).to(bf)
                m = torch.rand(B, T, **rnd) < 0.75
                xw = (hin.float() @ wx.float() + b.float()).to(bf)
                if args.direction != "fwd":
                    dh = (0.1 * torch.randn(B, T, H, **rnd)).to(bf)
                    bwd_cases(torch, R, out, card, cell, hin, wx, b, wh, m,
                              xw, dh, limit, sms, args.reps)
                    if diag:
                        diag_cases(torch, R, out, card, diag, cell, hin, wx,
                                   b, wh, m, xw, dh, limit, sms, args.reps)
                    del dh
                if args.direction == "bwd":
                    del hin, wx, wh, b, m, xw
                    torch.cuda.empty_cache()
                    continue
                pick_c = R._cluster_size(cell, H, limit)
                pick_rows = R._cluster_rows(cell, H, pick_c, B, 1, limit,
                                            sms)
                for fused in (True, False):
                    ops = ((hin, wx, b) if fused else (xw, None, None))

                    def run(C, rows):
                        return R._launch_fwd_cluster(
                            cell, fused, *ops, wh, m, 1.0, True, cluster=C,
                            rows=rows)

                    want = run(pick_c, pick_rows)
                    for C in R.CLUSTER_SIZES:
                        for rows in R.CLUSTER_ROWS:
                            if not (R._cluster_takes(H, C, rows)
                                    and R._cluster_smem(cell, H, C, rows)
                                    <= limit):
                                continue
                            clusters = R._cluster_check(cell, fused, H, C,
                                                        rows, dev)
                            got = run(C, rows)
                            same = all(
                                (g is None and w is None) or torch.equal(g, w)
                                for g, w in zip(got, want))
                            del got
                            run(C, rows)
                            torch.cuda.synchronize()
                            t0 = torch.cuda.Event(enable_timing=True)
                            t1 = torch.cuda.Event(enable_timing=True)
                            t0.record()
                            for _ in range(args.reps):
                                run(C, rows)
                            t1.record()
                            torch.cuda.synchronize()
                            rec = dict(
                                card=card, cell=cell,
                                form="fused_fwd" if fused else "fwd",
                                shape=[B, T, H], cluster=C, rows=rows,
                                warps=R._cluster_warps(H, C),
                                smem=R._cluster_smem(cell, H, C, rows),
                                clusters_at_once=clusters,
                                ms=t0.elapsed_time(t1) / args.reps,
                                picked=(C, rows) == (pick_c, pick_rows),
                                bitwise_as_picked=same)
                            print(json.dumps(rec), flush=True)
                            out.write(json.dumps(rec) + "\n")
                    del want
                del hin, wx, wh, b, m, xw
                torch.cuda.empty_cache()
    return 0


def build_diag(names, kind: str = "bwd") -> dict:
    """The ``--diag`` variants of ``kind``'s source (:data:`SOURCES`),
    each built into a library → {name: CDLL} with the backward's entry
    points typed."""
    import ctypes

    source, table, entry, n_ints, _ = SOURCES[kind]
    out_dir = os.path.join(ROOT, "build", "cluster_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(CSRC, source)).read()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for name in names:
        if name.startswith("file:"):
            # Another version of the source, as it is.
            text = open(name[5:]).read()
            name = os.path.basename(name[5:]).replace(".", "_")
        else:
            text = src
            for part in name.split("+"):
                for old, new in table[part]:
                    if text.count(old) != 1:
                        raise SystemExit(f"{part}: {old!r} is not in the "
                                         f"source once")
                    text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", cu,
             os.path.join(CSRC, "window_gather.cu"), "-o",
             os.path.join(out_dir, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, ci, cf, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = ([ci, ci] + [vp] * 12 + [ci, vp] + [ci] * n_ints
                       + [cll] * 5 + [cf, vp])
        if kind == "fwd_grid_bf16":
            fn.argtypes = ([ci, ci] + [vp] * 10 + [ci] * n_ints + [cll] * 5
                           + [cf, vp, vp])
            lib.lfm_rnn_fwd_grid_ctas.argtypes = [ci] * 5
            lib.lfm_rnn_fwd_grid_ctas.restype = ci
            lib.lfm_rnn_fwd_grid_smem.argtypes = [ci] * 4
            lib.lfm_rnn_fwd_grid_smem.restype = cll
        if kind in ("bwd_grid", "bwd_grid_bf16"):
            # The scratch pointers sync and stats beside dw (bf16: and the
            # exchange beside dhn, and the kernels' count beside the
            # stream).
            bf = kind == "bwd_grid_bf16"
            fn.argtypes = ([ci, ci] + [vp] * (13 if bf else 12) + [ci]
                           + [vp] * 3 + [ci] * n_ints + [cll] * 5
                           + ([cf, vp, vp] if bf else [cf, vp]))
            tag = "grid_bf16" if bf else "grid"
            getattr(lib, f"lfm_rnn_bwd_{tag}_ctas").argtypes = [ci] * 4
            getattr(lib, f"lfm_rnn_bwd_{tag}_ctas").restype = ci
            getattr(lib, f"lfm_rnn_bwd_{tag}_smem").argtypes = [ci] * 4
            getattr(lib, f"lfm_rnn_bwd_{tag}_smem").restype = cll
        fn.restype = ci
        lib.lfm_cuda_error_string.argtypes = [ci]
        lib.lfm_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def diag_cases(torch, R, out, card, libs, cell, hin, wx, b, wh, m, xw, dh,
               limit, sms, reps):
    """Rows 4 and 2 at the picked pair on each ``--diag`` variant's
    library (the wrapper's own arguments, its library swapped)."""
    B, T, H = hin.shape
    bf = torch.bfloat16
    C = R._cluster_bwd_size(cell, H, limit)
    rows = R._cluster_bwd_rows(cell, H, C, B, 1, limit, sms)
    real = R._build.library
    for fused in (True, False):
        src = hin.float() @ wx.float() + b.float() if fused else xw
        h, c = R.rnn_scan_states(cell, src, wh, m, 1.0, True)
        h, c = h.to(bf), None if c is None else c.to(bf)
        ops = (hin, wx, b) if fused else (xw, None, None)

        def run():
            return R._launch_bwd_cluster(cell, fused, *ops, wh, m, h, c, dh,
                                         1.0, cluster=C, rows=rows)

        R._cluster_bwd_check(cell, fused, H, C, rows, hin.device)
        for name, lib in libs.items():
            R._build.library = lambda lib=lib: lib
            try:
                ks = kernels_ms(torch, run)
                rec = dict(
                    card=card, cell=cell, variant=name,
                    form="fused_bwd" if fused else "bwd", shape=[B, T, H],
                    cluster=C, rows=rows, ms=mean_ms(torch, run, reps),
                    recur_ms=sum(v for k, v in ks.items()
                                 if SOURCES["bwd"][4] in k))
            finally:
                R._build.library = real
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
        del h, c
        torch.cuda.empty_cache()


def tf32_cases(torch, R, out, card, libs, cell, B, T, H, rnd, limit, sms,
               reps, picked_only=False):
    """Rows 4 and 2 in float32 on the 3xTF32 cluster at every (cluster
    size, rows) pair it takes and the card holds, as :func:`bwd_cases`
    does for bf16, then each ``--diag`` variant at the picked pair."""
    G = GATES[cell] * H
    hin = torch.randn(B, T, H, **rnd)
    wx = H ** -0.5 * torch.randn(H, G, **rnd)
    wh = H ** -0.5 * torch.randn(H, G, **rnd)
    b = 0.1 * torch.randn(G, **rnd)
    m = torch.rand(B, T, **rnd) < 0.75
    dh = 0.1 * torch.randn(B, T, H, **rnd)
    xw = hin @ wx + b
    dev = hin.device
    pick_c = R._tf32_cluster(cell, H, limit)
    pick_rows = R._tf32_rows(cell, H, pick_c, B, 1, limit, sms)
    h, c = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
    for fused in (True, False):
        ops = (hin, wx, b) if fused else (xw, None, None)

        def run(C, rows):
            return R._launch_bwd_tf32(cell, fused, *ops, wh, m, h, c, dh,
                                      1.0, cluster=C, rows=rows)

        want = run(pick_c, pick_rows)
        for C in R.TF32_CLUSTERS["bwd"][1:]:
            for rows in R.TF32_CLUSTER_ROWS:
                if not (R._tf32_takes(H, C, rows)
                        and R._tf32_smem(cell, H, C, "bwd", rows) <= limit):
                    continue
                if picked_only and (C, rows) != (pick_c, pick_rows):
                    continue
                clusters = R._tf32_bwd_check(cell, H, C, rows, dev)
                got = run(C, rows)
                same = (all(torch.equal(g, w) for g, w in zip(got, want))
                        if C == pick_c else None)
                del got
                picked = (C, rows) == (pick_c, pick_rows)
                rec = dict(
                    card=card, cell=cell, dtype="float32",
                    form="fused_bwd" if fused else "bwd", shape=[B, T, H],
                    cluster=C, rows=rows, warps=R._cluster_warps(H, C),
                    smem=R._tf32_smem(cell, H, C, "bwd", rows),
                    clusters_at_once=clusters,
                    ms=mean_ms(torch, lambda: run(C, rows), reps),
                    picked=picked, bitwise_as_picked=same)
                if picked:
                    rec["kernels_ms"] = kernels_ms(
                        torch, lambda: run(C, rows))
                print(json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")
        del want
        real = R._build.library
        for name, lib in libs.items():
            R._build.library = lambda lib=lib: lib
            try:
                ks = kernels_ms(torch, lambda: run(pick_c, pick_rows))
                rec = dict(
                    card=card, cell=cell, dtype="float32", variant=name,
                    form="fused_bwd" if fused else "bwd", shape=[B, T, H],
                    cluster=pick_c, rows=pick_rows,
                    ms=mean_ms(torch, lambda: run(pick_c, pick_rows), reps),
                    recur_ms=sum(v for k, v in ks.items()
                                 if SOURCES["bwd_tf32"][4] in k))
            finally:
                R._build.library = real
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
        torch.cuda.empty_cache()
    del hin, wx, wh, b, m, dh, xw, h, c
    torch.cuda.empty_cache()


def grid_cases(torch, R, out, card, libs, cell, B, T, H, rnd, limit, sms,
               reps, picked_only=False, dtype=None):
    """Rows 4 and 2 on the grid backward of ``dtype`` (float32 or bf16) at
    every (group, rows) pair with a distinct chunk count a CTA, as
    :func:`tf32_cases` does for the cluster form (the module docstring),
    then each ``--diag`` variant at the picked pair."""
    G = GATES[cell] * H
    dtype = dtype or torch.float32
    dname = str(dtype).replace("torch.", "")
    hin = torch.randn(B, T, H, **rnd)
    wx = H ** -0.5 * torch.randn(H, G, **rnd)
    wh = H ** -0.5 * torch.randn(H, G, **rnd)
    b = 0.1 * torch.randn(G, **rnd)
    m = torch.rand(B, T, **rnd) < 0.75
    dh = 0.1 * torch.randn(B, T, H, **rnd)
    xw = hin @ wx + b
    hin, wx, wh, b, dh = (t.to(dtype) for t in (hin, wx, wh, b, dh))
    xw_in = xw.to(dtype)
    dev = hin.device
    W = H // 8
    pick_n = R._grid_size(cell, H, limit, sms, dtype)
    pick_rows = R._grid_rows(cell, H, pick_n, B, 1, limit, sms, dtype)
    pairs = [(pick_n, pick_rows)]
    for nc in range(1, R._grid_chunks(H, 1) + 1):
        n = -(-W // nc)
        for rows in R.GRID_ROWS:
            if (n <= sms and (n, rows) not in pairs
                    and R._grid_takes(H, n, rows, dtype)
                    and R._grid_smem(cell, H, n, rows, dtype) <= limit
                    and not picked_only):
                pairs.append((n, rows))
    kernel = SOURCES["bwd_grid_bf16" if dtype == torch.bfloat16
                     else "bwd_grid"][4]
    for fused in (True, False):
        h, c = R.rnn_scan_states(cell, xw if fused else xw_in, wh, m, 1.0,
                                 True)
        h, c = h.to(dtype), None if c is None else c.to(dtype)
        ops = (hin, wx, b) if fused else (xw_in, None, None)

        def run(n, rows, stats=None):
            return R._launch_bwd_grid(cell, fused, *ops, wh, m, h, c, dh,
                                      1.0, group=n, rows=rows, stats=stats)

        want = run(pick_n, pick_rows)
        for n, rows in pairs:
            ctas = R._grid_check(cell, H, n, rows, dev, dtype)
            got = run(n, rows)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            del got
            picked = (n, rows) == (pick_n, pick_rows)
            rec = dict(
                card=card, cell=cell, dtype=dname,
                form="fused_bwd" if fused else "bwd", shape=[B, T, H],
                group=n, rows=rows, chunks=R._grid_chunks(H, n),
                groups=min(ctas // n, -(-B // rows)),
                smem=R._grid_smem(cell, H, n, rows, dtype),
                ctas_at_once=ctas,
                ms=mean_ms(torch, lambda: run(n, rows), reps),
                picked=picked, bitwise_as_picked=same)
            if picked:
                ks = kernels_ms(torch, lambda: run(n, rows))
                rec["kernels_ms"] = ks
                stats = {}
                run(n, rows, stats)
                torch.cuda.synchronize()
                cyc = stats["cycles"].double()
                rec["wait_share"] = float((cyc[:, 0] / cyc[:, 1]).mean())
                if dtype == torch.bfloat16:
                    recur = sum(v for k, v in ks.items() if kernel in k)
                    rec["gather_bytes"] = (T - 1) * n * B * G * 4
                    rec["gather_gb_per_s"] = (
                        rec["gather_bytes"] / recur / 1e6 if recur else None)
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
        del want
        real = R._build.library
        for name, lib in libs.items():
            R._build.library = lambda lib=lib: lib
            rec = dict(card=card, cell=cell, dtype=dname, variant=name,
                       form="fused_bwd" if fused else "bwd", shape=[B, T, H],
                       group=pick_n, rows=pick_rows)
            try:
                ks = kernels_ms(torch, lambda: run(pick_n, pick_rows))
                rec.update(
                    ms=mean_ms(torch, lambda: run(pick_n, pick_rows), reps),
                    recur_ms=sum(v for k, v in ks.items() if kernel in k))
            except RuntimeError as exc:
                # A variant whose shared memory is past the card's at the
                # picked group (more or wider stages).
                rec["refused"] = str(exc)
            finally:
                R._build.library = real
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
        torch.cuda.empty_cache()
    del hin, wx, wh, b, m, dh, xw, xw_in, h, c
    torch.cuda.empty_cache()


def fwd_grid_cases(torch, R, out, card, libs, cell, B, T, H, rnd, limit,
                   sms, reps, picked_only=False):
    """Rows 3 and 1 on the bf16 grid forward at every (group, rows) pair
    with a distinct chunk count a CTA, then each ``--diag`` variant at the
    picked pair (the module docstring)."""
    G = GATES[cell] * H
    bf = torch.bfloat16
    hin = torch.randn(B, T, H, **rnd).to(bf)
    wx = (H ** -0.5 * torch.randn(H, G, **rnd)).to(bf)
    wh = (H ** -0.5 * torch.randn(H, G, **rnd)).to(bf)
    b = (0.1 * torch.randn(G, **rnd)).to(bf)
    m = torch.rand(B, T, **rnd) < 0.75
    xw = (hin.float() @ wx.float() + b.float()).to(bf)
    dev = hin.device
    W = H // 8
    pick_n = R._fwd_grid_size(cell, H, limit, sms)
    pick_rows = R._fwd_grid_rows(cell, H, pick_n, B, 1, limit, sms)
    pairs = [(pick_n, pick_rows)]
    for nc in range(1, R._grid_chunks(H, 1) + 1):
        n = -(-W // nc)
        for rows in R.GRID_ROWS:
            if (n <= sms and (n, rows) not in pairs and not picked_only
                    and R._grid_takes(H, n, rows, bf)
                    and R._fwd_grid_smem(cell, H, n, rows) <= limit):
                pairs.append((n, rows))
    kernel = SOURCES["fwd_grid_bf16"][4]
    with torch.no_grad():
        for fused in (True, False):
            ops = (hin, wx, b) if fused else (xw, None, None)

            def run(n, rows, stats=None):
                return R._launch_fwd_grid(cell, fused, *ops, wh, m, 1.0,
                                          True, group=n, rows=rows,
                                          stats=stats)

            want = run(pick_n, pick_rows)
            for n, rows in pairs:
                ctas = R._fwd_grid_check(cell, fused, H, n, rows, dev)
                got = run(n, rows)
                same = all((g is None and w is None) or torch.equal(g, w)
                           for g, w in zip(got, want))
                del got
                picked = (n, rows) == (pick_n, pick_rows)
                rec = dict(
                    card=card, cell=cell, dtype="bfloat16",
                    form="fused_fwd" if fused else "fwd", shape=[B, T, H],
                    group=n, rows=rows, chunks=R._grid_chunks(H, n),
                    groups=min(ctas // n, -(-B // rows)),
                    smem=R._fwd_grid_smem(cell, H, n, rows),
                    ctas_at_once=ctas,
                    ms=mean_ms(torch, lambda: run(n, rows), reps),
                    picked=picked, bitwise_as_picked=same)
                if picked:
                    ks = kernels_ms(torch, lambda: run(n, rows))
                    rec["kernels_ms"] = ks
                    stats = {}
                    run(n, rows, stats)
                    torch.cuda.synchronize()
                    cyc = stats["cycles"].double()
                    rec["wait_share"] = float((cyc[:, 0] / cyc[:, 1]).mean())
                    recur = sum(v for k, v in ks.items() if kernel in k)
                    rec["recur_ms"] = recur
                    rec["gather_bytes"] = ((T - 1) * -(-B // rows) * n * rows
                                           * H * 2)
                    rec["gather_gb_per_s"] = (
                        rec["gather_bytes"] / recur / 1e6 if recur else None)
                print(json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")
            del want
            real = R._build.library
            for name, lib in libs.items():
                R._build.library = lambda lib=lib: lib
                rec = dict(card=card, cell=cell, dtype="bfloat16",
                           variant=name,
                           form="fused_fwd" if fused else "fwd",
                           shape=[B, T, H], group=pick_n, rows=pick_rows)
                try:
                    ks = kernels_ms(torch, lambda: run(pick_n, pick_rows))
                    rec.update(
                        ms=mean_ms(torch, lambda: run(pick_n, pick_rows),
                                   reps),
                        recur_ms=sum(v for k, v in ks.items()
                                     if kernel in k))
                except RuntimeError as exc:
                    # A variant whose stages are past the card's shared
                    # memory at the picked group.
                    rec["refused"] = str(exc)
                finally:
                    R._build.library = real
                print(json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")
            torch.cuda.empty_cache()
    del hin, wx, wh, b, m, xw
    torch.cuda.empty_cache()


def mean_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``reps`` back-to-back calls between CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernels_ms(torch, fn, calls: int = 2) -> dict:
    """Device ms a call of each CUDA kernel ``fn`` launches, by name, from
    ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0:
            out[ev.key[:80]] = us / 1e3 / calls
    return out


def bwd_cases(torch, R, out, card, cell, hin, wx, b, wh, m, xw, dh, limit,
              sms, reps):
    """Rows 4 and 2 at every (cluster size, rows) pair the backward takes
    (the module docstring)."""
    B, T, H = hin.shape
    dev = hin.device
    bf = torch.bfloat16
    pick_c = R._cluster_bwd_size(cell, H, limit)
    pick_rows = R._cluster_bwd_rows(cell, H, pick_c, B, 1, limit, sms)
    for fused in (True, False):
        src = hin.float() @ wx.float() + b.float() if fused else xw
        h, c = R.rnn_scan_states(cell, src, wh, m, 1.0, True)
        h, c = h.to(bf), None if c is None else c.to(bf)
        del src
        ops = (hin, wx, b) if fused else (xw, None, None)

        def run(C, rows):
            return R._launch_bwd_cluster(cell, fused, *ops, wh, m, h, c, dh,
                                         1.0, cluster=C, rows=rows)

        want = run(pick_c, pick_rows)
        for C in R.CLUSTER_SIZES:
            for rows in R.CLUSTER_ROWS:
                if not (R._cluster_bwd_takes(H, C, rows)
                        and R._cluster_bwd_smem(cell, H, C, rows) <= limit):
                    continue
                clusters = R._cluster_bwd_check(cell, fused, H, C, rows,
                                                dev)
                got = run(C, rows)
                same = (all(torch.equal(g, w) for g, w in zip(got, want))
                        if C == pick_c else None)
                del got
                picked = (C, rows) == (pick_c, pick_rows)
                rec = dict(
                    card=card, cell=cell,
                    form="fused_bwd" if fused else "bwd", shape=[B, T, H],
                    cluster=C, rows=rows, warps=R._cluster_warps(H, C),
                    smem=R._cluster_bwd_smem(cell, H, C, rows),
                    clusters_at_once=clusters,
                    ms=mean_ms(torch, lambda: run(C, rows), reps),
                    picked=picked, bitwise_as_picked=same)
                if picked:
                    rec["kernels_ms"] = kernels_ms(
                        torch, lambda: run(C, rows))
                print(json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")
        del want, h, c
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
