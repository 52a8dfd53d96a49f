#!/usr/bin/env python3
"""The bfloat16 forward above hidden 128 (``csrc/rnn_fwd_cluster.cu``) at
every cluster size and rows per cluster it takes, on the card.

    python3 scripts/torch_cluster_variants.py [--widths 256 320 512]
        [--batch 2048] [--steps 60] [--reps 5] [--out FILE]

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
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = {"lstm": 4, "gru": 3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[256, 320, 512])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "cluster_variants.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from lfm_quant_tpu_torch.ops import rnn as R

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
                hin = torch.randn(B, T, H, **rnd).to(bf)
                wx = (H ** -0.5 * torch.randn(H, G, **rnd)).to(bf)
                wh = (H ** -0.5 * torch.randn(H, G, **rnd)).to(bf)
                b = (0.1 * torch.randn(G, **rnd)).to(bf)
                m = torch.rand(B, T, **rnd) < 0.75
                xw = (hin.float() @ wx.float() + b.float()).to(bf)
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


if __name__ == "__main__":
    sys.exit(main())
