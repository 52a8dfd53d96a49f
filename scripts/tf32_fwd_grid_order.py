"""The float32 grid forward (``csrc/rnn_fwd_tf32_grid.cu``) modelled in
numpy, in the kernel's own order, against float64: how far its h_all and
c_all land from the exact recurrence, and from the plain float32 version,
at a real width and window before the card runs it.

The model runs what the kernel runs per step and (row, unit):

* the product h_{t-1} @ W_h[:, unit] in 3xTF32: each f32 operand split
  into hi = tf32(v) (a half TF32 ulp added to the magnitude's bits, the
  low 13 bits cleared: round to nearest, ties away) and lo = v - hi
  rounded the same way (the kernel's ``kRoundLo``); per k-step of 8 (the
  kernel's ``kRecurChainK``) the three mma a_lo b_hi, a_hi b_lo, a_hi b_hi
  into one accumulator from zero, each mma's 8 products (exact: TF32 x
  TF32 fits f32) summed in float64 and added to the accumulator with one
  rounding to f32 (the tensor cores truncate there; that bias is below
  the model's resolution at one k-step a chain), then the k-step's sum
  added to the f32 gate sum in k order;
* xw_t added after it (``kXwLast``); the fused form's xw one f32 FMA chain
  over k per (row, gate column) from zero, then + b (the CUDA-core GEMM's
  order), the hoisted form's the given f32 xw;
* the cell in f32, each product and sum of the carries' updates rounded
  (no fused multiply-add), h and c held on a masked step.

A (row, unit)'s sums run over the same k in the same order for any group
size or rows a work item, so the model has neither.

Reported for rows 3 (fused) and 1 (hoisted), both cells: the model's and
the plain float32 version's (``ops/rnn.py rnn_scan_states``, on this CPU)
largest error in h_all and c_all against float64 (the same formulas on
float64 copies of the operands), the model's distance from the plain
version (the card's check: atol 1e-5), and the largest |c|. Inputs as
``chip_smoke.py`` phase 28 makes them: hin ~ N(0, 1), W_x and W_h at
scale H^-1/2, b at 0.1, 75% of the steps valid, from ``--seed``.

    python scripts/tf32_fwd_grid_order.py [--H 400] [--T 60] [--B 64]
        [--cell lstm gru] [--seed 0]

About a minute at the defaults on one core. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GATES = {"lstm": 4, "gru": 3}
KSTEP = 8  # k of one mma.sync m16n8k8 .tf32
f32 = np.float32


def tf32_round(v):
    """``v`` (f32) rounded to TF32: half a TF32 ulp added to the
    magnitude's bits, the low 13 bits cleared (the kernel's
    ``split_tf32``)."""
    bits = np.ascontiguousarray(v, f32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(f32)


def split_tf32(v):
    """v = hi + lo with hi = tf32(v) and lo = v - hi rounded to TF32."""
    v = np.asarray(v, f32)
    hi = tf32_round(v)
    return hi, tf32_round((v - hi).astype(f32))


def product_3xtf32(h, w):
    """``h [R, K] @ w [K, N]`` as the kernel forms it: per k-step of 8 the
    three mma from zero (lo hi, hi lo, hi hi), each rounded to f32 once,
    then the k-steps' sums added to the f32 total in k order."""
    R, K = h.shape
    ah, al = split_tf32(h)
    bh, bl = split_tf32(w)
    nk = -(-K // KSTEP)
    pad = nk * KSTEP - K

    def steps(a, b):
        a = np.pad(a, ((0, 0), (0, pad))).reshape(R, nk, KSTEP)
        b = np.pad(b, ((0, pad), (0, 0))).reshape(nk, KSTEP, -1)
        return np.einsum("rsk,skn->srn", a.astype(np.float64),
                         b.astype(np.float64))

    cacc = steps(al, bh).astype(f32)
    cacc = (cacc + steps(ah, bl)).astype(f32)
    cacc = (cacc + steps(ah, bh)).astype(f32)
    total = np.zeros(cacc.shape[1:], f32)
    for s in range(nk):
        total = (total + cacc[s]).astype(f32)
    return total


def fma_gemm(a, w, b):
    """``a [M, K] @ w [K, N] + b``: one f32 FMA chain over k from zero per
    output, then + b (the CUDA-core GEMM, ``tf32_common.cuh``
    ``fwd_sgemm_kernel``)."""
    acc = np.zeros((a.shape[0], w.shape[1]), f32)
    for k in range(a.shape[1]):
        acc = (np.outer(a[:, k].astype(np.float64), w[k].astype(np.float64))
               + acc).astype(f32)
    return (acc + b).astype(f32)


def _sigmoid(v):
    return (f32(1) / (f32(1) + np.exp(-v))).astype(f32)


def grid_fwd_model(cell, x, wh, m, fb=1.0):
    """The kernel's order on f32 numpy arrays (``x`` the f32 x side [B, T,
    G H] with the bias) → (h_all, c_all or None), f32."""
    B, T, GH = x.shape
    G = GATES[cell]
    H = GH // G
    h = np.zeros((B, H), f32)
    c = np.zeros((B, H), f32)
    hs, cs = [], []
    for t in range(T):
        acc = (product_3xtf32(h, wh) if t > 0 else np.zeros((B, GH), f32))
        kp = m[:, t, None].astype(bool)
        a = np.split(acc, G, axis=-1)
        xs = np.split(x[:, t].astype(f32), G, axis=-1)
        if cell == "lstm":
            ig = _sigmoid((xs[0] + a[0]).astype(f32))
            fg = _sigmoid(((xs[1] + a[1]).astype(f32) + f32(fb)).astype(f32))
            gg = np.tanh((xs[2] + a[2]).astype(f32))
            og = _sigmoid((xs[3] + a[3]).astype(f32))
            c_new = ((fg * c).astype(f32) + (ig * gg).astype(f32)).astype(f32)
            h_new = (og * np.tanh(c_new)).astype(f32)
            c = np.where(kp, c_new, c)
            h = np.where(kp, h_new, h)
            cs.append(c)
        else:
            z = _sigmoid((xs[0] + a[0]).astype(f32))
            rg = _sigmoid((xs[1] + a[1]).astype(f32))
            n = np.tanh((xs[2] + (rg * a[2]).astype(f32)).astype(f32))
            h_new = (((f32(1) - z) * n).astype(f32)
                     + (z * h).astype(f32)).astype(f32)
            h = np.where(kp, h_new, h)
        hs.append(h)
    return (np.stack(hs, axis=1),
            np.stack(cs, axis=1) if cell == "lstm" else None)


def inputs(cell, B, T, H, seed):
    """Seeded f32 operands (``chip_smoke.py`` phase 28's scales)."""
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    hin = rng.standard_normal((B, T, H)).astype(f32)
    wx = (H ** -0.5 * rng.standard_normal((H, G))).astype(f32)
    wh = (H ** -0.5 * rng.standard_normal((H, G))).astype(f32)
    b = (0.1 * rng.standard_normal(G)).astype(f32)
    m = rng.random((B, T)) < 0.75
    return hin, wx, b, wh, m


def main() -> int:
    import torch

    from lfm_quant_tpu_torch.ops import rnn as R

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--H", type=int, default=400)
    ap.add_argument("--T", type=int, default=60)
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--cell", nargs="+", default=["lstm", "gru"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    for cell in args.cell:
        hin, wx, b, wh, m = inputs(cell, args.B, args.T, args.H, args.seed)
        B, T, H = hin.shape
        flat = hin.reshape(B * T, H)
        xw_fma = fma_gemm(flat, wx, b).reshape(B, T, -1)
        xw_plain = (torch.from_numpy(hin) @ torch.from_numpy(wx)
                    + torch.from_numpy(b))
        xw64 = (torch.from_numpy(hin).double() @ torch.from_numpy(wx).double()
                + torch.from_numpy(b).double())
        wh_t, m_t = torch.from_numpy(wh), torch.from_numpy(m)
        exact = R.rnn_scan_states(cell, xw64, wh_t.double(), m_t, 1.0, True)
        for row, model_x, plain_x in ((3, xw_fma, xw_plain),
                                      (1, xw_plain.numpy(), xw_plain)):
            model = grid_fwd_model(cell, model_x, wh, m)
            plain = R.rnn_scan_states(cell, plain_x, wh_t, m_t, 1.0, True)
            rec = dict(cell=cell, row=row, B=B, T=T, H=H, seed=args.seed)
            for state, got, ref, want in zip("hc", model, plain, exact):
                if want is None:
                    continue
                want = want.numpy()
                ref = ref.numpy()
                rec[f"model_vs_f64_{state}"] = float(np.abs(got - want).max())
                rec[f"plain_vs_f64_{state}"] = float(np.abs(ref - want).max())
                rec[f"model_vs_plain_{state}"] = float(
                    np.abs(got - ref).max())
                rec[f"max_abs_{state}"] = float(np.abs(want).max())
            rec["within_1e-5_of_plain"] = all(
                v <= 1e-5 for k, v in rec.items()
                if k.startswith("model_vs_plain"))
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
