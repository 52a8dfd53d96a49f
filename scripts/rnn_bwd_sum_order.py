"""The float32 sums of ``csrc/rnn_bwd.cu`` (the CUDA-core backward) modelled
in numpy, in the kernel's own order, against float64: where a long sum's
rounding enters the gradients, and how much shorter chains of k take out.

The model runs the hoisted backward (row 2: dxw = the f32 d_gates, and
dW_h) as the kernel's float32 unit does: the gates recomputed by one FMA
chain over k of h_{t-1} @ W_h per (row, gate column), the cell's backward
in f32, the carry d_hw @ W_h^T by one chain over the G H columns per
(row, unit) (the GRU's n slice from dn r, continuing the same chain),
then dW_h = sum h_{t-1}^T d_hw by one chain over the B T rows. Each FMA is
``float32(float64(a) * float64(b) + float64(c))`` (the product is exact in
float64). ``--chain K`` sums every dot product in chains of K of k, each
chain's sum added to the total in k order, as the fixed kernel does.
Reported: each output's largest error scaled by its largest float64
magnitude (the tests' ``_scaled_close`` measure; their bound is 1e-5),
for the kernel's model and for the plain float32 version on this CPU, and
the model's distance from that plain version (the card test's measure,
with the card's plain version in its place).

The inputs are ``tests/test_torch_kernels.py::_bwd_inputs`` at its
float32 width past the grid (B 21, T 4, H 1040, weights 0.3 randn, seed
H): the failing card test's. Run with ``python scripts/rnn_bwd_sum_order.py
[--cell gru] [--chain 0 64] [--H 1040]`` (about ten seconds a chain on
one core). With ``--card`` (on the machine with the card) it runs both
forms' plain version and ``rnn_bwd.cu`` itself there instead, each against
float64, output by output.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lfm_quant_tpu_torch.ops import rnn as R  # noqa: E402

GATES = {"lstm": 4, "gru": 3}
f32 = np.float32


def fma_dot(a, b, chain: int, init=None):
    """``init + a [R, K] @ b [K, N]`` with one FMA chain over k per output
    continuing from ``init`` (chain 0), or chains of ``chain`` of k from
    zero, each added to the total in order."""
    K = a.shape[1]
    total = (np.zeros((a.shape[0], b.shape[1]), f32) if init is None
             else init.astype(f32))
    step = chain or K
    for k0 in range(0, K, step):
        part = total if chain == 0 else np.zeros_like(total)
        for k in range(k0, min(K, k0 + step)):
            part = (np.outer(a[:, k].astype(np.float64), b[k].astype(np.float64))
                    + part).astype(f32)
        total = part if chain == 0 else (total + part).astype(f32)
    return total


def dot64(a, b, init=None):
    return a @ b if init is None else init + a @ b


def sigmoid(v):
    return (1 / (1 + np.exp(-v))).astype(v.dtype)


def backward(cell, xw, wh, m, h_all, c_all, dh, dot, dtype):
    """The hoisted backward's formulas (``csrc/rnn_bwd.cu``) in ``dtype``
    with every dot product by ``dot`` → (d_xw, dW_h)."""
    B, T, GH = xw.shape
    G = GATES[cell]
    H = GH // G
    c = (lambda v: np.asarray(v, dtype))
    whT = c(wh.T)
    h_prev = np.concatenate([np.zeros((B, 1, H)), h_all[:, :-1]], 1).astype(dtype)
    d_xw = np.zeros((B, T, GH), dtype)
    d_hw = np.zeros((B, T, GH), dtype)
    dhc = np.zeros((B, H), dtype)
    dcc = np.zeros((B, H), dtype)
    one = dtype(1)
    for t in reversed(range(T)):
        keep = c(m[:, t, None])
        hs = dot(h_prev[:, t], c(wh))
        dh_t = c(dh[:, t] + dhc)
        dh_new = c(keep * dh_t)
        x = xw[:, t]
        if cell == "lstm":
            ig, fg = sigmoid(c(x[:, :H] + hs[:, :H])), sigmoid(c(x[:, H:2 * H] + hs[:, H:2 * H] + one))
            gg, og = np.tanh(c(x[:, 2 * H:3 * H] + hs[:, 2 * H:3 * H])), sigmoid(c(x[:, 3 * H:] + hs[:, 3 * H:]))
            cp = c(c_all[:, t - 1]) if t > 0 else np.zeros((B, H), dtype)
            tc = np.tanh(c(c_all[:, t]))
            dc_tot = c(keep * dcc + dh_new * og * (one - tc * tc))
            dg = np.concatenate([dc_tot * gg * ig * (one - ig), dc_tot * cp * fg * (one - fg),
                                 dc_tot * ig * (one - gg * gg), dh_new * tc * og * (one - og)], 1)
            d_xw[:, t] = d_hw[:, t] = dg
            dcc = c((one - keep) * dcc + dc_tot * fg)
            base = c((one - keep) * dh_t)
        else:
            z, r = sigmoid(c(x[:, :H] + hs[:, :H])), sigmoid(c(x[:, H:2 * H] + hs[:, H:2 * H]))
            hn = hs[:, 2 * H:]
            n = np.tanh(c(x[:, 2 * H:] + r * hn))
            dn = c(dh_new * (one - z) * (one - n * n))
            dz = c(dh_new * (h_prev[:, t] - n) * z * (one - z))
            dr = c(dn * hn * r * (one - r))
            d_xw[:, t] = np.concatenate([dz, dr, dn], 1)
            d_hw[:, t] = np.concatenate([dz, dr, c(dn * r)], 1)
            base = c((one - keep) * dh_t + dh_new * z)
        # The GRU's n slice is a second call of rows_dot on the same sums.
        nx = GH if cell == "lstm" else 2 * H
        carry = dot(d_hw[:, t, :nx], whT[:nx])
        if cell == "gru":
            carry = dot(d_hw[:, t, nx:], whT[nx:], carry)
        dhc = c(base + carry)
    flat = (lambda a: a.reshape(-1, a.shape[-1]))
    return d_xw, dot(flat(h_prev).T.copy(), flat(d_hw))


def test_inputs(cell: str, H: int, B: int = 21, T: int = 4):
    """``tests/test_torch_kernels.py::_bwd_inputs``'s operands (seed H),
    float32 numpy: hin, W_x, b, W_h, m, dh."""
    G = GATES[cell] * H
    rng = np.random.default_rng(H)
    hin = rng.standard_normal((B, T, H)).astype(f32)
    wx = (0.3 * rng.standard_normal((H, G))).astype(f32)
    b = (0.1 * rng.standard_normal((G,))).astype(f32)
    wh = (0.3 * rng.standard_normal((H, G))).astype(f32)
    m = rng.random((B, T)) < 0.75
    m[0] = False
    dh = np.random.default_rng(H + 1).standard_normal((B, T, H)).astype(f32)
    return hin, wx, b, wh, m, dh


def on_card(cell: str, H: int) -> None:
    """Both forms on the card at the test's inputs (states from the plain
    forward there, as the test makes them): the plain float32 version
    (cuBLAS, TF32 off) and ``rnn_bwd.cu`` each against float64, and their
    distance, output by output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    hin, wx, b, wh, m, dh = test_inputs(cell, H)
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in (hin, wx, b, wh, m, dh)]
    hin_t, wx_t, b_t, wh_t, m_t, dh_t = t
    for fused in (True, False):
        xw_t = hin_t @ wx_t + b_t
        h_t, c_t = R.rnn_scan_states(cell, xw_t, wh_t, m_t, 1.0, True)
        if fused:
            ops = (hin_t, wx_t, b_t, wh_t, m_t, h_t, c_t, dh_t)
            plain = R.rnn_scan_fused_bwd_reference(cell, *ops)
            kern = R._launch_bwd(cell, True, *ops, 1.0)
            xw64 = hin.astype(np.float64) @ wx + b
        else:
            ops = (xw_t, wh_t, m_t, h_t, c_t, dh_t)
            plain = R.rnn_scan_bwd_reference(cell, *ops)
            kern = R._launch_bwd(cell, False, xw_t, None, None, *ops[1:], 1.0)
            xw64 = xw_t.double().cpu().numpy()
        h = h_t.cpu().numpy()
        cc = None if c_t is None else c_t.cpu().numpy()
        d_xw, dw_h = backward(cell, xw64, wh, m, h, cc, dh, dot64, np.float64)
        if fused:
            flat = (lambda a: a.reshape(-1, a.shape[-1]))
            want = (d_xw @ wx.T.astype(np.float64), flat(hin).T @ flat(d_xw),
                    d_xw.sum(axis=(0, 1)), dw_h)
            names = ("dhin", "dW_x", "db", "dW_h")
        else:
            want, names = (d_xw, dw_h), ("dxw", "dW_h")
        print(f"{cell} {'fused' if fused else 'hoisted'} B 21 T 4 H {H} on "
              f"{torch.cuda.get_device_name(0)}: scaled errors")
        for name, p, k, w in zip(names, plain, kern, want):
            scale = np.abs(w).max()
            p, k = (v.double().cpu().numpy() for v in (p, k))
            print(f"  {name}: plain {np.abs(p - w).max() / scale:.4g}, "
                  f"rnn_bwd.cu {np.abs(k - w).max() / scale:.4g}, apart "
                  f"{np.abs(k - p).max() / scale:.4g}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(GATES), default="gru")
    ap.add_argument("--H", type=int, default=1040)
    ap.add_argument("--chain", type=int, nargs="+", default=[0, 64])
    ap.add_argument("--card", action="store_true",
                    help="run the plain version and rnn_bwd.cu on the card")
    args = ap.parse_args(argv)
    if args.card:
        return on_card(args.cell, args.H)
    cell, H, B, T = args.cell, args.H, 21, 4
    hin, wx, b, wh, m, dh = test_inputs(cell, H, B, T)
    xw = (torch.from_numpy(hin) @ torch.from_numpy(wx) + torch.from_numpy(b))
    h, cc = R.rnn_scan_states(cell, xw, torch.from_numpy(wh), torch.from_numpy(m), 1.0, True)
    xw, h = xw.numpy(), h.numpy()
    cc = None if cc is None else cc.numpy()
    want = backward(cell, xw.astype(np.float64), wh, m, h, cc, dh, dot64,
                    np.float64)
    scale = [np.abs(w).max() for w in want]
    plain = R.rnn_scan_bwd_reference(cell, torch.from_numpy(xw), torch.from_numpy(wh),
                                     torch.from_numpy(m), torch.from_numpy(h),
                                     None if cc is None else torch.from_numpy(cc),
                                     torch.from_numpy(dh))
    print(f"{cell} B {B} T {T} H {H}: scaled error against float64 "
          f"(dxw, dW_h; the card test's bound 1e-5)")
    errs = [float(np.abs(g.numpy().astype(np.float64) - w).max() / s)
            for g, w, s in zip(plain, want, scale)]
    print(f"  plain float32 (torch on the CPU): {errs}")
    for chain in args.chain:
        got = backward(cell, xw, wh, m, h, cc, dh,
                       lambda a, w, i=None, k=chain: fma_dot(a, w, k, i), f32)
        errs = [float(np.abs(g.astype(np.float64) - w).max() / s)
                for g, w, s in zip(got, want, scale)]
        near = [float(np.abs(g.astype(np.float64) - p.numpy()).max() / s)
                for g, p, s in zip(got, plain, scale)]
        print(f"  rnn_bwd.cu model, chain {chain or 'one'}: {errs}; against "
              f"the plain float32: {near}")


if __name__ == "__main__":
    main()
