"""The fused masked LSTM/GRU recurrence: a hand-written CUDA kernel
(``csrc/rnn_fused_fwd.cu``) and its plain version.

Port of ``lfm_quant_tpu/ops/pallas_rnn.py``, forward only. The public
functions keep the JAX layouts: batch-major ``[B, T, .]`` and Flax
``[in, out]`` weights with gates concatenated on the last axis (LSTM
i, f, g, o; GRU z, r, n). An invalid step holds the carried state, so a
left-padded short history keeps the zero state until its first valid
month.
"""

from __future__ import annotations

import torch

from lfm_quant_tpu_torch.ops import _build

_GATES = {"lstm": 4, "gru": 3}
_CELL_CODE = {"lstm": 0, "gru": 1}


def _lstm_gates(gates: torch.Tensor, forget_bias: float):
    """Raw gate pre-activations [.., 4H] → (i, f, g, o) activations."""
    i, f, g, o = gates.chunk(4, dim=-1)
    return (torch.sigmoid(i), torch.sigmoid(f + forget_bias), torch.tanh(g),
            torch.sigmoid(o))


def _gru_parts(xw: torch.Tensor, hw: torch.Tensor):
    """Reset-after-projection GRU math → (z, r, n, hn)."""
    xz, xr, xn = xw.chunk(3, dim=-1)
    hz, hr, hn = hw.chunk(3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    return z, r, n, hn


def rnn_scan_reference(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                       m: torch.Tensor, forget_bias: float = 1.0
                       ) -> torch.Tensor:
    """The masked recurrence over a hoisted projection ``xw [B, T, G*H]``
    with an f32 carry: the JAX package's ``rnn_scan_reference``. Returns
    ``[B, T, H]`` in ``xw.dtype``."""
    B, T, G = xw.shape
    H = G // _GATES[cell]
    whf = wh.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    keep_all = m.to(torch.float32)
    out = []
    for t in range(T):
        xw_t = xw[:, t].float()
        keep = keep_all[:, t, None]
        if cell == "lstm":
            i, f, g, o = _lstm_gates(xw_t + h @ whf, forget_bias)
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            h = keep * h_new + (1.0 - keep) * h
            c = keep * c_new + (1.0 - keep) * c
        else:
            z, r, n, _ = _gru_parts(xw_t, h @ whf)
            h_new = (1.0 - z) * n + z * h
            h = keep * h_new + (1.0 - keep) * h
        out.append(h)
    return torch.stack(out, dim=1).to(xw.dtype)


def rnn_scan_fused_reference(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                             b: torch.Tensor, wh: torch.Tensor,
                             m: torch.Tensor, forget_bias: float = 1.0
                             ) -> torch.Tensor:
    """Plain version of :func:`rnn_scan_fused`: the reference recurrence
    fed ``hin @ wx + b`` computed in f32, as the JAX tests hold the fused
    kernel. Returns ``[B, T, H]`` in ``hin.dtype``."""
    xw = hin.float() @ wx.float() + b.float()
    return rnn_scan_reference(cell, xw, wh, m, forget_bias).to(hin.dtype)


def rnn_scan_fused(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                   b: torch.Tensor, wh: torch.Tensor, m: torch.Tensor,
                   forget_bias: float = 1.0) -> torch.Tensor:
    """Fused masked recurrence with the gate input projection computed
    inside the kernel. Forward only.

    Args:
      cell: "lstm" | "gru".
      hin: ``[B, T, H]`` layer input.
      wx: ``[H, G*H]`` gate input-projection weights.
      b: ``[G*H]`` gate bias.
      wh: ``[H, G*H]`` recurrent gate weights.
      m: ``[B, T]`` step validity (bool or 0/1); invalid steps hold state.

    Returns ``[B, T, H]`` hidden states in ``hin.dtype``. Tensors on the
    CPU go to the plain version; tensors on the card launch the kernel,
    which takes ``hin``, ``wx``, ``b`` and ``wh`` contiguous in one dtype
    (float32 or bfloat16).
    """
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {sorted(_GATES)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (hin, wx, b, wh)):
        raise NotImplementedError(
            "rnn_scan_fused is forward only: its backward kernel comes with "
            "the training slice (ROADMAP.md Queue B row 4). Call it under "
            "torch.no_grad() or torch.inference_mode().")
    if hin.dim() != 3:
        raise ValueError(f"hin must be [B, T, H], got {tuple(hin.shape)}")
    B, T, H = hin.shape
    G = _GATES[cell] * H
    if tuple(wx.shape) != (H, G) or tuple(wh.shape) != (H, G) \
            or tuple(b.shape) != (G,) or tuple(m.shape) != (B, T):
        raise ValueError(
            f"expected wx/wh [{H},{G}], b [{G}], m [{B},{T}]; got "
            f"{tuple(wx.shape)}/{tuple(wh.shape)}/{tuple(b.shape)}/"
            f"{tuple(m.shape)}")
    if hin.device.type == "cpu":
        return rnn_scan_fused_reference(cell, hin, wx, b, wh, m, forget_bias)
    if hin.device.type != "cuda":
        raise ValueError(f"unsupported device {hin.device}")
    for name, t in (("wx", wx), ("b", b), ("wh", wh), ("m", m)):
        if t.device != hin.device:
            raise ValueError(f"{name} is on {t.device}, hin on {hin.device}")
    for name, t in (("hin", hin), ("wx", wx), ("b", b), ("wh", wh)):
        if t.dtype != hin.dtype or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous {hin.dtype}, got "
                f"{t.dtype} (contiguous={t.is_contiguous()})")
    code = _build.dtype_code(hin.dtype)
    out = torch.empty_like(hin)
    if out.numel() == 0:
        return out
    lib = _build.library()
    smem = lib.lfm_rnn_fused_fwd_smem(_CELL_CODE[cell], H)
    limit = torch.cuda.get_device_properties(
        hin.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"hidden={H} needs {smem} bytes of shared memory per block, "
            f"more than the card's {limit}")
    keep = m.to(torch.uint8).contiguous()
    with torch.cuda.device(hin.device):
        err = lib.lfm_rnn_fused_fwd(
            _CELL_CODE[cell], code, hin.data_ptr(), wx.data_ptr(),
            b.data_ptr(), wh.data_ptr(), keep.data_ptr(), out.data_ptr(),
            None, B, T, H, float(forget_bias), _build.stream_of(hin))
    _build.check(lib, err, f"rnn_fused_fwd ({cell})")
    _build.count_launch(f"rnn_fused_fwd_{cell}")
    return out
