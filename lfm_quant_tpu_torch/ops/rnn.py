"""The masked LSTM/GRU recurrence: hand-written CUDA kernels
(``csrc/rnn_fused_fwd.cu``, ``csrc/rnn_fused_fwd_mma.cu``,
``csrc/rnn_bwd.cu``, ``csrc/rnn_fused_bwd_mma.cu``) and their plain
versions.

The fused forward and the fused backward each have two kernels, picked
by one rule, :func:`_mma_route`, from the dtype and H alone: bf16 with
16 <= H <= 128, H % 16 == 0 runs on the tensor cores
(``rnn_fused_fwd_mma.cu``, ``rnn_fused_bwd_mma.cu``); float32 and every
other H on the CUDA cores (``rnn_fused_fwd.cu``, ``rnn_bwd.cu``).

Port of ``lfm_quant_tpu/ops/pallas_rnn.py``, in its two forms:

* ``rnn_scan_fused`` — the gate input projection ``hin @ W_x + b``
  computed inside the kernel (the model's ``scan_impl="pallas_fused"``);
* ``rnn_scan`` — the recurrence over a hoisted projection ``xw``
  (``scan_impl="pallas"``).

Both are differentiable (``torch.autograd.Function``): the forward saves
the per-step states ``h_all`` (and ``c_all`` for the LSTM) and the
backward walks time in reverse, recomputing the gates from them, as the
TPU kernels' ``custom_vjp`` does. Under ``torch.no_grad`` or
``torch.inference_mode`` the forward saves nothing.

The public functions keep the JAX layouts: batch-major ``[B, T, .]`` and
Flax ``[in, out]`` weights with gates concatenated on the last axis (LSTM
i, f, g, o; GRU z, r, n). An invalid step holds the carried state, so a
left-padded short history keeps the zero state until its first valid
month. Tensors on the CPU go to the plain versions; tensors on the card
launch the kernels or raise.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def rnn_scan_states(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                    m: torch.Tensor, forget_bias: float = 1.0,
                    with_c: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The masked recurrence with an f32 carry → the states a backward
    needs, ``(h_all, c_all)`` in ``xw.dtype`` (``c_all`` only for the LSTM
    and when asked): the plain forward of :func:`rnn_scan`."""
    B, T, G = xw.shape
    H = G // _GATES[cell]
    whf = wh.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    keep_all = m.to(torch.float32)
    hs, cs = [], []
    for t in range(T):
        xw_t = xw[:, t].float()
        keep = keep_all[:, t, None]
        if cell == "lstm":
            i, f, g, o = _lstm_gates(xw_t + h @ whf, forget_bias)
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            h = keep * h_new + (1.0 - keep) * h
            c = keep * c_new + (1.0 - keep) * c
            cs.append(c)
        else:
            z, r, n, _ = _gru_parts(xw_t, h @ whf)
            h_new = (1.0 - z) * n + z * h
            h = keep * h_new + (1.0 - keep) * h
        hs.append(h)
    h_all = torch.stack(hs, dim=1).to(xw.dtype)
    c_all = (torch.stack(cs, dim=1).to(xw.dtype)
             if cell == "lstm" and with_c else None)
    return h_all, c_all


def rnn_scan_reference(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                       m: torch.Tensor, forget_bias: float = 1.0
                       ) -> torch.Tensor:
    """The masked recurrence over a hoisted projection ``xw [B, T, G*H]``
    with an f32 carry: the JAX package's ``rnn_scan_reference`` and the
    plain version of :func:`rnn_scan`. Returns ``[B, T, H]`` in
    ``xw.dtype``. Differentiable by autograd."""
    return rnn_scan_states(cell, xw, wh, m, forget_bias, with_c=False)[0]


def rnn_scan_fused_reference(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                             b: torch.Tensor, wh: torch.Tensor,
                             m: torch.Tensor, forget_bias: float = 1.0
                             ) -> torch.Tensor:
    """Plain version of :func:`rnn_scan_fused`: the reference recurrence
    fed ``hin @ wx + b`` computed in f32, as the JAX tests hold the fused
    kernel. Returns ``[B, T, H]`` in ``hin.dtype``."""
    xw = hin.float() @ wx.float() + b.float()
    return rnn_scan_reference(cell, xw, wh, m, forget_bias).to(hin.dtype)


def _scan_bwd_core(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                   m: torch.Tensor, h_all: torch.Tensor,
                   c_all: Optional[torch.Tensor], dh: torch.Tensor,
                   forget_bias: float):
    """The TPU backward kernels' reverse-time formulas in plain torch.

    ``xw [B, T, G*H]`` f32 x-side gate inputs; ``h_all``/``c_all`` the
    saved states. Returns ``(d_xw, d_hw, h_prev)``: the gate gradients of
    the x side and the h side ``[B, T, G*H]`` f32 (equal for the LSTM; the
    GRU's n slices differ) and ``h_prev [B, T, H]`` f32 (zero at t = 0).
    """
    B, T, G = xw.shape
    H = G // _GATES[cell]
    whf = wh.float()
    keep_all = m.to(torch.float32)
    zero = torch.zeros((B, 1, H), dtype=torch.float32, device=xw.device)
    h_prev = torch.cat([zero, h_all[:, :-1].float()], dim=1)
    # The recomputed h-side products; h_{t-1} rounded to W_h's type first.
    hw_all = h_prev.to(wh.dtype).float() @ whf
    d_xw = torch.empty((B, T, G), dtype=torch.float32, device=xw.device)
    d_hw = d_xw if cell == "lstm" else torch.empty_like(d_xw)
    dh_c = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    dc_c = torch.zeros_like(dh_c)
    for t in reversed(range(T)):
        keep = keep_all[:, t, None]
        dh_t = dh[:, t].float() + dh_c
        dh_new = keep * dh_t
        if cell == "lstm":
            i, f, g, o = _lstm_gates(xw[:, t] + hw_all[:, t], forget_bias)
            c_prev = (c_all[:, t - 1].float() if t > 0
                      else torch.zeros_like(dh_c))
            # The masked c_t stands in for c_new: every term that uses it
            # carries the mask.
            tc = torch.tanh(c_all[:, t].float())
            dc_t = dc_c
            dc_new = keep * dc_t
            do = dh_new * tc
            dc_tot = dc_new + dh_new * o * (1.0 - tc * tc)
            d_gates = torch.cat([
                dc_tot * g * i * (1.0 - i),
                dc_tot * c_prev * f * (1.0 - f),
                dc_tot * i * (1.0 - g * g),
                do * o * (1.0 - o),
            ], dim=-1)
            d_xw[:, t] = d_gates
            dh_c = (1.0 - keep) * dh_t + d_gates @ whf.T
            dc_c = (1.0 - keep) * dc_t + dc_tot * f
        else:
            z, r, n, hn = _gru_parts(xw[:, t], hw_all[:, t])
            dz = dh_new * (h_prev[:, t] - n)
            dn_raw = dh_new * (1.0 - z) * (1.0 - n * n)
            dr = dn_raw * hn
            d_hz = dz * z * (1.0 - z)
            d_hr = dr * r * (1.0 - r)
            d_hw[:, t] = torch.cat([d_hz, d_hr, dn_raw * r], dim=-1)
            # The candidate's x side skips the reset gate.
            d_xw[:, t] = torch.cat([d_hz, d_hr, dn_raw], dim=-1)
            dh_c = ((1.0 - keep) * dh_t + dh_new * z
                    + d_hw[:, t] @ whf.T)
    return d_xw, d_hw, h_prev


def _contract(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``sum_{b,t} a[b,t]^T d[b,t]`` → ``[a.shape[-1], d.shape[-1]]``."""
    return a.reshape(-1, a.shape[-1]).T @ d.reshape(-1, d.shape[-1])


def rnn_scan_bwd_reference(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                           m: torch.Tensor, h_all: torch.Tensor,
                           c_all: Optional[torch.Tensor], dh: torch.Tensor,
                           forget_bias: float = 1.0):
    """Plain version of :func:`rnn_scan_bwd`: ``(dxw in xw.dtype,
    dW_h f32)``."""
    d_xw, d_hw, h_prev = _scan_bwd_core(cell, xw.float(), wh, m, h_all,
                                        c_all, dh, forget_bias)
    return d_xw.to(xw.dtype), _contract(h_prev, d_hw)


def rnn_scan_fused_bwd_reference(cell: str, hin: torch.Tensor,
                                 wx: torch.Tensor, b: torch.Tensor,
                                 wh: torch.Tensor, m: torch.Tensor,
                                 h_all: torch.Tensor,
                                 c_all: Optional[torch.Tensor],
                                 dh: torch.Tensor, forget_bias: float = 1.0):
    """Plain version of :func:`rnn_scan_fused_bwd`: ``(dhin in hin.dtype,
    dW_x, db, dW_h f32)``."""
    xw = hin.float() @ wx.float() + b.float()
    d_xw, d_hw, h_prev = _scan_bwd_core(cell, xw, wh, m, h_all, c_all, dh,
                                        forget_bias)
    dhin = (d_xw @ wx.float().T).to(hin.dtype)
    return (dhin, _contract(hin.float(), d_xw), d_xw.sum(dim=(0, 1)),
            _contract(h_prev, d_hw))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_shapes(cell: str, B: int, T: int, H: int, m: torch.Tensor,
                  wh: torch.Tensor, wx=None, b=None) -> None:
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {sorted(_GATES)}")
    G = _GATES[cell] * H
    bad = tuple(wh.shape) != (H, G) or tuple(m.shape) != (B, T)
    if wx is not None:
        bad = bad or tuple(wx.shape) != (H, G) or tuple(b.shape) != (G,)
    if bad:
        raise ValueError(
            f"expected wx/wh [{H},{G}], b [{G}], m [{B},{T}]; got "
            f"{None if wx is None else tuple(wx.shape)}/{tuple(wh.shape)}/"
            f"{None if b is None else tuple(b.shape)}/{tuple(m.shape)}")


def _check_states(cell: str, B: int, T: int, H: int, h_all, c_all,
                  dh) -> None:
    """The saved states and the upstream gradient a backward takes."""
    if cell == "lstm" and c_all is None:
        raise ValueError("the LSTM backward needs the saved c_all")
    for name, t in (("h_all", h_all), ("c_all", c_all), ("dh", dh)):
        if t is not None and tuple(t.shape) != (B, T, H):
            raise ValueError(f"{name} must be [{B},{T},{H}], got "
                             f"{tuple(t.shape)}")


def _check_card(ref: torch.Tensor, **tensors) -> None:
    """The kernels take contiguous tensors of one dtype on ``ref``'s card."""
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    for name, t in (("input", ref), *tensors.items()):
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
        if name != "m" and (t.dtype != ref.dtype or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be contiguous {ref.dtype}, got "
                f"{t.dtype} (contiguous={t.is_contiguous()})")
    _build.dtype_code(ref.dtype)


def _smem_check(smem: int, device: torch.device, H: int) -> None:
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"hidden={H} needs {smem} bytes of shared memory per block, "
            f"more than the card's {limit}")


def _launch_fwd(cell: str, hoist: bool, xin: torch.Tensor, wx, b,
                wh: torch.Tensor, m: torch.Tensor, forget_bias: float,
                save_c: bool):
    """One forward launch → ``(h_all, c_all or None)``."""
    B, T = m.shape
    H = wh.shape[0]
    h = torch.empty((B, T, H), dtype=xin.dtype, device=xin.device)
    c = torch.empty_like(h) if save_c and cell == "lstm" else None
    lib = _build.library()
    _smem_check(lib.lfm_rnn_fwd_smem(_CELL_CODE[cell], int(hoist), H),
                xin.device, H)
    keep = m.to(torch.uint8).contiguous()
    code = _build.dtype_code(xin.dtype)
    c_ptr = None if c is None else c.data_ptr()
    with torch.cuda.device(xin.device):
        if hoist:
            err = lib.lfm_rnn_scan_fwd(
                _CELL_CODE[cell], code, xin.data_ptr(), wh.data_ptr(),
                keep.data_ptr(), h.data_ptr(), c_ptr, B, T, H,
                float(forget_bias), _build.stream_of(xin))
        else:
            err = lib.lfm_rnn_fused_fwd(
                _CELL_CODE[cell], code, xin.data_ptr(), wx.data_ptr(),
                b.data_ptr(), wh.data_ptr(), keep.data_ptr(), h.data_ptr(),
                c_ptr, B, T, H, float(forget_bias), _build.stream_of(xin))
    name = f"rnn_{'' if hoist else 'fused_'}fwd_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    return h, c


def _slices(rows: int) -> int:
    """Row slices of the weight-gradient reduction: enough blocks (one
    128 x 128 output tile per slice) to keep several in flight on every
    SM, and a fixed function of the shape, so the sums' order is too."""
    return max(1, min(128, rows // 512))


def _launch_bwd(cell: str, fused: bool, xin: torch.Tensor, wx, b,
                wh: torch.Tensor, m: torch.Tensor, h_all: torch.Tensor,
                c_all: Optional[torch.Tensor], dh: torch.Tensor,
                forget_bias: float):
    """One backward call (four kernel launches, counted once) →
    fused: ``(dhin, dW_x, db, dW_h)``; hoisted: ``(dxw, dW_h)``; the
    weight gradients in f32."""
    B, T = m.shape
    H = wh.shape[0]
    G = _GATES[cell] * H
    dev = xin.device
    f32 = torch.float32
    lib = _build.library()
    _smem_check(lib.lfm_rnn_bwd_smem(_CELL_CODE[cell], int(fused), H),
                dev, H)
    keep = m.to(torch.uint8).contiguous()
    # W^T in f32 (64K values each): the backward products read it by rows.
    whT = wh.float().t().contiguous()
    dgx = torch.empty((B, T, G), dtype=f32, device=dev)
    dhn = (torch.empty((B, T, H), dtype=f32, device=dev) if cell == "gru"
           else None)
    S = _slices(B * T)
    total = 2 * H * G + G if fused else H * G
    partial = torch.empty((S, total), dtype=f32, device=dev)
    dw = torch.empty((total,), dtype=f32, device=dev)
    code = _build.dtype_code(xin.dtype)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        if fused:
            wxT = wx.float().t().contiguous()
            dx = torch.empty_like(xin)
            err = lib.lfm_rnn_fused_bwd(
                _CELL_CODE[cell], code, xin.data_ptr(), wx.data_ptr(),
                b.data_ptr(), wh.data_ptr(), wxT.data_ptr(), whT.data_ptr(),
                keep.data_ptr(), h_all.data_ptr(), ptr(c_all), dh.data_ptr(),
                dx.data_ptr(), dgx.data_ptr(), ptr(dhn), partial.data_ptr(),
                S, dw.data_ptr(), B, T, H, float(forget_bias),
                _build.stream_of(xin))
        else:
            # In float32 the f32 gate gradients are dxw itself.
            dx = None if xin.dtype == f32 else torch.empty_like(xin)
            err = lib.lfm_rnn_scan_bwd(
                _CELL_CODE[cell], code, xin.data_ptr(), wh.data_ptr(),
                whT.data_ptr(), keep.data_ptr(), h_all.data_ptr(),
                ptr(c_all), dh.data_ptr(), ptr(dx), dgx.data_ptr(),
                ptr(dhn), partial.data_ptr(), S, dw.data_ptr(), B, T, H,
                float(forget_bias), _build.stream_of(xin))
    name = f"rnn_{'fused_' if fused else ''}bwd_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    if not fused:
        return (dgx if dx is None else dx), dw.view(H, G)
    hg = H * G
    return (dx, dw[:hg].view(H, G), dw[hg:hg + G],
            dw[hg + G:].view(H, G))


def _mma_route(dtype: torch.dtype, H: int) -> str:
    """Which kernels run the fused forward and the fused backward on the
    card: ``"mma"`` (``csrc/rnn_fused_fwd_mma.cu`` and
    ``csrc/rnn_fused_bwd_mma.cu``, bf16 tensor cores, W_h resident in
    shared memory, so 16 <= H <= 128 and H % 16 == 0) or ``"simt"``
    (``csrc/rnn_fused_fwd.cu`` and ``csrc/rnn_bwd.cu``, f32 on the CUDA
    cores: float32, which must hold the JAX f32 bound, and every other
    H). One rule for both directions: the backward reuses the forward's
    packing of W_x."""
    if dtype == torch.bfloat16 and H % 16 == 0 and 16 <= H <= 128:
        return "mma"
    return "simt"


#: Hidden units per warp of the tensor-core forward (``kUnits`` in
#: ``csrc/rnn_fused_fwd_mma.cu``), and the rows per block it is built for.
MMA_UNITS = 8
MMA_ROWS = (16, 32, 64)


@functools.lru_cache(maxsize=16)
def _fragment_index(H: int, cols: int, device=None,
                    transpose: bool = False) -> torch.Tensor:
    """Flat indices into ``w [H, cols]`` (``cols = G * H``) of the mma
    kernel's packed weight, laid out ``[H/16 k-steps][H/8 warps][G n8
    tiles][32 lanes][4]``.

    Warp w owns the :data:`MMA_UNITS` hidden units from ``u0 = 8 w`` with
    all G gates; its tile q covers columns ``q * H + u0 .. + 7``. Lane
    ``l`` holds the m16n8k16 B fragment ``W[k0 + 2 (l % 4) + {0, 1, 8,
    9}][col0 + l // 4]`` (PTX ISA, mma m16n8k16 B layout), so its four
    values of one tile are one 8-byte load and a warp's 32 lanes read 256
    contiguous bytes.

    ``transpose``: the packing of ``W^T [cols, H]`` for the backward's
    ``d_xw @ W_x^T`` (``csrc/rnn_fused_bwd_mma.cu``), laid out ``[cols/16
    k-steps][H/8 warps][32 lanes][4]``: warp s owns output units ``8 s ..
    8 s + 7`` and lane l holds ``W^T[k0 + 2 (l % 4) + {0, 1, 8, 9}][8 s +
    l // 4]``, that is ``w[8 s + l // 4][k0 + ...]``."""
    if transpose:
        KB, S = cols // 16, H // MMA_UNITS
        ks = torch.arange(KB, device=device).view(KB, 1, 1, 1)
        s = torch.arange(S, device=device).view(1, S, 1, 1)
        lane = torch.arange(32, device=device).view(1, 1, 32, 1)
        v = torch.arange(4, device=device).view(1, 1, 1, 4)
        k = ks * 16 + 2 * (lane % 4) + v % 2 + 8 * (v // 2)
        return ((s * MMA_UNITS + lane // 4) * cols + k).reshape(-1)
    KT, S, NT = H // 16, H // MMA_UNITS, cols // H
    kk = torch.arange(KT, device=device).view(KT, 1, 1, 1, 1)
    s = torch.arange(S, device=device).view(1, S, 1, 1, 1)
    q = torch.arange(NT, device=device).view(1, 1, NT, 1, 1)
    lane = torch.arange(32, device=device).view(1, 1, 1, 32, 1)
    v = torch.arange(4, device=device).view(1, 1, 1, 1, 4)
    k = kk * 16 + 2 * (lane % 4) + v % 2 + 8 * (v // 2)
    col = q * H + s * MMA_UNITS + lane // 4
    return (k * cols + col).reshape(-1)


def pack_fragments(w: torch.Tensor, transpose: bool = False
                   ) -> torch.Tensor:
    """``w [H, G*H]`` → the mma kernels' fragment order of ``w`` (or,
    with ``transpose``, of ``w^T``); flat, same dtype, a new tensor. See
    :func:`_fragment_index`."""
    H, cols = w.shape
    return w.reshape(-1)[_fragment_index(H, cols, w.device, transpose)]


def unpack_fragments(packed: torch.Tensor, H: int, cols: int,
                     transpose: bool = False) -> torch.Tensor:
    """Inverse of :func:`pack_fragments` → ``[H, cols]``."""
    w = torch.empty(H * cols, dtype=packed.dtype, device=packed.device)
    w[_fragment_index(H, cols, packed.device, transpose)] = packed
    return w.view(H, cols)


def _mma_rows(B: int, sms: int) -> int:
    """Rows per block of the tensor-core forward, from B alone: the most
    (64, 32, then 16: the fewer W_x reads and barriers per row) that
    still give at least half the SMs a block. Measured on an H100 with
    ``chip_smoke.py`` and ``scripts/torch_mma_variants.py`` (PERF.md,
    port PR 4)."""
    for rows in (64, 32):
        if 2 * -(-B // rows) >= sms:
            return rows
    return 16


def _launch_fwd_mma(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                    b: torch.Tensor, wh: torch.Tensor, m: torch.Tensor,
                    forget_bias: float, save_c: bool,
                    rows: Optional[int] = None, packed=None):
    """One launch of the tensor-core fused forward → ``(h_all, c_all or
    None)``. ``rows`` (per block, one of :data:`MMA_ROWS`) overrides the
    choice from B; ``packed`` is ``(pack_fragments(wx),
    pack_fragments(wh))`` when the caller has it."""
    B, T = m.shape
    H = wh.shape[0]
    dev = hin.device
    if rows is None:
        rows = _mma_rows(
            B, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _build.library()
    smem = lib.lfm_rnn_fused_fwd_mma_smem(_CELL_CODE[cell], H, rows)
    if smem < 0:
        raise ValueError(f"the mma forward does not take H={H} with {rows} "
                         f"rows per block")
    _smem_check(smem, dev, H)
    # Fresh tensors: 16-byte aligned for the kernel's cp.async and stores.
    wxp, whp = packed or (pack_fragments(wx), pack_fragments(wh))
    hin = _aligned16(hin)
    h = torch.empty((B, T, H), dtype=hin.dtype, device=dev)
    c = torch.empty_like(h) if save_c and cell == "lstm" else None
    keep = m.to(torch.uint8).contiguous()
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_fused_fwd_mma(
            _CELL_CODE[cell], hin.data_ptr(), wxp.data_ptr(), b.data_ptr(),
            whp.data_ptr(), keep.data_ptr(), h.data_ptr(),
            None if c is None else c.data_ptr(), B, T, H, rows,
            float(forget_bias), _build.stream_of(hin))
    name = f"rnn_fused_fwd_mma_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    return h, c


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it starting on a 16-byte boundary (the mma
    kernels' cp.async and vector loads)."""
    return t.clone() if t.data_ptr() % 16 else t


def _launch_bwd_mma(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                    b: torch.Tensor, wh: torch.Tensor, m: torch.Tensor,
                    h_all: torch.Tensor, c_all: Optional[torch.Tensor],
                    dh: torch.Tensor, forget_bias: float,
                    wxp: Optional[torch.Tensor] = None):
    """One call of the tensor-core fused backward (three kernel
    launches, counted once) → ``(dhin, dW_x, db, dW_h)``, the weight
    gradients in f32. ``wxp`` is ``pack_fragments(wx)`` when the forward
    already built it; W_h goes in as it is (row-major, copied once into
    shared memory)."""
    B, T = m.shape
    H = wh.shape[0]
    G = _GATES[cell] * H
    dev = hin.device
    f32 = torch.float32
    lib = _build.library()
    smem = lib.lfm_rnn_fused_bwd_mma_smem(_CELL_CODE[cell], H)
    if smem < 0:
        raise ValueError(f"the mma backward does not take H={H}")
    _smem_check(smem, dev, H)
    if wxp is None:
        wxp = pack_fragments(wx)
    wxtp = pack_fragments(wx, transpose=True)
    hin, wh, h_all, c_all, dh = (None if t is None else _aligned16(t)
                                 for t in (hin, wh, h_all, c_all, dh))
    keep = m.to(torch.uint8).contiguous()
    dgx = torch.empty((B, T, G), dtype=f32, device=dev)
    dhn = (torch.empty((B, T, H), dtype=f32, device=dev) if cell == "gru"
           else None)
    S = _slices(B * T)
    total = 2 * H * G + G
    partial = torch.empty((S, total), dtype=f32, device=dev)
    dw = torch.empty((total,), dtype=f32, device=dev)
    dx = torch.empty_like(hin)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_fused_bwd_mma(
            _CELL_CODE[cell], hin.data_ptr(), wxp.data_ptr(),
            wxtp.data_ptr(), b.data_ptr(), wh.data_ptr(), keep.data_ptr(),
            h_all.data_ptr(), ptr(c_all), dh.data_ptr(), dx.data_ptr(),
            dgx.data_ptr(), ptr(dhn), partial.data_ptr(), S, dw.data_ptr(),
            B, T, H, float(forget_bias), _build.stream_of(hin))
    name = f"rnn_fused_bwd_mma_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    hg = H * G
    return (dx, dw[:hg].view(H, G), dw[hg:hg + G],
            dw[hg + G:].view(H, G))


def _fused_states(cell, hin, wx, b, wh, m, forget_bias, save_c,
                  packed=None):
    if hin.device.type == "cpu":
        xw = hin.float() @ wx.float() + b.float()
        h, c = rnn_scan_states(cell, xw, wh, m, forget_bias, save_c)
        return h.to(hin.dtype), (None if c is None else c.to(hin.dtype))
    _check_card(hin, wx=wx, b=b, wh=wh, m=m)
    if _mma_route(hin.dtype, wh.shape[0]) == "mma":
        return _launch_fwd_mma(cell, hin, wx, b, wh, m, forget_bias, save_c,
                               packed=packed)
    return _launch_fwd(cell, False, hin, wx, b, wh, m, forget_bias, save_c)


def _scan_states_any(cell, xw, wh, m, forget_bias, save_c):
    if xw.device.type == "cpu":
        return rnn_scan_states(cell, xw, wh, m, forget_bias, save_c)
    _check_card(xw, wh=wh, m=m)
    return _launch_fwd(cell, True, xw, None, None, wh, m, forget_bias,
                       save_c)


def rnn_scan_fused_bwd(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                       b: torch.Tensor, wh: torch.Tensor, m: torch.Tensor,
                       h_all: torch.Tensor, c_all: Optional[torch.Tensor],
                       dh: torch.Tensor, forget_bias: float = 1.0,
                       wxp: Optional[torch.Tensor] = None):
    """Backward of :func:`rnn_scan_fused` from its saved states →
    ``(dhin in hin.dtype, dW_x, db, dW_h in f32)``. ``dh`` is the upstream
    gradient of ``h_all``, in ``hin.dtype``. ``wxp``: ``pack_fragments
    (wx)`` when the forward built it (the tensor-core route reuses it)."""
    B, T, H = hin.shape
    _check_shapes(cell, B, T, H, m, wh, wx, b)
    _check_states(cell, B, T, H, h_all, c_all, dh)
    if hin.device.type == "cpu":
        return rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m, h_all,
                                            c_all, dh, forget_bias)
    _check_card(hin, wx=wx, b=b, wh=wh, m=m, h_all=h_all, c_all=c_all,
                dh=dh)
    if _mma_route(hin.dtype, H) == "mma":
        return _launch_bwd_mma(cell, hin, wx, b, wh, m, h_all, c_all, dh,
                               forget_bias, wxp)
    return _launch_bwd(cell, True, hin, wx, b, wh, m, h_all, c_all, dh,
                       forget_bias)


def rnn_scan_bwd(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                 m: torch.Tensor, h_all: torch.Tensor,
                 c_all: Optional[torch.Tensor], dh: torch.Tensor,
                 forget_bias: float = 1.0):
    """Backward of :func:`rnn_scan` from its saved states → ``(dxw in
    xw.dtype, dW_h in f32)``."""
    B, T, G = xw.shape
    H = G // _GATES.get(cell, 1)
    _check_shapes(cell, B, T, H, m, wh)
    _check_states(cell, B, T, H, h_all, c_all, dh)
    if xw.device.type == "cpu":
        return rnn_scan_bwd_reference(cell, xw, wh, m, h_all, c_all, dh,
                                      forget_bias)
    _check_card(xw, wh=wh, m=m, h_all=h_all, c_all=c_all, dh=dh)
    return _launch_bwd(cell, False, xw, None, None, wh, m, h_all, c_all, dh,
                       forget_bias)


# ---------------------------------------------------------------------------
# Public, differentiable ops
# ---------------------------------------------------------------------------


class _FusedScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cell, forget_bias, hin, wx, b, wh, m):
        # The tensor-core kernels read W_x in fragment order: packed once
        # here, for the forward and the backward's recompute.
        packed = None
        if hin.device.type == "cuda" and _mma_route(
                hin.dtype, wh.shape[0]) == "mma":
            packed = (pack_fragments(wx), pack_fragments(wh))
        h, c = _fused_states(cell, hin, wx, b, wh, m, forget_bias, True,
                             packed)
        ctx.cell, ctx.forget_bias = cell, forget_bias
        ctx.wxp = None if packed is None else packed[0]
        ctx.save_for_backward(hin, wx, b, wh, m, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        hin, wx, b, wh, m, h, c = ctx.saved_tensors
        dhin, dwx, db, dwh = rnn_scan_fused_bwd(
            ctx.cell, hin, wx, b, wh, m, h, c,
            dh.to(hin.dtype).contiguous(), ctx.forget_bias, ctx.wxp)
        # The weight gradients leave in the operands' types (f32 sums).
        return (None, None, dhin, dwx.to(wx.dtype), db.to(b.dtype),
                dwh.to(wh.dtype), None)


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cell, forget_bias, xw, wh, m):
        h, c = _scan_states_any(cell, xw, wh, m, forget_bias, True)
        ctx.cell, ctx.forget_bias = cell, forget_bias
        ctx.save_for_backward(xw, wh, m, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xw, wh, m, h, c = ctx.saved_tensors
        dxw, dwh = rnn_scan_bwd(ctx.cell, xw, wh, m, h, c,
                                dh.to(xw.dtype).contiguous(),
                                ctx.forget_bias)
        return None, None, dxw, dwh.to(wh.dtype), None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rnn_scan_fused(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                   b: torch.Tensor, wh: torch.Tensor, m: torch.Tensor,
                   forget_bias: float = 1.0) -> torch.Tensor:
    """Fused masked recurrence with the gate input projection computed
    inside the kernel; differentiable.

    Args:
      cell: "lstm" | "gru".
      hin: ``[B, T, H]`` layer input.
      wx: ``[H, G*H]`` gate input-projection weights.
      b: ``[G*H]`` gate bias.
      wh: ``[H, G*H]`` recurrent gate weights.
      m: ``[B, T]`` step validity (bool or 0/1); invalid steps hold state.

    Returns ``[B, T, H]`` hidden states in ``hin.dtype``. Tensors on the
    card launch the kernels, which take ``hin``, ``wx``, ``b`` and ``wh``
    contiguous in one dtype (float32 or bfloat16).
    """
    if hin.dim() != 3:
        raise ValueError(f"hin must be [B, T, H], got {tuple(hin.shape)}")
    B, T, H = hin.shape
    _check_shapes(cell, B, T, H, m, wh, wx, b)
    if _wants_grad(hin, wx, b, wh):
        return _FusedScan.apply(cell, float(forget_bias), hin, wx, b, wh, m)
    if hin.numel() == 0:
        return torch.empty_like(hin)
    return _fused_states(cell, hin, wx, b, wh, m, forget_bias, False)[0]


def rnn_scan(cell: str, xw: torch.Tensor, wh: torch.Tensor, m: torch.Tensor,
             forget_bias: float = 1.0) -> torch.Tensor:
    """Masked recurrence over a hoisted gate projection ``xw [B, T, G*H]``
    (``x @ W_x + b`` for all gates); differentiable. ``wh [H, G*H]``,
    ``m [B, T]``. Returns ``[B, T, H]`` in ``xw.dtype``; on the card
    ``xw`` and ``wh`` are contiguous in one dtype."""
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {sorted(_GATES)}")
    if xw.dim() != 3 or xw.shape[-1] % _GATES[cell]:
        raise ValueError(
            f"xw must be [B, T, {_GATES[cell]}*H], got {tuple(xw.shape)}")
    B, T, G = xw.shape
    _check_shapes(cell, B, T, G // _GATES[cell], m, wh)
    if _wants_grad(xw, wh):
        return _Scan.apply(cell, float(forget_bias), xw, wh, m)
    if xw.numel() == 0:
        return xw.new_empty((B, T, G // _GATES[cell]))
    return _scan_states_any(cell, xw, wh, m, forget_bias, False)[0]
