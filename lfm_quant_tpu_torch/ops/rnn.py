"""The masked LSTM/GRU recurrence: hand-written CUDA kernels
(``csrc/rnn_fused_fwd.cu``, ``csrc/rnn_fused_fwd_mma.cu``,
``csrc/rnn_bwd.cu``, ``csrc/rnn_fused_bwd_mma.cu``) and their plain
versions.

The fused forward and both backwards each have two kernels, picked by one
rule, :func:`_mma_route`, from the dtype and H alone: bf16 with 16 <= H
<= 128, H % 16 == 0 runs on the tensor cores (``rnn_fused_fwd_mma.cu``;
``rnn_fused_bwd_mma.cu``, fused and hoisted modes); float32 and every
other H on the CUDA cores (``rnn_fused_fwd.cu``, ``rnn_bwd.cu``). The
hoisted forward runs on ``rnn_fused_fwd.cu`` at every dtype and H.

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

The seed axis (the seed ensemble; the JAX kernels' ``custom_vmap`` rules,
``pallas_rnn.py _fwd_vmap`` :919 and ``_bwd_vmap`` :951) is a leading
dimension written out: ``rnn_scan_fused`` also takes ``hin [S, B, T, H]``,
``wx``/``wh [S, H, G*H]``, ``b [S, G*H]`` and ``m [S, B, T]``, where any
operand may have seed extent 1 and is then shared by every seed (JAX's
``_seed_extent``). The tensor-core kernels run all seeds in one launch,
each operand at its own seed stride (0 when shared); the CUDA-core
kernels launch once per seed, as does the hoisted ``rnn_scan``; the plain
versions run the one-seed plain op per seed. A shared operand's gradient
is the sum of the seeds' gradients.
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


def _seed_extent(*tensors) -> int:
    """Common seed extent of leading axes that are each S or 1 (1: shared
    by every seed); ``None`` entries are skipped."""
    S = 1
    for t in tensors:
        if t is None or t.shape[0] in (1, S):
            continue
        if S != 1:
            raise ValueError(f"seed extents disagree ({t.shape[0]} vs {S})")
        S = t.shape[0]
    return S


def _seed(t: Optional[torch.Tensor], s: int) -> Optional[torch.Tensor]:
    """Seed ``s`` of a seed-stacked operand (seed 0 when it is shared)."""
    return None if t is None else t[s if t.shape[0] > 1 else 0]


def _over_seeds(fn, S: int, *tensors):
    """``fn`` on each seed's operands, its outputs stacked on a new leading
    seed axis (an output that is None stays None)."""
    outs = [fn(*(_seed(t, s) for t in tensors)) for s in range(S)]
    if not isinstance(outs[0], tuple):
        return torch.stack(outs)
    return tuple(None if o[0] is None else torch.stack(o)
                 for o in zip(*outs))


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
    kernel. Returns ``[B, T, H]`` in ``hin.dtype``; seed-stacked operands
    give ``[S, B, T, H]``, one seed at a time."""
    if hin.dim() == 4:
        return _over_seeds(
            lambda *a: rnn_scan_fused_reference(cell, *a, forget_bias),
            _check_stacked(cell, hin, wx, b, wh, m), hin, wx, b, wh, m)
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
    dW_x, db, dW_h f32)``; seed-stacked operands give each per seed, one
    seed at a time."""
    if hin.dim() == 4:
        S = _check_stacked(cell, hin, wx, b, wh, m, h_all, c_all, dh)
        return _over_seeds(
            lambda *a: rnn_scan_fused_bwd_reference(cell, *a, forget_bias),
            S, hin, wx, b, wh, m, h_all, c_all, dh)
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


def _check_stacked(cell: str, hin, wx, b, wh, m, h_all=None, c_all=None,
                   dh=None) -> int:
    """Shapes of seed-stacked fused operands → the seed extent S: hin [., B,
    T, H], wx/wh [., H, G*H], b [., G*H], m [., B, T] and the states
    [., B, T, H], each leading extent S or 1."""
    if hin.dim() != 4:
        raise ValueError(f"hin must be [S, B, T, H], got {tuple(hin.shape)}")
    _, B, T, H = hin.shape
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {sorted(_GATES)}")
    G = _GATES[cell] * H
    want = {"wx": (wx, (H, G)), "b": (b, (G,)), "wh": (wh, (H, G)),
            "m": (m, (B, T)), "h_all": (h_all, (B, T, H)),
            "c_all": (c_all, (B, T, H)), "dh": (dh, (B, T, H))}
    for name, (t, tail) in want.items():
        if t is not None and (t.dim() != len(tail) + 1
                              or tuple(t.shape[1:]) != tail):
            raise ValueError(f"{name} must be [S, {', '.join(map(str, tail))}]"
                             f", got {tuple(t.shape)}")
    return _seed_extent(hin, wx, b, wh, m, h_all, c_all, dh)


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
    """Which kernels run the fused forward and the fused and hoisted
    backwards on the card: ``"mma"`` (``csrc/rnn_fused_fwd_mma.cu`` and
    ``csrc/rnn_fused_bwd_mma.cu``, bf16 tensor cores, W_h resident in
    shared memory, so 16 <= H <= 128 and H % 16 == 0) or ``"simt"``
    (``csrc/rnn_fused_fwd.cu`` and ``csrc/rnn_bwd.cu``, f32 on the CUDA
    cores: float32, which must hold the JAX f32 bound, and every other
    H). One rule for both directions: the fused backward reuses the
    forward's packing of W_x."""
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
    :func:`_fragment_index`. A seed-stacked ``w [S, H, G*H]`` is packed
    per seed → ``[S, H*G*H]``."""
    H, cols = w.shape[-2:]
    idx = _fragment_index(H, cols, w.device, transpose)
    if w.dim() == 3:
        return w.reshape(w.shape[0], -1)[:, idx]
    return w.reshape(-1)[idx]


def unpack_fragments(packed: torch.Tensor, H: int, cols: int,
                     transpose: bool = False) -> torch.Tensor:
    """Inverse of :func:`pack_fragments` → ``[H, cols]``."""
    w = torch.empty(H * cols, dtype=packed.dtype, device=packed.device)
    w[_fragment_index(H, cols, packed.device, transpose)] = packed
    return w.view(H, cols)


def _mma_rows(B: int, sms: int, S: int = 1) -> int:
    """Rows per block of the tensor-core forward, from the block count S *
    ceil(B / rows) of S seeds: the most (64, 32, then 16: the fewer W_x
    reads and barriers per row) that still give at least half the SMs a
    block. Measured on an H100 with ``chip_smoke.py`` and
    ``scripts/torch_mma_variants.py`` (PERF.md §6)."""
    for rows in (64, 32):
        if 2 * S * -(-B // rows) >= sms:
            return rows
    return 16


def _stride(t: torch.Tensor, S: int) -> int:
    """A seed-stacked operand's seed stride in elements: 0 when shared."""
    return t[0].numel() if S > 1 and t.shape[0] > 1 else 0


def _launch_fwd_mma(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                    b: torch.Tensor, wh: torch.Tensor, m: torch.Tensor,
                    forget_bias: float, save_c: bool,
                    rows: Optional[int] = None, packed=None):
    """One launch of the tensor-core fused forward → ``(h_all, c_all or
    None)``. Seed-stacked operands (``hin`` 4-D, see :func:`_check_stacked`)
    run every seed in the same launch, counted once, → ``[S, B, T, H]``.
    ``rows`` (per block, one of :data:`MMA_ROWS`) overrides the choice from
    the block count; ``packed`` is ``(pack_fragments(wx),
    pack_fragments(wh))`` when the caller has it."""
    stacked = hin.dim() == 4
    if not stacked:
        hin, wx, b, wh, m = (t[None] for t in (hin, wx, b, wh, m))
        if packed is not None:
            packed = tuple(p[None] for p in packed)
    S = _seed_extent(hin, wx, b, wh, m)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    dev = hin.device
    if rows is None:
        rows = _mma_rows(
            B, torch.cuda.get_device_properties(dev).multi_processor_count, S)
    lib = _build.library()
    smem = lib.lfm_rnn_fused_fwd_mma_smem(_CELL_CODE[cell], H, rows)
    if smem < 0:
        raise ValueError(f"the mma forward does not take H={H} with {rows} "
                         f"rows per block")
    _smem_check(smem, dev, H)
    # Fresh tensors: 16-byte aligned for the kernel's cp.async and stores.
    wxp, whp = packed or (pack_fragments(wx), pack_fragments(wh))
    hin = _aligned16(hin)
    h = torch.empty((S, B, T, H), dtype=hin.dtype, device=dev)
    c = torch.empty_like(h) if save_c and cell == "lstm" else None
    keep = m.to(torch.uint8).contiguous()
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_fused_fwd_mma(
            _CELL_CODE[cell], hin.data_ptr(), wxp.data_ptr(), b.data_ptr(),
            whp.data_ptr(), keep.data_ptr(), h.data_ptr(),
            None if c is None else c.data_ptr(), S, B, T, H, rows,
            _stride(hin, S), _stride(wxp, S), _stride(b, S), _stride(whp, S),
            _stride(keep, S), float(forget_bias), _build.stream_of(hin))
    name = f"rnn_fused_fwd_mma_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    if not stacked:
        return h[0], (None if c is None else c[0])
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
    gradients in f32. Seed-stacked operands (``hin`` 4-D) run every seed
    in the same call, counted once, and give each gradient per seed
    (``[S, ...]``); the states ``h_all``, ``c_all`` and ``dh`` are per
    seed. ``wxp`` is ``pack_fragments(wx)`` when the forward already
    built it; W_h goes in as it is (row-major, copied once into shared
    memory)."""
    stacked = hin.dim() == 4
    if not stacked:
        hin, wx, b, wh, m, h_all, dh = (
            t[None] for t in (hin, wx, b, wh, m, h_all, dh))
        c_all = None if c_all is None else c_all[None]
        wxp = None if wxp is None else wxp[None]
    S = _seed_extent(hin, wx, b, wh, m, h_all, c_all, dh)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
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
    # The states are per seed: a shared one is copied out to every seed.
    h_all, c_all, dh = (
        None if t is None else t.expand(S, *t.shape[1:]).contiguous()
        for t in (h_all, c_all, dh))
    hin, wh, h_all, c_all, dh = (None if t is None else _aligned16(t)
                                 for t in (hin, wh, h_all, c_all, dh))
    keep = m.to(torch.uint8).contiguous()
    dgx = torch.empty((S, B, T, G), dtype=f32, device=dev)
    dhn = (torch.empty((S, B, T, H), dtype=f32, device=dev)
           if cell == "gru" else None)
    slices = _slices(B * T)
    total = 2 * H * G + G
    partial = torch.empty((S, slices, total), dtype=f32, device=dev)
    dw = torch.empty((S, total), dtype=f32, device=dev)
    dx = torch.empty((S, B, T, H), dtype=hin.dtype, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_fused_bwd_mma(
            _CELL_CODE[cell], hin.data_ptr(), wxp.data_ptr(),
            wxtp.data_ptr(), b.data_ptr(), wh.data_ptr(), keep.data_ptr(),
            h_all.data_ptr(), ptr(c_all), dh.data_ptr(), dx.data_ptr(),
            dgx.data_ptr(), ptr(dhn), partial.data_ptr(), slices,
            dw.data_ptr(), S, B, T, H, _stride(hin, S), _stride(wxp, S),
            _stride(b, S), _stride(wh, S), _stride(keep, S),
            float(forget_bias), _build.stream_of(hin))
    name = f"rnn_fused_bwd_mma_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    hg = H * G
    out = (dx, dw[:, :hg].view(S, H, G), dw[:, hg:hg + G],
           dw[:, hg + G:].view(S, H, G))
    return out if stacked else tuple(t[0] for t in out)


def _launch_scan_bwd_mma(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                         m: torch.Tensor, h_all: torch.Tensor,
                         c_all: Optional[torch.Tensor], dh: torch.Tensor,
                         forget_bias: float):
    """One call of the tensor-core hoisted backward (the hoisted mode of
    ``csrc/rnn_fused_bwd_mma.cu``: three kernel launches, counted once)
    → ``(dxw in xw.dtype, dW_h f32)``. One seed: ``rnn_scan`` runs
    seed-stacked operands one seed at a time."""
    B, T = m.shape
    H = wh.shape[0]
    G = _GATES[cell] * H
    dev = xw.device
    f32 = torch.float32
    lib = _build.library()
    smem = lib.lfm_rnn_scan_bwd_mma_smem(_CELL_CODE[cell], H)
    if smem < 0:
        raise ValueError(f"the mma backward does not take H={H}")
    _smem_check(smem, dev, H)
    xw, wh, h_all, c_all, dh = (None if t is None else _aligned16(t)
                                for t in (xw, wh, h_all, c_all, dh))
    keep = m.to(torch.uint8).contiguous()
    d_hw = torch.empty((B, T, G), dtype=f32, device=dev)
    slices = _slices(B * T)
    partial = torch.empty((slices, H * G), dtype=f32, device=dev)
    dw = torch.empty((H * G,), dtype=f32, device=dev)
    dxw = torch.empty_like(xw)
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_scan_bwd_mma(
            _CELL_CODE[cell], xw.data_ptr(), wh.data_ptr(), keep.data_ptr(),
            h_all.data_ptr(), None if c_all is None else c_all.data_ptr(),
            dh.data_ptr(), dxw.data_ptr(), d_hw.data_ptr(),
            partial.data_ptr(), slices, dw.data_ptr(), 1, B, T, H, 0, 0, 0,
            float(forget_bias), _build.stream_of(xw))
    name = f"rnn_bwd_mma_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    return dxw, dw.view(H, G)


def _fused_states(cell, hin, wx, b, wh, m, forget_bias, save_c,
                  packed=None):
    stacked = hin.dim() == 4
    if hin.device.type == "cpu":
        if stacked:
            return _over_seeds(
                lambda *a: _fused_states(cell, *a, forget_bias, save_c),
                _seed_extent(hin, wx, b, wh, m), hin, wx, b, wh, m)
        xw = hin.float() @ wx.float() + b.float()
        h, c = rnn_scan_states(cell, xw, wh, m, forget_bias, save_c)
        return h.to(hin.dtype), (None if c is None else c.to(hin.dtype))
    _check_card(hin, wx=wx, b=b, wh=wh, m=m)
    if _mma_route(hin.dtype, wh.shape[-2]) == "mma":
        return _launch_fwd_mma(cell, hin, wx, b, wh, m, forget_bias, save_c,
                               packed=packed)
    if stacked:
        # The CUDA-core kernel has no seed grid: one launch per seed.
        return _over_seeds(
            lambda *a: _launch_fwd(cell, False, *a, forget_bias, save_c),
            _seed_extent(hin, wx, b, wh, m), hin, wx, b, wh, m)
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
    (wx)`` when the forward built it (the tensor-core route reuses it).
    Seed-stacked operands give every gradient per seed, ``[S, ...]``."""
    if hin.dim() == 4:
        S = _check_stacked(cell, hin, wx, b, wh, m, h_all, c_all, dh)
        if cell == "lstm" and c_all is None:
            raise ValueError("the LSTM backward needs the saved c_all")
        if hin.device.type == "cpu":
            return rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m,
                                                h_all, c_all, dh, forget_bias)
        _check_card(hin, wx=wx, b=b, wh=wh, m=m, h_all=h_all, c_all=c_all,
                    dh=dh)
        if _mma_route(hin.dtype, hin.shape[-1]) == "mma":
            return _launch_bwd_mma(cell, hin, wx, b, wh, m, h_all, c_all, dh,
                                   forget_bias, wxp)
        # The CUDA-core kernels have no seed grid: one call per seed.
        return _over_seeds(
            lambda *a: _launch_bwd(cell, True, *a, forget_bias), S,
            hin, wx, b, wh, m, h_all, c_all, dh)
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
    xw.dtype, dW_h in f32)``; on the card the kernels of
    :func:`_mma_route`."""
    B, T, G = xw.shape
    H = G // _GATES.get(cell, 1)
    _check_shapes(cell, B, T, H, m, wh)
    _check_states(cell, B, T, H, h_all, c_all, dh)
    if xw.device.type == "cpu":
        return rnn_scan_bwd_reference(cell, xw, wh, m, h_all, c_all, dh,
                                      forget_bias)
    _check_card(xw, wh=wh, m=m, h_all=h_all, c_all=c_all, dh=dh)
    if _mma_route(xw.dtype, H) == "mma":
        return _launch_scan_bwd_mma(cell, xw, wh, m, h_all, c_all, dh,
                                    forget_bias)
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
                hin.dtype, wh.shape[-2]) == "mma":
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
        grads = rnn_scan_fused_bwd(
            ctx.cell, hin, wx, b, wh, m, h, c,
            dh.to(hin.dtype).contiguous(), ctx.forget_bias, ctx.wxp)
        # The weight gradients leave in the operands' types (f32 sums); an
        # operand shared by every seed takes the sum of their gradients.
        out = []
        for g, t in zip(grads, (hin, wx, b, wh)):
            if hin.dim() == 4 and t.shape[0] == 1 and g.shape[0] > 1:
                g = g.sum(dim=0, keepdim=True)
            out.append(g.to(t.dtype))
        return (None, None, *out, None)


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

    Seed-stacked: ``hin [S, B, T, H]``, ``wx``/``wh [S, H, G*H]``, ``b
    [S, G*H]``, ``m [S, B, T]``, each of seed extent S or 1 (shared) →
    ``[S, B, T, H]``, one launch for all seeds on the tensor cores.
    """
    if hin.dim() == 4:
        S = _check_stacked(cell, hin, wx, b, wh, m)
        if _wants_grad(hin, wx, b, wh):
            return _FusedScan.apply(cell, float(forget_bias), hin, wx, b, wh,
                                    m)
        if hin.numel() == 0:
            return hin.new_empty((S,) + hin.shape[1:])
        return _fused_states(cell, hin, wx, b, wh, m, forget_bias, False)[0]
    if hin.dim() != 3:
        raise ValueError(f"hin must be [B, T, H] or [S, B, T, H], got "
                         f"{tuple(hin.shape)}")
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
    ``xw`` and ``wh`` are contiguous in one dtype. Seed-stacked ``xw [S,
    B, T, G*H]``, ``wh [S, H, G*H]``, ``m [S, B, T]`` (each of extent S or
    1) run one seed at a time: one kernel launch per seed on the card."""
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {sorted(_GATES)}")
    if xw.dim() == 4 and wh.dim() == 3 and m.dim() == 3:
        return _over_seeds(
            lambda *a: rnn_scan(cell, *a, forget_bias),
            _seed_extent(xw, wh, m), xw, wh, m)
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
