"""The masked LSTM/GRU recurrence: hand-written CUDA kernels
(``csrc/rnn_fused_fwd.cu``, ``csrc/rnn_fused_fwd_mma.cu``,
``csrc/rnn_fwd_tf32.cu``, ``csrc/rnn_fwd_cluster.cu``, ``csrc/rnn_bwd.cu``,
``csrc/rnn_fused_bwd_mma.cu``, ``csrc/rnn_bwd_tf32.cu``,
``csrc/rnn_bwd_tf32_grid.cu``, ``csrc/rnn_bwd_cluster.cu``,
``csrc/rnn_bwd_grid.cu``, ``csrc/rnn_fwd_grid.cu``) and their plain
versions.

One rule, :func:`_mma_route`, picks the kernels of both forwards and both
backwards from the direction, the dtype and H alone: at every H <= 128
bf16 runs on the tensor cores (``rnn_fused_fwd_mma.cu``, fused and
hoisted modes; ``rnn_fused_bwd_mma.cu``, fused and hoisted modes) and
float32 on them in 3xTF32 (``rnn_fwd_tf32.cu``, whose fused form makes
xw on the CUDA cores, and ``rnn_bwd_tf32.cu``, fused and hoisted forms);
a width that is not a multiple of 16 is zero-padded per gate block to
the next one around the launch (:func:`padded_launch`, exact). Above 128
bf16 runs on the tensor cores with W_h split across a thread-block
cluster, up to H 512, both ways (``rnn_fwd_cluster.cu``: the fused form
as a bf16 GEMM into an f32 xw scratch and the cluster recurrence;
``rnn_bwd_cluster.cu``: the reverse recurrence with a reduce-scatter of
the carry's product, then the weight-gradient and dhin GEMMs). The
float32 backwards above 128 run in 3xTF32 on a cluster of 2-16 CTAs up
to Hp 384 (``rnn_bwd_tf32.cu``, which reduce-scatters the carry's
product as the bf16 one does) and past it, up to Hp 1024, on the whole
card (``rnn_bwd_tf32_grid.cu``: the gates recomputed by one GEMM, the
carry's product over a cooperative grid that holds W_h), and so do the
bf16 backwards past 512, up to Hp 1520, with W_h held in bf16
(``rnn_bwd_grid.cu``), and the bf16 forwards there (``rnn_fwd_grid.cu``:
the fused form's xw by the same GEMM into an f32 scratch that the grid
backward takes, the recurrence on a cooperative grid holding W_h's
columns); the float32 forwards above 128, the bf16 forwards past 1520,
the float32 backwards past 1024 and the bf16 backwards past 1520 run on
the CUDA cores (``rnn_fused_fwd.cu``, ``rnn_bwd.cu``).

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
``pallas_rnn.py _fwd_vmap`` :919 and ``_bwd_vmap`` :951, and the hoisted
scan's ``_make_scan._fwd_vmap`` :504 and ``_bwd_vmap`` :541) is a leading
dimension written out: ``rnn_scan_fused`` also takes ``hin [S, B, T, H]``,
``wx``/``wh [S, H, G*H]``, ``b [S, G*H]`` and ``m [S, B, T]``, and
``rnn_scan`` ``xw [S, B, T, G*H]``, ``wh [S, H, G*H]`` and ``m [S, B,
T]``, where any operand may have seed extent 1 and is then shared by every
seed (JAX's ``_seed_extent``). Every kernel runs all seeds in one launch
(one call for a backward), each operand at its own seed stride (0 when
shared), and a seed's outputs are bitwise those of a one-seed launch; the
plain versions run the one-seed plain op per seed. A shared operand's
gradient is the sum of the seeds' gradients.

Every hidden width runs: the CUDA-core kernels take as many batch rows
per block (16, 8, 4, 2 or 1: :func:`_simt_rows`) as the card's shared
memory holds, and raise only where one row does not fit.
"""

from __future__ import annotations

import ctypes
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
    and when asked): the plain forward of :func:`rnn_scan`. Float64 ``xw``
    gets a float64 carry: the same formulas in float64, the value that
    every float32 computation of them approximates."""
    B, T, G = xw.shape
    H = G // _GATES[cell]
    acc = torch.float64 if xw.dtype == torch.float64 else torch.float32
    whf = wh.to(acc)
    h = torch.zeros((B, H), dtype=acc, device=xw.device)
    c = torch.zeros_like(h)
    keep_all = m.to(acc)
    hs, cs = [], []
    for t in range(T):
        xw_t = xw[:, t].to(acc)
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

    ``xw [B, T, G*H]`` f32 x-side gate inputs (float64: every sum and
    product in float64, :func:`rnn_scan_states`' rule; see
    :func:`_bwd_acc`); ``h_all``/``c_all`` the saved states. Returns
    ``(d_xw, d_hw, h_prev)``: the gate gradients of the x side and the h
    side ``[B, T, G*H]`` f32, float64 for float64 ``xw`` (equal for the
    LSTM; the GRU's n slices differ) and ``h_prev [B, T, H]`` alike (zero
    at t = 0).
    """
    B, T, G = xw.shape
    H = G // _GATES[cell]
    acc = _bwd_acc(xw)
    whf = wh.to(acc)
    keep_all = m.to(acc)
    zero = torch.zeros((B, 1, H), dtype=acc, device=xw.device)
    h_prev = torch.cat([zero, h_all[:, :-1].to(acc)], dim=1)
    # The recomputed h-side products; h_{t-1} rounded to W_h's type first.
    hw_all = h_prev.to(wh.dtype).to(acc) @ whf
    d_xw = torch.empty((B, T, G), dtype=acc, device=xw.device)
    d_hw = d_xw if cell == "lstm" else torch.empty_like(d_xw)
    dh_c = torch.zeros((B, H), dtype=acc, device=xw.device)
    dc_c = torch.zeros_like(dh_c)
    for t in reversed(range(T)):
        keep = keep_all[:, t, None]
        dh_t = dh[:, t].to(acc) + dh_c
        dh_new = keep * dh_t
        if cell == "lstm":
            i, f, g, o = _lstm_gates(xw[:, t] + hw_all[:, t], forget_bias)
            c_prev = (c_all[:, t - 1].to(acc) if t > 0
                      else torch.zeros_like(dh_c))
            # The masked c_t stands in for c_new: every term that uses it
            # carries the mask.
            tc = torch.tanh(c_all[:, t].to(acc))
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


def _bwd_acc(*operands) -> torch.dtype:
    """The plain backwards' working type: float64 where the operands are
    float64 (every sum and product in float64, the value every float32
    computation of the formulas approximates, as :func:`rnn_scan_states`
    gives the forward), else float32 (bf16 and float32 operands)."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in operands)
            else torch.float32)


def _contract(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``sum_{b,t} a[b,t]^T d[b,t]`` → ``[a.shape[-1], d.shape[-1]]``."""
    return a.reshape(-1, a.shape[-1]).T @ d.reshape(-1, d.shape[-1])


def rnn_scan_bwd_reference(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                           m: torch.Tensor, h_all: torch.Tensor,
                           c_all: Optional[torch.Tensor], dh: torch.Tensor,
                           forget_bias: float = 1.0):
    """Plain version of :func:`rnn_scan_bwd`: ``(dxw in xw.dtype,
    dW_h f32)``; float64 operands give float64 sums and outputs."""
    d_xw, d_hw, h_prev = _scan_bwd_core(cell, xw.to(_bwd_acc(xw, wh)), wh,
                                        m, h_all, c_all, dh, forget_bias)
    return d_xw.to(xw.dtype), _contract(h_prev, d_hw)


def rnn_scan_fused_bwd_reference(cell: str, hin: torch.Tensor,
                                 wx: torch.Tensor, b: torch.Tensor,
                                 wh: torch.Tensor, m: torch.Tensor,
                                 h_all: torch.Tensor,
                                 c_all: Optional[torch.Tensor],
                                 dh: torch.Tensor, forget_bias: float = 1.0):
    """Plain version of :func:`rnn_scan_fused_bwd`: ``(dhin in hin.dtype,
    dW_x, db, dW_h f32)``; float64 operands give float64 sums and outputs;
    seed-stacked operands give each per seed, one seed at a time."""
    if hin.dim() == 4:
        S = _check_stacked(cell, hin, wx, b, wh, m, h_all, c_all, dh)
        return _over_seeds(
            lambda *a: rnn_scan_fused_bwd_reference(cell, *a, forget_bias),
            S, hin, wx, b, wh, m, h_all, c_all, dh)
    acc = _bwd_acc(hin, wx, b, wh)
    xw = hin.to(acc) @ wx.to(acc) + b.to(acc)
    d_xw, d_hw, h_prev = _scan_bwd_core(cell, xw, wh, m, h_all, c_all, dh,
                                        forget_bias)
    dhin = (d_xw @ wx.to(acc).T).to(hin.dtype)
    return (dhin, _contract(hin.to(acc), d_xw), d_xw.sum(dim=(0, 1)),
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


def _check_stacked_scan(cell: str, xw, wh, m, h_all=None, c_all=None,
                        dh=None) -> int:
    """Shapes of seed-stacked hoisted operands → the seed extent S: xw [.,
    B, T, G*H], wh [., H, G*H], m [., B, T] and the states [., B, T, H],
    each leading extent S or 1."""
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {sorted(_GATES)}")
    if xw.dim() != 4 or xw.shape[-1] % _GATES[cell]:
        raise ValueError(f"xw must be [S, B, T, {_GATES[cell]}*H], got "
                         f"{tuple(xw.shape)}")
    _, B, T, G = xw.shape
    H = G // _GATES[cell]
    want = {"wh": (wh, (H, G)), "m": (m, (B, T)), "h_all": (h_all, (B, T, H)),
            "c_all": (c_all, (B, T, H)), "dh": (dh, (B, T, H))}
    for name, (t, tail) in want.items():
        if t is not None and (t.dim() != len(tail) + 1
                              or tuple(t.shape[1:]) != tail):
            raise ValueError(f"{name} must be [S, {', '.join(map(str, tail))}]"
                             f", got {tuple(t.shape)}")
    return _seed_extent(xw, wh, m, h_all, c_all, dh)


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


#: Batch rows per block the CUDA-core kernels (``csrc/rnn_fused_fwd.cu``,
#: ``csrc/rnn_bwd.cu``) are built for, most first.
SIMT_ROWS = (16, 8, 4, 2, 1)


@functools.lru_cache(maxsize=None)
def _simt_rows(cell: str, form: str, H: int, device: torch.device) -> int:
    """Batch rows per block of a CUDA-core kernel (``form`` one of
    :data:`_PAD_FORMS`) at hidden width ``H`` on ``device``: the most of
    :data:`SIMT_ROWS` whose shared memory, as the source counts it, fits
    the card's per-block limit. A row's sums do not depend on the count,
    so neither do its bits. Raises only where one row does not fit."""
    lib = _build.library()
    smem = (functools.partial(lib.lfm_rnn_fwd_smem, _CELL_CODE[cell],
                              int(form == "fwd"), H)
            if form in ("fused_fwd", "fwd") else
            functools.partial(lib.lfm_rnn_bwd_smem, _CELL_CODE[cell],
                              int(form == "fused_bwd"), H))
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    for rows in SIMT_ROWS:
        if smem(rows) <= limit:
            return rows
    raise ValueError(
        f"hidden={H} needs {smem(1)} bytes of shared memory per block for "
        f"the {cell} {form.replace('_', ' ')} on the CUDA cores even at one "
        f"batch row per block, more than the card's {limit}")


def _launch_fwd(cell: str, hoist: bool, xin: torch.Tensor, wx, b,
                wh: torch.Tensor, m: torch.Tensor, forget_bias: float,
                save_c: bool, rows: Optional[int] = None):
    """One launch of the CUDA-core forward → ``(h_all, c_all or None)``.
    Fused, ``xin`` is hin; hoisted, xw (``wx``, ``b`` None). Seed-stacked
    operands (``xin`` 4-D, each operand of seed extent S or 1) run every
    seed in the same launch, counted once, → ``[S, B, T, H]``. ``rows``
    (per block, one of :data:`SIMT_ROWS`) overrides :func:`_simt_rows`."""
    stacked = xin.dim() == 4
    if not stacked:
        xin, wh, m = xin[None], wh[None], m[None]
        if not hoist:
            wx, b = wx[None], b[None]
    S = _seed_extent(xin, wx, b, wh, m)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    dev = xin.device
    if rows is None:
        rows = _simt_rows(cell, "fwd" if hoist else "fused_fwd", H, dev)
    h = torch.empty((S, B, T, H), dtype=xin.dtype, device=dev)
    c = torch.empty_like(h) if save_c and cell == "lstm" else None
    lib = _build.library()
    keep = _keep(m)
    code = _build.dtype_code(xin.dtype)
    c_ptr = None if c is None else c.data_ptr()
    with torch.cuda.device(dev):
        if hoist:
            err = lib.lfm_rnn_scan_fwd(
                _CELL_CODE[cell], code, xin.data_ptr(), wh.data_ptr(),
                keep.data_ptr(), h.data_ptr(), c_ptr, S, B, T, H, rows,
                _stride(xin, S), _stride(wh, S), _stride(keep, S),
                float(forget_bias), _build.stream_of(xin))
        else:
            err = lib.lfm_rnn_fused_fwd(
                _CELL_CODE[cell], code, xin.data_ptr(), wx.data_ptr(),
                b.data_ptr(), wh.data_ptr(), keep.data_ptr(), h.data_ptr(),
                c_ptr, S, B, T, H, rows, _stride(xin, S), _stride(wx, S),
                _stride(b, S), _stride(wh, S), _stride(keep, S),
                float(forget_bias), _build.stream_of(xin))
    name = f"rnn_{'' if hoist else 'fused_'}fwd_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    if not stacked:
        return h[0], (None if c is None else c[0])
    return h, c


def _slices(rows: int) -> int:
    """Row slices of the weight-gradient reduction: enough blocks (one
    128 x 128 output tile per slice) to keep several in flight on every
    SM, and a fixed function of the shape, so the sums' order is too."""
    return max(1, min(128, rows // 512))


def _launch_bwd(cell: str, fused: bool, xin: torch.Tensor, wx, b,
                wh: torch.Tensor, m: torch.Tensor, h_all: torch.Tensor,
                c_all: Optional[torch.Tensor], dh: torch.Tensor,
                forget_bias: float, rows: Optional[int] = None):
    """One call of the CUDA-core backward (four kernel launches, counted
    once) → fused: ``(dhin, dW_x, db, dW_h)``; hoisted (``xin`` is xw,
    ``wx``, ``b`` None): ``(dxw, dW_h)``; the weight gradients in f32.
    Seed-stacked operands (``xin`` 4-D, each operand of seed extent S or
    1) run every seed in the same call and give each output per seed; the
    states ``h_all``, ``c_all`` and ``dh`` are per seed. ``rows`` (per
    block of the recurrence, one of :data:`SIMT_ROWS`) overrides
    :func:`_simt_rows`."""
    stacked = xin.dim() == 4
    if not stacked:
        xin, wh, m, h_all, dh = (t[None] for t in (xin, wh, m, h_all, dh))
        c_all = None if c_all is None else c_all[None]
        if fused:
            wx, b = wx[None], b[None]
    S = _seed_extent(xin, wx, b, wh, m, h_all, c_all, dh)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    G = _GATES[cell] * H
    dev = xin.device
    f32 = torch.float32
    if rows is None:
        rows = _simt_rows(cell, "fused_bwd" if fused else "bwd", H, dev)
    lib = _build.library()
    keep = _keep(m)
    # W^T in f32, at W's seed stride: the backward products read it by rows.
    whT = wh.float().transpose(-1, -2).contiguous()
    # The states are per seed: a shared one is copied out to every seed.
    h_all, c_all, dh = (
        None if t is None else t.expand(S, *t.shape[1:]).contiguous()
        for t in (h_all, c_all, dh))
    dgx = torch.empty((S, B, T, G), dtype=f32, device=dev)
    dhn = (torch.empty((S, B, T, H), dtype=f32, device=dev)
           if cell == "gru" else None)
    slices = _slices(B * T)
    total = 2 * H * G + G if fused else H * G
    partial = torch.empty((S, slices, total), dtype=f32, device=dev)
    dw = torch.empty((S, total), dtype=f32, device=dev)
    code = _build.dtype_code(xin.dtype)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        if fused:
            wxT = wx.float().transpose(-1, -2).contiguous()
            dx = torch.empty((S, B, T, H), dtype=xin.dtype, device=dev)
            err = lib.lfm_rnn_fused_bwd(
                _CELL_CODE[cell], code, xin.data_ptr(), wx.data_ptr(),
                b.data_ptr(), wh.data_ptr(), wxT.data_ptr(), whT.data_ptr(),
                keep.data_ptr(), h_all.data_ptr(), ptr(c_all), dh.data_ptr(),
                dx.data_ptr(), dgx.data_ptr(), ptr(dhn), partial.data_ptr(),
                slices, dw.data_ptr(), S, B, T, H, rows, _stride(xin, S),
                _stride(wx, S), _stride(b, S), _stride(wh, S),
                _stride(keep, S), float(forget_bias), _build.stream_of(xin))
        else:
            # In float32 the f32 gate gradients are dxw itself.
            dx = (None if xin.dtype == f32 else
                  torch.empty((S, B, T, G), dtype=xin.dtype, device=dev))
            err = lib.lfm_rnn_scan_bwd(
                _CELL_CODE[cell], code, xin.data_ptr(), wh.data_ptr(),
                whT.data_ptr(), keep.data_ptr(), h_all.data_ptr(),
                ptr(c_all), dh.data_ptr(), ptr(dx), dgx.data_ptr(),
                ptr(dhn), partial.data_ptr(), slices, dw.data_ptr(), S, B, T,
                H, rows, _stride(xin, S), _stride(wh, S), _stride(keep, S),
                float(forget_bias), _build.stream_of(xin))
    name = f"rnn_{'fused_' if fused else ''}bwd_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    if fused:
        hg = H * G
        out = (dx, dw[:, :hg].view(S, H, G), dw[:, hg:hg + G],
               dw[:, hg + G:].view(S, H, G))
    else:
        out = ((dgx if dx is None else dx), dw.view(S, H, G))
    return out if stacked else tuple(t[0] for t in out)


def _padded_width(H: int) -> int:
    """The width the tensor-core kernels run hidden width ``H`` at: the
    next multiple of 16 (at least 16)."""
    return 16 * -(-max(H, 1) // 16)


#: The widest padded width the bfloat16 kernels above 128 take
#: (``kMaxWidth`` in ``csrc/rnn_fwd_cluster.cu`` and
#: ``csrc/rnn_bwd_cluster.cu``).
CLUSTER_MAX_WIDTH = 512
#: The widest padded width the float32 backward on the tensor cores takes
#: (``kMaxWidth`` in ``csrc/rnn_bwd_tf32.cu``): past it the LSTM's f32 W_h
#: (16 Hp^2 bytes) does not fit 16 CTAs' shared memory beside the tiles.
TF32_MAX_WIDTH = 384
#: The widest padded width the float32 backward past it takes, W_h held by
#: a group of co-resident CTAs across the card (``kMaxWidth`` in
#: ``csrc/rnn_bwd_tf32_grid.cu``): the LSTM's W_h rows of one 8-unit chunk
#: take 131 KB at Hp 1024, so a group there is 128 CTAs (of an H100's 132).
GRID_MAX_WIDTH = 1024
#: The widest padded width the bfloat16 backward and forward past the
#: cluster's take, W_h held in bf16 by a group of co-resident CTAs
#: (``kMaxWidth`` in ``csrc/rnn_bwd_grid.cu`` and ``csrc/rnn_fwd_grid.cu``):
#: the LSTM's W_h rows (columns) of two 8-unit chunks beside the stages fill
#: an H100's 232,448 bytes at Hp 1520 (a group of 95 CTAs); past it a CTA
#: would hold three chunks, and W = Hp / 8 exceeds two chunks on each of
#: 132 CTAs.
BF16_GRID_MAX_WIDTH = 1520


def _mma_route(dtype: torch.dtype, H: int, direction: str = "fwd") -> str:
    """Which kernels run the forwards (``direction="fwd"``) and the
    backwards (``"bwd"``), fused and hoisted, on the card, with ``Hp =
    _padded_width(H)``:

    ========= ======== ================ ================================
    direction dtype    H                kernel (answer)
    ========= ======== ================ ================================
    fwd       bfloat16 Hp <= 128        ``rnn_fused_fwd_mma.cu``, fused
                                        and hoisted modes (``"mma"``)
    fwd       bfloat16 128 < Hp <= 512  ``rnn_fwd_cluster.cu``, fused and
                                        hoisted forms (``"cluster"``)
    fwd       float32  Hp <= 128        ``rnn_fwd_tf32.cu`` (``"tf32"``)
    bwd       bfloat16 Hp <= 128        ``rnn_fused_bwd_mma.cu`` (``"mma"``)
    bwd       bfloat16 128 < Hp <= 512  ``rnn_bwd_cluster.cu``, fused and
                                        hoisted forms (``"cluster"``)
    bwd       float32  Hp <= 128        ``rnn_bwd_tf32.cu`` (``"tf32"``)
    bwd       float32  128 < Hp <= 384  ``rnn_bwd_tf32.cu`` on a cluster
                                        of 2-16 CTAs (``"tf32"``)
    bwd       float32  384 < Hp <= 1024 ``rnn_bwd_tf32_grid.cu``, W_h on a
                                        group of co-resident CTAs
                                        (``"grid"``)
    bwd       bfloat16 512 < Hp <= 1520 ``rnn_bwd_grid.cu``, W_h in bf16 on
                                        a group of co-resident CTAs
                                        (``"grid"``)
    fwd       bfloat16 512 < Hp <= 1520 ``rnn_fwd_grid.cu``, fused and
                                        hoisted forms, W_h's columns in
                                        bf16 on a group of co-resident
                                        CTAs (``"grid"``)
    fwd       float32  H > 128          ``rnn_fused_fwd.cu`` (``"simt"``)
    fwd       bfloat16 Hp > 1520        ``rnn_fused_fwd.cu`` (``"simt"``)
    bwd       float32  Hp > 1024        ``rnn_bwd.cu`` (``"simt"``)
    bwd       bfloat16 Hp > 1520        ``rnn_bwd.cu`` (``"simt"``)
    ========= ======== ================ ================================

    The tensor-core kernels take 16 <= H <= 128, H % 16 == 0 and hold W_h
    in shared memory, hence the widths (the f32 kernels split it across a
    cluster of CTAs: the forward at every width, the backward at H =
    128); any other H <= 128 runs there at Hp, zero-padded per gate block
    (:func:`padded_launch`, exact). Above 128 bf16 splits W_h across a
    cluster of 2-16 CTAs both ways (the forward's size
    :func:`_cluster_size`, the backward's :func:`_cluster_bwd_size`), and
    so does the float32 backward up to :data:`TF32_MAX_WIDTH`
    (:func:`_tf32_cluster`), any H at Hp too; past it (W_h past 16 CTAs'
    shared memory) the float32 backward recomputes the gates by one GEMM
    and spreads the carry's product over a group of up to 132 co-resident
    CTAs holding W_h (:func:`_grid_size`, :func:`_grid_rows`) up to
    :data:`GRID_MAX_WIDTH`, and the bf16 backward past 512 does the same
    with W_h in bf16 up to :data:`BF16_GRID_MAX_WIDTH`, as does the bf16
    forward there (each CTA of a group holding its units' columns of W_h:
    :func:`_fwd_grid_size`, :func:`_fwd_grid_rows`), so a width has one
    route both ways. The CUDA-core kernels are the route of the float32
    forward above 128, the bf16 forward past 1520, the float32 backward
    past 1024 and the bf16 backward past 1520, not a fallback: a cluster or
    grid launch the card refuses raises. bf16 runs on the
    bf16 tensor cores; float32 must hold
    the JAX f32 bound, so it splits every f32 operand of the recurrence
    into two TF32 terms (3xTF32), and the fused forward forms xw on the
    CUDA cores (unbiased f32 sums). The fused bf16 backward at H <= 128
    reuses the forward's packing of W_x; the fused float32 backward and
    the fused bf16 backward above 128 (cluster and grid) reuse the
    forward's f32 xw scratch as their d_gates buffer."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', got {direction}")
    Hp = _padded_width(H)
    if Hp > 128:
        if dtype == torch.bfloat16 and Hp <= CLUSTER_MAX_WIDTH:
            return "cluster"
        if dtype == torch.float32 and direction == "bwd":
            if Hp <= TF32_MAX_WIDTH:
                return "tf32"
            if Hp <= GRID_MAX_WIDTH:
                return "grid"
        if dtype == torch.bfloat16 and Hp <= BF16_GRID_MAX_WIDTH:
            return "grid"
        return "simt"
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "tf32"
    return "simt"


#: The operands and outputs of each form of launch, in order, and how each
#: pads: "u" a ``[.., H]`` tensor (hin, h_all, c_all, dh, dhin), "g" ``[..,
#: G H]`` gate columns (b, xw, db, dxw), "w" a weight ``[.., H, G H]``
#: (W_x, W_h and their gradients), "-" as it is (m; the float32 fused
#: forward's xw scratch, which its backward takes at the padded width).
_PAD_FORMS = {
    "fused_fwd": ("uwgwm", "uu-"),
    "fwd": ("gwm", "uu"),
    "fused_bwd": ("uwgwmuuu", "uwgw"),
    "bwd": ("gwmuuu", "gw"),
}


def _pad_one(t: Optional[torch.Tensor], kind: str, G: int, H: int,
             Hp: int) -> Optional[torch.Tensor]:
    """One operand from width H to Hp, zeros in the new places: the last
    axis (u), each of its G gate blocks (g), or a weight's rows and gate
    blocks (w). One copy of the values and a fill of the new places only
    (a pad that fills the whole output first writes it twice)."""
    if t is None or kind == "-" or kind == "m":
        return t
    blocks = 1 if kind == "u" else G
    src = t.unflatten(-1, (blocks, H))
    rows = (Hp,) if kind == "w" else ()
    out = t.new_empty(*src.shape[:-2 - len(rows)], *rows, blocks, Hp)
    real = out
    if kind == "w":
        out[..., H:, :, :].zero_()
        real = out[..., :H, :, :]
    real[..., :H].copy_(src)
    real[..., H:].zero_()
    return out.flatten(-2)


def _unpad_one(t: Optional[torch.Tensor], kind: str, G: int, H: int,
               Hp: int) -> Optional[torch.Tensor]:
    """The inverse of :func:`_pad_one`: a new contiguous tensor (the next
    layer's kernel reads it from a 16-byte boundary)."""
    if t is None or kind == "-":
        return t
    if kind == "w":
        t = t[..., :H, :]
    if kind in "gw":
        return t.unflatten(-1, (G, Hp))[..., :H].flatten(-2).contiguous()
    return t[..., :H].contiguous()


def _pad_operands(form: str, cell: str, ops) -> tuple:
    """``form``'s operands (:data:`_PAD_FORMS`) zero-padded from their
    hidden width H to :func:`_padded_width`; as they are when it is H."""
    kinds = _PAD_FORMS[form][0]
    H = ops[kinds.rindex("w")].shape[-2]
    Hp = _padded_width(H)
    if Hp == H:
        return tuple(ops)
    return tuple(_pad_one(t, k, _GATES[cell], H, Hp)
                 for t, k in zip(ops, kinds))


def _unpad_outputs(form: str, cell: str, H: int, out) -> tuple:
    """``form``'s outputs at the padded width sliced back to width H."""
    Hp = _padded_width(H)
    if Hp == H:
        return tuple(out)
    return tuple(_unpad_one(t, k, _GATES[cell], H, Hp)
                 for t, k in zip(out, _PAD_FORMS[form][1]))


def padded_launch(launch, form: str):
    """``launch`` — a kernel's launcher, or a plain version with its
    signature ``(cell, *operands, *rest, **kw)`` (operands in the order of
    :data:`_PAD_FORMS` ``[form]``) — run at :func:`_padded_width` of the
    operands' hidden width H: every operand is zero-padded per gate block
    to Hp (W_x, W_h ``[.., H, G H]`` → ``[.., Hp, G Hp]``, each gate's H
    columns first in its Hp; b, xw ``[.., G H]`` → ``[.., G Hp]``; hin,
    h_all, c_all, dh ``[.., H]`` → ``[.., Hp]``; m as it is; seed-stacked
    operands alike) and the outputs are sliced back (h_all, c_all, dhin to
    ``[.., :H]``; dxw, dW_x, db, dW_h per gate block). ``rest`` and ``kw``
    pass as they are (prepacked weights, the float32 forward's xw scratch
    and its backward's, which stay at Hp). At H = Hp ``launch`` runs on
    the operands themselves.

    Why this is exact. A padded unit's gate pre-activations are 0, since
    its columns of W_x, W_h and b are zero. LSTM: c = f 0 + sigmoid(0)
    tanh(0) = 0 and h = sigmoid(0) tanh(0) = 0. GRU (reset after the
    projection, no recurrent bias: :func:`_gru_parts`): n = tanh(0 + r 0)
    = 0 and h = (1 - z) 0 + z 0 = 0. The padded rows of W_h (and of W_x)
    meet h = 0 (and hin = 0), so the real units' gates are unchanged. In
    the backward dh is 0 on the padded units, so their d_gates are 0 and
    add nothing to the real units' gradients. The padded route computes
    the same function at the kernel's own bounds; it is not bitwise the
    unpadded plain version, since the k-chains, the cluster split and the
    rows per block change with Hp."""
    n = len(_PAD_FORMS[form][0])

    def run(cell: str, *args, **kw):
        ops, rest = args[:n], args[n:]
        H = ops[_PAD_FORMS[form][0].rindex("w")].shape[-2]
        out = launch(cell, *_pad_operands(form, cell, ops), *rest, **kw)
        return _unpad_outputs(form, cell, H, out)

    return run


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


@functools.lru_cache(maxsize=16)
def _padded_fragment_index(H: int, G: int, Hp: int, device=None,
                           transpose: bool = False) -> torch.Tensor:
    """:func:`_fragment_index` of a weight ``[H, G H]`` zero-padded to
    ``[Hp, G Hp]`` (:func:`padded_launch`), as flat indices into the
    unpadded weight with one zero appended: each padded place points at
    that zero, index ``H G H``."""
    idx = _fragment_index(Hp, G * Hp, device, transpose)
    row, col = idx // (G * Hp), idx % (G * Hp)
    q, u = col // Hp, col % Hp
    return torch.where((row < H) & (u < H), row * G * H + q * H + u,
                       H * G * H)


def pack_fragments(w: torch.Tensor, transpose: bool = False,
                   width: Optional[int] = None) -> torch.Tensor:
    """``w [H, G*H]`` → the mma kernels' fragment order of ``w`` (or,
    with ``transpose``, of ``w^T``); flat, same dtype, a new tensor. See
    :func:`_fragment_index`. A seed-stacked ``w [S, H, G*H]`` is packed
    per seed → ``[S, H*G*H]``. ``width`` Hp > H packs ``w`` zero-padded
    per gate block to ``[Hp, G Hp]`` (:func:`padded_launch`) in the same
    gather."""
    H, cols = w.shape[-2:]
    flat = w.reshape(*w.shape[:-2], -1)
    if width is None or width == H:
        idx = _fragment_index(H, cols, w.device, transpose)
    else:
        idx = _padded_fragment_index(H, cols // H, width, w.device,
                                     transpose)
        flat = torch.nn.functional.pad(flat, (0, 1))
    return flat[..., idx]


def unpack_fragments(packed: torch.Tensor, H: int, cols: int,
                     transpose: bool = False) -> torch.Tensor:
    """Inverse of :func:`pack_fragments` → ``[H, cols]``."""
    w = torch.empty(H * cols, dtype=packed.dtype, device=packed.device)
    w[_fragment_index(H, cols, packed.device, transpose)] = packed
    return w.view(H, cols)


def _mma_rows(B: int, sms: int, S: int = 1, hoisted: bool = False) -> int:
    """Rows per block of the tensor-core forward, from the block count S *
    ceil(B / rows) of S seeds: the most (64, 32, then 16: the fewer W_x
    reads and barriers per row) that still give at least half the SMs a
    block. The hoisted mode takes at most 32 (its xw_t waits in
    registers: ``csrc/rnn_fused_fwd_mma.cu``). Measured on an H100 with
    ``chip_smoke.py`` and ``scripts/torch_mma_variants.py`` (PERF.md §6)."""
    for rows in ((32,) if hoisted else (64, 32)):
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


def _launch_scan_fwd_mma(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                         m: torch.Tensor, forget_bias: float, save_c: bool,
                         rows: Optional[int] = None):
    """One launch of the tensor-core hoisted forward (the hoisted mode of
    ``csrc/rnn_fused_fwd_mma.cu``) → ``(h_all, c_all or None)``.
    Seed-stacked operands (``xw [S, B, T, G H]``, ``wh [S, H, G H]``, ``m
    [S, B, T]``, each of seed extent S or 1) run every seed in the same
    launch, counted once, → ``[S, B, T, H]``. ``rows`` (16 or 32)
    overrides the choice from the block count."""
    stacked = xw.dim() == 4
    if not stacked:
        xw, wh, m = xw[None], wh[None], m[None]
    S = _seed_extent(xw, wh, m)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    dev = xw.device
    if rows is None:
        rows = _mma_rows(
            B, torch.cuda.get_device_properties(dev).multi_processor_count, S,
            hoisted=True)
    lib = _build.library()
    smem = lib.lfm_rnn_scan_fwd_mma_smem(_CELL_CODE[cell], H, rows)
    if smem < 0:
        raise ValueError(f"the mma hoisted forward does not take H={H} with "
                         f"{rows} rows per block")
    _smem_check(smem, dev, H)
    whp = pack_fragments(wh)
    xw = _aligned16(xw)
    h = torch.empty((S, B, T, H), dtype=xw.dtype, device=dev)
    c = torch.empty_like(h) if save_c and cell == "lstm" else None
    keep = _keep(m)
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_scan_fwd_mma(
            _CELL_CODE[cell], xw.data_ptr(), whp.data_ptr(), keep.data_ptr(),
            h.data_ptr(), None if c is None else c.data_ptr(), S, B, T, H,
            rows, _stride(xw, S), _stride(whp, S), _stride(keep, S),
            float(forget_bias), _build.stream_of(xw))
    name = f"rnn_fwd_mma_{cell}"
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
    → ``(dxw in xw.dtype, dW_h f32)``. Seed-stacked operands (``xw [S,
    B, T, G H]``, ``wh [S, H, G H]``, ``m [S, B, T]``, each of seed extent
    S or 1) run every seed in the same call, counted once, and give each
    output per seed; the states ``h_all``, ``c_all`` and ``dh`` are per
    seed."""
    stacked = xw.dim() == 4
    if not stacked:
        xw, wh, m, h_all, dh = (t[None] for t in (xw, wh, m, h_all, dh))
        c_all = None if c_all is None else c_all[None]
    S = _seed_extent(xw, wh, m, h_all, c_all, dh)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    G = _GATES[cell] * H
    dev = xw.device
    f32 = torch.float32
    lib = _build.library()
    smem = lib.lfm_rnn_scan_bwd_mma_smem(_CELL_CODE[cell], H)
    if smem < 0:
        raise ValueError(f"the mma backward does not take H={H}")
    _smem_check(smem, dev, H)
    # The states are per seed: a shared one is copied out to every seed.
    h_all, c_all, dh = (
        None if t is None else t.expand(S, *t.shape[1:]).contiguous()
        for t in (h_all, c_all, dh))
    xw, wh, h_all, c_all, dh = (None if t is None else _aligned16(t)
                                for t in (xw, wh, h_all, c_all, dh))
    keep = _keep(m)
    d_hw = torch.empty((S, B, T, G), dtype=f32, device=dev)
    slices = _slices(B * T)
    partial = torch.empty((S, slices, H * G), dtype=f32, device=dev)
    dw = torch.empty((S, H * G), dtype=f32, device=dev)
    dxw = torch.empty((S, B, T, G), dtype=xw.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_scan_bwd_mma(
            _CELL_CODE[cell], xw.data_ptr(), wh.data_ptr(), keep.data_ptr(),
            h_all.data_ptr(), None if c_all is None else c_all.data_ptr(),
            dh.data_ptr(), dxw.data_ptr(), d_hw.data_ptr(),
            partial.data_ptr(), slices, dw.data_ptr(), S, B, T, H,
            _stride(xw, S), _stride(wh, S), _stride(keep, S),
            float(forget_bias), _build.stream_of(xw))
    name = f"rnn_bwd_mma_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    out = (dxw, dw.view(S, H, G))
    return out if stacked else tuple(t[0] for t in out)


#: Rows per CTA of the 3xTF32 recurrences at H <= 128 (``16 *
#: kRowTiles`` in ``csrc/rnn_bwd_tf32.cu`` and ``csrc/rnn_fwd_tf32.cu``)
#: and the cluster sizes each direction is built for (the forward's:
#: ``kCluster``; the backward's 1 and 2 at H <= 128, 2-16 above).
TF32_ROWS = 32
TF32_CLUSTERS = {"bwd": (1, 2, 4, 8, 16), "fwd": (2,)}
#: Rows per cluster of the float32 backward above 128, and its threads per
#: CTA at most by rows (``max_threads`` in ``csrc/rnn_bwd_tf32.cu``: the
#: registers of the recompute's sums, xw_t, the carries and the carry
#: product's chunks).
TF32_CLUSTER_ROWS = (16, 32)
TF32_MAX_THREADS = {16: 384, 32: 256}
#: Bytes of the float32 backward's per-slice weight-gradient partial sums
#: one seed may take (:func:`_tf32_slices`).
TF32_PARTIAL_BYTES = 1 << 27


def _tf32_takes(H: int, C: int, rows: int) -> bool:
    """The shapes the float32 backward (``csrc/rnn_bwd_tf32.cu``, its
    ``supported``) takes: 16 <= H <= 128 with C 1 or 2 and
    :data:`TF32_ROWS` rows; 128 < H <= :data:`TF32_MAX_WIDTH` with C of 2,
    4, 8, 16, rows of :data:`TF32_CLUSTER_ROWS` and the CTA's warps
    (:func:`_cluster_warps`) within the rows' thread limit; H % 16 == 0."""
    if not (16 <= H <= TF32_MAX_WIDTH and H % 16 == 0):
        return False
    if H <= 128:
        return C in (1, 2) and rows == TF32_ROWS
    if C not in TF32_CLUSTERS["bwd"][1:] or rows not in TF32_CLUSTER_ROWS:
        return False
    return _cluster_warps(H, C) * 32 <= TF32_MAX_THREADS[rows]


def _tf32_smem(cell: str, H: int, C: int, direction: str = "bwd",
               rows: int = TF32_ROWS) -> int:
    """Shared memory (bytes) of a 3xTF32 recurrence kernel with a cluster
    of ``C`` CTAs, as ``recur_smem_bytes`` computes it in the source, all
    f32. At H <= 128: W_h's columns of the CTA's H/C units [H, G H/C + 4]
    and two h tiles [rows, H + 8]; the backward (``csrc/rnn_bwd_tf32.cu``)
    adds the d_hw tile [rows, G H/C + 4] and, in a cluster, two receive
    buffers [rows, H/C + 8] (the forward, ``csrc/rnn_fwd_tf32.cu``,
    all-gathers h_t into the h tiles themselves). The backward above 128:
    the share [H, G U + 4] (U = 8 :func:`_cluster_warps`), one h tile
    [rows, H + 8], the d_hw tile [rows, G U + 4] and the receive buffer
    [C][rows][LR], LR = 8 NW rounded up to an odd multiple of 8."""
    G = _GATES[cell]
    if direction == "bwd" and H > 128:
        NW = _cluster_warps(H, C)
        LW = G * MMA_UNITS * NW + 4
        LR = MMA_UNITS * (NW | 1)
        return 4 * (H * LW + rows * (H + 8) + rows * LW + C * rows * LR)
    Hc = H // C
    GHc = G * Hc
    floats = H * (GHc + 4) + 2 * rows * (H + 8)
    if direction == "bwd":
        floats += rows * (GHc + 4) + (2 * rows * (Hc + 8) if C > 1 else 0)
    return 4 * floats


def _tf32_cluster(cell: str, H: int, limit: int,
                  direction: str = "bwd") -> int:
    """CTAs per cluster of a 3xTF32 recurrence: the fewest of the
    direction's sizes the kernel takes at H (the backward 1, then 2 at H
    <= 128, and 2, 4, 8, 16 above; the forward always 2, which beat one
    CTA by 1.3-1.6x at B 2048 where W_h fits one) whose share of W_h fits
    beside the tiles in ``limit`` bytes of shared memory per block (the
    backward above 128 at 16 rows, its least); raises where none does. On
    an H100 the backward above 128 takes the LSTM 2 CTAs at Hp 144, 4 to
    208, 8 to 272 and 16 to 384, the GRU 2 to 176, 4 to 224, 8 to 320 and
    16 to 384."""
    rows = 16 if direction == "bwd" and H > 128 else TF32_ROWS
    sizes = (TF32_CLUSTERS["fwd"] if direction == "fwd" else tuple(
        C for C in TF32_CLUSTERS["bwd"] if _tf32_takes(H, C, rows)))
    name = "backward" if direction == "bwd" else "forward"
    if not sizes:
        raise ValueError(f"the float32 {name} on the tensor cores does not "
                         f"take hidden={H}")
    for C in sizes:
        if _tf32_smem(cell, H, C, direction, rows) <= limit:
            return C
    raise ValueError(
        f"the float32 {name} at hidden={H} needs "
        f"{_tf32_smem(cell, H, sizes[-1], direction, rows)} bytes of "
        f"shared memory per block even split over {sizes[-1]} CTAs, "
        f"more than the card's {limit}")


def _tf32_rows(cell: str, H: int, C: int, B: int, S: int, limit: int,
               sms: int) -> int:
    """Batch rows per cluster of the float32 backward: :data:`TF32_ROWS`
    at H <= 128; above, 32 where the kernel takes them (the CTA within 256
    threads), they fit ``limit`` and the launch still gives at least half
    the ``sms`` SMs a CTA (``2 C S ceil(B / 32) >= sms``, the bf16 cluster
    kernels' rule), else 16. A row's sums do not depend on the count."""
    if H <= 128:
        return TF32_ROWS
    if (_tf32_takes(H, C, 32) and _tf32_smem(cell, H, C, "bwd", 32) <= limit
            and 2 * C * S * -(-B // 32) >= sms):
        return 32
    return 16


def _tf32_slices(rows: int, total: int) -> int:
    """Row slices of the float32 backward's weight-gradient reduction:
    :func:`_slices`, cut so that one seed's partial sums (``total`` f32 a
    slice) stay within :data:`TF32_PARTIAL_BYTES` (128 slices of the fused
    LSTM's at H 384 would be 605 MB). A fixed function of the shape, so
    the sums' order is too, and the same for every seed count."""
    return min(_slices(rows), max(1, TF32_PARTIAL_BYTES // (4 * total)))


@functools.lru_cache(maxsize=None)
def _tf32_bwd_check(cell: str, H: int, C: int, rows: int,
                    device: torch.device) -> Optional[int]:
    """Once per shape and card: ``csrc/rnn_bwd_tf32.cu`` takes it and
    counts the shared memory :func:`_tf32_smem` counts, it fits the card,
    and (above 128) the card holds at least one such cluster
    (``cudaOccupancyMaxActiveClusters``) → the clusters it holds at once
    (None at H <= 128, where the launch itself checks its 2-CTA cluster).
    Raises, naming the width and the cluster size, where not: the launch
    is refused, and nothing else runs it."""
    lib = _build.library()
    code = _CELL_CODE[cell]
    smem = lib.lfm_rnn_bwd_tf32_smem(code, H, C, rows)
    if smem < 0:
        raise ValueError(f"the float32 backward on the tensor cores does not "
                         f"take hidden={H} with a cluster of {C} CTAs and "
                         f"{rows} rows")
    if smem != _tf32_smem(cell, H, C, "bwd", rows):
        raise RuntimeError(
            f"csrc/rnn_bwd_tf32.cu counts {smem} bytes of shared memory, "
            f"ops/rnn.py {_tf32_smem(cell, H, C, 'bwd', rows)}")
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"hidden={H} on a cluster of {C} CTAs needs {smem} "
                         f"bytes of shared memory per CTA, more than the "
                         f"card's {limit}")
    if H <= 128:
        return None
    with torch.cuda.device(device):
        n = lib.lfm_rnn_bwd_tf32_clusters(code, H, C, rows)
    if n < 1:
        raise RuntimeError(
            f"the card holds no cluster of {C} CTAs of the float32 {cell} "
            f"backward at hidden={H} ({rows} rows, {smem} bytes of shared "
            f"memory a CTA): cudaOccupancyMaxActiveClusters gave {n}")
    return n


def _keep(m: torch.Tensor) -> torch.Tensor:
    """The step validity as the kernels read it, uint8 [.., B, T]: a
    contiguous bool tensor is viewed, not copied."""
    if m.dtype == torch.bool and m.is_contiguous():
        return m.view(torch.uint8)
    return m.to(torch.uint8).contiguous()


@functools.lru_cache(maxsize=None)
def _fwd_tf32_check(cell: str, H: int, device: torch.device) -> None:
    """The forward's 2-CTA cluster fits ``device``
    (:func:`_tf32_cluster`), and its shared memory agrees with the count
    of ``csrc/rnn_fwd_tf32.cu``: checked once per (cell, H, device), off
    the per-call host path."""
    C = _tf32_cluster(cell, H, torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin, "fwd")
    smem = _build.library().lfm_rnn_fwd_tf32_smem(_CELL_CODE[cell], H)
    if smem != _tf32_smem(cell, H, C, "fwd"):
        raise RuntimeError(
            f"csrc/rnn_fwd_tf32.cu counts {smem} bytes of shared memory, "
            f"ops/rnn.py {_tf32_smem(cell, H, C, 'fwd')}")


def _launch_fwd_tf32(cell: str, fused: bool, xin: torch.Tensor, wx, b,
                     wh: torch.Tensor, m: torch.Tensor, forget_bias: float,
                     save_c: bool, keep_xw: bool = False):
    """One call of the float32 forward on the tensor cores
    (``csrc/rnn_fwd_tf32.cu``, 3xTF32; fused: the xw GEMM and the
    recurrence, hoisted: the recurrence, counted once) → ``(h_all, c_all
    or None)``, f32, and fused with ``keep_xw`` also the xw scratch, which
    the backward takes as its d_gates buffer. Fused, ``xin`` is hin and
    ``wx``, ``b`` are used; hoisted, ``xin`` is xw (``wx``, ``b`` None).
    Seed-stacked operands (``xin`` 4-D, each operand of seed extent S or 1)
    run every seed in the same call → ``[S, B, T, H]``. A cluster the card
    cannot schedule raises (:func:`_fwd_tf32_check`). The wrapper allocates
    the outputs and, fused, the xw scratch [S, B, T, G H] f32, and copies
    no operand that is contiguous and 16-byte aligned."""
    stacked = xin.dim() == 4
    if not stacked:
        xin, wh, m = xin[None], wh[None], m[None]
        if fused:
            wx, b = wx[None], b[None]
    S = _seed_extent(xin, wx, b, wh, m)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    dev = xin.device
    lib = _build.library()
    _fwd_tf32_check(cell, H, dev)
    xin, wh = _aligned16(xin), _aligned16(wh)
    if fused:
        wx, b = _aligned16(wx), _aligned16(b)
    keep = _keep(m)
    h = torch.empty((S, B, T, H), dtype=torch.float32, device=dev)
    c = torch.empty_like(h) if save_c and cell == "lstm" else None
    xw = (torch.empty((S, B, T, _GATES[cell] * H), dtype=torch.float32,
                      device=dev) if fused else None)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_fwd_tf32(
            _CELL_CODE[cell], int(fused), xin.data_ptr(), ptr(wx), ptr(b),
            wh.data_ptr(), keep.data_ptr(), h.data_ptr(), ptr(c), ptr(xw), S,
            B, T, H, _stride(xin, S), 0 if wx is None else _stride(wx, S),
            0 if b is None else _stride(b, S), _stride(wh, S),
            _stride(keep, S), float(forget_bias), _build.stream_of(xin))
    name = f"rnn_{'fused_' if fused else ''}fwd_tf32_{cell}"
    _build.check(lib, err, name)
    _build.count_launch(name)
    out = (h, c, xw) if keep_xw else (h, c)
    return out if stacked else tuple(None if t is None else t[0]
                                     for t in out)


def _launch_bwd_tf32(cell: str, fused: bool, xin: torch.Tensor, wx, b,
                     wh: torch.Tensor, m: torch.Tensor, h_all: torch.Tensor,
                     c_all: Optional[torch.Tensor], dh: torch.Tensor,
                     forget_bias: float, xw: Optional[torch.Tensor] = None,
                     cluster: Optional[int] = None,
                     rows: Optional[int] = None):
    """One call of the float32 backward on the tensor cores
    (``csrc/rnn_bwd_tf32.cu``, 3xTF32; fused: five kernel launches, or four
    given ``xw``; hoisted: three; counted once) → fused: ``(dhin, dW_x, db,
    dW_h)``; hoisted (``xin`` is xw, ``wx`` and ``b`` None): ``(dxw,
    dW_h)``; all f32. Seed-stacked operands (``xin`` 4-D, each operand of
    seed extent S or 1) run every seed in the same call and give each
    output per seed; the states ``h_all``, ``c_all`` and ``dh`` are per
    seed. Fused, ``xw`` is the forward's xw scratch (``[S, B, T, G H]`` or
    ``[B, T, G H]``): the kernel skips its own xw GEMM and overwrites the
    scratch with d_xw. The cluster size and rows come from
    :func:`_tf32_cluster` and :func:`_tf32_rows` (``cluster``, ``rows``
    override them); a cluster the card cannot hold raises
    (:func:`_tf32_bwd_check`)."""
    stacked = xin.dim() == 4
    if not stacked:
        xin, wh, m, h_all, dh = (t[None] for t in (xin, wh, m, h_all, dh))
        c_all = None if c_all is None else c_all[None]
        if fused:
            wx, b = wx[None], b[None]
    S = _seed_extent(xin, wx, b, wh, m, h_all, c_all, dh)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    G = _GATES[cell] * H
    dev = xin.device
    f32 = torch.float32
    lib = _build.library()
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    C = cluster or _tf32_cluster(cell, H, limit)
    if rows is None:
        rows = _tf32_rows(cell, H, C, B, S, limit, props.multi_processor_count)
    _tf32_bwd_check(cell, H, C, rows, dev)
    # The states are per seed: a shared one is copied out to every seed.
    h_all, c_all, dh = (
        None if t is None else t.expand(S, *t.shape[1:]).contiguous()
        for t in (h_all, c_all, dh))
    xin, wh, h_all, c_all, dh = (None if t is None else _aligned16(t)
                                 for t in (xin, wh, h_all, c_all, dh))
    keep = m.to(torch.uint8).contiguous()
    dgx = (torch.empty((S, B, T, G), dtype=f32, device=dev) if xw is None
           else xw.view(S, B, T, G))
    dhn = (torch.empty((S, B, T, H), dtype=f32, device=dev)
           if cell == "gru" else None)
    total = 2 * H * G + G if fused else H * G
    slices = _tf32_slices(B * T, total)
    partial = torch.empty((S, slices, total), dtype=f32, device=dev)
    dw = torch.empty((S, total), dtype=f32, device=dev)
    dx = torch.empty((S, B, T, H), dtype=f32, device=dev) if fused else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_bwd_tf32(
            _CELL_CODE[cell], 0 if not fused else 1 if xw is None else 2,
            xin.data_ptr(), ptr(wx), ptr(b),
            wh.data_ptr(), keep.data_ptr(), h_all.data_ptr(), ptr(c_all),
            dh.data_ptr(), ptr(dx), dgx.data_ptr(), ptr(dhn),
            partial.data_ptr(), slices, dw.data_ptr(), S, B, T, H, C, rows,
            _stride(xin, S), 0 if wx is None else _stride(wx, S),
            0 if b is None else _stride(b, S), _stride(wh, S),
            _stride(keep, S), float(forget_bias), _build.stream_of(xin))
    name = f"rnn_{'fused_' if fused else ''}bwd_tf32_{cell}"
    _build.check(lib, err, f"{name} (hidden={H}, cluster of {C}, {rows} rows)")
    _build.count_launch(name)
    if fused:
        hg = H * G
        out = (dx, dw[:, :hg].view(S, H, G), dw[:, hg:hg + G],
               dw[:, hg + G:].view(S, H, G))
    else:
        out = (dgx, dw.view(S, H, G))
    return out if stacked else tuple(t[0] for t in out)


# ---------------------------------------------------------------------------
# The backwards on the grid: float32 past Hp 384
# (csrc/rnn_bwd_tf32_grid.cu) and bfloat16 past Hp 512 (csrc/rnn_bwd_grid.cu)
# ---------------------------------------------------------------------------

#: Rows per work item, threads per CTA at most, and the d_hw columns per
#: stage and stages in shared memory of the grid backwards (their rows,
#: ``kMaxThreads``, ``kStageK`` and ``kStages`` in
#: ``csrc/rnn_bwd_tf32_grid.cu`` and ``csrc/rnn_bwd_grid.cu``, the same in
#: both).
GRID_ROWS = (64, 128)
GRID_MAX_THREADS = 512
GRID_STAGE_K = 64
GRID_STAGES = 2


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _grid_max_width(dtype: torch.dtype) -> int:
    """The widest padded width the grid backward of ``dtype`` takes."""
    return (BF16_GRID_MAX_WIDTH if dtype == torch.bfloat16
            else GRID_MAX_WIDTH)


def _grid_chunks(Hp: int, n: int) -> int:
    """8-unit chunks a CTA of a group of ``n`` owns at most: ceil(W / n) of
    the W = Hp / 8, dealt out as :func:`_cluster_units` deals warps (CTA j
    owns ``[j W / n, (j + 1) W / n)``)."""
    return -(-(Hp // MMA_UNITS) // n)


def _grid_takes(Hp: int, n: int, rows: int,
                dtype: torch.dtype = torch.float32) -> bool:
    """The shapes the grid backward of ``dtype`` takes (its source's
    ``supported``): 128 < Hp <= :func:`_grid_max_width`, Hp % 16 == 0 (the
    route gives float32 Hp > :data:`TF32_MAX_WIDTH` and bf16 Hp >
    :data:`CLUSTER_MAX_WIDTH`; below, it is timed beside the cluster
    forms), rows of :data:`GRID_ROWS`, 1 <= n <= Hp / 8, and a warp per
    (chunk, 16 rows) within :data:`GRID_MAX_THREADS`."""
    if not (128 < Hp <= _grid_max_width(dtype) and Hp % 16 == 0):
        return False
    if rows not in GRID_ROWS or not 1 <= n <= Hp // MMA_UNITS:
        return False
    return 32 * _grid_chunks(Hp, n) * (rows // 16) <= GRID_MAX_THREADS


def _grid_smem(cell: str, Hp: int, n: int, rows: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory (bytes) of a CTA of the grid recurrence, as
    ``grid_smem_bytes`` counts it in the source of ``dtype``: the W_h rows
    of its units across every gate column and :data:`GRID_STAGES` stages
    of d_hw. float32: [8 NC][G Hp + 4] and [rows][kStageK + 4], f32 (NC =
    :func:`_grid_chunks`); bf16: [8 NC][G Hp + 8] and the hi and lo tiles
    [2][rows][kStageK + 8], bf16."""
    G = _GATES[cell]
    NC = _grid_chunks(Hp, n)
    if dtype == torch.bfloat16:
        return 2 * (MMA_UNITS * NC * (G * Hp + 8)
                    + GRID_STAGES * 2 * rows * (GRID_STAGE_K + 8))
    return 4 * (MMA_UNITS * NC * (G * Hp + 4)
                + GRID_STAGES * rows * (GRID_STAGE_K + 4))


def _grid_size(cell: str, Hp: int, limit: int, sms: int,
               dtype: torch.dtype = torch.float32) -> int:
    """CTAs a group of the grid backward of ``dtype``: the fewest, at most
    ``sms``, whose share of W_h fits beside the 64-row stages in
    ``limit`` bytes of shared memory a CTA within the thread limit (fewer
    CTAs all-gather fewer bytes a step and leave more groups). Raises,
    naming the width, where none does. On an H100, float32: the LSTM takes
    17 at Hp 400 (3 chunks a CTA), 40 at 640 and 128 at 1024, the GRU 13,
    27 and 64; bf16: the LSTM 17 at 528 (4 chunks, the thread limit), 20
    at 640, 64 at 1024 and 95 at 1520, the GRU 17, 20, 43 and 95."""
    for n in range(1, min(Hp // MMA_UNITS, sms) + 1):
        if (_grid_takes(Hp, n, 64, dtype)
                and _grid_smem(cell, Hp, n, 64, dtype) <= limit):
            return n
    raise ValueError(
        f"the {_dtype_name(dtype)} {cell} backward on the grid does not take "
        f"hidden={Hp}: no group of at most {sms} CTAs holds its W_h within "
        f"{limit} bytes of shared memory a CTA, or the width is outside "
        f"128 < Hp <= {_grid_max_width(dtype)}")


def _grid_rows(cell: str, Hp: int, n: int, B: int, S: int, limit: int,
               sms: int, dtype: torch.dtype = torch.float32) -> int:
    """Batch rows per work item of the grid recurrence: 128 where the
    kernel takes them at this group size, they fit ``limit`` and the S
    ceil(B / 128) items still occupy every group the card holds (``sms //
    n``), else 64. More rows halve the steps' barriers and give a CTA of
    one chunk 8 warps; a row's sums do not depend on the count."""
    if (_grid_takes(Hp, n, 128, dtype)
            and _grid_smem(cell, Hp, n, 128, dtype) <= limit
            and S * -(-B // 128) >= sms // n):
        return 128
    return 64


@functools.lru_cache(maxsize=None)
def _grid_check(cell: str, H: int, n: int, rows: int, device: torch.device,
                dtype: torch.dtype = torch.float32) -> int:
    """Once per shape, dtype and card: the grid backward's source
    (``csrc/rnn_bwd_tf32_grid.cu``, bf16 ``csrc/rnn_bwd_grid.cu``) takes it
    and counts the shared memory :func:`_grid_smem` counts, it fits the
    card, and the card holds a whole group at once → the CTAs it holds at
    once (one an SM). Raises, naming the width and the group, where not."""
    lib = _build.library()
    code = _CELL_CODE[cell]
    bf = dtype == torch.bfloat16
    src = "rnn_bwd_grid.cu" if bf else "rnn_bwd_tf32_grid.cu"
    name = _dtype_name(dtype)
    smem = (lib.lfm_rnn_bwd_grid_bf16_smem if bf
            else lib.lfm_rnn_bwd_grid_smem)(code, H, n, rows)
    if smem < 0:
        raise ValueError(f"the {name} backward on the grid does not take "
                         f"hidden={H} with a group of {n} CTAs and {rows} "
                         f"rows")
    if smem != _grid_smem(cell, H, n, rows, dtype):
        raise RuntimeError(
            f"csrc/{src} counts {smem} bytes of shared memory, ops/rnn.py "
            f"{_grid_smem(cell, H, n, rows, dtype)}")
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"hidden={H} on a group of {n} CTAs needs {smem} "
                         f"bytes of shared memory per CTA, more than the "
                         f"card's {limit}")
    with torch.cuda.device(device):
        ctas = (lib.lfm_rnn_bwd_grid_bf16_ctas if bf
                else lib.lfm_rnn_bwd_grid_ctas)(code, H, n, rows)
    if ctas < n:
        raise RuntimeError(
            f"the card holds {ctas} CTAs of the {name} {cell} backward at "
            f"hidden={H} ({rows} rows, {smem} bytes of shared memory a CTA) "
            f"at once, fewer than a group of {n}")
    return ctas


def _launch_bwd_grid(cell: str, fused: bool, xin: torch.Tensor, wx, b,
                     wh: torch.Tensor, m: torch.Tensor, h_all: torch.Tensor,
                     c_all: Optional[torch.Tensor], dh: torch.Tensor,
                     forget_bias: float, xw: Optional[torch.Tensor] = None,
                     group: Optional[int] = None, rows: Optional[int] = None,
                     groups: Optional[int] = None,
                     stats: Optional[dict] = None):
    """One call of the backward on the grid, in ``xin``'s dtype: float32
    past Hp 384 (``csrc/rnn_bwd_tf32_grid.cu``, 3xTF32; fused: six kernel
    launches, or five given ``xw``; hoisted: four), bfloat16 past Hp 512
    (``csrc/rnn_bwd_grid.cu``; the same counts); counted once →
    fused: ``(dhin, dW_x, db, dW_h)``; hoisted (``xin`` is xw, ``wx`` and
    ``b`` None): ``(dxw, dW_h)``; the weight gradients in f32, dhin and dxw
    in the dtype. Seed-stacked operands (``xin`` 4-D, each operand of seed
    extent S or 1) run every seed in the same call and give each output
    per seed; the states are per seed. Fused, ``xw`` is the forward's f32
    xw scratch at this width (the 3xTF32 forward's in float32, the grid
    forward's in bf16): the kernels skip their own xw GEMM and overwrite it
    with d_xw. The group size and rows come from
    :func:`_grid_size` and :func:`_grid_rows` (``group``, ``rows`` override
    them), the groups from the CTAs the card holds at once
    (:func:`_grid_check`; ``groups`` overrides it: more than the card
    holds is refused, never run another way). A ``stats`` dict gets the
    launch's shape and ``"cycles"``, ``[CTAs, 2]`` int64 on the card: each
    CTA's SM cycles waiting at the group's barriers and in all (read after
    a synchronize); in bf16 also ``"kernels"``, the kernels the call
    launched, as the source counts them."""
    stacked = xin.dim() == 4
    if not stacked:
        xin, wh, m, h_all, dh = (t[None] for t in (xin, wh, m, h_all, dh))
        c_all = None if c_all is None else c_all[None]
        if fused:
            wx, b = wx[None], b[None]
    S = _seed_extent(xin, wx, b, wh, m, h_all, c_all, dh)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    G = _GATES[cell] * H
    dev = xin.device
    dtype = xin.dtype
    bf = dtype == torch.bfloat16
    f32 = torch.float32
    lib = _build.library()
    props = torch.cuda.get_device_properties(dev)
    limit, sms = (props.shared_memory_per_block_optin,
                  props.multi_processor_count)
    n = group or _grid_size(cell, H, limit, sms, dtype)
    if rows is None:
        rows = _grid_rows(cell, H, n, B, S, limit, sms, dtype)
    ctas = _grid_check(cell, H, n, rows, dev, dtype)
    if groups is None:
        groups = min(ctas // n, S * -(-B // rows))
    # The states are per seed: a shared one is copied out to every seed.
    h_all, c_all, dh = (
        None if t is None else t.expand(S, *t.shape[1:]).contiguous()
        for t in (h_all, c_all, dh))
    xin, wh, h_all, c_all, dh = (None if t is None else _aligned16(t)
                                 for t in (xin, wh, h_all, c_all, dh))
    if fused:
        wx, b = _aligned16(wx), _aligned16(b)
    keep = m.to(torch.uint8).contiguous()
    dgx = (torch.empty((S, B, T, G), dtype=f32, device=dev) if xw is None
           else xw.view(S, B, T, G))
    dhn = (torch.empty((S, B, T, H), dtype=f32, device=dev)
           if cell == "gru" else None)
    total = 2 * H * G + G if fused else H * G
    slices = _tf32_slices(B * T, total)
    partial = torch.empty((S, slices, total), dtype=f32, device=dev)
    dw = torch.empty((S, total), dtype=f32, device=dev)
    if bf:
        dx = torch.empty((S, B, T, H if fused else G), dtype=dtype,
                         device=dev)
    else:
        dx = torch.empty((S, B, T, H), dtype=f32, device=dev) if fused else None
    sync = torch.zeros(max(groups, 1), dtype=torch.int32, device=dev)
    cycles = None
    if stats is not None:
        cycles = torch.zeros((groups * n, 2), dtype=torch.int64, device=dev)
        stats.update(group=n, rows=rows, groups=groups, ctas_at_once=ctas,
                     cycles=cycles)
    ptr = (lambda t: None if t is None else t.data_ptr())
    strides = (_stride(xin, S), 0 if wx is None else _stride(wx, S),
               0 if b is None else _stride(b, S), _stride(wh, S),
               _stride(keep, S))
    # 0 hoisted, 1 fused, 2 fused on the forward's xw (its GEMM skipped).
    mode = 0 if not fused else 1 if xw is None else 2
    with torch.cuda.device(dev):
        if bf:
            # The exchange: per group, two buffers of d_hw's hi and lo.
            xch = torch.empty((max(groups, 1), 2, 2, rows, G), dtype=dtype,
                              device=dev)
            kernels = ctypes.c_int(0)
            err = lib.lfm_rnn_bwd_grid_bf16(
                _CELL_CODE[cell], mode, xin.data_ptr(), ptr(wx),
                ptr(b), wh.data_ptr(), keep.data_ptr(), h_all.data_ptr(),
                ptr(c_all), dh.data_ptr(), dx.data_ptr(), dgx.data_ptr(),
                ptr(dhn), xch.data_ptr(), partial.data_ptr(), slices,
                dw.data_ptr(), sync.data_ptr(), ptr(cycles), S, B, T, H, n,
                rows, groups, *strides, float(forget_bias),
                ctypes.byref(kernels), _build.stream_of(xin))
            if stats is not None:
                stats["kernels"] = kernels.value
        else:
            err = lib.lfm_rnn_bwd_tf32_grid(
                _CELL_CODE[cell], mode,
                xin.data_ptr(), ptr(wx), ptr(b), wh.data_ptr(),
                keep.data_ptr(), h_all.data_ptr(), ptr(c_all),
                dh.data_ptr(), ptr(dx), dgx.data_ptr(), ptr(dhn),
                partial.data_ptr(), slices, dw.data_ptr(), sync.data_ptr(),
                ptr(cycles), S, B, T, H, n, rows, groups, *strides,
                float(forget_bias), _build.stream_of(xin))
    name = (f"rnn_{'fused_' if fused else ''}bwd_grid_"
            f"{'bf16_' if bf else ''}{cell}")
    _build.check(lib, err, f"{name} (hidden={H}, {groups} groups of {n} "
                           f"CTAs, {rows} rows, {ctas} CTAs at once)")
    _build.count_launch(name)
    if fused:
        hg = H * G
        out = (dx, dw[:, :hg].view(S, H, G), dw[:, hg:hg + G],
               dw[:, hg + G:].view(S, H, G))
    else:
        out = (dx if bf else dgx, dw.view(S, H, G))
    return out if stacked else tuple(t[0] for t in out)


# ---------------------------------------------------------------------------
# The bfloat16 forward past hidden 512 (csrc/rnn_fwd_grid.cu)
# ---------------------------------------------------------------------------


def _fwd_grid_smem(cell: str, Hp: int, n: int, rows: int) -> int:
    """Shared memory (bytes) of a CTA of the grid forward's recurrence, as
    ``fwd_grid_smem_bytes`` counts it in ``csrc/rnn_fwd_grid.cu``: the W_h
    columns of its units across the G gates, one row of Hp k-values each
    ([G 8 NC][Hp + 8], NC = :func:`_grid_chunks`), and
    :data:`GRID_STAGES` stages of the h tile [rows][:data:`GRID_STAGE_K` +
    8], bf16."""
    NC = _grid_chunks(Hp, n)
    return 2 * (_GATES[cell] * MMA_UNITS * NC * (Hp + 8)
                + GRID_STAGES * rows * (GRID_STAGE_K + 8))


def _fwd_grid_size(cell: str, Hp: int, limit: int, sms: int) -> int:
    """CTAs a group of the grid forward: the fewest, at most ``sms``, whose
    columns of W_h fit beside the 64-row stages in ``limit`` bytes of
    shared memory a CTA within the thread limit (the backward's rule,
    :func:`_grid_size`, on the forward's count). Raises, naming the width,
    where none does. On an H100: the LSTM and the GRU 17 at 528 and 544 (4
    chunks, the thread limit), 20 at 640, the LSTM 43 at 1024 (3 chunks)
    and the GRU 32, both 95 at 1520 (2 chunks)."""
    for n in range(1, min(Hp // MMA_UNITS, sms) + 1):
        if (_grid_takes(Hp, n, 64, torch.bfloat16)
                and _fwd_grid_smem(cell, Hp, n, 64) <= limit):
            return n
    raise ValueError(
        f"the bfloat16 {cell} forward on the grid does not take "
        f"hidden={Hp}: no group of at most {sms} CTAs holds its W_h within "
        f"{limit} bytes of shared memory a CTA, or the width is outside "
        f"128 < Hp <= {BF16_GRID_MAX_WIDTH}")


def _fwd_grid_rows(cell: str, Hp: int, n: int, B: int, S: int, limit: int,
                   sms: int) -> int:
    """Batch rows per work item of the grid forward: 128 where the kernel
    takes them at this group size, they fit ``limit`` and the S ceil(B /
    128) items still occupy every group the card holds, else 64 (the
    backward's rule, :func:`_grid_rows`); a row's sums do not depend on
    the count."""
    if (_grid_takes(Hp, n, 128, torch.bfloat16)
            and _fwd_grid_smem(cell, Hp, n, 128) <= limit
            and S * -(-B // 128) >= sms // n):
        return 128
    return 64


@functools.lru_cache(maxsize=None)
def _fwd_grid_check(cell: str, fused: bool, H: int, n: int, rows: int,
                    device: torch.device) -> int:
    """Once per shape, form and card: ``csrc/rnn_fwd_grid.cu`` takes it and
    counts the shared memory :func:`_fwd_grid_smem` counts, it fits the
    card, and the card holds a whole group at once → the CTAs it holds at
    once. Raises, naming the width and the group, where not."""
    lib = _build.library()
    code = _CELL_CODE[cell]
    smem = lib.lfm_rnn_fwd_grid_smem(code, H, n, rows)
    if smem < 0:
        raise ValueError(f"the bfloat16 forward on the grid does not take "
                         f"hidden={H} with a group of {n} CTAs and {rows} "
                         f"rows")
    if smem != _fwd_grid_smem(cell, H, n, rows):
        raise RuntimeError(
            f"csrc/rnn_fwd_grid.cu counts {smem} bytes of shared memory, "
            f"ops/rnn.py {_fwd_grid_smem(cell, H, n, rows)}")
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"hidden={H} on a group of {n} CTAs needs {smem} "
                         f"bytes of shared memory per CTA, more than the "
                         f"card's {limit}")
    with torch.cuda.device(device):
        ctas = lib.lfm_rnn_fwd_grid_ctas(code, int(fused), H, n, rows)
    if ctas < n:
        raise RuntimeError(
            f"the card holds {ctas} CTAs of the bfloat16 {cell} forward at "
            f"hidden={H} ({rows} rows, {smem} bytes of shared memory a CTA) "
            f"at once, fewer than a group of {n}")
    return ctas


def _launch_fwd_grid(cell: str, fused: bool, xin: torch.Tensor, wx, b,
                     wh: torch.Tensor, m: torch.Tensor, forget_bias: float,
                     save_c: bool, keep_xw: bool = False,
                     group: Optional[int] = None, rows: Optional[int] = None,
                     groups: Optional[int] = None,
                     stats: Optional[dict] = None):
    """One call of the bfloat16 forward past hidden 512
    (``csrc/rnn_fwd_grid.cu``; fused: the xw GEMM and the grid recurrence,
    hoisted: the recurrence; counted once) → ``(h_all, c_all or None)``,
    and fused with ``keep_xw`` also the f32 xw scratch ``[S, B, T, G H]``,
    which the grid backward takes as its d_gates buffer (None hoisted).
    Fused, ``xin`` is hin and ``wx``, ``b`` are used; hoisted, ``xin`` is
    xw (``wx``, ``b`` None). Seed-stacked operands (``xin`` 4-D, each of
    seed extent S or 1) run every seed in the same call → ``[S, B, T,
    H]``. The group size and rows come from :func:`_fwd_grid_size` and
    :func:`_fwd_grid_rows` (``group``, ``rows`` override them), the groups
    from the CTAs the card holds at once (:func:`_fwd_grid_check`;
    ``groups`` overrides it: more than the card holds is refused before
    any launch, never run another way). A ``stats`` dict gets the launch's
    shape, ``"kernels"`` (the kernels the call launched, as the source
    counts them) and ``"cycles"``, ``[CTAs, 2]`` int64 on the card: each
    CTA's SM cycles waiting at the group's barriers and in all (read after
    a synchronize)."""
    if xin.dtype != torch.bfloat16:
        raise ValueError(f"the forward on the grid takes bfloat16, got "
                         f"{xin.dtype}")
    stacked = xin.dim() == 4
    if not stacked:
        xin, wh, m = xin[None], wh[None], m[None]
        if fused:
            wx, b = wx[None], b[None]
    S = _seed_extent(xin, wx, b, wh, m)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    dev = xin.device
    props = torch.cuda.get_device_properties(dev)
    limit, sms = (props.shared_memory_per_block_optin,
                  props.multi_processor_count)
    n = group or _fwd_grid_size(cell, H, limit, sms)
    if rows is None:
        rows = _fwd_grid_rows(cell, H, n, B, S, limit, sms)
    ctas = _fwd_grid_check(cell, fused, H, n, rows, dev)
    if groups is None:
        groups = min(ctas // n, S * -(-B // rows))
    lib = _build.library()
    xin, wh = _aligned16(xin), _aligned16(wh)
    if fused:
        wx, b = _aligned16(wx), _aligned16(b)
    keep = _keep(m)
    h = torch.empty((S, B, T, H), dtype=xin.dtype, device=dev)
    c = torch.empty_like(h) if save_c and cell == "lstm" else None
    xw = (torch.empty((S, B, T, _GATES[cell] * H), dtype=torch.float32,
                      device=dev) if fused else None)
    sync = torch.zeros(max(groups, 1), dtype=torch.int32, device=dev)
    cycles = None
    if stats is not None:
        cycles = torch.zeros((groups * n, 2), dtype=torch.int64, device=dev)
        stats.update(group=n, rows=rows, groups=groups, ctas_at_once=ctas,
                     cycles=cycles)
    ptr = (lambda t: None if t is None else t.data_ptr())
    kernels = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_fwd_grid(
            _CELL_CODE[cell], int(fused), xin.data_ptr(), ptr(wx), ptr(b),
            wh.data_ptr(), keep.data_ptr(), h.data_ptr(), ptr(c), ptr(xw),
            sync.data_ptr(), ptr(cycles), S, B, T, H, n, rows, groups,
            _stride(xin, S), 0 if wx is None else _stride(wx, S),
            0 if b is None else _stride(b, S), _stride(wh, S),
            _stride(keep, S), float(forget_bias), ctypes.byref(kernels),
            _build.stream_of(xin))
    if stats is not None:
        stats["kernels"] = kernels.value
    name = f"rnn_{'fused_' if fused else ''}fwd_grid_bf16_{cell}"
    _build.check(lib, err, f"{name} (hidden={H}, {groups} groups of {n} "
                           f"CTAs, {rows} rows, {ctas} CTAs at once)")
    _build.count_launch(name)
    out = (h, c, xw) if keep_xw else (h, c)
    return out if stacked else tuple(None if t is None else t[0]
                                     for t in out)


# ---------------------------------------------------------------------------
# The bfloat16 forward above hidden 128 (csrc/rnn_fwd_cluster.cu)
# ---------------------------------------------------------------------------

#: CTAs per cluster and batch rows per cluster the bfloat16 forward above
#: 128 is built for, and its threads per CTA at most by rows
#: (``max_threads`` in ``csrc/rnn_fwd_cluster.cu``: the registers of the
#: rows' gate sums and xw_t).
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER_ROWS = (16, 32)
CLUSTER_MAX_THREADS = {16: 512, 32: 384}


def _cluster_warps(Hp: int, C: int) -> int:
    """Warps per CTA (:data:`MMA_UNITS` units each) when ``Hp`` units split
    over ``C`` CTAs: ceil(Hp / 8 / C). The W = Hp / 8 warps of units are
    dealt out evenly (:func:`_cluster_units`), so a CTA may own one fewer
    (its last warp idle but for the barriers)."""
    return -(-(Hp // MMA_UNITS) // C)


def _cluster_units(Hp: int, C: int, j: int) -> range:
    """The hidden units CTA ``j`` of a cluster of ``C`` owns: warps
    ``[j W / C, (j + 1) W / C)`` (floor) of ``W = Hp / 8``, 8 units each."""
    W = Hp // MMA_UNITS
    return range(j * W // C * MMA_UNITS, (j + 1) * W // C * MMA_UNITS)


def _cluster_takes(Hp: int, C: int, rows: int) -> bool:
    """The shapes ``csrc/rnn_fwd_cluster.cu`` takes (its ``supported``):
    128 < Hp <= :data:`CLUSTER_MAX_WIDTH`, Hp % 16 == 0, C and rows of
    :data:`CLUSTER_SIZES` and :data:`CLUSTER_ROWS`, the CTA's threads
    within the rows' limit."""
    if not (128 < Hp <= CLUSTER_MAX_WIDTH and Hp % 16 == 0):
        return False
    if C not in CLUSTER_SIZES or rows not in CLUSTER_ROWS:
        return False
    return _cluster_warps(Hp, C) * 32 <= CLUSTER_MAX_THREADS[rows]


def _cluster_smem(cell: str, Hp: int, C: int, rows: int) -> int:
    """Shared memory (bytes) of a CTA of the cluster recurrence, as
    ``recur_smem_bytes`` counts it in the source: its share of W_h, [Hp,
    G U] bf16 with U = 8 :func:`_cluster_warps`, and two h tiles [rows, Hp
    + 8] bf16."""
    U = MMA_UNITS * _cluster_warps(Hp, C)
    return Hp * _GATES[cell] * U * 2 + 2 * rows * (Hp + 8) * 2


def _cluster_size(cell: str, Hp: int, limit: int) -> int:
    """CTAs per cluster of the bf16 forward at padded width ``Hp``: the
    fewest of :data:`CLUSTER_SIZES` whose share of W_h fits beside two
    16-row h tiles in ``limit`` bytes of shared memory per block. Raises,
    naming the width, where none does.

    Measured (``scripts/torch_cluster_variants.py``, H100 80GB HBM3,
    700 W; B 2048, T 60, both forms, both cells, H 256, 320, 512; PERF.md
    §6): at every width the fewest CTAs that fit were the fastest
    at their best rows, by 6-137% over the next size (the LSTM at H 256:
    4 CTAs 1.176 ms for row 1, 8 CTAs 1.247, 16 CTAs 1.661): fewer CTAs
    all-gather less through distributed shared memory, wait at a smaller
    barrier, and more clusters fit on the card at once (30 of 4, 7 of
    16)."""
    for C in CLUSTER_SIZES:
        if (_cluster_takes(Hp, C, 16)
                and _cluster_smem(cell, Hp, C, 16) <= limit):
            return C
    raise ValueError(
        f"the bfloat16 {cell} forward on a cluster does not take hidden="
        f"{Hp}: no cluster of {CLUSTER_SIZES} CTAs holds its W_h share "
        f"beside the h tiles within {limit} bytes of shared memory per "
        f"block, or the width is past {CLUSTER_MAX_WIDTH}")


def _cluster_rows(cell: str, Hp: int, C: int, B: int, S: int, limit: int,
                  sms: int) -> int:
    """Batch rows per cluster: 32 where its tiles fit beside the W_h share
    in ``limit`` bytes, the CTA stays within its thread limit, and the
    launch still gives at least half the ``sms`` SMs a CTA (``2 C S
    ceil(B / 32) >= sms``, the rule of :func:`_mma_rows`); else 16. 32 rows
    give each warp two row tiles of independent products; measured (as
    :func:`_cluster_size`) 32 rows beat 16 wherever they fit (the LSTM at
    H 256, row 1: 1.176 against 1.280 ms; at H 512 4.220 against 5.338);
    a 64-row form beat 32 rows nowhere (at H 256 its 32 clusters take two
    waves of the 30 the card holds) and was taken out."""
    if (_cluster_takes(Hp, C, 32) and _cluster_smem(cell, Hp, C, 32) <= limit
            and 2 * C * S * -(-B // 32) >= sms):
        return 32
    return 16


@functools.lru_cache(maxsize=32)
def _cluster_fragment_index(H: int, G: int, Hp: int, C: int,
                            device=None) -> torch.Tensor:
    """Flat indices into ``w [H, G H]`` with one zero appended (index ``H G
    H``) of W_h packed for a cluster of ``C`` CTAs at padded width ``Hp``:
    ``C`` slices, one a CTA, each ``[Hp/16 k-steps][NW warps][G n8
    tiles][32 lanes][4]`` (``NW`` = :func:`_cluster_warps`). Warp w of CTA
    j owns the units ``u0 .. u0 + 7`` from ``u0`` = its w-th of
    :func:`_cluster_units` with all G gates, and lane l holds the m16n8k16
    B fragment ``W[k0 + 2 (l % 4) + {0, 1, 8, 9}][q Hp + u0 + l // 4]``
    (the layout of :func:`_fragment_index`). A place past H (the
    padding's rows and units) or of an idle warp points at the zero."""
    NW, KT = _cluster_warps(Hp, C), Hp // 16

    def axis(n, d):
        shape = [1] * 6
        shape[d] = n
        return torch.arange(n, device=device).view(shape)

    j, kk, w, q = axis(C, 0), axis(KT, 1), axis(NW, 2), axis(G, 3)
    lane, v = axis(32, 4), axis(4, 5)
    W = Hp // MMA_UNITS
    first, nxt = j * W // C, (j + 1) * W // C  # the CTA's warps
    k = kk * 16 + 2 * (lane % 4) + v % 2 + 8 * (v // 2)
    u = (first + w) * MMA_UNITS + lane // 4
    real = (k < H) & (u < H) & (first + w < nxt)
    return torch.where(real, k * G * H + q * H + u, H * G * H).reshape(-1)


def pack_cluster(w: torch.Tensor, C: int,
                 width: Optional[int] = None) -> torch.Tensor:
    """``w [H, G*H]`` → W_h packed for the cluster forward
    (:func:`_cluster_fragment_index`): ``C`` equal slices, CTA j's holding
    exactly its units' G gate columns in fragment order; flat, same dtype,
    a new tensor. A seed-stacked ``w [S, H, G*H]`` is packed per seed →
    ``[S, n]``. ``width`` Hp > H packs ``w`` zero-padded per gate block
    (:func:`padded_launch`) in the same gather."""
    H, cols = w.shape[-2:]
    flat = torch.nn.functional.pad(w.reshape(*w.shape[:-2], -1), (0, 1))
    idx = _cluster_fragment_index(H, cols // H, width or H, C, w.device)
    return flat[..., idx]


@functools.lru_cache(maxsize=None)
def _cluster_check(cell: str, fused: bool, Hp: int, C: int, rows: int,
                   device: torch.device) -> int:
    """Once per shape and card: the source counts the shared memory
    :func:`_cluster_smem` counts, it fits the card, and the card holds at
    least one such cluster (``cudaOccupancyMaxActiveClusters``) → the
    clusters it holds at once. Raises, naming the width and the cluster
    size, where not: the launch is refused, and nothing else runs it."""
    lib = _build.library()
    smem = lib.lfm_rnn_fwd_cluster_smem(_CELL_CODE[cell], Hp, C, rows)
    if smem < 0:
        raise ValueError(f"the bfloat16 forward on a cluster does not take "
                         f"hidden={Hp} with a cluster of {C} CTAs and {rows} "
                         f"rows")
    if smem != _cluster_smem(cell, Hp, C, rows):
        raise RuntimeError(
            f"csrc/rnn_fwd_cluster.cu counts {smem} bytes of shared memory, "
            f"ops/rnn.py {_cluster_smem(cell, Hp, C, rows)}")
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"hidden={Hp} on a cluster of {C} CTAs needs {smem} "
                         f"bytes of shared memory per CTA, more than the "
                         f"card's {limit}")
    with torch.cuda.device(device):
        n = lib.lfm_rnn_fwd_cluster_clusters(_CELL_CODE[cell], int(fused),
                                             Hp, C, rows)
    if n < 1:
        raise RuntimeError(
            f"the card holds no cluster of {C} CTAs of the bfloat16 {cell} "
            f"forward at hidden={Hp} ({rows} rows, {smem} bytes of shared "
            f"memory a CTA): cudaOccupancyMaxActiveClusters gave {n}")
    return n


def _launch_fwd_cluster(cell: str, fused: bool, xin: torch.Tensor, wx, b,
                        wh: torch.Tensor, m: torch.Tensor, forget_bias: float,
                        save_c: bool, packed: Optional[torch.Tensor] = None,
                        cluster: Optional[int] = None,
                        rows: Optional[int] = None, keep_xw: bool = False):
    """One call of the bfloat16 forward above hidden 128
    (``csrc/rnn_fwd_cluster.cu``; fused: the xw GEMM and the cluster
    recurrence, hoisted: the recurrence; counted once) → ``(h_all, c_all
    or None)``, and fused with ``keep_xw`` also the f32 xw scratch, which
    the cluster backward takes as its d_gates buffer (None hoisted).
    Fused, ``xin`` is hin and ``wx``, ``b`` are used; hoisted,
    ``xin`` is xw (``wx``, ``b`` None). Seed-stacked operands (``xin`` 4-D,
    each operand of seed extent S or 1) run every seed in the same call →
    ``[S, B, T, H]``. ``packed``: ``pack_cluster(wh, C)`` when the caller
    has it; ``cluster`` and ``rows`` override :func:`_cluster_size` and
    :func:`_cluster_rows`. A cluster the card cannot hold raises
    (:func:`_cluster_check`). The wrapper allocates the outputs and, fused,
    the xw scratch ``[S, B, T, G H]`` f32 (xw is never rounded to bf16)."""
    stacked = xin.dim() == 4
    if not stacked:
        xin, wh, m = xin[None], wh[None], m[None]
        if fused:
            wx, b = wx[None], b[None]
        if packed is not None:
            packed = packed[None]
    S = _seed_extent(xin, wx, b, wh, m)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    dev = xin.device
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    C = cluster or _cluster_size(cell, H, limit)
    if rows is None:
        rows = _cluster_rows(cell, H, C, B, S, limit,
                             props.multi_processor_count)
    _cluster_check(cell, fused, H, C, rows, dev)
    lib = _build.library()
    whp = pack_cluster(wh, C) if packed is None else packed
    xin = _aligned16(xin)
    if fused:
        wx = _aligned16(wx)
    keep = _keep(m)
    h = torch.empty((S, B, T, H), dtype=xin.dtype, device=dev)
    c = torch.empty_like(h) if save_c and cell == "lstm" else None
    xw = (torch.empty((S, B, T, _GATES[cell] * H), dtype=torch.float32,
                      device=dev) if fused else None)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_fwd_cluster(
            _CELL_CODE[cell], int(fused), xin.data_ptr(), ptr(wx), ptr(b),
            whp.data_ptr(), keep.data_ptr(), h.data_ptr(), ptr(c), ptr(xw),
            S, B, T, H, C, rows, _stride(xin, S),
            0 if wx is None else _stride(wx, S),
            0 if b is None else _stride(b, S), _stride(whp, S),
            _stride(keep, S), float(forget_bias), _build.stream_of(xin))
    name = f"rnn_{'fused_' if fused else ''}fwd_cluster_{cell}"
    _build.check(lib, err, f"{name} (hidden={H}, cluster of {C}, {rows} rows)")
    _build.count_launch(name)
    out = (h, c, xw) if keep_xw else (h, c)
    return out if stacked else tuple(None if t is None else t[0]
                                     for t in out)


# ---------------------------------------------------------------------------
# The bfloat16 backward above hidden 128 (csrc/rnn_bwd_cluster.cu)
# ---------------------------------------------------------------------------

#: Threads per CTA at most of the cluster backward's recurrence, by rows
#: per cluster (``max_threads`` in ``csrc/rnn_bwd_cluster.cu``: the
#: registers of the recompute's sums, the carries, xw_t and the carry
#: product's chunks).
CLUSTER_BWD_MAX_THREADS = {16: 384, 32: 256}


def _cluster_bwd_takes(Hp: int, C: int, rows: int) -> bool:
    """The shapes ``csrc/rnn_bwd_cluster.cu`` takes (its ``supported``):
    128 < Hp <= :data:`CLUSTER_MAX_WIDTH`, Hp % 16 == 0, C and rows of
    :data:`CLUSTER_SIZES` and :data:`CLUSTER_ROWS`, the CTA's threads
    within the rows' limit (:data:`CLUSTER_BWD_MAX_THREADS`)."""
    if not (128 < Hp <= CLUSTER_MAX_WIDTH and Hp % 16 == 0):
        return False
    if C not in CLUSTER_SIZES or rows not in CLUSTER_ROWS:
        return False
    return _cluster_warps(Hp, C) * 32 <= CLUSTER_BWD_MAX_THREADS[rows]


def _cluster_share_cols(cell: str, Hp: int, C: int) -> int:
    """Columns of a CTA's W_h share in the cluster backward: G U (U = 8
    :func:`_cluster_warps`, gate q's units at columns ``q U ..``) rounded
    up to a multiple of 16 (the carry's product steps k by 16)."""
    return 16 * -(-_GATES[cell] * MMA_UNITS * _cluster_warps(Hp, C) // 16)


def _cluster_bwd_smem(cell: str, Hp: int, C: int, rows: int) -> int:
    """Shared memory (bytes) of a CTA of the cluster backward's recurrence,
    as ``recur_smem_bytes`` counts it in the source: the W_h share [Hp,
    GUP + 8] bf16 (GUP :func:`_cluster_share_cols`), two h tiles [rows,
    Hp + 8] bf16, the d_hw hi and lo tiles [rows, GUP + 8] bf16 and the
    single receive buffer of the reduce-scatter [C][rows][LR] f32, LR = 8
    NW rounded up to an odd multiple of 8 (NW :func:`_cluster_warps`)."""
    LW = _cluster_share_cols(cell, Hp, C) + 8
    LR = MMA_UNITS * (_cluster_warps(Hp, C) | 1)
    return (Hp * LW * 2 + 2 * rows * (Hp + 8) * 2 + 2 * rows * LW * 2
            + C * rows * LR * 4)


def _cluster_bwd_size(cell: str, Hp: int, limit: int) -> int:
    """CTAs per cluster of the bf16 backward at padded width ``Hp``: the
    fewest of :data:`CLUSTER_SIZES` that the kernel takes at 16 rows and
    whose shared memory (:func:`_cluster_bwd_smem`) fits ``limit`` bytes
    per block. The backward holds more beside its share than the forward
    (the d tiles and the receive buffer), so its sizes differ: on an H100
    the LSTM takes 2 CTAs to Hp 192, 4 to 288, 8 to 384 and 16 above, the
    GRU 2 to 192, 4 to 320, 8 to 432 and 16 above. Measured
    (``scripts/torch_cluster_variants.py --direction bwd``, H100 80GB
    HBM3, 700 W; B 2048, T 60, H 256, 320, 512; PERF.md §6): with
    :func:`_cluster_bwd_rows` within 1% of the fastest pair at every width
    but the LSTM at H 256, where 8 CTAs x 16 rows tie or lead by up to 5%.
    Raises, naming the width, where none fits."""
    for C in CLUSTER_SIZES:
        if (_cluster_bwd_takes(Hp, C, 16)
                and _cluster_bwd_smem(cell, Hp, C, 16) <= limit):
            return C
    raise ValueError(
        f"the bfloat16 {cell} backward on a cluster does not take hidden="
        f"{Hp}: no cluster of {CLUSTER_SIZES} CTAs holds its W_h share "
        f"beside the tiles and the receive buffer within {limit} bytes of "
        f"shared memory per block, or the width is past {CLUSTER_MAX_WIDTH}")


def _cluster_bwd_rows(cell: str, Hp: int, C: int, B: int, S: int,
                      limit: int, sms: int) -> int:
    """Batch rows per cluster of the backward: 32 where the kernel takes
    them (the CTA within 256 threads), its shared memory fits ``limit``
    and the launch still gives at least half the ``sms`` SMs a CTA (``2 C
    S ceil(B / 32) >= sms``, the forward's rule); else 16."""
    if (_cluster_bwd_takes(Hp, C, 32)
            and _cluster_bwd_smem(cell, Hp, C, 32) <= limit
            and 2 * C * S * -(-B // 32) >= sms):
        return 32
    return 16


@functools.lru_cache(maxsize=32)
def _cluster_bwd_index(H: int, G: int, Hp: int, C: int,
                       device=None) -> torch.Tensor:
    """Flat indices into ``w [H, G H]`` with one zero appended (index ``H G
    H``) of W_h packed for the cluster backward at padded width ``Hp``:
    ``C`` slices ``[Hp][GUP]`` (:func:`_cluster_share_cols`), row-major, one
    a CTA. Column ``q U + i`` of CTA j's slice is gate q of its i-th unit
    (:func:`_cluster_units`; ``U`` = 8 :func:`_cluster_warps`), so row k is
    ``W_h[k, q Hp + u]`` over the CTA's units u. A place past H (the
    padding's rows and units), of an idle warp's units or past G U points
    at the zero."""
    NW = _cluster_warps(Hp, C)
    U = MMA_UNITS * NW
    GUP = 16 * -(-G * U // 16)
    W = Hp // MMA_UNITS
    j = torch.arange(C, device=device).view(C, 1, 1)
    k = torch.arange(Hp, device=device).view(1, Hp, 1)
    col = torch.arange(GUP, device=device).view(1, 1, GUP)
    q, i = col // U, col % U
    first, nxt = j * W // C, (j + 1) * W // C  # the CTA's warps
    u = first * MMA_UNITS + i
    real = (q < G) & (k < H) & (u < H) & (i < (nxt - first) * MMA_UNITS)
    return torch.where(real, k * G * H + q * H + u, H * G * H).reshape(-1)


def pack_cluster_bwd(w: torch.Tensor, C: int,
                     width: Optional[int] = None) -> torch.Tensor:
    """``w [H, G*H]`` → W_h packed for the cluster backward
    (:func:`_cluster_bwd_index`): ``C`` equal row-major slices, CTA j's
    holding exactly its units' G gate columns for every row; flat, same
    dtype, a new tensor. A seed-stacked ``w [S, H, G*H]`` is packed per
    seed → ``[S, n]``. ``width`` Hp > H packs ``w`` zero-padded per gate
    block (:func:`padded_launch`) in the same gather."""
    H, cols = w.shape[-2:]
    flat = torch.nn.functional.pad(w.reshape(*w.shape[:-2], -1), (0, 1))
    return flat[..., _cluster_bwd_index(H, cols // H, width or H, C,
                                        w.device)]


@functools.lru_cache(maxsize=None)
def _cluster_bwd_check(cell: str, fused: bool, Hp: int, C: int, rows: int,
                       device: torch.device) -> int:
    """Once per shape and card: the source counts the shared memory
    :func:`_cluster_bwd_smem` counts, it fits the card, and the card holds
    at least one such cluster (``cudaOccupancyMaxActiveClusters``) → the
    clusters it holds at once. Raises, naming the width and the cluster
    size, where not: the launch is refused, and nothing else runs it."""
    lib = _build.library()
    smem = lib.lfm_rnn_bwd_cluster_smem(_CELL_CODE[cell], Hp, C, rows)
    if smem < 0:
        raise ValueError(f"the bfloat16 backward on a cluster does not take "
                         f"hidden={Hp} with a cluster of {C} CTAs and {rows} "
                         f"rows")
    if smem != _cluster_bwd_smem(cell, Hp, C, rows):
        raise RuntimeError(
            f"csrc/rnn_bwd_cluster.cu counts {smem} bytes of shared memory, "
            f"ops/rnn.py {_cluster_bwd_smem(cell, Hp, C, rows)}")
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"hidden={Hp} on a cluster of {C} CTAs needs {smem} "
                         f"bytes of shared memory per CTA, more than the "
                         f"card's {limit}")
    with torch.cuda.device(device):
        n = lib.lfm_rnn_bwd_cluster_clusters(_CELL_CODE[cell], int(fused),
                                             Hp, C, rows)
    if n < 1:
        raise RuntimeError(
            f"the card holds no cluster of {C} CTAs of the bfloat16 {cell} "
            f"backward at hidden={Hp} ({rows} rows, {smem} bytes of shared "
            f"memory a CTA): cudaOccupancyMaxActiveClusters gave {n}")
    return n


def _launch_bwd_cluster(cell: str, fused: bool, xin: torch.Tensor, wx, b,
                        wh: torch.Tensor, m: torch.Tensor, h_all: torch.Tensor,
                        c_all: Optional[torch.Tensor], dh: torch.Tensor,
                        forget_bias: float, xw: Optional[torch.Tensor] = None,
                        cluster: Optional[int] = None,
                        rows: Optional[int] = None):
    """One call of the bfloat16 backward above hidden 128
    (``csrc/rnn_bwd_cluster.cu``; fused: the xw GEMM unless ``xw`` is
    given, the cluster recurrence, the weight gradients and dhin; hoisted:
    the recurrence and dW_h; counted once) → fused: ``(dhin, dW_x, db,
    dW_h)``; hoisted (``xin`` is xw, ``wx`` and ``b`` None): ``(dxw,
    dW_h)``; dhin and dxw in bf16, the weight gradients in f32.
    Seed-stacked operands (``xin`` 4-D, each operand of seed extent S or 1)
    run every seed in the same call and give each output per seed; the
    states ``h_all``, ``c_all`` and ``dh`` are per seed. Fused, ``xw`` is
    the cluster forward's f32 xw scratch (``[S, B, T, G H]`` or ``[B, T,
    G H]``): the call skips its xw GEMM and overwrites the scratch with
    d_xw. W_h is packed per CTA (:func:`pack_cluster_bwd`) once a call;
    ``cluster`` and ``rows`` override :func:`_cluster_bwd_size` and
    :func:`_cluster_bwd_rows`. A cluster the card cannot hold raises
    (:func:`_cluster_bwd_check`)."""
    stacked = xin.dim() == 4
    if not stacked:
        xin, wh, m, h_all, dh = (t[None] for t in (xin, wh, m, h_all, dh))
        c_all = None if c_all is None else c_all[None]
        if fused:
            wx, b = wx[None], b[None]
    S = _seed_extent(xin, wx, b, wh, m, h_all, c_all, dh)
    B, T = m.shape[-2:]
    H = wh.shape[-2]
    G = _GATES[cell] * H
    dev = xin.device
    f32 = torch.float32
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    C = cluster or _cluster_bwd_size(cell, H, limit)
    if rows is None:
        rows = _cluster_bwd_rows(cell, H, C, B, S, limit,
                                 props.multi_processor_count)
    _cluster_bwd_check(cell, fused, H, C, rows, dev)
    lib = _build.library()
    whp = pack_cluster_bwd(wh, C)
    # The states are per seed: a shared one is copied out to every seed.
    h_all, c_all, dh = (
        None if t is None else t.expand(S, *t.shape[1:]).contiguous()
        for t in (h_all, c_all, dh))
    xin, h_all, c_all, dh = (None if t is None else _aligned16(t)
                             for t in (xin, h_all, c_all, dh))
    if fused:
        wx = _aligned16(wx)
    keep = _keep(m)
    dgx = (torch.empty((S, B, T, G), dtype=f32, device=dev) if xw is None
           else xw.view(S, B, T, G))
    dhn = (torch.empty((S, B, T, H), dtype=f32, device=dev)
           if fused and cell == "gru" else None)
    slices = _slices(B * T)
    total = 2 * H * G + G if fused else H * G
    partial = torch.empty((S, slices, total), dtype=f32, device=dev)
    dw = torch.empty((S, total), dtype=f32, device=dev)
    dx = torch.empty((S, B, T, H if fused else G), dtype=xin.dtype,
                     device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.lfm_rnn_bwd_cluster(
            _CELL_CODE[cell], int(fused), xin.data_ptr(), ptr(wx), ptr(b),
            whp.data_ptr(), keep.data_ptr(), h_all.data_ptr(), ptr(c_all),
            dh.data_ptr(), dx.data_ptr(), dgx.data_ptr(), ptr(dhn),
            partial.data_ptr(), slices, dw.data_ptr(), S, B, T, H, C, rows,
            int(xw is not None), _stride(xin, S),
            0 if wx is None else _stride(wx, S),
            0 if b is None else _stride(b, S), _stride(whp, S),
            _stride(keep, S), float(forget_bias), _build.stream_of(xin))
    name = f"rnn_{'fused_' if fused else ''}bwd_cluster_{cell}"
    _build.check(lib, err, f"{name} (hidden={H}, cluster of {C}, {rows} rows)")
    _build.count_launch(name)
    if fused:
        hg = H * G
        out = (dx, dw[:, :hg].view(S, H, G), dw[:, hg:hg + G],
               dw[:, hg + G:].view(S, H, G))
    else:
        out = (dx, dw.view(S, H, G))
    return out if stacked else tuple(t[0] for t in out)


def _tensor_core_launcher(route: str, form: str):
    """The tensor-core launch of ``form`` (:data:`_PAD_FORMS`) on
    ``route`` ("mma", "tf32", "cluster" or "grid"), taking ``(cell,
    *operands, *rest, **kw)`` at a width the kernels take;
    :func:`padded_launch` wraps it. Looked up per call, so a launcher
    swapped on this module is the one run."""
    if route in ("cluster", "grid"):
        fwd = form in ("fused_fwd", "fwd")
        launch = ({"cluster": _launch_fwd_cluster, "grid": _launch_fwd_grid}
                  if fwd else {"cluster": _launch_bwd_cluster,
                               "grid": _launch_bwd_grid})[route]
        if form.startswith("fused"):
            return lambda cell, *a, **kw: launch(cell, True, *a, **kw)
        return lambda cell, xw, *a, **kw: launch(cell, False, xw, None, None,
                                                 *a, **kw)
    if route == "mma":
        return {"fused_fwd": _launch_fwd_mma, "fwd": _launch_scan_fwd_mma,
                "fused_bwd": _launch_bwd_mma,
                "bwd": _launch_scan_bwd_mma}[form]
    if form in ("fused_fwd", "fused_bwd"):
        launch = _launch_fwd_tf32 if form == "fused_fwd" else _launch_bwd_tf32
        return lambda cell, *a, **kw: launch(cell, True, *a, **kw)
    launch = _launch_fwd_tf32 if form == "fwd" else _launch_bwd_tf32
    return lambda cell, xw, *a, **kw: launch(cell, False, xw, None, None,
                                             *a, **kw)


def _fused_states(cell, hin, wx, b, wh, m, forget_bias, save_c,
                  packed=None, keep_xw=False):
    """The fused forward's states ``(h_all, c_all or None)`` on the route
    of :func:`_mma_route`; ``keep_xw`` → ``(h_all, c_all, xw)``, xw the
    3xTF32, cluster or grid route's f32 scratch at the padded width, which
    its backward reuses (None elsewhere). ``packed``: the bf16 tensor
    cores' weights at the padded width, W_x and W_h in fragment order
    (:func:`pack_fragments`) or, from 128 to 512, W_h packed per CTA
    (:func:`pack_cluster`)."""
    stacked = hin.dim() == 4
    if hin.device.type == "cpu":
        if stacked:
            out = _over_seeds(
                lambda *a: _fused_states(cell, *a, forget_bias, save_c),
                _seed_extent(hin, wx, b, wh, m), hin, wx, b, wh, m)
        else:
            xw = hin.float() @ wx.float() + b.float()
            h, c = rnn_scan_states(cell, xw, wh, m, forget_bias, save_c)
            out = h.to(hin.dtype), (None if c is None else c.to(hin.dtype))
    else:
        _check_card(hin, wx=wx, b=b, wh=wh, m=m)
        route = _mma_route(hin.dtype, wh.shape[-2])
        if route != "simt":
            # The 3xTF32, cluster and grid launches hand back their xw
            # scratch; the bf16 ones below 512 read prepacked weights.
            kw = {"tf32": dict(keep_xw=keep_xw),
                  "cluster": dict(packed=packed, keep_xw=keep_xw),
                  "grid": dict(keep_xw=keep_xw),
                  "mma": dict(packed=packed)}[route]
            out = padded_launch(_tensor_core_launcher(route, "fused_fwd"),
                                "fused_fwd")(cell, hin, wx, b, wh, m,
                                             forget_bias, save_c, **kw)
            return out if route != "mma" or not keep_xw else (*out, None)
        out = _launch_fwd(cell, False, hin, wx, b, wh, m, forget_bias,
                          save_c)
    return (*out, None) if keep_xw else out


def _scan_states_any(cell, xw, wh, m, forget_bias, save_c):
    """The hoisted forward's states ``(h_all, c_all or None)`` on the route
    of :func:`_mma_route`; seed-stacked operands (``xw`` 4-D) in one
    launch on the card, one seed at a time on the CPU."""
    if xw.device.type == "cpu":
        if xw.dim() == 4:
            return _over_seeds(
                lambda *a: rnn_scan_states(cell, *a, forget_bias, save_c),
                _seed_extent(xw, wh, m), xw, wh, m)
        return rnn_scan_states(cell, xw, wh, m, forget_bias, save_c)
    _check_card(xw, wh=wh, m=m)
    route = _mma_route(xw.dtype, wh.shape[-2])
    if route != "simt":
        return padded_launch(_tensor_core_launcher(route, "fwd"), "fwd")(
            cell, xw, wh, m, forget_bias, save_c)
    return _launch_fwd(cell, True, xw, None, None, wh, m, forget_bias,
                       save_c)


def rnn_scan_fused_bwd(cell: str, hin: torch.Tensor, wx: torch.Tensor,
                       b: torch.Tensor, wh: torch.Tensor, m: torch.Tensor,
                       h_all: torch.Tensor, c_all: Optional[torch.Tensor],
                       dh: torch.Tensor, forget_bias: float = 1.0,
                       wxp: Optional[torch.Tensor] = None,
                       xw: Optional[torch.Tensor] = None):
    """Backward of :func:`rnn_scan_fused` from its saved states →
    ``(dhin in hin.dtype, dW_x, db, dW_h in f32)``. ``dh`` is the upstream
    gradient of ``h_all``, in ``hin.dtype``. ``wxp``: ``pack_fragments
    (wx)`` when the forward built it (the tensor-core route reuses it).
    ``xw``: the 3xTF32, cluster or grid forward's f32 xw scratch
    (:func:`_fused_states`), which the backward on the same route takes,
    and overwrites with d_xw, in place of its own xw GEMM.
    Both are at the padded width (:func:`padded_launch`). Seed-stacked
    operands give every gradient per seed, ``[S, ...]``."""
    if hin.dim() == 4:
        S = _check_stacked(cell, hin, wx, b, wh, m, h_all, c_all, dh)
        if cell == "lstm" and c_all is None:
            raise ValueError("the LSTM backward needs the saved c_all")
        if hin.device.type == "cpu":
            return rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m,
                                                h_all, c_all, dh, forget_bias)
        _check_card(hin, wx=wx, b=b, wh=wh, m=m, h_all=h_all, c_all=c_all,
                    dh=dh)
        route = _mma_route(hin.dtype, hin.shape[-1], "bwd")
        if route != "simt":
            return _fused_bwd_on(route, cell, hin, wx, b, wh, m, h_all,
                                 c_all, dh, forget_bias, wxp, xw)
        return _launch_bwd(cell, True, hin, wx, b, wh, m, h_all, c_all, dh,
                           forget_bias)
    B, T, H = hin.shape
    _check_shapes(cell, B, T, H, m, wh, wx, b)
    _check_states(cell, B, T, H, h_all, c_all, dh)
    if hin.device.type == "cpu":
        return rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m, h_all,
                                            c_all, dh, forget_bias)
    _check_card(hin, wx=wx, b=b, wh=wh, m=m, h_all=h_all, c_all=c_all,
                dh=dh)
    route = _mma_route(hin.dtype, H, "bwd")
    if route != "simt":
        return _fused_bwd_on(route, cell, hin, wx, b, wh, m, h_all, c_all,
                             dh, forget_bias, wxp, xw)
    return _launch_bwd(cell, True, hin, wx, b, wh, m, h_all, c_all, dh,
                       forget_bias)


def _fused_bwd_on(route, cell, hin, wx, b, wh, m, h_all, c_all, dh,
                  forget_bias, wxp, xw):
    """The fused backward on the tensor cores of ``route``, padded to the
    kernels' width; ``wxp`` (bf16 up to 128) or ``xw`` (the f32 scratch of
    the 3xTF32, cluster or grid forward) from the forward."""
    kw = dict(wxp=wxp) if route == "mma" else dict(xw=xw)
    return padded_launch(_tensor_core_launcher(route, "fused_bwd"),
                         "fused_bwd")(cell, hin, wx, b, wh, m, h_all, c_all,
                                      dh, forget_bias, **kw)


def rnn_scan_bwd(cell: str, xw: torch.Tensor, wh: torch.Tensor,
                 m: torch.Tensor, h_all: torch.Tensor,
                 c_all: Optional[torch.Tensor], dh: torch.Tensor,
                 forget_bias: float = 1.0):
    """Backward of :func:`rnn_scan` from its saved states → ``(dxw in
    xw.dtype, dW_h in f32)``; on the card the kernels of
    :func:`_mma_route`. Seed-stacked operands (``xw`` 4-D, see
    :func:`_check_stacked_scan`) give both per seed, ``[S, ...]``, in one
    call on the card."""
    if xw.dim() == 4:
        S = _check_stacked_scan(cell, xw, wh, m, h_all, c_all, dh)
        if cell == "lstm" and c_all is None:
            raise ValueError("the LSTM backward needs the saved c_all")
        H = wh.shape[-2]
        if xw.device.type == "cpu":
            return _over_seeds(
                lambda *a: rnn_scan_bwd_reference(cell, *a, forget_bias),
                S, xw, wh, m, h_all, c_all, dh)
    else:
        B, T, G = xw.shape
        H = G // _GATES.get(cell, 1)
        _check_shapes(cell, B, T, H, m, wh)
        _check_states(cell, B, T, H, h_all, c_all, dh)
        if xw.device.type == "cpu":
            return rnn_scan_bwd_reference(cell, xw, wh, m, h_all, c_all, dh,
                                          forget_bias)
    _check_card(xw, wh=wh, m=m, h_all=h_all, c_all=c_all, dh=dh)
    route = _mma_route(xw.dtype, H, "bwd")
    if route != "simt":
        return padded_launch(_tensor_core_launcher(route, "bwd"), "bwd")(
            cell, xw, wh, m, h_all, c_all, dh, forget_bias)
    return _launch_bwd(cell, False, xw, None, None, wh, m, h_all, c_all, dh,
                       forget_bias)


# ---------------------------------------------------------------------------
# Public, differentiable ops
# ---------------------------------------------------------------------------


class _FusedScan(torch.autograd.Function):
    """The fused recurrence, one node for every seed of a seed-stacked
    call. On the 3xTF32, cluster and grid routes the forward's f32 xw
    scratch ``[S, B, T, G Hp]`` stays alive from the forward to the
    backward, which takes it as its d_gates buffer and skips its own xw
    GEMM (the bf16 grid backward's fused form: five kernels, not six;
    ``RNNModel.row_state_bytes`` counts the scratch); a second backward
    recomputes it."""

    @staticmethod
    def forward(ctx, cell, forget_bias, hin, wx, b, wh, m):
        # The bf16 tensor-core kernels read W_x and W_h in fragment order
        # (above 128, W_h packed per CTA of the cluster): packed once here,
        # at the padded width, for the forward and the backward's
        # recompute.
        packed = None
        route = (_mma_route(hin.dtype, wh.shape[-2])
                 if hin.device.type == "cuda" else None)
        Hp = _padded_width(wh.shape[-2])
        if route == "mma":
            packed = (pack_fragments(wx, width=Hp),
                      pack_fragments(wh, width=Hp))
        elif route == "cluster":
            C = _cluster_size(cell, Hp, torch.cuda.get_device_properties(
                hin.device).shared_memory_per_block_optin)
            packed = pack_cluster(wh, C, width=Hp)
        # The 3xTF32, cluster and grid routes' xw scratch becomes the
        # backward's d_gates buffer (its xw GEMM skipped); a second
        # backward recomputes it.
        h, c, ctx.xw = _fused_states(cell, hin, wx, b, wh, m, forget_bias,
                                     True, packed, keep_xw=True)
        ctx.cell, ctx.forget_bias = cell, forget_bias
        ctx.wxp = packed[0] if route == "mma" else None
        ctx.save_for_backward(hin, wx, b, wh, m, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        hin, wx, b, wh, m, h, c = ctx.saved_tensors
        xw, ctx.xw = ctx.xw, None
        grads = rnn_scan_fused_bwd(
            ctx.cell, hin, wx, b, wh, m, h, c,
            dh.to(hin.dtype).contiguous(), ctx.forget_bias, ctx.wxp, xw)
        # The weight gradients leave in the operands' types (f32 sums).
        return (None, None,
                *_seed_summed(grads, (hin, wx, b, wh), hin.dim() == 4), None)


def _seed_summed(grads, operands, stacked: bool):
    """Gradients in their operands' types; under seed stacking an operand
    of seed extent 1 (shared by every seed) takes the sum of the seeds'
    gradients."""
    out = []
    for g, t in zip(grads, operands):
        if stacked and t.shape[0] == 1 and g.shape[0] > 1:
            g = g.sum(dim=0, keepdim=True)
        out.append(g.to(t.dtype))
    return out


class _Scan(torch.autograd.Function):
    """The hoisted recurrence, one node for every seed of a seed-stacked
    call (the JAX ``custom_vjp`` over ``_make_scan``'s seed rules)."""

    @staticmethod
    def forward(ctx, cell, forget_bias, xw, wh, m):
        h, c = _scan_states_any(cell, xw, wh, m, forget_bias, True)
        ctx.cell, ctx.forget_bias = cell, forget_bias
        ctx.save_for_backward(xw, wh, m, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xw, wh, m, h, c = ctx.saved_tensors
        grads = rnn_scan_bwd(ctx.cell, xw, wh, m, h, c,
                             dh.to(xw.dtype).contiguous(), ctx.forget_bias)
        return (None, None, *_seed_summed(grads, (xw, wh), xw.dim() == 4),
                None)


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
    ``[S, B, T, H]``, one launch for all seeds on the card.
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
    ``xw`` and ``wh`` are contiguous in one dtype.

    Seed-stacked: ``xw [S, B, T, G*H]``, ``wh [S, H, G*H]``, ``m [S, B,
    T]``, each of seed extent S or 1 (shared) → ``[S, B, T, H]``: one
    autograd node, one kernel launch for all seeds forward and one call
    backward on the card (the JAX seed rules ``_make_scan._fwd_vmap`` and
    ``_bwd_vmap``); a shared operand's gradient is the seeds' sum.
    """
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {sorted(_GATES)}")
    if xw.dim() == 4:
        S = _check_stacked_scan(cell, xw, wh, m)
        if _wants_grad(xw, wh):
            return _Scan.apply(cell, float(forget_bias), xw, wh, m)
        if xw.numel() == 0:
            return xw.new_empty((S, *xw.shape[1:3], wh.shape[-2]))
        return _scan_states_any(cell, xw, wh, m, forget_bias, False)[0]
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
