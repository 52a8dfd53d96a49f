"""The index arithmetic of the window-gather kernel (``csrc/window_gather.cu``)
in a numpy model, held exactly to the plain gather.

This file imports nothing of JAX. The CUDA kernel runs only on the card
(``tests/test_torch_kernels.py`` holds it to the plain version there); here
a model mirrors its formulas step by step, as ``tests/test_torch_mma_bwd.py``
mirrors the recurrence kernels' lane formulas: which windows take the span
copy, the span aligned down to 16 bytes and its shift, the 16-byte chunks
copied into the warp's buffer, each lane's walk over its output vectors
with incrementing (j, k), the funnel shift (``__byte_perm``) of the aligned
words around a vector, the blend at a row boundary and the zero mask; the
rest of the windows through the narrow, clamping path. The model works on
the panel's raw bytes, and buffer bytes the kernel never loads hold
garbage, so a vector that read one would differ from the plain gather.
"""

import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch.data.windows import gather_windows_packed

K_WARP_BYTES = 6 * 1024  # kMaxWarpBytes
GARBAGE = 0xAB


def _round16(n):
    return (n + 15) & ~15


def _plan(W, Fp, F, isz):
    """``launch``: the span flag and one warp's shared bytes (the row
    flags, then the span's buffer)."""
    V = 16 // isz
    warp_bytes = _round16(W) + _round16(W * Fp * isz + 32)
    span = (W * F * isz) % 16 == 0 and F >= V and warp_bytes <= K_WARP_BYTES
    return span, warp_bytes


def _byte_perm(x, y, s):
    """CUDA ``__byte_perm(x, y, s)``: byte n of the result is byte
    ``(s >> 4 n) & 7`` of the 8 bytes ``y:x``."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _funnel16(buf, bq):
    """``funnel16``: the 16 bytes from byte ``bq`` as 4 words."""
    c = bq & ~15
    assert c + 32 <= buf.size  # the buffer holds both aligned words
    w = [int(v) for v in buf[c:c + 32].view("<u4")]
    ow = (bq >> 2) & 3
    sel = 0x5432 if bq & 2 else 0x3210
    s = [w[i + ow] for i in range(5)]
    return [_byte_perm(s[i], s[i + 1], sel) for i in range(4)]


def _blend(a, b, n1, va, vb, isz):
    epw = 4 // isz
    out = []
    for w in range(4):
        ma = mb = 0
        for e in range(epw):
            bits = 0xFFFFFFFF if epw == 1 else 0xFFFF << (16 * e)
            if w * epw + e < n1:
                if va:
                    ma |= bits
            elif vb:
                mb |= bits
        out.append((a[w] & ma) | (b[w] & mb))
    return out


def _nonzero(raw, isz):
    """``nonzero`` on an element's bits: not +0 or -0."""
    return (raw & (0x7FFF if isz == 2 else 0x7FFFFFFF)) != 0


def _elem(bytes_, byte_off, isz):
    return int.from_bytes(bytes(bytes_[byte_off:byte_off + isz]), "little")


def gather_model(xm, fi, ti, W, fp):
    """The kernel, lane by lane, on ``xm``'s bytes → ``(x, m, paths)``
    with ``paths`` the number of windows that took each store width."""
    N, Tn, Fp = xm.shape
    isz = xm.element_size()
    F = fp - 1
    V = 16 // isz
    D, Bf = fi.shape
    n = W * F
    # The panel's bytes, padded to its last 16-byte granule and one more
    # (an aligned base: the allocation holds the granule).
    raw = xm.contiguous().view(torch.uint8).reshape(-1).numpy()
    pan = np.zeros(_round16(raw.size) + 16, np.uint8)
    pan[:raw.size] = raw
    x = np.zeros(D * Bf * n * isz, np.uint8)
    m = np.zeros(D * Bf * W, np.uint8)
    span, warp_bytes = _plan(W, Fp, F, isz)
    paths = {"span": 0, "narrow": 0}
    fi, ti = fi.numpy(), ti.numpy()
    for d in range(D):
        for b in range(Bf):
            row = d * Bf + b
            f, t = int(fi[d, b]), int(ti[d])
            first = t - (W - 1)
            xo, mo = row * n * isz, row * W
            if span and first >= 0 and t < Tn and 0 <= f < N:
                paths["span"] += 1
                buf = np.full(warp_bytes - _round16(W), GARBAGE, np.uint8)
                a = ((f * Tn + first) * Fp) * isz
                lead = a & 15
                chunks = (lead + W * Fp * isz + 15) >> 4
                for c in range(chunks):
                    buf[16 * c:16 * c + 16] = pan[a - lead + 16 * c:
                                                  a - lead + 16 * c + 16]
                shift = lead // isz
                flags = [_nonzero(_elem(buf, (shift + j * Fp + F) * isz,
                                        isz), isz) for j in range(W)]
                m[mo:mo + W] = flags
                gap = Fp - F
                dj, dk = divmod(32 * V, F)
                for lane in range(32):
                    j, k = divmod(V * lane, F)
                    for v in range(lane, n // V, 32):
                        q = shift + j * Fp + k
                        n1 = V if k + V <= F else F - k
                        lo = _funnel16(buf, q * isz)
                        hi = _funnel16(buf, (q + gap) * isz)
                        words = _blend(lo, hi, n1, flags[j],
                                       n1 < V and flags[j + 1], isz)
                        x[xo + 16 * v:xo + 16 * v + 16] = np.asarray(
                            words, "<u4").view(np.uint8)
                        k += dk
                        j += dj
                        if k >= F:
                            k -= F
                            j += 1
                continue
            paths["narrow"] += 1
            fc = min(max(f, 0), N - 1)

            def month_row(j):
                mon = first + j
                if mon < 0:
                    return None
                return ((fc * Tn + min(mon, Tn - 1)) * Fp) * isz

            for j in range(W):
                r = month_row(j)
                m[mo + j] = r is not None and _nonzero(
                    _elem(pan, r + F * isz, isz), isz)
            dj, dk = divmod(32, F)
            for lane in range(32):
                j, k = divmod(lane, F)
                for i in range(lane, n, 32):
                    r = month_row(j)
                    if r is not None and _nonzero(_elem(pan, r + F * isz,
                                                        isz), isz):
                        x[xo + i * isz:xo + (i + 1) * isz] = \
                            pan[r + k * isz:r + (k + 1) * isz]
                    k += dk
                    j += dj
                    if k >= F:
                        k -= F
                        j += 1
    xt = torch.from_numpy(x).view(xm.dtype).view(D, Bf, W, F)
    mt = torch.from_numpy(m).view(D, Bf, W).bool()
    return xt, mt, paths


def _inputs(N, T, fp, D, Bf, seed, dtype, lane_pad=0):
    """As ``tests/test_torch_kernels.py _gather_inputs``, with the
    youngest and newest anchors."""
    rng = np.random.default_rng(seed)
    xm = rng.standard_normal((N, T, fp + lane_pad)).astype(np.float32)
    xm[..., fp - 1] = rng.random((N, T)) < 0.8
    xm[..., fp:] = 0.0
    xm[0, :, fp - 1] = 0.0  # a firm with no valid month
    fi = rng.integers(0, N, (D, Bf)).astype(np.int32)
    ti = rng.integers(0, T, (D,)).astype(np.int32)
    ti[0], ti[-1] = 0, T - 1
    return (torch.from_numpy(xm).to(dtype), torch.from_numpy(fi),
            torch.from_numpy(ti))


# (N, T, fp, W, D, Bf, lane_pad) → whether the span copy is taken in
# (float32, bfloat16).
SHAPES = [
    ((7, 23, 4, 9, 5, 13, 0), (False, False)),    # F < V: narrow
    ((7, 5, 4, 9, 3, 6, 0), (False, False)),      # panel shorter than W
    ((11, 64, 6, 60, 4, 33, 3), (True, False)),   # bf16: W F 2 % 16 = 8
    ((7, 30, 8, 9, 3, 10, 0), (False, False)),    # F = 7: W F 2 = 126
    ((9, 80, 21, 60, 4, 9, 0), (True, True)),     # c2's W and F
    ((9, 80, 21, 60, 4, 9, 11), (False, True)),   # lane-padded, Fp = 32
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,span", SHAPES)
def test_span_gather_model_matches_plain(shape, span, dtype):
    N, T, fp, W, D, Bf, lane_pad = shape
    xm, fi, ti = _inputs(N, T, fp, D, Bf, N + T + fp, dtype, lane_pad)
    x, m, paths = gather_model(xm, fi, ti, W, fp)
    xr, mr = gather_windows_packed(xm, fi, ti, W, fp=fp)
    assert torch.equal(m, mr)
    assert torch.equal(x.view(torch.uint8), xr.view(torch.uint8))
    want_span = span[dtype == torch.bfloat16]
    assert _plan(W, fp + lane_pad, fp - 1, xm.element_size())[0] == want_span
    if want_span:
        # Young anchors (t = 0) take the narrow path, interior ones the span.
        assert paths["span"] > 0 and paths["narrow"] > 0
    else:
        assert paths["span"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_span_gather_model_clamps_indices_outside_the_panel(dtype):
    """Months past the panel's end clamp to its last month and before its
    start are masked, as the plain gather does; firm indices clamp to
    [0, N - 1] (XLA's gather rule), held against the plain gather of the
    clamped indices. All of these take the narrow path."""
    N, T, fp, W = 9, 80, 21, 60
    xm, fi, _ = _inputs(N, T, fp, 4, 9, 3, dtype)
    ti = torch.tensor([T + 5, T - 1, -3, 70], dtype=torch.int32)
    fi[1, :3] = torch.tensor([-4, N, N + 7], dtype=torch.int32)
    x, m, paths = gather_model(xm, fi, ti, W, fp)
    xr, mr = gather_windows_packed(xm, fi.clamp(0, N - 1), ti, W, fp=fp)
    assert torch.equal(m, mr)
    assert torch.equal(x.view(torch.uint8), xr.view(torch.uint8))
    assert paths["narrow"] == 9 + 3 + 9  # rows 0 and 2, three firms of 1
    assert paths["span"] == 4 * 9 - paths["narrow"]


@pytest.mark.parametrize("F,isz", [(20, 2), (20, 4), (5, 4), (9, 2),
                                   (31, 2)])
def test_vector_walk_visits_each_output_element_once(F, isz):
    """Each lane's incremental (j, k) equals divmod(V v, F) for every one
    of its vectors, so the lanes cover the window's W F elements once."""
    V = 16 // isz
    W = 60
    n = W * F
    dj, dk = divmod(32 * V, F)
    seen = []
    for lane in range(32):
        j, k = divmod(V * lane, F)
        for v in range(lane, n // V, 32):
            assert (j, k) == divmod(V * v, F)
            seen.extend(range(V * v, V * v + V))
            k += dk
            j += dj
            if k >= F:
                k -= F
                j += 1
    assert sorted(seen) == list(range(n // V * V))


def test_byte_perm_funnel_matches_a_byte_slice():
    """The funnel shift returns the 16 bytes at any 2-byte offset."""
    buf = np.arange(64, dtype=np.uint8)
    for bq in range(0, 32, 2):
        words = _funnel16(buf, bq)
        assert bytes(np.asarray(words, "<u4").view(np.uint8)) == \
            bytes(buf[bq:bq + 16])
