"""The port's window gather against the JAX package's.

The same numpy panel and indices go through ``lfm_quant_tpu.data.windows
gather_windows_packed`` (the XLA row gather), ``lfm_quant_tpu.ops.
pallas_gather gather_windows_pallas`` (Pallas interpret mode on the CPU,
as ``tests/test_pallas_gather.py`` runs it) and the port's
``ops/gather.py gather_windows`` (its plain version on the CPU). A gather
only moves values, so every comparison is exact, in f32 and in bf16.

The CUDA kernel itself is held to its plain version on the card in
``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.data.windows import gather_windows_packed as jax_packed
from lfm_quant_tpu.ops.pallas_gather import gather_windows_pallas
from lfm_quant_tpu_torch.data.windows import gather_windows_packed
from lfm_quant_tpu_torch.ops.gather import gather_windows

N_FIRMS = 9


def _panel(T, n_feat, seed, lane_pad=0):
    """Packed panel [N, T, F+1(+lane_pad)] with gapped validity and raw
    noise left in the invalid cells (the gather must zero them itself);
    ``lane_pad`` zero columns past the validity column stand for a
    lane-padded panel."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N_FIRMS, T, n_feat)).astype(np.float32)
    valid = rng.random((N_FIRMS, T)) < 0.8
    valid[0, 5:9] = False  # a gap in one history
    valid[:, -1] = True
    xm = np.concatenate([feats, valid[..., None].astype(np.float32),
                         np.zeros((N_FIRMS, T, lane_pad), np.float32)], -1)
    return xm


def _indices(T, W, seed, pad_cols=3):
    """Anchors young (t < W-1), mid and at the tail; each date row ends in
    ``pad_cols`` repeats of its last firm, as the batcher pads."""
    rng = np.random.default_rng(seed)
    ti = np.asarray(sorted({0, 3, W - 2, W - 1, T // 2, T - 2, T - 1}),
                    np.int32)
    fi = rng.integers(0, N_FIRMS, size=(ti.size, 5)).astype(np.int32)
    fi = np.concatenate([fi, np.repeat(fi[:, -1:], pad_cols, 1)], 1)
    return fi, ti


def _to(dtype_name, xm):
    if dtype_name == "bf16":
        return (jnp.asarray(xm).astype(jnp.bfloat16),
                torch.from_numpy(xm).to(torch.bfloat16))
    return jnp.asarray(xm), torch.from_numpy(xm)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("T,W,lane_pad", [(70, 12, 0), (43, 12, 5),
                                          (64, 60, 0)])
def test_matches_jax_gathers(T, W, lane_pad, dtype_name):
    xm = _panel(T, 3, seed=T, lane_pad=lane_pad)
    fi, ti = _indices(T, W, seed=T + 1)
    fp = 4
    jxm, txm = _to(dtype_name, xm)
    x, m = gather_windows(txm, torch.from_numpy(fi), torch.from_numpy(ti),
                          W, fp=fp)
    assert x.dtype == txm.dtype and m.dtype == torch.bool
    assert tuple(x.shape) == (ti.size, fi.shape[1], W, fp - 1)
    for xr, mr in (jax_packed(jxm, jnp.asarray(fi), jnp.asarray(ti), W,
                              fp=fp),
                   gather_windows_pallas(jxm, jnp.asarray(fi),
                                         jnp.asarray(ti), W, fp=fp)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(mr))
        np.testing.assert_array_equal(_np(x), _np(xr))
    # Young anchors: window positions before the panel start are masked.
    assert not m[0, :, :W - 1].any()


def test_panel_shorter_than_window_matches_jax():
    """T < W: every anchor is young (the JAX package's pairwise path)."""
    T, W = 8, 12
    xm = _panel(T, 2, seed=1)
    fi, ti = _indices(T, W, seed=2)
    ti = np.clip(ti, 0, T - 1)
    x, m = gather_windows(torch.from_numpy(xm), torch.from_numpy(fi),
                          torch.from_numpy(ti), W)
    xr, mr = jax_packed(jnp.asarray(xm), jnp.asarray(fi), jnp.asarray(ti), W)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mr))
    np.testing.assert_array_equal(x.numpy(), np.asarray(xr))


def test_gather_checks_shapes():
    xm = torch.zeros((3, 10, 4))
    fi = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="time_idx"):
        gather_windows(xm, fi, torch.zeros((3,), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="fp="):
        gather_windows(xm, fi, torch.zeros((2,), dtype=torch.int32), 4, fp=9)
