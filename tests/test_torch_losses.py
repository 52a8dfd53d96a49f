"""The port's losses and metrics against the JAX package's.

The same numpy inputs go through ``lfm_quant_tpu.ops.losses`` /
``ops.metrics`` and ``lfm_quant_tpu_torch.ops.losses`` / ``ops.metrics``.
Tolerances: f32 atol 1e-6; ranks exactly. With bf16 inputs the
elementwise terms round at other points in the two frameworks (XLA's CPU
fusions keep bf16 arithmetic in f32, torch rounds each op to bf16), so
the losses agree to bf16's precision (rtol 1e-2), and
``test_bf16_inputs_reduce_in_f32`` pins the property that matters: the
reductions run in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.ops import losses as jl
from lfm_quant_tpu.ops import metrics as jm
from lfm_quant_tpu_torch.ops import losses as tl
from lfm_quant_tpu_torch.ops import metrics as tm

ATOL = 1e-6
BF16_RTOL = 1e-2


def _inputs(seed, D=3, Bf=11, ties=False, dtype="f32"):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((D, Bf)).astype(np.float32)
    target = rng.standard_normal((D, Bf)).astype(np.float32)
    log_var = (0.5 * rng.standard_normal((D, Bf))).astype(np.float32)
    w = np.ones((D, Bf), np.float32)
    w[0, -3:] = 0.0  # padded slots
    w[1, :2] = 0.0
    if ties:
        pred[:, 1::3] = pred[:, 0:1]
        target[:, ::4] = 0.25
    if dtype == "bf16":
        # Values exact in bf16, so both packages see the same numbers.
        pred, target, log_var = (np.asarray(
            torch.from_numpy(a).bfloat16().float()) for a in
            (pred, target, log_var))
    return pred, target, log_var, w


def _pair(a, dtype):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got, want, atol=ATOL, dtype="f32"):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    tol = (dict(atol=atol, rtol=0.0) if dtype == "f32"
           else dict(atol=atol, rtol=BF16_RTOL))
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(seed, dtype):
    pred, target, log_var, w = _inputs(seed, dtype=dtype)
    (jp, tp), (jt, tt), (jv, tv) = (_pair(a, dtype)
                                    for a in (pred, target, log_var))
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for got, want in (
            (tl.masked_mse(tp, tt, tw), jl.masked_mse(jp, jt, jw)),
            (tl.masked_huber(tp, tt, tw), jl.masked_huber(jp, jt, jw)),
            (tl.masked_huber(tp, tt, tw, delta=0.3),
             jl.masked_huber(jp, jt, jw, delta=0.3)),
            (tl.gaussian_nll(tp, tv, tt, tw),
             jl.gaussian_nll(jp, jv, jt, jw)),
            (tl.soft_rank(tp.float(), tw), jl.soft_rank(
                jp.astype(jnp.float32), jw)),
            (tl.rank_ic_loss(tp, tt, tw), jl.rank_ic_loss(jp, jt, jw))):
        assert got.dtype == torch.float32
        _close(got, want, dtype=dtype)


@pytest.mark.parametrize("name", ["mse", "huber", "nll", "rank_ic"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_parts_match_jax(name, dtype):
    """num and den of every loss, and their ratio through finalize_loss."""
    pred, target, log_var, w = _inputs(7, ties=True, dtype=dtype)
    (jp, tp), (jt, tt), (jv, tv) = (_pair(a, dtype)
                                    for a in (pred, target, log_var))
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jo, to = ((jp, jv), (tp, tv)) if name == "nll" else (jp, tp)
    num, den = tl.make_loss_parts(name)(to, tt, tw)
    jnum, jden = jl.make_loss_parts(name)(jo, jt, jw)
    _close(num, jnum, atol=1e-5, dtype=dtype)  # sums over 33 entries
    _close(den, jden)
    _close(tl.finalize_loss(num, den), jl.finalize_loss(jnum, jden),
           dtype=dtype)
    assert num.dtype == den.dtype == torch.float32


@pytest.mark.parametrize("name", ["mse", "huber"])
def test_bf16_inputs_reduce_in_f32(name):
    """bf16 predictions and targets: the loss is f32 and equals the f64
    mean of the same bf16 elementwise terms to f32 precision (a bf16 sum
    of 4096 terms would be off by far more)."""
    rng = np.random.default_rng(11)
    pred = torch.from_numpy(rng.standard_normal((8, 512)).astype(
        np.float32)).bfloat16()
    target = torch.from_numpy(rng.standard_normal((8, 512)).astype(
        np.float32)).bfloat16()
    w = torch.ones(8, 512)
    num, den = tl.make_loss_parts(name)(pred, target, w)
    err = (pred - target) ** 2 if name == "mse" else None
    if err is None:
        e = torch.abs(pred - target)
        q = torch.clamp(e, max=1.0)
        err = 0.5 * q ** 2 + (e - q)
    want = err.double().sum()
    assert num.dtype == torch.float32
    assert abs(float(num) - float(want)) <= 1e-6 * float(want)
    assert float(den) == 4096.0


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        tl.make_loss_parts("hinge")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
def test_hard_ranks_exact(ties, dtype):
    """Stable sort, first index first among ties, padded slots pushed to
    the top: the ranks of the real entries equal the JAX ranks exactly."""
    pred, target, _, w = _inputs(3, D=4, Bf=17, ties=ties, dtype=dtype)
    for a in (pred, target):
        ja, ta = _pair(a, dtype)
        got = tm.hard_ranks(ta, torch.from_numpy(w))
        want = np.asarray(jm.hard_ranks(ja, jnp.asarray(w)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    if ties:
        r = tm.hard_ranks(torch.tensor([[2.0, 1.0, 2.0, 2.0]]),
                          torch.tensor([[1.0, 1.0, 0.0, 1.0]]))
        assert r.tolist() == [[1.0, 0.0, 3.0, 2.0]]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
def test_spearman_and_pearson_ic_match_jax(ties, dtype):
    pred, target, _, w = _inputs(5, D=4, Bf=17, ties=ties, dtype=dtype)
    (jp, tp), (jt, tt) = _pair(pred, dtype), _pair(target, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    _close(tm.spearman_ic(tp, tt, tw), jm.spearman_ic(jp, jt, jw))
    _close(tm.pearson_ic(tp, tt, tw), jm.pearson_ic(jp, jt, jw))
    assert tm.spearman_ic(tp, tt, tw).dtype == torch.float32
