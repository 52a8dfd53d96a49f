"""The port's training-side geometry buckets (``LFM_BUCKETS``:
``buckets.py``, ``data/windows.py bucket_geometry``, the trainers'
bucketed epochs, sweeps and predicts), on the CPU:

* the ladders, ``bucket_geometry``, ``bucketed_epoch`` and
  ``bucketed_cross_sections`` byte-equal to the JAX package's on the same
  panel and seed (numpy copies); lookback rungs never cut a history gap;
* a bucketed batch's train step (loss and updated params), the bucketed
  validation sweep and the bucketed predict against the same batches at
  the max shape: bitwise for the single model (MLP, LSTM, GRU) and the
  ensemble's step and sweep; the ensemble's predict within 2e-7 (its
  month chunks group other months at another row count);
* the bucketed fit against the JAX trainer's bucketed fit: the history at
  rtol 1e-4, the decisions exact; the padded-cell counters; the seq-axis
  warning;
* on the card (``cuda``): rows 3 and 4 (the fused recurrence, bf16 at H
  128) and the gather at the bucket shapes (lookback 8 and 32, width 8),
  one seed and a seed grid, against their plain versions.

jax is imported inside the tests that compare with it: the ``cuda``
tests run on the card machine, which has none.
"""


import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch import buckets
from lfm_quant_tpu_torch.config import (DataConfig, ModelConfig, OptimConfig,
                                        RunConfig)
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.data.windows import (DateBatchSampler,
                                              rolling_valid_count)
from lfm_quant_tpu_torch.parallel.mesh import DataMesh
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.loop import Trainer, resolve_buckets
from lfm_quant_tpu_torch.utils import telemetry

PANEL = dict(n_firms=100, n_months=200, n_features=5, seed=5)
#: Young firms enter through the panel and 6 valid months make an anchor,
#: so the months of a 24-month window sit on every lookback rung.
RAGGED = dict(n_firms=120, n_months=150, n_features=3, seed=2,
              min_history=30)


@pytest.fixture(autouse=True)
def _bucketed(monkeypatch):
    monkeypatch.setenv("LFM_BUCKETS", "1")


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(**PANEL)


def _splits(panel):
    if panel.n_firms == RAGGED["n_firms"]:
        return PanelSplits.by_date(panel, int(panel.dates[100]),
                                   int(panel.dates[125]))
    return PanelSplits.by_date(panel, 198001, 198201)


def _cfg(kind="mlp", n_seeds=1, epochs=2, ragged=False):
    """The model over PANEL, or (``ragged``) over RAGGED at window 24, whose
    training dates fill a bucket of lookback 16."""
    data = (DataConfig(n_firms=120, n_months=150, n_features=3, window=24,
                       dates_per_batch=2, firms_per_date=16,
                       min_valid_months=6) if ragged else
            DataConfig(n_firms=100, n_months=200, n_features=5, window=12,
                       dates_per_batch=4, firms_per_date=32))
    return RunConfig(
        name="bk",
        data=data,
        model=ModelConfig(kind=kind, kwargs={"hidden": (16,)} if kind == "mlp"
                          else {"hidden": 8}, scan_impl="pallas_fused"),
        optim=OptimConfig(lr=1e-3, epochs=epochs, warmup_steps=5,
                          early_stop_patience=epochs + 1, loss="mse"),
        seed=0, n_seeds=n_seeds)


def _equal(a, b):
    for f in ("firm_idx", "time_idx", "weight"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


# ---- the ladder and the geometry (numpy copies) ---------------------------


def test_ladders_and_geometry_equal_jax():
    from lfm_quant_tpu import buckets as jax_buckets
    from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
    from lfm_quant_tpu.data.windows import DateBatchSampler as JaxSampler

    for cap in (1, 8, 32, 77, 4096):
        assert buckets.width_rungs(cap) == jax_buckets.width_rungs(cap)
        for n in (1, 5, 9, 33, 100):
            assert (buckets.capped_width(n, cap)
                    == jax_buckets.capped_width(n, cap))
    for w in (8, 12, 24, 60, 240):
        assert buckets.lookback_rungs(w) == jax_buckets.lookback_rungs(w)
        for d in range(0, w + 2):
            assert (buckets.bucket_lookback(d, w)
                    == jax_buckets.bucket_lookback(d, w))
    assert buckets.MIN_LOOKBACK == jax_buckets.MIN_LOOKBACK
    assert buckets.buckets_enabled() == jax_buckets.buckets_enabled()
    for kw, args, mv in ((PANEL, (12, 4, 32), None), (RAGGED, (24, 2, 0), 6)):
        for date_range in (None, (40, 120)):
            ours = DateBatchSampler(synthetic_panel(**kw), *args, seed=3,
                                    date_range=date_range,
                                    min_valid_months=mv)
            ref = JaxSampler(jax_synthetic(**kw), *args, seed=3,
                             date_range=date_range, min_valid_months=mv)
            g, r = ours.bucket_geometry(), ref.bucket_geometry()
            assert (g.window, g.width_cap, g.eval_width_cap) == (
                r.window, r.width_cap, r.eval_width_cap)
            for mine, theirs in ((g.train_buckets, r.train_buckets),
                                 (g.eval_buckets, r.eval_buckets)):
                assert list(mine) == list(theirs)
                for k in mine:
                    assert mine[k].tobytes() == theirs[k].tobytes(), k
            assert g.summary(args[1]) == r.summary(args[1])
            assert (ours.bucketed_batches_per_epoch()
                    == ref.bucketed_batches_per_epoch())
            for e in (0, 3):
                mine, theirs = ours.bucketed_epoch(e), ref.bucketed_epoch(e)
                assert [k for k, _ in mine] == [k for k, _ in theirs]
                for (_, x), (_, y) in zip(mine, theirs):
                    _equal(x, y)
            for (k, x, p), (kr, y, pr) in zip(
                    ours.bucketed_cross_sections(),
                    ref.bucketed_cross_sections()):
                assert k == kr and p.tobytes() == pr.tobytes()
                _equal(x, y)


def test_lookback_rungs_respect_history_gaps():
    """A month sits on a rung below the window only when no firm of its
    pool has a valid month in the dropped span (a count of valid months
    alone would cut gapped histories); the ragged panel puts months on
    every rung."""
    s = DateBatchSampler(synthetic_panel(**RAGGED), 24, 2, 0, seed=0,
                         min_valid_months=6)
    rung = s._safe_lookback_rung(s._all_dates)
    assert set(rung.values()) == set(buckets.lookback_rungs(24))
    for t, r in rung.items():
        if r == s.window:
            continue
        pool = s._firms_by_date[t]
        gap = (rolling_valid_count(s._valid, s.window)
               - rolling_valid_count(s._valid, r))[pool, t]
        assert not gap.any(), t
    geo = s.bucket_geometry()
    dates = np.concatenate(list(geo.train_buckets.values()))
    assert sorted(dates.tolist()) == sorted(s._dates.tolist())
    assert all(d.size >= s.dates_per_batch
               for d in geo.train_buckets.values())


# ---- bucketed against the max shape ----------------------------------------


def _pad(fi, ti, w, bf):
    """A ``[..., D, w]`` batch padded to ``[..., D, bf]`` with weight-0
    repeats of its first column: its max-shape twin."""
    extra = bf - fi.shape[-1]
    fi = torch.cat([fi, fi[..., :1].expand(*fi.shape[:-1], extra)], dim=-1)
    w = torch.cat([w, torch.zeros(*w.shape[:-1], extra)], dim=-1)
    return fi.contiguous(), ti, w


def _params(state):
    return {k: p.detach().clone() for k, p in state.params.items()}


@pytest.mark.parametrize("kind,n_seeds,ragged", [
    ("mlp", 1, False), ("lstm", 1, False), ("gru", 1, True),
    ("lstm", 2, True)])
def test_bucketed_equals_max_shape(panel, kind, n_seeds, ragged):
    """The cheapest bucket's first step (a narrower width, or on the
    ragged panel a shorter lookback) from the same state at its bucket
    shape and padded to the max shape: loss and updated params bitwise;
    the bucketed sweep's per-month ICs bitwise; the bucketed predict
    (every lookback and width rung) bitwise for one model, within 2e-7
    for the ensemble."""
    cls = EnsembleTrainer if n_seeds > 1 else Trainer
    if ragged:
        panel = synthetic_panel(**RAGGED)
    one, two = (cls(_cfg(kind, n_seeds, ragged=ragged), _splits(panel),
                    device="cpu") for _ in range(2))
    assert one._bucketed
    if n_seeds > 1:
        parts, _ = one._build_bucketed_epoch(0)
        cap = one.samplers[0].firms_per_date
    else:
        parts, _ = one._bucketed_build(0)
        cap = one.train_sampler.firms_per_date
    lb, (fi, ti, w) = min(parts, key=lambda p: p[0] * p[1][0].shape[-1])
    assert fi.shape[-1] < cap or lb < one.window
    s1, s2 = one.init_state(), two.init_state()
    _, m1 = one.step(s1, fi[0], ti[0], w[0], window=lb)
    _, m2 = two.step(s2, *(_pad(fi[0], ti[0], w[0], cap)))
    assert torch.equal(m1["loss"], m2["loss"])
    p1, p2 = _params(s1), _params(s2)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    one.state = one.init_state()
    sweep, counts = one._val_sweep()
    vb = one.val_sampler.stacked_cross_sections()
    np.testing.assert_array_equal(counts, vb.weight.sum(axis=1))
    if n_seeds > 1:
        assert torch.equal(sweep(one.state.params),
                           one._eval_ic(one.state.params, *one._batch(vb)))
    else:
        assert torch.equal(sweep()[0], one._eval_dispatch(*one._batch(vb))[0])
    fc, valid = one.predict()
    if n_seeds > 1:
        one._bucketed = False
    else:
        one._bucketed_eval = False
    ref, ref_valid = one.predict()
    np.testing.assert_array_equal(valid, ref_valid)
    if n_seeds > 1:
        np.testing.assert_allclose(fc, ref, rtol=0, atol=2e-7)
    else:
        np.testing.assert_array_equal(fc, ref)


def test_bucketed_fit_matches_jax(panel, tmp_path):
    """The bucketed fit (the epoch's buckets in geometry order, the
    bucketed sweep) against the JAX trainer's under ``LFM_BUCKETS=1``,
    from the same init: the steps per epoch exact, the history at rtol
    1e-4, the best and early-stop epochs exact; the padded-cell counters
    read fewer cells than the max shape's."""
    import jax

    from lfm_quant_tpu import config as jax_config
    from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
    from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
    from lfm_quant_tpu.train.loop import Trainer as JaxTrainer

    cfg = _cfg("mlp", epochs=3)
    jt = JaxTrainer(jax_config.RunConfig.from_json(cfg.to_json()),
                    JaxSplits.by_date(jax_synthetic(**PANEL), 198001,
                                      198201))
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    tt = Trainer(cfg, _splits(panel), device="cpu")
    assert tt._steps_per_epoch == jt._steps_per_epoch
    orig = tt.init_state
    tt.init_state = lambda params=None: orig(init if params is None
                                             else params)
    snap = telemetry.COUNTERS.snapshot()
    got = tt.fit()
    d = telemetry.COUNTERS.delta(snap)
    for k in ("best_epoch", "epochs_run", "steps"):
        assert got[k] == want[k], k
    for g, w in zip(got["history"], want["history"]):
        for k in ("train_loss", "val_ic", "val_mse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6)
    assert d["bucket_dispatches"] >= 2 * got["epochs_run"]
    assert d["bucket_cells_real"] <= d["bucket_cells_dispatched"] \
        < d["bucket_cells_max_shape"]


def test_seq_axis_warns_and_trains_at_the_max_shape(monkeypatch):
    with pytest.warns(UserWarning, match="sequence parallelism"):
        assert resolve_buckets(DataMesh(n_seq=2)) is False
    assert resolve_buckets(DataMesh()) is True
    monkeypatch.setenv("LFM_BUCKETS", "0")
    assert resolve_buckets(DataMesh(n_seq=2)) is False


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (python3 chip_smoke.py runs "
                    "phase 21 there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("T", [8, 32])
def test_kernels_at_the_bucket_shapes(cuda, T, S):
    """Rows 3 and 4 (the LSTM in bf16 at H 128, B = 8 dates x width 8)
    and the gather (window T, width 8) at a bucket's shape, one seed and
    a seed grid: each one counted launch, held to the plain versions at
    atol 0.05 + rtol 0.05 (the gather exactly)."""
    from lfm_quant_tpu_torch.data.windows import gather_windows_packed
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.ops import rnn as R
    from lfm_quant_tpu_torch.ops.gather import gather_windows

    B, H = 8 * 8, 128
    gen = torch.Generator(device=cuda).manual_seed(T + S)

    def bf(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device=cuda)).to(torch.bfloat16)

    lead = (S,) if S > 1 else ()
    hin, dh = bf(*lead, B, T, H), bf(*lead, B, T, H, scale=0.1)
    wx, wh = (bf(*lead, H, 4 * H, scale=H ** -0.5) for _ in range(2))
    b = bf(*lead, 4 * H, scale=0.1)
    m = torch.rand(*lead, B, T, generator=gen, device=cuda) < 0.8
    _build.reset_launch_counts()
    h, c = R._fused_states("lstm", hin, wx, b, wh, m, 1.0, True)
    grads = R.rnn_scan_fused_bwd("lstm", hin, wx, b, wh, m, h, c, dh)
    counts = _build.launch_counts()
    assert counts["rnn_fused_fwd_mma_lstm"] == 1
    assert counts["rnn_fused_bwd_mma_lstm"] == 1
    cpu = [t.cpu() for t in (hin, wx, b, wh, m, dh)]
    with torch.no_grad():
        h_ref, c_ref = R._fused_states("lstm", *cpu[:5], 1.0, True)
    g_ref = R.rnn_scan_fused_bwd("lstm", *cpu[:5], h_ref, c_ref, cpu[5])
    for got, want in ((h, h_ref), (c, c_ref)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), atol=0.05,
                                   rtol=0.05)
    for got, want in zip(grads, g_ref):
        scale = float(want.float().abs().max()) + 1e-9
        np.testing.assert_allclose(got.float().cpu().numpy() / scale,
                                   want.float().numpy() / scale, atol=0.05,
                                   rtol=0.05)
    rng = np.random.default_rng(T)
    xm = rng.standard_normal((300, 120, 21)).astype(np.float32)
    xm[..., 20] = rng.random((300, 120)) < 0.8
    xm = torch.from_numpy(xm).to(torch.bfloat16)
    fi = torch.from_numpy(rng.integers(0, 300, (*lead, 8, 8))
                          .astype(np.int32))
    ti = torch.from_numpy(rng.integers(0, 120, (*lead, 8)).astype(np.int32))
    _build.reset_launch_counts()
    x, mk = gather_windows(xm.to(cuda), fi.to(cuda), ti.to(cuda), T, fp=21)
    assert _build.launch_counts()["window_gather"] == 1
    flat = (fi.reshape(-1, 8), ti.reshape(-1))
    x_ref, m_ref = gather_windows_packed(xm, *flat, T, fp=21)
    assert torch.equal(x.cpu().reshape(x_ref.shape), x_ref)
    assert torch.equal(mk.cpu().reshape(m_ref.shape), m_ref)
