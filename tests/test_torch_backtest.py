"""The port's scoring path against the JAX package's.

* ``backtest/engine.py``: a copy of the JAX package's numpy engine, line
  for line but for its ``Panel`` import.
* ``backtest/torch_engine.py`` on the CPU against JAX ``run_backtest_jax``
  and the numpy ``run_backtest``, on ``tests/test_jax_backtest.py``'s
  adversarial panels at its ``TOL``: random ragged panels, all-invalid
  target months, thin and tiny universes, no qualifying month (raises).
  Tied forecasts give identical portfolios: membership decoded exactly
  from each month's long return.
* ``aggregate_scores_device`` and ``run_scoring_pipeline`` against the
  JAX ones and the numpy path for the three modes.
* ``Trainer.predict`` and ``EnsembleTrainer.predict`` against the JAX
  trainers' from the same (bridged) Flax params: a split, a month range
  and the live months (``require_target=False``), rtol 1e-4 in f32.
* The entry points ``python -m lfm_quant_tpu_torch.backtest`` and
  ``.forecast`` through ``main([...])`` with ``--device cpu``, and
  raising without a card; a fresh process running them loads no JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.backtest.jax_engine import (
    aggregate_scores_device as jax_aggregate,
)
from lfm_quant_tpu.backtest.jax_engine import run_backtest_jax
from lfm_quant_tpu.backtest.jax_engine import (
    run_scoring_pipeline as jax_pipeline,
)
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.backtest import engine, torch_engine
from lfm_quant_tpu_torch.backtest.__main__ import main as backtest_main
from lfm_quant_tpu_torch.data.panel import Panel, PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.forecast import main as forecast_main
from lfm_quant_tpu_torch.train.__main__ import main as train_main
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.loop import Trainer
from test_jax_backtest import TOL, assert_reports_match, random_panel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("features", "targets", "target_valid", "valid", "returns",
          "dates", "firm_ids", "feature_names")


def port_panel(p) -> Panel:
    """The JAX package's panel as the port's (the same arrays)."""
    return Panel(*[getattr(p, f) for f in FIELDS], horizon=p.horizon,
                 ret_valid=p.ret_valid)


def backtests(fc, fc_valid, jp, **kw):
    """(numpy, JAX, port) reports of one forecast panel."""
    return (engine.run_backtest(fc, fc_valid, port_panel(jp), **kw),
            run_backtest_jax(fc, fc_valid, jp, **kw),
            torch_engine.run_backtest_torch(fc, fc_valid, port_panel(jp),
                                            device="cpu", **kw))


def test_engine_is_a_copy_of_the_jax_engine():
    """Everything below the module docstring is the original's, the
    ``Panel`` import aside."""
    def body(path, panel_module):
        text = open(os.path.join(ROOT, path)).read()
        text = text[text.index("from __future__"):]
        return text.replace(f"from {panel_module}.data.panel import Panel",
                            "from PANEL import Panel")

    assert body("lfm_quant_tpu_torch/backtest/engine.py",
                "lfm_quant_tpu_torch") == body(
        "lfm_quant_tpu/backtest/engine.py", "lfm_quant_tpu")


@pytest.mark.parametrize("seed", range(4))
def test_engines_match_on_random_panels(seed):
    """Random ragged panels × engine configs, forecasts quantized to force
    ties across the portfolio boundary, an empty month, short universes
    that skip months."""
    jp = random_panel(seed=seed)
    rng = np.random.default_rng(100 + seed)
    fc = rng.standard_normal(jp.targets.shape).astype(np.float32)
    fc = np.round(fc * 3) / 3  # heavy ties
    fc_valid = jp.valid & (rng.random(fc.shape) > 0.2)
    fc_valid[:, 7] = False  # an empty month
    for kw in (dict(min_universe=10),
               dict(min_universe=10, long_short=True, costs_bps=25.0),
               dict(min_universe=10, quantile=0.25, rf_monthly=0.002),
               dict(min_universe=40)):
        ref, jax_rep, ours = backtests(fc, fc_valid, jp, **kw)
        assert_reports_match(ref, ours)
        assert_reports_match(jax_rep, ours)


def test_all_invalid_target_months():
    """Months with no observable target in the universe: IC 0 on every
    engine."""
    jp = random_panel(seed=9)
    jp.target_valid[:, 20:30] = False
    fc = np.random.default_rng(1).standard_normal(
        jp.targets.shape).astype(np.float32)
    ref, jax_rep, ours = backtests(fc, jp.valid, jp, min_universe=10)
    assert_reports_match(ref, ours)
    assert_reports_match(jax_rep, ours)
    blinded = np.isin(ours.dates, jp.dates[20:30].astype(ours.dates.dtype))
    assert blinded.any() and np.all(ours.monthly_ic[blinded] == 0.0)


@pytest.mark.parametrize("quantile,min_universe", [(0.2, 1), (0.5, 3)])
def test_thin_and_tiny_universes(quantile, min_universe):
    """Universes below ``profile_buckets`` (the thin-month bucket map),
    and k = n·q exactly on .5 (round-half-even from the host k-table)."""
    jp = random_panel(n=8, t=60, seed=3, ragged=False)
    fc = np.random.default_rng(2).standard_normal(
        jp.targets.shape).astype(np.float32)
    ref, jax_rep, ours = backtests(fc, jp.valid, jp, quantile=quantile,
                                   min_universe=min_universe)
    assert_reports_match(ref, ours)
    assert_reports_match(jax_rep, ours)
    k = torch_engine._k_table(9, quantile, "cpu").numpy()
    assert k.tolist() == [max(1, int(round(n * quantile)))
                          for n in range(10)]


def test_raises_when_no_month_qualifies():
    jp = random_panel(seed=5)
    fc = np.zeros(jp.targets.shape, np.float32)
    with pytest.raises(ValueError, match="no month"):
        torch_engine.run_backtest_torch(fc, np.zeros(fc.shape, bool),
                                        port_panel(jp), device="cpu")
    with pytest.raises(ValueError, match="shapes disagree"):
        torch_engine.run_backtest_torch(fc[:, :5], np.ones((80, 5), bool),
                                        port_panel(jp), device="cpu")


def _ties_panel():
    """16 firms whose forward returns are distinct powers of two, so a
    month's long return times k, scaled by 2**15, IS the bitmask of the
    portfolio; forecasts in {0, 1, 2} tie across every boundary."""
    n, t = 16, 40
    rng = np.random.default_rng(21)
    jp = random_panel(n=n, t=t, seed=21, ragged=False)
    jp.returns[:] = (2.0 ** -np.arange(n, dtype=np.float32))[:, None]
    jp.ret_valid[:] = True
    fc = rng.integers(0, 3, (n, t)).astype(np.float32)
    valid = rng.random((n, t)) > 0.15
    return jp, fc, valid


def _masks(rep, k):
    return np.rint(np.asarray(rep.monthly_returns, np.float64) * k
                   * 2.0 ** 15).astype(np.int64)


def test_tied_forecasts_form_identical_portfolios():
    """Portfolio membership held exactly (decoded from each month's long
    return) and turnover to its tolerance on every engine, on a panel
    where a sort that breaks ties another way forms other portfolios."""
    jp, fc, valid = _ties_panel()
    kw = dict(quantile=0.25, min_universe=8)
    ref, jax_rep, ours = backtests(fc, valid, jp, **kw)
    assert ours.n_months == ref.n_months > 20
    uni = valid & jp.tradeable()
    used = uni.sum(axis=0) >= 8
    k = np.maximum(1, np.round(uni.sum(axis=0) * 0.25)).astype(int)[used]
    want = _masks(ref, k)
    np.testing.assert_array_equal(_masks(ours, k), want)
    np.testing.assert_array_equal(_masks(jax_rep, k), want)
    # The masks really are portfolios, and turnover follows from them.
    bits = [int(m).bit_count() for m in want]
    assert bits == k.tolist()
    turns = [1.0 - int(a & b).bit_count() / kk
             for a, b, kk in zip(want[1:], want[:-1], k[1:])]
    np.testing.assert_allclose(ours.turnover, np.mean(turns),
                               atol=TOL["turn"])
    np.testing.assert_allclose(ref.turnover, np.mean(turns), atol=1e-12)
    # A tie-break that takes the lower firm index last picks other names.
    other = []
    for t in np.nonzero(used)[0]:
        ix = np.nonzero(uni[:, t])[0]
        order = ix[np.lexsort((-ix, fc[ix, t]))]
        kk = max(1, int(round(ix.size * 0.25)))
        # Firm i's return is 2**-i: its bit in the decoded mask is 15 - i.
        other.append(sum(1 << (15 - int(i)) for i in order[-kk:]))
    assert (np.asarray(other) != want).any()


def test_aggregate_scores_device_matches():
    """All three modes from one stacked tensor ≡ the JAX device
    aggregation and the numpy per-mode aggregate, with per-seed
    validity; the errors of the JAX function."""
    rng = np.random.default_rng(4)
    fc = rng.standard_normal((5, 30, 24)).astype(np.float32)
    avar = rng.random((5, 30, 24)).astype(np.float32)
    pv = np.ones((5, 30, 24), bool)
    pv[2, 4, 4] = False
    modes = [("mean", 1.0), ("mean_minus_std", 0.5),
             ("mean_minus_std", 2.0), ("mean_minus_total_std", 1.0)]
    scores, valid, specs = torch_engine.aggregate_scores_device(
        fc, pv, modes, aleatoric_var=avar, device="cpu")
    jscores, jvalid, jspecs = jax_aggregate(fc, pv, modes,
                                            aleatoric_var=avar)
    assert specs == jspecs and scores.shape == (4, 30, 24)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-6)
    for g, (mode, lam) in enumerate(specs):
        ref, ref_valid = engine.aggregate_ensemble(
            fc, pv, mode, lam,
            aleatoric_var=avar if mode == "mean_minus_total_std" else None)
        np.testing.assert_array_equal(valid, ref_valid)
        np.testing.assert_allclose(scores[g].numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError, match="aleatoric_var"):
        torch_engine.aggregate_scores_device(
            fc, pv, ["mean_minus_total_std"], device="cpu")
    with pytest.raises(ValueError, match="unknown ensemble mode"):
        torch_engine.aggregate_scores_device(fc, pv, ["median"],
                                             device="cpu")


def test_scoring_pipeline_matches():
    """One aggregation and one core pass for every mode ≡ the JAX
    pipeline and numpy aggregate → backtest per mode; a single [N, T]
    panel rejects mean_minus_std."""
    jp = random_panel(seed=6)
    rng = np.random.default_rng(7)
    stack = rng.standard_normal((4,) + jp.targets.shape).astype(np.float32)
    avar = rng.random(stack.shape).astype(np.float32)
    modes = [("mean", 1.0), ("mean_minus_std", 0.5),
             ("mean_minus_total_std", 2.0)]
    kw = dict(min_universe=10, long_short=True, costs_bps=5.0)
    panel = port_panel(jp)
    ours = torch_engine.run_scoring_pipeline(
        stack, jp.valid, panel, modes=modes, aleatoric_var=avar,
        device="cpu", **kw)
    theirs = jax_pipeline(stack, jp.valid, jp, modes=modes,
                          aleatoric_var=avar, **kw)
    assert list(ours) == list(theirs) == [
        "mean", "mean_minus_std@0.5", "mean_minus_total_std@2"]
    for (mode, lam), label in zip(modes, ours):
        assert_reports_match(theirs[label], ours[label])
        fc, v = engine.aggregate_ensemble(
            stack, jp.valid, mode, lam,
            aleatoric_var=avar if mode == "mean_minus_total_std" else None)
        assert_reports_match(engine.run_backtest(fc, v, panel, **kw),
                             ours[label])
    with pytest.raises(ValueError, match="stacked forecasts"):
        torch_engine.run_scoring_pipeline(stack[0], jp.valid, panel,
                                          modes=["mean_minus_std"],
                                          device="cpu")


def test_score_panel_residency():
    """One transfer per (panel, device), dropped by ``invalidate``, by
    ``clear`` and when the panel is collected."""
    panel = port_panel(random_panel(seed=2))
    a = torch_engine._device_score_panel(panel, torch.device("cpu"))
    assert torch_engine._device_score_panel(panel, torch.device("cpu")) is a
    assert a["returns"].shape == (panel.n_months, panel.n_firms)
    assert torch_engine.invalidate_score_panel(panel) == 1
    assert torch_engine.invalidate_score_panel(panel) == 0
    torch_engine._device_score_panel(panel, torch.device("cpu"))
    torch_engine.clear_score_panel_cache()
    assert not torch_engine._SCORE_PANEL_CACHE
    torch_engine._device_score_panel(panel, torch.device("cpu"))
    key = id(panel)
    del panel
    import gc
    gc.collect()
    assert not [k for k in torch_engine._SCORE_PANEL_CACHE if k[0] == key]


# ---- predict ------------------------------------------------------------


def _tiny(cfg_mod, cell, n_seeds):
    return cfg_mod.RunConfig(
        name="tiny_predict",
        data=cfg_mod.DataConfig(n_firms=40, n_months=120, n_features=4,
                                window=12, dates_per_batch=4,
                                firms_per_date=16, horizon=3),
        model=cfg_mod.ModelConfig(kind=cell, kwargs={"hidden": 16},
                                  scan_impl="xla"),
        optim=cfg_mod.OptimConfig(lr=3e-3, warmup_steps=4, epochs=2),
        seed=5, n_seeds=n_seeds)


def _splits(splits_cls, panel):
    return splits_cls.by_date(panel, int(panel.dates[84]),
                              int(panel.dates[102]))


@pytest.mark.parametrize("cell,n_seeds", [("lstm", 1), ("gru", 1),
                                          ("gru", 2), ("lstm", 2)])
def test_predict_matches_jax(cell, n_seeds):
    """``predict`` of the port's trainer (the fused recurrence's plain
    version on the CPU) against the JAX trainer's (XLA scan), from the
    JAX init bridged into the port: the test split, a month range, and
    the live months with ``require_target=False``. f32, rtol 1e-4; the
    validity exact."""
    jpanel = jax_synthetic(n_firms=40, n_months=120, n_features=4, seed=0,
                           horizon=3)
    panel = synthetic_panel(n_firms=40, n_months=120, n_features=4, seed=0,
                            horizon=3)
    jcls, cls = ((JaxTrainer, Trainer) if n_seeds == 1
                 else (JaxEnsemble, EnsembleTrainer))
    jt = jcls(_tiny(jax_config, cell, n_seeds), _splits(JaxSplits, jpanel))
    jt.state = jt.init_state()
    tcfg = _tiny(config, cell, n_seeds)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, scan_impl="pallas_fused"))
    tt = cls(tcfg, _splits(PanelSplits, panel), device="cpu")
    tt.state = tt.init_state(jax.tree_util.tree_map(np.asarray,
                                                    jt.state.params))
    lead = (n_seeds,) if n_seeds > 1 else ()
    for kw in (dict(split="test"), dict(date_range=(60, 75)),
               dict(date_range=(108, 120), require_target=False)):
        want, want_valid = jt.predict(**kw)
        got, valid = tt.predict(**kw)
        assert got.shape == want.shape == lead + (40, 120)
        np.testing.assert_array_equal(valid, want_valid)
        assert valid.any()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        assert not got[..., ~valid].any()
    # Live months: forecast without a target.
    _, live = tt.predict(date_range=(108, 120), require_target=False)
    assert (live & ~panel.target_valid).any()
    # A point head has no variance (the JAX trainer's ValueError).
    with pytest.raises(ValueError, match="heteroscedastic"):
        tt.predict(return_variance=True)
    if n_seeds == 1:
        # MC-dropout sampling on a model without dropout: every sample
        # would be the same (the JAX trainer's ValueError).
        with pytest.raises(ValueError, match="dropout"):
            tt.predict(mc_samples=4)


def test_written_ensemble_run_dir_reloads(tmp_path):
    """``write_ensemble_run_dir`` on an ensemble fit without a run dir
    (the trained state becomes ``ckpt/best``): ``load_forecaster`` reads
    it back as an ensemble with the same config, params and forecasts."""
    from lfm_quant_tpu_torch.train.ensemble import write_ensemble_run_dir
    from lfm_quant_tpu_torch.train.forecast import load_forecaster

    panel = synthetic_panel(n_firms=40, n_months=120, n_features=4, seed=0,
                            horizon=3)
    tt = EnsembleTrainer(_tiny(config, "lstm", 2), _splits(PanelSplits,
                                                           panel),
                         device="cpu")
    tt.state = tt.init_state()
    write_ensemble_run_dir(str(tmp_path), tt)
    model, _, is_ensemble = load_forecaster(str(tmp_path), panel=panel,
                                            device="cpu")
    assert is_ensemble and model.cfg.to_json() == tt.cfg.to_json()
    for k, p in tt.state.params.items():
        assert torch.equal(model.state.params[k], p), k
    np.testing.assert_array_equal(model.predict("test")[0],
                                  tt.predict("test")[0])


# ---- the entry points ----------------------------------------------------


def _tiny_json(tmp_path, preset, name):
    base = config.get_preset(preset)
    cfg = dataclasses.replace(
        base, name=name,
        data=dataclasses.replace(base.data, window=12, firms_per_date=32),
        model=dataclasses.replace(base.model, kwargs={"hidden": 8}),
        optim=dataclasses.replace(base.optim, warmup_steps=3))
    path = tmp_path / f"{name}.json"
    path.write_text(cfg.to_json())
    return str(path)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """A single model and a 2-seed ensemble trained by the CLI on the
    CPU: ``{kind: run dir}``."""
    tmp = tmp_path_factory.mktemp("runs")
    out = {}
    for kind, preset, extra in (("single", "c2", []),
                                ("ensemble", "c5", ["--n-seeds", "2"])):
        path = _tiny_json(tmp, preset, f"tiny_{kind}")
        assert train_main(["--config", path, "--device", "cpu", "--scale",
                           "0.02", "--epochs", "2", "--out",
                           str(tmp)] + extra) == 0
        out[kind] = str(tmp / f"tiny_{kind}" / ("ensemble" if extra
                                                else "seed0"))
    return out


@pytest.mark.parametrize("kind", ["single", "ensemble"])
def test_backtest_cli_matches_the_numpy_engine(run_dirs, kind, tmp_path,
                                               capsys):
    """``python -m lfm_quant_tpu_torch.backtest --run-dir ... --device
    cpu``: the report JSON equals the numpy engine's on the loaded
    model's own forecast (the ensemble aggregated mean − 0.5·std)."""
    from lfm_quant_tpu_torch.train.forecast import load_forecaster

    run_dir = run_dirs[kind]
    mode = ["--mode", "mean_minus_std", "--risk-lambda", "0.5"] \
        if kind == "ensemble" else []
    out = tmp_path / "report.json"
    assert backtest_main(["--run-dir", run_dir, "--device", "cpu",
                          "--yearly", "--costs-bps", "10",
                          "--json-out", str(out)] + mode) == 0
    printed = capsys.readouterr().out
    assert "CAGR" in printed and "mo)" in printed
    got = json.loads(out.read_text())
    model, splits, is_ensemble = load_forecaster(run_dir, device="cpu")
    assert is_ensemble == (kind == "ensemble")
    fc, valid = model.predict("test")
    if is_ensemble:
        fc, valid = engine.aggregate_ensemble(fc, valid, "mean_minus_std",
                                              0.5)
    ref = engine.run_backtest(fc, valid, splits.panel, costs_bps=10.0)
    assert got["n_months"] == ref.n_months
    assert got["dates"] == ref.dates.tolist()
    np.testing.assert_allclose(got["monthly_returns"], ref.monthly_returns,
                               atol=TOL["ret"])
    np.testing.assert_allclose(got["cagr"], ref.cagr, rtol=1e-4, atol=1e-6)
    # A single model has no seed axis to penalize.
    if kind == "single":
        with pytest.raises(SystemExit):
            backtest_main(["--run-dir", run_dir, "--device", "cpu",
                           "--mode", "mean_minus_std"])
    # These runs have point heads: no aleatoric variance to score.
    with pytest.raises(ValueError, match="heteroscedastic"):
        backtest_main(["--run-dir", run_dir, "--device", "cpu", "--mode",
                       "mean_minus_total_std"])


def test_forecast_cli_writes_live_rankings(run_dirs, tmp_path, capsys):
    """``python -m lfm_quant_tpu_torch.forecast --device cpu``: the live
    block's forecasts (no target yet) as npz and a ranked CSV, equal to
    the model's ``predict(require_target=False)``."""
    from lfm_quant_tpu_torch.train.forecast import load_forecaster

    for kind, run_dir in run_dirs.items():
        npz, csv = tmp_path / f"{kind}.npz", tmp_path / f"{kind}.csv"
        assert forecast_main(["--run-dir", run_dir, "--device", "cpu",
                              "--out", str(npz), "--csv", str(csv),
                              "--top", "3"]) == 0
        assert "live" in capsys.readouterr().out
        data = np.load(npz)
        model, splits, is_ensemble = load_forecaster(run_dir, device="cpu")
        panel = splits.panel
        lo = panel.n_months - panel.horizon
        fc, valid = model.predict(date_range=(lo, panel.n_months),
                                  require_target=False)
        if is_ensemble:
            fc = fc.mean(axis=0)
        np.testing.assert_array_equal(data["valid"], valid)
        np.testing.assert_allclose(data["forecast"], fc, atol=1e-6)
        assert valid[:, lo:].any() and not valid[:, :lo].any()
        rows = csv.read_text().splitlines()
        assert rows[0] == "firm_id,yyyymm,forecast,rank"
        assert len(rows) == 1 + valid.sum()


def test_entry_points_raise_without_a_card(run_dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backtest_main(["--run-dir", run_dirs["single"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forecast_main(["--run-dir", run_dirs["ensemble"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_engine.run_backtest_torch(np.zeros((2, 2)), np.ones((2, 2)),
                                        None)


def test_scoring_modules_load_no_jax(run_dirs):
    """The import guard over this slice's modules: in a fresh process the
    backtest and forecast entry points run and neither jax nor
    lfm_quant_tpu is loaded."""
    code = (
        "import sys\n"
        "from lfm_quant_tpu_torch.backtest.__main__ import main as bt\n"
        "from lfm_quant_tpu_torch.forecast import main as fc\n"
        "import lfm_quant_tpu_torch.train.walkforward\n"
        f"assert bt(['--run-dir', {run_dirs['ensemble']!r}, '--device', "
        "'cpu']) == 0\n"
        f"assert fc(['--run-dir', {run_dirs['single']!r}, '--device', "
        "'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'lfm_quant_tpu')]\n"
        "assert not bad, bad\n"
        "print('IMPORT_GUARD_OK')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORT_GUARD_OK" in r.stdout
