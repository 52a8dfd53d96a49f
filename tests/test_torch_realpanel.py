"""Real panels in the port: ``data/compustat.py`` and ``data/features.py``
against the JAX package's, on CSVs written by JAX ``to_long_frame`` from
synthetic panels (no download).

* ``load_compustat_csv``: the port's native and pandas engines (and
  "auto") against JAX's on the same files, every panel array byte-equal.
* ``add_derived_features``: byte-equal to JAX's, on a synthetic panel and
  on a loaded one; a bad spec raises JAX's error.
* Without pandas (a machine may lack it): ``write_long_csv`` writes the
  same rows, "auto" on a ``.csv`` parses natively, and the pandas paths
  raise a clear error.
* ``resolve_panel`` with ``panel_path`` and ``derived_features`` equals
  JAX's, and ``python -m lfm_quant_tpu_torch.train`` trains on such a
  panel.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

from lfm_quant_tpu.data.compustat import load_compustat_csv as jax_load
from lfm_quant_tpu.data.compustat import to_long_frame as jax_long
from lfm_quant_tpu.data.features import add_derived_features as jax_derive
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.train.loop import resolve_panel as jax_resolve
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data import compustat as C
from lfm_quant_tpu_torch.data.features import add_derived_features
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.train.__main__ import main as train_main
from lfm_quant_tpu_torch.train.loop import resolve_panel

FIELDS = ("features", "targets", "target_valid", "valid", "returns",
          "dates", "firm_ids", "ret_valid")
SPECS = ("mom_12_1", "vol_6", "rev_1", "chg_ebit_ev_3")
PANEL = dict(n_firms=60, n_months=130, n_features=4, seed=2)


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert list(a.feature_names) == list(b.feature_names)
    assert a.horizon == b.horizon


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("csv") / "panel.csv"
    jax_long(jax_synthetic(**PANEL)).to_csv(path, index=False)
    return str(path)


@pytest.mark.parametrize("kw", [
    {},
    dict(feature_cols=["book_to_market", "ebit_ev"],
         target_col="ebit_ev", horizon=6, winsor=(0.05, 0.95)),
])
def test_loader_engines_match_jax(csv_path, kw):
    want = jax_load(csv_path, engine="pandas", **kw)
    _same(jax_load(csv_path, engine="native", **kw), want)
    for engine in ("native", "pandas", "auto"):
        _same(C.load_compustat_csv(csv_path, engine=engine, **kw), want)
    with pytest.raises(ValueError, match="engine must be"):
        C.load_compustat_csv(csv_path, engine="arrow")


def test_derived_features_match_jax(csv_path):
    _same(add_derived_features(synthetic_panel(**PANEL), SPECS),
          jax_derive(jax_synthetic(**PANEL), SPECS))
    loaded = C.load_compustat_csv(csv_path, engine="native")
    _same(add_derived_features(loaded, ("mom_6_0", "vol_3")),
          jax_derive(jax_load(csv_path), ("mom_6_0", "vol_3")))
    for bad in ("mom_1_3", "chg_nope_2", "beta_12"):
        with pytest.raises(ValueError) as ours:
            add_derived_features(loaded, (bad,))
        with pytest.raises(ValueError) as theirs:
            jax_derive(jax_load(csv_path), (bad,))
        assert str(ours.value) == str(theirs.value)


def test_csv_path_without_pandas(csv_path, tmp_path, monkeypatch):
    """Without pandas: the port's writer gives the rows
    JAX ``to_long_frame`` gives, "auto" parses them natively to JAX's
    panel, and every pandas path says what is missing."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    out = str(tmp_path / "written.csv")
    rows = C.write_long_csv(synthetic_panel(**PANEL), out)
    assert rows == int(synthetic_panel(**PANEL).valid.sum())
    want = jax_load(csv_path, engine="native")
    _same(C.load_compustat_csv(out, engine="auto"), want)
    _same(C.load_compustat_csv(out, engine="native"), want)
    for call in (lambda: C.load_compustat_csv(out, engine="pandas"),
                 lambda: C.load_compustat_csv(str(tmp_path / "p.parquet")),
                 lambda: C.to_long_frame(want)):
        with pytest.raises(RuntimeError, match="needs pandas"):
            call()


def test_resolve_panel_and_train_cli_on_a_csv(csv_path, tmp_path, capsys):
    """``DataConfig.panel_path`` + ``derived_features`` resolve to JAX's
    panel; the train entry trains one epoch on it (its model's width is
    the base features plus the derived ones)."""
    d = dataclasses.replace(config.DataConfig(), panel_path=csv_path,
                            derived_features=("mom_12_1", "vol_6"),
                            horizon=12)
    got = resolve_panel(d)
    from lfm_quant_tpu import config as jax_config

    _same(got, jax_resolve(jax_config.DataConfig(
        panel_path=csv_path, derived_features=("mom_12_1", "vol_6"),
        horizon=12)))
    assert got.n_features == 6
    c2 = config.get_preset("c2")
    cfg = dataclasses.replace(
        c2, name="csv_c2", out_dir=str(tmp_path),
        data=dataclasses.replace(d, window=12, firms_per_date=16,
                                 dates_per_batch=4),
        model=dataclasses.replace(c2.model, kwargs={"hidden": 8}),
        optim=dataclasses.replace(c2.optim, epochs=1, warmup_steps=2))
    path = tmp_path / "csv.json"
    path.write_text(cfg.to_json())
    assert train_main(["--config", str(path), "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["epochs_run"] == 1 and np.isfinite(summary["best_val_ic"])
    assert summary["config"]["data"]["derived_features"] == ["mom_12_1",
                                                              "vol_6"]
