"""Run dir → aggregated forecast: the port of
``lfm_quant_tpu/train/forecast.py``, shared by the two forecast consumers,
``python -m lfm_quant_tpu_torch.backtest`` (historical anchors, scored
against realized outcomes) and ``python -m lfm_quant_tpu_torch.forecast``
(live anchors, ``require_target=False``): one copy of the single-model /
ensemble branching and its validation rules.

The aggregation of stacked forecasts (a seed ensemble's, or a dropout
model's MC-dropout samples) runs on the model's device
(``backtest/torch_engine.aggregate_scores_device``);
``mean_minus_total_std`` takes the heteroscedastic members' aleatoric
variances from ``predict(return_variance=True)`` (a single
heteroscedastic model's alone, as a one-member stack).
"""

from __future__ import annotations

import os
from typing import Callable, Optional


def _raise_system_exit(msg: str):
    raise SystemExit(msg)


def is_ensemble_run_dir(run_dir: str) -> bool:
    """Whether the run dir holds a seed ensemble (its ``ensemble.flag``):
    a cheap check before ``load_forecaster`` restores a checkpoint."""
    return os.path.exists(os.path.join(run_dir, "ensemble.flag"))


def mark_ensemble_run_dir(run_dir: str, ensemble: bool) -> None:
    """Write (or remove) the ensemble marker: the ONE writer for every
    run-dir producer, so the flag is both created and CLEARED when a dir
    is reused by the other trainer kind (a stale flag would route
    ``load_forecaster`` to the wrong restore)."""
    path = os.path.join(run_dir, "ensemble.flag")
    if ensemble:
        with open(path, "w") as fh:
            fh.write("stacked-seed-axis checkpoint\n")
    elif os.path.exists(path):
        os.unlink(path)


def load_forecaster(run_dir: str, panel=None, device=None):
    """Load a run dir's trained model, single seed or ensemble (told apart
    by the ``ensemble.flag`` marker), its best checkpoint restored.

    Returns ``(model, splits, is_ensemble)``: a ``Trainer`` or an
    ``EnsembleTrainer`` on ``device`` (None means ``cuda``), over
    ``panel`` or the panel its config resolves to. Loading is separate
    from forecasting so callers can inspect the panel (date ranges, the
    live block) before choosing what to predict."""
    is_ensemble = is_ensemble_run_dir(run_dir)
    if is_ensemble:
        from lfm_quant_tpu_torch.train.ensemble import load_ensemble

        model, splits = load_ensemble(run_dir, panel=panel, device=device)
    else:
        from lfm_quant_tpu_torch.train.loop import load_trainer

        model, splits = load_trainer(run_dir, panel=panel, device=device)
    return model, splits, is_ensemble


def run_forecast(
    model,
    is_ensemble: bool,
    mode: str = "mean",
    risk_lambda: float = 1.0,
    mc_samples: int = 0,
    error: Optional[Callable[[str], None]] = None,
    **predict_kw,
):
    """Aggregated forecast from a loaded model.

    ``predict_kw`` flows into ``predict()``: ``split=`` for the backtest
    path, ``date_range=``/``require_target=False`` for the live path.
    ``error`` reports invalid flag combinations (argparse's ``ap.error``
    from the entry points; default raising ``SystemExit``) and must not
    return.

    Returns ``(forecast [N, T], valid [N, T])`` on the host.
    """
    from lfm_quant_tpu_torch.backtest.torch_engine import (
        aggregate_scores_device,
    )

    error = error or _raise_system_exit
    if is_ensemble and mc_samples > 0:
        error("--mc-samples applies to single-model run dirs only; "
              "this is a seed ensemble — its uncertainty comes from "
              "the seeds (use --mode mean_minus_std directly)")
    avar = None
    if mode == "mean_minus_total_std":
        if mc_samples > 0:
            error("--mode mean_minus_total_std is not combinable with "
                  "--mc-samples (dropout samples carry no aleatoric "
                  "head variance); use --mode mean_minus_std")
        # A single heteroscedastic model has no seed axis: the penalty
        # reduces to its aleatoric head alone.
        stacked, avar, valid = model.predict(return_variance=True,
                                             **predict_kw)
        if not is_ensemble:
            stacked, avar = stacked[None], avar[None]
    elif not is_ensemble and mc_samples == 0:
        if mode != "mean":
            error(f"--mode {mode} needs stacked forecasts: an ensemble run "
                  "dir or --mc-samples")
        return model.predict(**predict_kw)
    elif mc_samples > 0:
        stacked, valid = model.predict(mc_samples=mc_samples, **predict_kw)
    else:
        stacked, valid = model.predict(**predict_kw)
    scores, valid, _ = aggregate_scores_device(
        stacked, valid, [mode], risk_lambda, aleatoric_var=avar,
        device=model.device)
    return scores[0].cpu().numpy(), valid
