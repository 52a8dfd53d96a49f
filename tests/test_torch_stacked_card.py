"""The stacked runs on the card (``cuda``-marked; skipped without one).

This file imports no jax: it runs on the card machine, beside
``chip_smoke.py``'s phase 26.

A 4-run stacked c2 step (LSTM 128, window 60, bf16; a cut panel): the
member stack's steps against each run's own sequential steps from the
same init and batches, the per-step losses within the training gate
(atol 0.05 + rtol 0.05); the stacked steps launch the gather's seed fold
and the seed grids of the fused forward and backward ONCE per step for
all 4 runs, the sequential ones once per run and step. Whether the runs
came out bitwise is printed, not gated: the bf16 launcher picks its row
tile from the total rows (``ops/rnn.py _mma_rows``), so 4 members may
reduce in another order than one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch.config import get_preset
from lfm_quant_tpu_torch.data.panel import PanelSplits
from lfm_quant_tpu_torch.ops import _build
from lfm_quant_tpu_torch.train import stacked as ST
from lfm_quant_tpu_torch.train.loop import (Trainer, default_split_dates,
                                            resolve_panel)

pytestmark = pytest.mark.cuda

KERNELS = ("window_gather", "rnn_fused_fwd_mma_lstm",
           "rnn_fused_bwd_mma_lstm")
STEPS = 4
TOL = 0.05


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (python3 chip_smoke.py runs "
                    "phase 26 there)")


def test_stacked_c2_steps_against_sequential_steps(card, capsys):
    c2 = get_preset("c2")
    cfg = dataclasses.replace(c2, data=dataclasses.replace(
        c2.data, n_firms=600, n_months=200))
    panel = resolve_panel(cfg.data)
    splits = PanelSplits.by_date(panel, *default_split_dates(panel,
                                                             cfg.data))
    grid = ST.parse_sweep_grid("lr=1e-3,3e-4;weight_decay=1e-4,0")
    runs = [dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                               **g))
            for g in grid]
    eng = ST.StackedRuns(runs, [splits] * len(runs), panel, device="cuda")
    state = eng.init_carry().state
    (fi, ti, w, _), _ = eng.build_epoch(0)
    _build.reset_launch_counts()
    stacked = []
    for k in range(STEPS):
        state, ms = eng.trainer.step(state, fi[k], ti[k], w[k])
        stacked.append(ms["loss"])
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    for name in KERNELS:
        assert counts[name] == STEPS, (name, counts)
    stacked = torch.stack(stacked).float().cpu().numpy()
    bitwise = True
    for r, rc in enumerate(runs):
        one = Trainer(rc, splits, device="cuda")
        st = one.init_state()
        b = one.train_sampler.stacked_epoch(0)
        f1, t1, w1 = one._batch(b)
        assert torch.equal(f1[:STEPS], fi[:STEPS, r])
        _build.reset_launch_counts()
        losses = []
        for k in range(STEPS):
            st, ms = one.step(st, f1[k], t1[k], w1[k])
            losses.append(float(ms["loss"]))
        assert _build.launch_counts()["rnn_fused_bwd_mma_lstm"] == STEPS
        err = np.abs(stacked[:, r] - np.asarray(losses))
        assert (err <= TOL + TOL * np.abs(losses)).all(), (r, err)
        bitwise &= bool(np.array_equal(stacked[:, r],
                                       np.asarray(losses, np.float32)))
    with capsys.disabled():
        print(f"\n4-run stacked c2 steps bitwise against their sequential "
              f"steps: {bitwise}")
