#!/usr/bin/env python
"""The JAX trainer's data-parallel gradient scale, on virtual CPU devices.

    python scripts/jax_dp_grad_scale.py

One ``_jit_step`` of the JAX ``Trainer`` on the first batch of epoch 0
(the ``tests/test_parallel.py`` panel, a GRU of hidden 16) at
``n_data_shards`` 1 and 4, for the mse and rank_ic losses: prints each
step's loss and ``grad_norm``. The losses agree; the sharded
``grad_norm`` is ``n_data`` times the one-device one (the loss parts are
psummed inside the differentiated function and the gradients psummed
again: ROADMAP.md Queue C). The PyTorch port is held to the one-device
gradients. Runs on the CPU with 8 virtual devices.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

from lfm_quant_tpu.config import (DataConfig, ModelConfig,  # noqa: E402
                                  OptimConfig, RunConfig)
from lfm_quant_tpu.data import PanelSplits, synthetic_panel  # noqa: E402
from lfm_quant_tpu.train import Trainer  # noqa: E402


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    panel = synthetic_panel(n_firms=150, n_months=150, n_features=5, seed=13)
    splits = PanelSplits.by_date(panel, 197910, 198101)
    print("| loss | shards | loss | grad_norm |")
    for loss in ("mse", "rank_ic"):
        for n in (1, 4):
            cfg = RunConfig(
                name=f"dp{n}",
                data=DataConfig(n_firms=150, n_months=150, n_features=5,
                                window=12, dates_per_batch=8,
                                firms_per_date=32),
                model=ModelConfig(kind="gru", kwargs={"hidden": 16}),
                optim=OptimConfig(lr=1e-3, epochs=2, warmup_steps=5,
                                  loss=loss),
                n_data_shards=n)
            t = Trainer(cfg, splits)
            b = next(iter(t.train_sampler.epoch(0)))
            _, m = t._jit_step(t.init_state(), t.dev,
                               *t._batch_args(b, train=True))
            print(f"| {loss} | {n} | {float(m['loss']):.7f} | "
                  f"{float(m['grad_norm']):.3f} |")


if __name__ == "__main__":
    main()
