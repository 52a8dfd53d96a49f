"""Train a preset's model: the port of the single-model path of the JAX
package's ``train.py``.

    python -m lfm_quant_tpu_torch.train --preset c2 [--epochs N] [--out DIR]
    python -m lfm_quant_tpu_torch.train --preset c2 --scale 0.05 --device cpu

config → panel (``synthetic_panel`` from the preset's seed and sizes, or
a saved panel) → splits → ``Trainer.fit`` with early stopping; writes
``metrics.jsonl``, ``ckpt/latest``, ``ckpt/best``, ``config.json`` and
``summary.json`` into ``<out>/<name>/seed<seed>`` and prints the summary
as JSON. Runs on the card; ``--device cpu`` trains through the kernels'
plain versions. ``--scale`` shrinks the synthetic panel (firms and
months, never the model's widths). ``--resume`` continues from the run
directory's latest checkpoint with the same history.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--preset", help="ladder preset (c2, c3, or a full name)")
    g.add_argument("--config", help="path to a RunConfig JSON file")
    ap.add_argument("--seed", type=int, default=None, help="override seed")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override epochs")
    ap.add_argument("--out", default=None, help="override output dir")
    ap.add_argument("--echo", action="store_true",
                    help="print metrics lines")
    ap.add_argument("--scale", type=float, default=None,
                    help="shrink the synthetic panel by this factor")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in the run dir")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from lfm_quant_tpu_torch.config import RunConfig, get_preset
    from lfm_quant_tpu_torch.device import resolve_device
    from lfm_quant_tpu_torch.train.loop import run_experiment

    device = resolve_device(args.device)  # no card: raise before any work

    if args.preset:
        cfg = get_preset(args.preset)
    else:
        with open(args.config) as fh:
            cfg = RunConfig.from_json(fh.read())
    if cfg.n_seeds > 1:
        raise NotImplementedError(
            f"{cfg.name} trains {cfg.n_seeds} seeds: the seed ensemble is "
            "not ported yet (ROADMAP.md Queue A)")
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, epochs=args.epochs))
    if args.out is not None:
        cfg = dataclasses.replace(cfg, out_dir=args.out)
    if args.scale is not None:
        d = cfg.data
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            d,
            n_firms=max(64, int(d.n_firms * args.scale)),
            # Longer than the generator's min_history (72) with room for
            # the window and the splits.
            n_months=max(d.window + d.horizon + 96, 120,
                         int(d.n_months * args.scale)),
        ))
    summary, _, _ = run_experiment(cfg, echo=args.echo, resume=args.resume,
                                   device=device)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("history", "step_losses")},
                     indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
