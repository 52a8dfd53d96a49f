"""Experiment configuration: the JAX package's dataclasses and presets.

A copy of ``lfm_quant_tpu/config.py`` (the port imports nothing from the
JAX package). The dataclasses and ``PRESETS`` are field for field the
same, so a config JSON written by either package loads in the other.
What differs is what the config resolves to: ``compute_dtype`` returns a
torch dtype, and ``model_kwargs`` maps ``scan_impl`` onto the port's
recurrences.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

#: The two supported compute-precision lanes.
PRECISIONS = ("f32", "bf16")


def resolve_precision(cfg: Optional["RunConfig"] = None) -> str:
    """The whole-stack compute-precision lane: an explicit
    ``RunConfig.precision`` wins, else the ``LFM_PRECISION`` env knob,
    else ``"f32"``."""
    p = ((cfg.precision if cfg is not None else "")
         or os.environ.get("LFM_PRECISION", "")) or "f32"
    if p not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {p!r} "
            "(RunConfig.precision / LFM_PRECISION)")
    return p


def compute_dtype(cfg: "RunConfig") -> Optional[torch.dtype]:
    """``torch.bfloat16`` when the per-model ``bf16`` flag or the
    precision lane selects it, else None (f32 compute). The one source
    that model construction and device-panel residency both read."""
    if cfg.model.bf16 or resolve_precision(cfg) == "bf16":
        return torch.bfloat16
    return None


@dataclasses.dataclass
class DataConfig:
    """Panel + windowing parameters."""

    n_firms: int = 1000
    n_months: int = 240
    n_features: int = 5
    start_yyyymm: int = 197001
    window: int = 60
    horizon: int = 12
    dates_per_batch: int = 8
    # Firms sampled per month row; 0 = full universe.
    firms_per_date: int = 128
    min_valid_months: Optional[int] = None
    train_end: Optional[int] = None
    val_end: Optional[int] = None
    train_start: Optional[int] = None
    panel_path: Optional[str] = None
    target_col: Optional[str] = None
    panel_seed: int = 0
    het_noise: float = 0.0
    sampler_engine: str = "python"
    # Window gather: "auto" and "pallas" pick the hand-written gather
    # kernel (ops/gather.py) on the card for serving and the train step;
    # the validation sweep takes it only for "pallas" (as the JAX
    # trainer); "xla" the plain gather everywhere.
    gather_impl: str = "auto"  # auto | xla | pallas
    derived_features: Tuple[str, ...] = ()


@dataclasses.dataclass
class ModelConfig:
    """Model selection + hyperparameters."""

    kind: str = "mlp"  # mlp | lstm | gru | transformer | lru
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    bf16: bool = False
    heteroscedastic: bool = False
    # auto | xla | pallas | pallas_fused (see model_kwargs).
    scan_impl: str = "auto"


@dataclasses.dataclass
class OptimConfig:
    """Optimizer / schedule / stopping."""

    lr: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    grad_clip: float = 1.0
    epochs: int = 20
    early_stop_patience: int = 5
    loss: str = "mse"  # mse | huber | rank_ic | nll
    optimizer: str = "adamw"


@dataclasses.dataclass
class RunConfig:
    """Top-level experiment config."""

    name: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    seed: int = 0
    n_seeds: int = 1
    n_data_shards: int = 1
    n_seq_shards: int = 1
    precision: str = ""
    seed_block: int = 0
    compilation_cache_dir: Optional[str] = None
    out_dir: str = "runs"

    @property
    def is_heteroscedastic(self) -> bool:
        """Whether the built model carries a (mean, log_var) head."""
        return self.model.heteroscedastic or self.optim.loss == "nll"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        raw = json.loads(text)
        return RunConfig(
            name=raw.get("name", "default"),
            data=DataConfig(**raw.get("data", {})),
            model=ModelConfig(**raw.get("model", {})),
            optim=OptimConfig(**raw.get("optim", {})),
            seed=raw.get("seed", 0),
            n_seeds=raw.get("n_seeds", 1),
            n_data_shards=raw.get("n_data_shards", 1),
            n_seq_shards=raw.get("n_seq_shards", 1),
            precision=raw.get("precision", ""),
            seed_block=raw.get("seed_block", 0),
            compilation_cache_dir=raw.get("compilation_cache_dir"),
            out_dir=raw.get("out_dir", "runs"),
        )


def _ladder() -> Dict[str, RunConfig]:
    """The capability-ladder presets, as the JAX package defines them."""
    c1 = RunConfig(
        name="c1_mlp_toy",
        data=DataConfig(n_firms=1000, n_months=240, n_features=5, window=12,
                        dates_per_batch=8, firms_per_date=128),
        model=ModelConfig(kind="mlp", kwargs={"hidden": (64, 32)}),
        optim=OptimConfig(lr=1e-3, epochs=20, loss="mse"),
    )
    c2 = RunConfig(
        name="c2_lstm_single",
        data=DataConfig(n_firms=4000, n_months=480, n_features=20, window=60,
                        dates_per_batch=8, firms_per_date=256),
        model=ModelConfig(kind="lstm", kwargs={"hidden": 128}, bf16=True),
        optim=OptimConfig(lr=1e-3, epochs=30, loss="mse"),
    )
    c3 = RunConfig(
        name="c3_gru_rank_ic",
        data=DataConfig(n_firms=8000, n_months=480, n_features=20, window=60,
                        dates_per_batch=8, firms_per_date=0),
        model=ModelConfig(kind="gru", kwargs={"hidden": 128}, bf16=True),
        optim=OptimConfig(lr=5e-4, epochs=30, loss="rank_ic"),
        n_data_shards=8,
    )
    c4 = RunConfig(
        name="c4_transformer_bf16",
        data=DataConfig(n_firms=8000, n_months=480, n_features=20, window=60,
                        dates_per_batch=16, firms_per_date=512),
        model=ModelConfig(kind="transformer",
                          kwargs={"dim": 64, "depth": 2, "heads": 4}, bf16=True),
        optim=OptimConfig(lr=5e-4, epochs=30, loss="mse"),
        n_data_shards=16,
    )
    c5 = RunConfig(
        name="c5_lstm_ensemble64",
        data=DataConfig(n_firms=8000, n_months=660, n_features=20, window=60,
                        start_yyyymm=197001, dates_per_batch=8,
                        firms_per_date=256),
        model=ModelConfig(kind="lstm", kwargs={"hidden": 128}, bf16=True),
        optim=OptimConfig(lr=1e-3, epochs=30, loss="mse"),
        n_seeds=64,
        n_data_shards=1,
    )
    lru = RunConfig(
        name="lru_c2_geometry",
        data=dataclasses.replace(c2.data),
        model=ModelConfig(kind="lru",
                          kwargs={"hidden": 128, "state_dim": 128},
                          bf16=True),
        optim=OptimConfig(lr=1e-3, epochs=30, loss="mse"),
    )
    lru64 = dataclasses.replace(
        lru,
        name="lru64_c5_ensemble",
        data=dataclasses.replace(c5.data),
        model=dataclasses.replace(lru.model,
                                  kwargs=dict(lru.model.kwargs)),
        n_seeds=64,
        n_data_shards=1,
    )
    lc = RunConfig(
        name="lc_transformer_seq8",
        data=DataConfig(n_firms=4000, n_months=600, n_features=20,
                        window=240, dates_per_batch=8, firms_per_date=128),
        model=ModelConfig(kind="transformer",
                          kwargs={"dim": 64, "depth": 2, "heads": 4},
                          bf16=True),
        optim=OptimConfig(lr=5e-4, epochs=30, loss="mse"),
        n_seq_shards=8,
    )
    return {c.name: c for c in (c1, c2, c3, c4, c5, lru, lru64, lc)}


PRESETS: Dict[str, RunConfig] = _ladder()
# Short aliases from the names themselves ("c2_lstm_single" → "c2").
for _name, _cfg in list(PRESETS.items()):
    _alias = _name.split("_")[0]
    if _alias in PRESETS and PRESETS[_alias] is not _cfg:
        raise ValueError(
            f"preset alias {_alias!r} (from {_name!r}) collides with an "
            f"existing preset/alias; rename the preset")
    PRESETS[_alias] = _cfg
del _name, _cfg, _alias


def get_preset(name: str) -> RunConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: "
            f"{sorted(k for k in PRESETS if not k.startswith('c') or len(k) > 2)}"
        ) from None


def model_kwargs(cfg: RunConfig) -> Tuple[str, Dict[str, Any]]:
    """Resolve ModelConfig into ``build_model(kind, n_features, **kwargs)``
    arguments.

    ``scan_impl``: "auto" and "pallas_fused" select the fused recurrence
    (``ops/rnn.py rnn_scan_fused``: the hand-written kernels for tensors
    on the card, their plain versions for tensors on the CPU); "pallas"
    the recurrence over a hoisted input projection (``rnn_scan``, the
    same split); "xla" the plain recurrence on any device, differentiated
    by autograd.
    """
    kw = dict(cfg.model.kwargs)
    if compute_dtype(cfg) is not None:
        kw["dtype"] = torch.bfloat16
    if cfg.is_heteroscedastic:
        kw["heteroscedastic"] = True
    if cfg.model.kind in ("lstm", "gru") and "scan_impl" not in kw:
        impl = cfg.model.scan_impl
        if impl in ("auto", "pallas_fused"):
            kw["scan_impl"] = "fused"
        elif impl == "xla":
            kw["scan_impl"] = "plain"
        elif impl == "pallas":
            kw["scan_impl"] = "hoisted"
        else:
            raise ValueError(
                "scan_impl must be auto|xla|pallas|pallas_fused, got "
                f"{impl!r}")
    return cfg.model.kind, kw
