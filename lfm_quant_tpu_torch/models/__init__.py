"""Factor models of the port, every kind of the JAX package's registry:
the MLP, the recurrent models (LSTM, GRU), the transformer encoder and
the LRU. All share one calling convention, ``model(x [B, W, F], m [B, W],
rng=None)`` → ``[B]`` f32 forecasts (or ``(mean, log_var)``), and take
``n_seeds=S`` for a seed-stacked ensemble."""

from typing import Optional

from torch import nn

from lfm_quant_tpu_torch.models.lru import LRUModel
from lfm_quant_tpu_torch.models.mlp import MLPModel
from lfm_quant_tpu_torch.models.rnn import RNNModel
from lfm_quant_tpu_torch.models.transformer import TransformerModel

#: Model kinds whose param shapes depend on the window length.
_WINDOWED = {"mlp": MLPModel, "transformer": TransformerModel}
KINDS = ("mlp", "lstm", "gru", "transformer", "lru")


def build_model(kind: str, n_features: int, window: Optional[int] = None,
                **kwargs) -> nn.Module:
    """Construct a model by registry name. Unlike Flax, a torch module
    needs its input widths up front: ``n_features`` is the panel's, and
    ``window`` the lookback length (read by the MLP and the transformer,
    whose first layer or position table it sizes)."""
    if kind in _WINDOWED:
        if window is None:
            raise ValueError(f"model kind {kind!r} needs the window length")
        return _WINDOWED[kind](n_features, window, **kwargs)
    if kind in ("lstm", "gru"):
        return RNNModel(n_features, cell=kind, **kwargs)
    if kind == "lru":
        return LRUModel(n_features, **kwargs)
    raise ValueError(
        f"unknown model kind {kind!r}; available: {', '.join(KINDS)}")


__all__ = ["KINDS", "LRUModel", "MLPModel", "RNNModel", "TransformerModel",
           "build_model"]
