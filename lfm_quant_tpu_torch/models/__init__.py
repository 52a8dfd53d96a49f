"""Factor models of the port. This slice carries the recurrent models
(LSTM, GRU); the others are listed in ROADMAP.md Queue A."""

from lfm_quant_tpu_torch.models.rnn import RNNModel

_NOT_PORTED = ("mlp", "transformer", "lru")


def build_model(kind: str, n_features: int, **kwargs) -> RNNModel:
    """Construct a model by registry name. Unlike Flax, a torch module
    needs its input width up front: ``n_features`` is the panel's."""
    if kind in ("lstm", "gru"):
        return RNNModel(n_features, cell=kind, **kwargs)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"model kind {kind!r} is not ported yet: ROADMAP.md Queue A "
            "(models)")
    raise ValueError(
        f"unknown model kind {kind!r}; available: lstm, gru "
        f"(not ported yet: {', '.join(_NOT_PORTED)})")


__all__ = ["RNNModel", "build_model"]
