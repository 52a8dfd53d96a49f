"""PyTorch/CUDA port of ``lfm_quant_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports nothing from it
and nothing of JAX. It serves, trains and scores the recurrent models:
``serve`` (the scoring service and ``python -m lfm_quant_tpu_torch.serve``),
``train`` (the trainer, the seed ensemble, walk-forward retraining and
``python -m lfm_quant_tpu_torch.train``), ``backtest`` and ``forecast``
(``python -m lfm_quant_tpu_torch.backtest`` / ``.forecast``), over
``models`` and the hand-written CUDA kernels in ``ops`` (``csrc/``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
