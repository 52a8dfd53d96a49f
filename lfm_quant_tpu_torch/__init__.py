"""PyTorch/CUDA port of ``lfm_quant_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports nothing from it
and nothing of JAX. This slice serves the recurrent models end to end:
``serve`` (the scoring service and ``python -m lfm_quant_tpu_torch.serve``)
over ``train/loop.py``'s predictor, ``models`` and the hand-written CUDA
kernels in ``ops`` (``csrc/``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
