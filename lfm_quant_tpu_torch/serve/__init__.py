"""The scoring service of the port: zoo, micro-batcher and service
(``python -m lfm_quant_tpu_torch.serve`` drives it)."""

from lfm_quant_tpu_torch.serve.batcher import ScoreResponse
from lfm_quant_tpu_torch.serve.service import ScoringService

__all__ = ["ScoreResponse", "ScoringService"]
