"""The scoring service of the port: zoo, micro-batcher, service, the
durable store and the fleet (``python -m lfm_quant_tpu_torch.serve``
drives it; ``python -m lfm_quant_tpu_torch.serve.fleet`` is a fleet
member)."""

from lfm_quant_tpu_torch.serve.batcher import ScoreResponse
from lfm_quant_tpu_torch.serve.fleet import (
    FleetCoordinator,
    FleetRouter,
    HttpMember,
    LocalMember,
    MemberJoinRefused,
)
from lfm_quant_tpu_torch.serve.persist import ZooStore
from lfm_quant_tpu_torch.serve.service import ScoringService

__all__ = ["FleetCoordinator", "FleetRouter", "HttpMember", "LocalMember",
           "MemberJoinRefused", "ScoreResponse", "ScoringService",
           "ZooStore"]
