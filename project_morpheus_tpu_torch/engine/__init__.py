"""Device-resident continuous-batching decode engine."""

from .engine import EngineConfig, OrpheusEngine
from .request import Request, RequestState

__all__ = ["OrpheusEngine", "EngineConfig", "Request", "RequestState"]
