from .flow import RetrievalAgentFlow
from .engine_backend import EngineRetrievalBackend
from .retrieval_adapter import RetrievalAdapter

__all__ = ["RetrievalAdapter", "RetrievalAgentFlow", "EngineRetrievalBackend"]
