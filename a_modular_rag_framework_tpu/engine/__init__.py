from .query_engine import EngineConfig, QueryResult, QueryEngine

__all__ = ["EngineConfig", "QueryResult", "QueryEngine"]
