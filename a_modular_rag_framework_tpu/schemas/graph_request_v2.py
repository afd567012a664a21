"""v2 graph-assembly request schema.

Parity with /root/reference/app/schemas/graph_request_v2.py — the richer
request shape accepted by the v1->v2 adapter (`adapters.graph_request_adapter`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from ..core.dto import _Model, _items


@dataclass(kw_only=True)
class Sentence(_Model):
    id: str
    text: str
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class Inputs(_Model):
    sentences: List[Sentence] = _items(Sentence)
    nodes: List[Dict[str, Any]] = field(default_factory=list)
    edges: List[Dict[str, Any]] = field(default_factory=list)


@dataclass(kw_only=True)
class AssembleGraphRequestV2(_Model):
    api_version: str = "v2"
    graph_id: str
    inputs: Inputs = field(default_factory=Inputs, metadata={"model": Inputs})
    options: Dict[str, Any] = field(default_factory=dict)
