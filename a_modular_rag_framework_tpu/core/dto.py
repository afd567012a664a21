"""Core data contracts (L2).

Dataclass DTOs mirroring the reference's module I/O contracts
(the reference's app/core/dto.py:9-209) plus the device currency:
retrieval hit batches travel between device programs as
``(ids: int32[B, K], scores: float32[B, K])`` arrays (`HitBatch`), and are
hydrated into per-hit `Hit` objects only at the host boundary.

The reference's contracts are pydantic models; these keep the part of that
surface callers use — keyword construction, nested ``Hit``/``EdgeEvidence``
lists given as dicts, ``model_dump()`` and ``model_copy()`` — with the
standard library only.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def _items(item_cls) -> Any:
    """A list field whose dict entries are built into ``item_cls``."""
    return field(default_factory=list, metadata={"item": item_cls})


class _Model:
    """model_dump / model_copy for the DTO dataclasses."""

    def __post_init__(self):
        for f in dataclasses.fields(self):
            item = f.metadata.get("item")
            if item is not None:
                setattr(self, f.name, [
                    item(**v) if isinstance(v, dict) else v
                    for v in getattr(self, f.name) or []])
            model = f.metadata.get("model")
            if model is not None and isinstance(getattr(self, f.name), dict):
                setattr(self, f.name, model(**getattr(self, f.name)))

    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def model_copy(self, *, update: Optional[Dict[str, Any]] = None,
                   deep: bool = False):
        src = copy.deepcopy(self) if deep else self
        return dataclasses.replace(src, **(update or {}))


# ========= Graph build =========


@dataclass(kw_only=True)
class GraphBuildIn(_Model):
    trace_id: str
    question_text: str = ""
    context: List[Any] = field(default_factory=list)

    graph_id: Optional[str] = None
    nodes: List[Dict[str, Any]] = field(default_factory=list)
    edges: List[Dict[str, Any]] = field(default_factory=list)

    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class GraphBuildOut(_Model):
    graph_id: str
    node_count: int
    edge_count: int

    nodes: Optional[List[Dict[str, Any]]] = None
    edges: Optional[List[Dict[str, Any]]] = None
    provenance: Optional[Dict[str, Any]] = None
    diagnostics: Optional[Dict[str, Any]] = None

    extra: Dict[str, Any] = field(default_factory=dict)


# ========= Retrieval =========


@dataclass(kw_only=True)
class RetrievalIn(_Model):
    query: str
    graph_id: str = ""
    top_k: int = 20
    trace_id: str
    # Optional per-request override of the graph expansion window (hops),
    # honored by the hybrid backend like the reference's req.graph_window.
    graph_window: Optional[int] = None


@dataclass(kw_only=True)
class Hit(_Model):
    id: str
    score: float
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.score = float(self.score)


@dataclass(kw_only=True)
class RetrievalOut(_Model):
    hits: List[Hit] = _items(Hit)
    diagnostics: Dict[str, Any] = field(default_factory=dict)
    model: Optional[str] = None


@dataclass(kw_only=True)
class HitBatch(_Model):
    """Device-side retrieval currency: a batch of top-K hits as arrays.

    ``ids`` are row indices into a corpus table (int32, shape [B, K]);
    ``scores`` are fused relevance scores (float32, shape [B, K]).
    ``-1`` ids mark padding (fewer than K real candidates).

    Host code converts to `Hit` lists via `hydrate` with a corpus metadata
    lookup. This replaces the reference's per-hit dict flow
    (retrieval_backend.py:336-372) with a single device->host transfer.
    """

    ids: Any  # np.ndarray int32 [B, K]
    scores: Any  # np.ndarray float32 [B, K]

    def hydrate(
        self,
        row: int,
        id_fn,
        meta_fn,
        extra_meta: Optional[Dict[str, Any]] = None,
    ) -> List[Hit]:
        """Convert one batch row into host `Hit`s, skipping padding."""
        ids = np.asarray(self.ids)[row]
        scores = np.asarray(self.scores)[row]
        hits: List[Hit] = []
        for i, s in zip(ids.tolist(), scores.tolist()):
            if i < 0:
                continue
            meta = dict(meta_fn(i) or {})
            if extra_meta:
                meta.update(extra_meta)
            hits.append(Hit(id=str(id_fn(i)), score=float(s), meta=meta))
        return hits


# ========= Reasoning =========


@dataclass(kw_only=True)
class ReasoningIn(_Model):
    question: str
    hits: List[Hit] = _items(Hit)
    graph_id: str = ""
    trace_id: str


@dataclass(kw_only=True)
class ReasoningOut(_Model):
    answer: str
    evidence_used: List[Hit] = _items(Hit)
    steps: List[Dict[str, Any]] = field(default_factory=list)
    model: Optional[str] = None


# ========= Verification =========


@dataclass(kw_only=True)
class VerifyIn(_Model):
    answer: str
    evidence: List[Hit] = _items(Hit)
    question: Optional[str] = None
    query: Optional[str] = None
    graph_id: Optional[str] = None
    trace_id: Optional[str] = None
    retry_round: int = 0


@dataclass(kw_only=True)
class VerifyOut(_Model):
    """Verifier output.

    ``status``: coarse "pass" | "fail" | "warn".
    ``status_detail``: fine-grained state — "fail", "high_conf_pass",
    "low_conf_pass", "unknown_pass" (see `modules.verification`).
    ``verdict``: fine verdict — PASS | PASS-WITH-NOISE | PARTIAL |
    FAIL-CONTRADICTED | FAIL-UNSUPPORTED | INCONCLUSIVE.
    Matches the contract of the reference verifier
    (/root/reference/app/core/dto.py:86-183).
    """

    status: str
    findings: List[Dict[str, Any]] = field(default_factory=list)
    model: Optional[str] = None

    ok: Optional[bool] = None
    score: Optional[float] = None
    issues: List[str] = field(default_factory=list)
    diagnostics: Dict[str, Any] = field(default_factory=dict)

    coverage_score: Optional[float] = None
    consistency_score: Optional[float] = None
    hallucination_risk: Optional[float] = None
    final_score: Optional[float] = None

    verdict: Optional[str] = None
    self_consistency: Optional[Dict[str, Any]] = None

    recommended_action: Optional[str] = None

    status_detail: Optional[str] = None
    status_detail_label: Optional[str] = None


# ========= Graph atoms =========


@dataclass(kw_only=True)
class EdgeEvidence(_Model):
    channel: str
    score: float
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class GraphNode(_Model):
    id: str
    type: str
    text: str
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class GraphEdge(_Model):
    source: str
    target: str
    type: str
    weight: float = 1.0
    meta: Dict[str, Any] = field(default_factory=dict)
    evidence: List[EdgeEvidence] = _items(EdgeEvidence)
