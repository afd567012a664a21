"""a_modular_rag_framework_tpu — a modular RAG framework on a JAX device engine.

A ground-up JAX/XLA rebuild of the capabilities of
AndyUkJ/A-Modular-RAG-Framework (graph-enhanced multi-hop RAG with agent
collaboration): per-question evidence-graph construction, hybrid retrieval
(BM25 + graph neighborhood + dense), plan/synthesize reasoning, rules+LLM
verification, a verify-retry orchestration loop, settings-driven dependency
injection, and JSONL span telemetry.

Unlike the reference's per-hit Python pipeline, the retrieval core here is a
device-resident index-and-query engine:

- embeddings   -> batched XLA encoder inference (``models.encoder``)
- dense search -> device-resident index + exact matmul+top-k (``ops.topk``)
- BM25         -> CSR postings scored as scatter-add SpMV on device (``ops.bm25``)
- multi-hop    -> adjacency frontier expansion with per-hop decay (``ops.graph``)
- fusion       -> per-channel min-max norm + alpha-weighted sum + final top-k,
                  one device program (``ops.fusion``)

Agent collaboration and LLM prompting glue stay host-side. The device
currency is ``(ids: int32[B, K], scores: float32[B, K])``; host code only
hydrates metadata at the edges.

Layer map (mirrors SURVEY.md section 1 of the reference analysis):

  core/        L0-L2: providers, LLM router, DTO contracts, dataset loaders
  ops/         device ops in plain JAX (with NumPy-tested reference paths)
  index/       corpus ingest, tokenizer, packed on-device index artifact
  engine/      the query engine (dense+sparse+graph+fusion, single program)
  parallel/    mesh construction, sharded index/query via shard_map + pjit
  models/      encoder model family (hash-embed mock + transformer encoder)
  modules/     L3 agents: graph_construction, retrieval, reasoning, verification
  orchestrator/ L4 host state machine with the verify-retry loop
  di/          L5 config-driven factory (import-by-string, reflection filter)
  telemetry/   cross-cutting JSONL span sink + device timing
  cli/         L6 ingest / run / bench tooling
"""

__version__ = "0.1.0"
