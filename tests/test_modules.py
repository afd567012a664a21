"""Agent-module tests: graph construction (golden-ish), reasoning strategies,
verifier channels, adapters."""
import json

import numpy as np
import pytest

from a_modular_rag_framework_tpu.adapters.graph_request_adapter import (
    hotpotqa_to_v2,
    normalize_title,
    upgrade_to_v2,
)
from a_modular_rag_framework_tpu.core.dto import (
    GraphBuildIn,
    Hit,
    ReasoningIn,
    RetrievalIn,
    RetrievalOut,
    VerifyIn,
)
from a_modular_rag_framework_tpu.core.llm_router import LLMRouter
from a_modular_rag_framework_tpu.core.providers.mock_provider import MockProvider
from a_modular_rag_framework_tpu.modules.graph_construction.edge_builder import EdgeBuilder
from a_modular_rag_framework_tpu.modules.graph_construction.impl_arrays import (
    GraphConstructionArrays,
)
from a_modular_rag_framework_tpu.modules.graph_construction.node_builder import NodeBuilder
from a_modular_rag_framework_tpu.modules.graph_construction.segmenter import (
    segment_context,
    simple_rule_split,
)
from a_modular_rag_framework_tpu.modules.reasoning import strategies
from a_modular_rag_framework_tpu.modules.reasoning.impl_planner_synth import (
    ReasoningAgentPlannerSynth,
)
from a_modular_rag_framework_tpu.modules.retrieval.query_expander import LLMQueryExpander
from a_modular_rag_framework_tpu.modules.retrieval.retrieval_adapter import RetrievalAdapter
from a_modular_rag_framework_tpu.modules.verification.impl_rules_llm import (
    VerifierAgentRulesLLM,
    extract_citation_ids,
    map_fine_verdict,
)

CONTEXT = [
    ("Alpha Doc", ["Alice Smith was born in Paris.",
                   "Alice Smith worked with Bob Jones."]),
    ("Beta Doc", ["Bob Jones lived in Rome.", "Bob Jones played the cello."]),
]
QUESTION = "Where was Alice Smith born?"


def mock_router():
    policy = {"default": [{"model": "m", "provider": "mock"}],
              "embedding_provider": "mock"}
    return LLMRouter(providers={"mock": MockProvider()}, policy=policy)


# ---------------- graph construction ----------------


def test_node_builder_structure():
    nb = NodeBuilder(enable_segmentation=False)
    nodes = nb.build(QUESTION, CONTEXT, {})
    by_type = {}
    for n in nodes:
        by_type.setdefault(n.type, []).append(n)
    assert [n.id for n in by_type["question"]] == ["q1"]
    sent_ids = [n.id for n in by_type["sentence"]]
    assert "Alpha Doc::sent0" in sent_ids and "Beta Doc::sent1" in sent_ids
    assert {n.id for n in by_type["document"]} == {"doc::Alpha Doc", "doc::Beta Doc"}
    ent_texts = {n.text for n in by_type["entity"]}
    assert "Alice Smith" in ent_texts and "Bob Jones" in ent_texts
    assert nb.last_diagnostics["node_counts"]["sentence"] == 4


def test_segmenter_rule_and_embed():
    assert simple_rule_split("One. Two! Three?") == ["One", "Two", "Three"]
    ctx = [("D", ["Alpha beta. Gamma delta."])]
    out = segment_context(ctx, strategy="rule")
    assert out[0][1] == ["Alpha beta", "Gamma delta"]

    # embed: identical adjacent sentences merge; orthogonal ones split
    def embed(texts):
        return np.array([[1.0, 0.0] if "cat" in t else [0.0, 1.0] for t in texts])

    ctx2 = [("D", ["cat a", "cat b", "dog c"])]
    out2 = segment_context(ctx2, strategy="embed", embed_fn=embed, sim_threshold=0.5)
    assert out2[0][1] == ["cat a cat b", "dog c"]


def test_edge_builder_channels_and_vote():
    nb = NodeBuilder(enable_segmentation=False)
    nodes = [n.model_dump() for n in nb.build(QUESTION, CONTEXT, {})]
    # settings.json policy: vote fusion on, but no min-vote pruning
    eb = EdgeBuilder(semantic_threshold=0.99,
                     assembly_policy={"channels": {"q_overlap": 1.0,
                                                   "embed_sim": 1.0,
                                                   "entity_link": 0.6,
                                                   "position_prior": 0.2},
                                      "edge_min_vote": 0,
                                      "max_edges_per_node": 0})
    edges = eb.build(nodes, QUESTION, {})
    types = {e["type"] for e in edges}
    assert {"next_in_doc", "in_doc", "q_match", "mentions"} <= types
    # q_match weight = vote(q_overlap * 1.0) <= 1
    qm = [e for e in edges if e["type"] == "q_match"]
    assert qm and all(0 < e["weight"] <= 1 for e in qm)
    # evidence recorded
    assert any(e.get("evidence") for e in edges)
    diag = eb.last_diagnostics
    assert diag["edge_counts"] and diag["total_edges"] == len(edges)


def test_edge_builder_min_vote_prunes():
    nb = NodeBuilder(enable_segmentation=False, use_entity_nodes=False)
    nodes = [n.model_dump() for n in nb.build(QUESTION, CONTEXT, {})]
    eb = EdgeBuilder(assembly_policy={"channels": {"q_overlap": 1.0,
                                                   "position_prior": 0.2},
                                      "edge_min_vote": 0.9,
                                      "max_edges_per_node": 0})
    edges = eb.build(nodes, QUESTION, {})
    assert all(e["weight"] >= 0.9 for e in edges)


def test_graph_impl_persists_reference_format(tmp_path):
    nb = NodeBuilder(enable_segmentation=False)
    nodes = [n.model_dump() for n in nb.build(QUESTION, CONTEXT, {})]
    eb = EdgeBuilder()
    edges = eb.build(nodes, QUESTION, {})
    impl = GraphConstructionArrays(root_dir=str(tmp_path), write_analysis=True)
    out = impl.build(GraphBuildIn(trace_id="t", graph_id="g1", nodes=nodes,
                                  edges=edges,
                                  extra={"edge_builder_diagnostics": eb.last_diagnostics}))
    assert out.node_count == len(nodes)
    g = json.loads((tmp_path / "g1" / "graph.json").read_text())
    assert g["graph_id"] == "g1"
    assert {"id"} <= set(g["nodes"][0])
    assert {"source", "target", "type"} <= set(g["edges"][0])
    # packed adjacency exists with q_match seeds
    adj = np.load(tmp_path / "g1" / "adjacency.npz", allow_pickle=True)
    assert adj["neighbors"].shape[0] == len(nodes)
    assert len(adj["qmatch_seeds"]) > 0
    assert (tmp_path / "g1" / "manifest.json").exists()
    assert (tmp_path / "g1" / "analysis" / "connectivity.json").exists()
    assert out.diagnostics["edge_builder_diagnostics"]


def test_graph_flow_end_to_end(tmp_path):
    from a_modular_rag_framework_tpu.modules.graph_construction.flow import (
        GraphConstructionFlow,
    )

    impl = GraphConstructionArrays(root_dir=str(tmp_path), write_analysis=False)
    flow = GraphConstructionFlow(impl=impl, router=mock_router())
    out = flow.build(GraphBuildIn(trace_id="t2", question_text=QUESTION,
                                  context=CONTEXT))
    assert out.node_count > 0 and out.edge_count > 0
    assert out.diagnostics["node_builder_diagnostics"]["node_counts"]["sentence"] > 0
    assert "t_build_sec" in out.diagnostics


# ---------------- adapters / schemas ----------------


def test_request_adapters():
    assert normalize_title("  A b/c ") == "A_b_c"
    v2 = upgrade_to_v2({"question": "Who?", "nodes": [], "edges": []},
                       default_trace_id="tr")
    assert v2.inputs.sentences[0].text == "Who?"
    v2b = hotpotqa_to_v2({"context": [["Doc A", ["s0", "s1"]]]}, trace_id="tr")
    kinds = {e["kind"] for e in v2b.inputs.edges}
    assert kinds == {"q2doc", "doc2sent", "next_sent"}


# ---------------- retrieval glue ----------------


def test_query_expander_llm_plus_fallbacks():
    exp = LLMQueryExpander(mock_router(), lines=3)
    out = exp.expand(query="What is the nationality of Alice Smith?", trace_id="t")
    assert 1 <= len(out) <= 3
    # fallbacks fire without a router
    exp2 = LLMQueryExpander(None, lines=3)
    out2 = exp2.expand(query="nationality of Alice", trace_id="t")
    assert out2 and any("born in" in q or "citizen of" in q for q in out2)


def test_retrieval_adapter_normalizes_shapes():
    class FakeBackend:
        def retrieve(self, req):
            return {"hits": [
                {"doc_id": "d1", "relevance": 0.7, "text": "hello"},
                {"id": "d2", "score": 0.5, "meta": {"text": "world"}},
                {"nonsense": True},
            ], "diagnostics": {"x": 1}}

    ad = RetrievalAdapter(FakeBackend())
    out = ad.retrieve(RetrievalIn(query="q", graph_id="", trace_id="t"))
    assert [h.id for h in out.hits] == ["d1", "d2"]
    assert out.hits[0].score == 0.7 and out.hits[0].meta.get("text") == "hello"
    assert out.diagnostics == {"x": 1}


# ---------------- reasoning ----------------


def _hits():
    return [
        Hit(id="h0", score=0.9, meta={"doc": "Alpha Doc", "sent_id": 0,
                                      "text": "Alice Smith was born in Paris."}),
        Hit(id="h1", score=0.8, meta={"doc": "Alpha Doc", "sent_id": 1,
                                      "text": "Alice Smith worked with Bob Jones."}),
        Hit(id="h2", score=0.7, meta={"doc": "Beta Doc", "sent_id": 0,
                                      "text": "Bob Jones lived in Rome."}),
    ]


def test_strategies_evidence_selection_and_citations():
    steps = ["Find where Alice Smith was born"]
    evid, used = strategies.select_evidence_for_steps(
        steps, _hits(), per_step_k=2, min_score=0.01,
        require_entities=["Alice"],
    )
    assert 0 in evid[0]  # the birth sentence is selected
    block = strategies.build_citation_block(_hits(), used)
    assert block.splitlines()[0].startswith("[#1]")
    assert "Alice Smith" in block


def test_strategies_channel_fusion_changes_ranking():
    hits = _hits()
    # boost h2 via channel norms; lexical prefers h0
    hits[2].meta.update({"score_text_norm": 1.0, "score_dense_norm": 1.0,
                         "score_graph_norm": 1.0})
    hits[0].meta.update({"score_text_norm": 0.0, "score_dense_norm": 0.0,
                         "score_graph_norm": 0.0})
    evid, _ = strategies.select_evidence_for_steps(
        ["Bob Jones"], hits, per_step_k=1, min_score=0.0)
    assert evid[0][0] in (1, 2)  # entity-bearing, channel-boosted


def test_strategies_anchor_filter_and_twin_penalty():
    """The evidence selector's multi-hop machinery (the e2e EM
    0.44 -> 0.99 fix): (a) a first-name twin distractor loses to the
    full-phrase match; (b) hop-2 evidence anchors through the CARRIED
    bridge entity; (c) anchorless stranger sentences never enter picks."""
    hits = [
        Hit(id="h0", score=0.9, meta={"doc": "Tove Kelanan", "sent_id": 0,
            "text": "Tove Kelanan collaborated closely with Corin Loranan."}),
        Hit(id="h1", score=0.85, meta={"doc": "Tove Norlorcor", "sent_id": 0,
            "text": "Tove Norlorcor was born in the city of Amberfield."}),
        Hit(id="h2", score=0.8, meta={"doc": "Corin Loranan", "sent_id": 0,
            "text": "Corin Loranan was born in the city of Junewood."}),
        Hit(id="h3", score=0.75, meta={"doc": "Iris Ulzelbel", "sent_id": 0,
            "text": "Iris Ulzelbel was born in the city of Oakhaven."}),
        Hit(id="h4", score=0.7, meta={"doc": "Tove Kelanan", "sent_id": 1,
            "text": "Critics praised the work of Tove Kelanan on maps."}),
    ]
    steps = ["Find facts about Tove Kelanan: city collaborator born.",
             "Answer: city collaborator tove kelanan born."]
    evid, used = strategies.select_evidence_for_steps(
        steps, hits, per_step_k=2, min_score=0.01,
        require_entities=["In", "Tove", "Kelanan"],
        entity_phrases=["Tove Kelanan"],
    )
    # step 1: the bridge is picked (the twin penalty keeps the distractor
    # from outranking it even though "born city" matches its predicates)
    assert 0 in evid[0]
    # step 2: the birth sentence anchors via the CARRIED bridge entity
    # (without the carry it would be filtered as unanchored)
    assert 2 in evid[1]
    # the anchorless stranger never enters any pick
    assert all(3 not in e for e in evid)


def test_strategies_neighbor_expansion():
    got = strategies.expand_with_neighbors({0}, _hits(), window=1, max_expand=5)
    assert got == {0, 1}  # Alpha Doc sent 0 -> sent 1


def test_majority_vote_normalization():
    ans, votes = strategies.majority_vote(
        ["Paris [#1]", "paris!", "Rome [#2]"])
    assert strategies.normalize_answer(ans) == "paris"
    assert votes["paris"] == 2


def test_reasoner_end_to_end_mock():
    r = ReasoningAgentPlannerSynth(mock_router(), sc_runs=3, n_drafts=1)
    out = r.reason(ReasoningIn(question=QUESTION, hits=_hits(), graph_id="g",
                               trace_id="t"))
    assert "Paris" in out.answer and "[#" in out.answer
    assert out.model == "planner+synth+react"
    assert out.evidence_used
    plan = out.steps[0]["plan"]
    assert plan


# ---------------- verification ----------------


def test_extract_citations_and_verdict_map():
    assert extract_citation_ids("x [#1] y [#12]") == [1, 12]
    assert map_fine_verdict(False, False, True, False, 1.0) == "FAIL-CONTRADICTED"
    assert map_fine_verdict(True, False, False, False, 0.4) == "INCONCLUSIVE"
    assert map_fine_verdict(True, False, False, True, 1.0) == "PASS-WITH-NOISE"
    assert map_fine_verdict(True, False, False, False, 1.0) == "PASS"
    assert map_fine_verdict(False, True, False, False, 1.0) == "PARTIAL"
    assert map_fine_verdict(True, False, True, False, 1.0, core_indirect=True) == "PARTIAL"


def test_verifier_pass_on_supported_answer():
    v = VerifierAgentRulesLLM(mock_router(), sc_runs=3,
                              require_citation_in_answer=False,
                              weight_rules=0.3, weight_llm=0.7)
    out = v.verify(VerifyIn(answer="Alice Smith was born in Paris. [#1]",
                            evidence=_hits(), question=QUESTION, trace_id="t"))
    assert out.status == "pass"
    assert out.verdict in ("PASS", "PASS-WITH-NOISE", "PARTIAL")
    assert out.final_score and out.final_score > 0.5
    assert out.self_consistency["runs"] == 3
    assert out.diagnostics["claim_check"]["results"] is not None
    assert out.status_detail_label


def test_verifier_empty_answer_fails_rules():
    v = VerifierAgentRulesLLM(mock_router(), sc_runs=1, use_llm=False)
    out = v.verify(VerifyIn(answer="", evidence=[], question="q", trace_id="t"))
    assert out.coverage_score == 0.0
    assert "Empty answer." in out.issues


def test_verifier_claim_check_with_external_retriever():
    calls = []

    def retriever(claim, entities, trace_id):
        calls.append(claim)
        return [Hit(id="e1", score=1.0,
                    meta={"text": "Alice Smith was born in Paris."})]

    v = VerifierAgentRulesLLM(mock_router(), sc_runs=1,
                              external_claim_retriever=retriever,
                              require_citation_in_answer=False)
    out = v.verify(VerifyIn(answer="Alice Smith was born in Paris. [#1]",
                            evidence=_hits(), question=QUESTION, trace_id="t"))
    cc = out.diagnostics["claim_check"]
    assert calls, "external retriever was not invoked"
    assert cc["summary"]["supported"] >= 1
