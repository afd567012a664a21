"""Natural-discourse retrieval: title-augmented indexing + title anchoring.

Real documents drop their subject after the first sentence ("He was born
in Cincinnati ..."), which breaks token-level retrieval and bridge
anchoring that the synthetic corpora (subject named in every sentence)
never exercise. Two mechanisms close that gap:

- ``build_packed_index(index_titles=True)`` prepends each sentence's doc
  TITLE to the text every channel indexes (BM25 postings, embeddings,
  entity graph) while leaving hit ids/display text untouched — the
  standard HotpotQA indexing practice (reference indexes bare text,
  text_index.py:40-50, so the flag defaults off for parity).
- ``bridge_entities(..., hit_titles=...)`` anchors a hop-1 sentence to a
  question entity via its own document title when the text itself never
  names the entity; the native C++ stage mirrors the same clause
  (native/text_native.cpp BridgeDoc.title).
"""
import numpy as np
import pytest

from a_modular_rag_framework_tpu.index.builder import (
    build_packed_index,
    build_sentence_graph,
)
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

SAMPLES = [
    {
        "_id": "nat1",
        "question": "In which city was the director of the film Sharktooth born?",
        "answer": "Cincinnati",
        "type": "bridge",
        "supporting_facts": [["Sharktooth (film)", 0], ["Steven Spielmann", 1]],
        "context": [
            ["Sharktooth (film)", [
                "Sharktooth is a 1975 thriller directed by Steven Spielmann.",
                "The production famously ran over budget on Martha's Vineyard.",
            ]],
            ["Steven Spielmann", [
                "Steven Spielmann is an American filmmaker.",
                "He was born in Cincinnati and raised in Phoenix.",
                "His early festival shorts won several regional awards.",
            ]],
            ["Tetrix", [
                "Tetrix asks players to pack falling pieces into lines.",
                "Alexei Pajitov programmed the first version in 1984.",
            ]],
        ],
    },
]


@pytest.fixture(scope="module")
def corpus():
    return SentenceCorpus.from_hotpotqa(SAMPLES)


def _row(corpus, title, sid):
    return corpus.row_by_title_sid()[(title, sid)]


def test_index_titles_reaches_pronoun_sentence(corpus):
    """With index_titles=True the pronoun sentence ("He was born in
    Cincinnati...") carries its doc-title tokens in BM25/dense/graph;
    the displayed hit text stays the original sentence."""
    from a_modular_rag_framework_tpu.engine.query_engine import (
        EngineConfig,
        QueryEngine,
    )

    born = _row(corpus, "Steven Spielmann", 1)
    q = "Where was Steven Spielmann born?"
    cfg = EngineConfig(top_k=4, pool_k=8, batch_buckets=(4,))

    idx_t = build_packed_index(corpus, embed_dim=32, index_titles=True)
    assert idx_t.manifest["build_stats"]["index_titles"] is True
    eng_t = QueryEngine(idx_t, config=cfg)
    res = eng_t.query_batch([q])
    got = [int(i) for i in np.asarray(res.hits.ids)[0] if i >= 0]
    assert born in got, got
    # the stored corpus text is untouched — hydration shows the bare
    # sentence, no title prefix leaks into display
    assert idx_t.corpus.docs[born]["text"] == \
        "He was born in Cincinnati and raised in Phoenix."

    # default build (parity with the reference): the pronoun sentence has
    # no token overlap with the query — the named sid-0 sentence outranks
    idx_p = build_packed_index(corpus, embed_dim=32)
    assert not idx_p.manifest["build_stats"]["index_titles"]
    eng_p = QueryEngine(idx_p, config=cfg)
    res_p = eng_p.query_batch([q])
    got_p = [int(i) for i in np.asarray(res_p.hits.ids)[0] if i >= 0]
    assert got_p[0] == _row(corpus, "Steven Spielmann", 0)


def test_index_titles_joins_entity_graph(corpus):
    """Title-augmented entity extraction links the pronoun sentence into
    its own document's entity chain (the bridge a 2-hop hop needs)."""
    texts = corpus.texts()
    aug = [f"{d.get('title')} . {t}" for d, t in zip(corpus.docs, texts)]
    plain = build_sentence_graph(corpus, max_degree=8)["entity"]
    titled = build_sentence_graph(corpus, max_degree=8, texts=aug)["entity"]

    born = _row(corpus, "Steven Spielmann", 1)
    film = _row(corpus, "Sharktooth (film)", 0)
    # plain: "He was born in Cincinnati and raised in Phoenix." names no
    # corpus entity chain shared with the film sentence
    assert film not in plain[born].tolist()
    # titled: both rows mention "Steven Spielmann" -> chained
    assert film in titled[born].tolist()


def test_bridge_entities_title_anchor():
    """A hop-1 sentence that never names the question entity anchors via
    its own doc title; without hit_titles it is (correctly) skipped."""
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        bridge_entities,
    )

    q = "Who directed the film Sharktooth?"
    texts = [
        # hop-1 evidence inside doc "Sharktooth (film)" that drops the
        # subject: names the bridge entity only
        "The black-and-white thriller was directed by Steven Spielmann.",
        "Tetrix asks players to pack falling pieces into lines.",
    ]
    titles = ["Sharktooth (film)", "Tetrix"]
    known = {"Sharktooth (film)", "Steven Spielmann", "Tetrix"}

    got_plain = bridge_entities(q, texts, known_titles=known)
    assert "Steven Spielmann" not in got_plain
    got_titled = bridge_entities(q, texts, known_titles=known,
                                 hit_titles=titles)
    assert "Steven Spielmann" in got_titled


def test_native_bridge_title_anchor_parity():
    """The C++ stage applies the same title-anchor clause: its hop-2
    output on subject-dropping sentences matches the Python path called
    WITH hit_titles."""
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        _QUESTION_WORDS,
        bridge_entities,
        doc_bridge_runs,
        hop2_queries_for,
    )
    from a_modular_rag_framework_tpu.native.binding import NativeBridge

    docs = [
        {"title": "Sharktooth", "text": "The thriller was directed by Steven Spielmann."},
        {"title": "Steven Spielmann", "text": "He was born in Cincinnati."},
        {"title": "Tetrix", "text": "Alexei Pajitov programmed the first version."},
    ]
    nb = NativeBridge(docs, _QUESTION_WORDS)
    if not nb.available:
        pytest.skip("native lib unavailable")

    titles = {d["title"] for d in docs}
    queries = ["Who directed the film Sharktooth?"]
    ids = np.array([[0, 1, 2, -1, -1]], dtype=np.int32)
    got = nb.hop2_batch(queries, ids)
    assert got is not None
    for b, q in enumerate(queries):
        rows = [i for i in ids[b] if i >= 0]
        texts = [docs[i]["text"] for i in rows]
        hit_titles = [docs[i]["title"] for i in rows]
        runs = [doc_bridge_runs(t, titles) for t in texts]
        bridges = bridge_entities(q, texts, max_entities=4,
                                  known_titles=titles, text_runs=runs,
                                  hit_titles=hit_titles)
        want = hop2_queries_for(q, bridges) if bridges else []
        assert got[b] == want, (q, got[b], want)
        # and the anchor actually fired: the subject-dropping hop-1 row
        # produced the bridge
        assert any("Steven Spielmann" in w for w in want)
