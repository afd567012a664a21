"""The driver records only the last ~2000 chars of bench stdout; rounds 3
and 4 both shipped final lines that outgrew the window and were recorded as
``parsed: null``. These tests pin the worst case: a fully-populated extras
dict (every scale row, rerank, dense, natural e2e, serving, splade, plus
error strings at maximum length) must condense to a line under
bench.COMPACT_BUDGET, and the budget-fitter must never drop the headline
fields."""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import COMPACT_BUDGET, _condense_extras, _fit_budget  # noqa: E402

LONG_ERR = "x" * 500


def worst_case_extras() -> dict:
    scale = {
        "corpus_passages": 5_171_354,
        "pipelined_qps": 14_612.3,
        "sequential_qps": 9_881.4,
        "recall_at_10": 0.9961,
        "mrr": 0.3751,
        "recall_at_10_iterative_2hop": 0.9961,
        "iterative_2hop_qps": 12_861.7,
        "index_build_sec": 612.4,
        "index_device_bytes": 1_398_101_333,
        "dense_encoder": "subword_collide_d64",
        "dense_only": {"qps": 21_412.9, "recall_at_10": 0.5081,
                       "hop1_recall": 0.9141, "two_hop_recall_at_10": 0.9414,
                       "two_hop_mrr": 0.4812, "error": LONG_ERR},
        "rerank": {"recall_at_10": 0.9961, "recall_before": 0.9961,
                   "mrr": 0.5812, "mrr_before": 0.3751,
                   "checkpoint": "cross_encoder_collide.npz",
                   "error": LONG_ERR},
        "error": LONG_ERR,
    }
    return {
        "recall_at_10": 0.9961, "mrr": 0.3594,
        "recall_at_10_iterative_2hop": 1.0, "mrr_iterative_2hop": 0.3421,
        "iterative_2hop_qps": 12_861.7, "sequential_qps": 9_881.4,
        "device_program_qps": 30_112.9, "corpus_passages": 13_243,
        "compile_sec": 41.2,
        "mfu_train_pct": 17.512, "mfu_dense_steady_pct": 41.2,
        "scale_100k": dict(scale), "scale_1m": dict(scale),
        "scale_5m": dict(scale),
        "natural": {
            "samples": 1043, "passages": 20_031, "index_titles": True,
            "tuned": {"recall_at_10": 0.8012, "mrr": 0.4311,
                      "recall_at_10_iterative_2hop": 0.8471},
            "parity": {"recall_at_10": 0.6231, "mrr": 0.3911,
                       "recall_at_10_iterative_2hop": 0.7012},
            "no_titles": {"recall_at_10": 0.5811, "mrr": 0.3011,
                          "recall_at_10_iterative_2hop": 0.6412},
            "e2e_em": 0.6411, "e2e_f1": 0.7123, "e2e_n": 209,
            "e2e": {"error": LONG_ERR},
            "error": LONG_ERR,
        },
        "serving": {"serving": {
            "single": {"clients": 64, "qps": 1021.4, "p50_ms": 61.2,
                       "p99_ms": 102.4, "completed": 4096},
            "single_512": {"clients": 512, "qps": 10_412.9, "p50_ms": 41.2,
                           "p99_ms": 141.4, "completed": 40_961},
            "iterative": {"clients": 32, "qps": 2412.9, "p50_ms": 13.2,
                          "p99_ms": 41.4, "completed": 14_412},
            "batched_16x128": {"clients": 16, "qps": 11_689.4,
                               "p50_ms": 175.2, "p99_ms": 312.4},
            "scale_1m": {"batched_16x256": {"qps": 9196.1}},
            "error": LONG_ERR,
        }},
        "splade": {
            "sparse_recall_at_10": 0.4141, "sparse_mrr": 0.2812,
            "hybrid_recall_at_10": 0.4921, "hybrid_mrr": 0.8151,
            "bm25_baseline_recall_at_10": 0.5081, "bm25_baseline_mrr": 0.3594,
            "variety_in_domain": {"splade_recall_at_10": 0.4871,
                                  "splade_mrr": 0.9061,
                                  "bm25_recall_at_10": 0.2471,
                                  "bm25_mrr": 0.6221},
            "error": LONG_ERR,
        },
        "channels": {"plain": {"bm25": {"recall_at_10": 0.5, "mrr": 0.3}},
                     "variety": {"error": LONG_ERR}},
        "train_sweep": {"b256_f32attn": {"mfu_train_pct": 12.4},
                        "b1024_bf16attn": {"error": LONG_ERR}},
    }


def make_compact(extras: dict) -> dict:
    return {
        "metric": "2hop_hybrid_queries_per_sec",
        "value": 14_612.3,
        "unit": "q/s/chip",
        "vs_baseline": 1.4612,
        "extras": _condense_extras(extras),
        "full_extras": "data/bench_full_latest.json",
    }


def test_worst_case_under_budget():
    payload = _fit_budget(make_compact(worst_case_extras()))
    assert len(payload) < 1800, len(payload)
    parsed = json.loads(payload)
    assert parsed["value"] == 14_612.3
    assert parsed["vs_baseline"] == 1.4612


def test_condensed_keeps_required_scale_fields():
    extras = _condense_extras(worst_case_extras())
    for label in ("scale_100k", "scale_1m", "scale_5m"):
        row = extras[label]
        assert row["recall"] == 0.9961
        assert row["mrr"] == 0.3751
        assert row["it_qps"] == 12_861.7
        assert row["dense_recall"] == 0.9414
        assert row["rerank_mrr"] == 0.5812
        assert row["enc"] == "subword_collide_d64"
    assert extras["natural"]["e2e_em"] == 0.6411
    # errors are truncated, never dropped silently
    assert extras["scale_1m"]["error"] == "x" * 60


def test_fit_budget_never_drops_headline():
    compact = make_compact(worst_case_extras())
    payload = _fit_budget(compact, budget=10)  # impossible budget
    parsed = json.loads(payload)
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in parsed


def test_empty_extras_ok():
    assert _condense_extras({}) == {}
    payload = _fit_budget(make_compact({}))
    assert len(payload) < COMPACT_BUDGET
