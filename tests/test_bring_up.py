"""Runtime setup and entry points: compile-cache placement, the settings
loader without PyYAML, the DTOs without pydantic, and chip_smoke.py's
refusal to run without a GPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def fresh_cache_setup(monkeypatch):
    """jax_setup with its once-only latch reset and jax.config.update
    recorded instead of applied (the test process keeps its config)."""
    import jax

    from a_modular_rag_framework_tpu.utils import jax_setup

    updates = {}
    monkeypatch.setattr(jax_setup, "_DONE", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    return jax_setup, updates


def test_cache_env_var_wins(fresh_cache_setup, monkeypatch, tmp_path):
    jax_setup, updates = fresh_cache_setup
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    jax_setup.enable_compilation_cache()
    # JAX reads the variable itself; no other directory is set in code
    assert "jax_compilation_cache_dir" not in updates
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_cache_default_is_fixed_inside_checkout(fresh_cache_setup,
                                                monkeypatch):
    jax_setup, updates = fresh_cache_setup
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax_setup.enable_compilation_cache()
    path = Path(updates["jax_compilation_cache_dir"])
    assert path == jax_setup.default_cache_dir()
    assert path.parent == REPO_ROOT / ".jax_cache"
    assert path.name == jax_setup._host_fingerprint()
    ignored = (REPO_ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_shipped_settings_load_without_yaml(monkeypatch):
    from a_modular_rag_framework_tpu.di.factory import load_settings

    monkeypatch.setitem(sys.modules, "yaml", None)
    s = load_settings(str(REPO_ROOT / "config" / "settings.json"))
    assert s["llm_policy"]["embedding_provider"] == "local_embed"
    assert s["kernels"] == {"query_batch_buckets": [1, 8, 64, 256]}
    assert s["mesh"]["axes"] == {"data": -1}


def test_yaml_settings_need_pyyaml(monkeypatch, tmp_path):
    from a_modular_rag_framework_tpu.di.factory import load_settings

    p = tmp_path / "s.yaml"
    p.write_text(json.dumps({"a": 1}))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_settings(str(p))


def test_answer_question_runs_without_pydantic_or_yaml(tmp_path):
    """A fresh interpreter with both packages blocked runs the full QA
    workflow on the shipped settings."""
    code = (
        "import sys; sys.modules['yaml'] = None; "
        "sys.modules['pydantic'] = None; "
        f"sys.path.insert(0, {str(REPO_ROOT)!r}); "
        "from a_modular_rag_framework_tpu.system import answer_question; "
        "r = answer_question('In which city was the collaborator of Sage "
        "Silverton born?', mode='full', settings_path="
        f"{str(REPO_ROOT / 'config' / 'settings.json')!r}); "
        "print('ANSWER', r['reasoning']['answer'], "
        "r['verification']['verdict'])"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("ANSWER")]
    assert line and "No supporting evidence" not in line[0]


def test_dtos_coerce_nested_dicts_and_dump():
    from a_modular_rag_framework_tpu.core.dto import (
        GraphEdge,
        Hit,
        ReasoningIn,
    )
    from a_modular_rag_framework_tpu.schemas.graph_request_v2 import (
        AssembleGraphRequestV2,
    )

    r = ReasoningIn(question="q", trace_id="t",
                    hits=[{"id": "a", "score": np.float32(0.5)}])
    assert isinstance(r.hits[0], Hit) and type(r.hits[0].score) is float
    assert r.model_dump() == {"question": "q", "graph_id": "", "trace_id": "t",
                              "hits": [{"id": "a", "score": 0.5, "meta": {}}]}
    e = GraphEdge(source="s", target="t", type="x",
                  evidence=[{"channel": "c", "score": 1.0}])
    assert e.evidence[0].channel == "c"
    h = Hit(id="a", score=1.0, meta={"k": [1]})
    deep = h.model_copy(update={"score": 2.0}, deep=True)
    assert deep.score == 2.0 and deep.meta == h.meta and deep.meta is not h.meta
    req = AssembleGraphRequestV2(
        graph_id="g", inputs={"sentences": [{"id": "s0", "text": "x"}]})
    assert req.inputs.sentences[0].text == "x"
    with pytest.raises(TypeError):
        Hit(id="a")  # required field missing


def test_chip_smoke_refuses_cpu_backend():
    """No CPU carry-on: the device phase raises, so main prints no
    result line."""
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke

    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.phase_device(1)


def test_chip_smoke_compare_allows_ties_only():
    sys.path.insert(0, str(REPO_ROOT))
    from chip_smoke import _compare

    a = ([[1, 2, 3]], [[0.9, 0.5, 0.5]])
    assert _compare(a, ([[1, 3, 2]], [[0.9, 0.5, 0.5]]), 1e-5) == 0
    assert _compare(a, ([[2, 1, 3]], [[0.9, 0.5, 0.5]]), 1e-5) == 1
    assert _compare(a, ([[1, 2, 3]], [[0.9, 0.5, 0.49]]), 1e-5) == 1
    assert _compare(a, ([[1, 2]], [[0.9, 0.5]]), 1e-5) == 1
    # a tie group cut by the top-k boundary: the last hit may differ
    c = ([[1, 2, 3]], [[0.9, 0.7, 0.5]])
    assert _compare(c, ([[1, 2, 4]], [[0.9, 0.7, 0.5]]), 1e-5) == 0
    assert _compare(c, ([[1, 4, 3]], [[0.9, 0.7, 0.5]]), 1e-5) == 1
    # given channel norms, two hits the engines cannot tell apart may swap
    # anywhere (a tie at a selection boundary the output scores hide)
    n = [[[0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [0.7, 0.8, 0.9]]]
    assert _compare((*c, n), ([[1, 4, 3]], [[0.9, 0.7, 0.5]], n), 1e-5) == 0
    m = [[[0.1, 0.2, 0.3], [0.4, 0.4, 0.6], [0.7, 0.8, 0.9]]]
    assert _compare((*c, n), ([[1, 4, 3]], [[0.9, 0.7, 0.5]], m), 1e-5) == 1
