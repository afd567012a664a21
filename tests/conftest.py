"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding/collective code paths compile and execute against 8 host devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8), per SURVEY.md §4.
Must run before jax is imported anywhere.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import pytest  # noqa: E402


@pytest.fixture()
def rng():
    import numpy as np

    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def settings():
    from a_modular_rag_framework_tpu.di.factory import load_settings

    return load_settings(str(REPO_ROOT / "config" / "settings.json"))
