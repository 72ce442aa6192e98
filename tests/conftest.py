"""Test config: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerator hardware, mirroring
the reference's rank-count-independent chunk tests (SURVEY.md section 4:
num_chunks > 1 in serial exercises the full connection path).

Tests marked `gpu` need an NVIDIA card.  They run only when MNT_TEST_GPU=1
leaves JAX free to pick the GPU backend:

    MNT_TEST_GPU=1 python -m pytest tests/ -m gpu

and otherwise skip from the `gpu_device` fixture (never at import time, so
every pytest-xdist worker collects the same tests).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
_ON_GPU = os.environ.get("MNT_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    if not _ON_GPU:
        pytest.skip("needs an NVIDIA GPU (run with MNT_TEST_GPU=1 on one)")
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("JAX found no GPU device")
    return gpus[0]


def pytest_collection_modifyitems(config, items):
    """Tier the suite: tests/medium_tests.txt lists tests (file.py or
    file.py::test_name entries) that get the `medium` marker — the
    long-running exactness sweeps.  The core tier
    (`pytest -m "not slow and not medium"`) covers every subsystem in
    under ~15 minutes on one CPU; `-m "not slow"` adds the medium
    sweeps; the full run includes the `slow` physics gates."""
    import pathlib
    import pytest as _pytest
    spec_file = pathlib.Path(__file__).parent / "medium_tests.txt"
    if not spec_file.exists():
        return
    entries = set(spec_file.read_text().split())
    files = {e for e in entries if e.endswith(".py")}
    for it in items:
        nid = it.nodeid.replace("tests/", "", 1)
        fname = nid.split("::")[0]
        base = nid.split("[")[0]
        if fname in files or nid in entries or base in entries:
            it.add_marker(_pytest.mark.medium)
