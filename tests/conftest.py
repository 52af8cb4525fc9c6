"""Test configuration: JAX on a virtual 8-device CPU mesh, so sharding
paths are exercised without a card (SURVEY.md §4).

JAX_PLATFORMS, where set, is honoured (the tier-1 command sets cpu);
unset, the tests take the CPU.  Kernels run through the Pallas
interpreter by the explicit interpret=True argument.  Tests marked `gpu`
need a card: the `_card` fixture skips them elsewhere, and chip_smoke.py
runs them on the card, in its own process.  On the CPU the persistent
compile cache stays off.
"""

import os

_CPU = os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if _CPU and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if _CPU:
    jax.config.update("jax_enable_compilation_cache", False)

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE = pathlib.Path("/root/reference")

# Slow tier (VERDICT r4 weak #8): the handful of multi-minute
# interpret-mode engine-vs-oracle sweeps run only under TH_RUN_SLOW=1
# (CI's full job and the per-round judging pass set it); the default
# `pytest tests/` stays fast while test_fuzz / test_offload /
# test_e2e_golden keep engine-oracle and golden coverage in-tier.
_SLOW_NODES = {
    "tests/test_engine.py::test_engine_matches_oracle_1000x10",
    "tests/test_engine.py::test_engine_matches_oracle_full_length",
    "tests/test_chaining_jax.py::test_engine_device_chain_matches_oracle",
    "tests/test_msa_banded_interpret.py::test_banded_msa_interpret_parity",
}


def pytest_collection_modifyitems(config, items):
    if os.environ.get("TH_RUN_SLOW"):
        return
    skip = pytest.mark.skip(
        reason="slow tier: set TH_RUN_SLOW=1 (run before every round end)")
    for item in items:
        nid = item.nodeid.replace("\\", "/")
        if not nid.startswith("tests/"):
            idx = nid.find("tests/")
            nid = nid[idx:] if idx >= 0 else "tests/" + nid
        if nid in _SLOW_NODES:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def test_data():
    path = REFERENCE / "test_data"
    if not path.is_dir():
        pytest.skip(f"reference test data not present at {path}")
    return path


@pytest.fixture(autouse=True)
def _card(request):
    """`gpu`-marked tests run only where JAX's backend is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
