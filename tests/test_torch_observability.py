"""The port's copy of the black-box contract (the counterpart of
``tests/test_observability.py``'s source scans): the port's routers,
controllers, planes and policies observe the cluster only through
``ClusterView`` — never ``Instance.queue`` / ``Instance.running`` or the
simulator's oracle fields — its simulator talks to one ``ControlPlane``,
and its fairness scheduler reads no oracle tenant state."""
import os
import re

import pytest

_SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")

PROXY_MODULES = ["core/router.py", "core/controller.py",
                 "core/control_plane.py", "core/sharded_plane.py",
                 "core/migration.py", "core/rectify.py", "core/fairness.py",
                 "core/replay.py", "core/learned_router.py"]


def _lines(*path):
    with open(os.path.join(_SRC, *path)) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("module", PROXY_MODULES)
def test_no_instance_internals_in_proxy_code(module):
    for pattern in (r"\.queue\b", r"\.running\b", r"\.session_cache\b",
                    r"\.prefix_cache\b", r"\.eviction_deadline\s*=",
                    r"\._spot_rng\b", r"\.evictions_per_hour\b"):
        hits = [ln for ln in _lines(module) if re.search(pattern, ln)]
        assert not hits, f"{module} touches Instance internals: {hits}"


def test_simulator_is_facade_only():
    for pattern in (r"self\.router\b", r"self\.pool\b",
                    r"self\.admission\b", r"self\.fairness\b",
                    r"from repro_torch\.core\.router",
                    r"from repro_torch\.core\.controller",
                    r"from repro_torch\.core\.fairness",
                    r"\bmake_router\b", r"\bGoodServe",
                    r"\bPoolController\b", r"\bAdmissionController\b",
                    r"\bReactivePool", r"\bForecastPool",
                    r"\bFairnessPolicy\b"):
        hits = [ln for ln in _lines("cluster", "simulator.py")
                if re.search(pattern, ln)]
        assert not hits, \
            f"simulator.py bypasses the ControlPlane facade: {hits}"


def test_fairness_module_reads_no_oracle_tenant_fields():
    for pattern in (r"\.output_len\b", r"\babuser\b", r"\bTenantSpec\b",
                    r"zipf", r"repro_torch\.cluster\.workload"):
        hits = [ln for ln in _lines("core", "fairness.py")
                if re.search(pattern, ln, re.IGNORECASE)]
        assert not hits, f"fairness.py peeks at oracle state: {hits}"


@pytest.mark.parametrize("module", PROXY_MODULES)
def test_scan_reads_the_ports_own_copy(module):
    """The scans above read the port's files, each a copy that names
    ``repro_torch`` and imports nothing of the reference."""
    src = "\n".join(_lines(module))
    assert "Copy of ``repro/" in src
    assert not re.search(r"^\s*(from|import)\s+repro(\.|\s|$)", src, re.M)
