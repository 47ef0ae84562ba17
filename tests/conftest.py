import os

import pytest

# Tests must see exactly ONE device (the dry-run sets 512 in its own
# subprocess); fail fast if something leaked the flag into the test env.
assert "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""), \
    "tests must not inherit the dry-run's 512-device XLA_FLAGS"


@pytest.fixture(autouse=True)
def _reset_telemetry():
    """Every test starts from zeroed UNION/CACHE/DISPATCH/PLAN counters so
    stats assertions never depend on collection order."""
    from repro import core
    core.reset_all_stats()
    yield

# hypothesis is optional: when missing, property tests skip (see
# tests/_hypothesis_compat.py) and the rest of the suite runs normally.
try:
    from hypothesis import HealthCheck, settings
except ImportError:
    pass
else:
    settings.register_profile(
        "ci", deadline=None, max_examples=25,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card of compute capability 9.0 "
        "(H100); skips where there is none")
