"""The repo's ``slow`` marks, in one table.

The tier-1 run selects ``-m 'not slow'``, so a test in ``SLOW`` leaves every
routine run; ``python -m pytest tests/ -m slow`` runs the listed tests. A
test is marked here, by its node id, and never in its own file: the table
is the one place that says which tests are slow and why. An entry needs a
timing of over 300 s on one worker of the tier-1 command.
"""

import pytest

SLOW = {
    "tests/test_frame.py::test_sharded_matches_single_chip":
        "8-device sharded JAX reference frame: 8-10 min alone on one core, "
        "1,036 s on one loaded worker; a known reference failure",
    "tests/test_frame.py::test_sharded_full_features_matches_single_chip":
        "8-device sharded JAX reference frame with meshlets and 68 lights: "
        "over 5 min alone on one core, 862 s on one loaded worker",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: over 300 s on one worker; the tests in SLOW of the "
        "root conftest.py, deselected by the tier-1 run's -m 'not slow'")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    """Mark the tests of ``SLOW`` before ``-m`` selects (tryfirst)."""
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
