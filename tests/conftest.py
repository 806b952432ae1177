"""Suite-wide pytest config.

1. Offline property-testing fallback: the CI container has no `hypothesis`
   (and no network to install it). When the real package is missing, a
   deterministic shim (`tests/_propcheck.py`) is registered under
   ``sys.modules["hypothesis"]`` *before* test modules import, so
   ``from hypothesis import given, settings, strategies as st`` keeps
   working with fixed, seeded example sets. A real hypothesis install is
   always preferred.

2. `slow` marker for the >10s model/train tests; `scripts/run_tests.sh`
   deselects them by default (run with ``-m ""`` or ``--all`` for the full
   suite).
"""
import sys
import types


def _install_propcheck_shim():
    try:
        import hypothesis  # noqa: F401  (real package available)
        return
    except ImportError:
        pass
    import _propcheck

    strategies = types.ModuleType("hypothesis.strategies")
    for name in ("integers", "floats", "sampled_from", "booleans"):
        setattr(strategies, name, getattr(_propcheck, name))

    hyp = types.ModuleType("hypothesis")
    hyp.given = _propcheck.given
    hyp.settings = _propcheck.settings
    hyp.strategies = strategies
    hyp.__propcheck_shim__ = True
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = strategies


_install_propcheck_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: tests taking >10s (model-family train loops); "
        "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels have "
        "no CPU mode); skips elsewhere")
