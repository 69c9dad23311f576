"""pytest settings of the benchmark's own tests (no JAX here)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")
