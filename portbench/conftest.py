"""The repository's marker for tests that need a card, registered here too
so that ``pytest portbench`` alone knows it."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")
