"""The benchmark's tests. Tests that need the card carry the `card`
marker and skip inside the test where torch.cuda finds none; run them on
the card with `python3 -m pytest portbench/tests -q -m card`."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips inside the test without one)")
