# Tests run on the default single CPU device. Do NOT set
# xla_force_host_platform_device_count here — only launch/dryrun.py (and the
# dist subprocess tests) use the 512-device placeholder mesh.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run them "
        "on the card with `python -m pytest -m card <file>`, per file: "
        "the files with such tests import no JAX)")
