import os
import sys

# src-layout import path (tests run as PYTHONPATH=src pytest tests/)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke
# tests and benches must see the real single device; multi-device tests
# spawn subprocesses with their own XLA_FLAGS (see test_multidevice.py).


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skipped "
        "on hosts without one")
