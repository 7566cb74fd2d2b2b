# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see the real (single) device; only launch/dryrun.py sets
# the 512-device placeholder flag, before any jax import.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and the CUDA toolkit (nvcc);"
        " skips elsewhere — python -m pytest -m cuda tests/test_torch_cuda.py")
