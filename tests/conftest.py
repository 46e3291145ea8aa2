"""Test configuration.

FP64 is enabled globally: the paper's outer Krylov layers run in double
precision (convergence criterion 1e-9 needs it). All other tests construct
their dtypes explicitly, so this is safe for the whole suite.

NOTE: XLA_FLAGS --xla_force_host_platform_device_count is deliberately NOT
set here — smoke tests and benchmarks must see 1 device; only
``repro.launch.dryrun`` requests 512 placeholder devices.
"""
import jax

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips with a reason without one")
