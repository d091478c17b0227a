import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests must see 1 CPU device.
# Multi-device / x64 tests spawn subprocesses whose environment comes from
# jax_subprocess_env below, the one place that composes jax env policy.

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def jax_subprocess_env(devices=None, x64=False):
    """Environment for a jax subprocess: the XLA host-device count and the
    x64 policy, set before the child imports jax (both are read at import).
    Replaces per-test ``os.environ`` twiddling inside ``python -c`` bodies;
    the parent pytest process keeps its own single-device, x32 default."""
    env = dict(os.environ)
    if devices is not None:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            f" --xla_force_host_platform_device_count={devices}"
                            ).strip()
    if x64:
        env["JAX_ENABLE_X64"] = "1"
    return env


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (the port's kernels run only "
        "there); such a test skips itself elsewhere")
