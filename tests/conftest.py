import os

# Tests must see exactly ONE device (the dry-run sets its own 512-device
# flag in its own process). Also keep XLA from grabbing every core.
os.environ.setdefault("XLA_FLAGS", "")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (skips without them)")
