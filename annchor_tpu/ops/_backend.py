"""Backend helpers shared by the device kernels."""

import jax


def default_platform() -> str:
    """Platform of the device new arrays land on: the configured
    ``jax_default_device`` when set (the test-suite pins a CPU device
    this way), else the default backend."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return getattr(dev, "platform", str(dev))
    return jax.default_backend()


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
