r"""The one place that asks which kind of device jitted code runs on.

kaptive-tpu runs on the CPU (tests, laptops) or on an NVIDIA GPU; policies
that differ between the two (seeding mode, DP batch size, the SWG kernel)
read :func:`on_gpu`.  Any other platform is refused rather than guessed at.
"""

from __future__ import annotations

import jax

PLATFORMS = ("cpu", "gpu")


def platform_of(device) -> str:
    r"""Platform name of a device (or of a platform string), checked."""
    name = device if isinstance(device, str) else device.platform
    if name not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: kaptive-tpu runs on 'cpu' or 'gpu'"
        )
    return name


def default_platform() -> str:
    r"""Platform of the default device, honouring a pinned ``jax_default_device``."""
    dev = jax.config.jax_default_device
    return platform_of(dev if dev is not None else jax.devices()[0])


def on_gpu() -> bool:
    return default_platform() == "gpu"
