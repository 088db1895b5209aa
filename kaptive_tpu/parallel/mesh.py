r"""Device mesh construction helpers.

Builds 1-D or 2-D ``jax.sharding.Mesh`` layouts with a ``data`` axis
(assembly batches) and an optional ``model`` axis (gene-table shards).  In a
multi-process run the caller is expected to have run
``jax.distributed.initialize`` first (see :mod:`kaptive_tpu.parallel.multihost`);
XLA lowers the collectives to NCCL.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    n_devices: int | None = None,
    model_parallel: int = 1,
    devices: list | None = None,
) -> Mesh:
    r"""Create a (data, model) mesh over the available devices.

    Args:
        n_devices: total devices to use (default: all).
        model_parallel: size of the ``model`` axis (gene-table shards);
            must divide ``n_devices``.
        devices: explicit device list (e.g. ``jax.devices("cpu")`` in tests).
    """
    devs = devices if devices is not None else jax.devices()
    n = n_devices or len(devs)
    if n % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} must divide device count {n}")
    grid = np.asarray(devs[:n]).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, axis_names=("data", "model"))
