"""16-device dryrun (data=8 x model=2): the BASELINE config-5 shape.

Runs ``__graft_entry__.dryrun_multichip(16)`` in a subprocess with a 16-device
virtual CPU mesh — the conftest's in-process mesh is 8 devices, and the XLA
device count is fixed at process start.  The dryrun itself asserts byte-equal
KaptiveRow TSV between the sharded and single-device pipelines.
"""

import os
import subprocess
import sys
from pathlib import Path


def test_dryrun_multichip_16_devices():
    repo_root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=16",
        PYTHONPATH=str(repo_root),
    )
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, __graft_entry__ as g; g.dryrun_multichip(16, jax.devices('cpu'))"],
        cwd=repo_root, env=env, capture_output=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert b"dryrun_multichip OK" in r.stdout
    assert b"'data': 8" in r.stdout and b"'model': 2" in r.stdout
