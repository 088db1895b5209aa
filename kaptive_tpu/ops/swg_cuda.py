r"""Banded SWG on NVIDIA Hopper: the CUDA kernel in ``native/banded_swg.cu``.

The kernel fills the band and walks the traceback in one launch, one warp per
pair, with the band in registers and the pair's sequences in shared memory;
its results are bit-identical to :func:`kaptive_tpu.ops.swg.banded_swg_lax`.
It is reached through ``jax.ffi`` on the CUDA platform only and has no
interpret mode: :func:`kaptive_tpu.ops.swg.banded_swg` routes a bucket here on
a GPU when :func:`fits` holds, and to the lax path otherwise.

The shared library is built from the committed source with ``nvcc`` on first
use, into ``build/`` at the repository root, keyed on a hash of the source
and the compile command; ``python -m kaptive_tpu.ops.swg_cuda`` builds it
ahead of time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parents[2]
SRC = REPO / "native" / "banded_swg.cu"
BUILD_DIR = REPO / "build"
TARGET = "kaptive_banded_swg"
MAX_W = 2048  # 64 cells per lane, the widest instantiated band
SMEM_LIMIT = 48 * 1024  # default per-block dynamic shared memory
PAIRS_PER_BLOCK = 2  # kWarps in the kernel
CLASS_STRIDE = 32  # column classes per substitution-table row


def nvcc_command(out: Path) -> list[str]:
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
        "-o", str(out), str(SRC),
    ]


def library_path() -> Path:
    r"""Path of the built library for the current source (built if missing)."""
    key = hashlib.sha256(
        SRC.read_bytes() + " ".join(nvcc_command(Path("x"))[1:-3]).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"banded_swg-{key}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(nvcc_command(tmp), capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed building {SRC.name}:\n{r.stderr[-4000:]}")
    tmp.replace(so)
    return so


@functools.cache
def register() -> Path:
    r"""Build (if needed), load and register the FFI target once per process."""
    so = library_path()
    lib = ctypes.cdll.LoadLibrary(str(so))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.KaptiveBandedSwg), platform="CUDA"
    )
    return so


def smem_bytes(rows_max: int, t_cols: int, n_row: int) -> int:
    def r16(x):
        return -(-x // 16) * 16

    return n_row * CLASS_STRIDE * 4 + 512 + PAIRS_PER_BLOCK * (r16(rows_max) + 2 * r16(t_cols))


def fits(rows_max: int, w_pad: int, t_cols: int, compressed) -> bool:
    r"""True when a bucket and its substitution matrix fit the kernel."""
    if compressed is None:
        return False
    n_row = compressed[2].shape[0]
    return (
        w_pad % 128 == 0
        and 128 <= w_pad <= MAX_W
        and t_cols >= w_pad
        and smem_bytes(rows_max, t_cols, n_row) <= SMEM_LIMIT
    )


@functools.partial(
    jax.jit, static_argnames=("gap_open", "gap_extend", "rows_max", "w_pad", "t_pad")
)
def banded_swg_cuda(
    q_codes, q_lens, t_codes, t_lens, offsets, k_locals, row_lut, col_lut, small,
    *, gap_open: int, gap_extend: int, rows_max: int, w_pad: int, t_pad: int,
):
    r"""Same contract and result as :func:`kaptive_tpu.ops.swg.banded_swg_lax`;
    the matrix arrives factored as ``(row_lut, col_lut, small)``."""
    from kaptive_tpu.ops.swg import SwgResult

    assert t_pad == w_pad + 2, "banded SWG requires t_pad == w_pad + 2"
    assert q_codes.shape[1] >= rows_max, "query matrix narrower than rows_max"
    register()
    b = q_codes.shape[0]
    out_types = [jax.ShapeDtypeStruct((b,), jnp.int32)] * 8 + [
        jax.ShapeDtypeStruct((b, rows_max, w_pad // 2), jnp.uint8)  # traceback scratch
    ]
    outs = jax.ffi.ffi_call(TARGET, out_types)(
        q_codes.astype(jnp.uint8), q_lens.astype(jnp.int32),
        t_codes.astype(jnp.uint8), t_lens.astype(jnp.int32),
        offsets.astype(jnp.int32), k_locals.astype(jnp.int32),
        row_lut.astype(jnp.int32), col_lut.astype(jnp.int32), small.astype(jnp.int32),
        gap_open=np.int32(gap_open), gap_extend=np.int32(gap_extend),
    )
    return SwgResult(*outs[:8])


if __name__ == "__main__":
    print(library_path())
