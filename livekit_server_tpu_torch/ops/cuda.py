"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one `.cu` file under `livekit_server_tpu_torch/csrc/` with
a plain C entry point; sources may include the shared `csrc/*.cuh`
headers. It is compiled with `nvcc` for `sm_90a` into its own shared
library under `livekit_server_tpu_torch/_build/` at first use (the file
name carries a digest of the source, every header and the flags, so an
edited source or header rebuilds) and loaded with `ctypes`. Nothing here runs at import:
the CPU tests import every module on a machine without `nvcc`.

Each C entry point enqueues its kernel on the stream it is given and
returns `cudaGetLastError()`; `check` turns a non-zero code into an
exception. `launches` counts the launches of each kernel; only the
wrappers in ops/selector.py, ops/allocation.py and ops/paged_kernel.py
add to it, through `count_launch`, at the point where they launch.
Every `nvcc` build and every first launch at a new launch shape is also
an entry of the build ledger (runtime/compile_ledger.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"

# Kernel name → CUDA source (csrc/<source>.cu).
SOURCES = {
    "decide_rooms": "decide_rooms",
    "allocate_budget_rooms": "budget_rooms",
    "paged_kernel": "paged_kernel",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = dict.fromkeys(SOURCES, 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(name: str, shape: tuple) -> None:
    """Count one launch of kernel `name` (called by its wrapper right after
    the launch) and note its launch shape in the build ledger, where the
    first launch at a shape this process has not seen is an entry."""
    launches[name] += 1
    _ledger().record_launch(name, shape)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or `nvcc` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(source: str, csrc: Path | None = None) -> Path:
    """The built library of csrc/<source>.cu (`csrc` defaults to CSRC)."""
    csrc = CSRC if csrc is None else csrc
    h = hashlib.sha256((csrc / f"{source}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{source}-{h.hexdigest()[:12]}.so"


def build(names=tuple(SOURCES), csrc: Path | None = None) -> dict[str, str]:
    """Compile the named kernels that are not built yet, one `nvcc` per
    source, all started together; `csrc` (default CSRC) holds the sources.
    Returns the compiler's output per kernel (ptxas register/shared-memory
    report); raises on a failed build with that output."""
    csrc = CSRC if csrc is None else csrc
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        source = SOURCES[name]
        out = library_path(source, csrc)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
        else:
            os.replace(tmp, out)
            # builds run side by side: each entry carries the wall time
            # from the common start to its end
            _ledger().record("nvcc", out.name, (time.perf_counter() - t0) * 1e3)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def _ledger():
    from livekit_server_tpu_torch.runtime.compile_ledger import LEDGER

    return LEDGER


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel's shared library."""
    build((name,))
    return ctypes.CDLL(str(library_path(SOURCES[name])))


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the integer the C entry
    points take."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Validate one kernel operand before its pointer crosses to C."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
