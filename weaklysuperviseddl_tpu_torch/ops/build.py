"""Builds the port's CUDA sources into shared libraries with ``nvcc``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first use
into ``build/`` (listed in ``.gitignore``), named by a hash of its source and
of the shared headers ``csrc/*.cuh``, so a changed source never loads a stale
library. The libraries are loaded with
``ctypes`` by the module that wraps each kernel; ``launch_device`` is the
device context such a launch runs in, ``stream_handle`` the stream it is
queued on.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _library_path(source: str) -> Path:
    """The shared library that ``csrc/<source>`` builds into."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; returns the path.
    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside the library as ``.log``."""
    out = _library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name per process and thread, then an atomic rename:
    # concurrent builds never load or overwrite half a file
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def launch_device(device):
    """The context a ctypes launch onto a tensor's CUDA ``device`` runs in:
    nothing to enter when it is the current device already (entering
    ``torch.cuda.device`` costs host time on every call), else
    ``torch.cuda.device(device)``."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device) -> int:
    """The ``cudaStream_t`` of the current stream on CUDA ``device``, as the
    int a ctypes launch takes, from torch's raw accessor (the one Triton's
    launchers use): it builds no ``torch.cuda.Stream`` object, which
    ``torch.cuda.current_stream(device).cuda_stream`` does at a cost of
    several microseconds of host time a call."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)
