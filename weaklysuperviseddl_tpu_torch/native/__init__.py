"""ctypes bindings of the port's asynchronous PNG writer (``wsdl_io.cpp``, a
copy of the JAX package's ``native/wsdl_io.cpp``).

``load`` compiles the source with ``g++`` on first use into the package's
``build/`` directory (listed in ``.gitignore``), named by a hash of the
source and the flags as ``ops/build.py`` names the CUDA libraries, so a
checkout carries no binary and a changed source never loads a stale one.
A failed build raises ``RuntimeError`` with the compiler's output, and the
failure is kept: ``load`` raises it again without compiling again.

``png_write_async`` queues a write on the writer's threads and returns;
``io_flush`` is the durability barrier, raising ``OSError`` with the paths
that failed; ``io_flush_report`` returns them instead; ``png_write`` writes
on the calling thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from weaklysuperviseddl_tpu_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().with_name("wsdl_io.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")
_FLUSH_DETAIL_BYTES = 4096

_lock = threading.Lock()
_lib = None
_error: RuntimeError | None = None


def library_path() -> Path:
    """The shared library ``wsdl_io.cpp`` builds into."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwsdl_io-{digest}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name, then an atomic rename: processes building at
    # once never load or overwrite half a file
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"cannot run g++ to build {SOURCE.name}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded library, built on first use; raises ``RuntimeError`` (the
    same one on every later call) if it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            lib = ctypes.CDLL(str(_build()))
        except RuntimeError as exc:
            _error = exc
            raise
        except OSError as exc:
            _error = RuntimeError(f"cannot load the library of {SOURCE.name}: {exc}")
            raise _error from exc
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        lib.wsdl_io_submit.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, u8p]
        lib.wsdl_io_submit.restype = ctypes.c_int
        lib.wsdl_io_flush_errors.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.wsdl_io_flush_errors.restype = ctypes.c_int
        lib.wsdl_png_write.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, u8p]
        lib.wsdl_png_write.restype = ctypes.c_int
        _lib = lib
        return lib


def _png_args(arr: np.ndarray):
    a = np.ascontiguousarray(arr, np.uint8)
    if a.ndim == 2:
        H, W, C = a.shape[0], a.shape[1], 1
    elif a.ndim == 3 and a.shape[2] in (1, 3):
        H, W, C = a.shape
    else:
        raise ValueError(f"expected [H,W], [H,W,1] or [H,W,3] uint8, got {arr.shape}")
    return a, H, W, C


def png_write_async(path: str, arr: np.ndarray) -> None:
    """Queue a PNG write on the writer's threads and return. The pixels are
    copied before this returns, so the caller may reuse ``arr``; ``io_flush``
    waits for the file."""
    lib = load()
    a, H, W, C = _png_args(arr)
    if lib.wsdl_io_submit(os.fsencode(path), H, W, C,
                          a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))) != 0:
        raise OSError(f"wsdl_io_submit failed for {path}")


def png_write(path: str, arr: np.ndarray) -> None:
    """Encode and write one PNG on the calling thread."""
    lib = load()
    a, H, W, C = _png_args(arr)
    if lib.wsdl_png_write(os.fsencode(path), H, W, C,
                          a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))) != 0:
        raise OSError(f"wsdl_png_write failed for {path}")


def io_flush_report() -> tuple[int, list[str]]:
    """Wait until every queued write has finished; return (the number that
    failed since the last flush, "<path>: <reason>" for the first few)."""
    lib = load()
    buf = ctypes.create_string_buffer(_FLUSH_DETAIL_BYTES)
    failures = lib.wsdl_io_flush_errors(buf, len(buf))
    detail = buf.value.decode(errors="replace")
    return failures, [line for line in detail.splitlines() if line]


def io_flush() -> None:
    """The durability barrier: wait until every queued write has finished,
    and raise ``OSError`` naming the paths and reasons if any failed."""
    failures, lines = io_flush_report()
    if failures:
        detail = "\n".join(lines) or "(no detail)"
        raise OSError(f"{failures} asynchronous PNG writes failed:\n{detail}")
