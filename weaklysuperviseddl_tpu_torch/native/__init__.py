"""ctypes bindings of the port's two host libraries, each a copy of the JAX
package's source of the same name:

- ``wsdl_io.cpp``, the asynchronous PNG writer. ``png_write_async`` queues a
  write on the writer's threads and returns; ``io_flush`` is the durability
  barrier, raising ``OSError`` with the paths that failed;
  ``io_flush_report`` returns them instead; ``png_write`` writes on the
  calling thread.
- ``wsdl_native.cpp``, the host goldens that the tests and ``chip_smoke.py``
  hold the port's CRF and connected-component kernels against: ``densecrf``
  (the mean-field CRF, exact O(N²) or through the permutohedral lattice),
  ``permutohedral_filter``, ``label_components`` (8-connected union-find)
  and ``keep_largest``. They take numpy, return numpy and run on the host,
  with the JAX package's names, signatures and return conventions.

Each library is compiled with ``g++`` on first use into the package's
``build/`` directory (listed in ``.gitignore``), named by a hash of the
source and the flags as ``ops/build.py`` names the CUDA libraries, so a
checkout carries no binary and a changed source never loads a stale one.
The flags leave out ``-march=native``, which the JAX package's build uses,
so the goldens' float results may differ from its library's in the last
bits. A failed build raises ``RuntimeError`` with the compiler's output, and
the failure is kept: a later call raises it again without compiling again.
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

CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_FLUSH_DETAIL_BYTES = 4096

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_ubyte)
_i32p = ctypes.POINTER(ctypes.c_int32)


class _Library:
    """One C++ source built into ``BUILD_DIR`` and loaded once a process;
    ``signatures`` maps each exported function to (argtypes, restype)."""

    def __init__(self, source: str, libs: tuple[str, ...], signatures: dict):
        self.source = Path(__file__).resolve().with_name(source)
        self.libs = libs
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib = None
        self._error: RuntimeError | None = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(CXX_FLAGS + self.libs).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def _build(self) -> Path:
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a private temporary name, then an atomic rename: processes building
        # at once never load or overwrite half a file
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(self.source), *self.libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"cannot run g++ to build {self.source.name}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {self.source.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def load(self):
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._error is not None:
                raise self._error
            try:
                lib = ctypes.CDLL(str(self._build()))
            except RuntimeError as exc:
                self._error = exc
                raise
            except OSError as exc:
                self._error = RuntimeError(f"cannot load the library of {self.source.name}: {exc}")
                raise self._error from exc
            for name, (argtypes, restype) in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            self._lib = lib
            return lib


_IO = _Library("wsdl_io.cpp", ("-lz", "-lpthread"), {
    "wsdl_io_submit": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p],
                       ctypes.c_int),
    "wsdl_io_flush_errors": ([ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "wsdl_png_write": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p],
                       ctypes.c_int),
})
_GOLDENS = _Library("wsdl_native.cpp", (), {
    "wsdl_densecrf": ([ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, _u8p,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int, _f32p], None),
    "wsdl_permutohedral_filter": ([ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, _f32p,
                                   _f32p], None),
    "wsdl_label_components": ([ctypes.c_int, ctypes.c_int, _u8p, _i32p], ctypes.c_int),
    "wsdl_keep_largest": ([ctypes.c_int, ctypes.c_int, _u8p, _u8p], None),
})


def library_path() -> Path:
    """The shared library ``wsdl_io.cpp`` builds into."""
    return _IO.path()


def load():
    """The PNG writer's library, built on first use; raises ``RuntimeError``
    (the same one on every later call) if it cannot be built or loaded."""
    return _IO.load()


def goldens_library_path() -> Path:
    """The shared library ``wsdl_native.cpp`` builds into."""
    return _GOLDENS.path()


def load_goldens():
    """The goldens' library, built on first use; raises as ``load`` does."""
    return _GOLDENS.load()


# ---- the PNG writer ---------------------------------------------------------------------


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
    if lib.wsdl_io_submit(os.fsencode(path), H, W, C, a.ctypes.data_as(_u8p)) != 0:
        raise OSError(f"wsdl_io_submit failed for {path}")


def png_write(path: str, arr: np.ndarray) -> None:
    """Encode and write one PNG on the calling thread."""
    lib = load()
    a, H, W, C = _png_args(arr)
    if lib.wsdl_png_write(os.fsencode(path), H, W, C, a.ctypes.data_as(_u8p)) != 0:
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


# ---- the goldens ------------------------------------------------------------------------


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def densecrf(unary: np.ndarray, rgb: np.ndarray, gauss_sxy: float = 1.0,
             gauss_compat: float = 2.0, bilat_sxy: float = 50.0, bilat_srgb: float = 5.0,
             bilat_compat: float = 10.0, n_iters: int = 5, exact: bool = False) -> np.ndarray:
    """Mean-field dense-CRF marginals [H,W,L] from negative log-probabilities
    ``unary`` [H,W,L] and ``rgb`` [H,W,3] uint8. ``exact=True`` runs the
    O(N²) brute force (test scale only), else the permutohedral lattice."""
    lib = load_goldens()
    H, W, L = unary.shape
    u = _f32(unary.reshape(H * W, L))
    img = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty((H * W, L), np.float32)
    lib.wsdl_densecrf(H, W, L, u.ctypes.data_as(_f32p), img.ctypes.data_as(_u8p),
                      gauss_sxy, gauss_compat, bilat_sxy, bilat_srgb, bilat_compat,
                      n_iters, 1 if exact else 0, out.ctypes.data_as(_f32p))
    return out.reshape(H, W, L)


def permutohedral_filter(positions: np.ndarray, values: np.ndarray) -> np.ndarray:
    """The raw lattice Gaussian filter: positions [N,d], values [N,C] → [N,C]."""
    lib = load_goldens()
    N, d = positions.shape
    C = values.shape[1]
    pos, val = _f32(positions), _f32(values)
    out = np.empty((N, C), np.float32)
    lib.wsdl_permutohedral_filter(N, d, C, pos.ctypes.data_as(_f32p), val.ctypes.data_as(_f32p),
                                  out.ctypes.data_as(_f32p))
    return out


def label_components(mask: np.ndarray) -> np.ndarray:
    """8-connected labels [H,W] int32: -1 background, else the linear index
    of the component's smallest pixel."""
    lib = load_goldens()
    H, W = mask.shape
    m = np.ascontiguousarray(mask != 0, np.uint8)
    out = np.empty((H, W), np.int32)
    lib.wsdl_label_components(H, W, m.ctypes.data_as(_u8p), out.ctypes.data_as(_i32p))
    return out


def keep_largest(mask: np.ndarray) -> np.ndarray:
    """The largest 8-connected component as a {0,1} uint8 mask (the smallest
    label on a tie); an empty mask passes through unchanged."""
    lib = load_goldens()
    H, W = mask.shape
    m = np.ascontiguousarray(mask != 0, np.uint8)
    out = np.empty((H, W), np.uint8)
    lib.wsdl_keep_largest(H, W, m.ctypes.data_as(_u8p), out.ctypes.data_as(_u8p))
    return out
