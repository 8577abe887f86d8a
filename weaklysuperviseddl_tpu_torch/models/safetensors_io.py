"""The ``.safetensors`` format with numpy and ``json`` only.

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (byte range
after the header), an optional ``__metadata__`` entry, then the raw
little-endian buffers. The reader takes F32, F16, BF16 (read through a
``uint16`` view, returned as torch bfloat16) and I64 and refuses anything
else; the writer takes the same types.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

_NUMPY = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2"),
          "I64": np.dtype("<i8")}
_CODES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
          torch.int64: "I64"}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the file, as CPU tensors (bfloat16 stays bfloat16)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        code = info["dtype"]
        if code not in _NUMPY:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code}; the reader takes "
                             f"{sorted(_NUMPY)}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        dt = _NUMPY[code]
        if end - start != int(np.prod(shape, dtype=np.int64)) * dt.itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r}'s byte range {start}-{end} does not "
                             f"hold {shape} of {code}")
        arr = np.frombuffer(data[start:end], dtype=dt).reshape(shape).copy()
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if code == "BF16" else t
    return out


def write_safetensors(path: str, tensors: dict[str, torch.Tensor],
                      metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (contiguous copies, in key order) to ``path``."""
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        if t.dtype not in _CODES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; the writer takes "
                             f"{sorted(_CODES.values())}")
        b = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(b)]}
        chunks.append(b)
        offset += len(b)
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for b in chunks:
            f.write(b)
