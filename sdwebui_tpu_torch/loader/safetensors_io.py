"""safetensors reader and writer on torch, without the ``safetensors`` package.

Port of ``sdwebui_tpu/loader/safetensors_io.py:42-142``.  The format: an
8-byte little-endian header length, a JSON header ``{name: {dtype, shape,
data_offsets}}`` (plus ``__metadata__``), then the raw little-endian data.
The reader maps the file once (copy-on-write, so the pages stay shared
with the page cache) and each tensor is a ``torch.frombuffer`` view into
it: the file is never copied into host RAM as a whole, and a tensor's
bytes move only when it is copied to the device.  F8_E4M3 and F8_E5M2
tensors (the published SD3 bundles store T5-XXL so) read as
``torch.float8_e4m3fn`` / ``float8_e5m2``; the loader casts them to the
module's dtype on the device, as JAX casts the T5 tree to param_dtype
(``load.py:244-245``).  fp8 *storage* of a UNet (opts.fp8_storage) is
another matter and stays unported.
"""

from __future__ import annotations

import json
import math
import mmap
import struct

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    """The tensors of one file as views into its map (do not write them)."""

    def __init__(self, path: str):
        from sdwebui_tpu_torch.utils.options import opts

        self.path = path
        with open(path, "rb") as f:
            if opts.get("disable_mmap_load_safetensors", False):
                # the option reads the file eagerly (network filesystems)
                self._buf = bytearray(f.read())
            else:
                self._buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        (header_len,) = struct.unpack("<Q", self._buf[:8])
        if header_len > len(self._buf) - 8:
            raise ValueError(f"corrupt safetensors header in {path}")
        header = json.loads(bytes(self._buf[8: 8 + header_len]).decode("utf-8"))
        self.metadata = header.pop("__metadata__", None) or {}
        self._entries = header
        self._data_start = 8 + header_len

    def keys(self):
        return self._entries.keys()

    def tensor(self, name) -> torch.Tensor:
        e = self._entries[name]
        dtype = _DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"unsupported dtype {e['dtype']} for {name}")
        shape = tuple(e["shape"])
        count = math.prod(shape)
        b0, b1 = e["data_offsets"]
        if b1 - b0 != count * dtype.itemsize:
            raise ValueError(f"{self.path}: {name} spans {b1 - b0} bytes for {shape} {dtype}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._buf, dtype=dtype, count=count,
                                offset=self._data_start + b0).reshape(shape)

    def load_all(self) -> dict:
        return {k: self.tensor(k) for k in self.keys()}


def read_metadata(path: str) -> dict:
    """Just the ``__metadata__`` header, as strings."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len).decode("utf-8"))
    return {str(k): str(v) for k, v in (header.get("__metadata__") or {}).items()}


def read_state_dict(path: str) -> dict:
    """path → {key: tensor view}; the map lives as long as its tensors."""
    return SafetensorsFile(path).load_all()


def write_safetensors(path: str, tensors: dict, metadata: dict | None = None):
    """Write `tensors` (torch tensors, on any device) in insertion order,
    one tensor at a time through host memory."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        n = t.numel() * t.dtype.itemsize
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in tensors.values():
            f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())
