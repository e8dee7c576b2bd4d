"""Weight shards without the ``safetensors`` package: a reader for
``.safetensors`` and ``.bin`` shards and a ``.safetensors`` writer.

The safetensors format is an 8-byte little-endian header length, a JSON
header {name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__"}, then the raw little-endian bytes, offsets counted from
the end of the header. A tensor is read through a ``numpy.memmap`` of its
own bytes (bf16 as int16, viewed as bfloat16), so only the tensor being
read is mapped; ``.bin`` shards go through ``torch.load(weights_only=True,
mmap=True)``. ``ShardIndex`` is a checkpoint folder as one mapping from
key to tensor, read at access, that records which keys were read, the
converters' guard against a layout they do not understand (the
reference's ``_TrackedStateDict``, ``models/convert.py:139-165``).
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(the tensor entries of a .safetensors file, the byte offset where
    its data begins)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_tensor(path: str, entry: dict, data_start: int) -> torch.Tensor:
    """One tensor of a .safetensors file (``entry`` from ``read_header``)
    as a CPU tensor over a copy-on-write memmap of its bytes."""
    if entry["dtype"] not in _DTYPES:
        raise TypeError(f"{path}: dtype {entry['dtype']} is not supported")
    np_dtype, torch_dtype = _DTYPES[entry["dtype"]]
    begin, end = entry["data_offsets"]
    shape = tuple(entry["shape"])
    count = int(np.prod(shape, dtype=np.int64))
    if end - begin != count * np.dtype(np_dtype).itemsize:
        raise ValueError(f"{path}: {shape} {entry['dtype']} does not fill "
                         f"[{begin}, {end})")
    if count == 0:
        return torch.empty(shape, dtype=torch_dtype)
    a = np.memmap(path, dtype=np_dtype, mode="c", offset=data_start + begin,
                  shape=shape)
    t = torch.from_numpy(a)
    return t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file."""
    header, start = read_header(path)
    return {k: read_tensor(path, e, start) for k, e in header.items()}


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) as
    a .safetensors file, in the order given."""
    header, offset = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            t = t.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            if t.numel():
                f.write(t.numpy().data)  # the array's own buffer, no copy
    os.replace(tmp, path)


class ShardIndex:
    """The weight shards of one model folder (``*.safetensors``, else
    ``*.bin``) as a mapping key -> CPU tensor, read at access. Records
    every key read; ``assert_fully_consumed`` raises on any key never
    read, so a converter never loads part of a layout it does not know."""

    def __init__(self, folder: str):
        self.folder = folder
        self._where: Dict[str, tuple] = {}
        files = sorted(glob.glob(os.path.join(folder, "*.safetensors")))
        if files:
            for path in files:
                header, start = read_header(path)
                for k, e in header.items():
                    self._add(k, ("st", path, e, start))
        else:
            files = sorted(glob.glob(os.path.join(folder, "*.bin")))
            for path in files:
                for k in torch.load(path, map_location="cpu", weights_only=True,
                                    mmap=True):
                    self._add(k, ("bin", path))
        if not self._where:
            raise FileNotFoundError(f"no .safetensors or .bin weight shards under {folder}")
        self.accessed: set = set()
        self._open_bin: Tuple[Optional[str], Optional[dict]] = (None, None)

    def _add(self, key: str, where: tuple) -> None:
        if key in self._where:
            raise ValueError(f"{self.folder}: key {key!r} appears in two shards")
        self._where[key] = where

    def __contains__(self, key: str) -> bool:
        return key in self._where

    def keys(self):
        return list(self._where)

    def _bin_shard(self, path: str) -> dict:
        if self._open_bin[0] != path:  # one .bin shard mapped at a time
            self._open_bin = (path, torch.load(path, map_location="cpu",
                                               weights_only=True, mmap=True))
        return self._open_bin[1]

    def __getitem__(self, key: str) -> torch.Tensor:
        where = self._where[key]
        self.accessed.add(key)
        if where[0] == "st":
            return read_tensor(where[1], where[2], where[3])
        return self._bin_shard(where[1])[key]

    def assert_fully_consumed(self, what: str) -> None:
        leftover = sorted(set(self._where) - self.accessed)
        if leftover:
            shown = ", ".join(leftover[:8])
            more = f" (+{len(leftover) - 8} more)" if len(leftover) > 8 else ""
            raise ValueError(
                f"{what} conversion left {len(leftover)} state-dict key(s) "
                f"unconsumed: {shown}{more}; the converter does not understand "
                "this checkpoint layout and refuses a partial conversion")
