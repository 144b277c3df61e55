"""A safetensors reader and writer with no dependency beyond numpy and torch.

The format: an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}}`, plus an
optional `__metadata__` map of strings, which the reader skips), then
the raw little-endian tensor bytes, offsets counted from the end of the
header.

`SafetensorsDir` reads one file or several (HF's
`model-0000k-of-0000n.safetensors`) as a read-only mapping from names to
CPU tensors. Each lookup maps only that tensor's bytes from the file
(`numpy.memmap`, copy-on-write), so a loader that copies each tensor to
its device and drops it holds one tensor's pages at a time, never the
whole file. BF16 is read as int16 and viewed as torch.bfloat16, since
numpy has no bfloat16.

`save_file` writes such a file one tensor at a time: the header comes
from shapes and dtypes alone, and each tensor is fetched to the host
only when its bytes are written.
"""
from __future__ import annotations

import json
import struct
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, Sequence

import numpy as np
import torch

#: safetensors dtype -> (numpy storage dtype, torch dtype)
_DTYPES = {"F32": (np.float32, torch.float32),
           "F16": (np.float16, torch.float16),
           "BF16": (np.int16, torch.bfloat16),
           "I8": (np.int8, torch.int8),
           "U8": (np.uint8, torch.uint8)}
_CODES = {t: code for code, (_, t) in _DTYPES.items()}


def read_header(path) -> tuple:
    """(header without `__metadata__`, byte offset of the data) of one
    safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}; this reader takes "
                             f"{sorted(_DTYPES)}")
    return header, 8 + n


class SafetensorsDir(Mapping):
    """The tensors of several safetensors files (read in the given order;
    a later file's name wins, as a dict update would) as a mapping from
    name to a CPU tensor backed by a map of the file."""

    def __init__(self, files: Sequence):
        self._where: Dict[str, tuple] = {}
        for f in files:
            header, start = read_header(f)
            for name, info in header.items():
                self._where[name] = (str(f), start, info)

    def __getitem__(self, name: str) -> torch.Tensor:
        path, start, info = self._where[name]
        np_dt, t_dt = _DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        lo, hi = info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if hi - lo != count * np.dtype(np_dt).itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {hi - lo} "
                             f"bytes, not {shape} x {info['dtype']}")
        if count == 0:
            return torch.empty(shape, dtype=t_dt)
        arr = np.memmap(path, dtype=np_dt, mode="c", offset=start + lo,
                        shape=shape)
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, name) -> bool:
        return name in self._where


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def save_file(tensors: Mapping, path,
              to_host: Callable[[Any], torch.Tensor] = lambda t: t) -> None:
    """Write `tensors` (name -> anything with `.shape` and `.dtype` that
    `to_host` turns into a torch tensor) as one safetensors file, in the
    mapping's order. Only one tensor's host copy exists at a time."""
    header: Dict[str, Any] = {}
    off = 0
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors code here ({sorted(_DTYPES)})")
        n = int(np.prod(tuple(t.shape), dtype=np.int64)) \
            * torch.empty((), dtype=t.dtype).element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, t in tensors.items():
            arr = _host_array(to_host(t))
            if arr.nbytes != header[name]["data_offsets"][1] \
                    - header[name]["data_offsets"][0]:
                raise ValueError(f"tensor {name!r}: its host copy has "
                                 f"{arr.nbytes} bytes, not its header's")
            f.write(arr.reshape(-1).view(np.uint8))
