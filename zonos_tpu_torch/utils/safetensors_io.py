"""Read and write the safetensors format without the ``safetensors`` package.

A file is an 8-byte little-endian header length, a JSON header that maps each
tensor's name to its dtype, shape and ``[begin, end)`` byte offsets into the
data buffer that follows (plus an optional ``__metadata__`` of strings), then
the raw little-endian data. ``load_file`` maps the file and views each tensor
in place with ``torch.frombuffer`` (no copy per tensor); ``save_file`` writes
each tensor's bytes straight from its storage.
"""

from __future__ import annotations

import json
import mmap
import struct

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
}
NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20


def _header(buf, size: int) -> tuple[dict, int]:
    if size < 8:
        raise ValueError(f"safetensors: {size} bytes is too short for a header")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > _MAX_HEADER or 8 + n > size:
        raise ValueError(f"safetensors: header length {n} does not fit a {size}-byte file")
    header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    header.pop("__metadata__", None)
    return header, 8 + n


def _check_layout(header: dict, data_len: int) -> None:
    """Every entry's bytes must match its dtype and shape, and the entries,
    sorted by offset, must tile the data buffer with no gap and no overlap."""
    spans = []
    for name, e in header.items():
        if e["dtype"] not in DTYPES:
            raise ValueError(f"safetensors: {name} has dtype {e['dtype']}, not one of {sorted(DTYPES)}")
        begin, end = e["data_offsets"]
        numel = 1
        for d in e["shape"]:
            numel *= d
        if end - begin != numel * DTYPES[e["dtype"]].itemsize:
            raise ValueError(f"safetensors: {name} spans {end - begin} bytes for shape {e['shape']} {e['dtype']}")
        spans.append((begin, end, name))
    pos = 0
    for begin, end, name in sorted(spans):
        if begin != pos:
            raise ValueError(f"safetensors: {name} starts at byte {begin}, not at {pos}: offsets do not tile the data")
        pos = end
    if pos != data_len:
        raise ValueError(f"safetensors: the tensors end at byte {pos} of a {data_len}-byte data buffer")


def load_file(path: str) -> dict[str, torch.Tensor]:
    """name → CPU tensor. The tensors share memory with a private (copy on
    write) map of the file, which lives as long as they do."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size == 0:
            raise ValueError(f"safetensors: {path} is empty")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, start = _header(buf, size)
    _check_layout(header, size - start)
    out = {}
    for name, e in header.items():
        dtype, shape = DTYPES[e["dtype"]], e["shape"]
        begin, end = e["data_offsets"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                         offset=start + begin).reshape(shape)
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write CPU or device tensors (copied to the host one at a time), in name order."""
    items = []
    header: dict = {}
    pos = 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"safetensors: {name} has dtype {t.dtype}, not one of {sorted(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [pos, pos + nbytes]}
        items.append(t)
        pos += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in items:
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
