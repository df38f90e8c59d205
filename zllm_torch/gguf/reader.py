"""mmap-backed GGUF v2/v3 reader.

Parses the GGUF container (contract: reference ggml/include/gguf.h — magic,
version, typed KV metadata, tensor-info table, aligned data blob) into numpy
views over a single memory map, so weight bytes are paged in lazily and never
copied on the host until repack/dequant time.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGML_BLOCK_SIZES,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
)

_SCALAR_FMT: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_SCALAR_NP: dict[GGUFValueType, np.dtype] = {
    GGUFValueType.UINT8: np.dtype("<u1"),
    GGUFValueType.INT8: np.dtype("<i1"),
    GGUFValueType.UINT16: np.dtype("<u2"),
    GGUFValueType.INT16: np.dtype("<i2"),
    GGUFValueType.UINT32: np.dtype("<u4"),
    GGUFValueType.INT32: np.dtype("<i4"),
    GGUFValueType.FLOAT32: np.dtype("<f4"),
    GGUFValueType.BOOL: np.dtype("?"),
    GGUFValueType.UINT64: np.dtype("<u8"),
    GGUFValueType.INT64: np.dtype("<i8"),
    GGUFValueType.FLOAT64: np.dtype("<f8"),
}


class _Cursor:
    """Sequential little-endian decoder over a buffer."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def scalar(self, vtype: GGUFValueType):
        fmt = _SCALAR_FMT[vtype]
        size = struct.calcsize(fmt)
        (val,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return val

    def u32(self) -> int:
        return self.scalar(GGUFValueType.UINT32)

    def u64(self) -> int:
        return self.scalar(GGUFValueType.UINT64)

    def string(self) -> str:
        n = self.u64()
        raw = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return raw.decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self.string()
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self.u32())
            count = self.u64()
            if etype == GGUFValueType.STRING:
                return [self.string() for _ in range(count)]
            if etype == GGUFValueType.ARRAY:
                return [self.value(GGUFValueType.ARRAY) for _ in range(count)]
            dt = _SCALAR_NP[etype]
            arr = np.frombuffer(self.buf, dtype=dt, count=count, offset=self.pos)
            self.pos += dt.itemsize * count
            return arr
        return self.scalar(vtype)


@dataclass
class TensorMeta:
    name: str
    shape: tuple[int, ...]  # logical numpy shape: reversed GGUF ne, shape[-1] contiguous
    gtype: GGMLType
    offset: int  # relative to data section start
    nbytes: int

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclass
class GGUFFile:
    path: str
    version: int
    alignment: int
    metadata: dict[str, Any]
    tensors: dict[str, TensorMeta]
    data_offset: int
    _mm: mmap.mmap | None = field(default=None, repr=False)
    _fh: BinaryIO | None = field(default=None, repr=False)

    # -- metadata helpers ---------------------------------------------------
    def kv(self, key: str, default=None, arch: str | None = None):
        if arch is not None:
            key = key.format(arch=arch)
        return self.metadata.get(key, default)

    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "unknown")

    # -- tensor access ------------------------------------------------------
    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw bytes of a tensor as uint8[*outer_shape, row_bytes] (zero-copy)."""
        meta = self.tensors[name]
        view = np.frombuffer(
            self._mm, dtype=np.uint8, count=meta.nbytes, offset=self.data_offset + meta.offset
        )
        blk, bsz = GGML_BLOCK_SIZES[meta.gtype]
        rb = meta.shape[-1] // blk * bsz if meta.shape else meta.nbytes
        return view.reshape(*meta.shape[:-1], rb) if meta.shape else view

    def tensor_f32(self, name: str) -> np.ndarray:
        """Tensor dequantized to float32 (copies)."""
        from ..quant import blocks as qb

        meta = self.tensors[name]
        return qb.dequantize(self.tensor_bytes(name), meta.gtype).reshape(meta.shape)

    def close(self):
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # numpy views still alive; the map is freed when they die
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SplitGGUF:
    """Sharded GGUF set (reference: gguf-split output, loaded via
    llama_get_list_splits, src/llama-model-loader.cpp:71-100): presents
    the union of all shards' tensors behind the GGUFFile interface."""

    def __init__(self, files: list[GGUFFile]):
        self.files = files
        self.path = files[0].path
        self.version = files[0].version
        self.metadata = files[0].metadata
        self.data_offset = files[0].data_offset
        self.tensors: dict[str, TensorMeta] = {}
        self._owner: dict[str, GGUFFile] = {}
        for f in files:
            for name, meta in f.tensors.items():
                self.tensors[name] = meta
                self._owner[name] = f

    def kv(self, key: str, default=None, arch: str | None = None):
        return self.files[0].kv(key, default, arch)

    @property
    def architecture(self) -> str:
        return self.files[0].architecture

    def tensor_bytes(self, name: str):
        return self._owner[name].tensor_bytes(name)

    def tensor_f32(self, name: str):
        return self._owner[name].tensor_f32(name)

    def close(self):
        for f in self.files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


SPLIT_PATTERN = "{prefix}-{no:05d}-of-{count:05d}.gguf"


def read_gguf(path: str | os.PathLike):
    """Open a GGUF; a first shard of a gguf-split set (split.count > 1)
    transparently opens its siblings."""
    f = _read_one(path)
    n_split = int(f.kv("split.count", 0) or 0)
    if n_split > 1:
        import re

        m = re.match(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$", str(path))
        if m and int(m.group(2)) == 1:
            prefix = m.group(1)
            files = [f]
            for no in range(2, n_split + 1):
                files.append(_read_one(SPLIT_PATTERN.format(prefix=prefix, no=no, count=n_split)))
            return SplitGGUF(files)
    return f


def _read_one(path: str | os.PathLike) -> GGUFFile:
    fh = open(path, "rb")
    mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
    cur = _Cursor(mm)

    magic = cur.u32()
    if magic != GGUF_MAGIC:
        raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
    version = cur.u32()
    if version not in (2, 3):
        raise ValueError(f"{path}: unsupported GGUF version {version}")

    n_tensors = cur.u64()
    n_kv = cur.u64()

    metadata: dict[str, Any] = {}
    for _ in range(n_kv):
        key = cur.string()
        vtype = GGUFValueType(cur.u32())
        metadata[key] = cur.value(vtype)

    alignment = int(metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))

    tensors: dict[str, TensorMeta] = {}
    order: list[TensorMeta] = []
    for _ in range(n_tensors):
        name = cur.string()
        n_dims = cur.u32()
        ne = [cur.u64() for _ in range(n_dims)]
        gtype = GGMLType(cur.u32())
        offset = cur.u64()
        shape = tuple(reversed(ne)) if ne else (1,)
        blk, bsz = GGML_BLOCK_SIZES[gtype]
        n_elem = 1
        for d in ne:
            n_elem *= d
        nbytes = n_elem // blk * bsz
        meta = TensorMeta(name=name, shape=shape, gtype=gtype, offset=offset, nbytes=nbytes)
        tensors[name] = meta
        order.append(meta)

    data_offset = (cur.pos + alignment - 1) // alignment * alignment

    return GGUFFile(
        path=str(path),
        version=version,
        alignment=alignment,
        metadata=metadata,
        tensors=tensors,
        data_offset=data_offset,
        _mm=mm,
        _fh=fh,
    )
