"""GGUF v3 writer.

Emits files readable by both this engine and the reference (contract:
ggml/include/gguf.h; reference writer: ggml/src/gguf.cpp gguf_write_to_file).
Used by the quantize tool, the HF converter, and the test-model factory.
"""

from __future__ import annotations

import struct
from typing import Any, Sequence

import numpy as np

from .constants import (
    GGML_BLOCK_SIZES,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
)

_NP_TO_VT = {
    np.dtype("uint8"): GGUFValueType.UINT8,
    np.dtype("int8"): GGUFValueType.INT8,
    np.dtype("uint16"): GGUFValueType.UINT16,
    np.dtype("int16"): GGUFValueType.INT16,
    np.dtype("uint32"): GGUFValueType.UINT32,
    np.dtype("int32"): GGUFValueType.INT32,
    np.dtype("float32"): GGUFValueType.FLOAT32,
    np.dtype("uint64"): GGUFValueType.UINT64,
    np.dtype("int64"): GGUFValueType.INT64,
    np.dtype("float64"): GGUFValueType.FLOAT64,
    np.dtype("bool"): GGUFValueType.BOOL,
}

_VT_FMT = {
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


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        return GGUFValueType.UINT32 if 0 <= value < 2**32 else GGUFValueType.INT64
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type for {type(value)}")


class GGUFWriter:
    def __init__(self, path: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []

    # -- metadata -----------------------------------------------------------
    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        if vtype is None:
            vtype = _infer_vtype(value)
        self._kv.append((key, vtype, value))

    # -- tensors ------------------------------------------------------------
    def add_tensor(
        self,
        name: str,
        data: np.ndarray | bytes,
        logical_shape: Sequence[int] | None = None,
        gtype: GGMLType | None = None,
    ):
        """Add a tensor.

        `data` may be a float/int numpy array (gtype inferred, or quantize
        first via zllm.quant) or raw block bytes with an explicit gtype and
        logical_shape (numpy convention: shape[-1] is the contiguous axis).
        """
        if isinstance(data, np.ndarray) and gtype is None:
            if data.dtype == np.float32:
                gtype = GGMLType.F32
            elif data.dtype == np.float16:
                gtype = GGMLType.F16
            elif data.dtype == np.int32:
                gtype = GGMLType.I32
            else:
                raise TypeError(f"cannot infer GGML type for dtype {data.dtype}")
            logical_shape = data.shape
            raw = np.ascontiguousarray(data).tobytes()
        else:
            assert gtype is not None and logical_shape is not None
            raw = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
        blk, bsz = GGML_BLOCK_SIZES[gtype]
        n_elem = int(np.prod(logical_shape))
        if n_elem // blk * bsz != len(raw):
            raise ValueError(
                f"{name}: {len(raw)} bytes inconsistent with shape {tuple(logical_shape)} of {gtype.name}"
            )
        self._tensors.append((name, tuple(int(d) for d in logical_shape), gtype, raw))

    # -- serialization ------------------------------------------------------
    def _emit_str(self, out: list[bytes], s: str):
        b = s.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)

    def _emit_value(self, out: list[bytes], vtype: GGUFValueType, value: Any):
        if vtype == GGUFValueType.STRING:
            self._emit_str(out, value)
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(value, np.ndarray):
                etype = _NP_TO_VT[value.dtype]
                out.append(struct.pack("<IQ", int(etype), value.size))
                out.append(value.astype(value.dtype.newbyteorder("<")).tobytes())
            else:
                value = list(value)
                etype = _infer_vtype(value[0]) if value else GGUFValueType.UINT32
                # promote mixed int arrays conservatively
                if etype != GGUFValueType.STRING and any(isinstance(v, float) for v in value):
                    etype = GGUFValueType.FLOAT32
                out.append(struct.pack("<IQ", int(etype), len(value)))
                for v in value:
                    self._emit_value(out, etype, v)
        else:
            out.append(struct.pack(_VT_FMT[vtype], value))

    def write(self):
        out: list[bytes] = []
        out.append(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._kv)))
        for key, vtype, value in self._kv:
            self._emit_str(out, key)
            out.append(struct.pack("<I", int(vtype)))
            self._emit_value(out, vtype, value)

        offset = 0
        infos: list[bytes] = []
        for name, shape, gtype, raw in self._tensors:
            info: list[bytes] = []
            self._emit_str(info, name)
            ne = tuple(reversed(shape))  # GGUF stores innermost-first
            info.append(struct.pack("<I", len(ne)))
            for d in ne:
                info.append(struct.pack("<Q", d))
            info.append(struct.pack("<IQ", int(gtype), offset))
            infos.append(b"".join(info))
            offset += (len(raw) + self.alignment - 1) // self.alignment * self.alignment
        out.extend(infos)

        header = b"".join(out)
        pad_to = (len(header) + self.alignment - 1) // self.alignment * self.alignment

        with open(self.path, "wb") as fh:
            fh.write(header)
            fh.write(b"\x00" * (pad_to - len(header)))
            for _, _, _, raw in self._tensors:
                fh.write(raw)
                rem = (-len(raw)) % self.alignment
                if rem:
                    fh.write(b"\x00" * rem)
