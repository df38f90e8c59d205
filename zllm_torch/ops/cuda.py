"""Build and load the port's hand-written CUDA kernels.

Each source under `zllm_torch/csrc/` exports a plain C interface.  It is
compiled with `nvcc` for `sm_90a` into its own shared library, at first use,
into `.cache/zllm_torch_kernels/` at the root of the checkout, under a name
keyed by a hash of the source and the flags.  All sources build in
parallel (one `nvcc` each).  Libraries are loaded with `ctypes`; the
wrappers in `ops/qmatmul.py` and `ops/attention.py` pass device pointers
and the current stream as integers.

Nothing here runs at import, so a CPU-only host can import every module;
`nvcc` runs only when a kernel is first launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
CACHE = Path(__file__).resolve().parents[2] / ".cache" / "zllm_torch_kernels"

# kernel library name -> source file
SOURCES = {
    "q4k_matvec": "q4k_matvec.cu",
    "q4k_gemm": "q4k_gemm.cu",
    "attn_decode": "attn_decode.cu",
    "flash_attn": "flash_attn.cu",
}

# No --use_fast_math: the matvec's int8 codes come from rintf(x / dx) with
# IEEE division, and fast math moves codes at the .5 boundaries.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return CACHE / f"{name}-{key}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernel libraries (all by default) that are not yet
    built, all at once; return {name: ptxas report}.  Raises on any error."""
    names = list(SOURCES) if names is None else list(names)
    CACHE.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argument types set (looked up once)."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    return fn


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require_cuda(*tensors, aligned=()):
    """Every tensor on one CUDA device and contiguous; `aligned` 16-byte
    aligned (vector loads)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError("kernel input is not 16-byte aligned")
