"""Session and sequence state files (counterpart of `zllm/runtime/state.py`).

A state file is a compressed `.npz` with a JSON `meta` (magic, version,
the model's arch / n_layers / n_kv_heads / head_dim, `n_past` and
`kv_dtype` under numpy's name) and the K/V arrays trimmed to `n_past`:

  * a session (`save_session` / `load_session`, the CLI's --prompt-cache):
    the whole cache, [n_layers, B, Hkv, n_past, D], plus the token history;
  * a sequence (`seq_get` / `seq_set`, `seq_save_file` / `seq_load_file`,
    the server's /slots save and restore): one slot, [n_layers, Hkv,
    n_past, D], from any of the port's caches (`KVCache` in bf16, f16 or
    f32, `KVCacheQ8`, `PagedKVCache`) into any of them.

bf16 arrays are stored as their uint16 bits, as zllm stores them, so a
file written by either package loads in the other.  The ring cache of a
sliding-window model (`KVCacheSWA`) has no state file: its windowed layers
hold the last ring of positions, not [:n_past], and zllm's functions fail
on it (a ragged stack, or a constructor the ring's fields do not fit), so
these raise ValueError for it.  A q8 slot is saved
dequantized, as the bf16 product codes * scales, and requantized on
restore (`KVCacheQ8._quant`), as zllm does.  Restores write in place.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .kvcache import KVCache, KVCacheQ8, KVCacheSWA
from .paged import PagedKVCache

MAGIC = "ZLLMSESS"
VERSION = 1

_NP_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32"}


def _to_np(x: torch.Tensor) -> np.ndarray:
    """A tensor as npz-storable numpy: bf16 as its uint16 bits."""
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_np(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """The inverse of _to_np, on `device` (bf16 read back from its bits)."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def _meta(model, extra: dict) -> dict:
    cfg = model.cfg
    return {"magic": MAGIC, "version": VERSION, "arch": cfg.arch, "n_layers": cfg.n_layers,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, **extra}


def _capacity(kv) -> int:
    """Positions a slot of `kv` holds (a paged cache: its horizon)."""
    return kv.horizon if isinstance(kv, PagedKVCache) else kv.max_len


def _check(path: str, meta: dict, model, kv, what: str) -> int:
    """Refuse a file of another format, a newer version, another model's
    geometry or more positions than the cache holds; returns n_past."""
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a zllm {what} file")
    if meta["version"] > VERSION:
        raise ValueError(f"{path}: session version {meta['version']} > supported {VERSION}")
    for key in ("arch", "n_layers", "n_kv_heads", "head_dim"):
        want = getattr(model.cfg, key)
        if meta[key] != want:
            raise ValueError(f"{path}: session {key}={meta[key]} does not match model {want}")
    n_past = int(meta["n_past"])
    if n_past > _capacity(kv):
        raise ValueError(f"session length {n_past} exceeds cache {_capacity(kv)}")
    return n_past


def _device(kv) -> torch.device:
    return kv.k[0].device


def _no_ring(kv):
    if isinstance(kv, KVCacheSWA):
        raise ValueError("the sliding-window ring cache has no state file (its windowed layers "
                         "hold a ring of positions, not a prefix)")


def save_session(path: str, model, kv: KVCache, tokens: list[int], n_past: int):
    """Whole-context session: the contiguous cache trimmed to n_past, and
    the token history.  Written to `path` exactly (no suffix added)."""
    _no_ring(kv)
    k = np.stack([_to_np(x[:, :, :n_past]) for x in kv.k])
    v = np.stack([_to_np(x[:, :, :n_past]) for x in kv.v])
    meta = _meta(model, {"n_past": n_past, "kv_dtype": _NP_NAMES[kv.dtype]})
    with open(path, "wb") as fh:
        np.savez_compressed(fh, meta=json.dumps(meta), tokens=np.asarray(tokens, np.int32),
                            k=k, v=v)


def load_session(path: str, model, kv: KVCache):
    """Restore a session into `kv` (its rows [:n_past], in place).
    Returns (kv, tokens, n_past)."""
    _no_ring(kv)
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    n_past = _check(path, meta, model, kv, "session")
    dt = meta.get("kv_dtype", "")
    k = _from_np(data["k"], dt, _device(kv))
    v = _from_np(data["v"], dt, _device(kv))
    for il in range(kv.n_layers):
        kv.k[il][:, :, :n_past] = k[il].to(kv.dtype)
        kv.v[il][:, :, :n_past] = v[il].to(kv.dtype)
    return kv, data["tokens"].tolist(), n_past


def seq_get(model, kv, seq: int, n_past: int) -> dict:
    """One slot's state: meta and K/V [n_layers, Hkv, n_past, D] (numpy)."""
    _no_ring(kv)
    if isinstance(kv, PagedKVCache):
        rows = [kv.gather_row(il, seq, n_past) for il in range(kv.n_layers)]
        k, v = [r[0] for r in rows], [r[1] for r in rows]
        kv_dtype = _NP_NAMES[kv.k[0].dtype]
    elif isinstance(kv, KVCacheQ8):
        # stored dequantized as zllm's bf16 product, so the slot restores
        # into any cache type; seq_set requantizes it on the way back
        def deq(codes, scales):
            return (codes[seq, :, :n_past].to(torch.bfloat16)
                    * scales[seq, :, :n_past].to(torch.bfloat16))

        k = [deq(kv.k[il], kv.ks[il]) for il in range(kv.n_layers)]
        v = [deq(kv.v[il], kv.vs[il]) for il in range(kv.n_layers)]
        kv_dtype = "bfloat16"
    else:
        k = [x[seq, :, :n_past] for x in kv.k]
        v = [x[seq, :, :n_past] for x in kv.v]
        kv_dtype = _NP_NAMES[kv.dtype]
    return {"meta": _meta(model, {"n_past": n_past, "kv_dtype": kv_dtype}),
            "k": np.stack([_to_np(x) for x in k]), "v": np.stack([_to_np(x) for x in v])}


def seq_set(model, kv, seq: int, state: dict):
    """Install a slot state into slot `seq` of `kv`, in place: its
    positions [:n_past] (a paged slot through its page table as it
    stands).  Returns (kv, n_past)."""
    _no_ring(kv)
    meta = state["meta"]
    n_past = _check("state", meta, model, kv, "state")
    dt = meta.get("kv_dtype", "")
    sk = _from_np(state["k"], dt, _device(kv))
    sv = _from_np(state["v"], dt, _device(kv))
    for il in range(kv.n_layers):
        if isinstance(kv, PagedKVCache):
            kv.scatter_row(il, seq, sk[il], sv[il])
        elif isinstance(kv, KVCacheQ8):
            for codes, scales, x in ((kv.k, kv.ks, sk[il]), (kv.v, kv.vs, sv[il])):
                q, s = KVCacheQ8._quant(x)
                codes[il][seq, :, :n_past] = q
                scales[il][seq, :, :n_past] = s
        else:
            kv.k[il][seq, :, :n_past] = sk[il].to(kv.dtype)
            kv.v[il][seq, :, :n_past] = sv[il].to(kv.dtype)
    return kv, n_past


def seq_save_file(path: str, model, kv, seq: int, n_past: int):
    st = seq_get(model, kv, seq, n_past)
    with open(path, "wb") as fh:  # a file object: savez must not append .npz
        np.savez_compressed(fh, meta=json.dumps(st["meta"]), k=st["k"], v=st["v"])


def seq_load_file(path: str, model, kv, seq: int):
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a zllm state file")
    return seq_set(model, kv, seq, {"meta": meta, "k": data["k"], "v": data["v"]})
