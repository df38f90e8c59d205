"""A speculative verify step gives every column a decode step's bits, on
the CPU (`forward(..., verify=True)`).

The serving engine's verify step holds, a row, the decode token in column
0 and the drafts after it at consecutive positions, trash positions in the
columns a row does not use.  Each column runs the T=1 kernel at its own
position, in column order: K2 through llama's `layer_forward` over a
contiguous cache, K8 for OLMo-2, K9 over pages, and over the q8 cache the
rows inserted first, then K7's split form a column.  So column j of a
speculating row attends exactly what the decode step at that position
would, and gets its attention bit for bit; the cache's committed slots
end as the decode steps leave them.  Held here through the plain
versions; `verify_matches_decode` runs on the card too
(tests/test_torch_cuda.py, the kernels themselves).  This file imports no
JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zllm_torch.models import llama
from zllm_torch.ops.layers import RopeParams
from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8
from zllm_torch.runtime.paged import PagedKVCache

B, HQ, HKV, D, T = 3, 8, 2, 64, 5  # G 4; T = 1 + 4 drafts
MAX_LEN, PAGE = 256, 128
TRASH = MAX_LEN
SCALE = D ** -0.5
# row 0 speculates at 100..104, row 1 decodes one token at 60, row 2 idles
POSITIONS = [[100, 101, 102, 103, 104], [60] + [TRASH] * (T - 1), [TRASH] * T]
COMMITTED = {0: range(100, 105), 1: range(60, 61)}  # slots the decode steps write for real
CFG = SimpleNamespace(attn_logit_softcap=0.0, arch="llama", attn_scale=None, head_dim=D,
                      q_dim=HQ * D, kv_dim=HKV * D, rope=RopeParams(dim=D, base=10000.0,
                                                                    style="neox"),
                      norm_eps=1e-5)
OLMO2 = SimpleNamespace(**{**vars(CFG), "arch": "olmo2"})
# (cache, its K/V dtype, the attention path): llama's K2 through layer_forward
CASES = [("contiguous", torch.float32, "llama"), ("contiguous", torch.bfloat16, "llama"),
         ("contiguous", torch.float32, "olmo2"), ("contiguous", torch.bfloat16, "olmo2"),
         ("paged", torch.float32, "llama"), ("paged", torch.bfloat16, "llama"),
         ("q8", None, "llama")]


def _rand(*shape, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _cache(kind: str, dtype, device):
    """One layer of the cache, filled with a random earlier context."""
    if kind == "q8":
        kv = KVCacheQ8.create(1, B, MAX_LEN + T, HKV, D, device=device)
        prefix = torch.arange(MAX_LEN, dtype=torch.int32, device=device)[None].repeat(B, 1)
        kv.update(0, _rand(B, MAX_LEN, HKV, D, seed=1, device=device),
                  _rand(B, MAX_LEN, HKV, D, seed=2, device=device), prefix)
        return kv
    if kind == "paged":
        kv = PagedKVCache.create(1, B, MAX_LEN, HKV, D, dtype=dtype, page_size=PAGE,
                                 device=device)
    else:  # the engine's stripe: max_len + chunk slots a row
        kv = KVCache.create(1, B, MAX_LEN + T, HKV, D, dtype=dtype, device=device)
    kv.k[0].copy_(_rand(*kv.k[0].shape, seed=1, device=device))
    kv.v[0].copy_(_rand(*kv.v[0].shape, seed=2, device=device))
    return kv


def _clone(kv):
    if isinstance(kv, PagedKVCache):
        return PagedKVCache([x.clone() for x in kv.k], [x.clone() for x in kv.v],
                            kv.table.clone(), kv.page_size, kv.horizon)
    if isinstance(kv, KVCache):
        return KVCache([x.clone() for x in kv.k], [x.clone() for x in kv.v])
    return KVCacheQ8([x.clone() for x in kv.k], [x.clone() for x in kv.v],
                     [x.clone() for x in kv.ks], [x.clone() for x in kv.vs])


def _slot_rows(kv, row: int, pos: int) -> list[torch.Tensor]:
    """What the cache holds for (row, pos): K, V (and the q8 scales)."""
    if isinstance(kv, PagedKVCache):
        r = int(kv.table[row, pos // PAGE]) * PAGE + pos % PAGE
        return [kv.k[0][:, r], kv.v[0][:, r]]
    names = ("k", "v", "ks", "vs") if isinstance(kv, KVCacheQ8) else ("k", "v")
    return [getattr(kv, n)[0][row, :, pos] for n in names]


def _attention(arch: str, kind: str, monkeypatch):
    """fn(q, k, v, kv, positions, verify) -> the attention [B, T, Hq, D]:
    llama over a contiguous cache through `layer_forward` (K2 on the raw
    q|k|v rows: the projections return them, wo is the identity and the
    FFN adds zero, so the block's output on x = 0 is its attention), the
    other paths through `_attend`."""
    if arch == "llama" and kind == "contiguous":
        monkeypatch.setattr(llama, "_projections", lambda layer, h: layer["qkv"])
        monkeypatch.setattr(llama, "linear", lambda h, w: h)
        monkeypatch.setattr(llama, "_ffn_core", lambda layer, h, *taps: torch.zeros_like(h))

        def run(q, k, v, kv, positions, verify):
            b, t = q.shape[:2]
            qkv = torch.cat([x.reshape(b, t, -1) for x in (q, k, v)], dim=-1)
            ones = torch.ones(HQ * D, device=q.device)
            layer = {"qkv": qkv, "wo": None, "attn_norm": ones, "ffn_norm": ones}
            x = torch.zeros(b, t, HQ * D, device=q.device, dtype=q.dtype)
            return llama.layer_forward(layer, CFG, x, positions, kv, 0,
                                       verify=verify).reshape(b, t, HQ, D)

        return run
    cfg = OLMO2 if arch == "olmo2" else CFG
    return lambda q, k, v, kv, positions, verify: llama._attend(
        q, k, v, kv, 0, positions, cfg, SCALE, verify=verify)


def verify_matches_decode(kind: str, kv_dtype, arch: str, device, act_dtype, monkeypatch):
    """Run one verify step and, on a copy of the cache, the decode steps of
    its columns one at a time; each column's attention must equal its
    decode step's, and the committed slots the decode steps' contents."""
    attend = _attention(arch, kind, monkeypatch)
    kv = _cache(kind, kv_dtype, device)
    q, k, v = (_rand(B, T, h, D, seed=10 + i, device=device, dtype=act_dtype)
               for i, h in enumerate((HQ, HKV, HKV)))
    pos = torch.tensor(POSITIONS, dtype=torch.int32, device=device)
    kv_v, kv_d = _clone(kv), _clone(kv)
    out_v = attend(q, k, v, kv_v, pos, True)
    assert out_v.shape == (B, T, HQ, D)
    for j in range(T):
        sl = slice(j, j + 1)
        out_d = attend(q[:, sl].contiguous(), k[:, sl].contiguous(), v[:, sl].contiguous(),
                       kv_d, pos[:, sl].contiguous(), False)
        for row, slots in COMMITTED.items():
            if j < len(slots):
                assert torch.equal(out_v[row, j], out_d[row, 0]), (row, j)
    for row, slots in COMMITTED.items():
        for p in slots:
            for a, b in zip(_slot_rows(kv_v, row, p), _slot_rows(kv_d, row, p)):
                assert torch.equal(a, b), (row, p)


@pytest.mark.parametrize("kind,kv_dtype,arch", CASES,
                         ids=[f"{c}_{str(d).split('.')[-1]}_{a}" for c, d, a in CASES])
def test_verify_columns_get_decode_bits(kind, kv_dtype, arch, monkeypatch):
    verify_matches_decode(kind, kv_dtype, arch, torch.device("cpu"), torch.float32, monkeypatch)


# the T=1 kernel each path runs, and the multi-row kernel it does not
T1 = {("contiguous", "llama"): ("attn_decode_qkv", "flash_attention"),
      ("contiguous", "olmo2"): ("attn_decode_update", "flash_attention"),
      ("paged", "llama"): ("paged_attn_decode_update", "paged_attention"),
      ("q8", "llama"): ("flash_attention_blockwise", None)}


@pytest.mark.parametrize("kind,arch", list(T1), ids=lambda x: x)
def test_verify_runs_the_t1_kernel_once_a_column(kind, arch, monkeypatch):
    """A verify step launches the T=1 kernel once a column, each on one
    query column, and no multi-row kernel (on the CPU the plain versions
    of the two agree in these cases, so this routing is what the card's
    bits rest on)."""
    attend = _attention(arch, kind, monkeypatch)
    one, multi = T1[kind, arch]
    cols = []
    real = getattr(llama, one)

    def spy(x, *a, **kw):
        # K2 takes the raw rows [B, Hq + 2 Hkv, D], the others q [B, T, Hq, D]
        cols.append(1 if x.dim() == 3 else x.shape[1])
        return real(x, *a, **kw)

    monkeypatch.setattr(llama, one, spy)
    if multi:
        monkeypatch.setattr(llama, multi, lambda *a, **kw: pytest.fail(f"{multi} ran"))
    q, k, v = (_rand(B, T, h, D, seed=10 + i, device="cpu") for i, h in
               enumerate((HQ, HKV, HKV)))
    attend(q, k, v, _cache(kind, torch.float32, "cpu"),
           torch.tensor(POSITIONS, dtype=torch.int32), True)
    assert cols == [1] * T


def test_verify_and_mask_refusals():
    """verify needs a cache and no mask; kv_positions goes with a mask; a
    mask needs a contiguous cache."""
    params = {"tok_emb": torch.zeros(8, 4)}
    tok = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="verify needs"):
        llama.forward(params, CFG, tok, tok, None, verify=True)
    with pytest.raises(ValueError, match="kv_positions"):
        llama.forward(params, CFG, tok, tok, None, kv_positions=tok)
    q = torch.zeros(1, 2, HQ, D)
    kvp = _cache("paged", torch.float32, "cpu")
    with pytest.raises(ValueError, match="contiguous KVCache"):
        llama._attend(q, q[:, :, :HKV], q[:, :, :HKV], kvp, 0, tok, CFG, SCALE,
                      mask=torch.ones(1, 2, MAX_LEN, dtype=torch.bool))
