"""Llama, Qwen2, Qwen3, OLMo-2 and Gemma forward pass (plain PyTorch
around the port's kernels).

The counterpart of `zllm/models/llama.py::forward` / `layer_forward` for
the plain llama block: RMS norm -> fused wqkv (or wq, wk, wv apart when
their formats differ, as in Q4_K_M files) -> rope -> GQA attention with
KV-cache insert -> wo -> RMS norm -> fused gate|up -> SwiGLU -> down, both
residual; final norm and output head.  Llama, Llama-3, Qwen2 and Qwen3
files run this block (`layer_forward`); Qwen2 adds its q/k/v biases to
the projection rows (`_projections`, and after the fused norm->wqkv
matvec) before anything reads them; Qwen3 gives q and k a per-head RMS
norm over head_dim before rope: inside K2 (its `qw`/`kw`) where K2 takes
the step, as an `rms_norm` on every other path.  The decode fast paths sit
where `zllm` has them:

  * T=1, B=1: the attention RMS norm is fused into the wqkv matvec
    (fuse="norm"; unfused projections take the plain norm), the FFN norm
    into the gate|up matvec and SwiGLU into the down matvec ("norm"/"glu"),
    the final norm into the head matvec; each matvec is K1 for a Q4_K
    weight and K4 for Q6_K or Q8_0;
  * T=1 with a contiguous KV cache: the whole attention block is one
    kernel (K2).

Every other shape takes the unfused path: RMS norm, `linear` (K3 or K5 for
the quantized weights of a multi-row batch), rope, the per-row cache
insert (`kv.update`, each row from its own positions[:, 0]), then
attention: K6 over a contiguous `KVCache`; with the q8 cache
(`runtime/kvcache.KVCacheQ8`) at every T, K7 over its int8 codes and
scales.  With the serving engine's paged cache (`runtime/paged.PagedKVCache`)
at T=1 rope runs outside the kernel and K9 inserts and attends in one
launch, as zllm does; at T>1 the rows are scattered into their pages and
K10 attends through the page table.  A row of a T>1 step that holds one
generating token (one trash position repeated after column 0: the
engine's generating rows, which ride its mixed steps in column 0; the
engine pads a prompt run with distinct trash positions) takes its
attention from the T=1 kernel as well, K9 (with the q8 cache, K7's split
form; over a contiguous bf16/f16/f32 cache K2, run on column 0 of the raw
projection rows after K6), so that it gets the bits a decode step would
give it: the multi-row kernels (K10, K7's tensor-core form, K6) agree
with the T=1 ones only to f32 rounding, and a request's greedy tokens
must not depend on the steps it rides.  Every T>1 step runs the T=1
kernel on column 0, the Generator's prefill chunks too (their rows hold
many tokens and keep the multi-row kernel's output).  A speculative verify
step (`forward(..., verify=True)`) holds up to 1 + n_draft decode tokens a
row: it runs the T=1 kernel once a column instead (no multi-row kernel),
so every verified column gets a decode step's bits.  Lookahead's block
mask (`forward(..., mask=, kv_positions=)`) attends through the plain
`attention_ref`, as zllm's XLA reference does.  MLA, LoRA, ALiBi and
sinks are not part of this block.

A mixture-of-experts layer (`cfg.moe` set and the router ffn_gate_inp in
the layer: Mixtral-style llama, qwen2moe, qwen3moe) runs `moe_ffn` in
place of the gated FFN, at every T (the fused decode FFN is off there):
the router's f32 scores, top-k, then the picked experts grouped by expert
after one host read of the picks, each expert's rows through K3 (the
nibble formats) or K5 (the others) at every M, M = 1 included, as zllm
runs its experts: dequantize, then multiply, with no int8 rounding of the
activations (K1/K4 never take an expert).

Gemma (gemma, gemma2, gemma3) runs the llama block with zllm's changes:
the embedding times sqrt(n_embd) rounded to the embedding's dtype; the
gated FFN's geglu (its norm, gate|up and down unfused through `linear`:
zllm fuses SwiGLU only); Gemma-2/3's post-norms on the attention and FFN
outputs (sandwich norms); Gemma-3's per-head q/k norms (Qwen3's, in K2
too); the final logit softcap.  A sliding window (`cfg.layer_window`:
gemma2 every other layer, gemma3 five of six) goes into every attention
kernel of its layer, and a windowed layer takes its own rope
(`cfg.layer_rope`: gemma3's rope.freq_base_swa), in K2 from a table of its
own kind (`_k2_ropes`).  Over the serving engine's ring cache
(`runtime/kvcache.KVCacheSWA`) a windowed layer writes its ring and
attends through `ring_mask` with the plain `attention_ref`, as zllm does
(no kernel reads the ring), column 0 of a T>1 step once more at T=1 as
on the other paths; its full layers are ordinary stripes (K2, K6).

The layer-norm families (gptneox, stablelm, starcoder2; `cfg.norm_kind ==
"layer"`) run the llama block with LayerNorms (`block_norm`: weight and
bias, at the pre-norms and the final norm), wo's bias where the file has
one, and, gptneox and starcoder2, the non-gated MLP: ffn_up (+ its bias),
the gelu of the f32 values (GPT-NeoX's exact one, StarCoder2's tanh one),
ffn_down (+ its bias); StableLM keeps the gated SwiGLU.  Their rope turns
the first rope.dimension_count dims of a head (neox halves; Pythia 32 of
128, StableLM-2 16 of 64), the rest pass through, in K2's table and in
`apply_rope` alike.  `cfg.parallel_residual == "separate"` (GPT-NeoX's
use_parallel_residual) feeds the FFN the layer's input through ffn_norm
and sums x + attention + FFN in that order.  As in zllm, the decode
fusions that carry K1's RMS prologue are off for them: no norm->wqkv
matvec (RMS norms only, not with a parallel residual), no norm->gate|up
and glu->down (RMS norms and SwiGLU only), no norm->head; each projection
is K1 or K4 unfused.

OLMo-2 (`cfg.arch == "olmo2"`, `_olmo2_layer`) has no pre-norms: the
projections read the raw residual stream through `linear` (at T=1, B=1
that is K1 with fuse="q"; zllm's fused-norm fast paths need the pre-norms),
then one RMS norm over the whole q projection and one over k (not per
head, so K2 cannot take the step), neox rope, attention, wo, an RMS
post-norm on the attention output; the FFN reads the raw stream (gate|up,
SwiGLU, down) and its output gets the second RMS post-norm.  Attention by
cache: a contiguous bf16/f16/f32 `KVCache` at T=1 goes to K8
(`attn_decode_update`: insert the roped row and attend in one call), at
T>1 to the insert and K6, then K8 on column 0 for the one-token rows; the
paged cache to K9/K10 and the q8 cache to K7, as for llama.  zllm's TPU
gate for its K8 (`use_decode_fused`: G % 8 == 0 or G == Hq) is not
carried over: OLMo-2-1B (G = 1) fails it, so zllm on a TPU takes its
unfused path there, while the port sends every such step to K8.

`forward(..., taps=)` records each matmul's input under zllm's names for
the importance matrix (`zllm_torch/imatrix.py`); the fused decode paths
are off then, as in zllm.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import qmatmul as qmm
from ..ops.attention import (
    attn_decode_qkv, attn_decode_update, flash_attention, flash_attention_blockwise,
    paged_attention, paged_attn_decode_update,
)
from ..ops.layers import (apply_rope, attention_ref, geglu, gelu, layer_norm, rms_norm,
                          rope_table, swiglu)
from ..ops.linear import fused_glu_linear, fused_norm_linear, linear
from ..quant.repack import QWeight, QWeightE
from ..runtime.kvcache import KVCache, KVCacheQ8, KVCacheSWA, ring_mask
from ..runtime.paged import PagedKVCache


def _layer_window(cfg, il: int) -> int:
    """Layer il's sliding window, 0 for none (a config without windows
    has none)."""
    return cfg.layer_window(il) if getattr(cfg, "sliding_window", 0) else 0


def _layer_rope(cfg, il: int):
    """Layer il's rope (`ModelConfig.layer_rope`; `cfg.rope` where no
    windowed rope is set)."""
    return cfg.layer_rope(il) if getattr(cfg, "rope_swa", None) is not None else cfg.rope


def _ring(kv, il: int) -> int:
    """Layer il's ring slots in a `KVCacheSWA` (its windowed layers), else 0."""
    return kv.ring_size(il) if isinstance(kv, KVCacheSWA) else 0


def _act(cfg):
    """The gated FFN's activation: SwiGLU, or Gemma's geglu."""
    return geglu if getattr(cfg, "act", "silu") == "gelu" else swiglu


def block_norm(x: torch.Tensor, params: dict, key: str, cfg) -> torch.Tensor:
    """The norm `params[key]` of x by the config's norm kind (zllm's
    `block_norm`): a LayerNorm with the bias `params[key + "_b"]` where
    the file has one, else an RMS norm."""
    if getattr(cfg, "norm_kind", "rms") == "layer":
        return layer_norm(x, params[key], params.get(key + "_b"), cfg.norm_eps)
    return rms_norm(x, params[key], cfg.norm_eps)


def _one_token_rows(out: torch.Tensor, positions: torch.Tensor,
                    first: torch.Tensor) -> torch.Tensor:
    """`out` [B, T, ...] of a T>1 step with column 0 replaced by `first`
    [B, 1, ...] (the T=1 kernel's attention of column 0) in every row that
    holds one generating token: columns 1 and 2 hold the same (trash)
    position, or (T = 2) column 1 is not column 0's next position.  The
    engine pads a prompt run with distinct trash positions, so a prompt
    chunk of one token keeps the multi-row kernel's bits."""
    if positions.shape[1] > 2:
        one = positions[:, 1] == positions[:, 2]
    else:
        one = positions[:, 1] != positions[:, 0] + 1
    one = one.reshape(-1, *[1] * (out.dim() - 2))
    out[:, 0] = torch.where(one, first[:, 0], out[:, 0])
    return out


def _attend(q, k, v, kv, il: int, positions: torch.Tensor, cfg, scale: float, *,
            mask: torch.Tensor | None = None, kv_positions: torch.Tensor | None = None,
            verify: bool = False, window: int = 0) -> torch.Tensor:
    """Attention of roped q [B, T, Hq, D] and k/v [B, T, Hkv, D] with the
    new rows inserted into `kv` (if any) at their positions (`kv_positions`
    where given), over the slots > pos - `window` (0: all).  `mask` [B, T,
    S]: attention over the whole contiguous cache under that mask
    (`attention_ref`), no kernel; `verify`: each column through the T=1
    kernel at its own position (see `forward`); a windowed layer of a
    `KVCacheSWA`: its ring under `ring_mask` (`attention_ref`)."""
    b, t = q.shape[:2]
    softcap = cfg.attn_logit_softcap
    if mask is not None:
        if kv is None:
            k_all, v_all = k.transpose(1, 2), v.transpose(1, 2)
        elif isinstance(kv, KVCache):
            kv.update(il, k, v, positions if kv_positions is None else kv_positions)
            k_all, v_all = kv.layer(il)
        else:
            raise ValueError("an explicit attention mask needs a contiguous KVCache")
        return attention_ref(q, k_all, v_all, mask, scale, logit_softcap=softcap)
    ring = _ring(kv, il)
    if ring:  # the ring's slots are not positions: its own mask, no kernel
        kv.update(il, k, v, positions)
        k_all, v_all = kv.layer(il)
        rmask = ring_mask(positions, ring, k_all.shape[2], window)
        out = attention_ref(q, k_all, v_all, rmask, scale, logit_softcap=softcap)
        if t == 1 or verify:
            return out
        # column 0 once more at T = 1, as a decode step computes it
        first = attention_ref(q[:, :1], k_all, v_all, rmask[:, :1], scale, logit_softcap=softcap)
        return _one_token_rows(out, positions, first)
    if isinstance(kv, PagedKVCache):
        def k9(q_, k_, v_, pos):  # insert into the page, attend
            return paged_attn_decode_update(q_, k_, v_, kv.k[il], kv.v[il], kv.table, pos,
                                            page_size=kv.page_size, scale=scale,
                                            softcap=softcap, window=window)

        if t == 1:
            return k9(q, k, v, positions)
        if verify:
            return _per_column(k9, q, k, v, positions)
        kv.update(il, k, v, positions)  # scatter the rows into their pages, then K10
        out = paged_attention(q.contiguous(), kv.k[il], kv.v[il], kv.table, positions,
                              page_size=kv.page_size, scale=scale, softcap=softcap,
                              window=window)
        # column 0 once more through K9, which writes the rows kv.update wrote
        first = k9(*(x[:, :1].contiguous() for x in (q, k, v, positions)))
        return _one_token_rows(out, positions, first)
    if isinstance(kv, KVCacheQ8):  # quantize and insert, then K7 on the codes
        kv.update(il, k, v, positions)
        kq, vq = kv.layer(il)

        def k7(q_, pos):
            return flash_attention_blockwise(q_.contiguous(), kq.q, vq.q, pos.contiguous(),
                                             scale=scale, softcap=softcap, window=window,
                                             ks=kq.s, vs=vq.s)

        if verify:  # every row is in the cache: each column reads its own prefix
            return torch.cat([k7(q[:, j:j + 1], positions[:, j:j + 1]) for j in range(t)],
                             dim=1)
        out = k7(q, positions)
        if t == 1:
            return out
        return _one_token_rows(out, positions, k7(q[:, :1], positions[:, :1]))
    if kv is not None:
        def k8(q_, k_, v_, pos):  # insert the row at min(pos, S-1), attend
            return attn_decode_update(q_, k_, v_, kv.k[il], kv.v[il], pos, scale=scale,
                                      softcap=softcap, window=window)

        if t == 1:
            return k8(q, k, v, positions)
        if verify:
            return _per_column(k8, q, k, v, positions)
        kv.update(il, k, v, positions)
        k_all, v_all = kv.layer(il)
        out = flash_attention(q.contiguous(), k_all.contiguous(), v_all.contiguous(),
                              positions, scale=scale, softcap=softcap, window=window)
        if cfg.arch != "olmo2":  # llama's T=1 kernel is K2, which layer_forward runs
            return out
        # column 0 once more through K8, which writes the k/v kv.update wrote
        first = k8(*(x[:, :1].contiguous() for x in (q, k, v, positions)))
        return _one_token_rows(out, positions, first)
    return flash_attention(q.contiguous(), k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), positions, scale=scale,
                           softcap=softcap, window=window)


def _per_column(kernel, q, k, v, positions) -> torch.Tensor:
    """A verify step's attention: `kernel` (K9 or K8: insert one row, then
    attend) once a column, in column order, each at its own position, so
    column j reads the slots columns 0..j wrote, as the decode step at
    that position would."""
    cols = [kernel(*(x[:, j:j + 1].contiguous() for x in (q, k, v, positions)))
            for j in range(q.shape[1])]
    return torch.cat(cols, dim=1)


def _split_heads(qkv: torch.Tensor, cfg):
    b, t = qkv.shape[:2]
    qd, kvd, d = cfg.q_dim, cfg.kv_dim, cfg.head_dim
    return (qkv[..., :qd].reshape(b, t, -1, d), qkv[..., qd:qd + kvd].reshape(b, t, -1, d),
            qkv[..., qd + kvd:].reshape(b, t, -1, d))


def _projections(layer: dict, h: torch.Tensor) -> torch.Tensor:
    """The q|k|v rows of h, biases added (Qwen2): the fused wqkv, or wq,
    wk, wv apart when their formats differ (loader._fusable), side by side
    as the fused layout."""
    if "wqkv" in layer:
        return linear(h, layer["wqkv"], layer.get("bqkv"))
    return torch.cat([linear(h, layer[w], layer.get(b))
                      for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))], dim=-1)


# a dense product inside moe_ffn takes its rows in blocks of this many
# on the card (`_rows_linear`)
MOE_DENSE_ROWS = 16


def _rows_linear(x: torch.Tensor, w) -> torch.Tensor:
    """linear(x, w) for x [M, K]; on the card a dense w takes x in blocks of
    MOE_DENSE_ROWS rows (the last zero-padded), one matmul shape for every
    M: the library picks its kernel by shape, so a row's bits then do not
    depend on the rows beside it, as K3's and K5's do not (the router's
    scores pick the experts; the engine batches rows of many requests)."""
    if isinstance(w, QWeight) or x.device.type == "cpu":
        return linear(x, w)
    m, pad = x.shape[0], (-x.shape[0]) % MOE_DENSE_ROWS
    xp = torch.cat([x, x.new_zeros((pad, x.shape[1]))]) if pad else x
    return torch.cat([linear(xp[i:i + MOE_DENSE_ROWS], w)
                      for i in range(0, m + pad, MOE_DENSE_ROWS)])[:m]


def _expert_mm(x: torch.Tensor, w, e: int) -> torch.Tensor:
    """x [M, K] @ expert e of a stack, in x's dtype: K3 or K5 on a
    QWeightE's expert at any M (`qmm.gemm`; its f32 rounded to x's dtype,
    as zllm's einsum in the activation dtype gives it), or torch.matmul on
    a dense [E, K, N] stack (zllm's product outside any Pallas kernel)."""
    if isinstance(w, QWeightE):
        return qmm.gemm(x.contiguous(), w.expert(e)).to(x.dtype)
    return _rows_linear(x, w[e]).to(x.dtype)


def _gate_up(layer: dict, fused: str, gate: str, up: str, mm, act):
    """act(gate, up) of the fused gate|up weight `fused` (its halves) or of
    gate and up apart, each product through mm(weight)."""
    if fused in layer:
        gup = mm(layer[fused])
        half = gup.shape[-1] // 2
        return act(gup[..., :half], gup[..., half:])
    return act(mm(layer[gate]), mm(layer[up]))


def moe_ffn(layer: dict, cfg, h: torch.Tensor) -> torch.Tensor:
    """The mixture-of-experts FFN (zllm's `moe_ffn`, `zllm/models/llama.py`:
    its sparse regime at T * k < E and its dense masked regime compute this
    one function).  The router's logits through `linear`, scored in f32
    (softmax or sigmoid), top-k, normalized over the k picks where
    `norm_topk_prob`, times `scale`.  Dispatch by expert, one way at every
    T: the (token, pick) pairs grouped by expert after one host read of the
    picks; each expert used takes its rows through gate|up (one product, or
    gate and up apart), the activation, then down, and writes its results
    to the rows' (token, pick) slots of a [T * k, n_embd] buffer; the k
    picks are then weighted and summed in pick order in f32 and cast.  No
    index_add_ and no atomics: a row's bits do not depend on the rows
    beside it, nor on the order of the launches (the dense products too:
    `_rows_linear`).  qwen2moe's shared expert and its sigmoid gate are
    added through `linear`.  `moe_ffn.routing`, when a list, receives a
    call's (layer, the experts used ascending, the picks [T * k] on the
    host, the router probabilities [T, E] f32)."""
    moe = cfg.moe
    lead, n_embd = h.shape[:-1], h.shape[-1]
    hf = h.reshape(-1, n_embd)
    t, k = hf.shape[0], moe.n_experts_used
    scores = _rows_linear(hf, layer["ffn_gate_inp"]).float()
    probs = torch.sigmoid(scores) if moe.gate_func == "sigmoid" else torch.softmax(scores, -1)
    topv, topi = torch.topk(probs, k, dim=-1)  # [T, k], descending
    if moe.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    if moe.scale != 1.0:
        topv = topv * moe.scale
    act = _act(cfg)

    picks = topi.reshape(-1).cpu().numpy()  # the layer's one host read
    order = np.argsort(picks, kind="stable")  # pick slots t * k + j, grouped by expert
    experts, starts = np.unique(picks[order], return_index=True)
    bounds = [*starts.tolist(), t * k]
    slots = torch.from_numpy(order).to(h.device)
    out = torch.empty((t * k, n_embd), dtype=h.dtype, device=h.device)
    for i, e in enumerate(experts.tolist()):
        sl = slots[bounds[i]:bounds[i + 1]]
        x = hf[sl // k]
        gu = _gate_up(layer, "ffn_gateup_exps", "ffn_gate_exps", "ffn_up_exps",
                      lambda w: _expert_mm(x, w, e), act)
        out[sl] = _expert_mm(gu, layer["ffn_down_exps"], e)
    if isinstance(moe_ffn.routing, list):
        moe_ffn.routing.append((layer, experts.tolist(), picks, probs))
    weighted = out.reshape(t, k, n_embd).float() * topv.to(h.dtype).float()[..., None]
    y = weighted[:, 0]
    for j in range(1, k):  # the picks in order
        y = y + weighted[:, j]
    y = y.to(h.dtype).reshape(*lead, n_embd)
    if "ffn_down_shexp" in layer:
        sh = _gate_up(layer, "ffn_gateup_shexp", "ffn_gate_shexp", "ffn_up_shexp",
                      lambda w: _rows_linear(hf, w), act)
        sh = _rows_linear(sh, layer["ffn_down_shexp"])
        if "ffn_gate_inp_shexp" in layer:  # qwen2moe's sigmoid-gated shared expert
            gate = _rows_linear(hf, layer["ffn_gate_inp_shexp"]).float()
            sh = sh * torch.sigmoid(gate).to(sh.dtype)
        y = y + sh.reshape(*lead, n_embd)
    return y.to(h.dtype)


moe_ffn.routing = None


def _ffn_core(layer: dict, h: torch.Tensor, taps: dict | None = None,
              tapname: str = "", act=swiglu, cfg=None) -> torch.Tensor:
    """The FFN of the normed h: the experts (`moe_ffn`), the gated act(gate,
    up) -> down (gate|up fused, or apart where their formats differ), or
    the non-gated up (+ ffn_up_b) -> gelu -> down (+ ffn_down_b) of gptneox
    and starcoder2; tested in zllm's `_ffn_core` order."""
    if taps is not None:
        taps[f"{tapname}.ffn_gate.weight"] = h
    if cfg is not None and cfg.moe is not None and "ffn_gate_inp" in layer:
        return moe_ffn(layer, cfg, h)  # zllm taps no expert's input
    if "ffn_gateup" in layer or "ffn_gate" in layer:
        gu = _gate_up(layer, "ffn_gateup", "ffn_gate", "ffn_up", lambda w: linear(h, w), act)
    else:
        gu = gelu(linear(h, layer["ffn_up"], layer.get("ffn_up_b")),
                  exact=cfg.act == "gelu_exact")
    if taps is not None:
        taps[f"{tapname}.ffn_down.weight"] = gu
    ff = linear(gu, layer["ffn_down"])
    if "ffn_down_b" in layer:
        ff = ff + layer["ffn_down_b"].to(ff.dtype)
    return ff


def _wo(layer: dict, att: torch.Tensor) -> torch.Tensor:
    """The attention output projection, plus its bias bo where the file
    has one (added in the product's dtype, as zllm adds it)."""
    o = linear(att, layer["wo"])
    if "bo" in layer:
        o = o + layer["bo"].to(o.dtype)
    return o


def _olmo2_layer(layer: dict, cfg, x: torch.Tensor, positions: torch.Tensor, kv,
                 il: int, taps: dict | None = None, **attend) -> torch.Tensor:
    """One OLMo-2 block (zllm's layer_forward without attn_norm / ffn_norm,
    with the whole-projection q/k norms and the post-norms)."""
    b, t = x.shape[:2]
    scale = cfg.attn_scale if cfg.attn_scale else 1.0 / (cfg.head_dim ** 0.5)
    tapname = f"blk.{il}"
    if taps is not None:  # the projections read the raw stream
        taps[f"{tapname}.attn_q.weight"] = x
    q, k, v = _split_heads(_projections(layer, x).reshape(b, t, -1), cfg)
    q = rms_norm(q.reshape(b, t, -1), layer["attn_q_norm"], cfg.norm_eps).reshape(q.shape)
    k = rms_norm(k.reshape(b, t, -1), layer["attn_k_norm"], cfg.norm_eps).reshape(k.shape)
    q = apply_rope(q, positions, cfg.rope)
    k = apply_rope(k, positions, cfg.rope)
    att = _attend(q, k, v, kv, il, positions, cfg, scale, **attend).reshape(b, t, -1)
    if taps is not None:
        taps[f"{tapname}.attn_output.weight"] = att
    x = x + rms_norm(_wo(layer, att), layer["attn_post_norm"], cfg.norm_eps)
    x = x + rms_norm(_ffn_core(layer, x, taps, tapname), layer["ffn_post_norm"], cfg.norm_eps)
    if taps is not None:
        taps[f"{tapname}.l_out"] = x
    return x


def layer_forward(layer: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                  kv: KVCache | KVCacheQ8 | PagedKVCache | None, il: int,
                  rope=None, taps: dict | None = None, *, mask: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None,
                  verify: bool = False) -> torch.Tensor:
    """One transformer block; x [B, T, n_embd], positions [B, T] int32.
    `rope` is K2's tables over a contiguous cache (`_k2_ropes`, built
    once per step): by kind of rope, the cos/sin table at positions[:, 0],
    or with `verify` the list of one table a column.  `taps` (see
    `forward`) takes the block's matmul inputs and output; it turns the
    fused decode paths off; so do `mask` and `kv_positions` (see
    `forward`)."""
    window = _layer_window(cfg, il)
    attend = dict(mask=mask, kv_positions=kv_positions, verify=verify, window=window)
    if cfg.arch == "olmo2":
        return _olmo2_layer(layer, cfg, x, positions, kv, il, taps, **attend)
    b, t = x.shape[:2]
    scale = cfg.attn_scale if cfg.attn_scale else 1.0 / (cfg.head_dim ** 0.5)
    tapname = f"blk.{il}"
    parallel = getattr(cfg, "parallel_residual", "none") != "none"
    # K1's prologue is an RMS norm: the fused decode paths are the RMS blocks'
    fused = (t == 1 and b == 1 and taps is None
             and getattr(cfg, "norm_kind", "rms") == "rms")

    qkv = None
    if "wqkv" in layer and fused and not parallel:  # decode: norm fused into the qkv matvec
        qkv = fused_norm_linear(x.reshape(1, -1), layer["attn_norm"], cfg.norm_eps,
                                layer["wqkv"])
        if qkv is not None and "bqkv" in layer:
            qkv = qkv + layer["bqkv"].to(qkv.dtype)
    if qkv is None:
        h = block_norm(x, layer, "attn_norm", cfg)
        if taps is not None:
            taps[f"{tapname}.attn_q.weight"] = h
        qkv = _projections(layer, h)
    qkv = qkv.reshape(b, t, -1)

    lrope = _layer_rope(cfg, il)
    # K2 takes the decode columns (not a ring layer's: its slots are not positions)
    k2_step = isinstance(kv, KVCache) and mask is None and not _ring(kv, il)
    if k2_step and rope is None:
        rope = _k2_ropes(positions, cfg, verify, [lrope])

    # Qwen3's per-head q/k norms (the loader holds them to head_dim)
    qw, kw = layer.get("attn_q_norm"), layer.get("attn_k_norm")

    cols = positions.t().contiguous() if k2_step else None  # each column's positions [T, B]

    def k2(row, j=0):  # the whole decode attention block in one kernel: split,
        # per-head q/k norms, rope, in-place cache insert at min(pos, S-1),
        # attention; column j of the step
        rt = rope[lrope][j] if verify else rope[lrope]
        return attn_decode_qkv(row.reshape(b, -1, cfg.head_dim).contiguous(), kv.k[il],
                               kv.v[il], cols[j], rt, qw, kw, scale=scale,
                               softcap=cfg.attn_logit_softcap, window=window, eps=cfg.norm_eps)

    if k2_step and t == 1:
        att = k2(qkv)
    elif k2_step and verify:
        # a verify step: K2 once a column, in column order, each inserting
        # its own row at its own position, so column j reads what the
        # decode step at that position would read and gets its bits
        rows = qkv.transpose(0, 1).contiguous()  # [T, B, Hq + 2 Hkv x D]: a column's rows
        att = torch.cat([k2(rows[j], j) for j in range(t)], dim=1)
    else:
        q, k, v = _split_heads(qkv, cfg)
        if qw is not None:
            q = rms_norm(q, qw, cfg.norm_eps)
            k = rms_norm(k, kw, cfg.norm_eps)
        q = apply_rope(q, positions, lrope)
        k = apply_rope(k, positions, lrope)
        att = _attend(q, k, v, kv, il, positions, cfg, scale, **attend)
        if k2_step:
            # column 0 once more through K2, as a decode step: it re-inserts
            # every row's slot pos0 with its own rope, whose bits equal
            # apply_rope's (one f32 product and one sum a pair, no FMA);
            # Qwen3's per-head norm there sums its mean in f32 where
            # rms_norm sums in f64, so that k may move by an f32 rounding
            att = _one_token_rows(att, positions, k2(qkv[:, :1]))
    att = att.reshape(b, t, -1)
    if taps is not None:
        taps[f"{tapname}.attn_output.weight"] = att
    o = _wo(layer, att)
    if "attn_post_norm" in layer:  # Gemma-2/3's sandwich norm
        o = rms_norm(o, layer["attn_post_norm"], cfg.norm_eps)
    act = _act(cfg)
    if parallel:  # the FFN reads the layer's input: x + attention + FFN, in that order
        ff = _ffn_core(layer, block_norm(x, layer, "ffn_norm", cfg), taps, tapname, act, cfg)
        return x + o + ff
    x = x + o

    ff = None
    if fused and act is swiglu and "ffn_gateup" in layer:
        # decode: norm -> gate|up and swiglu -> down fused (not an MoE layer,
        # nor gate and up apart)
        gup = fused_norm_linear(x.reshape(1, -1), layer["ffn_norm"], cfg.norm_eps,
                                layer["ffn_gateup"])
        if gup is not None:
            ff = fused_glu_linear(gup, layer["ffn_down"])
            if ff is None:
                half = gup.shape[-1] // 2
                ff = linear(swiglu(gup[..., :half], gup[..., half:]).to(x.dtype),
                            layer["ffn_down"])
            ff = ff.reshape(b, t, -1)
    if ff is None:
        ff = _ffn_core(layer, block_norm(x, layer, "ffn_norm", cfg), taps, tapname, act, cfg)
    if "ffn_post_norm" in layer:
        ff = rms_norm(ff, layer["ffn_post_norm"], cfg.norm_eps)
    x = x + ff
    if taps is not None:
        taps[f"{tapname}.l_out"] = x
    return x


def _k2_ropes(positions: torch.Tensor, cfg, verify: bool, ropes) -> dict:
    """K2's rope tables, one for each kind of rope in `ropes` (the layers'
    `_layer_rope`s: Gemma-3's full and windowed layers rotate apart),
    keyed by its RopeParams, so a layer reads its own kind's: the table at
    positions[:, 0], or with `verify` one a column."""
    def table(p):
        if verify:
            return [rope_table(positions[:, j], p, cfg.head_dim)
                    for j in range(positions.shape[1])]
        return rope_table(positions[:, 0], p, cfg.head_dim)

    return {p: table(p) for p in dict.fromkeys(ropes)}


def embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding rows; Gemma's times sqrt(n_embd), the scale
    rounded to the embedding's dtype first (zllm's `embed`: in bf16, 50.5
    for Gemma-3-4B's sqrt(2560) = 50.596)."""
    x = params["tok_emb"][tokens.long()]
    if cfg.arch.startswith("gemma"):
        x = x * torch.full((), cfg.n_embd ** 0.5, dtype=x.dtype, device=x.device)
    return x


def forward(params: dict, cfg, tokens: torch.Tensor, positions: torch.Tensor,
            kv: KVCache | KVCacheQ8 | PagedKVCache | None = None, *,
            logits_for: str = "all", taps: dict | None = None,
            mask: torch.Tensor | None = None, kv_positions: torch.Tensor | None = None,
            verify: bool = False) -> torch.Tensor:
    """tokens/positions [B, T] int32 -> logits [B, T or 1, vocab] f32.
    The cache is updated in place, each row at its own positions, so the
    rows may sit anywhere (the serving engine's slots, trash rows
    included): a contiguous cache writes row b's run from positions[b, 0]
    (clamped to end at its last slot), a paged one each token at its own
    position.

    `taps`, when given a dict, receives each matmul's input activation
    [B, T, K] keyed by the GGUF tensor it feeds, as zllm's forward
    records them for the importance matrix: blk.N.attn_q.weight (the
    normed input of the q/k/v projections; OLMo-2's raw stream),
    blk.N.attn_output.weight (the attention output before wo),
    blk.N.ffn_gate.weight (the FFN's input), blk.N.ffn_down.weight (the
    SwiGLU output), blk.N.l_out (the block's output) and hidden (the
    final normed stream); with taps the fused decode paths are off.

    `mask` [B, T, S] bool (lookahead's block mask): every query attends
    the slots its row marks, over the whole contiguous cache, through the
    plain `attention_ref` (zllm's XLA reference there); the decode
    kernels are off.  `kv_positions` [B, T]: the cache slots the rows are
    stored in, apart from their rope positions (the contiguous run from
    kv_positions[:, 0]).

    `verify` (the serving engine's speculative verify step): every column
    of every row is a decode step of its own, its token at positions[b, j]
    (trash positions past the horizon in the unused columns).  Attention
    runs the T=1 kernel once a column, in column order, each inserting its
    own row at its position (K2 over a contiguous cache, K8 for OLMo-2, K9
    paged; the q8 cache inserts the rows first, then K7's split form a
    column), so a verified column gets exactly the attention the decode
    step at that position would give; the matmuls at M >= 2 give each row
    the same bits whatever M is (`ops/qmatmul.slice_plan`)."""
    if verify and (kv is None or mask is not None):
        raise ValueError("verify needs a KV cache and no mask")
    if kv_positions is not None and mask is None:
        raise ValueError("kv_positions goes with an explicit mask")
    x = embed(params, cfg, tokens)
    rope = None
    if isinstance(kv, KVCache) and cfg.arch != "olmo2" and mask is None:  # K2's, once a step
        rope = _k2_ropes(positions, cfg, verify,
                         [_layer_rope(cfg, il) for il in range(len(params["layers"]))])
    for il, layer in enumerate(params["layers"]):
        x = layer_forward(layer, cfg, x, positions, kv, il, rope, taps, mask=mask,
                          kv_positions=kv_positions, verify=verify)

    logits = None
    if (logits_for == "last" and x.shape[0] == 1 and taps is None
            and getattr(cfg, "norm_kind", "rms") == "rms"):  # norm fused into the head
        logits = fused_norm_linear(x[:, -1].reshape(1, -1), params["out_norm"], cfg.norm_eps,
                                   params["output"])
        if logits is not None:
            logits = logits.reshape(1, 1, -1).float()
    if logits is None:
        x = block_norm(x, params, "out_norm", cfg)
        if taps is not None:
            taps["hidden"] = x
        if logits_for == "last":
            x = x[:, -1:, :]
        logits = linear(x, params["output"]).float()
    logits = logits[..., : cfg.vocab_size]
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap > 0:
        logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits
