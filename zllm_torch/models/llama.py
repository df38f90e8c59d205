"""Llama forward pass (plain PyTorch around the port's kernels).

The counterpart of `zllm/models/llama.py::forward` / `layer_forward` for
the plain llama block: RMS norm -> fused wqkv (or wq, wk, wv apart when
their formats differ, as in Q4_K_M files) -> rope -> GQA attention with
KV-cache insert -> wo -> RMS norm -> fused gate|up -> SwiGLU -> down, both
residual; final norm and output head.  The decode fast paths sit where
`zllm` has them:

  * T=1, B=1: the attention RMS norm is fused into the wqkv matvec
    (fuse="norm"; unfused projections take the plain norm), the FFN norm
    into the gate|up matvec and SwiGLU into the down matvec ("norm"/"glu"),
    the final norm into the head matvec; each matvec is K1 for a Q4_K
    weight and K4 for Q6_K or Q8_0;
  * T=1 with a KV cache: the whole attention block is one kernel (K2).

Every other shape takes the unfused path: RMS norm, `linear` (K3 or K5 for
the quantized weights of a multi-row batch), rope, cache insert, then
prefill attention (K6).  MoE, MLA, LoRA, sliding window, ALiBi and sinks are not
part of this block.
"""

from __future__ import annotations

import torch

from ..ops.attention import attn_decode_qkv, flash_attention
from ..ops.layers import apply_rope, rms_norm, rope_table, swiglu
from ..ops.linear import fused_glu_linear, fused_norm_linear, linear
from ..runtime.kvcache import KVCache


def layer_forward(layer: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                  kv: KVCache | None, il: int, rope=None, start: int | None = None
                  ) -> torch.Tensor:
    """One transformer block; x [B, T, n_embd], positions [B, T] int32.
    `rope` is the decode step's cos/sin table (built once per step);
    `start` the first cache slot of a multi-token insert (a host int)."""
    b, t = x.shape[:2]
    scale = cfg.attn_scale if cfg.attn_scale else 1.0 / (cfg.head_dim ** 0.5)

    if "wqkv" in layer:
        qkv = None
        if t == 1 and b == 1:  # decode: norm fused into the qkv matvec prologue
            qkv = fused_norm_linear(x.reshape(1, -1), layer["attn_norm"], cfg.norm_eps,
                                    layer["wqkv"])
        if qkv is None:
            qkv = linear(rms_norm(x, layer["attn_norm"], cfg.norm_eps), layer["wqkv"])
    else:
        # projections of different formats stay apart (loader._fusable):
        # the plain norm, then one matvec or GEMM each, as zllm's unfused
        # branch; their outputs side by side are the fused layout
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        qkv = torch.cat([linear(h, layer[key]) for key in ("wq", "wk", "wv")], dim=-1)
    qkv = qkv.reshape(b, t, -1)
    qd, kvd, d = cfg.q_dim, cfg.kv_dim, cfg.head_dim

    if kv is not None and t == 1:
        # the whole decode attention block in one kernel: split, rope,
        # in-place cache insert, attention
        if rope is None:
            rope = rope_table(positions[:, 0], cfg.rope, d)
        att = attn_decode_qkv(qkv.reshape(b, -1, d).contiguous(), kv.k[il], kv.v[il],
                              positions[:, 0].contiguous(), rope, scale=scale,
                              softcap=cfg.attn_logit_softcap, eps=cfg.norm_eps)
    else:
        q = qkv[..., :qd].reshape(b, t, -1, d)
        k = qkv[..., qd:qd + kvd].reshape(b, t, -1, d)
        v = qkv[..., qd + kvd:].reshape(b, t, -1, d)
        q = apply_rope(q, positions, cfg.rope)
        k = apply_rope(k, positions, cfg.rope)
        if kv is not None:
            kv.update(il, k, v, start)
            k_all, v_all = kv.layer(il)
        else:
            k_all, v_all = k.transpose(1, 2), v.transpose(1, 2)
        att = flash_attention(q.contiguous(), k_all.contiguous(), v_all.contiguous(),
                              positions, scale=scale, softcap=cfg.attn_logit_softcap)
    x = x + linear(att.reshape(b, t, -1), layer["wo"])

    ff = None
    if t == 1 and b == 1:  # decode: norm -> gate|up and swiglu -> down fused
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
        gup = linear(rms_norm(x, layer["ffn_norm"], cfg.norm_eps), layer["ffn_gateup"])
        half = gup.shape[-1] // 2
        ff = linear(swiglu(gup[..., :half], gup[..., half:]), layer["ffn_down"])
    return x + ff


def forward(params: dict, cfg, tokens: torch.Tensor, positions: torch.Tensor,
            kv: KVCache | None = None, *, start: int | None = None,
            logits_for: str = "all") -> torch.Tensor:
    """tokens/positions [B, T] int32 -> logits [B, T or 1, vocab] f32.
    The cache is updated in place; with a cache and T > 1, `start` is the
    host copy of positions[:, 0] (every row's first position)."""
    if kv is not None and tokens.shape[1] > 1 and start is None:
        raise ValueError("a multi-token step with a KV cache needs its start position")
    x = params["tok_emb"][tokens.long()]
    rope = None
    if kv is not None and tokens.shape[1] == 1:
        rope = rope_table(positions[:, 0], cfg.rope, cfg.head_dim)
    for il, layer in enumerate(params["layers"]):
        x = layer_forward(layer, cfg, x, positions, kv, il, rope, start)

    logits = None
    if logits_for == "last" and x.shape[0] == 1:  # final norm fused into the head
        logits = fused_norm_linear(x[:, -1].reshape(1, -1), params["out_norm"], cfg.norm_eps,
                                   params["output"])
        if logits is not None:
            logits = logits.reshape(1, 1, -1).float()
    if logits is None:
        x = rms_norm(x, params["out_norm"], cfg.norm_eps)
        if logits_for == "last":
            x = x[:, -1:, :]
        logits = linear(x, params["output"]).float()
    logits = logits[..., : cfg.vocab_size]
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap > 0:
        logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits
