"""Model hyper-parameters resolved from GGUF metadata: the fields the
llama path reads (counterpart of `zllm/models/config.py::ModelConfig`,
whose `from_gguf` resolves the same keys the same way for plain llama,
OLMo-2, Qwen2, Qwen3, the Gemma text families: gemma, gemma2 and
gemma3, with their gelu, sliding windows, rope base of the windowed
layers and `attention.query_pre_attn_scalar`, and the mixture-of-experts
files: Mixtral-style llama with `expert_count`, qwen2moe and qwen3moe,
whose expert keys resolve into `MoeConfig` as zllm resolves them, and the
layer-norm families gptneox, stablelm and starcoder2, with their norm
kind, activation, `use_parallel_residual` and partial rope)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..gguf.reader import GGUFFile
from ..ops.layers import RopeParams

_ROPE_SCALING_NAMES = {0: "none", 1: "linear", 2: "yarn", 3: "longrope"}

# architectures whose graph is the llama block this port runs: plain llama
# (Llama-3 files too: rope_freqs.weight is loaded and not read, as zllm
# does), OLMo-2 (no pre-norms; whole-projection q/k RMS norms; RMS
# post-norms on the attention and FFN outputs), Qwen2 (q/k/v biases) and
# Qwen3 (per-head q/k RMS norms) and Gemma: the embedding scaled by
# sqrt(n_embd), geglu, a tied head; gemma2 and gemma3 add the post-norms
# (sandwich norms), a sliding window on all but every swa_pattern-th
# layer, and gemma3 Qwen3's per-head q/k norms; qwen2moe and qwen3moe are
# Qwen2's and Qwen3's attention with a mixture-of-experts FFN (qwen2moe
# adds a shared expert behind a sigmoid gate); gptneox, stablelm and
# starcoder2 are the llama block with LayerNorms (weight and bias), neox
# rope over the first rope.dimension_count dims of a head, biases on the
# projections (gptneox and starcoder2 on all of them, stablelm on q/k/v)
# and, gptneox and starcoder2, a non-gated gelu MLP; gptneox files set
# use_parallel_residual (attention and MLP both read the layer's input)
SUPPORTED_ARCHES = ("llama", "olmo2", "qwen2", "qwen3", "gemma", "gemma2", "gemma3", "qwen2moe",
                    "qwen3moe", "gptneox", "stablelm", "starcoder2")
# architectures whose GGUFs carry half-split rope natively (zllm's
# _NEOX_ROPE_ARCHES, restricted to those above): no q/k permutation at load
NEOX_ROPE_ARCHES = ("olmo2", "qwen2", "qwen3", "gemma", "gemma2", "gemma3", "qwen2moe",
                    "qwen3moe", "gptneox", "stablelm", "starcoder2")
# the architectures whose blocks normalize with LayerNorm (zllm's
# norm_kind "layer"), and the activation of each architecture's FFN where
# it is not SwiGLU's silu (zllm's `act`): the tanh-approximate gelu of
# Gemma's geglu and StarCoder2's MLP, GPT-NeoX's exact (erf) one; the
# non-gated MLP (ffn_up, ffn_down) belongs to gptneox and starcoder2
LAYER_NORM_ARCHES = ("gptneox", "stablelm", "starcoder2")
ACTS = {"gemma": "gelu", "gemma2": "gelu", "gemma3": "gelu", "starcoder2": "gelu",
        "gptneox": "gelu_exact"}
NON_GATED_ARCHES = ("gptneox", "starcoder2")
# the architectures whose files may carry experts (`expert_count` > 0), and
# zllm's default of expert_weights_norm for each (llama: Mixtral)
MOE_ARCHES = {"llama": True, "qwen2moe": False, "qwen3moe": True}
_MOE_ITEM = "ROADMAP queue 1 item 8"
# the period of the windowed layers (zllm's swa_pattern: layer il is
# windowed unless (il + 1) % pattern == 0); 1, the other arches': none
SWA_PATTERN = {"gemma2": 2, "gemma3": 6}

# `{arch}.*` keys zllm's from_gguf reads for any architecture and its llama
# forward applies, none of which the port's forward does: the key -> a test
# that the file's value leaves zllm's model the port's (the default)
_UNPORTED_OPTIONS = {
    "embedding_scale": lambda v: float(v) == 1.0,
    "residual_scale": lambda v: float(v) == 1.0,
    "attention.clamp_kqv": lambda v: not float(v or 0.0),
    "swin_norm": lambda v: not bool(v),
    "attention.max_alibi_bias": lambda v: not float(v or 0.0),
}
_OPTIONS_ITEM = "ROADMAP queue 1 item 8: the llama-block options of other families"


def _is_per_layer(v) -> bool:
    return isinstance(v, (list, tuple)) or getattr(v, "ndim", 0) == 1


def _refuse_unported(kv):
    """Raise NotImplementedError for metadata that would make zllm compute
    another model than the port's forward does."""
    for key, is_default in _UNPORTED_OPTIONS.items():
        val = kv(key)
        if val is not None and not is_default(val):
            raise NotImplementedError(f"{key}={val!r} is not in zllm_torch yet ({_OPTIONS_ITEM})")
    # zllm takes attention.output_scale as the score scale when neither
    # query_pre_attn_scalar nor attention.scale sets one
    out_scale = kv("attention.output_scale")
    if (float(out_scale or 0.0) and not float(kv("attention.scale", 0.0) or 0.0)
            and not kv("attention.query_pre_attn_scalar")):
        raise NotImplementedError(f"attention.output_scale={out_scale!r} is not in zllm_torch "
                                  f"yet ({_OPTIONS_ITEM})")
    for key in ("attention.head_count", "attention.head_count_kv", "feed_forward_length"):
        if _is_per_layer(kv(key)):
            raise NotImplementedError(f"per-layer {key} is not in zllm_torch yet "
                                      f"({_OPTIONS_ITEM})")


@dataclass(frozen=True)
class MoeConfig:
    """The expert keys zllm's `MoeConfig` resolves (its field names and
    defaults); `moe_config` refuses the values the port's `moe_ffn` does
    not apply."""

    n_experts: int
    n_experts_used: int
    n_ff_exp: int
    n_shared_experts: int = 0
    gate_func: str = "softmax"  # softmax | sigmoid (| softmax_weight: refused)
    norm_topk_prob: bool = True
    scale: float = 1.0  # the routed experts' weight scale
    n_dense_lead: int = 0
    n_expert_groups: int = 1
    n_group_used: int = 1
    router_softcap: float = 0.0
    group_experts: int = 0
    group_scale: float = 0.0
    n_ff_chexp: int = 0


def moe_config(arch: str, kv) -> MoeConfig | None:
    """The file's MoeConfig (None without `expert_count`), resolved as
    zllm's from_gguf resolves it; NotImplementedError naming ROADMAP queue 1
    item 8 for experts on an architecture the port runs densely and for
    the routing options its `moe_ffn` does not apply."""
    n_experts = int(kv("expert_count", 0) or 0)
    if n_experts <= 0:
        return None
    if arch not in MOE_ARCHES:
        raise NotImplementedError(f"experts on {arch} are not in zllm_torch yet ({_MOE_ITEM}: "
                                  f"the port runs experts on {', '.join(MOE_ARCHES)})")
    moe = MoeConfig(
        n_experts=n_experts,
        n_experts_used=int(kv("expert_used_count", 2)),
        n_ff_exp=int(kv("expert_feed_forward_length", kv("feed_forward_length"))),
        n_shared_experts=int(kv("expert_shared_count", 0)),
        gate_func={1: "softmax", 2: "sigmoid", 3: "softmax_weight"}.get(
            int(kv("expert_gating_func", 1)), "softmax"),
        norm_topk_prob=bool(kv("expert_weights_norm", kv("norm_topk_prob", MOE_ARCHES[arch]))),
        scale=float(kv("expert_weights_scale", 1.0)),
        n_dense_lead=int(kv("leading_dense_block_count", 0)),
        router_softcap=float(kv("router_logit_softcapping", 0.0)),
        n_expert_groups=int(kv("expert_group_count", 1) or 1),
        n_group_used=int(kv("expert_group_used_count", 1) or 1),
        group_experts=int(kv("experts_per_group", 0) or 0),
        group_scale=float(kv("expert_group_scale", 0.0) or 0.0),
        n_ff_chexp=int(kv("expert_chunk_feed_forward_length", 0) or 0),
    )
    unported = {"expert_gating_func=3 (softmax_weight, gpt-oss)": moe.gate_func == "softmax_weight",
                f"expert_group_count={moe.n_expert_groups}": moe.n_expert_groups > 1,
                f"router_logit_softcapping={moe.router_softcap}": moe.router_softcap > 0,
                f"leading_dense_block_count={moe.n_dense_lead}": moe.n_dense_lead > 0,
                f"experts_per_group={moe.group_experts}": moe.group_experts > 0}
    for what, refused in unported.items():
        if refused:
            raise NotImplementedError(f"{what} is not in zllm_torch yet ({_MOE_ITEM})")
    return moe


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    n_layers: int
    n_embd: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_ff: int
    vocab_size: int
    ctx_len: int = 4096
    norm_eps: float = 1e-5
    rope: RopeParams = field(default_factory=lambda: RopeParams(dim=0))
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    logit_scale: float = 1.0
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim); 1/sqrt(query_pre_attn_scalar)
    # the rope of the windowed layers (gemma3: rope.freq_base_swa, unscaled)
    rope_swa: RopeParams | None = None
    sliding_window: int = 0
    swa_pattern: int = 1
    # the FFN's activation (`ACTS`): "silu" (SwiGLU), "gelu" (tanh-approximate:
    # Gemma's geglu, StarCoder2's MLP) or "gelu_exact" (GPT-NeoX's MLP)
    act: str = "silu"
    # the blocks' norms: "rms" or "layer" (LayerNorm, `LAYER_NORM_ARCHES`)
    norm_kind: str = "rms"
    # "separate": attention and FFN both read the layer's input, each
    # through its own norm, and add into one residual (use_parallel_residual,
    # zllm's "separate"); "none": one after the other
    parallel_residual: str = "none"
    # the file has no output.weight: the head is the token embedding (set
    # by the loader)
    tie_embedding: bool = False
    # the arch's q/k/v projections carry biases (zllm: qwen2)
    qkv_bias: bool = False
    # True once loader.rope_to_neox has permuted wq/wk into the half-split
    # rope basis
    neox_permuted: bool = False
    # the experts (`moe_ffn` runs a layer's FFN through them where the layer
    # has a router, ffn_gate_inp), None for a dense model
    moe: MoeConfig | None = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_swa_layer(self, il: int) -> bool:
        return self.sliding_window > 0 and (il + 1) % self.swa_pattern != 0

    def layer_window(self, il: int) -> int:
        """Layer il's sliding window, 0 for none (what zllm's forward passes
        every kernel of the layer)."""
        return self.sliding_window if self.is_swa_layer(il) else 0

    def layer_rope(self, il: int) -> RopeParams:
        """Layer il's rope: `rope_swa` on a windowed layer when the file sets
        one, else `rope`."""
        return self.rope_swa if self.layer_window(il) and self.rope_swa is not None else self.rope

    @classmethod
    def from_gguf(cls, f: GGUFFile) -> "ModelConfig":
        arch = f.architecture
        if arch not in SUPPORTED_ARCHES:
            raise NotImplementedError(f"zllm_torch runs {SUPPORTED_ARCHES}, not {arch!r}")

        def kv(suffix: str, default=None):
            return f.metadata.get(f"{arch}.{suffix}", default)

        _refuse_unported(kv)
        parallel = bool(kv("use_parallel_residual", False))
        if parallel and arch == "olmo2":
            raise NotImplementedError(f"use_parallel_residual={parallel!r} on olmo2 is not in "
                                      f"zllm_torch yet ({_OPTIONS_ITEM}: the port runs OLMo-2's "
                                      "own block)")
        n_heads = int(kv("attention.head_count", 1) or 1)
        n_embd = int(kv("embedding_length"))
        head_dim = int(kv("attention.key_length", n_embd // n_heads) or 1)
        vocab = f.kv("tokenizer.ggml.tokens")
        vocab_size = int(kv("vocab_size", len(vocab) if vocab is not None else 0))

        rope_dim = int(kv("rope.dimension_count", head_dim))
        scaling_raw = kv("rope.scaling.type", "none")
        if isinstance(scaling_raw, (int, float)):
            scaling = _ROPE_SCALING_NAMES.get(int(scaling_raw), "none")
        else:
            scaling = str(scaling_raw)
        scale_factor = float(kv("rope.scaling.factor", 1.0))
        if scaling in ("none", "linear") and kv("rope.scaling.low_freq_factor") is not None:
            scaling = "llama3"
        rope = RopeParams(
            dim=rope_dim,
            base=float(kv("rope.freq_base", 10000.0)),
            # llama GGUFs are permuted for adjacent-pair rope
            style="neox" if arch in NEOX_ROPE_ARCHES else "norm",
            scaling=scaling if scale_factor != 1.0 or scaling == "llama3" else "none",
            scale_factor=scale_factor,
            orig_ctx=int(kv("rope.scaling.original_context_length", kv("context_length", 4096))),
            low_freq_factor=float(kv("rope.scaling.low_freq_factor", 1.0)),
            high_freq_factor=float(kv("rope.scaling.high_freq_factor", 4.0)),
            attn_factor=float(kv("rope.scaling.attn_factor", 1.0)),
        )
        if scaling == "longrope":
            raise NotImplementedError("longrope rope scaling is not in zllm_torch yet (ROADMAP "
                                      "queue 3)")
        moe = moe_config(arch, kv)
        window = int(kv("attention.sliding_window", 0) or 0)
        swa_pattern = SWA_PATTERN.get(arch, 1)
        if window > 0 and swa_pattern == 1:
            # zllm's forward windows no layer of these arches (swa_pattern 1),
            # but the released model a file with a window comes from attends
            # through it: refused rather than run without it
            raise NotImplementedError(f"sliding-window attention on {arch} is not in zllm_torch "
                                      "yet (ROADMAP queue 3: zllm windows no layer of it)")
        rope_swa = None
        fb_swa = kv("rope.freq_base_swa")
        if fb_swa is not None and window > 0:
            # the windowed layers: plain rope at their own base (the scaling
            # applies to the full layers only)
            rope_swa = rope._replace(base=float(fb_swa), scaling="none", scale_factor=1.0)
        qpas = kv("attention.query_pre_attn_scalar")
        return cls(
            arch=arch,
            n_layers=int(kv("block_count")),
            n_embd=n_embd,
            n_heads=n_heads,
            n_kv_heads=int(kv("attention.head_count_kv", n_heads)),
            head_dim=head_dim,
            n_ff=int(kv("feed_forward_length", 0) or 0),
            vocab_size=vocab_size,
            ctx_len=int(kv("context_length", 4096)),
            norm_eps=float(
                kv("attention.layer_norm_rms_epsilon", kv("attention.layer_norm_epsilon", 1e-5))
            ),
            rope=rope,
            attn_logit_softcap=float(kv("attn_logit_softcapping", 0.0)),
            final_logit_softcap=float(kv("final_logit_softcapping", 0.0)),
            logit_scale=float(kv("logit_scale", 1.0)),
            attn_scale=((1.0 / float(qpas) ** 0.5) if qpas else 0.0)
            or float(kv("attention.scale", 0.0)),
            qkv_bias=arch in ("qwen2", "qwen2moe"),
            moe=moe,
            rope_swa=rope_swa,
            sliding_window=window,
            swa_pattern=swa_pattern,
            act=ACTS.get(arch, "silu"),
            norm_kind="layer" if arch in LAYER_NORM_ARCHES else "rms",
            parallel_residual="separate" if parallel else "none",
        )

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
