"""Model hyper-parameters resolved from GGUF metadata: the fields the
llama path reads (counterpart of `zllm/models/config.py::ModelConfig`,
whose `from_gguf` resolves the same keys the same way for plain llama)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..gguf.reader import GGUFFile
from ..ops.layers import RopeParams

_ROPE_SCALING_NAMES = {0: "none", 1: "linear", 2: "yarn", 3: "longrope"}

# architectures whose graph is the plain llama block this port runs
SUPPORTED_ARCHES = ("llama",)


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
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)
    # True once loader.rope_to_neox has permuted wq/wk into the half-split
    # rope basis
    neox_permuted: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @classmethod
    def from_gguf(cls, f: GGUFFile) -> "ModelConfig":
        arch = f.architecture
        if arch not in SUPPORTED_ARCHES:
            raise NotImplementedError(f"zllm_torch runs {SUPPORTED_ARCHES}, not {arch!r}")

        def kv(suffix: str, default=None):
            return f.metadata.get(f"{arch}.{suffix}", default)

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
            style="norm",  # llama GGUFs are permuted for adjacent-pair rope
            scaling=scaling if scale_factor != 1.0 or scaling == "llama3" else "none",
            scale_factor=scale_factor,
            orig_ctx=int(kv("rope.scaling.original_context_length", kv("context_length", 4096))),
            low_freq_factor=float(kv("rope.scaling.low_freq_factor", 1.0)),
            high_freq_factor=float(kv("rope.scaling.high_freq_factor", 4.0)),
            attn_factor=float(kv("rope.scaling.attn_factor", 1.0)),
        )
        if scaling == "longrope" or int(kv("expert_count", 0)) > 0:
            raise NotImplementedError("longrope and MoE llama are not in zllm_torch yet")
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
            attn_scale=float(kv("attention.scale", 0.0)),
        )

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
