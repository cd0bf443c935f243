"""Model geometry registry (Llama-3-class decoder-only transformers).

The port's own copy of ``distributed_gpu_inference_tpu/models/configs.py``:
the same ``ModelConfig`` fields and the same registry entries, so a model
name means the same geometry in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    head_dim: Optional[int] = None           # default hidden_size // num_heads
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False             # Qwen2-style QKV biases
    sliding_window: Optional[int] = None     # Mistral-style windowed attention
    # Gemma-family knobs
    activation: str = "silu"                 # silu | gelu (GeGLU MLP)
    scale_embeddings: bool = False           # hidden *= sqrt(hidden_size)
    norm_offset: bool = False                # RMSNorm uses (1 + weight)
    final_logit_softcap: Optional[float] = None  # cap*tanh(logits/cap)
    # MoE (Mixtral-style sparse MLP); 0 experts = dense
    num_experts: int = 0
    num_experts_per_tok: int = 2
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_heads)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads (GQA)")
        if self.activation not in ("silu", "gelu"):
            raise ValueError(
                f"unknown activation {self.activation!r}; use 'silu' or 'gelu'"
            )
        if self.num_experts and self.num_experts_per_tok > self.num_experts:
            raise ValueError("num_experts_per_tok exceeds num_experts")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def num_params(self) -> int:
        """Approximate parameter count (embeddings + layers + head)."""
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        d = self.head_dim
        attn = h * (self.num_heads * d) + 2 * h * (self.num_kv_heads * d) + (
            self.num_heads * d
        ) * h
        if self.num_experts:
            mlp = self.num_experts * 3 * h * i + h * self.num_experts
        else:
            mlp = 3 * h * i
        norms = 2 * h
        per_layer = attn + mlp + norms
        emb = v * h
        head = 0 if self.tie_word_embeddings else v * h
        return emb + self.num_layers * per_layer + head + h

    def param_bytes(self, dtype_bytes: int = 2) -> int:
        return self.num_params * dtype_bytes

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim * dtype_bytes


def _llama(name: str, **kw) -> ModelConfig:
    return ModelConfig(name=name, **kw)


MODEL_REGISTRY: Dict[str, ModelConfig] = {
    # test-scale
    "llama3-tiny": _llama(
        "llama3-tiny", vocab_size=512, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, intermediate_size=128,
        max_position_embeddings=1024, rope_theta=10000.0,
    ),
    "llama3-mini": _llama(  # CI-scale but realistic ratios
        "llama3-mini", vocab_size=2048, hidden_size=256, num_layers=4,
        num_heads=8, num_kv_heads=4, intermediate_size=640,
        max_position_embeddings=2048,
    ),
    # Llama 3.2 1B geometry
    "llama3-1b": _llama(
        "llama3-1b", vocab_size=128256, hidden_size=2048, num_layers=16,
        num_heads=32, num_kv_heads=8, intermediate_size=8192,
        head_dim=64, tie_word_embeddings=True,
        max_position_embeddings=131072,
    ),
    # llama3-1b body with a bench-sized vocab
    "llama3-1b-bench": _llama(
        "llama3-1b-bench", vocab_size=8192, hidden_size=2048, num_layers=16,
        num_heads=16, num_kv_heads=8, intermediate_size=8192,
        head_dim=128, tie_word_embeddings=True,
        max_position_embeddings=8192,
    ),
    "llama3-200m-bench": _llama(
        "llama3-200m-bench", vocab_size=8192, hidden_size=1024,
        num_layers=12, num_heads=8, num_kv_heads=4, intermediate_size=4096,
        head_dim=128, tie_word_embeddings=True,
        max_position_embeddings=8192,
    ),
    "llama3-200m-bench-untied": _llama(
        "llama3-200m-bench-untied", vocab_size=8192, hidden_size=1024,
        num_layers=12, num_heads=8, num_kv_heads=4, intermediate_size=4096,
        head_dim=128, tie_word_embeddings=False,
        max_position_embeddings=8192,
    ),
    # Llama 3.2 3B geometry
    "llama3-3b": _llama(
        "llama3-3b", vocab_size=128256, hidden_size=3072, num_layers=28,
        num_heads=24, num_kv_heads=8, intermediate_size=8192,
        head_dim=128, tie_word_embeddings=True,
        max_position_embeddings=131072,
    ),
    # Llama 3 8B geometry
    "llama3-8b": _llama(
        "llama3-8b", vocab_size=128256, hidden_size=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, intermediate_size=14336,
        max_position_embeddings=8192,
    ),
    # Llama 3 70B geometry
    "llama3-70b": _llama(
        "llama3-70b", vocab_size=128256, hidden_size=8192, num_layers=80,
        num_heads=64, num_kv_heads=8, intermediate_size=28672,
        max_position_embeddings=8192,
    ),
    # 70B per-layer width with 8 layers and a cut vocab
    "llama3-70b-micro": _llama(
        "llama3-70b-micro", vocab_size=2048, hidden_size=8192, num_layers=8,
        num_heads=64, num_kv_heads=8, intermediate_size=28672,
        max_position_embeddings=8192,
    ),
    # Qwen2.5 family: the Llama recipe with QKV biases and 1e6 rope theta
    "qwen2.5-tiny": _llama(  # test-scale
        "qwen2.5-tiny", vocab_size=512, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, intermediate_size=128,
        max_position_embeddings=1024, rope_theta=10000.0,
        attention_bias=True, tie_word_embeddings=True,
    ),
    "qwen2.5-0.5b": _llama(
        "qwen2.5-0.5b", vocab_size=151936, hidden_size=896, num_layers=24,
        num_heads=14, num_kv_heads=2, intermediate_size=4864,
        max_position_embeddings=32768, rope_theta=1000000.0,
        rms_norm_eps=1e-6, attention_bias=True, tie_word_embeddings=True,
    ),
    "qwen2.5-7b": _llama(
        "qwen2.5-7b", vocab_size=152064, hidden_size=3584, num_layers=28,
        num_heads=28, num_kv_heads=4, intermediate_size=18944,
        max_position_embeddings=32768, rope_theta=1000000.0,
        rms_norm_eps=1e-6, attention_bias=True,
    ),
    # Mistral family: the Llama recipe + sliding-window attention
    "mistral-tiny": _llama(  # test-scale; window smaller than the test
        "mistral-tiny", vocab_size=512, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, intermediate_size=128,
        max_position_embeddings=1024, rope_theta=10000.0,
        rms_norm_eps=1e-5, sliding_window=8,
    ),
    "mistral-7b": _llama(  # v0.1 geometry: 4096-token sliding window
        "mistral-7b", vocab_size=32000, hidden_size=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, intermediate_size=14336,
        max_position_embeddings=32768, rope_theta=10000.0,
        rms_norm_eps=1e-5, sliding_window=4096,
    ),
    # Gemma family: GeGLU MLP, sqrt(H)-scaled embeddings, (1+w) RMSNorm,
    # tied embeddings, 256-dim heads
    "gemma-tiny": _llama(  # test-scale
        "gemma-tiny", vocab_size=512, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, intermediate_size=256,
        max_position_embeddings=1024, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=True, activation="gelu", scale_embeddings=True,
        norm_offset=True, final_logit_softcap=30.0,
    ),
    "gemma-2b": _llama(  # MQA: one KV head
        "gemma-2b", vocab_size=256000, hidden_size=2048, num_layers=18,
        num_heads=8, num_kv_heads=1, intermediate_size=16384, head_dim=256,
        max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=True, activation="gelu", scale_embeddings=True,
        norm_offset=True,
    ),
    "gemma-7b": _llama(
        "gemma-7b", vocab_size=256000, hidden_size=3072, num_layers=28,
        num_heads=16, num_kv_heads=16, intermediate_size=24576, head_dim=256,
        max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=True, activation="gelu", scale_embeddings=True,
        norm_offset=True,
    ),
    # Mixtral family — sparse MoE MLP (top-2 of E experts); the port's
    # forward raises NotImplementedError on MoE layers in this slice
    "mixtral-tiny": _llama(  # test-scale: 4 experts, top-2
        "mixtral-tiny", vocab_size=512, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, intermediate_size=128,
        max_position_embeddings=1024, rope_theta=10000.0,
        num_experts=4, num_experts_per_tok=2,
    ),
    "mixtral-8x7b": _llama(
        "mixtral-8x7b", vocab_size=32000, hidden_size=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, intermediate_size=14336,
        max_position_embeddings=32768, rope_theta=1000000.0,
        rms_norm_eps=1e-5, num_experts=8, num_experts_per_tok=2,
    ),
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}"
        )
    cfg = MODEL_REGISTRY[name]
    return replace(cfg, **overrides) if overrides else cfg
