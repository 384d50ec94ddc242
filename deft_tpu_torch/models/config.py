"""Port of deft_tpu/models/config.py:13,149 (LlamaConfig, PRESETS): a copy, with the same
behaviour, owned by deft_tpu_torch.

Model configuration (parity: DeFT's deft/model_config.py:16-58
+ hf_transformers_utils context-length inference :54-66), Llama family."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_q_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    # Qwen2-family attention: q/k/v projections carry biases (transformers
    # modeling_qwen2.Qwen2Attention hardcodes bias=True for qkv, False for o)
    qkv_bias: bool = False
    # Qwen3-family attention: per-head RMSNorm on q and k after projection,
    # before RoPE (transformers modeling_qwen3.Qwen3Attention q_norm/k_norm)
    qk_norm: bool = False
    # MLP activation: "silu" (Llama/Mistral/Qwen) or "gelu_pytorch_tanh" /
    # "gelu" (Gemma-family GeGLU)
    hidden_act: str = "silu"
    # Gemma-family: embeddings scaled by sqrt(hidden_size) at input, and
    # RMSNorm computes x_norm * (1 + w) in fp32 before the output cast
    # (transformers modeling_gemma GemmaModel.forward / GemmaRMSNorm)
    gemma_norm: bool = False
    # Mixtral-family sparse MoE: num_experts > 0 replaces the dense MLP with
    # a top-k routed expert mixture (transformers MixtralSparseMoeBlock)
    num_experts: int = 0
    experts_per_tok: int = 2

    @property
    def q_per_kv(self) -> int:
        assert self.num_q_heads % self.num_kv_heads == 0
        return self.num_q_heads // self.num_kv_heads

    @property
    def context_len(self) -> int:
        """Max context, honoring rope factor like the reference
        (hf_transformers_utils.py:54-66)."""
        ctx = self.max_position_embeddings
        if self.rope_scaling and "factor" in self.rope_scaling:
            rtype = self.rope_scaling.get(
                "rope_type", self.rope_scaling.get("type", "")
            )
            # llama3/yarn/longrope configs already carry the scaled max
            if rtype not in ("llama3", "yarn", "longrope"):
                ctx = int(ctx * self.rope_scaling["factor"])
        return ctx

    @staticmethod
    def from_hf_config(cfg: Dict[str, Any]) -> "LlamaConfig":
        hidden = cfg["hidden_size"]
        n_q = cfg["num_attention_heads"]
        archs = cfg.get("architectures") or []
        max_pos = cfg.get("max_position_embeddings", 4096)
        if cfg.get("use_sliding_window"):
            # Qwen2-style opt-in flag
            raise NotImplementedError(
                "sliding-window attention is not supported (tree attention "
                "over full shared prefixes is the point of this engine)"
            )
        win = cfg.get("sliding_window")
        if (win and win < max_pos
                and "use_sliding_window" not in cfg):
            # ANY family carrying an active window (Mistral v0.1, Phi-3
            # 4k, ...): loading it would silently compute full attention
            # where the trained model masks.  A window >= max positions
            # (Phi-3 128k ships 262144) never masks — allowed.  Families
            # with the opt-in flag present (Qwen2) are governed by it alone.
            raise NotImplementedError(
                f"checkpoint has an active sliding_window={win} < "
                f"max_position_embeddings={max_pos}; windowless (null) "
                "configs load fine"
            )
        if any(("Gemma2" in a or "Gemma3" in a) for a in archs):
            raise NotImplementedError(
                "Gemma2/Gemma3 are not supported (logit softcapping and "
                "alternating sliding-window layers); Gemma-1 loads fine"
            )
        is_gemma = any("Gemma" in a for a in archs)
        # Activation key precedence matches live transformers (4.57):
        # GemmaMLP reads config.hidden_act ONLY (hidden_activation is a
        # dead legacy key there), so hidden_act wins when both are present
        hidden_act = (cfg.get("hidden_act") or
                      cfg.get("hidden_activation") or "silu")
        rope_scaling = cfg.get("rope_scaling")
        if rope_scaling and cfg.get("original_max_position_embeddings"):
            # Phi-3 keeps the pre-scaling max at the TOP level of
            # config.json; rope_table reads it from the scaling dict
            rope_scaling = dict(rope_scaling)
            rope_scaling.setdefault(
                "original_max_position_embeddings",
                cfg["original_max_position_embeddings"],
            )
        if float(cfg.get("partial_rotary_factor", 1.0)) != 1.0:
            raise NotImplementedError("partial rotary embeddings")
        return LlamaConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=hidden,
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_q_heads=n_q,
            num_kv_heads=cfg.get("num_key_value_heads", n_q),
            # `or`: some configs (Mixtral) carry an explicit null head_dim
            head_dim=cfg.get("head_dim") or hidden // n_q,
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            max_position_embeddings=max_pos,
            # Gemma always ties lm_head to the embedding (its checkpoints
            # carry no lm_head.weight even when config.json omits the flag)
            tie_word_embeddings=cfg.get("tie_word_embeddings", is_gemma),
            # Llama-family configs carry an explicit attention_bias flag;
            # Qwen2 configs carry none (bias is hardcoded in the modeling
            # code), so the architecture name decides the default
            qkv_bias=cfg.get(
                "attention_bias", any("Qwen2" in a for a in archs)
            ),
            # Qwen3 hardcodes q_norm/k_norm in the modeling code, no flag
            qk_norm=any("Qwen3" in a for a in archs),
            hidden_act=hidden_act,
            gemma_norm=is_gemma,
            # Mixtral carries num_local_experts/num_experts_per_tok
            num_experts=cfg.get("num_local_experts", 0),
            experts_per_tok=cfg.get("num_experts_per_tok", 2),
        )

    @staticmethod
    def from_pretrained(path: str) -> "LlamaConfig":
        with open(os.path.join(path, "config.json")) as f:
            return LlamaConfig.from_hf_config(json.load(f))


# Random-init presets for tests/benchmarks (no-egress environment: HF weights
# must come from a local path; these mirror real architectures' shapes).
PRESETS: Dict[str, LlamaConfig] = {
    # CPU-testable toy: big enough for GQA + rope paths, tiny vocab.
    "tiny": LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_q_heads=4,
        num_kv_heads=2,
        head_dim=32,
        max_position_embeddings=2048,
    ),
    # TinyLlama-1.1B-Chat shapes.
    "1b": LlamaConfig(
        vocab_size=32000,
        hidden_size=2048,
        intermediate_size=5632,
        num_layers=22,
        num_q_heads=32,
        num_kv_heads=4,
        head_dim=64,
        max_position_embeddings=4096,
    ),
    # Llama-3.1-8B shapes (the reference's headline benchmark model).
    "8b": LlamaConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_q_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3",
            "factor": 8.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
        max_position_embeddings=131072,
    ),
    # Llama-3.2-3B shapes (D=128 GQA; the largest Llama-3-family config
    # whose bf16 weights + KV pools fit a single v5e chip).
    "3b": LlamaConfig(
        vocab_size=128256,
        hidden_size=3072,
        intermediate_size=8192,
        num_layers=28,
        num_q_heads=24,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3",
            "factor": 32.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
        max_position_embeddings=131072,
    ),
    # Llama-2-7B shapes (the reference's default --model; MHA, q_per_kv=1).
    "7b": LlamaConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_layers=32,
        num_q_heads=32,
        num_kv_heads=32,
        head_dim=128,
        max_position_embeddings=4096,
    ),
    # 8B with fewer layers: fits HBM alongside big KV pools for kernels work.
    "8b-8l": LlamaConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=8,
        num_q_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500000.0,
        max_position_embeddings=131072,
    ),
    # Mixtral-8x7B shapes with trimmed layers: the full 32-layer expert
    # stack is ~47 GB int8 (32 GB HBM short on a v5e); 6 layers keep every
    # per-layer cost realistic (router, 8 experts x (4096, 14336) matmuls,
    # top-2 routing) while fitting int8 weights + KV pools on one chip.
    "mixtral-6l": LlamaConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=6,
        num_q_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1e6,
        max_position_embeddings=32768,
        num_experts=8,
        experts_per_tok=2,
    ),
}
