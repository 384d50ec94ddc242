"""deft_tpu_torch's rope_table under every scaling deft_tpu implements,
held against deft_tpu's table and against transformers.

- linear, dynamic NTK (with and without an original max in the scaling
  dict), YaRN, DeepSeek-YaRN, Llama-3 and LongRoPE (short and long rows),
  and no scaling: the port's table equals deft_tpu's to 1e-6 (both are
  float64 numpy cast to fp32);
- each one-frequency scaling matches ``transformers.modeling_rope_utils``
  at position 1 (angle and attention factor), and LongRoPE row by row in
  each regime, as tests/test_rope.py checks deft_tpu's;
- an unknown scaling type raises.
"""

import numpy as np
import pytest
import torch
import transformers.modeling_rope_utils as tf_rope

from deft_tpu.models.rope import rope_table as j_rope_table
from deft_tpu_torch.models.rope import rope_table

LONGROPE = {"type": "longrope",
            "short_factor": [1.0 + 0.25 * i for i in range(32)],
            "long_factor": [4.0 + 0.5 * i for i in range(32)],
            "original_max_position_embeddings": 4096}
SCALINGS = {
    "default": None,
    "linear": {"rope_type": "linear", "factor": 4.0},
    "dynamic": {"rope_type": "dynamic", "factor": 4.0,
                "original_max_position_embeddings": 2048},
    "dynamic, config max": {"rope_type": "dynamic", "factor": 2.0},
    "yarn": {"rope_type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 4096},
    "yarn, attention factor": {"rope_type": "yarn", "factor": 8.0, "beta_fast": 16,
                               "attention_factor": 1.3,
                               "original_max_position_embeddings": 2048},
    "deepseek_yarn": {"rope_type": "deepseek_yarn", "factor": 40.0, "mscale": 0.707,
                      "mscale_all_dim": 0.707,
                      "original_max_position_embeddings": 4096},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "longrope": LONGROPE,
}


@pytest.mark.parametrize("name", list(SCALINGS))
@pytest.mark.parametrize("head_dim", [64, 96])
def test_table_equals_deft_tpu(name, head_dim):
    scaling = SCALINGS[name]
    if scaling is LONGROPE:  # a factor for each of the head's frequencies
        half = head_dim // 2
        scaling = dict(LONGROPE, short_factor=[1.0 + 0.25 * i for i in range(half)],
                       long_factor=[4.0 + 0.5 * i for i in range(half)])
    kw = dict(orig_max_pos=16384)
    got = rope_table(head_dim, 8192, 10000.0, scaling, **kw)
    want = np.asarray(j_rope_table(head_dim, 8192, 10000.0, scaling, **kw))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class _Cfg:
    """The config fields transformers' ROPE_INIT_FUNCTIONS read."""

    def __init__(self, head_dim, theta, max_pos, scaling):
        self.head_dim = head_dim
        self.rope_theta = theta
        orig = (scaling or {}).get("original_max_position_embeddings", max_pos)
        self.max_position_embeddings = orig
        self.original_max_position_embeddings = orig
        self.rope_scaling = scaling
        self.hidden_size = head_dim * 8
        self.num_attention_heads = 8
        self.partial_rotary_factor = 1.0

    def get_text_config(self):
        return self


@pytest.mark.parametrize("name", ["default", "linear", "dynamic", "yarn", "llama3"])
def test_scaling_matches_transformers(name):
    scaling = SCALINGS[name]
    head_dim, theta, max_pos = 64, 10000.0, 8192
    fn = tf_rope.ROPE_INIT_FUNCTIONS[name]
    inv_freq, attn = fn(_Cfg(head_dim, theta, max_pos, scaling), device="cpu",
                        seq_len=torch.tensor(max_pos))
    want = np.asarray(inv_freq, dtype=np.float64)
    table = rope_table(head_dim, max_pos, theta, scaling).astype(np.float64)
    half = head_dim // 2
    sin, cos = table[1, half:], table[1, :half]
    want_angle = np.mod(want, 2 * np.pi)
    want_angle = np.where(want_angle > np.pi, want_angle - 2 * np.pi, want_angle)
    np.testing.assert_allclose(np.arctan2(sin, cos), want_angle, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.sqrt(sin ** 2 + cos ** 2), float(attn), rtol=1e-5)


def test_longrope_matches_transformers_per_position():
    """Rows below the original max take the short factors, rows from it on
    the long ones; the attention factor of the config's max ratio scales
    every row (tests/test_rope.py:85)."""
    head_dim, theta, orig = 64, 10000.0, 4096
    cfg = _Cfg(head_dim, theta, orig, LONGROPE)
    cfg.max_position_embeddings = 16384
    fn = tf_rope.ROPE_INIT_FUNCTIONS["longrope"]
    short, attn = fn(cfg, device="cpu", seq_len=orig)
    long, attn_l = fn(cfg, device="cpu", seq_len=orig + 1)
    assert float(attn) == float(attn_l) > 1.0
    table = rope_table(head_dim, orig + 64, theta, LONGROPE,
                       orig_max_pos=16384).astype(np.float64)

    def expect(p, freq):
        ang = p * np.asarray(freq, dtype=np.float64)
        return np.concatenate([np.cos(ang), np.sin(ang)]) * float(attn)

    # fp32 table against fp64 angles near p ~ 4k: the cast's 1e-3
    for p in (1, 100, orig - 1):
        np.testing.assert_allclose(table[p], expect(p, short), rtol=0, atol=1e-3)
    for p in (orig, orig + 63):
        np.testing.assert_allclose(table[p], expect(p, long), rtol=0, atol=1e-3)


def test_unknown_scaling_raises():
    with pytest.raises(NotImplementedError, match="su"):
        rope_table(64, 128, 10000.0, {"rope_type": "su", "factor": 2.0})
