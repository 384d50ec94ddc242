"""The port's top-k keeps deft_tpu's tie order: tied probabilities come out
lowest index first, as ``jax.lax.top_k`` gives them (deft_tpu
runtime/runner.py:733-744), which ``torch.topk`` does not promise.

Rows are Llama-3's vocabulary wide (128256) and bf16-valued, with ties
forced inside the top-K and across its K-th place; both packages see the
same numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.runtime import ModelRunner
from deft_tpu_torch.runtime.runner import topk_lowest_index

V, K = 128256, 64


def tied_rows(seed: int, rows: int = 6) -> np.ndarray:
    """bf16-valued fp32 rows: the row's largest value copied to three more
    places, and the K-th largest to the places ranked K-3 .. K+3, so that
    ties sit at the top, inside the top-K and across its K-th place."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, V)).astype(np.float32) * 3)
    x = x.to(torch.bfloat16).float().numpy()
    for r in range(rows):
        order = np.argsort(-x[r], kind="stable")
        x[r, rng.choice(V, 3, replace=False)] = x[r, order[0]]
        order = np.argsort(-x[r], kind="stable")
        x[r, order[K - 4:K + 3]] = x[r, order[K - 1]]
        x[r, rng.choice(V, 2, replace=False)] = x[r, order[K - 1]]
    return x


def ties(vals: np.ndarray) -> int:
    return int((vals[:, 1:] == vals[:, :-1]).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_ties_lowest_index_first_like_jax(seed):
    x = tied_rows(seed)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), K)
    got_v, got_i = topk_lowest_index(torch.from_numpy(x), K)
    assert ties(np.asarray(want_v)) >= 6 * 8  # the forced ties are in the top-K
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_logits_view_tie_order_matches_deft_tpu():
    """The runner's top-K view over bf16-valued logits with ties: softmax +
    1e-6, then the top-K, ids as deft_tpu's and probabilities within fp32
    rounding."""
    runner = ModelRunner(PRESETS["tiny"], EngineConfig(kv_pool_slots=4096,
                                                       dtype="float32"),
                         device="cpu")
    logits = tied_rows(2, rows=3)
    view = runner._logits_view(torch.from_numpy(logits), "topk")
    want_v, want_i = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1) + 1e-6,
                                   runner.topk_k)
    np.testing.assert_array_equal(view.ids, np.asarray(want_i))
    np.testing.assert_allclose(view.vals, np.asarray(want_v), rtol=1e-5)
    greedy = runner._logits_view(torch.from_numpy(logits), "greedy")
    np.testing.assert_array_equal(greedy.ids[:, 0], np.asarray(want_i)[:, 0])
