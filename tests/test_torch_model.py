"""deft_tpu_torch's tiny Llama against deft_tpu's, on the CPU in fp32.

Both packages get the same weights: deft_tpu's runner draws its numpy random
stream, and the port takes those arrays through params_from_numpy.  deft_tpu
runs its Pallas kernels (interpret mode); the port runs the plain versions
its kernel wrappers use on the CPU.  Logits are compared relative to the
largest logit at 1e-4: fp32 throughout, the two differ only in summation
order (matmul blocking, online vs dense softmax) over two layers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.models.loader import random_params as j_random_params
from deft_tpu.models.rope import apply_rope as j_apply_rope
from deft_tpu.models.rope import rope_table as j_rope_table
from deft_tpu.runtime import ForwardMode as JMode
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import (fuse_host, numpy_random_params,
                                          params_from_numpy, random_params)
from deft_tpu_torch.models.rope import apply_rope, rope_table
from deft_tpu_torch.runtime import ForwardMode, ModelRunner

ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(np.random.default_rng(0).integers(4, 500, 300))
TOL = 1e-4


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


def make_runners():
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="pallas",
                 seed=0, retain_full_logits=True)
    params = params_from_numpy({k: np.asarray(v) for k, v in jr.params.items()},
                               PRESETS["tiny"], "cpu", torch.float32)
    tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                     params=params, retain_full_logits=True)
    return jr, tr


@pytest.mark.parametrize("modes", [
    (JMode.TREE_DECODE_FLATTEN, ForwardMode.TREE_DECODE_FLATTEN),
    (JMode.DECODE, ForwardMode.DECODE),
])
def test_prefill_and_decode_logits_match(modes):
    jmode, tmode = modes
    jr, tr = make_runners()
    jv = jr.forward_prefill(PROMPT)
    tv = tr.forward_prefill(PROMPT)
    assert rel_err(tv.full_logits().numpy(), np.asarray(jv._full)) < TOL
    _, ids = jv.topk(0, 3)
    for r in (jr, tr):
        for c, child in enumerate(r.tree.branch(r.tree.root, 3)):
            child.append_token(int(ids[c]))
    for step in range(3):
        for r in (jr, tr):
            r.tree.alloc()
        jplan, tplan = jr.build_plan(jmode), tr.build_plan(tmode)
        assert tplan.paged and jplan.paged
        jv, _ = jr.forward_tree_decode(jmode, jplan)
        tv, _ = tr.forward_tree_decode(tmode, tplan)
        n = tplan.n_leaves
        err = rel_err(tv.full_logits().numpy()[:n], np.asarray(jv._full)[:n])
        assert err < TOL, (step, err)
        nxt, _ = jv.argmax()
        for r in (jr, tr):
            for leaf in r.tree.leaves.values():
                leaf.append_token(int(nxt[r.tree.leaf_to_q[leaf.id]]))


def test_numpy_stream_matches_deft_tpu():
    """The port's numpy random stream is deft_tpu's CPU stream, array for
    array (unfused), and so are the fused port parameters."""
    cfg = PRESETS["tiny"]
    ours = numpy_random_params(cfg, seed=3)
    theirs = j_random_params(JPRESETS["tiny"], 3, jnp.float32, on_device=False)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    p = random_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    fused = j_random_params(JPRESETS["tiny"], 3, jnp.float32, on_device=False,
                            fuse=True)
    assert set(p) == set(fused)
    for k in p:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(fused[k]), err_msg=k)


def test_params_from_numpy_fused_and_unfused_round_trip():
    cfg = PRESETS["tiny"]
    unfused = numpy_random_params(cfg, seed=1)
    a = params_from_numpy(unfused, cfg, "cpu", torch.float32)
    b = params_from_numpy(fuse_host(unfused), cfg, "cpu", torch.float32)
    assert set(a) == set(b) == {"embed", "ln1", "wqkv", "wo", "ln2", "wgu",
                                "wdown", "ln_f", "lm_head"}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # splitting the fused tensors back gives the unfused arrays
    nq = cfg.num_q_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    wqkv = a["wqkv"].numpy()
    np.testing.assert_array_equal(wqkv[..., :nq], unfused["wq"])
    np.testing.assert_array_equal(wqkv[..., nq:nq + nkv], unfused["wk"])
    np.testing.assert_array_equal(wqkv[..., nq + nkv:], unfused["wv"])
    I = cfg.intermediate_size
    np.testing.assert_array_equal(a["wgu"].numpy()[..., :I], unfused["wg"])
    np.testing.assert_array_equal(a["wgu"].numpy()[..., I:], unfused["wu"])
    bf = params_from_numpy(unfused, cfg, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bf.values())
    with pytest.raises(ValueError):
        bad = dict(unfused)
        bad["wo"] = bad["wo"][:, :-1]
        params_from_numpy(bad, cfg, "cpu", torch.float32)


@pytest.mark.parametrize("preset", ["tiny", "8b"])
def test_rope_matches(preset):
    cfg = PRESETS[preset]
    args = (cfg.head_dim, 512, cfg.rope_theta, cfg.rope_scaling)
    ours, theirs = rope_table(*args), np.asarray(j_rope_table(*args))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 3, cfg.head_dim)).astype(np.float32)
    pos = rng.integers(0, 512, 7).astype(np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     torch.from_numpy(ours))
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(theirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
