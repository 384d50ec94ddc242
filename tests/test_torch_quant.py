"""deft_tpu_torch's int8 KV cache against deft_tpu's, on the CPU.

- kv_store quantises to the same int8 codes and fp32 scales;
- the plain versions of B4 (paged_flatten_attention_q) and B5
  (paged_seq_attention_q), which the wrappers run on the CPU, against
  deft_tpu's Pallas kernels in interpret mode, on the same int8 codes,
  scales and plans;
- the runner's int8 segment rules give plans equal field by field to
  deft_tpu's runner's;
- tree_generate over an int8 cache emits deft_tpu's ids, with equal KV_IO.

Tolerances, relative to the largest output, live rows only (dead rows differ
by convention, deft_tpu tests/test_kernels.py:77-84):
  fp32 2e-5 — the same dequantised values, summation order only;
  bf16 2e-2 — the Pallas kernels round the scaled q and the scaled p to
              bf16, the plain versions dequantise and compute in fp32
              (tests/test_kernels.py's bf16 bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.models.llama import KVPool as JKVPool
from deft_tpu.models.llama import kv_store as j_kv_store
from deft_tpu.ops.flatten_attn import fold_q, unfold_o
from deft_tpu.ops.paged_quant import paged_flatten_attention_q as j_flatten_q
from deft_tpu.ops.paged_seq_attn import paged_seq_attention_q as j_seq_q
from deft_tpu.runtime import ForwardMode as JMode
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.llama import KVPool, kv_store
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.ops import paged_quant as tpq
from deft_tpu_torch.ops import paged_seq_attn as tps
from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan
from deft_tpu_torch.runtime import ForwardMode, ModelRunner, mode_from_cli, tree_generate

Hq, Hkv, D = 8, 2, 64
QPK = Hq // Hkv
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
INT8_FLATTEN = dict(seg_len=(512, 256, 128), waste_limit=(1.1, 1.2, 3.0))
INT8_SEQ = dict(seg_len=(128,), waste_limit=32.0)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


def test_kv_store_codes_and_scales_match():
    """Same x into both packages' quantising kv_store: equal codes, equal
    scales, including a row of zeros (scale clamps at 1e-8), exact
    half-way ties (round half to even) and duplicate DUMP_SLOT rows."""
    rng = np.random.default_rng(0)
    L, S, n = 2, 64, 9
    x = rng.standard_normal((n, Hkv, D)).astype(np.float32) * 3
    x[2] = 0.0
    x[3, 0, :4] = [127.0, 63.5, -0.5, 2.5]  # scale 1: ties at .5
    x[3, 0, 4:] = 0.0
    loc = np.array([5, 9, 0, 17, 33, 40, 0, 62, 1], np.int32)
    jk = JKVPool(jnp.zeros((L, S, Hkv * D), jnp.int8),
                 jnp.ones((L, Hkv, S), jnp.float32))
    jk = j_kv_store(jk, 1, jnp.asarray(loc), jnp.asarray(x))
    tk = KVPool(torch.zeros((L, S, Hkv * D), dtype=torch.int8),
                torch.ones((L, Hkv, S)))
    kv_store(tk, 1, torch.from_numpy(loc).long(), torch.from_numpy(x))
    # slot 0 takes two rows: either may land last, so it is left out
    slots = np.setdiff1d(np.arange(S), [0])
    np.testing.assert_array_equal(tk.data.numpy()[:, slots],
                                  np.asarray(jk.data)[:, slots])
    np.testing.assert_array_equal(tk.scale.numpy()[:, :, slots],
                                  np.asarray(jk.scale)[:, :, slots])
    assert tk.data.dtype == torch.int8 and tk.data[1, 17, :4].tolist() == [127, 64, 0, 2]
    assert tk.scale[1, :, 9].tolist() == np.asarray(jk.scale)[1, :, 9].tolist()


def grown_tree(rng, prompt_len, width, steps, pool=8192):
    tree = TreeCache(TokenKVPool(pool), ReqToTokenPool(64, prompt_len + steps + 64))
    tree.init_prompt(rng.integers(4, 400, prompt_len).tolist())
    for i, c in enumerate(tree.branch(tree.root, width)):
        c.append_token(50 + i)
    for _ in range(steps):
        tree.alloc()
        for leaf in list(tree.leaves.values()):
            leaf.append_token(int(rng.integers(1, 400)))
    tree.alloc()
    return tree


def int8_inputs(rng, tree, l_pad, dt):
    """Random int8 codes and scales as deft_tpu tests/test_kernels.py:348-352
    makes them, and a random q."""
    S = tree.token_to_kv_pool.size
    kd = rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8)
    vd = rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (1, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (1, Hkv, S)).astype(np.float32)
    q = rng.standard_normal((l_pad, Hq, D)).astype(np.float32)
    jdt, tdt, _ = DTYPES[dt]
    jx = [jnp.asarray(q, jdt)] + [jnp.asarray(a) for a in (kd, vd, ks, vs)]
    tx = [torch.from_numpy(q).to(tdt)] + [torch.from_numpy(a) for a in (kd, vd, ks, vs)]
    return jx, tx


@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_flatten_q_plain_vs_pallas(dt):
    """B4 on a tree with FULL prefix blocks, few-leaf suffix blocks and a
    dead bucket tail, under the int8 segment rules."""
    rng = np.random.default_rng(5)
    tree = grown_tree(rng, 700, 6, 30)
    plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=256,
                              min_token_bucket=1024, **INT8_FLATTEN)
    assert plan.paged and plan.seg_len in (256, 128)
    full = plan.blk_lo < -(1 << 20)
    assert full.any() and (~full & (plan.blk_lo >= plan.blk_hi)).any()
    (jq, jk, jv, jks, jvs), (tq, tk, tv, tks, tvs) = int8_inputs(rng, tree, plan.l_pad, dt)
    scale = D ** -0.5
    want = unfold_o(j_flatten_q(
        fold_q(jq, Hkv), jk, jv, jks, jvs, jnp.asarray(0, jnp.int32),
        jnp.asarray(plan.seg_src), jnp.asarray(plan.tok_lo),
        jnp.asarray(plan.tok_hi), jnp.asarray(plan.blk_lo),
        jnp.asarray(plan.blk_hi), scale=scale, qpk=QPK,
        block_len=plan.block_len, seg_len=plan.seg_len), plan.l_pad)
    arr = [torch.from_numpy(a) for a in (plan.seg_src, plan.tok_lo, plan.tok_hi,
                                         plan.blk_lo, plan.blk_hi)]
    got = tpq.paged_flatten_attention_q(tq, tk, tv, tks, tvs, 0, *arr, scale,
                                        plan.block_len, plan.seg_len)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_seq_q_plain_vs_pallas(dt):
    """B5 on per-leaf paths under the int8 seq rule (128-token segments)."""
    rng = np.random.default_rng(6)
    tree = grown_tree(rng, 300, 5, 20)
    plan = build_seq_plan(tree, q_per_kv=QPK, block_len=256,
                          min_token_bucket=256, **INT8_SEQ)
    assert plan.paged and plan.seg_len == 128
    (jq, jk, jv, jks, jvs), (tq, tk, tv, tks, tvs) = int8_inputs(rng, tree, plan.l_pad, dt)
    R = plan.l_pad
    scale = D ** -0.5
    block_len = plan.c_pad // (len(plan.blk_live) // R)
    want = j_seq_q(jq.reshape(R, Hkv, QPK, D), jk, jv, jks, jvs,
                   jnp.asarray(0, jnp.int32), jnp.asarray(plan.seg_src),
                   jnp.asarray(plan.seg_off), jnp.asarray(plan.seg_live),
                   jnp.asarray(plan.blk_live), scale=scale, block_len=block_len,
                   seg_len=plan.seg_len).reshape(R, Hq, D)
    arr = [torch.from_numpy(a) for a in (plan.seg_src, plan.seg_off,
                                         plan.seg_live, plan.blk_live)]
    got = tps.paged_seq_attention_q(tq, tk, tv, tks, tvs, 0, *arr, scale,
                                    plan.seg_len)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]


ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=1200,
            min_token_bucket=128, dtype="float32", kv_dtype="int8")


@pytest.mark.parametrize("prompt_len", [16, 300, 1000])
def test_int8_plans_match_deft_tpu_runner(prompt_len):
    """Both runners' build_plan over the same tree, int8 pools: equal plans
    field by field.  Each plan is the first its runner builds (bucket
    floors at 0), so the comparison holds the segment rules alone."""
    rng = np.random.default_rng(prompt_len)
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="pallas", seed=0)
    tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu")
    prompt = rng.integers(4, 500, prompt_len).tolist()
    for r in (jr, tr):
        r.tree.init_prompt(prompt)
        for i, c in enumerate(r.tree.branch(r.tree.root, 20)):
            c.append_token(10 + i)
    for step in range(12):
        for r in (jr, tr):
            r.tree.alloc()
        if step % 4 == 3:
            for jm, tm in ((JMode.TREE_DECODE_FLATTEN, ForwardMode.TREE_DECODE_FLATTEN),
                           (JMode.DECODE, ForwardMode.DECODE)):
                jr._bucket_floors.clear()
                jp, tp = jr.build_plan(jm), tr.build_plan(tm)
                assert jp.paged == tp.paged and jp.seg_len == tp.seg_len
                for f, x in vars(jp).items():
                    y = getattr(tp, f)
                    if isinstance(x, np.ndarray):
                        np.testing.assert_array_equal(x, y, err_msg=f)
                    else:
                        assert x == y, f
        tok = rng.integers(1, 500, 32)
        for r in (jr, tr):
            for i, leaf in enumerate(sorted(r.tree.leaves.values(), key=lambda n: n.id)):
                leaf.append_token(int(tok[i]))


@pytest.fixture(scope="module")
def int8_reference():
    """deft_tpu's int8-KV generations (its CPU XLA attention) and weights."""
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla", seed=0)
    prompt = list(np.random.default_rng(0).integers(4, 500, 300))
    out = {}
    for mode in ("flatten", "seq"):
        jr.reset_state()
        pm = j_tree_generate(jr, j_mode(mode), None, prompt, max_seq_len=312,
                             width=3, depth=1,
                             branch_controller=JController(jworkloads.simple_tree))
        out[mode] = ([tuple(s.token_ids) for s in jr.tree.all_finished_seqs], pm)
    return jr.params, prompt, out


@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_int8_tree_generate_matches_deft_tpu(int8_reference, mode):
    jparams, prompt, ref = int8_reference
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               PRESETS["tiny"], "cpu", torch.float32)
    runner = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                         params=params)
    assert runner.k_pool.quantized and runner.k_pool.data.dtype == torch.int8
    pm = tree_generate(runner, mode_from_cli(mode), None, prompt, max_seq_len=312,
                       width=3, depth=1,
                       branch_controller=Branch_Controller(workloads.simple_tree))
    got = [tuple(s.token_ids) for s in runner.tree.all_finished_seqs]
    want, jpm = ref[mode]
    assert len(got) == 3 and got == want
    assert pm.KV_IO == jpm.KV_IO and pm.Mask_IO == jpm.Mask_IO
    assert pm.KV_IO > 0
