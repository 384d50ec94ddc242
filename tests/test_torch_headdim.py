"""deft_tpu_torch at head_dim 96 (Phi-3-mini) and 256 (Gemma), held against
deft_tpu on the CPU.

At those widths a head's row does not pack into 128 lanes, so deft_tpu
builds seq plans in the gather layout and runs every decode step through
its gather kernels B6 and B7 (runner.py:1262-1295); the port keeps that
gate (runner.packs_heads).

- the plans: with deft_tpu's flags fixed to its Pallas kernels (the
  layout its TPU run would take), the port's flatten and seq plans equal
  deft_tpu's field by field, over fp32 and int8 pools, and neither
  runner takes the paged kernels;
- the plain versions of B3, B8, B6 and B7, which the wrappers run on the
  CPU, against deft_tpu's Pallas AttnFns in interpret mode at the same
  inputs (fp32 2e-5, bf16 2e-2, as tests/test_torch_gather.py bounds
  them; B6 and B7 over pools of q's dtype and over int8 pools);
- tree_generate emits deft_tpu's token ids in flatten and seq mode, over
  fp32 and int8 KV.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.models.llama import KVPool as JKVPool
from deft_tpu.ops.flatten_attn import flatten_attn_pallas as j_flatten
from deft_tpu.ops.prefill import prefill_attn_pallas as j_prefill
from deft_tpu.ops.prefill import ragged_prefill_attn_pallas as j_ragged
from deft_tpu.ops.seq_attn import seq_attn_pallas as j_seq
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.ops import flatten_attn as tfa
from deft_tpu_torch.ops import prefill as tpr
from deft_tpu_torch.ops import seq_attn as tsa
from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate

WIDTHS = [96, 256]
KV = ["inherit", "int8"]
MODES = ["flatten", "seq"]
Hq, Hkv = 4, 2
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = [7 + (i % 97) for i in range(300)]  # segment-aligned flatten plans
WIDTH, MAX_SEQ = 3, 316


def config(D, jax_side=False):
    base = (JPRESETS if jax_side else PRESETS)["tiny"]
    return dataclasses.replace(base, head_dim=D, num_q_heads=Hq, num_kv_heads=Hkv)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


def grow(tree, rng):
    """The prompt, WIDTH leaves, 20 appends, one leaf pruned."""
    tree.init_prompt(PROMPT)
    for i, c in enumerate(tree.branch(tree.root, WIDTH + 1)):
        c.append_token(50 + i)
    for _ in range(20):
        tree.alloc()
        for leaf in sorted(tree.leaves.values(), key=lambda x: x.id):
            leaf.append_token(int(rng.integers(1, 400)))
    tree.cut(sorted(tree.leaves.values(), key=lambda x: x.id)[0])
    tree.alloc()


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", WIDTHS)
def test_plans_equal_deft_tpu(D, mode, kv):
    jr = JRunner(config(D, True), JEngineConfig(**ECFG, kv_dtype=kv), kernels="pallas")
    tr = ModelRunner(config(D), EngineConfig(**ECFG, kv_dtype=kv), device="cpu")
    for runner in (jr, tr):
        grow(runner.tree, np.random.default_rng(0))
    jplan = jr.build_plan(j_mode(mode))
    tplan = tr.build_plan(mode_from_cli(mode))
    assert not jr._use_paged(j_mode(mode), jplan)
    assert not tr._use_paged(tplan, mode_from_cli(mode))
    if mode == "seq":
        assert not jplan.paged and not tplan.paged
    for f in dataclasses.fields(tplan):
        want = getattr(jplan, f.name)
        got = getattr(tplan, f.name)
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=f.name)
        else:
            assert got == want, f.name


def pools(rng, S, D, kv, dt):
    out = []
    for _ in range(2):
        if kv == "int8":
            d = rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8)
            s = rng.uniform(0.01, 0.1, (1, Hkv, S)).astype(np.float32)
            out.append((JKVPool(jnp.asarray(d), jnp.asarray(s)),
                        (torch.from_numpy(d), torch.from_numpy(s))))
        else:
            d = rng.standard_normal((1, S, Hkv * D)).astype(np.float32)
            out.append((JKVPool(jnp.asarray(d, DTYPES[dt][0])),
                        (torch.from_numpy(d).to(DTYPES[dt][1]), None)))
    return out


def qkv(rng, n, D, dt, heads=(Hq, Hkv, Hkv)):
    arrs = [rng.standard_normal((n, h, D)).astype(np.float32) for h in heads]
    return ([jnp.asarray(a, DTYPES[dt][0]) for a in arrs],
            [torch.from_numpy(a).to(DTYPES[dt][1]) for a in arrs])


def grown_tree():
    tree = TreeCache(TokenKVPool(4096), ReqToTokenPool(64, 512))
    grow(tree, np.random.default_rng(1))
    return tree


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", WIDTHS)
def test_prefill_plain_equals_deft_tpu(D, dt):
    """B3 over one prompt, B8 over three joined prompts with a pad tail."""
    rng = np.random.default_rng(2)
    (jq, jk, jv), (tq, tk, tv) = qkv(rng, 200, D, dt)
    scale = D ** -0.5
    want = j_prefill(jq, jk, jv, None, None, 0, None, scale)
    got = tpr.prefill_attention(tq, tk, tv, scale)
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) < DTYPES[dt][2]
    seg = np.concatenate([np.full(n, i) for i, n in enumerate((90, 60, 40))]
                         + [np.full(10, -1)]).astype(np.int32)
    want = j_ragged(jq, jk, jv, None, None, 0, SimpleNamespace(seg_ids=jnp.asarray(seg)),
                    scale)
    got = tpr.ragged_prefill_attention(tq, tk, tv, torch.from_numpy(seg), scale)
    live = seg >= 0
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", WIDTHS)
def test_gather_kernels_plain_equal_deft_tpu(D, dt, kv):
    """B6 on the grown tree's flatten plan in the gather layout and B7 on
    its gather seq plan: padded paths, seq_len 0 leaves, pads at slot 0."""
    rng = np.random.default_rng(3)
    tree = grown_tree()
    (jk, (tk, tks)), (jv, (tv, tvs)) = pools(rng, 4096, D, kv, dt)
    scale = D ** -0.5
    fields = ("kv_idx", "tok_lo", "tok_hi", "blk_lo", "blk_hi")
    plan = build_flatten_plan(tree, q_per_kv=Hq // Hkv, block_len=128,
                              min_token_bucket=128)
    (jq,), (tq,) = qkv(rng, plan.l_pad, D, dt, heads=(Hq,))
    want = j_flatten(jq, None, None, jk, jv, 0,
                     SimpleNamespace(**{f: jnp.asarray(getattr(plan, f)) for f in fields}),
                     scale)
    got = tfa.flatten_attention(tq, tk, tv, 0,
                                *(torch.from_numpy(getattr(plan, f)) for f in fields),
                                scale, tks, tvs)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]
    plan = build_seq_plan(tree, q_per_kv=Hq // Hkv, block_len=128,
                          min_token_bucket=128, want_paged=False)
    assert plan.n_leaves < plan.l_pad
    (jq,), (tq,) = qkv(rng, plan.l_pad, D, dt, heads=(Hq,))
    want = j_seq(jq, None, None, jk, jv, 0,
                 SimpleNamespace(paths=jnp.asarray(plan.paths),
                                 seq_lens=jnp.asarray(plan.seq_lens)), scale)
    got = tsa.seq_attention(tq, tk, tv, 0, torch.from_numpy(plan.paths),
                            torch.from_numpy(plan.seq_lens), scale, tks, tvs)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]


@pytest.fixture(scope="module", params=WIDTHS)
def reference(request):
    """deft_tpu's generations at one width (its CPU XLA attention), per KV
    dtype and mode, and its weights."""
    D = request.param
    out, jparams = {}, None
    for kv in KV:
        jr = JRunner(config(D, True), JEngineConfig(**ECFG, kv_dtype=kv),
                     kernels="xla", seed=0)
        jparams = jr.params
        for mode in MODES:
            jr.reset_state()
            j_tree_generate(jr, j_mode(mode), None, PROMPT, max_seq_len=MAX_SEQ,
                            width=WIDTH, depth=1,
                            branch_controller=JController(jworkloads.simple_tree))
            out[kv, mode] = [tuple(s.token_ids) for s in jr.tree.all_finished_seqs]
    return D, jparams, out


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("mode", MODES)
def test_generate_matches_deft_tpu(reference, mode, kv):
    D, jparams, ref = reference
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               config(D), "cpu", torch.float32)
    runner = ModelRunner(config(D), EngineConfig(**ECFG, kv_dtype=kv), device="cpu",
                         params=params)
    attn = []
    pick = runner._attn_fn
    runner._attn_fn = lambda m, paged: attn.append(paged) or pick(m, paged)
    tree_generate(runner, mode_from_cli(mode), None, PROMPT, max_seq_len=MAX_SEQ,
                  width=WIDTH, depth=1,
                  branch_controller=Branch_Controller(workloads.simple_tree))
    got = [tuple(s.token_ids) for s in runner.tree.all_finished_seqs]
    assert len(got) == WIDTH and got == ref[kv, mode]
    assert attn and not any(attn)  # every step through the gather kernels
