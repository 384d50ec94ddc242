"""deft_tpu_torch's plans that are not segment-aligned against deft_tpu's,
on the CPU.

- the plain versions of B6 (flatten_attention) and B7 (seq_attention),
  which the wrappers run on the CPU, against deft_tpu's Pallas AttnFns
  flatten_attn_pallas / seq_attn_pallas in interpret mode, on the same
  gather plans, over pools of q's dtype and over int8 pools;
- tree_generate over the CLI's default 16-token prompt, whose steps cross
  between paged and gather plans, emits deft_tpu's ids with equal KV_IO;
- the CLI runs with its default prompt in both modes and both KV dtypes.

Tolerances, relative to the largest output, live rows only (padded rows
differ by convention, deft_tpu tests/test_kernels.py:77-84):
  fp32 2e-5 — summation order only;
  bf16 2e-2 — the Pallas kernels round the scaled q and p (and deft_tpu the
              dequantised int8 rows) to bf16, the plain versions compute in
              fp32 (tests/test_kernels.py's bf16 bound).
"""

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
from deft_tpu_torch.ops import seq_attn as tsa
from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate

Hq, Hkv, D = 8, 2, 64
QPK = Hq // Hkv
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
KV = ["inherit", "int8"]


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


def grown_tree(rng, prompt, width, steps):
    """A root of ``prompt`` tokens, ``width`` leaves, ``steps`` appends and
    one pruned leaf."""
    tree = TreeCache(TokenKVPool(8192), ReqToTokenPool(64, len(prompt) + steps + 64))
    tree.init_prompt(prompt)
    for i, c in enumerate(tree.branch(tree.root, width)):
        c.append_token(50 + i)
    for _ in range(steps):
        tree.alloc()
        for leaf in list(tree.leaves.values()):
            leaf.append_token(int(rng.integers(1, 400)))
    tree.cut(sorted(tree.leaves.values(), key=lambda x: x.id)[0])
    tree.alloc()
    return tree


def short_prompt_tree(rng):
    """The CLI's default prompt length: its plans are not segment-aligned."""
    return grown_tree(rng, list(range(7, 23)), 12, 40)


def long_prompt_tree(rng):
    """FULL prompt blocks, few-leaf suffix blocks and a dead bucket tail."""
    return grown_tree(rng, rng.integers(4, 400, 700).tolist(), 12, 12)


def pools(rng, tree, kv, dt):
    """(jax KVPool, torch (data, scale)) pairs for K and V: random rows of
    q's dtype, or random int8 codes and scales as deft_tpu
    tests/test_kernels.py:348-352 makes them."""
    S = tree.token_to_kv_pool.size
    jdt, tdt, _ = DTYPES[dt]
    out = []
    for _ in range(2):
        if kv == "int8":
            d = rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8)
            s = rng.uniform(0.01, 0.1, (1, Hkv, S)).astype(np.float32)
            out.append((JKVPool(jnp.asarray(d), jnp.asarray(s)),
                        (torch.from_numpy(d), torch.from_numpy(s))))
        else:
            d = rng.standard_normal((1, S, Hkv * D)).astype(np.float32)
            out.append((JKVPool(jnp.asarray(d, jdt)),
                        (torch.from_numpy(d).to(tdt), None)))
    return out


def query(rng, rows, dt):
    q = rng.standard_normal((rows, Hq, D)).astype(np.float32)
    return jnp.asarray(q, DTYPES[dt][0]), torch.from_numpy(q).to(DTYPES[dt][1])


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["short", "long"])
def test_flatten_gather_plain_vs_pallas(case, dt, kv):
    """B6 on the short prompt's gather plan, and on a long prompt's plan
    built in the gather layout (FULL, dead and few-leaf blocks); tail pads
    at DUMP_SLOT."""
    rng = np.random.default_rng(1)
    if case == "short":
        tree = short_prompt_tree(rng)
        plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=128,
                                  min_token_bucket=1024)
    else:
        tree = long_prompt_tree(rng)
        plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=128,
                                  min_token_bucket=1024, seg_len=None)
        full = plan.blk_lo < -(1 << 20)
        dead = (plan.blk_lo >= plan.blk_hi) & ~full
        few = ~full & ~dead & (plan.blk_hi - plan.blk_lo < plan.n_leaves)
        assert full.any() and dead.any() and few.any()
    assert not plan.paged and plan.kv_idx[-1] == 0  # tail pad at DUMP_SLOT
    (jk, (tk, tks)), (jv, (tv, tvs)) = pools(rng, tree, kv, dt)
    jq, tq = query(rng, plan.l_pad, dt)
    scale = D ** -0.5
    batch = SimpleNamespace(**{f: jnp.asarray(getattr(plan, f)) for f in
                               ("kv_idx", "tok_lo", "tok_hi", "blk_lo", "blk_hi")})
    want = j_flatten(jq, None, None, jk, jv, 0, batch, scale)
    arr = [torch.from_numpy(getattr(plan, f)) for f in
           ("kv_idx", "tok_lo", "tok_hi", "blk_lo", "blk_hi")]
    got = tfa.flatten_attention(tq, tk, tv, 0, *arr, scale, tks, tvs)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_seq_gather_plain_vs_pallas(dt, kv):
    """B7 on a gather plan: padded per-leaf paths, pads at slot 0, padded
    leaves with seq_len 0."""
    rng = np.random.default_rng(2)
    tree = short_prompt_tree(rng)
    plan = build_seq_plan(tree, q_per_kv=QPK, block_len=128,
                          min_token_bucket=128, want_paged=False)
    assert not plan.paged and plan.n_leaves < plan.l_pad
    assert (plan.seq_lens[:plan.n_leaves] < plan.c_pad).all()
    (jk, (tk, tks)), (jv, (tv, tvs)) = pools(rng, tree, kv, dt)
    jq, tq = query(rng, plan.l_pad, dt)
    scale = D ** -0.5
    batch = SimpleNamespace(paths=jnp.asarray(plan.paths),
                            seq_lens=jnp.asarray(plan.seq_lens))
    want = j_seq(jq, None, None, jk, jv, 0, batch, scale)
    got = tsa.seq_attention(tq, tk, tv, 0, torch.from_numpy(plan.paths),
                            torch.from_numpy(plan.seq_lens), scale, tks, tvs)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]


ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(range(7, 23))  # cli/run.py's default prompt
WIDTH, MAX_SEQ = 4, 48


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's generations over the default prompt (its CPU XLA
    attention), per KV dtype and mode, and its weights."""
    out, jparams = {}, None
    for kv in KV:
        jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG, kv_dtype=kv),
                     kernels="xla", seed=0)
        jparams = jr.params
        for mode in ("flatten", "seq"):
            jr.reset_state()
            pm = j_tree_generate(jr, j_mode(mode), None, PROMPT,
                                 max_seq_len=MAX_SEQ, width=WIDTH, depth=1,
                                 branch_controller=JController(jworkloads.simple_tree))
            out[kv, mode] = ([tuple(s.token_ids) for s in jr.tree.all_finished_seqs], pm)
    return jparams, out


@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_short_prompt_generate_matches_deft_tpu(reference, mode):
    """The 16-token prompt: bf16/fp32 pools cross paged and gather plans
    within the run; int8 pools take the int8 segment rules.  Ids and KV_IO
    equal deft_tpu's for both."""
    jparams, ref = reference
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               PRESETS["tiny"], "cpu", torch.float32)
    for kv in KV:
        runner = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG, kv_dtype=kv),
                             device="cpu", params=params)
        paged = []
        build = runner.build_plan

        def recording_build(m):
            plan = build(m)
            paged.append(plan.paged)
            return plan

        runner.build_plan = recording_build
        pm = tree_generate(runner, mode_from_cli(mode), None, PROMPT,
                           max_seq_len=MAX_SEQ, width=WIDTH, depth=1,
                           branch_controller=Branch_Controller(workloads.simple_tree))
        got = [tuple(s.token_ids) for s in runner.tree.all_finished_seqs]
        want, jpm = ref[kv, mode]
        assert len(got) == WIDTH and got == want, kv
        assert pm.KV_IO == jpm.KV_IO and pm.Mask_IO == jpm.Mask_IO, kv
        if kv == "inherit":
            assert any(paged) and not all(paged), paged


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_cli_default_prompt_runs_on_cpu(mode, kv, capsys):
    from deft_tpu_torch.cli import run

    assert run.main(["--device", "cpu", "--random-model", "tiny", "--dtype",
                     "float32", "--kv_pool_slots", "4096", "--max_width", "3",
                     "--max_seq_len", "40", "--mode", mode, "--kv-dtype", kv,
                     "--print-branches"]) == 0
    text = capsys.readouterr().out
    assert "TPOT (ms/token)" in text and text.count("Branch ID") == 3


def test_new_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which refuses
    what is not on one CUDA device before it builds or launches anything:
    B4, B5, B6 and B7 (both pool types)."""
    from deft_tpu_torch.ops import paged_quant as tpq
    from deft_tpu_torch.ops import paged_seq_attn as tps

    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    q = torch.empty(4, Hq, D, **meta)
    pool = torch.empty(1, 512, Hkv * D, **meta)
    qpool = torch.empty(1, 512, Hkv * D, dtype=torch.int8, device="meta")
    sc = torch.empty(1, Hkv, 512, **meta)
    calls = [
        lambda: tpq.paged_flatten_attention_q(
            q, qpool, qpool, sc, sc, 0, torch.empty(4, **i32),
            torch.empty(128, **i32), torch.empty(128, **i32),
            torch.empty(1, **i32), torch.empty(1, **i32), 0.1, 128, 32),
        lambda: tps.paged_seq_attention_q(
            q, qpool, qpool, sc, sc, 0, torch.empty(16, **i32),
            torch.empty(16, **i32), torch.empty(16, **i32),
            torch.empty(4, **i32), 0.1, 32),
    ]
    for kpool, scales in ((pool, (None, None)), (qpool, (sc, sc))):
        calls.append(lambda k=kpool, s=scales: tfa.flatten_attention(
            q, k, k, 0, torch.empty(128, **i32), torch.empty(128, **i32),
            torch.empty(128, **i32), torch.empty(1, **i32),
            torch.empty(1, **i32), 0.1, *s))
        calls.append(lambda k=kpool, s=scales: tsa.seq_attention(
            q, k, k, 0, torch.empty(4, 64, **i32), torch.empty(4, **i32), 0.1,
            *s))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
