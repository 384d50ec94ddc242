"""deft_tpu_torch's batched serving against deft_tpu's, on the CPU.

- the multi-tree flatten and seq plans equal deft_tpu's field by field
  (leaf_offsets included), paged and gather, under the bf16 and the int8
  segment rules;
- B8's plain version (ragged_prefill_attention on CPU tensors) against
  deft_tpu's Pallas kernel in interpret mode;
- forward_prefill_batch's logits and pool writes against deft_tpu's;
- BatchedEngine emits deft_tpu's greedy ids in flatten and in seq, the same
  as each request run alone, with feed() mid-decode, a one-token request
  and an int8 KV cache, and deft_tpu's ids in node mode and for
  Speculative_Decoding requests (each tree's queued merge copies applied
  before its alloc);
- the CLI's --batch runs on the CPU.

Tolerances, relative to the largest output: fp32 2e-5 (summation order
only), bf16 2e-2 (tests/test_kernels.py's bf16 bound).  Token ids must be
equal: attention is exact and the weights are the same numpy stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.core as jcore
import deft_tpu.data.loader as jloader
import deft_tpu.data.synthetic as jsynth
import deft_tpu.plan.multi as jmulti
import deft_tpu_torch.core as tcore
import deft_tpu_torch.data.loader as tloader
import deft_tpu_torch.data.synthetic as tsynth
import deft_tpu_torch.plan.multi as tmulti
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.ops.flatten_attn import fold_q, unfold_o
from deft_tpu.ops.prefill import ragged_prefill_attention as j_ragged
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime.batched import BatchedEngine as JEngine
from deft_tpu.runtime.batched import Request as JRequest
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.ops import prefill as tprefill
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate
from deft_tpu_torch.runtime.batched import BatchedEngine, Request

ECFG = dict(kv_pool_slots=8192, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPTS = [list(range(7, 19)), list(range(31, 47)), list(range(5, 14))]
WIDTH, GEN = 2, 9
INT8_RULES = dict(seg_len=(128,), waste_limit=3.0)  # deft_tpu batched.py:195


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


# -- (a) multi-tree plans -----------------------------------------------------

def grown_trees(pkg, prompts, widths, steps, seed):
    """Trees of one package on one shared pool, grown by the same seeded
    schedule: prompt, branch, then `steps` rounds of alloc and append."""
    rng = np.random.default_rng(seed)
    pool, rt = pkg.TokenKVPool(16384), pkg.ReqToTokenPool(128, 2048)
    trees = [pkg.TreeCache(pool, rt) for _ in prompts]
    for t, p, w in zip(trees, prompts, widths):
        t.init_prompt(p)
        for c, ch in enumerate(t.branch(t.root, w)):
            ch.append_token(c + 3)
    for _ in range(steps):
        tok = rng.integers(1, 400, 64)
        for t in trees:
            t.alloc()
            for i, leaf in enumerate(sorted(t.leaves.values(), key=lambda n: n.id)):
                leaf.append_token(int(tok[i]))
    for t in trees:
        t.alloc()
    return trees


def assert_same_plan(a, b):
    assert a.leaf_offsets == b.leaf_offsets
    for f, x in vars(a).items():
        y = getattr(b, f)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("rules", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["paged", "gather"])
@pytest.mark.parametrize("kind", ["flatten", "seq"])
def test_multi_plans_match_deft_tpu(kind, layout, rules):
    """Three trees with different prompts and widths: long prompts give
    segment-aligned (paged) plans, short ones plans that are not."""
    rng = np.random.default_rng(3)
    lens, steps = ((300, 170, 420), 30) if layout == "paged" else ((12, 16, 9), 6)
    prompts = [rng.integers(4, 500, n).tolist() for n in lens]
    widths = (3, 5, 2)
    jt = grown_trees(jcore, prompts, widths, steps, seed=4)
    tt = grown_trees(tcore, prompts, widths, steps, seed=4)
    kw = dict(q_per_kv=2, block_len=256, min_token_bucket=128)
    if rules == "int8":
        kw.update(INT8_RULES)
    if kind == "flatten":
        jp = jmulti.build_multi_flatten_plan(jt, **kw)
        tp = tmulti.build_multi_flatten_plan(tt, **kw)
    else:
        jp = jmulti.build_multi_seq_plan(jt, want_paged=True, **kw)
        tp = tmulti.build_multi_seq_plan(tt, want_paged=True, **kw)
    assert tp.paged == (layout == "paged") and tp.n_leaves == sum(widths)
    assert tp.leaf_offsets == [0, 3, 8]
    assert_same_plan(jp, tp)


# -- (b) B8's plain version ---------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens,Hq,Hkv,D", [
    ((60, 83, 100), 8, 2, 64),
    ((128, 72), 32, 8, 128),
    ((500, 300, 200), 8, 2, 64),  # long prompts: mask-free interior tiles
])
def test_ragged_prefill_plain_vs_pallas(lens, Hq, Hkv, D, dt):
    """The cases of tests/test_kernels.py:615, padded tail included; pad
    rows give 0 in the port."""
    N = max(256, -(-sum(lens) // 128) * 128)
    rng = np.random.default_rng(sum(lens))
    q, k, v = (rng.standard_normal((N, h, D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    seg = np.full(N, -1, dtype=np.int32)
    o = 0
    for i, n in enumerate(lens):
        seg[o:o + n] = i
        o += n
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 2e-5),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dt]
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = unfold_o(j_ragged(fold_q(jq, Hkv), jnp.swapaxes(jk, 0, 1),
                             jnp.swapaxes(jv, 0, 1), jnp.asarray(seg),
                             scale=scale, qpk=Hq // Hkv), N)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = tprefill.ragged_prefill_attention(tq, tk, tv, torch.from_numpy(seg), scale)
    live = seg >= 0
    assert got.dtype == tdt
    assert rel_err(got.float().numpy()[live], np.asarray(want, np.float32)[live]) < tol
    assert not got[torch.from_numpy(~live)].any()
    starts = tprefill.segment_starts(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(starts[live], np.repeat(np.cumsum((0,) + lens[:-1]), lens))


# -- (c) ragged prefill through the model ---------------------------------------

@pytest.fixture(scope="module")
def jrunner():
    return JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla",
                   retain_full_logits=True, seed=0)


def test_forward_prefill_batch_matches_deft_tpu(jrunner):
    """The same three prompts in one ragged forward in both packages: equal
    top-k ids, logits and pool rows at 2e-5 (fp32); each row equals the
    port's own single-prompt prefill."""
    jr = jrunner
    jr.reset_state()
    jtrees = [jcore.TreeCache(jr.token_to_kv_pool, jr.req_to_token_pool)
              for _ in PROMPTS]
    jv = jr.forward_prefill_batch(PROMPTS, jtrees)
    tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                     retain_full_logits=True)
    ttrees = [tcore.TreeCache(tr.token_to_kv_pool, tr.req_to_token_pool)
              for _ in PROMPTS]
    tv = tr.forward_prefill_batch(PROMPTS, ttrees)
    np.testing.assert_array_equal(tv.ids, np.asarray(jv.ids))
    assert rel_err(tv.full_logits().numpy(), np.asarray(jv._full)) < 2e-5
    for jt, tt in zip(jtrees, ttrees):
        loc = tt.root.kv_indices
        np.testing.assert_array_equal(loc, jt.root.kv_indices)
        for jp, tp in ((jr.k_pool, tr.k_pool), (jr.v_pool, tr.v_pool)):
            assert rel_err(tp.data[:, loc].numpy(), np.asarray(jp.data)[:, loc]) < 2e-5
    for i, p in enumerate(PROMPTS):
        tr.reset_state()
        one = tr.forward_prefill(p)
        np.testing.assert_array_equal(one.ids[0], tv.ids[i])
        assert rel_err(one.full_logits()[0].numpy(), tv.full_logits()[i].numpy()) < 2e-5


# -- (d)-(g) the engine ----------------------------------------------------------

def engine_ids(engine_cls, request_cls, ctl_cls, policy, runner, mode, feed_after=None,
               template=None):
    eng = engine_cls(runner, mode=mode)
    reqs = [request_cls(p, ctl_cls(policy), len(p) + GEN, width=WIDTH,
                        template=template() if template else None)
            for p in PROMPTS]
    if feed_after is None:
        eng.add_requests(reqs)
    else:
        eng.add_request(reqs[0])
        for _ in range(feed_after):
            eng.step()
        eng.feed(reqs[1:])  # admitted inside the next step()
    eng.run()
    return [sorted(tuple(s.token_ids) for s in r.finished_seqs) for r in reqs]


def deft_ids(mode, kv="inherit", feed_after=None):
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG, kv_dtype=kv), kernels="xla",
                 seed=0)
    return engine_ids(JEngine, JRequest, JController, jworkloads.simple_tree, jr,
                      j_mode(mode), feed_after)


def port_ids(mode, kv="inherit", feed_after=None):
    tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG, kv_dtype=kv), device="cpu")
    return engine_ids(BatchedEngine, Request, Branch_Controller, workloads.simple_tree,
                      tr, mode_from_cli(mode), feed_after)


@pytest.fixture(scope="module")
def alone():
    """Each prompt's branches from the port's single-tree tree_generate."""
    out = []
    for p in PROMPTS:
        tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu")
        tree_generate(tr, mode_from_cli("flatten"), None, p, max_seq_len=len(p) + GEN,
                      width=WIDTH, depth=1,
                      branch_controller=Branch_Controller(workloads.simple_tree))
        out.append(sorted(tuple(s.token_ids) for s in tr.tree.all_finished_seqs))
    return out


@pytest.mark.parametrize("case", [("flatten", "inherit", None), ("seq", "inherit", None),
                                  ("flatten", "inherit", 3), ("flatten", "int8", None),
                                  ("seq", "int8", None)],
                         ids=["flatten", "seq", "feed-mid-decode", "flatten-int8-kv",
                              "seq-int8-kv"])
def test_batched_engine_matches_deft_tpu(alone, case):
    """deft_tpu's BatchedEngine (its CPU XLA attention) and the port's on
    the same weights: equal branch tokens per request, which also equal each
    request run alone (bf16/fp32 KV; int8 KV rounds the cache, so there
    the reference is deft_tpu's engine alone)."""
    mode, kv, feed_after = case
    got = port_ids(mode, kv, feed_after)
    assert got == deft_ids(mode, kv, feed_after)
    assert all(len(b) == WIDTH and all(len(t) == GEN - 1 for t in b) for b in got)
    if kv == "inherit":
        assert got == alone


def test_batched_max_gen_one_stops_after_prefill_branch():
    """max_seq_len = prompt + 1: exactly one generated token per branch; the
    engine finishes the request at admission even though the workload
    never signals stop (deft_tpu tests/test_batched.py:283)."""
    def never_stops(model, iter, max_gen_len, width, depth, logits, **kw):
        tree = model.tree
        if iter != 0:
            raise AssertionError("engine ran past max_gen")
        _, ids = logits.topk(0, width)
        for c, child in enumerate(tree.branch(tree.root, width)):
            child.append_token(int(ids[c]))
        return False

    tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu")
    eng = BatchedEngine(tr)
    req = Request(PROMPTS[0], Branch_Controller(never_stops), len(PROMPTS[0]) + 1,
                  width=2)
    eng.add_request(req)
    assert req.done and not eng.active
    assert eng.run() == 0
    assert tr.token_to_kv_pool.used_size() == 0  # the tree was freed


def spec_template(loader, synth):
    """A 4-leaf token tree whose accept schedule covers GEN tokens."""
    tpl = synth.synth_spec_tree(token_tree_size=4, gen_len=GEN - 1, seed=2)
    loader.generate_accepted_len_list(GEN, tpl, seed=0)
    return tpl


@pytest.mark.parametrize("mode,policy", [("node", "simple_tree"),
                                         ("flatten", "speculative_decoding"),
                                         ("seq", "speculative_decoding"),
                                         ("node", "speculative_decoding")])
def test_batched_node_and_speculative_match_deft_tpu(mode, policy):
    """Node mode (on the multi-tree flatten plan, as deft_tpu) and
    Speculative_Decoding requests, whose merges queue KV copies that the
    engine applies before each tree's alloc: deft_tpu's BatchedEngine and
    the port's give the same branch tokens on the same weights."""
    spec = policy == "speculative_decoding"
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla", seed=0)
    want = engine_ids(JEngine, JRequest, JController, getattr(jworkloads, policy), jr,
                      j_mode(mode), template=(lambda: spec_template(jloader, jsynth))
                      if spec else None)
    tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu")
    copies = []
    apply = tr.apply_kv_copies

    def counting_apply(tree=None):  # the engine passes each request's tree
        if tree is not None:
            copies.append(len(tree.pending_kv_copies))
        return apply(tree)

    tr.apply_kv_copies = counting_apply
    got = engine_ids(BatchedEngine, Request, Branch_Controller, getattr(workloads, policy),
                     tr, mode_from_cli(mode), template=(
                         lambda: spec_template(tloader, tsynth)) if spec else None)
    assert got == want and all(got)
    assert any(copies) == spec


def test_engine_refusals():
    """The engine takes flatten, node and seq modes (deft_tpu batched.py:101)
    and refuses the others; node mode runs, and a tree's queued KV copies
    land in the pools before its alloc."""
    tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu")
    with pytest.raises(ValueError, match="flatten, node or seq"):
        BatchedEngine(tr, mode=mode_from_cli("tree_index"))
    eng = BatchedEngine(tr, mode=mode_from_cli("node"))
    req = Request(PROMPTS[0], Branch_Controller(workloads.simple_tree),
                  len(PROMPTS[0]) + GEN, width=WIDTH)
    eng.add_request(req)
    src, dst = int(req.tree.root.kv_indices[0]), 4000  # a slot no step writes
    req.tree.pending_kv_copies.append((np.array([src]), np.array([dst])))
    eng.step()
    assert not req.tree.pending_kv_copies
    for pool in (tr.k_pool, tr.v_pool):
        assert torch.equal(pool.data[:, dst], pool.data[:, src])
        assert pool.data[:, dst].abs().sum() > 0


def test_cli_batch_runs_on_cpu(capsys):
    from deft_tpu_torch.cli import run

    assert run.main(["--device", "cpu", "--random-model", "tiny", "--mode", "flatten",
                     "--max_width", "2", "--max_seq_len", "20", "--dtype", "float32",
                     "--kv_pool_slots", "4096", "--batch", "3",
                     "--print-branches"]) == 0
    text = capsys.readouterr().out
    assert "batched: 3 requests, 54 generated tokens" in text
    assert text.count("req 2 branch") == 2
