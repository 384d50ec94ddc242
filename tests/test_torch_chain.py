"""deft_tpu_torch's device-chained decode against its per-step path and
deft_tpu, on the CPU in fp32.

A workload that declares its iterations (``structural_iters``,
``logits_free_iters``, ``supports_deferred``) runs chained in
runtime/generate.py: greedy steps feed their device ids to the next step,
deferred ToT and random-tree selections are gathered on the device, and
logits-free steps are enqueued without a wait.  The same workload wrapped
in a plain function declares nothing and runs every step with host logits
(the per-step path), as tests/test_e2e.py:454-556 wraps them for deft_tpu.
Both must give the same branches: token ids equal, logprobs equal rounded
to 4 places (tests/test_e2e.py:527-530), and equal to deft_tpu's
tree_generate on the same weights (its replay path) and its BatchedEngine.
Also: the device top-k tie rule against ``jax.lax.top_k``, a gloo grid
1x1x2 against the single device, and the runner's count of its host waits,
on one device and on each rank of a gloo grid 1x2x1.

The port's runs here take the per-step chain (``per_step_path``:
DEFT_REPLAY_EXEC=0 DEFT_PLAN_PATCH=0), which is what these tests hold:
by default tree_generate records such steps and replays them from slabs,
or runs them as decode windows (tests/test_torch_replay.py).
"""

import contextlib

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.data.loader as jloader
import deft_tpu_torch.data.loader as tloader
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu.runtime.batched import BatchedEngine as JEngine
from deft_tpu.runtime.batched import Request as JRequest
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.parallel import launch
from deft_tpu_torch.parallel.launch import generate_tokens, greedy_waits, run_all
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate
from deft_tpu_torch.runtime.batched import BatchedEngine, Request
from deft_tpu_torch.runtime.generate import sync_period
from deft_tpu_torch.runtime.runner import host_wait, topk_lowest_index

SYNC_PERIOD = sync_period()
ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(range(7, 19))  # tests/test_torch_workloads.py's
BATCH_PROMPTS = [list(range(7, 19)), list(range(31, 47)), list(range(5, 14))]


def e2e_template(loader):
    """tests/test_e2e.py:484-530's template: the root branches 3-way at
    iteration 0, node 1 2-way at 2, node 2 prunes at 4, the root at 9."""
    N = loader.ExecuteTreeNode
    root, n1, n2 = N(0, 1, 0, 0), N(1, 2, 0, 2), N(2, 4, 0, 4)
    n5, n3, n4 = N(5, 9, 0, 9), N(3, 9, 2, 9), N(4, 9, 2, 9)
    root.children, n1.children = [n1, n2, n5], [n3, n4]
    tpl = loader.ExecuteTree(root, [root, n1, n2, n5, n3, n4])
    assert tpl.branch_record[2] == {1: [3, 4]} and 0 in tpl.prune_record[9]
    return tpl


def spec_template(loader):
    """tests/test_e2e.py:138's token tree: 8 nodes, accepts 2, 1, 3."""
    tpl = loader.ExecuteTree(loader.ExecuteTreeNode(0),
                             [loader.ExecuteTreeNode(i) for i in range(8)])
    tpl.accepted_len_list = [2, 1, 3]
    return tpl


# name -> (workload, template maker (loader) or None, generated tokens, width)
CASES = {
    "greedy": ("simple_tree", None, 14, 3),
    "practical": ("practical_tree", e2e_template, 12, 3),
    "random": ("random_tree", None, 16, 3),
    "spec": ("speculative_decoding", spec_template, 32, 8),
}


@contextlib.contextmanager
def per_step_path():
    """The port's tree_generate on its per-step chain: no record path, no
    decode windows (the runner reads DEFT_PLAN_PATCH when it is made)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEFT_REPLAY_EXEC", "0")
        mp.setenv("DEFT_PLAN_PATCH", "0")
        yield


def per_step(fn):
    """``fn`` without its declarations: every step reads host logits."""
    def wrapped(*a, **k):
        k.pop("deferred", None)
        return fn(*a, **k)
    return wrapped


def branches(tree):
    return sorted((tuple(s.token_ids), round(s.cumulative_logprob, 4))
                  for s in tree.all_finished_seqs)


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's runner (CPU route) and its numpy weights in the port."""
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla", seed=0)
    params = params_from_numpy({k: np.asarray(v) for k, v in jr.params.items()},
                               PRESETS["tiny"], "cpu", torch.float32)
    return jr, params


def port_runner(params, **kw):
    with per_step_path():
        return ModelRunner(PRESETS["tiny"], EngineConfig(**{**ECFG, **kw}), device="cpu",
                           params=params)


def port_run(runner, case, mode="flatten", chained=True):
    """tree_generate of ``case``; returns its branches and the keyword
    arguments of every forward_tree_decode call."""
    name, make, gen, width = CASES[case]
    fn = getattr(workloads, name)
    calls = []
    forward = runner.forward_tree_decode

    def recording(mode, plan, **kw):
        calls.append(kw)
        return forward(mode, plan, **kw)

    runner.forward_tree_decode = recording
    with per_step_path():
        tree_generate(runner, mode_from_cli(mode), None, PROMPT,
                      max_seq_len=len(PROMPT) + gen, width=width, depth=2,
                      branch_controller=Branch_Controller(fn if chained else per_step(fn)),
                      tree_template=make(tloader) if make else None)
    return branches(runner.tree), calls


def deft_run(jr, case, mode="flatten"):
    name, make, gen, width = CASES[case]
    jr.reset_state()
    j_tree_generate(jr, j_mode(mode), None, PROMPT, max_seq_len=len(PROMPT) + gen,
                    width=width, depth=2,
                    branch_controller=JController(getattr(jworkloads, name)),
                    tree_template=make(jloader) if make else None)
    return branches(jr.tree)


@pytest.mark.parametrize("case,mode", [("greedy", "flatten"), ("greedy", "seq"),
                                       ("practical", "flatten"), ("random", "flatten")])
def test_chain_matches_per_step_and_deft_tpu(reference, case, mode):
    """Greedy chains (flatten and seq) and deferred selection (ToT replay
    across branches at top-K columns > 0 and prunes that reorder the rows;
    the random tree's rng schedule): the chained run's branches equal the
    per-step run's and deft_tpu's."""
    jr, params = reference
    chained, calls = port_run(port_runner(params), case, mode)
    stepped, step_calls = port_run(port_runner(params), case, mode, chained=False)
    assert chained and chained == stepped
    assert chained == deft_run(jr, case, mode)
    # the per-step run waits every step; the chained one enqueues most
    assert all(c.get("block", True) for c in step_calls)
    assert not any(c.get("q_tokens_override") is not None or c.get("q_select")
                   for c in step_calls)
    assert sum(not c["block"] for c in calls) >= len(calls) // 2
    if case == "greedy":
        assert sum(c["q_tokens_override"] is not None for c in calls) == len(calls) - 1
    else:
        selects = [c["q_select"] for c in calls if c["q_select"] is not None]
        assert selects and any((cols > 0).any() for _, _, cols in selects)


def test_speculative_pipelined_steps_match_per_step(reference):
    """Speculative decoding's logits-free accept steps are enqueued without
    a wait and skip the lm_head; the replayed tree equals the per-step
    run's (every step waiting for its top-K)."""
    _, params = reference
    chained, calls = port_run(port_runner(params), "spec")
    stepped, step_calls = port_run(port_runner(params), "spec", chained=False)
    assert chained and chained == stepped
    assert {(c["block"], c["logits_kind"]) for c in calls} == {(False, "skip")}
    assert {c.get("logits_kind", "topk") for c in step_calls} == {"topk"}


def test_int8_kv_chain_matches_per_step(reference):
    _, params = reference
    chained, calls = port_run(port_runner(params, kv_dtype="int8"), "greedy")
    stepped, _ = port_run(port_runner(params, kv_dtype="int8"), "greedy", chained=False)
    assert chained and chained == stepped
    assert any(c["q_tokens_override"] is not None for c in calls)


def engine_branches(engine_cls, request_cls, ctl_cls, policy, runner, mode, gen):
    eng = engine_cls(runner, mode=mode)
    reqs = [request_cls(p, ctl_cls(policy), len(p) + gen, width=2) for p in BATCH_PROMPTS]
    eng.add_requests(reqs)
    eng.run()
    return [sorted(tuple(s.token_ids) for s in r.finished_seqs) for r in reqs]


@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_batched_greedy_fast_path(reference, mode):
    """BatchedEngine's all-greedy fast path (steps enqueued on the previous
    step's device ids, placeholders backfilled, a wait every 8 steps)
    against per-step steps and against deft_tpu's BatchedEngine."""
    jr, params = reference
    gen = SYNC_PERIOD + 2  # one 8-step wait
    runner = port_runner(params)
    calls = []
    forward = runner.forward_tree_decode

    def recording(mode, plan, **kw):
        calls.append(kw)
        return forward(mode, plan, **kw)

    runner.forward_tree_decode = recording
    waits = host_wait.waits
    chained = engine_branches(BatchedEngine, Request, Branch_Controller,
                              workloads.simple_tree, runner, mode_from_cli(mode), gen)
    # the admission's read, the 8-step waits, the last (structural) step
    assert host_wait.waits - waits <= 1 + len(calls) // SYNC_PERIOD + 1
    assert sum(not c["block"] for c in calls) == len(calls) - 1
    stepped = engine_branches(BatchedEngine, Request, Branch_Controller,
                              per_step(workloads.simple_tree), port_runner(params),
                              mode_from_cli(mode), gen)
    jr.reset_state()
    want = engine_branches(JEngine, JRequest, JController, jworkloads.simple_tree, jr,
                           j_mode(mode), gen)
    assert chained == stepped == want
    assert all(len(b) == 2 and all(len(t) == gen - 1 for t in b) for b in chained)


def tied_probs(seed: int, rows: int, V: int, k: int) -> np.ndarray:
    """Softmax + 1e-6 of bf16-valued logits whose largest value recurs and
    whose k-th largest value fills the places k-3 .. k+3: ties at the top
    and across the k-th place, as the runner's top-K sees them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, V)).astype(np.float32) * 3)
    x = x.to(torch.bfloat16).float().numpy()
    for r in range(rows):
        order = np.argsort(-x[r], kind="stable")
        x[r, rng.choice(V, 3, replace=False)] = x[r, order[0]]
        order = np.argsort(-x[r], kind="stable")
        x[r, order[max(k - 4, 0):k + 3]] = x[r, order[k - 1]]
    return (torch.softmax(torch.from_numpy(x), dim=-1) + 1e-6).numpy()


@pytest.mark.parametrize("k", [1, 50, 64])
def test_device_topk_tie_rule_matches_jax(k):
    """The top-K of the runner's probabilities (rows of Llama-3's 128,256
    entries), computed without a host read, in jax.lax.top_k's order: ties
    lowest index first, also across the k-th place."""
    p = tied_probs(k, 4, 128256, k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(p), k)
    got_v, got_i = topk_lowest_index(torch.from_numpy(p), k)
    kth = p[np.arange(4), np.asarray(want_i)[:, -1]]
    assert ((p >= kth[:, None]).sum(axis=1) > k).all()  # a tie crosses the k-th place
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_grid_chain_matches_single_device(reference):
    """A gloo grid 1x1x2 (tp 2) chains each rank's own greedy ids (the
    ranks' all-reduced logits are the same): its branches equal deft_tpu's
    single-device run on the same seed's weights."""
    gen = dict(kv_pool_slots=1024, max_requests=16, max_context_len=128,
               min_token_bucket=128, dtype="float32")
    prompt = list(range(7, 27))
    got, _ = launch(run_all, (1, 1, 2), "cpu", args=([(generate_tokens, dict(
        cfg=PRESETS["tiny"], ecfg=EngineConfig(**gen), prompt=prompt, mode="flatten",
        width=3, max_seq_len=len(prompt) + SYNC_PERIOD + 2, seed=3))],),
        timeout=300)[0]
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**gen), kernels="xla", seed=3)
    j_tree_generate(jr, j_mode("flatten"), None, prompt,
                    max_seq_len=len(prompt) + SYNC_PERIOD + 2, width=3, depth=0,
                    branch_controller=JController(jworkloads.simple_tree))
    assert sorted(got) == sorted(tuple(s.token_ids) for s in jr.tree.all_finished_seqs)


WAITS_GEN = 2 * SYNC_PERIOD + 3


@pytest.fixture(scope="module")
def grid_waits():
    """test_host_waits_counted's runs on a gloo grid 1x2x1 (sp 2: each
    step's plan cut into the ranks' block spans on the host), chained and
    per-step, in one launch; rank 0's tokens, waits and steps."""
    calls = [(greedy_waits, dict(cfg=PRESETS["tiny"], ecfg=EngineConfig(**ECFG),
                                 prompt=PROMPT, gen=WAITS_GEN, width=3, chained=c,
                                 seed=0)) for c in (True, False)]
    return dict(zip((True, False), launch(run_all, (1, 2, 1), "cpu", args=(calls,),
                                          timeout=300)))


@pytest.mark.parametrize("chained", [True, False], ids=["chained", "per-step"])
def test_host_waits_counted(reference, grid_waits, chained):
    """A greedy Simple_Tree run of G decode steps waits at most
    ceil(G / 8) + 2 times after its prefill (the 8-step waits, the last,
    structural, step and the drain); the per-step path waits once a step.
    A step enqueued with block=False waits not at all.  The same holds on
    a gloo grid 1x2x1, whose branches equal the one device's."""
    _, params = reference
    runner = port_runner(params)
    forward = runner.forward_tree_decode
    seen = []

    def recording(mode, plan, **kw):
        before = host_wait.waits
        if not seen:
            seen.append(before)  # the prefill's read is behind us
        out = forward(mode, plan, **kw)
        if not kw.get("block", True):
            assert host_wait.waits == before
        return out

    runner.forward_tree_decode = recording
    fn = workloads.simple_tree if chained else per_step(workloads.simple_tree)
    with per_step_path():
        tree_generate(runner, mode_from_cli("flatten"), None, PROMPT,
                      max_seq_len=len(PROMPT) + WAITS_GEN, width=3, depth=1,
                      branch_controller=Branch_Controller(fn))
    G = WAITS_GEN - 1
    tokens, grid_total, grid_steps = grid_waits[chained]
    assert sorted(tokens) == sorted(tuple(s.token_ids) for s in runner.tree.all_finished_seqs)
    assert len(grid_steps) == G
    assert all(waits == 0 for block, waits in grid_steps if not block)
    for waits in (host_wait.waits - seen[0], grid_total):
        if chained:
            assert waits <= math.ceil(G / SYNC_PERIOD) + 2
        else:
            assert waits == G
