"""deft_tpu_torch's attention-latency estimate against deft_tpu's, on the
CPU in fp32.

With ``measure_attention`` the runner times each shape bucket's attention
(the step's AttnFn over every layer) and KV stores (into DUMP_SLOT) before
the step, and tree_generate charges the estimate to ``attn_mem`` /
``attn_comp`` (deft_tpu runner.py:1895-2002, generate.py:676-697).  Both
packages run with measurement on, deft_tpu on its CPU route
(kernels="xla") as tests/test_obs.py:64-90 runs it, and the port on its
kernels' plain versions.  Also: the bucket keys against deft_tpu's Pallas
route (interpret mode, where its plans are paged as the port's are), no
token and no live pool row changed by the measurement, a gloo grid 1x2x1,
the CPU default (off), the tokens at bench.py's block_len 1024, and the
progress beat with its ``.partial`` dump.
"""

import json

import numpy as np
import pytest
import torch

import deft_tpu_torch.data.loader as tloader
import deft_tpu_torch.runtime.generate as tgenerate
from deft_tpu.config import AttentionConfig as JAttentionConfig
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.obs import PerfMetrics as JPerfMetrics
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu_torch.config import AttentionConfig, EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.parallel import launch
from deft_tpu_torch.parallel.launch import attn_estimates, run_all
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate

# tests/test_obs.py:75-80's engine and run
ECFG = dict(kv_pool_slots=2048, max_requests=32, max_context_len=256,
            min_token_bucket=128, dtype="float32")
PROMPT = list(range(7, 19))
RUN = dict(max_seq_len=20, width=2, depth=1)
PER_ITER = ("iter_time", "prepare_per_iter", "forward_per_iter", "branch_per_iter",
            "attn_mem_per_iter", "attn_comp_per_iter", "traversal_per_iter",
            "alloc_per_iter", "positions_per_iter", "tree_metadata_per_iter",
            "input_metadata_per_iter")


@pytest.fixture(autouse=True)
def one_thread():
    """The plain attention versions on one thread: the microbench runs them
    84 times a layer and bucket, and tiny ops on several threads are two
    orders of magnitude slower on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's runner (CPU route, measurement on) and its weights in the
    port."""
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla", seed=0,
                 measure_attention=True)
    params = params_from_numpy({k: np.asarray(v) for k, v in jr.params.items()},
                               PRESETS["tiny"], "cpu", torch.float32)
    return jr, params


def port_runner(params, ecfg=ECFG, **kw):
    return ModelRunner(PRESETS["tiny"], EngineConfig(**ecfg), device="cpu",
                       params=params, **kw)


def branches(tree):
    return sorted((tuple(s.token_ids), round(s.cumulative_logprob, 4))
                  for s in tree.all_finished_seqs)


def per_step(fn):
    """``fn`` without its declarations: every step reads host logits."""
    def wrapped(*a, **k):
        k.pop("deferred", None)
        return fn(*a, **k)
    return wrapped


def e2e_template(loader):
    """tests/test_e2e.py:484-530's template: the root branches 3-way at
    iteration 0, node 1 2-way at 2, node 2 prunes at 4, the root at 9."""
    N = loader.ExecuteTreeNode
    root, n1, n2 = N(0, 1, 0, 0), N(1, 2, 0, 2), N(2, 4, 0, 4)
    n5, n3, n4 = N(5, 9, 0, 9), N(3, 9, 2, 9), N(4, 9, 2, 9)
    root.children, n1.children = [n1, n2, n5], [n3, n4]
    return loader.ExecuteTree(root, [root, n1, n2, n5, n3, n4])


def check_estimated(pm):
    assert pm.attn_is_estimate
    assert pm.attention_latency > 0
    assert all(v > 0 for v in pm.attn_comp_per_iter)
    assert pm.attention_latency <= pm.e2e_latency


@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_estimate_filled_as_deft_tpu(reference, mode):
    """A Simple_Tree run with measurement on fills the attention fields in
    both packages: attention_latency > 0 and within e2e, every step's
    attn_comp > 0, attn_is_estimate; the per-iteration lists as long as
    deft_tpu's, as_dict() with deft_tpu's keys, the same tokens."""
    jr, params = reference
    jr.reset_state()
    jpm = j_tree_generate(jr, j_mode(mode), None, PROMPT,
                          branch_controller=JController(jworkloads.simple_tree), **RUN)
    want = branches(jr.tree)
    runner = port_runner(params, measure_attention=True)
    pm = tree_generate(runner, mode_from_cli(mode), None, PROMPT,
                       branch_controller=Branch_Controller(workloads.simple_tree), **RUN)
    check_estimated(jpm)
    check_estimated(pm)
    assert set(pm.as_dict()) == set(jpm.as_dict())
    for key in PER_ITER:
        assert len(pm.as_dict()[key]) == len(jpm.as_dict()[key]) > 0
    assert branches(runner.tree) == want


@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_bucket_keys_match_deft_tpu(reference, monkeypatch, mode):
    """The port measures the same buckets, in the same order, as deft_tpu
    on its Pallas route, whose plans are paged as the port's are (its
    non-compact plan form: DEFT_COMPACT_PLAN=0).  On the 230-token prompt
    the flatten run's plans turn from gathered to segment-aligned as the
    leaves grow, so that run measures two buckets."""
    _, params = reference
    monkeypatch.setenv("DEFT_COMPACT_PLAN", "0")
    ecfg = dict(ECFG, kv_pool_slots=4096, max_context_len=1024)
    prompt = [int(t) for t in np.random.default_rng(0).integers(4, 500, 230)]
    run = dict(max_seq_len=len(prompt) + 8, width=4, depth=1)
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ecfg), kernels="pallas", seed=0,
                 measure_attention=True)
    j_tree_generate(jr, j_mode(mode), None, prompt,
                    branch_controller=JController(jworkloads.simple_tree), **run)
    runner = port_runner(params, ecfg, measure_attention=True)
    tree_generate(runner, mode_from_cli(mode), None, prompt,
                  branch_controller=Branch_Controller(workloads.simple_tree), **run)
    keys = list(runner._attn_bench_cache)
    assert keys == list(jr._attn_bench_cache)
    assert [paged for _, paged, _ in keys] == ([False, True] if mode == "flatten"
                                               else [True])


# name -> (workload, template maker, per-step, mode, KV dtype)
CASES = {
    "per-step": ("simple_tree", None, True, "flatten", "inherit"),
    "chained": ("simple_tree", None, False, "flatten", "inherit"),
    "chained-seq": ("simple_tree", None, False, "seq", "inherit"),
    "deferred": ("practical_tree", e2e_template, False, "flatten", "inherit"),
    "int8": ("simple_tree", None, False, "flatten", "int8"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_measurement_changes_no_token_or_live_row(reference, case):
    """A run with measurement on gives the tokens of one with it off, and
    leaves the K/V pools bit-equal but for DUMP_SLOT's row and int8 scale:
    per-step and chained (a greedy chain in flatten and seq, deferred
    selection of Practical_Tree), and over int8 KV."""
    _, params = reference
    name, make, stepped, mode, kv = CASES[case]
    fn = getattr(workloads, name)
    runs = {}
    for measure in (True, False):
        runner = port_runner(params, dict(ECFG, kv_pool_slots=4096, max_context_len=512,
                                          kv_dtype=kv), measure_attention=measure)
        pm = tree_generate(runner, mode_from_cli(mode), None, PROMPT,
                           max_seq_len=len(PROMPT) + 12, width=3, depth=2,
                           branch_controller=Branch_Controller(per_step(fn) if stepped
                                                               else fn),
                           tree_template=make(tloader) if make else None)
        runs[measure] = (branches(runner.tree), runner, pm)
    (got, on, pm), (want, off, _) = runs[True], runs[False]
    check_estimated(pm)
    assert got and got == want
    keep = [s for s in range(on.k_pool.data.shape[1]) if s != DUMP_SLOT]
    for a, b in ((on.k_pool, off.k_pool), (on.v_pool, off.v_pool)):
        assert torch.equal(a.data[:, keep], b.data[:, keep])
        if kv == "int8":
            assert torch.equal(a.scale[:, :, keep], b.scale[:, :, keep])


def test_grid_estimate(reference):
    """A gloo grid 1x2x1 (sp 2) with measure_attention=True: every rank
    gets an estimate at every step and measures the same buckets, and the
    tokens equal the single-process run's (deft_tpu
    tests/test_multichip.py:431-457's counterpart).  With the default
    (None) on the CPU, the same grid leaves the fields at 0."""
    ecfg = EngineConfig(**dict(ECFG, kv_pool_slots=1024, max_requests=16,
                               max_context_len=128))
    prompt = list(range(7, 27))
    calls = [(attn_estimates, dict(cfg=PRESETS["tiny"], ecfg=ecfg, prompt=prompt, gen=8,
                                   measure_attention=m, seed=3)) for m in (True, None)]
    (tokens, ranks), (tokens_off, ranks_off) = launch(run_all, (1, 2, 1), "cpu",
                                                      args=(calls,), timeout=300)
    single = ModelRunner(PRESETS["tiny"], ecfg, device="cpu", seed=3)
    tree_generate(single, mode_from_cli("flatten"), None, prompt,
                  max_seq_len=len(prompt) + 8, width=3, depth=1,
                  branch_controller=Branch_Controller(workloads.simple_tree))
    want = sorted(tuple(s.token_ids) for s in single.tree.all_finished_seqs)
    assert sorted(tokens) == sorted(tokens_off) == want
    keys = [r[0] for r in ranks]
    assert keys[0] and all(k == keys[0] for k in keys)
    for _, comp, mem, estimate in ranks:
        assert estimate and len(comp) == 7 and all(v > 0 for v in comp)
    for keys_off, comp, mem, estimate in ranks_off:
        assert not keys_off and not estimate and not any(comp) and not any(mem)


def test_cpu_default_is_off(reference):
    """measure_attention=None on the CPU measures nothing, in both packages
    (deft_tpu: on for its TPU only): the attention fields stay 0."""
    _, params = reference
    runner = port_runner(params)
    assert runner.measure_attention is False
    pm = tree_generate(runner, mode_from_cli("flatten"), None, PROMPT,
                       branch_controller=Branch_Controller(workloads.simple_tree), **RUN)
    assert not JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG),
                       kernels="xla", seed=0).measure_attention
    assert pm.attention_latency == 0 and not pm.attn_is_estimate
    assert len(pm.attn_comp_per_iter) == RUN["max_seq_len"] - len(PROMPT) - 1
    assert not any(pm.attn_comp_per_iter) and not any(pm.attn_mem_per_iter)
    assert runner.last_attn_estimate is None and not runner._attn_bench_cache


BENCH_ECFG = dict(kv_pool_slots=4096, max_requests=32, max_context_len=2048,
                  min_token_bucket=1024, dtype="float32")


@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_block_len_1024_tokens_match_deft_tpu(reference, mode):
    """bench.py's plans (BLOCK_LEN 1024, bench.py:51): the port's tokens on
    a 1500-token prompt equal deft_tpu's, and its flatten plans are paged
    at that block length (seq: deft_tpu's CPU route gathers, the port
    reads the paged plan)."""
    jr, params = reference
    prompt = [int(t) for t in np.random.default_rng(1).integers(4, 500, 1500)]
    run = dict(max_seq_len=len(prompt) + 6, width=3, depth=1)
    jr2 = JRunner(JPRESETS["tiny"],
                  JEngineConfig(attention=JAttentionConfig(block_len=1024), **BENCH_ECFG),
                  kernels="xla", params=jr.params)
    j_tree_generate(jr2, j_mode(mode), None, prompt,
                    branch_controller=JController(jworkloads.simple_tree), **run)
    runner = ModelRunner(PRESETS["tiny"],
                         EngineConfig(attention=AttentionConfig(block_len=1024),
                                      **BENCH_ECFG), device="cpu", params=params)
    plans = []
    build = runner.build_plan

    def recording(m):
        plans.append(build(m))
        return plans[-1]

    runner.build_plan = recording
    tree_generate(runner, mode_from_cli(mode), None, prompt,
                  branch_controller=Branch_Controller(workloads.simple_tree), **run)
    assert branches(runner.tree) == branches(jr2.tree)
    assert plans and all(p.paged for p in plans)
    if mode == "flatten":
        assert all(p.block_len == 1024 for p in plans)


class Clock:
    """The generation loop's clock, 40 s later at every reading."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 40.0
        return self.t


def test_progress_beat_and_partial_dump(reference, monkeypatch, tmp_path, capsys):
    """Past 60 s on the loop's clock the loop prints a progress line to
    stderr and writes ``<output>.partial`` (deft_tpu generate.py:270-296):
    deft_tpu's PerfMetrics.dump_partial keys, "partial" true, no temporary
    file left; the final dump still goes to the output file."""
    _, params = reference
    monkeypatch.setattr(tgenerate, "time", Clock())
    out = tmp_path / "pm.json"
    tree_generate(port_runner(params), mode_from_cli("flatten"), None, PROMPT,
                  output_file=str(out),
                  branch_controller=Branch_Controller(workloads.simple_tree), **RUN)
    assert "[tree_generate] iter 2/" in capsys.readouterr().err
    partial = json.loads((tmp_path / "pm.json.partial").read_text())
    jout = tmp_path / "deft.json"
    JPerfMetrics(str(jout)).dump_partial()
    want = json.loads((tmp_path / "deft.json.partial").read_text())
    assert set(partial) == set(want) and partial["partial"] is True
    assert partial["generated_len"] > 0 and len(partial["iter_time"]) > 0
    assert "partial" not in json.loads(out.read_text())
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "deft.json.partial", "pm.json", "pm.json.partial"]
