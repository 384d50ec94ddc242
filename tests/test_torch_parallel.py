"""deft_tpu_torch's multi-device engine with real ranks: spawned processes
over gloo on the CPU (parallel/launch.py), held against deft_tpu's
single-device runs (tests/test_multichip.py's workloads).

- tiny at fp32 on grids 1x2x2 and 2x2x1: flatten and seq tokens equal
  deft_tpu's single-device tree_generate;
- the first decode step over fp32 pools at prompt 400 and over int8 KV at
  prompt 1600 (segment-aligned plans, the partial paged kernels' plain
  versions on each rank): ids equal, probabilities at rtol 1e-4;
- MoE tiny (4 experts, a 520-token prompt: the expert-parallel grouped
  route at prefill) on 1x2x2: tokens equal;
- int8 and int8-pallas weights on 1x2x2 (row-parallel codes cut, their
  scales whole): tokens equal;
- every other decode mode (node, node_chunk, tree_index, unpaged flatten,
  node and seq, Medusa) on both grids: tokens equal deft_tpu's
  single-device run in that mode;
- the batched engine on both grids (three requests of unequal prompts, one
  ragged prefill, multi-tree steps, the all-greedy ones chained) in
  flatten, node and seq: tokens equal deft_tpu's single-device
  BatchedEngine;
- dryrun_multichip for 1, 2 and 4 ranks; the CLI's --mesh 1x2x2 (also
  with --batch 2, and --mode node on 1x2x1), and --multihost under
  torchrun.

Each grid is launched once for all its cases (a module fixture), the
worker functions living in the package: a spawned rank never imports a
test module, whose conftest imports jax.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from deft_tpu.config import AttentionConfig as JAttentionConfig
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.runtime import ForwardMode as JMode
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu.runtime.batched import BatchedEngine as JEngine
from deft_tpu.runtime.batched import Request as JRequest
from deft_tpu_torch.config import AttentionConfig, EngineConfig
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.parallel import dryrun_multichip, launch
from deft_tpu_torch.parallel.launch import (batched_tokens, first_step, generate_tokens,
                                            run_all)
from deft_tpu_torch.runtime.generate import sync_period

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEN = dict(kv_pool_slots=1024, max_requests=16, max_context_len=128,
           min_token_bucket=128, dtype="float32")
GEN_PROMPT = list(range(7, 27))
STEP = {"inherit": (400, dict(kv_pool_slots=8192, max_requests=16, max_context_len=2048,
                              min_token_bucket=128, dtype="float32")),
        "int8": (1600, dict(kv_pool_slots=8192, max_requests=16, max_context_len=2048,
                            min_token_bucket=128, dtype="float32", kv_dtype="int8"))}
MOE = dataclasses.replace(PRESETS["tiny"], num_experts=4, experts_per_tok=2)
MOE_ECFG = dict(kv_pool_slots=2048, max_requests=16, max_context_len=640,
                min_token_bucket=128, dtype="float32")
MOE_PROMPT = [7 + (i % 401) for i in range(520)]
MODES = {"flatten": JMode.TREE_DECODE_FLATTEN, "seq": JMode.DECODE}
WEIGHTS = ("int8", "int8-pallas")
# the other decode modes, by the CLI's --mode, --mem and --node_chunk_len
# (tests/test_torch_modes.py's), over GEN_PROMPT at width 6: 8 rows, so
# grid 2x2x1's second dp window holds live leaves (4 and 5)
OTHER_MODES = {"node": ("node", "paged", None), "node_chunk": ("node_chunk", "paged", 8),
               "tree_index": ("tree_index", "paged", None),
               "unpaged flatten": ("flatten", "unpaged", None),
               "unpaged node": ("node", "unpaged", None),
               "unpaged seq": ("seq", "unpaged", None), "medusa": ("tree", "unpaged", None)}
MODE_WIDTH = 6
# the batched engine: three requests of unequal prompts, width 3 (leaf
# offsets 0, 3, 6 in 16 rows: grid 2x2x1's second dp window starts inside
# the third tree's leaves), sync_period() + 2 tokens each (one 8-step wait
# of the all-greedy fast path); the flatten-family plans are gather plans
# (B11) at the first steps and segment-aligned (B1p) at the last, the seq
# plans segment-aligned (B2p)
BATCH = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
             min_token_bucket=128, dtype="float32")
BATCH_PROMPTS = [[7 + (i * 7 + j) % 401 for j in range(n)]
                 for i, n in enumerate((256, 160, 128))]
BATCH_GEN = sync_period() + 2
BATCH_MODES = ("flatten", "node", "seq")
# over int8 KV on grid 1x2x2 (the batched engine's int8 rule: 128-token
# segments; the windows run B11's int8 form and B5p)
BATCH_INT8 = ("flatten", "seq")


def step_prompt(n):
    return [7 + (i % 97) for i in range(n)]


def cases(grid_name):
    """The (worker, kwargs) calls one launch of a grid runs, keyed."""
    tiny = PRESETS["tiny"]
    out = {}
    for mode in MODES:
        out[f"gen {mode}"] = (generate_tokens, dict(
            cfg=tiny, ecfg=EngineConfig(**GEN), prompt=GEN_PROMPT, mode=mode,
            width=3, max_seq_len=32, seed=3))
        out[f"step inherit {mode}"] = (first_step, dict(
            cfg=tiny, ecfg=EngineConfig(**STEP["inherit"][1]),
            prompt=step_prompt(STEP["inherit"][0]), mode=mode))
    for name, (mode, mem, chunk) in OTHER_MODES.items():
        out[f"mode {name}"] = (generate_tokens, dict(
            cfg=tiny, ecfg=EngineConfig(**GEN, attention=AttentionConfig(
                node_chunk_len=chunk)),
            prompt=GEN_PROMPT, mode=mode, mem=mem, width=MODE_WIDTH, max_seq_len=32,
            seed=3))
    for mode in BATCH_MODES:
        out[f"batch {mode}"] = (batched_tokens, dict(
            cfg=tiny, ecfg=EngineConfig(**BATCH), prompts=BATCH_PROMPTS, mode=mode,
            width=3, gen=BATCH_GEN, seed=3))
    if grid_name == "1x2x2":
        for mode in BATCH_INT8:
            out[f"batch int8 {mode}"] = (batched_tokens, dict(
                cfg=tiny, ecfg=EngineConfig(**BATCH, kv_dtype="int8"), prompts=BATCH_PROMPTS,
                mode=mode, width=3, gen=BATCH_GEN, seed=3))
        for mode in MODES:
            out[f"step int8 {mode}"] = (first_step, dict(
                cfg=tiny, ecfg=EngineConfig(**STEP["int8"][1]),
                prompt=step_prompt(STEP["int8"][0]), mode=mode))
        out["moe"] = (generate_tokens, dict(
            cfg=MOE, ecfg=EngineConfig(**MOE_ECFG), prompt=MOE_PROMPT, mode="flatten",
            width=3, max_seq_len=len(MOE_PROMPT) + 12, seed=3))
        for wdt in WEIGHTS:
            out[f"gen {wdt}"] = (generate_tokens, dict(
                cfg=tiny, ecfg=EngineConfig(**GEN, weight_dtype=wdt), prompt=GEN_PROMPT,
                mode="flatten", width=3, max_seq_len=32, seed=3))
    return out


def run_grid(name, shape):
    calls = cases(name)
    got = launch(run_all, shape, "cpu", args=(list(calls.values()),), timeout=600)
    return dict(zip(calls, got))


@pytest.fixture(scope="module")
def grid_1x2x2():
    return run_grid("1x2x2", (1, 2, 2))


@pytest.fixture(scope="module")
def grid_2x2x1():
    return run_grid("2x2x1", (2, 2, 1))


def j_generate(cfg, ecfg, prompt, mode, max_seq_len, **kw):
    runner = JRunner(cfg, JEngineConfig(**ecfg, **kw), kernels="xla", seed=3)
    j_tree_generate(runner, MODES[mode], None, prompt, max_seq_len=max_seq_len, width=3,
                    depth=0, branch_controller=JController(jworkloads.simple_tree))
    return [tuple(s.token_ids) for s in runner.tree.all_finished_seqs]


def j_mode_generate(mode, mem, chunk):
    """deft_tpu's single-device Simple_Tree run in a CLI mode (for Medusa
    without decode windows, DEFT_PLAN_PATCH=0; the port's grids run every
    step per step, and the tokens are the same on every path)."""
    ecfg = JEngineConfig(**GEN, attention=JAttentionConfig(node_chunk_len=chunk))
    with pytest.MonkeyPatch.context() as mp:
        if mode == "tree":
            mp.setenv("DEFT_PLAN_PATCH", "0")
        runner = JRunner(JPRESETS["tiny"], ecfg, kernels="xla", seed=3,
                         use_tree_index=mode == "tree_index")
    j_tree_generate(runner, j_mode(mode, mem), None, GEN_PROMPT, max_seq_len=32,
                    width=MODE_WIDTH, depth=0,
                    branch_controller=JController(jworkloads.simple_tree))
    return [tuple(s.token_ids) for s in runner.tree.all_finished_seqs]


def j_batched(mode, **kw):
    """deft_tpu's single-device BatchedEngine on BATCH_PROMPTS."""
    runner = JRunner(JPRESETS["tiny"], JEngineConfig(**BATCH, **kw), kernels="xla", seed=3)
    eng = JEngine(runner, mode=j_mode(mode))
    reqs = [JRequest(p, JController(jworkloads.simple_tree), len(p) + BATCH_GEN, width=3)
            for p in BATCH_PROMPTS]
    eng.add_requests(reqs)
    eng.run()
    return [sorted(tuple(s.token_ids) for s in r.finished_seqs) for r in reqs]


def j_first_step(kv, mode):
    """deft_tpu's single-chip first step (its int8 reference runs the
    Pallas kernels, as test_sharded_paged_dma_kernel_matches_single_device
    does)."""
    n, ecfg = STEP[kv]
    runner = JRunner(JPRESETS["tiny"], JEngineConfig(**ecfg),
                     kernels="pallas" if kv == "int8" else "xla", seed=0)
    runner.forward_prefill(step_prompt(n))
    tree = runner.tree
    for i, c in enumerate(tree.branch(tree.root, 5)):
        c.append_token(100 + i)
    tree.alloc()
    plan = runner.build_plan(MODES[mode])
    view, _ = runner.forward_tree_decode(MODES[mode], plan)
    return np.asarray(view.ids[:5]), np.asarray(view.vals[:5])


@pytest.fixture(scope="module")
def reference():
    out = {f"gen {m}": j_generate(JPRESETS["tiny"], GEN, GEN_PROMPT, m, 32) for m in MODES}
    for kv in STEP:
        for m in MODES:
            out[f"step {kv} {m}"] = j_first_step(kv, m)
    jmoe = dataclasses.replace(JPRESETS["tiny"], num_experts=4, experts_per_tok=2)
    out["moe"] = j_generate(jmoe, MOE_ECFG, MOE_PROMPT, "flatten", len(MOE_PROMPT) + 12)
    for wdt in WEIGHTS:
        out[f"gen {wdt}"] = j_generate(JPRESETS["tiny"], GEN, GEN_PROMPT, "flatten", 32,
                                       weight_dtype=wdt)
    for name, spec in OTHER_MODES.items():
        out[f"mode {name}"] = j_mode_generate(*spec)
    for mode in BATCH_MODES:
        out[f"batch {mode}"] = j_batched(mode)
    for mode in BATCH_INT8:
        out[f"batch int8 {mode}"] = j_batched(mode, kv_dtype="int8")
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", ["grid_1x2x2", "grid_2x2x1"])
def test_grid_generation_matches_deft_tpu(grid, mode, reference, request):
    tokens, _ = request.getfixturevalue(grid)[f"gen {mode}"]
    want = reference[f"gen {mode}"]
    assert len(want) == 3 and tokens == want


@pytest.mark.parametrize("name", list(OTHER_MODES))
@pytest.mark.parametrize("grid", ["grid_1x2x2", "grid_2x2x1"])
def test_grid_mode_matches_deft_tpu(grid, name, reference, request):
    """node, node_chunk and tree_index plans (node-aligned flatten plans)
    and the unpaged flatten and node modes through the rank windows of
    B1p / B11; unpaged seq through B7 on the rank's heads; Medusa's dense
    baseline on the rank's heads, every row."""
    tokens, paged = request.getfixturevalue(grid)[f"mode {name}"]
    want = reference[f"mode {name}"]
    assert len(want) == MODE_WIDTH and tokens == want
    assert len(paged) == 31 - len(GEN_PROMPT)


@pytest.mark.parametrize("mode", BATCH_MODES)
@pytest.mark.parametrize("grid", ["grid_1x2x2", "grid_2x2x1"])
def test_grid_batched_engine_matches_deft_tpu(grid, mode, reference, request):
    """BatchedEngine on the grid: the ragged prefill on each rank's heads,
    multi-tree plans cut into the rank windows (a dp window starts inside
    a tree's leaves), the all-greedy steps chained without a wait."""
    tokens, steps = request.getfixturevalue(grid)[f"batch {mode}"]
    want = reference[f"batch {mode}"]
    assert tokens == want
    assert all(len(b) == 3 and all(len(t) == BATCH_GEN - 1 for t in b) for b in tokens)
    assert sum(not block for block, _ in steps) == len(steps) - 1
    layouts = {paged for _, paged in steps}
    assert layouts == ({True} if mode == "seq" else {True, False})


@pytest.mark.parametrize("mode", BATCH_INT8)
def test_grid_batched_engine_int8_kv_matches_deft_tpu(grid_1x2x2, reference, mode):
    """The batched engine over int8 KV on grid 1x2x2: the multi-tree
    flatten plans under the batched int8 rule (128-token segments) are
    gather plans here, so the windows run B11's int8 form; the seq plans
    are segment-aligned, so B5p."""
    tokens, steps = grid_1x2x2[f"batch int8 {mode}"]
    assert tokens == reference[f"batch int8 {mode}"]
    assert all(len(b) == 3 and all(len(t) == BATCH_GEN - 1 for t in b) for b in tokens)
    assert {paged for _, paged in steps} == {mode == "seq"}


@pytest.mark.parametrize("kv,grid", [("inherit", "grid_1x2x2"), ("inherit", "grid_2x2x1"),
                                     ("int8", "grid_1x2x2")])
@pytest.mark.parametrize("mode", list(MODES))
def test_grid_first_step_matches_deft_tpu(kv, grid, mode, reference, request):
    """Segment-aligned plans: every rank runs the partial paged kernel
    (B1p / B4p, B2p / B5p) on its window; ids equal, probabilities to
    rtol 1e-4."""
    paged, ids, vals = request.getfixturevalue(grid)[f"step {kv} {mode}"]
    want_ids, want_vals = reference[f"step {kv} {mode}"]
    assert paged, "the first step's plan must be segment-aligned here"
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-4, atol=1e-6)


def test_grid_moe_generation_matches_deft_tpu(grid_1x2x2, reference):
    """Experts over sp (2 a rank), their inner dims over tp; the 520-token
    prefill takes the expert-parallel grouped route."""
    from deft_tpu_torch.parallel.mesh import Grid
    from deft_tpu_torch.parallel.moe import sharded_gmm_ok

    import torch

    grid = Grid((1, 2, 2), 0, torch.device("cpu"))
    assert sharded_gmm_ok(grid, MOE, len(MOE_PROMPT))
    assert not sharded_gmm_ok(grid, MOE, 3)  # decode widths: the dense route
    tokens, _ = grid_1x2x2["moe"]
    assert len(tokens) == 3 and tokens == reference["moe"]


@pytest.mark.parametrize("wdt", WEIGHTS)
def test_grid_int8_weight_generation_matches_deft_tpu(grid_1x2x2, reference, wdt):
    tokens, _ = grid_1x2x2[f"gen {wdt}"]
    assert len(tokens) == 3 and tokens == reference[f"gen {wdt}"]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip(n):
    dryrun_multichip(n, device="cpu")


def test_cli_mesh_prints_the_single_process_tokens():
    base = [sys.executable, "-m", "deft_tpu_torch.cli.run", "--device", "cpu",
            "--random-model", "tiny", "--mode", "flatten", "--max_width", "3",
            "--max_seq_len", "40", "--dtype", "float32", "--kv_pool_slots", "4096",
            "--print-branches"]

    def tokens(extra):
        out = subprocess.run(base + extra, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, (
            f"rc {out.returncode}\nstderr head:\n{out.stderr[:2000]}\n"
            f"stderr tail:\n{out.stderr[-2000:]}")
        lines = [x for x in out.stdout.splitlines() if "Tokens in this path" in x]
        assert out.stdout.count("Generation starts with arguments") == 1
        return lines

    single = tokens([])
    assert len(single) == 3
    assert tokens(["--mesh", "1x2x2"]) == single
    # one rank of a torchrun job each (--multihost reads its environment)
    base[1:3] = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                 "-m", "deft_tpu_torch.cli.run"]
    assert tokens(["--multihost", "--mesh", "1x1x2"]) == single


@pytest.mark.parametrize("argv", [(["--batch", "2", "--mode", "flatten"], "1x2x2"),
                                  (["--mode", "node"], "1x2x1")],
                         ids=["batch 2 on 1x2x2", "node on 1x2x1"])
def test_cli_mesh_batch_and_modes_print_the_single_process_tokens(argv):
    """--batch 2 on grid 1x2x2 (rank 0 prints each request's branches) and
    --mode node on grid 1x2x1 print the single process's tokens."""
    base = [sys.executable, "-m", "deft_tpu_torch.cli.run", "--device", "cpu",
            "--random-model", "tiny", "--max_width", "3", "--max_seq_len", "40",
            "--dtype", "float32", "--kv_pool_slots", "4096", "--print-branches"]
    extra, mesh = argv

    def tokens(args):
        out = subprocess.run(base + extra + args, cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, (
            f"rc {out.returncode}\nstderr head:\n{out.stderr[:2000]}\n"
            f"stderr tail:\n{out.stderr[-2000:]}")
        assert out.stdout.count("Generation starts with arguments") == 1
        return [x for x in out.stdout.splitlines()
                if "Tokens in this path" in x or x.startswith("req ")]

    single = tokens([])
    assert len(single) == (6 if "--batch" in extra else 3)
    assert tokens(["--mesh", mesh]) == single


def test_refusals():
    """nccl with more ranks than cards names gloo; a grid that does not
    split the KV heads and tree_index in the batched engine are refused;
    the batched engine runs on a grid."""
    import torch

    from deft_tpu_torch.parallel.mesh import Grid
    from deft_tpu_torch.parallel.multihost import check_backend
    from deft_tpu_torch.runtime import ForwardMode, ModelRunner
    from deft_tpu_torch.runtime.batched import BatchedEngine

    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="KV heads"):
        ModelRunner(PRESETS["tiny"], EngineConfig(**GEN), device="cpu",
                    mesh=Grid((1, 1, 4), 0, torch.device("cpu")))
    runner = ModelRunner(PRESETS["tiny"], EngineConfig(**GEN), device="cpu",
                         mesh=Grid((1, 1, 1), 0, torch.device("cpu")))
    assert runner.mesh is None  # a grid of size 1 is no mesh
    BatchedEngine(runner)
    runner.mesh = Grid((1, 2, 1), 0, torch.device("cpu"))
    for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.TREE_DECODE_NODE,
                 ForwardMode.DECODE):
        assert BatchedEngine(runner, mode).runner.mesh is runner.mesh
    with pytest.raises(ValueError, match="flatten, node or seq"):
        BatchedEngine(runner, ForwardMode.TREE_DECODE_INDEX_NODE)
