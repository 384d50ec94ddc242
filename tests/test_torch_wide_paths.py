"""deft_tpu_torch's served paths at head_dim 96 (Phi-3-mini) and 256 (Gemma)
beyond a single tree, held against deft_tpu on the CPU.

At those widths a head's row does not pack into 128 lanes, so both
packages build gather plans and run every decode step through B6 and B7
(tests/test_torch_headdim.py holds a single tree).  Here, at the ``tiny``
preset's widths with head_dim 96 and 256 and 4 / 2 heads:

- BatchedEngine emits deft_tpu's BatchedEngine ids in flatten and seq over
  fp32 and int8 KV, every step through the gather kernels;
- the batched admission's B8 inputs (three prompts joined, each ending
  inside a 64-token tile) through the port's plain B8 against deft_tpu's
  ``ragged_prefill_attn_pallas`` in interpret mode, fp32 and bf16;
- gloo grids 2x1x2 and 1x2x2 emit the single process's tokens and
  deft_tpu's on its mesh of the same shape (8 host devices) in flatten and
  seq over fp32 KV and in flatten over int8 KV.

Tolerances: fp32 2e-5, bf16 2e-2 (tests/test_kernels.py's bounds), live
rows; token ids equal.
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
from deft_tpu.ops.prefill import ragged_prefill_attn_pallas as j_ragged
from deft_tpu.parallel.mesh import make_mesh as j_make_mesh
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu.runtime.batched import BatchedEngine as JEngine
from deft_tpu.runtime.batched import Request as JRequest
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.core import TreeCache
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.ops import attn_impls
from deft_tpu_torch.parallel import launch
from deft_tpu_torch.parallel.launch import generate_tokens, run_all
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli
from deft_tpu_torch.runtime.batched import BatchedEngine, Request

WIDTHS = [96, 256]
KV = ["inherit", "int8"]
MODES = ["flatten", "seq"]
Hq, Hkv = 4, 2
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
# three prompts whose ends fall inside 64-token tiles (100, 175 and 220 of
# the joined 220 tokens)
PROMPTS = [[7 + (i * 13 + j) % 401 for j in range(n)] for i, n in enumerate((100, 75, 45))]
WIDTH, GEN = 2, 9
# the grids' run: tests/test_torch_parallel.py's GEN and GEN_PROMPT
GRID_ECFG = dict(kv_pool_slots=1024, max_requests=16, max_context_len=128,
                 min_token_bucket=128, dtype="float32")
GRID_PROMPT = list(range(7, 27))
GRIDS = {"2x1x2": (2, 1, 2), "1x2x2": (1, 2, 2)}
GRID_CASES = [("flatten", "inherit"), ("seq", "inherit"), ("flatten", "int8")]


def config(D, jax_side=False):
    base = (JPRESETS if jax_side else PRESETS)["tiny"]
    return dataclasses.replace(base, head_dim=D, num_q_heads=Hq, num_kv_heads=Hkv)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


def engine_ids(engine_cls, request_cls, ctl_cls, policy, runner, mode):
    eng = engine_cls(runner, mode=mode)
    reqs = [request_cls(p, ctl_cls(policy), len(p) + GEN, width=WIDTH) for p in PROMPTS]
    eng.add_requests(reqs)
    eng.run()
    return [sorted(tuple(s.token_ids) for s in r.finished_seqs) for r in reqs]


# -- the batched engine ------------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", WIDTHS)
def test_batched_engine_matches_deft_tpu(D, mode, kv):
    """deft_tpu's BatchedEngine (its CPU XLA attention) and the port's on
    the same weights: equal branch tokens per request; every port step
    through the gather kernels (B6 / B7), over fp32 and int8 pools."""
    jr = JRunner(config(D, True), JEngineConfig(**ECFG, kv_dtype=kv), kernels="xla",
                 seed=0)
    want = engine_ids(JEngine, JRequest, JController, jworkloads.simple_tree, jr,
                      j_mode(mode))
    params = params_from_numpy({k: np.asarray(v) for k, v in jr.params.items()},
                               config(D), "cpu", torch.float32)
    tr = ModelRunner(config(D), EngineConfig(**ECFG, kv_dtype=kv), device="cpu",
                     params=params)
    paged = []
    pick = tr._attn_fn
    tr._attn_fn = lambda m, p: paged.append(p) or pick(m, p)
    got = engine_ids(BatchedEngine, Request, Branch_Controller, workloads.simple_tree, tr,
                     mode_from_cli(mode))
    assert got == want
    assert all(len(b) == WIDTH and all(len(t) == GEN - 1 for t in b) for b in got)
    assert paged and not any(paged)


# -- B8 in the batched admission -----------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", WIDTHS)
def test_admission_b8_plain_matches_deft_tpu(D, dt, monkeypatch):
    """Every layer's ragged attention of forward_prefill_batch (q, k, v and
    the segment ids as the admission builds them) through the port's plain
    B8 against deft_tpu's Pallas kernel in interpret mode on the same
    inputs; the joined prompts end inside 64-token tiles."""
    jdt, tdt, tol = DTYPES[dt]
    runner = ModelRunner(config(D), EngineConfig(**ECFG | {"dtype": dt}), device="cpu")
    calls = []
    attn = attn_impls.ragged_prefill_attn

    def recording(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
        o = attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale)
        calls.append((q, k_new, v_new, batch.seg_ids, scale, o))
        return o

    monkeypatch.setattr(attn_impls, "ragged_prefill_attn", recording)
    trees = [TreeCache(runner.token_to_kv_pool, runner.req_to_token_pool) for _ in PROMPTS]
    runner.forward_prefill_batch(PROMPTS, trees)
    assert len(calls) == runner.cfg.num_layers
    ends = np.cumsum([len(p) for p in PROMPTS])
    assert all(e % 64 for e in ends)
    for q, k, v, seg, scale, o in calls:
        assert o.dtype == tdt and q.shape == (ends[-1], Hq, D)
        np.testing.assert_array_equal(seg.numpy(), np.repeat(np.arange(3), np.diff(ends,
                                                                                prepend=0)))
        # deft_tpu's kernel takes the joined tokens padded to its 128-token
        # bucket, pads at segment -1 (the port runs the true count)
        n = len(seg)
        jq, jk, jv = (jnp.asarray(np.pad(t.float().numpy(), ((0, 256 - n), (0, 0), (0, 0))),
                                  jdt) for t in (q, k, v))
        jseg = jnp.asarray(np.pad(seg.numpy(), (0, 256 - n), constant_values=-1))
        want = j_ragged(jq, jk, jv, None, None, 0, SimpleNamespace(seg_ids=jseg), scale)
        assert rel_err(o.float().numpy(), np.asarray(want, np.float32)[:n]) < tol


# -- grids -----------------------------------------------------------------------------

def grid_calls():
    """The worker calls of one grid launch, keyed (D, mode, kv)."""
    return {(D, mode, kv): (generate_tokens, dict(
        cfg=config(D), ecfg=EngineConfig(**GRID_ECFG, kv_dtype=kv), prompt=GRID_PROMPT,
        mode=mode, width=3, max_seq_len=32, seed=3))
        for D in WIDTHS for mode, kv in GRID_CASES}


@pytest.fixture(scope="module")
def grid_tokens():
    """{grid: {(D, mode, kv): tokens}}: one gloo launch a grid, and the
    single process's runs ("1x1x1")."""
    calls = grid_calls()
    out = {}
    for name, shape in ({"1x1x1": (1, 1, 1)} | GRIDS).items():
        got = launch(run_all, shape, "cpu", args=(list(calls.values()),), timeout=600)
        out[name] = {key: tokens for key, (tokens, _) in zip(calls, got)}
    return out


def j_mesh_tokens(D, shape, mode, kv):
    """deft_tpu's tokens on its (dp, sp, tp) mesh of 4 host devices."""
    mesh = j_make_mesh(4, shape=shape, num_kv_heads=Hkv)
    runner = JRunner(config(D, True), JEngineConfig(**GRID_ECFG, kv_dtype=kv),
                     kernels="xla", seed=3, mesh=mesh)
    j_tree_generate(runner, j_mode(mode), None, GRID_PROMPT, max_seq_len=32, width=3,
                    depth=0, branch_controller=JController(jworkloads.simple_tree))
    return [tuple(s.token_ids) for s in runner.tree.all_finished_seqs]


@pytest.mark.parametrize("case", GRID_CASES, ids=["flatten", "seq", "flatten-int8-kv"])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_matches_single_process_and_deft_tpu_mesh(grid_tokens, grid, D, case):
    """The grid's branches (B11 on gather flatten plans, B7 on the rank's
    heads for gather seq plans) equal the single process's and deft_tpu's
    on its mesh of the same shape."""
    mode, kv = case
    got = grid_tokens[grid][D, mode, kv]
    assert len(got) == 3 and got == grid_tokens["1x1x1"][D, mode, kv]
    assert got == j_mesh_tokens(D, GRIDS[grid], mode, kv)
