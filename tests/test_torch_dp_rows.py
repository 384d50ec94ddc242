"""deft_tpu's batch layout on a grid (deft_tpu/parallel/sharding.py:121-182)
in deft_tpu_torch: a decode step's rows over dp, a prefill's tokens over
sp, the MoE block on its dp rows.  Spawned gloo ranks on the CPU, fp32.

- the batch specs equal deft_tpu's ``batch_shardings``; a ragged batch has
  none; ``RowWindow`` cuts and joins rows exactly;
- one decode step laid out by ``shard_decode_args`` on grids 2x1x1, 2x2x1,
  2x1x2 and 4x1x1 against deft_tpu's single-device ``decode_forward`` on
  the same numpy weights, pools and plan, cut to R = 5 rows (a multiple
  of no dp here): a paged flatten plan (B1p), a paged seq plan (B2p) and a
  seq plan that is not segment-aligned (B7 on the rank's rows).  The
  tolerance is test_torch_parallel.py's test_grid_first_step_matches_
  deft_tpu's: top ids equal, probabilities (softmax + 1e-6) at rtol 1e-4,
  atol 1e-6.  After the step every pool slot but DUMP_SLOT equals
  deft_tpu's: exactly where the step wrote nothing, the step's new K/V
  rows within 1e-4 of the largest of them (test_torch_model.py's
  measure), so no pad row lands in a live slot; each rank ran ceil(R /
  dp) rows through the dense layers;
- the CLI's --mesh 2x1x1 and 2x1x2 print the single process's tokens.

Grids 2x1x1 and 4x1x1 run here, 2x2x1 and 2x1x2 (with the runner's
tokens and counted rows) in tests/test_torch_dp_tokens.py, so that the two
files run side by side.  Workers live in the package (parallel/launch.py):
a spawned rank never imports a test module.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.models.llama import DecodeBatch as JDecodeBatch
from deft_tpu.models.llama import KVPool as JKVPool
from deft_tpu.models.llama import SeqBatch as JSeqBatch
from deft_tpu.models.llama import decode_forward as j_decode_forward
from deft_tpu.models.loader import random_params as j_random_params
from deft_tpu.models.rope import apply_rope as j_apply_rope
from deft_tpu.models.rope import rope_table as j_rope_table
from deft_tpu.ops import attn_impls as j_attn
from deft_tpu.ops.paged_seq_attn import paged_seq_attn_pallas as j_paged_seq
from deft_tpu.parallel.sharding import batch_shardings as j_batch_shardings
from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache
from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.parallel import launch
from deft_tpu_torch.parallel.launch import run_all, spec_step
from deft_tpu_torch.parallel.mesh import Grid
from deft_tpu_torch.parallel.sharding import batch_shardings, row_window
from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC_GRIDS = {"2x1x1": (2, 1, 1), "2x2x1": (2, 2, 1), "2x1x2": (2, 1, 2),
              "4x1x1": (4, 1, 1)}
HERE = ("2x1x1", "4x1x1")  # tests/test_torch_dp_tokens.py runs the others
ROUTES = ("flatten", "seq", "seq gather")
SEQ_TABLES = ("seg_src", "seg_off", "seg_live", "blk_live")
STEP_PROMPT, STEP_WIDTH, STEP_BLOCK, STEP_SLOTS = 400, 5, 128, 1024
PROB_RTOL, PROB_ATOL = 1e-4, 1e-6  # test_grid_first_step_matches_deft_tpu's
POOL_TOL = 1e-4  # the new K/V rows, relative to the largest (test_torch_model.py's)


# -- the specs and the row windows --------------------------------------------------

def test_batch_specs_equal_deft_tpu():
    """Each batch kind's specs, array by array, equal deft_tpu's
    batch_shardings on a (dp, sp, tp) CPU mesh; a ragged batch has none."""
    from deft_tpu.models.llama import PrefillBatch as JPrefillBatch
    from deft_tpu.models.llama import RaggedPrefillBatch as JRagged
    from deft_tpu.parallel.mesh import make_mesh as j_make_mesh

    mesh = j_make_mesh(8, shape=(2, 2, 2))
    a = np.zeros(4, np.int32)
    batches = {"DecodeBatch": JDecodeBatch(a, a, a, a, a, a, a, a, seg_src=a),
               "SeqBatch": JSeqBatch(a, a, a, a.reshape(2, 2), a, a, a, a, a),
               "PrefillBatch": JPrefillBatch(a, a, a, a)}
    for kind, batch in batches.items():
        want = {k: tuple(s.spec) for k, s in j_batch_shardings(mesh, batch)._asdict().items()}
        got = batch_shardings(kind)
        assert set(got) == set(want), kind
        for k, spec in got.items():
            # PartitionSpec drops trailing Nones: P(None) == P()
            assert tuple(x for x in spec if x) == tuple(x for x in want[k] if x), (kind, k)
    with pytest.raises(TypeError):
        j_batch_shardings(mesh, JRagged(a, a, a, a, a))
    with pytest.raises(TypeError):
        batch_shardings("RaggedPrefillBatch")


@pytest.mark.parametrize("axis,size,n", [("dp", 2, 5), ("dp", 4, 5), ("dp", 2, 64),
                                         ("sp", 2, 400), ("sp", 4, 401)])
def test_row_window_cuts_and_joins_rows_exactly(axis, size, n):
    """The windows of n rows over an axis of ``size`` ranks cover the rows
    once, padded to n_pad = size * ceil(n / size); joining the windows
    (their zero-padded buffers summed) gives back the rows exactly, and a
    numpy cut equals the tensor one."""
    shape = {"dp": (size, 1, 1), "sp": (1, size, 1)}[axis]
    x = torch.randn(n, 3, dtype=torch.float64)
    wins = [row_window(Grid(shape, r, torch.device("cpu")), axis, n) for r in range(size)]
    rows = -(-n // size)
    assert all(w.rows == rows and w.n_pad == rows * size and w.r0 == i * rows
               for i, w in enumerate(wins))
    parts = [w.take(x) for w in wins]
    assert all(p.shape == (rows, 3) for p in parts)
    np.testing.assert_array_equal(wins[-1].take(x.numpy()), parts[-1].numpy())
    total = torch.zeros(rows * size, 3, dtype=torch.float64)
    for w, p in zip(wins, parts):
        total[w.r0:w.r0 + w.rows] += p
    assert torch.equal(total[:n], x) and torch.count_nonzero(total[n:]) == 0
    for w, p in zip(wins, parts):  # join on one rank: the others' windows summed in
        others = total.clone()
        others[w.r0:w.r0 + w.rows] = 0
        w = dataclasses.replace(w, grid=_Summing(w.grid, others))
        assert torch.equal(w.join(p), x)


class _Summing:
    """A rank's grid whose all_reduce adds the other ranks' buffer."""

    def __init__(self, grid, others):
        self._grid, self._others = grid, others

    def axis_size(self, *axes):
        return self._grid.axis_size(*axes)

    def index(self, axis):
        return self._grid.index(axis)

    def all_reduce(self, t, axes, op="sum"):
        return t.add_(self._others)


def test_topk_join_is_exact():
    """ShardedModel.join_topk: the windows' fp32 values and int32 ids,
    joined in one int32 sum, are bit for bit every row's."""
    from deft_tpu_torch.parallel.engine import ShardedModel

    R, K = 5, 4
    vals = torch.rand(R, K) * 1e-3 + torch.tensor([0.0, -0.0, 1e-38, 3.0])
    ids = torch.randint(0, 50000, (R, K), dtype=torch.int32)
    grid = Grid((2, 1, 1), 1, torch.device("cpu"))
    w = row_window(grid, "dp", R)
    other = torch.zeros(w.n_pad, 2 * K, dtype=torch.int32)
    other[:w.rows] = torch.cat([vals[:w.rows].view(torch.int32), ids[:w.rows]], dim=-1)
    w = dataclasses.replace(w, grid=_Summing(grid, other))
    v, i = ShardedModel.join_topk(w, w.take(vals), w.take(ids))
    assert torch.equal(v.view(torch.int32), vals.view(torch.int32)) and torch.equal(i, ids)


# -- one decode step laid out by the specs ------------------------------------------

def step_case():
    """The tiny model's whole numpy weights (deft_tpu's fused stream, seed
    3), random fp32 pools, a tree of a 400-token prompt and 5 leaves, and
    its three plans as numpy arrays by name, cut to R = 5 rows (the plans
    pad to 8)."""
    cfg = PRESETS["tiny"]
    jparams = j_random_params(JPRESETS["tiny"], 3, jnp.float32, on_device=False, fuse=True)
    params = {k: v.numpy() for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu", torch.float32).items()}
    rng = np.random.default_rng(5)
    tree = TreeCache(TokenKVPool(STEP_SLOTS), ReqToTokenPool(8, 512))
    tree.init_prompt([7 + i % 97 for i in range(STEP_PROMPT)])
    for i, c in enumerate(tree.branch(tree.root, STEP_WIDTH)):
        c.append_token(100 + i)
    tree.alloc()
    shape = (cfg.num_layers, STEP_SLOTS, cfg.num_kv_heads * cfg.head_dim)
    pools = tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    kw = dict(q_per_kv=cfg.q_per_kv, block_len=STEP_BLOCK, min_token_bucket=128)
    flat = build_flatten_plan(tree, **kw)
    seq = build_seq_plan(tree, **kw)
    gather = build_seq_plan(tree, want_paged=False, **kw)
    assert flat.paged and seq.paged and not gather.paged
    R = STEP_WIDTH
    assert flat.l_pad > R == flat.n_leaves

    def rows_of(plan, names, per_row=()):
        """The plan's arrays by name, its per-row ones cut to the R leaves."""
        return {k: getattr(plan, k)[:R] for k in ("q_tokens", "q_pos", "out_loc")} | {
            k: getattr(plan, k) if k not in per_row
            else getattr(plan, k).reshape(plan.l_pad, -1)[:R].reshape(-1) for k in names}

    plans = {
        "flatten": (flat, rows_of(flat, ("tok_lo", "tok_hi", "blk_lo", "blk_hi", "seg_src",
                                         "kv_idx"))),
        "seq": (seq, rows_of(seq, SEQ_TABLES, SEQ_TABLES)),
        "seq gather": (gather, rows_of(gather, ("paths", "seq_lens"), ("seq_lens",))
                       | {"paths": gather.paths[:R]}),
    }
    return cfg, jparams, params, pools, plans


@pytest.fixture(scope="module")
def case():
    return step_case()


def launch_grids(case, names, extra=lambda name: {}):
    """One launch of each grid in ``names``: the three spec steps, then the
    calls ``extra(name)`` adds; returns {grid: {call: result}}."""
    cfg, _, params, pools, plans = case
    out = {}
    for name in names:
        calls = {route: (spec_step, dict(cfg=cfg, params=params, pools=pools,
                                          parts={k: v for k, v in parts.items()
                                                 if k != "kv_idx"},
                                          n=STEP_WIDTH, route=route, seg_len=plan.seg_len))
                 for route, (plan, parts) in plans.items()}
        calls.update(extra(name))
        got = launch(run_all, SPEC_GRIDS[name], "cpu", args=(list(calls.values()),),
                     timeout=600)
        out[name] = dict(zip(calls, got))
    return out


@pytest.fixture(scope="module")
def grids(case):
    return launch_grids(case, HERE)


def j_step(jparams, pools, plan, parts, route):
    """deft_tpu's single-device decode_forward over the same step: the
    flatten plan through flatten_attn_xla, the paged seq plan through its
    Pallas kernel (interpret mode), the gather seq plan through
    seq_attn_xla.  Returns (logits, k data, v data)."""
    cfg = JPRESETS["tiny"]
    tbl = j_rope_table(cfg.head_dim, 2048, cfg.rope_theta, cfg.rope_scaling,
                       orig_max_pos=cfg.max_position_embeddings)
    j = {k: jnp.asarray(v) for k, v in parts.items()}
    if route == "flatten":
        batch = JDecodeBatch(j["q_tokens"], j["q_pos"], j["out_loc"], j["kv_idx"],
                             j["tok_lo"], j["tok_hi"], j["blk_lo"], j["blk_hi"])
        attn = j_attn.flatten_attn_xla
    elif route == "seq":
        R = STEP_WIDTH
        batch = JSeqBatch(j["q_tokens"], j["q_pos"], j["out_loc"], jnp.zeros((R, 0), jnp.int32),
                          jnp.zeros(R, jnp.int32), j["seg_src"], j["seg_off"],
                          j["seg_live"], j["blk_live"])
        nb = len(parts["blk_live"]) // R

        def attn(*a):
            return j_paged_seq(*a, block_len=plan.c_pad // nb, seg_len=plan.seg_len)
    else:
        batch = JSeqBatch(j["q_tokens"], j["q_pos"], j["out_loc"], j["paths"],
                          j["seq_lens"])
        attn = j_attn.seq_attn_xla
    logits, k, v = j_decode_forward(
        cfg, jparams, lambda x, pos: j_apply_rope(x, pos, tbl),
        JKVPool(jnp.asarray(pools[0]), None), JKVPool(jnp.asarray(pools[1]), None),
        batch, attn)
    return np.asarray(logits), np.asarray(k.data), np.asarray(v.data)


def probs(logits):
    x = np.asarray(logits, np.float64)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True) + 1e-6


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("grid", HERE)
def test_spec_step_matches_deft_tpu_decode_forward(case, grids, grid, route):
    check_spec_step(case, grids, grid, route)


def check_spec_step(case, grids, grid, route):
    """The grid's step, laid out by shard_decode_args, against deft_tpu's
    single-device decode_forward: every row's probabilities and top ids,
    every pool slot but DUMP_SLOT (each rank's tp slice of the heads), and
    the rows each rank ran through the dense layers."""
    cfg, jparams, _, pools, plans = case
    plan, parts = plans[route]
    want_logits, want_k, want_v = j_step(jparams, pools, plan, parts, route)
    logits, ranks = grids[grid][route]
    assert logits.shape == (STEP_WIDTH, cfg.vocab_size)
    np.testing.assert_array_equal(np.argsort(-logits, -1)[:, :4],
                                  np.argsort(-want_logits, -1)[:, :4])
    np.testing.assert_allclose(probs(logits), probs(want_logits), rtol=PROB_RTOL,
                               atol=PROB_ATOL)
    dp, sp, tp = SPEC_GRIDS[grid]
    width = cfg.num_kv_heads * cfg.head_dim // tp
    written = np.zeros(STEP_SLOTS, bool)
    written[parts["out_loc"]] = True
    written[DUMP_SLOT] = False
    kept = ~written
    kept[DUMP_SLOT] = False
    for r, (rows, k, v) in enumerate(ranks):
        assert rows == -(-STEP_WIDTH // dp)
        cols = slice(r % tp * width, (r % tp + 1) * width)
        for have, want in ((k, want_k), (v, want_v)):
            np.testing.assert_array_equal(have[:, kept], want[:, kept, cols])
            new, ref = have[:, written], want[:, written, cols]
            assert np.abs(new - ref).max() <= POOL_TOL * np.abs(ref).max()


# -- the CLI --------------------------------------------------------------------

def test_cli_dp_meshes_print_the_single_process_tokens():
    base = [sys.executable, "-m", "deft_tpu_torch.cli.run", "--device", "cpu",
            "--random-model", "tiny", "--mode", "flatten", "--max_width", "3",
            "--max_seq_len", "40", "--dtype", "float32", "--kv_pool_slots", "4096",
            "--print-branches"]

    def tokens(extra):
        out = subprocess.run(base + extra, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, (
            f"rc {out.returncode}\nstderr tail:\n{out.stderr[-2000:]}")
        return [x for x in out.stdout.splitlines() if "Tokens in this path" in x]

    single = tokens([])
    assert len(single) == 3
    assert tokens(["--mesh", "2x1x1"]) == single
    assert tokens(["--mesh", "2x1x2"]) == single
