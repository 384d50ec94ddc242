"""Repairs of the port held against deft_tpu on the CPU:

- queued merge copies (TreeCache.merge_nodes) land in the pools before the
  next decode step, rows and int8 scales, as deft_tpu's apply_kv_copies
  puts them (runtime/runner.py:1727, :2020);
- the ranks of a grid agree on one KV slot count when each sizes its pool
  from its own memory (two gloo ranks, different memory fractions);
- a --prompt_len <= 0 gives the default prompt (deft_tpu cli/run.py:202-203).
"""

import argparse

import numpy as np
import pytest
import torch

from deft_tpu.cli.run import _IdTokenizer
from deft_tpu.cli.run import _make_prompt as j_make_prompt
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.runtime import ForwardMode as JMode
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu_torch.cli.run import make_prompt
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.parallel import launch
from deft_tpu_torch.parallel.launch import pool_slots
from deft_tpu_torch.runtime import ForwardMode, ModelRunner

ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(np.random.default_rng(0).integers(4, 500, 300))


def pools(runner):
    """(k data, v data, k scale, v scale) of a runner's pools as numpy."""
    out = []
    for pool in (runner.k_pool, runner.v_pool):
        out.append(np.asarray(pool.data))
    for pool in (runner.k_pool, runner.v_pool):
        out.append(None if pool.scale is None else np.asarray(pool.scale))
    return out


@pytest.mark.parametrize("kv", ["inherit", "int8"])
def test_merge_copies_land_before_the_step_as_in_deft_tpu(kv):
    """Both trees branch, decode two steps and merge two leaves into the
    root twice (deft_tpu tests/test_e2e.py's speculative-decoding layout).
    The port starts from deft_tpu's pools, so the copies alone decide what
    the rows hold: after the port's next forward_tree_decode (and deft_tpu's
    apply_kv_copies) every row but the step's own new ones is equal, bit for
    bit, and the queue is empty."""
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG, kv_dtype=kv), kernels="pallas",
                 seed=0)
    params = params_from_numpy({k: np.asarray(v) for k, v in jr.params.items()},
                               PRESETS["tiny"], "cpu", torch.float32)
    tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG, kv_dtype=kv), device="cpu",
                     params=params)
    jmode, tmode = JMode.TREE_DECODE_FLATTEN, ForwardMode.TREE_DECODE_FLATTEN
    for r in (jr, tr):
        r.forward_prefill(PROMPT)
        for i, c in enumerate(r.tree.branch(r.tree.root, 6)):
            c.append_token(20 + i)
    for step in range(2):
        for r, mode in ((jr, jmode), (tr, tmode)):
            r.tree.alloc()
            r.forward_tree_decode(mode, r.build_plan(mode))
            for leaf in r.tree.leaves.values():
                leaf.append_token(30 + step)
    # the port takes deft_tpu's pools: the copies alone decide the rows
    for mine, theirs in ((tr.k_pool, jr.k_pool), (tr.v_pool, jr.v_pool)):
        mine.data.copy_(torch.from_numpy(np.array(theirs.data)))
        if mine.scale is not None:
            mine.scale.copy_(torch.from_numpy(np.array(theirs.scale)))
    for r in (jr, tr):
        tree = r.tree
        for _ in range(2):
            leaves = list(tree.leaves.values())
            kv0 = tree.root.kv_len
            for i in range(2):
                tree.merge_nodes(tree.root, leaves[i], prune_b=False)
            for leaf in leaves:
                tree.reset_node_KV(leaf, tree.root.kv_len - kv0)
            tree.sync_page_table()
        tree.alloc()
    assert tr.tree.pending_kv_copies
    copies = np.concatenate([d for _, d in tr.tree.pending_kv_copies])
    jr.apply_kv_copies()
    plan = tr.build_plan(tmode)
    tr.forward_tree_decode(tmode, plan)
    assert not tr.tree.pending_kv_copies
    fresh = np.asarray(plan.out_loc)  # written by this step's kv_store
    keep = np.setdiff1d(np.arange(ECFG["kv_pool_slots"]), fresh)
    assert np.intersect1d(copies, keep).size == copies.size
    mine, theirs = pools(tr), pools(jr)
    for a, b in zip(mine[:2], theirs[:2]):
        np.testing.assert_array_equal(a[:, keep], b[:, keep])
    for a, b in zip(mine[2:], theirs[2:]):
        assert (a is None) == (kv != "int8")
        if a is not None:
            np.testing.assert_array_equal(a[:, :, keep], b[:, :, keep])


def test_grid_ranks_agree_on_pool_slots():
    """Two gloo ranks (grid 1x1x2) size their pools from different memory
    fractions of the CPU's assumed 2 GiB; both take the smaller count,
    which each would not have taken alone."""
    base = dict(max_requests=16, max_context_len=128, min_token_bucket=128,
                dtype="float32")
    fracs = (0.008, 0.004)
    got = launch(pool_slots, (1, 1, 2), device="cpu", backend="gloo",
                 args=(PRESETS["tiny"], [EngineConfig(**base, mem_fraction=f)
                                         for f in fracs]))
    cfg = PRESETS["tiny"]
    cell = cfg.num_layers * (cfg.num_kv_heads // 2) * cfg.head_dim * 2 * 4
    alone = [int((2 << 30) * f) // cell for f in fracs]
    assert alone[0] != alone[1] and min(alone) > 4096
    assert got == [min(alone)] * 2


@pytest.mark.parametrize("prompt_len", [-4, 0, None, 12])
def test_prompt_len_at_most_zero_gives_the_default_prompt(prompt_len):
    """The port's make_prompt against deft_tpu's _make_prompt after the
    mapping deft_tpu's main applies first (prompt_len <= 0 -> None)."""
    vocab, max_seq_len, seed = 512, 40, 3
    jlen = None if prompt_len is not None and prompt_len <= 0 else prompt_len
    args = argparse.Namespace(prompt_len=jlen, max_seq_len=max_seq_len, seed=seed)
    want = j_make_prompt(args, _IdTokenizer(vocab), None)
    got = make_prompt(prompt_len, max_seq_len, vocab, seed)
    assert got == want and len(got) > 0
