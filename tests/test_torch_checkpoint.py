"""deft_tpu_torch's checkpoint and restore (runtime/checkpoint.py) against
deft_tpu's (deft_tpu/runtime/checkpoint.py), tiny model in fp32 on the CPU.

- save, restore into a fresh runner on the same weights: the next decode
  step's greedy ids equal the uninterrupted run's, its distribution within
  rtol 1e-3 (the KV is recomputed through the prefill path, another
  summation order, as deft_tpu tests/test_checkpoint.py bounds it);
- a tree with a pruned leaf restores with the snapshot's node ids, kv
  lengths, offsets and node count, and its pending tokens stay pending;
- the snapshot of the same run equals deft_tpu's;
- a file written by either package restores in the other, to the same
  next step.
"""

import json

import numpy as np
import pytest
import torch

from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.runtime import ForwardMode as JMode
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime.checkpoint import restore as j_restore
from deft_tpu.runtime.checkpoint import save_checkpoint as j_save
from deft_tpu.runtime.checkpoint import tree_snapshot as j_snapshot
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.runtime import ForwardMode, ModelRunner
from deft_tpu_torch.runtime.checkpoint import restore, save_checkpoint, tree_snapshot

ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(range(7, 23))


@pytest.fixture(scope="module")
def runners():
    """deft_tpu's runner (CPU XLA attention) and a port runner on its
    weights; the port's runners share those weights."""
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla", seed=0)
    params = params_from_numpy({k: np.asarray(v) for k, v in jr.params.items()},
                               PRESETS["tiny"], "cpu", torch.float32)
    return jr, params


def port_runner(params):
    return ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu", params=params)


def grow(runner, flatten, prune=False):
    """Prefill, branch into the top 3, four greedy steps; optionally prune
    the second leaf."""
    view = runner.forward_prefill(PROMPT)
    tree = runner.tree
    _, ids0 = view.topk(0, 3)
    for c, child in enumerate(tree.branch(tree.root, 3)):
        child.append_token(int(ids0[c]))
    for _ in range(4):
        tree.alloc()
        plan = runner.build_plan(flatten)
        lv, _ = runner.forward_tree_decode(flatten, plan)
        ids, _ = lv.argmax()
        for leaf in list(tree.leaves.values()):
            leaf.append_token(int(ids[tree.leaf_to_q[leaf.id]]))
    if prune:
        tree.cut(sorted(tree.leaves.values(), key=lambda n: n.id)[1], record_deleted=True)


def next_step(runner, flatten):
    runner.tree.alloc()
    plan = runner.build_plan(flatten)
    lv, _ = runner.forward_tree_decode(flatten, plan)
    return lv.vals[:plan.n_leaves], lv.ids[:plan.n_leaves]


def nodes(tree):
    return {n.id: (list(n.token_ids), n.kv_len, n.position_offset)
            for n in tree.nodes.values()}


def test_save_restore_round_trip(runners, tmp_path):
    _, params = runners
    runner = port_runner(params)
    grow(runner, ForwardMode.TREE_DECODE_FLATTEN)
    path = str(tmp_path / "ckpt.json")
    save_checkpoint(runner.tree, path)
    want_nodes = nodes(runner.tree)
    want_vals, want_ids = next_step(runner, ForwardMode.TREE_DECODE_FLATTEN)
    fresh = port_runner(params)
    restore(fresh, path)
    assert nodes(fresh.tree) == want_nodes
    got_vals, got_ids = next_step(fresh, ForwardMode.TREE_DECODE_FLATTEN)
    np.testing.assert_array_equal(got_ids[:, 0], want_ids[:, 0])
    np.testing.assert_allclose(got_vals, want_vals, rtol=1e-3, atol=1e-5)


def test_restore_after_prune(runners, tmp_path):
    _, params = runners
    runner = port_runner(params)
    grow(runner, ForwardMode.TREE_DECODE_FLATTEN, prune=True)
    path = str(tmp_path / "ckpt.json")
    save_checkpoint(runner.tree, path)
    fresh = port_runner(params)
    restore(fresh, path)
    assert nodes(fresh.tree) == nodes(runner.tree)
    assert fresh.tree.node_cnt == runner.tree.node_cnt
    assert fresh.tree.deleted_token_num == runner.tree.deleted_token_num
    # the pending tokens stay pending: the next alloc gives one slot a leaf
    # and the plan holds each token once
    fresh.tree.alloc()
    plan = fresh.build_plan(ForwardMode.TREE_DECODE_FLATTEN)
    assert plan.n_tokens == fresh.tree.get_tree_kv_len()


def test_snapshot_equals_deft_tpu(runners):
    jr, params = runners
    jr.reset_state()
    grow(jr, JMode.TREE_DECODE_FLATTEN, prune=True)
    runner = port_runner(params)
    grow(runner, ForwardMode.TREE_DECODE_FLATTEN, prune=True)
    assert json.dumps(tree_snapshot(runner.tree)) == json.dumps(j_snapshot(jr.tree))


@pytest.mark.parametrize("writer", ["deft_tpu", "port"])
def test_file_restores_in_the_other_package(runners, tmp_path, writer):
    jr, params = runners
    jr.reset_state()
    grow(jr, JMode.TREE_DECODE_FLATTEN)
    runner = port_runner(params)
    grow(runner, ForwardMode.TREE_DECODE_FLATTEN)
    path = str(tmp_path / "ckpt.json")
    if writer == "deft_tpu":
        j_save(jr.tree, path)
        fresh = port_runner(params)
        restore(fresh, path)
        assert nodes(fresh.tree) == nodes(runner.tree)
        got = next_step(fresh, ForwardMode.TREE_DECODE_FLATTEN)
    else:
        save_checkpoint(runner.tree, path)
        fresh = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla",
                        params=jr.params)
        j_restore(fresh, path)
        assert nodes(fresh.tree) == nodes(jr.tree)
        got = next_step(fresh, JMode.TREE_DECODE_FLATTEN)
    want = next_step(jr, JMode.TREE_DECODE_FLATTEN)
    np.testing.assert_array_equal(got[1][:, 0], want[1][:, 0])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-5)
