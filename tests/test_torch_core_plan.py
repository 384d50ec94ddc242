"""deft_tpu_torch's host runtime and plans against deft_tpu's.

The same seeded operation schedules (prompt, branch, alloc, append, prune,
speculative-decoding merge/reset) drive a TreeCache of each package; after
every step the slots, refcounts and pool runs must be equal, and so must
every array of the flatten and seq plans built with the same fixed kwargs
(the runner's history-dependent bucket floors are not involved).  All of it
is integer bookkeeping: equality is exact.
"""

import numpy as np
import pytest

import deft_tpu.core as jcore
import deft_tpu.plan as jplan
import deft_tpu_torch.core as tcore
import deft_tpu_torch.plan as tplan


def make_trees(pool_size=16384, max_ctx=2048):
    return [
        pkg.TreeCache(pkg.TokenKVPool(pool_size), pkg.ReqToTokenPool(128, max_ctx))
        for pkg in (jcore, tcore)
    ]


def tree_state(tree):
    nodes = sorted(tree.nodes.values(), key=lambda n: n.id)
    return {
        "refs": tree.token_to_kv_pool.refs.copy(),
        "free": tree.token_to_kv_pool.available_size(),
        "used": tree.token_to_kv_pool.used_size(),
        "kv": [(n.id, n.kv_indices.tolist()) for n in nodes],
        "runs": [(n.id, [list(r) for r in n.kv_runs]) for n in nodes],
        "tokens": [(n.id, list(n.token_ids), list(n.positions)) for n in nodes],
        "ref_count": [(n.id, n.ref_count) for n in nodes],
        "leaves": sorted(tree.leaves),
        "req": sorted(tree.leaf_to_req.items()),
        "page_table": tree.req_to_token_pool.req_to_token.copy(),
    }


def assert_same_state(a, b):
    sa, sb = tree_state(a), tree_state(b)
    for key in sa:
        if isinstance(sa[key], np.ndarray):
            np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
        else:
            assert sa[key] == sb[key], key


PLAN_KWARGS = [
    dict(q_per_kv=4, block_len=128, min_token_bucket=256),
    dict(q_per_kv=4, block_len=256, min_token_bucket=1024),
    dict(q_per_kv=2, block_len=256, min_token_bucket=512, seg_len=32),
]


def assert_same_plans(a, b):
    for kw in PLAN_KWARGS:
        pa, pb = jplan.build_flatten_plan(a, **kw), tplan.build_flatten_plan(b, **kw)
        for f in ("kv_idx", "tok_lo", "tok_hi", "blk_lo", "blk_hi", "q_tokens",
                  "q_pos", "out_loc", "seg_src", "run_table"):
            x, y = getattr(pa, f), getattr(pb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"flatten {f} {kw}")
        for f in ("n_tokens", "n_leaves", "block_len", "seg_len", "paged",
                  "n_live_pad"):
            assert getattr(pa, f) == getattr(pb, f), f
        sa = jplan.build_seq_plan(a, want_paged=True, **kw)
        sb = tplan.build_seq_plan(b, want_paged=True, **kw)
        for f in ("paths", "seq_lens", "q_tokens", "q_pos", "out_loc",
                  "seg_src", "seg_off", "seg_live", "blk_live"):
            x, y = getattr(sa, f), getattr(sb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"seq {f} {kw}")
        for f in ("n_leaves", "total_kv", "seg_len", "paged", "c_pad", "l_pad"):
            assert getattr(sa, f) == getattr(sb, f), f


def run_schedule(seed, trees, check_plans_every=4):
    """One random decode history applied identically to both trees."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(4, 500, int(rng.integers(100, 700))).tolist()
    for t in trees:
        t.init_prompt(prompt)
    width = int(rng.integers(2, 9))
    for t in trees:
        for i, c in enumerate(t.branch(t.root, width)):
            c.append_token(10 + i)
    for step in range(int(rng.integers(20, 40))):
        slots = [t.alloc() for t in trees]
        np.testing.assert_array_equal(slots[0], slots[1])
        op = rng.random()
        leaf_ids = sorted(trees[0].leaves)
        if op < 0.15 and len(leaf_ids) < 16:        # branch one leaf
            lid = int(rng.choice(leaf_ids))
            k = int(rng.integers(2, 4))
            for t in trees:
                for i, c in enumerate(t.branch(t.nodes[lid], k)):
                    c.append_token(20 + i)
        elif op < 0.25 and len(leaf_ids) > 2:      # prune one leaf
            lid = int(rng.choice(leaf_ids))
            for t in trees:
                t.cut(t.nodes[lid], record_deleted=True)
        elif op < 0.32 and len(leaf_ids) >= 8:     # accept: merge + reset
            merged = [int(x) for x in rng.choice(leaf_ids, 2, replace=False)]
            for t in trees:
                before = t.root.kv_len
                for lid in merged:
                    t.merge_nodes(t.root, t.nodes[lid], prune_b=False)
                for leaf in list(t.leaves.values()):
                    t.reset_node_KV(leaf, t.root.kv_len - before)
                t.sync_page_table()
        tok = rng.integers(1, 500, 64)
        for t in trees:
            for i, leaf in enumerate(sorted(t.leaves.values(), key=lambda n: n.id)):
                if leaf.kv_len == leaf.get_len():  # not just branched
                    leaf.append_token(int(tok[i % 64]))
        assert_same_state(*trees)
        if step % check_plans_every == 0:
            for t in trees:
                t.alloc()
            assert_same_state(*trees)
            assert_same_plans(*trees)
            for t in trees:  # the alloc'd slots get their tokens
                for leaf in t.leaves.values():
                    leaf.append_token(7)


@pytest.mark.parametrize("seed", range(6))
def test_schedule_state_and_plans_match(seed):
    trees = make_trees()
    run_schedule(seed, trees)
    for t in trees:
        t.alloc()
    assert_same_plans(*trees)
    dumps = [[(s.id, s.token_ids) for s in t.all_finished_seqs] for t in trees]
    for t in trees:
        for leaf in list(t.leaves.values()):
            t.output_branch(leaf)
    assert ([(s.id, s.token_ids, s.PPL) for s in trees[0].all_finished_seqs]
            == [(s.id, s.token_ids, s.PPL) for s in trees[1].all_finished_seqs])
    assert dumps[0] == dumps[1]
    for t in trees:
        t.free()
    assert_same_state(*trees)


@pytest.mark.parametrize("seed", range(3))
def test_kv_pool_alloc_paths_match(seed):
    """alloc / alloc_for / alloc_group / close_owner / free in both pools,
    including the COVER_SLACK top rows and the chunk-aligned group spans."""
    rng = np.random.default_rng(100 + seed)
    pools = [jcore.TokenKVPool(4096), tcore.TokenKVPool(4096)]
    assert pools[0].COVER_SLACK == pools[1].COVER_SLACK == 128
    held = []
    for _ in range(300):
        op = rng.random()
        if op < 0.3:
            n = int(rng.integers(1, 200))
            outs = [p.alloc(n) for p in pools]
        elif op < 0.6:
            owner = int(rng.integers(0, 12))
            n = int(rng.integers(1, 40))
            outs = [p.alloc_for(owner, n) for p in pools]
        elif op < 0.7:
            n = int(rng.integers(8, 40))
            outs = [p.alloc_group(n) for p in pools]
        elif op < 0.8:
            owner = int(rng.integers(0, 12))
            for p in pools:
                p.close_owner(owner)
            outs = [None, None]
        else:
            outs = [None, None]
            if held:
                idx = held.pop(int(rng.integers(0, len(held))))
                for p in pools:
                    p.free(idx)
        assert (outs[0] is None) == (outs[1] is None)
        if outs[0] is not None:
            np.testing.assert_array_equal(outs[0], outs[1])
            held.append(outs[0])
        np.testing.assert_array_equal(pools[0].refs, pools[1].refs)
        assert pools[0].available_size() == pools[1].available_size()
        assert pools[0].used_size() == pools[1].used_size()
    assert tcore.kv_pool.DUMP_SLOT == jcore.kv_pool.DUMP_SLOT == 0


def test_plan_constants_match():
    from deft_tpu.plan import flatten as jf
    from deft_tpu.plan import padding as jp
    from deft_tpu_torch.plan import flatten as tf
    from deft_tpu_torch.plan import padding as tp

    assert tf.FULL_BLOCK_LO == jf.FULL_BLOCK_LO and tf.FULL_BLOCK_LO < -(1 << 20)
    assert tf._EMPTY_LO == jf._EMPTY_LO
    for n in (1, 100, 1023, 1025, 5000):
        for pow2 in (False, True):
            assert (tp.pad_token_count(n, 256, 1024, pow2=pow2)
                    == jp.pad_token_count(n, 256, 1024, pow2=pow2))
        assert tp.pad_leaf_count(n % 70 + 1, 4) == jp.pad_leaf_count(n % 70 + 1, 4)


def test_configs_match():
    from deft_tpu.config import EngineConfig as JE
    from deft_tpu.models.config import PRESETS as JP
    from deft_tpu_torch.config import EngineConfig as TE
    from deft_tpu_torch.models.config import PRESETS as TP

    # the port keeps a subset of the fields (the ones its code reads), each
    # with deft_tpu's default
    for ours, theirs in ((TE(), JE()), (TE().attention, JE().attention)):
        kept = {k: v for k, v in vars(ours).items() if k != "attention"}
        assert kept and kept == {k: vars(theirs)[k] for k in kept}
    for name in ("tiny", "8b"):
        assert vars(JP[name]) == vars(TP[name])
