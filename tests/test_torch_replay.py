"""deft_tpu_torch's packed plan uploads, decode windows and replay executor
against deft_tpu's, on the CPU in fp32 at the tiny preset.

- the packed plan buffer (runner._pack_plan) equals deft_tpu's element for
  element for flatten, node, tree_index and seq plans, compact and full
  (DEFT_COMPACT_PLAN), over trees with branches, prunes and speculative
  merges (test_torch_core_plan's run_schedule, tests/test_e2e.py:213);
- the compact buffer's expansion on the device (expand_compact) equals the
  plan's full arrays field by field (tests/test_e2e.py:259);
- a patched upload (DEFT_PLAN_PATCH) equals a full upload after every step
  of such a run, and ships fewer bytes on the steps that only append;
- plans built with the bucket floors equal deft_tpu's default-built plans
  across branch/prune cycles;
- decode windows (DEFT_REPLAY_EXEC=0) give the per-step path's tokens and
  KV_IO (DEFT_REPLAY_EXEC=0 DEFT_PLAN_PATCH=0) and deft_tpu's window
  path's, with as many windows (tests/test_e2e.py:775);
- the replay executor under deft_tpu's default switches, and with
  DEFT_REPLAY_UNIFORM, DEFT_REPLAY_WINDOWS and DEFT_REPLAY_EXEC each at 0,
  gives deft_tpu's token ids, KV_IO and Mask_IO for Simple_Tree,
  Practical_Tree (deferred), Random_Tree, Speculative_Decoding (logits-free
  steps with KV relocations) and Beam_Search, flatten and seq, and over
  int8 KV; with as many slab windows and slab steps as deft_tpu's, counted
  by spies on its _slab_window and slab _decode_step
  (tests/test_e2e.py:299-356); and with a host wait after every sub-step
  (DEFT_REPLAY_DRAIN=1);
- pipelined decode windows (DEFT_PIPE_WINDOWS=4, DEFT_SYNC_PERIOD=32, as
  tests/test_e2e.py:830-835 runs them) give deft_tpu's tokens under the
  same switches and the port's per-step chain's, with fewer host waits
  than one window in flight.
"""

import contextlib

import numpy as np
import pytest
import torch

import deft_tpu.data.loader as jloader
import deft_tpu.plan as jplan
import deft_tpu_torch.data.loader as tloader
import deft_tpu_torch.plan as tplan
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.plan.seq import SeqPlan
from deft_tpu_torch.runtime import ForwardMode, ModelRunner, mode_from_cli, tree_generate
from deft_tpu_torch.runtime.runner import PATCH_CHUNK, host_wait, plan_fields
from test_torch_chain import e2e_template, spec_template
from test_torch_core_plan import run_schedule
from test_torch_modes import assert_same_plan

ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
BIG = dict(kv_pool_slots=16384, max_requests=128, max_context_len=2048,
           min_token_bucket=128, dtype="float32")
PROMPT = list(range(7, 19))
KINDS = {"flatten": ForwardMode.TREE_DECODE_FLATTEN, "node": ForwardMode.TREE_DECODE_NODE,
         "tree_index": ForwardMode.TREE_DECODE_INDEX_NODE, "seq": ForwardMode.DECODE}
PLAN_KW = [dict(q_per_kv=2, block_len=128, min_token_bucket=256),
           dict(q_per_kv=2, block_len=256, min_token_bucket=512, seg_len=32),
           dict(q_per_kv=2, block_len=256, min_token_bucket=1024,
                seg_len=(512, 256, 128), waste_limit=(1.1, 1.2, 3.0))]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread for the module (as test_torch_attn_estimate.py
    runs): a replayed window runs 32 tiny forwards, and tiny ops on several
    threads are an order of magnitude slower on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def switches(**env):
    """The environment switches set (a value of None: unset) while open."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            if v is None:
                mp.delenv(k, raising=False)
            else:
                mp.setenv(k, v)
        yield


def runner_pair(compact: bool, ecfg=BIG):
    """deft_tpu's runner on its Pallas route (paged plans pack paged) and
    the port's, with DEFT_COMPACT_PLAN as asked, each with a tree-index
    pool; their trees take one schedule."""
    with switches(DEFT_COMPACT_PLAN="1" if compact else "0"):
        jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ecfg), kernels="pallas", seed=0,
                     use_tree_index=True)
        tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ecfg), device="cpu",
                         use_tree_index=True)
    assert jr._compact_plan == tr._compact_plan == compact
    return jr, tr


SEQ_FIELDS = ("q_tokens", "q_pos", "out_loc", "seq_lens", "paths", "seg_src", "seg_off",
              "seg_live", "blk_live")


def same_plan(pa, pb, what):
    """test_torch_modes' field-by-field check, and a seq plan's arrays."""
    if not isinstance(pb, SeqPlan):
        return assert_same_plan(pa, pb, what)
    for f in SEQ_FIELDS:
        x, y = getattr(pa, f), getattr(pb, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    assert (pa.paged, pa.seg_len, pa.c_pad) == (pb.paged, pb.seg_len, pb.c_pad), what


def build_both(trees, kind, kw):
    if kind == "flatten":
        return [pkg.build_flatten_plan(t, **kw) for pkg, t in zip((jplan, tplan), trees)]
    if kind == "node":
        return [pkg.build_node_plan(t, chunk_len=None, **kw)
                for pkg, t in zip((jplan, tplan), trees)]
    if kind == "tree_index":
        return [pkg.build_tree_index_plan(t, **kw) for pkg, t in zip((jplan, tplan), trees)]
    if isinstance(kw.get("waste_limit"), tuple):  # the int8 seq rule
        kw = dict(kw, seg_len=(128,), waste_limit=32.0)
    return [pkg.build_seq_plan(t, want_paged=True, **kw)
            for pkg, t in zip((jplan, tplan), trees)]


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("seed", range(3))
def test_packed_buffer_matches_deft_tpu(seed, compact):
    """Both runners' trees go through one seeded schedule of branches,
    prunes, merges and appends; every plan kind, built with fixed kwargs,
    packs to deft_tpu's buffer, sizes and layout, element for element —
    the compact form for the paged flatten-family plans where asked (the
    run-table floor grows alike), and the port's compact expansion gives
    the plan's full arrays."""
    jr, tr = runner_pair(compact)
    trees = [jr.tree, tr.tree]
    run_schedule(seed, trees, check_plans_every=1000)
    for t in trees:
        t.alloc()
    seen = set()
    for kw in PLAN_KW:
        for kind, mode in KINDS.items():
            jp, tp = build_both(trees, kind, kw)
            same_plan(jp, tp, f"{kind} {kw}")
            jbuf, jsizes, jpaged = jr._pack_plan(mode, jp)
            tbuf, tsizes, tpaged = tr._pack_plan(mode, tp)
            assert (tsizes, tpaged) == (tuple(jsizes), jpaged), (kind, kw)
            np.testing.assert_array_equal(tbuf, np.asarray(jbuf, np.int32),
                                          err_msg=f"{kind} {kw}")
            seen.add((kind, len(tsizes) == 5, tpaged))
            if kind != "seq" and len(tsizes) == 5:
                check_expansion(tr, kind, tp, tbuf, tsizes)
    # some flatten-family plan of the schedule packs compact (or, without
    # the switch, paged in the full form), and some seq plan paged
    assert any(k != "seq" and c == compact and p for k, c, p in seen), seen
    assert ("seq", True, True) in seen


def check_expansion(tr, kind, plan, buf, sizes):
    """The compact buffer unpacked on the device: the plan's per-token and
    per-block arrays, its query arrays, exactly."""
    fields = plan_fields(kind, sizes, True, False)
    batch = tr._unpack(tr._stage(buf), kind, sizes, fields, tr._plan_meta(plan, True))
    for f in ("tok_lo", "tok_hi", "seg_src", "blk_lo", "blk_hi", "q_tokens", "q_pos",
              "out_loc"):
        np.testing.assert_array_equal(getattr(batch, f).numpy(), getattr(plan, f),
                                      err_msg=f"{kind} {f}")
    assert batch.block_len == plan.block_len and batch.seg_len == plan.seg_len
    assert not hasattr(batch, "kv_idx") and not hasattr(batch, "run_off")
    # the compact buffer is smaller than the full one
    assert len(buf) < 3 * plan.l_pad + 2 * plan.t_pad + 2 * plan.num_blocks + len(plan.seg_src)


def test_compact_expansion_spec_shape():
    """tests/test_e2e.py:259's speculative pool shape: merged accepts and
    reset leaves give coalesced multi-node runs; the port's expansion
    equals the plan, and its buffer deft_tpu's."""
    jr, tr = runner_pair(True, ECFG)
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(4, 200, 300)]
    for t in (jr.tree, tr.tree):
        t.init_prompt(prompt)
        for i, c in enumerate(t.branch(t.root, 8)):
            c.append_token(20 + i)
        t.alloc()
        for _ in range(2):
            leaves = list(t.leaves.values())
            kv0 = t.root.kv_len
            for i in range(2):
                t.merge_nodes(t.root, leaves[i], prune_b=False)
            for leaf in leaves:
                t.reset_node_KV(leaf, t.root.kv_len - kv0)
            t.sync_page_table()
            t.alloc()
    mode = ForwardMode.TREE_DECODE_FLATTEN
    jp, tp = jr.build_plan(mode), tr.build_plan(mode)
    assert tp.paged and tp.run_table is not None
    jbuf, jsizes, _ = jr._pack_plan(mode, jp)
    tbuf, tsizes, _ = tr._pack_plan(mode, tp)
    assert tsizes == tuple(jsizes) and len(tsizes) == 5
    np.testing.assert_array_equal(tbuf, np.asarray(jbuf))
    check_expansion(tr, "flatten", tp, tbuf, tsizes)


@pytest.mark.parametrize("kind,compact", [("flatten", False), ("flatten", True),
                                          ("seq", False)])
def test_patched_upload_equals_full_upload(kind, compact):
    """Every step of a run with branches, prunes and a merge over a
    3600-token prompt: the buffer _upload_plan leaves on the device equals
    the step's full buffer.  On the steps that only append, the full-form
    buffers (O(tokens) ints) ship fewer bytes than a full upload; a
    compact buffer of this tree is a few chunks, more than a quarter of
    which change, so it ships whole, as deft_tpu's rule says."""
    with switches(DEFT_COMPACT_PLAN="1" if compact else "0"):
        runner = ModelRunner(PRESETS["tiny"], EngineConfig(**dict(
            BIG, max_context_len=4096)), device="cpu")
    assert runner._plan_patch
    mode = KINDS[kind]
    tree = runner.tree
    rng = np.random.default_rng(3)
    tree.init_prompt([int(t) for t in rng.integers(4, 500, 3600)])
    for i, c in enumerate(tree.branch(tree.root, 3)):
        c.append_token(30 + i)
    patched, changed = 0, True
    for step in range(24):
        tree.alloc()
        plan = runner.build_plan(mode)
        buf, sizes, _ = runner._pack_plan(mode, plan)
        assert (len(sizes) == 5) == (compact or kind == "seq")
        up, full = runner.plan_upload_bytes, runner.plan_full_bytes
        dev = runner._upload_plan(kind, buf)
        np.testing.assert_array_equal(dev.numpy()[:len(buf)], buf, err_msg=f"step {step}")
        assert len(dev) == -(-len(buf) // PATCH_CHUNK) * PATCH_CHUNK
        if not changed and not compact:
            assert runner.plan_upload_bytes - up < runner.plan_full_bytes - full, step
            patched += 1
        leaves = sorted(tree.leaves.values(), key=lambda n: n.id)
        changed = step % 6 in (0, 3) or step == 9
        if step % 6 == 0 and len(leaves) < 10:
            for i, c in enumerate(tree.branch(leaves[0], 2)):
                c.append_token(40 + i)
        elif step % 6 == 3 and len(leaves) > 3:
            tree.cut(leaves[-1], record_deleted=True)
        if step == 9:
            kv0 = tree.root.kv_len
            tree.merge_nodes(tree.root, leaves[1], prune_b=False)
            for leaf in list(tree.leaves.values()):
                tree.reset_node_KV(leaf, tree.root.kv_len - kv0)
            tree.sync_page_table()
        for leaf in tree.leaves.values():
            if leaf.kv_len == leaf.get_len():
                leaf.append_token(int(rng.integers(1, 500)))
    assert patched >= (0 if compact else 10)


@pytest.mark.parametrize("kind", list(KINDS))
def test_bucket_floors_match_deft_tpu(kind):
    """The runners' own build_plan across branch/prune cycles (the leaf
    count swings 3 -> 9 -> 3 twice): equal plans field by field, l_pad and
    the token bucket never shrink, and the compact run-table pad only
    grows."""
    jr, tr = runner_pair(True, ECFG)
    mode = KINDS[kind]
    rng = np.random.default_rng(7)
    prompt = [int(t) for t in rng.integers(4, 500, 200)]
    trees = [jr.tree, tr.tree]
    for t in trees:
        t.init_prompt(prompt)
        for i, c in enumerate(t.branch(t.root, 3)):
            c.append_token(10 + i)
    pads, rpads = [], []
    for step in range(16):
        for t in trees:
            t.alloc()
        jp, tp = jr.build_plan(mode), tr.build_plan(mode)
        same_plan(jp, tp, f"{kind} step {step}")
        pads.append((tp.l_pad, tp.c_pad if kind == "seq" else tp.t_pad))
        jbuf, jsizes, _ = jr._pack_plan(mode, jp)
        tbuf, tsizes, _ = tr._pack_plan(mode, tp)
        assert tsizes == tuple(jsizes)
        np.testing.assert_array_equal(tbuf, np.asarray(jbuf))
        rpads.append(tsizes[3] if kind != "seq" and len(tsizes) == 5 else 0)
        tok = int(rng.integers(1, 500))
        for t in trees:
            leaves = sorted(t.leaves.values(), key=lambda n: n.id)
            if step % 8 == 1:
                for leaf in leaves:
                    for i, c in enumerate(t.branch(leaf, 3)):
                        c.append_token(20 + i)
            elif step % 8 == 5:
                for leaf in leaves[3:]:
                    t.cut(leaf, record_deleted=True)
            for leaf in t.leaves.values():
                if leaf.kv_len == leaf.get_len():
                    leaf.append_token(tok)
    assert all(b >= a for a, b in zip(pads, pads[1:])), pads
    assert all(b >= a for a, b in zip(rpads, rpads[1:])), rpads
    assert pads[-1][0] > pads[0][0]  # the floor held the 9-leaf bucket


# name -> (workload, template maker (loader) or None, generated tokens, width)
CASES = {
    "simple": ("simple_tree", None, 40, 3),
    "practical": ("practical_tree", e2e_template, 12, 3),
    "random": ("random_tree", None, 16, 3),
    "spec": ("speculative_decoding", spec_template, 32, 8),
    "beam": ("beam_search", None, 12, 4),
}
# (case, mode, kv dtype, switches): deft_tpu's defaults for every case and
# mode, int8 KV, each replay switch at 0, and a host wait after every
# replayed sub-step (a switch "NAME=value" sets NAME to value, a bare NAME
# to 0)
RUNS = ([(c, m, "inherit", "default") for c in CASES for m in ("flatten", "seq")]
        + [(c, "flatten", "int8", "default") for c in ("simple", "spec")]
        + [(c, "flatten", "inherit", s) for c in ("simple", "practical", "spec")
           for s in ("DEFT_REPLAY_WINDOWS", "DEFT_REPLAY_EXEC")]
        + [(c, "flatten", "inherit", "DEFT_REPLAY_UNIFORM")
           for c in ("practical", "random")]
        + [(c, "flatten", "inherit", "DEFT_REPLAY_DRAIN=1") for c in ("simple", "spec")])


def run_case(generate, runner, loader, workloads_mod, controller, case, mode):
    name, make, gen, width = CASES[case]
    pm = generate(runner, mode, None, PROMPT, max_seq_len=len(PROMPT) + gen,
                  width=width, depth=2,
                  branch_controller=controller(getattr(workloads_mod, name)),
                  tree_template=make(loader) if make else None)
    return sorted(tuple(s.token_ids) for s in runner.tree.all_finished_seqs), pm


@pytest.fixture(scope="module")
def deft_runners():
    """deft_tpu's runners, made once a (route, KV dtype, DEFT_PLAN_PATCH)
    and reused with reset_state and cleared bucket floors, so its compiled
    steps are reused too (the replay switches are read at each generation,
    the plan switches when a runner is made), and the port's copy of their
    numpy weights."""
    made = {}

    def get(kernels="xla", kv="inherit", patch=None):
        key = (kernels, kv, patch)
        if key not in made:
            with switches(DEFT_PLAN_PATCH=patch, DEFT_COMPACT_PLAN=None):
                jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG, kv_dtype=kv),
                             kernels=kernels, seed=0)
            params = params_from_numpy({k: np.asarray(v) for k, v in jr.params.items()},
                                       PRESETS["tiny"], "cpu", torch.float32)
            made[key] = jr, params
        jr, params = made[key]
        jr.reset_state()
        # a fresh runner's buckets: the floors an earlier case raised go
        jr._bucket_floors.clear()
        jr._rpad_floor.clear()
        return jr, params

    return get


def replay_pair(run, jr, params, counts, tr=None):
    """One RUNS entry in both packages under its switches: deft_tpu on
    ``jr``, the port on its weights (``tr``, else a runner made under the
    switches); returns (deft_tpu's (ids, metrics), its slab windows and
    steps counted by the spies behind ``counts``, the port's (ids,
    metrics), its slab windows, steps and sub-steps and its host waits)."""
    case, mode, kv, switch = run
    env = dict.fromkeys(("DEFT_REPLAY_EXEC", "DEFT_REPLAY_WINDOWS", "DEFT_REPLAY_UNIFORM",
                         "DEFT_PLAN_PATCH", "DEFT_COMPACT_PLAN", "DEFT_REPLAY_DRAIN"))
    if switch != "default":
        name, _, value = switch.partition("=")
        env[name] = value or "0"
    with switches(**env):
        before = dict(counts)
        jgot = run_case(j_tree_generate, jr, jloader, jworkloads, JController, case,
                        j_mode(mode))
        jcount = {k: counts[k] - before[k] for k in counts}
        if tr is None:
            tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG, kv_dtype=kv),
                             device="cpu", params=params)
        stats, waits = dict(tr.replay_stats), host_wait.waits
        tgot = run_case(tree_generate, tr, tloader, workloads, Branch_Controller, case,
                        mode_from_cli(mode))
    tcount = {k: tr.replay_stats[k] - stats[k] for k in stats}
    tcount["waits"] = host_wait.waits - waits
    return jgot, jcount, tgot, tcount


@pytest.fixture(scope="module")
def slab_spies():
    """Counts of deft_tpu's slab windows (_slab_window) and slab steps
    (_decode_step with slab_rows), while the module runs."""
    counts = {"win": 0, "step": 0}
    orig_win, orig_step = JRunner._slab_window, JRunner._decode_step

    def spy_win(self, *a, **k):
        counts["win"] += 1
        return orig_win(self, *a, **k)

    def spy_step(self, *a, **k):
        counts["step"] += bool(k.get("slab_rows"))
        return orig_step(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JRunner, "_slab_window", spy_win)
        mp.setattr(JRunner, "_decode_step", spy_step)
        yield counts


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_replay_matches_deft_tpu(slab_spies, deft_runners, run):
    """Token ids, KV_IO, Mask_IO and generated_len equal deft_tpu's (its
    CPU route) under the same switches; both ran slab windows, none with
    DEFT_REPLAY_WINDOWS=0, and no slab at all with DEFT_REPLAY_EXEC=0 or
    where every step reads logits (beam search); with DEFT_REPLAY_DRAIN=1
    the port waited more often than at the default drain."""
    case, mode, kv, switch = run
    (jseqs, jpm), jcount, (tseqs, tpm), tcount = replay_pair(
        run, *deft_runners(kv=kv), slab_spies)
    assert tseqs and tseqs == jseqs
    assert tpm.generated_len == jpm.generated_len
    assert tpm.KV_IO == jpm.KV_IO and tpm.Mask_IO == jpm.Mask_IO
    if switch == "DEFT_REPLAY_EXEC" or case == "beam":
        assert tcount["win"] == tcount["step"] == 0 and jcount == {"win": 0, "step": 0}
    elif switch == "DEFT_REPLAY_WINDOWS":
        assert tcount["win"] == jcount["win"] == 0 and tcount["step"] > 0
    else:
        assert tcount["win"] > 0 and jcount["win"] > 0
    if switch == "DEFT_REPLAY_DRAIN=1":
        # a wait after every slab item, where the default drain (256) waits
        # once a span: the same sub-steps, more waits
        base = replay_pair((case, mode, kv, "default"), *deft_runners(kv=kv),
                           slab_spies)[3]
        assert tcount["subs"] == base["subs"] and tcount["waits"] > base["waits"]


# deft_tpu's Pallas route packs its plans as the port packs them (paged
# plans paged, the compact form), where its CPU route gathers every plan;
# so the executors' partitions are compared there
COUNTED = [("simple", "flatten", "inherit", "default"),
           ("practical", "flatten", "inherit", "default"),
           ("spec", "flatten", "inherit", "default"),
           ("practical", "flatten", "inherit", "DEFT_REPLAY_UNIFORM"),
           ("spec", "flatten", "inherit", "DEFT_REPLAY_WINDOWS")]


@pytest.fixture(scope="module")
def pallas_pair(deft_runners):
    """deft_tpu's runner on its Pallas route and a port runner on its
    weights, reused through COUNTED (the port's floors cleared as
    deft_runners clears deft_tpu's)."""
    jr, params = deft_runners(kernels="pallas")
    with switches(DEFT_PLAN_PATCH=None, DEFT_COMPACT_PLAN=None):
        tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                         params=params)
    return jr, params, tr


@pytest.mark.parametrize("run", COUNTED, ids=["-".join(r) for r in COUNTED])
def test_slab_windows_and_steps_match_deft_tpu(slab_spies, pallas_pair, run):
    """Against deft_tpu on its Pallas route (interpret mode): as many slab
    windows and slab steps, and the same token ids and IO."""
    jr, params, tr = pallas_pair
    for r in (jr, tr):
        r.reset_state()
        r._bucket_floors.clear()
        r._rpad_floor.clear()
    (jseqs, jpm), jcount, (tseqs, tpm), tcount = replay_pair(run, jr, params, slab_spies,
                                                             tr)
    assert tseqs and tseqs == jseqs
    assert tpm.KV_IO == jpm.KV_IO and tpm.Mask_IO == jpm.Mask_IO
    assert {k: tcount[k] for k in jcount} == jcount and sum(jcount.values()) > 0


@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_windows_match_per_step_and_deft_tpu(deft_runners, mode):
    """DEFT_REPLAY_EXEC=0: Simple_Tree's greedy iterations run as decode
    windows in both packages, as many windows; tokens and KV_IO equal the
    port's per-step chain (DEFT_PLAN_PATCH=0 too) and deft_tpu's."""
    calls = {"j": 0, "t": 0}
    jwin, twin = JRunner.forward_tree_decode_window, ModelRunner.forward_tree_decode_window

    def spy(pkg, orig):
        def wrapped(self, *a, **k):
            calls[pkg] += 1
            return orig(self, *a, **k)
        return wrapped

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JRunner, "forward_tree_decode_window", spy("j", jwin))
        mp.setattr(ModelRunner, "forward_tree_decode_window", spy("t", twin))
        for patch in ("1", "0"):
            jr, params = deft_runners(patch=patch)
            with switches(DEFT_REPLAY_EXEC="0", DEFT_PLAN_PATCH=patch):
                assert jr._plan_patch == (patch == "1")
                tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                                 params=params)
                out["j", patch] = run_case(j_tree_generate, jr, jloader, jworkloads,
                                           JController, "simple", j_mode(mode))
                n = calls["t"]
                out["t", patch] = run_case(tree_generate, tr, tloader, workloads,
                                           Branch_Controller, "simple", mode_from_cli(mode))
                if patch == "1":
                    windows = calls["t"] - n
                    assert tr.plan_upload_bytes < tr.plan_full_bytes
    assert windows > 0 and calls["j"] == windows  # no window without plan patches
    seqs, pm = out["t", "1"]
    for key in (("t", "0"), ("j", "1"), ("j", "0")):
        assert seqs == out[key][0], key
        assert pm.KV_IO == out[key][1].KV_IO, key



def test_pipelined_windows_match_deft_tpu(deft_runners):
    """tests/test_e2e.py:830-835's switches: decode windows
    (DEFT_REPLAY_EXEC=0) with DEFT_PIPE_WINDOWS=4 and DEFT_SYNC_PERIOD=32
    give deft_tpu's tokens and KV_IO under the same switches and the port's
    per-step chain's, on Simple_Tree (whose greedy iterations run as
    windows; Practical_Tree's are deferred selections, which no window
    takes); several windows ran, and the port waited fewer times than with
    one window in flight."""
    jr, params = deft_runners(patch="1")
    windows = {"n": 0}
    orig = ModelRunner.forward_tree_decode_window

    def spy(self, *a, **k):
        windows["n"] += 1
        return orig(self, *a, **k)

    out, waits = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ModelRunner, "forward_tree_decode_window", spy)
        for name, env in (("chain", dict(DEFT_PLAN_PATCH="0")),
                          ("pipe 1", dict(DEFT_PIPE_WINDOWS=None, DEFT_SYNC_PERIOD=None)),
                          ("pipe 4", dict(DEFT_PIPE_WINDOWS="4", DEFT_SYNC_PERIOD="32"))):
            with switches(DEFT_REPLAY_EXEC="0", **env):
                tr = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                                 params=params)
                n, w = windows["n"], host_wait.waits
                out[name] = run_case(tree_generate, tr, tloader, workloads,
                                     Branch_Controller, "simple",
                                     ForwardMode.TREE_DECODE_FLATTEN)
                waits[name] = host_wait.waits - w
                assert (windows["n"] - n > 1) == (name != "chain"), name
        with switches(DEFT_REPLAY_EXEC="0", DEFT_PIPE_WINDOWS="4", DEFT_SYNC_PERIOD="32"):
            want = run_case(j_tree_generate, jr, jloader, jworkloads, JController, "simple",
                            j_mode("flatten"))
    for name, (seqs, pm) in out.items():
        assert seqs and seqs == want[0], name
        assert pm.KV_IO == want[1].KV_IO, name
    assert waits["pipe 4"] < waits["pipe 1"], waits
