"""deft_tpu_torch's decode modes against deft_tpu's, on the CPU in fp32.

- Simple_Tree's tokens in node, node_chunk, tree_index and the unpaged
  modes (flatten, node, seq, tree = Medusa) equal deft_tpu's in the same
  mode and the port's flatten;
- build_node_plan (whole nodes and chunked) and build_tree_index_plan equal
  deft_tpu's field by field on a fragmented tree (branches, prunes,
  speculative merges), built with the same fixed kwargs;
- Medusa's IO accounting equals deft_tpu's on both packages' default
  path: the dense model on the per-step path (generate.py:597-605), the
  flatten mask on the replayed steps (:406-411), as deft_tpu's default CLI
  run counts it;
- the runner routes each mode to its attention entry, on one device and on
  a grid, which runs every decode mode.
"""

import numpy as np
import pytest
import torch

import deft_tpu.core as jcore
import deft_tpu.plan as jplan
import deft_tpu_torch.core as tcore
import deft_tpu_torch.plan as tplan
from deft_tpu.config import AttentionConfig as JAttentionConfig
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu_torch.config import AttentionConfig, EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.ops import attn_impls
from deft_tpu_torch.runtime import ForwardMode, ModelRunner, mode_from_cli, tree_generate
from test_torch_core_plan import make_trees, run_schedule

ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(np.random.default_rng(1).integers(4, 500, 300))
WIDTH, GEN = 3, 10
BLOCK = 128
# (--mode, --mem, node_chunk_len): the CLI's names
MODES = {"node": ("node", "paged", None), "node_chunk": ("node_chunk", "paged", 64),
         "tree_index": ("tree_index", "paged", None),
         "unpaged flatten": ("flatten", "unpaged", None),
         "unpaged node": ("node", "unpaged", None),
         "unpaged seq": ("seq", "unpaged", None), "medusa": ("tree", "unpaged", None)}


def generate(pkg_runner, generate_fn, controller, mode):
    pm = generate_fn(pkg_runner, mode, None, PROMPT, max_seq_len=len(PROMPT) + GEN,
                     width=WIDTH, depth=1, branch_controller=controller)
    return [tuple(s.token_ids) for s in pkg_runner.tree.all_finished_seqs], pm


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's generations in every mode, its flatten, and its weights."""
    out, params = {}, None
    for name, (mode, mem, chunk) in list(MODES.items()) + [
            ("flatten", ("flatten", "paged", None))]:
        ecfg = JEngineConfig(**ECFG, attention=JAttentionConfig(
            block_len=BLOCK, node_chunk_len=chunk))
        jr = JRunner(JPRESETS["tiny"], ecfg, kernels="xla", seed=0,
                     use_tree_index=mode == "tree_index")
        params = jr.params
        out[name] = generate(jr, j_tree_generate, JController(jworkloads.simple_tree),
                             j_mode(mode, mem))
    return params, out


def port_runner(jparams, mode="flatten", chunk=None):
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               PRESETS["tiny"], "cpu", torch.float32)
    ecfg = EngineConfig(**ECFG, attention=AttentionConfig(block_len=BLOCK,
                                                          node_chunk_len=chunk))
    return ModelRunner(PRESETS["tiny"], ecfg, device="cpu", params=params,
                       use_tree_index=mode == "tree_index")


@pytest.mark.parametrize("name", list(MODES))
def test_mode_matches_deft_tpu_and_flatten(reference, name):
    jparams, ref = reference
    mode, mem, chunk = MODES[name]
    runner = port_runner(jparams, mode, chunk)
    plans = []
    build = runner.build_plan
    runner.build_plan = lambda m: plans.append(build(m)) or plans[-1]
    got, pm = generate(runner, tree_generate, Branch_Controller(workloads.simple_tree),
                       mode_from_cli(mode, mem))
    want, jpm = ref[name]
    assert len(got) == WIDTH and all(len(t) == GEN - 1 for t in got)
    assert got == want
    assert got == ref["flatten"][0]  # attention is exact in every mode
    assert pm.generated_len == jpm.generated_len
    assert pm.KV_IO == jpm.KV_IO and pm.Mask_IO == jpm.Mask_IO
    # the 300-token prompt keeps every plan segment-aligned, so the paged
    # kernels' plain versions ran; node plans pad each node to a block
    assert all(p.paged for p in plans)
    if mode in ("node", "node_chunk", "tree_index"):
        assert all(p.t_pad > p.n_tokens + BLOCK for p in plans)


def test_medusa_io_accounting_matches_deft_tpu(reference):
    """UNPAGED_MEDUSA counts the dense baseline's materialised scores, mask
    and softmax bytes, per layer, on its per-step steps (deft_tpu
    generate.py:597-605), and the flatten mask on its replayed ones
    (:406-411): every field equals deft_tpu's default run's."""
    jparams, ref = reference
    runner = port_runner(jparams)
    _, pm = generate(runner, tree_generate, Branch_Controller(workloads.simple_tree),
                     mode_from_cli("tree", "unpaged"))
    jpm = ref["medusa"][1]
    for f in ("QK_IO", "QK_scale_IO", "QK_scale_masked_IO", "SoftMax_IO", "Mask_IO",
              "KV_IO", "QO_IO"):
        assert getattr(pm, f) == getattr(jpm, f) and getattr(pm, f) > 0, f
    assert set(pm.as_dict()) == set(jpm.as_dict())


PLAN_KW = [dict(q_per_kv=4, block_len=128, min_token_bucket=256),
           dict(q_per_kv=4, block_len=256, min_token_bucket=1024),
           dict(q_per_kv=2, block_len=256, min_token_bucket=512, seg_len=32),
           dict(q_per_kv=4, block_len=256, min_token_bucket=1024,
                seg_len=(512, 256, 128), waste_limit=(1.1, 1.2, 3.0))]
FIELDS = ("kv_idx", "tok_lo", "tok_hi", "blk_lo", "blk_hi", "q_tokens", "q_pos",
          "out_loc", "seg_src", "run_table")


def assert_same_plan(pa, pb, what):
    for f in FIELDS:
        x, y = getattr(pa, f), getattr(pb, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    for f in ("n_tokens", "n_leaves", "block_len", "seg_len", "paged", "n_live_pad"):
        assert getattr(pa, f) == getattr(pb, f), (what, f)


@pytest.mark.parametrize("seed", range(3))
def test_node_and_tree_index_plans_match_deft_tpu(seed):
    """Both packages' trees (with tree-index pools) go through one seeded
    schedule of branches, prunes, merges and appends (test_torch_core_plan's
    run_schedule); then every node, node_chunk and tree_index plan is equal
    field by field, with the flags fixed."""
    trees = make_trees()
    for pkg, t in zip((jcore, tcore), trees):
        t.tree_index_pool = pkg.TreeIndexPool(128, 2048)
    run_schedule(seed, trees, check_plans_every=1000)
    for t in trees:
        t.alloc()
    for kw in PLAN_KW:
        for chunk in (None, 64, 128):
            a = jplan.build_node_plan(trees[0], chunk_len=chunk, **kw)
            b = tplan.build_node_plan(trees[1], chunk_len=chunk, **kw)
            assert_same_plan(a, b, f"node chunk {chunk} {kw}")
        a = jplan.build_tree_index_plan(trees[0], **kw)
        b = tplan.build_tree_index_plan(trees[1], **kw)
        assert_same_plan(a, b, f"tree_index {kw}")
        # the tree-index rows give the same layout as the node runs
        assert_same_plan(tplan.build_node_plan(trees[1], **kw), b, f"rows {kw}")


def test_attention_routes():
    """Each mode's attention entry (deft_tpu runner.py:448-477): the
    flatten-family modes the flatten kernels, UNPAGED_MEDUSA the dense
    masked attention over kv_idx even when its plan is paged."""
    runner = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu")
    for mode in (ForwardMode.TREE_DECODE_NODE, ForwardMode.TREE_DECODE_INDEX_NODE,
                 ForwardMode.UNPAGED_DEFT_NODE, ForwardMode.UNPAGED_DEFT_FLATTEN):
        assert runner._attn_fn(mode, True) is attn_impls.flatten_attn
        assert runner._attn_fn(mode, False) is attn_impls.flatten_gather_attn
    assert runner._attn_fn(ForwardMode.UNPAGED_FD, True) is attn_impls.seq_attn
    medusa = ForwardMode.UNPAGED_MEDUSA
    for paged in (True, False):
        assert runner._attn_fn(medusa, paged) is attn_impls.flatten_attn_xla
    runner.forward_prefill(PROMPT)
    for c, child in enumerate(runner.tree.branch(runner.tree.root, 2)):
        child.append_token(30 + c)
    runner.tree.alloc()
    plan = runner.build_plan(medusa)
    assert plan.paged and not runner._use_paged(plan, medusa)
    batch = runner._step_batch(plan, runner._use_paged(plan, medusa))
    assert hasattr(batch, "kv_idx") and not hasattr(batch, "seg_src")


def test_grid_refuses_other_modes():
    """A (dp, sp, tp) grid runs every decode mode (deft_tpu runner.py
    :420-447): the flatten-family modes through the sharded flatten
    AttnFn (B1p / B4p / B11 on the rank windows), paged seq through the
    sharded seq AttnFn (B2p / B5p), unpaged seq through B7 on the rank's
    heads and Medusa through the dense baseline on the rank's heads, every
    row, as on one card.  PREFILL is no decode mode: it has no plan and
    still raises."""
    from deft_tpu_torch.parallel.mesh import Grid

    runner = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                         mesh=Grid((1, 2, 2), 0, torch.device("cpu")))
    assert runner.mesh is not None

    def route(mode, paged):
        fn = runner._attn_fn(mode, paged)
        plain = (attn_impls.seq_gather_attn, attn_impls.flatten_attn_xla)
        return fn if fn in plain else fn.__qualname__.split(".")[0]

    for mode in ForwardMode:
        if mode is ForwardMode.PREFILL:
            with pytest.raises(ValueError):
                runner._attn_fn(mode, True)
            continue
        for paged in (True, False):
            if mode is ForwardMode.UNPAGED_MEDUSA:
                want = attn_impls.flatten_attn_xla
            elif mode.plan_kind != "seq":
                want = "make_sharded_tree_attn"
            else:
                want = "make_sharded_seq_attn" if paged else attn_impls.seq_gather_attn
            assert route(mode, paged) == want, (mode, paged)
