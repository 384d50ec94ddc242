"""deft_tpu_torch's workloads against deft_tpu's, on the CPU in fp32.

Every workload of control/workloads.py runs through tree_generate in flatten
and in seq mode on the tiny preset with deft_tpu's numpy weights: the ToT
replay (practical_tree) on tests/test_e2e.py's hand template and on a
synthetic template, speculative decoding on a hand token tree and on a
synthetic one, beam search, the random tree (seeds 0 and 5, the port's
passed through tree_generate) and sampled Simple_Tree (its RandomState
passed the same way).  deft_tpu runs its CPU route (kernels="xla"); the
port's decode kernels run their plain versions, which tests/test_torch_b*.py
hold against deft_tpu's interpret-mode Pallas kernels.  Attention is exact, so finished token ids,
generated_len and KV_IO must be equal.
"""

import functools

import numpy as np
import pytest
import torch

import deft_tpu.data.loader as jloader
import deft_tpu.data.synthetic as jsynth
import deft_tpu_torch.data.loader as tloader
import deft_tpu_torch.data.synthetic as tsynth
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu.runtime.sampling import SamplingParams as JSamplingParams
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import params_from_numpy
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate
from deft_tpu_torch.runtime.sampling import SamplingParams

ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(range(7, 19))  # 12 tokens, tests/test_e2e.py's
SAMPLED = dict(temperature=0.8, top_k=8)


def hand_tot(loader):
    """tests/test_e2e.py:112's template: the root branches into 2 at iter 0,
    node 1 into 2 at iter 3, everything prunes at iter 6."""
    N = loader.ExecuteTreeNode
    root, n1, n2 = N(0, 1, 0, 0), N(1, 3, 0, 3), N(2, 6, 0, 6)
    n3, n4 = N(3, 3, 3, 6), N(4, 3, 3, 6)
    root.children, n1.children = [n1, n2], [n3, n4]
    return loader.ExecuteTree(root, [root, n1, n2, n3, n4])


def hand_spec(loader):
    """tests/test_e2e.py:138's token tree: 8 nodes, accepts 2, 1, 3."""
    tpl = loader.ExecuteTree(loader.ExecuteTreeNode(0),
                             [loader.ExecuteTreeNode(i) for i in range(8)])
    tpl.accepted_len_list = [2, 1, 3]
    return tpl


def synth_spec(loader, synth, max_gen):
    tpl = synth.synth_spec_tree(token_tree_size=6, gen_len=max_gen - 1, seed=1)
    loader.generate_accepted_len_list(max_gen, tpl, seed=0)
    return tpl


# name -> (workload name, template maker (loader, synth, max_gen) or None,
#          generated tokens, width)
CASES = {
    "practical_hand": ("practical_tree", lambda ld, sy, g: hand_tot(ld), 8, 2),
    "practical_synth": ("practical_tree", lambda ld, sy, g: sy.synth_tot_tree(
        seed=3, width=3, max_leaves=6, total_iters=g - 1, mean_run=3), 20, 6),
    "spec_hand": ("speculative_decoding", lambda ld, sy, g: hand_spec(ld), 32, 8),
    "spec_synth": ("speculative_decoding", synth_spec, 14, 6),
    "beam": ("beam_search", None, 12, 4),
    "random": ("random_tree", None, 16, 3),
    "random_seed5": ("random_tree", None, 16, 3),
    "sampled": ("simple_tree", None, 12, 3),
}


def deft_run(jr, case, mode):
    name, make, gen, width = CASES[case]
    fn = getattr(jworkloads, name)
    if case == "sampled":
        fn = functools.partial(fn, sampling_params=JSamplingParams(**SAMPLED),
                               rng=np.random.RandomState(7))
    if case == "random_seed5":
        fn = functools.partial(fn, seed=5)
    jr.reset_state()
    pm = j_tree_generate(jr, j_mode(mode), None, PROMPT, max_seq_len=len(PROMPT) + gen,
                         width=width, depth=2, branch_controller=JController(fn),
                         tree_template=make(jloader, jsynth, gen) if make else None)
    return [tuple(s.token_ids) for s in jr.tree.all_finished_seqs], pm


def port_run(runner, case, mode, **kw):
    name, make, gen, width = CASES[case]
    fn = getattr(workloads, name)
    if case == "sampled":  # the RandomState through tree_generate
        fn = functools.partial(fn, sampling_params=SamplingParams(**SAMPLED))
        kw.setdefault("rng", np.random.RandomState(7))
    if case == "random_seed5":  # through tree_generate
        kw.setdefault("seed", 5)
    pm = tree_generate(runner, mode_from_cli(mode), None, PROMPT,
                       max_seq_len=len(PROMPT) + gen, width=width, depth=2,
                       branch_controller=Branch_Controller(fn),
                       tree_template=make(tloader, tsynth, gen) if make else None, **kw)
    return [tuple(s.token_ids) for s in runner.tree.all_finished_seqs], pm


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's generations of every case and mode, and its weights."""
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla", seed=0)
    out = {(case, mode): deft_run(jr, case, mode)
           for case in CASES for mode in ("flatten", "seq")}
    return jr.params, out


@pytest.fixture(scope="module")
def port_params(reference):
    return params_from_numpy({k: np.asarray(v) for k, v in reference[0].items()},
                             PRESETS["tiny"], "cpu", torch.float32)


def port_runner(params, **kw):
    return ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                       params=params, **kw)


@pytest.mark.parametrize("mode", ["flatten", "seq"])
@pytest.mark.parametrize("case", list(CASES))
def test_workload_matches_deft_tpu(reference, port_params, case, mode):
    got, pm = port_run(port_runner(port_params), case, mode)
    want, jpm = reference[1][case, mode]
    assert got and got == want
    assert pm.generated_len == jpm.generated_len
    assert pm.KV_IO == jpm.KV_IO and pm.Mask_IO == jpm.Mask_IO


@pytest.mark.parametrize("case", ["spec_hand", "spec_synth"])
def test_speculative_skip_matches_retained_logits(port_params, case):
    """Speculative decoding's decode steps read no logits: they skip the
    lm_head ("skip", an (R, 1) view of zeros) unless full logits are
    retained, which turns them back into "topk" (deft_tpu
    tests/test_e2e.py:152).  The replayed tree is the same either way.
    Each step goes through forward_tree_decode: the record path, which
    retained logits turn off, is off here too (DEFT_REPLAY_EXEC=0)."""
    out = {}
    for retain in (False, True):
        runner = port_runner(port_params, retain_full_logits=retain)
        kinds, ks = [], []
        forward = runner.forward_tree_decode

        def recording(mode, plan, logits_kind="topk", _f=forward, **kw):
            kinds.append(logits_kind)
            view, t = _f(mode, plan, logits_kind=logits_kind, **kw)
            ks.append(view.k)
            return view, t

        runner.forward_tree_decode = recording
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DEFT_REPLAY_EXEC", "0")
            out[retain] = port_run(runner, case, "flatten")[0]
        assert set(kinds) == {"skip"}  # every decode step is logits-free
        assert set(ks) == ({runner.topk_k} if retain else {1})
    assert out[False] == out[True]


def test_sampled_temperature_zero_is_greedy(port_params):
    """Sampling at temperature 0 takes each row's top token: the tokens of
    greedy Simple_Tree."""
    runner = port_runner(port_params)
    fn = functools.partial(workloads.simple_tree,
                           sampling_params=SamplingParams(temperature=0.0))
    gen, width = CASES["sampled"][2:]
    runs = []
    for f in (fn, workloads.simple_tree):
        tree_generate(runner, mode_from_cli("flatten"), None, PROMPT,
                      max_seq_len=len(PROMPT) + gen, width=width, depth=1,
                      branch_controller=Branch_Controller(f))
        runs.append([tuple(s.token_ids) for s in runner.tree.all_finished_seqs])
    assert runs[0] == runs[1] and len(runs[0]) == width


def test_workload_attributes_match_deft_tpu():
    """structural_iters, logits_free_iters and supports_deferred, and the
    reference-name aliases, as deft_tpu declares them."""
    tpl_j, tpl_t = hand_tot(jloader), hand_tot(tloader)
    for name in ("simple_tree", "practical_tree", "speculative_decoding",
                 "beam_search", "random_tree"):
        j, t = getattr(jworkloads, name), getattr(workloads, name)
        for attr in ("structural_iters", "logits_free_iters"):
            assert hasattr(j, attr) == hasattr(t, attr), (name, attr)
            if hasattr(j, attr):
                assert (set(getattr(j, attr)(tpl_j, 20))
                        == set(getattr(t, attr)(tpl_t, 20))), (name, attr)
        assert (getattr(j, "supports_deferred", False)
                == getattr(t, "supports_deferred", False)), name
    for alias in ("example_branch_Func1_SimpleTree", "example_branch_Func2_BeamSearch",
                  "example_branch_Func3_FromTreeTemplate",
                  "example_branch_Func4_SpeculativeDecoding"):
        assert (getattr(workloads, alias).__name__
                == getattr(jworkloads, alias).__name__)
