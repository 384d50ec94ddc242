"""deft_tpu_torch's templates, dataset loaders, sampling and CLI against
deft_tpu's, on the CPU.

- synth_tot_tree and synth_spec_tree equal deft_tpu's node by node, with
  the same branch and prune records, over several seeds;
- JSON written by either package's save_tot_json / save_spec_json loads
  through the other's load_trees / load_prompts to the same trees;
- generate_accepted_len_list, sample_token and SamplingParams.verify
  behave as deft_tpu's on the same inputs and RandomState;
- the CLI with every --Branch_controller, --mode node --mem unpaged and a
  --dataset file prints the branch tokens of deft_tpu's CLI
  (--platform cpu --kernels xla) for the same flags.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest

import deft_tpu.data.loader as jloader
import deft_tpu.data.synthetic as jsynth
import deft_tpu_torch.data.loader as tloader
import deft_tpu_torch.data.synthetic as tsynth
from deft_tpu.runtime.runner import LogitsView as JLogitsView
from deft_tpu.runtime.sampling import SamplingParams as JSamplingParams
from deft_tpu.runtime.sampling import sample_token as j_sample_token
from deft_tpu_torch.runtime.runner import LogitsView
from deft_tpu_torch.runtime.sampling import SamplingParams, sample_token


def tree_record(tree):
    """Everything an ExecuteTree holds, as plain values."""
    nodes = [(n.id, n.value, n.start_offset, n.end_offset, n.depth, n.width,
              [c.id for c in n.children]) for n in tree.nodes]
    return (nodes, tree.branch_record, tree.prune_record, tree.max_depth,
            tree.max_width, tree.width_per_depth, tree.node_num, tree.prompt,
            tree.accepted_len_list)


@pytest.mark.parametrize("seed", range(5))
def test_synthetic_templates_match_deft_tpu(seed):
    for kw in (dict(width=4, max_leaves=50, total_iters=63),
               dict(width=3, max_leaves=6, total_iters=40, mean_run=3),
               dict(width=1, total_iters=20)):
        assert (tree_record(tsynth.synth_tot_tree(seed=seed, **kw))
                == tree_record(jsynth.synth_tot_tree(seed=seed, **kw)))
    for kw in (dict(token_tree_size=50, gen_len=63), dict(token_tree_size=8, gen_len=300,
                                                          mean_accept=3.0)):
        assert (tree_record(tsynth.synth_spec_tree(seed=seed, **kw))
                == tree_record(jsynth.synth_spec_tree(seed=seed, **kw)))
    tot = tsynth.synth_tot_tree(seed=seed, width=4, max_leaves=50, total_iters=63)
    assert tsynth.tot_tree_to_record(tot) == jsynth.tot_tree_to_record(
        jsynth.synth_tot_tree(seed=seed, width=4, max_leaves=50, total_iters=63))


@pytest.mark.parametrize("writer", ["deft_tpu", "port"])
def test_json_round_trip_between_packages(tmp_path, writer):
    """Each package's files load through the other's readers to the same
    trees; an incomplete trace is skipped, a .pkl file loads too."""
    w_synth, w_loader = (jsynth, jloader) if writer == "deft_tpu" else (tsynth, tloader)
    tots = [w_synth.synth_tot_tree(seed=s, width=3, max_leaves=8, total_iters=30,
                                   prompt=f"question {s}") for s in range(3)]
    specs = [w_synth.synth_spec_tree(token_tree_size=6, gen_len=40, seed=s,
                                     prompt=f"draft {s}") for s in range(3)]
    tot_path, spec_path = tmp_path / "tot.json", tmp_path / "spec.json"
    w_synth.save_tot_json(tots, str(tot_path))
    w_synth.save_spec_json(specs, str(spec_path))
    data = json.loads(tot_path.read_text())
    data.insert(1, dict(data[0], incompleted=True))
    tot_path.write_text(json.dumps(data))
    for path, load in ((tot_path, "load_trees"), (spec_path, "load_prompts")):
        want = [tree_record(t) for t in getattr(jloader, load)(str(path))]
        got = [tree_record(t) for t in getattr(tloader, load)(str(path))]
        assert got == want and len(got) == 3
    assert [tree_record(t) for t in tloader.load_trees(str(tot_path))] == [
        tree_record(t) for t in w_loader.load_trees(str(tot_path))]
    import pickle

    pkl = tmp_path / "spec.pkl"
    pkl.write_bytes(pickle.dumps(json.loads(spec_path.read_text())))
    assert ([tree_record(t) for t in tloader.load_prompts(str(pkl))]
            == [tree_record(t) for t in jloader.load_prompts(str(pkl))])
    with pytest.raises(NotImplementedError):
        tloader.load_trees(str(tmp_path / "tot.csv"))


@pytest.mark.parametrize("accepts", [[2, 1, 3], [0, 5, 1, 1, 9, 2], [0, 0], [4] * 30])
def test_generate_accepted_len_list_matches_deft_tpu(accepts):
    for max_gen in (1, 7, 40, 300):
        for seed in (0, 3):
            trees = []
            for loader in (jloader, tloader):
                tree = loader.ExecuteTree(loader.ExecuteTreeNode(0),
                                          [loader.ExecuteTreeNode(0)])
                tree.accepted_len_list = list(accepts)
                loader.generate_accepted_len_list(max_gen, tree, seed=seed)
                trees.append(tree.accepted_len_list)
            assert trees[0] == trees[1]


@pytest.mark.parametrize("params", [
    dict(temperature=0.8, top_k=8), dict(temperature=0.8, top_p=0.95, top_k=50),
    dict(temperature=0.0), dict(temperature=1.5, top_p=0.5), dict(temperature=0.002),
    dict()])
def test_sample_token_matches_deft_tpu(params):
    rng = np.random.default_rng(5)
    vals = np.sort(rng.random((6, 64)), axis=1)[:, ::-1].astype(np.float32)
    vals = vals / vals.sum(1, keepdims=True) + 1e-6
    ids = rng.integers(0, 1000, (6, 64)).astype(np.int32)
    views = LogitsView(vals, ids), JLogitsView(vals, ids)
    rngs = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(40):
        for row in range(6):
            got = sample_token(views[0], row, SamplingParams(**params), rngs[0])
            want = j_sample_token(views[1], row, JSamplingParams(**params), rngs[1])
            assert got == want


@pytest.mark.parametrize("bad", [dict(temperature=-1.0), dict(top_p=0.0),
                                 dict(top_p=1.5), dict(top_k=0), dict(top_k=-2),
                                 dict(max_new_tokens=-1)])
def test_verify_raises_where_deft_tpu_does(bad):
    with pytest.raises(ValueError) as want:
        JSamplingParams(**bad).verify()
    with pytest.raises(ValueError) as got:
        SamplingParams(**bad).verify()
    assert str(got.value) == str(want.value)


def branch_tokens(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return re.findall(r"Tokens in this path:(\[.*?\])", out.getvalue())


BASE = ["--random-model", "tiny", "--dtype", "float32", "--kv_pool_slots", "4096",
        "--max_width", "4", "--max_seq_len", "44", "--print-branches"]


@pytest.mark.parametrize("flags", [
    ["--Branch_controller", "Practical_Tree"],
    ["--Branch_controller", "Practical_Tree", "--mode", "seq", "--tree_idx", "2"],
    ["--Branch_controller", "Speculative_Decoding"],
    ["--Branch_controller", "Speculative_Decoding", "--mode", "seq"],
    ["--Branch_controller", "Beam_Search"],
    ["--Branch_controller", "Random_Tree", "--seed", "3"],
    ["--mode", "node", "--mem", "unpaged"],
    ["--mode", "node_chunk", "--node_chunk_len", "64", "--block_len", "128"],
    ["--mode", "tree_index", "--traversal", "bfs_node"],
])
def test_cli_prints_deft_tpus_tokens(flags):
    from deft_tpu.cli import run as jrun
    from deft_tpu_torch.cli import run as trun

    want = branch_tokens(jrun.main, BASE + flags + ["--platform", "cpu", "--kernels",
                                                    "xla"])
    got = branch_tokens(trun.main, BASE + flags + ["--device", "cpu"])
    assert got and got == want


@pytest.mark.parametrize("controller", ["Practical_Tree", "Speculative_Decoding"])
def test_cli_dataset_matches_deft_tpu(tmp_path, controller):
    """--dataset: a template file with prompt text, encoded by the
    random-init tokenizer (words hashed into the vocabulary) and padded to
    --prompt_len, as deft_tpu's CLI does."""
    from deft_tpu.cli import run as jrun
    from deft_tpu_torch.cli import run as trun

    path = tmp_path / "templates.json"
    if controller == "Practical_Tree":
        trees = [tsynth.synth_tot_tree(seed=s, width=3, max_leaves=6, total_iters=20,
                                       mean_run=3, prompt=f"Solve 24 with {s} 7 -3 x²")
                 for s in range(3)]
        tsynth.save_tot_json(trees, str(path))
    else:
        trees = [tsynth.synth_spec_tree(token_tree_size=5, gen_len=30, seed=s,
                                        prompt=f"draft {s} tokens") for s in range(2)]
        tsynth.save_spec_json(trees, str(path))
    flags = BASE + ["--Branch_controller", controller, "--dataset", str(path),
                    "--tree_idx", "1", "--prompt_len", "20"]
    want = branch_tokens(jrun.main, flags + ["--platform", "cpu", "--kernels", "xla"])
    got = branch_tokens(trun.main, flags + ["--device", "cpu"])
    assert got and got == want
    from deft_tpu.cli.run import _IdTokenizer
    from deft_tpu_torch.cli.run import encode

    text = "Solve 24 with 1 7 -3 x² ²"
    assert encode(text, 512) == _IdTokenizer(512).encode(text)
