"""deft_tpu_torch on local HF checkpoints of every family deft_tpu loads,
held against deft_tpu and against transformers.

Six tiny random HF models (Llama, Qwen2 with qkv biases, Qwen3 with q/k
norms, Gemma with (1 + w) norms, GeGLU and a tied lm_head, Mixtral's sparse
MoE, Phi-3 with fused qkv/gate_up tensors and LongRoPE), built as
tests/test_hf_parity.py builds them and saved with ``save_pretrained``:

- the port's parsed config equals deft_tpu's;
- the port's load_params equals deft_tpu's (fused names) exactly in fp32;
- the prefill distribution matches HF and deft_tpu within atol 5e-5;
- a branch-into-2 tree decode matches HF's per-path rerun within 5e-5,
  with equal greedy ids;
- an int8 load stays within 5e-2 of HF with an equal argmax;
- ``--model`` runs the CLI on each checkpoint;
- a tiny Qwen2 and Qwen3 on a gloo grid 1x1x2 give the single process's
  first decode step within 2e-5;
- Gemma at head_dim 256 and Phi-3 at 96 through the batched admission (three
  prompts in one ragged prefill) give each prompt's single prefill and
  deft_tpu's batched prefill within 2e-5, and BatchedEngine deft_tpu's
  branches.

Then the port's safetensors reader against ``safetensors.safe_open`` (F32,
BF16 and a two-file checkpoint), the ``.bin`` path, and the loader's
refusals.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import transformers
from safetensors import safe_open
from safetensors.torch import save_file

import chip_smoke as cs
import deft_tpu.core as jcore
import deft_tpu_torch.core as tcore
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models.config import LlamaConfig as JLlamaConfig
from deft_tpu.models.loader import load_params as j_load_params
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime.batched import BatchedEngine as JEngine
from deft_tpu.runtime.batched import Request as JRequest
from deft_tpu_torch.cli import run as cli
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.models.config import LlamaConfig
from deft_tpu_torch.models.loader import load_params, read_safetensors
from deft_tpu_torch.parallel import launch
from deft_tpu_torch.parallel.launch import first_step, run_all
from deft_tpu_torch.runtime import ForwardMode, ModelRunner, mode_from_cli
from deft_tpu_torch.runtime.batched import BatchedEngine, Request

PROMPT = [3, 11, 250, 77, 141, 9, 62, 200, 5, 18, 33, 127]
DECODE_STEPS = 6
FAMILIES = ["llama", "qwen2", "qwen3", "gemma", "mixtral", "phi3"]
ECFG = dict(kv_pool_slots=2048, max_requests=16, max_context_len=256,
            min_token_bucket=128, dtype="float32")
_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=512, rms_norm_eps=1e-5,
             tie_word_embeddings=False, torch_dtype=torch.float32)


def make_hf(family, head_dim=16):
    """The tiny HF model of ``family`` (tests/test_hf_parity.py:48-96).
    ``head_dim``: Gemma's head width, or Phi-3's (its hidden size is the
    heads' width, so 96 gives Phi-3-mini's)."""
    if family == "llama":
        cfg = transformers.LlamaConfig(rope_theta=10000.0, attention_bias=False,
                                       mlp_bias=False, **_TINY)
        cls = transformers.LlamaForCausalLM
    elif family == "qwen2":
        cfg = transformers.Qwen2Config(rope_theta=1e6, use_sliding_window=False, **_TINY)
        cls = transformers.Qwen2ForCausalLM
    elif family == "qwen3":
        cfg = transformers.Qwen3Config(rope_theta=1e6, use_sliding_window=False,
                                       attention_bias=False, head_dim=16, **_TINY)
        cls = transformers.Qwen3ForCausalLM
    elif family == "gemma":
        cfg = transformers.GemmaConfig(rope_theta=10000.0, attention_bias=False,
                                       head_dim=head_dim,
                                       **(_TINY | {"tie_word_embeddings": True}))
        cls = transformers.GemmaForCausalLM
    elif family == "mixtral":
        cfg = transformers.MixtralConfig(rope_theta=1e6, sliding_window=None,
                                         attention_bias=False, num_local_experts=4,
                                         num_experts_per_tok=2, **_TINY)
        cls = transformers.MixtralForCausalLM
    else:
        half = head_dim // 2
        cfg = transformers.Phi3Config(
            rope_theta=10000.0, sliding_window=None, pad_token_id=0,
            original_max_position_embeddings=256,
            rope_scaling={"type": "longrope",
                          "short_factor": [1.0 + 0.25 * i for i in range(half)],
                          "long_factor": [4.0 + 0.5 * i for i in range(half)]},
            **(_TINY | {"hidden_size": head_dim * _TINY["num_attention_heads"]}))
        cls = transformers.Phi3ForCausalLM
    torch.manual_seed(0)
    return cls(cfg).eval()


@pytest.fixture(scope="module", params=FAMILIES)
def hf_model(request, tmp_path_factory):
    model = make_hf(request.param)
    d = tmp_path_factory.mktemp(f"hf_{request.param}")
    model.save_pretrained(d, safe_serialization=True)
    return str(d), model


def hf_next_probs(model, token_ids):
    with torch.no_grad():
        logits = model(torch.tensor([token_ids])).logits[0, -1]
    return torch.softmax(logits.double(), -1).numpy()


def port_runner(path, **kw):
    return ModelRunner(LlamaConfig.from_pretrained(path), EngineConfig(**ECFG, **kw),
                       device="cpu", model_path=path, retain_full_logits=True)


def port_probs(view, rows):
    return torch.softmax(view.full_logits()[:rows].double(), -1).numpy()


def test_config_matches_deft_tpu(hf_model):
    path, _ = hf_model
    cfg = json.loads((pathlib.Path(path) / "config.json").read_text())
    assert LlamaConfig.from_hf_config(cfg).__dict__ == JLlamaConfig.from_hf_config(cfg).__dict__


@pytest.mark.parametrize("window", [None, 2047])
def test_phi3_mini_widths_parse_alike_and_refuse_its_window(window):
    """chip_smoke.py's served Phi-3-mini-widths family (Phi-3-mini-4k's
    config.json with sliding_window null) parses to equal fields in both
    packages, at D 96; with the published window, 2047 of 4096 positions,
    both refuse it."""
    cfg = dict(cs.FAMILIES["phi-3-mini"][1], sliding_window=window)
    if window is None:
        port = LlamaConfig.from_hf_config(cfg)
        assert port.__dict__ == JLlamaConfig.from_hf_config(cfg).__dict__
        assert (port.num_layers, port.num_q_heads, port.num_kv_heads, port.head_dim,
                port.vocab_size) == (32, 32, 32, 96, 32064)
        assert cs.PROMPT_LEN + cs.GEN_LEN <= port.max_position_embeddings
    else:
        for parse in (LlamaConfig.from_hf_config, JLlamaConfig.from_hf_config):
            with pytest.raises(NotImplementedError, match="sliding_window=2047"):
                parse(cfg)


def test_load_params_matches_deft_tpu(hf_model):
    path, _ = hf_model
    cfg = LlamaConfig.from_pretrained(path)
    got = load_params(path, cfg, "cpu", torch.float32)
    want = j_load_params(path, JLlamaConfig.from_pretrained(path),
                         dtype=np.float32, fuse=True)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w), err_msg=name)


def test_prefill_matches_hf_and_deft_tpu(hf_model):
    path, model = hf_model
    view = port_runner(path).forward_prefill(PROMPT)
    got = port_probs(view, 1)[0]
    np.testing.assert_allclose(got, hf_next_probs(model, PROMPT), rtol=0, atol=5e-5)
    jr = JRunner(JLlamaConfig.from_pretrained(path), JEngineConfig(**ECFG),
                 kernels="xla", model_path=path, retain_full_logits=True)
    want = jr.forward_prefill(PROMPT).full_probs()[0] - 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    assert int(view.ids[0, 0]) == int(want.argmax())


def test_tree_decode_matches_hf_per_path(hf_model):
    """Branch the root into the prefill's top 2, decode greedily: every
    step, each leaf's distribution is HF's over the leaf's whole path."""
    path, model = hf_model
    runner = port_runner(path)
    view = runner.forward_prefill(PROMPT)
    tree = runner.tree
    _, top2 = view.topk(0, 2)
    for c, child in enumerate(tree.branch(tree.root, 2)):
        child.append_token(int(top2[c]))
    for step in range(DECODE_STEPS):
        tree.alloc()
        plan = runner.build_plan(ForwardMode.TREE_DECODE_FLATTEN)
        lv, _ = runner.forward_tree_decode(ForwardMode.TREE_DECODE_FLATTEN, plan)
        probs = port_probs(lv, plan.l_pad)
        ids, _ = lv.argmax()
        for leaf in list(tree.leaves.values()):
            q = tree.leaf_to_q[leaf.id]
            node, chain = leaf, []
            while node is not None:
                chain.append(node)
                node = node.parent
            tokens = [int(t) for n in reversed(chain) for t in n.token_ids]
            want = hf_next_probs(model, tokens)
            np.testing.assert_allclose(probs[q], want, rtol=0, atol=5e-5,
                                       err_msg=f"step {step}, leaf {leaf.id}")
            assert int(ids[q]) == int(want.argmax()), (step, leaf.id)
            leaf.append_token(int(ids[q]))


def test_int8_load_matches_hf(hf_model):
    path, model = hf_model
    runner = port_runner(path, weight_dtype="int8")
    assert any(k.endswith("_s") for k in runner.params)
    assert not any(k.startswith(("bqkv", "ln")) and runner.params[k].dtype == torch.int8
                   for k in runner.params)  # biases and norms stay unquantised
    view = runner.forward_prefill(PROMPT)
    want = hf_next_probs(model, PROMPT)
    assert int(view.ids[0, 0]) == int(want.argmax())
    np.testing.assert_allclose(port_probs(view, 1)[0], want, rtol=0, atol=5e-2)


def test_cli_model_runs_each_family(hf_model, capsys):
    path, _ = hf_model
    assert cli.main(["--device", "cpu", "--model", path, "--max_width", "2",
                     "--max_seq_len", "24", "--dtype", "float32", "--kv_pool_slots",
                     "2048", "--print-branches"]) == 0
    out = capsys.readouterr().out
    assert "TPOT (ms/token)" in out and out.count("Branch ID") == 2


# the grid's checkpoints: name -> (family, head_dim); Gemma-7B's and
# Phi-3-mini's head widths, whose heads do not pack (gather plans: B11)
GRID_FAMILIES = {"qwen2": ("qwen2", 16), "qwen3": ("qwen3", 16),
                 "gemma-d256": ("gemma", 256), "phi3-d96": ("phi3", 96)}


@pytest.fixture(scope="module")
def grid_checkpoints(tmp_path_factory):
    """Tiny Qwen2 and Qwen3 checkpoints, a Gemma at head_dim 256 and a
    Phi-3 at 96, and their first decode step on a gloo grid 1x1x2 (one
    launch for all)."""
    paths = {}
    for name, (family, head_dim) in GRID_FAMILIES.items():
        d = tmp_path_factory.mktemp(f"grid_{name}")
        make_hf(family, head_dim).save_pretrained(d, safe_serialization=True)
        paths[name] = str(d)
    calls = [(first_step, dict(cfg=LlamaConfig.from_pretrained(p),
                               ecfg=EngineConfig(**ECFG), prompt=PROMPT,
                               mode="flatten", width=3, model_path=p))
             for p in paths.values()]
    # the worker lives in the package: a spawned rank imports no test module
    got = launch(run_all, (1, 1, 2), "cpu", args=(calls,), timeout=600)
    return paths, dict(zip(paths, got))


@pytest.mark.parametrize("family", list(GRID_FAMILIES))
def test_grid_matches_single_process(grid_checkpoints, family):
    paths, got = grid_checkpoints
    from deft_tpu_torch.parallel.mesh import Grid

    cfg = LlamaConfig.from_pretrained(paths[family])
    assert cfg.head_dim == GRID_FAMILIES[family][1]
    one = first_step(Grid((1, 1, 1), 0, torch.device("cpu")), cfg, EngineConfig(**ECFG),
                     PROMPT, "flatten", width=3, model_path=paths[family])
    _, ids, vals = got[family]
    np.testing.assert_array_equal(ids, one[1])
    np.testing.assert_allclose(vals, one[2], rtol=2e-5, atol=0)


# three prompts joined in one ragged prefill: the second and third start
# inside a 64-token tile of the joined prompt
BATCH_PROMPTS = [[7 + (i * 13 + j) % 241 for j in range(n)] for i, n in enumerate((100, 75, 45))]


@pytest.mark.parametrize("family", ["gemma-d256", "phi3-d96"])
def test_wide_family_batch_matches_single_prefills_and_deft_tpu(tmp_path, family):
    """Gemma at head_dim 256 ((1 + w) norms, scaled embeddings, tanh-GELU)
    and Phi-3 at 96 (fused projections) through the batched admission in
    fp32: each prompt's last-token logits equal its own single prefill's
    and deft_tpu's forward_prefill_batch's within 2e-5, with equal ids;
    then BatchedEngine's branches equal deft_tpu's BatchedEngine's on the
    same checkpoint."""
    name, head_dim = GRID_FAMILIES[family]
    make_hf(name, head_dim).save_pretrained(tmp_path, safe_serialization=True)
    path = str(tmp_path)
    runner = port_runner(path)
    view = runner.forward_prefill_batch(
        BATCH_PROMPTS, [tcore.TreeCache(runner.token_to_kv_pool, runner.req_to_token_pool)
                        for _ in BATCH_PROMPTS])
    got = view.full_logits().numpy()
    for i, p in enumerate(BATCH_PROMPTS):
        runner.reset_state()
        one = runner.forward_prefill(p).full_logits()[0].numpy()
        assert np.linalg.norm(got[i] - one) / np.linalg.norm(one) < 2e-5, i
    jr = JRunner(JLlamaConfig.from_pretrained(path), JEngineConfig(**ECFG), kernels="xla",
                 model_path=path, retain_full_logits=True)
    jv = jr.forward_prefill_batch(BATCH_PROMPTS, [
        jcore.TreeCache(jr.token_to_kv_pool, jr.req_to_token_pool) for _ in BATCH_PROMPTS])
    want = np.asarray(jv._full)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-5
    np.testing.assert_array_equal(view.ids, np.asarray(jv.ids))

    def branches(engine_cls, request_cls, ctl_cls, policy, r, mode):
        eng = engine_cls(r, mode=mode)
        reqs = [request_cls(p, ctl_cls(policy), len(p) + 5, width=2) for p in BATCH_PROMPTS]
        eng.add_requests(reqs)
        eng.run()
        return [sorted(tuple(s.token_ids) for s in q.finished_seqs) for q in reqs]

    runner.reset_state()
    jr.reset_state()
    ids = branches(BatchedEngine, Request, Branch_Controller, workloads.simple_tree, runner,
                   mode_from_cli("flatten"))
    assert all(len(b) == 2 and all(len(t) == 4 for t in b) for b in ids)
    assert ids == branches(JEngine, JRequest, JController, jworkloads.simple_tree, jr,
                           j_mode("flatten"))


@pytest.mark.parametrize("kind", ["F32", "BF16", "two files"])
def test_safetensors_reader_matches_safe_open(tmp_path, kind):
    rng = np.random.default_rng(0)
    dtype = torch.bfloat16 if kind == "BF16" else torch.float32
    tensors = {f"t{i}": torch.from_numpy(rng.standard_normal((3 + i, 5)).astype(np.float32)
                                         ).to(dtype) for i in range(4)}
    tensors["i8"] = torch.from_numpy(rng.integers(-127, 128, (7,), dtype=np.int8))
    tensors["f16"] = torch.from_numpy(rng.standard_normal(6).astype(np.float16))
    files = ([dict(list(tensors.items())[:3]), dict(list(tensors.items())[3:])]
             if kind == "two files" else [tensors])
    for i, part in enumerate(files):
        save_file(part, str(tmp_path / f"model-{i:05d}.safetensors"))
    got = {}
    for i in range(len(files)):
        f = str(tmp_path / f"model-{i:05d}.safetensors")
        got.update(read_safetensors(f))
        with safe_open(f, framework="pt") as sf:
            for name in sf.keys():
                want = sf.get_tensor(name)
                assert got[name].dtype == want.dtype and torch.equal(got[name], want), name
    assert sorted(got) == sorted(tensors)


def test_bin_checkpoint_loads(tmp_path):
    """A pytorch_model.bin checkpoint loads as its safetensors twin does."""
    model = make_hf("llama")
    st, pt = tmp_path / "st", tmp_path / "bin"
    model.save_pretrained(st, safe_serialization=True)
    model.save_pretrained(pt, safe_serialization=False)
    assert list(pt.glob("pytorch_model*.bin")) and not list(pt.glob("*.safetensors"))
    cfg = LlamaConfig.from_pretrained(str(st))
    a = load_params(str(st), cfg, "cpu", torch.float32)
    b = load_params(str(pt), cfg, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_loader_refusals(tmp_path):
    model = make_hf("llama")
    model.save_pretrained(tmp_path, safe_serialization=True)
    cfg = LlamaConfig.from_pretrained(str(tmp_path))
    state = {k: v.contiguous() for k, v in model.state_dict().items()}
    for f in tmp_path.glob("*.safetensors"):
        f.unlink()
    # an untied config whose checkpoint has no lm_head: refused, never tied
    save_file({k: v for k, v in state.items() if k != "lm_head.weight"},
              str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="lm_head"):
        load_params(str(tmp_path), cfg, "cpu", torch.float32)
    # a name the map does not know
    save_file(state | {"model.layers.0.mlp.extra.weight": torch.zeros(2)},
              str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="unmapped"):
        load_params(str(tmp_path), cfg, "cpu", torch.float32)
