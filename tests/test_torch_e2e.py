"""End-to-end: deft_tpu_torch's Simple_Tree generation against deft_tpu's, on
the CPU in fp32, plus the port's boundaries.

- tree_generate emits the same token ids as deft_tpu's for flatten and seq
  (same numpy weights; attention is exact, so ids must be equal);
- flatten equals seq inside the port;
- the CLI runs with --device cpu;
- importing the port loads neither jax nor deft_tpu, and its sources (and
  chip_smoke.py) import neither.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

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
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate

ROOT = pathlib.Path(__file__).resolve().parents[1]
ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(np.random.default_rng(0).integers(4, 500, 300))
WIDTH, MAX_SEQ = 3, 300 + 12


def port_runner(jparams=None):
    params = None
    if jparams is not None:
        params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                   PRESETS["tiny"], "cpu", torch.float32)
    return ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cpu",
                       params=params)


def port_generate(runner, mode):
    pm = tree_generate(runner, mode_from_cli(mode), None, PROMPT,
                       max_seq_len=MAX_SEQ, width=WIDTH, depth=1,
                       branch_controller=Branch_Controller(workloads.simple_tree))
    return [tuple(s.token_ids) for s in runner.tree.all_finished_seqs], pm


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's generations (its CPU XLA attention; the Pallas kernels are
    held against the port in test_torch_kernels.py / test_torch_model.py)."""
    jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG), kernels="xla", seed=0)
    out = {}
    for mode in ("flatten", "seq"):
        jr.reset_state()
        pm = j_tree_generate(jr, j_mode(mode), None, PROMPT, max_seq_len=MAX_SEQ,
                             width=WIDTH, depth=1,
                             branch_controller=JController(jworkloads.simple_tree))
        out[mode] = ([tuple(s.token_ids) for s in jr.tree.all_finished_seqs], pm)
    return jr.params, out


@pytest.mark.parametrize("mode", ["flatten", "seq"])
def test_tree_generate_matches_deft_tpu(reference, mode):
    jparams, ref = reference
    runner = port_runner(jparams)
    got, pm = port_generate(runner, mode)
    want, jpm = ref[mode]
    assert len(got) == WIDTH and all(len(t) == MAX_SEQ - len(PROMPT) - 1 for t in got)
    assert got == want
    assert pm.generated_len == jpm.generated_len
    assert pm.KV_IO == jpm.KV_IO and pm.Mask_IO == jpm.Mask_IO
    assert set(pm.as_dict()) == set(jpm.as_dict())


def test_flatten_equals_seq_in_port():
    runner = port_runner()  # the port's own numpy random stream
    flat, pf = port_generate(runner, "flatten")
    seq, ps = port_generate(runner, "seq")
    assert flat == seq
    assert ps.KV_IO > pf.KV_IO  # seq re-reads the shared prompt per leaf


def test_cli_runs_on_cpu(tmp_path, capsys):
    from deft_tpu_torch.cli import run

    out = tmp_path / "pm.json"
    assert run.main(["--device", "cpu", "--random-model", "tiny", "--mode", "seq",
                     "--max_width", "2", "--prompt_len", "300",
                     "--max_seq_len", "306", "--dtype", "float32",
                     "--kv_pool_slots", "4096", "--output_file", str(out),
                     "--print-branches"]) == 0
    text = capsys.readouterr().out
    assert "TPOT (ms/token)" in text and text.count("Branch ID") == 2
    assert out.exists()
    for flag, value in (("--mode", "node"), ("--Branch_controller", "Beam_Search")):
        assert run.main(["--device", "cpu", "--random-model", "tiny", "--max_width", "2",
                         "--prompt_len", "300", "--max_seq_len", "306", "--dtype",
                         "float32", "--kv_pool_slots", "4096", "--print-branches",
                         flag, value]) == 0
        text = capsys.readouterr().out
        assert "TPOT (ms/token)" in text and text.count("Branch ID") == 2
    for flag, value in (("--model", str(tmp_path)), ("--kernels", "xla")):
        # --model beside --random-model, and the unported --kernels:
        # argparse refuses both
        with pytest.raises(SystemExit):
            run.main(["--device", "cpu", "--random-model", "tiny", flag, value])


def test_refusals():
    """No silent fallbacks: CUDA without a GPU, the families deft_tpu
    refuses, unknown rope scalings and engine options raise; the ported
    families and scalings construct; a gather plan (short prompt) runs
    through its kernel entry and matches the dense oracle.  On the CPU both
    are B6's / B7's plain version, so this checks the dispatch only;
    tests/test_torch_gather.py holds them against deft_tpu."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG), device="cuda")
    runner = port_runner()
    runner.retain_full_logits = True
    runner.forward_prefill(list(range(7, 19)))  # short prompt: no seg alignment
    for c, child in enumerate(runner.tree.branch(runner.tree.root, 2)):
        child.append_token(30 + c)
    runner.tree.alloc()
    from unittest import mock

    from deft_tpu_torch.ops import attn_impls

    for name in ("flatten", "seq"):
        mode = mode_from_cli(name)
        plan = runner.build_plan(mode)
        assert not plan.paged
        assert runner._attn_fn(mode, False) in (attn_impls.flatten_gather_attn,
                                                attn_impls.seq_gather_attn)
        got, _ = runner.forward_tree_decode(mode, plan)
        oracle = {"flatten": attn_impls.flatten_attn_xla,
                  "seq": attn_impls.seq_attn_xla}[name]
        with mock.patch.object(runner, "_attn_fn", lambda *_: oracle):
            want, _ = runner.forward_tree_decode(mode, plan)
        n = plan.n_leaves
        g, w = got.full_logits()[:n], want.full_logits()[:n]
        assert float((g - w).abs().max() / w.abs().max()) < 1e-5  # fp32 order
    import dataclasses

    qk = dataclasses.replace(PRESETS["tiny"], qk_norm=True)  # Qwen3: ported
    assert ModelRunner(qk, EngineConfig(**ECFG), device="cpu").params["ln_q"].shape == (2, 32)
    moe = dataclasses.replace(PRESETS["tiny"], num_experts=4)  # Mixtral: ported
    assert ModelRunner(moe, EngineConfig(**ECFG), device="cpu").params["wg"].dim() == 4
    yarn = dataclasses.replace(PRESETS["tiny"],
                               rope_scaling={"rope_type": "yarn", "factor": 4.0})
    ModelRunner(yarn, EngineConfig(**ECFG), device="cpu")  # ported
    unknown = dataclasses.replace(PRESETS["tiny"],
                                  rope_scaling={"rope_type": "su", "factor": 4.0})
    with pytest.raises(NotImplementedError, match="su"):
        ModelRunner(unknown, EngineConfig(**ECFG), device="cpu")
    from deft_tpu_torch.models.config import LlamaConfig

    with pytest.raises(NotImplementedError, match="Gemma2"):
        LlamaConfig.from_hf_config({"architectures": ["Gemma2ForCausalLM"],
                                    "hidden_size": 64, "num_attention_heads": 4})
    with pytest.raises(ValueError, match="kv_dtype"):
        EngineConfig(**ECFG, kv_dtype="fp8")


def test_port_imports_neither_jax_nor_deft_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deft_tpu_torch\n"
        "for m in pkgutil.walk_packages(deft_tpu_torch.__path__, 'deft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'deft_tpu' or n.startswith('deft_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('deft_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_import_neither_jax_nor_deft_tpu():
    files = sorted((ROOT / "deft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "deft_tpu"), (f, n)
