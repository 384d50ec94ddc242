"""deft_tpu_torch's int8 weights against deft_tpu's, on the CPU.

- the loader's codes and scales equal deft_tpu's _finalize for `tiny`, both
  flavours, in the fused layout;
- B9's plain version (int8_matmul on CPU tensors) against deft_tpu's Pallas
  kernel in interpret mode;
- ``eligible`` agrees with deft_tpu's shape rule;
- ``mm`` routes "_sp" scales through B9 when eligible and through the plain
  expression otherwise, "_s" scales always through the expression;
- Simple_Tree generation with "int8" and "int8-pallas" weights emits
  deft_tpu's ids in flatten and in seq;
- the CLI's --weight-dtype runs on the CPU; unknown values raise.

Tolerances, relative to the largest output: fp32 2e-5 (summation order
only), bf16 2e-2 (tests/test_kernels.py's bf16 bound).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.models.loader import random_params as j_random_params
from deft_tpu.ops import int8_matmul as j_i8
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.models import PRESETS, llama
from deft_tpu_torch.models.loader import random_params
from deft_tpu_torch.ops import int8_matmul as t_i8
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate

ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=512,
            min_token_bucket=128, dtype="float32")
PROMPT = list(np.random.default_rng(0).integers(4, 500, 300))
WIDTH, MAX_SEQ = 3, 300 + 12


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


@pytest.mark.parametrize("wdt", ["int8", "int8-pallas"])
def test_codes_and_scales_match_deft_tpu(wdt):
    want = j_random_params(JPRESETS["tiny"], 0, jnp.float32, weight_dtype=wdt,
                           on_device=False, fuse=True)
    got = random_params(PRESETS["tiny"], 0, "cpu", torch.float32, wdt)
    assert set(got) == set(want)
    suffix = "_sp" if wdt == "int8-pallas" else "_s"
    assert sorted(k for k in got if k.endswith(suffix)) == sorted(
        k + suffix for k in ("wqkv", "wo", "wgu", "wdown", "lm_head"))
    for k, v in want.items():
        a = np.asarray(v)
        assert got[k].numpy().dtype == a.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [8, 64, 256])
def test_int8_matmul_plain_vs_pallas(R, dt):
    H, I = 512, 1536
    rng = np.random.default_rng(R + H + I)
    x = rng.standard_normal((R, H)).astype(np.float32)
    w = rng.integers(-127, 128, (H, I)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (I,)).astype(np.float32)
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 2e-5),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dt]
    want = j_i8.int8_matmul(jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(s))
    got = t_i8.int8_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                           torch.from_numpy(s))
    assert got.dtype == tdt and got.shape == (R, I)
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("shape", [
    ((64, 4096), (4096, 128256)), ((256, 14336), (14336, 4096)),
    ((8, 384), (384, 256)), ((1, 4096), (4096, 4096)), ((12, 512), (512, 512)),
    ((264, 512), (512, 512)), ((64, 513), (513, 512)), ((64, 512), (512, 100)),
    ((4000, 4096), (4096, 6144)), ((2, 8, 512), (512, 512)),
])
def test_eligible_matches_deft_tpu(shape):
    xs, ws = shape
    want = j_i8.eligible(jnp.zeros(xs, jnp.float32), jnp.zeros(ws, jnp.int8))
    assert t_i8.eligible(torch.zeros(xs), torch.zeros(ws, dtype=torch.int8)) == want


def test_mm_routes_by_scale_key_and_shape(monkeypatch):
    """An "_sp" weight goes to B9 for an eligible product and to the plain
    expression otherwise (deft_tpu's shape rule, never a caught failure);
    an "_s" weight always takes the expression."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.integers(-127, 128, (256, 512)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, 512).astype(np.float32))
    calls = []
    real = t_i8.int8_matmul
    monkeypatch.setattr(t_i8, "int8_matmul", lambda *a: calls.append(a) or real(*a))
    for R, routed in ((64, True), (12, False), (300, False)):
        x = torch.from_numpy(rng.standard_normal((R, 256)).astype(np.float32))
        expr = ((x @ w.float()).float() * s).to(x.dtype)
        calls.clear()
        got = llama.mm(x, {"w": w, "w_sp": s}, "w")
        assert len(calls) == int(routed)
        assert rel_err(got.numpy(), expr.numpy()) < 2e-5
        calls.clear()
        assert torch.equal(llama.mm(x, {"w": w, "w_s": s}, "w"), expr) and not calls
    x = torch.ones((8, 256))
    assert torch.equal(llama.mm(x, {"w": w.float()}, "w"), x @ w.float())


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's int8-weight generations (XLA attention; its "int8-pallas"
    matmuls run the Pallas kernel in interpret mode)."""
    out = {}
    for wdt in ("int8", "int8-pallas"):
        jr = JRunner(JPRESETS["tiny"], JEngineConfig(**ECFG, weight_dtype=wdt),
                     kernels="xla", seed=0)
        for mode in ("flatten", "seq"):
            jr.reset_state()
            j_tree_generate(jr, j_mode(mode), None, PROMPT, max_seq_len=MAX_SEQ,
                            width=WIDTH, depth=1,
                            branch_controller=JController(jworkloads.simple_tree))
            out[wdt, mode] = [tuple(s.token_ids) for s in jr.tree.all_finished_seqs]
    return out


@pytest.mark.parametrize("mode", ["flatten", "seq"])
@pytest.mark.parametrize("wdt", ["int8", "int8-pallas"])
def test_int8_weight_generation_matches_deft_tpu(reference, wdt, mode, monkeypatch):
    calls = []
    real = t_i8.int8_matmul
    monkeypatch.setattr(t_i8, "int8_matmul", lambda *a: calls.append(a[0].shape) or real(*a))
    runner = ModelRunner(PRESETS["tiny"], EngineConfig(**ECFG, weight_dtype=wdt),
                         device="cpu")
    assert runner.params["wqkv"].dtype == torch.int8
    tree_generate(runner, mode_from_cli(mode), None, PROMPT, max_seq_len=MAX_SEQ,
                  width=WIDTH, depth=1,
                  branch_controller=Branch_Controller(workloads.simple_tree))
    got = [tuple(s.token_ids) for s in runner.tree.all_finished_seqs]
    assert len(got) == WIDTH and got == reference[wdt, mode]
    if wdt == "int8":
        assert not calls
    else:
        # 11 decode steps: the first 10 replayed as one slab window of 10
        # sub-steps, the last per step; each 4 x 2 layers + lm_head;
        # prefill never
        assert runner.replay_stats == {"win": 1, "step": 0, "subs": 10}
        assert len(calls) == 11 * 9 and {c[0] for c in calls} == {8}


def test_cli_weight_dtype_runs_on_cpu(capsys):
    from deft_tpu_torch.cli import run

    assert run.main(["--device", "cpu", "--random-model", "tiny", "--mode", "seq",
                     "--max_width", "2", "--prompt_len", "40", "--max_seq_len", "48",
                     "--dtype", "float32", "--kv_pool_slots", "4096",
                     "--weight-dtype", "int8-pallas"]) == 0
    assert "TPOT (ms/token)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run.main(["--device", "cpu", "--random-model", "tiny", "--weight-dtype", "int4"])


def test_unknown_weight_dtype_raises():
    with pytest.raises(ValueError, match="weight_dtype"):
        EngineConfig(**ECFG, weight_dtype="int4")
    with pytest.raises(ValueError, match="weight_dtype"):
        random_params(PRESETS["tiny"], 0, "cpu", torch.float32, "fp8")
    assert dataclasses.replace(EngineConfig(), weight_dtype="int8").weight_dtype == "int8"
