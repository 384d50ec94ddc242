"""deft_tpu_torch's Mixtral-family sparse MoE against deft_tpu's, on the CPU.

- B10's plain version (gmm_plain, and the gmm wrapper on CPU tensors)
  against deft_tpu's Pallas gmm in interpret mode, fp32/bf16 x unscaled/int8,
  with an empty expert group and pad tiles past the last group;
  ``gmm_eligible`` against deft_tpu's rule;
- the dispatch layout (row_src, tok_pos, w_pos, tile_eid) against deft_tpu's
  expressions (llama.py:258-287) on the same top-k, and its invariants;
- the MoE block, dense and grouped routes, against deft_tpu's on the same
  layer for inherit / int8 / int8-pallas experts, and the port's two routes
  against each other;
- the loader's MoE parameters equal deft_tpu's key by key;
- ModelRunner prefill (gmm route engaged), tree_generate and BatchedEngine
  emit deft_tpu's tokens;
- a MoE config builds and the CLI takes mixtral-6l.

Tolerances, relative to the largest output: fp32 2e-5 for one grouped matmul
(summation order only), 1e-5 for the MoE block (as tests/test_moe_gmm.py),
bf16 2e-2 (tests/test_kernels.py's bf16 bound); runner probabilities rtol
1e-4 (tests/test_moe_gmm.py:137).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.ops.gmm as j_gmm_mod
from deft_tpu.config import EngineConfig as JEngineConfig
from deft_tpu.control import Branch_Controller as JController
from deft_tpu.control import workloads as jworkloads
from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.models import llama as jllama
from deft_tpu.models.loader import random_params as j_random_params
from deft_tpu.runtime import ModelRunner as JRunner
from deft_tpu.runtime import mode_from_cli as j_mode
from deft_tpu.runtime import tree_generate as j_tree_generate
from deft_tpu.runtime.batched import BatchedEngine as JEngine
from deft_tpu.runtime.batched import Request as JRequest
from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.control import Branch_Controller, workloads
from deft_tpu_torch.models import PRESETS, llama
from deft_tpu_torch.models.loader import random_params
from deft_tpu_torch.ops import gmm as t_gmm
from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate
from deft_tpu_torch.runtime.batched import BatchedEngine, Request

NE, K = 4, 2
CFG = dataclasses.replace(PRESETS["tiny"], num_experts=NE, experts_per_tok=K)
JCFG = dataclasses.replace(JPRESETS["tiny"], num_experts=NE, experts_per_tok=K)
ECFG = dict(kv_pool_slots=4096, max_requests=64, max_context_len=1024,
            min_token_bucket=128, dtype="float32")
# 520 * top-2 = 1040 routed rows >= 2 * NE * 128: the grouped route engages
PROMPT = [7 + (i % 97) for i in range(520)]
WIDTH, GEN = 3, 8


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


def routed(n, ne, empty, seed):
    """top-2 choices of n tokens among the experts other than ``empty``,
    and their renormalised weights."""
    rng = np.random.default_rng(seed)
    pick = [e for e in range(ne) if e != empty]
    top_i = np.stack([rng.choice(pick, size=K, replace=False) for _ in range(n)])
    w = rng.uniform(0.1, 1.0, (n, K)).astype(np.float32)
    return top_i.astype(np.int64), w / w.sum(-1, keepdims=True)


def deft_dispatch(top_i, top_w, ne, tm=128):
    """deft_tpu's grouped layout, its expressions of llama.py:258-287."""
    n, k = top_i.shape
    nK = n * k
    M_pad = -(-(nK + ne * (tm - 1)) // tm) * tm
    flat_e = jnp.asarray(top_i.reshape(-1), jnp.int32)
    flat_t = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, k)).reshape(-1)
    flat_w = jnp.asarray(top_w.reshape(-1), jnp.float32)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    g = jnp.bincount(flat_e, length=ne)
    gstart = jnp.cumsum(g) - g
    padded = -(-g // tm) * tm
    pstart = jnp.cumsum(padded) - padded
    pos = (pstart[se] + jnp.arange(nK, dtype=jnp.int32) - gstart[se]).astype(jnp.int32)
    row_src = jnp.zeros(M_pad, jnp.int32).at[pos].set(flat_t[order])
    tok_pos = jnp.full(M_pad, n, jnp.int32).at[pos].set(flat_t[order])
    w_pos = jnp.zeros(M_pad, jnp.float32).at[pos].set(flat_w[order])
    tile_eid = jnp.searchsorted(pstart, jnp.arange(M_pad // tm, dtype=jnp.int32) * tm,
                                side="right") - 1
    return [np.asarray(a) for a in (row_src, tok_pos, w_pos, tile_eid)]


# -- B10's function ----------------------------------------------------------------

@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "int8-scaled"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_gmm_plain_matches_deft_tpu(dt, scaled):
    """NE = 4 with expert 2 empty: 300 tokens x top-2 fill three groups of
    two tiles each, and the static M_pad leaves three pad tiles past the last
    group (run by the last expert)."""
    E, F = 128, 256
    top_i, top_w = routed(300, NE, 2, seed=1)
    *_, tile_eid = llama.moe_dispatch(torch.from_numpy(top_i), torch.from_numpy(top_w), NE)
    eids = tile_eid.tolist()
    assert 2 not in eids and eids[-3:] == [NE - 1] * 3 and len(eids) == 9
    rng = np.random.default_rng(2)
    x = rng.standard_normal((len(eids) * 128, E)).astype(np.float32)
    if scaled:
        w = rng.integers(-127, 128, (NE, E, F)).astype(np.int8)
        s = rng.uniform(0.01, 0.1, (NE, F)).astype(np.float32)
    else:
        w = (rng.standard_normal((NE, E, F)) / np.sqrt(E)).astype(np.float32)
        s = None
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 2e-5),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dt]
    jw = jnp.asarray(w) if scaled else jnp.asarray(w, jdt)
    want = j_gmm_mod.gmm(jnp.asarray(x, jdt), jw, jnp.asarray(eids, jnp.int32),
                         None if s is None else jnp.asarray(s))
    tw = torch.from_numpy(w) if scaled else torch.from_numpy(w).to(tdt)
    ts = None if s is None else torch.from_numpy(s)
    tx = torch.from_numpy(x).to(tdt)
    for fn in (t_gmm.gmm_plain, t_gmm.gmm):
        got = fn(tx, tw, tile_eid, ts)
        assert got.dtype == tdt and got.shape == (len(eids) * 128, F)
        assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("shape", [
    (9088, 4096, 14336), (9088, 14336, 4096), (1152, 128, 256), (1000, 128, 256),
    (1152, 384, 256), (1152, 640, 256), (1152, 1024, 1536), (1152, 128, 700),
    (256, 512, 512), (128, 2048, 100),
])
def test_gmm_eligible_matches_deft_tpu(shape):
    assert t_gmm.gmm_eligible(*shape) == j_gmm_mod.gmm_eligible(*shape)


def test_gmm_wrapper_refuses_tensors_off_cuda():
    """A tensor that is not on the CPU goes to the kernel path, which refuses
    what is not on one CUDA device, and shapes the kernel does not tile."""
    meta = dict(device="meta")
    x = torch.empty(256, 128, **meta)
    eid = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        t_gmm.gmm(x, torch.empty(NE, 128, 256, **meta), eid)
    with pytest.raises(ValueError, match="CUDA device"):
        t_gmm.gmm(x, torch.empty(NE, 128, 256, dtype=torch.int8, device="meta"), eid,
                  torch.empty(NE, 256, **meta))
    with pytest.raises(ValueError, match="F % 128"):
        t_gmm.gmm(x, torch.empty(NE, 128, 200, **meta), eid)
    with pytest.raises(ValueError, match="int8"):
        t_gmm.gmm(x, torch.empty(NE, 128, 256, **meta), eid, torch.empty(NE, 256, **meta))


# -- the dispatch ----------------------------------------------------------------------

@pytest.mark.parametrize("n, ne, empty", [(2048, 8, None), (300, 4, 2), (700, 8, 7)])
def test_dispatch_matches_deft_tpu(n, ne, empty):
    """Equal arrays on the same top-k, and test_gmm_dispatch_layout_invariants'
    invariants (tests/test_moe_gmm.py:61-109) on the port's arrays."""
    top_i, top_w = routed(n, ne, empty, seed=n)
    got = llama.moe_dispatch(torch.from_numpy(top_i), torch.from_numpy(top_w), ne)
    for g, w, name in zip(got, deft_dispatch(top_i, top_w, ne),
                          ("row_src", "tok_pos", "w_pos", "tile_eid")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    row_src, tok_pos, w_pos, tile_eid = (a.numpy() for a in got)
    tm, nK = 128, n * K
    M_pad = len(row_src)
    assert M_pad == -(-(nK + ne * (tm - 1)) // tm) * tm and len(tile_eid) == M_pad // tm
    live = tok_pos < n
    assert live.sum() == nK and (w_pos[~live] == 0).all() and (row_src[~live] == 0).all()
    # each token's K slots, each in a tile owned by one of its experts
    slots = np.nonzero(live)[0]
    for t in (0, n // 2, n - 1):
        mine = slots[tok_pos[slots] == t]
        assert sorted(tile_eid[mine // tm]) == sorted(top_i[t])
        np.testing.assert_allclose(sorted(w_pos[mine]), sorted(top_w[t]), rtol=0)
    assert len(np.unique(slots // tm)) <= nK // tm + ne  # k-scaled work
    assert (np.diff(tile_eid) >= 0).all()


# -- the MoE block -----------------------------------------------------------------

def layer_params(wdt):
    jp = j_random_params(JCFG, 0, jnp.float32, weight_dtype=wdt, on_device=False)
    jlp = {k: v[0] for k, v in jp.items() if k.split("_")[0] in ("wg", "wu", "wdown", "wrt")}
    tlp = llama.layer_params(random_params(CFG, 0, "cpu", torch.float32, wdt), 0)
    return jlp, {k: v for k, v in tlp.items() if k.split("_")[0] in ("wg", "wu", "wdown", "wrt")}


@pytest.mark.parametrize("wdt", ["inherit", "int8", "int8-pallas"])
def test_moe_block_matches_deft_tpu(wdt, monkeypatch):
    jlp, tlp = layer_params(wdt)
    assert set(jlp) == set(tlp)
    n = 512
    h = (np.random.default_rng(0).standard_normal((n, CFG.hidden_size)) * 0.1
         ).astype(np.float32)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    act = jllama._act_fn("silu")
    assert jllama._moe_gmm_ok(JCFG, jlp, n) and llama._moe_gmm_ok(CFG, n)
    assert not llama._moe_gmm_ok(CFG, 64)  # decode widths stay dense
    seen = {"deft": [], "port": []}
    j_real, t_real = j_gmm_mod.gmm, t_gmm.gmm
    monkeypatch.setattr(j_gmm_mod, "gmm", lambda x, w, e, s=None, **kw:
                        seen["deft"].append((x, e)) or j_real(x, w, e, s, **kw))
    monkeypatch.setattr(t_gmm, "gmm", lambda x, w, e, s=None:
                        seen["port"].append((x, e)) or t_real(x, w, e, s))
    dense = llama._moe_mlp(CFG, tlp, th).numpy()
    grouped = llama._moe_mlp_gmm(CFG, tlp, th).numpy()
    assert rel_err(dense, np.asarray(jllama._moe_mlp(JCFG, jlp, jh, act))) < 1e-5
    assert rel_err(grouped, np.asarray(jllama._moe_mlp_gmm(JCFG, jlp, jh, act))) < 1e-5
    assert rel_err(grouped, dense) < 1e-5
    # three grouped matmuls each, over the same tiles and gathered rows
    assert len(seen["deft"]) == len(seen["port"]) == 3
    (jx, je), (tx, te) = seen["deft"][0], seen["port"][0]
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert rel_err(tx.numpy(), np.asarray(jx)) < 1e-6


@pytest.mark.parametrize("wdt", ["inherit", "int8", "int8-pallas"])
def test_moe_loader_matches_deft_tpu(wdt):
    want = j_random_params(JCFG, 0, jnp.float32, weight_dtype=wdt, on_device=False,
                           fuse=True)
    got = random_params(CFG, 0, "cpu", torch.float32, wdt)
    assert set(got) == set(want)
    for k, v in want.items():
        a = np.asarray(v)
        assert got[k].numpy().dtype == a.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    assert got["wg"].shape == (CFG.num_layers, NE, CFG.hidden_size, CFG.intermediate_size)
    assert got["wrt"].dtype == torch.float32 and not any(k.startswith("wrt_") for k in got)
    if wdt != "inherit":
        suffix = "_sp" if wdt == "int8-pallas" else "_s"
        assert got["wdown" + suffix].shape == (CFG.num_layers, NE, CFG.hidden_size)


# -- through the runner ----------------------------------------------------------------

def counting(monkeypatch):
    calls = []
    real = t_gmm.gmm
    monkeypatch.setattr(t_gmm, "gmm", lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


def test_moe_prefill_matches_deft_tpu_pallas(monkeypatch):
    """deft_tpu's pallas runner (its gmm route) and the port's on the same
    numpy weights: equal top-1 id and probability (tests/test_moe_gmm.py:112)."""
    jr = JRunner(JCFG, JEngineConfig(**ECFG), kernels="pallas", seed=0)
    assert jr._moe_gmm
    jv = jr.forward_prefill(PROMPT)
    calls = counting(monkeypatch)
    tr = ModelRunner(CFG, EngineConfig(**ECFG), device="cpu")
    tv = tr.forward_prefill(PROMPT)
    assert len(calls) == 3 * CFG.num_layers  # the grouped route, every layer
    assert int(tv.ids[0, 0]) == int(np.asarray(jv.ids)[0, 0])
    np.testing.assert_allclose(tv.vals[0, 0], np.asarray(jv.vals)[0, 0], rtol=1e-4,
                               atol=1e-6)


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's MoE generations (its CPU XLA route: dense experts; the
    port's prefill takes the grouped route, exact in fp32 too)."""
    out = {}
    for wdt in ("inherit", "int8-pallas"):
        jr = JRunner(JCFG, JEngineConfig(**ECFG, weight_dtype=wdt), kernels="xla", seed=0)
        for mode in ("flatten", "seq"):
            jr.reset_state()
            j_tree_generate(jr, j_mode(mode), None, PROMPT, max_seq_len=len(PROMPT) + GEN,
                            width=WIDTH, depth=1,
                            branch_controller=JController(jworkloads.simple_tree))
            out[wdt, mode] = [tuple(s.token_ids) for s in jr.tree.all_finished_seqs]
    return out


@pytest.mark.parametrize("mode", ["flatten", "seq"])
@pytest.mark.parametrize("wdt", ["inherit", "int8-pallas"])
def test_moe_tree_generate_matches_deft_tpu(reference, wdt, mode, monkeypatch):
    calls = counting(monkeypatch)
    runner = ModelRunner(CFG, EngineConfig(**ECFG, weight_dtype=wdt), device="cpu")
    tree_generate(runner, mode_from_cli(mode), None, PROMPT,
                  max_seq_len=len(PROMPT) + GEN, width=WIDTH, depth=1,
                  branch_controller=Branch_Controller(workloads.simple_tree))
    got = [tuple(s.token_ids) for s in runner.tree.all_finished_seqs]
    assert len(got) == WIDTH and got == reference[wdt, mode]
    assert len(calls) == 3 * CFG.num_layers  # prefill only: decode stays dense


def test_moe_batched_engine_matches_deft_tpu(monkeypatch):
    """Three MoE requests of 200 + 180 + 160 tokens: one ragged prefill of
    540 rows takes the grouped route; both engines emit the same ids."""
    prompts = [[5 + (i * (r + 3)) % 400 for i in range(n)]
               for r, n in enumerate((200, 180, 160))]

    def ids(engine_cls, request_cls, ctl, policy, runner, mode):
        eng = engine_cls(runner, mode=mode)
        reqs = [request_cls(p, ctl(policy), len(p) + GEN, width=WIDTH) for p in prompts]
        eng.add_requests(reqs)
        eng.run()
        return [sorted(tuple(s.token_ids) for s in r.finished_seqs) for r in reqs]

    jr = JRunner(JCFG, JEngineConfig(**ECFG), kernels="xla", seed=0)
    want = ids(JEngine, JRequest, JController, jworkloads.simple_tree, jr, j_mode("flatten"))
    calls = counting(monkeypatch)
    tr = ModelRunner(CFG, EngineConfig(**ECFG), device="cpu")
    got = ids(BatchedEngine, Request, Branch_Controller, workloads.simple_tree, tr,
              mode_from_cli("flatten"))
    assert got == want
    assert all(len(b) == WIDTH and all(len(t) == GEN - 1 for t in b) for b in got)
    assert len(calls) == 3 * CFG.num_layers and calls[0][0] >= 2 * 540


def test_cli_takes_mixtral_preset():
    from deft_tpu_torch.cli import run

    args = run.build_parser().parse_args(["--random-model", "mixtral-6l"])
    assert args.random_model == "mixtral-6l"
    assert PRESETS[args.random_model].num_experts == 8
