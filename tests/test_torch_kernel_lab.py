"""The flatten kernel lab's port (deft_tpu_torch/experiments/kernel_lab.py)
against deft_tpu's experiments/kernel_lab.py, on the CPU.

deft_tpu's lab is loaded by path and set to its check shapes (LAYERS 2,
PROMPT 600, T_PAD 1024), as its main does under DEFT_LAB_CHECK=1.  Held
here:

- the case builders (build_case, build_case_q, build_case_deep, sentinel):
  the integer tables (seg_src, tok_lo/hi, blk_lo/hi, live and full block
  counts) equal at the check and the full shapes; q and the pools equal
  exactly after the same bf16 rounding (int8 codes and fp32 scales
  exactly), but the pools' DUMP_SLOT row (row 0), which the port's cases
  hold at zero (its flatten bodies read that row as zeros) and deft_tpu's
  give to live token 0; the kernel comparisons below hand deft_tpu's
  kernels the same zeroed row (``dump_row_zero``);
- B12's and B13's plain versions (the wrappers on CPU tensors) against
  deft_tpu's _lab_call and _lab_call_fused in interpret mode, bf16, 2e-2 of
  the largest output;
- B15's against deft_tpu's exp2 probe in fp32 within 1e-5, at the lab's
  72 sweeps and at few sweeps (x <- exp2(-0.9999 x) contracts by about
  0.44 a sweep, so by some 14 sweeps every chain sits within 1e-5 of one
  fixed point; at 12 or fewer a wrong sweep count shows), and from a
  random start tile against a numpy loop;
- the entry: ``--device cpu`` in check mode prints a line a variant (a
  SKIP for the one past T_PAD 1024) and exits 0; a variant forced to
  disagree with v0, or to raise, makes it exit 1; ``cuda`` without a card
  raises.

B14 (the K2/TQ variants) is held in tests/test_torch_kernel_lab_k2.py.  The
kernels themselves run only on the card (chip_smoke.py's lab phase).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu_torch.experiments import kernel_lab as kl

ROOT = Path(__file__).resolve().parents[1]
CHECK = dict(LAYERS=2, PROMPT=600, T_PAD=1024)
FULL = dict(LAYERS=1, PROMPT=4400, T_PAD=8192)  # one layer: the tables only
TABLES = ("seg_src", "tok_lo", "tok_hi", "blk_lo", "blk_hi")


def load_jax_lab(name):
    """deft_tpu's experiments/kernel_lab.py as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "experiments" / "kernel_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_shapes(mod, shapes):
    for k, v in shapes.items():
        setattr(mod, k, v)


@pytest.fixture(scope="module")
def jlab():
    mod = load_jax_lab("deft_tpu_kernel_lab_t1")
    set_shapes(mod, CHECK)
    return mod


@pytest.fixture
def tlab(monkeypatch):
    """The port's lab at the check shapes (restored after the test)."""
    for k, v in CHECK.items():
        monkeypatch.setattr(kl, k, v)
    return kl


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def as_np(x):
    """A jax array or a torch tensor as float64 / int numpy."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x)
    return x.astype(np.float64) if x.dtype.kind == "f" else x


def builders(mod):
    return {"build_case": mod.build_case, "build_case_q": mod.build_case_q,
            "build_case_deep": mod.build_case_deep,
            "sent_build_case": mod.sentinel(mod.build_case),
            "sent_build_case_deep": mod.sentinel(mod.build_case_deep),
            "sent_build_case_q": mod.sentinel(mod.build_case_q)}


CASES = [("build_case", 128), ("build_case", 256), ("build_case", 512),
         ("build_case", 1024), ("build_case_q", 256), ("build_case_q", 512),
         ("build_case_deep", 256), ("build_case_deep", 512), ("build_case_deep", 1024),
         ("sent_build_case", 512), ("sent_build_case", 1024),
         ("sent_build_case_deep", 512), ("sent_build_case_q", 512)]


def dump_row_zero(case):
    """deft_tpu's lab case with its pools' row 0 (the port's DUMP_SLOT)
    zeroed, as the port's builders leave it."""
    for k in ("k_pool", "v_pool"):
        case[k] = case[k].at[:, 0].set(0)
    return case


def assert_same_tables(cj, ct):
    for k in TABLES:
        np.testing.assert_array_equal(as_np(cj[k]), as_np(ct[k]), err_msg=k)
        assert ct[k].dtype == torch.int32, k
    assert cj["live_blocks"] == ct["live_blocks"]
    assert cj.get("full_blocks") == ct.get("full_blocks")
    assert cj["block_len"] == ct["block_len"]


@pytest.mark.parametrize("builder,block_len", CASES)
def test_builders_match_deft_tpu_at_check_shapes(jlab, tlab, builder, block_len):
    cj = builders(jlab)[builder](block_len, np.random.default_rng(0))
    ct = builders(tlab)[builder](block_len, np.random.default_rng(0))
    assert_same_tables(cj, ct)
    int8 = builder.endswith("_q")
    dtypes = dict(q=torch.bfloat16, k_pool=torch.int8 if int8 else torch.bfloat16)
    dtypes["v_pool"] = dtypes["k_pool"]
    if int8:
        dtypes.update(k_scale=torch.float32, v_scale=torch.float32)
    for k, dtype in dtypes.items():
        assert ct[k].dtype == dtype, k
        want, got = as_np(cj[k]), as_np(ct[k])
        if k in ("k_pool", "v_pool"):  # DUMP_SLOT's row: zeros in the port
            assert not got[:, 0].any() and want[:, 0].any()
            want, got = want[:, 1:], got[:, 1:]
        np.testing.assert_array_equal(want, got, err_msg=k)


@pytest.fixture(scope="module")
def jlab_full():
    mod = load_jax_lab("deft_tpu_kernel_lab_t1_full")
    set_shapes(mod, FULL)
    return mod


@pytest.mark.parametrize("builder,block_len", CASES + [("build_case", 2048)])
def test_integer_tables_match_deft_tpu_at_full_shapes(jlab_full, monkeypatch, builder,
                                                      block_len):
    jmod = jlab_full
    for k, v in FULL.items():
        monkeypatch.setattr(kl, k, v)
    cj = builders(jmod)[builder](block_len, np.random.default_rng(0))
    ct = builders(kl)[builder](block_len, np.random.default_rng(0))
    assert_same_tables(cj, ct)


def jax_out(jlab, name, case):
    """deft_tpu's lab variant ``name`` on its case at the last layer."""
    fn = jlab.VARIANTS[name][0]
    return fn(case["q"], case["k_pool"], case["v_pool"],
              jnp.asarray(jlab.LAYERS - 1, jnp.int32), case)


def port_out(tlab, name, case):
    """The port's variant ``name`` through its wrapper (CPU tensors: the
    plain version), folded."""
    call = tlab.VARIANTS[name][0](case)
    return call.fold(call.fn(*call.args(tlab.LAYERS - 1)))


def sharpen(cj, ct, q_scale):
    """Both cases' q times ``q_scale`` (bf16): the lab's q and K (0.3 N(0,
    1)) give scores of about 0.09 N(0, 1), nearly uniform weights; at 8x
    each row's output leans on its own largest scores."""
    if q_scale != 1:
        cj["q"] = (cj["q"].astype(jnp.float32) * q_scale).astype(jnp.bfloat16)
        ct["q"] = (ct["q"].float() * q_scale).to(torch.bfloat16)
    return cj, ct


@pytest.mark.parametrize("q_scale", [1, 8])
@pytest.mark.parametrize("name,kernel", [("vB_b128", "B12"), ("vB_b256", "B12"),
                                         ("vB_b512", "B12"), ("vD_b256", "B13"),
                                         ("vD_b512", "B13")])
def test_b12_b13_plain_match_deft_tpu_interpret(jlab, tlab, name, kernel, q_scale):
    _, bl, builder = tlab.VARIANTS[name]
    cj, ct = sharpen(dump_row_zero(jlab.VARIANTS[name][2](bl, np.random.default_rng(0))),
                     builder(bl, np.random.default_rng(0)), q_scale)
    call = tlab.VARIANTS[name][0](ct)
    assert call.kernel == kernel
    want = as_np(jax_out(jlab, name, cj))
    got = port_out(tlab, name, ct)
    assert got.shape == (kl.HKV, kl.RQ, kl.D) and got.dtype == torch.bfloat16
    assert rel_err(as_np(got), want) < 2e-2
    # and the same function as B1's on the case (the lab's v0)
    v0 = port_out(tlab, f"v0_b{bl}", ct)
    assert rel_err(as_np(got), as_np(v0)) < 2e-2


def test_b15_plain_matches_deft_tpu_probe_in_fp32(jlab, tlab):
    cj = jlab.build_case_probe(512, np.random.default_rng(0))
    ct = tlab.build_case_probe(512, np.random.default_rng(0))
    # the probe's output takes q's dtype: a float32 q keeps it in fp32
    q32 = jnp.zeros((jlab.HKV, jlab.RQ, jlab.D), jnp.float32)
    want = as_np(jlab.VARIANTS["probe_exp2_b512"][0](
        q32, cj["k_pool"], cj["v_pool"], jnp.asarray(1, jnp.int32), cj))
    call = tlab.VARIANTS["probe_exp2_b512"][0](ct)
    assert call.kernel == "B15"
    x0, nb, passes, d = call.args(1)
    assert (nb, passes, d) == (ct["live_blocks"], 8, kl.D) and x0.shape == (kl.RQ, 512)
    got = call.fn(*call.args(1))
    assert got.dtype == torch.float32 and got.shape == (1, kl.RQ, kl.D)
    np.testing.assert_allclose(as_np(got)[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(as_np(got.expand(kl.HKV, -1, -1)), want, rtol=0, atol=1e-5)


# (nb, passes) with nb * passes <= 12: each sweep moves the output by more
# than 1e-4
FEW_SWEEPS = [(1, p) for p in range(1, 9)] + [(3, 3), (2, 5), (5, 2), (2, 6)]


def probe_sweeps(x0, steps):
    """``steps`` sweeps of x <- exp2(-0.9999 x) in float32 numpy."""
    x = np.asarray(x0, np.float32)
    for _ in range(steps):
        x = np.exp2(x * np.float32(-0.9999)).astype(np.float32)
    return x


@pytest.mark.parametrize("nb,passes", FEW_SWEEPS)
def test_b15_plain_matches_deft_tpu_probe_at_few_sweeps(jlab, nb, passes):
    from deft_tpu_torch.ops import lab_probe as lp

    q32 = jnp.zeros((jlab.HKV, jlab.RQ, jlab.D), jnp.float32)
    want = as_np(jlab.make_exp2_probe(passes)(q32, None, None, 0,
                                              dict(live_blocks=nb, block_len=512)))
    x0 = torch.full((kl.RQ, 512), -0.5)
    got = lp.lab_exp2_probe(x0, nb, passes, kl.D)
    np.testing.assert_allclose(as_np(got.expand(kl.HKV, -1, -1)), want, rtol=0, atol=1e-5)
    # the check is sharp: one sweep more or less is far outside 1e-5
    for steps in (nb * passes - 1, nb * passes + 1):
        assert np.abs(probe_sweeps(x0, steps)[:, :kl.D] - want[0]).max() > 1e-4
    # from a start tile drawn per element, the chains differ, each as a
    # numpy loop runs it
    x0 = np.random.default_rng(nb * 16 + passes).uniform(-4, 2, (kl.RQ, 512)).astype(np.float32)
    got = as_np(lp.lab_exp2_probe(torch.from_numpy(x0), nb, passes, kl.D))[0]
    want = probe_sweeps(x0, nb * passes)[:, :kl.D]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want.max() - want.min() > 1e-4


def test_entry_check_mode_prints_every_variant(tlab, monkeypatch, capsys):
    monkeypatch.setenv("DEFT_LAB_CHECK", "1")
    # the check shapes hold for the run only, and its records say so
    monkeypatch.setattr(tlab, "LAYERS", 3)
    results = {}
    assert tlab.main(["--device", "cpu"], results=results) == 0
    assert (tlab.LAYERS, tlab.PROMPT, tlab.T_PAD) == (3, 600, 1024)
    assert {(r["layers"], r["t_pad"]) for r in results.values()} == {(2, 1024)}
    r = results["vB_b512"]
    assert r["call"].kernel == "B12" and r["case"]["block_len"] == 512
    lines = capsys.readouterr().out.splitlines()
    for name, (_, bl, _) in tlab.VARIANTS.items():
        line = next(x for x in lines if x.split()[0] == name)
        if bl > 1024:
            assert "SKIP" in line and name not in results
        else:
            assert "max|diff vs v0|=" in line and "FAIL" not in line
            assert results[name]["rel"] < tlab.TOL
    assert len(results) == len(tlab.VARIANTS) - 1
    assert lines[-1].startswith("# live KV")
    kernels = {r["kernel"].split()[0] for r in results.values()}
    assert kernels == {"B1", "B4", "B12", "B13", "B14", "B15"}


def test_entry_exits_nonzero_on_a_failing_variant(tlab, monkeypatch, capsys):
    monkeypatch.setenv("DEFT_LAB_CHECK", "1")
    make, bl, builder = tlab.VARIANTS["vB_b128"]

    def off(case):  # B12 forced to disagree with v0 by 10 %
        call = make(case)
        return call._replace(fn=lambda *a: call.fn(*a) * 1.1)

    def raises(case):
        raise RuntimeError("launch refused")

    variants = dict(tlab.VARIANTS, vB_off=(off, bl, builder), vB_raise=(raises, bl, builder))
    monkeypatch.setattr(tlab, "VARIANTS", variants)
    assert tlab.main(["--device", "cpu", "v0_b128", "vB_b128"]) == 0
    assert tlab.main(["--device", "cpu", "v0_b128", "vB_off", "vB_b128"]) == 1
    out = capsys.readouterr().out
    assert "vB_off     block= 128 FAIL: ArithmeticError" in out
    assert tlab.main(["--device", "cpu", "vB_raise"]) == 1
    assert "vB_raise   block= 128 FAIL: RuntimeError: launch refused" in capsys.readouterr().out


def test_entry_asks_for_the_card_by_default(tlab):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no GPU"):
        tlab.main(["v0_b128"])


@pytest.mark.parametrize("builder,live,pairs", [("build_case", 4528, 4400 * 64 + 128),
                                                ("build_case_deep", 7680, 1536 * 64 + 6144)])
def test_bounds_count_the_live_tokens_at_full_shapes(monkeypatch, builder, live, pairs):
    for k, v in FULL.items():
        monkeypatch.setattr(kl, k, v)
    case = getattr(kl, builder)(512, np.random.default_rng(0))
    for name in ("vB_b512", "vD_b512", "v0_b512"):
        w = kl.work(kl.VARIANTS[name][0](case), case)
        kv = live * kl.HKV * kl.D * 2 * 2  # K and V rows, bf16
        assert kv <= w["bytes"] < kv + 2e6  # plus q, o and the plan tables
        assert w["flops"] == pairs * kl.QPK * kl.HKV * 4 * kl.D
        ms, by = kl.bound_ms(w)
        assert by == "bytes" and ms == pytest.approx(w["bytes"] / 3.35e12 * 1e3)
    # the bench case: 18.5 MB of K+V a layer, 5.5 us (5.9 with q, o and the
    # plan); 4.6 GFLOP, 4.7 us
    if builder == "build_case":
        assert kv == pytest.approx(18.5e6, rel=3e-3)
        assert ms == pytest.approx(5.87e-3, rel=1e-2)
        assert w["flops"] / 989e12 * 1e3 == pytest.approx(4.67e-3, rel=1e-2)
    probe = kl.VARIANTS["probe_exp2_b512"][0](kl.build_case_probe(512, np.random.default_rng(0)))
    w = kl.work(probe, case)
    assert w == {"exp2": 9 * 8 * kl.RQ * 512}  # 9.44 M exp2: 9 live blocks at b512
    assert kl.bound_ms(w, rate=16 * 132 * 1.98e9) == (pytest.approx(2.26e-3, rel=1e-2),
                                                       "operations")
    assert kl.bound_ms(w) == (None, "operations")
