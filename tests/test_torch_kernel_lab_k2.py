"""B14, the kernel lab's K2/TQ variants, against deft_tpu's on the CPU.

deft_tpu's experiments/kernel_lab.py is loaded by path at its check shapes
(LAYERS 2, PROMPT 600, T_PAD 1024).  Held here:

- B14's plain version (the wrapper on CPU tensors) against deft_tpu's
  _lab2_call in interpret mode, bf16, 2e-2 of the largest output, as
  make_k2_variant sets it: k2_b1024s512, tq64_b512s512, deep_tq64_b512 and
  deep_k2tq64_b1024, each with FULL sentinel sub-blocks and, at 8x the
  case's q (sharper weights), without;
- the narrow-q window variants the port runs on B14 (prog_len = sub_len =
  block_len, tq = qwin over the case's block tables) against deft_tpu's B1
  with ``qwin`` in interpret mode: qw64_b512, deep_qw32_b512 and the
  sentinel case deep_full_b512;
- the sub-block tables and the whole-span segment table the port derives
  for every K2/TQ variant, against the ones deft_tpu's make_k2_variant hands
  _lab2_call, at the full shapes (T_PAD 8192).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_lab import (CHECK, FULL, as_np, dump_row_zero, jax_out, load_jax_lab,
                                   port_out, rel_err, set_shapes, sharpen)

from deft_tpu_torch.experiments import kernel_lab as kl

K2 = [("k2_b1024s512", (1024, 512, 0), 1024, "build_case"),
      ("tq64_b512s512", (512, 512, 64), 512, "build_case"),
      ("deep_tq64_b512", (512, 512, 64), 512, "build_case_deep"),
      ("deep_k2tq64_b1024", (1024, 512, 64), 1024, "build_case_deep")]


@pytest.fixture(scope="module")
def jlab():
    mod = load_jax_lab("deft_tpu_kernel_lab_k2")
    set_shapes(mod, CHECK)
    return mod


@pytest.fixture
def tlab(monkeypatch):
    for k, v in CHECK.items():
        monkeypatch.setattr(kl, k, v)
    return kl


@pytest.mark.parametrize("sentinel_subs,q_scale", [(True, 1), (False, 8)])
@pytest.mark.parametrize("name,k2,block_len,builder", K2)
def test_b14_plain_matches_deft_tpu_interpret(jlab, tlab, name, k2, block_len, builder,
                                              sentinel_subs, q_scale):
    cj, ct = sharpen(dump_row_zero(getattr(jlab, builder)(block_len, np.random.default_rng(0))),
                     getattr(tlab, builder)(block_len, np.random.default_rng(0)), q_scale)
    li = tlab.LAYERS - 1
    want = as_np(jlab.make_k2_variant(*k2, sentinel_subs=sentinel_subs)(
        cj["q"], cj["k_pool"], cj["v_pool"], jnp.asarray(li, jnp.int32), cj))
    call = tlab.make_k2_variant(*k2, sentinel_subs=sentinel_subs)(ct)
    assert call.kernel == "B14"
    args = call.args(li)
    sub_lo = args[7].numpy()
    assert (sub_lo < -(1 << 20)).any() == sentinel_subs  # the prompt's sub-blocks
    got = call.fn(*args)
    assert got.shape == (kl.HKV, kl.RQ, kl.D) and got.dtype == torch.bfloat16
    assert rel_err(as_np(got), want) < 2e-2
    if builder == "build_case":  # the lab's reference: B1 on the case
        v0 = port_out(tlab, "v0_b512",
                      tlab.build_case(512, np.random.default_rng(0)) | {"q": ct["q"]})
        assert rel_err(as_np(got), as_np(v0)) < 2e-2


@pytest.mark.parametrize("name,qwin", [("qw64_b512", 64), ("deep_qw32_b512", 32),
                                       ("deep_full_b512", 32)])
def test_qwin_variants_on_b14_match_deft_tpu_b1(jlab, tlab, name, qwin):
    make, bl, builder = tlab.VARIANTS[name]
    cj = dump_row_zero(jlab.VARIANTS[name][2](bl, np.random.default_rng(0)))
    ct = builder(bl, np.random.default_rng(0))
    call = make(ct)
    assert call.kernel == "B14"
    *_, prog_len, sub_len, seg_len, tq = call.args(0)
    assert (prog_len, sub_len, seg_len, tq) == (bl, bl, kl.SEG, qwin)
    want = as_np(jax_out(jlab, name, cj))
    assert rel_err(as_np(port_out(tlab, name, ct)), want) < 2e-2


@pytest.mark.parametrize("name", [n for n, *_ in K2] + ["k2_b2048s512", "deep_k2_b1024s512"])
def test_k2_tables_match_deft_tpu_at_full_shapes(monkeypatch, name):
    jmod = load_jax_lab("deft_tpu_kernel_lab_k2_full")
    set_shapes(jmod, FULL)
    for k, v in FULL.items():
        monkeypatch.setattr(kl, k, v)
    seen = {}

    def capture(q, kp, vp, li, seg_src, tok_lo, tok_hi, sub_lo, sub_hi, **kw):
        seen.update(seg_src=seg_src, sub_lo=sub_lo, sub_hi=sub_hi, **kw)

    jmod._lab2_call = capture
    make, bl, builder = kl.VARIANTS[name]
    cj = jmod.VARIANTS[name][2](bl, np.random.default_rng(0))
    jmod.VARIANTS[name][0](cj["q"], cj["k_pool"], cj["v_pool"], jnp.asarray(0, jnp.int32), cj)
    (q, kp, vp, li, seg_src, tok_lo, tok_hi, sub_lo, sub_hi, _, qpk, prog_len, sub_len,
     seg_len, tq) = make(builder(bl, np.random.default_rng(0))).args(0)
    for k, t in (("seg_src", seg_src), ("sub_lo", sub_lo), ("sub_hi", sub_hi)):
        np.testing.assert_array_equal(as_np(seen[k]), t.numpy(), err_msg=k)
        assert t.dtype == torch.int32
    assert (seen["prog_len"], seen["sub_len"], seen["seg_len"], seen["tq"]) == \
        (prog_len, sub_len, seg_len, tq)
    assert qpk == kl.QPK
