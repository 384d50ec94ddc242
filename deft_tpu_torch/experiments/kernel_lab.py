"""Flatten kernel lab on the card: time variants of B1 (the paged flatten
kernel) at the headline bench shape (the 8B's attention geometry: Hkv 8,
D 128, 64 leaves x qpk 4 = 256 folded rows, a 4400-token prompt and 2-token
tails in a 8192-token plan), ms per 32-layer step, each output held against
the v0 output of its case first.

    python -m deft_tpu_torch.experiments.kernel_lab [variant ...] [--device cpu]
    DEFT_LAB_CHECK=1 python -m deft_tpu_torch.experiments.kernel_lab --device cpu

Port of deft_tpu's experiments/kernel_lab.py.  Its constants (:26-32), case
builders (build_case :61, build_case_q :35, build_case_deep :465, sentinel
:525, build_case_probe :807) and VARIANTS table (:811-866, every name) are
kept; on the CPU each builder draws numpy's default_rng(0) stream in
deft_tpu's order (on the card, the same shapes from a torch.Generator
seeded 0 on the card, minutes faster at the full shapes), then zeroes the
pools' DUMP_SLOT row
(row 0, live token 0's in deft_tpu's cases), which the port's flatten
bodies read as zeros (``_dump_row_zero``).  The variants run the port's
kernels:

- ``v0_*``, ``full_*``, ``qw0_b512``, ``deep_qw0_*``: B1
  (ops/paged_flatten_attn.py), the sentinel cases as built;
- ``q_*``, ``qfull_*``: B4 (ops/paged_quant.py) with the variant's seg
  table; ``qwin`` is not a parameter of the port's B4 (its row tiles skip
  as B1's do), the line says so;
- ``vB_*``: B12, ``vD_*``: B13 (ops/lab_flatten.py);
- ``qw{32,64}_*``, ``deep_qw{32,64}_*``, ``deep_full_b512`` and the
  ``k2``/``tq`` variants: B14 (ops/lab_flatten.py), the qwin variants at
  prog_len = sub_len = block_len with tq = qwin over the case's block
  tables, the others as make_k2_variant (:737) derives their sub-block
  tables;
- ``probe_exp2_b512``: B15 (ops/lab_probe.py).

Timing is the runner's two-point difference (runtime/runner.py
rep_seconds: CUDA events behind a sleep kernel), one launch a layer, li = 0
.. LAYERS - 1; deft_tpu's q perturbation and host clock are not carried
over.  Each line adds the variant's bound (the larger of its live KV bytes
at 3.35 TB/s and its FLOPs at 989 TFLOP/s, the probe's exp2 at the card's
rate) and the card's name and power limit.  DEFT_LAB_CHECK=1 trims the
shapes as deft_tpu's lab does (LAYERS 2, PROMPT 600, T_PAD 1024) for the
run (main restores them on return) and skips timing, as does the CPU.  A variant that fails to build, to launch, or to
match its case's v0 output within TOL makes the run exit non-zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import traceback
from typing import Callable, NamedTuple

import numpy as np
import torch

from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.ops import lab_flatten as lf
from deft_tpu_torch.ops import lab_probe as lp
from deft_tpu_torch.ops import paged_flatten_attn as pf
from deft_tpu_torch.ops import paged_quant as pq
from deft_tpu_torch.plan.flatten import FULL_BLOCK_LO
from deft_tpu_torch.runtime.runner import rep_seconds, resolve_device

LAYERS = 32
HKV, D, QPK = 8, 128, 4
LEAVES = 64          # width 50 padded
RQ = LEAVES * QPK    # folded rows per kv head
PROMPT = 4400        # live tree tokens (prompt 4000 + tails)
T_PAD = 8192         # pow2 token bucket
SEG = 128

# H100 SXM (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s; exp2 a clock
# per SM (CUDA C Programming Guide, arithmetic instruction throughput,
# compute capability 9.0)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 989e12
EXP2_PER_SM_CLOCK = 16
# max |out - v0| / max |v0| a variant may reach (bf16: deft_tpu
# tests/test_kernels.py's bound)
TOL = 2e-2
SCALE = D ** -0.5


# -- cases ------------------------------------------------------------------------

def _normal(rng, shape, device) -> torch.Tensor:
    """Standard normals times 0.3 in bf16 on ``device``: numpy's stream, or
    a torch.Generator's (on its own device)."""
    if isinstance(rng, np.random.Generator):
        return torch.from_numpy(rng.standard_normal(shape) * 0.3).to(torch.bfloat16).to(device)
    x = torch.randn(shape, generator=rng, device=rng.device).mul_(0.3)
    return x.to(torch.bfloat16).to(device)


def _int8(rng, shape, device) -> torch.Tensor:
    """int8 codes uniform in [-127, 127]."""
    if isinstance(rng, np.random.Generator):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(device)
    return torch.randint(-127, 128, shape, generator=rng, device=rng.device,
                         dtype=torch.int32).to(torch.int8).to(device)


def _uniform(rng, lo, hi, shape, device) -> torch.Tensor:
    if isinstance(rng, np.random.Generator):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device)
    return (torch.rand(shape, generator=rng, device=rng.device) * (hi - lo) + lo).to(device)


def _dump_row_zero(pool: torch.Tensor) -> torch.Tensor:
    """``pool`` with the row of DUMP_SLOT zeroed in every layer.  deft_tpu's
    lab gives pool row 0 to live token 0; in the port that row is the
    pool's reserved DUMP_SLOT, which no live token gets and which the
    flatten bodies of B1, B4 and B6 read as zeros (csrc/flat_q_body.cuh,
    kDumpRow), so the port's cases hold zeros there and every kernel and
    plain version attends the same KV."""
    pool[:, DUMP_SLOT] = 0
    return pool


def _tables(case, device, tok_lo, tok_hi, block_len):
    """Set the case's token and block tables (numpy on the host under
    ``host``, int32 tensors on ``device``) and its live block count."""
    nb = T_PAD // block_len
    blk_lo = tok_lo.reshape(nb, block_len).min(1)
    blk_hi = tok_hi.reshape(nb, block_len).max(1)
    host = dict(case.get("host", {}), tok_lo=tok_lo, tok_hi=tok_hi, blk_lo=blk_lo,
                blk_hi=blk_hi)
    case.update({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in host.items()},
                host=host, live_blocks=int((blk_lo < blk_hi).sum()))
    return case


def build_case(block_len: int, rng, device="cpu"):
    """Synthetic bench-shape plan: one contiguous prompt run attended by
    all leaves + per-leaf 2-token tails, seg tables at ``block_len``."""
    S = T_PAD + 2 * SEG
    k_pool = _dump_row_zero(_normal(rng, (LAYERS, S, HKV * D), device))
    v_pool = _dump_row_zero(_normal(rng, (LAYERS, S, HKV * D), device))
    # token metadata: prompt tokens [0, PROMPT) attended by all leaves;
    # the rest dead (pow2 bucket padding)
    tok_lo = np.full(T_PAD, 2**30, np.int32)
    tok_hi = np.zeros(T_PAD, np.int32)
    tok_lo[:PROMPT] = 0
    tok_hi[:PROMPT] = LEAVES
    # per-leaf tails: 2 tokens each, leaf r attends its own
    o = PROMPT
    for r in range(LEAVES):
        tok_lo[o:o + 2] = r
        tok_hi[o:o + 2] = r + 1
        o += 2
    nb = T_PAD // block_len
    nseg = block_len // SEG
    seg_src = (np.arange(nb * nseg, dtype=np.int32) * SEG) % (S - SEG)
    q = _normal(rng, (HKV, RQ, D), device)
    case = dict(q=q, k_pool=k_pool, v_pool=v_pool, block_len=block_len,
                host=dict(seg_src=seg_src))
    return _tables(case, device, tok_lo, tok_hi, block_len)


def build_case_q(block_len: int, rng, device="cpu"):
    """int8 pools + per-(token, head) scales for the quant kernel (seg
    fixed at 128)."""
    case = build_case(block_len, rng, device)
    S = case["k_pool"].shape[1]
    del case["k_pool"], case["v_pool"]
    kd = _dump_row_zero(_int8(rng, (LAYERS, S, HKV * D), device))
    vd = _dump_row_zero(_int8(rng, (LAYERS, S, HKV * D), device))
    ks = _uniform(rng, 0.01, 0.1, (LAYERS, HKV, S), device)
    case.update(k_pool=kd, v_pool=vd, k_scale=ks, v_scale=ks)
    return case


def build_case_deep(block_len: int, rng, device="cpu"):
    """Deep-tree shape (long-context replay late state): the shared prefix
    is ~1/3 of live KV, per-leaf suffix runs of 96 tokens make up the rest:
    most blocks then serve a single leaf."""
    case = build_case(block_len, rng, device)
    tok_lo = np.full(T_PAD, 2**30, np.int32)
    tok_hi = np.zeros(T_PAD, np.int32)
    prefix = min(1536, T_PAD // 2)  # check mode trims T_PAD
    tok_lo[:prefix] = 0
    tok_hi[:prefix] = LEAVES
    o = prefix
    per_leaf = min(96, (T_PAD - prefix) // LEAVES)
    for r in range(LEAVES):
        tok_lo[o:o + per_leaf] = r
        tok_hi[o:o + per_leaf] = r + 1
        o += per_leaf
    return _tables(case, device, tok_lo, tok_hi, block_len)


def sentinel(builder):
    """Apply the plan's FULL-block sentinel (plan/flatten.py FULL_BLOCK_LO):
    blocks whose every token is live with interval [0, LEAVES) take the
    kernels' mask-free path.  Exact: outputs must equal v0."""
    def build(block_len, rng, device="cpu"):
        case = builder(block_len, rng, device)
        h = case["host"]
        nb = T_PAD // block_len
        tl, th = h["tok_lo"].reshape(nb, block_len), h["tok_hi"].reshape(nb, block_len)
        full = (tl == 0).all(axis=1) & (th == LEAVES).all(axis=1)
        h["blk_lo"] = np.where(full, FULL_BLOCK_LO, h["blk_lo"]).astype(np.int32)
        case.update(blk_lo=torch.from_numpy(h["blk_lo"]).to(device),
                    full_blocks=int(full.sum()))
        return case
    build.__name__ = "sent_" + builder.__name__
    return build


def build_case_probe(block_len, rng, device="cpu"):
    return build_case(block_len, rng, device)


# -- variants ---------------------------------------------------------------------

class Call(NamedTuple):
    """One variant on one case: ``fn(*args(li))`` launches its kernel at
    layer li, ``plain(*args(li))`` is the kernel's plain version, ``fold``
    takes an output to the folded (HKV, RQ, D) layout in q's dtype."""
    kernel: str
    fn: Callable
    plain: Callable
    args: Callable
    fold: Callable = lambda o: o


def _b1(case, blk_lo=None):
    q = pf.unfold_rows(case["q"], LEAVES).contiguous()
    bl = case["block_len"]
    rest = (case["seg_src"], case["tok_lo"], case["tok_hi"], case["blk_lo"], case["blk_hi"],
            SCALE, bl, min(SEG, bl))
    return Call("B1", pf.paged_flatten_attention, pf.paged_flatten_attention_plain,
                lambda li: (q, case["k_pool"], case["v_pool"], li, *rest),
                lambda o: pf.fold_rows(o, HKV))


def v0_production(case):
    return _b1(case)


def _b4(case, seg, label):
    q = pf.unfold_rows(case["q"], LEAVES).contiguous()
    bl = case["block_len"]
    # the seg table at this seg length: the same linear address coverage as
    # the case's 128-token table (outputs stay comparable)
    nseg = bl // seg
    seg_src = torch.arange(T_PAD // bl * nseg, dtype=torch.int32,
                           device=q.device) * seg
    rest = (seg_src, case["tok_lo"], case["tok_hi"], case["blk_lo"], case["blk_hi"], SCALE,
            bl, seg)
    return Call(label, pq.paged_flatten_attention_q, pq.paged_flatten_attention_q_plain,
                lambda li: (q, case["k_pool"], case["v_pool"], case["k_scale"],
                            case["v_scale"], li, *rest),
                lambda o: pf.fold_rows(o, HKV))


def v0_quant(case):
    return _b4(case, 128, "B4")


def make_qwin_variant_q(qwin, seg):
    def fn(case):
        return _b4(case, seg, f"B4 (qwin {qwin}: not a parameter of the port's B4)"
                   if qwin else "B4")
    return fn


def _lab_blocks(case, kernel, fn, plain):
    """B12 or B13 over the case's blocks, its seg table at SEG."""
    bl = case["block_len"]
    rest = (case["seg_src"], case["tok_lo"], case["tok_hi"], case["blk_lo"], case["blk_hi"],
            SCALE, QPK, bl, min(SEG, bl))
    return Call(kernel, fn, plain,
                lambda li: (case["q"], case["k_pool"], case["v_pool"], li, *rest))


def vB_passes(case):
    return _lab_blocks(case, "B12", lf.lab_passes_attention, lf.lab_passes_attention_plain)


def vD_fused(case):
    return _lab_blocks(case, "B13", lf.lab_fused_attention, lf.lab_fused_attention_plain)


def _b14(case, seg_src, sub_lo, sub_hi, prog_len, sub_len, seg_len, tq):
    rest = (seg_src, case["tok_lo"], case["tok_hi"], sub_lo, sub_hi, SCALE, QPK, prog_len,
            sub_len, seg_len, tq)
    return Call("B14", lf.lab_k2_attention, lf.lab_k2_attention_plain,
                lambda li: (case["q"], case["k_pool"], case["v_pool"], li, *rest))


def make_qwin_variant(qwin):
    """qwin 0: B1; else B14 at prog_len = sub_len = block_len over the
    case's block tables, tq = qwin."""
    def fn(case):
        if not qwin:
            return _b1(case)
        bl = case["block_len"]
        return _b14(case, case["seg_src"], case["blk_lo"], case["blk_hi"], bl, bl,
                    min(SEG, bl), qwin)
    return fn


def make_k2_variant(prog_len, sub_len, tq, sentinel_subs=True):
    """B14 at prog_len tokens a program with sub_len dispatch; derives the
    sub-block lo/hi (+ FULL sentinel) from the case's token arrays and a
    seg table over the whole span (the cases' seg tables are SEG-aligned
    and linear)."""
    def fn(case):
        tl = case["host"]["tok_lo"].reshape(-1, sub_len)
        th = case["host"]["tok_hi"].reshape(-1, sub_len)
        sub_lo, sub_hi = tl.min(1), th.max(1)
        if sentinel_subs:
            full = (tl == 0).all(1) & (th == LEAVES).all(1) & (sub_lo < sub_hi)
            sub_lo = np.where(full, FULL_BLOCK_LO, sub_lo).astype(np.int32)
        S = case["k_pool"].shape[1]
        seg_src = (np.arange(T_PAD // SEG, dtype=np.int32) * SEG) % (S - SEG)
        dev = case["q"].device
        return _b14(case, *(torch.from_numpy(a).to(dev) for a in (seg_src, sub_lo, sub_hi)),
                    prog_len, sub_len, SEG, tq)
    return fn


def make_exp2_probe(passes_per_block):
    """B15: just the exp2 passes the bench shape's live blocks do: live
    blocks steps x passes_per_block exp2 sweeps over an (RQ, block) tile."""
    def fn(case):
        q = case["q"]
        x0 = torch.full((RQ, case["block_len"]), -0.5, dtype=torch.float32, device=q.device)
        nb = max(1, case["live_blocks"])
        return Call("B15", lp.lab_exp2_probe, lp.lab_exp2_probe_plain,
                    lambda li: (x0, nb, passes_per_block, D),
                    lambda o: o.expand(HKV, RQ, D).to(q.dtype))
    return fn


VARIANTS = {
    "v0_b128": (v0_production, 128, build_case),
    "vB_b128": (vB_passes, 128, build_case),
    "v0_b256": (v0_production, 256, build_case),
    "vB_b256": (vB_passes, 256, build_case),
    "v0_b512": (v0_production, 512, build_case),
    "vB_b512": (vB_passes, 512, build_case),
    "q_b256": (v0_quant, 256, build_case_q),
    "q_b512": (v0_quant, 512, build_case_q),
    "vD_b256": (vD_fused, 256, build_case),
    "vD_b512": (vD_fused, 512, build_case),
    # narrow-q window sweep: bench shape and the deep-tree shape
    "qw0_b512": (make_qwin_variant(0), 512, build_case),
    "qw32_b512": (make_qwin_variant(32), 512, build_case),
    "qw64_b512": (make_qwin_variant(64), 512, build_case),
    "deep_qw0_b512": (make_qwin_variant(0), 512, build_case_deep),
    "deep_qw32_b512": (make_qwin_variant(32), 512, build_case_deep),
    "deep_qw64_b512": (make_qwin_variant(64), 512, build_case_deep),
    "deep_qw0_b256": (make_qwin_variant(0), 256, build_case_deep),
    "deep_qw32_b256": (make_qwin_variant(32), 256, build_case_deep),
    # int8 wide segments: one 512-token segment per block vs four of 128
    "q_b512_seg128_qw0": (make_qwin_variant_q(0, 128), 512, build_case_q),
    "q_b512_seg128_qw32": (make_qwin_variant_q(32, 128), 512, build_case_q),
    "q_b512_seg512_qw0": (make_qwin_variant_q(0, 512), 512, build_case_q),
    "q_b512_seg512_qw32": (make_qwin_variant_q(32, 512), 512, build_case_q),
    # mask-free FULL-block sentinel: outputs must equal the masked path's
    "full_b512": (v0_production, 512, sentinel(build_case)),
    "full_b1024": (v0_production, 1024, sentinel(build_case)),
    "deep_full_b512": (make_qwin_variant(32), 512, sentinel(build_case_deep)),
    "qfull_b512_seg512": (make_qwin_variant_q(32, 512), 512, sentinel(build_case_q)),
    # bigger blocks alone
    "v0_b1024": (v0_production, 1024, build_case),
    "deep_qw32_b1024": (make_qwin_variant(32), 1024, build_case_deep),
    # two or four 512-token sub-blocks a program
    "k2_b1024s512": (make_k2_variant(1024, 512, 0), 1024, build_case),
    "k2_b2048s512": (make_k2_variant(2048, 512, 0), 2048, build_case),
    "deep_k2_b1024s512": (make_k2_variant(1024, 512, 0), 1024, build_case_deep),
    # row-tile skipping: masked sub-blocks update only the row tiles their
    # leaf interval meets
    "tq64_b512s512": (make_k2_variant(512, 512, 64), 512, build_case),
    "deep_tq64_b512": (make_k2_variant(512, 512, 64), 512, build_case_deep),
    "deep_k2tq64_b1024": (make_k2_variant(1024, 512, 64), 1024, build_case_deep),
    # the transcendental floor: 8 exp2 passes (one a head) over an
    # (Rq, block) tile a live block, nothing else
    "probe_exp2_b512": (make_exp2_probe(8), 512, build_case_probe),
}


# -- measurement ------------------------------------------------------------------

def smi(device: torch.device, fields: str) -> str:
    """nvidia-smi's csv row of ``fields`` for ``device``'s card."""
    out = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                          f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def exp2_rate(device: torch.device) -> float:
    """exp2 a second the card can do: EXP2_PER_SM_CLOCK x SMs x the SM
    clock nvidia-smi reports as its maximum."""
    mhz = float(smi(device, "clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return EXP2_PER_SM_CLOCK * sms * mhz * 1e6


def work(call: Call, case) -> dict:
    """What a launch must do on this case's data: its live plan tokens'
    K/V bytes, q, o and plan bytes, and the FLOPs of the (row, token) pairs
    the intervals make visible; the probe: its exp2 count."""
    a = call.args(0)
    if call.kernel == "B15":
        x0, nb, passes, _ = a
        return dict(exp2=nb * passes * x0.numel())
    h = case["host"]
    lo, hi = h["tok_lo"].astype(np.int64), h["tok_hi"].astype(np.int64)
    live = hi > lo
    pairs = int((hi[live] - lo[live]).sum()) * QPK * HKV
    pool = case["k_pool"]
    token = HKV * (2 * D + 8) if pool.dtype == torch.int8 else HKV * D * 2 * pool.element_size()
    q = case["q"]
    plan = sum(t.numel() * 4 for t in a if isinstance(t, torch.Tensor) and t.dtype == torch.int32)
    return dict(bytes=int(live.sum()) * token + 2 * q.numel() * q.element_size() + plan,
                flops=pairs * 4 * D)


def bound_ms(w: dict, rate=None):
    """(ms a launch, what bounds it): the larger of the bytes at PEAK_BYTES
    and the FLOPs at PEAK_FLOPS; the probe's exp2 at ``rate`` (None:
    unknown off the card)."""
    if "exp2" in w:
        return (None if rate is None else w["exp2"] / rate * 1e3), "operations"
    tb, tf = w["bytes"] / PEAK_BYTES * 1e3, w["flops"] / PEAK_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_step(call: Call, device: torch.device) -> float:
    """ms per LAYERS-layer step: one launch a layer, li = 0 .. LAYERS - 1,
    by the runner's two-point difference."""
    arg_sets = [call.args(li) for li in range(LAYERS)]

    def rep():
        for a in arg_sets:
            call.fn(*a)

    return rep_seconds([rep], device)[0] * 1e3


def main(argv=None, results=None) -> int:
    """Run the named variants (default: all); returns the exit code.  With
    ``results`` (a dict), each variant that ran leaves its record there:
    kernel, block, live_blocks, ms (a LAYERS-layer step), diff, rel,
    bound_ms (a launch), bound_by, its folded output ``out``, its ``call``
    and ``case`` (kept, not freed) and the shapes it ran at (``layers``,
    ``t_pad``)."""
    global LAYERS, PROMPT, T_PAD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="names of VARIANTS (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    unknown = [n for n in args.variants if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    check_only = os.environ.get("DEFT_LAB_CHECK") == "1"
    shapes = LAYERS, PROMPT, T_PAD
    if check_only:  # correctness pass on trimmed shapes
        LAYERS, PROMPT, T_PAD = 2, 600, 1024
    try:
        return _run(args.variants or list(VARIANTS), resolve_device(args.device),
                    check_only, results)
    finally:
        LAYERS, PROMPT, T_PAD = shapes


def _run(names, device, check_only, results) -> int:
    timed = device.type == "cuda" and not check_only
    card = smi(device, "name,power.limit") if device.type == "cuda" else "cpu, no card"
    rate = exp2_rate(device) if device.type == "cuda" else None
    # the last variant of each case, after which the case is freed
    last = {(VARIANTS[n][2].__name__, VARIANTS[n][1]): i for i, n in enumerate(names)}
    cases, refs, failed = {}, {}, []
    for i, name in enumerate(names):
        make, bl, builder = VARIANTS[name]
        if bl > T_PAD:
            print(f"{name:10s} SKIP (block {bl} > T_PAD {T_PAD})", flush=True)
            continue
        key = (builder.__name__, bl)
        try:
            if key not in cases:
                # fresh seed per case: cross-block-size outputs must compare
                rng = (np.random.default_rng(0) if device.type == "cpu"
                       else torch.Generator(device=device).manual_seed(0))
                cases[key] = builder(bl, rng, device)
            case = cases[key]
            call = make(case)
            out = call.fold(call.fn(*call.args(LAYERS - 1)))
            # sentinel cases must give the unsentineled builder's output
            # (the mask-free path is exact) -> shared reference
            ref = refs.setdefault(builder.__name__.replace("sent_", ""), out)
            diff = float((out.double() - ref.double()).abs().max())
            rel = diff / max(float(ref.double().abs().max()), 1e-30)
            if not bool(torch.isfinite(out).all()):
                raise ArithmeticError("non-finite output")
            if not rel <= TOL:
                raise ArithmeticError(f"max|diff vs v0| {diff:.3e} is {rel:.3e} of max|v0|, "
                                      f"above {TOL}")
            ms = time_step(call, device) if timed else None
        except Exception as e:  # noqa: BLE001 - every failure is reported and counted
            traceback.print_exc()
            print(f"{name:10s} block={bl:4d} FAIL: {type(e).__name__}: {str(e)[:160]}",
                  flush=True)
            failed.append(name)
            continue
        finally:
            if last[key] == i:
                cases.pop(key, None)
        w = work(call, case)
        b_ms, b_by = bound_ms(w, rate)
        step = None if b_ms is None else b_ms * LAYERS
        ms_txt = f"{ms:7.3f}" if ms is not None else "not timed"
        b_txt = f"{step:.4f} ms/step" if step is not None else "not known off the card"
        extra = ""
        if "exp2" in w and ms is not None:
            extra = (f", {w['exp2'] / 1e6:.2f} M exp2 a launch at "
                     f"{w['exp2'] * LAYERS / ms / 1e9:.2f} T/s, "
                     f"{step / ms:.1%} of the exp2 rate")
        print(f"{name:10s} block={bl:4d} live_blocks={case['live_blocks']:3d}"
              f"  {ms_txt} ms/step ({LAYERS}L)   max|diff vs v0|={diff:.2e} (rel {rel:.1e})"
              f"  {call.kernel}, bound {b_txt} ({b_by}){extra}  [{card}]",
              flush=True)
        if results is not None:
            results[name] = dict(kernel=call.kernel, block=bl, live_blocks=case["live_blocks"],
                                 ms=ms, diff=diff, rel=rel, bound_ms=b_ms, bound_by=b_by,
                                 out=out, call=call, case=case, layers=LAYERS, t_pad=T_PAD)
        del case, call
    # speed-of-light note: the bench case's live K+V bf16 bytes a layer
    live_kv = 2 * (PROMPT + 2 * LEAVES) * HKV * D * 2
    print(f"# live KV {live_kv / 1e6:.1f} MB/layer -> "
          f"{live_kv * LAYERS / PEAK_BYTES * 1e3:.3f} ms/step at 3.35 TB/s [{card}]",
          flush=True)
    if failed:
        print(f"# FAILED: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
