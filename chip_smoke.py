#!/usr/bin/env python3
"""Start deft_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # also torch.profiler decode breakdowns

Phases, each fatal on failure (the script then exits non-zero and prints no
result line):
  1. card:    nvidia-smi's name and power limit, torch's device name;
  2. build:   nvcc builds every kernel from csrc/, one process per source;
  3. kernels: each kernel against its plain torch version on the card, on the
              shapes its path gives it (Llama-3.1-8B heads, bf16, tolerance
              2e-2) and on small fp32 trees with dead, FULL and few-leaf
              blocks, unaligned seq segments and a short prompt's plans that
              are not segment-aligned, over bf16/fp32 pools and int8 pools
              with random codes and scales (tolerance 2e-5), live rows only;
  4. main:    the 8B model (random bf16 weights from a CUDA torch.Generator,
              all 32 layers) serves Simple_Tree few-shot, width 50, prompt
              4000, 64 generated tokens, block_len 256, in flatten then seq
              mode; B1-B3's launch counters must move during this run, and
              the first decode step's logits must agree between modes
              (relative L2 error below LOGITS_LIMIT), while two controls on
              the same step must land on either side of that limit: one ulp
              of noise in every layer's attention output below it, one plan
              block of the prompt hidden from every leaf above it (a rerun
              and a one-token mask fault are printed beside them);
  5. int8:    the same weights and workload over an int8 KV cache, flatten
              then seq: B4 and B5 must launch and B1 and B2 must not; the
              first decode step's logits are compared with the bf16 cache's;
  6. short:   the same weights and workload over the CLI's default 16-token
              prompt, flatten then seq, bf16 then int8 KV: the steps whose
              plans are not segment-aligned run B6 and B7, which must launch;
  7. batch:   four requests with distinct prompts of 4000, 3000, 2000 and
              1000 tokens (the 8B bf16 weights, bf16 KV, 40960 slots), each a
              width-50 Simple_Tree of 64 tokens a branch: first each alone
              (B3 prefill and its first decode step), then all four in one
              ragged prefill (B8) and one multi-tree step on the same branch
              tokens, whose rows must agree with the alone runs (relative L2
              below LOGITS_LIMIT); then BatchedEngine.add_requests + run() in
              flatten and in seq: B8 launches once a layer, B3 never, B1 or
              B6 (flatten) and B2 or B7 (seq) must launch;
  8. int8w:   the main path's workload over int8 weights made on the card
              (weight_dtype "int8-pallas"), flatten then seq: B9 launches 129
              times a decode step (4 matmuls x 32 layers + lm_head) and never
              in prefill; the first decode step's logits against the same
              codes and scales under "int8" (the plain expression, 0 B9
              launches) below LOGITS_LIMIT;
  9. timing:  CUDA-event times of each kernel, its plain version and, where
              one PyTorch call computes the same function, that call, at its
              path's shapes, beside the least time the card could take.
Each path's counts are set to 0 just before it and read just after (the
short path's two runs each, summed; the batch path's two engine runs each).
Then one JSON line of kernels, the card's nvidia-smi line, and the last
line {"ok": true, "device": {...}}.

Tolerances: bf16 kernels round P to bf16 for the PV product and sum in
another order than the fp32 plain versions, so 2e-2 relative (deft_tpu
tests/test_kernels.py's bf16 bound); fp32 kernels differ by summation order
only, 2e-5.  Errors are max |kernel - plain| / max |plain| over live rows.
The batch path's four paths hold their B8 and multi-tree logits to the
main path's LOGITS_LIMIT, against the same requests run alone.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 and fp32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0
# relative L2 error allowed between the first decode step's logits in
# flatten and in seq mode (bf16, 32 random layers): the geometric mean of the
# one-ulp-noise control (1.835e-2) and the dropped-block fault (1.854e-1) on
# an H100, rounded down (logits_controls; PERF.md)
LOGITS_LIMIT = 5e-2
WIDTH, PROMPT_LEN, GEN_LEN = 50, 4000, 64
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the batch path: four prompts; 40960 KV slots (5.4 GB), because each of the
# 200 leaves reserves a 128-slot chunk (core/kv_pool.py alloc_for), so the
# 10000 prompt tokens plus 200 chunks do not fit 32768
BATCH_LENS = (4000, 3000, 2000, 1000)
BATCH_SLOTS = 40960
# Llama-3.1-8B's matmul weights (H, I), as B9 sees them at decode
INT8_SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672),
               "wdown": (14336, 4096), "lm_head": (4096, 128256)}

# name -> (TPU kernel it replaces, source, plan kind, KV, plan layout)
KERNELS = {
    "prefill": ("deft_tpu/ops/prefill.py:82", "prefill.cu", None, None, None),
    "paged_flatten": ("deft_tpu/ops/paged_flatten_attn.py:63", "paged_flatten.cu",
                      "flatten", "inherit", "paged"),
    "paged_seq": ("deft_tpu/ops/paged_seq_attn.py:41", "paged_seq.cu", "seq",
                  "inherit", "paged"),
    "paged_flatten_q": ("deft_tpu/ops/paged_quant.py:32", "paged_flatten.cu",
                        "flatten", "int8", "paged"),
    "paged_seq_q": ("deft_tpu/ops/paged_seq_attn.py:41", "paged_seq.cu", "seq",
                    "int8", "paged"),
    "flatten_gather": ("deft_tpu/ops/flatten_attn.py:77", "flatten_gather.cu",
                       "flatten", None, "gather"),
    "seq_gather": ("deft_tpu/ops/seq_attn.py:28", "seq_gather.cu", "seq", None,
                   "gather"),
    "ragged_prefill": ("deft_tpu/ops/prefill.py:205", "prefill.cu", None, None, None),
    "int8_matmul": ("deft_tpu/ops/int8_matmul.py:44", "int8_matmul.cu", None, None,
                    None),
}


class Failure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-9))


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def wrappers():
    """name -> (kernel wrapper, its plain version): the wrappers carry the
    launch counters."""
    from deft_tpu_torch.ops import flatten_attn as fa
    from deft_tpu_torch.ops import int8_matmul as i8
    from deft_tpu_torch.ops import paged_flatten_attn as pf
    from deft_tpu_torch.ops import paged_quant as pq
    from deft_tpu_torch.ops import paged_seq_attn as ps
    from deft_tpu_torch.ops import prefill as pr
    from deft_tpu_torch.ops import seq_attn as sa

    return {
        "prefill": (pr.prefill_attention, pr.prefill_attention_plain),
        "paged_flatten": (pf.paged_flatten_attention, pf.paged_flatten_attention_plain),
        "paged_seq": (ps.paged_seq_attention, ps.paged_seq_attention_plain),
        "paged_flatten_q": (pq.paged_flatten_attention_q,
                            pq.paged_flatten_attention_q_plain),
        "paged_seq_q": (ps.paged_seq_attention_q, ps.paged_seq_attention_q_plain),
        "flatten_gather": (fa.flatten_attention, fa.flatten_attention_plain),
        "seq_gather": (sa.seq_attention, sa.seq_attention_plain),
        "ragged_prefill": (pr.ragged_prefill_attention, pr.ragged_prefill_attention_plain),
        "int8_matmul": (i8.int8_matmul, i8.int8_matmul_plain),
    }


def reset_counts() -> None:
    for fn, _ in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, (fn, _) in wrappers().items()}


# -- trees and kernel inputs ---------------------------------------------------------

def grow_tree(prompt_len: int, width: int, steps: int, slots: int, rng):
    """A Simple_Tree-shaped tree: prompt, `width` leaves, `steps` appends."""
    from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache

    tree = TreeCache(TokenKVPool(slots), ReqToTokenPool(max(64, 2 * width),
                                                        prompt_len + steps + 64))
    tree.init_prompt(list(rng.integers(4, 1000, prompt_len)))
    for i, c in enumerate(tree.branch(tree.root, width)):
        c.append_token(50 + i)
    for _ in range(steps):
        tree.alloc()
        for leaf in list(tree.leaves.values()):
            leaf.append_token(int(rng.integers(1, 400)))
    tree.alloc()
    return tree


def small_trees(rng):
    """Three small trees: the first has FULL, dead and few-leaf blocks; the
    second has leaves with 1-token runs at unaligned offsets
    (speculative-decoding accepts merged into the root), so its seq plan
    covers them with seg_off > 0; the third is the CLI's 16-token prompt at
    width 50, whose plans are not segment-aligned."""
    from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache

    a = grow_tree(700, 6, 10, 8192, rng)
    a.cut(sorted(a.leaves.values(), key=lambda x: x.id)[0])  # prune one leaf
    a.alloc()
    b = TreeCache(TokenKVPool(16384), ReqToTokenPool(64, 4096))
    b.init_prompt(list(range(300)))
    for i, c in enumerate(b.branch(b.root, 16)):
        c.append_token(50 + i)
    b.alloc()
    for _ in range(3):
        leaves = list(b.leaves.values())
        before = b.root.kv_len
        for i in range(2):
            b.merge_nodes(b.root, leaves[i], prune_b=False)
        for leaf in leaves:
            b.reset_node_KV(leaf, b.root.kv_len - before)
        b.sync_page_table()
        b.alloc()
    c = grow_tree(16, 50, 4, 8192, rng)
    return a, b, c


def to_dev(plan_arrays, dev):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in plan_arrays]


# int8 rules of runner.build_plan (deft_tpu runner.py:1227-1246)
INT8_RULES = {"flatten": dict(seg_len=(512, 256, 128), waste_limit=(1.1, 1.2, 3.0)),
              "seq": dict(seg_len=(128,), waste_limit=32.0)}


def kernel_case(name, tree, qpk, Hkv, D, dtype, dev, gen, block_len, kv=None,
                as_built=False):
    """(plan, args) of kernel `name` on this tree's plan, with random q and
    pools: of `dtype`, or int8 codes in [-127, 127] with scales in
    [0.01, 0.1) (deft_tpu tests/test_kernels.py:348-352).  Paged kernels get
    the plan the runner builds (int8 pools: the int8 segment rules).  Gather
    kernels get the tree's gather layout, or with `as_built` the plan the
    runner builds for bf16 pools, which must then not be paged; `kv` picks
    their pools."""
    import torch
    from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan

    _, _, kind, kv_kind, layout = KERNELS[name]
    kv = kv_kind or kv or "inherit"
    kw = {}
    if layout == "paged" and kv == "int8":
        kw = INT8_RULES[kind]
    elif layout == "gather" and not as_built:
        kw = {"seg_len": None} if kind == "flatten" else {"want_paged": False}
    if kind == "flatten":
        plan = build_flatten_plan(tree, q_per_kv=qpk, block_len=block_len,
                                  min_token_bucket=1024, **kw)
    else:
        plan = build_seq_plan(tree, q_per_kv=qpk, block_len=block_len,
                              min_token_bucket=1024, **kw)
    check(plan.paged == (layout == "paged"),
          f"{name}: expected a {layout} plan, got paged={plan.paged}")
    S = tree.token_to_kv_pool.size
    shape = (1, S, Hkv * D)
    if kv == "int8":
        pools = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand((1, Hkv, S), generator=gen, device=dev) * 0.09 + 0.01
                  for _ in range(2)]
    else:
        pools = [torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for _ in range(2)]
        scales = [None, None]
    q = torch.randn((plan.l_pad, qpk * Hkv, D), generator=gen, device=dev).to(dtype)
    scale = D ** -0.5
    if kind == "flatten" and layout == "paged":
        arrs = to_dev([plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo,
                       plan.blk_hi], dev)
        tail = (scale, plan.block_len, plan.seg_len)
    elif kind == "flatten":
        arrs = to_dev([plan.kv_idx, plan.tok_lo, plan.tok_hi, plan.blk_lo,
                       plan.blk_hi], dev)
        return plan, (q, *pools, 0, *arrs, scale, *scales)
    elif layout == "paged":
        arrs = to_dev([plan.seg_src, plan.seg_off, plan.seg_live, plan.blk_live], dev)
        tail = (scale, plan.seg_len)
    else:
        arrs = to_dev([plan.paths, plan.seq_lens], dev)
        return plan, (q, *pools, 0, *arrs, scale, *scales)
    if kv == "int8":
        return plan, (q, *pools, *scales, 0, *arrs, *tail)
    return plan, (q, *pools, 0, *arrs, *tail)


def prefill_case(N, Hq, Hkv, D, dtype, dev, gen):
    import torch

    q = torch.randn((N, Hq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((N, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((N, Hkv, D), generator=gen, device=dev).to(dtype)
    return (q, k, v, D ** -0.5)


def ragged_case(lens, Hq, Hkv, D, dtype, dev, gen, pad=0):
    """B8's inputs: prompts of `lens` tokens joined, then `pad` pad tokens
    (seg -1); returns (args, live-row mask)."""
    import torch

    N = sum(lens) + pad
    q, k, v = (torch.randn((N, h, D), generator=gen, device=dev).to(dtype)
               for h in (Hq, Hkv, Hkv))
    seg = torch.full((N,), -1, dtype=torch.int32, device=dev)
    o = 0
    for i, n in enumerate(lens):
        seg[o:o + n] = i
        o += n
    return (q, k, v, seg, D ** -0.5), seg >= 0


def int8mm_case(R, H, I, dtype, dev, gen, w=None, s=None):
    """B9's inputs: x (R, H) N(0, 1), int8 codes in [-127, 127] and scales in
    [0.01, 0.1) (deft_tpu tests/test_kernels.py:651-660)."""
    import torch

    x = torch.randn((R, H), generator=gen, device=dev).to(dtype)
    if w is None:
        w = torch.randint(-127, 128, (H, I), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((I,), generator=gen, device=dev) * 0.09 + 0.01
    return (x, w, s)


def path_shapes(dev):
    """Kernel inputs at each path's shapes, Llama-3.1-8B heads (Hq 32, Hkv 8,
    D 128), bf16 q, block_len 256, width 50: B1/B2 (bf16 pools) and B4/B5
    (int8 pools) on the 4000-token prompt's tree halfway through its 64
    tokens; B6 (bf16 and int8 pools) on the CLI's 16-token prompt's tree
    halfway through, B7 at its fifth step, where their plans come out not
    segment-aligned; prefill of the 4000-token prompt; B8 over the batch
    path's four prompts; B9 at R = 64 (one width-50 tree) and 256 (the batch
    path's 200 leaves) for each of the 8B matmul weights.
    name -> [(label, plan, args)]."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    main = grow_tree(PROMPT_LEN, WIDTH, GEN_LEN // 2, 16384, np.random.default_rng(SEED))
    bf16 = torch.bfloat16
    out = {"prefill": [("", None, prefill_case(PROMPT_LEN, 32, 8, 128, bf16, dev, gen))]}
    for name in ("paged_flatten", "paged_seq", "paged_flatten_q", "paged_seq_q"):
        out[name] = [("", *kernel_case(name, main, 4, 8, 128, bf16, dev, gen, 256))]
    for name, steps in (("flatten_gather", GEN_LEN // 2), ("seq_gather", 4)):
        short = grow_tree(16, WIDTH, steps, 16384, np.random.default_rng(SEED))
        out[name] = [(kv, *kernel_case(name, short, 4, 8, 128, bf16, dev, gen, 256,
                                       kv=kv, as_built=True))
                     for kv in ("inherit", "int8")]
    out["ragged_prefill"] = [("", None, ragged_case(BATCH_LENS, 32, 8, 128, bf16, dev,
                                                    gen)[0])]
    out["int8_matmul"] = []
    for name, (H, I) in INT8_SHAPES.items():
        w = s = None
        for R in (64, 256):
            args = int8mm_case(R, H, I, bf16, dev, gen, w, s)
            w, s = args[1], args[2]
            out["int8_matmul"].append((f"R={R} {name}", None, args))
    return out


# -- phases -----------------------------------------------------------------------

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    print(f"[card] nvidia-smi: {smi[0]}; torch: {name}; "
          f"devices: {torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return smi[0], name


def phase_build():
    from deft_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"[build] {len(_cuda.SOURCES)} kernel sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in sorted(_cuda.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(dev, shapes):
    """Kernel vs plain at each path's shapes and on the small fp32 trees.
    Returns {kernel: max_abs_err at its path's shapes}."""
    import torch

    fns = wrappers()

    def live(plan):
        return slice(0, plan.n_leaves) if plan is not None else slice(None)

    def compare(name, label, args, tol, rows=slice(None)):
        fn, plain = fns[name]
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        e = rel_err(got[rows], want[rows])
        print(f"[kernels] {name} {label}: rel err {e:.3e}, tol {tol:.0e}", flush=True)
        check(e < tol and bool(torch.isfinite(got[rows]).all()),
              f"{name} {label} disagrees with its plain version: {e}")
        if isinstance(rows, torch.Tensor):  # B8's pad rows give 0
            check(not bool(got[~rows].any()), f"{name} {label}: pad rows are not 0")
        return float((got[rows].double() - want[rows].double()).abs().max())

    errs = {}
    for name, cases in shapes.items():
        for label, plan, args in cases:
            e = compare(name, f"bf16 path shapes {label}", args, TOL["bfloat16"],
                        live(plan))
            errs[name] = max(errs.get(name, 0.0), e)

    # small fp32 trees with every plan feature, both head dims
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    a, b, c = small_trees(np.random.default_rng(SEED + 1))
    f32 = torch.float32
    for D in (64, 128):
        for block_len in (128, 256):
            for tree, label in ((a, "FULL/dead/few-leaf tree"), (b, "unaligned tree")):
                for name in ("paged_flatten", "paged_flatten_q", "flatten_gather"):
                    for kv in (("inherit", "int8") if name == "flatten_gather"
                               else (None,)):
                        plan, args = kernel_case(name, tree, 4, 2, D, f32, dev, gen,
                                                 block_len, kv=kv)
                        if tree is a and block_len == 128:
                            full = plan.blk_lo < -(1 << 20)
                            dead = (plan.blk_lo >= plan.blk_hi) & ~full
                            narrow = ~full & ~dead & (plan.blk_hi - plan.blk_lo
                                                      < plan.n_leaves)
                            # the gather layout packs the short leaf suffixes
                            # into the prompt's last block: no few-leaf block
                            check(full.any() and dead.any() and (
                                narrow.any() or KERNELS[name][4] == "gather"),
                                  f"{name}: small plan lacks FULL, dead or "
                                  "few-leaf blocks")
                        compare(name, f"fp32 {kv or ''} D={D} block {block_len} "
                                f"{label}", args, TOL["float32"], live(plan))
                for name in ("paged_seq", "paged_seq_q", "seq_gather"):
                    for kv in (("inherit", "int8") if name == "seq_gather"
                               else (None,)):
                        plan, args = kernel_case(name, tree, 4, 2, D, f32, dev, gen,
                                                 block_len, kv=kv)
                        if tree is b and KERNELS[name][4] == "paged":
                            check(bool(plan.seg_off.any()),
                                  f"{name}: plan has no unaligned segment")
                        compare(name, f"fp32 {kv or ''} D={D} block {block_len} "
                                f"{label}", args, TOL["float32"], live(plan))
            # the short prompt's plans as the runner builds them: not paged
            for name in ("flatten_gather", "seq_gather"):
                for kv in ("inherit", "int8"):
                    plan, args = kernel_case(name, c, 4, 2, D, f32, dev, gen,
                                             block_len, kv=kv, as_built=True)
                    compare(name, f"fp32 {kv} D={D} block {block_len} short-prompt "
                            "plan", args, TOL["float32"], live(plan))
        for N in (300, 1000):
            args = prefill_case(N, 8, 2, D, f32, dev, gen)
            compare("prefill", f"fp32 D={D} N={N}", args, TOL["float32"])
        # B8: ragged lengths off the 64-token tiles, a padded tail, long
        # prompts (mask-free interior tiles), GQA and plain multi-head
        for Hq, Hkv in ((8, 2), (2, 2)):
            for lens, pad in (((60, 83, 100), 13), ((500, 300, 200), 24)):
                args, rows = ragged_case(lens, Hq, Hkv, D, f32, dev, gen, pad)
                compare("ragged_prefill", f"fp32 D={D} qpk {Hq // Hkv} lens {lens} "
                        f"pad {pad}", args, TOL["float32"], rows)
    # B9: R = 8, H not a multiple of 512, split and unsplit H, every row tile
    for R, H, I in ((8, 384, 256), (24, 4096, 4096), (64, 640, 384),
                    (16, 256, 128 * 264), (256, 512, 1536)):
        for dt in (f32, torch.bfloat16):
            compare("int8_matmul", f"{'fp32' if dt == f32 else 'bf16'} R={R} H={H} I={I}",
                    int8mm_case(R, H, I, dt, dev, gen),
                    TOL["float32" if dt == f32 else "bfloat16"])
    return errs


def make_runner(cfg, params, dev, kv_dtype="inherit", prompt_len=PROMPT_LEN,
                slots=16384, max_requests=2 * WIDTH):
    from deft_tpu_torch.config import AttentionConfig, EngineConfig
    from deft_tpu_torch.runtime import ModelRunner

    ecfg = EngineConfig(attention=AttentionConfig(block_len=256),
                        kv_pool_slots=slots, max_requests=max_requests,
                        max_context_len=prompt_len + GEN_LEN + 64, kv_dtype=kv_dtype)
    return ModelRunner(cfg, ecfg, device=dev, params=params,
                       topk_k=max(64, WIDTH), retain_full_logits=True)


def generate_both(runner, prompt, tag, count_plans=False):
    """Flatten then seq through tree_generate; checks each run finishes its
    branches and returns {mode: {"pm", "seqs", "paged"}}."""
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.obs import PerfMetrics
    from deft_tpu_torch.runtime import ForwardMode, tree_generate

    out = {}
    build = runner.build_plan
    for mode_name, mode in (("flatten", ForwardMode.TREE_DECODE_FLATTEN),
                            ("seq", ForwardMode.DECODE)):
        paged = []

        def recording_build(m):
            plan = build(m)
            paged.append(plan.paged)
            return plan

        runner.build_plan = recording_build
        before = read_counts()
        try:
            pm = tree_generate(runner, mode, None, prompt,
                               max_seq_len=len(prompt) + GEN_LEN, width=WIDTH,
                               depth=1,
                               branch_controller=Branch_Controller(workloads.simple_tree),
                               perf_metrics=PerfMetrics())
        finally:
            runner.build_plan = build
        seqs = [list(s.token_ids) for s in runner.tree.all_finished_seqs]
        check(len(seqs) == WIDTH and all(len(s) == GEN_LEN - 1 for s in seqs),
              f"{tag} {mode_name}: expected {WIDTH} branches of {GEN_LEN - 1} tokens")
        check(np.isfinite(pm.TPOT) and pm.TPOT > 0, f"{tag} {mode_name}: bad TPOT")
        moved = {k: v - before[k] for k, v in read_counts().items() if v > before[k]}
        out[mode_name] = {"pm": pm, "seqs": seqs, "paged": paged, "launches": moved}
        steps = (f", plans paged at {sum(paged)} of {len(paged)} steps"
                 if count_plans else "")
        print(f"[{tag}] {mode_name}: TTFT {pm.TTFT:.3f} ms, TPOT {pm.TPOT:.4f} ms, "
              f"decode {pm.decode_latency:.1f} ms, e2e {pm.e2e_latency:.1f} ms, "
              f"generated {pm.generated_len}, KV_IO {pm.KV_IO:.4e} B{steps}; "
              f"launches {moved}", flush=True)
    f, s = out["flatten"], out["seq"]
    same = np.mean([a == b for x, y in zip(f["seqs"], s["seqs"]) for a, b in zip(x, y)])
    print(f"[{tag}] kv_io_reduction (seq KV_IO / flatten KV_IO) "
          f"{s['pm'].KV_IO / f['pm'].KV_IO:.4f}; generated ids equal in "
          f"{same:.4f} of positions (bf16 near-ties may flip greedy tokens)",
          flush=True)
    return out


def first_step(runner, prompt, ids):
    """Prefill, branch the root into WIDTH leaves with tokens `ids`, alloc;
    returns the tree for the first decode step."""
    runner.forward_prefill(prompt)
    tree = runner.tree
    for c, child in enumerate(tree.branch(tree.root, WIDTH)):
        child.append_token(int(ids[c]))
    tree.alloc()
    return tree


def phase_main(dev, params, profile: bool = False):
    """Flatten then seq through the public entry points; returns the launch
    counts during that run and the first decode step's flatten logits and
    branch tokens."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    cfg = PRESETS["8b"]
    runner = make_runner(cfg, params, dev)
    rng = np.random.default_rng(SEED)
    prompt = [int(t) for t in rng.integers(4, cfg.vocab_size - 4, PROMPT_LEN)]

    # first decode step in both modes on one tree state: logits must agree
    view = runner.forward_prefill(prompt)
    _, ids = view.topk(0, WIDTH)
    runner.reset_state()
    first_step(runner, prompt, ids)
    lf, ls, readings = logits_controls(runner, WIDTH)
    # the logits leave the lm_head in bf16, so single-ulp flips near the
    # largest logit move the max-abs error in steps of ~0.8%: the check uses
    # the relative L2 error over all rows; the max-abs error is printed beside it
    top1 = float((lf.argmax(-1) == ls.argmax(-1)).float().mean())
    print(f"[main] first decode step, relative L2 error of the logits against "
          f"flatten's: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
          + f" (limit {LOGITS_LIMIT:.0e}); flatten vs seq max-abs error "
          f"{rel_err(lf, ls):.3e} of the largest logit, top-1 agreement "
          f"{top1:.3f}", flush=True)
    check(readings["seq"] < LOGITS_LIMIT,
          f"flatten and seq logits disagree: {readings['seq']}")
    check(readings["flatten+ulp noise"] < LOGITS_LIMIT,
          "one ulp of attention noise moves the logits past the limit: the "
          "check cannot tell bf16 rounding from a fault on this card")
    check(readings["flatten, block dropped"] > LOGITS_LIMIT,
          "a dropped KV block stays under the limit: the check cannot see it")
    runner.reset_state()
    runner.retain_full_logits = False

    reset_counts()
    runs = generate_both(runner, prompt, "main")
    launches = read_counts()
    print(f"[main] launches during the main path: {launches}", flush=True)
    for name in ("prefill", "paged_flatten", "paged_seq"):
        check(launches[name] > 0, f"kernel {name} was never launched on the main path")
    if profile:
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
    del runner
    torch.cuda.empty_cache()
    return launches, prompt, ids, lf, runs


def phase_int8(dev, params, prompt, ids, lf_bf16, profile: bool = False):
    """The main path's workload over an int8 KV cache; B4 and B5 must
    launch, B1 and B2 must not."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    runner = make_runner(PRESETS["8b"], params, dev, kv_dtype="int8")
    check(runner.k_pool.data.dtype == torch.int8 and runner.k_pool.quantized,
          "the int8 runner's pools are not int8")
    first_step(runner, prompt, ids)
    mode = ForwardMode.TREE_DECODE_FLATTEN
    plan = runner.build_plan(mode)
    check(plan.paged, "the int8 first-step flatten plan is not paged")
    view, _ = runner.forward_tree_decode(mode, plan)
    lq = view.full_logits()[:WIDTH].float()
    err = float((lq - lf_bf16).norm() / lf_bf16.norm())
    top1 = float((lq.argmax(-1) == lf_bf16.argmax(-1)).float().mean())
    print(f"[int8] first decode step, int8 KV flatten vs bf16 KV flatten: "
          f"relative L2 error of the logits {err:.3e}, top-1 agreement {top1:.3f}, "
          f"plan seg_len {plan.seg_len}", flush=True)
    check(bool(torch.isfinite(lq).all()), "int8 first-step logits are not finite")
    runner.reset_state()
    runner.retain_full_logits = False

    reset_counts()
    generate_both(runner, prompt, "int8")
    launches = read_counts()
    print(f"[int8] launches during the int8 path: {launches}", flush=True)
    for name in ("paged_flatten_q", "paged_seq_q", "prefill"):
        check(launches[name] > 0, f"kernel {name} was never launched on the int8 path")
    for name in ("paged_flatten", "paged_seq"):
        check(launches[name] == 0, f"kernel {name} ran on the int8 path")
    if profile:
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
    del runner
    torch.cuda.empty_cache()
    return launches


def phase_short(dev, params, profile: bool = False):
    """The CLI's default 16-token prompt, bf16 then int8 KV, flatten then
    seq: B6 must launch in both flatten runs, B7 in the bf16 seq run."""
    import torch
    from deft_tpu_torch.cli.run import make_prompt
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    cfg = PRESETS["8b"]
    prompt = make_prompt(None, 16 + GEN_LEN, cfg.vocab_size, SEED)
    check(len(prompt) == 16, f"the default prompt has {len(prompt)} tokens")
    runs, launches = {}, {}
    for kv in ("inherit", "int8"):
        runner = make_runner(cfg, params, dev, kv_dtype=kv, prompt_len=len(prompt))
        # first decode step, flatten against seq (bf16 pools: both plans
        # gather plans; int8 pools: seq's plan is paged from the start)
        view = runner.forward_prefill(prompt)
        _, ids = view.topk(0, WIDTH)
        runner.reset_state()
        first_step(runner, prompt, ids)
        logits, paged = {}, {}
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            plan = runner.build_plan(mode)
            paged[mode.name] = plan.paged
            check(kv == "int8" or not plan.paged,
                  f"the short prompt's first {mode.name} plan is paged")
            v, _ = runner.forward_tree_decode(mode, plan)
            logits[mode] = v.full_logits()[:WIDTH].float()
        lf, ls = logits.values()
        err = float((ls - lf).norm() / lf.norm())
        print(f"[short {kv}] first decode step (plans paged: {paged}), seq vs flatten: "
              f"relative L2 error of the logits {err:.3e} (limit {LOGITS_LIMIT:.0e}), "
              f"top-1 agreement {float((lf.argmax(-1) == ls.argmax(-1)).float().mean()):.3f}",
              flush=True)
        # the main path's limit: its controls put bf16 noise well below it
        check(err < LOGITS_LIMIT, f"short {kv}: flatten and seq logits disagree: {err}")
        runner.reset_state()
        runner.retain_full_logits = False
        reset_counts()
        runs[kv] = generate_both(runner, prompt, f"short {kv}", count_plans=True)
        for k, n in read_counts().items():
            launches[k] = launches.get(k, 0) + n
        del runner
        torch.cuda.empty_cache()
    print(f"[short] launches during the short-prompt path (bf16 and int8 runs): "
          f"{launches}", flush=True)
    if profile:  # bf16 KV: the first 8 steps take gather plans
        runner = make_runner(cfg, params, dev, prompt_len=len(prompt))
        runner.retain_full_logits = False
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
        del runner
        torch.cuda.empty_cache()
    for kv in ("inherit", "int8"):
        check(runs[kv]["flatten"]["launches"].get("flatten_gather", 0) > 0,
              f"flatten_gather was never launched in the {kv} short flatten run")
    check(runs["inherit"]["seq"]["launches"].get("seq_gather", 0) > 0,
          "seq_gather was never launched in the bf16 short seq run")
    return launches


def phase_batch(dev, params, profile: bool = False):
    """Four requests with distinct prompts (BATCH_LENS), each a width-50
    Simple_Tree: each alone, then all four through one ragged prefill (B8)
    and one multi-tree step on the same branch tokens, held against the
    alone runs; then BatchedEngine.add_requests + run() in flatten and in
    seq.  Returns the launch counts of the two engine runs, summed."""
    import torch
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.core import TreeCache
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.obs import PerfMetrics
    from deft_tpu_torch.runtime import ForwardMode, tree_generate
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request

    cfg = PRESETS["8b"]
    rng = np.random.default_rng(SEED + 3)
    prompts = [[int(t) for t in rng.integers(4, cfg.vocab_size - 4, n)]
               for n in BATCH_LENS]
    runner = make_runner(cfg, params, dev, prompt_len=max(BATCH_LENS),
                         slots=BATCH_SLOTS, max_requests=4 * (WIDTH + 2))
    flatten = ForwardMode.TREE_DECODE_FLATTEN

    # each request alone: its prefill (B3) and its first decode step
    alone = []
    for p in prompts:
        runner.reset_state()
        view = runner.forward_prefill(p)
        _, ids = view.topk(0, WIDTH)
        tree = runner.tree
        for c, child in enumerate(tree.branch(tree.root, WIDTH)):
            child.append_token(int(ids[c]))
        tree.alloc()
        v, _ = runner.forward_tree_decode(flatten, runner.build_plan(flatten))
        alone.append((view.full_logits()[0].float(), ids, v.full_logits()[:WIDTH].float()))
    runner.reset_state()

    # the four in one ragged prefill, then one multi-tree step whose leaves
    # carry the alone runs' branch tokens
    trees = [TreeCache(runner.token_to_kv_pool, runner.req_to_token_pool)
             for _ in prompts]
    reset_counts()
    view = runner.forward_prefill_batch(prompts, trees)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["ragged_prefill"] == cfg.num_layers and counts["prefill"] == 0,
          f"one ragged prefill launched {counts}")
    for t, (_, ids, _) in zip(trees, alone):
        for c, child in enumerate(t.branch(t.root, WIDTH)):
            child.append_token(int(ids[c]))
        t.alloc()
    eng = BatchedEngine(runner, flatten)
    plan = eng.build_plan(trees)
    v, _ = runner.forward_tree_decode(flatten, plan)
    step_logits = v.full_logits().float()
    for i, (lp, _, lf) in enumerate(alone):
        lb = step_logits[plan.leaf_offsets[i]:plan.leaf_offsets[i] + WIDTH]
        e_pre = rel_l2(view.full_logits()[i].float(), lp)
        e_dec = rel_l2(lb, lf)
        top1 = float((lb.argmax(-1) == lf.argmax(-1)).float().mean())
        print(f"[batch] request {i} (prompt {BATCH_LENS[i]}): relative L2 against "
              f"alone, ragged prefill (B8) vs prefill (B3) {e_pre:.3e}, first "
              f"multi-tree step (plan paged={plan.paged}) vs alone {e_dec:.3e} "
              f"(limit {LOGITS_LIMIT:.0e}); top-1 agreement {top1:.3f}, "
              f"prefill top-1 {int(view.ids[i, 0]) == int(lp.argmax())}", flush=True)
        check(e_pre < LOGITS_LIMIT, f"request {i}: ragged prefill logits {e_pre}")
        check(e_dec < LOGITS_LIMIT, f"request {i}: first batched step logits {e_dec}")
    for t in trees:
        t.free()
    runner.reset_state()
    runner.retain_full_logits = False

    launches, out = {}, {}
    for mode_name, mode in (("flatten", flatten), ("seq", ForwardMode.DECODE)):
        # a fresh pool for each mode: the slots the previous run's requests
        # freed come back scattered, and prompts laid on them are not
        # segment-aligned, which sends every step to the gather kernels
        runner.reset_state()
        eng = BatchedEngine(runner, mode)
        plans = []

        def recording_build(trees, build=eng.build_plan):
            plans.append(build(trees))
            return plans[-1]

        eng.build_plan = recording_build
        reqs = [Request(p, Branch_Controller(workloads.simple_tree), len(p) + GEN_LEN,
                        width=WIDTH, depth=1) for p in prompts]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.add_requests(reqs)
        torch.cuda.synchronize()
        t_adm = time.perf_counter() - t0
        steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        seqs = [[list(s.token_ids) for s in r.finished_seqs] for r in reqs]
        check(all(len(b) == WIDTH and all(len(x) == GEN_LEN - 1 for x in b) for b in seqs),
              f"batch {mode_name}: expected {WIDTH} branches of {GEN_LEN - 1} tokens "
              "per request")
        tok = sum(len(x) for b in seqs for x in b)
        paged = sum(p.paged for p in plans)
        kv = sum(p.n_tokens if mode_name == "flatten" else p.total_kv for p in plans)
        moved = {k: n for k, n in counts.items() if n}
        print(f"[batch] {mode_name}: admission (one ragged prefill of "
              f"{sum(BATCH_LENS)} tokens + root branching) {t_adm * 1e3:.3f} ms, "
              f"{steps} steps, {tok} generated tokens in {wall * 1e3:.1f} ms, "
              f"{wall * 1e3 / tok:.4f} ms/token aggregate; plans paged at {paged} "
              f"of {len(plans)} steps (gather at {len(plans) - paged}); "
              f"launches {moved}", flush=True)
        check(counts["ragged_prefill"] == cfg.num_layers,
              f"batch {mode_name}: B8 launched {counts['ragged_prefill']} times, "
              f"not once a layer")
        check(counts["prefill"] == 0, f"batch {mode_name}: B3 ran on the batch path")
        pair = (("paged_flatten", "flatten_gather") if mode_name == "flatten"
                else ("paged_seq", "seq_gather"))
        check(counts[pair[0]] + counts[pair[1]] > 0,
              f"batch {mode_name}: neither {pair[0]} nor {pair[1]} launched")
        out[mode_name] = (seqs, kv)
    print(f"[batch] kv_io_reduction (seq KV tokens read / flatten's, over the "
          f"run's plans) {out['seq'][1] / out['flatten'][1]:.4f}", flush=True)

    # greedy ids of the flatten engine against each request alone, printed
    # and not held: the batched step's matmuls run at 256 rows, not 64, so
    # cuBLAS rounds every layer differently, and bf16 near-ties flip tokens
    # (PERF.md).  Branches are matched by sorting: a near-tie in the
    # prefill's top-50 reorders the root's children, so the i-th branch of
    # one run need not start with the i-th branch's token of the other
    same, whole = [], 0
    for p, got in zip(prompts, out["flatten"][0]):
        runner.reset_state()
        tree_generate(runner, flatten, None, p, max_seq_len=len(p) + GEN_LEN,
                      width=WIDTH, depth=1,
                      branch_controller=Branch_Controller(workloads.simple_tree),
                      perf_metrics=PerfMetrics())
        want = [list(s.token_ids) for s in runner.tree.all_finished_seqs]
        same += [a == b for x, y in zip(sorted(got), sorted(want)) for a, b in zip(x, y)]
        whole += sum(x in want for x in got)
    print(f"[batch] flatten engine vs each request alone: greedy ids equal at "
          f"{np.mean(same):.4f} of positions (branches sorted), {whole} of "
          f"{len(prompts) * WIDTH} branches identical", flush=True)
    print(f"[batch] launches during the batch path (both engine runs): {launches}",
          flush=True)
    if profile:
        profile_batch(runner, prompts, WIDTH, steps=8)
    del runner
    torch.cuda.empty_cache()
    return launches


def phase_int8w(dev, prompt, ids, main_runs):
    """The main path's workload over int8 weights made on the card
    (weight_dtype "int8-pallas"): B9 launches 129 times a decode step, and
    the first step agrees with the same codes and scales under "int8"."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params
    from deft_tpu_torch.runtime import ForwardMode

    cfg = PRESETS["8b"]
    per_step = 4 * cfg.num_layers + 1
    t0 = time.perf_counter()
    params = random_params(cfg, SEED, dev, torch.bfloat16, "int8-pallas")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
    print(f"[int8w] 8b int8-pallas weights ({gb:.2f} GB, int8 codes + fp32 scales, "
          f"bf16 embed and norms) made on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the same codes and scales, routed to the plain expression
    expr = {(k[:-3] + "_s" if k.endswith("_sp") else k): t for k, t in params.items()}
    runner = make_runner(cfg, params, dev)
    check(runner.params["wqkv"].dtype == torch.int8 and "wqkv_sp" in runner.params,
          "the int8w runner's weights are not int8-pallas")
    first_step(runner, prompt, ids)
    flatten = ForwardMode.TREE_DECODE_FLATTEN
    plan = runner.build_plan(flatten)
    logits, n_b9 = {}, {}
    for name, p in (("int8-pallas", params), ("int8", expr)):
        runner.params = p
        reset_counts()
        v, _ = runner.forward_tree_decode(flatten, plan)
        n_b9[name] = read_counts()["int8_matmul"]
        logits[name] = v.full_logits()[:WIDTH].float()
    runner.params = params
    err = rel_l2(logits["int8-pallas"], logits["int8"])
    top1 = float((logits["int8-pallas"].argmax(-1) == logits["int8"].argmax(-1))
                 .float().mean())
    print(f"[int8w] first decode step, B9 ({n_b9['int8-pallas']} launches) vs the "
          f"plain expression ({n_b9['int8']} launches) on the same codes: relative "
          f"L2 of the logits {err:.3e} (limit {LOGITS_LIMIT:.0e}), top-1 agreement "
          f"{top1:.3f}", flush=True)
    check(n_b9["int8-pallas"] == per_step and n_b9["int8"] == 0,
          f"B9 launches in one decode step: {n_b9}, expected {per_step} and 0")
    check(err < LOGITS_LIMIT, f"int8-pallas and int8 logits disagree: {err}")
    check(bool(torch.isfinite(logits["int8-pallas"]).all()), "int8w logits not finite")
    runner.reset_state()
    runner.retain_full_logits = False

    reset_counts()
    runs = generate_both(runner, prompt, "int8w")
    launches = read_counts()
    for mode_name, r in runs.items():
        n, steps = r["launches"].get("int8_matmul", 0), len(r["paged"])
        check(n == per_step * steps,
              f"int8w {mode_name}: B9 launched {n} times in {steps} decode steps, "
              f"not {per_step} a step")
        m = main_runs[mode_name]["pm"]
        print(f"[int8w] {mode_name}: {n} B9 launches over {steps} decode steps; TTFT "
              f"{r['pm'].TTFT:.3f} ms, TPOT {r['pm'].TPOT:.4f} ms against bf16 "
              f"weights' {m.TTFT:.3f} / {m.TPOT:.4f} ms (main path, this run)",
              flush=True)
    print(f"[int8w] launches during the int8-weight path: {launches}", flush=True)
    del runner, params, expr
    torch.cuda.empty_cache()
    return launches


def logits_controls(runner, width):
    """The first decode step on the runner's current tree, run in flatten
    mode, in seq mode and under three controls; returns flatten's and seq's
    (width, V) logits and each run's relative L2 error against flatten's.
    Controls: flatten again (the noise of a rerun), flatten with each
    nonzero element of every layer's attention output moved by -1, 0 or +1
    ulp at random (bf16 rounding noise), and two planted faults: one plan
    block of the shared prompt hidden from every leaf (what a split-KV
    merge that lost a span does, at the grain of one block), and each
    leaf's own newest token hidden from it (a mask off by one).  Each step
    rewrites the new tokens' KV before any layer reads it, so the runs do
    not disturb one another."""
    import contextlib
    from types import SimpleNamespace
    from unittest import mock

    import torch
    from deft_tpu_torch.ops import attn_impls
    from deft_tpu_torch.runtime import ForwardMode

    gen = torch.Generator(device=runner.device)
    gen.manual_seed(SEED + 2)

    def ulp_noise(*args):
        o = attn_impls.flatten_attn(*args)
        step = torch.randint(-1, 2, o.shape, generator=gen, device=o.device,
                             dtype=torch.int16)
        return (o.view(torch.int16) + step * (o != 0)).view(o.dtype)

    def with_plan(edit):
        def attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
            b = SimpleNamespace(**vars(batch))
            edit(b)
            return attn_impls.flatten_attn(q, k_new, v_new, k_pool, v_pool, li,
                                           b, scale)
        return attn

    def drop_block(b):  # the middle one of the FULL (prompt-only) blocks
        full = (b.blk_lo < -(1 << 20)).nonzero().flatten()
        check(len(full) > 0, "the flatten plan has no FULL block")
        b.blk_lo, b.blk_hi = b.blk_lo.clone(), b.blk_hi.clone()
        b.blk_lo[full[len(full) // 2]] = b.blk_hi[full[len(full) // 2]] = 0

    def hide_own_token(b):  # the tokens exactly one leaf sees: each leaf's own
        own = b.tok_hi - b.tok_lo == 1
        check(int(own.sum()) == width, "expected one own token per leaf")
        b.tok_hi = torch.where(own, b.tok_lo, b.tok_hi)

    flatten = ForwardMode.TREE_DECODE_FLATTEN
    plans = {m: runner.build_plan(m) for m in (flatten, ForwardMode.DECODE)}
    check(all(p.paged for p in plans.values()), "the first step's plans are not paged")
    runs = (("flatten", flatten, None), ("seq", ForwardMode.DECODE, None),
            ("flatten again", flatten, None),
            ("flatten+ulp noise", flatten, ulp_noise),
            ("flatten, block dropped", flatten, with_plan(drop_block)),
            ("flatten, own token hidden", flatten, with_plan(hide_own_token)))
    logits = {}
    for name, mode, attn in runs:
        with (mock.patch.object(runner, "_attn_fn", lambda m, paged, a=attn: a)
              if attn is not None else contextlib.nullcontext()):
            v, _ = runner.forward_tree_decode(mode, plans[mode])
        logits[name] = v.full_logits()[:width].float()
    lf = logits["flatten"]
    readings = {name: float((x - lf).norm() / lf.norm())
                for name, x in logits.items() if name != "flatten"}
    return lf, logits["seq"], readings


RANGES = ("build_plan", "forward", "kv_store")


def profile_decode(runner, mode, prompt, width, steps):
    """torch.profiler over `steps` greedy decode steps of a fresh tree (see
    profile_steps)."""
    import torch
    from torch.profiler import record_function

    runner.reset_state()
    view = runner.forward_prefill(prompt)
    tree = runner.tree
    _, ids = view.topk(0, width)
    for c, child in enumerate(tree.branch(tree.root, width)):
        child.append_token(int(ids[c]))
    torch.cuda.synchronize()

    def step():
        tree.alloc()
        with record_function("build_plan"):
            plan = runner.build_plan(mode)
        with record_function("forward"):
            v, _ = runner.forward_tree_decode(mode, plan, logits_kind="greedy")
        nxt, _ = v.argmax()
        for leaf in tree.leaves.values():
            leaf.append_token(int(nxt[tree.leaf_to_q[leaf.id]]))

    kv = "int8" if runner.k_pool.quantized else "bf16"
    profile_steps(f"{mode.name}, prompt {len(prompt)}, {kv} KV", step, steps)
    runner.reset_state()


def profile_batch(runner, prompts, width, steps):
    """torch.profiler over `steps` BatchedEngine flatten steps right after
    the requests' admission (see profile_steps)."""
    from unittest import mock

    import torch
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime import ForwardMode
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request
    from torch.profiler import record_function

    runner.reset_state()
    eng = BatchedEngine(runner, ForwardMode.TREE_DECODE_FLATTEN)
    eng.add_requests([Request(p, Branch_Controller(workloads.simple_tree),
                              len(p) + GEN_LEN, width=width, depth=1) for p in prompts])
    torch.cuda.synchronize()
    build, forward = eng.build_plan, runner.forward_tree_decode

    def marked_build(trees):
        with record_function("build_plan"):
            return build(trees)

    def marked_forward(*a, **k):
        with record_function("forward"):
            return forward(*a, **k)

    with (mock.patch.object(eng, "build_plan", marked_build),
          mock.patch.object(runner, "forward_tree_decode", marked_forward)):
        profile_steps(f"batched TREE_DECODE_FLATTEN, {len(prompts)} requests "
                      f"(prompts {'/'.join(str(len(p)) for p in prompts)}), bf16 KV",
                      eng.step, steps)
    for req in eng.active:
        req.tree.free()
    runner.reset_state()


def profile_steps(label, step, steps):
    """torch.profiler over `steps` calls of step(): device time by kernel,
    the device's busy share of the wall time, and the host and device time
    of each step's plan building, its forward and the model's kv_store calls
    within it (RANGES, marked with record_function while the profiler
    runs)."""
    from unittest import mock

    from deft_tpu_torch.models import llama
    from torch.profiler import ProfilerActivity, profile, record_function

    store = llama.kv_store

    def marked_store(*a):
        with record_function("kv_store"):
            store(*a)

    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof,
          mock.patch.object(llama, "kv_store", marked_store)):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    def dev_total_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)

    avgs = prof.key_averages()
    # kernel entries only (CPU-op entries also carry their kernels' time; a
    # range's device-side copy spans its kernels)
    evs = [e for e in avgs
           if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0
           and e.key not in RANGES]
    busy_ms = sum(dev_us(e) for e in evs) / 1e3
    print(f"[profile] {label}: {steps} steps, "
          f"wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy_ms / steps:.3f} ms/step "
          f"({busy_ms / wall_ms:.1%}; idle {1 - busy_ms / wall_ms:.1%})", flush=True)
    for key in RANGES:
        st = [e for e in avgs if e.key == key
              and str(getattr(e, "device_type", "")).endswith("CPU")]
        if not st:
            print(f"[profile]   {key}: no range recorded (not measured)", flush=True)
            continue
        host_ms, dev_ms = st[0].cpu_time_total / 1e3, dev_total_us(st[0]) / 1e3
        print(f"[profile]   {key}: {st[0].count // steps}/step, host "
              f"{host_ms / steps:.3f} ms/step ({host_ms / wall_ms:.1%} of wall), "
              f"device {dev_ms / steps:.3f} ms/step ({dev_ms / max(busy_ms, 1e-9):.1%} "
              f"of busy)", flush=True)
    for e in sorted(evs, key=dev_us, reverse=True)[:12]:
        print(f"[profile]   {dev_us(e) / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d}/step  {e.key[:90]}")


def profile_kv_store(dev, reps: int = 20):
    """One decode step's kv_store calls (K and V of 32 layers, WIDTH new
    tokens, 8 KV heads of 128) into bf16 and int8 pools, without the
    profiler: host ms a step (host clock, synchronised at the end of each
    step) and device ms a step (CUDA events); then the int8 store's torch
    ops by host time under torch.profiler."""
    import torch
    from deft_tpu_torch.models.llama import KVPool, kv_store
    from torch.profiler import ProfilerActivity, profile

    L, S, Hkv, D = 32, 16384, 8, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn((WIDTH, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    loc = torch.randperm(S, generator=gen, device=dev)[:WIDTH]

    def step(pools):
        for li in range(L):
            for p in pools:
                kv_store(p, li, loc, x)

    for kv in ("bf16", "int8"):
        if kv == "int8":
            pools = [KVPool(torch.zeros((L, S, Hkv * D), dtype=torch.int8, device=dev),
                            torch.ones((L, Hkv, S), device=dev)) for _ in range(2)]
        else:
            pools = [KVPool(torch.zeros((L, S, Hkv * D), dtype=torch.bfloat16,
                                        device=dev)) for _ in range(2)]
        step(pools)
        torch.cuda.synchronize()
        host, devs = [], []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            step(pools)
            b.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            devs.append(a.elapsed_time(b))
        print(f"[profile] kv_store, {kv} pools, one step ({2 * L} calls of "
              f"{WIDTH} tokens), no profiler: host {np.mean(host):.3f} ms/step "
              f"(median {np.median(host):.3f}), device span {np.mean(devs):.3f} "
              f"ms/step", flush=True)
        if kv == "int8":
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                step(pools)
                torch.cuda.synchronize()
            ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                         reverse=True)
            for e in ops[:10]:
                print(f"[profile]   {e.self_cpu_time_total / 1e3:8.3f} ms/step "
                      f"{e.count:5d}/step  {e.key[:60]}")
        del pools
    torch.cuda.empty_cache()


# ~1 ms of sleep kernel at the H100's 1.98 GHz boost clock: longer than any
# timed call's host work apart from the plain versions'
PRIME_CYCLES = 2_000_000


def time_ms(fn, reps: int, flush, primed: bool = True) -> float:
    """Mean CUDA-event time of fn() over reps launches, L2 flushed before
    each (the decode step's weight streaming leaves the cache cold).
    primed: a sleep kernel ahead of each launch keeps the device busy while
    the host runs the wrapper (argument checks, allocations, the ctypes
    call), so the events time the device work alone; unprimed, the device
    waits for the host between the events, and a call shorter than its
    wrapper's host time reads as the host time."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        if primed:
            torch.cuda._sleep(PRIME_CYCLES)
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in zip(starts, ends)]))


# name -> the library call timed beside a kernel, as found on this card
LIBRARY = {}


def ragged_timing_row(fns, shapes, bound):
    """B8 at the batch path's shapes: kernel, plain and library callables,
    bound.  Library: torch.nn.attention.varlen's varlen_attn where the
    installed torch has it and it agrees with the plain version, else
    scaled_dot_product_attention with the block-diagonal causal mask as a
    boolean attn_mask."""
    import torch
    import torch.nn.functional as F

    q, k, v, seg, scale = shapes["ragged_prefill"][0][2]
    N, Hq, D = q.shape
    qpk = Hq // k.shape[1]
    want = fns["ragged_prefill"][1](q, k, v, seg, scale)
    cu = torch.tensor(np.cumsum((0,) + BATCH_LENS), dtype=torch.int32, device=q.device)
    lib = None
    try:
        from torch.nn.attention.varlen import varlen_attn

        params = inspect.signature(varlen_attn).parameters
        kw = {"scale": scale} if "scale" in params else {}
        kw.update({"is_causal": True} if "is_causal" in params
                  else {"window_size": (-1, 0)})
        kk, vv = k, v
        if "enable_gqa" in params:
            kw["enable_gqa"] = True
        else:
            kk, vv = (x.repeat_interleave(qpk, dim=1) for x in (k, v))
        L = max(BATCH_LENS)

        def lib():
            return varlen_attn(q, kk, vv, cu, cu, L, L, **kw)

        e = rel_err(lib(), want)
        print(f"[timing] ragged_prefill library: varlen_attn({', '.join(kw)}) vs "
              f"plain rel err {e:.3e}", flush=True)
        check(e < TOL["bfloat16"], "varlen_attn disagrees")
        LIBRARY["ragged_prefill"] = "torch.nn.attention.varlen.varlen_attn"
    except (ImportError, TypeError, RuntimeError, Failure) as err:
        print(f"[timing] ragged_prefill library: varlen_attn not usable here "
              f"({type(err).__name__}: {str(err)[:120]}); SDPA with a boolean "
              "block-diagonal causal mask instead", flush=True)
        pos = torch.arange(N, device=q.device)
        mask = (seg[:, None] == seg[None, :]) & (pos[:, None] >= pos[None, :])
        qt = q.transpose(0, 1)[None]
        kt, vt = (x.repeat_interleave(qpk, dim=1).transpose(0, 1)[None] for x in (k, v))

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)

        LIBRARY["ragged_prefill"] = "SDPA, boolean block-diagonal causal attn_mask"
    pairs = sum(n * (n + 1) // 2 for n in BATCH_LENS)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + 4 * N
    kern, plain = fns["ragged_prefill"]
    return (lambda: kern(q, k, v, seg, scale), lambda: plain(q, k, v, seg, scale), lib,
            *bound(nbytes, 2 * 2 * Hq * D * pairs))


def int8mm_timing_row(fns, shapes, bound, flush):
    """B9 as one decode step's layer sees it: the five 8B matmul weights in
    turn (wqkv, wo, wgu, wdown, then lm_head) at R = 64, as one timed
    function.  Library: torch._weight_int8pack_mm where the card's torch has
    a CUDA kernel for it, else cuBLAS x @ w with the weight dequantised to
    bf16 ahead of time.  Each shape at R = 64 and 256 is also timed alone
    (printed), beside cuBLAS on the dequantised bf16 weight, which reads
    twice B9's weight bytes."""
    import torch

    kern, plain = fns["int8_matmul"]
    cases = {label: args for label, _, args in shapes["int8_matmul"]}
    deq = {}  # R = 64 and 256 share each weight
    for x, w, s in cases.values():
        if id(w) not in deq:
            deq[id(w)] = (w.float() * s).to(x.dtype)
    if torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm",
                                                      "CUDA"):
        prep = {label: (x, w.t().contiguous(), s.to(x.dtype))
                for label, (x, w, s) in cases.items()}

        def lib_call(x, wt, sb):
            return torch._weight_int8pack_mm(x, wt, sb)

        LIBRARY["int8_matmul"] = "torch._weight_int8pack_mm"
    else:
        prep = {label: (x, deq[id(w)], None) for label, (x, w, s) in cases.items()}

        def lib_call(x, wd, _):
            return x @ wd

        LIBRARY["int8_matmul"] = "cuBLAS x @ w, w dequantised to bf16 ahead of time"

    def cost(x, w, s):
        R, H = x.shape
        I = w.shape[1]
        return (H * I + 2 * R * H + 4 * I + 2 * R * I), 2 * R * H * I

    for label, args in cases.items():
        nb, fl = cost(*args)
        b_ms, b_by = bound(nb, fl)
        ms = time_ms(lambda a=args: kern(*a), 20, flush)
        host_ms = time_ms(lambda a=args: kern(*a), 20, flush, primed=False)
        lib_ms = time_ms(lambda a=prep[label]: lib_call(*a), 20, flush)
        bf16_ms = time_ms(lambda x=args[0], wd=deq[id(args[1])]: x @ wd, 20, flush)
        print(f"[timing] int8_matmul {label} (H, I) = {tuple(args[1].shape)}: kernel "
              f"{ms:.4f} ms ({host_ms:.4f} ms unprimed), library {lib_ms:.4f} ms, "
              f"cuBLAS on the bf16 weight "
              f"{bf16_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.1%} of the bound", flush=True)
    step = [cases[f"R=64 {n}"] for n in INT8_SHAPES]
    step_lib = [prep[f"R=64 {n}"] for n in INT8_SHAPES]
    nb, fl = (sum(c) for c in zip(*(cost(*a) for a in step)))
    return (lambda: [kern(*a) for a in step], lambda: [plain(*a) for a in step],
            lambda: [lib_call(*a) for a in step_lib], *bound(nb, fl))


def phase_timing(dev, shapes):
    """Per kernel at its path's shapes (the bf16-pool case of B6 and B7; B9:
    one layer's four matmuls and lm_head at R = 64): kernel, plain and
    (prefill, B8, B9) library times, the least time the card could take and
    what bounds it."""
    import torch
    import torch.nn.functional as F

    fns = wrappers()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def bound(nbytes, flops):
        tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    def plan_bytes(args):
        return sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor) and a.dtype == torch.int32)

    def kv_token_bytes(args, Hkv, D):
        """K and V bytes of one token: int8 codes plus fp32 (token, head)
        scales, or two rows of the pool's dtype."""
        pool = args[1]
        if pool.dtype == torch.int8:
            return Hkv * (2 * D + 8)
        return Hkv * D * 2 * pool.element_size()

    rows = {}
    for name, cases in shapes.items():
        if KERNELS[name][2] is None:  # prefill, B8, B9: below
            continue
        _, plan, args = cases[0]
        q = args[0]
        R, Hq, D = q.shape
        Hkv = args[1].shape[-1] // D
        qpk = Hq // Hkv
        io = 2 * q.numel() * q.element_size()
        if KERNELS[name][2] == "flatten":
            # live KV read once, q and the plan read, o written; FLOPs over
            # the (row, token) pairs the plan's intervals make visible
            lo, hi = plan.tok_lo.astype(np.int64), plan.tok_hi.astype(np.int64)
            live = hi > lo
            pairs = int((hi[live] - lo[live]).sum()) * qpk * Hkv
            nbytes = plan.n_tokens * kv_token_bytes(args, Hkv, D) + io + plan_bytes(args)
        else:
            # each leaf's path read once per leaf (the baseline's own work)
            pairs = plan.total_kv * qpk * Hkv
            nbytes = plan.total_kv * kv_token_bytes(args, Hkv, D) + io
            if KERNELS[name][4] == "gather":  # the live entries of paths
                nbytes += 4 * plan.total_kv + 4 * R
            else:
                nbytes += plan_bytes(args)
        fn, plain = fns[name]
        rows[name] = (lambda f=fn, a=args: f(*a), lambda p=plain, a=args: p(*a), None,
                      *bound(nbytes, pairs * 4 * D))
    # prefill: causal FLOPs 2 * 2 * Hq * N^2 * D / 2
    q, k, v, scale = shapes["prefill"][0][2]
    N, Hq, D = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    # SDPA takes (batch, heads, N, D) with every query head's K/V spelled out
    qt = q.transpose(0, 1).contiguous()[None]
    kt, vt = (x.repeat_interleave(Hq // x.shape[1], dim=1).transpose(0, 1)
              .contiguous()[None] for x in (k, v))
    fn, plain = fns["prefill"]
    LIBRARY["prefill"] = "SDPA is_causal, K/V repeated to the query heads"
    rows["prefill"] = (lambda f=fn: f(q, k, v, scale),
                       lambda p=plain: p(q, k, v, scale),
                       lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=True, scale=scale),
                       *bound(nbytes, 2 * 2 * Hq * N * N * D / 2))

    rows["ragged_prefill"] = ragged_timing_row(fns, shapes, bound)
    rows["int8_matmul"] = int8mm_timing_row(fns, shapes, bound, flush)

    out = {}
    for name, (kern, plain_fn, lib, bound_ms, bound_by) in rows.items():
        ms = time_ms(kern, 20, flush)
        host_ms = time_ms(kern, 20, flush, primed=False)
        plain_ms = time_ms(plain_fn, 3, flush)
        lib_ms = time_ms(lib, 20, flush) if lib is not None else None
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        lib_txt = (f", library {lib_ms:.4f} ms ({LIBRARY[name]})"
                   if lib_ms is not None else
                   ", library none (no single PyTorch call computes a tree-masked"
                   " or per-leaf-path attention)")
        print(f"[timing] {name}: kernel {ms:.4f} ms ({host_ms:.4f} ms unprimed: "
              f"the device waits for the wrapper's host work), plain {plain_ms:.4f} ms"
              f"{lib_txt}, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of the bound", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace 8 decode steps per mode with torch.profiler "
                         "(the 4000-token prompt over bf16 and int8 KV, the "
                         "16-token prompt over bf16 KV) and 8 batched flatten "
                         "steps of the batch path's four requests")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import deft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the deft_tpu_torch package is missing ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        smi, name = phase_card()
        phase_build()
        shapes = path_shapes(dev)
        errs = phase_kernels(dev, shapes)
        t0 = time.perf_counter()
        params = random_params(PRESETS["8b"], SEED, dev, torch.bfloat16)
        torch.cuda.synchronize()
        print(f"[main] 8b random bf16 weights made on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        launches, prompt, ids, lf, main_runs = phase_main(dev, params, args.profile)
        launches.update({k: v for k, v in phase_int8(dev, params, prompt, ids,
                                                     lf, args.profile).items()
                         if k in ("paged_flatten_q", "paged_seq_q")})
        launches.update({k: v for k, v in phase_short(dev, params, args.profile).items()
                         if k in ("flatten_gather", "seq_gather")})
        launches["ragged_prefill"] = phase_batch(dev, params,
                                                args.profile)["ragged_prefill"]
        del params, lf
        torch.cuda.empty_cache()
        launches["int8_matmul"] = phase_int8w(dev, prompt, ids, main_runs)["int8_matmul"]
        if args.profile:
            profile_kv_store(dev)
        timing = phase_timing(dev, shapes)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [dict(name=n, route="cuda", source=f"deft_tpu_torch/csrc/{KERNELS[n][1]}",
                    replaces=KERNELS[n][0], launches=launches[n],
                    max_abs_err=errs[n], ms=timing[n]["ms"],
                    plain_ms=timing[n]["plain_ms"], bound_ms=timing[n]["bound_ms"],
                    bound_by=timing[n]["bound_by"],
                    library_ms=timing[n]["library_ms"])
               for n in KERNELS]
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
