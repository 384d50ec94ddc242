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
  7. timing:  CUDA-event times of each kernel, its plain version and, for
              prefill, scaled_dot_product_attention, at its path's shapes,
              beside the least time the card could take.
Each path's counts are set to 0 just before it and read just after (the
short path's two runs each, summed).  Then
one JSON line of kernels, the card's nvidia-smi line, and the last line
{"ok": true, "device": {...}}.

Tolerances: bf16 kernels round P to bf16 for the PV product and sum in
another order than the fp32 plain versions, so 2e-2 relative (deft_tpu
tests/test_kernels.py's bf16 bound); fp32 kernels differ by summation order
only, 2e-5.  Errors are max |kernel - plain| / max |plain| over live rows.
"""

from __future__ import annotations

import argparse
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
}


class Failure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-9))


def wrappers():
    """name -> (kernel wrapper, its plain version): the wrappers carry the
    launch counters."""
    from deft_tpu_torch.ops import flatten_attn as fa
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


def path_shapes(dev):
    """Kernel inputs at each path's shapes, Llama-3.1-8B heads (Hq 32, Hkv 8,
    D 128), bf16 q, block_len 256, width 50: B1/B2 (bf16 pools) and B4/B5
    (int8 pools) on the 4000-token prompt's tree halfway through its 64
    tokens; B6 (bf16 and int8 pools) on the CLI's 16-token prompt's tree
    halfway through, B7 at its fifth step, where their plans come out not
    segment-aligned; prefill of the 4000-token prompt.
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

    def compare(name, label, plan, args, tol):
        fn, plain = fns[name]
        rows = slice(0, plan.n_leaves) if plan is not None else slice(None)
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        e = rel_err(got[rows], want[rows])
        print(f"[kernels] {name} {label}: rel err {e:.3e}, tol {tol:.0e}", flush=True)
        check(e < tol and bool(torch.isfinite(got[rows]).all()),
              f"{name} {label} disagrees with its plain version: {e}")
        return float((got[rows].double() - want[rows].double()).abs().max())

    errs = {}
    for name, cases in shapes.items():
        for label, plan, args in cases:
            e = compare(name, f"bf16 path shapes {label}", plan, args,
                        TOL["bfloat16"])
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
                                f"{label}", plan, args, TOL["float32"])
                for name in ("paged_seq", "paged_seq_q", "seq_gather"):
                    for kv in (("inherit", "int8") if name == "seq_gather"
                               else (None,)):
                        plan, args = kernel_case(name, tree, 4, 2, D, f32, dev, gen,
                                                 block_len, kv=kv)
                        if tree is b and KERNELS[name][4] == "paged":
                            check(bool(plan.seg_off.any()),
                                  f"{name}: plan has no unaligned segment")
                        compare(name, f"fp32 {kv or ''} D={D} block {block_len} "
                                f"{label}", plan, args, TOL["float32"])
            # the short prompt's plans as the runner builds them: not paged
            for name in ("flatten_gather", "seq_gather"):
                for kv in ("inherit", "int8"):
                    plan, args = kernel_case(name, c, 4, 2, D, f32, dev, gen,
                                             block_len, kv=kv, as_built=True)
                    compare(name, f"fp32 {kv} D={D} block {block_len} short-prompt "
                            "plan", plan, args, TOL["float32"])
        for N in (300, 1000):
            args = prefill_case(N, 8, 2, D, f32, dev, gen)
            compare("prefill", f"fp32 D={D} N={N}", None, args, TOL["float32"])
    return errs


def make_runner(cfg, params, dev, kv_dtype="inherit", prompt_len=PROMPT_LEN):
    from deft_tpu_torch.config import AttentionConfig, EngineConfig
    from deft_tpu_torch.runtime import ModelRunner

    ecfg = EngineConfig(attention=AttentionConfig(block_len=256),
                        kv_pool_slots=16384, max_requests=2 * WIDTH,
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
    generate_both(runner, prompt, "main")
    launches = read_counts()
    print(f"[main] launches during the main path: {launches}", flush=True)
    for name in ("prefill", "paged_flatten", "paged_seq"):
        check(launches[name] > 0, f"kernel {name} was never launched on the main path")
    if profile:
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
    del runner
    torch.cuda.empty_cache()
    return launches, prompt, ids, lf


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
    """torch.profiler over `steps` greedy decode steps of a fresh tree:
    device time by kernel, the device's busy share of the wall time, and the
    host and device time of each step's plan building, its forward and the
    model's kv_store calls within it (RANGES, marked with record_function
    while the profiler runs)."""
    from unittest import mock

    import torch
    from deft_tpu_torch.models import llama
    from torch.profiler import ProfilerActivity, profile, record_function

    store = llama.kv_store

    def marked_store(*a):
        with record_function("kv_store"):
            store(*a)

    runner.reset_state()
    view = runner.forward_prefill(prompt)
    tree = runner.tree
    _, ids = view.topk(0, width)
    for c, child in enumerate(tree.branch(tree.root, width)):
        child.append_token(int(ids[c]))
    torch.cuda.synchronize()
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof,
          mock.patch.object(llama, "kv_store", marked_store)):
        t0 = time.perf_counter()
        for _ in range(steps):
            tree.alloc()
            with record_function("build_plan"):
                plan = runner.build_plan(mode)
            with record_function("forward"):
                v, _ = runner.forward_tree_decode(mode, plan, logits_kind="greedy")
            nxt, _ = v.argmax()
            for leaf in tree.leaves.values():
                leaf.append_token(int(nxt[tree.leaf_to_q[leaf.id]]))
        wall_ms = (time.perf_counter() - t0) * 1e3
    runner.reset_state()

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
    kv = "int8" if runner.k_pool.quantized else "bf16"
    print(f"[profile] {mode.name}, prompt {len(prompt)}, {kv} KV: {steps} steps, "
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


def time_ms(fn, reps: int, flush) -> float:
    """Mean CUDA-event time of fn() over reps launches, L2 flushed before
    each (the decode step's weight streaming leaves the cache cold)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in zip(starts, ends)]))


def phase_timing(dev, shapes):
    """Per kernel at its path's shapes (the bf16-pool case of B6 and B7):
    kernel, plain and (prefill) library times, the least time the card could
    take and what bounds it."""
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
        if name == "prefill":
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
    rows["prefill"] = (lambda f=fn: f(q, k, v, scale),
                       lambda p=plain: p(q, k, v, scale),
                       lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=True, scale=scale),
                       *bound(nbytes, 2 * 2 * Hq * N * N * D / 2))

    out = {}
    for name, (kern, plain_fn, lib, bound_ms, bound_by) in rows.items():
        ms = time_ms(kern, 20, flush)
        plain_ms = time_ms(plain_fn, 3, flush)
        lib_ms = time_ms(lib, 20, flush) if lib is not None else None
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        lib_txt = (f", library {lib_ms:.4f} ms" if lib_ms is not None else
                   ", library none (no single PyTorch call computes a tree-masked"
                   " or per-leaf-path attention)")
        print(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{lib_txt}, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of the bound", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace 8 decode steps per mode with torch.profiler "
                         "(the 4000-token prompt over bf16 and int8 KV, the "
                         "16-token prompt over bf16 KV)")
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
        launches, prompt, ids, lf = phase_main(dev, params, args.profile)
        launches.update({k: v for k, v in phase_int8(dev, params, prompt, ids,
                                                     lf, args.profile).items()
                         if k in ("paged_flatten_q", "paged_seq_q")})
        launches.update({k: v for k, v in phase_short(dev, params, args.profile).items()
                         if k in ("flatten_gather", "seq_gather")})
        del params, lf
        torch.cuda.empty_cache()
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
