"""Experiment CLI: one tree generation, from a local HF checkpoint or with
random weights.

Port of deft_tpu/cli/run.py:26 (build_parser), :120 (_load_model_and_
tokenizer) and :200 (main): --model DIR (a local HF checkpoint: its
config.json through LlamaConfig.from_hf_config, its weights through
models/loader.py load_params, its tokenizer through transformers'
AutoTokenizer where that loads, else the id tokenizer of random-init runs)
or --random-model PRESET, one of the two; --mode node|seq|flatten|tree|node_chunk|tree_index with --mem paged|unpaged
(deft_tpu's mode_from_cli), --Branch_controller Simple_Tree|Beam_Search|
Random_Tree|Practical_Tree|Speculative_Decoding, --dataset (a Reasoning or
Speculative_Decoding JSON; without it the synthetic templates of
data/synthetic.py, deft_tpu :216-245), --traversal (accepted for parity),
--tree_idx, --node_chunk_len, --max_width, --max_depth, --max_seq_len,
--prompt_len, --block_len, --dtype, --kv-dtype inherit|int8,
--weight-dtype inherit|int8|int8-pallas, --kv_pool_slots, --seed,
--output_file, --print-branches, --batch N (N requests through the
continuous-batching engine, deft_tpu :270-296), --device cuda|cpu (default
cuda; a missing GPU raises), and the multi-device engine (deft_tpu :84-90,
:141-167, :213-216): --mesh DPxSPxTP|auto starts dp*sp*tp ranks on this host
(parallel/launch.py) and runs the generation on the grid (every --mode and
--mem, and --batch N; a decode step's rows over dp, a prefill's tokens over
sp, as deft_tpu's batch specs lay them out), --multihost makes this
process one rank of a torchrun job (its environment names the group),
--dist-backend nccl|gloo (default nccl on cuda, gloo on cpu; nccl refuses
two ranks on one card); --trace-dir DIR writes a torch.profiler Chrome
trace of the run there, with the prefill, plan_build and decode_step spans
(obs/tracing.py).  Only rank 0 prints and traces.  deft_tpu's --kernels
(its xla choice would put the plain versions on the card's main path) and
--platform are not ported, so argparse refuses them.

Usage (the default 16-token prompt; --model DIR in place of --random-model
tiny for a checkpoint; add --kv-dtype int8 for the int8 cache,
--weight-dtype int8-pallas for int8 weights through kernel B9, --batch 3
for three requests decoded together, --mesh 1x2x2 for four ranks,
--Branch_controller Practical_Tree for a synthetic ToT template):
    python -m deft_tpu_torch.cli.run --device cpu --random-model tiny \
        --mode flatten --max_width 3 --max_seq_len 40 --dtype float32 \
        --kv_pool_slots 4096
"""

from __future__ import annotations

import argparse
import random
import sys
import time
import zlib

WORKLOADS = {"Simple_Tree": "simple_tree", "Beam_Search": "beam_search",
             "Random_Tree": "random_tree", "Practical_Tree": "practical_tree",
             "Speculative_Decoding": "speculative_decoding"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="deft_tpu_torch tree-decoding run")
    model = p.add_mutually_exclusive_group(required=True)
    model.add_argument("--model", type=str, default=None,
                       help="local HF checkpoint dir (config.json + safetensors"
                            " or pytorch_model*.bin)")
    model.add_argument("--random-model", type=str, default=None,
                       choices=["tiny", "1b", "3b", "7b", "8b", "8b-8l",
                                "mixtral-6l"],
                       help="random-init preset (no weights needed)")
    p.add_argument("--mode", default="flatten",
                   choices=["node", "seq", "flatten", "tree", "node_chunk",
                            "tree_index"])
    p.add_argument("--mem", choices=["paged", "unpaged"], default="paged")
    p.add_argument("--Branch_controller", default="Simple_Tree",
                   choices=list(WORKLOADS))
    p.add_argument("--dataset", type=str, default=None,
                   help="tree-template JSON (Practical_Tree /"
                        " Speculative_Decoding); default: a synthetic template")
    p.add_argument("--traversal", choices=["dfs", "bfs_token", "bfs_node"],
                   default="dfs",
                   help="accepted for parity; plans always use DFS (the"
                        " reference's non-dfs options are dead code,"
                        " tree_cache.py:588,725)")
    p.add_argument("--max_depth", type=int, default=10)
    p.add_argument("--max_width", type=int, default=50)
    p.add_argument("--prompt_len", type=int, default=None)
    p.add_argument("--max_seq_len", type=int, default=500)
    p.add_argument("--tree_idx", type=int, default=0)
    p.add_argument("--output_file", type=str, default=None)
    p.add_argument("--block_len", type=int, default=256)
    p.add_argument("--node_chunk_len", type=int, default=None,
                   help="node_chunk mode: max tokens of one node per kernel"
                        " block (default --block_len; reference MAX_BLOCK_LEN,"
                        " run_DeFT_llama_paged.py:146-150)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--kv-dtype", choices=["inherit", "int8"],
                   default="inherit",
                   help="int8: quantized KV cache (per-token-head scales)")
    p.add_argument("--weight-dtype", choices=["inherit", "int8", "int8-pallas"],
                   default="inherit",
                   help="int8: weight-only int8 matmuls (per-output-channel "
                        "scales, plain torch expression); int8-pallas: the "
                        "same weights, decode-sized matmuls through the "
                        "hand-written kernel B9 (ops/int8_matmul.py)")
    p.add_argument("--kv_pool_slots", type=int, default=None)
    p.add_argument("--print-branches", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--batch", type=int, default=1,
                   help="N>1: drive N requests of this workload through the "
                        "continuous-batching engine (shared pools, one ragged "
                        "prefill, one multi-tree step per iteration)")
    p.add_argument("--mesh", type=str, default=None, metavar="DPxSPxTP",
                   help="run on a (dp, sp, tp) grid of ranks, e.g. 1x2x2; "
                        "'auto' factors every card of this host (or, with "
                        "--multihost, every rank of the job)")
    p.add_argument("--multihost", action="store_true",
                   help="this process is one rank of a torchrun job (RANK, "
                        "WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend (default: nccl on cuda, "
                        "gloo on cpu)")
    p.add_argument("--trace-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run here")
    return p


class IdTokenizer:
    """The tokenizer of a random-init model or of a checkpoint without one
    (deft_tpu cli/run.py:94, _IdTokenizer): ids <-> their decimal words."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list:
        return encode(text, self.vocab_size)

    def decode(self, ids, **kw) -> str:
        return " ".join(str(int(t)) for t in ids)


def model_config(args):
    """The LlamaConfig of --model (its config.json) or --random-model."""
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.config import LlamaConfig

    if args.model:
        return LlamaConfig.from_pretrained(args.model)
    return PRESETS[args.random_model]


def load_tokenizer(args, cfg):
    """--model's tokenizer through transformers.AutoTokenizer where that
    package and the checkpoint's tokenizer files load, else the id
    tokenizer (deft_tpu cli/run.py:167-173)."""
    if args.model:
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(args.model)
        except Exception:  # no transformers, or no tokenizer files
            pass
    return IdTokenizer(cfg.vocab_size)


def encode(text: str, vocab_size: int) -> list:
    """deft_tpu cli/run.py:94 (_IdTokenizer.encode), the tokenizer of a
    random-init model: numeric words map to their value mod the vocabulary,
    any other word hashes stably into it."""
    def tok(t: str) -> int:
        body = t[1:] if t.startswith("-") else t
        if body.isdecimal():
            return int(t) % vocab_size
        return (zlib.crc32(t.encode()) % (vocab_size - 4)) + 4

    return [tok(t) for t in text.split()]


def make_prompt(prompt_len, max_seq_len: int, vocab_size: int, seed: int,
                text: str = None, tokenizer=None) -> list:
    """Prompt ids, as deft_tpu cli/run.py:179 makes them: a template's
    prompt text encoded (by ``tokenizer``, else the id tokenizer), trimmed
    or padded with seeded random ids below ``vocab_size`` to prompt_len;
    without text, seeded random ids, or 7.. when no length (or a length
    <= 0, which deft_tpu maps to none, cli/run.py:202-203)."""
    if not text:
        ids = []
    elif tokenizer is not None:
        ids = list(tokenizer.encode(text))
    else:
        ids = encode(text, vocab_size)
    if prompt_len and prompt_len > 0:
        if len(ids) >= prompt_len:
            return ids[:prompt_len]
        rnd = random.Random(seed)
        return ids + [rnd.randrange(4, max(8, vocab_size - 1))
                      for _ in range(prompt_len - len(ids))]
    return ids or list(range(7, 7 + min(16, max(2, max_seq_len // 2))))


def make_template(args):
    """The workload's template (deft_tpu cli/run.py:216-245): a ToT schedule
    for Practical_Tree, a token tree and accept schedule for
    Speculative_Decoding, from --dataset or, without it, synthetic; None for
    the other workloads."""
    from deft_tpu_torch.data import load_prompts, load_trees
    from deft_tpu_torch.data.synthetic import synth_spec_tree, synth_tot_tree

    synthetic = args.dataset in (None, "synthetic")
    gen_len = max(8, args.max_seq_len - (args.prompt_len or 16) - 1)
    if args.Branch_controller == "Practical_Tree":
        if not synthetic:
            return load_trees(args.dataset)[args.tree_idx]
        return synth_tot_tree(seed=args.seed + args.tree_idx,
                              width=min(args.max_width, 4),
                              max_leaves=args.max_width, total_iters=gen_len)
    if args.Branch_controller == "Speculative_Decoding":
        if not synthetic:
            return load_prompts(args.dataset)[args.tree_idx]
        return synth_spec_tree(token_tree_size=args.max_width, gen_len=gen_len,
                               seed=args.seed + args.tree_idx)
    return None


def grid_shape(mesh: str, n_ranks: int, num_kv_heads: int) -> tuple:
    """(dp, sp, tp) of a --mesh value: DPxSPxTP, or 'auto' (deft_tpu's
    factoring of n_ranks)."""
    from deft_tpu_torch.parallel.mesh import _factor

    if mesh == "auto":
        dp, tp, sp = _factor(n_ranks, num_kv_heads)
        return dp, sp, tp
    dims = tuple(int(x) for x in mesh.lower().split("x"))
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"--mesh {mesh!r}: DPxSPxTP, e.g. 1x2x2, or auto")
    return dims


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.prompt_len is not None and args.prompt_len <= 0:
        args.prompt_len = None
    cfg = model_config(args)
    if args.multihost:
        import torch.distributed as dist

        from deft_tpu_torch.parallel import init_runtime, make_pod_mesh

        init_runtime(args.dist_backend, device=args.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        shape = (grid_shape(args.mesh, world, cfg.num_kv_heads) if args.mesh
                 else None)
        grid = make_pod_mesh(num_kv_heads=cfg.num_kv_heads, shape=shape,
                             device=args.device)
        if grid.rank == 0:
            print_arguments(args)
        try:
            rc = run(grid, args)
            # every rank leaves its last collective before any rank closes
            # its connections; a rank that raised skips this, so it fails
            # rather than waiting for its peers
            if dist.is_initialized():
                dist.barrier()
            return rc
        finally:
            # the group is torn down before the interpreter exits, as
            # parallel/launch.py does for its ranks
            if dist.is_initialized():
                dist.destroy_process_group()
    print_arguments(args)
    if args.mesh:
        from deft_tpu_torch.parallel import launch

        n = 0
        if args.mesh == "auto":
            import torch

            if args.device != "cuda" or not torch.cuda.is_available():
                raise SystemExit("--mesh auto counts this host's GPUs: give "
                                 "DPxSPxTP on the CPU")
            n = torch.cuda.device_count()
        return launch(run, grid_shape(args.mesh, n, cfg.num_kv_heads), args.device,
                      args.dist_backend, args=(args,))
    return run(None, args)


def print_arguments(args) -> None:
    print("Generation starts with arguments:",
          ", ".join(f"{k}={v}" for k, v in vars(args).items()), flush=True)


def run(grid, args) -> int:
    """One generation on this process's rank of ``grid`` (None: one
    device); only rank 0 prints and writes the output file."""
    from deft_tpu_torch.config import AttentionConfig, EngineConfig
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.data import generate_accepted_len_list
    from deft_tpu_torch.obs import Tracer
    from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate

    cfg = model_config(args)
    chunk = ((args.node_chunk_len or args.block_len) if args.mode == "node_chunk"
             else None)
    ecfg = EngineConfig(attention=AttentionConfig(block_len=args.block_len,
                                                  node_chunk_len=chunk),
                        kv_pool_slots=args.kv_pool_slots, dtype=args.dtype,
                        kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype)
    runner = ModelRunner(cfg, ecfg, device=args.device, seed=args.seed,
                         topk_k=max(64, args.max_width), mesh=grid,
                         use_tree_index=args.mode == "tree_index",
                         model_path=args.model)
    tokenizer = load_tokenizer(args, cfg)
    template = make_template(args)
    prompt_ids = make_prompt(args.prompt_len, args.max_seq_len,
                             getattr(tokenizer, "vocab_size", cfg.vocab_size),
                             args.seed, getattr(template, "prompt", None),
                             tokenizer)
    if template is not None and template.accepted_len_list is not None:
        generate_accepted_len_list(args.max_seq_len - len(prompt_ids), template,
                                   seed=args.seed)
    fn = getattr(workloads, WORKLOADS[args.Branch_controller])
    mode = mode_from_cli(args.mode, args.mem)
    primary = grid is None or grid.rank == 0
    tracer = Tracer(args.trace_dir if primary else None)
    with tracer.session():
        if args.batch > 1:
            return run_batch(args, runner, mode, prompt_ids, fn, template,
                             tokenizer, primary)
        pm = tree_generate(
            model=runner,
            mode=mode,
            tokenizer=tokenizer,
            prompt_ids=prompt_ids,
            max_seq_len=args.max_seq_len,
            width=args.max_width,
            depth=args.max_depth,
            branch_controller=Branch_Controller(fn),
            tree_template=template,
            output_file=args.output_file if primary else None,
            print_branches=args.print_branches and primary,
            tracer=tracer,
        )
    if primary:
        pm.print_latency()
        if tracer.trace_file:
            print(f"trace written to {tracer.trace_file}")
    return 0


def run_batch(args, runner, mode, prompt_ids, fn, template, tokenizer,
              primary: bool = True) -> int:
    """--batch N: N requests of the same prompt and workload, admitted by one
    ragged prefill and decoded together (deft_tpu cli/run.py:270-296); on a
    grid every rank runs the engine and only rank 0 (``primary``) prints."""
    from deft_tpu_torch.control import Branch_Controller
    from deft_tpu_torch.obs.timers import synchronize
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request

    eng = BatchedEngine(runner, mode=mode)
    reqs = [Request(prompt_ids, Branch_Controller(fn), args.max_seq_len,
                    width=args.max_width, depth=args.max_depth, template=template)
            for _ in range(args.batch)]
    t0 = time.perf_counter()
    eng.add_requests(reqs)
    eng.run()
    synchronize(runner.device)
    wall = time.perf_counter() - t0
    if not primary:
        return 0
    tok = sum(len(s.token_ids) for r in reqs for s in r.finished_seqs)
    print(f"batched: {args.batch} requests, {tok} generated tokens, "
          f"{wall * 1000:.1f} ms wall, "
          f"{wall * 1000 / max(tok, 1):.4f} ms/token aggregate")
    if args.print_branches:
        for i, r in enumerate(reqs):
            for s in r.finished_seqs:
                print(f"req {i} branch {s.id}: {tokenizer.decode(s.token_ids)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
