"""Parameters: random init, conversion from numpy, local HF checkpoints.

Port of deft_tpu/models/loader.py:25 (_param_shapes), :76 (QUANT_WEIGHTS),
:83 (_fuse_host), :103 (_fused_shapes), :189 (_quantize_int8), :197
(_finalize), :217 (random_params), :293 (_iter_hf_weights) and :315
(load_params).  The port keeps the JAX package's parameter layout: stacked
(num_layers, ...) tensors, projections as (in, out) matrices, and q/k/v and
gate/up fused along the output axis (wqkv, wgu) as deft_tpu's single-chip
runner keeps them (runner.py:228-252).  A Mixtral-family MoE config replaces
the dense MLP by the router ``wrt`` (L, E, NE) and stacked experts
``wg``/``wu`` (L, NE, E, I) and ``wdown`` (L, NE, I, E), which stay unfused
(deft_tpu loader.py:31-38, :90-95, :120-123).  Qwen2-family qkv biases
fuse into ``bqkv`` (L, (Hq + 2 Hkv) D) as the weights do; Qwen3-family q/k
norms are ``ln_q``/``ln_k`` (L, D).  Biases and norms are never quantised.

Weight-only int8 (``weight_dtype`` "int8" or "int8-pallas"): every matmul
weight in QUANT_WEIGHTS becomes int8 codes plus a per-output-channel fp32
scale under ``name + "_s"`` ("int8") or ``name + "_sp"`` ("int8-pallas"),
which tells ``llama.mm`` which route to take (deft_tpu loader.py:207-211).
Expert stacks are quantised per expert and output column (scales (L, NE,
F)); the router stays in the model dtype.

Two random streams:
- the numpy stream (``random_params(..., device="cpu")``): default_rng(seed)
  drawn in _param_shapes order, the same numbers as deft_tpu's CPU path
  (loader.py:233-244), so both packages get identical weights;
- a ``torch.Generator`` on the target device for full-size models, where
  the numpy path would hold some 32 GB of fp32 on the host (8B).

Checkpoints (``load_params``): ``*.safetensors`` through the port's own
reader (``read_safetensors``: an 8-byte little-endian header length, a JSON
header, raw little-endian data; F32, F16, BF16 and I8), else
``pytorch_model*.bin`` through ``torch.load(weights_only=True)``.  Where
deft_tpu fills fp32 numpy buffers on the host and converts them at the end,
the port writes each checkpoint tensor, widened to fp32, straight into its
block of the final device tensor (cast, or quantised per output column:
every column of a checkpoint tensor holds its whole input axis, so the codes
and scales are those of the fused tensor).  The values are deft_tpu's.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from deft_tpu_torch.config import WEIGHT_DTYPES
from deft_tpu_torch.models.config import LlamaConfig

# (members, fused name) along the output axis (deft_tpu loader.py:80); the
# Qwen2 biases fuse the same way
_FUSE_GROUPS = ((("wq", "wk", "wv"), "wqkv"), (("wg", "wu"), "wgu"),
                (("bq", "bk", "bv"), "bqkv"))

# Matmul weights that weight-only int8 quantises: all but embed and the norms
# (deft_tpu loader.py:76).  Scales are per output column, so quantising a
# fused tensor equals fusing the quantised members.
QUANT_WEIGHTS = ("wq", "wk", "wv", "wo", "wg", "wu", "wdown", "lm_head",
                 "wqkv", "wgu")
SCALE_SUFFIX = {"int8": "_s", "int8-pallas": "_sp"}


def _param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Llama shapes (MoE: router and stacked experts in place of the dense
    MLP; Qwen2: qkv biases; Qwen3: per-head q/k norms), in the order the
    numpy stream draws them (deft_tpu loader.py:25-71)."""
    E, D, L, I = cfg.hidden_size, cfg.head_dim, cfg.num_layers, cfg.intermediate_size
    NE = cfg.num_experts
    Hq, Hkv = cfg.num_q_heads, cfg.num_kv_heads
    mlp = ({"wrt": (L, E, NE), "wg": (L, NE, E, I), "wu": (L, NE, E, I),
            "wdown": (L, NE, I, E)} if NE > 0 else
           {"wg": (L, E, I), "wu": (L, E, I), "wdown": (L, I, E)})
    bias = ({"bq": (L, Hq * D), "bk": (L, Hkv * D), "bv": (L, Hkv * D)}
            if cfg.qkv_bias else {})
    qk_norm = {"ln_q": (L, D), "ln_k": (L, D)} if cfg.qk_norm else {}
    return {
        "embed": (cfg.vocab_size, E),
        "ln1": (L, E),
        "wq": (L, E, cfg.num_q_heads * D),
        "wk": (L, E, cfg.num_kv_heads * D),
        "wv": (L, E, cfg.num_kv_heads * D),
        "wo": (L, cfg.num_q_heads * D, E),
        "ln2": (L, E),
        **mlp,
        "ln_f": (E,),
        "lm_head": (E, cfg.vocab_size),
        **bias,
        **qk_norm,
    }


def _fusable(shapes: Dict[str, Any], group) -> bool:
    """A fuse group applies when all its members exist and are not MoE
    expert stacks (4-D, which stay unfused)."""
    return all(g in shapes for g in group) and len(shapes[group[0]]) != 4


def _fused_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """_param_shapes with each fusable group replaced, at its first
    member's place, by the fused tensor (deft_tpu loader.py:103)."""
    shapes = _param_shapes(cfg)
    out: Dict[str, Any] = {}
    for name, shape in shapes.items():
        group, fused = next(((g, f) for g, f in _FUSE_GROUPS if name in g),
                            (None, None))
        if group is None or not _fusable(shapes, group):
            out[name] = shape
        elif name == group[0]:
            out[fused] = shape[:-1] + (sum(shapes[g][-1] for g in group),)
    return out


def fuse_host(bufs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """q/k/v -> wqkv, gate/up -> wgu and the biases -> bqkv on host numpy;
    already fused inputs and 4-D MoE expert stacks pass through (deft_tpu
    loader.py:83)."""
    p = dict(bufs)
    for group, out in _FUSE_GROUPS:
        if all(g in p for g in group) and np.ndim(p[group[0]]) != 4:
            p[out] = np.concatenate([np.asarray(p[g]) for g in group], axis=-1)
            for g in group:
                del p[g]
    return p


def _quantize_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8 of fp32 ``w`` (..., in, out): scale
    max(max|w| / 127, 1e-8) over the input axis, codes round(w / scale)
    (half to even, as np.round) clipped to +-127 (deft_tpu loader.py:189).
    Returns (int8 codes, fp32 scales (..., out))."""
    s = torch.clamp_min(w.abs().amax(dim=-2, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s.squeeze(-2)


def _check_weight_dtype(weight_dtype: str) -> None:
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype {weight_dtype!r}: one of "
                         f"{', '.join(WEIGHT_DTYPES)}")


def params_from_numpy(np_params: Dict[str, np.ndarray], cfg: LlamaConfig,
                      device, dtype: torch.dtype,
                      weight_dtype: str = "inherit") -> Dict[str, torch.Tensor]:
    """The port's parameters from float numpy arrays in deft_tpu's layout,
    fused (wqkv, wgu) or unfused (wq/wk/wv, wg/wu): e.g. ``{k: np.asarray(v)}``
    of a deft_tpu runner's (unquantised) params, or the numpy random stream.
    ``weight_dtype`` int8 flavours quantise the fused matmul weights, as
    deft_tpu's _finalize(fuse=True) does (loader.py:197-214)."""
    _check_weight_dtype(weight_dtype)
    bufs = fuse_host(np_params)
    want = _fused_shapes(cfg)
    if set(bufs) != set(want):
        raise KeyError(f"parameter names {sorted(bufs)} != {sorted(want)}")
    out = {}
    for name, shape in want.items():
        arr = np.array(bufs[name], dtype=np.float32)  # a private copy
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != {shape}")
        w = torch.from_numpy(arr)
        if weight_dtype != "inherit" and name in QUANT_WEIGHTS:
            q, s = _quantize_int8(w)
            out[name] = q.to(device)
            out[name + SCALE_SUFFIX[weight_dtype]] = s.to(device)
        else:
            out[name] = w.to(device=device, dtype=dtype)
    return out


def numpy_random_params(cfg: LlamaConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """deft_tpu's CPU random stream (loader.py:233-244): norms are ones,
    every other tensor N(0, 1) / sqrt(fan_in), drawn in _param_shapes order."""
    rng = np.random.default_rng(seed)
    bufs: Dict[str, np.ndarray] = {}
    for name, shape in _param_shapes(cfg).items():
        if name.startswith("ln"):
            bufs[name] = np.ones(shape, dtype=np.float32)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            arr = rng.standard_normal(size=shape, dtype=np.float32)
            arr *= 1.0 / np.sqrt(fan_in)
            bufs[name] = arr
    return bufs


def random_params(cfg: LlamaConfig, seed: int = 0, device="cuda",
                  dtype: torch.dtype = torch.bfloat16,
                  weight_dtype: str = "inherit") -> Dict[str, torch.Tensor]:
    """Random-init parameters with sane scales.

    On the CPU: deft_tpu's numpy stream, so both packages get the same
    weights (and, for int8, the same codes and scales).  On a GPU: a
    torch.Generator seeded with ``seed`` draws the fused tensors directly on
    ``device``, one layer at a time, and int8 flavours quantise each layer's
    slice as it is drawn: the fp32 transient is one layer's tensor (lm_head,
    the largest, is 2.1 GB at 8B; one layer's expert stack is 1.9 GB at
    Mixtral-8x7B) and no full-precision copy of a quantised weight ever
    exists.  The same seed gives the int8 weights of the same
    draws as the bf16 ones."""
    device = torch.device(device)
    _check_weight_dtype(weight_dtype)
    if device.type == "cpu":
        return params_from_numpy(numpy_random_params(cfg, seed), cfg, device,
                                 dtype, weight_dtype)
    return generator_params(cfg, seed, device, dtype, weight_dtype)


def generator_params(cfg: LlamaConfig, seed: int, device, dtype: torch.dtype,
                     weight_dtype: str = "inherit",
                     keep: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """random_params' torch.Generator stream on ``device``: the fused
    tensors in _fused_shapes order, each stacked tensor one layer at a time,
    N(0, 1) / sqrt(fan_in) in fp32, then quantised (int8 flavours) or cast.
    ``keep(name, x, stacked)`` cuts what is stored of each drawn tensor (a
    layer of a stacked one, or a whole one) and of its int8 scale (the
    name ends in the scale suffix), after the quantisation: the
    multi-device loader keeps a rank's slice of the same draws."""
    device = torch.device(device)
    _check_weight_dtype(weight_dtype)
    cut = keep or (lambda name, x, stacked: x)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: Dict[str, torch.Tensor] = {}
    for name, shape in _fused_shapes(cfg).items():
        stacked = len(shape) >= 3
        if name.startswith("ln"):
            params[name] = cut(name, torch.ones(shape, dtype=dtype, device=device),
                               False)
            continue
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        quant = weight_dtype != "inherit" and name in QUANT_WEIGHTS
        sname = name + SCALE_SUFFIX.get(weight_dtype, "")
        out = scale = None
        for i in range(shape[0]) if stacked else [None]:
            x = torch.randn(shape[1:] if stacked else shape, generator=gen,
                            device=device, dtype=torch.float32).mul_(fan_in ** -0.5)
            if quant:
                q, s = _quantize_int8(x)
                q, s = cut(name, q, stacked), cut(sname, s, stacked)
            else:
                q, s = cut(name, x.to(dtype), stacked), None
            del x
            if not stacked:
                out, scale = q, s
                break
            if out is None:  # the kept layer's shape is known once drawn
                out = torch.empty((shape[0],) + q.shape, dtype=q.dtype, device=device)
                scale = (torch.empty((shape[0],) + s.shape, dtype=s.dtype,
                                     device=device) if quant else None)
            out[i].copy_(q)
            if quant:
                scale[i].copy_(s)
        params[name] = out
        if quant:
            params[sname] = scale
    return params


# -- local HF checkpoints -------------------------------------------------------

# safetensors dtype -> the little-endian numpy type its bytes are read as;
# BF16 (no numpy type) is read as uint16 and viewed as torch.bfloat16
_ST_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2", "I8": "i1"}


def read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of every tensor of one ``.safetensors`` file, in
    the file's order: an 8-byte little-endian header length, a JSON header
    (name -> dtype, shape, [begin, end) byte offsets past the header;
    ``__metadata__`` skipped), then the raw little-endian data.  F32, F16
    and I8 keep their type; BF16 is read as uint16 and viewed as bfloat16,
    so widening it to fp32 later is exact."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    for name, meta in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        dt = _ST_DTYPES.get(meta["dtype"])
        if dt is None:
            raise TypeError(f"{path}: tensor {name} has dtype {meta['dtype']}, "
                            f"not one of {', '.join(_ST_DTYPES)}")
        lo, hi = meta["data_offsets"]
        arr = np.array(data[lo:hi]).view(dt).reshape(meta["shape"])
        if not arr.dtype.isnative:  # a big-endian host
            arr = arr.astype(arr.dtype.newbyteorder("="))
        t = torch.from_numpy(arr)
        yield name, (t.view(torch.bfloat16) if meta["dtype"] == "BF16" else t)


def _iter_hf_weights(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) from the ``*.safetensors`` files under ``path``
    (several files a checkpoint, in name order), else its
    ``pytorch_model*.bin`` files (deft_tpu loader.py:293)."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        for f in st_files:
            yield from read_safetensors(f)
        return
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors or .bin weights under {path}")
    for f in bin_files:
        yield from torch.load(f, map_location="cpu", weights_only=True).items()


def _checkpoint_target(cfg: LlamaConfig, name: str
                       ) -> Optional[Tuple[str, tuple, int, bool]]:
    """Where checkpoint tensor ``name`` goes: (parameter, index of its
    stacked axes, first output column, whether the HF (out, in) matrix is
    transposed to the port's (in, out)), or None for a tensor that is
    recomputed (rotary tables).  The name map of deft_tpu
    loader.py:315-402: q/k/v into wqkv's and gate/up into wgu's column blocks
    (Phi-3's fused qkv_proj and gate_up_proj keep that order); biases into
    bqkv; Qwen3's q/k norms; Mixtral's router and experts (w1 gate, w3 up,
    w2 down).  Raises KeyError on a name it does not map."""
    D, I = cfg.head_dim, cfg.intermediate_size
    qd, kvd = cfg.num_q_heads * D, cfg.num_kv_heads * D
    moe = cfg.num_experts > 0
    if name == "model.embed_tokens.weight":
        return "embed", (), 0, False
    if name == "lm_head.weight":
        return "lm_head", (), 0, True
    if name == "model.norm.weight":
        return "ln_f", (), 0, False
    parts = name.split(".")
    if not name.startswith("model.layers.") or len(parts) < 5:
        raise KeyError(f"unmapped weight {name}")
    li, sub = int(parts[2]), ".".join(parts[3:])
    cols = {"self_attn.q_proj": 0, "self_attn.k_proj": qd,
            "self_attn.v_proj": qd + kvd}
    simple = {"input_layernorm.weight": ("ln1", False),
              "post_attention_layernorm.weight": ("ln2", False),
              "self_attn.o_proj.weight": ("wo", True),
              "mlp.down_proj.weight": ("wdown", True),
              "block_sparse_moe.gate.weight": ("wrt", True)}
    if sub in simple:
        return simple[sub][0], (li,), 0, simple[sub][1]
    proj, _, kind = sub.rpartition(".")
    if proj in cols and kind == "weight":
        return "wqkv", (li,), cols[proj], True
    if proj in cols and kind == "bias":
        if not cfg.qkv_bias:
            raise KeyError(f"checkpoint has {name} but the parsed config set "
                           "qkv_bias=False (config.json probably lacks an "
                           "'architectures' entry naming Qwen2 or an "
                           "attention_bias flag)")
        return "bqkv", (li,), cols[proj], False
    if sub in ("self_attn.q_norm.weight", "self_attn.k_norm.weight"):
        if not cfg.qk_norm:
            raise KeyError(f"checkpoint has {name} but the parsed config set "
                           "qk_norm=False (config.json probably lacks an "
                           "'architectures' entry naming Qwen3)")
        return "ln_" + sub[len("self_attn.")], (li,), 0, False
    if sub == "self_attn.qkv_proj.weight":  # Phi-3: q|k|v, wqkv's order
        return "wqkv", (li,), 0, True
    if sub in ("mlp.gate_proj.weight", "mlp.up_proj.weight") and not moe:
        return "wgu", (li,), 0 if sub.startswith("mlp.gate") else I, True
    if sub == "mlp.gate_up_proj.weight" and not moe:  # Phi-3: gate|up
        return "wgu", (li,), 0, True
    if sub.startswith("block_sparse_moe.experts.") and moe:
        _, _, ei, wn, kind = sub.split(".")
        dst = {"w1": "wg", "w3": "wu", "w2": "wdown"}.get(wn)
        if dst is not None and kind == "weight":
            return dst, (li, int(ei)), 0, True
    if "rotary_emb" in sub:
        return None  # tables are recomputed
    raise KeyError(f"unmapped weight {name}")


def load_params(path: str, cfg: LlamaConfig, device="cuda",
                dtype: torch.dtype = torch.bfloat16,
                weight_dtype: str = "inherit") -> Dict[str, torch.Tensor]:
    """A local HF checkpoint in the port's fused layout on ``device``
    (deft_tpu loader.py:315 with fuse=True).  Each checkpoint tensor is
    widened to fp32 and written into its block of the final tensor: cast to
    ``dtype``, or for the matmul weights of an int8 ``weight_dtype``
    quantised per output column into codes and scales.  Parameters the
    checkpoint lacks stay zero, as deft_tpu's buffers do; a missing
    ``lm_head.weight`` ties it to the embedding, which a config that does
    not tie its embeddings refuses."""
    device = torch.device(device)
    _check_weight_dtype(weight_dtype)
    shapes = _fused_shapes(cfg)
    quant = {n for n in shapes if weight_dtype != "inherit" and n in QUANT_WEIGHTS}
    suffix = SCALE_SUFFIX.get(weight_dtype, "")
    params: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name in quant:
            params[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            # an all-zero column quantises to scale 1e-8 (_quantize_int8)
            params[name + suffix] = torch.full(shape[:-2] + shape[-1:], 1e-8,
                                               dtype=torch.float32, device=device)
        else:
            params[name] = torch.zeros(shape, dtype=dtype, device=device)

    def put(name: str, index: tuple, col: int, transpose: bool,
            w: torch.Tensor) -> None:
        """Checkpoint tensor ``w`` (on the CPU, as read) into its block:
        moved in its own type, then transposed and widened on the device."""
        want = shapes[name][len(index):]
        w = w.to(device)
        w = (w.t() if transpose else w).float()
        if w.shape[:-1] != want[:-1] or col + w.shape[-1] > want[-1]:
            raise ValueError(f"{name}{list(index)}: checkpoint shape "
                             f"{tuple(w.shape)} at column {col} does not fit {want}")
        cols = slice(col, col + w.shape[-1])
        if name in quant:
            q, s = _quantize_int8(w)
            params[name][index][..., cols] = q
            params[name + suffix][index][..., cols] = s
        else:
            params[name][index][..., cols] = w.to(dtype)

    embed = None  # the embedding as read, kept for a tied lm_head
    seen_lm_head = False
    for name, w in _iter_hf_weights(path):
        target = _checkpoint_target(cfg, name)
        if target is None:
            continue
        put(*target, w)
        seen_lm_head |= target[0] == "lm_head"
        if target[0] == "embed" and cfg.tie_word_embeddings:
            embed = w
    if not seen_lm_head:
        if not cfg.tie_word_embeddings:
            raise ValueError(
                f"checkpoint at {path} has no lm_head.weight but the config "
                "does not tie word embeddings — refusing to silently tie "
                "(the model would produce wrong logits)")
        if embed is not None:
            put("lm_head", (), 0, True, embed)
    return params
