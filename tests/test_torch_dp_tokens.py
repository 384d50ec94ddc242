"""deft_tpu's batch layout on grids 2x1x2 and 2x2x1 in deft_tpu_torch's
runner (the rest, and what is checked, in tests/test_torch_dp_rows.py):
spawned gloo ranks on the CPU, fp32, one launch a grid.

- the spec step (test_torch_dp_rows.py's) on these two grids;
- tokens equal deft_tpu's single-device tokens on grid 2x1x2 in flatten,
  seq, node, tree_index and Medusa, through the batched engine (a dp
  window starting inside a tree), over int8 KV, with int8-pallas weights
  and for the tiny MoE preset; on 2x2x1 (whose other modes
  test_torch_parallel.py runs) over int8 KV, with int8-pallas weights and
  for the MoE preset, its 520-token prefill split over sp with the
  experts over sp;
- the rows each rank runs through the dense layers of a runner: R_pad /
  dp at decode (R the plan's rows), N_pad / sp at prefill, N at the
  ragged prefill.
"""

import dataclasses

import pytest
from test_torch_dp_rows import ROUTES, check_spec_step, launch_grids, step_case
from test_torch_parallel import (BATCH, BATCH_GEN, BATCH_PROMPTS, GEN, GEN_PROMPT, MOE,
                                 MOE_ECFG, MOE_PROMPT, MODE_WIDTH, OTHER_MODES, j_batched,
                                 j_generate, j_mode_generate)

from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu_torch.config import AttentionConfig, EngineConfig
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.parallel.launch import batched_tokens, counted_rows, generate_tokens

MODES = ("flatten", "seq", "node", "tree_index", "medusa")
TOKEN_GRIDS = {"2x1x2": (2, 1, 2), "2x2x1": (2, 2, 1)}
ROWS_PROMPTS = [[7 + (i * 5 + j) % 97 for j in range(n)] for i, n in enumerate((300, 161))]


# the CLI's (--mode, --mem, --node_chunk_len) of each mode
MODE_SPECS = {"flatten": ("flatten", "paged", None), "seq": ("seq", "paged", None),
              **{m: OTHER_MODES[m] for m in ("node", "tree_index", "medusa")}}


def token_cases(name):
    """The token and row calls of a grid's launch, keyed."""
    tiny = PRESETS["tiny"]
    gen = dict(cfg=tiny, prompt=GEN_PROMPT, width=3, max_seq_len=32, seed=3)
    out = {}
    if name == "2x1x2":
        for mode in MODES:
            m, mem, chunk = MODE_SPECS[mode]
            out[f"mode {mode}"] = (generate_tokens, dict(
                gen, ecfg=EngineConfig(**GEN, attention=AttentionConfig(node_chunk_len=chunk)),
                mode=m, mem=mem, width=MODE_WIDTH))
        out["batch"] = (batched_tokens, dict(
            cfg=tiny, ecfg=EngineConfig(**BATCH), prompts=BATCH_PROMPTS, mode="flatten",
            width=3, gen=BATCH_GEN, seed=3))
    out["int8 kv"] = (generate_tokens, dict(gen, ecfg=EngineConfig(**GEN, kv_dtype="int8"),
                                            mode="flatten"))
    out["int8 weights"] = (generate_tokens, dict(
        gen, ecfg=EngineConfig(**GEN, weight_dtype="int8-pallas"), mode="flatten"))
    out["moe"] = (generate_tokens, dict(
        cfg=MOE, ecfg=EngineConfig(**MOE_ECFG), prompt=MOE_PROMPT, mode="flatten",
        width=3, max_seq_len=len(MOE_PROMPT) + 6, seed=3))
    out["rows"] = (counted_rows, dict(cfg=tiny, ecfg=EngineConfig(**BATCH),
                                      prompts=ROWS_PROMPTS, width=5, seed=3))
    return out


@pytest.fixture(scope="module")
def case():
    return step_case()


@pytest.fixture(scope="module")
def grids(case):
    return launch_grids(case, TOKEN_GRIDS, token_cases)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("grid", list(TOKEN_GRIDS))
def test_spec_step_matches_deft_tpu_decode_forward(case, grids, grid, route):
    check_spec_step(case, grids, grid, route)


@pytest.fixture(scope="module")
def reference():
    """deft_tpu's single-device runs (test_torch_parallel.py's helpers)."""
    out = {f"mode {mode}": j_mode_generate(*MODE_SPECS[mode]) for mode in MODES}
    out["batch"] = j_batched("flatten")
    out["int8 kv"] = j_generate(JPRESETS["tiny"], GEN, GEN_PROMPT, "flatten", 32,
                                kv_dtype="int8")
    out["int8 weights"] = j_generate(JPRESETS["tiny"], GEN, GEN_PROMPT, "flatten", 32,
                                     weight_dtype="int8-pallas")
    jmoe = dataclasses.replace(JPRESETS["tiny"], num_experts=4, experts_per_tok=2)
    out["moe"] = j_generate(jmoe, MOE_ECFG, MOE_PROMPT, "flatten", len(MOE_PROMPT) + 6)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_2x1x2_modes_match_deft_tpu(grids, reference, mode):
    """Grid 2x1x2: each rank's dp window of the 8 rows (width 6: the
    second window holds leaves 4 and 5) through every dense layer, B1p /
    B11, B2p, node and tree_index plans through the tree AttnFn, Medusa's
    dense baseline on the window's rows."""
    tokens, _ = grids["2x1x2"][f"mode {mode}"]
    want = reference[f"mode {mode}"]
    assert len(want) == 6 and tokens == want


def test_2x1x2_batched_engine_matches_deft_tpu(grids, reference):
    """BatchedEngine on grid 2x1x2: three requests' 9 live rows of 16, the
    second dp window starting inside the third tree's leaves."""
    tokens, steps = grids["2x1x2"]["batch"]
    assert tokens == reference["batch"]
    assert sum(not block for block, _ in steps) == len(steps) - 1


@pytest.mark.parametrize("kind", ["int8 kv", "int8 weights", "moe"])
@pytest.mark.parametrize("grid", list(TOKEN_GRIDS))
def test_grid_weights_kv_and_moe_match_deft_tpu(grids, reference, grid, kind):
    """int8 KV (B4p / B11's int8 form on the windows), int8-pallas weights
    (the window's rows through the int8 products) and the tiny MoE preset
    (on 2x2x1 its prefill's 520 tokens split over sp, h joined over sp
    before the expert-parallel block; its decode rows over dp)."""
    tokens, _ = grids[grid][kind]
    assert len(tokens) == 3 and tokens == reference[kind]


@pytest.mark.parametrize("grid", list(TOKEN_GRIDS))
def test_counted_rows_per_rank(grids, grid):
    """Each rank's rows through the dense layers: the prefill's N tokens
    padded to a multiple of sp, over sp; the decode step's plan rows over
    dp; the ragged prefill's N tokens on every rank."""
    dp, sp, _ = TOKEN_GRIDS[grid]
    ranks = grids[grid]["rows"]
    N, N_all = len(ROWS_PROMPTS[0]), sum(map(len, ROWS_PROMPTS))
    assert len(ranks) == dp * sp * TOKEN_GRIDS[grid][2]
    for r in ranks:
        assert r["prefill"] == -(-N // sp)
        assert r["decode"] == r["l_pad"] // dp
        assert r["ragged"] == N_all
