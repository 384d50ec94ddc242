"""Port of deft_tpu/runtime/sampling.py:24 (SamplingParams) and :46
(sample_token): a copy, with the same behaviour, owned by deft_tpu_torch.

Sampling parameters + top-k/top-p/temperature sampling over a LogitsView.

Parity surface: DeFT's deft/sampling_params.py:9-87 (the reference defines
the container but never wires it — its branch controllers do top-k/argmax
directly).  Here ``sample_token`` is the live path: workloads accepting a
``sampling_params`` kwarg (control/workloads.py simple_tree) sample leaf
continuations through it instead of argmax.

The decode step copies top-K probabilities (softmax + 1e-6) per leaf to the
host (runtime/runner.py LogitsView); sampling re-weights those K candidates
in numpy.  Temperature is applied as p^(1/T) renormalized, equivalent to
softmax(logits / T) over the kept candidates (up to the +1e-6 floor).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np


@dataclasses.dataclass
class SamplingParams:
    n: int = 1
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    ignore_eos: bool = False
    max_new_tokens: int = 16
    stop: Optional[Union[str, List[str]]] = None

    def verify(self) -> None:
        if self.temperature < 0.0:
            raise ValueError("temperature must be non-negative")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < -1 or self.top_k == 0:
            raise ValueError("top_k must be -1 (disable) or >= 1")
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")


def sample_token(
    view,
    row: int,
    params: SamplingParams,
    rng: np.random.RandomState,
) -> tuple:
    """Sample one token for leaf ``row`` from the step's top-K candidates.

    Returns (token_id, prob) where prob is the *pre-temperature* model
    probability of the sampled token (what PPL accounting wants).
    """
    params.verify()
    k = view.k if params.top_k < 0 else min(params.top_k, view.k)
    probs, ids = view.topk(row, k)
    probs = np.asarray(probs, dtype=np.float64)
    if params.temperature == 0.0:
        return int(ids[0]), float(probs[0])
    # log-space: probs ** (1/T) underflows to all-zeros at small T (e.g.
    # 0.2**500 == 0.0), which would make w/w.sum() NaN; subtracting the max
    # log-weight first keeps the top candidate at weight 1.0 exactly
    logw = np.log(np.maximum(probs, 1e-300)) / params.temperature
    w = np.exp(logw - logw.max())
    if params.top_p < 1.0:
        # nucleus over the model distribution (rows are descending-prob)
        keep = np.cumsum(probs) - probs < params.top_p * probs.sum()
        keep[0] = True
        w = np.where(keep, w, 0.0)
    w = w / w.sum()
    c = int(rng.choice(len(w), p=w))
    return int(ids[c]), float(probs[c])
