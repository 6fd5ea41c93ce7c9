"""The one traffic generator every cell's data file parameterises.

A cell draws a fixed pool of requests from its own ``pool_seed``: prompt
lengths spread evenly over ``prompt_tokens`` (inclusive, BOS and EOS
counted), token ids uniform over the text vocabulary, speakers evenly over
the baked ones, one sampling seed each. The model's weights are fixed by the
configuration too, so a request's output length, which the model decides by
its EOS, is a property of the pool and not of ``--seed``. ``--seed`` orders
the pool (a fresh permutation each time the pool is cycled), so that every
seed runs the same sizes in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int            # position in the pool: the request's fixed identity
    tokens: tuple         # [BOS, ids..., EOS]
    speaker: int
    seed: int             # the request's sampling seed (int32)


def pool(traffic: dict, hp: dict) -> List[Request]:
    """The cell's request pool (``pool_size`` requests from ``pool_seed``)."""
    rng = np.random.default_rng(traffic["pool_seed"])
    n = int(traffic["pool_size"])
    lo, hi = traffic["prompt_tokens"]
    lengths = np.rint(np.linspace(lo, hi, n)).astype(int)
    rng.shuffle(lengths)
    speakers = np.arange(n) % hp["num_speakers"]
    rng.shuffle(speakers)
    bos, eos = hp["text_bos_id"], hp["text_eos_id"]
    out = []
    for i, length in enumerate(lengths):
        ids = rng.integers(2, min(bos, eos), size=int(length) - 2).tolist()
        out.append(Request(i, tuple([bos] + ids + [eos]), int(speakers[i]),
                           int(rng.integers(0, 2**31 - 1))))
    return out


def order(requests: List[Request], seed: int) -> Iterator[Request]:
    """The pool in the seed's order, cycled, each cycle permuted afresh."""
    rng = np.random.default_rng([seed % 2**64, 1])
    while True:
        for i in rng.permutation(len(requests)):
            yield requests[int(i)]


def sample(n_total: int, k: int, seed: int, always=()) -> List[int]:
    """``k`` indices of ``n_total`` drawn from the seed, ``always`` included."""
    rng = np.random.default_rng([seed % 2**64, 3])
    rest = [i for i in rng.permutation(n_total).tolist() if i not in set(always)]
    return sorted(set(always) | set(rest[:max(0, k - len(set(always)))]))

