"""The one traffic generator: a mix file of parameters and a seed in, the
requests out.

A mix (``portbench/mixes/<name>.json``) names its loop and its length
distributions:

- ``"loop": "open"``: requests arrive on a schedule whatever the engine
  does, at the cell's ``rate_per_s``, Poisson (exponential gaps). The
  arrivals start ``warmup_s`` before the measured window; the requests due
  inside the window are the sample.
- ``"loop": "closed"``: ``clients`` callers, each sending its next request
  when its last one ends. Their first requests carry budgets staggered
  over [16, the output length] so that the callers fall out of step
  before the window opens ``warmup_s`` later.

``prompt_tokens`` and ``output_tokens`` are distributions: ``{"dist":
"lognormal", "median", "sigma", "min", "max"}``, ``{"dist": "uniform",
"min", "max"}`` (integers, both ends included) or ``{"dist": "fixed",
"value"}``. Token ids are uniform over the configuration's vocabulary.

Every seed gets the same set of sizes and gaps in another order: sizes
and gaps are the distribution's quantiles at evenly spaced levels, each
set in an order of its own drawn from the seed (and the token ids too).
So two seeds offer the same work over the window, and a difference
between their runs is the system's or the order's; the order is free, so
bursts of short gaps and runs of long prompts come as they would from
independent draws. A mix may set ``block``: the sets are then dealt into
blocks of that many consecutive requests, each holding the whole spread
of sizes, and only the blocks and the order inside each are drawn (a
closed loop's callers take their prompts so, and no two seeds' callers
pile up long prompts differently).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Optional

import numpy as np

# requests a closed loop draws its sizes from, in order; more than any
# window at any rate consumes
CLOSED_POOL = 1024
# the least budget of a closed loop's staggered first requests
STAGGER_MIN = 16


@dataclasses.dataclass
class Planned:
    idx: int
    prompt: np.ndarray  # int32 token ids
    max_new: int
    due_s: Optional[float] = None  # open loop: seconds after the stream starts
    in_window: bool = False


def _levels(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def sizes(spec: dict, n: int) -> np.ndarray:
    """n integer sizes at evenly spaced quantile levels of ``spec``."""
    u = _levels(n)
    kind = spec["dist"]
    if kind == "fixed":
        return np.full(n, int(spec["value"]), dtype=np.int64)
    if kind == "uniform":
        lo, hi = int(spec["min"]), int(spec["max"])
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(np.int64)
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        vals = np.round(spec["median"] * np.exp(spec["sigma"] * z))
        return np.clip(vals, spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown distribution {kind!r}")


def size_range(spec: dict) -> tuple[int, int]:
    """The least and the most a distribution gives."""
    if spec["dist"] == "fixed":
        return int(spec["value"]), int(spec["value"])
    return int(spec["min"]), int(spec["max"])


def gaps(rate: float, n: int, span: float) -> np.ndarray:
    """n exponential inter-arrival gaps at evenly spaced quantile levels,
    scaled to fill ``span`` seconds exactly (their mean is 1 / rate up to
    the quantiles' rounding)."""
    g = -np.log1p(-_levels(n)) / rate
    return g * (span / g.sum())


def blocked(values: np.ndarray, block: int, rng: np.random.Generator) -> np.ndarray:
    """``values`` (ascending) in an order drawn from ``rng``. With ``block``
    over 1, dealt into blocks of ``block``: value i to block i mod (number
    of blocks), so each block spans the whole range; each block shuffled,
    the blocks in a shuffled order."""
    if block <= 1:
        return rng.permutation(values)
    nb = max(1, -(-len(values) // block))
    parts = [rng.permutation(values[j::nb]) for j in range(nb)]
    return np.concatenate([parts[j] for j in rng.permutation(nb)])


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def _prompt(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, size=n, dtype=np.int64).astype(np.int32)


def open_loop(mix: dict, rate: float, seconds: float, seed: int, vocab: int) -> list[Planned]:
    """The open loop's schedule: the warm-up's requests, then the window's,
    each part with its own fixed set of sizes and gaps, permuted by the
    seed."""
    out: list[Planned] = []
    t = 0.0
    for part, span in enumerate((mix["warmup_s"], seconds)):
        n = max(1, round(rate * span))
        rng = _rng(seed, part)
        block = int(mix.get("block", 1))
        g = blocked(gaps(rate, n, span), block, rng)
        p = blocked(sizes(mix["prompt_tokens"], n), block, rng)
        o = blocked(sizes(mix["output_tokens"], n), block, rng)
        due = t + np.cumsum(g) - g  # the first request at the part's start
        for i in range(n):
            out.append(Planned(len(out), _prompt(rng, int(p[i]), vocab), int(o[i]),
                               due_s=float(due[i]), in_window=part == 1))
        t += span
    return out


def closed_loop(mix: dict, seed: int, vocab: int, count: int = CLOSED_POOL) -> list[Planned]:
    """The closed loop's requests in the order the callers take them: the
    first ``clients`` are the callers' first requests, with staggered
    budgets; the rest come from one fixed set of sizes permuted by the
    seed."""
    rng = _rng(seed, 2)
    clients = int(mix["clients"])
    block = int(mix.get("block", 1))
    p = blocked(sizes(mix["prompt_tokens"], count), block, rng)
    o = blocked(sizes(mix["output_tokens"], count), block, rng)
    top = size_range(mix["output_tokens"])[1]
    out = []
    for i in range(count):
        budget = int(o[i])
        if i < clients:
            budget = max(STAGGER_MIN, math.ceil(top * (i + 1) / clients))
        out.append(Planned(i, _prompt(rng, int(p[i]), vocab), budget))
    return out


def warm_shapes(buckets: list[int], batch_sizes: list[int], seed: int,
                vocab: int) -> list[Planned]:
    """Prompts that, submitted together before the loop starts, form one
    admission of every (bucket, batch size): for each bucket as many
    prompts as the sizes sum to, each one token long of budget. Admission
    takes the largest size that fits what waits, so sum(sizes) prompts of
    a bucket form one batch of each size."""
    rng = _rng(seed, 3)
    out = []
    for b in buckets:
        for _ in range(sum(batch_sizes)):
            out.append(Planned(len(out), _prompt(rng, b, vocab), 1))
    return out
