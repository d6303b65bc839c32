"""The benchmark's yardstick: the card's peaks, the statistics a metric is
taken with, and the operations and bytes each kernel and the whole model
step need, computed from shapes.

Plain Python only, so the arithmetic is the same wherever it
runs and later changes to the program cannot move it. The kernel
arithmetic follows the rule the kernel table of PERF.md uses: each input
byte read once, each output byte written once, whatever a kernel reads
again; where the work depends on the data (a causal mask, a sequence's
length) count what these inputs need.
"""

from __future__ import annotations

import math

# one NVIDIA H100 SXM: NVIDIA's data sheet, dense rates, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ALL the samples, by linear
    interpolation between closest ranks (numpy's default)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no samples")
    pos = (len(vals) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def union_ns(intervals) -> int:
    """Length of the union of [start, end) intervals (ns)."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip(intervals, lo: int, hi: int) -> list:
    """Intervals cut to [lo, hi); those outside it dropped."""
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return out


def idle_gaps(intervals, lo: int, hi: int) -> list:
    """(gap ns, start ns) of every stretch of [lo, hi) that no interval
    covers, longest first."""
    gaps, at = [], lo
    for s, e in sorted(clip(intervals, lo, hi)):
        if s > at:
            gaps.append((s - at, at))
        at = max(at, e)
    if hi > at:
        gaps.append((hi - at, at))
    return sorted(gaps, reverse=True)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over peak
    bandwidth and operations over the bf16 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


# ------------------------------------------------------------ kernels


def flash_call(n: int, s: int, h: int, dh: int) -> tuple[int, int]:
    """(bytes, flops) of one causal flash-attention call on q, k, v of
    [n, s, h, dh] bf16: q, k, v read once and o written once; QK^T and PV
    over the causal half, s (s + 1) / 2 pairs a head."""
    nbytes = 4 * n * s * h * dh * BF16
    flops = 4 * n * h * dh * s * (s + 1) // 2
    return nbytes, flops


def paged_row(kv_len: int, h: int, dh: int, page: int) -> tuple[int, int]:
    """(bytes, flops) one row of a decode tick's paged call adds for one
    layer: its kv_len keys and values read once (bf16), its query row read
    and its output row written, the page-table entries its length needs
    and its length. The operations: QK and PV over kv_len keys."""
    keys_bytes = kv_len * h * dh * BF16 * 2
    qo_bytes = 2 * h * dh * BF16
    table_bytes = -(-kv_len // page) * 4 + 4
    return keys_bytes + qo_bytes + table_bytes, 4 * kv_len * h * dh


# ------------------------------------------------------------ model step


def matmul_params_per_token(cfg: dict) -> int:
    """Weights one token multiplies through in the layers (attention
    projections and the MLP, or the routed experts it is sent to and the
    router), not counting the output head."""
    d = cfg["hidden_size"]
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    attn = 4 * d * qd
    if cfg["family"] == "moe":
        ffn = cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"] + d * cfg["num_experts"]
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn)


def token_flops(cfg: dict, context: int) -> int:
    """Model FLOPs of one token at ``context`` keys (itself included),
    without the output head: 2 x the weights it multiplies through, and
    QK and PV over its context in every layer."""
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    return 2 * matmul_params_per_token(cfg) + 4 * cfg["num_hidden_layers"] * qd * context


def head_flops(cfg: dict) -> int:
    """The output head's FLOPs for one token's logits."""
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def prompt_flops(cfg: dict, n: int) -> int:
    """Model FLOPs of a prompt of n tokens: every position through the
    layers at its causal context, and the head at the last position (the
    only logits an admission computes)."""
    per = 2 * matmul_params_per_token(cfg) * n
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    attn = 4 * cfg["num_hidden_layers"] * qd * n * (n + 1) // 2
    return per + attn + head_flops(cfg)


def decode_flops(cfg: dict, context: int) -> int:
    """Model FLOPs of one decoded token at ``context`` keys, head included."""
    return token_flops(cfg, context) + head_flops(cfg)
