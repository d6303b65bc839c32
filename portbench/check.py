"""The comparison that decides ``correct``: what the timed path served,
against the plain reference.

After the window, a sample of the finished requests, drawn from the seed
with the longest among them, is run through the reference once each,
teacher-forced on its prompt and its served tokens. At every served
position the reading is how far the served token's reference logit lies
below the reference's best there; the number compared is the widest of
these over the sample (0 where every served token is the reference's own
argmax). The control (``fp8=True``) reads, at the same positions, the gap
of the token that the reference computed in float8 would put first.

Both the widest gap and the mean gap over every served token compared
are read; a cell's file names which of them it holds to a limit.

A MoE request is run with the rows it was admitted beside, in their row
order, since an expert's capacity at admission is shared by the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref
from portbench.system import bucket_of


def sample(records, n: int, seed: int) -> list:
    """Up to n finished requests: the longest (prompt + output), then a
    draw from the seed among the rest."""
    if not records:
        return []
    longest = max(records, key=lambda r: (len(r.prompt) + r.max_new, -r.rid))
    rest = [r for r in records if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def admission_of(rec, admissions, by_rid, cfg: dict):
    """(bucket, rows in order, their prompt lengths, the record's row) of
    the admission batch that took ``rec``; a dense model's rows do not
    interact, so it runs alone."""
    if cfg["family"] == "moe":
        for _, bucket, rids, lens in admissions:
            if rec.rid in rids:
                return bucket, [by_rid[r] for r in rids], lens, rids.index(rec.rid)
        raise KeyError(f"request {rec.rid} was served but no admission batch took it")
    n = len(rec.prompt)
    return bucket_of(n, cfg["serving"]["prefill_buckets"]), [rec], [n], 0


def widest_gaps(cfg: dict, params: dict, recs, admissions, by_rid, device,
                control: bool = False) -> dict:
    """{"max_logit_gap", "mean_logit_gap": the widest and the mean
    served-token gap over ``recs``, "tokens": served tokens compared,
    "dropped" of "claims": expert choices the reference dropped at
    admission of those its admissions made, and with ``control`` the same
    two gaps of the control's first choices, "control_max_logit_gap" and
    "control_mean_logit_gap"}."""
    out = {"max_logit_gap": 0.0, "mean_logit_gap": 0.0, "tokens": 0, "dropped": 0,
           "claims": 0}
    total = control_total = 0.0
    if control:
        out["control_max_logit_gap"] = 0.0
    for rec in recs:
        bucket, rows, lens, at = admission_of(rec, admissions, by_rid, cfg)
        served = list(rec.q.tokens)
        n, m = len(rec.prompt), len(served)
        seqs = [torch.as_tensor(np.asarray(r.prompt, dtype=np.int64), device=device)
                for r in rows]
        seqs[at] = torch.as_tensor(np.concatenate([np.asarray(rec.prompt, dtype=np.int64),
                                                   np.asarray(served[:-1], dtype=np.int64)]),
                                   device=device)
        got = torch.as_tensor(served, dtype=torch.long, device=device)
        lg, dropped = ref.logits(cfg, params, seqs, lens, bucket, at, n - 1, n + m - 1)
        top = lg.max(-1).values
        gap = top - lg.gather(1, got[:, None])[:, 0]
        out["max_logit_gap"] = max(out["max_logit_gap"], float(gap.max()))
        total += float(gap.sum())
        out["tokens"] += m
        out["dropped"] += dropped
        if cfg["family"] == "moe":
            out["claims"] += sum(lens) * cfg["num_experts_per_tok"] * cfg["num_hidden_layers"]
        if control:
            c, _ = ref.logits(cfg, params, seqs, lens, bucket, at, n - 1, n + m - 1, fp8=True)
            cgap = top - lg.gather(1, c.argmax(-1)[:, None])[:, 0]
            out["control_max_logit_gap"] = max(out["control_max_logit_gap"], float(cgap.max()))
            control_total += float(cgap.sum())
            del c
        del lg
    if out["tokens"]:
        out["mean_logit_gap"] = total / out["tokens"]
        if control:
            out["control_mean_logit_gap"] = control_total / out["tokens"]
    return out
