#!/usr/bin/env python3
"""Probe how the flagship SSM's streams depend on which prompts the engine
admits together, on the card.

    python3 hack/torch_ssm_admission_probe.py [--waves 30] [--json PATH]

chip_smoke.py's phase k serves the flagship SSM (bf16, four slots, one
1024-token prefill bucket) on the pipelined loop and on ``decode_loop_k=8``
and holds every stream against the plain recurrence teacher-forced on it.
Which prompts share an admission dispatch ([1, 1024] or [2, 1024]) depends
on when each submit reaches the loop, so a dependence of a row's result on
its batch shows as a phase that fails now and then. Three parts, on the
six wave prompts (600-1024 tokens from SEED):

- ``compositions``: each prompt admitted alone, beside each other prompt,
  and in sampled batches of three and four (``SsmSlotModel.prefill_into_slots``,
  random slots of a four-slot state), then 15 decode steps fed the plain
  reference's greedy tokens; per prompt, the largest logit deviation from
  the reference (the prompt prefilled alone at its own length) and the
  steps whose token differs where the reference's top-1/top-2 margin is at
  least chip_smoke.FORCED_MARGIN.
- ``ops``: prompt 4 in batches of one to four, every intermediate of every
  layer (``ssm_layer``'s steps) against the batch of one's, and the pair
  once more with torch's allow_bf16_reduced_precision_reduction off.
- ``engines``: the two phase-k engines, built and started as phase k
  builds them, serving ``--waves`` waves each with three submit patterns
  (all at once, 0-4 ms apart, half of them 0-30 ms apart); every stream
  held as phase k holds it, each failure printed with the wave's
  admission batches.

Prints one line a part and, last, a JSON summary (also written to
``--json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import random
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from vtpu_torch.models import SSMConfig, init_ssm_params  # noqa: E402
from vtpu_torch.models import ssm as S  # noqa: E402
from vtpu_torch.models.transformer import rms_norm  # noqa: E402
from vtpu_torch.serving import ServingConfig, ServingEngine  # noqa: E402
from vtpu_torch.serving.adapters import SsmSlotModel  # noqa: E402

STEPS = cs.FAMILY_TOKENS


def reference(params, cfg, p):
    """The prompt prefilled alone at its own length, then greedy: its tokens
    and the [STEPS, vocab] logits."""
    logits, st = S.ssm_prefill(params, cfg, torch.from_numpy(p[None]).cuda(), len(p),
                               logits_at=torch.tensor([len(p) - 1], device="cuda"))
    rows, toks = [logits[0]], []
    for i in range(STEPS):
        toks.append(int(torch.argmax(rows[-1])))
        if i + 1 < STEPS:
            logits, st = S.ssm_decode_step(params, cfg, st, torch.tensor(
                [toks[-1]], dtype=torch.int32, device="cuda"))
            rows.append(logits[0])
    return toks, torch.stack(rows)


def compositions(params, cfg, prompts, refs, margins) -> list:
    model = SsmSlotModel(params, cfg)
    rs = random.Random(0)
    comps = [(i,) for i in range(6)] + list(itertools.permutations(range(6), 2))
    comps += [tuple(rs.sample(range(6), 3)) for _ in range(10)]
    comps += [tuple(rs.sample(range(6), 4)) for _ in range(10)]
    out = []
    for comp in comps:
        state = model.init_state(4)
        slots = rs.sample(range(4), len(comp))
        padded = np.zeros((len(comp), cs.FAMILY_BUCKET), np.int32)
        for j, i in enumerate(comp):
            padded[j, :len(prompts[i])] = prompts[i]
        last, state = model.prefill_into_slots(
            params, state, torch.from_numpy(padded).cuda(), torch.tensor(slots, device="cuda"),
            torch.tensor([len(prompts[i]) for i in comp], device="cuda"))
        rows = {i: [last[j]] for j, i in enumerate(comp)}
        for t in range(1, STEPS):
            tok = torch.zeros(4, dtype=torch.int32, device="cuda")
            act = torch.zeros(4, dtype=torch.bool, device="cuda")
            for j, i in enumerate(comp):
                tok[slots[j]] = refs[i][0][t - 1]
                act[slots[j]] = True
            logits, state = model.decode_step(params, state, tok, act, 0)
            for j, i in enumerate(comp):
                rows[i].append(logits[slots[j]])
        dev, flips = {}, []
        for i, rr in rows.items():
            got = torch.stack(rr)
            dev[i] = float((got - refs[i][1]).abs().max())
            flips += [(i, t) for t in range(STEPS) if int(torch.argmax(got[t])) != refs[i][0][t]
                      and margins[i][t] >= cs.FORCED_MARGIN]
        out.append({"comp": comp, "slots": slots, "max_dev": dev, "flips": flips})
    return out


def layer_ops(lp, x) -> dict:
    """Every intermediate of ssm_layer on x [N, S, D]."""
    out = {"normed": rms_norm(x, lp["norm"])}
    out["in_proj"] = out["normed"] @ lp["in_proj"]
    xi_raw, z = out["in_proj"].chunk(2, dim=-1)
    out["conv"] = S._causal_conv(xi_raw, lp["conv_w"])
    xi = F.silu(out["conv"].float()).to(x.dtype)
    a, b, c = S._selective_mix(lp, xi)
    out["a"], out["b"] = a, b
    out["h"] = S._scan_states(a, b)
    y = torch.einsum("bsdn,bsn->bsd", out["h"], c)
    out["readout"] = y
    y = ((y + xi.float() * lp["d_skip"].float()) * F.silu(z.float())).to(x.dtype)
    out["out_proj"] = y @ lp["out_proj"]
    out["x"] = x + out["out_proj"]
    return out


def ops(params, cfg, prompts) -> dict:
    def run(rows):
        padded = np.zeros((len(rows), cs.FAMILY_BUCKET), np.int32)
        for j, i in enumerate(rows):
            padded[j, :len(prompts[i])] = prompts[i]
        x = params["embed"][torch.from_numpy(padded).cuda()].to(cfg.dtype)
        per = []
        for layer in range(cfg.n_layers):
            o = layer_ops(S._layer(params, layer), x)
            per.append({k: v[0, :len(prompts[rows[0]])].float() for k, v in o.items()})
            x = o["x"]
        return per

    def dev(a, b):
        return [{k: float((x[k] - y[k]).abs().max()) for k in x} for x, y in zip(a, b)]

    out = {}
    one = run([4])
    for rows in ([4, 0], [4, 0, 1], [4, 0, 1, 2]):
        out[str(rows)] = dev(one, run(rows))
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        out["[4, 0] reduced-precision reduction off"] = dev(run([4]), run([4, 0]))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return out


def engines(params, cfg, prompts, waves: int) -> dict:
    ref = cs.ssm_forced_trunk(params, cfg)
    serving = ServingConfig(slots=4, prefill_buckets=(cs.FAMILY_BUCKET,), max_new_tokens=STEPS)
    kinds = {"pipelined": {}, "device_loop": {"decode_loop_k": cs.LOOP_K}}
    built, log = {}, {}
    for name, kw in kinds.items():
        eng = ServingEngine(model=SsmSlotModel(params, cfg),
                            serving=dataclasses.replace(serving, **kw))
        log[name] = []
        admit = eng._admit_batch

        def logged(slots, reqs, bucket, _admit=admit, _log=log[name]):
            _log.append((tuple(slots), tuple(r.rid for r in reqs)))
            return _admit(slots, reqs, bucket)

        eng._admit_batch = logged
        built[name] = eng
        eng.start()
    rs = random.Random(1)
    fails = []
    try:
        for eng in built.values():
            cs.stream_all(eng, [prompts[0]])
        for w in range(waves):
            for name in (list(kinds) if w % 2 == 0 else list(kinds)[::-1]):
                eng, mode, mark = built[name], w % 3, len(log[name])
                recs = [{"toks": []} for _ in prompts]
                threads = []
                for p, rec in zip(prompts, recs):
                    if mode == 1:
                        time.sleep(rs.random() * 0.004)
                    elif mode == 2 and rs.random() < 0.5:
                        time.sleep(rs.random() * 0.03)
                    req = eng.submit(p)
                    rec["rid"] = req.rid
                    th = threading.Thread(target=lambda r=req, rc=rec: rc["toks"].extend(
                        r.stream()), daemon=True)
                    th.start()
                    threads.append(th)
                for th in threads:
                    th.join(120)
                for i, (p, rec) in enumerate(zip(prompts, recs)):
                    want, m = ref(p, rec["toks"])
                    bad = [t for t, (g, x, mm) in enumerate(zip(rec["toks"], want, m))
                           if g != x and mm >= cs.FORCED_MARGIN]
                    if bad:
                        t = bad[0]
                        fails.append({"engine": name, "wave": w, "mode": mode, "prompt": i,
                                      "rid": rec["rid"], "token": t, "got": rec["toks"][t],
                                      "want": want[t], "margin": m[t],
                                      "admissions": log[name][mark:]})
                        print("FAIL", fails[-1], flush=True)
    finally:
        for eng in built.values():
            eng.stop()
    return {"waves": waves, "fails": fails,
            "batch_hist": {n: list(e.stats()["prefill_batch_hist"]) for n, e in built.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--waves", type=int, default=30, help="waves per engine")
    ap.add_argument("--json", default=None, help="write the summary here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = SSMConfig(**cs.SSM_FLAGSHIP, dtype=torch.bfloat16)
    params = init_ssm_params(cs.SEED, cfg, device="cuda")
    prompts = cs.wave_prompts(cfg.vocab)
    refs = [reference(params, cfg, p) for p in prompts]
    margins = [[float(x) for x in r.topk(2).values[:, 0] - r.topk(2).values[:, 1]]
               for _, r in refs]
    out = {"gpu": cs.gpu_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "ref_margins": margins}
    out["compositions"] = compositions(params, cfg, prompts, refs, margins)
    by_size: dict = {}
    for c in out["compositions"]:
        for i, d in c["max_dev"].items():
            key = f"{len(c['comp'])} rows, prompt {i}"
            by_size[key] = max(by_size.get(key, 0.0), d)
    out["max_dev_by_size"] = by_size
    print("compositions:", json.dumps(by_size), "flips:",
          [c for c in out["compositions"] if c["flips"]][:3], flush=True)
    out["ops"] = ops(params, cfg, prompts)
    print("ops, last layer:", json.dumps({k: v[-1] for k, v in out["ops"].items()}), flush=True)
    out["engines"] = engines(params, cfg, prompts, args.waves)
    out["seconds"] = time.perf_counter() - t0
    print("engines:", out["engines"]["waves"], "waves each,", len(out["engines"]["fails"]),
          "failed streams, batch hist", out["engines"]["batch_hist"], flush=True)
    line = json.dumps(out)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line)
    print(json.dumps({k: out[k] for k in ("gpu", "max_dev_by_size", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
