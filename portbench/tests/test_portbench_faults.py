"""A whole run at a tiny size on the CPU (the look for a card skipped):
sound, it comes out correct; with the timed path broken underneath, its
comparison with the reference comes out false. The faults a serving cell
can have: a token altered where it is produced, and a decode step that
leaves the state unchanged (its KV writes dropped)."""

import time

import pytest

import vtpu_torch.serving.engine as engine_mod
from portbench import harness
from tiny import tiny_cell

SEED = 3_000_000_019


def _run(cell, seconds=1.5):
    return harness.run_cell(cell, SEED, seconds, False, time.monotonic_ns(), device="cpu",
                            log=lambda msg: None)


@pytest.mark.parametrize("family,loop", [("dense", "open"), ("dense", "closed"),
                                         ("moe", "open")])
def test_sound_run_is_correct(family, loop):
    limits = {"mean_logit_gap": 0.01} if family == "moe" else None
    r = _run(tiny_cell(family, loop, limits))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


def test_altered_token_is_caught(monkeypatch):
    emit = engine_mod.ServingEngine._emit

    def altered(self, slot, tok, lp=None, now=None):
        if self._slot_req[slot].delivered == 2:
            tok = (tok + 1) % self.cfg.vocab
        return emit(self, slot, tok, lp, now)

    monkeypatch.setattr(engine_mod.ServingEngine, "_emit", altered)
    r = _run(tiny_cell("dense", "open"))
    assert not r["correct"]
    assert r["checks"]["max_logit_gap"]["value"] > r["checks"]["max_logit_gap"]["limit"]


def test_unchanged_state_is_caught(monkeypatch):
    monkeypatch.setattr(engine_mod, "store_kv", lambda *a, **k: None)
    r = _run(tiny_cell("dense", "closed"))
    assert not r["correct"]
    assert r["checks"]["max_logit_gap"]["value"] > r["checks"]["max_logit_gap"]["limit"]


def test_lost_requests_are_caught():
    cell = tiny_cell("dense", "open")
    cell["mix"]["drain_s"] = 0.0  # nothing due late in the window can finish
    cell["params"]["rate_per_s"] = 40.0
    r = _run(cell, seconds=1.0)
    assert r["failed"] > 0 and not r["correct"]
