"""The traced run starts and stops its profiler on the engine's loop
thread, at its tick head (``devtrace.on_loop``): a tiny engine on the CPU."""

import threading

import pytest

from portbench import devtrace, system
from tiny import tiny_cfg

SEED = 3_000_000_053


@pytest.fixture
def engine():
    cfg = tiny_cfg("dense")
    eng = system.build_engine(cfg, system.make_params(cfg, SEED, "cpu"), "cpu")
    yield eng
    eng.stop()


def test_runs_on_the_loop_thread_and_chains_the_hook(engine):
    seen = []
    engine._ledger_hook = lambda e: seen.append(threading.get_ident())
    engine.start()
    assert devtrace.on_loop(engine, threading.get_ident, timeout_s=30) == engine._thread.ident
    assert seen and set(seen) == {engine._thread.ident}
    assert devtrace.on_loop(engine, lambda: 7, timeout_s=30) == 7
    assert engine._ledger_hook is not None and engine._ledger_hook.__name__ == "<lambda>"


def test_hands_back_what_the_step_raises(engine):
    engine.start()

    def fails():
        raise ValueError("on the loop")

    with pytest.raises(ValueError, match="on the loop"):
        devtrace.on_loop(engine, fails, timeout_s=30)
    assert engine._ledger_hook is None
    assert devtrace.on_loop(engine, lambda: "still ticking", timeout_s=30) == "still ticking"


def test_a_loop_that_is_not_running_is_not_waited_for(engine):
    with pytest.raises(RuntimeError, match="not running"):
        devtrace.on_loop(engine, lambda: None, timeout_s=30)
    engine.start()
    engine.stop()
    with pytest.raises(RuntimeError, match="not running"):
        devtrace.on_loop(engine, lambda: None, timeout_s=30)


def test_a_loop_that_never_reaches_its_tick_head_times_out(engine, monkeypatch):
    engine.start()
    held = threading.Event()
    monkeypatch.setattr(engine, "_ledger_hook", lambda e: held.wait(5))
    try:
        with pytest.raises(RuntimeError, match="did not run a step"):
            devtrace.on_loop(engine, lambda: None, timeout_s=0.3)
    finally:
        held.set()
