"""The generator: a seed repeats its traffic exactly, and every seed gets
the same set of sizes and gaps."""

import numpy as np
import pytest

from portbench import catalog, traffic

CHAT = catalog.mix("chat")
LONG = catalog.mix("decode_long")


def _key(plan):
    return [(p.prompt.tolist(), p.max_new, p.due_s, p.in_window) for p in plan]


def test_open_loop_repeats_exactly():
    a = traffic.open_loop(CHAT, 6.8, 51, 3_000_000_001, 102400)
    b = traffic.open_loop(CHAT, 6.8, 51, 3_000_000_001, 102400)
    assert _key(a) == _key(b)


def test_closed_loop_repeats_exactly():
    a = traffic.closed_loop(LONG, 2**31 + 5, 1000, count=64)
    b = traffic.closed_loop(LONG, 2**31 + 5, 1000, count=64)
    assert _key(a) == _key(b)


@pytest.mark.parametrize("seeds", [(1, 2), (7, 2**32 + 1)])
def test_seeds_share_sizes_and_gaps(seeds):
    plans = [traffic.open_loop(CHAT, 4.4, 51, s, 50304) for s in seeds]
    wins = [[p for p in plan if p.in_window] for plan in plans]
    assert len(wins[0]) == len(wins[1]) == round(4.4 * 51)
    for get in (lambda p: len(p.prompt), lambda p: p.max_new):
        assert sorted(map(get, wins[0])) == sorted(map(get, wins[1]))
    g = traffic.gaps(4.4, 224, 51.0)
    assert abs(g.sum() - 51.0) < 1e-9 and abs(g.mean() - 1 / 4.4) < 0.02 / 4.4
    assert [p.prompt.tolist() for p in wins[0]] != [p.prompt.tolist() for p in wins[1]]


def test_window_part_fills_its_seconds():
    plan = traffic.open_loop(CHAT, 6.8, 51, 9, 1000)
    win = [p.due_s for p in plan if p.in_window]
    assert CHAT["warmup_s"] <= min(win) and max(win) < CHAT["warmup_s"] + 51


def test_sizes_follow_their_distribution():
    s = traffic.sizes(CHAT["prompt_tokens"], 1001)
    assert s.min() >= 64 and s.max() <= 2048 and int(np.median(s)) == 512
    u = traffic.sizes(LONG["prompt_tokens"], 513)
    assert u.min() == 1536 and u.max() == 2048
    assert set(traffic.sizes(LONG["output_tokens"], 5)) == {512}


def test_blocks_hold_the_whole_spread():
    vals = np.arange(80)
    out = traffic.blocked(vals, 8, np.random.default_rng(0))
    assert sorted(out) == list(vals)
    for b in range(10):
        block = out[8 * b:8 * b + 8]
        assert block.min() < 10 and block.max() >= 70


def test_closed_loop_staggers_first_budgets():
    plan = traffic.closed_loop(LONG, 1, 1000, count=40)
    first = [p.max_new for p in plan[:32]]
    assert first == sorted(first) and first[0] == 16 and first[-1] == 512
    assert {p.max_new for p in plan[32:]} == {512}


def test_warm_shapes_form_every_batch():
    warm = traffic.warm_shapes([256, 2048], [1, 2, 4], 5, 1000)
    assert [len(p.prompt) for p in warm] == [256] * 7 + [2048] * 7


def test_chat_order_is_free_of_blocks():
    """The chat mix deals no blocks: over a window, some run of eight
    consecutive requests holds two prompts from the longest eighth, and
    some holds two gaps from the shortest eighth (a burst)."""
    plan = [p for p in traffic.open_loop(CHAT, 6.8, 51, 2**31 + 11, 1000) if p.in_window]
    lens = np.array([len(p.prompt) for p in plan])
    due = np.array([p.due_s for p in plan])
    gaps = np.diff(due)
    long_ = lens >= np.quantile(lens, 7 / 8)
    short = gaps <= np.quantile(gaps, 1 / 8)
    assert max(long_[i:i + 8].sum() for i in range(len(lens) - 8)) >= 2
    assert max(short[i:i + 8].sum() for i in range(len(gaps) - 8)) >= 2
