"""The card's idle share of the traced stretch, in percent: 1 - the union
of every operation's interval on the card over the stretch's length."""

from portbench.yardstick import clip, union_ns


def read(run):
    if run.ops is None:
        return None
    a, b = run.dev_window
    return 100.0 * (1.0 - union_ns(clip([(s, e) for _, s, e in run.ops], a, b)) / (b - a))
