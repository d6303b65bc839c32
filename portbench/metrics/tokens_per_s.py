"""Output tokens delivered to the clients in the window over its seconds."""


def read(run):
    return sum(1 for _ in run.tokens_between(run.t0, run.t1)) / run.window_s
