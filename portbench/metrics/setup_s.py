"""Process start to the window's start: the weights, the engine's build
(kernels, graph capture), the shape warm-up and the mix's own warm-up."""


def read(run):
    return run.setup_s
