"""Percent of the traced stretch in which the card ran nothing while the
serving loop worked on the host: the tick head's admission work, the
dispatch, the delivery or the swap drain (``loopclock.HOST_PHASES``), each
phase from the engine's trace ring moved onto the device's clock."""

from portbench.loopclock import HOST_PHASES, share


def read(run):
    return share(run, HOST_PHASES)
