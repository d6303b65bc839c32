"""Percent of the traced stretch in which the card ran nothing while the
serving loop was in its tick head's admission work (the ``admission``
phase of the engine's trace ring on the device's clock): the part of
``idle_host_share`` that admissions hold."""

from portbench.loopclock import share


def read(run):
    return share(run, ("admission",))
