"""device.idle_share.<cell kind>: the share of the traced window in which no
operation ran on the card (the first card's timeline averaged over the
cards used), in %. One reader for every name under this prefix."""

from portbench.metrics._shared import idle_share


def read(run):
    return idle_share(run)
