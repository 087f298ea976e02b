"""Share of the traced slice in which no device operation ran (union of
device intervals)."""

from core import readers


def read(r):
    return readers.idle_pct(r)
