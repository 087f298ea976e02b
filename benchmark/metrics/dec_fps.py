"""Decoded frames a second over the whole window (host clock)."""

from core import readers


def read(r):
    return readers.rate(r)
