"""Frames decoded in bfloat16 a second over the whole window (host
clock)."""

from core import readers


def read(r):
    return readers.rate(r)
