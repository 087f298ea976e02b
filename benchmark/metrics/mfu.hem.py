"""The window's NN FLOPs (counts/flops_<config>.json) a second, in % of one
card's float32 peak."""

from core import readers


def read(r):
    return readers.mfu_pct(r)
