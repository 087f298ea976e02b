"""The window's NN FLOPs (counts/flops_<config>.json) a second, in % of one
card's dense bfloat16 tensor-core peak."""

from core import readers


def read(r):
    return readers.mfu_pct(r, "bfloat16_flops_per_s")
