"""K2's least time (bytes at HBM bandwidth, counts/lane_rans.py) over its
device time in the traced slice."""

from core import readers


def read(r):
    return readers.k2_roofline_pct(r)
