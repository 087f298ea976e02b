"""Staging-ladder reruns (one K1 launch each) per hundred frames of the
traced slice, from the measured package's `ec.rerun` counter."""

from core import port_trace


def read(r):
    return port_trace.per_frame_pct("ec.rerun")
