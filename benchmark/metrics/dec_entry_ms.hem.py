"""Host ms a frame of the traced slice in the measured package's HEM
decode entry points, its own `intra_no_ar.decompress` and
`dmc_hem.decompress` spans (its trace's last session); nothing where the
package has neither span."""

from core import port_trace

ENTRIES = ("intra_no_ar.decompress", "dmc_hem.decompress")


def read(r):
    s = port_trace.session()
    if s is None or not any(n in s["spans"] for n in ENTRIES):
        return None
    return sum(port_trace.spans_ms(n) for n in ENTRIES)
