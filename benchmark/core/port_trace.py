"""Readings of the measured package's own trace
(`opendcvc_tpu_torch/utils/trace.py`): its last session, which in a
traced run is the profiled slice, the only session the run opens.  A
package without that module, or a session that coded no frames, reads
None, so a reader returns nothing there rather than raising."""


def session():
    try:
        from opendcvc_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.last_session()
    return s if s and s["frames"] else None


def spans_ms(prefix):
    """Host ms a frame in the session's spans named `prefix`*."""
    s = session()
    if s is None:
        return None
    return sum(v["ms"] for k, v in s["spans"].items()
               if k.startswith(prefix)) / s["frames"]


def per_frame_pct(counter):
    """100 x the session's `counter` over its frames."""
    s = session()
    if s is None:
        return None
    return 100.0 * s["counters"].get(counter, 0) / s["frames"]


def share_pct(part, whole):
    """100 x the session's counter `part` over its counter `whole`; None
    where `whole` counted nothing."""
    s = session()
    if s is None or not s["counters"].get(whole):
        return None
    return 100.0 * s["counters"].get(part, 0) / s["counters"][whole]
