"""Reductions shared by the per-metric readers in `metrics/`.  A reader
returns None where its run has nothing to read; a share of a peak or a
roofline is never reported as 0 in place of a missing number."""


def per_frame_ms(total_ms, frames):
    return total_ms / frames if frames else None


def span_ms(r, name):
    """Host ms a frame of the window spent in the benchmark span `name`."""
    if name not in r.rec.ms:
        return None
    return per_frame_ms(r.rec.ms[name], r.rec.n_frames())


def rate(r):
    """Frames the window completed a second, over the whole window."""
    n = r.rec.n_frames()
    return n / r.window_s if n else None


def device_ms(r, *classes):
    """Device ms a frame of the traced slice in the given classes."""
    if r.trace is None:
        return None
    return per_frame_ms(r.trace.seconds(*classes) * 1e3, r.slice_frames)


def nn_device_ms(r):
    if r.trace is None:
        return None
    return per_frame_ms(r.trace.nn_seconds() * 1e3, r.slice_frames)


def idle_pct(r):
    t = r.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(r, peak="float32_flops_per_s"):
    """NN FLOPs of the window's frames over the window, against one card's
    `peak` in counts/peaks.json (by default float32 outside the tensor
    cores)."""
    f = r.counts.get("window_flops")
    if not f or not r.window_s:
        return None
    return 100.0 * f / r.window_s / r.counts["peaks"][peak]


def k2_roofline_pct(r):
    """Least time of the slice's K2 launches (their bytes at HBM
    bandwidth) over their device time."""
    b = r.counts.get("k2_bytes_pass")
    if r.trace is None or not b:
        return None
    t = sum(s for n, s in r.trace.lane_rans if "decode" in n)
    if not t:
        return None
    return 100.0 * b / r.counts["peaks"]["hbm_bytes_per_s"] / t


def k1_roofline_pct(r):
    """Least time of the slice's K1 launches over their device time."""
    b = r.counts.get("k1_bytes_pass")
    if r.trace is None or not b:
        return None
    t = sum(s for n, s in r.trace.lane_rans if "encode" in n)
    if not t:
        return None
    return 100.0 * b / r.counts["peaks"]["hbm_bytes_per_s"] / t
