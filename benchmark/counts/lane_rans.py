"""Bytes of the lane rANS kernels K1 (encode) and K2 (decode) for the
roofline shares: each input byte read once and each output byte written
once, counted as the measured package's chip smoke test (phase 2) counts
them, for the launch shapes these inputs need.

K1, one launch: the (K, L) int32 operand; 4 bytes (start and frequency)
of each distinct (row, symbol) entry it codes; the (L, mw) int32 staging;
each lane's length and state (12 bytes).
K2, one launch: the (K, L) int32 row ids and the (K, L) int32 symbols;
the table rows it reads, 784 bytes each (256 u16 bins, 16 pad bytes, 256
u8 buckets); each consumed word as int32; the carry in and out (2 x 12
bytes a lane).

A DCVC-RT frame's K2 launches, in decode order: z (128 rows of the
frame's qp), then its y planes (the 128 Gaussian scale rows), each
plane laid out over the container's L lanes."""

import numpy as np

K2_ROW_BYTES = 784
RT_Z_ROWS = 128
RT_Y_ROWS = 128
RT_Z_CH = 128


def k1_bytes(k, lanes, mw, n_entries):
    return 4 * k * lanes + 4 * n_entries + 4 * lanes * mw + 12 * lanes


def k2_bytes(k, lanes, rows, n_words):
    return 8 * k * lanes + K2_ROW_BYTES * rows + 4 * n_words + 24 * lanes


def bound_ms(n_bytes, hbm_bytes_per_s):
    return n_bytes / hbm_bytes_per_s * 1e3


def parse_header(stream, offset=0):
    """The fixed fields of one v6 ("tpu-lane") frame container: symbols,
    lanes, steps, staging width, capacity, compaction rung, payload
    words."""
    b = bytes(stream[offset:offset + 21])
    if len(b) < 21:
        raise ValueError("short container header")
    n, = np.frombuffer(b, np.uint32, 1, 1)
    lanes, k, mw = np.frombuffer(b, np.uint16, 3, 5)
    cap, = np.frombuffer(b, np.uint32, 1, 11)
    kyc, = np.frombuffer(b, np.uint16, 1, 15)
    dlen, = np.frombuffer(b, np.uint32, 1, 17)
    return {"n": int(n), "L": int(lanes), "K": int(k), "MW": int(mw),
            "cap": int(cap), "kyc": int(kyc), "total": int(dlen) // 2}


def rt_frame_launches(stream, n_y_planes, height, width):
    """[(K, L, rows, words)] of a DCVC-RT frame's K2 launches (z, then its
    y planes; DMCI codes 4, DMC 2) at a padded frame size: z has 128
    channels at 1/64, each y plane 64 x (H/16) x (W/16) symbols; the lane
    count and the payload words come from the frame's container."""
    h = parse_header(stream)
    lanes = h["L"]
    if h["kyc"]:
        raise ValueError("skip-compacted containers are not counted")
    zh, zw = -(-height // 64), -(-width // 64)
    n_z = RT_Z_CH * zh * zw
    n_y = 64 * (height // 16) * (width // 16)
    k_z, k_y = -(-n_z // lanes), -(-n_y // lanes)
    if k_z + n_y_planes * k_y != h["K"]:
        raise ValueError(f"container steps {h['K']} do not split as "
                         f"{k_z} + {n_y_planes} x {k_y}")
    return [(k_z, lanes, RT_Z_ROWS, h["total"])] + \
        [(k_y, lanes, RT_Y_ROWS, 0)] * n_y_planes


def rt_period_launches(streams, height, width):
    """K2 launches of a DCVC-RT period: an I-frame, then P-frames (the
    payload words are counted once a frame, with its z launch)."""
    return [rt_frame_launches(s, 4 if t == 0 else 2, height, width)
            for t, s in enumerate(streams)]


def k2_pass_bytes(frames):
    """Bytes of every K2 launch of a pass ([[(K, L, rows, words)]])."""
    return sum(k2_bytes(*launch) for frame in frames for launch in frame)


def k1_launch(stream):
    """(K, L, mw, table entries) of the K1 launch that wrote a frame's
    container (its settled rung).  The table entries a launch reads are
    not counted (they are under 1 % of its bytes at these shapes: ~2.4 K
    entries of 4 bytes against ~5.7 MB), so the bound is a little low."""
    h = parse_header(stream)
    return (h["K"], h["L"], h["MW"], 0)


def k1_pass_bytes(launches):
    return sum(k1_bytes(*launch) for launch in launches)
