"""Device-side entropy coding: the "tpu-lane" lane rANS container.

Counterpart of the JAX package's `entropy/device_rans.py`, cut to what the
DMC/DMCI device-EC path uses.  L independent rANS lanes are advanced in
lockstep by the scans in `ops/lane_rans.py` (kernels K1/K2 on CUDA);
renormalisation is 16-bit (state in [2^16, 2^32)), so a step moves at
most one u16 word per lane.  Tables are plain int32 (NR, 257) cumulative
rows; the container bytes do not depend on how a device looks them up.

Container (v6, byte-identical to the JAX package's):
  u8 FRAME_MAGIC | u32 n | u16 L | u16 K | u16 MW | u32 cap | u16 kyc |
  u32 data_len | lens u16*L | states u32*L | dense u16*total
with each lane's words in decode order, lanes back to back.  `kyc` is
the skip-compaction rung: with force_zero_thres and kyc > 0 each y plane's
surviving symbols are compacted into a lanes * kyc prefix
(`compact_skip_enc`), so each y plane is coded in kyc steps a lane in place
of its full K_y; kyc = 0 codes the full planes, skipped positions at zero
rate.
"""

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..models.common import fetch_async
from ..ops.lane_rans import DEC_SKIP, ENC_SKIP
from ..utils import trace
from ..utils.common import env_flag

#: the JAX package's sentinel local row id of a force_zero_thres-skipped
#: symbol: its scans pass it through at zero rate and decode it as 0.  The
#: port's kernels take their own 9-bit sentinel (ops/lane_rans.py
#: ENC_SKIP / DEC_SKIP, 511), since DCVC-FM's 256-row y table codes a row
#: 255; this is the JAX package's value, under its name.
SKIP_ROW = 255

FRAME_MAGIC = 0xD6  # container format/version marker (v6)


def full_range_cdf_rows(cdfs, cdf_sizes, offsets):
    """Convert escape-format quantized CDF rows into full-range 256-bin
    rows (freq >= 1 everywhere, sum == 2^16).

    cdfs: (n, max_len) int32 rows; cdf_sizes: (n,); offsets: (n,).
    Returns (n, 257) int32 cumulative rows over symbols -128..127.
    """
    cdfs = np.asarray(cdfs, np.int64)
    sizes = np.asarray(cdf_sizes, np.int64).reshape(-1)
    offsets = np.asarray(offsets, np.int64).reshape(-1)
    n, w = cdfs.shape
    in_f = cdfs[:, 1:] - cdfs[:, :-1]                    # (n, w-1)
    n_sym = sizes - 2              # in-range symbols (last bin = escape)
    col = np.arange(w - 1)[None, :]
    valid = col < n_sym[:, None]
    # scatter each row's in-range block at bin offset+128
    freqs = np.ones((n, 256), np.int64)
    lo = offsets + 128             # bin index of first in-range symbol
    dest = lo[:, None] + col                             # (n, w-1)
    valid &= (dest >= 0) & (dest < 256)
    in_f = np.where(valid, np.maximum(in_f, 1), 0)
    dest_c = np.clip(dest, 0, 255)
    rows_i = np.repeat(np.arange(n), w - 1)
    np.add.at(freqs, (rows_i, dest_c.reshape(-1)),
              (np.where(valid, in_f - 1, 0)).reshape(-1))
    excess = freqs.sum(axis=1) - (1 << 16)
    j = np.argmax(freqs, axis=1)
    if not np.all(freqs[np.arange(n), j] - excess >= 1):
        raise ValueError("cannot normalize full-range cdf")
    freqs[np.arange(n), j] -= excess
    out = np.zeros((n, 257), np.int64)
    out[:, 1:] = np.cumsum(freqs, axis=1)
    return out.astype(np.int32)


def encode_carry_init(lanes, max_words, device="cpu"):
    """Fresh encode carry: (state (L,) int64 = 2^16, cursors (L,) int64,
    staging (L, max_words) int32 zeros)."""
    return (torch.full((lanes,), 1 << 16, dtype=torch.int64, device=device),
            torch.zeros((lanes,), dtype=torch.int64, device=device),
            torch.zeros((lanes, max_words), dtype=torch.int32,
                        device=device))


def densify_segment(buf, lens, states, cap, survivors=None):
    """Compact the encode staging on the device: each lane's emitted words,
    reversed into decode order, back to back lane-major (the container's
    data layout), so only ~true-bpp bytes cross to the host.

    Returns ONE int32 vector of u16 values: [dense words (cap) | lens (L)
    | state hi (L) | state lo (L)], and with skip compaction (`survivors`,
    the frame's largest per-plane survivor count, a 0-d tensor) two more
    words, its high and low halves.  Overflow (sum(lens) > cap) leaves the
    tail truncated; the host detects it from the lens and re-runs at the
    next ladder step."""
    L, MW = buf.shape
    dev = buf.device
    lens64 = lens.to(torch.int64)
    offs = torch.cumsum(lens64, 0) - lens64          # exclusive, lane-major
    col = torch.arange(MW, device=dev)[None, :]
    dst = offs[:, None] + (lens64[:, None] - 1 - col)
    # invalid slots and overflow park in the pad slot `cap`
    dst = torch.where(col < lens64[:, None], dst, cap).clamp(max=cap)
    dense = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    dense.scatter_(0, dst.reshape(-1), buf.reshape(-1))
    states = states.to(torch.int64)
    parts = [dense[:cap], lens.to(torch.int32) & 0xFFFF,
             (states >> 16).to(torch.int32),
             (states & 0xFFFF).to(torch.int32)]
    if survivors is not None:
        m = survivors.to(torch.int32).reshape(1)
        parts += [m >> 16, m & 0xFFFF]
    return torch.cat(parts)


def undensify_packed(packed, cap, L):
    """Host-side split of densify_segment's output (numpy u16)."""
    dense = packed[:cap]
    lens = packed[cap:cap + L].astype(np.int32)
    states = (packed[cap + L:cap + 2 * L].astype(np.uint32) << 16) \
        | packed[cap + 2 * L:cap + 3 * L].astype(np.uint32)
    return dense, lens, states


def _undensify_device(staging, cap, L, MW):
    """Compact staging [dense | lens | st_hi | st_lo] (int32 u16 values,
    on the device) -> ((L, MW) int32 decode-order lane words, (L,) int64
    states).  Inverse of densify_segment, run on the device so a decode
    uploads only ~true-bpp bytes.  Positions past a lane's length stay 0
    (the decode scan never reads them)."""
    dev = staging.device
    dense = staging[:cap]
    lens = staging[cap:cap + L].to(torch.int64)
    states = (staging[cap + L:cap + 2 * L].to(torch.int64) << 16) \
        | staging[cap + 2 * L:cap + 3 * L].to(torch.int64)
    ends = torch.cumsum(lens, 0)
    pos = torch.arange(cap, device=dev)
    lane = torch.searchsorted(ends, pos, right=True)   # ends[lane-1] <= pos
    lane_c = lane.clamp(max=L - 1)
    j = pos - (ends[lane_c] - lens[lane_c])
    # words past the last lane (and of a corrupt lane longer than MW)
    # park in the pad slot
    dst = torch.where((lane < L) & (j < MW), lane_c * MW + j, L * MW)
    data = torch.zeros((L * MW + 1,), dtype=torch.int32, device=dev)
    data.scatter_(0, dst, dense)
    return data[:L * MW].reshape(L, MW), states


def effective_lanes(max_lanes, n_symbols, min_lanes=256, min_steps=64):
    """Scale the lane count to the frame's symbol count: the container
    carries ~6 bytes of per-lane state, so small frames halve the lane
    count until each lane has >= min_steps symbols.  The decoder needs no
    configuration: every container records its own L."""
    lanes = max_lanes
    while lanes > min_lanes and lanes * min_steps > n_symbols:
        lanes //= 2
    return max(lanes, min_lanes)


def staging_width(k_total, bps):
    """Staging words a lane (mw) of a K1 launch over k_total steps at `bps`
    bytes per symbol: the staging ladder's rungs run from bps 0.5 to 3.0,
    the top, where a lane has room for a word every step."""
    return max(8, int(k_total * bps / 2)) + 4


class StagingPlan(NamedTuple):
    """A frame's lane plan: `lanes` lanes code z in k_z steps and each of
    `n_planes` y planes in k_y steps, or in kyc steps when skip compaction
    is on (kyc > 0)."""
    lanes: int
    k_z: int
    k_y: int
    n_planes: int
    kyc: int = 0

    def steps(self, kyc=None):
        """K1's steps a lane at the compaction rung `kyc` (default the
        plan's own)."""
        kyc = self.kyc if kyc is None else kyc
        return self.k_z + self.n_planes * (kyc if kyc > 0 else self.k_y)


def survivor_count(arr, cap, lanes):
    """The skip-compaction survivor count (the largest over the frame's y
    planes) that rides a compacted staging's tail, after [dense | lens |
    st_hi | st_lo], as two u16 words."""
    at = cap + 3 * lanes
    return (int(arr[at]) << 16) | int(arr[at + 1])


def settle_staging(arr, plan, rung, bps, base_bps, rerun):
    """Overflow-check a fetched compact staging and serialize it.

    `arr` was launched at `rung(plan.steps(), bps)` -> (mw, cap).  Two
    overflow axes, as the JAX package's `_finish_one_device`: while a lane
    reached mw - 2 words or the payload exceeds cap (lane cursors count
    every emission, so overflow always shows), double bps (at most 3.0,
    the top rung, where cap is the whole rectangle and everything fits);
    while a compacted y plane has more survivors m than its lanes * kyc
    slots, grow kyc to min(k_y, ceil8(max(ceil(m / lanes), 2 * kyc))).
    Either way re-encode with `rerun(mw, cap, kyc)`.  The container then
    records the rung a ladder started at `base_bps` settles at, computed
    from the payload alone, so a stream does not depend on the rung it was
    launched at.  Returns (stream, settled bps, reruns)."""
    lanes, g_bps, g_kyc = plan.lanes, bps, plan.kyc
    mw, cap = rung(plan.steps(g_kyc), g_bps)
    reruns = 0
    for _ in range(8):
        dense, ln, st = undensify_packed(arr, cap, lanes)
        m = survivor_count(arr, cap, lanes) if g_kyc > 0 else 0
        comp_over = g_kyc < plan.k_y and m > lanes * g_kyc
        stage_over = int(ln.max(initial=0)) >= mw - 2 or int(ln.sum()) > cap
        if not comp_over and not stage_over:
            break
        if comp_over:
            need = -(-m // lanes)
            g_kyc = min(plan.k_y, -(-max(need, 2 * g_kyc) // 8) * 8)
        if stage_over:
            g_bps = min(g_bps * 2, 3.0)
        mw, cap = rung(plan.steps(g_kyc), g_bps)
        reruns += 1
        arr = rerun(mw, cap, g_kyc)
    else:
        raise OverflowError(
            "device rANS staging overflowed at the top ladder rung")
    k_total = plan.steps(g_kyc)
    ln_max, ln_sum = int(ln.max(initial=0)), int(ln.sum())
    s_bps = base_bps
    for _ in range(8):
        s_mw, s_cap = rung(k_total, s_bps)
        if ln_max < s_mw - 2 and ln_sum <= s_cap:
            return (serialize_frame_dense(dense, ln, st, lanes * k_total,
                                          k_total, s_mw, s_cap, g_kyc),
                    g_bps, reruns)
        s_bps = min(s_bps * 2, 3.0)
    raise OverflowError(
        "device rANS staging overflowed at the top ladder rung")


def fm_rung(lanes, k_total, bps, top=False):
    """(mw, cap) of a DCVC-FM staging rung: mw by staging_width, cap half
    the rectangle (at least 4096 words), or the whole rectangle at a top
    rung (`top`)."""
    mw = staging_width(k_total, bps)
    return mw, lanes * mw if top else max(4096, lanes * mw // 2)


def fm_settle_staging(arr, lanes, k_total, bps, rerun):
    """The DCVC-FM codecs' staging ladder, as the JAX package's FM loops
    run it (models/dmc_fm.py and models/dmci_fm.py `_compress_device`),
    which is not RT's settle_staging: the container records the rung the
    last run used, not one derived from the payload, and a run gets the
    whole rectangle only after a run at bps 3.0 overflowed (the top flag
    is taken before the doubling).

    `arr` is the fetched compact staging of a run at fm_rung(lanes,
    k_total, bps).  While a lane reached mw - 2 words or the payload
    exceeds cap, double bps (at most 3.0) and re-encode with `rerun(mw,
    cap)`, which returns the new run's host staging.  Returns (stream,
    reruns)."""
    mw, cap = fm_rung(lanes, k_total, bps)
    for reruns in range(8):
        dense, ln, st = undensify_packed(arr, cap, lanes)
        if int(ln.max(initial=0)) < mw - 2 and int(ln.sum()) <= cap:
            return (serialize_frame_dense(dense, ln, st, lanes * k_total,
                                          k_total, mw, cap), reruns)
        top = bps >= 3.0
        bps = min(bps * 2, 3.0)
        mw, cap = fm_rung(lanes, k_total, bps, top)
        arr = rerun(mw, cap)
    raise OverflowError(
        "device rANS staging overflowed at the top ladder rung")


def serialize_frame_dense(dense, lens, states, n_symbols, K, MW, cap,
                          kyc=0):
    """v6 container from an already-dense (decode-order, lane-major) word
    vector (layout in the module docstring).  `cap` records the encoder's
    dense staging capacity so the decoder rebuilds the exact staging
    layout; `kyc` is the skip-compaction rung (0 = none)."""
    L = lens.shape[0]
    total = int(lens.sum())
    head = [np.uint8(FRAME_MAGIC).tobytes(),
            np.uint32(n_symbols).tobytes(),
            np.uint16(L).tobytes(), np.uint16(K).tobytes(),
            np.uint16(MW).tobytes(),
            np.uint32(cap).tobytes(),
            np.uint16(kyc).tobytes(),
            np.uint32(2 * total).tobytes()]
    return b"".join(head + [lens.astype(np.uint16).tobytes(),
                            states.astype(np.uint32).tobytes(),
                            np.ascontiguousarray(dense[:total])
                            .astype(np.uint16).tobytes()])


def parse_frame_parts(stream, offset=0):
    """Parse one v6 container into its raw parts.

    Returns (meta, dense (total,) u16, lens (L,) u16, states (L,) u32,
    next_offset); meta carries n/L/K/MW/cap/kyc/total."""
    if stream[offset] != FRAME_MAGIC:
        raise ValueError(
            f"bad container magic 0x{stream[offset]:02x} (expected "
            f"0x{FRAME_MAGIC:02x}): stream written by an incompatible "
            "format version")
    off = offset + 1
    n = int(np.frombuffer(stream, np.uint32, 1, off)[0]); off += 4
    L = int(np.frombuffer(stream, np.uint16, 1, off)[0]); off += 2
    K = int(np.frombuffer(stream, np.uint16, 1, off)[0]); off += 2
    mw = int(np.frombuffer(stream, np.uint16, 1, off)[0]); off += 2
    cap = int(np.frombuffer(stream, np.uint32, 1, off)[0]); off += 4
    kyc = int(np.frombuffer(stream, np.uint16, 1, off)[0]); off += 2
    dlen = int(np.frombuffer(stream, np.uint32, 1, off)[0]); off += 4
    lens = np.frombuffer(stream, np.uint16, L, off); off += 2 * L
    states = np.frombuffer(stream, np.uint32, L, off); off += 4 * L
    total = dlen // 2
    dense = np.frombuffer(stream, np.uint16, total, off); off += dlen
    meta = {"n": n, "L": L, "K": K, "MW": mw, "cap": cap, "kyc": kyc,
            "total": total}
    return meta, dense, lens, states, off


def staging_from_parts(dense, lens, states, cap, width=None):
    """Host-side staging vector [dense padded to cap | lens | st_hi |
    st_lo] (u16): the layout densify_segment produced on the encoder.  A
    smaller `width` (at least the payload) pads the dense section to it
    in place of cap: the bucketed upload form, which expand_staging
    zero-extends to cap on the device."""
    L = lens.shape[0]
    w = cap if width is None else width
    staging = np.zeros(w + 3 * L, np.uint16)
    staging[:dense.shape[0]] = dense
    staging[w:w + L] = lens
    staging[w + L:w + 2 * L] = (states >> 16).astype(np.uint16)
    staging[w + 2 * L:] = (states & 0xFFFF).astype(np.uint16)
    return staging


def parse_frame(stream, offset=0):
    """Parse one v6 container into the compact staging vector (numpy u16)
    that _undensify_device expands on the device.

    Returns (meta, staging_u16, next_offset)."""
    meta, dense, lens, states, off = parse_frame_parts(stream, offset)
    staging = staging_from_parts(dense, lens, states, meta["cap"])
    return meta, staging, off


# ---------------------------------------------------------------------------
# transfer slimming (the JAX package's, under its names; on unless
# OPENDCVC_TPU_EC_SLIM is set off)
#
# A staging's dense section is sized for hard content (cap), but a frame's
# payload (`total`, the sum of the lane lengths) is usually far smaller, so
# each direction moves only a quantized window around it:
#   decode: upload [dense padded to a bucket | lens | hi | lo] and
#           zero-extend it to cap on the device (expand_staging); exact,
#           since the host knows total;
#   encode: copy [dense window w | tail] (fetch_window) and rebuild the
#           cap layout on the host (restore_window).  sum(lens) > w shows
#           in the copied lens; the staging, kept alive on the device,
#           then crosses once in full, and the window grows to the
#           batch's largest payload + 25 %.
# Windows and buckets are multiples of WINDOW_STEP words.  The streams do
# not depend on any of it: the restored staging equals the full one up to
# total, and nothing reads a staging's dense words past total.
# ---------------------------------------------------------------------------

WINDOW_STEP = 8192  # u16 words = 16 KiB

#: guards the codecs' window dicts: GOP chunks settle on pool threads.
#: The trace counts the copies (utils/trace.py): slim.fetch the windowed
#: encode copies, slim.miss those whose payload overran the window (each
#: cost one full copy more), d2h_bytes / h2d_bytes the bytes every staging
#: copy and upload of this module moved, windowed or not.
_WINDOW_LOCK = threading.Lock()


def quantize_window(words, cap, step=None):
    step = WINDOW_STEP if step is None else step
    return int(min(-(-max(int(words), 1) // step) * step, cap))


def expand_staging(win, bucket, cap):
    """(..., bucket + tail) -> (..., cap + tail): zero-extend the dense
    section to cap on the device, so the decoder keeps one staging shape
    while the upload scales with the payload."""
    pad = win.new_zeros(win.shape[:-1] + (cap - bucket,))
    return torch.cat([win[..., :bucket], pad, win[..., bucket:]], dim=-1)


def fetch_window(packed, w, cap, tail):
    """[dense(cap) | tail] -> [dense(:w) | tail] along the last axis
    (leading batch dims kept): the encode copy's form, cut on the
    device."""
    return torch.cat([packed[..., :w], packed[..., cap:cap + tail]], dim=-1)


def restore_window(arr_w, w, cap, L, tail):
    """The host's inverse of fetch_window for ONE frame: the [dense(cap) |
    tail] vector, zeros in [w:cap].  None when sum(lens) > w: the window
    missed payload."""
    lens = arr_w[w:w + L]
    if int(lens.astype(np.int64).sum()) > w:
        return None
    out = np.zeros(cap + tail, np.uint16)
    out[:w] = arr_w[:w]
    out[cap:] = arr_w[w:]
    return out


def slim_enabled():
    return env_flag("OPENDCVC_TPU_EC_SLIM", default=True)


def fetch_w_for(windows, cap):
    """The encode copy's window for a staging capacity: cap/4 (quantized)
    at first, grown to fit observed payloads (grow_fetch_w), never shrunk;
    cap with slimming off.  `windows` is the codec's own {cap: w}."""
    if not slim_enabled():
        return cap
    with _WINDOW_LOCK:
        w = windows.get(cap)
        if w is None:
            w = windows[cap] = quantize_window(cap // 4, cap)
    return w


def grow_fetch_w(windows, cap, total):
    """Grow the window to an observed payload + 25 %."""
    want = quantize_window(total + total // 4, cap)
    with _WINDOW_LOCK:
        if want > windows.get(cap, 0):
            windows[cap] = want


def fetch_staging(staging):
    """Start the copy of a staging, or of a stack of them, to the host as
    u16 words (half the bytes of the int32 on the device) in one pinned
    copy (models/common.py::fetch_async); returns the callable that waits
    for it (trace span `wait.staging`) and gives the numpy u16 array."""
    trace.count("d2h_bytes", 2 * staging.numel())
    wait = fetch_async(staging.to(torch.int16), "wait.staging")
    return lambda: wait().view(np.uint16)


def slim_fetch(windows, packed, lanes, cap):
    """Start the (windowed) copy of encode staging(s) `packed` ((cap +
    tail) or (N, cap + tail) on the device; the tail is [lens | hi | lo]
    and, under skip compaction, the survivor count's two words: the JAX
    package's tail_extra, read here off the staging's length) and return
    the callable that gives the full [dense(cap) | tail] host array(s).
    With slimming on only the window crosses; if a frame's payload
    overran it, `packed` crosses once more in full (the batch's every
    frame taken from that copy), the miss is counted and the codec's
    window grows, all before the caller's ladder check sees the
    staging."""
    tail = packed.shape[-1] - cap
    w = fetch_w_for(windows, cap)
    if w >= cap:
        return fetch_staging(packed)
    wait = fetch_staging(fetch_window(packed, w, cap, tail))

    def finish():
        arr = wait()
        rows = arr if arr.ndim == 2 else arr[None]
        trace.count("slim.fetch")
        out, full = [], None
        for i, row in enumerate(rows):
            got = restore_window(row, w, cap, lanes, tail)
            if got is None:
                if full is None:
                    full = fetch_staging(packed)().reshape(rows.shape[0], -1)
                    trace.count("slim.miss")
                    grow_fetch_w(windows, cap, int(
                        full[:, cap:cap + lanes].astype(np.int64)
                        .sum(axis=1).max()))
                got = full[i]
            out.append(got)
        return np.stack(out) if arr.ndim == 2 else out[0]

    return finish


def upload_stagings(bit_streams, device):
    """Parse a chunk's containers and upload their compact decode
    stagings to `device`.

    Returns (metas, stagings): stagings is one (N, cap + 3L) int32 tensor
    of u16 values, or None when the containers disagree on (L, MW, cap,
    kyc), a chunk of mixed ladder rungs that the caller decodes frame by
    frame.  With slimming on, the dense sections cross padded only to a
    quantized bucket around the chunk's largest payload and are
    zero-extended to cap on the device (expand_staging); off, they span
    cap.  The u16 words cross in one copy (pinned and non-blocking on a
    CUDA device; trace span `upload`) and are widened on the device."""
    parts = [parse_frame_parts(s) for s in bit_streams]
    metas = [pp[0] for pp in parts]
    if len({(m["L"], m["MW"], m["cap"], m["kyc"]) for m in metas}) != 1:
        return metas, None
    cap = metas[0]["cap"]
    bucket = cap
    if slim_enabled():
        bucket = quantize_window(max(m["total"] for m in metas), cap)
    host = torch.from_numpy(np.stack(
        [staging_from_parts(d, ln, st, cap, width=bucket)
         for _, d, ln, st, _ in parts]).view(np.int16))
    trace.count("h2d_bytes", 2 * host.numel())
    with trace.span("upload"):
        if device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(device, non_blocking=True)
    dev = dev.to(torch.int32) & 0xFFFF
    if bucket < cap:
        dev = expand_staging(dev, bucket, cap)
    return metas, dev


# ---------------------------------------------------------------------------
# skip compaction (force_zero_thres with kyc > 0)
#
# A y plane's surviving (kept) symbols move into a lanes * kyc slot prefix,
# in order, so its scans run kyc steps a lane in place of the plane's K_y.
# Encoder and decoder derive the same mapping from the shared keep mask;
# only the rung kyc crosses, in the container.  Each survivor's slot is its
# exclusive prefix count among the kept positions, so no two survivors
# share a slot; every skipped position writes one parking slot past both
# the prefix and the plane, which is dropped, as are the survivors past
# the prefix (overflow, which the ladder regrows from the count).
# ---------------------------------------------------------------------------

def _survivor_slots(keep, n_c):
    """(slot of each position: its exclusive prefix count among the kept
    positions, or the dropped slot max(n_c, n) where skipped; survivor
    count m as a 0-d tensor; the scatter's length max(n_c, n) + 1)."""
    keep = keep.reshape(-1)
    k = keep.to(torch.int64)
    park = max(n_c, k.shape[0])
    idx = torch.cumsum(k, 0) - k
    return torch.where(keep, idx, park), k.sum(), park + 1


def compact_skip_enc(sym, rows, keep, n_c):
    """Compact a flat plane's survivors into n_c slots: (sym_c (n_c,),
    rows_c (n_c,), m).  Survivors keep their order; the tail slots ride
    the kernels' skip row id (ops/lane_rans.py ENC_SKIP; the JAX
    package's `compact_skip_enc` fills SKIP_ROW) at zero rate with symbol
    0; m counts every survivor, also those past n_c, which are dropped
    (the caller re-runs at a larger rung when m > n_c)."""
    dst, m, n_buf = _survivor_slots(keep, n_c)
    sym_c = sym.new_zeros((n_buf,)).scatter_(0, dst, sym.reshape(-1))
    rows_c = rows.new_full((n_buf,), ENC_SKIP).scatter_(
        0, dst, rows.reshape(-1))
    return sym_c[:n_c], rows_c[:n_c], m


def compact_skip_dec(rows, keep, n_c):
    """The decoder's side of compact_skip_enc: (rows_c (n_c,), orig (n_c,)
    int64, each slot's position in the plane, n for a tail slot); tail
    slots ride K2's DEC_SKIP."""
    dst, _, n_buf = _survivor_slots(keep, n_c)
    n = rows.numel()
    rows_c = rows.new_full((n_buf,), DEC_SKIP).scatter_(
        0, dst, rows.reshape(-1))
    orig = torch.full((n_buf,), n, dtype=torch.int64, device=rows.device)
    orig.scatter_(0, dst, torch.arange(n, device=rows.device))
    return rows_c[:n_c], orig[:n_c]


def expand_compact_syms(sym_c, orig, n):
    """Decoded compact symbols back to their plane positions (n,); skipped
    positions decode as 0.  Tail slots (orig == n) land in a dropped
    slot."""
    out = sym_c.new_zeros((n + 1,))
    return out.scatter_(0, orig, sym_c)[:n]
