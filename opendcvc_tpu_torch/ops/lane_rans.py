"""Lane rANS scans: kernels K1 (encode) and K2 (decode) and their plain
PyTorch versions.

K1 replaces the JAX package's `ops/pallas_rans.py::_enc_kernel`
(`encode_scan_pallas_packed`), K2 replaces `_dec_kernel`
(`decode_scan_pallas`).  Both are bit for bit the XLA scans of the JAX
package (`entropy/device_rans.py` `_encode_scan_carry`,
`_decode_scan_carry`); the CUDA sources are `csrc/lane_rans.cu` with the
per-lane arithmetic in `csrc/lane_rans_step.cuh`, whose notes say what
bounds them and how they are laid out.  Each reads a prepared form of the
(nr, 257) int32 cumulative rows, built once per model table: K1 the
entries of `prepare_encode_table`, K2 the compact rows of
`prepare_decode_table`.

A wrapper runs the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (raising if the launch fails); each
wrapper counts its kernel launches in the trace's counters `k1.launch`
and `k2.launch` (utils/trace.py).  The plain
versions loop over steps with vectorised lane ops in int64, because
PyTorch's uint32 lacks most arithmetic.
"""

import torch

from ..utils import trace

#: the packed encode operand is (sym + 128) << ENC_ROW_BITS | row; rows
#: take 9 bits because a combined per-frame table reaches 384 rows (DCVC-FM),
#: where the JAX package's 8-bit skip row (entropy/device_rans.py SKIP_ROW,
#: 255) would collide with a real row id
ENC_ROW_BITS = 9
ENC_ROW_MASK = (1 << ENC_ROW_BITS) - 1
#: the skip row id of both kernels (csrc/lane_rans_step.cuh LR_SKIP): a
#: zero-rate passthrough that decodes as 0.  Callers holding the JAX
#: package's row ids map its SKIP_ROW to it.
ENC_SKIP = DEC_SKIP = ENC_ROW_MASK
#: K2 takes slices of at most this many rows (DCVC-FM's 256-row y table)
DEC_MAX_ROWS = 256


def pack_operand(sym, rows):
    """(sym in [-128, 127], local rows or ENC_SKIP) -> packed int32."""
    return ((sym.to(torch.int32) + 128) << ENC_ROW_BITS) \
        | rows.to(torch.int32)


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cdf_rows(table, what):
    """(nr, 257) int64 of valid cumulative rows; raises ValueError on a
    row without cum[0] = 0, cum[256] = 65536 and every frequency >= 1
    (`full_range_cdf_rows`)."""
    if table.dim() != 2 or table.shape[1] != 257:
        raise ValueError(f"table must be (nr, 257), got {tuple(table.shape)}")
    cum = table.to(torch.int64)
    if bool((cum[:, 0] != 0).any()) or bool((cum[:, 256] != 65536).any()) \
            or bool((cum[:, 1:] <= cum[:, :-1]).any()):
        raise ValueError(f"every {what} row needs cum[0] = 0, cum[256] = "
                         "65536 and every frequency >= 1")
    return cum


def _lib():
    from . import _build
    return _build.load_kernels()["lane_rans"]


# ---------------------------------------------------------------------------
# K1: encode
# ---------------------------------------------------------------------------

#: int32 words of a prepared encode entry and row (256 entries)
ENC_ENTRY_WORDS = 4
ENC_ROW_WORDS = 256 * ENC_ENTRY_WORDS


def div_magic(freq):
    """Magic M = ceil(2^48 / freq) of K1's exact division by freq in
    [1, 65536] (int64 in and out).  `csrc/lane_rans_step.cuh::
    lr_div_exact` turns its low and high 32-bit words into x // freq for
    every u32 x, and proves that exact."""
    return ((1 << 48) + freq - 1) // freq


def prepare_encode_table(table):
    """K1's table of (nr, 257) int32 cumulative rows.

    Every row must hold cum[0] = 0, cum[256] = 65536 and every frequency
    >= 1; a row that does not raises ValueError.  Returns (nr,
    ENC_ROW_WORDS) int32 on the table's device: for symbol s of a row the
    u32 words (65536 - freq) << 16, the low and the high word of
    div_magic(freq), and start (start = cum[s], freq = cum[s + 1] -
    cum[s]), 4 KB a row, so one 16-byte read gives K1 all it needs of a
    slot.  Built once per model table; the encode calls slice it by
    row."""
    cum = _cdf_rows(table, "encode")
    start = cum[:, :256]
    freq = cum[:, 1:] - start
    magic = div_magic(freq)
    entry = torch.stack([(65536 - freq) << 16, magic & 0xFFFFFFFF,
                         magic >> 32, start], dim=2)
    entry = entry - ((entry >> 31) << 32)            # u32 bit patterns
    return entry.to(torch.int32).reshape(cum.shape[0], ENC_ROW_WORDS)


def encode_table_entries(enc_table):
    """(start, freq, magic) (nr, 256) int64 of a prepared encode table."""
    e = (enc_table.to(torch.int64) & 0xFFFFFFFF).reshape(
        enc_table.shape[0], 256, ENC_ENTRY_WORDS)
    return e[..., 3], 65536 - (e[..., 0] >> 16), (e[..., 2] << 32) | e[..., 1]


def encode_scan(packed, enc_table, mw):
    """Encode L lanes over K steps from a fresh carry.

    packed: (K, L) int32 step-major, (sym + 128) << 9 | row, encode order
    (each lane's last symbol first); row == ENC_SKIP is a zero-rate
    passthrough, a row id >= nr reads row nr - 1.  enc_table: (nr,
    ENC_ROW_WORDS) int32 rows of prepare_encode_table, nr <= 511.  mw:
    staging width.  Returns (staging (L, mw) int32 u16 words in emit
    order, zero past each lane's last word; lens (L,) int32, counting
    words past mw too; states (L,) int64 u32 values)."""
    dev = packed.device
    _check("packed", packed, torch.int32, 2, dev)
    _check("enc_table", enc_table, torch.int32, 2, dev)
    if enc_table.shape[1] != ENC_ROW_WORDS or \
            not 0 < enc_table.shape[0] <= ENC_SKIP:
        raise ValueError(f"enc_table must be (1..{ENC_SKIP}, "
                         f"{ENC_ROW_WORDS}), got {tuple(enc_table.shape)}")
    if mw < 1:
        raise ValueError("mw must be positive")
    if dev.type == "cpu":
        return encode_scan_plain(packed, enc_table, mw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if enc_table.data_ptr() % 16:
        raise ValueError("enc_table must start 16-byte aligned (a row "
                         "slice of an aligned table does)")
    K, L = packed.shape
    staging = torch.empty((L, mw), dtype=torch.int32, device=dev)
    lens = torch.empty((L,), dtype=torch.int32, device=dev)
    states = torch.empty((L,), dtype=torch.int64, device=dev)
    err = _lib().lr_encode_launch(
        packed.data_ptr(), enc_table.data_ptr(), staging.data_ptr(),
        lens.data_ptr(), states.data_ptr(), K, L, enc_table.shape[0], mw,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lane rANS encode launch failed: cudaError {err}")
    trace.count("k1.launch")
    return staging, lens, states


def encode_scan_plain(packed, enc_table, mw):
    """Plain PyTorch version of encode_scan (same contract), on the start
    and freq of the prepared entries, dividing in int64."""
    from ..entropy.device_rans import encode_carry_init
    K, L = packed.shape
    dev = packed.device
    start_t, freq_t, _ = encode_table_entries(enc_table)
    nr = start_t.shape[0]
    state, cur, buf = encode_carry_init(L, mw, dev)
    lane = torch.arange(L, device=dev)
    for k in range(K):
        pk = packed[k].to(torch.int64)
        row = pk & ENC_ROW_MASK
        skip = row == ENC_SKIP
        row = row.clamp(max=nr - 1)
        sym = (pk >> ENC_ROW_BITS) & 255
        start = start_t[row, sym]
        freq = freq_t[row, sym]
        emit = (state >= (freq << 16)) & ~skip
        word = (state & 0xFFFF).to(torch.int32)
        # words past mw are dropped; the cursor still counts them
        at = cur.clamp(max=mw - 1)
        buf[lane, at] = torch.where(emit & (cur < mw), word, buf[lane, at])
        state1 = torch.where(emit, state >> 16, state)
        cur = cur + emit.to(torch.int64)
        state2 = ((state1 // freq) << 16) + state1 % freq + start
        state = torch.where(skip, state, state2)
    return buf, cur.to(torch.int32), state


# ---------------------------------------------------------------------------
# K2: decode
# ---------------------------------------------------------------------------

#: int32 words of a prepared decode row: 256 u16 bins, 16 bytes of
#: padding, 256 u8 buckets (784 bytes: every row of a slice starts 16-byte
#: aligned for K2's bulk copy into shared memory, and the stride spreads
#: one bin of neighbouring rows over the shared-memory banks)
DEC_ROW_WORDS = 196


def prepare_decode_table(table):
    """Compact K2 table of (nr, 257) int32 cumulative rows.

    Every row must hold cum[0] = 0, cum[256] = 65536 and every frequency
    >= 1 (`full_range_cdf_rows`); a row that does not raises ValueError.
    Returns (nr, DEC_ROW_WORDS) int32 on the table's device, a row being
    the bytes of u16 bins[s] = cum[s] - 1 mod 2^16 for s in [0, 256) (the
    255 inner bins fit 16 bits on a valid row; bins[0] = 0xFFFF pads
    them), 16 bytes of 0xFF (cum[256] - 1, and room for K2's scan to read
    past bin 255), and u8 bucket[b] = the last s with cum[s] <= b << 8,
    which bounds the symbol of a slot f to [bucket[f >> 8],
    bucket[(f >> 8) + 1]].  With the offset, cum[s] <= f is bins[s] < f,
    and no bin past 255 is below f.  Built once per model table; the
    decode calls slice it by row."""
    cum = _cdf_rows(table, "decode")
    bins = (cum[:, :256] - 1) & 0xFFFF
    bins = (bins - ((bins >> 15) << 16)).to(torch.int16)    # u16 bit pattern
    edges = (torch.arange(256, device=cum.device) << 8).expand(
        cum.shape[0], 256).contiguous()
    bucket = torch.searchsorted(cum.contiguous(), edges, right=True) - 1
    pad = torch.full((cum.shape[0], 16), 0xFF, dtype=torch.uint8,
                     device=cum.device)
    return torch.cat([bins.view(torch.uint8), pad, bucket.to(torch.uint8)],
                     dim=1).view(torch.int32)


def expand_decode_table(dec_table):
    """Inverse of prepare_decode_table: (nr, 257) int64 cumulative rows."""
    bins = (dec_table.view(torch.int16)[:, :256].to(torch.int64) + 1) \
        & 0xFFFF
    return torch.cat([bins, torch.full_like(bins[:, :1], 65536)], dim=1)


def decode_scan(data, rows, dec_table, state, ptr):
    """Decode L lanes over K steps, continuing the carry (state, ptr).

    data: (L, MW) int32 u16 words in decode order; rows: (K, L) int32
    local row ids in decode order, DEC_SKIP (511) decodes 0 at zero rate,
    any other id >= nr reads row nr - 1 (row 255 of a 256-row table is a
    coded row); dec_table: (nr, DEC_ROW_WORDS) int32 rows of
    prepare_decode_table, 1 <= nr <= DEC_MAX_ROWS; state: (L,) int64 u32
    values;
    ptr: (L,) int32, a word past either end of a lane's row reads as 0.
    Returns (symbols (K, L) int32 in [-128, 127], state, ptr)."""
    dev = data.device
    _check("data", data, torch.int32, 2, dev)
    _check("rows", rows, torch.int32, 2, dev)
    _check("dec_table", dec_table, torch.int32, 2, dev)
    if dec_table.shape[1] != DEC_ROW_WORDS or \
            not 0 < dec_table.shape[0] <= DEC_MAX_ROWS:
        raise ValueError(f"dec_table must be (1..{DEC_MAX_ROWS}, "
                         f"{DEC_ROW_WORDS}), got {tuple(dec_table.shape)}")
    _check("state", state, torch.int64, 1, dev)
    _check("ptr", ptr, torch.int32, 1, dev)
    L, MW = data.shape
    K = rows.shape[0]
    if rows.shape[1] != L or state.shape[0] != L or ptr.shape[0] != L:
        raise ValueError("data, rows, state and ptr disagree on the lane "
                         "count")
    if dev.type == "cpu":
        return decode_scan_plain(data, rows, dec_table, state, ptr)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dec_table.data_ptr() % 16:
        raise ValueError("dec_table must start 16-byte aligned (a row "
                         "slice of an aligned table does)")
    syms = torch.empty((K, L), dtype=torch.int32, device=dev)
    state_out = torch.empty((L,), dtype=torch.int64, device=dev)
    ptr_out = torch.empty((L,), dtype=torch.int32, device=dev)
    err = _lib().lr_decode_launch(
        data.data_ptr(), rows.data_ptr(), dec_table.data_ptr(),
        state.data_ptr(), ptr.data_ptr(), syms.data_ptr(),
        state_out.data_ptr(), ptr_out.data_ptr(), K, L, dec_table.shape[0],
        MW, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lane rANS decode launch failed: cudaError {err}")
    trace.count("k2.launch")
    return syms, state_out, ptr_out


def decode_scan_plain(data, rows, dec_table, state, ptr):
    """Plain PyTorch version of decode_scan (same contract), on the
    cumulative rows the prepared table expands back to."""
    L, MW = data.shape
    K = rows.shape[0]
    dev = data.device
    tab = expand_decode_table(dec_table)
    nr = tab.shape[0]
    words = torch.cat([data.to(torch.int64),
                       torch.zeros((L, 1), dtype=torch.int64, device=dev)],
                      dim=1)
    lane = torch.arange(L, device=dev)
    state = state.to(torch.int64)
    ptr = ptr.to(torch.int64)
    out = torch.empty((K, L), dtype=torch.int32, device=dev)
    for k in range(K):
        r = rows[k].to(torch.int64)
        skip = r == DEC_SKIP
        cum = tab[r.clamp(max=nr - 1)]                       # (L, 257)
        f = state & 0xFFFF
        sym = (cum[:, 1:] <= f[:, None]).sum(dim=1)          # last bin <= f
        start = cum[lane, sym]
        freq = cum[lane, sym + 1] - start
        state1 = torch.where(skip, state, freq * (state >> 16) + f - start)
        need = state1 < (1 << 16)
        at = torch.where((ptr >= 0) & (ptr < MW), ptr, MW)   # past end -> 0
        state = torch.where(need, (state1 << 16) | words[lane, at], state1)
        ptr = ptr + need.to(torch.int64)
        out[k] = torch.where(skip, 0, sym - 128).to(torch.int32)
    return out, state, ptr.to(torch.int32)
