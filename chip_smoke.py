#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (opendcvc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):
  1. build the CUDA kernels from opendcvc_tpu_torch/csrc (nvcc, sm_90a);
  2. hold K1 (lane rANS encode) and K2 (decode) against their plain
     PyTorch versions, bit for bit: K1 at 4096 lanes, 272 steps, a
     256-row combined random table, ~30 % skip slots, then at the main
     path's own frames, one launch each over the port's combined y + z
     table (symbols drawn from each row, ~30 % skips): a DMC frame (16 z
     + 2 x 128 y steps) and a DMCI frame (16 + 4 x 128), each at the
     staging ladder's first and top rung, and at the contract's edges (a
     partial warp, row ids past the table, odd staging widths that some
     lanes overflow); K2 on one 272-step launch over
     a 128-row table, then at the main path's own launch shapes, decoding
     those two frames: a DMC frame's z (16 steps, the port's 128-row z
     table), y0 and y1 (128 steps, its 128-row y table) and a DMCI
     frame's z and four y quarters, with the (state, ptr) carry handed
     from launch to launch, and on arbitrary words at the contract's
     edges (a partial warp, clamped rows, pointers past either end).
     Every launch is timed as the median of 20 launches with CUDA events
     around the wrapper call (`ms`, the host's call time included) and
     again queued behind a sleep so the events time the device alone
     (`device_ms`); K2's per-frame totals are the sums of the timed
     launches of each frame;
  3. DMCI at 1080p full width (N = 256, z 128), f32, force_zero_thres
     0.12, flat q banks, device EC: one I-frame compress + decompress, the
     decoded frame equal to the encoder's;
  4. DMC at 1080p full width, device EC, seeded from phase 3's frame:
     four P-frames compress, then decompress, the decoder's feature equal
     to the encoder's after every frame;
  5. a 64x64 I-frame coded on the GPU and on the CPU with the same
     weights, through device EC and through host EC: the CPU decodes the
     GPU's stream and the two agree (the CPU path is the one the test
     suite holds against the JAX package); then a host-EC chain, a 64x64
     I-frame and 3 P-frames coded on the GPU and decoded by the CPU port,
     logging per frame the max |x_hat diff|, the feature diff and whether
     the GPU's and the CPU's streams are identical (fails on a decode
     error or a diff over 1e-3); then a bfloat16 row, reported and never
     failed: the 64x64 I-frame's encoder on the GPU and the CPU (the share
     of equal symbols per plane, the max |x_hat diff|) and whether the CPU
     decodes the GPU's bfloat16 host-EC stream;
  6. the host-EC sequence at 1080p: phases 3-4's weights, frames, qp and
     force_zero_thres, the C++ rANS coder on the host with two coders (as
     the harness above 1280x720); the I-frame and 4 P-frames encoded and
     written as one NAL stream (SPS, then I/P records) into memory, parsed
     back and decoded from those bytes.  The encoder's x_hat and features
     must equal phases 3-4's bit for bit, the decoded I-frame the
     encoder's, the decoder's feature the encoder's after every P-frame
     and each decoded P-frame phase 4's; K1 and K2 must not launch.
     Prints per frame the enc/dec ms, the host coder's ms within them,
     the device->host waits and uploads, and the bpp beside phase 3-4's.
  7. the RD harness, `opendcvc_tpu_torch.eval.harness.main`, in process,
     as a user runs it: a 1920x1080 8-bit YUV420 sequence of 16 textured
     frames and its dataset config (src_type yuv420, intra_period 32)
     written to a temporary directory, coded at qp 21, force_zero_thres
     0.12, reset_interval 8 (a periodic refresh at frames 1 and 9) with
     random full-width weights (--seed 0) into a NAL .bin, decoded from
     the file, the recon .yuv and the RD JSON written; run (a) with host
     EC (the default), run (b) with OPENDCVC_TPU_DEVICE_EC=1.  Fails
     unless, in both runs, every decoded frame equals the encoder's bit
     for bit (the codecs that build_nets returns are wrapped to record
     them), the JSON's bits are 8 x the .bin's size, the recon file has
     16 frames and its PSNR lies within 0.5 dB of the JSON's; K1 and K2
     launch in (b) and not in (a); per-frame PSNR is equal in (a) and
     (b).  Prints per run the harness's average frame times (frames
     10-15), bpp, PSNR, test_time and the time outside the codec calls.
  8. the port's benchmark, `opendcvc_tpu_torch.bench`, in process at
     bench.py's defaults: 1080p, 32 P-frames in GOP chunks of 8 (encode
     pipelined over two pool threads, chunk k + 1 uploaded before chunk
     k's decode), a batch of 8 intra frames, force_zero_thres 0.12, qp 21,
     device EC (4096 lanes, 0.4 bytes a symbol, P cap fraction 0.375).
     Fails unless K1 launched once a coded frame plus once a rerun and K2
     3 times a decoded P-frame and 5 an I-frame; the first chunk's GOP
     streams equal the same frames coded one by one through
     compress_async; decompress_gop and the last uploaded chunk equal the
     per-frame decode, whose final feature is the GOP decoder's and the
     encoder's; the batch's streams, x_hats and batched decode equal
     DMCI.compress and decompress frame by frame.  Prints the bench's
     JSON line, its ms a chunk and a batch, and a chunk's staging bytes
     with the time of one pinned copy of them each way.
  9. DCVC-RT in bfloat16 (`dtype=torch.bfloat16`), phases 3-8's
     configuration: (a) phases 3-4 (device EC), then phase 6 (host EC,
     two coders, one NAL stream) in bfloat16: each decoded I-frame equal
     to the encoder's, the decoder's feature the encoder's after every
     P-frame, host EC equal to device EC in encoder x_hat, features and
     decoded frames; K1 and K2 launch in the device-EC run only; the frame
     times and bpp printed beside phases 3-4's float32 ones; (b) the
     bench with BENCH_DTYPE=bfloat16 under phase 8's checks; (c) the
     harness with --dtype bfloat16 and device EC on the first 8 frames of
     phase 7's sequence under phase 7's checks.
The kernel launch counters are zeroed before phase 3 and read after
phase 4, so the counts are the main path's (the device-EC path); they are
zeroed again before phase 6 and must read 0 after it, again before each
run of phases 7 and 9, and before phase 8; `launches` adds the device-EC
runs of phases 7 (b), 8 and 9 to phases 3-4's, and `launches_by_run`
splits it.  Then it prints the card's name and
power limit, one JSON line describing each kernel, and, last, {"ok":
true, "device": {...}}.
"""

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 1080, 1920
QP = 21
FZ = 0.12
L_MAIN, K_MAIN = 4096, 272
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
REPS = 20
SLEEP_CYCLES = 1_000_000    # ~0.5 ms: covers one wrapper call's host time


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _log(msg):
    print(msg, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_ms(fn, dev, reps=REPS, queued=False):
    """Median over `reps` calls; CUDA events around each call, so they
    take the host time of the call as well.  queued: a sleep kernel ahead
    of the first event keeps the card busy while the host runs the call,
    so the events time the device's work alone."""
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _max_abs_err(got, ref):
    return max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
               for g, r in zip(got, ref))


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_tables(rng, nr):
    """(nr, 257) int32 valid cumulative rows (every freq >= 1, sum 2^16)."""
    rows = []
    for _ in range(nr):
        freqs = rng.integers(1, 600, 256).astype(np.int64)
        freqs = freqs * (65536 - 256) // freqs.sum() + 1
        freqs[0] += 65536 - freqs.sum()
        rows.append(np.concatenate([[0], np.cumsum(freqs)]))
    return np.stack(rows).astype(np.int32)


def phase_kernels(dev, L, K):
    """K1/K2 kernel vs plain, bit for bit; returns the kernel records."""
    from opendcvc_tpu_torch.entropy.device_rans import staging_width
    from opendcvc_tpu_torch.ops import lane_rans as LR

    rng = np.random.default_rng(0)
    n_y_rows = 128
    k_z = max(1, K // 17)                 # 16 of 272 steps are z
    table = torch.from_numpy(random_tables(rng, 2 * n_y_rows)).to(dev)
    sym = rng.integers(-128, 128, (K, L))
    rows = rng.integers(0, n_y_rows, (K, L))
    rows[K - k_z:] += n_y_rows            # z steps: combined rows 128..255
    skip = rng.random((K, L)) < 0.3
    skip[K - k_z:] = False                # z is never skipped
    rows = np.where(skip, LR.ENC_SKIP, rows)
    sym = np.where(skip, 0, sym)
    packed = LR.pack_operand(torch.from_numpy(sym),
                             torch.from_numpy(rows)).to(dev)

    # K1 at PR 1's shape (random symbols overflow some lanes at the first
    # rung: dropped words and over-counting cursors are part of the
    # contract), then at the main path's frames inside phase_k2
    k1_shapes = []
    _k1_case(dev, LR, packed, LR.prepare_encode_table(table),
             staging_width(K, 0.5), "random", k1_shapes)
    k2 = phase_k2(dev, LR, rng, table, n_y_rows, sym, skip, L, K, k1_shapes)
    k1_edges = _k1_edges(dev, LR, rng)
    for s in k1_shapes:
        _log(f"phase 2: K1 {s['launch']} K={s['steps']} mw={s['mw']}: "
             f"{s['ms']:.4f} ms, device {s['device_ms']:.4f} ms (plain "
             f"{s['plain_ms']:.3f} ms, bound {s['bound_ms']:.5f} ms by "
             f"{s['bound_by']}), {s['coded']} coded slots; bit-exact")
    head = k1_shapes[0]
    return [
        {"name": "lane_rans_encode (K1)", "route": "cuda",
         "source": "opendcvc_tpu_torch/csrc/lane_rans.cu",
         "replaces": "opendcvc_tpu/ops/pallas_rans.py:98",
         "max_abs_err": max([s["max_abs_err"] for s in k1_shapes]
                            + k1_edges),
         "ms": head["ms"], "device_ms": head["device_ms"],
         "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "library_ms": None,
         "shapes": k1_shapes},
        k2,
    ]


def _k1_bound(packed, mw, LR):
    """Bytes: the operand, 4 B (start and freq, each 16 bits) of every
    (row, symbol) it codes, once, the staging, lens and states;
    operations: ~10 a coded step."""
    coded = (packed & LR.ENC_ROW_MASK) != LR.ENC_SKIP
    n_entries = int(torch.unique(packed[coded]).numel())
    L = packed.shape[1]
    n_bytes = (packed.numel() * 4 + n_entries * 4 + L * mw * 4 + L * 12)
    n_coded = int(coded.sum())
    return _bound_ms(n_bytes, 10 * n_coded) + (n_coded,)


def _k1_case(dev, LR, packed, enc_table, mw, what, shapes):
    """K1 vs its plain version, bit for bit, then timed; appends the
    shape's record and returns K1's output."""
    K = packed.shape[0]
    got = LR.encode_scan(packed, enc_table, mw)
    err = _max_abs_err(got, LR.encode_scan_plain(packed, enc_table, mw))
    if err:
        _fail(f"K1 differs from its plain version at {what} K={K} mw={mw} "
              f"(max |err| {err})")
    ms = median_ms(lambda: LR.encode_scan(packed, enc_table, mw), dev)
    dev_ms = median_ms(lambda: LR.encode_scan(packed, enc_table, mw), dev,
                       queued=True)
    plain = median_ms(lambda: LR.encode_scan_plain(packed, enc_table, mw),
                      dev)
    bound, by, coded = _k1_bound(packed, mw, LR)
    shapes.append({"steps": K, "mw": mw, "launch": what, "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain,
                   "bound_ms": bound, "bound_by": by, "coded": coded,
                   "max_abs_err": err})
    return got


def _k1_edges(dev, LR, rng):
    """K1 vs its plain version, bit for bit, at the contract's edges: 99
    lanes (a partial warp, and a last block whose staging ends off a
    16-byte boundary), a 24-row table, row ids past it, ~20 % skips, odd
    staging widths that some lanes overflow, K below the entry lead (20)
    and past the operand ring (100).  Returns the max |err| of each."""
    lanes, nr = 99, 24
    table = LR.prepare_encode_table(
        torch.from_numpy(random_tables(rng, nr)).to(dev))
    errs = []
    for k, mw in ((20, 7), (100, 41)):
        rows = rng.integers(0, nr + 8, (k, lanes))
        rows[rng.random(rows.shape) < 0.2] = LR.ENC_SKIP
        packed = LR.pack_operand(
            torch.from_numpy(rng.integers(-128, 128, (k, lanes))),
            torch.from_numpy(rows)).to(dev)
        got = LR.encode_scan(packed, table, mw)
        errs.append(_max_abs_err(got, LR.encode_scan_plain(packed, table,
                                                           mw)))
        over = int((got[1] > mw).sum())
        if errs[-1] or not 0 < over < lanes:
            _fail(f"K1 at the contract's edges, K={k} mw={mw}: max |err| "
                  f"{errs[-1]}, {over} of {lanes} lanes overflowed")
        _log(f"phase 2: K1 at the contract's edges K={k} mw={mw}: "
             f"{over} of {lanes} lanes overflowed; bit-exact")
    return errs


def _enc_operand(dev, LR, rows, sym, skip):
    """K1's operand for decode-order (K, L) row ids and symbols, skip
    slots at zero rate: encode order reverses the steps."""
    rows_enc = np.where(skip, LR.ENC_SKIP, rows)
    sym = np.where(skip, 0, sym)
    return LR.pack_operand(torch.from_numpy(sym[::-1].copy()),
                           torch.from_numpy(rows_enc[::-1].copy())).to(dev)


def _decode_order(got, K):
    """K1's output with room for every word -> the (L, K) words in decode
    order and the final states."""
    buf, lens, states = got
    if int(lens.max()) > buf.shape[1]:
        _fail("K1 staging with room for every word overflowed")
    col = torch.arange(K, device=buf.device)[None, :]
    idx = (lens.to(torch.int64)[:, None] - 1 - col).clamp(min=0)
    data = torch.where(col < lens[:, None], torch.gather(buf, 1, idx), 0) \
        .to(torch.int32).contiguous()
    return data, states


def _k2_bound(rows, dec_table, ptr_in, ptr_out):
    """Bytes: rows and symbols, the compact table once, the words this
    run consumed, the carry in and out; operations: ~14 a coded step."""
    n_words = int((ptr_out.to(torch.int64) - ptr_in.to(torch.int64)).sum())
    n_coded = int((rows != 255).sum())
    L = rows.shape[1]
    n_bytes = (2 * rows.numel() * 4 + dec_table.numel() * 4 + n_words * 4
               + 2 * L * 12)
    return _bound_ms(n_bytes, 14 * n_coded)


def _model_tables():
    """The port's own y rows (GaussianEncoder) and one qp's z rows
    (BitEstimator, seeded init): (128, 257) int32 each."""
    from opendcvc_tpu_torch.entropy import models as M
    from opendcvc_tpu_torch.entropy.device_rans import full_range_cdf_rows
    be = M.bit_estimator_init(torch.Generator().manual_seed(1), 1, 128)
    return (full_range_cdf_rows(*M.GaussianEncoder().update()),
            full_range_cdf_rows(*M.BitEstimator(1, 128).update(be)))


def _draw(rng, cum, ids):
    """A symbol for every slot, drawn from the distribution of its row."""
    u = rng.integers(0, 65536, ids.shape)
    sym = np.empty(ids.shape, np.int64)
    for r in np.unique(ids):
        at = ids == r
        sym[at] = np.searchsorted(cum[r], u[at], side="right") - 129
    return sym


def phase_k2(dev, LR, rng, table, n_y_rows, sym, skip, L, K, k1_shapes):
    """K2 vs its plain version, bit for bit: one K-step launch over a
    128-row random table (uniform symbols), then a DMC frame's three and
    a DMCI frame's five carried launches at the main path's shapes over
    the port's own y and z tables, symbols drawn from each row; times
    every launch.  Each frame is coded by one K1 launch, checked and
    timed at the first and the top staging rung (into k1_shapes).
    Returns K2's kernel record."""
    from opendcvc_tpu_torch.entropy.device_rans import staging_width
    t_y = table[:n_y_rows].contiguous()
    d_y = LR.prepare_decode_table(t_y)
    errs, shapes = [], []

    def check(args, want, what):
        got = LR.decode_scan(*args)
        ref = LR.decode_scan_plain(*args)
        errs.append(_max_abs_err(got, ref))
        if errs[-1]:
            _fail(f"K2 differs from its plain version at {what} "
                  f"(max |err| {errs[-1]})")
        if not torch.equal(got[0].to(torch.int64), want):
            _fail(f"K2 did not decode what K1 encoded at {what}")
        return got

    def timed(args, got, what):
        ms = median_ms(lambda: LR.decode_scan(*args), dev)
        dev_ms = median_ms(lambda: LR.decode_scan(*args), dev, queued=True)
        plain = median_ms(lambda: LR.decode_scan_plain(*args), dev)
        bound, by = _k2_bound(args[1], args[2], args[4], got[2])
        shapes.append({"steps": args[1].shape[0], "launch": what, "ms": ms,
                       "device_ms": dev_ms, "plain_ms": plain,
                       "bound_ms": bound, "bound_by": by})
        return shapes[-1]

    def dec_rows(ids, skip_mask):
        return torch.from_numpy(np.where(skip_mask, 255, ids)) \
            .to(torch.int32).to(dev)

    # one K-step launch over the y rows (random rows, uniform symbols)
    ids = rng.integers(0, n_y_rows, (K, L))
    data, states = _decode_order(LR.encode_scan(
        _enc_operand(dev, LR, ids, sym, skip), LR.prepare_encode_table(t_y),
        K), K)
    args = (data, dec_rows(ids, skip), d_y, states,
            torch.zeros((L,), dtype=torch.int32, device=dev))
    got = check(args, torch.from_numpy(sym).to(dev), f"K={K}")
    head = timed(args, got, "one launch")

    # a frame: z (16 steps, never skipped), then n_y launches of 128 y
    # steps (DMC: two halves, DMCI: four quarters), coded by one K1 launch
    # against the combined [y | z] table and decoded with the carry
    k_z, k_y = 16, 128
    cum_y, cum_z = _model_tables()
    t_frame = torch.from_numpy(np.concatenate([cum_y, cum_z])).to(dev)
    e_frame = LR.prepare_encode_table(t_frame)
    d_fy, d_fz = (LR.prepare_decode_table(t_frame[a:a + len(cum_y)])
                  for a in (0, len(cum_y)))
    frame = {}
    for codec, n_y in (("DMC", 2), ("DMCI", 4)):
        ids = rng.integers(0, len(cum_y), (k_z + n_y * k_y, L))
        skip_f = rng.random(ids.shape) < 0.3
        skip_f[:k_z] = False
        sym_f = np.concatenate([_draw(rng, cum_z, ids[:k_z]),
                                _draw(rng, cum_y, ids[k_z:])])
        sym_f = np.where(skip_f, 0, sym_f)
        comb = ids.copy()
        comb[:k_z] += len(cum_y)
        packed = _enc_operand(dev, LR, comb, sym_f, skip_f)
        k_f = len(ids)
        _k1_case(dev, LR, packed, e_frame, staging_width(k_f, 0.5),
                 f"{codec} frame, first rung", k1_shapes)
        data, states = _decode_order(_k1_case(
            dev, LR, packed, e_frame, staging_width(k_f, 3.0),
            f"{codec} frame, top rung", k1_shapes), k_f)
        carry = (states, torch.zeros((L,), dtype=torch.int32, device=dev))
        segs = [("z", 0, k_z, d_fz)] + [
            (f"y{i}", k_z + i * k_y, k_z + (i + 1) * k_y, d_fy)
            for i in range(n_y)]
        frame[codec] = {"ms": 0.0, "device_ms": 0.0}
        for what, a, b, dt in segs:
            args = (data, dec_rows(ids[a:b], skip_f[a:b]), dt) + carry
            got = check(args, torch.from_numpy(sym_f[a:b]).to(dev),
                        f"{codec} {what} (K={b - a})")
            rec = timed(args, got, f"{codec} {what}")
            for key in frame[codec]:
                frame[codec][key] += rec[key]
            carry = got[1:]
    # the contract's edges on arbitrary words: 100 lanes (a partial warp),
    # a 24-row table, row ids past it, skips, pointers past either end
    lanes, k_e, nr_e, mw_e = 100, 40, 24, 20
    rows_e = rng.integers(0, nr_e + 8, (k_e, lanes))
    rows_e[rng.random(rows_e.shape) < 0.2] = 255
    arrays = (rng.integers(0, 1 << 16, (lanes, mw_e)).astype(np.int32),
              rows_e.astype(np.int32),
              rng.integers(1 << 16, 1 << 32, lanes),
              rng.integers(-3, mw_e + 3, lanes).astype(np.int32))
    data_e, rows_e, state_e, ptr_e = (torch.from_numpy(a).to(dev)
                                      for a in arrays)
    d_e = LR.prepare_decode_table(
        torch.from_numpy(random_tables(rng, nr_e)).to(dev))
    args = (data_e, rows_e, d_e, state_e, ptr_e)
    errs.append(_max_abs_err(LR.decode_scan(*args),
                             LR.decode_scan_plain(*args)))
    if errs[-1]:
        _fail(f"K2 differs from its plain version at the contract's edges "
              f"(max |err| {errs[-1]})")

    for s in shapes:
        _log(f"phase 2: K2 {s['launch']} K={s['steps']}: {s['ms']:.4f} ms, "
             f"device {s['device_ms']:.4f} ms (plain {s['plain_ms']:.3f} ms, "
             f"bound {s['bound_ms']:.5f} ms by {s['bound_by']})")
    for codec, t in frame.items():
        _log(f"phase 2: K2 per {codec} frame (sum of its timed launches): "
             f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms")
    _log(f"phase 2: K2 {len(d_y)}-row tables, {d_y.numel() * 4} B of "
         f"shared memory a block; bit-exact, carry exact across each "
         f"frame's launches, and at the contract's edges")
    return {"name": "lane_rans_decode (K2)", "route": "cuda",
            "source": "opendcvc_tpu_torch/csrc/lane_rans.cu",
            "replaces": "opendcvc_tpu/ops/pallas_rans.py:267",
            "max_abs_err": max(errs), "ms": head["ms"],
            "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shapes": shapes, "frame_ms": frame}


def synthetic_frames(height, width, n):
    """Noise frames rolled 4 px per frame, replicate-padded to 16."""
    from opendcvc_tpu_torch.models import common as C
    pr, pb = C.get_padding_size(height, width, 16)
    base = np.random.default_rng(0).random((1, height, width, 3),
                                           dtype=np.float32)
    return [np.pad(np.roll(base, 4 * t, axis=2),
                   ((0, 0), (0, pb), (0, pr), (0, 0)), mode="edge")
            for t in range(n)]


def _timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def phase_intra(dev, frame, qp, fz, dtype=torch.float32, label="phase 3"):
    from opendcvc_tpu_torch.models.dmci import DMCI
    net = DMCI(device=dev, device_ec=True, dtype=dtype)
    net.init_params(seed=0)     # cast to dtype; the banks set after it
    # flat banks (bench.py's surrogate for trained rate statistics)
    net.params["q_scale_enc"] = torch.ones_like(
        net.params["q_scale_enc"]) * 0.2
    net.params["q_scale_dec"] = torch.ones_like(net.params["q_scale_dec"])
    net.update(force_zero_thres=fz)
    sps = {"height": frame.shape[1], "width": frame.shape[2]}
    results = []
    for _ in range(2):   # the first pass warms cuDNN; the second is timed
        enc, enc_ms = _timed(lambda: net.compress(frame, qp), dev)
        dec, dec_ms = _timed(
            lambda: net.decompress(enc["bit_stream"], sps, qp), dev)
        if not torch.equal(enc["x_hat"], dec["x_hat"]):
            _fail("DMCI decoded frame differs from the encoder's")
        results.append((enc, enc_ms, dec_ms))
    enc, enc_ms, dec_ms = results[-1]
    x_hat = enc["x_hat"]
    if tuple(x_hat.shape) != tuple(frame.shape) or \
            not bool(torch.isfinite(x_hat).all()):
        _fail("DMCI x_hat has the wrong shape or is not finite")
    bpp = len(enc["bit_stream"]) * 8 / (frame.shape[1] * frame.shape[2])
    _log(f"{label}: DMCI {frame.shape[1]}x{frame.shape[2]} enc "
         f"{enc_ms:.1f} ms dec {dec_ms:.1f} ms (second pass), bpp "
         f"{bpp:.4f}, reruns {net._ec_rerun_count}; decoded frame exact")
    return {"params": net.params, "x_hat": x_hat, "bpp": bpp,
            "enc_ms": enc_ms, "dec_ms": dec_ms}


def phase_p(dev, x_ref, frames, qp, fz, dtype=torch.float32,
            label="phase 4"):
    from opendcvc_tpu_torch.models.dmc import DMC
    enc_net = DMC(device=dev, device_ec=True, dtype=dtype)
    enc_net.init_params(seed=1)
    enc_net.params["q_encoder"] = torch.ones_like(
        enc_net.params["q_encoder"]) * 0.25
    enc_net.params["q_decoder"] = torch.ones_like(
        enc_net.params["q_decoder"])
    enc_net.update(force_zero_thres=fz)
    dec_net = DMC(device=dev, device_ec=True, dtype=dtype)
    dec_net.load_params(enc_net.params)
    dec_net.update(force_zero_thres=fz)
    for net in (enc_net, dec_net):
        net.add_ref_frame(None, x_ref)
    sps = {"height": frames[0].shape[1], "width": frames[0].shape[2]}
    streams, feats, enc_ms = [], [], []
    for x in frames:
        s, ms = _timed(lambda: enc_net.compress(x, qp)["bit_stream"], dev)
        streams.append(s)
        enc_ms.append(ms)
        feats.append(enc_net.dpb[0].feature.clone())
    dec_ms, dec_x = [], []
    for i, s in enumerate(streams):
        out, ms = _timed(lambda: dec_net.decompress(s, sps, qp), dev)
        dec_ms.append(ms)
        dec_x.append(out["x_hat"])
        if not torch.equal(dec_net.dpb[0].feature, feats[i]):
            _fail(f"DMC enc/dec feature chain diverged at P-frame {i}")
        if not bool(torch.isfinite(out["x_hat"]).all()):
            _fail("DMC x_hat is not finite")
    bpp = [len(s) * 8 / (sps["height"] * sps["width"]) for s in streams]
    _log(f"{label}: DMC P-frames enc ms " + " ".join(f"{t:.1f}" for t in
                                                     enc_ms)
         + " | dec ms " + " ".join(f"{t:.1f}" for t in dec_ms)
         + " | bpp " + " ".join(f"{b:.4f}" for b in bpp)
         + f" | reruns {enc_net._ec_rerun_count}; feature chain exact")
    return {"params": enc_net.params, "feats": feats, "dec_x": dec_x,
            "bpp": bpp, "enc_ms": enc_ms, "dec_ms": dec_ms}


def phase_reference(dev, qp, fz):
    """The same 64x64 I-frame through the GPU and the CPU port, device EC
    and host EC."""
    from opendcvc_tpu_torch.models.dmci import DMCI
    x = np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32)
    sps = {"height": 64, "width": 64, "ec_part": 0}
    params = None
    for device_ec, mode in ((True, "device EC"), (False, "host EC")):
        nets = {d.type: DMCI(device=d, device_ec=device_ec)
                for d in (dev, torch.device("cpu"))}
        if params is None:
            params = nets["cpu"].init_params(seed=3)
        for net in nets.values():
            net.load_params(params)
            net.update(force_zero_thres=fz)
        enc = {k: n.compress(x, qp) for k, n in nets.items()}
        x_dev = enc[dev.type]["x_hat"].cpu()
        x_cpu = enc["cpu"]["x_hat"]
        cross = nets["cpu"].decompress(enc[dev.type]["bit_stream"], sps,
                                       qp)["x_hat"]
        err = max(float((x_dev - x_cpu).abs().max()),
                  float((cross - x_dev).abs().max()))
        same = enc[dev.type]["bit_stream"] == enc["cpu"]["bit_stream"]
        if err > 1e-3:
            _fail(f"GPU and CPU ports disagree on a 64x64 I-frame, {mode} "
                  f"({err:g})")
        _log(f"phase 5: 64x64 I-frame GPU vs CPU port, {mode}: max |x_hat "
             f"diff| {err:.3g}, CPU decodes the GPU stream, streams "
             f"identical: {same}")
    _reference_chain(dev, qp, fz)
    _reference_bf16(dev, qp, fz)


def _reference_bf16(dev, qp, fz):
    """Phase 5's bfloat16 row, reported and never failed (except on a
    crash): the 64x64 I-frame's encoder on the GPU and on the CPU, the
    share of equal symbols per plane and the max |x_hat diff|, and
    whether the CPU decodes the GPU's host-EC stream to the GPU's x_hat.
    cuDNN's and oneDNN's bfloat16 sums differ, so a symbol near a
    rounding boundary may round apart: a property of bfloat16, not a
    fault."""
    from opendcvc_tpu_torch.models import common as C
    from opendcvc_tpu_torch.models import dmci as I
    from opendcvc_tpu_torch.utils.params import to_device
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    x = np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32)
    params = I.DMCI(device=cpu, dtype=bf16).init_params(seed=3)
    enc = {}
    for d in (dev, cpu):
        x_hat, z, planes = I._encode_stages_i(
            to_device(params, d), C.frame_to_nchw(x, d, bf16), qp, fz)
        enc[d.type] = [x_hat.cpu(), z.cpu()] + [pl[0].cpu() for pl in planes]
    shares = [float((a == b).float().mean())
              for a, b in zip(enc[dev.type][1:], enc["cpu"][1:])]
    x_err = float((enc[dev.type][0] - enc["cpu"][0]).abs().max())
    nets = {}
    for d in (dev, cpu):
        nets[d.type] = I.DMCI(device=d, dtype=bf16)
        nets[d.type].load_params(params)
        nets[d.type].update(force_zero_thres=fz)
    gpu = nets[dev.type].compress(x, qp)
    try:
        cross = nets["cpu"].decompress(gpu["bit_stream"], {
            "height": 64, "width": 64, "ec_part": 0}, qp)["x_hat"]
        decoded = (f"CPU decodes the GPU's stream, max |x_hat diff| "
                   f"{float((cross - gpu['x_hat'].cpu()).abs().max()):.3g}")
    except ValueError as e:
        decoded = f"the CPU cannot decode the GPU's stream ({e})"
    _log(f"phase 5: 64x64 I-frame GPU vs CPU port, bfloat16 (reported): "
         f"equal symbols z / y0..y3 "
         + " / ".join(f"{100 * v:.2f} %" for v in shares)
         + f", max |x_hat diff| {x_err:.3g}; host EC: {decoded}")


def textured_frames(h, w, n, seed, shift=3):
    """n (h, w, 3) uint8 frames: a smooth gradient, a blocky texture that
    moves `shift` px a frame, and mild noise (so motion and residuals are
    not pure noise)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    grad = 48 + 96 * xx * np.float32([1.0, 0.3, 0.6]) \
        + 80 * yy * np.float32([0.2, 1.0, 0.5])
    wide = w + shift * n
    tex = rng.integers(0, 40, (-(-h // 4), -(-wide // 4), 3))
    tex = tex.repeat(4, 0).repeat(4, 1)[:h, :wide].astype(np.float32)
    return [np.clip(grad + tex[:, shift * t:shift * t + w]
                    + rng.normal(0, 1.5, (h, w, 3)).astype(np.float32),
                    0, 255).astype(np.uint8) for t in range(n)]


def _reference_chain(dev, qp, fz):
    """Phase 5's chain: a 64x64 I-frame and 3 P-frames coded on the GPU
    through host EC and decoded by the CPU port; the same frames are also
    coded on the CPU, to say whether the two devices write the same
    streams.  Fails on a decode error or a diff over 1e-3."""
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    cpu = torch.device("cpu")
    frames = [f[None].astype(np.float32) / 255.0
              for f in textured_frames(64, 64, 4, seed=5)]
    sps = {"height": 64, "width": 64, "ec_part": 0}
    params = {"I": DMCI(device=cpu).init_params(seed=3),
              "P": DMC(device=cpu).init_params(seed=4)}

    def codec(cls, d):
        net = cls(device=d)
        net.load_params(params["I" if cls is DMCI else "P"])
        net.update(force_zero_thres=fz)
        return net

    enc = {d.type: (codec(DMCI, d), codec(DMC, d)) for d in (dev, cpu)}
    dec_cpu = (codec(DMCI, cpu), codec(DMC, cpu))
    dec_gpu = codec(DMC, dev)
    streams = {}
    for t, x in enumerate(frames):
        if t == 0:
            out = {k: n[0].compress(x, qp) for k, n in enc.items()}
            streams = {k: o["bit_stream"] for k, o in out.items()}
            try:
                x_cpu = dec_cpu[0].decompress(streams[dev.type], sps,
                                              qp)["x_hat"]
            except ValueError as e:
                _fail(f"phase 5 chain: the CPU cannot decode the GPU's "
                      f"I-frame: {e}")
            x_gpu = out[dev.type]["x_hat"]
            for k, n in enc.items():
                n[1].add_ref_frame(None, out[k]["x_hat"])
            dec_cpu[1].add_ref_frame(None, x_cpu)
            dec_gpu.add_ref_frame(None, x_gpu)
            feat_err = 0.0
        else:
            streams = {k: n[1].compress(x, qp)["bit_stream"]
                       for k, n in enc.items()}
            try:
                x_cpu = dec_cpu[1].decompress(streams[dev.type], sps,
                                              qp)["x_hat"]
            except ValueError as e:
                _fail(f"phase 5 chain: the CPU cannot decode the GPU's "
                      f"P-frame {t}: {e}")
            x_gpu = dec_gpu.decompress(streams[dev.type], sps, qp)["x_hat"]
            f_gpu = enc[dev.type][1].dpb[0].feature.cpu()
            feat_err = float((dec_cpu[1].dpb[0].feature - f_gpu).abs()
                             .max()) / max(1.0, float(f_gpu.abs().max()))
        x_err = float((x_cpu - x_gpu.cpu()).abs().max())
        same = streams[dev.type] == streams["cpu"]
        _log(f"phase 5: host-EC chain, {'I' if t == 0 else 'P'}-frame {t} "
             f"coded on the GPU, decoded by the CPU: max |x_hat diff| "
             f"{x_err:.3g}, max |feature diff| / max(1, max|feature|) "
             f"{feat_err:.3g}; GPU and CPU streams identical: {same}")
        if max(x_err, feat_err) > 1e-3:
            _fail(f"phase 5 chain: GPU and CPU disagree at frame {t} "
                  f"(x_hat {x_err:g}, feature {feat_err:g})")


CODER_CALLS = ("reset", "encode_y", "encode_z", "flush",
               "get_encoded_stream", "set_stream", "decode_y", "decode_z",
               "get_decoded_tensor")


def _clock_coder(coder):
    """Wrap the host coder's calls so each adds its host time to the
    returned one-element list (ms)."""
    spent = [0.0]
    for name in CODER_CALLS:
        def timed(*args, _fn=getattr(coder, name), **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                spent[0] += (time.perf_counter() - t0) * 1e3
        setattr(coder, name, timed)
    return spent


def _clock_transfers(common):
    """Wrap the codecs' host transfers (models/common.py) so the host's
    waits for device->host copies and its upload calls add their host
    time (ms) to the returned dict; returns (dict, undo)."""
    spent = {"wait_ms": 0.0, "upload_ms": 0.0}
    fetch_async, upload = common.fetch_async, common.upload

    def timed_fetch_async(t):
        wait = fetch_async(t)

        def timed_wait():
            t0 = time.perf_counter()
            try:
                return wait()
            finally:
                spent["wait_ms"] += (time.perf_counter() - t0) * 1e3
        return timed_wait

    def timed_upload(a, device):
        t0 = time.perf_counter()
        try:
            return upload(a, device)
        finally:
            spent["upload_ms"] += (time.perf_counter() - t0) * 1e3

    common.fetch_async, common.upload = timed_fetch_async, timed_upload

    def undo():
        common.fetch_async, common.upload = fetch_async, upload
    return spent, undo


def _frame_record(net, spent, moves, fn, dev):
    """Run one frame's call, synchronized; returns (its result, {ms, the
    host coder's ms, device->host waits and their ms, uploads and their
    ms})."""
    before = (spent[0], dict(net.transfers), dict(moves))
    out, ms = _timed(fn, dev)
    rec = {"ms": ms, "coder_ms": spent[0] - before[0]}
    rec.update({k: net.transfers[k] - before[1][k] for k in net.transfers})
    rec.update({k: moves[k] - before[2][k] for k in moves})
    return out, rec


def phase_host(dev, frames, qp, fz, intra, p_run, dtype=torch.float32,
               label="phase 6"):
    """Phase 6 (and 9 (a) in bfloat16): the host-EC sequence at 1080p,
    written to and decoded from one NAL stream; held bit for bit against
    the device-EC run (phases 3-4)."""
    from opendcvc_tpu_torch.models import common
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    from opendcvc_tpu_torch.utils import stream_helper as S
    i_net = DMCI(device=dev, dtype=dtype)
    i_net.load_params(intra["params"])
    p_net = DMC(device=dev, dtype=dtype)
    p_net.load_params(p_run["params"])
    use_two = H * W > 1280 * 720      # the harness's rule, source size
    clocks = {}
    for name, net in (("I", i_net), ("P", p_net)):
        net.update(force_zero_thres=fz)
        net.set_use_two_entropy_coders(use_two)
        clocks[name] = _clock_coder(net.entropy_coder)
    sps = {"sps_id": -1, "height": H, "width": W,
           "ec_part": int(use_two), "use_ada_i": 0}

    # the first pass warms the host path; the sequence is the second
    warm = i_net.compress(frames[0], qp)
    i_net.decompress(warm["bit_stream"], dict(sps), qp)
    moves, undo = _clock_transfers(common)
    try:
        return _host_sequence(dev, frames, qp, intra, p_run, i_net, p_net,
                              clocks, moves, sps, S, label)
    finally:
        undo()


def _host_sequence(dev, frames, qp, intra, p_run, i_net, p_net, clocks,
                   moves, sps, S, label):
    """Encode the sequence into one NAL stream, then decode it from the
    bytes; fails on any difference from the device-EC run."""
    use_two = bool(sps["ec_part"])
    n_px = frames[0].shape[1] * frames[0].shape[2]
    buf, helper = io.BytesIO(), S.SPSHelper()
    enc_recs, streams, feats, sps_bytes = [], [], [], 0
    for t, x in enumerate(frames):
        if t == 0:
            enc, rec = _frame_record(i_net, clocks["I"], moves,
                                     lambda: i_net.compress(x, qp), dev)
            if not torch.equal(enc["x_hat"], intra["x_hat"]):
                _fail(f"{label}: host-EC I-frame x_hat differs from the "
                      f"device-EC run's")
            p_net.clear_dpb()
            p_net.add_ref_frame(None, enc["x_hat"])
            x_i, stream = enc["x_hat"], enc["bit_stream"]
        else:
            stream, rec = _frame_record(
                p_net, clocks["P"], moves,
                lambda: p_net.compress(x, qp)["bit_stream"], dev)
            feats.append(p_net.dpb[0].feature.clone())
            if not torch.equal(feats[-1], p_run["feats"][t - 1]):
                _fail(f"{label}: host-EC P-frame {t - 1} feature differs "
                      f"from the device-EC run's")
        sps_id, new = helper.get_sps_id(dict(sps))
        if new:
            sps_bytes += S.write_sps(buf, dict(sps, sps_id=sps_id))
        S.write_ip(buf, t == 0, sps_id, qp, stream)
        rec["bpp"] = len(stream) * 8 / n_px
        enc_recs.append(rec)
        streams.append(stream)
    data = buf.getvalue()

    # decode from the bytes, as the harness does
    rd, helper, dec_recs = io.BytesIO(data), S.SPSHelper(), []
    for t in range(len(frames)):
        header = S.read_header(rd)
        while header["nal_type"] == S.NalType.NAL_SPS:
            helper.add_sps_by_id(S.read_sps_remaining(rd, header["sps_id"]))
            header = S.read_header(rd)
        f_sps = helper.get_sps_by_id(header["sps_id"])
        f_qp, stream = S.read_ip_remaining(rd)
        if stream != streams[t] or f_qp != qp or f_sps["ec_part"] != \
                int(use_two):
            _fail(f"{label}: frame {t} does not read back from the NAL "
                  f"stream")
        if header["nal_type"] == S.NalType.NAL_I:
            dec, rec = _frame_record(
                i_net, clocks["I"], moves,
                lambda: i_net.decompress(stream, f_sps, f_qp), dev)
            if not torch.equal(dec["x_hat"], x_i):
                _fail(f"{label}: host-EC decoded I-frame differs from the "
                      f"encoder's")
            p_net.clear_dpb()
            p_net.add_ref_frame(None, dec["x_hat"])
        else:
            dec, rec = _frame_record(
                p_net, clocks["P"], moves,
                lambda: p_net.decompress(stream, f_sps, f_qp), dev)
            if not torch.equal(p_net.dpb[0].feature, feats[t - 1]):
                _fail(f"{label}: host-EC enc/dec feature chain diverged "
                      f"at P-frame {t - 1}")
            if not torch.equal(dec["x_hat"], p_run["dec_x"][t - 1]):
                _fail(f"{label}: host-EC decoded P-frame {t - 1} differs "
                      f"from the device-EC run's")
        dec_recs.append(rec)
    if rd.read() != b"":
        _fail(f"{label}: bytes left after the last frame of the NAL "
              f"stream")

    dev_bpp = [intra["bpp"]] + p_run["bpp"]

    def side(r):
        return (f"{r['ms']:.1f} ms (host coder {r['coder_ms']:.1f} ms; "
                f"{r['d2h']} device->host waits, {r['wait_ms']:.1f} ms; "
                f"{r['h2d']} uploads, {r['upload_ms']:.2f} ms)")

    for t, (e, d) in enumerate(zip(enc_recs, dec_recs)):
        _log(f"{label}: {'I' if t == 0 else 'P'}-frame {t}: enc {side(e)} "
             f"| dec {side(d)} | bpp {e['bpp']:.4f} (device EC "
             f"{dev_bpp[t]:.4f})")
    _log(f"{label}: NAL stream {len(data)} bytes for {len(frames)} frames "
         f"({sps_bytes} bytes of SPS, two coders: {use_two}); encoder "
         f"outputs equal the device-EC run's, decoded from the bytes: "
         f"I-frame exact, feature chain exact, P-frames equal the "
         f"device-EC run's")
    return {"enc": enc_recs, "dec": dec_recs, "stream_bytes": len(data)}


N_HARNESS = 16          # phase 7's frames (configs' UVG shape, cut)


def _write_sequence(root, h, w, n):
    """Phase 7's input in `root`: a raw 8-bit YUV420 sequence of n
    textured frames (the chroma subsampled by taking every other sample);
    returns its path."""
    os.makedirs(os.path.join(root, "data"))
    seq = os.path.join(root, "data", "seq1080.yuv")
    with open(seq, "wb") as f:
        for img in textured_frames(h, w, n, seed=7):
            f.write(img[:, :, 0].tobytes())
            f.write(np.ascontiguousarray(
                img[::2, ::2, 1:].transpose(2, 0, 1)).tobytes())
    return seq


def _write_config(root, h, w, n):
    """A dataset config that codes the first n frames of the sequence;
    returns its path."""
    cfg = os.path.join(root, f"config_{n}.json")
    with open(cfg, "w") as f:
        json.dump({"root_path": root, "test_classes": {"synthetic": {
            "test": 1, "base_path": "data", "src_type": "yuv420",
            "sequences": {"seq1080": {"width": w, "height": h, "frames": n,
                                      "intra_period": 32}}}}}, f)
    return cfg


def _record_codecs(harness, log):
    """Wrap the codecs that the harness's build_nets returns: each
    compress / decompress call logs its result and adds its host time,
    synchronized, to log["codec_s"].  Returns the undo."""
    build = harness.build_nets

    def recording(args):
        i_net, p_net = build(args)
        log["p_params"] = p_net.params
        for kind, net in (("I", i_net), ("P", p_net)):
            _wrap_codec(net, kind, log)
        return i_net, p_net

    harness.build_nets = recording
    return lambda: setattr(harness, "build_nets", build)


def _wrap_codec(net, kind, log):
    compress, decompress = net.compress, net.decompress

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(net.device)
        spent = time.perf_counter() - t0
        log["codec_s"] += spent
        log["calls"].append((kind, fn is compress, spent * 1e3))
        return out

    def enc(x, qp):
        out = timed(compress, x, qp)
        log["enc"].append((kind, out["x_hat"] if kind == "I"
                           else net.dpb[0].feature, qp))
        return out

    def dec(bit_stream, sps, qp):
        out = timed(decompress, bit_stream, sps, qp)
        log["dec"].append((kind, out["x_hat"],
                           net.dpb[0].feature if kind == "P" else None))
        return out

    net.compress, net.decompress = enc, dec


def _check_decoder_exact(log, mode, n):
    """Every decoded frame equals the encoder's, bit for bit: the I-frame's
    x_hat, and for a P-frame the feature and the frame the encoder's
    feature reconstructs."""
    from opendcvc_tpu_torch.models import common as C
    from opendcvc_tpu_torch.models.dmc import _stage_recon_x
    if not len(log["enc"]) == len(log["dec"]) == n:
        _fail(f"{mode}: {len(log['enc'])} frames encoded, "
              f"{len(log['dec'])} decoded")
    for t, ((kind, e, qp), (_, x_dec, f_dec)) in enumerate(
            zip(log["enc"], log["dec"])):
        if kind == "I":
            same = torch.equal(e, x_dec)
        else:
            x_enc = C.frame_to_nhwc(_stage_recon_x(log["p_params"], e, qp))
            same = torch.equal(e, f_dec) and torch.equal(x_enc, x_dec)
        if not same:
            _fail(f"{mode}: decoded frame {t} ({kind}) differs from the "
                  f"encoder's")


def _refresh_frames(bin_path):
    """The frames whose SPS in a NAL .bin sets use_ada_i (the refresh)."""
    from opendcvc_tpu_torch.utils import stream_helper as S
    with open(bin_path, "rb") as f:
        rd = io.BytesIO(f.read())
    helper, out, t = S.SPSHelper(), [], 0
    while rd.tell() < len(rd.getbuffer()):
        header = S.read_header(rd)
        while header["nal_type"] == S.NalType.NAL_SPS:
            helper.add_sps_by_id(S.read_sps_remaining(rd, header["sps_id"]))
            header = S.read_header(rd)
        if helper.get_sps_by_id(header["sps_id"])["use_ada_i"]:
            out.append(t)
        S.read_ip_remaining(rd)
        t += 1
    return out


def _recon_psnr(src_path, rec_path, h, w, n):
    """Mean over the first n frames of (6 PSNR_Y + PSNR_U + PSNR_V) / 8,
    from the files."""
    fsz, ysz = h * w * 3 // 2, h * w
    src, rec = (np.fromfile(p, np.uint8, count=n * fsz).reshape(n, fsz)
                .astype(np.float64) for p in (src_path, rec_path))
    out = []
    for s, r in zip(src, rec):
        planes = (slice(0, ysz), slice(ysz, ysz + ysz // 4),
                  slice(ysz + ysz // 4, fsz))
        p = [min(99.9, 10 * np.log10(255.0 ** 2 / max(
            np.mean((s[sl] - r[sl]) ** 2), 1e-10))) for sl in planes]
        out.append((6 * p[0] + p[1] + p[2]) / 8)
    return float(np.mean(out))


HARNESS_STEPS = {"_read_src_frame": "file reads",
                 "ycbcr420_to_444_np": "chroma upsampling",
                 "get_src_frame": "codec input (read, upsample, upload, pad)",
                 "_postprocess": "recon crop/convert/clip + fetch",
                 "_distortion": "metrics",
                 "_write_recon": "recon writes"}


def _clock_harness(harness):
    """Wrap the harness's host steps (module functions, which call each
    other through the module, so get_src_frame's time includes its read
    and upsampling); each adds its host time (s) to the returned dict.
    Returns (dict, undo)."""
    spent = dict.fromkeys(HARNESS_STEPS, 0.0)
    saved = {name: getattr(harness, name) for name in HARNESS_STEPS}
    for name, fn in saved.items():
        def timed(*args, _fn=fn, _name=name):
            t0 = time.perf_counter()
            try:
                return _fn(*args)
            finally:
                spent[_name] += time.perf_counter() - t0
        setattr(harness, name, timed)

    def undo():
        for name, fn in saved.items():
            setattr(harness, name, fn)
    return spent, undo


def _harness_run(harness, LR, root, seq, device_ec, n=N_HARNESS,
                 dtype="float32", phase="phase 7"):
    """One harness run on the first n frames of the sequence, in process,
    through the port's CLI entry point; returns its per-job log, .bin
    size, kernel launches and codec time."""
    tag = ("device_ec" if device_ec else "host_ec") + \
        ("" if dtype == "float32" else f"_{dtype}")
    mode = f"{phase} {'device EC' if device_ec else 'host EC'}" + \
        ("" if dtype == "float32" else f" {dtype}")
    cfg = _write_config(root, H, W, n)
    log = {"enc": [], "dec": [], "codec_s": 0.0, "calls": []}
    saved = os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
    if device_ec:
        os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    undo = _record_codecs(harness, log)
    steps, undo_steps = _clock_harness(harness)
    LR.encode_scan.launches = 0
    LR.decode_scan.launches = 0
    try:
        harness.main([
            "--test_config", cfg,
            "--output_path", os.path.join(root, f"{tag}.json"),
            "--stream_path", os.path.join(root, tag), "--rate_num", "1",
            "--qp_i", str(QP), "--qp_p", str(QP),
            "--force_zero_thres", str(FZ), "--reset_interval", "8",
            "--verbose", "1", "--verbose_json", "1",
            "--save_decoded_frame", "1", "--seed", "0", "--device", "cuda",
            "--dtype", dtype])
    finally:
        undo_steps()
        undo()
        os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
        if saved is not None:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = saved
    launches = [LR.encode_scan.launches, LR.decode_scan.launches]
    out_dir = os.path.join(root, tag, "synthetic")
    with open(os.path.join(out_dir, f"seq1080_q{QP}.json")) as f:
        job = json.load(f)
    _check_decoder_exact(log, mode, n)
    n_bytes = os.path.getsize(os.path.join(out_dir, f"seq1080_q{QP}.bin"))
    if round(sum(job["frame_bpp"]) * job["frame_pixel_num"]) != 8 * n_bytes:
        _fail(f"{mode}: the log's bits differ from 8 x the .bin's "
              f"{n_bytes} bytes")
    if (job["i_frame_num"], job["p_frame_num"]) != (1, n - 1):
        _fail(f"{mode}: frame counts {job['i_frame_num']} I, "
              f"{job['p_frame_num']} P")
    refresh = _refresh_frames(os.path.join(out_dir, f"seq1080_q{QP}.bin"))
    if refresh != list(range(1, n, 8)):
        _fail(f"{mode}: periodic refresh at frames {refresh}, not every "
              f"8 from frame 1")
    (rec,) = [p for p in os.listdir(out_dir) if p.endswith("kbps.yuv")]
    rec = os.path.join(out_dir, rec)
    if os.path.getsize(rec) != n * H * W * 3 // 2:
        _fail(f"{mode}: recon file of {os.path.getsize(rec)} bytes")
    psnr_files = _recon_psnr(seq, rec, H, W, n)
    if not abs(psnr_files - job["ave_all_frame_psnr"]) <= 0.5:
        _fail(f"{mode}: PSNR from the files {psnr_files:.4f} dB, the "
              f"log's {job['ave_all_frame_psnr']:.4f} dB")
    outside = job["test_time"] - log["codec_s"]
    p_ms = [float(np.median([ms for kind, enc, ms in log["calls"][2:]
                             if kind == "P" and enc == side]))
            for side in (True, False)]
    avg = " ".join(f"{k} {job[k] * 1e3:.2f} ms" for k in
                   ("avg_frame_encoding_time", "avg_frame_decoding_time")
                   if job.get(k) is not None)
    _log(f"{mode}: harness {avg or 'avg frame times n/a'} (frames 10 on), "
         f"P-frame codec calls enc {p_ms[0]:.2f} / dec {p_ms[1]:.2f} ms "
         f"(median, synchronized), bpp {job['ave_all_frame_bpp']:.4f}, PSNR "
         f"{job['ave_all_frame_psnr']:.4f} dB (from the files "
         f"{psnr_files:.4f}), test_time {job['test_time']:.2f} s, codec "
         f"calls {log['codec_s']:.2f} s, outside the codecs {outside:.2f} s; "
         f".bin {n_bytes} B; K1 {launches[0]}, K2 {launches[1]} launches; "
         f"decoder exact on all {n} frames")
    _log(f"{mode}: harness host steps (s, {n} frames): "
         + ", ".join(f"{HARNESS_STEPS[k]} {v:.3f}" for k, v in steps.items()))
    return {"job": job, "launches": launches}


def phase_harness(root, seq):
    """Phase 7: the RD harness (`eval.harness.main`) on a 1080p YUV420
    sequence from a dataset config, host EC then device EC; returns the
    device-EC run's K1 and K2 launches."""
    from opendcvc_tpu_torch.eval import harness
    from opendcvc_tpu_torch.ops import lane_rans as LR
    pil_before = "PIL" in sys.modules
    host = _harness_run(harness, LR, root, seq, device_ec=False)
    dev = _harness_run(harness, LR, root, seq, device_ec=True)
    if max(host["launches"]):
        _fail("phase 7: the host-EC harness run launched a lane rANS kernel")
    if min(dev["launches"]) == 0:
        _fail("phase 7: the device-EC harness run did not launch K1 and K2")
    if host["job"]["frame_psnr"] != dev["job"]["frame_psnr"]:
        _fail("phase 7: per-frame PSNR differs between host and device EC")
    if not pil_before and "PIL" in sys.modules:
        _fail("phase 7 imported PIL")
    _log("phase 7: per-frame PSNR equal in host and device EC; bits equal "
         "8 x each .bin; periodic refresh at frames 1 and 9 in both")
    return dev["launches"]


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if card.returncode != 0:
        _fail(f"nvidia-smi failed: {card.stderr.strip()}")
    return card.stdout.strip().splitlines()[0]


def _copy_ms(shape, dev):
    """Median ms of one int16 copy of `shape` device->host (into pinned
    memory) and host->device (from it), with CUDA events around each."""
    src = torch.zeros(shape, dtype=torch.int16, device=dev)
    host = torch.empty(shape, dtype=torch.int16, pin_memory=True)
    d2h = median_ms(lambda: host.copy_(src, non_blocking=True), dev)
    h2d = median_ms(lambda: src.copy_(host, non_blocking=True), dev)
    return d2h, h2d


def _bench_checks(st, dev, label):
    """Phase 8's holds: the first GOP chunk's streams against the same
    frames coded one by one, the GOP decode against the per-frame decode
    (x_hats and features), the batched intra streams, x_hats and decode
    against the single-frame calls."""
    from opendcvc_tpu_torch.models.dmc import DMC
    p_net, d_net, qp, qps = st["p_net"], st["d_net"], st["qp"], st["qps"]

    def p_codec():
        net = DMC(device=dev, device_ec=True, lanes=p_net.lanes,
                  bytes_per_symbol=p_net.bytes_per_symbol,
                  cap_frac=p_net.cap_frac, dtype=p_net.dtype)
        net.load_params(p_net.params)
        net.update(force_zero_thres=st["fz"])
        net.add_ref_frame(None, st["enc0"]["x_hat"])
        return net

    one = p_codec()
    for x in st["seed_frames"]:
        one.compress_async(x, qp)()
    for t, x in enumerate(st["chunks"][0]):
        if one.compress_async(x, qps[t])() != st["chunk_streams"][0][t]:
            _fail(f"{label}: GOP stream of chunk 0 frame {t} differs from "
                  f"the frame coded alone through compress_async")

    per, gop = p_codec(), p_codec()
    for net in (per, gop):
        for s in st["seed_streams"]:
            net.decompress(s, st["sps"], qp)
    per_x = [per.decompress(s, st["sps"], q)["x_hat"]
             for streams in st["chunk_streams"] for s, q in zip(streams, qps)]
    x_gop = gop.decompress_gop(st["chunk_streams"][0], st["sps"],
                               qps)["x_hat"]
    n = st["gop_n"]
    if not all(torch.equal(x_gop[t], per_x[t]) for t in range(n)):
        _fail(f"{label}: decompress_gop differs from the per-frame decode")
    if not all(torch.equal(st["dec_out"]["x_hat"][t], per_x[t - n])
               for t in range(n)):
        _fail(f"{label}: the last uploaded chunk's decode differs from the "
              "per-frame decode")
    for what, f in (("GOP decoder", d_net.dpb[0].feature),
                    ("encoder", p_net.dpb[0].feature)):
        if not torch.equal(per.dpb[0].feature, f):
            _fail(f"{label}: the per-frame decoder's final feature differs "
                  f"from the {what}'s")
    if not all(bool(torch.isfinite(x).all()) for x in per_x):
        _fail(f"{label}: a decoded P-frame is not finite")

    i_net, i_dec = st["i_net"], st["i_dec"]
    for t, x in enumerate(st["i_frames"]):
        enc = i_net.compress(x, qp)
        if enc["bit_stream"] != st["i_streams"][t] or \
                not torch.equal(enc["x_hat"], st["i_x_hats"][t]):
            _fail(f"{label}: compress_batch frame {t} differs from "
                  f"DMCI.compress")
        dec = i_dec.decompress(enc["bit_stream"], st["i_sps"], qp)["x_hat"]
        if not torch.equal(dec, st["i_dec_out"][t]) or \
                not torch.equal(dec, enc["x_hat"]):
            _fail(f"{label}: decompress_batch frame {t} differs from "
                  f"decompress or from the encoder's x_hat")
    return len(per_x) + n


def phase_bench(dev, LR, label="phase 8", env=None):
    """Phase 8 (and 9 (b) with env BENCH_DTYPE=bfloat16):
    `opendcvc_tpu_torch.bench` in process at bench.py's defaults (BENCH_*
    and OPENDCVC_TPU_EC_* unset but for `env`), then its holds; returns
    its K1 and K2 launches, which must match the frames it coded and
    decoded."""
    from opendcvc_tpu_torch import bench
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("BENCH_", "OPENDCVC_TPU_EC_"))}
    os.environ.update(env or {})
    LR.encode_scan.launches = 0
    LR.decode_scan.launches = 0
    t0 = time.perf_counter()
    try:
        st = bench.run()
    finally:
        for k in env or {}:
            os.environ.pop(k)
        os.environ.update(saved)
    launches = [LR.encode_scan.launches, LR.decode_scan.launches]
    bench_s = time.perf_counter() - t0
    coded, decoded, n, gop_n = (st["coded"], st["decoded"], st["n_frames"],
                                st["gop_n"])
    want_p = 2 * len(st["seed_frames"]) + gop_n + n
    if coded["P"] != want_p or decoded["P"] != want_p or \
            decoded["I"] != 3 * len(st["i_frames"]):
        _fail(f"{label}: frames coded {coded}, decoded {decoded}")
    want = [coded["I"] + coded["P"] + st["reruns"],
            5 * decoded["I"] + 3 * decoded["P"]]
    if launches != want:
        _fail(f"{label}: K1/K2 launched {launches} times, the frames coded "
              f"and decoded need {want}")
    line = st["result"]
    _log(f"{label}: {_card()}")
    _log(f"{label}: bench line " + json.dumps(line))
    _log(f"{label}: " + st["verbose"])
    _log(f"{label}: {n} P-frames in chunks of {gop_n}; encode ms a chunk "
         + " ".join(f"{t:.1f}" for t in st["enc_chunk_ms"])
         + " | decode ms a chunk " + " ".join(f"{t:.1f}" for t in
                                                st["dec_chunk_ms"])
         + f" | intra batch of {len(st['i_frames'])}: encode ms "
         + " ".join(f"{t:.1f}" for t in st["intra_enc_ms"]) + ", decode ms "
         + " ".join(f"{t:.1f}" for t in st["intra_dec_ms"])
         + f" | reruns {st['reruns']}; bench {bench_s:.1f} s")

    p_net, (h, w) = st["p_net"], st["size"]
    lanes, _, k_total = p_net._plan_device_ec(-(-h // 16) * 16,
                                              -(-w // 16) * 16)
    mw, cap = p_net._rung(lanes, k_total, max(
        p_net.bytes_per_symbol, max(p_net._ec_learned.values(), default=0)))
    shape = (gop_n, cap + 3 * lanes)
    d2h, h2d = _copy_ms(shape, dev)
    payload = sum(len(s) for s in st["chunk_streams"][0])
    _log(f"{label}: a chunk's stagings {shape[0]} x {shape[1]} u16 = "
         f"{2 * shape[0] * shape[1]} B (streams {payload} B; lanes {lanes}, "
         f"mw {mw}, cap {cap}); one copy of them: device->host "
         f"{d2h:.4f} ms, host->device {h2d:.4f} ms (pinned, median of "
         f"{REPS})")

    checked = _bench_checks(st, dev, label)
    _log(f"{label}: K1 {launches[0]} launches ({coded['I']} I + "
         f"{coded['P']} P coded + {st['reruns']} reruns), K2 {launches[1]} "
         f"({decoded['I']} I x 5 + {decoded['P']} P x 3); GOP chunk 0 == "
         f"compress_async frame by frame; decompress_gop and the uploaded "
         f"chunks == {checked} per-frame decodes, final features equal, "
         f"enc/dec chain exact; compress_batch / decompress_batch == "
         f"compress / decompress on {len(st['i_frames'])} frames")
    return launches


N_BF16_HARNESS = 8      # phase 9 (c)'s frames, the first of phase 7's


def _times(intra, p_run):
    """The frame times (ms) and bpp of a device-EC I-frame and P-frame
    run (phase_intra, phase_p)."""
    return {"i_enc": intra["enc_ms"], "i_dec": intra["dec_ms"],
            "i_bpp": intra["bpp"], "enc_ms": p_run["enc_ms"],
            "dec_ms": p_run["dec_ms"], "bpp": p_run["bpp"]}


def phase_bf16(dev, LR, frames, f32, root, seq):
    """Phase 9: DCVC-RT in bfloat16 at 1080p full width, phases 3-8's
    configuration.  (a) DMCI + 4 DMC P-frames through device EC, then
    through host EC (two coders, one NAL stream), each exact within
    itself and the two equal; (b) the bench with BENCH_DTYPE=bfloat16;
    (c) the harness with --dtype bfloat16 and device EC on the first
    N_BF16_HARNESS frames of phase 7's sequence.  f32: phases 3-4's
    results, printed beside (a)'s.  Returns the K1 and K2 launches of
    each device-EC run."""
    from opendcvc_tpu_torch.eval import harness
    bf16 = torch.bfloat16
    runs = {}

    LR.encode_scan.launches = 0
    LR.decode_scan.launches = 0
    intra = phase_intra(dev, frames[0], QP, FZ, bf16, "phase 9 (a)")
    p_run = phase_p(dev, intra["x_hat"], frames[1:], QP, FZ, bf16,
                    "phase 9 (a)")
    runs["phase 9 (a) device EC"] = [LR.encode_scan.launches,
                                     LR.decode_scan.launches]
    if min(runs["phase 9 (a) device EC"]) == 0:
        _fail("phase 9 (a): the device-EC run did not launch K1 and K2")
    if intra["x_hat"].dtype != bf16 or p_run["feats"][0].dtype != bf16:
        _fail("phase 9 (a): the codecs did not run in bfloat16")
    LR.encode_scan.launches = 0
    LR.decode_scan.launches = 0
    phase_host(dev, frames, QP, FZ, intra, p_run, bf16,
               "phase 9 (a) host EC")
    if max(LR.encode_scan.launches, LR.decode_scan.launches):
        _fail("phase 9 (a): the host-EC run launched a lane rANS kernel")
    for name, r in (("float32 (phases 3-4)", f32),
                    ("bfloat16 (phase 9 a)", _times(intra, p_run))):
        _log(f"phase 9 (a): device EC, {name}: I-frame enc "
             f"{r['i_enc']:.1f} / dec {r['i_dec']:.1f} ms, bpp "
             f"{r['i_bpp']:.4f}; P-frames enc ms "
             + " ".join(f"{t:.1f}" for t in r["enc_ms"]) + " | dec ms "
             + " ".join(f"{t:.1f}" for t in r["dec_ms"]) + " | bpp "
             + " ".join(f"{b:.4f}" for b in r["bpp"]))

    runs["phase 9 (b)"] = phase_bench(dev, LR, "phase 9 (b)",
                                      {"BENCH_DTYPE": "bfloat16"})
    run_c = _harness_run(harness, LR, root, seq, device_ec=True,
                         n=N_BF16_HARNESS, dtype="bfloat16",
                         phase="phase 9 (c)")
    runs["phase 9 (c)"] = run_c["launches"]
    if min(run_c["launches"]) == 0:
        _fail("phase 9 (c): the device-EC harness run did not launch K1 "
              "and K2")
    return runs


def main():
    if not torch.cuda.is_available():
        _fail("CUDA is not available")
    try:
        import opendcvc_tpu_torch  # noqa: F401  (pins cuDNN determinism)
        from opendcvc_tpu_torch.ops import _build
        from opendcvc_tpu_torch.ops import lane_rans as LR
    except ImportError as e:
        _fail(f"the port's package is missing: {e}")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    _build.load_kernels()
    _log(f"phase 1: kernels built and loaded in "
         f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                _log(f"  {name}: {line.strip()}")

    kernels = phase_kernels(dev, L_MAIN, K_MAIN)

    frames = synthetic_frames(H, W, 5)
    LR.encode_scan.launches = 0
    LR.decode_scan.launches = 0
    intra = phase_intra(dev, frames[0], QP, FZ)
    p_run = phase_p(dev, intra["x_hat"], frames[1:], QP, FZ)
    f32 = _times(intra, p_run)
    launches = [LR.encode_scan.launches, LR.decode_scan.launches]
    _log(f"main path launches: K1 {launches[0]}, K2 {launches[1]}")
    if min(launches) == 0:
        _fail("a kernel of the main path was never launched")
    for k, n in zip(kernels, launches):
        k["launches"] = n

    phase_reference(dev, QP, FZ)

    LR.encode_scan.launches = 0
    LR.decode_scan.launches = 0
    phase_host(dev, frames, QP, FZ, intra, p_run)
    host_launches = [LR.encode_scan.launches, LR.decode_scan.launches]
    _log(f"host-EC path launches: K1 {host_launches[0]}, K2 "
         f"{host_launches[1]}")
    if max(host_launches):
        _fail("the host-EC path launched a lane rANS kernel")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        seq = _write_sequence(root, H, W, N_HARNESS)
        _log(f"phase 7: {N_HARNESS} frames of {W}x{H} YUV420 written in "
             f"{time.perf_counter() - t0:.1f} s")
        runs = {"phase 7 device EC": phase_harness(root, seq),
                "phase 8": phase_bench(dev, LR)}
        runs.update(phase_bf16(dev, LR, frames, f32, root, seq))
    for i, k in enumerate(kernels):
        k["launches_by_run"] = {"phases 3-4": k["launches"]}
        for name, n in runs.items():
            k["launches_by_run"][name] = n[i]
            k["launches"] += n[i]

    card = _card()
    _log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)   # name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
