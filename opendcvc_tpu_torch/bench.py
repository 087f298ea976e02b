"""Headline benchmark of the port: 1080p P-frame encode AND decode
throughput of DCVC-RT's GOP-batched device-EC path, plus the batched
intra fps.

    python -m opendcvc_tpu_torch.bench          # on the card
    BENCH_PLATFORM=cpu BENCH_HEIGHT=64 BENCH_WIDTH=64 BENCH_FRAMES=2 \\
        BENCH_GOP_N=2 BENCH_INTRA_FRAMES=2 python -m opendcvc_tpu_torch.bench

A port of the JAX package's bench.py (its main, bench.py:133-429): the
same content, configuration, timed regions and output line.  The P-frame
codec (DMC) codes GOP chunks of N frames (`compress_gop_async`, one
device->host copy a chunk; `upload_gop` + `decompress_gop_uploaded`, one
upload a chunk); the intra codec (DMCI) codes batches
(`compress_batch_async`, `decompress_batch`).  Symbols are coded on the
device by the lane rANS kernels K1/K2.

Prints ONE JSON line:
  {"metric": "1080p_p_frame_enc_dec_fps", "value": N, "unit": "fps",
   "vs_baseline": N, "enc_fps": N, "dec_fps": N, "bpp": N,
   "gop_n": N, "intra_enc_fps": N, "intra_dec_fps": N}
and "ec_reruns" when the staging ladder re-ran a frame (the trace's
`ec.rerun` over the run).  value =
min(enc_fps, dec_fps); vs_baseline compares it with bench.py's A100
figures (125.2 enc / 112.8 dec fps).

Env knobs, with bench.py's defaults: BENCH_FRAMES (32; rounded to a GOP
multiple), BENCH_GOP_N (8), BENCH_HEIGHT / BENCH_WIDTH (1080 / 1920),
BENCH_DTYPE (float32, bench.py's default off a TPU; bfloat16 codes in
bfloat16, the frames cast before their padding and the flat banks set
after the init's cast, as bench.py does), BENCH_Q_SCALE (0.25, the P-frame banks),
BENCH_Q_SCALE_I (0.2, the intra banks), BENCH_FZ (force_zero_thres 0.12;
negative disables), BENCH_DECODE=0 skips the decode half, BENCH_INTRA=0
the intra half, BENCH_INTRA_FRAMES (8), BENCH_CKPT_I (a full-size DMCI
checkpoint of the JAX package, then synthetic content),
BENCH_CKPT_EC_BPS (0.9, the intra staging rate with BENCH_CKPT_I),
BENCH_VERBOSE (a second, human-readable line).  Device EC: 4096 lanes,
0.4 bytes per symbol and a P-frame cap fraction of 0.375, as bench.py
sets them; OPENDCVC_TPU_EC_LANES / _EC_BPS / _EC_CAP_FRAC override them.
The intra codec keeps its 0.5 cap, as the JAX package's DMCI does.

Differences from bench.py:
  * BENCH_PLATFORM=cpu runs on the CPU; otherwise it runs on "cuda", and
    without CUDA it prints bench.py's infra_error line and exits with 3.
  * No `last_good` in that line: the BENCH_r*.json files it reads hold
    TPU numbers.  No subprocess preflight.
  * The enc/dec feature-chain gate raises RuntimeError instead of an
    assert.
  * The weights are the port's torch.Generator init (seeds 0 and 1), not
    the JAX package's, so bpp is the port's own.
  * Each block_until_ready becomes torch.cuda.synchronize() on the
    codecs' device.
  * The EC settings are passed to the codecs, not written into the
    environment, and device EC is always on (bench.py's GOP and batch
    calls exist only there).
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .models import common as C
from .models.dmc import DMC
from .models.dmci import DMCI
from .ops.fused import replicate_pad
from .utils import trace

METRIC = "1080p_p_frame_enc_dec_fps"
BASELINE_ENC_FPS = 125.2
BASELINE_DEC_FPS = 112.8


def _infra_fail(reason):
    print(json.dumps({"metric": METRIC, "value": 0, "unit": "fps",
                      "vs_baseline": 0, "infra_error": True,
                      "error": reason}), flush=True)
    sys.exit(3)


def _env_on(name):
    return os.environ.get(name, "1") not in ("0", "false")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device():
    if os.environ.get("BENCH_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        _infra_fail("infra: CUDA is not available (BENCH_PLATFORM=cpu runs "
                    "on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def _intra_net(dev, dtype, fz, lanes, bps):
    """The intra codec: a JAX package checkpoint under BENCH_CKPT_I (its
    float32 leaves cast to `dtype`, as bench.py casts them), else the
    port's init (seed 0) with flat q banks."""
    from .utils import checkpoint as ckpt
    from .utils.params import cast_floating, from_jax
    ckpt_i = os.environ.get("BENCH_CKPT_I")
    if ckpt_i:
        # trained statistics need a larger first staging rung
        bps = float(os.environ.get("BENCH_CKPT_EC_BPS", 0.9))
    net = DMCI(device=dev, device_ec=True, lanes=lanes, bytes_per_symbol=bps,
               dtype=dtype)
    if ckpt_i:
        payload = ckpt.load_checkpoint(ckpt_i)
        kw = (payload.get("extra") or {}).get("model_kwargs", {})
        if kw:
            raise ValueError(f"BENCH_CKPT_I must be a full-size DMCI "
                             f"checkpoint (got model_kwargs={kw})")
        net.load_params(cast_floating(from_jax(payload["params"], dev),
                                      dtype))
    else:
        net.init_params(seed=0)
        # flat unit banks: random weights with the init's log-spaced rate
        # ladder give out-of-model symbol magnitudes at mid QPs; flat
        # banks keep the entropy-coding load near trained statistics
        q_i = float(os.environ.get("BENCH_Q_SCALE_I", 0.2))
        net.params["q_scale_enc"] = torch.ones_like(
            net.params["q_scale_enc"]) * q_i
        net.params["q_scale_dec"] = torch.ones_like(net.params["q_scale_dec"])
    net.update(force_zero_thres=fz)
    return net, bool(ckpt_i)


class _Marks:
    """Time stamps of a pipelined region, one after each chunk is queued:
    CUDA events on a card (so an interval is the device's time for a
    chunk; read them after a synchronize), the host clock on the CPU."""

    def __init__(self, dev):
        self.dev, self.marks = dev, []
        self.mark()

    def mark(self):
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        if self.dev.type == "cuda":
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def run():
    """Run the benchmark; returns its state: "result" (the JSON line's
    dict), the codecs, content and streams of each half, per-chunk and
    per-call times, and the frames each half coded and decoded."""
    dev = _device()
    dtype_name = os.environ.get("BENCH_DTYPE", "float32")
    dtype = C.DTYPES[dtype_name]
    gop_n = int(os.environ.get("BENCH_GOP_N", 8))
    n_frames = int(os.environ.get("BENCH_FRAMES", 32))
    n_frames = max(gop_n, n_frames // gop_n * gop_n)
    n_chunks = n_frames // gop_n
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    width = int(os.environ.get("BENCH_WIDTH", 1920))
    qp = 21
    fz = float(os.environ.get("BENCH_FZ", 0.12))
    fz = None if fz < 0 else fz
    lanes = C.ec_setting(None, "OPENDCVC_TPU_EC_LANES", 4096)
    bps = C.ec_setting(None, "OPENDCVC_TPU_EC_BPS", 0.4)
    cap_frac = C.ec_setting(None, "OPENDCVC_TPU_EC_CAP_FRAC", 0.375)
    coded = {"I": 0, "P": 0}
    decoded = {"I": 0, "P": 0}
    reruns0 = trace.counters().get("ec.rerun", 0)

    def reruns():
        return trace.counters().get("ec.rerun", 0) - reruns0

    i_net, ckpt_i = _intra_net(dev, dtype, fz, lanes, bps)

    def p_codec():
        return DMC(device=dev, device_ec=True, lanes=lanes,
                   bytes_per_symbol=bps, cap_frac=cap_frac, dtype=dtype)

    p_net = p_codec()
    p_net.init_params(seed=1)
    # moderate symbol magnitudes for the entropy-coding load
    q_scale = float(os.environ.get("BENCH_Q_SCALE", 0.25))
    p_net.params["q_encoder"] = torch.ones_like(
        p_net.params["q_encoder"]) * q_scale
    p_net.params["q_decoder"] = torch.ones_like(p_net.params["q_decoder"])
    p_net.update(force_zero_thres=fz)

    pr, pb = C.get_padding_size(height, width, 16)
    use_two = height * width > 1280 * 720
    if ckpt_i:
        # a trained model prices uniform noise at ~8 bpp: code content
        from .eval.rd_evidence import synthetic_images
        base = synthetic_images(1, height, seed=0, width=width)[0]
    else:
        base = np.random.default_rng(0).random((1, height, width, 3),
                                               dtype=np.float32)

    def frame(t):
        x = torch.from_numpy(np.roll(base, 4 * t, axis=2)).to(dtype).to(dev)
        return replicate_pad(x.permute(0, 3, 1, 2), pb, pr) \
            .permute(0, 2, 3, 1).contiguous()

    # I-frame to seed the DPB; frames 1-2 run the single-frame path
    # (pixel-adaptor then feature-adaptor) before the GOP chunks
    x0 = frame(0)
    enc0 = i_net.compress(x0, qp)
    coded["I"] += 1
    seed_frames = [frame(1), frame(2)]
    frames = [frame(t) for t in range(3, 3 + n_frames)]
    _sync(dev)
    chunks = [frames[i * gop_n:(i + 1) * gop_n] for i in range(n_chunks)]
    qps = [qp] * gop_n

    def seed_encoder():
        p_net.clear_dpb()
        p_net.set_curr_poc(0)
        p_net.add_ref_frame(None, enc0["x_hat"])
        coded["P"] += len(seed_frames)
        return [p_net.compress(f, qp)["bit_stream"] for f in seed_frames]

    # warm-up: both single-frame adaptor variants and a GOP chunk
    seed_encoder()
    p_net.compress_gop(chunks[0], qps)
    coded["P"] += gop_n

    # pipelined chunk encode: chunk k + 1 is queued while a pool thread
    # waits for chunk k's copy and serializes its streams
    seed_streams = seed_encoder()
    _sync(dev)
    pool = ThreadPoolExecutor(max_workers=2)
    t0 = time.perf_counter()
    marks = _Marks(dev)
    handles = []
    for c in chunks:
        handles.append(pool.submit(p_net.compress_gop_async(c, qps)))
        marks.mark()
    chunk_streams = [h.result() for h in handles]
    enc_elapsed = time.perf_counter() - t0
    pool.shutdown()
    _sync(dev)
    coded["P"] += n_frames

    enc_fps = n_frames / enc_elapsed
    total_bits = sum(len(s) * 8 for streams in chunk_streams
                     for s in streams)
    bpp = total_bits / (n_frames * height * width)
    enc_feature = p_net.dpb[0].feature
    state = {"device": dev, "qp": qp, "qps": qps, "fz": fz, "gop_n": gop_n,
             "n_frames": n_frames, "size": (height, width),
             "i_net": i_net, "p_net": p_net, "enc0": enc0,
             "seed_frames": seed_frames, "chunks": chunks,
             "seed_streams": seed_streams, "chunk_streams": chunk_streams,
             "enc_chunk_ms": marks.intervals_ms(),
             "coded": coded, "decoded": decoded}

    dec_fps = None
    if _env_on("BENCH_DECODE"):
        d_net = p_codec()
        d_net.load_params(p_net.params)
        d_net.update(force_zero_thres=fz)
        sps = {"sps_id": 0, "height": height, "width": width,
               "ec_part": 1 if use_two else 0, "use_ada_i": 0}

        def seed_decoder():
            d_net.clear_dpb()
            d_net.set_curr_poc(0)
            d_net.add_ref_frame(None, enc0["x_hat"])
            for s in seed_streams:
                d_net.decompress(s, sps, qp)
            decoded["P"] += len(seed_streams)
            _sync(dev)

        # warm both single-frame variants and a GOP chunk, synchronized
        seed_decoder()
        d_net.decompress_gop(chunk_streams[0], sps, qps)
        decoded["P"] += gop_n
        _sync(dev)

        seed_decoder()
        t0 = time.perf_counter()
        marks = _Marks(dev)
        # pipelined: chunk k + 1 is parsed and its upload queued before
        # chunk k's decode
        out = None
        up = d_net.upload_gop(chunk_streams[0], sps)
        for i in range(n_chunks):
            nxt = d_net.upload_gop(chunk_streams[i + 1], sps) \
                if i + 1 < n_chunks else None
            if up is not None:
                out = d_net.decompress_gop_uploaded(up, sps, qps)
            else:  # mixed ladder rungs: per-frame fallback
                out = d_net.decompress_gop(chunk_streams[i], sps, qps)
            marks.mark()
            up = nxt
        # decoded frames stay on the device; wait for the last
        _sync(dev)
        dec_elapsed = time.perf_counter() - t0
        dec_fps = n_frames / dec_elapsed
        decoded["P"] += n_frames

        # the bit-exact temporal-chain contract
        if not torch.equal(enc_feature, d_net.dpb[0].feature):
            raise RuntimeError("enc/dec feature chain diverged")
        state.update(d_net=d_net, sps=sps, dec_out=out,
                     dec_chunk_ms=marks.intervals_ms())

    intra_enc_fps = intra_dec_fps = None
    if _env_on("BENCH_INTRA"):
        n_intra = int(os.environ.get("BENCH_INTRA_FRAMES", 8))
        i_frames = [frame(t) for t in range(n_intra)]
        _sync(dev)
        i_streams = i_net.compress_batch(i_frames, qp)["bit_streams"]
        coded["I"] += n_intra
        if reruns():
            # the codec has learned the settled rung: warm once more at it
            i_streams = i_net.compress_batch(i_frames, qp)["bit_streams"]
            coded["I"] += n_intra
        enc_times = []
        for _ in range(2):
            _sync(dev)
            t0 = time.perf_counter()
            i_x_hats, fin = i_net.compress_batch_async(i_frames, qp)
            i_streams = fin()
            enc_times.append(time.perf_counter() - t0)
            coded["I"] += n_intra
        intra_enc_fps = n_intra / min(enc_times)

        i_dec = DMCI(device=dev, device_ec=True, lanes=lanes,
                     bytes_per_symbol=bps, dtype=dtype)
        i_dec.load_params(i_net.params)
        i_dec.update(force_zero_thres=fz)
        i_sps = {"sps_id": 0, "height": height, "width": width,
                 "ec_part": 1 if use_two else 0, "use_ada_i": 0}
        # warm, synchronized so no warm-up work bleeds into the timing
        i_dec.decompress_batch(i_streams, i_sps, qp)
        _sync(dev)
        dec_times = []
        for _ in range(2):
            t0 = time.perf_counter()
            outs = i_dec.decompress_batch(i_streams, i_sps, qp)["x_hat"]
            _sync(dev)
            dec_times.append(time.perf_counter() - t0)
        decoded["I"] += 3 * n_intra
        intra_dec_fps = n_intra / min(dec_times)
        state.update(i_dec=i_dec, i_sps=i_sps, i_frames=i_frames,
                     i_streams=i_streams, i_x_hats=i_x_hats, i_dec_out=outs,
                     intra_enc_ms=[t * 1e3 for t in enc_times],
                     intra_dec_ms=[t * 1e3 for t in dec_times])

    if dec_fps is None:
        value = enc_fps
        vs = enc_fps / BASELINE_ENC_FPS
    else:
        value = min(enc_fps, dec_fps)
        vs = min(enc_fps / BASELINE_ENC_FPS, dec_fps / BASELINE_DEC_FPS)
    result = {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": "fps",
        "vs_baseline": round(vs, 4),
        "enc_fps": round(enc_fps, 2),
        "dec_fps": None if dec_fps is None else round(dec_fps, 2),
        "bpp": round(bpp, 4),
        "gop_n": gop_n,
        "intra_enc_fps": None if intra_enc_fps is None
        else round(intra_enc_fps, 2),
        "intra_dec_fps": None if intra_dec_fps is None
        else round(intra_dec_fps, 2),
    }
    n_reruns = reruns()
    if n_reruns:
        result["ec_reruns"] = n_reruns
    state.update(result=result, reruns=n_reruns,
                 verbose=(f"# platform={dev.type} dtype={dtype_name} "
                          f"frames={n_frames} gop={gop_n} {height}x{width} "
                          f"enc={1e3 / enc_fps:.2f}ms dec="
                          + ("n/a" if dec_fps is None
                             else f"{1e3 / dec_fps:.2f}ms")
                          + f" bpp={bpp:.4f}"))
    return state


def main():
    state = run()
    print(json.dumps(state["result"]), flush=True)
    if os.environ.get("BENCH_VERBOSE"):
        print(state["verbose"], flush=True)


if __name__ == "__main__":
    main()
