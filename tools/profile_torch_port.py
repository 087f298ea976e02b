#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's P-frame goes, on one GPU.

    python3 tools/profile_torch_port.py [--frames 2] [--dtype bfloat16]
        [--codec rt|fm|dc|hem|tcm|evc|dcvc] [--size HxW] [--trace PATH]

Every codec runs in --dtype (float32 or bfloat16).  --codec rt (the
default) codes 1080p P-frames with DMC at full width on the device-EC
path (random weights from seed 1, flat q banks, force_zero_thres 0.12,
as chip_smoke.py's phase 4 does); --codec fm codes them with DCVC-FM's
DMCFM (random weights from seed 1, host EC, qp 21, fa_idx 0 on the
propagated DPB, as chip_smoke.py's phase 11 and 14); --codec dc codes
704x1280 P-frames with DCVC-DC's DMCDC (random weights from seed 0, host
EC, q_index 30 on the fine ladder, frame_idx t from a raw reference, as
tools/family_bench.py and chip_smoke.py's phase 15); --codec hem and tcm
code 704x1280 P-frames with DCVC-HEM's DMCHEM (seed 0, the anchors spread
to family_bench's, its rung get_interpolated_q_scales(4)[1]) and DCVC-TCM's
DMCTCM (seed 0), host EC, from a raw reference, as family_bench and
chip_smoke.py's phases 16-17 do; --codec evc codes 704x1280 images with
EVC_LL (seed 0, q_scale 1.0) and --codec dcvc 256x256 P-frames with
DCVCNet (seed 0), each against the raw frame 0, host EC, as family_bench
and chip_smoke.py's phases 18-19 do; for dcvc the host time of the
autoregressive loop (`_ARCoder`) within each encode and decode is printed
beside the frame times.  --size HxW replaces the codec's frame size
(multiples of 64).  It warms up with one
frame, then profiles `--frames` encodes and their decodes with
torch.profiler.  Prints the card's name and power limit, the per-frame
host-clock times, the device kernels launched a pair, the device time
by kernel (top 15) and by class
(convolutions, the depthwise 3x3, the layout transposes around
convolutions, elementwise, gathers (FM's warps), host->device uploads,
device->host copies, lane rANS K1/K2, other), the device time a frame of
each entry point by the port's innermost `nn.*` / `wait.*` span around
the launch (the port's trace, opendcvc_tpu_torch/utils/trace.py: each
device operation goes to the host range that launched it by kineto's
correlation ids), and the device busy and idle shares of the window;
writes the Chrome trace to --trace.  The profiler slows the
host's launches, so the window's idle share overstates the idle of an
unprofiled frame: the same number of frames is first timed without the
profiler, and the device time an enc + dec pair took under it is also
printed as a share of an unprofiled pair's host-clock time.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

QP, FZ = 21, 0.12
#: each codec's frame size: 1080p padded to 16, or family_bench's
SIZES = {"rt": (1088, 1920), "fm": (1088, 1920), "dc": (704, 1280),
         "hem": (704, 1280), "tcm": (704, 1280), "evc": (704, 1280),
         "dcvc": (256, 256)}
DC_Q = 30


def _kernel_class(name):
    n = name.lower()
    if n.startswith("lr_") or "lr_encode" in n or "lr_decode" in n:
        return "lane rANS (K1/K2)"
    if "memcpy htod" in n:
        return "upload (host->device copies)"
    if "memcpy dtoh" in n:
        return "fetch (device->host copies)"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout transposes around convolutions"
    if "conv_depthwise" in n:
        return "depthwise 3x3 convolution (ATen)"
    # nvjet: cuBLASLt's GEMMs, which run the bfloat16 1x1 convolutions
    if any(s in n for s in ("conv", "gemm", "cudnn", "xmma", "cutlass",
                            "winograd", "implicit", "nvjet")):
        return "convolution (cuDNN, cuBLASLt)"
    if "gather" in n:
        return "gather (flow warps)"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other (copies, cat, scatter, reductions, ...)"


#: the port's span names (opendcvc_tpu_torch/utils/trace.py)
PORT_SPANS = ("nn.", "wait.", "coder.", "upload", "dmc.", "dmci.",
              "dmc_fm.", "dmci_fm.", "intra_no_ar.", "dmc_hem.")


def _ns(ev, what):
    fn = getattr(ev, f"{what}_ns", None)
    return fn() if fn is not None else getattr(ev, f"{what}_us")() * 1000


def _open_spans(spans, t):
    """The port spans of `spans` ((start, end, name), sorted by start) that
    cover time t, outermost first."""
    return [n for s, e, n in spans if s <= t <= e]


def port_span_table(prof):
    """{entry point: {innermost nn.* / wait.* span: device ns}} of a
    profile: each device operation goes to the host event that launched it
    (its linked correlation id), and from there to the port spans open on
    that thread at that time; the outermost names the entry point, the
    innermost nn.* or wait.* one (else the innermost port span) the row."""
    spans, launched = {}, {}
    device = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append(ev)
            continue
        start = _ns(ev, "start")
        if ev.is_user_annotation() and ev.name().startswith(PORT_SPANS):
            spans.setdefault(ev.start_thread_id(), []).append(
                (start, start + _ns(ev, "duration"), ev.name()))
        if ev.correlation_id() and not ev.name().startswith("cuda"):
            launched.setdefault(ev.correlation_id(),
                                (ev.start_thread_id(), start))
    for v in spans.values():
        v.sort()
    table = {}
    for ev in device:
        host = launched.get(ev.linked_correlation_id())
        open_ = _open_spans(spans.get(host[0], []), host[1]) if host else []
        entry = open_[0] if open_ else "(no port span)"
        inner = [n for n in open_ if n.startswith(("nn.", "wait."))]
        row = inner[-1] if inner else open_[-1] if open_ else \
            "(no port span)"
        by = table.setdefault(entry, {})
        by[row] = by.get(row, 0) + _ns(ev, "duration")
    return table


def _rt_codec(dev, dtype, frames, H, W):
    """DMC encoder and decoder on device EC, each seeded from frames[0];
    returns (encode(x) -> stream, decode(stream), feature chain equal)."""
    from opendcvc_tpu_torch.models.dmc import DMC
    nets = []
    for _ in range(2):
        net = DMC(device=dev, device_ec=True, dtype=dtype)
        if nets:
            net.load_params(nets[0].params)
        else:
            net.init_params(seed=1)
            net.params["q_encoder"] = torch.ones_like(
                net.params["q_encoder"]) * 0.25
            net.params["q_decoder"] = torch.ones_like(
                net.params["q_decoder"])
        net.update(force_zero_thres=FZ)
        nets.append(net)
    enc, dec = nets
    for net in nets:
        net.add_ref_frame(None, frames[0])
    sps = {"height": H, "width": W}
    return (lambda x: enc.compress(x, QP)["bit_stream"],
            lambda s: dec.decompress(s, sps, QP),
            lambda: torch.equal(enc.dpb[0].feature, dec.dpb[0].feature))


def _fresh(frame, dev):
    return {"ref_frame": torch.from_numpy(frame).to(dev),
            "ref_feature": None, "ref_mv_feature": None, "ref_y": None,
            "ref_mv_y": None}


def _fm_codec(dev, dtype, frames, H, W):
    """DMCFM encoder and decoder on host EC, their DPBs seeded from
    frames[0]; the same three callables as _rt_codec."""
    from opendcvc_tpu_torch.models.dmc_fm import DMCFM
    enc, dec = DMCFM(device=dev, dtype=dtype), DMCFM(device=dev, dtype=dtype)
    enc.init_params(seed=1)
    dec.load_params(enc.params)
    for net in (enc, dec):
        net.update()
    dpb = {"enc": _fresh(frames[0], dev), "dec": _fresh(frames[0], dev)}
    sps = {"height": H, "width": W, "qp": QP, "fa_idx": 0}

    def encode(x):
        out = enc.compress(x, dpb["enc"], QP, 0)
        dpb["enc"] = out["dpb"]
        return out["bit_stream"]

    def decode(s):
        dpb["dec"] = dec.decompress(s, dpb["dec"], sps)["dpb"]

    return encode, decode, lambda: all(
        torch.equal(dpb["enc"][k], dpb["dec"][k]) for k in dpb["enc"])


def _dc_codec(dev, dtype, frames, H, W):
    """DMCDC encoder and decoder on host EC from the raw reference
    frames[0], frame_idx counting up from 1; the same three callables as
    _rt_codec."""
    from opendcvc_tpu_torch.models.dmc_dc import DMCDC
    enc, dec = DMCDC(device=dev, dtype=dtype), DMCDC(device=dev, dtype=dtype)
    enc.init_params(seed=0)
    dec.load_params(enc.params)
    for net in (enc, dec):
        net.update()
    dpb = {"enc": _fresh(frames[0], dev), "dec": _fresh(frames[0], dev)}
    t = {"enc": 0, "dec": 0}

    def encode(x):
        t["enc"] += 1
        out = enc.compress(x, dpb["enc"], False, DC_Q, frame_idx=t["enc"])
        dpb["enc"] = out["dpb"]
        return out["bit_stream"]

    def decode(s):
        t["dec"] += 1
        dpb["dec"] = dec.decompress(s, dpb["dec"], H, W, False, DC_Q,
                                    frame_idx=t["dec"])["dpb"]

    return encode, decode, lambda: all(
        torch.equal(dpb["enc"][k], dpb["dec"][k]) for k in dpb["enc"])


def _hem_codec(dev, dtype, frames, H, W):
    """DMCHEM encoder and decoder on host EC from the raw reference
    frames[0], at family_bench's rung; the same three callables as
    _rt_codec."""
    from opendcvc_tpu_torch.family_bench import HEM_ANCHORS
    from opendcvc_tpu_torch.models.dmc_hem import DMCHEM
    enc, dec = DMCHEM(device=dev, dtype=dtype), DMCHEM(device=dev,
                                                        dtype=dtype)
    enc.init_params(seed=0)
    for name in ("y_q_scale", "mv_y_q_scale"):
        enc.params[name] = torch.tensor(HEM_ANCHORS, device=dev)
    dec.load_params(enc.params)
    for net in (enc, dec):
        net.update()
    y_l, mv_l = enc.get_interpolated_q_scales(4)
    yq, mvq = float(y_l[1]), float(mv_l[1])
    dpb = {k: {"ref_frame": torch.from_numpy(frames[0]).to(dev),
               "ref_feature": None, "ref_y": None, "ref_mv_y": None}
           for k in ("enc", "dec")}

    def encode(x):
        out = enc.compress(x, dpb["enc"], mvq, yq)
        dpb["enc"] = out["dpb"]
        return out["bit_stream"]

    def decode(s):
        dpb["dec"] = dec.decompress(dpb["dec"], s, H, W, mvq, yq)["dpb"]

    return encode, decode, lambda: all(
        torch.equal(dpb["enc"][k], dpb["dec"][k]) for k in dpb["enc"])


def _tcm_codec(dev, dtype, frames, H, W):
    """DMCTCM encoder and decoder on host EC from the raw reference
    frames[0]; the same three callables as _rt_codec."""
    from opendcvc_tpu_torch.models.dmc_tcm import DMCTCM
    enc, dec = DMCTCM(device=dev, dtype=dtype), DMCTCM(device=dev,
                                                        dtype=dtype)
    enc.init_params(seed=0)
    dec.load_params(enc.params)
    for net in (enc, dec):
        net.update()
    ref = torch.from_numpy(frames[0]).to(dev)
    refs = {"enc": (ref, None), "dec": (ref, None)}

    def encode(x):
        out = enc.compress(x, *refs["enc"])
        refs["enc"] = (out["x_hat"], out["feature"])
        return out["bit_stream"]

    def decode(s):
        out = dec.decompress(*refs["dec"], s, H, W)
        refs["dec"] = (out["x_hat"], out["feature"])

    return encode, decode, lambda: all(
        torch.equal(a, b) for a, b in zip(refs["enc"], refs["dec"]))


def _evc_codec(dev, dtype, frames, H, W):
    """EVC_LL encoder and decoder on host EC at q_scale 1.0, each frame an
    image; the same three callables as _rt_codec (the chain: the last
    decoded x_hat equals its encoder's)."""
    from opendcvc_tpu_torch.models.evc import EVC_LL
    enc, dec = EVC_LL(device=dev, dtype=dtype), EVC_LL(device=dev,
                                                        dtype=dtype)
    enc.init_params(seed=0)
    dec.load_params(enc.params)
    for net in (enc, dec):
        net.update()
    last = {}

    def encode(x):
        out = enc.compress(x, 1.0)
        last["enc"] = out["x_hat"]
        return out["bit_stream"]

    def decode(s):
        last["dec"] = dec.decompress(s, H, W, 1.0)["x_hat"]

    return encode, decode, lambda: torch.equal(last["enc"], last["dec"])


def _dcvc_codec(dev, dtype, frames, H, W):
    """DCVCNet encoder and decoder on host EC, each frame against the raw
    frames[0]; the same three callables as _rt_codec, and `encode.report`
    gives each encode's and decode's host ms in the AR loop."""
    from opendcvc_tpu_torch.models.dcvc import DCVCNet
    enc, dec = DCVCNet(device=dev, dtype=dtype), DCVCNet(device=dev,
                                                          dtype=dtype)
    enc.init_params(seed=0)
    dec.load_params(enc.params)
    ar_ms = {"enc": [], "dec": []}
    for side, net in (("enc", enc), ("dec", dec)):
        net.update()
        for ar in (net._ar, net._ar_mv):
            for name in ("encode", "decode"):
                def timed(*args, _fn=getattr(ar, name), _side=side):
                    t0 = time.perf_counter()
                    try:
                        return _fn(*args)
                    finally:
                        ar_ms[_side].append((time.perf_counter() - t0)
                                            * 1e3)
                setattr(ar, name, timed)
    ref = torch.from_numpy(frames[0]).to(dev)
    last = {}

    def encode(x):
        out = enc.compress(ref, x)
        last["enc"] = out["recon_image"]
        return out

    def decode(o):
        last["dec"] = dec.decompress(ref, o["mv_y_string"], o["mv_z_string"],
                                     o["y_string"], o["z_string"], H, W)

    def report():
        pairs = {k: [round(a + b, 2) for a, b in zip(v[::2], v[1::2])]
                 for k, v in ar_ms.items()}
        return (f"AR loop (host) ms a frame, mv_y + y: enc {pairs['enc']} "
                f"dec {pairs['dec']} (warm-up and unprofiled frames "
                f"included)")

    encode.report = report
    return encode, decode, lambda: torch.equal(last["enc"], last["dec"])


CODECS = {"rt": _rt_codec, "fm": _fm_codec, "dc": _dc_codec,
          "hem": _hem_codec, "tcm": _tcm_codec, "evc": _evc_codec,
          "dcvc": _dcvc_codec}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--codec", default="rt", choices=sorted(CODECS))
    ap.add_argument("--size", default=None,
                    help="HxW instead of the codec's frame size")
    ap.add_argument("--trace", default="chiprun_out/torch_port_trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_port: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    H, W = SIZES[args.codec] if args.size is None else \
        map(int, args.size.split("x"))
    print(f"{card}; codec {args.codec}, dtype {args.dtype}, {W}x{H}")
    rng = np.random.default_rng(0)
    base = rng.random((1, H, W, 3), dtype=np.float32)
    frames = [np.roll(base, 4 * t, axis=2) for t in range(args.frames + 2)]
    encode, decode, chain_equal = CODECS[args.codec](
        dev, getattr(torch, args.dtype), frames, H, W)
    decode(encode(frames[1]))
    torch.cuda.synchronize()

    plain_ms = []       # enc + dec pairs, no profiler
    for x in frames[2:]:
        t0 = time.perf_counter()
        decode(encode(x))
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    enc_ms, dec_ms = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for x in frames[2:]:
            t0 = time.perf_counter()
            s = encode(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            decode(s)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((t2 - t1) * 1e3)
        window_us = (time.perf_counter() - t_window) * 1e6
    if not chain_equal():
        sys.exit("profile_torch_port: the enc/dec chain diverged")

    kernels, launched = {}, 0
    for ev in prof.events():
        # a port span's copy on the device's timeline is no device work
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not ev.is_user_annotation:
            launched += 1
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range \
                .elapsed_us()
    busy_us = sum(kernels.values())
    if busy_us == 0:
        sys.exit("profile_torch_port: the profiler recorded no device time")
    print(f"frame enc ms {[round(t, 2) for t in enc_ms]} dec ms "
          f"{[round(t, 2) for t in dec_ms]} (host clock, synchronized)")
    if hasattr(encode, "report"):
        print(encode.report())
    print(f"window {window_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms = {100 * busy_us / window_us:.1f} %, "
          f"idle {100 - 100 * busy_us / window_us:.1f} %")
    pair_busy = busy_us / 1e3 / len(enc_ms)
    print(f"device kernels and copies a pair: {launched / len(enc_ms):.0f}")
    print(f"without the profiler an enc + dec pair took "
          f"{[round(t, 2) for t in plain_ms]} ms (host clock); the device's "
          f"{pair_busy:.2f} ms a pair is "
          f"{100 * pair_busy / np.mean(plain_ms):.1f} % of their mean")
    classes = {}
    for name, us in kernels.items():
        c = _kernel_class(name)
        classes[c] = classes.get(c, 0.0) + us
    for c, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  {100 * us / busy_us:5.1f} %  {us / 1e3:9.3f} ms  {c}")
    print("top kernels by device time:")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {100 * us / busy_us:5.1f} %  {us / 1e3:9.3f} ms  "
              f"{name[:100]}")
    n = len(enc_ms)
    print("device ms a frame by entry point and the port's innermost "
          "nn.* / wait.* span:")
    for entry, rows in sorted(port_span_table(prof).items()):
        total = sum(rows.values())
        print(f"  {entry}: {total / 1e6 / n:.3f} ms")
        for row, ns in sorted(rows.items(), key=lambda kv: -kv[1]):
            print(f"    {100 * ns / total:5.1f} %  {ns / 1e6 / n:9.3f} ms  "
                  f"{row}")
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    print(f"trace: {args.trace}")


if __name__ == "__main__":
    main()
