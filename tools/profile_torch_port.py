#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's P-frame goes, on one GPU.

    python3 tools/profile_torch_port.py [--frames 2] [--dtype bfloat16]
        [--codec rt|fm|dc|hem|tcm] [--trace PATH]

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
chip_smoke.py's phases 16-17 do.  It warms up with one
frame, then profiles `--frames` encodes and their decodes with
torch.profiler.  Prints the card's name and power limit, the per-frame
host-clock times, the device time by kernel (top 15) and by class
(convolutions, the depthwise 3x3, the layout transposes around
convolutions, elementwise, gathers (FM's warps), host->device uploads,
device->host copies, lane rANS K1/K2, other), and the device busy and
idle shares of the window; writes the Chrome trace to --trace.  The profiler slows the
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
         "hem": (704, 1280), "tcm": (704, 1280)}
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


CODECS = {"rt": _rt_codec, "fm": _fm_codec, "dc": _dc_codec,
          "hem": _hem_codec, "tcm": _tcm_codec}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--codec", default="rt", choices=sorted(CODECS))
    ap.add_argument("--trace", default="chiprun_out/torch_port_trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_port: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    H, W = SIZES[args.codec]
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

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range \
                .elapsed_us()
    busy_us = sum(kernels.values())
    if busy_us == 0:
        sys.exit("profile_torch_port: the profiler recorded no device time")
    print(f"P-frame enc ms {[round(t, 2) for t in enc_ms]} dec ms "
          f"{[round(t, 2) for t in dec_ms]} (host clock, synchronized)")
    print(f"window {window_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms = {100 * busy_us / window_us:.1f} %, "
          f"idle {100 - 100 * busy_us / window_us:.1f} %")
    pair_busy = busy_us / 1e3 / len(enc_ms)
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
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    print(f"trace: {args.trace}")


if __name__ == "__main__":
    main()
