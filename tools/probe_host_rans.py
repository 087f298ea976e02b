#!/usr/bin/env python3
"""The host rANS coder alone, on a real 1080p frame's symbols.

    python3 tools/probe_host_rans.py [--reps 5] [--device cuda]
                                     [--size 1080 1920]

Encodes one DCVC-RT I-frame (DMCI, seed 0) and one P-frame (DMC, seed 1)
at 1080p (padded to 1088x1920; --size for another) full width, flat q
banks, force_zero_thres 0.12, qp 21, the weights and frames of
chip_smoke.py's phase 6, takes the host-EC symbol
buffers the codecs fetch, and times the host coder on them alone (host
clock, median of --reps): the encode, and the decode with and without
the decoder's 2^16-entry lookup table a CDF row (the JAX package builds
it for the y rows), each with one and two coders, threaded and not.
Every decode is checked against the symbols.  Prints the coded symbols
of each frame and ms and ns a symbol for each mode.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

QP, FZ = 21, 0.12


def frame_symbols(device, height, width):
    """{"I": ..., "P": ...}: each (z, y planes kept, y indexes kept,
    z rows per qp, cdf tables) as the host coder receives them."""
    from chip_smoke import synthetic_frames
    from opendcvc_tpu_torch.models import common as C
    from opendcvc_tpu_torch.models import dmc as D
    from opendcvc_tpu_torch.models import dmci as DI

    frames = synthetic_frames(height, width, 2)
    i_net = DI.DMCI(device=device)
    i_net.init_params(seed=0)
    i_net.params["q_scale_enc"] = torch.ones_like(
        i_net.params["q_scale_enc"]) * 0.2
    i_net.params["q_scale_dec"] = torch.ones_like(
        i_net.params["q_scale_dec"])
    p_net = D.DMC(device=device)
    p_net.init_params(seed=1)
    p_net.params["q_encoder"] = torch.ones_like(
        p_net.params["q_encoder"]) * 0.25
    p_net.params["q_decoder"] = torch.ones_like(p_net.params["q_decoder"])
    out = {}
    for name, net in (("I", i_net), ("P", p_net)):
        net.update(force_zero_thres=FZ)
        x = C.frame_to_nchw(frames[0 if name == "I" else 1], net.device)
        if name == "I":
            x_hat, z, planes = DI._encode_stages_i(net.params, x, QP, FZ)
        else:
            feature = D._stage_adaptor_i(net.params, x_hat)
            _, z, planes = D._encode_stages(net.params, x, feature, QP, FZ)
        buf = C.fetch_async(D._pack_host(z, planes, FZ))()
        (z_np,), ys, keeps = C.unpack_host(
            buf, [z.numel()], [planes[0][0].numel()] * len(planes),
            FZ is not None)
        ys = [y[k] for y, k in zip(ys, keeps)]
        out[name] = (z_np, ys, [(y & 0xFF).astype(np.uint8) for y in ys],
                     net.bit_estimator_z.channel,
                     (net.gaussian_encoder.cdf_info,
                      net.bit_estimator_z.cdf_info))
    return out


def _coder(tables, threaded, two, lut):
    from opendcvc_tpu_torch.entropy.coder import EntropyCoder
    ec = EntropyCoder(threaded=threaded)
    ec.add_cdf(*tables[0], build_lut=lut)
    ec.add_cdf(*tables[1])
    ec.set_use_two_entropy_coders(two)
    return ec


def time_modes(sym, reps):
    z, ys, idxs, c, tables = sym
    n = z.size + sum(y.size for y in ys)
    rows = []
    for threaded in (False, True):
        for two in (False, True):
            ec = _coder(tables, threaded, two, False)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                ec.reset()
                ec.encode_z(z, 1, QP * c, c)
                for y in ys:
                    ec.encode_y(y, 0)
                ec.flush()
                stream = ec.get_encoded_stream()
                times.append(time.perf_counter() - t0)
            rows.append(("encode", threaded, two, None, times))
            for lut in (True, False):
                dec = _coder(tables, threaded, two, lut)
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    dec.set_stream(stream)
                    dec.decode_z(z.size, 1, QP * c, c)
                    got = [dec.get_decoded_tensor()]
                    for idx in idxs:
                        dec.decode_y(idx, 0)
                        got.append(dec.get_decoded_tensor())
                    times.append(time.perf_counter() - t0)
                want = [z] + [(y >> 8).astype(np.int8) for y in ys]
                if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                    sys.exit("probe_host_rans: a decode differs")
                rows.append(("decode", threaded, two, lut, times))
    return n, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, nargs=2, default=(1080, 1920),
                    metavar=("HEIGHT", "WIDTH"))
    args = ap.parse_args()
    print(f"host: {os.cpu_count()} cores visible")
    for name, sym in frame_symbols(torch.device(args.device),
                                   *args.size).items():
        n, rows = time_modes(sym, args.reps)
        print(f"{name}-frame: {sym[0].size} z + "
              f"{sum(y.size for y in sym[1])} kept y symbols")
        for what, threaded, two, lut, times in rows:
            ms = float(np.median(times)) * 1e3
            mode = (f"{'threaded' if threaded else 'inline':8s} "
                    f"{'two coders' if two else 'one coder ':10s} "
                    + ("" if lut is None else
                       "lookup table" if lut else "row scan    "))
            print(f"  {what} {mode:34s} {ms:8.2f} ms  "
                  f"{ms * 1e6 / n:6.1f} ns a symbol")


if __name__ == "__main__":
    main()
