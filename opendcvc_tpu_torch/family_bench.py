"""Family-codec scorecard of the port: one measured enc/dec number per
family codec the port has.

    python -m opendcvc_tpu_torch.family_bench [out.json]      # on the card
    FAM_PLATFORM=cpu FAM_H=64 FAM_W=64 FAM_FRAMES=2 \\
        python -m opendcvc_tpu_torch.family_bench out.json      # on the CPU

A port of the JAX package's `tools/family_bench.py`: the same content
(`_frames`: a synthetic image rolled 3 px a frame plus mild noise, one
seed per codec), operating points, timed regions (a warm chain, then a
timed one; a chain's time ends when the device has finished it) and
rows.  Each codec's full compress AND decompress is timed: the NN stages
on the device, the host rANS coder and the container.  One row a codec,
printed as it finishes, then the whole result written to out.json:

    {"platform": "gpu" | "cpu", "host_ec": true, "note": ...,
     "codecs": {name: {"h", "w", "frames", "enc_fps", "dec_fps",
                       "enc_ms_pf", "dec_ms_pf", "bpp"}}}

Env, with the JAX tool's defaults: FAM_H / FAM_W (704 / 1280),
FAM_FRAMES (3), FAM_CODECS (comma list; default the codecs the port has,
in the JAX tool's order: "tcm,hem,dc").  A codec the port does not have yet raises
NotImplementedError with its ROADMAP item.  FAM_PLATFORM=cpu runs on
the CPU; otherwise the codecs run on "cuda" and raise without CUDA.

Differences from the JAX tool: the weights are the port's
torch.Generator init (seed 0), not the JAX package's, so bpp is the
port's own; each block_until_ready is torch.cuda.synchronize(); the
default output is family_bench_torch.json in the working directory (the
JAX tool writes docs/family_bench_r5.json).
"""

import json
import os
import sys
import time

import numpy as np
import torch

from .eval.rd_evidence import synthetic_images
from .models.dmc_dc import DMCDC
from .models.dmc_hem import DMCHEM
from .models.dmc_tcm import DMCTCM

#: the JAX tool's codecs the port does not have yet, by ROADMAP Queue 1
#: item
UNPORTED = {"evc": "8g", "dcvc": "8f"}
#: HEM's anchors, spread so that the continuous ladder's rung is a real
#: operating point between them (the init's anchors are flat)
HEM_ANCHORS = [2.0, 1.2, 0.8, 0.5]
DEFAULT_OUT = "family_bench_torch.json"
NOTE = ("untrained init weights (the port's own); wall times incl. NN + "
        "host rANS + container; RT codecs (DMC/DMCI) are covered by "
        "opendcvc_tpu_torch.bench device-EC chunks")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _frames(h, w, n, device, seed=0):
    """n + 1 float32 frames (1, H, W, 3) on `device`: a synthetic image,
    then that image rolled 3t px along the width plus N(0, 0.01) noise,
    clipped to [0, 1] (the JAX tool's `_frames`)."""
    rng = np.random.default_rng(seed)
    base = synthetic_images(1, h, seed=seed, width=w)[0]
    out = [base.astype(np.float32)]
    for t in range(1, n + 1):
        nxt = np.clip(np.roll(base, 3 * t, axis=2)
                      + rng.normal(0, 0.01, base.shape), 0, 1)
        out.append(nxt.astype(np.float32))
    frames = [torch.from_numpy(f).to(device) for f in out]
    _sync(device)
    return frames


def _fresh_dpb(frame):
    return {"ref_frame": frame, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


def _time(fn):
    """(seconds of one call of fn after a warm call, its result)."""
    fn()
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def bench_tcm(h, w, n, device):
    """DCVC-TCM: n P-frames after the raw reference frame 0, the x_hat and
    feature propagated; host EC.  Returns (encode seconds, decode seconds,
    bpp) of the timed chains."""
    xs = _frames(h, w, n, device, seed=1)
    net = DMCTCM(device=device)
    net.init_params(seed=0)
    net.update()

    def enc_chain():
        ref, feat, streams = xs[0], None, []
        for t in range(1, n + 1):
            out = net.compress(xs[t], ref, feat)
            ref, feat = out["x_hat"], out["feature"]
            streams.append(out["bit_stream"])
        _sync(device)
        return streams

    t_enc, streams = _time(enc_chain)
    dec = DMCTCM(device=device)
    dec.load_params(net.params)
    dec.update()

    def dec_chain():
        ref, feat = xs[0], None
        for s in streams:
            out = dec.decompress(ref, feat, s, h, w)
            ref, feat = out["x_hat"], out["feature"]
        _sync(device)

    t_dec, _ = _time(dec_chain)
    return t_enc, t_dec, sum(len(s) * 8 for s in streams) / (n * h * w)


def bench_hem(h, w, n, device):
    """DCVC-HEM: n P-frames after the raw reference frame 0, the anchors
    spread to HEM_ANCHORS and the rung get_interpolated_q_scales(4)[1];
    host EC.  Returns (encode seconds, decode seconds, bpp)."""
    xs = _frames(h, w, n, device, seed=2)
    net = DMCHEM(device=device)
    net.init_params(seed=0)
    for name in ("y_q_scale", "mv_y_q_scale"):
        net.params[name] = torch.tensor(HEM_ANCHORS, device=device)
    net.update()
    y_l, mv_l = net.get_interpolated_q_scales(4)
    yq, mvq = float(y_l[1]), float(mv_l[1])

    def fresh():
        return {"ref_frame": xs[0], "ref_feature": None, "ref_y": None,
                "ref_mv_y": None}

    def enc_chain():
        dpb, streams = fresh(), []
        for t in range(1, n + 1):
            out = net.compress(xs[t], dpb, mv_y_q_scale=mvq, y_q_scale=yq)
            dpb = out["dpb"]
            streams.append(out["bit_stream"])
        _sync(device)
        return streams

    t_enc, streams = _time(enc_chain)
    dec = DMCHEM(device=device)
    dec.load_params(net.params)
    dec.update()

    def dec_chain():
        dpb = fresh()
        for s in streams:
            dpb = dec.decompress(dpb, s, h, w, mvq, yq)["dpb"]
        _sync(device)

    t_dec, _ = _time(dec_chain)
    return t_enc, t_dec, sum(len(s) * 8 for s in streams) / (n * h * w)


def bench_dc(h, w, n, device):
    """DCVC-DC: n P-frames after the raw reference frame 0, q_index 30 on
    the fine ladder (q_in_ckpt False), frame_idx t; host EC.  Returns
    (encode seconds, decode seconds, bpp) of the timed chains."""
    xs = _frames(h, w, n, device, seed=3)
    net = DMCDC(device=device)
    net.init_params(seed=0)
    net.update()

    def enc_chain():
        dpb, streams = _fresh_dpb(xs[0]), []
        for t in range(1, n + 1):
            out = net.compress(xs[t], dpb, q_in_ckpt=False, q_index=30,
                               frame_idx=t)
            dpb = out["dpb"]
            streams.append(out["bit_stream"])
        _sync(device)
        return streams

    t_enc, streams = _time(enc_chain)
    dec = DMCDC(device=device)
    dec.load_params(net.params)
    dec.update()

    def dec_chain():
        dpb = _fresh_dpb(xs[0])
        for t, s in enumerate(streams, 1):
            dpb = dec.decompress(s, dpb, h, w, q_in_ckpt=False, q_index=30,
                                 frame_idx=t)["dpb"]
        _sync(device)

    t_dec, _ = _time(dec_chain)
    return t_enc, t_dec, sum(len(s) * 8 for s in streams) / (n * h * w)


BENCHES = {"tcm": bench_tcm, "hem": bench_hem, "dc": bench_dc}


def main(argv=None):
    """Run the rows FAM_CODECS names; returns the result written to the
    output file (argv[0], else DEFAULT_OUT)."""
    argv = sys.argv[1:] if argv is None else argv
    h = int(os.environ.get("FAM_H", 704))
    w = int(os.environ.get("FAM_W", 1280))
    n = int(os.environ.get("FAM_FRAMES", 3))
    codecs = os.environ.get("FAM_CODECS", ",".join(BENCHES)).split(",")
    for name in codecs:
        if name in UNPORTED:
            raise NotImplementedError(
                f"family_bench: {name} is not ported yet (ROADMAP Queue 1, "
                f"item {UNPORTED[name]})")
        if name not in BENCHES:
            raise ValueError(f"family_bench: unknown codec {name!r}")
    out_path = argv[0] if argv else DEFAULT_OUT
    platform = os.environ.get("FAM_PLATFORM") or "cuda"
    device = torch.device("cpu" if platform == "cpu" else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; set FAM_PLATFORM=cpu to "
                           "run on the CPU")
    rows = {}
    for name in codecs:
        t_enc, t_dec, bpp = BENCHES[name](h, w, n, device)
        rows[name] = {
            "h": h, "w": w, "frames": n,
            "enc_fps": round(n / t_enc, 3),
            "dec_fps": round(n / t_dec, 3),
            "enc_ms_pf": round(1e3 * t_enc / n, 1),
            "dec_ms_pf": round(1e3 * t_dec / n, 1),
            "bpp": round(bpp, 4),
        }
        print(name, json.dumps(rows[name]), flush=True)
    result = {"platform": "gpu" if device.type == "cuda" else "cpu",
              "host_ec": True, "note": NOTE, "codecs": rows}
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", out_path)
    return result


if __name__ == "__main__":
    main()
