"""RD and rate-consistency evidence for trained checkpoints, and the
trainers that make them.

    python -m opendcvc_tpu_torch.eval.rd_evidence --ckpt CKPT --out OUT.json \
        [--model dmci|dmc] [--train_tiny] [--device cpu]

Counterpart of the JAX package's `eval/rd_evidence.py`: a QP sweep that
writes real streams, the training forward's analytic bit estimate beside
each stream's size, and PSNR, which checks the probability model -> CDF
-> coder chain with trained weights (`measure` for DMCI, `measure_dmc`
for DMC P-frames, which also decodes every stream with a second DMC);
`train_tiny` / `train_tiny_dmc` (re)train such checkpoints on the
synthetic content here (`docs/dmci_tiny_rd.msgpack` is a DMCI trained at
TINY_KW).  The codecs code on the host (host EC) unless
OPENDCVC_TPU_DEVICE_EC is set, the JAX package's rule; then K1 encodes
and K2 decodes.  Everything runs on `device` (default cuda; without CUDA
that raises unless device="cpu").  `synthetic_images` also feeds
`python -m opendcvc_tpu_torch.bench` under BENCH_CKPT_I.
"""

import argparse
import json

import numpy as np
import torch

from ..models import common as CM
from ..models.dmc import DMC, dmc_init
from ..models.dmci import DMCI, dmci_init
from ..training.forward import dmc_forward_one_frame, dmci_forward
from ..training.train import (make_dmc_loss, make_dmci_loss,
                              make_optimizer, make_train_step,
                              trainable_leaves)
from ..utils import checkpoint as ckpt
from ..utils.common import env_flag
from ..utils.metrics import calc_psnr
from ..utils.params import from_jax, to_device
from ..utils.transfer import upload

#: the reduced DMCI widths of the trained RD-evidence checkpoint
TINY_KW = {"N": 96, "z_channel": 64, "enc_dec_ch": 64}


def synthetic_images(n, size, seed=0, width=None):
    """Deterministic mixed-content eval set: multi-scale block
    textures + smooth gradients + hard edges + mild noise — content a
    codec can actually model, with enough structure that rate responds
    to quantization (pure noise is incompressible; single-scale
    textures saturate).  `width` defaults to `size` (square).  Returns n
    (1, size, width, 3) float32 frames in [0, 1]."""
    rng = np.random.default_rng(seed)
    w = size if width is None else width
    imgs = []
    for _ in range(n):
        img = np.zeros((size, w, 3), np.float32)
        for block in (16, 8, 4):
            lo = rng.random((-(-size // block), -(-w // block), 3))
            img += np.kron(lo, np.ones((block, block, 1)))[
                :size, :w] / (16 / block) ** 0.5
        yy, xx = np.mgrid[0:size, 0:w].astype(np.float32)
        yy, xx = yy / size, xx / w
        img += (rng.random(3) * np.stack([yy, xx, yy * xx], -1)).sum(
            -1, keepdims=True) * 0.5
        # a few hard-edged rectangles
        for _ in range(4):
            y0 = rng.integers(0, size - 8)
            x0 = rng.integers(0, w - 8)
            h_ = rng.integers(4, size // 3)
            w_ = rng.integers(4, w // 3)
            img[y0:y0 + h_, x0:x0 + w_] += rng.random(3) - 0.5
        img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
        img = np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1)
        imgs.append(img[None].astype(np.float32))
    return imgs


def synthetic_pairs(n, size, seed=0):
    """Deterministic (ref, cur) frame pairs with global motion: cur is
    ref shifted by a few pixels plus mild noise, so a P-codec spends bits
    on the innovation and rate responds to QP as on natural video."""
    imgs = synthetic_images(n, size, seed)
    rng = np.random.default_rng(seed + 999)
    pairs = []
    for im in imgs:
        dy, dx = (int(v) for v in rng.integers(-4, 5, 2))
        cur = np.roll(im, (dy, dx), axis=(1, 2))
        cur = np.clip(cur + rng.normal(0, 0.01, cur.shape)
                      .astype(np.float32), 0, 1).astype(np.float32)
        pairs.append((im, cur))
    return pairs


def _device_ec():
    return env_flag("OPENDCVC_TPU_DEVICE_EC")


def measure(ckpt_path, qps=(16, 26, 36, 46), size=128, n_images=4,
            seed=0, width=None, gen=None, device="cuda"):
    """QP sweep of a DMCI checkpoint (its extra's model_kwargs give the
    widths) on real streams.  `width` makes the frames non-square (e.g.
    1080x1920): they are edge-padded to a multiple of 64 as the harness
    pads, PSNR is taken on the unpadded region, and both bpp figures
    count the padded pixels, so stream_vs_estimate does not depend on the
    alignment.  `gen(n, size, seed, width=)` replaces the content
    (default synthetic_images).  Returns [{qp, bpp_stream, bpp_estimate,
    stream_vs_estimate, psnr}]."""
    payload = ckpt.load_checkpoint(ckpt_path)
    model_kw = {k: int(v) for k, v in
                (payload.get("extra") or {}).get("model_kwargs", {}).items()}
    net = DMCI(**model_kw, device=device, device_ec=_device_ec())
    net.load_params(from_jax(payload["params"]))
    net.update()

    imgs = (gen or synthetic_images)(n_images, size, seed, width=width)
    h, w = size, (size if width is None else width)
    pr, pb = CM.get_padding_size(h, w, 64)
    n_pix = (h + pb) * (w + pr)

    points = []
    for qp in qps:
        est_bits = real_bits = 0.0
        quality = []
        for img in imgs:
            x = np.pad(img, ((0, 0), (0, pb), (0, pr), (0, 0)), mode="edge")
            with torch.no_grad():
                fwd = dmci_forward(net.params, upload(x, net.device), qp)
            est_bits += float(fwd["bpp"]) * n_pix
            enc = net.compress(x, qp)
            real_bits += len(enc["bit_stream"]) * 8
            quality.append(float(calc_psnr(
                enc["x_hat"].float().cpu().numpy()[:, :h, :w], img,
                data_range=1.0)))
        points.append({
            "qp": int(qp),
            "bpp_stream": real_bits / (n_images * n_pix),
            "bpp_estimate": est_bits / (n_images * n_pix),
            "stream_vs_estimate": real_bits / est_bits,
            "psnr": float(np.mean(quality)),
        })
    return points


def _log_step(i, metrics, qp):
    print(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
          f"bpp={float(metrics['bpp']):.4f} "
          f"mse={float(metrics['mse']):.5f} qp={qp}", flush=True)


def train_tiny(out_ckpt, steps=3000, seed=0, crop=96, batch=8,
               lmbda_min=32.0, lmbda_max=4096.0, lr=1e-4,
               log_every=200, resume_from=None, model_kw=None,
               device="cuda"):
    """Train a DMCI RD-evidence checkpoint (TINY_KW widths unless model_kw
    says otherwise, {} the full size) on synthetic_images with the per-qp
    lambda ladder; saves the params (save_params, with extra model_kwargs,
    steps, seed and lmbda) every 500 steps and at the end.  resume_from
    continues from a checkpoint's params with a fresh optimizer.  The
    port's init is drawn from `seed` by torch.Generator; each step's qp
    from np.random.default_rng(seed + 1), as in the JAX package."""
    device = CM.resolve_device(device)
    kw = TINY_KW if model_kw is None else model_kw
    if resume_from:
        params = from_jax(ckpt.load_checkpoint(resume_from)["params"])
    else:
        params = dmci_init(torch.Generator().manual_seed(seed), **kw)
    params = to_device(params, device)
    tx = make_optimizer(base_lr=lr, schedule="cosine", total_steps=steps,
                        warmup_steps=min(200, steps))
    step_fn = make_train_step(make_dmci_loss(lmbda_min, quant_mode="ste",
                                             lmbda_max=lmbda_max), tx)
    opt_state = tx.init(trainable_leaves(params))
    rng = np.random.default_rng(seed + 1)
    for i in range(steps):
        imgs = np.concatenate(synthetic_images(batch, crop,
                                               seed=seed + 10 + i), axis=0)
        qp = int(rng.integers(0, 64))
        params, opt_state, metrics = step_fn(
            params, opt_state, upload(imgs, device), qp, None)
        if (i + 1) % log_every == 0:
            _log_step(i, metrics, qp)
        if (i + 1) % 500 == 0 or i + 1 == steps:
            ckpt.save_params(out_ckpt, params,
                             extra={"model_kwargs": kw, "steps": i + 1,
                                    "seed": seed,
                                    "lmbda": [lmbda_min, lmbda_max]})
    return out_ckpt


def measure_dmc(ckpt_path, qps=(16, 26, 36, 46), size=128, n_pairs=4,
                seed=0, device="cuda"):
    """P-frame RD sweep of a DMC checkpoint on real streams: each pair
    puts the true reference in the DPB, encodes the current frame and
    decodes it from the bytes with a second DMC.  Returns [{qp,
    bpp_stream, bpp_estimate, stream_vs_estimate, psnr, decoder_exact}],
    decoder_exact: every decoded frame's feature (the next frame's
    reference) equals the encoder's."""
    params = from_jax(ckpt.load_checkpoint(ckpt_path)["params"])
    net, dec = (DMC(device=device, device_ec=_device_ec()) for _ in "ed")
    for codec in (net, dec):
        codec.load_params(params)
        codec.update()
    sps = {"sps_id": 0, "height": size, "width": size, "ec_part": 0,
           "use_ada_i": 0}

    pairs = synthetic_pairs(n_pairs, size, seed)
    points = []
    for qp in qps:
        est_bits = real_bits = 0.0
        quality, exact = [], True
        for ref, cur in pairs:
            with torch.no_grad():
                fwd = dmc_forward_one_frame(
                    net.params, upload(cur, net.device),
                    upload(ref, net.device), None, qp)
            est_bits += float(fwd["bpp"]) * size * size
            for codec in (net, dec):
                codec.clear_dpb()
                codec.set_curr_poc(0)
                codec.add_ref_frame(None, ref)
            enc = net.compress(cur, qp)
            real_bits += len(enc["bit_stream"]) * 8
            out = dec.decompress(enc["bit_stream"], sps, qp)
            exact = exact and torch.equal(dec.dpb[0].feature,
                                          net.dpb[0].feature)
            quality.append(float(calc_psnr(
                out["x_hat"].float().cpu().numpy(), cur, data_range=1.0)))
        points.append({
            "qp": int(qp),
            "bpp_stream": real_bits / (n_pairs * size * size),
            "bpp_estimate": est_bits / (n_pairs * size * size),
            "stream_vs_estimate": real_bits / est_bits,
            "psnr": float(np.mean(quality)),
            "decoder_exact": bool(exact),
        })
    return points


def train_tiny_dmc(out_ckpt, steps=2000, seed=0, crop=96, batch=4,
                   lmbda_min=32.0, lmbda_max=4096.0, lr=1e-4,
                   log_every=100, device="cuda"):
    """Train a full-size DMC P-frame RD-evidence checkpoint on
    synthetic_pairs with the per-qp lambda ladder (DMC has no reduced
    widths); saves the params every 250 steps and at the end."""
    device = CM.resolve_device(device)
    params = to_device(dmc_init(torch.Generator().manual_seed(seed)),
                       device)
    tx = make_optimizer(base_lr=lr, schedule="cosine", total_steps=steps,
                        warmup_steps=min(200, steps))
    step_fn = make_train_step(make_dmc_loss(lmbda_min, quant_mode="ste",
                                            lmbda_max=lmbda_max), tx)
    opt_state = tx.init(trainable_leaves(params))
    rng = np.random.default_rng(seed + 1)
    for i in range(steps):
        frames = np.stack([np.concatenate([r, c], axis=0) for r, c in
                           synthetic_pairs(batch, crop, seed=seed + 10 + i)])
        qp = int(rng.integers(0, 64))
        params, opt_state, metrics = step_fn(
            params, opt_state, upload(frames, device), qp, None)
        if (i + 1) % log_every == 0:
            _log_step(i, metrics, qp)
        if (i + 1) % 250 == 0 or i + 1 == steps:
            ckpt.save_params(out_ckpt, params,
                             extra={"steps": i + 1, "seed": seed,
                                    "lmbda": [lmbda_min, lmbda_max]})
    return out_ckpt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--qps", type=int, nargs="+",
                    default=[16, 26, 36, 46])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--width", type=int, default=0,
                    help="frame width for non-square sweeps (0 = "
                         "square --size; e.g. --size 1080 --width "
                         "1920 for true 1080p)")
    ap.add_argument("--train_tiny", action="store_true",
                    help="first (re)train the committable tiny "
                         "checkpoint at --ckpt, then measure")
    ap.add_argument("--train_full", action="store_true",
                    help="first train a FULL-size DMCI at --ckpt, then "
                         "measure")
    ap.add_argument("--resume_from", default=None)
    ap.add_argument("--crop", type=int, default=96)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", choices=["dmci", "dmc"], default="dmci")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the CPU "
                         "path)")
    args = ap.parse_args(argv)
    if args.model == "dmc":
        if args.train_tiny:
            train_tiny_dmc(args.ckpt, steps=args.steps, seed=args.seed,
                           device=args.device)
        points = measure_dmc(args.ckpt, qps=tuple(args.qps),
                             size=args.size, device=args.device)
    else:
        if args.train_tiny or args.train_full:
            train_tiny(args.ckpt, steps=args.steps, seed=args.seed,
                       crop=args.crop, batch=args.batch,
                       resume_from=args.resume_from,
                       model_kw={} if args.train_full else None,
                       device=args.device)
        points = measure(args.ckpt, qps=tuple(args.qps), size=args.size,
                         width=args.width or None, device=args.device)
    payload = {"model": args.model, "ckpt": args.ckpt, "points": points}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    for p in points:
        print(p)
    return payload


if __name__ == "__main__":
    main()
