"""Image-codec RD evaluation harness (EVC).

    python -m opendcvc_tpu_torch.eval.image_harness --test_config CFG.json \\
        --output_path OUT.json [--model_type EVC_LL] [--device cuda|cpu]

Counterpart of the JAX package's `eval/image_harness.py` (reference: EVC's
test_image.py): the same CLI, JSON dataset config (Kodak-style folders of
images), `.bin` container (`utils/stream_helper.py::encode_i`) and JSON
results.  Each image is padded to a multiple of 64 by edge replication,
coded at each rate into a `.bin`, decoded back from the file, cropped,
and scored (PSNR, and MS-SSIM with --calc_ssim) on the host.  The rates
are --q_scales, else the model's q_scale anchors when --rate_num equals
their count, else --rate_num values spaced log-evenly between the
smallest and the largest anchor (which must differ).

The codec runs on --device (default cuda; without CUDA that raises, and
the harness runs on the CPU only when --device cpu asks for it).  Weights:
--model_path reads a JAX package checkpoint (no JAX needed); without it
the codec takes the port's own random init from --seed, drawn by
torch.Generator, not the JAX package's weights for the same seed.
Encode and decode times are host-clock times that end after a
synchronize.  PNG images need PIL, imported on first use.
"""

import argparse
import json
import os
import time

import numpy as np

from ..models import common as CM
from ..models.evc import (EVC_LL, EVC_LM, EVC_LS, EVC_ML, EVC_MM, EVC_MS,
                          EVC_SL, EVC_SS, ScalableEVC)
from ..ops.fused import replicate_pad
from ..utils import checkpoint as ckpt
from ..utils.common import create_folder, dump_json, str2bool
from ..utils.io import _pil_image
from ..utils.metrics import calc_msssim_rgb, calc_psnr
from ..utils.params import from_jax
from ..utils.stream_helper import (decode_i, encode_i, get_rounded_q,
                                   interpolate_log)
from .harness import _sync

MODEL_REGISTRY = {
    "EVC_LL": EVC_LL, "EVC_LM": EVC_LM, "EVC_LS": EVC_LS,
    "EVC_ML": EVC_ML, "EVC_SL": EVC_SL, "EVC_MM": EVC_MM,
    "EVC_MS": EVC_MS, "EVC_SS": EVC_SS,
    "Scale_EVC_SS": ScalableEVC, "Scale_EVC_SL": ScalableEVC,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="image codec RD evaluation")
    p.add_argument("--model_type", type=str, default="EVC_LL",
                   choices=sorted(MODEL_REGISTRY))
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--test_config", type=str, required=True)
    p.add_argument("--rate_num", type=int, default=4)
    p.add_argument("--q_scales", type=float, nargs="+", default=None)
    p.add_argument("--calc_ssim", type=str2bool, default=False)
    p.add_argument("--stream_path", type=str, default="out_bin_image")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the CPU "
                        "path)")
    return p.parse_args(argv)


def read_image(path):
    """An image file as (H, W, 3) float32 in [0, 1]."""
    rgb = _pil_image().open(path).convert("RGB")
    return np.asarray(rgb).astype(np.float32) / 255.0


def run_one_image(net, img, q_scale, bin_path, calc_ssim=False):
    """Code one (H, W, 3) image at q_scale (rounded to 1/100) into
    bin_path, decode it back from the file; returns {bpp, psnr, msssim,
    encoding_time, decoding_time}."""
    h, w, _ = img.shape
    pr, pb = CM.get_padding_size(h, w, 64)
    x = CM.frame_to_nchw(img[None], net.device)
    x_pad = CM.frame_to_nhwc(replicate_pad(x, pb, pr))

    q_scale, q_index = get_rounded_q(q_scale)
    _sync(net.device)
    t0 = time.time()
    enc = net.compress(x_pad, q_scale)
    _sync(net.device)
    enc_time = time.time() - t0
    encode_i(h, w, q_index, enc["bit_stream"], bin_path)
    bits = os.path.getsize(bin_path) * 8

    h2, w2, qi2, stream = decode_i(bin_path)
    t0 = time.time()
    dec = net.decompress(stream, h2, w2, qi2 / 100)
    _sync(net.device)
    dec_time = time.time() - t0
    x_hat = dec["x_hat"][0, :h, :w].float().cpu().numpy()

    rec = np.clip(x_hat * 255, 0, 255)
    src = img * 255
    psnr = calc_psnr(src.transpose(2, 0, 1), rec.transpose(2, 0, 1))
    ssim = calc_msssim_rgb(src.transpose(2, 0, 1),
                           rec.transpose(2, 0, 1)) if calc_ssim else 0.0
    return {"bpp": bits / (h * w), "psnr": psnr, "msssim": ssim,
            "encoding_time": enc_time, "decoding_time": dec_time}


def main(argv=None):
    args = parse_args(argv)
    CM.resolve_device(args.device)      # no CUDA: raises before any work
    with open(args.test_config) as f:
        config = json.load(f)

    net = MODEL_REGISTRY[args.model_type](device=args.device)
    if args.model_path:
        net.load_params(from_jax(ckpt.load_params(args.model_path)))
    else:
        net.init_params(seed=args.seed)
    net.update()

    if args.q_scales:
        q_scales = args.q_scales
    else:
        anchors = net.get_q_scales()
        if args.rate_num == len(anchors):
            q_scales = list(map(float, anchors))
        else:
            q_scales = interpolate_log(float(min(anchors)),
                                       float(max(anchors)), args.rate_num)

    root_path = config["root_path"]
    results = {}
    create_folder(args.stream_path)
    for ds_name, ds in config["test_classes"].items():
        if ds.get("test", 1) == 0:
            continue
        base = os.path.join(root_path, ds["base_path"])
        results[ds_name] = {}
        for img_name in ds["images"]:
            img = read_image(os.path.join(base, img_name))
            results[ds_name][img_name] = {}
            for ri, q in enumerate(q_scales):
                bin_path = os.path.join(
                    args.stream_path, f"{img_name}_{ri}.bin")
                r = run_one_image(net, img, q, bin_path, args.calc_ssim)
                r["q_scale"] = q
                results[ds_name][img_name][f"{ri:03d}"] = r
                if args.verbose:
                    print(f"{img_name} q={q:.3f}: bpp={r['bpp']:.4f} "
                          f"psnr={r['psnr']:.3f}")

    out_dir = os.path.dirname(args.output_path)
    if out_dir:
        create_folder(out_dir)
    with open(args.output_path, "w") as f:
        dump_json(results, f, float_digits=6, indent=2)
    print("Image evaluation finished")
    return results


if __name__ == "__main__":
    main()
