"""DCVC-FM RD evaluation harness.

    python -m opendcvc_tpu_torch.eval.fm_harness --test_config CONFIG.json \\
        --output_path OUT.json [--device cuda|cpu] [...]

Counterpart of the JAX package's `eval/fm_harness.py` (reference:
DCVC-FM's test_video.py): the same CLI, dataset-config schema, FM NAL
streams and JSON output.  Each (sequence, rate) job codes the frames
through DMCIFM + DMCFM into one stream (the SPS carries qp and fa_idx, a
new SPS only when the pair changes), writes it as a `.bin`, decodes it
back from the file and writes the RD JSON.  P-frames take the
hierarchical QP of INDEX_MAP / QP_SHIFT over the rate GOP, and every
frame with frame_idx % reset_interval == 1 refreshes: fa_idx 3 in the
SPS, the DPB's features and latents dropped, the frame coded from the
reference frame alone with feature adaptor 2.

The codecs run on `--device` (default cuda; without CUDA that raises, and
the harness runs on the CPU only when `--device cpu` asks for it) with the
host rANS coder, or, with OPENDCVC_TPU_DEVICE_EC=1 (read by the codecs'
constructors, as the JAX package's read it), with device EC: kernels
K1/K2 on the card, their plain versions on the CPU; a frame record then
carries the "tpu-lane" container (the JAX FM harness writes its device
streams the same way).  Weights: `--model_path_i/_p` read the JAX
package's checkpoints (no JAX needed); without them the codecs take the
port's own random init from `--seed` (intra) and `--seed + 1` (P), drawn
by torch.Generator, not the JAX package's weights for the same seed.
"""

import argparse
import io
import json
import os
import time

import numpy as np
import torch

from ..models import common as CM
from ..models.dmc_fm import DMCFM
from ..models.dmci_fm import DMCIFM
from ..utils import checkpoint as ckpt
from ..utils import stream_helper_fm as SF
from ..utils.common import create_folder, dump_json, generate_log_json, \
    str2bool
from ..utils.params import from_jax
from .harness import (_originals, _read_src_frame, _sync, get_distortion,
                      get_src_frame, get_src_reader)

INDEX_MAP = [0, 1, 0, 2, 0, 2, 0, 2]
QP_SHIFT = [0, 8, 4, 0]


def _reset_dpb(dpb):
    return dict(dpb, ref_feature=None, ref_mv_feature=None, ref_y=None,
                ref_mv_y=None)


def _intra_dpb(x_hat):
    return _reset_dpb({"ref_frame": x_hat})


def run_one_point(p_net, i_net, args):
    """Code one sequence at one rate into args["curr_bin_path"], decode it
    from the file, write and return the RD log."""
    frame_num = args["frame_num"]
    intra_period = args["intra_period"]
    reset_interval = args.get("reset_interval", 32)
    pic_h, pic_w = args["src_height"], args["src_width"]
    padding_r, padding_b = CM.get_padding_size(pic_h, pic_w, 16)
    device = torch.device(args["device"])

    src_reader = get_src_reader(args)
    sps_helper = SF.SPSHelper()
    output_buff = io.BytesIO()
    frame_types, psnrs, msssims, bits = [], [], [], []
    enc_times, dec_times = [], []
    start_time = time.time()

    dpb = None
    for frame_idx in range(frame_num):
        x, _, _, _, _ = get_src_frame(args, src_reader,
                                      (padding_b, padding_r))
        _sync(device)
        t0 = time.time()
        is_i = frame_idx == 0 or (intra_period > 0
                                  and frame_idx % intra_period == 0)
        if is_i:
            qp = args["qp_i"]
            fa_idx = 0
            enc = i_net.compress(x, qp)
            dpb = _intra_dpb(enc["x_hat"])
            frame_types.append(0)
        else:
            fa_idx = INDEX_MAP[frame_idx % 8]
            if reset_interval > 0 and frame_idx % reset_interval == 1:
                fa_idx = 3
                dpb = _reset_dpb(dpb)
            qp = min(args["qp_p"] + QP_SHIFT[fa_idx], 63)
            enc = p_net.compress(x, dpb, qp, min(fa_idx, 2))
            dpb = enc["dpb"]
            frame_types.append(1)

        sps = {"sps_id": -1, "height": pic_h, "width": pic_w, "qp": qp,
               "fa_idx": fa_idx}
        sps_id, new = sps_helper.get_sps_id(sps)
        sps["sps_id"] = sps_id
        n = SF.write_sps(output_buff, sps) if new else 0
        n += SF.write_ip(output_buff, is_i, sps_id, enc["bit_stream"])
        bits.append(n * 8)
        _sync(device)
        enc_times.append(time.time() - t0)

    src_reader.close()
    with open(args["curr_bin_path"], "wb") as f:
        f.write(output_buff.getbuffer())
    output_buff.close()

    # decode from the file
    sps_helper = SF.SPSHelper()
    with open(args["curr_bin_path"], "rb") as f:
        input_buff = io.BytesIO(f.read())
    src_reader = get_src_reader(args)
    dpb = None
    for _ in range(frame_num):
        y, u, v, rgb = _originals(args, _read_src_frame(args, src_reader))
        t0 = time.time()
        header = SF.read_header(input_buff)
        while header["nal_type"] == SF.NalType.NAL_SPS:
            sps = SF.read_sps_remaining(input_buff, header["sps_id"])
            sps_helper.add_sps_by_id(sps)
            header = SF.read_header(input_buff)
        if header["nal_type"] not in (SF.NalType.NAL_I, SF.NalType.NAL_P):
            raise ValueError(f"{args['curr_bin_path']}: unexpected "
                             f"{header['nal_type'].name} record")
        sps = sps_helper.get_sps_by_id(header["sps_id"])
        if sps is None:
            raise ValueError(f"{args['curr_bin_path']}: a frame names SPS "
                             f"{header['sps_id']}, which is not defined")
        stream = SF.read_ip_remaining(input_buff)

        if header["nal_type"] == SF.NalType.NAL_I:
            dpb = _intra_dpb(i_net.decompress(stream, sps)["x_hat"])
        else:
            if sps["fa_idx"] == 3:
                dpb = _reset_dpb(dpb)
            dsps = dict(sps, fa_idx=min(sps["fa_idx"], 2))
            dpb = p_net.decompress(stream, dpb, dsps)["dpb"]
        x_hat = dpb["ref_frame"]
        _sync(device)
        dec_times.append(time.time() - t0)
        cp, cs = get_distortion(args, x_hat, y, u, v, rgb)
        psnrs.append(cp)
        msssims.append(cs)
    input_buff.close()
    src_reader.close()

    test_time = time.time() - start_time
    avg_enc = sum(enc_times[1:]) / max(len(enc_times) - 1, 1)
    avg_dec = sum(dec_times[1:]) / max(len(dec_times) - 1, 1)
    log = generate_log_json(frame_num, pic_h * pic_w, test_time,
                            frame_types, bits, psnrs, msssims,
                            avg_encoding_time=avg_enc,
                            avg_decoding_time=avg_dec)
    with open(args["curr_json_path"], "w") as f:
        json.dump(log, f, indent=2)
    return log


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DCVC-FM RD evaluation")
    p.add_argument("--model_path_i", type=str, default=None,
                   help="a JAX package checkpoint of DMCIFM")
    p.add_argument("--model_path_p", type=str, default=None,
                   help="a JAX package checkpoint of DMCFM")
    p.add_argument("--rate_num", type=int, default=4)
    p.add_argument("--qp_i", type=int, nargs="+")
    p.add_argument("--qp_p", type=int, nargs="+")
    p.add_argument("--force_intra_period", type=int, default=-1)
    p.add_argument("--reset_interval", type=int, default=32)
    p.add_argument("--force_frame_num", type=int, default=-1)
    p.add_argument("--test_config", type=str, required=True)
    p.add_argument("--force_root_path", type=str, default=None)
    p.add_argument("--calc_ssim", type=str2bool, default=False)
    p.add_argument("--stream_path", type=str, default="out_bin_fm")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--seed", type=int, default=0,
                   help="random-init seed without checkpoints (the intra "
                        "codec takes seed, the P codec seed + 1)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the codecs (default cuda; cpu "
                        "runs the CPU path)")
    return p.parse_args(argv)


def _load(net, path, seed):
    if path:
        net.load_params(from_jax(ckpt.load_params(path)))
    else:
        net.init_params(seed=seed)
    net.update()
    return net


def build_nets(args):
    """(DMCIFM, DMCFM) on args.device: weights from --model_path_i/_p,
    else the port's random init from --seed and --seed + 1."""
    i_net = _load(DMCIFM(device=args.device), args.model_path_i, args.seed)
    p_net = _load(DMCFM(device=args.device), args.model_path_p,
                  args.seed + 1)
    return i_net, p_net


def main(argv=None):
    args = parse_args(argv)
    CM.resolve_device(args.device)      # no CUDA: raises before any work
    with open(args.test_config) as f:
        config = json.load(f)

    qp_i = args.qp_i or [int(i + 0.5) for i in
                         np.linspace(0, 63, args.rate_num)]
    qp_p = args.qp_p or qp_i
    if len(qp_p) != len(qp_i):
        raise ValueError(f"{len(qp_p)} --qp_p values for {len(qp_i)} "
                         f"--qp_i values")
    i_net, p_net = build_nets(args)

    root_path = args.force_root_path or config["root_path"]
    results = {}
    for ds_name, ds in config["test_classes"].items():
        if ds.get("test", 1) == 0:
            continue
        results[ds_name] = {}
        for seq, info in ds["sequences"].items():
            results[ds_name][seq] = {}
            for ri in range(len(qp_i)):
                cur = {
                    "src_type": ds["src_type"],
                    "src_height": info["height"],
                    "src_width": info["width"],
                    "frame_num": args.force_frame_num
                    if args.force_frame_num > 0 else info["frames"],
                    "intra_period": args.force_intra_period
                    if args.force_intra_period > 0
                    else info["intra_period"],
                    "reset_interval": args.reset_interval,
                    "qp_i": qp_i[ri], "qp_p": qp_p[ri],
                    "calc_ssim": args.calc_ssim,
                    "device": args.device,
                }
                bin_folder = os.path.join(args.stream_path, ds_name)
                create_folder(bin_folder)
                cur["src_path"] = os.path.join(root_path, ds["base_path"],
                                               seq)
                cur["curr_bin_path"] = os.path.join(
                    bin_folder, f"{seq}_q{qp_i[ri]}.bin")
                cur["curr_json_path"] = \
                    cur["curr_bin_path"].replace(".bin", ".json")
                r = run_one_point(p_net, i_net, cur)
                r.update({"rate_idx": ri, "qp_i": qp_i[ri],
                          "qp_p": qp_p[ri]})
                results[ds_name][seq][f"{ri:03d}"] = r

    out_dir = os.path.dirname(args.output_path)
    if out_dir:
        create_folder(out_dir)
    with open(args.output_path, "w") as f:
        dump_json(results, f, float_digits=6, indent=2)
    print("FM evaluation finished")


if __name__ == "__main__":
    main()
