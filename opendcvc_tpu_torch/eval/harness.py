"""RD evaluation harness.

    python -m opendcvc_tpu_torch.eval.harness --test_config CONFIG.json \\
        --output_path OUT.json [--device cuda|cpu] [...]

Counterpart of the JAX package's `eval/harness.py` (reference:
test_video.py): the same CLI, JSON dataset-config schema, NAL bitstream
files and JSON output layout.  Each (sequence, rate) job codes the frames
through DMCI + DMC into one NAL stream, writes it as a `.bin`, decodes it
back from the file and writes the RD JSON (bpp, PSNR, MS-SSIM, frame
times).  The codecs run on `--device` (default cuda; without CUDA that
raises, and the harness runs on the CPU only when `--device cpu` asks for
it).  They code with the host rANS coder, or with the lane rANS kernels
K1/K2 when OPENDCVC_TPU_DEVICE_EC is set, their staging sized by
OPENDCVC_TPU_EC_LANES / _EC_BPS / _EC_CAP_FRAC, which the codecs read.
Jobs run one after another, or over `--worker N` threads with one codec
pair each.

Weights: `--model_path_i/_p` read the JAX package's checkpoints (no JAX
needed).  Without them the codecs take the port's own random init from
`--seed`, drawn by torch.Generator: not the JAX package's weights for the
same seed.  `--dtype bfloat16` codes in bfloat16, as the JAX harness
does: `--seed` weights are cast to it, checkpoint weights are kept as
loaded (each convolution casts them), and the recon's crop, colour
conversion and clip run in bfloat16 before the metrics read float32.

`--write_stream 0` is the estimate mode: no stream is written; the
training forwards (`training/forward.py`, straight-through rounding) run
on the codecs' weights under torch.inference_mode and the JSON takes
their rate estimates, as the JAX harness's `run_one_point_estimation`.
"""

import argparse
import io
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models import common as CM
from ..models.dmc import DMC
from ..models.dmci import DMCI
from ..ops.fused import replicate_pad
from ..training.forward import dmc_forward_one_frame, dmci_forward
from ..utils import checkpoint as ckpt
from ..utils.common import (create_folder, dump_json, env_flag,
                            generate_log_json, str2bool)
from ..utils.io import PNGReader, PNGWriter, YUV420Reader, YUV420Writer
from ..utils.metrics import calc_msssim, calc_msssim_rgb, calc_psnr
from ..utils.params import from_jax
from ..utils.stream_helper import (NalType, SPSHelper, read_header,
                                   read_ip_remaining, read_sps_remaining,
                                   write_ip, write_sps)
from ..utils.transforms import (rgb2ycbcr, ycbcr2rgb, ycbcr420_to_444_np,
                                yuv_444_to_420)

def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="opendcvc_tpu_torch RD evaluation")
    parser.add_argument('--force_zero_thres', type=float, default=None)
    parser.add_argument('--model_path_i', type=str, default=None,
                        help='a JAX package checkpoint of the intra codec')
    parser.add_argument('--model_path_p', type=str, default=None,
                        help='a JAX package checkpoint of the P codec')
    parser.add_argument('--rate_num', type=int, default=4)
    parser.add_argument('--qp_i', type=int, nargs="+")
    parser.add_argument('--qp_p', type=int, nargs="+")
    parser.add_argument("--force_intra", type=str2bool, default=False)
    parser.add_argument("--force_frame_num", type=int, default=-1)
    parser.add_argument("--force_intra_period", type=int, default=-1)
    parser.add_argument('--reset_interval', type=int, default=32)
    parser.add_argument('--test_config', type=str, required=True)
    parser.add_argument('--force_root_path', type=str, default=None)
    parser.add_argument("--worker", "-w", type=int, default=1)
    parser.add_argument('--calc_ssim', type=str2bool, default=False)
    parser.add_argument('--write_stream', type=str2bool, default=True,
                        help='0: estimate mode (rate estimates of the '
                             'training forwards, no stream)')
    parser.add_argument('--check_existing', type=str2bool, default=False)
    parser.add_argument('--stream_path', type=str, default="out_bin")
    parser.add_argument('--save_decoded_frame', type=str2bool, default=False)
    parser.add_argument('--output_path', type=str, required=True)
    parser.add_argument('--verbose_json', type=str2bool, default=False)
    parser.add_argument('--verbose', type=int, default=0)
    parser.add_argument('--dtype', type=str, default='float32',
                        choices=list(CM.DTYPES),
                        help='the codecs\' activation dtype')
    parser.add_argument('--seed', type=int, default=0,
                        help='random-init seed when no checkpoint is given '
                             '(the intra codec takes seed, the P codec '
                             'seed + 1); the port draws its init with '
                             'torch.Generator, so these weights are not the '
                             'JAX package\'s: pass --model_path_i/_p for '
                             'the same weights')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device of the codecs (default cuda; '
                             'cpu runs the CPU path)')
    return parser.parse_args(argv)


def np_image_to_tensor(img):
    """(3,H,W) uint8 -> (1,H,W,3) float NHWC in [0,1]."""
    x = img.astype(np.float32) / 255.0
    return x.transpose(1, 2, 0)[None]


# IO transforms on the codec's device (NHWC tensors): color conversion,
# padding and the reconstruction's crop, color conversion and clip

def _prep_yuv(yuv, pb, pr):
    return replicate_pad(yuv.permute(0, 3, 1, 2), pb, pr).permute(0, 2, 3, 1)


def _prep_png(rgb, pb, pr):
    return _prep_yuv(rgb2ycbcr(rgb), pb, pr)


def _post_png(x_hat, h, w):
    rgb = ycbcr2rgb(x_hat[:, :h, :w, :])
    return torch.clamp(rgb * 255.0, 0.0, 255.0)


def _post_yuv(x_hat, h, w):
    y, uv = yuv_444_to_420(x_hat[:, :h, :w, :])
    return (torch.clamp(y * 255.0, 0.0, 255.0),
            torch.clamp(uv * 255.0, 0.0, 255.0))


def _sync(device):
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def get_src_reader(args):
    if args['src_type'] == 'png':
        return PNGReader(args['src_path'], args['src_width'],
                         args['src_height'])
    if args['src_type'] == 'yuv420':
        return YUV420Reader(args['src_path'], args['src_width'],
                            args['src_height'])
    raise ValueError(args['src_type'])


def _read_src_frame(args, src_reader):
    """The next source frame as read: (y (1, H, W), uv (2, H/2, W/2))
    uint8 for YUV420, (3, H, W) uint8 RGB for PNG."""
    frame = src_reader.read_one_frame()
    if (frame[0] if args['src_type'] == 'yuv420' else frame) is None:
        raise ValueError(f"{args['src_path']} ends before frame "
                         f"{args['frame_num']}")
    return frame


def _originals(args, frame):
    """(y, u, v, rgb): the host-side originals of a frame for metrics."""
    if args['src_type'] == 'yuv420':
        y, uv = frame
        return y[0], uv[0], uv[1], None
    return None, None, None, frame


def get_src_frame(args, src_reader, padding=(0, 0)):
    """Returns the padded codec input (NHWC, on the codec's device) plus
    host-side originals for metrics."""
    pb, pr = padding
    frame = _read_src_frame(args, src_reader)
    if args['src_type'] == 'yuv420':
        y, uv = frame
        yuv = ycbcr420_to_444_np(y.astype(np.float32) / 255.0,
                                 uv.astype(np.float32) / 255.0)
        x = _prep_yuv(CM.upload(yuv.transpose(1, 2, 0)[None],
                                torch.device(args['device'])), pb, pr)
    else:
        x = _prep_png(CM.upload(np_image_to_tensor(frame),
                                torch.device(args['device'])), pb, pr)
    return (x,) + _originals(args, frame)


def _postprocess(args, x_hat):
    """The decoded frame cropped, color-converted and clipped on the
    device in x_hat's dtype, as the JAX harness's jitted post-processing;
    only the result is fetched.  Returns float32 host arrays: (y (H, W),
    uv (H/2, W/2, 2)) for YUV420, (3, H, W) RGB for PNG."""
    h, w = args['src_height'], args['src_width']
    if args['src_type'] == 'yuv420':
        y_rec, uv_rec = _post_yuv(x_hat, h, w)
        return (y_rec[0, :, :, 0].float().cpu().numpy(),
                uv_rec[0].float().cpu().numpy())
    return _post_png(x_hat, h, w)[0].permute(2, 0, 1).float().cpu().numpy()


def _distortion(args, rec, y, u, v, rgb):
    if args['src_type'] == 'yuv420':
        y_rec, uv_rec = rec
        u_rec, v_rec = uv_rec[:, :, 0], uv_rec[:, :, 1]
        psnr_y = calc_psnr(y, y_rec)
        psnr_u = calc_psnr(u, u_rec)
        psnr_v = calc_psnr(v, v_rec)
        psnr = (6 * psnr_y + psnr_u + psnr_v) / 8
        if args['calc_ssim']:
            ssim_y = calc_msssim(y, y_rec)
            ssim_u = calc_msssim(u, u_rec)
            ssim_v = calc_msssim(v, v_rec)
        else:
            ssim_y = ssim_u = ssim_v = 0.0
        ssim = (6 * ssim_y + ssim_u + ssim_v) / 8
        return [psnr, psnr_y, psnr_u, psnr_v], [ssim, ssim_y, ssim_u, ssim_v]
    psnr = calc_psnr(rgb, rec)
    msssim = calc_msssim_rgb(rgb, rec) if args['calc_ssim'] else 0.0
    return [psnr], [msssim]


def get_distortion(args, x_hat, y, u, v, rgb):
    return _distortion(args, _postprocess(args, x_hat), y, u, v, rgb)


def _write_recon(args, writer, rec):
    """Write a postprocessed frame as the JAX harness does: Y and RGB
    rounded, U and V truncated to uint8."""
    if args['src_type'] == 'yuv420':
        y_rec, uv_rec = rec
        writer.write_one_frame(np.round(y_rec).astype(np.uint8)[None],
                               uv_rec.astype(np.uint8).transpose(2, 0, 1))
    else:
        writer.write_one_frame(np.round(rec).astype(np.uint8))


def run_one_point_estimation(p_frame_net, i_frame_net, args):
    """--write_stream 0: the training forwards' rate estimates in place of
    streams (the reference test_video.py's estimate mode), under
    torch.inference_mode on the codecs' weights.  I-frames at qp_i,
    P-frames at qp_p (no hierarchical shift and no refresh, as the JAX
    harness's estimate mode); the JSON's bits are bpp x the padded
    frame's pixels."""
    frame_num = args['frame_num']
    intra_period = args['intra_period']
    pic_h, pic_w = args['src_height'], args['src_width']
    padding_r, padding_b = CM.get_padding_size(pic_h, pic_w, 16)
    src_reader = get_src_reader(args)

    frame_types, psnrs, msssims, bits = [], [], [], []
    start_time = time.time()
    feature = ref_frame = None
    with torch.inference_mode():
        for frame_idx in range(frame_num):
            x, y, u, v, rgb = get_src_frame(args, src_reader,
                                            (padding_b, padding_r))
            if frame_idx == 0 or (intra_period > 0
                                  and frame_idx % intra_period == 0):
                out = dmci_forward(i_frame_net.params, x, args['qp_i'])
                feature = None
                frame_types.append(0)
            else:
                out = dmc_forward_one_frame(p_frame_net.params, x, ref_frame,
                                            feature, args['qp_p'])
                feature = out['feature']
                frame_types.append(1)
            ref_frame = out['x_hat']
            bits.append(float(out['bpp']) * x.shape[1] * x.shape[2])
            cp, cs = get_distortion(args, out['x_hat'], y, u, v, rgb)
            psnrs.append(cp)
            msssims.append(cs)
    src_reader.close()
    log_result = generate_log_json(frame_num, pic_h * pic_w,
                                   time.time() - start_time, frame_types,
                                   bits, psnrs, msssims,
                                   verbose=args['verbose_json'])
    with open(args['curr_json_path'], 'w') as fp:
        json.dump(log_result, fp, indent=2)
    return log_result


def run_one_point_with_stream(p_frame_net, i_frame_net, args):
    if not args.get('write_stream', True):
        return run_one_point_estimation(p_frame_net, i_frame_net, args)
    if args['check_existing'] and os.path.exists(args['curr_json_path']) \
            and os.path.exists(args['curr_bin_path']):
        with open(args['curr_json_path']) as f:
            log_result = json.load(f)
        if log_result['i_frame_num'] + log_result['p_frame_num'] == \
                args['frame_num']:
            return log_result
        print(f"incorrect log for {args['curr_json_path']}, rerunning.")

    frame_num = args['frame_num']
    reset_interval = args['reset_interval']
    intra_period = args['intra_period']
    verbose = args['verbose']
    device = torch.device(args['device'])

    src_reader = get_src_reader(args)
    pic_height = args['src_height']
    pic_width = args['src_width']
    padding_r, padding_b = CM.get_padding_size(pic_height, pic_width, 16)

    use_two = pic_height * pic_width > 1280 * 720
    i_frame_net.set_use_two_entropy_coders(use_two)
    if p_frame_net is not None:
        p_frame_net.set_use_two_entropy_coders(use_two)

    frame_types, psnrs, msssims, bits = [], [], [], []
    encoding_time, decoding_time = [], []
    index_map = [0, 1, 0, 2, 0, 2, 0, 2]

    start_time = time.time()
    output_buff = io.BytesIO()
    sps_helper = SPSHelper()
    if p_frame_net is not None:
        p_frame_net.set_curr_poc(0)

    last_qp = 0
    for frame_idx in range(frame_num):
        x_padded, y, u, v, rgb = get_src_frame(args, src_reader,
                                               (padding_b, padding_r))
        _sync(device)
        frame_start = time.time()

        is_i_frame = (frame_idx == 0
                      or (intra_period > 0 and frame_idx % intra_period == 0))
        if is_i_frame:
            curr_qp = args['qp_i']
            sps = {'sps_id': -1, 'height': pic_height, 'width': pic_width,
                   'ec_part': 1 if use_two else 0, 'use_ada_i': 0}
            encoded = i_frame_net.compress(x_padded, curr_qp)
            if p_frame_net is not None:
                p_frame_net.clear_dpb()
                p_frame_net.add_ref_frame(None, encoded['x_hat'])
            frame_types.append(0)
        else:
            fa_idx = index_map[frame_idx % 8]
            if reset_interval > 0 and frame_idx % reset_interval == 1:
                use_ada_i = 1
                p_frame_net.prepare_feature_adaptor_i(last_qp)
            else:
                use_ada_i = 0
            curr_qp = p_frame_net.shift_qp(args['qp_p'], fa_idx)
            sps = {'sps_id': -1, 'height': pic_height, 'width': pic_width,
                   'ec_part': 1 if use_two else 0, 'use_ada_i': use_ada_i}
            encoded = p_frame_net.compress(x_padded, curr_qp)
            frame_types.append(1)
        last_qp = curr_qp

        sps_id, sps_new = sps_helper.get_sps_id(sps)
        sps['sps_id'] = sps_id
        sps_bytes = write_sps(output_buff, sps) if sps_new else 0
        stream_bytes = write_ip(output_buff, is_i_frame, sps_id, curr_qp,
                                encoded['bit_stream'])
        bits.append(stream_bytes * 8 + sps_bytes * 8)
        encoding_time.append(time.time() - frame_start)
        if verbose >= 2:
            print(f"frame {frame_idx} encoded, "
                  f"{encoding_time[-1] * 1000:.3f} ms, bits: {bits[-1]}")

    src_reader.close()
    with open(args['curr_bin_path'], "wb") as f:
        f.write(output_buff.getbuffer())
        total_bytes = output_buff.getbuffer().nbytes
    output_buff.close()
    total_kbps = int(total_bytes * 8 / (frame_num / 30) / 1000)

    # ---- decode from the file (full bitstream roundtrip)
    sps_helper = SPSHelper()
    with open(args['curr_bin_path'], "rb") as f:
        input_buff = io.BytesIO(f.read())
    src_reader = get_src_reader(args)

    recon_writer = None
    if args['save_decoded_frame']:
        if args['src_type'] == 'png':
            recon_writer = PNGWriter(args['bin_folder'], pic_width,
                                     pic_height)
        else:
            out_yuv = args['curr_rec_path'].replace(
                '.yuv', f'_{total_kbps}kbps.yuv')
            recon_writer = YUV420Writer(out_yuv, pic_width, pic_height)

    if p_frame_net is not None:
        p_frame_net.set_curr_poc(0)
    decoded_frame_number = 0
    while decoded_frame_number < frame_num:
        y, u, v, rgb = _originals(args, _read_src_frame(args, src_reader))
        frame_start = time.time()
        header = read_header(input_buff)
        while header['nal_type'] == NalType.NAL_SPS:
            sps = read_sps_remaining(input_buff, header['sps_id'])
            sps_helper.add_sps_by_id(sps)
            header = read_header(input_buff)
        sps = sps_helper.get_sps_by_id(header['sps_id'])
        qp, bit_stream = read_ip_remaining(input_buff)

        if header['nal_type'] == NalType.NAL_I:
            decoded = i_frame_net.decompress(bit_stream, sps, qp)
            if p_frame_net is not None:
                p_frame_net.clear_dpb()
                p_frame_net.add_ref_frame(None, decoded['x_hat'])
        else:
            if sps['use_ada_i']:
                p_frame_net.reset_ref_feature()
            decoded = p_frame_net.decompress(bit_stream, sps, qp)

        x_hat = decoded['x_hat']
        _sync(device)
        decoding_time.append(time.time() - frame_start)

        rec = _postprocess(args, x_hat)
        curr_psnr, curr_ssim = _distortion(args, rec, y, u, v, rgb)
        psnrs.append(curr_psnr)
        msssims.append(curr_ssim)
        if verbose >= 2:
            print(f"frame {decoded_frame_number} decoded, "
                  f"{decoding_time[-1] * 1000:.3f} ms, "
                  f"PSNR: {curr_psnr[0]:.4f}")

        if recon_writer is not None:
            _write_recon(args, recon_writer, rec)
        decoded_frame_number += 1

    input_buff.close()
    src_reader.close()
    if recon_writer is not None:
        recon_writer.close()

    test_time = time.time() - start_time
    n_warm = 10
    if verbose >= 1 and len(encoding_time) > n_warm:
        enc_t = encoding_time[n_warm:]
        dec_t = decoding_time[n_warm:]
        avg_enc = sum(enc_t) / len(enc_t)
        avg_dec = sum(dec_t) / len(dec_t)
        print(f"average encoding time {avg_enc * 1000:.3f} ms, "
              f"average decoding time {avg_dec * 1000:.3f} ms.")
    else:
        avg_enc = avg_dec = None

    log_result = generate_log_json(frame_num, pic_height * pic_width,
                                   test_time, frame_types, bits, psnrs,
                                   msssims, verbose=args['verbose_json'],
                                   avg_encoding_time=avg_enc,
                                   avg_decoding_time=avg_dec)
    with open(args['curr_json_path'], 'w') as fp:
        json.dump(log_result, fp, indent=2)
    return log_result


def _load(net, path, seed):
    """Checkpoint weights as loaded (a float32 file in a bfloat16 codec
    stays float32), else the init cast to the codec's dtype."""
    if path:
        net.load_params(from_jax(ckpt.load_params(path)))
    else:
        net.init_params(seed=seed)


def build_nets(args):
    """(DMCI, DMC or None with --force_intra) on args.device in
    args.dtype: weights from --model_path_i/_p, else the port's random
    init from --seed (intra) and --seed + 1 (P); device EC when
    OPENDCVC_TPU_DEVICE_EC is set."""
    device_ec = env_flag("OPENDCVC_TPU_DEVICE_EC")
    dtype = CM.DTYPES[args.dtype]
    i_frame_net = DMCI(device=args.device, device_ec=device_ec, dtype=dtype)
    _load(i_frame_net, args.model_path_i, args.seed)
    i_frame_net.update(args.force_zero_thres)

    p_frame_net = None
    if not args.force_intra:
        p_frame_net = DMC(device=args.device, device_ec=device_ec,
                          dtype=dtype)
        _load(p_frame_net, args.model_path_p, args.seed + 1)
        p_frame_net.update(args.force_zero_thres)
    return i_frame_net, p_frame_net


def _run_jobs(jobs, args):
    """Execute (sequence, rate) jobs, fanning out over `--worker N`
    threads with one codec pair per worker (the reference fans the same
    job list over a process pool, test_video.py:381-442; threads suffice
    because coder state is per codec and the device work and the native
    coder release the interpreter lock)."""

    def finalize(cur, result):
        result = dict(result)
        result['ds_name'] = cur['ds_name']
        result['seq'] = cur['seq']
        result['rate_idx'] = cur['rate_idx']
        result['qp_i'] = cur['qp_i']
        result['qp_p'] = cur['qp_p']
        return result

    n_workers = max(1, int(getattr(args, 'worker', 1) or 1))
    if n_workers <= 1 or len(jobs) <= 1:
        i_frame_net, p_frame_net = build_nets(args)
        return [finalize(cur, run_one_point_with_stream(
            p_frame_net, i_frame_net, cur)) for cur in jobs]

    local = threading.local()

    def run_job(cur):
        if not hasattr(local, 'nets'):
            local.nets = build_nets(args)
        i_net, p_net = local.nets
        return finalize(cur, run_one_point_with_stream(p_net, i_net, cur))

    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        return list(pool.map(run_job, jobs))


def _qps(args):
    """(qp_i, qp_p) lists of --rate_num entries."""
    rate_num = args.rate_num
    if args.qp_i is not None:
        if len(args.qp_i) != rate_num:
            raise ValueError(f"--qp_i has {len(args.qp_i)} values for "
                             f"--rate_num {rate_num}")
        qp_i = args.qp_i
    else:
        if not 2 <= rate_num <= CM.QP_NUM:
            raise ValueError(f"--rate_num {rate_num} without --qp_i must "
                             f"lie in [2, {CM.QP_NUM}]")
        qp_i = [int(i + 0.5)
                for i in np.linspace(0, CM.QP_NUM - 1, num=rate_num)]
    if args.qp_p is not None:
        if len(args.qp_p) != rate_num:
            raise ValueError(f"--qp_p has {len(args.qp_p)} values for "
                             f"--rate_num {rate_num}")
        return qp_i, args.qp_p
    return qp_i, qp_i


def main(argv=None):
    begin_time = time.time()
    args = parse_args(argv)
    CM.resolve_device(args.device)      # no CUDA: raises before any work
    if args.force_zero_thres is not None and args.force_zero_thres < 0:
        args.force_zero_thres = None

    with open(args.test_config) as f:
        config = json.load(f)

    rate_num = args.rate_num
    qp_i, qp_p = _qps(args)
    print(f"testing {rate_num} rates, using qp: "
          + ", ".join(str(q) for q in qp_i))

    root_path = args.force_root_path if args.force_root_path is not None \
        else config['root_path']
    config = config['test_classes']

    jobs = []
    count_frames = 0
    count_sequences = 0
    for ds_name in config:
        if config[ds_name]['test'] == 0:
            continue
        for seq in config[ds_name]['sequences']:
            count_sequences += 1
            for rate_idx in range(rate_num):
                cur = {
                    'rate_idx': rate_idx,
                    'qp_i': qp_i[rate_idx],
                    'qp_p': qp_p[rate_idx],
                    'force_intra': args.force_intra,
                    'reset_interval': args.reset_interval,
                    'seq': seq,
                    'src_type': config[ds_name]['src_type'],
                    'src_height': config[ds_name]['sequences'][seq]['height'],
                    'src_width': config[ds_name]['sequences'][seq]['width'],
                    'intra_period':
                        config[ds_name]['sequences'][seq]['intra_period'],
                    'frame_num': config[ds_name]['sequences'][seq]['frames'],
                    'calc_ssim': args.calc_ssim,
                    'dataset_path': os.path.join(
                        root_path, config[ds_name]['base_path']),
                    'write_stream': args.write_stream,
                    'check_existing': args.check_existing,
                    'stream_path': args.stream_path,
                    'save_decoded_frame': args.save_decoded_frame,
                    'ds_name': ds_name,
                    'verbose': args.verbose,
                    'verbose_json': args.verbose_json,
                    'device': args.device,
                }
                if args.force_intra:
                    cur['intra_period'] = 1
                if args.force_intra_period > 0:
                    cur['intra_period'] = args.force_intra_period
                if args.force_frame_num > 0:
                    cur['frame_num'] = args.force_frame_num
                count_frames += cur['frame_num']

                bin_folder = os.path.join(cur['stream_path'], ds_name)
                create_folder(bin_folder, True)
                cur['src_path'] = os.path.join(cur['dataset_path'], seq)
                cur['bin_folder'] = bin_folder
                cur['curr_bin_path'] = os.path.join(
                    bin_folder, f"{seq}_q{cur['qp_i']}.bin")
                cur['curr_rec_path'] = \
                    cur['curr_bin_path'].replace('.bin', '.yuv')
                cur['curr_json_path'] = \
                    cur['curr_bin_path'].replace('.bin', '.json')

                jobs.append(cur)

    results = _run_jobs(jobs, args)

    log_result = {}
    for res in results:
        log_result.setdefault(res['ds_name'], {}).setdefault(
            res['seq'], {})[f"{res['rate_idx']:03d}"] = res

    out_dir = os.path.dirname(args.output_path)
    if out_dir:
        create_folder(out_dir, True)
    with open(args.output_path, 'w') as fp:
        dump_json(log_result, fp, float_digits=6, indent=2)

    total_minutes = (time.time() - begin_time) / 60
    print('Test finished')
    print(f'Tested {count_frames} frames from {count_sequences} sequences')
    print(f'Total elapsed time: {total_minutes:.1f} min')


if __name__ == "__main__":
    main()
