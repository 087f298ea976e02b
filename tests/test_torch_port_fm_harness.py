"""The port's DCVC-FM harness (`opendcvc_tpu_torch.eval.fm_harness`)
against the JAX package's (`opendcvc_tpu.eval.fm_harness`), on the CPU.

Two configs: the JAX package's own FM harness test (3 PNG frames at 48x64,
a random image rolled 2 px a frame) and 4 frames of a 64x64 YUV420
sequence (a gradient plus texture shifted 2 px a frame, mild noise), both
at --qp_i 21 --qp_p 21 --reset_interval 2, so frames 1 and 3 are
refreshes (fa_idx 3) and frame 2 takes fa_idx 0.  Both harnesses code with
the JAX package's init_params(0) / (1), saved by its save_params and read
by the port's JAX-free checkpoint reader; the JAX codecs run host EC with
their plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1).  Held:
  * the .bin files are byte-identical, and parse as the FM syntax with
    the expected (qp, fa_idx) per frame and an SPS only when it changes;
  * the RD JSONs have the same keys, frame counts and bits, and bits are
    8 x the .bin's size;
  * PSNR agrees within the bound test_torch_port_harness.py derives from
    the codecs' float agreement; MS-SSIM is 0 in both (these frames are
    below MS-SSIM's 88-pixel minimum, so neither harness computes it);
  * the port's harness with its own --seed weights codes and decodes.
"""

import io
import json

import numpy as np
import pytest
from PIL import Image

from opendcvc_tpu.eval import fm_harness as JH
from opendcvc_tpu.models import dmc_fm as JDMC
from opendcvc_tpu.models import dmci_fm as JDMCI
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.eval import fm_harness as PH
from opendcvc_tpu_torch.utils import stream_helper_fm as SF
from test_torch_port_harness import RGB_GAIN, X_HAT_ATOL, _psnr_tol
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

QP = 21
CONFIGS = {"png": (48, 64, 3), "yuv420": (64, 64, 4)}


def _dataset(root, src_type):
    h, w, n = CONFIGS[src_type]
    data = root / "data"
    rng = np.random.default_rng(0)
    if src_type == "png":
        (data / "seqA").mkdir(parents=True)
        base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for i in range(n):
            Image.fromarray(np.roll(base, i * 2, axis=1)).save(
                data / "seqA" / f"im{i + 1}.png")
    else:
        data.mkdir(parents=True)
        yy, xx = np.mgrid[0:h, 0:w + 2 * n]
        smooth = np.stack([(3 * xx + 2 * yy) % 256, 96 + xx, 200 - 2 * yy],
                          -1)
        tex = rng.integers(0, 48, (h, w + 2 * n, 3))
        with open(data / "seqA.yuv", "wb") as f:
            for t in range(n):
                img = smooth[:, 2 * t:2 * t + w] + tex[:, 2 * t:2 * t + w] \
                    + rng.normal(0, 2.0, (h, w, 3))
                img = np.clip(img, 0, 255).astype(np.uint8)
                f.write(img[:, :, 0].tobytes())
                f.write(np.ascontiguousarray(
                    img[::2, ::2, 1:].transpose(2, 0, 1)).tobytes())
    cfg = root / "config.json"
    cfg.write_text(json.dumps({"root_path": str(root), "test_classes": {
        "tiny": {"test": 1, "base_path": "data", "src_type": src_type,
                 "sequences": {"seqA": {"width": w, "height": h,
                                        "frames": n, "intra_period": -1}}}}}))
    return str(cfg)


def _argv(cfg, root, tag, *extra):
    return ["--test_config", cfg, "--output_path", str(root / f"{tag}.json"),
            "--stream_path", str(root / f"{tag}_bins"), "--rate_num", "1",
            "--qp_i", str(QP), "--qp_p", str(QP), "--reset_interval", "2",
            *extra]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("fm_weights")
    paths = {"i": str(d / "i.msgpack"), "p": str(d / "p.msgpack")}
    JCK.save_params(paths["i"], JDMCI.DMCIFM().init_params(seed=0))
    JCK.save_params(paths["p"], JDMC.DMCFM().init_params(seed=1))
    return paths


def _outputs(root, tag):
    bins = root / f"{tag}_bins" / "tiny"
    return {"bin": (bins / f"seqA_q{QP}.bin").read_bytes(),
            "log": json.loads((bins / f"seqA_q{QP}.json").read_text()),
            "out": json.loads((root / f"{tag}.json").read_text())}


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, weights, tmp_path_factory):
    src_type = request.param
    root = tmp_path_factory.mktemp(f"fm_{src_type}")
    cfg = _dataset(root, src_type)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        JH.main(_argv(cfg, root, "jax", "--model_path_i", weights["i"],
                      "--model_path_p", weights["p"]))
        mp.delenv("OPENDCVC_TPU_FORCE_PY_RANS")
        PH.main(_argv(cfg, root, "port", "--device", "cpu",
                      "--model_path_i", weights["i"],
                      "--model_path_p", weights["p"]))
    return {"src_type": src_type, "jax": _outputs(root, "jax"),
            "port": _outputs(root, "port")}


def test_fm_bin_byte_identical(run):
    assert run["port"]["bin"] == run["jax"]["bin"]


def _records(data, n):
    """(nal type, qp, fa_idx, new SPS) of each frame record."""
    rd, helper, out = io.BytesIO(data), SF.SPSHelper(), []
    for _ in range(n):
        header, new = SF.read_header(rd), False
        while header["nal_type"] == SF.NalType.NAL_SPS:
            helper.add_sps_by_id(SF.read_sps_remaining(rd,
                                                       header["sps_id"]))
            header, new = SF.read_header(rd), True
        sps = helper.get_sps_by_id(header["sps_id"])
        SF.read_ip_remaining(rd)
        out.append((header["nal_type"], sps["qp"], sps["fa_idx"], new))
    assert rd.read() == b""
    return out


def test_fm_bin_syntax(run):
    """I at qp 21; frames 1 and 3 refresh (fa_idx 3, qp 21 + QP_SHIFT[3]);
    frame 2 takes INDEX_MAP[2] = 0; an SPS only where (qp, fa_idx)
    changes."""
    n = CONFIGS[run["src_type"]][2]
    want = [(SF.NalType.NAL_I, QP, 0, True),
            (SF.NalType.NAL_P, QP, 3, True),
            (SF.NalType.NAL_P, QP, 0, False),
            (SF.NalType.NAL_P, QP, 3, False)][:n]
    assert _records(run["port"]["bin"], n) == want


def test_fm_json_layout_and_bits(run):
    j, p = run["jax"], run["port"]
    assert list(p["log"]) == list(j["log"])
    for key in ("frame_pixel_num", "i_frame_num", "p_frame_num",
                "ave_i_frame_bpp", "ave_p_frame_bpp", "ave_all_frame_bpp"):
        assert p["log"][key] == j["log"][key], key
    n = p["log"]["i_frame_num"] + p["log"]["p_frame_num"]
    assert n == CONFIGS[run["src_type"]][2]
    bits = p["log"]["ave_all_frame_bpp"] * n * p["log"]["frame_pixel_num"]
    assert round(bits) == 8 * len(p["bin"])
    jo, po = j["out"]["tiny"]["seqA"]["000"], p["out"]["tiny"]["seqA"]["000"]
    assert list(po) == list(jo)
    assert (po["rate_idx"], po["qp_i"], po["qp_p"]) == (0, QP, QP)


def test_fm_psnr_within_tolerance(run):
    j, p = run["jax"]["log"], run["port"]["log"]
    eps = X_HAT_ATOL * 255 * (RGB_GAIN if run["src_type"] == "png" else 1)
    for key in (k for k in j if "psnr" in k):
        assert np.isfinite(p[key]) and \
            abs(p[key] - j[key]) <= _psnr_tol(j[key], eps), key
    for key in (k for k in j if "msssim" in k):
        assert p[key] == j[key] == 0, key


def test_fm_harness_seed_weights(tmp_path):
    """Without checkpoints: the port's own init (--seed), 2 frames."""
    cfg = _dataset(tmp_path, "yuv420")
    PH.main(_argv(cfg, tmp_path, "seed", "--device", "cpu",
                  "--force_frame_num", "2", "--seed", "5"))
    out = _outputs(tmp_path, "seed")
    log = out["log"]
    assert (log["i_frame_num"], log["p_frame_num"]) == (1, 1)
    assert np.isfinite(log["ave_all_frame_psnr"])
    assert round(log["ave_all_frame_bpp"] * 2 * log["frame_pixel_num"]) \
        == 8 * len(out["bin"])
