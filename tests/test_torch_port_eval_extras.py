"""The port's evaluation extras (`eval/rd_evidence.py`,
`eval/published_results.py`, `eval/complexity.py`, `eval/profiler.py`)
and reference precompute (`training/preprocessing.py`) against the JAX
package's, on the CPU.

Held exactly:
  * `measure` on the committed trained DMCI (`docs/dmci_tiny_rd.msgpack`,
    TINY_KW; qps 20 and 40, 128 px, 2 images, host EC): every point's
    bpp_stream (the same bytes) equal to the JAX package's; bpp_estimate
    within EST_RTOL relative (the forwards' float agreement,
    tests/test_torch_port_training.py's FWD_RTOL); PSNR within the bound
    a move of every sample by X_HAT_ATOL gives (the harness tests' bound,
    in units of the data range 1); the JAX package's own gate
    (tests/test_rate_consistency.py): stream / estimate in (0.97, 1.03)
    and qp 20's bpp above 1.2 x qp 40's.  With OPENDCVC_TPU_DEVICE_EC set,
    the port's device-EC codec (the kernels' plain versions here) gives
    the same estimate and PSNR and a longer stream: the device-EC
    container's lane headers (4-5x the estimate at 128 px when this test
    was written), so the JAX gate is a host-EC gate;
  * `precompute_references` on a Vimeo-layout tree of three 64x96 PNGs
    with that checkpoint at qp 20: the port's device-EC codec writes the
    host-EC PNGs; those equal the JAX package's but for at most
    TIE_VALUES values a PNG, each one code value off where the port's
    float x_hat x 255 lies within 255 x X_HAT_ATOL of a rounding boundary
    (the packages' x_hat agree within X_HAT_ATOL; when this test was
    written at most one value of a PNG's 18432 was off, in one or two of
    the three PNGs as the thread count changed the sums);
  * `bd_rate` and the published tables equal; `count_params` of the JAX
    DMCI at TINY_KW equal.
Stated: `flops_of` counts matrix products and convolutions only, XLA's
cost analysis elementwise operations too, so the port's count of DMCI's
encoder front at TINY_KW and 64x64 lies in FLOPS_RATIO of the JAX
package's (measured 0.979 when this test was written).  Smoke:
`measure_dmc` at 64 px on the port's random DMC (host EC, then device
EC) gives finite points and a decoder equal to the encoder;
`train_tiny` and `train_tiny_dmc` train 2 steps and save checkpoints the
JAX package reads; the CLI writes its JSON with --device cpu and refuses
to run without CUDA otherwise; `profile_dmc` at 64x64 returns the JAX
profiler's stage names; `report_dmci` the JAX report's keys.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from opendcvc_tpu.eval import complexity as JX
from opendcvc_tpu.eval import published_results as JPUB
from opendcvc_tpu.eval import rd_evidence as JR
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu.training import preprocessing as JPRE
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.eval import complexity as PX
from opendcvc_tpu_torch.eval import profiler as PPROF
from opendcvc_tpu_torch.eval import published_results as PPUB
from opendcvc_tpu_torch.eval import rd_evidence as PR
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.models.dmc import dmc_init
from opendcvc_tpu_torch.training import preprocessing as PPRE
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
TINY_CKPT = os.path.join(ROOT, "docs", "dmci_tiny_rd.msgpack")
QPS = (20, 40)
EST_RTOL = 1e-4
X_HAT_ATOL = 1e-4
FLOPS_RATIO = (0.9, 1.0)
TIE_VALUES = 4


def _psnr_tol(psnr, eps=X_HAT_ATOL):
    """Largest PSNR change when every sample (data range 1) moves by at
    most eps: the MSE moves by at most 2 eps rmse + eps^2."""
    rmse = 10 ** (-psnr / 20)
    return -10 * math.log10(1 - (2 * eps * rmse + eps * eps) / rmse ** 2)


@pytest.fixture
def host_ec_env(monkeypatch):
    """Host EC in both packages; the JAX package's plain coder, so its
    shared native build never starts."""
    monkeypatch.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
    monkeypatch.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")


def _gate(points):
    for p in points:
        assert 0.97 < p["stream_vs_estimate"] < 1.03, p
    assert points[0]["bpp_stream"] > points[-1]["bpp_stream"] * 1.2


def test_measure_matches_jax(host_ec_env, monkeypatch):
    want = JR.measure(TINY_CKPT, qps=QPS, size=128, n_images=2)
    got = PR.measure(TINY_CKPT, qps=QPS, size=128, n_images=2,
                     device="cpu")
    for g, w in zip(got, want):
        print(f"qp {w['qp']}: port {g}, JAX {w}")
        assert g["qp"] == w["qp"] and g["bpp_stream"] == w["bpp_stream"]
        assert abs(g["bpp_estimate"] - w["bpp_estimate"]) <= \
            EST_RTOL * w["bpp_estimate"]
        assert abs(g["psnr"] - w["psnr"]) <= _psnr_tol(w["psnr"])
    _gate(got)
    monkeypatch.setenv("OPENDCVC_TPU_DEVICE_EC", "1")
    dev = PR.measure(TINY_CKPT, qps=QPS, size=128, n_images=2,
                     device="cpu")
    for d, g in zip(dev, got):
        print(f"qp {d['qp']}: device EC {d}")
        assert d["bpp_estimate"] == g["bpp_estimate"]
        assert d["psnr"] == g["psnr"]
        assert d["bpp_stream"] > g["bpp_stream"]


def _vimeo_tree(root, names, h=64, w=96):
    from PIL import Image
    from opendcvc_tpu_torch.training.syndata import natural_images
    imgs = natural_images(len(names), h, seed=12, width=w)
    for name, img in zip(names, imgs):
        d = os.path.join(root, "sequences", name)
        os.makedirs(d)
        Image.fromarray(np.round(img[0] * 255).astype(np.uint8)).save(
            os.path.join(d, "im1.png"))
    lst = os.path.join(root, "sep_trainlist.txt")
    with open(lst, "w") as f:
        f.write("\n".join(names) + "\n")
    return lst


def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path))


def test_precompute_references_matches_jax(host_ec_env, tmp_path):
    names = ["00001/0001", "00001/0002", "00002/0003"]
    lst = _vimeo_tree(str(tmp_path), names)
    jnet = JDMCI.DMCI(**JR.TINY_KW)
    jnet.load_params(JCK.load_params(TINY_CKPT))
    jnet.update()
    assert JPRE.precompute_references(str(tmp_path), lst, jnet, 20,
                                      "ref_jax") == 3
    nets = {}
    for name, device_ec in (("ref_host", False), ("ref_dev", True)):
        net = PDMCI.DMCI(device="cpu", device_ec=device_ec, **PR.TINY_KW)
        net.load_params(from_jax(PCK.load_params(TINY_CKPT)))
        net.update()
        nets[name] = net
        assert PPRE.precompute_references(str(tmp_path), lst, net, 20,
                                          name) == 3
    for seq in names:
        d = os.path.join(str(tmp_path), "sequences", seq)
        want = _png(os.path.join(d, "ref_jax.png")).astype(int)
        host = _png(os.path.join(d, "ref_host.png")).astype(int)
        assert want.shape == (64, 96, 3)
        assert np.array_equal(_png(os.path.join(d, "ref_dev.png")), host)
        off = np.argwhere(host != want)
        print(f"{seq}: {len(off)} values off by one from the JAX PNG")
        assert len(off) <= TIE_VALUES and np.abs(host - want).max() <= 1
        if len(off):
            img = _png(os.path.join(d, "im1.png")).astype(np.float32) / 255
            x = np.pad(img[None], ((0, 0), (0, 0), (0, 32), (0, 0)),
                       mode="edge")
            v = nets["ref_host"].compress(x, 20)["x_hat"][0].numpy() * 255
            for y, xx, c in off:
                frac = v[y, xx, c] - np.floor(v[y, xx, c])
                assert abs(frac - 0.5) <= 255 * X_HAT_ATOL, (y, xx, c)


def test_published_results_and_bd_rate():
    assert PPUB.EVC_KODAK == JPUB.EVC_KODAK
    assert PPUB.DCVC_RT == JPUB.DCVC_RT
    assert PPUB.PROTOCOL == JPUB.PROTOCOL
    a, b = PPUB.EVC_KODAK["EncL_DecL"], PPUB.EVC_KODAK["EncS_DecS"]
    for args in ((a["bpp"], a["psnr"], b["bpp"], b["psnr"]),
                 (b["bpp"], b["psnr"], a["bpp"], a["psnr"]),
                 (a["bpp"], a["psnr"], a["bpp"], a["psnr"])):
        got, want = PPUB.bd_rate(*args), JPUB.bd_rate(*args)
        assert got == want
    assert PPUB.bd_rate(a["bpp"], a["psnr"], b["bpp"], b["psnr"]) > 0


@pytest.fixture(scope="module")
def tiny_jax_tree():
    return JCK.load_params(TINY_CKPT)


def test_count_params_matches_jax(tiny_jax_tree):
    assert PX.count_params(from_jax(tiny_jax_tree)) == \
        JX.count_params(tiny_jax_tree)


def test_flops_of_within_stated_ratio(tiny_jax_tree):
    x = np.random.default_rng(2).random((1, 64, 64, 3), np.float32)
    want = JX.flops_of(JDMCI._stage_enc_front, tiny_jax_tree,
                       jnp.asarray(x), jnp.int32(32))
    got = PX.flops_of(PDMCI._stage_enc_front, from_jax(tiny_jax_tree),
                      torch.from_numpy(x).permute(0, 3, 1, 2), 32)
    ratio = got / want
    print(f"encoder front at 64x64: port {got:.0f}, JAX {want:.0f} "
          f"FLOPs, ratio {ratio:.4f}")
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1]


def test_report_dmci_keys():
    rep = PX.report_dmci(64, 64, device="cpu")
    assert list(rep) == ["model", "input", "params", "enc_front_flops",
                         "enc_front_gmacs"]
    assert rep["input"] == "64x64" and rep["enc_front_flops"] > 0
    assert rep["enc_front_gmacs"] == rep["enc_front_flops"] / 2e9


def test_profile_dmc_returns_jax_stage_names(tmp_path):
    with open(os.path.join(ROOT, "opendcvc_tpu", "eval",
                           "profiler.py")) as f:
        names = set(re.findall(r'results\["([^"]+)"\]', f.read()))
    assert len(names) == 11
    res = PPROF.profile_dmc(64, 64, iters=1, device="cpu",
                            trace_dir=str(tmp_path / "trace"))
    assert set(res) == names
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    assert os.path.exists(str(tmp_path / "trace" / "dmc_stages.json"))
    PPROF.print_table(res)


@pytest.mark.parametrize("device_ec", [False, True],
                         ids=["host_ec", "device_ec"])
def test_measure_dmc_decodes_exactly(tmp_path, monkeypatch, device_ec):
    monkeypatch.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
    if device_ec:
        monkeypatch.setenv("OPENDCVC_TPU_DEVICE_EC", "1")
    path = str(tmp_path / "dmc.msgpack")
    PCK.save_params(path, dmc_init(torch.Generator().manual_seed(1)))
    points = PR.measure_dmc(path, qps=QPS, size=64, n_pairs=2, device="cpu")
    for p in points:
        assert p["decoder_exact"], p
        assert all(np.isfinite(p[k]) for k in
                   ("bpp_stream", "bpp_estimate", "stream_vs_estimate",
                    "psnr")), p
        assert p["bpp_stream"] > 0


def test_train_tiny_saves_checkpoints_jax_reads(tmp_path):
    out = str(tmp_path / "tiny.msgpack")
    PR.train_tiny(out, steps=2, crop=64, batch=2, log_every=1,
                  device="cpu")
    payload = JCK.load_checkpoint(out)
    assert int(payload["extra"]["steps"]) == 2
    assert {k: int(v) for k, v in payload["extra"]["model_kwargs"]
            .items()} == JR.TINY_KW
    assert jax.tree_util.tree_structure(payload["params"]) == \
        jax.tree_util.tree_structure(JCK.load_params(TINY_CKPT))
    out_p = str(tmp_path / "dmc.msgpack")
    PR.train_tiny_dmc(out_p, steps=2, crop=32, batch=1, log_every=1,
                      device="cpu")
    assert int(JCK.load_checkpoint(out_p)["extra"]["steps"]) == 2


def test_rd_evidence_cli(tmp_path, host_ec_env):
    out = str(tmp_path / "rd.json")
    PR.main(["--ckpt", TINY_CKPT, "--out", out, "--qps", "20", "40",
             "--size", "64", "--device", "cpu"])
    with open(out) as f:
        payload = json.load(f)
    assert [p["qp"] for p in payload["points"]] == [20, 40]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PR.main(["--ckpt", TINY_CKPT, "--out", out])
