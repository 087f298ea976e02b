"""The port's DCVC-FM codecs (DMCIFM + DMCFM, host EC) against the JAX
package's, on the CPU in float32 at FM's full width.

Weights: the JAX package's `init_params(0)` (DMCIFM) and `(1)` (DMCFM),
written by its `save_params` and read by the port's JAX-free checkpoint
reader.  The JAX codecs run their host-EC path (OPENDCVC_TPU_DEVICE_EC
unset) with their plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1).  Frames
come from numpy (default_rng): a texture shifted 2 px a frame plus mild
noise.  Chains: at 64x64 an I-frame and 5 P-frames (the first P-frame
from the I-frame alone, then fa_idx 0 and 1 on the propagated DPB, a
refresh, then fa_idx 2), at 64x128 an I-frame and 3 P-frames (fa_idx 0,
1, 2).  The port's encoder drives the chain; the JAX encoder codes each
frame from the port's DPB, so every frame is its own comparison.

Held on every frame:
  * the port's stream is the JAX package's, byte for byte, or else the
    first plane (in the order the encoder computes them: motion z, the
    four motion passes, z, the four y passes) where the two packages'
    symbols differ differs only where the port's value before rounding
    (z, y's residual, a CDF index before truncation) lies within the
    codecs' float agreement (1e-4 x the plane's max |value|) of its
    rounding boundary; those are printed with their distance to it;
  * the port's decoder reproduces its encoder's DPB exactly (all five
    entries);
  * on the frames whose streams are equal, each package decodes the
    other's stream: the port exactly, the JAX package within 1e-4 x
    max|ref| of the port's encoder (from the port's reference DPB); a
    frame with a tie is printed (the other package reads that symbol's
    CDF row or value the other way, and the rest of the frame decodes
    from another rANS state);
  * with stream_part 2 and 3 (the N-part split) the same, and the
    streams parse as 2- and 3-part streams;
  * the weights cross leaf for leaf (grouped fusion conv, the
    feature_adaptor list, the quant anchors, both bit estimators), and
    the port's own init draws a tree of the JAX package's layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.models import dmc_fm as JDMC
from opendcvc_tpu.models import dmci_fm as JDMCI
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.models import dmc_fm as PDMC
from opendcvc_tpu_torch.models import dmci_fm as PDMCI
from opendcvc_tpu_torch.eval import fm_ties as TIES
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

QP = 21
# (fa_idx, refresh before the frame, qp) of each P-frame
CHAINS = {(64, 64): [(0, False, 21), (0, False, 21), (1, False, 29),
                     (2, True, 25), (2, False, 21)],
          (64, 128): [(0, False, 21), (1, False, 29), (2, False, 25)]}
DPB_KEYS = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y",
            "ref_mv_y")
# the codecs' float agreement (test_torch_port_codec, _host_ec)
REL_TOL = TIES.REL_TOL


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's init_params(0) / (1) and their save_params
    files."""
    d = tmp_path_factory.mktemp("fm_weights")
    trees = {"i": JDMCI.DMCIFM().init_params(seed=0),
             "p": JDMC.DMCFM().init_params(seed=1)}
    paths = {k: str(d / f"{k}.msgpack") for k in trees}
    for k, tree in trees.items():
        JCK.save_params(paths[k], tree)
    return {"trees": trees, "paths": paths}


def _jax_codec(cls, tree, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = cls(**kw)
        net.load_params(tree)
        net.update()
    assert not net.device_ec
    return net


def _port_codec(cls, path, **kw):
    net = cls(device="cpu", **kw)
    net.load_params(from_jax(PCK.load_params(path)))
    net.update()
    return net


def _frames(h, w, n):
    rng = np.random.default_rng(w)
    tex = rng.random((1, h, w + 2 * n + 2, 3), dtype=np.float32)
    return [np.clip(tex[:, :, 2 * t:2 * t + w]
                    + rng.normal(0, 0.02, (1, h, w, 3)).astype(np.float32),
                    0, 1) for t in range(n + 1)]


def _np(dpb):
    """A DPB as NHWC numpy: the port's frame is NHWC, its other entries
    NCHW; the JAX package's are all NHWC."""
    out = {}
    for k in DPB_KEYS:
        v = dpb[k]
        if isinstance(v, torch.Tensor):
            v = (v if k == "ref_frame" else v.permute(0, 2, 3, 1)).numpy()
        out[k] = None if v is None else np.asarray(v)
    return out


def _to_jax(dpb):
    return {k: None if v is None else jnp.asarray(v)
            for k, v in _np(dpb).items()}


def _fresh(frame):
    return {"ref_frame": frame, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


def _run_chain(weights, h, w, spec, stream_part=1):
    """Code the chain with the port's encoder, each frame also with the
    JAX package's from the port's DPB; decode the port's streams with both
    packages and the JAX package's with the port where they are equal."""
    paths, trees = weights["paths"], weights["trees"]
    xs = _frames(h, w, len(spec))
    ji = _jax_codec(JDMCI.DMCIFM, trees["i"])
    pi = _port_codec(PDMCI.DMCIFM, paths["i"])
    kw = {"stream_part": stream_part}
    jp_enc = _jax_codec(JDMC.DMCFM, trees["p"], **kw)
    jp_dec = _jax_codec(JDMC.DMCFM, trees["p"], **kw)
    pp_enc = _port_codec(PDMC.DMCFM, paths["p"], **kw)
    pp_dec = _port_codec(PDMC.DMCFM, paths["p"], **kw)
    pp_dec_jax = _port_codec(PDMC.DMCFM, paths["p"], **kw)
    coded = {"port": [], "jax": []}
    for port_net, jax_net in ((pi, ji), (pp_enc, jp_enc)):
        TIES.record_coded(port_net, coded["port"])
        TIES.record_coded(jax_net, coded["jax"])

    def explain(jax_stream, port_stream, floats, kind):
        ties = None
        if jax_stream != port_stream:
            ties = TIES.first_differing_plane(coded["port"], coded["jax"],
                                              floats.take(kind), kind)
        else:
            floats.take(kind)
        coded["port"].clear()
        coded["jax"].clear()
        return ties

    sps = {"height": h, "width": w, "qp": QP}
    with TIES.PreRoundingFloats() as floats:
        floats.on = True
        pe = pi.compress(xs[0], QP)
        floats.on = False
        je = ji.compress(jnp.asarray(xs[0]), QP)
        ps, js = pe["bit_stream"], je["bit_stream"]
        ties = explain(js, ps, floats, "i")
        out = {"jax_stream": [js], "port_stream": [ps], "ties": [ties],
               "port_enc": [_np(_fresh(pe["x_hat"]))],
               "jax_enc": [_np(_fresh(je["x_hat"]))],
               "port_dec": [_np(_fresh(pi.decompress(ps, sps)["x_hat"]))],
               "jax_dec": [_np(_fresh(ji.decompress(ps, sps)["x_hat"]))],
               "port_dec_jax": [None if ties else _np(_fresh(
                   pi.decompress(js, sps)["x_hat"]))]}
        enc_dpb = dec_dpb = _fresh(pe["x_hat"])
        for (fa, refresh, qp), x in zip(spec, xs[1:]):
            if refresh:
                enc_dpb, dec_dpb = _fresh(enc_dpb["ref_frame"]), \
                    _fresh(dec_dpb["ref_frame"])
            sps = {"height": h, "width": w, "qp": qp, "fa_idx": fa}
            ref_jax = _to_jax(enc_dpb)
            floats.on = True
            po = pp_enc.compress(x, enc_dpb, qp, fa)
            floats.on = False
            jo = jp_enc.compress(jnp.asarray(x), ref_jax, qp, fa)
            ties = explain(jo["bit_stream"], po["bit_stream"], floats, "p")
            out["ties"].append(ties)
            out["port_stream"].append(po["bit_stream"])
            out["jax_stream"].append(jo["bit_stream"])
            out["port_enc"].append(_np(po["dpb"]))
            out["jax_enc"].append(_np(jo["dpb"]))
            out["jax_dec"].append(_np(jp_dec.decompress(
                po["bit_stream"], ref_jax, sps)["dpb"]))
            out["port_dec_jax"].append(
                None if ties else _np(pp_dec_jax.decompress(
                    jo["bit_stream"], enc_dpb, sps)["dpb"]))
            dec_dpb = pp_dec.decompress(po["bit_stream"], dec_dpb,
                                        sps)["dpb"]
            out["port_dec"].append(_np(dec_dpb))
            enc_dpb = po["dpb"]
    return out


@pytest.fixture(scope="module", params=list(CHAINS),
                ids=[f"{h}x{w}" for h, w in CHAINS])
def run(request, weights):
    h, w = request.param
    return _run_chain(weights, h, w, CHAINS[request.param])


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=REL_TOL * float(np.abs(ref).max()),
                               err_msg=what)


def _keys(t):
    """Frame 0 is the I-frame: its x_hat alone."""
    return DPB_KEYS if t else ("ref_frame",)


def _check_streams(r):
    """Frame 0 is the I-frame."""
    for t, ties in enumerate(r["ties"]):
        if ties is None:
            assert r["port_stream"][t] == r["jax_stream"][t]
            continue
        plane, rows = ties
        assert rows, f"frame {t}: streams differ, every plane equal"
        for kind, i, value, dist, tol in rows:
            print(f"frame {t}: {plane} {kind} {i} differs; the port's "
                  f"value {value:.9g} lies {dist:.3g} from its rounding "
                  f"boundary (float agreement {tol:.3g})")
            assert dist <= tol, (t, plane, kind, i, dist, tol)


def test_fm_streams_match_jax(run):
    _check_streams(run)


def test_fm_port_decoder_exact(run):
    for t, (enc, dec) in enumerate(zip(run["port_enc"], run["port_dec"])):
        for k in _keys(t):
            np.testing.assert_array_equal(dec[k], enc[k],
                                          err_msg=f"frame {t} {k}")


def _check_cross_decode(r, label=""):
    """On the frames whose streams are equal: a tie read the other way
    changes that symbol's CDF row, and the rest of the frame then decodes
    from another rANS state."""
    for t in range(len(r["port_enc"])):
        if r["ties"][t] is not None:
            print(f"frame {t}{label}: a boundary tie; the packages do not "
                  f"decode each other's stream of this frame")
            continue
        for k in _keys(t):
            _close(r["jax_dec"][t][k], r["port_enc"][t][k],
                   f"JAX on the port's stream{label}, frame {t} {k}")
            np.testing.assert_array_equal(r["port_dec_jax"][t][k],
                                          r["port_enc"][t][k],
                                          err_msg=f"frame {t} {k}")


def test_fm_each_side_decodes_the_others_streams(run):
    _check_cross_decode(run)


def test_fm_encoder_dpb_close_to_jax(run):
    """On the frames whose streams are equal (a tied symbol moves the
    reconstruction by a quantization step)."""
    for t in range(len(run["port_enc"])):
        if run["ties"][t] is not None:
            continue
        for k in _keys(t):
            _close(run["port_enc"][t][k], run["jax_enc"][t][k],
                   f"frame {t} {k}")


@pytest.mark.parametrize("parts", [2, 3])
def test_fm_nparts_streams_match_jax(weights, parts):
    """The first three frames of the 64x64 chain with the N-part split."""
    r = _run_chain(weights, 64, 64, CHAINS[(64, 64)][:2], stream_part=parts)
    _check_streams(r)
    _check_cross_decode(r, f" ({parts} parts)")
    for t in range(1, len(r["port_enc"])):
        assert (r["port_stream"][t][0] >> 4) + 1 == parts
        for k in DPB_KEYS:
            np.testing.assert_array_equal(r["port_dec"][t][k],
                                          r["port_enc"][t][k])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("codec", ["i", "p"])
def test_fm_weights_cross_exactly(weights, codec):
    tree = weights["trees"][codec]
    port = from_jax(PCK.load_params(weights["paths"][codec]))
    if codec == "p":
        assert port["align"]["fusion"]["w"].shape == (48, 6, 1, 1)
        assert len(port["feature_adaptor"]) == 3
        for name in ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec"):
            assert port[name].tolist() == [0.5, 2.0]
    want = dict(_leaves(tree))
    got = dict(_leaves(to_jax(port)))
    assert list(got) == list(want)
    for name, a in want.items():
        assert got[name].dtype == a.dtype, name
        np.testing.assert_array_equal(got[name], a, err_msg=name)


@pytest.mark.parametrize("codec", ["i", "p"])
def test_fm_port_init_has_jax_layout(weights, codec):
    """The port's own init: a tree of the JAX package's keys, shapes and
    dtypes (its own draws), the anchors apart at [0.5, 2.0]."""
    net = (PDMCI.DMCIFM if codec == "i" else PDMC.DMCFM)(device="cpu")
    port = to_jax(net.init_params(seed=3))
    want = {k: (v.shape, v.dtype)
            for k, v in _leaves(weights["trees"][codec])}
    assert {k: (v.shape, v.dtype) for k, v in _leaves(port)} == want
    if codec == "p":
        assert port["y_q_dec"].tolist() == [0.5, 2.0]
