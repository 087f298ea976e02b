"""The port's EVC (`models/evc.py`: the eight width classes and
ScalableEVC) against the JAX package's, on the CPU.

Weights: the JAX package's own init (seed 0; ScalableEVC with enc_num 2,
seed 3) carried across with `from_jax`.  The JAX codecs code on the host
with their plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1 during update()).
Images: uniform noise from numpy's default_rng at 64x64 and 64x128.

Held:
  * the port's init: the JAX tree's keys and shapes for every width class
    and ScalableEVC (float32 leaves cast to the codec's dtype by EVC,
    kept float32 by ScalableEVC, as in the JAX package);
  * every stage function on the same inputs: integers (the rounded z)
    and `_curr_q` exact, floats within STAGE_RTOL x max|ref| (XLA:CPU
    and ATen sum convolutions in their own orders);
  * float32 streams of EVC_LL, EVC_SS, EVC_MS and ScalableEVC at rates 0
    and 1, at both sizes: byte-equal to the JAX package's (or else a tie
    by `eval/fm_ties.py`'s rule, printed), the port's decoder exact, and
    each package decoding the other's stream: the port exactly, JAX
    within REL_TOL x max|ref|;
  * bfloat16 (EVC_LL and EVC_SS): the port's decoder exact; against the
    JAX bfloat16 codec, the share of equal symbols per plane >=
    SYMBOL_SHARE (the other port tests' bound) and the share of x_hat
    values within XHAT_RTOL x max|ref| of JAX's >= XHAT_SHARE (the HEM
    and TCM tests' raw-reference bound: a symbol that differs moves its
    neighbourhood);
  * the JAX-package fault of ROADMAP Queue 3: with q_basic from U(0.6,
    3.0) and q_scale 0.37 the JAX bfloat16 decoder's rate multiplier
    differs from its encoder's and its x_hat from the encoder's, while
    the port's decoder is exact;
  * a bfloat16 ScalableEVC keeps float32 parameters: its y and x_hat are
    float32 (as the JAX encoder's), its stream's symbols within
    SYMBOL_SHARE of JAX's, the port's decoder exact where the JAX
    decoder (which computes y in bfloat16) is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.models import evc as JE
from opendcvc_tpu_torch.eval import fm_ties as TIES
from opendcvc_tpu_torch.models import evc as PE
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

BF = torch.bfloat16
STAGE_RTOL = 1e-4
REL_TOL = TIES.REL_TOL
SYMBOL_SHARE = 0.9
XHAT_SHARE = 0.9
XHAT_RTOL = 2.0 ** -4
SIZES = [(64, 64), (64, 128)]
Q = 0.37


def _nchw(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(jnp.asarray(a, jnp.float32))
                                  .transpose(0, 3, 1, 2), order="C"))
    return t if dtype is None else t.to(dtype)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _x(t):
    """An NHWC frame tensor as float32 numpy."""
    return t.float().numpy()


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _close(got, want, rtol, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _share_close(got, want):
    """The share of got's values within XHAT_RTOL x max|want| of want's,
    printed and held to XHAT_SHARE."""
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want) \
        / float(np.abs(want).max())
    share = float((err <= XHAT_RTOL).mean())
    print(f"x_hat: max {err.max():.4g} x max|ref|, {share:.5f} within "
          f"{XHAT_RTOL}")
    assert share >= XHAT_SHARE, share


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


#: codec name -> (class name, constructor kwargs, init seed)
CODECS = {"EVC_LL": ("EVC_LL", {}, 0), "EVC_SS": ("EVC_SS", {}, 0),
          "EVC_MS": ("EVC_MS", {}, 0),
          "ScalableEVC": ("ScalableEVC", {"enc_num": 2}, 3)}


@pytest.fixture(scope="module")
def trees():
    return {name: getattr(JE, cls)(**kw).init_params(seed=seed)
            for name, (cls, kw, seed) in CODECS.items()}


def _jax_codec(name, tree, **kw):
    cls, ckw, _ = CODECS[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = getattr(JE, cls)(**ckw, **kw)
        net.load_params(tree)
        net.update()
    return net


def _port_codec(name, tree, **kw):
    cls, ckw, _ = CODECS[name]
    net = getattr(PE, cls)(device="cpu", **ckw, **kw)
    net.load_params(from_jax(tree))
    net.update()
    return net


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["EVC_LL", "EVC_LM", "EVC_LS", "EVC_ML",
                                 "EVC_SL", "EVC_MM", "EVC_MS", "EVC_SS"])
def test_width_class_init_has_the_jax_layout(cls):
    jnet = getattr(JE, cls)()
    want = jax.eval_shape(lambda: JE.evc_init(
        jax.random.PRNGKey(0), jnet.N, jnet.enc_width, jnet.dec_width,
        jnet.anchor_num))
    net = getattr(PE, cls)(device="cpu", dtype=BF)
    assert (net.enc_width, net.dec_width) == (jnet.enc_width,
                                             jnet.dec_width)
    tree = to_jax(net.init_params(seed=1))
    assert _shapes(tree) == _shapes(want)
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(tree)} == \
        {"bfloat16"}


def test_scalable_init_has_the_jax_layout_and_stays_float32(trees):
    net = PE.ScalableEVC(device="cpu", enc_num=2, dtype=BF)
    tree = to_jax(net.init_params(seed=1))
    assert _shapes(tree) == _shapes(trees["ScalableEVC"])
    assert {a.dtype for a in jax.tree_util.tree_leaves(tree)} == \
        {np.dtype(np.float32)}
    assert PE.Scale_EVC_SS is PE.Scale_EVC_SL is PE.ScalableEVC
    assert PE.ENC_DEC_CHANNELS == JE.ENC_DEC_CHANNELS


def test_codec_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PE.EVC_LL()


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _stage_cases(trees):
    """(port call, JAX call, integer output positions) of every stage
    function, on NHWC numpy inputs."""
    jp, js = trees["EVC_LL"], trees["ScalableEVC"]
    pp, ps = from_jax(jp), from_jax(js)
    N = 192
    x = _rand(1, (1, 64, 64, 3), 0, 1)
    z = np.round(_rand(2, (1, 1, 1, N), -4, 4))
    y0 = np.round(_rand(3, (1, 4, 4, N), -3, 3))
    y1 = np.round(_rand(4, (1, 4, 4, N), -3, 3))
    means = _rand(5, (1, 4, 4, N), -2, 2)
    scales = _rand(6, (1, 4, 4, N), 0.01, 30)
    q_step = _rand(7, (1, 4, 4, N), 0.5, 2)
    qs = np.asarray(Q, np.float32)
    P, J = _nchw, jnp.asarray
    jfront = _jax_codec("ScalableEVC", js)
    jfront.set_rate(1)
    pfront = _port_codec("ScalableEVC", js)
    pfront.set_rate(1)
    return {
        "enc_front": (lambda: PE._stage_enc_front(pp, P(x), Q),
                      lambda: JE._stage_enc_front(jp, J(x), qs), (2,)),
        "scalable_enc_front": (
            lambda: pfront._enc_front(P(x), Q),
            lambda: jfront._enc_front_for_rate(1)(js, J(x), J(qs)), (2,)),
        "prior": (lambda: PE._stage_prior(pp, P(z)),
                  lambda: JE._stage_prior(jp, J(z)), ()),
        "spatial": (lambda: PE._stage_spatial(pp, P(y0), P(means),
                                              P(scales), P(q_step)),
                    lambda: JE._stage_spatial(jp, J(y0), J(means),
                                              J(scales), J(q_step)), ()),
        "recon": (lambda: (PE._stage_recon(pp, P(y0), P(y1), P(q_step),
                                           Q),),
                  lambda: (JE._stage_recon(jp, J(y0), J(y1), J(q_step),
                                           qs),), ()),
    }


STAGES = ["enc_front", "scalable_enc_front", "prior", "spatial", "recon"]


@pytest.fixture(scope="module")
def stage_cases(trees):
    return _stage_cases(trees)


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_jax(stage_cases, name):
    port_fn, jax_fn, ints = stage_cases[name]
    with torch.no_grad():
        got = port_fn()
    want = jax_fn()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.permute(0, 2, 3, 1)
        assert g.shape == w.shape, (name, i)
        if i in ints:
            assert g.numpy().dtype == w.dtype, (name, i)
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{name} {i}")
        else:
            _close(g.float().numpy(), w, STAGE_RTOL, f"{name} {i}")


def test_curr_q_and_cfg_equal_jax(trees):
    """The float32 product, then the cast, as the JAX encoder forms it;
    on spread q_basic too."""
    jp = dict(trees["EVC_SS"])
    jp["q_basic"] = jnp.asarray(_rand(8, (192,), 0.3, 3.0))
    pp = from_jax(jp)
    for dt, jdt in ((torch.float32, jnp.float32), (BF, jnp.bfloat16)):
        for q in (1.0, Q, 1.7):
            want = JE._curr_q(jp, np.asarray(q, np.float32), jdt)
            got = PE._curr_q(pp, q, dt)
            assert got.dtype == dt and got.shape == (1, 192, 1, 1)
            np.testing.assert_array_equal(got.float().numpy().reshape(-1),
                                          _np(want).reshape(-1))
    ge = PE.EVC_SS(device="cpu").gaussian_encoder
    assert PE._fold_index_cfg(ge) == JE._fold_index_cfg(
        JE.EVC_SS().gaussian_encoder)


# ---------------------------------------------------------------------------
# float32 streams
# ---------------------------------------------------------------------------

STREAM_CASES = [("EVC_LL", None), ("EVC_SS", None), ("EVC_MS", None),
                ("ScalableEVC", 0), ("ScalableEVC", 1)]


@pytest.fixture(scope="module")
def codecs(trees):
    """name -> (JAX encoder, JAX decoder, port encoder, port decoder)."""
    return {name: (_jax_codec(name, t), _jax_codec(name, t),
                   _port_codec(name, t), _port_codec(name, t))
            for name, t in trees.items()}


def _image(h, w, seed=10):
    return np.random.default_rng(seed + h + w).random((1, h, w, 3),
                                                      dtype=np.float32)


@pytest.mark.parametrize("hw", SIZES, ids=["64x64", "64x128"])
@pytest.mark.parametrize("name,rate", STREAM_CASES,
                         ids=["LL", "SS", "MS", "scalable_r0",
                              "scalable_r1"])
def test_float32_stream_matches_jax(codecs, name, rate, hw):
    je, jd, pe, pd = codecs[name]
    if rate is not None:
        je.set_rate(rate)
        pe.set_rate(rate)
    h, w = hw
    x = _image(h, w)
    coded = {"port": [], "jax": []}
    TIES.record_coded(pe, coded["port"])
    TIES.record_coded(je, coded["jax"])
    with TIES.PreRoundingFloats() as floats:
        floats.on = True
        po = pe.compress(x, Q)
        floats.on = False
        jo = je.compress(jnp.asarray(x), Q)
        tie = None
        if jo["bit_stream"] != po["bit_stream"]:
            tie = TIES.first_differing_plane(coded["port"], coded["jax"],
                                             floats.take("evc"), "evc")
        else:
            floats.take("evc")
    for net in (pe, je):
        del net.gaussian_encoder.encode_y_packed
        del net.bit_estimator_z.encode_z
    d = pd.decompress(po["bit_stream"], h, w, Q)
    assert torch.equal(d["x_hat"], po["x_hat"])
    assert d["x_hat"].dtype == torch.float32
    ref = _x(po["x_hat"])
    jdo = jd.decompress(po["bit_stream"], h, w, Q)
    np.testing.assert_allclose(_np(jdo["x_hat"]), ref, rtol=0,
                               atol=REL_TOL * float(np.abs(ref).max()))
    _close(_x(po["x_hat"]), _np(jo["x_hat"]), REL_TOL, "x_hat")
    if tie is None:
        pdo = pd.decompress(jo["bit_stream"], h, w, Q)
        np.testing.assert_array_equal(_x(pdo["x_hat"]), ref)
        return
    plane, rows = tie
    assert rows, "streams differ, every plane equal"
    for kind, i, value, dist, tol in rows:
        print(f"{name} {hw}: {plane} {kind} {i} differs; the port's value "
              f"{value:.9g} lies {dist:.3g} from its rounding boundary "
              f"(float agreement {tol:.3g})")
        assert dist <= tol, (plane, kind, i, dist, tol)


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

def _symbols(planes):
    return [p.astype(np.int32) >> 8 if p.dtype == np.int16 else
            p.astype(np.int32) for p in planes]


def _bf16_pair(tree, name, x, q):
    """The port's and the JAX package's bfloat16 codecs of `name` on
    `tree` code x at q: (shares of equal symbols per plane, port encoder
    output, port decoder output, JAX encoder output, JAX decoder
    output)."""
    h, w = x.shape[1:3]
    pe, pd = (_port_codec(name, tree, dtype=BF) for _ in range(2))
    je, jd = (_jax_codec(name, tree, dtype=jnp.bfloat16) for _ in range(2))
    if name == "ScalableEVC":
        pe.set_rate(1)
        je.set_rate(1)
    coded = {"port": [], "jax": []}
    TIES.record_coded(pe, coded["port"])
    TIES.record_coded(je, coded["jax"])
    po = pe.compress(x, q)
    jo = je.compress(x, q)
    shares = {n: float((a == b).mean()) for n, a, b in zip(
        TIES.PLANES["evc"][1], _symbols(coded["port"]),
        _symbols(coded["jax"]))}
    return (shares, po, pd.decompress(po["bit_stream"], h, w, q), jo,
            jd.decompress(jo["bit_stream"], h, w, q))


@pytest.mark.parametrize("name", ["EVC_LL", "EVC_SS"])
def test_bf16_decoder_exact_and_close_to_jax(trees, name):
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                  trees[name])
    shares, po, pdo, jo, _ = _bf16_pair(tree, name, _image(64, 64), Q)
    assert po["x_hat"].dtype == BF
    assert torch.equal(pdo["x_hat"], po["x_hat"])
    print(f"{name} bfloat16: equal symbols {shares}")
    for plane, share in shares.items():
        assert share >= SYMBOL_SHARE, (plane, share)
    _share_close(_x(po["x_hat"]), _np(jo["x_hat"]))


def test_bf16_spread_q_basic_jax_decoder_drifts_port_exact(trees):
    """q_basic from U(0.6, 3.0), q_scale 0.37: the JAX decoder rounds
    q_scale to bfloat16 and multiplies in bfloat16, its encoder forms a
    float32 product; the port forms the encoder's product on both
    sides."""
    tree = dict(trees["EVC_SS"])
    tree["q_basic"] = jnp.asarray(_rand(9, (192,), 0.6, 3.0))
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)
    enc_q = JE._curr_q(tree, np.asarray(Q, np.float32), jnp.bfloat16)
    dec_q = (jnp.maximum(tree["q_basic"], 0.5)
             * jnp.asarray(Q, jnp.bfloat16))[None, None, None, :]
    n_diff = int(jnp.sum(enc_q != dec_q))
    shares, po, pdo, jo, jdo = _bf16_pair(tree, "EVC_SS", _image(64, 64), Q)
    jax_drift = float(jnp.max(jnp.abs(jdo["x_hat"].astype(jnp.float32)
                                      - jo["x_hat"].astype(jnp.float32))))
    print(f"the JAX rate multipliers differ in {n_diff} of 192 channels; "
          f"its decoder's x_hat is up to {jax_drift:.4g} from its "
          f"encoder's; equal symbols {shares}")
    assert n_diff > 0 and jax_drift > 0
    assert torch.equal(pdo["x_hat"], po["x_hat"])
    for plane, share in shares.items():
        assert share >= SYMBOL_SHARE, (plane, share)


def test_bf16_scalable_keeps_float32_y_and_decodes_exact(trees):
    """A bfloat16 ScalableEVC on its float32 init: y, everything computed
    from it and x_hat are float32 in both packages' encoders; the JAX
    decoder computes y in bfloat16 and misses its encoder's x_hat, the
    port's decoder rebuilds it."""
    tree = trees["ScalableEVC"]
    shares, po, pdo, jo, jdo = _bf16_pair(tree, "ScalableEVC",
                                          _image(64, 64), 1.0)
    assert np.asarray(jo["x_hat"]).dtype == np.float32
    assert po["x_hat"].dtype == pdo["x_hat"].dtype == torch.float32
    assert torch.equal(pdo["x_hat"], po["x_hat"])
    jax_drift = float(jnp.max(jnp.abs(jdo["x_hat"].astype(jnp.float32)
                                      - jo["x_hat"])))
    print(f"ScalableEVC bfloat16: the JAX decoder ({jdo['x_hat'].dtype}) "
          f"is up to {jax_drift:.4g} from its encoder; equal symbols "
          f"{shares}")
    assert str(jdo["x_hat"].dtype) == "bfloat16" and jax_drift > 0
    for plane, share in shares.items():
        assert share >= SYMBOL_SHARE, (plane, share)
    _share_close(_x(po["x_hat"]), _np(jo["x_hat"]))
