"""The port's DCVC (`models/dcvc.py`: DCVCNet, its host `_ARCoder`, the
masked convolution) and its training (`training/forward.py::dcvc_forward`,
`stage_loss_dcvc`; `training/train.py::make_dcvc_loss`,
`dcvc_stage_grad_transform`, the fixed masks; `train_video --model dcvc`)
against the JAX package's, on the CPU.

Weights: the JAX package's own init (`DCVCNet.init_params(seed=0)`)
carried across with `from_jax`.  Under it no symbol of the motion latent,
y or z rounds to a non-zero value, so the stream tests code on the "live"
tree: the last conv of mv_enc, ctx_enc, prior_enc and mv_prior_enc scaled
by LIVE (weights and bias), the same tree in both packages; each plane's
non-zero symbols are counted, printed and required.  The JAX codec codes
with its plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1 during update()).
Frames: 64x64, a texture shifted 3 px plus mild noise, the reference raw.

Held, with each tolerance's reason:
  * the init: the JAX tree's keys and shapes, the masks equal;
  * every sub-network and stage on the same inputs: integers (the rounded
    z planes) exact, floats within STAGE_RTOL x max|ref| (XLA:CPU and ATen
    sum convolutions in their own orders);
  * `_ARCoder` on the same float64 prior and latent (N(0, 3), so most
    symbols are non-zero): the same bytes and y_hat as the JAX package's,
    exactly, and each decodes the other's bytes to that y_hat;
  * float32 streams (all four) byte-equal to the JAX package's (or else a
    tie by `eval/fm_ties.py`'s rule, printed), the port's decoder exact,
    each package decoding the other's streams (the port exactly, JAX
    within REL_TOL x max|ref|);
  * bfloat16, the reference frame handed raw (float32) to both packages,
    each casting it: the port's decoder exact; against the JAX bfloat16
    codec, the share of equal symbols per plane >= SYMBOL_SHARE;
  * training on a 3-frame clip, batch 2, stage 4, in "ste" and "noise"
    mode (the JAX draws passed to the port): `dcvc_forward`'s terms, the
    loss and metrics within FWD_RTOL relative, every gradient leaf but the
    masks within GRAD_RTOL x max(its largest |value|, GRAD_FLOOR x the
    tree's largest |value|) (`test_torch_port_tcm.py`'s bounds); stages
    1-3 on one P-frame, batch 1, the same; one optimizer step on the same
    gradients equal to optax's with the masks' gradients zeroed there by
    the JAX package's `freeze_subtree` (within OPT_RTOL); the port's step
    leaves every mask bit for bit, and in stages 2-3 every leaf of
    DCVC_MOTION_SUBTREES; `train_video --model dcvc --device cpu` trains
    two steps and saves a checkpoint the JAX package's `load_params`
    reads.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opendcvc_tpu.models import dcvc as JD
from opendcvc_tpu.training import forward as JF
from opendcvc_tpu.training import train as JTR
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch import train_video
from opendcvc_tpu_torch.eval import fm_ties as TIES
from opendcvc_tpu_torch.models import dcvc as PD
from opendcvc_tpu_torch.training import forward as PF
from opendcvc_tpu_torch.training import train as PTR
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

BF = torch.bfloat16
H = W = 64
LIVE = 20.0
STAGE_RTOL = 1e-4
REL_TOL = TIES.REL_TOL
SYMBOL_SHARE = 0.9
FWD_RTOL = 1e-4
GRAD_RTOL = 2e-4
GRAD_FLOOR = 1e-5
OPT_RTOL = 1e-6
B, LMBDA = 2, 256.0
KEYS = ("mv_z_string", "mv_y_string", "z_string", "y_string")


def _nchw(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(jnp.asarray(a, jnp.float32))
                                  .transpose(0, 3, 1, 2), order="C"))
    return t if dtype is None else t.to(dtype)


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


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


def live_tree(tree, scale=LIVE):
    """A copy of the port's tree whose motion latent, motion z, y and z
    carry non-zero symbols: the last conv of each of their encoders
    scaled."""
    tree = copy.deepcopy(tree)
    for conv in (tree["mv_enc"]["convs"][3], tree["ctx_enc"]["convs"][3],
                 tree["prior_enc"][2], tree["mv_prior_enc"][2]):
        conv["w"] = conv["w"] * scale
        conv["b"] = conv["b"] * scale
    return tree


@pytest.fixture(scope="module")
def jp():
    return JD.DCVCNet().init_params(seed=0)


@pytest.fixture(scope="module")
def live(jp):
    """(the port's live tree, the same tree in the JAX layout)."""
    pt = live_tree(from_jax(jp))
    return pt, to_jax(pt)


def _frames():
    rng = np.random.default_rng(5)
    ref = rng.random((1, H, W, 3), dtype=np.float32)
    x = np.clip(np.roll(ref, 3, axis=2) + rng.normal(0, 0.01, ref.shape),
                0, 1).astype(np.float32)
    return ref, x


# ---------------------------------------------------------------------------
# init, sub-networks and stages
# ---------------------------------------------------------------------------

def test_port_init_has_the_jax_layout(jp):
    tree = PD.DCVCNet(device="cpu").init_params(seed=3)
    assert _shapes(to_jax(tree)) == _shapes(jp)
    for key in ("auto_regressive", "auto_regressive_mv"):
        np.testing.assert_array_equal(tree[key]["mask"].numpy(),
                                      np.asarray(jp[key]["mask"]))
        assert float(tree[key]["mask"].sum()) == 12


def test_codec_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PD.DCVCNet()


def _stage_cases(jp):
    """(port call, JAX call, integer output positions) of every stage and
    sub-network, on NHWC numpy inputs."""
    pp = from_jax(jp)
    x, ref = _rand(1, (1, H, W, 3), 0, 1), _rand(2, (1, H, W, 3), 0, 1)
    mv = _rand(3, (1, H, W, 2), -2, 2)
    mv_y = _rand(4, (1, 4, 4, PD.CH_MV), -3, 3)
    z = np.round(_rand(5, (1, 1, 1, PD.CH_N), -4, 4))
    ctx = _rand(6, (1, H, W, PD.CH_N), -1, 1)
    y = _rand(7, (1, 4, 4, PD.CH_M), -3, 3)
    temporal = _rand(8, (1, 4, 4, PD.CH_M), -1, 1)
    ep_in = _rand(9, (1, 4, 4, PD.CH_M * 4), -1, 1)
    P, J = _nchw, jnp.asarray
    return {
        "mv_front": (lambda: PD._stage_mv_front(pp, P(x), P(ref)),
                     lambda: JD._stage_mv_front(jp, J(x), J(ref)), (2,)),
        "mv_prior_params": (
            lambda: (PD._stage_mv_prior_params(pp, P(z)),),
            lambda: (JD._stage_mv_prior_params(jp, J(z)),), ()),
        "after_mv": (lambda: (PD._stage_after_mv(pp, P(ref), P(mv_y)),),
                     lambda: (JD._stage_after_mv(jp, J(ref), J(mv_y)),), ()),
        "ctx_front": (lambda: PD._stage_ctx_front(pp, P(x), P(ctx)),
                      lambda: JD._stage_ctx_front(jp, J(x), J(ctx)), (2,)),
        "temporal": (lambda: (PD._stage_temporal(pp, P(ctx)),),
                     lambda: (JD._stage_temporal(jp, J(ctx)),), ()),
        "y_prior_params": (
            lambda: (PD._stage_y_prior_params(pp, P(z), P(temporal)),),
            lambda: (JD._stage_y_prior_params(jp, J(z), J(temporal)),), ()),
        "recon": (lambda: (PD._stage_recon(pp, P(y), P(ctx)),),
                  lambda: (JD._stage_recon(jp, J(y), J(ctx)),), ()),
        "mv_refine": (lambda: (PD.mv_refine(pp, P(ref), P(mv)),),
                      lambda: (JD.mv_refine(jp, J(ref), J(mv)),), ()),
        "motion_compensation": (
            lambda: (PD.motion_compensation(pp, P(ref), P(mv)),),
            lambda: (JD.motion_compensation(jp, J(ref), J(mv)),), ()),
        "entropy_params": (
            lambda: (PD.entropy_params_apply(pp["entropy_parameters"],
                                             P(ep_in)),),
            lambda: (JD.entropy_params_apply(jp["entropy_parameters"],
                                             J(ep_in)),), ()),
        "masked_conv": (
            lambda: (PD.masked_conv_apply(pp["auto_regressive"], P(y)),),
            lambda: (JD.masked_conv_apply(jp["auto_regressive"], J(y)),),
            ()),
        "res": (lambda: (PD._res_apply(pp["feature_extract"]["res"],
                                       P(ctx)),),
                lambda: (JD._res_apply(jp["feature_extract"]["res"],
                                       J(ctx)),), ()),
        "res01": (lambda: (PD._res01_apply(pp["ctx_enc"]["res"][0],
                                           P(ctx)),),
                  lambda: (JD._res01_apply(jp["ctx_enc"]["res"][0],
                                           J(ctx)),), ()),
    }


STAGES = ["mv_front", "mv_prior_params", "after_mv", "ctx_front",
          "temporal", "y_prior_params", "recon", "mv_refine",
          "motion_compensation", "entropy_params", "masked_conv", "res",
          "res01"]


@pytest.fixture(scope="module")
def stage_cases(jp):
    return _stage_cases(jp)


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


# ---------------------------------------------------------------------------
# the host AR coder
# ---------------------------------------------------------------------------

def q_nonzero(ar):
    """Non-zero symbols of the plane an _ARCoder encoded last."""
    return int((np.round(ar.last_floats[0]) != 0).sum())


def _coders(jp):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        jnet = JD.DCVCNet()
        jnet.load_params(jp)
        jnet.update()
    pnet = PD.DCVCNet(device="cpu")
    pnet.load_params(from_jax(jp))
    pnet.update()
    return jnet, pnet


@pytest.mark.parametrize("which", ["y", "mv_y"])
def test_ar_coder_bit_equal_to_jax(jp, which):
    """The same float64 prior and latent, N(0, 3): the same bytes and
    y_hat, and each side decodes the other's bytes."""
    jnet, pnet = _coders(jp)
    ar_j, ar_p = (jnet._ar, pnet._ar) if which == "y" else \
        (jnet._ar_mv, pnet._ar_mv)
    np.testing.assert_array_equal(ar_p.w, ar_j.w)
    assert ar_p.w.flags.c_contiguous
    for (wp, bp), (wj, bj) in zip(ar_p.ep, ar_j.ep):
        np.testing.assert_array_equal(wp, wj)
        np.testing.assert_array_equal(bp, bj)
        assert wp.flags.c_contiguous == wj.flags.c_contiguous
    c = ar_p.cin
    rng = np.random.default_rng(7)
    y = rng.normal(0, 3, (6, 5, c)).astype(np.float32)
    prior = rng.normal(0, 1, (6, 5, 2 * c)).astype(np.float32)
    out = {}
    for side, net, ar in (("jax", jnet, ar_j), ("port", pnet, ar_p)):
        net.entropy_coder.reset()
        y_hat = ar.encode(y, prior, net.gaussian_encoder)
        out[side] = (net._flush_segment(), y_hat)
    assert out["port"][0] == out["jax"][0]
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert q_nonzero(ar_p) > 0
    q = np.round(ar_p.last_floats[0])
    print(f"{which}: {len(out['port'][0])} B, {int((q != 0).sum())} of "
          f"{q.size} symbols non-zero")
    for side, net, ar in (("jax", jnet, ar_j), ("port", pnet, ar_p)):
        other = out["port" if side == "jax" else "jax"][0]
        net.entropy_coder.set_stream(other)
        np.testing.assert_array_equal(
            ar.decode(prior, net.gaussian_encoder), out["port"][1])


# ---------------------------------------------------------------------------
# streams on the live tree
# ---------------------------------------------------------------------------

def _nonzero(coded):
    """Non-zero symbols per plane of a frame's coded planes (coding
    order)."""
    return {n: int(((p.astype(np.int32) >> 8) if p.dtype == np.int16
                    else p.astype(np.int32)).astype(bool).sum())
            for n, p in zip(TIES.PLANES["dcvc"][1], coded)}


def _jax_codec(tree, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = JD.DCVCNet(**kw)
        net.load_params(tree)
        net.update()
    return net


def _port_codec(tree, **kw):
    net = PD.DCVCNet(device="cpu", **kw)
    net.load_params(tree)
    net.update()
    return net


def _code(live, dtype):
    pt, jt = live
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref, x = _frames()
    pe, pd = _port_codec(pt, dtype=dtype), _port_codec(pt, dtype=dtype)
    je, jd = _jax_codec(jt, dtype=jdt), _jax_codec(jt, dtype=jdt)
    coded = {"port": [], "jax": []}
    TIES.record_coded(pe, coded["port"])
    TIES.record_coded(je, coded["jax"])
    with TIES.PreRoundingFloats() as floats:
        floats.on = True
        po = pe.compress(ref, x)
        floats.on = False
        jo = je.compress(ref, x)
        floats = floats.take("dcvc")
    return {"ref": ref, "po": po, "jo": jo, "coded": coded,
            "floats": floats, "pd": pd, "jd": jd,
            "dec": pd.decompress(ref, *(po[k] for k in (
                "mv_y_string", "mv_z_string", "y_string", "z_string")),
                H, W)}


@pytest.fixture(scope="module")
def f32_run(live):
    return _code(live, torch.float32)


@pytest.fixture(scope="module")
def bf16_run(live):
    return _code(live, BF)


def _args(o):
    return [o[k] for k in ("mv_y_string", "mv_z_string", "y_string",
                           "z_string")]


def test_live_tree_codes_non_zero_symbols(f32_run):
    counts = _nonzero(f32_run["coded"]["port"])
    print(f"non-zero symbols per plane: {counts}")
    assert min(counts.values()) > 0, counts


def test_float32_streams_match_jax(f32_run):
    r = f32_run
    po, jo = r["po"], r["jo"]
    print("bytes " + ", ".join(f"{k} {len(po[k])}" for k in KEYS))
    if all(po[k] == jo[k] for k in KEYS):
        return
    plane, rows = TIES.first_differing_plane(
        r["coded"]["port"], r["coded"]["jax"], r["floats"], "dcvc")
    assert rows, "streams differ, every plane equal"
    for kind, i, value, dist, tol in rows:
        print(f"{plane} {kind} {i} differs; the port's value {value:.9g} "
              f"lies {dist:.3g} from its rounding boundary (float "
              f"agreement {tol:.3g})")
        assert dist <= tol, (plane, kind, i, dist, tol)


def test_float32_port_decoder_exact(f32_run):
    assert torch.equal(f32_run["dec"], f32_run["po"]["recon_image"])
    assert f32_run["dec"].dtype == torch.float32


def test_float32_each_side_decodes_the_others(f32_run):
    r = f32_run
    ref_img = r["po"]["recon_image"].numpy()
    jdo = r["jd"].decompress(r["ref"], *_args(r["po"]), H, W)
    np.testing.assert_allclose(_np(jdo), ref_img, rtol=0,
                               atol=REL_TOL * float(np.abs(ref_img).max()))
    if all(r["po"][k] == r["jo"][k] for k in KEYS):
        pdo = r["pd"].decompress(r["ref"], *_args(r["jo"]), H, W)
        np.testing.assert_array_equal(pdo.numpy(), ref_img)
    else:
        print("a boundary tie; the packages do not decode each other's "
              "streams of this frame")


def test_bf16_port_decoder_exact_and_close_to_jax(bf16_run):
    r = bf16_run
    assert r["po"]["recon_image"].dtype == BF
    assert torch.equal(r["dec"], r["po"]["recon_image"])
    shares = {}
    for n, a, b in zip(TIES.PLANES["dcvc"][1], r["coded"]["port"],
                       r["coded"]["jax"]):
        sa = (a.astype(np.int32) >> 8) if a.dtype == np.int16 else a
        sb = (b.astype(np.int32) >> 8) if b.dtype == np.int16 else b
        shares[n] = float((sa == sb).mean())
    print(f"bfloat16: equal symbols {shares}, non-zero "
          f"{_nonzero(r['coded']['port'])}")
    for plane, share in shares.items():
        assert share >= SYMBOL_SHARE, (plane, share)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _noise(rng, n_frames, batch):
    """The JAX DCVC loss's uniform draws for each frame's four quantizers
    (motion z, motion latent, z, y), NHWC, at 64x64."""
    shapes = [(batch, 1, 1, PD.CH_N), (batch, 4, 4, PD.CH_MV),
              (batch, 1, 1, PD.CH_N), (batch, 4, 4, PD.CH_M)]
    return [[jax.random.uniform(k, s, jnp.float32, -0.5, 0.5)
             for k, s in zip(jax.random.split(r, 4), shapes)]
            for r in jax.random.split(rng, n_frames)]


def _train_pair(jp, mode, stage, batch, n_frames):
    frames = np.random.default_rng(11).random(
        (batch, n_frames + 1, H, W, 3), np.float32)
    rng = jax.random.PRNGKey(13)
    loss_fn = JTR.make_dcvc_loss(LMBDA, stage=stage, quant_mode=mode)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, f: loss_fn(p, f, 0, rng), has_aux=True))(
            jp, jnp.asarray(frames))
    params = from_jax(jp)
    leaves = PTR.trainable_leaves(params)
    for t in leaves:
        t.requires_grad_()
    noise = None if mode == "ste" else \
        [[_nchw(n) for n in frame] for frame in _noise(rng, n_frames,
                                                       batch)]
    p_loss, p_metrics = PTR.make_dcvc_loss(LMBDA, stage=stage,
                                           quant_mode=mode)(
        params, torch.from_numpy(frames), 0, noise)
    p_grads = torch.autograd.grad(p_loss, leaves, allow_unused=True)
    it = iter(p_grads)
    full = [next(it) if k else None for k in PTR._trainable(params)]
    return {"jax": (loss, metrics, from_jax(grads)),
            "port": (p_loss, p_metrics, PTR.tree_unflatten(
                params, [torch.zeros_like(t) if g is None else g
                         for t, g in zip(PTR.tree_leaves(params), full)])),
            "frames": frames, "noise": noise, "rng": rng}


@pytest.fixture(scope="module", params=["ste", "noise"])
def train_run(request, jp):
    return _train_pair(jp, request.param, 4, B, 2)


@pytest.fixture(scope="module", params=[1, 2, 3])
def stage_run(request, jp):
    return request.param, _train_pair(jp, "noise", request.param, 1, 1)


def _like(like, tree):
    """tree with like's key order (JAX's tree functions sort dict
    keys)."""
    if isinstance(like, dict):
        return {k: _like(v, tree[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_like(a, b) for a, b in zip(like, tree)]
    return tree


def _pairs(port, ref, path=""):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        return [x for k in port for x in _pairs(port[k], ref[k],
                                                f"{path}/{k}")]
    if isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        return [x for i, (a, b) in enumerate(zip(port, ref))
                for x in _pairs(a, b, f"{path}/[{i}]")]
    return [(path, port, ref)]


def _check_loss(run):
    loss, metrics, _ = run["jax"]
    p_loss, p_metrics, _ = run["port"]
    assert set(p_metrics) == set(metrics)
    for k, want in list(metrics.items()) + [("loss", loss)]:
        got = float(p_metrics[k].detach()) if k != "loss" else \
            float(p_loss.detach())
        print(f"{k}: port {got:.7g}, JAX {float(want):.7g}")
        assert abs(got - float(want)) <= FWD_RTOL * abs(float(want)), k


def _check_grads(run):
    """Every leaf but the masks; the port's mask gradients are zero (the
    masks are not trained)."""
    pairs = _pairs(run["port"][2], run["jax"][2])
    masks = [(p, g) for p, g, _ in pairs if p.endswith("/mask")]
    assert len(masks) == 2
    for path, g in masks:
        assert not g.any(), path
    pairs = [t for t in pairs if not t[0].endswith("/mask")]
    floor = GRAD_FLOOR * max(float(w.abs().max()) for _, _, w in pairs)
    worst = max((float((g - w).abs().max()
                       / max(float(w.abs().max()), floor)), path)
                for path, g, w in pairs)
    print(f"largest gradient difference: {worst[0]:.3g} at {worst[1]}")
    for path, g, w in pairs:
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=GRAD_RTOL * max(float(w.abs().max()), floor),
            err_msg=path)


def test_dcvc_forward_terms_match(jp):
    """One frame, noise mode with JAX's draws: every term of
    `dcvc_forward` (and `stage_loss_dcvc` of each stage)."""
    frames = np.random.default_rng(12).random((1, 2, H, W, 3), np.float32)
    rng = jax.random.PRNGKey(14)
    want = JF.dcvc_forward(jp, jnp.asarray(frames[:, 1]),
                           jnp.asarray(frames[:, 0]), rng)
    # the JAX forward splits its key into the four quantizers' draws
    noise = [_nchw(jax.random.uniform(k, s, jnp.float32, -0.5, 0.5))
             for k, s in zip(jax.random.split(rng, 4), [
                 (1, 1, 1, PD.CH_N), (1, 4, 4, PD.CH_MV),
                 (1, 1, 1, PD.CH_N), (1, 4, 4, PD.CH_M)])]
    with torch.no_grad():
        got = PF.dcvc_forward(from_jax(jp), torch.from_numpy(frames[:, 1]),
                              torch.from_numpy(frames[:, 0]), noise)
    assert set(got) == set(want)
    for k in ("x_hat", "pixel_rec"):
        _close(got[k].numpy(), _np(want[k]), STAGE_RTOL, k)
    for k in ("mse", "warp_mse", "bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z",
              "bpp"):
        assert abs(float(got[k]) - float(want[k])) <= \
            FWD_RTOL * abs(float(want[k])), k
    for stage in (1, 2, 3, 4):
        a = float(PF.stage_loss_dcvc(got, LMBDA, stage))
        b = float(JF.stage_loss_dcvc(want, LMBDA, stage))
        assert abs(a - b) <= FWD_RTOL * abs(b), stage
    assert PF.DCVC_MOTION_SUBTREES == JF.DCVC_MOTION_SUBTREES


def test_stage4_loss_and_metrics_match(train_run):
    _check_loss(train_run)


def test_stage4_gradients_match(train_run):
    _check_grads(train_run)


def test_stages_1_to_3_loss_and_gradients_match(stage_run):
    stage, run = stage_run
    print(f"stage {stage}")
    _check_loss(run)
    _check_grads(run)


def test_optimizer_step_matches_optax_with_masks_frozen(jp):
    """The same gradients (N(0, 1e-3) on every leaf, the masks' too)
    through the port's optimizer on the trainable leaves and through optax
    with the masks' gradients zeroed: equal parameters after the step,
    the masks unchanged in both."""
    rng = np.random.default_rng(16)
    jgrads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 1e-3, a.shape), jnp.float32),
        jp)
    jtx = JTR.make_optimizer(1e-3, "constant", 10, 0, 1.0)

    @jax.jit
    def jax_step(g, p):
        g = JTR.freeze_subtree(g, ("mask",))
        updates, _ = jtx.update(g, jtx.init(p), p)
        return optax.apply_updates(p, updates)

    want = from_jax(jax_step(jgrads, jp))
    params, grads = from_jax(jp), _like(jp, from_jax(jgrads))
    tx = PTR.make_optimizer(1e-3, "constant", 10, 0, 1.0)
    leaves = PTR.trainable_leaves(params)
    ups, _ = tx.update(PTR.trainable_leaves(grads), tx.init(leaves))
    torch._foreach_add_(leaves, ups)
    init = from_jax(jp)
    for path, g, w in _pairs(params, want):
        if path.endswith("/mask"):
            assert torch.equal(g, w) and torch.equal(
                g, init[path.split("/")[1]]["mask"]), path
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=OPT_RTOL,
                                       atol=1e-9, err_msg=path)


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_step_keeps_masks_and_frozen_motion(jp, stage):
    """One port step (batch 1, one P-frame): the masks unchanged bit for
    bit; in stages 2-3 every leaf of DCVC_MOTION_SUBTREES too, while the
    contextual branch moves."""
    params = from_jax(jp)
    before = [t.clone() for t in PTR.tree_leaves(params)]
    tx = PTR.make_optimizer(1e-3, "constant", 10, 0, 1.0)
    step = PTR.make_train_step(PTR.make_dcvc_loss(LMBDA, stage=stage),
                               tx, grad_transform=PTR
                               .dcvc_stage_grad_transform(stage))
    frames = torch.from_numpy(np.random.default_rng(15).random(
        (1, 2, H, W, 3), np.float32))
    params, _, metrics = step(params, tx.init(PTR.trainable_leaves(params)),
                              frames, 0, torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    frozen = PF.DCVC_MOTION_SUBTREES if stage in (2, 3) else ()
    for path, a, b in zip(PTR._paths(params), before,
                          PTR.tree_leaves(params)):
        top = path.split("/")[0]
        if path.endswith("/mask") or top in frozen:
            assert torch.equal(a, b), path
    moved = {p.split("/")[0] for p, a, b in zip(
        PTR._paths(params), before, PTR.tree_leaves(params))
        if not torch.equal(a, b)}
    assert "ctx_enc" in moved and "ctx_dec2" in moved
    assert ("mv_enc" in moved) == (stage == 4)


def test_train_video_dcvc_on_cpu(tmp_path):
    """Two steps of --model dcvc (2 frames, batch 1, crop 64, stage 3) on
    the CPU: finite losses; the checkpoint in the JAX layout loads in the
    JAX package, its masks the init's."""
    out = train_video.main(["--device", "cpu", "--model", "dcvc",
                            "--stage", "3", "--frames", "2",
                            "--batch_size", "1", "--crop", "64", "--steps",
                            "2", "--log_every", "1", "--warmup_steps", "0",
                            "--save_dir", str(tmp_path)])
    assert len(out["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    path = str(tmp_path / "dcvc_latest.msgpack")
    assert int(JCK.load_checkpoint(path)["extra"]["step"]) == 2
    tree = JCK.load_params(path)
    assert _shapes(tree) == _shapes(JD.DCVCNet().init_params(seed=0))
    mask = np.asarray(JD.masked_conv_init(jax.random.PRNGKey(0), 4, 4)
                      ["mask"])
    for key in ("auto_regressive", "auto_regressive_mv"):
        np.testing.assert_array_equal(np.asarray(tree[key]["mask"]), mask)
