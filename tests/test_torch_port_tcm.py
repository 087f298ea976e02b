"""The port's DCVC-TCM (`models/dmc_tcm.py`, `layers/gdn.py`,
`layers/blocks.py::conv_transpose2x_apply`, and its training:
`training/forward.py::dmc_tcm_forward_one_frame` and `laplace_bits`,
`training/train.py::make_tcm_loss`, `train_video --model tcm`) against
the JAX package's, on the CPU.

Weights: the JAX package's own init (`DMCTCM.init_params(seed=0)`)
carried across with `from_jax`.  The JAX codec codes on the host with its
plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1 during update()).  Frames:
64x64 from numpy's default_rng, a texture shifted 2 px a frame plus mild
noise; the chain starts from a raw reference frame.

Held, with each tolerance's reason:
  * `conv_transpose2x_apply` (k = 3, on odd and even sizes): float32
    within BLOCK_RTOL x max|ref| (the two backends sum in their own
    orders), bfloat16 within BF16_RTOL x max|ref| (one bfloat16 step at
    the largest value); `gdn_apply` forward and inverse the same; the
    GDN init exact; `lower_bound`'s straight-through gradient equal to
    `jax.grad`'s, and GDN's gradients within BLOCK_RTOL;
  * `laplace_bits` within 1e-3 + 1e-5 |bits| (expm1 differs by an ulp);
  * every stage function on the same inputs: the rounded z planes and
    the packed symbols and CDF indexes exact, floats within STAGE_RTOL x
    max|ref|;
  * float32 streams of two P-frames: byte-equal to the JAX package's (or
    else a tie by `eval/fm_ties.py`'s rule, printed), the port's decoder
    exact (x_hat and feature), each package decoding the other's stream
    (the port exactly, JAX within REL_TOL x max|ref|); the JAX encoder
    codes each frame from the port's references;
  * bfloat16: the port's chain exact; against the JAX bfloat16 codec on
    the port's references, equal symbols per plane >= SYMBOL_SHARE; a raw
    float32 reference (cast by the port, kept by JAX) held to the same
    share and, on x_hat and the feature, to RAW_REF_SHARE of the values
    within RAW_REF_RTOL x max|ref|;
  * training on a 3-frame clip, batch 2, in "ste" and in "noise" mode
    (the JAX draws passed to the port): the loss and metrics within
    FWD_RTOL relative, every gradient leaf within GRAD_RTOL x max(its
    largest |value|, GRAD_FLOOR x the tree's largest |value|)
    (`test_torch_port_training.py`'s FWD_RTOL and GRAD_RTOL).  The floor:
    under random weights the y prior's scales sit on the 1e-5 clamp, so
    bpp_y is ~2e-11 bits a pixel and that branch's gradients (1e-13 to
    1e-7, against the tree's ~40) are the float noise of expm1 next to
    0, up to 60 % apart between the packages.  The first run measured
    9.1e-5 (ste) and 1.4e-4 (noise) against this bound;
    `python -m opendcvc_tpu_torch.train_video --model tcm --device cpu`
    trains two steps and saves its checkpoint in the JAX layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.layers import blocks as JB
from opendcvc_tpu.layers import gdn as JG
from opendcvc_tpu.models import dmc_tcm as JT
from opendcvc_tpu.training import forward as JF
from opendcvc_tpu.training import train as JTR
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch import train_video
from opendcvc_tpu_torch.eval import fm_ties as TIES
from opendcvc_tpu_torch.layers import blocks as PB
from opendcvc_tpu_torch.layers import gdn as PG
from opendcvc_tpu_torch.models import dmc_tcm as PT
from opendcvc_tpu_torch.training import forward as PF
from opendcvc_tpu_torch.training import train as PTR
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

BF = torch.bfloat16
H = W = 64
N_P = 2
BLOCK_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
STAGE_RTOL = 1e-4
REL_TOL = TIES.REL_TOL
SYMBOL_SHARE = 0.9
RAW_REF_SHARE = 0.9
RAW_REF_RTOL = 2.0 ** -4
FWD_RTOL = 1e-4
GRAD_RTOL = 2e-4
GRAD_FLOOR = 1e-5
B, LMBDA = 2, 256.0


def _nchw(a, dtype=torch.float32):
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2),
                                     order="C")).to(dtype)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


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


# ---------------------------------------------------------------------------
# the 2x transposed conv and GDN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(5, 7), (4, 6)], ids=["odd", "even"])
def test_conv_transpose2x_matches_jax(hw, dtype):
    """The input-dilated correlation with the unflipped kernel, pads
    (k-1-p, k-p), bias added after: an exact 2x upsample."""
    tdt, jdt, rtol = (torch.float32, jnp.float32, BLOCK_RTOL) \
        if dtype == "float32" else (BF, jnp.bfloat16, BF16_RTOL)
    p = JB.conv_init(jax.random.PRNGKey(sum(hw)), 8, 12, 3)
    x = _rand(sum(hw), (1,) + hw + (8,), -2, 2)
    want = JB.conv_transpose2x_apply(p, jnp.asarray(x, jdt))
    got = PB.conv_transpose2x_apply(from_jax(p), _nchw(x, tdt))
    assert got.dtype == tdt
    assert got.shape == (1, 12, 2 * hw[0], 2 * hw[1])
    _close(_nhwc(got), _np(want), rtol)


def _gdn_params(seed, ch=12):
    """GDN parameters off their init, some below the bounds."""
    p = JG.gdn_init(None, ch)
    k = jax.random.split(jax.random.PRNGKey(seed))
    return {"beta": p["beta"] * jax.random.uniform(k[0], (ch,), minval=0.5,
                                                   maxval=1.5),
            "gamma": p["gamma"] + jax.random.uniform(
                k[1], (ch, ch), minval=-0.02, maxval=0.08)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_gdn_matches_jax(inverse, dtype):
    """The norm in float32 over a non-symmetric gamma (so a transposed
    contraction shows), its sqrt cast to x's dtype before the divide or
    the product."""
    tdt, jdt, rtol = (torch.float32, jnp.float32, BLOCK_RTOL) \
        if dtype == "float32" else (BF, jnp.bfloat16, BF16_RTOL)
    p = _gdn_params(3)
    x = _rand(4, (1, 5, 6, 12), -3, 3)
    want = JG.gdn_apply(p, jnp.asarray(x, jdt), inverse=inverse)
    got = PG.gdn_apply(from_jax(p), _nchw(x, tdt), inverse=inverse)
    assert got.dtype == tdt and np.asarray(want).dtype == jdt
    _close(_nhwc(got), _np(want), rtol)


def test_gdn_init_equals_jax():
    for ch in (64, 96, 144):
        want = JG.gdn_init(None, ch)
        got = PG.gdn_init(None, ch)
        for k in ("beta", "gamma"):
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_lower_bound_gradient_equals_jax():
    """g passes where x >= bound or g < 0, else 0 (values on both sides of
    the bound, gradients of both signs), and GDN's gradients through it
    within BLOCK_RTOL."""
    bound = 0.3
    x = _rand(5, (64,), -1, 1)
    x[:4] = bound
    g = _rand(6, (64,), -1, 1)
    want = jax.grad(lambda v: jnp.sum(JG.lower_bound(v, bound)
                                      * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (PG.lower_bound(xt, bound) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert 0 < int((xt.grad == 0).sum()) < 64

    p = _gdn_params(7)
    p["beta"] = p["beta"].at[:3].set(1e-5)   # below beta's bound
    p["gamma"] = p["gamma"].at[0, :].set(-0.01)   # below gamma's
    x = _rand(8, (1, 4, 5, 12), -3, 3)
    for inverse in (False, True):
        want = jax.grad(lambda q, v: jnp.sum(jnp.sin(JG.gdn_apply(
            q, v, inverse=inverse))), argnums=(0, 1))(p, jnp.asarray(x))
        pp = {k: v.requires_grad_() for k, v in from_jax(p).items()}
        xt = _nchw(x).requires_grad_()
        torch.sin(PG.gdn_apply(pp, xt, inverse=inverse)).sum().backward()
        for k in ("beta", "gamma"):
            _close(pp[k].grad.numpy(), np.asarray(want[0][k]), BLOCK_RTOL,
                   k)
        _close(_nhwc(xt.grad), np.asarray(want[1]), BLOCK_RTOL, "x")


def test_laplace_bits_matches_jax():
    rng = np.random.default_rng(9)
    res = np.round(rng.laplace(0, 3, (2, 8, 4, 4))).astype(np.float32)
    scales = rng.uniform(1e-6, 20, res.shape).astype(np.float32)
    want = np.asarray(JF.laplace_bits(jnp.asarray(res), jnp.asarray(scales)))
    got = PF.laplace_bits(torch.from_numpy(res), torch.from_numpy(scales))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# init and the stages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jp():
    return JT.DMCTCM().init_params(seed=0)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


def test_port_init_has_the_jax_layout(jp):
    tree = to_jax(PT.DMCTCM(device="cpu").init_params(seed=3))
    assert _shapes(tree) == _shapes(jp)
    for leaf in jax.tree_util.tree_leaves(tree):
        assert leaf.dtype == np.float32


def test_codec_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PT.DMCTCM()


def _cfg():
    return PT.DMCTCM(device="cpu")._cfg


def _stage_cases(jp):
    """(port call, JAX call, integer output positions) of every stage
    function, on NHWC numpy inputs."""
    pp = from_jax(jp)
    x, ref = _rand(1, (1, H, W, 3), 0, 1), _rand(2, (1, H, W, 3), 0, 1)
    z64 = np.round(_rand(3, (1, 1, 1, PT.CH_N), -4, 4))
    mv_y = _rand(4, (1, 4, 4, PT.CH_MV), -3, 3)
    mv_hat = _rand(5, (1, H, W, 2), -2, 2)
    feat = _rand(6, (1, H, W, PT.CH_N), -1, 1)
    c = [_rand(7 + k, (1, H >> k, W >> k, PT.CH_N), -1, 1) for k in range(3)]
    y = _rand(10, (1, 4, 4, PT.CH_M), -6, 6)
    scales = _rand(11, (1, 4, 4, PT.CH_M), 0.001, 80)
    means = _rand(12, (1, 4, 4, PT.CH_M), -2, 2)
    cfg = _cfg()
    P, J = _nchw, jnp.asarray
    return {
        "mv_enc": (lambda: PT._stage_mv_enc(pp, P(x), P(ref)),
                   lambda: JT._stage_mv_enc(jp, J(x), J(ref)), (2,)),
        "mv_params": (lambda: PT._stage_mv_params(pp, P(z64)),
                      lambda: JT._stage_mv_params(jp, J(z64)), ()),
        "quantize_dense": (
            lambda: PT._stage_quantize_dense(P(y), P(scales), P(means), cfg),
            lambda: JT._stage_quantize_dense(J(y), J(scales), J(means), cfg),
            (0,)),
        "index_dense": (lambda: (PT._stage_index_dense(P(scales), cfg),),
                        lambda: (JT._stage_index_dense(J(scales), cfg),),
                        (0,)),
        "mv_dec": (lambda: (PT._stage_mv_dec(pp, P(mv_y)),),
                   lambda: (JT._stage_mv_dec(jp, J(mv_y)),), ()),
        "motion_comp_i": (
            lambda: PT._stage_motion_comp(pp, P(mv_hat), P(ref), None),
            lambda: JT._stage_motion_comp(jp, J(mv_hat), J(ref), None), ()),
        "motion_comp_p": (
            lambda: PT._stage_motion_comp(pp, P(mv_hat), P(ref), P(feat)),
            lambda: JT._stage_motion_comp(jp, J(mv_hat), J(ref), J(feat)),
            ()),
        "ctx_enc": (lambda: PT._stage_ctx_enc(pp, P(x), *map(P, c)),
                    lambda: JT._stage_ctx_enc(jp, J(x), *map(J, c)), (2,)),
        "y_params": (lambda: PT._stage_y_params(pp, P(z64), *map(P, c)),
                     lambda: JT._stage_y_params(jp, J(z64), *map(J, c)), ()),
        "recon": (lambda: PT._stage_recon(pp, P(y), *map(P, c)),
                  lambda: JT._stage_recon(jp, J(y), *map(J, c)), ()),
    }


STAGES = ["mv_enc", "mv_params", "quantize_dense", "index_dense", "mv_dec",
          "motion_comp_i", "motion_comp_p", "ctx_enc", "y_params", "recon"]


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
# the chain
# ---------------------------------------------------------------------------

def _frames(n):
    rng = np.random.default_rng(H + 2)
    tex = rng.random((1, H, W + 2 * n + 2, 3), dtype=np.float32)
    return [np.clip(tex[:, :, 2 * t:2 * t + W]
                    + rng.normal(0, 0.02, (1, H, W, 3)).astype(np.float32),
                    0, 1) for t in range(n + 1)]


def _jax_codec(tree, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = JT.DMCTCM(**kw)
        net.load_params(tree)
        net.update()
    return net


def _port_codec(tree, **kw):
    net = PT.DMCTCM(device="cpu", **kw)
    net.load_params(from_jax(tree))
    net.update()
    return net


def _symbols(planes):
    return [p.astype(np.int32) >> 8 if p.dtype == np.int16 else
            p.astype(np.int32) for p in planes]


def _shares(coded):
    return {n: float((a == b).mean()) for n, a, b in zip(
        TIES.PLANES["tcm"][1], _symbols(coded["port"]),
        _symbols(coded["jax"]))}


def _refs_np(ref, feat):
    return {"x_hat": np.asarray(ref, np.float32) if not torch.is_tensor(ref)
            else ref.float().numpy(),
            "feature": None if feat is None else _nhwc(feat)}


def _run_chain(jp, dtype=torch.float32):
    """The port's encoder drives the chain from a raw reference; the JAX
    encoder codes each frame from the port's references, and in float32
    each package decodes the other's streams."""
    f32 = dtype == torch.float32
    jdtype = jnp.float32 if f32 else jnp.bfloat16
    xs = _frames(N_P)
    pe, pd = (_port_codec(jp, dtype=dtype) for _ in range(2))
    je = _jax_codec(jp, dtype=jdtype)
    jd = _jax_codec(jp) if f32 else None
    coded = {"port": [], "jax": []}
    TIES.record_coded(pe, coded["port"])
    TIES.record_coded(je, coded["jax"])
    out = {k: [] for k in ("port_stream", "jax_stream", "ties", "exact",
                           "port_enc", "port_dec", "jax_dec",
                           "port_dec_jax", "shares", "dtypes")}
    ref, feat = xs[0], None
    dref, dfeat = xs[0], None
    with TIES.PreRoundingFloats() as floats:
        for t in range(1, N_P + 1):
            floats.on = True
            po = pe.compress(xs[t], ref, feat)
            floats.on = False
            d = pd.decompress(dref, dfeat, po["bit_stream"], H, W)
            jref = jnp.asarray(_refs_np(ref, None)["x_hat"], jdtype)
            jfeat = None if feat is None else jnp.asarray(_nhwc(feat),
                                                          jdtype)
            jo = je.compress(jnp.asarray(xs[t], jdtype), jref, jfeat)
            js = jo["bit_stream"]
            out["port_stream"].append(po["bit_stream"])
            out["jax_stream"].append(js)
            out["shares"].append(_shares(coded))
            out["exact"].append(torch.equal(d["x_hat"], po["x_hat"])
                                and torch.equal(d["feature"],
                                                po["feature"]))
            out["dtypes"].append({po["x_hat"].dtype, po["feature"].dtype,
                                  d["x_hat"].dtype, d["feature"].dtype})
            tie = None
            if f32 and js != po["bit_stream"]:
                tie = TIES.first_differing_plane(coded["port"],
                                                 coded["jax"],
                                                 floats.take("tcm"), "tcm")
            else:
                floats.take("tcm")
            coded["port"].clear()
            coded["jax"].clear()
            out["ties"].append(tie)
            out["port_enc"].append(_refs_np(po["x_hat"], po["feature"]))
            out["port_dec"].append(_refs_np(d["x_hat"], d["feature"]))
            if f32:
                jdo = jd.decompress(jref, jfeat, po["bit_stream"], H, W)
                out["jax_dec"].append({"x_hat": _np(jdo["x_hat"]),
                                       "feature": _np(jdo["feature"])})
                if tie is None:
                    pdo = _port_codec(jp).decompress(ref, feat, js, H, W)
                    out["port_dec_jax"].append(
                        _refs_np(pdo["x_hat"], pdo["feature"]))
                else:
                    out["port_dec_jax"].append(None)
            ref, feat = po["x_hat"], po["feature"]
            dref, dfeat = d["x_hat"], d["feature"]
    return out


@pytest.fixture(scope="module")
def f32_run(jp):
    return _run_chain(jp)


@pytest.fixture(scope="module")
def bf16_run(jp):
    return _run_chain(jp, dtype=BF)


def test_streams_match_jax(f32_run):
    r = f32_run
    for t, ties in enumerate(r["ties"]):
        if ties is None:
            assert r["port_stream"][t] == r["jax_stream"][t], t
            continue
        plane, rows = ties
        assert rows, f"frame {t}: streams differ, every plane equal"
        for kind, i, value, dist, tol in rows:
            print(f"frame {t}: {plane} {kind} {i} differs; the port's "
                  f"value {value:.9g} lies {dist:.3g} from its rounding "
                  f"boundary (float agreement {tol:.3g})")
            assert dist <= tol, (t, plane, kind, i, dist, tol)


def test_port_decoder_exact(f32_run):
    assert all(f32_run["exact"]), f32_run["exact"]
    for d in f32_run["dtypes"]:
        assert d == {torch.float32}, d


def test_each_side_decodes_the_others_streams(f32_run):
    r = f32_run
    for t in range(N_P):
        if r["ties"][t] is not None:
            print(f"frame {t}: a boundary tie; the packages do not decode "
                  f"each other's stream of this frame")
            continue
        for k, ref in r["port_enc"][t].items():
            np.testing.assert_allclose(
                r["jax_dec"][t][k], ref, rtol=0,
                atol=REL_TOL * float(np.abs(ref).max()),
                err_msg=f"JAX on the port's stream, frame {t} {k}")
            np.testing.assert_array_equal(r["port_dec_jax"][t][k], ref,
                                          err_msg=f"frame {t} {k}")


def test_bf16_chain_exact(bf16_run):
    assert all(bf16_run["exact"]), bf16_run["exact"]
    for d in bf16_run["dtypes"]:
        assert d == {BF}, d


def test_bf16_symbols_close_to_jax(bf16_run):
    for t, shares in enumerate(bf16_run["shares"]):
        print(f"P-frame {t + 1}: equal symbols {shares}")
        for plane, share in shares.items():
            assert share >= SYMBOL_SHARE, (t, plane, share)


def test_bf16_float32_reference_against_jax(jp):
    """A raw float32 reference before the bfloat16 DMCTCM: the port casts
    it, the JAX package keeps it (its encoder promoted to float32).
    Held: equal symbols per plane >= SYMBOL_SHARE, and on x_hat and the
    feature the share of values within RAW_REF_RTOL x max|ref| of JAX's
    >= RAW_REF_SHARE; printed: the JAX decoder's distance from its own
    encoder (or that it cannot decode that stream)."""
    xs = _frames(1)
    pe = _port_codec(jp, dtype=BF)
    je, jd = (_jax_codec(jp, dtype=jnp.bfloat16) for _ in range(2))
    coded = {"port": [], "jax": []}
    TIES.record_coded(pe, coded["port"])
    TIES.record_coded(je, coded["jax"])
    po = pe.compress(xs[1], xs[0], None)
    jo = je.compress(jnp.asarray(xs[1]), jnp.asarray(xs[0]), None)
    try:
        jdo = jd.decompress(jnp.asarray(xs[0]), None, jo["bit_stream"], H, W)
    except (IndexError, ValueError) as e:
        print(f"the JAX decoder cannot decode its own encoder's stream "
              f"({type(e).__name__}: {e})")
        jdo = None
    assert po["x_hat"].dtype == po["feature"].dtype == BF
    shares = _shares(coded)
    print(f"equal symbols {shares}")
    for plane, share in shares.items():
        assert share >= SYMBOL_SHARE, (plane, share)
    port = _refs_np(po["x_hat"], po["feature"])
    for k in ("x_hat", "feature"):
        jenc = _np(jo[k])
        scale = float(np.abs(jenc).max())
        err = np.abs(port[k] - jenc) / scale
        close = float((err <= RAW_REF_RTOL).mean())
        own = "" if jdo is None else \
            f"; the JAX decoder vs its encoder max " \
            f"{float(np.abs(_np(jdo[k]) - jenc).max()) / scale:.4g}"
        print(f"{k} (JAX {np.asarray(jo[k]).dtype}): port vs JAX max "
              f"{err.max():.4f} x max|ref|, {close:.5f} within "
              f"{RAW_REF_RTOL}{own}")
        assert close >= RAW_REF_SHARE, (k, close)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _noise(rng, n_frames):
    """The JAX TCM loss's uniform draws for each frame's four quantizers
    (motion z, motion latent, z, y), NHWC, at 64x64 and batch B."""
    shapes = [(B, 1, 1, PT.CH_N), (B, 4, 4, PT.CH_MV), (B, 1, 1, PT.CH_N),
              (B, 4, 4, PT.CH_M)]
    return [[jax.random.uniform(k, s, jnp.float32, -0.5, 0.5)
             for k, s in zip(jax.random.split(r, 4), shapes)]
            for r in jax.random.split(rng, n_frames)]


@pytest.fixture(scope="module", params=["ste", "noise"])
def train_run(request, jp):
    mode = request.param
    frames = np.random.default_rng(11).random((B, 3, H, W, 3), np.float32)
    rng = jax.random.PRNGKey(13)
    loss_fn = JTR.make_tcm_loss(LMBDA, quant_mode=mode)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, f: loss_fn(p, f, 0, rng), has_aux=True))(
            jp, jnp.asarray(frames))
    params = from_jax(jp)
    leaves = PTR.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    noise = None if mode == "ste" else \
        [[_nchw(n) for n in frame] for frame in _noise(rng, 2)]
    p_loss, p_metrics = PTR.make_tcm_loss(LMBDA, quant_mode=mode)(
        params, torch.from_numpy(frames), 0, noise)
    p_grads = torch.autograd.grad(p_loss, leaves, allow_unused=True)
    return {"jax": (loss, metrics, from_jax(grads)),
            "port": (p_loss, p_metrics, PTR.tree_unflatten(params, [
                torch.zeros_like(t) if g is None else g
                for t, g in zip(leaves, p_grads)]))}


def test_tcm_loss_and_metrics_match(train_run):
    loss, metrics, _ = train_run["jax"]
    p_loss, p_metrics, _ = train_run["port"]
    assert set(p_metrics) == set(metrics)
    for k, want in list(metrics.items()) + [("loss", loss)]:
        got = float(p_metrics[k].detach()) if k != "loss" else \
            float(p_loss.detach())
        print(f"{k}: port {got:.7g}, JAX {float(want):.7g}")
        assert abs(got - float(want)) <= FWD_RTOL * abs(float(want)), k


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


def test_tcm_gradients_match(train_run):
    """Every leaf, through the two frames' x_hat and feature chain; the P
    adaptor and the GDN parameters learn."""
    pairs = _pairs(train_run["port"][2], train_run["jax"][2])
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
    by_path = {p: g for p, g, _ in pairs}
    for path in ("/feature_adaptor_P/w", "/ctx_enc/g1/gamma",
                 "/mv_dec/gdn1/beta"):
        assert float(by_path[path].abs().sum()) > 0, path


def test_train_video_tcm_on_cpu(tmp_path):
    """Two steps of --model tcm (3 frames, batch 1, crop 64) on the CPU:
    finite losses, and the checkpoint in the JAX layout loads in the JAX
    package's DMCTCM."""
    out = train_video.main(["--device", "cpu", "--model", "tcm",
                            "--frames", "3", "--batch_size", "1", "--crop",
                            "64", "--steps", "2", "--log_every", "1",
                            "--warmup_steps", "0", "--save_dir",
                            str(tmp_path)])
    assert len(out["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    payload = JCK.load_checkpoint(str(tmp_path / "tcm_latest.msgpack"))
    assert int(payload["extra"]["step"]) == 2
    net = JT.DMCTCM()
    assert _shapes(payload["params"]) == _shapes(net.init_params(seed=0))
