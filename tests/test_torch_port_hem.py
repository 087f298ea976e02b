"""The port's DCVC-HEM (`models/intra_no_ar.py`, `models/dmc_hem.py`) and
the two-part checkerboard stages (`make_pass_stages(cfg, 2)`) against the
JAX package's, on the CPU.

Weights: the JAX package's own init (IntraNoAR seed 0, N = 192; DMCHEM
seed 1) carried across with `from_jax`.  The JAX codecs code on the host
with their plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1 during update()).
Frames: 64x64 from numpy's default_rng, a texture shifted 2 px a frame
plus mild noise.  The chain: an IntraNoAR I-frame (q_scale 1.0), then
HEM P-frames from its x_hat at a rung between spread anchors.

Held:
  * `make_pass_stages(cfg, 2)`, every stage, on IntraNoAR's Gaussian and
    HEM's Laplace tables, in float32 and bfloat16: packed symbols and CDF
    indexes exact; float planes exact too (the stages are elementwise);
  * every stage function of both codecs on the same inputs: integers
    (the rounded z planes) exact, floats within STAGE_RTOL x max|ref|
    (XLA:CPU and ATen sum convolutions in their own orders);
  * the port's init: the JAX tree's keys and shapes;
    `get_interpolated_q_scales` equal to JAX's on spread and on flat
    anchors;
  * float32 streams: IntraNoAR's and two HEM P-frames', each byte-equal
    to the JAX package's (or else a tie by `eval/fm_ties.py`'s rule,
    printed), the port's decoder exact (x_hat, all four DPB entries), and
    each package decoding the other's stream: the port exactly, JAX
    within REL_TOL x max|ref|; the JAX encoder codes each frame from the
    port's DPB, so every frame is its own comparison;
  * bfloat16: the port's chain exact, every entry bfloat16; against the
    JAX bfloat16 codecs, coding each frame from the port's references,
    the share of equal symbols per plane >= SYMBOL_SHARE (RT's bound,
    `test_torch_port_bf16.py`);
  * a raw float32 reference before the bfloat16 DMCHEM: the port casts
    it, the JAX package keeps it and promotes its encoder's DPB to
    float32: the symbol share as above, each DPB entry's share of values
    within RAW_REF_RTOL x max|ref| of JAX's >= RAW_REF_SHARE, and the
    JAX decoder's distance from its own encoder printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.models import dmc_hem as JH
from opendcvc_tpu.models import intra_no_ar as JI
from opendcvc_tpu.models import prior_stages as JPS
from opendcvc_tpu_torch.entropy import models as PM
from opendcvc_tpu_torch.eval import fm_ties as TIES
from opendcvc_tpu_torch.models import dmc_hem as PH
from opendcvc_tpu_torch.models import intra_no_ar as PI
from opendcvc_tpu_torch.models import prior_stages as PPS
from opendcvc_tpu_torch.models.dmci_fm import gaussian_cfg
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

BF = torch.bfloat16
H = W = 64
N_P = 2
ANCHORS = [2.0, 1.2, 0.8, 0.5]
DPB_KEYS = ("ref_frame", "ref_feature", "ref_y", "ref_mv_y")
STAGE_RTOL = 1e-4
REL_TOL = TIES.REL_TOL
SYMBOL_SHARE = 0.9
RAW_REF_SHARE = 0.9
RAW_REF_RTOL = 2.0 ** -4


def _nchw(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(jnp.asarray(a, jnp.float32))
                                  .transpose(0, 3, 1, 2), order="C"))
    return t if dtype is None else t.to(dtype)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# make_pass_stages(cfg, 2)
# ---------------------------------------------------------------------------

def _ge(dist):
    """IntraNoAR's Gaussian and HEM's Laplace tables."""
    if dist == "gaussian":
        return PM.GaussianEncoder(distribution="gaussian", scale_min=0.11,
                                  scale_max=64.0, scale_levels=256,
                                  support=50)
    return PM.GaussianEncoder(distribution="laplace", scale_min=0.01,
                              scale_max=64.0, scale_levels=256, support=50)


def _pass_inputs(seed, c=16, h=6, w=10):
    return {"y": _rand(seed, (1, h, w, c), -6, 6),
            "q_step": _rand(seed + 1, (1, h, w, c), 0.3, 2.5),
            "scales": _rand(seed + 2, (1, h, w, c), 0.001, 80),
            "means": _rand(seed + 3, (1, h, w, c), -2, 2),
            "prior": np.concatenate([_rand(seed + 4, (1, h, w, c), 0.2, 3),
                                     _rand(seed + 5, (1, h, w, c), 0.001, 80),
                                     _rand(seed + 6, (1, h, w, c), -2, 2)],
                                    -1),
            "sym": np.round(_rand(seed + 7, (1, h, w, c // 2), -5, 5)),
            "so_far": _rand(seed + 8, (1, h, w, c), -3, 3)}


def _pass_call(name, st, a, conv):
    """Stage `name` of a make_pass_stages dict on the inputs `a`, each
    converted by `conv`: its outputs as a tuple."""
    c = {k: conv(v) for k, v in a.items()}
    calls = {
        "enc_pass0_qstep": lambda: st[name](c["y"], c["q_step"], c["scales"],
                                            c["means"]),
        "enc_pass_k": lambda: st[name](c["y"], c["scales"], c["means"],
                                       c["so_far"], 1)
        + st[name](c["y"], c["scales"], c["means"], None, 1),
        "dec_index_k": lambda: (st[name](c["scales"], 0),
                                st[name](c["scales"], 1)),
        "dec_restore_acc": lambda: (
            st[name](c["sym"], c["means"], None, 0),
            st[name](c["sym"], c["means"], c["so_far"], 1)),
        "finalize_qstep": lambda: (st[name](c["so_far"], c["means"],
                                            c["q_step"], c["scales"]),),
        "enc_pass0_video": lambda: st[name](c["y"], c["prior"]),
        "dec_index0_video": lambda: (st[name](c["prior"]),),
        "dec_restore0_video": lambda: (st[name](c["sym"], c["prior"]),),
        "finalize_video": lambda: (st[name](c["so_far"], c["prior"]),),
    }
    out = calls[name]()
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["enc_pass0_qstep", "enc_pass_k",
                                  "dec_index_k", "dec_restore_acc",
                                  "finalize_qstep", "enc_pass0_video",
                                  "dec_index0_video", "dec_restore0_video",
                                  "finalize_video"])
def test_two_part_stage_matches_jax(name, dtype):
    """Every stage of make_pass_stages(cfg, 2), on both tables: integers
    and floats equal to the JAX package's (elementwise math on the same
    values), outputs of JAX's dtypes."""
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else \
        (BF, jnp.bfloat16)
    for i, dist in enumerate(("gaussian", "laplace")):
        cfg = gaussian_cfg(_ge(dist))
        a = _pass_inputs(40 + 10 * i)
        got = _pass_call(name, PPS.make_pass_stages(cfg, 2), a,
                         lambda v: _nchw(v, tdt))
        want = _pass_call(name, JPS.make_pass_stages(cfg, 2), a,
                          lambda v: jnp.asarray(v, jdt))
        assert len(got) == len(want)
        for j, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            g = g.permute(0, 2, 3, 1)
            assert g.shape == w.shape, (dist, j)
            if w.dtype in (np.int16, np.uint8):
                assert g.numpy().dtype == w.dtype, (dist, j)
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"{dist} {j}")
            else:
                assert g.dtype == tdt, (dist, j)
                np.testing.assert_array_equal(g.float().numpy(), _np(w),
                                              err_msg=f"{dist} {j}")


# ---------------------------------------------------------------------------
# weights, init and the rate ladder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return {"intra": JI.IntraNoAR().init_params(seed=0),
            "hem": JH.DMCHEM().init_params(seed=1)}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


@pytest.mark.parametrize("codec", ["intra", "hem"])
def test_port_init_has_the_jax_layout(jax_params, codec):
    """The port's own init, carried to the JAX layout, has the JAX tree's
    keys and shapes; float32 leaves; flat anchors, as JAX's."""
    net = PI.IntraNoAR(device="cpu") if codec == "intra" else \
        PH.DMCHEM(device="cpu")
    tree = to_jax(net.init_params(seed=3))
    assert _shapes(tree) == _shapes(jax_params[codec])
    for leaf in jax.tree_util.tree_leaves(tree):
        assert leaf.dtype == np.float32
    name = "q_scale" if codec == "intra" else "y_q_scale"
    np.testing.assert_array_equal(tree[name], np.ones(4, np.float32))


@pytest.mark.parametrize("spread", [True, False], ids=["spread", "flat"])
def test_interpolated_q_scales_equal_jax(jax_params, spread):
    tree = dict(jax_params["hem"])
    if spread:
        tree["y_q_scale"] = jnp.asarray(ANCHORS)
        tree["mv_y_q_scale"] = jnp.asarray(ANCHORS[::-1])
    jnet = JH.DMCHEM()
    jnet.load_params(tree)
    pnet = PH.DMCHEM(device="cpu")
    pnet.load_params(from_jax(tree))
    for got, want in zip(pnet.get_q_scales(), jnet.get_q_scales()):
        np.testing.assert_array_equal(got, want)
    for rate_num in (2, 4, 6):
        for got, want in zip(pnet.get_interpolated_q_scales(rate_num),
                             jnet.get_interpolated_q_scales(rate_num)):
            assert len(got) == rate_num
            np.testing.assert_array_equal(got, want)


def test_codecs_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    for cls in (PI.IntraNoAR, PH.DMCHEM):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------

def _stage_cases(jp):
    """(name, port call, JAX call, integer output positions) of every stage
    function, on NHWC numpy inputs."""
    pi, ph = from_jax(jp["intra"]), from_jax(jp["hem"])
    ji, jh = jp["intra"], jp["hem"]
    x, ref = _rand(1, (1, H, W, 3), 0, 1), _rand(2, (1, H, W, 3), 0, 1)
    q_i = np.full((1, 1, 1, 192), 1.3, np.float32)
    mv_q = np.full((1, 1, 1, PH.CH_MV), 0.9, np.float32)
    y_q = np.full((1, 1, 1, PH.CH_M), 1.1, np.float32)
    z = np.round(_rand(3, (1, 1, 1, 192), -4, 4))
    z64 = np.round(_rand(4, (1, 1, 1, PH.CH_N), -4, 4))
    y_i = _rand(5, (1, 4, 4, 192), -3, 3)
    mv_hat = _rand(6, (1, H, W, 2), -2, 2)
    feat = _rand(7, (1, H, W, PH.CH_N), -1, 1)
    c = [_rand(8 + k, (1, H >> k, W >> k, PH.CH_N), -1, 1) for k in range(3)]
    ref_mv_y = _rand(11, (1, 4, 4, PH.CH_MV), -2, 2)
    ref_y = _rand(12, (1, 4, 4, PH.CH_M), -2, 2)
    y_hem = _rand(13, (1, 4, 4, PH.CH_M), -3, 3)
    sp = [_rand(14 + k, (1, 4, 4, PH.CH_MV), 0.3, 2) for k in range(4)]
    P, J = _nchw, jnp.asarray
    return {
        "intra_enc_front": (lambda: PI._stage_enc_front(pi, P(x), P(q_i)),
                            lambda: JI._stage_enc_front(ji, J(x), J(q_i)),
                            (2,)),
        "intra_prior": (lambda: PI._stage_prior(pi, P(z)),
                        lambda: JI._stage_prior(ji, J(z)), ()),
        "intra_spatial": (
            lambda: PI._stage_spatial(pi, P(y_i), P(y_i) * 0.5,
                                      P(y_i).abs(), P(y_i).abs() + 0.5),
            lambda: JI._stage_spatial(ji, J(y_i), J(y_i) * 0.5,
                                      jnp.abs(J(y_i)),
                                      jnp.abs(J(y_i)) + 0.5), ()),
        "intra_recon": (lambda: (PI._stage_recon(pi, P(y_i), P(q_i)),),
                        lambda: (JI._stage_recon(ji, J(y_i), J(q_i)),), ()),
        "hem_mv_enc": (lambda: PH._stage_mv_enc(ph, P(x), P(ref), P(mv_q)),
                       lambda: JH._stage_mv_enc(jh, J(x), J(ref), J(mv_q)),
                       (2,)),
        "hem_mv_prior": (lambda: PH._stage_mv_prior(ph, P(z64), P(ref_mv_y)),
                         lambda: JH._stage_mv_prior(jh, J(z64), J(ref_mv_y)),
                         ()),
        "hem_mv_prior_first": (
            lambda: PH._stage_mv_prior(ph, P(z64), None),
            lambda: JH._stage_mv_prior(jh, J(z64), jnp.zeros(
                (1, 4, 4, PH.CH_MV))), ()),
        "hem_motion_comp_i": (
            lambda: PH._stage_motion_comp(ph, P(mv_hat), P(ref), None),
            lambda: JH._stage_motion_comp(jh, J(mv_hat), J(ref), None), ()),
        "hem_motion_comp_p": (
            lambda: PH._stage_motion_comp(ph, P(mv_hat), P(ref), P(feat)),
            lambda: JH._stage_motion_comp(jh, J(mv_hat), J(ref), J(feat)),
            ()),
        "hem_ctx_enc": (
            lambda: PH._stage_ctx_enc(ph, P(x), *map(P, c), P(y_q)),
            lambda: JH._stage_ctx_enc(jh, J(x), *map(J, c), J(y_q)), (2,)),
        "hem_ctx_prior": (
            lambda: PH._stage_ctx_prior(ph, P(z64), P(c[2]), P(ref_y)),
            lambda: JH._stage_ctx_prior(jh, J(z64), J(c[2]), J(ref_y)), ()),
        "hem_ctx_prior_first": (
            lambda: PH._stage_ctx_prior(ph, P(z64), P(c[2]), None),
            lambda: JH._stage_ctx_prior(jh, J(z64), J(c[2]), jnp.zeros(
                (1, 4, 4, PH.CH_M))), ()),
        "hem_mv_spatial": (
            lambda: PH._stage_spatial(ph["mv_y_spatial_prior"],
                                      *map(P, sp)),
            lambda: JH._stage_spatial(jh["mv_y_spatial_prior"],
                                      *map(J, sp)), ()),
        "hem_mv_dec": (lambda: (PH._stage_mv_dec(ph, P(ref_mv_y)),),
                       lambda: (JH._stage_mv_dec(jh, J(ref_mv_y)),), ()),
        "hem_recon": (lambda: PH._stage_recon(ph, P(y_hem), *map(P, c)),
                      lambda: JH._stage_recon(jh, J(y_hem), *map(J, c)),
                      ()),
    }


STAGES = ["intra_enc_front", "intra_prior", "intra_spatial", "intra_recon",
          "hem_mv_enc", "hem_mv_prior", "hem_mv_prior_first",
          "hem_motion_comp_i", "hem_motion_comp_p", "hem_ctx_enc",
          "hem_ctx_prior", "hem_ctx_prior_first", "hem_mv_spatial",
          "hem_mv_dec", "hem_recon"]


@pytest.fixture(scope="module")
def stage_cases(jax_params):
    return _stage_cases(jax_params)


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_jax(stage_cases, name):
    port_fn, jax_fn, ints = stage_cases[name]
    with torch.no_grad():
        got = port_fn()
    want = jax_fn()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = _nhwc(g) if g.dtype != torch.int8 else \
            g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, (name, i)
        if i in ints:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {i}")
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=STAGE_RTOL * float(np.abs(w).max()),
                err_msg=f"{name} {i}")


# ---------------------------------------------------------------------------
# the chain: an IntraNoAR I-frame, then HEM P-frames
# ---------------------------------------------------------------------------

def _frames(n):
    rng = np.random.default_rng(H + 1)
    tex = rng.random((1, H, W + 2 * n + 2, 3), dtype=np.float32)
    return [np.clip(tex[:, :, 2 * t:2 * t + W]
                    + rng.normal(0, 0.02, (1, H, W, 3)).astype(np.float32),
                    0, 1) for t in range(n + 1)]


def _jax_codec(cls, tree, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = cls(**kw)
        net.load_params(tree)
        net.update()
    return net


def _port_codec(cls, tree, **kw):
    net = cls(device="cpu", **kw)
    net.load_params(from_jax(tree))
    net.update()
    return net


def _spread(tree):
    tree = dict(tree)
    tree["y_q_scale"] = jnp.asarray(ANCHORS)
    tree["mv_y_q_scale"] = jnp.asarray(ANCHORS)
    return tree


def _dpb_np(dpb):
    """A DPB as NHWC float32 numpy (None kept)."""
    out = {}
    for k in DPB_KEYS:
        v = dpb[k]
        if isinstance(v, torch.Tensor):
            v = (v if k == "ref_frame" else v.permute(0, 2, 3, 1)).float() \
                .numpy()
        out[k] = None if v is None else _np(v)
    return out


def _dpb_jax(dpb, jdtype):
    return {k: None if v is None else jnp.asarray(v, jdtype)
            for k, v in _dpb_np(dpb).items()}


def _symbols(planes):
    return [p.astype(np.int32) >> 8 if p.dtype == np.int16 else
            p.astype(np.int32) for p in planes]


def _shares(coded, kind):
    return {n: float((a == b).mean()) for n, a, b in zip(
        TIES.PLANES[kind][1], _symbols(coded["port"]),
        _symbols(coded["jax"]))}


def _run_chain(jp, dtype=torch.float32):
    """The port's encoders drive the chain; the JAX encoders code each
    frame from the port's references, and in float32 each package decodes
    the other's streams."""
    f32 = dtype == torch.float32
    jdtype = jnp.float32 if f32 else jnp.bfloat16
    xs = _frames(N_P)
    hem_tree = _spread(jp["hem"])
    pe_i = _port_codec(PI.IntraNoAR, jp["intra"], dtype=dtype)
    pd_i = _port_codec(PI.IntraNoAR, jp["intra"], dtype=dtype)
    je_i = _jax_codec(JI.IntraNoAR, jp["intra"], dtype=jdtype)
    pe = _port_codec(PH.DMCHEM, hem_tree, dtype=dtype)
    pd = _port_codec(PH.DMCHEM, hem_tree, dtype=dtype)
    je = _jax_codec(JH.DMCHEM, hem_tree, dtype=jdtype)
    jd_i = _jax_codec(JI.IntraNoAR, jp["intra"]) if f32 else None
    jd = _jax_codec(JH.DMCHEM, hem_tree) if f32 else None
    y_l, mv_l = pe.get_interpolated_q_scales(4)
    yq, mvq = float(y_l[1]), float(mv_l[1])
    coded = {"port": [], "jax": []}
    for net, log in ((pe_i, coded["port"]), (pe, coded["port"]),
                     (je_i, coded["jax"]), (je, coded["jax"])):
        TIES.record_coded(net, log)
    out = {k: [] for k in ("kind", "port_stream", "jax_stream", "ties",
                           "exact", "port_enc", "port_dec", "jax_dec",
                           "port_dec_jax", "shares", "dtypes")}

    def frame(kind, po, jo, floats, jax_dec, port_dec_jax,
              enc_np):
        js = jo["bit_stream"]
        out["kind"].append(kind)
        out["port_stream"].append(po["bit_stream"])
        out["jax_stream"].append(js)
        out["shares"].append(_shares(coded, kind))
        tie = None
        if f32 and js != po["bit_stream"]:
            tie = TIES.first_differing_plane(coded["port"], coded["jax"],
                                             floats.take(kind), kind)
        else:
            floats.take(kind)
        coded["port"].clear()
        coded["jax"].clear()
        out["ties"].append(tie)
        out["port_enc"].append(enc_np)
        if f32:
            out["jax_dec"].append(jax_dec())
            out["port_dec_jax"].append(None if tie else port_dec_jax(js))

    with TIES.PreRoundingFloats() as floats:
        floats.on = True
        po = pe_i.compress(xs[0], 1.0)
        floats.on = False
        jo = je_i.compress(jnp.asarray(xs[0], jdtype), 1.0)
        d = pd_i.decompress(po["bit_stream"], H, W, 1.0)["x_hat"]
        out["exact"].append(torch.equal(d, po["x_hat"]))
        out["dtypes"].append({po["x_hat"].dtype, d.dtype})
        frame("noar", po, jo, floats, lambda: {"ref_frame": _np(
                  jd_i.decompress(po["bit_stream"], H, W, 1.0)["x_hat"])},
              lambda js: {"ref_frame": _port_codec(
                  PI.IntraNoAR, jp["intra"]).decompress(js, H, W, 1.0)[
                      "x_hat"].numpy()},
              {"ref_frame": po["x_hat"].float().numpy()})
        enc_dpb = dec_dpb = {"ref_frame": po["x_hat"], "ref_feature": None,
                             "ref_y": None, "ref_mv_y": None}
        for t in range(1, N_P + 1):
            floats.on = True
            po = pe.compress(xs[t], enc_dpb, mvq, yq)
            floats.on = False
            new_dec = pd.decompress(dec_dpb, po["bit_stream"], H, W, mvq,
                                    yq)["dpb"]
            out["exact"].append(all(torch.equal(po["dpb"][k], new_dec[k])
                                    for k in DPB_KEYS))
            out["dtypes"].append({v.dtype for v in po["dpb"].values()}
                                 | {v.dtype for v in new_dec.values()})
            jref = _dpb_jax(enc_dpb, jdtype)
            jo = je.compress(jnp.asarray(xs[t], jdtype), jref, mvq, yq)
            frame("hem", po, jo, floats,
                  lambda: _dpb_np(jd.decompress(
                      _dpb_jax(enc_dpb, jnp.float32), po["bit_stream"], H,
                      W, mvq, yq)["dpb"]),
                  lambda js: _dpb_np(_port_codec(PH.DMCHEM, hem_tree)
                                     .decompress(enc_dpb, js, H, W, mvq,
                                                 yq)["dpb"]),
                  _dpb_np(po["dpb"]))
            out["port_dec"].append(_dpb_np(new_dec))
            enc_dpb, dec_dpb = po["dpb"], new_dec
    return out


@pytest.fixture(scope="module")
def f32_run(jax_params):
    return _run_chain(jax_params)


@pytest.fixture(scope="module")
def bf16_run(jax_params):
    return _run_chain(jax_params, dtype=BF)


def test_streams_match_jax(f32_run):
    r = f32_run
    assert r["kind"] == ["noar"] + ["hem"] * N_P
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
    r = f32_run
    assert all(r["exact"]), r["exact"]
    for t, dec in enumerate(r["port_dec"]):
        for k in DPB_KEYS:
            np.testing.assert_array_equal(dec[k], r["port_enc"][t + 1][k],
                                          err_msg=f"P-frame {t + 1} {k}")
    for d in r["dtypes"]:
        assert d == {torch.float32}, d


def test_each_side_decodes_the_others_streams(f32_run):
    r = f32_run
    for t in range(len(r["kind"])):
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
        print(f"frame {t} ({bf16_run['kind'][t]}): equal symbols {shares}")
        for plane, share in shares.items():
            assert share >= SYMBOL_SHARE, (t, plane, share)


def test_bf16_float32_reference_against_jax(jax_params):
    """A raw float32 reference frame before the bfloat16 DMCHEM: the port
    casts it (its DPB bfloat16), the JAX package keeps it (its encoder's
    DPB float32).  Held: the share of equal symbols per plane >=
    SYMBOL_SHARE, each DPB entry's share of values within RAW_REF_RTOL x
    max|ref| of JAX's >= RAW_REF_SHARE; printed: the JAX decoder's
    distance from its own encoder, whose priors run in bfloat16 (or that
    it cannot decode that stream at all)."""
    xs = _frames(1)
    tree = _spread(jax_params["hem"])
    pe = _port_codec(PH.DMCHEM, tree, dtype=BF)
    je, jd = (_jax_codec(JH.DMCHEM, tree, dtype=jnp.bfloat16)
              for _ in range(2))
    coded = {"port": [], "jax": []}
    TIES.record_coded(pe, coded["port"])
    TIES.record_coded(je, coded["jax"])
    y_l, mv_l = pe.get_interpolated_q_scales(4)
    yq, mvq = float(y_l[1]), float(mv_l[1])
    fresh = {"ref_frame": xs[0], "ref_feature": None, "ref_y": None,
             "ref_mv_y": None}
    po = pe.compress(xs[1], fresh, mvq, yq)
    jref = dict(fresh, ref_frame=jnp.asarray(xs[0]))
    jo = je.compress(jnp.asarray(xs[1]), jref, mvq, yq)
    try:
        jdec = _dpb_np(jd.decompress(jref, jo["bit_stream"], H, W, mvq,
                                     yq)["dpb"])
    except (IndexError, ValueError) as e:
        print(f"the JAX decoder cannot decode its own encoder's stream "
              f"({type(e).__name__}: {e})")
        jdec = None
    assert {v.dtype for v in po["dpb"].values()} == {BF}
    assert {v.dtype for v in jo["dpb"].values()} == {np.dtype(np.float32)}
    shares = _shares(coded, "hem")
    print(f"equal symbols {shares}")
    for plane, share in shares.items():
        assert share >= SYMBOL_SHARE, (plane, share)
    port, jenc = _dpb_np(po["dpb"]), _dpb_np(jo["dpb"])
    for k in DPB_KEYS:
        scale = float(np.abs(jenc[k]).max())
        err = np.abs(port[k] - jenc[k]) / scale
        close = float((err <= RAW_REF_RTOL).mean())
        own = "" if jdec is None else \
            f"; the JAX decoder vs its encoder max " \
            f"{float(np.abs(jdec[k] - jenc[k]).max()) / scale:.4g}"
        print(f"{k}: port vs JAX max {err.max():.4f} x max|ref|, "
              f"{close:.5f} within {RAW_REF_RTOL}{own}")
        assert close >= RAW_REF_SHARE, (k, close)
