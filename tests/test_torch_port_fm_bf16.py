"""DCVC-FM in bfloat16: the port (`dtype=torch.bfloat16` on DMCIFM and
DMCFM) against the JAX package (`dtype=jnp.bfloat16`), and against
itself.  The policy of `test_torch_port_bf16.py` (DCVC-RT): exact where
both packages round the same, stated tolerances where their bfloat16
differs, and the port's own chain exact.

Weights: the port's own float32 inits (torch.Generator; DMCIFM seed 0,
DMCFM seed 1) carried to the JAX layout with `to_jax`, so both packages
hold the same numbers without the JAX package's slow init.  FM keeps its
parameters in float32 in both packages (only the activations run in
bfloat16).  Frames: 64x64 from numpy's default_rng, a texture shifted
2 px a frame plus mild noise.  The JAX codecs code on the host with
their plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1 during update()).

Held exactly:
  * weight crossing: a JAX float32 FM tree, written by the JAX package's
    save_params and read by the port's JAX-free reader, in a bfloat16
    codec, bit for bit and float32; a bfloat16 codec's init equals the
    float32 codec's (no cast);
  * `bilinear_resize_2x` up (`jax.image.resize`: each axis summed in
    float32 and rounded once, the longer axis first; a wide and a tall
    input) and down,
    `flow_warp` (float32 inside, cast back), LeakyReLU (the slope rounded
    to bfloat16, as JAX's weak-typed product rounds it) and tanh on the
    same bfloat16 inputs;
  * the prior-stage passes (`make_pass_stages(cfg, 4)`): on the JAX
    codec's own bfloat16 inputs the packed symbols and CDF indexes, the
    decoder's indexes and restored values;
  * within the port: the decoder's DPB (all five entries, bfloat16)
    equals the encoder's after every frame on host EC and on device EC,
    host EC equals device EC, a 2-part stream (with and without worker
    threads, the same bytes) and the two-coder split decode to the same
    DPB.

Held to a tolerance:
  * `offset_diversity`'s mask sigmoid: SIGMOID_ULPS (XLA:CPU's bfloat16
    sigmoid is not correctly rounded; torch's is; the first run: 27.9 %
    of the outputs one or two ulps apart);
  * each stage of DMCIFM and DMCFM (an I-frame and two P-frames, the
    second with every reference) on the JAX codec's own bfloat16
    intermediates: the output dtypes are JAX's; float outputs within
    STAGE_RTOL x max|ref|; a reconstructed frame through its head
    output before the clamp, at that output's own scale, and the clamp
    of each package's head output equal to its frame bit for bit (a
    random-weight P-frame peaks at ~0.0027, so the clamp cuts most of
    the head's output and the frame's own max says nothing of the
    scale); z, rounded after convolutions, within 1 and
    unequal on at most STAGE_INT_SHARE of it (or one value); the packed
    symbols and indexes of the elementwise passes exact.  The first run
    measured 0-1.36 % (the heads 1.13-1.36 %; the clamped P-frames
    36-47 % of their own max); the bound is RT's;
  * the whole frames, each package's own encoder from the same frame and
    the port's DPB: the share of equal symbols per plane >= SYMBOL_SHARE
    (the first run: 98.8-100 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.layers import blocks as JB
from opendcvc_tpu.layers import blocks_evc as JE
from opendcvc_tpu.models import dmc_fm as JDMC
from opendcvc_tpu.models import dmci_fm as JDMCI
from opendcvc_tpu.ops import warp as JW
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.eval import fm_ties as TIES
from opendcvc_tpu_torch.layers import blocks as PB
from opendcvc_tpu_torch.layers import blocks_evc as PE
from opendcvc_tpu_torch.models import common as PC
from opendcvc_tpu_torch.models import dmc_fm as PDMC
from opendcvc_tpu_torch.models import dmci_fm as PDMCI
from opendcvc_tpu_torch.ops import warp as PW
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

BF = torch.bfloat16
H = W = 64
QP = 21
P_FA = [0, 1]          # the P-frames' fa_idx (the first from the I-frame)
DPB_KEYS = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y",
            "ref_mv_y")
SIGMOID_ULPS = 2
STAGE_RTOL = 2.0 ** -4
STAGE_INT_SHARE = 0.01
SYMBOL_SHARE = 0.9


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _ulps(a, b):
    def ordered(u):
        u = u.astype(np.int64)
        return np.where(u < 0x8000, u, 0x8000 - u)
    return np.abs(ordered(_bits(a)) - ordered(_bits(b)))


def _nchw(a):
    """A JAX NHWC array -> a port NCHW tensor of its dtype and bits."""
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(BF)
    return torch.from_numpy(a.copy())


def _nhwc(t):
    """A port tensor -> numpy NHWC (4-D) in float32, or its ints."""
    if t.ndim == 4:
        t = t.permute(0, 2, 3, 1)
    return (t.float() if t.dtype == BF else t).contiguous().numpy()


def _jnp(t, nhwc=False):
    """A port tensor -> a JAX array of its dtype and bits (NCHW -> NHWC
    unless it is NHWC already)."""
    if t.ndim == 4 and not nhwc:
        t = t.permute(0, 2, 3, 1)
    t = t.contiguous()
    if t.dtype == BF:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _frames(n):
    rng = np.random.default_rng(W)
    tex = rng.random((1, H, W + 2 * n + 2, 3), dtype=np.float32)
    return [np.clip(tex[:, :, 2 * t:2 * t + W]
                    + rng.normal(0, 0.02, (1, H, W, 3)).astype(np.float32),
                    0, 1) for t in range(n + 1)]


def _fresh(frame):
    return {"ref_frame": frame, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


def _to_jax_dpb(dpb):
    return {k: None if v is None else _jnp(v, nhwc=k == "ref_frame")
            for k, v in dpb.items()}


@pytest.fixture(scope="module")
def weights():
    trees = {"i": PDMCI.DMCIFM(device="cpu").init_params(seed=0),
             "p": PDMC.DMCFM(device="cpu").init_params(seed=1)}
    return {"port": trees, "jax": {k: to_jax(v) for k, v in trees.items()}}


# ---------------------------------------------------------------------------
# weights, exact
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("codec", ["i", "p"])
def test_fm_float32_tree_into_bf16_codec_bit_exact(weights, codec,
                                                   tmp_path):
    """A JAX float32 FM tree through save_params and the port's reader
    into a bfloat16 codec: every leaf float32, bit for bit; the bfloat16
    codec's own init equals the float32 codec's."""
    cls, seed = ((PDMCI.DMCIFM, 0) if codec == "i" else (PDMC.DMCFM, 1))
    path = str(tmp_path / f"{codec}.msgpack")
    JCK.save_params(path, weights["jax"][codec])
    net = cls(device="cpu", dtype=BF)
    net.load_params(from_jax(PCK.load_params(path)))
    got = dict(_leaves(to_jax(net.params)))
    want = dict(_leaves(weights["jax"][codec]))
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == np.float32, name
        np.testing.assert_array_equal(got[name].view(np.uint32),
                                      np.asarray(w).view(np.uint32),
                                      err_msg=name)
    own = dict(_leaves(net.init_params(seed=seed)))
    for name, t in dict(_leaves(weights["port"][codec])).items():
        assert own[name].dtype == torch.float32
        assert torch.equal(own[name], t), name


# ---------------------------------------------------------------------------
# ops on the same bfloat16 inputs
# ---------------------------------------------------------------------------

def _bf16_pair(rng, shape, scale=1.0):
    a = jnp.asarray(rng.normal(0, scale, shape).astype(np.float32),
                    jnp.bfloat16)
    return a, _nchw(a)


def _flow_warp_pair(rng):
    xj, xp = _bf16_pair(rng, (2, 16, 24, 8))
    fj, fp = _bf16_pair(rng, (2, 16, 24, 2), 5.0)
    return JW.flow_warp(xj, fj), PW.flow_warp(xp, fp)


OPS = {  # name: (fn(rng) -> (jax out, port out), max ulps)
    "flow_warp": (_flow_warp_pair, 0),
    "resize_up": (lambda r: (lambda a: (
        JW.bilinear_resize_2x(a[0], up=True),
        PW.bilinear_resize_2x(a[1], up=True)))(
            _bf16_pair(r, (1, 8, 12, 16), 4.0)), 0),
    "resize_up_tall": (lambda r: (lambda a: (
        JW.bilinear_resize_2x(a[0], up=True),
        PW.bilinear_resize_2x(a[1], up=True)))(
            _bf16_pair(r, (1, 12, 8, 16), 4.0)), 0),
    "resize_down": (lambda r: (lambda a: (
        JW.bilinear_resize_2x(a[0], up=False),
        PW.bilinear_resize_2x(a[1], up=False)))(
            _bf16_pair(r, (1, 8, 12, 16), 4.0)), 0),
    "lrelu_0.01": (lambda r: (lambda a: (JE.lrelu(a[0], 0.01),
                                         PE.lrelu(a[1], 0.01)))(
        _bf16_pair(r, (1, 8, 8, 64), 3.0)), 0),
    "lrelu_0.1": (lambda r: (lambda a: (JE.lrelu(a[0], 0.1),
                                        PE.lrelu(a[1], 0.1)))(
        _bf16_pair(r, (1, 8, 8, 64), 3.0)), 0),
    "tanh": (lambda r: (lambda a: (jnp.tanh(a[0]), torch.tanh(a[1])))(
        _bf16_pair(r, (1, 8, 8, 64), 2.0)), 0),
    "sigmoid": (lambda r: (lambda a: (jax.nn.sigmoid(a[0]),
                                      torch.sigmoid(a[1])))(
        _bf16_pair(r, (1, 8, 8, 64), 8.0)), SIGMOID_ULPS),
}


@pytest.mark.parametrize("name", list(OPS))
def test_fm_op_matches_jax(name):
    fn, max_ulps = OPS[name]
    want, got = fn(np.random.default_rng(sorted(OPS).index(name)))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF
    ulps = _ulps(_nchw(want), got)
    print(f"{name}: max {ulps.max()} ulps, {(ulps > 0).mean():.4f} unequal")
    assert ulps.max() <= max_ulps


# ---------------------------------------------------------------------------
# each stage and the whole frames against the JAX package
# ---------------------------------------------------------------------------

def _jax_codec(cls, tree):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = cls(dtype=jnp.bfloat16)
        net.load_params(tree)
        net.update()
    assert not net.device_ec
    return net


def _port_codec(cls, tree, **kw):
    net = cls(device="cpu", dtype=BF, **kw)
    net.load_params(tree)
    net.update()
    return net


def _ifm_pass0(st):
    def fn(y, q_enc, scales, means, cfg):
        y_s = y * q_enc
        return (y_s,) + st["enc_pass_k"](y_s, scales, means, None, 0)
    return fn


def _ifm_pass(st):
    def fn(y_s, scales, means, so_far, k, cfg):
        return st["enc_pass_k"](y_s, scales, means, so_far, k)
    return fn


def _ifm_head_jax(p, y_hat_so_far, q_dec_prior, qp):
    y_hat = y_hat_so_far * q_dec_prior
    q_dec = p["q_scale_dec"][qp][None, None, None, :].astype(y_hat.dtype)
    return JDMCI.refine(p, JDMCI.intra_decoder(p, y_hat, q_dec))


def _ifm_head_port(p, y_hat_so_far, q_dec_prior, qp):
    y_hat = y_hat_so_far * q_dec_prior
    return PDMCI.refine(p, PDMCI.intra_decoder(
        p, y_hat, PC.q_vec(p["q_scale_dec"], qp, y_hat.dtype)))


#: the stages whose first output is a frame, clamped to [0, 1]: each
#: package's head output before the clamp, from the stage's arguments
#: and outputs, (JAX, port).  A random-weight frame is near black (max
#: ~0.002): the clamp cuts most of the head's output, so the frame is
#: held through the head output at its own scale (the clamp moves no
#: value further apart).
PRE_CLAMP = {
    "ifm.recon": (lambda args, outs: jax.jit(_ifm_head_jax)(*args),
                  lambda args, outs: _ifm_head_port(*args)),
    "fm.recon": (lambda args, outs: jax.jit(JB.conv_apply,
                                            static_argnames="padding")(
                     args[0]["recon"]["head"], outs[1], padding=1),
                 lambda args, outs: PB.conv_apply(
                     args[0]["recon"]["head"], outs[1], padding=1)),
}


def _port_stages(st_i, st_p):
    """Stage name -> (port function of the JAX stage's arguments, the
    output indexes rounded after convolutions, the packed outputs)."""
    PI, PF = PDMCI, PDMC
    return {
        "ifm.enc_front": (PI._stage_enc_front, (1, 2), ()),
        "ifm.prior": (PI._stage_prior, (), ()),
        "ifm.enc_pass0": (_ifm_pass0(st_i), (), (1,)),
        "ifm.spatial": (PI._stage_spatial, (), ()),
        "ifm.enc_pass": (_ifm_pass(st_i), (), (0,)),
        "ifm.recon": (PI._stage_recon, (), ()),
        "fm.mv_enc_i": (lambda p, x, rf, qi: PF._stage_mv_enc(
            p, x, rf, None, qi), (1, 2), ()),
        "fm.mv_enc": (PF._stage_mv_enc, (1, 2), ()),
        "fm.mv_prior_i": (lambda p, z, yh, yw: PF._stage_mv_prior(
            p, z, None, yh, yw), (), ()),
        "fm.mv_prior": (PF._stage_mv_prior, (), ()),
        "fm.mv_dec": (PF._stage_mv_dec, (), ()),
        "fm.motion_comp_i": (lambda p, mv, rf, fa: PF._stage_motion_comp(
            p, mv, rf, None, fa), (), ()),
        "fm.motion_comp": (PF._stage_motion_comp, (), ()),
        "fm.ctx_enc": (PF._stage_ctx_enc, (1, 2), ()),
        "fm.ctx_prior_i": (lambda p, z, c3, yh, yw: PF._stage_ctx_prior(
            p, z, c3, None, yh, yw), (), ()),
        "fm.ctx_prior": (PF._stage_ctx_prior, (), ()),
        "fm.mv_spatial": (PF._stage_mv_spatial, (), ()),
        "fm.y_spatial": (PF._stage_y_spatial, (), ()),
        "fm.recon": (PF._stage_recon, (), ()),
        "fm.enc_pass0_video": (st_p["enc_pass0_video"], (), (1,)),
        "fm.enc_pass_k": (st_p["enc_pass_k"], (), (0,)),
        "fm.finalize_video": (st_p["finalize_video"], (), ()),
    }


#: the JAX codecs' jitted stages, by attribute: (codec, stage name)
JAX_ATTRS = {
    "i": {"_j_enc_front": "ifm.enc_front", "_j_prior": "ifm.prior",
          "_j_enc_pass0": "ifm.enc_pass0", "_j_spatial": "ifm.spatial",
          "_j_enc_pass": "ifm.enc_pass", "_j_recon": "ifm.recon"},
    "p": {"_j_mv_enc_i": "fm.mv_enc_i", "_j_mv_enc": "fm.mv_enc",
          "_j_mv_prior_i": "fm.mv_prior_i", "_j_mv_prior": "fm.mv_prior",
          "_j_mv_dec": "fm.mv_dec", "_j_motion_comp_i": "fm.motion_comp_i",
          "_j_motion_comp": "fm.motion_comp", "_j_ctx_enc": "fm.ctx_enc",
          "_j_ctx_prior_i": "fm.ctx_prior_i",
          "_j_ctx_prior": "fm.ctx_prior", "_j_mv_spatial": "fm.mv_spatial",
          "_j_y_spatial": "fm.y_spatial", "_j_recon": "fm.recon"},
}
PASS_STAGES = ("enc_pass0_video", "enc_pass_k", "finalize_video")

#: (frame, stage) of every stage the whole frames run
STAGES = ([("I", n) for n in JAX_ATTRS["i"].values()]
          + [(f, n) for f in ("P1", "P2") for n in
             ("fm.mv_prior", "fm.mv_dec", "fm.ctx_enc", "fm.mv_spatial",
              "fm.y_spatial", "fm.recon", "fm.enc_pass0_video",
              "fm.enc_pass_k", "fm.finalize_video")]
          + [("P1", n) for n in ("fm.mv_enc_i", "fm.motion_comp_i",
                                 "fm.ctx_prior_i")]
          + [("P2", n) for n in ("fm.mv_enc", "fm.motion_comp",
                                 "fm.ctx_prior")])
STAGES = [(f, "fm.mv_prior_i" if (f, n) == ("P1", "fm.mv_prior") else n)
          for f, n in STAGES]


def _record(net, attrs, calls, frame, stages=None):
    """Wrap the JAX codec's jitted stages: each call appends (args,
    outputs) under (the current frame, the stage's name)."""
    def wrap(name, fn):
        def call(*args):
            out = fn(*args)
            calls.setdefault((frame[0], name), []).append(
                (args, out if isinstance(out, tuple) else (out,)))
            return out
        return call

    for attr, name in attrs.items():
        setattr(net, attr, wrap(name, getattr(net, attr)))
    for name in stages or ():
        net._stages[name] = wrap(f"fm.{name}", net._stages[name])


def _symbols(planes):
    return [p.astype(np.int32) >> 8 if p.dtype == np.int16 else
            p.astype(np.int32) for p in planes]


@pytest.fixture(scope="module")
def run(weights):
    """An I-frame and two P-frames: the port's bfloat16 encoders drive the
    chain, the JAX package's code each frame from the port's DPB with
    every jitted stage recorded."""
    xs = _frames(len(P_FA))
    pi = _port_codec(PDMCI.DMCIFM, weights["port"]["i"])
    pp = _port_codec(PDMC.DMCFM, weights["port"]["p"])
    ji = _jax_codec(JDMCI.DMCIFM, weights["jax"]["i"])
    jp = _jax_codec(JDMC.DMCFM, weights["jax"]["p"])
    calls, frame = {}, ["I"]
    _record(ji, JAX_ATTRS["i"], calls, frame)
    _record(jp, JAX_ATTRS["p"], calls, frame, PASS_STAGES)
    coded = {"port": [], "jax": []}
    for port_net, jax_net in ((pi, ji), (pp, jp)):
        TIES.record_coded(port_net, coded["port"])
        TIES.record_coded(jax_net, coded["jax"])
    shares = {}

    def take(label, kind):
        shares[label] = {
            n: float((a == b).mean()) for n, a, b in zip(
                TIES.PLANES[kind][1], _symbols(coded["port"]),
                _symbols(coded["jax"]))}
        coded["port"].clear()
        coded["jax"].clear()

    pe = pi.compress(xs[0], QP)
    ji.compress(jnp.asarray(xs[0]), QP)
    take("I", "i")
    dpb = _fresh(pe["x_hat"])
    for t, (fa, x) in enumerate(zip(P_FA, xs[1:]), 1):
        frame[0] = f"P{t}"
        po = pp.compress(x, dpb, QP, fa)
        jp.compress(jnp.asarray(x), _to_jax_dpb(dpb), QP, fa)
        take(frame[0], "p")
        dpb = po["dpb"]
    return {"calls": calls, "shares": shares,
            "stages": _port_stages(pi._stages, pp._stages),
            "port_passes": pp._stages, "jax_stages": jp._stages}


def _port_args(args, params):
    out = []
    for a in args:
        if isinstance(a, dict):
            out.append(params)
        elif isinstance(a, jax.Array) and a.ndim == 0:
            out.append(int(a))
        elif isinstance(a, (jax.Array, np.ndarray)) and a.ndim:
            out.append(_nchw(a))
        else:
            out.append(a)
    return out


def _flat(outs, packed):
    flat = []
    for i, o in enumerate(outs):
        if i in packed:
            a = (_nhwc(o) if isinstance(o, torch.Tensor)
                 else np.asarray(o)).astype(np.int32)
            flat.extend([a >> 8, a & 255])
        else:
            flat.append(o)
    return flat


def _check_pre_clamp(name, args, got, want, params):
    """The frame output's head before the clamp, both packages: the clamp
    of each equals the stage's frame bit for bit, and the port's is
    within STAGE_RTOL x max|ref| of JAX's.  Returns that error."""
    jax_fn, port_fn = PRE_CLAMP[name]
    pre_w = jax_fn(args, want)
    pre_g = port_fn(_port_args(args, params), got)
    np.testing.assert_array_equal(_bits(jnp.clip(pre_w, 0.0, 1.0)),
                                  _bits(want[0]))
    assert torch.equal(torch.clamp(pre_g, 0.0, 1.0), got[0])
    w = _f32(pre_w)
    return np.abs(_nhwc(pre_g) - w).max() / np.abs(w).max()


@pytest.mark.parametrize("frame,name", STAGES,
                         ids=[f"{f}-{n}" for f, n in STAGES])
def test_fm_stage_matches_jax(run, weights, frame, name):
    """Output dtypes equal JAX's; floats within STAGE_RTOL x max|ref|
    (a frame: its head output before the clamp, at that output's own
    scale); z within 1 and unequal on at most STAGE_INT_SHARE; symbols
    and indexes exact; every call of the stage in that frame."""
    fn, rounded, packed = run["stages"][name]
    calls = run["calls"][(frame, name)]
    params = weights["port"]["i" if name.startswith("ifm") else "p"]
    for args, want in calls:
        got = fn(*_port_args(args, params))
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        head_err = (_check_pre_clamp(name, args, got, want, params)
                    if name in PRE_CLAMP else None)
        got, want = _flat(got, packed), _flat(want, packed)
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(g, torch.Tensor):
                assert (g.dtype == BF) == (np.asarray(w).dtype.name
                                           == "bfloat16"), (name, i)
                g = _nhwc(g)
            w = _f32(w) if np.asarray(w).dtype.name == "bfloat16" \
                else np.asarray(w)
            assert g.shape == w.shape, (name, i)
            if i in rounded:
                assert np.abs(g - w).max() <= 1, (name, i)
                assert (g != w).sum() <= max(1, STAGE_INT_SHARE * g.size)
            elif g.dtype.kind == "f":
                err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
                if head_err is not None and i == 0:
                    print(f"{frame} {name} frame: head before the clamp "
                          f"max |diff| / max|ref| {head_err:.4f} (the "
                          f"clamped frame's {err:.4f}, max|ref| "
                          f"{np.abs(w).max():.4g})")
                    err = head_err
                else:
                    print(f"{frame} {name} output {i}: max |diff| / "
                          f"max|ref| {err:.4f}")
                assert err <= STAGE_RTOL, (name, i, err)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {i}")


def _same_bits(port, jax_array):
    np.testing.assert_array_equal(_bits(port.permute(0, 2, 3, 1)),
                                  _bits(jax_array))


@pytest.mark.parametrize("frame", ["P1", "P2"])
def test_fm_prior_stage_passes_equal_jax(run, frame):
    """The decoder's passes on the JAX encoder's bfloat16 inputs: each
    pass's CDF indexes, the restored latent and the final y_hat equal the
    JAX package's, for the motion and the contextual latent."""
    jst, pst = run["jax_stages"], run["port_passes"]
    pass0 = run["calls"][(frame, "fm.enc_pass0_video")]
    passes = run["calls"][(frame, "fm.enc_pass_k")]
    assert len(pass0) == 2 and len(passes) == 6
    for lat, ((_, prior), (_, pk0, _)) in enumerate(pass0):
        pp = _nchw(prior)
        np.testing.assert_array_equal(
            _nhwc(pst["dec_index0_video"](pp)),
            np.asarray(jst["dec_index0_video"](prior)))
        sym = jnp.asarray(np.asarray(pk0).astype(np.int32) >> 8,
                          jnp.bfloat16)
        acc_j = jst["dec_restore0_video"](sym, prior)
        acc_p = pst["dec_restore0_video"](_nchw(sym), pp)
        _same_bits(acc_p, acc_j)
        for k, ((_, scales, means, _, kk), (pk, _)) in enumerate(
                passes[3 * lat:3 * lat + 3], 1):
            assert kk == k
            np.testing.assert_array_equal(
                _nhwc(pst["dec_index_k"](_nchw(scales), k)),
                np.asarray(jst["dec_index_k"](scales, k)))
            sym = jnp.asarray(np.asarray(pk).astype(np.int32) >> 8,
                              jnp.bfloat16)
            acc_j = jst["dec_restore_acc"](sym, means, acc_j, k)
            acc_p = pst["dec_restore_acc"](_nchw(sym), _nchw(means), acc_p,
                                           k)
            _same_bits(acc_p, acc_j)
        fin_p = pst["finalize_video"](acc_p, pp)
        assert fin_p.dtype == BF
        _same_bits(fin_p, jst["finalize_video"](acc_j, prior))


def test_fm_whole_frames_symbols_close_to_jax(run):
    for label, shares in run["shares"].items():
        print(f"{label}: equal symbols {shares}")
        for plane, share in shares.items():
            assert share >= SYMBOL_SHARE, (label, plane, share)


# ---------------------------------------------------------------------------
# within the port, bfloat16, exact
# ---------------------------------------------------------------------------

# (fa_idx, refresh before the frame) of each P-frame of the port's chain
CHAIN = [(0, False), (1, False), (2, True)]


def _chain(weights, device_ec, stream_part=1, ec_thread=False,
           two_coders=False):
    """I + 3 P-frames encoded, then decoded by fresh codecs."""
    xs = _frames(len(CHAIN))
    kw = {"device_ec": device_ec}
    pkw = dict(kw, stream_part=stream_part, ec_thread=ec_thread)
    ie, id_ = (_port_codec(PDMCI.DMCIFM, weights["port"]["i"], **kw)
               for _ in range(2))
    pe, pd = (_port_codec(PDMC.DMCFM, weights["port"]["p"], **pkw)
              for _ in range(2))
    if two_coders:
        for net in (ie, id_, pe, pd):
            net.set_use_two_entropy_coders(True)
    e0 = ie.compress(xs[0], QP)
    d0 = id_.decompress(e0["bit_stream"], {"height": H, "width": W,
                                           "qp": QP})
    out = {"streams": [e0["bit_stream"]], "enc": [_fresh(e0["x_hat"])],
           "dec": [_fresh(d0["x_hat"])]}
    enc, dec = out["enc"][0], out["dec"][0]
    for (fa, refresh), x in zip(CHAIN, xs[1:]):
        if refresh:
            enc, dec = _fresh(enc["ref_frame"]), _fresh(dec["ref_frame"])
        o = pe.compress(x, enc, QP, fa)
        dec = pd.decompress(o["bit_stream"], dec, {"height": H, "width": W,
                                                   "qp": QP,
                                                   "fa_idx": fa})["dpb"]
        enc = o["dpb"]
        out["streams"].append(o["bit_stream"])
        out["enc"].append(enc)
        out["dec"].append(dec)
    return out


@pytest.fixture(scope="module")
def chains(weights):
    return {ec: _chain(weights, ec == "device_ec")
            for ec in ("host_ec", "device_ec")}


def _same_dpbs(a, b):
    for t, (x, y) in enumerate(zip(a, b)):
        for k in DPB_KEYS:
            if x[k] is None or y[k] is None:
                assert x[k] is None and y[k] is None, (t, k)
                continue
            assert x[k].dtype == BF and y[k].dtype == BF, (t, k)
            assert torch.equal(x[k], y[k]), (t, k)


@pytest.mark.parametrize("ec", ["host_ec", "device_ec"])
def test_fm_bf16_chain_exact(chains, ec):
    c = chains[ec]
    _same_dpbs(c["dec"], c["enc"])
    assert all(c["enc"][t][k] is not None for t in (1, 2) for k in DPB_KEYS)


def test_fm_bf16_host_ec_equals_device_ec(chains):
    h, d = chains["host_ec"], chains["device_ec"]
    _same_dpbs(h["enc"], d["enc"])
    _same_dpbs(h["dec"], d["dec"])
    assert h["streams"] != d["streams"]


@pytest.mark.parametrize("ec_thread", [False, True],
                         ids=["one_thread", "ec_thread"])
def test_fm_bf16_two_parts_decode_the_same_dpb(chains, weights, ec_thread):
    c = _chain(weights, False, stream_part=2, ec_thread=ec_thread)
    _same_dpbs(c["dec"], chains["host_ec"]["dec"])
    _same_dpbs(c["enc"], chains["host_ec"]["enc"])
    for s in c["streams"][1:]:
        assert (s[0] >> 4) + 1 == 2
    if ec_thread:
        assert c["streams"] == _chain(weights, False,
                                      stream_part=2)["streams"]


def test_fm_bf16_two_coders_decode_the_same_dpb(chains, weights):
    c = _chain(weights, False, two_coders=True)
    _same_dpbs(c["dec"], chains["host_ec"]["dec"])
    assert c["streams"] != chains["host_ec"]["streams"]


def test_fm_bf16_params_stay_float32(weights):
    """A bfloat16 codec casts no parameter: its tree is the float32 init
    it loaded."""
    net = _port_codec(PDMC.DMCFM, weights["port"]["p"])
    assert {t.dtype for _, t in _leaves(net.params)} == {torch.float32}
