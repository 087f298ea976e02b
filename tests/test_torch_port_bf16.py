"""DCVC-RT in bfloat16: the port (`dtype=torch.bfloat16` on DMC and DMCI)
against the JAX package (`dtype=jnp.bfloat16`), and against itself.

Weights: the port's own float32 init (torch.Generator, seeds 0 and 1;
DMCI at the JAX package's reduced widths `TINY_KW`, DMC at its only,
full widths), carried to the JAX layout (`_to_jax`), so both packages
hold the same numbers without the JAX package's slow init.  Inputs are
64x64 frames from numpy's default_rng.

Held exactly:
  * weight crossing: a JAX bfloat16 tree through `from_jax`, a bfloat16
    `save_params` file (also with a chunked leaf) through the port's
    JAX-free reader, and
    `cast_floating` against JAX's `astype`, bit for bit on every leaf;
  * `round_and_to_int8`, `process_with_mask` (force_zero_thres None and
    0.12), `build_index_enc` / `build_index_dec` and the checkerboard
    masks on the same bfloat16 inputs;
  * the z CDF tables of a bfloat16 DMC and DMCI (the BitEstimator
    samples the CDF in float64 from the bfloat16 params on both sides);
  * within the port: the DMCI round trip, the decoder's feature after
    every P-frame of an I + 3 P chain, host EC == device EC, GOP ==
    per-frame, batch == single, and a float32 checkpoint in a bfloat16
    codec == the same weights cast to bfloat16 (x_hats and features).

Held to a tolerance, because the two packages' bfloat16 differs:
  * `conv_apply` (1x1, 3x3, depthwise 3x3, 3x3 stride 2, 2x2 stride 2;
    bfloat16 and float32 weights): CONV_ULPS on at most CONV_SHARE of the
    outputs.  Both accumulate in float32 and round to bfloat16, then add
    the bias and round again; only the order of the sums differs;
  * sigmoid: SIGMOID_ULPS.  XLA:CPU's bfloat16 sigmoid is not the
    correctly rounded value on about a quarter of its inputs (the first
    run: 27 % off by one ulp, 0.24 % by two); torch's is the correctly
    rounded one.  `wsilu` (x * sigmoid(4x)):
    WSILU_ULPS, the sigmoid's ulp carried through the product and its
    rounding; `wsilu_chunk_add`: that on each addend plus the sum's
    rounding;
  * each stage of DMC and DMCI on the same bfloat16 inputs (the JAX
    codec's own intermediates): the output dtypes are JAX's; float
    outputs within STAGE_RTOL * max|ref|; z, rounded after convolutions,
    within 1 and unequal on at most STAGE_INT_SHARE of it (or one value);
    symbols, indexes and keep masks of the elementwise passes exact.  Each
    block adds its sums' and its sigmoid's roundings, so the difference
    grows with a stage's depth: the first run measured 0.13-1.15 % of
    max|ref| for stages of 1-7 blocks and 3.52 % for DMCI's recon (14
    blocks); the bound, 2^-4, was set from that run;
  * the whole frame, each package's own encoder from the same frame and
    reference: the share of equal symbols per plane >= SYMBOL_SHARE.
    A symbol flips when its residual lies within the two packages'
    difference (a few % of |y|, compounded over 20-30 blocks) of a
    rounding boundary; the first run measured 94.8-100 % per plane.
    The x_hat max |diff| is printed, not bounded: with random weights a
    few flipped symbols move the recon by up to 0.75 (DMCI, first run).
Stream parity with the JAX package stays a float32 contract (the other
port test files).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization as flax_ser
from opendcvc_tpu.entropy import models as JM
from opendcvc_tpu.eval.rd_evidence import TINY_KW
from opendcvc_tpu.layers import blocks as JL
from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu.ops import fused as JF
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.layers import blocks as PL
from opendcvc_tpu_torch.models import common as PC
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.ops import fused as PF
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import cast_floating, from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

BF = torch.bfloat16
H = W = 64
QP = 21
FZS = [None, 0.12]
FZ_IDS = ["fz_none", "fz_0.12"]
SPS = {"height": H, "width": W, "ec_part": 0}
CONV_ULPS, CONV_SHARE = 1, 1e-3
SIGMOID_ULPS = 2
WSILU_ULPS = 2 * SIGMOID_ULPS + 1
STAGE_RTOL = 2.0 ** -4
STAGE_INT_SHARE = 0.01
SYMBOL_SHARE = 0.9


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _jax_cast(tree):
    """The JAX package's init rule: float32 leaves -> bfloat16."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16)
        if jnp.asarray(a).dtype == jnp.float32 else jnp.asarray(a), tree)


def _bits(a):
    """bfloat16 array or tensor -> its uint16 bit patterns (numpy)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _ulps(a, b):
    """|a - b| in bfloat16 ulps, elementwise, through the ordered bit
    patterns (0 for +0 and -0)."""
    def ordered(u):
        u = u.astype(np.int64)
        return np.where(u < 0x8000, u, 0x8000 - u)
    return np.abs(ordered(_bits(a)) - ordered(_bits(b)))


def _nhwc(t):
    """A port tensor -> numpy NHWC (4-D) in float32, or its ints."""
    if t.ndim == 4:
        t = t.permute(0, 2, 3, 1)
    if t.dtype == BF:
        t = t.float()
    return t.numpy()


def _nchw(a):
    """A JAX NHWC array -> a port NCHW tensor of the same dtype."""
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(BF)
    return torch.from_numpy(a.copy())


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module")
def weights():
    """The port's float32 inits: DMCI (TINY_KW, seed 0), DMC (seed 1)."""
    return {"i": PDMCI.DMCI(device="cpu", **TINY_KW).init_params(seed=0),
            "p": PDMC.DMC(device="cpu").init_params(seed=1)}


def _frames(n=4):
    """n frames, each a small random step from the last."""
    rng = np.random.default_rng(0)
    out = [rng.random((1, H, W, 3), dtype=np.float32)]
    for _ in range(n - 1):
        out.append(np.clip(out[-1] + rng.normal(0, 0.02, out[-1].shape)
                           .astype(np.float32), 0, 1))
    return out


# ---------------------------------------------------------------------------
# weight crossing, exact
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_same_bits(port_tree, jax_tree):
    """Every port leaf has the JAX leaf's dtype and bits (conv weights
    compared in the JAX layout)."""
    got = dict(_leaves(_to_jax(port_tree)))
    want = dict(_leaves(jax_tree))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert g.dtype.name == w.dtype.name and g.shape == w.shape, path
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=path)


def _to_jax(tree):
    """A port parameter tree -> the JAX layout (conv weights OIHW ->
    HWIO) as numpy in each leaf's own dtype, bfloat16 as jnp.bfloat16."""
    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        t = node
        if key == "w" and t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        t = t.contiguous()
        if t.dtype == BF:
            return np.asarray(_bits(t)).view(jnp.bfloat16)
        return t.numpy()
    return conv(tree)


def test_from_jax_takes_bf16_tree_bit_exact(weights):
    tree = _jax_cast(_to_jax(weights["i"]))
    port = from_jax(tree)
    assert port["enc_down"]["w"].dtype == BF
    assert port["enc_down"]["w"].is_contiguous()
    _assert_same_bits(port, tree)


def test_bf16_checkpoint_reads_back_bit_exact(weights, tmp_path):
    """A file written by the JAX package's save_params from a bfloat16
    tree (with an int32 leaf beside it) reads back bit for bit."""
    tree = _jax_cast(_to_jax(weights["p"]))
    tree["counts"] = jnp.arange(5, dtype=jnp.int32)
    path = str(tmp_path / "dmc_bf16.msgpack")
    JCK.save_params(path, tree)
    raw = PCK.load_params(path)
    assert raw["q_encoder"].dtype == BF        # no numpy bfloat16 needed
    assert raw["counts"].dtype == np.int32
    _assert_same_bits(from_jax(raw), tree)


def test_chunked_bf16_leaf_reads_back_bit_exact(tmp_path, monkeypatch):
    """A bfloat16 leaf over flax's chunk size (made small here) arrives in
    flat chunks, joined back bit for bit."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    big = jnp.asarray(np.random.default_rng(6).normal(size=(4, 25))
                      .astype(np.float32), jnp.bfloat16)
    path = str(tmp_path / "chunked.msgpack")
    JCK.save_params(path, {"big": big})
    got = PCK.load_params(path)["big"]
    assert got.dtype == BF and got.shape == (4, 25)
    np.testing.assert_array_equal(_bits(got), _bits(big))


def test_cast_floating_matches_jax_astype(weights):
    """cast_floating against JAX's astype, bit for bit on every leaf;
    integer leaves stay as they are."""
    tree = _to_jax(weights["p"])
    tree["counts"] = np.arange(5, dtype=np.int32)
    port = cast_floating(from_jax(tree), BF)
    assert port["counts"].dtype == torch.int32
    _assert_same_bits(port, _jax_cast(tree))


def test_codec_init_casts_to_its_dtype(weights):
    """init_params draws in float32 and casts: the bfloat16 codec's
    params are the float32 codec's cast."""
    for net, ref in ((PDMC.DMC(device="cpu", dtype=BF), weights["p"]),
                     (PDMCI.DMCI(device="cpu", dtype=BF, **TINY_KW),
                      weights["i"])):
        got = net.init_params(seed=1 if isinstance(net, PDMC.DMC) else 0)
        _assert_same_bits(got, _to_jax(cast_floating(ref, BF)))


# ---------------------------------------------------------------------------
# ops against the JAX package in bfloat16
# ---------------------------------------------------------------------------

def _bf16_pair(rng, shape, scale=1.0):
    """The same bfloat16 values as a JAX NHWC array and a port NCHW
    tensor; shape is NHWC."""
    a = jnp.asarray(rng.normal(0, scale, shape).astype(np.float32),
                    jnp.bfloat16)
    return a, _nchw(a)


CONVS = {  # name: (in, out, k, stride, padding, groups)
    "1x1": (32, 48, 1, 1, 0, 1),
    "3x3": (16, 24, 3, 1, 1, 1),
    "depthwise_3x3": (32, 32, 3, 1, 1, 32),
    "3x3_stride2": (32, 16, 3, 2, 1, 1),
    "2x2_stride2": (32, 32, 2, 2, 0, 1),
}


@pytest.mark.parametrize("w_dtype", ["bf16", "f32"],
                         ids=["bf16_weights", "f32_weights"])
@pytest.mark.parametrize("name", list(CONVS))
def test_conv_apply_matches_jax(name, w_dtype):
    """Within CONV_ULPS on at most CONV_SHARE of the outputs; float32
    weights on a bfloat16 input are cast first, so they give the bfloat16
    weights' result exactly."""
    cin, cout, k, stride, pad, groups = CONVS[name]
    rng = np.random.default_rng(1)
    xj, xp = _bf16_pair(rng, (1, 16, 16, cin))
    bound = 1.0 / np.sqrt(cin // groups * k * k)
    w = rng.uniform(-bound, bound, (k, k, cin // groups, cout)) \
        .astype(np.float32)
    b = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
    p32 = {"w": w, "b": b}
    pj = p32 if w_dtype == "f32" else _jax_cast(p32)
    pp = from_jax(pj)
    want = JL.conv_apply(pj, xj, stride=stride, padding=pad, groups=groups)
    got = PL.conv_apply(pp, xp, stride=stride, padding=pad, groups=groups)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF
    ulps = _ulps(_nchw(want), got)
    assert ulps.max() <= CONV_ULPS
    assert (ulps > 0).mean() <= CONV_SHARE
    if w_dtype == "f32":
        cast = PL.conv_apply(cast_floating(pp, BF), xp, stride=stride,
                             padding=pad, groups=groups)
        assert torch.equal(got, cast)


def _ulp(v):
    """The bfloat16 ulp at |v| (float64 numpy; subnormal spacing at 0)."""
    v = np.abs(np.asarray(v, np.float64))
    e = np.floor(np.log2(np.maximum(v, 2.0 ** -126)))
    return np.ldexp(1.0, (e - 7).astype(np.int64))


def test_sigmoid_within_one_ulp_of_jax():
    """XLA:CPU's bfloat16 sigmoid vs torch's: SIGMOID_ULPS."""
    xj, xp = _bf16_pair(np.random.default_rng(2), (1, 16, 16, 64), 8.0)
    assert _ulps(_nchw(jax.nn.sigmoid(xj)), torch.sigmoid(xp)).max() \
        <= SIGMOID_ULPS


def test_wsilu_matches_jax():
    """x * sigmoid(4x): the sigmoids differ by SIGMOID_ULPS, which moves
    the exact product by at most 2 ulps of it; each side rounds it once
    (WSILU_ULPS)."""
    xj, xp = _bf16_pair(np.random.default_rng(2), (1, 16, 16, 64), 2.0)
    want, got = JL.wsilu(xj), PL.wsilu(xp)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert _ulps(_nchw(want), got).max() <= WSILU_ULPS


def test_wsilu_chunk_add_matches_jax():
    """WSiLU's halves summed: each addend within WSILU_ULPS of its own
    value, the sum rounded once more, so |diff| <= WSILU_ULPS (ulp(a) +
    ulp(b)) + ulp(a + b), with a and b JAX's halves."""
    xj, xp = _bf16_pair(np.random.default_rng(2), (1, 16, 16, 64), 2.0)
    want, got = JL.wsilu_chunk_add(xj), PL.wsilu_chunk_add(xp)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    halves = _f32(JL.wsilu(xj))
    a, b = halves[..., :32], halves[..., 32:]
    ref = _f32(want)
    bound = WSILU_ULPS * (_ulp(a) + _ulp(b)) + _ulp(ref)
    assert (np.abs(_nhwc(got) - ref) <= bound).all()


def test_round_and_to_int8_matches_jax():
    rng = np.random.default_rng(3)
    xj, xp = _bf16_pair(rng, (1, 8, 8, 16), 60.0)
    # halves and values past the int8 range
    xj = xj.at[0, 0, 0, :4].set(jnp.asarray([0.5, 1.5, -2.5, 300.0],
                                             jnp.bfloat16))
    xp = _nchw(xj)
    jh, ji = JF.round_and_to_int8(xj)
    ph, pi = PF.round_and_to_int8(xp)
    assert ph.dtype == BF and pi.dtype == torch.int8
    np.testing.assert_array_equal(_bits(ph), _bits(_nchw(jh)))
    np.testing.assert_array_equal(pi.numpy(), _nchw(ji).numpy())


@pytest.mark.parametrize("fz", FZS, ids=FZ_IDS)
@pytest.mark.parametrize("kind", ["2x", "4x"])
def test_process_with_mask_matches_jax(kind, fz):
    """Masks built in bfloat16, the masked quantization with the rounding
    and the force-zero comparison in float32: every output exact."""
    rng = np.random.default_rng(4)
    c = 16
    yj, yp = _bf16_pair(rng, (1, 8, 8, c), 3.0)
    sj, sp = _bf16_pair(rng, (1, 8, 8, c), 0.3)
    sj, sp = jnp.abs(sj), sp.abs()
    mj, mp = _bf16_pair(rng, (1, 8, 8, c))
    jm = getattr(JF, f"checkerboard_masks_{kind}")(8, 8, c, jnp.bfloat16)
    pm = getattr(PF, f"checkerboard_masks_{kind}")(8, 8, c, BF)
    for a, b in zip(jm, pm):
        assert b.dtype == BF
        np.testing.assert_array_equal(_bits(b), _bits(_nchw(a)))
    want = JF.process_with_mask(yj, sj, mj, jm[1], fz)
    got = PF.process_with_mask(yp, sp, mp, pm[1], fz)
    for g, w in zip(got, want):
        assert g.dtype == BF and w.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(g), _bits(_nchw(w)))


@pytest.mark.parametrize("fz", FZS, ids=FZ_IDS)
def test_build_index_matches_jax(fz):
    """The CDF index (a float32 log of the bfloat16 scale, truncated) and
    the packed symbols, exact."""
    rng = np.random.default_rng(5)
    sj = jnp.asarray(np.exp(rng.uniform(-3, 4, (1, 8, 8, 16)))
                     .astype(np.float32), jnp.bfloat16)
    sym = rng.integers(-128, 128, (1, 8, 8, 16)).astype(np.int8)
    cfg = PDMC._GE_IDX_CFG
    jd = JF.build_index_dec(sj, *cfg, fz)
    pd = PF.build_index_dec(_nchw(sj), *cfg[:3], float(cfg[3]), fz)
    je = JF.build_index_enc(jnp.asarray(sym), sj, *cfg, fz)
    pe = PF.build_index_enc(_nchw(sym), _nchw(sj), *cfg[:3], float(cfg[3]),
                            fz)
    for (gi, gk), (wi, wk) in ((pd, jd), (pe, je)):
        np.testing.assert_array_equal(_nhwc(gi), np.asarray(wi))
        if fz is None:
            assert gk is None and wk is None
        else:
            np.testing.assert_array_equal(_nhwc(gk), np.asarray(wk))


# ---------------------------------------------------------------------------
# z CDF tables
# ---------------------------------------------------------------------------

class _TableSink:
    """Stands in for the JAX package's entropy coder: takes the rows."""

    def add_cdf(self, *args, **kwargs):
        return 0


@pytest.mark.parametrize("codec", ["DMC", "DMCI"])
def test_z_cdf_tables_equal_jax(codec, weights):
    key = "p" if codec == "DMC" else "i"
    qp_num = PC.QP_NUM + (PDMC.EXTRA_QP if codec == "DMC" else 0)
    channel = 128 if codec == "DMC" else TINY_KW["z_channel"]
    params = cast_floating(weights[key], BF)["bit_estimator_z"]
    port = PDMC.BitEstimator(qp_num, channel)
    port.update(params)
    ref = JM.BitEstimator(qp_num, channel)
    ref.update(_jax_cast(_to_jax(weights[key]))["bit_estimator_z"],
               _TableSink())
    assert len(port.cdf_info) == len(ref.cdf_info) == 3
    for a, b in zip(port.cdf_info, ref.cdf_info):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# each stage against the JAX package
# ---------------------------------------------------------------------------

def _packed(t):
    """JAX's packed int16 (sym << 8 | idx) -> (symbols, indexes)."""
    a = np.asarray(t).astype(np.int32)
    return a >> 8, a & 255


def _stage_chain(trees):
    """Run the JAX codecs' stages in bfloat16, each on the previous ones'
    outputs; returns {stage: (jax fn, port fn, args, jax outputs, indexes
    of the outputs rounded after convolutions)}.  Args hold "P" where the codec's params go (trees
    ["dmc"] or ["dmci"], by the stage's name); the outputs are flat
    tuples, a packed plane split into symbols and indexes."""
    frames = _frames(2)
    x_ref = jnp.asarray(frames[0], jnp.bfloat16)
    x = jnp.asarray(frames[1], jnp.bfloat16)
    q, fz = np.int32(QP), 0.12
    out = {}

    def run(name, jfn, pfn, args, split=(), rounded=()):
        res = _jax_call(jfn, args, trees[name.split(".")[0]])
        flat = []
        for i, r in enumerate(res):
            flat.extend(_packed(r) if i in split else [r])
        out[name] = (jfn, pfn, args, tuple(flat), rounded)
        return res

    feat, = run("dmc.adaptor_i", JDMC._stage_adaptor_i,
                PDMC._stage_adaptor_i, ["P", x_ref])
    fa, = run("dmc.adaptor_p", JDMC._stage_adaptor_p,
              PDMC._stage_adaptor_p, ["P", feat])
    x1, ctx_t = run("dmc.fe_part1", JDMC._stage_fe_part1,
                    PDMC._stage_fe_part1, ["P", fa, q])
    ctx, = run("dmc.fe_part2", JDMC._stage_fe_part2, PDMC._stage_fe_part2,
               ["P", x1])
    y, z_hat, _ = run("dmc.encode_y", JDMC._stage_encode_y,
                      PDMC._stage_encode_y, ["P", x, ctx, q],
                      rounded=(1, 2))
    prior, = run("dmc.prior", JDMC._stage_prior, PDMC._stage_prior,
                 ["P", z_hat, ctx_t])
    y_div, _, _, y_hat_0 = run("dmc.enc_pass0", JDMC._stage_enc_pass0,
                               PDMC._stage_enc_pass0, [y, prior, fz],
                               split=(1,))
    sc, me = run("dmc.spatial", JDMC._stage_spatial, PDMC._stage_spatial,
                 ["P", y_hat_0, prior])
    _, _, y_hat_1 = run("dmc.enc_pass1", JDMC._stage_enc_pass1,
                        PDMC._stage_enc_pass1, [y_div, sc, me, fz],
                        split=(0,))
    f_out, = run("dmc.feature_out", JDMC._stage_feature_out,
                 PDMC._stage_feature_out,
                 ["P", y_hat_0, y_hat_1, prior, ctx, q])
    run("dmc.recon_x", JDMC._stage_recon_x, PDMC._stage_recon_x,
        ["P", f_out, q])

    y, z_hat, _ = run("dmci.enc_front", JDMCI._stage_enc_front,
                      PDMCI._stage_enc_front, ["P", x, q],
                      rounded=(1, 2))
    q_enc, q_dec, sc, me, red = run(
        "dmci.prior", JDMCI._stage_prior, PDMCI._stage_prior,
        ["P", z_hat, y.shape[1], y.shape[2]])
    y_s = y * q_enc
    _, _, so_far = run("dmci.enc_pass0", JDMCI._stage_enc_pass,
                       PDMCI._stage_enc_pass, [y_s, sc, me, None, 0, fz],
                       split=(0,))
    sc, me = run("dmci.spatial", JDMCI._stage_spatial, PDMCI._stage_spatial,
                 ["P", 1, so_far, red])
    _, _, so_far = run("dmci.enc_pass1", JDMCI._stage_enc_pass,
                       PDMCI._stage_enc_pass, [y_s, sc, me, so_far, 1, fz],
                       split=(0,))
    run("dmci.recon", JDMCI._stage_recon, PDMCI._stage_recon,
        ["P", so_far, q_dec, q])
    return out


def _is_array(a):
    return isinstance(a, jax.Array)


def _jax_fn(jfn, args):
    """jfn as a function of (params, *arrays) with every other argument
    (qp, sizes, k, force_zero_thres) bound, as the codecs' jit binds
    them static."""
    def fn(params, *arrays):
        it = iter(arrays)
        return jfn(*[params if a == "P" else next(it) if _is_array(a)
                     else a for a in args])
    return fn


def _jax_call(jfn, args, params):
    res = jax.jit(_jax_fn(jfn, args))(params,
                                      *[a for a in args if _is_array(a)])
    return res if isinstance(res, tuple) else (res,)


@pytest.fixture(scope="module")
def stages(weights):
    trees = {"dmc": _jax_cast(_to_jax(weights["p"])),
             "dmci": _jax_cast(_to_jax(weights["i"]))}
    return _stage_chain(trees), {"dmc": cast_floating(weights["p"], BF),
                                 "dmci": cast_floating(weights["i"], BF)}


STAGES = ["dmc.adaptor_i", "dmc.adaptor_p", "dmc.fe_part1", "dmc.fe_part2",
          "dmc.encode_y", "dmc.prior", "dmc.enc_pass0", "dmc.spatial",
          "dmc.enc_pass1", "dmc.feature_out", "dmc.recon_x",
          "dmci.enc_front", "dmci.prior", "dmci.enc_pass0", "dmci.spatial",
          "dmci.enc_pass1", "dmci.recon"]


def _run_port(name, chain, params):
    """The port's stage on the JAX stage's inputs (NCHW), its outputs
    as a flat tuple."""
    _, pfn, args, _, _ = chain[name]
    p = params[name.split(".")[0]]
    res = pfn(*[p if a == "P" else _nchw(a) if _is_array(a)
                else int(a) if isinstance(a, np.integer) else a
                for a in args])
    return res if isinstance(res, tuple) else (res,)


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_jax(name, stages):
    """Output dtypes equal JAX's; floats within STAGE_RTOL * max|ref|;
    values rounded after convolutions (z) within 1, and unequal on at
    most STAGE_INT_SHARE of them (or one); the outputs of elementwise steps on equal inputs (symbols, indexes, keep
    masks) exact."""
    chain, params = stages
    _, _, _, want, rounded = chain[name]
    got = _run_port(name, chain, params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert (g.dtype == BF) == (w.dtype.name == "bfloat16"), (name, i)
        assert (g.dtype == torch.bool) == (w.dtype == bool), (name, i)
        g, w = _nhwc(g), _f32(w)
        assert g.shape == w.shape, (name, i)
        if i in rounded:
            assert np.abs(g - w).max() <= 1, (name, i)
            assert (g != w).sum() <= max(1, STAGE_INT_SHARE * g.size), \
                (name, i)
        elif g.dtype == np.float32:
            err = np.abs(g - w).max() / np.abs(w).max()
            print(f"{name} output {i}: max |diff| / max|ref| {err:.4f}")
            assert err <= STAGE_RTOL, (name, i, err)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {i}")


@pytest.mark.parametrize("name", STAGES)
def test_stage_dtypes_with_float32_weights(name, stages, weights):
    """A float32 checkpoint in a bfloat16 codec (the harness's case): the
    JAX stage's output dtypes (traced, not run) are the port's, and the
    port's outputs equal those from the weights cast to bfloat16."""
    chain, params = stages
    jfn, _, args, _, _ = chain[name]
    raw = {"dmc": weights["p"], "dmci": weights["i"]}
    key = name.split(".")[0]
    shapes = jax.eval_shape(_jax_fn(jfn, args), _to_jax(raw[key]),
                            *[a for a in args if _is_array(a)])
    shapes = shapes if isinstance(shapes, tuple) else (shapes,)
    got = _run_port(name, chain, raw)
    floats = [s.dtype for s in shapes if jnp.issubdtype(s.dtype,
                                                       jnp.floating)]
    assert floats and set(floats) == {jnp.dtype(jnp.bfloat16)}
    assert [g.dtype for g in got if g.is_floating_point()] == \
        [BF] * len(floats)
    for g, c in zip(got, _run_port(name, chain, params)):
        assert torch.equal(g, c)


# ---------------------------------------------------------------------------
# whole frames against the JAX package
# ---------------------------------------------------------------------------

def _jax_encode_i(jp, x, fz):
    """The JAX DMCI host-EC compress's stages: (x_hat, z int8, packed
    planes y0..y3)."""
    q = np.int32(QP)
    y, z_hat, z_int8 = jax.jit(JDMCI._stage_enc_front)(jp, x, q)
    q_enc, q_dec, sc, me, red = jax.jit(
        JDMCI._stage_prior, static_argnums=(2, 3))(jp, z_hat, y.shape[1],
                                                   y.shape[2])
    y_s, pk, _, so_far = jax.jit(JDMCI._stage_enc_pass0,
                                 static_argnums=(4,))(y, q_enc, sc, me, fz)
    planes = [pk]
    for k in range(1, 4):
        sc, me = jax.jit(JDMCI._stage_spatial, static_argnums=(1,))(
            jp, k, so_far, red)
        pk, _, so_far = jax.jit(JDMCI._stage_enc_pass,
                                static_argnums=(4, 5))(y_s, sc, me, so_far,
                                                       k, fz)
        planes.append(pk)
    return jax.jit(JDMCI._stage_recon)(jp, so_far, q_dec, q), z_int8, planes


def _jax_encode_p(jp, x, x_ref, fz):
    """The JAX DMC host-EC compress's stages from a pixel reference:
    (feature, z int8, packed planes y0, y1)."""
    q = np.int32(QP)
    feat = jax.jit(JDMC._stage_adaptor_i)(jp, x_ref)
    x1, ctx_t = jax.jit(JDMC._stage_fe_part1)(jp, feat, q)
    ctx = jax.jit(JDMC._stage_fe_part2)(jp, x1)
    y, z_hat, z_int8 = jax.jit(JDMC._stage_encode_y)(jp, x, ctx, q)
    prior = jax.jit(JDMC._stage_prior)(jp, z_hat, ctx_t)
    y_div, pk0, _, y_hat_0 = jax.jit(JDMC._stage_enc_pass0,
                                     static_argnums=(2,))(y, prior, fz)
    sc1, me1 = jax.jit(JDMC._stage_spatial)(jp, y_hat_0, prior)
    pk1, _, y_hat_1 = jax.jit(JDMC._stage_enc_pass1,
                              static_argnums=(3,))(y_div, sc1, me1, fz)
    feat_out = jax.jit(JDMC._stage_feature_out)(jp, y_hat_0, y_hat_1, prior,
                                                ctx, q)
    return feat_out, z_int8, [pk0, pk1]


def _shares(z_port, planes_port, z_jax, planes_jax):
    out = {"z": float((_nhwc(z_port) == np.asarray(z_jax)).mean())}
    for k, ((sym, _, _), pk) in enumerate(zip(planes_port, planes_jax)):
        out[f"y{k}"] = float((_nhwc(sym) == _packed(pk)[0]).mean())
    return out


@pytest.mark.parametrize("fz", FZS, ids=FZ_IDS)
def test_whole_frames_against_jax(fz, weights):
    """Each package's own encoder, DMCI then a DMC P-frame from the same
    pixel reference: the share of equal symbols of every plane >=
    SYMBOL_SHARE; x_hat and feature differences are printed."""
    x0, x1 = _frames(2)
    pi, pp = (cast_floating(weights[k], BF) for k in ("i", "p"))
    ji, jp = (_jax_cast(_to_jax(weights[k])) for k in ("i", "p"))
    x_hat_j, z_j, planes_j = _jax_encode_i(ji, jnp.asarray(x0, jnp.bfloat16),
                                           fz)
    x_hat_p, z_p, planes_p = PDMCI._encode_stages_i(
        pi, PC.frame_to_nchw(x0, "cpu", BF), QP, fz)
    shares = {"I": _shares(z_p, planes_p, z_j, planes_j)}
    diffs = {"I x_hat": float(np.abs(_nhwc(x_hat_p) - _f32(x_hat_j)).max())}

    ref = x_hat_j          # one pixel reference for both P encoders
    f_j, z_j, planes_j = _jax_encode_p(jp, jnp.asarray(x1, jnp.bfloat16),
                                       ref, fz)
    f_p, z_p, planes_p = PDMC._encode_stages(
        pp, PC.frame_to_nchw(x1, "cpu", BF),
        PDMC._stage_adaptor_i(pp, _nchw(ref)), QP, fz)
    shares["P"] = _shares(z_p, planes_p, z_j, planes_j)
    f_ref = _f32(f_j)
    diffs["P feature / max|feature|"] = float(
        np.abs(_nhwc(f_p) - f_ref).max() / np.abs(f_ref).max())
    print(f"bf16 vs JAX, fz {fz}: equal symbols {shares}; {diffs}")
    for kind, s in shares.items():
        for plane, share in s.items():
            assert share >= SYMBOL_SHARE, (kind, plane, share)
    assert np.isfinite(list(diffs.values())).all()


# ---------------------------------------------------------------------------
# within the port, bfloat16, exact
# ---------------------------------------------------------------------------

def _codec(weights, kind, device_ec, fz, cast=True):
    """A bfloat16 DMCI ("i") or DMC ("p") on the CPU, its params the
    float32 init cast (or, cast=False, as they are)."""
    cls, kw = (PDMCI.DMCI, TINY_KW) if kind == "i" else (PDMC.DMC, {})
    net = cls(device="cpu", device_ec=device_ec, dtype=BF, **kw)
    net.load_params(cast_floating(weights[kind], BF) if cast
                    else weights[kind])
    net.update(force_zero_thres=fz)
    return net


def _chain(weights, device_ec, fz, **kw):
    """I + 3 P-frames encoded, then decoded by fresh codecs."""
    frames = _frames(4)
    enc_i, enc_p, dec_i, dec_p = (_codec(weights, k, device_ec, fz, **kw)
                                  for k in "ipip")
    e0 = enc_i.compress(frames[0], QP)
    enc_p.add_ref_frame(None, e0["x_hat"])
    streams, feats = [e0["bit_stream"]], []
    for x in frames[1:]:
        streams.append(enc_p.compress(x, QP)["bit_stream"])
        feats.append(enc_p.dpb[0].feature.clone())
    d0 = dec_i.decompress(streams[0], SPS, QP)
    dec_p.add_ref_frame(None, d0["x_hat"])
    dec_x, dec_f = [], []
    for s in streams[1:]:
        dec_x.append(dec_p.decompress(s, SPS, QP)["x_hat"])
        dec_f.append(dec_p.dpb[0].feature.clone())
    return {"streams": streams, "enc_x": e0["x_hat"], "dec_x0": d0["x_hat"],
            "feats": feats, "dec_x": dec_x, "dec_feats": dec_f,
            "recon": [PC.frame_to_nhwc(PDMC._stage_recon_x(
                enc_p.params, f, QP)) for f in feats]}


@pytest.fixture(scope="module", params=FZS, ids=FZ_IDS)
def chains(request, weights):
    fz = request.param
    return fz, {ec: _chain(weights, ec == "device_ec", fz)
                for ec in ("host_ec", "device_ec")}


@pytest.mark.parametrize("ec", ["host_ec", "device_ec"])
def test_chain_exact(chains, ec):
    """The decoded I-frame is the encoder's; after every P-frame the
    decoder's feature is the encoder's, and its frame the one the
    encoder's feature reconstructs; all bfloat16."""
    c = chains[1][ec]
    assert c["enc_x"].dtype == BF and c["feats"][0].dtype == BF
    assert torch.equal(c["dec_x0"], c["enc_x"])
    for t in range(3):
        assert torch.equal(c["dec_feats"][t], c["feats"][t]), t
        assert torch.equal(c["dec_x"][t], c["recon"][t]), t
        assert c["dec_x"][t].dtype == BF


def test_host_ec_equals_device_ec(chains):
    h, d = chains[1]["host_ec"], chains[1]["device_ec"]
    assert torch.equal(h["enc_x"], d["enc_x"])
    assert torch.equal(h["dec_x0"], d["dec_x0"])
    for t in range(3):
        assert torch.equal(h["feats"][t], d["feats"][t])
        assert torch.equal(h["dec_x"][t], d["dec_x"][t])


def test_gop_equals_per_frame(chains, weights):
    """Device EC: P-frame 1 alone, P-frames 2-3 as one GOP chunk; the
    streams, decodes and final features equal the per-frame chain's."""
    fz, c = chains[0], chains[1]["device_ec"]
    frames = _frames(4)
    enc_i, enc_p, dec_p = (_codec(weights, k, True, fz) for k in "ipp")
    enc_p.add_ref_frame(None, enc_i.compress(frames[0], QP)["x_hat"])
    assert enc_p.compress(frames[1], QP)["bit_stream"] == c["streams"][1]
    gop = enc_p.compress_gop(frames[2:], [QP, QP])["bit_streams"]
    assert gop == c["streams"][2:]
    assert torch.equal(enc_p.dpb[0].feature, c["feats"][-1])
    dec_p.add_ref_frame(None, c["dec_x0"])
    dec_p.decompress(c["streams"][1], SPS, QP)
    out = dec_p.decompress_gop(gop, SPS, [QP, QP])["x_hat"]
    for t in range(2):
        assert torch.equal(out[t], c["dec_x"][t + 1])
    assert torch.equal(dec_p.dpb[0].feature, c["dec_feats"][-1])


def test_batch_equals_single(chains, weights):
    """Device EC: compress_batch / decompress_batch of two frames equal
    compress / decompress frame by frame."""
    fz = chains[0]
    frames = _frames(2)
    net = _codec(weights, "i", True, fz)
    singles = [net.compress(x, QP) for x in frames]
    batch = net.compress_batch(frames, QP)
    assert batch["bit_streams"] == [s["bit_stream"] for s in singles]
    for t, s in enumerate(singles):
        assert torch.equal(batch["x_hat"][t], s["x_hat"])
    dec = net.decompress_batch(batch["bit_streams"], SPS, QP)["x_hat"]
    for t, s in enumerate(singles):
        assert torch.equal(dec[t], s["x_hat"])
        assert torch.equal(
            net.decompress(s["bit_stream"], SPS, QP)["x_hat"], dec[t])


def test_float32_weights_in_bf16_codec_equal_cast_weights(chains, weights):
    """The harness loads a float32 checkpoint into a bfloat16 codec
    without a cast; each convolution and qp bank casts per call, so the
    x_hats and features are those of the weights cast to bfloat16.  (The
    z CDF tables are sampled from the params as loaded, in float64, as
    the JAX package samples them, so the z bytes may differ.)"""
    fz, c = chains[0], chains[1]["host_ec"]
    raw = _chain(weights, False, fz, cast=False)
    assert torch.equal(raw["enc_x"], c["enc_x"])
    assert torch.equal(raw["dec_x0"], c["dec_x0"])
    for t in range(3):
        assert torch.equal(raw["feats"][t], c["feats"][t])
        assert torch.equal(raw["dec_feats"][t], raw["feats"][t])
        assert torch.equal(raw["dec_x"][t], c["dec_x"][t])
