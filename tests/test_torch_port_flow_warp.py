"""The bilinear warp (`ops/warp.py::flow_warp`): the CUDA kernel W1
(`csrc/flow_warp.cu`) against its plain twin `flow_warp_plain`.

On the CPU: the wrapper takes the twin for CPU tensors and W1 for CUDA
ones (under autograd through its autograd Function); it refuses CUDA
operands that W1 does not take, while the twin takes any floating dtype
and any strides; both refuse wrong shapes; the mask operand gives the bits of the warp times the
mask; W1's autograd Function, its launch computed here by the twin, gives
the twin's gradients bit for bit; `offset_diversity` with the mask folded
into the warp gives the bits it gave before (frozen here).  Tests marked
`card` hold W1 against the twin bit for bit at DCVC-FM's and DCVC-HEM's
1080p call shapes, on ragged planes, at and past the borders, on integer
flows, with and without the mask, and under autograd; they skip without
a card.  This file imports no JAX, so they run on a card's machine with

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_port_flow_warp.py
"""

import pytest
import torch

from opendcvc_tpu_torch.layers import blocks_fm as FM
from opendcvc_tpu_torch.layers.blocks import conv_apply, conv_init
from opendcvc_tpu_torch.models import dmc_fm as PDMC
from opendcvc_tpu_torch.ops import warp as W
from opendcvc_tpu_torch.utils import trace
from test_torch_port_dcb_epilogue import card  # noqa: F401  (fixture)
from test_torch_port_dcb_epilogue import _one_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["float32", "bfloat16"]

#: the main path's calls at 1080p (1088x1920): (units, C, H, W, masked)
MAIN_SHAPES = {
    "fm_ref_frame": (1, 3, 1088, 1920, False),
    "fm_c1_init": (1, 48, 1088, 1920, False),
    "fm_offset_diversity": (32, 3, 1088, 1920, True),
    "fm_c2": (1, 64, 544, 960, False),
    "fm_c3": (1, 96, 272, 480, False),
    "hem_c1": (1, 64, 1088, 1920, False),
    "hem_c2": (1, 64, 544, 960, False),
    "hem_c3": (1, 64, 272, 480, False),
}


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    iv = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
          torch.float16: torch.int16, torch.float64: torch.int64}[got.dtype]
    diff = got.contiguous().view(iv) != want.contiguous().view(iv)
    assert not bool(diff.any()), \
        f"{int(diff.sum())} of {got.numel()} elements differ"


def _gen(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def _operands(seed, units, c, h, w, dtype, device="cpu", mag=4.0,
              masked=True, kind="random"):
    """im, flow and mask (None unless masked).  kind: "random" (flows in
    +-mag), "integer" (whole pixels, so every weight is 0 or 1),
    "borders" (flows that land past every border and on it), "zero"."""
    g = _gen(seed, device)
    im = torch.randn((units, c, h, w), generator=g, device=device).to(dtype)
    u = torch.rand((units, 2, h, w), generator=g, device=device) * 2 - 1
    if kind == "random":
        flow = u * mag
    elif kind == "integer":
        flow = torch.round(u * mag)
    elif kind == "borders":
        flow = u * 3.0 * max(h, w)
        flow[:, 0, :, :1] = -1.0                      # x + dx = -1
        flow[:, 0, :, -1:] = 0.5                      # x + dx = w - 1/2
        flow[:, 1, :1] = 0.0                          # on the top row
        flow[:, 1, -1:] = 1.0                         # one past the bottom
    else:
        flow = torch.zeros_like(u)
    flow = flow.to(dtype)
    mask = None
    if masked:
        mask = torch.rand((units, 1, h, w), generator=g,
                          device=device).to(dtype)
    return im, flow, mask


# ---------------------------------------------------------------------------
# CPU: the wrapper
# ---------------------------------------------------------------------------

class _Cuda:
    """A stand-in operand that reports a CUDA device."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t, requires_grad=False):
        self.dtype, self.shape = t.dtype, t.shape
        self.requires_grad = requires_grad
        self._t = t

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()


def _counts():
    c = trace.counters()
    return tuple(c.get("warp." + k, 0) for k in ("call", "fused", "launch"))


def test_twin_on_the_cpu_and_w1_on_cuda(monkeypatch):
    """CPU tensors take the twin, under autograd too; a CUDA operand
    takes W1: its launch where autograd does not record, its autograd
    Function where it does.  `warp.call` counts every call, `warp.fused`
    those on W1."""
    calls = []
    monkeypatch.setattr(W, "flow_warp_plain",
                        lambda im, flow, mask=None: calls.append("twin"))
    monkeypatch.setattr(W, "_launch",
                        lambda im, flow, mask: calls.append("launch"))
    monkeypatch.setattr(W._WarpFn, "apply",
                        lambda im, flow, mask: calls.append("autograd"))
    im, flow, mask = _operands(0, 2, 3, 4, 8, torch.float32)
    before = _counts()
    W.flow_warp(im, flow)
    W.flow_warp(im.requires_grad_(), flow, mask)
    assert calls == ["twin", "twin"]
    assert _counts() == (before[0] + 2, before[1], before[2])
    del calls[:]
    for dtype in DTYPES:
        ci, cf, cm = (_Cuda(t.to(dtype)) for t in (im.detach(), flow, mask))
        W.flow_warp(ci, cf)
        W.flow_warp(ci, cf, cm)
        W.flow_warp(_Cuda(im.to(dtype), requires_grad=True), cf, cm)
        W.flow_warp(ci, _Cuda(flow.to(dtype), requires_grad=True))
        with torch.no_grad():
            W.flow_warp(_Cuda(im.to(dtype), requires_grad=True), cf)
    assert calls == ["launch", "launch", "autograd", "autograd",
                     "launch"] * 2
    assert _counts() == (before[0] + 12, before[1] + 10, before[2])


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64],
                         ids=["float16", "float64"])
def test_wrapper_refuses_other_dtypes(dtype, monkeypatch):
    """W1 takes float32 and bfloat16 alone, the mask in im's dtype: the
    wrapper refuses other CUDA operands before a launch.  The twin on the
    CPU takes them, as the plain warp always did."""
    monkeypatch.setattr(W, "_launch", lambda im, flow, mask: "launch")
    im, flow, mask = _operands(1, 1, 3, 4, 8, torch.float32)
    for args in ((im.to(dtype), flow), (im, flow.to(dtype)),
                 (im.to(dtype), flow.to(dtype), mask.to(dtype))):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            W.flow_warp(*(_Cuda(t) for t in args))
        _same_bits(W.flow_warp(*args), W.flow_warp_plain(*args))
    with pytest.raises(ValueError, match="mask must be"):
        W.flow_warp(_Cuda(im), _Cuda(flow), _Cuda(mask.to(dtype)))
    assert W.flow_warp(_Cuda(im), _Cuda(flow), _Cuda(mask)) == "launch"
    _same_bits(W.flow_warp(im, flow, mask.to(dtype)),
               W.flow_warp_plain(im, flow, mask.to(dtype)))


def test_wrapper_refuses_bad_operands(monkeypatch):
    """Non-contiguous CUDA operands are refused (W1 reads dense planes);
    the twin on the CPU takes any strides.  Wrong flow or mask shapes and
    an image that is not NCHW are refused on both paths."""
    monkeypatch.setattr(W, "_launch", lambda im, flow, mask: "launch")
    im, flow, mask = _operands(2, 2, 3, 4, 8, torch.float32)

    def strided(t):
        return t.transpose(2, 3).contiguous().transpose(2, 3)

    for args in ((strided(im), flow), (im, strided(flow)),
                 (im, flow, strided(mask))):
        with pytest.raises(ValueError, match="contiguous"):
            W.flow_warp(*(_Cuda(t) for t in args))
        _same_bits(W.flow_warp(*args),
                   W.flow_warp_plain(*(t.contiguous() for t in args)))
    for bad in (flow[:1], flow[:, :1], flow[..., :4], flow[:, :, :2]):
        for wrap in (lambda t: t, _Cuda):
            with pytest.raises(ValueError, match="flow must be"):
                W.flow_warp(wrap(im), wrap(bad.contiguous()))
    for bad in (mask[:1], torch.cat((mask, mask), 1), mask[..., :4]):
        for wrap in (lambda t: t, _Cuda):
            with pytest.raises(ValueError, match="mask must be"):
                W.flow_warp(wrap(im), wrap(flow), wrap(bad.contiguous()))
    with pytest.raises(ValueError, match="mask must be"):
        W.flow_warp(_Cuda(im), _Cuda(flow), _Cuda(mask.to(torch.bfloat16)))
    for wrap in (lambda t: t, _Cuda):
        with pytest.raises(ValueError, match="NCHW"):
            W.flow_warp(wrap(im[0]), wrap(flow[0]))


@pytest.mark.parametrize("kind", ["random", "integer", "borders", "zero"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_mask_operand_equals_the_product_on_the_cpu(dtype, kind):
    """flow_warp(im, flow, mask) is flow_warp(im, flow) * mask, bit for
    bit."""
    im, flow, mask = _operands(3, 3, 5, 9, 14, dtype, mag=6.0, kind=kind)
    _same_bits(W.flow_warp(im, flow, mask), W.flow_warp(im, flow) * mask)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_autograd_function_keeps_the_twins_gradients(dtype, masked,
                                                     monkeypatch):
    """W1's autograd Function, its launch computed by the twin: the
    output and the gradients of every operand (and of the flow alone)
    equal the twin's own under autograd, bit for bit."""
    monkeypatch.setattr(W, "_launch", lambda im, flow, mask:
                        W.flow_warp_plain(im, flow, mask))
    im, flow, mask = _operands(4, 2, 4, 11, 13, dtype, mag=5.0,
                               masked=masked)
    g = torch.randn(im.shape, generator=_gen(5, "cpu")).to(dtype)
    for wanted in ((True, True, masked), (False, True, False)):
        leaves = [None if t is None else t.clone().requires_grad_(n)
                  for t, n in zip((im, flow, mask), wanted)]
        twins = [None if t is None else t.clone().requires_grad_(n)
                 for t, n in zip((im, flow, mask), wanted)]
        got = W._WarpFn.apply(*leaves)
        want = W.flow_warp_plain(*twins)
        _same_bits(got, want)
        ins = [t for t, n in zip(leaves, wanted) if n]
        refs = [t for t, n in zip(twins, wanted) if n]
        for a, b in zip(torch.autograd.grad(got, ins, g),
                        torch.autograd.grad(want, refs, g)):
            _same_bits(a, b)


def _offset_diversity_before(p, x, aux, flow, group_num=16, offset_num=2,
                             max_mag=40.0):
    """`models/dmc_fm.py::offset_diversity` before the mask moved into
    the warp: the warp, then the product."""
    a = p["align"]
    b, c, h, w = x.shape
    out = FM.lrelu(conv_apply(a["off1"], aux, stride=2, padding=1), 0.1)
    out = FM.lrelu(conv_apply(a["off2"], out, padding=1), 0.1)
    out = W.bilinear_resize_2x(conv_apply(a["off3"], out, padding=1),
                               up=True)
    go = group_num * offset_num
    cg = c // group_num
    offs = max_mag * torch.tanh(out[:, :2 * go]) + flow.repeat(1, go, 1, 1)
    flows = offs.reshape(b * go, 2, h, w)
    mask = torch.sigmoid(out[:, 2 * go:]).reshape(b * go, 1, h, w)
    xg = x.reshape(b, 1, group_num, cg, h, w).expand(
        b, offset_num, group_num, cg, h, w).reshape(b * go, cg, h, w)
    warped = W.flow_warp_plain(xg, flows) * mask
    return conv_apply(a["fusion"], warped.reshape(b, go * cg, h, w),
                      groups=group_num)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_offset_diversity_keeps_its_bits(dtype, batch):
    """DCVC-FM's offset diversity at 64 px, its mask now the warp's
    operand, gives the bits it gave with the product after the warp."""
    gen = torch.Generator().manual_seed(6)
    c1, c2 = PDMC.G_CH_1X, PDMC.G_CH_2X
    p = {"align": {"off1": conv_init(gen, c1 + 3 + 2, c2, 3),
                   "off2": conv_init(gen, c2, c2, 3),
                   "off3": conv_init(gen, c2, 3 * 16 * 2, 3),
                   "fusion": conv_init(gen, c1 * 2, c1, 1, groups=16)}}
    g = _gen(7, "cpu")
    x = torch.randn((batch, c1, 64, 64), generator=g).to(dtype)
    aux = torch.randn((batch, c1 + 5, 64, 64), generator=g).to(dtype)
    flow = (torch.randn((batch, 2, 64, 64), generator=g) * 4).to(dtype)
    with torch.no_grad():
        _same_bits(PDMC.offset_diversity(p, x, aux, flow),
                   _offset_diversity_before(p, x, aux, flow))


# ---------------------------------------------------------------------------
# card: W1 against the twin
# ---------------------------------------------------------------------------

def _w1_launches():
    return trace.counters().get("warp.launch", 0)


def _held(card, dtype, units, c, h, w, masked, kind="random", mag=48.0,
          seed=11, flow_dtype=None):
    im, flow, mask = _operands(seed, units, c, h, w, dtype, card, mag=mag,
                               masked=masked, kind=kind)
    if flow_dtype is not None:
        flow = flow.to(flow_dtype)
    with torch.no_grad():
        before = _w1_launches()
        got = W.flow_warp(im, flow, mask)
        assert _w1_launches() == before + 1
        want = W.flow_warp_plain(im, flow, mask)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", list(MAIN_SHAPES), ids=list(MAIN_SHAPES))
def test_w1_equals_the_twin_at_the_main_shapes(card, shape, dtype):
    units, c, h, w, masked = MAIN_SHAPES[shape]
    _held(card, dtype, units, c, h, w, masked)
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", [
    (1, 1, 1, 1), (2, 1, 1, 37), (3, 2, 33, 1), (2, 3, 17, 30),
    (5, 10, 31, 45), (1, 17, 9, 257), (3, 9, 68, 121)],
    ids=lambda c: "x".join(map(str, c)))
def test_w1_on_ragged_planes(card, case, dtype):
    """Planes of every size, channel counts that split unevenly, with and
    without the mask, and a flow of the other dtype."""
    units, c, h, w = case
    for masked in (False, True):
        _held(card, dtype, units, c, h, w, masked, mag=7.0)
    other = DTYPES[1 - DTYPES.index(dtype)]
    _held(card, dtype, units, c, h, w, True, mag=7.0, flow_dtype=other)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("kind", ["borders", "integer", "zero"])
def test_w1_at_the_borders_and_on_whole_pixels(card, kind, dtype):
    """Flows past every border and onto it, whole-pixel flows (every
    weight exactly 0 or 1) and the zero flow, with and without the
    mask."""
    for masked in (False, True):
        _held(card, dtype, 4, 6, 67, 120, masked, kind=kind, mag=9.0)


@pytest.mark.card
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_w1_under_autograd_keeps_the_twins_gradients(card, dtype, masked):
    """Under autograd W1 runs in its autograd Function: the output and the
    gradients of im, flow and mask equal the twin's bit for bit.
    Deterministic algorithms, so the twin's gather backward (a
    scatter_add) sums in one order on both sides."""
    im, flow, mask = _operands(12, 3, 48, 68, 120, dtype, card, mag=20.0,
                               masked=masked)
    g = torch.randn(im.shape, generator=_gen(13, card),
                    device=card).to(dtype)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        ops = [None if t is None else t.clone().requires_grad_()
               for t in (im, flow, mask)]
        twins = [None if t is None else t.clone().requires_grad_()
                 for t in (im, flow, mask)]
        before = _w1_launches()
        got = W.flow_warp(*ops)
        assert _w1_launches() == before + 1
        want = W.flow_warp_plain(*twins)
        _same_bits(got, want)
        ins = [t for t in ops if t is not None]
        refs = [t for t in twins if t is not None]
        for a, b in zip(torch.autograd.grad(got, ins, g),
                        torch.autograd.grad(want, refs, g)):
            _same_bits(a, b)
    finally:
        torch.use_deterministic_algorithms(was)
