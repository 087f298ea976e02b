"""The DepthConvBlock's epilogues (`ops/dcb_epilogue.py`) and the block
that runs them (`layers/blocks.py::depth_conv_block_apply`) against the
unfused chain the block ran before them, frozen here (`_chain_*`).

On the CPU: the plain twins and the wrappers (which run the twins on CPU
tensors) equal the chain bit for bit in float32 and bfloat16, in every
block variant and on ragged planes; the block takes the plain path on
the CPU, with the chain's gradients; the kernels' autograd Functions,
their launches computed here by the twins, give the chain's gradients
bit for bit; the wrappers refuse what the kernels do not take; the
block's counters.  Tests marked `card` hold each CUDA kernel and the
fused block, under autograd too, against the chain at the main path's
shapes; they skip without a card.  This file imports no JAX, so they run
on a card's machine with

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_port_dcb_epilogue.py
"""

import pytest
import torch
import torch.nn.functional as F

from opendcvc_tpu_torch.layers import blocks as L
from opendcvc_tpu_torch.ops import dcb_epilogue as E
from opendcvc_tpu_torch.utils import trace

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (as `test_torch_port_lane_rans._one_thread`,
    which this file cannot import: that module imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the unfused chain, as the block ran it
# ---------------------------------------------------------------------------

def _chain_conv(p, x, padding=0, groups=1):
    out = F.conv2d(x, p["w"].to(x.dtype), None, padding=padding,
                   groups=groups)
    return out.add_(p["b"].to(x.dtype)[:, None, None])


def _chain_wsilu(x):
    return x * torch.sigmoid(4.0 * x)


def _chain_chunk_add(x):
    y = _chain_wsilu(x)
    c = y.shape[1]
    return y[:, :c // 2] + y[:, c // 2:]


def _chain_block(p, x, quant_step=None, shortcut=False):
    if "adaptor" in p:
        x = _chain_conv(p["adaptor"], x)
    c = x.shape[1]
    h = _chain_wsilu(_chain_conv(p["dc1"], x))
    h = _chain_conv(p["dc_dw"], h, padding=1, groups=c)
    out = _chain_conv(p["dc2"], h) + x
    f = _chain_conv(p["ffn2"], _chain_chunk_add(_chain_conv(p["ffn1"], out)))
    out = f + out
    if shortcut:
        out = out + x
    if quant_step is not None:
        out = out * quant_step
    return out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _rand(seed, shape, dtype=torch.float32, device="cpu", scale=3.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device=device,
                                                        dtype=dtype)


def _block(seed, in_ch, out_ch, force_adaptor, dtype, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    p = L.depth_conv_block_init(g, in_ch, out_ch, force_adaptor)
    return {k: {n: t.to(device=device, dtype=dtype) for n, t in v.items()}
            for k, v in p.items()}


#: (in_ch, out_ch, force_adaptor, shortcut, quant_step rows: 0 none, 1 one
#: row, 2 one a sample, batch)
VARIANTS = {
    "plain": (8, 8, False, False, 0, 1),
    "adaptor": (6, 8, False, False, 0, 1),
    "forced_adaptor": (8, 8, True, False, 0, 1),
    "shortcut": (8, 8, False, True, 0, 1),
    "quant_step": (8, 8, False, False, 1, 1),
    "shortcut_quant_step": (6, 8, False, True, 1, 2),
    "quant_step_a_sample": (8, 8, False, False, 2, 3),
}


def _variant(name, hw, dtype, device="cpu", seed=0):
    in_ch, out_ch, force, shortcut, q_rows, n = VARIANTS[name]
    p = _block(seed, in_ch, out_ch, force, dtype, device)
    x = _rand(seed + 1, (n,) + (in_ch,) + hw, dtype, device)
    q = None
    if q_rows:
        rows = 1 if q_rows == 1 else n
        q = (0.5 + _rand(seed + 2, (rows, out_ch, 1, 1), scale=1.0).abs()) \
            .to(device=device, dtype=dtype)
    return p, x, q, shortcut


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), \
        f"{int((got != want).sum())} of {got.numel()} elements differ"


def _same_bits(got, want):
    """Equal bit for bit: the sign of a zero counts too."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.view(ints[got.dtype]), want.view(ints[want.dtype])
    assert torch.equal(g, w), \
        f"{int((g != w).sum())} of {got.numel()} elements differ"


def _grads(fn, p, x, q, shortcut):
    """fn's output and the gradients of sum(out^2) for x, every parameter
    and the quant step, on fresh leaves."""
    pp = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
          for k, v in p.items()}
    xx = x.clone().requires_grad_()
    qq = None if q is None else q.clone().requires_grad_()
    out = fn(pp, xx, quant_step=qq, shortcut=shortcut)
    (out.float() * out.float()).sum().backward()
    return [out.detach(), xx.grad] + [t.grad for v in pp.values()
                                      for t in v.values()] + (
        [] if q is None else [qq.grad])


# ---------------------------------------------------------------------------
# CPU: the plain twins, the wrappers and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(7, 9), (4, 8)], ids=["7x9", "4x8"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_block_equals_the_chain_on_the_cpu(variant, hw, dtype):
    p, x, q, shortcut = _variant(variant, hw, dtype)
    x0 = x.clone()
    trace.reset_counters()
    got = L.depth_conv_block_apply(p, x, quant_step=q, shortcut=shortcut)
    _equal(got, _chain_block(p, x, quant_step=q, shortcut=shortcut))
    _equal(x, x0)
    assert trace.counters().get("dcb.block") == 1
    assert "dcb.fused" not in trace.counters()


def _epilogue_cases(dtype, device="cpu", c=8, hw=(7, 9), n=2, seed=3):
    """(name, kernel call, chain) on fresh copies of one set of inputs."""
    shape = (n, c) + hw
    conv = _rand(seed, shape, dtype, device)
    wide = _rand(seed + 1, (n, 4 * c) + hw, dtype, device)
    b = _rand(seed + 2, (c,), dtype, device, scale=1.0)
    b4 = _rand(seed + 3, (4 * c,), dtype, device, scale=1.0)
    r = _rand(seed + 4, shape, dtype, device)
    x = _rand(seed + 5, shape, dtype, device)
    q = (0.5 + _rand(seed + 6, (1, c, 1, 1), scale=1.0).abs()).to(
        device=device, dtype=dtype)
    qn = (0.5 + _rand(seed + 7, (n, c, 1, 1), scale=1.0).abs()).to(
        device=device, dtype=dtype)

    def badd(t, bb):
        return t + bb[:, None, None]
    return [
        ("bias", lambda: E.bias(conv.clone(), b), lambda: badd(conv, b)),
        ("bias_wsilu", lambda: E.bias_wsilu(conv.clone(), b),
         lambda: _chain_wsilu(badd(conv, b))),
        ("chunk_add", lambda: E.bias_wsilu_chunk_add(wide.clone(), b4),
         lambda: _chain_chunk_add(badd(wide, b4))),
        ("residual", lambda: E.bias_residual(conv.clone(), b, r),
         lambda: badd(conv, b) + r),
        ("residual_shortcut", lambda: E.bias_residual(conv.clone(), b, r, x),
         lambda: badd(conv, b) + r + x),
        ("residual_quant", lambda: E.bias_residual(conv.clone(), b, r, None,
                                                   q),
         lambda: (badd(conv, b) + r) * q),
        ("residual_shortcut_quant",
         lambda: E.bias_residual(conv.clone(), b, r, x, qn),
         lambda: (badd(conv, b) + r + x) * qn),
    ]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_epilogues_equal_the_chain_on_the_cpu(dtype):
    for name, fn, want in _epilogue_cases(dtype):
        got = fn()
        assert got.dtype == dtype, name
        _equal(got, want())


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_plain_twins_equal_the_chain(dtype):
    """The twins on their own, the bias in float32 cast to c's dtype as
    `conv_apply` casts it."""
    c = _rand(0, (2, 8, 7, 9), dtype)
    b32 = _rand(1, (8,), scale=1.0)
    b4 = _rand(2, (16,), scale=1.0)
    r = _rand(3, (2, 8, 7, 9), dtype)
    bb = b32.to(dtype)[:, None, None]
    _equal(E.bias_plain(c.clone(), b32), c + bb)
    _equal(E.bias_wsilu_plain(c.clone(), b32), _chain_wsilu(c + bb))
    _equal(E.bias_wsilu_chunk_add_plain(c.clone(), b4[:8]),
           _chain_chunk_add(c + b4[:8].to(dtype)[:, None, None]))
    _equal(E.bias_residual_plain(c.clone(), b32, r), c + bb + r)
    _equal(L.conv_apply({"w": _rand(4, (8, 8, 1, 1)), "b": b32}, c),
           _chain_conv({"w": _rand(4, (8, 8, 1, 1)), "b": b32}, c))


def test_block_under_autograd_keeps_the_chains_gradients():
    p, x, q, _ = _variant("shortcut_quant_step", (7, 9), torch.float32)
    trace.reset_counters()
    got = _grads(L.depth_conv_block_apply, p, x, q, True)
    assert "dcb.fused" not in trace.counters()
    for g, w in zip(got, _grads(_chain_block, p, x, q, True)):
        _same_bits(g, w)


class _TwinKernels(E.Kernels):
    """`Kernels` with each launch computed by its plain twin: the
    kernels' autograd Functions, forward and backward, on the CPU."""

    def __init__(self, x):
        self.dtype, self.code, self.stream = x.dtype, E.DTYPES[x.dtype], 0

    def _bias_of(self, b):
        return b.to(self.dtype).contiguous()

    def launch_bias(self, c, out, b, wsilu):
        twin = E.bias_wsilu_plain if wsilu else E.bias_plain
        return out.copy_(twin(c.clone(), b))

    def launch_chunk_add(self, c, b):
        return E.bias_wsilu_chunk_add_plain(c.clone(), b)

    def launch_residual(self, c, out, b, r, x, q):
        return out.copy_(E.bias_residual_plain(c.clone(), b, r, x, q))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kernels_under_autograd_keep_the_chains_gradients(variant, dtype,
                                                          monkeypatch):
    """The block on `Kernels` under autograd: every epilogue through its
    Function, whose backward gives the chain's output and gradients (x,
    every weight and bias, the quant step) bit for bit."""
    p, x, q, shortcut = _variant(variant, (7, 9), dtype)
    monkeypatch.setattr(E, "epilogues", _TwinKernels)
    trace.reset_counters()
    got = _grads(L.depth_conv_block_apply, p, x, q, shortcut)
    assert trace.counters().get("dcb.fused") == 1
    launches = sum(v for k, v in trace.counters().items()
                   if k.startswith("dcb.launch."))
    assert launches == 0    # the twins' launches count nothing
    for g, w in zip(got, _grads(_chain_block, p, x, q, shortcut)):
        _same_bits(g, w)


def test_fused_path_is_chosen_by_what_the_block_sees(monkeypatch):
    """CPU tensors never take the kernels; a CUDA input takes them, under
    autograd too, in float32 and bfloat16, and raises in another
    dtype."""
    x = _rand(0, (1, 8, 4, 8))
    assert E.epilogues(x) is E.PLAIN
    assert E.epilogues(x.requires_grad_()) is E.PLAIN
    with torch.no_grad():
        assert E.epilogues(x) is E.PLAIN

    class _Cuda:
        """A stand-in input that reports a CUDA device."""
        is_cuda = True
        requires_grad = True

        def __init__(self, dtype):
            self.dtype = dtype

        def get_device(self):
            return 0
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    for dtype in DTYPES:
        k = E.epilogues(_Cuda(dtype))
        assert isinstance(k, E.Kernels)
        assert (k.dtype, k.code, k.stream) == (dtype, E.DTYPES[dtype], 7)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        E.epilogues(_Cuda(torch.float16))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64],
                         ids=["float16", "float64"])
def test_wrappers_refuse_other_dtypes(dtype):
    c = _rand(0, (1, 8, 4, 8), dtype)
    b = _rand(1, (8,), dtype)
    for fn in (E.bias, E.bias_wsilu, E.bias_wsilu_chunk_add):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(c, b)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        E.bias_residual(c, b, c.clone())


def test_wrappers_refuse_bad_operands():
    c = _rand(0, (2, 8, 4, 8))
    b = _rand(1, (8,))
    strided = _rand(2, (2, 8, 8, 4)).transpose(2, 3)
    for fn in (E.bias, E.bias_wsilu, E.bias_wsilu_chunk_add):
        with pytest.raises(ValueError, match="contiguous"):
            fn(strided, b)
        with pytest.raises(ValueError, match="bias must be"):
            fn(c, b[:4])
    with pytest.raises(ValueError, match="r must be contiguous"):
        E.bias_residual(c, b, strided)
    with pytest.raises(ValueError, match="x must be contiguous"):
        E.bias_residual(c, b, c.clone(), c[:1].clone())
    with pytest.raises(ValueError, match="r must be contiguous"):
        E.bias_residual(c, b, c.to(torch.bfloat16))
    for q in (_rand(3, (8,)), _rand(3, (3, 8, 1, 1)), _rand(3, (1, 8, 4, 8)),
              _rand(3, (1, 8, 1, 1)).to(torch.bfloat16)):
        with pytest.raises(ValueError, match="quant_step must be"):
            E.bias_residual(c, b, c.clone(), None, q)
    with pytest.raises(ValueError, match="even channel count"):
        E.bias_wsilu_chunk_add(_rand(4, (1, 7, 4, 8)), _rand(5, (7,)))


# ---------------------------------------------------------------------------
# card: the kernels and the fused block against the chain
# ---------------------------------------------------------------------------

MAIN_C = [256, 320, 368]
MAIN_HW = [(136, 240), (68, 120)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hw", MAIN_HW, ids=["136x240", "68x120"])
@pytest.mark.parametrize("c", MAIN_C)
def test_kernels_equal_the_chain_on_the_card(card, c, hw, dtype):
    trace.reset_counters()
    with torch.no_grad():
        for name, fn, want in _epilogue_cases(dtype, card, c, hw, n=1):
            got = fn()
            torch.cuda.synchronize()
            assert got.is_cuda, name
            _equal(got, want())
    launches = {k: v for k, v in trace.counters().items()
                if k.startswith("dcb.launch.")}
    assert launches == {"dcb.launch.bias": 1, "dcb.launch.bias_wsilu": 1,
                        "dcb.launch.chunk_add": 1, "dcb.launch.residual": 4}


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", [((7, 9), 3, 0), ((17, 30), 2, 0),
                                  ((4, 8), 2, 1)],
                         ids=["7x9", "17x30", "misaligned"])
def test_kernels_on_ragged_planes_on_the_card(card, case, dtype):
    """Scalar and narrower vectors: HW not a multiple of 4, batches over
    one, and operands starting off a 16-byte boundary."""
    hw, n, offset = case
    with torch.no_grad():
        for name, fn, want in _epilogue_cases(dtype, card, 8, hw, n=n):
            _equal(fn(), want())
        conv = _rand(0, (n * 8 * hw[0] * hw[1] + offset,), dtype, card)
        conv = conv[offset:].view(n, 8, *hw)
        b = _rand(1, (8,), dtype, card, scale=1.0)
        want = _chain_wsilu(conv + b[:, None, None])
        _equal(E.bias_wsilu(conv, b), want)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_block_equals_the_chain_on_the_card(card, variant, dtype):
    p, x, q, shortcut = _variant(variant, (68, 120), dtype, card)
    x0 = x.clone()
    trace.reset_counters()
    with torch.no_grad():
        got = L.depth_conv_block_apply(p, x, quant_step=q,
                                       shortcut=shortcut)
        want = _chain_block(p, x, quant_step=q, shortcut=shortcut)
    _equal(got, want)
    _equal(x, x0)
    assert trace.counters().get("dcb.fused") == 1
    # without no_grad the block takes the kernels too: nothing requires
    # grad
    _equal(L.depth_conv_block_apply(p, x, quant_step=q, shortcut=shortcut),
           want)
    assert trace.counters().get("dcb.fused") == 2


@pytest.mark.card
def test_block_on_the_card_under_autograd_and_in_float16(card):
    p, x, q, _ = _variant("quant_step", (17, 30), torch.float32, card)
    p["ffn1"]["w"].requires_grad_()
    trace.reset_counters()
    out = L.depth_conv_block_apply(p, x, quant_step=q)
    assert out.requires_grad and trace.counters().get("dcb.fused") == 1
    assert trace.counters().get("dcb.launch.chunk_add") == 1
    p16, x16, q16, _ = _variant("quant_step", (17, 30), torch.float16, card)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or "
                                                          "bfloat16"):
        L.depth_conv_block_apply(p16, x16, quant_step=q16)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_block_under_autograd_keeps_the_chains_gradients_on_the_card(
        card, variant, dtype):
    """The block on the kernels under autograd (training): its output
    and every gradient equal the chain's bit for bit."""
    p, x, q, shortcut = _variant(variant, (17, 30), dtype, card)
    trace.reset_counters()
    got = _grads(L.depth_conv_block_apply, p, x, q, shortcut)
    assert trace.counters().get("dcb.fused") == 1
    assert trace.counters().get("dcb.launch.chunk_add") == 1
    for g, w in zip(got, _grads(_chain_block, p, x, q, shortcut)):
        _same_bits(g, w)
