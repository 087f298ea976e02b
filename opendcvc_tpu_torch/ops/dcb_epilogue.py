"""The DepthConvBlock's elementwise epilogues: the CUDA kernels of
`csrc/dcb_epilogue.cu` and their plain PyTorch twins.

`layers/blocks.py::depth_conv_block_apply` runs a convolution without its
bias (`conv_nobias`), then one of these on the convolution's output:

    bias(c, b)                        c + b                       (dw, adaptor)
    bias_wsilu(c, b)                  t = c + b; t * sigmoid(4 t) (dc1)
    bias_wsilu_chunk_add(c, b)        the sum of the two channel halves of
                                      bias_wsilu, a new tensor    (ffn1)
    bias_residual(c, b, r, x, q)      ((c + b) + r [+ x]) [* q]   (dc2, ffn2)

They replace no TPU kernel: the JAX package leaves these chains to XLA's
fusion, and eager PyTorch ran them as 14 elementwise kernels a block.
Each kernel is bound by bytes: counting a C-channel plane read or written
as one unit, the chain moves about 63 units a block and the kernels 16
(the bias and WSiLU kernels 2 a launch, the chunk add 6 for C = K, the
residual 3, 4 with the shortcut).  The kernels equal the plain twins
bit for bit in float32 and bfloat16: every step rounded to the tensor's
dtype as ATen stores it, no FMA contraction, ATen's sigmoid.

`epilogues(x)` is the one place that picks between them: the plain twins
for tensors off CUDA (the CPU), else a `Kernels` bound to x's dtype and
the current stream.  The block takes one set a call and runs its five
epilogues on it, on operands it allocated itself (contiguous, x's dtype
and device), so `Kernels` checks nothing more a call.  Where autograd
records (training), each kernel runs inside a `torch.autograd.Function`
whose backward is the chain's own: the same ATen ops autograd runs on the
unfused chain, in its order, so the gradients are the chain's bit for
bit; its forward then writes a new tensor and keeps the convolution's
output for the backward.  Elsewhere the kernels write in place into `c`
(the convolution output the caller allocated, never an input it was
given), except the chunk add, which returns a new tensor.  Each launch
counts in the trace's counter `dcb.launch.<kernel>` (utils/trace.py):
`bias`, `bias_wsilu`, `chunk_add`, `residual`.  `bias`,
`bias_wsilu`, `bias_wsilu_chunk_add` and `bias_residual` are the same
epilogues for a caller that owns no block: they check every operand
first.
"""

import types

import torch

from ..utils import trace

#: the kernels' dtype codes (csrc/dcb_epilogue.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FN = {}    # ctypes functions, looked up once
#: each kernel's launch counter
_COUNTERS = {k: "dcb.launch." + k
             for k in ("bias", "bias_wsilu", "chunk_add", "residual")}


def _fn(name):
    f = _FN.get(name)
    if f is None:
        from . import _build
        f = _FN[name] = getattr(_build.load_kernels()["dcb_epilogue"], name)
    return f


# ---------------------------------------------------------------------------
# plain twins: the unfused chain
# ---------------------------------------------------------------------------

def wsilu(x):
    """WSiLU(x) = x * sigmoid(4x)."""
    return x * torch.sigmoid(4.0 * x)


def wsilu_chunk_add(x):
    """WSiLU then the sum of the two channel halves."""
    y = wsilu(x)
    c = y.shape[1]
    return y[:, :c // 2] + y[:, c // 2:]


def bias_plain(c, b):
    """c + b in place, b cast to c's dtype: the bias added after the
    convolution's own rounding, as `layers/blocks.py::conv_apply` adds
    it."""
    return c.add_(b.to(c.dtype)[:, None, None])


def bias_wsilu_plain(c, b):
    return wsilu(bias_plain(c, b))


def bias_wsilu_chunk_add_plain(c, b):
    return wsilu_chunk_add(bias_plain(c, b))


def bias_residual_plain(c, b, r, x=None, q=None):
    out = bias_plain(c, b) + r
    if x is not None:
        out = out + x
    if q is not None:
        out = out * q
    return out


#: the epilogues on the plain twins, under `Kernels`' names
PLAIN = types.SimpleNamespace(
    bias=bias_plain, bias_wsilu=bias_wsilu_plain,
    bias_wsilu_chunk_add=bias_wsilu_chunk_add_plain,
    bias_residual=bias_residual_plain)


# ---------------------------------------------------------------------------
# the chain's gradients, as autograd computes them on the chain
# ---------------------------------------------------------------------------

def _biased(c, b):
    """t = c + b, rounded as the chain's bias add rounds it."""
    return c + b[:, None, None]


def _bias_grad(g, b):
    """The bias add's gradient for b: g summed to b's broadcast shape
    (autograd's `sum_to`), viewed as (C,)."""
    return g.sum_to_size(b.shape[0], 1, 1).view(-1)


def _wsilu_grad(g, t):
    """The gradient at t of t * s, s = sigmoid(4 t): the product's term
    g s and sigmoid's term (its backward of g t, times the 4 of 4 t),
    summed as autograd sums the two uses of t."""
    s = torch.sigmoid(4.0 * t)
    return g * s + torch.ops.aten.sigmoid_backward(g * t, s) * 4.0


class _BiasFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, k, c, b, wsilu):
        ctx.wsilu = wsilu
        ctx.save_for_backward(c, b)
        return k.launch_bias(c, torch.empty_like(c), b, wsilu)

    @staticmethod
    def backward(ctx, g):
        c, b = ctx.saved_tensors
        if ctx.wsilu:
            g = _wsilu_grad(g, _biased(c, b))
        return None, g, _bias_grad(g, b), None


class _ChunkAddFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, k, c, b):
        ctx.save_for_backward(c, b)
        return k.launch_chunk_add(c, b)

    @staticmethod
    def backward(ctx, g):
        c, b = ctx.saved_tensors
        # the two halves' slice gradients, [g, 0] and [0, g], summed as
        # autograd sums them: g + 0 (the same bits, but -0.0 reads +0.0)
        g = torch.cat((g, g), 1).add_(0.0)
        g = _wsilu_grad(g, _biased(c, b))
        return None, g, _bias_grad(g, b)


class _ResidualFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, k, c, b, r, x, q):
        ctx.save_for_backward(c, b, r, x, q)
        return k.launch_residual(c, torch.empty_like(c), b, r, x, q)

    @staticmethod
    def backward(ctx, g):
        c, b, r, x, q = ctx.saved_tensors
        gq = None
        if q is not None:
            if ctx.needs_input_grad[5]:
                o = _biased(c, b) + r
                if x is not None:
                    o = o + x
                gq = (g * o).sum_to_size(q.shape)
            g = g * q
        return (None, g, _bias_grad(g, b), g, None if x is None else g,
                gq)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _records(c, b, *more):
    """Whether autograd records an op on c, b and `more` (None skipped)."""
    return torch.is_grad_enabled() and (
        c.requires_grad or b.requires_grad or
        any(t is not None and t.requires_grad for t in more))


def _failed(err, kernel):
    raise RuntimeError(f"dcb_elementwise_{kernel} launch failed: "
                       f"cudaError {err}")


class Kernels:
    """The epilogues on the CUDA kernels for one block's tensors, which
    are contiguous NCHW of the dtype and on the device of the `x` it was
    built for (the block's convolution outputs and its input): x's dtype
    is checked and the stream looked up once, and a call checks nothing
    more but a quant step.  Each epilogue runs in place where autograd
    does not record, else through its autograd Function.  A call costs
    the host a few attribute reads, the ctypes call and one count."""

    __slots__ = ("dtype", "code", "stream")

    def __init__(self, x):
        code = DTYPES.get(x.dtype)
        if code is None:
            raise ValueError(f"the epilogue kernels take float32 or "
                             f"bfloat16, got {x.dtype}")
        self.dtype, self.code = x.dtype, code
        # the raw cudaStream_t, without building a torch.cuda.Stream
        self.stream = torch._C._cuda_getCurrentRawStream(x.get_device())

    def _bias_of(self, b):
        """b in the block's dtype, contiguous (a cast only where needed),
        on a CUDA device."""
        if not b.is_cuda:
            raise ValueError(f"the bias must be on the block's CUDA "
                             f"device, got {b.device}")
        if b.dtype is not self.dtype or not b.is_contiguous():
            b = b.to(self.dtype).contiguous()
        return b

    # the launches: c read, out written (out may be c)

    def launch_bias(self, c, out, b, wsilu):
        n, ch, h, w = c.shape
        err = _fn("dcb_bias_launch")(
            c.data_ptr(), b.data_ptr(), out.data_ptr(), n, ch, h * w,
            wsilu, self.code, self.stream)
        kernel = "bias_wsilu" if wsilu else "bias"
        if err:
            _failed(err, kernel)
        trace.count(_COUNTERS[kernel])
        return out

    def launch_chunk_add(self, c, b):
        n, ch, h, w = c.shape
        out = c.new_empty((n, ch // 2, h, w))
        err = _fn("dcb_chunk_add_launch")(
            c.data_ptr(), b.data_ptr(), out.data_ptr(), n, ch // 2, h * w,
            self.code, self.stream)
        if err:
            _failed(err, "chunk_add")
        trace.count(_COUNTERS["chunk_add"])
        return out

    def launch_residual(self, c, out, b, r, x, q):
        n, ch, h, w = c.shape
        err = _fn("dcb_residual_launch")(
            c.data_ptr(), b.data_ptr(), r.data_ptr(),
            None if x is None else x.data_ptr(),
            None if q is None else q.data_ptr(), out.data_ptr(), n, ch,
            h * w, 0 if q is None or q.shape[0] == 1 else ch, self.code,
            self.stream)
        if err:
            _failed(err, "residual")
        trace.count(_COUNTERS["residual"])
        return out

    # the epilogues

    def bias(self, c, b):
        """c + b[ch] (c: NCHW, b: (C,))."""
        b = self._bias_of(b)
        if _records(c, b):
            return _BiasFn.apply(self, c, b, 0)
        return self.launch_bias(c, c, b, 0)

    def bias_wsilu(self, c, b):
        """WSiLU(c + b[ch])."""
        b = self._bias_of(b)
        if _records(c, b):
            return _BiasFn.apply(self, c, b, 1)
        return self.launch_bias(c, c, b, 1)

    def bias_wsilu_chunk_add(self, c, b):
        """(N, 2K, H, W) -> a new (N, K, H, W): WSiLU(c + b[ch]) of the
        first K channels plus that of the last K."""
        b = self._bias_of(b)
        if _records(c, b):
            return _ChunkAddFn.apply(self, c, b)
        return self.launch_chunk_add(c, b)

    def bias_residual(self, c, b, r, x=None, q=None):
        """((c + b[ch]) + r [+ x]) [* q[ch]], in that order (the block's
        residual, its shortcut, its quant step); r and x: c's shape, q:
        (1 or N, C, 1, 1), one value a channel (a sample)."""
        b = self._bias_of(b)
        if q is not None:
            q = _quant(q, c)
        if _records(c, b, r, x, q):
            return _ResidualFn.apply(self, c, b, r, x, q)
        return self.launch_residual(c, c, b, r, x, q)


def epilogues(x):
    """The epilogues for a block on x: the plain twins (`PLAIN`) for a
    tensor off CUDA, else the kernels (`Kernels(x)`; it raises for a
    dtype they do not take)."""
    return Kernels(x) if x.is_cuda else PLAIN


# ---------------------------------------------------------------------------
# checked epilogues, for a caller that owns no block
# ---------------------------------------------------------------------------

def _check(c, b):
    """c: contiguous NCHW float32 / bfloat16; b: (C,) on c's device."""
    if c.dtype not in DTYPES:
        raise ValueError(f"the epilogue kernels take float32 or bfloat16, "
                         f"got {c.dtype}")
    if c.dim() != 4:
        raise ValueError(f"expected an NCHW tensor, got {c.dim()}-d")
    if not c.is_contiguous():
        raise ValueError("the epilogue kernels take contiguous tensors")
    ch = c.shape[1]
    if b.shape != (ch,) or b.device != c.device:
        raise ValueError(f"bias must be ({ch},) on {c.device}, got "
                         f"{tuple(b.shape)} on {b.device}")


def _operand(name, t, c):
    if t.dtype != c.dtype or t.shape != c.shape or t.device != c.device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {c.dtype} "
                         f"{tuple(c.shape)} on {c.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _quant(q, c):
    """q (1, C, 1, 1) or (N, C, 1, 1) of c's dtype and device, contiguous
    (the kernel reads rows of C)."""
    n, ch = c.shape[:2]
    if q.dtype != c.dtype or q.device != c.device or \
            q.shape not in ((1, ch, 1, 1), (n, ch, 1, 1)):
        raise ValueError(f"quant_step must be (1 or {n}, {ch}, 1, 1) "
                         f"{c.dtype} on {c.device}, got {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")
    return q.contiguous()


def bias(c, b):
    """c + b[ch] (c: NCHW, b: (C,)), in place where autograd does not
    record."""
    _check(c, b)
    return epilogues(c).bias(c, b)


def bias_wsilu(c, b):
    """WSiLU(c + b[ch]), in place where autograd does not record."""
    _check(c, b)
    return epilogues(c).bias_wsilu(c, b)


def bias_wsilu_chunk_add(c, b):
    """(N, 2K, H, W) -> a new (N, K, H, W): WSiLU(c + b[ch]) of the first
    K channels plus that of the last K."""
    _check(c, b)
    if c.shape[1] % 2:
        raise ValueError(f"the chunk add takes an even channel count, "
                         f"got {c.shape[1]}")
    return epilogues(c).bias_wsilu_chunk_add(c, b)


def bias_residual(c, b, r, x=None, q=None):
    """((c + b[ch]) + r [+ x]) [* q[ch]], in that order (the block's
    residual, its shortcut, its quant step), in place where autograd does
    not record; r and x: c's shape, q: one value a channel."""
    _check(c, b)
    _operand("r", r, c)
    if x is not None:
        _operand("x", x, c)
    if q is not None:
        _quant(q, c)
    return epilogues(c).bias_residual(c, b, r, x, q)
