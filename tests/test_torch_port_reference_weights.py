"""Reference state dicts through `utils/port_torch.py` (CPU).

For each of the eight mappers, a reference-named state dict is written
from the port's `init` tree in the JAX layout (`to_jax`) by the inverse
in `torch_port_reference_sd.py`.  Held:
  * the JAX package's mapper gives back that tree leaf for leaf, and the
    tree has the structure, shapes and dtypes of the JAX package's own
    init (`jax.eval_shape`, so nothing is drawn): the dict has the
    reference's shape, and the JAX mapper covers every init leaf;
  * the port's mapper equals `from_jax` of the JAX mapper's tree bit for
    bit, dtypes included, for numpy and torch values, float32 and float64
    (both packages give float32), each leaf a fresh contiguous tensor;
  * bfloat16 tensors map to bfloat16 leaves in the port (the JAX
    mapper raises TypeError on them);
  * a missing key raises KeyError in both; extra keys are ignored;
  * DMCI (narrow: N 64, z 32, 64 channels at full resolution) and DMC
    (its one width) loaded through each package's mapper code a 64x64
    I-frame and 2 P-frames on host EC to the same bytes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu.utils import port_torch as JP
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.utils import port_torch as PP
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)
from torch_port_reference_sd import REFERENCE_SD

MODELS = list(REFERENCE_SD)
INITS = {"dmci": "dmci_init", "dmc": "dmc_init", "dmc_hem": "dmc_hem_init",
         "dmc_tcm": "dmc_tcm_init", "dmc_fm": "dmc_fm_init",
         "dcvc": "dcvc_init", "dmc_dc": "dmc_dc_init", "evc": "evc_init"}
FLAVOURS = ["numpy", "torch", "numpy_float64", "torch_float64"]
NARROW_I = {"N": 64, "z_channel": 32, "enc_dec_ch": 64}
H = W = 64
QP = 21


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _port_init(model, **kw):
    mod = importlib.import_module(f"opendcvc_tpu_torch.models.{model}")
    return getattr(mod, INITS[model])(torch.Generator().manual_seed(3), **kw)


@pytest.fixture(scope="module")
def sources():
    """Per model: the JAX-layout source tree and its reference dict."""
    out = {}
    for model in MODELS:
        tree = to_jax(_port_init(model))
        out[model] = (tree, REFERENCE_SD[model](tree))
    return out


def _flavour(sd, flavour):
    def one(a):
        if flavour.endswith("float64"):
            # off the float32 grid, so the cast's rounding is held too
            a = a.astype(np.float64) * (1.0 + 2.0 ** -30)
        return torch.from_numpy(a.copy()) if flavour.startswith("torch") \
            else a
    return {k: one(v) for k, v in sd.items()}


@pytest.mark.parametrize("model", MODELS)
def test_jax_mapper_reads_reference_dict(model, sources):
    tree, sd = sources[model]
    jmod = importlib.import_module(f"opendcvc_tpu.models.{model}")
    shapes = dict(_leaves(jax.eval_shape(getattr(jmod, INITS[model]),
                                         jax.random.PRNGKey(0))))
    got = dict(_leaves(getattr(JP, "port_" + model)(sd)))
    want = dict(_leaves(tree))
    assert got.keys() == shapes.keys() == want.keys()
    for path, leaf in got.items():
        assert leaf.shape == shapes[path].shape, path
        assert leaf.dtype == shapes[path].dtype, path
        np.testing.assert_array_equal(np.asarray(leaf), want[path],
                                      err_msg=path)


@pytest.mark.parametrize("flavour", FLAVOURS)
@pytest.mark.parametrize("model", MODELS)
def test_port_mapper_equals_jax_mapper(model, flavour, sources):
    sd = _flavour(sources[model][1], flavour)
    want = dict(_leaves(from_jax(getattr(JP, "port_" + model)(sd))))
    got = dict(_leaves(getattr(PP, "port_" + model)(sd)))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        ref = want[path]
        assert leaf.dtype == ref.dtype == torch.float32, path
        assert leaf.shape == ref.shape and leaf.is_contiguous(), path
        assert leaf.device.type == "cpu", path
        assert torch.equal(leaf.view(torch.int32), ref.view(torch.int32)), \
            path
    if flavour == "torch":
        # nothing shares storage with the caller's dict
        before = {p: t.clone() for p, t in got.items()}
        for v in sd.values():
            v.add_(1.0)
        for path, leaf in got.items():
            assert torch.equal(leaf, before[path]), path


@pytest.mark.parametrize("model", MODELS)
def test_bfloat16_torch_values_keep_their_dtype(model, sources):
    """bfloat16 tensors: the port's leaves are the float32 mapping's,
    rounded to bfloat16 (the mapping only moves values); the JAX mapper
    cannot read them (ROADMAP, faults of the JAX package)."""
    sd = sources[model][1]
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    got = dict(_leaves(getattr(PP, "port_" + model)(bf)))
    want = dict(_leaves(getattr(PP, "port_" + model)(sd)))
    for path, leaf in got.items():
        assert leaf.dtype == torch.bfloat16, path
        assert torch.equal(leaf, want[path].to(torch.bfloat16)), path
    with pytest.raises(TypeError):
        getattr(JP, "port_" + model)(bf)


@pytest.mark.parametrize("model", MODELS)
def test_missing_key_raises_and_extra_keys_are_ignored(model, sources):
    sd = dict(sources[model][1])
    sd["unused.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    want = dict(_leaves(getattr(PP, "port_" + model)(sources[model][1])))
    got = dict(_leaves(getattr(PP, "port_" + model)(sd)))
    assert all(torch.equal(got[p], want[p]) for p in want)
    bias = sorted(k for k in sd if k.endswith(".bias"))[0]
    del sd[bias]
    for mapper in (JP, PP):
        with pytest.raises(KeyError):
            getattr(mapper, "port_" + model)(sd)


def _jax_codec(cls, params, **kw):
    """A JAX codec on its host-EC path with its plain coder."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = cls(**kw)
        net.load_params(params)
        net.update()
    assert not net.device_ec
    return net


def _port_codec(cls, params, **kw):
    net = cls(device="cpu", device_ec=False, **kw)
    net.load_params(params)
    net.update()
    return net


def test_loaded_codecs_code_the_same_bytes():
    sd_i = REFERENCE_SD["dmci"](to_jax(_port_init("dmci", **NARROW_I)))
    sd_p = REFERENCE_SD["dmc"](to_jax(_port_init("dmc")))
    rng = np.random.default_rng(0)
    x0 = rng.random((1, H, W, 3), dtype=np.float32)
    frames = [np.clip(x0 + rng.normal(0, 0.02 * (k + 1), x0.shape), 0, 1)
              .astype(np.float32) for k in range(2)]

    ji = _jax_codec(JDMCI.DMCI, JP.port_dmci(sd_i), **NARROW_I)
    pi = _port_codec(PDMCI.DMCI, PP.port_dmci(sd_i), **NARROW_I)
    js = ji.compress(jnp.asarray(x0), QP)["bit_stream"]
    pe = pi.compress(x0, QP)
    assert pe["bit_stream"] == js
    ref = pe["x_hat"].numpy()

    jp = _jax_codec(JDMC.DMC, JP.port_dmc(sd_p))
    pp = _port_codec(PDMC.DMC, PP.port_dmc(sd_p))
    jp.add_ref_frame(None, jnp.asarray(ref))
    pp.add_ref_frame(None, ref)
    for k, x in enumerate(frames):
        js = jp.compress(jnp.asarray(x), QP)["bit_stream"]
        ps = pp.compress(x, QP)["bit_stream"]
        assert ps == js, f"P-frame {k}"
