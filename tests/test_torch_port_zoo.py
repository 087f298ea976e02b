"""The port's CompressAI-era image-codec zoo (`models/priors_zoo.py`)
against the JAX package's, on the CPU.

Each of the five models at 64x64 with N 64 / M 96 (Cheng2020Anchor N 64),
on the JAX package's own init (seed 0) carried across with `from_jax`,
and on a "live" copy of it: the analysis transform's last conv and the
hyper analysis' last conv scaled by LIVE (weights and bias), the same
tree in both packages, so that y carries non-zero symbols (under the
init it rounds to zeros in every hyperprior model).  The JAX codecs code
with their plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1 during update()).
Image: uniform noise from numpy's default_rng.

Held, in float32 and bfloat16: the strings byte-identical to the JAX
package's, in its nesting, and the shape equal; the port's decoder
decodes the JAX package's strings to the x_hat it decodes its own to,
and a second decode is identical; the JAX decoder on the port's strings
within REL_TOL x max|ref| of the port's x_hat in float32, and in
bfloat16 the share of values within XHAT_RTOL x max|ref| >= XHAT_SHARE
(`test_torch_port_evc.py`'s bound); x_hat in [0, 1].  The registry's
keys and classes; the init's tree layout; the default device raises
without CUDA.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.models import priors_zoo as JZ
from opendcvc_tpu_torch.eval import fm_ties as TIES
from opendcvc_tpu_torch.models import priors_zoo as PZ
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

MODELS = list(JZ.IMAGE_CODEC_ZOO)
LIVE = 20.0
REL_TOL = TIES.REL_TOL
XHAT_SHARE = 0.9
XHAT_RTOL = 2.0 ** -4


def _kw(name):
    return {"N": 64} if name == "cheng2020-anchor" else {"N": 64, "M": 96}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


def live_tree(tree, scale=LIVE):
    """A copy of the port's tree with the analysis transform's last conv
    and the hyper analysis' last conv scaled."""
    tree = copy.deepcopy(tree)
    ga = tree["g_a"]
    convs = [ga["convs"][3] if "convs" in ga else ga["down"]]
    if "h_a" in tree:
        convs.append(tree["h_a"][-1])
    for conv in convs:
        conv["w"] = conv["w"] * scale
        conv["b"] = conv["b"] * scale
    return tree


@pytest.fixture(scope="module")
def trees():
    """name -> {"init": port tree, "live": port tree}."""
    out = {}
    for name in MODELS:
        pt = from_jax(JZ.IMAGE_CODEC_ZOO[name](**_kw(name)).init_params(0))
        out[name] = {"init": pt, "live": live_tree(pt)}
    return out


def test_registry_equals_jax():
    assert list(PZ.IMAGE_CODEC_ZOO) == list(JZ.IMAGE_CODEC_ZOO)
    for name, cls in PZ.IMAGE_CODEC_ZOO.items():
        assert cls.__name__ == JZ.IMAGE_CODEC_ZOO[name].__name__


@pytest.mark.parametrize("name", MODELS)
def test_port_init_has_the_jax_layout(name, trees):
    net = PZ.IMAGE_CODEC_ZOO[name](device="cpu", **_kw(name))
    tree = to_jax(net.init_params(seed=2))
    assert _shapes(tree) == _shapes(to_jax(trees[name]["init"]))
    assert {a.dtype for a in jax.tree_util.tree_leaves(tree)} == \
        {np.dtype(np.float32)}


def test_codec_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PZ.MeanScaleHyperprior()


def _flat(strings):
    return [s for group in strings for s in group]


@pytest.mark.parametrize("which", ["init", "live"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_strings_match_jax_and_cross_decode(trees, name, dtype, which):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    pt = trees[name][which]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        jnet = JZ.IMAGE_CODEC_ZOO[name](dtype=jdt, **_kw(name))
        jnet.load_params(to_jax(pt))
        jnet.update()
    pnet = PZ.IMAGE_CODEC_ZOO[name](device="cpu", dtype=tdt, **_kw(name))
    pnet.load_params(pt)
    pnet.update()
    x = np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32)
    jo, po = jnet.compress(x), pnet.compress(x)
    print(f"{name} {dtype} {which}: bytes "
          f"{[len(s) for s in _flat(po['strings'])]}")
    assert [len(g) for g in po["strings"]] == \
        [len(g) for g in jo["strings"]]
    assert _flat(po["strings"]) == _flat(jo["strings"])
    assert tuple(po["shape"]) == tuple(jo["shape"])

    d = pnet.decompress(po["strings"], po["shape"])["x_hat"]
    assert d.dtype == tdt and d.shape == (1, 64, 64, 3)
    assert float(d.min()) >= 0 and float(d.max()) <= 1
    assert torch.equal(pnet.decompress(po["strings"], po["shape"])["x_hat"],
                       d)
    assert torch.equal(pnet.decompress(jo["strings"], jo["shape"])["x_hat"],
                       d)
    ref = d.float().numpy()
    got = np.asarray(jnp.asarray(
        jnet.decompress(po["strings"], po["shape"])["x_hat"], jnp.float32))
    err = np.abs(got - ref) / max(float(np.abs(ref).max()), 1e-6)
    if dtype == "float32":
        assert err.max() <= REL_TOL, err.max()
    else:
        share = float((err <= XHAT_RTOL).mean())
        print(f"JAX bfloat16 decoder vs the port's: {share:.5f} within "
              f"{XHAT_RTOL}")
        assert share >= XHAT_SHARE, share
