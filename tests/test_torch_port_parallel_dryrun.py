"""`opendcvc_tpu_torch/parallel/dryrun.py::dryrun_multichip(4,
device="cpu")` on 4 gloo ranks, {data 2, spatial 2}, on the JAX package's
`dmc_init(PRNGKey(0))` weights (written by its `save_params`, read by the
port's checkpoint reader and `utils/params.py::from_jax`): the sharded
step holds the JAX dryrun's bounds against the one-process step
(__graft_entry__.py:163, :178) with the parameters bit-identical on every
rank, and its loss, and the one-process loss, lie within FWD_RTOL = 1e-4
(tests/test_torch_port_training.py's forward tolerance) of the JAX
package's `make_dmc_loss(lmbda=256.0)` on one device, on the same frames
(default_rng(0), (2, 3, 128, 128, 3)) at qp 21."""

import jax
import jax.numpy as jnp
import numpy as np

from opendcvc_tpu.models.dmc import dmc_init as jax_dmc_init
from opendcvc_tpu.training import train as JT
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.parallel.dryrun import dryrun_multichip
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

FWD_RTOL = 1e-4


def test_dryrun_multichip_cpu(tmp_path, capsys):
    params = jax_dmc_init(jax.random.PRNGKey(0))
    path = str(tmp_path / "dmc.msgpack")
    JCK.save_params(path, params)
    res = dryrun_multichip(4, device="cpu", checkpoint=path, timeout=280.0)
    line = capsys.readouterr().out
    assert "dryrun_multichip: mesh={'data': 2, 'spatial': 2}" in line
    assert "parity ok" in line
    frames = np.random.default_rng(0).random((2, 3, 128, 128, 3)) \
        .astype(np.float32)
    want, _ = jax.jit(JT.make_dmc_loss(lmbda=256.0))(
        params, jnp.asarray(frames), jnp.int32(21), jax.random.PRNGKey(2))
    want = float(want)
    print(f"loss: sharded {res['loss']}, one process {res['ref_loss']}, "
          f"JAX {want}; max|dparam| {res['max_dparam']:.3e}")
    for got in (res["loss"], res["ref_loss"]):
        assert abs(got - want) <= FWD_RTOL * abs(want)
