"""The port's process grid (`opendcvc_tpu_torch/parallel/mesh.py`) on the
CPU: the environment parse of init_distributed in the JAX package's order
(`opendcvc_tpu/parallel/mesh.py::init_distributed`), its idempotence and
its refusal to fall back to the CPU, make_mesh's shapes, -1 inference and
ValueError where the JAX package asserts, and batch_sharding /
replicate_sharding on 4 gloo ranks.  Multi-process cases run through
`parallel/dryrun.py::run_ranks` (spawned ranks, one thread each, killed
on failure or after their timeout)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from opendcvc_tpu_torch.parallel import mesh as M
from opendcvc_tpu_torch.parallel.dryrun import free_port, run_ranks
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

TIMEOUT = 240.0
ENV = ("OPENDCVC_TPU_COORDINATOR", "MASTER_ADDR", "MASTER_PORT",
       "OPENDCVC_TPU_NUM_PROCS", "SLURM_NTASKS", "WORLD_SIZE",
       "OPENDCVC_TPU_PROC_ID", "SLURM_PROCID", "RANK", "LOCAL_RANK",
       "SLURM_LOCALID", "OPENDCVC_TPU_DIST")

# (environment, arguments, the (init_method, world_size, rank) joined)
CASES = {
    "jax_vars_first": (
        {"OPENDCVC_TPU_COORDINATOR": "node0:7000", "MASTER_ADDR": "m",
         "MASTER_PORT": "9", "OPENDCVC_TPU_NUM_PROCS": "8",
         "SLURM_NTASKS": "4", "WORLD_SIZE": "2",
         "OPENDCVC_TPU_PROC_ID": "5", "SLURM_PROCID": "3", "RANK": "1"},
        {}, ("tcp://node0:7000", 8, 5)),
    "slurm_then_master": (
        {"MASTER_ADDR": "head", "MASTER_PORT": "29500", "SLURM_NTASKS": "4",
         "WORLD_SIZE": "2", "SLURM_PROCID": "3", "RANK": "1"},
        {}, ("tcp://head:29500", 4, 3)),
    "master_port_default": (
        {"MASTER_ADDR": "head", "SLURM_NTASKS": "2", "SLURM_PROCID": "1"},
        {}, ("tcp://head:1234", 2, 1)),
    "torchrun": (
        {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29400",
         "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2"},
        {}, ("tcp://127.0.0.1:29400", 4, 2)),
    "arguments_first": (
        {"OPENDCVC_TPU_COORDINATOR": "node0:7000",
         "OPENDCVC_TPU_NUM_PROCS": "8", "OPENDCVC_TPU_PROC_ID": "5"},
        {"coordinator_address": "x:1", "num_processes": 3, "process_id": 0},
        ("tcp://x:1", 3, 0)),
}


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("case", sorted(CASES))
def test_env_parse(case, clean_env):
    """The coordinator, process count and id come from the arguments,
    then OPENDCVC_TPU_*, then SLURM (coordinator MASTER_ADDR:MASTER_PORT,
    port 1234 by default), then torchrun's WORLD_SIZE / RANK; a CPU run
    joins over gloo."""
    env, kw, want = CASES[case]
    for k, v in env.items():
        clean_env.setenv(k, v)
    seen = []
    clean_env.setattr(M.dist, "is_initialized", lambda: False)
    clean_env.setattr(
        M.dist, "init_process_group",
        lambda backend, init_method, world_size, rank:
        seen.append((backend, init_method, world_size, rank)))
    assert M.init_distributed(device="cpu", **kw) == torch.device("cpu")
    assert seen == [("gloo",) + want]


def test_env_missing_raises(clean_env):
    """No coordinator, count or id anywhere: ValueError (the port has no
    pod to autodetect)."""
    clean_env.setenv("MASTER_ADDR", "head")
    with pytest.raises(ValueError, match="process count"):
        M.init_distributed(device="cpu")


def test_cuda_without_cuda_raises(clean_env):
    """device "cuda" never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_distributed("localhost:1", 1, 0, device="cuda")


def test_idempotent_and_gated(clean_env):
    """maybe_init_distributed joins only under OPENDCVC_TPU_DIST; a second
    init_distributed returns the bound device and joins nothing."""
    clean_env.setenv("OPENDCVC_TPU_DIST", "0")
    assert M.maybe_init_distributed("cpu") is None
    assert not dist.is_initialized()
    clean_env.setenv("OPENDCVC_TPU_DIST", "1")
    clean_env.setenv("OPENDCVC_TPU_COORDINATOR", f"localhost:{free_port()}")
    clean_env.setenv("OPENDCVC_TPU_NUM_PROCS", "1")
    clean_env.setenv("OPENDCVC_TPU_PROC_ID", "0")
    try:
        assert M.maybe_init_distributed("cpu") == torch.device("cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        clean_env.setattr(M.dist, "init_process_group", None)
        assert M.init_distributed(device="cpu") == torch.device("cpu")
        mesh = M.make_mesh()
        assert mesh.shape == {"data": 1, "spatial": 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shapes,err", [
    (None, None), ((-1, 1), None), ((1, -1), None), ((2, 1), ValueError),
    ((0, 1), ValueError), ((-2, 1), ValueError), ((1,), ValueError)],
    ids=["default", "infer_data", "infer_spatial", "too_many",
         "zero", "negative", "names_mismatch"])
def test_make_mesh_one_process(shapes, err):
    """Without a process group the mesh holds one rank."""
    if err is not None:
        with pytest.raises(err):
            M.make_mesh(shapes)
        return
    mesh = M.make_mesh(shapes)
    assert mesh.shape == {"data": 1, "spatial": 1}
    assert mesh.coords == {"data": 0, "spatial": 0}
    assert mesh.groups == {"data": None, "spatial": None}


def _grid_rank(dev):
    """Meshes, blocks and the replication check on one of 4 ranks."""
    rank = dist.get_rank()
    out = {}
    for shapes in ((2, 2), (-1, 2), (4, -1), (1, 4)):
        m = M.make_mesh(shapes)
        out[str(shapes)] = (m.shape, m.coords, m.ranks)
    try:
        M.make_mesh((3, -1))
        out["(3, -1)"] = "no error"
    except ValueError:
        out["(3, -1)"] = "ValueError"
    m = M.make_mesh((2, 2))
    x = np.arange(4 * 3 * 8 * 5 * 3).reshape(4, 3, 8, 5, 3)
    out["data_block"] = M.batch_sharding(m, x)
    out["spatial_block"] = M.batch_sharding(m, torch.from_numpy(x),
                                            spatial_dim=2).numpy()
    tree = {"a": torch.arange(6.0), "b": [torch.ones(2, 3)]}
    out["same"] = M.replicate_sharding(m, tree)
    if rank == 2:
        tree["b"][0][1, 2] = 1.0 + 2.0 ** -20
    out["differ"] = M.replicate_sharding(m, tree)
    return out


@pytest.fixture(scope="module")
def grid():
    return run_ranks(4, _grid_rank, timeout=TIMEOUT)


def test_make_mesh_grid(grid):
    """4 ranks: row-major coordinates as JAX reshapes its devices, -1
    inferred, each axis's line of ranks; (3, -1) raises ValueError."""
    for rank, out in enumerate(grid):
        d, s = divmod(rank, 2)
        want = ({"data": 2, "spatial": 2}, {"data": d, "spatial": s},
                {"data": [s, 2 + s], "spatial": [2 * d, 2 * d + 1]})
        assert out["(2, 2)"] == want
        assert out["(-1, 2)"] == want
        assert out["(4, -1)"] == ({"data": 4, "spatial": 1},
                                  {"data": rank, "spatial": 0},
                                  {"data": [0, 1, 2, 3], "spatial": [rank]})
        assert out["(1, 4)"][1] == {"data": 0, "spatial": rank}
        assert out["(3, -1)"] == "ValueError"


def test_batch_sharding(grid):
    """A rank keeps its data row block (replicas on the spatial axis get
    the same rows), and with spatial_dim its block of that dim."""
    x = np.arange(4 * 3 * 8 * 5 * 3).reshape(4, 3, 8, 5, 3)
    for rank, out in enumerate(grid):
        d, s = divmod(rank, 2)
        np.testing.assert_array_equal(out["data_block"],
                                      x[2 * d:2 * d + 2])
        np.testing.assert_array_equal(out["spatial_block"],
                                      x[2 * d:2 * d + 2, :,
                                        4 * s:4 * s + 4])


def test_replicate_sharding(grid):
    """True on every rank for equal trees; False on every rank when one
    rank's leaf differs in one bit pattern."""
    assert all(out["same"] for out in grid)
    assert not any(out["differ"] for out in grid)


def test_batch_sharding_indivisible():
    mesh = M.Mesh({"data": 3, "spatial": 1}, {"data": 0, "spatial": 0},
                  {}, {})
    with pytest.raises(ValueError):
        M.batch_sharding(mesh, np.zeros((8, 2)))
