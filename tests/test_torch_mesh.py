"""The port's ``parallel/mesh.py`` against the JAX package's, on the CPU,
in this process.

``create_mesh``'s refusals word for word (the shape is checked before any
process group is touched, so any rank count can be named), the ``-1``
inference, ``mesh_shape_from_env``, ``megatron_rules`` and
``param_shardings`` against the reference's patterns and
``PartitionSpec``s; then, in a world of one process (a gloo group over
an in-process store), ``shard_params``' placements and its no-op
re-shard, ``global_mesh`` with the ``mesh_axis_size`` gauge,
``context.process_mesh``/``mesh_sharding``, and the refusal of a mesh on
the card without one.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu import telemetry as jtm
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.parallel import mesh as jmesh

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import context as tcontext
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.models import transformer as ttrm
from mxnet_tpu_torch.parallel import mesh as tmesh

BAD_SHAPES = [((16,), ("data",)), ((0, 2), ("batch", "model")),
              ((-1, -1), ("batch", "model")), ((-1, 3), ("batch", "model")),
              ((2, 2), ("data",)), ((-2, 4), ("batch", "model"))]


@pytest.mark.parametrize("shape,axes", BAD_SHAPES)
def test_create_mesh_refusals_match_jax(shape, axes):
    """The reference's message for each shape 8 devices cannot fill."""
    with pytest.raises(JMXNetError) as jerr:
        jmesh.create_mesh(shape, axes, devices=jax.devices("cpu"))
    with pytest.raises(MXNetError) as terr:
        tmesh.create_mesh(shape, axes, devices=list(range(8)))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("shape,axes", [
    ((-1, 2), ("batch", "model")), ((2, -1), ("data", "model")),
    (None, ("data",)), ((4,), ("data",))])
def test_create_mesh_shapes_match_jax(shape, axes):
    """The resolved shape (one ``-1`` inferred) for 8 devices."""
    jm = jmesh.create_mesh(shape, axes, devices=jax.devices("cpu"))
    assert tmesh._validated_shape(shape, axes, 8) == jm.devices.shape


@pytest.mark.parametrize("raw", ["", "2,4", "8", "-1x2", "(4, 2)",
                                 "banana", "2,2,2"])
def test_mesh_shape_from_env_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("MXTPU_MESH_SHAPE", raw)

    def run(fn, err):
        try:
            return fn(8)
        except err as exc:
            return ("error", str(exc))

    assert run(tmesh.mesh_shape_from_env, MXNetError) == \
        run(jmesh.mesh_shape_from_env, JMXNetError)


@pytest.mark.parametrize("kw", [{}, {"shard_embed": False},
                                {"model_axis": "tp"}])
def test_megatron_rules_match_jax(kw):
    got = [(r.pattern, tuple(r.spec)) for r in tmesh.megatron_rules(**kw)]
    want = [(r.pattern, tuple(r.spec)) for r in jmesh.megatron_rules(**kw)]
    assert got == want


def _lm_names():
    return list(ttrm.lm_param_shapes(2, 2, 32, 64, 64, 16))


@pytest.mark.parametrize("rules", ["megatron", "none", "custom"])
def test_param_shardings_match_jax_specs(rules):
    """Each LM parameter's spec against the reference's PartitionSpec
    (the first matching rule, else replicated)."""
    rule_sets = {
        "megatron": (tmesh.megatron_rules(), jmesh.megatron_rules()),
        "none": ((), ()),
        "custom": ((tmesh.ShardingRule(r".*_bias$", ("data",)),),
                   (jmesh.ShardingRule(r".*_bias$", ("data",)),))}
    trules, jrules = rule_sets[rules]
    jm = jmesh.create_mesh((2, 2), ("data", "model"),
                           devices=jax.devices("cpu")[:4])
    tm = tmesh.Mesh(None, ("data", "model"), np.arange(4).reshape(2, 2),
                    torch.device("cpu"))
    got = tmesh.param_shardings(tm, _lm_names(), trules)
    want = jmesh.param_shardings(jm, _lm_names(), jrules)
    assert {k: v.spec for k, v in got.items()} == \
        {k: tuple(v.spec) for k, v in want.items()}


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    tm = tmesh.Mesh(None, ("data", "model"), np.arange(4).reshape(2, 2),
                    torch.device("cpu"))
    NS = tmesh.NamedSharding
    assert NS(tm, ("model", None)).placements == (Replicate(), Shard(0))
    assert NS(tm, (None, "model")).placements == (Replicate(), Shard(1))
    assert NS(tm, ("data", None, "model")).placements == (Shard(0),
                                                          Shard(2))
    assert tmesh.replicated(tm).placements == (Replicate(), Replicate())
    assert tmesh.data_sharding(tm, 3).spec == ("data", None, None)
    assert NS(tm, ("model", None)) == NS(tm, ("model",))
    assert tmesh.replicated(tm).is_fully_replicated


def test_a_mesh_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmesh.create_mesh((1,), ("data",))


# ------------------------------------------------------ a world of one
@pytest.fixture(scope="module")
def world1():
    """A gloo group of one process, brought up by ``create_mesh`` (no
    launcher environment) and torn down after the module."""
    import torch.distributed as td

    owned = not td.is_initialized()
    mesh = tmesh.create_mesh((1, 1), ("data", "model"), device="cpu")
    yield mesh
    if owned and td.is_initialized():
        td.destroy_process_group()


def test_world_of_one_mesh(world1):
    import torch.distributed as td

    assert td.get_backend() == "gloo" and td.get_world_size() == 1
    assert dict(world1.shape) == {"data": 1, "model": 1}
    assert world1.axis_names == ("data", "model")
    assert world1.devices.shape == (1, 1) and world1.size == 1
    assert world1.coordinate("model") == 0


def test_shard_params_placements_and_noop_reshard(world1):
    """Every parameter a DTensor placed by its rule; re-sharding the
    placed dict returns the very same objects (the reference's
    micro-assert), and a dict placed otherwise moves."""
    from torch.distributed.tensor import Replicate, Shard

    rs = np.random.RandomState(0)
    params = {"fc1_weight": rs.randn(8, 4).astype(np.float32),
              "fc1_bias": torch.zeros(8),
              "other": rs.randn(6, 3).astype(np.float32)}
    rules = [tmesh.ShardingRule(r"fc1_weight", ("model", None))]
    placed = tmesh.shard_params(world1, params, rules)
    assert placed["fc1_weight"].placements == (Replicate(), Shard(0))
    assert placed["other"].placements == (Replicate(), Replicate())
    np.testing.assert_array_equal(placed["fc1_weight"].full_tensor().numpy(),
                                  params["fc1_weight"])
    again = tmesh.shard_params(world1, placed, rules)
    assert all(again[k] is placed[k] for k in placed)
    moved = tmesh.shard_params(world1, placed)
    assert moved["fc1_weight"] is not placed["fc1_weight"]
    assert moved["fc1_weight"].placements == (Replicate(), Replicate())
    assert moved["other"] is placed["other"]


def test_copy_full_into_and_local_blocks(world1):
    from torch.distributed.tensor import distribute_tensor

    sh = tmesh.NamedSharding(world1, ("model", None))
    full = torch.arange(12.0).reshape(4, 3)
    dt = distribute_tensor(torch.zeros(4, 3), world1.device_mesh,
                           sh.placements)
    tmesh.copy_full_into(dt, full.numpy())
    assert torch.equal(dt.full_tensor(), full)
    assert torch.equal(tmesh.narrow_local(full, sh), full)
    assert tmesh.full_value(full) is full


def test_global_mesh_and_axis_gauge(world1, monkeypatch):
    """``global_mesh`` over the world's one rank: ("batch", "model")
    sized by ``MXTPU_MESH_SHAPE`` (default (ranks, 1)), cached, a bad
    value refused with the reference's words; the ``mesh_axis_size``
    gauge has the reference's schema and records each axis."""
    ttm.reset()
    ttm.enable()
    try:
        monkeypatch.delenv("MXTPU_MESH_SHAPE", raising=False)
        m = tmesh.global_mesh(device="cpu")
        assert m.axis_names == ("batch", "model")
        assert dict(m.shape) == {"batch": 1, "model": 1}
        assert tmesh.global_mesh(device="cpu") is m
        fam = ttm.get_registry().get("mesh_axis_size")
        ref = jtm.get_registry().get("mesh_axis_size")
        assert (fam.typename, fam.labelnames, fam.help) == \
            (ref.typename, ref.labelnames, ref.help)
        assert fam.value(axis="batch") == 1 and fam.value(axis="model") == 1
        monkeypatch.setenv("MXTPU_MESH_SHAPE", "3,1")
        with pytest.raises(MXNetError, match="multiple of 3"):
            tmesh.global_mesh(device="cpu")
        monkeypatch.setenv("MXTPU_MESH_SHAPE", "banana")
        with pytest.raises(MXNetError, match="expected integers"):
            tmesh.global_mesh(device="cpu")
    finally:
        ttm.reset()
        ttm.enable(False)


def test_context_process_mesh_and_sharding(world1, monkeypatch):
    from torch.distributed.tensor import Replicate, Shard

    monkeypatch.delenv("MXTPU_MESH_SHAPE", raising=False)
    pm = tcontext.process_mesh(device="cpu")
    assert pm is tmesh.global_mesh(device="cpu")
    sh = tcontext.mesh_sharding(("model",), device="cpu")
    assert sh.mesh is pm and sh.placements == (Replicate(), Shard(0))
    assert tcontext.mesh_sharding(device="cpu").is_fully_replicated
    assert tcontext.mesh_sharding("batch", device="cpu").spec == ("batch",)


def test_flash_op_refuses_a_split_sequence(world1):
    """The FlashAttention op under a mesh runs each rank's rows and
    heads; a query split on T is refused by name (the ring's work)."""
    from torch.distributed.tensor import distribute_tensor

    from mxnet_tpu_torch.ops import registry

    sh = tmesh.NamedSharding(world1, (None, None, "model"))
    q = distribute_tensor(torch.zeros(1, 2, 8, 8), world1.device_mesh,
                          sh.placements)
    with pytest.raises(MXNetError, match="ring_attention"):
        registry.get("FlashAttention").fn(registry.OpCtx(), q, q, q)


LAUNCHED = r"""
import json, os, sys
import torch
import mxnet_tpu_torch  # noqa: F401
import torch.distributed as td
from mxnet_tpu_torch.parallel import mesh as tmesh

mesh = tmesh.create_mesh((2,), ("data",), device="cpu")
x = torch.tensor([float(td.get_rank())])
td.all_reduce(x, group=mesh.get_group("data"))
with open(os.path.join(sys.argv[1], "rank%d.json" % td.get_rank()),
          "w") as f:
    json.dump({"rank": td.get_rank(), "world": td.get_world_size(),
               "backend": td.get_backend(), "sum": float(x)}, f)
td.destroy_process_group()
"""


def test_launcher_brings_up_a_mesh_world(tmp_path):
    """``python -m mxnet_tpu_torch.launch -n 2 -s 0`` gives its workers a
    rendezvous address: each builds the same (2,) mesh over one gloo
    group on the CPU and an all-reduce over ``data`` sums both ranks."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "launched.py"
    script.write_text(LAUNCHED)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env["PYTHONPATH"] = repo
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2", "-s",
         "0", "--launcher", "local", sys.executable, str(script),
         str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env, cwd=repo)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert got == [{"rank": r, "world": 2, "backend": "gloo", "sum": 1.0}
                   for r in range(2)]
