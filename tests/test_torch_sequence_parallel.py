"""The port's ring and Ulysses attention against the JAX package's, on the
CPU.

The cases of ``tests/test_parallel.py:33-78`` (a ``seq`` mesh of 4:
full and causal, the gradients of ``sum(out ** 2)``), ``:301`` and
``:731`` (dp x sp: the batch split over ``data`` and the sequence over
``seq``, each data replica running its own ring or all-to-all).  The
port's side runs in one gloo world of 4 processes
(``tests/torch_mesh_worlds.py``), so its dp x sp mesh is (2, 2) where
the reference's is (2, 4); the JAX side is the reference's functions on
the virtual CPU mesh, from the same numpy-seeded q, k, v.  The
tolerances are the reference's own against ``full_attention``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mxnet_tpu.parallel.mesh import create_mesh as jcreate_mesh
from mxnet_tpu.parallel.ring_attention import ring_attention as jring
from mxnet_tpu.parallel.ring_attention import ulysses_attention as julysses

import torch_mesh_worlds as worlds


def _qkv(b=2, h=4, t=32, d=8, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))


def _normal_qkv(b, h, t, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.normal(size=(b, h, t, d)).astype(np.float32)
                 for _ in range(3))


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return jcreate_mesh(shape, axes, devices=jax.devices("cpu")[:n])


# name: (function, qkv, causal, grad, dp x sp)
CASES = {
    "ring": ("ring_attention", _qkv(), False, False, False),
    "ring_causal": ("ring_attention", _qkv(seed=1), True, False, False),
    "ring_grads": ("ring_attention", _qkv(seed=2, t=16), True, True, False),
    "ulysses": ("ulysses_attention", _qkv(h=8), False, False, False),
    "ulysses_causal": ("ulysses_attention", _qkv(h=8), True, False, False),
    "ulysses_grads": ("ulysses_attention", _qkv(h=8, seed=2, t=16), True,
                      True, False),
    "ring_dp_sp": ("ring_attention", _normal_qkv(4, 2, 32, 8, 9), True,
                   False, True),
    "ulysses_dp_sp": ("ulysses_attention", _normal_qkv(4, 4, 32, 8, 11),
                      True, False, True),
}
JFN = {"ring_attention": jring, "ulysses_attention": julysses}


def _jax_case(fn, qkv, causal, grad, dp_sp):
    f = JFN[fn]
    q, k, v = map(jnp.asarray, qkv)
    if dp_sp:
        mesh = _jmesh((2, 4), ("data", "seq"))
        sh = NamedSharding(mesh, P("data", None, "seq", None))
        q, k, v = (jax.device_put(x, sh) for x in (q, k, v))
        return {"out": np.asarray(f(q, k, v, mesh, "seq", causal=causal,
                                    batch_axis="data"))}
    mesh = _jmesh((4,), ("seq",))
    out = {"out": np.asarray(f(q, k, v, mesh, causal=causal))}
    if grad:
        def loss(q, k, v):
            return jnp.sum(f(q, k, v, mesh, causal=causal) ** 2)

        # jitted: one compile instead of the eager dispatch of every
        # primitive of the ring's backward
        out["grads"] = [np.asarray(g) for g in
                        jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]
    return out


@pytest.fixture(scope="module")
def runs():
    jax_runs = {name: _jax_case(*case) for name, case in CASES.items()}
    cases = []
    for name, (fn, qkv, causal, grad, dp_sp) in CASES.items():
        cases.append(dict(name=name, fn=fn, qkv=qkv, causal=causal,
                          grad=grad,
                          mesh=(2, 2) if dp_sp else (4,),
                          axes=("data", "seq") if dp_sp else ("seq",),
                          batch_axis="data" if dp_sp else None))
    port = worlds.run_world(4, "seq_scenarios", cases)
    return {"jax": jax_runs, "port": port}


@pytest.mark.parametrize("name", ["ring", "ring_causal", "ulysses",
                                  "ulysses_causal"])
def test_matches_jax(runs, name):
    np.testing.assert_allclose(runs["port"][name]["out"],
                               runs["jax"][name]["out"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["ring_grads", "ulysses_grads"])
def test_gradients_match_jax(runs, name):
    """``jax.grad`` of the reference's function against the port's
    backward, which rotates (or exchanges) in reverse."""
    got, want = runs["port"][name], runs["jax"][name]
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-4,
                               atol=1e-5)
    for g, w, what in zip(got["grads"], want["grads"], "qkv"):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4,
                                   err_msg=f"d{what}")


@pytest.mark.parametrize("name", ["ring_dp_sp", "ulysses_dp_sp"])
def test_dp_sp_matches_jax(runs, name):
    np.testing.assert_allclose(runs["port"][name]["out"],
                               runs["jax"][name]["out"], rtol=2e-4,
                               atol=1e-5)


def test_ulysses_refuses_heads_the_axis_does_not_divide():
    """The reference's ValueError, raised before any exchange (a port
    ``Mesh`` of 3 ranks is built without a process group)."""
    import torch

    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel.ring_attention import ulysses_attention

    q = torch.zeros(1, 4, 6, 8)
    tm = tmesh.Mesh(None, ("seq",), np.arange(3), torch.device("cpu"))
    with pytest.raises(ValueError) as port_err:
        ulysses_attention(q, q, q, tm)
    with pytest.raises(ValueError) as jax_err:
        julysses(jnp.zeros((1, 4, 6, 8)), jnp.zeros((1, 4, 6, 8)),
                 jnp.zeros((1, 4, 6, 8)), _jmesh((3,), ("seq",)))
    assert str(port_err.value) == str(jax_err.value)
