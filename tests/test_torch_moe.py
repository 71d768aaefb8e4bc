"""The port's expert parallelism against the JAX package's, on the CPU.

One port counterpart for each MoE case of ``tests/test_pipeline_moe.py``
(top-1 and top-2 ``moe_ffn`` against the reference's function and its
loop oracles, SGD training with gradients held to ``jax.grad``, the bf16
routing regression, the ``train_moe.py`` LM), plus the refusal and
``init_moe_params``.  The port's side runs in one gloo world of 4
processes on an ``expert`` mesh of 4 (``tests/torch_mesh_worlds.py``);
the JAX side is the reference's own functions on 4 of the virtual CPU
devices, from the same numpy-seeded inputs and weights.  Tolerances are
the reference test's own: outputs rtol 1e-4 / atol 1e-5, losses rtol
1e-5, gradients rtol 2e-4 / atol 1e-5; bf16 slot positions exact.
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel import moe as jmoe
from mxnet_tpu.parallel.mesh import create_mesh as jcreate_mesh

import test_pipeline_moe as ref
import torch_mesh_worlds as worlds
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E = 4
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
LOSS_RTOL = 1e-5
TRAIN_STEPS = 12
LM_STEPS = 8


def _jmesh():
    return jcreate_mesh((E,), ("expert",), devices=jax.devices("cpu")[:E])


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _jax_ffn(seed, top_k, per_dev=6):
    rs = np.random.RandomState(seed)
    params = ref.init_moe_params(rs, 8, 16)
    x = rs.normal(size=(per_dev * E, 8)).astype(np.float32)
    y, aux = jmoe.moe_ffn(params, jnp.asarray(x), _jmesh(), "expert",
                          capacity_factor=1.25, top_k=top_k)
    oracle = ref._dense_moe if top_k == 1 else ref._dense_moe_top2
    cap = max(1, int(1.25 * top_k * per_dev / E))
    dense = np.concatenate([oracle(params, x[d * per_dev:(d + 1) * per_dev],
                                   cap) for d in range(E)])
    return (dict(params=_np_tree(params), x=x, top_k=top_k, cf=1.25),
            dict(y=np.asarray(y), aux=float(aux), dense=dense))


def _jax_train(seed, top_k):
    rs = np.random.RandomState(seed)
    params = ref.init_moe_params(rs, 8, 16)
    x = rs.normal(size=(24, 8)).astype(np.float32)
    tgt = rs.normal(size=(24, 8)).astype(np.float32)
    case = dict(params=_np_tree(params), x=x, tgt=tgt, top_k=top_k,
                steps=TRAIN_STEPS)
    mesh = _jmesh()

    def loss_fn(p):
        y, aux = jmoe.moe_ffn(p, jnp.asarray(x), mesh, "expert", top_k=top_k)
        return jnp.mean((y - tgt) ** 2) + 0.01 * aux

    step = jax.jit(jax.value_and_grad(loss_fn))
    losses, first = [], None
    for i in range(TRAIN_STEPS):
        loss, g = step(params)
        losses.append(float(loss))
        if i == 0:
            first = _np_tree(g)
        params = {k: v - 0.3 * g[k] for k, v in params.items()}
    return case, dict(losses=losses, grads=first)


def _jax_bf16():
    d, per_dev = 8, 900
    eye = jnp.eye(d, dtype=jnp.float32)
    params = {"gate_w": jnp.concatenate(
        [jnp.full((d, 1), 50.0)] + [jnp.zeros((d, 1))] * (E - 1), axis=1),
        "w_in": jnp.stack([eye] * E), "w_out": jnp.stack([eye] * E)}
    rs = np.random.RandomState(5)
    x_np = rs.uniform(0.5, 1.5, (per_dev * E, d)).astype(np.float32)
    y, _ = jmoe.moe_ffn(params, jnp.asarray(x_np, jnp.bfloat16), _jmesh(),
                        "expert", capacity_factor=1.25)
    cap = int(1.25 * per_dev / E)
    return (dict(params=_np_tree(params),
                 x=np.asarray(jnp.asarray(x_np, jnp.bfloat16)), top_k=1,
                 cf=1.25, routing=True),
            dict(y=np.asarray(y.astype(jnp.float32)), x=x_np, cap=cap,
                 per_dev=per_dev))


def _load_train_moe():
    path = os.path.join(REPO, "examples", "transformer-lm")
    sys.path.insert(0, path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_train_moe_example", os.path.join(path, "train_moe.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(path)
    return mod


def _jax_lm():
    """train_moe.py's main loop at its defaults (4 experts, 2 layers,
    d_model 32, top-2, batch 4 x 16), ``LM_STEPS`` SGD steps."""
    ex = _load_train_moe()
    layers, D, heads, T, vocab, B, top_k = 2, 32, 2, 16, 64, 4, 2
    lr, aux_w = 0.3, 0.01
    mesh = _jmesh()
    rs = np.random.RandomState(0)
    params = ex.init_params(rs, layers, D, E, vocab)
    X = jnp.asarray(rs.randint(0, vocab, (B, T)).astype(np.int32))
    Y = (X * 5 + 3) % vocab
    case = dict(params=_np_tree(params), X=np.asarray(X), Y=np.asarray(Y),
                heads=heads, top_k=top_k, lr=lr, aux_weight=aux_w,
                steps=LM_STEPS)

    def loss_fn(p):
        logits, aux = ex.forward(p, X, heads, mesh, top_k)
        lp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(lp, Y[..., None], axis=-1).mean()
        return nll + aux_w * aux, (nll, aux)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    nlls, auxes = [], []
    for _ in range(LM_STEPS):
        (_, (nll, aux)), grads = step(params)
        params = jax.tree_util.tree_map(lambda w, d: w - lr * d, params,
                                        grads)
        nlls.append(float(nll))
        auxes.append(float(aux))
    return case, dict(nll=nlls, aux=auxes)


@pytest.fixture(scope="module")
def runs():
    jax_runs, cases = {}, []
    for name, seed, k in (("top1", 2, 1), ("top2", 4, 2)):
        case, jax_runs[name] = _jax_ffn(seed, k)
        cases.append(dict(case, name=name, kind="ffn"))
    for name, seed, k in (("train1", 3, 1), ("train2", 6, 2)):
        case, jax_runs[name] = _jax_train(seed, k)
        cases.append(dict(case, name=name, kind="train"))
    case, jax_runs["bf16"] = _jax_bf16()
    cases.append(dict(case, name="bf16", kind="ffn"))
    case, jax_runs["lm"] = _jax_lm()
    cases.append(dict(case, name="lm", kind="lm"))
    port = worlds.run_world(4, "moe_scenarios", cases)
    return {"jax": jax_runs, "port": port}


def _check_ffn(got, want):
    np.testing.assert_allclose(got["y"], want["y"], **OUT_TOL)
    np.testing.assert_allclose(got["y"], want["dense"], **OUT_TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
    assert np.isfinite(got["aux"])


def test_moe_matches_dense_oracle(runs):
    """Top-1 (Switch): the port's output against the reference's
    function and its per-device loop oracle (capacity per rank)."""
    _check_ffn(runs["port"]["top1"], runs["jax"]["top1"])


def test_moe_top2_matches_dense_oracle(runs):
    """Top-2 (GShard/Mixtral): choice-major slots, renormalized gates."""
    _check_ffn(runs["port"]["top2"], runs["jax"]["top2"])


def _check_train(got, want):
    """Losses at every step and the first step's gradients against
    ``jax.grad`` of the reference's loss: each rank backpropagates its
    share and the replicated gate's gradient is summed over the axis."""
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                   err_msg=k, **GRAD_TOL)
    assert got["losses"][-1] < got["losses"][0]
    assert np.abs(got["grads"]["gate_w"]).max() > 0


def test_moe_trains(runs):
    _check_train(runs["port"]["train1"], runs["jax"]["train1"])


def test_moe_top2_trains(runs):
    _check_train(runs["port"]["train2"], runs["jax"]["train2"])


def test_moe_bf16_routing_exact(runs):
    """bf16 activations, every token to expert 0, > 256 tokens a rank:
    the slot positions are exactly 0, 1, 2, ... (integer bookkeeping),
    kept tokens come back as themselves, dropped ones exactly 0, and the
    output equals the reference's."""
    got, want = runs["port"]["bf16"], runs["jax"]["bf16"]
    per_dev, cap = want["per_dev"], want["cap"]
    np.testing.assert_array_equal(
        got["slots"][:, :, 0], np.tile(np.arange(per_dev), (E, 1)))
    np.testing.assert_array_equal(
        got["keep"][:, :, 0], np.tile(np.arange(per_dev) < cap, (E, 1)))
    for dev in range(E):
        shard = got["y"][dev * per_dev:(dev + 1) * per_dev]
        np.testing.assert_allclose(shard[:cap],
                                   want["x"][dev * per_dev:][:cap],
                                   rtol=0.02, atol=0.02)
        assert np.all(shard[cap:] == 0.0)
    np.testing.assert_allclose(got["y"], want["y"], **OUT_TOL)


def test_moe_lm_example_converges(runs):
    """train_moe.py's LM (top-2, 4 experts) through the port's copy:
    NLL and balance aux at every one of 8 SGD steps against the
    reference's loop, and the NLL falling."""
    got, want = runs["port"]["lm"], runs["jax"]["lm"]
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=LOSS_RTOL)
    assert got["nll"][-1] < got["nll"][0]


@pytest.mark.parametrize("top_k", [0, E + 1])
def test_top_k_out_of_range_refused(top_k):
    """The reference's ValueError, raised before any exchange (a port
    ``Mesh`` of 4 ranks without a process group)."""
    tm = tmesh.Mesh(None, ("expert",), np.arange(E), torch.device("cpu"))
    p = {"gate_w": torch.zeros(8, E), "w_in": torch.zeros(E, 8, 16),
         "w_out": torch.zeros(E, 16, 8)}
    with pytest.raises(ValueError) as terr:
        tmoe.moe_ffn(p, torch.zeros(8, 8), tm, top_k=top_k)
    with pytest.raises(ValueError) as jerr:
        jmoe.moe_ffn({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                     jnp.zeros((8, 8)), _jmesh(), top_k=top_k)
    assert str(terr.value) == str(jerr.value)


def test_init_moe_params_by_statistics():
    """``init_moe_params`` from a ``torch.Generator`` against the
    reference's from a JAX key: the same shapes, dtypes and scale."""
    d, h, n, scale = 64, 128, E, 0.02
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(0), d, h, n,
                              scale=scale, device="cpu")
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), d, h, n, scale=scale)
    assert tp.keys() == jp.keys()
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == torch.float32 and jp[k].dtype == jnp.float32
        for a in (tp[k].numpy(), np.asarray(jp[k])):
            # five standard errors of the sample mean and deviation
            assert abs(a.mean()) < 5 * scale / np.sqrt(a.size)
            assert abs(a.std() / scale - 1) < 5 / np.sqrt(2 * a.size)
    again = tmoe.init_moe_params(torch.Generator().manual_seed(0), d, h, n,
                                 scale=scale, device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)
