"""The port's ``FusedTrainer`` on a mesh against the JAX package's, on the
CPU: data parallel over 4 ranks, Megatron tensor parallel (1, 4), dp x
tp (2, 2) in fp32 SGD and bf16 Adam, ``step_multi`` under the mesh, and
a checkpoint written under the mesh and loaded by a trainer without one.

The port's side runs in one gloo world of 4 processes
(``tests/torch_mesh_worlds.py``: each rank builds the same global batch
and keeps its rows, as the reference's multi-host feed does); the JAX
side is the reference's own trainer on the 8-device virtual CPU mesh,
each case the one of ``tests/test_parallel.py`` it names, from the same
numpy-seeded inputs and the same initial weights (the JAX trainer's,
loaded into the port's through ``convert.load_trainer_params``).
Tolerances are stated where they are used.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.models import transformer as jtrm
from mxnet_tpu.parallel.mesh import create_mesh as jcreate_mesh
from mxnet_tpu.parallel.mesh import megatron_rules as jmegatron_rules
from mxnet_tpu.test_utils import get_synthetic_mnist
from mxnet_tpu.trainer import FusedTrainer as JTrainer

from mxnet_tpu_torch.models import transformer as ttrm
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

import torch_mesh_worlds as worlds

TP_LM = dict(num_layers=2, num_heads=2, d_model=32, seq_len=16,
             vocab_size=64)
LM_SHAPES = {"data": (8, 16), "softmax_label": (8, 16)}
DP_TP_STEPS = 4
BF16_STEPS = 3


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return jcreate_mesh(shape, axes, devices=jax.devices("cpu")[:n])


def _host(params):
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def _tp_batch(n=8, t=16, vocab=64, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (n, t)).astype(np.float32),
            rs.randint(0, vocab, (n, t)).astype(np.float32))


def _nll(out, y, vocab=64):
    p = np.asarray(out, np.float32).reshape(-1, vocab)
    lab = y.reshape(-1).astype(int)
    return float(-np.log(p[np.arange(lab.size), lab] + 1e-9).mean())


# ---------------------------------------------------------- JAX runs
def _jax_dp():
    """``test_data_parallel_grads_match_single_device``'s mesh run."""
    (xtr, ytr), _ = get_synthetic_mnist(64, 8)
    mx.random.seed(0)
    np.random.seed(0)
    net = jmodels.get_symbol("mlp", num_classes=10)
    tr = JTrainer(net, optimizer="sgd",
                  optimizer_params={"lr": 0.5, "rescale_grad": 1.0 / 32},
                  mesh=_jmesh((4,), ("data",)), initializer=mx.init.Xavier())
    tr.init(data=(32, 1, 28, 28))
    w0 = _host(tr.params)
    batch = {"data": xtr[:32], "softmax_label": ytr[:32]}
    for _ in range(2):
        tr.step(**batch)
    return w0, [batch, batch], _host(tr.params)


def _jax_tp():
    """``test_transformer_tp_matches_dense_oracle``'s TP run."""
    X, Y = _tp_batch()
    net = jtrm.transformer_lm(**TP_LM)
    dense = JTrainer(net, optimizer="sgd", optimizer_params={"lr": 0.1})
    dense.init(**LM_SHAPES)
    w0 = _host(dense.params)
    tp = JTrainer(net, optimizer="sgd", optimizer_params={"lr": 0.1},
                  mesh=_jmesh((1, 4), ("data", "model")),
                  sharding_rules=jmegatron_rules())
    tp.init(**LM_SHAPES)
    for k in list(tp.params):
        tp.params[k] = jax.device_put(w0[k], tp.params[k].sharding)
    tp._refresh_compute_cache()
    outs = [np.asarray(tp.step(data=X, softmax_label=Y)[0])
            for _ in range(3)]
    return w0, outs, _host(tp.params)


def _jax_dp_tp(dtype, optimizer, opt, steps, seed):
    """``test_transformer_dp_tp_mesh_trains``' (2, 2) mesh: Xavier
    weights from one numpy seed, the same batch every step."""
    X, Y = _tp_batch()
    mx.random.seed(seed)
    np.random.seed(seed)
    tr = JTrainer(jtrm.transformer_lm(**TP_LM), optimizer=optimizer,
                  optimizer_params=dict(opt), dtype=dtype,
                  mesh=_jmesh((2, 2), ("data", "model")),
                  sharding_rules=jmegatron_rules(),
                  initializer=mx.init.Xavier())
    tr.init(**LM_SHAPES)
    w0 = _host(tr.params)
    outs = [np.asarray(tr.step(data=X, softmax_label=Y)[0], np.float32)
            for _ in range(steps)]
    return w0, outs, _host(tr.params)


def _fit_data():
    (xtr, ytr), _ = get_synthetic_mnist(64, 8)
    return xtr[:64], ytr[:64]


def _plain_dp_fit(w0, batches):
    """The DP case's steps and its epoch of ``fit`` in one port process
    without a mesh, from the same weights."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import metric as tmetric
    from mxnet_tpu_torch.models import mlp as tmlp

    tr = TTrainer(tmlp.get_symbol(num_classes=10), optimizer="sgd",
                  optimizer_params={"lr": 0.5, "rescale_grad": 1.0 / 32},
                  device="cpu")
    tr.init(data=(32, 1, 28, 28), softmax_label=(32,))
    convert.load_trainer_params(tr, w0)
    for b in batches:
        tr.step(**b)
    data, label = _fit_data()
    acc = tmetric.create("acc")
    tr.fit(tio.NDArrayIter(data, label, batch_size=len(label) // 2),
           eval_metric=acc, num_epoch=1)
    return {k: v.numpy() for k, v in tr.params.items()}, acc.get()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's JAX run, then the port's in one world of 4 ranks."""
    ck = str(tmp_path_factory.mktemp("mesh_ck") / "lm")
    X, Y = _tp_batch()
    lm_batch = {"data": X, "softmax_label": Y}
    jax_runs = {
        "dp": _jax_dp(),
        "tp": _jax_tp(),
        "dp_tp": _jax_dp_tp("float32", "sgd",
                            {"lr": 0.5, "rescale_grad": 1.0 / X.size},
                            DP_TP_STEPS, 0),
        "bf16": _jax_dp_tp("bfloat16", "adam", {"lr": 1e-3}, BF16_STEPS, 1),
    }
    dp_w0, dp_batches, _ = jax_runs["dp"]
    cases = [
        dict(name="dp", mesh=(4,), axes=("data",), net="mlp",
             optimizer="sgd", opt={"lr": 0.5, "rescale_grad": 1.0 / 32},
             weights=dp_w0, shapes={"data": (32, 1, 28, 28),
                                    "softmax_label": (32,)},
             batches=dp_batches, fit=_fit_data()),
        dict(name="tp", mesh=(1, 4), axes=("data", "model"), net=TP_LM,
             optimizer="sgd", opt={"lr": 0.1}, weights=jax_runs["tp"][0],
             shapes=LM_SHAPES, batches=[lm_batch] * 3),
        dict(name="dp_tp", mesh=(2, 2), axes=("data", "model"), net=TP_LM,
             optimizer="sgd", opt={"lr": 0.5, "rescale_grad": 1.0 / X.size},
             weights=jax_runs["dp_tp"][0], shapes=LM_SHAPES,
             batches=[lm_batch] * DP_TP_STEPS),
        dict(name="bf16", mesh=(2, 2), axes=("data", "model"), net=TP_LM,
             optimizer="adam", opt={"lr": 1e-3}, dtype="bfloat16",
             weights=jax_runs["bf16"][0], shapes=LM_SHAPES,
             batches=[lm_batch] * BF16_STEPS, checkpoint=ck),
        dict(name="multi", mesh=(2, 2), axes=("data", "model"), net=TP_LM,
             optimizer="sgd", opt={"lr": 0.5, "rescale_grad": 1.0 / X.size},
             weights=jax_runs["dp_tp"][0], shapes=LM_SHAPES,
             batches=[lm_batch] * 3, step_multi=True),
    ]
    port = worlds.run_world(4, "train_scenarios", {"cases": cases})
    return {"jax": jax_runs, "port": port, "ck": ck,
            "dp_batches": dp_batches}


def _cmp_params(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_data_parallel_matches_jax(runs):
    """``test_parallel.py:94``: mlp, batch 32 split over 4 ranks, 2 SGD
    steps; the parameters at the reference's rtol 1e-4 / atol 1e-5."""
    port = runs["port"]["dp"]
    _cmp_params(port["params"], runs["jax"]["dp"][2], 1e-4, 1e-5)
    # every parameter is replicated over 'data'
    assert all(p == "(Replicate(),)" for p in port["placements"].values())


def test_fit_over_the_data_mesh(runs):
    """After the DP steps, one epoch of ``fit`` (2 batches of 32 over
    the 4 ranks, the accuracy metric reading the gathered outputs) gives
    the port's run without a mesh: the metric equal, the parameters at
    the DP test's 1e-4 / 1e-5."""
    port = runs["port"]["dp"]
    params, acc = _plain_dp_fit(runs["jax"]["dp"][0], runs["dp_batches"])
    assert port["fit_acc"] == acc
    _cmp_params(port["fit_params"], params, 1e-4, 1e-5)


def test_tensor_parallel_matches_jax(runs):
    """``test_parallel.py:213``: Megatron TP (1, 4) over the small LM, 3
    SGD steps: outputs at the reference's 1e-5, parameters at its 5e-5
    (the sharded reductions' order differs)."""
    port, (_, jouts, jparams) = runs["port"]["tp"], runs["jax"]["tp"]
    for got, want in zip(port["outs"], jouts):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _cmp_params(port["params"], jparams, 5e-5, 5e-5)
    # the rules split things (not a replicated no-op): each rank holds a
    # quarter of the q/k/v rows, of the proj columns and of the vocab
    shapes = port["local_shapes"]
    for name in ("layer0_q_weight", "layer0_k_weight", "layer0_v_weight"):
        assert shapes[name] == (8, 32), name
    assert shapes["layer0_proj_weight"] == (32, 8)
    assert shapes["lm_head_weight"] == (16, 32)
    assert shapes["tok_embed_weight"] == (16, 32)
    assert shapes["layer0_ffn_in_bias"] == (32,)
    assert port["placements"]["layer0_proj_bias"] == \
        "(Replicate(), Replicate())"


def test_dp_tp_losses_match_jax(runs):
    """(2, 2) dp x tp from the JAX trainer's Xavier weights, lr 0.5: the
    per-step losses at 1e-4 absolute (the reference's run trains, its
    first loss about 4.16), the outputs and parameters at 5e-5."""
    port, (_, jouts, jparams) = runs["port"]["dp_tp"], runs["jax"]["dp_tp"]
    _, Y = _tp_batch()
    for got, want in zip(port["outs"], jouts):
        assert abs(_nll(got, Y) - _nll(want, Y)) < 1e-4
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
    assert _nll(port["outs"][-1], Y) < _nll(port["outs"][0], Y)
    _cmp_params(port["params"], jparams, 5e-5, 5e-5)
    assert port["placements"]["lm_head_weight"] == \
        "(Replicate(), Shard(dim=0))"


def test_dp_tp_bf16_adam_matches_jax(runs):
    """bf16 compute, fp32 masters, Adam (no bias correction) on (2, 2).
    The two packages round bf16 at other places (``test_torch_trainer.py``
    holds one step at 3e-2 relative); from these Xavier weights the port
    without a mesh parts from JAX by up to 5.5e-2 relative at step 3
    (measured), so the outputs are held at 8e-2 relative and 2e-5
    absolute, the losses at 2e-3.  An Adam step without bias correction
    moves an entry by at most (1 - b1^t) / sqrt(1 - b2^t) lr: 12.4 lr
    over three steps, so masters whose gradients are rounding noise (the
    key biases) may part by 2 x 12.4e-3; the masters are held there."""
    port, (_, jouts, jparams) = runs["port"]["bf16"], runs["jax"]["bf16"]
    _, Y = _tp_batch()
    for got, want in zip(port["outs"], jouts):
        np.testing.assert_allclose(got, want, rtol=8e-2, atol=2e-5)
        assert abs(_nll(got, Y) - _nll(want, Y)) < 2e-3
    _cmp_params(port["params"], jparams, 0, 2.5e-2)


def test_step_multi_under_the_mesh(runs):
    """``step_multi`` over 3 stacked batches on the (2, 2) mesh: over
    gloo it runs the steps eagerly, equal to the bit to 3 ``step()``
    calls of a twin trainer, and both to the JAX (2, 2) run's first 3
    steps at 5e-5."""
    port = runs["port"]["multi"]
    assert port["k"] == 3
    np.testing.assert_array_equal(port["multi_out"], port["eager_out"])
    for k, v in port["params"].items():
        np.testing.assert_array_equal(v, port["twin_params"][k])
    for got, want in zip(port["multi_out"], runs["jax"]["dp_tp"][1]):
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_checkpoint_under_the_mesh_loads_without_one(runs):
    """The bf16 Adam (2, 2) trainer's checkpoint, gathered to full
    tensors and written by rank 0, loads bit-equal into a port trainer
    without a mesh: masters and both Adam slots, through the Module
    format with the optimizer states and through the survival
    checkpoint."""
    port = runs["port"]["bf16"]
    for how in ("load_checkpoint", "restore_state"):
        tr = TTrainer(ttrm.transformer_lm(**TP_LM), optimizer="adam",
                      optimizer_params={"lr": 1e-3}, dtype="bfloat16",
                      device="cpu")
        tr.init(**LM_SHAPES)
        if how == "load_checkpoint":
            tr.load_checkpoint(runs["ck"], 1, load_optimizer_states=True)
        else:
            tr.restore_state(runs["ck"] + "-state")
        assert tr._step == BF16_STEPS
        for k, v in tr.params.items():
            assert type(v) is torch.Tensor
            np.testing.assert_array_equal(v.numpy(), port["params"][k])
            for got, want in zip(tr.opt_state[k], port["opt_state"][k]):
                np.testing.assert_array_equal(got.numpy(), want)
            assert torch.equal(tr._cparams[k], v.to(torch.bfloat16))
