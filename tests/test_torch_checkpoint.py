"""Checkpoints across the two packages, on the CPU: a small ResNet saved
by the JAX package's ``model.save_checkpoint`` is loaded by the port's
``predict.create`` and held against the JAX ``predict.create``; the
port's checkpoints load in the JAX package; ``param_bytes=`` and the
reference's binary ``.params`` build the same Predictor as the file.

ResNet-18 at 2 x 3 x 32 x 32, 10 classes, seeded weights made with
numpy (the port's ``random_params``) and a second head on the logits
(``fc1``, whose FullyConnected weight is scaled down so the softmax is
informative).  The JAX side runs its convolutions in true fp32
(``MXTPU_CONV_PRECISION=float32``).  Tolerances: JAX vs port, 1e-5
relative (norm) on the logits and 1e-5 on the probabilities — 21
convolutions summed in other orders by XLA and torch, measured near
1e-6; port vs port from the same values, exact (0).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import interop as jinterop
from mxnet_tpu import model as jmodel
from mxnet_tpu import predict as jpredict
from mxnet_tpu import symbol as jsym
from mxnet_tpu.models import resnet as jresnet

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import predict as tpredict
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.models import resnet as tresnet

SHAPE = (2, 3, 32, 32)


@pytest.fixture(scope="module")
def net():
    jnet = jresnet.get_symbol(10, 18, SHAPE[1:])
    jnet = jsym.Group([jnet, jnet.get_internals()["fc1_output"]])
    arg, aux = tresnet.random_params(tsym.load_json(jnet.tojson()), seed=3,
                                     data=SHAPE)
    arg["fc1_weight"] = arg["fc1_weight"] * np.float32(0.02)
    x = np.random.default_rng(5).normal(size=SHAPE).astype(np.float32)
    return jnet, arg, aux, x


def _outs(p, x):
    p.forward(data=x)
    return [np.asarray(p.get_output(i)) for i in range(2)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_in_memory(jnet, arg, aux):
    return tpredict.Predictor(symbol=tsym.load_json(jnet.tojson()),
                              arg_params=arg, aux_params=aux,
                              input_shapes={"data": SHAPE}, dev_type="cpu")


def test_jax_checkpoint_into_port_create(net, tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    jnet, arg, aux, x = net
    prefix = str(tmp_path / "resnet")
    jmodel.save_checkpoint(prefix, 3, jnet,
                           {k: mx.nd.array(v) for k, v in arg.items()},
                           {k: mx.nd.array(v) for k, v in aux.items()})
    got = _outs(tpredict.create(prefix, 3, {"data": SHAPE}, dev_type="cpu"),
                x)
    want = _outs(jpredict.create(prefix, 3, {"data": SHAPE}), x)
    assert _rel(got[1], want[1]) < 1e-5
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    # the same file through the checkpoint's bytes, and the in-memory
    # Predictor from the same values: identical
    with open(f"{prefix}-symbol.json") as f:
        js = f.read()
    with open(f"{prefix}-0003.params", "rb") as f:
        blob = f.read()
    by_bytes = tpredict.Predictor(symbol_json_str=js, param_bytes=blob,
                                  input_shapes={"data": SHAPE},
                                  dev_type="cpu")
    for a, b in zip(_outs(by_bytes, x), got):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_outs(_port_in_memory(jnet, arg, aux), x), got):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_loads_in_jax(net, tmp_path):
    jnet, arg, aux, _ = net
    prefix = str(tmp_path / "port")
    tnet = tsym.load_json(jnet.tojson())
    tmodel.save_checkpoint(prefix, 0, tnet, arg, aux)
    jgot, jarg, jaux = jmodel.load_checkpoint(prefix, 0)
    assert jgot.list_arguments() == jnet.list_arguments()
    assert jgot.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert sorted(jarg) == sorted(arg) and sorted(jaux) == sorted(aux)
    for k in arg:
        np.testing.assert_array_equal(jarg[k].asnumpy(), arg[k])
    tgot, targ, taux = tmodel.load_checkpoint(prefix, 0, ctx="cpu")
    assert tgot.tojson() == tnet.tojson()
    for k in aux:
        assert isinstance(taux[k], tnd.NDArray)
        np.testing.assert_array_equal(taux[k].asnumpy(), aux[k])


def test_port_checkpoint_create_is_identical(net, tmp_path):
    jnet, arg, aux, x = net
    prefix = str(tmp_path / "same")
    nd_arg = {k: tnd.array(v, ctx="cpu") for k, v in arg.items()}
    tmodel.save_checkpoint(prefix, 7, tsym.load_json(jnet.tojson()), nd_arg,
                           aux)
    want = _outs(_port_in_memory(jnet, arg, aux), x)
    for dtype in (None, "bfloat16"):
        p = tpredict.create(prefix, 7, {"data": SHAPE}, dev_type="cpu",
                            dtype=dtype)
        ref = want if dtype is None else _outs(tpredict.Predictor(
            symbol=tsym.load_json(jnet.tojson()), arg_params=arg,
            aux_params=aux, input_shapes={"data": SHAPE}, dev_type="cpu",
            dtype=dtype), x)
        for a, b in zip(_outs(p, x), ref):
            np.testing.assert_array_equal(a, b)


def test_reference_binary_checkpoint(net, tmp_path):
    """A checkpoint whose params are the reference's 0x112 binary (as the
    reference's own save_checkpoint writes it) loads through create."""
    jnet, arg, aux, x = net
    prefix = str(tmp_path / "ref")
    jnet.save(f"{prefix}-symbol.json")
    jinterop.save_params(f"{prefix}-0001.params", arg, aux)
    got = _outs(tpredict.create(prefix, 1, {"data": SHAPE}, dev_type="cpu"),
                x)
    for a, b in zip(got, _outs(_port_in_memory(jnet, arg, aux), x)):
        np.testing.assert_array_equal(a, b)


def test_create_defaults_to_the_card(net, tmp_path, monkeypatch):
    jnet, arg, aux, _ = net
    prefix = str(tmp_path / "card")
    tmodel.save_checkpoint(prefix, 0, tsym.load_json(jnet.tojson()), arg,
                           aux)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tpredict.create(prefix, 0, {"data": SHAPE})
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmodel.load_checkpoint(prefix, 0)


def test_symbol_save_load_and_refusals(net, tmp_path):
    jnet = net[0]
    tnet = tsym.load_json(jnet.tojson())
    fname = str(tmp_path / "s.json")
    tnet.save(fname)
    assert tsym.load(fname).tojson() == tnet.tojson()
    assert jsym.load(fname).list_outputs() == jnet.list_outputs()
    # URIs are ported: a mem:// object round-trips, a missing one raises
    tnet.save("mem://ckpt/s.json")
    assert tsym.load("mem://ckpt/s.json").tojson() == tnet.tojson()
    with pytest.raises(FileNotFoundError):
        tsym.load("mem://ckpt/missing.json")
    with pytest.raises(MXNetError, match="arg:/aux:"):
        tmodel.split_params({"fc1_weight": np.zeros(2)})
    assert os.path.exists(fname)
