"""The image-classification zoo in the port against the JAX package's, on
the CPU: each builder's eval forward at its native size and batch 1
through the ``Predictor`` of each package (graph passes on, fp32, the
same seeded numpy weights), and one ``FusedTrainer`` SGD step of
GoogLeNet (no BatchNorm) from the same weights.  The builders' JSON is
held in ``tests/test_torch_train_resnet.py::test_get_symbol_matches_jax``.

Each net is compared on a second head, its last FullyConnected's
output: with 1000 classes and seeded weights the softmax is near
uniform and says little.  The JAX side runs its convolutions in true
fp32 (``MXTPU_CONV_PRECISION=float32``).  Tolerance: 1e-4 of the
logits' norm — the same fp32 arithmetic summed in another order through
up to ~250 layers.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import executor as jexec
from mxnet_tpu import models as jmodels
from mxnet_tpu import symbol as jsym
from mxnet_tpu.predict import Predictor as JPredictor
from mxnet_tpu.trainer import FusedTrainer as JTrainer

from mxnet_tpu_torch import convert
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.predict import Predictor as TPredictor
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

ZOO = {"alexnet": 224, "vgg": 224, "googlenet": 224, "inception-bn": 224,
       "inception-v3": 299, "inception-resnet-v2": 299, "resnext": 224}


@pytest.fixture(autouse=True)
def _fp32_convs(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _with_logits(jnet):
    """``jnet`` grouped with the input of its SoftmaxOutput."""
    return jsym.Group([jnet, jnet.get_children()[0]])


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_eval_forward_matches_jax(name):
    side = ZOO[name]
    shape = (1, 3, side, side)
    jnet = _with_logits(jmodels.get_symbol(name))
    tnet = tsym.load_json(jnet.tojson())
    arg, aux = tresnet.random_params(tnet, seed=0, data=shape)
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)

    jexec.program_cache_clear()
    jp = JPredictor(symbol=jnet,
                    arg_params={k: jmx.nd.array(v) for k, v in arg.items()},
                    aux_params={k: jmx.nd.array(v) for k, v in aux.items()},
                    input_shapes={"data": shape})
    jp.forward(data=x)
    tp = TPredictor(symbol=tnet, arg_params=arg, aux_params=aux,
                    input_shapes={"data": shape}, dev_type="cpu")
    tp.forward(data=x)
    for i in range(2):
        want, got = jp.get_output(i), tp.get_output(i)
        assert got.shape == want.shape == ((1, 1000))
        assert np.isfinite(got).all()
        assert _rel(got, want) <= 1e-4, (i, _rel(got, want))
    assert np.std(jp.get_output(1)) > 1e-3  # the logits are not flat


def test_googlenet_fused_trainer_step_matches_jax():
    """One SGD step (momentum 0.9, lr 0.1) of GoogLeNet at batch 4 x 3 x
    64 x 64 (the smallest side its five stride-2 stages keep positive),
    10 classes, from the JAX initializer's weights.  No BatchNorm, so the
    step is well-conditioned: the probabilities agree to 1e-5 and each
    parameter's change to 1e-4 of its norm."""
    b, shape = 4, (3, 64, 64)
    jmx.random.seed(0)
    np.random.seed(0)
    opt = {"lr": 0.1, "momentum": 0.9, "rescale_grad": 1.0 / b}
    init = jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                           magnitude=2)
    jt = JTrainer(jmodels.get_symbol("googlenet", num_classes=10),
                  optimizer="sgd", optimizer_params=dict(opt),
                  initializer=init, dtype="float32")
    jt.init(data=(b,) + shape)
    tt = TTrainer(tmodels.get_symbol("googlenet", num_classes=10),
                  optimizer="sgd", optimizer_params=dict(opt),
                  dtype="float32", device="cpu").init(data=(b,) + shape)
    arg, aux = jt.get_params()
    start = {k: v.asnumpy() for k, v in arg.items()}
    convert.load_trainer_params(tt, start, {k: v.asnumpy()
                                            for k, v in aux.items()})
    rs = np.random.RandomState(3)
    d = rs.normal(0, 1, (b,) + shape).astype(np.float32)
    lab = rs.randint(0, 10, b).astype(np.float32)
    for _ in range(2):
        jo = np.asarray(jt.step(data=d, softmax_label=lab)[0])
        to = tt.step(data=d, softmax_label=lab)[0].numpy()
        assert _rel(to, jo) <= 1e-5
    jarg = {k: v.asnumpy() for k, v in jt.get_params()[0].items()}
    targ, _ = tt.get_params()
    for k, w in targ.items():
        moved = jarg[k] - start[k]
        assert np.linalg.norm(moved) > 0, k
        assert _rel(w.numpy() - start[k], moved) <= 1e-4, k
