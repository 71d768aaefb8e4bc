"""The detection zoo and CTC training in the port against the JAX
package, on the CPU: ``models/ssd.py`` (``ssd-vgg16``), the loop of
``examples/ssd/train.py``, the deploy graph's detections, one
``train_rois=True`` step of ``examples/rcnn``'s graph and two steps of
``examples/warpctc/lstm_ocr.py``.

The port's copies of the example builders (``rcnn_symbol``,
``ocr_net``, ``synthetic_detections``) are ``chip_smoke.py``'s, the ones
the card runs; their graphs must equal the examples' JSON.  Weights are
the JAX side's initializer output carried across as numpy
(``convert.from_jax_params``).  JAX's convolutions run in true fp32
(``MXTPU_CONV_PRECISION=float32``).

Tolerances: fp32 ``1e-5`` relative and absolute on outputs and
gradients after one step; ``1e-4`` relative on the second SSD step and
the second OCR step, which add a step of the other side's rounding
(SGD and Adam on gradients that agree to ~1e-6).  Detections are held
by ``chip_smoke._detections_agree``: class ids and kept rows equal and
scores/boxes within the tolerance wherever a score is not within it of
a neighbour's (there the order of equal scores decides); sorted scores
within it throughout.
"""
import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import base as jbase
from mxnet_tpu import models as jmodels
from mxnet_tpu.models import ssd as jssd

import chip_smoke as cs
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import convert, initializer
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.models import ssd as tssd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
STEP2_RTOL = 1e-4
SCALE = cs.SSD_SCALE


@pytest.fixture(autouse=True)
def _fresh_names_fp32_convs(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    monkeypatch.setattr(tbase, "_NAME_MANAGER", tbase.NameManager())
    with jbase.NameManager():
        yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else \
        x.detach().cpu().numpy()


def _example(rel, name):
    """An example module of the JAX package, loaded from its file (a
    package when ``rel`` is a directory)."""
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(REPO, "examples", rel)
    if os.path.isdir(path):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
    else:
        spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _jax_init(net, shapes, skip, seed=0):
    """The JAX executor bound on ``shapes`` with the example's Xavier
    (numpy's global stream, seeded) on every argument but ``skip``."""
    np.random.seed(seed)
    ex = net.simple_bind(ctx=None, **shapes)
    init = jmx.init.Xavier()
    for name, arr in ex.arg_dict.items():
        if not skip(name):
            init(name, arr)
    return ex


def _port_bind(net, shapes, jex, skip):
    """The port's executor on the CPU with the JAX executor's weights."""
    ex = net.simple_bind("cpu", **shapes)
    ex.copy_params_from(convert.from_jax_params(
        {k: v for k, v in jex.arg_dict.items() if not skip(k)},
        device="cpu"))
    return ex


# ------------------------------------------------------------- graphs
@pytest.mark.parametrize("which", ["dispatcher", "deploy", "tiny_train",
                                   "tiny_deploy"])
def test_ssd_graph_json_matches_jax(which):
    build = {
        "dispatcher": lambda m: (jmodels if m is jssd else tmodels
                                 ).get_symbol("ssd-vgg16"),
        "deploy": lambda m: m.get_symbol(num_classes=20),
        "tiny_train": lambda m: m.get_symbol_train(num_classes=3,
                                                   backbone="tiny"),
        "tiny_deploy": lambda m: m.get_symbol(num_classes=3,
                                              backbone="tiny"),
    }[which]
    want = build(jssd).tojson()
    tbase._NAME_MANAGER = tbase.NameManager()
    assert build(tssd).tojson() == want


def test_ssd_vgg16_infers_8732_anchors():
    # the graph is the JAX package's (its JSON above); its shapes here
    shapes = {"data": (2, 3, 300, 300), "label": (2, 8, 5)}
    _, touts, _ = tmodels.get_symbol(
        "ssd-vgg16", num_classes=20).infer_shape(**shapes)
    assert touts == [(2, 21, 8732), (2, 8732 * 4), (2, 8732),
                     (2, 8732, 6)]


def test_ssd_params_carry_across_with_conv4_3_scale():
    """The full VGG16-SSD parameter dict (numpy by name, as the JAX
    package hands it over) reaches a port executor whole, conv4_3's
    L2-norm scale (``relu_conv4_3_scale``) included; the scale's own init
    attr gives 20 in both packages."""
    net = tssd.get_symbol_train(num_classes=20)
    shapes = {"data": (1, 3, 300, 300), "label": (1, 8, 5)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(0)
    params = {n: rs.normal(size=s).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in shapes}
    assert params[SCALE].shape == (1, 512, 1, 1)
    ex = net.simple_bind("cpu", grad_req="null", **shapes)
    ex.copy_params_from(convert.from_jax_params(params, device="cpu"))
    for n, v in params.items():
        np.testing.assert_array_equal(_np(ex.arg_dict[n]), v)
    inits = initializer.variable_initializers(net)
    assert sorted(inits) == [SCALE]
    t = torch.zeros(1, 512, 1, 1)
    inits[SCALE](SCALE, t)
    jnet = jssd.get_symbol_train(num_classes=20)
    attr = jnet.attr_dict()[SCALE]["__init__"]
    j = jmx.nd.zeros((1, 512, 1, 1))
    jmx.initializer.create(attr)(SCALE, j)
    np.testing.assert_array_equal(t.numpy(), j.asnumpy())
    assert float(t.mean()) == 20.0


# ------------------------------------------------------ SSD training
TINY = {"num_classes": 3, "backbone": "tiny"}
TINY_SHAPES = {"data": (4, 3, 64, 64), "label": (4, 8, 5)}
SKIP_SSD = ("data", "label").__contains__


def _ssd_loop(ex, names, updater, imgs, labels, steps, b, nd_set):
    """examples/ssd/train.py's loop: set the batch, forward, backward,
    the updater over every argument with a gradient; the outputs of each
    step (numpy)."""
    outs = []
    for step in range(steps):
        sel = slice((step * b) % len(imgs), (step * b) % len(imgs) + b)
        nd_set(ex.arg_dict["data"], imgs[sel])
        nd_set(ex.arg_dict["label"], labels[sel])
        ex.forward(is_train=True)
        ex.backward()
        for i, name in enumerate(names):
            if SKIP_SSD(name) or ex.grad_dict.get(name) is None:
                continue
            updater(i, ex.grad_dict[name], ex.arg_dict[name])
        outs.append([_np(o) for o in ex.outputs])
    return outs


def _jset(arr, value):
    arr[:] = value


def _tset(arr, value):
    arr.copy_(torch.from_numpy(value))


def test_tiny_ssd_training_steps_match_jax():
    b = 4
    imgs, labels = cs.synthetic_detections(8, 64, 8, 3)
    jnet = jssd.get_symbol_train(**TINY)
    tnet = tssd.get_symbol_train(**TINY)
    jex = _jax_init(jnet, TINY_SHAPES, SKIP_SSD)
    tex = _port_bind(tnet, TINY_SHAPES, jex, SKIP_SSD)
    opt = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4}
    jouts = _ssd_loop(jex, jnet.list_arguments(),
                      jmx.optimizer.get_updater(
                          jmx.optimizer.create("sgd", **opt)),
                      imgs, labels, 2, b, _jset)
    touts = _ssd_loop(tex, tnet.list_arguments(),
                      topt.get_updater(topt.create("sgd", **opt)),
                      imgs, labels, 2, b, _tset)
    for step, (jo, to) in enumerate(zip(jouts, touts)):
        rtol = TOL if step == 0 else STEP2_RTOL
        # cls_prob, loc_loss, cls_label (targets: equal), det_out
        np.testing.assert_allclose(to[0], jo[0], rtol=rtol, atol=TOL)
        np.testing.assert_allclose(to[1], jo[1], rtol=rtol, atol=TOL)
        np.testing.assert_array_equal(to[2], jo[2])
        cs._detections_agree(to[3], jo[3], TOL)
    assert (touts[0][2] > 0).any() and (touts[0][2] == -1).any()
    for name in tnet.list_arguments():
        if not SKIP_SSD(name):
            np.testing.assert_allclose(_np(tex.arg_dict[name]),
                                       _np(jex.arg_dict[name]),
                                       rtol=STEP2_RTOL, atol=TOL,
                                       err_msg=name)


def test_tiny_ssd_deploy_detections_match_jax():
    from mxnet_tpu.predict import Predictor as JPredictor

    from mxnet_tpu_torch.predict import Predictor as TPredictor

    jtrain = _jax_init(jssd.get_symbol_train(**TINY), TINY_SHAPES,
                       SKIP_SSD, seed=1)
    jparams = {k: v for k, v in jtrain.arg_dict.items() if not SKIP_SSD(k)}
    params = {k: _np(v) for k, v in jparams.items()}
    imgs, _ = cs.synthetic_detections(4, 64, 8, 3, seed=6)
    shape = {"data": imgs.shape}
    jp = JPredictor(symbol=jssd.get_symbol(**TINY), arg_params=jparams,
                    aux_params={}, input_shapes=shape)
    jp.forward(data=imgs)
    tp = TPredictor(symbol=tssd.get_symbol(**TINY), arg_params=params,
                    aux_params={}, input_shapes=shape, dev_type="cpu")
    tp.forward(data=imgs)
    want, got = jp.get_output(0), tp.get_output(0)
    assert got.shape == want.shape == (4, 1344, 6)
    rows, ties, _ = cs._detections_agree(got, want, TOL)
    assert rows > ties and (got[..., 0] >= 0).any()


# --------------------------------------------------- rcnn and lstm_ocr
def _rcnn():
    """examples/rcnn/rcnn's ``config`` and ``symbols``; the port's copy
    of the config holds the example's values."""
    _example(os.path.join("rcnn", "rcnn"), "_rcnn_example")
    jcfg = importlib.import_module("_rcnn_example.config")
    for k, v in cs.RCNN_CFG.items():
        assert jcfg.default[k] == v, k
    return jcfg.default, importlib.import_module("_rcnn_example.symbols")


def test_rcnn_train_rois_step_matches_jax():
    jcfg, jsyms = _rcnn()
    b = 2
    jnet = jsyms.get_symbol(jcfg, b, train_rois=True)
    tnet = cs.rcnn_symbol(cs.RCNN_CFG, b, train_rois=True)
    assert tnet.tojson() == jnet.tojson()
    shapes = cs.rcnn_shapes(cs.RCNN_CFG, b, True)
    values = cs._rcnn_inputs(cs.RCNN_CFG, b, seed=3)
    # RoIs as the eval graph's Proposal emits them: image index, corners
    rs = np.random.RandomState(4)
    xy = rs.uniform(0, 40, (b * 16, 2))
    wh = rs.uniform(4, 24, (b * 16, 2))
    values["rois"] = np.concatenate(
        [np.repeat(np.arange(b), 16)[:, None], xy, xy + wh],
        axis=1).astype(np.float32)
    values["rois"][3, 1:] = [10.5, 6.5, 30.5, 14.5]  # .5 at stride 4 -> 2.625
    is_param = lambda n: n.endswith(("weight", "bias"))  # noqa: E731
    jex = _jax_init(jnet, shapes, lambda n: not is_param(n))
    tex = _port_bind(tnet, shapes, jex, lambda n: not is_param(n))
    for k in shapes:
        jex.arg_dict[k][:] = values[k]
        tex.arg_dict[k].copy_(torch.from_numpy(values[k]))
    jex.forward(is_train=True)
    jex.backward()
    tex.forward(is_train=True)
    tex.backward()
    for j, t in zip(jex.outputs, tex.outputs):
        np.testing.assert_allclose(_np(t), _np(j), rtol=TOL, atol=TOL)
    for name in tnet.list_arguments():
        if is_param(name):
            np.testing.assert_allclose(_np(tex.grad_dict[name]),
                                       _np(jex.grad_dict[name]), rtol=TOL,
                                       atol=TOL, err_msg=name)
    assert np.abs(_np(tex.grad_dict["conv3_weight"])).sum() > 0


def test_rcnn_eval_graph_proposals_match_jax():
    jcfg, jsyms = _rcnn()
    b = 2
    jnet = jsyms.get_symbol(jcfg, b, train_rois=False)
    tnet = cs.rcnn_symbol(cs.RCNN_CFG, b, train_rois=False)
    assert tnet.tojson() == jnet.tojson()
    shapes = cs.rcnn_shapes(cs.RCNN_CFG, b, False)
    values = cs._rcnn_inputs(cs.RCNN_CFG, b, seed=5)
    is_param = lambda n: n.endswith(("weight", "bias"))  # noqa: E731
    jex = _jax_init(jnet, shapes, lambda n: not is_param(n), seed=2)
    tex = _port_bind(tnet, shapes, jex, lambda n: not is_param(n))
    for k in shapes:
        jex.arg_dict[k][:] = values[k]
        tex.arg_dict[k].copy_(torch.from_numpy(values[k]))
    jouts = [_np(o) for o in jex.forward(is_train=False)]
    touts = [_np(o) for o in tex.forward(is_train=False)]
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=1e-4)
    assert touts[4].shape == (b * 16, 5)


def test_lstm_ocr_steps_match_jax(monkeypatch):
    """lstm_ocr.py's net and loop with the canvas (and so the unroll)
    cut from 48 columns to 16 in both packages, batch 4."""
    ocr = _example(os.path.join("warpctc", "lstm_ocr.py"), "_lstm_ocr")
    monkeypatch.setattr(ocr, "W", 16)
    monkeypatch.setattr(cs, "OCR_W", 16)
    b, hidden = 4, cs.OCR_HIDDEN
    jnet = ocr.build_net(b, hidden, cs.OCR_CLASSES)
    tnet = cs.ocr_net(hidden, cs.OCR_CLASSES)
    assert tnet.tojson() == jnet.tojson()
    shapes = {"data": (b, ocr.H, ocr.W), "label": (b, ocr.MAX_DIGITS),
              "l0_begin_state_0": (b, hidden),
              "l0_begin_state_1": (b, hidden)}
    skip = lambda n: n in ("data", "label") or "state" in n  # noqa: E731
    jex = _jax_init(jnet, shapes, skip)
    tex = _port_bind(tnet, shapes, jex, skip)
    # the example's generator and the port's copy draw the same batches
    rs_j, rs_t = np.random.RandomState(0), np.random.RandomState(0)
    names = sorted(n for n in tnet.list_arguments() if not skip(n))
    jup = jmx.optimizer.get_updater(jmx.optimizer.create(
        "adam", learning_rate=cs.OCR_LR))
    tup = topt.get_updater(topt.create("adam", learning_rate=cs.OCR_LR))
    timgs, tlabels = cs.ocr_batches(rs_t, 2, b)
    for step in range(2):
        jb = [ocr.gen_captcha(rs_j) for _ in range(b)]
        imgs = np.stack([g[0] for g in jb])
        labels = np.stack([g[1] for g in jb])
        np.testing.assert_array_equal(timgs[step], imgs)
        np.testing.assert_array_equal(tlabels[step], labels)
        jex.arg_dict["data"][:] = imgs
        jex.arg_dict["label"][:] = labels
        tex.arg_dict["data"].copy_(torch.from_numpy(imgs))
        tex.arg_dict["label"].copy_(torch.from_numpy(labels))
        for ex in (jex, tex):
            ex.forward(is_train=True)
            ex.backward()
        rtol = TOL if step == 0 else STEP2_RTOL
        np.testing.assert_allclose(_np(tex.outputs[0]), _np(jex.outputs[0]),
                                   rtol=rtol, atol=TOL)
        for name in names:
            np.testing.assert_allclose(_np(tex.grad_dict[name]),
                                       _np(jex.grad_dict[name]), rtol=rtol,
                                       atol=TOL, err_msg=name)
        for i, name in enumerate(names):
            jup(i, jex.grad_dict[name], jex.arg_dict[name])
            tup(i, tex.grad_dict[name], tex.arg_dict[name])
    acc = cs.seq_accuracy(_np(tex.outputs[0]), tlabels[1])
    assert acc == ocr.seq_accuracy(_np(jex.outputs[0]), labels)
