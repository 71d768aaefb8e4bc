"""The port's plugins against the JAX package's, on the CPU.

``TorchModule`` and ``TorchCriterion`` run copies of one torch module in
both packages (the JAX package's on the host behind
``jax.pure_callback``, the port's in place under autograd): Linear, and
Conv+BatchNorm in train and eval mode, with the forward, the input and
parameter gradients and the buffers; the buffers advance once per
training forward and never at inference; Dropout by statistics (the
masks of forward and backward agree; the port draws from the op's
generator and leaves torch's global one alone); ``grad_scale``; the MLP
of ``examples/torch/torch_module.py`` through ``Module.fit`` for 3
batches from the same weights; 0 host syncs a batch with the port's
sync counter.  The opencv plugin's functions against the reference's,
through cv2 and with ``_cv2`` set to ``None`` in both packages.

Tolerances: 1e-6 relative on the forwards and 1e-5 on the gradients and
the fitted parameters (the same torch code on the same host on both
sides; the JAX side runs the graph around it in XLA); the image
functions exactly.
"""
import copy
import io
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.plugins import opencv_plugin as jcv
from mxnet_tpu.plugins import torch_plugin as jtp

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.plugins import opencv_plugin as tcv
from mxnet_tpu_torch.plugins import torch_plugin as ttp

CPU = "cpu"
_SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
          "__int__")


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-12)
    assert float(np.abs(a - b).max()) <= tol * scale


def _loss_net(s, mid, names):
    out = s.TorchModule(s.Variable("x"), *[s.Variable(n) for n in names],
                        module_id=mid)
    return s.MakeLoss(s.sum(out * out))


def _run(mx, module, x, is_train, backward=True):
    """Both packages' executor over ``sum(TorchModule(x, *params)²)``:
    (output, {name: gradient})."""
    tp = jtp if mx is jmx else ttp
    names = [n.replace(".", "_") for n, _ in module.named_parameters()]
    mid = tp.register_module(module)
    net = _loss_net(mx.sym, mid, names)
    shapes = {"x": x.shape}
    shapes.update({n: tuple(p.shape)
                   for n, (_, p) in zip(names, module.named_parameters())})
    vals = {"x": x}
    vals.update({n: p.detach().numpy().copy()
                 for n, (_, p) in zip(names, module.named_parameters())})
    ex = net.simple_bind(ctx=mx.cpu(), grad_req="write" if backward
                         else "null", **shapes)
    for k, v in vals.items():
        if mx is jmx:
            ex.arg_dict[k][:] = v
        else:
            ex.arg_dict[k].copy_(torch.from_numpy(v))
    ex.forward(is_train=is_train)
    out = ex.outputs[0]
    out = out.asnumpy() if hasattr(out, "asnumpy") else out.detach().numpy()
    grads = {}
    if backward:
        ex.backward()
        for k in vals:
            g = ex.grad_dict[k]
            grads[k] = g.asnumpy() if hasattr(g, "asnumpy") else g.numpy()
    return out, grads


def _conv_bn():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                            torch.nn.BatchNorm2d(4), torch.nn.ReLU())
    with torch.no_grad():
        m[1].weight.uniform_(0.5, 1.5)
        m[1].bias.uniform_(-0.2, 0.2)
    return m


@pytest.mark.parametrize("kind,is_train", [("linear", True),
                                           ("conv_bn", True),
                                           ("conv_bn", False)])
def test_torch_module_matches_the_reference(kind, is_train):
    torch.manual_seed(1)
    module = torch.nn.Linear(6, 3) if kind == "linear" else _conv_bn()
    shape = (5, 6) if kind == "linear" else (4, 3, 6, 6)
    x = np.random.RandomState(2).normal(size=shape).astype(np.float32)
    jmod, tmod = copy.deepcopy(module), copy.deepcopy(module)
    # an inference forward has no backward in either package
    jout, jg = _run(jmx, jmod, x, is_train, backward=is_train)
    tout, tg = _run(tmx, tmod, x, is_train, backward=is_train)
    _close(tout, jout, 1e-6)
    assert sorted(tg) == sorted(jg)
    # held to the largest gradient entry of the problem: the conv bias
    # before a training-mode BatchNorm has a zero gradient but rounding
    top = max([float(np.abs(g).max()) for g in jg.values()] + [0.0])
    for k in jg:
        assert float(np.abs(tg[k] - jg[k]).max()) <= 1e-5 * top, k
    # plain torch on a third copy: the same loss, its gradient by autograd
    ref = copy.deepcopy(module).train(is_train)
    xt = torch.tensor(x, requires_grad=True)
    loss = (ref(xt) ** 2).sum()
    _close(tout, loss.detach().numpy(), 1e-6)
    if is_train:
        loss.backward()
        want = {"x": xt.grad.numpy()}
        want.update({k: p.grad.numpy() for k, (_, p) in zip(
            [k for k in tg if k != "x"], ref.named_parameters())})
        for k, w in want.items():
            assert float(np.abs(tg[k] - w).max()) <= 1e-5 * top, k
    # the buffers: advanced once by a training forward, never at eval —
    # as the plain module's one forward left them
    for a, b in zip(tmod.buffers(), ref.buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    if not is_train:
        for a, b in zip(tmod.buffers(), module.buffers()):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_buffers_advance_once_per_training_forward():
    """Three training forwards (each with a backward) advance the
    BatchNorm statistics three times; inference forwards leave them."""
    module = _conv_bn()
    tmod, ref = copy.deepcopy(module), copy.deepcopy(module).train()
    mid = ttp.register_module(tmod)
    names = ["w", "b", "g", "beta"]
    net = _loss_net(tmx.sym, mid, names)
    params = [p.detach().numpy().copy() for p in module.parameters()]
    ex = net.simple_bind(ctx=tmx.cpu(), x=(4, 3, 6, 6),
                         **{n: p.shape for n, p in zip(names, params)})
    for n, p in zip(names, params):
        ex.arg_dict[n].copy_(torch.from_numpy(p))
    rs = np.random.RandomState(3)
    for _ in range(3):
        x = rs.normal(size=(4, 3, 6, 6)).astype(np.float32)
        ex.forward(is_train=True, x=x)
        ex.backward()
        with torch.no_grad():
            ref(torch.from_numpy(x))
    assert int(tmod[1].num_batches_tracked) == 3
    for a, b in zip(tmod.buffers(), ref.buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    before = [b.clone() for b in tmod.buffers()]
    for _ in range(2):
        ex.forward(is_train=False, x=x)
    for a, b in zip(tmod.buffers(), before):
        assert torch.equal(a, b)
    # shape inference runs on meta tensors: the module's own stay put
    net.infer_shape(x=(8, 3, 6, 6), **{n: p.shape
                                       for n, p in zip(names, params)})
    for a, b in zip(tmod.buffers(), before):
        assert torch.equal(a, b)
    # the registered module holds the values the op ran with
    ex.arg_dict["w"].mul_(2.0)
    ex.forward(is_train=False, x=x)
    np.testing.assert_array_equal(tmod[0].weight.detach().numpy(),
                                  2.0 * params[0])


def _dropout_dx(mx, seed):
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Dropout(0.5),
                                 torch.nn.Linear(4, 4))
    x = np.random.RandomState(2).normal(size=(256, 4)).astype(np.float32)
    mx.random.seed(seed)
    _, g = _run(mx, copy.deepcopy(module), x, True)
    return g["x"]


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "port"])
def test_dropout_masks_agree_by_statistics(mx):
    """A dropped input gets no gradient in every column, so the share of
    exact zeros in dx is the drop rate when the backward reuses the
    forward's mask (about 0.25 with independent masks)."""
    zero = float((_dropout_dx(mx, 7) == 0).mean())
    assert 0.44 < zero < 0.56, zero


def test_dropout_draws_from_the_ops_generator():
    """The port's masks come from its seeded generator, reproducibly,
    and torch's global generator is left as it was."""
    state = torch.random.get_rng_state()
    a, b, c = _dropout_dx(tmx, 7), _dropout_dx(tmx, 7), _dropout_dx(tmx, 8)
    torch.manual_seed(0)            # _dropout_dx seeds the module's init
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    torch.random.set_rng_state(state)
    # the fused CUDA dropout (native_dropout) is drawn the port's way
    gen = torch.Generator().manual_seed(3)
    x = torch.ones(4000, requires_grad=True)
    before = torch.random.get_rng_state()
    with ttp._OpGenerator(gen):
        y, mask = torch.ops.aten.native_dropout(x, 0.3, True)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert 0.27 < 1 - float(mask.float().mean()) < 0.33
    torch.testing.assert_close(y, mask.float() / 0.7)
    y.sum().backward()
    torch.testing.assert_close(x.grad, mask.float() / 0.7)


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_torch_criterion_matches_the_reference(scale):
    """MSELoss: the loss, and ``grad_scale · ∂loss/∂data`` whatever the
    head gradient (a MakeLoss-free output op)."""
    rs = np.random.RandomState(1)
    pred = rs.normal(size=(6, 3)).astype(np.float32)
    target = rs.normal(size=(6, 3)).astype(np.float32)
    outs = {}
    for mx, tp in ((jmx, jtp), (tmx, ttp)):
        cid = tp.register_criterion(torch.nn.MSELoss())
        net = mx.sym.TorchCriterion(mx.sym.Variable("p"),
                                    mx.sym.Variable("t"), criterion_id=cid,
                                    grad_scale=scale)
        ex = net.simple_bind(ctx=mx.cpu(), p=(6, 3), t=(6, 3))
        for k, v in (("p", pred), ("t", target)):
            if mx is jmx:
                ex.arg_dict[k][:] = v
            else:
                ex.arg_dict[k].copy_(torch.from_numpy(v))
        ex.forward(is_train=True)
        ex.backward()
        out, g = ex.outputs[0], ex.grad_dict["p"]
        outs[mx] = (np.asarray(out.asnumpy() if hasattr(out, "asnumpy")
                               else out.detach().numpy()),
                    g.asnumpy() if hasattr(g, "asnumpy") else g.numpy())
    assert outs[tmx][0].shape == outs[jmx][0].shape == ()
    _close(outs[tmx][0], outs[jmx][0], 1e-6)
    _close(outs[tmx][1], outs[jmx][1], 1e-6)
    _close(outs[tmx][1], scale * 2 * (pred - target) / pred.size, 1e-6)


def test_torch_criterion_cross_entropy_on_class_indices():
    """A criterion with ``ignore_index`` takes class-index labels as
    int64 (the reference hands every label over as float32, which
    CrossEntropyLoss refuses); with ``grad_scale`` = the batch its
    gradient is SoftmaxOutput's; the loss stays a tensor (no host read)."""
    rs = np.random.RandomState(4)
    logits = rs.normal(size=(8, 5)).astype(np.float32)
    labels = rs.randint(0, 5, 8).astype(np.float32)
    cid = ttp.register_criterion(torch.nn.CrossEntropyLoss())
    with tmx.Context(CPU):
        loss = tnd.TorchCriterion(tnd.array(logits), tnd.array(labels),
                                  criterion_id=cid)
    want = torch.nn.functional.cross_entropy(torch.from_numpy(logits),
                                             torch.from_numpy(labels).long())
    assert isinstance(loss.tensor, torch.Tensor) and loss.shape == ()
    _close(loss.asnumpy(), want.numpy(), 1e-6)
    grads = {}
    for name, head in (("ce", tmx.sym.TorchCriterion(
            tmx.sym.Variable("x"), tmx.sym.Variable("softmax_label"),
            criterion_id=cid, grad_scale=8)),
            ("softmax", tmx.sym.SoftmaxOutput(tmx.sym.Variable("x"),
                                              name="softmax"))):
        ex = head.simple_bind(ctx=tmx.cpu(), x=(8, 5), softmax_label=(8,))
        ex.forward(is_train=True, x=logits, softmax_label=labels)
        ex.backward()
        grads[name] = ex.grad_dict["x"].numpy()
    _close(grads["ce"], grads["softmax"], 1e-6)
    with pytest.raises(MXNetError, match="scalar loss"):
        bad = ttp.register_criterion(torch.nn.MSELoss(reduction="none"))
        with tmx.Context(CPU):
            tnd.TorchCriterion(tnd.array(logits), tnd.array(logits),
                               criterion_id=bad)


def _example_net(mx, mid):
    data = mx.sym.Variable("data")
    tw = mx.sym.Variable("torch_weight", shape=(64, 32))
    tb = mx.sym.Variable("torch_bias", shape=(64,))
    net = mx.sym.TorchModule(data, tw, tb, module_id=mid, name="torch_fc")
    net = mx.sym.Activation(net, name="relu1", act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc_out", num_hidden=5)
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _example_data(n):
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 1, (n, 32)).astype(np.float32)
    w = rs.normal(size=(32, 5)).astype(np.float32)
    return x, (x @ w).argmax(axis=1).astype(np.float32)


def _example_fit(mx, nbatch, batch_end_callback=None):
    """examples/torch/torch_module.py's MLP, ``nbatch`` batches of 50
    through ``Module.fit`` (SGD lr 0.2) from fixed weights."""
    tp = jtp if mx is jmx else ttp
    torch.manual_seed(0)
    hidden = torch.nn.Linear(32, 64)
    rs = np.random.RandomState(1)
    arg = {"torch_weight": hidden.weight.detach().numpy().copy(),
           "torch_bias": hidden.bias.detach().numpy().copy(),
           "fc_out_weight": rs.normal(0, 0.1, (5, 64)).astype(np.float32),
           "fc_out_bias": np.zeros(5, np.float32)}
    net = _example_net(mx, tp.register_module(hidden))
    x, y = _example_data(50 * nbatch)
    mod = mx.mod.Module(net, context=mx.cpu())
    arr = jmx.nd.array if mx is jmx else (lambda a: tnd.array(a, ctx=CPU))
    mod.fit(mx.io.NDArrayIter(x, y, 50), optimizer="sgd",
            optimizer_params={"learning_rate": 0.2},
            arg_params={k: arr(v) for k, v in arg.items()}, num_epoch=1,
            batch_end_callback=batch_end_callback)
    return mod, hidden


def test_example_mlp_fit_matches_the_reference():
    jmod, _ = _example_fit(jmx, 3)
    tmod, hidden = _example_fit(tmx, 3)
    jarg, targ = jmod.get_params()[0], tmod.get_params()[0]
    assert sorted(jarg) == sorted(targ)
    for k in jarg:
        _close(targ[k].asnumpy(), jarg[k].asnumpy(), 1e-5)
    # the torch layer holds the weights of the last forward it ran: the
    # second update's, on the op's device
    torch.manual_seed(0)
    start = torch.nn.Linear(32, 64).weight.detach()
    assert hidden.weight.device.type == "cpu"
    assert not torch.equal(hidden.weight.detach(), start)
    assert not np.array_equal(hidden.weight.detach().numpy(),
                              targ["torch_weight"].asnumpy())


def _count_fit_syncs(monkeypatch, nbatch):
    counts = []

    def count(name, orig):
        def f(*a, **k):
            counts.append(name)
            return orig(*a, **k)
        return f

    with monkeypatch.context() as mp:
        for name in _SYNCS:
            mp.setattr(torch.Tensor, name,
                       count(name, getattr(torch.Tensor, name)))
        _example_fit(tmx, nbatch)
    return len(counts)


def test_fit_with_a_torch_module_adds_no_host_sync(monkeypatch):
    """The host reads of a fit are those of its ends (metrics), the same
    for 2 and for 8 batches: 0 a batch."""
    assert _count_fit_syncs(monkeypatch, 2) == \
        _count_fit_syncs(monkeypatch, 8)


def test_plugin_surface():
    from mxnet_tpu_torch import plugins

    assert plugins.torch_available is True
    assert callable(tnd.TorchModule) and callable(tmx.sym.TorchModule)
    assert callable(tnd.TorchCriterion) and callable(tmx.sym.TorchCriterion)
    for name in ("caffe_plugin", "sframe_plugin"):
        for pkg in ("mxnet_tpu", "mxnet_tpu_torch"):
            with pytest.raises(ImportError):
                __import__(f"{pkg}.plugins.{name}")
    with pytest.raises(MXNetError, match="no module registered"):
        with tmx.Context(CPU):
            tnd.TorchModule(tnd.zeros((2, 3)), module_id=10 ** 6)
    lin = torch.nn.Linear(3, 2)
    mid = ttp.register_module(lin)
    with pytest.raises(MXNetError, match="2 parameters"):
        with tmx.Context(CPU):
            tnd.TorchModule(tnd.zeros((2, 3)), module_id=mid)


# ------------------------------------------------------------ opencv
def _png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img.squeeze()).save(buf, format="PNG")
    return buf.getvalue()


def _jpeg(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(params=["cv2", "fallback"])
def route(request, monkeypatch):
    if request.param == "cv2":
        if jcv._cv2 is None or tcv._cv2 is None:
            pytest.fail("cv2 does not import in this environment")
    else:
        monkeypatch.setattr(jcv, "_cv2", None)
        monkeypatch.setattr(tcv, "_cv2", None)
    return request.param


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def test_opencv_decode_resize_border(route):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, (24, 32, 3), dtype=np.uint8)
    gray = rs.randint(0, 255, (24, 32, 1), dtype=np.uint8)
    with tmx.Context(CPU):
        for raw in (_png(img), _jpeg(img), _png(gray)):
            for flag in (1, 0):
                a, b = tcv.imdecode(raw, flag=flag), jcv.imdecode(raw, flag)
                np.testing.assert_array_equal(_np(a), _np(b))
                assert a.context.type == "cpu"
        src = jmx.nd.array(img)
        for interp in (tcv.INTER_NEAREST, tcv.INTER_LINEAR,
                       tcv.INTER_CUBIC):
            for data in (img, img.astype(np.float32) - 100.0, gray):
                np.testing.assert_array_equal(
                    _np(tcv.resize(data, (16, 12), interp)),
                    _np(jcv.resize(data, (16, 12), interp)))
            np.testing.assert_array_equal(
                _np(tcv.resize(tnd.array(img), (9, 13), interp)),
                _np(jcv.resize(src, (9, 13), interp)))
        for border in (tcv.BORDER_CONSTANT, tcv.BORDER_REPLICATE):
            for data in (img, gray):
                np.testing.assert_array_equal(
                    _np(tcv.copyMakeBorder(data, 2, 3, 4, 5, border, 7)),
                    _np(jcv.copyMakeBorder(data, 2, 3, 4, 5, border, 7)))


def test_opencv_crops_and_normalise(route):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 255, (40, 50, 3)).astype(np.uint8)
    assert tcv.scale_down((50, 40), (60, 30)) == \
        jcv.scale_down((50, 40), (60, 30))
    with tmx.Context(CPU):
        timg, jimg = tnd.array(img), jmx.nd.array(img)
        np.testing.assert_array_equal(
            _np(tcv.fixed_crop(timg, 5, 3, 20, 30, size=(10, 15))),
            _np(jcv.fixed_crop(jimg, 5, 3, 20, 30, size=(10, 15))))
        for fn, size in ((tcv.random_crop, (16, 16)),
                         (tcv.random_size_crop, (16, 16))):
            jfn = getattr(jcv, fn.__name__)
            a, ra = fn(timg, size, rng=np.random.RandomState(2))
            b, rb = jfn(jimg, size, rng=np.random.RandomState(2))
            assert ra == rb
            np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(
            _np(tcv.color_normalize(timg, (1.0, 2.0, 3.0), (2.0, 2.0, 2.0))),
            _np(jcv.color_normalize(jimg, (1.0, 2.0, 3.0), (2.0, 2.0, 2.0))))


def test_opencv_image_list_iter(route, tmp_path):
    rs = np.random.RandomState(3)
    names = []
    for i in range(5):
        names.append(f"{i}.png")
        with open(tmp_path / names[-1], "wb") as f:
            f.write(_png(rs.randint(0, 255, (20 + i, 24, 3), dtype=np.uint8)))
    out = {}
    for cv, mx in ((tcv, tmx), (jcv, jmx)):
        np.random.seed(4)
        random.seed(4)
        with tmx.Context(CPU):
            it = cv.ImageListIter(str(tmp_path), names, 2, (16, 16),
                                  mean=(1.0, 2.0, 3.0))
            out[cv] = [_np(b) for b in it]
            it.reset()
            assert len(list(it)) == 2
    assert len(out[tcv]) == 2
    for a, b in zip(out[tcv], out[jcv]):
        np.testing.assert_array_equal(a, b)
