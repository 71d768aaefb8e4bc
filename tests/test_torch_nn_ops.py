"""The rest of ``ops/nn.py`` in the port against the JAX package's, on the
CPU: ``Concat``, ``SliceChannel``, ``LRN``, ``LeakyReLU``,
``Deconvolution``, ``InstanceNorm``, ``L2Normalization``, ``Pad``,
``UpSampling``, ``Crop``, 1-D and 3-D ``Convolution`` and ``Pooling``,
``Dropout`` and ``BatchNorm`` under ``MXTPU_BN_STATS_DTYPE=compute``.

Each case runs the op's forward and its gradient (a seeded cotangent
through ``jax.vjp`` and ``torch.autograd.grad``) on numpy-seeded inputs
in fp32 and bf16, and in two layouts: NCHW memory, and the port's 4-D
input in channels-last memory (for ``LRN``, the op whose JAX version
reads the layout pass's attr, against the JAX op under
``__layout__="NHWC"`` on NHWC data).  ``MXTPU_CONV_PRECISION=float32``
puts the JAX convolutions in true fp32.

Tolerances: fp32 ``1e-5`` relative and absolute (the same arithmetic
summed in another order; the convolutions' gradients ``1e-4``, longer
sums); bf16 ``2e-2`` (each side rounds every intermediate to bf16, a
relative step of 2^-8, so results may part by a couple of steps).
Random ops are compared by statistics or through an injected mask: the
two packages' generators differ.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu import ops as jops

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.ops import registry as treg

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LAYOUTS = ["NCHW", "channels_last"]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _fp32_convs(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")


def _n(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(
        np.float32)


def _round(a, dtype):
    """``a`` rounded to ``dtype``, as fp32 numpy (both sides start here)."""
    if dtype == "bfloat16":
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _run(name, ins, attrs, dtype="float32", layout="NCHW", is_train=False,
         grad=True, jattrs=None):
    """``[(jax, port)]`` numpy pairs: each output, then each input's
    gradient under a seeded cotangent."""
    ins = [_round(a, dtype) for a in ins]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jattrs = dict(attrs if jattrs is None else jattrs)
    nhwc = (layout == "channels_last" and ins[0].ndim == 4
            and name in ("LRN",))
    jins = [jnp.asarray(a, dtype=jdt) for a in ins]
    if nhwc:
        jins[0] = jnp.transpose(jins[0], (0, 2, 3, 1))
        jattrs["__layout__"] = "NHWC"
    ts = [torch.from_numpy(a).to(tdt) for a in ins]
    if layout == "channels_last" and ts[0].ndim == 4:
        ts[0] = ts[0].contiguous(memory_format=torch.channels_last)
    ts = [t.requires_grad_(grad) for t in ts]

    jop, top = jops.get(name), treg.get(name)

    def jfn(*xs):
        out = jop.fn(jops.OpCtx(is_train=is_train), *xs, **jattrs)
        return out[0] if jop.aux_names else out

    jout, vjp = jax.vjp(jfn, *jins)
    tout = top.fn(treg.OpCtx(is_train=is_train), *ts, **attrs)
    if top.aux_names:
        tout = tout[0]
    jouts = list(jout) if isinstance(jout, tuple) else [jout]
    touts = list(tout) if isinstance(tout, tuple) else [tout]
    if nhwc:
        jouts = [jnp.transpose(j, (0, 3, 1, 2)) for j in jouts]
    pairs = []
    for j, t in zip(jouts, touts):
        assert str(t.dtype).split(".")[1] == str(np.dtype(j.dtype)), \
            (t.dtype, j.dtype)
        pairs.append((np.asarray(j, dtype=np.float32),
                      t.detach().float().numpy()))
    if not grad:
        return pairs
    cts = [_round(_n(100 + i, *t.shape), dtype) for i, t in enumerate(touts)]
    jct = [jnp.asarray(c, dtype=j.dtype) for c, j in zip(cts, jouts)]
    if nhwc:
        jct = [jnp.transpose(c, (0, 2, 3, 1)) for c in jct]
    jgrads = vjp(tuple(jct) if isinstance(jout, tuple) else jct[0])
    tgrads = torch.autograd.grad(
        touts, ts, [torch.from_numpy(c).to(t.dtype)
                    for c, t in zip(cts, touts)], allow_unused=True)
    for k, (jg, tg) in enumerate(zip(jgrads, tgrads)):
        jg = np.asarray(jg, dtype=np.float32)
        if nhwc and k == 0:
            jg = jg.transpose(0, 3, 1, 2)
        tg = np.zeros_like(jg) if tg is None else tg.float().numpy()
        pairs.append((jg, tg))
    return pairs


def _check(pairs, tol):
    for j, t in pairs:
        assert j.shape == t.shape, (j.shape, t.shape)
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


# (name, inputs(seed) -> list of arrays, attrs, fp32 tolerance or None)
CASES = {
    "concat_channels": ("Concat", lambda: [_n(1, 2, 3, 5, 4), _n(2, 2, 5, 5, 4),
                                           _n(3, 2, 2, 5, 4)],
                        {"dim": 1, "num_args": 3}),
    "concat_batch": ("Concat", lambda: [_n(1, 2, 3, 4, 4), _n(2, 3, 3, 4, 4)],
                     {"dim": "0", "num_args": "2"}),
    "concat_width": ("concat", lambda: [_n(1, 2, 3, 4, 2), _n(2, 2, 3, 4, 5)],
                     {"dim": 3}),
    "slice_channels": ("SliceChannel", lambda: [_n(4, 2, 6, 3, 4)],
                       {"num_outputs": 3}),
    "slice_squeeze": ("split", lambda: [_n(4, 2, 3, 5, 4)],
                      {"num_outputs": "3", "axis": "1",
                       "squeeze_axis": "True"}),
    "slice_last_axis": ("SliceChannel", lambda: [_n(4, 2, 3, 4, 6)],
                        {"num_outputs": 2, "axis": -1}),
    "lrn_alexnet": ("LRN", lambda: [_n(5, 2, 8, 5, 4, scale=3.0)],
                    {"alpha": 0.0001, "beta": 0.75, "knorm": 1, "nsize": 5}),
    "lrn_even": ("LRN", lambda: [_n(5, 2, 7, 4, 4, scale=2.0)],
                 {"alpha": 0.5, "beta": 0.6, "knorm": 2.0, "nsize": 4}),
    "lrn_default_knorm": ("LRN", lambda: [_n(5, 2, 6, 3, 5)],
                          {"alpha": "0.3", "nsize": "3"}),
    "leaky": ("LeakyReLU", lambda: [_n(6, 2, 3, 4, 4)], {"slope": 0.1}),
    "elu": ("LeakyReLU", lambda: [_n(6, 2, 3, 4, 4)],
            {"act_type": "elu", "slope": "0.3"}),
    "prelu": ("LeakyReLU", lambda: [_n(6, 2, 3, 4, 4), _n(7, 3) * 0.2],
              {"act_type": "prelu"}),
    "rrelu_eval": ("LeakyReLU", lambda: [_n(6, 2, 3, 4, 4)],
                   {"act_type": "rrelu", "lower_bound": 0.1,
                    "upper_bound": 0.3}),
    "deconv_s2": ("Deconvolution", lambda: [_n(8, 2, 3, 5, 5),
                                            _n(9, 3, 4, 4, 4) * 0.3],
                  {"kernel": (4, 4), "num_filter": 4, "stride": (2, 2),
                   "pad": (1, 1), "no_bias": True}, 1e-4),
    "deconv_bias_adj": ("Deconvolution", lambda: [
        _n(8, 2, 4, 4, 6), _n(9, 4, 3, 3, 3) * 0.3, _n(10, 3)],
        {"kernel": "(3, 3)", "num_filter": "3", "stride": "(2, 3)",
         "pad": "(1, 0)", "adj": "(1, 2)", "no_bias": "False"}, 1e-4),
    "deconv_group_dilate": ("Deconvolution", lambda: [
        _n(8, 2, 4, 5, 5), _n(9, 4, 3, 3, 3) * 0.3],
        {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
         "dilate": (2, 2), "pad": (1, 1), "no_bias": True}, 1e-4),
    "deconv_target": ("Deconvolution", lambda: [_n(8, 2, 3, 5, 5),
                                                _n(9, 3, 2, 4, 4) * 0.3],
                      {"kernel": (4, 4), "num_filter": 2, "stride": (2, 2),
                       "pad": (1, 1), "target_shape": (11, 10),
                       "no_bias": True}, 1e-4),
    "deconv_1d": ("Deconvolution", lambda: [_n(8, 2, 3, 7),
                                            _n(9, 3, 2, 3) * 0.3],
                  {"kernel": (3,), "num_filter": 2, "stride": (2,),
                   "no_bias": True}, 1e-4),
    "deconv_3d": ("Deconvolution", lambda: [_n(8, 1, 2, 3, 4, 3),
                                            _n(9, 2, 3, 2, 3, 2) * 0.3],
                  {"kernel": (2, 3, 2), "num_filter": 3, "stride": (1, 2, 2),
                   "pad": (0, 1, 0), "no_bias": True}, 1e-4),
    "conv_1d": ("Convolution", lambda: [_n(11, 2, 3, 12),
                                        _n(12, 4, 3, 3) * 0.3, _n(13, 4)],
                {"kernel": (3,), "num_filter": 4, "stride": (2,),
                 "pad": (1,), "dilate": (1,)}, 1e-4),
    "conv_3d": ("Convolution", lambda: [_n(11, 1, 2, 5, 6, 5),
                                        _n(12, 4, 1, 3, 3, 3) * 0.3],
                {"kernel": (3, 3, 3), "num_filter": 4, "num_group": 2,
                 "pad": (1, 0, 1), "stride": (1, 2, 1), "no_bias": True},
                1e-4),
    "instance_norm": ("InstanceNorm", lambda: [
        _n(14, 2, 3, 5, 4, scale=2.0) + 0.5, _n(15, 3), _n(16, 3)], {}),
    "instance_norm_eps": ("InstanceNorm", lambda: [
        _n(14, 2, 4, 6), _n(15, 4), _n(16, 4)], {"eps": "0.01"}),
    "l2_instance": ("L2Normalization", lambda: [_n(17, 2, 3, 4, 4)], {}),
    "l2_channel": ("L2Normalization", lambda: [_n(17, 2, 3, 4, 4)],
                   {"mode": "channel"}),
    "l2_spatial": ("L2Normalization", lambda: [_n(17, 2, 3, 4, 4)],
                   {"mode": "spatial", "eps": 1e-3}),
    "pad_constant": ("Pad", lambda: [_n(18, 2, 3, 4, 5)],
                     {"pad_width": (0, 0, 0, 0, 1, 2, 3, 1),
                      "mode": "constant", "constant_value": 1.5}),
    "pad_edge": ("Pad", lambda: [_n(18, 2, 3, 4, 5)],
                 {"pad_width": "(0, 0, 0, 0, 2, 1, 1, 3)", "mode": "edge"}),
    "pad_reflect": ("pad", lambda: [_n(18, 2, 3, 4, 5)],
                    {"pad_width": (0, 0, 0, 0, 3, 2, 4, 4),
                     "mode": "reflect"}),
    "pad_every_axis": ("Pad", lambda: [_n(18, 2, 3, 4, 5)],
                       {"pad_width": (1, 2, 2, 0, 0, 1, 1, 1),
                        "mode": "reflect"}),
    "pad_edge_leading": ("Pad", lambda: [_n(18, 2, 3, 4)],
                         {"pad_width": (2, 1, 0, 3, 1, 0), "mode": "edge"}),
    "upsample_nearest": ("UpSampling", lambda: [_n(19, 2, 3, 4, 5)],
                         {"scale": 2, "sample_type": "nearest"}),
    "upsample_nearest_3": ("UpSampling", lambda: [_n(19, 1, 2, 3, 3)],
                           {"scale": "3", "sample_type": "nearest",
                            "num_args": "1"}),
    "crop_hw": ("Crop", lambda: [_n(20, 2, 3, 7, 8)],
                {"h_w": (4, 5), "offset": (2, 1)}),
    "crop_center": ("Crop", lambda: [_n(20, 2, 3, 7, 8)],
                    {"h_w": (4, 5), "center_crop": True}),
    "crop_like": ("Crop", lambda: [_n(20, 2, 3, 7, 8), _n(21, 2, 3, 5, 3)],
                  {"num_args": 2, "offset": (1, 2)}),
    "pool1d_max": ("Pooling", lambda: [_n(22, 2, 3, 11)],
                   {"kernel": (3,), "stride": (2,), "pad": (1,),
                    "pool_type": "max"}),
    "pool1d_avg_full": ("Pooling", lambda: [_n(22, 2, 3, 10)],
                        {"kernel": "(3,)", "stride": "(2,)",
                         "pool_type": "avg", "pooling_convention": "full"}),
    "pool1d_global_sum": ("Pooling", lambda: [_n(22, 2, 3, 9)],
                          {"kernel": (1,), "global_pool": True,
                           "pool_type": "sum"}),
    "pool3d_max": ("Pooling", lambda: [_n(23, 1, 2, 5, 6, 7)],
                   {"kernel": (2, 3, 3), "stride": (2, 2, 2),
                    "pad": (0, 1, 1), "pool_type": "max"}),
    "pool3d_avg_bigpad": ("Pooling", lambda: [_n(23, 1, 2, 4, 5, 5)],
                          {"kernel": (2, 2, 3), "stride": (1, 2, 2),
                           "pad": (1, 1, 2), "pool_type": "avg"}),
    "pool3d_sum_full": ("Pooling", lambda: [_n(23, 1, 2, 5, 5, 6)],
                        {"kernel": (3, 3, 3), "stride": (2, 2, 2),
                         "pool_type": "sum", "pooling_convention": "full"}),
    "pool3d_global_avg": ("Pooling", lambda: [_n(23, 1, 3, 3, 4, 5)],
                          {"kernel": (1, 1, 1), "global_pool": "True",
                           "pool_type": "avg"}),
    "dropout_eval": ("Dropout", lambda: [_n(24, 2, 3, 4, 4)], {"p": 0.5}),
}


# channels-last memory is a 4-D format: other ranks run in NCHW only;
# the bf16 bias gradient has a test of its own (below)
PARAMS = [(case, dtype, layout) for case in sorted(CASES)
          for dtype in DTYPES for layout in LAYOUTS
          if (layout == "NCHW" or CASES[case][1]()[0].ndim == 4)
          and (case, dtype) != ("deconv_bias_adj", "bfloat16")]


@pytest.mark.parametrize("case,dtype,layout", PARAMS)
def test_op_and_gradient_match_jax(case, dtype, layout):
    name, make, attrs, *tol = CASES[case]
    ins = make()
    fp32_tol = tol[0] if tol else TOL["float32"]
    _check(_run(name, ins, attrs, dtype, layout),
           fp32_tol if dtype == "float32" else TOL["bfloat16"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_deconvolution_bf16_bias_gradient_is_the_rounded_sum(layout):
    """In bf16 the JAX op's bias gradient is a ``lax`` reduction that
    adds in bf16, one rounding per term (measured: -16.125 against an
    exact -16.388 over 320 terms); torch sums in fp32 and rounds once.
    So the port's bias gradient is held to the exact sum of the bf16
    cotangent rounded to bf16, the JAX one to ``n * 2^-8`` of the sum of
    magnitudes, and the output and the other gradients to JAX's at the
    bf16 tolerance."""
    name, make, attrs, _ = CASES["deconv_bias_adj"]
    pairs = _run(name, make(), attrs, "bfloat16", layout)
    out, dgrad, wgrad, (jb, tb) = pairs
    _check([out, dgrad, wgrad], TOL["bfloat16"])
    ct = _round(_n(100, *out[0].shape), "bfloat16").astype(np.float64)
    exact = ct.sum((0, 2, 3))
    np.testing.assert_array_equal(tb, _round(exact.astype(np.float32),
                                             "bfloat16"))
    n = ct.size // ct.shape[1]
    assert np.all(np.abs(jb - exact)
                  <= n * 2 ** -8 * np.abs(ct).sum((0, 2, 3)) / n)


# ------------------------------------------------------- random ops
def _inject(monkeypatch, values):
    """The port's draws replaced by ``values`` (a torch tensor), the JAX
    package's ``jax.random.bernoulli`` / ``uniform`` by the same numbers,
    so both ops see one draw."""
    from mxnet_tpu_torch.ops import nn as tnn

    monkeypatch.setattr(tnn, "_uniform",
                        lambda ctx, shape, lo, hi, like: values.reshape(shape))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(
                            values.numpy().reshape(shape) < p))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, minval, maxval: jnp.asarray(
                            values.numpy().reshape(shape)))


def _run_random(name, x, attrs, dtype):
    """(jax, port) pairs of output and data gradient in training, both
    ops drawing the injected numbers."""
    x = _round(x, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ctx = jops.OpCtx(is_train=True, key=jax.random.PRNGKey(0))
    jout, vjp = jax.vjp(lambda v: jops.get(name).fn(ctx, v, **attrs),
                        jnp.asarray(x, dtype=jdt))
    t = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tout = treg.get(name).fn(treg.OpCtx(is_train=True), t, **attrs)
    assert str(tout.dtype).split(".")[1] == str(np.dtype(jout.dtype))
    ct = _round(_n(101, *x.shape), dtype)
    (jg,) = vjp(jnp.asarray(ct, dtype=jout.dtype))
    (tg,) = torch.autograd.grad(tout, t, torch.from_numpy(ct).to(tout.dtype))
    return [(np.asarray(jout, np.float32), tout.detach().float().numpy()),
            (np.asarray(jg, np.float32), tg.float().numpy())]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [0.5, 0.2])
def test_dropout_with_an_injected_mask_matches_jax(monkeypatch, dtype, p):
    x = _n(30, 4, 6, 5)
    u = torch.from_numpy(np.random.RandomState(31).uniform(
        size=x.shape).astype(np.float32))
    _inject(monkeypatch, u)
    pairs = _run_random("Dropout", x, {"p": p}, dtype)
    # the same mask and the same division: equal to the bit
    for j, t in pairs:
        np.testing.assert_array_equal(t, j)
    assert 0 < (pairs[0][1] == 0).mean() < 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_rrelu_with_injected_slopes_matches_jax(monkeypatch, dtype):
    x = _n(32, 3, 5, 4, 4)
    s = torch.from_numpy(np.random.RandomState(33).uniform(
        0.1, 0.3, (1, 5, 1, 1)).astype(np.float32))
    _inject(monkeypatch, s)
    attrs = {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.3}
    # the fp32 slopes promote bf16 data to fp32 on both sides
    _check(_run_random("LeakyReLU", x, attrs, dtype), TOL["float32"])


def test_dropout_draws_from_the_graph_generator():
    x = torch.ones(64, 4096)
    op = treg.get("Dropout")

    def draw(seed, p=0.5):
        gen = torch.Generator().manual_seed(seed)
        return op.fn(treg.OpCtx(is_train=True, generator=gen), x, p=p)

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).double().mean().item()
    n = x.numel()
    assert abs(kept - 0.5) <= 4 * np.sqrt(0.25 / n)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    d = draw(1, p=0.2)
    assert abs((d != 0).double().mean().item() - 0.8) <= 4 * np.sqrt(
        0.16 / n)
    # eval and p = 0 are the identity
    assert op.fn(treg.OpCtx(is_train=False), x, p=0.5) is x
    assert op.fn(treg.OpCtx(is_train=True), x, p=0.0) is x


def test_nd_dropout_follows_the_process_seed():
    x = tnd.ones((32, 256), ctx="cpu")
    trandom.seed(7)
    a = tnd.Dropout(x, p=0.5).asnumpy()
    b = tnd.Dropout(x, p=0.5).asnumpy()
    trandom.seed(7)
    c = tnd.Dropout(x, p=0.5).asnumpy()
    assert np.array_equal(a, c) and not np.array_equal(a, b)
    assert set(np.unique(a)) == {0.0, 2.0}


def test_dropout_backward_reuses_the_forward_mask():
    """Through the executor: the gradient is zero exactly where the
    output is, and ``1/keep`` elsewhere."""
    net = tsym.Dropout(tsym.Variable("data"), p=0.25)
    exe = net.simple_bind("cpu", data=(16, 64))
    exe.arg_dict["data"][:] = 1.0
    trandom.seed(3)
    (out,) = exe.forward(is_train=True, data=np.ones((16, 64), np.float32))
    exe.backward(torch.ones(16, 64))
    g = exe.grad_dict["data"]
    assert torch.equal(g == 0, out == 0)
    torch.testing.assert_close(g[out != 0], torch.full_like(
        g[out != 0], 1 / 0.75))
    (ev,) = exe.forward(is_train=False)
    assert torch.equal(ev, torch.ones(16, 64))


def test_rrelu_training_slopes_lie_in_bounds_per_channel():
    x = -torch.ones(2, 64, 3, 3)
    gen = torch.Generator().manual_seed(0)
    out = treg.get("LeakyReLU").fn(
        treg.OpCtx(is_train=True, generator=gen), x, act_type="rrelu",
        lower_bound=0.2, upper_bound=0.4)
    slopes = -out
    assert out.dtype == torch.float32
    assert torch.equal(slopes, slopes[:1, :, :1, :1].expand_as(slopes))
    assert bool(((slopes >= 0.2) & (slopes < 0.4)).all())
    assert slopes.std() > 0.02


# ---------------------------------------------------------- UpSampling
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_bilinear_upsampling_is_the_jax_leading_window(dtype, scale):
    """MXNet's bilinear UpSampling gives ``n·scale`` per side; the JAX op
    pads ``scale-1`` more on the high side.  The port's output is the
    JAX op's leading ``n·scale`` window, and its gradients are the JAX
    op's under a cotangent that is zero on the extra rows and columns.
    The weight is not symmetric, so a flipped kernel would fail."""
    c, n = 3, 5
    k = 2 * scale - scale % 2
    x = _round(_n(40, 2, c, n, n + 1), dtype)
    w = _round(np.random.RandomState(41).uniform(
        0, 1, (c, 1, k, k)).astype(np.float32), dtype)
    attrs = {"scale": scale, "sample_type": "bilinear", "num_filter": c}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jout, vjp = jax.vjp(
        lambda a, b: jops.get("UpSampling").fn(jops.OpCtx(), a, b, **attrs),
        jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    assert jout.shape == (2, c, n * scale + scale - 1,
                          (n + 1) * scale + scale - 1)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (x, w)]
    tout = treg.get("UpSampling").fn(treg.OpCtx(), *ts, **attrs)
    assert tout.shape == (2, c, n * scale, (n + 1) * scale)
    lead = np.asarray(jout, np.float32)[:, :, :n * scale, :(n + 1) * scale]
    ct = _round(_n(42, *tout.shape), dtype)
    jct = np.zeros(jout.shape, np.float32)
    jct[:, :, :n * scale, :(n + 1) * scale] = ct
    jg = vjp(jnp.asarray(jct, jdt))
    tg = torch.autograd.grad(tout, ts, torch.from_numpy(ct).to(tdt))
    pairs = [(lead, tout.detach().float().numpy())] + [
        (np.asarray(a, np.float32), b.float().numpy())
        for a, b in zip(jg, tg)]
    # the weight gradient sums n² products per entry
    _check(pairs, 1e-4 if dtype == "float32" else TOL["bfloat16"])
    assert not np.allclose(lead, treg.get("UpSampling").fn(
        treg.OpCtx(), ts[0], ts[1].flip(2, 3), **attrs).detach().float()
        .numpy(), atol=1e-3)


def test_upsampling_infers_mxnet_output_size():
    net = tsym.UpSampling(tsym.Variable("data"), scale=2,
                          sample_type="bilinear", num_filter=2, num_args=2,
                          name="up")
    args, outs, _ = net.infer_shape(data=(1, 2, 5, 5))
    assert net.list_arguments() == ["data", "up_weight"]
    assert args[1] == (2, 1, 4, 4) and outs == [(1, 2, 10, 10)]
    near = tsym.UpSampling(tsym.Variable("data"), scale=3, num_args=1)
    assert near.infer_shape(data=(1, 2, 5, 4))[1] == [(1, 2, 15, 12)]


# ------------------------------------------------------- Deconvolution
def test_deconvolution_has_no_bias_by_default():
    from mxnet_tpu import symbol as jsym

    t = tsym.Deconvolution(tsym.Variable("data"), kernel=(4, 4),
                           num_filter=3, stride=(2, 2), name="d")
    assert t.list_arguments() == ["data", "d_weight"]
    args, outs, _ = t.infer_shape(data=(1, 2, 5, 5))
    assert args == [(1, 2, 5, 5), (2, 3, 4, 4)] and outs == [(1, 3, 12, 12)]
    # the JAX package's sym.Deconvolution makes a bias unless told not to
    j = jsym.Deconvolution(jsym.Variable("data"), kernel=(4, 4),
                           num_filter=3, stride=(2, 2), name="d")
    assert j.list_arguments() == ["data", "d_weight", "d_bias"]
    jn = jsym.Deconvolution(jsym.Variable("data"), kernel=(4, 4),
                            num_filter=3, stride=(2, 2), name="d",
                            no_bias=True)
    assert jn.list_arguments() == t.list_arguments()
    tb = tsym.Deconvolution(tsym.Variable("data"), kernel=(4, 4),
                            num_filter=3, stride=(2, 2), name="d",
                            no_bias=False)
    assert tb.list_arguments() == j.list_arguments()
    assert tb.infer_shape(data=(1, 2, 5, 5))[0][2] == (3,)
    # the JAX symbol's JSON, bias and all, loads and infers in the port
    loaded = tsym.load_json(j.tojson())
    assert loaded.list_arguments() == j.list_arguments()
    assert loaded.infer_shape(data=(1, 2, 5, 5)) == j.infer_shape(
        data=(1, 2, 5, 5))


def test_deconvolution_refusals_match_jax():
    x = _n(50, 1, 2, 5, 5)
    w = _n(51, 2, 3, 4, 4)
    attrs = {"kernel": (4, 4), "num_filter": 3, "stride": (2, 2),
             "target_shape": (13, 10)}
    with pytest.raises(mxnet_tpu.MXNetError) as jerr:
        jops.get("Deconvolution").fn(jops.OpCtx(), jnp.asarray(x),
                                     jnp.asarray(w), **attrs)
    with pytest.raises(MXNetError) as terr:
        treg.get("Deconvolution").fn(treg.OpCtx(), torch.from_numpy(x),
                                     torch.from_numpy(w), **attrs)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(MXNetError, match="adj"):
        treg.get("Deconvolution").fn(
            treg.OpCtx(), torch.from_numpy(x), torch.from_numpy(w),
            kernel=(4, 4), num_filter=3, stride=(2, 2), adj=(2, 0))


# ------------------------------------------------ SliceChannel, Concat
def test_slice_channel_outputs_through_sym_nd_and_executor():
    from mxnet_tpu import symbol as jsym

    t = tsym.SliceChannel(tsym.Variable("data"), num_outputs=3, name="s")
    j = jsym.SliceChannel(jsym.Variable("data"), num_outputs=3, name="s")
    assert len(t) == 3 and t.list_outputs() == j.list_outputs()
    assert t.infer_shape(data=(2, 6, 4))[1] == [(2, 2, 4)] * 3
    net = t[0] + t[2] * 2.0
    assert tsym.load_json(net.tojson()).tojson() == net.tojson()
    x = _n(52, 2, 6, 4)
    exe = net.simple_bind("cpu", data=x.shape)
    (out,) = exe.forward(data=x)
    np.testing.assert_allclose(out.numpy(), x[:, 0:2] + 2 * x[:, 4:6],
                               rtol=1e-6)
    exe2 = t.simple_bind("cpu", data=x.shape)
    outs = exe2.forward(data=x)
    assert len(outs) == 3
    parts = tnd.split(tnd.array(x, ctx="cpu"), num_outputs=3, axis=1)
    assert len(parts) == 3
    for k, p in enumerate(parts):
        np.testing.assert_array_equal(p.asnumpy(), x[:, 2 * k:2 * k + 2])
        np.testing.assert_array_equal(outs[k].numpy(), p.asnumpy())
    with pytest.raises(MXNetError, match="equal parts"):
        tnd.split(tnd.array(x, ctx="cpu"), num_outputs=4, axis=1)


def test_attr_dependent_output_counts(monkeypatch):
    """``num_outputs=-1`` reads the ``num_outputs`` attr (SliceChannel);
    ``num_outputs_fn`` computes the count, naming outputs past
    ``output_names`` ``output<i>``, as the JAX Symbol does."""
    op = treg.OpDef(name="_pair_or_more", fn=lambda ctx, x, **a: (x, x),
                    output_names=("first", "second"),
                    num_outputs_fn=lambda attrs: int(attrs.get("n", 2)))
    monkeypatch.setitem(treg._OPS, "_pair_or_more", op)
    s = tsym._create("_pair_or_more", [tsym.Variable("x")], {"n": 3},
                     name="p")
    assert s.list_outputs() == ["p_first", "p_second", "p_output2"]
    assert op.count_outputs({"n": "3"}) == 3
    split = treg.get("SliceChannel")
    assert split.count_outputs({"num_outputs": "4"}) == 4


def test_concat_keeps_channels_last_memory():
    xs = [torch.randn(2, c, 5, 5).contiguous(
        memory_format=torch.channels_last) for c in (3, 8, 5)]
    out = treg.get("Concat").fn(treg.OpCtx(), *xs, dim=1)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, torch.cat([x.contiguous() for x in xs], 1))


def test_every_name_of_the_jax_nn_module_is_registered():
    jnames = {n for n in jops.list_ops()
              if jops.get(n).fn.__module__ == "mxnet_tpu.ops.nn"}
    tnames = {n for n in treg.list_ops()
              if treg.get(n).fn.__module__ == "mxnet_tpu_torch.ops.nn"}
    assert jnames == tnames and len(tnames) == 20
    for n in jnames:
        j, t = jops.get(n), treg.get(n)
        assert (tuple(j.arg_names), tuple(j.aux_names), j.num_outputs,
                j.varargs, j.needs_rng) == (
            tuple(t.arg_names), tuple(t.aux_names), t.num_outputs,
            t.varargs, t.needs_rng), n
        assert j.attr_defaults == t.attr_defaults, n


def test_pad_refuses_an_unknown_mode():
    with pytest.raises(MXNetError, match="unknown mode"):
        tnd.Pad(tnd.ones((1, 1, 2, 2), ctx="cpu"),
                pad_width=(0, 0, 0, 0, 1, 1, 1, 1), mode="wrap")


# ------------------------------------------------------------- Symbol
def _both(build):
    """``build(sym)`` in both packages under fresh name managers; the two
    JSON strings."""
    from mxnet_tpu import base as jbase
    from mxnet_tpu import symbol as jsym
    from mxnet_tpu_torch import base as tbase

    with jbase.NameManager():
        want = build(jsym).tojson()
    old = tbase._NAME_MANAGER
    tbase._NAME_MANAGER = tbase.NameManager()
    try:
        got = build(tsym).tojson()
    finally:
        tbase._NAME_MANAGER = old
    return want, got


OPERATORS = {
    "sub": lambda a, b: a - b, "sub_scalar": lambda a, b: a - 2.0,
    "rsub": lambda a, b: 2.0 - a, "mul": lambda a, b: a * b,
    "mul_scalar": lambda a, b: a * 3.0, "rmul": lambda a, b: 3.0 * a,
    "div": lambda a, b: a / b, "div_scalar": lambda a, b: a / 4.0,
    "rdiv": lambda a, b: 4.0 / a, "pow": lambda a, b: a ** b,
    "pow_scalar": lambda a, b: a ** 2.0, "neg": lambda a, b: -a,
    "radd": lambda a, b: 1.0 + a, "add": lambda a, b: a + b,
    "chain": lambda a, b: -(a * 0.17 + b) / (1 - a) ** 2,
}


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_symbol_operators_match_jax_json(op):
    fn = OPERATORS[op]
    want, got = _both(lambda s: fn(s.Variable("a"), s.Variable("b")))
    assert got == want
    # and they evaluate as the expression does
    net = tsym.load_json(got)
    a = np.random.RandomState(53).uniform(0.5, 1.5, (2, 3)).astype(
        np.float32)
    b = np.random.RandomState(54).uniform(0.5, 1.5, (2, 3)).astype(
        np.float32)
    shapes = {k: a.shape for k in net.list_arguments()}
    exe = net.simple_bind("cpu", grad_req="null", **shapes)
    feed = {k: v for k, v in (("a", a), ("b", b)) if k in shapes}
    (out,) = exe.forward(**feed)
    np.testing.assert_allclose(out.numpy(), fn(a, b), rtol=1e-5)
