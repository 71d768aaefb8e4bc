"""The port's residual epilogue against the JAX package's, on the CPU.

The port's plain version (``_plain_fwd``) against the JAX lax twin and
against the Pallas kernel in interpret mode; the ``autograd.Function``'s
gradients against ``jax.grad`` through the interpreted kernel; the
``supports()`` gate; and the ``_residual_epilogue`` /
``_residual_epilogue_bn`` ops in eval and train mode, NCHW and
channels-last, aux pass-through and update included.  Inputs come from
numpy seeds and go to both packages; tolerances are stated where used.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu import ops as jops
from mxnet_tpu.ops import residual_epilogue as jre

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import residual_epilogue as tre

SHAPES = [(2, 4, 4, 128), (2, 8, 8, 256)]  # NHWC, as the JAX tests use

# one bf16 ulp at magnitude m is 2^-7 * 2^floor(log2 m); the bound
# below holds one ulp of every output
BF16_ULP = 2.0 ** -7


def _case(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.uniform(-1, 1, shape).astype(dtype)
    s = rng.uniform(-1, 1, shape).astype(dtype)
    scale = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (c,)).astype(np.float32)
    return x, s, scale, bias


def _t(a):
    """numpy (float32 or ml_dtypes bfloat16) -> torch tensor."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_lax_fp32(shape):
    x, s, scale, bias = _case(shape, 0)
    want = jre.residual_epilogue(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(scale), jnp.asarray(bias),
                                 channel_axis=-1, impl="lax")
    got = tre.residual_epilogue(_t(x), _t(s), _t(scale), _t(bias),
                                channel_axis=-1)
    # the same fp32 operations in the same order
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_lax_bf16(shape):
    x, s, scale, bias = _case(shape, 1, ml_dtypes.bfloat16)
    want = jre.residual_epilogue(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(scale), jnp.asarray(bias),
                                 channel_axis=-1, impl="lax")
    got = tre.residual_epilogue(_t(x), _t(s), _t(scale), _t(bias),
                                channel_axis=-1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # both add in bf16 and round the fp32 affine once: at most one bf16
    # ulp apart (exact in practice)
    w = np.asarray(want).astype(np.float32)
    assert np.all(np.abs(_np(got) - w) <= BF16_ULP * np.abs(w) + 1e-30)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    x, s, scale, bias = _case(shape, 2)
    want = jre.residual_epilogue(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(scale), jnp.asarray(bias),
                                 channel_axis=-1, impl="pallas_interpret")
    got = tre.residual_epilogue(_t(x), _t(s), _t(scale), _t(bias),
                                channel_axis=-1, impl="lax")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_plain_matches_pallas_interpret_bf16_within_add_rounding():
    """The TPU kernel (like the CUDA kernel) adds x and s in fp32; the
    plain version rounds x + s to bf16 first.  Per element the two part
    by at most that rounding times the scale (2^-8 |x + s| |scale|) plus
    one rounding of each output (2^-8 each)."""
    x, s, scale, bias = _case((2, 8, 8, 256), 3, ml_dtypes.bfloat16)
    want = np.asarray(jre.residual_epilogue(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(scale),
        jnp.asarray(bias), channel_axis=-1,
        impl="pallas_interpret")).astype(np.float32)
    got = _np(tre.residual_epilogue(_t(x), _t(s), _t(scale), _t(bias),
                                    channel_axis=-1))
    t = x.astype(np.float32) + s.astype(np.float32)
    bound = 2.0 ** -8 * np.abs(t * scale) + 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound + 1e-30)
    # and the rounding is visible: the two are not identical
    assert np.any(got != want)


def test_autograd_matches_jax_grad_through_interpreted_kernel():
    """The four gradients of ``sum(out * cos(out))``, as
    tests/test_amp.py checks the JAX pair, at 1e-5."""
    x, s, scale, bias = _case((2, 4, 4, 128), 0)

    def f(x_, s_, sc_, b_):
        out = jre.residual_epilogue(x_, s_, sc_, b_, channel_axis=-1,
                                    impl="pallas_interpret")
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, s, scale, bias)))
    ins = [_t(a).requires_grad_(True) for a in (x, s, scale, bias)]
    out = tre.residual_epilogue(*ins, channel_axis=-1)
    (out * torch.cos(out)).sum().backward()
    for t, w in zip(ins, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("rows", [0, 7, 8, 16, 100, 128, 200, 256, 512,
                                  768, 6272, 25088])
@pytest.mark.parametrize("c", [64, 100, 128, 256, 384, 2048])
def test_supports_matches_jax(rows, c):
    assert tre.supports(rows, c) == jre.supports(rows, c)
    assert tre._default_block_rows(max(rows, 1)) == \
        jre._default_block_rows(max(rows, 1))


def test_shape_gate_takes_the_plain_version():
    """A ragged C (not a lane multiple) goes to the plain version under
    ``auto`` and still computes correctly (tests/test_amp.py's gate)."""
    assert not tre.supports(32, 100)
    x = torch.ones((2, 3, 3, 100))
    s = torch.ones((2, 3, 3, 100)) * -0.5
    out = tre.residual_epilogue(x, s, channel_axis=-1)
    np.testing.assert_allclose(_np(out), np.full(x.shape, 0.5), rtol=1e-6)


def test_kernel_refuses_cpu_tensors_and_unknown_impls():
    x = torch.ones((2, 4, 4, 128))
    with pytest.raises(MXNetError, match="not on a CUDA device"):
        tre.residual_epilogue(x, x, channel_axis=-1, impl="cuda")
    with pytest.raises(MXNetError, match="unknown impl"):
        tre.residual_epilogue(x, x, channel_axis=-1, impl="pallas")
    # tune() is ported: without a card the plain version has no
    # schedule, so it keeps the default and records nothing
    assert tre.tune(512, 256) == tre.DEFAULT_SCHEDULE


def test_rows_view_follows_the_memory_format():
    x = torch.zeros((2, 256, 4, 4))
    assert not tre.has_rows_view(x, 1)
    assert tre.has_rows_view(x.contiguous(memory_format=torch.channels_last),
                             1)
    assert tre.has_rows_view(x.permute(0, 2, 3, 1).contiguous(), 3)


# ------------------------------------------------------------------ ops
def _bn_case(c, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.5, 1.5, (c,)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (c,)).astype(np.float32),
            rng.uniform(-0.1, 0.1, (c,)).astype(np.float32),
            rng.uniform(0.75, 1.25, (c,)).astype(np.float32))


def _run_jax_op(name, inputs, attrs, is_train):
    return jops.get(name).fn(jops.OpCtx(is_train=is_train),
                             *map(jnp.asarray, inputs), **attrs)


def _run_port_op(name, inputs, attrs, is_train, channels_last):
    ts = [_t(a) for a in inputs]
    if channels_last:
        ts = [t.contiguous(memory_format=torch.channels_last)
              if t.ndim == 4 else t for t in ts]
    return treg.get(name).fn(treg.OpCtx(is_train=is_train), *ts, **attrs)


@pytest.mark.parametrize("channels_last", [False, True])
def test_residual_epilogue_op_matches_jax(channels_last):
    rng = np.random.RandomState(4)
    x = rng.normal(size=(2, 128, 4, 4)).astype(np.float32)   # NCHW
    s = rng.normal(size=(2, 128, 4, 4)).astype(np.float32)
    want = _run_jax_op("_residual_epilogue", [x, s], {}, False)
    got = _run_port_op("_residual_epilogue", [x, s], {}, False,
                       channels_last)
    if channels_last:
        assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


BN_ATTRS = [{"fix_gamma": False, "eps": 2e-5, "momentum": 0.9},
            {},                                      # defaults: fix_gamma
            {"fix_gamma": "False", "use_global_stats": "True",
             "eps": "1e-4"}]


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("attrs", BN_ATTRS)
def test_residual_epilogue_bn_op_matches_jax(attrs, channels_last, is_train):
    """Eval folds the moving stats and passes them through; train replays
    BatchNorm + ReLU with the aux update.  fp32 throughout: the fold and
    the batch moments are the same fp32 arithmetic in another order."""
    rng = np.random.RandomState(5)
    x = rng.normal(size=(2, 256, 3, 3)).astype(np.float32)
    s = rng.normal(size=(2, 256, 3, 3)).astype(np.float32)
    ins = [x, s, *_bn_case(256, 6)]
    jout, jaux = _run_jax_op("_residual_epilogue_bn", ins, attrs, is_train)
    tout, taux = _run_port_op("_residual_epilogue_bn", ins, attrs, is_train,
                              channels_last)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(taux, jaux):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    moving_stats_pass_through = not is_train or "use_global_stats" in attrs
    if moving_stats_pass_through:
        np.testing.assert_array_equal(_np(taux[0]), ins[4])
        np.testing.assert_array_equal(_np(taux[1]), ins[5])


def test_residual_epilogue_bn_op_bf16_matches_jax_loosely():
    """The Predictor's bf16 case: data, shortcut and the BN params and
    stats all bf16 (the JAX Predictor casts them), the fold read in fp32
    from the bf16 values.  Both sides add in bf16 and round the fp32
    affine once: one bf16 ulp."""
    rng = np.random.RandomState(7)
    bf = ml_dtypes.bfloat16
    ins = [rng.normal(size=(2, 128, 4, 4)).astype(bf),
           rng.normal(size=(2, 128, 4, 4)).astype(bf)]
    ins += [a.astype(bf) for a in _bn_case(128, 8)]
    attrs = {"fix_gamma": False, "eps": 2e-5}
    jout, _ = _run_jax_op("_residual_epilogue_bn", ins, attrs, False)
    tout, _ = _run_port_op("_residual_epilogue_bn", ins, attrs, False, True)
    w = np.asarray(jout).astype(np.float32)
    assert np.all(np.abs(_np(tout) - w) <= BF16_ULP * np.abs(w) + 1e-30)
