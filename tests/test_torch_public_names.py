"""The public names the port gained with the core telemetry, each against
the JAX package's: ``ops.loss.token_nll`` on seeded fp32 logits with
integer and float-encoded labels, ``base.get_env`` on the same
environment strings, ``ops.registry.exists`` over every registered name
and a missing one, ``PagedSlots.max_prompt`` on a small decoder, and
``NDArray.wait_to_write``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import base as jbase
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import loss as jloss
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch.ops import loss as tloss
from mxnet_tpu_torch.ops import registry as treg


@pytest.mark.parametrize("shape", [(2, 8, 64), (8, 64), (3, 2, 4, 16)])
@pytest.mark.parametrize("encoding", ["int", "float"])
def test_token_nll_matches_jax(shape, encoding):
    rs = np.random.RandomState(0)
    logits = rs.normal(0, 3, shape).astype(np.float32)
    labels = rs.randint(0, shape[-1], shape[:-1])
    labels = labels.astype(np.int32 if encoding == "int" else np.float32)
    want = float(jloss.token_nll(jnp.asarray(logits), jnp.asarray(labels)))
    got = tloss.token_nll(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # numpy inputs too, as the reference takes them
    np.testing.assert_allclose(float(tloss.token_nll(logits, labels)), want,
                               rtol=1e-6)


def test_token_nll_gradient_is_softmax_less_onehot():
    rs = np.random.RandomState(1)
    logits = torch.from_numpy(rs.normal(size=(2, 8, 64)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 64, (2, 8)))
    logits.requires_grad_(True)
    tloss.token_nll(logits, labels).backward()
    want = (torch.softmax(logits.detach(), -1)
            - torch.nn.functional.one_hot(labels, 64)) / 16
    torch.testing.assert_close(logits.grad, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("raw,default,dtype", [
    (None, 3, None), ("7", 3, None), ("2.5", 1.0, None), ("x", "d", None),
    ("0", True, None), ("false", True, None), ("FALSE", True, None),
    ("", True, None), ("1", False, None), ("yes", False, None),
    ("12", None, int), ("0.25", None, float), ("abc", 0, str),
])
def test_get_env_matches_jax(monkeypatch, raw, default, dtype):
    name = "MXTT_TEST_GET_ENV"
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    want = jbase.get_env(name, default, dtype)
    got = tbase.get_env(name, default, dtype)
    assert got == want and type(got) is type(want)


def test_get_env_raises_as_jax_on_a_bad_number(monkeypatch):
    monkeypatch.setenv("MXTT_TEST_GET_ENV", "x")
    with pytest.raises(ValueError):
        jbase.get_env("MXTT_TEST_GET_ENV", 3)
    with pytest.raises(ValueError):
        tbase.get_env("MXTT_TEST_GET_ENV", 3)


def test_registry_exists_matches_jax():
    names = treg.list_ops()
    assert names and all(treg.exists(n) for n in names)
    assert [jreg.exists(n) for n in names] == [True] * len(names)
    for missing in ("NoSuchOp", "", "fullyconnected"):
        assert treg.exists(missing) is jreg.exists(missing) is False
    assert treg.exists("FullyConnected") is jreg.exists("FullyConnected")


def test_paged_slots_max_prompt_matches_jax():
    from mxnet_tpu.models.decode import KVDecoder as JDecoder
    from mxnet_tpu.serving.paged_kv import PagedSlots as JSlots

    from mxnet_tpu_torch.models.decode import KVDecoder as TDecoder
    from mxnet_tpu_torch.models.transformer import (lm_param_shapes,
                                                    lm_random_params)
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots as TSlots

    L, H, D, V, T = 1, 2, 16, 32, 48
    params = lm_random_params(lm_param_shapes(L, H, D, 4 * D, V, T), seed=2)
    jdec = JDecoder({k: jnd.array(v) for k, v in params.items()},
                    num_layers=L, num_heads=H, max_len=T)
    tdec = TDecoder(params, num_layers=L, num_heads=H, max_len=T,
                    device="cpu")
    js = JSlots(jdec, 2, block=16, prefill_buckets=(16, 32, 48))
    ts = TSlots(tdec, 2, block=16, prefill_buckets=(16, 32, 48))
    assert ts.max_prompt == js.max_prompt == T


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_wait_to_write_returns_and_keeps_the_value(pkg):
    if pkg == "jax":
        a = jnd.array(np.arange(6, dtype=np.float32))
        b = a * 2
    else:
        a = tmx.nd.array(np.arange(6, dtype=np.float32), ctx=tmx.cpu())
        b = a * 2
    assert b.wait_to_write() is None
    np.testing.assert_array_equal(b.asnumpy(),
                                  2 * np.arange(6, dtype=np.float32))
    b[:] = 1.0
    b.wait_to_write()
    np.testing.assert_array_equal(b.asnumpy(), np.ones(6, np.float32))
