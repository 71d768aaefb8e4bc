"""The port's flash attention against the JAX package, on the CPU.

On CPU tensors ``mxnet_tpu_torch.ops.flash_attention`` runs its plain
versions; each must match the JAX Pallas kernel it stands beside, run
in interpret mode (``_fwd_impl`` / ``_bwd_impl`` with
``interpret=True``), to 1e-5 in fp32: scores of order 10 (unit-normal
q, k, D 16-32 scaled by 1/sqrt(D)) are summed over at most 256 keys, and
fp32 reassociation of such sums stays near 1e-6.  The CUDA kernels are
held against the plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu.parallel import ring_attention as jra

from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.parallel import ring_attention as tra

ATOL = 1e-5


def _case(b=2, h=2, t=128, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.normal(size=(b, h, t, d)).astype(np.float32)
            for _ in range(4)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=0)


# (t, d, block_q, block_k): both block sizes, uneven blocks, T 128 / 256
SHAPES = [(128, 16, 64, 64), (128, 32, 32, 64), (256, 16, 64, 32)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d,bq,bk", SHAPES)
def test_plain_forward_matches_pallas_interpret(causal, t, d, bq, bk):
    q, k, v, _ = _case(t=t, d=d)
    scale = 1.0 / np.sqrt(d)
    jo, jlse = jfa._fwd_impl(*[jnp.asarray(a) for a in (q, k, v)], scale,
                             causal, bq, bk, True)
    o, lse = tfa.fwd_plain(*_t(q, k, v), scale, causal)
    assert o.dtype == torch.float32 and lse.shape == (2, 2, t)
    _close(o, jo)
    _close(lse, jlse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d,bq,bk", SHAPES)
def test_plain_backward_matches_pallas_interpret(causal, t, d, bq, bk):
    q, k, v, do = _case(t=t, d=d, seed=1)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = [jnp.asarray(a) for a in (q, k, v, do)]
    jo, jlse = jfa._fwd_impl(jq, jk, jv, scale, causal, bq, bk, True)
    jdq, jdk, jdv = jfa._bwd_impl(jq, jk, jv, jo, jlse, jdo, scale, causal,
                                  bq, bk, True)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = _t(np.asarray(jo), np.asarray(jlse))
    delta = (o * tdo).sum(-1)
    _close(tfa.dq_plain(tq, tk, tv, tdo, lse, delta, scale, causal), jdq)
    dk, dv = tfa.dkv_plain(tq, tk, tv, tdo, lse, delta, scale, causal)
    _close(dk, jdk)
    _close(dv, jdv)
    # the module's own backward (δ computed inside) gives the same three
    got = tfa._bwd_impl(tq, tk, tv, o, lse, tdo, scale, causal)
    for g, w in zip(got, (jdq, jdk, jdv)):
        _close(g, w)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_jax_vjp(causal):
    q, k, v, do = _case(t=128, d=32, seed=2)
    jq, jk, jv, jdo = [jnp.asarray(a) for a in (q, k, v, do)]
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal, None, 64, 64, True), jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv = [x.requires_grad_(True) for x in _t(q, k, v)]
    got = tfa.flash_attention(tq, tk, tv, causal, None, 64, 64)
    _close(got, out)
    got.backward(torch.from_numpy(do))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(g, w)
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0}


def test_bf16_outputs_keep_the_jax_dtypes():
    q, k, v, do = _case(t=64, d=16, seed=3)
    tq, tk, tv, tdo = [x.to(torch.bfloat16) for x in _t(q, k, v, do)]
    o, lse = tfa.fwd_plain(tq, tk, tv, 0.25, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    delta = (o.float() * tdo.float()).sum(-1)
    dq = tfa.dq_plain(tq, tk, tv, tdo, lse, delta, 0.25, True)
    dk, dv = tfa.dkv_plain(tq, tk, tv, tdo, lse, delta, 0.25, True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


@pytest.mark.parametrize("shape,bq,bk", [
    ((1, 2, 256, 64), 128, 128), ((1, 2, 250, 64), 128, 128),
    ((1, 2, 256, 63), 128, 128), ((2, 2, 192, 16), 64, 32),
    ((2, 2, 192, 16), 128, 64), ((1, 1, 64, 128), 64, 64)])
def test_supports_matches_jax_gate(shape, bq, bk):
    assert tfa.supports(shape, bq, bk) == jfa.supports(shape, bq, bk)


def test_supports_adds_the_kernels_head_limit():
    assert jfa.supports((1, 1, 64, 256), 64, 64)
    assert not tfa.supports((1, 1, 64, 256), 64, 64)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal):
    q, k, v, _ = _case(t=64, d=16, seed=4)
    want = jra.full_attention(*[jnp.asarray(a) for a in (q, k, v)],
                              causal=causal)
    _close(tra.full_attention(*_t(q, k, v), causal=causal), want)


def test_full_attention_bf16_promotes_like_jax():
    q, k, v, _ = _case(t=32, d=16, seed=5)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jra.full_attention(*jb, causal=True)
    got = tra.full_attention(*[x.to(torch.bfloat16) for x in _t(q, k, v)],
                             causal=True)
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    # both round the scores to bf16 before scaling; softmax and the
    # weighted sum run in fp32 on both sides
    _close(got, want, atol=2e-2)


@pytest.mark.parametrize("env,block", [
    ({}, 128), ({"MXTPU_FLASH_BLOCK_Q": "64", "MXTPU_FLASH_BLOCK_K": "32"},
                64)])
def test_dispatcher_blocks_from_env(monkeypatch, env, block):
    for name in ("MXTPU_FLASH_BLOCK_Q", "MXTPU_FLASH_BLOCK_K"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    assert tra._env_block("MXTPU_FLASH_BLOCK_Q") == block
    assert tra._env_block("MXTPU_FLASH_BLOCK_Q") == \
        jra._env_block("MXTPU_FLASH_BLOCK_Q")
    q, k, v, _ = _case(t=192, d=16, seed=6)
    want = jra.full_attention(*[jnp.asarray(a) for a in (q, k, v)],
                              causal=True)
    # CPU tensors: auto takes the plain versions, whatever the gate says
    _close(tra.attention(*_t(q, k, v), causal=True), want)
    # flash takes the gate: T 192 divides by 64 and 32 but not by 128
    if block == 128:
        with pytest.raises(ValueError, match="divisible"):
            tra.attention(*_t(q, k, v), causal=True, impl="flash")
    else:
        _close(tra.attention(*_t(q, k, v), causal=True, impl="flash"), want)
    _close(tra.attention(*_t(q, k, v), causal=True, impl="lax"), want)


@pytest.mark.parametrize("raw", ["abc", "0", "-4"])
def test_dispatcher_malformed_block_warns(monkeypatch, raw):
    monkeypatch.setenv("MXTPU_FLASH_BLOCK_K", raw)
    with pytest.warns(UserWarning, match="not a positive integer"):
        assert tra._env_block("MXTPU_FLASH_BLOCK_K") == 128
    q, k, v, _ = _case(t=32, d=16, seed=7)
    with pytest.warns(UserWarning):
        out = tra.attention(*_t(q, k, v), causal=False)
    _close(out, jra.full_attention(*[jnp.asarray(a) for a in (q, k, v)]))


def test_dispatcher_odd_head_width_on_cpu():
    # D 12 fails the gate; a CPU tensor still takes the plain versions
    q, k, v, _ = _case(t=16, d=12, seed=8)
    want = jra.full_attention(*[jnp.asarray(a) for a in (q, k, v)],
                              causal=True)
    _close(tra.attention(*_t(q, k, v), causal=True), want)


def test_flash_attention_op_from_string_attrs():
    q, k, v, _ = _case(t=64, d=16, seed=9)
    fn = treg.get("FlashAttention").fn
    got = fn(treg.OpCtx(), *_t(q, k, v), causal="True", scale="0.2",
             impl="auto")
    want = jra.full_attention(*[jnp.asarray(a) for a in (q, k, v)],
                              causal=True, scale=0.2)
    _close(got, want)
