"""int8 weights in the port against the JAX package, on the CPU.

``mxnet_tpu_torch.serving.quantize`` and ``mxnet_tpu.serving.quantize``
quantize the same numpy weights to bit-equal ``q`` and ``scale`` (fp32
weights, bf16-rounded weights, all-zero rows); ``prepare_inference_params``
folds before it quantizes in both; ``KVDecoder(quantize="int8")`` casts
to the compute dtype first and then quantizes, and its logits agree with
the JAX int8 decoder's to 1e-4 in fp32 (both dequantize the same int8
weights in fp32: the remaining difference is the two libraries' fp32
sums, ~1e-7 on logits of order 1) with equal greedy tokens; int8 paged
serving equals int8 contiguous serving.  Checkpoint of the reference
fixtures: 2 layers, 2 heads, d_model 64, vocab 256, max_len 128.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu import symbol as jsym
from mxnet_tpu.models.decode import KVDecoder as JaxDecoder
from mxnet_tpu.serving import quantize as jq

from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.models.decode import KVDecoder
from mxnet_tpu_torch.serving import SlotScheduler
from mxnet_tpu_torch.serving import quantize as tq

L, H, D, T, V = 2, 2, 64, 128, 256
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def lm_params():
    net = jmodels.transformer.transformer_lm(
        num_layers=L, num_heads=H, d_model=D, seq_len=T, vocab_size=V)
    ex = net.simple_bind(ctx=jmx.cpu(), grad_req="null",
                         data=(1, T), softmax_label=(1, T))
    rs = np.random.RandomState(0)
    return {name: rs.normal(0, 0.08, arr.shape).astype(np.float32)
            for name, arr in ex.arg_dict.items()
            if name not in ("data", "softmax_label")}


@pytest.fixture(scope="module")
def decoders(lm_params):
    jd = JaxDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                    quantize="int8")
    td = KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                   quantize="int8", device="cpu")
    return jd, td


# ------------------------------------------------------------ the scheme
@pytest.mark.parametrize("kind", ["fp32", "bf16_rounded", "zero_rows", "4d"])
def test_quantize_per_channel_is_bit_equal(kind):
    rs = np.random.RandomState(3)
    w = rs.normal(0, 0.5, (16, 24)).astype(np.float32)
    if kind == "bf16_rounded":
        w = torch.from_numpy(w).bfloat16().float().numpy()
    elif kind == "zero_rows":
        w[[0, 5, 15]] = 0.0
    elif kind == "4d":
        w = rs.normal(0, 0.5, (8, 3, 3, 3)).astype(np.float32)
    tqv, tsv = tq.quantize_per_channel(w)
    jqv, jsv = jq.quantize_per_channel(w)
    assert tqv.dtype == np.int8 and tsv.dtype == np.float32
    np.testing.assert_array_equal(tqv, jqv)
    np.testing.assert_array_equal(tsv, jsv)
    if kind == "zero_rows":
        assert (tsv[[0, 5, 15]] == 1.0).all() and (tqv[[0, 5, 15]] == 0).all()
    assert np.abs(tqv).max() <= 127


def test_quantize_params_filter_and_dequantize(lm_params):
    """The same weights are picked (``*weight``, float, 2-D or 4-D);
    biases, norms and ``pos_embed`` pass through; ``dequantize`` and
    ``rows`` give the JAX package's dequantized values."""
    tp = tq.quantize_params(lm_params, device="cpu")
    jp = jq.quantize_params(lm_params)
    tq_names = sorted(k for k, v in tp.items()
                      if isinstance(v, tq.QuantizedTensor))
    jq_names = sorted(k for k, v in jp.items()
                      if isinstance(v, jq.QuantizedTensor))
    assert tq_names == jq_names
    assert "pos_embed" not in tq_names and "lm_head_weight" in tq_names
    for k in tq_names:
        np.testing.assert_array_equal(tp[k].q.numpy(), np.asarray(jp[k].q))
        np.testing.assert_array_equal(tp[k].scale.numpy(),
                                      np.asarray(jp[k].scale))
        np.testing.assert_array_equal(tp[k].dequantize().numpy(),
                                      np.asarray(jp[k].dequantize()))
        assert tp[k].nbytes == jp[k].nbytes
    emb = tp["tok_embed_weight"]
    idx = torch.tensor([[3, 0, 255], [7, 7, 1]])
    np.testing.assert_array_equal(emb.rows(idx).numpy(),
                                  emb.dequantize()[idx].numpy())
    host = tq.quantize_params(lm_params, device_put=False)
    assert isinstance(host["lm_head_weight"].q, np.ndarray)


def test_prepare_inference_params_folds_before_quantizing():
    """Conv+BN fold, then int8: the scales are those of the FOLDED conv
    weight, in both packages."""
    rs = np.random.RandomState(1)

    def net(s):
        c = s.Convolution(s.Variable("data"), num_filter=4, kernel=(3, 3),
                          name="conv0")
        return s.BatchNorm(c, fix_gamma=False, name="bn0")

    arg = {"conv0_weight": rs.normal(0, 0.3, (4, 2, 3, 3)),
           "conv0_bias": rs.normal(0, 0.1, 4),
           "bn0_gamma": rs.uniform(0.2, 3.0, 4),
           "bn0_beta": rs.uniform(-0.1, 0.1, 4)}
    aux = {"bn0_moving_mean": rs.uniform(-0.1, 0.1, 4),
           "bn0_moving_var": rs.uniform(0.5, 1.5, 4)}
    arg = {k: v.astype(np.float32) for k, v in arg.items()}
    aux = {k: v.astype(np.float32) for k, v in aux.items()}
    tsy, tp, _, tn = tq.prepare_inference_params(
        net(tsym), dict(arg), dict(aux), device="cpu")
    jsy, jp, _, jn = jq.prepare_inference_params(
        net(jsym), {k: jmx.nd.array(v) for k, v in arg.items()},
        {k: jmx.nd.array(v) for k, v in aux.items()})
    assert tn == jn == 1
    assert tsy.list_outputs() == jsy.list_outputs()
    np.testing.assert_array_equal(tp["conv0_weight"].q.numpy(),
                                  np.asarray(jp["conv0_weight"].q))
    np.testing.assert_array_equal(tp["conv0_weight"].scale.numpy(),
                                  np.asarray(jp["conv0_weight"].scale))
    plain = tq.quantize_per_channel(arg["conv0_weight"])[1]
    assert not np.array_equal(tp["conv0_weight"].scale.numpy(), plain)
    _, fp, _, _ = tq.prepare_inference_params(
        net(tsym), dict(arg), dict(aux), quantize=None)
    assert not isinstance(fp["conv0_weight"], tq.QuantizedTensor)


# -------------------------------------------------------------- decoding
def test_int8_decoder_logits_and_tokens_match_jax(decoders):
    jd, td = decoders
    assert td.quantize == "int8" and td.vocab == V and td.d_model == D
    rs = np.random.RandomState(2)
    prompt = rs.randint(0, V, (2, 9))
    (jst, jl), (tst, tl) = jd.prefill(prompt), td.prefill(prompt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    for t in range(3):
        tok = rs.randint(0, V, 2)
        jst, jl = jd.step(jst, tok)
        tst, tl = td.step(tst, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
    np.testing.assert_array_equal(
        td.generate(prompt, 12, temperature=0),
        jd.generate(prompt, 12, temperature=0))


def test_int8_decoder_quantizes_after_the_cast(lm_params):
    """bf16: the params are rounded to bf16 first and the scales are
    taken from the rounded weights (the JAX decoder's order); the device
    holds int8 payloads, under 0.6 of the bf16 decoder's weight bytes.

    The JAX decoder means to do the same but quantizes nothing in bf16:
    its filter reads ``np.dtype(bfloat16).kind``, which is ``"V"`` for
    ml_dtypes' bfloat16, not ``"f"``, so every weight stays bf16 (a
    fault of the reference, pinned here).  The port's q and scale are
    held against the JAX package's ``quantize_per_channel`` of the
    bf16-rounded weights instead."""
    td = KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                   dtype="bfloat16", quantize="int8", device="cpu")
    jd = JaxDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                    dtype=jnp.bfloat16, quantize="int8")
    assert not any(isinstance(v, jq.QuantizedTensor)
                   for v in dict.values(jd.p))
    for k in ("layer0_q_weight", "lm_head_weight", "tok_embed_weight"):
        t = dict.__getitem__(td.p, k)
        rounded = torch.from_numpy(lm_params[k]).bfloat16().float().numpy()
        jqv, jsv = jq.quantize_per_channel(rounded)
        np.testing.assert_array_equal(t.q.numpy(), jqv)
        np.testing.assert_array_equal(t.scale.numpy(), jsv)
        assert t.dtype == torch.bfloat16
    assert td._cache_dtype == torch.bfloat16
    bf16 = KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                     dtype="bfloat16", device="cpu")
    assert td.weight_bytes() < 0.6 * bf16.weight_bytes()
    prompt = np.arange(1, 10)[None]
    np.testing.assert_array_equal(td.generate_scan(prompt, 6),
                                  td.generate(prompt, 6, temperature=0))


def test_from_jax_params_carries_a_quantized_dict(lm_params, decoders):
    """The JAX package's ``quantize_params`` output crosses as it is: the
    port's decoder gets the same int8 payload (no requantizing) and the
    same logits as one that quantized for itself."""
    jp = jq.quantize_params(lm_params)
    carried = from_jax_params(jp, device="cpu")
    assert isinstance(carried["lm_head_weight"], tq.QuantizedTensor)
    np.testing.assert_array_equal(carried["lm_head_weight"].q.numpy(),
                                  np.asarray(jp["lm_head_weight"].q))
    td2 = KVDecoder(jp, num_layers=L, num_heads=H, max_len=T, device="cpu")
    prompt = np.arange(1, 8)[None]
    np.testing.assert_array_equal(td2.prefill(prompt)[1].numpy(),
                                  decoders[1].prefill(prompt)[1].numpy())


def test_paged_composes_with_int8(decoders):
    """``tests/test_serving_fleet.py::test_paged_composes_with_int8``:
    int8 weights decode through the paged programs, token-equal to the
    contiguous slot pool on a block-aligned prompt, and to the JAX int8
    decoder's greedy tokens."""
    jd, td = decoders
    prompt = np.arange(1, 9)
    runs = []
    for paged in (False, True):
        sched = SlotScheduler(td, num_slots=2, queue_size=4, paged=paged,
                              kv_block=8)
        try:
            req = sched.generate(prompt, max_new_tokens=5, timeout=120)
            assert req.outcome == "ok"
            runs.append(list(req.tokens))
        finally:
            sched.close()
    assert runs[0] == runs[1]
    assert runs[0] == jd.generate(prompt[None], 5, temperature=0)[0].tolist()


def test_quantize_refusals(lm_params):
    with pytest.raises(ValueError, match="unknown quantize mode"):
        KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                  quantize="int4", device="cpu")
