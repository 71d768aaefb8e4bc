"""The port's tensor-parallel ``KVDecoder(mesh=)`` against the JAX
package's, on the CPU.

``tests/test_decode.py:128-150`` on a 2-way ``model`` mesh: the port's
side in a gloo world of 2 processes (``tests/torch_mesh_worlds.py``),
the JAX side the reference's decoder over 2 of the virtual CPU devices,
both from the same numpy-seeded weights and tokens.  Then the refusals,
whose texts are the reference's: a head count or an FFN width the
``model`` axis does not divide, int8 together with a mesh, a mesh that
is not one, and ``PagedSlots`` over a tensor-parallel decoder.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.models.decode import KVDecoder as JDecoder
from mxnet_tpu.serving.paged_kv import PagedSlots as JPagedSlots

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models.decode import KVDecoder as TDecoder
from mxnet_tpu_torch.parallel import mesh as tmesh

import torch_mesh_worlds as worlds

L, H, D, T, V = 2, 2, 32, 12, 17
PREFIX = 3
# the reference's own tolerance for its TP decoder against the dense one
ATOL = 2e-5


def _bound_params():
    """``tests/test_decode.py``'s ``_bound_model``: every parameter drawn
    from N(0, 0.08) in bind order from one RandomState, then the
    tokens from the same state."""
    net = jmodels.transformer.transformer_lm(
        num_layers=L, num_heads=H, d_model=D, seq_len=T, vocab_size=V)
    ex = net.simple_bind(ctx=mx.cpu(), grad_req="null",
                         data=(2, T), softmax_label=(2, T))
    rs = np.random.RandomState(0)
    params = {}
    for name, arr in ex.arg_dict.items():
        if name in ("data", "softmax_label"):
            continue
        params[name] = rs.normal(0, 0.08, arr.shape).astype(np.float32)
    return params, rs.randint(0, V, (2, 8))


def _jmesh(n):
    return JMesh(np.array(jax.devices("cpu")[:n]), ("model",))


@pytest.fixture(scope="module")
def runs():
    params, tokens = _bound_params()
    jtp = JDecoder(params, num_layers=L, num_heads=H, max_len=T,
                   mesh=_jmesh(2))
    _, full = jtp.prefill(tokens)
    st, lt = jtp.prefill(tokens[:, :PREFIX])
    steps = [np.asarray(lt)]
    for t in range(PREFIX, tokens.shape[1]):
        st, lt = jtp.step(st, tokens[:, t])
        steps.append(np.asarray(lt))
    jax_run = {"prefill": np.asarray(full), "steps": steps,
               "spec": str(st[0].sharding.spec),
               "generate": jtp.generate(tokens[:, :PREFIX], 6,
                                        temperature=0)}
    try:
        JPagedSlots(jtp, num_slots=2)
        jax_run["paged_refusal"] = None
    except Exception as exc:  # noqa: BLE001 — the text is compared
        jax_run["paged_refusal"] = str(exc)
    port = worlds.run_world(2, "decode_scenarios", params, L, H, T, tokens,
                            PREFIX)
    dense = TDecoder(params, num_layers=L, num_heads=H, max_len=T,
                     device="cpu")
    return {"jax": jax_run, "port": port, "params": params,
            "dense_bytes": dense.weight_bytes()}


def test_tp_prefill_matches_jax(runs):
    np.testing.assert_allclose(runs["port"]["prefill"], runs["jax"]["prefill"],
                               atol=ATOL)


def test_tp_steps_match_jax(runs):
    """A 3-token prefill, then step by step to 8 tokens."""
    got, want = runs["port"]["steps"], runs["jax"]["steps"]
    assert len(got) == len(want) == 8 - PREFIX + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_tp_greedy_tokens_equal_jax(runs):
    np.testing.assert_array_equal(runs["port"]["generate"],
                                  runs["jax"]["generate"])
    np.testing.assert_array_equal(runs["port"]["generate_scan"],
                                  runs["jax"]["generate"])


def test_tp_cache_is_split_on_heads(runs):
    """The cache is a DTensor split on its head axis, and each rank holds
    (and allocated) its own heads only; the weights each rank holds are
    its blocks."""
    port = runs["port"]
    assert "model" in runs["jax"]["spec"]
    assert port["placements"] == "(Shard(dim=2),)"
    assert port["cache_shape"] == (L, 2, H, T, D // H)
    assert port["local_cache_shape"] == (L, 2, H // 2, T, D // H)
    assert port["weight_bytes"] < runs["dense_bytes"]


def test_paged_slots_refuse_a_tp_decoder(runs):
    assert runs["port"]["paged_refusal"] == runs["jax"]["paged_refusal"]
    assert "tensor-parallel mesh" in runs["port"]["paged_refusal"]


def _refusal(make):
    with pytest.raises(Exception) as info:
        make()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", ["num_heads", "d_ff", "int8"])
def test_mesh_refusals_match_jax(case):
    """A ``model`` axis of 3 divides neither 2 heads nor the FFN width
    127; int8 with a 2-way mesh.  A port ``Mesh`` is built without a
    process group (the checks run before any is touched)."""
    params, _ = _bound_params()
    heads, kw, n = H, {}, 3
    if case == "d_ff":
        heads = 3
        params["layer0_ffn_in_weight"] = np.zeros((127, D), np.float32)
    if case == "int8":
        kw, n = {"quantize": "int8"}, 2
    tm = tmesh.Mesh(None, ("model",), np.arange(n), torch.device("cpu"))
    jerr = _refusal(lambda: JDecoder(params, num_layers=L, num_heads=heads,
                                     max_len=T, mesh=_jmesh(n), **kw))
    terr = _refusal(lambda: TDecoder(params, num_layers=L, num_heads=heads,
                                     max_len=T, mesh=tm, device="cpu",
                                     **kw))
    assert jerr[0] is ValueError
    assert terr == jerr


def test_a_mesh_that_is_not_one_is_refused():
    params, _ = _bound_params()
    with pytest.raises(MXNetError, match="mesh must be a parallel.mesh.Mesh"):
        TDecoder(params, num_layers=L, num_heads=H, max_len=T,
                 mesh=object(), device="cpu")
