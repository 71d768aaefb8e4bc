"""The PyTorch port's decoder and paged KV cache against the JAX package.

The same numpy-seeded parameters go through ``mxnet_tpu.models.decode.
KVDecoder`` and ``mxnet_tpu_torch.models.decode.KVDecoder`` on the CPU,
in fp32; logits must agree to 1e-4 (fp32 sums in another order over a
2-layer model stay around 1e-6; 1e-4 leaves room without hiding a wrong
mask, scale or activation, each of which moves logits by > 1e-2).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models
from mxnet_tpu.models.decode import KVDecoder as JaxDecoder
from mxnet_tpu.serving.paged_kv import PagedSlots as JaxPagedSlots

from mxnet_tpu_torch import MXNetError, context
from mxnet_tpu_torch.models import transformer as ttr
from mxnet_tpu_torch.models.decode import KVDecoder, _gelu, _snap
from mxnet_tpu_torch.serving.paged_kv import PagedSlots

L, H, D, T, V = 2, 2, 32, 32, 17
ATOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _bind_params(num_layers, num_heads, d_model, seq_len, vocab, seed=0,
                 scale=0.08):
    net = models.transformer.transformer_lm(
        num_layers=num_layers, num_heads=num_heads, d_model=d_model,
        seq_len=seq_len, vocab_size=vocab)
    ex = net.simple_bind(ctx=mx.cpu(), grad_req="null",
                         data=(1, seq_len), softmax_label=(1, seq_len))
    rs = np.random.RandomState(seed)
    params = {}
    for name, arr in ex.arg_dict.items():
        if name in ("data", "softmax_label"):
            continue
        arr[:] = rs.normal(0, scale, arr.shape).astype(np.float32)
        params[name] = arr
    return params


@pytest.fixture(scope="module")
def lm_params():
    return _bind_params(L, H, D, T, V)


@pytest.fixture(scope="module")
def jdec(lm_params):
    return JaxDecoder(lm_params, num_layers=L, num_heads=H, max_len=T)


@pytest.fixture(scope="module")
def tdec(lm_params):
    return KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                     device="cpu")


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("cfg", [
    dict(num_layers=2, num_heads=2, d_model=32, d_ff=None, vocab_size=17,
         seq_len=32, max_len=None),
    dict(num_layers=3, num_heads=4, d_model=64, d_ff=96, vocab_size=97,
         seq_len=16, max_len=48),
])
def test_lm_param_shapes_match_simple_bind(cfg):
    net = models.transformer.transformer_lm(**cfg)
    T_ = cfg["seq_len"]
    ex = net.simple_bind(ctx=mx.cpu(), grad_req="null", data=(1, T_),
                         softmax_label=(1, T_))
    want = {k: tuple(v.shape) for k, v in ex.arg_dict.items()
            if k not in ("data", "softmax_label")}
    got = ttr.lm_param_shapes(
        cfg["num_layers"], cfg["num_heads"], cfg["d_model"],
        cfg["d_ff"] or 4 * cfg["d_model"], cfg["vocab_size"],
        cfg["max_len"] or T_)
    assert {k: tuple(v) for k, v in got.items()} == want


def test_headline_config_matches_reference():
    assert ttr.MFU_HEADLINE_CONFIG == models.transformer.MFU_HEADLINE_CONFIG


def test_random_params_seeded_and_shaped():
    shapes = ttr.lm_param_shapes(2, 2, 16, 32, 11, 8)
    a = ttr.lm_random_params(shapes, seed=3, std=0.02)
    b = ttr.lm_random_params(shapes, seed=3, std=0.02)
    assert list(a) == list(shapes)
    for k in shapes:
        assert a[k].shape == tuple(shapes[k]) and a[k].dtype == np.float32
        assert np.array_equal(a[k], b[k])
    assert np.all(a["layer0_ln1_gamma"] == 1)
    assert np.all(a["layer1_q_bias"] == 0)
    assert 0.015 < a["tok_embed_weight"].std() < 0.025


def test_weight_carry_from_ndarrays(lm_params):
    from mxnet_tpu_torch.convert import from_jax_params

    t32 = from_jax_params(lm_params, "float32", "cpu")
    t16 = from_jax_params(lm_params, torch.bfloat16, "cpu")
    for k, v in lm_params.items():
        ref = v.asnumpy()
        assert np.array_equal(t32[k].numpy(), ref)
        assert t16[k].dtype == torch.bfloat16
        np.testing.assert_allclose(t16[k].float().numpy(), ref,
                                   rtol=2 ** -8, atol=0)


# ------------------------------------------------------- decoder parity
def test_prefill_and_step_match_jax(jdec, tdec):
    rs = np.random.RandomState(1)
    prompt = rs.randint(0, V, (2, 5))
    js, jl = jdec.prefill(prompt)
    ts, tl = tdec.prefill(prompt)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
    for _ in range(4):
        tok = rs.randint(0, V, 2)
        js, jl = jdec.step(js, tok)
        ts, tl = tdec.step(ts, tok)
        assert ts[2] == js[2]
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)


def test_generate_greedy_matches_jax(jdec, tdec):
    prompt = np.random.RandomState(2).randint(0, V, (1, 6))
    assert np.array_equal(tdec.generate(prompt, 8, temperature=0),
                          jdec.generate(prompt, 8, temperature=0))


def test_prefill_padded_matches_jax(jdec, tdec):
    rs = np.random.RandomState(3)
    tokens = rs.randint(0, V, (3, 16))
    lengths = [16, 9, 3]
    (jk, jv), jl = jdec.prefill_padded(tokens, lengths)
    (tk, tv), tl = tdec.prefill_padded(tokens, lengths)
    np.testing.assert_allclose(_np(tl[:, -1]), _np(jl[:, -1]), atol=ATOL,
                               rtol=0)
    # the caches hold the same K/V for every real position
    for b, n in enumerate(lengths):
        sl = slice(16 - n, 16)
        np.testing.assert_allclose(_np(tk[:, b, :, sl]),
                                   _np(jk[:, b, :, sl]), atol=ATOL, rtol=0)


def test_step_slots_and_adopt_row_match_jax(jdec, tdec):
    """Admit three ragged prompts one by one (prefill_padded at B=1 +
    adopt_row), then tick the pool with per-slot windows — the
    contiguous scheduler's life cycle."""
    rs = np.random.RandomState(4)
    jcache = jdec.init_slot_state(3)
    tcache = tdec.init_slot_state(3)
    start = np.zeros(3, np.int32)
    cursor = np.zeros(3, np.int32)
    tokens = np.zeros(3, np.int64)
    for slot, n in enumerate((5, 8, 2)):
        padded = np.zeros((1, 8), np.int64)
        padded[0, 8 - n:] = rs.randint(0, V, n)
        jrow, jl = jdec.prefill_padded(padded, [n])
        trow, tl = tdec.prefill_padded(padded, [n])
        np.testing.assert_allclose(_np(tl[0, -1]), _np(jl[0, -1]),
                                   atol=ATOL, rtol=0)
        jcache = jdec.adopt_row(jcache, jrow, slot)
        tcache = tdec.adopt_row(tcache, trow, slot)
        start[slot], cursor[slot] = 8 - n, 8
        tokens[slot] = int(_np(jl[0, -1]).argmax())
    for _ in range(5):
        jcache, jl = jdec.step_slots(jcache, tokens, start, cursor)
        tcache, tl = tdec.step_slots(tcache, tokens, start, cursor)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
        tokens = _np(jl).argmax(-1)
        cursor += 1


def test_gelu_is_the_tanh_form():
    import jax

    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), atol=1e-6)


def test_snap_never_aliases_host_state():
    host = np.arange(6, dtype=np.int32)
    t = _snap(host, torch.device("cpu"))
    host += 100
    assert t.tolist() == list(range(6))
    assert t.dtype == torch.int32


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()}, {"quantize": "int8", "mesh": object()},
])
def test_unported_decoder_options_raise(lm_params, kwargs):
    """``mesh=`` takes a ``parallel.mesh.Mesh`` and refuses anything else
    by name; int8 with a mesh is the reference's own ``ValueError``."""
    exc, match = ((ValueError, "tensor-parallel mesh")
                  if "quantize" in kwargs else
                  (MXNetError, "mesh must be a parallel.mesh.Mesh"))
    with pytest.raises(exc, match=match):
        KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                  device="cpu", **kwargs)


@pytest.mark.parametrize("method", ["generate_scan", "beam_search"])
def test_unported_decoder_methods_raise(tdec, method):
    """Both are ported; each refuses a budget past ``max_len`` with the
    reference's ``ValueError``."""
    with pytest.raises(ValueError, match="exceeds max_len"):
        getattr(tdec, method)(np.zeros((1, 3), np.int64), T)


def test_default_device_without_cuda_raises(lm_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T)
    with pytest.raises(MXNetError):
        context.resolve_device(None)
    assert context.resolve_device("cpu") == torch.device("cpu")
    assert context.gpu(1) == torch.device("cuda", 1)


# ---------------------------------------------------------- paged cache
def _drive(pg, vocab, seed=5):
    """Prefill + ragged steps + a mid-flight fork admission against the
    shared prefix block + dual-slot steps — the paged life cycle of
    tests/test_autotune.py:_drive, returning every logits array."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, vocab, 8).astype(np.int64)     # one full block
    fa = np.concatenate([shared, rs.randint(0, vocab, 8)])
    fb = np.concatenate([shared, rs.randint(0, vocab, 3)])  # ragged tail
    outs = [_np(pg.admit(0, fa))]
    occ = np.array([True, False, False])
    tok = np.array([int(outs[-1].argmax()), 0, 0])
    for _ in range(4):
        lg, _ = pg.step(tok, occ)
        outs.append(_np(lg))
        tok = np.array([int(outs[-1][0].argmax()), 0, 0])
    outs.append(_np(pg.admit(1, fb)))
    occ = np.array([True, True, False])
    tok = np.array([tok[0], int(outs[-1].argmax()), 0])
    for _ in range(4):
        lg, _ = pg.step(tok, occ)
        outs.append(_np(lg))
        tok = np.array([int(outs[-1][0].argmax()),
                        int(outs[-1][1].argmax()), 0])
    return outs


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_paged_slots_match_jax_interpret_kernel(jdec, tdec, prefix_cache):
    """The port's paged backend through prefill, ragged steps and a fork
    behind the shared prefix block, against the JAX backend running its
    Pallas kernel in interpret mode — every emission."""
    buckets = (8, 16, 32)
    ref = _drive(JaxPagedSlots(jdec, 3, block=8, prefill_buckets=buckets,
                               prefix_cache=prefix_cache,
                               kernel="interpret"), V)
    pg = PagedSlots(tdec, 3, block=8, prefill_buckets=buckets,
                    prefix_cache=prefix_cache, kernel="auto")
    assert pg.kernel == "gather" and pg.stats()["kernel"] == "gather"
    outs = _drive(pg, V)
    assert len(outs) == len(ref)
    for i, (a, b) in enumerate(zip(ref, outs)):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0,
                                   err_msg="emission %d" % i)
    if prefix_cache:
        assert pg.stats()["prefix_pages"] >= 1


def test_paged_slots_wider_model_matches_jax():
    """A second shape: 4 heads of 16, vocab 97, block 16."""
    params = _bind_params(2, 4, 64, 32, 97, seed=7)
    jd = JaxDecoder(params, num_layers=2, num_heads=4, max_len=32)
    td = KVDecoder(params, num_layers=2, num_heads=4, max_len=32,
                   device="cpu")
    ref = _drive(JaxPagedSlots(jd, 3, block=16, prefill_buckets=(16, 32),
                               kernel="gather"), 97, seed=9)
    outs = _drive(PagedSlots(td, 3, block=16, prefill_buckets=(16, 32),
                             kernel="gather"), 97, seed=9)
    for a, b in zip(ref, outs):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


def test_prefill_pad_rows_write_nothing(tdec):
    """A 5-token prompt prefilled in an 8-token bucket writes exactly
    positions 0..4 of its one page: the 3 pad rows (which the JAX
    program scatters out of bounds) touch no page at all."""
    pg = PagedSlots(tdec, 2, block=8, prefill_buckets=(8, 16, 32),
                    kernel="gather")
    with torch.inference_mode():
        for t in pg.pool:
            t.fill_(7.0)
    before = [t.clone() for t in pg.pool]
    pg.admit(0, np.arange(1, 6))
    page = int(pg.bt[0, 0])
    assert page != 0
    for b, a in zip(before, pg.pool):
        changed = (b != a).reshape(b.shape[0], -1).any(-1)
        assert changed.nonzero().flatten().tolist() == [page]
        diff = (b[page] != a[page]).any(-1).any(1).any(0)   # (block,)
        assert diff.tolist() == [True] * 5 + [False] * 3


@pytest.mark.parametrize("mode", ["pallas", "interpret", "pagewalk"])
def test_unported_kernel_modes_raise(tdec, mode):
    """On a CPU pool ``pallas`` (the forced kernel) and ``interpret``
    (no CPU interpreter for a CUDA kernel) raise; ``pagewalk`` is
    ported and builds."""
    match = {"pallas": "needs a CUDA pool",
             "interpret": "no CPU interpreter"}.get(mode)
    if match is None:
        pg = PagedSlots(tdec, 2, block=8, prefill_buckets=(8,), kernel=mode)
        assert pg.kernel == mode
        return
    with pytest.raises(MXNetError, match=match):
        PagedSlots(tdec, 2, block=8, prefill_buckets=(8,), kernel=mode)


@pytest.mark.parametrize("block,patch,match", [
    (4, {}, "block=4"),                                  # block % 8
    (8, {"_cache_dtype": torch.float16}, "dtype=torch.float16"),
    (8, {"dh": 264}, "dh=264"),                          # dh > MAX_DH
    (8, {"MAX_CONTEXT": 16}, "MAX_CONTEXT"),             # max_len is 32
])
def test_auto_on_a_cuda_pool_the_kernel_cannot_take_raises(
        tdec, monkeypatch, block, patch, match):
    """``auto`` on a CUDA pool is the kernel or an error naming the
    limit, never a quiet switch to the gather path.  The decoder stays
    on the CPU; only its device type reads ``cuda`` (the kernel choice is
    made before the pool is allocated)."""
    from mxnet_tpu_torch.ops import paged_attention as tpa

    monkeypatch.setattr(tdec, "device", torch.device("cuda"))
    for name, value in patch.items():
        monkeypatch.setattr(tpa if name == "MAX_CONTEXT" else tdec, name,
                            value)
    with pytest.raises(MXNetError, match=match):
        PagedSlots(tdec, 2, block=block, prefill_buckets=(8,),
                   kernel="auto")


def test_kernel_mode_env(tdec, monkeypatch):
    monkeypatch.setenv("MXTPU_PAGED_KERNEL", "0")
    assert PagedSlots(tdec, 2, block=8, prefill_buckets=(8,)).kernel == \
        "gather"
    monkeypatch.setenv("MXTPU_PAGED_KERNEL", "auto")
    # auto on a CPU pool: the plain path (the kernel needs the card)
    assert PagedSlots(tdec, 2, block=8, prefill_buckets=(8,)).kernel == \
        "gather"
    monkeypatch.setenv("MXTPU_PAGED_KERNEL", "bogus")
    with pytest.raises(MXNetError, match="unknown"):
        PagedSlots(tdec, 2, block=8, prefill_buckets=(8,))
