"""The port's hand-written CUDA kernels against their plain versions, on
the card: paged decode attention, the flash-attention forward, dQ and
dK/dV kernels, and the residual epilogue (with its 4 launches per
ResNet-50 forward through the Predictor).

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the CPU tier has no card and no ``nvcc``).  The file imports
neither JAX nor ``mxnet_tpu``, so on a machine with the card it runs
without the JAX stack (skip the repo's JAX conftest):

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops import paged_attention as tpa
from mxnet_tpu_torch.ops import residual_epilogue as tre

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(card, dtype, B=4, H=4, M=8, block=16, dh=128, L=2, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    P = B * M + 1
    pk = torch.randn((P, L, H, block, dh), generator=g).to(card, dtype)
    pv = torch.randn((P, L, H, block, dh), generator=g).to(card, dtype)
    q = torch.randn((B, H, 1, dh), generator=g).to(card, dtype)
    bt = (torch.randperm(P - 1, generator=g)[:B * M] + 1).reshape(B, M)
    cursor = torch.tensor([0, block - 1, block, M * block - 1][:B])
    return (q, pk, pv, bt.to(card, torch.int32),
            cursor.to(card, torch.int32))


# fp32: the kernel sums in another order than cuBLAS (1e-5 covers it);
# bf16: both accumulate in fp32 and round once, in another order, so a
# value near a rounding boundary parts by one bf16 ulp (at most 2^-7 of
# it): 4e-3 + 4e-3 relative holds that below magnitude 2, where these
# softmax averages of unit-normal rows lie
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-3)])
def test_kernel_matches_plain(card, dtype, tol):
    args = _case(card, dtype)
    for layer in range(2):
        n0 = tpa.launch_count()
        got = tpa.paged_attention(*args, layer, block=16)
        torch.cuda.synchronize()
        assert tpa.launch_count() == n0 + 1
        ref = tpa._gather_attention(*args, layer, 16)
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


def test_kernel_rejects_unsupported_shapes(card):
    q, pk, pv, bt, cursor = _case(card, torch.float16, dh=64)
    with pytest.raises(Exception, match="does not support"):
        tpa.paged_attention(q, pk, pv, bt, cursor, 0, block=16)


# ------------------------------------------------------ flash attention
# fp32: the kernels sum in another order than the plain version's cuBLAS
# products (TF32 off): forward outputs are weighted means of unit-normal
# rows (order 1, 1e-5 holds ~100 ulps); dQ/dK/dV sum up to T products of
# order 1-10 and may cancel, so 1e-4 of the larger of value and 1.
# bf16: both sides widen the same bf16 inputs, work in fp32 and round
# once, so they part by one bf16 ulp where a value sits near a rounding
# boundary: 1e-2 absolute and relative is about 2.5 ulps at magnitude 1.
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _flash_case(card, dtype, B=2, H=3, T=200, D=64, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn((B, H, T, D), generator=g).to(card, dtype)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D", [(200, 64), (256, 128), (64, 8)])
def test_flash_kernels_match_plain(card, dtype, causal, T, D):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _flash_case(card, dtype, T=T, D=D)
    scale = 1.0 / D ** 0.5
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    n0 = tfa.launch_counts()
    o, lse = tfa._cuda_fwd(q, k, v, scale, causal)
    po, plse = tfa.fwd_plain(q, k, v, scale, causal)
    torch.testing.assert_close(o.float(), po.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
    delta = (po.float() * do.float()).sum(-1)
    args = (q, k, v, do, plse, delta, scale, causal)
    got = (tfa._cuda_dq(*args),) + tfa._cuda_dkv(*args)
    want = (tfa.dq_plain(*args),) + tfa.dkv_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=bwd_tol,
                                   rtol=bwd_tol, msg=name)
    n1 = tfa.launch_counts()
    assert {k_: n1[k_] - n0[k_] for k_ in n1} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_flash_autograd_on_card_matches_plain(card):
    q, k, v, do = _flash_case(card, torch.float32, T=128, D=32, seed=1)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*ins, True, None, 64, 64)
    out.backward(do)
    po, plse = tfa.fwd_plain(q, k, v, 32 ** -0.5, True)
    delta = (po * do).sum(-1)
    args = (q, k, v, do, plse, delta, 32 ** -0.5, True)
    want = (tfa.dq_plain(*args),) + tfa.dkv_plain(*args)
    torch.testing.assert_close(out, po, atol=1e-5, rtol=1e-5)
    for x, w in zip(ins, want):
        torch.testing.assert_close(x.grad, w, atol=1e-4, rtol=1e-4)


def test_flash_kernels_reject_unsupported(card):
    q, k, v, _ = _flash_case(card, torch.float16, T=64, D=64)
    with pytest.raises(Exception, match="do not support"):
        tfa._cuda_fwd(q, k, v, 0.125, True)
    q, k, v, _ = _flash_case(card, torch.float32, T=64, D=256)
    with pytest.raises(Exception, match="do not support"):
        tfa._cuda_fwd(q, k, v, 0.0625, True)


# ------------------------------------------------------ residual epilogue
# the four tails of ResNet-50 at batch 32, 224x224, as NCHW shapes
EPILOGUE_SHAPES = [(32, 256, 56, 56), (32, 512, 28, 28), (32, 1024, 14, 14),
                   (32, 2048, 7, 7)]


def _epi_case(card, dtype, shape, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn(shape, generator=g).to(card, dtype).contiguous(
        memory_format=cl)
    s = torch.randn(shape, generator=g).to(card, dtype).contiguous(
        memory_format=cl)
    c = shape[1]
    scale = (torch.rand((c,), generator=g) + 0.5).to(card)
    bias = (torch.rand((c,), generator=g) - 0.5).to(card)
    return x, s, scale, bias


def _epi_tolerance(x, s, scale, ref):
    """Per-element bound on |kernel - plain|.  fp32: the same operations
    in the same order (bit-identical; one ulp allowed).  bf16: the plain
    version rounds x + s to bf16 before the affine (2^-8 relative, times
    the scale) and each side rounds its output once (2^-8 relative
    each, 2^-7 together)."""
    sc = scale.reshape(1, -1, 1, 1)
    if x.dtype == torch.float32:
        return 2.0 ** -23 * ref.abs()
    t = x.float() + s.float()
    return 2.0 ** -8 * (t * sc).abs() + 2.0 ** -7 * ref.float().abs()


@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_kernel_matches_plain(card, dtype, shape):
    x, s, scale, bias = _epi_case(card, dtype, shape)
    n0 = tre.launch_count()
    got = tre.residual_epilogue(x, s, scale, bias, channel_axis=1)
    torch.cuda.synchronize()
    assert tre.launch_count() == n0 + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = tre._plain_fwd(x, s, scale, bias, 1)
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= _epi_tolerance(x, s, scale, ref)).all()), \
        float(diff.max())


def test_epilogue_kernel_refusals(card):
    x, s, scale, bias = _epi_case(card, torch.float32, (2, 256, 4, 4))
    with pytest.raises(MXNetError, match="not on a CUDA device"):
        tre.residual_epilogue(x.cpu(), s.cpu(), scale.cpu(), bias.cpu(),
                              channel_axis=1, impl="cuda")
    with pytest.raises(MXNetError, match=r"dense \(rows, C\) view"):
        tre.residual_epilogue(x.contiguous(), s.contiguous(), scale, bias,
                              channel_axis=1, impl="cuda")
    with pytest.raises(MXNetError, match="must match"):
        tre.residual_epilogue(x, s.to(torch.bfloat16), scale, bias,
                              channel_axis=1, impl="cuda")
    h, hs, _, _ = _epi_case(card, torch.float16, (2, 256, 4, 4))
    with pytest.raises(MXNetError, match="dtype"):
        tre.residual_epilogue(h, hs, scale, bias, channel_axis=1,
                              impl="cuda")
    r, rs, rsc, rb = _epi_case(card, torch.float32, (2, 100, 4, 4))
    with pytest.raises(MXNetError, match="does not support"):
        tre.residual_epilogue(r, rs, rsc, rb, channel_axis=1, impl="cuda")
    # the reference's gate: no channels-last view takes the plain version
    n0 = tre.launch_count()
    out = tre.residual_epilogue(x.contiguous(), s.contiguous(), scale, bias,
                                channel_axis=1)
    assert tre.launch_count() == n0
    torch.testing.assert_close(out, tre._plain_fwd(x, s, scale, bias, 1))


def test_epilogue_autograd_on_card_matches_plain(card):
    x, s, scale, bias = _epi_case(card, torch.float32, (2, 256, 4, 4), 3)
    cot = torch.randn(x.shape, device=card)
    grads = []
    for impl in ("cuda", "lax"):
        ins = [t.clone().requires_grad_(True) for t in (x, s, scale, bias)]
        out = tre.residual_epilogue(*ins, channel_axis=1, impl=impl)
        out.backward(cot)
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_predictor_launches_the_epilogue_four_times(card, monkeypatch):
    import numpy as np

    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.predict import Predictor

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shape = (2, 3, 64, 64)
    net = resnet.get_symbol(10, 50, shape[1:])
    arg, aux = resnet.random_params(net, seed=0, data=shape)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)

    def run(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        p = Predictor(symbol=net, arg_params=arg, aux_params=aux,
                      input_shapes={"data": shape})
        n0 = tre.launch_count()
        p.forward(data=x)
        out = p.get_output(0)
        for k in env:
            monkeypatch.delenv(k)
        return out, tre.launch_count() - n0

    got, n = run({})
    assert n == 4
    ref, n_off = run({"MXTPU_GRAPH_PASSES": "0"})
    assert n_off == 0
    nchw, n_nchw = run({"MXTPU_CONV_LAYOUT": "NCHW"})
    assert n_nchw == 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, nchw, rtol=1e-4, atol=1e-6)


def test_predictor_uploads_each_batch_through_the_staging_buffer(card):
    """Back-to-back forwards of different host batches, no copy-out in
    between: each must see its own batch, not a later one written into
    the pinned staging buffer while an upload was still reading it."""
    import numpy as np

    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.predict import Predictor

    shape = (2, 3, 32, 32)
    net = resnet.get_symbol(10, 18, shape[1:])
    arg, aux = resnet.random_params(net, seed=1, data=shape)
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    p = Predictor(symbol=net, arg_params=arg, aux_params=aux,
                  input_shapes={"data": shape})
    want = []
    for x in xs:
        p.forward(data=x)
        want.append(p.get_output(0))
    outs = []
    for x in xs:
        p.forward(data=x)
        outs.append(p._outs[0].clone())
    for got, w in zip(outs, want):
        np.testing.assert_array_equal(got.cpu().numpy(), w)
