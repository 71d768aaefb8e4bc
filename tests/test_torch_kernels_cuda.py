"""The port's hand-written CUDA kernels against their plain versions, on
the card: paged decode attention, and the flash-attention forward, dQ and
dK/dV kernels.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the CPU tier has no card and no ``nvcc``).  The file imports
neither JAX nor ``mxnet_tpu``, so on a machine with the card it runs
without the JAX stack (skip the repo's JAX conftest):

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops import paged_attention as tpa

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
