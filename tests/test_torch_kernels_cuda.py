"""The port's hand-written CUDA kernels against their plain versions, on
the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the CPU tier has no card and no ``nvcc``).  The file imports
neither JAX nor ``mxnet_tpu``, so on a machine with the card it runs
without the JAX stack (skip the repo's JAX conftest):

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

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
