"""The port's hand-written CUDA kernels against their plain versions, on
the card: paged decode attention, the flash-attention forward, dQ and
dK/dV kernels, the residual epilogue (with its 4 launches per
ResNet-50 forward through the Predictor), user CUDA C through
``rtc.Rtc`` (NVRTC) against the plain twins of the kernels pushed, and
``FusedTrainer.step_multi``'s captured CUDA graph of the training step
against eager steps, the Module path (a Module step against
``FusedTrainer.step``, the bucketed kvstore update's launches,
``Module.score`` through the epilogue kernel), and mixed precision (the
bucketed update's skip-step under AMP loss scaling with no host sync,
``Cast`` of channels-last weights, the epilogue kernel in the AMP
graph), and the ops of ``ops/nn.py`` (each new op on the card against
the port on the CPU, the Dropout mask drawn from an explicit card
generator, and a draw on the card after a failed capture), and the LSTM
language model's path (``step_multi`` over a graph with Dropout, a
fresh mask per replay and the same sequence from the same seed; the
``RNN`` op on the card against the CPU), and the input pipeline's
staging (``DevicePrefetchIter`` and ``storage.stage_to_device`` under a
slow consumer, every staged batch equal to its host source; a pinned
buffer held until its copy's event completes; ``ImageRecordIter`` and
``MultiProcessImageRecordIter`` batches on the card equal to those on
the host, with decode workers that never touch CUDA), and the survival
and row-sparse slice (the row-sparse update on the card against the
CPU, with no host sync; a ``save_state`` taken while steps are queued
holding the post-step values; ``remat=True`` through the flash kernels
giving the plain step's gradients, its forward launched twice a step,
also under ``step_multi`` with Dropout), and the classic top-level
surface (a ``Custom`` op on card tensors against the CPU with one host
sync each way, ``cpu_pinned`` arrays in pinned memory, the profiler's
device trace naming the flash kernels), and the rest of decode serving
(an int8 decoder's paged step through the kernel against the gather
path; ``generate_scan`` on the card equal to ``generate`` with one read
of the device), and the plugins (a ``TorchModule`` and a
``TorchCriterion`` on card tensors with no host sync, the fused CUDA
dropout inside a module drawn from the op's card generator), and two
faults the port lint found (the paged decode step's uploads with no
host wait; ``step_multi`` over a ``Pad`` of edge or reflect mode), and
the device mesh (the LM step on a world-1 NCCL mesh through the flash
kernels on the rank's heads, equal to the step without a mesh, and with
no host sync, eager or captured).

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the CPU tier has no card and no ``nvcc``).  The file imports
neither JAX nor ``mxnet_tpu``, so on a machine with the card it runs
without the JAX stack (skip the repo's JAX conftest):

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import rtc
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


def _split_case(card, dtype, cursors, M, block, dh, H=2, L=2, seed=0):
    """A pool, table and query for ``cursors`` (one slot each) over a
    table of ``M`` pages of ``block`` positions."""
    B = len(cursors)
    g = torch.Generator(device="cpu").manual_seed(seed)
    P = B * M + 1
    pk = torch.randn((P, L, H, block, dh), generator=g).to(card, dtype)
    pv = torch.randn((P, L, H, block, dh), generator=g).to(card, dtype)
    q = torch.randn((B, H, 1, dh), generator=g).to(card, dtype)
    bt = (torch.randperm(P - 1, generator=g)[:B * M] + 1).reshape(B, M)
    return (q, pk, pv, bt.to(card, torch.int32),
            torch.tensor(cursors).to(card, torch.int32))


# the split across the sequence: cursors on and beside the chunk
# boundaries (the first chunk exactly full, one position into the
# second, ...), the last position of the table and a cursor past it
@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-3)])
def test_kernel_split_boundaries_match_plain(card, dtype, tol, dh, block):
    M = 512 // block
    chunk_pages, n_split = tpa.split_of(M, block)
    chunk = chunk_pages * block
    assert n_split > 2
    cursors = [0, chunk - 2, chunk - 1, chunk, 2 * chunk - 1, 2 * chunk + 1,
               M * block - 1, M * block + 5]
    args = _split_case(card, dtype, cursors, M, block, dh)
    for layer in range(2):
        got = tpa.paged_attention(*args, layer, block=block)
        ref = tpa._gather_attention(*args, layer, block)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-3)])
def test_kernel_at_max_context_matches_plain(card, dtype, tol):
    """One slot at the full MAX_CONTEXT (384 chunks of 128 positions) and
    one short slot in the same table."""
    block = 16
    M = tpa.MAX_CONTEXT // block
    args = _split_case(card, dtype, [tpa.MAX_CONTEXT - 1, 100], M, block,
                       128, H=2, L=1)
    got = tpa.paged_attention(*args, 0, block=block)
    ref = tpa._gather_attention(*args, 0, block)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(card, dtype):
    """The chunks are merged in a fixed order with no atomics: two calls
    on the same inputs give the same bits."""
    args = _split_case(card, dtype, [0, 15, 16, 17, 255, 511, 700, 1023],
                       64, 16, 128, H=16)
    first = tpa.paged_attention(*args, 1, block=16)
    second = tpa.paged_attention(*args, 1, block=16)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_rejects_a_pool_off_a_16_byte_boundary(card):
    """The kernel reads rows with 16-byte loads: a contiguous pool that
    starts 2 bytes into its storage is refused by name."""
    q, pk, pv, bt, cursor = _case(card, torch.bfloat16)
    shifted = torch.empty(pk.numel() + 1, dtype=pk.dtype, device=card)
    shifted = shifted[1:].view(pk.shape)
    shifted.copy_(pk)
    with pytest.raises(MXNetError, match="16-byte boundary"):
        tpa.paged_attention(q, shifted, pv, bt, cursor, 0, block=16)


def test_kernel_rejects_unsupported_shapes(card):
    q, pk, pv, bt, cursor = _case(card, torch.float16, dh=64)
    with pytest.raises(Exception, match="does not support"):
        tpa.paged_attention(q, pk, pv, bt, cursor, 0, block=16)


# ------------------------------------------------------ flash attention
# fp32: the kernels sum in another order than the plain version's cuBLAS
# products (TF32 off): forward outputs are weighted means of unit-normal
# rows (order 1, 1e-5 holds ~100 ulps); dQ/dK/dV sum up to T products of
# order 1-10 and may cancel, so 1e-4 of the larger of value and 1.
# bf16: both sides widen the same bf16 inputs and accumulate in fp32; the
# tensor-core forward and dK/dV also round P (and dS) to bf16 as the A
# operand of their products, 2^-9 relative per term.  Each element is
# held to 1e-2 absolute and relative (one output ulp is 2^-8 to 2^-7 of
# the value), which is loose where O, dK and dV are ~0.02-0.05; so each
# tile of 64 rows (64 queries' O, 64 keys' dK or dV, all D columns) is
# also held to FLASH_TILE_TOL of its norm.  A single row of D 8 is too
# few values for a norm to average the roundings; a tile is enough, and
# a dK/dV that leaves out one query tile reads 0.4-1 there.
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
FLASH_TILE_TOL = {torch.bfloat16: 1e-2}


def _tile_rel_err(got, ref, rows=64):
    """The largest ``||got - ref|| / ||ref||`` over the tiles of ``rows``
    consecutive rows (the last may be short) of ``(..., T, D)`` tensors."""
    ref = ref.float()
    pad = -ref.shape[-2] % rows

    def norms(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.reshape(*x.shape[:-2], -1, rows * x.shape[-1]).norm(dim=-1)

    return float((norms(got.float() - ref)
                  / norms(ref).clamp_min(1e-30)).max())


def _assert_flash_close(got, want, tol, dtype, what):
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol, msg=what)
    if dtype in FLASH_TILE_TOL:
        err = _tile_rel_err(got, want)
        assert err <= FLASH_TILE_TOL[dtype], (what, err)


def _flash_case(card, dtype, B=2, H=3, T=200, D=64, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn((B, H, T, D), generator=g).to(card, dtype)
            for _ in range(4)]


# (B, H, T, D): small cases, then T and D that disagree with the tensor
# cores' tiles (128 queries x 128 keys forward, 128 keys x 64 queries
# dK/dV, wgmma depth 16, 64-column swizzle rows) at B*H = 160, more than
# one wave of CTAs on the card's 132 SMs
FLASH_SHAPES = [(2, 3, 200, 64), (2, 3, 256, 128), (2, 3, 64, 8)] + [
    (4, 40, T, D) for T in (200, 1000, 1024) for D in (8, 64, 72, 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,D", FLASH_SHAPES)
def test_flash_kernels_match_plain(card, dtype, causal, B, H, T, D):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _flash_case(card, dtype, B=B, H=H, T=T, D=D)
    scale = 1.0 / D ** 0.5
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    n0 = tfa.launch_counts()
    o, lse = tfa._cuda_fwd(q, k, v, scale, causal)
    po, plse = tfa.fwd_plain(q, k, v, scale, causal)
    _assert_flash_close(o, po, fwd_tol, dtype, "o")
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
    delta = (po.float() * do.float()).sum(-1)
    args = (q, k, v, do, plse, delta, scale, causal)
    got = (tfa._cuda_dq(*args),) + tfa._cuda_dkv(*args)
    want = (tfa.dq_plain(*args),) + tfa.dkv_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_flash_close(a, b, bwd_tol, dtype, name)
    n1 = tfa.launch_counts()
    assert {k_: n1[k_] - n0[k_] for k_ in n1} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dkv_is_deterministic(card, dtype, kernel):
    """No atomics: each key tile sums its query tiles (and each query tile
    its key tiles, for dQ) in a fixed order, so two launches on the same
    inputs give the same bits."""
    q, k, v, do = _flash_case(card, dtype, B=4, H=40, T=1000, D=72, seed=3)
    o, lse = tfa._cuda_fwd(q, k, v, 72 ** -0.5, True)
    delta = (o.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, delta, 72 ** -0.5, True)
    launch = {"dkv": tfa._cuda_dkv,
              "dq": lambda *a: (tfa._cuda_dq(*a),)}[kernel]
    first = launch(*args)
    second = launch(*args)
    o2, lse2 = tfa._cuda_fwd(q, k, v, 72 ** -0.5, True)
    torch.cuda.synchronize()
    for a, b in zip(first + (o,), second + (o2,)):
        assert torch.equal(a, b)
    assert torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_card_matches_plain(card, dtype):
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    q, k, v, do = _flash_case(card, dtype, T=128, D=32, seed=1)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*ins, True, None, 64, 64)
    out.backward(do)
    po, plse = tfa.fwd_plain(q, k, v, 32 ** -0.5, True)
    delta = (po.float() * do.float()).sum(-1)
    args = (q, k, v, do, plse, delta, 32 ** -0.5, True)
    want = (tfa.dq_plain(*args),) + tfa.dkv_plain(*args)
    _assert_flash_close(out, po, fwd_tol, dtype, "o")
    for name, x, w in zip(("dq", "dk", "dv"), ins, want):
        assert x.grad.dtype == dtype
        _assert_flash_close(x.grad, w, bwd_tol, dtype, name)


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


# ------------------------------------------------------------------ rtc
# user kernels for rtc.Rtc (CUDA C bodies), each beside its plain twin
RTC_EXP = """
    __shared__ float s_rec[10];
    s_rec[threadIdx.x] = x[threadIdx.x];
    y[threadIdx.x] = expf(s_rec[threadIdx.x]*5.0);"""
RTC_AXPY = """
    const int n = x_dims[0];
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += blockDim.x * gridDim.x)
        out[i] = 2.0f * x[i] + y[i];"""
RTC_SOFTMAX = """
    __shared__ float red[256];
    const int cols = x_dims[1];
    const float* xr = x + (size_t)blockIdx.x * cols;
    float* yr = y + (size_t)blockIdx.x * cols;
    float m = __int_as_float(0xff800000);
    for (int c = threadIdx.x; c < cols; c += blockDim.x) m = fmaxf(m, xr[c]);
    red[threadIdx.x] = m;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s)
            red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
        __syncthreads();
    }
    m = red[0];
    __syncthreads();
    float sum = 0.0f;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        sum += expf(xr[c] - m);
    red[threadIdx.x] = sum;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    sum = red[0];
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        yr[c] = expf(xr[c] - m) / sum;"""
RTC_AXPY_BF16 = """
    const int n = x_dims[0];
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += blockDim.x * gridDim.x)
        out[i] = __float2bfloat16(2.0f * __bfloat162float(x[i])
                                  + __bfloat162float(y[i]));"""
RTC_INDEX = """
    const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                  + blockIdx.x;
    const int t = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x
                  + threadIdx.x;
    int* o = out + (b * blockDim.x * blockDim.y * blockDim.z + t) * 6;
    o[0] = blockIdx.x; o[1] = blockIdx.y; o[2] = blockIdx.z;
    o[3] = threadIdx.x; o[4] = threadIdx.y; o[5] = threadIdx.z;"""


def _rtc_exp_plain(x):
    return torch.exp(x * 5.0)


def _rtc_axpy_plain(x, y):
    return 2 * x + y


def _rtc_softmax_plain(x):
    e = torch.exp(x - x.max(1, keepdim=True).values)
    return e / e.sum(1, keepdim=True)


def _rtc_index_plain(grid, block):
    gx, gy, gz = grid
    bx, by, bz = block
    z, y, x, tz, ty, tx = torch.meshgrid(
        *[torch.arange(n, dtype=torch.int32) for n in (gz, gy, gx, bz, by,
                                                       bx)], indexing="ij")
    return torch.stack([x, y, z, tx, ty, tz], -1).reshape(-1, 6)


def _nd(t):
    return tnd.NDArray(t)


def test_rtc_mxnet_docstring_example(card):
    x = tnd.zeros((10,), ctx=card)
    x[:] = 1
    y = tnd.zeros((10,), ctx=card)
    y[:] = 2
    k = rtc.Rtc("abc", [("x", x)], [("y", y)], RTC_EXP)
    n0 = rtc.launch_count()
    k.push([x], [y], (1, 1, 1), (10, 1, 1))
    assert rtc.launch_count() == n0 + 1
    np.testing.assert_allclose(y.asnumpy(), np.exp(x.asnumpy() * 5.0),
                               rtol=1e-6)
    xs = torch.empty(10, device=card).uniform_(-1, 1)
    k.push([xs.cpu().numpy()], [y], (1, 1, 1), (10, 1, 1))   # host input
    torch.testing.assert_close(y.tensor, _rtc_exp_plain(xs), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 3])
def test_rtc_axpy_matches_plain_exactly(card, n):
    g = torch.Generator(device=card).manual_seed(n)
    x, y = (torch.randn(n, generator=g, device=card) for _ in range(2))
    out = torch.empty_like(x)
    k = rtc.Rtc("axpy", [("x", _nd(x)), ("y", _nd(y))], [("out", _nd(out))],
                RTC_AXPY)
    # fewer blocks than elements: the grid-stride loop covers the rest
    k.push([_nd(x), _nd(y)], [_nd(out)], (max(1, n // 1024), 1, 1),
           (256, 1, 1))
    torch.testing.assert_close(out, _rtc_axpy_plain(x, y), rtol=0, atol=0)


def test_rtc_row_softmax_matches_plain(card):
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn((32, 1000), generator=g, device=card) * 4
    y = torch.empty_like(x)
    k = rtc.Rtc("row_softmax", [("x", _nd(x))], [("y", _nd(y))],
                RTC_SOFTMAX)
    k.push([_nd(x)], [_nd(y)], (32, 1, 1), (256, 1, 1))
    torch.testing.assert_close(y, _rtc_softmax_plain(x), rtol=1e-6,
                               atol=1e-6)


def test_rtc_bf16_kernel_matches_plain(card):
    g = torch.Generator(device=card).manual_seed(8)
    x, y = (torch.randn(4099, generator=g, device=card).bfloat16()
            for _ in range(2))
    out = torch.empty_like(x)
    k = rtc.Rtc("axpy_bf16", [("x", _nd(x)), ("y", _nd(y))],
                [("out", _nd(out))], RTC_AXPY_BF16)
    assert k.source.startswith("#include <cuda_bf16.h>")
    k.push([_nd(x), _nd(y)], [_nd(out)], (17, 1, 1), (256, 1, 1))
    want = (2 * x.float() + y.float()).bfloat16()
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("grid,block", [((2, 3, 2), (4, 2, 3)),
                                        ((5, 1, 1), (32, 4, 1)),
                                        ((1, 2, 3), (1, 1, 64))])
def test_rtc_honours_grid_and_block_dims(card, grid, block):
    n = int(np.prod(grid)) * int(np.prod(block))
    out = torch.full((n, 6), -1, dtype=torch.int32, device=card)
    k = rtc.Rtc("where", [], [("out", _nd(out))], RTC_INDEX)
    k.push([], [_nd(out)], grid, block)
    torch.testing.assert_close(out.cpu(), _rtc_index_plain(grid, block),
                               rtol=0, atol=0)


def test_rtc_second_construction_makes_no_nvrtc_call(card):
    from mxnet_tpu_torch.ops import _nvrtc

    x = torch.zeros(321, device=card)
    args = ([("x", _nd(x)), ("y", _nd(x))], [("out", _nd(torch.empty_like(
        x)))], RTC_AXPY)
    first = rtc.Rtc("axpy_cached", *args)
    n0 = _nvrtc.compile_count()
    again = rtc.Rtc("axpy_cached", *args)
    assert _nvrtc.compile_count() == n0 and again.compile_ms is None
    assert again._fn.value == first._fn.value
    rtc.Rtc("axpy_cached", [("x", _nd(torch.zeros(322, device=card))),
                            ("y", _nd(x))], *args[1:])
    assert _nvrtc.compile_count() == n0 + 1       # other dims: new source


def test_rtc_bad_source_raises_with_the_nvrtc_log(card):
    x = torch.zeros(4, device=card)
    with pytest.raises(MXNetError, match="(?s)NVRTC failed.*undefined_thing"):
        rtc.Rtc("bad", [("x", _nd(x))], [("y", _nd(x.clone()))],
                "y[0] = undefined_thing(x[0]);")


def test_rtc_push_refusals(card):
    x = torch.zeros((4, 8), device=card)
    k = rtc.Rtc("copy2d", [("x", _nd(x))], [("y", _nd(torch.empty_like(x)))],
                "y[threadIdx.x] = x[threadIdx.x];")
    with pytest.raises(MXNetError, match=r"is \(8, 4\)"):
        k.push([_nd(torch.zeros((8, 4), device=card))], [_nd(x)], (1, 1, 1),
               (32, 1, 1))
    with pytest.raises(MXNetError, match="not contiguous"):
        k.push([_nd(x)], [_nd(torch.zeros((8, 4), device=card).t())],
               (1, 1, 1), (32, 1, 1))
    with pytest.raises(MXNetError, match="runs on a CUDA device"):
        k.push([tnd.zeros((4, 8), ctx="cpu")], [_nd(x)], (1, 1, 1),
               (32, 1, 1))
    with pytest.raises(MXNetError, match="no default"):
        k.push([_nd(x)], [_nd(x.clone())])
    with pytest.raises(MXNetError, match="exceed 1024"):
        k.push([_nd(x)], [_nd(x.clone())], (1, 1, 1), (64, 32, 1))
    n0 = rtc.launch_count()
    with pytest.raises(MXNetError, match="cuLaunchKernel failed"):
        k.push([_nd(x)], [_nd(x.clone())], (1, 70000, 1), (32, 1, 1))
    assert rtc.launch_count() == n0


def test_rtc_push_from_a_fresh_thread(card):
    """The driver needs a current context on the calling thread; a thread
    that never touched CUDA through torch has none until push sets it."""
    import threading

    g = torch.Generator(device=card).manual_seed(9)
    x, y = (torch.randn(5000, generator=g, device=card) for _ in range(2))
    out = torch.zeros_like(x)
    k = rtc.Rtc("axpy_thread", [("x", _nd(x)), ("y", _nd(y))],
                [("out", _nd(out))], RTC_AXPY)
    torch.cuda.synchronize()
    errors = []

    def run():
        try:
            k.push([_nd(x), _nd(y)], [_nd(out)], (20, 1, 1), (256, 1, 1))
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and errors == []
    torch.testing.assert_close(out, _rtc_axpy_plain(x, y), rtol=0, atol=0)


def test_rtc_push_makes_no_host_sync(card, monkeypatch):
    x = torch.ones(1024, device=card)
    out = torch.empty_like(x)
    k = rtc.Rtc("axpy_nosync", [("x", _nd(x)), ("y", _nd(x))],
                [("out", _nd(out))], RTC_AXPY)
    calls = []

    def count(name):
        def f(*a, **kw):
            calls.append(name)
            raise AssertionError(f"host sync through {name}")
        return f

    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, count(name))
    monkeypatch.setattr(torch.cuda, "synchronize", count("synchronize"))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        count("Stream.synchronize"))
    for _ in range(3):
        k.push([_nd(x), _nd(x)], [_nd(out)], (4, 1, 1), (256, 1, 1))
    monkeypatch.undo()
    assert calls == []
    torch.testing.assert_close(out, torch.full_like(x, 3.0))


# ------------------------------------------------ captured training step
def _conv_trainer(card, dtype, b=8, seed=0):
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.trainer import FusedTrainer

    data = tsym.Variable("data")
    net = tsym.Convolution(data, name="conv1", kernel=(3, 3), num_filter=16,
                           pad=(1, 1))
    net = tsym.BatchNorm(net, name="bn1", fix_gamma=False)
    net = tsym.Activation(net, act_type="relu")
    net = tsym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = tsym.Convolution(net, name="conv2", kernel=(3, 3), num_filter=32,
                           pad=(1, 1))
    net = tsym.BatchNorm(net, name="bn2", fix_gamma=False)
    net = tsym.Activation(net, act_type="relu")
    net = tsym.Pooling(net, global_pool=True, kernel=(1, 1), pool_type="avg")
    net = tsym.FullyConnected(tsym.Flatten(net), name="fc", num_hidden=10)
    net = tsym.SoftmaxOutput(net, name="softmax")
    trandom.seed(seed)
    return FusedTrainer(net, optimizer="sgd",
                        optimizer_params={"lr": 0.1, "momentum": 0.9,
                                          "rescale_grad": 1.0 / b},
                        dtype=dtype, device=card).init(data=(b, 3, 16, 16))


def _train_batches(k, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand((b, 3, 16, 16), generator=g),
             torch.randint(0, 10, (b,), generator=g).float())
            for _ in range(k)]


@pytest.fixture()
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _max_param_err(a, b):
    return max(float((a.params[k] - b.params[k]).norm()
                     / b.params[k].norm().clamp_min(1e-30))
               for k in a.params)


# the graph replays the kernels the eager step launches, on the same
# inputs; they part only where a kernel's summation order is not fixed
# (atomics in cuDNN's weight gradients): fp32 to 1e-5 of each
# parameter's norm after 4 steps, bf16 (whose activations then round
# apart) to 1e-2
@pytest.mark.parametrize("dtype,tol", [(None, 1e-5), ("bfloat16", 1e-2)])
def test_step_multi_graph_matches_eager_steps(card, no_tf32, dtype, tol):
    from mxnet_tpu_torch import convert

    eager, graph = _conv_trainer(card, dtype), _conv_trainer(card, dtype)
    convert.load_trainer_params(graph, eager.params, eager.aux)
    batches = _train_batches(4, 8)
    want = [eager.step(data=x, softmax_label=y)[0] for x, y in batches]
    outs = graph.step_multi(data=torch.stack([x for x, _ in batches]),
                            softmax_label=torch.stack([y for _, y in batches]))
    assert len(graph._graphs) == 1 and graph._step == eager._step == 4
    assert outs[0].shape == (4, 8, 10)
    torch.testing.assert_close(outs[0].float(), torch.stack(want).float(),
                               rtol=tol, atol=tol)
    assert _max_param_err(graph, eager) <= tol
    for k in eager.aux:
        torch.testing.assert_close(graph.aux[k], eager.aux[k], rtol=tol,
                                   atol=tol)
    # a later eager step continues from the graph's state
    x, y = batches[0]
    eager.step(data=x, softmax_label=y)
    graph.step(data=x, softmax_label=y)
    assert _max_param_err(graph, eager) <= tol


def test_step_multi_recaptures_on_a_new_batch_shape(card):
    t = _conv_trainer(card, "bfloat16")
    for b in (8, 4, 8):
        xs = _train_batches(3, b, seed=b)
        outs = t.step_multi(data=tuple(x for x, _ in xs),
                            softmax_label=tuple(y for _, y in xs))
        assert outs[0].shape == (3, b, 10)
        assert bool(torch.isfinite(outs[0]).all())
    assert len(t._graphs) == 2 and t._step == 9


def test_step_multi_is_one_graph_launch_per_step(card):
    from torch.profiler import ProfilerActivity, profile

    t = _conv_trainer(card, "bfloat16")
    xs = _train_batches(4, 8)
    feed = {"data": torch.stack([x for x, _ in xs]).to(card),
            "softmax_label": torch.stack([y for _, y in xs]).to(card)}
    t.step_multi(**feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.step_multi(**feed)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert names.count("cudaGraphLaunch") == 4
    launches = sum(n in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                   for n in names)
    # per step: the lr fill, the batch copies and the output copy only
    assert launches <= 4 * 6, launches


def test_step_multi_capture_failure_raises(card, monkeypatch):
    from mxnet_tpu_torch.ops import registry

    t = _conv_trainer(card, None)
    before = {k: v.clone() for k, v in t.params.items()}
    flatten = registry.get("Flatten")
    plain = flatten.fn

    def syncing(ctx, x, **attrs):
        float(x.sum())  # a host sync: not capturable
        return plain(ctx, x, **attrs)

    monkeypatch.setattr(flatten, "fn", syncing)
    xs = _train_batches(2, 8)
    with pytest.raises(MXNetError, match="could not be captured"):
        t.step_multi(data=torch.stack([x for x, _ in xs]),
                     softmax_label=torch.stack([y for _, y in xs]))
    # nothing ran in its place: no step, no graph, the state as it was
    assert t._step == 0 and not t._graphs
    for k, v in t.params.items():
        assert torch.equal(v, before[k]), k
    monkeypatch.undo()
    out = t.step(data=xs[0][0], softmax_label=xs[0][1])[0]
    assert bool(torch.isfinite(out).all()) and t._step == 1


# ------------------------------------------------------- the Module path
def _launches(run):
    """Kernel launch calls the host makes in ``run()`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC")
               for e in prof.events())


def test_module_step_matches_fused_trainer_step(card, no_tf32,
                                                monkeypatch):
    """One Module step (its own eager updater) and one FusedTrainer.step
    with the same SGD from the same weights: the same arithmetic on the
    same kernels (cuDNN deterministic), so equal to 1e-6 of each tensor's
    norm (measured 0 at ResNet-50 width by chip_smoke.py)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    b = 8
    tr = _conv_trainer(card, None, b=b)
    arg, aux = tr.get_params()
    mod = mx.mod.Module(tr.symbol, context=card)
    mod.bind(data_shapes=[("data", (b, 3, 16, 16))],
             label_shapes=[("softmax_label", (b,))])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    assert mod._kvstore is None  # one card, "local": the eager Updater
    x, y = _train_batches(1, b)[0]
    want = tr.step(data=x, softmax_label=y)[0]
    mod.forward_backward(io.DataBatch([tnd.NDArray(x.to(card))],
                                      [tnd.NDArray(y.to(card))]))
    mod.update()
    got = mod.get_outputs()[0].tensor
    ex = mod._exec_group.execs[0]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    assert rel(got, want) <= 1e-6
    for i, k in enumerate(mod._param_names):
        assert rel(ex.arg_dict[k], tr.params[k]) <= 1e-6, k
        assert rel(mod._updater.states[i].tensor,
                   tr.opt_state[k][0]) <= 1e-6, k
    for k, v in tr.aux.items():
        assert rel(ex.aux_dict[k], v) <= 1e-6, k


def test_bucketed_update_launches_do_not_grow_with_keys(card, monkeypatch):
    """A batched push and pull through the bucketed update on the card:
    the same kernel launches for 8 and for 16 keys in one bucket, and
    fewer than the eager per-key update's; the two agree exactly."""
    import mxnet_tpu_torch as mx

    def store(nkeys, fused):
        monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1" if fused else "0")
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=1e-3,
            rescale_grad=0.5, param_idx2name={i: f"w{i}_weight"
                                              for i in range(nkeys)}))
        keys = list(range(nkeys))
        g = torch.Generator(device="cpu").manual_seed(nkeys)
        kv.init(keys, [tnd.NDArray(torch.randn(16, 32, generator=g).to(card))
                       for _ in keys])
        grads = [[tnd.NDArray(torch.randn(16, 32, generator=g).to(card))]
                 for _ in keys]
        outs = [tnd.NDArray(torch.zeros(16, 32, device=card))
                for _ in keys]

        def step():
            kv.push(keys, grads)
            kv.pull(keys, outs)
        step()  # the states are made on the first push
        return kv, step, outs

    counts = {}
    for n in (8, 16):
        kv, step, outs = store(n, True)
        assert kv._fused.num_buckets == 1
        counts[n] = _launches(step)
        _, estep, eouts = store(n, False)
        counts[("eager", n)] = _launches(estep)
        for a, b in zip(outs, eouts):
            assert torch.equal(a.tensor, b.tensor)
    assert counts[8] == counts[16], counts
    assert counts[("eager", 16)] > 2 * counts[16], counts


def test_module_score_launches_the_epilogue_four_times(card, no_tf32):
    """``Module.score`` over a bound ResNet-50 runs the graph passes'
    fused tails through the kernel, 4 launches a forward, and
    ``Module.predict`` equals the Predictor on the same parameters with
    the same passes (the Conv+BN fold off: the Module does not fold)."""
    import os

    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io, metric
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.predict import Predictor

    shape = (2, 3, 64, 64)
    net = resnet.get_symbol(10, 50, shape[1:])
    arg, aux = resnet.random_params(net, seed=0, data=shape)
    mod = mx.mod.Module(net, context=card)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (2,))], for_training=False)
    mod.init_params(arg_params=arg, aux_params=aux)
    rs = np.random.RandomState(2)
    x = rs.normal(size=(4,) + shape[1:]).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.float32)
    it = io.NDArrayIter(x, y, batch_size=2)
    n0 = tre.launch_count()
    mod.score(it, metric.Accuracy())
    assert tre.launch_count() - n0 == 8
    probs = mod.predict(it).asnumpy()
    old = os.environ.get("MXTPU_GRAPH_PASSES")
    os.environ["MXTPU_GRAPH_PASSES"] = "cse,dce,residual_epilogue"
    try:
        p = Predictor(symbol=net, arg_params=arg, aux_params=aux,
                      input_shapes={"data": shape})
    finally:
        if old is None:
            os.environ.pop("MXTPU_GRAPH_PASSES")
        else:
            os.environ["MXTPU_GRAPH_PASSES"] = old
    want = []
    for i in range(2):
        p.forward(data=x[2 * i:2 * i + 2])
        want.append(p.get_output(0))
    # the same graph and kernels on the same inputs: equal
    np.testing.assert_array_equal(probs, np.concatenate(want))


# ------------------------------------------------------ mixed precision
@pytest.fixture()
def amp_env(monkeypatch):
    from mxnet_tpu_torch import amp

    monkeypatch.setenv("MXTPU_AMP", "bf16")
    amp.reset_scaler()
    yield monkeypatch
    amp.reset_scaler()


def test_bucketed_amp_step_skips_an_overflow_without_host_sync(card,
                                                               amp_env):
    """The bucketed update under AMP loss scaling on the card, under
    ``set_sync_debug_mode("error")``: a clean push, then a push with an
    ``inf`` in one bucket.  That bucket's weights, momenta and fp32
    masters are held to the bit, the other bucket moves, and the report
    shows the scale halved with one overflow and one skip."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp

    amp_env.setenv("MXTPU_LOSS_SCALE", "1024")
    amp_env.setenv("MXTPU_KV_BUCKET_MB", "0.001")   # one key a bucket
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                         momentum=0.9))
    keys = [0, 1, 2]
    g = torch.Generator(device="cpu").manual_seed(5)
    kv.init(keys, [tnd.NDArray(torch.randn(16, 32, generator=g).to(
        card, torch.bfloat16)) for _ in keys])
    grads = [tnd.NDArray(torch.randn(16, 32, generator=g).to(card))
             for _ in keys]
    bad = [tnd.NDArray(grads[0].tensor.clone().fill_(float("inf")))] + \
        grads[1:]

    def held(k):
        st = kv._updater.states[k]
        return [kv._store[k].tensor.clone()] + [t.tensor.clone()
                                                for t in st]

    kv.push(keys, [[v] for v in grads])     # makes the states
    torch.cuda.synchronize()
    before = [held(k) for k in keys]
    assert len(before[0]) == 3             # weight, momentum, master
    torch.cuda.set_sync_debug_mode("error")
    try:
        kv.push(keys, [[v] for v in bad])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kv._fused.num_buckets == 3
    for a, b in zip(before[0], held(0)):
        assert torch.equal(a, b)
    assert not torch.equal(before[1][0], held(1)[0])
    rep = amp.global_scaler().report()
    assert rep["scale"] == 512.0
    assert rep["overflow_total"] == 1 and rep["skipped_steps_total"] == 1


def test_cast_keeps_channels_last_weights_on_card(card):
    from mxnet_tpu_torch.ops import registry

    g = torch.Generator(device="cpu").manual_seed(9)
    w = torch.randn(64, 32, 3, 3, generator=g).to(card).contiguous(
        memory_format=torch.channels_last)
    out = registry.get("Cast").fn(registry.OpCtx(), w, dtype="bfloat16")
    assert out.dtype == torch.bfloat16 and out.device == w.device
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out.float(), w.to(torch.bfloat16).float())


def test_epilogue_in_the_amp_graph_matches_plain(card, amp_env, no_tf32):
    """``Module.score`` on a ResNet-50 bound under ``MXTPU_AMP=bf16``: 4
    epilogue launches a forward, each in the dtype its inputs arrive in
    (bf16: the sums of bf16 convolutions), and each launch's output
    within ``_epi_tolerance`` of the plain version on the same inputs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io, metric
    from mxnet_tpu_torch.models import resnet

    shape = (2, 3, 64, 64)
    net = resnet.get_symbol(10, 50, shape[1:])
    arg, aux = resnet.random_params(net, seed=0, data=shape)
    mod = mx.mod.Module(net, context=card)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (2,))], for_training=False)
    mod.init_params(arg_params=arg, aux_params=aux)
    calls = []
    kernel = tre._cuda_fwd

    def recording(x, s, scale, bias, channel_axis):
        out = kernel(x, s, scale, bias, channel_axis)
        calls.append((x, s, scale, bias, channel_axis, out))
        return out

    amp_env.setattr(tre, "_cuda_fwd", recording)
    rs = np.random.RandomState(3)
    it = io.NDArrayIter(rs.normal(size=(4,) + shape[1:]).astype(np.float32),
                        rs.randint(0, 10, 4).astype(np.float32),
                        batch_size=2)
    mod.score(it, metric.Accuracy())
    assert len(calls) == 8
    for x, s, scale, bias, ax, out in calls:
        assert x.dtype == s.dtype == out.dtype == torch.bfloat16
        ref = tre._plain_fwd(x, s, scale, bias, ax)
        diff = (out.float() - ref.float()).abs()
        assert bool((diff <= _epi_tolerance(x, s, scale, ref)).all()), \
            float(diff.max())


# ------------------------------------------- the generator after a capture
def test_card_generator_draws_after_a_failed_capture(card, monkeypatch):
    """A failed ``step_multi`` capture puts the card's default generator
    and the current stream back: a draw on the card works after it (it
    raised "Offset increment outside graph capture" before)."""
    from mxnet_tpu_torch.ops import registry

    t = _conv_trainer(card, None)
    flatten = registry.get("Flatten")
    plain = flatten.fn

    def syncing(ctx, x, **attrs):
        float(x.sum())  # a host sync: not capturable
        return plain(ctx, x, **attrs)

    monkeypatch.setattr(flatten, "fn", syncing)
    xs = _train_batches(2, 8)
    stream = torch.cuda.current_stream(card)
    with pytest.raises(MXNetError, match="could not be captured"):
        t.step_multi(data=torch.stack([x for x, _ in xs]),
                     softmax_label=torch.stack([y for _, y in xs]))
    assert torch.cuda.current_stream(card) == stream
    z = torch.randn(1024, device=card)
    assert bool(torch.isfinite(z).all()) and float(z.std()) > 0.5
    torch.cuda.manual_seed(3)
    a = torch.rand(16, device=card)
    torch.cuda.manual_seed(3)
    assert torch.equal(a, torch.rand(16, device=card))


# ------------------------------------------------------ the ops of nn.py
def test_dropout_mask_comes_from_the_card_generator(card):
    from mxnet_tpu_torch.ops import registry

    op = registry.get("Dropout")
    x = torch.ones(256, 4096, device=card)

    def draw(seed):
        gen = torch.Generator(device=card).manual_seed(seed)
        return op.fn(registry.OpCtx(is_train=True, device=card,
                                    generator=gen), x, p=0.5)

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the global generator does not decide it
    torch.cuda.manual_seed(99)
    assert torch.equal(draw(1), a)
    kept = float((a != 0).double().mean())
    assert abs(kept - 0.5) <= 4 * np.sqrt(0.25 / x.numel())
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}


def _nn_cases():
    r = np.random.RandomState(0)

    def n(*shape, scale=1.0):
        return (r.normal(size=shape) * scale).astype(np.float32)

    return {
        "concat": ("Concat", [n(2, 3, 5, 4), n(2, 5, 5, 4)], {"dim": 1}),
        "slice": ("SliceChannel", [n(2, 6, 3, 4)], {"num_outputs": 3}),
        "lrn": ("LRN", [n(4, 96, 13, 13, scale=3.0)],
                {"alpha": 1e-4, "beta": 0.75, "knorm": 1, "nsize": 5}),
        "leaky": ("LeakyReLU", [n(2, 3, 4, 4)], {"slope": 0.1}),
        "elu": ("LeakyReLU", [n(2, 3, 4, 4)], {"act_type": "elu"}),
        "prelu": ("LeakyReLU", [n(2, 3, 4, 4), n(3)],
                  {"act_type": "prelu"}),
        "deconv": ("Deconvolution", [n(2, 4, 5, 5), n(4, 3, 4, 4) * 0.3,
                                     n(3)],
                   {"kernel": (4, 4), "num_filter": 3, "stride": (2, 2),
                    "pad": (1, 1), "adj": (1, 1), "no_bias": False}),
        "deconv_group": ("Deconvolution", [n(2, 4, 5, 5),
                                           n(4, 3, 3, 3) * 0.3],
                         {"kernel": (3, 3), "num_filter": 6,
                          "num_group": 2, "dilate": (2, 2)}),
        "conv1d": ("Convolution", [n(2, 3, 12), n(4, 3, 3) * 0.3],
                   {"kernel": (3,), "num_filter": 4, "no_bias": True}),
        "conv3d": ("Convolution", [n(1, 2, 5, 6, 5), n(4, 2, 3, 3, 3)],
                   {"kernel": (3, 3, 3), "num_filter": 4, "no_bias": True}),
        "instance_norm": ("InstanceNorm", [n(2, 3, 5, 4) + 0.5, n(3), n(3)],
                          {}),
        "l2norm": ("L2Normalization", [n(2, 3, 4, 4)], {"mode": "channel"}),
        "pad_reflect": ("Pad", [n(2, 3, 4, 5)],
                        {"pad_width": (0, 0, 1, 1, 3, 2, 4, 4),
                         "mode": "reflect"}),
        "pad_constant": ("Pad", [n(2, 3, 4, 5)],
                         {"pad_width": (0, 0, 0, 0, 1, 2, 3, 1),
                          "constant_value": 1.5}),
        "upsample_nearest": ("UpSampling", [n(2, 3, 4, 5)], {"scale": 2}),
        "upsample_bilinear": ("UpSampling", [n(2, 3, 5, 5),
                                             np.abs(n(3, 1, 4, 4))],
                              {"scale": 2, "sample_type": "bilinear",
                               "num_filter": 3}),
        "crop": ("Crop", [n(2, 3, 7, 8)], {"h_w": (4, 5),
                                           "center_crop": True}),
        "pool1d": ("Pooling", [n(2, 3, 11)],
                   {"kernel": (3,), "stride": (2,), "pool_type": "avg"}),
        "pool3d": ("Pooling", [n(1, 2, 5, 6, 7)],
                   {"kernel": (2, 3, 3), "stride": (2, 2, 2),
                    "pad": (0, 1, 1), "pool_type": "max"}),
        "pool3d_avg": ("Pooling", [n(1, 2, 5, 6, 7)],
                       {"kernel": (3, 3, 3), "stride": (2, 2, 2),
                        "pool_type": "avg", "pooling_convention": "full"}),
        "dropout_eval": ("Dropout", [n(2, 3, 4, 4)], {"p": 0.5}),
    }


_NN_CASES = sorted(_nn_cases())


# the card's kernels against torch's CPU ones on the same inputs: fp32
# (TF32 off) to 1e-5, the convolutions' gradients 1e-4 (longer sums in
# another order); bf16 to 2e-2 (a couple of bf16 steps)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _NN_CASES)
def test_nn_op_on_the_card_matches_the_cpu(card, no_tf32, case, dtype):
    from mxnet_tpu_torch.ops import registry

    name, ins, attrs = _nn_cases()[case]
    tdt = getattr(torch, dtype)

    def run(dev):
        ts = [torch.from_numpy(a).to(dev, tdt).requires_grad_(True)
              for a in ins]
        out = registry.get(name).fn(registry.OpCtx(device=dev), *ts,
                                    **attrs)
        outs = list(out) if isinstance(out, tuple) else [out]
        g = torch.Generator().manual_seed(1)
        cts = [torch.randn(o.shape, generator=g).to(dev, o.dtype)
               for o in outs]
        grads = torch.autograd.grad(outs, ts, cts, allow_unused=True)
        return [o.detach().float().cpu() for o in outs] + [
            torch.zeros(t.shape) if gr is None else gr.float().cpu()
            for t, gr in zip(ts, grads)]

    conv = name in ("Convolution", "Deconvolution", "UpSampling")
    tol = 2e-2 if dtype == "bfloat16" else (1e-4 if conv else 1e-5)
    for got, want in zip(run(card), run(torch.device("cpu"))):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ------------------------------------------------ the LSTM LM's path
def _dropout_trainer(card, seed, p=0.5, lr=0.0):
    """A FusedTrainer over fc -> Dropout -> fc -> SoftmaxOutput, its
    weights drawn after ``random.seed(seed)``."""
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.trainer import FusedTrainer

    net = tsym.FullyConnected(tsym.Variable("data"), num_hidden=512,
                              name="fc1")
    net = tsym.Dropout(net, p=p, name="drop")
    net = tsym.SoftmaxOutput(tsym.FullyConnected(net, num_hidden=10,
                                                 name="fc2"), name="softmax")
    trandom.seed(seed)
    return FusedTrainer(net, optimizer="sgd", optimizer_params={"lr": lr},
                        device=card).init(data=(64, 32))


def _captured_outputs(t, k):
    """The outputs of ``k`` captured steps over one repeated batch; at lr
    0 the weights stay, so only the Dropout masks tell them apart."""
    return t.step_multi(data=torch.ones(k, 64, 32),
                        softmax_label=torch.zeros(k, 64))[0]


def test_step_multi_draws_a_fresh_dropout_mask_per_replay(card):
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        with pytest.raises(MXNetError, match="random numbers"):
            _captured_outputs(_dropout_trainer(card, 0), 2)
        return
    a = _captured_outputs(_dropout_trainer(card, 0), 4)
    for i in range(3):
        assert not torch.equal(a[i], a[i + 1]), i
    # the same seed, the same sequence (a new trainer, a new capture)
    assert torch.equal(a, _captured_outputs(_dropout_trainer(card, 0), 4))
    assert not torch.equal(a, _captured_outputs(_dropout_trainer(card, 1),
                                                4))


def test_step_multi_with_dropout_equals_eager_steps(card, no_tf32):
    """The captured steps draw what eager steps draw from the same
    generator state, so k replays equal k ``step()`` calls."""
    from mxnet_tpu_torch import random as trandom

    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        pytest.skip("this torch has no CUDAGraph.register_generator_state")
    eager = _dropout_trainer(card, 3, 0.3, lr=0.1)
    graph = _dropout_trainer(card, 3, 0.3, lr=0.1)
    g = torch.Generator().manual_seed(0)
    xs = torch.rand(3, 64, 32, generator=g)
    ys = torch.randint(0, 10, (3, 64), generator=g).float()
    trandom.seed(7)
    want = [eager.step(data=x, softmax_label=y)[0] for x, y in zip(xs, ys)]
    trandom.seed(7)
    outs = graph.step_multi(data=xs, softmax_label=ys)[0]
    torch.testing.assert_close(outs, torch.stack(want), rtol=1e-5,
                               atol=1e-6)
    assert _max_param_err(graph, eager) <= 1e-5


# fp32 (TF32 off): the same arithmetic in other kernels, elementwise to
# 1e-5.  bf16: every product and cell rounds to bf16 on both sides and
# the two libraries' bf16 GEMMs round at other points, so the values
# part by bf16 steps that compound through 35 recurrent steps and 2
# layers; each output and gradient is held to 2e-2 of its norm
@pytest.mark.parametrize("mode", ["lstm", "gru"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_rnn_op_on_the_card_matches_the_cpu(card, no_tf32, mode, dtype,
                                            tol):
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size

    T, N, C, H = 35, 8, 16, 32
    r = np.random.RandomState(0)
    ins = [r.normal(size=(T, N, C)), r.normal(
        size=rnn_param_size(2, C, H, True, mode)) * 0.2,
        r.normal(size=(4, N, H)) * 0.5]
    if mode == "lstm":
        ins.append(r.normal(size=(4, N, H)) * 0.5)
    attrs = {"mode": mode, "state_size": H, "num_layers": 2,
             "bidirectional": True, "state_outputs": True}
    tdt = getattr(torch, dtype)

    def run(dev):
        ts = [torch.from_numpy(a.astype(np.float32)).to(dev, tdt)
              .requires_grad_(True) for a in ins]
        outs = registry.get("RNN").fn(registry.OpCtx(device=dev), *ts,
                                      **attrs)
        g = torch.Generator().manual_seed(1)
        cts = [torch.randn(o.shape, generator=g).to(dev, o.dtype)
               for o in outs]
        grads = torch.autograd.grad(outs, ts, cts)
        return [o.detach().float().cpu() for o in outs] + [
            gr.float().cpu() for gr in grads]

    for got, want in zip(run(card), run(torch.device("cpu"))):
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        else:
            err = float((got - want).norm() / want.norm())
            assert err <= tol, err


# ------------------------------------------------------------ staging
def _records(tmp_path, n=21):
    from mxnet_tpu_torch import image as timg
    from mxnet_tpu_torch import recordio as trec

    rs = np.random.RandomState(4)
    rec = str(tmp_path / "c.rec")
    w = trec.MXRecordIO(rec, "w")
    for i in range(n):
        img = rs.randint(0, 256, (20, 24, 3)).astype(np.uint8)
        w.write(trec.pack(trec.IRHeader(0, float(i), i, 0),
                          timg.imencode(img, img_fmt=".png")))
    w.close()
    return rec


def test_device_prefetch_under_a_slow_consumer_stages_every_batch(card):
    from mxnet_tpu_torch import io as tio

    rs = np.random.RandomState(5)
    x = rs.normal(size=(96, 3, 64, 64)).astype(np.float32)
    y = rs.randint(0, 10, 96).astype(np.float32)
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy())
            for b in tio.NDArrayIter(x, y, batch_size=8)]
    it = tio.DevicePrefetchIter(tio.NDArrayIter(x, y, batch_size=8),
                                depth=3, device=card)
    busy = torch.randn(2048, 2048, device=card)
    for (wx, wy), batch in zip(want, it):
        assert batch.data[0].tensor.is_cuda
        for _ in range(8):         # queued work ahead of the read
            busy = busy @ busy * 1e-3
        torch.cuda._sleep(2_000_000)
        np.testing.assert_array_equal(batch.data[0].asnumpy(), wx)
        np.testing.assert_array_equal(batch.label[0].asnumpy(), wy)
    assert not it.iter_next()


def test_pinned_buffer_is_held_until_its_copy_completes(card):
    from mxnet_tpu_torch import storage

    storage.release_all()
    buf = storage.staging_empty((1 << 20,), np.float32, pin=True)
    assert buf.is_pinned()
    buf.copy_(torch.arange(1 << 20, dtype=torch.float32))
    ptr = buf.data_ptr()
    stream = storage._staging_stream(torch.device("cuda",
                                                  torch.cuda.current_device()))
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)   # the copy waits behind this
    out = storage.stage_to_device(buf, card)
    other = storage.staging_empty((1 << 20,), np.float32, pin=True)
    assert other.data_ptr() != ptr       # its copy has not completed
    other.fill_(-1.0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  np.arange(1 << 20, dtype=np.float32))
    storage.staging_free(other)
    again = storage.staging_empty((1 << 20,), np.float32, pin=True)
    assert ptr in (again.data_ptr(), other.data_ptr())


def test_image_record_iters_on_the_card_equal_the_host(card, tmp_path):
    from mxnet_tpu_torch import image as timg
    from mxnet_tpu_torch import io as tio

    rec = _records(tmp_path)
    host = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
            for b in timg.ImageRecordIter(rec, (3, 16, 16), 4, device="cpu")]
    on_card = tio.DevicePrefetchIter(tio.PrefetchingIter(
        timg.ImageRecordIter(rec, (3, 16, 16), 4, preprocess_threads=3)),
        device=card)
    got = [(b.data[0], b.label[0], b.pad) for b in on_card]
    assert len(got) == len(host) == 6
    for (hd, hl, hp), (d, lab, p) in zip(host, got):
        assert d.tensor.is_cuda and lab.tensor.is_cuda and p == hp
        np.testing.assert_array_equal(d.asnumpy(), hd)
        np.testing.assert_array_equal(lab.asnumpy(), hl)
    mp = timg.MultiProcessImageRecordIter(rec, (3, 16, 16), 4,
                                          num_workers=2, stall_timeout=120)
    try:
        rows = {}
        for b in mp:
            assert b.data[0].tensor.is_cuda
            d, lab = b.data[0].asnumpy(), b.label[0].asnumpy()
            for i in range(4 - b.pad):
                rows[int(lab[i])] = d[i]
    finally:
        mp.close()
    flat = {int(hl[i]): hd[i] for hd, hl, hp in host
            for i in range(4 - hp)}
    assert sorted(rows) == sorted(flat) == list(range(21))
    for k in rows:
        np.testing.assert_array_equal(rows[k], flat[k])


# --------------------------------------------- survival and row-sparse
@pytest.mark.parametrize("rule,params", [
    ("sgd", (("momentum", 0.9), ("rescale_grad", 0.5))),
    ("adam", (("rescale_grad", 0.5),)),
    ("rmsprop", ()),
])
def test_row_update_on_the_card_equals_the_cpu(card, rule, params):
    """The touched-rows-only update (coalesce by sort and segment sum,
    gather, the rule, the masked index_add_) on the card against the
    same function on the CPU, with duplicate ids, queued without a host
    sync.  fp32 elementwise arithmetic in both; the segment sum adds
    each id's rows in order on both, so the tables agree to 1e-6."""
    from mxnet_tpu_torch import sparse as tsparse

    g = torch.Generator().manual_seed(0)
    rows, dim, k = 5000, 64, 4096
    w = torch.randn(rows, dim, generator=g)
    nslots = {"sgd": 1, "adam": 2, "rmsprop": 1}[rule]
    slots = [torch.rand(rows, dim, generator=g) for _ in range(nslots)]
    idx = torch.randint(0, 300, (k,), generator=g, dtype=torch.int32)
    vals = torch.randn(k, dim, generator=g)
    fn = tsparse.make_row_program(rule, params, 1.0)
    host = [w.clone()] + [s.clone() for s in slots]
    fn((idx,), (vals,), host[0], tuple(host[1:]), 0.01)
    dev = [t.to(card) for t in [w] + slots]
    idx_d, vals_d = idx.to(card), vals.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn((idx_d,), (vals_d,), dev[0], tuple(dev[1:]), 0.01)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(dev, host):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)
    untouched = torch.ones(rows, dtype=torch.bool)
    untouched[idx.long()] = False
    for a, b in zip(dev, [w] + slots):
        assert torch.equal(a.cpu()[untouched], b[untouched])


def test_save_state_in_flight_holds_the_post_step_values(card, tmp_path):
    """A snapshot taken right after queued steps (no sync between) holds
    the values those steps leave, not earlier ones, and later steps do
    not change it."""
    from mxnet_tpu_torch import checkpoint as ckpt

    t = _conv_trainer(card, None)
    batches = _train_batches(6, 8)
    for x, y in batches[:4]:
        t.step(data=x, softmax_label=y)
    w = t.save_state(str(tmp_path), background=True)
    want = {k: v.detach().clone() for k, v in t.params.items()}
    for x, y in batches[4:]:
        t.step(data=x, softmax_label=y)
    w.wait()
    arrays, manifest = ckpt.load(w.path)
    assert manifest["meta"]["step"] == 4
    for k, v in want.items():
        np.testing.assert_array_equal(arrays["param/" + k], v.cpu().numpy())
    assert not torch.equal(t.params["fc_weight"], want["fc_weight"])


def _lm_pair(card, dropout=0.0):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.models import transformer as ttrm
    from mxnet_tpu_torch.trainer import FusedTrainer

    cfg = dict(num_layers=2, num_heads=4, d_model=256, seq_len=256,
               vocab_size=512, dropout=dropout)
    shapes = {"data": (2, 256), "softmax_label": (2, 256)}
    trandom.seed(0)
    tts = [FusedTrainer(ttrm.transformer_lm(**cfg), optimizer="sgd",
                        optimizer_params={"lr": 0.1}, dtype="bfloat16",
                        device=card, remat=r).init(**shapes)
           for r in (True, False)]
    convert.load_trainer_params(tts[1], tts[0].params, tts[0].aux)
    g = torch.Generator().manual_seed(1)
    d = torch.randint(0, 512, (2, 256), generator=g).float()
    return tts, d


def test_remat_through_the_flash_kernels_gives_the_plain_gradients(card):
    """``remat=True`` recomputes the forward in the backward: the flash
    forward runs twice a step (4 launches for 2 layers, against 2), and
    the step's outputs and weights equal the plain step's (bf16; the
    same kernels on the same inputs, to 1e-2 of each weight's norm)."""
    tts, d = _lm_pair(card)
    outs, launches = [], []
    for t in tts:
        n0 = tfa.launch_counts()["flash_fwd"]
        outs.append(t.step(data=d, softmax_label=d)[0])
        torch.cuda.synchronize()
        launches.append(tfa.launch_counts()["flash_fwd"] - n0)
    assert launches == [4, 2]
    torch.testing.assert_close(outs[0].float(), outs[1].float(), rtol=1e-2,
                               atol=1e-2)
    assert _max_param_err(tts[0], tts[1]) <= 1e-2


def test_remat_step_multi_with_dropout_equals_eager_remat(card):
    """Captured recomputed steps with Dropout: the recompute's generator
    is registered with the graph beside the trainer's, so k replays
    equal k eager ``remat`` steps from the same generator state."""
    from mxnet_tpu_torch import random as trandom

    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        pytest.skip("this torch has no CUDAGraph.register_generator_state")
    (eager, _), d = _lm_pair(card, 0.1)
    (graph, _), _ = _lm_pair(card, 0.1)
    trandom.seed(5)
    want = [eager.step(data=d, softmax_label=d)[0] for _ in range(3)]
    trandom.seed(5)
    got = graph.step_multi(data=torch.stack([d] * 3),
                           softmax_label=torch.stack([d] * 3))[0]
    torch.testing.assert_close(got.float(), torch.stack(want).float(),
                               rtol=1e-2, atol=1e-2)
    assert _max_param_err(graph, eager) <= 1e-2


# ------------------------------------------- the classic top-level surface
def _custom_softmax_prop():
    """The custom_softmax.py head, registered as ``cuda_test_softmax``."""
    import mxnet_tpu_torch as mx

    class _Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], y / y.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("cuda_test_softmax")
    class _Prop(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return _Softmax()


def test_custom_op_on_card_tensors_matches_the_cpu(card, no_tf32):
    """A Custom softmax head over an FC layer on the card: outputs and
    gradients equal the same net's on the CPU (fp32, 1e-6); one batch
    makes one host sync each way, counted by the op."""
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.ops import custom as tcustom

    _custom_softmax_prop()
    net = tsym.Custom(tsym.FullyConnected(tsym.Variable("data"),
                                          num_hidden=10, name="fc"),
                      tsym.Variable("softmax_label"),
                      op_type="cuda_test_softmax", name="softmax")
    g = torch.Generator().manual_seed(0)
    vals = {"data": torch.randn(32, 64, generator=g),
            "softmax_label": torch.randint(0, 10, (32,), generator=g).float(),
            "fc_weight": torch.randn(10, 64, generator=g) * 0.1,
            "fc_bias": torch.randn(10, generator=g) * 0.1}
    res = []
    for dev in ("cpu", card):
        ex = net.simple_bind(dev, data=(32, 64), softmax_label=(32,))
        for k, v in vals.items():
            ex.arg_dict[k].copy_(v)
        tcustom.reset_stats()
        out = ex.forward(is_train=True)[0]
        ex.backward()
        res.append((out.cpu(), {k: ex.grad_dict[k].cpu()
                                for k in ("fc_weight", "fc_bias", "data")},
                    tcustom.stats()))
    (o_c, g_c, s_c), (o_g, g_g, s_g) = res
    assert o_g.device.type == "cpu"
    torch.testing.assert_close(o_g, o_c, rtol=1e-6, atol=1e-6)
    for k in g_c:
        torch.testing.assert_close(g_g[k], g_c[k], rtol=1e-6, atol=1e-6)
    assert (s_c["syncs"], s_g["syncs"]) == (0, 2)
    assert s_g["forward"] == s_g["backward"] == 1


def test_cpu_pinned_arrays_live_in_pinned_memory(card):
    import mxnet_tpu_torch as mx

    a = tnd.zeros((4, 5), ctx=mx.cpu_pinned())
    assert a.tensor.is_pinned() and a.context.type == "cpu"
    with mx.cpu_pinned():
        b = tnd.array(np.arange(6, dtype=np.float32))
        c = tnd.ones((3,))
    assert b.tensor.is_pinned() and c.tensor.is_pinned()
    np.testing.assert_array_equal(b.asnumpy(), np.arange(6))
    d = tnd.ones((3,), ctx=card).copyto(mx.cpu_pinned())
    assert d.tensor.is_pinned()
    np.testing.assert_array_equal(d.asnumpy(), np.ones(3))
    assert d.as_in_context(mx.cpu_pinned()) is d
    # temp space is host scratch from the native arena (src/storage.cc)
    from mxnet_tpu_torch import resource
    from mxnet_tpu_torch.resource import ResourceManager, ResourceRequest

    res = ResourceManager().request(card, ResourceRequest.kTempSpace)
    space = res.get_space((16,), np.float32)
    assert res._buf.ctypes.data in resource._arena()._ptrs
    assert space.shape == (16,)


def test_device_trace_holds_the_flash_kernels(card, tmp_path):
    """A transformer-LM step in bf16 under ``profiler_set_config(
    xla_trace_dir=...)``: the torch.profiler trace written there names
    the three flash kernels, and profile.json holds the step's
    ``forward_backward`` span."""
    import json

    from mxnet_tpu_torch import profiler

    (t, _), d = _lm_pair(card)
    t.step(data=d, softmax_label=d)
    torch.cuda.synchronize()
    fname = str(tmp_path / "profile.json")
    profiler.profiler_set_config(mode="symbolic", filename=fname,
                                 xla_trace_dir=str(tmp_path / "trace"))
    try:
        profiler.profiler_set_state("run")
        t.step(data=d, softmax_label=d)
    finally:
        profiler.profiler_set_state("stop")
        profiler.profiler_set_config()
    profiler.dump_profile(fname)
    trace = json.load(open(profiler.device_trace_files()[-1]))
    kernels = {e["name"] for e in trace["traceEvents"]
               if e.get("cat") == "kernel"}
    for pat in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert any(pat in k for k in kernels), (pat, sorted(kernels)[:20])
    spans = [e["name"] for e in json.load(open(fname))["traceEvents"]]
    assert [s for s in spans if s.startswith("forward_backward[")]


# -------------------------------------------- int8 serving, generate_scan
def _lm_params(L=2, H=2, D=128, V=256, T=128, seed=0):
    from mxnet_tpu_torch.models import transformer as tr

    shapes = tr.lm_param_shapes(L, H, D, 4 * D, V, T)
    return tr.lm_random_params(shapes, seed=seed, std=0.05)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_paged_step_kernel_matches_gather(card, dtype):
    """An int8 decoder's paged step through the kernel against the same
    pools stepped through the plain gather path: fp32 within 1e-4 of the
    logits, bf16 within one bf16 rounding at magnitude ~2 (1e-2), and
    the kernel launched once per layer."""
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    dec = KVDecoder(_lm_params(), num_layers=2, num_heads=2, max_len=128,
                    dtype=dtype, quantize="int8", device=card)
    outs = {}
    for kernel in ("gather", "auto"):
        pg = PagedSlots(dec, 3, block=16, prefill_buckets=(16, 32, 64),
                        kernel=kernel)
        assert pg.kernel == ("cuda" if kernel == "auto" else "gather")
        rng = np.random.default_rng(3)
        tok = np.array([int(pg.admit(b, rng.integers(0, 256, n))
                            .float().argmax()) for b, n in
                        enumerate((5, 17, 40))])
        n0 = tpa.launch_count()
        lg, _ = pg.step(tok, np.ones(3, bool))
        outs[kernel] = (lg.float().cpu(), tpa.launch_count() - n0)
    assert outs["auto"][1] == 2 and outs["gather"][1] == 0
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(outs["auto"][0], outs["gather"][0],
                               rtol=0, atol=tol)


def test_generate_scan_on_the_card_equals_generate(card):
    """Greedy ``generate_scan`` on the card equals ``generate`` token for
    token, reads the host once without eos, and with an eos at most once
    per ``SCAN_EOS_CHECK`` tokens more."""
    from mxnet_tpu_torch.models import decode as tdecode

    dec = tdecode.KVDecoder(_lm_params(), num_layers=2, num_heads=2,
                            max_len=128, device=card)
    prompt = np.random.default_rng(4).integers(0, 256, (3, 6))
    ref = dec.generate(prompt, 40, temperature=0)
    got = dec.generate_scan(prompt, 40)
    np.testing.assert_array_equal(got, ref)
    assert dec.last_scan_syncs == 1
    eos = int(ref[0, 3])
    dec.generate_scan(prompt, 40, eos_id=eos)
    assert dec.last_scan_syncs <= 1 + -(-39 // tdecode.SCAN_EOS_CHECK)


# ------------------------------------------------ schedules (the autotuner)
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_every_schedule_matches_plain(card, dtype, shape):
    """Every launch schedule the autotuner may pick gives the default's
    output bit for bit, which is the plain version's bit for bit in fp32
    and within the add rounding in bf16; a schedule outside the kernel's
    raises before launch."""
    x, s, scale, bias = _epi_case(card, dtype, shape)
    ref = tre._plain_fwd(x, s, scale, bias, 1)
    tol = _epi_tolerance(x, s, scale, ref)
    base = tre._cuda_fwd(x, s, scale, bias, 1,
                         schedule=tre.DEFAULT_SCHEDULE)
    for sched in tre.candidate_schedules():
        got = tre._cuda_fwd(x, s, scale, bias, 1, schedule=sched)
        torch.cuda.synchronize()
        assert torch.equal(got, base), sched
        if dtype == torch.float32:
            assert torch.equal(got, ref), sched
        else:
            assert bool(((got.float() - ref.float()).abs() <= tol).all())
    for bad in ({"threads": 96, "blocks_per_sm": 8},
                {"threads": 256, "blocks_per_sm": 0}, {"block_rows": 256}):
        with pytest.raises(MXNetError, match="schedule"):
            tre._cuda_fwd(x, s, scale, bias, 1, schedule=bad)


@pytest.mark.parametrize("chunk_pages", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-3)])
def test_kernel_every_split_at_max_context_matches_plain(card, dtype, tol,
                                                         chunk_pages):
    """The paged kernel under each ``chunk_pages`` the autotuner may pick,
    at ``MAX_CONTEXT``'s edge and beside a chunk boundary, within the
    gather tolerance of ``test_kernel_at_max_context_matches_plain``."""
    block = 16
    M = tpa.MAX_CONTEXT // block
    chunk = chunk_pages * block
    args = _split_case(card, dtype, [tpa.MAX_CONTEXT - 1, chunk - 1, chunk,
                                     100], M, block, 128, H=2, L=1)
    n0 = tpa.launch_count()
    got = tpa.paged_attention(*args, 0, block=block, chunk_pages=chunk_pages)
    ref = tpa._gather_attention(*args, 0, block)
    torch.cuda.synchronize()
    assert tpa.launch_count() == n0 + 1
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_kernel_refuses_a_split_that_does_not_fit(card):
    args = _case(card, torch.bfloat16)
    for bad in (0, tpa.MAX_CHUNK_PAGES + 1):
        with pytest.raises(MXNetError, match="chunk_pages"):
            tpa.paged_attention(*args, 0, block=16, chunk_pages=bad)


def test_autotune_measure_returns_positive_us_on_the_card(card):
    from mxnet_tpu_torch import autotune

    x = torch.randn(1 << 22, device=card)
    us = autotune.measure(lambda: x * 2, warmup=1, best_of=3)
    assert 0 < us < 1e6
    assert autotune.device_kind() not in ("cpu", "unknown")


@pytest.fixture()
def search_cache(tmp_path, monkeypatch):
    from mxnet_tpu_torch import autotune

    path = tmp_path / "schedules.json"
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE", "search:%s" % path)
    monkeypatch.delenv("MXTPU_PAGED_KERNEL", raising=False)
    autotune.reset()
    yield path
    autotune.reset()


def test_epilogue_tune_searches_every_schedule_on_the_card(card,
                                                            search_cache):
    import json

    from mxnet_tpu_torch import autotune

    won = tre.tune(6272, 1024, torch.float32)
    assert won in tre.candidate_schedules()
    ent = json.load(open(search_cache))["entries"][autotune.device_kind()]
    assert ent["residual_epilogue|r6272c1024_float32"]["trials"] == 12
    assert tre._schedule_for(6272, 1024, torch.float32) == won
    assert tre.tune(6272, 1024, torch.float32) == won     # a cache hit


def test_epilogue_tune_winner_is_never_slower_than_the_default(
        card, search_cache):
    """The winner, timed again as the search times it (CUDA events over
    passes on inputs cold in L2), is within the default's spread of the
    default or faster."""
    from mxnet_tpu_torch.autotune import search

    rows, c, dtype = 25088, 512, torch.bfloat16
    won = tre.tune(rows, c, dtype)
    bench = tre.make_bench_fn(rows, c, dtype)
    td = search._timings(bench(tre.DEFAULT_SCHEDULE), warmup=3, best_of=10)
    tw = search._timings(bench(won), warmup=3, best_of=10)
    assert min(tw) <= min(td) + search._spread(td), (won, tw, td)


def test_paged_slots_on_the_card_never_take_a_cached_plain_winner(
        card, search_cache, monkeypatch, tmp_path):
    """A gather winner a shared cache holds for the card's kind is not
    installed on a CUDA pool: search mode searches the kernel's splits,
    readonly mode keeps the kernel's default split."""
    import json

    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.models import decode as tdecode
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    dec = tdecode.KVDecoder(_lm_params(), num_layers=2, num_heads=2,
                            max_len=128, device=card, dtype=torch.bfloat16)
    sig = tpa.keysig(4, 2, 8, 16, 64, torch.bfloat16)
    autotune.record("paged_attention", sig, {"impl": "gather"}, 1.0, 1)
    pg = PagedSlots(dec, 4, block=16, prefill_buckets=(16, 32, 64, 128))
    assert pg.schedule["impl"] == "cuda"
    ro = tmp_path / "shared.json"
    ro.write_text(json.dumps({"version": autotune.SCHEMA_VERSION,
                              "entries": {autotune.device_kind(): {
                                  "paged_attention|" + sig: {
                                      "schedule": {"impl": "pagewalk",
                                                   "chunk": 1},
                                      "best_us": 1.0, "trials": 1}}}}))
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE", "readonly:%s" % ro)
    autotune.reset()
    pg = PagedSlots(dec, 4, block=16, prefill_buckets=(16, 32, 64, 128))
    assert pg.schedule == tpa.default_schedule("cuda", 16, 64,
                                               torch.bfloat16)


def test_paged_search_on_the_card_and_a_cuda_failure_raises(
        card, search_cache, monkeypatch):
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.models import decode as tdecode
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    dec = tdecode.KVDecoder(_lm_params(), num_layers=2, num_heads=2,
                            max_len=128, device=card, dtype=torch.bfloat16)
    pg = PagedSlots(dec, 4, block=16, prefill_buckets=(16, 32, 64, 128))
    assert pg.schedule in tpa.candidate_schedules("cuda", 16, 64, 8,
                                                  torch.bfloat16)
    assert pg.schedule["impl"] == "cuda"
    autotune.reset()

    def broken(*a, **k):
        raise MXNetError("paged_attention CUDA launch failed: cuda error 1")

    monkeypatch.setattr(tpa, "_cuda_attention", broken)
    with pytest.raises(MXNetError, match="launch failed"):
        PagedSlots(dec, 2, block=16, prefill_buckets=(16, 32, 64, 128))


# ---------------------------------------------------- the health plane
def test_sentinel_vector_on_the_card_matches_the_cpu(card):
    from mxnet_tpu_torch.telemetry import health

    ts = [torch.randn(300, 7), torch.tensor([1.0, float("nan")]),
          torch.tensor([float("inf"), 2.0]), torch.zeros(0),
          torch.full((5,), 3e30)]
    want = health.sentinel_vector(ts)
    got = health.sentinel_vector([t.to(card) for t in ts]).cpu()
    assert got[:-1].tolist() == want[:-1].tolist() == [1, 0, 0, 1, 1]
    assert torch.isnan(got[-1]) and torch.isnan(want[-1])
    clean = [ts[0], ts[3], ts[4]]
    torch.testing.assert_close(
        health.sentinel_vector([t.to(card) for t in clean]).cpu(),
        health.sentinel_vector(clean), rtol=1e-6, atol=0)


def test_step_multi_capture_parks_the_sentinel_rows(card, monkeypatch):
    """The sentinel inside the captured step: each replay's flags are
    copied out of the graph's buffer, the rows map to steps step0+1 ..
    step0+k, and nothing is read before the boundary."""
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.telemetry import health

    monkeypatch.setenv("MXTPU_SENTINEL", "warn")
    health._pending.clear()
    t = _conv_trainer(card, "bfloat16")
    xs = _train_batches(3, 8)
    x = torch.stack([x for x, _ in xs])
    y = torch.stack([y for _, y in xs])
    t.step_multi(data=x, softmax_label=y)
    assert health.sentinel_pending() == 1
    assert health.sentinel_check() == []
    with torch.no_grad():
        t.params["fc_weight"].view(-1)[0] = float("inf")
    t._refresh_compute_cache()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t.step_multi(data=x, softmax_label=y)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(t._graphs) == 1 and t._step == 6
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        offenders = health.sentinel_check()
    assert {s for s, _, _ in offenders} == {4, 5, 6}
    assert {b for _, b, _ in offenders} == {"fused_step_multi"}
    assert (4, "fused_step_multi", "fc_weight") in offenders
    monkeypatch.setenv("MXTPU_SENTINEL", "raise")
    t.step(data=xs[0][0], softmax_label=xs[0][1])
    with pytest.raises(health.NumericsError, match="fc_weight"):
        engine.AsyncWindow().drain()


# ------------------------------------------------------- MXNet from C
def test_c_api_arrays_executor_and_update_on_the_card(card, no_tf32):
    """``_c_api_impl`` with ``dev_type`` 2: arrays on ``cuda:0``, sync
    copies both ways, an executor bound on the card whose forward and
    backward equal the CPU's, and ``sgd_update`` through
    ``imperative_invoke`` writing the bound weight on the card."""
    from mxnet_tpu_torch import _c_api_impl as impl
    from mxnet_tpu_torch import symbol as tsym

    a = impl.ndarray_create([2, 3], 2, 0)
    assert a.tensor.device == torch.device("cuda", 0)
    impl.ndarray_sync_copy_from(
        a, memoryview(np.arange(6, dtype=np.float32).tobytes()))
    assert np.frombuffer(impl.ndarray_sync_copy_to(a), np.float32
                         ).tolist() == [0, 1, 2, 3, 4, 5]
    net = tsym.SoftmaxOutput(tsym.FullyConnected(
        tsym.Variable("data"), num_hidden=4, name="fc"), name="softmax")
    rs = np.random.RandomState(0)
    vals = {"data": rs.normal(size=(8, 5)),
            "fc_weight": rs.normal(size=(4, 5)), "fc_bias": np.zeros(4),
            "softmax_label": rs.randint(0, 4, 8)}
    grads = {}
    for dev_type in (1, 2):
        ex = impl.executor_simple_bind(net, dev_type, 0, "write",
                                       ["data", "softmax_label"],
                                       [[8, 5], [8]])
        for name in impl.executor_arg_names(ex):
            impl.ndarray_sync_copy_from(
                impl.executor_arg_array(ex, name), memoryview(
                    np.ascontiguousarray(vals[name], np.float32).tobytes()))
        impl.executor_forward(ex, 1)
        impl.executor_backward(ex)
        g = impl.executor_grad_array(ex, "fc_weight")
        grads[dev_type] = np.frombuffer(impl.ndarray_sync_copy_to(g),
                                        np.float32)
        if dev_type == 2:
            w = impl.executor_arg_array(ex, "fc_weight")
            assert w.tensor.is_cuda
            before = ex.arg_dict["fc_weight"].clone()
            impl.imperative_invoke("sgd_update", [w, g], ["lr"], ["0.5"])
            torch.testing.assert_close(ex.arg_dict["fc_weight"],
                                       before - 0.5 * ex.grad_dict[
                                           "fc_weight"])
    np.testing.assert_allclose(grads[2], grads[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(MXNetError, match="dev_id 7"):
        impl.ndarray_create([2], 2, 7)


def test_native_runtime_and_host_engine_on_the_card_host(card):
    """The card's host builds the core library and ``_mxtpu_ext`` from
    ``src/`` and the host engine runs on the compiled backend."""
    from mxnet_tpu_torch import _native, engine

    assert _native.get_ext() is not None
    assert _native.ffi_backend() == "cext"
    assert engine.host_engine()._be == "cext"
    v = engine.new_host_var()
    out = []
    for i in range(10):
        engine.push(lambda i=i: out.append(i), mutable_vars=[v])
    engine.wait_for_host_var(v)
    assert out == list(range(10))


def test_dist_store_moves_card_values_through_pinned_buffers(card,
                                                             monkeypatch):
    """A parameter-server store on card tensors: the push snapshots a
    channels-last gradient into a pinned host buffer behind the kernel
    that wrote it (the loop makes no host sync), the server applies the
    port's SGD on the host, and the lazy pull lands the update in the
    card weight, ordered before the next kernel reads it.  The server
    never initialises CUDA (it runs in this process here, so only its
    arithmetic is checked: the card's values equal the host update)."""
    import socket
    import threading

    from mxnet_tpu_torch import kvstore as tkv
    from mxnet_tpu_torch import kvstore_server as tserver
    from mxnet_tpu_torch import optimizer as topt

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setenv("MXTPU_PS_SERVERS", f"127.0.0.1:{port}")
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "1")
    monkeypatch.setenv("MXTPU_RANK", "0")
    srv = tserver.KVStoreServer(num_workers=1, port=port, host="127.0.0.1")
    t = threading.Thread(target=srv.run, daemon=True)
    t.start()
    kv = tkv.create("dist_sync")
    try:
        g = torch.Generator(device="cpu").manual_seed(5)
        w0 = torch.randn(8, 4, 3, 3, generator=g)
        w = w0.to(card).contiguous(memory_format=torch.channels_last)
        kv.init(0, tnd.NDArray(w))
        opt = topt.create("sgd", learning_rate=0.1, momentum=0.9,
                          rescale_grad=0.5)
        kv.set_optimizer(opt)
        ref_w, ref = w0.clone(), topt.get_updater(topt.create(
            "sgd", learning_rate=0.1, momentum=0.9, rescale_grad=0.5))
        x = torch.randn(8, 4, 3, 3, generator=g).to(card)
        for step in range(3):
            grad = (x * (step + 1)).contiguous(
                memory_format=torch.channels_last)
            torch.cuda.set_sync_debug_mode("error")
            try:
                kv.push(0, tnd.NDArray(grad))
                kv.pull(0, tnd.NDArray(w))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            kv.wait_pulls()
            y = w * 2.0                     # reads the pulled weight
            ref(0, tnd.NDArray(grad.cpu().contiguous()), tnd.NDArray(ref_w))
            torch.testing.assert_close(y.cpu(), ref_w * 2.0, rtol=0, atol=0)
        stats = kv.comm_stats()
        assert stats["pushes"] == stats["pulls"] == 3
        assert stats["loop_waits"] == 3
    finally:
        kv._send_stop()
        t.join(30)
    assert not t.is_alive()


def test_server_optimizer_pickle_moves_card_tensors_to_the_host(card):
    from mxnet_tpu_torch import kvstore_server as tserver
    from mxnet_tpu_torch import optimizer as topt

    opt = topt.create("sgd", learning_rate=0.1)
    opt.scale = torch.ones(3, device=card)
    back = tserver._loads_no_import(tserver.dumps_host(opt))
    assert back.scale.device.type == "cpu"
    torch.testing.assert_close(back.scale, torch.ones(3))


# ------------------------------------------------------------ plugins
def test_torch_module_runs_on_the_card_without_a_host_sync(card, no_tf32):
    """``TorchModule`` over a Conv+BatchNorm+Dropout module and
    ``TorchCriterion`` (cross-entropy on class indices) on card tensors:
    the module moves to the card at its first call, its output, the loss
    and every gradient stay there, nothing reads the device in a later
    forward or backward (``set_sync_debug_mode("error")``), the
    BatchNorm statistics advance once a forward, and the values match
    the same graph on the CPU (Dropout off)."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.plugins import torch_plugin as tp

    torch.manual_seed(0)
    body = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                               torch.nn.BatchNorm2d(8), torch.nn.ReLU(),
                               torch.nn.Flatten(), torch.nn.Linear(8 * 36, 5))
    names = [n.replace(".", "_") for n, _ in body.named_parameters()]
    params = {n: p.detach().clone() for n, (_, p) in
              zip(names, body.named_parameters())}
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.normal(size=(16, 3, 6, 6)).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 5, 16).astype(np.float32))
    grads = {}
    for dev in (torch.device("cpu"), card):
        module = copy.deepcopy(body)
        mid = tp.register_module(module)
        cid = tp.register_criterion(torch.nn.CrossEntropyLoss())
        net = mx.sym.TorchCriterion(
            mx.sym.TorchModule(mx.sym.Variable("data"),
                               *[mx.sym.Variable(n) for n in names],
                               module_id=mid),
            mx.sym.Variable("label"), criterion_id=cid, grad_scale=16)
        ex = net.simple_bind(ctx=dev, data=tuple(x.shape),
                             label=tuple(y.shape),
                             **{n: tuple(p.shape) for n, p in params.items()})
        ex.copy_params_from(params)
        xd, yd = x.to(dev), y.to(dev)
        # the first call moves the module to the card; the second runs
        # under the sync check
        ex.forward(is_train=True, data=xd, label=yd)
        ex.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            ex.forward(is_train=True, data=xd, label=yd)
            ex.backward()
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        assert ex.outputs[0].device.type == dev.type
        assert all(t.device.type == dev.type
                   for t in list(module.parameters())
                   + list(module.buffers()))
        assert int(module[1].num_batches_tracked) == 2
        grads[dev.type] = {k: g.detach().cpu() for k, g in
                           ex.grad_dict.items() if g is not None}
        assert all(g.device.type == dev.type
                   for g in ex.grad_dict.values() if g is not None)
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k], g, rtol=1e-4,
                                   atol=1e-5, msg=k)


def test_torch_module_dropout_draws_from_the_card_generator(card):
    """The fused CUDA dropout (``native_dropout``) inside a TorchModule
    is drawn from the op's card generator: the same seed gives the same
    mask, torch's own card generator is left as it was, and the
    backward applies the forward's mask."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.plugins import torch_plugin as tp

    drop = torch.nn.Sequential(torch.nn.Dropout(0.3), torch.nn.Linear(64, 64))
    mid = tp.register_module(drop)
    net = mx.sym.MakeLoss(mx.sym.sum(mx.sym.TorchModule(
        mx.sym.Variable("x"), mx.sym.Variable("w"), mx.sym.Variable("b"),
        module_id=mid)))
    ex = net.simple_bind(ctx=card, x=(512, 64), w=(64, 64), b=(64,))
    ex.copy_params_from({"w": drop[1].weight.detach(),
                         "b": drop[1].bias.detach()})
    x = torch.randn(512, 64, device=card)
    masks = []
    before = torch.cuda.get_rng_state()
    for seed in (5, 5, 6):
        mx.random.seed(seed)
        ex.forward(is_train=True, x=x)
        ex.backward()
        masks.append(ex.grad_dict["x"] != 0)
    assert torch.equal(torch.cuda.get_rng_state(), before)
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    kept = masks[0].float().mean().item()
    assert 0.65 < kept < 0.75, kept


# ------------------------------------------------ the port lint's findings
def test_paged_step_uploads_without_a_host_wait(card):
    """The paged decode step uploads its block tables, tokens and
    cursors from pinned copies without a host wait: under the sync
    debug mode the step itself makes no synchronizing call (three
    pageable uploads made the serving tick sync four times, where its
    one sync is the sampled tokens), and its logits equal those of a
    step through the gather path."""
    import warnings

    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    dec = KVDecoder(_lm_params(), num_layers=2, num_heads=2, max_len=128,
                    device=card)
    outs = {}
    for kernel in ("gather", "auto"):
        pg = PagedSlots(dec, 3, block=16, prefill_buckets=(16, 32, 64),
                        kernel=kernel)
        rng = np.random.default_rng(3)
        tok = np.array([int(pg.admit(b, rng.integers(0, 256, n))
                            .float().argmax()) for b, n in
                        enumerate((5, 17, 40))])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                lg, _ = pg.step(tok, np.ones(3, bool))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        assert syncs == [], [str(w.message)[:200] for w in syncs]
        outs[kernel] = lg.float().cpu()
    torch.testing.assert_close(outs["auto"], outs["gather"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["edge", "reflect"])
def test_step_multi_captures_a_pad_of_edge_or_reflect(card, no_tf32, mode):
    """Pad's edge and reflect gather positions are made on the card: an
    upload of host positions waits for the stream, which a capture
    refuses, so ``step_multi`` of such a net raised.  Captured steps
    against eager ones from the same weights."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.trainer import FusedTrainer

    def trainer():
        net = tsym.Pad(tsym.Variable("data"), mode=mode,
                       pad_width=(0, 0, 0, 0, 2, 1, 1, 2))
        net = tsym.Convolution(net, name="conv", kernel=(3, 3),
                               num_filter=8)
        net = tsym.FullyConnected(tsym.Flatten(net), name="fc",
                                  num_hidden=10)
        net = tsym.SoftmaxOutput(net, name="softmax")
        trandom.seed(0)
        return FusedTrainer(net, optimizer="sgd",
                            optimizer_params={"lr": 0.1},
                            device=card).init(data=(8, 3, 16, 16))

    eager, graph = trainer(), trainer()
    convert.load_trainer_params(graph, eager.params, eager.aux)
    batches = _train_batches(3, 8)
    want = [eager.step(data=x, softmax_label=y)[0] for x, y in batches]
    outs = graph.step_multi(data=torch.stack([x for x, _ in batches]),
                            softmax_label=torch.stack([y for _, y in batches]))
    assert len(graph._graphs) == 1
    torch.testing.assert_close(outs[0].float(), torch.stack(want).float(),
                               rtol=1e-5, atol=1e-5)
    assert _max_param_err(graph, eager) <= 1e-5


# ----------------------------------------------------------- the mesh
@pytest.fixture()
def nccl_mesh(card, tmp_path):
    """A (1, 1) ("data", "model") mesh over a world-1 NCCL group brought
    up in this process on a ``FileStore``."""
    import torch.distributed as td

    from mxnet_tpu_torch.parallel import mesh as tmesh

    owned = not td.is_initialized()
    if owned:
        td.init_process_group("nccl", store=td.FileStore(
            str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield tmesh.create_mesh((1, 1), ("data", "model"))
    if owned:
        td.destroy_process_group()


def _mesh_pair(card, mesh):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.models import transformer as ttrm
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.trainer import FusedTrainer

    cfg = dict(num_layers=2, num_heads=4, d_model=256, seq_len=256,
               vocab_size=512)
    shapes = {"data": (2, 256), "softmax_label": (2, 256)}
    trandom.seed(0)
    plain = FusedTrainer(ttrm.transformer_lm(**cfg), optimizer="adam",
                         optimizer_params={"lr": 1e-3}, dtype="bfloat16",
                         device=card).init(**shapes)
    tm = FusedTrainer(ttrm.transformer_lm(**cfg), optimizer="adam",
                      optimizer_params={"lr": 1e-3}, dtype="bfloat16",
                      mesh=mesh,
                      sharding_rules=tmesh.megatron_rules()).init(**shapes)
    convert.load_trainer_params(tm, plain.params)
    g = torch.Generator().manual_seed(1)
    d = torch.randint(0, 512, (2, 256), generator=g).float()
    return plain, tm, d


def test_mesh_step_runs_the_flash_kernels_on_local_heads(card, nccl_mesh):
    """The LM step on a world-1 NCCL mesh launches each flash kernel once
    a layer on the rank's heads (2 layers: 2 of each, as without a mesh)
    and gives the step without a mesh (bf16; the same kernels on the same
    operands, the softmax's sums by hand: 1e-2)."""
    from mxnet_tpu_torch.parallel import mesh as tmesh

    plain, tm, d = _mesh_pair(card, nccl_mesh)
    launches, outs = [], []
    for t in (plain, tm):
        before = tfa.launch_counts()
        outs.append(tmesh.full_value(t.step(data=d, softmax_label=d)[0]))
        torch.cuda.synchronize()
        after = tfa.launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
    assert launches[0] == launches[1] == {
        "flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    torch.testing.assert_close(outs[1].float(), outs[0].float(), rtol=1e-2,
                               atol=1e-4)
    for k, w in plain.params.items():
        got = tmesh.full_value(tm.params[k])
        assert float((got - w).norm() / w.norm().clamp_min(1e-30)) <= 1e-2, k


def test_mesh_step_makes_no_host_sync(card, nccl_mesh):
    """After a first step, the mesh step and a captured ``step_multi``
    run under ``set_sync_debug_mode("error")``: no host sync on the
    mesh's path (DTensor's dispatch, the NCCL collectives, the
    vocab-parallel softmax, the update on the rank's blocks)."""
    _, tm, d = _mesh_pair(card, nccl_mesh)
    tm.step(data=d, softmax_label=d)
    tm.step_multi(data=torch.stack([d, d]), softmax_label=torch.stack([d, d]))
    dd = d.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.step(data=dd, softmax_label=dd)
        tm.step_multi(data=torch.stack([dd, dd]),
                      softmax_label=torch.stack([dd, dd]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(tm._graphs) == 1


# ------------------------------------------------ the collective dist_sync
@pytest.mark.parametrize("rule,params", [
    ("sgd", {"momentum": 0.9, "wd": 1e-3, "rescale_grad": 0.5,
             "clip_gradient": 0.8}),
    ("adam", {"wd": 1e-4, "rescale_grad": 0.5}),
    ("rmsprop", {"wd": 1e-4, "clip_weights": 0.9})])
def test_slice_update_equals_the_bucket_rule_on_the_card(card, rule, params):
    """The sharded update's rule on the card: the bucket's multi-tensor
    rule on each of 2 ranks' slices (``_slice_update``; the second key
    is split between them, the last slice ends in padding) equals the
    replicated bucket's step over whole keys to the bit, three steps in
    a row."""
    from mxnet_tpu_torch import optim_rules
    from mxnet_tpu_torch.kvstore_fused import _Bucket, _slice_update

    nslots, multi = optim_rules.multi_rule(rule, params)
    g = torch.Generator(device="cpu").manual_seed(7)
    shapes, lrs, wds = [(64, 33), (17,), (8, 4, 3)], [0.1, 0.05, 0.2], \
        [params["wd"], 0.0, 2 * params["wd"]]
    sizes = [int(np.prod(s)) for s in shapes]
    ws = [torch.randn(s, generator=g).to(card) for s in shapes]
    st = [[torch.rand(s, generator=g).to(card) for _ in range(nslots)]
          for s in shapes]
    bs = []
    for r in range(2):
        b = _Bucket(torch.float32)
        b.keys, b.sizes = [0, 1, 2], sizes
        b.offsets = [0, sizes[0], sizes[0] + sizes[1]]
        b.shard_n, b.padded = 2, -(-sum(sizes) // 2) * 2
        b.lo = r * b.padded // 2
        bs.append(b)
    pad = bs[0].padded - sum(sizes)

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts]
                         + [ts[0].new_zeros(pad)])

    fw = flat(ws)
    fs = [flat([st[i][j] for i in range(len(shapes))])
          for j in range(nslots)]
    for _ in range(3):
        gs = [torch.randn(s, generator=g).to(card) for s in shapes]
        gflat = flat(gs)
        for b in bs:
            sl = slice(b.lo, b.lo + b.padded // 2)
            _slice_update(b, multi, gflat[sl].clone(), fw[sl],
                          [f[sl] for f in fs], dict(enumerate(lrs)),
                          dict(enumerate(wds)))
        merged = gflat[:sum(sizes)].clone()  # the bucket's scratch
        multi(merged, ws, [x.view(s) for x, s in
                           zip(merged.split(sizes), shapes)],
              [tuple(s) for s in st], lrs, wds)
        assert torch.equal(fw, flat(ws))
        for j in range(nslots):
            assert torch.equal(fs[j], flat([st[i][j]
                                             for i in range(len(shapes))]))


def test_group2ctx_card_and_host_groups_equal_the_unplaced_graph(card):
    """``group2ctx={'card': gpu(0), 'host': cpu()}``: a FullyConnected on
    the card whose 64 MB output crosses to exactly rounded host ops
    (``relu(fc) * s + s``), forward and backward, equals the graph bound
    on the card without groups to the bit.  A crossing that returned
    before the card's values reached the host would hand the host ops an
    unfilled buffer; torch 2.11's copy to the host returns after the
    values arrive even when asked not to wait, so there this holds the
    split's numbers, and the crossing's choice is pinned on the CPU
    (``test_copies_onto_a_card_do_not_wait_and_onto_the_host_block``)."""
    import mxnet_tpu_torch as mx

    n, d, h = 4096, 2048, 4096

    def run(group2ctx):
        data = mx.sym.Variable("data")
        with mx.AttrScope(ctx_group="card"):
            fc = mx.sym.FullyConnected(data, num_hidden=h, name="fc")
        with mx.AttrScope(ctx_group="host"):
            s = mx.sym.Variable("s")
            net = mx.sym.Activation(fc, act_type="relu") * s + s
        ex = net.simple_bind(mx.gpu(0), group2ctx=group2ctx, data=(n, d),
                             s=(n, h))
        g = torch.Generator().manual_seed(0)
        for k in sorted(ex.arg_dict):
            ex.arg_dict[k].copy_(torch.randn(ex.arg_dict[k].shape,
                                             generator=g))
        ex.forward(is_train=True)
        out = ex.outputs[0]
        ex.backward([torch.ones(out.shape, device=out.device)])
        return out, dict(ex.grad_dict)

    out_p, grads_p = run({"card": mx.gpu(0), "host": mx.cpu()})
    out_s, grads_s = run(None)
    assert out_p.device.type == "cpu" and grads_p["s"].device.type == "cpu"
    assert grads_p["fc_weight"].device.type == "cuda"
    assert torch.equal(out_p, out_s.cpu())
    for k in grads_s:
        assert torch.equal(grads_p[k].cpu(), grads_s[k].cpu()), k


def test_collective_store_at_world_one_on_the_card(card, monkeypatch):
    """``kv.create("dist_sync")`` without servers in one process is the
    collective store at world 1: its bucketed pushes on the card equal
    the ``device`` store's to the bit."""
    import mxnet_tpu_torch as mx

    for k in ("MXTPU_PS_SERVERS", "MXTPU_NUM_WORKERS", "MXTPU_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    outs = {}
    for name in ("dist_sync", "device"):
        kv = mx.kv.create(name)
        kv.set_optimizer(mx.optimizer.create("adam", learning_rate=0.01,
                                             rescale_grad=0.5))
        g = torch.Generator(device="cpu").manual_seed(3)
        keys = list(range(5))
        kv.init(keys, [tnd.NDArray(torch.randn(32, 16, generator=g).to(card))
                       for _ in keys])
        out = [tnd.NDArray(torch.zeros(32, 16, device=card)) for _ in keys]
        for _ in range(3):
            kv.push(keys, [[tnd.NDArray(torch.randn(32, 16, generator=g)
                                        .to(card))] for _ in keys])
            kv.pull(keys, out)
        outs[name] = [o.tensor for o in out]
        if name == "dist_sync":
            assert kv.collective and kv.num_workers == 1
    for a, b in zip(outs["dist_sync"], outs["device"]):
        assert torch.equal(a, b)
