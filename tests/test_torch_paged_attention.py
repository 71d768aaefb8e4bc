"""The port's paged decode attention against the JAX package, on the CPU.

On CPU tensors ``mxnet_tpu_torch.ops.paged_attention`` runs its plain
version; it must match both the JAX gather math and the JAX Pallas
kernel run in interpret mode, to 1e-5 in fp32 (scores of order 1 summed
over at most 64 positions: fp32 reassociation stays near 1e-7).  The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import paged_attention as jpa

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import paged_attention as tpa

ATOL = 1e-5
INTERPRET = {"impl": "pallas", "grid": "bh", "live_only": True,
             "interpret": True}


def _case(B, H, M, block, dh, L, cursors, seed=3):
    rs = np.random.RandomState(seed)
    P = B * M + 1
    pool_k = rs.normal(size=(P, L, H, block, dh)).astype(np.float32)
    pool_v = rs.normal(size=(P, L, H, block, dh)).astype(np.float32)
    q = rs.normal(size=(B, H, 1, dh)).astype(np.float32)
    bt = rs.permutation(np.arange(1, P))[:B * M].reshape(B, M) \
        .astype(np.int32)
    cursor = np.asarray(cursors, np.int32)
    return q, pool_k, pool_v, bt, cursor


def _jax(sched, args, layer, block):
    import jax.numpy as jnp

    f = jax.jit(lambda *a: jpa.paged_attention(
        *a, layer, block=block, schedule=sched))
    return np.asarray(f(*[jnp.asarray(a) for a in args]))


def _torch(args, layer, block):
    out = tpa.paged_attention(*[torch.from_numpy(a) for a in args], layer,
                              block=block)
    return out.numpy()


# (block, dh, M, cursors): ragged cursors, page boundaries, 0 and the
# last position of the table
CASES = [
    (8, 32, 4, [1, 15, 31]),
    (8, 64, 4, [0, 7, 8, 31]),
    (16, 32, 2, [0, 15, 16, 31]),
    (8, 16, 8, [63, 2, 40]),
]


@pytest.mark.parametrize("block,dh,M,cursors", CASES)
def test_plain_matches_jax_gather(block, dh, M, cursors):
    args = _case(len(cursors), 2, M, block, dh, 2, cursors)
    for layer in range(2):
        np.testing.assert_allclose(_torch(args, layer, block),
                                   _jax(None, args, layer, block),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("block,dh,M,cursors", CASES[:3])
def test_plain_matches_pallas_interpret(block, dh, M, cursors):
    args = _case(len(cursors), 2, M, block, dh, 2, cursors, seed=11)
    np.testing.assert_allclose(_torch(args, 1, block),
                               _jax(INTERPRET, args, 1, block),
                               atol=ATOL, rtol=0)


def test_gather_tables_matches_jax():
    q, pk, _pv, bt, _c = _case(3, 2, 4, 8, 16, 3, [1, 2, 3])
    ref = np.asarray(jpa.gather_tables(pk, bt, 8))
    got = tpa.gather_tables(torch.from_numpy(pk), torch.from_numpy(bt), 8)
    assert np.array_equal(got.numpy(), ref)
    one = tpa.gather_tables(torch.from_numpy(pk), torch.from_numpy(bt), 8,
                            layer=2)
    assert np.array_equal(one.numpy(), ref[2])


@pytest.mark.parametrize("block,dh,dtype,ok", [
    (8, 32, torch.float32, True),
    (16, 128, torch.bfloat16, True),
    (16, 256, torch.float32, True),
    (4, 32, torch.float32, False),      # block % 8
    (8, 12, torch.float32, False),      # dh % 8
    (8, 264, torch.float32, False),     # dh > MAX_DH (the CUDA limit)
    (8, 32, torch.float16, False),      # dtype
])
def test_supports_gate(block, dh, dtype, ok):
    assert tpa.supports(block, dh, dtype) is ok
    if dh <= tpa.MAX_DH and dtype is not torch.float16:
        # the JAX gate agrees wherever the CUDA kernel adds no limit
        jdt = np.float32 if dtype is torch.float32 else jax.numpy.bfloat16
        assert jpa.supports(block, dh, jdt) is ok


@pytest.mark.parametrize("block,dh,dtype,context,match", [
    (4, 32, torch.float32, 64, "block=4"),
    (8, 264, torch.float32, 64, "dh=264"),
    (8, 32, torch.float16, 64, "dtype=torch.float16"),
    (8, 32, torch.float32, tpa.MAX_CONTEXT + 8, "MAX_CONTEXT"),
])
def test_require_names_the_limit(block, dh, dtype, context, match):
    with pytest.raises(MXNetError, match=match):
        tpa.require(block, dh, dtype, context)
    tpa.require(8, 32, torch.bfloat16, tpa.MAX_CONTEXT)


def test_decoder_attends_through_the_plain_version_in_bf16():
    """One plain attention on every path: the decoder's contiguous
    attention and the kernel's plain version give the same bf16 bits on
    the same table (both fp32 inside, rounded once)."""
    from types import SimpleNamespace

    from mxnet_tpu_torch.models.decode import KVDecoder

    q, pk, pv, bt, cursor = [torch.from_numpy(a) for a in
                             _case(3, 2, 4, 8, 32, 1, [0, 9, 31], seed=5)]
    q, pk, pv = (t.to(torch.bfloat16) for t in (q, pk, pv))
    paged = tpa._gather_attention(q, pk, pv, bt, cursor, 0, 8)
    kc = tpa.gather_tables(pk, bt, 8, 0)
    vc = tpa.gather_tables(pv, bt, 8, 0)
    valid = torch.arange(32)[None, :] <= cursor[:, None]
    ctx = KVDecoder._attend(SimpleNamespace(d_model=64), q, kc, vc,
                            valid[:, None, None, :])
    assert ctx.dtype == torch.bfloat16
    assert torch.equal(ctx, paged.transpose(1, 2).reshape(3, 1, 64))


def test_cpu_tensors_take_the_plain_version_without_launching():
    args = _case(2, 2, 2, 8, 16, 1, [3, 9])
    tpa.reset_launch_count()
    _torch(args, 0, 8)
    assert tpa.launch_count() == 0


def test_bf16_plain_uses_bf16_scale():
    """sqrt(128) rounds to 11.3125 in bf16 — the JAX math's scale."""
    assert tpa._scale(128, torch.bfloat16) == 11.3125
    assert tpa._scale(128, torch.float32) == pytest.approx(11.3137085)


@pytest.mark.parametrize("M,block", [(64, 16), (128, 8), (16, 32),
                                     (3072, 16), (1, 8), (7, 24), (4, 256)])
def test_split_takes_whole_pages_covering_the_table(M, block):
    pages, n_split = tpa.split_of(M, block)
    assert 1 <= pages <= tpa.MAX_CHUNK_PAGES
    assert (n_split - 1) * pages < M <= n_split * pages
    assert pages == 1 or (pages * block <= tpa.SPLIT_POSITIONS
                          < (pages + 1) * block)


def _split_merge(args, layer, block):
    """The CUDA kernel's split, in numpy fp32: each chunk of
    ``split_of``'s whole pages gives (acc, m, l) over its live positions,
    and the chunks merge in chunk order, as the combine kernel does."""
    q, pk, pv, bt, cursor = args
    B, H, _, dh = q.shape
    M = bt.shape[1]
    pages, n_split = tpa.split_of(M, block)
    chunk = pages * block
    scale = np.sqrt(np.float32(dh))
    out = np.empty_like(q)
    for b in range(B):
        n_pos = min(max(int(cursor[b]) + 1, 1), M * block)
        kc, vc = (t[bt[b], layer].transpose(1, 0, 2, 3)
                  .reshape(H, M * block, dh) for t in (pk, pv))
        parts = []
        for c in range(n_split):
            lo, hi = c * chunk, min((c + 1) * chunk, n_pos)
            if lo >= n_pos:
                break
            s = np.einsum("hd,hsd->hs", q[b, :, 0], kc[:, lo:hi]) / scale
            m = s.max(-1)
            p = np.exp(s - m[:, None])
            parts.append((np.einsum("hs,hsd->hd", p, vc[:, lo:hi]), m,
                          p.sum(-1)))
        mx = np.max([m for _, m, _ in parts], axis=0)
        acc = sum(a * np.exp(m - mx)[:, None] for a, m, _ in parts)
        tot = sum(l * np.exp(m - mx) for _, m, l in parts)
        out[b, :, 0] = acc / tot[:, None]
    return out


# tables of 3 chunks; cursors on and beside the chunk boundaries, the
# last position and one past the table
@pytest.mark.parametrize("block,M,cursors", [
    (8, 48, [0, 126, 127, 128, 255, 383, 500]),
    (32, 10, [127, 128, 200, 319]),
])
def test_split_merge_matches_jax_gather(block, M, cursors):
    args = _case(len(cursors), 2, M, block, 32, 2, cursors, seed=5)
    for layer in range(2):
        np.testing.assert_allclose(_split_merge(args, layer, block),
                                   _jax(None, args, layer, block),
                                   atol=ATOL, rtol=0)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.nvcc_path()


def test_nvcc_command_targets_sm90a(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    cmd = _build.nvcc_command(_build.source_path("paged_attention"), "x.so")
    assert cmd[0] == str(fake)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3"} <= set(cmd)
    assert os.path.isfile(cmd[-1])


def test_build_report_is_kept_beside_the_library(monkeypatch, tmp_path):
    """The compiler's report is written beside the library and read back
    when a later process finds the library built."""
    script = ("import sys; open(sys.argv[1], 'w').write('lib'); "
              "print('ptxas info    : Used 7 registers')")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_command",
                        lambda src, out: [sys.executable, "-c", script, out])
    monkeypatch.setattr(_build, "build_logs", {})
    _build._compile(["paged_attention"])
    report = _build.build_logs["paged_attention"]
    assert "Used 7 registers" in report
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".log", ".so"]
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "nvcc_command", None)   # nothing to build
    _build._compile(["paged_attention"])
    assert _build.build_logs["paged_attention"] == report
