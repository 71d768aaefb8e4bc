"""``KVDecoder.generate_scan`` and ``KVDecoder.beam_search`` of the port
against the JAX package's, on the CPU (``tests/test_decode.py:78-190``
mirrored, each case also held against the JAX decoder).

Same numpy-seeded checkpoint in both packages: 2 layers, 2 heads,
d_model 64, vocab 256, max_len 128.  Greedy and beam tokens must be
equal; beam scores (sums of fp32 log-probabilities of logits that agree
to ~1e-7) within 1e-4.  Sampling draws from different generators
(threefry against Philox), so it is compared by statistics: the
empirical first-token distribution of 4000 rows against the softmax of
the JAX decoder's logits, within 4 standard errors per token.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.models.decode import KVDecoder as JaxDecoder

from mxnet_tpu_torch.models import decode as tdecode
from mxnet_tpu_torch.models.decode import KVDecoder

L, H, D, T, V = 2, 2, 64, 128, 256
SCORE_TOL = 1e-4


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
def decs(lm_params):
    return (JaxDecoder(lm_params, num_layers=L, num_heads=H, max_len=T),
            KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                      device="cpu"))


def _prompt(shape, seed=1):
    return np.random.RandomState(seed).randint(0, V, shape)


# ------------------------------------------------------------ beam_search
def test_beam_search_beam1_matches_greedy(decs):
    jd, td = decs
    prompt = _prompt((2, 4))
    greedy = td.generate(prompt, 6, temperature=0)
    beam, scores = td.beam_search(prompt, 6, beam_size=1)
    assert beam.shape == (2, 1, 6) and scores.shape == (2, 1)
    np.testing.assert_array_equal(beam[:, 0], greedy)
    jbeam, jscores = jd.beam_search(prompt, 6, beam_size=1)
    np.testing.assert_array_equal(beam, jbeam)
    np.testing.assert_allclose(scores, jscores, atol=SCORE_TOL)


def test_beam_search_widening_never_hurts_best_score(decs):
    jd, td = decs
    prompt = _prompt((1, 3), seed=2)
    _, s1 = td.beam_search(prompt, 5, beam_size=1)
    t4, s4 = td.beam_search(prompt, 5, beam_size=4)
    assert s4[0, 0] >= s1[0, 0] - 1e-5
    assert (np.diff(s4[0]) <= 1e-6).all()        # sorted best-first
    j4, js4 = jd.beam_search(prompt, 5, beam_size=4)
    np.testing.assert_array_equal(t4, j4)
    np.testing.assert_allclose(s4, js4, atol=SCORE_TOL)


@pytest.mark.parametrize("length_penalty", [0.0, 1.0])
def test_beam_search_eos_finishes_and_pads(decs, length_penalty):
    """The greedy first token made the eos: one beam finishes at once
    and comes back eos-padded with its one-token score frozen — the best
    beam without a length penalty, since log-probabilities only subtract
    — and the port equals the JAX package beam for beam."""
    jd, td = decs
    prompt = _prompt((1, 3), seed=3)
    base, base_scores = td.beam_search(prompt, 5, beam_size=2)
    eos = int(base[0, 0, 0])
    toks, scores = td.beam_search(prompt, 5, beam_size=2, eos_id=eos,
                                  length_penalty=length_penalty)
    assert toks.shape == (1, 2, 5)
    assert any((toks[0, b] == eos).all() for b in range(2))
    if not length_penalty:
        assert (toks[0, 0] == eos).all()
        assert scores[0, 0] > base_scores[0, 0]
    jtoks, jscores = jd.beam_search(prompt, 5, beam_size=2, eos_id=eos,
                                    length_penalty=length_penalty)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_allclose(scores, jscores, atol=SCORE_TOL)


def test_beam_search_batch_and_reorder_match_jax(decs):
    """Two rows, four beams, long enough that the beams reorder the
    device cache many times."""
    jd, td = decs
    prompt = _prompt((2, 5), seed=4)
    t, s = td.beam_search(prompt, 12, beam_size=4)
    j, js = jd.beam_search(prompt, 12, beam_size=4)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(s, js, atol=SCORE_TOL)
    assert (np.diff(s, axis=1) <= 1e-6).all()


def test_beam_search_rejects_oversized_beam_and_budget(decs):
    _, td = decs
    with pytest.raises(ValueError, match="beam_size"):
        td.beam_search(_prompt((1, 2)), 3, beam_size=V + 1)
    with pytest.raises(ValueError, match="exceeds max_len"):
        td.beam_search(_prompt((1, 2)), T, beam_size=2)
    toks, scores = td.beam_search(_prompt((2, 2)), 0, beam_size=3)
    assert toks.shape == (2, 3, 0) and scores.shape == (2, 3)


# ---------------------------------------------------------- generate_scan
def test_generate_scan_matches_generate_greedy(decs):
    jd, td = decs
    prompt = _prompt((2, 4), seed=5)
    n = 9
    ref = td.generate(prompt, n, temperature=0.0)
    got = td.generate_scan(prompt, n, temperature=0.0)
    np.testing.assert_array_equal(got, ref)
    assert td.last_scan_syncs == 1              # one read, at the end
    np.testing.assert_array_equal(got, jd.generate_scan(prompt, n))
    # sampled: right shape and range, deterministic per seed
    s1 = td.generate_scan(prompt, n, temperature=1.0, top_k=5, seed=3)
    s2 = td.generate_scan(prompt, n, temperature=1.0, top_k=5, seed=3)
    assert s1.shape == (2, n) and (s1 >= 0).all() and (s1 < V).all()
    np.testing.assert_array_equal(s1, s2)
    # one token: no loop at all
    np.testing.assert_array_equal(td.generate_scan(prompt, 1), ref[:, :1])
    assert td.generate_scan(prompt, 0).shape == (2, 0)


@pytest.mark.parametrize("n", [8, 40])
def test_generate_scan_eos_early_exit(decs, n):
    """eos rows freeze to eos padding; the output agrees with the no-eos
    run up to each row's first eos, equals the JAX package's, and the
    loop checks ``done.all()`` on the host once every
    ``SCAN_EOS_CHECK`` tokens at most."""
    jd, td = decs
    prompt = _prompt((3, 3), seed=6)
    free = td.generate_scan(prompt, n, temperature=0.0)
    eos = int(free[0, 2])
    got = td.generate_scan(prompt, n, temperature=0.0, eos_id=eos)
    assert got.shape == free.shape
    for r in range(free.shape[0]):
        hits = np.where(free[r] == eos)[0]
        cut = (hits[0] + 1) if len(hits) else n
        np.testing.assert_array_equal(got[r, :cut], free[r, :cut])
        assert (got[r, cut:] == eos).all()
    np.testing.assert_array_equal(
        got, jd.generate_scan(prompt, n, temperature=0.0, eos_id=eos))
    checks = -(-(n - 1) // tdecode.SCAN_EOS_CHECK)
    assert 2 <= td.last_scan_syncs <= 1 + checks
    # the sampled eos loop keeps the no-eos run's prefix property
    s_free = td.generate_scan(prompt, n, temperature=0.8, seed=5)
    s_eos = int(s_free[1, 1])
    s_got = td.generate_scan(prompt, n, temperature=0.8, seed=5,
                             eos_id=s_eos)
    for r in range(s_free.shape[0]):
        hits = np.where(s_free[r] == s_eos)[0]
        cut = (hits[0] + 1) if len(hits) else n
        np.testing.assert_array_equal(s_got[r, :cut], s_free[r, :cut])
        assert (s_got[r, cut:] == s_eos).all()


def test_generate_scan_exits_early_when_every_row_ends(decs):
    """Every row's first token is the eos: the loop stops at its first
    check and the rest is eos padding."""
    _, td = decs
    prompt = np.repeat(_prompt((1, 4), seed=7), 2, axis=0)
    eos = int(td.generate(prompt, 1, temperature=0)[0, 0])
    out = td.generate_scan(prompt, 60, temperature=0.0, eos_id=eos)
    assert (out == eos).all()
    assert td.last_scan_syncs == 2


@pytest.mark.parametrize("top_k", [None, 8])
def test_generate_scan_sampling_statistics(decs, top_k):
    """4000 copies of one prompt, one sampled token each: the empirical
    distribution against ``softmax(logits / 0.7)`` (after the top-k cut)
    of the JAX decoder's logits, within 4 standard errors per token, and
    nothing outside the top k."""
    jd, td = decs
    B, temp = 4000, 0.7
    prompt = np.repeat(_prompt((1, 3), seed=8), B, axis=0)
    toks = td.generate_scan(prompt, 1, temperature=temp, top_k=top_k,
                            seed=11)[:, 0]
    _, jl = jd.prefill(prompt[:1])
    lg = np.asarray(jl, np.float64)[0, -1] / temp
    if top_k:
        kth = np.sort(lg)[-top_k]
        assert set(np.unique(toks)) <= set(np.flatnonzero(lg >= kth))
        lg = np.where(lg < kth, -np.inf, lg)
    p = np.exp(lg - lg.max())
    p /= p.sum()
    freq = np.bincount(toks, minlength=V) / B
    se = np.sqrt(p * (1 - p) / B)
    assert (np.abs(freq - p) <= 4 * se + 1e-3).all()
