"""The port's autotuner against the JAX package's, on the CPU.

Mirrors ``tests/test_autotune.py`` for ``mxnet_tpu_torch.autotune``: the
schedule cache's round trip, corrupt and mismatched files, readonly mode
never writing, device-kind segregation, the trial budget with the
``autotune_*`` counters and the fingerprint epoch.  Across the packages:
a cache file one package writes on the CPU loads in the other under the
same ``"cpu"`` kind, and the port's epilogue ignores the reference's
``block_rows`` schedule; ``keysig`` and the gather/pagewalk candidates
equal the reference's.  ``PagedSlots`` in search mode on the CPU picks
among gather and pagewalk, and its greedy tokens equal the JAX gather
backend's on the same seeded decoder.  The CUDA candidates (the
kernel's splits, the epilogue's launch schedules) are measured on the
card by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autotune as jat
from mxnet_tpu import models
from mxnet_tpu.models.decode import KVDecoder as JaxDecoder
from mxnet_tpu.ops import paged_attention as jpa
from mxnet_tpu.ops import residual_epilogue as jre
from mxnet_tpu.serving.paged_kv import PagedSlots as JaxPagedSlots

from mxnet_tpu_torch import autotune as at
from mxnet_tpu_torch.autotune import search
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.executor import simple_bind
from mxnet_tpu_torch.models.decode import KVDecoder
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.ops import residual_epilogue as tre
from mxnet_tpu_torch.serving.paged_kv import PagedSlots
from mxnet_tpu_torch.serving.scheduler import SlotScheduler
from mxnet_tpu_torch import symbol as tsym

L, H, D, T, V = 2, 2, 32, 32, 17


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def lm_params():
    net = models.transformer.transformer_lm(
        num_layers=L, num_heads=H, d_model=D, seq_len=T, vocab_size=V)
    ex = net.simple_bind(ctx=mx.cpu(), grad_req="null",
                         data=(1, T), softmax_label=(1, T))
    rs = np.random.RandomState(0)
    params = {}
    for name, arr in ex.arg_dict.items():
        if name in ("data", "softmax_label"):
            continue
        arr[:] = rs.normal(0, 0.08, arr.shape).astype(np.float32)
        params[name] = arr
    return params


@pytest.fixture(scope="module")
def tdec(lm_params):
    return KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                     device="cpu")


@pytest.fixture()
def metrics():
    was = tm.enabled()
    tm.enable()
    yield tm.get_registry()
    if not was:
        tm.disable()


def _reset_both():
    at.reset()
    jat.reset()


@pytest.fixture()
def no_cache(monkeypatch):
    monkeypatch.delenv("MXTPU_SCHEDULE_CACHE", raising=False)
    monkeypatch.delenv("MXTPU_PAGED_KERNEL", raising=False)
    _reset_both()
    yield
    _reset_both()


@pytest.fixture()
def sched_cache(tmp_path, monkeypatch):
    """A private search-mode schedule cache; both packages reset."""
    path = str(tmp_path / "schedules.json")
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE", "search:" + path)
    monkeypatch.delenv("MXTPU_PAGED_KERNEL", raising=False)
    monkeypatch.delenv("MXTPU_AUTOTUNE_TRIALS", raising=False)
    _reset_both()
    yield path
    _reset_both()


def _const_bench(calls=None):
    def bench(cand):
        if calls is not None:
            calls.append(cand)
        return lambda: 0.0
    return bench


# ---------------------------------------------------------------------------
# cache plane (tests/test_autotune.py's cases)
# ---------------------------------------------------------------------------
def test_cache_roundtrip_persists_and_reloads(sched_cache):
    won = at.ensure("k", "sig", {"impl": "a"},
                    [{"impl": "a"}, {"impl": "b"}], _const_bench(),
                    warmup=0, best_of=1)
    assert won["impl"] in ("a", "b")
    doc = json.load(open(sched_cache))
    assert doc["version"] == at.SCHEMA_VERSION == jat.SCHEMA_VERSION
    ent = doc["entries"][at.device_kind()]["k|sig"]
    assert ent["schedule"] == won and ent["trials"] == 2
    assert ent["best_us"] >= 0
    at.reset()
    assert at.schedule_for("k", "sig", "DEFAULT") == "DEFAULT", \
        "an unprimed lookup stays a pure default read"
    at.fingerprint()                       # the executor bind's priming
    assert at.schedule_for("k", "sig", "DEFAULT") == won
    calls = []
    again = at.ensure("k", "sig", {"impl": "a"},
                      [{"impl": "a"}, {"impl": "b"}], _const_bench(calls),
                      warmup=0, best_of=1)
    assert again == won and calls == []


def test_corrupt_and_mismatched_files_fall_back(tmp_path, monkeypatch):
    good = {"version": at.SCHEMA_VERSION,
            "entries": {"cpu": {"k|s": {"schedule": {"impl": "x"}}}}}
    for name, text in [("garbage.json", "{not json"),
                       ("wrong_version.json",
                        json.dumps(dict(good, version=999))),
                       ("wrong_shape.json", json.dumps([1, 2, 3]))]:
        p = tmp_path / name
        p.write_text(text)
        assert at.load_file(str(p)) == {} == jat.load_file(str(p)), name
    assert at.load_file(str(tmp_path / "missing.json")) == {}
    p = tmp_path / "corrupt.json"
    p.write_text("{not json")
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE", "search:%s" % p)
    at.reset()
    at.fingerprint()
    assert at.schedule_for("k", "s", "DEFAULT") == "DEFAULT"
    at.ensure("k", "s", {"impl": "a"}, [{"impl": "a"}], _const_bench(),
              warmup=0, best_of=1)
    assert json.load(open(p))["version"] == at.SCHEMA_VERSION
    at.reset()


def test_readonly_never_writes(tmp_path, monkeypatch):
    path = tmp_path / "ro.json"
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE", "readonly:%s" % path)
    at.reset()
    calls = []
    got = at.ensure("k", "sig", {"impl": "default"},
                    [{"impl": "default"}, {"impl": "other"}],
                    _const_bench(calls), warmup=0, best_of=1)
    assert got == {"impl": "default"} and calls == []
    assert not path.exists()
    at.record("k", "sig", {"impl": "other"}, 1.0, 1)
    assert not path.exists()
    doc = {"version": at.SCHEMA_VERSION,
           "entries": {at.device_kind(): {
               "k|sig": {"schedule": {"impl": "pinned"},
                         "best_us": 1.0, "trials": 1}}}}
    path.write_text(json.dumps(doc))
    before = path.read_bytes()
    at.reset()
    got = at.ensure("k", "sig", {"impl": "default"}, [{"impl": "default"}],
                    _const_bench(calls), warmup=0, best_of=1)
    assert got == {"impl": "pinned"} and calls == []
    assert path.read_bytes() == before
    at.reset()


def test_device_kind_segregation(tmp_path, monkeypatch):
    kind = at.device_kind()
    other = "NVIDIA_H100_80GB_HBM3" if kind == "cpu" else "cpu"
    path = tmp_path / "mixed.json"
    path.write_text(json.dumps({
        "version": at.SCHEMA_VERSION,
        "entries": {
            kind: {"k|sig": {"schedule": {"impl": "mine"}}},
            other: {"k|sig": {"schedule": {"impl": "theirs"}},
                    "k2|sig": {"schedule": {"impl": "theirs"}}},
        }}))
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE", "search:%s" % path)
    at.reset()
    at.fingerprint()
    assert at.schedule_for("k", "sig", None) == {"impl": "mine"}
    assert at.schedule_for("k2", "sig", "DEFAULT") == "DEFAULT"
    at.ensure("k3", "sig", {"impl": "a"}, [{"impl": "a"}], _const_bench(),
              warmup=0, best_of=1)
    entries = json.load(open(path))["entries"]
    assert entries[other]["k|sig"]["schedule"] == {"impl": "theirs"}
    assert "k3|sig" in entries[kind]
    at.reset()


def test_trial_budget_and_telemetry(sched_cache, monkeypatch, metrics):
    monkeypatch.setenv("MXTPU_AUTOTUNE_TRIALS", "2")
    assert at.trials_budget() == 2
    trials = metrics.get("autotune_trials_total")
    cachec = metrics.get("autotune_cache_total")
    t0, h0, m0 = (trials.total(), cachec.value(result="hit"),
                  cachec.value(result="miss"))
    calls = []
    cands = [{"impl": "c%d" % i} for i in range(5)]
    won = at.ensure("budgeted", "sig", cands[0], cands,
                    _const_bench(calls), warmup=0, best_of=1)
    assert len(calls) == 2 and won in cands[:2]
    assert trials.total() - t0 == 2
    assert cachec.value(result="miss") - m0 == 1
    assert metrics.get("autotune_best_us").samples()
    calls.clear()
    again = at.ensure("budgeted", "sig", cands[0], cands,
                      _const_bench(calls), warmup=0, best_of=1)
    assert again == won and calls == []
    assert trials.total() - t0 == 2
    assert cachec.value(result="hit") - h0 == 1
    monkeypatch.setenv("MXTPU_AUTOTUNE_TRIALS", "0")
    assert at.ensure("budgeted", "sig", cands[0], cands,
                     _const_bench(calls), warmup=0, best_of=1) == won
    got = at.ensure("never_searched", "sig", {"impl": "d"}, cands,
                    _const_bench(calls), warmup=0, best_of=1)
    assert got == {"impl": "d"} and calls == []


def test_fingerprint_epoch_invalidates_on_record(sched_cache):
    fp0 = at.fingerprint()
    at.record("k", "sig", {"impl": "a"}, 1.0, 1)
    fp1 = at.fingerprint()
    assert fp0 != fp1 and fp0[:2] == fp1[:2]


def test_ensure_raises_after_the_gate_and_skips_what_it_refuses(
        sched_cache):
    """Only a candidate its gate refuses before launch is skipped; a
    candidate that fails when it runs is a fault and raises (the JAX
    package skips both)."""
    def bench(cand):
        if cand["impl"] == "refused":
            raise at.ScheduleRejected("the gate says no")
        if cand["impl"] == "broken":
            def run():
                raise RuntimeError("launch failed")
            return run
        return lambda: 0.0

    got = at.ensure("gated", "sig", {"impl": "ok"},
                    [{"impl": "refused"}, {"impl": "ok"}], bench,
                    warmup=0, best_of=1)
    assert got == {"impl": "ok"}
    assert at.ensure("all_refused", "sig", {"impl": "d"},
                     [{"impl": "refused"}], bench, warmup=0,
                     best_of=1) == {"impl": "d"}
    with pytest.raises(RuntimeError, match="launch failed"):
        at.ensure("faulty", "sig", {"impl": "ok"},
                  [{"impl": "ok"}, {"impl": "broken"}], bench, warmup=0,
                  best_of=1)


def test_ensure_keeps_the_default_inside_its_spread(sched_cache,
                                                    monkeypatch):
    """A candidate replaces the measured default only by beating the
    default's best by more than its spread (median less best)."""
    times = {"d": [10.0, 12.0, 14.0], "near": [9.0, 9.0, 9.0],
             "far": [7.0, 7.5, 8.0]}
    monkeypatch.setattr(search, "_timings",
                        lambda fn, warmup, best_of: fn())

    def bench(cand):
        return lambda: times[cand["impl"]]

    d, near, far = ({"impl": k} for k in ("d", "near", "far"))
    assert at.ensure("noise", "sig", d, [d, near], bench) == d
    assert at.ensure("gain", "sig", d, [near, d, far], bench) == far
    # without the default among the candidates: the plain minimum
    assert at.ensure("nodef", "sig", d, [near, far], bench) == far


def test_ensure_does_not_take_a_cached_winner_it_refuses(sched_cache,
                                                         tmp_path,
                                                         monkeypatch):
    """A cached schedule ``accept`` refuses is a miss: search mode
    searches the candidates, readonly mode keeps the default."""
    calls = []
    at.record("k", "sig", {"impl": "plain"}, 1.0, 1)
    got = at.ensure("k", "sig", {"impl": "kern"}, [{"impl": "kern"}],
                    _const_bench(calls), warmup=0, best_of=1,
                    accept=lambda s: s["impl"] == "kern")
    assert got == {"impl": "kern"} and calls == [{"impl": "kern"}]
    assert at.schedule_for("k", "sig", None) == {"impl": "kern"}
    ro = tmp_path / "ro.json"
    ro.write_text(json.dumps({"version": at.SCHEMA_VERSION, "entries": {
        at.device_kind(): {"k|sig": {"schedule": {"impl": "plain"},
                                     "best_us": 1.0, "trials": 1}}}}))
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE", "readonly:%s" % ro)
    at.reset()
    calls.clear()
    assert at.ensure("k", "sig", {"impl": "kern"}, [{"impl": "kern"}],
                     _const_bench(calls),
                     accept=lambda s: s["impl"] == "kern") == {"impl": "kern"}
    assert calls == []
    assert at.ensure("k", "sig", {"impl": "kern"}, [{"impl": "kern"}],
                     _const_bench(calls)) == {"impl": "plain"}


def test_cache_off_never_counts(no_cache, metrics):
    calls = []
    t0 = metrics.get("autotune_cache_total").total()
    assert at.ensure("k", "s", {"impl": "d"}, [{"impl": "x"}],
                     _const_bench(calls)) == {"impl": "d"}
    assert calls == [] and at.cache_spec() == ("off", None)
    assert metrics.get("autotune_cache_total").total() == t0


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def test_device_kind_is_the_references_on_the_cpu(no_cache):
    assert at.device_kind() == jat.device_kind() == "cpu"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_file_crosses_packages(sched_cache, writer):
    """A cache one package writes on the CPU loads in the other under
    the same kind, keys and schedules."""
    w, r = (jat, at) if writer == "jax" else (at, jat)
    won = w.ensure("paged_attention", "b3h2m4k8d16_float32",
                   {"impl": "gather"},
                   [{"impl": "gather"}, {"impl": "pagewalk", "chunk": 2}],
                   _const_bench(), warmup=0, best_of=1)
    r.reset()
    r.fingerprint()
    assert r.schedule_for("paged_attention", "b3h2m4k8d16_float32",
                          None) == won
    doc = json.load(open(sched_cache))
    assert list(doc["entries"]) == ["cpu"]


def test_epilogue_ignores_the_references_block_rows(sched_cache):
    """The JAX package tunes ``block_rows`` (interpreted on the CPU) into
    the shared cache; the port's kernel cannot read that schedule and
    keeps its default launch."""
    won = jre.tune(64, 128)
    assert "block_rows" in won
    at.fingerprint()
    assert at.schedule_for("residual_epilogue", tre._keysig(
        64, 128, torch.float32), None) == won
    assert tre._schedule_for(64, 128, torch.float32) == tre.DEFAULT_SCHEDULE
    # the port's tune() on the CPU records nothing over it
    assert tre.tune(64, 128) == tre.DEFAULT_SCHEDULE
    ent = json.load(open(sched_cache))["entries"]["cpu"]
    assert ent["residual_epilogue|r64c128_float32"]["schedule"] == won


def test_epilogue_schedules_and_keysig(no_cache):
    assert tre._keysig(100352, 256, torch.bfloat16) == \
        "r100352c256_bfloat16"
    assert tre._keysig(64, 128, torch.float32) == "r64c128_float32"
    cands = tre.candidate_schedules()
    assert tre.DEFAULT_SCHEDULE in cands and len(cands) == 12
    assert {c["threads"] for c in cands} == {128, 256, 512}
    assert tre.tune(60, 100) == tre.DEFAULT_SCHEDULE   # not supported


@pytest.mark.parametrize("B,Hh,M,block,dh,dtype", [
    (8, 16, 64, 16, 128, "bfloat16"), (3, 2, 4, 8, 16, "float32"),
    (2, 4, 6, 8, 32, "float32")])
def test_keysig_and_candidates_equal_the_references(no_cache, B, Hh, M,
                                                    block, dh, dtype):
    import jax.numpy as jnp

    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    assert pa.keysig(B, Hh, M, block, dh, td) == \
        jpa.keysig(B, Hh, M, block, dh, jd)
    assert pa.candidate_schedules("cpu", block, dh, M, td) == \
        jpa.candidate_schedules("cpu", block, dh, M, jd)
    assert pa.default_schedule("cpu", block, dh, td) == \
        jpa.default_schedule("cpu", block, dh, jd) == {"impl": "gather"}
    # on a card the search picks the kernel's split, never a plain path
    assert pa.candidate_schedules("cuda", block, dh, M, td) == [
        {"impl": "cuda", "chunk_pages": p} for p in (1, 2, 4, 8, 16)]
    assert pa.default_schedule("cuda", block, dh, td) == {
        "impl": "cuda", "chunk_pages": pa.split_of(M, block)[0]}


def test_bench_fns_agree_and_refuse_the_kernel_on_the_cpu(no_cache):
    shape = dict(B=3, H=2, M=4, block=8, dh=16, L=2)
    ref = _np(pa.make_bench_fn({"impl": "gather"}, **shape)())
    for ch in (1, 2, 4):
        got = _np(pa.make_bench_fn({"impl": "pagewalk", "chunk": ch},
                                   **shape)())
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    for sched in ({"impl": "cuda", "chunk_pages": 8},
                  {"impl": "cuda", "chunk_pages": 32}, {"impl": "x"}):
        with pytest.raises(at.ScheduleRejected):
            pa.make_bench_fn(sched, **shape)


def test_require_checks_the_split():
    pa.require(16, 128, torch.bfloat16, 1024, chunk_pages=16)
    for bad in (0, 17):
        with pytest.raises(MXNetError, match="chunk_pages"):
            pa.require(16, 128, torch.bfloat16, 1024, chunk_pages=bad)


# ---------------------------------------------------------------------------
# PagedSlots under the autotuner
# ---------------------------------------------------------------------------
def _drive(pg, seed=5):
    """The paged life cycle of tests/test_autotune.py:_drive; returns
    every emission's logits."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, V, 8).astype(np.int64)
    fa = np.concatenate([shared, rs.randint(0, V, 8)])
    fb = np.concatenate([shared, rs.randint(0, V, 3)])
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


def _greedy(outs):
    return [o.argmax(-1).tolist() for o in outs]


def test_paged_slots_search_on_the_cpu_matches_the_reference(
        lm_params, tdec, sched_cache, metrics, monkeypatch):
    """Search mode on the CPU measures gather and pagewalk, persists the
    winner, and the port's greedy tokens equal the JAX gather backend's
    on the same seeded decoder; a second construction hits the cache
    with zero trials."""
    trials = metrics.get("autotune_trials_total")
    t0 = trials.total()
    timed = []
    timings = search._timings

    def spy(fn, warmup, best_of):
        timed.append(fn)
        return timings(fn, warmup=warmup, best_of=best_of)

    monkeypatch.setattr(search, "_timings", spy)
    buckets = (8, 16, 32)
    pg = PagedSlots(tdec, 3, block=8, prefill_buckets=buckets)
    assert pg.schedule["impl"] in ("gather", "pagewalk")
    assert pg.stats()["schedule"] == pg.schedule
    # gather + the pagewalk granules 1, 2 and 4 (8 does not divide M 4),
    # and the four re-timings (winner, gather, winner, gather) when a
    # pagewalk winner is confirmed against the default
    ent = json.load(open(sched_cache))["entries"]["cpu"]
    assert ent["paged_attention|b3h2m4k8d16_float32"]["trials"] == 4
    assert len(set(timed[:4])) == 4 and len(timed) in (4, 8)
    if len(timed) == 8:
        assert timed[4] is timed[6] and timed[5] is timed[7] is timed[0]
    assert trials.total() - t0 == len(timed)
    n_timed = len(timed)
    assert ent["paged_attention|b3h2m4k8d16_float32"]["schedule"] == \
        pg.schedule
    outs = _drive(pg)
    jdec = JaxDecoder(lm_params, num_layers=L, num_heads=H, max_len=T)
    jat.reset()
    os.environ.pop("MXTPU_SCHEDULE_CACHE")   # the reference: plain gather
    ref = _drive(JaxPagedSlots(jdec, 3, block=8, prefill_buckets=buckets,
                               kernel="gather"))
    assert _greedy(outs) == _greedy(ref)
    for a, b in zip(ref, outs):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
    os.environ["MXTPU_SCHEDULE_CACHE"] = "search:" + sched_cache
    at.reset()
    again = PagedSlots(tdec, 3, block=8, prefill_buckets=buckets)
    assert again.schedule == pg.schedule
    assert trials.total() - t0 == n_timed


def test_paged_forced_modes_skip_the_search(tdec, sched_cache, metrics,
                                            monkeypatch):
    trials = metrics.get("autotune_trials_total")
    t0 = trials.total()
    assert PagedSlots(tdec, 2, block=8, prefill_buckets=(8, 16, 32),
                      kernel="gather").schedule == {"impl": "gather"}
    assert PagedSlots(tdec, 2, block=8, prefill_buckets=(8, 16, 32),
                      kernel="pagewalk").schedule == {
                          "impl": "pagewalk", "chunk": 1}
    with pytest.raises(MXNetError, match="CUDA pool"):
        PagedSlots(tdec, 2, block=8, prefill_buckets=(8, 16, 32),
                   kernel="pallas")
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE", "off")
    assert PagedSlots(tdec, 2, block=8,
                      prefill_buckets=(8, 16, 32)).schedule == {
                          "impl": "gather"}
    assert trials.total() == t0


def test_zero_researches_and_rebinds_after_warmup_with_tuning_on(
        tdec, metrics, sched_cache, monkeypatch):
    """Tuning on: the admit-time search picks a schedule ONCE; warm
    serving traffic never searches again, and a rebind of an equal graph
    hits the program cache until a new winner re-keys it."""
    monkeypatch.setenv("MXTPU_AUTOTUNE_TRIALS", "3")
    trials = metrics.get("autotune_trials_total")
    sched = SlotScheduler(tdec, num_slots=2, queue_size=16, paged=True,
                          kv_block=8)
    try:
        rs = np.random.RandomState(6)
        for plen in (3, 12, 20):
            sched.generate(rs.randint(0, V, plen), max_new_tokens=2,
                           timeout=120)
        assert os.path.exists(sched_cache)
        t0 = trials.total()
        reqs = [sched.submit(rs.randint(0, V, ln), max_new_tokens=4)
                for ln in (3, 7, 5, 9, 4, 18)]
        for r in reqs:
            r.wait(120)
        assert all(r.outcome == "ok" for r in reqs)
        assert trials.total() - t0 == 0
    finally:
        sched.close()
    cache = metrics.get("executor_graph_cache_total")
    net = tsym.FullyConnected(tsym.Variable("data"), num_hidden=4,
                              name="tfc")
    simple_bind(net, "cpu", data=(2, 8))
    m0 = cache.value(result="miss")
    simple_bind(net, "cpu", data=(2, 8))
    assert cache.value(result="miss") == m0
    at.record("residual_epilogue", "r8c128_float32",
              {"threads": 128, "blocks_per_sm": 4}, 1.0, 1)
    simple_bind(net, "cpu", data=(2, 8))
    assert cache.value(result="miss") == m0 + 1


def test_new_winner_drops_only_the_captures_that_launch_a_tuned_kernel(
        sched_cache, monkeypatch):
    """``FusedTrainer``'s captured steps: a new winner (the fingerprint
    moves) drops a graph that launches the epilogue, whose schedule it
    baked in, and keeps one that does not, which is not captured again."""
    from mxnet_tpu_torch import trainer as ttrainer

    net = tsym.FullyConnected(tsym.Variable("data"), num_hidden=4,
                              name="tfc")
    tr = ttrainer.FusedTrainer(tsym.SoftmaxOutput(net, name="softmax"),
                               optimizer="sgd", device="cpu")
    plain = {"data": torch.zeros(2, 8)}
    tuned = {"data": torch.zeros(4, 8)}

    def capture(example):
        return ttrainer._Captured(None, {}, [], None,
                                  example["data"].shape[0] == 4)

    monkeypatch.setattr(tr, "_capture", capture)
    kept, dropped = tr._captured(plain), tr._captured(tuned)
    assert tr._captured(plain) is kept and tr._captured(tuned) is dropped
    at.record("residual_epilogue", "r8c128_float32",
              {"threads": 128, "blocks_per_sm": 4}, 1.0, 1)
    assert tr._captured(plain) is kept
    assert tr._captured(tuned) is not dropped
