"""The port's native runtime against the JAX package's, on the CPU: the
dependency engine (``src/engine.cc``), the storage arena
(``src/storage.cc``) and the record reader/writer, through both FFI
backends (``ctypes`` and the compiled ``_mxtpu_ext`` of
``src/py_ext.cc``), with the host engine of ``engine.py`` and the
arena-backed temp space of ``resource.py``.

The port builds its libraries into ``build/torch_kernels/``; the JAX
package builds its own with ``make -C src`` into ``mxnet_tpu/lib/`` at
first use.  Test processes running side by side (pytest-xdist) used to
race in that build: one process loaded a library another's ``g++`` was
still writing, or saw its own ``make`` fail, and the JAX package then
kept "unavailable" for the whole process.  :func:`load_jax_native`, the
fixture ``jax_native`` of every port test that calls the JAX package's
native library, serialises that build across processes with an
``fcntl.flock`` on ``build/.jax_native.lock`` and retries a failed load
until it succeeds or :data:`JAX_NATIVE_DEADLINE_S` (the JAX package's
own ``make`` timeout) has passed.
"""
import fcntl
import os
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import _native as jnative_mod
from mxnet_tpu import engine as jengine

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import resource as tresource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "build", ".jax_native.lock")
JAX_NATIVE_DEADLINE_S = 120.0
BOTH = ("ctypes", "cext")


def load_jax_native(deadline_s=JAX_NATIVE_DEADLINE_S):
    """``mxnet_tpu._native`` with its library loaded: the build and the
    load happen under an exclusive lock shared by every test process,
    and a failed load (a file half written by a process outside the
    lock, a ``make`` that lost a race) is forgotten and tried again."""
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    end = time.monotonic() + deadline_s
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            while jnative_mod.get_lib() is None:
                if time.monotonic() > end:
                    raise RuntimeError(
                        "the JAX package's native library did not load "
                        f"within {deadline_s} s")
                jnative_mod._LIB = None
                jnative_mod._EXT = None
                time.sleep(0.5)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    return jnative_mod


@pytest.fixture(scope="module")
def jax_native():
    return load_jax_native()


def _need(backend):
    if backend == "cext" and tnative.get_ext() is None:
        pytest.skip("_mxtpu_ext cannot be built here (no Python headers)")


# ------------------------------------------------------------ the build
def test_core_and_ext_build_into_the_port_build_dir():
    from mxnet_tpu_torch.ops import _build

    assert tnative.available()
    path = tnative.lib_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert not path.startswith(os.path.join(REPO, "mxnet_tpu"))
    ext = tnative.get_ext()
    if ext is not None:
        assert ext.__name__ == "_mxtpu_ext"
        assert os.path.dirname(ext.__file__) == _build.BUILD_DIR


def test_backend_selection(monkeypatch):
    _need("cext")
    monkeypatch.setenv("MXTPU_FFI", "ctypes")
    assert tnative.ffi_backend() == "ctypes"
    monkeypatch.setenv("MXTPU_FFI", "cext")
    assert tnative.ffi_backend() == "cext"
    assert tnative.ffi_backend("ctypes") == "ctypes"
    monkeypatch.setenv("MXTPU_FFI", "parrot")
    with pytest.raises(ValueError):
        tnative.ffi_backend()
    monkeypatch.delenv("MXTPU_FFI")
    assert tnative.ffi_backend() == "cext"


# ---------------------------------------------------------------- engine
def _script(seed, n_tasks=60, n_vars=3):
    """A task sequence: each task reads and writes random vars."""
    rs = np.random.RandomState(seed)
    tasks = []
    for _ in range(n_tasks):
        picks = rs.permutation(n_vars)[:rs.randint(1, n_vars + 1)]
        cut = rs.randint(0, len(picks) + 1)
        tasks.append((sorted(picks[:cut].tolist()),
                      sorted(picks[cut:].tolist())))
    return tasks


def _run_script(eng, tasks, n_vars=3):
    """What each task saw: the write count of every var it touched.  The
    engine's contract fixes it: a task sees exactly the writes pushed
    before it on its vars."""
    var_ids = [eng.new_var() for _ in range(n_vars)]
    version = [0] * n_vars
    seen = [None] * len(tasks)
    lock = threading.Lock()

    def task(i, reads, writes):
        time.sleep(0.0005 * (i % 3))
        with lock:
            seen[i] = tuple(version[v] for v in reads + writes)
            for v in writes:
                version[v] += 1

    for i, (reads, writes) in enumerate(tasks):
        eng.push(lambda i=i, r=reads, w=writes: task(i, r, w),
                 const_vars=[var_ids[v] for v in reads],
                 mutable_vars=[var_ids[v] for v in writes])
    eng.wait_all()
    return seen, version


@pytest.mark.parametrize("backend", BOTH)
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_orders_tasks_as_the_jax_engine(jax_native, backend, seed):
    _need(backend)
    tasks = _script(seed)
    ref_eng = jax_native.NativeEngine(num_threads=4, backend="ctypes")
    eng = tnative.NativeEngine(num_threads=4, backend=backend)
    try:
        assert _run_script(eng, tasks) == _run_script(ref_eng, tasks)
    finally:
        eng._shutdown()
        ref_eng._shutdown()


@pytest.mark.parametrize("backend", BOTH)
def test_engine_writers_in_push_order_and_errors_at_wait(jax_native,
                                                         backend):
    _need(backend)
    results = {}
    for pkg, eng in (("jax", jax_native.NativeEngine(4, "ctypes")),
                     ("port", tnative.NativeEngine(4, backend))):
        try:
            v = eng.new_var()
            order = []
            for i in range(50):
                eng.push(lambda i=i: order.append(i), mutable_vars=[v])
            eng.wait_for_var(v)

            def boom():
                raise RuntimeError("task failed on purpose")

            eng.push(boom, mutable_vars=[v])
            with pytest.raises(RuntimeError, match="on purpose"):
                eng.wait_all()
            pending = eng.pending()
            refusals = 0
            for kw in ({"const_vars": [v], "mutable_vars": [v]},
                       {"mutable_vars": [10 ** 9]}):
                try:
                    eng.push(lambda: None, **kw)
                except ValueError:
                    refusals += 1
            results[pkg] = (order, pending, refusals)
        finally:
            eng._shutdown()
    assert results["port"] == results["jax"] == (list(range(50)), 0, 2)


@pytest.mark.parametrize("backend", BOTH)
def test_engine_readers_between_writers(backend):
    _need(backend)
    eng = tnative.NativeEngine(num_threads=4, backend=backend)
    try:
        v = eng.new_var()
        seen = []
        eng.push(lambda: seen.append("w1"), mutable_vars=[v])
        for _ in range(8):
            eng.push(lambda: seen.append("r"), const_vars=[v])
        eng.push(lambda: seen.append("w2"), mutable_vars=[v], priority=1)
        eng.wait_for_var(v)
        assert seen[0] == "w1" and seen[-1] == "w2"
        assert seen.count("r") == 8
    finally:
        eng._shutdown()


# ------------------------------------------------------------ host engine
def test_host_engine_push_matches_jax(jax_native):
    """``engine.push``/``new_host_var``/``wait_for_host_var`` in both
    packages on one sequence: the same order, the error at the wait."""
    out = {}
    for name, mod in (("jax", jengine), ("port", tengine)):
        v = mod.new_host_var()
        log = []
        for i in range(20):
            mod.push(lambda i=i: log.append(i), mutable_vars=[v])
        mod.wait_for_host_var(v)

        def boom():
            raise KeyError("host task")

        mod.push(boom, mutable_vars=[v])
        with pytest.raises(KeyError):
            mod.wait_for_host_var(v)
        mod.wait_for_all_host()
        out[name] = log
    assert out["port"] == out["jax"] == list(range(20))
    assert isinstance(tengine.host_engine(), tnative.NativeEngine)


def test_naive_engine_runs_host_tasks_on_the_pushing_thread(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    ran = []
    tengine.push(lambda: ran.append(threading.get_ident()),
                 mutable_vars=[tengine.new_host_var()])
    assert ran == [threading.get_ident()]


# ----------------------------------------------------------------- arena
def _arena_trace(arena):
    """Pool bytes and pointer reuse over one alloc/free sequence."""
    arena.release_all()
    trace = []
    a = arena.alloc((1000,), np.float32)       # 4000 B -> class 4096
    pa = a.ctypes.data
    arena.free(a)
    trace.append(arena.pool_bytes())
    b = arena.alloc((900,), np.float32)        # same class: recycled
    trace.append(b.ctypes.data == pa)
    trace.append(arena.pool_bytes())
    c = arena.alloc((3, 5), np.float64)        # 120 B -> class 256
    c[:] = 1.5
    trace.append(float(c.sum()))
    arena.free(b)
    arena.free(c)
    trace.append(arena.pool_bytes())
    arena.free(c)                              # a second free: ignored
    trace.append(arena.pool_bytes())
    arena.release_all()
    trace.append(arena.pool_bytes())
    return trace


@pytest.mark.parametrize("backend", BOTH)
def test_arena_reuse_matches_jax(jax_native, backend):
    _need(backend)
    want = _arena_trace(jax_native.NativeArena(backend="ctypes"))
    assert _arena_trace(tnative.NativeArena(backend=backend)) == want
    assert want == [4096, True, 0, 22.5, 4096 + 256, 4096 + 256, 0]


def test_arena_pool_is_shared_by_both_backends():
    """A block freed through one backend is pooled for the other: the
    extension is linked to the core library's file, one pool in the
    process."""
    _need("cext")
    a = tnative.NativeArena(backend="ctypes")
    b = tnative.NativeArena(backend="cext")
    b.release_all()
    arr = a.alloc((1024,), np.float32)
    a.free(arr)
    assert b.pool_bytes() == 4096
    b.release_all()
    assert a.pool_bytes() == 0


def test_temp_space_lives_in_the_arena():
    rm = tresource.ResourceManager()
    res = rm.request("cpu", tresource.ResourceRequest.kTempSpace)
    arena = tresource._arena()
    small = res.get_space((4,), np.float32)
    first = res._buf
    assert first.ctypes.data in arena._ptrs
    before = arena.pool_bytes()
    big = res.get_space((4096,), np.float64)   # grows: the old block
    assert big.shape == (4096,)                # goes back to the pool
    assert res._buf.ctypes.data in arena._ptrs
    assert first.ctypes.data not in arena._ptrs
    assert arena.pool_bytes() >= before + first.nbytes
    assert small.shape == (4,)


# --------------------------------------------------------------- records
@pytest.mark.parametrize("backend", BOTH)
def test_records_match_jax_through_either_backend(jax_native, tmp_path,
                                                  backend):
    _need(backend)
    rs = np.random.RandomState(9)
    recs = [rs.bytes(int(n)) for n in rs.randint(0, 500, 37)] + [b""]
    mine, theirs = str(tmp_path / "t.rec"), str(tmp_path / "j.rec")
    w = tnative.NativeRecordWriter(mine, backend=backend)
    for r in recs:
        w.write(r)
    w.close()
    jw = jax_native.NativeRecordWriter(theirs, backend="ctypes")
    for r in recs:
        jw.write(r)
    jw.close()
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(
        tnative.native_index(mine, backend=backend),
        jax_native.native_index(theirs, backend="ctypes"))
    rd = tnative.NativeRecordReader(mine, backend=backend)
    got = []
    while True:
        part = rd.read_batch(max_records=10)
        if not part:
            break
        got.extend(part)
    rd.close()
    assert got == recs

