"""The port's serving stack against the JAX package's, on the CPU.

``mxnet_tpu_torch.serving`` (scheduler, paged KV cache, HTTP server) and
``mxnet_tpu.serving`` get the same numpy-seeded checkpoint and the same
greedy requests; they must return the same tokens.  Also here: the
port's telemetry renders exactly like the reference's, the package and
``chip_smoke.py`` import neither JAX nor ``mxnet_tpu``, and
``chip_smoke.py`` refuses to report without a card.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import models
from mxnet_tpu import telemetry as jtm
from mxnet_tpu.models.decode import KVDecoder as JaxDecoder
from mxnet_tpu.serving import SlotScheduler as JaxScheduler
from mxnet_tpu.serving import serve_decoder as jax_serve

from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.models.decode import KVDecoder
from mxnet_tpu_torch.serving import SlotScheduler, serve_decoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, H, D, T, V = 2, 2, 32, 32, 17


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
def jdec(lm_params):
    return JaxDecoder(lm_params, num_layers=L, num_heads=H, max_len=T)


@pytest.fixture(scope="module")
def tdec(lm_params):
    return KVDecoder(lm_params, num_layers=L, num_heads=H, max_len=T,
                     device="cpu")


def _prompts(seed=2):
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, V, 8)
    return [np.concatenate([shared, rs.randint(0, V, n)]) for n in (3, 9)] \
        + [rs.randint(0, V, n) for n in (1, 5, 12, 20)]


def _run(sched, prompts, max_new=6):
    try:
        reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
        for r in reqs:
            r.wait(120)
        return [(r.outcome, list(map(int, r.tokens))) for r in reqs]
    finally:
        sched.close()


@pytest.mark.parametrize("paged", [True, False])
def test_scheduler_tokens_match_jax(jdec, tdec, paged):
    """More requests than slots, ragged prompts, two sharing a prefix
    block: continuous batching in both packages yields the same greedy
    tokens (JAX on its gather path, the port on its plain path)."""
    kw = dict(num_slots=2, queue_size=16, paged=paged, kv_block=8)
    ref = _run(JaxScheduler(jdec, paged_kernel="gather", **kw), _prompts())
    got = _run(SlotScheduler(tdec, **kw), _prompts())
    assert all(o == "ok" for o, _ in ref)
    assert got == ref


def _post(port, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        body = r.read()
    return json.loads(body) if path.endswith(("json", "healthz")) \
        else body.decode()


def _serve_all(serve, dec, prompts):
    srv, sched = serve(dec, num_slots=2, paged=True, kv_block=8,
                       queue_size=16)
    try:
        port = srv.server_address[1]
        with ThreadPoolExecutor(len(prompts)) as ex:
            replies = list(ex.map(lambda p: _post(port, {
                "prompt": [int(t) for t in p], "max_tokens": 5}), prompts))
        return replies, _get(port, "/healthz")
    finally:
        srv.shutdown()
        srv.server_close()
        sched.close()


def test_http_generate_matches_jax_server(jdec, tdec):
    prompts = _prompts(seed=3)
    ref, _ = _serve_all(
        lambda d, **kw: jax_serve(d, paged_kernel="gather", **kw), jdec,
        prompts)
    got, health = _serve_all(serve_decoder, tdec, prompts)
    assert [s for s, _ in got] == [200] * len(prompts)
    assert [b["tokens"] for _, b in got] == [b["tokens"] for _, b in ref]
    assert all(b["outcome"] == "ok" and b["n_tokens"] == 5 for _, b in got)
    assert health["paged"]["kernel"] == "gather"
    assert health["slots"] == 2 and health["status"] == "ok"


def test_http_ops_endpoints_and_drain(tdec):
    was = ttm.enabled()
    ttm.enable()
    ttm.enable_tracing(True)
    srv, sched = serve_decoder(tdec, num_slots=2, paged=True, kv_block=8)
    try:
        port = srv.server_address[1]
        trace = "0af7651916cd43dd8448eb211c80319c"
        st, body = _post(port, {"prompt": [1, 2, 3], "max_tokens": 3},
                         {"traceparent": f"00-{trace}-b7ad6b7169203331-01"})
        assert st == 200 and body["trace"] == trace
        assert "serve_requests_total" in _get(port, "/metrics")
        snap = _get(port, "/metrics.json")["metrics"]
        assert snap["serve_tokens_total"]["samples"][0]["value"] >= 3
        names = {s["name"] for s in _get(port, "/spans.json")["spans"]
                 if s["trace"] == trace}
        assert {"queue_wait", "kv_admit", "prefill", "admit",
                "request"} <= names
        assert _post(port, {"prompt": []})[0] == 400
        assert _post(port, {"prompt": [1], "bogus": 1})[0] == 400
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/admin/drain", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["status"] in ("draining", "drained")
        assert _post(port, {"prompt": [1, 2], "max_tokens": 2})[0] == 503
        assert _get(port, "/healthz")["status"] == "drained"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/admin/undrain", data=b"",
            method="POST")
        with urllib.request.urlopen(req, timeout=30):
            pass
        assert _post(port, {"prompt": [1, 2], "max_tokens": 2})[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()
        sched.close()
        ttm.enable_tracing(False)
        ttm.enable(was)


# ------------------------------------------------------------ telemetry
def _fill(mod, reg):
    c = reg.get_or_create(mod.Counter, "x_total", "a counter", ("k",))
    g = reg.get_or_create(mod.Gauge, "y", 'a "gauge"\nwith lines')
    h = reg.get_or_create(mod.Histogram, "z_seconds", "a histogram",
                          buckets=(0.1, 1.0))
    c.inc(2, k="a")
    c.inc(1.5, k='b"c')
    g.set(7)
    for v in (0.05, 0.5, 3.0):
        h.observe(v)


def test_exporters_render_like_jax():
    from mxnet_tpu.telemetry import registry as jreg

    from mxnet_tpu_torch.telemetry import registry as treg

    jwas, twas = jtm.enabled(), ttm.enabled()
    jtm.enable()
    ttm.enable()
    try:
        jr, tr = jreg.Registry(), treg.Registry()
        _fill(jreg, jr)
        _fill(treg, tr)
        assert ttm.generate_text(tr) == jtm.generate_text(jr)
        js, ts = jtm.json_snapshot(jr), ttm.json_snapshot(tr)
        js.pop("timestamp")
        ts.pop("timestamp")
        assert ts == js
    finally:
        jtm.enable(jwas)
        ttm.enable(twas)


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    "01-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "garbage", "", None,
])
def test_parse_traceparent_like_jax(header):
    assert ttm.parse_traceparent(header) == jtm.parse_traceparent(header)


# -------------------------------------------------- import independence
def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_neither_jax_nor_mxnet_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(REPO,
                                                      "mxnet_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 15
    for new in ("ndarray.py", "model.py", "interop.py", "rtc.py",
                os.path.join("ops", "_nvrtc.py"),
                os.path.join("ops", "init_sample.py"), "io.py",
                "metric.py", "engine.py", "callback.py", "lr_scheduler.py",
                os.path.join("module", "base_module.py"), "recordio.py",
                "image.py", "filesystem.py", "storage.py", "mp_io.py",
                "monitor.py", "_native.py",
                os.path.join("module", "sequential_module.py"),
                os.path.join("module", "python_module.py"), "sparse.py",
                "checkpoint.py", "context.py", "random.py", "resource.py",
                "operator.py", os.path.join("ops", "custom.py"),
                "profiler.py", "faults.py", "executor_manager.py",
                "visualization.py", "test_utils.py",
                os.path.join("serving", "quantize.py"),
                os.path.join("serving", "router.py"),
                os.path.join("serving", "__main__.py"),
                os.path.join("telemetry", "fleet.py"),
                os.path.join("ops", "vision.py"),
                os.path.join("ops", "ctc.py"),
                os.path.join("models", "ssd.py"), "_c_api_impl.py",
                "libinfo.py"):
        assert os.path.join(REPO, "mxnet_tpu_torch", new) in files, new
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), (f, mod)


def test_import_pulls_in_no_jax():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving, "
            "mxnet_tpu_torch.models, mxnet_tpu_torch.ops, "
            "mxnet_tpu_torch.convert, mxnet_tpu_torch.trainer, "
            "mxnet_tpu_torch.symbol, mxnet_tpu_torch.executor, "
            "mxnet_tpu_torch.parallel.ring_attention, "
            "mxnet_tpu_torch.passes, mxnet_tpu_torch.predict, "
            "mxnet_tpu_torch.models.resnet, mxnet_tpu_torch.ndarray, "
            "mxnet_tpu_torch.model, mxnet_tpu_torch.interop, "
            "mxnet_tpu_torch.rtc, mxnet_tpu_torch.ops._nvrtc, "
            "mxnet_tpu_torch.io, mxnet_tpu_torch.metric, "
            "mxnet_tpu_torch.engine, mxnet_tpu_torch.callback, "
            "mxnet_tpu_torch.lr_scheduler, mxnet_tpu_torch.module, "
            "mxnet_tpu_torch.recordio, mxnet_tpu_torch.image, "
            "mxnet_tpu_torch.filesystem, mxnet_tpu_torch.storage, "
            "mxnet_tpu_torch.mp_io, mxnet_tpu_torch.monitor, "
            "mxnet_tpu_torch._native, "
            "mxnet_tpu_torch.module.sequential_module, "
            "mxnet_tpu_torch.module.python_module, "
            "mxnet_tpu_torch.sparse, mxnet_tpu_torch.checkpoint, "
            "mxnet_tpu_torch.resource, mxnet_tpu_torch.operator, "
            "mxnet_tpu_torch.ops.custom, mxnet_tpu_torch.profiler, "
            "mxnet_tpu_torch.faults, mxnet_tpu_torch.executor_manager, "
            "mxnet_tpu_torch.visualization, mxnet_tpu_torch.test_utils, "
            "mxnet_tpu_torch.serving.quantize, "
            "mxnet_tpu_torch.serving.router, "
            "mxnet_tpu_torch.serving.__main__, "
            "mxnet_tpu_torch.telemetry.fleet, mxnet_tpu_torch.ops.vision, "
            "mxnet_tpu_torch.ops.ctc, mxnet_tpu_torch.models.ssd, "
            "mxnet_tpu_torch._c_api_impl, mxnet_tpu_torch.libinfo\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu'))\n"
            "assert not bad, bad\nprint('CLEAN')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CLEAN" in r.stdout


def test_mp_io_worker_imports_no_jax(tmp_path):
    """A real decode worker of ``mp_io`` (started by forkserver) writes
    its ``sys.modules`` once it has built its iterator."""
    import numpy as np
    from torch_mp_probe import RecordsModules

    from mxnet_tpu_torch import image as timg
    from mxnet_tpu_torch import recordio as trec

    rec = str(tmp_path / "w.rec")
    w = trec.MXRecordIO(rec, "w")
    for i in range(4):
        img = np.full((8, 8, 3), i, np.uint8)
        w.write(trec.pack_img(trec.IRHeader(0, float(i), i, 0), img))
    w.close()
    out = str(tmp_path / "modules.json")
    it = timg.MultiProcessImageRecordIter(
        rec, (3, 8, 8), 2, num_workers=1, device="cpu", stall_timeout=120,
        preprocess_threads=RecordsModules(out))
    try:
        assert it.next().data[0].shape == (2, 3, 8, 8)
    finally:
        it.close()
    with open(out) as f:
        mods = json.load(f)
    assert "mxnet_tpu_torch.image" in mods and "torch" in mods
    # the package's import pulls in the newer modules too, all clean
    assert "mxnet_tpu_torch.sparse" in mods
    assert "mxnet_tpu_torch.checkpoint" in mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                   "mxnet_tpu")]
    assert not bad, bad


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_a_card():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
