"""The port's general C API (``csrc/c_api.cc`` over ``src/mxtpu_capi.h``)
on the CPU, against the JAX package's.

- ``bindings/cpp/example_train.cc``, unchanged, built against both
  packages' C-API libraries: both print ``CPP TRAIN OK`` and their first
  and last losses agree (printed to 4 decimals; the first forward runs
  the same fp32 arithmetic on the same weights: 1e-4; after 30 SGD steps
  the two libraries' summation orders have drifted: 2e-3);
- ``tests/c/train_lenet.c``, unchanged, against the port's library;
- the port's C++ client ``csrc/clients/train_step.cc`` (``mxtpu.hpp``,
  ``MXExecutorSimpleBind``, ``sgd_update`` through
  ``MXImperativeInvoke``) on resnet-8 at 3 x 16 x 16: its first
  gradients against the port's Python executor (the same arithmetic:
  1e-6 relative) and the JAX executor (true fp32 convolutions: 1e-4
  relative, the norm of each gradient), and its loss at each of 3 steps
  against 3 SGD steps of the Python executor (printed to 6 decimals:
  1e-5);
- each function of ``_c_api_impl`` against the JAX package's, called
  in process on the same inputs.

The JAX package's library is built by ``make -C src capi`` under the
lock of ``test_torch_native_engine.py`` (other test processes may run
the same ``make``; a failed build or link is tried again).
"""
import fcntl
import os
import re
import subprocess
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import _c_api_impl as jimpl
from mxnet_tpu.models import resnet as jresnet

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import _c_api_impl as timpl
from mxnet_tpu_torch import libinfo
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.executor import simple_bind
from mxnet_tpu_torch.models import resnet as tresnet

from test_torch_native_engine import JAX_NATIVE_DEADLINE_S, LOCK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "bindings", "cpp", "example_train.cc")
LENET = os.path.join(REPO, "tests", "c", "train_lenet.c")
TRAIN_STEP = os.path.join(REPO, "mxnet_tpu_torch", "csrc", "clients",
                          "train_step.cc")
JAX_CAPI = os.path.join(REPO, "mxnet_tpu", "lib", "libmxtpu_capi.so")
LOSS_TOL = {"first": 1e-4, "last": 2e-3}


def _compile(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    return r.returncode == 0, r.stderr


def _link(src, lib, exe, cxx=True):
    return (["g++", "-std=c++17"] if cxx else ["gcc"]) + [
        src, *(f"-I{d}" for d in libinfo.include_dirs()), lib, "-lm",
        "-o", exe, f"-Wl,-rpath,{os.path.dirname(lib)}"]


def _jax_client(src, exe):
    """``src`` linked against the JAX package's C-API library, which is
    built first; both under the shared lock, retried until they work."""
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    end = time.monotonic() + JAX_NATIVE_DEADLINE_S
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            while True:
                ok, err = _compile(["make", "-C", os.path.join(REPO, "src"),
                                    "capi"])
                if ok:
                    ok, err = _compile(_link(src, JAX_CAPI, exe))
                if ok:
                    return exe
                if time.monotonic() > end:
                    raise RuntimeError(f"cannot build against {JAX_CAPI}: "
                                       f"{err}")
                time.sleep(1.0)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _losses(out):
    m = re.search(r"first ([-\d.]+) last ([-\d.]+)", out)
    return float(m.group(1)), float(m.group(2))


def test_example_train_against_both_libraries(tmp_path):
    port_exe = str(tmp_path / "port_train")
    ok, err = _compile(_link(EXAMPLE, libinfo.find_lib_path("capi"),
                             port_exe))
    assert ok, err
    jax_exe = _jax_client(EXAMPLE, str(tmp_path / "jax_train"))
    jenv = dict(os.environ, MXTPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    outs = {}
    for tag, exe, env in (("port", port_exe, libinfo.client_env()),
                          ("jax", jax_exe, jenv)):
        r = subprocess.run([exe], env=env, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "CPP TRAIN OK" in r.stdout
        outs[tag] = _losses(r.stdout)
    (pf, pl), (jf, jl) = outs["port"], outs["jax"]
    assert abs(pf - jf) <= LOSS_TOL["first"], outs
    assert abs(pl - jl) <= LOSS_TOL["last"] * max(abs(jl), 1.0), outs
    assert pl < 0.5 * pf


def test_lenet_c_client_trains_on_the_port(tmp_path):
    exe = str(tmp_path / "lenet")
    ok, err = _compile(_link(LENET, libinfo.find_lib_path("capi"), exe,
                             cxx=False))
    assert ok, err
    r = subprocess.run([exe], env=libinfo.client_env(), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TRAIN OK" in r.stdout
    assert "conv1_weight" in r.stdout and "fc1_weight" in r.stdout


# ------------------------------------------------------- train_step.cc
SHAPE = (8, 3, 16, 16)
LR, RESCALE, STEPS = 0.05, 1.0 / SHAPE[0], 3


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """resnet-8's JSON, seeded weights and a batch; the C++ client's
    first gradients and its weights after STEPS steps."""
    tmp = tmp_path_factory.mktemp("trainstep")
    jnet = jresnet.get_symbol(10, 8, SHAPE[1:])
    json_str = jnet.tojson()
    net = tsym.load_json(json_str)
    arg, _ = tresnet.random_params(net, seed=1, data=SHAPE)
    rs = np.random.RandomState(2)
    x = rs.normal(size=SHAPE).astype(np.float32)
    y = rs.randint(0, 10, SHAPE[0]).astype(np.float32)
    names = [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")]
    np.concatenate([arg[n].ravel() for n in names]).astype(
        np.float32).tofile(str(tmp / "w.f32"))
    x.tofile(str(tmp / "x.f32"))
    y.tofile(str(tmp / "y.f32"))
    (tmp / "net.json").write_text(json_str)
    exe = str(tmp / "train_step")
    ok, err = _compile(_link(TRAIN_STEP, libinfo.find_lib_path("capi"), exe))
    assert ok, err
    r = subprocess.run(
        [exe, str(tmp / "net.json"), str(tmp / "w.f32"), str(tmp / "x.f32"),
         str(tmp / "y.f32"), str(tmp / "g.f32"), "1", str(STEPS), str(LR),
         repr(RESCALE), *map(str, SHAPE)],
        env=libinfo.client_env(), capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TRAIN STEP OK" in r.stdout
    flat = np.fromfile(str(tmp / "g.f32"), np.float32)
    grads, off = {}, 0
    for n in names:
        grads[n] = flat[off:off + arg[n].size].reshape(arg[n].shape)
        off += arg[n].size
    assert off == flat.size
    losses = [float(v) for v in re.findall(r"loss ([-\d.]+)", r.stdout)]
    return json_str, net, arg, x, y, names, grads, losses


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_train_step_client_grads_match_the_port_executor(step_run):
    _, net, arg, x, y, names, grads, losses = step_run
    ex = simple_bind(net, "cpu", data=SHAPE, softmax_label=SHAPE[:1])
    ex.copy_params_from({n: arg[n] for n in names}, {},
                        allow_extra_params=True)
    ex.forward(is_train=True, data=x, softmax_label=y)
    ex.backward()
    worst = max(_rel(grads[n], ex.grad_dict[n].numpy()) for n in names)
    assert worst <= 1e-6, worst
    want = []
    for step in range(STEPS):
        if step:
            ex.forward(is_train=True)
            ex.backward()
        prob = ex.outputs[0].detach().numpy()
        want.append(float(-np.log(np.maximum(
            prob[np.arange(SHAPE[0]), y.astype(int)], 1e-12)).mean()))
        for n in names:
            ex.arg_dict[n] -= LR * RESCALE * ex.grad_dict[n]
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
    assert losses[-1] != losses[0]


def test_train_step_client_grads_match_the_jax_executor(step_run,
                                                        monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    json_str, _, arg, x, y, names, grads, _ = step_run
    jnet = jmx.symbol.load_json(json_str)
    ex = jnet.simple_bind(ctx=jmx.cpu(), data=SHAPE, softmax_label=SHAPE[:1])
    for n in names:
        ex.arg_dict[n][:] = arg[n]
    ex.arg_dict["data"][:] = x
    ex.arg_dict["softmax_label"][:] = y
    ex.forward(is_train=True)
    ex.backward()
    worst = max(_rel(grads[n], ex.grad_dict[n].asnumpy()) for n in names)
    assert worst <= 1e-4, worst


# ------------------------------------------------- _c_api_impl in process
def _mlp(impl):
    """data -> FC(6) -> relu -> FC(3) -> SoftmaxOutput, composed through
    the atomic-symbol calls, as a C binding does."""
    data = impl.symbol_create_variable("data")
    label = impl.symbol_create_variable("softmax_label")
    fc1 = impl.symbol_compose(impl.symbol_create_atomic(
        "FullyConnected", ["num_hidden"], ["6"]), "fc1", [], [data])
    act = impl.symbol_compose(impl.symbol_create_atomic(
        "Activation", ["act_type"], ["relu"]), "relu1", [], [fc1])
    fc2 = impl.symbol_compose(impl.symbol_create_atomic(
        "FullyConnected", ["num_hidden"], ["3"]), "fc2", [], [act])
    return impl.symbol_compose(impl.symbol_create_atomic(
        "SoftmaxOutput", [], []), "softmax", ["data", "label"],
        [fc2, label])


def _host(arr):
    return np.frombuffer(arr, np.float32) if isinstance(arr, bytes) else arr


@pytest.mark.parametrize("fn", ["symbol_to_json", "symbol_list_arguments",
                                "symbol_list_outputs",
                                "symbol_list_auxiliary_states"])
def test_symbol_calls_match_jax(fn):
    got, want = getattr(timpl, fn)(_mlp(timpl)), getattr(jimpl, fn)(
        _mlp(jimpl))
    assert got == want
    if fn == "symbol_to_json":
        back = timpl.symbol_from_json(got)
        assert timpl.symbol_to_json(back) == got


def test_infer_shape_matches_jax():
    args = (["data"], [[4, 8]])
    assert timpl.symbol_infer_shape(_mlp(timpl), *args) == \
        jimpl.symbol_infer_shape(_mlp(jimpl), *args)


def _exec_case(impl, rs_seed=0):
    """simple_bind -> set args by sync copies -> forward/backward ->
    outputs and gradients as host arrays."""
    rs = np.random.RandomState(rs_seed)
    ex = impl.executor_simple_bind(_mlp(impl), 1, 0, "write",
                                   ["data", "softmax_label"], [[4, 8], [4]])
    vals = {"data": rs.normal(size=(4, 8)),
            "softmax_label": np.array([0, 2, 1, 2]),
            "fc1_weight": rs.normal(size=(6, 8)) * 0.3,
            "fc1_bias": rs.normal(size=6) * 0.1,
            "fc2_weight": rs.normal(size=(3, 6)) * 0.3,
            "fc2_bias": rs.normal(size=3) * 0.1}
    for name in impl.executor_arg_names(ex):
        buf = np.ascontiguousarray(vals[name], np.float32).tobytes()
        impl.ndarray_sync_copy_from(impl.executor_arg_array(ex, name),
                                    memoryview(buf))
    impl.executor_forward(ex, 1)
    impl.executor_backward(ex)
    out = {"n_out": impl.executor_num_outputs(ex),
           "prob": _host(impl.ndarray_sync_copy_to(
               impl.executor_output(ex, 0)))}
    for name in ("fc1_weight", "fc2_bias", "data"):
        out[name] = _host(impl.ndarray_sync_copy_to(
            impl.executor_grad_array(ex, name)))
    return out, ex


def test_executor_calls_match_jax():
    got, tex = _exec_case(timpl)
    want, _ = _exec_case(jimpl)
    assert got["n_out"] == want["n_out"] == 1
    for k in ("prob", "fc1_weight", "fc2_bias", "data"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    assert timpl.executor_arg_names(tex) == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
        "softmax_label"]
    with pytest.raises(MXNetError, match="no argument named"):
        timpl.executor_arg_array(tex, "nope")


def test_ndarray_calls_match_jax():
    buf = np.arange(6, dtype=np.float32).tobytes()
    res = {}
    for tag, impl in (("port", timpl), ("jax", jimpl)):
        a = impl.ndarray_create([2, 3], 1, 0)
        impl.ndarray_sync_copy_from(a, memoryview(bytearray(buf)))
        res[tag] = (impl.ndarray_shape(a),
                    _host(impl.ndarray_sync_copy_to(a)).tolist())
    assert res["port"] == res["jax"] == ([2, 3], [0, 1, 2, 3, 4, 5])
    timpl.ndarray_wait_all()
    # the reference's MXNDArrayWaitAll calls an engine.wait_all that
    # mxnet_tpu/engine.py does not define (ROADMAP Queue 3)
    with pytest.raises(AttributeError, match="wait_all"):
        jimpl.ndarray_wait_all()


def test_sync_copy_from_owns_its_copy_before_returning():
    """The caller frees or rewrites its buffer right after the call."""
    a = timpl.ndarray_create([4], 1, 0)
    buf = bytearray(np.ones(4, np.float32).tobytes())
    timpl.ndarray_sync_copy_from(a, memoryview(buf))
    buf[:] = np.full(4, 7, np.float32).tobytes()
    assert a.asnumpy().tolist() == [1, 1, 1, 1]


@pytest.mark.parametrize("op,attrs", [
    ("_mul_scalar", {"scalar": "2.0"}),
    ("_plus_scalar", {"scalar": "1.5"}),
    ("sgd_update", {"lr": "0.1", "rescale_grad": "0.5"}),
])
def test_imperative_invoke_matches_jax(op, attrs):
    w = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    g = np.linspace(2, 3, 6, dtype=np.float32).reshape(2, 3)
    ins = [w, g] if op == "sgd_update" else [w]
    got = timpl.imperative_invoke(op, [tnd.array(v, ctx="cpu") for v in ins],
                                  list(attrs), list(attrs.values()))
    want = jimpl.imperative_invoke(op, [jmx.nd.array(v) for v in ins],
                                   list(attrs), list(attrs.values()))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="unknown imperative op"):
        timpl.imperative_invoke("asnumpy", [], [], [])


def test_sgd_update_writes_the_bound_weight_in_place():
    ex = timpl.executor_simple_bind(_mlp(timpl), 1, 0, "write",
                                    ["data", "softmax_label"], [[4, 8], [4]])
    w = timpl.executor_arg_array(ex, "fc2_bias")
    g = tnd.array(np.ones(3, np.float32), ctx="cpu")
    timpl.imperative_invoke("sgd_update", [w, g], ["lr"], ["0.5"])
    np.testing.assert_array_equal(ex.arg_dict["fc2_bias"].numpy(),
                                  [-0.5, -0.5, -0.5])


def _kv_case(impl, nd):
    kv = impl.kvstore_create("local")
    seen = []

    def updater(key, recv, local):
        seen.append(key)
        local[:] = local - 0.5 * recv

    impl.kvstore_set_updater(kv, updater)
    impl.kvstore_init(kv, [3, 7], [nd(np.ones(4)), nd(np.full(4, 2.0))])
    impl.kvstore_push(kv, [3, 7], [nd(np.arange(4)), nd(np.ones(4))], 0)
    outs = [nd(np.zeros(4)), nd(np.zeros(4))]
    impl.kvstore_pull(kv, [3, 7], outs, 0)
    return ([o.asnumpy().tolist() for o in outs], seen,
            impl.kvstore_rank(kv), impl.kvstore_num_workers(kv))


def test_kvstore_calls_match_jax():
    got = _kv_case(timpl, lambda v: tnd.array(np.asarray(v, np.float32),
                                              ctx="cpu"))
    want = _kv_case(jimpl, lambda v: jmx.nd.array(np.asarray(v, np.float32)))
    assert got == want
    assert got[2:] == (0, 1)


def test_data_iter_calls_match_jax(tmp_path):
    csv = tmp_path / "d.csv"
    rows = np.arange(30, dtype=np.float32).reshape(10, 3)
    np.savetxt(str(csv), rows, delimiter=",", fmt="%.1f")
    keys = ["data_csv", "data_shape", "batch_size"]
    vals = [str(csv), "(3,)", "4"]
    res = {}
    for tag, impl in (("port", timpl), ("jax", jimpl)):
        it = impl.data_iter_create("CSVIter", keys, vals)
        epochs = []
        for _ in range(2):
            batches = []
            while impl.data_iter_next(it):
                batches.append((impl.data_iter_data(it).asnumpy().tolist(),
                                impl.data_iter_pad(it)))
            epochs.append(batches)
            impl.data_iter_before_first(it)
        res[tag] = (impl.list_data_iters(), epochs)
        with pytest.raises(ValueError, match="no current batch"):
            impl.data_iter_pad(it)
    assert res["port"] == res["jax"]
    assert len(res["port"][1][0]) == 2 and res["port"][1][0] == \
        res["port"][1][1]
    with pytest.raises(ValueError, match="unknown iterator"):
        timpl.data_iter_create("NoSuchIter", [], [])


def test_random_seed_and_creators():
    timpl.random_seed(5)
    creators = timpl.symbol_list_atomic_creators()
    assert creators == sorted(creators)
    assert {"Convolution", "FullyConnected", "SoftmaxOutput",
            "sgd_update"} <= set(creators)
    assert creators == sorted(__import__(
        "mxnet_tpu_torch").ops.list_ops())


@pytest.mark.parametrize("dev_type,match", [
    (2, "no CUDA device is available"), (0, "unknown dev_type 0"),
    (5, "unknown dev_type 5")])
def test_dev_types_refused(dev_type, match):
    import torch

    if dev_type == 2 and torch.cuda.is_available():
        pytest.skip("the refusal needs a host without a card")
    with pytest.raises(MXNetError, match=match):
        timpl.ndarray_create([2], dev_type, 0)
