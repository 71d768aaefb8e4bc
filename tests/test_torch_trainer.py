"""The port's transformer-LM training path against the JAX package, on the
CPU: each ported op (forward and gradient), the ``transformer_lm``
symbol, and ``FusedTrainer`` steps from the same weights.

Inputs come from numpy seeds and go to both packages.  On the CPU the
JAX trainer's ``FlashAttention`` takes the dense lax path
(``full_attention``) and the port's takes the flash kernels' plain
versions; in fp32 the two are the same function.  Tolerances are stated
where they are used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu import ops as jops
from mxnet_tpu.models import transformer as jtrm
from mxnet_tpu.trainer import FusedTrainer as JTrainer

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import transformer as ttrm
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

# fp32 ops: the same arithmetic in another summation order (tanh / exp
# implementations differ in the last ulp); values are of order 1
OP_TOL = 1e-5


def _rs(seed):
    return np.random.RandomState(seed)


def _op_pair(name, inputs, attrs, diff, cot_seed=0):
    """Forward and vjp of one op in both packages; ``diff`` lists the
    indices of the inputs to differentiate.  Returns ((jax out, jax
    grads), (torch out, torch grads))."""
    jfn = jops.get(name).fn
    tfn = treg.get(name).fn

    def jf(*xs):
        full = list(map(jnp.asarray, inputs))
        for i, x in zip(diff, xs):
            full[i] = x
        return jfn(jops.OpCtx(is_train=True), *full, **attrs)

    jout, vjp = jax.vjp(jf, *[jnp.asarray(inputs[i]) for i in diff])
    cot = _rs(cot_seed).normal(size=jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))

    tins = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in diff:
        tins[i].requires_grad_(True)
    tout = tfn(treg.OpCtx(is_train=True), *tins, **attrs)
    tout.backward(torch.from_numpy(cot))
    tgrads = [tins[i].grad for i in diff]
    return (np.asarray(jout), [np.asarray(g) for g in jgrads]), \
        (tout.detach().numpy(), [g.numpy() for g in tgrads])


def _check_op(name, inputs, attrs, diff, tol=OP_TOL):
    (jo, jg), (to, tg) = _op_pair(name, inputs, attrs, diff)
    assert jo.shape == to.shape
    np.testing.assert_allclose(to, jo, atol=tol, rtol=tol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _n(seed, *shape):
    return _rs(seed).normal(size=shape).astype(np.float32)


OP_CASES = [
    ("FullyConnected", lambda: [_n(1, 4, 3, 5), _n(2, 6, 15), _n(3, 6)],
     {"num_hidden": 6}, (0, 1, 2)),
    ("FullyConnected", lambda: [_n(1, 4, 15), _n(2, 6, 15)],
     {"num_hidden": "6", "no_bias": "True"}, (0, 1)),
    ("LayerNorm", lambda: [_n(4, 3, 4, 16) * 3 + 1, _n(5, 16) + 1,
                           _n(6, 16)], {}, (0, 1, 2)),
    ("LayerNorm", lambda: [_n(4, 3, 16, 4), _n(5, 4) + 1, _n(6, 4)],
     {"axis": "-1", "eps": "1e-3"}, (0, 1, 2)),
    ("elemwise_add", lambda: [_n(7, 2, 3, 4), _n(8, 2, 3, 4)], {}, (0, 1)),
    ("_plus", lambda: [_n(7, 2, 3), _n(8, 2, 3)], {}, (0, 1)),
    ("_Plus", lambda: [_n(7, 5), _n(8, 5)], {}, (0, 1)),
    ("_plus_scalar", lambda: [_n(9, 2, 3)], {"scalar": "1.5"}, (0,)),
    ("broadcast_add", lambda: [_n(10, 2, 3, 4), _n(11, 1, 3, 4)], {},
     (0, 1)),
    ("transpose", lambda: [_n(12, 2, 3, 4)], {"axes": "(0, 2, 1)"}, (0,)),
    ("transpose", lambda: [_n(12, 2, 3, 4)], {}, (0,)),
    ("Reshape", lambda: [_n(13, 2, 3, 4)], {"shape": "(0, -1)"}, (0,)),
    ("Reshape", lambda: [_n(13, 2, 3, 4)], {"shape": (-1, 2, 2)}, (0,)),
    ("slice_axis", lambda: [_n(14, 2, 5, 3)],
     {"axis": 1, "begin": 1, "end": 3}, (0,)),
    ("slice_axis", lambda: [_n(14, 2, 5, 3)],
     {"axis": "2", "begin": "1", "end": "None"}, (0,)),
] + [("Activation", lambda: [_n(15, 3, 7) * 2], {"act_type": act}, (0,))
     for act in ("relu", "sigmoid", "tanh", "softrelu", "gelu")]


@pytest.mark.parametrize("case", range(len(OP_CASES)))
def test_op_matches_jax(case):
    name, make, attrs, diff = OP_CASES[case]
    _check_op(name, make(), attrs, diff)


def test_embedding_matches_jax():
    # float ids, truncated and clipped to the table: -3 and 120 clip, 2.7
    # truncates to 2
    ids = np.array([[0, 2.7, 9], [-3, 120, 4]], np.float32)
    _check_op("Embedding", [ids, _n(16, 10, 8)],
              {"input_dim": "10", "output_dim": "8"}, (1,))


@pytest.mark.parametrize("attrs", [
    {}, {"normalization": "batch"}, {"grad_scale": "0.5"},
    {"normalization": "valid"},
    {"use_ignore": "True", "ignore_label": "2", "normalization": "valid"},
    {"use_ignore": True, "ignore_label": 2, "normalization": "null"},
    {"use_ignore": True, "ignore_label": -1, "normalization": "valid"}])
def test_softmax_output_matches_jax(attrs):
    # labels include the ignore label and an id past the classes (its
    # one-hot row is zeros in both); the random head is ignored by both
    label = np.array([0, 2, 4, 2, 1, 7], np.float32)
    _check_op("SoftmaxOutput", [_n(17, 6, 5) * 2, label], attrs, (0,))


@pytest.mark.parametrize("shape,attrs", [
    ((2, 3, 4), {"multi_output": "False"}),
    ((2, 3, 4), {"preserve_shape": "True"}),
    ((2, 3, 4), {})])
def test_softmax_output_refuses_what_is_not_ported(shape, attrs):
    # data of more than 2 dims without multi_output: the reference's
    # backward fails on it (multi_output and preserve_shape themselves
    # are ported, tests/test_torch_op_set.py)
    with pytest.raises(MXNetError, match="without multi_output"):
        treg.get("SoftmaxOutput").fn(treg.OpCtx(), torch.zeros(shape),
                                     torch.zeros(2), **attrs)


def test_softmax_output_ignores_the_head():
    data = _n(18, 4, 3)
    label = np.array([0, 1, 2, 1], np.float32)
    fn = treg.get("SoftmaxOutput").fn
    grads = []
    for head in (torch.ones(4, 3), torch.from_numpy(_n(19, 4, 3))):
        x = torch.from_numpy(data).requires_grad_(True)
        fn(treg.OpCtx(), x, torch.from_numpy(label)).backward(head)
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
    p = torch.softmax(torch.from_numpy(data), 1)
    onehot = torch.nn.functional.one_hot(torch.tensor([0, 1, 2, 1]), 3)
    torch.testing.assert_close(grads[0], p - onehot, atol=1e-7, rtol=0)


@pytest.mark.parametrize("name,nstate,attrs", [
    ("sgd_update", 0, {"lr": 0.1}),
    ("sgd_update", 0, {"lr": "0.1", "wd": "0.01", "rescale_grad": "0.5",
                       "clip_gradient": "0.3"}),
    ("sgd_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam_update", 2, {"lr": 1e-2}),
    ("adam_update", 2, {"lr": 1e-2, "beta1": "0.8", "beta2": "0.99",
                        "epsilon": "1e-6", "wd": "0.1",
                        "clip_gradient": 1.0}),
    ("rmsprop_update", 1, {"lr": 1e-2, "gamma1": 0.9, "clip_weights": 0.5,
                           "rescale_grad": 2.0})])
def test_optimizer_op_matches_jax_in_place(name, nstate, attrs):
    # the port updates weight and state in place and returns them; the
    # values are the JAX package's (elementwise fp32, same operation
    # order: a few ulps of values of order 1)
    w, g = _n(30, 4, 5), _n(31, 4, 5) * 3
    states = [np.abs(_n(32 + i, 4, 5)) for i in range(nstate)]
    want = jops.get(name).fn(jops.OpCtx(), *map(jnp.asarray, [w, g] + states),
                             **attrs)
    want = want if isinstance(want, tuple) else (want,)
    tins = [torch.from_numpy(np.array(a)) for a in [w, g] + states]
    got = treg.get(name).fn(treg.OpCtx(), *tins, **attrs)
    got = got if isinstance(got, tuple) else (got,)
    for out, inp in zip(got, [tins[0]] + tins[2:]):
        assert out is inp                      # updated in place
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# ----------------------------------------------------------- the symbol
SMALL = dict(num_layers=2, num_heads=4, d_model=64, seq_len=32,
             vocab_size=97)


@pytest.mark.parametrize("extra", [{}, {"max_len": 48, "ignore_label": 0,
                                         "d_ff": 96}])
def test_transformer_lm_symbol_matches_jax(extra):
    cfg = dict(SMALL, **extra)
    jnet, tnet = jtrm.transformer_lm(**cfg), ttrm.transformer_lm(**cfg)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_outputs() == jnet.list_outputs()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert tnet.attr_dict() == jnet.attr_dict()
    shapes = dict(data=(2, 32), softmax_label=(2, 32))
    ja, jo, jx = jnet.infer_shape(**shapes)
    ta, to, tx = tnet.infer_shape(**shapes)
    assert ta == [tuple(s) for s in ja]
    assert to == [tuple(s) for s in jo] == [(64, 97)]
    assert tx == [tuple(s) for s in jx]


@pytest.mark.parametrize("cfg", [SMALL, dict(SMALL, num_layers=1,
                                              d_model=32, num_heads=2)])
def test_lm_param_shapes_agree_with_infer_shape(cfg):
    net = ttrm.transformer_lm(**cfg)
    args, _, _ = net.infer_shape(data=(3, cfg["seq_len"]),
                                 softmax_label=(3, cfg["seq_len"]))
    bound = [(n, s) for n, s in zip(net.list_arguments(), args)
             if n not in ("data", "softmax_label")]
    layout = ttrm.lm_param_shapes(cfg["num_layers"], cfg["num_heads"],
                                  cfg["d_model"], 4 * cfg["d_model"],
                                  cfg["vocab_size"], cfg["seq_len"])
    assert bound == list(layout.items())


def test_infer_shape_incomplete_returns_none():
    net = ttrm.transformer_lm(**SMALL)
    assert net.infer_shape(softmax_label=(2, 32)) == (None, None, None)


def test_flops_per_token_matches_jax():
    cfg = ttrm.MFU_HEADLINE_CONFIG
    args = (cfg["num_layers"], cfg["d_model"], cfg["d_ff"], cfg["seq_len"],
            cfg["vocab_size"])
    assert ttrm.lm_train_flops_per_token(*args) == \
        jtrm.lm_train_flops_per_token(*args)


# ---------------------------------------------------------- the trainer
# vocab 521 puts ids past 256, where the bf16 cast of the data rounds
# them (to multiples of 2 up to 512, of 4 above)
TCFG = dict(num_layers=2, num_heads=4, d_model=64, seq_len=32,
            vocab_size=521)
B, T = 2, 32


def _batches(n=3, seed=20):
    rs = _rs(seed)
    return [(rs.randint(0, TCFG["vocab_size"], (B, T)).astype(np.float32),
             rs.randint(0, TCFG["vocab_size"], (B, T)).astype(np.float32))
            for _ in range(n)]


def _trainers(dtype, optimizer, opt_params, cfg=TCFG, batch=(B, T),
              init_seed=None, **kw):
    """A JAX and a port trainer of ``cfg`` from the same weights: seeded
    draws of std 0.05 (pos_embed included), or with ``init_seed`` the
    port's own initializer seeded so, as the full-width chip run draws
    them."""
    jt = JTrainer(jtrm.transformer_lm(**cfg), optimizer=optimizer,
                  optimizer_params=dict(opt_params), dtype=dtype, **kw)
    jt.init(data=batch, softmax_label=batch)
    if init_seed is not None:
        from mxnet_tpu_torch import random as trandom

        trandom.seed(init_seed)
    tt = TTrainer(ttrm.transformer_lm(**cfg), optimizer=optimizer,
                  optimizer_params=dict(opt_params), dtype=dtype,
                  device="cpu", **kw)
    tt.init(data=batch, softmax_label=batch)
    if init_seed is None:
        shapes = {k: tuple(v.shape) for k, v in jt.params.items()}
        weights = ttrm.lm_random_params(shapes, seed=3, std=0.05)
        convert.load_trainer_params(tt, weights)
    else:
        weights = {k: v.numpy() for k, v in tt.params.items()}
    jt.params = {k: jnp.asarray(v) for k, v in weights.items()}
    jt._refresh_compute_cache()
    return jt, tt


def _run(jt, tt, batches):
    outs = []
    for d, lab in batches:
        jo = np.asarray(jt.step(data=d, softmax_label=lab)[0], np.float32)
        to = tt.step(data=d, softmax_label=lab)[0].float().numpy()
        outs.append((jo, to))
    return outs


def _cmp(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _cmp_scaled(got, want, tol, what):
    """Largest difference within ``tol`` of the tensor's largest value
    (gradient sums that cancel to near 0 have no relative precision)."""
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _noise_only(name):
    """The key biases: their gradient is 0 in exact arithmetic (softmax is
    invariant to adding q.b to every score of a row), so both packages
    update them by rounding noise alone, which differs."""
    return name.endswith("_k_bias")


def test_trainer_fp32_sgd_matches_jax():
    # momentum, weight decay (weights and gammas only), a global-norm
    # clip that bites, a frozen parameter and an lr schedule, over 3 steps
    jt, tt = _trainers("float32", "sgd",
                       {"lr": 0.5, "momentum": 0.9, "wd": 1e-3},
                       clip_global_norm=1.0,
                       fixed_param_names=("layer0_ln1_beta",),
                       lr_scheduler=lambda n: 0.5 / n)
    # fp32 on both sides: outputs (probabilities near 1/521) and masters
    # (|w| up to ~0.25) agree to fp32 reassociation, a few 1e-7 relative
    for jo, to in _run(jt, tt, _batches()):
        _cmp(to, jo, 1e-5, 1e-8, "softmax output")
    for k, w in tt.params.items():
        _cmp(w.numpy(), np.asarray(jt.params[k]), 1e-5, 1e-6, k)
        if k != "layer0_ln1_beta" and not _noise_only(k):
            _cmp_scaled(tt.opt_state[k][0].numpy(),
                        np.asarray(jt.opt_state[k][0]), 1e-4,
                        k + " momentum")
    assert "layer0_ln1_beta" not in tt.opt_state
    assert tt.current_lr() == jt.current_lr() == 0.5 / 4


def test_trainer_fp32_adam_matches_jax():
    jt, tt = _trainers("float32", "adam", {"lr": 1e-3, "wd": 1e-4})
    for jo, to in _run(jt, tt, _batches(seed=21)):
        _cmp(to, jo, 1e-5, 1e-8, "softmax output")
    # Adam divides each gradient by its own running RMS, so an entry
    # whose gradient is near rounding noise moves by up to lr per step
    # in whichever direction its noise points: masters agree to 5e-5
    # (5 % of the 3 steps' lr; measured 2.2e-5 at most), m and v to 1e-4
    # of each tensor's largest value
    for k, w in tt.params.items():
        if _noise_only(k):
            assert bool(torch.isfinite(w).all()), k
            continue
        _cmp(w.numpy(), np.asarray(jt.params[k]), 0, 5e-5, k)
        for i, what in enumerate(("mean", "var")):
            _cmp_scaled(tt.opt_state[k][i].numpy(),
                        np.asarray(jt.opt_state[k][i]), 1e-4,
                        f"{k} {what}")


def test_trainer_bf16_matches_jax_loosely():
    jt, tt = _trainers("bfloat16", "adam", {"lr": 1e-3})
    assert tt._cparams["lm_head_weight"].dtype == torch.bfloat16
    # bf16: the two round at other places (the JAX lax attention
    # promotes to fp32 after layer 0; the port's flash path stays bf16),
    # so activations part by a few bf16 ulps (2^-8 relative); the output
    # probabilities (~2e-3) agree to 3e-2 relative, far below what a
    # wrong token row (the bf16 id cast) or a wrong layer would move
    for jo, to in _run(jt, tt, _batches(seed=22)):
        _cmp(to, jo, 3e-2, 2e-5, "bf16 softmax output")
    for k, w in tt.params.items():
        assert w.dtype == torch.float32
        torch.testing.assert_close(tt._cparams[k], w.to(torch.bfloat16),
                                   atol=0, rtol=0)


def test_trainer_casts_ids_to_the_compute_dtype():
    tt = TTrainer(ttrm.transformer_lm(**TCFG), dtype="bfloat16",
                  device="cpu")
    ids = torch.tensor([[255.0, 257.0, 259.0, 517.0]])
    got = tt._args({"data": ids}, {})["data"]
    assert got.float().tolist() == [[255.0, 256.0, 260.0, 516.0]]


def test_trainer_step_has_no_host_sync(monkeypatch):
    jt, tt = _trainers("bfloat16", "adam", {"lr": 1e-3},
                       clip_global_norm=1.0)
    (d, lab), = _batches(1)

    def boom(*a, **k):
        raise AssertionError("host sync inside FusedTrainer.step")

    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    outs = tt.step(data=torch.from_numpy(d), softmax_label=torch.from_numpy(
        lab))
    monkeypatch.undo()
    assert outs[0].shape == (B * T, TCFG["vocab_size"])


def test_trainer_eval_matches_step_forward():
    jt, tt = _trainers("float32", "sgd", {"lr": 0.0})
    (d, lab), = _batches(1, seed=23)
    ev = tt.eval(data=d)[0]
    jev = np.asarray(jt.eval(data=d)[0])
    _cmp(ev.numpy(), jev, 1e-5, 1e-8, "eval output")
    st = tt.step(data=d, softmax_label=lab)[0]
    _cmp(st.numpy(), ev.numpy(), 0, 0, "step vs eval forward")


@pytest.mark.parametrize("kw,match", [
    ({"mesh": object()}, "mesh must be a parallel.mesh.Mesh"),
    ({"remat": True}, "item 4"),
    ({"sharding_rules": ("x",)}, "places nothing")],
    ids=["kw0-item 10", "kw1-item 4", "kw2-item 10"])
def test_trainer_refuses_what_is_not_ported(kw, match):
    """``mesh`` takes a ``parallel.mesh.Mesh`` and refuses anything else
    by name; ``sharding_rules`` without a mesh is kept and places
    nothing, as in the JAX trainer (whose step from the same weights the
    port's equals); ``remat=True`` is ported (item 4): a recomputed step
    equals the plain one from the same weights."""
    if "mesh" in kw:
        with pytest.raises(MXNetError, match=match):
            TTrainer(ttrm.transformer_lm(**SMALL), device="cpu", **kw)
        return
    if "sharding_rules" in kw:
        jt, tt = _trainers("float32", "sgd", {"lr": 0.1}, **kw)
        assert tt._sharding_rules == jt._sharding_rules == ("x",)
        assert tt.mesh is None and jt.mesh is None
        assert all(type(v) is torch.Tensor for v in tt.params.values())
        for jo, to in _run(jt, tt, _batches(1, seed=24)):
            _cmp(to, jo, 1e-5, 1e-8, "softmax output")
        return
    shapes = {"data": (2, 32), "softmax_label": (2, 32)}
    tts = [TTrainer(ttrm.transformer_lm(**SMALL), device="cpu",
                    optimizer_params={"lr": 0.1}, **k).init(**shapes)
           for k in (kw, {})]
    assert tts[0].remat and not tts[1].remat
    convert.load_trainer_params(
        tts[1], {k: v.numpy() for k, v in tts[0].params.items()})
    rs = np.random.RandomState(5)
    d = rs.randint(0, SMALL["vocab_size"], (2, 32)).astype(np.float32)
    outs = [t.step(data=d, softmax_label=d)[0] for t in tts]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for k in tts[0].params:
        torch.testing.assert_close(tts[0].params[k], tts[1].params[k],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method,match", [
    ("save_state", "item 7"), ("load_checkpoint", "item 7"),
    ("save_checkpoint", "item 7"), ("restore_state", "item 7"),
    ("rebind_mesh", "item 10")])
def test_trainer_methods_not_ported(method, match, tmp_path):
    """``rebind_mesh`` still raises; the item 7 methods are ported and
    need ``init()`` first, then round-trip the trainer's state."""
    tt = TTrainer(ttrm.transformer_lm(**SMALL), device="cpu")
    if match != "item 7":
        with pytest.raises(MXNetError, match=match):
            getattr(tt, method)()
        return
    target = str(tmp_path / "ck")
    args = {"save_state": (target,), "restore_state": (target,),
            "save_checkpoint": (target, 1), "load_checkpoint": (target, 1)}
    with pytest.raises(MXNetError, match="init"):
        getattr(tt, method)(*args[method])
    tt.init(data=(1, 32), softmax_label=(1, 32))
    saved = {k: v.clone() for k, v in tt.params.items()}
    if method in ("save_state", "restore_state"):
        tt.save_state(target, background=False)
    else:
        tt.save_checkpoint(target, 1)
    for v in tt.params.values():
        v.zero_()
    if method in ("save_state", "restore_state"):
        tt.restore_state(target)
    else:
        tt.load_checkpoint(target, 1)
    for k, v in saved.items():
        torch.testing.assert_close(tt.params[k], v, rtol=0, atol=0)


def test_trainer_refuses_the_sentinel(monkeypatch):
    """The sentinel is ported: it no longer refuses, and a clean step
    parks one record that the boundary check finds clean."""
    from mxnet_tpu_torch.telemetry import health

    monkeypatch.setenv("MXTPU_SENTINEL", "raise")
    health._pending.clear()
    tt = TTrainer(ttrm.transformer_lm(**SMALL), device="cpu").init(
        data=(1, 32), softmax_label=(1, 32))
    rs = np.random.RandomState(0)
    tt.step(data=rs.randint(0, SMALL["vocab_size"], (1, 32)).astype(
        np.float32), softmax_label=np.zeros((1, 32), np.float32))
    assert health.sentinel_pending() == 1
    assert health.sentinel_check() == []


def test_load_trainer_params_checks_names_and_shapes():
    tt = TTrainer(ttrm.transformer_lm(**SMALL), device="cpu").init(
        data=(1, 32), softmax_label=(1, 32))
    params = {k: np.zeros(tuple(v.shape), np.float32)
              for k, v in tt.params.items()}
    convert.load_trainer_params(tt, params)
    assert float(tt.params["lm_head_weight"].abs().sum()) == 0.0
    params.pop("pos_embed")
    with pytest.raises(MXNetError, match="pos_embed"):
        convert.load_trainer_params(tt, params)
    params["pos_embed"] = np.zeros((1, 31, 64), np.float32)
    with pytest.raises(MXNetError, match="shape"):
        convert.load_trainer_params(tt, params)


# vocab 32768 as in MFU_HEADLINE_CONFIG: Adam at lr 1e-4 on one repeated
# batch, bf16 compute with fp32 masters, weights from the port's own
# initializer and the batch from numpy, both seeded 0 as the full-width
# chip run draws them.  At 4 layers x 512 x 256 tokens the cross-entropy
# rises at step 4 and falls again, the pattern that run shows at step 3;
# the JAX package does the same, so it is the reference's Adam (no bias
# correction: the first updates are ~3x lr per weight), not a port fault.
LM4 = dict(num_layers=4, num_heads=8, d_model=512, seq_len=256,
           vocab_size=32768)


def test_trainer_bf16_adam_loss_curve_matches_jax():
    b, t, vocab = 2, LM4["seq_len"], LM4["vocab_size"]
    jt, tt = _trainers("bfloat16", "adam", {"lr": 1e-4}, cfg=LM4,
                       batch=(b, t), init_seed=0)
    rng = np.random.default_rng(0)
    data = rng.integers(0, vocab, (b, t)).astype(np.float32)
    label = rng.integers(0, vocab, (b, t)).astype(np.float32)
    rows = np.arange(b * t)
    lab = label.reshape(-1).astype(np.int64)

    def ce(p):
        return float(-np.log(np.maximum(p[rows, lab], 1e-30)).mean())

    jce, tce = zip(*(map(ce, outs)
                     for outs in _run(jt, tt, [(data, label)] * 5)))
    # bf16 rounds at other places in the two packages (see above): the
    # losses (~10) agree to 1e-2, a tenth of the smallest step between them
    np.testing.assert_allclose(tce, jce, rtol=0, atol=1e-2)
    for curve in (jce, tce):
        steps = np.diff(curve)
        assert [i for i, d in enumerate(steps) if d > 0] == [2], curve
        assert np.abs(steps).min() > 0.1, curve
