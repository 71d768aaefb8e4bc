"""The op set of ``ops/matrix.py``, ``ops/reduce.py``, ``ops/indexing.py``,
``ops/loss.py``, ``ops/init_sample.py`` and ``ops/sequence.py`` in the
port against the JAX package's, on the CPU.

Each case runs the op's forward and, where it has one, its gradient (a
seeded cotangent through ``jax.vjp`` and ``torch.autograd.grad``; the
loss heads ignore it on both sides) on numpy-seeded inputs.  Ids and
labels are inputs without a gradient.  Tie cases pin what the two
libraries could do differently: ``argsort(is_ascend=False)`` gives ties
in reverse index order, argmax/argmin take the first index, and the
gradient of ``max``/``min`` at a tie splits evenly among the tied
entries.  The samplers are compared by statistics (the packages'
generators differ).

Tolerances: fp32 ``1e-5`` relative and absolute (the same arithmetic
summed in another order; products and the RNN-free reductions over at
most 60 terms); bf16 ``2e-2`` (each side rounds every intermediate to
bf16, a relative step of 2^-8).  Indices, masks and copies are held to
equality.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu import ops as jops

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.ops import registry as treg

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the reference's names the port leaves to ROADMAP Queue 1 item 11
UNPORTED_MODULES = ("mxnet_tpu.ops.vision", "mxnet_tpu.ops.ctc")


def _n(seed, *shape, scale=1.0):
    return np.asarray(np.random.RandomState(seed).normal(size=shape)
                      * scale, dtype=np.float32)


def _ids(seed, high, *shape, low=0):
    return np.random.RandomState(seed).randint(low, high, shape).astype(
        np.float32)


def _round(a, dtype):
    if dtype == "bfloat16" and a.dtype == np.float32:
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _run(name, ins, attrs, dtype="float32", diff=None, is_train=False,
         aux=()):
    """``[(jax, port)]`` numpy pairs: each output, then the gradient of
    each input listed in ``diff`` (default: all) under a seeded
    cotangent.  ``aux`` values go in after the inputs; a (out, aux)
    result is compared as its output and its new aux values."""
    diff = tuple(range(len(ins))) if diff is None else tuple(diff)
    ins = [_round(a, dtype) for a in ins]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jins = [jnp.asarray(a, dtype=jdt if i in diff else jnp.float32)
            for i, a in enumerate(ins)]
    ts = [torch.from_numpy(a).to(tdt if i in diff else torch.float32)
          .requires_grad_(i in diff) for i, a in enumerate(ins)]
    jaux = [jnp.asarray(a) for a in aux]
    taux = [torch.from_numpy(a) for a in aux]
    jop, top = jops.get(name), treg.get(name)
    jaux_new = []

    def jfn(*xs):
        full = list(jins)
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fn(jops.OpCtx(is_train=is_train), *full, *jaux, **attrs)
        if jop.aux_names:
            out, new = out
            jaux_new[:] = list(new)
        return out

    jout, vjp = jax.vjp(jfn, *[jins[i] for i in diff])
    tout = top.fn(treg.OpCtx(is_train=is_train), *ts, *taux, **attrs)
    taux_new = []
    if top.aux_names:
        tout, taux_new = tout
    jouts = list(jout) if isinstance(jout, tuple) else [jout]
    touts = list(tout) if isinstance(tout, tuple) else [tout]
    pairs = []
    for j, t in zip(jouts, touts):
        assert str(t.dtype).split(".")[1] == str(np.dtype(j.dtype)), \
            (name, t.dtype, j.dtype)
        assert tuple(t.shape) == tuple(j.shape), (name, t.shape, j.shape)
        pairs.append((np.asarray(j, dtype=np.float32),
                      t.detach().float().numpy()))
    for j, t in zip(jaux_new, taux_new):
        pairs.append((np.asarray(j, dtype=np.float32),
                      t.detach().float().numpy()))
    if not diff or not any(o.dtype.is_floating_point and o.requires_grad
                           for o in touts):
        return pairs
    cts = [_round(_n(100 + i, *t.shape), dtype) for i, t in enumerate(touts)]
    jgrads = vjp(tuple(jnp.asarray(c, dtype=j.dtype)
                       for c, j in zip(cts, jouts))
                 if isinstance(jout, tuple)
                 else jnp.asarray(cts[0], dtype=jouts[0].dtype))
    tgrads = torch.autograd.grad(
        [o for o in touts if o.requires_grad], [ts[i] for i in diff],
        [torch.from_numpy(c).to(o.dtype) for c, o in zip(cts, touts)
         if o.requires_grad], allow_unused=True)
    for jg, tg in zip(jgrads, tgrads):
        jg = np.asarray(jg, dtype=np.float32)
        tg = np.zeros_like(jg) if tg is None else tg.float().numpy()
        pairs.append((jg, tg))
    return pairs


def _check(pairs, tol):
    for j, t in pairs:
        assert j.shape == t.shape, (j.shape, t.shape)
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


# name -> (op, inputs() -> list of arrays, attrs, inputs with a gradient)
CASES = {
    # --- matrix
    "dot_2d": ("dot", lambda: [_n(1, 3, 4), _n(2, 4, 5)], {}, None),
    "dot_transpose_a": ("dot", lambda: [_n(1, 4, 3), _n(2, 4, 5)],
                        {"transpose_a": "True"}, None),
    "dot_transpose_b": ("dot", lambda: [_n(1, 3, 4), _n(2, 5, 4)],
                        {"transpose_b": True}, None),
    "dot_vectors": ("dot", lambda: [_n(1, 7), _n(2, 7)], {}, None),
    "dot_vector_matrix": ("dot", lambda: [_n(1, 4), _n(2, 4, 5)], {}, None),
    "dot_3d_2d": ("dot", lambda: [_n(1, 2, 3, 4), _n(2, 4, 5)], {}, None),
    "dot_2d_3d": ("dot", lambda: [_n(1, 3, 4), _n(2, 2, 4, 5)], {}, None),
    "batch_dot": ("batch_dot", lambda: [_n(1, 2, 3, 4), _n(2, 2, 4, 5)], {},
                  None),
    "batch_dot_ta": ("batch_dot", lambda: [_n(1, 2, 4, 3), _n(2, 2, 4, 5)],
                     {"transpose_a": True}, None),
    "batch_dot_tb": ("batch_dot", lambda: [_n(1, 2, 3, 4), _n(2, 2, 5, 4)],
                     {"transpose_b": "1"}, None),
    "swapaxis": ("SwapAxis", lambda: [_n(3, 2, 3, 4)],
                 {"dim1": 0, "dim2": 2}, None),
    "swapaxes": ("swapaxes", lambda: [_n(3, 2, 3, 4)],
                 {"dim1": "1", "dim2": "2"}, None),
    "expand_dims": ("expand_dims", lambda: [_n(4, 2, 3)], {"axis": 1}, None),
    "expand_dims_last": ("expand_dims", lambda: [_n(4, 2, 3)],
                         {"axis": "-1"}, None),
    "flip": ("flip", lambda: [_n(5, 2, 3, 4)], {"axis": 1}, None),
    "flip_axes": ("flip", lambda: [_n(5, 2, 3, 4)], {"axis": "(0, 2)"},
                  None),
    "repeat": ("repeat", lambda: [_n(6, 2, 3)], {"repeats": 2, "axis": 1},
               None),
    "repeat_flat": ("repeat", lambda: [_n(6, 2, 3)], {"repeats": "3"}, None),
    "tile": ("tile", lambda: [_n(7, 2, 3)], {"reps": (2, 1, 3)}, None),
    "tile_short": ("tile", lambda: [_n(7, 2, 3)], {"reps": "(2,)"}, None),
    "sort": ("sort", lambda: [_n(8, 3, 5)], {}, None),
    "sort_descending": ("sort", lambda: [_n(8, 3, 5)],
                        {"axis": 0, "is_ascend": "False"}, None),
    "sort_flat": ("sort", lambda: [_n(8, 3, 5)], {"axis": "None"}, None),
    "argsort": ("argsort", lambda: [_n(9, 3, 6)], {}, ()),
    "reshape": ("reshape", lambda: [_n(10, 2, 3, 4)], {"shape": (0, -1)},
                None),
    "identity_like_rhs": ("_identity_with_attr_like_rhs",
                          lambda: [_n(11, 2, 3), _n(12, 2, 3)], {}, None),
    "crop_assign": ("_crop_assign", lambda: [_n(13, 4, 5), _n(14, 2, 3)],
                    {"begin": (1, 1), "end": (3, 4)}, None),
    "crop_assign_scalar": ("_crop_assign_scalar", lambda: [_n(15, 4, 5)],
                           {"begin": "(0, 2)", "end": "(2, 5)",
                            "scalar": "2.5"}, None),
    # --- reduce
    "sum": ("sum", lambda: [_n(16, 3, 4, 5)], {"axis": 1}, None),
    "sum_all": ("sum", lambda: [_n(16, 3, 4, 5)], {}, None),
    "sum_axis_keep": ("sum_axis", lambda: [_n(16, 3, 4, 5)],
                      {"axis": "(0, 2)", "keepdims": "True"}, None),
    "mean": ("mean", lambda: [_n(17, 3, 4, 5)], {"axis": (1, 2)}, None),
    "prod": ("prod", lambda: [_n(18, 3, 4, 2)], {"axis": (0, 2)}, None),
    "prod_keep": ("prod", lambda: [_n(18, 3, 4, 2)],
                  {"axis": 1, "keepdims": True}, None),
    "prod_all": ("prod", lambda: [_n(18, 2, 3)], {}, None),
    "max": ("max", lambda: [_n(19, 3, 4, 5)], {"axis": 2}, None),
    "max_axis_all": ("max_axis", lambda: [_n(19, 3, 4, 5)], {}, None),
    "min": ("min", lambda: [_n(20, 3, 4, 5)],
            {"axis": (0, 1), "keepdims": "1"}, None),
    "min_axis": ("min_axis", lambda: [_n(20, 3, 4, 5)], {"axis": "0"},
                 None),
    "norm": ("norm", lambda: [_n(21, 3, 4)], {}, None),
    "argmax": ("argmax", lambda: [_n(22, 3, 5)], {"axis": 1}, ()),
    "argmax_keep": ("argmax", lambda: [_n(22, 3, 5)],
                    {"axis": "0", "keepdims": "True"}, ()),
    "argmax_flat": ("argmax", lambda: [_n(22, 3, 5)], {}, ()),
    "argmin": ("argmin", lambda: [_n(23, 3, 5)], {"axis": -1}, ()),
    "argmax_channel": ("argmax_channel", lambda: [_n(24, 2, 4, 3)], {}, ()),
    # --- indexing
    "take": ("take", lambda: [_n(25, 6, 3),
                              np.array([[0, 5], [7.9, -2], [3.5, 1]],
                                       np.float32)], {}, (0,)),
    "batch_take": ("batch_take", lambda: [_n(26, 4, 5),
                                          np.array([0, 4, -1, 2],
                                                   np.float32)], {}, (0,)),
    "choose_element_0index": ("choose_element_0index",
                              lambda: [_n(27, 4, 5),
                                       np.array([1, 3, 0, 9], np.float32)],
                              {}, (0,)),
    "fill_element_0index": ("fill_element_0index",
                            lambda: [_n(28, 4, 5), _n(29, 4),
                                     np.array([1, 3, -1, 7], np.float32)],
                            {}, (0, 1)),
    # --- loss
    "linear_regression": ("LinearRegressionOutput",
                          lambda: [_n(30, 4, 3), _n(31, 4, 3)],
                          {"grad_scale": 2.0}, (0,)),
    "linear_regression_column": ("LinearRegressionOutput",
                                 lambda: [_n(30, 4, 1), _n(31, 4)], {},
                                 (0,)),
    "logistic_regression": ("LogisticRegressionOutput",
                            lambda: [_n(32, 4, 3),
                                     _ids(33, 2, 4, 3)], {}, (0,)),
    "mae_regression": ("MAERegressionOutput",
                       lambda: [_n(34, 4, 3), _n(35, 4, 3)],
                       {"grad_scale": "0.5"}, (0,)),
    "svm_l2": ("SVMOutput", lambda: [_n(36, 5, 4), _ids(37, 4, 5)],
               {"margin": 0.5, "regularization_coefficient": 2.0}, (0,)),
    "svm_l1": ("SVMOutput", lambda: [_n(36, 5, 4), _ids(37, 4, 5)],
               {"use_linear": "True"}, (0,)),
    "make_loss": ("MakeLoss", lambda: [_n(38, 4, 3)], {"grad_scale": 3.0},
                  None),
    "make_loss_batch": ("MakeLoss", lambda: [_n(38, 4, 3)],
                        {"normalization": "batch"}, None),
    "make_loss_valid": ("MakeLoss", lambda: [_n(38, 4, 3)],
                        {"normalization": "valid"}, None),
    "softmax_cross_entropy": ("softmax_cross_entropy",
                              lambda: [_n(39, 5, 6), _ids(40, 6, 5)], {},
                              (0,)),
    "softmax_cross_entropy_outside": ("softmax_cross_entropy",
                                      lambda: [_n(39, 5, 6),
                                               np.array([1, 6, -1, 8, 0],
                                                        np.float32)], {},
                                      (0,)),
    "softmax_activation": ("SoftmaxActivation", lambda: [_n(41, 2, 3, 4)],
                           {}, None),
    "softmax_activation_channel": ("SoftmaxActivation",
                                   lambda: [_n(41, 2, 3, 4)],
                                   {"mode": "channel"}, None),
    "softmax_multi_output": ("SoftmaxOutput",
                             lambda: [_n(42, 3, 4, 5), _ids(43, 4, 3, 5)],
                             {"multi_output": "True"}, (0,)),
    "softmax_multi_output_ignore": (
        "SoftmaxOutput", lambda: [_n(42, 3, 4, 5), _ids(43, 4, 3, 5)],
        {"multi_output": True, "use_ignore": True, "ignore_label": 0,
         "normalization": "valid"}, (0,)),
    "softmax_multi_output_batch": (
        "SoftmaxOutput", lambda: [_n(42, 3, 4, 5), _ids(43, 4, 3, 5)],
        {"multi_output": True, "normalization": "batch",
         "grad_scale": 0.5}, (0,)),
    "softmax_multi_output_valid": (
        "SoftmaxOutput", lambda: [_n(42, 3, 4, 5), _ids(43, 4, 3, 5)],
        {"multi_output": True, "normalization": "valid"}, (0,)),
    "softmax_multi_output_2d": ("SoftmaxOutput",
                                lambda: [_n(44, 4, 5), _ids(45, 5, 4)],
                                {"multi_output": True, "use_ignore": True,
                                 "ignore_label": 2}, (0,)),
    "softmax_preserve_shape": ("SoftmaxOutput",
                               lambda: [_n(44, 4, 5), _ids(45, 5, 4)],
                               {"preserve_shape": "True"}, (0,)),
    # --- sequence (time-major)
    "sequence_last": ("SequenceLast", lambda: [_n(46, 5, 3, 2)], {}, None),
    "sequence_last_lengths": ("SequenceLast",
                              lambda: [_n(46, 5, 3, 2),
                                       np.array([2, 5, 1], np.float32)],
                              {"use_sequence_length": True}, (0,)),
    "sequence_mask": ("SequenceMask", lambda: [_n(47, 5, 3, 2)], {}, None),
    "sequence_mask_lengths": ("SequenceMask",
                              lambda: [_n(47, 5, 3, 2),
                                       np.array([2, 5, 0], np.float32)],
                              {"use_sequence_length": "True",
                               "value": -1.5}, (0,)),
    "sequence_reverse": ("SequenceReverse", lambda: [_n(48, 5, 3, 2)], {},
                         None),
    "sequence_reverse_lengths": ("SequenceReverse",
                                 lambda: [_n(48, 5, 3, 2),
                                          np.array([3, 5, 1], np.float32)],
                                 {"use_sequence_length": True}, (0,)),
    "sequence_lengths_outside": ("SequenceReverse",
                                 lambda: [_n(48, 5, 3, 2),
                                          np.array([7, 0, 2], np.float32)],
                                 {"use_sequence_length": True}, (0,)),
    "sequence_last_outside": ("SequenceLast",
                              lambda: [_n(46, 5, 3, 2),
                                       np.array([0, 9, 3], np.float32)],
                              {"use_sequence_length": True}, (0,)),
}
# the cases run in bf16 too (the others are copies, index arithmetic or
# fp32 heads)
BF16 = ("dot_2d", "dot_3d_2d", "batch_dot", "swapaxis", "flip", "tile",
        "sort_descending", "sum", "mean", "max", "min", "norm", "take",
        "crop_assign", "linear_regression", "logistic_regression",
        "svm_l2", "softmax_cross_entropy", "softmax_activation",
        "softmax_multi_output_ignore", "sequence_mask_lengths",
        "sequence_reverse_lengths")


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_fp32(case):
    name, make, attrs, diff = CASES[case]
    _check(_run(name, make(), attrs, diff=diff), TOL["float32"])


@pytest.mark.parametrize("case", BF16)
def test_op_matches_jax_bf16(case):
    name, make, attrs, diff = CASES[case]
    _check(_run(name, make(), attrs, "bfloat16", diff=diff),
           TOL["bfloat16"])


def test_registry_is_the_reference_but_vision_ctc_custom():
    # the reference's own names: a plugin that another test imports
    # (mxnet_tpu/plugins/) registers more into the JAX registry.  The
    # Custom op is ported: the names still lacking are those of vision
    # and ctc
    jnames = {n for n in jops.list_ops()
              if not jops.get(n).fn.__module__.startswith(
                  "mxnet_tpu.plugins.")}
    assert len(jnames) == 227
    unported = {n for n in jnames
                if jops.get(n).fn.__module__ in UNPORTED_MODULES}
    assert len(unported) == 17
    assert set(treg.list_ops()) == jnames - unported
    assert len(treg.list_ops()) == 210
    assert "Custom" in treg.list_ops()


@pytest.mark.parametrize("module", ["matrix", "reduce", "indexing", "loss",
                                    "init_sample", "sequence"])
def test_op_signatures_match_the_reference(module):
    jnames = {n for n in jops.list_ops()
              if jops.get(n).fn.__module__ == f"mxnet_tpu.ops.{module}"}
    for n in sorted(jnames):
        j, t = jops.get(n), treg.get(n)
        assert (tuple(j.arg_names), tuple(j.aux_names), j.num_outputs,
                tuple(j.output_names), j.needs_rng) == (
            tuple(t.arg_names), tuple(t.aux_names), t.num_outputs,
            tuple(t.output_names), t.needs_rng), n


# ------------------------------------------------------------ ties
def test_argsort_descending_gives_ties_in_reverse_index_order():
    data = np.array([[1.0, 3.0, 1.0, 3.0, 2.0, 1.0]], np.float32)
    for attrs in ({"is_ascend": False}, {"is_ascend": True},
                  {"is_ascend": "False", "axis": "None"}):
        (j, t), = _run("argsort", [data], attrs, diff=())
        np.testing.assert_array_equal(t, j)
    (j, t), = _run("argsort", [data], {"is_ascend": False}, diff=())
    np.testing.assert_array_equal(t[0], [3, 1, 4, 5, 2, 0])


@pytest.mark.parametrize("ret_typ", ["indices", "value", "both", "mask"])
@pytest.mark.parametrize("ascend", [False, True])
def test_topk_with_ties_matches_jax(ret_typ, ascend):
    data = np.array([[2.0, 5.0, 2.0, 5.0, 1.0, 2.0],
                     [0.5, 0.5, 0.5, 3.0, -1.0, 4.0]], np.float32)
    attrs = {"k": 3, "ret_typ": ret_typ, "is_ascend": ascend}
    pairs = _run("topk", [data], attrs, diff=())
    for j, t in pairs:
        np.testing.assert_array_equal(t, j)
    pairs = _run("topk", [data.T.copy()], dict(attrs, axis=0, k=2),
                 diff=())
    for j, t in pairs:
        np.testing.assert_array_equal(t, j)


def test_argsort_indices_round_in_bf16_like_jax():
    data = np.arange(600, dtype=np.float32)[::-1].copy()
    (j, t), = _run("argsort", [data], {}, "bfloat16", diff=())
    np.testing.assert_array_equal(t, j)
    assert (t != np.arange(600)[::-1]).any()   # ids above 256 rounded


@pytest.mark.parametrize("op", ["argmax", "argmin"])
def test_arg_reduce_ties_take_the_first_index(op):
    data = np.array([[1.0, 4.0, 4.0, 0.0], [0.0, 0.0, 2.0, 2.0]],
                    np.float32)
    for attrs in ({"axis": 1}, {"axis": 0}, {}):
        (j, t), = _run(op, [data], attrs, diff=())
        np.testing.assert_array_equal(t, j)
    (j, t), = _run("argmax", [data], {"axis": 1}, diff=())
    np.testing.assert_array_equal(t, [1, 2])


@pytest.mark.parametrize("op,attrs", [("max", {"axis": 1}), ("max", {}),
                                      ("min", {"axis": (0, 1)}),
                                      ("max_axis", {"axis": 0}),
                                      ("min_axis", {"axis": 1,
                                                    "keepdims": True})])
def test_max_min_tie_gradient_splits_like_jax(op, attrs):
    data = np.array([[3.0, 3.0, 1.0], [-2.0, 0.5, -2.0], [3.0, 0.5, 0.5]],
                    np.float32)
    pairs = _run(op, [data], attrs)
    _check(pairs, 1e-6)
    if op == "max" and attrs == {"axis": 1}:
        grad = pairs[-1][1]
        ct = _n(100, 3)
        np.testing.assert_allclose(grad[0, :2], [ct[0] / 2] * 2, rtol=1e-6)


@pytest.mark.parametrize("op", ["nansum", "nanprod"])
def test_nan_reductions_match_jax(op):
    data = _n(49, 3, 4)
    data[0, 1] = data[2, 3] = np.nan
    for attrs in ({"axis": 1}, {}, {"axis": 0, "keepdims": True}):
        _check(_run(op, [data], attrs), 1e-5)


# ----------------------------------------------------- aux and heads
def test_identity_attach_kl_sparse_reg_matches_jax():
    data = np.abs(_n(50, 4, 3, 2)) * 0.2
    avg = np.array([0.05, 0.2, 0.5], np.float32)
    attrs = {"penalty": 0.01, "sparseness_target": 0.1, "momentum": 0.8}
    for is_train in (True, False):
        pairs = _run("IdentityAttachKLSparseReg", [data], attrs,
                     is_train=is_train, aux=[avg])
        assert len(pairs) == 3        # output, new moving_avg, gradient
        _check(pairs, 1e-5)


def test_loss_heads_ignore_the_head_gradient():
    data = _n(51, 4, 3)
    label = _n(52, 4, 3)
    for name in ("LinearRegressionOutput", "LogisticRegressionOutput",
                 "MAERegressionOutput", "MakeLoss"):
        fn = treg.get(name).fn
        grads = []
        for head in (torch.ones(4, 3), torch.from_numpy(_n(53, 4, 3))):
            x = torch.from_numpy(data).requires_grad_(True)
            ins = (x,) if name == "MakeLoss" else (x, torch.from_numpy(label))
            fn(treg.OpCtx(), *ins).backward(head)
            grads.append(x.grad)
        assert torch.equal(grads[0], grads[1]), name


def test_softmax_output_refuses_3d_data_without_multi_output():
    fn = treg.get("SoftmaxOutput").fn
    for attrs in ({}, {"preserve_shape": True}):
        with pytest.raises(MXNetError, match="without multi_output"):
            fn(treg.OpCtx(), torch.zeros(2, 3, 4), torch.zeros(2), **attrs)


def test_new_heads_infer_their_label_shapes():
    x = tsym.Variable("data")
    for op, shape, want in (("LinearRegressionOutput", (4, 1), (4,)),
                            ("MAERegressionOutput", (4, 3), (4, 3)),
                            ("SVMOutput", (4, 3), (4,)),
                            ("softmax_cross_entropy", (4, 3), (4,))):
        net = getattr(tsym, op)(x, name="out")
        args, _, _ = net.infer_shape(data=shape)
        assert dict(zip(net.list_arguments(), args))["out_label"] == want
    net = tsym.SoftmaxOutput(x, multi_output=True, name="sm")
    args, _, _ = net.infer_shape(data=(2, 5, 3, 3))
    assert dict(zip(net.list_arguments(), args))["sm_label"] == (2, 3, 3)


# -------------------------------------------------------------- samplers
@pytest.mark.parametrize("name", ["uniform", "_sample_uniform",
                                  "random_uniform"])
def test_uniform_by_statistics(name):
    trandom.seed(3)
    a = getattr(tnd, name)(low=-2.0, high=3.0, shape=(200, 100), ctx="cpu")
    x = a.asnumpy()
    assert x.shape == (200, 100) and x.dtype == np.float32
    assert x.min() >= -2.0 and x.max() < 3.0
    sigma = 5.0 / np.sqrt(12 * x.size)
    assert abs(x.mean() - 0.5) < 4 * sigma
    assert abs(x.std() - 5.0 / np.sqrt(12)) < 0.02
    trandom.seed(3)
    b = getattr(tnd, name)(low=-2.0, high=3.0, shape=(200, 100), ctx="cpu")
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    jx = np.asarray(jops.get(name).fn(
        jops.OpCtx(key=jax.random.PRNGKey(0)), low=-2.0, high=3.0,
        shape=(200, 100)))
    assert abs(jx.mean() - x.mean()) < 8 * sigma


@pytest.mark.parametrize("name", ["normal", "_sample_normal",
                                  "random_normal"])
def test_normal_by_statistics(name):
    trandom.seed(4)
    x = getattr(tnd, name)(loc=1.5, scale=0.5, shape=(200, 100),
                           ctx="cpu").asnumpy()
    assert x.shape == (200, 100)
    assert abs(x.mean() - 1.5) < 4 * 0.5 / np.sqrt(x.size)
    assert abs(x.std() - 0.5) < 0.01
    jx = np.asarray(jops.get(name).fn(
        jops.OpCtx(key=jax.random.PRNGKey(1)), loc=1.5, scale=0.5,
        shape=(200, 100)))
    assert abs(jx.std() - x.std()) < 0.02


def test_sampler_dtype_and_symbol():
    trandom.seed(5)
    x = tnd.uniform(shape=(3, 4), dtype="bfloat16", ctx="cpu")
    assert x.tensor.dtype == torch.bfloat16
    net = tsym.normal(shape=(2, 3), name="n") + tsym.Variable("data")
    exe = net.simple_bind("cpu", data=(2, 3))
    out = exe.forward(is_train=True)[0]
    assert out.shape == (2, 3) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------- nd and sym
def test_nd_reductions_and_reshape_keep_the_builtins():
    # the generated nd.max / nd.min / nd.sum shadow the builtins in
    # ndarray.py; NDArray.reshape must not depend on them
    x = tnd.array(np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                  ctx="cpu")
    assert x.reshape((-1, 4)).shape == (6, 4)
    assert x.reshape((4, -1)).shape == (4, 6)
    np.testing.assert_array_equal(tnd.max(x, axis=2).asnumpy(),
                                  np.arange(24).reshape(2, 3, 4).max(2))
    np.testing.assert_array_equal(tnd.sum(x).asnumpy(), 276.0)
    np.testing.assert_array_equal(tnd.argmax(x, axis=1).asnumpy(),
                                  np.full((2, 4), 2.0))


def test_symbol_constructors_of_the_new_ops_match_jax_json():
    from mxnet_tpu import base as jbase
    from mxnet_tpu import symbol as jsym
    from mxnet_tpu_torch import base as tbase

    def build(s):
        x = s.Variable("data")
        y = s.SwapAxis(s.expand_dims(x, axis=1), dim1=0, dim2=2)
        y = s.sum(s.dot(y, s.Variable("w")), axis=1, keepdims=True)
        y = s.SequenceMask(y, s.Variable("len"), use_sequence_length=True)
        return s.Group([s.MakeLoss(y), s.argmax(x, axis=1),
                        s.LinearRegressionOutput(x, name="lin"),
                        s.topk(x, k=2, ret_typ="both")])

    with jbase.NameManager():
        want = build(jsym).tojson()
    old = tbase._NAME_MANAGER
    tbase._NAME_MANAGER = tbase.NameManager()
    try:
        got = build(tsym).tojson()
    finally:
        tbase._NAME_MANAGER = old
    assert got == want
