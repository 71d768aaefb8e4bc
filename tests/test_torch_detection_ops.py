"""The op set of ``ops/vision.py`` (its 14 registry names) in the port
against the JAX package's, on the CPU.

Each case runs the op's forward and, where it has one, its gradient (a
seeded cotangent through ``jax.vjp`` and ``torch.autograd.grad``) on
numpy-seeded inputs, as ``test_torch_op_set._run`` does, but with the
JAX side under one ``jax.jit`` (compiling the op whole takes a fifth of
the time of compiling each of its primitives eagerly).  Box
coordinates, RoIs, labels and image info are inputs without a gradient
unless a case lists them.  The tie cases pin what the two libraries
could do differently: stable sorts (negative mining, NMS order,
``Proposal``'s two sorts), the first maximum of ``argmax``, the gradient
of a max split evenly among tied maxima (``ROIPooling``), C's rounding
of .5 away from zero, and the anchor two ground truths claim (the later
one in label order wins, as the JAX op's scatter does on the CPU).

Tolerance: fp32 ``1e-5`` relative and absolute (the same arithmetic in
another order); indices, class ids and masks are held to equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu import ops as jops

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from test_torch_op_set import _check, _n

TOL = 1e-5
RCNN = {"feature_stride": 4, "scales": (2, 4, 8), "ratios": (0.5, 1, 2),
        "rpn_pre_nms_top_n": 64, "rpn_post_nms_top_n": 16,
        "threshold": 0.7, "rpn_min_size": 4}
SSD_TARGET = {"overlap_threshold": 0.5, "ignore_label": -1,
              "negative_mining_ratio": 3, "negative_mining_thresh": 0.5,
              "variances": (0.1, 0.1, 0.2, 0.2)}


def _run(name, ins, attrs, diff=None):
    """``[(jax, port)]`` numpy pairs: each output, then the gradient of
    each input listed in ``diff`` (default: all) under cotangents
    ``_n(100 + i, ...)``, where the port's output has a gradient."""
    diff = tuple(range(len(ins))) if diff is None else tuple(diff)
    jop, top = jops.get(name), treg.get(name)
    ts = [torch.from_numpy(np.array(a)).requires_grad_(i in diff)
          for i, a in enumerate(ins)]
    tout = top.fn(treg.OpCtx(), *ts, **attrs)
    touts = list(tout) if isinstance(tout, tuple) else [tout]
    cts = tuple(_n(100 + i, *o.shape) for i, o in enumerate(touts))

    def f(dins, cts):
        def g(*xs):
            full = [jnp.asarray(a) for a in ins]
            for i, x in zip(diff, xs):
                full[i] = x
            out = jop.fn(None, *full, **attrs)
            return tuple(out) if isinstance(out, tuple) else (out,)

        if not dins:
            return g(), ()
        out, vjp = jax.vjp(g, *dins)
        return out, vjp(cts)

    jouts, jgrads = jax.jit(f)(tuple(jnp.asarray(ins[i]) for i in diff),
                               cts)
    pairs = []
    for j, t in zip(jouts, touts):
        assert str(t.dtype).split(".")[1] == str(np.dtype(j.dtype)), \
            (name, t.dtype, j.dtype)
        assert tuple(t.shape) == tuple(j.shape), (name, t.shape, j.shape)
        pairs.append((np.asarray(j), t.detach().numpy()))
    if not diff or not any(o.requires_grad for o in touts):
        return pairs
    tgrads = torch.autograd.grad(
        [o for o in touts if o.requires_grad], [ts[i] for i in diff],
        [torch.from_numpy(c) for c, o in zip(cts, touts) if o.requires_grad],
        allow_unused=True)
    for jg, tg in zip(jgrads, tgrads):
        jg = np.asarray(jg)
        pairs.append((jg, np.zeros_like(jg) if tg is None else tg.numpy()))
    return pairs


def _u(seed, *shape, low=0.0, high=1.0):
    return np.random.RandomState(seed).uniform(low, high, shape).astype(
        np.float32)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _prior(h, w, sizes=(0.2, 0.272), ratios=(1, 2, 0.5)):
    """Anchors of MultiBoxPrior, (1, h * w * A, 4)."""
    return np.asarray(jops.get("MultiBoxPrior").fn(
        None, jnp.zeros((1, 1, h, w)), sizes=sizes, ratios=ratios))


def _labels(seed, n, m, valid):
    """(n, m, 5) ground truths [cls, x1, y1, x2, y2], rows past
    ``valid[i]`` padded with -1."""
    rs = np.random.RandomState(seed)
    lab = np.full((n, m, 5), -1.0, np.float32)
    for i in range(n):
        for j in range(valid[i]):
            w, h = rs.uniform(0.15, 0.5, 2)
            x1, y1 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            lab[i, j] = [rs.randint(0, 3), x1, y1, x1 + w, y1 + h]
    return lab


def _rois():
    """RoIs on a (2, C, 12, 12) map at spatial_scale 0.5: an ordinary
    box, one with coordinates whose scaled values end in .5 (C rounds
    them away from zero), one past the image (empty bins), a one-pixel
    box and a batch index of 1."""
    return np.array([[0, 2.0, 3.0, 17.0, 20.0],
                     [1, 3.0, 5.0, 13.0, 9.0],     # 1.5, 2.5, 6.5, 4.5
                     [1, 20.0, 4.0, 40.0, 30.0],   # x beyond 12: empty
                     [0, 6.0, 6.0, 6.0, 6.0],
                     [1, 0.0, 0.0, 23.0, 23.0]], np.float32)


def _tied_map():
    """Integer values in a small range: tied maxima in most bins."""
    return np.random.RandomState(7).randint(0, 3, (2, 3, 12, 12)).astype(
        np.float32)


def _detection_inputs(seed, n=2, classes=3, h=4, w=4):
    anchors = _prior(h, w)
    a = anchors.shape[1]
    probs = _softmax(_n(seed, n, classes + 1, a, scale=2.0), axis=1)
    loc = _n(seed + 1, n, a * 4, scale=0.5)
    return [probs, loc, anchors]


def _proposal_inputs(seed, n=2, fh=16, fw=16, a0=9):
    scores = _softmax(_n(seed, n, 2, a0 * fh * fw, scale=2.0), axis=1)
    cls_prob = scores.reshape(n, 2 * a0, fh, fw)
    bbox = _n(seed + 1, n, 4 * a0, fh, fw, scale=0.2)
    im_info = np.array([[64, 64, 1.0], [60, 56, 1.0]][:n], np.float32)
    return [cls_prob, bbox, im_info]


# name -> (op, inputs() -> arrays, attrs, inputs with a gradient)
CASES = {
    # --- the spatial transformer family
    "grid_affine": ("GridGenerator",
                    lambda: [_n(1, 2, 6)],
                    {"transform_type": "affine", "target_shape": (5, 7)},
                    None),
    "grid_affine_one_row": ("GridGenerator", lambda: [_n(1, 2, 6)],
                            {"target_shape": "(1, 4)"}, None),
    "grid_warp": ("GridGenerator", lambda: [_n(2, 2, 2, 5, 6)],
                  {"transform_type": "warp"}, None),
    # sample points up to 0.3 past each edge: corners out of bounds
    "bilinear_out_of_bounds": ("BilinearSampler",
                               lambda: [_n(3, 2, 3, 6, 7),
                                        _u(4, 2, 2, 5, 4, low=-1.3,
                                           high=1.3)],
                               {}, None),
    "spatial_transformer": ("SpatialTransformer",
                            lambda: [_n(5, 2, 3, 8, 8),
                                     np.array([[0.9, 0.1, 0.05, -0.1, 1.1,
                                                0.0],
                                               [1.2, 0.0, -0.2, 0.1, 0.8,
                                                0.3]], np.float32)],
                            {"target_shape": (6, 5),
                             "transform_type": "affine"}, None),
    "spatial_transformer_input_shape": (
        "SpatialTransformer",
        lambda: [_n(5, 1, 2, 5, 6),
                 np.array([[0.7, -0.2, 0.1, 0.3, 0.9, -0.1]], np.float32)],
        {}, None),
    # --- ROIPooling
    "roi_pooling": ("ROIPooling", lambda: [_n(6, 2, 4, 12, 12), _rois()],
                    {"pooled_size": (3, 3), "spatial_scale": 0.5}, (0,)),
    "roi_pooling_tied_max": ("ROIPooling", lambda: [_tied_map(), _rois()],
                             {"pooled_size": "(2, 3)",
                              "spatial_scale": "0.5"}, (0,)),
    # --- Correlation
    "correlation": ("Correlation",
                    lambda: [_n(8, 2, 3, 9, 9), _n(9, 2, 3, 9, 9)],
                    {"kernel_size": 1, "max_displacement": 1}, None),
    "correlation_strided_abs": ("Correlation",
                                lambda: [_n(8, 1, 2, 10, 10),
                                         _n(9, 1, 2, 10, 10)],
                                {"kernel_size": 3, "max_displacement": 2,
                                 "stride1": 2, "stride2": 2, "pad_size": 2,
                                 "is_multiply": False}, None),
    # --- the multibox trio
    "multibox_prior": ("MultiBoxPrior", lambda: [_n(10, 1, 3, 4, 5)],
                       {"sizes": (0.2, 0.3), "ratios": (1, 2, 0.5)}, None),
    "multibox_prior_clip": ("_contrib_MultiBoxPrior",
                            lambda: [_n(10, 2, 3, 3, 2)],
                            {"sizes": "[0.9, 1.2]", "ratios": "[1, 3]",
                             "clip": "True"}, None),
    "multibox_target_padded": ("MultiBoxTarget",
                               lambda: [_prior(4, 4),
                                        _labels(11, 3, 4, (2, 4, 1)),
                                        _n(12, 3, 4, 64)],
                               SSD_TARGET, ()),
    # cls_pred all equal: every negative candidate equally hard, so the
    # mined negatives are the first in anchor order (stable sort)
    "multibox_target_tied_hardness": (
        "_contrib_MultiBoxTarget",
        lambda: [_prior(4, 4), _labels(13, 2, 3, (1, 3)),
                 np.zeros((2, 4, 64), np.float32)],
        SSD_TARGET, ()),
    "multibox_target_no_mining": ("MultiBoxTarget",
                                  lambda: [_prior(4, 4),
                                           _labels(14, 2, 2, (2, 0)),
                                           _n(15, 2, 4, 64)],
                                  {"overlap_threshold": 0.3}, ()),
    "multibox_detection_topk": ("MultiBoxDetection",
                                lambda: _detection_inputs(16),
                                {"nms_topk": 10, "nms_threshold": 0.3},
                                None),
    "multibox_detection_all": ("MultiBoxDetection",
                               lambda: _detection_inputs(17),
                               {"nms_topk": -1, "nms_threshold": 0.3,
                                "threshold": 0.3}, None),
    "multibox_detection_force_suppress": (
        "_contrib_MultiBoxDetection", lambda: _detection_inputs(18),
        {"nms_topk": 20, "nms_threshold": 0.2, "force_suppress": True,
         "clip": False}, None),
    "multibox_detection_per_class": (
        "MultiBoxDetection", lambda: _detection_inputs(18),
        {"nms_topk": 20, "nms_threshold": 0.2, "force_suppress": "False"},
        None),
    # --- Proposal at examples/rcnn/rcnn/config.py's sizes
    "proposal_rcnn": ("Proposal", lambda: _proposal_inputs(19), RCNN,
                      None),
    # fewer candidates than post_nms_top_n: the best survivor repeats
    "proposal_short": ("_contrib_Proposal",
                       lambda: _proposal_inputs(20, n=1, fh=4, fw=4, a0=3),
                       {**RCNN, "scales": (2, 4, 8), "ratios": (1,),
                        "rpn_pre_nms_top_n": 12, "rpn_post_nms_top_n": 16,
                        "threshold": 0.5}, None),
    "cross_device_copy": ("_CrossDeviceCopy", lambda: [_n(21, 3, 4)], {},
                          None),
}
# the registry names these cases reach (read by test_torch_op_set.py)
PARITY_OPS = {op for op, *_ in CASES.values()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_fp32(case):
    name, make, attrs, diff = CASES[case]
    _check(_run(name, make(), attrs, diff=diff), TOL)


def test_every_vision_name_has_a_case():
    jnames = {n for n in jops.list_ops()
              if jops.get(n).fn.__module__ == "mxnet_tpu.ops.vision"}
    assert len(jnames) == 14
    assert PARITY_OPS == jnames


# ------------------------------------------------------------ ties
def test_multibox_target_duplicate_claim_goes_to_the_later_ground_truth():
    anchors = _prior(4, 4)
    box = [0.3, 0.3, 0.6, 0.6]
    # rows 0 and 2 are the same box (they claim the same anchor), with
    # other classes; row 1 is padding
    lab = np.array([[[0] + box, [-1] * 5, [2] + box]], np.float32)
    (j_loc, t_loc), (j_msk, t_msk), (j_cls, t_cls) = _run(
        "MultiBoxTarget", [anchors, lab, _n(22, 1, 4, 64)],
        {"overlap_threshold": 0.9}, diff=())
    np.testing.assert_array_equal(t_cls, j_cls)
    np.testing.assert_array_equal(t_msk, j_msk)
    np.testing.assert_allclose(t_loc, j_loc, rtol=TOL, atol=TOL)
    # only the bipartite claim is positive (IoU > 0.9 nowhere), with the
    # later row's class
    assert sorted(np.unique(t_cls[0])) == [0.0, 3.0]
    assert (t_cls[0] == 3.0).sum() == 1


def test_multibox_target_gives_no_gradient():
    """Targets carry no gradient in the port (MXNet's op writes zero
    input gradients); in JAX the class scores' gradient is zero too,
    since they only rank the negatives."""
    ins = [_prior(4, 4), _labels(11, 2, 3, (2, 3)), _n(12, 2, 4, 64)]
    outs = treg.get("MultiBoxTarget").fn(
        None, *[torch.from_numpy(a.copy()).requires_grad_() for a in ins],
        **SSD_TARGET)
    assert not any(o.requires_grad for o in outs)

    def cls_sum(cls_pred):
        out = jops.get("MultiBoxTarget").fn(
            None, jnp.asarray(ins[0]), jnp.asarray(ins[1]), cls_pred,
            **SSD_TARGET)
        return sum(jnp.sum(o * (i + 1)) for i, o in enumerate(out))

    g = jax.jit(jax.grad(cls_sum))(jnp.asarray(ins[2]))
    np.testing.assert_array_equal(np.asarray(g), 0.0)


def test_detection_keeps_ties_in_score_order_and_first_class():
    """Equal scores keep anchor order (stable sort) and equal class
    probabilities give the first class, on both sides."""
    anchors = _prior(2, 2)
    a = anchors.shape[1]
    probs = np.full((1, 4, a), 0.25, np.float32)
    probs[0, 2, ::3] = 0.4
    loc = np.zeros((1, a * 4), np.float32)
    (j, t), *_ = _run("MultiBoxDetection", [probs, loc, anchors],
                      {"nms_threshold": 0.4}, diff=())
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    assert set(np.unique(t[0, :, 0])) <= {-1.0, 0.0, 1.0}


def test_nms_makes_three_launch_calls_a_row(monkeypatch):
    """The greedy loop's cost on the card: three tensor ops a row of
    the top k, whatever the batch (counted here through the ops it
    calls)."""
    from mxnet_tpu_torch.ops import vision

    calls = []
    real = vision._greedy_nms

    def counting(sup, ok, alive):
        calls.append(sup.shape[1])
        return real(sup, ok, alive)

    monkeypatch.setattr(vision, "_greedy_nms", counting)
    ins = [torch.from_numpy(np.array(a))
           for a in _detection_inputs(23, n=3)]
    vision._multibox_detection(None, *ins, nms_topk=7)
    ins = [torch.from_numpy(np.array(a)) for a in _proposal_inputs(24)]
    vision._proposal(None, *ins, **RCNN)
    assert calls == [7, 64]


def test_ops_infer_shapes_on_meta_tensors():
    """Shape inference runs each op on meta tensors: no value is read,
    and the NMS loops are skipped."""
    from mxnet_tpu_torch import symbol as tsym

    anchors = tsym.MultiBoxPrior(tsym.Variable("feat"), sizes=(0.2, 0.3),
                                 ratios=(1, 2))
    det = tsym.MultiBoxDetection(tsym.Variable("cls_prob"),
                                 tsym.Variable("loc"), anchors, nms_topk=5)
    _, out, _ = det.infer_shape(feat=(2, 8, 3, 3), cls_prob=(2, 4, 27),
                                loc=(2, 108))
    assert out == [(2, 27, 6)]
    rois = tsym.Proposal(tsym.Variable("c"), tsym.Variable("b"),
                         tsym.Variable("i"), **RCNN)
    _, out, _ = rois.infer_shape(c=(2, 18, 16, 16), b=(2, 36, 16, 16),
                                 i=(2, 3))
    assert out == [(32, 5)]


def test_refusals_match_the_reference():
    x = torch.zeros((1, 2, 4, 4))
    with pytest.raises(MXNetError, match="pooled_size"):
        treg.get("ROIPooling").fn(None, x, torch.zeros((1, 5)))
    with pytest.raises(MXNetError, match="target_shape"):
        treg.get("GridGenerator").fn(None, torch.zeros((1, 6)))
    with pytest.raises(MXNetError, match="transform_type"):
        treg.get("GridGenerator").fn(None, x, transform_type="tps")
    with pytest.raises(MXNetError, match="empty"):
        treg.get("Correlation").fn(None, x, x, max_displacement=3)
