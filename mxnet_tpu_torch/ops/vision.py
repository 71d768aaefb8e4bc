"""Vision ops of the port (``mxnet_tpu/ops/vision.py``, every name it
registers): the SSD multibox trio ``MultiBoxPrior``, ``MultiBoxTarget``
and ``MultiBoxDetection``, Faster R-CNN's ``ROIPooling`` and
``Proposal``, the spatial transformer family ``GridGenerator``,
``BilinearSampler`` and ``SpatialTransformer``, FlowNet's
``Correlation`` and ``_CrossDeviceCopy``.

The JAX ops are dense gather/where/reduce math over one sample,
``jax.vmap``'d over the batch; here the batch is a leading axis of the
same tensor ops.  Sorts are stable (``jnp.argsort`` is), ``argmax``
takes the first maximum on both sides, and max reductions are
``amax``, whose gradient splits evenly among tied maxima as JAX's does.

The two greedy NMS loops (``MultiBoxDetection`` over ``min(nms_topk,
A)`` score-sorted rows, ``Proposal`` over its ``pre_nms_top_n``) are
Python loops of three small tensor ops a row over the whole batch, on
a suppression matrix computed before the loop; nothing in them reads a
value to the host.  Each runs inside a ``torch.profiler`` range
(``MultiBoxDetection.nms``, ``Proposal.nms``), as does
``MultiBoxTarget``, so a device trace can attribute their kernels.

``MultiBoxTarget`` computes targets: it runs under ``no_grad`` and gives
no gradient to any input, as MXNet's op does (the JAX op lets
``loc_target``'s gradient reach ``anchor`` and ``label``; SSD's graph
never reads either).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, normalize_tuple, parse_attr, parse_bool
from .registry import register


# --------------------------------------------------------------------------
# GridGenerator / BilinearSampler / SpatialTransformer
# --------------------------------------------------------------------------
def _target_shape(attrs):
    ts = normalize_tuple(parse_attr(attrs.get("target_shape", (0, 0))), 2,
                         "target_shape")
    return int(ts[0]), int(ts[1])


def _linspace(n, device):
    return (torch.linspace(-1.0, 1.0, n, device=device) if n > 1
            else torch.zeros(1, device=device))


def _affine_grid(theta, h, w):
    """Normalized sampling grid (N, 2, H, W) for a batch of 2x3 affine
    matrices: target coords in [-1, 1], x fastest, source = theta @
    [x, y, 1]."""
    n = theta.shape[0]
    ys, xs = torch.meshgrid(_linspace(h, theta.device),
                            _linspace(w, theta.device), indexing="ij")
    grid_dst = torch.stack([xs.reshape(-1), ys.reshape(-1),
                            torch.ones(h * w, device=theta.device)], dim=0)
    dt = torch.promote_types(theta.dtype, grid_dst.dtype)
    src = torch.einsum("nij,jk->nik", theta.reshape(n, 2, 3).to(dt),
                       grid_dst.to(dt))
    return src.reshape(n, 2, h, w)


@register("GridGenerator")
def _grid_generator(ctx, data, **attrs):
    """``affine``: data (N, 6) -> grid (N, 2, H, W) of attr
    ``target_shape``; ``warp``: data is a flow field (N, 2, H, W) and the
    grid is the normalized flow + identity meshgrid."""
    transform_type = attrs.get("transform_type", "affine")
    if transform_type == "affine":
        h, w = _target_shape(attrs)
        if h <= 0 or w <= 0:
            raise MXNetError("GridGenerator(affine) requires target_shape")
        return _affine_grid(data, h, w)
    if transform_type == "warp":
        _, _, h, w = data.shape
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=data.dtype, device=data.device),
            torch.arange(w, dtype=data.dtype, device=data.device),
            indexing="ij")
        x = data[:, 0] + xs
        y = data[:, 1] + ys
        xn = x * (2.0 / max(w - 1, 1)) - 1.0 if w > 1 else torch.zeros_like(x)
        yn = y * (2.0 / max(h - 1, 1)) - 1.0 if h > 1 else torch.zeros_like(y)
        return torch.stack([xn, yn], dim=1)
    raise MXNetError(f"unknown transform_type {transform_type!r}")


def _bilinear_sample(data, grid):
    """Sample data (N, C, H, W) at the normalized grid (N, 2, Ho, Wo):
    real coords ``(g + 1) * (size - 1) / 2``, the 4-corner blend, corners
    outside the image contributing zero.  The gradient reaches ``grid``
    through the corner weights only."""
    n, _, h, w = data.shape
    xs = (grid[:, 0] + 1.0) * (w - 1) / 2.0  # (N, Ho, Wo)
    ys = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0
    batch = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def corner(yc, xc, weight):
        valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        xi = xc.clamp(0, w - 1).long()
        yi = yc.clamp(0, h - 1).long()
        vals = data[batch, :, yi, xi].movedim(-1, 1)  # (N, C, Ho, Wo)
        return vals * (weight * valid.to(data.dtype))[:, None]

    out = (corner(y0, x0, (1 - wy) * (1 - wx))
           + corner(y0, x0 + 1, (1 - wy) * wx)
           + corner(y0 + 1, x0, wy * (1 - wx))
           + corner(y0 + 1, x0 + 1, wy * wx))
    return out.to(data.dtype)


@register("BilinearSampler", arg_names=("data", "grid"))
def _bilinear_sampler(ctx, data, grid, **attrs):
    return _bilinear_sample(data, grid)


def _st_params(attrs, data_shape, *rest):
    return {"loc": (data_shape[0], 6)}


@register("SpatialTransformer", arg_names=("data", "loc"),
          infer_params=_st_params)
def _spatial_transformer(ctx, data, loc, **attrs):
    """The affine grid of the localisation output, then the bilinear
    sampler; ``target_shape`` defaults to the input's."""
    h, w = _target_shape(attrs)
    if h <= 0 or w <= 0:
        h, w = data.shape[2], data.shape[3]
    return _bilinear_sample(data, _affine_grid(loc, h, w))


# --------------------------------------------------------------------------
# ROIPooling
# --------------------------------------------------------------------------
def _cround(v):
    """C's round(): half away from zero (``torch.round`` rounds half to
    even and would shift bins at exact .5 products)."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


@register("ROIPooling", arg_names=("data", "rois"))
def _roi_pooling(ctx, data, rois, **attrs):
    """data (N, C, H, W); rois (R, 5) = [batch_index, x1, y1, x2, y2] in
    image coordinates, scaled by ``spatial_scale`` and rounded; bin b of
    a side covers [floor(b * bin), ceil((b + 1) * bin)) and is
    max-pooled through separable row and column masks; an empty bin
    gives 0 (and no gradient)."""
    if "pooled_size" not in attrs:
        raise MXNetError("ROIPooling requires attribute pooled_size")
    pooled = normalize_tuple(parse_attr(attrs["pooled_size"]), 2,
                             "pooled_size")
    ph, pw = int(pooled[0]), int(pooled[1])
    scale = float(parse_attr(attrs.get("spatial_scale", 1.0)))
    n, _, h, w = data.shape

    batch_idx = _cround(rois[:, 0]).to(torch.int32).clamp(0, n - 1).long()
    x1 = _cround(rois[:, 1] * scale)
    y1 = _cround(rois[:, 2] * scale)
    x2 = _cround(rois[:, 3] * scale)
    y2 = _cround(rois[:, 4] * scale)
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / pw  # (R,)
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / ph

    def axis_mask(start, bin_size, nbins, size):
        # mask[r, b, p]: pixel p lies in bin b of roi r
        b = torch.arange(nbins, dtype=data.dtype, device=data.device)
        lo = torch.floor(b[None, :] * bin_size[:, None] + start[:, None])
        hi = torch.ceil((b[None, :] + 1.0) * bin_size[:, None]
                        + start[:, None])
        lo = lo.clamp(0, size)
        hi = hi.clamp(0, size)
        p = torch.arange(size, dtype=data.dtype, device=data.device)
        return ((p[None, None, :] >= lo[:, :, None])
                & (p[None, None, :] < hi[:, :, None]))

    mask_h = axis_mask(y1, bin_h, ph, h)  # (R, PH, H)
    mask_w = axis_mask(x1, bin_w, pw, w)  # (R, PW, W)
    picked = data[batch_idx]  # (R, C, H, W)
    tmp = torch.where(mask_h[:, None, :, :, None], picked[:, :, None],
                      -math.inf)
    tmp = tmp.amax(dim=3)  # (R, C, PH, W)
    out = torch.where(mask_w[:, None, None], tmp[:, :, :, None], -math.inf)
    out = out.amax(dim=4)  # (R, C, PH, PW)
    return torch.where(torch.isfinite(out), out, 0.0)


# --------------------------------------------------------------------------
# Correlation (FlowNet)
# --------------------------------------------------------------------------
@register("Correlation", arg_names=("data1", "data2"), num_outputs=1)
def _correlation(ctx, data1, data2, **attrs):
    """Patch cross-correlation over a displacement neighbourhood: output
    channel k enumerates (dy, dx) in stride2 * [-r, r]^2 with r =
    max_displacement // stride2; output (i, j) centres at border + (i,
    j) * stride1 of the padded map; values average over the kernel window
    and the channels."""
    kernel_size = int(parse_attr(attrs.get("kernel_size", 1)))
    max_disp = int(parse_attr(attrs.get("max_displacement", 1)))
    stride1 = int(parse_attr(attrs.get("stride1", 1)))
    stride2 = int(parse_attr(attrs.get("stride2", 1)))
    pad_size = int(parse_attr(attrs.get("pad_size", 0)))
    is_multiply = parse_bool(attrs.get("is_multiply", True))

    _, c, h, w = data1.shape
    pad = (pad_size,) * 4
    d1 = F.pad(data1, pad)
    d2 = F.pad(data2, pad)
    ph_, pw_ = h + 2 * pad_size, w + 2 * pad_size
    kernel_radius = (kernel_size - 1) // 2
    border = max_disp + kernel_radius
    top_h = int(math.ceil(float(ph_ - border * 2) / stride1))
    top_w = int(math.ceil(float(pw_ - border * 2) / stride1))
    if top_h < 1 or top_w < 1:
        raise MXNetError("Correlation: output would be empty")
    grid_radius = max_disp // stride2
    norm = float(kernel_size * kernel_size * c)
    # window centres in padded coords; after a VALID window sum of size
    # k, index (y - kernel_radius) is the window centred at y
    y0 = x0 = border - kernel_radius
    ys = slice(y0, y0 + stride1 * (top_h - 1) + 1, stride1)
    xs = slice(x0, x0 + stride1 * (top_w - 1) + 1, stride1)
    outs = []
    for dyi in range(-grid_radius, grid_radius + 1):
        for dxi in range(-grid_radius, grid_radius + 1):
            dy, dx = dyi * stride2, dxi * stride2
            shifted = torch.roll(d2, shifts=(-dy, -dx), dims=(2, 3))
            prod = d1 * shifted if is_multiply else torch.abs(d1 - shifted)
            summed = prod.sum(dim=1, keepdim=True)
            if kernel_size > 1:
                summed = (summed.unfold(2, kernel_size, 1)
                          .unfold(3, kernel_size, 1).sum(dim=(-2, -1)))
            summed = summed / norm
            outs.append(summed[:, 0, ys, xs])
    return torch.stack(outs, dim=1).to(data1.dtype)


# --------------------------------------------------------------------------
# SSD multibox trio
# --------------------------------------------------------------------------
def _parse_floats(val, default):
    v = parse_attr(val) if val is not None else default
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


@register("MultiBoxPrior", aliases=("_contrib_MultiBoxPrior",))
def _multibox_prior(ctx, data, **attrs):
    """Anchors of each feature-map cell, (1, H * W * A, 4) corners:
    each size with ratios[0], then sizes[0] with each other ratio;
    centres ((j + 0.5) / W, (i + 0.5) / H), half-extents (s * sqrt(r) /
    2, s / sqrt(r) / 2).  A constant of the data's shape."""
    sizes = _parse_floats(attrs.get("sizes"), (1.0,))
    ratios = _parse_floats(attrs.get("ratios"), (1.0,))
    clip = parse_bool(attrs.get("clip", False))
    h, w = data.shape[2], data.shape[3]
    combos = ([(s, ratios[0]) for s in sizes]
              + [(sizes[0], r) for r in ratios[1:]])
    # float64 on the device, as numpy computes it: no upload (which
    # would sync the host, and cannot be captured), the same bits
    f64 = {"dtype": torch.float64, "device": data.device}
    cy, cx = torch.meshgrid((torch.arange(h, **f64) + 0.5) / h,
                            (torch.arange(w, **f64) + 0.5) / w,
                            indexing="ij")
    anchors = []
    for s, r in combos:
        hw = s * math.sqrt(r) / 2.0
        hh = s / math.sqrt(r) / 2.0
        anchors.append(torch.stack([cx - hw, cy - hh, cx + hw, cy + hh],
                                   dim=-1))
    out = torch.stack(anchors, dim=2).reshape(1, -1, 4).to(torch.float32)
    return out.clamp(0.0, 1.0) if clip else out


def _iou(a, b):
    """IoU of corner boxes a (..., A, 4) and b (..., B, 4) -> (..., A, B)."""
    a = a.unsqueeze(-2)
    b = b.unsqueeze(-3)
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    area_a = torch.clamp((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]),
                         min=0.0)
    area_b = torch.clamp((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                         min=0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def _corners_to_centre(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w, h, (boxes[..., 0] + boxes[..., 2]) / 2,
            (boxes[..., 1] + boxes[..., 3]) / 2)


def _encode_loc(anchors, gt, variances):
    """Box regression targets of ``gt`` against ``anchors`` (..., 4)."""
    aw, ah, ax, ay = _corners_to_centre(anchors)
    aw = torch.clamp(aw, min=1e-12)
    ah = torch.clamp(ah, min=1e-12)
    gw, gh, gx, gy = _corners_to_centre(gt)
    gw = torch.clamp(gw, min=1e-12)
    gh = torch.clamp(gh, min=1e-12)
    v0, v1, v2, v3 = variances
    return torch.stack([(gx - ax) / aw / v0, (gy - ay) / ah / v1,
                        torch.log(gw / aw) / v2, torch.log(gh / ah) / v3],
                       dim=-1)


def _rank(keys):
    """Each entry's place in ``argsort(keys)`` along the last axis (a
    stable sort, as ``jnp.argsort``'s)."""
    order = torch.argsort(keys, dim=-1, stable=True)
    places = torch.arange(keys.shape[-1], dtype=torch.float32,
                          device=keys.device).expand_as(keys)
    return torch.empty(keys.shape, dtype=torch.float32,
                       device=keys.device).scatter_(-1, order, places)


@register(
    "MultiBoxTarget",
    arg_names=("anchor", "label", "cls_pred"),
    num_outputs=3,
    output_names=("loc_target", "loc_mask", "cls_target"),
    aliases=("_contrib_MultiBoxTarget",),
)
def _multibox_target(ctx, anchor, label, cls_pred, **attrs):
    """Anchor matching: each valid ground truth (label rows [cls, x1, y1,
    x2, y2], cls < 0 is padding) claims its best-IoU anchor, then every
    anchor with IoU > overlap_threshold joins its best ground truth.  An
    anchor claimed by two ground truths goes to the later one in label
    order, as the JAX op's scatter gives on the CPU.  Hard negative
    mining keeps ``negative_mining_ratio * num_pos`` negatives ranked by
    1 - background probability.  Outputs loc_target (N, A * 4), loc_mask
    (N, A * 4), cls_target (N, A): 0 background, cls + 1 positive,
    ignore_label ignored."""
    overlap_threshold = float(parse_attr(attrs.get("overlap_threshold", 0.5)))
    ignore_label = float(parse_attr(attrs.get("ignore_label", -1.0)))
    neg_ratio = float(parse_attr(attrs.get("negative_mining_ratio", -1.0)))
    neg_thresh = float(parse_attr(attrs.get("negative_mining_thresh", 0.5)))
    variances = _parse_floats(attrs.get("variances"), (0.1, 0.1, 0.2, 0.2))

    with torch.no_grad(), torch.profiler.record_function(
            "MultiBoxTarget"):
        anchors = anchor.reshape(-1, 4)
        a = anchors.shape[0]
        m = label.shape[1]
        valid = label[:, :, 0] >= 0  # (N, M)
        gt = label[:, :, 1:5]
        iou = _iou(anchors, gt)  # (N, A, M)
        iou = torch.where(valid[:, None, :], iou, -1.0)
        best_iou, _ = iou.max(dim=2)
        best_gt = iou.argmax(dim=2)  # (N, A), the first maximum
        matched = best_iou > overlap_threshold
        # bipartite stage: gt j claims anchor argmax_a iou[a, j]; among
        # gts claiming one anchor the last in label order wins
        best_anchor = iou.argmax(dim=1)  # (N, M)
        claim = valid[:, :, None] & (
            best_anchor[:, :, None]
            == torch.arange(a, device=anchor.device))  # (N, M, A)
        claimed = claim.any(dim=1)
        order = torch.arange(m, device=anchor.device)[None, :, None]
        gt_of_claim = torch.where(claim, order, -1).amax(dim=1)
        match_gt = torch.where(claimed, gt_of_claim, best_gt)  # (N, A)
        positive = claimed | matched

        cls_t = torch.where(positive,
                            label[:, :, 0].gather(1, match_gt) + 1.0, 0.0)
        gt_m = gt.gather(1, match_gt[:, :, None].expand(-1, -1, 4))
        pos = positive[:, :, None].to(torch.float32)
        loc_t = _encode_loc(anchors, gt_m, variances) * pos.to(gt.dtype)
        loc_m = pos.expand(-1, -1, 4)

        if neg_ratio > 0:
            max_neg = neg_ratio * positive.to(torch.float32).sum(
                dim=1, keepdim=True)
            bg_prob = torch.softmax(cls_pred, dim=1)[:, 0]  # (N, A)
            neg_cand = ~positive & (best_iou < neg_thresh)
            hardness = torch.where(neg_cand, 1.0 - bg_prob, -1.0)
            keep_neg = neg_cand & (_rank(-hardness) < max_neg)
            cls_t = torch.where(
                positive, cls_t,
                torch.where(keep_neg, 0.0, ignore_label).to(cls_t.dtype))
        return (loc_t.reshape(label.shape[0], -1),
                loc_m.reshape(label.shape[0], -1), cls_t)


def _decode_loc(anchors, loc, variances):
    v0, v1, v2, v3 = variances
    aw, ah, ax, ay = _corners_to_centre(anchors)
    cx = loc[..., 0] * v0 * aw + ax
    cy = loc[..., 1] * v1 * ah + ay
    w = torch.exp(torch.clamp(loc[..., 2] * v2, -10, 10)) * aw
    h = torch.exp(torch.clamp(loc[..., 3] * v3, -10, 10)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _greedy_nms(sup, ok, alive):
    """Greedy suppression over rows i = 0 .. k-1 of ``sup`` (N, k, A):
    a row still alive and ``ok`` kills the entries its row marks.
    Updates ``alive`` (N, A) in place: three launches a row, no read to
    the host (none at all on meta tensors, whose shapes are all that
    shape inference reads)."""
    if alive.is_meta:
        return alive
    for i in range(sup.shape[1]):
        kill = alive[:, i:i + 1] & ok[:, i:i + 1]
        alive.masked_fill_(sup[:, i] & kill, False)
    return alive


def _gather_rows(x, order):
    """``x`` (N, A, ...) with its rows of each sample in ``order`` (N, K)."""
    idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
    return x.gather(1, idx.expand(order.shape + x.shape[2:]))


@register(
    "MultiBoxDetection",
    arg_names=("cls_prob", "loc_pred", "anchor"),
    aliases=("_contrib_MultiBoxDetection",),
)
def _multibox_detection(ctx, cls_prob, loc_pred, anchor, **attrs):
    """Decode the loc predictions against the anchors, take each
    anchor's best class and score, threshold, sort by score, greedy NMS
    from the ``min(nms_topk, A)`` best rows (rows past them are dropped).
    Output (N, A, 6) rows [cls_id, score, x1, y1, x2, y2], cls_id -1 for
    suppressed or invalid rows."""
    clip = parse_bool(attrs.get("clip", True))
    threshold = float(parse_attr(attrs.get("threshold", 0.01)))
    nms_threshold = float(parse_attr(attrs.get("nms_threshold", 0.5)))
    force_suppress = parse_bool(attrs.get("force_suppress", False))
    nms_topk = int(parse_attr(attrs.get("nms_topk", -1)))
    variances = _parse_floats(attrs.get("variances"), (0.1, 0.1, 0.2, 0.2))

    n = cls_prob.shape[0]
    anchors = anchor.reshape(-1, 4)
    a = anchors.shape[0]
    boxes = _decode_loc(anchors, loc_pred.reshape(n, -1, 4), variances)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    fg = cls_prob[:, 1:]
    cls_id = fg.argmax(dim=1).to(torch.float32)  # (N, A), the first max
    score = fg.amax(dim=1)
    keep = score > threshold
    cls_id = torch.where(keep, cls_id, -1.0)
    score = torch.where(keep, score, 0.0)

    order = torch.argsort(-score, dim=1, stable=True)
    cls_s = cls_id.gather(1, order)
    score_s = score.gather(1, order)
    boxes_s = _gather_rows(boxes, order)
    # suppression flows only from the top-k rows; rows past k are dropped
    k = min(nms_topk, a) if nms_topk > 0 else a
    if k < a:
        cls_s = torch.where(torch.arange(a, device=cls_s.device) < k, cls_s,
                            -1.0)
    with torch.no_grad(), torch.profiler.record_function(
            "MultiBoxDetection.nms"):
        bs = boxes_s.detach()
        later = (torch.arange(a, device=bs.device)[None, :]
                 > torch.arange(k, device=bs.device)[:, None])
        sup = (_iou(bs[:, :k], bs) > nms_threshold) & later
        if not force_suppress:
            sup &= cls_s[:, :k, None] == cls_s[:, None, :]
        alive = _greedy_nms(sup, cls_s[:, :k] >= 0,
                            torch.ones((n, a), dtype=torch.bool,
                                       device=bs.device))
    cls_s = torch.where(alive, cls_s, -1.0)
    return torch.cat([cls_s[..., None], score_s[..., None], boxes_s], dim=-1)


# --------------------------------------------------------------------------
# Proposal: the RPN -> RoI stage of Faster R-CNN
# --------------------------------------------------------------------------
def _generate_anchors(stride, scales, ratios):
    """Base anchors around one stride cell (example/rcnn's
    generate_anchor)."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        ws = np.round(np.sqrt(w * h / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.array(anchors, np.float32)


def _device_constant(a, device):
    """A small float32 host array on ``device``, one fill a value (the
    value travels as a kernel argument): an upload, or a ``t[i] = v``,
    would sync the host, and cannot be captured."""
    # trace-ok: a is a host numpy array (the anchors): tolist reads no
    # value of the card
    values = a.ravel().tolist()
    return torch.stack([torch.full((), v, dtype=torch.float32,
                                   device=device)
                        for v in values]).reshape(a.shape)


def _bbox_transform_inv(boxes, deltas):
    """Apply (dx, dy, dw, dh) regression deltas to boxes (x1y1x2y2, +1
    pixel extents)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(torch.clamp(deltas[..., 2], -10, 10)) * w
    ph = torch.exp(torch.clamp(deltas[..., 3], -10, 10)) * h
    return torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                        pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)],
                       dim=-1)


def _clip(x, hi):
    """``jnp.clip(x, 0, hi)``: the upper bound wins where hi < 0."""
    return torch.minimum(torch.clamp(x, min=0.0), hi)


@register(
    "Proposal",
    arg_names=("cls_prob", "bbox_pred", "im_info"),
    aliases=("_contrib_Proposal",),
)
def _proposal(ctx, cls_prob, bbox_pred, im_info, **attrs):
    """Slide the base anchors over the feature grid, decode the RPN
    deltas, clip to the image, mask boxes under ``rpn_min_size``, keep
    the ``rpn_pre_nms_top_n`` best, greedy NMS, and emit
    ``rpn_post_nms_top_n`` RoIs a sample as (batch_idx, x1, y1, x2, y2),
    suppressed slots filled with the best survivor."""
    stride = int(parse_attr(attrs.get("feature_stride", 16)))
    scales = _parse_floats(attrs.get("scales"), (8, 16, 32))
    ratios = _parse_floats(attrs.get("ratios"), (0.5, 1, 2))
    pre = int(parse_attr(attrs.get("rpn_pre_nms_top_n", 6000)))
    post = int(parse_attr(attrs.get("rpn_post_nms_top_n", 300)))
    nms_thresh = float(parse_attr(attrs.get("threshold", 0.7)))
    min_size = float(parse_attr(attrs.get("rpn_min_size", 16)))

    n, twice_a, fh, fw = cls_prob.shape
    num_anchors = twice_a // 2
    base = _device_constant(_generate_anchors(stride, scales, ratios),
                            cls_prob.device)  # (A0, 4)
    f32 = {"dtype": torch.float32, "device": cls_prob.device}
    sy, sx = torch.meshgrid(torch.arange(fh, **f32) * stride,
                            torch.arange(fw, **f32) * stride, indexing="ij")
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1), sx.reshape(-1),
                          sy.reshape(-1)], dim=1)  # (HW, 4)
    anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
    k = min(pre, anchors.shape[0])

    # foreground half, (A0, H, W) -> (HW * A0,) a sample
    scores = cls_prob[:, num_anchors:].permute(0, 2, 3, 1).reshape(n, -1)
    deltas = bbox_pred.reshape(n, num_anchors, 4, fh, fw).permute(
        0, 3, 4, 1, 2).reshape(n, -1, 4)
    boxes = _bbox_transform_inv(anchors, deltas)
    hi = torch.stack([im_info[:, 1], im_info[:, 0]] * 2, dim=1) - 1.0
    boxes = _clip(boxes, hi[:, None, :])  # x to the width, y the height
    ms = (min_size * im_info[:, 2])[:, None]
    valid = ((boxes[..., 2] - boxes[..., 0] + 1 >= ms)
             & (boxes[..., 3] - boxes[..., 1] + 1 >= ms))
    scores = torch.where(valid, scores, -1.0)
    order = torch.argsort(-scores, dim=1, stable=True)[:, :k]
    boxes_s = _gather_rows(boxes, order)
    scores_s = scores.gather(1, order)

    with torch.no_grad(), torch.profiler.record_function(
            "Proposal.nms"):
        later = (torch.arange(k, device=order.device)[None, :]
                 > torch.arange(k, device=order.device)[:, None])
        sup = (_iou(boxes_s.detach(), boxes_s.detach()) > nms_thresh) & later
        alive = _greedy_nms(sup, scores_s > 0,
                            torch.ones((n, k), dtype=torch.bool,
                                       device=order.device))
    keep_score = torch.where(alive & (scores_s > 0), scores_s, -math.inf)
    sel = torch.argsort(-keep_score, dim=1, stable=True)[:, :post]
    picked = _gather_rows(boxes_s, sel)
    ok = keep_score.gather(1, sel) > -math.inf
    # suppressed slots, and slots past k, repeat the best survivor
    picked = torch.where(ok[..., None], picked, picked[:, :1])
    if picked.shape[1] < post:
        picked = torch.cat([picked, picked[:, :1].expand(
            -1, post - picked.shape[1], -1)], dim=1)
    batch_idx = torch.arange(n, dtype=picked.dtype, device=picked.device)
    return torch.cat([batch_idx[:, None, None].expand(n, post, 1),
                      picked], dim=2).reshape(-1, 5)


# --------------------------------------------------------------------------
# _CrossDeviceCopy
# --------------------------------------------------------------------------
@register("_CrossDeviceCopy")
def _cross_device_copy(ctx, data, **attrs):
    """An identity marker (MXNet inserts it at ctx-group boundaries)."""
    return data
