"""SSD-VGG16-300 detector (a copy of ``mxnet_tpu/models/ssd.py``;
parity: example/ssd/symbol/symbol_vgg16_ssd_300.py +
example/ssd/symbol/common.py multi_layer_feature/multibox_layer).

get_symbol_train: training graph ending in the multibox target + losses
(SoftmaxOutput over matched classes, SmoothL1 on localization offsets).
get_symbol: deploy graph ending in MultiBoxDetection NMS output.
"""
from .. import symbol as sym

# per-scale anchor config (reference symbol_vgg16_ssd_300.py:12-22)
_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
          (0.71, 0.79), (0.88, 0.961)]
_RATIOS = [(1, 2, 0.5), (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5, 3, 1.0 / 3),
           (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5), (1, 2, 0.5)]
_NORMALIZATION = [20, -1, -1, -1, -1, -1]


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1), dilate=(1, 1)):
    conv = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           pad=pad, stride=stride, dilate=dilate, name=name)
    return sym.Activation(conv, act_type="relu", name=f"relu_{name}")


def vgg16_base(data):
    """VGG16 through conv5_3 with the SSD modifications: pool5 3x3/1,
    fc6 as dilated conv, fc7 as 1x1 conv (reference vgg16_reduced)."""
    x = _conv_act(data, "conv1_1", 64)
    x = _conv_act(x, "conv1_2", 64)
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="pool1")
    x = _conv_act(x, "conv2_1", 128)
    x = _conv_act(x, "conv2_2", 128)
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="pool2")
    x = _conv_act(x, "conv3_1", 256)
    x = _conv_act(x, "conv3_2", 256)
    x = _conv_act(x, "conv3_3", 256)
    # "full" (ceil) convention keeps conv4_3 at 38x38 for 300-input
    # (reference symbol_vgg16_reduced.py pool3 pooling_convention="full")
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    pooling_convention="full", name="pool3")
    x = _conv_act(x, "conv4_1", 512)
    x = _conv_act(x, "conv4_2", 512)
    conv4_3 = _conv_act(x, "conv4_3", 512)
    x = sym.Pooling(conv4_3, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="pool4")
    x = _conv_act(x, "conv5_1", 512)
    x = _conv_act(x, "conv5_2", 512)
    x = _conv_act(x, "conv5_3", 512)
    x = sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(1, 1),
                    pad=(1, 1), name="pool5")
    fc6 = _conv_act(x, "fc6", 1024, kernel=(3, 3), pad=(6, 6), dilate=(6, 6))
    fc7 = _conv_act(fc6, "fc7", 1024, kernel=(1, 1), pad=(0, 0))
    return conv4_3, fc7


def _extra_layers(fc7):
    """conv6..conv9 downsampling pyramid (reference common.py)."""
    layers = []
    x = _conv_act(fc7, "conv6_1", 256, kernel=(1, 1), pad=(0, 0))
    x = _conv_act(x, "conv6_2", 512, kernel=(3, 3), pad=(1, 1),
                  stride=(2, 2))
    layers.append(x)
    y = _conv_act(x, "conv7_1", 128, kernel=(1, 1), pad=(0, 0))
    y = _conv_act(y, "conv7_2", 256, kernel=(3, 3), pad=(1, 1),
                  stride=(2, 2))
    layers.append(y)
    z = _conv_act(y, "conv8_1", 128, kernel=(1, 1), pad=(0, 0))
    z = _conv_act(z, "conv8_2", 256, kernel=(3, 3), pad=(0, 0))
    layers.append(z)
    w = _conv_act(z, "conv9_1", 128, kernel=(1, 1), pad=(0, 0))
    w = _conv_act(w, "conv9_2", 256, kernel=(3, 3), pad=(0, 0))
    layers.append(w)
    return layers


def multibox_layer(from_layers, num_classes, sizes, ratios, normalization):
    """Per-scale loc/cls heads + priors (parity: common.py multibox_layer).
    num_classes here EXCLUDES background; heads predict num_classes+1."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    for k, from_layer in enumerate(from_layers):
        name = from_layer.name
        if normalization[k] > 0:
            from_layer = sym.L2Normalization(from_layer, mode="channel",
                                             name=f"{name}_norm")
            scale = sym.Variable(f"{name}_scale", shape=(1, 512, 1, 1),
                                 init='["constant", {"value": 20.0}]')
            from_layer = sym.broadcast_mul(from_layer, scale)
        num_anchors = len(sizes[k]) + len(ratios[k]) - 1
        # location offsets: 4 per anchor
        loc = sym.Convolution(from_layer, num_filter=num_anchors * 4,
                              kernel=(3, 3), pad=(1, 1),
                              name=f"{name}_loc_pred_conv")
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc = sym.Flatten(loc)
        loc_layers.append(loc)
        # class predictions: (num_classes + 1) per anchor
        cls = sym.Convolution(from_layer,
                              num_filter=num_anchors * (num_classes + 1),
                              kernel=(3, 3), pad=(1, 1),
                              name=f"{name}_cls_pred_conv")
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls = sym.Flatten(cls)
        cls_layers.append(cls)
        anchors = sym.MultiBoxPrior(from_layer, sizes=sizes[k],
                                    ratios=ratios[k], clip=False,
                                    name=f"{name}_anchors")
        anchor_layers.append(sym.Flatten(anchors))

    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_layers, dim=1)
    cls_preds = sym.Reshape(cls_preds, shape=(0, -1, num_classes + 1))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1),
                              name="multibox_cls_pred")
    anchor_boxes = sym.Concat(*anchor_layers, dim=1)
    anchor_boxes = sym.Reshape(anchor_boxes, shape=(0, -1, 4),
                               name="multibox_anchors")
    return loc_preds, cls_preds, anchor_boxes


def tiny_base(data):
    """4-conv trunk for from-scratch training (the reference always
    fine-tunes a pretrained VGG; a 13-conv VGG from random init cannot
    learn in a short CPU run — this trunk can, and exercises the same
    two-scale multibox head wiring)."""
    net = data
    for i, nf in enumerate((16, 32)):
        net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                              num_filter=nf, name=f"tconv{i + 1}")
        net = sym.Activation(net, act_type="relu")
        net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                          pool_type="max")
    c3 = sym.Convolution(net, kernel=(3, 3), pad=(1, 1), num_filter=32,
                         name="tconv3")
    c3 = sym.Activation(c3, act_type="relu", name="tiny_scale1")
    c4 = sym.Pooling(c3, kernel=(2, 2), stride=(2, 2), pool_type="max")
    c4 = sym.Convolution(c4, kernel=(3, 3), pad=(1, 1), num_filter=64,
                         name="tconv4")
    c4 = sym.Activation(c4, act_type="relu", name="tiny_scale2")
    return c3, c4


_TINY_SIZES = [(0.2, 0.272), (0.4, 0.5, 0.65)]
_TINY_RATIOS = [(1, 2, 0.5), (1, 2, 0.5)]
_TINY_NORMALIZATION = [-1, -1]


def _build(num_classes, backbone="vgg16"):
    data = sym.Variable("data")
    if backbone == "tiny":
        s1, s2 = tiny_base(data)
        return multibox_layer([s1, s2], num_classes, _TINY_SIZES,
                              _TINY_RATIOS, _TINY_NORMALIZATION)
    conv4_3, fc7 = vgg16_base(data)
    extras = _extra_layers(fc7)
    from_layers = [conv4_3, fc7] + extras
    return multibox_layer(from_layers, num_classes, _SIZES, _RATIOS,
                          _NORMALIZATION)


def get_symbol_train(num_classes=20, backbone="vgg16", **kwargs):
    """Training graph (parity: symbol_vgg16_ssd_300.py get_symbol_train):
    label is (N, M, 5) [cls, x1, y1, x2, y2] normalized, -1-padded."""
    label = sym.Variable("label")
    loc_preds, cls_preds, anchor_boxes = _build(num_classes, backbone)

    loc_target, loc_target_mask, cls_target = sym.MultiBoxTarget(
        anchor_boxes, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3,
        negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2),
        name="multibox_target")
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_preds - loc_target
    masked_loc_diff = loc_target_mask * loc_diff
    loc_loss_ = sym.smooth_l1(masked_loc_diff, scalar=1.0,
                              name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0,
                            normalization="valid", name="loc_loss")
    # monitoring outputs (BlockGrad'd like the reference)
    cls_label = sym.BlockGrad(cls_target, name="cls_label")
    det = sym.MultiBoxDetection(cls_prob, loc_preds, anchor_boxes,
                                name="detection", nms_threshold=0.45,
                                force_suppress=False, variances=(0.1, 0.1,
                                                                 0.2, 0.2),
                                nms_topk=400)
    det = sym.BlockGrad(det, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               nms_topk=400, backbone="vgg16", **kwargs):
    """Deploy graph: softmax over classes + NMS detection output."""
    loc_preds, cls_preds, anchor_boxes = _build(num_classes, backbone)
    cls_prob = sym.SoftmaxActivation(cls_preds, mode="channel",
                                     name="cls_prob")
    return sym.MultiBoxDetection(cls_prob, loc_preds, anchor_boxes,
                                 name="detection", nms_threshold=nms_thresh,
                                 force_suppress=force_suppress,
                                 variances=(0.1, 0.1, 0.2, 0.2),
                                 nms_topk=nms_topk)
