"""
Plain float32 YOLOv5 (P5 and P6 heads) for the benchmark's comparison: the
network of a configuration file's layer table (the published yolov5*.yaml
form: [from, repeats, module, args]), the MegaDetector 'classic' letterbox,
the v6 anchor decode, YOLOv5's non_max_suppression (objectness and
objectness x best class above the floor, class-offset greedy NMS) and the
box mapping back to the image, as MegaDetector's batch driver emits it.

Written from the published descriptions alone: it imports nothing of the
program under test. Parameters are a nested dict of float arrays in the
checkpoint layout the benchmark writes (conv weights HWIO, BatchNorm
folded): 'l<i>' per layer, C3 nodes 'cv1', 'cv2', 'cv3', 'm<j>/cv1',
'm<j>/cv2', SPPF 'cv1', 'cv2', the detect heads 'm<level>'.

Every conv goes through conv_node(x, node, stride, pad, act, hook), so the
benchmark's weight recipe can rescale each conv in forward order with a
hook, and the operation counter can walk the same graph on the meta device.
"""

import math

import cv2
import numpy as np
import torch
import torch.nn.functional as F


def make_divisible(x, divisor=8):
    return int(math.ceil(x / divisor) * divisor)


def layer_table(config):
    """The configuration's layers with channels resolved (YOLOv5's
    parse_model): dicts of frm, kind, n, c_in, c_out and the kind's own
    arguments."""

    gd = float(config['depth_multiple'])
    gw = float(config['width_multiple'])
    channels = [3]

    def ch(f):
        return channels[-1] if f == -1 else channels[f + 1]

    layers = []
    for frm, repeats, kind, args in config['backbone'] + config['head']:
        n = max(round(repeats * gd), 1) if repeats > 1 else repeats
        if kind == 'Conv':
            c_out = make_divisible(args[0] * gw)
            e = dict(kind=kind, c_in=ch(frm), c_out=c_out, k=args[1],
                     s=args[2], p=args[3] if len(args) > 3 else args[1] // 2)
        elif kind == 'C3':
            c_out = make_divisible(args[0] * gw)
            e = dict(kind=kind, c_in=ch(frm), c_out=c_out, n=n,
                     shortcut=args[1] if len(args) > 1 else True)
        elif kind == 'SPPF':
            c_out = make_divisible(args[0] * gw)
            e = dict(kind=kind, c_in=ch(frm), c_out=c_out, pool_k=args[1])
        elif kind == 'Upsample':
            e = dict(kind=kind, c_out=ch(frm))
        elif kind == 'Concat':
            e = dict(kind=kind, c_out=sum(ch(f) for f in frm))
        elif kind == 'Detect':
            e = dict(kind=kind, c_ins=[ch(f) for f in frm], c_out=0)
        else:
            raise ValueError('unknown module {}'.format(kind))
        e['frm'] = frm
        layers.append(e)
        channels.append(e['c_out'])
    return layers


def anchors(config):
    """[levels, na, 2] anchor sizes in pixels."""

    a = np.asarray(config['anchors'], np.float32)
    return a.reshape(a.shape[0], -1, 2)


def strides(config):
    return [8 * 2 ** i for i in range(len(config['anchors']))]


def num_outputs(config):
    return int(config['nc']) + 5


def param_shapes(config):
    """{path: HWIO shape} of every conv weight, in forward order (bias:
    the last dimension)."""

    shapes = {}

    def conv(path, c_in, c_out, k):
        shapes[path] = (k, k, c_in, c_out)

    no = num_outputs(config) * anchors(config).shape[1]
    for i, e in enumerate(layer_table(config)):
        name = 'l{}'.format(i)
        if e['kind'] == 'Conv':
            conv(name, e['c_in'], e['c_out'], e['k'])
        elif e['kind'] == 'C3':
            c_h = int(e['c_out'] * 0.5)
            conv(name + '/cv1', e['c_in'], c_h, 1)
            conv(name + '/cv2', e['c_in'], c_h, 1)
            for j in range(e['n']):
                conv('{}/m{}/cv1'.format(name, j), c_h, c_h, 1)
                conv('{}/m{}/cv2'.format(name, j), c_h, c_h, 3)
            conv(name + '/cv3', 2 * c_h, e['c_out'], 1)
        elif e['kind'] == 'SPPF':
            c_h = e['c_in'] // 2
            conv(name + '/cv1', e['c_in'], c_h, 1)
            conv(name + '/cv2', 4 * c_h, e['c_out'], 1)
        elif e['kind'] == 'Detect':
            for lvl, c_in in enumerate(e['c_ins']):
                conv('{}/m{}'.format(name, lvl), c_in, no, 1)
    return shapes


def conv_node(x, node, stride=1, pad=None, act=True, hook=None):
    """conv + bias (+ SiLU) of one node ({'w': HWIO, 'b'} tensors); [hook],
    when given, is called as hook(node, x, stride, pad, act) and returns
    the output instead."""

    if hook is not None:
        return hook(node, x, stride, pad, act)
    w = node['w']
    k = w.shape[0]
    pad = k // 2 if pad is None else pad
    y = F.conv2d(x, w.permute(3, 2, 0, 1), node['b'], stride, pad)
    return F.silu(y) if act else y


def forward(config, params, x, hook=None):
    """Raw detect heads [B, na*no, H_l, W_l] per level of float NCHW images
    in [0, 1]."""

    outputs = []
    y = x
    for i, e in enumerate(layer_table(config)):
        node = params.get('l{}'.format(i))
        frm = e['frm']
        if isinstance(frm, list):
            xin = [outputs[f] if f != -1 else y for f in frm]
        else:
            xin = y if frm == -1 else outputs[frm]
        kind = e['kind']
        if kind == 'Conv':
            y = conv_node(xin, node, e['s'], e['p'], True, hook)
        elif kind == 'C3':
            a = conv_node(xin, node['cv1'], hook=hook)
            b = conv_node(xin, node['cv2'], hook=hook)
            for j in range(e['n']):
                m = node['m{}'.format(j)]
                h = conv_node(conv_node(a, m['cv1'], hook=hook), m['cv2'],
                              hook=hook)
                a = a + h if e['shortcut'] else h
            y = conv_node(torch.cat([a, b], 1), node['cv3'], hook=hook)
        elif kind == 'SPPF':
            h = conv_node(xin, node['cv1'], hook=hook)
            k = e['pool_k']
            p1 = F.max_pool2d(h, k, 1, k // 2)
            p2 = F.max_pool2d(p1, k, 1, k // 2)
            p3 = F.max_pool2d(p2, k, 1, k // 2)
            y = conv_node(torch.cat([h, p1, p2, p3], 1), node['cv2'],
                          hook=hook)
        elif kind == 'Upsample':
            y = F.interpolate(xin, scale_factor=2, mode='nearest')
        elif kind == 'Concat':
            y = torch.cat(xin, 1)
        elif kind == 'Detect':
            y = [conv_node(t, node['m{}'.format(lvl)], act=False, hook=hook)
                 for lvl, t in enumerate(xin)]
        outputs.append(y)
    return y


def decode(config, heads):
    """[B, A, 5 + nc] decoded predictions (canvas pixels, sigmoids) of the
    raw heads, level by level, each level's rows (anchor, y, x)."""

    na = anchors(config).shape[1]
    no = num_outputs(config)
    out = []
    for lvl, (raw, stride) in enumerate(zip(heads, strides(config))):
        b, _, h, w = raw.shape
        p = torch.sigmoid(raw.float().view(b, na, no, h, w)
                          .permute(0, 1, 3, 4, 2))
        gy, gx = torch.meshgrid(torch.arange(h, device=raw.device),
                                torch.arange(w, device=raw.device),
                                indexing='ij')
        grid = torch.stack([gx, gy], -1).float()[None, None]
        anchor = torch.as_tensor(anchors(config)[lvl],
                                 device=raw.device)[None, :, None, None]
        xy = (p[..., :2] * 2 - 0.5 + grid) * stride
        wh = (p[..., 2:4] * 2) ** 2 * anchor
        out.append(torch.cat([xy, wh, p[..., 4:]], -1).reshape(b, -1, no))
    return torch.cat(out, 1)


def greedy_nms(boxes, scores, iou_thres):
    """Indices kept by greedy NMS over xyxy [N, 4] numpy boxes, highest
    score first (numpy, float64)."""

    order = np.argsort(-scores, kind='stable')
    boxes = boxes[order].astype(np.float64)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    suppressed = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        xx1 = np.maximum(boxes[i, 0], boxes[i + 1:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[i + 1:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[i + 1:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[i + 1:, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        iou = inter / (area[i] + area[i + 1:] - inter)
        suppressed[i + 1:] |= iou > iou_thres
    return np.asarray(keep, np.int64)


def non_max_suppression(pred, conf_thres, iou_thres=0.45, max_wh=7680):
    """YOLOv5's non_max_suppression (single best class, class-offset
    boxes) on one image's decoded rows [A, 5 + nc]: (xyxy canvas pixels,
    conf, class, every class's score objectness x class) numpy arrays of
    the kept boxes, conf descending. No max_det cut."""

    pred = pred.float()
    x = pred[pred[:, 4] > conf_thres]
    scores = x[:, 5:] * x[:, 4:5]
    conf, cls = scores.max(1)
    keep = conf > conf_thres
    x, conf, cls, scores = x[keep], conf[keep], cls[keep], scores[keep]
    xy, wh = x[:, :2], x[:, 2:4]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], 1)
    boxes, conf, cls, scores = (t.cpu().numpy()
                                for t in (boxes, conf, cls, scores))
    offset = cls[:, None].astype(np.float64) * max_wh
    kept = greedy_nms(boxes + offset, conf, iou_thres)
    return boxes[kept], conf[kept], cls[kept], scores[kept]


def letterbox(img, image_size, stride, auto=True):
    """The classic letterbox onto the minimal stride-multiple canvas (or,
    without [auto], the square one): (canvas HWC uint8, gain, (pad_w,
    pad_h))."""

    h, w = img.shape[:2]
    r = min(image_size / h, image_size / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = image_size - new_w, image_size - new_h
    if auto:
        dw, dh = dw % stride, dh % stride
    dw, dh = dw / 2.0, dh / 2.0
    if (new_w, new_h) != (w, h):
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=(114, 114, 114))
    return img, r, (dw, dh)


def canvas_shape(shape_hw, image_size, stride):
    h, w = shape_hw
    r = min(image_size / h, image_size / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    return (new_h + (image_size - new_h) % stride,
            new_w + (image_size - new_w) % stride)


def detect(config, params, images, conf_thres, device, batch=8, hook=None):
    """
    The reference's detections of HWC uint8 RGB [images] (a list): per
    image a list of (category '1'..., conf, [x0, y0, x1, y1] normalized to
    the image, [every class's score]) of every box above [conf_thres],
    conf descending; boxes
    mapped back to the image and clipped, unrounded. Images run in blocks
    of [batch] per canvas shape; [hook] goes to every conv_node.
    """

    size = int(config['image_size'])
    stride = max(strides(config))
    out = [None] * len(images)
    groups = {}
    for i, img in enumerate(images):
        groups.setdefault(canvas_shape(img.shape[:2], size, stride),
                          []).append(i)
    with torch.inference_mode():
        for idx in groups.values():
            for s in range(0, len(idx), batch):
                block = idx[s:s + batch]
                boxed = [letterbox(images[i], size, stride) for i in block]
                x = torch.from_numpy(np.stack([b[0] for b in boxed])).to(
                    device).permute(0, 3, 1, 2).float() / 255.0
                pred = decode(config, forward(config, params, x, hook))
                for row, i, (_, gain, (pw, ph)) in zip(pred, block, boxed):
                    boxes, conf, cls, scores = non_max_suppression(
                        row, conf_thres)
                    h, w = images[i].shape[:2]
                    boxes = boxes.astype(np.float64)
                    boxes[:, [0, 2]] = np.clip((boxes[:, [0, 2]] - pw) / gain,
                                               0, w) / w
                    boxes[:, [1, 3]] = np.clip((boxes[:, [1, 3]] - ph) / gain,
                                               0, h) / h
                    out[i] = [(str(int(c) + 1), float(p), list(map(float, b)),
                               list(map(float, sc)))
                              for b, p, c, sc in zip(boxes, conf, cls, scores)]
    return out
