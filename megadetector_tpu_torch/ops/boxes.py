"""
Host-side letterbox geometry and box rescaling for the port (its own copy
of megadetector_tpu/ops/boxes.py letterbox, auto_target_shape,
resize_long_side, compute_stride_target_shape, scale_coords, clip_coords,
xyxy2xywh and xywh2xyxy, with the same rounding).

- letterbox(): scale the image so it fits the target canvas, then pad
  with gray (114) to a stride multiple ('auto') or to the exact canvas.
- scale_coords(): map boxes from canvas pixels back to the original image
  by undoing the pad and the gain.

cv2 resizes and pads where it is installed (INTER_LINEAR, the letterbox
interpolation of YOLOv5); without it a numpy bilinear resize stands in,
which is not bit-identical.
"""

import math

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is expected to be present
    cv2 = None


def auto_target_shape(shape_hw, image_size, stride=64, scaleup=True):
    """
    The minimal stride-multiple canvas letterbox(auto=True) produces for
    an image of [shape_hw] at square target [image_size]; int(round())
    (banker's rounding) as in letterbox, so the two always agree.
    """

    h, w = int(shape_hw[0]), int(shape_hw[1])
    r = min(image_size / h, image_size / w)
    if not scaleup:
        r = min(r, 1.0)
    new_w = int(round(w * r))
    new_h = int(round(h * r))
    dh = (image_size - new_h) % stride
    dw = (image_size - new_w) % stride
    return (new_h + dh, new_w + dw)


def letterbox(im, new_shape=(1280, 1280), color=(114, 114, 114), auto=True,
              scale_fill=False, scaleup=True, stride=64):
    """
    Resize [im] (HWC uint8) preserving aspect ratio and pad to [new_shape].

    Args:
        im: HWC numpy image
        new_shape: int or (h, w) target canvas
        color: pad value
        auto: pad only to the next multiple of [stride] (minimal rectangle)
            instead of the full canvas
        scale_fill: stretch to exactly new_shape (no padding)
        scaleup: allow upscaling small images (False = only shrink)
        stride: stride multiple for 'auto' padding

    Returns:
        (image, ratio, (dw, dh)): the padded image, the (w, h) scale ratios,
        and the per-side padding in pixels (floats; total pad / 2)
    """

    shape = im.shape[:2]
    if isinstance(new_shape, (int, np.integer)):
        new_shape = (int(new_shape), int(new_shape))
    else:
        new_shape = (int(new_shape[0]), int(new_shape[1]))

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # w, h
    dw = new_shape[1] - new_unpad[0]
    dh = new_shape[0] - new_unpad[1]

    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2.0
    dh /= 2.0

    if (shape[1], shape[0]) != new_unpad:
        im = _resize(im, new_unpad)

    top = int(round(dh - 0.1))
    bottom = int(round(dh + 0.1))
    left = int(round(dw - 0.1))
    right = int(round(dw + 0.1))

    im = _pad(im, top, bottom, left, right, color)
    return im, ratio, (dw, dh)


def _resize(im, new_wh):
    """HWC image to (w, h): cv2 INTER_LINEAR, else the numpy bilinear."""

    if cv2 is not None:
        return cv2.resize(im, new_wh, interpolation=cv2.INTER_LINEAR)
    return _numpy_bilinear_resize(im, new_wh)


def resize_long_side(im, image_size, use_ceil=False):
    """
    Resize so the long side equals [image_size] (the 'modern' pre-resize):
    INTER_LINEAR when upsizing, INTER_AREA when downsizing; int() (or
    ceil) target dims. Returns (image, resize_ratio).
    """

    h, w = im.shape[:2]
    resize_ratio = image_size / max(h, w)
    if resize_ratio == 1:
        return im, 1.0
    if use_ceil:
        target_w = math.ceil(w * resize_ratio)
        target_h = math.ceil(h * resize_ratio)
    else:
        target_w = int(w * resize_ratio)
        target_h = int(h * resize_ratio)
    if cv2 is not None:
        interp = cv2.INTER_LINEAR if resize_ratio > 1 else cv2.INTER_AREA
        im = cv2.resize(im, (target_w, target_h), interpolation=interp)
    else:
        im = _numpy_bilinear_resize(im, (target_w, target_h))
    return im, resize_ratio


def _pad(im, top, bottom, left, right, color):
    """Constant-pad an HWC image."""

    if top == bottom == left == right == 0:
        return im
    if cv2 is not None:
        return cv2.copyMakeBorder(im, top, bottom, left, right,
                                  cv2.BORDER_CONSTANT, value=color)
    c = im.shape[2] if im.ndim == 3 else 1
    pad_value = np.array(color, dtype=im.dtype).reshape(1, 1, -1)[..., :c]
    out = np.empty((im.shape[0] + top + bottom,
                    im.shape[1] + left + right) + im.shape[2:],
                   dtype=im.dtype)
    out[...] = pad_value
    out[top:top + im.shape[0], left:left + im.shape[1]] = im
    return out


def _numpy_bilinear_resize(im, new_wh):
    """Pure-numpy bilinear resize (cv2-free fallback; not bit-identical)."""

    w, h = new_wh
    src_h, src_w = im.shape[:2]
    ys = (np.arange(h) + 0.5) * src_h / h - 0.5
    xs = (np.arange(w) + 0.5) * src_w / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, src_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, src_w - 1)
    y1 = np.clip(y0 + 1, 0, src_h - 1)
    x1 = np.clip(x0 + 1, 0, src_w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    im_f = im.astype(np.float32)
    top = im_f[y0][:, x0] * (1 - wx) + im_f[y0][:, x1] * wx
    bot = im_f[y1][:, x0] * (1 - wx) + im_f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(im.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255)
    return out.astype(im.dtype)


def compute_stride_target_shape(image_shape, image_size, stride, pad=0.5):
    """
    The reference's 'modern' target-shape computation
    (pytorch_detector.py:1090-1101): normalize the image shape by its long
    side, scale to [image_size], divide by stride, add [pad], ceil, multiply
    back by stride. Returns an (h, w) int array.
    """

    max_dimension = max(image_shape[:2])
    normalized = np.array([image_shape[0] / max_dimension,
                           image_shape[1] / max_dimension])
    return (np.ceil(((normalized * image_size) / stride) + pad)
            .astype(int) * stride)


def scale_coords(img1_shape, coords, img0_shape, ratio_pad=None):
    """
    Rescale xyxy [coords] (numpy [N,4], modified in place and returned) from
    the letterboxed canvas [img1_shape] = (h, w) back to the original image
    [img0_shape] = (h, w). When [ratio_pad] is None, gain/pad are recomputed
    from the two shapes; otherwise ratio_pad = ((gain_h, gain_w), (dw, dh)).
    """

    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0],
                   img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]

    coords[:, [0, 2]] -= pad[0]
    coords[:, [1, 3]] -= pad[1]
    coords[:, :4] /= gain
    clip_coords(coords, img0_shape)
    return coords


def clip_coords(boxes, shape):
    """Clip xyxy boxes (numpy, in place) to (h, w) image bounds."""

    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, shape[1])
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, shape[0])
    return boxes


def xyxy2xywh(x):
    """xyxy -> center-format xywh (numpy [N,4])."""

    y = np.copy(x).astype(np.float64)
    y[:, 0] = (x[:, 0] + x[:, 2]) / 2
    y[:, 1] = (x[:, 1] + x[:, 3]) / 2
    y[:, 2] = x[:, 2] - x[:, 0]
    y[:, 3] = x[:, 3] - x[:, 1]
    return y


def xywh2xyxy(x):
    """Center-format xywh -> xyxy (numpy [N,4])."""

    y = np.copy(x).astype(np.float64)
    y[:, 0] = x[:, 0] - x[:, 2] / 2
    y[:, 1] = x[:, 1] - x[:, 3] / 2
    y[:, 2] = x[:, 0] + x[:, 2] / 2
    y[:, 3] = x[:, 1] + x[:, 3] / 2
    return y
