"""
Letterbox on the device: batched resize + pad + normalize of raw uint8
staging canvases (counterpart of megadetector_tpu/ops/preprocess_device.py
letterbox_one, letterbox_batch and stage_images).

The host only decodes images and copies each into a uint8 staging canvas
(stage_images); the device computes, per image, the letterbox geometry of
ops/boxes.letterbox (r = min(T/h, T/w) with T the square scale target,
round-half-even new size, centered padding split with the -0.1 offset), a
bilinear resize with cv2's half-pixel convention, gray (114) padding and
the /255 normalization.

letterbox_batch is the JAX package's matmul form: the separable resize as
two products with one-hot interpolation matrices built per batch ([B,
canvas, staging] float32), computed by torch.matmul in float32 (TF32 off
on a card), as XLA computes them outside any kernel. With resize_dtype
bf16 the operands are rounded to bf16 first and multiplied in float32,
which is what the JAX bf16 operands with float32 accumulation give (uint8
pixels are exact in bf16; only the weights round, <= 2/255 of drift).
letterbox_batch_gather is the elementwise four-corner form, the numerics
oracle of the tests.

Every division is tensor by tensor: on a card, dividing by a Python
number multiplies by its reciprocal, which is not the JAX division.
"""

import numpy as np
import torch


def _div(a, b):
    """a / b as an IEEE division on a's device (b a tensor or a number)."""

    if not torch.is_tensor(b):
        b = torch.full((), float(np.float32(b)), dtype=torch.float32,
                       device=a.device)
    return a / b


def _out_hw(out_size):
    if isinstance(out_size, (tuple, list)):
        return int(out_size[0]), int(out_size[1])
    return int(out_size), int(out_size)


def _geometry(sizes, s_h, s_w, scale_target):
    """Per image float32 [B, 1] tensors: h, w, new_h, new_w, top, left."""

    t = float(scale_target) if scale_target is not None \
        else float(max(s_h, s_w))
    h = sizes[:, 0:1].to(torch.float32)
    w = sizes[:, 1:2].to(torch.float32)
    tt = torch.full_like(h, t)
    r = torch.minimum(tt / h, tt / w)
    # round half to even, like Python's int(round()) in letterbox
    new_w = torch.round(w * r)
    new_h = torch.round(h * r)
    # the -0.1 offset makes these tie-free; floor(x + 0.5)
    left = torch.floor((s_w - new_w) / 2.0 - 0.1 + 0.5)
    top = torch.floor((s_h - new_h) / 2.0 - 0.1 + 0.5)
    return h, w, new_h, new_w, top, left


def _source_positions(n, offset, size, new_size, device):
    """cv2 half-pixel source positions [B, n] of n output pixels, clipped
    to the valid extent [0, size - 1]."""

    o = torch.arange(n, dtype=torch.float32, device=device)[None, :]
    pos = (o - offset + 0.5) * _div(size, new_size) - 0.5
    return torch.minimum(torch.clamp(pos, min=0.0), size - 1.0), o


def _interp_matrix(src_pos, src_size, src_extent):
    """
    One-hot bilinear interpolation matrices [B, n, src_size]: row i holds
    (1 - f) at floor(src_pos[i]) and f at floor + 1 (clamped to the valid
    extent); when both clamp to one column the weights sum back to 1.
    """

    y0f = torch.floor(src_pos)
    frac = src_pos - y0f
    y0 = y0f.to(torch.int64)
    y1 = torch.minimum(y0 + 1, src_extent.to(torch.int64) - 1)
    cols = torch.arange(src_size, device=src_pos.device)[None, None, :]
    return (cols == y0[..., None]).to(torch.float32) * \
        (1 - frac)[..., None] + \
        (cols == y1[..., None]).to(torch.float32) * frac[..., None]


def letterbox_batch(images_u8, sizes, out_size, scale_target=None,
                    resize_dtype=None, fold_layout=None, pad_value=114.0):
    """
    Batched letterbox on the device (the matmul form).

    Args:
        images_u8: [B, S0h, S0w, 3] uint8 staging canvases
        sizes: [B, 2] int (height, width) of each valid region
        out_size: canvas, an int (square) or (h, w)
        scale_target: the square size the ratio derives from (default
            max(out_h, out_w)); the model's image size with a minimal
            stride-rectangle canvas reproduces letterbox(auto=True)
        resize_dtype: None (float32 operands) or torch.bfloat16 (operands
            rounded to bf16, products summed in float32)
        fold_layout: None only; the JAX package's 'h2' folded stem layout
            exists for the TPU's lanes and is not ported

    Returns:
        [B, out_h, out_w, 3] float32 in [0, 1]
    """

    if fold_layout is not None:
        raise NotImplementedError(
            'fold_layout={!r}: the folded stem layout is not ported'.format(
                fold_layout))
    if resize_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError('resize_dtype must be None, float32 or bfloat16')
    s_h, s_w = _out_hw(out_size)
    b, s0h, s0w, _ = images_u8.shape
    device = images_u8.device
    sizes = torch.as_tensor(sizes, device=device)
    h, w, new_h, new_w, top, left = _geometry(sizes, s_h, s_w, scale_target)

    sy, oy = _source_positions(s_h, top, h, new_h, device)
    sx, ox = _source_positions(s_w, left, w, new_w, device)
    row_ok = (oy >= top) & (oy < top + new_h)                # [B, s_h]
    col_ok = (ox >= left) & (ox < left + new_w)              # [B, s_w]
    # Rows of the padding read 0 and get the pad value added below
    m_v = _interp_matrix(sy, s0h, sizes[:, 0:1]) * \
        row_ok[..., None].to(torch.float32)                  # [B, s_h, S0h]
    m_h = _interp_matrix(sx, s0w, sizes[:, 1:2]) * \
        col_ok[..., None].to(torch.float32)                  # [B, s_w, S0w]

    def operand(t):
        if resize_dtype == torch.bfloat16:
            return t.to(torch.bfloat16).to(torch.float32)
        return t

    img = images_u8.to(torch.float32).reshape(b, s0h, s0w * 3)
    y = torch.matmul(operand(m_v), img)                      # [B, s_h, S0w*3]
    y = y.reshape(b, s_h, s0w, 3).transpose(2, 3)            # [B, s_h, 3, S0w]
    out = torch.matmul(operand(y.reshape(b, s_h * 3, s0w)),
                       operand(m_h).transpose(1, 2))         # [B, s_h*3, s_w]
    out = out.reshape(b, s_h, 3, s_w).transpose(2, 3)        # [B, s_h, s_w, 3]

    mask = (row_ok[:, :, None] & col_ok[:, None, :])[..., None]
    out = out + (1.0 - mask.to(torch.float32)) * pad_value
    return _div(out, 255.0)


def letterbox_one(image_u8, height, width, out_size, pad_value=114.0,
                  use_matmul=True, scale_target=None, resize_dtype=None,
                  fold_layout=None):
    """
    Letterbox one image from a staging canvas onto [out_h, out_w]: the
    geometry of letterbox_batch on a batch of one.

    Args:
        image_u8: [S0h, S0w, 3] uint8 staging canvas; the valid image
            occupies the top-left [height, width] region
        height, width: ints or 0-d integer tensors, the valid region
        out_size: canvas, an int (square) or (h, w)
        use_matmul: True for the matmul form (letterbox_batch), False for
            the four-corner gather (letterbox_batch_gather; float32, and
            resize_dtype is ignored there, as in the JAX function)
        scale_target, resize_dtype: as in letterbox_batch
        fold_layout: None only; the folded stem layout is TPU-only and
            any other value raises ValueError

    Returns:
        [out_h, out_w, 3] float32 in [0, 1]
    """

    if fold_layout is not None:
        raise ValueError(
            'fold_layout={!r}: the folded stem layout is TPU-only and not '
            'ported'.format(fold_layout))
    device = image_u8.device
    sizes = torch.stack([torch.as_tensor(height, device=device),
                         torch.as_tensor(width, device=device)]).reshape(
                             1, 2).to(torch.int32)
    if use_matmul:
        return letterbox_batch(image_u8[None], sizes, out_size,
                               scale_target=scale_target,
                               resize_dtype=resize_dtype,
                               pad_value=pad_value)[0]
    return letterbox_batch_gather(image_u8[None], sizes, out_size,
                                  scale_target=scale_target,
                                  pad_value=pad_value)[0]


def letterbox_batch_gather(images_u8, sizes, out_size, scale_target=None,
                           pad_value=114.0):
    """The four-corner gather form of letterbox_batch (same geometry and
    arguments, float32 only): the numerics oracle."""

    s_h, s_w = _out_hw(out_size)
    b = images_u8.shape[0]
    device = images_u8.device
    sizes = torch.as_tensor(sizes, device=device)
    h, w, new_h, new_w, top, left = _geometry(sizes, s_h, s_w, scale_target)
    sy, oy = _source_positions(s_h, top, h, new_h, device)   # [B, s_h]
    sx, ox = _source_positions(s_w, left, w, new_w, device)  # [B, s_w]
    in_region = ((oy >= top) & (oy < top + new_h))[:, :, None] & \
        ((ox >= left) & (ox < left + new_w))[:, None, :]

    y0f, x0f = torch.floor(sy), torch.floor(sx)
    wy = (sy - y0f)[:, :, None, None]
    wx = (sx - x0f)[:, None, :, None]
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    y1 = torch.minimum(y0 + 1, sizes[:, 0:1].to(torch.int64) - 1)
    x1 = torch.minimum(x0 + 1, sizes[:, 1:2].to(torch.int64) - 1)
    img = images_u8.to(torch.float32)
    bi = torch.arange(b, device=device)[:, None, None]

    def gather(yi, xi):
        return img[bi, yi[:, :, None], xi[:, None, :]]

    interp = (gather(y0, x0) * (1 - wy) * (1 - wx) +
              gather(y0, x1) * (1 - wy) * wx +
              gather(y1, x0) * wy * (1 - wx) +
              gather(y1, x1) * wy * wx)
    out = torch.where(in_region[..., None], interp,
                      torch.full_like(interp, pad_value))
    return _div(out, 255.0)


def stage_images(images, staging_size=None, multiple=128):
    """
    Host-side staging: copy variable-size HWC uint8 images into one padded
    uint8 batch (a copy, no resize). The staging canvas is the
    per-dimension max rounded up to [multiple], or [staging_size] (an int
    or (h, w)); larger images must be shrunk on the host first.

    Returns (staged [B, S0h, S0w, 3] uint8, sizes [B, 2] int32).
    """

    max_h = max(im.shape[0] for im in images)
    max_w = max(im.shape[1] for im in images)
    if staging_size is None:
        staging_h = ((max_h + multiple - 1) // multiple) * multiple
        staging_w = ((max_w + multiple - 1) // multiple) * multiple
    elif isinstance(staging_size, (tuple, list)):
        staging_h, staging_w = int(staging_size[0]), int(staging_size[1])
    else:
        staging_h = staging_w = int(staging_size)
    if max_h > staging_h or max_w > staging_w:
        raise ValueError('Image {}x{} exceeds the staging canvas {}x{}'
                         .format(max_h, max_w, staging_h, staging_w))

    staged = np.zeros((len(images), staging_h, staging_w, 3), dtype=np.uint8)
    sizes = np.zeros((len(images), 2), dtype=np.int32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        staged[i, :h, :w] = im
        sizes[i] = (h, w)
    return staged, sizes
