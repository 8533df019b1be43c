"""
The batch driver's image loader: load + EXIF-rotate + letterbox of one
image file, for the driver's loader pool (its process mode, and its thread
mode with the native loader). The port's own copy of
megadetector_tpu/detection/_loader_worker.py.

It imports neither torch nor jax (nor anything that does): worker
processes are spawned, must not start CUDA, and should start in a fraction
of a second. Its imports are numpy, PIL and cv2 (through ops/boxes and
visualization_utils) and the native JPEG loader.

Two repairs against the JAX module: device preprocessing applies in the
classic modes only, as in the detector's preprocess_image (the JAX worker
stages the image in every mode); and the per-process canvas guard is
locked, since the driver's loader threads share it.
"""

import threading

import numpy as np

FAILURE_IMAGE_OPEN = 'image access failure'

# Per-process view of the detector's max_canvases guard: each process
# tracks the auto canvases it has emitted per (image_size, stride) and
# falls back to the square canvas beyond the cap, so at most
# n_processes * cap shapes reach the device programs
_SEEN_AUTO_CANVASES = {}
_SEEN_LOCK = threading.Lock()


def _auto_target_shape(shape_hw, image_size, stride, scaleup=True,
                       max_canvases=None):
    """The minimal stride-multiple canvas (ops/boxes.auto_target_shape),
    with the per-process guard."""

    from megadetector_tpu_torch.ops.boxes import auto_target_shape

    t = auto_target_shape(shape_hw, image_size, stride=stride,
                          scaleup=scaleup)
    if max_canvases is None or t == (image_size, image_size):
        return t
    with _SEEN_LOCK:
        seen = _SEEN_AUTO_CANVASES.setdefault((image_size, stride), set())
        if t in seen:
            return t
        if len(seen) >= max_canvases:
            return (image_size, image_size)
        seen.add(t)
        return t


def _is_jpeg(im_file):
    return im_file.lower().endswith(('.jpg', '.jpeg'))


def load_and_letterbox(args):
    """
    Worker entry: (im_file, image_size, stride, compatibility_mode,
    preprocess_mode[, max_staging_side[, use_native_loader[, canvas_mode[,
    max_canvases]]]]) -> (im_file, info dict or failure string,
    native_fallback). The info dict is TorchDetector.preprocess_image()'s
    for the same settings. native_fallback is True when the native loader
    was tried on the file and handed it to PIL (a non-RGB JPEG, a mirrored
    EXIF orientation or a decode error; PIL decides whether it is a real
    failure).

    canvas_mode 'auto' letterboxes onto the minimal stride-multiple
    rectangle, 'square' (the default) onto the full square canvas;
    max_canvases applies the detector's guard per process.
    """

    (im_file, image_size, stride, compatibility_mode,
     preprocess_mode) = args[:5]
    max_staging_side = args[5] if len(args) > 5 else None
    use_native_loader = bool(args[6]) if len(args) > 6 else False
    canvas_mode = args[7] if len(args) > 7 else 'square'
    max_canvases = args[8] if len(args) > 8 else None

    from megadetector_tpu_torch.ops import boxes as box_ops
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    classic = 'classic' in compatibility_mode
    device = preprocess_mode == 'device' and classic
    native_fallback = False
    if use_native_loader and classic and _is_jpeg(im_file):
        if device:
            info = _native_load_device(im_file, image_size, stride,
                                       canvas_mode, max_canvases)
        else:
            info = _native_load(im_file, image_size, stride, canvas_mode,
                                max_canvases)
        if info is not None:
            return im_file, info, False
        native_fallback = True

    try:
        img_original = np.asarray(load_image(im_file))
    except Exception:
        return im_file, FAILURE_IMAGE_OPEN, native_fallback

    info = {'file': im_file,
            'scaling_shape': img_original.shape,
            'img_original_pil': None}
    auto = canvas_mode == 'auto'

    try:
        if device:
            # The detector's host pre-shrink of images longer than
            # max_staging_side; normalized coordinates do not depend on
            # the scale, so scaling_shape follows the shrunk image
            max_side = int(max_staging_side or 4096)
            info['original_shape'] = img_original.shape
            if max(img_original.shape[:2]) > max_side:
                img_original, _ = box_ops.resize_long_side(img_original,
                                                           max_side)
                info['scaling_shape'] = img_original.shape
            if auto:
                target = _auto_target_shape(img_original.shape[:2],
                                            image_size, stride,
                                            max_canvases=max_canvases)
            else:
                target = (image_size, image_size)
            info.update({'img_processed': None,
                         'img_original': img_original,
                         'target_shape': target,
                         'scale_target': image_size,
                         'letterbox_ratio': None, 'letterbox_pad': None})
            return im_file, info, native_fallback

        scaleup = classic
        if not classic:
            use_ceil = 'use_ceil_for_resize' in compatibility_mode
            img_original, _ = box_ops.resize_long_side(
                img_original, image_size, use_ceil=use_ceil)
        if auto and max_canvases is not None:
            # Square when the guard refused this image's rectangle
            t = _auto_target_shape(img_original.shape[:2], image_size,
                                   stride, scaleup=scaleup,
                                   max_canvases=max_canvases)
            auto = t != (image_size, image_size) or \
                box_ops.auto_target_shape(img_original.shape[:2],
                                          image_size, stride=stride,
                                          scaleup=scaleup) == t
        img, ratio, pad = box_ops.letterbox(
            img_original, new_shape=(image_size, image_size), stride=stride,
            auto=auto, scaleup=scaleup)
        info.update({'img_processed': img, 'img_original': img_original,
                     'target_shape': img.shape[:2],
                     'letterbox_ratio': ratio, 'letterbox_pad': pad})
        return im_file, info, native_fallback
    except Exception:
        return im_file, FAILURE_IMAGE_OPEN, native_fallback


def _read(im_file):
    with open(im_file, 'rb') as f:
        return f.read()


def _native_load_device(im_file, image_size, stride=64,
                        canvas_mode='square', max_canvases=None):
    """
    Native DCT-scaled decode (no letterbox) for device preprocessing: the
    JPEG decodes at the smallest libjpeg scale_num/8 that covers
    image_size on the long side, so the staging canvas shrinks. Its
    scaling_shape is the scaled image's (normalized output coordinates do
    not depend on the scale). An info dict, or None for the PIL path.
    """

    from megadetector_tpu_torch import native

    native.load_library()
    try:
        img = native.decode_jpeg_scaled(_read(im_file),
                                        dct_scale_target=image_size)
    except Exception:
        return None

    if canvas_mode == 'auto':
        target = _auto_target_shape(img.shape[:2], image_size, stride,
                                    max_canvases=max_canvases)
    else:
        target = (image_size, image_size)
    return {
        'file': im_file,
        'scaling_shape': img.shape,
        'img_original_pil': None,
        'img_processed': None,
        'img_original': img,
        'target_shape': target,
        'scale_target': image_size,
        'letterbox_ratio': None,
        'letterbox_pad': None,
    }


def _native_load(im_file, image_size, stride=64, canvas_mode='square',
                 max_canvases=None):
    """
    Native decode + EXIF rotation + letterbox (jpeg_loader.cpp). An info
    dict, or None for the PIL path. Its decode may differ from PIL's by a
    few levels.

    In 'auto' canvas mode the rectangle comes from the JPEG header's dims
    (PIL reads them without decoding) and the EXIF orientation; the
    library then decodes straight onto that canvas.
    """

    import io

    from PIL import Image

    from megadetector_tpu_torch import native

    native.load_library()
    try:
        data = _read(im_file)
        canvas_hw = int(image_size)
        if canvas_mode == 'auto':
            with Image.open(io.BytesIO(data)) as pim:
                w0, h0 = pim.size  # header only, no decode
                try:
                    orientation = pim.getexif().get(274, 1)
                except Exception:
                    orientation = 1
            if orientation in (6, 8):
                h0, w0 = w0, h0  # the dims after rotation
            canvas_hw = _auto_target_shape((h0, w0), image_size, stride,
                                           max_canvases=max_canvases)
        canvas, (h, w) = native.decode_jpeg_letterbox(
            data, canvas_hw, pad_value=114, scale_target=int(image_size))
    except Exception:
        return None

    # ops/boxes.letterbox's geometry: the ratio from the square target,
    # rounded half to even, as letterbox(auto=True)
    ch, cw = canvas.shape[:2]
    r = min(image_size / h, image_size / w)
    new_w = min(int(round(w * r)), cw)
    new_h = min(int(round(h * r)), ch)
    return {
        'file': im_file,
        'scaling_shape': (h, w, 3),
        'img_original_pil': None,
        'img_original': None,
        'img_processed': canvas,
        'target_shape': canvas.shape[:2],
        'letterbox_ratio': (r, r),
        'letterbox_pad': ((cw - new_w) / 2.0, (ch - new_h) / 2.0),
    }
