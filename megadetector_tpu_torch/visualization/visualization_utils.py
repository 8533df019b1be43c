"""
Image loading and box rendering for the port: its own copy of
megadetector_tpu/visualization/visualization_utils.py load_image,
render_detection_bounding_boxes and what it calls, and the previews'
open_image, resize_image (with exif_preserving_save) and
render_db_bounding_boxes, the crop folder's crop_image, and the rest
of the JAX module's public functions (arrays, blurring, MegaDB and
database boxes on files, integrity checks, sizes, resizing folders;
draw_bounding_boxes_on_file is the second of JAX's two definitions, the
one its module binds). Images are
converted to RGB and EXIF orientation is applied as the MD loader does (rotate by
{3: 180, 6: 270, 8: 90} degrees with expand=True; mirrored orientations
unsupported). PIL is imported only when an image is loaded or drawn on.
"""

import math
import os

import numpy as np

# EXIF tag 274 = Orientation; values map to counterclockwise PIL rotations
EXIF_ORIENTATION_TAG = 274
EXIF_IMAGE_NO_ROTATION = 1
EXIF_IMAGE_ROTATIONS = {3: 180, 6: 270, 8: 90}

# Default per-category colors used when rendering boxes; category '1' =
# animal, '2' = person, '3' = vehicle
DEFAULT_COLORS = [
    'AliceBlue', 'Red', 'RoyalBlue', 'Gold', 'Chartreuse', 'Aqua', 'Azure',
    'Beige', 'Bisque', 'BlanchedAlmond', 'BlueViolet', 'BurlyWood',
    'CadetBlue', 'AntiqueWhite', 'Chocolate', 'Coral', 'CornflowerBlue',
    'Cornsilk', 'Crimson', 'Cyan', 'DarkCyan', 'DarkGoldenRod', 'DarkGrey',
    'DarkKhaki', 'DarkOrange', 'DarkOrchid', 'DarkSalmon', 'DarkSeaGreen',
    'DarkTurquoise', 'DarkViolet', 'DeepPink', 'DeepSkyBlue', 'DodgerBlue',
    'FireBrick', 'FloralWhite', 'ForestGreen', 'Fuchsia', 'Gainsboro',
    'GhostWhite', 'GoldenRod', 'Salmon', 'Tan', 'HoneyDew', 'HotPink',
    'IndianRed', 'Ivory', 'Khaki', 'Lavender', 'LavenderBlush', 'LawnGreen',
    'LemonChiffon', 'LightBlue', 'LightCoral', 'LightCyan',
    'LightGoldenRodYellow', 'LightGray', 'LightGrey', 'LightGreen',
    'LightPink', 'LightSalmon', 'LightSeaGreen', 'LightSkyBlue',
    'LightSlateGray', 'LightSlateGrey', 'LightSteelBlue', 'LightYellow',
    'Lime', 'LimeGreen', 'Linen', 'Magenta', 'MediumAquaMarine',
    'MediumOrchid', 'MediumPurple', 'MediumSeaGreen', 'MediumSlateBlue',
    'MediumSpringGreen', 'MediumTurquoise', 'MediumVioletRed', 'MintCream',
    'MistyRose', 'Moccasin', 'NavajoWhite', 'OldLace', 'Olive', 'OliveDrab',
    'Orange', 'OrangeRed', 'Orchid', 'PaleGoldenRod', 'PaleGreen',
    'PaleTurquoise', 'PaleVioletRed', 'PapayaWhip', 'PeachPuff', 'Peru',
    'Pink', 'Plum', 'PowderBlue', 'Purple', 'RosyBrown', 'Aquamarine',
    'SaddleBrown', 'Green', 'SandyBrown', 'SeaGreen', 'SeaShell', 'Sienna',
    'Silver', 'SkyBlue', 'SlateBlue', 'SlateGray', 'SlateGrey', 'Snow',
    'SpringGreen', 'SteelBlue', 'GreenYellow', 'Teal', 'Thistle', 'Tomato',
    'Turquoise', 'Violet', 'Wheat', 'White', 'WhiteSmoke', 'Yellow',
    'YellowGreen'
]

DEFAULT_BOX_THICKNESS = 4
DEFAULT_LABEL_FONT_SIZE = 16

DEFAULT_DETECTOR_LABEL_MAP = {'1': 'animal', '2': 'person', '3': 'vehicle'}

TEXTALIGN_LEFT = 0
TEXTALIGN_RIGHT = 1


def open_image(input_file, ignore_exif_rotation=False):
    """
    Open a local image file (or a binary stream) with PIL, convert it to
    RGB and apply its EXIF orientation. Lazy: the pixels are decoded at
    first use; see load_image() for the eager version.
    """

    from PIL import Image

    image = Image.open(input_file)
    if image.mode not in ('RGBA', 'RGB', 'L', 'I;16'):
        raise AttributeError(
            'Image {} uses unsupported mode {}'.format(input_file, image.mode))
    if image.mode in ('RGBA', 'L'):
        image = image.convert(mode='RGB')

    if not ignore_exif_rotation:
        try:
            exif = image._getexif()
            orientation = exif.get(EXIF_ORIENTATION_TAG, None)
            if orientation is not None and \
                    orientation != EXIF_IMAGE_NO_ROTATION:
                if orientation not in EXIF_IMAGE_ROTATIONS:
                    raise ValueError('Mirrored rotations are not supported')
                image = image.rotate(
                    EXIF_IMAGE_ROTATIONS[orientation], expand=True)
        except Exception:
            pass

    return image


def load_image(input_file, ignore_exif_rotation=False):
    """Eager version of open_image(): decodes the pixels before returning."""

    image = open_image(input_file, ignore_exif_rotation=ignore_exif_rotation)
    image.load()
    return image


def exif_preserving_save(pil_image, output_file, quality='keep',
                         default_quality=85, verbose=False):
    """Save a PIL image, keeping JPEG quality/EXIF where possible."""

    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    kwargs = {}
    exif = pil_image.info.get('exif', None)
    if exif is not None:
        kwargs['exif'] = exif
    if output_file.lower().endswith(('.jpg', '.jpeg')):
        if quality == 'keep':
            try:
                pil_image.save(output_file, quality='keep', **kwargs)
                return
            except Exception:
                kwargs['quality'] = default_quality
        else:
            kwargs['quality'] = quality if isinstance(quality, int) \
                else default_quality
    pil_image.save(output_file, **kwargs)


def resize_image(image, target_width=-1, target_height=-1, output_file=None,
                 no_enlarge_width=False, verbose=False, quality='keep'):
    """
    Resize a PIL image (or filename) to the given size; -1 in one dimension
    preserves aspect ratio; -1 in both is a no-op (but still writes
    output_file when given).
    """

    from PIL import Image

    if isinstance(image, str):
        image = load_image(image)

    if target_width is None:
        target_width = -1
    if target_height is None:
        target_height = -1

    resize_required = not (target_width == -1 and target_height == -1)

    if resize_required and (target_width == -1 or target_height == -1):
        aspect_ratio = image.size[0] / image.size[1]
        if target_width != -1:
            target_height = int(target_width / aspect_ratio)
        else:
            target_width = int(aspect_ratio * target_height)

    if no_enlarge_width and target_width > image.size[0]:
        resize_required = False

    if (target_width == image.size[0]) and (target_height == image.size[1]):
        resize_required = False

    if not resize_required:
        if output_file is not None:
            exif_preserving_save(image, output_file, quality=quality)
        return image

    assert target_width > 0 and target_height > 0, \
        'Invalid resize target {}x{}'.format(target_width, target_height)

    resized = image.resize((target_width, target_height),
                           Image.Resampling.LANCZOS)
    if output_file is not None:
        exif_preserving_save(resized, output_file, quality=quality)
    return resized


def crop_image(detections, image, confidence_threshold=0.15, expansion=0):
    """
    Crop detections above [confidence_threshold] out of a PIL image.
    Returns a list of PIL images, one per qualifying detection; boxes are in
    normalized MD xywh format; [expansion] is in pixels per side.
    """

    crops = []
    img_w, img_h = image.size
    for d in detections:
        if d['conf'] < confidence_threshold:
            continue
        x, y, w, h = d['bbox']
        left = int(round(x * img_w)) - expansion
        top = int(round(y * img_h)) - expansion
        right = int(round((x + w) * img_w)) + expansion
        bottom = int(round((y + h) * img_h)) + expansion
        left = max(left, 0)
        top = max(top, 0)
        right = min(right, img_w)
        bottom = min(bottom, img_h)
        crops.append(image.crop((left, top, right, bottom)))
    return crops


def _get_font(size):
    """Best-effort truetype font; falls back to PIL's default."""

    from PIL import ImageFont

    for name in ('DejaVuSans.ttf', 'Arial.ttf', 'arial.ttf'):
        try:
            return ImageFont.truetype(name, size)
        except Exception:
            continue
    return ImageFont.load_default()


def get_text_size(font, s):
    """
    Expected (width, height) in pixels when rendering the string [s] in
    [font]: getbbox's right and bottom, which track Pillow 9's getsize
    most closely.
    """

    try:
        left, top, right, bottom = font.getbbox(s)
        return right, bottom
    except Exception:
        return font.getsize(s)


def draw_bounding_box_on_image(image, ymin, xmin, ymax, xmax, clss=None,
                               thickness=DEFAULT_BOX_THICKNESS,
                               expansion=0, display_str_list=(),
                               use_normalized_coordinates=True,
                               label_font_size=DEFAULT_LABEL_FONT_SIZE,
                               colormap=DEFAULT_COLORS,
                               textalign=TEXTALIGN_LEFT):
    """
    Draw one box (and optional label strings) on a PIL image, in place.
    Coordinates are (ymin, xmin, ymax, xmax), normalized by default.
    """

    from PIL import ImageDraw

    draw = ImageDraw.Draw(image)
    im_width, im_height = image.size
    if use_normalized_coordinates:
        left, right = xmin * im_width, xmax * im_width
        top, bottom = ymin * im_height, ymax * im_height
    else:
        left, right, top, bottom = xmin, xmax, ymin, ymax

    if expansion > 0:
        left -= expansion
        right += expansion
        top -= expansion
        bottom += expansion
        left = max(left, 0)
        top = max(top, 0)
        right = min(right, im_width - 1)
        bottom = min(bottom, im_height - 1)

    if clss is None:
        color = colormap[1]
    else:
        color = colormap[int(clss) % len(colormap)]

    draw.line([(left, top), (left, bottom), (right, bottom), (right, top),
               (left, top)], width=thickness, fill=color)

    if len(display_str_list) > 0:
        font = _get_font(label_font_size)
        text_y = top
        for display_str in display_str_list[::-1]:
            try:
                bbox = draw.textbbox((0, 0), display_str, font=font)
                text_w = bbox[2] - bbox[0]
                text_h = bbox[3] - bbox[1]
            except Exception:
                text_w, text_h = (8 * len(display_str), label_font_size)
            margin = int(math.ceil(0.05 * text_h))
            box_top = text_y - text_h - 2 * margin
            if box_top < 0:
                box_top = bottom
                text_y = bottom + text_h + 2 * margin
            text_x = left
            if textalign == TEXTALIGN_RIGHT:
                text_x = right - text_w
            draw.rectangle([(text_x, box_top),
                            (text_x + text_w + 2 * margin, text_y)],
                           fill=color)
            draw.text((text_x + margin, box_top + margin), display_str,
                      fill='black', font=font)
            text_y = box_top
    return image


def render_detection_bounding_boxes(
        detections, image,
        label_map=DEFAULT_DETECTOR_LABEL_MAP,
        classification_label_map=None,
        confidence_threshold=0.15,
        thickness=DEFAULT_BOX_THICKNESS,
        expansion=0,
        classification_confidence_threshold=0.3,
        max_classifications=3,
        colormap=DEFAULT_COLORS,
        label_font_size=DEFAULT_LABEL_FONT_SIZE):
    """
    Render MD-format detections (normalized xywh boxes) onto a PIL image,
    in place, with per-category colors and 'label: conf%' strings; also
    renders classification labels when present. [confidence_threshold]
    may be a dict keyed by category id with a 'default' fallback.
    """

    for detection in detections:
        score = detection['conf']
        threshold = confidence_threshold
        if isinstance(threshold, dict):
            threshold = threshold.get(detection['category'],
                                      threshold.get('default', 0.15))
        if score is None or score < threshold:
            continue

        x, y, w, h = detection['bbox']
        clss = detection['category']
        label = label_map.get(clss, clss) if label_map else ''
        display_strs = []
        if label:
            display_strs.append('{}: {:.0f}%'.format(label, 100 * score))

        classifications = detection.get('classifications', [])
        for classification in classifications[:max_classifications]:
            class_id, class_conf = classification[0], classification[1]
            if class_conf is None or \
                    class_conf < classification_confidence_threshold:
                continue
            class_label = class_id
            if classification_label_map and \
                    class_id in classification_label_map:
                class_label = classification_label_map[class_id]
            display_strs.append('{}: {:.1f}%'.format(
                class_label, 100 * class_conf))

        draw_bounding_box_on_image(
            image, y, x, y + h, x + w, clss=clss, thickness=thickness,
            expansion=expansion, display_str_list=display_strs,
            colormap=colormap, label_font_size=label_font_size)

    return image


def render_db_bounding_boxes(boxes, classes, image, original_size=None,
                             label_map=None,
                             thickness=DEFAULT_BOX_THICKNESS,
                             expansion=0, colormap=None,
                             label_font_size=DEFAULT_LABEL_FONT_SIZE,
                             boxes_are_normalized=False):
    """
    Render COCO-Camera-Traps-style boxes (absolute-pixel x, y, w, h unless
    boxes_are_normalized) with class labels on a PIL image, in place;
    [original_size] rescales boxes annotated on a different resolution.
    """

    display_boxes = []
    display_strs = []
    if original_size is not None and \
            tuple(original_size) != tuple(image.size):
        image_size = original_size
    else:
        image_size = image.size
    img_width, img_height = image_size

    for box, clss in zip(boxes, classes):
        x_min, y_min, width_of_box, height_of_box = box
        if boxes_are_normalized:
            x_min *= img_width
            y_min *= img_height
            width_of_box *= img_width
            height_of_box *= img_height
        # Normalize against the annotation-time size so rendering on a
        # resized image lands correctly
        display_boxes.append([y_min / img_height, x_min / img_width,
                              (y_min + height_of_box) / img_height,
                              (x_min + width_of_box) / img_width])
        if label_map is not None and clss in label_map:
            display_strs.append([str(label_map[clss])])
        elif label_map is not None and str(clss) in label_map:
            display_strs.append([str(label_map[str(clss)])])
        else:
            display_strs.append([str(clss)])

    for box, clss, strs in zip(display_boxes, classes, display_strs):
        try:
            clss_int = int(clss)
        except (TypeError, ValueError):
            clss_int = abs(hash(str(clss))) % 100
        draw_bounding_box_on_image(
            image, box[0], box[1], box[2], box[3], clss=clss_int,
            thickness=thickness, expansion=expansion,
            display_str_list=strs, use_normalized_coordinates=True,
            label_font_size=label_font_size,
            colormap=colormap or DEFAULT_COLORS)
    return image


#%% The rest of the JAX module's public functions


def load_image_as_array(input_file, ignore_exif_rotation=False):
    """Load an image directly to an RGB uint8 numpy array (H, W, 3)."""

    image = load_image(input_file, ignore_exif_rotation=ignore_exif_rotation)
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def blur_detections(image, detections, confidence_threshold=0.15,
                    blur_radius=25):
    """
    Blur (in place) the regions covered by detections above the threshold;
    typically used to anonymize humans.
    """

    img_w, img_h = image.size
    for d in detections:
        if d['conf'] < confidence_threshold:
            continue
        x, y, w, h = d['bbox']
        box = (max(int(x * img_w), 0), max(int(y * img_h), 0),
               min(int((x + w) * img_w), img_w),
               min(int((y + h) * img_h), img_h))
        if box[2] <= box[0] or box[3] <= box[1]:
            continue
        from PIL import ImageFilter
        region = image.crop(box)
        region = region.filter(ImageFilter.GaussianBlur(radius=blur_radius))
        image.paste(region, box)
    return image


def draw_bounding_boxes_on_image(image, boxes, classes,
                                 thickness=DEFAULT_BOX_THICKNESS,
                                 expansion=0, display_strs=None,
                                 colormap=None,
                                 label_font_size=DEFAULT_LABEL_FONT_SIZE):
    """
    Draw bounding boxes on a PIL image, in place (reference:
    visualization_utils.py:801-862). [boxes] is an [N, 4] numpy array
    of normalized (ymin, xmin, ymax, xmax) rows; [classes] is a
    same-length list of ints (or string-formatted ints) used only for
    color selection; [display_strs] is an optional list (per box) of
    lists of label strings.
    """

    boxes = np.asarray(boxes)
    if not boxes.shape or len(boxes.shape) != 2 or boxes.shape[1] != 4:
        return
    for i in range(boxes.shape[0]):
        display_str_list = ()
        if display_strs:
            display_str_list = display_strs[i]
        draw_bounding_box_on_image(
            image, boxes[i, 0], boxes[i, 1], boxes[i, 2], boxes[i, 3],
            clss=classes[i], thickness=thickness, expansion=expansion,
            display_str_list=display_str_list,
            label_font_size=label_font_size,
            colormap=colormap or DEFAULT_COLORS)


def render_megadb_bounding_boxes(boxes_info, image):
    """
    Render boxes in the mostly-deprecated MegaDB format — dicts with a
    category NAME and a normalized [x_min, y_min, w, h] bbox — onto a
    PIL image, in place (reference:
    visualization_utils.py:1146-1184).
    """

    name_to_id = {'animal': 1, 'person': 2, 'vehicle': 3}
    display_boxes = []
    display_strs = []
    classes = []
    for b in boxes_info:
        x_min, y_min, w_rel, h_rel = b['bbox']
        display_boxes.append([y_min, x_min, y_min + h_rel,
                              x_min + w_rel])
        display_strs.append([b['category']])
        classes.append(name_to_id.get(b['category'], 1))
    draw_bounding_boxes_on_image(image, np.array(display_boxes),
                                 classes, display_strs=display_strs)


def draw_bounding_boxes_on_file(input_file, output_file, detections,
                                confidence_threshold=0.0,
                                detector_label_map=None,
                                thickness=DEFAULT_BOX_THICKNESS,
                                expansion=0, target_size=None,
                                quality=None):
    """
    Render MD-format detections on an image file and write the result
    (reference: visualization_utils.py:1307-1382). Returns the output
    path.
    """

    if detector_label_map is None:
        detector_label_map = DEFAULT_DETECTOR_LABEL_MAP
    image = load_image(input_file)
    if target_size is not None:
        image = resize_image(image, target_size[0], target_size[1])
    render_detection_bounding_boxes(
        detections, image, label_map=detector_label_map,
        confidence_threshold=confidence_threshold,
        thickness=thickness, expansion=expansion)
    parent = os.path.dirname(output_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    save_kwargs = {}
    if quality is not None:
        save_kwargs['quality'] = quality
    image.save(output_file, **save_kwargs)
    return output_file


def check_image_integrity(filename, modes=None):
    """
    Verify that an image can be opened / decoded. Returns a dict with
    'file' and per-mode bool results ('exists', 'load', 'pixel_load').
    """

    if modes is None:
        modes = ['exists', 'load']
    result = {'file': filename}
    if 'exists' in modes:
        result['exists'] = os.path.isfile(filename)
    if 'load' in modes:
        from PIL import Image
        try:
            with Image.open(filename) as im:
                im.verify()
            result['load'] = True
        except Exception:
            result['load'] = False
    if 'pixel_load' in modes:
        try:
            _ = load_image_as_array(filename)
            result['pixel_load'] = True
        except Exception:
            result['pixel_load'] = False
    return result


def gray_scale_fraction(image, crop_size=(0.1, 0.1)):
    """
    Fraction of pixels that are grayscale (R==G==B); used to detect
    night-time/IR images. [crop_size] trims border fractions first.
    """

    if isinstance(image, str):
        image = load_image(image)
    arr = np.asarray(image)
    if arr.ndim == 2 or arr.shape[2] == 1:
        return 1.0
    h, w = arr.shape[:2]
    dh = int(h * crop_size[0])
    dw = int(w * crop_size[1])
    arr = arr[dh:h - dh if h - dh > dh else h, dw:w - dw if w - dw > dw else w]
    r = arr[..., 0].astype(np.int16)
    g = arr[..., 1].astype(np.int16)
    b = arr[..., 2].astype(np.int16)
    gray = (r == g) & (g == b)
    return float(np.mean(gray))


def resize_images(input_file_to_output_file, target_width=-1,
                  target_height=-1, no_enlarge_width=False,
                  verbose=False, quality='keep', n_workers=10,
                  overwrite=True):
    """
    Resize every image in {input path: output path}; returns
    {input path: output path or error string}. -1 in one dimension
    preserves aspect ratio (reference: visualization_utils.py:1562).
    """

    from concurrent.futures import ThreadPoolExecutor

    def _resize_one(item):
        input_file, output_file = item
        try:
            if not overwrite and os.path.isfile(output_file):
                return output_file
            resize_image(input_file, target_width=target_width,
                         target_height=target_height,
                         output_file=output_file,
                         no_enlarge_width=no_enlarge_width,
                         verbose=verbose, quality=quality)
            return output_file
        except Exception as e:
            if verbose:
                print('Error resizing {}: {}'.format(input_file, e))
            return 'error: {}'.format(e)

    items = list(input_file_to_output_file.items())
    if n_workers <= 1 or len(items) <= 1:
        results = [_resize_one(item) for item in items]
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            results = list(pool.map(_resize_one, items))
    return {item[0]: r for item, r in zip(items, results)}


def resize_image_folder(input_folder, output_folder=None,
                        target_width=-1, target_height=-1,
                        no_enlarge_width=False, verbose=False,
                        quality='keep', n_workers=10, recursive=True,
                        image_files_relative=None, overwrite=True):
    """
    Resize all images in a folder, in place (no output_folder) or into
    a parallel tree (reference: visualization_utils.py:1655). Returns
    the resize_images result dict.
    """

    from megadetector_tpu_torch.utils import path_utils

    if image_files_relative is None:
        image_files_relative = path_utils.find_images(
            input_folder, recursive=recursive,
            return_relative_paths=True)
    if output_folder is None:
        output_folder = input_folder

    input_to_output = {}
    for fn_relative in image_files_relative:
        input_to_output[os.path.join(input_folder, fn_relative)] = \
            os.path.join(output_folder, fn_relative)
    return resize_images(
        input_to_output, target_width=target_width,
        target_height=target_height,
        no_enlarge_width=no_enlarge_width, verbose=verbose,
        quality=quality, n_workers=n_workers, overwrite=overwrite)


def get_image_size(im, verbose=False):
    """(w, h) of a filename or PIL image, or None when unreadable
    (reference: visualization_utils.py:1742)."""

    try:
        if isinstance(im, str):
            im = load_image(im)
        w, h = im.width, im.height
        if w <= 0 or h <= 0:
            return None
        return (w, h)
    except Exception as e:
        if verbose:
            print('Error reading image size: {}'.format(e))
        return None


def parallel_get_image_sizes(filenames, max_workers=16, recursive=True,
                             verbose=False):
    """
    {filename: (w, h) or None} for a list or folder of images
    (reference: visualization_utils.py:1777). Non-image/unreadable
    files map to None.
    """

    from concurrent.futures import ThreadPoolExecutor
    from megadetector_tpu_torch.utils import path_utils

    if isinstance(filenames, str):
        filenames = path_utils.find_images(filenames,
                                           recursive=recursive)

    def _size_one(fn):
        if not path_utils.is_image_file(fn):
            return None
        return get_image_size(fn, verbose=verbose)

    if max_workers <= 1 or len(filenames) <= 1:
        sizes = [_size_one(fn) for fn in filenames]
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            sizes = list(pool.map(_size_one, filenames))
    return dict(zip(filenames, sizes))


def parallel_check_image_integrity(filenames, max_workers=16,
                                   recursive=True,
                                   check_decode=True):
    """
    check_image_integrity over a list or folder with a thread pool;
    returns a list of per-image status dicts
    (reference: visualization_utils.py:1843).
    """

    from concurrent.futures import ThreadPoolExecutor
    from megadetector_tpu_torch.utils import path_utils

    if isinstance(filenames, str):
        filenames = path_utils.find_images(filenames,
                                           recursive=recursive)

    modes = ['exists', 'load', 'pixel_load'] if check_decode \
        else ['exists', 'load']

    def _check_one(fn):
        return check_image_integrity(fn, modes=modes)

    if max_workers <= 1 or len(filenames) <= 1:
        return [_check_one(fn) for fn in filenames]
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(_check_one, filenames))


def draw_db_boxes_on_file(input_file, output_file, boxes, classes=None,
                          label_map=None,
                          thickness=DEFAULT_BOX_THICKNESS,
                          expansion=0, boxes_are_normalized=False):
    """
    render_db_bounding_boxes on an image file, written to [output_file]
    (reference: visualization_utils.py:1385-1430). Returns the output
    path.
    """

    image = load_image(input_file)
    if classes is None:
        classes = [0] * len(boxes)
    render_db_bounding_boxes(boxes, classes, image,
                             label_map=label_map, thickness=thickness,
                             expansion=expansion,
                             boxes_are_normalized=boxes_are_normalized)
    parent = os.path.dirname(output_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    image.save(output_file)
    return output_file
