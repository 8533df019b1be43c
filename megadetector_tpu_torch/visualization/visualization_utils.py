"""
Image loading and box rendering for the port: its own copy of
megadetector_tpu/visualization/visualization_utils.py load_image,
render_detection_bounding_boxes and what it calls, and the previews'
open_image, resize_image (with exif_preserving_save) and
render_db_bounding_boxes, and the crop folder's crop_image. Images are
converted to RGB and EXIF orientation is applied as the MD loader does (rotate by
{3: 180, 6: 270, 8: 90} degrees with expand=True; mirrored orientations
unsupported). PIL is imported only when an image is loaded or drawn on.
"""

import math
import os

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
