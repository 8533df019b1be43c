"""
Image loading and box rendering for the port: its own copy of
megadetector_tpu/visualization/visualization_utils.py load_image,
render_detection_bounding_boxes and what it calls. Images are converted
to RGB and EXIF orientation is applied as the MD loader does (rotate by
{3: 180, 6: 270, 8: 90} degrees with expand=True; mirrored orientations
unsupported). PIL is imported only when an image is loaded or drawn on.
"""

import math

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


def load_image(input_file, ignore_exif_rotation=False):
    """
    Open a local image file (or a binary stream) with PIL, convert it to
    RGB, apply its EXIF orientation and decode the pixels.
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

    image.load()
    return image


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
