"""
Datetime extraction from camera-trap info bars (reference:
megadetector/data_management/ocr_tools.py): locate the solid-background
metadata strip at the top/bottom of an image, crop it, OCR it, and parse
a datetime out of the recognized text.

The OCR engine is injectable (any fn image->string); the default uses
pytesseract when available (the reference shells out to tesseract, which
is not part of this framework's environment).

The port's own copy of megadetector_tpu/data_management/ocr_tools.py:
the same public names, signatures, defaults and output bytes.
"""

import datetime
import re

import numpy as np


class DatetimeExtractionOptions:

    def __init__(self):
        # Fractions of image height to probe for the info bar
        self.image_crop_fraction = [0.045, 0.045]
        # Min/max fraction of pixels that must be near-uniform for a
        # row to count as part of a solid info bar
        self.row_uniformity_threshold = 0.75
        # Intensity delta for "uniform" pixels
        self.uniformity_delta = 18
        # Pad applied around the detected bar before OCR
        self.crop_padding = 2


def make_rough_crops(image, options=None):
    """
    Top and bottom candidate strips of [image] (PIL or HWC numpy).
    Returns [{'image': np.uint8, 'location': 'top'/'bottom'}].
    """

    if options is None:
        options = DatetimeExtractionOptions()
    arr = np.asarray(image)
    h = arr.shape[0]
    crops = []
    top_h = max(1, int(h * options.image_crop_fraction[0]))
    bottom_h = max(1, int(h * options.image_crop_fraction[1]))
    crops.append({'image': arr[:top_h], 'location': 'top'})
    crops.append({'image': arr[h - bottom_h:], 'location': 'bottom'})
    return crops


def crop_to_solid_region(rough_crop, options=None):
    """
    Tighten a rough crop to its solid-background (info bar) rows.
    Returns (cropped array, (row_start, row_end)) or (None, None) when
    no solid region is found (reference: ocr_tools.py:171).
    """

    if options is None:
        options = DatetimeExtractionOptions()
    arr = rough_crop['image'] if isinstance(rough_crop, dict) \
        else rough_crop
    if arr.ndim == 3:
        gray = arr.mean(axis=2)
    else:
        gray = arr.astype(np.float64)

    solid_rows = []
    for i in range(gray.shape[0]):
        row = gray[i]
        median = np.median(row)
        uniform = np.abs(row - median) < options.uniformity_delta
        if uniform.mean() >= options.row_uniformity_threshold:
            solid_rows.append(i)

    if not solid_rows:
        return None, None
    start, end = solid_rows[0], solid_rows[-1] + 1
    start = max(0, start - options.crop_padding)
    end = min(gray.shape[0], end + options.crop_padding)
    return arr[start:end], (start, end)


_DATETIME_PATTERNS = [
    # 2023-04-01 12:34:56 / 2023/04/01 12:34
    (re.compile(r'(\d{4})[-/.](\d{1,2})[-/.](\d{1,2})\D{0,3}'
                r'(\d{1,2}):(\d{2})(?::(\d{2}))?'), 'ymd'),
    # 04/01/2023 12:34:56
    (re.compile(r'(\d{1,2})[-/.](\d{1,2})[-/.](\d{4})\D{0,3}'
                r'(\d{1,2}):(\d{2})(?::(\d{2}))?'), 'mdy'),
]


def datetime_string_to_datetime(s):
    """Parse a datetime out of arbitrary OCR text; None on failure."""

    s = str(s)
    for pattern, order in _DATETIME_PATTERNS:
        m = pattern.search(s)
        if not m:
            continue
        g = m.groups()
        try:
            if order == 'ymd':
                year, month, day = int(g[0]), int(g[1]), int(g[2])
            else:
                month, day, year = int(g[0]), int(g[1]), int(g[2])
            hour, minute = int(g[3]), int(g[4])
            second = int(g[5]) if g[5] else 0
            return datetime.datetime(year, month, day, hour, minute,
                                     second)
        except ValueError:
            continue
    return None


def _default_ocr_fn():
    try:
        import pytesseract
        from PIL import Image

        def ocr(arr):
            return pytesseract.image_to_string(Image.fromarray(arr))
        return ocr
    except ImportError:
        return None


def find_text_in_crops(rough_crops, options=None,
                       tesseract_config_string=None, ocr_fn=None):
    """
    OCR every rough crop (the top/bottom info-bar strips); returns
    {'top': {'text', 'crop_to_solid_region_results'}, 'bottom': ...}
    (reference: ocr_tools.py:295-358). [rough_crops] is either the
    reference's {'top': image, 'bottom': image} dict or the list of
    {'image', 'location'} dicts from make_rough_crops.
    [tesseract_config_string] is passed to pytesseract when the default
    engine is in use; [ocr_fn] overrides the OCR engine entirely.
    """

    if options is None:
        options = DatetimeExtractionOptions()

    if ocr_fn is None:
        if tesseract_config_string is not None:
            try:
                import pytesseract
                from PIL import Image

                def ocr_fn(arr):
                    return pytesseract.image_to_string(
                        Image.fromarray(arr),
                        config=tesseract_config_string)
            except ImportError:
                ocr_fn = None
        else:
            ocr_fn = _default_ocr_fn()
    if ocr_fn is None:
        raise RuntimeError(
            'No OCR engine: install pytesseract or pass ocr_fn')

    if isinstance(rough_crops, dict):
        location_to_crop = rough_crops
    else:
        location_to_crop = {r['location']: r['image']
                            for r in rough_crops}

    results = {}
    for crop_location in ('top', 'bottom'):
        results[crop_location] = {
            'text': '',
            'crop_to_solid_region_results': None,
        }
        rough_crop = location_to_crop.get(crop_location)
        if rough_crop is None:
            continue
        solid, region = crop_to_solid_region(
            np.asarray(rough_crop), options)
        results[crop_location]['crop_to_solid_region_results'] = region
        if solid is None:
            continue
        results[crop_location]['text'] = ocr_fn(solid).strip()
    return results


def get_datetime_from_image(image, options=None, ocr_fn=None):
    """
    Full pipeline for one image: rough crops -> solid-region crops ->
    OCR -> datetime parse. [ocr_fn] maps an HWC uint8 array to text;
    without one (and without pytesseract installed) raises RuntimeError.

    Returns (datetime or None, {'location': ..., 'text': ...}).
    """

    if options is None:
        options = DatetimeExtractionOptions()
    if ocr_fn is None:
        ocr_fn = _default_ocr_fn()
    if ocr_fn is None:
        raise RuntimeError(
            'No OCR engine: install pytesseract or pass ocr_fn')

    for rough in make_rough_crops(image, options):
        solid, _ = crop_to_solid_region(rough, options)
        if solid is None:
            continue
        text = ocr_fn(solid)
        dt = datetime_string_to_datetime(text)
        if dt is not None:
            return dt, {'location': rough['location'], 'text': text}
    return None, {}


def try_get_datetime_from_image(image, options=None, ocr_fn=None):
    """
    Try/catch wrapper over get_datetime_from_image that accepts one
    DatetimeExtractionOptions or a list to try in order until a
    datetime is found (reference: ocr_tools.py:539-585). Returns
    {'datetime': datetime-or-None, 'text': str, 'options_index': int,
    'error': str-or-None}.
    """

    if options is None:
        options = DatetimeExtractionOptions()
    if not isinstance(options, (list, tuple)):
        options = [options]

    result = {'datetime': None, 'text': '', 'options_index': None,
              'error': None}
    for i_option_set, current_options in enumerate(options):
        try:
            dt, info = get_datetime_from_image(
                image, options=current_options, ocr_fn=ocr_fn)
            result['datetime'] = dt
            result['text'] = info.get('text', '')
            result['options_index'] = i_option_set
            if dt is not None:
                break
        except Exception as e:
            result['error'] = str(e)
    return result


def get_datetimes_for_folder(folder, output_file=None, options=None,
                             ocr_fn=None, recursive=True):
    """{relative filename: ISO datetime or None} for every image in a
    folder (reference: ocr_tools.py driver)."""

    from PIL import Image
    from megadetector_tpu_torch.utils.path_utils import find_images
    from megadetector_tpu_torch.utils import ct_utils

    results = {}
    for fn in find_images(folder, recursive=recursive,
                          return_relative_paths=True):
        try:
            import os
            with Image.open(os.path.join(folder, fn)) as im:
                arr = np.asarray(im.convert('RGB'))
            dt, _ = get_datetime_from_image(arr, options, ocr_fn)
            results[fn] = dt.isoformat() if dt else None
        except Exception:
            results[fn] = None
    if output_file is not None:
        ct_utils.write_json(output_file, results, force_str=True)
    return results
