"""
EXIF reading for the batch driver: the port's own copy of
ReadExifOptions, _clean_value and read_pil_exif from
megadetector_tpu/data_management/read_exif.py. read_pil_exif returns a
flat {tag name: value} dict with GPSInfo expanded into named GPS tags.
PIL is imported only when a file or image is read.
"""


class ReadExifOptions:
    """Options of read_pil_exif (and of the JAX package's folder reader,
    whose fields this keeps)."""

    def __init__(self):
        self.verbose = False
        self.n_workers = 8
        self.tags_to_include = None
        self.tags_to_exclude = None
        self.byte_handling = 'convert_to_string'  # 'delete', 'raw'
        self.processing_library = 'pil'


def _clean_value(v, byte_handling='convert_to_string'):
    if isinstance(v, bytes):
        if byte_handling == 'delete':
            return None
        if byte_handling == 'convert_to_string':
            try:
                return v.decode('utf-8', errors='replace')
            except Exception:
                return str(v)
        return v
    # IFDRational and similar: coerce to float
    if hasattr(v, 'numerator') and hasattr(v, 'denominator'):
        try:
            return float(v)
        except (ZeroDivisionError, ValueError):
            return None
    if isinstance(v, tuple):
        return tuple(_clean_value(x, byte_handling) for x in v)
    return v


def read_pil_exif(im, options=None):
    """
    Read EXIF tags from a PIL image (or filename) into a flat dict keyed
    by tag name, with GPSInfo expanded into named GPS tags; {} when the
    image has none.
    """

    from PIL import Image
    from PIL.ExifTags import GPSTAGS, TAGS

    if options is None:
        options = ReadExifOptions()

    opened_here = False
    if isinstance(im, str):
        im = Image.open(im)
        opened_here = True

    try:
        exif = im._getexif()
    except Exception:
        exif = None
    if exif is None:
        try:
            exif = dict(im.getexif())
        except Exception:
            exif = None
    if opened_here:
        im.close()
    if not exif:
        return {}

    tags = {}
    for tag_id, value in exif.items():
        name = TAGS.get(tag_id, str(tag_id))
        if name == 'GPSInfo' and isinstance(value, dict):
            for gps_id, gps_value in value.items():
                gps_name = GPSTAGS.get(gps_id, 'GPS_{}'.format(gps_id))
                tags[gps_name] = _clean_value(gps_value,
                                              options.byte_handling)
            continue
        cleaned = _clean_value(value, options.byte_handling)
        if cleaned is None and value is not None:
            continue
        tags[name] = cleaned

    if options.tags_to_include is not None:
        tags = {k: v for k, v in tags.items()
                if k in options.tags_to_include}
    if options.tags_to_exclude is not None:
        tags = {k: v for k, v in tags.items()
                if k not in options.tags_to_exclude}

    return tags
