"""
EXIF reading: per-image tag extraction (PIL-based), GPS coordinate
parsing, and parallel folder-level EXIF harvesting.

Behavioral contract follows the reference
(megadetector/data_management/read_exif.py:338,562,880): read_pil_exif
returns a flat {tag name: value} dict including parsed GPSInfo;
read_exif_from_folder walks a folder in a thread pool and writes a list
of {'file_name', 'exif_tags'} records.

The port's own copy of megadetector_tpu/data_management/read_exif.py: the
same public names, signatures, defaults and output bytes. No progress
bars: the card's machine is not promised tqdm.
"""

import json
import os

from concurrent.futures import ThreadPoolExecutor

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils import path_utils


class ReadExifOptions:
    """Options controlling read_exif_from_folder()."""

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
    by tag name, with GPSInfo expanded into named GPS tags
    (reference: read_exif.py:338).
    """

    from PIL import Image
    from PIL.ExifTags import TAGS, GPSTAGS

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


def exif_gps_to_decimal_degrees(tags):
    """
    Convert GPSLatitude/GPSLongitude (+Ref) tags into signed decimal
    degrees; returns (lat, lon) or None.
    """

    def _dms_to_decimal(dms, ref):
        try:
            d, m, s = [float(x) for x in dms]
        except (TypeError, ValueError):
            return None
        decimal = d + m / 60.0 + s / 3600.0
        if ref in ('S', 'W'):
            decimal = -decimal
        return decimal

    lat = tags.get('GPSLatitude')
    lon = tags.get('GPSLongitude')
    if lat is None or lon is None:
        return None
    lat_dd = _dms_to_decimal(lat, tags.get('GPSLatitudeRef', 'N'))
    lon_dd = _dms_to_decimal(lon, tags.get('GPSLongitudeRef', 'E'))
    if lat_dd is None or lon_dd is None:
        return None
    return lat_dd, lon_dd


def exiftool_available(exiftool_command='exiftool'):
    """True when the exiftool binary is on PATH."""

    import shutil as _shutil
    return _shutil.which(exiftool_command) is not None


def read_exif_with_exiftool(filenames, exiftool_command='exiftool',
                            options=None):
    """
    Batch-read EXIF via the exiftool binary (reference backend:
    read_exif.py:8-9,84 — exiftool surfaces GPS and maker-note tags PIL
    can't). One subprocess call handles the whole batch
    (`exiftool -json -n file...`). Returns a list of tag dicts aligned
    with [filenames] ({} for failures).
    """

    import subprocess

    assert exiftool_available(exiftool_command), \
        'exiftool is not installed or not on PATH'
    if isinstance(filenames, str):
        filenames = [filenames]

    proc = subprocess.run(
        [exiftool_command, '-json', '-n'] + list(filenames),
        capture_output=True, text=True)
    try:
        records = json.loads(proc.stdout) if proc.stdout.strip() else []
    except json.JSONDecodeError:
        records = []
    by_source = {rec.get('SourceFile'): rec for rec in records}

    out = []
    for fn in filenames:
        rec = dict(by_source.get(fn, {}))
        rec.pop('SourceFile', None)
        if options is not None:
            if options.tags_to_include is not None:
                rec = {k: v for k, v in rec.items()
                       if k in options.tags_to_include}
            if options.tags_to_exclude is not None:
                rec = {k: v for k, v in rec.items()
                       if k not in options.tags_to_exclude}
        out.append(rec)
    return out


def read_exif_from_image(filename, options=None):
    """EXIF tags for one image file; {} on failure."""

    if options is not None and \
            getattr(options, 'processing_library', 'pil') == 'exiftool':
        try:
            return read_exif_with_exiftool([filename],
                                           options=options)[0]
        except Exception:
            return {}
    try:
        return read_pil_exif(filename, options)
    except Exception:
        return {}


def read_exif_from_folder(input_folder, output_file=None, options=None,
                          filenames=None, recursive=True):
    """
    Harvest EXIF from every image in a folder (thread pool). Returns a
    list of {'file_name': relative path, 'exif_tags': dict}; writes
    [output_file] when given (reference: read_exif.py:880).
    """

    if options is None:
        options = ReadExifOptions()

    if filenames is None:
        filenames = path_utils.find_images(
            input_folder, recursive=recursive, return_relative_paths=True)

    # exiftool backend: one batched subprocess call for the whole
    # folder (the reference's parallel exiftool harvest collapses to a
    # single batch invocation)
    if getattr(options, 'processing_library', 'pil') == 'exiftool':
        abs_paths = [os.path.join(input_folder, fn) for fn in filenames]
        tag_dicts = read_exif_with_exiftool(abs_paths, options=options)
        results = [{'file_name': fn, 'exif_tags': tags}
                   for fn, tags in zip(filenames, tag_dicts)]
        if output_file is not None:
            ct_utils.write_json(output_file, results, force_str=True)
        return results

    def _one(fn):
        tags = read_exif_from_image(
            os.path.join(input_folder, fn), options)
        return {'file_name': fn, 'exif_tags': tags}

    if options.n_workers <= 1:
        results = [_one(fn) for fn in filenames]
    else:
        with ThreadPoolExecutor(max_workers=options.n_workers) as pool:
            results = list(pool.map(_one, filenames))

    if output_file is not None:
        ct_utils.write_json(output_file, results, force_str=True)
    return results


class ExifResultsToCCTOptions:
    """
    Options controlling exif_results_to_cct() (reference:
    read_exif.py:99-117).
    """

    def __init__(self):
        #: Timestamps older than this are assumed to be junk; lots of
        #: cameras use a default time in 2000
        self.min_valid_timestamp_year = 2001
        #: The EXIF tag from which to pull datetime information
        self.exif_datetime_tag = 'DateTimeOriginal'
        #: Maps an image filename to a location string; None writes
        #: every location as 'unknown'
        from megadetector_tpu_torch.utils.ct_utils import \
            image_file_to_camera_folder
        self.filename_to_location_function = image_file_to_camera_folder


def exif_results_to_cct(exif_results, cct_output_file=None,
                        options=None):
    """
    Convert EXIF harvest results (a list, or the .json filename written
    by read_exif_from_folder) to a CCT dict with no annotations,
    attaching image filenames to locations and datetimes
    (reference: read_exif.py:964-1060). Datetimes in the future, within
    the last 24 hours, or before options.min_valid_timestamp_year are
    treated as invalid (None).
    """

    import datetime as _datetime

    if options is None:
        options = ExifResultsToCCTOptions()

    if isinstance(exif_results, str):
        with open(exif_results, 'r') as f:
            exif_results = json.load(f)

    now = _datetime.datetime.now()

    images = []
    for r in exif_results:
        fn = r.get('file_name', r.get('file'))
        tags = r.get('exif_tags') or {}

        if options.filename_to_location_function is None:
            location = 'unknown'
        else:
            location = options.filename_to_location_function(fn)

        dt = tags.get(options.exif_datetime_tag)
        if dt is not None:
            parsed = parse_exif_datetime_string(str(dt))
            if parsed is None:
                dt = None
            elif (now - parsed).total_seconds() <= 24 * 60 * 60 or \
                    parsed.year < options.min_valid_timestamp_year:
                print('Warning: datetime for {} is {}'.format(fn,
                                                              parsed))
                dt = None
            else:
                dt = parsed

        im = {
            'id': fn,
            'file_name': fn,
            'datetime': dt,
            'location': location,
        }
        gps = exif_gps_to_decimal_degrees(tags)
        if gps is not None:
            im['latitude'], im['longitude'] = gps
        images.append(im)

    cct = {'images': images, 'annotations': [], 'categories': [],
           'info': {'description': 'EXIF-derived CCT metadata'}}
    if cct_output_file is not None:
        ct_utils.write_json(cct_output_file, cct, force_str=True)
    return cct


def main():
    """CLI: harvest EXIF for a folder into a .json file (reference:
    read_exif.py command-line driver)."""

    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description='Read EXIF data for every image in a folder')
    parser.add_argument('input_folder')
    parser.add_argument('output_file')
    parser.add_argument('--n_workers', type=int, default=1)
    parser.add_argument('--processing_library', default='pil',
                        choices=['pil', 'exiftool'])
    parser.add_argument('--no_recursive', action='store_true')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()

    options = ReadExifOptions()
    options.n_workers = args.n_workers
    options.processing_library = args.processing_library
    read_exif_from_folder(args.input_folder, args.output_file,
                          options=options,
                          recursive=not args.no_recursive)


if __name__ == '__main__':
    main()


#%% GPS / datetime convenience API (reference: read_exif.py:140-420)


def _is_null_gps_value(v):
    """True for None/zero GPS components (incl. zero IFDRationals);
    errs toward True on parse failures."""

    if v is None:
        return True
    try:
        if v == 0:
            return True
        from PIL import TiffImagePlugin
        if isinstance(v, TiffImagePlugin.IFDRational):
            return v.numerator == 0 or v.denominator == 0
        return False
    except Exception:
        return True


def _is_null_island(tags):
    """True when both GPSLatitude and GPSLongitude are all-zero
    triplets (0,0 off the coast of Africa = 'no real GPS data')."""

    for k in ('GPSLatitude', 'GPSLongitude'):
        v = tags.get(k)
        if not isinstance(v, (list, tuple)) or len(v) != 3:
            return False
        try:
            if not all(_is_null_gps_value(x) for x in v):
                return False
        except Exception:
            return False
    return True


def get_gps_info(im, verbose=False, check_for_null_island=True):
    """
    GPS tags for a filename, PIL image, EXIF-tag dict, or dict with an
    'exif_tags' field (reference: read_exif.py:194-260). Returns
    {'status': 'success'|'read_error'|'no_exif_info'|'no_gps_info'|
    'null_island', 'gps_info': dict or None}; values stay in raw EXIF
    form.
    """

    to_return = {'status': 'unknown', 'gps_info': None}

    if isinstance(im, dict):
        tags = im.get('exif_tags', im)
    else:
        try:
            tags = read_pil_exif(im)
        except Exception as e:
            if verbose:
                print('EXIF read error: {}'.format(e))
            to_return['status'] = 'read_error'
            to_return['error'] = str(e)
            return to_return

    if not tags:
        to_return['status'] = 'no_exif_info'
        return to_return
    if 'GPSLatitude' not in tags or 'GPSLongitude' not in tags:
        to_return['status'] = 'no_gps_info'
        return to_return
    if check_for_null_island and _is_null_island(tags):
        to_return['status'] = 'null_island'
        return to_return

    to_return['status'] = 'success'
    to_return['gps_info'] = {k: v for k, v in tags.items()
                             if k.startswith('GPS')}
    return to_return


def has_gps_info(im):
    """True/False for GPS presence; None when EXIF could not be read
    (reference: read_exif.py:312)."""

    result = get_gps_info(im)
    if result['status'] == 'read_error':
        return None
    return result['status'] == 'success'


def get_exif_lat_lon(gps, verbose=False):
    """
    EXIF GPS dict -> (lat, lon) in signed decimal degrees, or None for
    invalid/missing coordinates (reference: read_exif.py:274-309).
    """

    import math

    if 'GPSInfo' in gps and 'GPSLatitude' not in gps:
        gps = gps['GPSInfo']
    if 'GPSLatitudeRef' in gps and \
            gps.get('GPSLatitudeRef') not in ('N', 'S'):
        return None
    if 'GPSLongitudeRef' in gps and \
            gps.get('GPSLongitudeRef') not in ('E', 'W'):
        return None
    result = exif_gps_to_decimal_degrees(gps)
    if result is None:
        return None
    lat, lon = result
    if math.isnan(lat) or math.isnan(lon):
        return None
    if not (-90 <= lat <= 90 and -180 <= lon <= 180):
        if verbose:
            print('Warning: out-of-range lat/lon {},{}'.format(lat,
                                                               lon))
        return None
    return lat, lon


EXIF_DATETIME_FORMAT = '%Y:%m:%d %H:%M:%S'


def parse_exif_datetime_string(s, verbose=False):
    """'YYYY:MM:DD HH:MM:SS' -> datetime, or None on parse failure
    (reference: read_exif.py:~395)."""

    from datetime import datetime
    try:
        return datetime.strptime(str(s).strip(), EXIF_DATETIME_FORMAT)
    except Exception as e:
        if verbose:
            print('Could not parse EXIF datetime {}: {}'.format(s, e))
        return None


def format_datetime_as_exif_datetime_string(dt):
    """datetime -> 'YYYY:MM:DD HH:MM:SS' (reference: read_exif.py)."""

    return dt.strftime(EXIF_DATETIME_FORMAT)


def read_exif_tags_for_image(filename, options=None):
    """
    EXIF tags for one image via the configured backend ('pil' or
    'exiftool'); the single-image form of read_exif_from_folder
    (reference: read_exif.py:~560). Returns a {'file', 'exif_tags'}
    dict; 'error' replaces 'exif_tags' on failure.
    """

    if options is None:
        options = ReadExifOptions()
    result = {'file': filename}
    try:
        # read_exif_from_image maps *all* failures to {}, which would
        # mask the error contract here, so surface missing files first
        if not os.path.isfile(filename):
            raise FileNotFoundError(
                'Image file {} does not exist'.format(filename))
        result['exif_tags'] = read_exif_from_image(filename,
                                                   options=options)
    except Exception as e:
        result['error'] = str(e)
    return result
