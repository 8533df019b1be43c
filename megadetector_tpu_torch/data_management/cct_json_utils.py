"""
COCO Camera Traps (CCT) utilities: indexed access to CCT .json databases,
datetime parsing, and time-based sequence (burst/episode) assembly.

Behavioral contract follows the reference
(megadetector/data_management/cct_json_utils.py): IndexedJsonDb (:155)
with filename/id/annotation indices, create_sequences (:421) grouping
images at one location into sequences when consecutive timestamps are
within episode_interval_seconds (default 60), populating 'seq_id'
('location_<loc>_sequence_index_<NNNNN>'), 'seq_num_frames', and
'frame_num'.

The port's own copy of megadetector_tpu/data_management/cct_json_utils.py:
the same public names, signatures, defaults and output bytes. No progress
bars: the card's machine is not promised tqdm.
"""

import datetime
import json
import os

from collections import defaultdict


#%% Indexed CCT database


class IndexedJsonDb:
    """
    Wrapper for a COCO Camera Traps database that indexes images by
    filename and ID, and annotations by image ID
    (reference: cct_json_utils.py:155-292).
    """

    def __init__(self, json_filename, b_normalize_paths=False,
                 filename_replacements=None, b_convert_classes_to_lower=True):

        if isinstance(json_filename, str):
            with open(json_filename) as f:
                self.db = json.load(f)
        else:
            self.db = json_filename

        assert 'images' in self.db, 'No images found in database'

        if b_normalize_paths:
            import os
            for im in self.db['images']:
                im['file_name'] = os.path.normpath(
                    im['file_name']).replace('\\', '/')

        if filename_replacements is not None:
            for s_old, s_new in filename_replacements.items():
                for im in self.db['images']:
                    im['file_name'] = im['file_name'].replace(s_old, s_new)

        if b_convert_classes_to_lower:
            for c in self.db.get('categories', []):
                c['name'] = c['name'].lower()

        self.filename_to_id = {im['file_name']: im['id']
                               for im in self.db['images']}
        self.image_id_to_image = {im['id']: im
                                  for im in self.db['images']}
        self.cat_id_to_name = {c['id']: c['name']
                               for c in self.db.get('categories', [])}
        self.cat_name_to_id = {c['name']: c['id']
                               for c in self.db.get('categories', [])}

        self.image_id_to_annotations = defaultdict(list)
        for ann in self.db.get('annotations', []):
            self.image_id_to_annotations[ann['image_id']].append(ann)

    def get_annotations_for_image(self, image):
        """Annotations for an image dict; [] when none."""

        return self.image_id_to_annotations.get(image['id'], [])

    def get_classes_for_image(self, image):
        """Sorted unique class names for an image dict."""

        anns = self.get_annotations_for_image(image)
        class_names = set()
        for ann in anns:
            class_names.add(self.cat_id_to_name.get(
                ann['category_id'], str(ann['category_id'])))
        return sorted(class_names)


class CameraTrapJsonUtils:
    """Static helpers over CCT databases."""

    @staticmethod
    def annotations_to_class_names(annotations, cat_id_to_name):
        """Sorted unique class names for a list of annotations."""

        return sorted(set(cat_id_to_name[ann['category_id']]
                          for ann in annotations))

    @staticmethod
    def annotations_to_string(annotations, cat_id_to_name):
        """Comma-delimited sorted class names."""

        return ','.join(CameraTrapJsonUtils.annotations_to_class_names(
            annotations, cat_id_to_name))

    @staticmethod
    def order_db_keys(db):
        """Return the db as an OrderedDict in canonical key order."""

        from collections import OrderedDict
        ordered = OrderedDict()
        for k in ('info', 'categories', 'annotations', 'images'):
            if k in db:
                ordered[k] = db[k]
        for k in db:
            if k not in ordered:
                ordered[k] = db[k]
        return ordered

    @staticmethod
    def group_annotations_by_image_field(db_indexed, image_field='seq_id'):
        """Map image_field values to lists of annotations."""

        image_id_to_field = {
            im['id']: im.get(image_field)
            for im in db_indexed.db['images']}
        out = defaultdict(list)
        for ann in db_indexed.db.get('annotations', []):
            out[image_id_to_field.get(ann['image_id'])].append(ann)
        return out

    @staticmethod
    def get_entries_for_locations(db, locations):
        """Subset a CCT db to a set of locations."""

        locations = set(locations)
        images = [im for im in db['images']
                  if im.get('location') in locations]
        image_ids = set(im['id'] for im in images)
        annotations = [ann for ann in db.get('annotations', [])
                       if ann['image_id'] in image_ids]
        out = dict(db)
        out['images'] = images
        out['annotations'] = annotations
        return out


#%% Datetime parsing


# Common camera-trap EXIF datetime formats
_DATETIME_FORMATS = [
    '%Y-%m-%d %H:%M:%S',
    '%Y:%m:%d %H:%M:%S',
    '%Y-%m-%dT%H:%M:%S',
    '%m/%d/%Y %H:%M:%S',
    '%m/%d/%Y %I:%M:%S %p',
    '%d/%m/%Y %H:%M',
    '%Y-%m-%d',
]


def parse_datetime_string(s):
    """Parse a datetime string in any supported format; None on failure."""

    if isinstance(s, datetime.datetime):
        return s
    if s is None:
        return None
    s = str(s).strip()
    for fmt in _DATETIME_FORMATS:
        try:
            return datetime.datetime.strptime(s, fmt)
        except ValueError:
            continue
    try:
        return datetime.datetime.fromisoformat(s)
    except ValueError:
        return None


def parse_datetimes_from_cct_image_list(
        images, conversion_failure_behavior='none', verbose=False):
    """
    Convert each image's 'datetime' field (string) to a
    datetime.datetime, in place. Failures become None (default) or raise.
    """

    n_failures = 0
    for im in images:
        dt = im.get('datetime')
        parsed = parse_datetime_string(dt)
        if parsed is None and dt is not None:
            n_failures += 1
            if conversion_failure_behavior == 'error':
                raise ValueError(
                    'Cannot parse datetime {}'.format(dt))
            if verbose:
                print('Cannot parse datetime {}'.format(dt))
            # 'str' leaves the unparseable value in place; 'none'
            # (default) nulls it
            if conversion_failure_behavior == 'str':
                continue
        im['datetime'] = parsed
    return images


def parse_datetimes_from_cct_dict(d, conversion_failure_behavior='error'):
    """
    Convert all string-formatted datetime fields of a CCT dict (or a
    CCT .json filename) to Python datetimes, in place (reference:
    cct_json_utils.py:389-416). [conversion_failure_behavior] is
    'error' (raise), 'str' (leave as a string), or 'none' (convert to
    None). Returns the CCT dict.
    """

    import json as _json
    if isinstance(d, str):
        assert os.path.isfile(d), \
            'Could not find .json file {}'.format(d)
        with open(d, 'r') as f:
            d = _json.load(f)

    parse_datetimes_from_cct_image_list(
        d['images'],
        conversion_failure_behavior=conversion_failure_behavior)
    return d


def write_object_with_serialized_datetimes(d, json_fn):
    """Write a dict to .json, serializing datetimes to ISO strings."""

    from megadetector_tpu_torch.utils.ct_utils import write_json
    write_json(json_fn, d, serialize_datetimes=True, force_str=True)


#%% Sequence assembly


class SequenceOptions:
    """Options for create_sequences()."""

    def __init__(self):
        # Images within this many seconds of the previous image (at the
        # same location) join its sequence
        self.episode_interval_seconds = 60.0
        self.datetime_conversion_failure_behavior = 'none'
        self.verbose = False


def create_sequences(image_info, options=None):
    """
    Group images into time-based sequences per location, populating
    'seq_id', 'seq_num_frames', and 'frame_num' in place
    (reference: cct_json_utils.py:421-566).

    [image_info] may be a CCT dict, a CCT .json filename, or a list of
    image dicts with 'file_name', 'datetime', 'location'.
    """

    if options is None:
        options = SequenceOptions()

    if isinstance(image_info, list):
        to_return = image_info
        images = image_info
    elif isinstance(image_info, str):
        with open(image_info) as f:
            to_return = json.load(f)
        images = to_return['images']
    elif isinstance(image_info, dict):
        to_return = image_info
        images = image_info['images']
    else:
        raise ValueError('Unrecognized type for image_info')

    parse_datetimes_from_cct_image_list(
        images,
        conversion_failure_behavior=
        options.datetime_conversion_failure_behavior,
        verbose=options.verbose)

    locations = sorted(set(im.get('location') for im in images),
                       key=lambda x: (x is None, x))

    all_sequences = set()

    for location in locations:

        images_this_location = [im for im in images
                                if im.get('location') == location]
        # None datetimes sort to the end
        images_sorted = sorted(
            images_this_location,
            key=lambda im: (im['datetime'] is None, im['datetime']))

        sequence_to_images = defaultdict(list)
        current_sequence_id = None
        next_frame_number = 0
        next_sequence_number = 0
        previous_datetime = None

        for im in images_sorted:
            invalid_datetime = im['datetime'] is None
            if previous_datetime is None or invalid_datetime:
                delta = None
            else:
                delta = (im['datetime'] -
                         previous_datetime).total_seconds()

            if delta is None or invalid_datetime or \
                    delta > options.episode_interval_seconds:
                next_frame_number = 0
                current_sequence_id = \
                    'location_{}_sequence_index_{}'.format(
                        location, str(next_sequence_number).zfill(5))
                next_sequence_number += 1
                assert current_sequence_id not in all_sequences
                all_sequences.add(current_sequence_id)

            im['seq_id'] = current_sequence_id
            im['seq_num_frames'] = None
            im['frame_num'] = next_frame_number
            sequence_to_images[current_sequence_id].append(im)
            next_frame_number += 1
            if not invalid_datetime:
                previous_datetime = im['datetime']

        for seq_id, seq_images in sequence_to_images.items():
            for im in seq_images:
                im['seq_num_frames'] = len(seq_images)

    return to_return
