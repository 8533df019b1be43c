"""
Wildlife Insights (WI) interop: the 7-field taxonomy-string format used
by WI and SpeciesNet prediction files, plus prediction-file parsing and
conversion to/from MD results.

Behavioral contract follows the reference's WI utilities
(megadetector/utils/wi_taxonomy_utils.py, wi_platform_utils.py): taxonomy
strings are 'guid;class;order;family;genus;species;common_name';
recognized non-taxon predictions include blank / animal / human /
vehicle / no-cv-result. The reference's live platform-API client is
replaced by file-level interop (prediction files in, MD results out) —
appropriate for an air-gapped serving environment.

The port's own copy of megadetector_tpu/utils/wi_utils.py:
the same public names, signatures, defaults and output bytes.
"""

import json

from megadetector_tpu_torch.utils import ct_utils

TAXONOMY_STRING_FIELDS = ['guid', 'class', 'order', 'family', 'genus',
                          'species', 'common_name']

BLANK_GUID = 'f1856211-cfb7-4a5b-9158-c0f72fd09ee6'
ANIMAL_GUID = '1f689929-883d-4dae-958c-3d57ab5b6c16'
HUMAN_GUID = '990ae9dd-7a59-4344-afcb-1b7b21368000'
VEHICLE_GUID = 'e2895ed5-780b-48f6-8a11-9e27cb594511'
NO_CV_RESULT_GUID = 'f2efdae9-efb8-48fb-8a91-eccf79ab4ffb'


def parse_taxonomy_string(s):
    """'guid;class;...;common_name' -> dict of the 7 fields."""

    tokens = str(s).split(';')
    assert len(tokens) == 7, \
        'Invalid taxonomy string {} ({} fields)'.format(s, len(tokens))
    return dict(zip(TAXONOMY_STRING_FIELDS, tokens))


def build_taxonomy_string(guid='', class_name='', order='', family='',
                          genus='', species='', common_name=''):
    """Inverse of parse_taxonomy_string()."""

    return ';'.join([guid, class_name, order, family, genus, species,
                     common_name])


def taxonomy_string_to_binomial_name(s):
    """'...;genus;species;...' -> 'Genus species' (or '')."""

    fields = parse_taxonomy_string(s)
    if fields['genus'] and fields['species']:
        return '{} {}'.format(fields['genus'].capitalize(),
                              fields['species'])
    return ''


def taxonomy_string_to_common_name(s):
    return parse_taxonomy_string(s)['common_name']


def is_blank_prediction(s):
    return str(s).startswith(BLANK_GUID) or \
        taxonomy_string_to_common_name(s) in ('blank', 'no cv result')


def is_human_prediction(s):
    fields = parse_taxonomy_string(s)
    return str(s).startswith(HUMAN_GUID) or \
        fields['common_name'] in ('human', 'person') or \
        fields['species'] == 'sapiens'


def is_animal_prediction(s):
    if is_blank_prediction(s) or is_human_prediction(s):
        return False
    fields = parse_taxonomy_string(s)
    if str(s).startswith(VEHICLE_GUID) or \
            fields['common_name'] == 'vehicle':
        return False
    return True


def wi_predictions_to_md(predictions_file, output_file=None,
                         base_confidence=None):
    """
    Convert a WI/SpeciesNet predictions file ({'predictions': [...]})
    into MD results. Each prediction's detections carry over when
    present; otherwise the top prediction becomes a full-frame detection.
    """

    if isinstance(predictions_file, str):
        with open(predictions_file) as f:
            data = json.load(f)
    else:
        data = predictions_file

    name_to_category = {'animal': '1', 'person': '2', 'human': '2',
                        'vehicle': '3'}
    classification_names = {}

    images = []
    for p in data['predictions']:
        im = {'file': p.get('filepath') or p.get('filename')}
        if p.get('failures'):
            im['detections'] = None
            im['failure'] = ';'.join(str(f) for f in p['failures'])
            images.append(im)
            continue

        detections = []
        for d in p.get('detections') or []:
            label = d.get('label', 'animal')
            detections.append({
                'category': name_to_category.get(label, '1'),
                'conf': d['conf'],
                'bbox': d['bbox'],
            })

        prediction = p.get('prediction')
        score = p.get('prediction_score', base_confidence or 0.0)
        if prediction and not is_blank_prediction(prediction):
            common = taxonomy_string_to_common_name(prediction) or \
                taxonomy_string_to_binomial_name(prediction)
            if is_animal_prediction(prediction) and common:
                if common not in classification_names:
                    classification_names[common] = str(
                        len(classification_names))
                class_id = classification_names[common]
                if len(detections) == 0:
                    detections.append({'category': '1',
                                       'conf': score,
                                       'bbox': [0.0, 0.0, 1.0, 1.0]})
                top = max(detections, key=lambda d: d['conf'])
                top['classifications'] = [[class_id,
                                           round(float(score), 4)]]
        im['detections'] = detections
        images.append(im)

    out = {'images': images,
           'detection_categories': {'1': 'animal', '2': 'person',
                                    '3': 'vehicle'},
           'info': {'format_version': '1.6',
                    'detector': 'converted-from-wi-predictions'}}
    if classification_names:
        out['classification_categories'] = {
            v: k for k, v in classification_names.items()}

    if output_file is not None:
        ct_utils.write_json(output_file, out, force_str=True)
    return out
