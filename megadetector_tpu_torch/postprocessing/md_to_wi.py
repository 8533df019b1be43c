"""
Convert MD results to the Wildlife Insights (WI) prediction format.

Behavioral contract follows the reference
(megadetector/postprocessing/md_to_wi.py:19): one WI prediction record
per image with the top detection/classification mapped onto the WI
7-field taxonomy string, blank predictions for empty images.

The port's own copy of megadetector_tpu/postprocessing/md_to_wi.py: the
same public names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from megadetector_tpu_torch.utils import ct_utils

BLANK_PREDICTION = \
    'f1856211-cfb7-4a5b-9158-c0f72fd09ee6;;;;;;blank'
ANIMAL_PREDICTION = \
    '1f689929-883d-4dae-958c-3d57ab5b6c16;;;;;;animal'
HUMAN_PREDICTION = \
    '990ae9dd-7a59-4344-afcb-1b7b21368000;mammalia;primates;hominidae;' \
    'homo;sapiens;human'
VEHICLE_PREDICTION = \
    'e2895ed5-780b-48f6-8a11-9e27cb594511;;;;;;vehicle'

MD_CATEGORY_TO_WI_PREDICTION = {
    'animal': ANIMAL_PREDICTION,
    'person': HUMAN_PREDICTION,
    'vehicle': VEHICLE_PREDICTION,
}


def md_to_wi(input_file, output_file=None, detection_threshold=0.2,
             classification_threshold=0.5,
             classification_name_to_wi_taxonomy=None):
    """
    Convert an MD results file to a WI predictions dict
    ({'predictions': [...]}), each record with filepath, the WI taxonomy
    prediction string, and per-detection records. Writes [output_file]
    when given.
    """

    with open(input_file) as f:
        data = json.load(f)

    detection_categories = data.get('detection_categories', {})
    classification_categories = data.get('classification_categories', {})
    if classification_name_to_wi_taxonomy is None:
        classification_name_to_wi_taxonomy = {}

    predictions = []

    for im in data['images']:

        record = {'filepath': im['file']}
        detections = im.get('detections')

        if detections is None:
            record['failures'] = [im.get('failure', 'failure')]
            record['prediction'] = BLANK_PREDICTION
            record['prediction_score'] = 0.0
            predictions.append(record)
            continue

        above = [d for d in detections
                 if d['conf'] >= detection_threshold]
        record['detections'] = [{
            'category': d['category'],
            'label': detection_categories.get(d['category'],
                                              d['category']),
            'conf': d['conf'],
            'bbox': d['bbox'],
        } for d in detections]

        if len(above) == 0:
            record['prediction'] = BLANK_PREDICTION
            record['prediction_score'] = round(
                1.0 - ct_utils.get_max_conf(im), 4)
            predictions.append(record)
            continue

        top = max(above, key=lambda d: d['conf'])
        category_name = detection_categories.get(top['category'],
                                                 top['category'])

        # Prefer a confident species classification on the top detection
        prediction = None
        score = top['conf']
        for c in top.get('classifications') or []:
            if c[1] >= classification_threshold:
                class_name = classification_categories.get(c[0], c[0])
                taxonomy = classification_name_to_wi_taxonomy.get(
                    class_name)
                if taxonomy is not None:
                    prediction = taxonomy
                    score = c[1]
                break

        if prediction is None:
            prediction = MD_CATEGORY_TO_WI_PREDICTION.get(
                category_name, ANIMAL_PREDICTION)

        record['prediction'] = prediction
        record['prediction_score'] = score
        predictions.append(record)

    out = {'predictions': predictions}
    if output_file is not None:
        ct_utils.write_json(output_file, out, force_str=True)
    return out


def main():
    parser = argparse.ArgumentParser(
        description='Convert MD results to WI prediction format')
    parser.add_argument('input_file')
    parser.add_argument('output_file')
    parser.add_argument('--detection_threshold', type=float, default=0.2)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    md_to_wi(args.input_file, args.output_file,
             detection_threshold=args.detection_threshold)


if __name__ == '__main__':
    main()
