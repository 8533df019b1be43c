"""
Aggregate classifier probability columns into target groups.

Reference contract (megadetector/classification/
aggregate_classifier_probs.py:37-79): given a classifier results CSV
(path + one probability column per classifier label) and a target
mapping JSON {target_name: [classifier labels]}, write a CSV whose
columns are the targets (each the SUM of its member labels'
probabilities) plus a {index: target} label-index JSON. Targets must
partition the classifier labels (disjoint; every probability column
covered). Processes the CSV streaming, row by row, since results files
can be large.

The port's own copy of
megadetector_tpu/classification/aggregate_classifier_probs.py: the same
public names, signatures, defaults and output bytes.
"""

import argparse
import csv
import json
import sys


def aggregate_classifier_probs(classifier_results_csv_path,
                               target_mapping_json_path,
                               output_csv_path,
                               output_label_index_json_path=None):
    """Returns the sorted target names."""

    with open(target_mapping_json_path) as f:
        target_mapping = json.load(f)
    target_names = sorted(target_mapping.keys())

    all_labels = set()
    for target, labels in target_mapping.items():
        overlap = all_labels & set(labels)
        assert not overlap, \
            'labels {} appear in more than one target'.format(
                sorted(overlap))
        all_labels.update(labels)

    with open(classifier_results_csv_path, newline='') as f_in, \
            open(output_csv_path, 'w', newline='') as f_out:
        reader = csv.DictReader(f_in)
        prob_cols = [c for c in reader.fieldnames if c != 'path']
        assert set(prob_cols) == all_labels, \
            'CSV columns {} do not match the mapped labels {}'.format(
                sorted(prob_cols), sorted(all_labels))
        writer = csv.writer(f_out)
        writer.writerow(['path'] + target_names)
        for row in reader:
            out = [row['path']]
            for target in target_names:
                out.append('{:.6f}'.format(
                    sum(float(row[lbl])
                        for lbl in target_mapping[target])))
            writer.writerow(out)

    if output_label_index_json_path is not None:
        with open(output_label_index_json_path, 'w') as f:
            json.dump({str(i): t for i, t in enumerate(target_names)},
                      f, indent=1)
    return target_names


def main():
    parser = argparse.ArgumentParser(
        description='Aggregate classifier probabilities into target '
                    'groups')
    parser.add_argument('classifier_results_csv')
    parser.add_argument('target_mapping_json')
    parser.add_argument('output_csv')
    parser.add_argument('--output_label_index', default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    aggregate_classifier_probs(
        args.classifier_results_csv, args.target_mapping_json,
        args.output_csv, args.output_label_index)


if __name__ == '__main__':
    main()
