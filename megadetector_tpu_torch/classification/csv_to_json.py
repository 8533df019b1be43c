"""
Convert a label-specification CSV to the label-spec JSON consumed by
json_validator (reference: megadetector/classification/csv_to_json.py).

CSV columns are output_label,type,content, where type is 'row'
(<dataset>|<dataset_label>), 'datasettaxon'
(<dataset>|<taxon_level>|<taxon_name>), 'max_count', 'prioritize'
(a Python-literal list of dataset tiers), or any taxon level name
(content is the taxon name). A leading '!' on output_label routes the
row into that label's 'exclude' spec.

The port's own copy of megadetector_tpu/classification/csv_to_json.py: the
same public names, signatures, defaults and output bytes.
"""

import argparse
import ast
import csv
import json
import sys

from collections import defaultdict


def parse_csv_row(obj, rowtype, content):
    """
    Fold one CSV row into the spec dict [obj], in place (reference:
    csv_to_json.py:125-165). 'prioritize' content is parsed with
    ast.literal_eval (the reference uses eval; literal lists are all
    the format allows anyway).
    """

    if rowtype == 'row':
        if 'dataset_labels' not in obj:
            obj['dataset_labels'] = defaultdict(list)
        assert '|' in content
        ds, ds_label = content.split('|')
        obj['dataset_labels'][ds].append(ds_label)

    elif rowtype == 'datasettaxon':
        if 'taxa' not in obj:
            obj['taxa'] = []
        assert '|' in content
        ds, taxon_level, taxon_name = content.split('|')
        obj['taxa'].append({'level': taxon_level, 'name': taxon_name,
                            'datasets': [ds]})

    elif rowtype == 'max_count':
        obj['max_count'] = int(content)

    elif rowtype == 'prioritize':
        obj['prioritize'] = ast.literal_eval(content)

    else:
        if 'taxa' not in obj:
            obj['taxa'] = []
        obj['taxa'].append({'level': rowtype, 'name': content})


def csv_to_jsondict(csv_path):
    """
    Parse the label-spec CSV into {output_label: spec dict}; '#'
    comment lines and blank lines are skipped (reference:
    csv_to_json.py:168-189).
    """

    js = defaultdict(dict)
    with open(csv_path, newline='') as f:
        rows = [r for r in csv.reader(f)
                if r and not r[0].lstrip().startswith('#')]
    header = rows[0]
    assert header == ['output_label', 'type', 'content'], \
        'Unexpected label-spec CSV columns: {}'.format(header)

    for row in rows[1:]:
        label, rowtype, content = row[0], row[1], row[2]
        if label.startswith('!'):
            label = label[1:]
            if 'exclude' not in js[label]:
                js[label]['exclude'] = {}
            obj = js[label]['exclude']
        else:
            obj = js[label]
        parse_csv_row(obj, rowtype, content)

    return dict(js)


def order_spec_dict(spec_dict):
    """
    Return [spec_dict] with keys in the canonical order (reference:
    csv_to_json.py:192-203).
    """

    if 'exclude' in spec_dict:
        spec_dict['exclude'] = order_spec_dict(spec_dict['exclude'])
    ordered = {}
    for key in ['dataset_labels', 'taxa', 'exclude', 'max_count',
                'prioritize']:
        if key in spec_dict:
            ordered[key] = spec_dict[key]
    return ordered


def main():
    parser = argparse.ArgumentParser(
        description='Convert a label-specification CSV to JSON')
    parser.add_argument('input_csv_file')
    parser.add_argument('output_json_path')
    parser.add_argument('--json-indent', type=int, default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    js = csv_to_jsondict(args.input_csv_file)
    js = {label: order_spec_dict(spec) for label, spec in js.items()}
    with open(args.output_json_path, 'w') as f:
        json.dump(js, f, indent=args.json_indent)


if __name__ == '__main__':
    main()
