"""
Record confirmed mislabeled images in a persistent ledger.

Reference role (megadetector/classification/save_mislabeled.py): after
a human reviews the identify_mislabeled_candidates lists, the confirmed
mislabelings are saved centrally (the reference posts to MegaDB). This
version appends to a local CSV ledger
(dataset, file, original_label, corrected_label, note, timestamp),
deduplicating on (dataset, file) — later corrections win — and can
filter a queried-images JSON against the ledger so known-bad images
drop out of future dataset builds.

The port's own copy of megadetector_tpu/classification/save_mislabeled.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import csv
import json
import os
import sys

from datetime import datetime

LEDGER_COLUMNS = ['dataset', 'file', 'original_label',
                  'corrected_label', 'note', 'timestamp']


def read_ledger(ledger_path):
    """Returns {(dataset, file): row dict}; empty when absent."""

    if not os.path.isfile(ledger_path):
        return {}
    with open(ledger_path, newline='') as f:
        return {(r['dataset'], r['file']): r
                for r in csv.DictReader(f)}


def save_mislabeled(ledger_path, entries):
    """
    Append [entries] (dicts with dataset/file and optionally
    original_label/corrected_label/note) to the ledger; duplicates on
    (dataset, file) are replaced. Returns the full ledger dict.
    """

    ledger = read_ledger(ledger_path)
    now = datetime.now().strftime('%Y-%m-%d %H:%M:%S')
    for e in entries:
        row = {c: '' for c in LEDGER_COLUMNS}
        row.update({k: v for k, v in e.items()
                    if k in LEDGER_COLUMNS})
        row['timestamp'] = now
        assert row['dataset'] or row['file'], \
            'entries need a dataset and/or file'
        ledger[(row['dataset'], row['file'])] = row

    os.makedirs(os.path.dirname(os.path.abspath(ledger_path)),
                exist_ok=True)
    with open(ledger_path, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=LEDGER_COLUMNS)
        writer.writeheader()
        for key in sorted(ledger):
            writer.writerow(ledger[key])
    print('Ledger now holds {} mislabeled images'.format(len(ledger)))
    return ledger


def update_mislabeled_images(container_path, input_csv_path):
    """
    Fold a Timelapse-review CSV (columns RelativePath, File,
    mislabeled (bool), correct_class) into per-dataset mislabeled
    ledgers <container_path>/megadb_mislabeled/<dataset>.csv with
    columns file,correct_class (reference:
    save_mislabeled.py:43-100; the reference writes to Azure — here
    [container_path] is a local folder). Existing entries for the same
    file are replaced.
    """

    import pathlib

    with open(input_csv_path, newline='') as f:
        rows = list(csv.DictReader(f))

    def to_bool(v):
        return str(v).strip().lower() in ('true', '1', 'yes')

    # Any row with a correct_class must be marked mislabeled
    for r in rows:
        if r.get('correct_class'):
            assert to_bool(r.get('mislabeled')), \
                'Row for {} has correct_class but is not marked ' \
                'mislabeled'.format(r.get('File'))

    rows = [r for r in rows if to_bool(r.get('mislabeled'))]

    by_dataset = {}
    for r in rows:
        rel = pathlib.PureWindowsPath(r['RelativePath']).as_posix()
        dataset, blob_dirname = rel.split('/', 1)
        file_name = blob_dirname + '/' + r['File']
        by_dataset.setdefault(dataset, {})[file_name] = \
            r.get('correct_class', '')

    out_dir = os.path.join(container_path, 'megadb_mislabeled')
    os.makedirs(out_dir, exist_ok=True)
    for ds, file_to_class in by_dataset.items():
        ledger_path = os.path.join(out_dir, '{}.csv'.format(ds))
        existing = {}
        if os.path.exists(ledger_path):
            with open(ledger_path, newline='') as f:
                existing = {r['file']: r.get('correct_class', '')
                            for r in csv.DictReader(f)}
        existing.update(file_to_class)
        with open(ledger_path, 'w', newline='') as f:
            writer = csv.DictWriter(f,
                                    fieldnames=['file',
                                                'correct_class'])
            writer.writeheader()
            for file_name in sorted(existing):
                writer.writerow({'file': file_name,
                                 'correct_class':
                                     existing[file_name]})
        print('{}: {} mislabeled images'.format(ds, len(existing)))


def filter_queried_images(queried_images_json, ledger_path,
                          output_json=None):
    """
    Drop ledger-listed images from a queried-images JSON (so confirmed
    mislabelings never re-enter a training set). Returns the filtered
    dict.
    """

    ledger = read_ledger(ledger_path)
    bad = {'{}/{}'.format(ds, fn) if ds and not fn.startswith(ds + '/')
           else fn
           for (ds, fn) in ledger.keys()}

    with open(queried_images_json) as f:
        queried = json.load(f)
    kept = {p: info for p, info in queried.items() if p not in bad}
    n_dropped = len(queried) - len(kept)
    print('Dropped {} mislabeled images ({} remain)'.format(
        n_dropped, len(kept)))
    if output_json is not None:
        with open(output_json, 'w') as f:
            json.dump(kept, f, indent=1)
    return kept


def main():
    parser = argparse.ArgumentParser(
        description='Record confirmed mislabeled images / filter them '
                    'out of a queried-images file')
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('add')
    p.add_argument('ledger_csv')
    p.add_argument('--dataset', required=True)
    p.add_argument('--file', required=True)
    p.add_argument('--original_label', default='')
    p.add_argument('--corrected_label', default='')
    p.add_argument('--note', default='')

    p = sub.add_parser('filter')
    p.add_argument('ledger_csv')
    p.add_argument('queried_images_json')
    p.add_argument('output_json')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    if args.command == 'add':
        save_mislabeled(args.ledger_csv, [{
            'dataset': args.dataset, 'file': args.file,
            'original_label': args.original_label,
            'corrected_label': args.corrected_label,
            'note': args.note}])
    else:
        filter_queried_images(args.queried_images_json,
                              args.ledger_csv, args.output_json)


if __name__ == '__main__':
    main()
