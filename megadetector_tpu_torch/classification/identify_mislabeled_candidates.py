"""
Identify images that may carry a wrong ground-truth label.

Reference contract (megadetector/classification/
identify_mislabeled_candidates.py:1-40): a "mislabeled candidate" is an
evaluation row where the model's prediction disagrees with the label
AND the predicted-class confidence exceeds the labeled-class confidence
by at least [margin]. Reads evaluate_model's outputs_{split}.csv and
writes one text file of candidate crop paths per (split, dataset):

    <logdir>/mislabeled_candidates_{split}_{dataset}.txt

(the reference then feeds these lists to AzCopy; locally they feed any
review tool). The dataset is the first path component of each crop.

The port's own copy of
megadetector_tpu/classification/identify_mislabeled_candidates.py: the same
public names, signatures, defaults and output bytes.
"""

import argparse
import csv
import os
import sys

from collections import defaultdict


def get_candidates_df(outputs_csv_path, label_names, margin):
    """
    DataFrame of crops whose predicted-label confidence beats the
    ground-truth label's confidence by at least [margin] — the
    mislabeled candidates (reference:
    identify_mislabeled_candidates.py:109-123). Adds 'pred',
    'pred_conf', and 'label_conf' columns.
    """

    import numpy as np
    import pandas as pd

    df = pd.read_csv(outputs_csv_path, float_precision='high')
    probs = df[list(label_names)].to_numpy()
    pred_idx = probs.argmax(axis=1)
    df['pred'] = [label_names[i] for i in pred_idx]
    df['pred_conf'] = probs[np.arange(len(df)), pred_idx]
    label_idx = [list(label_names).index(lb) for lb in df['label']]
    df['label_conf'] = probs[np.arange(len(df)), label_idx]
    return df[df['pred_conf'] >= df['label_conf'] + margin].copy()


def identify_mislabeled_candidates(outputs_csv_path, split, logdir,
                                   margin=0.5,
                                   include_dataset_in_filename=False):
    """
    Returns {dataset: [candidate paths]}; writes the per-dataset text
    files to [logdir].
    """

    candidates = defaultdict(list)
    with open(outputs_csv_path, newline='') as f:
        reader = csv.DictReader(f)
        label_cols = [c for c in reader.fieldnames
                      if c not in ('path', 'label', 'weight')]
        for row in reader:
            label = row['label']
            if label not in label_cols:
                continue
            probs = {c: float(row[c]) for c in label_cols}
            pred = max(probs, key=probs.get)
            if pred == label:
                continue
            if probs[pred] - probs[label] < margin:
                continue
            path = row['path']
            dataset = path.split('/', 1)[0] if '/' in path else ''
            candidates[dataset].append(
                path if include_dataset_in_filename
                else path.split('/', 1)[-1])

    os.makedirs(logdir, exist_ok=True)
    for dataset, paths in candidates.items():
        out = os.path.join(
            logdir, 'mislabeled_candidates_{}_{}.txt'.format(
                split, dataset or 'unknown'))
        with open(out, 'w') as f:
            for p in sorted(paths):
                f.write(p + '\n')
    total = sum(len(v) for v in candidates.values())
    print('Found {} mislabeled candidates across {} datasets'.format(
        total, len(candidates)))
    return dict(candidates)


def main():
    parser = argparse.ArgumentParser(
        description='Find evaluation rows whose confident prediction '
                    'disagrees with the label')
    parser.add_argument('outputs_csv')
    parser.add_argument('--split', default='val')
    parser.add_argument('--logdir', required=True)
    parser.add_argument('--margin', type=float, default=0.5)
    parser.add_argument('--include_dataset_in_filename',
                        action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    identify_mislabeled_candidates(
        args.outputs_csv, args.split, args.logdir, margin=args.margin,
        include_dataset_in_filename=args.include_dataset_in_filename)


if __name__ == '__main__':
    main()
