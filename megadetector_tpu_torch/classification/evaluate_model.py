"""
Evaluate a trained species classifier over a classification dataset: the
port's counterpart of megadetector_tpu/classification/evaluate_model.py,
running the port's SpeciesClassifier (models/classifier.py) on the card
(device=None) or where [device] says. Outputs to [output_dir], byte for
byte the JAX module's for the same probabilities:

1) outputs_{split}.csv per split: path, label, weight, then one
   confidence column per label name
2) overall_metrics.csv: split, loss, acc_top1, acc_top3 (+ weighted
   variants)
3) confusion_matrices.npz: per-split confusion matrix ndarrays
4) label_stats.csv: split, label, precision, recall

Example weights follow the reference's inverse-frequency convention:
weight = (split size) / (label count within the split), normalized so
weights sum to the split size.

    python -m megadetector_tpu_torch.classification.evaluate_model \
        clf.npz dataset_dir --cropped_images_dir crops --output_dir out \
        [--device cpu]

trace_model writes the classifier forward as a standalone torch.export
program (weights baked in), loaded with torch.export.load.
"""

import argparse
import collections
import json
import os
import sys

import numpy as np

from megadetector_tpu_torch.classification.create_classification_dataset \
    import load_dataset_csv, rows_for_split

SPLITS = ['train', 'val', 'test']


def _predict_rows(classifier, rows, cropped_images_dir, batch_size=32):
    """Run the classifier over crop files; returns (probs [N, C],
    valid mask [N])."""

    from megadetector_tpu_torch.visualization import \
        visualization_utils as vis_utils

    n = len(rows)
    num_classes = classifier.config.num_classes
    probs = np.zeros((n, num_classes), np.float32)
    valid = np.zeros(n, bool)

    batch_imgs = []
    batch_idx = []

    def flush():
        if not batch_imgs:
            return
        p = classifier.classify_batch(batch_imgs)
        for bi, pi in zip(batch_idx, np.asarray(p)):
            probs[bi] = pi
            valid[bi] = True
        batch_imgs.clear()
        batch_idx.clear()

    for i, r in enumerate(rows):
        path = os.path.join(cropped_images_dir, r['path'])
        try:
            img = np.asarray(vis_utils.load_image(path))
        except Exception:
            continue
        batch_imgs.append(img)
        batch_idx.append(i)
        if len(batch_imgs) >= batch_size:
            flush()
    flush()
    return probs, valid


def _topk_accuracy(probs, labels, weights, k):
    if len(labels) == 0:
        return 0.0, 0.0
    topk = np.argsort(-probs, axis=1)[:, :k]
    hit = np.any(topk == labels[:, None], axis=1)
    acc = float(hit.mean())
    acc_w = float((hit * weights).sum() / max(weights.sum(), 1e-9))
    return acc, acc_w


def calc_per_label_stats(cm, label_names):
    """
    Per-label precision/recall from a confusion matrix C (C[i, j] =
    observations of group i predicted as group j); returns a DataFrame
    indexed by 'label' with 'precision' and 'recall' columns (recall is
    NaN for labels with zero ground-truth observations) (reference:
    evaluate_model.py:126-153).
    """

    import numpy as np
    import pandas as pd

    cm = np.asarray(cm)
    tp = np.diag(cm)
    predicted_positives = cm.sum(axis=0, dtype=np.float64)
    predicted_positives[predicted_positives == 0] += 1e-8
    all_positives = cm.sum(axis=1, dtype=np.float64)
    all_positives[all_positives == 0] = np.nan

    df = pd.DataFrame()
    df['label'] = list(label_names)
    df['precision'] = tp / predicted_positives
    df['recall'] = tp / all_positives
    df.set_index('label', inplace=True)
    return df


def check_override(params, key, override):
    """
    Return params[key], or [override] when given (printing what was
    overridden) (reference: evaluate_model.py:74-84).
    """

    if override is None:
        return params[key]
    saved = params.get(key, None)
    print('Overriding saved {}. Saved: {}. Override with: {}.'.format(
        key, saved, override))
    return override


def trace_model(model_name, ckpt_path, num_classes, img_size, *,
                device=None):
    """
    Compile the trained classifier into a standalone serialized artifact
    (reference: evaluate_model.py:87-120, a TorchScript trace; the JAX
    module writes a jax.export program): a torch.export program of the
    float32 forward at [1, img_size, img_size, 3] float32 (the input
    normalized by the caller) -> [1, num_classes] logits, parameters baked
    in, traced on [device] (keyword only: 'cuda', 'cuda:N', 'cpu' or
    None, the card). Writes <root>_compiled<ext> next to [ckpt_path] and
    its <root>_compiled.trace.json sidecar; reused when the sidecar
    matches this request and the checkpoint has not been rewritten since.
    Returns its path; load with torch.export.load.
    """

    import torch

    from megadetector_tpu_torch.device import get_device
    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.convert_weights import load_checkpoint

    device = get_device(device)
    root, ext = os.path.splitext(ckpt_path)
    compiled_path = root + '_compiled' + ext
    sidecar_path = root + '_compiled.trace.json'
    trace_key = {'model_name': model_name, 'num_classes': num_classes,
                 'img_size': img_size,
                 'ckpt_mtime': os.path.getmtime(ckpt_path),
                 'platform': device.type}
    if os.path.exists(compiled_path):
        # Reuse only when the artifact matches this exact request and
        # the checkpoint hasn't been rewritten since
        try:
            with open(sidecar_path) as f:
                if json.load(f) == trace_key:
                    return compiled_path
        except (OSError, ValueError):
            pass
        print('Stale compiled artifact at {}; re-tracing'.format(
            compiled_path))

    params, metadata = load_checkpoint(ckpt_path)
    arch = (metadata or {}).get('arch', model_name)
    config = efficientnet.EfficientNetConfig(arch, num_classes=num_classes)
    model = efficientnet.EfficientNet(config).load_params(params).eval().to(
        device)
    x = torch.zeros((1, img_size, img_size, 3), dtype=torch.float32,
                    device=device)
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
    torch.export.save(program, compiled_path)
    with open(sidecar_path, 'w') as f:
        json.dump(trace_key, f)
    return compiled_path


def evaluate_model(checkpoint_path, dataset_dir, cropped_images_dir,
                   output_dir, splits=None, batch_size=32,
                   label_index_path=None, *, device=None):
    """
    Evaluate [checkpoint_path] (a converted classifier checkpoint; see
    training/train_classifier.py) over the dataset in [dataset_dir]
    (classification_ds.csv + label_index.json + splits.json). Returns
    the overall-metrics rows. [device] (keyword only): 'cuda', 'cuda:N',
    'cpu' or None (the card; raises without one).
    """

    from megadetector_tpu_torch.models.classifier import SpeciesClassifier

    splits = splits or SPLITS
    rows = load_dataset_csv(
        os.path.join(dataset_dir, 'classification_ds.csv'))
    with open(label_index_path or
              os.path.join(dataset_dir, 'label_index.json')) as f:
        label_index = json.load(f)
    with open(os.path.join(dataset_dir, 'splits.json')) as f:
        split_map = json.load(f)

    label_names = [label_index[str(i)] for i in range(len(label_index))]
    name_to_id = {n: i for i, n in enumerate(label_names)}

    classifier = SpeciesClassifier(checkpoint_path, device=device)
    assert classifier.config.num_classes >= len(label_names), \
        'checkpoint has fewer classes than the label index'

    # Map checkpoint output columns to the dataset's label order by
    # NAME when the checkpoint records class names; positional
    # assumptions silently permute every metric when the label sets
    # differ (e.g. evaluating on a second dataset)
    class_names = list(getattr(classifier, 'class_names', None) or [])
    if class_names:
        missing = [n for n in label_names if n not in class_names]
        assert not missing, \
            'labels {} are not in the checkpoint\'s class names ' \
            '{}'.format(missing, class_names)
        prob_columns = np.asarray(
            [class_names.index(n) for n in label_names])
    else:
        if classifier.config.num_classes != len(label_names):
            print('Warning: checkpoint records no class names and has '
                  '{} outputs vs {} dataset labels; assuming the first '
                  '{} outputs align positionally'.format(
                      classifier.config.num_classes, len(label_names),
                      len(label_names)))
        prob_columns = np.arange(len(label_names))

    os.makedirs(output_dir, exist_ok=True)
    overall_rows = []
    confusions = {}
    label_stat_rows = []

    for split in splits:
        split_rows = rows_for_split(rows, split_map, split)
        # Only rows with a single known label evaluate cleanly
        split_rows = [r for r in split_rows
                      if r['label'] in name_to_id]
        if len(split_rows) == 0:
            continue
        labels = np.asarray([name_to_id[r['label']]
                             for r in split_rows], np.int64)

        # Inverse-frequency example weights, normalized to the split
        counts = collections.Counter(labels.tolist())
        weights = np.asarray(
            [1.0 / counts[int(l)] for l in labels], np.float64)
        weights *= len(labels) / weights.sum()

        probs, valid = _predict_rows(classifier, split_rows,
                                     cropped_images_dir,
                                     batch_size=batch_size)
        if not valid.any():
            print('Warning: no crops in split {} could be loaded from '
                  '{}; skipping (check cropped_images_dir)'.format(
                      split, cropped_images_dir))
            continue
        labels = labels[valid]
        weights = weights[valid]
        probs = probs[valid][:, prob_columns]
        kept_rows = [r for r, v in zip(split_rows, valid) if v]

        # 1) per-split outputs CSV
        out_csv = os.path.join(output_dir,
                               'outputs_{}.csv'.format(split))
        with open(out_csv, 'w') as f:
            f.write('path,label,weight,' + ','.join(label_names) + '\n')
            for r, lbl, w, p in zip(kept_rows, labels, weights, probs):
                f.write('{},{},{:.6f},{}\n'.format(
                    r['path'], label_names[int(lbl)], w,
                    ','.join('{:.6f}'.format(v) for v in p)))

        # 2) overall metrics
        eps = 1e-12
        losses = -np.log(probs[np.arange(len(labels)), labels] + eps)
        acc1, acc1_w = _topk_accuracy(probs, labels, weights, 1)
        k3 = min(3, len(label_names))
        acc3, acc3_w = _topk_accuracy(probs, labels, weights, k3)
        overall_rows.append({
            'split': split,
            'loss': float(losses.mean()),
            'acc_top1': acc1,
            'acc_top3': acc3,
            'loss_weighted': float((losses * weights).sum() /
                                   max(weights.sum(), eps)),
            'acc_weighted_top1': acc1_w,
            'acc_weighted_top3': acc3_w,
        })

        # 3) confusion matrix
        preds = probs.argmax(axis=1)
        cm = np.zeros((len(label_names), len(label_names)), np.int64)
        for t, p in zip(labels, preds):
            cm[int(t), int(p)] += 1
        confusions[split] = cm

        # 4) per-label precision/recall
        for i, name in enumerate(label_names):
            tp = cm[i, i]
            label_stat_rows.append({
                'split': split,
                'label': name,
                'precision': float(tp / max(cm[:, i].sum(), 1)),
                'recall': float(tp / max(cm[i, :].sum(), 1)),
            })

    with open(os.path.join(output_dir, 'overall_metrics.csv'), 'w') as f:
        cols = ['split', 'loss', 'acc_top1', 'acc_top3',
                'loss_weighted', 'acc_weighted_top1',
                'acc_weighted_top3']
        f.write(','.join(cols) + '\n')
        for r in overall_rows:
            f.write(','.join(str(r[c]) for c in cols) + '\n')

    np.savez(os.path.join(output_dir, 'confusion_matrices.npz'),
             **confusions)

    with open(os.path.join(output_dir, 'label_stats.csv'), 'w') as f:
        f.write('split,label,precision,recall\n')
        for r in label_stat_rows:
            f.write('{split},{label},{precision},{recall}\n'.format(**r))

    print('Wrote evaluation outputs to {}'.format(output_dir))
    return overall_rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Evaluate a species classifier over a '
                    'classification dataset')
    parser.add_argument('checkpoint')
    parser.add_argument('dataset_dir')
    parser.add_argument('--cropped_images_dir', required=True)
    parser.add_argument('--output_dir', required=True)
    parser.add_argument('--splits', nargs='*', default=None)
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--device', default=None,
                        help='cuda, cuda:N or cpu (default: cuda, which '
                             'needs a card)')

    if len(sys.argv[1:] if argv is None else argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    evaluate_model(args.checkpoint, args.dataset_dir,
                   args.cropped_images_dir, args.output_dir,
                   splits=args.splits, batch_size=args.batch_size,
                   device=args.device)


if __name__ == '__main__':
    main()
