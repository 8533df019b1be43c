"""
Framework-agnostic utilities for classifier training, the port's own copy
of megadetector_tpu/classification/train_utils.py (which imports no jax;
the port imports nothing of the JAX package): top-k example tracking via
a bounded heap, figure/image-grid helpers for logging extreme examples,
split loading, and confusion-matrix recall. Also load_dataset_csv and
rows_for_split, copied from the JAX package's
classification/create_classification_dataset.py (the rest of that module
is not ported yet, ROADMAP A13).
"""

import dataclasses
import heapq
import io
import json

from typing import Any

import numpy as np


@dataclasses.dataclass(order=True)
class HeapItem:
    """
    A wrapper over non-comparable data with a comparable priority value
    (reference: train_utils.py:34-40).
    """

    priority: Any
    data: Any = dataclasses.field(compare=False, repr=False)


def add_to_heap(h, item, k=None):
    """
    Track the max-[k] elements in the min-heap [h]: push when below
    capacity, otherwise push-and-pop so the smallest element leaves
    (reference: train_utils.py:43-62).
    """

    if k is None or len(h) < k:
        heapq.heappush(h, item)
    else:
        heapq.heappushpop(h, item)


def prefix_all_keys(d, prefix):
    """New dict with every key prefixed (reference: train_utils.py:65)."""

    return {'{}{}'.format(prefix, k): v for k, v in d.items()}


def fig_to_img(fig):
    """
    Render a matplotlib figure to a uint8 [H, W, 3] numpy array
    (reference: train_utils.py:73-86).
    """

    from PIL import Image

    with io.BytesIO() as b:
        fig.savefig(b, transparent=False, bbox_inches='tight',
                    pad_inches=0, format='png')
        b.seek(0)
        fig_img = np.asarray(Image.open(b).convert('RGB'))
    assert fig_img.dtype == np.uint8
    return fig_img


def plot_img_grid(imgs, row_h, col_w, ncols=None, tags=None,
                  titles=None):
    """
    Grid of images with optional corner tags and titles; returns the
    matplotlib Figure (reference: train_utils.py:123-176).
    """

    import matplotlib.figure

    num_images = len(imgs)
    if tags is not None:
        assert len(tags) == num_images
    if titles is not None:
        assert len(titles) == num_images
    if ncols is None:
        ncols = num_images

    nrows = int(np.ceil(num_images / ncols))
    fig = matplotlib.figure.Figure(
        figsize=(ncols * col_w, nrows * row_h), tight_layout=True)
    axs = fig.subplots(nrows, ncols, squeeze=False)

    for i in range(num_images):
        ax = axs[i // ncols, i % ncols]
        ax.imshow(imgs[i])
        if tags is not None:
            ax.text(-0.2, -0.2, tags[i], ha='left', va='top',
                    bbox=dict(lw=0, facecolor='white'))
        if titles is not None:
            ax.set_title(titles[i])

    for r in range(nrows):
        for c in range(ncols):
            axs[r, c].set_axis_off()
            axs[r, c].set_aspect('equal')
    fig.subplots_adjust(wspace=0, hspace=0)
    return fig


def imgs_with_confidences(imgs_list, label_names):
    """
    Plot a row of images annotated with their true label and top-k
    predicted confidences; returns (figure, image file list)
    (reference: train_utils.py:89-120). Each imgs_list entry is
    (img, label_id, topk_conf, topk_preds, img_file).
    """

    imgs, img_files, tags, titles = [], [], [], []
    for img, label_id, topk_conf, topk_preds, img_file in imgs_list:
        imgs.append(img)
        img_files.append(img_file)
        tags.append(label_names[label_id])
        titles.append('\n'.join(
            '{}: {:.03f}'.format(label_names[pred], conf)
            for pred, conf in zip(topk_preds, topk_conf)))

    fig = plot_img_grid(imgs=imgs, row_h=3, col_w=2.5, tags=tags,
                        titles=titles)
    return fig, img_files


def load_splits(splits_json_path):
    """
    Load location splits from splits.json; returns
    {split: set of (dataset, location)} and asserts the splits don't
    overlap (reference: train_utils.py:179-199).
    """

    with open(splits_json_path, 'r') as f:
        split_to_locs_js = json.load(f)
    split_to_locs = {
        split: set((loc[0], loc[1]) for loc in locs)
        for split, locs in split_to_locs_js.items()
    }
    assert split_to_locs['train'].isdisjoint(split_to_locs['val'])
    assert split_to_locs['train'].isdisjoint(split_to_locs['test'])
    assert split_to_locs['val'].isdisjoint(split_to_locs['test'])
    return split_to_locs


def recall_from_confusion_matrix(confusion_matrix, label_names):
    """
    {label name: recall} from a confusion matrix with C[i, j] = samples
    of true label i predicted as j (reference:
    train_utils.py:306-323).
    """

    confusion_matrix = np.asarray(confusion_matrix)
    return {
        label_name:
            confusion_matrix[i, i] / (confusion_matrix[i].sum() + 1e-8)
        for i, label_name in enumerate(label_names)
    }


def load_dataset_csv(csv_path):
    """Read classification_ds.csv back into a list of row dicts."""

    rows = []
    with open(csv_path) as f:
        header = f.readline().strip().split(',')
        for line in f:
            parts = line.rstrip('\n').split(',', len(header) - 1)
            rows.append(dict(zip(header, parts)))
    return rows


def rows_for_split(rows, splits, split_name):
    """Rows whose (dataset, location) belongs to [split_name]."""

    members = {tuple(lc) for lc in splits[split_name]}
    return [r for r in rows
            if (r['dataset'], str(r['location'])) in members]
