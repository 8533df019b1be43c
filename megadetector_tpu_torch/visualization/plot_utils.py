"""
Plotting helpers: precision-recall curves, confidence histograms, and
calibration (reliability) plots.

Behavioral contract follows the reference
(megadetector/visualization/plot_utils.py:20-254). matplotlib is imported
lazily (headless Agg backend) so the rest of the framework never needs it.

The port's own copy of megadetector_tpu/visualization/plot_utils.py: the
same public names, signatures, defaults and output bytes.
"""

import numpy as np


def _get_plt():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def precision_recall_curve(y_true, y_scores):
    """
    Compute a P/R curve without sklearn. Returns
    (precisions, recalls, thresholds) sorted by descending threshold.
    """

    y_true = np.asarray(y_true, bool)
    y_scores = np.asarray(y_scores, float)
    order = np.argsort(-y_scores)
    y_true = y_true[order]
    y_scores = y_scores[order]

    tp = np.cumsum(y_true)
    fp = np.cumsum(~y_true)
    n_pos = max(int(y_true.sum()), 1)

    precisions = tp / np.maximum(tp + fp, 1)
    recalls = tp / n_pos
    return precisions, recalls, y_scores


def average_precision(y_true, y_scores):
    """AP = area under the P/R curve (step interpolation)."""

    precisions, recalls, _ = precision_recall_curve(y_true, y_scores)
    recalls = np.concatenate([[0.0], recalls])
    precisions = np.concatenate([[1.0], precisions])
    return float(np.sum(np.diff(recalls) * precisions[1:]))


def plot_precision_recall_curve(y_true, y_scores, output_file=None,
                                title='Precision-recall'):
    """Render a P/R curve to [output_file]; returns the AP."""

    precisions, recalls, _ = precision_recall_curve(y_true, y_scores)
    ap = average_precision(y_true, y_scores)
    if output_file is not None:
        plt = _get_plt()
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.plot(recalls, precisions)
        ax.set_xlabel('Recall')
        ax.set_ylabel('Precision')
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1.02)
        ax.set_title('{} (AP = {:.3f})'.format(title, ap))
        ax.grid(alpha=0.3)
        fig.savefig(output_file, bbox_inches='tight', dpi=120)
        plt.close(fig)
    return ap


def expected_calibration_error(y_true, y_scores, n_bins=10):
    """
    ECE over equal-width confidence bins
    (reference: plot_utils.py:209).
    """

    y_true = np.asarray(y_true, float)
    y_scores = np.asarray(y_scores, float)
    bins = np.linspace(0, 1, n_bins + 1)
    ece = 0.0
    n = len(y_scores)
    for i in range(n_bins):
        mask = (y_scores >= bins[i]) & (y_scores < bins[i + 1])
        if i == n_bins - 1:
            mask |= y_scores == 1.0
        if not mask.any():
            continue
        accuracy = y_true[mask].mean()
        confidence = y_scores[mask].mean()
        ece += (mask.sum() / n) * abs(accuracy - confidence)
    return float(ece)


def calibration_ece(true_scores, pred_scores, num_bins):
    """
    Expected calibration error per eq. (3) of Guo et al. 2017
    (reference: plot_utils.py:209-251). Returns (accs, confs, ece):
    per-bin accuracy and mean confidence (empty bins dropped, so the
    arrays can be shorter than [num_bins]) plus the scalar ECE.
    """

    assert len(true_scores) == len(pred_scores)
    true_scores = np.asarray(true_scores, float)
    pred_scores = np.asarray(pred_scores, float)

    bins = np.linspace(0., 1. + 1e-8, num=num_bins + 1)
    binids = np.digitize(pred_scores, bins) - 1

    bin_sums = np.bincount(binids, weights=pred_scores,
                           minlength=len(bins))
    bin_true = np.bincount(binids, weights=true_scores,
                           minlength=len(bins))
    bin_total = np.bincount(binids, minlength=len(bins))

    nonzero = bin_total != 0
    accs = bin_true[nonzero] / bin_total[nonzero]
    confs = bin_sums[nonzero] / bin_total[nonzero]
    weights = bin_total[nonzero] / len(pred_scores)
    ece = float(np.sum(weights * np.abs(accs - confs)))
    return accs, confs, ece


def plot_calibration_curve(y_true, y_scores, output_file=None, n_bins=10,
                           title='Calibration'):
    """Reliability diagram; returns the ECE."""

    ece = expected_calibration_error(y_true, y_scores, n_bins)
    if output_file is not None:
        plt = _get_plt()
        y_true = np.asarray(y_true, float)
        y_scores = np.asarray(y_scores, float)
        bins = np.linspace(0, 1, n_bins + 1)
        centers, accuracies = [], []
        for i in range(n_bins):
            mask = (y_scores >= bins[i]) & (y_scores < bins[i + 1])
            if not mask.any():
                continue
            centers.append((bins[i] + bins[i + 1]) / 2)
            accuracies.append(y_true[mask].mean())
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.plot([0, 1], [0, 1], '--', color='gray')
        ax.bar(centers, accuracies, width=1.0 / n_bins, alpha=0.7,
               edgecolor='black')
        ax.set_xlabel('Confidence')
        ax.set_ylabel('Accuracy')
        ax.set_title('{} (ECE = {:.3f})'.format(title, ece))
        fig.savefig(output_file, bbox_inches='tight', dpi=120)
        plt.close(fig)
    return ece


def plot_confidence_histogram(scores, output_file=None, n_bins=50,
                              title='Confidence histogram'):
    """Histogram of detection confidences."""

    if output_file is not None:
        plt = _get_plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(np.asarray(scores, float), bins=n_bins, range=(0, 1))
        ax.set_xlabel('Confidence')
        ax.set_ylabel('Count')
        ax.set_title(title)
        fig.savefig(output_file, bbox_inches='tight', dpi=120)
        plt.close(fig)
    return np.histogram(np.asarray(scores, float), bins=n_bins,
                        range=(0, 1))


def plot_confusion_matrix(matrix, classes, normalize=False,
                          title='Confusion matrix', vmax=None,
                          use_colorbar=True, y_label=True,
                          fmt='{:.0f}', output_file=None):
    """
    Render a confusion matrix (rows = ground truth, columns =
    predicted) with per-cell value labels; optionally row-normalized
    (reference: plot_utils.py:20-97). Returns the figure.
    """

    plt = _get_plt()
    matrix = np.asarray(matrix, np.float64)
    num_classes = matrix.shape[0]
    assert matrix.shape[1] == num_classes
    assert len(classes) == num_classes

    if normalize:
        matrix = matrix / (matrix.sum(axis=1, keepdims=True) + 1e-7)

    fig_h = 3 + 0.3 * num_classes
    fig_w = fig_h + (0.5 if use_colorbar else 0.0)
    fig, ax = plt.subplots(figsize=(fig_w, fig_h))
    im = ax.imshow(matrix, interpolation='nearest', cmap='Blues',
                   vmax=vmax)
    ax.set_title(title)
    if use_colorbar:
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    ax.set_xticks(range(num_classes))
    ax.set_xticklabels(classes, rotation=90)
    ax.set_yticks(range(num_classes))
    ax.set_yticklabels(classes if y_label else [''] * num_classes)
    ax.set_xlabel('Predicted class')
    ax.set_ylabel('Ground-truth class')

    # Per-cell labels, white on dark cells
    threshold = (np.nanmax(matrix) if vmax is None else vmax) / 2.0
    for i in range(num_classes):
        for j in range(num_classes):
            ax.text(j, i, fmt.format(matrix[i, j]),
                    ha='center', va='center', fontsize=8,
                    color='white' if matrix[i, j] > threshold
                    else 'black')
    fig.tight_layout()
    if output_file is not None:
        fig.savefig(output_file)
        plt.close(fig)
    return fig


def plot_stacked_bar_chart(data, series_labels=None, col_labels=None,
                           x_label=None, y_label=None, log_scale=False,
                           output_file=None):
    """
    Stacked bar chart (rows = series, e.g. species; columns = bars,
    e.g. locations); reference: plot_utils.py:140-206. Returns the
    figure.
    """

    plt = _get_plt()
    data = np.asarray(data, np.float64)
    n_series, n_cols = data.shape
    fig, ax = plt.subplots(
        figsize=(max(6, 0.4 * n_cols), 5))
    x = np.arange(n_cols)
    bottom = np.zeros(n_cols)
    for i_series in range(n_series):
        label = series_labels[i_series] if series_labels else None
        ax.bar(x, data[i_series], bottom=bottom, label=label)
        bottom += data[i_series]
    if col_labels is not None:
        ax.set_xticks(x)
        ax.set_xticklabels(col_labels, rotation=90)
    if x_label:
        ax.set_xlabel(x_label)
    if y_label:
        ax.set_ylabel(y_label)
    if log_scale:
        ax.set_yscale('log')
    if series_labels:
        ax.legend(fontsize=8)
    fig.tight_layout()
    if output_file is not None:
        fig.savefig(output_file)
        plt.close(fig)
    return fig
