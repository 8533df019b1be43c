"""
The reference's pytorch_detector module surface in the port (counterpart
of megadetector_tpu/detection/pytorch_detector.py), so code written
against that import path runs on the port:

- PTDetector is models/detector.TorchDetector (converted checkpoints, see
  models/convert_weights.py; the card unless the caller passes
  device='cpu' or the force_cpu option);
- nms() runs ops/nms.batched_nms (the greedy NMS kernel on the card) and
  returns the reference's list of [n, 6] arrays;
- the two metadata functions are the registry's, which handle converted
  checkpoints and reference .pt zipfiles alike.
"""

import numpy as np
import torch

from megadetector_tpu_torch.device import get_device
from megadetector_tpu_torch.models import registry
from megadetector_tpu_torch.models.detector import TorchDetector as PTDetector  # noqa: F401
from megadetector_tpu_torch.ops.nms import batched_nms


def nms(prediction, conf_thres=0.25, iou_thres=0.45, max_det=300, *,
        device=None):
    """
    Non-maximum suppression over decoded predictions [B, A, 5+C]
    (center-format boxes in canvas pixels, objectness, per-class
    confidences). Returns a length-B list of float32 [n, 6] arrays (x1,
    y1, x2, y2, conf, class), highest confidence first.

    A torch tensor is suppressed on its own device; other array-likes go to
    [device] (keyword only: 'cuda', 'cuda:N', 'cpu', or None for the
    card, which raises without one).
    """

    if isinstance(prediction, torch.Tensor):
        pred = prediction.float()
    else:
        pred = torch.as_tensor(np.array(prediction, np.float32),
                               device=get_device(device))
    with torch.inference_mode():
        out = batched_nms(pred, conf_thres, iou_thres, max_det=max_det)
    boxes, scores, classes, valid = (
        out[k].cpu().numpy() for k in ('boxes', 'scores', 'classes',
                                       'valid'))
    return [np.concatenate([boxes[i][v], scores[i][v][:, None],
                            classes[i][v][:, None].astype(np.float32)],
                           axis=1)
            for i, v in enumerate(valid)]


def add_metadata_to_megadetector_model_file(
        model_file_in, model_file_out, metadata,
        destination_path='megadetector_info.json'):
    """Add a metadata dict to a model file, writing [model_file_out]
    (registry.add_metadata_to_model_file)."""

    return registry.add_metadata_to_model_file(
        model_file_in, metadata, output_filename=model_file_out)


def read_metadata_from_megadetector_model_file(
        model_file, relative_path='megadetector_info.json', verbose=False):
    """A model file's embedded metadata dict, or None
    (registry.read_metadata_from_model_file)."""

    return registry.read_metadata_from_model_file(model_file,
                                                  verbose=verbose)
