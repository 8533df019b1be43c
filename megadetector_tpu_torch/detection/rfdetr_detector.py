"""
The reference's rfdetr_detector module surface in the port (counterpart
of megadetector_tpu/detection/rfdetr_detector.py):

- RFDETRDetector is models/detector.TorchDetector, which runs
  models/rfdetr.py when the checkpoint's metadata says model_type 'rfdetr';
- load_model() loads a converted RF-DETR checkpoint (convert a .pth first
  with models/convert_weights.convert_rfdetr_checkpoint, or
  convert_megadetector_checkpoint, which routes it) in the reference's
  dict shape;
- convert_detections_to_md_format() turns absolute-xyxy detections into
  normalized MD dicts.
"""

from megadetector_tpu_torch.models.detector import TorchDetector as RFDETRDetector  # noqa: F401
from megadetector_tpu_torch.models.registry import \
    read_metadata_from_model_file
from megadetector_tpu_torch.utils.ct_utils import (round_float,
                                                   round_float_array)

CONF_DIGITS = 3
COORD_DIGITS = 4


def load_model(detector_file, image_size=None, optimize_for_inference=False,
               batch_size=1, compile=None, dtype=None, *, device=None):
    """
    Load an RF-DETR model from a converted checkpoint. The torch-specific
    knobs (optimize_for_inference, batch_size, compile) are accepted for
    the reference's signature; dtype 'float16' runs as bfloat16. [device]
    (keyword only) is the TorchDetector's: None for the card, 'cpu' for
    the CPU.

    Returns a dict with 'model' (the detector), 'model_type',
    'image_size' and 'detection_categories'.
    """

    detector_options = {}
    if image_size is not None:
        detector_options['image_size'] = image_size
    if dtype is not None:
        detector_options['dtype'] = \
            'bfloat16' if str(dtype) == 'float16' else str(dtype)

    detector = RFDETRDetector(detector_file,
                              detector_options=detector_options,
                              device=device)
    metadata = read_metadata_from_model_file(detector_file) or {}
    return {
        'model': detector,
        'model_type': metadata.get('architecture',
                                   metadata.get('model_type', 'rfdetr')),
        'image_size': getattr(detector, 'default_image_size', None),
        'detection_categories': metadata.get('detection_categories'),
    }


def convert_detections_to_md_format(detections, image_width, image_height):
    """
    Absolute-pixel xyxy detections -> MD detection dicts with clamped,
    rounded normalized boxes. [detections] has .xyxy [n, 4], .confidence
    [n] and .class_id [n] (the supervision Detections layout), or is None.
    """

    md_detections = []
    if detections is None or len(detections) == 0:
        return md_detections

    for i in range(len(detections)):
        x1, y1, x2, y2 = detections.xyxy[i]
        x_min_norm = max(0.0, min(1.0, float(x1) / image_width))
        y_min_norm = max(0.0, min(1.0, float(y1) / image_height))
        width_norm = max(0.0, min(1.0 - x_min_norm,
                                  float(x2 - x1) / image_width))
        height_norm = max(0.0, min(1.0 - y_min_norm,
                                   float(y2 - y1) / image_height))

        md_detections.append({
            'category': str(int(detections.class_id[i])),
            'conf': round_float(float(detections.confidence[i]),
                                precision=CONF_DIGITS),
            'bbox': round_float_array(
                [x_min_norm, y_min_norm, width_norm, height_norm],
                precision=COORD_DIGITS),
        })
    return md_detections
