"""
Legacy TF1 frozen-graph detector (MDv2, MDv3, MDv4).

Behavioral contract follows the reference
(megadetector/detection/tf_detector.py:25-209): load a frozen inference
graph (.pb), feed uint8 batches to 'image_tensor:0', read
'detection_boxes:0' ([y1, x1, y2, x2] normalized), 'detection_scores:0'
and 'detection_classes:0'; batch size fixed at 1 (resizing happens inside
the graph); boxes convert to MD [x, y, w, h]; confidences rounded to the
standard digits. These models are deprecated upstream — this exists for
backward compatibility with archived results/workflows, and runs on the
TF CPU runtime (there is no card path for TF1 graphs; use MDv5+ on the
card). The port's copy of megadetector_tpu/detection/tf_detector.py:
tensorflow is imported when a detector is built, and its absence is
named there; run_detector.load_detector dispatches .pb files here.
"""

import time

import numpy as np

from megadetector_tpu_torch.utils import ct_utils

CONF_DIGITS = 3
COORD_DIGITS = 4
FAILURE_INFER = 'inference failure'


class TFDetector:
    """Loads and runs a legacy MegaDetector TF1 frozen graph."""

    # The TF models process one image at a time (the graph does its own
    # resizing); kept for API compatibility
    BATCH_SIZE = 1

    # These models emit fixed categories 1/2/3
    DEFAULT_RENDERING_CONFIDENCE_THRESHOLD = 0.85
    DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD = 0.1

    def __init__(self, model_path, detector_options=None, verbose=False):
        try:
            import tensorflow.compat.v1 as tf
        except ImportError as e:
            raise ImportError(
                'TFDetector: the legacy .pb detectors (MDv2-v4) run on '
                'tensorflow\'s CPU runtime, and tensorflow is not installed '
                '({})'.format(e)) from e
        tf.disable_v2_behavior()

        if verbose:
            print('Loading TF graph from {}'.format(model_path))
        start = time.time()

        graph = tf.Graph()
        with graph.as_default():
            graph_def = tf.GraphDef()
            with tf.io.gfile.GFile(model_path, 'rb') as f:
                graph_def.ParseFromString(f.read())
            tf.import_graph_def(graph_def, name='')

        # TF's CPU runtime only: a tensorflow built with GPU support
        # would otherwise take a card for itself beside torch
        self.tf_session = tf.Session(
            graph=graph, config=tf.ConfigProto(device_count={'GPU': 0}))
        self.image_tensor = graph.get_tensor_by_name('image_tensor:0')
        self.box_tensor = graph.get_tensor_by_name('detection_boxes:0')
        self.score_tensor = graph.get_tensor_by_name('detection_scores:0')
        self.class_tensor = graph.get_tensor_by_name(
            'detection_classes:0')

        print('TFDetector loaded model in {:.2f}s'.format(
            time.time() - start))

    @staticmethod
    def __convert_coords(tf_coords):
        """TF [y1, x1, y2, x2] -> MD [x, y, w, h] (all normalized)."""

        y1, x1, y2, x2 = [float(v) for v in tf_coords]
        return [x1, y1, x2 - x1, y2 - y1]

    def preprocess_image(self, img_original, image_id='unknown',
                         image_size=None, verbose=False):
        """The TF graph resizes internally; preprocessing is a no-op."""

        if not isinstance(img_original, np.ndarray):
            img_original = np.asarray(img_original)
        return {'file': image_id, 'img_processed': img_original,
                'img_original': img_original,
                'scaling_shape': img_original.shape}

    def generate_detections_one_image(self, img_original,
                                      image_id='unknown',
                                      detection_threshold=0.1,
                                      image_size=None, augment=False,
                                      verbose=False):
        """Run the frozen graph on one image; returns an MD image dict."""

        result = {'file': image_id}
        try:
            if isinstance(img_original, dict):
                img = img_original['img_processed']
            elif not isinstance(img_original, np.ndarray):
                img = np.asarray(img_original)
            else:
                img = img_original

            boxes, scores, classes = self.tf_session.run(
                [self.box_tensor, self.score_tensor, self.class_tensor],
                feed_dict={self.image_tensor: img[None]})
            boxes = np.squeeze(boxes, axis=0)
            scores = np.squeeze(scores, axis=0)
            classes = np.squeeze(classes, axis=0)

            detections = []
            max_conf = 0.0
            for box, score, cls in zip(boxes, scores, classes):
                if score < detection_threshold:
                    continue
                detections.append({
                    'category': str(int(cls)),
                    'conf': ct_utils.truncate_float(
                        float(score), precision=CONF_DIGITS),
                    'bbox': ct_utils.truncate_float_array(
                        TFDetector.__convert_coords(box),
                        precision=COORD_DIGITS),
                })
                max_conf = max(max_conf, float(score))

            result['detections'] = detections
            result['max_detection_conf'] = ct_utils.truncate_float(
                max_conf, precision=CONF_DIGITS)
        except Exception as e:
            result['detections'] = None
            result['failure'] = FAILURE_INFER
            if verbose:
                print('TF inference error for {}: {}'.format(image_id, e))
        return result

    def generate_detections_one_batch(self, img_originals, image_ids=None,
                                      detection_threshold=0.1,
                                      image_size=None, augment=False,
                                      verbose=False):
        """Sequential per-image loop (the TF graphs are batch-1)."""

        if image_ids is None:
            image_ids = ['unknown'] * len(img_originals)
        return [self.generate_detections_one_image(
            img, image_id, detection_threshold=detection_threshold,
            verbose=verbose)
            for img, image_id in zip(img_originals, image_ids)]
