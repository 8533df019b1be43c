"""
Species classifier: batched crop classification on the card (counterpart
of megadetector_tpu/models/classifier.py, with its options, defaults and
errors).

Checkpoints are .npz parameter trees with metadata carrying class names,
input size and normalization constants; the network is the EfficientNetV2
family (models/efficientnet.py). One batch is one device program (uint8
crops -> / 255 -> (x - mean) / std -> forward -> softmax) run through
models/program_cache.py: eager on its first call per batch size, then
captured into a CUDA graph and replayed, fed from a pinned buffer.

classify_batch_async dispatches a batch and returns at once: its
probabilities are copied (non-blocking, into a pinned buffer of the
handle's own) out of the program's static output, and an event on the
stream marks the copy. A later replay rewrites the static output only
after that copy on the same stream, so batches N and N + 1 may both be in
flight before fetch_batch(N) reads N's buffer.

int8 (quantize=int8) follows the JAX classifier: scales calibrated on the
first classified batch unless calibrate() was called. Unlike the JAX
classifier, calibrate() on a calibrated classifier recalibrates (the JAX
one fails an assertion, models/classifier.py:173), a quantized checkpoint
saved before calibration loads and calibrates (ops/quantization.py
requalify_quantized), and the crop count a calibration used is always
printed (JAX prints it only when verbose; the first batch may hold 1-3
crops, models/classifier.py:267).
"""

import numpy as np
import torch

from megadetector_tpu_torch.device import (device_constant, get_device,
                                           set_float32_exact)
from megadetector_tpu_torch.models import efficientnet
from megadetector_tpu_torch.models.convert_weights import load_checkpoint
from megadetector_tpu_torch.models.detector import DTYPES, _to_bool
from megadetector_tpu_torch.models.program_cache import ProgramCache
from megadetector_tpu_torch.ops import quantization as q
from megadetector_tpu_torch.ops.boxes import _resize, letterbox
from megadetector_tpu_torch.ops.conv_int8 import scalar_like


class SpeciesClassifier:
    """
    Batched image classifier.

    Classifier options (a dict, the JAX classifier's names):
        arch: override the checkpoint metadata's architecture
        num_classes: used when the metadata has none (else from the fc)
        dtype: 'float32' (default) or 'bfloat16'; int8 defaults to bf16
            for its float convs
        image_size: input side (default from metadata, else 480)
        crop_mode: 'stretch' (resize the crop to the square input,
            SpeciesNet-style) or 'pad' (letterbox the crop)
        folded_stem: 'auto' (default), 'off', 'w2' or 'w4': accepted and
            ignored (the JAX package's TPU stem layout; the function is
            the same); other values raise ValueError
        quantize: 'off' (default) or 'int8', the chained int8 inference of
            models/efficientnet.quantize_params_chain, calibrated on the
            first classified batch unless calibrate() was called
        calibration_headroom: abs-max multiplier for the int8 activation
            scales (default 1.0)
        force_cpu: run on the CPU (the default device is the card)

    [device] (keyword-only): 'cuda', 'cuda:N', 'cpu' or None (CUDA; raises
    without a card).
    """

    KNOWN_OPTIONS = ('arch', 'num_classes', 'image_size', 'crop_mode',
                     'folded_stem', 'dtype', 'quantize',
                     'calibration_headroom', 'force_cpu')

    def __init__(self, model_path, classifier_options=None, verbose=False,
                 *, device=None):

        options = dict(classifier_options or {})
        unknown = sorted(set(options) - set(self.KNOWN_OPTIONS))
        if unknown:
            raise ValueError(
                'Unknown classifier option(s) {} (known: {})'.format(
                    unknown, list(self.KNOWN_OPTIONS)))
        self.verbose = verbose
        if _to_bool(options.get('force_cpu', False)):
            device = 'cpu'
        self.device = get_device(device)
        if self.device.type == 'cuda':
            set_float32_exact()

        params, metadata = load_checkpoint(model_path)
        self.metadata = metadata or {}

        arch = options.get('arch',
                           self.metadata.get('arch', 'efficientnetv2_m'))
        num_classes = int(self.metadata.get('num_classes',
                                            options.get('num_classes', 0)))
        if num_classes == 0:
            # Infer from the fc weights
            num_classes = params['fc']['w'].shape[-1]

        self.config = efficientnet.EfficientNetConfig(
            arch, num_classes=num_classes)
        self.image_size = int(options.get(
            'image_size', self.metadata.get('image_size', 480)))
        self.class_names = self.metadata.get(
            'class_names',
            ['class_{}'.format(i) for i in range(num_classes)])
        self.crop_mode = options.get('crop_mode', 'stretch')

        # Normalization applied on the device (defaults: [0,1] scaling
        # only, matching SpeciesNet's preprocessing)
        self.mean = np.asarray(
            self.metadata.get('normalization_mean', [0.0, 0.0, 0.0]),
            np.float32)
        self.std = np.asarray(
            self.metadata.get('normalization_std', [1.0, 1.0, 1.0]),
            np.float32)

        fold = options.get('folded_stem', 'auto')
        if fold not in ('auto', True, 'off', False, 'w2', 'w4'):
            raise ValueError(
                'folded_stem must be auto/off/w2/w4, got {!r}'.format(
                    options.get('folded_stem')))

        quantize = options.get('quantize', 'off')
        if quantize in (False, None, 'off'):
            quantize = 'off'
        elif quantize not in ('int8',):
            raise ValueError(
                "quantize must be 'off' or 'int8', got {!r}".format(
                    quantize))
        self.quantize = quantize
        self.calibration_headroom = float(
            options.get('calibration_headroom', 1.0))

        # int8 mode defaults the float-part compute dtype to bf16
        dtype_name = options.get(
            'dtype', 'bfloat16' if quantize == 'int8' else 'float32')
        self.compute_dtype = DTYPES[dtype_name]

        if efficientnet.stem_is_folded(params):
            params = efficientnet.unfold_stem(params)
        if quantize == 'int8':
            if not efficientnet.params_are_chain_quantized(params):
                params = efficientnet.quantize_params_chain(
                    params, self.config)
            else:
                params = q.requalify_quantized(params)
            self._calibrated = self._chain_is_calibrated(params)
        else:
            self._calibrated = True
        self.params = params
        self.calibration_crops = None
        self._reset_programs()

    @staticmethod
    def _chain_is_calibrated(params):
        nodes = []

        def walk(node):
            if isinstance(node, dict):
                if 'w_q' in node:
                    nodes.append(node)
                else:
                    for v in node.values():
                        walk(v)
        walk(params)
        return bool(nodes) and all('y_scale' in n for n in nodes)

    def _reset_programs(self):
        """Drop the network and its programs (after a calibration)."""

        self._model = None
        self._programs = ProgramCache(self.device)

    @property
    def model(self):
        """The network on the device, built at first use (an int8
        classifier's after its calibration)."""

        if self._model is None:
            self._model = efficientnet.EfficientNet(self.config) \
                .load_params(self.params) \
                .set_compute_dtype(self.compute_dtype).eval() \
                .to(self.device)
        return self._model

    def calibrate(self, crops):
        """
        Bake static int8 activation scales from representative crops (a
        list of HWC uint8 arrays, or a stacked [N, H, W, 3] uint8 batch).
        Only meaningful with quantize='int8'; classify_batch calibrates on
        its first batch if this was never called. A calibrated classifier
        is recalibrated from [crops]. Prints the number of crops used.
        """

        if self.quantize != 'int8':
            raise ValueError('calibrate() requires quantize=int8')
        if isinstance(crops, np.ndarray) and crops.ndim == 4:
            batch = crops
        else:
            s = self.image_size
            batch = np.stack([
                c if (c.shape[0] == s and c.shape[1] == s)
                else self.preprocess_crop(c) for c in crops])
        x = (batch.astype(np.float32) / 255.0 - self.mean) / self.std

        self.params = efficientnet.strip_scales(self.params)
        q.calibrate_chain_scales(self.config, self.params, x,
                                 headroom=self.calibration_headroom,
                                 device=self.device)
        self._calibrated = True
        self.calibration_crops = int(batch.shape[0])
        self._reset_programs()
        print('Calibrated int8 scales on {} crops'.format(batch.shape[0]))

    def _program(self, crops_u8):
        """uint8 crops [B, S, S, 3] on the device -> [B, num_classes]
        float32 probabilities."""

        device = crops_u8.device
        x = crops_u8.to(torch.float32) / scalar_like(255.0, crops_u8)
        x = (x - device_constant(self.mean, torch.float32, device)) / \
            device_constant(self.std, torch.float32, device)
        with torch.inference_mode():
            logits = self.model(x)
        return torch.softmax(logits, dim=-1)

    def preprocess_crop(self, crop):
        """HWC uint8 crop -> [image_size, image_size, 3] uint8."""

        s = self.image_size
        if self.crop_mode == 'stretch':
            return _resize(crop, (s, s))
        # 'pad': letterbox into the square
        out, _, _ = letterbox(crop, (s, s), auto=False, scaleup=True)
        return out

    def classify_batch_async(self, crops, pad_to=None):
        """
        Dispatch one classifier batch without waiting for its result;
        returns a handle for fetch_batch(). The host can stage the next
        batch while this one runs (the two-stage driver keeps one batch in
        flight).

        pad_to: when set, pad the batch with zero crops up to this size so
        one program (and one CUDA graph) serves every flush.
        """

        if len(crops) == 0:
            return (None, None, 0)

        s = self.image_size
        processed = []
        for crop in crops:
            if crop.shape[0] != s or crop.shape[1] != s:
                crop = self.preprocess_crop(crop)
            processed.append(crop)
        batch = np.stack(processed).astype(np.uint8)

        n = batch.shape[0]
        if pad_to is not None and n < pad_to:
            batch = np.concatenate(
                [batch, np.zeros((pad_to - n,) + batch.shape[1:],
                                 np.uint8)], axis=0)

        if not self._calibrated:
            # First batch in int8 mode: bake activation scales from it,
            # then classify it through the calibrated chain so every batch
            # in the run uses identical numerics
            self.calibrate(batch[:n])

        probs, _ = self._programs.run(('classify',) + batch.shape,
                                      self._program, host_inputs=(batch,))
        if self.device.type != 'cuda':
            return (probs.clone(), None, n)
        out = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
        out.copy_(probs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return (out, done, n)

    def fetch_batch(self, handle):
        """Wait for a classify_batch_async() handle; returns [N,
        num_classes] numpy probabilities."""

        probs, done, n = handle
        if probs is None:
            return np.zeros((0, self.config.num_classes), np.float32)
        if done is not None:
            done.synchronize()
        return np.array(probs[:n].numpy(), np.float32)

    def classify_batch(self, crops, pad_to=None):
        """
        Classify a list of HWC uint8 crops (pre-resized or raw). Returns
        [N, num_classes] numpy probabilities.
        """

        return self.fetch_batch(self.classify_batch_async(
            crops, pad_to=pad_to))

    def top_k(self, probs, k=5):
        """[(class_id_str, conf), ...] descending, for one probs row."""

        order = np.argsort(-probs)[:k]
        return [[str(int(i)), float(probs[i])] for i in order]


def extract_crop(image_np, bbox_norm, expansion=0.0, square=False):
    """
    Extract a detection crop from an HWC image given a normalized MD bbox
    [x, y, w, h]. [expansion] grows the box by that fraction per side;
    [square] expands the short side to make the crop square. Returns the
    crop (may be empty for degenerate boxes).
    """

    img_h, img_w = image_np.shape[:2]
    x, y, w, h = bbox_norm
    x0 = x * img_w
    y0 = y * img_h
    x1 = (x + w) * img_w
    y1 = (y + h) * img_h

    if expansion > 0:
        dx = (x1 - x0) * expansion
        dy = (y1 - y0) * expansion
        x0 -= dx
        x1 += dx
        y0 -= dy
        y1 += dy

    if square:
        bw = x1 - x0
        bh = y1 - y0
        if bw > bh:
            pad = (bw - bh) / 2
            y0 -= pad
            y1 += pad
        else:
            pad = (bh - bw) / 2
            x0 -= pad
            x1 += pad

    x0 = int(max(0, np.floor(x0)))
    y0 = int(max(0, np.floor(y0)))
    x1 = int(min(img_w, np.ceil(x1)))
    y1 = int(min(img_h, np.ceil(y1)))
    return image_np[y0:y1, x0:x1]
