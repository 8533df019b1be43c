"""
The port's detector: preprocessing (the host letterbox, or the device
letterbox of ops/preprocess_device), the batched device program (/255 ->
forward -> candidate selection -> greedy NMS) and MD-format emission.
Counterpart of megadetector_tpu/models/detector.py TPUDetector.

The network follows the checkpoint's arch and model_type as the JAX
detector dispatches them: RF-DETR (models/rfdetr.py), DETR
(models/detr.py), the anchor-free YOLOv8 family of the MDv1000 models
(models/yolov8.py, model_type 'ultralytics'), else YOLOv5
(models/yolov5.py). Only YOLOv5 gets the fused decode, the width-fold
undoing, the fused stem and the int8 chain; the other families run the
decoded forward, then ops/nms.batched_nms. The letterbox stride is the
config's max_stride: 64 or 32 for YOLOv5, 32 for YOLOv8, patch x windows
for RF-DETR (56 for the published presets), the patch for DETR.

Float, int8-chain and int8 static-scale checkpoints load (quantized
checkpoints written width-folded by the JAX package are unfolded on load),
and compute in float32 or bf16 (dtype): bf16 casts the float layers (all
of a float checkpoint; l0 and the detect heads of a chain one; every conv
a static one keeps float, whose int8 convs then give bf16 outputs) as the
JAX detector does, and outside the strict modes runs l0 as the fused stem kernel from
the uint8 pixels. conv_backend picks how the int8 chain's bottlenecks run:
'xla' (default) runs each of their convs on the int8 conv kernel, 'pallas'
(and 'pallas-interpret', the same output) runs each bottleneck as the
fused bottleneck kernel.

preprocess_mode='device' (classic modes) ships each image as raw uint8 in
a staging canvas and letterboxes the batch on the device; l0 then takes
the letterbox's float output through the plain conv, as in the JAX
program. A batch whose images already equal the canvas takes the identity
path (slice + normalize), bit-identical to the letterbox at ratio 1.

The device program has the two branches of the JAX program:
- default ('classic' / 'modern'): raw heads -> ops/decode
  select_topk_candidates -> ops/nms nms_on_candidates;
- 'classic-strict': decoded forward -> ops/nms batched_nms.
Both end in the greedy NMS kernel (ops/cuda_nms) when the detector runs on
a CUDA device.

Candidate capacity escalates like the JAX detector's (pre_nms_topk, then
doubling up to max_pre_nms_topk) when more candidates pass the floor than
the selection holds; the escalation reuses the forward's head tensors and
redoes only selection and NMS.

Each of these is a program of models/program_cache (the JAX detector's
per-shape compiled programs): the forward per (batch, canvas), selection
+ NMS per (batch, canvas, capacity, thresholds), the device-preprocess
forward per staging shape, canvas and identity, the augment program per
(batch, canvas, thresholds). On the card each is captured into a CUDA
graph at its second call and replayed after that, its batch copied in
from a pinned buffer; on the CPU they run eagerly. Setting the private
_cuda_graphs attribute false runs them eagerly on the card too (the tests
hold replay against eager that way); it is not a detector option.

augment=True runs the reference's test-time augmentation (tta_passes,
_tta_transform_input, tta_concatenated_predictions; host preprocessing
only): three passes at scales 1, 0.83 (flipped) and 0.67, merged before
one NMS, with no capacity escalation.
"""

import math
import os
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.device import get_device, set_float32_exact
from megadetector_tpu_torch.models import detr, rfdetr, yolov5, yolov8
from megadetector_tpu_torch.models.convert_weights import (
    load_checkpoint, unfold_early_params)
from megadetector_tpu_torch.models.program_cache import ProgramCache
from megadetector_tpu_torch.ops import boxes as box_ops
from megadetector_tpu_torch.ops._build import KernelError
from megadetector_tpu_torch.ops.conv_int8 import scalar_like
from megadetector_tpu_torch.ops.decode import (merge_candidates,
                                               select_topk_candidates)
from megadetector_tpu_torch.ops.nms import batched_nms, nms_on_candidates
from megadetector_tpu_torch.ops.preprocess_device import (letterbox_batch,
                                                          stage_images)
from megadetector_tpu_torch.utils import ct_utils

# Failure strings and output precision: part of the MD output contract
FAILURE_INFER = 'inference failure'
FAILURE_IMAGE_OPEN = 'image access failure'
CONF_DIGITS = 3
COORD_DIGITS = 4

DEFAULT_DETECTOR_LABEL_MAP = {
    '1': 'animal',
    '2': 'person',
    '3': 'vehicle',
}

# Failure containment exists for DATA errors (corrupt images, a device
# fault on one batch). Bug-shaped exceptions re-raise under pytest or
# MD_STRICT_FAILURES; kernel build and launch failures always re-raise,
# never becoming per-image 'inference failure' records.
PROGRAMMING_ERRORS = (AttributeError, NameError, UnboundLocalError,
                      ImportError)
ALWAYS_RERAISED = (KernelError, NotImplementedError)

# Options of the JAX detector that leave output unchanged (TPU layout and
# schedule choices); accepted and ignored. use_mesh is the JAX driver's
# (it splits batches over local devices): one card here
NO_OP_OPTIONS = ('folded_early', 'folded_h2', 'approx_select', 'select_cm',
                 'stem_gemm', 'bottleneck_variant', 'use_mesh')

CONV_BACKENDS = ('xla', 'pallas', 'pallas-interpret')

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
          'bf16': torch.bfloat16}

PARSED_OPTIONS = ('compatibility_mode', 'canvas_mode', 'max_canvases',
                  'image_size', 'pre_nms_topk', 'max_det',
                  'auto_escalate_topk', 'max_pre_nms_topk',
                  'pad_batches_to', 'use_model_native_classes', 'dtype',
                  'force_cpu', 'preprocess_mode', 'staging_multiple',
                  'max_staging_side', 'bf16_resize', 'conv_backend', 'mesh',
                  'xla_compiler_options', 'arch', 'fused_decode',
                  'preprocess_only', 'batch_axis')


def is_device_fault(e):
    """
    True for an exception that no driver may contain as a per-image, per
    tile or per-video failure record: a kernel's build or launch failure
    (KernelError), an option not ported (NotImplementedError), an error
    that the CUDA runtime raised, or the card's memory running out. Such
    a fault is the program's or the card's, never the data's.
    """

    if isinstance(e, ALWAYS_RERAISED + (torch.cuda.OutOfMemoryError,)):
        return True
    accelerator_error = getattr(torch, 'AcceleratorError', None)
    if accelerator_error is not None and isinstance(e, accelerator_error):
        return True
    return isinstance(e, RuntimeError) and 'CUDA error' in str(e)


def reraise_programming_errors():
    """True when containment should let bug-shaped exceptions surface:
    under pytest, or when MD_STRICT_FAILURES is set non-false."""

    if os.environ.get('PYTEST_CURRENT_TEST'):
        return True
    return os.environ.get('MD_STRICT_FAILURES', '').lower() \
        not in ('', '0', 'false')


def _to_bool(v):
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ('true', '1', 'yes'):
        return True
    if s in ('false', '0', 'no', ''):
        return False
    raise ValueError('Unrecognized boolean option value {!r}; use '
                     'true/false'.format(v))


def _check_options(options):
    """Raise on options this slice does not run, or does not know."""

    unknown = sorted(set(options) - set(PARSED_OPTIONS) -
                     set(NO_OP_OPTIONS))
    if unknown:
        raise ValueError('Unknown detector options {}; this detector takes '
                         '{}'.format(unknown, sorted(PARSED_OPTIONS +
                                                     NO_OP_OPTIONS)))
    if str(options.get('conv_backend', 'xla')).lower() not in CONV_BACKENDS:
        raise ValueError('conv_backend must be one of {}, got {!r}'.format(
            CONV_BACKENDS, options['conv_backend']))
    if str(options.get('dtype', 'float32')) not in DTYPES:
        raise ValueError('dtype must be one of {}, got {!r}'.format(
            sorted(DTYPES), options['dtype']))
    if options.get('preprocess_mode', 'host') not in ('host', 'device'):
        raise ValueError('preprocess_mode must be host or device, got '
                         '{!r}'.format(options['preprocess_mode']))
    refused = []
    if options.get('mesh') is not None:
        refused.append('mesh')
    if options.get('batch_axis') is not None:
        refused.append('batch_axis')
    if options.get('xla_compiler_options'):
        refused.append('xla_compiler_options')
    if refused:
        raise NotImplementedError(
            'Not ported to PyTorch: {}'.format(', '.join(refused)))


def model_config(arch, model_type, metadata):
    """
    The network config for a checkpoint's [arch] and [model_type], as the
    JAX TPUDetector dispatches: an 'rfdetr' arch, or model_type 'rfdetr'
    without a 'detr' arch, is RF-DETR (rfdetr_base unless the arch names
    one; image_size from the metadata, default 560); a 'detr' arch or
    model_type 'detr' is DETR (detr_base unless named); a 'yolov8' arch
    or model_type 'ultralytics' is YOLOv8; anything else YOLOv5 (with the
    metadata's anchors).
    """

    num_classes = int(metadata.get('num_classes', 3))
    if arch.startswith('rfdetr') or (model_type == 'rfdetr' and
                                     not arch.startswith('detr')):
        return rfdetr.RFDetrConfig(
            arch if arch.startswith('rfdetr') else 'rfdetr_base',
            num_classes=num_classes,
            image_size=int(metadata.get('image_size', 560)))
    if arch.startswith('detr') or model_type == 'detr':
        return detr.DetrConfig(arch if arch.startswith('detr')
                               else 'detr_base', num_classes=num_classes)
    if arch.startswith('yolov8') or model_type == 'ultralytics':
        return yolov8.YoloV8Config(arch, num_classes=num_classes)
    return yolov5.YoloV5Config(arch, num_classes=num_classes,
                               anchors=metadata.get('anchors', None))


# The network of each config but YOLOv5's
NETWORKS = {rfdetr.RFDetrConfig: rfdetr.RFDetr, detr.DetrConfig: detr.Detr,
            yolov8.YoloV8Config: yolov8.YoloV8}


class TorchDetector:
    """
    Detector on PyTorch for every family model_config dispatches
    (YOLOv5, YOLOv8, RF-DETR, DETR). Loads converted checkpoints (.npz +
    metadata, or a folder with weights.npz + metadata.json).

    Options (a dict, the JAX detector's names):
        compatibility_mode: 'classic' (default), 'modern', or a '-strict'
            variant (decoded forward + batched_nms)
        canvas_mode: 'auto' (default; minimal stride-rectangle canvases,
            shape-grouped batches) or 'square'
        max_canvases: distinct auto canvases before falling back to square
        image_size: override the checkpoint's inference canvas
        pre_nms_topk / max_pre_nms_topk / auto_escalate_topk: candidate
            capacity, its escalation ceiling, and whether to escalate
        max_det: detections kept per image
        pad_batches_to: pad partial batches (repeating the last image)
        use_model_native_classes: emit 0-based model classes
        dtype: 'float32' (default) or 'bfloat16' / 'bf16' (the float
            layers; an int8 checkpoint's chain stays int8)
        force_cpu: run on the CPU (the default device is the card)
        preprocess_mode: 'host' (default; letterbox on the host) or
            'device' (classic modes: letterbox on the device from uint8
            staging canvases; other modes letterbox on the host)
        staging_multiple: staging canvas sides round up to this (256)
        max_staging_side: images longer than this are shrunk on the host
            before staging (4096)
        bf16_resize: with dtype bf16 outside the strict modes, round the
            device letterbox's matmul operands to bf16 (default true)
        conv_backend: 'xla' (default; int8 bottleneck convs on the conv
            kernel) or 'pallas' / 'pallas-interpret' (int8 bottlenecks on
            the fused bottleneck kernel where its tiling takes the shape);
            no effect on float checkpoints
        arch: override the checkpoint metadata's architecture
        fused_decode: YOLOv5 only: select candidates from the raw head
            logits (default true outside the strict modes) or from the
            decoded forward (then batched_nms); the other families always
            run the decoded forward
        preprocess_only: build without weights and without a device, for
            preprocessing only (loader workers): preprocess_image works,
            image_size comes from the options (default 1280) and the
            stride is 64; inference raises RuntimeError
    Accepted as no-ops: folded_early, folded_h2, approx_select, select_cm,
    stem_gemm, bottleneck_variant, use_mesh. Refused
    (NotImplementedError): mesh and
    batch_axis (multi-card) and xla_compiler_options. augment=True at
    inference needs preprocess_mode host and a YOLOv5 or YOLOv8 model
    (ValueError).

    preprocess_image may be called from many threads at once (the batch
    driver's loader threads): the auto-canvas guard is locked, and
    repreprocess_on_square_canvas passes its canvas mode down instead of
    changing the detector's.
    """

    def __init__(self, model_path, detector_options=None, verbose=False,
                 device=None):

        options = dict(detector_options or {})
        _check_options(options)
        self.preprocess_only = _to_bool(options.get('preprocess_only',
                                                    False))
        if _to_bool(options.get('force_cpu', False)):
            device = 'cpu'
        self.device = None if self.preprocess_only else get_device(device)
        if self.device is not None and self.device.type == 'cuda':
            set_float32_exact()

        self.compatibility_mode = options.get('compatibility_mode',
                                              'classic') or 'classic'
        self.use_model_native_classes = _to_bool(
            options.get('use_model_native_classes', False))
        self.pre_nms_topk = int(options.get('pre_nms_topk', 512))
        self.max_det = int(options.get('max_det', 300))
        self.auto_escalate_topk = _to_bool(
            options.get('auto_escalate_topk', True))
        self.max_pre_nms_topk = int(options.get('max_pre_nms_topk', 8192))
        pad = options.get('pad_batches_to', None)
        self.pad_batches_to = int(pad) if pad else None
        self.canvas_mode = options.get('canvas_mode', 'auto')
        if self.canvas_mode not in ('auto', 'square'):
            raise ValueError('canvas_mode must be auto or square, got '
                             '{}'.format(self.canvas_mode))
        self.max_canvases = int(options.get('max_canvases', 16))
        self._auto_canvases = set()
        self._auto_canvases_lock = threading.Lock()
        self.preprocess_mode = options.get('preprocess_mode', 'host')
        self.staging_multiple = int(options.get('staging_multiple', 256))
        self.max_staging_side = int(options.get('max_staging_side', 4096))
        self.compute_dtype = DTYPES[str(options.get('dtype', 'float32'))]
        strict = 'strict' in self.compatibility_mode
        # bf16 interpolation operands for the device letterbox: a bf16
        # forward rounds its input to bf16 anyway; never in strict modes
        self.resize_dtype = torch.bfloat16 if (
            self.compute_dtype == torch.bfloat16 and not strict and
            _to_bool(options.get('bf16_resize', True))) else None
        self._warned_low_threshold_topk = False
        self.n_truncated_images = 0
        # Device program executions (one per batch; escalation re-runs
        # selection and NMS inside the same execution), and how many of
        # them took the device-preprocess identity path
        self.programs_run = 0
        self.identity_programs_run = 0
        # Device -> host reads of program outputs (escalation's
        # n_candidates, each program's final outputs)
        self.host_reads = 0
        self.printed_image_size_warning = False
        # The checkpoint's metadata and class names (the serving daemon's
        # model info), as the JAX detector holds them
        self.metadata = None
        self.class_names = ['animal', 'person', 'vehicle']
        if self.preprocess_only:
            self.letterbox_stride = 64
            self.default_image_size = int(options.get('image_size', 1280))
            print('TorchDetector: preprocess only (no weights, no device)')
            return
        self._programs = ProgramCache(self.device)
        self._cuda_graphs = self.device.type == 'cuda'
        self._load_model(model_path, options, verbose)
        print('{} using device {}'.format(type(self).__name__, self.device))

    def _load_model(self, model_path, options, verbose):
        """The network and its checkpoint's metadata: sets model, config,
        model_type, conv_backend, _fused_decode, letterbox_stride,
        default_image_size, metadata and class_names."""

        strict = 'strict' in self.compatibility_mode
        start = time.time()
        params, metadata = load_checkpoint(model_path)
        metadata = metadata or {}
        arch = options.get('arch', metadata.get('arch', 'yolov5l6'))
        self.model_type = metadata.get('model_type', 'yolov5')
        self.config = model_config(arch, self.model_type, metadata)
        self.conv_backend = str(options.get('conv_backend',
                                            'xla')).lower()
        if isinstance(self.config, yolov5.YoloV5Config):
            params = unfold_early_params(params, self.config)
            # bf16 outside the strict modes runs l0 as the fused stem;
            # strict modes keep the JAX graph (bf16(u8 / 255) into the
            # plain conv)
            model = yolov5.YoloV5(
                self.config,
                fuse_bottlenecks=self.conv_backend != 'xla').load_params(
                    params).set_compute_dtype(self.compute_dtype,
                                              fused_stem=not strict)
            # Fused selection from raw head logits; strict modes run the
            # decoded forward + batched_nms instead, unless the option
            # says
            self._fused_decode = _to_bool(options.get('fused_decode',
                                                      not strict))
        else:
            model = NETWORKS[type(self.config)](self.config).load_params(
                params).set_compute_dtype(self.compute_dtype)
            self._fused_decode = False
        self.model = model.eval().to(self.device)
        self.letterbox_stride = int(self.config.max_stride)
        self.default_image_size = int(options.get(
            'image_size', metadata.get('image_size', 1280)))
        self.metadata = metadata
        self.class_names = metadata.get(
            'class_names', ['animal', 'person', 'vehicle'][
                :self.config.num_classes])
        if verbose:
            print('Loaded model in {:.2f}s'.format(time.time() - start))

    #%% Preprocessing

    def _auto_target_shape(self, shape_hw, image_size, scaleup=True):
        return box_ops.auto_target_shape(
            shape_hw, image_size, stride=self.letterbox_stride,
            scaleup=scaleup)

    def _use_auto_canvas(self, shape_hw, image_size, scaleup, canvas_mode):
        """True when this image letterboxes onto its minimal
        stride-rectangle; False when [canvas_mode] is 'square' or once
        max_canvases distinct rectangles are in use. The check and the
        admission are one locked step, so loader threads never admit more
        than max_canvases."""

        if canvas_mode != 'auto':
            return False
        t = self._auto_target_shape(shape_hw, image_size, scaleup)
        if t == (image_size, image_size):
            return True
        with self._auto_canvases_lock:
            if t in self._auto_canvases:
                return True
            if len(self._auto_canvases) >= self.max_canvases:
                return False
            self._auto_canvases.add(t)
            return True

    def preprocess_image(self, img_original, image_id='unknown',
                         image_size=None, verbose=False):
        """
        Letterbox an image (PIL or HWC uint8 numpy, RGB, EXIF-rotated)
        onto its inference canvas. Returns a dict with the uint8 canvas
        ('img_processed') and the geometry that maps boxes back. In device
        preprocess mode (classic modes) 'img_processed' is None: the dict
        carries the raw image ('img_original', shrunk to max_staging_side),
        its canvas ('target_shape') and 'scale_target', and the batch
        letterboxes on the device. Safe to call from many threads.
        """

        return self._preprocess(img_original, image_id, image_size,
                                self.canvas_mode)

    def _preprocess(self, img_original, image_id, image_size, canvas_mode):
        """preprocess_image under [canvas_mode] ('auto' or 'square')."""

        result = {'file': image_id}
        img_original_pil = None
        if not isinstance(img_original, np.ndarray):
            img_original_pil = img_original
            img_original = np.asarray(img_original)
        scaling_shape = img_original.shape

        if image_size is not None:
            if not isinstance(image_size, int):
                raise TypeError('image_size must be an int')
            if not self.printed_image_size_warning:
                print('Using user-supplied image size {}'.format(image_size))
                self.printed_image_size_warning = True
        else:
            image_size = self.default_image_size
            self.printed_image_size_warning = False

        if self.preprocess_mode == 'device' and \
                'classic' in self.compatibility_mode:
            # The letterbox runs on the device: record the raw image and
            # its canvas (the classic host letterbox's geometry). Images
            # longer than max_staging_side are shrunk here first; the
            # normalized output coordinates do not depend on the scale.
            original_shape = img_original.shape
            if max(img_original.shape[:2]) > self.max_staging_side:
                img_original, _ = box_ops.resize_long_side(
                    img_original, self.max_staging_side)
                scaling_shape = img_original.shape
            if self._use_auto_canvas(img_original.shape[:2], image_size,
                                     True, canvas_mode):
                target = self._auto_target_shape(img_original.shape[:2],
                                                 image_size)
            else:
                target = (image_size, image_size)
            result.update({
                'img_processed': None, 'img_original': img_original,
                'img_original_pil': img_original_pil,
                'target_shape': target, 'scale_target': image_size,
                'scaling_shape': scaling_shape,
                'original_shape': original_shape,
                'letterbox_ratio': None, 'letterbox_pad': None})
            return result

        if 'classic' in self.compatibility_mode:
            auto = self._use_auto_canvas(img_original.shape[:2],
                                         image_size, True, canvas_mode)
            img, ratio, pad = box_ops.letterbox(
                img_original, new_shape=(image_size, image_size),
                stride=self.letterbox_stride, auto=auto, scaleup=True)
        else:
            use_ceil = 'use_ceil_for_resize' in self.compatibility_mode
            img_resized, _ = box_ops.resize_long_side(
                img_original, image_size, use_ceil=use_ceil)
            auto = self._use_auto_canvas(img_resized.shape[:2],
                                         image_size, False, canvas_mode)
            img, ratio, pad = box_ops.letterbox(
                img_resized, new_shape=(image_size, image_size),
                stride=self.letterbox_stride, auto=auto, scaleup=False)
            img_original = img_resized

        result['img_processed'] = img
        result['img_original'] = img_original
        result['img_original_pil'] = img_original_pil
        result['target_shape'] = img.shape[:2]
        result['scaling_shape'] = scaling_shape
        result['letterbox_ratio'] = ratio
        result['letterbox_pad'] = pad
        return result

    def repreprocess_on_square_canvas(self, info, image_size=None):
        """Re-letterbox a preprocessed image onto the square canvas (the
        batch runner merges small tail buckets this way), leaving the
        detector's canvas mode alone: loader threads may be letterboxing
        meanwhile. None when the original pixels are gone (the native
        loader's images)."""

        source = info.get('img_original_pil')
        if source is None:
            source = info.get('img_original')
        if source is None:
            return None
        new_info = self._preprocess(source, info.get('file', 'unknown'),
                                    image_size, 'square')
        # Loader-attached fields (EXIF) carry over
        for key, value in info.items():
            if key not in new_info:
                new_info[key] = value
        return new_info

    #%% Device program

    def run_program(self, batch_u8, conf_thres, iou_thres, augment=False):
        """
        The device program on one uint8 NHWC batch [B, H, W, 3] of
        letterboxed canvases, with capacity escalation (none under
        [augment], the test-time augmentation program). Returns (numpy
        dict of 'boxes' [B, max_det, 4] xyxy canvas pixels, 'scores',
        'classes', 'valid', and without augment 'n_candidates'; the
        capacity finally used).
        """

        if augment:
            self._check_augment()
        batch = np.ascontiguousarray(batch_u8, dtype=np.uint8)
        b, h, w = batch.shape[:3]
        with torch.inference_mode():
            if augment:
                key = ('augment', b, h, w, self._fused_decode,
                       float(conf_thres), float(iou_thres))
                out, _ = self._programs.run(
                    key, lambda x: self._augment_program(
                        x, h, w, conf_thres, iou_thres),
                    host_inputs=(batch,), graphs=self._cuda_graphs)
                self.programs_run += 1
                return self._read_outputs(out), self.pre_nms_topk
            return self._program(('forward', b, h, w), (batch,),
                                 self._forward, conf_thres, iou_thres)

    def _check_augment(self):
        """Raise ValueError where augment=True cannot run: device
        preprocessing, or a query-output family (RF-DETR, DETR), whose
        rows the reference's per-level clipping would cut as if they were
        detect levels (a fault of the JAX detector, ROADMAP C)."""

        if self.preprocess_mode == 'device':
            raise ValueError(
                'augment=True requires preprocess_mode=host (TTA rescales '
                'the letterboxed canvas, which device mode computes '
                'in-program)')
        # Level clipping needs rows ordered by detect level
        if not isinstance(self.config, (yolov5.YoloV5Config,
                                        yolov8.YoloV8Config)):
            raise ValueError(
                'augment=True is not supported for {} ({}): test-time '
                'augmentation clips detect levels, and this family emits '
                'query rows'.format(self.config.arch, self.model_type))

    def run_program_staged(self, staged_u8, sizes, canvas_hw, scale_target,
                           identity, conf_thres, iou_thres):
        """
        The device-preprocess program: uint8 staging canvases [B, S0h,
        S0w, 3] with valid sizes [B, 2] -> the device letterbox onto
        canvas_hw (or, with [identity], the slice + normalize of images
        that already equal the canvas) -> run_program's forward,
        selection and NMS. Same return as run_program.
        """

        h, w = int(canvas_hw[0]), int(canvas_hw[1])
        staged = np.ascontiguousarray(staged_u8, dtype=np.uint8)
        sizes = np.ascontiguousarray(sizes, dtype=np.int32)

        def forward(staged, sizes):
            if identity:
                x = staged[:, :h, :w, :].to(torch.float32) / \
                    torch.full((), 255.0, device=staged.device)
            else:
                x = letterbox_batch(staged, sizes, (h, w),
                                    scale_target=scale_target,
                                    resize_dtype=self.resize_dtype)
            return self._forward(x)

        key = ('device_preprocess',) + staged.shape + (
            h, w, int(scale_target), bool(identity))
        with torch.inference_mode():
            return self._program(key, (staged, sizes), forward, conf_thres,
                                 iou_thres)

    def _forward(self, x):
        """The network on one batch: raw heads (fused selection) or the
        decoded predictions, as a tuple of tensors."""

        if self._fused_decode:
            return tuple(self.model(x, decode=False))
        return (self.model(x, decode=True),)

    def _select_and_suppress(self, capacity, conf_thres, iou_thres,
                             *forward_out):
        config = self.config
        if self._fused_decode:
            cands = select_topk_candidates(
                list(forward_out), config.anchors, config.strides,
                config.num_classes, conf_thres, capacity)
            return nms_on_candidates(
                cands, iou_thres, max_det=self.max_det,
                class_agnostic=(config.num_classes == 1))
        return batched_nms(forward_out[0], conf_thres, iou_thres,
                           max_det=self.max_det, pre_nms_topk=capacity)

    def _program(self, key, host_inputs, forward, conf_thres, iou_thres):
        """
        Forward, then selection + NMS at the capacity, each a program of
        the cache (the forward per (batch, canvas), selection + NMS per
        (batch, canvas, capacity, thresholds) on the forward's outputs).
        Capacity escalation reads n_candidates alone; the outputs are read
        to the host once, at the end. Inside inference_mode.
        """

        key = key + (self._fused_decode,)
        forward_out, static = self._programs.run(
            key, forward, host_inputs=host_inputs, graphs=self._cuda_graphs)

        def select_and_suppress(capacity):
            return self._run_select(key, capacity, conf_thres, iou_thres,
                                    forward_out, static)

        topk = self.pre_nms_topk
        out = select_and_suppress(topk)
        # More above-floor candidates than the capacity holds: redo
        # selection + NMS at the next power of two (up to
        # max_pre_nms_topk), like the reference's uncapped nms(). The
        # count does not depend on the capacity, so one step suffices.
        if self.auto_escalate_topk and topk < self.max_pre_nms_topk:
            needed = int(self._read_host(out['n_candidates']).max(initial=0))
            if needed > topk:
                new_topk = topk
                while new_topk < needed:
                    new_topk *= 2
                topk = self._effective_topk(min(new_topk,
                                                self.max_pre_nms_topk))
                out = select_and_suppress(topk)
        self.programs_run += 1
        return self._read_outputs(out), topk

    def _run_select(self, key, capacity, conf_thres, iou_thres, forward_out,
                    static):
        """Selection + NMS at [capacity] on the forward's outputs, a
        program per (forward key, capacity, thresholds)."""

        out, _ = self._programs.run(
            key + ('select', capacity, float(conf_thres), float(iou_thres)),
            lambda *f: self._select_and_suppress(capacity, conf_thres,
                                                 iou_thres, *f),
            device_inputs=forward_out, graphs=self._cuda_graphs,
            capture=static)
        return out

    def _effective_topk(self, topk):
        """The capacity an escalation to [topk] runs at: [topk] itself
        (an exported artifact rounds it up to its capacity ladder)."""

        return topk

    def _augment_program(self, images_u8, height, width, conf_thres,
                         iou_thres):
        """
        The test-time augmentation program (the JAX detector's
        _get_compiled_augment): the reference's three passes (tta_passes)
        over the canvas; pass 1 takes the uint8 canvas (the fused stem
        where the model has one), the scaled passes the float canvas.
        Fused: each pass's heads select candidates over its clipped
        levels, boxes de-scaled and de-flipped, all merged before one NMS.
        Unfused: tta_concatenated_predictions, then batched_nms. No
        capacity escalation.
        """

        config = self.config
        dtype = self.compute_dtype
        stride = int(self.letterbox_stride)
        nl = int(getattr(self, '_tta_nl', len(config.strides)))
        if not self._fused_decode:
            pred = tta_concatenated_predictions(
                config, self.model, images_u8, height, width, stride, dtype,
                nl=nl)
            return batched_nms(pred, conf_thres, iou_thres,
                               max_det=self.max_det,
                               pre_nms_topk=self.pre_nms_topk)

        passes = tta_passes(height, width, stride)
        x = _tta_float_input(images_u8, dtype)
        cands = []
        for i_pass, (s, flip, sh, sw, ph, pw) in enumerate(passes):
            xi = images_u8 if i_pass == 0 else _tta_transform_input(
                x, height, width, s, flip, sh, sw, ph, pw, dtype)
            heads = self.model(xi, decode=False)
            # _clip_augmented at the head level: skip the coarsest level
            # on the unscaled pass, the finest on the most-scaled pass
            lvl = _tta_level_slice(i_pass, len(passes), nl)
            c = select_topk_candidates(
                heads[lvl], config.anchors[lvl], config.strides[lvl],
                config.num_classes, conf_thres, self.pre_nms_topk)
            bx = c['boxes_cxcywh'] / scalar_like(s, c['boxes_cxcywh'])
            if flip:
                bx = torch.stack([width - bx[..., 0], bx[..., 1],
                                  bx[..., 2], bx[..., 3]], dim=-1)
            cands.append(dict(c, boxes_cxcywh=bx))
        return nms_on_candidates(
            merge_candidates(cands, self.pre_nms_topk), iou_thres,
            max_det=self.max_det, class_agnostic=(config.num_classes == 1))

    def _read_host(self, tensor):
        """One device -> host read (counted in host_reads)."""

        self.host_reads += 1
        return tensor.cpu().numpy()

    def _read_outputs(self, out):
        """The program's outputs as numpy arrays: one host read."""

        self.host_reads += 1
        return {k: v.cpu().numpy() for k, v in out.items()}

    #%% Inference

    def generate_detections_one_image(self, img_original,
                                      image_id='unknown',
                                      detection_threshold=0.00001,
                                      image_size=None, augment=False,
                                      verbose=False):
        """Run detection on one image; returns an MD-format image dict."""

        return self.generate_detections_one_batch(
            [img_original], [image_id],
            detection_threshold=detection_threshold,
            image_size=image_size, augment=augment, verbose=verbose)[0]

    def generate_detections_one_batch(self, img_originals, image_ids=None,
                                      detection_threshold=0.00001,
                                      image_size=None, augment=False,
                                      verbose=False):
        """
        Run detection on a batch of images (PIL images, numpy arrays, or
        dicts from preprocess_image). Returns MD-format image dicts with
        'file', 'detections', 'max_detection_conf' (or 'failure').
        """

        if self.preprocess_only:
            raise RuntimeError('This detector was built with '
                               'preprocess_only=true: it has no weights and '
                               'runs no inference')
        if augment:
            self._check_augment()
        if image_ids is None:
            image_ids = ['unknown'] * len(img_originals)
        if len(img_originals) != len(image_ids):
            raise ValueError('{} images but {} ids'.format(
                len(img_originals), len(image_ids)))

        results = [None] * len(img_originals)
        infos = []
        for idx, (img, image_id) in enumerate(zip(img_originals,
                                                  image_ids)):
            if isinstance(img, dict):
                info = dict(img)
                if image_id is not None and image_id != 'unknown':
                    info['file'] = image_id
                infos.append((idx, info))
                continue
            if img is not None:
                try:
                    infos.append((idx, self.preprocess_image(
                        img, image_id=image_id, image_size=image_size)))
                    continue
                except Exception as e:
                    if verbose:
                        print('Preprocess error for {}: {}'.format(
                            image_id, e))
            results[idx] = {'file': image_id, 'detections': None,
                            'failure': FAILURE_IMAGE_OPEN}

        # One device program per canvas shape (shape-grouped batching)
        groups = {}
        for item in infos:
            shape = tuple(item[1].get('target_shape') or (0, 0))
            groups.setdefault(shape, []).append(item)

        for group in groups.values():
            try:
                self._run_batch(group, results, detection_threshold,
                                augment=augment)
            except Exception as e:
                if is_device_fault(e) or (
                        isinstance(e, PROGRAMMING_ERRORS) and
                        reraise_programming_errors()):
                    raise
                print('Inference failure on batch of {}: {}'.format(
                    len(group), e))
                if verbose:
                    import traceback
                    traceback.print_exc()
                for idx, info in group:
                    results[idx] = {'file': info['file'],
                                    'detections': None,
                                    'failure': FAILURE_INFER}
        return results

    def _run_batch(self, infos, results, detection_threshold,
                   augment=False):
        """Stack preprocessed images, run the device program, emit dicts."""

        nms_iou = 0.45 if 'classic' in self.compatibility_mode else 0.6

        if detection_threshold < 0.005 and self.pre_nms_topk < 2048 and \
                not self.auto_escalate_topk and \
                not self._warned_low_threshold_topk:
            print('Warning: detection_threshold {} is very low but '
                  'pre_nms_topk is {}; detections beyond the top {} '
                  'candidates per image will be dropped (set the '
                  'pre_nms_topk detector option to keep more)'.format(
                      detection_threshold, self.pre_nms_topk,
                      self.pre_nms_topk))
            self._warned_low_threshold_topk = True

        # Pad partial batches by repeating the last image; padded slots
        # carry idx None and are dropped below
        n_real = len(infos)
        if self.pad_batches_to is not None and \
                n_real < self.pad_batches_to:
            infos = list(infos) + \
                [(None, infos[-1][1])] * (self.pad_batches_to - n_real)

        staged = [info.get('img_processed') is None for _, info in infos]
        if any(staged) != all(staged):
            raise ValueError('Staged (device-preprocess) and letterboxed '
                             'images in one batch')
        if all(staged):
            h, w = (int(v) for v in infos[0][1]['target_shape'])
            scale_target = int(infos[0][1].get('scale_target', max(h, w)))
            raw = [np.asarray(info['img_original']) for _, info in infos]
            if any(tuple(info['target_shape']) != (h, w)
                   for _, info in infos):
                raise ValueError('Heterogeneous canvas in one batch')
            staged_u8, sizes = stage_images(raw,
                                            multiple=self.staging_multiple)
            # Identity path: every image already equals the canvas, so the
            # ratio is exactly 1 (T = max(canvas)) and the letterbox is a
            # copy; slice + normalize gives the same bits
            identity = scale_target == max(h, w) and \
                all(im.shape[:2] == (h, w) for im in raw)
            self.identity_programs_run += int(identity)
            out, topk = self.run_program_staged(
                staged_u8, sizes, (h, w), scale_target, identity,
                detection_threshold, nms_iou)
        else:
            imgs = [info['img_processed'] for _, info in infos]
            h, w = imgs[0].shape[:2]
            for im in imgs:
                if im.shape[:2] != (h, w):
                    raise ValueError('Heterogeneous canvas in one batch')
            out, topk = self.run_program(np.stack(imgs).astype(np.uint8),
                                         detection_threshold, nms_iou,
                                         augment=augment)
        # TTA counts the same objects once per pass, so the overflow
        # indicator applies to single-pass runs only
        n_cand = None if augment else out['n_candidates']

        for slot, (idx, info) in enumerate(infos):
            if idx is None:
                continue
            valid = out['valid'][slot]
            boxes = np.asarray(out['boxes'][slot][valid], np.float64)
            scores = np.asarray(out['scores'][slot][valid], np.float64)
            classes = np.asarray(out['classes'][slot][valid])

            scaling_shape = info['scaling_shape']
            detections = []
            max_conf = 0.0

            if boxes.shape[0] > 0:
                if 'classic' in self.compatibility_mode:
                    ratio_pad = None
                    img_orig = info.get('img_original')
                    img0_shape = img_orig.shape if img_orig is not None \
                        else scaling_shape
                else:
                    img_orig = info['img_original']
                    ratio = (img_orig.shape[0] / scaling_shape[0],
                             img_orig.shape[1] / scaling_shape[1])
                    ratio_pad = (ratio, info['letterbox_pad'])
                    img0_shape = scaling_shape

                boxes = box_ops.scale_coords(
                    (h, w), boxes, img0_shape, ratio_pad).round()
                gn = np.array([scaling_shape[1], scaling_shape[0],
                               scaling_shape[1], scaling_shape[0]],
                              dtype=np.float64)

                # The reference emits detections in reversed prediction
                # order, i.e. ascending confidence
                for i in reversed(range(boxes.shape[0])):
                    conf = float(scores[i])
                    if conf < detection_threshold:
                        continue
                    xywh = (box_ops.xyxy2xywh(boxes[i:i + 1]) / gn)[0]
                    api_box = ct_utils.convert_yolo_to_xywh(list(xywh))
                    if 'classic' in self.compatibility_mode:
                        api_box = ct_utils.truncate_float_array(
                            api_box, precision=COORD_DIGITS)
                        conf = ct_utils.truncate_float(
                            conf, precision=CONF_DIGITS)
                    else:
                        api_box = ct_utils.round_float_array(
                            api_box, precision=COORD_DIGITS)
                        conf = ct_utils.round_float(
                            conf, precision=CONF_DIGITS)

                    if self.use_model_native_classes:
                        cls = int(classes[i])
                    else:
                        cls = int(classes[i]) + 1
                        if cls not in (1, 2, 3):
                            raise KeyError(
                                '{} is not a valid class.'.format(cls))
                    detections.append({'category': str(cls),
                                       'conf': conf,
                                       'bbox': api_box})
                    max_conf = max(max_conf, conf)

            results[idx] = {'file': info['file'],
                            'detections': detections,
                            'max_detection_conf': max_conf}

            # A count still above the final capacity means the tail was
            # truncated relative to the reference's uncapped nms()
            if n_cand is not None and int(n_cand[slot]) > topk:
                results[idx]['pre_nms_truncation'] = int(n_cand[slot])
                self.n_truncated_images += 1
                if self.n_truncated_images <= 3:
                    print('Warning: image {} had {} candidates above the '
                          'confidence floor but the candidate capacity is '
                          '{}; lowest-confidence detections were dropped '
                          '(raise the max_pre_nms_topk detector option to '
                          'keep them)'.format(info['file'],
                                              int(n_cand[slot]), topk))


#%% Test-time augmentation


def tta_passes(height, width, stride):
    """The reference TTA pass table (scale, flip, scaled_h, scaled_w,
    padded_h, padded_w): (1, no), (0.83, hflip), (0.67, no), scaled
    dims int()-floored and padded up to the next stride multiple
    (yolov5 forward_augment + scale_img)."""

    passes = [(1.0, False, height, width, height, width)]
    for s, flip in ((0.83, True), (0.67, False)):
        sh, sw = int(height * s), int(width * s)
        ph = int(math.ceil(sh / stride) * stride)
        pw = int(math.ceil(sw / stride) * stride)
        passes.append((s, flip, sh, sw, ph, pw))
    return passes


def _tta_float_input(images_u8, dtype):
    """The uint8 canvas as [dtype] values in [0, 1] (the JAX augment
    program's images_u8.astype(dtype) / 255)."""

    return (images_u8.float() / scalar_like(255.0, images_u8)).to(dtype)


def _tta_transform_input(x, height, width, s, flip, sh, sw, ph, pw,
                         dtype):
    """One TTA pass's input transform of the NHWC float canvas: flip the
    ORIGINAL canvas, then bilinear-resize (no antialiasing, half-pixel
    centres: F.interpolate's align_corners=False), then pad bottom/right
    with gray 0.447 (yolov5 scale_img)."""

    xi = torch.flip(x, dims=[2]) if flip else x
    if (sh, sw) != (height, width):
        xi = F.interpolate(xi.permute(0, 3, 1, 2).float(), size=(sh, sw),
                           mode='bilinear', align_corners=False,
                           antialias=False).permute(0, 2, 3, 1).to(dtype)
    if (ph, pw) != (sh, sw):
        xi = F.pad(xi, (0, 0, 0, pw - sw, 0, ph - sh), value=0.447)
    return xi.contiguous()


def _tta_level_slice(i_pass, n_passes, nl):
    """The detect levels pass [i_pass] keeps (yolov5 _clip_augmented with
    its exclude-layer count of 1): all but the coarsest on the unscaled
    pass, all but the finest on the most-scaled pass; every level when
    nl is 1."""

    if nl > 1:
        if i_pass == 0:
            return slice(0, nl - 1)
        if i_pass == n_passes - 1:
            return slice(1, None)
    return slice(None)


def tta_concatenated_predictions(config, model, x, height, width, stride,
                                 dtype, nl=None):
    """
    The full reference TTA prediction assembly on decoded outputs:
    per-pass input transform, forward, de-scale by the nominal scale,
    de-flip against the original canvas width (yolov5 _descale_pred),
    clip the augmented tails (drop the coarsest detect level's rows from
    the unscaled pass and the finest level's rows from the most-scaled
    pass; levels are concatenated finest-first), concatenate. [x] is the
    NHWC uint8 canvas batch (pass 1 takes it as it is); [nl] is the
    number of detect levels (default from config.strides; 1 for
    single-level stand-ins, which disables clipping). Returns
    [B, A_total, 5+C].
    """

    if nl is None:
        nl = len(config.strides)
    passes = tta_passes(height, width, stride)
    g = sum(4 ** k for k in range(nl))
    xf = _tta_float_input(x, dtype)

    preds = []
    for i_pass, (s, flip, sh, sw, ph, pw) in enumerate(passes):
        xi = x if i_pass == 0 else _tta_transform_input(
            xf, height, width, s, flip, sh, sw, ph, pw, dtype)
        p = model(xi, decode=True).float()
        boxes = p[..., :4] / scalar_like(s, p)
        if flip:
            boxes = torch.cat([(width - boxes[..., 0])[..., None],
                               boxes[..., 1:]], dim=-1)
        p = torch.cat([boxes, p[..., 4:]], dim=-1)
        if nl > 1:
            a = p.shape[1]
            if i_pass == 0:
                p = p[:, : a - a // g]
            elif i_pass == len(passes) - 1:
                p = p[:, (a // g) * (4 ** (nl - 1)):]
        preds.append(p)
    return torch.cat(preds, dim=1)
