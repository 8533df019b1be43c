"""
Ahead-of-time detector export: a detector's device programs (letterboxed
uint8 canvas -> forward, then candidate selection + greedy NMS, weights
baked in as constants) as one self-contained artifact, and detection from
that artifact with no model code and no checkpoint at load time.
Counterpart of megadetector_tpu/detection/export_detector.py.

The artifact is a zip of a manifest (the model's identity, its
preprocessing geometry and a sha256 for every program) and torch.export
programs, as traced (ATen ops and the port's kernels as its custom
operators, mdtorch::*; no decomposition pass, so every op rounds where the
live detector's does). The programs follow the detector's own program
cache:
- a forward program per (platform, batch, canvas height, canvas width):
  uint8 canvases [b, h, w, 3] -> the raw heads (or the decoded
  predictions);
- a selection + NMS program per (platform, batch, canvas, candidate
  capacity) on the forward's outputs, so that the capacity ladder does not
  copy the weights.
Confidence and IoU thresholds are 0-d float32 tensor inputs of the
selection program, so one program (and one captured CUDA graph) serves
every detection_threshold.

The manifest's format_version is FORMAT_VERSION, not the JAX package's 1:
each package refuses the other's artifact (a JAX .mdpkg holds StableHLO).
Platforms are 'cpu' and 'cuda' ('gpu' is taken for 'cuda'); each is traced
on its own device, and exporting for 'cuda' needs a card.

Export:
    python -m megadetector_tpu_torch.detection.export_detector model.npz \\
        out.mdpkg [--batch_sizes 1 8] [--aspects 1:1 4:3 3:4] \\
        [--platforms cpu cuda]

Run (everything that calls load_detector accepts the artifact):
    python -m megadetector_tpu_torch.detection.run_detector_batch \\
        out.mdpkg image_folder results.json
"""

import argparse
import hashlib
import io
import json
import os
import time
import zipfile

import numpy as np
import torch

from megadetector_tpu_torch.device import get_device
from megadetector_tpu_torch.models.detector import TorchDetector
from megadetector_tpu_torch.ops import boxes as box_ops

ARTIFACT_EXTENSION = '.mdpkg'
MANIFEST_NAME = 'manifest.json'
FORMAT_VERSION = 'torch-export-1'
#: The JAX package's format_version (its programs are StableHLO)
JAX_FORMAT_VERSION = 1

#: Canvas aspect ratios exported by default: square (the universal
#: fallback), plus 4:3 / 3:4 (typical camera-trap stills) and 16:9 /
#: 9:16 (typical video frames). Each becomes the minimal stride-multiple
#: rectangle the detector's auto canvas mode would choose.
DEFAULT_ASPECTS = ('1:1', '4:3', '3:4', '16:9', '9:16')

#: Platform names -> the torch device type their programs run on
PLATFORMS = {'cpu': 'cpu', 'cuda': 'cuda', 'gpu': 'cuda'}

#: Detector options fixed at export time
FORBIDDEN_OPTIONS = ('mesh', 'image_size', 'arch', 'dtype', 'fused_decode',
                     'folded_early', 'folded_h2', 'approx_select',
                     'select_cm', 'stem_gemm', 'bf16_resize', 'conv_backend',
                     'bottleneck_variant', 'pre_nms_topk',
                     'xla_compiler_options')

_DTYPE_NAMES = {torch.float32: 'float32', torch.bfloat16: 'bfloat16'}


def forward_program_name(platform, batch_size, height, width):
    return 'programs/{}/forward_b{}_h{}_w{}.pt2'.format(
        platform, batch_size, height, width)


def select_program_name(platform, batch_size, height, width, topk):
    return 'programs/{}/select_b{}_h{}_w{}_k{}.pt2'.format(
        platform, batch_size, height, width, topk)


def _aspect_to_canvas(aspect, image_size, stride):
    """'W:H' aspect string -> the minimal stride-multiple canvas (h, w)."""

    try:
        w_part, h_part = aspect.split(':')
        w_ratio, h_ratio = float(w_part), float(h_part)
        assert w_ratio > 0 and h_ratio > 0
    except Exception:
        raise ValueError(
            "Bad aspect '{}' (expected W:H, e.g. 4:3)".format(aspect))
    # A large representative source image with this aspect; the minimal
    # canvas depends only on the aspect ratio once the long side exceeds
    # image_size (scale-down letterbox), so any big exemplar works
    scale = 8 * image_size / max(w_ratio, h_ratio)
    shape_hw = (int(round(h_ratio * scale)), int(round(w_ratio * scale)))
    return box_ops.auto_target_shape(shape_hw, image_size, stride=stride)


def canonical_platforms(platforms, force_cpu=False):
    """[platforms] as device types ('cpu', 'cuda'), in order, without
    repeats; None means the card, or the CPU with [force_cpu]."""

    if not platforms:
        return ['cpu'] if force_cpu else ['cuda']
    out = []
    for p in platforms:
        name = PLATFORMS.get(str(p).lower())
        if name is None:
            raise ValueError('Unknown platform {!r}; one of {}'.format(
                p, sorted(PLATFORMS)))
        if name not in out:
            out.append(name)
    return out


class _ForwardProgram(torch.nn.Module):
    """The detector's forward as a module (its network the submodule)."""

    def __init__(self, detector):
        super().__init__()
        self.model = detector.model
        self._forward = detector._forward

    def forward(self, images_u8):
        return self._forward(images_u8)


class _SelectProgram(torch.nn.Module):
    """Selection + NMS at one capacity, the thresholds as tensors."""

    def __init__(self, detector, capacity):
        super().__init__()
        self._select = detector._select_and_suppress
        self.capacity = int(capacity)

    def forward(self, conf_thres, iou_thres, forward_out):
        return self._select(self.capacity, conf_thres, iou_thres,
                            *forward_out)


def _export_program(module, args, device):
    """torch.export of [module] at [args], serialized. Refuses a program
    holding a tensor off [device] (it would copy from the host at every
    call, which no CUDA graph can capture)."""

    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    tensors = list(program.state_dict.values()) + list(
        program.constants.values())
    stray = [t.device for t in tensors if isinstance(t, torch.Tensor) and
             (t.device.type, t.device.index or 0) !=
             (device.type, device.index or 0)]
    if stray:
        raise ValueError('Traced program holds tensors on {} (exported for '
                         '{})'.format(sorted(set(map(str, stray))), device))
    # torch.export.save would otherwise store the example inputs too: a
    # 1280 px batch of 8, and a selection program's float heads, weigh
    # tens of MB each
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return program, buf.getvalue()


def export_detector(model_file, output_file, batch_sizes=(1, 8),
                    aspects=DEFAULT_ASPECTS, topk_ladder=None,
                    platforms=None, detector_options=None, verbose=False):
    """
    Export a detector checkpoint (or known model name) as an artifact at
    [output_file].

    Args:
        model_file (str): converted checkpoint / known model name, as
            accepted by load_detector
        output_file (str): artifact path (conventionally .mdpkg)
        batch_sizes (list of int): program batch shapes to export; at
            run time, batches pad up to the smallest exported size that
            fits (larger requests are chunked)
        aspects (list of str): 'W:H' aspect ratios; each exports the
            minimal stride-multiple canvas for that aspect (the square
            canvas is always included as the fallback for unlisted
            aspects)
        topk_ladder (list of int, optional): candidate capacities to
            export (default: the detector's pre_nms_topk only); include
            larger values to preserve capacity auto-escalation for
            crowded scenes
        platforms (list of str, optional): 'cpu' and / or 'cuda' ('gpu');
            default the card, or the CPU under the force_cpu option. Each
            is traced on its own device
        detector_options (dict, optional): options for the underlying
            TorchDetector (image_size, dtype, conv_backend, ...); the
            exported programs bake these in
        verbose (bool): print per-program progress

    Returns:
        dict: the manifest that was written
    """

    from megadetector_tpu_torch.detection.run_detector import load_detector

    options = dict(detector_options or {})
    if options.get('preprocess_mode', 'host') != 'host':
        raise ValueError('Only host-preprocess programs are exportable')
    if options.get('mesh') is not None:
        raise ValueError('Export single-device programs')
    if options.get('xla_compiler_options'):
        raise ValueError('xla_compiler_options cannot be baked into an '
                         'artifact')
    force_cpu = str(options.pop('force_cpu', False)).lower() in (
        'true', '1', 'yes')
    platforms = canonical_platforms(platforms, force_cpu)
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError('batch_sizes must be positive, got {}'.format(
            batch_sizes))

    manifest = None
    program_hashes = {}
    start = time.time()
    with zipfile.ZipFile(output_file, 'w', zipfile.ZIP_STORED) as z:
        for platform in platforms:
            detector = load_detector(model_file, detector_options=options,
                                     verbose=verbose, device=platform)
            if type(detector) is not TorchDetector:
                raise ValueError('Only converted checkpoints are exportable '
                                 '(got {})'.format(type(detector).__name__))
            if hasattr(detector.model, 'check_stem'):
                detector.model.check_stem()
            image_size = detector.default_image_size
            stride = detector.letterbox_stride
            canvases = {(image_size, image_size)}
            for aspect in (aspects or ()):
                canvases.add(_aspect_to_canvas(aspect, image_size, stride))
            canvases = sorted(canvases)
            ladder = sorted(set(int(k) for k in (
                topk_ladder or [detector.pre_nms_topk])))
            if manifest is None:
                manifest = _manifest(detector, model_file, ladder,
                                     batch_sizes, canvases, platforms)

            device = detector.device
            for batch_size in batch_sizes:
                for (height, width) in canvases:
                    if verbose:
                        print('Exporting {} b{} {}x{}, capacities {}'.format(
                            platform, batch_size, height, width, ladder))
                    x = torch.zeros((batch_size, height, width, 3),
                                    dtype=torch.uint8, device=device)
                    forward, blob = _export_program(
                        _ForwardProgram(detector), (x,), device)
                    name = forward_program_name(platform, batch_size,
                                                height, width)
                    program_hashes[name] = hashlib.sha256(blob).hexdigest()
                    z.writestr(name, blob)
                    with torch.no_grad():
                        forward_out = tuple(forward.module()(x))
                    conf = torch.full((), 0.005, dtype=torch.float32,
                                      device=device)
                    iou = torch.full((), 0.45, dtype=torch.float32,
                                     device=device)
                    for topk in ladder:
                        _, blob = _export_program(
                            _SelectProgram(detector, topk),
                            (conf, iou, forward_out), device)
                        name = select_program_name(platform, batch_size,
                                                   height, width, topk)
                        program_hashes[name] = hashlib.sha256(
                            blob).hexdigest()
                        z.writestr(name, blob)
            del detector
        # Written last so it can carry per-program integrity hashes,
        # checked at load time
        manifest['program_sha256'] = program_hashes
        z.writestr(MANIFEST_NAME, json.dumps(manifest, indent=1),
                   compress_type=zipfile.ZIP_DEFLATED)

    if verbose:
        print('Exported {} programs to {} in {:.1f}s ({:.1f} MB)'.format(
            len(program_hashes), output_file, time.time() - start,
            os.path.getsize(output_file) / 1e6))
    return manifest


def _manifest(detector, model_file, ladder, batch_sizes, canvases,
              platforms):
    return {
        'format_version': FORMAT_VERSION,
        'source_model': os.path.basename(str(model_file)),
        'metadata': detector.metadata or {},
        'class_names': list(detector.class_names),
        'model_type': detector.model_type,
        'image_size': detector.default_image_size,
        'letterbox_stride': detector.letterbox_stride,
        'compatibility_mode': detector.compatibility_mode,
        'compute_dtype': _DTYPE_NAMES[detector.compute_dtype],
        'conv_backend': detector.conv_backend,
        'fused_decode': bool(detector._fused_decode),
        'max_det': detector.max_det,
        'pre_nms_topk': detector.pre_nms_topk,
        'topk_ladder': ladder,
        'batch_sizes': batch_sizes,
        'canvases': [list(c) for c in canvases],
        'platforms': list(platforms),
        'use_model_native_classes': detector.use_model_native_classes,
        'torch_version': torch.__version__,
    }


def read_artifact(artifact_path):
    """
    (manifest, {program name: bytes}) of a port artifact, its integrity
    checked both ways: every program in the archive has a manifest hash
    that matches, and every hashed name is in the archive. A JAX .mdpkg,
    or an archive that is no artifact, raises ValueError.
    """

    try:
        with zipfile.ZipFile(artifact_path, 'r') as z:
            names = z.namelist()
            if MANIFEST_NAME not in names:
                raise ValueError('{} has no {}: not a detector artifact'
                                 .format(artifact_path, MANIFEST_NAME))
            manifest = json.loads(z.read(MANIFEST_NAME).decode('utf-8'))
            version = manifest.get('format_version')
            if version == JAX_FORMAT_VERSION:
                raise ValueError(
                    '{} is a JAX artifact (format_version {}, StableHLO '
                    'programs of megadetector_tpu): the port runs its own '
                    'artifacts (format_version {}); export the checkpoint '
                    'with megadetector_tpu_torch.detection.export_detector'
                    .format(artifact_path, version, FORMAT_VERSION))
            if version != FORMAT_VERSION:
                raise ValueError('{}: unsupported artifact format version '
                                 '{!r}'.format(artifact_path, version))
            blobs = {name: z.read(name) for name in names
                     if name.startswith('programs/')}
    except zipfile.BadZipFile as e:
        raise ValueError('{} is not a detector artifact: {}'.format(
            artifact_path, e)) from e
    hashes = manifest.get('program_sha256') or {}
    missing = sorted(set(hashes) - set(blobs))
    if missing:
        raise ValueError('Corrupt artifact: manifest lists programs absent '
                         'from the archive: {}'.format(missing))
    for name, blob in blobs.items():
        expected = hashes.get(name)
        if expected is None:
            raise ValueError('Corrupt artifact: {} has no integrity hash in '
                             'the manifest'.format(name))
        got = hashlib.sha256(blob).hexdigest()
        if got != expected:
            raise ValueError('Corrupt artifact: {} sha256 mismatch (manifest '
                             '{}..., got {}...)'.format(name, expected[:12],
                                                        got[:12]))
    return manifest, blobs


class ExportedDetector(TorchDetector):
    """
    Run detection from an exported artifact: the TorchDetector driver
    (preprocessing, batching, capacity escalation, emission) around the
    artifact's programs instead of a live network. Weights are baked into
    the programs, so no checkpoint, model config or weight conversion is
    involved at load time. The programs run through the detector's
    program cache: eagerly once, then captured into a CUDA graph and
    replayed on the card, the thresholds copied into static device
    tensors at every call.

    Constraints of the exported form:
    - host preprocessing only (the canvas is the program input)
    - canvases are fixed to the exported set; images whose minimal
      rectangle was not exported letterbox onto the square canvas
    - batches chunk / pad to the exported batch sizes
    - candidate-capacity escalation is bounded by the exported
      topk_ladder (beyond it, images carry the 'pre_nms_truncation' flag)
    - TTA (augment=True) is refused
    - the device must be one of the artifact's platforms
    """

    supports_mesh = False

    def __init__(self, artifact_path, detector_options=None, verbose=False,
                 device=None):

        options = dict(detector_options or {})
        for forbidden in FORBIDDEN_OPTIONS:
            if options.get(forbidden) is not None:
                raise ValueError('{} is fixed at export time for exported '
                                 'artifacts'.format(forbidden))
        if options.get('preprocess_mode', 'host') != 'host':
            raise ValueError('Exported artifacts hold host-preprocess '
                             'programs only')
        manifest, self._program_bytes = read_artifact(artifact_path)
        self._manifest = manifest
        self._modules = {}
        self._exported_canvases = set(
            tuple(c) for c in manifest['canvases'])
        self._exported_batch_sizes = sorted(manifest['batch_sizes'])
        self._topk_ladder = sorted(manifest['topk_ladder'])

        options.setdefault('compatibility_mode',
                           manifest['compatibility_mode'])
        options['pre_nms_topk'] = self._topk_ladder[0]
        options['dtype'] = manifest['compute_dtype']
        # Values beyond the exported shapes would only fail at run time
        # (escalation or padding asking for a program never exported);
        # refuse them up front
        max_topk = options.setdefault('max_pre_nms_topk',
                                      self._topk_ladder[-1])
        if int(max_topk) > self._topk_ladder[-1]:
            raise ValueError(
                'max_pre_nms_topk {} exceeds the largest exported '
                'candidate capacity {} (re-export with --topk_ladder '
                'covering it)'.format(max_topk, self._topk_ladder[-1]))
        pad_to = options.get('pad_batches_to')
        if pad_to is not None and \
                int(pad_to) > self._exported_batch_sizes[-1]:
            raise ValueError(
                'pad_batches_to {} exceeds the largest exported batch '
                'size {} (re-export with --batch_sizes covering '
                'it)'.format(pad_to, self._exported_batch_sizes[-1]))
        options.setdefault('use_model_native_classes',
                           manifest.get('use_model_native_classes', False))

        # The artifact holds programs for its platforms only; another
        # device would load fine and fail at the first batch
        if str(options.get('force_cpu', False)).lower() in ('true', '1',
                                                             'yes'):
            device = 'cpu'
        self._platform = get_device(device).type
        if self._platform not in manifest['platforms']:
            raise ValueError(
                'Artifact {} was exported for platform(s) {} but the '
                'detector runs on {}; re-export with --platforms {} (or '
                'include both)'.format(artifact_path, manifest['platforms'],
                                       self._platform, self._platform))

        super().__init__(artifact_path, detector_options=options,
                         verbose=verbose, device=device)

    #%% Loading

    def _load_model(self, model_path, options, verbose):
        manifest = self._manifest
        self.metadata = dict(manifest.get('metadata') or {})
        self.model_type = manifest.get('model_type', 'exported')
        self.class_names = list(manifest['class_names'])
        self.default_image_size = int(manifest['image_size'])
        self.letterbox_stride = int(manifest['letterbox_stride'])
        self.conv_backend = manifest.get('conv_backend', 'xla')
        self._fused_decode = bool(manifest.get('fused_decode', True))
        self.max_det = int(manifest['max_det'])
        self.model = None
        self.config = None
        if verbose:
            print('Loaded exported artifact {} ({} programs, platforms '
                  '{})'.format(model_path, len(self._program_bytes),
                               manifest['platforms']))

    def _program_module(self, name):
        """The artifact's program [name], deserialized once, as a
        callable module."""

        module = self._modules.get(name)
        if module is None:
            program = torch.export.load(io.BytesIO(self._program_bytes[name]))
            module = self._modules[name] = program.module()
        return module

    #%% Program management

    def _check_image_size(self, image_size):
        """A per-call image_size would letterbox onto a canvas no exported
        program matches: refuse it up front."""

        if image_size is not None and \
                int(image_size) != self.default_image_size:
            raise ValueError(
                'image_size {} differs from the exported canvas size {}; '
                'exported artifacts run at their export-time image size '
                'only (re-export with detector_options image_size={} if '
                'you need it)'.format(image_size, self.default_image_size,
                                      image_size))

    def _effective_topk(self, topk):
        """Round an escalation capacity up to the exported ladder entry
        that will run, so escalation never re-runs the same program."""

        usable = [k for k in self._topk_ladder if k >= topk]
        return usable[0] if usable else topk

    def _canvas_key(self, batch_size, height, width, topk):
        """Map a requested program shape onto an exported one: the exact
        canvas, the smallest exported batch that fits, and the smallest
        exported capacity that holds [topk]."""

        usable_b = [b for b in self._exported_batch_sizes
                    if b >= batch_size]
        usable_k = [k for k in self._topk_ladder if k >= topk]
        if (height, width) not in self._exported_canvases or \
                not usable_b or not usable_k:
            raise RuntimeError(
                'No exported program for batch {} canvas {}x{} capacity {}; '
                'artifact has batch sizes {}, canvases {}, capacities {} '
                '(re-export with the shapes you need)'.format(
                    batch_size, height, width, topk,
                    self._exported_batch_sizes,
                    sorted(self._exported_canvases), self._topk_ladder))
        return (usable_b[0], height, width, usable_k[0])

    def _check_augment(self):
        raise ValueError(
            'augment=True is not supported by exported artifacts (TTA '
            'programs are not exported); run TTA from the checkpoint '
            'instead')

    def _use_auto_canvas(self, shape_hw, image_size, scaleup, canvas_mode):
        """Only canvases that were exported are usable; everything else
        falls back to the (always exported) square canvas."""

        if canvas_mode != 'auto':
            return False
        t = self._auto_target_shape(shape_hw, image_size, scaleup)
        return t in self._exported_canvases

    def run_program(self, batch_u8, conf_thres, iou_thres, augment=False):
        """TorchDetector.run_program on the artifact's programs: the batch
        padded (repeating its last image) to the smallest exported batch
        that holds it, the outputs cut back to its images."""

        if augment:
            self._check_augment()
        batch = np.ascontiguousarray(batch_u8, dtype=np.uint8)
        n, h, w = batch.shape[:3]
        b = self._canvas_key(n, h, w, self.pre_nms_topk)[0]
        if n < b:
            batch = np.concatenate([batch, np.repeat(batch[-1:], b - n, 0)])
        module = self._program_module(forward_program_name(
            self._platform, b, h, w))
        with torch.inference_mode():
            out, topk = self._program(('forward', b, h, w), (batch,),
                                      lambda x: tuple(module(x)),
                                      conf_thres, iou_thres)
        if n < b:
            out = {k: v[:n] for k, v in out.items()}
        return out, topk

    def _run_select(self, key, capacity, conf_thres, iou_thres, forward_out,
                    static):
        """The artifact's selection + NMS program at [capacity]: one
        program per (forward key, capacity), the thresholds host inputs
        staged into the program's static device tensors."""

        b, h, w = key[1:4]
        module = self._program_module(select_program_name(
            self._platform, b, h, w, capacity))
        out, _ = self._programs.run(
            key + ('select', capacity),
            lambda c, i, *f: module(c.reshape(()), i.reshape(()), f),
            host_inputs=(np.float32(conf_thres), np.float32(iou_thres)),
            device_inputs=forward_out, graphs=self._cuda_graphs,
            capture=static)
        return out

    #%% Inference

    def preprocess_image(self, img_original, image_id='unknown',
                         image_size=None, verbose=False):
        self._check_image_size(image_size)
        return super().preprocess_image(
            img_original, image_id=image_id, image_size=image_size,
            verbose=verbose)

    def generate_detections_one_batch(self, img_originals, image_ids=None,
                                      detection_threshold=0.00001,
                                      image_size=None, augment=False,
                                      verbose=False):
        # Raise up front instead of letting batch failure containment
        # turn an unsupported request into per-image failure records
        if augment:
            self._check_augment()
        self._check_image_size(image_size)
        return super().generate_detections_one_batch(
            img_originals, image_ids=image_ids,
            detection_threshold=detection_threshold,
            image_size=image_size, augment=augment, verbose=verbose)

    def _run_batch(self, infos, results, detection_threshold,
                   augment=False):
        # Chunk oversized groups to the largest exported batch program
        max_b = self._exported_batch_sizes[-1]
        for i in range(0, len(infos), max_b):
            super()._run_batch(infos[i:i + max_b], results,
                               detection_threshold, augment=augment)


#%% CLI

def main():

    parser = argparse.ArgumentParser(
        description='Export a detector as a self-contained artifact '
                    '(torch.export programs with weights baked in)')
    parser.add_argument('model_file',
                        help='converted checkpoint or known model name')
    parser.add_argument('output_file',
                        help='artifact path (conventionally {})'.format(
                            ARTIFACT_EXTENSION))
    parser.add_argument('--batch_sizes', type=int, nargs='+',
                        default=[1, 8])
    parser.add_argument('--aspects', nargs='+',
                        default=list(DEFAULT_ASPECTS),
                        help="canvas aspect ratios as W:H (square is "
                             "always included)")
    parser.add_argument('--topk_ladder', type=int, nargs='+',
                        default=None,
                        help='candidate capacities (default: the '
                             "detector's pre_nms_topk)")
    parser.add_argument('--platforms', nargs='+', default=None,
                        help='cpu and / or cuda (gpu) (default: the card, '
                             'or the CPU under force_cpu=true)')
    parser.add_argument('--detector_options', nargs='*', default=None,
                        metavar='KEY=VALUE')
    args = parser.parse_args()

    detector_options = None
    if args.detector_options:
        from megadetector_tpu_torch.utils import ct_utils
        detector_options = ct_utils.parse_kvp_list(args.detector_options)

    export_detector(args.model_file, args.output_file,
                    batch_sizes=args.batch_sizes, aspects=args.aspects,
                    topk_ladder=args.topk_ladder,
                    platforms=args.platforms,
                    detector_options=detector_options, verbose=True)


if __name__ == '__main__':
    main()
