"""
Detector loading for the port (counterpart of
megadetector_tpu/detection/run_detector.py load_detector,
is_gpu_available and get_accelerator_summary).

A known model name ('MDV5A') resolves only to a converted checkpoint that
is already on disk in the model folder; nothing is downloaded.
"""

import hashlib
import os
import time

from megadetector_tpu_torch.device import (  # noqa: F401  (public API)
    get_accelerator_summary,
    is_gpu_available,
)
from megadetector_tpu_torch.models.detector import (  # noqa: F401
    CONF_DIGITS,
    COORD_DIGITS,
    DEFAULT_DETECTOR_LABEL_MAP,
    FAILURE_IMAGE_OPEN,
    FAILURE_INFER,
    TorchDetector,
)
from megadetector_tpu_torch.models import registry
from megadetector_tpu_torch.models.convert_weights import \
    convert_megadetector_checkpoint


def resolve_model_file(model_file):
    """
    A path that exists is returned as is. A known model name resolves to
    its converted checkpoint in the model folder; if that is not on disk,
    FileNotFoundError says how to make it.
    """

    if os.path.exists(model_file):
        return model_file
    version = registry.model_string_to_model_version.get(
        str(model_file).lower())
    if version is None:
        raise FileNotFoundError('Model file {} does not exist'.format(
            model_file))
    converted = registry.find_converted_checkpoint(version)
    if converted is None:
        raise FileNotFoundError(
            'No converted checkpoint for {} ({}) in {}; convert the .pt '
            'once with python -m megadetector_tpu_torch.models.'
            'convert_weights '
            'and place it there as md_{}.npz'.format(
                model_file, version, registry.get_default_model_folder(),
                version))
    return converted


def load_detector(model_file, force_cpu=False, detector_options=None,
                  verbose=False, *, device=None):
    """
    Load a TorchDetector from a converted checkpoint (.npz + metadata, or
    a folder with weights.npz + metadata.json), a reference YOLOv5 .pt
    (converted once into the model folder) or a known model name.
    The positional arguments are the JAX package's load_detector's.

    Args:
        model_file: checkpoint path or known model name
        force_cpu: run on the CPU (device 'cpu')
        detector_options: dict of TorchDetector options
        verbose: print load details
        device: keyword only: 'cuda', 'cuda:N', 'cpu' or None (CUDA, or
            the CPU with force_cpu); CUDA without a card raises, so the
            CPU needs 'cpu' (or force_cpu). A device other than the CPU
            together with force_cpu raises ValueError.
    """

    if force_cpu:
        if device is not None and str(device) != 'cpu':
            raise ValueError('load_detector: force_cpu=True contradicts '
                             'device={!r}'.format(device))
        device = 'cpu'
    model_file = resolve_model_file(model_file)
    if model_file.endswith(('.pb', '.mdpkg')):
        raise NotImplementedError(
            '{}: the PyTorch port loads converted .npz checkpoints and '
            'reference .pt files only'.format(model_file))
    start = time.time()
    if model_file.endswith('.pt'):
        # A reference checkpoint: converted once into the model folder,
        # then loaded. The name hashes the file's first MiB and its size,
        # so a checkpoint that merely names a known version (a fine-tune
        # called my_v5a.0.1.pt) never resolves to another's conversion
        version = registry.get_detector_version_from_model_file(model_file)
        with open(model_file, 'rb') as f:
            head = f.read(1 << 20)
            f.seek(0, os.SEEK_END)
            size = f.tell()
        digest = hashlib.sha256(head + str(size).encode()).hexdigest()[:10]
        out_path = os.path.join(
            registry.get_default_model_folder(),
            'md_{}_{}.npz'.format(version or os.path.basename(model_file),
                                  digest))
        if not os.path.isfile(out_path):
            print('Converting torch checkpoint {} -> {}'.format(
                model_file, out_path))
            convert_megadetector_checkpoint(model_file, out_path,
                                            model_version=version,
                                            verbose=verbose)
        model_file = out_path
    detector = TorchDetector(model_file, detector_options=detector_options,
                             verbose=verbose, device=device)
    print('Loaded model in {:.2f} seconds'.format(time.time() - start))
    return detector
