"""
Checkpoint I/O for the port: the .npz + metadata.json format that
megadetector_tpu/models/convert_weights.py writes, read without importing
the JAX package, plus the HWIO -> OIHW conversion into torch tensors.

Parameters stay a nested dict of numpy arrays (the JAX pytree layout) on
disk and in the tests, so both packages load the very same numbers.
"""

import json
import os

import numpy as np
import torch


def flatten_params(params, prefix='', out=None):
    """Nested-dict pytree -> {'a/b/c': ndarray} flat dict."""

    if out is None:
        out = {}
    for k, v in params.items():
        path = '{}/{}'.format(prefix, k) if prefix else k
        if isinstance(v, dict):
            flatten_params(v, path, out)
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_params(flat):
    """{'a/b/c': ndarray} -> nested-dict pytree."""

    params = {}
    for path, v in flat.items():
        parts = path.split('/')
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return params


def save_checkpoint(params, path, metadata=None):
    """
    Save a numpy parameter pytree as .npz, with a metadata.json sidecar
    ('<path minus .npz>.metadata.json'). Same format the JAX package
    reads.
    """

    flat = flatten_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    if metadata is not None:
        meta_path = os.path.splitext(path)[0] + '.metadata.json'
        with open(meta_path, 'w') as f:
            json.dump(metadata, f, indent=1)
    return path


def load_checkpoint(path):
    """
    Load a converted checkpoint: an .npz file (metadata from
    '<path minus .npz>.metadata.json') or a directory holding
    weights.npz + metadata.json. Returns (params, metadata-or-None).

    Quantized checkpoints (int8 'w_q' leaves) belong to the int8 slice,
    which the port does not run yet: they raise NotImplementedError.
    """

    if os.path.isdir(path):
        npz_path = os.path.join(path, 'weights.npz')
        meta_path = os.path.join(path, 'metadata.json')
    else:
        npz_path = path
        meta_path = os.path.splitext(path)[0] + '.metadata.json'

    with np.load(npz_path) as data:
        flat = {k: data[k] for k in data.files}
    quantized = [k for k in flat if k.split('/')[-1] == 'w_q']
    if quantized:
        raise NotImplementedError(
            'Checkpoint {} is quantized ({} int8 w_q leaves); the int8 '
            'chain (ops/quantization.py, kernels conv3x3_chain and '
            'bottleneck_chain) is not ported yet'.format(
                path, len(quantized)))
    params = unflatten_params(flat)

    metadata = None
    if os.path.isfile(meta_path):
        with open(meta_path, 'r') as f:
            metadata = json.load(f)
    return params, metadata


def params_to_torch(params_np):
    """
    JAX-layout numpy pytree -> the same tree of float32 torch tensors:
    conv weights 'w' go HWIO -> OIHW, biases 'b' are copied as they are.
    """

    out = {}
    for k, v in params_np.items():
        if isinstance(v, dict):
            out[k] = params_to_torch(v)
            continue
        a = np.asarray(v, np.float32)
        if k == 'w':
            if a.ndim != 4:
                raise ValueError('Conv weight {} has shape {}, expected '
                                 'HWIO'.format(k, a.shape))
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out
