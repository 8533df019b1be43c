"""
Checkpoint I/O for the port: the .npz + metadata.json format that
megadetector_tpu/models/convert_weights.py writes, read without importing
the JAX package, plus the conversion into torch tensors.

Parameters stay a nested dict of numpy arrays (the JAX pytree layout) on
disk and in the tests, so both packages load the very same numbers.

int8-chain checkpoints load too. The JAX package writes them width-folded
(quantize_checkpoint folds l0-l3 for the TPU's lanes before it
quantizes, megadetector_tpu/ops/folding.py); the port unfolds them on load
(unfold_early_params), which is exact. The port's own quantize_checkpoint
writes unfolded int8 checkpoints with the same layer policy, which the JAX
TPUDetector loads unchanged.
"""

import json
import os

import numpy as np
import torch

from megadetector_tpu_torch.ops.quantization import (SCALE_KEYS,
                                                     requalify_quantized)


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
    Static scales of quantized checkpoints (x_scale, y_scale, res_scale)
    come back as Python floats.
    """

    if os.path.isdir(path):
        npz_path = os.path.join(path, 'weights.npz')
        meta_path = os.path.join(path, 'metadata.json')
    else:
        npz_path = path
        meta_path = os.path.splitext(path)[0] + '.metadata.json'

    with np.load(npz_path) as data:
        flat = {k: data[k] for k in data.files}
    params = requalify_quantized(unflatten_params(flat))

    metadata = None
    if os.path.isfile(meta_path):
        with open(meta_path, 'r') as f:
            metadata = json.load(f)
    return params, metadata


def params_to_torch(params_np):
    """
    JAX-layout numpy pytree -> the same tree of torch tensors: float conv
    weights 'w' go HWIO -> OIHW float32; int8 weights 'w_q' stay int8 and
    go HWIO -> [Cout, kh, kw, Cin], the int8 kernels' layout; biases and
    w_scale are float32; static scales become Python floats.
    """

    out = {}
    for k, v in params_np.items():
        if isinstance(v, dict):
            out[k] = params_to_torch(v)
        elif k in SCALE_KEYS:
            out[k] = float(np.asarray(v))
        elif k in ('w', 'w_q'):
            a = np.asarray(v)
            if a.ndim != 4:
                raise ValueError('Conv weight {} has shape {}, expected '
                                 'HWIO'.format(k, a.shape))
            if k == 'w':
                out[k] = torch.from_numpy(np.ascontiguousarray(
                    a.astype(np.float32).transpose(3, 2, 0, 1)))
            else:
                if a.dtype != np.int8:
                    raise ValueError('w_q has dtype {}, expected int8'
                                     .format(a.dtype))
                out[k] = torch.from_numpy(np.ascontiguousarray(
                    a.transpose(3, 0, 1, 2)))
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(v, np.float32)))
    return out


#%% Width folding, undone


def params_are_folded(params):
    """True when l0 carries a width-folded weight: [6, 3, 12, *] (w4) or
    [3, 3, 24, *] (h2 + w4), as megadetector_tpu/ops/folding.py writes."""

    node = params.get('l0')
    if not isinstance(node, dict):
        return False
    w = node.get('w', node.get('w_q'))
    return w is not None and tuple(np.shape(w)[:3]) in ((6, 3, 12),
                                                        (3, 3, 24))


def _weight_key(node):
    if 'w' in node:
        return 'w'
    if 'w_q' in node:
        return 'w_q'
    raise ValueError('Not a conv node: {}'.format(sorted(node)))


def _unfold_node(node, w, co=None):
    """Copy of a conv node with weight [w]; with [co], the per-output-channel
    leaves (b, w_scale) keep their first co entries (output phase 0)."""

    out = dict(node)
    out[_weight_key(node)] = np.ascontiguousarray(w)
    if co is not None:
        for key in ('b', 'w_scale'):
            if key in node:
                out[key] = np.ascontiguousarray(np.asarray(node[key])[:co])
    return out


def _unfold_l0(node):
    """Inverse of folding.fold_l0 (and of fold_l0_h2): [6,3,12,2C] ->
    [6,6,3,C]. Output phase 0 reads original column kx through folded
    column t // 4 + 1, subphase t % 4, with t = kx - 2."""

    wf = np.asarray(node[_weight_key(node)])
    if wf.shape[:3] == (3, 3, 24):
        # fold_l0_h2 put w4 row ky at [ky // 2, :, (ky % 2) * 12 + g]
        wf = np.stack([wf[ky // 2, :, (ky % 2) * 12:(ky % 2) * 12 + 12]
                       for ky in range(6)])
    c = wf.shape[3] // 2
    w = np.zeros((6, 6, 3, c), wf.dtype)
    for kx in range(6):
        t = kx - 2
        w[:, kx] = wf[:, t // 4 + 1, 3 * (t % 4):3 * (t % 4) + 3, 0:c]
    return _unfold_node(node, w, c)


def _unfold_conv_s2(node):
    """Inverse of folding.fold_conv_s2: [3,3,2Ci,2Co] -> [3,3,Ci,Co]
    (output phase 0: column kx at folded column t // 2 + 1, phase t % 2,
    t = kx - 1)."""

    wf = np.asarray(node[_weight_key(node)])
    ci, co = wf.shape[2] // 2, wf.shape[3] // 2
    w = np.zeros((3, 3, ci, co), wf.dtype)
    for kx in range(3):
        t = kx - 1
        w[:, kx] = wf[:, t // 2 + 1, (t % 2) * ci:(t % 2) * ci + ci, 0:co]
    return _unfold_node(node, w, co)


def _unfold_conv_s2_exit(node):
    """Inverse of folding.fold_conv_s2_exit: [3,2,2Ci,Co] -> [3,3,Ci,Co]."""

    wf = np.asarray(node[_weight_key(node)])
    ci = wf.shape[2] // 2
    w = np.stack([wf[:, 0, ci:2 * ci], wf[:, 1, 0:ci], wf[:, 1, ci:2 * ci]],
                 axis=1)
    return _unfold_node(node, w)


def _unfold_1x1(node):
    """Inverse of folding.fold_1x1 (block-diagonal [1,1,2C,2Co])."""

    wf = np.asarray(node[_weight_key(node)])
    ci, co = wf.shape[2] // 2, wf.shape[3] // 2
    return _unfold_node(node, wf[:, :, 0:ci, 0:co], co)


def _unfold_3x3_s1(node):
    """Inverse of folding.fold_3x3_s1: output phase 0 taps column 0 at
    (folded column 0, phase 1), column 1 at (1, 0), column 2 at (1, 1)."""

    wf = np.asarray(node[_weight_key(node)])
    ci, co = wf.shape[2] // 2, wf.shape[3] // 2
    w = np.stack([wf[:, 0, ci:2 * ci, 0:co], wf[:, 1, 0:ci, 0:co],
                  wf[:, 1, ci:2 * ci, 0:co]], axis=1)
    return _unfold_node(node, w, co)


def _unfold_c3(node, n):
    """Inverse of folding.fold_c3: the merged cv12 splits back into cv1
    and cv2 (both keep cv12's static scales), cv3 and the n bottlenecks
    unfold."""

    cv12 = node['cv12']
    w12 = np.asarray(cv12[_weight_key(cv12)])
    ci, ch = w12.shape[2] // 2, w12.shape[3] // 4
    out = {'cv1': _unfold_node(cv12, w12[:, :, 0:ci, 0:ch]),
           'cv2': _unfold_node(cv12, w12[:, :, 0:ci, 2 * ch:3 * ch])}
    for name, lo in (('cv1', 0), ('cv2', 2 * ch)):
        for key in ('b', 'w_scale'):
            if key in cv12:
                out[name][key] = np.ascontiguousarray(
                    np.asarray(cv12[key])[lo:lo + ch])
    cv3 = node['cv3']
    w3f = np.asarray(cv3[_weight_key(cv3)])
    co = w3f.shape[3] // 2
    out['cv3'] = _unfold_node(cv3, np.concatenate(
        [w3f[:, :, 0:ch, 0:co], w3f[:, :, 2 * ch:3 * ch, 0:co]], axis=2),
        co)
    for j in range(n):
        m = node['m{}'.format(j)]
        out['m{}'.format(j)] = {'cv1': _unfold_1x1(m['cv1']),
                                'cv2': _unfold_3x3_s1(m['cv2'])}
    return out


def unfold_early_params(params, config):
    """
    Exact inverse of megadetector_tpu/ops/folding.py fold_early_params:
    l0-l3 of a width-folded tree (float or int8 nodes) go back to the
    plain layout, every other layer is shared. Each folded output channel
    holds every original tap of its channel once (the rest are zeros), so
    phase 0's block gives back the original weight, and per-channel
    w_scale / w_q equal those of quantizing the unfolded weight. A tree
    that is not folded is returned as it is. [config] is the tree's
    YoloV5Config (every YOLOv5 config has the foldable l0-l3 prefix).
    """

    if not params_are_folded(params):
        return params
    out = dict(params)
    out['l0'] = _unfold_l0(params['l0'])
    out['l1'] = _unfold_conv_s2(params['l1'])
    out['l2'] = _unfold_c3(params['l2'], config.layers[2]['n'])
    out['l3'] = _unfold_conv_s2_exit(params['l3'])
    return out


#%% int8-chain checkpoints


def _share_merged_scales(params_q):
    """Give l2's cv1 and cv2 the scales of the merged cv12 node the JAX
    package quantizes: both read l1's output (one x_scale), and the merged
    output's abs-max is the larger of the two (y_scale = max)."""

    cv1, cv2 = params_q['l2']['cv1'], params_q['l2']['cv2']
    x_scale = max(cv1['x_scale'], cv2['x_scale'])
    y_scale = max(cv1['y_scale'], cv2['y_scale'])
    for node in (cv1, cv2):
        node['x_scale'] = x_scale
        node['y_scale'] = y_scale


def quantize_checkpoint(input_path, output_path, calibration_folder=None,
                        calibration_image_size=None, n_calibration_images=8,
                        verbose=False, calibration_images=None, device=None):
    """
    Write an int8-chain checkpoint from a converted float checkpoint
    (counterpart of the JAX package's quantize_checkpoint, mode='chain',
    the only mode the port writes), calibrating with the port's own
    forward on [device] (None: the card; pass 'cpu' for the CPU).

    The policy is the JAX package's for MDv5a: l0 float, every later conv
    int8 with calibrated static scales, the detect heads float; l2's cv1
    and cv2 share the scales of the merged node the JAX package folds
    them into. The checkpoint is written unfolded; the JAX TPUDetector
    loads it as it is.

    Calibration images: [calibration_images] ([N, H, W, 3] float in
    [0, 1]), else up to n_calibration_images from [calibration_folder]
    letterboxed to the square calibration canvas, else 4 uniform-noise
    canvases from RandomState(0). The canvas defaults to the checkpoint's
    image_size.
    """

    from megadetector_tpu_torch.models.yolov5 import YoloV5Config
    from megadetector_tpu_torch.ops import quantization as q

    params, metadata = load_checkpoint(input_path)
    metadata = metadata or {}
    arch = metadata.get('arch', 'yolov5l6')
    if not arch.startswith('yolov5'):
        raise ValueError(
            'int8-chain quantization supports the yolov5 family only '
            '(checkpoint arch: {})'.format(arch))
    config = YoloV5Config(arch, num_classes=int(metadata.get('num_classes',
                                                             3)),
                          anchors=metadata.get('anchors'))
    params = unfold_early_params(params, config)
    if any(k.split('/')[-1] == 'w_q' for k in flatten_params(params)):
        raise ValueError('{} is already quantized'.format(input_path))
    detect_name = 'l{}'.format(len(config.layers) - 1)
    params_q = q.quantize_params_chain(
        params, skip_names=(detect_name,),
        float_store_names=q.DEFAULT_FLOAT_STORE_LAYERS_FOLDED)

    s = int(calibration_image_size or metadata.get('image_size', 640))
    if calibration_images is not None:
        samples = np.asarray(calibration_images, np.float32)
    elif calibration_folder is not None:
        from megadetector_tpu_torch.ops.boxes import letterbox
        from megadetector_tpu_torch.utils.path_utils import find_images
        from megadetector_tpu_torch.visualization import \
            visualization_utils
        files = find_images(calibration_folder,
                            recursive=True)[:n_calibration_images]
        if not files:
            raise ValueError('No calibration images in {}'.format(
                calibration_folder))
        samples = np.stack([
            letterbox(np.asarray(visualization_utils.load_image(fn)),
                      (s, s), auto=False, scaleup=True)[0]
            for fn in files]).astype(np.float32) / 255.0
    else:
        if verbose:
            print('Warning: calibrating on synthetic noise; provide '
                  'calibration images for production use')
        samples = np.random.RandomState(0).uniform(
            0, 1, (4, s, s, 3)).astype(np.float32)

    q.calibrate_chain_scales(config, params_q, samples, device=device)
    _share_merged_scales(params_q)

    metadata = dict(metadata)
    metadata['quantized'] = True
    metadata['quantization'] = 'int8-chain'
    save_checkpoint(params_q, output_path, metadata)
    if verbose:
        print('Quantized {} -> {}'.format(input_path, output_path))
    return output_path
