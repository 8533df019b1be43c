"""
Checkpoint I/O for the port: the .npz + metadata.json format that
megadetector_tpu/models/convert_weights.py writes, read without importing
the JAX package, plus the conversion into torch tensors; and the offline
converter of reference .pt checkpoints into that format (a stub unpickler,
so the training repo need not be installed; BatchNorm folded, weights OIHW
-> HWIO) for every detector family the JAX converter takes: YOLOv5,
ultralytics (YOLOv8-style, MDv1000) and RF-DETR, with its CLI:

    python -m megadetector_tpu_torch.models.convert_weights ckpt.pt \
        [out.npz] [--arch A] [--num_classes N] [--model_version V] \
        [--quantize [--calibration_folder F] [--device cpu]]

Parameters stay a nested dict of numpy arrays (the JAX pytree layout) on
disk and in the tests, so both packages load the very same numbers.

int8-chain checkpoints load too. The JAX package writes them width-folded
(quantize_checkpoint folds l0-l3 for the TPU's lanes before it
quantizes, megadetector_tpu/ops/folding.py); the port unfolds them on load
(unfold_early_params), which is exact. The port's own quantize_checkpoint
writes unfolded int8 checkpoints with the same layer policy, which the JAX
TPUDetector loads unchanged. Static-scale checkpoints (mode='static':
float32 x_scale per int8 conv, float activations between layers, never
folded) load and are written by both packages alike.
"""

import io
import json
import os
import pickle
import re

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


#%% Torch-state-dict extraction without the training repo


class _StubModule:
    """Generic stand-in for any class the checkpoint pickle references."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


def _make_stub_class(module, name):
    return type(name, (_StubModule,), {'__module__': module})


def extract_torch_state_dict(checkpoint_path, verbose=False):
    """
    Extract {name: numpy array} from a torch checkpoint without the model
    repo that pickled it: classes that cannot be imported resolve to
    stubs, and the nn.Module object graph is walked through its
    _parameters / _buffers / _modules.

    Returns (state_dict, extras); extras carries the class names, stride,
    nc, yaml and a training-config block when the checkpoint has them.
    """

    class _ShimUnpickler(pickle.Unpickler):

        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                if verbose:
                    print('Stubbing {}.{}'.format(module, name))
                return _make_stub_class(module, name)

    def _shim_load(f, **kwargs):
        return _ShimUnpickler(f).load()

    shim_pickle = type(pickle)('shim_pickle')
    shim_pickle.Unpickler = _ShimUnpickler
    shim_pickle.load = _shim_load
    shim_pickle.loads = lambda b, **kw: _ShimUnpickler(
        io.BytesIO(b)).load()

    ckpt = torch.load(checkpoint_path, map_location='cpu',
                      pickle_module=shim_pickle, weights_only=False)

    model_obj = None
    extras = {}
    if isinstance(ckpt, dict):
        # Top-level training-config blocks (an 'args' Namespace or a
        # 'model_config' dict next to the weights)
        for cfg_key in ('args', 'model_config', 'config'):
            cfg = ckpt.get(cfg_key)
            if cfg is None:
                continue
            cfg_dict = cfg if isinstance(cfg, dict) else \
                getattr(cfg, '__dict__', {})
            clean = {}
            for k, v in dict(cfg_dict).items():
                try:
                    if hasattr(v, 'tolist'):
                        v = v.tolist()
                    json.dumps(v)
                    clean[k] = v
                except (TypeError, ValueError):
                    pass
            if clean:
                extras['model_config'] = clean
                break
        for key in ('model', 'ema'):
            if key in ckpt and ckpt[key] is not None:
                model_obj = ckpt[key]
                break
        if model_obj is None and all(
                hasattr(v, 'shape') for v in ckpt.values()):
            # Plain state dict
            return ({k: _to_numpy(v) for k, v in ckpt.items()}, extras)
    else:
        model_obj = ckpt

    if model_obj is None:
        raise ValueError('Could not find a model object in {}'.format(
            checkpoint_path))

    state = {}
    _walk_module(model_obj, '', state)

    # Metadata commonly attached to YOLO model objects
    d = getattr(model_obj, '__dict__', {})
    names = d.get('names', None)
    if names is not None:
        extras['names'] = names if isinstance(names, (list, dict)) \
            else list(names)
    for attr in ('stride', 'nc', 'yaml'):
        if attr in d:
            try:
                v = d[attr]
                if hasattr(v, 'tolist'):
                    v = v.tolist()
                json.dumps(v)
                extras[attr] = v
            except (TypeError, ValueError):
                pass

    return state, extras


def _to_numpy(t):
    return t.detach().cpu().numpy() if hasattr(t, 'detach') else np.asarray(t)


def _walk_module(obj, prefix, out):
    """Recursively collect parameters/buffers from a (stubbed) nn.Module."""

    d = getattr(obj, '__dict__', None)
    if d is None:
        return
    for group in ('_parameters', '_buffers'):
        tensors = d.get(group, None)
        if isinstance(tensors, dict):
            for name, t in tensors.items():
                if t is not None and hasattr(t, 'shape'):
                    key = '{}.{}'.format(prefix, name) if prefix else name
                    out[key] = _to_numpy(t)
    modules = d.get('_modules', None)
    if isinstance(modules, dict):
        for name, child in modules.items():
            if child is None:
                continue
            child_prefix = '{}.{}'.format(prefix, name) if prefix else name
            _walk_module(child, child_prefix, out)


#%% BN fusion and layout conversion


def fuse_conv_bn(conv_w, bn_weight, bn_bias, bn_mean, bn_var, eps=1e-3):
    """
    Fold BatchNorm into conv weights. conv_w is OIHW; returns (w, b) with w
    still OIHW. YOLOv5 BatchNorm uses eps=1e-3.
    """

    scale = bn_weight / np.sqrt(bn_var + eps)
    w = conv_w * scale[:, None, None, None]
    b = bn_bias - bn_mean * scale
    return w, b


def _oihw_to_hwio(w):
    return np.transpose(w, (2, 3, 1, 0))


class _TorchKeyReader:
    """Pulls fused (HWIO weight, bias) pairs out of a torch state dict."""

    def __init__(self, state_dict):
        # Strip leading 'model.' wrappers so keys start with the layer
        # index ('0.conv.weight', '24.m.0.weight', ...)
        self.sd = {}
        for k, v in state_dict.items():
            key = k
            while key.startswith('model.'):
                key = key[len('model.'):]
            self.sd[key] = v
        self.used = set()

    def conv(self, base):
        """
        Fused conv weights at [base] (e.g. '0' or '2.cv1'), from an
        already-fused checkpoint (conv.weight + conv.bias) or an unfused
        one (conv.weight + bn.*).
        """

        wk = base + '.conv.weight'
        if wk not in self.sd:
            raise KeyError('Missing key {}'.format(wk))
        w = self.sd[wk]
        self.used.add(wk)
        bk = base + '.conv.bias'
        bnk = base + '.bn.weight'
        if bnk in self.sd:
            bn_w = self.sd[base + '.bn.weight']
            bn_b = self.sd[base + '.bn.bias']
            bn_m = self.sd[base + '.bn.running_mean']
            bn_v = self.sd[base + '.bn.running_var']
            for suffix in ('.bn.weight', '.bn.bias', '.bn.running_mean',
                           '.bn.running_var', '.bn.num_batches_tracked'):
                self.used.add(base + suffix)
            w, b = fuse_conv_bn(w, bn_w, bn_b, bn_m, bn_v)
        elif bk in self.sd:
            b = self.sd[bk]
            self.used.add(bk)
        else:
            b = np.zeros(w.shape[0], dtype=w.dtype)
        return {'w': _oihw_to_hwio(np.asarray(w, np.float32)),
                'b': np.asarray(b, np.float32)}

    def plain_conv(self, base):
        """Unwrapped conv (detect heads): weight+bias directly at [base]."""

        w = np.asarray(self.sd[base + '.weight'], np.float32)
        b = np.asarray(self.sd[base + '.bias'], np.float32)
        self.used.add(base + '.weight')
        self.used.add(base + '.bias')
        return {'w': _oihw_to_hwio(w), 'b': b}

    def get(self, key, default=None):
        if key in self.sd:
            self.used.add(key)
            return self.sd[key]
        return default


def convert_yolov5_state_dict(state_dict, config):
    """
    Map a YOLOv5 torch state dict onto the layer structure of [config]
    (a YoloV5Config). Returns (params pytree, anchors ndarray or None).
    """

    reader = _TorchKeyReader(state_dict)
    params = {}
    anchors = None

    for i, entry in enumerate(config.layers):
        kind = entry['kind']
        name = 'l{}'.format(i)
        base = str(i)
        if kind == 'conv':
            params[name] = reader.conv(base)
        elif kind == 'c3':
            node = {
                'cv1': reader.conv(base + '.cv1'),
                'cv2': reader.conv(base + '.cv2'),
                'cv3': reader.conv(base + '.cv3'),
            }
            for j in range(entry['n']):
                node['m{}'.format(j)] = {
                    'cv1': reader.conv('{}.m.{}.cv1'.format(base, j)),
                    'cv2': reader.conv('{}.m.{}.cv2'.format(base, j)),
                }
            params[name] = node
        elif kind == 'sppf':
            params[name] = {
                'cv1': reader.conv(base + '.cv1'),
                'cv2': reader.conv(base + '.cv2'),
            }
        elif kind == 'detect':
            heads = {}
            for lvl in range(len(entry['frm'])):
                heads['m{}'.format(lvl)] = reader.plain_conv(
                    '{}.m.{}'.format(base, lvl))
            params[name] = heads
            # The anchors buffer is grid-relative (divided by stride);
            # convert back to pixels
            raw_anchors = reader.get(base + '.anchors')
            if raw_anchors is not None:
                a = np.asarray(raw_anchors, np.float32)
                strides = np.asarray(config.strides, np.float32)
                anchors = a * strides[:, None, None]
        # 'up'/'cat' have no parameters

    return params, anchors


def convert_rfdetr_state_dict(state_dict, config):
    """
    Map an RF-DETR torch state dict (the HF Dinov2WithRegisters backbone
    naming and the LW-DETR transformer naming) onto the models/rfdetr.py
    parameter structure, as the JAX converter does. Returns the numpy
    params pytree.
    """

    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    def lin(prefix):
        return {'w': sd[prefix + '.weight'].T.astype(np.float32),
                'b': sd[prefix + '.bias'].astype(np.float32)}

    def ln(prefix):
        return {'g': sd[prefix + '.weight'].astype(np.float32),
                'b': sd[prefix + '.bias'].astype(np.float32)}

    def conv(prefix):
        # torch OIHW -> HWIO
        return {'w': sd[prefix + '.weight'].transpose(2, 3, 1, 0)
                .astype(np.float32),
                'b': sd[prefix + '.bias'].astype(np.float32)}

    def mlp3(prefix):
        return {'l{}'.format(i): lin('{}.layers.{}'.format(prefix, i))
                for i in range(3)}

    enc = 'backbone.0.encoder'
    emb = enc + '.embeddings'
    c = config

    blocks = []
    for i in range(c.vit_depth):
        base = '{}.encoder.layer.{}'.format(enc, i)
        att = base + '.attention.attention'
        q = lin(att + '.query')
        k = lin(att + '.key')
        v = lin(att + '.value')
        blocks.append({
            'norm1': ln(base + '.norm1'),
            'qkv': {'w': np.concatenate([q['w'], k['w'], v['w']],
                                        axis=1),
                    'b': np.concatenate([q['b'], k['b'], v['b']])},
            'proj': lin(base + '.attention.output.dense'),
            'ls1': {'g': sd[base + '.layer_scale1.lambda1']
                    .astype(np.float32)},
            'norm2': ln(base + '.norm2'),
            'fc1': lin(base + '.mlp.fc1'),
            'fc2': lin(base + '.mlp.fc2'),
            'ls2': {'g': sd[base + '.layer_scale2.lambda1']
                    .astype(np.float32)},
        })

    dec_layers = []
    i = 0
    while 'transformer.decoder.layers.{}.norm1.weight'.format(i) in sd:
        base = 'transformer.decoder.layers.{}'.format(i)
        in_w = sd[base + '.self_attn.in_proj_weight']
        in_b = sd[base + '.self_attn.in_proj_bias']
        dec_layers.append({
            'self_qkv': {'w': in_w.T.astype(np.float32),
                         'b': in_b.astype(np.float32)},
            'self_proj': lin(base + '.self_attn.out_proj'),
            'norm1': ln(base + '.norm1'),
            'sampling_offsets': lin(base + '.cross_attn'
                                    '.sampling_offsets'),
            'attention_weights': lin(base + '.cross_attn'
                                     '.attention_weights'),
            'value_proj': lin(base + '.cross_attn.value_proj'),
            'output_proj': lin(base + '.cross_attn.output_proj'),
            'norm2': ln(base + '.norm2'),
            'linear1': lin(base + '.linear1'),
            'linear2': lin(base + '.linear2'),
            'norm3': ln(base + '.norm3'),
        })
        i += 1

    return {
        'patch_embed': conv(emb + '.patch_embeddings.projection'),
        'cls_token': sd[emb + '.cls_token'].astype(np.float32),
        'register_tokens': sd[emb + '.register_tokens']
        .astype(np.float32),
        'pos_embed': sd[emb + '.position_embeddings']
        .astype(np.float32),
        'blocks': {'b{}'.format(k): blk
                   for k, blk in enumerate(blocks)},
        'out_norms': {
            'n{}'.format(k): ln('backbone.0.out_norms.{}'.format(k))
            for k in range(len(c.out_block_indexes))},
        'projector': {
            'conv1': conv('backbone.0.projector.conv1'),
            'norm1': ln('backbone.0.projector.norm1'),
            'downs': {
                'd{}'.format(k):
                conv('backbone.0.projector.downs.{}'.format(k))
                for k in range(c.num_levels - 1)},
            'down_norms': {
                'n{}'.format(k):
                ln('backbone.0.projector.down_norms.{}'.format(k))
                for k in range(c.num_levels - 1)},
        },
        'level_embed': sd['transformer.level_embed']
        .astype(np.float32),
        'enc_output': lin('transformer.enc_output'),
        'enc_output_norm': ln('transformer.enc_output_norm'),
        'enc_out_class_embed': lin('transformer.enc_out_class_embed'),
        'enc_out_bbox_embed': mlp3('transformer.enc_out_bbox_embed'),
        'ref_point_head': {
            'l0': lin('transformer.ref_point_head.layers.0'),
            'l1': lin('transformer.ref_point_head.layers.1'),
        },
        'decoder': {'d{}'.format(k): layer
                    for k, layer in enumerate(dec_layers)},
        'decoder_norm': ln('transformer.decoder.norm'),
        'class_embed': lin('class_embed'),
        'bbox_embed': mlp3('bbox_embed'),
    }


def infer_rfdetr_arch(state_dict):
    """
    The RF-DETR preset whose widths and depths (ViT width and blocks,
    transformer width, decoder layers) the state dict has; rfdetr_base
    when none or several match. The JAX converter takes rfdetr_base
    whenever no rfdetr arch is given, so it cannot convert another
    preset's checkpoint without one (load_detector on a .pt passes none).
    """

    from megadetector_tpu_torch.models.rfdetr import PRESETS

    enc = 'backbone.0.encoder.'
    key = enc + 'embeddings.patch_embeddings.projection.weight'
    if key not in state_dict or 'transformer.enc_output.weight' not in \
            state_dict:
        return 'rfdetr_base'

    def count(pattern):
        n = 0
        while pattern.format(n) in state_dict:
            n += 1
        return n

    widths = (np.shape(state_dict[key])[0],
              count(enc + 'encoder.layer.{}.norm1.weight'),
              np.shape(state_dict['transformer.enc_output.weight'])[0],
              count('transformer.decoder.layers.{}.norm1.weight'))
    matches = [name for name, p in PRESETS.items()
               if (p[0], p[1], p[6], p[7]) == widths]
    return matches[0] if len(matches) == 1 else 'rfdetr_base'


def convert_rfdetr_checkpoint(checkpoint_path, output_path=None,
                              arch='rfdetr_base', num_classes=None,
                              image_size=None, class_names=None,
                              verbose=False):
    """
    Convert an RF-DETR .pth checkpoint into .npz + metadata.json, the
    arrays and metadata the JAX converter writes: the state dict through
    the stub unpickler, mapped by convert_rfdetr_state_dict; resolution
    and class names from the checkpoint's model_config block where it has
    them. Returns the output path.
    """

    from megadetector_tpu_torch.models.rfdetr import RFDetrConfig

    state, extras = extract_torch_state_dict(checkpoint_path)
    model_config = extras.get('model_config', {}) or {}
    if num_classes is None:
        num_classes = int(model_config.get('num_classes', 0)) or None
    if num_classes is None:
        num_classes = state['class_embed.bias'].shape[0]
    if image_size is None:
        image_size = int(model_config.get('resolution', 560))
    if class_names is None:
        class_names = extras.get(
            'class_names',
            model_config.get('class_names', model_config.get('names')))

    config = RFDetrConfig(arch, num_classes=num_classes,
                          image_size=image_size)
    params = convert_rfdetr_state_dict(state, config)

    if output_path is None:
        output_path = os.path.splitext(checkpoint_path)[0] + '.npz'
    metadata = {
        'metadata_format_version': 1.0,
        'arch': arch,
        'model_type': 'rfdetr',
        'num_classes': int(num_classes),
        'image_size': int(image_size),
        'class_names': list(class_names) if class_names else None,
    }
    save_checkpoint(params, output_path, metadata)
    if verbose:
        print('Converted {} -> {}'.format(checkpoint_path, output_path))
    return output_path


def convert_megadetector_checkpoint(checkpoint_path, output_path=None,
                                    arch=None, num_classes=None,
                                    model_version=None, image_size=1280,
                                    verbose=False):
    """
    Convert a reference MegaDetector .pt checkpoint into a .npz +
    metadata.json, the arrays and metadata the JAX package's converter
    writes, routing by the state dict's keys as it does: RF-DETR
    (class_embed / transformer.decoder keys) to convert_rfdetr_checkpoint,
    the preset from infer_rfdetr_arch unless [arch] is an rfdetr one;
    ultralytics (a .dfl. key or a cv3 '.2.weight' head conv) to
    models/yolov8.convert_ultralytics_state_dict, the arch taken from the
    stem width unless [arch] is a yolov8 one; else YOLOv5. Returns the
    output path.
    """

    from megadetector_tpu_torch.models import registry
    from megadetector_tpu_torch.models.yolov5 import YoloV5Config

    state_dict, extras = extract_torch_state_dict(
        checkpoint_path, verbose=verbose)

    if 'class_embed.bias' in state_dict or any(
            k.startswith('transformer.decoder') for k in state_dict):
        return convert_rfdetr_checkpoint(
            checkpoint_path, output_path,
            arch=arch if (arch or '').startswith('rfdetr')
            else infer_rfdetr_arch(state_dict),
            num_classes=num_classes, verbose=verbose)

    if model_version is None:
        model_version = registry.get_detector_version_from_model_file(
            checkpoint_path) or 'unknown'
    if arch is None:
        entry = registry.known_models.get(model_version, {})
        arch = entry.get('arch', 'yolov5l6')
        image_size = entry.get('image_size', image_size)

    is_ultralytics = any('.dfl.' in k or ('.cv3.' in k and '.2.weight' in k)
                         for k in state_dict)

    if num_classes is None:
        names = extras.get('names')
        if names is not None:
            num_classes = len(names)
        elif is_ultralytics:
            cls_keys = sorted(k for k in state_dict
                              if '.cv3.0.2.weight' in k)
            if not cls_keys:
                raise ValueError('Cannot infer the class count of {}'
                                 .format(checkpoint_path))
            num_classes = state_dict[cls_keys[0]].shape[0]
        else:
            # out_channels of a detect-head conv = na * (5 + nc); only keys
            # that END at the level index are heads (C3 blocks also hold
            # '.m.0.cv1...')
            head_keys = [k for k in state_dict
                         if re.search(r'\.m\.\d+\.weight$', k)]
            if not head_keys:
                raise ValueError('Cannot infer the class count of {}'
                                 .format(checkpoint_path))
            out_ch = state_dict[sorted(head_keys)[0]].shape[0]
            num_classes = out_ch // 3 - 5

    if is_ultralytics:
        from megadetector_tpu_torch.models.yolov8 import (
            YoloV8Config, convert_ultralytics_state_dict)
        if not arch.startswith('yolov8'):
            # The variant from the stem width
            stem_key = [k for k in state_dict
                        if k.endswith('0.conv.weight')][0]
            arch = {16: 'yolov8n', 32: 'yolov8s', 48: 'yolov8m',
                    64: 'yolov8l', 80: 'yolov8x'}.get(
                        state_dict[stem_key].shape[0], 'yolov8l')
        config = YoloV8Config(arch, num_classes=num_classes)
        params = convert_ultralytics_state_dict(state_dict, config)
        model_type = 'ultralytics'
    else:
        config = YoloV5Config(arch, num_classes=num_classes)
        params, anchors = convert_yolov5_state_dict(state_dict, config)
        if anchors is not None:
            config.anchors = anchors
        model_type = 'yolov5'

    names = extras.get('names',
                       ['animal', 'person', 'vehicle'][:num_classes])
    if isinstance(names, dict):
        names = [names[k] for k in sorted(names, key=lambda x: int(x))]

    metadata = {
        'metadata_format_version': 1.0,
        'model_version_string': model_version,
        'arch': arch,
        'model_type': model_type,
        'num_classes': int(num_classes),
        'class_names': list(names),
        'image_size': int(image_size),
        'strides': [int(s) for s in config.strides],
    }
    if getattr(config, 'anchors', None) is not None:
        metadata['anchors'] = np.asarray(config.anchors).tolist()

    if output_path is None:
        output_path = os.path.join(
            os.path.dirname(os.path.abspath(checkpoint_path)),
            'md_{}.npz'.format(model_version))

    save_checkpoint(params, output_path, metadata)
    if verbose:
        print('Converted {} -> {}'.format(checkpoint_path, output_path))
    return output_path


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


QUANTIZATION_MODES = ('chain', 'static')


def quantize_checkpoint(input_path, output_path, calibration_folder=None,
                        calibration_image_size=None, n_calibration_images=8,
                        verbose=False, mode='chain', *,
                        calibration_images=None, device=None):
    """
    Write an int8 checkpoint from a converted float checkpoint (the JAX
    package's quantize_checkpoint, whose positional arguments these are),
    calibrating with the port's own forward on [device] (keyword only;
    None: the card; pass 'cpu' for the CPU).

    mode='chain' (default): the JAX package's MDv5a policy. l0 float,
    every later conv int8 with calibrated static x/y scales, the detect
    heads float; l2's cv1 and cv2 share the scales of the merged node the
    JAX package folds them into. Written unfolded; the JAX TPUDetector
    loads it as it is.

    mode='static': quantization.quantize_params' policy (int8 where c_in
    * k * k >= 288 and c_out >= 64, the detect heads included once
    3 * (5 + nc) >= 64) with a calibrated float32 x_scale per int8 conv
    and float activations between layers; not folded, as the JAX package
    writes it.

    Any other mode raises ValueError (the JAX package writes every mode
    but 'chain' as a static checkpoint named 'int8-<mode>').

    Calibration images: [calibration_images] (keyword only; [N, H, W, 3]
    float in [0, 1]), else up to n_calibration_images from
    [calibration_folder] letterboxed to the square calibration canvas,
    else 4 uniform-noise canvases from RandomState(0). The canvas defaults
    to the checkpoint's image_size.
    """

    from megadetector_tpu_torch.models.yolov5 import YoloV5Config
    from megadetector_tpu_torch.ops import quantization as q

    if mode not in QUANTIZATION_MODES:
        raise ValueError('quantize_checkpoint: mode must be one of {}, got '
                         '{!r}'.format(QUANTIZATION_MODES, mode))
    params, metadata = load_checkpoint(input_path)
    metadata = metadata or {}
    arch = metadata.get('arch', 'yolov5l6')
    if not arch.startswith('yolov5'):
        raise ValueError(
            'int8-{} quantization supports the yolov5 family only '
            '(checkpoint arch: {})'.format(mode, arch))
    config = YoloV5Config(arch, num_classes=int(metadata.get('num_classes',
                                                             3)),
                          anchors=metadata.get('anchors'))
    params = unfold_early_params(params, config)
    if any(k.split('/')[-1] == 'w_q' for k in flatten_params(params)):
        raise ValueError('{} is already quantized'.format(input_path))
    if mode == 'chain':
        detect_name = 'l{}'.format(len(config.layers) - 1)
        params_q = q.quantize_params_chain(
            params, skip_names=(detect_name,),
            float_store_names=q.DEFAULT_FLOAT_STORE_LAYERS_FOLDED)
    else:
        params_q = q.quantize_params(params)

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

    if mode == 'chain':
        q.calibrate_chain_scales(config, params_q, samples, device=device)
        _share_merged_scales(params_q)
    else:
        q.calibrate_activation_scales(config, params_q, samples,
                                      device=device)

    metadata = dict(metadata)
    metadata['quantized'] = True
    metadata['quantization'] = 'int8-' + mode
    save_checkpoint(params_q, output_path, metadata)
    if verbose:
        print('Quantized {} -> {}'.format(input_path, output_path))
    return output_path


def main(argv=None):
    """CLI: python -m megadetector_tpu_torch.models.convert_weights
    ckpt.pt [out.npz]; with --quantize, also <out>.int8.npz."""

    import argparse
    parser = argparse.ArgumentParser(
        description='Convert a torch MegaDetector checkpoint to the .npz '
                    'format the port (and the JAX package) loads')
    parser.add_argument('checkpoint', help='input .pt file')
    parser.add_argument('output', nargs='?', default=None,
                        help='output .npz path')
    parser.add_argument('--arch', default=None)
    parser.add_argument('--num_classes', type=int, default=None)
    parser.add_argument('--model_version', default=None)
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--quantize', action='store_true',
                        help='also write an int8-chain checkpoint '
                             '(<output>.int8.npz)')
    parser.add_argument('--calibration_folder', default=None)
    parser.add_argument('--device', default=None,
                        help='where --quantize calibrates: cuda, cuda:N or '
                             'cpu (default: cuda, which needs a card)')
    args = parser.parse_args(argv)
    out = convert_megadetector_checkpoint(
        args.checkpoint, args.output, arch=args.arch,
        num_classes=args.num_classes, model_version=args.model_version,
        verbose=args.verbose)
    print(out)
    if args.quantize:
        q_out = os.path.splitext(out)[0] + '.int8.npz'
        quantize_checkpoint(out, q_out,
                            calibration_folder=args.calibration_folder,
                            verbose=args.verbose, device=args.device)
        print(q_out)
    return out


if __name__ == '__main__':
    main()
