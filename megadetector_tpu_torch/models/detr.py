"""
DETR-style detection network (ViT encoder over patches, 2-d sine position
encodings, a decoder whose learned queries cross-attend to the encoder
memory, per-query class and box heads) as a torch nn.Module: counterpart
of megadetector_tpu/models/detr.py.

DetrConfig and init_params are the JAX module's. The forward is the JAX
apply() op for op over a ParamTree (models/params.py), each op in the
dtype JAX gives it: _dense casts its weight and bias to the compute dtype
and multiplies in the dtype jnp.dot promotes its operands to, so in bf16
the patch embedding runs in bf16 and, once the first LayerNorm's float32
parameters have promoted the tokens, every later dense layer runs in
float32 on bf16-rounded weights. GELU is the tanh form (jax.nn.gelu's
default approximate=True); RF-DETR's is the erf form. The sine position
encodings are computed in the compute dtype, as in JAX.

Decode emits the shared [B, Q, 5+nc] layout (obj = 1, sigmoid class
scores, cxcywh in canvas pixels).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.models.params import (  # noqa: F401
    ParamNetwork, num_params)
from megadetector_tpu_torch.models.rfdetr import layer_norm


class DetrConfig:
    """Resolved DETR-style architecture."""

    def __init__(self, arch='detr_small', num_classes=3, image_size=448):
        presets = {
            'detr_small': dict(patch=16, dim=384, depth=12, heads=6,
                               dec_dim=256, dec_depth=3, dec_heads=8,
                               num_queries=300),
            'detr_base': dict(patch=14, dim=768, depth=12, heads=12,
                              dec_dim=256, dec_depth=6, dec_heads=8,
                              num_queries=300),
            'detr_tiny': dict(patch=16, dim=96, depth=2, heads=3,
                              dec_dim=64, dec_depth=2, dec_heads=4,
                              num_queries=32),
        }
        if arch not in presets:
            raise ValueError('Unknown arch {}'.format(arch))
        self.arch = arch
        self.num_classes = num_classes
        self.image_size = image_size
        for k, v in presets[arch].items():
            setattr(self, k, v)
        self.mlp_ratio = 4
        # The letterbox stride: the ViT needs patch-aligned inputs
        self.max_stride = self.patch


#%% Initialization (the JAX module's draws)


def _linear(rng, d_in, d_out, zero=False):
    if zero:
        w = np.zeros((d_in, d_out), np.float32)
    else:
        w = rng.standard_normal((d_in, d_out)).astype(np.float32) * \
            (1.0 / math.sqrt(d_in))
    return {'w': w, 'b': np.zeros((d_out,), np.float32)}


def _layernorm(d):
    return {'g': np.ones((d,), np.float32),
            'b': np.zeros((d,), np.float32)}


def _attn_block(rng, dim, heads):
    return {
        'ln1': _layernorm(dim),
        'qkv': _linear(rng, dim, 3 * dim),
        'proj': _linear(rng, dim, dim),
        'ln2': _layernorm(dim),
        'mlp1': _linear(rng, dim, 4 * dim),
        'mlp2': _linear(rng, 4 * dim, dim),
    }


def _dec_block(rng, dim, heads):
    return {
        'ln1': _layernorm(dim),
        'self_qkv': _linear(rng, dim, 3 * dim),
        'self_proj': _linear(rng, dim, dim),
        'ln2': _layernorm(dim),
        'cross_q': _linear(rng, dim, dim),
        'cross_kv': _linear(rng, dim, 2 * dim),
        'cross_proj': _linear(rng, dim, dim),
        'ln3': _layernorm(dim),
        'mlp1': _linear(rng, dim, 4 * dim),
        'mlp2': _linear(rng, 4 * dim, dim),
    }


def init_params(config, seed=0):
    """Random numpy parameters; structure mirrors apply()."""

    rng = np.random.RandomState(seed)
    c = config
    params = {
        'patch_embed': _linear(rng, c.patch * c.patch * 3, c.dim),
        'enc_ln': _layernorm(c.dim),
        'enc': {'b{}'.format(i): _attn_block(rng, c.dim, c.heads)
                for i in range(c.depth)},
        'input_proj': _linear(rng, c.dim, c.dec_dim),
        'queries': rng.standard_normal(
            (c.num_queries, c.dec_dim)).astype(np.float32) * 0.02,
        'dec': {'b{}'.format(i): _dec_block(rng, c.dec_dim, c.dec_heads)
                for i in range(c.dec_depth)},
        'dec_ln': _layernorm(c.dec_dim),
        'class_head': _linear(rng, c.dec_dim, c.num_classes),
        'box_head1': _linear(rng, c.dec_dim, c.dec_dim),
        'box_head2': _linear(rng, c.dec_dim, 4),
    }
    return params


#%% Forward


def _dense(p, x, dtype):
    """jnp.dot(x, w.astype(dtype), preferred_element_type=x.dtype) +
    b.astype(dtype): the operands promoted to a common dtype, the product
    given x's dtype, then the bias add's promotion."""

    w = p['w'].to(dtype)
    ct = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(ct), w.to(ct)).to(x.dtype)
    return y + p['b'].to(dtype)


def _mha(q, k, v, heads):
    """[B, Nq, D] x [B, Nk, D] -> [B, Nq, D] multi-head attention (the
    softmax in the scores' dtype, as jax.nn.softmax computes it)."""

    b, nq, d = q.shape
    nk = k.shape[1]
    dh = d // heads

    def split(x, n):
        return x.reshape(b, n, heads, dh).permute(0, 2, 1, 3)

    qh = split(q, nq)
    kh = split(k, nk)
    vh = split(v, nk)
    scores = torch.einsum('bhqd,bhkd->bhqk', qh, kh) / math.sqrt(dh)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum('bhqk,bhkd->bhqd', attn, vh)
    return out.permute(0, 2, 1, 3).reshape(b, nq, d)


def sine_pos_embed(h, w, dim, dtype, device):
    """2-d sine/cosine position encoding [h*w, dim] in [dtype]."""

    if dim % 4:
        raise ValueError('dim {} is not a multiple of 4'.format(dim))
    quarter = dim // 4
    omega = 1.0 / torch.pow(10000, torch.arange(
        quarter, dtype=dtype, device=device) / quarter)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing='ij')
    ys = ys.reshape(-1)
    xs = xs.reshape(-1)
    return torch.cat([
        torch.sin(xs[:, None] * omega), torch.cos(xs[:, None] * omega),
        torch.sin(ys[:, None] * omega), torch.cos(ys[:, None] * omega),
    ], dim=1)


def _gelu(x):
    return F.gelu(x, approximate='tanh')


def apply(config, params, x, dtype=None, decode=True):
    """
    Run the network on [B, H, W, 3] images in [dtype] (None: x's dtype;
    H, W multiples of the patch size). decode=True: [B, num_queries, 5+nc] (obj = 1); else
    (class_logits, raw boxes).
    """

    if dtype is None:
        dtype = x.dtype
    x = x.to(dtype)
    c = config
    b, img_h, img_w, _ = x.shape
    gh, gw = img_h // c.patch, img_w // c.patch

    # Patchify: [B, gh * gw, patch * patch * 3]
    patches = x.reshape(b, gh, c.patch, gw, c.patch, 3)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
        b, gh * gw, c.patch * c.patch * 3)

    tokens = _dense(params['patch_embed'], patches, dtype)
    tokens = tokens + sine_pos_embed(gh, gw, c.dim, dtype, x.device)[None]

    for i in range(c.depth):
        blk = params['enc']['b{}'.format(i)]
        h = layer_norm(blk['ln1'], tokens)
        q, k, v = _dense(blk['qkv'], h, dtype).chunk(3, dim=-1)
        tokens = tokens + _dense(blk['proj'], _mha(q, k, v, c.heads), dtype)
        h = layer_norm(blk['ln2'], tokens)
        h = _gelu(_dense(blk['mlp1'], h, dtype))
        tokens = tokens + _dense(blk['mlp2'], h, dtype)

    memory = layer_norm(params['enc_ln'], tokens)
    memory = _dense(params['input_proj'], memory, dtype)
    memory = memory + sine_pos_embed(gh, gw, c.dec_dim, dtype, x.device)[None]

    queries = params['queries'].to(dtype)[None].expand(
        b, c.num_queries, c.dec_dim)

    for i in range(c.dec_depth):
        blk = params['dec']['b{}'.format(i)]
        h = layer_norm(blk['ln1'], queries)
        q, k, v = _dense(blk['self_qkv'], h, dtype).chunk(3, dim=-1)
        queries = queries + _dense(
            blk['self_proj'], _mha(q, k, v, c.dec_heads), dtype)
        h = layer_norm(blk['ln2'], queries)
        q = _dense(blk['cross_q'], h, dtype)
        k, v = _dense(blk['cross_kv'], memory, dtype).chunk(2, dim=-1)
        queries = queries + _dense(
            blk['cross_proj'], _mha(q, k, v, c.dec_heads), dtype)
        h = layer_norm(blk['ln3'], queries)
        h = _gelu(_dense(blk['mlp1'], h, dtype))
        queries = queries + _dense(blk['mlp2'], h, dtype)

    queries = layer_norm(params['dec_ln'], queries)

    class_logits = _dense(params['class_head'], queries, dtype)
    box_h = torch.relu(_dense(params['box_head1'], queries, dtype))
    box_raw = _dense(params['box_head2'], box_h, dtype)

    if not decode:
        return class_logits, box_raw

    boxes = torch.sigmoid(box_raw.float())  # cxcywh in [0, 1]
    cls = torch.sigmoid(class_logits.float())
    cx = boxes[..., 0] * img_w
    cy = boxes[..., 1] * img_h
    bw = boxes[..., 2] * img_w
    bh = boxes[..., 3] * img_h
    obj = torch.ones((b, c.num_queries, 1), dtype=torch.float32,
                     device=x.device)
    return torch.cat([cx[..., None], cy[..., None], bw[..., None],
                      bh[..., None], obj, cls], dim=-1)


class Detr(ParamNetwork):
    """DETR for a DetrConfig (ParamNetwork: load_params,
    set_compute_dtype, forward). DETR has no 4-d leaf: bf16 changes no
    stored weight, and _dense casts at each use."""

    PARAM_KEYS = ('patch_embed', 'enc_ln', 'enc', 'input_proj', 'queries',
                  'dec', 'dec_ln', 'class_head', 'box_head1', 'box_head2')
    apply = staticmethod(apply)
