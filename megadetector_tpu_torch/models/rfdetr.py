"""
RF-DETR detection network as a torch nn.Module: counterpart of
megadetector_tpu/models/rfdetr.py (a DINOv2 ViT with register tokens and
windowed attention, a projector to a two-level pyramid, two-stage top-Q
proposals, decoder layers of query self-attention and multi-scale
deformable cross-attention with iterative box refinement).

RFDetrConfig, PRESETS and init_params are the JAX module's, so the same
seed gives the same arrays. The forward is the JAX apply() op for op, with
the parameters in a ParamTree (models/params.py), and gives each op the
dtype JAX gives it. In bf16 the compute dtype reaches the patch embedding,
the first block's first LayerNorm, the query position head and the
deformable attention's output projection; elsewhere float32 LayerNorm
parameters promote the activations to float32, and _dense casts its
weights to its input's dtype, as in JAX. One departure, in bf16 only: the
projector's convs take their bf16 weights up to their float32 input, as
_dense does. The JAX apply raises TypeError there (lax.conv_general_dilated
requires equal dtypes), a fault of the reference (ROADMAP C).

Numerical points kept from the JAX code:
- the stored square position embedding is resized to the patch grid by
  resize_pos_embed, jax.image.resize 'bilinear' with its default
  antialias=True: an axis shorter than the stored grid is low-pass
  filtered, which F.interpolate without antialias does not do;
- windowed blocks: the cls and register tokens join every window and are
  averaged back over the windows, windows taken in (row, column) order;
- two-stage selection with ops/decode.topk_lower_index_first (the
  jax.lax.top_k tie rule);
- deformable sampling as the JAX gather: loc * size - 0.5, floor, four
  taps zeroed outside the map, a flat index over (position, head), the
  softmax over levels x points in float32;
- _sine_embed_2d returns (y, x) order; GELU is the erf form;
- attention softmax in float32, written out (no
  scaled_dot_product_attention, which would change the reduction order).

apply() emits the shared decoded layout [B, Q, 5+nc] (obj = 1, sigmoid
class scores, cxcywh boxes in canvas pixels).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.models.params import (  # noqa: F401
    ParamNetwork, num_params)
from megadetector_tpu_torch.ops.decode import topk_lower_index_first

#%% Config (the JAX module's presets)

PRESETS = {
    # name: (vit_dim, vit_depth, vit_heads, patch, num_windows,
    #        out_block_indexes, hidden_dim, dec_layers, dec_heads,
    #        num_queries, num_levels, num_points)
    'rfdetr_nano':   (384, 12, 6, 14, 4, (2, 5, 8, 11), 256, 2, 8,
                      300, 2, 4),
    'rfdetr_small':  (384, 12, 6, 14, 4, (2, 5, 8, 11), 256, 3, 8,
                      300, 2, 4),
    'rfdetr_medium': (384, 12, 6, 14, 4, (2, 5, 8, 11), 384, 4, 8,
                      300, 2, 4),
    'rfdetr_base':   (768, 12, 12, 14, 4, (2, 5, 8, 11), 256, 3, 8,
                      300, 2, 4),
    'rfdetr_large':  (1024, 24, 16, 14, 4, (4, 11, 17, 23), 384, 6, 8,
                      300, 2, 4),
    # Tiny test-only variant
    'rfdetr_test':   (64, 4, 4, 14, 2, (1, 3), 64, 2, 4, 50, 2, 4),
}


class RFDetrConfig:
    """Resolved RF-DETR architecture."""

    def __init__(self, arch='rfdetr_base', num_classes=3,
                 image_size=560, num_registers=4):
        if arch not in PRESETS:
            raise ValueError('Unknown rfdetr arch {}'.format(arch))
        (self.vit_dim, self.vit_depth, self.vit_heads, self.patch,
         self.num_windows, self.out_block_indexes, self.hidden_dim,
         self.dec_layers, self.dec_heads, self.num_queries,
         self.num_levels, self.num_points) = PRESETS[arch]
        self.arch = arch
        self.num_classes = num_classes
        self.num_registers = num_registers
        self.image_size = image_size
        self.mlp_ratio = 4
        # Global-attention blocks: the feature-output blocks
        self.global_block_indexes = set(self.out_block_indexes)
        # Input resolution must tile into patch * num_windows
        self.size_multiple = self.patch * self.num_windows
        self.max_stride = self.size_multiple
        self.strides = tuple(self.patch * (2 ** i)
                             for i in range(self.num_levels))

    @property
    def num_outputs(self):
        return self.num_classes + 5


#%% Init (the JAX module's draws)

def _linear(rng, d_in, d_out, zero=False, std=None):
    if zero:
        w = np.zeros((d_in, d_out), np.float32)
    else:
        s = std if std is not None else math.sqrt(2.0 / (d_in + d_out))
        w = rng.standard_normal((d_in, d_out)).astype(np.float32) * s
    return {'w': w, 'b': np.zeros((d_out,), np.float32)}


def _ln_params(d):
    return {'g': np.ones((d,), np.float32),
            'b': np.zeros((d,), np.float32)}


def _vit_block(rng, dim, heads):
    return {
        'norm1': _ln_params(dim),
        'qkv': _linear(rng, dim, 3 * dim),
        'proj': _linear(rng, dim, dim),
        'ls1': {'g': np.full((dim,), 1e-5, np.float32)},
        'norm2': _ln_params(dim),
        'fc1': _linear(rng, dim, 4 * dim),
        'fc2': _linear(rng, 4 * dim, dim),
        'ls2': {'g': np.full((dim,), 1e-5, np.float32)},
    }


def _dec_layer(rng, c):
    d = c.hidden_dim
    return {
        'self_qkv': _linear(rng, d, 3 * d),
        'self_proj': _linear(rng, d, d),
        'norm1': _ln_params(d),
        'sampling_offsets': _linear(
            rng, d, c.dec_heads * c.num_levels * c.num_points * 2,
            zero=True),
        'attention_weights': _linear(
            rng, d, c.dec_heads * c.num_levels * c.num_points,
            zero=True),
        'value_proj': _linear(rng, d, d),
        'output_proj': _linear(rng, d, d),
        'norm2': _ln_params(d),
        'linear1': _linear(rng, d, 4 * d),
        'linear2': _linear(rng, 4 * d, d),
        'norm3': _ln_params(d),
    }


def init_params(config, seed=0):
    """Random numpy parameters (JAX pytree layout) for [config]."""

    c = config
    rng = np.random.RandomState(seed)
    grid = c.image_size // c.patch

    params = {
        'patch_embed': {
            'w': rng.standard_normal(
                (c.patch, c.patch, 3, c.vit_dim)).astype(np.float32)
            * math.sqrt(2.0 / (c.patch * c.patch * 3)),
            'b': np.zeros((c.vit_dim,), np.float32),
        },
        'cls_token': np.zeros((1, 1, c.vit_dim), np.float32),
        'register_tokens': np.zeros(
            (1, c.num_registers, c.vit_dim), np.float32),
        'pos_embed': (rng.standard_normal(
            (1, grid * grid + 1, c.vit_dim)) * 0.02).astype(np.float32),
        'blocks': {'b{}'.format(i): _vit_block(rng, c.vit_dim,
                                               c.vit_heads)
                   for i in range(c.vit_depth)},
        'out_norms': {'n{}'.format(i): _ln_params(c.vit_dim)
                      for i in range(len(c.out_block_indexes))},
        'projector': {
            'conv1': {
                'w': rng.standard_normal(
                    (3, 3, c.vit_dim * len(c.out_block_indexes),
                     c.hidden_dim)).astype(np.float32) * 0.02,
                'b': np.zeros((c.hidden_dim,), np.float32)},
            'norm1': _ln_params(c.hidden_dim),
            'downs': {
                'd{}'.format(i): {'w': rng.standard_normal(
                    (3, 3, c.hidden_dim, c.hidden_dim))
                    .astype(np.float32) * 0.02,
                    'b': np.zeros((c.hidden_dim,), np.float32)}
                for i in range(c.num_levels - 1)},
            'down_norms': {'n{}'.format(i): _ln_params(c.hidden_dim)
                           for i in range(c.num_levels - 1)},
        },
        'level_embed': (rng.standard_normal(
            (c.num_levels, c.hidden_dim)) * 0.02).astype(np.float32),
        'enc_output': _linear(rng, c.hidden_dim, c.hidden_dim),
        'enc_output_norm': _ln_params(c.hidden_dim),
        'enc_out_class_embed': _linear(rng, c.hidden_dim,
                                       c.num_classes),
        'enc_out_bbox_embed': {
            'l0': _linear(rng, c.hidden_dim, c.hidden_dim),
            'l1': _linear(rng, c.hidden_dim, c.hidden_dim),
            'l2': _linear(rng, c.hidden_dim, 4, zero=True),
        },
        'ref_point_head': {
            'l0': _linear(rng, 2 * c.hidden_dim, c.hidden_dim),
            'l1': _linear(rng, c.hidden_dim, c.hidden_dim),
        },
        'decoder': {'d{}'.format(i): _dec_layer(rng, c)
                    for i in range(c.dec_layers)},
        'decoder_norm': _ln_params(c.hidden_dim),
        'class_embed': _linear(rng, c.hidden_dim, c.num_classes),
        'bbox_embed': {
            'l0': _linear(rng, c.hidden_dim, c.hidden_dim),
            'l1': _linear(rng, c.hidden_dim, c.hidden_dim),
            'l2': _linear(rng, c.hidden_dim, 4, zero=True),
        },
    }

    # Deformable-DETR offset init: per-head directional bias
    for layer in params['decoder'].values():
        h = c.dec_heads
        thetas = np.arange(h, dtype=np.float32) * (2 * np.pi / h)
        grid_init = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid_init /= np.abs(grid_init).max(-1, keepdims=True)
        grid_init = np.tile(grid_init[:, None, None, :],
                            (1, c.num_levels, c.num_points, 1))
        for p in range(c.num_points):
            grid_init[:, :, p, :] *= (p + 1)
        layer['sampling_offsets']['b'] = grid_init.reshape(-1) \
            .astype(np.float32)
    return params


#%% Primitives (JAX dtypes: a bf16 input to a float32 parameter gives
# float32, as jnp promotes)


def layer_norm(p, x, eps=1e-6):
    """The JAX _ln: mean and variance reduced in float32 and given the
    input's dtype (jnp.mean / jnp.var), the normalization in the input's
    dtype, then * g + b, whose float32 parameters promote."""

    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True).to(x.dtype)
    var = xf.var(dim=-1, unbiased=False, keepdim=True).to(x.dtype)
    return (x - mean) * torch.rsqrt(var + eps) * p['g'] + p['b']


def _dense(p, x):
    return x @ p['w'].to(x.dtype) + p['b'].to(x.dtype)


def _mha(q, k, v, heads):
    """Multi-head attention over [..., N, D] tokens; the softmax in
    float32, then back to the query's dtype."""

    *lead, n, d = q.shape
    hd = d // heads

    def split(x):
        return x.reshape(*lead, x.shape[-2], heads, hd).transpose(-2, -3)

    qh, kh, vh = split(q), split(k), split(v)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = attn @ vh
    return out.transpose(-2, -3).reshape(*lead, n, d)


def vit_block(p, x, heads, windowed, num_windows, grid_hw, n_prefix):
    """
    One DINOv2 block with LayerScale. Windowed: the patch tokens attend
    within num_windows x num_windows spatial windows, the prefix (cls,
    registers) tokens joining every window and averaged back over them;
    global blocks attend over all tokens.
    """

    b, n, d = x.shape
    h, w = grid_hw

    def attn(tokens):
        y = layer_norm(p['norm1'], tokens)
        q, k, v = _dense(p['qkv'], y).chunk(3, dim=-1)
        y = _dense(p['proj'], _mha(q, k, v, heads))
        return tokens + y * p['ls1']['g'].to(y.dtype)

    if not windowed or num_windows <= 1:
        x = attn(x)
    else:
        nw = num_windows
        wh, ww = h // nw, w // nw
        prefix = x[:, :n_prefix]                       # [B, P, D]
        patches = x[:, n_prefix:].reshape(b, h, w, d)
        win = patches.reshape(b, nw, wh, nw, ww, d) \
            .permute(0, 1, 3, 2, 4, 5) \
            .reshape(b * nw * nw, wh * ww, d)
        pre = prefix.repeat_interleave(nw * nw, dim=0)  # [B*nw2, P, D]
        tokens = attn(torch.cat([pre, win], dim=1))
        pre2 = tokens[:, :n_prefix].reshape(b, nw * nw, n_prefix, d) \
            .mean(dim=1)
        win2 = tokens[:, n_prefix:] \
            .reshape(b, nw, nw, wh, ww, d) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, h * w, d)
        x = torch.cat([pre2, win2], dim=1)

    y = layer_norm(p['norm2'], x)
    y = _dense(p['fc2'], F.gelu(_dense(p['fc1'], y)))
    return x + y * p['ls2']['g'].to(y.dtype)


def _mlp3(p, x):
    """3-layer box-embed MLP (ReLU, final linear)."""

    x = torch.relu(_dense(p['l0'], x))
    x = torch.relu(_dense(p['l1'], x))
    return _dense(p['l2'], x)


def sine_embed_2d(xy, dim, temperature=10000.0):
    """Sine position encoding of normalized (x, y): [..., 2] ->
    [..., 2 * dim], float32, in (y, x) order."""

    scale = 2 * math.pi
    dim_t = torch.arange(dim // 2, dtype=torch.float32, device=xy.device)
    dim_t = torch.pow(temperature, 2 * dim_t / (dim // 2) / 2.0)
    out = []
    for i in range(2):
        v = xy[..., i:i + 1].float() * scale / dim_t
        out.append(torch.stack([torch.sin(v), torch.cos(v)], dim=-1)
                   .reshape(*xy.shape[:-1], -1))
    return torch.cat(out[::-1], dim=-1)


def deformable_attn(p, queries, ref_boxes, value_levels, level_shapes,
                    heads, num_points, dtype):
    """
    Multi-scale deformable cross-attention (Deformable-DETR semantics, the
    JAX gather). queries [B, Q, D]; ref_boxes [B, Q, 4] normalized cxcywh;
    value_levels: per level [B, H_l*W_l, D].
    """

    b, nq, d = queries.shape
    nl = len(value_levels)
    hd = d // heads

    value = _dense(p['value_proj'], torch.cat(value_levels, dim=1))
    value = value.reshape(b, value.shape[1], heads, hd)

    offsets = _dense(p['sampling_offsets'], queries).float()
    offsets = offsets.reshape(b, nq, heads, nl, num_points, 2)
    weights = _dense(p['attention_weights'], queries).float()
    weights = torch.softmax(weights.reshape(b, nq, heads, nl * num_points),
                            dim=-1).reshape(b, nq, heads, nl, num_points)

    ref_xy = ref_boxes[..., :2].float()
    ref_wh = ref_boxes[..., 2:].float()
    # Sampling locations, normalized to [0, 1]
    loc = ref_xy[:, :, None, None, None, :] + \
        offsets / num_points * ref_wh[:, :, None, None, None, :] * 0.5

    head_idx = torch.arange(heads, device=queries.device)[None, None, :,
                                                          None]
    outputs = torch.zeros((b, nq, heads, hd), dtype=torch.float32,
                          device=queries.device)
    start = 0
    for lvl in range(nl):
        h_l, w_l = level_shapes[lvl]
        n_l = h_l * w_l
        v_l = value[:, start:start + n_l].reshape(b, n_l * heads, hd)
        start += n_l

        xy = loc[:, :, :, lvl]                          # [B, Q, h, P, 2]
        x = xy[..., 0] * w_l - 0.5
        y = xy[..., 1] * h_l - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]

        def gather(ix, iy):
            inside = (ix >= 0) & (ix < w_l) & (iy >= 0) & (iy < h_l)
            ixc = ix.clamp(0, w_l - 1).to(torch.int64)
            iyc = iy.clamp(0, h_l - 1).to(torch.int64)
            # Flat index over (position, head): each head gathers its own
            # hd-slice
            flat = ((iyc * w_l + ixc) * heads + head_idx).reshape(b, -1)
            g = torch.gather(v_l, 1, flat[..., None].expand(-1, -1, hd))
            g = g.reshape(b, nq, heads, num_points, hd)
            return g.float() * inside[..., None].float()

        sampled = (gather(x0, y0) * (1 - fx) * (1 - fy) +
                   gather(x0 + 1, y0) * fx * (1 - fy) +
                   gather(x0, y0 + 1) * (1 - fx) * fy +
                   gather(x0 + 1, y0 + 1) * fx * fy)  # [B, Q, h, P, hd]
        outputs = outputs + torch.sum(
            sampled * weights[:, :, :, lvl, :, None], dim=3)

    out = outputs.reshape(b, nq, d).to(dtype)
    return _dense(p['output_proj'], out)


def _inverse_sigmoid(x, eps=1e-5):
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def resize_weights(in_size, out_size, device):
    """
    [in_size, out_size] float32 weights of jax.image.resize 'bilinear'
    along one axis (jax scale_and_translate's compute_weight_mat with the
    triangle kernel, antialias=True, translation 0): when downsampling the
    kernel widens by in_size / out_size (a low-pass filter); columns are
    normalized to sum 1.
    """

    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = float(np.float32(max(inv_scale, 1.0)))
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) +
              0.5) * inv_scale - 0.0 - 0.5
    x = (sample[None, :] - torch.arange(
        in_size, dtype=torch.float32, device=device)[:, None]).abs() / \
        kernel_scale
    w = torch.clamp(1 - x, min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_pos_embed(patch_pos, gh, gw):
    """jax.image.resize(patch_pos, (1, gh, gw, D), 'bilinear') of the
    float32 [1, side, side, D] embedding: each axis whose size changes is
    contracted with its resize_weights."""

    _, side_h, side_w, _ = patch_pos.shape
    if gh != side_h:
        patch_pos = torch.einsum('bhwd,hy->bywd', patch_pos, resize_weights(
            side_h, gh, patch_pos.device))
    if gw != side_w:
        patch_pos = torch.einsum('bhwd,wx->bhxd', patch_pos, resize_weights(
            side_w, gw, patch_pos.device))
    return patch_pos


def _conv(x, w, b, stride, padding, dtype):
    """NHWC conv (OIHW weight) in the dtype jnp promotes the input and the
    weight to, then + b in [dtype] (which promotes again)."""

    ct = torch.promote_types(x.dtype, w.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(ct), w.to(ct), None, stride,
                 padding)
    return y.permute(0, 2, 3, 1) + b.to(dtype)


#%% Forward


def backbone_features(config, params, x, dtype):
    """ViT backbone -> list of [B, H, W, vit_dim] selected features."""

    c = config
    b, hh, ww, _ = x.shape
    if hh % c.size_multiple or ww % c.size_multiple:
        raise ValueError('Input {}x{} is not a multiple of {}'.format(
            hh, ww, c.size_multiple))
    gh, gw = hh // c.patch, ww // c.patch

    tokens = _conv(x.to(dtype), params['patch_embed']['w'].to(dtype),
                   params['patch_embed']['b'], c.patch, 0, dtype)
    tokens = tokens.reshape(b, gh * gw, c.vit_dim)

    # The square-grid position embedding, resized to the patch grid
    pos = params['pos_embed'].float()
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    side = int(math.sqrt(patch_pos.shape[1]))
    patch_pos = resize_pos_embed(
        patch_pos.reshape(1, side, side, c.vit_dim), gh, gw)
    patch_pos = patch_pos.reshape(1, gh * gw, c.vit_dim)

    tokens = tokens + patch_pos.to(dtype)
    cls_tok = (params['cls_token'].float() + cls_pos).to(dtype)
    cls_tok = cls_tok.expand(b, 1, c.vit_dim)
    regs = params['register_tokens'].to(dtype).expand(
        b, c.num_registers, c.vit_dim)
    n_prefix = 1 + c.num_registers
    xx = torch.cat([cls_tok, regs, tokens], dim=1)

    feats = []
    for i in range(c.vit_depth):
        xx = vit_block(params['blocks']['b{}'.format(i)], xx, c.vit_heads,
                       i not in c.global_block_indexes, c.num_windows,
                       (gh, gw), n_prefix)
        if i in c.out_block_indexes:
            idx = list(c.out_block_indexes).index(i)
            f = layer_norm(params['out_norms']['n{}'.format(idx)],
                           xx[:, n_prefix:])
            feats.append(f.reshape(b, gh, gw, c.vit_dim))
    return feats


def pyramid(config, params, x, dtype):
    """The backbone and the projector: (per-level memory tokens [B,
    H_l*W_l, hidden] with the level embedding added, level shapes)."""

    c = config
    b = x.shape[0]
    feats = backbone_features(config, params, x, dtype)

    # Projector: concat levels -> conv -> pyramid
    pj = params['projector']
    f = _conv(torch.cat(feats, dim=-1), pj['conv1']['w'], pj['conv1']['b'],
              1, 1, dtype)
    levels = [F.gelu(layer_norm(pj['norm1'], f))]
    for di in range(c.num_levels - 1):
        down = pj['downs']['d{}'.format(di)]
        g = _conv(levels[-1], down['w'], down['b'], 2, 1, dtype)
        levels.append(F.gelu(layer_norm(pj['down_norms']['n{}'.format(di)],
                                        g)))

    level_shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
    tokens = [lv.reshape(b, h_l * w_l, c.hidden_dim) +
              params['level_embed'][lvl].to(dtype)
              for lvl, (lv, (h_l, w_l)) in enumerate(zip(levels,
                                                         level_shapes))]
    return tokens, level_shapes


def select_queries(config, params, tokens, level_shapes):
    """
    Two-stage proposals: score every memory token, take the top Q (the
    jax.lax.top_k tie rule), regress their anchor boxes. Returns
    (query contents [B, Q, D], reference boxes [B, Q, 4] normalized
    cxcywh float32, top_idx [B, Q]).
    """

    memory = torch.cat(tokens, dim=1)                   # [B, S, D]
    if memory.shape[1] < config.num_queries:
        # jax.lax.top_k raises here too
        raise ValueError('{} memory tokens for {} queries: the canvas is '
                         'too small for {}'.format(
                             memory.shape[1], config.num_queries,
                             config.arch))
    device = memory.device
    centers, scales = [], []
    for lvl, (h_l, w_l) in enumerate(level_shapes):
        ys = (torch.arange(h_l, dtype=torch.float32, device=device) +
              0.5) / h_l
        xs = (torch.arange(w_l, dtype=torch.float32, device=device) +
              0.5) / w_l
        cy, cx = torch.meshgrid(ys, xs, indexing='ij')
        centers.append(torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1))
        scales.append(torch.full((h_l * w_l, 2), 0.1 * (2 ** lvl),
                                 dtype=torch.float32, device=device))
    anchors_xy = torch.cat(centers, dim=0)              # [S, 2]
    anchors_wh = torch.cat(scales, dim=0)               # [S, 2]

    enc = layer_norm(params['enc_output_norm'],
                     _dense(params['enc_output'], memory))
    enc_logits = _dense(params['enc_out_class_embed'], enc)
    enc_score = enc_logits.float().amax(dim=-1)
    _, top_idx = topk_lower_index_first(enc_score,
                                        config.num_queries)  # [B, Q]

    q_content = torch.gather(
        enc, 1, top_idx[..., None].expand(-1, -1, enc.shape[-1]))
    anchor_box = torch.cat([anchors_xy[top_idx], anchors_wh[top_idx]],
                           dim=-1)
    delta = _mlp3(params['enc_out_bbox_embed'], q_content).float()
    ref_boxes = torch.sigmoid(_inverse_sigmoid(anchor_box) + delta)
    return q_content, ref_boxes, top_idx


def apply(config, params, x, dtype=None, decode=True):
    """
    Run RF-DETR on [B, H, W, 3] images in [dtype] (None: x's dtype; H, W
    multiples of config.size_multiple). decode=True: [B, Q, 5+nc] (obj = 1, sigmoid
    class scores, cxcywh in canvas pixels); else (class_logits [B, Q, nc],
    normalized boxes [B, Q, 4]).
    """

    c = config
    if dtype is None:
        dtype = x.dtype
    hh, ww = x.shape[1:3]
    tokens, level_shapes = pyramid(config, params, x, dtype)
    queries, ref_boxes, _ = select_queries(config, params, tokens,
                                           level_shapes)

    for li in range(c.dec_layers):
        layer = params['decoder']['d{}'.format(li)]
        # Query position from the reference box centres
        qpos = sine_embed_2d(ref_boxes[..., :2], c.hidden_dim)
        qpos = _dense(params['ref_point_head']['l1'], torch.relu(
            _dense(params['ref_point_head']['l0'], qpos.to(dtype))))
        q_, k_, v_ = _dense(layer['self_qkv'], queries + qpos).chunk(3,
                                                                     dim=-1)
        sa = _mha(q_, k_, v_, c.dec_heads)
        queries = layer_norm(layer['norm1'],
                             queries + _dense(layer['self_proj'], sa))

        ca = deformable_attn(layer, queries + qpos, ref_boxes, tokens,
                             level_shapes, c.dec_heads, c.num_points, dtype)
        queries = layer_norm(layer['norm2'], queries + ca)

        ff = _dense(layer['linear2'],
                    torch.relu(_dense(layer['linear1'], queries)))
        queries = layer_norm(layer['norm3'], queries + ff)

        # Iterative refinement
        delta = _mlp3(params['bbox_embed'], queries).float()
        ref_boxes = torch.sigmoid(_inverse_sigmoid(ref_boxes) + delta)

    queries = layer_norm(params['decoder_norm'], queries)
    class_logits = _dense(params['class_embed'], queries)

    if not decode:
        return class_logits, ref_boxes

    cls = torch.sigmoid(class_logits.float())
    cx = ref_boxes[..., 0] * ww
    cy = ref_boxes[..., 1] * hh
    bw = ref_boxes[..., 2] * ww
    bh = ref_boxes[..., 3] * hh
    obj = torch.ones_like(cx)
    return torch.cat([torch.stack([cx, cy, bw, bh, obj], dim=-1), cls],
                     dim=-1)


class RFDetr(ParamNetwork):
    """RF-DETR for an RFDetrConfig (ParamNetwork: load_params,
    set_compute_dtype, forward)."""

    PARAM_KEYS = ('patch_embed', 'cls_token', 'register_tokens',
                  'pos_embed', 'blocks', 'out_norms', 'projector',
                  'level_embed', 'enc_output', 'enc_output_norm',
                  'enc_out_class_embed', 'enc_out_bbox_embed',
                  'ref_point_head', 'decoder', 'decoder_norm', 'class_embed',
                  'bbox_embed')
    apply = staticmethod(apply)
