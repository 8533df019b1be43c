"""
Greedy NMS keep mask: the CUDA kernel (csrc/nms.cu) and its plain PyTorch
version.

Replaces megadetector_tpu/ops/pallas_nms.py pallas_greedy_nms /
_nms_kernel (and the XLA _fixpoint_suppress the JAX default program runs).
The mask pass launches only the upper triangle of 256 x 256 tiles and is
bounded by its K(K-1)/2 IoU tests; the sweep resolves one 64-box chunk at a
time from its diagonal words (a serial chain in shared memory) and applies
it from a cp.async-prefetched tile (see the source note in csrc/nms.cu).
The constants and helpers below restate the kernel's geometry for the CPU
tests (tests/test_torch_nms_sweep.py).

greedy_nms_keep takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises KernelError. It calls the
custom operators mdtorch::greedy_nms_keep (the threshold a Python number,
its split passed by value) and mdtorch::greedy_nms_keep_t (the threshold
a 0-d tensor on the boxes' device, its split computed there by
threshold_split_tensor and read by the kernel from device memory, so that
one captured CUDA graph or exported program serves every threshold). Each
is one node of a traced graph; both give the same keep mask.
"""

import functools

import numpy as np
import torch

from megadetector_tpu_torch.ops import _build
from megadetector_tpu_torch.ops.decode import threshold_tensor

# Kernel launches made by greedy_nms_keep (the plain version never counts)
launches = 0

# csrc/nms.cu: the mask pass's square tile (rows and columns) and the
# sweep's widest ring stage (64-bit words a row)
MASK_TILE = 256
SWEEP_SEGMENT_WORDS = 128


def row_words(k):
    """Words a mask row holds: ceil(K / 64) rounded up to even, so every
    row starts on 16 bytes for the sweep's cp.async pieces."""

    return ((k + 63) // 64 + 1) & ~1


def sweep_smem_bytes(k):
    """Dynamic shared memory of the sweep: two ring stages of 64 rows and
    the removed bitmask."""

    seg = min(SWEEP_SEGMENT_WORDS, row_words(k))
    return 8 * (2 * 64 * seg + (k + 63) // 64)


@functools.lru_cache(maxsize=16)
def threshold_split(thresh):
    """
    (m, m_hi, m_lo, tie_up) of the kernel's division-free IoU test: with t
    = f32(thresh) and t+ the next float32 above it, m = (t + t+) / 2, exact
    in float64. RN_f32(inter / u) > t holds exactly when inter > m * u, or
    inter == m * u and t+ has an even mantissa (tie_up), since
    round-half-even then rounds up to t+. m_hi >= m (1 + 2^-19) and m_lo
    <= m (1 - 2^-19) in magnitude, as float32: a float32 product u * m_hi
    is off by at most 2^-24, so inter > u * m_hi proves inter > m * u and
    inter < u * m_lo proves inter < m * u. Where |m| < 2^-60 (the product
    could leave float32's normal range) they are +inf / -inf, and every
    test takes the exact path.
    """

    t = np.float32(thresh)
    t_next = np.nextafter(t, np.float32(np.inf))
    m = (float(t) + float(t_next)) / 2.0
    tie_up = int(np.array(t_next).view(np.uint32)) % 2 == 0
    if np.isfinite(m) and abs(m) >= 2.0 ** -60:
        margin = abs(m) * 2.0 ** -19
        m_hi = np.float32(m + margin)
        if float(m_hi) < m + margin:
            m_hi = np.nextafter(m_hi, np.float32(np.inf))
        m_lo = np.float32(m - margin)
        if float(m_lo) > m - margin:
            m_lo = np.nextafter(m_lo, np.float32(-np.inf))
        m_hi, m_lo = float(m_hi), float(m_lo)
    else:
        m_hi, m_lo = float('inf'), float('-inf')
    return m, m_hi, m_lo, tie_up


def threshold_split_tensor(thresh):
    """
    threshold_split of a 0-d float32 tensor, computed with torch ops on
    its device (so a CUDA graph can capture it): float64 [4] holding m,
    m_hi, m_lo and tie_up (1.0 or 0.0), bit for bit threshold_split's.
    Every step is exact in float64 but the two float32 roundings, which
    are corrected toward their bound as threshold_split corrects them.
    """

    t = thresh.reshape(()).to(torch.float32)
    inf = torch.full((), float('inf'), dtype=torch.float32, device=t.device)
    t_next = torch.nextafter(t, inf)
    m = (t.double() + t_next.double()) * 0.5
    tie_up = (t_next.view(torch.int32) & 1) == 0
    margin = m.abs() * 2.0 ** -19
    hi, lo = m + margin, m - margin
    m_hi = hi.float()
    m_hi = torch.where(m_hi.double() < hi, torch.nextafter(m_hi, inf), m_hi)
    m_lo = lo.float()
    m_lo = torch.where(m_lo.double() > lo, torch.nextafter(m_lo, -inf),
                       m_lo)
    bounded = torch.isfinite(m) & (m.abs() >= 2.0 ** -60)
    return torch.stack([m, torch.where(bounded, m_hi, inf).double(),
                        torch.where(bounded, m_lo, -inf).double(),
                        tie_up.double()])


def pairwise_iou_xyxy(boxes):
    """IoU matrix [..., K, K] for xyxy boxes [..., K, 4] (JAX formula)."""

    x0, y0, x1, y1 = boxes.unbind(-1)
    area = torch.clamp(x1 - x0, min=0.0) * torch.clamp(y1 - y0, min=0.0)
    ix0 = torch.maximum(x0[..., :, None], x0[..., None, :])
    iy0 = torch.maximum(y0[..., :, None], y0[..., None, :])
    ix1 = torch.minimum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.minimum(y1[..., :, None], y1[..., None, :])
    inter = torch.clamp(ix1 - ix0, min=0.0) * torch.clamp(iy1 - iy0,
                                                           min=0.0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def greedy_nms_keep_reference(boxes, valid, thresh):
    """
    Plain version: the sequential greedy scan over the IoU matrix
    (megadetector_tpu/ops/nms.py _greedy_suppress), batched.

    Args:
        boxes: [B, K, 4] float32 xyxy, class-offset, score-sorted
        valid: [B, K] bool
        thresh: IoU threshold, a number or a 0-d tensor (compared in
            float32, strict '>')

    Returns:
        [B, K] bool keep mask
    """

    k = boxes.shape[1]
    thr = threshold_tensor(thresh, boxes.device)
    overlap = torch.triu(pairwise_iou_xyxy(boxes.float()) > thr,
                         diagonal=1)
    keep = valid.clone()
    for i in range(k):
        keep &= ~(overlap[:, i, :] & keep[:, i:i + 1])
    return keep


def greedy_nms_keep(boxes, valid, thresh):
    """
    Greedy NMS keep mask [B, K] bool for score-sorted, class-offset xyxy
    boxes [B, K, 4] float32 and valid [B, K] bool: box i, while kept,
    suppresses every j > i with IoU(i, j) > thresh. [thresh] is a number,
    or a 0-d float32 tensor on the boxes' device.

    CPU tensors run the plain version. CUDA tensors run the kernel
    (built at first use); anything else raises.
    """

    if boxes.device.type not in ('cpu', 'cuda'):
        raise ValueError('greedy_nms_keep: boxes on {}; need the CPU or a '
                         'CUDA device'.format(boxes.device))
    if isinstance(thresh, torch.Tensor):
        return torch.ops.mdtorch.greedy_nms_keep_t(boxes, valid, thresh)
    return torch.ops.mdtorch.greedy_nms_keep(boxes, valid, float(thresh))


@torch.library.custom_op('mdtorch::greedy_nms_keep', mutates_args=(),
                         device_types='cpu')
def _greedy_nms_keep_op(boxes: torch.Tensor, valid: torch.Tensor,
                        thresh: float) -> torch.Tensor:
    return greedy_nms_keep_reference(boxes, valid, thresh)


@_greedy_nms_keep_op.register_kernel('cuda')
def _greedy_nms_keep_cuda(boxes, valid, thresh):
    return _launch(boxes, valid, thresh, None)


@torch.library.custom_op('mdtorch::greedy_nms_keep_t', mutates_args=(),
                         device_types='cpu')
def _greedy_nms_keep_t_op(boxes: torch.Tensor, valid: torch.Tensor,
                          thresh: torch.Tensor) -> torch.Tensor:
    return greedy_nms_keep_reference(boxes, valid, thresh)


@_greedy_nms_keep_t_op.register_kernel('cuda')
def _greedy_nms_keep_t_cuda(boxes, valid, thresh):
    if thresh.device != boxes.device or thresh.numel() != 1:
        raise ValueError('greedy_nms_keep: a tensor threshold must be one '
                         'value on the boxes\' device {}, got {} on {}'
                         .format(boxes.device, tuple(thresh.shape),
                                 thresh.device))
    return _launch(boxes, valid, None, threshold_split_tensor(thresh))


@_greedy_nms_keep_op.register_fake
@_greedy_nms_keep_t_op.register_fake
def _greedy_nms_keep_fake(boxes, valid, thresh):
    return torch.empty_like(valid)


def _launch(boxes, valid, thresh, split):
    """The kernel on CUDA tensors: the split of [thresh] by value, or
    [split] (threshold_split_tensor) read from device memory."""

    global launches

    if boxes.device.type != 'cuda' or valid.device != boxes.device:
        raise ValueError('greedy_nms_keep: boxes on {} and valid on {}; '
                         'need both on the CPU or both on one CUDA '
                         'device'.format(boxes.device, valid.device))
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError('greedy_nms_keep: need float32 boxes and bool '
                         'valid, got {} and {}'.format(boxes.dtype,
                                                       valid.dtype))
    if boxes.dim() != 3 or boxes.shape[2] != 4 or \
            tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError('greedy_nms_keep: need boxes [B, K, 4] and valid '
                         '[B, K], got {} and {}'.format(
                             tuple(boxes.shape), tuple(valid.shape)))
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError('greedy_nms_keep: inputs must be contiguous')
    if boxes.data_ptr() % 16 != 0:
        raise ValueError('greedy_nms_keep: boxes must be 16-byte aligned '
                         '(the kernel loads one float4 per box)')

    b, k = valid.shape
    words = (k + 63) // 64
    if words * 8 > 48 * 1024:
        raise ValueError('greedy_nms_keep: K={} exceeds the sweep\'s '
                         'shared-memory bitmask'.format(k))
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep

    lib = _build.load_library()
    mask = torch.empty((b, k, row_words(k)), dtype=torch.int64,
                       device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    # The launch goes to the runtime's current device: make it the
    # tensors' device, and use its current torch stream
    with torch.cuda.device(boxes.device):
        if split is None:
            m, m_hi, m_lo, tie_up = threshold_split(thresh)
            err = lib.md_greedy_nms(
                boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
                keep.data_ptr(), b, k, m, m_hi, m_lo, int(tie_up), stream)
            name = 'md_greedy_nms'
        else:
            err = lib.md_greedy_nms_dev(
                boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
                keep.data_ptr(), b, k, split.data_ptr(), stream)
            name = 'md_greedy_nms_dev'
    _build.check_launch(lib, err, name)
    launches += 1
    return keep
