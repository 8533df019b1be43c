"""
megadetector_tpu_torch: the PyTorch/CUDA port of megadetector_tpu.

The JAX package (megadetector_tpu) stays the reference; this package mirrors
its module names (models/yolov5.py, ops/decode.py, ops/nms.py,
models/detector.py, detection/run_detector*.py) so each counterpart is easy
to find, and keeps its public layouts (NHWC images, [B, K, 4] boxes, the
same dict keys) so the two can be compared like for like.

The package imports torch and never jax. The jax-free layers of the
reference (ops/boxes, utils/ct_utils, utils/path_utils, models/registry)
are imported, not copied. The TPU kernel on the detection path (Pallas
greedy NMS) is replaced by a hand-written CUDA kernel, csrc/nms.cu, built
with nvcc at first use (ops/_build.py).
"""

__version__ = '0.1.0'
