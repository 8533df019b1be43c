"""
megadetector_tpu_torch: the PyTorch/CUDA port of megadetector_tpu.

The JAX package (megadetector_tpu) stays the reference; this package mirrors
its module names (models/yolov5.py, ops/decode.py, ops/nms.py,
models/detector.py, detection/run_detector*.py) so each counterpart is easy
to find, and keeps its public layouts (NHWC images, [B, K, 4] boxes, the
same dict keys) so the two can be compared like for like.

The package imports torch and never jax, and nothing of the JAX package:
the jax-free helpers it needs are its own copies (ops/boxes,
utils/ct_utils, utils/path_utils, models/registry,
visualization/visualization_utils). The TPU kernels on its paths are
hand-written CUDA kernels under csrc/ (greedy NMS, the int8 chain conv,
the fused int8 bottleneck, the fused uint8 stem and the bf16 conv
epilogue), built with nvcc at first use (ops/_build.py) and called as
torch custom operators (mdtorch::*), so that torch.export traces them as
one node each (detection/export_detector.py). Entry points run
on the card unless the caller asks for the CPU (device='cpu' or the
force_cpu detector option).
"""

__version__ = '0.1.0'
