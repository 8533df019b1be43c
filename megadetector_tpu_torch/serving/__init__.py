"""
Synchronous (real-time) serving on one CUDA card: the port of
megadetector_tpu/serving, a self-hosted HTTP daemon with dynamic
micro-batching in front of the port's detector, plus a thin client.
"""

from megadetector_tpu_torch.serving.server import MDServer, ServingOptions  # noqa: F401,E501
