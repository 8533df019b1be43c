"""
A JAX-layout parameter pytree held by a torch nn.Module, for the networks
written as functions of their parameters (models/rfdetr.py, models/detr.py):
each dict becomes a ParamTree submodule and each array a buffer, so
.to(device) moves the tree and tree['key'] reads it as the JAX functions
read theirs. ParamNetwork is such a network's module.
"""

import numpy as np
import torch
import torch.nn as nn

from megadetector_tpu_torch.models.yolov5 import COMPUTE_DTYPES, network_input


class ParamTree(nn.Module):
    """Nested dict of numpy arrays -> nested modules of float32 buffers;
    4-d leaves (conv weights, HWIO) are stored OIHW."""

    def __init__(self, node):
        super().__init__()
        for key, value in node.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
                continue
            a = np.asarray(value)
            if not np.issubdtype(a.dtype, np.floating):
                raise ValueError('Leaf {} has dtype {}, expected a float '
                                 'array'.format(key, a.dtype))
            a = a.astype(np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            self.register_buffer(key, torch.from_numpy(
                np.ascontiguousarray(a)))

    def __getitem__(self, key):
        return getattr(self, key)

    def cast_conv_weights(self, dtype):
        """Cast every 4-d float leaf to [dtype]: the JAX detector's _cast,
        which gives the compute dtype to floating leaves with ndim >= 4
        only."""

        for module in self.modules():
            for name, buf in list(module.named_buffers(recurse=False)):
                if buf.dim() >= 4:
                    setattr(module, name, buf.to(dtype))


class ParamNetwork(nn.Module):
    """
    A network that is a function of its parameter tree: a subclass gives
    PARAM_KEYS (the tree's top-level keys) and apply(config, params, x,
    dtype, decode). load_params, then set_compute_dtype, then
    forward(x, decode) on NHWC uint8 pixels or floats in [0, 1].
    """

    PARAM_KEYS = ()

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.compute_dtype = torch.float32
        self.params = None

    def load_params(self, params_np):
        if sorted(params_np) != sorted(self.PARAM_KEYS):
            raise ValueError('Not a {} parameter tree: keys {}'.format(
                type(self).__name__, sorted(params_np)))
        self.params = ParamTree(params_np)
        return self

    def set_compute_dtype(self, dtype):
        """Compute in [dtype]; bf16 casts the 4-d leaves (conv weights)
        only, as the JAX detector's _cast does."""

        if dtype not in COMPUTE_DTYPES:
            raise ValueError('compute dtype must be one of {}, got {}'.format(
                COMPUTE_DTYPES, dtype))
        self.compute_dtype = dtype
        self.params.cast_conv_weights(dtype)
        return self

    def forward(self, x, decode=True):
        return type(self).apply(self.config, self.params,
                                network_input(x, self.compute_dtype),
                                self.compute_dtype, decode=decode)
