"""
Device selection and float32 policy for the port (counterpart of
megadetector_tpu/detection/run_detector.py is_gpu_available /
get_accelerator_summary).

The entry points run on the card unless the caller asks for the CPU: no
device (None) means CUDA, and asking for CUDA where there is no card
raises instead of quietly running on the CPU.
"""

import numpy as np
import torch

# device_constant's tensors, by (values, dtype, device)
_CONSTANTS = {}


def get_device(name=None):
    """
    The torch.device to run on. [name] is 'cuda', 'cuda:N', 'cpu' or a
    torch.device; None means 'cuda'. Raises RuntimeError when a CUDA
    device is asked for (or implied by None) and absent: the CPU runs only
    when a caller passes 'cpu'.
    """

    if name is None:
        name = 'cuda'
    device = torch.device(name)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA device {} requested but torch.cuda.is_available() '
                'is False'.format(device))
        index = device.index if device.index is not None else 0
        if index >= torch.cuda.device_count():
            raise RuntimeError('CUDA device {} requested but only {} '
                               'present'.format(device,
                                                torch.cuda.device_count()))
    elif device.type != 'cpu':
        raise ValueError('Unsupported device {}'.format(device))
    return device


def device_constant(values, dtype, device):
    """
    [values] (array-like) as a tensor of [dtype] on [device], made once per
    (values, dtype, device) and shared after that. A CUDA graph cannot
    capture a copy from the host: a program's first, eager run makes its
    constants here, and the captured run reads the same tensors. Callers
    never write to them.
    """

    arr = np.asarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, str(device))
    tensor = _CONSTANTS.get(key)
    if tensor is None:
        tensor = torch.as_tensor(arr).to(dtype).to(device)
        _CONSTANTS[key] = tensor
    return tensor


def set_float32_exact():
    """
    Make float32 mean float32 on the card: cuDNN runs float32
    convolutions in TF32 by default on Hopper, which keeps about three
    decimal digits. Turns TF32 off for convolutions and matmuls.
    """

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def is_gpu_available(detector_file=None):
    """True when torch sees a CUDA card. [detector_file] is taken, as in
    the JAX package's signature, and ignored."""

    return torch.cuda.is_available()


def get_accelerator_summary():
    """Human-readable device summary ('<count> x <name>', or 'cpu')."""

    if not torch.cuda.is_available():
        return 'cpu'
    return '{} x {}'.format(torch.cuda.device_count(),
                            torch.cuda.get_device_name(0))
