"""
Accelerator diagnostics with the reference's per-framework entry points
(reference: megadetector/utils/gpu_test.py: torch_test / tf_test /
directml_test); the port's copy of megadetector_tpu/utils/gpu_test.py.
The primary diagnostic of the port is utils/accelerator_test.py (torch,
the card, one of the port's kernels), which main() runs where the JAX
module runs its JAX probe; these functions report what each framework can
see so environment problems are easy to localize.

    python -m megadetector_tpu_torch.utils.gpu_test
"""

import sys


def torch_test(verbose=True):
    """
    Print diagnostic information about torch/CUDA/MPS availability;
    returns the number of CUDA (or MPS) devices (reference:
    gpu_test.py:torch_test).
    """

    try:
        import torch
    except ImportError:
        if verbose:
            print('PyTorch unavailable, not running PyTorch tests.')
        return 0

    if verbose:
        print('Torch version: {}'.format(torch.__version__))
        print('CUDA available (according to PyTorch): {}'.format(
            torch.cuda.is_available()))

    device_ids = list(range(torch.cuda.device_count()))
    if verbose:
        for device_id in device_ids:
            print('Device {}: {}'.format(
                device_id, torch.cuda.get_device_name(device_id)))

    if len(device_ids) == 0:
        try:
            if torch.backends.mps.is_built() and \
                    torch.backends.mps.is_available():
                if verbose:
                    print('MPS (Apple silicon acceleration) available')
                return 1
        except AttributeError:
            pass
        if verbose:
            print('No GPUs reported by PyTorch')
    return len(device_ids)


def tf_test(verbose=True):
    """
    Print diagnostic information about TensorFlow GPU availability;
    returns the number of GPUs TF can see (reference:
    gpu_test.py:tf_test).
    """

    try:
        import tensorflow as tf
    except ImportError:
        if verbose:
            print('TensorFlow unavailable, not running TF tests.')
        return 0

    if verbose:
        print('TensorFlow version: {}'.format(tf.__version__))
    gpus = tf.config.list_physical_devices('GPU')
    if verbose:
        print('TensorFlow sees {} GPU(s)'.format(len(gpus)))
        for gpu in gpus:
            print('  {}'.format(gpu))
    return len(gpus)


def directml_test(verbose=True):
    """
    Probe torch-directml availability (Windows DirectML acceleration);
    returns the number of DirectML devices (reference:
    gpu_test.py:directml_test). Always 0 on non-Windows platforms.
    """

    try:
        import torch_directml
    except ImportError:
        if verbose:
            print('torch-directml unavailable, not running DirectML '
                  'tests.')
        return 0

    n_devices = torch_directml.device_count()
    if verbose:
        print('DirectML sees {} device(s)'.format(n_devices))
    return n_devices


def main():
    from megadetector_tpu_torch.utils.accelerator_test import \
        accelerator_test

    print('*** Running accelerator tests ***\n')
    accelerator_test()
    print('\n*** Running Torch tests ***\n')
    torch_test()
    print('\n*** Running TF tests ***\n')
    tf_test()
    print('\n*** Running DirectML tests ***\n')
    directml_test()


if __name__ == '__main__':
    sys.exit(main())
