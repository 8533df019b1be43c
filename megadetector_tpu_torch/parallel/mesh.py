"""
Device meshes for data-parallel inference and training (counterpart of
megadetector_tpu/parallel/mesh.py).

The JAX package runs one process over every local device: the batch axis
of each step is sharded over a 1-D 'data' mesh and the parameters are
replicated. The port keeps that single-process API. A DataMesh names the
devices, one replica each; the detector (models/detector.py) and the
sharded train steps (training/) keep one copy of the model per mesh
device, split each batch into equal contiguous shards, run every
replica's shard on its own CUDA stream and join the results in shard
order (parallel/replicas.py). Multi-host jobs keep the reference's
file-level sharding: each host runs its own image chunk and writes its
own JSON shard, merged by postprocessing.combine_batch_outputs.

A mesh may name one device more than once (make_data_mesh(devices=[...])):
two replicas on one card, each with its own stream, is the port's
counterpart of the virtual CPU mesh that the JAX package forces with
XLA's host device count, and the CPU tests use ['cpu', 'cpu', ...].
"""

import os

import numpy as np
import torch


class DataMesh:
    """
    A 1-D mesh: [devices] (a numpy object array of torch.device, one per
    replica, repeats allowed) along the single axis [axis_names][0].
    mesh.devices.size is the replica count, as for a jax Mesh.
    """

    def __init__(self, devices, axis_name='data'):
        if len(devices) == 0:
            raise ValueError('A mesh needs at least one device')
        arr = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            arr[i] = _indexed(torch.device(d))
        self.devices = arr
        self.axis_names = (axis_name,)

    @property
    def size(self):
        return int(self.devices.size)

    def device_list(self):
        return list(self.devices.flat)

    def __repr__(self):
        return 'DataMesh({}, {!r})'.format(
            [str(d) for d in self.devices.flat], self.axis_names[0])


def _indexed(device):
    """'cuda' as 'cuda:<current index>', so that two names of one card
    are one device (caches are keyed by str(device))."""

    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def make_data_mesh(n_devices=None, axis_name='data', *, devices=None):
    """
    A 1-D mesh over the first [n_devices] local CUDA devices (all by
    default), or over [devices] (a list of devices or names; repeats
    allowed) when given. Raises when more devices are asked for than
    there are, as the JAX function asserts.
    """

    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError('make_data_mesh: no CUDA device (pass '
                               'devices=[...] for a CPU mesh)')
        devices = [torch.device('cuda', i) for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise AssertionError(
                'Requested {} devices but only {} available'.format(
                    n_devices, len(devices)))
        devices = devices[:n_devices]
    return DataMesh(devices, axis_name)


def batch_sharding(mesh, axis_name='data'):
    """The batch axis over the mesh axis: (mesh, axis_name), what the
    port's replicas split [B, ...] tensors by."""

    _check_axis(mesh, axis_name)
    return (mesh, axis_name)


def replicated_sharding(mesh):
    """Full replication (parameters, scalars): (mesh, None)."""

    return (mesh, None)


def _check_axis(mesh, axis_name):
    if axis_name not in mesh.axis_names:
        raise ValueError('Mesh axes are {}; no axis {!r}'.format(
            mesh.axis_names, axis_name))


def pad_batch_to_multiple(batch_arrays, multiple):
    """
    Pad the leading axis of each array in [batch_arrays] (a list/tuple of
    numpy arrays sharing batch size) to a multiple of [multiple] by
    repeating the last element. Returns (padded_arrays, original_size).
    """

    n = batch_arrays[0].shape[0]
    remainder = n % multiple
    if remainder == 0:
        return batch_arrays, n
    pad = multiple - remainder
    padded = []
    for a in batch_arrays:
        pad_block = np.repeat(a[-1:], pad, axis=0)
        padded.append(np.concatenate([a, pad_block], axis=0))
    return padded, n


def local_device_count():
    """The CUDA devices of this process (0 without a card)."""

    return torch.cuda.device_count()


def process_index():
    """This process's rank in torch.distributed's group, 0 when none is
    initialized."""

    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def process_count():
    """The size of torch.distributed's group, 1 when none is
    initialized."""

    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def shard_image_list_for_hosts(image_file_names):
    """
    Multi-host data sharding at the file level (the faithful analog of the
    reference's per-GPU chunking): host i of N takes images [i::N].
    """

    return image_file_names[process_index()::max(process_count(), 1)]


def shard_output_filename(output_file, index=None):
    """
    Per-host output shard path for a multi-host run:
    results.json -> results.host003.json. Shards are merged by
    postprocessing.combine_batch_outputs.combine_batch_output_files.
    """

    i = process_index() if index is None else index
    base, ext = os.path.splitext(output_file)
    return '{}.host{:03d}{}'.format(base, i, ext)


def round_batch_to_devices(batch_size, n_devices, label='batch size',
                           verbose=True):
    """[batch_size] rounded up to a multiple of [n_devices] (the JAX batch
    driver's and server's batch size over a mesh), printed as '[label]'
    where it changes."""

    if batch_size % n_devices == 0:
        return batch_size
    rounded = ((batch_size + n_devices - 1) // n_devices) * n_devices
    if verbose:
        print('Rounded {} up to {} for {} devices'.format(
            label, rounded, n_devices))
    return rounded
