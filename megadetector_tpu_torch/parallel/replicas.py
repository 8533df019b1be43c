"""
The replicas of a data mesh (parallel/mesh.DataMesh): one copy of a model
per mesh device, each with its own CUDA stream, and the pieces that the
meshed detector and the sharded train steps share:

- split_batch cuts a batch into equal contiguous shards, one a replica;
- on_stream runs a replica's work on its stream once that stream has
  waited for the device's current stream (parameters, inputs and
  constants made there), and join makes every device's current stream
  wait for the replicas' streams before their results are combined;
- check_on_first_device refuses a model to train that is not on the
  mesh's first device (its optimizer steps it as the first replica);
- sum_gradients adds the replicas' gradients onto the first replica's
  parameters in mesh order (the same bits on every run),
  copy_parameters puts the first replica's parameters into the others,
  and sum_metrics adds the shards' metrics in the same order.

All of this is one process launching in turn: each replica's kernels go
to its own stream, so the replicas' work can overlap on the device(s)
while the host reads nothing until every replica has been launched.
"""

import contextlib
import copy

import torch

from megadetector_tpu_torch.parallel.mesh import pad_batch_to_multiple


class Replica:
    """One mesh device's copy of a model: [device], [model], [stream]
    (None on the CPU) and, for the detector, its program cache."""

    def __init__(self, device, model, stream=None, programs=None):
        self.device = device
        self.model = model
        self.stream = stream
        self.programs = programs


def replicate_module(module, device):
    """A copy of [module] on [device]: parameters, buffers and settings
    (dtype, int8 scales, training mode) as the module holds them."""

    replica = copy.deepcopy(module).to(device)
    # Version stamps restart on copied tensors: re-stamp what the module
    # checks its derived weights against (YoloV5's fused stem)
    if hasattr(module, 'check_stem'):
        module.check_stem()
        replica.stamp_stem()
    return replica


def make_replicas(module, devices, programs=None):
    """One Replica per device of [devices] (repeats allowed): the first
    holds [module] itself where it lies on devices[0], every other a copy
    (replicate_module). [programs] (device -> a program cache) gives each
    replica a cache of its own."""

    first = module_device(module)
    replicas = []
    for i, device in enumerate(devices):
        if i == 0 and first == device:
            model = module
        else:
            model = replicate_module(module, device)
        stream = torch.cuda.Stream(device) if device.type == 'cuda' \
            else None
        replicas.append(Replica(device, model, stream,
                                None if programs is None
                                else programs(device)))
    return replicas


def module_device(module):
    """The device of [module]'s first parameter or buffer ('cuda' as
    'cuda:<current index>'; the CPU for a module with neither)."""

    for t in list(module.parameters()) + list(module.buffers()):
        d = t.device
        if d.type == 'cuda' and d.index is None:
            d = torch.device('cuda', torch.cuda.current_device())
        return d
    return torch.device('cpu')


def check_on_first_device(module, mesh):
    """Raise ValueError unless [module] lies on [mesh]'s first device: a
    sharded train step sums the gradients onto [module] and its optimizer
    steps it, so it must be the first replica and not a copy of it."""

    first = mesh.devices.flat[0]
    if module_device(module) != first:
        raise ValueError('The model is on {}; a sharded step needs it on '
                         'the mesh\'s first device, {}'.format(
                             module_device(module), first))


@contextlib.contextmanager
def on_stream(stream):
    """Run the block on [stream] (nothing changes for None), after the
    stream has waited for its device's current stream."""

    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        yield


def join(replicas):
    """Make each replica device's current stream wait for the replicas'
    streams: what they wrote may then be read there."""

    for r in replicas:
        if r.stream is not None:
            torch.cuda.current_stream(r.device).wait_stream(r.stream)


def split_batch(arrays, n_shards, pad=False):
    """
    Equal contiguous shards of the leading axis of [arrays] (numpy arrays
    or tensors sharing it): a list, one tuple per shard. With [pad] (numpy
    arrays) a batch that [n_shards] does not divide is padded by repeating
    its last element (mesh.pad_batch_to_multiple); without, it raises
    ValueError.
    Returns (shards, the batch's size before padding).
    """

    n = int(arrays[0].shape[0])
    if pad:
        arrays, n = pad_batch_to_multiple(arrays, n_shards)
    elif n % n_shards:
        raise ValueError('A batch of {} does not split into {} equal '
                         'shards'.format(n, n_shards))
    size = int(arrays[0].shape[0]) // n_shards
    return [tuple(a[i * size:(i + 1) * size] for a in arrays)
            for i in range(n_shards)], n


def sum_gradients(replicas):
    """
    Each parameter's gradient over the replicas, summed onto the first
    replica's parameter in mesh order (g0 + g1 + ...; a replica without a
    gradient adds nothing). Call after join.
    """

    params = [list(r.model.parameters()) for r in replicas]
    with torch.no_grad():
        for j, p0 in enumerate(params[0]):
            g = p0.grad
            for ps in params[1:]:
                gi = ps[j].grad
                if gi is None:
                    continue
                gi = gi.to(p0.device)
                g = gi.clone() if g is None else g + gi
            p0.grad = g


def copy_parameters(replicas):
    """The first replica's parameters and floating buffers into every
    other replica, and every replica's gradients cleared."""

    first = replicas[0].model
    with torch.no_grad():
        for r in replicas[1:]:
            for p, p0 in zip(r.model.parameters(), first.parameters()):
                p.copy_(p0)
            for b, b0 in zip(r.model.buffers(), first.buffers()):
                if b0.is_floating_point():
                    b.copy_(b0)
    for r in replicas:
        for p in r.model.parameters():
            p.grad = None


def sum_metrics(parts, device):
    """Each metric of [parts] (one dict a shard) summed on [device] in
    shard order, detached."""

    out = {}
    for k in parts[0]:
        total = None
        for m in parts:
            v = m[k]
            v = v.detach().to(device) if isinstance(v, torch.Tensor) else \
                torch.tensor(v, device=device)
            total = v if total is None else total + v
        out[k] = total
    return out
