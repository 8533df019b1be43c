"""
The multi-device dry run (counterpart of the JAX package's
__graft_entry__.dryrun_multichip): build an [n_devices]-replica data mesh
and run one step of each data-parallel path over it on small shapes:

- inference: yolov5n6 (3 classes, seed 0) at 128 px, batch 2 per replica,
  through the meshed detector (load_detector with the mesh option, its
  run_program at the JAX dry run's fixed capacity of 256 candidates):
  forward, candidate selection and greedy NMS on each replica's shard;
- a detector train step (make_sharded_detector_train_step, Adam with a
  global-norm clip), the whole batch's targets normalizing every shard;
- an efficientnetv2_s train step (64 px, 4 classes,
  make_sharded_train_step, AdamW).

Each prints the JAX dry run's OK line. The mesh is the local cards when
there are at least [n_devices], else [n_devices] replicas of the first
card (the JAX run forces that many virtual CPU devices); devices=[...]
names them instead ('cpu' for a CPU mesh). Without a card and without
devices it raises, as every entry point of the port does.

    python -m megadetector_tpu_torch.parallel.dryrun [N]
"""

import os
import sys
import tempfile

import numpy as np
import torch

from megadetector_tpu_torch.device import get_device
from megadetector_tpu_torch.parallel.mesh import make_data_mesh


def dryrun_mesh(n_devices, devices=None):
    """The dry run's mesh: [devices], the first [n_devices] local cards,
    or [n_devices] replicas of the first card."""

    if devices is not None:
        return make_data_mesh(n_devices, devices=devices)
    first = get_device(None)
    if torch.cuda.device_count() >= n_devices:
        return make_data_mesh(n_devices)
    return make_data_mesh(devices=[first] * n_devices)


def dryrun_multichip(n_devices, *, devices=None):
    """
    One data-parallel inference step, detector train step and classifier
    train step over an [n_devices]-replica mesh (see the module
    docstring). Returns {'inference': host outputs, 'detector': metrics,
    'classifier': metrics}.
    """

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models import efficientnet, yolov5
    from megadetector_tpu_torch.models.convert_weights import save_checkpoint
    from megadetector_tpu_torch.training import optim
    from megadetector_tpu_torch.training.train_classifier import \
        make_sharded_train_step
    from megadetector_tpu_torch.training.train_detector import (
        make_sharded_detector_train_step, pad_targets)

    mesh = dryrun_mesh(n_devices, devices)
    first = mesh.devices.flat[0]
    n_devices = mesh.size
    batch = n_devices * 2

    # Small variant + canvas; the layout is the production one (the batch
    # split over the mesh, the parameters replicated)
    config = yolov5.YoloV5Config('yolov5n6', num_classes=3)
    params = yolov5.init_params(config, seed=0)
    images = np.random.RandomState(0).randint(
        0, 255, (batch, 128, 128, 3), dtype=np.uint8).astype(np.uint8)
    with tempfile.TemporaryDirectory() as folder:
        path = save_checkpoint(params, os.path.join(folder, 'yolov5n6.npz'),
                               {'arch': 'yolov5n6', 'num_classes': 3,
                                'image_size': 128})
        detector = load_detector(path, detector_options={
            'mesh': mesh, 'max_det': 100, 'pre_nms_topk': 256,
            'auto_escalate_topk': False})
    out, _ = detector.run_program(images, 0.005, 0.45)
    assert out['boxes'].shape[0] == batch
    print('dryrun_multichip inference OK: {} devices, batch {}, '
          'boxes {}'.format(n_devices, batch, out['boxes'].shape))

    # A full training step of the detector over the same mesh: the batch
    # and targets split, the gradients summed onto the first replica
    det_model = yolov5.YoloV5(config).load_params(params).to(first)
    det_optimizer = optim.Optimizer(det_model.parameters(), optim.chain(
        optim.clip_by_global_norm(5.0), optim.adam(1e-3)))
    train_step = make_sharded_detector_train_step(
        config, det_model, det_optimizer, mesh, batch_axis='data')
    train_images = np.random.RandomState(1).randint(
        0, 255, (batch, 128, 128, 3)).astype(np.uint8)
    gt_boxes, gt_classes, gt_mask = pad_targets(
        [np.array([[0.5, 0.5, 0.3, 0.3]])] * batch,
        [np.array([0])] * batch, max_targets=4)
    metrics = train_step(train_images, gt_boxes, gt_classes, gt_mask)
    print('dryrun_multichip training OK: loss {:.4f}, '
          'positives {:.0f}'.format(float(metrics['loss']),
                                    float(metrics['n_positives'])))

    # The classifier's training step (the second model family)
    clf_config = efficientnet.EfficientNetConfig(
        'efficientnetv2_s', num_classes=4, image_size=64)
    clf_model = efficientnet.EfficientNet(clf_config).load_params(
        efficientnet.init_params(clf_config, seed=0,
                                 train_init=True)).to(first)
    clf_optimizer = optim.Optimizer(clf_model.parameters(),
                                    optim.adamw(1e-3))
    clf_step = make_sharded_train_step(clf_config, clf_model, clf_optimizer,
                                       mesh, batch_axis='data')
    crops = np.random.RandomState(1).randint(
        0, 255, (batch, 64, 64, 3)).astype(np.uint8)
    labels = np.random.RandomState(2).randint(0, 4, (batch,)).astype(
        np.int32)
    clf_metrics = clf_step(crops, labels)
    print('dryrun_multichip classifier training OK: loss {:.4f}'.format(
        float(clf_metrics['loss'])))
    return {'inference': out, 'detector': metrics,
            'classifier': clf_metrics}


if __name__ == '__main__':
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
