"""
Train a species classifier on a classification dataset produced by
create_classification_dataset.py (classification_ds.csv +
label_index.json + splits.json).

Reference contract (megadetector/classification/train_classifier.py:
64-745): location-split dataloaders with label weighting and
detection-confidence weighting, EfficientNet-family models with an
optional head-only finetune mode, top-1/3 accuracy via correct(),
per-epoch train/val/test metrics via run_epoch()/log_run(), and
extreme-example tracking, with host-side numpy data loading. The port of
megadetector_tpu/classification/train_classifier.py: the step is
training/train_classifier.make_train_step (the folder-per-class
trainer's) over the port's EfficientNet and optimizer, and the finetune
split is optim.masked, which leaves the frozen parameters as they are
(the JAX trainer's optax.masked adds their raw gradients to them). As in
the JAX trainer, the step divides its (already normalized) images by 255
while the evaluation forward takes them as they are. Entry points run on
the card unless device is 'cpu'. With more than one card and no device
asked for, prep_device's mesh trains data-parallel
(training/train_classifier.make_sharded_train_step), and run_epoch skips
the trailing train batches that the card count does not divide.
"""

import argparse
import json
import os
import sys

import numpy as np

import torch

from megadetector_tpu_torch.classification.create_classification_dataset \
    import load_dataset_csv
from megadetector_tpu_torch.classification.train_utils import (
    HeapItem, add_to_heap, load_splits)

#: ImageNet normalization used by the reference's torchvision transforms
#: (reference: train_utils.py MEANS/STDS)
MEANS = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
STDS = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)

#: Architectures build_model accepts. The reference's list is
#: efficientnet-b0..b7 + torchvision resnets; this framework's native
#: family is EfficientNetV2, with the classic names mapped onto
#: comparable V2 capacities.
VALID_MODELS = ('efficientnetv2_s', 'efficientnetv2_m',
                'efficientnetv2_l', 'efficientnet-b0',
                'efficientnet-b1', 'efficientnet-b2', 'efficientnet-b3',
                'efficientnet-b4', 'efficientnet-b5', 'efficientnet-b6',
                'efficientnet-b7')

#: classic-name -> native-arch mapping for build_model
_MODEL_NAME_TO_ARCH = {
    'efficientnet-b0': 'efficientnetv2_s',
    'efficientnet-b1': 'efficientnetv2_s',
    'efficientnet-b2': 'efficientnetv2_s',
    'efficientnet-b3': 'efficientnetv2_s',
    'efficientnet-b4': 'efficientnetv2_m',
    'efficientnet-b5': 'efficientnetv2_m',
    'efficientnet-b6': 'efficientnetv2_l',
    'efficientnet-b7': 'efficientnetv2_l',
}

SPLITS = ('train', 'val', 'test')


class AverageMeter:
    """
    Running average of a streamed metric (reference:
    train_classifier.py:64-79).
    """

    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class SimpleDataset:
    """
    Dataset over crop files with labels and optional per-sample weights
    (reference: train_classifier.py:82-124). Indexing returns
    (img, img_file, label, weight) with img an HWC float32 array.
    """

    def __init__(self, img_files, labels=None, sample_weights=None,
                 img_base_dir='', transform=None):
        self.img_files = list(img_files)
        self.labels = list(labels) if labels is not None else None
        self.sample_weights = list(sample_weights) \
            if sample_weights is not None else None
        self.img_base_dir = img_base_dir
        self.transform = transform

    def __getitem__(self, index):
        from PIL import Image

        img_file = self.img_files[index]
        with Image.open(os.path.join(self.img_base_dir,
                                     img_file)) as img:
            img = img.convert('RGB')
        if self.transform is not None:
            img = self.transform(img)
        label = self.labels[index] if self.labels is not None else -1
        weight = self.sample_weights[index] \
            if self.sample_weights is not None else 1.0
        return img, img_file, label, weight

    def __len__(self):
        return len(self.img_files)


def _resize_center_crop(img, img_size):
    """Resize the short side to img_size, center-crop the square."""

    from PIL import Image

    w, h = img.size
    scale = img_size / min(w, h)
    img = img.resize((max(img_size, int(round(w * scale))),
                      max(img_size, int(round(h * scale)))),
                     Image.BICUBIC)
    w, h = img.size
    left = (w - img_size) // 2
    top = (h - img_size) // 2
    return img.crop((left, top, left + img_size, top + img_size))


def _augment_image(img, img_size, rng):
    """
    Train-time augmentation mirroring the reference recipe
    (train_classifier.py:159-169): random resized crop, rotation,
    horizontal/vertical flip, grayscale, color jitter.
    """

    from PIL import Image

    w, h = img.size
    # Random resized crop: area 8-100%, aspect 3/4-4/3
    for _ in range(4):
        area = w * h * rng.uniform(0.35, 1.0)
        aspect = rng.uniform(3.0 / 4.0, 4.0 / 3.0)
        cw = int(round(np.sqrt(area * aspect)))
        ch = int(round(np.sqrt(area / aspect)))
        if cw <= w and ch <= h:
            left = rng.randint(0, w - cw + 1)
            top = rng.randint(0, h - ch + 1)
            img = img.crop((left, top, left + cw, top + ch))
            break
    img = img.resize((img_size, img_size), Image.BILINEAR)
    img = img.rotate(rng.uniform(-90, 90), Image.BILINEAR)
    if rng.rand() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if rng.rand() < 0.1:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
    if rng.rand() < 0.1:
        img = img.convert('L').convert('RGB')
    arr = np.asarray(img, dtype=np.float32) / 255.0
    # brightness/contrast/saturation jitter +-25%
    arr = np.clip(arr * rng.uniform(0.75, 1.25), 0.0, 1.0)
    mean = arr.mean()
    arr = np.clip(mean + (arr - mean) * rng.uniform(0.75, 1.25),
                  0.0, 1.0)
    gray = arr.mean(axis=2, keepdims=True)
    arr = np.clip(gray + (arr - gray) * rng.uniform(0.75, 1.25),
                  0.0, 1.0)
    return arr


def _normalize(arr):
    return (arr - MEANS) / STDS


def create_dataloaders(dataset_csv_path, label_index_json_path,
                       splits_json_path, cropped_images_dir, img_size,
                       multilabel, label_weighted,
                       weight_by_detection_conf, batch_size,
                       num_workers=0, augment_train=True, seed=0):
    """
    Build per-split batched loaders over the classification dataset
    (reference: train_classifier.py:127-209). Returns
    (loaders, label_names) where loaders maps each split to a
    zero-argument callable yielding (imgs NHWC float32 normalized,
    labels int32, weights float32, img_files) batches. Label weighting
    assigns each sample 1/label-frequency (normalized so weights sum to
    the split size); weight_by_detection_conf additionally multiplies
    by the crop's detection confidence.
    """

    assert not multilabel, 'multilabel training is not supported'

    rows = load_dataset_csv(dataset_csv_path)
    with open(label_index_json_path) as f:
        label_index = json.load(f)
    label_names = [label_index[str(i)] for i in range(len(label_index))]
    name_to_id = {n: i for i, n in enumerate(label_names)}
    split_to_locs = load_splits(splits_json_path)

    loaders = {}
    for split, locs in split_to_locs.items():
        split_rows = [r for r in rows
                      if (r['dataset'], str(r['location'])) in locs]
        if len(split_rows) == 0:
            continue
        labels = [name_to_id[r['label']] for r in split_rows]

        weights = np.ones(len(split_rows), dtype=np.float64)
        if label_weighted or weight_by_detection_conf:
            if label_weighted:
                counts = np.bincount(labels,
                                     minlength=len(label_names))
                weights = 1.0 / counts[np.asarray(labels)]
            if weight_by_detection_conf:
                weights = weights * np.asarray(
                    [float(r.get('confidence', 1.0))
                     for r in split_rows])
            weights = weights * (len(split_rows) / weights.sum())

        is_train = (split == 'train') and augment_train
        dataset = SimpleDataset(
            [r['path'] for r in split_rows], labels=labels,
            sample_weights=weights,
            img_base_dir=cropped_images_dir)

        def make_loader(dataset=dataset, is_train=is_train,
                        weights=weights, split_seed=seed):
            rng = np.random.RandomState(split_seed)

            def loader():
                n = len(dataset)
                if is_train and (label_weighted or
                                 weight_by_detection_conf):
                    # Weighted sampling with replacement
                    order = rng.choice(
                        n, size=n, replace=True,
                        p=np.asarray(weights) / np.sum(weights))
                elif is_train:
                    order = rng.permutation(n)
                else:
                    order = np.arange(n)
                batch = []
                for i in order:
                    img, img_file, label, weight = dataset[i]
                    if is_train:
                        arr = _augment_image(img, img_size, rng)
                    else:
                        arr = np.asarray(
                            _resize_center_crop(img, img_size),
                            dtype=np.float32) / 255.0
                    batch.append((_normalize(arr), img_file, label,
                                  weight))
                    if len(batch) == batch_size:
                        yield _stack_batch(batch)
                        batch = []
                if batch:
                    yield _stack_batch(batch)
            return loader
        loaders[split] = make_loader()

    return loaders, label_names


def _stack_batch(batch):
    imgs = np.stack([b[0] for b in batch]).astype(np.float32)
    files = [b[1] for b in batch]
    labels = np.asarray([b[2] for b in batch], dtype=np.int32)
    weights = np.asarray([b[3] for b in batch], dtype=np.float32)
    return imgs, labels, weights, files


def set_finetune(model, model_name, finetune):
    """
    The trainable mask over list(model.parameters()) (reference:
    train_classifier.py:212-229, there mutating requires_grad): with
    finetune, only the final fc layer (fc_w, fc_b) trains; otherwise
    everything does. A list of bools for optim.masked.
    """

    return [(not finetune) or name in ('fc_w', 'fc_b')
            for name, _ in model.named_parameters()]


def build_model(model_name, num_classes, pretrained, finetune,
                device=None):
    """
    Create an EfficientNet-family classifier (reference:
    train_classifier.py:232-269) on [device], in float32 training mode.
    [device]: 'cuda', 'cuda:N', 'cpu' or None (CUDA; raises without a
    card).
    [pretrained] may be a checkpoint path (loaded, with the fc head
    re-initialized when the class count differs); True requests ImageNet
    weights, which are not available offline: a warning is printed and
    training starts from random init. Returns (config, model,
    trainable_mask).
    """

    from megadetector_tpu_torch.device import get_device
    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.training.train_classifier import \
        make_classifier

    device = get_device(device)
    assert model_name in VALID_MODELS, \
        'Unknown model {} (valid: {})'.format(model_name, VALID_MODELS)
    arch = _MODEL_NAME_TO_ARCH.get(model_name, model_name)

    config = efficientnet.EfficientNetConfig(arch,
                                             num_classes=num_classes)
    params = efficientnet.init_params(config, train_init=True)

    if pretrained is True:
        print('Warning: ImageNet-pretrained weights are not available '
              'offline; training from random init')
    elif isinstance(pretrained, str):
        from megadetector_tpu_torch.models.convert_weights import \
            load_checkpoint
        print('Loading saved weights from {}'.format(pretrained))
        ckpt_params, _ = load_checkpoint(pretrained)
        if ckpt_params['fc']['w'].shape[-1] != num_classes:
            print('Checkpoint has {} classes; reinitializing the fc '
                  'head for {}'.format(
                      ckpt_params['fc']['w'].shape[-1], num_classes))
            ckpt_params['fc'] = params['fc']
        params = ckpt_params

    model = make_classifier(config, params, device, torch.float32)
    mask = set_finetune(model, model_name, finetune)
    return config, model, mask


def correct(outputs, labels, weights=None, top=(1,)):
    """
    Weighted number of correct top-k predictions per k in [top]
    (reference: train_classifier.py:597-621). outputs is [N, C] logits
    or probs; returns {k: float}.
    """

    outputs = np.asarray(outputs)
    labels = np.asarray(labels)
    if weights is None:
        weights = np.ones(len(labels), dtype=np.float64)
    weights = np.asarray(weights)

    result = {}
    max_k = max(top)
    topk = np.argsort(-outputs, axis=1)[:, :max_k]
    for k in top:
        hit = (topk[:, :k] == labels[:, None]).any(axis=1)
        result[k] = float((hit * weights).sum())
    return result


def prep_device(device_id=None):
    """
    Pick the training devices (reference: train_classifier.py:272-304,
    there CUDA/DataParallel): returns (devices, mesh), the CUDA devices
    (the one of [device_id] when given) and, when there is more than one
    and no device was asked for, a parallel/mesh.DataMesh over them (the
    DataParallel analog), else None. Raises RuntimeError without a card.
    """

    from megadetector_tpu_torch.parallel.mesh import make_data_mesh

    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError('prep_device: no CUDA device (pass '
                           'device=\'cpu\' to main for the CPU)')
    devices = [torch.device('cuda', i) for i in range(count)]
    if device_id is not None:
        devices = [devices[device_id]]
    mesh = None
    if len(devices) > 1:
        print('Found multiple devices, enabling data parallelism '
              '({})'.format([d.index for d in devices]))
        mesh = make_data_mesh(devices=devices)
    print('Training on {} device(s) ({})'.format(
        len(devices), devices[0].type))
    return devices, mesh


def run_epoch(step_fn, loader, num_classes, train=True, top=(1, 3),
              forward_fn=None, track_extremes=False, label_names=None,
              batch_multiple=None):
    """
    One pass over [loader] (reference: train_classifier.py:624-745). With
    train=True, applies step_fn (imgs, labels) -> metrics per batch, which
    steps the model in place; otherwise runs forward_fn (imgs) -> logits
    for metrics only. Returns the metrics dict: loss/acc@k AverageMeters
    plus optional extreme-example heaps. With [batch_multiple] (the mesh
    device count for a sharded step_fn), trailing train batches not
    divisible by it are skipped: the sharded step splits a batch into
    equal shards.
    """

    loss_meter = AverageMeter()
    acc_meters = {k: AverageMeter() for k in top}
    tp_heaps = {} if track_extremes else None
    fn_heaps = {} if track_extremes else None

    for imgs, labels, weights, files in loader():
        n = len(labels)
        if train and batch_multiple is not None and \
                n % batch_multiple != 0:
            continue
        if train:
            metrics = step_fn(imgs, labels)
            loss_meter.update(float(metrics['loss']), n)
            # Only top-1 during training, from the step itself (a second
            # forward per batch for top-k would cost more and measure the
            # parameters after the update); eval epochs report all of
            # [top]
            acc_meters[1].update(float(metrics['accuracy']) * 100.0, n)
        else:
            assert forward_fn is not None
            logits = np.asarray(forward_fn(imgs), np.float32)
            # Cross-entropy for the meter
            shifted = logits - logits.max(axis=1, keepdims=True)
            log_probs = shifted - np.log(
                np.exp(shifted).sum(axis=1, keepdims=True))
            loss = -log_probs[np.arange(n), labels].mean()
            loss_meter.update(float(loss), n)
            c = correct(logits, labels, top=top)
            for k in top:
                acc_meters[k].update(100.0 * c[k] / n, n)
            if track_extremes and label_names is not None:
                probs = np.exp(log_probs)
                track_extreme_examples(tp_heaps, fn_heaps, imgs,
                                       labels, files, probs)

    metrics = {'loss': loss_meter}
    for k in top:
        metrics['acc_top{}'.format(k)] = acc_meters[k]
    if track_extremes:
        metrics['tp_heaps'] = tp_heaps
        metrics['fn_heaps'] = fn_heaps
    return metrics


def log_run(split, epoch, writer, metrics):
    """
    Record epoch metrics (reference: train_classifier.py:476-505).
    [writer] is anything with add_scalar(tag, value, step) (a
    tensorboard SummaryWriter in the reference) or a file-like object;
    metrics values may be AverageMeters or floats.
    """

    vals = {}
    for name, m in metrics.items():
        if isinstance(m, AverageMeter):
            if m.count > 0:
                vals[name] = m.avg
        elif isinstance(m, (int, float)):
            vals[name] = float(m)
    line = '{} epoch {}: '.format(split, epoch) + ', '.join(
        '{} {:.4f}'.format(k, v) for k, v in sorted(vals.items()))
    print(line)
    if writer is None:
        return vals
    if hasattr(writer, 'add_scalar'):
        for name, v in vals.items():
            writer.add_scalar('{}/{}'.format(split, name), v, epoch)
    elif hasattr(writer, 'write'):
        writer.write(line + '\n')
    return vals


def track_extreme_examples(tp_heaps, fn_heaps, imgs, labels, files,
                           probs, k=5):
    """
    Track the highest-confidence true positives and false negatives per
    class in bounded heaps (reference: train_classifier.py:547-594).
    """

    probs = np.asarray(probs)
    labels = np.asarray(labels)
    preds = probs.argmax(axis=1)
    for i in range(len(labels)):
        label = int(labels[i])
        conf = float(probs[i, label])
        item = HeapItem(priority=conf,
                        data=(files[i], int(preds[i]), conf))
        if preds[i] == label:
            add_to_heap(tp_heaps.setdefault(label, []), item, k=k)
        else:
            neg = HeapItem(priority=-conf,
                           data=(files[i], int(preds[i]), conf))
            add_to_heap(fn_heaps.setdefault(label, []), neg, k=k)


def log_images_with_confidence(heaps, label_names, epoch, tag):
    """
    Render each class's extreme examples into a summary dict
    (reference: train_classifier.py:508-544 — there logged to
    tensorboard; here returned for the caller to print or save).
    """

    out = {}
    for label_id, heap in heaps.items():
        name = label_names[label_id] if label_id < len(label_names) \
            else str(label_id)
        examples = sorted(heap, key=lambda h: -abs(h.priority))
        out['{}/{}'.format(tag, name)] = [
            {'file': h.data[0], 'pred': h.data[1], 'conf': h.data[2]}
            for h in examples]
    return out


def main(dataset_dir, cropped_images_dir, multilabel=False,
         model_name='efficientnetv2_s', pretrained=False, finetune=False,
         label_weighted=False, weight_by_detection_conf=False,
         epochs=1, batch_size=32, lr=1e-3, weight_decay=1e-5,
         img_size=224, num_workers=0, logdir=None, seed=0,
         device_id=None, device=None):
    """
    End-to-end training over a classification dataset directory
    (reference: train_classifier.py:307-473). Writes params.npz (+
    label_index.json and a metrics CSV) under [logdir]. Returns the
    best validation metrics. [device]: 'cuda', 'cuda:N', 'cpu' or None
    (CUDA; device_id N picks cuda:N). With neither, prep_device's mesh
    (more than one card) trains data-parallel over every card, unless
    batch_size does not divide over them.
    """

    from megadetector_tpu_torch.device import get_device, set_float32_exact
    from megadetector_tpu_torch.models.convert_weights import save_checkpoint
    from megadetector_tpu_torch.training import optim
    from megadetector_tpu_torch.training.train_classifier import (
        make_sharded_train_step, make_train_step)

    mesh = None
    if device is None and device_id is None:
        devices, mesh = prep_device()
        if mesh is not None and batch_size % len(devices) != 0:
            print('Batch size {} is not divisible by {} devices; using a '
                  'single device'.format(batch_size, len(devices)))
            mesh = None
        device = devices[0]
    if device is None and device_id is not None:
        device = 'cuda:{}'.format(device_id)
    device = get_device(device)
    if device.type == 'cuda':
        set_float32_exact()
    print('Training on {}'.format(device))

    loaders, label_names = create_dataloaders(
        os.path.join(dataset_dir, 'classification_ds.csv'),
        os.path.join(dataset_dir, 'label_index.json'),
        os.path.join(dataset_dir, 'splits.json'),
        cropped_images_dir, img_size, multilabel, label_weighted,
        weight_by_detection_conf, batch_size, num_workers,
        augment_train=True, seed=seed)
    num_classes = len(label_names)

    config, model, mask = build_model(model_name, num_classes,
                                      pretrained, finetune, device)
    config.image_size = img_size

    tx = optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(lr, weight_decay=weight_decay))
    if finetune:
        tx = optim.masked(tx, mask)
    optimizer = optim.Optimizer(model.parameters(), tx)
    if mesh is not None:
        step_fn = make_sharded_train_step(config, model, optimizer, mesh)
        batch_multiple = mesh.size
    else:
        step_fn = make_train_step(config, model, optimizer)
        batch_multiple = None

    def forward_fn(imgs):
        with torch.no_grad():
            return model(torch.as_tensor(imgs).to(device)).cpu().numpy()

    def save(path):
        save_checkpoint(model.export_params(), path,
                        {'arch': config.arch, 'num_classes': num_classes,
                         'class_names': label_names, 'image_size': img_size,
                         'normalization_mean': MEANS.tolist(),
                         'normalization_std': STDS.tolist()})

    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)

    best = None
    metrics_rows = []
    for epoch in range(epochs):
        train_m = run_epoch(step_fn, loaders['train'], num_classes,
                            train=True, forward_fn=forward_fn,
                            batch_multiple=batch_multiple)
        metrics_rows.append(('train', epoch,
                             log_run('train', epoch, None, train_m)))
        if 'val' in loaders:
            val_m = run_epoch(None, loaders['val'], num_classes,
                              train=False, forward_fn=forward_fn)
            vals = log_run('val', epoch, None, val_m)
            metrics_rows.append(('val', epoch, vals))
            if best is None or vals['acc_top1'] > best['acc_top1']:
                best = dict(vals, epoch=epoch)
                if logdir is not None:
                    save(os.path.join(logdir, 'params.npz'))

    if logdir is not None:
        if best is None:
            save(os.path.join(logdir, 'params.npz'))
        with open(os.path.join(logdir, 'label_index.json'), 'w') as f:
            json.dump({str(i): n for i, n in enumerate(label_names)},
                      f, indent=1)
        with open(os.path.join(logdir, 'metrics.csv'), 'w') as f:
            f.write('split,epoch,metric,value\n')
            for split, epoch, vals in metrics_rows:
                for k, v in sorted(vals.items()):
                    f.write('{},{},{},{}\n'.format(split, epoch, k, v))
    return best


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Train a species classifier on a classification '
                    'dataset (classification_ds.csv + label_index.json '
                    '+ splits.json)')
    parser.add_argument('dataset_dir')
    parser.add_argument('cropped_images_dir')
    parser.add_argument('--model_name', default='efficientnetv2_s',
                        choices=VALID_MODELS)
    parser.add_argument('--pretrained', default=None,
                        help='checkpoint path to start from')
    parser.add_argument('--finetune', action='store_true',
                        help='train only the final fc layer')
    parser.add_argument('--label_weighted', action='store_true')
    parser.add_argument('--weight_by_detection_conf',
                        action='store_true')
    parser.add_argument('--epochs', type=int, default=1)
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--lr', type=float, default=1e-3)
    parser.add_argument('--weight_decay', type=float, default=1e-5)
    parser.add_argument('--img_size', type=int, default=224)
    parser.add_argument('--logdir', default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default=None,
                        help='cuda (default), cuda:N or cpu')
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        parser.print_help()
        parser.exit()
    return parser.parse_args(argv)


def cli(argv=None):
    """The command line: _parse_args, then main."""

    args = _parse_args(argv)
    return main(args.dataset_dir, args.cropped_images_dir,
         model_name=args.model_name,
         pretrained=args.pretrained if args.pretrained else False,
         finetune=args.finetune, label_weighted=args.label_weighted,
         weight_by_detection_conf=args.weight_by_detection_conf,
         epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
         weight_decay=args.weight_decay, img_size=args.img_size,
         logdir=args.logdir, seed=args.seed, device=args.device)


if __name__ == '__main__':
    cli()
