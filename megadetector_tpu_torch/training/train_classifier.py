"""
Species-classifier training (counterpart of megadetector_tpu/training/
train_classifier.py): the train step over the port's EfficientNet module
and optimizer (training/optim.py), a folder-per-class dataset read with
cv2, and train(), which writes a checkpoint that SpeciesClassifier (of
either package) loads.

The step computes in float32 or bf16 (options.dtype): the model keeps
float32 master parameters and casts them in its forward
(EfficientNet.set_training), so a bf16 step runs the E7 kernel forward
and backward on a card. Entry points run on the card unless
options.device is 'cpu'. The data-parallel step (make_sharded_train_step,
options.mesh) waits for multi-GPU (ROADMAP A8).
"""

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.device import get_device, set_float32_exact
from megadetector_tpu_torch.models import efficientnet
from megadetector_tpu_torch.training import optim

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
          'bf16': torch.bfloat16}


class TrainingOptions:
    """Options controlling train()."""

    def __init__(self):
        self.arch = 'efficientnetv2_s'
        self.image_size = 224
        self.batch_size = 64
        self.learning_rate = 1e-3
        self.weight_decay = 1e-5
        self.num_epochs = 10
        self.label_smoothing = 0.1
        self.seed = 0
        #: A device mesh (data parallelism): not ported, must stay None
        self.mesh = None
        self.log_every = 50
        self.dtype = 'float32'
        #: 'cuda', 'cuda:N', 'cpu' or None (CUDA)
        self.device = None


def cross_entropy_loss(logits, labels, num_classes, label_smoothing=0.0):
    """Smoothed softmax cross-entropy."""

    one_hot = F.one_hot(labels.to(torch.int64), num_classes).to(logits.dtype)
    if label_smoothing > 0:
        one_hot = one_hot * (1.0 - label_smoothing) + \
            label_smoothing / num_classes
    log_probs = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(one_hot * log_probs, dim=-1))


def make_train_step(config, model, optimizer, label_smoothing=0.0,
                    compute_dtype=torch.float32):
    """
    The train step: (images_u8 [B,S,S,3], labels [B]) -> metrics dict
    ('loss', 'accuracy', detached tensors), stepping [model] (an
    EfficientNet, put in training mode in [compute_dtype]) with
    [optimizer] (optim.Optimizer over its parameters) in place. As in the
    JAX step, the images are divided by 255 whatever their type. Inputs
    may be numpy arrays or tensors.
    """

    model.set_training(compute_dtype)

    def train_step(images_u8, labels):
        device = model.fc_w.device
        x = torch.as_tensor(np.asarray(images_u8) if not isinstance(
            images_u8, torch.Tensor) else images_u8).to(device)
        labels = torch.as_tensor(np.asarray(labels) if not isinstance(
            labels, torch.Tensor) else labels).to(device).to(torch.int64)
        logits = model(x.to(torch.float32) / 255.0)
        loss = cross_entropy_loss(logits, labels, config.num_classes,
                                  label_smoothing)
        accuracy = torch.mean(
            (torch.argmax(logits, dim=-1) == labels).to(torch.float32))
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {'loss': loss.detach(), 'accuracy': accuracy}

    return train_step


def make_classifier(config, params, device, compute_dtype):
    """An EfficientNet on [device] holding [params] (numpy, JAX layout),
    in training mode in [compute_dtype]."""

    return efficientnet.EfficientNet(config).load_params(params).to(
        device).set_training(compute_dtype)


class FolderDataset:
    """
    Folder-per-class image dataset (the crop-folder layout produced by
    the classifier-training prep pipeline). Loads lazily; shuffled
    batches of (uint8 images resized to image_size, int labels).
    """

    def __init__(self, root, image_size=224, seed=0):
        from megadetector_tpu_torch.utils.path_utils import find_images
        self.root = root
        self.image_size = image_size
        self.class_names = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        assert len(self.class_names) > 0, 'No class folders in ' + root
        self.samples = []
        for label, name in enumerate(self.class_names):
            for fn in find_images(os.path.join(root, name),
                                  recursive=True):
                self.samples.append((fn, label))
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.samples)

    def batches(self, batch_size, shuffle=True):
        import cv2
        order = np.arange(len(self.samples))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            images = []
            labels = []
            for j in order[i:i + batch_size]:
                fn, label = self.samples[j]
                img = cv2.imread(fn)
                if img is None:
                    continue
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                img = cv2.resize(img, (self.image_size, self.image_size))
                images.append(img)
                labels.append(label)
            if len(images) == 0:
                continue
            yield (np.stack(images).astype(np.uint8),
                   np.asarray(labels, np.int32))


def train(crop_folder, output_checkpoint, options=None):
    """
    Train a classifier on a folder-per-class dataset; writes a converted
    checkpoint (npz + metadata) usable by SpeciesClassifier. Returns
    (the trained EfficientNet, in inference mode in float32, which holds
    the JAX trainer's params; the metrics history).
    """

    from megadetector_tpu_torch.models.convert_weights import save_checkpoint

    if options is None:
        options = TrainingOptions()
    if options.mesh is not None:
        raise NotImplementedError('data-parallel training over a mesh is '
                                  'not ported (one card)')
    device = get_device(options.device)
    if device.type == 'cuda':
        set_float32_exact()

    dataset = FolderDataset(crop_folder, image_size=options.image_size,
                            seed=options.seed)
    num_classes = len(dataset.class_names)
    print('Training on {} images across {} classes'.format(
        len(dataset), num_classes))

    config = efficientnet.EfficientNetConfig(
        options.arch, num_classes=num_classes,
        image_size=options.image_size)
    compute_dtype = DTYPES[options.dtype]
    model = make_classifier(
        config, efficientnet.init_params(config, seed=options.seed,
                                         train_init=True),
        device, compute_dtype)
    optimizer = optim.Optimizer(model.parameters(), optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(options.learning_rate,
                    weight_decay=options.weight_decay)))
    step = make_train_step(config, model, optimizer,
                           options.label_smoothing, compute_dtype)

    history = []
    i_step = 0
    t_start = time.time()
    for epoch in range(options.num_epochs):
        for images, labels in dataset.batches(options.batch_size):
            metrics = step(images, labels)
            i_step += 1
            if i_step % options.log_every == 0:
                loss = float(metrics['loss'])
                accuracy = float(metrics['accuracy'])
                history.append({'step': i_step, 'loss': loss,
                                'accuracy': accuracy})
                print('step {} loss {:.4f} acc {:.3f} '
                      '({:.1f} img/s)'.format(
                          i_step, loss, accuracy,
                          i_step * options.batch_size /
                          (time.time() - t_start)))

    save_checkpoint(model.export_params(), output_checkpoint, {
        'arch': options.arch,
        'num_classes': num_classes,
        'class_names': dataset.class_names,
        'image_size': options.image_size,
    })
    print('Saved checkpoint to {}'.format(output_checkpoint))
    return model.set_training(None), history


def main(argv=None):
    import argparse
    import sys
    parser = argparse.ArgumentParser(
        description='Train a species classifier on a folder-per-class '
                    'crop dataset')
    parser.add_argument('crop_folder')
    parser.add_argument('output_checkpoint')
    parser.add_argument('--arch', default='efficientnetv2_s')
    parser.add_argument('--image_size', type=int, default=224)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--learning_rate', type=float, default=1e-3)
    parser.add_argument('--num_epochs', type=int, default=10)
    parser.add_argument('--dtype', default='float32', choices=sorted(DTYPES))
    parser.add_argument('--device', default=None,
                        help='cuda (default), cuda:N or cpu')

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    options = TrainingOptions()
    options.arch = args.arch
    options.image_size = args.image_size
    options.batch_size = args.batch_size
    options.learning_rate = args.learning_rate
    options.num_epochs = args.num_epochs
    options.dtype = args.dtype
    options.device = args.device
    return train(args.crop_folder, args.output_checkpoint, options)


if __name__ == '__main__':
    main()
