"""
The port's copy of megadetector_tpu/classification/run_classifier.py, on
the port's SpeciesClassifier (keyword-only device: None means the card).

Run a species classifier over the crops of a detections file and merge
the results back in.

Reference behavior (megadetector/classification/run_classifier.py:1-19):
inputs are a detections JSON, the crop folder produced by
crop_detections.py, and a classifier checkpoint (here a converted JAX
checkpoint, see training/train_classifier.py); classifications attach
to the corresponding detections (by the ___cropXX path convention) and
the result overwrites the input file unless --output is given. Also
writes the raw per-crop confidence CSV (the evaluate_model outputs
shape, without labels) when --output_csv is given.
"""

import argparse
import json
import os
import sys

import numpy as np

from megadetector_tpu_torch.classification.crop_detections import \
    parse_crop_filename
from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.ct_utils import round_float


class SimpleDataset:
    """
    Very simple dataset over image files (reference:
    run_classifier.py:56-84): indexing returns (img, img_file), where
    img is the loaded (and optionally transformed) image. Torch-free —
    images load via PIL into HWC arrays.
    """

    def __init__(self, img_files, images_dir=None, transform=None):
        self.img_files = list(img_files)
        self.images_dir = images_dir
        self.transform = transform

    def __getitem__(self, index):
        from PIL import Image

        img_file = self.img_files[index]
        img_path = os.path.join(self.images_dir, img_file) \
            if self.images_dir is not None else img_file
        with Image.open(img_path) as img:
            img = img.convert('RGB')
        if self.transform is not None:
            img = self.transform(img)
        return img, img_file

    def __len__(self):
        return len(self.img_files)


def create_loader(cropped_images_dir, detections_json_path, img_size,
                  batch_size, num_workers=0):
    """
    Batched loader over a crop folder (reference:
    run_classifier.py:89-160): enumerate crops (all files when
    [detections_json_path] is None, else only crops of images in the
    detections file), resize each to img_size x img_size, and yield
    (batch float32 NHWC in [0,1], [crop files]) tuples. Replaces the
    reference's torch DataLoader with a generator feeding fixed-shape
    batches to the JAX classifier.
    """

    import numpy as np
    from PIL import Image

    crop_files = []
    if detections_json_path is None:
        for subdir, _, files in os.walk(cropped_images_dir):
            rel_dir = os.path.relpath(subdir, cropped_images_dir)
            for file_name in files:
                rel = file_name if rel_dir == '.' \
                    else os.path.join(rel_dir, file_name)
                crop_files.append(rel)
    else:
        with open(detections_json_path) as f:
            js = json.load(f)
        # Crop names replace the image extension
        # (gt.jpg -> gt___crop00.jpg), so match on the stem too
        image_files = set()
        for im in js['images']:
            image_files.add(im['file'])
            image_files.add(os.path.splitext(im['file'])[0])
        for subdir, _, files in os.walk(cropped_images_dir):
            rel_dir = os.path.relpath(subdir, cropped_images_dir)
            for file_name in files:
                rel = file_name if rel_dir == '.' \
                    else os.path.join(rel_dir, file_name)
                parsed = parse_crop_filename(rel)
                if parsed is None:
                    continue
                if parsed[0] in image_files:
                    crop_files.append(rel)
    crop_files = sorted(crop_files)

    dataset = SimpleDataset(crop_files, images_dir=cropped_images_dir)

    def loader():
        batch_imgs, batch_files = [], []
        for i in range(len(dataset)):
            img, img_file = dataset[i]
            img = img.resize((img_size, img_size), Image.BILINEAR)
            batch_imgs.append(
                np.asarray(img, dtype=np.float32) / 255.0)
            batch_files.append(img_file)
            if len(batch_imgs) == batch_size:
                yield np.stack(batch_imgs), batch_files
                batch_imgs, batch_files = [], []
        if batch_imgs:
            yield np.stack(batch_imgs), batch_files

    return loader()


def run_classifier(detections_json_path, cropped_images_dir,
                   checkpoint_path, output_json_path=None,
                   output_csv_path=None, batch_size=32, top_k=5,
                   threshold=0.0, classifier_name=None, *, device=None):
    """
    Classify every crop under [cropped_images_dir] that maps back to a
    detection in [detections_json_path]; writes the merged file (in
    place by default). Returns the merged dict.
    """

    from datetime import datetime

    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    from megadetector_tpu_torch.visualization import \
        visualization_utils as vis_utils

    classifier = SpeciesClassifier(checkpoint_path, device=device)
    class_names = classifier.class_names

    with open(detections_json_path) as f:
        data = json.load(f)
    det_by_file = {im['file']: im for im in data['images']}

    # Enumerate crops that parse back to a detection
    crop_paths = []
    for root, _, files in os.walk(cropped_images_dir):
        for fn in files:
            full = os.path.join(root, fn)
            rel = os.path.relpath(full, cropped_images_dir) \
                .replace('\\', '/')
            parsed = parse_crop_filename(rel)
            if parsed is None:
                continue
            image_file, crop_index = parsed
            im = det_by_file.get(image_file)
            if im is None or im.get('detections') is None or \
                    crop_index >= len(im['detections']):
                continue
            crop_paths.append((full, image_file, crop_index))
    crop_paths.sort()

    csv_rows = []
    n_classified = 0
    batch = []

    def flush():
        nonlocal n_classified
        if not batch:
            return
        imgs = []
        meta = []
        for full, image_file, crop_index in batch:
            try:
                imgs.append(np.asarray(vis_utils.load_image(full)))
                meta.append((full, image_file, crop_index))
            except Exception:
                continue
        if not imgs:
            batch.clear()
            return
        probs = np.asarray(classifier.classify_batch(imgs))
        for (full, image_file, crop_index), p in zip(meta, probs):
            det = det_by_file[image_file]['detections'][crop_index]
            order = np.argsort(-p)[:top_k]
            det['classifications'] = [
                [str(int(i)), round_float(float(p[i]), 4)]
                for i in order if p[i] >= threshold]
            n_classified += 1
            csv_rows.append(
                (os.path.relpath(full, cropped_images_dir)
                 .replace('\\', '/'), p))
        batch.clear()

    for item in crop_paths:
        batch.append(item)
        if len(batch) >= batch_size:
            flush()
    flush()

    data['classification_categories'] = {
        str(i): name for i, name in enumerate(class_names)}
    info = data.setdefault('info', {})
    info['classifier'] = classifier_name or \
        os.path.basename(checkpoint_path)
    info['classification_completion_time'] = \
        datetime.now().strftime('%Y-%m-%d %H:%M:%S')

    out_path = output_json_path or detections_json_path
    ct_utils.write_json(out_path, data)
    print('Classified {} crops -> {}'.format(n_classified, out_path))

    if output_csv_path is not None:
        with open(output_csv_path, 'w') as f:
            f.write('path,' + ','.join(class_names) + '\n')
            for rel, p in csv_rows:
                f.write('{},{}\n'.format(
                    rel, ','.join('{:.6f}'.format(v)
                                  for v in p[:len(class_names)])))
        print('Wrote per-crop confidences to {}'.format(
            output_csv_path))
    return data


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Run a species classifier over detection crops')
    parser.add_argument('detections_json')
    parser.add_argument('cropped_images_dir')
    parser.add_argument('checkpoint')
    parser.add_argument('--output', default=None,
                        help='output JSON (default: overwrite input)')
    parser.add_argument('--output_csv', default=None)
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--top_k', type=int, default=5)
    parser.add_argument('--threshold', type=float, default=0.0)
    parser.add_argument('--device', default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")

    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    run_classifier(args.detections_json, args.cropped_images_dir,
                   args.checkpoint, output_json_path=args.output,
                   output_csv_path=args.output_csv,
                   batch_size=args.batch_size, top_k=args.top_k,
                   threshold=args.threshold, device=args.device)


if __name__ == '__main__':
    main()
