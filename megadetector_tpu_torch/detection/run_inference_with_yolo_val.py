"""
Parity oracle: run inference through an external YOLO repo's val.py and
convert the output to MD format, for golden-file comparison against the
port's own pipeline.

In the reference this is a first-class inference path
(megadetector/detection/run_inference_with_yolov5_val.py:287, with a flat
symlink farm for unique IDs :140-152 and YOLO-json -> MD-json conversion
via data_management/yolo_output_to_md_output.py). Here its role is
verification: generate reference results with the original YOLO stack
(when available), then compare them against the port's own results with
utils/md_tests.compare_results. Test-time augmentation, which the
reference reached through val.py, is native here
(TorchDetector augment=True).

The port's own copy of
megadetector_tpu/detection/run_inference_with_yolo_val.py: the same
public names, signatures and output bytes. Differences on purpose: each
val.py run reads a dataset YAML of its own, removed when the run ends, so
runs at once do not read each other's folder; and val.py runs on the
card by default (device_string '0', YOLOv5's name for the first CUDA
device, where JAX's default is 'cpu'), which the CLI's --device_string
changes.
"""

import os
import sys
import tempfile

from megadetector_tpu_torch.data_management.yolo_output_to_md_output import (
    yolo_json_output_to_md_output,
)
from megadetector_tpu_torch.utils import path_utils
from megadetector_tpu_torch.utils.process_utils import execute_and_print


class YoloInferenceOptions:
    """Options controlling run_inference_with_yolo_val()."""

    def __init__(self):
        self.input_folder = None
        self.model_filename = None
        self.output_file = None
        self.yolo_working_folder = None  # the yolov5 repo checkout
        self.image_size = 1280
        self.conf_thres = 0.005
        self.batch_size = 1
        # YOLOv5's --device: '0' is the first CUDA device
        self.device_string = '0'
        self.augment = False
        self.symlink_folder = None
        self.yolo_category_id_to_name = {0: 'animal', 1: 'person',
                                         2: 'vehicle'}
        self.remove_symlink_folder = True
        # Unique-ID strategy (reference :140-152): 'links' always
        # builds the symlink farm, 'verify' errors on duplicate
        # basenames, 'auto' links only when basenames collide
        self.unique_id_strategy = 'links'
        # Chunked checkpointing (reference :203-210 + chunk loop):
        # process images in chunks of this size, one val.py run per
        # chunk, resumable — chunks whose result file already exists in
        # [checkpoint_folder] are skipped
        self.checkpoint_frequency = None
        self.checkpoint_folder = None


def run_inference_with_yolo_val(options):
    """
    Run the external val.py and convert results to MD format. Requires a
    YOLOv5 repo checkout (options.yolo_working_folder) and torch; raises
    a clear error otherwise. Returns the MD-format dict.
    """

    assert options.yolo_working_folder is not None and \
        os.path.isdir(options.yolo_working_folder), \
        'run_inference_with_yolo_val requires a YOLO repo checkout ' \
        '(yolo_working_folder); for native TPU inference use ' \
        'run_detector_batch, and for TTA use augment=True'
    assert os.path.isfile(os.path.join(options.yolo_working_folder,
                                       'val.py')), \
        'No val.py in {}'.format(options.yolo_working_folder)

    images = path_utils.find_images(options.input_folder, recursive=True)

    # Unique-ID strategy (basenames become YOLO image IDs)
    basenames = [os.path.splitext(os.path.basename(p))[0]
                 for p in images]
    ids_unique = len(set(basenames)) == len(basenames)
    strategy = options.unique_id_strategy
    if strategy == 'verify':
        assert ids_unique, \
            'Duplicate image basenames; use unique_id_strategy=links'
        use_links = False
    elif strategy == 'auto':
        use_links = not ids_unique
    else:
        assert strategy == 'links', \
            'Unknown unique_id_strategy {}'.format(strategy)
        use_links = True

    symlink_folder = None
    if use_links:
        # Flat symlink farm so every image has a unique basename
        symlink_folder = options.symlink_folder or tempfile.mkdtemp(
            prefix='yolo_val_symlinks_')
        os.makedirs(symlink_folder, exist_ok=True)
        image_id_to_relative_path = {}
        run_paths = []
        for i_image, image_path in enumerate(images):
            ext = os.path.splitext(image_path)[1]
            link_name = 'im_{:0>8d}{}'.format(i_image, ext)
            image_id_to_relative_path['im_{:0>8d}'.format(i_image)] = \
                os.path.relpath(image_path, options.input_folder)
            link_path = os.path.join(symlink_folder, link_name)
            path_utils.safe_create_link(os.path.abspath(image_path),
                                        link_path)
            run_paths.append(link_path)
    else:
        image_id_to_relative_path = {
            base: os.path.relpath(p, options.input_folder)
            for base, p in zip(basenames, images)}
        run_paths = list(images)

    def run_chunk(chunk_paths, chunk_folder):
        """One val.py invocation over [chunk_paths]; returns the
        predictions-json path."""

        os.makedirs(chunk_folder, exist_ok=True)
        for p in chunk_paths:
            link = os.path.join(chunk_folder, os.path.basename(p))
            if not os.path.lexists(link):
                path_utils.safe_create_link(os.path.abspath(p), link)
        project_dir = tempfile.mkdtemp(prefix='yolo_val_results_')
        dataset_yaml = _write_dataset_yaml(chunk_folder)
        cmd = ('cd "{}" && python val.py --task test --data "{}" '
               '--weights "{}" --batch-size {} --imgsz {} '
               '--conf-thres {} --device {} --save-json '
               '--project "{}" --name results --exist-ok{}').format(
                   options.yolo_working_folder, dataset_yaml,
                   options.model_filename, options.batch_size,
                   options.image_size, options.conf_thres,
                   options.device_string, project_dir,
                   ' --augment' if options.augment else '')
        try:
            result = execute_and_print(cmd, print_output=False)
        finally:
            os.remove(dataset_yaml)
        if result['status'] != 0:
            raise RuntimeError(
                'val.py failed (status {}):\n{}'.format(
                    result['status'],
                    ''.join(result['output'][-20:])))
        predictions_files = []
        for root, _, files in os.walk(project_dir):
            predictions_files.extend(
                os.path.join(root, f) for f in files
                if f.endswith('_predictions.json') or
                f == 'best_predictions.json')
        assert predictions_files, 'No predictions file produced'
        return predictions_files[0]

    # Chunked, resumable execution: one val.py run per chunk; chunks
    # whose merged-predictions shard already exists are skipped
    if options.checkpoint_frequency and \
            options.checkpoint_frequency > 0:
        import json as _json
        import shutil
        checkpoint_folder = options.checkpoint_folder or \
            tempfile.mkdtemp(prefix='yolo_val_checkpoints_')
        os.makedirs(checkpoint_folder, exist_ok=True)
        n = options.checkpoint_frequency
        merged = []
        for i_chunk, start in enumerate(range(0, len(run_paths), n)):
            shard_file = os.path.join(
                checkpoint_folder,
                'chunk_{:04d}_predictions.json'.format(i_chunk))
            if os.path.isfile(shard_file):
                print('Skipping completed chunk {}'.format(i_chunk))
            else:
                chunk_dir = os.path.join(
                    checkpoint_folder,
                    'chunk_{:04d}_images'.format(i_chunk))
                predictions = run_chunk(run_paths[start:start + n],
                                        chunk_dir)
                shutil.copyfile(predictions, shard_file)
            with open(shard_file) as f:
                merged.extend(_json.load(f))
        combined_file = os.path.join(checkpoint_folder,
                                     'combined_predictions.json')
        with open(combined_file, 'w') as f:
            _json.dump(merged, f)
        predictions_file = combined_file
    else:
        run_folder = symlink_folder if use_links else \
            tempfile.mkdtemp(prefix='yolo_val_run_')
        if not use_links:
            for p in run_paths:
                path_utils.safe_create_link(
                    os.path.abspath(p),
                    os.path.join(run_folder, os.path.basename(p)))
        predictions_file = run_chunk(run_paths, run_folder)

    md = yolo_json_output_to_md_output(
        predictions_file, options.input_folder, options.output_file,
        yolo_category_id_to_name=options.yolo_category_id_to_name,
        image_id_to_relative_path=image_id_to_relative_path)

    if options.remove_symlink_folder and symlink_folder is not None:
        import shutil
        shutil.rmtree(symlink_folder, ignore_errors=True)

    return md


def get_stats_for_category(filename, category='all'):
    """
    Parse the per-category statistics row from YOLO val console output
    stored in [filename]; returns a dict with category, n_images,
    n_labels, P, R, mAP50, and mAP50-95, or None when the category
    isn't found (reference:
    run_inference_with_yolov5_val.py:227-283).
    """

    with open(filename, 'r', encoding='utf-8') as f:
        lines = f.readlines()

    # Hedge against a YOLO version that used different IoU thresholds
    # in the console output
    found_map50 = False
    found_map5095 = False

    for line in lines:
        s = line.strip()
        if ' map50 ' in s.lower() or ' map@.5 ' in s.lower():
            found_map50 = True
        if 'map50-95' in s.lower() or 'map@.5:.95' in s.lower():
            found_map5095 = True

        if not s.startswith(category):
            continue
        tokens_filtered = list(filter(None, s.split(' ')))
        if len(tokens_filtered) != 7:
            continue
        # startswith() above is only a cheap prefilter: 'all' must not
        # match an 'alligator' row
        if tokens_filtered[0] != category:
            continue
        assert found_map50 and found_map5095, \
            'Parsing error in YOLO console output file {}'.format(
                filename)
        return {
            'category': category,
            'n_images': int(tokens_filtered[1]),
            'n_labels': int(tokens_filtered[2]),
            'P': float(tokens_filtered[3]),
            'R': float(tokens_filtered[4]),
            'mAP50': float(tokens_filtered[5]),
            'mAP50-95': float(tokens_filtered[6]),
        }

    return None


def _write_dataset_yaml(image_folder):
    """Minimal dataset.yaml pointing val.py's 'test' split at a folder, in
    a temporary file of its own (the JAX module writes one fixed path in
    the temporary folder, which two runs at once share)."""

    fd, yaml_path = tempfile.mkstemp(prefix='yolo_val_dataset_',
                                     suffix='.yaml')
    with os.fdopen(fd, 'w') as f:
        f.write('path: {}\ntrain: .\nval: .\ntest: .\n'.format(
            image_folder))
        f.write('names:\n  0: animal\n  1: person\n  2: vehicle\n')
    return yaml_path


def main():
    import argparse
    parser = argparse.ArgumentParser(
        description='Run inference through an external YOLO val.py '
                    '(parity oracle)')
    parser.add_argument('model_filename')
    parser.add_argument('input_folder')
    parser.add_argument('output_file')
    parser.add_argument('--yolo_working_folder', required=True)
    parser.add_argument('--image_size', type=int, default=1280)
    parser.add_argument('--device_string', default='0',
                        help="val.py's --device: '0' is the first CUDA "
                             "device, 'cpu' the host")
    parser.add_argument('--augment', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = YoloInferenceOptions()
    options.model_filename = args.model_filename
    options.input_folder = args.input_folder
    options.output_file = args.output_file
    options.yolo_working_folder = args.yolo_working_folder
    options.image_size = args.image_size
    options.device_string = args.device_string
    options.augment = args.augment
    run_inference_with_yolo_val(options)


if __name__ == '__main__':
    main()
