"""
Import guard for the port: megadetector_tpu_torch stands alone. It imports
no jax and nothing of the JAX package (megadetector_tpu), not even its
modules that hold no jax: it keeps its own copies (ops/boxes,
utils/ct_utils, utils/path_utils, models/registry,
visualization/visualization_utils, postprocessing/validate_batch_results,
the tiled and video drivers, the YOLOv8, RF-DETR and DETR networks and
their converters and shims, the classifier, its converter, the two-stage
driver and the classification toolchain, the ensemble and the taxonomy
graph, which imports networkx only to build a graph; the serving daemon
and client, the trainers, their optimizer and training utilities; the
folder workflow and the inference-options comparison with their
postprocessing, rendering, sequence and EXIF modules; the weight
validation gate and its comparator, the classifier's dataset and
evaluation modules, the accelerator and profiling utilities and the
legacy .pb detector; the exported artifact, mAP evaluation, frame
extraction, the URL helpers and the integration harness; the
detection-postprocessing tools and plot_utils; the classifier-training
workflow's host tools and the CCT database tools, whose TaxonNode route
alone needs networkx; the data-format converters, importers, image and
OCR tools and the LILA tools; the Wildlife Insights and SpeciesNet results
layer, the WI platform tools and the WI download workflow; the taxonomy
tools, the YOLO val runner, change detection, XMP tagging, video
rendering and the string and process helpers; the data-parallel mesh,
its replicas and the dry run). PIL is imported only once a file is decoded or
drawn on; tensorflow only once a .pb detector is built, pandas only
inside the functions that build data frames, matplotlib only inside the
functions that plot. cv2 is not checked:
ops/boxes.py imports it whenever it is installed and falls back to numpy
where it is not.
"""

import json
import os
import re
import subprocess
import sys

import megadetector_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The detection-postprocessing tools (postprocessing/<name>.py)
POSTPROCESSING_TOOLS = (
    'load_api_results', 'add_max_conf', 'convert_output_format',
    'merge_detections', 'remap_detection_categories',
    'categorize_detections_by_size', 'md_to_coco', 'md_to_labelme',
    'md_to_wi', 'separate_detections_into_folders', 'top_folders_to_bottom',
    'create_crop_folder', 'detector_calibration',
    'render_detection_confusion_matrix', 'analyze_classification_results')
# The classifier-training workflow's host tools and the CCT database tools
CLASSIFICATION_TOOLS = (
    'classification.csv_to_json', 'classification.json_validator',
    'classification.cache_batchapi_outputs',
    'classification.aggregate_classifier_probs',
    'classification.map_classification_categories',
    'classification.merge_classification_detection_output',
    'classification.identify_mislabeled_candidates',
    'classification.save_mislabeled', 'classification.analyze_failed_images',
    'data_management.annotation_constants',
    'data_management.integrity_check_json_db',
    'data_management.add_width_and_height_to_db',
    'data_management.subset_json_db', 'data_management.coco_tools',
    'data_management.cct_to_md')
# The data-format converters, importers, image and OCR tools and the LILA
# tools (data_management/<name>.py)
DATA_FORMAT_TOOLS = (
    'importers', 'animl_to_md', 'zamba_to_md', 'yolo_output_to_md_output',
    'coco_to_yolo', 'yolo_to_coco', 'coco_to_labelme', 'labelme_to_coco',
    'labelme_to_yolo', 'cct_to_wi', 'wi_download_csv_to_coco',
    'camtrap_dp_to_coco', 'image_file_tools', 'ocr_tools', 'lila',
    'lila.lila_common', 'lila.lila_reports', 'lila.download_lila_subset',
    'lila.generate_lila_per_image_labels')
# The Wildlife Insights and SpeciesNet results layer, the WI platform tools
# and the WI download workflow
WI_TOOLS = (
    'utils.wi_utils', 'utils.wi_taxonomy_utils',
    'data_management.speciesnet_to_md',
    'taxonomy_mapping.map_lila_taxonomy_to_wi_taxonomy',
    'utils.wi_platform_utils', 'visualization.visualize_db',
    'utils.directory_listing', 'utils.split_locations_into_train_val',
    'workflows.download_wi_projects')
# The taxonomy tools, the YOLO val runner, change detection, XMP tagging,
# video rendering and the string and process helpers
HOST_TOOLS = (
    'taxonomy_mapping.species_lookup', 'taxonomy_mapping.taxonomy_release',
    'taxonomy_mapping.taxonomy_csv_checker',
    'taxonomy_mapping.validate_lila_category_mappings',
    'taxonomy_mapping.retrieve_sample_image',
    'taxonomy_mapping.simple_image_download', 'utils.process_utils',
    'detection.run_inference_with_yolo_val', 'detection.change_detection',
    'integration.xmp_integration', 'visualization.visualize_video_output',
    'utils.string_utils')
PACKAGE_DIR = os.path.dirname(os.path.abspath(
    megadetector_tpu_torch.__file__))

_CHECK = """
import importlib, json, pkgutil, sys
import megadetector_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({'modules': names,
                  'jax': sorted(m for m in sys.modules
                                if m == 'jax' or m.startswith('jax.')),
                  'jax_package': sorted(
                      m for m in sys.modules if m == 'megadetector_tpu' or
                      m.startswith('megadetector_tpu.')),
                  'PIL': 'PIL' in sys.modules,
                  'networkx': 'networkx' in sys.modules,
                  'tensorflow': 'tensorflow' in sys.modules,
                  'pandas': 'pandas' in sys.modules,
                  'matplotlib': 'matplotlib' in sys.modules}))
"""


def test_port_imports_no_jax_no_jax_package_and_no_pil():
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _CHECK], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {'megadetector_tpu_torch.device',
                'megadetector_tpu_torch.ops.cuda_nms',
                'megadetector_tpu_torch.ops.conv_int8',
                'megadetector_tpu_torch.ops.bottleneck_int8',
                'megadetector_tpu_torch.ops.quantization',
                'megadetector_tpu_torch.ops.l0_fused',
                'megadetector_tpu_torch.ops.silu_bf16',
                'megadetector_tpu_torch.ops.preprocess_device',
                'megadetector_tpu_torch.ops.boxes',
                'megadetector_tpu_torch.utils.ct_utils',
                'megadetector_tpu_torch.utils.path_utils',
                'megadetector_tpu_torch.models.registry',
                'megadetector_tpu_torch.visualization.visualization_utils',
                'megadetector_tpu_torch.models.convert_weights',
                'megadetector_tpu_torch.models.detector',
                'megadetector_tpu_torch.models.yolov8',
                'megadetector_tpu_torch.models.rfdetr',
                'megadetector_tpu_torch.models.detr',
                'megadetector_tpu_torch.models.params',
                'megadetector_tpu_torch.detection.pytorch_detector',
                'megadetector_tpu_torch.detection.rfdetr_detector',
                'megadetector_tpu_torch.models.program_cache',
                'megadetector_tpu_torch.detection.run_detector',
                'megadetector_tpu_torch.detection.run_detector_batch',
                'megadetector_tpu_torch.detection.run_tiled_inference',
                'megadetector_tpu_torch.detection.video_utils',
                'megadetector_tpu_torch.detection.process_video',
                'megadetector_tpu_torch.postprocessing.'
                'validate_batch_results',
                'megadetector_tpu_torch.workflows.manage_video_batch',
                'megadetector_tpu_torch.detection._loader_worker',
                'megadetector_tpu_torch.native',
                'megadetector_tpu_torch.utils.read_exif',
                'megadetector_tpu_torch.ops.gemm_int8',
                'megadetector_tpu_torch.experiments._harness',
                'megadetector_tpu_torch.experiments.exp_conv3x3',
                'megadetector_tpu_torch.experiments.exp_conv3x3b',
                'megadetector_tpu_torch.experiments.exp_conv3x3c',
                'megadetector_tpu_torch.experiments.exp_conv3x3d',
                'megadetector_tpu_torch.experiments.exp_int8_chain',
                'megadetector_tpu_torch.experiments.exp_int8_matmul',
                'megadetector_tpu_torch.models.efficientnet',
                'megadetector_tpu_torch.models.classifier',
                'megadetector_tpu_torch.models.convert_speciesnet',
                'megadetector_tpu_torch.postprocessing.'
                'classification_ensemble',
                'megadetector_tpu_torch.taxonomy_mapping.taxonomy_graph',
                'megadetector_tpu_torch.detection.run_md_and_classifier',
                'megadetector_tpu_torch.detection.run_md_and_speciesnet',
                'megadetector_tpu_torch.classification.crop_detections',
                'megadetector_tpu_torch.classification.run_classifier',
                'megadetector_tpu_torch.classification.detect_and_crop',
                'megadetector_tpu_torch.serving.server',
                'megadetector_tpu_torch.serving.client',
                'megadetector_tpu_torch.training.optim',
                'megadetector_tpu_torch.training.train_detector',
                'megadetector_tpu_torch.training.train_classifier',
                'megadetector_tpu_torch.classification.train_utils',
                'megadetector_tpu_torch.classification.train_classifier',
                'megadetector_tpu_torch.utils.write_html_image_list',
                'megadetector_tpu_torch.visualization.'
                'visualize_detector_output',
                'megadetector_tpu_torch.visualization.'
                'render_images_with_thumbnails',
                'megadetector_tpu_torch.postprocessing.compare_batch_results',
                'megadetector_tpu_torch.workflows.compare_inference_options',
                'megadetector_tpu_torch.postprocessing.'
                'repeat_detection_elimination.repeat_detections_core',
                'megadetector_tpu_torch.postprocessing.'
                'repeat_detection_elimination.find_repeat_detections',
                'megadetector_tpu_torch.postprocessing.'
                'repeat_detection_elimination.remove_repeat_detections',
                'megadetector_tpu_torch.postprocessing.'
                'subset_json_detector_output',
                'megadetector_tpu_torch.postprocessing.'
                'classification_postprocessing',
                'megadetector_tpu_torch.data_management.cct_json_utils',
                'megadetector_tpu_torch.data_management.read_exif',
                'megadetector_tpu_torch.postprocessing.'
                'postprocess_batch_results',
                'megadetector_tpu_torch.postprocessing.generate_csv_report',
                'megadetector_tpu_torch.postprocessing.combine_batch_outputs',
                'megadetector_tpu_torch.workflows.manage_local_batch',
                'megadetector_tpu_torch.utils.md_tests',
                'megadetector_tpu_torch.utils.validate_weights',
                'megadetector_tpu_torch.classification.'
                'create_classification_dataset',
                'megadetector_tpu_torch.classification.evaluate_model',
                'megadetector_tpu_torch.utils.accelerator_test',
                'megadetector_tpu_torch.utils.gpu_test',
                'megadetector_tpu_torch.utils.profiling',
                'megadetector_tpu_torch.detection.tf_detector',
                'megadetector_tpu_torch.detection.export_detector',
                'megadetector_tpu_torch.postprocessing.evaluate_detections',
                'megadetector_tpu_torch.utils.extract_frames_from_video',
                'megadetector_tpu_torch.utils.url_utils',
                'megadetector_tpu_torch.utils.integration_tests'} | {
                    'megadetector_tpu_torch.postprocessing.' + name
                    for name in POSTPROCESSING_TOOLS} | {
                    'megadetector_tpu_torch.visualization.plot_utils'} | {
                    'megadetector_tpu_torch.' + name
                    for name in CLASSIFICATION_TOOLS} | {
                    'megadetector_tpu_torch.data_management.' + name
                    for name in DATA_FORMAT_TOOLS} | {
                    'megadetector_tpu_torch.' + name for name in WI_TOOLS} | {
                    'megadetector_tpu_torch.' + name for name in HOST_TOOLS}
    assert expected <= set(report['modules'])
    assert report['jax'] == []
    assert report['jax_package'] == []
    assert report['PIL'] is False
    assert report['networkx'] is False
    assert report['tensorflow'] is False
    assert report['pandas'] is False
    assert report['matplotlib'] is False


def test_no_port_source_imports_jax_or_the_jax_package():
    jax_import = re.compile(r'^\s*(import\s+jax\b|from\s+jax\b)', re.M)
    # Any module of the JAX package (megadetector_tpu_torch is the port)
    jax_module_import = re.compile(
        r'^\s*(from|import)\s+megadetector_tpu(\.|\s|$|,)', re.M)
    sources = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PACKAGE_DIR):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith('.py')]
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not jax_import.search(text), path
        assert not jax_module_import.search(text), path


def test_no_port_source_imports_tqdm():
    """The card's machine is not promised tqdm: the port's drivers print
    their progress plainly (torch may import tqdm itself, so the sources
    are read)."""

    tqdm_import = re.compile(r'^\s*(import\s+tqdm\b|from\s+tqdm\b)', re.M)
    sources = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PACKAGE_DIR):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith('.py')]
    for path in sources:
        with open(path) as f:
            assert not tqdm_import.search(f.read()), path
    with open(os.path.join(REPO, 'megadetector_tpu', 'detection',
                           'video_utils.py')) as f:
        assert tqdm_import.search(f.read())


_RUN = """
import json, os, sys, tempfile
import numpy as np
import torch
sys.path.insert(0, 'tests')
from torch_yolo_ref import make_torch_model
from megadetector_tpu_torch.detection import run_detector, run_detector_batch
from megadetector_tpu_torch.models import convert_weights
from megadetector_tpu_torch.models.yolov5 import YoloV5Config
tmp = tempfile.mkdtemp()
model = make_torch_model(YoloV5Config('yolov5n', num_classes=3), seed=0)
pt = os.path.join(tmp, 'tiny.pt')
torch.save({'model': model}, pt)
out = convert_weights.main([pt, os.path.join(tmp, 'tiny.npz'), '--arch',
                            'yolov5n', '--quantize', '--device', 'cpu'])
detector = run_detector.load_detector(
    out, device='cpu', detector_options={'image_size': 128})
img = np.random.RandomState(0).randint(0, 256, (96, 128, 3), np.uint8)
results = run_detector_batch.load_and_run_detector_batch(
    detector, [('a', img), ('b', img)], batch_size=2, quiet=True,
    augment=True, checkpoint_path=os.path.join(tmp, 'ckpt.json'),
    checkpoint_frequency=1)
print(json.dumps({'n': len(results),
                  'programs': sorted(k[0] for k in detector._programs.entries),
                  'jax': sorted(m for m in sys.modules
                                if m == 'jax' or m.startswith('jax.')),
                  'jax_package': sorted(
                      m for m in sys.modules if m == 'megadetector_tpu' or
                      m.startswith('megadetector_tpu.'))}))
"""


def test_converter_tta_and_checkpoints_run_without_jax():
    """The converter and its CLI (with --quantize), test-time
    augmentation through the program cache, and batch checkpoints run
    without importing jax or the JAX package."""

    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report['n'] == 2
    assert report['programs'] == ['augment']
    assert report['jax'] == []
    assert report['jax_package'] == []


_FAMILIES = """
import json, os, sys, tempfile
import numpy as np
from megadetector_tpu_torch.detection import pytorch_detector, rfdetr_detector
from megadetector_tpu_torch.detection.run_detector import load_detector
from megadetector_tpu_torch.models import detr, rfdetr, yolov8
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
tmp = tempfile.mkdtemp()
img = np.random.RandomState(0).randint(0, 256, (96, 128, 3), np.uint8)
counts = {}
for name, module, config, size, model_type in (
        ('yolov8n', yolov8, yolov8.YoloV8Config('yolov8n', 3), 64,
         'ultralytics'),
        ('rfdetr_test', rfdetr, rfdetr.RFDetrConfig('rfdetr_test', 3, 112),
         112, 'rfdetr'),
        ('detr_tiny', detr, detr.DetrConfig('detr_tiny', 3, 64), 64,
         'detr')):
    path = os.path.join(tmp, name + '.npz')
    save_checkpoint(module.init_params(config, seed=0), path, {
        'arch': name, 'model_type': model_type, 'num_classes': 3,
        'image_size': size})
    for dtype in ('float32', 'bfloat16'):
        detector = load_detector(path, device='cpu', detector_options={
            'dtype': dtype})
        result = detector.generate_detections_one_image(img, 'a', 0.005)
        counts[name + '_' + dtype] = len(result['detections'])
loaded = rfdetr_detector.load_model(os.path.join(tmp, 'rfdetr_test.npz'),
                                    device='cpu')
pred = np.zeros((1, 4, 8), np.float32)
pred[0, :, :4] = [[10, 10, 4, 4], [11, 10, 4, 4], [40, 40, 4, 4],
                  [80, 80, 4, 4]]
pred[0, :, 4] = 1.0
pred[0, :, 5] = [0.9, 0.8, 0.7, 0.1]
kept = pytorch_detector.nms(pred, device='cpu')
print(json.dumps({'counts': counts, 'kept': len(kept[0]),
                  'rfdetr_type': loaded['model_type'],
                  'jax': sorted(m for m in sys.modules
                                if m == 'jax' or m.startswith('jax.')),
                  'jax_package': sorted(
                      m for m in sys.modules if m == 'megadetector_tpu' or
                      m.startswith('megadetector_tpu.'))}))
"""


def test_other_families_and_shims_run_without_jax():
    """YOLOv8, RF-DETR and DETR detectors (float32 and bf16), the
    rfdetr_detector and pytorch_detector shims, run without importing jax
    or the JAX package."""

    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _FAMILIES], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(report['counts']) == sorted(
        '{}_{}'.format(n, d) for n in ('yolov8n', 'rfdetr_test', 'detr_tiny')
        for d in ('float32', 'bfloat16'))
    assert all(n > 0 for n in report['counts'].values()), report['counts']
    # Boxes 1 and 2 overlap (IoU 0.6 > 0.45); the 0.1 box is below 0.25
    assert report['kept'] == 2
    assert report['rfdetr_type'] == 'rfdetr'
    assert report['jax'] == []
    assert report['jax_package'] == []


_TWO_STAGE = """
import json, os, sys, tempfile
import numpy as np
import cv2
from PIL import Image
sys.modules['networkx'] = None
from megadetector_tpu_torch.detection import run_md_and_classifier
from megadetector_tpu_torch.models import efficientnet, yolov5
from megadetector_tpu_torch.models.classifier import SpeciesClassifier
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
tmp = tempfile.mkdtemp()
folder = os.path.join(tmp, 'media')
os.makedirs(folder)
rng = np.random.RandomState(0)
for i in range(2):
    Image.fromarray(rng.randint(0, 256, (60, 80, 3), np.uint8)).save(
        os.path.join(folder, 'im{}.jpg'.format(i)))
out = cv2.VideoWriter(os.path.join(folder, 'v.mp4'),
                      cv2.VideoWriter_fourcc(*'mp4v'), 8, (64, 48))
for _ in range(6):
    out.write(rng.randint(0, 256, (48, 64, 3), np.uint8))
out.release()
det = yolov5.YoloV5Config('yolov5n', num_classes=3)
save_checkpoint(yolov5.init_params(det, seed=7), os.path.join(tmp, 'd.npz'),
                {'arch': 'yolov5n', 'model_type': 'yolov5',
                 'num_classes': 3, 'image_size': 64})
cfg = efficientnet.EfficientNetConfig('efficientnetv2_test', 4)
save_checkpoint(efficientnet.init_params(cfg, seed=3),
                os.path.join(tmp, 'c.npz'),
                {'arch': 'efficientnetv2_test', 'num_classes': 4,
                 'image_size': 64})
counts = {}
for name, clf in (('float32', {}), ('bfloat16', {'dtype': 'bfloat16'}),
                  ('int8', {'quantize': 'int8'})):
    options = run_md_and_classifier.MDAndClassifierOptions()
    options.input_folder = folder
    options.output_file = os.path.join(tmp, name + '.json')
    options.detector_model = os.path.join(tmp, 'd.npz')
    options.classifier_model = os.path.join(tmp, 'c.npz')
    options.classifier_options = clf
    options.classification_confidence_threshold = 0.01
    options.frame_sample = 2
    options.device = 'cpu'
    options.apply_ensemble = True
    data = run_md_and_classifier.run_md_and_classifier(options)
    counts[name] = sum('classifications' in d for im in data['images']
                       for d in im['detections'] or [])
print(json.dumps({'counts': counts,
                  'jax': sorted(m for m in sys.modules
                                if m == 'jax' or m.startswith('jax.')),
                  'jax_package': sorted(
                      m for m in sys.modules if m == 'megadetector_tpu' or
                      m.startswith('megadetector_tpu.'))}))
"""


def test_classifier_and_two_stage_run_without_jax_or_networkx():
    """The two-stage driver with the classifier in float32, bf16 and int8
    (auto-calibrated), over images and a video, with the ensemble (no
    taxonomy file), runs without importing jax, the JAX package or
    networkx."""

    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _TWO_STAGE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(report['counts']) == ['bfloat16', 'float32', 'int8']
    assert all(n > 0 for n in report['counts'].values()), report['counts']
    assert report['jax'] == []
    assert report['jax_package'] == []


_TOOLS = """
import importlib, json, os, sys, tempfile
# Importing any of these now raises ImportError
for blocked in ('jax', 'megadetector_tpu', 'tqdm'):
    sys.modules[blocked] = None
import numpy as np
from PIL import Image
names = json.loads(sys.argv[1])
for name in names:
    importlib.import_module(name)
from megadetector_tpu_torch.postprocessing import (
    convert_output_format, create_crop_folder, merge_detections)
from megadetector_tpu_torch.utils import ct_utils
tmp = tempfile.mkdtemp()
rng = np.random.RandomState(0)
images = os.path.join(tmp, 'images')
os.makedirs(os.path.join(images, 'cam'))
for i in range(3):
    Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(
        os.path.join(images, 'cam', 'im{}.jpg'.format(i)))


def results(seed):
    r = np.random.RandomState(seed)
    return {'info': {'format_version': '1.4'},
            'detection_categories': {'1': 'animal', '2': 'person'},
            'images': [{'file': 'cam/im{}.jpg'.format(i), 'detections': [
                {'category': str(r.randint(1, 3)),
                 'conf': round(float(r.uniform(0.2, 0.9)), 3),
                 'bbox': [round(float(v), 4) for v in
                          r.uniform(0.05, 0.45, 4)]}
                for _ in range(2)]} for i in range(3)]}


a, b = (os.path.join(tmp, n) for n in ('a.json', 'b.json'))
ct_utils.write_json(a, results(1))
ct_utils.write_json(b, results(2))
merged = merge_detections.merge_detections(b, a, os.path.join(tmp, 'm.json'))
csv_file = convert_output_format.convert_json_to_csv(a)
back = convert_output_format.convert_csv_to_json(
    csv_file, os.path.join(tmp, 'back.json'))
options = create_crop_folder.CreateCropFolderOptions()
options.n_threads = 2
cropped = create_crop_folder.create_crop_folder(
    a, images, os.path.join(tmp, 'crops'),
    crops_output_file=os.path.join(tmp, 'crops.json'), options=options)
with open(back) as f:
    round_trip = json.load(f)
print(json.dumps({
    'merged': sum(len(im['detections']) for im in merged['images']),
    'round_trip': [im['detections'] for im in round_trip['images']] ==
    [im['detections'] for im in results(1)['images']],
    'crops': sorted(os.listdir(os.path.join(tmp, 'crops', 'cam'))),
    'tagged': sum('crop_filename' in d for im in cropped['images']
                  for d in im['detections']),
    'blocked': [m for m in ('jax', 'megadetector_tpu', 'tqdm')
                if sys.modules[m] is not None]}))
"""


def test_postprocessing_tools_run_without_jax_or_tqdm():
    """Each detection-postprocessing module and plot_utils imports with
    jax, the JAX package and tqdm made unimportable; merge_detections,
    convert_output_format (JSON -> CSV -> JSON) and create_crop_folder
    (a thread pool) then run on a tiny input."""

    names = ['megadetector_tpu_torch.postprocessing.' + name
             for name in POSTPROCESSING_TOOLS] + [
        'megadetector_tpu_torch.visualization.plot_utils']
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _TOOLS, json.dumps(names)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report['merged'] > 6
    assert report['round_trip'] is True
    assert report['crops'] == ['im{}_crop_{:03d}.jpg'.format(i, j)
                               for i in range(3) for j in range(2)]
    assert report['tagged'] == 6
    assert report['blocked'] == []


_CLASSIFICATION = """
import importlib, json, os, sys, tempfile
# Importing any of these now raises ImportError
for blocked in ('jax', 'megadetector_tpu', 'tqdm', 'networkx'):
    sys.modules[blocked] = None
import numpy as np
from PIL import Image
names = json.loads(sys.argv[1])
for name in names:
    importlib.import_module(name)
from megadetector_tpu_torch.classification import (
    analyze_failed_images, map_classification_categories)
from megadetector_tpu_torch.data_management import (
    add_width_and_height_to_db, cct_to_md, subset_json_db)
tmp = tempfile.mkdtemp()
rng = np.random.RandomState(0)
db = {'images': [], 'annotations': [], 'categories': [
    {'id': 1, 'name': 'deer'}]}
for i in range(4):
    name = 'cam{}/im{}.jpg'.format(i % 2, i)
    os.makedirs(os.path.join(tmp, 'cam{}'.format(i % 2)), exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (30 + i, 40, 3), np.uint8)).save(
        os.path.join(tmp, name))
    db['images'].append({'id': i, 'file_name': name})
    db['annotations'].append({'id': i, 'image_id': i, 'category_id': 1,
                              'bbox': [1, 2, 10, 12]})
db = add_width_and_height_to_db.add_width_and_height_to_db(db, tmp,
                                                           n_workers=3)
md = cct_to_md.cct_to_md(subset_json_db.subset_json_db(db, 'cam1/'))
spec = {'d': {'dataset_labels': {'ds': ['deer']}},
        'e': {'dataset_labels': {'ds': ['elk']}}}
mapping = map_classification_categories.map_classification_categories(
    {'cervid': {'dataset_labels': {'ds': ['deer', 'elk']}}}, spec)
try:
    map_classification_categories.parse_spec(
        {'taxa': [{'level': 'family', 'name': 'cervidae'}]}, {}, {})
    refusal = None
except ImportError as e:
    refusal = str(e)
report = analyze_failed_images.analyze_failed_images(
    [im['file_name'] for im in db['images']], tmp, threads=2)
print(json.dumps({
    'heights': [im['height'] for im in db['images']],
    'md_boxes': sum(len(im['detections']) for im in md['images']),
    'mapping': mapping, 'refusal': refusal,
    'ok': len(report['by_status']['ok']),
    'blocked': [m for m in ('jax', 'megadetector_tpu', 'tqdm', 'networkx')
                if sys.modules[m] is not None]}))
"""


def test_classification_and_cct_tools_run_without_jax_tqdm_or_networkx():
    """The 15 host tools of the classifier-training workflow and the CCT
    database import with jax, the JAX package, tqdm and networkx made
    unimportable; add_width_and_height_to_db (a thread pool),
    subset_json_db, cct_to_md, map_classification_categories' pair route
    and analyze_failed_images (threads) then run, and the TaxonNode route
    raises an ImportError that names networkx."""

    names = ['megadetector_tpu_torch.' + name
             for name in CLASSIFICATION_TOOLS]
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _CLASSIFICATION,
                           json.dumps(names)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report['heights'] == [30, 31, 32, 33]
    assert report['md_boxes'] == 2
    assert report['mapping'] == {'cervid': ['d', 'e']}
    assert report['refusal'] is not None and 'networkx' in report['refusal']
    assert report['ok'] == 4
    assert report['blocked'] == []


_DATA_FORMATS = """
import importlib, json, os, sys, tempfile
# Importing any of these now raises ImportError
for blocked in ('jax', 'megadetector_tpu', 'tqdm'):
    sys.modules[blocked] = None
import numpy as np
from PIL import Image
names = json.loads(sys.argv[1])
for name in names:
    importlib.import_module(name)
from megadetector_tpu_torch.data_management import (
    coco_to_labelme, coco_to_yolo, image_file_tools, importers,
    labelme_to_yolo, ocr_tools, yolo_to_coco)
from megadetector_tpu_torch.data_management.lila import lila_common


def main():
    tmp = tempfile.mkdtemp()
    images = os.path.join(tmp, 'images')
    rng = np.random.RandomState(0)
    db = {'images': [], 'annotations': [], 'categories': [
        {'id': 1, 'name': 'deer'}]}
    for i in range(4):
        name = 'cam{}/im{}.jpg'.format(i % 2, i)
        os.makedirs(os.path.join(images, 'cam{}'.format(i % 2)),
                    exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (30, 40, 3), np.uint8)).save(
            os.path.join(images, name))
        db['images'].append({'id': i, 'file_name': name, 'width': 40,
                             'height': 30})
        db['annotations'].append({'id': i, 'image_id': i, 'category_id': 1,
                                  'bbox': [1, 2, 10, 12]})
    db_file = os.path.join(tmp, 'db.json')
    with open(db_file, 'w') as f:
        json.dump(db, f)
    yolo = os.path.join(tmp, 'yolo')
    coco_to_yolo.coco_to_yolo(images, yolo, db_file)
    back = yolo_to_coco.yolo_to_coco(yolo, os.path.join(yolo, 'classes.txt'))
    coco_to_labelme.coco_to_labelme(db, images)
    spawned = labelme_to_yolo.labelme_folder_to_yolo(
        images, n_workers=2, use_threads=False)
    renamed = image_file_tools.rename_images(
        images, os.path.join(tmp, 'flat'), n_copy_workers=2)
    md = importers.zamba_to_md(_zamba(tmp))
    try:
        ocr_tools.get_datetime_from_image(np.zeros((40, 40, 3), np.uint8))
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    print(json.dumps({
        'boxes': len(back['annotations']),
        'converted': [r['status'] for r in spawned['image_results']],
        'renamed': len(renamed), 'zamba': len(md['images']),
        'url': lila_common.lila_image_url({}, 'a/b.jpg'),
        'refusal': refusal,
        'blocked': [m for m in ('jax', 'megadetector_tpu', 'tqdm')
                    if sys.modules[m] is not None]}))


def _zamba(tmp):
    path = os.path.join(tmp, 'zamba.csv')
    with open(path, 'w') as f:
        f.write('filepath,blank,deer\\na.mp4,0.2,0.8\\n')
    return path


if __name__ == '__main__':
    sys.modules['pytesseract'] = None
    main()
"""


def test_data_format_tools_run_without_jax_or_tqdm(tmp_path):
    """The 19 data-format, importer, image, OCR and LILA modules import
    with jax, the JAX package and tqdm made unimportable; coco_to_yolo,
    yolo_to_coco, coco_to_labelme, labelme_folder_to_yolo (a spawned
    pool), rename_images (threads), an importer and a LILA URL then run,
    and ocr_tools without an engine raises RuntimeError."""

    names = ['megadetector_tpu_torch.data_management.' + name
             for name in DATA_FORMAT_TOOLS]
    script = str(tmp_path / 'data_formats.py')
    with open(script, 'w') as f:
        f.write(_DATA_FORMATS)
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, script, json.dumps(names)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report['boxes'] == 4
    assert report['converted'] == ['converted'] * 4
    assert report['renamed'] == 4
    assert report['zamba'] == 1
    assert report['url'] == ('https://storage.googleapis.com/'
                             'public-datasets-lila/a/b.jpg')
    assert report['refusal'] is not None and 'OCR' in report['refusal']
    assert report['blocked'] == []


_WI = """
import importlib, json, os, sys, tempfile
# Importing any of these now raises ImportError
for blocked in ('jax', 'megadetector_tpu', 'tqdm'):
    sys.modules[blocked] = None
import numpy as np
from PIL import Image
names = json.loads(sys.argv[1])
for name in names:
    importlib.import_module(name)
from megadetector_tpu_torch.utils import (
    directory_listing, split_locations_into_train_val, wi_platform_utils,
    wi_taxonomy_utils, wi_utils)
from megadetector_tpu_torch.visualization import visualize_db
tmp = tempfile.mkdtemp()
rng = np.random.RandomState(0)
Image.fromarray(rng.randint(0, 256, (30, 40, 3), np.uint8)).save(
    os.path.join(tmp, 'a.jpg'))
db = {'images': [{'id': 'a', 'file_name': 'a.jpg'}],
      'annotations': [{'id': 0, 'image_id': 'a', 'category_id': 1,
                       'bbox': [1, 2, 10, 12]}],
      'categories': [{'id': 1, 'name': 'deer'}]}
with open(os.path.join(tmp, 'db.json'), 'w') as f:
    json.dump(db, f)
deer = 'u1;mammalia;cetartiodactyla;cervidae;odocoileus;virginianus;deer'
md = wi_taxonomy_utils.generate_md_results_from_predictions_json(
    {'predictions': [{'filepath': 'a.jpg', 'detections': [],
                      'prediction': deer, 'prediction_score': 0.9}]})
payload = wi_platform_utils.generate_payload_for_prediction_string(
    '00000000-0000-4000-8000-000000000000', 7, deer)
html, _ = visualize_db.visualize_db(os.path.join(tmp, 'db.json'),
                                    os.path.join(tmp, 'viz'), tmp)
written = directory_listing.create_html_index(os.path.join(tmp, 'viz'))
val, _ = split_locations_into_train_val.split_locations_into_train_val(
    {'l{}'.format(i): {'deer': i + 1} for i in range(10)},
    n_random_seeds=10, default_max_allowable_error=None)
print(json.dumps({
    'common': wi_utils.taxonomy_string_to_common_name(deer),
    'fake': md['images'][0]['detections'][0]['bbox'],
    'valid': wi_platform_utils.validate_payload(payload),
    'html': os.path.isfile(html), 'indexes': len(written),
    'val': len(val),
    'pandas': 'pandas' in sys.modules,
    'blocked': [m for m in ('jax', 'megadetector_tpu', 'tqdm')
                if sys.modules[m] is not None]}))
"""


def test_wi_tools_run_without_jax_tqdm_or_pandas():
    """The nine Wildlife Insights and SpeciesNet modules import with jax,
    the JAX package and tqdm made unimportable; predictions.json to MD
    results, a WI payload and its validation, visualize_db, a directory
    index and a location split then run without importing pandas."""

    names = ['megadetector_tpu_torch.' + name for name in WI_TOOLS]
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _WI, json.dumps(names)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {'common': 'deer', 'fake': [0, 0, 1, 1], 'valid': True,
                      'html': True, 'indexes': 1, 'val': 1,
                      'pandas': False, 'blocked': []}


_HOST = """
import importlib, json, os, sys, tempfile
# Importing any of these now raises ImportError
for blocked in ('jax', 'megadetector_tpu', 'tqdm'):
    sys.modules[blocked] = None
import numpy as np
names = json.loads(sys.argv[1])
for name in names:
    importlib.import_module(name)
from megadetector_tpu_torch import native
from megadetector_tpu_torch.detection import change_detection
from megadetector_tpu_torch.integration import xmp_integration
from megadetector_tpu_torch.taxonomy_mapping import (species_lookup,
                                                     taxonomy_release)
from megadetector_tpu_torch.utils import process_utils, string_utils
tmp = tempfile.mkdtemp()
import cv2
os.makedirs(os.path.join(tmp, 'cam'))
rng = np.random.RandomState(0)
for i in range(3):
    img = rng.randint(0, 50, (40, 60), np.uint8)
    img[10:30, 10 * i:10 * i + 20] = 250
    cv2.imwrite(os.path.join(tmp, 'cam', 'im{}.jpg'.format(i)), img)
motion = change_detection.process_folders(os.path.join(tmp, 'cam'))
with open(os.path.join(tmp, 'r.json'), 'w') as f:
    json.dump({'images': [{'file': 'im0.jpg', 'detections': [
        {'category': '1', 'conf': 0.9, 'bbox': [0, 0, 1, 1]}]}],
        'detection_categories': {'1': 'animal'}}, f)
xmp = xmp_integration.write_results_to_xmp(os.path.join(tmp, 'r.json'),
                                           os.path.join(tmp, 'cam'))
lookup = species_lookup.SpeciesLookup(
    [('1', 'genus', 'puma', None), ('2', 'species', 'puma concolor', '1')],
    synonyms={'cougar': 'puma concolor'})
rows = taxonomy_release.map_new_dataset('ds', ['Cougar'], lookup)
print(json.dumps({
    'motion': sum(r['motion'] for r in motion),
    'xmp': len(xmp), 'mapped': rows[0]['scientific_name'],
    'bytes': string_utils.human_readable_to_bytes('2 KB'),
    'echo': process_utils.execute_and_print('echo ok',
                                            print_output=False)['output'],
    'nms': native.nms_xyxy(np.array([[0, 0, 2, 2], [0, 0, 2, 2.1]],
                                    np.float32),
                           np.array([0.5, 0.9], np.float32), 0.5).tolist(),
    'PIL': 'PIL' in sys.modules,
    'blocked': [m for m in ('jax', 'megadetector_tpu', 'tqdm')
                if sys.modules[m] is not None]}))
"""


def test_host_tools_run_without_jax_or_tqdm():
    """The twelve host modules of the taxonomy tools, the YOLO val runner,
    change detection, XMP tagging, video rendering and the string and
    process helpers import with jax, the JAX package and tqdm made
    unimportable; change detection, XMP sidecars, a taxonomy mapping, the
    helpers and the native NMS then run without PIL."""

    names = ['megadetector_tpu_torch.' + name for name in HOST_TOOLS]
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', _HOST, json.dumps(names)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {'motion': 2, 'xmp': 1, 'mapped': 'puma concolor',
                      'bytes': 2048.0, 'echo': ['ok\n'], 'nms': [1],
                      'PIL': False, 'blocked': []}


def _public(path):
    """{name: signature} of the public functions and classes of [path] (a
    class: its bases and each method's arguments), and the names of its
    public module-level assignments (ROADMAP C's AST diff)."""

    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and \
                not node.name.startswith('_'):
            out[node.name] = ast.unparse(node.args)
        elif isinstance(node, ast.ClassDef) and \
                not node.name.startswith('_'):
            out[node.name] = (
                [ast.unparse(b) for b in node.bases],
                {n.name: ast.unparse(n.args) for n in node.body
                 if isinstance(n, ast.FunctionDef)})
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and \
                        not target.id.startswith('_'):
                    out[target.id] = 'assigned'
    return out


def _sources(module):
    return [os.path.join(REPO, package, *module.split('.')) + '.py'
            for package in ('megadetector_tpu', 'megadetector_tpu_torch')]


def test_host_tools_public_signatures_match():
    """The twelve modules match their JAX modules exactly."""

    for module in HOST_TOOLS:
        want, got = (_public(p) for p in _sources(module))
        assert got == want and want, module


# (module, the JAX functions the port now has with their signatures)
QUEUE_C = (
    ('native/__init__', ('is_available', 'letterbox_u8', 'nms_xyxy',
                         'cluster_boxes')),
    ('utils/path_utils', ('unzip_file', 'safe_create_link')),
    ('models/registry', ('download_model', 'try_download_known_detector',
                         'find_converted_checkpoint',
                         'get_default_model_folder')),
    ('ops/quantization', ('is_quantized',)),
    ('ops/preprocess_device', ('letterbox_one',)),
    ('models/yolov5', ('conv_geom',)),
)


def test_native_bindings_and_queue_c_functions_match():
    """The four native bindings, the two path_utils helpers and queue C's
    five functions have the JAX functions' signatures."""

    for module, names in QUEUE_C:
        want, got = (_public(p) for p in _sources(module.replace('/', '.')))
        for name in names:
            assert name in got and got[name] == want[name], (module, name)


# The three helper modules whose every public function the port now has
HELPER_MODULES = ('utils.ct_utils', 'utils.path_utils',
                  'visualization.visualization_utils')


def test_helper_modules_have_every_jax_public_function():
    """ct_utils, path_utils and visualization_utils: each public function
    of the JAX module is in the port's with its signature."""

    for module in HELPER_MODULES:
        want, got = (_public(p) for p in _sources(module))
        functions = [n for n, v in want.items() if isinstance(v, str) and
                     v != 'assigned']
        assert len(functions) > 20, module
        for name in functions:
            assert got.get(name) == want[name], (module, name)


def test_mesh_and_data_parallel_entry_points_match():
    """parallel/mesh has all nine public names of JAX's, each with JAX's
    arguments (make_data_mesh adds the keyword-only devices); the sharded
    train steps and prep_device exist, prep_device and run_epoch with
    JAX's arguments (the port's steps take the model, as its unsharded
    steps do)."""

    want, got = (_public(p) for p in _sources('parallel.mesh'))
    assert len(want) == 9
    for name, sig in want.items():
        if name == 'make_data_mesh':
            assert got[name] == sig + ', *, devices=None'
        else:
            assert got[name] == sig, name
    for module, names in (
            ('training.train_detector', ('make_sharded_detector_train_step',
                                         'make_detector_train_step')),
            ('training.train_classifier', ('make_sharded_train_step',
                                           'make_train_step')),
            ('classification.train_classifier', ('prep_device',
                                                 'run_epoch'))):
        want, got = (_public(p) for p in _sources(module))
        for name in names:
            assert name in got and name in want, (module, name)
    want, got = (_public(p) for p in _sources(
        'classification.train_classifier'))
    assert got['prep_device'] == want['prep_device']
    assert got['run_epoch'].endswith('batch_multiple=None')
    assert want['run_epoch'].endswith('batch_multiple=None')
