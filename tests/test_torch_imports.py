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
extraction, the URL helpers and the integration harness). PIL is imported only once a file is decoded or
drawn on; tensorflow only once a .pb detector is built, pandas only
inside the functions that build data frames. cv2 is not checked:
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
                  'pandas': 'pandas' in sys.modules}))
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
                'megadetector_tpu_torch.utils.integration_tests'}
    assert expected <= set(report['modules'])
    assert report['jax'] == []
    assert report['jax_package'] == []
    assert report['PIL'] is False
    assert report['networkx'] is False
    assert report['tensorflow'] is False
    assert report['pandas'] is False


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
