"""
Import guard for the port: megadetector_tpu_torch stands alone. It imports
no jax and nothing of the JAX package (megadetector_tpu), not even its
modules that hold no jax: it keeps its own copies (ops/boxes,
utils/ct_utils, utils/path_utils, models/registry,
visualization/visualization_utils). PIL is imported only once a file is
decoded. cv2 is not checked: ops/boxes.py imports it whenever it is
installed and falls back to numpy where it is not.
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
                  'PIL': 'PIL' in sys.modules}))
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
                'megadetector_tpu_torch.detection.run_detector_batch'}
    assert expected <= set(report['modules'])
    assert report['jax'] == []
    assert report['jax_package'] == []
    assert report['PIL'] is False


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
