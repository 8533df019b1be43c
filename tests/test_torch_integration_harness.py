"""
The port's integration harness (utils/integration_tests.py) on the CPU:

- its Python tiers (single image against batch, batch-size invariance,
  augmentation, video, tiled, postprocessing and RDE) pass on the port's
  own synthetic package, with the tiers JAX's harness reports;
- the package it builds is JAX's (the same images, video and checkpoint
  arrays);
- download_test_data stages a package from a file:// URL (no network)
  and falls back to the synthetic package when the URL cannot be read;
- run_download_tests resolves known models only to checkpoints on disk;
- get_expected_results_filename names the torch version;
- the full harness with its CLI tier (every CLI of the port as a
  subprocess, export -> batch from the artifact identical to the
  checkpoint's run) is marked slow, as JAX's is in
  tests/test_md_tests_harness.py.
"""

import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

from megadetector_tpu.utils import integration_tests as jax_it
from megadetector_tpu_torch.models.convert_weights import load_checkpoint
from megadetector_tpu_torch.utils import integration_tests as it


def _options(scratch, **kwargs):
    options = it.MDTestOptions()
    options.scratch_dir = scratch
    options.force_cpu = True
    options.verbose = False
    for k, v in kwargs.items():
        setattr(options, k, v)
    return options


def test_python_tiers_pass_on_the_cpu(tmp_path):
    assert it.MDTestOptions().force_cpu is False
    assert it.MDTestOptions().skip_cli_tests is True
    status = it.run_python_tests(_options(str(tmp_path / 'tiers')))
    assert status == {'single_image': 'ok', 'batch_folder': 'ok',
                      'augmented': 'ok', 'video': 'ok', 'tiled': 'ok',
                      'postprocessing': 'ok'}
    # The scratch folder is kept when given
    assert os.path.isfile(str(tmp_path / 'tiers' / 'results_b2.json'))


def _tree(root):
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_test_package_is_jax_s(tmp_path):
    ours = it._build_test_package(_options(str(tmp_path / 'ours')))
    ref_options = jax_it.MDTestOptions()
    ref_options.scratch_dir = str(tmp_path / 'ref')
    ref = jax_it._build_test_package(ref_options)
    assert _tree(ours[1]) == _tree(ref[1])
    assert sorted(_tree(ours[2])) == sorted(_tree(ref[2]))
    params, metadata = load_checkpoint(ours[3])
    ref_params, ref_metadata = load_checkpoint(ref[3])
    assert metadata == ref_metadata

    def leaves(tree, prefix=''):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + '/')
            else:
                yield prefix + k, np.asarray(v)

    assert [(k, v.tobytes()) for k, v in leaves(params)] == \
        [(k, v.tobytes()) for k, v in leaves(ref_params)]


def test_download_test_data_offline(tmp_path):
    # A hosted-style package: a zip holding an image folder, read from a
    # file:// URL; the model comes from the options
    source = tmp_path / 'source'
    package = it._build_test_package(_options(str(source)))
    zip_path = str(tmp_path / 'package.zip')
    with zipfile.ZipFile(zip_path, 'w') as z:
        for folder, _, files in os.walk(package[1]):
            for name in files:
                path = os.path.join(folder, name)
                z.write(path, os.path.join(
                    'md-test-package', os.path.relpath(path, package[1])))
    options = _options(str(tmp_path / 'staged'), model_file=package[3])
    options.test_data_url = 'file://' + zip_path
    os.makedirs(options.scratch_dir)
    scratch, image_dir, video_dir, model_file = it.download_test_data(
        options)
    assert image_dir == os.path.join(scratch, 'md-test-package')
    assert model_file == package[3] and video_dir is None
    assert options.skip_video_tests is True
    # An unreadable URL falls back to the synthetic package
    options = _options(str(tmp_path / 'fallback'))
    options.test_data_url = 'file://' + str(tmp_path / 'absent.zip')
    os.makedirs(options.scratch_dir)
    got = it.download_test_data(options)
    assert os.path.isfile(got[3]) and os.path.isdir(got[1])


def test_known_models_resolve_only_on_disk(tmp_path, monkeypatch):
    monkeypatch.setenv('MD_MODEL_FOLDER', str(tmp_path / 'models'))
    status = it.run_download_tests()
    assert status and all(v.startswith('skipped: no converted checkpoint')
                          for v in status.values())
    # A converted checkpoint on disk resolves
    source = it._build_test_package(_options(str(tmp_path / 'pkg')))[3]
    os.makedirs(str(tmp_path / 'models'), exist_ok=True)
    shutil.copyfile(source, str(tmp_path / 'models' / 'md_v5a.0.1.npz'))
    status = it.run_download_tests()
    assert status['v5a.0.1'] == 'ok'


def test_expected_results_filename_names_torch():
    version = '.'.join(torch.__version__.split('+')[0].split('.')[:2])
    assert it.get_expected_results_filename(False) == \
        'mdv5a-image-cpu-pt{}.json'.format(version)
    assert it.get_expected_results_filename(
        True, augment=True) == 'mdv5a-augment-image-gpu-pt{}.json'.format(
            version)
    assert it.get_expected_results_filename(
        False, test_type='video') == 'mdv5a-video.json'


@pytest.mark.slow
def test_integration_harness_full_with_cli(tmp_path):
    status = it.run_tests(_options(str(tmp_path / 'cli'),
                                   skip_cli_tests=False))
    assert status['cli'] == 'ok'
    assert set(status.values()) == {'ok'}
